"""hero_tpu_torch on grids of ranks beyond data parallelism: ZeRO-1,
pipeline, tensor and sequence parallelism (``parallel/dist`` grids,
``parallel/mesh``, ``parallel/pipeline``, ``training/step``) against the
one-process step and the JAX package's sharded steps: the twins of
``tests/test_pipeline_parallel.py``,
``tests/test_training.py::test_zero1_optimizer_sharding`` /
``::test_tensor_parallel_train_step`` /
``::test_sequence_parallel_train_step`` and
``tests/test_drivers_all.py::test_pretrain_driver_pipeline_parallel``.

Two worlds run as processes over ``gloo`` on the CPU with ``file://``
stores in the test's directory, spawned once by a module fixture:
``pair`` (2 ranks: ZeRO-1 over 2 data ranks against the 2-rank
replicated step, the pipelined encoder and the PP, TP and SP steps on
grids of one data rank and 2 inner ranks, the refusals, and
``train_vcmr`` replicated, then with ``--zero1`` stopped by SIGTERM to
rank 1 and resumed) and ``quad`` (4 ranks: ``pretrain.main --pp_stages 2``
on 2 data x 2 stage ranks).  The JAX steps run in the pytest process
while the ranks work, one after another in one thread (the pipeline and
sequence-parallel toggles are read while a step traces).  Everything is
fp32 with dropout off unless stated, the model tiny, torch on one thread.

Run as ``python tests/test_torch_parallel.py <world> <rank> <root>``,
the file is one rank of a world; it imports no JAX then.
"""

import concurrent.futures
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

from hero_tpu_torch.config import opts as topts                 # noqa: E402
from hero_tpu_torch.config.model_config import (               # noqa: E402
    TransformerConfig, tiny_hero_config)
from hero_tpu_torch.convert.from_jax import load_jax_params     # noqa: E402
from hero_tpu_torch.data import synthetic as tsyn               # noqa: E402
from hero_tpu_torch.data import testing as ttesting             # noqa: E402
from hero_tpu_torch.data.occupancy import VideoShape            # noqa: E402
from hero_tpu_torch.drivers import common as tcommon            # noqa: E402
from hero_tpu_torch.drivers import pretrain as tpretrain_drv    # noqa: E402
from hero_tpu_torch.drivers import train_vcmr as ttrain_vcmr    # noqa: E402
from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device  # noqa
from hero_tpu_torch.models import pretrain as tpre              # noqa: E402
from hero_tpu_torch.models import transformer as ttrm           # noqa: E402
from hero_tpu_torch.parallel import dist, mesh, pipeline        # noqa: E402
from hero_tpu_torch.training import optim as toptim             # noqa: E402
from hero_tpu_torch.training import step as tstep               # noqa: E402

B = 4                       # the global batch
VSM = dict(lw_neg_ctx=1.0, lw_neg_q=1.0, lw_st_ed=0.01)
SPEC = dict(learning_rate=1e-3, warmup_steps=1, num_train_steps=100,
            grad_norm=2.0)
SHAPE = dataclasses.replace(tsyn.TINY, batch=B, n_subs=3, txt_len=12,
                            frames_per_sub=6)
MAX_FRAMES = 16
WORLD_TIMEOUT_S = 300
ZERO1_STEPS = 3
DROP_SEEDS = 48
VCMR_STEPS, VCMR_SIGTERM_AT = 4, 2
HEAD = "head/video_query_linear/weight"


def tiny_videos(seed, n):
    """Small TV-like videos that fit :data:`SHAPE`'s packed rows."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        n_subs = r.randint(2, 6)
        out.append(VideoShape(
            n_frames=int(r.randint(8, 17)),
            sub_txt_lens=[int(x) for x in r.randint(2, 9, n_subs)],
            sub_n_frames=[int(x) for x in r.randint(1, 4, n_subs)]))
    return out


def vsm_batch(seed=4):
    b, _ = tsyn.tv_vsm_batch(tiny_videos(seed, B), SHAPE, packed=True,
                             seed=seed + 1)
    return b


def port_loss():
    return tpretrain_drv.make_loss("vsm", tiny_hero_config(),
                                   tpre.VsmConfig(**VSM),
                                   dtype=torch.float32, train=False)


def init_params():
    return load_jax_params(tpre.init_flat_params(tiny_hero_config(),
                                                 seed=0), device="cpu")


def enc_cfg(layers):
    return TransformerConfig(hidden_size=32, num_hidden_layers=layers,
                             num_attention_heads=4, intermediate_size=64,
                             max_position_embeddings=64, vocab_size=64,
                             type_vocab_size=2)


def enc_params(layers, seed):
    """A ``layers``-deep encoder stack from a numpy seed."""
    r = np.random.RandomState(seed)

    def t(*shape, scale=0.05, base=0.0):
        return torch.tensor(base + scale * r.randn(*shape),
                            dtype=torch.float32)

    def lin(o, i):
        return {"weight": t(o, i), "bias": t(o, scale=0.02)}

    def ln(d):
        return {"weight": t(d, scale=0.1, base=1.0), "bias": t(d, scale=0.1)}

    return {"layers": [
        {"attention": {"qkv": lin(96, 32), "out": lin(32, 32),
                       "out_ln": ln(32)},
         "ffn": {"intermediate": lin(64, 32), "output": lin(32, 64),
                 "ln": ln(32)}} for _ in range(layers)]}


def _paths(tree):
    return ["/".join(p) for p in toptim.tree_paths(tree)]


def _worst(got, want, rtol, atol):
    """The largest |got - want| / (atol + rtol |want|) over two lists of
    tensors (at most 1 is within tolerance)."""
    return max(float(((g.double() - w.double()).abs()
                      / (atol + rtol * w.double().abs())).max())
               if w.numel() else 0.0 for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_main(world_name, rank, root):
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(
        2 if world_name == "pair" else 4))
    os.environ[dist.INIT_METHOD_ENV] = "file://" + os.path.join(
        root, f"store_{world_name}")
    assert dist.init_distributed("cpu") == torch.device("cpu")
    out = {"rank": rank}
    if world_name == "pair":
        batch = dict(np.load(os.path.join(root, "batch.npz")))
        out["zero1"] = _zero1(root, batch)
        out["pp"] = _pp(root, batch)
        out["tp"] = _tp_sp(root, batch, "model")
        out["sp"] = _tp_sp(root, batch, "seq")
        out["guards"] = _guards()
        out["vcmr"] = _vcmr_runs(root)
    else:
        opts = topts.get_pretrain_args(
            ["--config", os.path.join(root, "pp_pretrain.json"),
             "--pp_stages", "2", "--pp_microbatches", "2"])
        state = tpretrain_drv.main(opts, device="cpu")
        out["pp_run"] = {
            "step": state.global_step,
            "grid": [dist.data_rank(), dist.data_world(), dist.inner_rank(),
                     dist.inner_world()],
            "stages": pipeline.n_stages(),
            "own_f_layers": [l is not None for l in state.params[
                "v_encoder"]["f_encoder"]["encoder"]["layers"]]}
    dist.shutdown_distributed()
    with open(os.path.join(root, f"{world_name}_{rank}.json"), "w") as f:
        json.dump(out, f)


def _zero1(root, batch):
    """Three ZeRO-1 steps against three 2-rank replicated steps on the
    rank's half of the batch: the parameters after each step equal bit
    for bit; the rank's moments are its ``zero1_opt_spec`` slices of the
    replicated moments, and gathered they equal them bit for bit."""
    dist.init_grid()
    fn, spec = port_loss(), tstep.TrainSpec(**SPEC)
    params = init_params()
    mine = batch_to_device(dist.shard_rows(batch), "cpu")
    rep = tstep.TrainState.create(params)
    z = tstep.shard_state(tstep.TrainState.create(params), zero1=True)
    step_r = tstep.make_train_step(fn, spec)
    step_z = tstep.make_train_step(fn, spec, zero1=True)
    equal, losses = [], []
    for i in range(ZERO1_STEPS):
        rep, _ = step_r(rep, mine, None)
        z, m = step_z(z, mine, None)
        losses.append(float(m["loss"]))
        equal.append(all(torch.equal(a, b) for a, b in zip(
            toptim.tree_leaves(rep.params), toptim.tree_leaves(z.params))))
    specs = mesh.zero1_opt_spec(params, 2)
    slices = all(
        torch.equal(got, want if sh is None
                    else mesh.split(want, sh, dist.data_rank(), 2))
        for tree_z, tree_r in ((z.opt.mu, rep.opt.mu), (z.opt.nu, rep.opt.nu))
        for got, want, sh in zip(toptim.tree_leaves(tree_z),
                                 toptim.tree_leaves(tree_r), specs))
    whole = tstep.gather_state(z, zero1=True)
    gathered = all(torch.equal(a, b) for a, b in zip(
        toptim.tree_leaves(whole.opt.mu) + toptim.tree_leaves(whole.opt.nu),
        toptim.tree_leaves(rep.opt.mu) + toptim.tree_leaves(rep.opt.nu)))
    paths = _paths(params)
    k = paths.index("v_encoder/f_encoder/encoder/layers/0/ffn/intermediate/"
                    "weight")
    if dist.is_primary():
        torch.save({"params": toptim.tree_leaves(z.params),
                    "losses": losses}, os.path.join(root, "zero1.pt"))
    return {"equal_by_step": equal, "moment_slices": slices,
            "gathered_equal": gathered,
            "mu_shape": list(toptim.tree_leaves(z.opt.mu)[k].shape),
            "param_shape": list(toptim.tree_leaves(z.params)[k].shape)}


def _pp(root, batch):
    """The pipelined encoder against the sequential one (forward and
    every gradient; no mask; an uneven stack; the packed segment mask;
    the dropout stream), and the PP VSM step, plain and with two
    accumulated micro-batches, against the one-process step, on a grid
    of one data rank and 2 stages with 2 micro-batches."""
    dist.init_grid("stage", 2)
    pipeline.enable_pipeline(True, 2)
    s = dist.inner_rank()
    out = {}
    r = np.random.RandomState(0)
    cfg = enc_cfg(4)
    full = enc_params(4, 0)
    x = torch.tensor(r.randn(4, 10, 32), dtype=torch.float32)
    mask = torch.tensor(r.rand(4, 10) > 0.2, dtype=torch.float32)
    ids = np.full((4, 12), -1, np.int32)
    ids[:, 0:4], ids[:, 4:9], ids[:, 9:11] = 0, 1, 2
    cases = {"mask": (x, {"kv_mask": mask}), "no_mask": (x[:, :8], {}),
             "seg": (torch.tensor(r.randn(4, 12, 32), dtype=torch.float32),
                     {"seg": torch.tensor(ids)})}
    mine = pipeline.stage_params(full, s, 2)
    for name, (xc, kw) in cases.items():
        outs = []
        for p in (full, mine):
            leaves = [t.detach().requires_grad_(True)
                      for t in toptim.tree_leaves(p)]
            xi = xc.detach().requires_grad_(True)
            y = ttrm.encoder(toptim.tree_unflatten(p, leaves), xi, cfg, **kw)
            gx, *gl = torch.autograd.grad((y ** 2).sum(), [xi] + leaves)
            outs.append((y.detach(), gx, gl))
        (y0, gx0, gl0), (y1, gx1, gl1) = outs
        held = [p is not None for p in mine["layers"]]
        gl0 = [g for g, own in zip(
            gl0, [h for h, l in zip(held, full["layers"])
                  for _ in toptim.tree_leaves(l)]) if own]
        out[name] = {"fwd": _worst([y1], [y0], 1e-5, 1e-6),
                     "grads": _worst([gx1] + gl1, [gx0] + gl0, 1e-4, 1e-5),
                     "layers_held": held}
    # a 3-layer stack stays whole and sequential on every stage
    three = enc_params(3, 1)
    out["uneven"] = {
        "whole": all(l is not None for l in pipeline.stage_params(
            three, s, 2)["layers"]),
        "equal": torch.equal(
            ttrm.encoder(pipeline.stage_params(three, s, 2), x, enc_cfg(3),
                         kv_mask=mask),
            ttrm.encoder(three, x, enc_cfg(3), kv_mask=mask)),
        "active": [pipeline.active(n) for n in (4, 3, 1)]}
    # the dropout stream: a different draw, the same distribution
    ones = torch.ones(4, 10)
    with torch.no_grad():
        ev = ttrm.encoder(full, x, cfg, kv_mask=ones)
        seq, ppv = [], []
        for i in range(DROP_SEEDS):
            for p, acc in ((full, seq), (mine, ppv)):
                y = ttrm.encoder(p, x, cfg, kv_mask=ones, train=True,
                                 seed=100 + i)
                acc.append(float(((y - ev) ** 2).mean()))
    out["dropout"] = {"seq": seq, "pp": ppv}
    # the VSM step: the f-encoder (2 layers) one layer a stage, the
    # 1-layer c-encoder whole
    fn, spec = port_loss(), tstep.TrainSpec(**SPEC)
    params = init_params()
    tb = batch_to_device(batch, "cpu")
    b2 = {k: np.stack([v, v[::-1].copy()]) for k, v in batch.items()}
    tb2 = batch_to_device(b2, "cpu")
    for name, accum, bt in (("step", 1, tb), ("accum_step", 2, tb2)):
        st = tstep.shard_state(tstep.TrainState.create(params))
        st, m = tstep.make_train_step(fn, spec, accum_steps=accum)(st, bt,
                                                                  None)
        got = tstep.gather_state(st)
        one, m1 = tstep.make_train_step(fn, spec, accum_steps=accum,
                                        group=dist.ALONE)(
            tstep.TrainState.create(params), bt, None)
        out[name] = {"loss": [float(m["loss"]), float(m1["loss"])],
                     "params": _worst(toptim.tree_leaves(got.params),
                                      toptim.tree_leaves(one.params),
                                      2e-4, 2e-5)}
        if name == "step":
            out["f_layers_held"] = [
                l is not None for l in st.params["v_encoder"]["f_encoder"][
                    "encoder"]["layers"]]
            out["c_layers_held"] = [
                l is not None for l in st.params["v_encoder"]["c_encoder"][
                    "encoder"]["layers"]]
            if dist.is_primary():
                torch.save({"params": toptim.tree_leaves(got.params),
                            "loss": float(m["loss"])},
                           os.path.join(root, "pp.pt"))
    pipeline.enable_pipeline(False)
    return out


def _tp_sp(root, batch, axis):
    """The VSM step on a grid of one data rank and 2 ``axis`` ranks
    ("model": tensor parallelism, "seq": sequence parallelism) against
    the one-process step."""
    dist.init_grid(axis, 2)
    fn, spec = port_loss(), tstep.TrainSpec(**SPEC)
    params = init_params()
    tb = batch_to_device(batch, "cpu")
    dist.enable_seq_parallel(axis == "seq")
    try:
        st = tstep.shard_state(tstep.TrainState.create(params))
        st, m = tstep.make_train_step(fn, spec)(st, tb, None)
    finally:
        dist.enable_seq_parallel(False)
    got = tstep.gather_state(st)
    one, m1 = tstep.make_train_step(fn, spec, group=dist.ALONE)(
        tstep.TrainState.create(params), tb, None)
    k = _paths(params).index(
        "v_encoder/f_encoder/encoder/layers/0/ffn/intermediate/weight")
    if dist.is_primary():
        torch.save({"params": toptim.tree_leaves(got.params),
                    "loss": float(m["loss"])},
                   os.path.join(root, f"{axis}.pt"))
    return {"loss": [float(m["loss"]), float(m1["loss"])],
            "params": _worst(toptim.tree_leaves(got.params),
                             toptim.tree_leaves(one.params), 2e-4, 2e-5),
            "intermediate_shape": list(
                toptim.tree_leaves(st.params)[k].shape),
            "moment_shape": list(toptim.tree_leaves(st.opt.mu)[k].shape)}


def _guards():
    """What a world of 2 accepts and refuses: ``--zero1`` builds a plain
    grid and a ZeRO-1 step; ``--zero1`` with ``--pp_stages 2``, and a
    ZeRO-1 step on a stage grid, raise."""
    msgs = {}
    grid = pipeline.driver_grid(topts.get_pretrain_args(["--zero1"]), B)
    tstep.make_train_step(port_loss(), tstep.TrainSpec(**SPEC), zero1=True)
    msgs["zero1"] = [grid.axis, grid.data_world]
    try:
        pipeline.driver_grid(topts.get_pretrain_args(
            ["--zero1", "--pp_stages", "2"]), B)
    except ValueError as e:
        msgs["zero1_pp"] = str(e)
    dist.init_grid("stage", 2)
    try:
        tstep.make_train_step(port_loss(), tstep.TrainSpec(**SPEC),
                              zero1=True)
    except ValueError as e:
        msgs["zero1_stage_grid"] = str(e)
    dist.init_grid()
    return msgs


def _vcmr_runs(root):
    """``train_vcmr`` run A (replicated) and run B (``--zero1``) stopped
    by SIGTERM to rank 1 after step 2, then resumed; the final steps."""
    def on_step(step, task, metrics):
        if dist.rank() == 1 and step == VCMR_SIGTERM_AT:
            os.kill(os.getpid(), signal.SIGTERM)

    def run(name, extra=(), hook=None):
        opts = topts.get_vcmr_args(
            ["--config", os.path.join(root, f"{name}.json"), *extra])
        return ttrain_vcmr.main(opts, device="cpu", on_step=hook,
                                dtype=torch.float32).global_step

    return {"a": run("vcmr_a"),
            "b_stopped": run("vcmr_b", ["--zero1"], on_step),
            "b_resumed": run("vcmr_b", ["--zero1"])}


# ---------------------------------------------------------------------------
# the pytest process: the inputs, the worlds, the references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(world_name, n, root):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", dist.INIT_METHOD_ENV, dist.BACKEND_ENV):
        env.pop(k, None)
    procs = []
    for r in range(n):
        log = open(os.path.join(root, f"{world_name}_{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__)), world_name,
             str(r), root], cwd=root, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _join(procs, world_name, root):
    """Wait for a world's ranks; a rank that fails or outlasts the time
    limit fails the test with every rank's log."""
    deadline = time.time() + WORLD_TIMEOUT_S
    codes = []
    for p, log in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.time())))
        except subprocess.TimeoutExpired:
            codes.append("timeout")
        log.close()
    if codes != [0] * len(procs):
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        logs = "\n".join(
            f"--- rank {r} ({c}) ---\n" + pathlib.Path(
                root, f"{world_name}_{r}.log").read_text()[-4000:]
            for r, c in enumerate(codes))
        pytest.fail(f"world {world_name!r} failed: {codes}\n{logs}")
    return [json.loads(pathlib.Path(root, f"{world_name}_{r}.json")
                       .read_text()) for r in range(len(procs))]


MODEL_CFG = tiny_hero_config(max_clip_len=MAX_FRAMES).to_dict()


def _configs(root):
    """The runs' stores and configs: ``vcmr_a.json`` / ``vcmr_b.json``
    (``train_vcmr`` from a JAX-layout ``.npz``, 4 steps of 4 queries, 2 a
    rank, validation at step 4, ``restore.npz`` every 2) and
    ``pp_pretrain.json`` (``pretrain``: 4 steps of the four-task mix, 4
    videos a step, 2 a data rank, validation at step 2, a 2-layer
    f-encoder)."""
    corpus = ttesting.build_synthetic_corpus(os.path.join(root, "db"),
                                             n_videos=6,
                                             max_frames=MAX_FRAMES,
                                             vfeat_dim=64)
    mc = os.path.join(root, "model.json")
    with open(mc, "w") as f:
        json.dump(MODEL_CFG, f)
    ns = types.SimpleNamespace(model_config=mc, max_clip_len=MAX_FRAMES,
                               vfeat_dim=64)
    ckpt = os.path.join(root, "init.npz")
    np.savez(ckpt, **tpre.init_flat_params(
        tcommon.model_config_from_opts(ns), tpre.VsmConfig(**VSM), seed=9))
    for name in ("vcmr_a", "vcmr_b"):
        cfg = dict(
            task="tvr", sub_txt_db=corpus["sub"], vfeat_db=corpus["vfeat"],
            train_query_txt_db=corpus["query"],
            val_query_txt_db=corpus["query"], model_config=mc,
            checkpoint=ckpt, output_dir=os.path.join(root, name),
            max_clip_len=MAX_FRAMES, max_txt_len=12, vfeat_interval=1.5,
            vfeat_dim=64, train_batch_size=4,
            gradient_accumulation_steps=1, learning_rate=1e-3,
            valid_steps=VCMR_STEPS, save_steps=2,
            num_train_steps=VCMR_STEPS, warmup_steps=1, grad_norm=1.0,
            hard_pool_size=[4], hard_neg_weights=[10],
            hard_negtiave_start_step=[2], train_span_start_step=0,
            sub_ctx_len=0, seed=7, max_vcmr_video=6, max_before_nms=50,
            max_after_nms=20, nms_thd=0.5, min_pred_l=1, max_pred_l=8,
            vcmr_eval_video_batch_size=4, vcmr_eval_batch_size=10,
            bucket_n_subs=4, bucket_frames_per_sub=12, bucket_query_len=16,
            distributed_eval=True, **VSM)
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(cfg, f)
    cfg = dict(
        targets=[{"name": "tv", "sub_txt_db": corpus["sub"],
                  "vfeat_db": corpus["vfeat"],
                  "tasks": {"mlm": 2, "mfm-nce": 2, "fom": 1, "vsm": 2}}],
        targets_ratio=[1], model_config=mc, checkpoint=None,
        output_dir=os.path.join(root, "pp_pretrain"),
        max_clip_len=MAX_FRAMES, max_txt_len=12, vfeat_interval=1.5,
        vfeat_dim=64, pack_subs=True, bucket_n_subs=2, train_batch_size=4,
        val_batch_size=4, n_val_batches=1, gradient_accumulation_steps=1,
        learning_rate=1e-3, valid_steps=2, save_steps=2, num_train_steps=4,
        warmup_steps=2, grad_norm=1.0, sub_ctx_len=0, seed=11,
        query_per_video=2, bucket_query_len=16, drop_svmr_prob=0.5,
        hard_pool_size=[2], hard_neg_weights=[10],
        hard_negtiave_start_step=[2], train_span_start_step=0, **VSM)
    with open(os.path.join(root, "pp_pretrain.json"), "w") as f:
        json.dump(cfg, f)


def _jax_steps(batch):
    """The JAX package's sharded steps from the bridged weights, one after
    another: ZeRO-1 on ``get_mesh(2)`` (three steps), and one step each on
    ``get_pp_mesh(1, 2)`` (2 micro-batches), ``get_2d_mesh(1, 2)`` and
    ``get_seq_mesh(1, 2)``.  {mode: (losses, new parameters in the
    port's layout)}."""
    import jax
    import jax.numpy as jnp
    from hero_tpu.config.model_config import tiny_hero_config as jcfg_fn
    from hero_tpu.models import pretrain as jpre
    from hero_tpu.parallel import mesh as jmesh
    from hero_tpu.parallel import pipeline as jpp
    from hero_tpu.training import step as jstep
    from hero_tpu.training.save import flatten_tree, unflatten_tree

    jcfg, vsm = jcfg_fn(), jpre.VsmConfig(**VSM)
    params = jax.tree.map(jnp.asarray, unflatten_tree(
        tpre.init_flat_params(tiny_hero_config(), seed=0)))

    def loss_fn(p, b, rng):
        a, x, y = jpre.forward_vsm(p, jcfg, vsm, b)
        return a + x + y, {}

    def run(m, steps=1, zero1=False):
        st = jstep.shard_state(jstep.TrainState.create(params), m,
                               zero1=zero1)
        fn = jstep.make_sharded_train_step(loss_fn, jstep.TrainSpec(**SPEC),
                                           m, donate=False, zero1=zero1)
        b = jmesh.shard_task_batch(batch, m)
        losses = []
        for i in range(steps):
            st, met = fn(st, b, jax.random.PRNGKey(i))
            losses.append(float(met["loss"]))
        return losses, toptim.tree_leaves(load_jax_params(
            flatten_tree(jax.device_get(st.params)), device="cpu"))

    out = {"zero1": run(jmesh.get_mesh(2), ZERO1_STEPS, zero1=True),
           "model": run(jmesh.get_2d_mesh(1, 2))}
    pp_mesh = jpp.get_pp_mesh(1, 2)
    jpp.enable_pipeline(pp_mesh, n_microbatches=2)
    try:
        out["pp"] = run(pp_mesh)
    finally:
        jpp.enable_pipeline(None)
    seq_mesh = jmesh.get_seq_mesh(1, 2)
    jmesh.enable_seq_parallel(seq_mesh)
    try:
        out["seq"] = run(seq_mesh)
    finally:
        jmesh.enable_seq_parallel(None)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, and the JAX steps beside them."""
    root = str(tmp_path_factory.mktemp("parallel"))
    batch = vsm_batch()
    np.savez(os.path.join(root, "batch.npz"), **batch)
    _configs(root)
    pair = _spawn("pair", 2, root)
    quad = _spawn("quad", 4, root)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_future = pool.submit(_jax_steps, batch)
        try:
            ranks = _join(pair, "pair", root)
        finally:
            quad_ranks = _join(quad, "quad", root)
        jax_steps = jax_future.result()
    saved = {m: torch.load(os.path.join(root, f"{m}.pt"))
             for m in ("zero1", "pp", "model", "seq")}
    return types.SimpleNamespace(root=root, ranks=ranks, quad=quad_ranks,
                                 jax=jax_steps, saved=saved,
                                 paths=_paths(init_params()))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_specs_cut_and_join_every_leaf():
    """``zero1_opt_spec`` shards each leaf's largest dim W divides (0-d,
    small and indivisible leaves whole), ``tp_param_spec`` the attention
    and FFN products of every encoder block (the fused QKV in three
    blocks, the decoder whole), ``pp_param_spec`` the layers of the
    encoder stacks S divides; ``split`` and ``join`` invert each other."""
    params = init_params()
    paths = _paths(params)
    leaves = toptim.tree_leaves(params)
    z = mesh.zero1_opt_spec(params, 2)
    for t, sh in zip(leaves, z):
        big = [d for d in range(t.ndim) if t.shape[d] >= 2
               and t.shape[d] % 2 == 0]
        assert (sh is None) == (not big)
        if sh is not None:
            assert t.shape[sh.dim] == max(t.shape[d] for d in big)
            parts = [mesh.split(t, sh, r, 2) for r in range(2)]
            assert torch.equal(mesh.join(parts, sh), t)
    odd = {"w": torch.zeros(3, 5), "s": torch.zeros(())}
    assert mesh.zero1_opt_spec(odd, 2) == [None, None]
    tp = dict(zip(paths, mesh.tp_param_spec(params)))
    base = "v_encoder/f_encoder/encoder/layers/1/"
    assert tp[base + "attention/qkv/weight"] == mesh.Shard(0, 3)
    assert tp[base + "attention/qkv/bias"] == mesh.Shard(0, 3)
    assert tp[base + "attention/out/weight"] == mesh.Shard(1)
    assert tp[base + "attention/out/bias"] is None
    assert tp[base + "ffn/intermediate/weight"] == mesh.Shard(0)
    assert tp[base + "ffn/output/weight"] == mesh.Shard(1)
    assert tp[base + "ffn/ln/weight"] is None
    assert tp["head/q_feat_attn/attention/qkv/weight"] == mesh.Shard(0, 3)
    assert tp[HEAD] is None
    qkv = torch.arange(96.0 * 2).reshape(96, 2)
    parts = [mesh.split(qkv, mesh.Shard(0, 3), r, 2) for r in range(2)]
    assert torch.equal(parts[1][:16], qkv[16:32])       # query rows 16-31
    assert torch.equal(parts[1][16:32], qkv[48:64])     # key rows 16-31
    assert torch.equal(mesh.join(parts, mesh.Shard(0, 3)), qkv)
    pp = dict(zip(paths, pipeline.pp_param_spec(params, 2)))
    assert pp[base + "ffn/ln/weight"] == 1
    assert pp["v_encoder/f_encoder/encoder/layers/0/ffn/ln/weight"] == 0
    assert pp["v_encoder/c_encoder/encoder/layers/0/ffn/ln/weight"] is None
    assert pp[HEAD] is None
    # the poolers, which no loss reads, are replicated, as JAX's specs
    # place every leaf outside the stacked encoder layers
    for enc in ("f_encoder", "c_encoder"):
        for leaf in ("weight", "bias"):
            path = f"v_encoder/{enc}/pooler/dense/{leaf}"
            assert tp[path] is None and pp[path] is None, path
    assert pipeline.pp_param_spec({"decoder": {"layers": [
        {"w": torch.zeros(1)}] * 2}}, 2) == [None, None]


def test_zero1_step_equals_replicated_step_bit_for_bit(worlds):
    """Twin of ``test_zero1_optimizer_sharding``: three ZeRO-1 steps on 2
    ranks give the 2-rank replicated steps' parameters bit for bit after
    each step; each rank's moments are its ``zero1_opt_spec`` slices (the
    FFN intermediate's moments half its rows) and gather to the
    replicated moments bit for bit."""
    for res in worlds.ranks:
        z = res["zero1"]
        assert z["equal_by_step"] == [True] * ZERO1_STEPS
        assert z["moment_slices"] and z["gathered_equal"]
        assert z["param_shape"] == [128, 32] and z["mu_shape"] == [64, 32]


def test_zero1_steps_equal_jax_zero1_steps(worlds):
    """Three ZeRO-1 steps equal JAX's ``make_sharded_train_step(zero1=True)``
    on ``get_mesh(2)``: the losses at rel 1e-5 and the head's query
    projection at ``test_zero1_optimizer_sharding``'s rtol 1e-5, every
    parameter at the one-step tests' atol 2e-6 a step."""
    jl, jp = worlds.jax["zero1"]
    got = worlds.saved["zero1"]
    assert got["losses"] == pytest.approx(jl, rel=1e-5)
    k = worlds.paths.index(HEAD)
    np.testing.assert_allclose(got["params"][k].numpy(), jp[k].numpy(),
                               rtol=1e-5, atol=1e-7)
    for i, (g, w) in enumerate(zip(got["params"], jp)):
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=2e-6 * ZERO1_STEPS,
                                   err_msg=worlds.paths[i])


@pytest.mark.parametrize("case", ["mask", "no_mask", "seg"])
def test_pipelined_encoder_matches_sequential(worlds, case):
    """Twin of ``test_pipelined_encoder_matches_sequential`` /
    ``_no_mask_and_uneven_stack`` / ``_packed_segment_mask``: a 4-layer
    stack over 2 stages (2 layers each), 2 micro-batches, with a
    validity mask, no mask or packed segment ids: the output at rtol 1e-5
    / atol 1e-6 on every stage, d(input) and each stage's layer
    gradients at rtol 1e-4 / atol 1e-5."""
    for s, res in enumerate(worlds.ranks):
        c = res["pp"][case]
        assert c["layers_held"] == [s == 0, s == 0, s == 1, s == 1]
        assert c["fwd"] <= 1.0 and c["grads"] <= 1.0, c


def test_uneven_stack_stays_sequential(worlds):
    """A 3-layer stack does not split over 2 stages: every stage holds it
    whole and runs it sequentially, equal bit for bit."""
    for res in worlds.ranks:
        u = res["pp"]["uneven"]
        assert u["whole"] and u["equal"]
        assert u["active"] == [True, False, False]


def test_pipeline_dropout_stream_unbiased(worlds):
    """Twin of ``test_pipeline_dropout_stream_unbiased``: with dropout the
    pipeline (micro-batch j's layers on the sub-seed ``micro{j}``) draws
    another stream than the sequential stack, no seed of 48 reproduces
    it, and the mean squared perturbation agrees within 5%."""
    for res in worlds.ranks:
        seq = np.asarray(res["pp"]["dropout"]["seq"])
        ppv = np.asarray(res["pp"]["dropout"]["pp"])
        assert not np.any(seq == ppv)
        assert abs(seq.mean() - ppv.mean()) < 0.05 * seq.mean()
    assert (worlds.ranks[0]["pp"]["dropout"]
            == worlds.ranks[1]["pp"]["dropout"])


@pytest.mark.parametrize("case", ["step", "accum_step"])
def test_pipeline_step_equals_one_process_step(worlds, case):
    """Twins of ``test_pipeline_parallel_train_step`` and
    ``_grad_accum_step``: the VSM step on 2 stages (the 2-layer f-encoder
    one layer a stage, the 1-layer c-encoder whole on both), plain and
    over two accumulated micro-batches, equals the one-process step:
    loss rel 2e-4, every gathered parameter rtol 2e-4 / atol 2e-5."""
    for s, res in enumerate(worlds.ranks):
        c = res["pp"][case]
        assert c["loss"][0] == pytest.approx(c["loss"][1], rel=2e-4)
        assert c["params"] <= 1.0, c
        assert res["pp"]["f_layers_held"] == [s == 0, s == 1]
        assert res["pp"]["c_layers_held"] == [True]


@pytest.mark.parametrize("mode", ["pp", "model", "seq"])
def test_sharded_step_equals_jax_sharded_step(worlds, mode):
    """Twins of ``test_pipeline_parallel_train_step``,
    ``test_tensor_parallel_train_step`` and
    ``test_sequence_parallel_train_step``: the port's step on 2 stage,
    model or seq ranks equals the JAX step on ``get_pp_mesh(1, 2)``,
    ``get_2d_mesh(1, 2)`` or ``get_seq_mesh(1, 2)`` from the same bridged
    weights: loss rel 2e-4, every parameter rtol 2e-4 / atol 2e-5."""
    jl, jp = worlds.jax[mode]
    got = worlds.saved[mode]
    assert got["loss"] == pytest.approx(jl[0], rel=2e-4)
    assert _worst(got["params"], jp, 2e-4, 2e-5) <= 1.0


@pytest.mark.parametrize("axis", ["tp", "sp"])
def test_tp_and_sp_steps_equal_one_process_step(worlds, axis):
    """The TP step on 2 model ranks (the FFN intermediate weight and its
    moments really split: 64 of 128 rows a rank) and the SP step on 2
    seq ranks (the c-encoder on 8 of 16 frames a rank) equal the
    one-process step: loss rel 2e-4, every parameter rtol 2e-4 / atol
    2e-5."""
    for res in worlds.ranks:
        c = res[axis]
        assert c["loss"][0] == pytest.approx(c["loss"][1], rel=2e-4)
        assert c["params"] <= 1.0, c
        rows = 64 if axis == "tp" else 128
        assert c["intermediate_shape"] == [rows, 32]
        assert c["moment_shape"] == [rows, 32]


def test_zero1_with_pipeline_stages_raises(worlds):
    """``--zero1`` on 2 ranks builds the plain grid and a ZeRO-1 step;
    with ``--pp_stages 2`` it raises, as the JAX ``driver_mesh`` does, and
    a ZeRO-1 step on a stage grid raises, as its ``shard_state`` does."""
    for res in worlds.ranks:
        g = res["guards"]
        assert g["zero1"] == ["data", 2]
        assert "--zero1 with --pp_stages 2" in g["zero1_pp"]
        assert "stage grid" in g["zero1_stage_grid"]


def test_zero1_run_resumed_after_sigterm_equals_replicated_run(worlds):
    """``train_vcmr --zero1`` on 2 ranks stopped by SIGTERM to rank 1 after
    step 2 and resumed (the moments gathered into ``restore.npz``, then
    cut again) ends with the uninterrupted replicated run's
    ``model_step_4.npz``, ``restore.npz`` and step-4 submission, bit for
    bit."""
    for res in worlds.ranks:
        assert res["vcmr"] == {"a": VCMR_STEPS, "b_stopped": VCMR_SIGTERM_AT,
                               "b_resumed": VCMR_STEPS}
    a, b = (os.path.join(worlds.root, n) for n in ("vcmr_a", "vcmr_b"))
    for name in (f"ckpt/model_step_{VCMR_STEPS}.npz", "restore.npz"):
        got, want = _npz(os.path.join(b, name)), _npz(os.path.join(a, name))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sub = f"results_{VCMR_STEPS}_all.json"
    assert json.loads(pathlib.Path(b, sub).read_text()) == json.loads(
        pathlib.Path(a, sub).read_text())


def test_pretrain_driver_pipeline_parallel(worlds):
    """Twin of ``test_pretrain_driver_pipeline_parallel``: ``pretrain.main
    --pp_stages 2 --pp_microbatches 2`` on 4 ranks (2 data x 2 stages:
    global rank g is data rank g // 2, stage g % 2) trains 4 steps of 2
    videos a data rank with validation through the pipelined 2-layer
    f-encoder, and its primary writes ``restore.npz`` and
    ``ckpt/model_step_N.npz`` in the JAX layout: every key and shape of
    the tree a one-process run saves, every value finite."""
    for g, res in enumerate(worlds.quad):
        run = res["pp_run"]
        assert run["step"] == 4 and run["stages"] == 2
        assert run["grid"] == [g // 2, 2, g % 2, 2]
        assert run["own_f_layers"] == [g % 2 == 0, g % 2 == 1]
    out = os.path.join(worlds.root, "pp_pretrain")
    flat = tpre.init_flat_params(tiny_hero_config(max_clip_len=MAX_FRAMES),
                                 tpre.VsmConfig(**VSM), seed=11)
    restore = _npz(os.path.join(out, "restore.npz"))
    assert int(restore.pop("__step__")) == 4
    want = {f"{t}/{k}": v.shape for t in ("params", "mu", "nu")
            for k, v in flat.items()}
    assert {k: v.shape for k, v in restore.items()} == want
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "model_step_2.npz", "model_step_4.npz"]
    model = _npz(os.path.join(out, "ckpt", "model_step_4.npz"))
    assert {k: v.shape for k, v in model.items()} == {
        k: v.shape for k, v in flat.items()}
    assert all(np.isfinite(v).all() for v in restore.values())


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
