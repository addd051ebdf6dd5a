"""hero_tpu_torch on several ranks (``parallel/dist``) against one process
and against the JAX package's sharded step: the twins of
``tests/test_multiprocess_eval.py``, ``tests/test_multihost_resume.py``
and ``tests/test_training.py::test_vsm_global_batch_semantics_under_sharding``.

Two worlds of two ranks run as processes over ``gloo`` on the CPU with
a ``file://`` store in the test's directory, each spawned once by a
module fixture: ``main`` (the process group from the environment, one
train step of each loss on the rank's half of a global batch, three
dropout steps, the dropout streams, the guards, ``drivers.eval_vcmr``,
an uninterrupted ``drivers.pretrain`` run and the same run with SIGTERM
sent to rank 1 alone) and ``resume`` (its restart in fresh processes).
The one-process runs and the JAX step run in the pytest process while
the ranks work.  Everything is fp32 with dropout off unless stated, the
model tiny, torch on one thread.

The JAX side is ``make_sharded_train_step`` over ``get_mesh(2)`` on
batches that ``shard_task_batch`` placed, one loss a thread, so the
compiles overlap the ranks' work and each other.

Run as ``python tests/test_torch_dp.py <world> <rank> <root>``, the file
is one rank of a world; it imports no JAX then.
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
from hero_tpu_torch.config.model_config import tiny_hero_config  # noqa
from hero_tpu_torch.convert.from_jax import load_jax_params     # noqa: E402
from hero_tpu_torch.convert.from_jax import load_jax_tvc_params  # noqa
from hero_tpu_torch.data import synthetic as tsyn               # noqa: E402
from hero_tpu_torch.data import testing as ttesting             # noqa: E402
from hero_tpu_torch.data.downstream_tasks import VcmrFullEvalDataset  # noqa
from hero_tpu_torch.data.occupancy import VideoShape            # noqa: E402
from hero_tpu_torch.drivers import common as tcommon            # noqa: E402
from hero_tpu_torch.drivers import eval_vcmr as teval_drv       # noqa: E402
from hero_tpu_torch.drivers import pretrain as tpretrain_drv    # noqa: E402
from hero_tpu_torch.drivers import train_tvc as ttrain_tvc      # noqa: E402
from hero_tpu_torch.evaluation import vcmr_eval as teval        # noqa: E402
from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device  # noqa
from hero_tpu_torch.models import nn as tnn                     # noqa: E402
from hero_tpu_torch.models import pretrain as tpre              # noqa: E402
from hero_tpu_torch.models import transformer as ttrm           # noqa: E402
from hero_tpu_torch.models import tvc as ttvc                   # noqa: E402
from hero_tpu_torch.parallel import dist                        # noqa: E402
from hero_tpu_torch.parallel import pipeline as tpipeline       # noqa: E402
from hero_tpu_torch.training import optim as toptim             # noqa: E402
from hero_tpu_torch.training import step as tstep               # noqa: E402

WORLD = 2
B = 4                       # the global batch: 2 videos a rank
# the losses of the step test: (task, VsmConfig options)
VARIANTS = {"vsm": ("vsm", {}), "vsm_sampled": ("vsm", {"use_all_neg": False}),
            "mlm": ("mlm", {}), "mfm-nce": ("mfm-nce", {}),
            "mffr": ("mffr", {}), "fom": ("fom", {})}
VSM = dict(lw_neg_ctx=1.0, lw_neg_q=1.0, lw_st_ed=0.5)
SPEC = dict(learning_rate=1e-3, warmup_steps=1, num_train_steps=100,
            grad_norm=2.0)
SHAPE = dataclasses.replace(tsyn.TINY, batch=B, n_subs=3, txt_len=12,
                            frames_per_sub=6)
MAX_FRAMES = 16
WORLD_TIMEOUT_S = 240


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


def global_batch(task):
    """The packed global batch of ``task`` (MLM's seed leaves its two
    halves unequal masked counts)."""
    b, _ = tsyn.tv_task_batch(task, tiny_videos(4, B), SHAPE, packed=True,
                              seed=5)
    return b


def port_loss(variant, train=False):
    task, kw = VARIANTS[variant]
    return tpretrain_drv.make_loss(task, tiny_hero_config(),
                                   tpre.VsmConfig(**VSM, **kw),
                                   dtype=torch.float32, train=train)


def init_params():
    return load_jax_params(tpre.init_flat_params(tiny_hero_config(),
                                                 seed=0), device="cpu")


def with_uniforms(uniforms):
    """``_sampled_neg_loss`` fed ``uniforms`` (the JAX step's draws)."""
    orig = tpre._sampled_neg_loss

    def sampled(*a, **kw):
        kw["uniforms"] = tuple(torch.tensor(u) for u in uniforms)
        return orig(*a, **kw)
    return sampled


def tvc_setup():
    """TVC's tiny model and a global batch of 4 videos, 2 caption rows a
    video (``cap_vidx`` names each row's video, as ``build_tvc_batch``
    lays them out)."""
    cfg = tiny_hero_config()
    params = load_jax_tvc_params(ttvc.init_flat_tvc_params(cfg, seed=0),
                                 device="cpu")
    r = np.random.RandomState(7)
    b, _ = tsyn.tv_vsm_batch(tiny_videos(7, B), SHAPE, packed=True, seed=7)
    batch = {k: v for k, v in b.items() if k.startswith(("sub_", "c_"))}
    n_cap, lv, lt = 2 * B, 6, 5
    batch["cap_vidx"] = np.repeat(np.arange(B, dtype=np.int32), 2)
    batch["seg_idx"] = np.sort(r.randint(0, 16, (n_cap, lv)), 1).astype(
        np.int32)
    batch["seg_mask"] = (np.arange(lv)[None] < r.randint(
        1, lv + 1, (n_cap, 1))).astype(np.float32)
    batch["cap_input_ids"] = r.randint(3, 128, (n_cap, lt)).astype(np.int32)
    tgt = r.randint(0, 128, (n_cap, lt)).astype(np.int32)
    tgt[:, -1] = -1
    tgt[1, 2:] = -1
    batch["cap_tgt_ids"] = tgt
    return cfg, params, batch


def step_outputs(variant, params, batch):
    """(loss, grad norm, the global gradients, the new parameters) of one
    step of ``variant`` (a loss name, or a loss function) on ``batch``
    (the rank's rows on several ranks), no dropout."""
    fn = port_loss(variant) if isinstance(variant, str) else variant
    with dist.data_parallel(dist.data_group()):
        _, _, grads = tstep.loss_and_grads(fn, params, batch, None)
    if dist.world_size() > 1:
        grads = dist.all_reduce_grads(grads)
    step = tstep.make_train_step(fn, tstep.TrainSpec(**SPEC))
    state, m = step(tstep.TrainState.create(params), batch, None)
    return (float(m["loss"]), float(m["grad_norm"]),
            toptim.tree_leaves(grads), toptim.tree_leaves(state.params))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_main(world_name, rank, root):
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD))
    os.environ[dist.INIT_METHOD_ENV] = "file://" + os.path.join(
        root, f"store_{world_name}")
    out = {"rank": rank}
    tcommon.LOG_EVERY = 1
    if world_name == "main":
        _rank_main_world(rank, root, out)
    else:
        out["resumed_step"] = _pretrain_run(root, "resumed")
    dist.shutdown_distributed()
    with open(os.path.join(root, f"{world_name}_{rank}.json"), "w") as f:
        json.dump(out, f)


def _rank_main_world(rank, root, out):
    # the process group from the environment alone (RANK, WORLD_SIZE,
    # HERO_DIST_INIT_METHOD); the CPU names gloo
    assert dist.init_distributed("cpu") == torch.device("cpu")
    out["backend"] = dist.backend()
    out["ranks"] = dist.host_allgather(dist.rank())

    params = init_params()
    uniforms = tuple(np.load(os.path.join(root, "uniforms.npz"))[k]
                     for k in ("ctx", "q"))
    tpre._sampled_neg_loss = with_uniforms(uniforms)
    steps = {}
    for variant, (task, _) in VARIANTS.items():
        batch = dict(np.load(os.path.join(root, f"batch_{task}.npz")))
        mine = batch_to_device(dist.shard_rows(batch), "cpu")
        steps[variant] = step_outputs(variant, params, mine)
        # three steps with dropout on: the replicas stay bit-identical
        fn = tstep.make_train_step(port_loss(variant, train=True),
                                   tstep.TrainSpec(**SPEC))
        state = tstep.TrainState.create(params)
        for i in range(3):
            state, _ = fn(state, mine, 100 + i)
        dist.check_replicas(state.params)
        steps[variant] += (toptim.tree_leaves(state.params),)
    cfg, tparams, batch = tvc_setup()
    steps["tvc"] = step_outputs(
        ttrain_tvc.make_loss_fn(cfg, 0.1, torch.float32, train=False),
        tparams, batch_to_device(dist.shard_rows(
            batch, row_index_keys=tcommon.ROW_INDEX_KEYS), "cpu"))
    torch.save(steps, os.path.join(root, f"steps_{rank}.pt"))
    out["streams"] = _streams(root)
    out["guards"] = _guards(params)

    args = teval_drv.build_argparser().parse_args(
        ["--output_dir", os.path.join(root, "serve"), "--checkpoint", "5"])
    metrics, sub = teval_drv.main(args, device="cpu", dtype=torch.float32)
    out["eval"] = {"metrics": metrics, "submission": sub}

    out["full_step"] = _pretrain_run(root, "full")
    out["trunc_step"] = _pretrain_run(root, "resumed", sigterm_at=3)


def _pretrain_run(root, name, sigterm_at=0):
    """``drivers.pretrain.main`` on ``root/name.json``, SIGTERM sent to
    rank 1 alone after step ``sigterm_at`` (0: never); the final step."""
    def on_step(step, task, metrics):
        if dist.rank() == 1 and step == sigterm_at:
            os.kill(os.getpid(), signal.SIGTERM)

    opts = topts.get_pretrain_args(["--config",
                                    os.path.join(root, f"{name}.json")])
    return tpretrain_drv.main(opts, device="cpu",
                              on_step=on_step).global_step


def _streams(root):
    """What each rank draws in a data-parallel step: an ``nn.dropout``
    mask and the attention dropout seed (the rank folded in), outside a
    step the same mask; and per step seed the span-loss skip and the
    sampled-negative seed (every rank the same)."""
    grp = dist.data_group()
    ones = torch.ones(64)
    with dist.data_parallel(grp):
        mask = tnn.dropout(ones, 0.5, 1234)
    plain = tnn.dropout(ones, 0.5, 1234)
    attn_seeds, neg_seeds = [], []
    orig_attn, orig_neg = ttrm.packed_attention, tpre._sampled_neg_loss

    def attn(*a, **kw):
        attn_seeds.append(kw["seed"])
        return orig_attn(*a, **kw)

    def neg(*a, **kw):
        neg_seeds.append(kw["seed"])
        return orig_neg(*a, **kw)

    ttrm.packed_attention, tpre._sampled_neg_loss = attn, neg
    cfg = tiny_hero_config()
    vsm = tpre.VsmConfig(**VSM, use_all_neg=False, drop_svmr_prob=0.5)
    batch = batch_to_device(dist.shard_rows(
        dict(np.load(os.path.join(root, "batch_vsm.npz")))), "cpu")
    kept = []
    try:
        with dist.data_parallel(grp), torch.no_grad():
            for seed in range(8):
                span, _, _ = tpre.forward_vsm(
                    init_params(), cfg, vsm, batch, train=True,
                    seed=seed)
                kept.append(bool(span != 0))
    finally:
        ttrm.packed_attention, tpre._sampled_neg_loss = orig_attn, orig_neg
    return {"mask": mask.tolist(), "plain": plain.tolist(),
            "attn_seeds": attn_seeds[:4], "neg_seeds": neg_seeds,
            "span_kept": kept}


def _guards(params):
    """What a world of 2 accepts (``--zero1``: the plain grid of 2 data
    ranks) and the messages of what it refuses."""
    msgs = {}
    grid = tpipeline.driver_grid(topts.get_pretrain_args(["--zero1"]), B)
    msgs["zero1"] = [grid.axis, grid.data_world, grid.inner_world]
    try:
        dist.shard_rows({"x": np.zeros((3, 2))})
    except ValueError as e:
        msgs["indivisible"] = str(e)
    try:
        dist.shard_rows({"x": np.zeros((4, 2))}, items=3)
    except ValueError as e:
        msgs["items"] = str(e)
    opts = teval.VcmrEvalOpts(corpus_chunk_videos=1, max_clip_len=16)
    try:
        teval.validate_full_vcmr(params, tiny_hero_config(),
                                 tpre.VsmConfig(**VSM), opts, [], [],
                                 ["a", "b"], {"a": 0, "b": 1}, {},
                                 device="cpu")
    except NotImplementedError as e:
        msgs["chunked"] = str(e)
    return msgs


# ---------------------------------------------------------------------------
# the pytest process: the inputs, the worlds, the references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(world_name, root):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", dist.INIT_METHOD_ENV, dist.BACKEND_ENV):
        env.pop(k, None)
    procs = []
    for r in range(WORLD):
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
    if codes != [0] * WORLD:
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
                       .read_text()) for r in range(WORLD)]


MODEL_CFG = tiny_hero_config(max_clip_len=MAX_FRAMES).to_dict()


def _serve_dir(root):
    """A finetune run's directory for ``drivers.eval_vcmr``: stores of the
    synthetic corpus (7 videos, 21 queries), ``log/hps.json`` with
    ``distributed_eval`` (video batches of 3 and query batches of 4, both
    last batches ragged) and ``ckpt/model_step_5.npz``.  No metrics by
    query type: the example-weighted merge weighs them by every query of
    a rank, not by the queries of their type (the JAX merge's rule), so
    they move past the rounding bound."""
    dbs = ttesting.build_synthetic_corpus(os.path.join(root, "serve_db"),
                                          n_videos=7, max_frames=MAX_FRAMES,
                                          vfeat_dim=64)
    mc = os.path.join(root, "model.json")
    with open(mc, "w") as f:
        json.dump(MODEL_CFG, f)
    out = os.path.join(root, "serve")
    exp = {"sub_txt_db": dbs["sub"], "vfeat_db": dbs["vfeat"],
           "val_query_txt_db": dbs["query"], "model_config": mc,
           "output_dir": out, "max_clip_len": MAX_FRAMES, "max_txt_len": 12,
           "vfeat_interval": 1.5, "vfeat_dim": 64, "lw_neg_q": 8.0,
           "lw_neg_ctx": 8.0, "max_vcmr_video": 6, "max_before_nms": 50,
           "max_after_nms": 20, "nms_thd": -1.0, "min_pred_l": 1,
           "max_pred_l": 8, "vcmr_eval_video_batch_size": 3,
           "vcmr_eval_batch_size": 4, "bucket_n_subs": 4,
           "bucket_frames_per_sub": 12, "bucket_query_len": 12,
           "distributed_eval": True, "eval_with_query_type": False}
    with open(os.path.join(root, "exp.json"), "w") as f:
        json.dump(exp, f)
    hps = vars(topts.get_vcmr_args(["--config",
                                    os.path.join(root, "exp.json")]))
    os.makedirs(os.path.join(out, "log"))
    os.makedirs(os.path.join(out, "ckpt"))
    with open(os.path.join(out, "log", "hps.json"), "w") as f:
        json.dump(hps, f)
    opts = teval_drv.load_serve_opts(out)
    np.savez(os.path.join(out, "ckpt", "model_step_5.npz"),
             **tpre.init_flat_params(tcommon.model_config_from_opts(opts),
                                     tcommon.vsm_config_from_opts(opts),
                                     seed=3))


def _pretrain_configs(root):
    """``full.json`` and ``resumed.json``: 6 steps of the four-task mix,
    2 videos a step (one a rank), two micro-batches, validation at step 3
    and ``restore.npz`` every 4 steps."""
    corpus = ttesting.build_synthetic_corpus(os.path.join(root, "pre_db"),
                                             n_videos=6,
                                             max_frames=MAX_FRAMES,
                                             vfeat_dim=64)
    for name in ("full", "resumed"):
        cfg = dict(
            targets=[{"name": "tv", "sub_txt_db": corpus["sub"],
                      "vfeat_db": corpus["vfeat"],
                      "tasks": {"mlm": 2, "mfm-nce": 2, "fom": 1,
                                "vsm": 2}}],
            targets_ratio=[1], model_config=os.path.join(root, "model.json"),
            checkpoint=None, output_dir=os.path.join(root, name),
            max_clip_len=MAX_FRAMES, max_txt_len=12, vfeat_interval=1.5,
            vfeat_dim=64, pack_subs=True, bucket_n_subs=2,
            train_batch_size=2, val_batch_size=2, n_val_batches=1,
            gradient_accumulation_steps=2, learning_rate=1e-3,
            valid_steps=3, save_steps=4, num_train_steps=6, warmup_steps=2,
            grad_norm=1.0, sub_ctx_len=0, seed=11, query_per_video=2,
            bucket_query_len=16, lw_neg_q=1.0, lw_neg_ctx=1.0,
            lw_st_ed=0.01, drop_svmr_prob=0.5, hard_pool_size=[2],
            hard_neg_weights=[10], hard_negtiave_start_step=[4],
            train_span_start_step=0)
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(cfg, f)


def _jax_uniforms():
    """The uniforms JAX's sampled-negative loss draws from
    ``PRNGKey(0)`` (its draw with no key) at the global batch."""
    import jax
    r_ctx, r_q = jax.random.split(jax.random.PRNGKey(0))
    nq = B * SHAPE.n_queries
    return {"ctx": np.asarray(jax.random.uniform(r_ctx, (nq,))),
            "q": np.asarray(jax.random.uniform(r_q, (B,)))}


def _jax_steps(batches, pool):
    """One ``make_sharded_train_step`` of each loss over the 2-device data
    mesh from the bridged weights, each compiled and run in a thread of
    ``pool`` (the compiles overlap): {variant: future of (loss, grad
    norm, new parameters in the port's layout)}."""
    import jax
    import jax.numpy as jnp
    from hero_tpu.config.model_config import tiny_hero_config as jcfg_fn
    from hero_tpu.models import pretrain as jpre
    from hero_tpu.parallel.mesh import get_mesh, shard_task_batch
    from hero_tpu.training import step as jstep
    from hero_tpu.training.save import flatten_tree, unflatten_tree

    jcfg, mesh = jcfg_fn(), get_mesh(2)
    params = jax.tree.map(jnp.asarray, unflatten_tree(
        tpre.init_flat_params(tiny_hero_config(), seed=0)))
    state = jstep.shard_state(jstep.TrainState.create(params), mesh)

    def run(variant):
        task, kw = VARIANTS[variant]
        vsm = jpre.VsmConfig(**VSM, **kw)

        def loss_fn(p, batch, rng):
            if task == "vsm":
                a, b, c = jpre.forward_vsm(p, jcfg, vsm, batch)
                return a + b + c, {}
            s, n = jpre.forward_pretrain(p, jcfg, vsm, batch, task)
            return s / jnp.maximum(n, 1.0), {}

        step = jstep.make_sharded_train_step(
            loss_fn, jstep.TrainSpec(**SPEC), mesh, donate=False)
        st, m = step(state, shard_task_batch(batches[task], mesh),
                     jax.random.PRNGKey(0))
        return (float(m["loss"]), float(m["grad_norm"]),
                toptim.tree_leaves(load_jax_params(
                    flatten_tree(jax.device_get(st.params)),
                    device="cpu")))

    return {v: pool.submit(run, v) for v in VARIANTS}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds and the pytest process's references, run
    side by side: world ``main`` runs while this process computes the
    one-process steps, the JAX steps and the one-process ``eval_vcmr``."""
    root = str(tmp_path_factory.mktemp("dp"))
    batches = {task: global_batch(task) for task, _ in VARIANTS.values()}
    for task, b in batches.items():
        np.savez(os.path.join(root, f"batch_{task}.npz"), **b)
    uniforms = _jax_uniforms()
    np.savez(os.path.join(root, "uniforms.npz"), **uniforms)
    _serve_dir(root)
    _pretrain_configs(root)

    procs = _spawn("main", root)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        try:
            jax_futures = _jax_steps(batches, pool)
            params = init_params()
            orig = tpre._sampled_neg_loss
            tpre._sampled_neg_loss = with_uniforms(
                (uniforms["ctx"], uniforms["q"]))
            try:
                single = {v: step_outputs(v, params, batch_to_device(
                    batches[task], "cpu"))
                    for v, (task, _) in VARIANTS.items()}
                cfg, tparams, tbatch = tvc_setup()
                single["tvc"] = step_outputs(
                    ttrain_tvc.make_loss_fn(cfg, 0.1, torch.float32,
                                            train=False),
                    tparams, batch_to_device(tbatch, "cpu"))
            finally:
                tpre._sampled_neg_loss = orig
            # its own split name: the ranks write results_5_val_all.json
            args = teval_drv.build_argparser().parse_args(
                ["--output_dir", os.path.join(root, "serve"),
                 "--checkpoint", "5", "--split", "one"])
            sys.modules["torch.utils.tensorboard"] = None
            one_eval = teval_drv.main(args, device="cpu",
                                      dtype=torch.float32)
        finally:
            sys.modules.pop("torch.utils.tensorboard", None)
            main = _join(procs, "main", root)
        with np.load(os.path.join(root, "resumed", "restore.npz")) as z:
            trunc_step = int(z["__step__"])
        # the restart runs while the JAX steps finish
        procs = _spawn("resume", root)
        try:
            jax_steps = {v: f.result() for v, f in jax_futures.items()}
        finally:
            resume = _join(procs, "resume", root)
    steps = [torch.load(os.path.join(root, f"steps_{r}.pt"))
             for r in range(WORLD)]
    return types.SimpleNamespace(
        root=root, batches=batches, main=main, resume=resume, trunc_step=trunc_step, steps=steps, single=single,
        jax=jax_steps, one_eval=one_eval)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_query_shard_partition():
    """Twin of ``test_multiprocess_eval::test_query_shard_partition``: the
    query shards of W = 3 are disjoint and cover every query in order of
    rank slices; undistributed every rank has them all."""
    class Store:
        def __getitem__(self, k):
            return {"input_ids": [5, 6]}
    qids = [f"q{i}" for i in range(10)]
    shards = [VcmrFullEvalDataset(qids, Store(), None, distributed=True,
                                  rank=r, world_size=3).qids
              for r in range(3)]
    assert sorted(q for s in shards for q in s) == sorted(qids)
    assert all(not set(a) & set(b) for i, a in enumerate(shards)
               for b in shards[i + 1:])
    assert shards[1] == qids[1::3]
    assert VcmrFullEvalDataset(qids, Store(), None, distributed=False,
                               rank=1, world_size=3).qids == qids


def test_init_distributed_env_triplet(worlds):
    """Twin of ``test_init_distributed_env_triplet``: each rank joined the
    group from RANK, WORLD_SIZE and ``$HERO_DIST_INIT_METHOD`` alone, on
    gloo (the CPU), and ``host_allgather`` gives the ranks in order."""
    for r, res in enumerate(worlds.main):
        assert res["rank"] == r and res["backend"] == "gloo"
        assert res["ranks"] == [0, 1]


def _as_rank(monkeypatch, r, world=WORLD):
    monkeypatch.setattr(dist, "rank", lambda: r)
    monkeypatch.setattr(dist, "world_size", lambda: world)


def test_shard_rows_cuts_items_and_rebases_row_indices(monkeypatch):
    """Each rank's contiguous rows of every array (the caption rows with
    their videos, ``cap_vidx`` rebased to the rank's own videos), the
    accumulation axis kept, the curriculum's scalars whole; the two
    ranks' rows together are the global batch."""
    _, _, batch = tvc_setup()
    batch["lw_st_ed"] = np.asarray(0.5, np.float32)
    acc = {k: np.stack([v, v]) for k, v in batch.items()}
    for accum, b in ((1, batch), (2, acc)):
        axis = 1 if accum > 1 else 0
        parts = []
        for r in range(WORLD):
            _as_rank(monkeypatch, r)
            parts.append(dist.shard_rows(
                b, accum, items=B, replicated_keys=("lw_st_ed",),
                row_index_keys=tcommon.ROW_INDEX_KEYS))
        for k, v in b.items():
            if k == "lw_st_ed":
                assert all(p[k] is v for p in parts)
            elif k == "cap_vidx":
                assert all((p[k] == np.repeat(np.arange(B // WORLD), 2))
                           .all() for p in parts)
            else:
                np.testing.assert_array_equal(
                    np.concatenate([p[k] for p in parts], axis), v)
    with pytest.raises(ValueError, match="does not divide by 2 ranks"):
        dist.shard_rows(batch, items=3)
    bad = dict(batch, cap_vidx=np.zeros(2 * B, np.int32))
    with pytest.raises(ValueError, match="another rank's"):
        dist.shard_rows(bad, row_index_keys=tcommon.ROW_INDEX_KEYS)


def test_a_process_without_a_launch_is_a_world_of_one(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", dist.INIT_METHOD_ENV):
        monkeypatch.delenv(k, raising=False)
    assert dist.init_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    assert (dist.world_size(), dist.rank(), dist.is_primary()) == (1, 0, True)
    assert dist.host_allgather("x") == ["x"] and dist.any_rank(True)
    x = torch.arange(3.0, requires_grad=True)
    assert dist.gather_rows(x) is x and dist.replicated(x) is x
    assert dist.fold_rank(7) == 7
    batch = {"a": np.zeros((3, 2))}
    assert dist.shard_rows(batch) is batch
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="incomplete launch"):
        dist.init_distributed("cpu")


@pytest.mark.parametrize("variant", list(VARIANTS) + ["tvc"])
def test_two_rank_step_equals_one_process(worlds, variant):
    """Twin of ``test_two_process_train_matches_single``: the 2-rank gloo
    step on the two halves of the global batch gives the 1-process step's
    loss, grad norm, every gradient and every new parameter at rtol 1e-6,
    on both ranks.  Beside it an absolute bound: for a gradient, 1e-6 of
    its leaf's largest element (two partial sums that cancel); for a
    parameter, the one-device step tests' 2e-6 (AdamW's first step moves
    an element by lr g / (|g| + eps), whose slope at g ~ 0 is lr / eps,
    1e3 here, ``tests/test_torch_pretrain.py``)."""
    loss, gnorm, grads, new = worlds.single[variant]
    for r in range(WORLD):
        rl, rg, rgrads, rnew = worlds.steps[r][variant][:4]
        assert rl == pytest.approx(loss, rel=1e-6)
        assert rg == pytest.approx(gnorm, rel=1e-6)
        for i, (g, w) in enumerate(zip(rgrads, grads)):
            scale = float(w.abs().max()) if w.numel() else 0.0
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-6 * scale,
                                       err_msg=f"{variant} grad {i}")
        for i, (g, w) in enumerate(zip(rnew, new)):
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=1e-6,
                atol=2e-6,
                err_msg=f"{variant} param {i}")
    if variant == "mlm":
        # the halves mask unequal counts: a mean of rank means is not
        # the global mean here
        lab = worlds.batches["mlm"]["mlm_labels"]
        assert (lab[:2] >= 0).sum() != (lab[2:] >= 0).sum()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_rank_step_equals_jax_sharded_step(worlds, variant):
    """Twin of ``test_vsm_global_batch_semantics_under_sharding``: the
    2-rank step equals the JAX step over a 2-device data mesh from the
    same bridged weights (loss and grad norm rel 1e-5, new parameters
    atol 2e-6: the one-device step tests' tolerances)."""
    jl, jg, jparams = worlds.jax[variant]
    for r in range(WORLD):
        rl, rg, _, rnew, _ = worlds.steps[r][variant]
        assert rl == pytest.approx(jl, rel=1e-5)
        assert rg == pytest.approx(jg, rel=1e-5)
        for i, (g, w) in enumerate(zip(rnew, jparams)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-6,
                                       err_msg=f"{variant} param {i}")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_replicas_bit_identical_after_three_dropout_steps(worlds, variant):
    """Three steps with dropout on (each rank its own masks) leave the
    two ranks' parameters equal bit for bit."""
    a, b = (worlds.steps[r][variant][4] for r in range(WORLD))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in
                   zip(a, worlds.steps[0][variant][3]))


def test_dropout_masks_differ_and_shared_draws_agree(worlds):
    """Inside a data-parallel step the ranks draw different dropout masks
    and attention dropout seeds (outside it the same mask); the span-loss
    skips of ``drop_svmr_prob`` and the sampled-negative seeds agree over
    8 step seeds, and both skip outcomes occur."""
    s0, s1 = (res["streams"] for res in worlds.main)
    assert s0["mask"] != s1["mask"] and s0["plain"] == s1["plain"]
    assert all(a != b for a, b in zip(s0["attn_seeds"], s1["attn_seeds"]))
    assert s0["neg_seeds"] == s1["neg_seeds"] and len(s0["neg_seeds"]) == 8
    assert s0["span_kept"] == s1["span_kept"]
    assert len(set(s0["span_kept"])) == 2


def test_guards_raise_on_two_ranks(worlds):
    """``--zero1`` on two ranks now runs (it builds the plain grid of 2
    data ranks; its steps are ``tests/test_torch_parallel.py``'s); a
    global batch of 3 rows or 3 items, and the chunked corpus on two
    ranks, raise, the chunked corpus's message saying that the JAX
    package serves it from one process too (no longer citing A8)."""
    for res in worlds.main:
        g = res["guards"]
        assert g["zero1"] == ["data", 2, 1]
        assert "3 rows" in g["indivisible"] and "2 ranks" in g["indivisible"]
        assert "3 items" in g["items"]
        assert "JAX package" in g["chunked"] and "A8" not in g["chunked"]


def test_two_rank_eval_matches_single(worlds):
    """Twin of ``test_two_process_eval_matches_single``: ``eval_vcmr.main``
    on 2 ranks with ``distributed_eval`` gives both ranks the same merged
    metrics, within the per-rank 2-decimal rounding of the 1-process ones
    (atol 0.05), and a submission holding every query, equal query by
    query to the 1-process submission; the primary alone wrote it."""
    one_met, one_sub = worlds.one_eval
    r0, r1 = (res["eval"] for res in worlds.main)
    assert r0["metrics"] == r1["metrics"] and r0["metrics"]
    for task, m in one_met.items():
        for k, v in m.items():
            assert np.isclose(r0["metrics"][task][k], v, atol=0.05), (task,
                                                                      k)
    one = json.loads(json.dumps(one_sub))
    for res in (r0, r1):
        sub = res["submission"]
        assert sub["video2idx"] == one["video2idx"]
        for task in ("VCMR", "SVMR", "VR"):
            got = {e["desc_id"]: e for e in sub[task]}
            want = {e["desc_id"]: e for e in one[task]}
            assert sorted(got) == sorted(want) and len(got) == 21
            assert len(sub[task]) == 21
            assert got == want, task
    path = os.path.join(worlds.root, "serve", "results_5_val_all.json")
    assert json.loads(pathlib.Path(path).read_text()) == r0["submission"]


def _scalars(root, name):
    """{step: the step's loss, grad norm and lr} of a run's
    ``scalars.jsonl`` (the throughput and the smoothed loss, a meter a
    restart begins anew, left out)."""
    rows = {}
    for line in pathlib.Path(root, name, "log",
                             "scalars.jsonl").read_text().splitlines():
        rec = json.loads(line)
        step = rec.pop("step")
        rows.setdefault(step, {}).update(
            {k: v for k, v in rec.items()
             if k in ("loss", "grad_norm", "lr")})
    return rows


def test_two_rank_resume_after_one_rank_sigterm(worlds):
    """Twin of ``test_two_process_resume_matches_uninterrupted``: SIGTERM
    to rank 1 alone after step 3 stops both ranks after step 3 with
    ``restore.npz`` at step 3; the restarted world ends with the
    uninterrupted world's ``model_step_6.npz`` and ``restore.npz`` bit
    for bit, and rank 0's ``scalars.jsonl`` agrees step for step (steps
    1-3 from the stopped run, 4-6 from the restart).  Only the primary
    wrote the run's files."""
    root = worlds.root
    assert [r["trunc_step"] for r in worlds.main] == [3, 3]
    assert worlds.trunc_step == 3
    assert [r["resumed_step"] for r in worlds.resume] == [6, 6]
    assert all(r["full_step"] == 6 for r in worlds.main)
    for f in ("ckpt/model_step_6.npz", "restore.npz"):
        with np.load(os.path.join(root, "full", f)) as a, \
                np.load(os.path.join(root, "resumed", f)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (f, k)
    full, resumed = _scalars(root, "full"), _scalars(root, "resumed")
    assert sorted(full) == sorted(resumed) == list(range(1, 7))
    assert full == resumed
    assert sorted(os.listdir(os.path.join(root, "resumed", "ckpt"))) == [
        "model_step_3.npz", "model_step_6.npz"]
    log = pathlib.Path(root, "full", "log", "log.txt").read_text()
    assert "training done at step 6" in log


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
