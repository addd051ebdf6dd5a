"""hero_tpu_torch's VideoQA (TVQA/How2QA) and VIOLIN as programs against
the JAX package: the options, ``VideoQaDataset`` / ``ViolinDataset`` and
``build_batch`` (packed and unpacked), ``forward_videoqa`` /
``forward_violin`` (losses, logits and every gradient against
``jax.grad``), the VideoQA/VIOLIN bridge both ways, ``train_videoqa`` /
``train_violin`` against the JAX programs from one reference-layout
``.pt``, ``eval_videoqa`` / ``eval_violin`` against the JAX drivers on
one checkpoint (and each package's checkpoint in the other's eval), the
packed layout against the unpacked one, and ``train_videoqa`` stopped by
SIGTERM in a subprocess and resumed.

One tiny model (``tests/test_drivers_all.py``'s, every dropout rate 0:
the two frameworks' random streams differ) on one 6-video
synthetic corpus of 8-16 frames a video (``max_clip_len`` 16, so padded
frames sit between the frames and the QA tokens of the fused c-encoder
rows), 3 answers a question.  The ``.pt`` holds the pretraining tree with
120 word rows, as the released ``hero-tv-ht100.pt`` does: the QA and
VIOLIN heads come from the init, which both packages take from the
port's numpy init (the JAX programs' eager init is replaced by it).
Everything is fp32 on the CPU, the port on one torch thread; the JAX
programs' bf16 sites (the forwards, the validators) are asked for fp32.
Each JAX program runs once, in a module fixture.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config import opts as jopts
from hero_tpu.data import downstream_tasks as jdt
from hero_tpu.data.store import QueryTokStore as JQueryTokStore
from hero_tpu.drivers import common as jcommon
from hero_tpu.drivers import eval_videoqa as jeval_videoqa
from hero_tpu.drivers import eval_violin as jeval_violin
from hero_tpu.drivers import train_videoqa as jtrain_videoqa
from hero_tpu.drivers import train_violin as jtrain_violin
from hero_tpu.evaluation import downstream as jdownstream
from hero_tpu.models import videoqa as jvideoqa
from hero_tpu.models import violin as jviolin
from hero_tpu.training import save as jsave
from hero_tpu_torch.config import opts as topts
from hero_tpu_torch.convert import from_jax
from hero_tpu_torch.data import downstream_tasks as tdt
from hero_tpu_torch.data import testing as ttesting
from hero_tpu_torch.data.store import QueryTokStore, SubTokStore, \
    VideoFeatStore
from hero_tpu_torch.data.video import FixedShapes, VideoFeatSubTokDataset
from hero_tpu_torch.drivers import common as tcommon
from hero_tpu_torch.drivers import eval_videoqa as teval_videoqa
from hero_tpu_torch.drivers import eval_violin as teval_violin
from hero_tpu_torch.drivers import train_videoqa as ttrain_videoqa
from hero_tpu_torch.drivers import train_violin as ttrain_violin
from hero_tpu_torch.models import pretrain as tpre
from hero_tpu_torch.models import videoqa as tvideoqa
from hero_tpu_torch.models import violin as tviolin
from hero_tpu_torch.training import optim
from hero_tpu_torch.training import save as tsave
from hero_tpu_torch.training.step import loss_and_grads

REPO = pathlib.Path(__file__).resolve().parents[1]
MAX_FRAMES, N_ANSWERS = 16, 3
VOCAB, PT_ROWS = 128, 120
LAYER = {"hidden_size": 32, "num_attention_heads": 4,
         "intermediate_size": 64, "max_position_embeddings": 64,
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
MODEL_CFG = {   # tests/test_drivers_all.py's model, dropout 0
    "f_config": dict(LAYER, num_hidden_layers=1, vocab_size=VOCAB,
                     type_vocab_size=2),
    "c_config": dict(LAYER, num_hidden_layers=1, type_vocab_size=2),
    "q_config": dict(LAYER, num_hidden_layers=0, vocab_size=VOCAB,
                     type_vocab_size=1),
}
# task -> (the JAX and port train / eval modules, option parsers, the
# port's init and bridge, the eval results file)
TASKS = {
    "videoqa": dict(jtrain=jtrain_videoqa, jeval=jeval_videoqa,
                    ttrain=ttrain_videoqa, teval=teval_videoqa,
                    jargs=jopts.get_videoqa_args,
                    targs=topts.get_videoqa_args,
                    init=tvideoqa.init_hero_for_videoqa,
                    load=from_jax.load_jax_videoqa_params,
                    to_jax=from_jax.to_jax_videoqa_params,
                    results="qa_results_4_all.json"),
    "violin": dict(jtrain=jtrain_violin, jeval=jeval_violin,
                   ttrain=ttrain_violin, teval=teval_violin,
                   jargs=jopts.get_violin_args, targs=topts.get_violin_args,
                   init=tviolin.init_hero_for_violin,
                   load=from_jax.load_jax_violin_params,
                   to_jax=from_jax.to_jax_violin_params,
                   results="violin_results_4_all.json"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """Both programs' scalar writers keep to JSONL."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# the pooler kernels: no loss reads them, and AdamW decays them
POOLER_KERNELS = tuple(f"v_encoder/{e}/pooler/dense/kernel"
                       for e in ("f_encoder", "c_encoder"))


def _assert_restore_files_close(tdir, jdir):
    """The port's ``restore.npz`` against the JAX run's: the same keys,
    the step equal, every parameter and AdamW moment within the
    parameters' atol 1e-5."""
    got = _npz(os.path.join(tdir, "restore.npz"))
    want = _npz(os.path.join(jdir, "restore.npz"))
    assert sorted(got) == sorted(want)
    assert int(got.pop("__step__")) == int(want.pop("__step__"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The 6-video corpus (``qa_query``: a question and 3 answers a video;
    ``violin_query``: a ``_0``/``_1`` pair a video), MODEL_CFG in both
    packages, the pretraining tree of the port's init at seed 9 written as
    a reference ``.pt`` with 120 word rows, each task's init at the run
    seed, and ``cfg(name, task, **over)``, which writes a run config
    (``tests/test_drivers_all.py``'s options: 4 steps of 2 items, a
    validation at step 4, ``restore.npz`` every 2 steps; sub rows of 12
    frames + 16 tokens, so a long sub's appended QA text is cut) and
    returns its path."""
    root = str(tmp_path_factory.mktemp("qa_program"))
    corpus = ttesting.build_synthetic_corpus(root, n_videos=6,
                                             max_frames=MAX_FRAMES,
                                             vfeat_dim=64,
                                             n_answers=N_ANSWERS)
    mc = os.path.join(root, "model.json")
    with open(mc, "w") as f:
        json.dump(MODEL_CFG, f)
    ns = types.SimpleNamespace(model_config=mc, max_clip_len=MAX_FRAMES,
                               vfeat_dim=64)
    tcfg = tcommon.model_config_from_opts(ns)
    pt = os.path.join(root, "hero-tv.pt")
    pre = tpre.init_flat_params(tcfg, seed=9)
    torch.save({"model": ttesting.reference_state_dict(pre, PT_ROWS)}, pt)
    seed = 3
    base = dict(
        sub_txt_db=corpus["sub"], vfeat_db=corpus["vfeat"], model_config=mc,
        checkpoint=pt, max_clip_len=MAX_FRAMES, max_txt_len=12,
        vfeat_interval=1.5, vfeat_dim=64, train_batch_size=2,
        val_batch_size=4, gradient_accumulation_steps=1,
        learning_rate=5e-4, lr_mul=2.0, valid_steps=4, save_steps=2,
        num_train_steps=4, warmup_steps=1, grad_norm=1.0, sub_ctx_len=0,
        seed=seed, bucket_n_subs=4, bucket_frames_per_sub=12,
        bucket_txt_len=16, bucket_query_len=24)
    task_over = {
        "videoqa": dict(task="tvqa", train_query_txt_db=corpus["qa_query"],
                        val_query_txt_db=corpus["qa_query"],
                        num_answers=N_ANSWERS, lw_st_ed=0.4),
        "violin": dict(task="violin",
                       train_query_txt_db=corpus["violin_query"],
                       val_query_txt_db=corpus["violin_query"]),
    }

    def cfg(name, task, **over):
        d = dict(base, **task_over[task],
                 output_dir=os.path.join(root, name), **over)
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(d, f)
        return path

    inits = {t: TASKS[t]["init"](tcfg, seed=seed) for t in TASKS}
    return types.SimpleNamespace(
        root=root, corpus=corpus, cfg=cfg, pt=pt, tcfg=tcfg,
        jcfg=jcommon.model_config_from_opts(ns), inits=inits,
        templates={t: tcommon.load_checkpoint_into(inits[t], pt, VOCAB)
                   for t in TASKS})


def _jax_fp32(fn):
    """``fn`` with ``dtype`` forced to fp32 (the JAX programs' bf16
    sites)."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        return fn(*a, **dict(k, dtype=jnp.float32))
    return wrapped


def _jax_patches(mp, env):
    """The JAX programs in fp32 (both forwards, both validators as the
    drivers import them), their eager inits replaced by the port's trees
    at the run seed."""
    mp.setattr(jvideoqa, "forward_videoqa",
               _jax_fp32(jvideoqa.forward_videoqa))
    mp.setattr(jviolin, "forward_violin", _jax_fp32(jviolin.forward_violin))
    for mod in (jtrain_videoqa, jeval_videoqa):
        mp.setattr(mod, "validate_videoqa", _jax_fp32(
            jdownstream.validate_videoqa))
    for mod in (jtrain_violin, jeval_violin):
        mp.setattr(mod, "validate_violin", _jax_fp32(
            jdownstream.validate_violin))
    for mod, name, task in ((jvideoqa, "init_hero_for_videoqa", "videoqa"),
                            (jviolin, "init_hero_for_violin", "violin")):
        tree = jax.tree.map(jnp.asarray, jsave.unflatten_tree(
            env.inits[task]))
        mp.setattr(mod, name, lambda rng, cfg, tree=tree: tree)


# ---------------------------------------------------------------------------
# the options and the datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", list(TASKS))
def test_options_equal_jax(env, task):
    """``get_videoqa_args`` / ``get_violin_args`` give the JAX parsers'
    namespace for a run config and for the defaults (``--task tvqa``,
    ``lw_st_ed`` 0.4, 5 answers, the eval flags; ``bucket_query_len`` the
    base parser's 32)."""
    path = env.cfg("opts", task)
    for argv in (["--config", path], ["--config", path, "--pack_subs",
                                      "--seed", "5"], []):
        got = vars(TASKS[task]["targs"](argv))
        want = vars(TASKS[task]["jargs"](argv))
        assert got == want
    defaults = vars(TASKS[task]["targs"]([]))
    assert defaults["bucket_query_len"] == 32
    if task == "videoqa":
        assert (defaults["task"], defaults["lw_st_ed"],
                defaults["num_answers"]) == ("tvqa", 0.4, 5)
        assert defaults["full_eval_tasks"] == ["VCMR", "SVMR", "VR"]
    else:
        assert defaults["task"] == "violin"


def _video_dbs(env, task, pack=False):
    """The sub dataset of the run config in both packages (packed rows of
    2 x (32 f + 48 t) with ``pack``)."""
    over = dict(bucket_n_subs=2, bucket_txt_len=48,
                bucket_frames_per_sub=32) if pack else {}
    argv = ["--config", env.cfg("data", task, **over)]
    opts = TASKS[task]["jargs"](argv + (["--pack_subs"] if pack else []))
    return opts, [c.load_video_sub_dataset(opts, c.shapes_from_opts(opts))
                  for c in (tcommon, jcommon)]


def _assert_items_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def _datasets(env, task, pack=False):
    opts, (tvideo, jvideo) = _video_dbs(env, task, pack)
    path = opts.train_query_txt_db
    if task == "videoqa":
        t = ttrain_videoqa.videoqa_dataset(tvideo, path, opts)
        jq = JQueryTokStore(path, max_txt_len=opts.max_txt_len)
        j = jdt.VideoQaDataset(list(jq.id2len.keys()), jvideo, jq,
                               qa_len=opts.bucket_query_len)
    else:
        t = ttrain_violin.violin_dataset(tvideo, path, opts)
        jq = JQueryTokStore(path, max_txt_len=opts.max_txt_len)
        j = jdt.ViolinDataset([q for q in jq.id2len if q.endswith("_0")],
                              jvideo, jq, stmt_len=opts.bucket_query_len)
    return opts, t, j


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("task", list(TASKS))
def test_dataset_equals_jax(env, task, pack):
    """Twins of ``test_data_layer::test_videoqa_dataset`` /
    ``test_violin_dataset``: every item of ``VideoQaDataset`` (3 answer
    rows a question) and ``ViolinDataset`` (the ``_0`` statement and its
    ``_1`` pair), and ``build_batch(flatten_rows=True)`` of three of them,
    bit for bit the JAX package's, unpacked (the QA / statement text
    appended to every sub, cut at 16 slots) and packed (a copy in every
    segment, the four packed seg/pos keys kept); ``_append_txt_to_subs``
    and ``get_paired_statement_id`` likewise."""
    opts, t, j = _datasets(env, task, pack)
    rows = N_ANSWERS if task == "videoqa" else 2
    assert len(t) == len(j) == 6
    cut = 0
    for i in range(len(j)):
        _assert_items_equal(t[i], j[i])
        base = t.video_db.video_item(t[i]["__vid__"])
        assert t[i]["sub_input_ids"].shape[0] == rows
        cut += int((t[i]["sub_txt_mask"].sum(-1)
                    == t.video_db.shapes.txt_len).sum())
        if not pack:
            assert (t[i]["sub_txt_mask"].sum(-1)
                    >= base["sub_txt_mask"].sum(-1)).all()
    assert cut > 0 or pack         # some rows are full: the append was cut
    got = tdt.build_batch(t, [0, 2, 5], flatten_rows=True)
    _assert_items_equal(got, jdt.build_batch(j, [0, 2, 5],
                                             flatten_rows=True))
    assert got["sub_input_ids"].shape[0] == 3 * rows
    if task == "videoqa":
        assert got["targets"].shape == (3,) and got["ts_targets"].shape == (
            3, 2)
        assert got["qa_input_ids"].shape == (3 * rows, 24)
    else:
        assert got["targets"].shape == (3, 2)
        assert set(got["targets"].reshape(-1)) == {0, 1}
    packed_keys = {"sub_txt_seg", "sub_txt_pos", "sub_frame_seg",
                   "sub_frame_pos"}
    assert packed_keys <= set(got) if pack else not packed_keys & set(got)
    if not pack:
        base = t.video_db.video_item("vid1")
        extra = list(range(3, 15))
        _assert_items_equal(
            tdt._append_txt_to_subs(base, extra, t.video_db.shapes, 1),
            jdt._append_txt_to_subs(base, extra, j.video_db.shapes, 1))
    for q in ("s3_0", "s3_1", "x_0"):
        assert tdt.get_paired_statement_id(q) == \
            jdt.get_paired_statement_id(q)


# ---------------------------------------------------------------------------
# the heads
# ---------------------------------------------------------------------------

def _head_inputs(env, task):
    """An unpacked batch of 3 items (one video of fewer frames than
    ``max_clip_len``) as numpy, and the task's init tree."""
    opts, t, _ = _datasets(env, task)
    batch = {k: v for k, v in tdt.build_batch(
        t, [0, 1, 3], flatten_rows=True).items() if not k.startswith("__")}
    assert (batch["c_attn_masks"].sum(-1) < MAX_FRAMES).any()
    if task == "violin":
        batch["targets"] = batch["targets"].reshape(-1)
    return batch, env.templates[task]


def _forward(task, pkg):
    if task == "videoqa":
        mod = tvideoqa if pkg == "torch" else jvideoqa
        return functools.partial(mod.forward_videoqa, num_answers=N_ANSWERS)
    return (tviolin if pkg == "torch" else jviolin).forward_violin


@pytest.mark.parametrize("task", list(TASKS))
def test_forward_equals_jax(env, task):
    """Twins of ``test_task_heads::test_videoqa`` / ``test_violin``:
    ``forward_videoqa`` (qa and temporal losses, the (3, 3) logits) and
    ``forward_violin`` (the BCE loss, the (6, 1) logits), and every
    gradient of the training loss (``qa + 0.4 st_ed``; the BCE) against
    ``jax.grad`` bridged to the port's tree, within atol 1e-5, on one
    bridged tree and a batch holding a video of fewer frames than
    ``max_clip_len``."""
    batch, flat = _head_inputs(env, task)
    tfwd, jfwd = _forward(task, "torch"), _forward(task, "jax")
    params = TASKS[task]["load"](flat, device="cpu")
    jparams = jax.tree.map(jnp.asarray, jsave.unflatten_tree(flat))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def total(out):
        return out[0] + 0.4 * out[1] if task == "videoqa" else out

    def jall(p, b):                     # one JAX compile for all of it
        def jloss(p):
            out = jfwd(p, env.jcfg, b)
            return total(out), out
        (jl, out), jg = jax.value_and_grad(jloss, has_aux=True)(p)
        return out, jfwd(p, env.jcfg, b, compute_loss=False), jl, jg

    jout, jlogits, jl, jg = jax.jit(jall)(jparams, jb)
    for compute_loss, want in ((True, jout), (False, jlogits)):
        got = tfwd(params, env.tcfg, tb, compute_loss=compute_loss)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                       atol=1e-5)
    assert w.shape == ((3, N_ANSWERS) if task == "videoqa" else (6, 1))

    def tloss(p, b, seed):
        return total(tfwd(p, env.tcfg, b)), {}

    loss, _, grads = loss_and_grads(tloss, params, tb, None)
    np.testing.assert_allclose(float(loss), float(jl), rtol=0, atol=1e-5)
    want = TASKS[task]["load"](jax.tree.map(np.asarray,
                                            jsave.flatten_tree(jg)),
                               device="cpu")
    paths = ["/".join(p) for p in optim.tree_paths(grads)]
    nonzero = 0
    for path, g, w in zip(paths, optim.tree_leaves(grads),
                          optim.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=path)
        nonzero += bool(w.abs().max() > 0)
    heads = [p for p in paths if p.startswith("head/")]
    assert heads and nonzero > len(paths) // 2


@pytest.mark.parametrize("task", list(TASKS))
def test_packed_equals_unpacked(env, task):
    """Twins of ``test_packing::test_videoqa_packed_equivalence`` /
    ``test_violin_packed_equivalence`` (port only): the same questions
    (statements) through ``--pack_subs`` rows, where every packed segment
    carries its own copy of the appended text, and through one sub a row
    (no text cut in either bucket), give the loss within rtol 2e-4, the
    logits within 3e-4 and gradients whose difference has a norm within
    2e-3 of theirs, JAX's tolerances."""
    corpus = env.corpus
    sub = SubTokStore(corpus["sub"], max_clip_len=MAX_FRAMES)
    vfeat = VideoFeatStore(corpus["vfeat"], max_clip_len=MAX_FRAMES)
    shapes = dict(n_frames=MAX_FRAMES, n_queries=2, query_len=16,
                  max_masked=6, vfeat_dim=64)
    plain = VideoFeatSubTokDataset(
        sub, vfeat, FixedShapes(n_subs=4, txt_len=32, frames_per_sub=16,
                                **shapes), max_txt_len=8)
    packed = VideoFeatSubTokDataset(
        sub, vfeat, FixedShapes(n_subs=2, txt_len=64, frames_per_sub=32,
                                **shapes), max_txt_len=8, pack=True)
    qpath = corpus["qa_query" if task == "videoqa" else "violin_query"]
    qdb = QueryTokStore(qpath)

    def batch_of(db):
        if task == "videoqa":
            ds = tdt.VideoQaDataset(sorted(qdb.id2len)[:3], db, qdb,
                                    qa_len=16)
        else:
            ds = tdt.ViolinDataset([q for q in sorted(qdb.id2len)
                                    if q.endswith("_0")][:2], db, qdb,
                                   stmt_len=16)
        b = tdt.build_batch(ds, list(range(len(ds))), flatten_rows=True)
        return {k: torch.from_numpy(np.asarray(v).reshape(-1)
                                    if k == "targets" and task == "violin"
                                    else v)
                for k, v in b.items() if not k.startswith("__")}

    ba, bb = batch_of(plain), batch_of(packed)
    assert "sub_txt_seg" in bb and "sub_txt_seg" not in ba
    va = ba["sub_input_ids"][ba["sub_txt_mask"] > 0]
    vb = bb["sub_input_ids"][bb["sub_txt_mask"] > 0]
    assert sorted(va.tolist()) == sorted(vb.tolist())
    assert plain.truncation_report()["txt_tokens_dropped"] == 0
    assert packed.truncation_report()["txt_tokens_dropped"] == 0
    params = TASKS[task]["load"](TASKS[task]["init"](env.tcfg, seed=4),
                                 device="cpu")
    fwd = _forward(task, "torch")

    def loss_fn(p, b, seed):
        out = fwd(p, env.tcfg, b)
        return (out[0] + 0.4 * out[1] if task == "videoqa" else out), {}

    la, _, ga = loss_and_grads(loss_fn, params, ba, None)
    lb, _, gb = loss_and_grads(loss_fn, params, bb, None)
    np.testing.assert_allclose(float(la), float(lb), rtol=2e-4)
    logits_a = fwd(params, env.tcfg, ba, compute_loss=False)
    logits_b = fwd(params, env.tcfg, bb, compute_loss=False)
    np.testing.assert_allclose(logits_a.detach().numpy(),
                               logits_b.detach().numpy(), atol=3e-4,
                               rtol=3e-4)
    ga, gb = optim.tree_leaves(ga), optim.tree_leaves(gb)
    na = torch.sqrt(sum((x * x).sum() for x in ga))
    diff = torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(ga, gb)))
    assert float(diff) <= 2e-3 * max(float(na), 1e-6), (float(diff),
                                                        float(na))


# ---------------------------------------------------------------------------
# the programs against the JAX programs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def programs(env):
    """``programs(task)``: the JAX program's and the port's run of the
    task on one config each, run once: (jax dir, port dir, port options,
    port final state)."""
    done = {}

    def run(task):
        if task not in done:
            t = TASKS[task]
            jpath = env.cfg(f"jax_{task}", task)
            with pytest.MonkeyPatch.context() as mp:
                _jax_patches(mp, env)
                t["jtrain"].main(t["jargs"](["--config", jpath]))
            topt = t["targs"](["--config", env.cfg(f"torch_{task}", task)])
            state = t["ttrain"].main(topt, device="cpu",
                                     dtype=torch.float32)
            done[task] = (os.path.join(env.root, f"jax_{task}"),
                          topt.output_dir, topt, state)
        return done[task]
    return run


@pytest.mark.parametrize("task", list(TASKS))
def test_train_program_matches_jax(env, programs, task):
    """Twins of ``test_drivers_all::test_videoqa_driver_and_eval`` /
    ``test_violin_driver_and_eval`` (their training halves), against the
    JAX programs on the same config from the same ``.pt``: every key of
    ``model_step_4.npz``, and every parameter and moment of
    ``restore.npz``, within atol 1e-5 of the JAX run's, the poolers and
    the pretraining task heads (which no loss reads) moved by weight
    decay alone as JAX's were; both files marked ``__vocab_padded__``;
    ``restore.npz`` at steps 2 and 4 in ``log/checkpoints.json``; the
    step-4 validation's answers and accuracy in ``val_results_4.json``;
    the port's step-4 file bridged back equal to its final state."""
    jdir, tdir, topt, state = programs(task)
    assert state.global_step == 4
    template = env.templates[task]
    got = _npz(os.path.join(tdir, "ckpt", "model_step_4.npz"))
    want = _npz(os.path.join(jdir, "ckpt", "model_step_4.npz"))
    assert sorted(got) == sorted(want) == sorted(
        [*template, "__vocab_padded__"])
    assert bool(got.pop("__vocab_padded__")) is True
    assert bool(want.pop("__vocab_padded__")) is True
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
        moved += not np.array_equal(want[k], template[k])
    assert moved > len(want) // 2
    for k in POOLER_KERNELS:
        assert not np.array_equal(got[k], template[k]), k
    _assert_restore_files_close(tdir, jdir)
    for k in ("v_encoder/fom_output/linear_1/kernel",
              "v_encoder/f_encoder/lm_head/dense/kernel"):
        assert not np.array_equal(got[k], template[k]), k
    back = TASKS[task]["load"](got, device="cpu")
    for a, b in zip(optim.tree_leaves(back),
                    optim.tree_leaves(state.params)):
        assert torch.equal(a, b)
    rec = _json(os.path.join(tdir, "log", "checkpoints.json"))
    assert [r["step"] for r in rec["model"]] == [4]
    assert [r["step"] for r in rec["restore"]] == [2, 4]
    assert _json(os.path.join(tdir, "log", "hps.json")) == vars(topt)
    val = _json(os.path.join(tdir, "val_results_4.json"))
    n = 6 if task == "videoqa" else 12
    assert val["log"]["n_ex"] == n and len(val["results"]) == n
    assert 0.0 <= val["log"]["acc"] <= 1.0


@pytest.mark.parametrize("task", list(TASKS))
def test_eval_program_matches_jax(env, programs, task):
    """Twins of the serving halves of
    ``test_videoqa_driver_and_eval`` / ``test_violin_driver_and_eval``:
    the JAX ``eval_videoqa`` / ``eval_violin`` and the port's on the
    port's run directory at step 4 (a port checkpoint in the JAX eval)
    write equal results files and logs (``n_ex`` 6 questions, 12
    statements); the port's eval on the JAX run's directory (a JAX
    checkpoint in the port's eval) answers the same; the answers equal
    the run's step-4 validation; ``--save_logits`` writes the logits of
    every question."""
    jdir, tdir, _, _ = programs(task)
    t = TASKS[task]
    argv = ["--output_dir", tdir, "--checkpoint", "4"]
    path = os.path.join(tdir, t["results"])
    with pytest.MonkeyPatch.context() as mp:
        _jax_patches(mp, env)
        jlog, _ = t["jeval"].main(t["jeval"].build_argparser().parse_args(
            argv))
    want = _json(path)
    os.remove(path)
    if task == "videoqa":
        argv.append("--save_logits")
    targs = t["teval"].build_argparser().parse_args(argv)
    tlog, results = t["teval"].main(targs, device="cpu",
                                    dtype=torch.float32)
    assert _json(path) == want
    assert tlog == jlog and tlog["n_ex"] == (6 if task == "videoqa" else 12)
    assert {str(k): v for k, v in results.items()} == want
    assert _json(os.path.join(tdir, "val_results_4.json")) == {
        "log": tlog, "results": want}
    if task == "videoqa":
        import pickle
        with open(path.replace(".json", "_logits.pkl"), "rb") as f:
            logits = pickle.load(f)
        assert sorted(map(str, logits)) == sorted(want)
        assert all(v.shape == (N_ANSWERS,) for v in logits.values())
    targs = t["teval"].build_argparser().parse_args(
        ["--output_dir", jdir, "--checkpoint", "4"])
    jdir_log, jdir_results = t["teval"].main(targs, device="cpu",
                                             dtype=torch.float32)
    assert {str(k): v for k, v in jdir_results.items()} == want
    assert jdir_log == jlog


@pytest.mark.parametrize("task", list(TASKS))
def test_bridge_inverts(env, task):
    """The VideoQA / VIOLIN bridge: ``load(to_jax(p, t)) == p`` and
    ``to_jax(load(t), t) == t`` bit for bit, the poolers unread; a key
    the tree lacks or does not hold raises; ``training/save.TREES`` has
    both trees."""
    flat = env.templates[task]
    p = TASKS[task]["load"](flat, device="cpu")
    back = TASKS[task]["to_jax"](p, flat)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    again = TASKS[task]["load"](back, device="cpu")
    for a, b in zip(optim.tree_leaves(again), optim.tree_leaves(p)):
        assert torch.equal(a, b)
    assert task in tsave.TREES
    head = next(k for k in flat if k.startswith("head/"))
    with pytest.raises(KeyError, match="missing"):
        TASKS[task]["load"]({k: v for k, v in flat.items() if k != head},
                            device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        TASKS[task]["load"](dict(flat, **{"head/extra/kernel": flat[head]}),
                            device="cpu")


# run in a fresh interpreter: main on the CPU with SIGTERM sent after step
# 2 (signal handlers need the main thread, which a test worker may not be)
_INTERRUPTED = """
import os, signal, sys, threading
sys.modules["torch.utils.tensorboard"] = None
import torch
torch.set_num_threads(1)
from hero_tpu_torch.config import opts
from hero_tpu_torch.drivers import train_videoqa

def on_step(step, task, metrics):
    if step == 2:
        os.kill(os.getpid(), signal.SIGTERM)

state = train_videoqa.main(
    opts.get_videoqa_args(["--config", sys.argv[1]]), device="cpu",
    on_step=on_step, dtype=torch.float32)
assert state.global_step == 2, state.global_step
assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
assert threading.active_count() == 1, threading.enumerate()
"""


def test_main_resumed_after_sigterm_equals_the_uninterrupted_run(env,
                                                                 programs):
    """``train_videoqa`` stopped by SIGTERM after step 2 leaves
    ``restore.npz`` and the model at step 2; resumed from the ``.pt``
    config, it skips the batches taken and ends with the uninterrupted
    run's ``model_step_4.npz``, ``restore.npz`` and step-4 validation,
    bit for bit."""
    _, adir, _, _ = programs("videoqa")
    path = env.cfg("resumed", "videoqa")
    out = os.path.join(env.root, "resumed")
    penv = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _INTERRUPTED, path],
                          cwd=env.root, env=penv, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(os.path.join(out, "restore.npz")) as z:
        assert int(z["__step__"]) == 2
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "model_step_2.npz"]
    state = ttrain_videoqa.main(topts.get_videoqa_args(["--config", path]),
                                device="cpu", dtype=torch.float32)
    assert state.global_step == 4
    for name in ("ckpt/model_step_4.npz", "restore.npz"):
        got, want = (_npz(os.path.join(d, name)) for d in (out, adir))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert _json(os.path.join(out, "val_results_4.json")) == _json(
        os.path.join(adir, "val_results_4.json"))
    rec = _json(os.path.join(out, "log", "checkpoints.json"))
    assert rec["restore_ms"] > 0 and [r["step"] for r in rec["model"]] == [4]


@pytest.mark.parametrize("program", ["train_videoqa", "eval_videoqa",
                                     "train_violin", "eval_violin"])
def test_programs_default_to_the_card(env, programs, program, tmp_path):
    """Without a card the default device raises before any work (no
    output directory is made, no results file written), instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    task = program.split("_")[1]
    t = TASKS[task]
    out = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if program.startswith("eval"):
            _, tdir, _, _ = programs(task)
            out = os.path.join(tdir, t["results"].replace("_4_", "_none_"))
            t["teval"].main(t["teval"].build_argparser().parse_args(
                ["--output_dir", tdir, "--checkpoint", "none"]))
        else:
            t["ttrain"].main(t["targs"](
                ["--config", env.cfg("nocard", task), "--output_dir",
                 out]))
    assert not os.path.exists(out)
