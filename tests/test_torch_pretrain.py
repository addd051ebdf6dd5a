"""hero_tpu_torch pretraining against the JAX package: the MLM, MFM (NCE
and regression), FOM and VSM forwards with every parameter gradient, the
NCE row cap, the sampled-negative VSM loss, a train step of each task,
rematerialisation, the task datasets, the MetaLoader, the synthetic task
batches, the options, the validators and the driver.

Everything is fp32 on the CPU with dropout off (the two frameworks'
random streams differ); the weights are the port's numpy init in the JAX
layout, bridged into both packages.  The JAX gradient and step functions
are jitted once per module: one compile for each batch layout's
gradients, one for the train steps of the five tasks, and the
validators' own.
"""

import dataclasses
import json
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config import opts as jopts
from hero_tpu.config.model_config import tiny_hero_config as jax_tiny_config
from hero_tpu.data import loader as jloader
from hero_tpu.data import pretrain_tasks as jpt
from hero_tpu.data import synthetic as jsyn
from hero_tpu.data import video as jvideo
from hero_tpu.data.store import SubTokStore, VideoFeatStore
from hero_tpu_torch.data import store as tstore
from hero_tpu.data.testing import build_synthetic_corpus
from hero_tpu.drivers import common as jcommon
from hero_tpu.evaluation import pretrain_val as jval
from hero_tpu.models import model as jmodel
from hero_tpu.models import pretrain as jpre
from hero_tpu.training import step as jstep
from hero_tpu.training.save import flatten_tree, unflatten_tree
from hero_tpu_torch.config import opts as topts
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert.from_jax import load_jax_params
from hero_tpu_torch.data import loader as tloader
from hero_tpu_torch.data import pretrain_tasks as tpt
from hero_tpu_torch.data import synthetic as tsyn
from hero_tpu_torch.data import video as tvideo
from hero_tpu_torch.drivers import common as tcommon
from hero_tpu_torch.drivers import pretrain as tdrv
from hero_tpu_torch.evaluation import pretrain_val as tval
from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
from hero_tpu_torch.models import model as tmodel
from hero_tpu_torch.models import pretrain as tpre
from hero_tpu_torch.models import transformer as ttrm
from hero_tpu_torch.training import optim as toptim
from hero_tpu_torch.training import step as tstep
from tests.test_torch_models import PACKED_TINY, tiny_videos

TASKS = ("mlm", "mfm-nce", "mffr", "fom", "vsm")
VSM = dict(lw_neg_ctx=1.0, lw_neg_q=1.0, lw_st_ed=0.5)
# the curriculum's arguments, hard negatives on: a pool of 2 of the 2-3
# negatives, weight 10, and a span weight in place of VSM's
CURRICULUM = dict(use_hard_negative=True, hard_pool_size=2,
                  hard_neg_weight=10.0, lw_st_ed=0.25)
SPEC = dict(learning_rate=1e-3, warmup_steps=1, num_train_steps=100,
            grad_norm=2.0)
MAX_FRAMES = 16
STORE_SHAPES = tvideo.FixedShapes(n_subs=4, txt_len=24, frames_per_sub=12,
                                  n_frames=MAX_FRAMES, n_queries=2,
                                  query_len=16, max_masked=4, vfeat_dim=64)


def _to_port(jtree):
    return load_jax_params(flatten_tree(jax.device_get(jtree)), device="cpu")


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _batch(task, layout):
    """The synthetic batch of ``task`` (VSM's queries on the MLM rows of
    ``vsm_batch``) in the unpacked (``TINY``) or packed (TV-shaped tiny
    videos) layout."""
    if layout == "unpacked":
        return jsyn.task_batch(task, jsyn.TINY, seed=3)
    b, _ = jsyn.tv_task_batch(task, tiny_videos(4, PACKED_TINY.batch),
                              PACKED_TINY, packed=True, seed=5)
    return b


def _assert_trees_close(got, want, atol, rtol=0.0):
    for path, g, w in zip(toptim.tree_paths(want), toptim.tree_leaves(got),
                          toptim.tree_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), atol=atol,
                                   rtol=rtol, err_msg="/".join(path))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny_config()
    flat = tpre.init_flat_params(tiny_hero_config(), seed=0)
    params = jax.tree.map(jnp.asarray, unflatten_tree(flat))
    return jcfg, params, load_jax_params(flat, device="cpu")


def _jax_loss(jcfg, task, curriculum=None):
    vsm = jpre.VsmConfig(**VSM)

    def loss_fn(p, batch, rng):
        if task == "vsm":
            a, b, c = jpre.forward_vsm(p, jcfg, vsm, batch,
                                       **(curriculum or {}))
            return a + b + c, {}
        s, n = jpre.forward_pretrain(p, jcfg, vsm, batch, task)
        return s / jnp.maximum(n, 1.0), {}
    return loss_fn


def _port_loss(task, train=False, curriculum=None):
    cfg, vsm = tiny_hero_config(), tpre.VsmConfig(**VSM)

    def loss_fn(p, batch, seed):
        if task == "vsm":
            a, b, c = tpre.forward_vsm(p, cfg, vsm, batch, train=train,
                                       seed=seed, **(curriculum or {}))
            return a + b + c, {}
        s, n = tpre.forward_pretrain(p, cfg, vsm, batch, task, train=train,
                                     seed=seed)
        return s / torch.clamp(n, min=1.0), {}
    return loss_fn


# ---------------------------------------------------------------------------
# the task forwards: loss and every parameter gradient
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_task_grads(setup):
    """jax.value_and_grad of each task's loss (VSM with the curriculum's
    arguments) in each layout: one jitted function over the five tasks,
    one compile a layout."""
    jcfg, params, _ = setup
    fns = {t: jax.value_and_grad(_jax_loss(
        jcfg, t, CURRICULUM if t == "vsm" else None), has_aux=True)
        for t in TASKS}

    @jax.jit
    def all_tasks(p, batches):
        return {t: fns[t](p, batches[t], None) for t in TASKS}

    out = {}
    for layout in ("unpacked", "packed"):
        res = all_tasks(params, {t: _jnp(_batch(t, layout)) for t in TASKS})
        out[layout] = {t: (float(res[t][0][0]), _to_port(res[t][1]))
                       for t in TASKS}
    return out


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("task", ["mlm", "mfm-nce", "mffr", "fom"])
def test_task_loss_and_grads_match_jax(setup, jax_task_grads, task, layout):
    _, _, tparams = setup
    want_loss, want_grads = jax_task_grads[layout][task]
    loss, _, grads = tstep.loss_and_grads(
        _port_loss(task), tparams, batch_to_device(_batch(task, layout),
                                                   "cpu"), None)
    # fp32 sums in other orders through 2+1 post-LN layers and the heads
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    # every gradient (test_torch_train.py's tolerance)
    _assert_trees_close(grads, want_grads, atol=1e-5)
    assert any(float(g.abs().max()) > 0 for g in toptim.tree_leaves(grads))


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
def test_forward_vsm_curriculum_matches_jax(setup, jax_task_grads, layout):
    """forward_vsm with hard-negative mining on and the span weight of the
    curriculum, loss and every gradient."""
    _, _, tparams = setup
    want_loss, want_grads = jax_task_grads[layout]["vsm"]
    loss, _, grads = tstep.loss_and_grads(
        _port_loss("vsm", curriculum=CURRICULUM), tparams,
        batch_to_device(_batch("vsm", layout), "cpu"), None)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    _assert_trees_close(grads, want_grads, atol=1e-5)


@pytest.mark.parametrize("mask_prob,N,clips", [
    (0.15, 3200, 32), (0.15, 160, 2), (0.15, 32, 2), (0.3, 3200, 32),
    (0.5, 1000, 10), (0.05, 100000, 1000), (0.15, 1, 1), (0.9, 64, 64)])
def test_mfm_nce_row_cap_matches_jax(mask_prob, N, clips):
    got = tmodel._mfm_nce_row_cap(mask_prob, N, n_clips=clips)
    assert got == jmodel._mfm_nce_row_cap(mask_prob, N, n_clips=clips)
    assert got <= N and (got % 128 == 0 or got == N)
    if (mask_prob, N, clips) == (0.15, 3200, 32):
        assert got == 896       # the recipe's cap at batch 32


@pytest.mark.parametrize("loss_type", ["hinge", "lse"])
@pytest.mark.parametrize("hard", [False, True])
def test_sampled_neg_loss_matches_jax(loss_type, hard):
    """Twin of tests/test_training.py::test_sampled_neg_branch: the
    port's ``_sampled_neg_loss`` fed the uniforms the JAX function draws
    from its own split keys gives its losses; one padded query."""
    r = np.random.RandomState(13)
    nv, q = 5, 2
    nq = nv * q
    scores = r.uniform(-1, 1, (nq, nv)).astype(np.float32)
    q_mask = np.ones(nq, np.float32)
    q_mask[3] = 0.0
    pos_vid = np.arange(nq) // q
    pos = scores[np.arange(nq), pos_vid]
    masked = scores.copy()
    masked[np.arange(nq), pos_vid] = 999.0
    vsm_kw = dict(use_all_neg=False, ranking_loss_type=loss_type, margin=0.1)
    rng = jax.random.PRNGKey(7 + hard)
    ja, jb = jpre._sampled_neg_loss(
        jnp.asarray(masked), jnp.asarray(pos), jnp.asarray(q_mask), q,
        jpre.VsmConfig(**vsm_kw), use_hard_negative=hard, hard_pool_size=2,
        rng=rng)
    r_ctx, r_q = jax.random.split(rng)
    uniforms = (torch.from_numpy(np.array(jax.random.uniform(r_ctx,
                                                             (nq,)))),
                torch.from_numpy(np.array(jax.random.uniform(r_q, (nv,)))))
    ta, tb = tpre._sampled_neg_loss(
        torch.from_numpy(masked), torch.from_numpy(pos),
        torch.from_numpy(q_mask), q, tpre.VsmConfig(**vsm_kw),
        use_hard_negative=hard, hard_pool_size=2, uniforms=uniforms)
    np.testing.assert_allclose([float(ta), float(tb)],
                               [float(ja), float(jb)], atol=1e-6)
    # through video_level_loss, the draws come from the seed: one seed
    # gives one loss, on any device
    ts = torch.from_numpy(scores)
    one = tpre.video_level_loss(ts, torch.from_numpy(q_mask), q,
                                tpre.VsmConfig(**vsm_kw),
                                use_hard_negative=hard, hard_pool_size=2,
                                seed=5)
    again = tpre.video_level_loss(ts, torch.from_numpy(q_mask), q,
                                  tpre.VsmConfig(**vsm_kw),
                                  use_hard_negative=hard, hard_pool_size=2,
                                  seed=5)
    assert [float(x) for x in one] == [float(x) for x in again]


# ---------------------------------------------------------------------------
# rematerialisation and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
def test_remat_step_equals_plain_step_bit_for_bit(setup, task):
    """With dropout on (train, a seed), a step whose encoder layers are
    checkpointed gives the plain step's loss and gradients bit for bit:
    every dropout site redraws from its seed in the rerun."""
    _, _, tparams = setup
    batch = batch_to_device(_batch(task, "packed"), "cpu")
    fn = _port_loss(task, train=True)
    plain = tstep.loss_and_grads(fn, tparams, batch, 11)
    ttrm.set_remat(True)
    try:
        remat = tstep.loss_and_grads(fn, tparams, batch, 11)
    finally:
        ttrm.set_remat(False)
    assert torch.equal(plain[0], remat[0])
    for path, a, b in zip(toptim.tree_paths(tparams),
                          toptim.tree_leaves(plain[2]),
                          toptim.tree_leaves(remat[2])):
        assert torch.equal(a, b), "/".join(path)
    other = tstep.loss_and_grads(fn, tparams, batch, 12)[0]
    assert not torch.equal(plain[0], other)       # dropout is on


@pytest.fixture(scope="module")
def jax_steps(setup):
    """One JAX train step of each task from one state, two micro-batches
    a step (the recipe's accumulation), in one jitted function."""
    jcfg, params, _ = setup
    steps = {t: jstep._build_step(_jax_loss(jcfg, t), jstep.TrainSpec(
        **SPEC), accum_steps=2) for t in TASKS}

    @jax.jit
    def all_steps(state, batches):
        return {t: steps[t](state, batches[t], jax.random.PRNGKey(0))
                for t in TASKS}

    batches = {t: _stacked(t) for t in TASKS}
    res = all_steps(jstep.TrainState.create(params),
                    {t: _jnp(b) for t, b in batches.items()})
    flat = {t: tuple(flatten_tree(jax.device_get(tree)) for tree in (
        st.params, st.opt.mu, st.opt.nu)) for t, (st, _) in res.items()}
    return batches, {t: (float(m["loss"]), float(m["grad_norm"]),
                         _to_port(st.params), _to_port(st.opt.mu))
                     for t, (st, m) in res.items()}, flat


def _stacked(task):
    """Two packed micro-batches of ``task`` on a leading axis."""
    b1 = _batch(task, "packed")
    b2, _ = jsyn.tv_task_batch(task, tiny_videos(9, PACKED_TINY.batch),
                               PACKED_TINY, packed=True, seed=6)
    return {k: np.stack([b1[k], b2[k]]) for k in b1}


@pytest.mark.parametrize("task", TASKS)
def test_train_step_matches_jax(setup, jax_steps, task):
    """One accumulated step of each package from the same state: loss,
    grad norm and every new parameter and first moment."""
    _, _, tparams = setup
    batches, want, _ = jax_steps
    loss, gnorm, want_params, want_mu = want[task]
    step = tstep.make_train_step(_port_loss(task), tstep.TrainSpec(**SPEC),
                                 accum_steps=2)
    state, m = step(tstep.TrainState.create(tparams),
                    batch_to_device(batches[task], "cpu"), None)
    assert float(m["loss"]) == pytest.approx(loss, rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(gnorm, rel=1e-5)
    # AdamW's first step moves an element by lr*sf*g/(|g| + eps), whose
    # slope at g ~ 0 is lr*sf/eps (test_torch_train.py's bound)
    _assert_trees_close(state.params, want_params, atol=2e-6)
    _assert_trees_close(state.opt.mu, want_mu, atol=1e-6)


@pytest.mark.parametrize("task", TASKS)
def test_port_restore_state_equals_jax_at_every_key(setup, jax_steps, task):
    """What the port's ``restore.npz`` holds after one step of each task
    (``to_jax_train_state`` with the run's init as the template) against
    the JAX step's state: every parameter and moment within the step
    test's tolerances, the poolers and the task heads no loss of the
    task reads included (the JAX AdamW decays their kernels, and so does
    the port's)."""
    from hero_tpu_torch.convert.from_jax import to_jax_train_state
    _, _, tparams = setup
    batches, _, flat = jax_steps
    template = tpre.init_flat_params(tiny_hero_config(), seed=0)
    step = tstep.make_train_step(_port_loss(task), tstep.TrainSpec(**SPEC),
                                 accum_steps=2)
    state, _ = step(tstep.TrainState.create(tparams),
                    batch_to_device(batches[task], "cpu"), None)
    got = to_jax_train_state(state, template)
    assert got[3] == 1
    want_p, want_mu, want_nu = flat[task]
    poolers = [k for k in want_p if "pooler" in k.split("/")]
    assert len(poolers) == 4
    for name, g, w, atol in (("params", got[0], want_p, 2e-6),
                             ("mu", got[1], want_mu, 1e-6),
                             ("nu", got[2], want_nu, 1e-6)):
        assert sorted(g) == sorted(w), name
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=atol,
                                       err_msg=f"{name}/{k}")
    for k in poolers:
        if k.endswith("/kernel"):
            assert not np.array_equal(got[0][k], template[k]), k


# ---------------------------------------------------------------------------
# data: stores, task datasets, loader, synthetic batches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return build_synthetic_corpus(root, n_videos=6, max_frames=MAX_FRAMES,
                                  vfeat_dim=64)


def _stores(corpus):
    """The sub and feature stores of the test corpus: the JAX package's
    readers, and the port's."""
    return ((SubTokStore(corpus["sub"], max_clip_len=MAX_FRAMES),
             VideoFeatStore(corpus["vfeat"], max_clip_len=MAX_FRAMES)),
            (tstore.SubTokStore(corpus["sub"], max_clip_len=MAX_FRAMES),
             tstore.VideoFeatStore(corpus["vfeat"], max_clip_len=MAX_FRAMES)))


def _video_dbs(corpus, pack):
    """The JAX and the port's ``VideoFeatSubTokDataset``, each over its
    own package's readers of the test corpus."""
    jstores, tstores = _stores(corpus)
    jshapes = jvideo.FixedShapes(**dataclasses.asdict(STORE_SHAPES))
    kw = dict(max_txt_len=20, sub_ctx_len=1, pack=pack)
    return (jvideo.VideoFeatSubTokDataset(*jstores, jshapes, **kw),
            tvideo.VideoFeatSubTokDataset(*tstores, STORE_SHAPES, **kw))


def _same_arrays(got, want):
    assert set(got) == set(want)
    for k in want:
        if k.startswith("__"):
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _task_datasets(mod, db, task):
    vids = list(db.txt_db.id2len.keys())
    if task == "mlm":
        return mod.MlmDataset(vids, db, mask_prob=0.3, seed=3)
    if task == "mfm":
        return mod.MfmDataset(vids, db, mask_prob=0.3, seed=3)
    if task == "fom":
        return mod.FomDataset(vids, db, seed=3)
    return mod.VsmDataset(vids, db, query_per_video=2, seed=3)


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("task", ["mlm", "mfm", "fom", "vsm"])
def test_task_datasets_and_build_batch_match_jax(corpus, task, pack):
    """Every item (two epochs) and a batch of each task dataset equal the
    JAX package's bit for bit, with the same truncation counters."""
    jdb, tdb = _video_dbs(corpus, pack)
    jds, tds = _task_datasets(jpt, jdb, task), _task_datasets(tpt, tdb, task)
    assert len(tds) == len(jds)
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(jds)):
            _same_arrays(tds[i], jds[i])
    _same_arrays(tpt.build_batch(tds, [4, 0, 2]),
                 jpt.build_batch(jds, [4, 0, 2]))
    assert tdb.truncation_report() == jdb.truncation_report()
    for vid in tdb.vids:
        assert (tvideo.video_fits_bucket(tdb, vid)
                == jvideo.video_fits_bucket(jdb, vid))


@pytest.mark.parametrize("pack", [False, True])
def test_second_bucket_task_datasets_match_jax(corpus, pack):
    """``build_task_datasets`` with ``--second_bucket`` (twin of
    tests/test_data_layer.py::test_pretrain_second_bucket_partition):
    the same task names, ratios, video split and big-bucket shapes as
    the JAX driver's, and the same items."""
    from hero_tpu.drivers.pretrain import build_task_datasets as jbuild
    jstores, tstores = _stores(corpus)
    tiny = STORE_SHAPES.replace(n_subs=1 if pack else 2, txt_len=8)
    jdb = jvideo.VideoFeatSubTokDataset(
        *jstores, jvideo.FixedShapes(**dataclasses.asdict(tiny)),
        max_txt_len=20, sub_ctx_len=1, pack=pack)
    tdb = tvideo.VideoFeatSubTokDataset(*tstores, tiny, max_txt_len=20,
                                        sub_ctx_len=1, pack=pack)
    opts = types.SimpleNamespace(second_bucket=True, seed=0,
                                 query_per_video=2,
                                 task_ratios={"mlm": 2, "vsm": 1})
    jt, tt = jbuild(opts, {"": jdb}), tdrv.build_task_datasets(opts,
                                                               {"": tdb})
    assert any(name.endswith("#big") for name in tt)
    assert list(tt) == list(jt)
    for name in jt:
        (jds, jr), (tds, tr) = jt[name], tt[name]
        assert (tr, tds.ids) == (jr, jds.ids), name
        assert dataclasses.asdict(tds.video_db.shapes) == \
            dataclasses.asdict(jds.video_db.shapes)
        for i in range(len(jds)):
            _same_arrays(tds[i], jds[i])
    assert sum(len(ds.ids) for ds, _ in tt.values()) == 2 * len(tdb.vids)


def test_bucket_helpers_match_jax(corpus):
    (jsub, _), (tsub, _) = _stores(corpus)
    for coverage in (0.5, 1.0):
        jshapes = jvideo.suggest_shapes(jsub, coverage=coverage,
                                        max_txt_len=20, sub_ctx_len=1)
        tshapes = tvideo.suggest_shapes(tsub, coverage=coverage,
                                        max_txt_len=20, sub_ctx_len=1)
        assert dataclasses.asdict(tshapes) == dataclasses.asdict(jshapes)
    for n in (3, 200):
        for prob in (0.15, 0.4):
            assert tpt.mlm_row_cap(prob, n) == jpt.mlm_row_cap(prob, n)
    draw = random.Random(4)
    for seed in range(20):
        toks = [draw.randrange(3, 100) for _ in range(draw.randrange(1, 12))]
        assert (tpt.random_word(toks, (3, 99), 50, random.Random(seed), 0.4)
                == jpt.random_word(toks, (3, 99), 50, random.Random(seed),
                                   0.4))
    for seed in range(5):
        assert (tpt.random_reorder(list(range(12)), random.Random(seed), 0.4)
                == jpt.random_reorder(list(range(12)), random.Random(seed),
                                      0.4))
    assert (tvideo.pad_query([5, 6, 7], 5, 1)[0].tolist()
            == jvideo.pad_query([5, 6, 7], 5, 1)[0].tolist())


def _schedule(mod, accum, n, skip=0):
    """(task, batch index) of ``n`` micro-batches of a 3-task MetaLoader
    over counting iterators, after ``skip`` fast-forwarded ones."""
    def counter(tag):
        i = 0
        while True:
            yield (tag, i)
            i += 1
    meta = mod.MetaLoader({"mlm": (counter("mlm"), 2),
                           "fom": (counter("fom"), 1),
                           "vsm": (counter("vsm"), 3)},
                          accum_steps=accum, seed=77)
    if skip:
        meta.fast_forward(skip)
    it = iter(meta)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("accum", [1, 2])
def test_meta_loader_schedule_and_fast_forward_match_jax(accum):
    assert _schedule(tloader, accum, 40) == _schedule(jloader, accum, 40)
    # a resumed loader continues the uninterrupted schedule
    full = _schedule(tloader, accum, 40)
    assert _schedule(tloader, accum, 30, skip=10) == full[10:]
    assert (_schedule(tloader, accum, 30, skip=10)
            == _schedule(jloader, accum, 30, skip=10))


def test_batch_sampler_and_dataset_iterator_match_jax(corpus):
    for n, bs, rank, world in ((7, 3, 0, 1), (3, 4, 5, 8), (10, 4, 1, 2)):
        for drop_last in (True, False):
            kw = dict(seed=2, rank=rank, world_size=world,
                      drop_last=drop_last)
            for epoch in (0, 1):
                assert (tloader.BatchSampler(n, bs, **kw).epoch_batches(epoch)
                        == jloader.BatchSampler(n, bs, **kw).epoch_batches(
                            epoch))
    jdb, tdb = _video_dbs(corpus, True)
    jit_ = jloader.dataset_iterator(_task_datasets(jpt, jdb, "mlm"),
                                    jpt.build_batch, 4, seed=5)
    tit = tloader.dataset_iterator(_task_datasets(tpt, tdb, "mlm"),
                                   tpt.build_batch, 4, seed=5)
    jit_.skip(1)
    tit.skip(1)
    for _ in range(3):             # crosses an epoch boundary
        _same_arrays(next(tit), next(jit_))


def test_prefetch_loader_places_batches_and_reraises():
    """Twin of tests/test_data_layer.py::
    test_prefetch_loader_reraises_worker_exception, with the default
    placement: numpy arrays arrive as tensors, other values as they
    are."""
    def poisoned():
        yield "x", {"a": np.arange(3, dtype=np.int32), "n": 2}
        raise ValueError("boom")

    it = iter(tloader.PrefetchLoader(poisoned(), device="cpu"))
    tag, b = next(it)
    assert tag == "x" and b["n"] == 2
    assert torch.equal(b["a"], torch.arange(3, dtype=torch.int32))
    with pytest.raises(RuntimeError) as e:
        next(it)
    assert isinstance(e.value.__cause__, ValueError)
    placed = tloader.to_device({"a": np.ones(2), "k": np.ones(2)}, "cpu",
                               host_keys=("k",))
    assert isinstance(placed["a"], torch.Tensor)
    assert isinstance(placed["k"], np.ndarray)


@pytest.mark.parametrize("task", TASKS)
def test_synthetic_task_batches_match_jax(task):
    for seed in (0, 4):
        _same_arrays(tsyn.task_batch(task, tsyn.TINY, seed),
                     jsyn.task_batch(task, jsyn.TINY, seed))
    videos = tiny_videos(6, 3)
    tshape = tsyn.BatchShape(**dataclasses.asdict(PACKED_TINY))
    for packed in (False, True):
        got, gd = tsyn.tv_task_batch(task, videos, tshape, packed, seed=2)
        want, wd = jsyn.tv_task_batch(task, videos, PACKED_TINY, packed,
                                      seed=2)
        _same_arrays(got, want)
        assert gd == wd


# ---------------------------------------------------------------------------
# options, curriculum, validators, the driver
# ---------------------------------------------------------------------------

def test_options_shapes_and_curriculum_match_jax():
    argv = ["--config", "config/pretrain-tv.json"]
    topt, jopt = topts.get_pretrain_args(argv), jopts.get_pretrain_args(argv)
    assert vars(topt) == vars(jopt)
    assert topts.get_pretrain_args(argv + ["--mask_prob", "0.2"]).mask_prob \
        == 0.2
    tsh, jsh = tcommon.shapes_from_opts(topt), jcommon.shapes_from_opts(jopt)
    assert dataclasses.asdict(tsh) == dataclasses.asdict(jsh)
    assert (tsh.n_subs, tsh.txt_len, tsh.frames_per_sub, tsh.max_masked) \
        == (8, 122, 16, 42)
    assert dataclasses.asdict(tcommon.vsm_config_from_opts(topt)) == \
        dataclasses.asdict(jcommon.vsm_config_from_opts(jopt))
    tcur, jcur = tcommon.Curriculum(topt), jcommon.Curriculum(jopt)
    for step in (0, 19999, 20000, 90000):
        t, j = tcur.at(step), jcur.at(step)
        assert {k: (v.dtype, v.item()) for k, v in t.items()} == \
            {k: (v.dtype, v.item()) for k, v in j.items()}
    kw = tcommon.curriculum_kwargs(dict(tcur.at(20000)))
    assert kw == {"use_hard_negative": True, "hard_pool_size": 20,
                  "hard_neg_weight": 10.0,
                  "lw_st_ed": float(np.float32(0.01))}


def test_validate_pretrain_matches_jax(setup):
    """Every validator's metrics (all but the rates) against the JAX
    validators', fp32, two batches a task."""
    jcfg, params, tparams = setup
    vsm = VSM
    loaders = {t: [jsyn.task_batch(t, jsyn.TINY, seed=s) for s in (1, 2)]
               for t in TASKS}
    want = jval.validate_pretrain(params, jcfg, jpre.VsmConfig(**vsm),
                                  loaders, dtype=jnp.float32)
    got = tval.validate_pretrain(tparams, tiny_hero_config(),
                                 tpre.VsmConfig(**vsm), loaders,
                                 dtype=torch.float32, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("_per_s"):
            continue
        assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


@pytest.fixture
def one_torch_thread():
    """The tiny model's train loop on one intra-op thread: beside other
    test workers, each with a full OpenMP pool, its threads starved (a
    3 s run took minutes).  The results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
def test_run_pretrain_four_task_mix_on_cpu(corpus, tmp_path):
    """``run_pretrain`` at ``config/pretrain-tv.json``'s recipe (packed
    subs, accumulation 2, the 2:2:1:2 mix, hard negatives from a step it
    reaches) on the test stores and the tiny model: the MetaLoader's
    schedule, finite losses, validation, and truncation counts."""
    _, tdb = _video_dbs(corpus, True)
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(tiny_hero_config(
        max_clip_len=MAX_FRAMES).to_dict()))
    opts = topts.get_pretrain_args(["--config", "config/pretrain-tv.json"])
    for k in ("checkpoint", "output_dir", "targets"):
        setattr(opts, k, None)
    opts.model_config = str(cfg_path)
    opts.max_clip_len, opts.vfeat_dim = MAX_FRAMES, 64
    opts.train_batch_size, opts.val_batch_size = 3, 2
    opts.query_per_video = 2
    opts.num_train_steps, opts.valid_steps = 8, 4
    opts.hard_negtiave_start_step = [3]
    seen = []
    state = tdrv.run_pretrain(
        opts, {"": tdb}, dtype=torch.float32, device="cpu",
        on_step=lambda step, task, m: seen.append(
            (step, task, float(m["loss"]))))
    assert state.global_step == 8 == len(seen)
    assert all(np.isfinite(loss) for _, _, loss in seen)
    # the schedule is the MetaLoader's, one task per optimizer step
    meta = tloader.MetaLoader({t: (iter(int, 1), r)
                               for t, r in tdrv.DEFAULT_TASKS.items()},
                              accum_steps=2, seed=opts.seed)
    it = iter(meta)
    want = [next(it)[0] for _ in range(16)][::2]
    assert [t for _, t, _ in seen] == want
    assert set(want) >= {"mlm", "vsm"}
    assert tdb.truncation_report()["videos_seen"] > 0
    if not torch.cuda.is_available():
        # the program's default device is the card: without one it
        # raises instead of running on the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdrv.main(opts)
