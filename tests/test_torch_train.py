"""hero_tpu_torch training against the JAX package on the same weights:
schedules, AdamW's parameter groups, AdamW and clipping, the VSM losses,
``forward_vsm``'s losses and every parameter gradient, and one whole
train step.  Plus the port's own accumulation and learning-signal twins
of ``tests/test_training.py``.

JAX gradients and optimizer trees reach the port's layout through the
weight bridge (``convert/from_jax.load_jax_params``): the map is linear,
so it carries them as it carries the parameters.  Everything is fp32 on
the CPU with dropout off (the two frameworks' random streams differ; the
dropout draws are tested on their own in ``test_torch_ops.py``).  The JAX
step functions are jitted once per module, which keeps the file's
compiles to three.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config.model_config import tiny_hero_config as jax_tiny_config
from hero_tpu.data import synthetic as jsyn
from hero_tpu.models import model as jmodel
from hero_tpu.models import pretrain as jpre
from hero_tpu.training import optim as joptim
from hero_tpu.training import step as jstep
from hero_tpu.training.save import flatten_tree, unflatten_tree
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert.from_jax import (load_jax_params,
                                             load_jax_train_state)
from hero_tpu_torch.data import synthetic as tsyn
from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
from hero_tpu_torch.models import model as tmodel
from hero_tpu_torch.models import pretrain as tpre
from hero_tpu_torch.training import optim as toptim
from hero_tpu_torch.training import step as tstep
from tests.test_torch_models import PACKED_TINY, tiny_videos

WEIGHTS = dict(lw_neg_ctx=1.0, lw_neg_q=1.0, lw_st_ed=0.5)
SPEC = dict(learning_rate=1e-3, warmup_steps=1, num_train_steps=100,
            grad_norm=2.0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _to_port(jtree):
    """A JAX parameter-shaped tree in the port's layout (on the CPU)."""
    return load_jax_params(flatten_tree(jax.device_get(jtree)), device="cpu")


def _batch(kind):
    if kind == "unpacked":
        return jsyn.vsm_batch(jsyn.TINY, seed=3)
    b, _ = jsyn.tv_vsm_batch(tiny_videos(4, PACKED_TINY.batch), PACKED_TINY,
                             packed=True, seed=5)
    return b


def _jax_loss_fn(cfg, vsm):
    def loss_fn(params, batch, rng):
        a, b, c = jpre.forward_vsm(params, cfg, vsm, batch)
        return a + b + c, {"loss_st_ed": a, "loss_neg_ctx": b,
                           "loss_neg_q": c}
    return loss_fn


def _port_loss_fn(cfg, vsm, train=False):
    def loss_fn(params, batch, seed):
        a, b, c = tpre.forward_vsm(params, cfg, vsm, batch, train=train,
                                   seed=seed)
        return a + b + c, {"loss_st_ed": a, "loss_neg_ctx": b,
                           "loss_neg_q": c}
    return loss_fn


@pytest.fixture(scope="module")
def setup():
    """The JAX tree of ``init_hero_for_pretraining`` drawn by the port's
    numpy init (``test_torch_port.py`` holds the two inits to one tree and
    one set of distributions), and the same weights in the port."""
    jcfg = jax_tiny_config()
    flat = tpre.init_flat_params(tiny_hero_config(), seed=0)
    params = jax.tree.map(jnp.asarray, unflatten_tree(flat))
    return jcfg, params, load_jax_params(flat, device="cpu")


def _assert_trees_close(got, want, atol, rtol=0.0):
    for path, g, w in zip(toptim.tree_paths(want), toptim.tree_leaves(got),
                          toptim.tree_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), atol=atol,
                                   rtol=rtol, err_msg="/".join(path))


# ---------------------------------------------------------------------------
# optimizer pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["warmup_linear", "noam", "vqa"])
def test_schedules_match_jax(schedule):
    for step in (0, 1, 5, 50, 99, 100, 101, 300, 550, 999, 1000, 1500):
        want = float(joptim.get_lr(step, 1e-4, 100, 1000, schedule))
        got = toptim.get_lr(step, 1e-4, 100, 1000, schedule)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_group_masks_match_jax(setup):
    """The port's decay and top-lr rules on its own key paths give the JAX
    masks, carried through the bridge leaf by leaf."""
    _, params, tparams = setup
    paths = {"/".join(p) for p in toptim.tree_paths(tparams)}
    # the leaves no VSM loss reads take part: poolers and task heads
    assert {"v_encoder/f_encoder/pooler/dense/weight",
            "v_encoder/c_encoder/pooler/dense/bias",
            "v_encoder/f_encoder/lm_head/ln/weight",
            "v_encoder/fom_output/linear_1/weight",
            "v_encoder/mask_embedding"} <= paths
    for jmask, tmask in ((joptim.no_decay_mask, toptim.no_decay_mask),
                         (joptim.top_lr_mask, toptim.top_lr_mask)):
        full = jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32),
                            jmask(params), params)
        want = _to_port(full)
        got = tmask(tparams)
        for path, m, w in zip(toptim.tree_paths(want),
                              toptim.tree_leaves(got),
                              toptim.tree_leaves(want)):
            assert (w.numpy() == m).all(), "/".join(path)


@jax.jit
def _jax_clip_adamw(grads, state, params):
    g, norm = joptim.clip_by_global_norm(grads, 2.0)
    p, st = joptim.adamw_update(g, state, params, 2e-3,
                                joptim.AdamWConfig(lr_mul=3.0))
    return g, norm, p, st


def _random_like(flat, r, positive=False):
    out = {}
    for k, v in flat.items():
        x = r.randn(*v.shape).astype(np.float32)
        out[k] = np.abs(x) * 1e-3 if positive else x * 1e-2
    return out


@pytest.mark.parametrize("start_step", [0, 2])
def test_adamw_and_clipping_match_jax(setup, start_step):
    """One AdamW update from step ``start_step`` (zero or random carried
    moments), after global-norm clipping, with lr_mul 3 on the heads."""
    _, params, _ = setup
    flat = flatten_tree(jax.device_get(params))
    r = np.random.RandomState(start_step)
    g = _random_like(flat, r)
    if start_step:
        mu, nu = _random_like(flat, r), _random_like(flat, r, positive=True)
    else:
        mu = {k: np.zeros_like(v) for k, v in flat.items()}
        nu = dict(mu)
    jstate = joptim.AdamWState(step=jnp.asarray(start_step, jnp.int32),
                               mu=unflatten_tree(mu), nu=unflatten_tree(nu))
    jg, jnorm, jp, jst = _jax_clip_adamw(unflatten_tree(g), jstate,
                                         unflatten_tree(flat))
    tstate = load_jax_train_state(flat, mu, nu, start_step, 0, device="cpu")
    tg, tnorm = toptim.clip_by_global_norm(
        toptim.tree_leaves(load_jax_params(g, device="cpu")), 2.0)
    assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
    tp, tst = toptim.adamw_update(tg, tstate.opt, tstate.params, 2e-3,
                                  toptim.AdamWConfig(lr_mul=3.0))
    tg = toptim.tree_unflatten(tstate.params, tg)
    assert tst.step == int(jst.step) == start_step + 1
    # fp32 elementwise updates in the same order, up to the bias
    # correction taken in fp64 (JAX: fp32), ~1e-7 relative
    _assert_trees_close(tg, _to_port(jg), atol=1e-7, rtol=1e-6)
    _assert_trees_close(tst.mu, _to_port(jst.mu), atol=1e-9, rtol=1e-6)
    _assert_trees_close(tst.nu, _to_port(jst.nu), atol=1e-12, rtol=1e-6)
    _assert_trees_close(tp, _to_port(jp), atol=1e-7, rtol=1e-6)


def test_adamw_takes_a_none_gradient_as_zero(setup):
    """A gradient leaf list with None for the leaves no loss reads (what
    the train step passes) gives the clip, the norm and the AdamW update
    of the same list with zeros there, bit for bit, from carried
    moments: the unread leaves' moments scaled, the kernels decayed."""
    _, _, tparams = setup
    paths = toptim.tree_paths(tparams)
    leaves = toptim.tree_leaves(tparams)
    r = np.random.RandomState(5)
    unread = [bool({"pooler", "fom_output", "feat_regress"} & set(p))
              for p in paths]
    assert 4 <= sum(unread) < len(leaves)
    grads = [None if u else _t(r.randn(*p.shape).astype(np.float32))
             for u, p in zip(unread, leaves)]
    zeros = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]

    def moments(positive):
        return toptim.tree_unflatten(tparams, [
            _t(np.abs(x) if positive else x) for x in
            (r.randn(*p.shape).astype(np.float32) * 1e-3 for p in leaves)])
    state = toptim.AdamWState(step=3, mu=moments(False), nu=moments(True))
    cfg = toptim.AdamWConfig(lr_mul=3.0)
    g_none, n_none = toptim.clip_by_global_norm(grads, 0.5)
    g_zero, n_zero = toptim.clip_by_global_norm(zeros, 0.5)
    assert torch.equal(n_none, n_zero)
    assert all(g is None for g, u in zip(g_none, unread) if u)
    p_none, s_none = toptim.adamw_update(g_none, state, tparams, 2e-3, cfg)
    p_zero, s_zero = toptim.adamw_update(g_zero, state, tparams, 2e-3, cfg)
    for t_none, t_zero in ((p_none, p_zero), (s_none.mu, s_zero.mu),
                           (s_none.nu, s_zero.nu)):
        for path, a, b in zip(paths, toptim.tree_leaves(t_none),
                              toptim.tree_leaves(t_zero)):
            assert torch.equal(a, b), "/".join(path)
    moved = [not torch.equal(a, b) for a, b, u in zip(
        toptim.tree_leaves(p_none), leaves, unread) if u]
    assert all(moved)


# ---------------------------------------------------------------------------
# VSM losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss_type", ["hinge", "lse"])
@pytest.mark.parametrize("hard", [False, True])
def test_video_level_loss_matches_jax(loss_type, hard):
    """Both ranking losses with all negatives, with and without
    hard-negative weighting, one padded query; values and the gradient
    with respect to the scores."""
    r = np.random.RandomState(11)
    nv, q = 4, 2
    scores = r.uniform(-1, 1, (nv * q, nv)).astype(np.float32)
    q_mask = np.ones(nv * q, np.float32)
    q_mask[3] = 0.0
    kw = dict(use_hard_negative=hard, hard_pool_size=2, hard_neg_weight=10.0)
    jvsm = jpre.VsmConfig(ranking_loss_type=loss_type, margin=0.1)
    tvsm = tpre.VsmConfig(ranking_loss_type=loss_type, margin=0.1)

    def jf(s):
        a, b = jpre.video_level_loss(s, jnp.asarray(q_mask), q, jvsm, **kw)
        return a + 2.0 * b, (a, b)

    (_, (ja, jb)), jgrad = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(scores))
    ts = _t(scores).requires_grad_(True)
    ta, tb = tpre.video_level_loss(ts, _t(q_mask), q, tvsm, **kw)
    (tgrad,) = torch.autograd.grad(ta + 2.0 * tb, ts)
    # sums of <= 8 fp32 terms of O(1)
    np.testing.assert_allclose([float(ta.detach()), float(tb.detach())],
                               [ja, jb], atol=1e-6)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-6)
    one = tpre.video_level_loss(ts[:, :1], _t(q_mask), q, tvsm, **kw)
    assert [float(x) for x in one] == [0.0, 0.0]


def test_masked_cross_entropy_matches_jax():
    r = np.random.RandomState(12)
    logits = (r.randn(6, 20) * 3).astype(np.float32)
    logits[:, 15:] -= 1e4                      # masked frames
    labels = np.array([0, 3, -1, 14, 7, -1], np.int32)

    def jf(x):
        s, c = jmodel.masked_cross_entropy(x, jnp.asarray(labels))
        return s / c

    jval, jgrad = jax.value_and_grad(jf)(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    s, c = tmodel.masked_cross_entropy(x, _t(labels))
    assert float(c) == 4.0
    (g,) = torch.autograd.grad(s / c, x)
    np.testing.assert_allclose(float(s.detach() / c), float(jval), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), atol=1e-7)


# ---------------------------------------------------------------------------
# forward_vsm and the train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vsm_grads(setup):
    """jax.value_and_grad of forward_vsm on both batches (one compile
    each)."""
    jcfg, params, _ = setup
    fn = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jcfg, jpre.VsmConfig(**WEIGHTS)), has_aux=True))
    out = {}
    for kind in ("unpacked", "packed"):
        batch = {k: jnp.asarray(v) for k, v in _batch(kind).items()}
        (_, aux), grads = fn(params, batch, None)
        out[kind] = ({k: float(v) for k, v in aux.items()}, _to_port(grads))
    return out


@pytest.mark.parametrize("kind", ["unpacked", "packed"])
def test_forward_vsm_losses_and_grads_match_jax(setup, jax_vsm_grads, kind):
    _, _, tparams = setup
    want_losses, want_grads = jax_vsm_grads[kind]
    batch = batch_to_device(_batch(kind), "cpu")
    loss, aux, grads = tstep.loss_and_grads(
        _port_loss_fn(tiny_hero_config(), tpre.VsmConfig(**WEIGHTS)),
        tparams, batch, None)
    for k, v in want_losses.items():
        # fp32 sums in other orders through 2+1 post-LN layers; the
        # losses are O(1)
        assert float(aux[k]) == pytest.approx(v, abs=2e-6), k
    # every gradient: fp32 products summed in other orders (measured
    # <= 1e-6 on gradients of magnitude <= 4)
    _assert_trees_close(grads, want_grads, atol=1e-5)
    assert any(float(g.abs().max()) > 0 for g in toptim.tree_leaves(grads))


def test_train_step_matches_jax(setup):
    """One ``make_train_step`` step of each package from the same state:
    loss, grad norm and every new parameter."""
    jcfg, params, tparams = setup
    batch = _batch("packed")
    jfn = jstep.make_train_step(
        _jax_loss_fn(jcfg, jpre.VsmConfig(**WEIGHTS)),
        jstep.TrainSpec(**SPEC), donate=False)
    jstate, jm = jfn(jstep.TrainState.create(params),
                     {k: jnp.asarray(v) for k, v in batch.items()},
                     jax.random.PRNGKey(0))
    tfn = tstep.make_train_step(
        _port_loss_fn(tiny_hero_config(), tpre.VsmConfig(**WEIGHTS)),
        tstep.TrainSpec(**SPEC))
    tstate, tm = tfn(tstep.TrainState.create(tparams),
                     batch_to_device(batch, "cpu"), None)
    assert tstate.global_step == int(jstate.global_step) == 1
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=2e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
    # AdamW's first step moves an element by lr*sf*g/(|g| + eps): its
    # slope in g is at most lr*sf/eps = 1.4e3, so the <= 1e-9 gradient
    # differences of near-zero gradients move it by <= 2e-6
    _assert_trees_close(tstate.params, _to_port(jstate.params), atol=2e-6)
    _assert_trees_close(tstate.opt.mu, _to_port(jstate.opt.mu), atol=1e-6)


def _tiny_port_state(seed):
    from hero_tpu_torch.models.pretrain import init_flat_params
    cfg = tiny_hero_config()
    return cfg, tstep.TrainState.create(
        load_jax_params(init_flat_params(cfg, seed=seed), device="cpu"))


def test_accum_steps_equal_one_step_on_the_same_batch():
    """Twin of test_training.py::test_accum_steps_equivalent_batch: two
    micro-batches holding the same batch give the step of that batch."""
    cfg, state = _tiny_port_state(1)
    vsm = tpre.VsmConfig(lw_neg_ctx=1.0, lw_neg_q=1.0, lw_st_ed=0.0)
    spec = tstep.TrainSpec(learning_rate=1e-3, warmup_steps=1,
                           num_train_steps=100)
    batch = batch_to_device(_batch("unpacked"), "cpu")
    stacked = {k: torch.stack([v, v]) for k, v in batch.items()}
    one, m1 = tstep.make_train_step(_port_loss_fn(cfg, vsm), spec)(
        state, batch, None)
    two, m2 = tstep.make_train_step(_port_loss_fn(cfg, vsm), spec,
                                    accum_steps=2)(state, stacked, None)
    assert np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    # (g + g) / 2 == g exactly; the clip scale and update then match
    _assert_trees_close(two.params, one.params, atol=1e-7)


def test_train_step_decreases_loss():
    """Twin of test_training.py::test_train_step_decreases_loss, with
    dropout on (train=True, a seed per step)."""
    cfg, state = _tiny_port_state(0)
    vsm = tpre.VsmConfig(lw_neg_ctx=1.0, lw_neg_q=1.0, lw_st_ed=0.01)
    spec = tstep.TrainSpec(learning_rate=5e-3, warmup_steps=1,
                           num_train_steps=1000, grad_norm=2.0)
    step = tstep.make_train_step(_port_loss_fn(cfg, vsm, train=True), spec)
    batch = batch_to_device(_batch("unpacked"), "cpu")
    losses = []
    for i in range(8):
        state, metrics = step(state, batch, i)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert state.global_step == 8


def test_train_mode_dropout_is_seeded(setup):
    """train=True draws every dropout site from the step's seed: one seed
    gives one loss, another seed another, and eval mode none of them."""
    _, _, tparams = setup
    cfg = tiny_hero_config()
    vsm = tpre.VsmConfig(**WEIGHTS)
    batch = batch_to_device(_batch("packed"), "cpu")

    def loss(train, seed):
        return float(sum(tpre.forward_vsm(tparams, cfg, vsm, batch,
                                          train=train, seed=seed)))

    assert loss(True, 3) == loss(True, 3)
    assert len({loss(True, 3), loss(True, 4), loss(False, None)}) == 3
    assert loss(True, None) == loss(False, None)


def test_bridge_carries_a_jax_train_state(setup):
    """A JAX TrainState after one step crosses into the port: step
    counters, and mu/nu through the parameters' key map (fused qkv
    included)."""
    jcfg, params, _ = setup
    jstate = jstep.TrainState.create(params)
    flat_mu = {k: np.full(v.shape, i, np.float32) for i, (k, v) in
               enumerate(flatten_tree(jax.device_get(params)).items())}
    st = load_jax_train_state(flatten_tree(jax.device_get(jstate.params)),
                              flat_mu, flat_mu, 7, 5, device="cpu")
    assert (st.opt.step, st.global_step) == (7, 5)
    key = "v_encoder/c_encoder/encoder/layers/attention"
    qkv = st.opt.mu["v_encoder"]["c_encoder"]["encoder"]["layers"][0][
        "attention"]["qkv"]["weight"]
    D = jcfg.c_config.hidden_size
    for i, name in enumerate(("query", "key", "value")):
        assert (qkv[i * D:(i + 1) * D] == flat_mu[f"{key}/{name}/kernel"][
            0, 0, 0]).all()


def test_overflow_bucket_and_partition_copy_bench():
    """TV_PACKED_OVERFLOW and partition_videos are bench.py's."""
    import bench
    from hero_tpu.data.occupancy import sample_tv_video
    assert dataclasses.asdict(tsyn.TV_PACKED_OVERFLOW) == dataclasses.asdict(
        bench.TV_PACKED_OVERFLOW)
    r = np.random.RandomState(0)
    videos = [sample_tv_video(r) for _ in range(64)]
    assert (tsyn.partition_videos(videos, tsyn.TV_PACKED)
            == bench._partition_videos(videos, jsyn.TV_PACKED))
