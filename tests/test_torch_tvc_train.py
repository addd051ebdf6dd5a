"""hero_tpu_torch TVC training, and the head-major attention backward and
the fused dropout-add-LayerNorm, against the JAX package.

- ``multi_head_attention``'s gradients (Pallas kernel #5 on the card)
  against ``jax.grad`` through JAX's Pallas kernel in interpret mode and
  through ``mha_reference``;
- ``dropout_add_layer_norm`` (#8, #9) forward and all four gradients
  against both JAX paths at rate 0, and its dropout on its own;
- ``streamed_lse``, ``label_smoothing_loss``, ``forward_tvc``'s loss and
  every parameter gradient, and one whole TVC train step from a bridged
  JAX train state, on the same weights (``init_hero_for_tvc`` on
  ``tiny_hero_config`` with every dropout rate 0: the two frameworks'
  random streams differ);
- ``TvcTrainDataset``/``build_tvc_batch`` bit for bit on the caption store
  the JAX data tests build.

Everything runs in fp32 on the CPU, where the port takes its plain
versions.  The JAX functions are jitted once each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config.model_config import tiny_hero_config as jax_tiny_config
from hero_tpu.data import downstream_tasks as jdt
from hero_tpu.data.store import SubTokStore, VideoFeatStore
from hero_tpu.data.testing import build_synthetic_corpus
from hero_tpu.data.video import FixedShapes, VideoFeatSubTokDataset
from hero_tpu.models import model as jmodel
from hero_tpu.models import tvc as jtvc
from hero_tpu.ops import attention as jatt
from hero_tpu.ops import layernorm as jln
from hero_tpu.training import step as jstep
from hero_tpu.training.optim import AdamWConfig as JaxAdamWConfig
from hero_tpu.training.save import flatten_tree
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert.from_jax import (load_jax_tvc_params,
                                             load_jax_tvc_train_state)
from hero_tpu_torch.data import downstream_tasks as tdt
from hero_tpu_torch.drivers import train_tvc
from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
from hero_tpu_torch.models import model as tmodel
from hero_tpu_torch.models import nn as tnn
from hero_tpu_torch.models import tvc as ttvc
from hero_tpu_torch.ops import attention as tatt
from hero_tpu_torch.ops import layernorm as tln
from hero_tpu_torch.ops.dropout import keep_scale, row_keep_mask
from hero_tpu_torch.training import optim as toptim
from hero_tpu_torch.training import step as tstep
from tests.test_torch_tvc import _tvc_batch


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _assert_trees_close(got, want, atol, rtol=0.0):
    for path, g, w in zip(toptim.tree_paths(want), toptim.tree_leaves(got),
                          toptim.tree_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), atol=atol,
                                   rtol=rtol, err_msg="/".join(path))


# ---------------------------------------------------------------------------
# the head-major attention backward (#5)
# ---------------------------------------------------------------------------

MHA_GRAD_CASES = {  # (Lq, Lk, causal, JAX takes its Pallas kernel)
    "self": (20, 20, False, True),
    "self_causal": (20, 20, True, True),
    "cross": (6, 15, False, True),
    "causal_lq_lt_lk": (5, 12, True, False),
}


@pytest.mark.parametrize("case", list(MHA_GRAD_CASES))
def test_multi_head_attention_grads_match_jax(case):
    """dq, dk, dv of sum(out * g) against ``jax.grad`` through
    ``mha_reference`` and, where JAX takes it, its Pallas kernel pair in
    interpret mode (which pads both lengths to 64 with masked keys: every
    row here has a valid key, so the padding adds ~e^-1e4 to no row).
    The second batch row masks its last 3 keys.  Tolerance 2e-4, as
    ``tests/test_ops.py`` holds the Pallas gradients to the reference."""
    Lq, Lk, causal, pallas = MHA_GRAD_CASES[case]
    B, H, d = 2, 2, 16
    r = np.random.RandomState(70 + Lq + Lk)
    q = r.randn(B, H, Lq, d).astype(np.float32)
    k, v = (r.randn(B, H, Lk, d).astype(np.float32) for _ in range(2))
    g = r.randn(B, H, Lq, d).astype(np.float32)
    mask = (np.arange(Lk)[None] < np.array([[Lk], [Lk - 3]])).astype(
        np.float32)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tatt.multi_head_attention(tq, tk, tv, _t(mask), causal=causal)
    got = torch.autograd.grad((out * _t(g)).sum(), (tq, tk, tv))
    jm, jg = jnp.asarray(mask), jnp.asarray(g)

    def jgrad(fn):
        return jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * jg),
                        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    paths = [jgrad(lambda a, b, c: jatt.mha_reference(a, b, c, jm,
                                                      causal=causal))]
    if pallas:
        paths.append(jgrad(lambda a, b, c: jatt.multi_head_attention(
            a, b, c, jm, causal=causal, use_pallas=True)))
    for want in paths:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                       rtol=2e-4)


def test_multi_head_attention_dropout_grads_are_the_plain_ones():
    """With dropout the backward regenerates the forward's Philox mask:
    the gradients equal autograd through the plain forward."""
    B, H, Lq, Lk, d = 2, 3, 7, 11, 8
    r = np.random.RandomState(75)
    qkv = [_t(r.randn(B, H, L, d).astype(np.float32)).requires_grad_(True)
           for L in (Lq, Lk, Lk)]
    mask = _t((np.arange(Lk)[None] < np.array([[Lk], [4]])).astype(
        np.float32))
    g = _t(r.randn(B, H, Lq, d).astype(np.float32))
    kw = dict(dropout_rate=0.3, seed=2 ** 40 + 11, causal=True)
    got = torch.autograd.grad(
        (tatt.multi_head_attention(*qkv, mask, **kw) * g).sum(), qkv)
    want = torch.autograd.grad(
        (tatt.mha_reference(*qkv, mask, **kw) * g).sum(), qkv)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    ref = tatt.mha_backward_reference(*(t.detach() for t in qkv), mask, g,
                                      **kw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# fused dropout + add + LayerNorm (#8, #9)
# ---------------------------------------------------------------------------

def _daln_inputs(seed, n=24, d=128):
    r = np.random.RandomState(seed)
    y, x = (r.randn(n, d).astype(np.float32) for _ in range(2))
    w = (r.randn(d) + 1.0).astype(np.float32)
    b = r.randn(d).astype(np.float32)
    return y, x, w, b


@pytest.mark.parametrize("use_pallas", [False, True])
def test_dropout_add_layer_norm_matches_jax(use_pallas):
    """Forward and the four gradients of sum(out^3) at rate 0 against
    JAX's jnp path and its Pallas kernels (#8, #9) in interpret mode, at
    ``tests/test_ops.py``'s shape and tolerances (2e-5 forward, 5e-4
    gradients)."""
    y, x, w, b = _daln_inputs(76)
    args = [_t(a).requires_grad_(True) for a in (y, x, w, b)]
    out = tln.dropout_add_layer_norm(*args)
    got = torch.autograd.grad((out ** 3).sum(), args)

    def jfn(*a):
        return jln.dropout_add_layer_norm(*a, use_pallas=use_pallas)

    ja = list(map(jnp.asarray, (y, x, w, b)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jfn(*ja)),
                               atol=2e-5, rtol=2e-5)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) ** 3),
                    argnums=(0, 1, 2, 3))(*ja)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=5e-4,
                                   rtol=5e-4)


def test_dropout_add_layer_norm_dtype_is_the_jnp_paths():
    """The output takes x's dtype, as JAX's jnp path (its Pallas path
    takes y's, which differs only when the two dtypes do): bf16 y on fp32
    x gives fp32 and the jnp path's values; each gradient keeps its
    input's dtype."""
    y, x, w, b = _daln_inputs(77, n=6, d=32)
    ty = _t(y).to(torch.bfloat16).requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    out = tln.dropout_add_layer_norm(ty, tx, _t(w), _t(b))
    want = jln.dropout_add_layer_norm(
        jnp.asarray(y, jnp.bfloat16), jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(b), use_pallas=False)
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    gy, gx = torch.autograd.grad(out.sum(), (ty, tx))
    assert (gy.dtype, gx.dtype) == (torch.bfloat16, torch.float32)
    swapped = tln.dropout_add_layer_norm(_t(y), _t(x).to(torch.bfloat16),
                                         _t(w), _t(b))
    assert swapped.dtype == torch.bfloat16


def test_dropout_add_layer_norm_dropout():
    """At rate > 0 (the port alone: JAX's draw is the TPU PRNG): the
    forward equals the plain chain on the Philox row mask; dy is 0 where
    the mask drops and dx / (1 - rate) where it keeps; a repeat gives the
    same output; no seed means rate 0."""
    y, x, w, b = _daln_inputs(78, n=40, d=96)
    rate, seed = 0.25, 2 ** 36 + 5
    args = [_t(a).requires_grad_(True) for a in (y, x, w, b)]
    out = tln.dropout_add_layer_norm(*args, rate=rate, seed=seed)
    keep = row_keep_mask(seed, 40, 96, rate)
    assert 0.65 < float(keep.float().mean()) < 0.85
    yd = torch.where(keep, _t(y) * keep_scale(rate), 0.0)
    chain = tln.layer_norm_reference(yd + _t(x), _t(w), _t(b))
    torch.testing.assert_close(out.detach(), chain, atol=1e-6, rtol=1e-6)
    dy, dx, dw, db = torch.autograd.grad((out ** 3).sum(), args)
    assert bool((dy[~keep] == 0).all())
    torch.testing.assert_close(dy[keep], dx[keep] / (1 - rate), atol=1e-6,
                               rtol=1e-5)
    assert torch.equal(out, tln.dropout_add_layer_norm(*args, rate=rate,
                                                       seed=seed))
    assert torch.equal(tln.dropout_add_layer_norm(*args, rate=rate),
                       tln.dropout_add_layer_norm(*args))
    lnp = {"weight": args[2], "bias": args[3]}
    assert torch.equal(tnn.dropout_add_layer_norm(lnp, *args[:2], rate, seed),
                       out)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

def _logits_targets(seed, V=40):
    r = np.random.RandomState(seed)
    logits = (r.randn(3, 7, V) * 3).astype(np.float32)
    targets = r.randint(0, V, (3, 7)).astype(np.int32)
    targets[:, 5:] = -1
    targets[2] = -1
    return logits, targets


def test_streamed_lse_matches_jax():
    logits, _ = _logits_targets(80)
    want, jg = jax.value_and_grad(lambda z: jnp.sum(jmodel.streamed_lse(z)))(
        jnp.asarray(logits))
    z = _t(logits).requires_grad_(True)
    got = tmodel.streamed_lse(z)
    (g,) = torch.autograd.grad(got.sum(), z)
    np.testing.assert_allclose(np.asarray(got.detach()),
                               np.asarray(jmodel.streamed_lse(
                                   jnp.asarray(logits))), rtol=1e-6)
    np.testing.assert_allclose(float(got.detach().sum()), float(want),
                               rtol=1e-6)
    # softmax probabilities <= 1 from fp32 exp and 40-term sums taken in
    # other orders: a few fp32 ulps
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)


@pytest.mark.parametrize("lsr", [0.1, 0.0])
def test_label_smoothing_loss_matches_jax(lsr):
    """(sum, count) and the gradient of sum / count; at lsr 0 it is the
    cross entropy."""
    logits, targets = _logits_targets(81)

    def jf(z):
        s, n = jtvc.label_smoothing_loss(z, jnp.asarray(targets), lsr)
        return s / n

    jval, jgrad = jax.value_and_grad(jf)(jnp.asarray(logits))
    z = _t(logits).requires_grad_(True)
    s, n = ttvc.label_smoothing_loss(z, _t(targets), lsr)
    assert float(n) == 10.0
    (g,) = torch.autograd.grad(s / n, z)
    np.testing.assert_allclose(float(s.detach() / n), float(jval),
                               rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), atol=1e-7)
    if lsr == 0:
        ce, _ = tmodel.masked_cross_entropy(z, _t(targets))
        np.testing.assert_allclose(float(s.detach()), float(ce.detach()),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# forward_tvc and the train step
# ---------------------------------------------------------------------------

def _no_dropout(cfg):
    def off(c):
        return c.replace(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
    return cfg.replace(f_config=off(cfg.f_config), c_config=off(cfg.c_config),
                       q_config=off(cfg.q_config), d_config=off(cfg.d_config))


def _train_batch(seed):
    batch = _tvc_batch(seed=seed)
    r = np.random.RandomState(seed)
    tgt = r.randint(0, 128, batch["cap_input_ids"].shape).astype(np.int32)
    tgt[:, -1] = -1
    tgt[0, 2:] = -1
    batch["cap_tgt_ids"] = tgt
    return batch


@pytest.fixture(scope="module")
def tvc_setup():
    jcfg = _no_dropout(jax_tiny_config())
    params = jtvc.init_hero_for_tvc(jax.random.PRNGKey(0), jcfg)
    flat = flatten_tree(jax.device_get(params))
    return (jcfg, _no_dropout(tiny_hero_config()), params,
            load_jax_tvc_params(flat, device="cpu"))


def _jax_loss_fn(cfg, lsr):
    """The loss of ``hero_tpu``'s train_tvc
    (``hero_tpu/drivers/train_tvc.py:68-70``), in fp32."""
    def loss_fn(p, batch, rng):
        s, n = jtvc.forward_tvc(p, cfg, batch, lsr=lsr, rng=rng, train=True)
        return s / jnp.maximum(n, 1.0), {}
    return loss_fn


@pytest.mark.parametrize("lsr", [0.1, 0.0])
def test_forward_tvc_loss_and_grads_match_jax(tvc_setup, lsr):
    """train=True with every dropout rate 0: the loss and every parameter
    gradient (the tied word embedding gets its gradient from the
    f-encoder, the caption embedding and the LM head; the caption gather
    scatters into the backbone's frames)."""
    jcfg, tcfg, params, tparams = tvc_setup
    batch = _train_batch(82)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jcfg, lsr), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1))
    loss, _, grads = tstep.loss_and_grads(
        train_tvc.make_loss_fn(tcfg, lsr, torch.float32), tparams,
        batch_to_device(batch, "cpu"), 5)
    # fp32 sums in other orders through 2+1 encoder and 1 decoder post-LN
    # layers and a 128-way softmax; the loss is O(5)
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    want = load_jax_tvc_params(flatten_tree(jax.device_get(jgrads)),
                               device="cpu")
    _assert_trees_close(grads, want, atol=1e-5)
    wemb = grads["v_encoder"]["f_encoder"]["embeddings"]["word_emb"]
    assert float(wemb.abs().max()) > 0


def test_tvc_train_step_matches_jax(tvc_setup):
    """One step of each package's train step (``train_tvc``'s loss and
    ``config/train-tvc.json``'s options with warm-up 1, so the step moves
    the weights) from a bridged JAX state that has already taken a step:
    loss, grad norm, every new parameter and AdamW moment."""
    jcfg, tcfg, params, _ = tvc_setup
    opts = dict(train_tvc.load_train_opts(), warmup_steps=1)
    spec = train_tvc.train_spec(opts)
    jspec = jstep.TrainSpec(
        learning_rate=spec.learning_rate, warmup_steps=spec.warmup_steps,
        num_train_steps=spec.num_train_steps, grad_norm=spec.grad_norm,
        lr_schedule=spec.lr_schedule,
        adamw=JaxAdamWConfig(beta1=opts["betas"][0], beta2=opts["betas"][1],
                             weight_decay=opts["weight_decay"],
                             lr_mul=opts["lr_mul"]))
    jfn = jstep.make_train_step(_jax_loss_fn(jcfg, opts["lsr"]), jspec,
                                donate=False)
    first = {k: jnp.asarray(v) for k, v in _train_batch(83).items()}
    batch = _train_batch(84)
    js1, _ = jfn(jstep.TrainState.create(params), first,
                 jax.random.PRNGKey(2))
    js2, jm = jfn(js1, {k: jnp.asarray(v) for k, v in batch.items()},
                  jax.random.PRNGKey(3))

    def flat(tree):
        return flatten_tree(jax.device_get(tree))

    state = load_jax_tvc_train_state(flat(js1.params), flat(js1.opt.mu),
                                     flat(js1.opt.nu), int(js1.opt.step),
                                     int(js1.global_step), device="cpu")
    step = tstep.make_train_step(
        train_tvc.make_loss_fn(tcfg, opts["lsr"], torch.float32), spec)
    ts2, tm = step(state, batch_to_device(batch, "cpu"), 9)
    assert ts2.global_step == int(js2.global_step) == 2
    assert ts2.opt.step == int(js2.opt.step) == 2
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
    # AdamW's update is lr * lr_mul * sf * m / (sqrt(v) + eps): its slope in
    # the gradient is bounded by lr * lr_mul * sf / eps, so the ~1e-9
    # gradient differences of near-zero gradients move it by <= ~1e-5
    _assert_trees_close(ts2.params, load_jax_tvc_params(flat(js2.params),
                                                        device="cpu"),
                        atol=1e-5)
    _assert_trees_close(ts2.opt.mu, load_jax_tvc_params(flat(js2.opt.mu),
                                                        device="cpu"),
                        atol=1e-6)


# ---------------------------------------------------------------------------
# the training data
# ---------------------------------------------------------------------------

MAX_FRAMES = 16
SHAPES = FixedShapes(n_subs=4, txt_len=24, frames_per_sub=12,
                     n_frames=MAX_FRAMES, n_queries=2, query_len=16,
                     max_masked=4, vfeat_dim=64)


@pytest.mark.parametrize("pack", [False, True])
def test_tvc_train_batches_match_jax(tmp_path, pack):
    """``TvcTrainDataset`` and ``build_tvc_batch`` on the caption store
    and video store ``tests/test_data_layer.py`` builds (the port's
    classes read JAX's stores through their duck types): every array bit
    for bit, the host lists, and in pack mode the four packed keys."""
    corpus = build_synthetic_corpus(str(tmp_path), n_videos=6,
                                    max_frames=MAX_FRAMES, vfeat_dim=64)
    video_db = VideoFeatSubTokDataset(
        SubTokStore(corpus["sub"], max_clip_len=MAX_FRAMES),
        VideoFeatStore(corpus["vfeat"], max_clip_len=MAX_FRAMES), SHAPES,
        max_txt_len=20, sub_ctx_len=1, pack=pack)
    cap_db = jdt.TvcCaptionStore(corpus["cap"], max_txt_len=12)
    kw = dict(caps_per_video=2, cap_len=12, seg_len=MAX_FRAMES, seed=3)
    jds = jdt.TvcTrainDataset(video_db, cap_db, **kw)
    tds = tdt.TvcTrainDataset(video_db, cap_db, **kw)
    assert len(tds) == len(jds) == 6
    for idx in ([0, 1, 2], [5, 3, 4]):
        jb = jdt.build_tvc_batch(jds, idx)
        tb = tdt.build_tvc_batch(tds, idx)
        assert set(tb) == set(jb)
        if pack:
            assert {"sub_txt_seg", "sub_txt_pos", "sub_frame_seg",
                    "sub_frame_pos"} <= set(tb)
        for k in tb:
            if k.startswith("__"):
                assert tb[k] == jb[k], k
            else:
                assert tb[k].dtype == jb[k].dtype, k
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert (tb["cap_input_ids"][:, 0] == cap_db.bos).all()
    opts = dict(train_tvc.load_train_opts(), max_txt_len=10,
                max_clip_len=MAX_FRAMES, caps_per_video=2)
    ds = train_tvc.tvc_train_dataset(video_db, cap_db, opts)
    assert (ds.cap_len, ds.seg_len, ds.seed) == (12, MAX_FRAMES, 77)
