"""The port's attention past the lengths its CUDA kernels once refused,
against the JAX package on the CPU.

The packed forward (Pallas #1/#2) once stopped at 752 keys in bf16 and
417 in fp32 at head_dim 64, the head-major backward (#5) at 400 and 154
rows; the kernels now stream their tiles and take every length.  On the
CPU the port takes the plain versions of those kernels, so this holds
the functions the kernels compute at those lengths against the JAX
package (``packed_attention`` and ``multi_head_attention``, which on the
CPU run ``mha_reference``); ``test_torch_kernels.py`` holds the kernels
against the plain versions on the card.  The slice as a whole: one
f-encoder layer over a packed bucket whose rows hold 784 slots, the loss
and every parameter gradient against ``jax.grad``.  Last, the fact the
forward's skip of dead chunks rests on: in the plain version, p is
exactly 0.0 on every key a row that has a valid key may not attend, in
fp32 and bf16, and not on a fully masked row.

Inputs are numpy arrays from a seed handed to both frameworks (weights
through ``convert/from_jax``); everything is fp32 with dropout off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config.model_config import HeroConfig as JHeroConfig
from hero_tpu.models import encoder as jenc
from hero_tpu.ops import attention as jatt
from hero_tpu.training.save import flatten_tree, unflatten_tree
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.const import PACK_MAX_SEGS
from hero_tpu_torch.convert.from_jax import load_jax_params
from hero_tpu_torch.models import encoder as tenc
from hero_tpu_torch.models import pretrain as tpre
from hero_tpu_torch.ops import attention as tatt
from hero_tpu_torch.training import optim as toptim

HEADS, HEAD_DIM = 2, 64                  # the flagship's head width
D = HEADS * HEAD_DIM


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _runs(r, L, lo, hi, gap):
    """Segment ids (L,): runs of lo..hi slots, up to ``gap`` pad slots
    (-1) between them, ids below PACK_MAX_SEGS."""
    seg = np.full(L, -1, np.int32)
    pos, s = int(r.randint(0, gap + 1)), 0
    while pos < L and s < PACK_MAX_SEGS:
        n = int(r.randint(lo, hi + 1))
        seg[pos:pos + n] = s
        pos, s = pos + n + int(r.randint(0, gap + 1)), s + 1
    return seg


# (Lq, Lk, mode, causal): segment mode at 800 slots with pad slots, and
# the validity mask with the causal bias over 800 keys at Lq != Lk
LONG_CASES = {"segment": (800, 800, "segment", False),
              "validity_causal": (300, 800, "validity", True)}


@pytest.mark.parametrize("case", list(LONG_CASES))
def test_packed_attention_and_grads_at_800_keys_match_jax(case):
    """``packed_attention``'s output and dq, dk, dv of sum(out * g)
    against JAX's ``packed_attention`` and ``jax.grad`` at 800 keys,
    past the bf16 forward's old 752 (and fp32's 417): fp32 sums of 64-
    and <= 800-term products in other orders, within 1e-5.  Segment mode
    has pad slots (rows that attend nothing: the unmasked softmax, as
    both define it); the validity rows keep 700 and 513 keys, and with
    Lq < Lk every row has a causal key."""
    Lq, Lk, mode, causal = LONG_CASES[case]
    B = 2
    r = np.random.RandomState(Lq + Lk)
    q, g = (r.randn(B, Lq, D).astype(np.float32) for _ in range(2))
    k, v = (r.randn(B, Lk, D).astype(np.float32) for _ in range(2))
    if mode == "segment":
        seg = np.stack([_runs(r, Lk, 30, 120, 3) for _ in range(B)])
        assert (seg == -1).any() and seg.max() >= 6
        jmask, tkw = jax.nn.one_hot(seg, PACK_MAX_SEGS), {"seg": _t(seg)}
    else:
        m = (np.arange(Lk)[None] < np.array([[700], [513]])).astype(
            np.float32)
        jmask, tkw = jnp.asarray(m), {"kv_mask": _t(m)}

    def jloss(a, b, c):
        out = jatt.packed_attention(a, b, c, HEADS, jmask, causal=causal)
        return jnp.sum(out * g), out

    (_, jout), want = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tatt.packed_attention(tq, tk, tv, HEADS, causal=causal, **tkw)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_grads_at_420_rows_match_jax(causal):
    """dq, dk, dv of ``multi_head_attention`` at 420 query rows and keys,
    past the bf16 backward's old 400 rows (and fp32's 154), against
    ``jax.grad`` of JAX's (``mha_reference`` on the CPU); the second
    batch row masks its last 50 keys.  fp32 sums of up to 420 products in
    other orders on gradients of O(1): within 1e-5 and 1e-5 relative."""
    B, H, L, d = 2, 2, 420, HEAD_DIM
    r = np.random.RandomState(420 + causal)
    q, k, v, g = (r.randn(B, H, L, d).astype(np.float32) for _ in range(4))
    mask = (np.arange(L)[None] < np.array([[L], [L - 50]])).astype(
        np.float32)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tatt.multi_head_attention(tq, tk, tv, _t(mask), causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    jm, jg = jnp.asarray(mask), jnp.asarray(g)
    want = jax.grad(lambda a, b, c: jnp.sum(jatt.multi_head_attention(
        a, b, c, jm, causal=causal) * jg), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


# one f-encoder layer of width 128 (2 heads of 64) over packed rows of
# FRAMES frame slots and TXT text slots: 784 slots a row
VOCAB, VFEAT, FRAMES, TXT, SUBS = 128, 32, 64, 720, 6
LAYER = {"hidden_size": D, "num_attention_heads": HEADS,
         "intermediate_size": 4 * D, "max_position_embeddings": 256,
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
MODEL = {"f_config": dict(LAYER, num_hidden_layers=1, vocab_size=VOCAB,
                          type_vocab_size=2),
         "c_config": dict(LAYER, num_hidden_layers=1, type_vocab_size=2),
         "q_config": dict(LAYER, num_hidden_layers=0, vocab_size=VOCAB,
                          type_vocab_size=1),
         "vfeat_dim": VFEAT, "max_frm_seq_len": FRAMES,
         "max_clip_len": FRAMES}


def _packed_rows(r, n):
    """``n`` packed rows: SUBS subs a row, each one segment of its frame
    slots and text slots, positions restarting per segment; the text
    tail past the last sub is pad slots (-1)."""
    b = {"frame_seg": np.full((n, FRAMES), -1, np.int32),
         "txt_seg": np.full((n, TXT), -1, np.int32),
         "frame_pos": np.zeros((n, FRAMES), np.int32),
         "txt_pos": np.zeros((n, TXT), np.int32)}
    for i in range(n):
        fl = np.diff(np.concatenate([[0], np.sort(r.choice(
            np.arange(1, FRAMES), SUBS - 1, replace=False)), [FRAMES]]))
        tl = r.randint(60, 115, SUBS)
        f0 = t0 = 0
        for s in range(SUBS):
            b["frame_seg"][i, f0:f0 + fl[s]] = s
            b["frame_pos"][i, f0:f0 + fl[s]] = np.arange(fl[s])
            b["txt_seg"][i, t0:t0 + tl[s]] = s
            b["txt_pos"][i, t0:t0 + tl[s]] = np.arange(tl[s])
            f0, t0 = f0 + fl[s], t0 + tl[s]
    return b


def test_f_encoder_layer_over_784_slot_packed_rows_matches_jax():
    """One f-encoder layer (``cross_modal_repr``) over two packed rows of
    64 + 720 slots (six subs a row and a pad tail), the loss the mean
    over the 1,568 slots of out . g: the output and every parameter
    gradient within atol 1e-5 and the loss within 2e-6 of JAX's and
    ``jax.grad``'s: fp32 sums of up to 784 products (the attention rows)
    and 512 (the FFN) in other orders through a post-LN layer."""
    r = np.random.RandomState(784)
    n = 2
    packed = _packed_rows(r, n)
    assert (packed["txt_seg"] == -1).any()
    batch = {"sub_input_ids": r.randint(3, VOCAB, (n, TXT)).astype(np.int32),
             "txt_mask": (packed["txt_seg"] >= 0).astype(np.float32),
             "v_feats": r.randn(n, FRAMES, VFEAT).astype(np.float32),
             "v_mask": np.ones((n, FRAMES), np.float32)}
    g = r.randn(n, FRAMES + TXT, D).astype(np.float32)
    tcfg, jcfg = HeroConfig.from_dict(MODEL), JHeroConfig.from_dict(MODEL)
    flat = tpre.init_flat_params(tcfg, tpre.VsmConfig(), seed=784)

    def jloss(params):
        out = jenc.cross_modal_repr(
            params["v_encoder"]["f_encoder"], jcfg.f_config,
            *(jnp.asarray(batch[k]) for k in ("sub_input_ids", "txt_mask",
                                               "v_feats", "v_mask")),
            packed={k: jnp.asarray(v) for k, v in packed.items()})
        return jnp.sum(out * g) / (n * (FRAMES + TXT)), out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, unflatten_tree(flat)))
    want = load_jax_params(flatten_tree(jax.device_get(jgrads)),
                           device="cpu")
    params = load_jax_params(flat, device="cpu")
    leaves = toptim.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    out = tenc.cross_modal_repr(
        params["v_encoder"]["f_encoder"], tcfg.f_config,
        *(_t(batch[k]) for k in ("sub_input_ids", "txt_mask", "v_feats",
                                 "v_mask")),
        packed={k: _t(v) for k, v in packed.items()})
    loss = (out * _t(g)).sum() / (n * (FRAMES + TXT))
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    assert float(loss.detach()) == pytest.approx(float(jl), abs=2e-6)
    n_nonzero = 0
    for path, a, w in zip(toptim.tree_paths(want), got,
                          toptim.tree_leaves(want)):
        a = torch.zeros_like(w) if a is None else a
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5, rtol=0,
                                   err_msg="/".join(path))
        n_nonzero += bool(float(w.abs().max()) > 0)
    assert n_nonzero > 10


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["segment", "validity", "causal"])
def test_plain_p_is_exactly_zero_where_a_row_may_not_attend(mode, dtype):
    """The plain forward's saved p (``packed_forward_reference``) is
    exactly 0.0 on every key a row with an attendable key may not attend
    -- another segment, an invalid key, a key past the causal limit --
    in fp32 and in bf16: the -1e4 bias puts exp(s - max) below fp32's
    smallest subnormal.  This is what lets the forward kernel skip such
    chunks and write zeros.  On a row that may attend nothing (a pad
    slot, a batch row with no valid key) the bias cancels in the
    softmax, and no p of it is 0 (with the causal bias: none within the
    row's causal limit)."""
    B, L = 2, 96
    r = np.random.RandomState(96)
    q, k, v = (_t(r.randn(B, L, D).astype(np.float32)).to(dtype)
               for _ in range(3))
    causal = mode == "causal"
    if mode == "segment":
        seg = np.stack([_runs(r, L, 8, 30, 2) for _ in range(B)])
        seg[:, :2] = -1                                  # pad slots
        kw = {"seg": _t(seg)}
        allowed = (seg[:, :, None] == seg[:, None, :]) & (seg >= 0)[:, :,
                                                                    None]
    else:
        m = (np.arange(L)[None] < np.array([[L - 20], [0]])).astype(
            np.float32)                      # batch row 1: no valid key
        kw = {"kv_mask": _t(m)}
        allowed = np.broadcast_to((m > 0)[:, None, :], (B, L, L)).copy()
        if causal:
            allowed &= np.arange(L)[None, None] <= np.arange(L)[None, :,
                                                                None]
    _, p = tatt.packed_forward_reference(q, k, v, HEADS, save_probs=True,
                                         causal=causal, **kw)
    p = p.float().numpy()                                  # (B, H, L, L)
    has_key = allowed.any(-1)                              # (B, L)
    assert has_key.any() and (~has_key).any()
    masked = ~allowed[:, None] & has_key[:, None, :, None]
    assert masked.any()
    assert (p[np.broadcast_to(masked, p.shape)] == 0.0).all()
    # a row that may attend nothing: every key carries one -1e4, and with
    # the causal bias the keys past the row's limit a second one (those
    # are 0 again); the rest share the unmasked softmax
    free = ~has_key[:, None, :, None] & np.ones((1, 1, 1, L), bool)
    if causal:
        free = free & (np.arange(L)[None, None, None]
                       <= np.arange(L)[None, None, :, None])
    free = np.broadcast_to(free, p.shape)
    assert (p[free] > 0.0).all()
