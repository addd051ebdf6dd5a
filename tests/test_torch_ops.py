"""hero_tpu_torch ops: the plain attention and LayerNorm, forward and
backward, against the JAX package (its jnp path and its Pallas kernels in
interpret mode), the Philox dropout draws against a scalar Python Philox,
and the rule that a CUDA entry point raises instead of falling back when
there is no card.  The CUDA kernels are held against the plain versions in
``test_torch_kernels.py``, which runs on the card.

Inputs are numpy arrays from a seed, handed to both frameworks; all
comparisons are fp32.  JAX's TPU PRNG has no CPU lowering, so dropout is
tested on its own (keep rate, determinism, the bits themselves), as
``tests/test_ops.py`` does for the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.ops import attention as jatt
from hero_tpu.ops import layernorm as jln
from hero_tpu_torch.models import nn as tnn
from hero_tpu_torch.ops import attention as tatt
from hero_tpu_torch.ops import dropout as tdrop
from hero_tpu_torch.ops import layernorm as tln

# fp32 on the CPU: the two frameworks sum 64-term dots and <= 40-term
# softmax/P.V rows in different orders (~1e-7 relative per op)
ATOL = 2e-5

B, L, HEADS, HEAD_DIM = 2, 40, 2, 64          # head_dim of the flagship
D = HEADS * HEAD_DIM


def _qkv(seed):
    r = np.random.RandomState(seed)
    return [r.randn(B, L, D).astype(np.float32) for _ in range(3)]


def _validity_mask(seed):
    r = np.random.RandomState(seed)
    lens = r.randint(L // 4, L + 1, (B,))
    return (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)


def _segments(seed):
    """Segment ids (B, L): runs of 3-9 slots per segment, -1 pad tail."""
    r = np.random.RandomState(seed)
    seg = np.full((B, L), -1, np.int32)
    for b in range(B):
        pos, s = 0, 0
        while pos < L - 6:
            n = r.randint(3, 10)
            seg[b, pos:pos + n] = s
            pos, s = pos + n, s + 1
    return seg


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("mode", ["validity", "segment"])
def test_plain_attention_matches_jax_reference(mode):
    q, k, v = _qkv(0)
    if mode == "validity":
        m = _validity_mask(1)
        jmask, tkw = jnp.asarray(m), {"kv_mask": _t(m)}
    else:
        seg = _segments(2)
        jmask = jax.nn.one_hot(seg, 16, dtype=jnp.float32)
        tkw = {"seg": _t(seg)}
    want = np.asarray(jatt.packed_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), HEADS, jmask,
        use_pallas=False))
    got = tatt.packed_attention(_t(q), _t(k), _t(v), HEADS, **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["validity", "segment"])
def test_plain_attention_matches_pallas_interpret_valid_rows(mode):
    """Against the Pallas kernels run in interpret mode.  The Pallas path
    pads keys to a multiple of 64, which changes fully masked query rows
    only: compare the rows that have a valid key."""
    q, k, v = _qkv(3)
    if mode == "validity":
        m = _validity_mask(4)
        jmask, tkw = jnp.asarray(m), {"kv_mask": _t(m)}
        rows = np.ones((B, L), bool)
    else:
        seg = _segments(5)
        jmask = jax.nn.one_hot(seg, 16, dtype=jnp.float32)
        tkw = {"seg": _t(seg)}
        rows = seg >= 0
    want = np.asarray(jatt.packed_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), HEADS, jmask,
        use_pallas=True))
    got = tatt.packed_attention(_t(q), _t(k), _t(v), HEADS, **tkw).numpy()
    np.testing.assert_allclose(got[rows], want[rows], atol=ATOL, rtol=0)


def test_plain_attention_on_fused_qkv_views():
    """q/k/v as column slices of one fused projection (the model's layout)
    give the same result as contiguous copies."""
    q, k, v = _qkv(6)
    qkv = _t(np.concatenate([q, k, v], -1))
    views = qkv.split(D, dim=-1)
    m = _t(_validity_mask(7))
    got = tatt.packed_attention(*views, HEADS, kv_mask=m)
    want = tatt.packed_attention(_t(q), _t(k), _t(v), HEADS, kv_mask=m)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_attention_dropout_is_not_served():
    """A serving call (no gradient, no rate) draws no dropout and records
    no graph; a rate without a seed is refused, not ignored."""
    q, k, v = (_t(x) for x in _qkv(8))
    with torch.inference_mode():
        out = tatt.packed_attention(q, k, v, HEADS)
    assert out.grad_fn is None
    torch.testing.assert_close(out, tatt.packed_reference(q, k, v, HEADS),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="seed"):
        tatt.packed_attention(q, k, v, HEADS, dropout_rate=0.1)


@pytest.mark.parametrize("mode", ["validity", "segment"])
def test_plain_attention_backward_matches_pallas_interpret(mode):
    """The plain saved-probabilities backward (through the autograd
    Function) against ``jax.grad`` of the Pallas path in interpret mode,
    which runs ``_bwd3_kernel``.  Lk = 64 is a multiple of the Pallas key
    padding, so no padded column joins any softmax."""
    r = np.random.RandomState(20)
    L2 = 64
    q, k, v, g = (r.randn(B, L2, D).astype(np.float32) for _ in range(4))
    if mode == "validity":
        lens = np.array([L2, 37])
        m = (np.arange(L2)[None, :] < lens[:, None]).astype(np.float32)
        jmask, tkw = jnp.asarray(m), {"kv_mask": _t(m)}
    else:
        seg = np.repeat(np.arange(8, dtype=np.int32)[None], B, 0)
        seg = np.repeat(seg, 8, axis=1)                       # 8 x 8 slots
        jmask = jax.nn.one_hot(seg, 16, dtype=jnp.float32)
        tkw = {"seg": _t(seg)}

    def jloss(q, k, v):
        out = jatt.packed_attention(q, k, v, HEADS, jmask, use_pallas=True)
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tatt.packed_attention(tq, tk, tv, HEADS, **tkw)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    for a, b in zip(got, want):
        # 64-term fp32 products in other orders; grads are O(10)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def test_plain_attention_backward_regenerates_the_dropout_mask():
    """With dropout the backward of the Function equals autograd of the
    plain forward that drew the same Philox mask."""
    q, k, v = (_t(x).double().float().requires_grad_(True)
               for x in _qkv(21))
    seg = _t(_segments(22))
    g = torch.from_numpy(np.random.RandomState(23).randn(B, L, D).astype(
        np.float32))
    kw = dict(seg=seg, dropout_rate=0.25, seed=2 ** 40 + 7)
    out = tatt.packed_attention(q, k, v, HEADS, **kw)
    ref = tatt.packed_reference(q, k, v, HEADS, **kw)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(ref, (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def _ln_inputs(seed, n=16, d=4352):
    r = np.random.RandomState(seed)
    x = (r.randn(n, d) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * r.randn(d)).astype(np.float32)
    b = (0.1 * r.randn(d)).astype(np.float32)
    return x, w, b


def test_plain_layer_norm_matches_jax_reference_and_interpret():
    # fp32 statistics over 4352-wide rows, summed in different orders
    x, w, b = _ln_inputs(9)
    got = tln.layer_norm(_t(x), _t(w), _t(b)).numpy()
    ref = np.asarray(jln.layer_norm_reference(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(b)))
    kern = np.asarray(jln._fused_layer_norm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5, True))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, kern, atol=1e-5, rtol=0)


def test_plain_layer_norm_backward_matches_pallas_interpret():
    """The plain backward (through the autograd Function) against
    ``jax.grad`` of the Pallas LayerNorm in interpret mode, which runs
    ``_bwd_kernel``: dx, and dw/db summed over the rows."""
    x, w, b = _ln_inputs(24, n=32, d=768)
    g = np.random.RandomState(25).randn(32, 768).astype(np.float32)

    def jloss(x, w, b):
        return jnp.sum(jln._fused_layer_norm(x, w, b, 1e-5, True) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    tx, tw, tb = (_t(a).requires_grad_(True) for a in (x, w, b))
    out = tln.layer_norm(tx, tw, tb)
    got = torch.autograd.grad(out, (tx, tw, tb), _t(g))
    assert got[1].dtype == got[2].dtype == torch.float32
    # fp32 row means of 768 terms (dx) and column sums of 32 terms (dw,
    # db) taken in other orders
    for a, w_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w_), atol=2e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("max_groups", [tln.LN_BWD_GROUPS, 7])
def test_backward_row_partition_covers_every_row_once(max_groups):
    """The backward kernels' partition of n rows (``row_groups``): every
    row in exactly one group, no group empty, at most ``max_groups``
    groups, and the same partition on every call for one n -- the
    partial dw/db sums, and so the grads, depend on it alone."""
    P = max_groups
    for n in (0, 1, 2, 37, P - 1, P, P + 1, 2 * P + 1, 3200, 13312, 18432,
              20800, 10 ** 6 + 7):
        groups, rows = tln.row_groups(n, P)
        assert tln.row_groups(n, P) == (groups, rows)
        if n == 0:
            assert groups == 0
            continue
        assert 1 <= groups <= P
        seen = np.zeros(n, np.int64)
        for i in range(groups):
            lo, hi = i * rows, min(n, (i + 1) * rows)
            assert lo < hi
            seen[lo:hi] += 1
        assert (seen == 1).all()


# ---------------------------------------------------------------------------
# Philox dropout
# ---------------------------------------------------------------------------

def _philox_scalar(seed, ctr, all_words=False):
    """Philox4x32-10 in Python ints (Random123's definition): word 0, or
    the four words with ``all_words``."""
    m = 0xFFFFFFFF
    k0, k1 = seed & m, (seed >> 32) & m
    c0, c1, c2, c3 = ctr
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + 0x9E3779B9) & m, (k1 + 0xBB67AE85) & m
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & m,
                          (p0 >> 32) ^ c3 ^ k1, p0 & m)
    return (c0, c1, c2, c3) if all_words else c0


def test_philox_matches_the_scalar_definition():
    r = np.random.RandomState(26)
    for seed in (0, 1, 12345, 2 ** 32 + 99, 2 ** 64 - 1):
        ctr = r.randint(0, 2 ** 32, (300, 4), dtype=np.uint64)
        ctr[:4] = [[0, 0, 0, 0], [2 ** 32 - 1] * 4, [1, 2, 3, 4],
                   [2 ** 31, 0, 2 ** 31, 0]]
        cols = [torch.from_numpy(ctr[:, i].astype(np.int64))
                for i in range(4)]
        want = [_philox_scalar(seed, tuple(int(c) for c in row), True)
                for row in ctr]
        got = tdrop.philox4x32(seed, *cols).tolist()
        assert got == [w[0] for w in want]
        words = tdrop.philox4x32_words(seed, *cols)
        assert [tuple(w) for w in zip(*(t.tolist() for t in words))] == want


def _row_bits_scalar(seed, row, col):
    """Bits of row-tensor element (row, col): word col & 3 of the scalar
    Philox at counter (col >> 2, row lo, row hi, 2^32 - 1)."""
    words = _philox_scalar(seed, (col >> 2, row & 0xFFFFFFFF, row >> 32,
                                  0xFFFFFFFF), True)
    return words[col & 3]


@pytest.mark.parametrize("n, d", [(1, 1), (3, 3), (2, 4), (5, 13),
                                  (4, 64), (3, 130)])
def test_row_keep_mask_takes_word_col_mod_4_of_the_quad_call(n, d):
    """The row stream's layout: element (row, col) keeps where word col & 3
    of Philox4x32-10 at (col >> 2, row lo, row hi, 2^32 - 1) says so, one
    call per four columns, at widths that are and are not a multiple of
    4; the rate is compared in fp32."""
    seed, rate = 2 ** 37 + 9, 0.3
    keep = tdrop.row_keep_mask(seed, n, d, rate)
    assert keep.shape == (n, d) and keep.dtype == torch.bool
    want = [[(_row_bits_scalar(seed, i, j) >> 8) / 2 ** 24
             >= np.float32(rate) for j in range(d)] for i in range(n)]
    assert keep.tolist() == want


def test_row_words_past_two_to_the_32_rows():
    """Rows past 2^32 put their high word in counter word 2: the four
    words of ``row_words`` equal the scalar call's for each quad."""
    seed = 2 ** 40 + 3
    rows = [0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 7, 2 ** 40 + 5,
            2 ** 63 - 1]
    quads = [0, 1, 3, 3631]
    row = torch.tensor(rows, dtype=torch.int64)[:, None]
    quad = torch.tensor(quads, dtype=torch.int64)[None]
    words = tdrop.row_words(seed, row, quad)
    for i, rw in enumerate(rows):
        for j, q in enumerate(quads):
            want = _philox_scalar(seed, (q, rw & 0xFFFFFFFF, rw >> 32,
                                         0xFFFFFFFF), True)
            assert tuple(int(w[i, j]) for w in words) == want
            assert all(_row_bits_scalar(seed, rw, 4 * q + k) == want[k]
                       for k in range(4))


def test_row_keep_mask_rate_determinism_and_blocks():
    """Bernoulli(1 - rate) within 4 sigma, the same for one seed and
    another for another seed, and a smaller (n', d') mask is the
    top-left block of a larger one (each bit depends on its coordinates
    alone, whatever the width)."""
    seed, rate = 99, 0.1
    keep = tdrop.row_keep_mask(seed, 300, 771, rate)
    n = keep.numel()
    assert abs(float(keep.float().mean()) - 0.9) < 4 * (0.09 / n) ** 0.5
    assert torch.equal(keep, tdrop.row_keep_mask(seed, 300, 771, rate))
    assert not torch.equal(keep, tdrop.row_keep_mask(seed + 1, 300, 771,
                                                     rate))
    for n_, d_ in ((1, 1), (7, 3), (299, 770), (40, 768), (300, 5)):
        assert torch.equal(tdrop.row_keep_mask(seed, n_, d_, rate),
                           keep[:n_, :d_])
    # the row stream is apart from the attention stream's counters
    att = tdrop.attention_keep_mask(seed, 1, 1, 300, 771, rate)[0, 0]
    assert not torch.equal(att, keep)


@pytest.mark.parametrize("rate, refused", [(1.0 - 2.0 ** -26, True),
                                           (1.0, True),
                                           (1.0 - 2.0 ** -24, False)])
def test_daln_takes_rates_below_one_in_fp32_only(rate, refused):
    """The fused dropout-add-LayerNorm refuses a rate that rounds to 1 in
    fp32, as its kernels take it (1 - 2^-26 is below 1 as a double; there
    the kernels' integer keep threshold would wrap to 0 and keep every
    element, while the plain mask keeps none), and takes the largest fp32
    rate below 1."""
    y, x, g = (torch.full((2, 9), v) for v in (1.0, 2.0, 0.5))
    w, b = torch.ones(9), torch.zeros(9)
    if refused:
        with pytest.raises(ValueError, match="rate"):
            tln.dropout_add_layer_norm(y, x, w, b, rate=rate, seed=3)
        with pytest.raises(ValueError, match="rate"):
            tln.dropout_add_layer_norm_bwd_reference(y, x, w, g, rate, 3)
    else:
        out = tln.dropout_add_layer_norm(y, x, w, b, rate=rate, seed=3)
        assert bool(torch.isfinite(out).all())
        dy = tln.dropout_add_layer_norm_bwd_reference(y, x, w, g, rate,
                                                      3)[0]
        keep = tdrop.row_keep_mask(3, 2, 9, rate)
        assert torch.equal(dy != 0, keep & (dy != 0))


def test_attention_keep_mask_rate_determinism_and_layout():
    B_, H_, Lq_, Lk_ = 3, 4, 50, 70
    keep = tdrop.attention_keep_mask(99, B_, H_, Lq_, Lk_, 0.1)
    n = keep.numel()
    # Bernoulli(0.9): within 4 sigma of the keep rate
    assert abs(float(keep.float().mean()) - 0.9) < 4 * (0.09 / n) ** 0.5
    assert torch.equal(keep, tdrop.attention_keep_mask(99, B_, H_, Lq_, Lk_,
                                                       0.1))
    assert not torch.equal(keep, tdrop.attention_keep_mask(
        100, B_, H_, Lq_, Lk_, 0.1))
    # element (b, h, i, j) depends on its coordinates, not on the shape
    sub = tdrop.attention_keep_mask(99, 2, 2, 20, 30, 0.1)
    assert torch.equal(sub, keep[:2, :2, :20, :30])
    bits = _philox_scalar(99, (5, 7, 1, 2))
    assert bool(keep[2, 1, 7, 5]) == ((bits >> 8) / 2 ** 24 >= np.float32(
        0.1))


def test_model_dropout_is_exact_bernoulli_and_seeded():
    x = torch.ones(200, 500)
    y = tnn.dropout(x, 0.1, 7)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 4 * (0.09 / x.numel()
                                                        ) ** 0.5
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(y, tnn.dropout(x, 0.1, 7))
    assert not torch.equal(y, tnn.dropout(x, 0.1, 8))
    assert tnn.dropout(x, 0.1, None) is x
    assert tnn.rng_for(None, "a") is None
    assert tnn.rng_for(5, "a") != tnn.rng_for(5, "b") != tnn.rng_for(6, "b")


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from hero_tpu_torch import resolve_device
    from hero_tpu_torch.config.model_config import tiny_hero_config
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.evaluation.vcmr_eval import (VcmrEvalOpts,
                                                     embed_video_corpus,
                                                     validate_full_vcmr)
    from hero_tpu_torch.models.pretrain import VsmConfig, init_flat_params
    cfg = tiny_hero_config()
    flat = init_flat_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        load_jax_params(flat)
    params = load_jax_params(flat, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        embed_video_corpus(params, cfg, [])
    with pytest.raises(RuntimeError, match="cuda"):
        validate_full_vcmr(params, cfg, VsmConfig(lw_neg_ctx=1.0),
                           VcmrEvalOpts(), [], [], [], {}, {})
