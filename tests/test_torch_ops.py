"""hero_tpu_torch ops: the plain attention and LayerNorm against the JAX
package (its jnp path and its Pallas kernels in interpret mode), and the
rule that a CUDA entry point raises instead of falling back when there is
no card.  The CUDA kernels are held against the plain versions in
``test_torch_kernels.py``, which runs on the card.

Inputs are numpy arrays from a seed, handed to both frameworks; all
comparisons are fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.ops import attention as jatt
from hero_tpu.ops import layernorm as jln
from hero_tpu_torch.ops import attention as tatt
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
    q, k, v = (_t(x) for x in _qkv(8))
    with pytest.raises(NotImplementedError):
        tatt.packed_attention(q, k, v, HEADS, dropout_rate=0.1)


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
