"""Packed multi-head attention: the plain PyTorch versions, the CUDA
kernels, and the ``torch.autograd.Function`` that joins them.

Counterpart of ``hero_tpu/ops/attention.py`` (``mha_reference`` and
``packed_attention`` with its saved-probabilities backward), on the packed
(B, L, H*d) layout throughout.  Two mask
modes:

- validity: ``kv_mask`` (B, Lk), 1 = valid key;
- segment (sub packing, self-attention): ``seg`` (B, L) int32 segment ids,
  -1 = pad slot; token i may attend token j iff ``seg[i] == seg[j] >= 0``.
  The JAX package carries a (B, L, PACK_MAX_SEGS) one-hot and builds the
  block-diagonal mask with a matmul (a TPU matrix-unit trick); the ids
  express the same mask.

Masked scores get an ADDITIVE -1e4 (``const.NEG_INF``), so on a fully
masked row the bias cancels in the softmax and the row stays finite, never
NaN.  The function is defined with no key padding (the Pallas path pads Lk
to 64 with -1e4 columns, which join the softmax of fully masked rows only).

Training adds attention-probability dropout, drawn from Philox
(``ops/dropout.py``) per element (b, h, i, j) and regenerated in the
backward, which reads the saved pre-dropout probabilities:

    pd = keep * p / (1 - r),  dv = pd^T do
    dp = keep * (do v^T) / (1 - r),  ds = p o (dp - rowsum(dp o p))
    dq = ds k * scale,  dk = ds^T q * scale

:func:`packed_attention` always goes through :class:`PackedAttention`.
A CPU tensor takes the plain versions; a CUDA tensor launches
``csrc/attention.cu`` or raises.  Probabilities are written, and dropout
drawn, only when the call needs a gradient or a rate is set, so a serving
call launches the forward kernel exactly as an inference-only kernel would.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from hero_tpu_torch.const import NEG_INF
from hero_tpu_torch.ops import cuda_build
from hero_tpu_torch.ops.dropout import attention_keep_mask, float32

KERNEL_HEAD_DIMS = (32, 64, 128)


def _keep_scale(rate: float) -> float:
    """1 / (1 - rate) rounded once to fp32, as the kernels take it (a
    Python float, so the plain versions copy nothing to the device)."""
    return float32(1.0 / (1.0 - rate))


def _check_dropout(rate: float, seed: Optional[int]) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    if rate and seed is None:
        raise ValueError("attention dropout needs a seed")
    if rate and not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be a 64-bit unsigned int, got {seed}")


def _probs_reference(q, k, kv_mask, seg) -> torch.Tensor:
    """fp32 softmax probabilities (B, H, Lq, Lk) of (B, H, L, d) q, k
    (``mha_reference``, ``hero_tpu/ops/attention.py:53-82``).  ``kv_mask``
    (B, Lk) or ``seg`` (B, Lk) as in the module doc (segment mode uses
    ``seg[:, :Lq]`` for the queries)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if seg is not None:
        sq = seg[:, :q.shape[2]]
        same = (sq[:, :, None] == seg[:, None, :]) & (sq >= 0)[:, :, None]
        s = s + (~same).float()[:, None] * NEG_INF
    elif kv_mask is not None:
        s = s + ((1.0 - kv_mask.float()) * NEG_INF)[:, None, None, :]
    return torch.softmax(s, dim=-1)


def _drop(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    """keep * x / (1 - rate) with the Philox mask of x's (B, H, Lq, Lk)."""
    if not rate:
        return x
    keep = attention_keep_mask(seed, *x.shape, rate, device=x.device)
    return torch.where(keep, x * _keep_scale(rate), 0.0)


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, L, D = t.shape
    return t.reshape(B, L, n_heads, D // n_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    B, H, L, d = t.shape
    return t.transpose(1, 2).reshape(B, L, H * d)


def packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_heads: int, kv_mask: Optional[torch.Tensor] = None,
                     seg: Optional[torch.Tensor] = None,
                     dropout_rate: float = 0.0,
                     seed: Optional[int] = None) -> torch.Tensor:
    """The plain forward: (B, Lq, H*d) in q's dtype; scores, softmax and
    the probability-value product in fp32."""
    return packed_forward_reference(q, k, v, n_heads, kv_mask, seg,
                                    dropout_rate, seed)[0]


def packed_forward_reference(q, k, v, n_heads: int, kv_mask=None, seg=None,
                             dropout_rate: float = 0.0,
                             seed: Optional[int] = None,
                             save_probs: bool = False
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain forward on packed tensors: (out (B, Lq, H*d), the
    pre-dropout probabilities (B, H, Lq, Lk) in q's dtype or None)."""
    _check_dropout(dropout_rate, seed)
    p = _probs_reference(_heads(q, n_heads), _heads(k, n_heads), kv_mask,
                         seg)
    out = torch.einsum("bhqk,bhkd->bhqd", _drop(p, dropout_rate, seed),
                       _heads(v, n_heads).float()).to(q.dtype)
    return _merge(out), (p.to(q.dtype) if save_probs else None)


def packed_backward_reference(p: torch.Tensor, q, k, v, dout,
                              n_heads: int, dropout_rate: float = 0.0,
                              seed: Optional[int] = None):
    """The plain saved-probabilities backward (``_bwd3_kernel``,
    ``hero_tpu/ops/attention.py:342-381``): (dq, dk, dv) of packed
    tensors from the saved pre-dropout ``p`` (B, H, Lq, Lk), in fp32 and
    rounded once to the inputs' dtypes."""
    _check_dropout(dropout_rate, seed)
    scale = 1.0 / ((q.shape[-1] // n_heads) ** 0.5)
    qh, kh, vh, gh = (_heads(t, n_heads).float() for t in (q, k, v, dout))
    pf = p.float()
    pd = _drop(pf, dropout_rate, seed)
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, gh)
    dp = _drop(torch.einsum("bhqd,bhkd->bhqk", gh, vh), dropout_rate, seed)
    ds = pf * (dp - (dp * pf).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale
    return (_merge(dq).to(q.dtype), _merge(dk).to(k.dtype),
            _merge(dv).to(v.dtype))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("attention")
    if lib.hero_packed_attention_fwd.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f32, u32 = ctypes.c_float, ctypes.c_uint
        lib.hero_packed_attention_fwd.argtypes = (
            [i32, i32] + [vp] * 6 + [i32] * 5 + [i64] * 8
            + [f32, f32, f32, u32, u32, vp])
        lib.hero_packed_attention_bwd.argtypes = (
            [i32] + [vp] * 8 + [i32] * 5 + [i64] * 14
            + [f32, f32, f32, u32, u32, vp])
        lib.hero_dropout_keep_mask.argtypes = [u32, u32] + [i32] * 4 + [
            f32, vp, vp]
        lib.hero_attention_smem_bytes.argtypes = [i32] * 4
        for fn in (lib.hero_packed_attention_fwd,
                   lib.hero_packed_attention_bwd, lib.hero_dropout_keep_mask):
            fn.restype = ctypes.c_int
        lib.hero_attention_smem_bytes.restype = i64
        lib.hero_attention_smem_limit.argtypes = []
        lib.hero_attention_smem_limit.restype = i64
    return lib


def _seed_words(seed: Optional[int]) -> Tuple[int, int]:
    seed = seed or 0
    return seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF


def _check_smem(lib, backward: bool, Lq: int, Lk: int, d: int) -> None:
    need = lib.hero_attention_smem_bytes(int(backward), Lq, Lk, d)
    limit = lib.hero_attention_smem_limit()
    if need > limit:
        raise ValueError(
            f"attention {'backward' if backward else 'forward'} kernel "
            f"needs {need} bytes of shared memory at Lq={Lq}, Lk={Lk}, "
            f"head_dim={d}; a block may use {limit}")


def _check_packed(q, k, v, n_heads: int) -> int:
    B, Lq, D = q.shape
    Lk = k.shape[1]
    if q.dtype not in cuda_build.DTYPE_CODES:
        raise TypeError(f"attention kernel takes float32/bfloat16, "
                        f"got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not (k.shape == v.shape == (B, Lk, D)):
        raise ValueError(f"k/v must be ({B}, Lk, {D}), got "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit stride on the last axis")
    if D % n_heads:
        raise ValueError(f"width {D} does not split into {n_heads} heads")
    d = D // n_heads
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    return d


def _launch(q, k, v, n_heads: int, mask: torch.Tensor, seg_mode: bool,
            dropout_rate: float, seed: Optional[int], save_probs: bool):
    _check_dropout(dropout_rate, seed)
    B, Lq, D = q.shape
    Lk = k.shape[1]
    d = _check_packed(q, k, v, n_heads)
    if any(t.device != q.device for t in (k, v, mask)):
        raise ValueError("q, k, v and the mask must be on one device")
    if seg_mode and Lq > Lk:
        raise ValueError("segment mode is self-attention: Lq <= Lk")
    mask = (mask.to(torch.int32) if seg_mode else mask.float()).contiguous()
    if mask.shape != (B, Lk):
        raise ValueError(f"mask must be ({B}, {Lk}), got {tuple(mask.shape)}")
    out = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
    probs = (torch.empty((B, n_heads, Lq, Lk), dtype=q.dtype,
                         device=q.device) if save_probs else None)
    if B == 0 or Lq == 0:
        return out, probs
    lib = _lib()
    _check_smem(lib, False, Lq, Lk, d)
    with torch.cuda.device(q.device):
        err = lib.hero_packed_attention_fwd(
            cuda_build.DTYPE_CODES[q.dtype], int(seg_mode), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), mask.data_ptr(),
            None if probs is None else probs.data_ptr(),
            B, n_heads, Lq, Lk, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            1.0 / (d ** 0.5), float(dropout_rate),
            _keep_scale(dropout_rate) if dropout_rate else 1.0,
            *_seed_words(seed), cuda_build.stream_ptr(q))
    cuda_build.check(lib, err, "attention kernel")
    return out, probs


def seg_attention_cuda(q, k, v, n_heads: int, seg: torch.Tensor,
                       dropout_rate: float = 0.0, seed: Optional[int] = None,
                       save_probs: bool = False):
    """Segment-mask forward kernel launch: (out, probs or None).
    ``seg_attention_cuda.launches`` counts the launches."""
    res = _launch(q, k, v, n_heads, seg, True, dropout_rate, seed,
                  save_probs)
    seg_attention_cuda.launches += 1
    return res


def valid_attention_cuda(q, k, v, n_heads: int, kv_mask: torch.Tensor,
                         dropout_rate: float = 0.0,
                         seed: Optional[int] = None,
                         save_probs: bool = False):
    """Validity-mask forward kernel launch: (out, probs or None).
    ``valid_attention_cuda.launches`` counts the launches."""
    res = _launch(q, k, v, n_heads, kv_mask, False, dropout_rate, seed,
                  save_probs)
    valid_attention_cuda.launches += 1
    return res


def attention_bwd_cuda(p, q, k, v, dout, n_heads: int,
                       dropout_rate: float = 0.0,
                       seed: Optional[int] = None):
    """Backward kernel launch: (dq, dk, dv), contiguous packed tensors.
    ``attention_bwd_cuda.launches`` counts the launches."""
    _check_dropout(dropout_rate, seed)
    B, Lq, D = q.shape
    Lk = k.shape[1]
    d = _check_packed(q, k, v, n_heads)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dout must have q's shape and dtype")
    if p.shape != (B, n_heads, Lq, Lk) or p.dtype != q.dtype:
        raise ValueError(f"p must be ({B}, {n_heads}, {Lq}, {Lk}) in "
                         f"{q.dtype}, got {tuple(p.shape)} {p.dtype}")
    if any(t.device != q.device for t in (p, k, v, dout)):
        raise ValueError("p, q, k, v and dout must be on one device")
    p = p.contiguous()
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    dq = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Lk, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Lk, D), dtype=v.dtype, device=q.device)
    if B == 0 or Lq == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = _lib()
    _check_smem(lib, True, Lq, Lk, d)
    with torch.cuda.device(q.device):
        err = lib.hero_packed_attention_bwd(
            cuda_build.DTYPE_CODES[q.dtype], p.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, n_heads, Lq, Lk, d,
            *(s for t in (q, k, v, dout, dq, dk, dv)
              for s in (t.stride(0), t.stride(1))),
            1.0 / (d ** 0.5), float(dropout_rate),
            _keep_scale(dropout_rate) if dropout_rate else 1.0,
            *_seed_words(seed), cuda_build.stream_ptr(q))
    cuda_build.check(lib, err, "attention backward kernel")
    attention_bwd_cuda.launches += 1
    return dq, dk, dv


seg_attention_cuda.launches = 0
valid_attention_cuda.launches = 0
attention_bwd_cuda.launches = 0


def dropout_keep_mask_cuda(seed: int, B: int, H: int, Lq: int, Lk: int,
                           rate: float, device) -> torch.Tensor:
    """The (B, H, Lq, Lk) bool keep mask the kernels draw, computed on the
    card by the same Philox code (for checks against ``ops/dropout.py``)."""
    _check_dropout(rate, seed)
    out = torch.empty((B, H, Lq, Lk), dtype=torch.uint8, device=device)
    lib = _lib()
    with torch.cuda.device(out.device):
        err = lib.hero_dropout_keep_mask(*_seed_words(seed), B, H, Lq, Lk,
                                         float(rate), out.data_ptr(),
                                         cuda_build.stream_ptr(out))
    cuda_build.check(lib, err, "dropout mask kernel")
    return out.bool()


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class PackedAttention(torch.autograd.Function):
    """Packed attention with its saved-probabilities backward.  Inputs:
    q, k, v (B, L, H*d), the mask ((B, Lk) validity or segment ids),
    n_heads, seg_mode, dropout_rate, seed."""

    @staticmethod
    def forward(ctx, q, k, v, mask, n_heads, seg_mode, dropout_rate, seed):
        save = any(ctx.needs_input_grad[:3])
        if q.device.type == "cpu":
            kw = {"seg": mask} if seg_mode else {"kv_mask": mask}
            out, probs = packed_forward_reference(
                q, k, v, n_heads, dropout_rate=dropout_rate, seed=seed,
                save_probs=save, **kw)
        elif q.device.type == "cuda":
            launch = seg_attention_cuda if seg_mode else valid_attention_cuda
            out, probs = launch(q, k, v, n_heads, mask, dropout_rate, seed,
                                save)
        else:
            raise ValueError(f"packed_attention runs on cpu or cuda, "
                             f"not {q.device}")
        if save:
            ctx.save_for_backward(probs, q, k, v)
            ctx.args = (n_heads, dropout_rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        probs, q, k, v = ctx.saved_tensors
        n_heads, rate, seed = ctx.args
        if q.device.type == "cpu":
            grads = packed_backward_reference(probs, q, k, v, dout, n_heads,
                                              rate, seed)
        else:
            grads = attention_bwd_cuda(probs, q, k, v, dout, n_heads, rate,
                                       seed)
        return (*grads, None, None, None, None, None)


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_heads: int, kv_mask: Optional[torch.Tensor] = None,
                     seg: Optional[torch.Tensor] = None,
                     dropout_rate: float = 0.0,
                     seed: Optional[int] = None) -> torch.Tensor:
    """Attention over PACKED (B, L, H*d) tensors -- the layout the fused QKV
    projection produces (q, k, v may be column slices of it) -- returning
    (B, Lq, H*d) (``hero_tpu/ops/attention.py:523-609``).  A nonzero
    ``dropout_rate`` needs ``seed`` (a 64-bit int: the Philox key)."""
    _check_dropout(dropout_rate, seed)
    if kv_mask is not None and seg is not None:
        raise ValueError("pass kv_mask or seg, not both")
    seg_mode = seg is not None
    mask = seg if seg_mode else kv_mask
    if mask is None:
        mask = torch.ones(k.shape[:2], dtype=torch.float32, device=q.device)
    return PackedAttention.apply(q, k, v, mask, n_heads, seg_mode,
                                 float(dropout_rate), seed)
