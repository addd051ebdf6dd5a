"""Packed multi-head attention: the plain PyTorch version and the CUDA kernel.

Counterpart of ``hero_tpu/ops/attention.py`` (``mha_reference`` and
``packed_attention``).  Two mask modes:

- validity: ``kv_mask`` (B, Lk), 1 = valid key;
- segment (sub packing, self-attention): ``seg`` (B, L) int32 segment ids,
  -1 = pad slot; token i may attend token j iff ``seg[i] == seg[j] >= 0``.
  The JAX package carries a (B, L, PACK_MAX_SEGS) one-hot and builds the
  block-diagonal mask with a matmul (a TPU matrix-unit trick); the ids
  express the same mask.

Masked scores get an ADDITIVE -1e4 (``const.NEG_INF``), so on a fully
masked row the bias cancels in the softmax and the row stays finite, never
NaN.  The function is defined with no key padding (the Pallas path pads Lk
to 64 with -1e4 columns, which join the softmax of fully masked rows only).  :func:`packed_attention` dispatches on the tensor's
device: CPU tensors take :func:`mha_reference`; CUDA tensors launch
``csrc/attention.cu`` or raise.  Every call on the card takes the kernel,
whatever Lk (no ``PALLAS_MIN_LK`` threshold).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hero_tpu_torch.const import NEG_INF
from hero_tpu_torch.ops import cuda_build

KERNEL_HEAD_DIMS = (32, 64, 128)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor] = None,
                  seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version (``hero_tpu/ops/attention.py:53-82``).

    q, k, v: (B, H, L, d).  ``kv_mask`` (B, Lk) or ``seg`` (B, Lk) as in
    the module doc (segment mode uses ``seg[:, :Lq]`` for the queries).
    Scores, softmax and the probability-value product are fp32; returns
    (B, H, Lq, d) in q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if seg is not None:
        sq = seg[:, :q.shape[2]]
        same = (sq[:, :, None] == seg[:, None, :]) & (sq >= 0)[:, :, None]
        s = s + (~same).float()[:, None] * NEG_INF
    elif kv_mask is not None:
        s = s + ((1.0 - kv_mask.float()) * NEG_INF)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_heads: int, kv_mask: Optional[torch.Tensor] = None,
                     seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`mha_reference` on packed (B, L, H*d) tensors."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    d = D // n_heads

    def heads(t, L):
        return t.reshape(B, L, n_heads, d).transpose(1, 2)

    out = mha_reference(heads(q, Lq), heads(k, Lk), heads(v, Lk), kv_mask,
                        seg)
    return out.transpose(1, 2).reshape(B, Lq, D)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("attention")
    fn = lib.hero_packed_attention_fwd
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i32, i32, vp, vp, vp, vp, vp] + [i32] * 5
                       + [i64] * 8 + [ctypes.c_float, vp])
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, n_heads: int, mask: torch.Tensor, seg_mode: bool):
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
    if any(t.device != q.device for t in (k, v, mask)):
        raise ValueError("q, k, v and the mask must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit stride on the last axis")
    if D % n_heads:
        raise ValueError(f"width {D} does not split into {n_heads} heads")
    d = D // n_heads
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if seg_mode and Lq > Lk:
        raise ValueError("segment mode is self-attention: Lq <= Lk")
    mask = (mask.to(torch.int32) if seg_mode else mask.float()).contiguous()
    if mask.shape != (B, Lk):
        raise ValueError(f"mask must be ({B}, {Lk}), got {tuple(mask.shape)}")
    out = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
    if B == 0 or Lq == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.hero_packed_attention_fwd(
            cuda_build.DTYPE_CODES[q.dtype], int(seg_mode), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), mask.data_ptr(),
            B, n_heads, Lq, Lk, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            1.0 / (d ** 0.5), cuda_build.stream_ptr(q))
    cuda_build.check(lib, err, "attention kernel")
    return out


def seg_attention_cuda(q, k, v, n_heads: int, seg: torch.Tensor):
    """Segment-mask kernel launch; ``seg_attention_cuda.launches`` counts
    them."""
    out = _launch(q, k, v, n_heads, seg, seg_mode=True)
    seg_attention_cuda.launches += 1
    return out


def valid_attention_cuda(q, k, v, n_heads: int, kv_mask: torch.Tensor):
    """Validity-mask kernel launch; ``valid_attention_cuda.launches``
    counts them."""
    out = _launch(q, k, v, n_heads, kv_mask, seg_mode=False)
    valid_attention_cuda.launches += 1
    return out


seg_attention_cuda.launches = 0
valid_attention_cuda.launches = 0


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_heads: int, kv_mask: Optional[torch.Tensor] = None,
                     seg: Optional[torch.Tensor] = None,
                     dropout_rate: float = 0.0) -> torch.Tensor:
    """Attention over PACKED (B, L, H*d) tensors -- the layout the fused QKV
    projection produces (q, k, v may be column slices of it) -- returning
    (B, Lq, H*d) (``hero_tpu/ops/attention.py:523-609``)."""
    if dropout_rate:
        raise NotImplementedError(
            "attention-probability dropout is training-only and waits for "
            "the training slice (ROADMAP B1)")
    if kv_mask is not None and seg is not None:
        raise ValueError("pass kv_mask or seg, not both")
    if q.device.type == "cpu":
        return packed_reference(q, k, v, n_heads, kv_mask, seg)
    if q.device.type != "cuda":
        raise ValueError(f"packed_attention runs on cpu or cuda, "
                         f"not {q.device}")
    if seg is not None:
        return seg_attention_cuda(q, k, v, n_heads, seg)
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:2], dtype=torch.float32,
                             device=q.device)
    return valid_attention_cuda(q, k, v, n_heads, kv_mask)
