"""Counter-based dropout masks: Philox4x32-10 in plain PyTorch.

Stands in for the TPU PRNG of the Pallas kernels: the attention kernels'
(``hero_tpu/ops/attention.py:89-99``, ``_dropout_keep_mask``) and the fused
dropout-add-LayerNorm's (``hero_tpu/ops/layernorm.py:179-185``).  A keep
bit is a pure function of the seed and the element's coordinates:

- key = (seed mod 2^32, seed >> 32 mod 2^32);
- counter = (j, i, h, b) for attention-probability element (b, h, i, j),
  and (col, row mod 2^32, row >> 32, 2^32 - 1) for element (row, col) of a
  row tensor (:func:`row_keep_mask`; the last word, which no attention
  batch index reaches, keeps the two streams apart);
- bits = word 0 of Philox4x32-10(key, counter);
- keep = (bits >> 8) * 2^-24 >= rate, in fp32, as ``_dropout_keep_mask``.

So the draw does not depend on the launch geometry, and the backward
regenerates the forward's mask exactly.  ``csrc/philox.cuh`` computes the
same bits on the card; this plain version is what the CPU path and the
tests use and what the card's kernels are held against.

torch has no uint32 arithmetic, so the words are kept in int64 tensors.
The 32x32 -> 64-bit products of the Philox round would overflow int64, so
:func:`_mulhilo` splits the operand into 16-bit halves.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10
MASK32 = 0xFFFFFFFF
ROW_STREAM = 0xFFFFFFFF            # counter word 3 of the row-tensor draws


def float32(x: float) -> float:
    """``x`` rounded to the nearest fp32 value, as a Python float (exact
    in fp32 arithmetic, and no device copy when it meets a tensor)."""
    return struct.unpack("f", struct.pack("f", x))[0]


def keep_scale(rate: float) -> float:
    """1 / (1 - rate) rounded once to fp32, as the kernels take it (a
    Python float, so the plain versions copy nothing to the device)."""
    return float32(1.0 / (1.0 - rate))


def seed_words(seed: Optional[int]) -> Tuple[int, int]:
    """The Philox key (seed lo, seed hi) the kernels take; no seed is 0."""
    seed = seed or 0
    return seed & MASK32, (seed >> 32) & MASK32


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``m``
    and the uint32 values held in int64 tensor ``a``, with no partial
    product above 2^34."""
    m_lo, m_hi = m & 0xFFFF, m >> 16
    a_lo, a_hi = a & 0xFFFF, a >> 16
    ll, lh, hl, hh = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo, a_hi * m_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = (hh + (lh >> 16) + (hl >> 16) + (mid >> 16)) & MASK32
    return hi, lo


def philox4x32(seed: int, c0, c1, c2, c3) -> torch.Tensor:
    """Word 0 of Philox4x32-10 for key = (seed lo, seed hi) and the counter
    words c0..c3 (int64 tensors of uint32 values, broadcastable).
    Returns the uint32 bits as int64."""
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    for r in range(PHILOX_ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def attention_keep_mask(seed: int, B: int, H: int, Lq: int, Lk: int,
                        rate: float, device="cpu") -> torch.Tensor:
    """(B, H, Lq, Lk) bool keep mask of the attention-probability dropout
    with this ``seed`` and ``rate``."""
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be a 64-bit unsigned int, got {seed}")

    def ax(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    bits = philox4x32(seed, ax(Lk, 3), ax(Lq, 2), ax(H, 1), ax(B, 0))
    return _keep(bits, rate)


def _keep(bits: torch.Tensor, rate: float) -> torch.Tensor:
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u >= float32(rate)


def row_keep_mask(seed: int, n: int, d: int, rate: float,
                  device="cpu") -> torch.Tensor:
    """(n, d) bool keep mask of a row tensor's dropout with this ``seed``
    and ``rate`` (the fused dropout-add-LayerNorm's draw)."""
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be a 64-bit unsigned int, got {seed}")
    row = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    bits = philox4x32(seed, col, row & MASK32, row >> 32,
                      torch.full((1, 1), ROW_STREAM, dtype=torch.int64,
                                 device=device))
    return _keep(bits, rate)
