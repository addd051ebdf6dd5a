"""Functional NN primitives (counterpart of ``hero_tpu/models/nn.py``).

Parameters are plain nested dicts of tensors in PyTorch's layout:

- a linear is ``{"weight": (out, in), "bias": (out,)}`` (the bridge in
  ``convert/from_jax.py`` transposes the JAX ``(in, out)`` kernels);
- a LayerNorm is ``{"weight": (d,), "bias": (d,)}``, always fp32.

Parameters are fp32; compute runs in a caller-chosen ``dtype`` (bf16 on the
card), with each weight cast where it is used, as the JAX package does.

Randomness is an integer seed instead of a JAX PRNG key: :func:`rng_for`
derives a named sub-seed, and each dropout site draws from a
``torch.Generator`` seeded with its own.  ``seed=None`` means eval mode
(no dropout), as ``rng=None`` does in the JAX package.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from hero_tpu_torch.const import NEG_INF
from hero_tpu_torch.ops import layernorm as _ln
from hero_tpu_torch.ops.layernorm import layer_norm
from hero_tpu_torch.parallel import dist

Params = Dict[str, Any]


def rng_for(seed: Optional[int], tag: str) -> Optional[int]:
    """A named sub-seed of an optional seed: the crc32 of ``tag`` started
    from the seed (``hero_tpu/models/nn.py:32-36`` folds the same crc32
    into a PRNG key).  Sub-seeds are 32-bit."""
    if seed is None:
        return None
    return zlib.crc32(tag.encode(), seed & 0xFFFFFFFF)


def dropout_add_layer_norm(p: Params, y: torch.Tensor, x: torch.Tensor,
                           rate: float, seed: Optional[int],
                           eps: float = 1e-5) -> torch.Tensor:
    """``LN(dropout(y) + x)``, the fused kernels #8 and #9 on the card
    (``hero_tpu/models/nn.py:105-112``).  No model code calls it: the
    transformer keeps dropout, add and :func:`apply_layer_norm` apart,
    as the JAX package does."""
    return _ln.dropout_add_layer_norm(y, x, p["weight"], p["bias"],
                                      rate=rate, seed=dist.fold_rank(seed),
                                      eps=eps)


def dropout(x: torch.Tensor, rate: float,
            seed: Optional[int]) -> torch.Tensor:
    """Inverted dropout with an exact Bernoulli(1 - rate) keep mask drawn
    from a generator on x's device seeded with ``seed``; the identity when
    ``seed`` is None or ``rate`` is 0 (``hero_tpu/models/nn.py:115-128``,
    without its uint16 quantisation of the rate, a TPU workaround).  In a
    data-parallel step the rank is folded into the seed
    (``parallel/dist.fold_rank``)."""
    if seed is None or rate <= 0.0:
        return x
    seed = dist.fold_rank(seed)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.empty(x.shape, dtype=torch.float32,
                       device=x.device).bernoulli_(1.0 - rate, generator=gen)
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


def tree_to(p: Any, device) -> Any:
    """A parameter tree with every tensor moved to ``device`` (tensors
    already there are shared, not copied)."""
    if isinstance(p, dict):
        return {k: tree_to(v, device) for k, v in p.items()}
    if isinstance(p, list):
        return [tree_to(v, device) for v in p]
    return None if p is None else p.to(device)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU: x * 0.5 * (1 + erf(x / sqrt(2)))."""
    return F.gelu(x)


def linear(p: Params, x: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dtype = dtype or x.dtype
    bias = p["bias"].to(dtype) if "bias" in p else None
    return F.linear(x.to(dtype), p["weight"].to(dtype), bias)


class _Embedding(torch.autograd.Function):
    """``F.embedding`` whose backward sums each row's gradients in a fixed
    order.  The default CUDA backward adds rows that share an index in no
    fixed order: a table read at many repeated indices (the position
    tables, the two-row MFM mask tables) got a gradient that differed in
    its last bits from one run to the next on the card, and so did the
    parameters of a resumed run.  PyTorch's deterministic implementation
    (sorted indices, a fixed summation order) runs for this op alone."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        # the ATen flags themselves: torch.use_deterministic_algorithms
        # also imports torch._inductor (seconds, and hundreds of modules)
        C = torch._C
        was = (C._get_deterministic_algorithms(),
               C._get_deterministic_algorithms_warn_only(),
               C._get_deterministic_fill_uninitialized_memory())
        C._set_deterministic_algorithms(True, warn_only=True)
        C._set_deterministic_fill_uninitialized_memory(False)
        try:
            out = torch.ops.aten.embedding_dense_backward(
                grad.contiguous(), ids, ctx.rows, -1, False)
        finally:
            C._set_deterministic_algorithms(was[0], warn_only=was[1])
            C._set_deterministic_fill_uninitialized_memory(was[2])
        return out, None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    # gather first, cast the gathered rows (not the whole table)
    if table.requires_grad:
        rows = _Embedding.apply(table, ids.long())
    else:
        rows = F.embedding(ids.long(), table)
    return rows.to(dtype or table.dtype)


def apply_layer_norm(p: Params, x: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    return layer_norm(x, p["weight"], p["bias"], eps)


def linear_layer(p: Params, x: torch.Tensor, *, relu: bool = True,
                 dropout_rate: float = 0.1, seed: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LinearLayer: [LN] -> dropout -> linear -> [relu]
    (``hero_tpu/models/nn.py:160-169``)."""
    if "ln" in p:
        x = apply_layer_norm(p["ln"], x)
    x = dropout(x, dropout_rate, seed)
    x = linear(p["dense"], x, dtype)
    return torch.relu(x) if relu else x


def mlp_layer(p: Params, x: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """MLPLayer: linear(d, 2d) -> GELU -> LayerNorm -> linear(2d, out)
    (``hero_tpu/models/nn.py:144-157``), the FOM head."""
    h = gelu(linear(p["linear_1"], x, dtype))
    h = apply_layer_norm(p["ln"], h)
    return linear(p["linear_2"], h, dtype)


def mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """logits + (1 - mask) * -1e4."""
    return logits + (1.0 - mask.to(logits.dtype)) * NEG_INF


def prune_attention_heads(attn_params: Params, heads, n_heads: int
                          ) -> Params:
    """Remove ``heads`` of ``n_heads`` from an attention block
    (``hero_tpu/models/nn.py:177-198``; reference prune_heads +
    prune_linear_layer, model/layers.py:189-216, modeling_utils.py:
    14-39): the kept heads' rows of each of the fused ``qkv``'s three
    parts and their input columns of ``out``.  Returns new params; the
    caller shrinks ``num_attention_heads`` in the config."""
    qkv_w, qkv_b = attn_params["qkv"]["weight"], attn_params["qkv"]["bias"]
    width = qkv_w.shape[0] // 3
    head_dim = width // n_heads
    drop = set(heads)
    cols = torch.cat([torch.arange(h * head_dim, (h + 1) * head_dim,
                                   device=qkv_w.device)
                      for h in range(n_heads) if h not in drop])
    rows = torch.cat([cols + i * width for i in range(3)])
    out = dict(attn_params)
    out["qkv"] = {"weight": qkv_w[rows], "bias": qkv_b[rows]}
    out["out"] = dict(attn_params["out"],
                      weight=attn_params["out"]["weight"][:, cols])
    return out
