"""Functional NN primitives (counterpart of ``hero_tpu/models/nn.py``).

Parameters are plain nested dicts of tensors in PyTorch's layout:

- a linear is ``{"weight": (out, in), "bias": (out,)}`` (the bridge in
  ``convert/from_jax.py`` transposes the JAX ``(in, out)`` kernels);
- a LayerNorm is ``{"weight": (d,), "bias": (d,)}``, always fp32.

Parameters are fp32; compute runs in a caller-chosen ``dtype`` (bf16 on the
card), with each weight cast where it is used, as the JAX package does.
Dropout is absent: the serving path runs in eval mode.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from hero_tpu_torch.const import NEG_INF
from hero_tpu_torch.ops.layernorm import layer_norm

Params = Dict[str, Any]


def tree_to(p: Any, device) -> Any:
    """A parameter tree with every tensor moved to ``device`` (tensors
    already there are shared, not copied)."""
    if isinstance(p, dict):
        return {k: tree_to(v, device) for k, v in p.items()}
    if isinstance(p, list):
        return [tree_to(v, device) for v in p]
    return p.to(device)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU: x * 0.5 * (1 + erf(x / sqrt(2)))."""
    return F.gelu(x)


def linear(p: Params, x: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dtype = dtype or x.dtype
    bias = p["bias"].to(dtype) if "bias" in p else None
    return F.linear(x.to(dtype), p["weight"].to(dtype), bias)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    # gather first, cast the gathered rows (not the whole table)
    return F.embedding(ids.long(), table).to(dtype or table.dtype)


def apply_layer_norm(p: Params, x: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    return layer_norm(x, p["weight"], p["bias"], eps)


def linear_layer(p: Params, x: torch.Tensor, *, relu: bool = True,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LinearLayer: [LN] -> linear -> [relu] (eval mode: no dropout)."""
    if "ln" in p:
        x = apply_layer_norm(p["ln"], x)
    x = linear(p["dense"], x, dtype)
    return torch.relu(x) if relu else x


def mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """logits + (1 - mask) * -1e4."""
    return logits + (1.0 - mask.to(logits.dtype)) * NEG_INF
