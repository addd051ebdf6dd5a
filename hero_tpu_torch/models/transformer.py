"""Transformer encoder stack (counterpart of ``hero_tpu/models/transformer.py``).

Post-LN residual wiring as in the reference: attention -> dense + LN
residual, FFN -> dense + LN residual.  Self-attention uses one fused QKV
projection (``qkv``: (3D, D), rows ordered query, key, value) whose output
feeds the packed attention kernel through column views, with no head
transposes.  The JAX package scans one layer body over stacked parameters;
here ``p["layers"]`` is a list and the stack is a Python loop.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from hero_tpu_torch.config.model_config import TransformerConfig
from hero_tpu_torch.models import nn
from hero_tpu_torch.ops.attention import packed_attention

Params = Dict[str, Any]


def attention(p: Params, x: torch.Tensor, cfg: TransformerConfig, *,
              kv_mask: Optional[torch.Tensor] = None,
              seg: Optional[torch.Tensor] = None,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Self-attention plus the output projection and residual LayerNorm
    (``hero_tpu/models/transformer.py:73-101``).  ``kv_mask`` (B, L) or
    ``seg`` (B, L) segment ids select the mask mode."""
    D = x.shape[-1]
    qkv = nn.linear(p["qkv"], x, dtype)
    q, k, v = qkv.split(D, dim=-1)
    ctx = packed_attention(q, k, v, cfg.num_attention_heads,
                           kv_mask=kv_mask, seg=seg)
    y = nn.linear(p["out"], ctx, dtype)
    return nn.apply_layer_norm(p["out_ln"], y + x, cfg.layer_norm_eps)


def ffn(p: Params, x: torch.Tensor, cfg: TransformerConfig, *,
        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if cfg.hidden_act != "gelu":
        raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}")
    h = nn.gelu(nn.linear(p["intermediate"], x, dtype))
    h = nn.linear(p["output"], h, dtype)
    return nn.apply_layer_norm(p["ln"], h + x, cfg.layer_norm_eps)


def encoder_layer(p: Params, x: torch.Tensor, cfg: TransformerConfig, *,
                  kv_mask=None, seg=None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    x = attention(p["attention"], x, cfg, kv_mask=kv_mask, seg=seg,
                  dtype=dtype)
    return ffn(p["ffn"], x, cfg, dtype=dtype)


def encoder(p: Params, x: torch.Tensor, cfg: TransformerConfig, *,
            kv_mask=None, seg=None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """BertEncoder: the layers of ``p["layers"]`` in order
    (``hero_tpu/models/transformer.py:158-205``)."""
    for layer in p["layers"]:
        x = encoder_layer(layer, x, cfg, kv_mask=kv_mask, seg=seg,
                          dtype=dtype)
    return x
