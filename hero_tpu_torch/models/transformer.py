"""Transformer encoder stack (counterpart of ``hero_tpu/models/transformer.py``).

Post-LN residual wiring as in the reference: attention -> dense + LN
residual, FFN -> dense + LN residual.  Self-attention uses one fused QKV
projection (``qkv``: (3D, D), rows ordered query, key, value) whose output
feeds the packed attention kernel through column views, with no head
transposes.  The JAX package scans one layer body over stacked parameters;
here ``p["layers"]`` is a list and the stack is a Python loop.

Training (``train=True`` with an integer ``seed``) adds the three dropout
sites of the JAX package: attention probabilities (inside the attention
kernel), the attention output and the FFN output.  Layer
rematerialisation (``set_remat``) is not ported (ROADMAP A2).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from hero_tpu_torch.config.model_config import TransformerConfig
from hero_tpu_torch.models import nn
from hero_tpu_torch.ops.attention import packed_attention

Params = Dict[str, Any]


def _rate(rate: float, train: bool, seed: Optional[int]) -> float:
    return rate if train and seed is not None else 0.0


def attention(p: Params, x: torch.Tensor, cfg: TransformerConfig, *,
              kv_mask: Optional[torch.Tensor] = None,
              seg: Optional[torch.Tensor] = None, train: bool = False,
              seed: Optional[int] = None,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Self-attention plus the output projection, dropout and residual
    LayerNorm (``hero_tpu/models/transformer.py:73-101``).  ``kv_mask``
    (B, L) or ``seg`` (B, L) segment ids select the mask mode."""
    D = x.shape[-1]
    qkv = nn.linear(p["qkv"], x, dtype)
    q, k, v = qkv.split(D, dim=-1)
    ctx = packed_attention(
        q, k, v, cfg.num_attention_heads, kv_mask=kv_mask, seg=seg,
        dropout_rate=_rate(cfg.attention_probs_dropout_prob, train, seed),
        seed=nn.rng_for(seed, "attn_probs"))
    y = nn.linear(p["out"], ctx, dtype)
    y = nn.dropout(y, _rate(cfg.hidden_dropout_prob, train, seed),
                   nn.rng_for(seed, "attn_out"))
    return nn.apply_layer_norm(p["out_ln"], y + x, cfg.layer_norm_eps)


def ffn(p: Params, x: torch.Tensor, cfg: TransformerConfig, *,
        train: bool = False, seed: Optional[int] = None,
        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if cfg.hidden_act != "gelu":
        raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}")
    h = nn.gelu(nn.linear(p["intermediate"], x, dtype))
    h = nn.linear(p["output"], h, dtype)
    h = nn.dropout(h, _rate(cfg.hidden_dropout_prob, train, seed),
                   nn.rng_for(seed, "ffn"))
    return nn.apply_layer_norm(p["ln"], h + x, cfg.layer_norm_eps)


def encoder_layer(p: Params, x: torch.Tensor, cfg: TransformerConfig, *,
                  kv_mask=None, seg=None, train: bool = False,
                  seed: Optional[int] = None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    x = attention(p["attention"], x, cfg, kv_mask=kv_mask, seg=seg,
                  train=train, seed=nn.rng_for(seed, "a"), dtype=dtype)
    return ffn(p["ffn"], x, cfg, train=train, seed=nn.rng_for(seed, "f"),
               dtype=dtype)


def encoder(p: Params, x: torch.Tensor, cfg: TransformerConfig, *,
            kv_mask=None, seg=None, train: bool = False,
            seed: Optional[int] = None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """BertEncoder: the layers of ``p["layers"]`` in order
    (``hero_tpu/models/transformer.py:158-205``); layer i draws from the
    sub-seed ``layer{i}``."""
    for i, layer in enumerate(p["layers"]):
        x = encoder_layer(layer, x, cfg, kv_mask=kv_mask, seg=seg,
                          train=train, seed=nn.rng_for(seed, f"layer{i}"),
                          dtype=dtype)
    return x
