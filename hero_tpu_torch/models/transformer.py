"""Transformer encoder and decoder stacks (counterpart of
``hero_tpu/models/transformer.py``).

Post-LN residual wiring as in the reference: attention -> dense + LN
residual, FFN -> dense + LN residual.  Every attention block keeps one
fused QKV projection (``qkv``: (3D, D), rows ordered query, key, value):
self-attention runs it whole and feeds the packed attention kernel
through column views, with no head transposes; cross-attention (the TVC
decoder) projects the queries with its first D rows and the keys and
values of the encoder output with the other 2D.  The JAX package scans one
layer body over stacked parameters; here ``p["layers"]`` is a list and the
stack is a Python loop.

The TVC decoder (:func:`decoder`, teacher-forced, and :func:`decoder_step`,
one token against a KV cache) attends causally over the caption, then
over the clip's encoder outputs.  The decode step's self-attention reads
one layer of the (layers, B, H, T, d) cache through the head-major
attention (``multi_head_attention``); its cross-attention re-projects the
encoder outputs every step, as the JAX package does.

Training (``train=True`` with an integer ``seed``) adds the three dropout
sites of the JAX package: attention probabilities (inside the attention
kernel), the attention output and the FFN output -- in the encoder layers
and in each of the decoder's self-attention, cross-attention and FFN.

Layer rematerialisation (:func:`set_remat`) wraps each training encoder
layer in ``torch.utils.checkpoint``: the layer keeps only its input, and
the backward reruns it.  Every dropout site draws from an integer seed and
the attention kernels regenerate their Philox bits, so the rerun redraws
the same bits and rebuilds the kernels' saved probabilities; a remat step
equals a plain step bit for bit.

On several ranks (``parallel/dist`` grids):

- an encoder stack sharded over pipeline stages (None in place of other
  stages' layers) runs through ``parallel/pipeline.pipelined_encoder``
  (``hero_tpu/models/transformer.py:185-190``);
- an attention or FFN block whose weights are a model rank's part
  (``parallel/mesh.tp_param_spec``, seen from their shapes) runs
  Megatron's tensor parallelism: ``dist.copy_to_inner`` before the
  column-parallel QKV / intermediate product, this rank's heads (H/S of
  them) or hidden units, the row-parallel product summed over the model
  ranks by ``dist.reduce_from_inner``, then the output bias once; the
  attention dropout folds the model rank (each rank's heads are its
  own);
- inside ``dist.seq_region`` (sequence parallelism) self-attention takes
  this rank's queries against every rank's keys and values
  (``dist.gather_kv``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from hero_tpu_torch.config.model_config import TransformerConfig
from hero_tpu_torch.models import nn
from hero_tpu_torch.parallel import dist, pipeline
from hero_tpu_torch.ops.attention import (merge_heads, multi_head_attention,
                                          packed_attention, split_heads)

Params = Dict[str, Any]

# Whole-run training policy, read by :func:`encoder` at each call (the JAX
# package's ``set_remat``, ``hero_tpu/models/transformer.py:35-44``).
_REMAT = False


def set_remat(enabled: bool) -> None:
    """Rematerialise every encoder layer of the training calls that follow:
    each layer keeps only its input for the backward and reruns its
    forward there (the JAX package saves the non-batched matmul outputs
    too; here the whole layer is recomputed)."""
    global _REMAT
    _REMAT = bool(enabled)


def _rate(rate: float, train: bool, seed: Optional[int]) -> float:
    return rate if train and seed is not None else 0.0


def attention(p: Params, x: torch.Tensor, cfg: TransformerConfig, *,
              kv_mask: Optional[torch.Tensor] = None,
              seg: Optional[torch.Tensor] = None,
              kv: Optional[torch.Tensor] = None, causal: bool = False,
              train: bool = False, seed: Optional[int] = None,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Self- (``kv`` None) or cross-attention plus the output projection,
    dropout and residual LayerNorm
    (``hero_tpu/models/transformer.py:73-101``).  ``kv_mask`` (B, Lk) or
    ``seg`` (B, L) segment ids select the mask mode; ``causal`` adds the
    decoder's causal bias."""
    D = x.shape[-1]
    part = p["qkv"]["weight"].shape[0] // 3      # D/S on a model rank
    # outside a model grid a narrow block is a pruned one
    # (nn.prune_attention_heads), whose config counts its heads
    tp = part != D and dist.inner_axis() == "model"
    heads = cfg.num_attention_heads
    if tp:
        if D % part or heads % (D // part):
            raise ValueError(f"{D // part} model ranks do not split "
                             f"{heads} heads of width {D}")
        heads //= D // part
        x_in = dist.copy_to_inner(x)
    else:
        x_in = x
    if kv is None:
        q, k, v = nn.linear(p["qkv"], x_in, dtype).split(part, dim=-1)
        if dist.in_seq_region():
            k, v = dist.gather_kv(k), dist.gather_kv(v)
    else:
        w, b = p["qkv"]["weight"], p["qkv"]["bias"]
        q = nn.linear({"weight": w[:part], "bias": b[:part]}, x_in, dtype)
        k, v = nn.linear({"weight": w[part:], "bias": b[part:]}, kv,
                         dtype).split(part, dim=-1)
    ctx = packed_attention(
        q, k, v, heads, kv_mask=kv_mask, seg=seg,
        dropout_rate=_rate(cfg.attention_probs_dropout_prob, train, seed),
        seed=dist.fold_rank(nn.rng_for(seed, "attn_probs"), inner=tp),
        causal=causal)
    y = _row_parallel(p["out"], ctx, dtype) if tp else nn.linear(
        p["out"], ctx, dtype)
    y = nn.dropout(y, _rate(cfg.hidden_dropout_prob, train, seed),
                   nn.rng_for(seed, "attn_out"))
    return nn.apply_layer_norm(p["out_ln"], y + x, cfg.layer_norm_eps)


def _row_parallel(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    """A row-parallel linear: this rank's input columns' product, summed
    over the model ranks, then the bias once."""
    y = dist.reduce_from_inner(nn.linear({"weight": p["weight"]}, x, dtype))
    return y + p["bias"].to(dtype)


def ffn(p: Params, x: torch.Tensor, cfg: TransformerConfig, *,
        train: bool = False, seed: Optional[int] = None,
        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if cfg.hidden_act != "gelu":
        raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}")
    if p["intermediate"]["weight"].shape[0] != cfg.intermediate_size:
        # a model rank's hidden units (tensor parallelism)
        h = nn.gelu(nn.linear(p["intermediate"], dist.copy_to_inner(x),
                              dtype))
        h = _row_parallel(p["output"], h, dtype)
    else:
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
    sub-seed ``layer{i}``.  Under :func:`set_remat` a training call with
    gradients on checkpoints each layer (non-reentrant, so the autograd
    graph, and with it every accumulation order, is the plain one; no
    global RNG state is kept, since no site reads it).  A stack sharded
    over pipeline stages runs through the pipeline."""
    remat = _REMAT and train and torch.is_grad_enabled()
    if any(layer is None for layer in p["layers"]):
        return pipeline.pipelined_encoder(
            p["layers"], x, cfg, kv_mask=kv_mask, seg=seg, train=train,
            seed=seed, dtype=dtype, remat=remat, layer_fn=encoder_layer)
    for i, layer in enumerate(p["layers"]):
        kw = dict(kv_mask=kv_mask, seg=seg, train=train,
                  seed=nn.rng_for(seed, f"layer{i}"), dtype=dtype)
        if remat:
            x = checkpoint(encoder_layer, layer, x, cfg, use_reentrant=False,
                           preserve_rng_state=False, **kw)
        else:
            x = encoder_layer(layer, x, cfg, **kw)
    return x


# ---------------------------------------------------------------------------
# LM head
# ---------------------------------------------------------------------------

def lm_head(p: Params, word_emb: torch.Tensor, x: torch.Tensor,
            cfg: TransformerConfig,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Tied LM head: dense -> GELU -> LN -> (.) @ word_emb^T + bias
    (``hero_tpu/models/transformer.py:234-247``).  The logits stay in the
    model dtype, as in the JAX package."""
    if cfg.hidden_act != "gelu":
        raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}")
    h = nn.gelu(nn.linear(p["dense"], x, dtype))
    h = nn.apply_layer_norm(p["ln"], h)
    return torch.matmul(h.to(dtype), word_emb.to(dtype).T) + p["bias"].to(
        dtype)


# ---------------------------------------------------------------------------
# TVC decoder, with a KV cache for generation
# ---------------------------------------------------------------------------

def decoder(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
            enc_mask: torch.Tensor, cfg: TransformerConfig, *,
            train: bool = False, seed: Optional[int] = None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Full-sequence decoder (training and teacher-forced scoring): per
    layer, causal self-attention, cross-attention over ``enc_out``
    (B, Lv, D) with ``enc_mask`` (B, Lv), then the FFN
    (``hero_tpu/models/transformer.py:267-299``).  Layer i draws from the
    sub-seed ``layer{i}`` and its three blocks from ``sa``, ``ca`` and
    ``f`` under it, as the JAX package keys them."""
    for i, layer in enumerate(p["layers"]):
        ls = nn.rng_for(seed, f"layer{i}")
        x = attention(layer["self_attention"], x, cfg, causal=True,
                      train=train, seed=nn.rng_for(ls, "sa"), dtype=dtype)
        x = attention(layer["cross_attention"], x, cfg, kv_mask=enc_mask,
                      kv=enc_out, train=train, seed=nn.rng_for(ls, "ca"),
                      dtype=dtype)
        x = ffn(layer["ffn"], x, cfg, train=train, seed=nn.rng_for(ls, "f"),
                dtype=dtype)
    return x


def init_decode_cache(cfg: TransformerConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.float32,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """Zero self-attention keys and values {"k", "v"}, each
    (layers, batch, H, max_len, d)."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_attention_heads, max_len,
             cfg.head_dim)
    return {n: torch.zeros(shape, dtype=dtype, device=device)
            for n in ("k", "v")}


def decoder_step(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 step: int, enc_out: torch.Tensor, enc_mask: torch.Tensor,
                 cfg: TransformerConfig,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One incremental decode step (``hero_tpu/models/transformer.py:
    302-344``): ``x`` (B, 1, D) is the embedding of the token at position
    ``step``; ``cache`` holds the keys and values of the positions before
    it.  Returns (output (B, 1, D), cache).

    The cache is updated IN PLACE (the JAX package returns a new one):
    position ``step`` of every layer is written, and the same dict is
    returned.  Self-attention attends over all T cache slots with the
    positions after ``step`` masked, as the JAX package does."""
    H = cfg.num_attention_heads
    B, T = x.shape[0], cache["k"].shape[3]
    self_mask = (torch.arange(T, device=x.device) <= step).float()
    self_mask = self_mask[None].expand(B, T)
    for i, layer in enumerate(p["layers"]):
        ap = layer["self_attention"]
        q, k_new, v_new = (split_heads(t, H) for t in nn.linear(
            ap["qkv"], x, dtype).split(x.shape[-1], dim=-1))
        cache["k"][i, :, :, step] = k_new[:, :, 0]
        cache["v"][i, :, :, step] = v_new[:, :, 0]
        ctx = multi_head_attention(q, cache["k"][i], cache["v"][i],
                                   self_mask)
        y = nn.linear(ap["out"], merge_heads(ctx), dtype)
        x = nn.apply_layer_norm(ap["out_ln"], y + x, cfg.layer_norm_eps)
        x = attention(layer["cross_attention"], x, cfg, kv_mask=enc_mask,
                      kv=enc_out, dtype=dtype)
        x = ffn(layer["ffn"], x, cfg, dtype=dtype)
    return x, cache
