"""HeroForTvc -- TV-show caption generation (counterpart of
``hero_tpu/models/tvc.py``).

- :func:`encode`: the backbone 'repr' forward, then each caption's clip
  segment by a two-level gather: ``cap_vidx`` (Ncap,) picks the video,
  ``seg_idx``/``seg_mask`` (Ncap, Lv) its frames.
- :func:`decode`: shared word embedding + decoder position embedding + LN
  -> the causal/cross decoder -> the tied LM head (teacher-forced logits).
- :func:`forward_tvc`: the training forward, encode then decode with
  dropout, and the label-smoothed loss (:func:`label_smoothing_loss`) or,
  at ``lsr`` 0, the cross entropy.
- :func:`greedy_decode` and :func:`beam_decode`: generation with the
  decoder's KV cache, one Python step per token.  Beam search orders its
  candidates as ``jax.lax.top_k`` does (value descending, ties to the
  lowest index) with a stable sort.

:func:`init_flat_tvc_params` draws the TVC tree with numpy in the flat JAX
layout that ``convert/from_jax.load_jax_tvc_params`` loads.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.models import model as backbone
from hero_tpu_torch.models import nn, transformer
from hero_tpu_torch.models.pretrain import FlatInit, init_flat_v_encoder

Params = Dict[str, Any]

LENGTH_PENALTY = 0.6   # beam_decode's default in the JAX package


def encode(params: Params, cfg: HeroConfig, batch: Dict[str, torch.Tensor],
           *, train: bool = False, seed: Optional[int] = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Clip-segment encoder outputs per caption: (Ncap, Lv, D)
    (``hero_tpu/models/tvc.py:49-57``).  The gather's backward adds each
    caption's gradient into its video's frames."""
    frame_emb = backbone.forward_repr(params["v_encoder"], cfg, batch,
                                      train=train,
                                      seed=nn.rng_for(seed, "repr"),
                                      dtype=dtype)                # (B, F, D)
    seg = frame_emb[batch["cap_vidx"].long()[:, None],
                    batch["seg_idx"].long()]                      # (N, Lv, D)
    return seg * batch["seg_mask"][..., None].to(seg.dtype)


def _embed_captions(params: Params, caption_ids: torch.Tensor,
                    pos_ids: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    word_emb = params["v_encoder"]["f_encoder"]["embeddings"]["word_emb"]
    tok = nn.embedding_lookup(word_emb, caption_ids, dtype)
    pos = nn.embedding_lookup(params["position_embeddings"], pos_ids, dtype)
    return nn.apply_layer_norm(params["emb_ln"], tok + pos)


def _logits(params: Params, cfg: HeroConfig, h: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    fenc = params["v_encoder"]["f_encoder"]
    return transformer.lm_head(fenc["lm_head"],
                               fenc["embeddings"]["word_emb"], h,
                               cfg.f_config, dtype=dtype)


def decode(params: Params, cfg: HeroConfig, enc_outputs: torch.Tensor,
           enc_masks: torch.Tensor, caption_ids: torch.Tensor, *,
           train: bool = False, seed: Optional[int] = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Teacher-forced decode -> vocab logits (Ncap, Lt, V) in ``dtype``
    (``hero_tpu/models/tvc.py:68-84``, positions 0..Lt-1)."""
    pos_ids = torch.arange(caption_ids.shape[1], device=caption_ids.device)
    h = _embed_captions(params, caption_ids, pos_ids, dtype)
    h = transformer.decoder(params["decoder"], h, enc_outputs,
                            enc_masks.float(), cfg.d_config, train=train,
                            seed=nn.rng_for(seed, "dec"), dtype=dtype)
    return _logits(params, cfg, h, dtype)


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         label_smoothing: float, ignore_index: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KL(q_smooth || softmax(logits)) summed over targets !=
    ``ignore_index``, and their count (``hero_tpu/models/tvc.py:87-115``):
    q puts 1 - ``label_smoothing`` on the target and ``label_smoothing`` /
    (V - 1) on every other entry of the (padded) vocabulary.  The logits
    stay in the model dtype; the sums are fp32 through
    :func:`~hero_tpu_torch.models.model.streamed_lse`, and q's entropy is a
    constant."""
    V = logits.shape[-1]
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0).long()
    eps = label_smoothing / (V - 1)
    conf = 1.0 - label_smoothing
    lse = backbone.streamed_lse(logits)
    tgt_logp = logits.gather(-1, safe[..., None])[..., 0].float() - lse
    sum_logp = logits.float().sum(-1) - V * lse
    cross = -(eps * (sum_logp - tgt_logp) + conf * tgt_logp)
    q_ent = ((V - 1) * eps * math.log(eps) if eps > 0 else 0.0) \
        + conf * math.log(conf)
    loss = torch.where(valid, cross + q_ent, 0.0)
    return loss.sum(), valid.sum().float()


def forward_tvc(params: Params, cfg: HeroConfig,
                batch: Dict[str, torch.Tensor], *, lsr: float = 0.1,
                compute_loss: bool = True, train: bool = False,
                seed: Optional[int] = None,
                dtype: torch.dtype = torch.float32):
    """The training forward (``hero_tpu/models/tvc.py:118-132``): the
    logits of ``cap_input_ids`` over each caption's clip, and with
    ``compute_loss`` (sum, count) of the loss against ``cap_tgt_ids``,
    label-smoothed at ``lsr`` > 0 and plain cross entropy at 0.
    ``train`` with a ``seed`` turns on every dropout site."""
    enc_out = encode(params, cfg, batch, train=train,
                     seed=nn.rng_for(seed, "enc"), dtype=dtype)
    logits = decode(params, cfg, enc_out, batch["seg_mask"],
                    batch["cap_input_ids"], train=train,
                    seed=nn.rng_for(seed, "dec"), dtype=dtype)
    if not compute_loss:
        return logits
    if lsr > 0:
        return label_smoothing_loss(logits, batch["cap_tgt_ids"], lsr)
    return backbone.masked_cross_entropy(logits, batch["cap_tgt_ids"])


def _step(params, cfg, tok, cache, t, enc_out, enc_mask, dtype):
    """Logits (N, V) of the token after ``tok`` (N,) at position ``t``."""
    pos = torch.tensor([t], device=tok.device)
    h = _embed_captions(params, tok[:, None], pos, dtype)
    h, cache = transformer.decoder_step(params["decoder"], h, cache, t,
                                        enc_out, enc_mask, cfg.d_config,
                                        dtype=dtype)
    return _logits(params, cfg, h, dtype)[:, 0]


def greedy_decode(params: Params, cfg: HeroConfig,
                  batch: Dict[str, torch.Tensor], *, max_step: int, bos: int,
                  eos: int, dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """KV-cached greedy decoding (``hero_tpu/models/tvc.py:139-170``):
    generated ids (Ncap, max_step) int32.  Every step runs, as the JAX
    scan does; the tokens after the first EOS are garbage and are cut on
    the host.  ``eos`` is unused, as in the JAX package."""
    del eos
    enc_out = encode(params, cfg, batch, dtype=dtype)
    enc_mask = batch["seg_mask"].float()
    N = enc_out.shape[0]
    cache = transformer.init_decode_cache(cfg.d_config, N, max_step, dtype,
                                          enc_out.device)
    tok = torch.full((N,), bos, dtype=torch.int32, device=enc_out.device)
    out = []
    for t in range(max_step):
        logits = _step(params, cfg, tok, cache, t, enc_out, enc_mask, dtype)
        # torch.argmax, like jnp.argmax, takes the first of equal maxima
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, ties to the
    lowest index, as ``jax.lax.top_k`` orders them."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def beam_decode(params: Params, cfg: HeroConfig,
                batch: Dict[str, torch.Tensor], *, max_step: int, bos: int,
                eos: int, beam: int = 4,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Length-normalised beam search with the KV cache
    (``hero_tpu/models/tvc.py:173-234``): the best ids (Ncap, max_step)
    int32.  Finished beams extend only with EOS at no cost; each step
    reorders every layer's cache along the batch axis (a copy).  Scores
    are divided by length ** ``LENGTH_PENALTY`` at the end."""
    enc_out = encode(params, cfg, batch, dtype=dtype)
    dev = enc_out.device
    enc_mask = batch["seg_mask"].float()
    N = enc_out.shape[0]
    enc_out_b = enc_out.repeat_interleave(beam, dim=0)
    enc_mask_b = enc_mask.repeat_interleave(beam, dim=0)
    cache = transformer.init_decode_cache(cfg.d_config, N * beam, max_step,
                                          dtype, dev)
    first = torch.full((beam,), -1e9, dtype=torch.float32, device=dev)
    first[0] = 0.0
    scores = first.repeat(N)                                    # (N*beam,)
    tok = torch.full((N * beam,), bos, dtype=torch.int32, device=dev)
    done = torch.zeros((N * beam,), dtype=torch.bool, device=dev)
    seqs = torch.zeros((N * beam, max_step), dtype=torch.int32, device=dev)
    base = torch.arange(N, device=dev)[:, None] * beam
    eos_only = None
    for t in range(max_step):
        logits = _step(params, cfg, tok, cache, t, enc_out_b, enc_mask_b,
                       dtype)
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
        if eos_only is None:
            eos_only = torch.full((V,), -1e9, dtype=torch.float32,
                                  device=dev)
            eos_only[eos] = 0.0
        logp = torch.where(done[:, None], eos_only[None, :], logp)
        cand = (scores[:, None] + logp).reshape(N, beam * V)
        top_scores, top_idx = _top_k(cand, beam)                # (N, beam)
        flat_src = (top_idx // V + base).reshape(-1)
        next_tok = (top_idx % V).to(torch.int32).reshape(-1)
        cache = {n: c.index_select(1, flat_src) for n, c in cache.items()}
        seqs = seqs[flat_src]
        seqs[:, t] = next_tok
        done = done[flat_src] | (next_tok == eos)
        tok, scores = next_tok, top_scores.reshape(-1)
    lengths = ((seqs == eos).int().cumsum(dim=1) == 0).sum(dim=1) + 1
    norm = scores / lengths.float() ** LENGTH_PENALTY
    best = torch.argmax(norm.reshape(N, beam), dim=1)
    return seqs.reshape(N, beam, max_step)[torch.arange(N, device=dev), best]


def init_flat_tvc_params(cfg: HeroConfig, seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """Random weights in the flat JAX layout of ``init_hero_for_tvc``
    (``hero_tpu/models/tvc.py:35-46``): the backbone's ``v_encoder`` keys
    (``pretrain.init_flat_v_encoder``), the decoder position embedding
    and its LayerNorm, and the stacked decoder layers (self-attention,
    cross-attention, FFN), with the JAX init's distributions."""
    if cfg.d_config is None:
        raise ValueError("TVC needs a d_config")
    d = cfg.d_config
    it = FlatInit(seed)
    init_flat_v_encoder(it, cfg)
    it.normal("position_embeddings", (d.max_position_embeddings,
                                      d.hidden_size), d.initializer_range)
    it.layer_norm("emb_ln", d.hidden_size)
    lead = (d.num_hidden_layers,)
    it.attention("decoder/layers/self_attention", d, lead)
    it.attention("decoder/layers/cross_attention", d, lead)
    it.linear("decoder/layers/ffn/intermediate", d.hidden_size,
              d.intermediate_size, d.initializer_range, lead=lead)
    it.linear("decoder/layers/ffn/output", d.intermediate_size,
              d.hidden_size, d.initializer_range, lead=lead)
    it.layer_norm("decoder/layers/ffn/ln", d.hidden_size, lead)
    return it.flat
