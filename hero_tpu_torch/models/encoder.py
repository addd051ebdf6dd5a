"""Cross-modal, temporal and query encoders (counterpart of
``hero_tpu/models/encoder.py``).

Every f-encoder row has the fixed layout ``[Fs frame slots ; Lt text
slots]`` with per-slot validity.  A packed row (``hero_tpu_torch/data``
sub packing) holds several subs behind a block-diagonal segment mask,
given as int32 segment ids (-1 = pad slot) with positions restarting per
segment.

Training threads ``train`` and an integer ``seed`` down to every dropout
site, with the JAX package's sub-seed tags.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from hero_tpu_torch.config.model_config import TransformerConfig
from hero_tpu_torch.const import PACK_MAX_SEGS
from hero_tpu_torch.models import embed, nn, transformer

Params = Dict[str, Any]


def _img_type_embedding(p: Params) -> torch.Tensor:
    """Type embedding for frame tokens: index 1 (or 0 if single-type)."""
    table = p["embeddings"]["type_emb"]
    return table[min(1, table.shape[0] - 1)]


def _emb_rate(cfg: TransformerConfig, train: bool) -> float:
    return cfg.hidden_dropout_prob if train else 0.0


def _fused_embeddings(p: Params, cfg: TransformerConfig, sub_input_ids,
                      txt_mask, v_feats, v_mask,
                      packed: Optional[Dict[str, torch.Tensor]] = None, *,
                      train: bool = False, seed: Optional[int] = None,
                      dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Embed ``[frames ; text]`` rows.  Returns (hidden (N, Fs+Lt, D), the
    encoder's mask keyword: ``{"kv_mask": (N, Fs+Lt)}`` unpacked, or
    ``{"seg": (N, Fs+Lt) int32}`` when ``packed`` carries ``txt_seg`` /
    ``frame_seg`` / ``txt_pos`` / ``frame_pos``)."""
    txt_emb = embed.sub_embeddings(
        p["embeddings"], sub_input_ids,
        position_ids=None if packed is None else packed["txt_pos"],
        dropout_rate=_emb_rate(cfg, train), seed=nn.rng_for(seed, "txt"),
        dtype=dtype)
    img_emb = embed.image_embeddings(
        p["img_embeddings"], v_feats, _img_type_embedding(p),
        img_pos_ids=None if packed is None else packed["frame_pos"],
        dropout_rate=_emb_rate(cfg, train), seed=nn.rng_for(seed, "img"),
        dtype=dtype)
    hidden = torch.cat([img_emb, txt_emb], dim=1)
    if packed is not None:
        seg = torch.cat([packed["frame_seg"], packed["txt_seg"]], dim=1)
        # the JAX package's PACK_MAX_SEGS-wide one-hot has an all-zero row
        # (a pad slot) for any id outside [0, PACK_MAX_SEGS)
        seg = torch.where(seg < PACK_MAX_SEGS, seg, -1)
        return hidden, {"seg": seg.to(torch.int32)}
    mask = torch.cat([v_mask, txt_mask], dim=1).float()
    return hidden, {"kv_mask": mask}


def cross_modal_repr(p: Params, cfg: TransformerConfig, sub_input_ids,
                     txt_mask, v_feats, v_mask, *, packed=None,
                     train: bool = False, seed: Optional[int] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused encoding ('repr'): (N, Fs+Lt, D), frame outputs first."""
    hidden, mask = _fused_embeddings(p, cfg, sub_input_ids, txt_mask,
                                     v_feats, v_mask, packed, train=train,
                                     seed=seed, dtype=dtype)
    return transformer.encoder(p["encoder"], hidden, cfg, train=train,
                               seed=nn.rng_for(seed, "enc"), dtype=dtype,
                               **mask)


def cross_modal_txt(p: Params, cfg: TransformerConfig, input_ids, mask, *,
                    train: bool = False, seed: Optional[int] = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Text-only encoding ('txt') for queries."""
    hidden = embed.sub_embeddings(
        p["embeddings"], input_ids, dropout_rate=_emb_rate(cfg, train),
        seed=nn.rng_for(seed, "txt"), dtype=dtype)
    return transformer.encoder(p["encoder"], hidden, cfg,
                               kv_mask=mask.float(), train=train,
                               seed=nn.rng_for(seed, "enc"), dtype=dtype)


def temporal_trm(p: Params, cfg: TransformerConfig, frame_feat, attn_mask,
                 *, train: bool = False, seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Clip-level temporal encoding (c-encoder)."""
    hidden = embed.frame_embeddings(
        p["embeddings"], frame_feat, dropout_rate=_emb_rate(cfg, train),
        seed=nn.rng_for(seed, "emb"), dtype=dtype)
    return transformer.encoder(p["encoder"], hidden, cfg,
                               kv_mask=attn_mask.float(), train=train,
                               seed=nn.rng_for(seed, "enc"), dtype=dtype)


def get_modularized_queries(p: Params, query: torch.Tensor, query_mask,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Softmax-weighted pooling over token positions: (N, L, D) -> (N, D)."""
    scores = nn.linear(p["modular_vector"], query, dtype)       # (N, L, 1)
    scores = nn.mask_logits(scores, query_mask[..., None])
    att = torch.softmax(scores.float(), dim=1).to(dtype)
    return torch.einsum("blm,bld->bmd", att, query)[:, 0]


def query_feat_encoder(p: Params, cfg: TransformerConfig, query_feat,
                       query_mask, *, train: bool = False,
                       seed: Optional[int] = None,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Project -> position-embed -> one self-attention block -> modular
    pooling: (N, L, qdim) -> (N, D)
    (``hero_tpu/models/encoder.py:252-269``)."""
    h = nn.linear_layer(p["query_input_proj"], query_feat, relu=True,
                        dropout_rate=_emb_rate(cfg, train),
                        seed=nn.rng_for(seed, "proj"), dtype=dtype)
    h = embed.query_feat_embeddings(
        p["pos_embed"], h, dropout_rate=_emb_rate(cfg, train),
        seed=nn.rng_for(seed, "pos"), dtype=dtype)
    h = transformer.attention(p["attention"], h, cfg,
                              kv_mask=query_mask.float(), train=train,
                              seed=nn.rng_for(seed, "attn"), dtype=dtype)
    return get_modularized_queries(p, h, query_mask, dtype)
