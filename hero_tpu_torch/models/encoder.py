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
from hero_tpu_torch.parallel import dist

Params = Dict[str, Any]


def _img_type_embedding(p: Params) -> torch.Tensor:
    """Type embedding for frame tokens: index 1 (or 0 if single-type)."""
    table = p["embeddings"]["type_emb"]
    return table[min(1, table.shape[0] - 1)]


def _emb_rate(cfg: TransformerConfig, train: bool) -> float:
    return cfg.hidden_dropout_prob if train else 0.0


def _fused_embeddings(p: Params, cfg: TransformerConfig, sub_input_ids,
                      txt_mask, v_feats, v_mask,
                      packed: Optional[Dict[str, torch.Tensor]] = None,
                      img_masks: Optional[torch.Tensor] = None, *,
                      train: bool = False, seed: Optional[int] = None,
                      dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Embed ``[frames ; text]`` rows.  Returns (hidden (N, Fs+Lt, D), the
    encoder's mask keyword: ``{"kv_mask": (N, Fs+Lt)}`` unpacked, or
    ``{"seg": (N, Fs+Lt) int32}`` when ``packed`` carries ``txt_seg`` /
    ``frame_seg`` / ``txt_pos`` / ``frame_pos``).  ``img_masks`` (N, Fs),
    1 = masked frame slot, adds the MFM mask embedding to the frames."""
    txt_emb = embed.sub_embeddings(
        p["embeddings"], sub_input_ids,
        position_ids=None if packed is None else packed["txt_pos"],
        dropout_rate=_emb_rate(cfg, train), seed=nn.rng_for(seed, "txt"),
        dtype=dtype)
    img_emb = embed.image_embeddings(
        p["img_embeddings"], v_feats, _img_type_embedding(p),
        img_pos_ids=None if packed is None else packed["frame_pos"],
        img_masks=img_masks, dropout_rate=_emb_rate(cfg, train),
        seed=nn.rng_for(seed, "img"),
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
                     txt_mask, v_feats, v_mask, img_masks=None, *,
                     packed=None, train: bool = False,
                     seed: Optional[int] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused encoding ('repr'): (N, Fs+Lt, D), frame outputs first."""
    hidden, mask = _fused_embeddings(p, cfg, sub_input_ids, txt_mask,
                                     v_feats, v_mask, packed, img_masks,
                                     train=train, seed=seed, dtype=dtype)
    return transformer.encoder(p["encoder"], hidden, cfg, train=train,
                               seed=nn.rng_for(seed, "enc"), dtype=dtype,
                               **mask)


def cross_modal_mlm(p: Params, cfg: TransformerConfig, sub_input_ids,
                    txt_mask, v_feats, v_mask, mask_pos, *, packed=None,
                    train: bool = False, seed: Optional[int] = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """MLM logits (N, M, vocab) at the masked text positions ``mask_pos``
    (N, M), indices into the text slots after the Fs frame slots: the
    tied LM head runs on the gathered rows only
    (``hero_tpu/models/encoder.py:131-152``).  Padded entries of
    ``mask_pos`` point anywhere; their labels are -1."""
    seq = cross_modal_repr(p, cfg, sub_input_ids, txt_mask, v_feats, v_mask,
                           packed=packed, train=train, seed=seed,
                           dtype=dtype)
    txt = seq[:, v_feats.shape[1]:]                          # (N, Lt, D)
    idx = mask_pos.long()[..., None].expand(-1, -1, txt.shape[-1])
    return transformer.lm_head(p["lm_head"], p["embeddings"]["word_emb"],
                               txt.gather(1, idx), cfg, dtype=dtype)


def cross_modal_txt(p: Params, cfg: TransformerConfig, input_ids,
                    mask=None, *, position_ids=None, seg=None,
                    train: bool = False, seed: Optional[int] = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Text-only encoding ('txt') for queries
    (``hero_tpu/models/encoder.py:117-128``): ``mask`` (N, L) validity, or
    ``seg`` (N, L) int32 segment ids of packed query rows (-1 = pad slot)
    with ``position_ids`` restarting per segment."""
    if (mask is None) == (seg is None):
        raise ValueError("pass exactly one of mask and seg")
    hidden = embed.sub_embeddings(
        p["embeddings"], input_ids, position_ids=position_ids,
        dropout_rate=_emb_rate(cfg, train), seed=nn.rng_for(seed, "txt"),
        dtype=dtype)
    kw = {"seg": seg} if seg is not None else {"kv_mask": mask.float()}
    return transformer.encoder(p["encoder"], hidden, cfg, train=train,
                               seed=nn.rng_for(seed, "enc"), dtype=dtype,
                               **kw)


def cross_modal_pooled(p: Params, seq_out: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The f-encoder's pooler over its output's first token: (N, D)
    (``hero_tpu/models/encoder.py:155-157``)."""
    return transformer.pooler(p["pooler"], seq_out, dtype)


def temporal_trm(p: Params, cfg: TransformerConfig, frame_feat, attn_mask,
                 *, position_ids=None, pool: bool = False,
                 train: bool = False, seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 offset: int = 0) -> torch.Tensor:
    """Clip-level temporal encoding (c-encoder,
    ``hero_tpu/models/encoder.py:173-188``): (B, F, D), or with ``pool``
    the c-encoder's pooler over the first frame, (B, D).  The frames sit
    at ``position_ids``, by default clip positions from ``offset``."""
    hidden = embed.frame_embeddings(
        p["embeddings"], frame_feat, position_ids,
        dropout_rate=_emb_rate(cfg, train), seed=nn.rng_for(seed, "emb"),
        dtype=dtype, offset=offset)
    out = transformer.encoder(p["encoder"], hidden, cfg,
                              kv_mask=attn_mask.float(), train=train,
                              seed=nn.rng_for(seed, "enc"), dtype=dtype)
    if pool:
        return transformer.pooler(p["pooler"], out, dtype)
    return out


def temporal_trm_seq_parallel(p: Params, cfg: TransformerConfig, frame_feat,
                              attn_mask, *, train: bool = False,
                              seed: Optional[int] = None,
                              dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """:func:`temporal_trm` over the grid's seq ranks
    (``hero_tpu/parallel/mesh.py:217-241``): seq rank r of S encodes
    frames [r F/S, (r+1) F/S) at their clip positions, its queries meeting
    every rank's keys and values (``dist.gather_kv``: #2/#3 at Lq = F/S,
    Lk = F), its dropout folding the seq rank; the outputs are gathered on
    the frame axis, the same (B, F, D) on every rank.  The c-encoder's
    parameters get their whole gradient on every rank
    (``dist.sync_grads``)."""
    n, r = dist.inner_world(), dist.inner_rank()
    frames = frame_feat.shape[1]
    if frames % n:
        raise ValueError(f"{frames} frames do not split over {n} seq ranks")
    p = dist.sync_grads(p)
    mine = dist.seq_slice(frame_feat, 1)
    with dist.seq_region():
        out = temporal_trm(p, cfg, mine, attn_mask, train=train, seed=seed,
                           dtype=dtype, offset=r * (frames // n))
    return dist.seq_gather(out, 1)


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


def query_feat_encoder_packed(p: Params, cfg: TransformerConfig, query_feat,
                              seg: torch.Tensor, position_ids: torch.Tensor,
                              max_segs: int,
                              dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Packed :func:`query_feat_encoder` (inference): several queries share
    a row behind the block-diagonal segment mask
    (``hero_tpu/models/encoder.py:222-249``).  query_feat (R, L, qdim),
    ``seg`` (R, L) int32 ids in [0, max_segs) or -1 for a pad slot,
    ``position_ids`` restarting per segment.  Returns (R, max_segs, D)
    per-segment modular-pooled vectors; an empty segment pools its row
    uniformly (finite, never gathered)."""
    h = nn.linear_layer(p["query_input_proj"], query_feat, relu=True,
                        dtype=dtype)
    h = embed.query_feat_embeddings(p["pos_embed"], h, position_ids,
                                    dtype=dtype)
    h = transformer.attention(p["attention"], h, cfg, seg=seg, dtype=dtype)
    scores = nn.linear(p["modular_vector"], h, dtype)[..., 0]     # (R, L)
    onehot = (seg[:, None, :] == torch.arange(
        max_segs, device=seg.device)[None, :, None])             # (R, S, L)
    slog = nn.mask_logits(scores[:, None, :], onehot)
    att = torch.softmax(slog.float(), dim=-1).to(dtype)
    return torch.einsum("rsl,rld->rsd", att, h)
