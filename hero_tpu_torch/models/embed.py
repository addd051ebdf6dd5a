"""Input embeddings (counterpart of ``hero_tpu/models/embed.py``).

- :func:`sub_embeddings`: word + position + token-type embeddings for
  subtitle and query text.  Default positions are ``arange`` clamped at 511
  (the reference collates); the default type id is 1.
- :func:`project_image_features` / :func:`image_embeddings`: 4352-d frame
  features -> LN -> linear -> + position + type -> LN.
- :func:`frame_embeddings`: clip-level positions for the temporal encoder.
- :func:`query_feat_embeddings`: positions over projected query features.

Each embedding ends in dropout (``dropout_rate``, drawn from ``seed``; none
when ``seed`` is None), as the JAX package's four embedders do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from hero_tpu_torch.models import nn

Params = Dict[str, Any]

MAX_POS_ID = 511     # collate clamp (reference data/data.py:429)


def _arange_like(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=x.device)


def sub_embeddings(p: Params, input_ids: torch.Tensor,
                   position_ids: Optional[torch.Tensor] = None, *,
                   dropout_rate: float = 0.0, seed: Optional[int] = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if position_ids is None:
        position_ids = _arange_like(input_ids, input_ids.shape[-1]).clamp(
            max=MAX_POS_ID).expand(input_ids.shape)
    words = nn.embedding_lookup(p["word_emb"], input_ids, dtype)
    pos = nn.embedding_lookup(p["pos_emb"], position_ids, dtype)
    # reference default: type id 1 for every token (embed.py:47-50)
    type_idx = min(1, p["type_emb"].shape[0] - 1)
    types = p["type_emb"][type_idx].to(dtype)
    x = nn.apply_layer_norm(p["ln"], words + pos + types)
    return nn.dropout(x, dropout_rate, nn.rng_for(seed, "sub_emb"))


def project_image_features(p: Params, img_feat: torch.Tensor, *,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """img_ln + img_linear: (..., L, img_dim) -> (..., L, D)."""
    h = nn.apply_layer_norm(p["img_ln"], img_feat.to(dtype))
    return nn.linear(p["img_linear"], h, dtype)


def image_embeddings(p: Params, img_feat: torch.Tensor,
                     type_embedding: torch.Tensor,
                     img_pos_ids: Optional[torch.Tensor] = None, *,
                     dropout_rate: float = 0.0, seed: Optional[int] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """img_feat (..., L, img_dim) -> (..., L, D)."""
    h = project_image_features(p, img_feat, dtype=dtype)
    if img_pos_ids is None:
        img_pos_ids = _arange_like(img_feat, img_feat.shape[-2])
    pos = nn.embedding_lookup(p["pos_emb"], img_pos_ids, dtype)
    x = nn.apply_layer_norm(p["ln"], h + pos + type_embedding.to(dtype))
    return nn.dropout(x, dropout_rate, nn.rng_for(seed, "img_emb"))


def frame_embeddings(p: Params, frame_feat: torch.Tensor, *,
                     dropout_rate: float = 0.0, seed: Optional[int] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """frame_feat (B, L, D), already in hidden space."""
    pos = nn.embedding_lookup(
        p["pos_emb"], _arange_like(frame_feat, frame_feat.shape[1]), dtype)
    x = nn.apply_layer_norm(p["ln"], frame_feat.to(dtype) + pos)
    return nn.dropout(x, dropout_rate, nn.rng_for(seed, "frame_emb"))


def query_feat_embeddings(p: Params, input_feat: torch.Tensor, *,
                          dropout_rate: float = 0.0,
                          seed: Optional[int] = None,
                          dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    pos = nn.embedding_lookup(
        p["pos_emb"], _arange_like(input_feat, input_feat.shape[1]), dtype)
    x = nn.apply_layer_norm(p["ln"], input_feat.to(dtype) + pos)
    return nn.dropout(x, dropout_rate, nn.rng_for(seed, "query_emb"))
