"""Moment-retrieval head (counterpart of ``hero_tpu/models/vcmr.py``)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.models import model as backbone

Params = Dict[str, Any]


def encode_video_corpus(params: Params, cfg: HeroConfig,
                        batch: Dict[str, torch.Tensor],
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Phase-1 corpus embedding: the backbone 'repr' forward on a video
    batch.  Returns (Nv, F, D)."""
    return backbone.forward_repr(params["v_encoder"], cfg, batch,
                                 dtype=dtype)
