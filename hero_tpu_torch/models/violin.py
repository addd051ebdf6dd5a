"""HeroForViolin: binary video-statement entailment (counterpart of
``hero_tpu/models/violin.py``; reference ``model/violin.py:18-84``).

The fusion of VideoQA (the frames and the statement's tokens through the
temporal encoder), one attention-pooled vector, an MLP to one logit and
binary cross entropy.  Extras of the batch: ``q_input_ids`` /
``q_attn_masks`` (B, Lq) the statement's tokens, ``targets`` (B,) 0 or 1.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.models import nn
from hero_tpu_torch.models.pretrain import FlatInit, init_flat_v_encoder
from hero_tpu_torch.models.videoqa import _fuse_video_text
from hero_tpu_torch.parallel import dist

Params = Dict[str, Any]


def init_hero_for_violin(cfg: HeroConfig, seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """Random weights in the flat JAX layout of ``init_hero_for_violin``
    (``hero_tpu/models/violin.py:26-35``): the backbone's ``v_encoder``
    keys and ``head/violin_pool``, ``violin_pred_head``."""
    it = FlatInit(seed)
    init_flat_v_encoder(it, cfg)
    D = cfg.c_config.hidden_size
    it.linear("head/violin_pool", D, 1, bias=False)
    it.mlp_layer("head/violin_pred_head", D, 1)
    return it.flat


def get_modularized_video(head: Params, frame_emb: torch.Tensor,
                          frame_mask: torch.Tensor,
                          dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """(Nv, L, D) -> softmax-pooled over the frames (Nv, D), the softmax
    in fp32 (reference violin.py:30-47)."""
    scores = nn.linear(head["violin_pool"], frame_emb, dtype)   # (Nv, L, 1)
    scores = nn.mask_logits(scores, frame_mask[..., None])
    att = torch.softmax(scores.float(), dim=1).to(dtype)
    return torch.einsum("vlm,vld->vmd", att, frame_emb.to(dtype))[:, 0]


def forward_violin(params: Params, cfg: HeroConfig,
                   batch: Dict[str, torch.Tensor], *,
                   compute_loss: bool = True, train: bool = False,
                   seed: Optional[int] = None,
                   dtype: torch.dtype = torch.float32):
    """Reference violin.py:49-84 (``hero_tpu/models/violin.py:49-66``):
    the mean binary cross entropy with logits in fp32 (the stable form
    ``max(x, 0) - x t + log1p(exp(-|x|))``), or with
    ``compute_loss=False`` the logits (B, 1) in ``dtype``."""
    video_emb = _fuse_video_text(params, cfg, batch, batch["q_input_ids"],
                                 batch["q_attn_masks"], train=train,
                                 seed=seed, dtype=dtype)
    video_masks = batch["c_attn_masks"].float()
    pooled = get_modularized_video(params["head"], video_emb, video_masks,
                                   dtype)
    logits = nn.mlp_layer(params["head"]["violin_pred_head"], pooled, dtype)
    if not compute_loss:
        return logits
    targets = batch["targets"].reshape(-1).float()
    x = logits[..., 0].float()
    loss = (torch.clamp(x, min=0.0) - x * targets
            + torch.log1p(torch.exp(-x.abs())))
    if dist.dp_size() == 1:
        return loss.mean()
    # rule (a) of parallel/dist: the mean over the global batch's pairs
    return dist.global_mean(loss.sum(), loss.new_tensor(float(loss.numel())))
