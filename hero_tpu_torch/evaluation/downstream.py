"""Downstream evaluation loops (counterpart of
``hero_tpu/evaluation/downstream.py``): VR only, the VCMR corpus
evaluation restricted to video retrieval.  The VideoQA and VIOLIN loops
wait for ROADMAP A6."""

from __future__ import annotations

import dataclasses

import torch

from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.evaluation.vcmr_eval import (VcmrEvalOpts,
                                                 validate_full_vcmr)
from hero_tpu_torch.models.pretrain import VsmConfig


def validate_full_vr(params, cfg: HeroConfig, vsm: VsmConfig,
                     opts: VcmrEvalOpts, video_batches, query_batches,
                     video_ids, video2idx_global, query_data,
                     dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """VR-only two-phase evaluation (reference eval_vr.py:137-305;
    ``hero_tpu/evaluation/downstream.py:24-32``): :func:`validate_full_vcmr`
    with ``full_eval_tasks=("VR",)``.  Returns (val_log, submission,
    metrics)."""
    opts = dataclasses.replace(opts, full_eval_tasks=("VR",))
    return validate_full_vcmr(params, cfg, vsm, opts, video_batches,
                              query_batches, video_ids, video2idx_global,
                              query_data, dtype=dtype, device=device)
