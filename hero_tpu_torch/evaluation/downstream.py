"""Downstream evaluation loops (counterpart of
``hero_tpu/evaluation/downstream.py``): VR only (the VCMR corpus
evaluation restricted to video retrieval), VideoQA's answer accuracy and
VIOLIN's entailment accuracy.  Host-side protocol of reference
``eval_vr.py:137-305``, ``eval_videoQA.py:120-173`` and
``eval_violin.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from hero_tpu_torch import resolve_device
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.evaluation.vcmr_eval import (VcmrEvalOpts,
                                                 batch_to_device,
                                                 validate_full_vcmr)
from hero_tpu_torch.models import nn
from hero_tpu_torch.models import videoqa as videoqa_lib
from hero_tpu_torch.models import violin as violin_lib
from hero_tpu_torch.models.pretrain import VsmConfig


def validate_full_vr(params, cfg: HeroConfig, vsm: VsmConfig,
                     opts: VcmrEvalOpts, video_batches, query_batches,
                     video_ids, video2idx_global, query_data,
                     dtype: torch.dtype = torch.bfloat16, device="cuda",
                     distributed: bool = False):
    """VR-only two-phase evaluation (reference eval_vr.py:137-305;
    ``hero_tpu/evaluation/downstream.py:24-32``): :func:`validate_full_vcmr`
    with ``full_eval_tasks=("VR",)``, on several ranks as it runs there.
    Returns (val_log, submission, metrics)."""
    opts = dataclasses.replace(opts, full_eval_tasks=("VR",))
    return validate_full_vcmr(params, cfg, vsm, opts, video_batches,
                              query_batches, video_ids, video2idx_global,
                              query_data, dtype=dtype, device=device,
                              distributed=distributed)


def _forward_batches(forward, params, batches, device):
    """(qids, host targets, host logits) of each batch: the host entries
    ``qids`` and ``targets_host`` (else ``targets``) popped, every other
    array but ``targets`` on ``device`` through ``forward``."""
    params = nn.tree_to(params, device)
    for batch in batches:
        batch = dict(batch)
        qids = batch.pop("qids")
        targets = np.asarray(batch.pop("targets_host",
                                       batch.get("targets")))
        tb = batch_to_device({k: v for k, v in batch.items()
                              if k != "targets"}, device)
        with torch.inference_mode():
            logits = forward(params, tb).cpu()
        yield qids, targets.reshape(-1), logits


def _log(n_correct: int, n_labeled: int, n_ex: int) -> Dict[str, float]:
    log: Dict[str, float] = {"n_ex": n_ex}
    if n_labeled:
        log["acc"] = n_correct / n_labeled
    return log


def validate_videoqa(params, cfg: HeroConfig,
                     batches: Iterable[Dict[str, Any]], *,
                     num_answers: int = 5,
                     dtype: torch.dtype = torch.bfloat16, device="cuda"
                     ) -> Tuple[Dict[str, float], Dict[Any, int],
                                Dict[Any, np.ndarray]]:
    """Answer argmax and accuracy (reference eval_videoQA.py:120-173;
    ``hero_tpu/evaluation/downstream.py:35-75``) on ``device`` in
    ``dtype``.  Batches carry the host list ``qids`` and numpy arrays;
    ``targets`` may hold -1 (an unlabelled split), and only rows with a
    target count toward ``acc``.  Returns (``{"n_ex", "acc"}``, qid ->
    answer, qid -> fp32 logits (A,))."""
    device = resolve_device(device)

    def forward(p, b):
        return videoqa_lib.forward_videoqa(p, cfg, b,
                                           num_answers=num_answers,
                                           compute_loss=False, dtype=dtype)

    results: Dict[Any, int] = {}
    logits_out: Dict[Any, np.ndarray] = {}
    n_correct = n_labeled = n_ex = 0
    for qids, targets, logits in _forward_batches(forward, params, batches,
                                                  device):
        logits = logits.numpy()
        answers = logits.argmax(-1)
        for i, qid in enumerate(qids):
            results[qid] = int(answers[i])
            logits_out[qid] = logits[i]
        labeled = targets >= 0
        n_correct += int(((answers == targets) & labeled).sum())
        n_labeled += int(labeled.sum())
        n_ex += len(qids)
    return _log(n_correct, n_labeled, n_ex), results, logits_out


def validate_violin(params, cfg: HeroConfig,
                    batches: Iterable[Dict[str, Any]], *,
                    dtype: torch.dtype = torch.bfloat16, device="cuda"
                    ) -> Tuple[Dict[str, float], Dict[Any, int]]:
    """Binary accuracy of sigmoid > 0.5 (reference eval_violin.py;
    ``hero_tpu/evaluation/downstream.py:78-103``) on ``device`` in
    ``dtype``: the sigmoid is taken on the host in the logits' dtype, as
    the JAX loop does, so a bf16 logit just above 0 can round to 0.5 and
    predict 0 there too.  Returns (``{"n_ex", "acc"}``, qid -> 0/1)."""
    device = resolve_device(device)

    def forward(p, b):
        return violin_lib.forward_violin(p, cfg, b, compute_loss=False,
                                         dtype=dtype)

    results: Dict[Any, int] = {}
    n_correct = n_labeled = n_ex = 0
    for qids, targets, logits in _forward_batches(forward, params, batches,
                                                  device):
        logits = logits.reshape(-1)
        pred = (1.0 / (1.0 + torch.exp(-logits)) > 0.5).long().numpy()
        for i, qid in enumerate(qids):
            results[qid] = int(pred[i])
        labeled = targets >= 0
        n_correct += int(((pred == targets) & labeled).sum())
        n_labeled += int(labeled.sum())
        n_ex += len(qids)
    return _log(n_correct, n_labeled, n_ex), results
