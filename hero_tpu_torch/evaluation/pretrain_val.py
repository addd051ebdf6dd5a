"""Per-task pretraining validators (counterpart of
``hero_tpu/evaluation/pretrain_val.py``): VSM losses, MLM accuracy and
loss, MFM-NCE accuracy and loss, MFFR feature error, FOM accuracy and
loss, with examples (tokens, features, frames) per second.

Each runs its forward under ``torch.no_grad()`` on ``device`` and reduces
on the device, reading back scalars only (the JAX validators copy the
logits to the host); log-softmaxes are fp32.  On several ranks every rank
validates the identical batch stream, as the JAX package does, and a
cross-rank checksum of each batch fails loudly when a rank's stream
drifted.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterable

import torch

from hero_tpu_torch import resolve_device
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.data.loader import to_device
from hero_tpu_torch.models import model as backbone
from hero_tpu_torch.models import nn
from hero_tpu_torch.models import pretrain as pretrain_lib
from hero_tpu_torch.models.pretrain import VsmConfig
from hero_tpu_torch.parallel import dist

LOGGER = logging.getLogger(__name__)


def validate_pretrain(params, cfg: HeroConfig, vsm: VsmConfig,
                      val_loaders: Dict[str, Iterable],
                      dtype: torch.dtype = torch.bfloat16,
                      mask_prob: float = 0.15,
                      device="cuda") -> Dict[str, float]:
    """Every task's validator over its batches (``val_loaders``: {task
    name: iterable of numpy batches}); a flat {valid_<task>/<metric>:
    value} log."""
    device = resolve_device(device)
    params = nn.tree_to(params, device)
    out: Dict[str, float] = {}
    for task, loader in val_loaders.items():
        LOGGER.info("validate on %s task", task)
        if dist.world_size() > 1:
            loader = _checked(loader, task)
        kw = dict(dtype=dtype, device=device)
        if task.startswith("mlm"):
            log = validate_mlm(params, cfg, loader, **kw)
        elif task.startswith("mffr"):
            log = validate_mfm(params, cfg, loader, "regression",
                               mask_prob=mask_prob, **kw)
        elif task.startswith("mfm"):
            log = validate_mfm(params, cfg, loader, "nce",
                               mask_prob=mask_prob, **kw)
        elif task.startswith("fom"):
            log = validate_fom(params, cfg, loader, **kw)
        elif task.startswith("vsm"):
            log = validate_vsm(params, cfg, vsm, loader, **kw)
        else:
            raise ValueError(task)
        out.update({f"valid_{task}/{k}": v for k, v in log.items()})
    return out


def _checked(loader: Iterable, task: str):
    """``loader``'s batches, each first checked equal on every rank
    (``hero_tpu/evaluation/pretrain_val.py:41-54``)."""
    for batch in loader:
        dist.assert_same_batch(batch, f"{task} validation batch")
        yield batch


@torch.no_grad()
def validate_vsm(params, cfg, vsm, loader, dtype=torch.bfloat16,
                 device="cuda"):
    t0 = time.time()
    tot = {"st_ed": 0.0, "neg_ctx": 0.0, "neg_q": 0.0}
    n_batches = n_ex = 0
    for batch in loader:
        a, b, c = pretrain_lib.forward_vsm(params, cfg, vsm,
                                           to_device(batch, device),
                                           dtype=dtype)
        tot["st_ed"] += float(a)
        tot["neg_ctx"] += float(b)
        tot["neg_q"] += float(c)
        n_batches += 1
        n_ex += int(batch["q_mask"].sum())
    n = max(n_batches, 1)
    loss = sum(tot.values()) / n
    log = {"loss_overall": loss,
           "loss_st_ed": tot["st_ed"] / n / max(vsm.lw_st_ed, 1e-8),
           "loss_neg_ctx": tot["neg_ctx"] / n / max(vsm.lw_neg_ctx, 1e-8),
           "loss_neg_q": tot["neg_q"] / n / max(vsm.lw_neg_q, 1e-8),
           "ex_per_s": n_ex / max(time.time() - t0, 1e-6)}
    LOGGER.info("vsm val loss: %.3f", loss)
    return log


def _nll_and_correct(logits, labels):
    """(sum of the fp32 NLL, number of argmax hits, label count) over the
    labels >= 0."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    hits = (logits.argmax(-1) == labels) & valid
    return (float((nll * valid).sum()), int(hits.sum()),
            int(valid.sum()))


@torch.no_grad()
def validate_mlm(params, cfg, loader, dtype=torch.bfloat16, device="cuda"):
    t0 = time.time()
    loss_sum, n_correct, n_word = 0.0, 0, 0
    for batch in loader:
        b = to_device(batch, device)
        logits = backbone.forward_mlm(params["v_encoder"], cfg, b,
                                      compute_loss=False, dtype=dtype)
        labels = b["mlm_labels"].reshape(logits.shape[0], -1)
        s, c, n = _nll_and_correct(logits, labels)
        loss_sum += s
        n_correct += c
        n_word += n
    dt = max(time.time() - t0, 1e-6)
    acc = n_correct / max(n_word, 1)
    LOGGER.info("mlm val acc: %.4f", acc)
    return {"loss": loss_sum / max(n_word, 1), "acc": acc,
            "tok_per_s": n_word / dt}


@torch.no_grad()
def validate_mfm(params, cfg, loader, loss_kind, dtype=torch.bfloat16,
                 mask_prob: float = 0.15, device="cuda"):
    t0 = time.time()
    loss_sum, n_feat, n_correct = 0.0, 0, 0
    for batch in loader:
        b = to_device(batch, device)
        s, n = backbone.forward_mfm(params["v_encoder"], cfg, b,
                                    loss=loss_kind, dtype=dtype,
                                    mask_prob=mask_prob)
        loss_sum += float(s)
        n_feat += int(n)
        if loss_kind == "nce":
            pred = backbone.forward_mfm(params["v_encoder"], cfg, b,
                                        loss="nce", compute_loss=False,
                                        dtype=dtype)     # (B, F, vdim)
            # NCE accuracy: each masked prediction's closest target among
            # the valid frames (zero pad rows would win when every real
            # similarity is negative) is its own
            mask = b["c_v_masks"] > 0
            valid = b["c_attn_masks"].reshape(-1) > 0
            tgt = b["c_v_feats"].float().reshape(-1, pred.shape[-1])
            scores = pred.float()[mask] @ tgt.T
            scores[:, ~valid] = -torch.inf
            own = torch.nonzero(mask.reshape(-1))[:, 0]
            n_correct += int((scores.argmax(1) == own).sum())
    dt = max(time.time() - t0, 1e-6)
    log = {"loss": loss_sum / max(n_feat, 1), "feat_per_s": n_feat / dt}
    if loss_kind == "nce":
        log["acc"] = n_correct / max(n_feat, 1)
    LOGGER.info("%s val loss: %.4f", loss_kind, log["loss"])
    return log


@torch.no_grad()
def validate_fom(params, cfg, loader, dtype=torch.bfloat16, device="cuda"):
    t0 = time.time()
    loss_sum, n_correct, n_frame = 0.0, 0, 0
    for batch in loader:
        b = to_device(batch, device)
        logits = backbone.forward_fom(params["v_encoder"], cfg, b,
                                      compute_loss=False, dtype=dtype)
        targets = b["fom_targets"]
        valid = targets >= 0
        n_correct += int(((logits.argmax(-1) == targets) & valid).sum())
        n_frame += int(valid.sum())
        s, _ = backbone.masked_cross_entropy(logits, targets)
        loss_sum += float(s)
    acc = n_correct / max(n_frame, 1)
    LOGGER.info("fom val acc: %.4f", acc)
    return {"loss": loss_sum / max(n_frame, 1), "acc": acc,
            "frame_per_s": n_frame / max(time.time() - t0, 1e-6)}
