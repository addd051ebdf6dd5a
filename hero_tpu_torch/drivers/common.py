"""Shared driver plumbing (counterpart of ``hero_tpu/drivers/common.py``):
bucket shapes and configs from the options, the VSM curriculum, and the
train loop on one device.

:func:`run_training` keeps the JAX loop's contract: batches arrive as
(task, numpy micro-batch) pairs; an accumulation window must hold one
task; the curriculum's extras join each step's batch; validation runs
every ``valid_steps``; the loss is logged every ``LOG_EVERY`` steps.
Checkpoint saving, the restore file and the SIGTERM checkpoint arrive with
``training/save.py``: their hooks (``saver``, ``restorer``) stay None.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from hero_tpu_torch import resolve_device
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.data.loader import PrefetchLoader
from hero_tpu_torch.data.pretrain_tasks import mlm_row_cap
from hero_tpu_torch.data.video import FixedShapes
from hero_tpu_torch.models import nn
from hero_tpu_torch.models import pretrain as pretrain_lib

LOGGER = logging.getLogger(__name__)

# the curriculum's per-step extras: they ride in the batch on the host
# (a loss pops them as Python values) and never go to the device
CURRICULUM_KEYS = ("use_hard_negative", "hard_pool_size", "hard_neg_weight",
                   "lw_st_ed")


def shapes_from_opts(opts) -> FixedShapes:
    """The bucket of the options (``hero_tpu/drivers/common.py:19-50``):
    packed (``pack_subs``) 8 rows of twice the text budget, else 32 rows;
    ``max_masked`` from :func:`mlm_row_cap` unless set."""
    pack = getattr(opts, "pack_subs", False)
    n_subs = getattr(opts, "bucket_n_subs", 0) or (8 if pack else 32)
    txt_len = getattr(opts, "bucket_txt_len", None)
    if not txt_len:
        txt_len = min(opts.max_txt_len * (opts.sub_ctx_len + 1) + 1, 120)
        if pack:
            txt_len = min(2 * txt_len, 184)
    max_masked = getattr(opts, "bucket_max_masked", 0)
    if not max_masked:
        max_masked = mlm_row_cap(getattr(opts, "mask_prob", 0.15), txt_len)
    return FixedShapes(
        n_subs=n_subs,
        txt_len=txt_len,
        frames_per_sub=getattr(opts, "bucket_frames_per_sub", 16),
        n_frames=opts.max_clip_len,
        n_queries=getattr(opts, "query_per_video", 5),
        query_len=getattr(opts, "bucket_query_len", 32),
        max_masked=max_masked,
        vfeat_dim=getattr(opts, "vfeat_dim", 4352),
    )


def vsm_config_from_opts(opts) -> pretrain_lib.VsmConfig:
    return pretrain_lib.VsmConfig(
        ranking_loss_type=getattr(opts, "ranking_loss_type", "hinge"),
        margin=getattr(opts, "margin", 0.1),
        lw_neg_ctx=getattr(opts, "lw_neg_ctx", 0.0),
        lw_neg_q=getattr(opts, "lw_neg_q", 0.0),
        lw_st_ed=getattr(opts, "lw_st_ed", 0.01),
        drop_svmr_prob=getattr(opts, "drop_svmr_prob", 0.0),
        use_all_neg=getattr(opts, "use_all_neg", True),
    )


class Curriculum:
    """Hard-negative and span-loss schedules (reference pretrain.py:
    277-287): at each step, hard-negative mining from the last start step
    passed (with its pool size and weight) and the span loss's weight
    from ``train_span_start_step``.  Values are numpy scalars, as in the
    JAX package."""

    def __init__(self, opts):
        self.starts = list(getattr(opts, "hard_negtiave_start_step", []))
        self.pools = list(getattr(opts, "hard_pool_size", []))
        self.weights = list(getattr(opts, "hard_neg_weights", []))
        self.span_start = getattr(opts, "train_span_start_step", 0)
        self.lw_st_ed = getattr(opts, "lw_st_ed", 0.01)

    def at(self, step: int) -> Dict[str, Any]:
        use_hard, pool, weight = False, 20, 10.0
        for s, p, w in zip(self.starts, self.pools, self.weights):
            if step >= s:
                use_hard, pool, weight = True, p, float(w)
        lw = self.lw_st_ed if step >= self.span_start else 0.0
        return {
            "use_hard_negative": np.asarray(use_hard),
            "hard_pool_size": np.asarray(pool),
            "hard_neg_weight": np.asarray(weight, np.float32),
            "lw_st_ed": np.asarray(lw, np.float32),
        }


def curriculum_kwargs(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Pop the curriculum's extras from a (micro-)batch as
    :func:`models.pretrain.forward_vsm`'s keyword arguments (absent keys
    are skipped)."""
    cur = {k: batch.pop(k) for k in CURRICULUM_KEYS if k in batch}
    conv = {"use_hard_negative": bool, "hard_pool_size": int,
            "hard_neg_weight": float, "lw_st_ed": float}
    return {k: conv[k](np.asarray(v)) for k, v in cur.items()}


def model_config_from_opts(opts) -> HeroConfig:
    cfg = HeroConfig.from_json(opts.model_config)
    return cfg.replace(max_clip_len=opts.max_clip_len,
                       vfeat_dim=getattr(opts, "vfeat_dim", cfg.vfeat_dim))


LOG_EVERY = 100           # optimizer steps between loss log lines


def run_training(opts, step_fn, state, batch_iter, *,
                 extras_fn: Optional[Callable] = None,
                 validate_fn: Optional[Callable] = None, saver=None,
                 restorer=None, device="cuda",
                 on_step: Optional[Callable] = None):
    """The train loop (``hero_tpu/drivers/common.py:220-402``, one
    device): up to ``opts.num_train_steps`` optimizer steps.

    ``batch_iter`` yields (task, numpy micro-batch); every
    ``gradient_accumulation_steps`` of them, all of one task, are stacked
    on a leading micro-batch axis with ``extras_fn(step)`` broadcast
    beside them, and a background thread (:class:`PrefetchLoader`) moves
    the arrays to ``device`` through pinned memory while the previous
    step runs.  ``step_fn`` is a train step or {task: train step}
    (``training/step.make_train_step``); step i gets the integer seed
    ``rng_for(opts.seed + 1, f"step{i}")``.  ``validate_fn(state,
    step)`` runs every ``opts.valid_steps`` steps and after the last;
    ``on_step(step, task, metrics)``, if given, after every step.
    ``saver`` and ``restorer`` wait for ``training/save.py`` and must be
    None.  Returns the final state."""
    if saver is not None or restorer is not None:
        raise NotImplementedError(
            "checkpoint saving and restoring wait for training/save.py "
            "(ROADMAP A)")
    device = resolve_device(device)
    accum = max(getattr(opts, "gradient_accumulation_steps", 1), 1)
    global_step = int(state.global_step)

    def assembled_steps():
        """One item per optimizer step: the micro-batch window stacked,
        with the curriculum's extras."""
        micro = []
        step_ord = global_step
        for task, batch in batch_iter:
            micro.append((task, batch))
            if len(micro) < accum:
                continue
            task0 = micro[0][0]
            if any(t != task0 for t, _ in micro):
                raise ValueError("accumulation window must hold a single "
                                 f"task: {[t for t, _ in micro]}")
            mbs = [b for _, b in micro]
            micro = []
            extras = extras_fn(step_ord) if extras_fn else {}
            if accum > 1:
                stacked = {k: np.stack([m[k] for m in mbs])
                           for k in mbs[0]}
                stacked.update({
                    k: np.broadcast_to(np.asarray(v),
                                       (accum,) + np.shape(v))
                    for k, v in extras.items()})
            else:
                stacked = dict(mbs[0])
                stacked.update(extras)
            yield task0, stacked
            step_ord += 1

    loader = PrefetchLoader(assembled_steps(), device=device,
                            host_keys=CURRICULUM_KEYS)
    t0, n_ex = time.time(), 0
    last_validated = -1
    for task, batch in loader:
        fn = step_fn[task] if isinstance(step_fn, dict) else step_fn
        state, metrics = fn(state, batch,
                            nn.rng_for(opts.seed + 1, f"step{global_step}"))
        global_step += 1
        # videos this step: the micro-batch axis, then the batch axis
        n_ex += int(np.prod(batch["sub_mask"].shape[:-1]))
        if on_step is not None:
            on_step(global_step, task, metrics)
        if global_step % LOG_EVERY == 0:
            loss = float(metrics["loss"])
            dt = max(time.time() - t0, 1e-6)
            LOGGER.info("step %d [%s]: loss=%.4f  %.1f ex/s", global_step,
                        task, loss, n_ex / dt)
            t0, n_ex = time.time(), 0
        if (validate_fn is not None
                and global_step % opts.valid_steps == 0):
            validate_fn(state, global_step)
            last_validated = global_step
        if global_step >= opts.num_train_steps:
            break
    if validate_fn is not None and last_validated != global_step:
        validate_fn(state, global_step)
    LOGGER.info("training done at step %d", global_step)
    return state

