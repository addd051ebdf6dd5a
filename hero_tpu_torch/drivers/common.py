"""Shared driver plumbing (counterpart of ``hero_tpu/drivers/common.py``):
bucket shapes and configs from the options, the video dataset over the
stores on disk, checkpoint loading, the VSM curriculum, and the train loop
on one device.

:func:`run_training` keeps the JAX loop's contract: batches arrive as
(task, numpy micro-batch) pairs; an accumulation window must hold one
task; the curriculum's extras join each step's batch; validation (and a
model checkpoint) every ``valid_steps``; ``restore.npz`` every
``save_steps``; on SIGTERM the step finishes, both are written and the
loop returns; the loss is logged every ``LOG_EVERY`` steps.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from hero_tpu_torch import resolve_device
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.data.loader import PrefetchLoader
from hero_tpu_torch.data.pretrain_tasks import mlm_row_cap
from hero_tpu_torch.data.store import SubTokStore, VideoFeatStore
from hero_tpu_torch.data.video import FixedShapes, VideoFeatSubTokDataset
from hero_tpu_torch.models import nn
from hero_tpu_torch.models import pretrain as pretrain_lib
from hero_tpu_torch.training.save import (checkpoint_vocab_padded,
                                          flatten_tree, load_params,
                                          unflatten_tree)
from hero_tpu_torch.utils.logger import NoOp, RunningMeter, ScalarWriter

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


def load_video_sub_dataset(opts, shapes: FixedShapes
                           ) -> VideoFeatSubTokDataset:
    """The sub and feature stores of ``opts.sub_txt_db`` /
    ``opts.vfeat_db`` as one video dataset."""
    sub = SubTokStore(opts.sub_txt_db, max_clip_len=opts.max_clip_len)
    vfeat = VideoFeatStore(opts.vfeat_db,
                           frame_interval=opts.vfeat_interval,
                           max_clip_len=opts.max_clip_len)
    return VideoFeatSubTokDataset(sub, vfeat, shapes,
                                  max_txt_len=opts.max_txt_len,
                                  sub_ctx_len=opts.sub_ctx_len,
                                  pack=getattr(opts, "pack_subs", False))


def merge_params(init: Dict, loaded: Dict, prefix: str = "") -> Dict:
    """Overlay ``loaded`` (a nested JAX-layout tree) on ``init``: a leaf of
    the same shape is taken in ``init``'s dtype, anything else keeps
    ``init``'s value; missing and unexpected keys are logged (reference
    load_pretrained_weight, modeling_utils.py:68-121)."""
    out = {}
    for k, v in init.items():
        path = f"{prefix}{k}"
        if k in loaded:
            if isinstance(v, dict):
                out[k] = merge_params(v, loaded[k], path + "/")
            else:
                lv = np.asarray(loaded[k])
                if lv.shape == v.shape:
                    out[k] = np.asarray(lv, dtype=v.dtype)
                else:
                    LOGGER.warning("shape mismatch at %s: ckpt %s vs %s - "
                                   "keeping init", path, lv.shape, v.shape)
                    out[k] = v
        else:
            LOGGER.info("missing from checkpoint (kept init): %s", path)
            out[k] = v
    for k in loaded:
        if k not in init and not k.startswith("__"):
            LOGGER.info("unexpected checkpoint key ignored: %s%s", prefix,
                        k)
    return out


def load_checkpoint_into(flat: Dict[str, np.ndarray], path: str,
                         info: Optional[Dict] = None
                         ) -> Dict[str, np.ndarray]:
    """``flat`` (JAX-layout init parameters) overlaid with the ``.npz``
    checkpoint at ``path`` (:func:`merge_params`).  With ``info``, the
    checkpoint's ``__vocab_padded__`` marker goes to
    ``info["vocab_padded"]`` when it has one.  The reference's ``.pt``
    checkpoints need its converter, not ported yet (ROADMAP A4)."""
    if path.endswith(".pt"):
        raise NotImplementedError(
            f"{path}: converting a reference .pt checkpoint waits for "
            "convert/torch_checkpoint.py (ROADMAP A4); convert it with the "
            "JAX package to an .npz first")
    padded = checkpoint_vocab_padded(path)
    if info is not None and padded is not None:
        info["vocab_padded"] = padded
    return flatten_tree(merge_params(unflatten_tree(flat), load_params(path)))


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


def _scalars(metrics: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float))
            or (isinstance(v, torch.Tensor) and v.ndim == 0)}


def run_training(opts, step_fn, state, batch_iter, *,
                 extras_fn: Optional[Callable] = None,
                 validate_fn: Optional[Callable] = None, saver=None,
                 restorer=None, device="cuda",
                 on_step: Optional[Callable] = None):
    """The train loop (``hero_tpu/drivers/common.py:220-402``, one
    device): optimizer steps from ``state.global_step`` up to
    ``opts.num_train_steps``.

    ``batch_iter`` yields (task, numpy micro-batch); every
    ``gradient_accumulation_steps`` of them, all of one task, are stacked
    on a leading micro-batch axis with ``extras_fn(step)`` broadcast
    beside them, and a background thread (:class:`PrefetchLoader`) moves
    the arrays to ``device`` through pinned memory while the previous
    step runs.  ``step_fn`` is a train step or {task: train step}
    (``training/step.make_train_step``); step i gets the integer seed
    ``rng_for(opts.seed + 1, f"step{i}")``, so a resumed run draws what
    the uninterrupted one drew.

    After each step: ``on_step(step, task, metrics)`` if given; every
    ``LOG_EVERY`` steps the loss to the log and the scalars to
    ``output_dir/log/scalars.jsonl``; every ``opts.valid_steps``
    ``validate_fn(state, step)`` and ``saver.save`` (a
    ``training/save.ModelSaver``); ``restorer.step`` (a
    ``TrainingRestorer``: ``restore.npz`` every ``opts.save_steps``).  At
    the end the model is saved and validated unless the last step was.
    On SIGTERM (handled while the loop runs, when it runs on the main
    thread) the step in flight finishes, ``restore.npz`` and the model
    are written, and the loop returns.  ``opts.profile_step`` = i traces
    step i + 1 with ``torch.profiler`` into ``output_dir/trace``.
    Returns the final state."""
    device = resolve_device(device)
    accum = max(getattr(opts, "gradient_accumulation_steps", 1), 1)
    global_step = int(state.global_step)
    output_dir = getattr(opts, "output_dir", None)

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

    preempted = threading.Event()
    installed, prev_handler = False, None
    if threading.current_thread() is threading.main_thread():
        def on_sigterm(signum, frame):
            LOGGER.warning("SIGTERM received: checkpointing and exiting "
                           "after the current step")
            preempted.set()
        prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
        installed = True
    writer = ScalarWriter(os.path.join(output_dir, "log")) if output_dir \
        else NoOp()
    steps = iter(PrefetchLoader(assembled_steps(), device=device,
                                host_keys=CURRICULUM_KEYS))
    try:
        return _train_loop(opts, step_fn, state, steps, global_step,
                           device, validate_fn, saver, restorer, on_step,
                           preempted, writer)
    finally:
        steps.close()                 # ends the prefetch thread
        writer.close()
        if installed:
            signal.signal(signal.SIGTERM, prev_handler
                          if prev_handler is not None else signal.SIG_DFL)


def _train_loop(opts, step_fn, state, steps, global_step, device,
                validate_fn, saver, restorer, on_step, preempted, writer):
    output_dir = getattr(opts, "output_dir", None)
    profile_at = getattr(opts, "profile_step", -1) if output_dir else -1
    meters: Dict[str, RunningMeter] = {}
    t0, n_ex = time.time(), 0
    last_validated = last_saved = -1
    if global_step >= opts.num_train_steps:
        steps = ()                    # a finished run resumed: no step
    for task, batch in steps:
        fn = step_fn[task] if isinstance(step_fn, dict) else step_fn
        seed = nn.rng_for(opts.seed + 1, f"step{global_step}")
        if profile_at == global_step:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                state, metrics = fn(state, batch, seed)
                float(metrics["loss"])          # wait for the device
            trace_dir = os.path.join(output_dir, "trace")
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(trace_dir, f"step_{global_step + 1}.json"))
        else:
            state, metrics = fn(state, batch, seed)
        global_step += 1
        # videos this step: the micro-batch axis, then the batch axis
        n_ex += int(np.prod(batch["sub_mask"].shape[:-1]))
        if on_step is not None:
            on_step(global_step, task, metrics)
        if global_step % LOG_EVERY == 0:
            scalars = _scalars(metrics)
            meter = meters.setdefault(f"loss/{task}",
                                      RunningMeter(f"loss/{task}"))
            meter(scalars["loss"])
            dt = max(time.time() - t0, 1e-6)
            LOGGER.info("step %d [%s]: loss=%.4f  %.1f ex/s", global_step,
                        task, scalars["loss"], n_ex / dt)
            writer.log_scalar_dict(scalars, step=global_step)
            writer.add_scalar(f"smooth_loss/{task}", meter.val, global_step)
            writer.add_scalar("perf/ex_per_s", n_ex / dt, global_step)
            t0, n_ex = time.time(), 0
        if (validate_fn is not None
                and global_step % opts.valid_steps == 0):
            validate_fn(state, global_step)
            last_validated = global_step
            if saver is not None:
                saver.save(state.params, global_step)
                last_saved = global_step
        if restorer is not None:
            restorer.step(state, opts.save_steps)
        if preempted.is_set():
            if restorer is not None:
                if restorer.saved_step != global_step:
                    restorer.save(state)
                restorer.flush()
            if saver is not None:
                if last_saved != global_step:
                    saver.save(state.params, global_step)
                saver.flush()
            LOGGER.warning("preempted at step %d: restore.npz written, "
                           "resume will continue from here", global_step)
            return state
        if global_step >= opts.num_train_steps:
            break
    if saver is not None and last_saved != global_step:
        saver.save(state.params, global_step)
    if saver is not None:
        saver.flush()
    if restorer is not None:
        restorer.flush()
    if validate_fn is not None and last_validated != global_step:
        validate_fn(state, global_step)
    LOGGER.info("training done at step %d", global_step)
    return state
