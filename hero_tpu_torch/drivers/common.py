"""Shared driver plumbing (counterpart of ``hero_tpu/drivers/common.py``):
bucket shapes and configs from the options (the corpus evaluation's too),
the video dataset over the stores on disk, checkpoint loading, the VSM
curriculum, and the train loop, on one device or as one rank of a
data-parallel world (``parallel/dist``).

:func:`run_training` keeps the JAX loop's contract: batches arrive as
(task, numpy micro-batch) pairs; an accumulation window must hold one
task; the curriculum's extras join each step's batch; validation (and a
model checkpoint) every ``valid_steps``; ``restore.npz`` every
``save_steps``; on SIGTERM the step finishes, both are written and the
loop returns; the loss is logged every ``LOG_EVERY`` steps.  On W ranks
every rank builds the same global batches and trains on its rows; only
the primary writes files.
"""

from __future__ import annotations

import dataclasses
import json
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
from hero_tpu_torch.convert.torch_checkpoint import load_and_convert
from hero_tpu_torch.data import load_data
from hero_tpu_torch.data.loader import PrefetchLoader
from hero_tpu_torch.data.pretrain_tasks import mlm_row_cap
from hero_tpu_torch.data.video import (FixedShapes, VideoFeatSubTokDataset,
                                      VideoOnlyDataset)
from hero_tpu_torch.models import nn
from hero_tpu_torch.models import pretrain as pretrain_lib
from hero_tpu_torch.parallel import dist, pipeline
from hero_tpu_torch.training import save as save_lib
from hero_tpu_torch.training.optim import AdamWConfig
from hero_tpu_torch.training.save import (flatten_tree, load_params,
                                          unflatten_tree)
from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                          gather_state, shard_state)
from hero_tpu_torch.utils.logger import LOGGER as PACKAGE_LOGGER
from hero_tpu_torch.utils.logger import (NoOp, RunningMeter, ScalarWriter,
                                         add_log_to_file)
from hero_tpu_torch.utils.misc import set_random_seed

LOGGER = logging.getLogger(__name__)

# the curriculum's per-step extras: they ride in the batch on the host
# (a loss pops them as Python values) and never go to the device
CURRICULUM_KEYS = ("use_hard_negative", "hard_pool_size", "hard_neg_weight",
                   "lw_st_ed")
# batch entries that index another entry's rows ({key: the indexed key}):
# TVC's caption rows name their video; a rank's rows are rebased to its
# own videos (dist.shard_rows)
ROW_INDEX_KEYS = {"cap_vidx": "c_attn_masks"}


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
    ``opts.vfeat_db`` as one video dataset (``data/load_data``)."""
    return load_data.load_video_sub_dataset(
        opts.vfeat_db, opts.sub_txt_db, shapes,
        vfeat_interval=opts.vfeat_interval, max_clip_len=opts.max_clip_len,
        max_txt_len=opts.max_txt_len, sub_ctx_len=opts.sub_ctx_len,
        pack=getattr(opts, "pack_subs", False))


def load_video_only_dataset(opts, shapes: FixedShapes) -> VideoOnlyDataset:
    """A video-only corpus (``hero_tpu/drivers/common.py:64-95``; reference
    load_video_only_dataset, load_data.py:47-54): no sub store, one [CLS]
    pseudo-sub spanning the clip, so the bucket becomes one row of
    max(frames_per_sub, n_frames) frames and at least 8 text slots.  The
    special ids come from the query store's ``meta.json``
    (``train_query_txt_db``, else ``val_query_txt_db``), RoBERTa's when it
    has none."""
    meta_db = (getattr(opts, "train_query_txt_db", None)
               or getattr(opts, "val_query_txt_db", None))
    return load_data.load_video_only_dataset(
        opts.vfeat_db, meta_db, shapes.replace(txt_len=max(shapes.txt_len,
                                                           8)),
        vfeat_interval=opts.vfeat_interval, max_clip_len=opts.max_clip_len)


def is_video_only_task(task: str) -> bool:
    return task.endswith("video_only")


def load_task_video_dataset(opts, shapes: FixedShapes):
    """The video dataset of ``opts.task``: :func:`load_video_only_dataset`
    for a ``*_video_only`` task, else :func:`load_video_sub_dataset`."""
    if is_video_only_task(getattr(opts, "task", "tvr")):
        return load_video_only_dataset(opts, shapes)
    return load_video_sub_dataset(opts, shapes)


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
                         vocab_size: int = 50272,
                         info: Optional[Dict] = None
                         ) -> Dict[str, np.ndarray]:
    """``flat`` (JAX-layout init parameters) overlaid with the checkpoint
    at ``path`` (:func:`merge_params`; ``hero_tpu/drivers/common.py:
    130-149``): a reference ``.pt`` through the converter
    (``convert/torch_checkpoint.load_and_convert``, its word rows padded
    with zeros to ``vocab_size``), else a JAX-layout ``.npz``.  With
    ``info``, the checkpoint's vocab-pad decision goes to
    ``info["vocab_padded"]`` when it has one."""
    if path.endswith(".pt"):
        loaded = load_and_convert(path, vocab_size=vocab_size)
        padded = loaded.pop("__vocab_padded__", None)
    else:
        loaded = load_params(path)
        padded = save_lib.checkpoint_vocab_padded(path)
    if info is not None and padded is not None:
        info["vocab_padded"] = bool(padded)
    return flatten_tree(merge_params(unflatten_tree(flat), loaded))


def checkpoint_vocab_padded(path: str, vocab_size: int = 50272
                            ) -> Optional[bool]:
    """The vocab-pad decision :func:`load_checkpoint_into` records for
    ``path``, for a resumed run, which overlays no checkpoint: whether a
    ``.pt``'s word rows were fewer than ``vocab_size``, an ``.npz``'s
    ``__vocab_padded__`` marker (None without one)."""
    if path.endswith(".pt"):
        return load_and_convert(path, vocab_size).get("__vocab_padded__")
    return save_lib.checkpoint_vocab_padded(path)


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


def train_spec(opts: Dict[str, Any]) -> TrainSpec:
    """A finetune step's hyper-parameters from the run's options (a dict:
    ``vars(opts)``), ``lr_mul`` on every parameter outside ``v_encoder``
    (``hero_tpu/drivers/train_tvc.py:78-88``, ``train_vcmr.py:139-149``)."""
    return TrainSpec(
        learning_rate=opts["learning_rate"],
        warmup_steps=opts["warmup_steps"],
        num_train_steps=opts["num_train_steps"],
        grad_norm=opts["grad_norm"],
        lr_schedule=opts.get("lr_sched", "warmup_linear"),
        adamw=AdamWConfig(beta1=opts["betas"][0], beta2=opts["betas"][1],
                          weight_decay=opts["weight_decay"],
                          lr_mul=opts.get("lr_mul", 1.0)))


def model_config_from_opts(opts) -> HeroConfig:
    cfg = HeroConfig.from_json(opts.model_config)
    return cfg.replace(max_clip_len=opts.max_clip_len,
                       vfeat_dim=getattr(opts, "vfeat_dim", cfg.vfeat_dim))


def eval_opts_from(opts):
    """The corpus evaluation's options from a run's options
    (``hero_tpu/drivers/common.py:197-214``), with the two query-packing
    options when the options carry them."""
    from hero_tpu_torch.evaluation.vcmr_eval import VcmrEvalOpts
    return VcmrEvalOpts(
        q2c_alpha=getattr(opts, "q2c_alpha", 20.0),
        max_vcmr_video=getattr(opts, "max_vcmr_video", 100),
        min_pred_l=getattr(opts, "min_pred_l", 2),
        max_pred_l=getattr(opts, "max_pred_l", 16),
        max_before_nms=getattr(opts, "max_before_nms", 200),
        max_after_nms=getattr(opts, "max_after_nms", 100),
        nms_thd=getattr(opts, "nms_thd", -1.0),
        vfeat_interval=opts.vfeat_interval,
        max_clip_len=opts.max_clip_len,
        full_eval_tasks=tuple(getattr(opts, "full_eval_tasks",
                                      ("VCMR", "SVMR", "VR"))),
        eval_with_query_type=getattr(opts, "eval_with_query_type", True),
        corpus_chunk_videos=getattr(opts, "corpus_chunk_videos", 0),
        pack_queries=getattr(opts, "pack_queries", False),
        query_pack_segs=getattr(opts, "query_pack_segs", 4),
        query_pack_rows_per_call=getattr(opts, "query_pack_rows_per_call",
                                         64),
    )


def write_checkpoint_records(output_dir: str, saver, restorer) -> None:
    """``output_dir/log/checkpoints.json``: the restore's ms and each
    model and restore save's record (``training/save.py``)."""
    with open(os.path.join(output_dir, "log", "checkpoints.json"), "w") as f:
        json.dump({"restore_ms": restorer.restore_ms,
                   "model": saver.records,
                   "restore": restorer.records}, f, indent=1)


@dataclasses.dataclass(frozen=True)
class Finetune:
    """What sets one finetuning program apart, made by its ``prepare(cfg,
    device)`` once the stores are open: ``init(info)``, the flat JAX-layout
    parameters a fresh run starts from (the checkpoint's vocab-pad
    decision to ``info["vocab_padded"]``); ``load(flat, device=)``, their
    bridge to the device; ``step_fn`` as :func:`run_training`'s;
    ``batches(taken)``, the (task, numpy micro-batch) iterator past the
    ``taken`` micro-batches that a resumed run's steps took;
    ``validate(state, step)``; and ``extras_fn`` as
    :func:`run_training`'s."""
    init: Callable
    load: Callable
    step_fn: Callable
    batches: Callable
    validate: Callable
    extras_fn: Optional[Callable] = None


def start_run(opts, device, global_batch: Optional[int] = None):
    """The start of a training program: join the launch's process group
    (``parallel/dist.init_distributed``: this rank's device), build its
    grid from ``--pp_stages`` / ``--pp_microbatches``
    (``parallel/pipeline.driver_grid`` over ``global_batch`` rows,
    default ``opts.train_batch_size``; it refuses what the JAX package's
    ``driver_mesh`` refuses, before any file is made), seed, and on the
    primary create ``output_dir`` with ``log/hps.json`` and the
    ``log/log.txt`` handler.  Returns (device, the handler or None)."""
    device = dist.init_distributed(device)
    pipeline.driver_grid(opts, global_batch or opts.train_batch_size)
    set_random_seed(opts.seed)
    if not dist.is_primary():
        return device, None
    os.makedirs(opts.output_dir, exist_ok=True)
    save_lib.save_training_meta(opts.output_dir, vars(opts),
                                {"model_config": opts.model_config})
    return device, add_log_to_file(os.path.join(opts.output_dir, "log",
                                                "log.txt"))


def end_run(opts, ckpt_writer, saver, restorer, log_file) -> None:
    """The end of a training program, also after an error: the checkpoint
    writer joined, and on the primary ``log/checkpoints.json`` written
    and the log handler removed."""
    try:
        ckpt_writer.close()
    finally:
        if saver is not None and dist.is_primary():
            write_checkpoint_records(opts.output_dir, saver, restorer)
        if log_file is not None:
            PACKAGE_LOGGER.removeHandler(log_file)
            log_file.close()


def make_restorer(opts, writer, tree: str = "pretrain"):
    """The run's ``TrainingRestorer``, made on the primary first (it
    writes ``restore_hps.json``, which the other ranks then check), and
    whether to resume from ``output_dir``'s restore file."""
    with dist.primary_first():
        restorer = save_lib.TrainingRestorer(
            opts.output_dir, {"num_train_steps": opts.num_train_steps,
                              "learning_rate": opts.learning_rate},
            writer=writer, tree=tree)
        resume = restorer.can_restore()
    return restorer, resume


def primary_only(*writers):
    """The checkpoint writers (``ModelSaver``, ``TrainingRestorer``) a
    rank passes to :func:`run_training`: all of them on the primary, None
    on the other ranks."""
    return writers if dist.is_primary() else (None,) * len(writers)


def run_finetune(opts, prepare: Callable, *, tree: str = "pretrain",
                 device="cuda", on_step: Optional[Callable] = None,
                 global_batch: Optional[int] = None):
    """A finetuning program's run on ``device``, or as this rank of the
    launch's data-parallel world (:func:`start_run`): ``output_dir`` with
    ``log/`` (``hps.json``, ``log.txt``, ``scalars.jsonl``,
    ``checkpoints.json``: each checkpoint's copy and write ms and bytes),
    ``ckpt/model_step_N.npz`` (marked ``__vocab_padded__`` when the
    checkpoint's pad decision is known) and ``restore.npz``, resumed from
    when present (every rank restores the primary's file).  Only the
    primary writes.  ``prepare(cfg, device)`` opens the stores and returns
    the program's :class:`Finetune`; ``tree`` is the parameter tree
    (``training/save.TREES``) the checkpoints hold.  ``on_step`` as
    :func:`run_training`'s.  Returns the final train state (this rank's
    part of it).  ``--pp_stages`` S splits the world into pipeline stages
    of S ranks and ``--zero1`` shards the AdamW moments over the ranks
    (:func:`start_run`, ``training/step.shard_state``; ``global_batch``,
    default ``opts.train_batch_size``, is the rows the grid checks)."""
    device, log_file = start_run(opts, device, global_batch)
    ckpt_writer = save_lib.AsyncCheckpointWriter()   # I/O off the loop
    saver = restorer = None
    try:
        cfg = model_config_from_opts(opts)
        job = prepare(cfg, device)
        restorer, resume = make_restorer(opts, ckpt_writer, tree)
        ckpt_info: Dict = {}
        if resume:
            # the restored parameters are the template: no init needed
            state = restorer.restore(device)
            if getattr(opts, "checkpoint", None):
                ckpt_info["vocab_padded"] = checkpoint_vocab_padded(
                    opts.checkpoint, cfg.f_config.vocab_size)
        else:
            restorer.template = job.init(ckpt_info)
            state = TrainState.create(job.load(restorer.template,
                                               device=device))
        state = shard_state(state, getattr(opts, "zero1", False))
        saver = save_lib.ModelSaver(
            os.path.join(opts.output_dir, "ckpt"), restorer.template,
            vocab_padded=ckpt_info.get("vocab_padded"), writer=ckpt_writer,
            tree=tree)
        taken = state.global_step * max(opts.gradient_accumulation_steps, 1)
        writing_saver, writing_restorer = primary_only(saver, restorer)
        return run_training(opts, job.step_fn, state, job.batches(taken),
                            extras_fn=job.extras_fn,
                            validate_fn=job.validate, saver=writing_saver,
                            restorer=writing_restorer, device=device,
                            on_step=on_step)
    finally:
        end_run(opts, ckpt_writer, saver, restorer, log_file)


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
    """The train loop (``hero_tpu/drivers/common.py:220-402``): optimizer
    steps from ``state.global_step`` up to ``opts.num_train_steps``, on
    ``device`` or as one rank of a data-parallel world.

    ``batch_iter`` yields (task, numpy micro-batch) of the global batch,
    the same on every rank; every ``gradient_accumulation_steps`` of
    them, all of one task, are stacked on a leading micro-batch axis with
    ``extras_fn(step)`` broadcast beside them, cut to the rank's rows
    (``dist.shard_rows``; ``opts.train_batch_size`` items must divide by
    the world size), and a background thread (:class:`PrefetchLoader`)
    moves the rank's arrays to ``device`` through pinned memory while the
    previous step runs.  ``step_fn`` is a train step or {task: train step}
    (``training/step.make_train_step``); step i gets the integer seed
    ``rng_for(opts.seed + 1, f"step{i}")``, so a resumed run draws what
    the uninterrupted one drew.

    After each step: ``on_step(step, task, metrics)`` if given; every
    ``LOG_EVERY`` steps the loss to the log and, on the primary, the
    scalars to ``output_dir/log/scalars.jsonl``; every
    ``opts.valid_steps`` the ranks' parameters checked identical
    (``dist.check_replicas``), ``validate_fn(state, step)`` on every rank
    and ``saver.save`` (a ``training/save.ModelSaver``);
    ``restorer.step`` (a ``TrainingRestorer``: ``restore.npz`` every
    ``opts.save_steps``).  A rank that writes no files passes no saver
    and no restorer; on a grid that shards the state (pipeline stages,
    ``--zero1``) every rank joins the gather of the whole state
    (``training/step.gather_state``) at each of these points.  At the
    end the model is saved and validated unless the last step was.  On
    SIGTERM (handled while the loop runs, when it runs on the main
    thread) the step in flight finishes, ``restore.npz`` and the model
    are written, and the loop returns; the ranks agree on it after every
    step (``dist.any_rank``), so a signal to one rank stops
    them all after the same step.  ``opts.profile_step`` = i traces
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
            yield task0, dist.shard_rows(
                stacked, accum, items=getattr(opts, "train_batch_size", None),
                replicated_keys=CURRICULUM_KEYS,
                row_index_keys=ROW_INDEX_KEYS)
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
    writer = (ScalarWriter(os.path.join(output_dir, "log"))
              if output_dir and dist.is_primary() else NoOp())
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
    profile_at = (getattr(opts, "profile_step", -1)
                  if output_dir and dist.is_primary() else -1)
    meters: Dict[str, RunningMeter] = {}
    world = dist.data_world()
    zero1 = bool(getattr(opts, "zero1", False))
    save_steps = getattr(opts, "save_steps", None)
    t0, n_ex = time.time(), 0
    last_validated = last_saved = -1
    whole = [None, None]              # (state, its whole state)

    def files():
        """The whole state for the files: every rank calls it at the same
        points (a collective on a sharded grid)."""
        if whole[0] is not state:
            whole[:] = [state, gather_state(state, zero1)]
        return whole[1]

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
        # videos this step: the micro-batch axis, then the batch axis, of
        # every rank's rows
        n_ex += int(np.prod(batch["sub_mask"].shape[:-1])) * world
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
            dist.check_replicas(state.params)
            # every rank validates: distributed serving needs every rank
            # in its collectives (hero_tpu/drivers/common.py:365-369)
            validate_fn(state, global_step)
            last_validated = global_step
            params = files().params
            if saver is not None:
                saver.save(params, global_step)
            last_saved = global_step
        restoring = (files() if save_steps and global_step % save_steps == 0
                     else state)
        if restorer is not None:
            restorer.step(restoring, save_steps)
        if dist.any_rank(preempted.is_set()):
            final = files()
            if restorer is not None:
                if restorer.saved_step != global_step:
                    restorer.save(final)
                restorer.flush()
            if saver is not None:
                if last_saved != global_step:
                    saver.save(final.params, global_step)
                saver.flush()
            dist.barrier()            # the files exist before any rank goes on
            LOGGER.warning("preempted at step %d: restore.npz written, "
                           "resume will continue from here", global_step)
            return state
        if global_step >= opts.num_train_steps:
            break
    if last_saved != global_step:
        params = files().params
        if saver is not None:
            saver.save(params, global_step)
    if saver is not None:
        saver.flush()
    if restorer is not None:
        restorer.flush()
    dist.barrier()
    if validate_fn is not None and last_validated != global_step:
        validate_fn(state, global_step)
    LOGGER.info("training done at step %d", global_step)
    return state
