"""Multi-task pretraining (counterpart of ``hero_tpu/drivers/pretrain.py``):
MLM, MFM-NCE / MFFR, FOM and VSM over one or more video targets, one
task an optimizer step as the seeded :class:`MetaLoader` draws it.

    python -m hero_tpu_torch.drivers.pretrain --config config/pretrain-tv.json

:func:`main` opens the targets' stores (:func:`build_targets`), loads
``opts.checkpoint`` (a JAX-layout ``.npz``) over the seeded init, resumes
from ``output_dir/restore.npz`` when there is one (the schedule replayed
exactly), and trains with checkpoints in the JAX package's layout
(``training/save.py``).  :func:`run_pretrain` is its body after the stores
and the state exist: task datasets over the targets'
``VideoFeatSubTokDataset`` s, one train step a task, the curriculum,
validation, and the train loop.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from hero_tpu_torch.config import opts as opts_lib
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.convert.from_jax import load_jax_params
from hero_tpu_torch.data import pretrain_tasks as pt
from hero_tpu_torch.data.loader import MetaLoader, dataset_iterator
from hero_tpu_torch.data.store import (ShardedVideoFeatStore, SubTokStore,
                                       VideoFeatStore)
from hero_tpu_torch.data.video import (VideoFeatSubTokDataset,
                                       suggest_shapes, video_fits_bucket)
from hero_tpu_torch.drivers import common
from hero_tpu_torch.models import pretrain as pretrain_lib
from hero_tpu_torch.parallel import dist, pipeline
from hero_tpu_torch.training.optim import AdamWConfig
from hero_tpu_torch.training.save import AsyncCheckpointWriter, ModelSaver
from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                          make_train_step, shard_state)
from hero_tpu_torch.utils.logger import LOGGER, configure_stdout

DEFAULT_TASKS = {"mlm": 2, "mfm-nce": 2, "fom": 1, "vsm": 2}


def build_targets(opts):
    """({target name: VideoFeatSubTokDataset}, {``task@target``: ratio})
    from ``opts.targets`` (reference build_target_loaders,
    pretrain.py:44-57): each target names its sub store and its feature
    store (``vfeat_db``, or HowTo100M-style ``vfeat_shards``), optionally
    its ``vfeat_interval`` and its ``tasks`` ratios (default
    :data:`DEFAULT_TASKS`), each ratio times the target's entry of
    ``opts.targets_ratio``.  Without targets: the single target ``""``
    over ``opts.sub_txt_db`` / ``opts.vfeat_db``, ratios None."""
    shapes = common.shapes_from_opts(opts)
    targets = getattr(opts, "targets", None)
    if not targets:
        return {"": common.load_video_sub_dataset(opts, shapes)}, None
    out, ratios = {}, {}
    tgt_ratios = getattr(opts, "targets_ratio", None) or [1] * len(targets)
    for tgt, tr in zip(targets, tgt_ratios):
        sub = SubTokStore(tgt["sub_txt_db"], max_clip_len=opts.max_clip_len)
        interval = tgt.get("vfeat_interval", opts.vfeat_interval)
        if "vfeat_shards" in tgt:
            vfeat = ShardedVideoFeatStore(
                tgt["vfeat_shards"], frame_interval=interval,
                max_clip_len=opts.max_clip_len)
        else:
            vfeat = VideoFeatStore(tgt["vfeat_db"], frame_interval=interval,
                                   max_clip_len=opts.max_clip_len)
        out[tgt["name"]] = VideoFeatSubTokDataset(
            sub, vfeat, shapes, max_txt_len=opts.max_txt_len,
            sub_ctx_len=opts.sub_ctx_len,
            pack=getattr(opts, "pack_subs", False))
        for task, r in tgt.get("tasks", DEFAULT_TASKS).items():
            ratios[f"{task}@{tgt['name']}"] = r * tr
    return out, ratios


def _bucketize(opts, video_dbs):
    """With ``--second_bucket``, the videos the primary shapes would
    truncate go to a larger, unpacked bucket sized by
    :func:`suggest_shapes` at full coverage.  Returns {target: (video_db,
    fitting vids, big_db or None, big vids)}."""
    out = {}
    for tgt, db in video_dbs.items():
        vids = list(db.txt_db.id2len.keys())
        if not getattr(opts, "second_bucket", False):
            out[tgt] = (db, vids, None, [])
            continue
        fit = [v for v in vids if video_fits_bucket(db, v)]
        fit_set = set(fit)
        big = [v for v in vids if v not in fit_set]
        if not big:
            out[tgt] = (db, vids, None, [])
            continue
        big_shapes = suggest_shapes(db.txt_db, coverage=1.0,
                                    max_txt_len=db.max_txt_len,
                                    sub_ctx_len=db.sub_ctx_len,
                                    base=db.shapes)
        big_db = VideoFeatSubTokDataset(db.txt_db, db.img_db, big_shapes,
                                        max_txt_len=db.max_txt_len,
                                        sub_ctx_len=db.sub_ctx_len)
        LOGGER.info("target %r: %d/%d videos exceed the primary bucket; "
                    "second bucket %s", tgt, len(big), len(vids),
                    big_shapes)
        out[tgt] = (db, fit, big_db, big)
    return out


def build_task_datasets(opts, video_dbs, name_ratios=None):
    """{task name: (task dataset, ratio)}; names are ``task@target`` as
    :func:`build_targets` gives them (``task`` with the single-target
    schema), ``#big`` added for a second bucket's share."""
    tasks = {}
    if name_ratios is None:
        ratios = getattr(opts, "task_ratios", None) or DEFAULT_TASKS
        name_ratios = {f"{t}@": r for t, r in ratios.items()}
    buckets = _bucketize(opts, video_dbs)
    # when any bucket splits, every ratio scales by the same factor, so
    # the relative task and target weights hold
    scale = 8 if any(b[2] is not None for b in buckets.values()) else 1
    expanded = {}
    for name, ratio in name_ratios.items():
        task, _, tgt = name.partition("@")
        db, fit, big_db, big = buckets.get(tgt) or buckets[""]
        if big_db is None:
            expanded[name] = (scale * ratio, db, fit)
            continue
        total = len(fit) + len(big)
        r_big = min(max(1, round(scale * ratio * len(big) / total)),
                    scale * ratio - 1)
        r_fit = scale * ratio - r_big
        expanded[name] = (r_fit, db, fit)
        expanded[name + "#big"] = (r_big, big_db, big)
    for name, (ratio, video_db, vids) in expanded.items():
        task = name.partition("@")[0]
        if task == "vsm":
            ds = pt.VsmDataset(vids, video_db,
                               query_per_video=getattr(
                                   opts, "query_per_video", 5),
                               seed=opts.seed)
        elif task.startswith("mlm"):
            ds = pt.MlmDataset(vids, video_db,
                               mask_prob=getattr(opts, "mask_prob", 0.15),
                               seed=opts.seed)
        elif task in ("mfm-nce", "mffr"):
            ds = pt.MfmDataset(vids, video_db,
                               mask_prob=getattr(opts, "mask_prob", 0.15),
                               seed=opts.seed)
        elif task == "fom":
            ds = pt.FomDataset(vids, video_db, seed=opts.seed)
        else:
            raise ValueError(task)
        tasks[name.rstrip("@")] = (ds, ratio)
    return tasks


def make_loss(task: str, cfg, vsm, *, mask_prob: float = 0.15,
              dtype: torch.dtype = torch.bfloat16,
              train: bool = True) -> Callable:
    """The train loss of one task, ``loss_fn(params, batch, seed) ->
    (loss, {})`` (``hero_tpu/drivers/pretrain.py:191-210``): VSM pops the
    curriculum's extras and sums its three weighted losses; the other
    tasks return sum / max(count, 1) of the global batch
    (``parallel/dist``: MLM, MFFR and FOM by rule (a), MFM-NCE, whose sum
    and count are already the global batch's, by rule (b))."""
    task = task.partition("@")[0].partition("#")[0]

    def loss_fn(params, batch, seed):
        batch = dict(batch)
        cur = common.curriculum_kwargs(batch)
        if task == "vsm":
            a, b, c = pretrain_lib.forward_vsm(params, cfg, vsm, batch,
                                               train=train, seed=seed,
                                               dtype=dtype, **cur)
            return a + b + c, {}
        s, n = pretrain_lib.forward_pretrain(params, cfg, vsm, batch, task,
                                             train=train, seed=seed,
                                             dtype=dtype,
                                             mask_prob=mask_prob)
        if task == "mfm-nce":
            return dist.replicated(s / torch.clamp(n, min=1.0)), {}
        return dist.global_mean(s, n), {}
    return loss_fn


def train_spec_from_opts(opts) -> TrainSpec:
    return TrainSpec(learning_rate=opts.learning_rate,
                     warmup_steps=opts.warmup_steps,
                     num_train_steps=opts.num_train_steps,
                     grad_norm=opts.grad_norm,
                     lr_schedule=getattr(opts, "lr_sched", "warmup_linear"),
                     adamw=AdamWConfig(beta1=opts.betas[0],
                                       beta2=opts.betas[1],
                                       weight_decay=opts.weight_decay))


def init_params(opts, cfg, vsm, info: Optional[Dict] = None
                ) -> Dict[str, np.ndarray]:
    """The flat JAX-layout parameters a run starts from: the numpy init
    from ``opts.seed``, overlaid with ``opts.checkpoint`` (a JAX-layout
    ``.npz`` or a reference ``.pt``; its vocab-pad decision to
    ``info["vocab_padded"]``) when set.  The
    bridge (``load_jax_params``) moves them to the device."""
    flat = pretrain_lib.init_flat_params(cfg, vsm, seed=opts.seed)
    if getattr(opts, "checkpoint", None):
        flat = common.load_checkpoint_into(flat, opts.checkpoint,
                                           cfg.f_config.vocab_size,
                                           info=info)
    return flat


def run_pretrain(opts, video_dbs: Dict[str, VideoFeatSubTokDataset],
                 name_ratios: Optional[Dict[str, int]] = None, *,
                 cfg: Optional[HeroConfig] = None,
                 state: Optional[TrainState] = None, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 on_step: Optional[Callable] = None, saver=None,
                 restorer=None) -> TrainState:
    """Pretrain on ``video_dbs`` ({target: dataset}) with ``name_ratios``
    ({``task@target``: ratio}, or ``opts.task_ratios`` /
    :data:`DEFAULT_TASKS` over the single target ``""``) for
    ``opts.num_train_steps`` optimizer steps of
    ``opts.train_batch_size`` videos x ``gradient_accumulation_steps``,
    bf16 on fp32 parameters by default, on ``device``
    (``hero_tpu/drivers/pretrain.py:173-282``).  ``cfg`` overrides the
    model config of ``opts.model_config``.  ``state`` is where to start
    (default :func:`init_params` on ``device``); a state past step 0
    resumes the task schedule where it stood.  ``on_step``, ``saver`` and
    ``restorer`` are :func:`common.run_training`'s.  Returns the final
    train state.  On several ranks (``parallel/dist``) every data rank
    builds the same task draws and batches and trains on its rows;
    ``--pp_stages`` and ``--zero1`` shard the state as
    ``common.start_run`` says (a ``state`` given is this rank's part).
    The grid's checks run before any work."""
    pipeline.driver_grid(opts, opts.train_batch_size)
    task_datasets = build_task_datasets(opts, video_dbs, name_ratios)
    LOGGER.info("pretraining targets %s, tasks %s", list(video_dbs),
                {t: r for t, (_, r) in task_datasets.items()})
    cfg = cfg or common.model_config_from_opts(opts)
    vsm = common.vsm_config_from_opts(opts)
    mask_prob = getattr(opts, "mask_prob", 0.15)
    accum = max(opts.gradient_accumulation_steps, 1)
    spec = train_spec_from_opts(opts)
    step_fns = {t: make_train_step(make_loss(t, cfg, vsm,
                                             mask_prob=mask_prob,
                                             dtype=dtype),
                                   spec, accum_steps=accum,
                                   zero1=getattr(opts, "zero1", False))
                for t in task_datasets}
    if state is None:
        state = shard_state(TrainState.create(load_jax_params(
            init_params(opts, cfg, vsm), device=device)),
            getattr(opts, "zero1", False))
    loaders = {
        t: (dataset_iterator(ds, pt.build_batch, opts.train_batch_size,
                             seed=opts.seed), ratio)
        for t, (ds, ratio) in task_datasets.items()}
    meta = MetaLoader(loaders, accum_steps=accum, seed=opts.seed)
    if state.global_step:
        # the same seeded draws, the task iterators skipping the batches
        # the steps before took without building them
        meta.fast_forward(state.global_step * accum)
    curriculum = common.Curriculum(opts)

    def validate(state, step):
        from hero_tpu_torch.evaluation.pretrain_val import validate_pretrain
        n_val = getattr(opts, "n_val_batches", 2)
        bs = getattr(opts, "val_batch_size", opts.train_batch_size)

        def val_batches(ds):
            n = min(n_val * bs, len(ds))
            return [pt.build_batch(ds, list(range(s, min(s + bs, n))))
                    for s in range(0, n, bs)]

        log = validate_pretrain(
            state.params, cfg, vsm,
            {t: val_batches(ds) for t, (ds, _) in task_datasets.items()},
            dtype=dtype, mask_prob=mask_prob, device=device)
        LOGGER.info("[step %d] %s", step,
                    {k: round(v, 4) for k, v in log.items()})

    state = common.run_training(opts, step_fns, state, iter(meta),
                                extras_fn=curriculum.at,
                                validate_fn=validate, saver=saver,
                                restorer=restorer, device=device,
                                on_step=on_step)
    for tgt, db in video_dbs.items():
        rep = db.truncation_report()
        if rep["videos_seen"]:
            LOGGER.info("bucket truncation [%s]: %s", tgt or "default", rep)
    return state


def main(opts, device="cuda", on_step: Optional[Callable] = None
         ) -> TrainState:
    """Pretrain as ``opts`` says (``hero_tpu/drivers/pretrain.py:163-282``)
    on ``device``, or as this rank of the launch's data-parallel world
    (``common.start_run``; ``torchrun --nproc_per_node N -m
    hero_tpu_torch.drivers.pretrain --config ...``): the stores of
    :func:`build_targets`, the weights of :func:`init_params`,
    ``output_dir`` with ``log/`` (``hps.json``, ``log.txt``,
    ``scalars.jsonl``, ``checkpoints.json``: each checkpoint's copy and
    write ms and bytes), ``ckpt/model_step_N.npz`` and ``restore.npz``,
    resumed from when present (every rank restores the primary's file),
    written by the primary alone.  bf16 compute on fp32 parameters.
    ``on_step`` as :func:`common.run_training`'s.  Returns the final train
    state (this rank's part).  ``--zero1`` shards the AdamW moments over
    the ranks and ``--pp_stages`` S runs the encoder stacks S divides as
    a pipeline over stages of S ranks (``common.start_run``; launch
    ``torchrun --nproc_per_node N`` with N a multiple of S)."""
    device, log_file = common.start_run(opts, device)
    ckpt_writer = AsyncCheckpointWriter()   # file I/O off the train loop
    saver = restorer = None
    try:
        video_dbs, name_ratios = build_targets(opts)
        cfg = common.model_config_from_opts(opts)
        vsm = common.vsm_config_from_opts(opts)
        restorer, resume = common.make_restorer(opts, ckpt_writer)
        ckpt_info: Dict = {}
        if resume:
            # the restored parameters give the files' layout: no init needed
            state = restorer.restore(device)
            if getattr(opts, "checkpoint", None):
                ckpt_info["vocab_padded"] = common.checkpoint_vocab_padded(
                    opts.checkpoint, cfg.f_config.vocab_size)
        else:
            restorer.template = init_params(opts, cfg, vsm, info=ckpt_info)
            state = TrainState.create(load_jax_params(restorer.template,
                                                      device=device))
        state = shard_state(state, getattr(opts, "zero1", False))
        saver = ModelSaver(os.path.join(opts.output_dir, "ckpt"),
                           restorer.template,
                           vocab_padded=ckpt_info.get("vocab_padded"),
                           writer=ckpt_writer)
        writing_saver, writing_restorer = common.primary_only(saver,
                                                               restorer)
        return run_pretrain(opts, video_dbs, name_ratios, cfg=cfg,
                            state=state, device=device, on_step=on_step,
                            saver=writing_saver, restorer=writing_restorer)
    finally:
        common.end_run(opts, ckpt_writer, saver, restorer, log_file)


def cli():
    """The console script's entry (``hero-tpu-torch-pretrain``)."""
    configure_stdout()
    main(opts_lib.get_pretrain_args())


if __name__ == "__main__":
    cli()
