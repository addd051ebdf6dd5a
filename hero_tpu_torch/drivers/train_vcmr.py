"""TVR/How2R/DiDeMo VCMR finetuning as a program (counterpart of
``hero_tpu/drivers/train_vcmr.py``, on one card or data-parallel ranks):

    python -m hero_tpu_torch.drivers.train_vcmr --config <json>

:func:`main` reads the video stores (the sub and feature stores, or the
feature store alone for a ``*_video_only`` task) and the train query
store from disk, overlays ``opts.checkpoint`` (the reference's ``.pt``,
e.g. ``hero-tv-ht100.pt``, or a JAX-layout ``.npz``) on the seeded
pretraining init, resumes from ``output_dir/restore.npz`` when there is
one, and trains the VSM losses of ``models/vcmr.forward_vcmr`` with the
curriculum's hard negatives and span weight (``common.Curriculum``),
bf16 compute on fp32 parameters, with checkpoints in the JAX package's
layout.  Every ``valid_steps`` it evaluates the whole corpus against
``val_query_txt_db`` (:func:`run_validation`: ``validate_full_vcmr``)
and writes the reference-schema submission to
``output_dir/results_{step}_all.json``.  ``drivers/train_vr`` runs it
for MSR-VTT video retrieval.  On several ranks ``--zero1`` shards the
AdamW moments over them and ``--pp_stages`` S runs the f-encoder as a
pipeline over stages of S ranks (``common.start_run``).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from hero_tpu_torch.config import opts as opts_lib
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.convert.from_jax import load_jax_params
from hero_tpu_torch.data.downstream_tasks import (VcmrDataset,
                                                  VcmrFullEvalDataset,
                                                  build_batch)
from hero_tpu_torch.data.loader import dataset_iterator
from hero_tpu_torch.data.store import QueryTokStore
from hero_tpu_torch.data.video import stack_items
from hero_tpu_torch.drivers import common, pretrain
from hero_tpu_torch.evaluation.vcmr_eval import validate_full_vcmr
from hero_tpu_torch.models import vcmr as vcmr_lib
from hero_tpu_torch.models.pretrain import VsmConfig
from hero_tpu_torch.parallel import dist
from hero_tpu_torch.training.step import TrainState, make_train_step
from hero_tpu_torch.utils.logger import LOGGER, configure_stdout


def build_eval_inputs(video_db, query_db, opts):
    """(video batches, query batches, sorted video ids, the global
    {video: index}, query data) for ``validate_full_vcmr``
    (``hero_tpu/drivers/train_vcmr.py:40-82``).

    The global index is the sub store's for the first of the ``val``,
    ``train`` and ``test`` splits it has, else the sorted ids' order.
    Video batches hold ``opts.vcmr_eval_video_batch_size`` videos; a
    ragged last batch (after the first) is padded with zero-mask videos,
    which the scorer never ranks; on W ranks the batches another rank
    embeds (``validate_full_vcmr``'s ``i % W``) are None, never read from
    the stores.  Query batches hold ``opts.vcmr_eval_batch_size``
    queries, the last padded to that size
    (:meth:`VcmrFullEvalDataset.batches`); with
    ``opts.distributed_eval`` on W ranks, of this rank's share of the
    queries."""
    if hasattr(video_db.txt_db, "id2len") and video_db.txt_db.id2len:
        video_ids = sorted(video_db.txt_db.id2len.keys())
    else:
        video_ids = sorted(video_db.vids)
    video2idx_global = None
    v2i = video_db.vid2idx
    if v2i:
        # the sub store's vid2idx is {split: {vid: idx}} (vid2dur_idx.json)
        for split in ("val", "train", "test"):
            if split in v2i:
                video2idx_global = v2i[split]
                break
    if video2idx_global is None:
        video2idx_global = {v: i for i, v in enumerate(video_ids)}
    video_ids = sorted(video2idx_global.keys())

    world, rank = dist.data_world(), dist.data_rank()

    def video_batches():
        bs = getattr(opts, "vcmr_eval_video_batch_size", 50)
        for i, s in enumerate(range(0, len(video_ids), bs)):
            if i % world != rank:
                yield None
                continue
            items = [video_db.video_item(v) for v in video_ids[s:s + bs]]
            if len(items) < bs and s > 0:
                pad_item = {k: np.zeros_like(v) for k, v in items[0].items()}
                items.extend([pad_item] * (bs - len(items)))
            yield stack_items(items)

    full_eval = VcmrFullEvalDataset(
        list(query_db.id2len.keys()), query_db, video_db.shapes,
        distributed=bool(getattr(opts, "distributed_eval", False)),
        rank=rank, world_size=world)
    query_batches = full_eval.batches(
        getattr(opts, "vcmr_eval_batch_size", 80))
    return (video_batches(), query_batches, video_ids, video2idx_global,
            query_db.query_data)


def make_loss_fn(cfg: HeroConfig, vsm: VsmConfig,
                 dtype: torch.dtype = torch.bfloat16, train: bool = True):
    """``train_vcmr``'s ``loss_fn(params, batch, seed)``: the sum of the
    three weighted VSM losses, with the curriculum's extras popped from
    the batch, and each loss as aux (``hero_tpu/drivers/train_vcmr.py:
    129-137``)."""

    def loss_fn(params, batch, seed):
        batch = dict(batch)
        cur = common.curriculum_kwargs(batch)
        a, b, c = vcmr_lib.forward_vcmr(params, cfg, vsm, batch, train=train,
                                        seed=seed, dtype=dtype, **cur)
        return a + b + c, {"loss_st_ed": a, "loss_neg_ctx": b,
                           "loss_neg_q": c}
    return loss_fn


def main(opts, *, dataset_cls=VcmrDataset, query_store_cls=QueryTokStore,
         device="cuda", on_step: Optional[Callable] = None,
         dtype: torch.dtype = torch.bfloat16) -> TrainState:
    """Finetune VCMR as ``opts`` says (``hero_tpu/drivers/train_vcmr.py:
    85-183``) on ``device`` (:func:`common.run_finetune`: ``output_dir``
    with ``log/``, ``ckpt/`` and ``restore.npz``), with
    ``results_{step}_all.json`` at every validation.  One query a
    training item (``dataset_cls(..., sampled_by_q=True)``).  The step
    and the validation compute in ``dtype`` (bf16, as the JAX program) on
    fp32 parameters.
    ``dataset_cls`` / ``query_store_cls`` select the VR variant
    (``drivers/train_vr``).  The parameters are the pretraining tree
    (``drivers/pretrain.init_params``: the checkpoint over the port's
    numpy-seeded init, not ``jax.random.PRNGKey(seed)``'s); the step
    takes ``common.train_spec``'s hyper-parameters (``lr_mul`` on every
    parameter outside ``v_encoder``).
    ``on_step`` as :func:`common.run_training`'s.  Returns the final
    train state (this rank's part: ``common.run_finetune``)."""
    def prepare(cfg, device):
        shapes = common.shapes_from_opts(opts).replace(n_queries=1)
        video_db = common.load_task_video_dataset(opts, shapes)
        if common.is_video_only_task(getattr(opts, "task", "tvr")):
            train_vids = list(video_db.vids)
        else:
            train_vids = list(video_db.txt_db.id2len.keys())
        query_db = query_store_cls(opts.train_query_txt_db,
                                   max_txt_len=opts.max_txt_len)
        train_ds = dataset_cls(train_vids, video_db, query_db,
                               sampled_by_q=True, seed=opts.seed)
        LOGGER.info("train: %d queries over %d videos", len(train_ds),
                    len(video_db))
        vsm = common.vsm_config_from_opts(opts)

        def batches(taken):
            it = dataset_iterator(train_ds, build_batch,
                                  opts.train_batch_size)
            it.skip(taken)
            for batch in it:
                yield "tvr", {k: v for k, v in batch.items()
                              if not k.startswith("__")}

        def validate(state, step):
            run_validation(state, cfg, vsm, video_db, opts, step,
                           query_store_cls=query_store_cls, dtype=dtype,
                           device=device)

        return common.Finetune(
            init=lambda info: pretrain.init_params(opts, cfg, vsm,
                                                   info=info),
            load=load_jax_params,
            step_fn=make_train_step(
                make_loss_fn(cfg, vsm, dtype), common.train_spec(vars(opts)),
                accum_steps=max(opts.gradient_accumulation_steps, 1),
                zero1=getattr(opts, "zero1", False)),
            batches=batches, validate=validate,
            extras_fn=common.Curriculum(opts).at)

    return common.run_finetune(opts, prepare, device=device,
                               on_step=on_step)


def run_validation(state, cfg: HeroConfig, vsm: VsmConfig, video_db, opts,
                   step: int, *, query_store_cls=QueryTokStore,
                   dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """The whole corpus against ``opts.val_query_txt_db`` (none: no
    validation) with ``validate_full_vcmr``; the metrics to the log and
    the submission (every rank's queries) to
    ``output_dir/results_{step}_all.json`` from the primary
    (``hero_tpu/drivers/train_vcmr.py:186-214``).  Every rank calls it."""
    if not getattr(opts, "val_query_txt_db", None):
        return
    val_qdb = query_store_cls(opts.val_query_txt_db,
                              max_txt_len=opts.max_txt_len)
    vb, qb, video_ids, v2i_global, qdata = build_eval_inputs(video_db,
                                                             val_qdb, opts)
    _, submission, metrics = validate_full_vcmr(
        state.params, cfg, vsm, common.eval_opts_from(opts), vb, qb,
        video_ids, v2i_global, qdata, dtype=dtype, device=device,
        distributed=bool(getattr(opts, "distributed_eval", False)))
    if not dist.is_primary():
        return
    for task, m in (metrics or {}).items():
        LOGGER.info("[step %d] %s: %s", step, task,
                    {k: round(v, 2) for k, v in m.items()
                     if isinstance(v, float)})
    with open(os.path.join(opts.output_dir,
                           f"results_{step}_all.json"), "w") as f:
        json.dump(submission, f)


def cli():
    """The console script's entry (``hero-tpu-torch-train-vcmr``)."""
    configure_stdout()
    main(opts_lib.get_vcmr_args())


if __name__ == "__main__":
    cli()
