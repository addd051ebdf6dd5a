"""TVQA/How2QA finetuning as a program (counterpart of
``hero_tpu/drivers/train_videoqa.py``, on one card or several ranks):

    python -m hero_tpu_torch.drivers.train_videoqa --config <json>

:func:`main` reads the sub and feature stores and the train question
store (``train_query_txt_db``: a question and its candidate answers a
record, with the answer index and the ``ts`` span) from disk, overlays
``opts.checkpoint`` (the reference's ``.pt``, e.g. ``hero-tv-ht100.pt``,
or a JAX-layout ``.npz``) on the seeded VideoQA init, resumes from
``output_dir/restore.npz`` when there is one, and trains ``qa_loss +
lw_st_ed * st_ed_loss`` of ``models/videoqa.forward_videoqa`` (reference
train_videoQA.py:157-166) with dropout, bf16 compute on fp32 parameters
(``lr_mul`` on the heads), with checkpoints in the JAX package's layout.
Every ``valid_steps`` it answers ``val_query_txt_db`` (the tail batch
kept) and writes the accuracy and the answers to
``output_dir/val_results_{step}.json``.  ``config/train-tvqa.json``
(TVQA, 5 answers, ``lw_st_ed`` 0.4) is its config; ``drivers/eval_videoqa``
serves a run.  :func:`run_qa_training` is the program of
``drivers/train_violin`` too.  On several ranks ``--zero1`` and
``--pp_stages`` work as in every training program (``common.start_run``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from hero_tpu_torch.config import opts as opts_lib
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.convert import from_jax
from hero_tpu_torch.data.downstream_tasks import VideoQaDataset, build_batch
from hero_tpu_torch.data.loader import dataset_iterator
from hero_tpu_torch.data.store import QueryTokStore
from hero_tpu_torch.drivers import common
from hero_tpu_torch.evaluation.downstream import validate_videoqa
from hero_tpu_torch.models import videoqa as videoqa_lib
from hero_tpu_torch.parallel import dist
from hero_tpu_torch.training.step import TrainState, make_train_step
from hero_tpu_torch.utils.logger import LOGGER, configure_stdout


@dataclasses.dataclass(frozen=True)
class QaTask:
    """What sets a VideoQA-style finetune apart: the parameter tree (a key
    of ``training/save.TREES``), its numpy init ``init(cfg, seed)`` and
    bridge ``load(flat, device)``; ``dataset(video_db, store_path,
    opts)``; ``make_loss_fn(cfg, opts, dtype)``; ``train_batch(batch)``,
    a numpy micro-batch's last edit; ``validate(params, cfg, dataset,
    opts, dtype, device) -> (log, results)``; ``rows(opts)``, the rows a
    training item spans (the JAX driver's global batch is that many rows
    an item); and the task name of the train batches (None:
    ``opts.task``)."""
    tree: str
    init: Callable
    load: Callable
    dataset: Callable
    make_loss_fn: Callable
    train_batch: Callable
    validate: Callable
    rows: Callable
    task: Optional[str] = None


def query_store(path: str, opts) -> QueryTokStore:
    return QueryTokStore(path, max_txt_len=opts.max_txt_len)


def qa_len(opts) -> int:
    """The padded length of the question-answer (or statement) tokens:
    ``bucket_query_len`` (the base parser's 32)."""
    return getattr(opts, "bucket_query_len", 40)


def videoqa_dataset(video_db, path: str, opts) -> VideoQaDataset:
    """Every question of the store at ``path``."""
    qdb = query_store(path, opts)
    return VideoQaDataset(list(qdb.id2len.keys()), video_db, qdb,
                          qa_len=qa_len(opts))


def videoqa_eval_batches(ds: VideoQaDataset, batch_size: int
                         ) -> Iterator[Dict[str, Any]]:
    """``ds`` in order, ``batch_size`` questions a batch (the tail batch
    shorter), answer rows flattened, with the host entries ``qids`` and
    ``targets_host`` (``hero_tpu/drivers/eval_videoqa.py:37-43``)."""
    for s in range(0, len(ds), batch_size):
        b = build_batch(ds, list(range(s, min(s + batch_size, len(ds)))),
                        flatten_rows=True)
        b["qids"] = b.pop("__qid__")
        b["targets_host"] = b["targets"]
        yield {k: v for k, v in b.items() if not k.startswith("__")}


def make_loss_fn(cfg: HeroConfig, num_answers: int = 5,
                 lw_st_ed: float = 0.4, dtype: torch.dtype = torch.bfloat16,
                 train: bool = True):
    """``train_videoqa``'s ``loss_fn(params, batch, seed)``: ``qa_loss +
    lw_st_ed * st_ed_loss``, both as aux
    (``hero_tpu/drivers/train_videoqa.py:59-64``)."""

    def loss_fn(params, batch, seed):
        qa_loss, t_loss = videoqa_lib.forward_videoqa(
            params, cfg, batch, num_answers=num_answers, train=train,
            seed=seed, dtype=dtype)
        return qa_loss + lw_st_ed * t_loss, {"qa_loss": qa_loss,
                                             "st_ed_loss": t_loss}
    return loss_fn


def _validate_videoqa(params, cfg, ds, opts, dtype, device):
    log, results, _ = validate_videoqa(
        params, cfg, videoqa_eval_batches(ds, min(opts.val_batch_size,
                                                  len(ds))),
        num_answers=getattr(opts, "num_answers", 5), dtype=dtype,
        device=device)
    return log, results


VIDEOQA = QaTask(
    tree="videoqa", init=videoqa_lib.init_hero_for_videoqa,
    load=from_jax.load_jax_videoqa_params, dataset=videoqa_dataset,
    make_loss_fn=lambda cfg, opts, dtype: make_loss_fn(
        cfg, getattr(opts, "num_answers", 5), getattr(opts, "lw_st_ed", 0.4),
        dtype),
    train_batch=lambda b: b, validate=_validate_videoqa,
    rows=lambda opts: getattr(opts, "num_answers", 5))


def init_params(task: QaTask, opts, cfg: HeroConfig,
                info: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """The flat JAX-layout parameters a run starts from: ``task``'s numpy
    init from ``opts.seed`` (not ``jax.random.PRNGKey(seed)``'s), overlaid
    with ``opts.checkpoint`` when set (its vocab-pad decision to
    ``info["vocab_padded"]``).  A pretraining checkpoint or the released
    ``.pt`` fills ``v_encoder``; a head it lacks keeps the init."""
    flat = task.init(cfg, seed=opts.seed)
    if getattr(opts, "checkpoint", None):
        flat = common.load_checkpoint_into(flat, opts.checkpoint,
                                           cfg.f_config.vocab_size,
                                           info=info)
    return flat


def run_qa_training(task: QaTask, opts, *, device="cuda",
                    on_step: Optional[Callable] = None,
                    dtype: torch.dtype = torch.bfloat16) -> TrainState:
    """Finetune ``task`` as ``opts`` says on ``device``
    (:func:`common.run_finetune`: ``output_dir`` with ``log/``, ``ckpt/``
    and ``restore.npz``), with ``val_results_{step}.json`` (``{"log",
    "results"}``) at every validation.  The step and the validation
    compute in ``dtype`` (bf16, as the JAX programs) on fp32 parameters.
    ``on_step`` as :func:`common.run_training`'s.  Returns the final
    train state (this rank's part: ``common.run_finetune``; the grid's
    global batch is ``task.rows(opts)`` rows an item)."""
    def prepare(cfg, device):
        video_db = common.load_video_sub_dataset(
            opts, common.shapes_from_opts(opts))
        train_ds = task.dataset(video_db, opts.train_query_txt_db, opts)
        LOGGER.info("%s train: %d items", task.tree, len(train_ds))
        name = task.task or opts.task

        def batches(taken):
            it = dataset_iterator(
                train_ds, lambda ds, idx: build_batch(ds, idx,
                                                      flatten_rows=True),
                opts.train_batch_size, seed=opts.seed)
            it.skip(taken)
            for batch in it:
                yield name, task.train_batch(
                    {k: v for k, v in batch.items()
                     if not k.startswith("__")})

        def validate(state, step):
            if not getattr(opts, "val_query_txt_db", None):
                return
            val_ds = task.dataset(video_db, opts.val_query_txt_db, opts)
            log, results = task.validate(state.params, cfg, val_ds, opts,
                                         dtype, device)
            if not dist.is_primary():
                return            # every rank validated the same items
            LOGGER.info("[step %d] %s val: %s", step, task.tree, log)
            with open(os.path.join(opts.output_dir,
                                   f"val_results_{step}.json"), "w") as f:
                json.dump({"log": log, "results": {
                    str(k): v for k, v in results.items()}}, f)

        return common.Finetune(
            init=lambda info: init_params(task, opts, cfg, info=info),
            load=task.load,
            step_fn=make_train_step(
                task.make_loss_fn(cfg, opts, dtype),
                common.train_spec(vars(opts)),
                accum_steps=max(opts.gradient_accumulation_steps, 1),
                zero1=getattr(opts, "zero1", False)),
            batches=batches, validate=validate)

    return common.run_finetune(
        opts, prepare, tree=task.tree, device=device, on_step=on_step,
        global_batch=opts.train_batch_size * task.rows(opts))


def main(opts, *, device="cuda", on_step: Optional[Callable] = None,
         dtype: torch.dtype = torch.bfloat16) -> TrainState:
    """Finetune TVQA/How2QA as ``opts`` says
    (``hero_tpu/drivers/train_videoqa.py:30-136``): :func:`run_qa_training`
    of :data:`VIDEOQA`, ``opts.num_answers`` rows a question, the batches
    named ``opts.task``."""
    return run_qa_training(VIDEOQA, opts, device=device, on_step=on_step,
                           dtype=dtype)


def cli():
    """The console script's entry (``hero-tpu-torch-train-videoqa``)."""
    configure_stdout()
    main(opts_lib.get_videoqa_args())


if __name__ == "__main__":
    cli()
