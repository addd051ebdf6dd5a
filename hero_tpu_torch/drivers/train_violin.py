"""VIOLIN entailment finetuning as a program (counterpart of
``hero_tpu/drivers/train_violin.py``, on one card or several ranks):

    python -m hero_tpu_torch.drivers.train_violin --config <json>

``drivers/train_videoqa.run_qa_training`` with VIOLIN's parts: the items
are the store's ``_0`` statements, each with its ``_1`` pair (two rows a
item, flattened into the batch), the loss the binary cross entropy of
``models/violin.forward_violin`` (reference train_violin.py:160-162) on
``targets`` flattened to one per row, the batches named ``violin``, and
validation the accuracy of sigmoid > 0.5 over both statements of every
pair, written to ``output_dir/val_results_{step}.json``.
``config/train-violin.json`` is its config; ``drivers/eval_violin``
serves a run.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from hero_tpu_torch.config import opts as opts_lib
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.convert import from_jax
from hero_tpu_torch.data.downstream_tasks import ViolinDataset, build_batch
from hero_tpu_torch.drivers.train_videoqa import (QaTask, qa_len,
                                                  query_store,
                                                  run_qa_training)
from hero_tpu_torch.evaluation.downstream import validate_violin
from hero_tpu_torch.models import violin as violin_lib
from hero_tpu_torch.training.step import TrainState
from hero_tpu_torch.utils.logger import configure_stdout


def violin_dataset(video_db, path: str, opts) -> ViolinDataset:
    """The ``_0`` statements of the store at ``path``, each paired with
    its ``_1``."""
    qdb = query_store(path, opts)
    qids = [q for q in qdb.id2len if q.endswith("_0")]
    return ViolinDataset(qids, video_db, qdb, stmt_len=qa_len(opts))


def violin_eval_batches(ds: ViolinDataset, batch_size: int
                        ) -> Iterator[Dict[str, Any]]:
    """``ds`` in order, ``batch_size`` pairs a batch (the tail batch
    shorter), rows flattened, with the host list ``qids`` (both of each
    pair) and ``targets`` one per row
    (``hero_tpu/drivers/eval_violin.py:39-49``)."""
    for s in range(0, len(ds), batch_size):
        b = build_batch(ds, list(range(s, min(s + batch_size, len(ds)))),
                        flatten_rows=True)
        qids = [q for pair in b.pop("__qids__") for q in pair]
        b = {k: v for k, v in b.items() if not k.startswith("__")}
        b["qids"] = qids
        b["targets_host"] = np.asarray(b["targets"]).reshape(-1)
        b["targets"] = b["targets_host"]
        yield b


def make_loss_fn(cfg: HeroConfig, dtype: torch.dtype = torch.bfloat16,
                 train: bool = True):
    """``train_violin``'s ``loss_fn(params, batch, seed)``: the mean binary
    cross entropy, no aux (``hero_tpu/drivers/train_violin.py:56-61``)."""

    def loss_fn(params, batch, seed):
        batch = dict(batch)
        batch["targets"] = batch["targets"].reshape(-1)
        return violin_lib.forward_violin(params, cfg, batch, train=train,
                                         seed=seed, dtype=dtype), {}
    return loss_fn


def _train_batch(b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    b["targets"] = np.asarray(b["targets"]).reshape(-1)
    return b


def _validate_violin(params, cfg, ds, opts, dtype, device):
    return validate_violin(
        params, cfg, violin_eval_batches(ds, min(opts.val_batch_size,
                                                 len(ds))),
        dtype=dtype, device=device)


VIOLIN = QaTask(
    tree="violin", init=violin_lib.init_hero_for_violin,
    load=from_jax.load_jax_violin_params, dataset=violin_dataset,
    make_loss_fn=lambda cfg, opts, dtype: make_loss_fn(cfg, dtype),
    train_batch=_train_batch, validate=_validate_violin,
    rows=lambda opts: 2, task="violin")


def main(opts, *, device="cuda", on_step: Optional[Callable] = None,
         dtype: torch.dtype = torch.bfloat16) -> TrainState:
    """Finetune VIOLIN as ``opts`` says
    (``hero_tpu/drivers/train_violin.py:31-142``):
    ``train_videoqa.run_qa_training`` of :data:`VIOLIN`."""
    return run_qa_training(VIOLIN, opts, device=device, on_step=on_step,
                           dtype=dtype)


def cli():
    """The console script's entry (``hero-tpu-torch-train-violin``)."""
    configure_stdout()
    main(opts_lib.get_violin_args())


if __name__ == "__main__":
    cli()
