"""VIOLIN inference as a program (counterpart of
``hero_tpu/drivers/eval_violin.py``, on one card or several ranks):

    python -m hero_tpu_torch.drivers.eval_violin --output_dir <train dir> \
        --checkpoint <step or path> [--query_txt_db <db>]

``drivers/eval_videoqa``'s loading with VIOLIN's tree and pairs: writes
qid -> 0/1 (sigmoid > 0.5) for both statements of every ``_0``/``_1``
pair to ``violin_results_{ckpt}_all.json`` beside the run and prints
``{"n_ex", "acc"}``.
"""

from __future__ import annotations

import json

import torch

from hero_tpu_torch.drivers.eval_videoqa import (base_argparser, load_run,
                                                 write_results)
from hero_tpu_torch.drivers.train_violin import VIOLIN, violin_eval_batches
from hero_tpu_torch.evaluation.downstream import validate_violin
from hero_tpu_torch.parallel import dist
from hero_tpu_torch.utils.logger import LOGGER, configure_stdout


def main(args, *, device="cuda", dtype: torch.dtype = torch.bfloat16):
    """Judge the statements with ``args.output_dir``'s run at
    ``args.checkpoint`` on ``device`` in ``dtype``
    (``hero_tpu/drivers/eval_violin.py:20-58``), ``val_batch_size`` pairs
    a batch.  On the ranks of a launch every rank judges every pair, as
    the JAX program does, and the primary writes.  Returns (log, qid ->
    0/1)."""
    device = dist.init_distributed(device)
    opts, cfg, params, ds = load_run(args, VIOLIN, device)
    log, results = validate_violin(
        params, cfg, violin_eval_batches(ds, getattr(opts,
                                                     "val_batch_size", 8)),
        dtype=dtype, device=device)
    if not dist.is_primary():
        return log, results
    LOGGER.info("violin eval: %s", log)
    write_results(args.output_dir,
                  f"violin_results_{args.checkpoint}_all.json", results)
    print(json.dumps(log))
    return log, results


def build_argparser():
    return base_argparser("eval_violin")


def cli():
    """The console script's entry (``hero-tpu-torch-eval-violin``)."""
    configure_stdout()
    main(build_argparser().parse_args())


if __name__ == "__main__":
    cli()
