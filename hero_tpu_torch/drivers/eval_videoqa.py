"""VideoQA inference as a program (counterpart of
``hero_tpu/drivers/eval_videoqa.py``, on one card or several ranks):

    python -m hero_tpu_torch.drivers.eval_videoqa --output_dir <train dir> \
        --checkpoint <step or path> [--query_txt_db <db>] [--save_logits]

reloads the run's ``log/hps.json`` as the serving options, overlays the
checkpoint (a JAX-layout ``.npz`` or a reference ``.pt``) on the seeded
VideoQA init, answers every question of the store (the run's
``val_query_txt_db`` unless ``--query_txt_db``), writes qid -> answer
index to ``qa_results_{ckpt}_all.json`` beside the run (and qid -> the
answers' logits to ``qa_results_{ckpt}_all_logits.pkl`` with
``--save_logits``) and prints ``{"n_ex", "acc"}`` (acc over the questions
with a target).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import torch

from hero_tpu_torch.drivers import common
from hero_tpu_torch.drivers.eval_vcmr import (load_serve_opts,
                                              resolve_checkpoint)
from hero_tpu_torch.drivers.train_videoqa import (VIDEOQA, QaTask,
                                                  videoqa_eval_batches)
from hero_tpu_torch.evaluation.downstream import validate_videoqa
from hero_tpu_torch.parallel import dist
from hero_tpu_torch.utils.logger import LOGGER, configure_stdout

INIT_SEED = 0        # the JAX driver initialises from PRNGKey(0)


def load_run(args, task: QaTask, device):
    """(options, model config, parameters on ``device``, dataset) of the
    run at ``args.output_dir``: ``hps.json``, ``task``'s init from
    :data:`INIT_SEED` with ``args.checkpoint`` overlaid
    (``common.load_checkpoint_into``; a key the checkpoint lacks keeps the
    seeded init, not the JAX driver's), and ``task``'s dataset over the
    run's stores and ``args.query_txt_db`` (default the run's
    ``val_query_txt_db``)."""
    opts = load_serve_opts(args.output_dir)
    cfg = common.model_config_from_opts(opts)
    ckpt = resolve_checkpoint(args.output_dir, args.checkpoint)
    flat = common.load_checkpoint_into(task.init(cfg, seed=INIT_SEED), ckpt,
                                       cfg.f_config.vocab_size)
    params = task.load(flat, device=device)
    video_db = common.load_video_sub_dataset(opts,
                                             common.shapes_from_opts(opts))
    ds = task.dataset(video_db, args.query_txt_db or opts.val_query_txt_db,
                      opts)
    return opts, cfg, params, ds


def write_results(output_dir: str, name: str, results) -> str:
    out = os.path.join(output_dir, name)
    with open(out, "w") as f:
        json.dump({str(k): v for k, v in results.items()}, f)
    LOGGER.info("wrote %s", out)
    return out


def main(args, *, device="cuda", dtype: torch.dtype = torch.bfloat16):
    """Answer the questions with ``args.output_dir``'s run at
    ``args.checkpoint`` on ``device`` in ``dtype``
    (``hero_tpu/drivers/eval_videoqa.py:20-59``), ``val_batch_size``
    questions a batch.  On the ranks of a launch every rank answers every
    question, as the JAX program does, and the primary writes.  Returns
    (log, qid -> answer)."""
    device = dist.init_distributed(device)
    opts, cfg, params, ds = load_run(args, VIDEOQA, device)
    log, results, logits = validate_videoqa(
        params, cfg, videoqa_eval_batches(ds, getattr(opts,
                                                      "val_batch_size", 8)),
        num_answers=getattr(opts, "num_answers", 5), dtype=dtype,
        device=device)
    if not dist.is_primary():
        return log, results
    LOGGER.info("videoQA eval: %s", log)
    out = write_results(args.output_dir,
                        f"qa_results_{args.checkpoint}_all.json", results)
    if args.save_logits:
        with open(out.replace(".json", "_logits.pkl"), "wb") as f:
            pickle.dump(logits, f)
    print(json.dumps(log))
    return log, results


def base_argparser(name: str) -> argparse.ArgumentParser:
    """The run, the checkpoint and the question store: the options of
    both QA eval programs."""
    p = argparse.ArgumentParser(f"hero_tpu_torch {name}")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--query_txt_db", default=None)
    return p


def build_argparser() -> argparse.ArgumentParser:
    p = base_argparser("eval_videoqa")
    p.add_argument("--save_logits", action="store_true")
    return p


def cli():
    """The console script's entry (``hero-tpu-torch-eval-videoqa``)."""
    configure_stdout()
    main(build_argparser().parse_args())


if __name__ == "__main__":
    cli()
