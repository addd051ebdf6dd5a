"""Full-corpus VCMR inference as a program (counterpart of
``hero_tpu/drivers/eval_vcmr.py``, on one card or several ranks):

    python -m hero_tpu_torch.drivers.eval_vcmr --output_dir <train dir> \
        --checkpoint <step or path> [--query_txt_db <db>] [--split val]

reloads the run's ``log/hps.json`` as the serving options (reference
eval_vcmr.py:56-58), initialises the model from a seed and overlays the
checkpoint (a JAX-layout ``.npz`` or a reference ``.pt``), reads the sub
(none for a ``*_video_only`` task), feature and query stores the options
name, runs ``validate_full_vcmr`` (with ``pack_queries`` and
``corpus_chunk_videos`` as the options set them) and writes the
reference-schema submission to ``results_{ckpt}_{split}_all.json``
beside the run, printing the metrics.  Launched on several ranks
(``torchrun --nproc_per_node N -m hero_tpu_torch.drivers.eval_vcmr ...``)
every rank embeds its share of the corpus and, with the run's
``distributed_eval``, scores its share of the queries; the primary
writes the merged submission and prints.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from hero_tpu_torch.convert.from_jax import load_jax_params
from hero_tpu_torch.data.store import QueryTokStore
from hero_tpu_torch.drivers import common
from hero_tpu_torch.drivers.train_vcmr import build_eval_inputs
from hero_tpu_torch.evaluation.vcmr_eval import validate_full_vcmr
from hero_tpu_torch.models import pretrain as pretrain_lib
from hero_tpu_torch.parallel import dist
from hero_tpu_torch.utils.logger import LOGGER, configure_stdout
from hero_tpu_torch.utils.misc import Struct

INIT_SEED = 0        # the JAX driver initialises from PRNGKey(0)


def load_serve_opts(output_dir: str, **overrides) -> Struct:
    """The train-time options (``output_dir/log/hps.json``) with
    ``overrides`` applied."""
    with open(os.path.join(output_dir, "log", "hps.json")) as f:
        hps = json.load(f)
    hps.update(overrides)
    return Struct(hps)


def resolve_checkpoint(output_dir: str, checkpoint: str) -> str:
    """``checkpoint`` if it is a path, else the run's
    ``ckpt/model_step_{checkpoint}.npz``."""
    if os.path.exists(checkpoint):
        return checkpoint
    return os.path.join(output_dir, "ckpt",
                        f"model_step_{checkpoint}.npz")


def main(args, *, query_store_cls=QueryTokStore, full_eval_tasks=None,
         device="cuda", dtype: torch.dtype = torch.bfloat16):
    """Serve ``args.output_dir``'s run at ``args.checkpoint`` on
    ``device`` in ``dtype`` (``hero_tpu/drivers/eval_vcmr.py:41-83``).
    ``query_store_cls`` / ``full_eval_tasks`` select the VR variant (the
    MSR-VTT query store, VR only).  A ``*_video_only`` task's run serves
    from its feature store alone (``common.load_task_video_dataset``, as
    its training validated; the JAX driver opens a sub store for every
    task).  The parameters the checkpoint lacks
    keep their seeded init, so a partial checkpoint serves other weights
    than the JAX driver's.  The checkpoint is a JAX-layout ``.npz`` or a
    reference ``.pt`` (``common.load_checkpoint_into``).
    On the ranks of a launch (``parallel/dist.init_distributed``) every
    rank returns the merged metrics and submission; the primary writes.
    Returns (metrics, submission)."""
    device = dist.init_distributed(device)
    opts = load_serve_opts(args.output_dir)
    if args.nms_thd is not None:
        opts.nms_thd = args.nms_thd
    if full_eval_tasks is not None:
        opts.full_eval_tasks = list(full_eval_tasks)
    cfg = common.model_config_from_opts(opts)
    vsm = common.vsm_config_from_opts(opts)
    ckpt = resolve_checkpoint(args.output_dir, args.checkpoint)
    flat = common.load_checkpoint_into(
        pretrain_lib.init_flat_params(cfg, vsm, seed=INIT_SEED), ckpt,
        cfg.f_config.vocab_size)
    params = load_jax_params(flat, device=device, heads=False)

    shapes = common.shapes_from_opts(opts).replace(n_queries=1)
    video_db = common.load_task_video_dataset(opts, shapes)
    qdb_path = args.query_txt_db or getattr(opts, "val_query_txt_db")
    query_db = query_store_cls(qdb_path, max_txt_len=opts.max_txt_len)
    try:
        vb, qb, video_ids, v2i, qdata = build_eval_inputs(video_db,
                                                          query_db, opts)
        val_log, submission, metrics = validate_full_vcmr(
            params, cfg, vsm, common.eval_opts_from(opts), vb, qb,
            video_ids, v2i, qdata, dtype=dtype, device=device,
            distributed=bool(getattr(opts, "distributed_eval", False)))
    finally:
        for store in (video_db.txt_db, video_db.img_db, query_db):
            if hasattr(store, "store"):   # a video-only txt_db has none
                store.store.close()
    tag = os.path.basename(ckpt).replace("model_step_", "").replace(
        ".npz", "").replace(".pt", "")
    out_path = os.path.join(args.output_dir,
                            f"results_{tag}_{args.split}_all.json")
    if not dist.is_primary():
        return metrics, submission
    with open(out_path, "w") as f:
        json.dump(submission, f)
    LOGGER.info("wrote %s", out_path)
    if metrics:
        print(json.dumps(metrics, indent=2, default=float))
    return metrics, submission


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("hero_tpu_torch eval_vcmr")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--query_txt_db", default=None)
    p.add_argument("--split", default="val")
    p.add_argument("--nms_thd", default=None, type=float)
    return p


def cli():
    """The console script's entry (``hero-tpu-torch-eval-vcmr``)."""
    configure_stdout()
    main(build_argparser().parse_args())


if __name__ == "__main__":
    cli()
