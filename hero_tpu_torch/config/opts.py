"""Options: argparse plus a JSON config (a copy of the pretraining, VCMR,
VideoQA, VIOLIN and TVC parts of ``hero_tpu/config/opts.py``).

``--config`` names a JSON file; each of its keys becomes an attribute
unless the same flag was given on the command line (the command line
wins), and keys no flag declares are attached as they are.  A config read
here gives the namespace the JAX driver reads
(``config/pretrain-tv.json`` included).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


def parse_with_config(parser: argparse.ArgumentParser,
                      argv: Optional[list] = None) -> argparse.Namespace:
    args = parser.parse_args(argv)
    if args.config is not None:
        with open(args.config) as f:
            config_args = json.load(f)
        cli = argv if argv is not None else sys.argv[1:]
        override_keys = {a[2:].split("=")[0] for a in cli
                         if a.startswith("--")}
        for k, v in config_args.items():
            if k not in override_keys:
                setattr(args, k, v)
    del args.config
    return args


def base_parser(desc: str = "hero_tpu_torch") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--config", default=None, type=str)
    # model / checkpoint
    p.add_argument("--model_config", default=None, type=str)
    p.add_argument("--checkpoint", default=None, type=str)
    p.add_argument("--output_dir", default=None, type=str)
    # data
    p.add_argument("--sub_txt_db", default=None, type=str)
    p.add_argument("--vfeat_db", default=None, type=str)
    p.add_argument("--train_query_txt_db", default=None, type=str)
    p.add_argument("--val_query_txt_db", default=None, type=str)
    p.add_argument("--test_query_txt_db", default=None, type=str)
    p.add_argument("--compressed_db", action="store_true")
    p.add_argument("--max_clip_len", default=100, type=int)
    p.add_argument("--max_txt_len", default=60, type=int)
    p.add_argument("--vfeat_interval", default=1.5, type=float)
    p.add_argument("--vfeat_version", default="resnet_slowfast", type=str)
    p.add_argument("--sub_ctx_len", default=0, type=int)
    # training
    p.add_argument("--train_batch_size", default=16, type=int)
    p.add_argument("--val_batch_size", default=20, type=int)
    p.add_argument("--gradient_accumulation_steps", default=1, type=int)
    p.add_argument("--learning_rate", default=3e-5, type=float)
    p.add_argument("--lr_mul", default=1.0, type=float)
    p.add_argument("--valid_steps", default=1000, type=int)
    p.add_argument("--save_steps", default=1000, type=int)
    p.add_argument("--num_train_steps", default=100000, type=int)
    p.add_argument("--optim", default="adamw", type=str)
    p.add_argument("--betas", default=[0.9, 0.98], nargs="+", type=float)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--weight_decay", default=0.01, type=float)
    p.add_argument("--grad_norm", default=2.0, type=float)
    p.add_argument("--warmup_steps", default=4000, type=int)
    p.add_argument("--lr_sched", default="warmup_linear",
                   choices=["warmup_linear", "noam", "vqa"])
    # the JAX package's multi-device options: --zero1 shards the AdamW
    # moments over the ranks of a plain data-parallel world (in a world of
    # 1 it is the replicated step), --pp_stages S splits the ranks into
    # pipeline stages of S with --pp_microbatches micro-batches
    # (parallel/pipeline.driver_grid)
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--pp_stages", default=1, type=int)
    p.add_argument("--pp_microbatches", default=2, type=int)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--fp16", action="store_true",
                   help="accepted for config compatibility; the port "
                        "trains in bf16")
    p.add_argument("--n_workers", default=4, type=int)
    p.add_argument("--pin_mem", action="store_true")
    # bucket shapes (fixed-shape pipeline)
    p.add_argument("--bucket_n_subs", default=0, type=int,
                   help="f-encoder rows per video; 0 = auto (32, or 8 "
                        "packed rows with --pack_subs)")
    p.add_argument("--bucket_frames_per_sub", default=16, type=int)
    p.add_argument("--bucket_query_len", default=32, type=int)
    p.add_argument("--bucket_max_masked", default=0, type=int,
                   help="MLM mask slots per sub row; 0 = auto-size from "
                        "--mask_prob + binomial tail (mlm_row_cap) so no "
                        "masked position is silently dropped")
    p.add_argument("--corpus_chunk_videos", default=0, type=int,
                   help="full-corpus eval: score the corpus in chunks of "
                        "this many videos (0 = the whole corpus resident)")
    p.add_argument("--second_bucket", action="store_true",
                   help="route videos the primary bucket would truncate "
                        "to a second, larger bucket (pretrain)")
    p.add_argument("--pack_subs", action="store_true",
                   help="pack several subs per f-encoder row behind a "
                        "block-diagonal segment mask")
    p.add_argument("--pack_queries", action="store_true",
                   help="corpus eval phase 2: pack several queries per "
                        "encoder row")
    return p


def add_vsm_args(p: argparse.ArgumentParser):
    p.add_argument("--lw_neg_q", default=0.0, type=float)
    p.add_argument("--lw_neg_ctx", default=0.0, type=float)
    p.add_argument("--lw_st_ed", default=0.01, type=float)
    p.add_argument("--ranking_loss_type", default="hinge", type=str)
    p.add_argument("--margin", default=0.1, type=float)
    p.add_argument("--hard_pool_size", default=[20], nargs="+", type=int)
    p.add_argument("--hard_neg_weights", default=[10], nargs="+",
                   type=float)
    p.add_argument("--hard_negtiave_start_step", default=[20000],
                   nargs="+", type=int)  # (sic) reference spelling
    p.add_argument("--train_span_start_step", default=0, type=int)
    p.add_argument("--use_all_neg", default=True, type=bool)
    p.add_argument("--drop_svmr_prob", default=0.0, type=float)
    return p


def add_eval_args(p: argparse.ArgumentParser):
    p.add_argument("--eval_with_query_type", default=True, type=bool)
    p.add_argument("--max_before_nms", default=200, type=int)
    p.add_argument("--max_after_nms", default=100, type=int)
    # on several ranks each scores its share of the queries
    # (evaluation/vcmr_eval.validate_full_vcmr's ``distributed``)
    p.add_argument("--distributed_eval", action="store_true")
    p.add_argument("--nms_thd", default=-1.0, type=float)
    p.add_argument("--q2c_alpha", default=20.0, type=float)
    p.add_argument("--max_vcmr_video", default=100, type=int)
    p.add_argument("--full_eval_tasks", default=["VCMR", "SVMR", "VR"],
                   nargs="+", type=str)
    p.add_argument("--min_pred_l", default=2, type=int)
    p.add_argument("--max_pred_l", default=16, type=int)
    p.add_argument("--vcmr_eval_video_batch_size", default=50, type=int)
    p.add_argument("--vcmr_eval_batch_size", default=80, type=int)
    return p


def get_vcmr_args(argv=None):
    p = base_parser("HERO VCMR finetuning (TVR/How2R/DiDeMo)")
    add_vsm_args(p)
    add_eval_args(p)
    p.add_argument("--task", default="tvr", type=str)
    return parse_with_config(p, argv)


get_vr_args = get_vcmr_args


def get_videoqa_args(argv=None):
    p = base_parser("HERO VideoQA finetuning (TVQA/How2QA)")
    add_eval_args(p)
    p.add_argument("--task", default="tvqa", type=str)
    p.add_argument("--lw_st_ed", default=0.4, type=float)
    p.add_argument("--num_answers", default=5, type=int)
    return parse_with_config(p, argv)


def get_violin_args(argv=None):
    p = base_parser("HERO VIOLIN finetuning")
    p.add_argument("--task", default="violin", type=str)
    return parse_with_config(p, argv)


def get_tvc_args(argv=None):
    p = base_parser("HERO TVC captioning")
    p.add_argument("--task", default="tvc", type=str)
    p.add_argument("--cap_db", default=None, type=str)
    p.add_argument("--lsr", default=0.1, type=float)
    p.add_argument("--max_gen_step", default=30, type=int)
    p.add_argument("--max_cap_per_vid", default=-1, type=int)
    return parse_with_config(p, argv)


def get_pretrain_args(argv=None):
    p = base_parser("HERO pretraining")
    add_vsm_args(p)
    p.add_argument("--targets", default=[], nargs="+")
    p.add_argument("--targets_ratio", default=[], nargs="+", type=int)
    p.add_argument("--mask_prob", default=0.15, type=float)
    p.add_argument("--query_per_video", default=5, type=int)
    return parse_with_config(p, argv)
