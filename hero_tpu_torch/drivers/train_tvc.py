"""The TVC captioning train step (counterpart of the step that
``hero_tpu/drivers/train_tvc.py`` builds): the label-smoothed decoder loss
of ``forward_tvc`` with dropout, bf16 compute on fp32 parameters, and
``training/step.make_train_step`` with the options of
``config/train-tvc.json`` (``warmup_linear``, lr 1e-4 with ``lr_mul`` 10
on every parameter outside ``v_encoder``, warm-up 700 of 7000 steps,
betas (0.9, 0.98), weight decay 0.01, grad norm 1.0, label smoothing
0.1; the dropout rates, 0.1, come from the model config).

``main`` is not ported: it waits for the caption-store and video-store
readers (ROADMAP A3), the checkpoint saver and restorer (A4), caption-
metric validation (A3) and the device mesh (A8).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import torch

from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.data.downstream_tasks import TvcTrainDataset
from hero_tpu_torch.models import tvc as tvc_lib
from hero_tpu_torch.training.optim import AdamWConfig
from hero_tpu_torch.training.step import TrainSpec, make_train_step

TRAIN_TVC_JSON = (Path(__file__).resolve().parents[2] / "config"
                  / "train-tvc.json")


def load_train_opts(path=TRAIN_TVC_JSON) -> Dict[str, Any]:
    """The options of a TVC training run (``config/train-tvc.json``)."""
    with open(path) as f:
        return json.load(f)


def make_loss_fn(cfg: HeroConfig, lsr: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, train: bool = True):
    """``train_tvc``'s ``loss_fn(params, batch, seed)``: the summed loss over
    the caption tokens divided by their count (at least 1), dropout on
    (``train``)."""

    def loss_fn(params, batch, seed):
        s, n = tvc_lib.forward_tvc(params, cfg, batch, lsr=lsr, train=train,
                                   seed=seed, dtype=dtype)
        return s / torch.clamp(n, min=1.0), {}
    return loss_fn


def train_spec(opts: Dict[str, Any]) -> TrainSpec:
    """The step's hyper-parameters from the run's options."""
    return TrainSpec(
        learning_rate=opts["learning_rate"],
        warmup_steps=opts["warmup_steps"],
        num_train_steps=opts["num_train_steps"],
        grad_norm=opts["grad_norm"],
        lr_schedule=opts.get("lr_sched", "warmup_linear"),
        adamw=AdamWConfig(beta1=opts["betas"][0], beta2=opts["betas"][1],
                          weight_decay=opts["weight_decay"],
                          lr_mul=opts.get("lr_mul", 1.0)))


def make_tvc_train_step(cfg: HeroConfig, opts: Dict[str, Any],
                        dtype: torch.dtype = torch.bfloat16):
    """``step(state, batch, seed) -> (state, metrics)`` of TVC training."""
    return make_train_step(make_loss_fn(cfg, opts.get("lsr", 0.1), dtype),
                           train_spec(opts),
                           accum_steps=max(
                               opts.get("gradient_accumulation_steps", 1), 1))


def tvc_train_dataset(video_db, caption_db,
                      opts: Dict[str, Any]) -> TvcTrainDataset:
    """``train_tvc``'s training dataset: ``caps_per_video`` captions (2) of
    ``max_txt_len`` + 2 tokens over clips of ``max_clip_len`` frames,
    unless the options name buckets."""
    return TvcTrainDataset(
        video_db, caption_db,
        caps_per_video=opts.get("caps_per_video", 2),
        cap_len=opts.get("bucket_cap_len", opts["max_txt_len"] + 2),
        seg_len=opts.get("bucket_seg_len", opts["max_clip_len"]),
        seed=opts["seed"])
