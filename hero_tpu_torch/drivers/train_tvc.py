"""TVC captioning finetune as a program (counterpart of
``hero_tpu/drivers/train_tvc.py``, on one card or several ranks):

    python -m hero_tpu_torch.drivers.train_tvc --config <json>

:func:`main` reads the sub and feature stores and the caption store
(``cap.db``, optionally ``clip.db``) from disk, loads ``opts.checkpoint``
(a JAX-layout ``.npz``, e.g. a pretraining checkpoint, which fills
``v_encoder``, or a reference ``.pt`` such as ``hero-tv-ht100.pt``,
through ``convert/torch_checkpoint``) over the seeded TVC init, resumes from
``output_dir/restore.npz`` when there is one, and trains the
label-smoothed decoder loss of ``forward_tvc`` with dropout, bf16
compute on fp32 parameters (:func:`make_tvc_train_step`: ``lr_mul`` on
every parameter outside ``v_encoder``), with checkpoints in the JAX
package's layout.  Validation captions every clip of ``clip.db`` once
with the KV-cached greedy decoder in fp32, as the JAX program does, and
scores BLEU-4/ROUGE-L/CIDEr-D against its texts
(:func:`score_clip_captions`); a caption store without ``clip.db``
decodes a few training batches in bf16 instead (:func:`generate_captions`)
and scores the token ids (:func:`score_token_captions`).  Either way the
records go to ``output_dir/tvc_gen_{step}.jsonl``.

``config/train-tvc.json``'s options: ``warmup_linear``, lr 1e-4 with
``lr_mul`` 10, warm-up 700 of 7000 steps, betas (0.9, 0.98), weight decay
0.01, grad norm 1.0, label smoothing 0.1; the dropout rates, 0.1, come
from the model config.  On several ranks ``--zero1`` and ``--pp_stages``
work as in every training program (``common.start_run``; the decoder
never pipelines).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from hero_tpu_torch import resolve_device
from hero_tpu_torch.config import opts as opts_lib
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.convert.from_jax import load_jax_tvc_params
from hero_tpu_torch.data.downstream_tasks import (TvcCaptionStore,
                                                  TvcClipDataset,
                                                  TvcTrainDataset,
                                                  build_tvc_batch)
from hero_tpu_torch.data.loader import dataset_iterator
from hero_tpu_torch.drivers import common
from hero_tpu_torch.drivers.common import train_spec
from hero_tpu_torch.drivers.inf_tvc import (cut_at_eos,
                                            generate_clip_captions)
from hero_tpu_torch.evaluation import caption_metrics as cm
from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
from hero_tpu_torch.models import nn
from hero_tpu_torch.models import tvc as tvc_lib
from hero_tpu_torch.parallel import dist
from hero_tpu_torch.training.step import TrainState, make_train_step
from hero_tpu_torch.utils.logger import LOGGER, configure_stdout

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
    (``train``); on several ranks the global batch's tokens (rule (a) of
    ``parallel/dist``)."""

    def loss_fn(params, batch, seed):
        s, n = tvc_lib.forward_tvc(params, cfg, batch, lsr=lsr, train=train,
                                   seed=seed, dtype=dtype)
        return dist.global_mean(s, n), {}
    return loss_fn


def make_tvc_train_step(cfg: HeroConfig, opts: Dict[str, Any],
                        dtype: torch.dtype = torch.bfloat16):
    """``step(state, batch, seed) -> (state, metrics)`` of TVC training."""
    return make_train_step(make_loss_fn(cfg, opts.get("lsr", 0.1), dtype),
                           train_spec(opts),
                           accum_steps=max(
                               opts.get("gradient_accumulation_steps", 1), 1),
                           zero1=bool(opts.get("zero1", False)))


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


def score_clip_captions(gen: List[dict], val_ds: TvcClipDataset
                        ) -> Dict[str, float]:
    """BLEU-4/ROUGE-L/CIDEr of generated per-clip captions against the
    clip.db GT texts (reference train_tvc.py validate -> TVCEval;
    ``hero_tpu/drivers/train_tvc.py:146-163``), rounded to 4 places."""
    gt_map = {str(cid): g for _, rows in val_ds.items
              for cid, _, g in rows if g}
    gts, res = {}, {}
    for rec in gen:
        cid = str(rec["clip_id"])
        if cid not in gt_map:
            continue
        gts[cid] = [t.split() for t in gt_map[cid]]
        res[cid] = rec["descs"][0]["desc"].split()
    if not res:
        return {}
    return {"Bleu@4": round(cm.bleu(gts, res)[3], 4),
            "ROUGE-L": round(cm.rouge_l(gts, res), 4),
            "CIDEr": round(cm.cider_d(gts, res), 4)}


def score_token_captions(gen: List[dict], cap_db) -> Dict[str, float]:
    """BLEU-4/ROUGE-L/CIDEr over token-id sequences against each caption's
    ids (``hero_tpu/drivers/train_tvc.py:166-184``: a training-time
    monitor; ``inf_tvc`` scores text against a reference jsonl), rounded
    to 4 places."""
    gts, res = {}, {}
    for rec in gen:
        cid = str(rec["clip_id"])
        gt = cap_db[cid]
        gts[cid] = [[str(t) for t in gt["input_ids"][1:]]]  # drop BOS
        res[cid] = [str(t) for t in rec["descs"][0]["desc_token_ids"]]
    if not res:
        return {}
    return {"Bleu@4": round(cm.bleu(gts, res)[3], 4),
            "ROUGE-L": round(cm.rouge_l(gts, res), 4),
            "CIDEr": round(cm.cider_d(gts, res), 4)}


def generate_captions(params, cfg: HeroConfig, dataset: TvcTrainDataset,
                      opts, n_batches: int = 4,
                      dtype: torch.dtype = torch.bfloat16,
                      device="cuda") -> List[dict]:
    """Greedy-decode the first ``n_batches`` batches of ``val_batch_size``
    videos of ``dataset`` in ``dtype`` -> one record a caption row,
    ``{"clip_id": cap id, "descs": [{"desc_token_ids"}], "vid_name"}``
    (``hero_tpu/drivers/train_tvc.py:187-217``, which decodes in bf16)."""
    device = resolve_device(device)
    params = nn.tree_to(params, device)
    bos = dataset.caption_db.bos
    eos = dataset.caption_db.eos
    out = []
    bs = min(opts.val_batch_size, len(dataset))
    for s in range(0, min(n_batches * bs, len(dataset) - bs + 1), bs):
        batch = build_tvc_batch(dataset, list(range(s, s + bs)))
        with torch.inference_mode():
            ids = tvc_lib.greedy_decode(
                params, cfg, batch_to_device(batch, device),
                max_step=getattr(opts, "max_gen_step", 30), bos=bos,
                eos=eos, dtype=dtype).cpu().numpy()
        # build_tvc_batch emits caps_per_video caption rows per video row
        caps_per_video = max(
            1, len(batch["__cap_ids__"]) // len(batch["__vids__"]))
        for ci, cap_id in enumerate(batch["__cap_ids__"]):
            out.append({"clip_id": cap_id,
                        "descs": [{"desc_token_ids":
                                   cut_at_eos(ids[ci].tolist(), eos)}],
                        "vid_name": batch["__vids__"][ci // caps_per_video]})
    return out


def init_params(opts, cfg: HeroConfig, info: Optional[Dict] = None
                ) -> Dict[str, np.ndarray]:
    """The flat JAX-layout TVC parameters a run starts from: the numpy
    init from ``opts.seed`` (``models/tvc.init_flat_tvc_params``),
    overlaid with ``opts.checkpoint`` when set (its vocab-pad marker to
    ``info["vocab_padded"]``).  A pretraining checkpoint fills
    ``v_encoder``; the decoder keeps its init."""
    flat = tvc_lib.init_flat_tvc_params(cfg, seed=opts.seed)
    if getattr(opts, "checkpoint", None):
        flat = common.load_checkpoint_into(flat, opts.checkpoint,
                                           cfg.f_config.vocab_size,
                                           info=info)
    return flat


def main(opts, device="cuda", on_step: Optional[Callable] = None,
         dtype: torch.dtype = torch.bfloat16) -> TrainState:
    """Finetune TVC as ``opts`` says (``hero_tpu/drivers/train_tvc.py:
    33-143``) on ``device`` (:func:`common.run_finetune`: ``output_dir``
    with ``log/``, ``ckpt/`` and ``restore.npz``), with
    ``tvc_gen_{step}.jsonl`` at every validation.  The step computes in
    ``dtype`` (bf16, as the JAX program; the caption-only validation
    decodes in it too) on fp32
    parameters; clip validation decodes in fp32.  Parameters the
    checkpoint lacks take the port's numpy-seeded init
    (:func:`init_params`), not ``jax.random.PRNGKey(seed)``'s, so a
    partial checkpoint trains from other weights than the JAX driver's.
    ``on_step`` as :func:`common.run_training`'s.  On several ranks the
    validation runs on each and the primary writes.  Returns the final
    train state (this rank's part: ``common.run_finetune``)."""
    hps = vars(opts)

    def prepare(cfg, device):
        if cfg.d_config is None:
            raise ValueError("TVC model_config must carry d_config")
        video_db = common.load_video_sub_dataset(
            opts, common.shapes_from_opts(opts))
        cap_db = TvcCaptionStore(opts.cap_db, max_txt_len=opts.max_txt_len)
        train_ds = tvc_train_dataset(video_db, cap_db, hps)
        LOGGER.info("tvc train: %d videos, %d caps each", len(train_ds),
                    train_ds.caps_per_video)

        def batches(taken):
            it = dataset_iterator(train_ds, build_tvc_batch,
                                  opts.train_batch_size, seed=opts.seed)
            it.skip(taken)
            for batch in it:
                yield "tvc", {k: v for k, v in batch.items()
                              if not k.startswith("__")}

        def validate(state, step):
            if cap_db.vid2clips:
                # every clip of clip.db decoded exactly once, in fp32
                val_ds = TvcClipDataset.from_caption_db(
                    video_db, cap_db,
                    clips_per_item=getattr(opts, "clips_per_item", 4),
                    seg_len=getattr(opts, "bucket_seg_len",
                                    opts.max_clip_len))
                gen = generate_clip_captions(
                    state.params, cfg, val_ds, bos=cap_db.bos,
                    eos=cap_db.eos, batch_size=opts.val_batch_size,
                    max_gen_step=getattr(opts, "max_gen_step", 30),
                    dtype=torch.float32, device=device)
                scores = score_clip_captions(gen, val_ds)
            else:
                gen = generate_captions(state.params, cfg, train_ds, opts,
                                        dtype=dtype, device=device)
                scores = score_token_captions(gen, cap_db)
            path = os.path.join(opts.output_dir, f"tvc_gen_{step}.jsonl")
            if not dist.is_primary():
                return            # every rank decoded the same captions
            with open(path, "w") as f:
                for rec in gen:
                    f.write(json.dumps(rec) + "\n")
            LOGGER.info("[step %d] wrote %d captions to %s - %s", step,
                        len(gen), path, scores)

        return common.Finetune(
            init=lambda info: init_params(opts, cfg, info=info),
            load=load_jax_tvc_params,
            step_fn=make_tvc_train_step(cfg, hps, dtype),
            batches=batches, validate=validate)

    return common.run_finetune(opts, prepare, tree="tvc", device=device,
                               on_step=on_step)


def cli():
    """The console script's entry (``hero-tpu-torch-train-tvc``)."""
    configure_stdout()
    main(opts_lib.get_tvc_args())


if __name__ == "__main__":
    cli()
