"""TVC caption generation as a program -> submission jsonl (counterpart
of ``hero_tpu/drivers/inf_tvc.py``, on one card or several ranks):

    python -m hero_tpu_torch.drivers.inf_tvc --output_dir <train dir> \
        --checkpoint <step or path> [--target_clip J] [--beam K] \
        [--reference GT] [--submission OUT]

:func:`main` reloads the run's ``log/hps.json``, overlays the JAX-layout
``.npz`` checkpoint on the seeded TVC init, reads the sub and feature
stores and the clips to caption: a raw clip jsonl (``--target_clip``,
reference TvcEvalDataset), or the ``clip.db`` of ``--target_clip_db`` or
of the run's caption store (TvcValDataset).  :func:`generate_clip_captions`
decodes every clip exactly once, greedy or by beam search with the
decoder's KV cache, into the reference submission schema ``{"vid_name",
"clip_id", "ts", "descs": [{"desc"}]}``; the program decodes in fp32, as
the JAX program does.  With a tokenizer in the local Hugging Face cache
the ids become text (:func:`detokenizer`), else they are joined by
spaces.  ``--reference`` scores the submission with ``TVCEval``
(BLEU-4, ROUGE-L, CIDEr-D, METEOR and its variant) to stdout and
``<submission>.scores.json``.
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import Callable, List, Optional

import torch

from hero_tpu_torch import resolve_device
from hero_tpu_torch.convert.from_jax import load_jax_tvc_params
from hero_tpu_torch.data.downstream_tasks import (TvcCaptionStore,
                                                  TvcClipDataset,
                                                  build_tvc_clip_batch)
from hero_tpu_torch.drivers import common
from hero_tpu_torch.drivers.eval_vcmr import (INIT_SEED, load_serve_opts,
                                              resolve_checkpoint)
from hero_tpu_torch.evaluation.caption_metrics import TVCEval
from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
from hero_tpu_torch.models import nn
from hero_tpu_torch.models import tvc as tvc_lib
from hero_tpu_torch.parallel import dist
from hero_tpu_torch.prepro.tokenize import load_roberta
from hero_tpu_torch.utils.logger import LOGGER, configure_stdout


@functools.lru_cache(maxsize=None)
def detokenizer() -> Optional[Callable]:
    """RoBERTa's ``decode`` (special tokens skipped) when ``transformers``
    and the ``roberta-base`` tokenizer files are in the local cache; else
    None, with one warning (``hero_tpu/drivers/inf_tvc.py:33-40``).  The
    files are never downloaded.  A tokenizer without roberta-base's
    vocabulary counts as unavailable: offline, ``transformers`` 5 builds
    one of its 5 special tokens alone, which decodes every caption to
    ''."""
    try:
        tok = load_roberta()
    except OSError:
        LOGGER.warning("RobertaTokenizer unavailable; emitting token ids")
        return None
    return lambda ids: tok.decode(ids, skip_special_tokens=True)


def cut_at_eos(ids, eos: int) -> List[int]:
    """The ids before the first ``eos`` (reference cut_eos)."""
    out = []
    for t in ids:
        if t == eos:
            break
        out.append(int(t))
    return out


def generate_clip_captions(params, cfg, ds: TvcClipDataset, *, bos: int,
                           eos: int, batch_size: int = 8,
                           max_gen_step: int = 30, beam: int = 1,
                           detok: Optional[Callable] = None,
                           dtype: torch.dtype = torch.bfloat16,
                           device="cuda") -> List[dict]:
    """Decode every clip in ``ds`` once -> reference submission records
    (``hero_tpu/drivers/inf_tvc.py:43-90``).

    The final partial batch is padded by repeating its last item (fixed
    batch shapes); the rows of padded clip slots and of repeated items are
    dropped by their clip ids."""
    device = resolve_device(device)
    params = nn.tree_to(params, device)
    decode_fn = tvc_lib.beam_decode if beam > 1 else tvc_lib.greedy_decode
    kwargs = {"beam": beam} if beam > 1 else {}
    records, seen = [], set()
    bs = max(1, min(batch_size, len(ds)))
    for s in range(0, len(ds), bs):
        idx = list(range(s, min(s + bs, len(ds))))
        while len(idx) < bs:       # repeat-pad tail; deduped below
            idx.append(idx[-1])
        batch = build_tvc_clip_batch(ds, idx)
        with torch.inference_mode():
            ids = decode_fn(params, cfg, batch_to_device(batch, device),
                            max_step=max_gen_step, bos=bos, eos=eos,
                            dtype=dtype, **kwargs).cpu().numpy()
        for ri, cid in enumerate(batch["__clip_ids__"]):
            if cid is None or cid in seen:
                continue           # padded clip slot / repeated tail item
            seen.add(cid)
            toks = cut_at_eos(ids[ri].tolist(), eos)
            desc = detok(toks) if detok else " ".join(map(str, toks))
            try:
                clip_id = int(cid)
            except (TypeError, ValueError):
                clip_id = cid
            records.append({"vid_name": batch["__vids__"][ri],
                            "clip_id": clip_id,
                            "ts": batch["__ts__"][ri],
                            "descs": [{"desc": desc}]})
    return records


def main(args, device="cuda", dtype: torch.dtype = torch.float32):
    """Caption ``args``' clips with ``args.output_dir``'s run at
    ``args.checkpoint`` on ``device`` in ``dtype``
    (``hero_tpu/drivers/inf_tvc.py:93-138``; fp32 as the JAX program, bf16
    for in-process callers that ask) and write the submission jsonl.
    The parameters the checkpoint lacks keep the port's seeded init, so
    a partial checkpoint serves other weights than the JAX driver's.  The
    checkpoint is a JAX-layout ``.npz`` or a reference ``.pt``.  On the
    ranks of a launch (``parallel/dist.init_distributed``) each captions
    its share of the videos and the records are gathered, rank after rank
    (``hero_tpu/drivers/inf_tvc.py:94-123``); the primary writes and
    scores, the other ranks return the gathered records.  Returns the
    ``TVCEval`` scores with ``args.reference``, else the records."""
    device = dist.init_distributed(device)
    opts = load_serve_opts(args.output_dir)
    cfg = common.model_config_from_opts(opts)
    ckpt = resolve_checkpoint(args.output_dir, args.checkpoint)
    flat = common.load_checkpoint_into(
        tvc_lib.init_flat_tvc_params(cfg, seed=INIT_SEED), ckpt,
        cfg.f_config.vocab_size)
    params = load_jax_tvc_params(flat, device=device)

    video_db = common.load_video_sub_dataset(opts,
                                             common.shapes_from_opts(opts))
    cap_db = TvcCaptionStore(args.target_clip_db or opts.cap_db,
                             max_txt_len=opts.max_txt_len)
    ds_kw = dict(clips_per_item=getattr(opts, "clips_per_item", 4),
                 seg_len=opts.max_clip_len,
                 distributed=dist.data_world() > 1, rank=dist.data_rank(),
                 world_size=dist.data_world())
    if args.target_clip:
        ds = TvcClipDataset.from_jsonl(video_db, args.target_clip, **ds_kw)
    else:
        ds = TvcClipDataset.from_caption_db(video_db, cap_db, **ds_kw)
    records = generate_clip_captions(
        params, cfg, ds, bos=cap_db.bos, eos=cap_db.eos,
        batch_size=getattr(opts, "val_batch_size", 8),
        max_gen_step=getattr(opts, "max_gen_step", 30), beam=args.beam,
        detok=detokenizer(), dtype=dtype, device=device)
    records = [r for rs in dist.data_allgather(records) for r in rs]
    if not dist.is_primary():
        return records
    with open(args.submission, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    LOGGER.info("wrote %d captions to %s", len(records), args.submission)
    if args.reference:
        scores = TVCEval(args.reference)(records)
        print(json.dumps(scores))
        # the scores beside the submission, with METEOR_variant
        with open(args.submission + ".scores.json", "w") as f:
            json.dump(scores, f, indent=2)
        return scores
    return records


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("hero_tpu_torch inf_tvc")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--target_clip", default=None,
                   help="clip jsonl to generate for (reference "
                        "--target_clip); default: clip.db of the train "
                        "caption store")
    p.add_argument("--target_clip_db", default=None)
    p.add_argument("--submission", default="tvc_submission.jsonl")
    p.add_argument("--beam", default=1, type=int)
    p.add_argument("--reference", default=None,
                   help="GT jsonl for CIDEr/BLEU/ROUGE scoring")
    return p


def cli():
    """The console script's entry (``hero-tpu-torch-inf-tvc``)."""
    configure_stdout()
    main(build_argparser().parse_args())


if __name__ == "__main__":
    cli()
