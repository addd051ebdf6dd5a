"""TVC caption generation -> submission records (counterpart of
``hero_tpu/drivers/inf_tvc.py``'s ``generate_clip_captions``).

Every clip of a :class:`~hero_tpu_torch.data.downstream_tasks.TvcClipDataset`
is decoded exactly once, greedy or by beam search with the decoder's KV
cache, and becomes a record in the reference submission schema
``{"vid_name", "clip_id", "ts", "descs": [{"desc"}]}``.  With no
detokenizer the ids are joined by spaces.  The command-line driver
(checkpoint loading, the caption-store readers, CIDEr/BLEU scoring) is not
ported yet (ROADMAP A3, A9).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from hero_tpu_torch import resolve_device
from hero_tpu_torch.data.downstream_tasks import (TvcClipDataset,
                                                  build_tvc_clip_batch)
from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
from hero_tpu_torch.models import nn
from hero_tpu_torch.models import tvc as tvc_lib


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
