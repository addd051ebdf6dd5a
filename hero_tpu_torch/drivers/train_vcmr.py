"""TVR/How2R/DiDeMo VCMR finetuning (counterpart of
``hero_tpu/drivers/train_vcmr.py``).

Only :func:`build_eval_inputs` is ported: the corpus evaluation's inputs,
which ``drivers/eval_vcmr.main`` serves from.  ``main`` (the finetune
loop) and ``run_validation`` wait for ROADMAP A5 (``forward_vcmr``,
``VcmrDataset``).
"""

from __future__ import annotations

import numpy as np

from hero_tpu_torch.data.downstream_tasks import VcmrFullEvalDataset
from hero_tpu_torch.data.video import stack_items


def build_eval_inputs(video_db, query_db, opts):
    """(video batches, query batches, sorted video ids, the global
    {video: index}, query data) for ``validate_full_vcmr``
    (``hero_tpu/drivers/train_vcmr.py:40-82``, one process).

    The global index is the sub store's for the first of the ``val``,
    ``train`` and ``test`` splits it has, else the sorted ids' order.
    Video batches hold ``opts.vcmr_eval_video_batch_size`` videos; a
    ragged last batch (after the first) is padded with zero-mask videos,
    which the scorer never ranks.  Query batches hold
    ``opts.vcmr_eval_batch_size`` queries, the last padded to that size
    (:meth:`VcmrFullEvalDataset.batches`)."""
    if hasattr(video_db.txt_db, "id2len") and video_db.txt_db.id2len:
        video_ids = sorted(video_db.txt_db.id2len.keys())
    else:
        video_ids = sorted(video_db.vids)
    video2idx_global = None
    v2i = video_db.vid2idx
    if v2i:
        # the sub store's vid2idx is {split: {vid: idx}} (vid2dur_idx.json)
        for split in ("val", "train", "test"):
            if split in v2i:
                video2idx_global = v2i[split]
                break
    if video2idx_global is None:
        video2idx_global = {v: i for i, v in enumerate(video_ids)}
    video_ids = sorted(video2idx_global.keys())

    def video_batches():
        bs = getattr(opts, "vcmr_eval_video_batch_size", 50)
        for s in range(0, len(video_ids), bs):
            items = [video_db.video_item(v) for v in video_ids[s:s + bs]]
            if len(items) < bs and s > 0:
                pad_item = {k: np.zeros_like(v) for k, v in items[0].items()}
                items.extend([pad_item] * (bs - len(items)))
            yield stack_items(items)

    full_eval = VcmrFullEvalDataset(list(query_db.id2len.keys()), query_db,
                                    video_db.shapes)
    query_batches = full_eval.batches(
        getattr(opts, "vcmr_eval_batch_size", 80))
    return (video_batches(), query_batches, video_ids, video2idx_global,
            query_db.query_data)
