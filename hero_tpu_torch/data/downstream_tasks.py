"""TVC caption-generation data (copies from
``hero_tpu/data/downstream_tasks.py``; the same inputs give the same
arrays).

- :func:`get_st_ed_label`: seconds -> frame-index span.
- :class:`TvcTrainDataset` and :func:`build_tvc_batch`: TVC training,
  ``caps_per_video`` caption rows per video with their clip gather
  indices, the batch flattened to caption rows with ``cap_vidx``.  The
  caption store is duck-typed as ``TvcCaptionStore``: ``vid2caps``,
  ``pad``/``bos``/``eos`` and ``store[cid]`` -> ``input_ids`` (BOS
  first), ``tgt_ids`` (EOS last), ``ts``; the herostore reader waits for
  the herostore readers.
- :class:`TvcClipDataset`: every clip exactly once, ``clips_per_item``
  clip rows per item.  The caption-store and jsonl readers
  (``from_caption_db``, ``from_jsonl``) wait for the herostore readers.
- :func:`build_tvc_clip_batch`: the backbone keys (with the four packed
  segment/position keys) plus the per-clip gather indices.

The video store is duck-typed: ``img_db.frame_interval``,
``video_item(vid)`` (a fresh dict of the backbone arrays of one video) and
``nframes(vid)``.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def get_st_ed_label(ts, max_idx: int, frame_interval: float,
                    round_ed: bool = False) -> Tuple[int, int]:
    """sec -> frame-index span (reference vcmr.py:107-124; TVC uses the
    round() end rule, tvc.py:128-140)."""
    st = min(math.floor(ts[0] / frame_interval), max_idx)
    if round_ed:
        ed = min(max(round(ts[1] / frame_interval), st + 1), max_idx)
    else:
        ed = min(max(math.ceil(ts[1] / frame_interval) - 1, st + 1),
                 max_idx)
    return st, ed


class TvcTrainDataset:
    """TVC captioning (reference TvcTrainDataset, data/tvc.py:72-161).

    Fixed shape: exactly ``caps_per_video`` captions per item (sample or
    repeat-fill), segment gather indices of length ``seg_len``."""

    def __init__(self, video_db, caption_db, caps_per_video: int = 2,
                 cap_len: int = 32, seg_len: int = 48, seed: int = 0):
        self.video_db = video_db
        self.caption_db = caption_db
        self.caps_per_video = caps_per_video
        self.cap_len = cap_len
        self.seg_len = seg_len
        self.seed = seed
        self.vids = list(caption_db.vid2caps.keys())
        self.frame_interval = video_db.img_db.frame_interval

    def __len__(self):
        return len(self.vids)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = random.Random(self.seed * 1_000_003 + i)
        vid = self.vids[i]
        cap_ids = list(self.caption_db.vid2caps[vid])
        if len(cap_ids) > self.caps_per_video:
            cap_ids = rng.sample(cap_ids, self.caps_per_video)
        while len(cap_ids) < self.caps_per_video:
            cap_ids.append(cap_ids[-1])
        item = self.video_db.video_item(vid)
        nframes = self.video_db.nframes(vid)
        C, Lt, Lv = self.caps_per_video, self.cap_len, self.seg_len
        cap_input_ids = np.full((C, Lt), self.caption_db.pad, np.int32)
        cap_tgt_ids = np.full((C, Lt), -1, np.int32)
        seg_idx = np.zeros((C, Lv), np.int32)
        seg_mask = np.zeros((C, Lv), np.float32)
        for ci, cid in enumerate(cap_ids):
            ex = self.caption_db[cid]
            st, ed = get_st_ed_label(ex["ts"], nframes,
                                     self.frame_interval, round_ed=True)
            n = min(ed - st, Lv)
            seg_idx[ci, :n] = np.arange(st, st + n)
            seg_mask[ci, :n] = 1.0
            ids = ex["input_ids"][:Lt]
            tgts = ex["tgt_ids"][:Lt]
            cap_input_ids[ci, :len(ids)] = ids
            cap_tgt_ids[ci, :len(tgts)] = tgts
        item["cap_input_ids"] = cap_input_ids
        item["cap_tgt_ids"] = cap_tgt_ids
        item["seg_idx"] = seg_idx
        item["seg_mask"] = seg_mask
        item["__cap_ids__"] = cap_ids
        item["__vid__"] = vid
        return item


class TvcClipDataset:
    """Per-clip TVC generation dataset: every clip appears EXACTLY once
    (reference TvcValDataset / TvcEvalDataset, data/tvc.py:164-291).

    Each item is one video with a fixed width of ``clips_per_item`` clip
    rows; videos with more clips span several items, fewer are padded with
    masked rows.  Per-clip meta (``__clip_ids__``/``__ts__``/``__gts__``)
    carries ``None`` in padded slots so callers can drop them.
    """

    def __init__(self, video_db,
                 clips: Sequence[Tuple[str, str, Sequence[float],
                                       Optional[List[str]]]],
                 clips_per_item: int = 4, seg_len: int = 48,
                 distributed: bool = False, rank: int = 0,
                 world_size: int = 1):
        """``clips``: (vid, clip_id, ts, gt_texts-or-None) in corpus order."""
        self.video_db = video_db
        self.clips_per_item = clips_per_item
        self.seg_len = seg_len
        self.frame_interval = video_db.img_db.frame_interval
        by_vid: Dict[str, list] = {}
        for vid, cid, ts, gts in clips:
            by_vid.setdefault(vid, []).append((cid, ts, gts))
        vids = list(by_vid.keys())
        if distributed and world_size > 1:
            vids = vids[rank::world_size]  # reference rank-slicing
        self.items = []
        for vid in vids:
            rows = by_vid[vid]
            for s in range(0, len(rows), clips_per_item):
                self.items.append((vid, rows[s:s + clips_per_item]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        vid, rows = self.items[i]
        item = self.video_db.video_item(vid)
        nframes = self.video_db.nframes(vid)
        C, Lv = self.clips_per_item, self.seg_len
        seg_idx = np.zeros((C, Lv), np.int32)
        seg_mask = np.zeros((C, Lv), np.float32)
        clip_ids: List[Optional[str]] = [None] * C
        tss: List[Optional[list]] = [None] * C
        gts: List[Optional[List[str]]] = [None] * C
        for ci, (cid, ts, gt) in enumerate(rows):
            st, ed = get_st_ed_label(ts, nframes, self.frame_interval,
                                     round_ed=True)
            n = min(ed - st, Lv)
            seg_idx[ci, :n] = np.arange(st, st + n)
            seg_mask[ci, :n] = 1.0
            clip_ids[ci], tss[ci], gts[ci] = cid, list(ts), gt
        item["seg_idx"] = seg_idx
        item["seg_mask"] = seg_mask
        item["__clip_ids__"] = clip_ids
        item["__ts__"] = tss
        item["__gts__"] = gts
        item["__vid__"] = vid
        return item


VIDEO_KEYS = ("sub_input_ids", "sub_txt_mask", "sub_frame_idx",
              "sub_frame_mask", "sub_mask", "c_v_feats", "c_attn_masks",
              # packed extras: dropping these would silently run UNPACKED
              # attention over packed rows (cross-sub leakage);
              # forward_repr keys on sub_txt_seg's presence
              "sub_txt_seg", "sub_frame_seg", "sub_txt_pos", "sub_frame_pos")


def build_tvc_clip_batch(dataset: TvcClipDataset,
                         indices: Sequence[int]) -> Dict[str, np.ndarray]:
    """Per-clip generation batch: the backbone keys of each item's video,
    the clips' ``seg_idx``/``seg_mask`` and ``cap_vidx``, and the host
    meta lists (decoding starts at BOS, so no caption inputs)."""
    items = [dataset[i] for i in indices]
    batch = {}
    for k in VIDEO_KEYS:
        if k not in items[0]:
            continue
        batch[k] = np.stack([it[k] for it in items])
    C = dataset.clips_per_item
    for k in ("seg_idx", "seg_mask"):
        batch[k] = np.concatenate([it[k] for it in items], 0)
    batch["cap_vidx"] = np.repeat(np.arange(len(items), dtype=np.int32), C)
    batch["__clip_ids__"] = [c for it in items for c in it["__clip_ids__"]]
    batch["__ts__"] = [t for it in items for t in it["__ts__"]]
    batch["__gts__"] = [g for it in items for g in it["__gts__"]]
    batch["__vids__"] = [it["__vid__"] for it in items for _ in range(C)]
    return batch


def build_tvc_batch(dataset: TvcTrainDataset,
                    indices: Sequence[int]) -> Dict[str, np.ndarray]:
    """TVC training batch: the backbone keys of each item's video (with the
    packed segment/position keys), its caption rows flattened to
    (len(indices) * caps_per_video, ...) and ``cap_vidx``."""
    items = [dataset[i] for i in indices]
    batch = {}
    for k in VIDEO_KEYS:
        if k not in items[0]:
            continue
        batch[k] = np.stack([it[k] for it in items])
    C = dataset.caps_per_video
    for k in ("cap_input_ids", "cap_tgt_ids", "seg_idx", "seg_mask"):
        batch[k] = np.concatenate([it[k] for it in items], 0)
    batch["cap_vidx"] = np.repeat(np.arange(len(items), dtype=np.int32), C)
    batch["__cap_ids__"] = [c for it in items for c in it["__cap_ids__"]]
    batch["__vids__"] = [it["__vid__"] for it in items]
    return batch
