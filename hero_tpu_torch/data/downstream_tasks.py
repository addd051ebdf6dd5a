"""VCMR and VR training data, VCMR corpus-evaluation queries and TVC
caption data (copies from ``hero_tpu/data/downstream_tasks.py``; the same
inputs give the same arrays).

- :func:`get_st_ed_label`: seconds -> frame-index span.
- :class:`VcmrDataset` / :class:`VrDataset` and :func:`build_batch`: VCMR
  and VR finetuning, one query (or one video's queries) an item, with
  span targets for VCMR.
- :class:`VcmrFullEvalDataset`: the queries of the two-phase corpus
  evaluation, in fixed-size batches (``batches``).
- :class:`VideoQaDataset`: TVQA/How2QA, one question an item with a row
  a candidate answer, the ``[SEP] q [SEP] a`` tokens appended to every
  sub's text (:func:`_append_txt_to_subs`, or each packed segment's copy
  through ``video_item(vid, append_ids=...)``) and fed to the temporal
  stage, with the answer and span targets.
- :class:`ViolinDataset`: VIOLIN, one statement pair (``_0`` / ``_1``,
  :func:`get_paired_statement_id`) an item, each statement appended to
  the subs the same way, with 0/1 targets.
- :class:`TvcCaptionStore`: a TVC caption store on disk, ``cap.db`` (one
  record a caption) and optionally ``clip.db`` (one record a clip, with
  its ground-truth texts) as herostore databases, with ``meta.json``'s
  PAD/BOS/EOS and the id maps beside them; ``store[cid]`` gives
  ``input_ids`` (BOS first) and ``tgt_ids`` (EOS last) cut to
  ``max_txt_len``.
- :class:`TvcTrainDataset` and :func:`build_tvc_batch`: TVC training,
  ``caps_per_video`` caption rows per video with their clip gather
  indices, the batch flattened to caption rows with ``cap_vidx``.
- :class:`TvcClipDataset`: every clip exactly once, ``clips_per_item``
  clip rows per item, from a caption store's ``clip.db``
  (``from_caption_db``) or a clip jsonl (``from_jsonl``).
- :func:`build_tvc_clip_batch`: the backbone keys (with the four packed
  segment/position keys) plus the per-clip gather indices.
- :func:`suggest_downstream_lens`: the QA, statement, caption, segment
  and clip budgets of a task's stores, as ``bucket_*`` options.

The caption store (``vid2caps``, ``pad``/``bos``/``eos``, ``store[cid]``)
and the video store (``img_db.frame_interval``, ``video_item(vid)``, a
fresh dict of the backbone arrays of one video, and ``nframes(vid)``) are
duck-typed, so in-memory stores serve too.
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hero_tpu_torch.data.store import HeroStore, _load_json
from hero_tpu_torch.data.video import FixedShapes, pad_query, quantile_dim


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


class VcmrDataset:
    """TVR/How2R/DiDeMo moment retrieval for training (reference
    data/vcmr.py:21-124; ``hero_tpu/data/downstream_tasks.py:45-122``).
    ``sampled_by_q``: one item a query, its video and span target;
    otherwise one item a video with exactly ``max_num_query`` of its
    queries (repeat-filled by a draw seeded from ``seed`` and the
    index).  Span targets are the frame span of the query's seconds
    (:func:`get_st_ed_label`), (-1, -1) without one."""

    span_targets = True

    def __init__(self, video_ids, video_db, query_db,
                 max_num_query: int = 5, sampled_by_q: bool = True,
                 seed: int = 0):
        self.video_db = video_db
        self.query_db = query_db
        self.max_num_query = max_num_query
        self.sampled_by_q = sampled_by_q
        self.vids = list(video_ids)
        self.seed = seed
        self.frame_interval = video_db.img_db.frame_interval
        self.max_txt_len = getattr(video_db, "max_txt_len", -1)
        if video_db.vid2dur:
            self.vid2idx = video_db.vid2idx
            self.global_vid2idx = self.vid2idx
        else:
            names = sorted(video_db.img_db.name2nframe.keys())
            self.global_vid2idx = {v: i for i, v in enumerate(names)}
            self.vid2idx = {v: self.global_vid2idx[v] for v in video_ids}
        self.query_data = query_db.query_data
        if sampled_by_q:
            self.qids = list(query_db.id2len.keys())
        else:
            self.qids = []

    def __len__(self):
        return len(self.qids) if self.sampled_by_q else len(self.vids)

    def getids(self, i: int):
        if not self.sampled_by_q:
            vid = self.vids[i]
            qids = self.query_db.video2query[vid][:self.max_num_query]
            rng = random.Random(self.seed * 1_000_003 + i)
            if len(qids) < self.max_num_query:
                qids = qids + rng.sample(qids,
                                         self.max_num_query - len(qids))
            return vid, qids
        qid = self.qids[i]
        return self.query_db.query2video[qid], [qid]

    def _query_target(self, example, nframes: int):
        if not self.span_targets or example.get("target") is None:
            return (-1, -1)
        return get_st_ed_label(example["target"], nframes - 1,
                               self.frame_interval)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        vid, qids = self.getids(i)
        sp = self.video_db.shapes
        item = self.video_db.video_item(vid)
        nframes = self.video_db.nframes(vid)
        Q = len(qids)
        q_ids = np.full((Q, sp.query_len), self.query_db.pad, np.int32)
        q_mask = np.zeros((Q, sp.query_len), np.float32)
        targets = np.full((Q, 2), -1, np.int32)
        for qi, qid in enumerate(qids):
            ex = self.query_db[qid]
            ids, m = pad_query([self.query_db.cls_] + list(ex["input_ids"]),
                               sp.query_len, self.query_db.pad)
            q_ids[qi] = ids
            q_mask[qi] = m
            targets[qi] = self._query_target(ex, nframes)
        item["query_input_ids"] = q_ids
        item["query_attn_masks"] = q_mask
        item["q_mask"] = np.ones((Q,), np.float32)
        item["targets"] = targets
        item["__qids__"] = qids
        item["__vid__"] = vid
        return item


class VrDataset(VcmrDataset):
    """Video retrieval (reference data/vr.py:64-200): no span targets."""
    span_targets = False


def suggest_downstream_lens(task: str, db_dir: str, coverage: float = 0.99,
                            frame_interval: float = 1.5,
                            max_clip_len: int = 100) -> Dict[str, int]:
    """The downstream tasks' bucket lengths from their stores
    (``hero_tpu/data/downstream_tasks.py:412-477``), as the drivers'
    ``bucket_*`` options; each the ``coverage`` quantile rounded up to a
    multiple of 8:

    - ``tvqa``/``how2qa``/``videoqa``: ``bucket_query_len`` of the
      ``[SEP] q [SEP] a`` unit over every (question, answer) pair
      (reference videoQA.py:93-115), the QA input and the text appended
      to every sub row or packed segment;
    - ``violin``: ``bucket_query_len`` of ``[SEP] statement``;
    - ``tvc`` (``db_dir`` holds ``cap.db`` and ``clip.db``):
      ``bucket_cap_len`` of caption + BOS, ``bucket_seg_len`` of the
      clips' frame spans (the rounded-end rule) and ``clips_per_item`` of
      the clips a video (unrounded, at least 1)."""
    def dim(vals, lo=8, mult=8):
        return quantile_dim(vals, coverage, lo, mult)

    if task in ("videoqa", "tvqa", "how2qa"):
        store = HeroStore(db_dir)
        units = []
        for qid in _load_json(db_dir, "id2len.json", {}):
            ex = store[qid]
            q, answers = ex["input_ids"][0], ex["input_ids"][1:]
            units.extend(2 + len(q) + len(a) for a in answers)
        return {"bucket_query_len": dim(units)}
    if task == "violin":
        store = HeroStore(db_dir)
        lens = [1 + len(store[qid]["input_ids"])
                for qid in _load_json(db_dir, "id2len.json", {})]
        return {"bucket_query_len": dim(lens)}
    if task == "tvc":
        cap_dir = os.path.join(db_dir, "cap.db")
        cap = HeroStore(cap_dir)
        cap_lens, spans = [], []
        for cids in _load_json(cap_dir, "vid2caps.json", {}).values():
            for cid in cids:
                ex = cap[cid]
                cap_lens.append(len(ex["input_ids"]) + 1)
                if ex.get("ts") is not None:
                    st, ed = get_st_ed_label(ex["ts"], max_clip_len,
                                             frame_interval, round_ed=True)
                    spans.append(ed - st)
        clips = [len(c) for c in _load_json(
            os.path.join(db_dir, "clip.db"), "vid2clips.json", {}).values()]
        out = {"bucket_cap_len": dim(cap_lens),
               "bucket_seg_len": dim(spans)}
        if clips:
            out["clips_per_item"] = dim(clips, lo=1, mult=1)
        return out
    raise ValueError(f"no downstream bucket suggester for task {task!r}")


def build_batch(dataset, indices: Sequence[int],
                flatten_rows: bool = False) -> Dict[str, np.ndarray]:
    """The items at ``indices`` stacked (``hero_tpu/data/downstream_tasks.py:
    478-504``); host-side ``__*__`` fields become lists.  ``flatten_rows``
    merges a leading per-example row axis (answers, statement pairs) into
    the batch axis, (N, A, ...) -> (N*A, ...), except ``targets`` and
    ``ts_targets``."""
    items = [dataset[i] for i in indices]
    batch: Dict[str, np.ndarray] = {}
    for k in items[0]:
        if k.startswith("__"):
            batch[k] = [it[k] for it in items]
            continue
        batch[k] = np.stack([it[k] for it in items])
    if flatten_rows:
        flat = {}
        for k, v in batch.items():
            if k.startswith("__") or k in ("targets", "ts_targets"):
                flat[k] = v
            elif k in ("qa_input_ids", "qa_attn_masks", "q_input_ids",
                       "q_attn_masks") or isinstance(v, np.ndarray):
                flat[k] = v.reshape((-1,) + v.shape[2:])
            else:
                flat[k] = v
        batch = flat
    return batch


class VcmrFullEvalDataset:
    """Queries only, for the two-phase corpus evaluation (reference
    VcmrFullEvalDataset, data/vcmr.py:181-242;
    ``hero_tpu/data/downstream_tasks.py:125-175``).  The query store is
    duck-typed as ``QueryTokStore``: ``store[qid]`` -> ``input_ids``,
    ``cls_``, ``pad`` and ``query2video``; ``shapes.query_len`` is the
    padded query length (with the leading CLS).  ``distributed`` serving
    on ``world_size`` ranks keeps rank ``rank``'s queries,
    ``qids[rank::world_size]`` (``hero_tpu/data/downstream_tasks.py:
    129-136``); otherwise one process serves every query."""

    def __init__(self, qids, query_db, shapes, distributed: bool = False,
                 rank: int = 0, world_size: int = 1):
        self.query_db = query_db
        self.shapes = shapes
        self.qids = list(qids)
        if distributed and world_size > 1:
            self.qids = self.qids[rank::world_size]

    def __len__(self):
        return len(self.qids)

    def __getitem__(self, i: int):
        qid = self.qids[i]
        ex = self.query_db[qid]
        ids, mask = pad_query([self.query_db.cls_] + list(ex["input_ids"]),
                              self.shapes.query_len, self.query_db.pad)
        vid = self.query_db.query2video.get(qid, "")
        return {"query_input_ids": ids, "query_attn_masks": mask,
                "__qid__": qid, "__vid__": vid}

    def batches(self, batch_size: int, pad_to_full: bool = True):
        """Batches of ``batch_size`` queries.  ``pad_to_full`` pads the
        ragged last batch to ``batch_size`` rows of pad tokens with zero
        masks, so every batch has one shape; its ``qids`` / ``vids``
        lists keep the real length and the scorer's pad rows are sliced
        off."""
        for s in range(0, len(self), batch_size):
            items = [self[i] for i in range(s, min(s + batch_size,
                                                   len(self)))]
            ids = np.stack([it["query_input_ids"] for it in items])
            masks = np.stack([it["query_attn_masks"] for it in items])
            if pad_to_full and len(items) < batch_size:
                pad = batch_size - len(items)
                ids = np.concatenate(
                    [ids, np.full((pad,) + ids.shape[1:],
                                  self.query_db.pad, ids.dtype)])
                masks = np.concatenate(
                    [masks, np.zeros((pad,) + masks.shape[1:],
                                     masks.dtype)])
            yield {
                "qids": [it["__qid__"] for it in items],
                "vids": [it["__vid__"] for it in items],
                "query_input_ids": ids,
                "query_attn_masks": masks,
            }


class VideoQaDataset:
    """TVQA/How2QA (reference data/videoQA.py:21-199;
    ``hero_tpu/data/downstream_tasks.py:178-237``).  An item is one
    question with a leading answer axis (A rows: the video once per
    candidate answer, each with ``[SEP] q [SEP] a`` appended to its subs
    and in ``qa_input_ids``), which ``build_batch(flatten_rows=True)``
    merges into the batch axis; ``targets`` the answer index (-1 without
    one) and ``ts_targets`` the frame span of ``ts`` ((-1, -1) without
    one)."""

    def __init__(self, qids, video_db, query_db, qa_len: int = 40):
        self.video_db = video_db
        self.query_db = query_db
        self.qids = list(qids)
        self.qa_len = qa_len
        self.frame_interval = video_db.img_db.frame_interval

    def __len__(self):
        return len(self.qids)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        qid = self.qids[i]
        vid = self.query_db.query2video[qid]
        ex = self.query_db[qid]
        nframes = self.video_db.nframes(vid)
        packed = getattr(self.video_db, "pack", False)
        # pack mode re-packs per answer (unit length = sub + qa text, so
        # placements depend on the qa length); unpacked copies one base
        base = None if packed else self.video_db.video_item(vid)
        input_ids = ex["input_ids"]
        q_ids, answers = input_ids[0], input_ids[1:]
        A = len(answers)
        sp = self.video_db.shapes
        rows = []
        qa_input_ids = np.full((A, self.qa_len), self.query_db.pad,
                               np.int32)
        qa_attn_masks = np.zeros((A, self.qa_len), np.float32)
        for a_i, a_ids in enumerate(answers):
            qa = ([self.query_db.sep] + list(q_ids)
                  + [self.query_db.sep] + list(a_ids))
            ids, m = pad_query(qa, self.qa_len, self.query_db.pad)
            qa_input_ids[a_i] = ids
            qa_attn_masks[a_i] = m
            if packed:
                rows.append(self.video_db.video_item(vid, append_ids=qa))
            else:
                rows.append(_append_txt_to_subs(base, qa, sp,
                                                self.query_db.pad))
        item = {k: np.stack([r[k] for r in rows]) for k in rows[0]
                if not k.startswith("__")}  # __pack_map is host metadata
        item["qa_input_ids"] = qa_input_ids
        item["qa_attn_masks"] = qa_attn_masks
        item["targets"] = np.asarray(
            ex["target"] if ex.get("target") is not None else -1, np.int32)
        if ex.get("ts") is not None:
            st, ed = get_st_ed_label(ex["ts"], nframes - 1,
                                     self.frame_interval)
            item["ts_targets"] = np.asarray([st, ed], np.int32)
        else:
            item["ts_targets"] = np.asarray([-1, -1], np.int32)
        item["__qid__"] = qid
        item["__vid__"] = vid
        return item


def _append_txt_to_subs(base: Dict[str, np.ndarray], extra_ids: List[int],
                        sp: FixedShapes, pad: int) -> Dict[str, np.ndarray]:
    """Append query/statement tokens to every valid sub row's text
    (reference videoQA.py:93-115 / violin.py:69-85), truncating at Lt."""
    out = {k: v.copy() for k, v in base.items()}
    for row in range(sp.n_subs):
        if base["sub_mask"][row] == 0:
            continue
        used = int(base["sub_txt_mask"][row].sum())
        room = sp.txt_len - used
        take = extra_ids[:room]
        out["sub_input_ids"][row, used:used + len(take)] = take
        out["sub_txt_mask"][row, used:used + len(take)] = 1.0
    return out


def get_paired_statement_id(qid: str) -> str:
    """VIOLIN pos/neg pairing by suffix flip (reference violin.py:20-24)."""
    if qid.endswith("_0"):
        return qid[:-2] + "_1"
    return qid[:-2] + "_0"


class ViolinDataset:
    """VIOLIN entailment (reference data/violin.py:27-170;
    ``hero_tpu/data/downstream_tasks.py:263-304``).  An item is the
    statement and its pair (leading axis 2): the video once per
    statement with ``[SEP] s`` appended to its subs and in
    ``q_input_ids``, ``targets`` 1 for a true statement, else 0, and the
    host list ``__qids__``."""

    def __init__(self, qids, video_db, query_db, stmt_len: int = 40):
        self.video_db = video_db
        self.query_db = query_db
        self.stmt_len = stmt_len
        self.qids = list(qids)

    def __len__(self):
        return len(self.qids)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        qid = self.qids[i]
        qids = [qid, get_paired_statement_id(qid)]
        vid = self.query_db.query2video[qids[0]]
        packed = getattr(self.video_db, "pack", False)
        base = None if packed else self.video_db.video_item(vid)
        sp = self.video_db.shapes
        rows, stmts, masks, targets = [], [], [], []
        for q in qids:
            ex = self.query_db[q]
            stmt = [self.query_db.sep] + list(ex["input_ids"])
            ids, m = pad_query(stmt, self.stmt_len, self.query_db.pad)
            stmts.append(ids)
            masks.append(m)
            targets.append(1 if ex.get("target") else 0)
            if packed:
                rows.append(self.video_db.video_item(vid,
                                                     append_ids=stmt))
            else:
                rows.append(_append_txt_to_subs(base, stmt, sp,
                                                self.query_db.pad))
        item = {k: np.stack([r[k] for r in rows]) for k in rows[0]
                if not k.startswith("__")}  # __pack_map is host metadata
        item["q_input_ids"] = np.stack(stmts)
        item["q_attn_masks"] = np.stack(masks)
        item["targets"] = np.asarray(targets, np.int32)
        item["__qids__"] = qids
        item["__vid__"] = vid
        return item


class TvcCaptionStore:
    """cap.db/clip.db over herostore dirs (reference CaptionTokLmdb,
    data/tvc.py:25-69; ``hero_tpu/data/downstream_tasks.py:310-353``)."""

    def __init__(self, db_dir: str, max_txt_len: int = -1):
        self.cap_db = HeroStore(os.path.join(db_dir, "cap.db"))
        self.clip_db = (HeroStore(os.path.join(db_dir, "clip.db"))
                        if os.path.exists(
                            os.path.join(db_dir, "clip.db", "index.bin"))
                        else None)
        meta = _load_json(db_dir, "meta.json", {})
        self.pad = meta.get("PAD", 1)
        self.bos = meta.get("BOS", 0)
        self.eos = meta.get("EOS", 2)
        self.max_txt_len = max_txt_len
        self.cap2vid = _load_json(os.path.join(db_dir, "cap.db"),
                                  "cap2vid.json", {})
        self.vid2caps = _load_json(os.path.join(db_dir, "cap.db"),
                                   "vid2caps.json", {})
        self.vid2clips = _load_json(os.path.join(db_dir, "clip.db"),
                                    "vid2clips.json", {})
        self.clip2vid = _load_json(os.path.join(db_dir, "clip.db"),
                                   "clip2vid.json", {})

    def get_clip(self, clip_id: str):
        """Clip record: {vid_name, ts, captions: [{id, text}]}
        (reference CaptionTokLmdb.get_clip, data/tvc.py:51-53)."""
        assert self.clip_db is not None, "no clip.db in this caption store"
        return dict(self.clip_db[clip_id])

    def __getitem__(self, cid: str):
        d = dict(self.cap_db[cid])
        cap = list(d["input_ids"])
        input_ids = [self.bos] + cap
        tgt_ids = cap + [self.eos]
        if self.max_txt_len != -1:
            input_ids = input_ids[:self.max_txt_len]
            tgt_ids = tgt_ids[:self.max_txt_len]
        d["input_ids"] = input_ids
        d["tgt_ids"] = tgt_ids
        return d


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

    @classmethod
    def from_caption_db(cls, video_db, caption_db: TvcCaptionStore,
                        **kw) -> "TvcClipDataset":
        """Validation source: clip.db GT captions (reference TvcValDataset,
        data/tvc.py:164-219)."""
        clips = []
        for vid, cids in caption_db.vid2clips.items():
            for cid in cids:
                ex = caption_db.get_clip(cid)
                gts = [c["text"] for c in ex.get("captions", [])] or None
                clips.append((vid, cid, ex["ts"], gts))
        return cls(video_db, clips, **kw)

    @classmethod
    def from_jsonl(cls, video_db, path: str, **kw) -> "TvcClipDataset":
        """Submission source: raw clip jsonl {vid_name, clip_id, ts[,descs]}
        (reference TvcEvalDataset, data/tvc.py:221-291)."""
        clips = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                ex = json.loads(line)
                gts = ([d.get("desc") for d in ex["descs"]]
                       if ex.get("descs") else None)
                clips.append((ex["vid_name"], str(ex["clip_id"]),
                              ex["ts"], gts))
        return cls(video_db, clips, **kw)

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
