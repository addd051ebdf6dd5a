"""The video + subtitle dataset, and the video-only one, as fixed-shape
numpy structs (a copy of ``hero_tpu/data/video.py``: the same stores give
the same arrays).

Every video becomes one struct of the backbone batch arrays
(``models/model.py``); per-sub frame features are not duplicated, only
the (S, Fs) frame-index arrays are built, and the model gathers the
features.  With ``pack=True`` the shapes are row capacities and several
subs share a row behind segment ids (``data/packing.py``).

The stores are duck-typed, so no store reader is imported:

- the sub store (``txt_db``): ``id2len`` {vid: n_frames} (its keys are
  the videos), ``vid2dur``, ``vid2idx``, ``vid_sub2frame`` {vid: [(sub
  index, [frame, ...]), ...]}, the token ids ``sep``, ``pad``, ``cls_``,
  ``mask`` and the sampling range ``v_range`` (lo, hi), ``store[vid]`` ->
  {"input_ids": [[token, ...] per sub]}, and optionally
  ``vid2sub_lens`` {vid: [tokens per sub]};
- the feature store (``img_db``): ``store[vid]`` -> (n_frames, vdim)
  float16 features and ``name2nframe`` {vid: n_frames}.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from hero_tpu_torch.const import VFEAT_DIM
from hero_tpu_torch.data.packing import pack_subs

LOGGER = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class FixedShapes:
    """Bucket sizes for one step shape."""
    n_subs: int = 32           # S
    txt_len: int = 64          # Lt (incl. leading SEP)
    frames_per_sub: int = 16   # Fs
    n_frames: int = 100        # F (= max_clip_len)
    n_queries: int = 5         # Q (VSM/VCMR video-sampled)
    query_len: int = 32        # Lq (incl. leading CLS)
    max_masked: int = 10       # M (MLM positions per sub)
    vfeat_dim: int = VFEAT_DIM

    def replace(self, **kw) -> "FixedShapes":
        return dataclasses.replace(self, **kw)


def scan_shape_stats(sub_store, max_txt_len: int = 60,
                     sub_ctx_len: int = 0) -> Dict[str, np.ndarray]:
    """Corpus-wide size distributions for bucket selection:
    ``subs_per_video``, ``frames_per_video``, per-sub ``tokens_per_row``
    (the [SEP] + context-window row :meth:`VideoFeatSubTokDataset.
    sub_tokens` builds) and ``frames_per_sub``."""
    subs_pv, frames_pv, toks_pr, frames_ps = [], [], [], []
    sidecar = getattr(sub_store, "vid2sub_lens", None)
    for vid, sub2frames in sub_store.vid_sub2frame.items():
        subs_pv.append(len(sub2frames))
        frames_pv.append(sub_store.id2len.get(vid, 0))
        lens = None
        for sub_idx, frames in sub2frames:
            frames_ps.append(len(frames))
            if lens is None:
                lens = _sub_row_lens(sub_store, sidecar, vid, max_txt_len)
            toks_pr.append(_row_tokens(lens, sub_idx, sub_ctx_len))
    return {"subs_per_video": np.asarray(subs_pv),
            "frames_per_video": np.asarray(frames_pv),
            "tokens_per_row": np.asarray(toks_pr),
            "frames_per_sub": np.asarray(frames_ps)}


def suggest_shapes(sub_store, coverage: float = 0.99,
                   max_txt_len: int = 60, sub_ctx_len: int = 0,
                   base: Optional[FixedShapes] = None,
                   append_len: int = 0) -> FixedShapes:
    """A bucket sized so >= ``coverage`` of each dimension fits untruncated
    (dims rounded up to a multiple of 8).  ``append_len``: extra per-row
    text budget for tasks that append tokens to every sub row."""
    base = base or FixedShapes()
    st = scan_shape_stats(sub_store, max_txt_len, sub_ctx_len)

    def dim(arr, lo):
        return quantile_dim(arr, coverage, lo)

    return base.replace(
        n_subs=dim(st["subs_per_video"], 8),
        txt_len=dim(st["tokens_per_row"] + append_len, 16),
        frames_per_sub=dim(st["frames_per_sub"], 8),
        n_frames=max(base.n_frames, dim(st["frames_per_video"], 8)))


def suggest_packed_shapes(sub_store, coverage: float = 0.99,
                          max_txt_len: int = 60, sub_ctx_len: int = 0,
                          base: Optional[FixedShapes] = None,
                          max_rows: int = 32,
                          append_len: int = 0) -> FixedShapes:
    """A ``--pack_subs`` bucket (row capacities) sized from the corpus
    (``hero_tpu/data/video.py:102-168``): the cheapest (rows, txt_len,
    frames_per_sub) by row-slot area for which >= ``coverage`` of the
    videos pack with nothing dropped under :func:`pack_subs`.  Text
    budgets are 1-4 times the per-sub quantile row, frame budgets the
    per-sub quantile and its double, dims multiples of 8, as
    :func:`suggest_shapes`; :func:`suggest_shapes` when nothing reaches
    the coverage.  ``append_len``: text a packed segment carries on top
    (VideoQA/VIOLIN append their tokens to every segment)."""
    base = base or FixedShapes()
    sidecar = getattr(sub_store, "vid2sub_lens", None)
    per_video, frames_pv, all_toks, all_fs = [], [], [], []
    for vid, sub2frames in sub_store.vid_sub2frame.items():
        lens = _sub_row_lens(sub_store, sidecar, vid, max_txt_len)
        rows = []
        for sub_idx, frames in sub2frames:
            n = append_len + _row_tokens(lens, sub_idx, sub_ctx_len)
            rows.append((n, len(frames)))
            all_toks.append(n)
            all_fs.append(len(frames))
        per_video.append(rows)
        frames_pv.append(sub_store.id2len.get(vid, 0))
    if not per_video:
        return base

    def dim(arr, lo):
        return quantile_dim(arr, coverage, lo)

    t_min, fs_min = dim(all_toks, 16), dim(all_fs, 8)
    target = coverage * len(per_video)
    best = None                       # (cost, n_rows, txt, fs)
    for fs in (fs_min, 2 * fs_min):
        for t_mult in (1, 2, 3, 4):
            txt = t_min * t_mult
            for n_rows in range(1, max_rows + 1):
                fit = sum(all(p is not None
                              for p in pack_subs(rows, n_rows, txt, fs))
                          for rows in per_video)
                if fit >= target:
                    cost = n_rows * (txt + fs)
                    if best is None or cost < best[0]:
                        best = (cost, n_rows, txt, fs)
                    break
    if best is None:
        return suggest_shapes(sub_store, coverage=coverage,
                              max_txt_len=max_txt_len,
                              sub_ctx_len=sub_ctx_len, base=base,
                              append_len=append_len)
    _, n_rows, txt, fs = best
    return base.replace(n_subs=n_rows, txt_len=txt, frames_per_sub=fs,
                        n_frames=max(base.n_frames, dim(frames_pv, 8)))


def quantile_dim(values, coverage: float, lo: int, mult: int = 8) -> int:
    """A bucket dimension: the ``coverage`` quantile of ``values`` rounded
    up to a multiple of ``mult``, at least ``lo`` (``lo`` without
    values)."""
    v = (int(np.ceil(np.percentile(values, 100.0 * coverage)))
         if len(values) else lo)
    return max(lo, -(-v // mult) * mult)


def _row_tokens(lens: List[int], sub_idx: int, sub_ctx_len: int) -> int:
    """The tokens of sub ``sub_idx``'s row: [SEP] and the subs of its
    context window."""
    return 1 + sum(lens[t] for t in range(sub_idx - sub_ctx_len, sub_idx + 1)
                   if 0 <= t < len(lens))


def _sub_row_lens(sub_store, sidecar, vid: str,
                  max_txt_len: int) -> List[int]:
    """Per-sub token lengths (clamped to max_txt_len), from the
    ``vid2sub_lens`` sidecar when present, else from the example."""
    raw = sidecar.get(vid) if sidecar else None
    if raw is None:
        raw = [len(t) for t in sub_store[vid]["input_ids"]]
    if max_txt_len == -1:
        return list(raw)
    return [min(n, max_txt_len) for n in raw]


def video_fits_bucket(db: "VideoFeatSubTokDataset", vid: str) -> bool:
    """True iff ``vid`` loses nothing under ``db.shapes``; in pack mode
    the first-fit packer must place every sub."""
    sp = db.shapes
    sub2frames = db.txt_db.vid_sub2frame[vid]
    if len(sub2frames) > sp.n_subs and not db.pack:
        return False
    if db.img_db.name2nframe.get(vid, 0) > sp.n_frames:
        return False
    lens = None
    sidecar = getattr(db.txt_db, "vid2sub_lens", None)
    row_lens = []
    for sub_idx, frames in sub2frames:
        if len(frames) > sp.frames_per_sub:
            return False
        if lens is None:
            lens = _sub_row_lens(db.txt_db, sidecar, vid, db.max_txt_len)
        n = _row_tokens(lens, sub_idx, db.sub_ctx_len)
        if n > sp.txt_len:
            return False
        row_lens.append((n, len(frames)))
    if db.pack:
        return all(p is not None for p in pack_subs(
            row_lens, sp.n_subs, sp.txt_len, sp.frames_per_sub))
    return True


class VideoFeatSubTokDataset:
    """Fixed-shape video structs over a sub store and a feature store
    (``hero_tpu/data/video.py:276-474``); ``trunc_counts`` counts what
    the bucket drops."""

    def __init__(self, sub_store, vfeat_store, shapes: FixedShapes,
                 max_txt_len: int = 60, sub_ctx_len: int = 0,
                 pack: bool = False):
        self.txt_db = sub_store
        self.img_db = vfeat_store
        self.shapes = shapes
        self.max_txt_len = max_txt_len
        self.sub_ctx_len = sub_ctx_len
        self.pack = pack
        assert sub_ctx_len >= 0
        self.vids = list(sub_store.id2len.keys())
        self.vid2dur = sub_store.vid2dur
        self.vid2idx = sub_store.vid2idx
        self.trunc_counts = {"videos_seen": 0, "subs_dropped": 0,
                             "frames_dropped": 0, "clip_frames_dropped": 0,
                             "txt_tokens_dropped": 0,
                             "mlm_labels_dropped": 0,
                             "videos_truncated": 0}
        self._trunc_warned = False

    def truncation_report(self) -> Dict[str, float]:
        """Counters + the fraction of seen videos that lost any data."""
        c = dict(self.trunc_counts)
        seen = max(c["videos_seen"], 1)
        c["videos_truncated_frac"] = c["videos_truncated"] / seen
        return c

    def __len__(self) -> int:
        return len(self.vids)

    def sub_tokens(self, example, sub_idx: int, num_subs: int,
                   exclude: Optional[Set[int]] = None) -> List[int]:
        """[SEP] + context-window token ids (truncated to txt_len)."""
        ids: List[int] = [self.txt_db.sep]
        for t in range(sub_idx - self.sub_ctx_len, sub_idx + 1):
            if 0 <= t < num_subs and (exclude is None or t not in exclude):
                toks = example["input_ids"][t]
                if self.max_txt_len != -1:
                    toks = toks[:self.max_txt_len]
                ids.extend(toks)
        if len(ids) > self.shapes.txt_len:
            self.trunc_counts["txt_tokens_dropped"] += (
                len(ids) - self.shapes.txt_len)
        return ids[:self.shapes.txt_len]

    def video_item(self, vid: str,
                   exclude_subs: Optional[Set[int]] = None,
                   append_ids: Optional[List[int]] = None
                   ) -> Dict[str, np.ndarray]:
        """The backbone arrays of one video.  ``append_ids``: token ids
        appended to every sub's text (each packed segment gets its own
        copy)."""
        sp = self.shapes
        example = self.txt_db[vid]
        v_feat = self.img_db[vid]
        tc = self.trunc_counts
        lost = False
        if v_feat.shape[0] > sp.n_frames:
            tc["clip_frames_dropped"] += v_feat.shape[0] - sp.n_frames
            v_feat = v_feat[:sp.n_frames]
            lost = True
        nframes = v_feat.shape[0]
        sub2frames = self.txt_db.vid_sub2frame[vid]
        num_subs = len(sub2frames)
        tc["videos_seen"] += 1
        txt_dropped_before = tc["txt_tokens_dropped"]
        if num_subs > sp.n_subs and not self.pack:
            tc["subs_dropped"] += num_subs - sp.n_subs
            lost = True

        out = {
            "sub_input_ids": np.full((sp.n_subs, sp.txt_len),
                                     self.txt_db.pad, np.int32),
            "sub_txt_mask": np.zeros((sp.n_subs, sp.txt_len), np.float32),
            "sub_frame_idx": np.zeros((sp.n_subs, sp.frames_per_sub),
                                      np.int32),
            "sub_frame_mask": np.zeros((sp.n_subs, sp.frames_per_sub),
                                       np.float32),
            "sub_mask": np.zeros((sp.n_subs,), np.float32),
            "c_v_feats": np.zeros((sp.n_frames, sp.vfeat_dim), np.float16),
            "c_attn_masks": np.zeros((sp.n_frames,), np.float32),
        }
        out["c_v_feats"][:nframes] = v_feat
        out["c_attn_masks"][:nframes] = 1.0

        if self.pack:
            lost = self._fill_packed(out, example, sub2frames, num_subs,
                                     nframes, exclude_subs,
                                     append_ids) or lost
        else:
            for row, (sub_idx, frames) in enumerate(sub2frames[:sp.n_subs]):
                ids = self.sub_tokens(example, sub_idx, num_subs,
                                      exclude_subs)
                if append_ids:
                    take = list(append_ids)[:sp.txt_len - len(ids)]
                    if len(take) < len(append_ids):
                        tc["txt_tokens_dropped"] += (len(append_ids)
                                                     - len(take))
                    ids = ids + take
                out["sub_input_ids"][row, :len(ids)] = ids
                out["sub_txt_mask"][row, :len(ids)] = 1.0
                frames = [f for f in frames if f < nframes]
                if len(frames) > sp.frames_per_sub:
                    tc["frames_dropped"] += len(frames) - sp.frames_per_sub
                    lost = True
                frames = frames[:sp.frames_per_sub]
                if frames:
                    out["sub_frame_idx"][row, :len(frames)] = frames
                    out["sub_frame_mask"][row, :len(frames)] = 1.0
                out["sub_mask"][row] = 1.0
        if tc["txt_tokens_dropped"] > txt_dropped_before:
            lost = True
        if lost:
            tc["videos_truncated"] += 1
            if not self._trunc_warned:
                self._trunc_warned = True
                LOGGER.warning(
                    "fixed bucket %s truncates video %s (subs=%d); "
                    "monitor truncation_report() and consider a larger "
                    "bucket (suggest_shapes)", sp, vid, num_subs)
        return out

    def _fill_packed(self, out, example, sub2frames, num_subs, nframes,
                     exclude_subs, append_ids=None) -> bool:
        """Packed fill: several subs a row, first-fit.  Adds the segment
        ids (``sub_txt_seg`` / ``sub_frame_seg``, -1 = pad slot), the
        per-segment positions (``sub_txt_pos`` / ``sub_frame_pos``) and
        ``__pack_map`` ({sub index: Placement}, for tasks that rewrite a
        sub's text in place; :func:`stack_items` drops it).  Returns True
        if a sub was dropped."""
        sp = self.shapes
        tc = self.trunc_counts
        lost = False
        subs = []
        for sub_idx, frames in sub2frames:
            ids = self.sub_tokens(example, sub_idx, num_subs, exclude_subs)
            if append_ids:
                ids = ids + list(append_ids)
                if len(ids) > sp.txt_len:
                    tc["txt_tokens_dropped"] += len(ids) - sp.txt_len
                    lost = True
                    ids = ids[:sp.txt_len]
            frames = [f for f in frames if f < nframes]
            if len(frames) > sp.frames_per_sub:
                tc["frames_dropped"] += len(frames) - sp.frames_per_sub
                lost = True
                frames = frames[:sp.frames_per_sub]
            subs.append((sub_idx, ids, frames))
        placements = pack_subs([(len(i), len(f)) for _, i, f in subs],
                               sp.n_subs, sp.txt_len, sp.frames_per_sub)
        for k, shape in (("sub_txt_seg", (sp.n_subs, sp.txt_len)),
                         ("sub_frame_seg", (sp.n_subs, sp.frames_per_sub))):
            out[k] = np.full(shape, -1, np.int32)
        out["sub_txt_pos"] = np.zeros((sp.n_subs, sp.txt_len), np.int32)
        out["sub_frame_pos"] = np.zeros((sp.n_subs, sp.frames_per_sub),
                                        np.int32)
        pack_map = {}
        for (sub_idx, ids, frames), pl in zip(subs, placements):
            if pl is None:
                tc["subs_dropped"] += 1
                lost = True
                continue
            pack_map[sub_idx] = pl
            r, t0, t1 = pl.row, pl.toff, pl.toff + pl.tlen
            out["sub_input_ids"][r, t0:t1] = ids
            out["sub_txt_mask"][r, t0:t1] = 1.0
            out["sub_txt_seg"][r, t0:t1] = pl.seg
            out["sub_txt_pos"][r, t0:t1] = np.arange(pl.tlen)
            if frames:
                f0, f1 = pl.foff, pl.foff + pl.flen
                out["sub_frame_idx"][r, f0:f1] = frames
                out["sub_frame_mask"][r, f0:f1] = 1.0
                out["sub_frame_seg"][r, f0:f1] = pl.seg
                out["sub_frame_pos"][r, f0:f1] = np.arange(pl.flen)
            out["sub_mask"][pl.row] = 1.0
        out["__pack_map"] = pack_map
        return lost

    def sub2frames(self, vid: str):
        return self.txt_db.vid_sub2frame[vid]

    def nframes(self, vid: str) -> int:
        return min(self.img_db.name2nframe[vid], self.shapes.n_frames)


class VideoOnlyDataset:
    """Video-only corpora (MSR-VTT/DiDeMo without ASR): one pseudo-subtitle,
    [CLS], spanning every frame (reference data/vr_video_only.py:15-54;
    ``hero_tpu/data/video.py:433-480``).  ``txt_store`` gives the token ids
    ``cls_`` and ``pad``.  Needs ``shapes.frames_per_sub >=
    shapes.n_frames``."""

    def __init__(self, vfeat_store, txt_store, shapes: FixedShapes):
        assert shapes.frames_per_sub >= shapes.n_frames, (
            "video-only pseudo-sub spans the whole clip")
        self.img_db = vfeat_store
        self.txt_db = txt_store
        self.shapes = shapes
        self.vids = sorted(vfeat_store.name2nframe.keys())
        self.vid2idx = {v: i for i, v in enumerate(self.vids)}
        self.vid2dur = {}

    def __len__(self) -> int:
        return len(self.vids)

    def video_item(self, vid: str) -> Dict[str, np.ndarray]:
        sp = self.shapes
        v_feat = self.img_db[vid][:sp.n_frames]
        nframes = v_feat.shape[0]
        out = {
            "sub_input_ids": np.full((sp.n_subs, sp.txt_len),
                                     self.txt_db.pad, np.int32),
            "sub_txt_mask": np.zeros((sp.n_subs, sp.txt_len), np.float32),
            "sub_frame_idx": np.zeros((sp.n_subs, sp.frames_per_sub),
                                      np.int32),
            "sub_frame_mask": np.zeros((sp.n_subs, sp.frames_per_sub),
                                       np.float32),
            "sub_mask": np.zeros((sp.n_subs,), np.float32),
            "c_v_feats": np.zeros((sp.n_frames, sp.vfeat_dim), np.float16),
            "c_attn_masks": np.zeros((sp.n_frames,), np.float32),
        }
        out["c_v_feats"][:nframes] = v_feat
        out["c_attn_masks"][:nframes] = 1.0
        out["sub_input_ids"][0, 0] = self.txt_db.cls_
        out["sub_txt_mask"][0, 0] = 1.0
        out["sub_frame_idx"][0, :nframes] = np.arange(nframes)
        out["sub_frame_mask"][0, :nframes] = 1.0
        out["sub_mask"][0] = 1.0
        return out

    def nframes(self, vid: str) -> int:
        return min(self.img_db.name2nframe[vid], self.shapes.n_frames)


def stack_items(items: Sequence[Dict[str, np.ndarray]]
                ) -> Dict[str, np.ndarray]:
    """A batch: the items' arrays stacked (``__``-prefixed keys are
    per-item metadata and are dropped)."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]
            if not k.startswith("__")}


def pad_query(ids: List[int], query_len: int, pad: int):
    """(ids padded/cut to query_len, their validity mask)."""
    ids = ids[:query_len]
    out = np.full((query_len,), pad, np.int32)
    out[:len(ids)] = ids
    mask = np.zeros((query_len,), np.float32)
    mask[:len(ids)] = 1.0
    return out, mask
