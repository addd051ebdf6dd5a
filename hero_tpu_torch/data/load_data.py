"""Dataset factories over the stores on disk (a copy of
``hero_tpu/data/load_data.py``; reference ``load_data.py:21-138``), with
the JAX names: :func:`get_video_ids`, :func:`load_video_sub_dataset`,
:func:`load_video_only_dataset`, :func:`build_downstream_dataset`.  The
drivers' loaders (``drivers/common.py``) call these with their options."""

from __future__ import annotations

from typing import Optional

from hero_tpu_torch.data.downstream_tasks import (VcmrDataset,
                                                  VideoQaDataset,
                                                  ViolinDataset, VrDataset)
from hero_tpu_torch.data.store import (QueryTokStore, SubTokStore,
                                       VideoFeatStore, _load_json)
from hero_tpu_torch.data.video import (FixedShapes, VideoFeatSubTokDataset,
                                       VideoOnlyDataset)


def get_video_ids(sub_store: SubTokStore) -> list:
    """The videos of a sub store (reference load_data.py:21-28)."""
    return list(sub_store.id2len.keys())


def load_video_sub_dataset(vfeat_db: str, sub_txt_db: str,
                           shapes: FixedShapes, *,
                           vfeat_interval: float = 1.5,
                           max_clip_len: int = 100, max_txt_len: int = 60,
                           sub_ctx_len: int = 0,
                           pack: bool = False) -> VideoFeatSubTokDataset:
    """The sub and feature stores as one video dataset; ``pack``: the
    shapes are ``--pack_subs`` row capacities."""
    sub = SubTokStore(sub_txt_db, max_clip_len=max_clip_len)
    vfeat = VideoFeatStore(vfeat_db, frame_interval=vfeat_interval,
                           max_clip_len=max_clip_len)
    return VideoFeatSubTokDataset(sub, vfeat, shapes,
                                  max_txt_len=max_txt_len,
                                  sub_ctx_len=sub_ctx_len, pack=pack)


class SpecialIds:
    """The special token ids of a store's ``meta.json`` (RoBERTa's where
    it has none), for a corpus without a text store."""

    def __init__(self, meta: dict):
        self.id2len: dict = {}
        self.cls_ = meta.get("CLS", 0)
        self.sep = meta.get("SEP", 2)
        self.pad = meta.get("PAD", 1)
        self.mask = meta.get("MASK", 50264)


def load_video_only_dataset(vfeat_db: str, txt_meta_db: Optional[str],
                            shapes: FixedShapes, *,
                            vfeat_interval: float = 1.5,
                            max_clip_len: int = 100) -> VideoOnlyDataset:
    """A corpus without subtitles (reference load_data.py:47-54): one
    [CLS] pseudo-sub spans the clip, so the bucket becomes one row of
    max(frames_per_sub, n_frames) frames.  The special ids come from
    ``txt_meta_db``'s ``meta.json`` (the reference loads the query
    store's), RoBERTa's without one."""
    meta = _load_json(txt_meta_db, "meta.json", {}) if txt_meta_db else {}
    vfeat = VideoFeatStore(vfeat_db, frame_interval=vfeat_interval,
                           max_clip_len=max_clip_len)
    shapes = shapes.replace(
        n_subs=1, frames_per_sub=max(shapes.frames_per_sub,
                                     shapes.n_frames))
    return VideoOnlyDataset(vfeat, SpecialIds(meta), shapes)


def build_downstream_dataset(task: str, video_db, query_db_path: str, *,
                             max_txt_len: int = 60, **kw):
    """The training dataset of a task name over ``video_db`` and the query
    store (reference build_downstream_dataloaders, load_data.py:57-138);
    ``kw`` go to the dataset."""
    qdb = QueryTokStore(query_db_path, max_txt_len=max_txt_len)
    if task in ("tvr", "how2r", "didemo_video_sub", "didemo_video_only"):
        return VcmrDataset(getattr(video_db, "vids", []), video_db, qdb,
                           **kw)
    if task in ("msrvtt_video_sub", "msrvtt_video_only", "vr"):
        return VrDataset(getattr(video_db, "vids", []), video_db, qdb, **kw)
    if task in ("tvqa", "how2qa"):
        return VideoQaDataset(list(qdb.id2len.keys()), video_db, qdb, **kw)
    if task == "violin":
        qids = [q for q in qdb.id2len if q.endswith("_0")]
        return ViolinDataset(qids, video_db, qdb, **kw)
    raise ValueError(f"Unrecognized task {task}")
