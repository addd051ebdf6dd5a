"""herostore, the feature and text databases (a copy of
``hero_tpu/data/store.py``, with its own msgpack subset in place of the
``msgpack`` package).

A store is a directory:

- ``data.bin``: the payloads, one after another;
- ``index.bin``: msgpack map {key: [offset, length, codec]};
- the reference's sidecar JSONs (``meta.json``, ``id2len.json``,
  ``vid2len.json``, ``id2nframe.json``, ``query2video.json``,
  ``query_data.jsonl``, ...) beside them.

Codecs: ``msg`` (msgpack, ndarrays as ext type 42) and ``raw`` (one
ndarray: a dtype/shape header and the bytes; the 4352-d frame
features).  Reads go through the native reader
(``native/herostore``, built with g++ at first use) or, where it cannot
be built, Python's mmap: the same bytes.  ``HeroStore.reader`` says which.
The files are the JAX package's, byte for byte, so either package reads
the other's stores.
"""

from __future__ import annotations

import json
import mmap
import os
import weakref
from typing import Any, Dict, Tuple

import numpy as np

from hero_tpu_torch.data import msgpack_codec


def pack_value(value: Any) -> Tuple[bytes, str]:
    if isinstance(value, np.ndarray):
        return msgpack_codec.pack_ndarray(value), "raw"
    return msgpack_codec.packb(value), "msg"


def unpack_value(buf: bytes, codec: str) -> Any:
    if codec == "raw":
        return msgpack_codec.unpack_ndarray(buf)
    return msgpack_codec.unpackb(buf)


class HeroStoreWriter:
    """Append-only writer; not thread safe."""

    def __init__(self, db_dir: str):
        os.makedirs(db_dir, exist_ok=True)
        self.db_dir = db_dir
        self._data = open(os.path.join(db_dir, "data.bin"), "wb")
        self._index: Dict[str, Tuple[int, int, str]] = {}
        self._offset = 0

    def put(self, key: str, value: Any) -> None:
        payload, codec = pack_value(value)
        self._data.write(payload)
        self._index[key] = (self._offset, len(payload), codec)
        self._offset += len(payload)

    def close(self) -> None:
        self._data.close()
        with open(os.path.join(self.db_dir, "index.bin"), "wb") as f:
            f.write(msgpack_codec.packb(self._index))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _native_reader():
    """The native module if its library builds and loads, else None."""
    from hero_tpu_torch.native import herostore as native
    return native if native.available() else None


def _close_mmap(mm, f) -> None:
    if isinstance(mm, mmap.mmap):
        mm.close()
    f.close()


class HeroStore:
    """Read-only store: ``store[key] -> decoded value``.  ``reader`` is
    ``"native"`` or ``"mmap"``.  ``data.bin`` stays open until
    :meth:`close` or until the store is collected."""

    def __init__(self, db_dir: str):
        self.db_dir = db_dir
        with open(os.path.join(db_dir, "index.bin"), "rb") as f:
            self._index = msgpack_codec.unpackb(f.read())
        self._native = _native_reader()
        path = os.path.join(db_dir, "data.bin")
        if self._native is not None:
            self.reader = "native"
            self._handle = self._native.open(path)
            self._mm = None
            self._release = weakref.finalize(self, self._native.close,
                                             self._handle)
        else:
            self.reader = "mmap"
            f = open(path, "rb")
            size = os.path.getsize(path)
            self._mm = (mmap.mmap(f.fileno(), size, access=mmap.ACCESS_READ)
                        if size else b"")
            self._release = weakref.finalize(self, _close_mmap, self._mm, f)

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def keys(self):
        return self._index.keys()

    def __getitem__(self, key: str) -> Any:
        off, length, codec = self._index[key]
        if not self._release.alive:
            raise ValueError(f"store {self.db_dir} is closed")
        if self._native is not None:
            buf = self._native.read(self._handle, off, length)
        else:
            buf = self._mm[off:off + length]
        return unpack_value(buf, codec)

    def close(self) -> None:
        """Release ``data.bin``; values read before stay valid (both
        readers copy each record out)."""
        self._release()


# ---------------------------------------------------------------------------
# typed wrappers mirroring the reference db classes (data/data.py:52-323)
# ---------------------------------------------------------------------------

def _load_json(db_dir, name, default=None):
    path = os.path.join(db_dir, name)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return default


class VideoFeatStore:
    """Per-video float16 (nframes, 4352) features
    (reference VideoFeatLmdb, data/data.py:52-122)."""

    def __init__(self, img_dir: str, feat_version: str = "",
                 frame_interval: float = 1.5, compress: bool = False,
                 max_clip_len: int = -1):
        self.img_dir = img_dir
        self.frame_interval = frame_interval
        self.max_clip_len = max_clip_len
        self.store = HeroStore(img_dir)
        self.name2nframe = _load_json(img_dir, "id2nframe.json", {})
        if isinstance(self.name2nframe, dict) and max_clip_len != -1:
            self.name2nframe = {k: min(v, max_clip_len)
                                for k, v in self.name2nframe.items()}

    def __contains__(self, vid):
        return vid in self.store

    def __getitem__(self, vid: str) -> np.ndarray:
        # the storage dtype (float16), as the reference yields it; the
        # models cast at ingestion (embed.project_image_features)
        feat = self.store[vid]
        if self.max_clip_len != -1:
            feat = feat[:self.max_clip_len]
        return np.asarray(feat)


class TxtTokStore:
    """Tokenized text store + special-token metadata
    (reference TxtTokLmdb, data/data.py:134-211)."""

    def __init__(self, db_dir: str, max_txt_len: int = -1):
        self.db_dir = db_dir
        self.store = HeroStore(db_dir)
        meta = _load_json(db_dir, "meta.json", {})
        self.meta = meta
        self.cls_ = meta.get("CLS", 0)
        self.sep = meta.get("SEP", 2)
        self.pad = meta.get("PAD", 1)
        self.bos = meta.get("BOS", 0)
        self.eos = meta.get("EOS", 2)
        self.mask = meta.get("MASK", 50264)
        self.v_range = meta.get("v_range", (3, 50260))
        self.max_txt_len = max_txt_len
        id2len = _load_json(db_dir, "id2len.json", {})
        if max_txt_len == -1:
            self.id2len = id2len
        else:
            self.id2len = {i: l for i, l in id2len.items()
                           if l <= max_txt_len}

    def __getitem__(self, id_: str) -> Any:
        return self.store[id_]


class SubTokStore(TxtTokStore):
    """Subtitle store with the sub -> frame precompute
    (reference SubTokLmdb, data/data.py:214-268)."""

    def __init__(self, db_dir: str, max_clip_len: int = -1):
        super().__init__(db_dir, max_txt_len=-1)
        self.max_clip_len = max_clip_len
        self.vid2max_len = _load_json(db_dir,
                                      "vid2max_frame_sub_len.json", {})
        self.id2len = _load_json(db_dir, "vid2len.json", {})
        # per-sub token lengths from prepro (None: consumers scan)
        self.vid2sub_lens = _load_json(db_dir, "vid2sub_len.json", None)
        self.vid2dur, self.vid2idx = {}, {}
        video_data = _load_json(db_dir, "vid2dur_idx.json")
        if video_data:
            for key, info in video_data.items():
                self.vid2dur[key] = [{"vid_name": k, "duration": v[0]}
                                     for k, v in info.items()]
                self.vid2idx[key] = {k: v[1] for k, v in info.items()}
        self.vid_sub2frame, self.vid2vonly_frames = self._compute()

    def _compute(self):
        vid_sub2frame, vid2vonly = {}, {}
        for vid in list(self.id2len.keys()):
            ex = self.store[vid]
            unmatched = ex.get("unmatched_frames", [])
            sen2frame = []
            cutoff = False
            for sub_idx, frames in ex["unique_sub2frames"]:
                if self.max_clip_len > -1:
                    in_range = [i for i in sorted(frames)
                                if i < self.max_clip_len]
                    cutoff = cutoff or len(in_range) != len(frames)
                    if len(in_range) or len(frames) == 0:
                        sen2frame.append((sub_idx, in_range))
                    if cutoff:
                        break
                else:
                    sen2frame.append((sub_idx, list(frames)))
            vid_sub2frame[vid] = sen2frame
            vid2vonly[vid] = [i for i in unmatched
                              if i < self.max_clip_len]
            self.id2len[vid] = min(self.id2len[vid], self.max_clip_len)
        return vid_sub2frame, vid2vonly


class QueryTokStore(TxtTokStore):
    """Query store (reference QueryTokLmdb, data/data.py:271-296)."""

    def __init__(self, db_dir: str, max_txt_len: int = -1):
        super().__init__(db_dir, max_txt_len)
        self.query2video = _load_json(db_dir, "query2video.json", {})
        self.video2query: Dict[str, list] = {}
        for q, v in self.query2video.items():
            self.video2query.setdefault(v, []).append(q)
        self._query_data_rows = []
        path = os.path.join(db_dir, "query_data.jsonl")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if line.strip():
                        self._query_data_rows.append(json.loads(line))
        self.query_data = self._key_query_data()

    def _key_query_data(self) -> Dict[str, dict]:
        return {str(item["desc_id"]): item
                for item in self._query_data_rows}


class MsrvttQueryTokStore(QueryTokStore):
    """MSR-VTT query store (reference MsrvttQueryTokLmdb,
    data/vr.py:50-61): rows keyed by ``sen_id``, else wholesale by
    ``retrieval_key`` if any row lacks it, else by ``desc_id``."""

    def _key_query_data(self) -> Dict[str, dict]:
        for key in ("sen_id", "retrieval_key", "desc_id"):
            try:
                return {str(item[key]): item
                        for item in self._query_data_rows}
            except KeyError:
                continue
        return {}


class ShardedVideoFeatStore:
    """HowTo100M-style sharded feature stores (reference vfeat_shards,
    pretrain.py:45-57): several VideoFeatStore shards behind one lookup."""

    def __init__(self, shard_dirs, frame_interval: float = 1.5,
                 max_clip_len: int = -1):
        self.shards = [VideoFeatStore(d, frame_interval=frame_interval,
                                      max_clip_len=max_clip_len)
                       for d in shard_dirs]
        self.frame_interval = frame_interval
        self.max_clip_len = max_clip_len
        self.name2nframe = {}
        self._vid2shard = {}
        for s in self.shards:
            self.name2nframe.update(s.name2nframe)
            for vid in s.name2nframe:
                self._vid2shard[vid] = s

    def __contains__(self, vid):
        return vid in self._vid2shard

    def __getitem__(self, vid):
        return self._vid2shard[vid][vid]
