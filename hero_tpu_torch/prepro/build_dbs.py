"""Store builders (a copy of ``hero_tpu/prepro/build_dbs.py``; reference
``scripts/prepro_sub.py``, ``prepro_query.py``, ``convert_videodb.py``,
``prepro_tvc.py``): herostore stores with the reference's sidecar JSONs,
byte for byte the JAX builders' given the same inputs.

``python -m hero_tpu_torch.prepro.build_dbs <sub_db> [<sub_db> ...]``
backfills ``vid2sub_len.json`` (:func:`emit_sub_len_sidecar`)."""

from __future__ import annotations

import json
import logging
import os
import sys
import zipfile
from typing import Callable, Dict, List, Optional

import numpy as np

from hero_tpu_torch.data.store import HeroStore, HeroStoreWriter
from hero_tpu_torch.prepro.sub_align import (empty_sub_fallback,
                                             process_single_vid_sub)

LOGGER = logging.getLogger(__name__)

ROBERTA_META = {"CLS": 0, "SEP": 2, "PAD": 1, "BOS": 0, "EOS": 2,
                "MASK": 50264, "v_range": (3, 50260)}

# what np.load and the concatenation raise for a corrupted or mismatched
# feature file
FEATURE_ERRORS = (OSError, EOFError, KeyError, ValueError,
                  zipfile.BadZipFile)


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def build_sub_db(out_dir: str, vid2subs: Dict[str, List[dict]],
                 vid2nframe: Dict[str, int], frame_length: float,
                 tokenize: Callable[[str], List[int]],
                 meta: dict = ROBERTA_META, split: str = "train",
                 vid2idx: Optional[Dict[str, int]] = None) -> None:
    """Subtitle store: each video's subs aligned to its frames and
    tokenized, with ``meta.json``, ``vid2len.json``,
    ``vid2max_frame_sub_len.json``, ``vid2dur_idx.json`` and the per-sub
    token lengths ``vid2sub_len.json`` (bucket sizing and routing read it
    instead of scanning the store)."""
    vid2len, vid2max_len, vid2sub_len, dur_idx = {}, {}, {}, {}
    total_overlap = 0
    with HeroStoreWriter(out_dir) as w:
        for i, (vid, subs) in enumerate(vid2subs.items()):
            nf = vid2nframe[vid]
            info, overlap = process_single_vid_sub(subs, frame_length, nf)
            total_overlap += overlap
            if subs:
                unique = sorted(info["unique_sub2frames"].items())
                input_ids = [tokenize(s["text"]) for s in subs]
            else:
                unique = sorted(empty_sub_fallback(nf).items())
                input_ids = [[] for _ in unique]
            w.put(vid, {
                "input_ids": input_ids,
                "unique_sub2frames": [(int(s), list(f)) for s, f in unique],
                "unmatched_frames": info.get("unmatched_frames", []),
            })
            vid2len[vid] = nf
            vid2sub_len[vid] = [len(t) for t in input_ids]
            max_txt = max((len(t) for t in input_ids), default=1)
            max_frames = info.get("max_matched_frame_len", nf) or nf
            vid2max_len[vid] = max_txt + max_frames
            dur_idx[vid] = [nf * frame_length, vid2idx[vid] if vid2idx else i]
    _write_json(os.path.join(out_dir, "meta.json"), meta)
    _write_json(os.path.join(out_dir, "vid2len.json"), vid2len)
    _write_json(os.path.join(out_dir, "vid2max_frame_sub_len.json"),
                vid2max_len)
    _write_json(os.path.join(out_dir, "vid2dur_idx.json"), {split: dur_idx})
    _write_json(os.path.join(out_dir, "vid2sub_len.json"), vid2sub_len)
    LOGGER.info("sub db: %d videos, %d overlapping subs", len(vid2subs),
                total_overlap)


def _load_features(path: str) -> np.ndarray:
    """The ``features`` array of an ``.npz`` (pickles refused)."""
    z = np.load(path, allow_pickle=False)
    if isinstance(z, np.ndarray):            # an .npy file
        raise ValueError(f"{path} is not an .npz archive")
    with z:
        return z["features"]


def build_video_db(out_dir: str,
                   vid2feat_paths: Dict[str, Dict[str, str]],
                   clip_interval: float = -1,
                   frame_length: float = 1.5) -> List[str]:
    """Each video's SlowFast and ResNet frame features, cut to the
    shorter and concatenated, as an (n, 4352) float16 store with
    ``id2nframe.json`` (reference convert_videodb.py:23-136).  A file
    that does not load is quarantined into ``corrupted.json``, not
    fatal; returns those videos.  ``clip_interval`` > 0 splits each
    video into records of that many seconds, ``{vid}_{i}`` (HowTo100M)."""
    id2nframe, corrupted = {}, []
    with HeroStoreWriter(out_dir) as w:
        for vid, paths in vid2feat_paths.items():
            try:
                parts = [_load_features(paths[key])
                         for key in ("slowfast", "resnet") if key in paths]
                n = min(p.shape[0] for p in parts)
                feat = np.concatenate([p[:n] for p in parts],
                                      axis=-1).astype(np.float16)
            except FEATURE_ERRORS as e:
                LOGGER.warning("corrupted features for %s: %s", vid, e)
                corrupted.append(vid)
                continue
            if clip_interval > 0:
                frames_per_clip = int(clip_interval / frame_length)
                for ci, st in enumerate(range(0, n, frames_per_clip)):
                    clip = feat[st:st + frames_per_clip]
                    key = f"{vid}_{ci}"
                    w.put(key, clip)
                    id2nframe[key] = clip.shape[0]
            else:
                w.put(vid, feat)
                id2nframe[vid] = feat.shape[0]
    _write_json(os.path.join(out_dir, "id2nframe.json"), id2nframe)
    if corrupted:
        _write_json(os.path.join(out_dir, "corrupted.json"), corrupted)
    return corrupted


def build_query_db(out_dir: str, query_jsonl: List[dict],
                   tokenize: Callable[[str], List[int]],
                   meta: dict = ROBERTA_META,
                   desc_key: str = "desc", id_key: str = "desc_id",
                   vid_key: str = "vid_name", ts_key: str = "ts") -> None:
    """TVR-style query store (reference prepro_query.py:32-160): the ids
    and the span ``target``, with ``meta.json``, ``id2len.json``,
    ``query2video.json`` and the items as ``query_data.jsonl``."""
    id2len, q2v = {}, {}
    with HeroStoreWriter(out_dir) as w, open(
            os.path.join(out_dir, "query_data.jsonl"), "w") as jf:
        for item in query_jsonl:
            qid = str(item[id_key])
            ids = tokenize(item[desc_key])
            rec = {"input_ids": ids}
            if item.get(ts_key) is not None:
                rec["target"] = item[ts_key]
            w.put(qid, rec)
            id2len[qid] = len(ids)
            if vid_key in item:
                q2v[qid] = item[vid_key]
            jf.write(json.dumps(item) + "\n")
    _write_json(os.path.join(out_dir, "meta.json"), meta)
    _write_json(os.path.join(out_dir, "id2len.json"), id2len)
    if q2v:
        _write_json(os.path.join(out_dir, "query2video.json"), q2v)


def build_qa_query_db(out_dir: str, qa_jsonl: List[dict],
                      tokenize: Callable[[str], List[int]],
                      meta: dict = ROBERTA_META) -> None:
    """TVQA/How2QA store: ``[question] + answers`` ids, the answer index
    and the ``ts`` span."""
    id2len, q2v = {}, {}
    with HeroStoreWriter(out_dir) as w:
        for item in qa_jsonl:
            qid = str(item["qid"] if "qid" in item else item["desc_id"])
            q_ids = tokenize(item["q"])
            a_ids = [tokenize(a) for a in item["answers"]]
            w.put(qid, {"input_ids": [q_ids] + a_ids,
                        "target": item.get("answer_idx"),
                        "ts": item.get("ts")})
            id2len[qid] = len(q_ids)
            q2v[qid] = item["vid_name"]
    _write_json(os.path.join(out_dir, "meta.json"), meta)
    _write_json(os.path.join(out_dir, "id2len.json"), id2len)
    _write_json(os.path.join(out_dir, "query2video.json"), q2v)


def build_caption_db(root_dir: str, cap_jsonl: List[dict],
                     tokenize: Callable[[str], List[int]],
                     meta: dict = ROBERTA_META) -> None:
    """TVC ``cap.db`` (one record a caption, keyed by ``desc_id``) and
    ``clip.db`` (one a clip: its video, span, duration and every caption's
    text, for validation by clip) under ``root_dir`` (reference
    prepro_tvc.py:22-137)."""
    cap_dir = os.path.join(root_dir, "cap.db")
    clip_dir = os.path.join(root_dir, "clip.db")
    vid2caps, cap2vid, vid2clips, clip2vid = {}, {}, {}, {}
    with HeroStoreWriter(cap_dir) as w, HeroStoreWriter(clip_dir) as cw:
        for item in cap_jsonl:
            vid = item["vid_name"]
            clip_id = str(item.get("clip_id", item["descs"][0]["desc_id"]))
            clip2vid[clip_id] = vid
            vid2clips.setdefault(vid, []).append(clip_id)
            captions = []
            for d in item["descs"]:
                cid = str(d["desc_id"])
                w.put(cid, {"input_ids": tokenize(d["desc"]),
                            "ts": item["ts"], "clip_id": clip_id})
                vid2caps.setdefault(vid, []).append(cid)
                cap2vid[cid] = vid
                captions.append({"id": cid, "text": d["desc"]})
            cw.put(clip_id, {"vid_name": vid, "ts": item["ts"],
                             "duration": item.get("duration"),
                             "captions": captions})
    _write_json(os.path.join(root_dir, "meta.json"), meta)
    _write_json(os.path.join(cap_dir, "vid2caps.json"), vid2caps)
    _write_json(os.path.join(cap_dir, "cap2vid.json"), cap2vid)
    _write_json(os.path.join(clip_dir, "vid2clips.json"), vid2clips)
    _write_json(os.path.join(clip_dir, "clip2vid.json"), clip2vid)


def emit_sub_len_sidecar(db_dir: str) -> str:
    """Write ``vid2sub_len.json`` for a sub store made before the sidecar
    existed (one scan of the store); returns its path."""
    store = HeroStore(db_dir)
    try:
        with open(os.path.join(db_dir, "vid2len.json")) as f:
            vid2len = json.load(f)
        vid2sub_len = {vid: [len(t) for t in store[vid]["input_ids"]]
                       for vid in vid2len}
    finally:
        store.close()
    path = os.path.join(db_dir, "vid2sub_len.json")
    _write_json(path, vid2sub_len)
    LOGGER.info("emitted %s (%d videos)", path, len(vid2sub_len))
    return path


def main(argv=None) -> None:
    dirs = sys.argv[1:] if argv is None else argv
    if not dirs:
        raise SystemExit("usage: python -m hero_tpu_torch.prepro.build_dbs "
                         "<sub_db> [<sub_db> ...]")
    for d in dirs:
        print(emit_sub_len_sidecar(d))


if __name__ == "__main__":
    main()
