"""Synthetic corpus builder (a copy of ``hero_tpu/data/testing.py``): writes
a full herostore DB suite for tests, the JAX builder's files byte for byte.

Produces the same artifact layout the real prepro emits (SURVEY.md §2.2):
sub db (+ vid2len.json, vid2max_frame_sub_len.json, vid2dur_idx.json),
video-feature db (+ id2nframe.json), query db (+ id2len.json,
query2video.json, query_data.jsonl), TVC cap db.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from hero_tpu_torch.data.store import HeroStoreWriter

META = {"CLS": 0, "SEP": 2, "PAD": 1, "BOS": 0, "EOS": 2, "MASK": 50,
        "v_range": (3, 100)}


def _write_json(db_dir, name, obj):
    with open(os.path.join(db_dir, name), "w") as f:
        json.dump(obj, f)


def build_synthetic_corpus(root: str, n_videos: int = 6,
                           max_frames: int = 16, vfeat_dim: int = 64,
                           frame_interval: float = 1.5,
                           n_queries_per_video: int = 3,
                           n_answers: int = 3, seed: int = 0,
                           correlated: bool = False) -> Dict[str, str]:
    """Returns dict of db paths: sub, vfeat, query, qa_query, cap.

    With ``correlated=True`` the corpus carries a learnable retrieval
    signal: video ``v`` gets a distinctive feature direction and its
    queries/subtitles carry video-identity tokens, so VSM/VCMR training
    must drive corpus R@1 well above chance (used by the flagship-scale
    TPU drive and the learning-signal tests)."""
    rng = random.Random(seed)
    npr = np.random.RandomState(seed)
    vids = [f"vid{i}" for i in range(n_videos)]

    def id_tok(vi: int) -> int:
        # per-video identity token in the corpus vocab band [3, 99)
        return 3 + (vi % 96)

    # --- video features
    vfeat_dir = os.path.join(root, "video_db")
    id2nframe = {}
    with HeroStoreWriter(vfeat_dir) as w:
        for vi, vid in enumerate(vids):
            nf = rng.randint(max_frames // 2, max_frames)
            id2nframe[vid] = nf
            feat = npr.randn(nf, vfeat_dim).astype(np.float32)
            if correlated:
                feat *= 0.1
                feat[:, (3 * vi) % vfeat_dim] += 3.0   # identity direction
            w.put(vid, feat.astype(np.float16))
    _write_json(vfeat_dir, "id2nframe.json", id2nframe)

    # --- subtitles
    sub_dir = os.path.join(root, "sub_db")
    vid2len, vid2max_len, vid2sub_len = {}, {}, {}
    vid2dur_idx = {"train": {}}
    with HeroStoreWriter(sub_dir) as w:
        for vi, vid in enumerate(vids):
            nf = id2nframe[vid]
            n_subs = rng.randint(2, 4)
            bounds = sorted(rng.sample(range(1, nf), min(n_subs - 1,
                                                         nf - 1)))
            spans = []
            prev = 0
            for b in bounds + [nf]:
                spans.append(list(range(prev, b)))
                prev = b
            input_ids = [[rng.randint(3, 99)
                          for _ in range(rng.randint(3, 8))]
                         for _ in spans]
            if correlated:
                # subtitles open with the video-identity token
                input_ids = [[id_tok(vi)] + row[1:] for row in input_ids]
            w.put(vid, {
                "input_ids": input_ids,
                "unique_sub2frames": [(i, s) for i, s in enumerate(spans)],
                "unmatched_frames": [],
            })
            vid2len[vid] = nf
            vid2sub_len[vid] = [len(t) for t in input_ids]
            vid2max_len[vid] = max(len(t) for t in input_ids) + max(
                len(s) for s in spans)
            vid2dur_idx["train"][vid] = [nf * frame_interval, vi]
    _write_json(sub_dir, "meta.json", META)
    _write_json(sub_dir, "vid2len.json", vid2len)
    _write_json(sub_dir, "vid2max_frame_sub_len.json", vid2max_len)
    _write_json(sub_dir, "vid2dur_idx.json", vid2dur_idx)
    _write_json(sub_dir, "vid2sub_len.json", vid2sub_len)

    # --- retrieval queries
    q_dir = os.path.join(root, "query_db")
    id2len, q2v = {}, {}
    with HeroStoreWriter(q_dir) as w, open(
            os.path.join(root, "query_data.jsonl"), "w") as jf:
        qid = 0
        for vi, vid in enumerate(vids):
            nf = id2nframe[vid]
            for _ in range(n_queries_per_video):
                ids = [rng.randint(3, 99)
                       for _ in range(rng.randint(3, 10))]
                if correlated:
                    # query is dominated by the identity token of its video
                    ids = [id_tok(vi)] * max(4, len(ids) - 1) + ids[:1]
                st = rng.uniform(0, nf * frame_interval / 2)
                ed = st + rng.uniform(frame_interval,
                                      nf * frame_interval / 2)
                w.put(str(qid), {"input_ids": ids, "target": [st, ed]})
                id2len[str(qid)] = len(ids)
                q2v[str(qid)] = vid
                rec = {"desc_id": qid, "desc": "", "vid_name": vid,
                       "ts": [st, ed], "type": rng.choice(["v", "t", "vt"])}
                jf.write(json.dumps(rec) + "\n")
                qid += 1
    _write_json(q_dir, "meta.json", META)
    _write_json(q_dir, "id2len.json", id2len)
    _write_json(q_dir, "query2video.json", q2v)
    os.replace(os.path.join(root, "query_data.jsonl"),
               os.path.join(q_dir, "query_data.jsonl"))

    # --- QA queries (q + A answers, target answer idx + ts)
    qa_dir = os.path.join(root, "qa_query_db")
    qa_id2len, qa_q2v = {}, {}
    with HeroStoreWriter(qa_dir) as w:
        qid = 0
        for vid in vids:
            nf = id2nframe[vid]
            q_ids = [rng.randint(3, 99) for _ in range(5)]
            answers = [[rng.randint(3, 99) for _ in range(4)]
                       for _ in range(n_answers)]
            st = rng.uniform(0, nf * frame_interval / 2)
            w.put(str(qid), {
                "input_ids": [q_ids] + answers,
                "target": rng.randrange(n_answers),
                "ts": [st, st + frame_interval * 2],
            })
            qa_id2len[str(qid)] = len(q_ids)
            qa_q2v[str(qid)] = vid
            qid += 1
    _write_json(qa_dir, "meta.json", META)
    _write_json(qa_dir, "id2len.json", qa_id2len)
    _write_json(qa_dir, "query2video.json", qa_q2v)

    # --- VIOLIN statements (paired _0/_1)
    vl_dir = os.path.join(root, "violin_query_db")
    vl_id2len, vl_q2v = {}, {}
    with HeroStoreWriter(vl_dir) as w:
        for i, vid in enumerate(vids):
            for suffix, tgt in (("_0", 0), ("_1", 1)):
                q = f"s{i}{suffix}"
                ids = [rng.randint(3, 99) for _ in range(6)]
                if correlated:
                    # entailment carries a learnable rule: a TRUE statement
                    # opens with its own video's identity token, a FALSE
                    # one with another video's — so the binary head must
                    # learn "statement token matches the video's feature
                    # direction" (the same video-identity structure the
                    # retrieval signal uses), not memorize labels
                    match = i if tgt == 1 else (i + 1) % len(vids)
                    ids = [id_tok(match)] * 3 + ids[3:]
                w.put(q, {"input_ids": ids, "target": tgt})
                vl_id2len[q] = len(ids)
                vl_q2v[q] = vid
    _write_json(vl_dir, "meta.json", META)
    _write_json(vl_dir, "id2len.json", vl_id2len)
    _write_json(vl_dir, "query2video.json", vl_q2v)

    # --- TVC captions
    cap_root = os.path.join(root, "cap_db_root")
    cap_dir = os.path.join(cap_root, "cap.db")
    clip_dir = os.path.join(cap_root, "clip.db")
    vid2caps, cap2vid = {}, {}
    vid2clips, clip2vid = {}, {}
    os.makedirs(cap_root, exist_ok=True)
    with HeroStoreWriter(cap_dir) as w, HeroStoreWriter(clip_dir) as cw:
        cid = 0
        for vid in vids:
            nf = id2nframe[vid]
            caps = []
            for _ in range(2):
                ids = [rng.randint(3, 99)
                       for _ in range(rng.randint(4, 9))]
                st = rng.uniform(0, nf * frame_interval / 2)
                ts = [st, st + rng.uniform(2, 8)]
                w.put(str(cid), {
                    "input_ids": ids,
                    "ts": ts,
                    "clip_id": cid,
                })
                # one clip per caption here (TVC has ~2-4 captions per
                # clip in the real data; 1:1 keeps the corpus small)
                cw.put(str(cid), {
                    "vid_name": vid, "ts": ts,
                    "captions": [{"id": str(cid),
                                  "text": " ".join(map(str, ids))}],
                })
                clip2vid[str(cid)] = vid
                vid2clips.setdefault(vid, []).append(str(cid))
                caps.append(str(cid))
                cap2vid[str(cid)] = vid
                cid += 1
            vid2caps[vid] = caps
    _write_json(cap_root, "meta.json", META)
    _write_json(cap_dir, "vid2caps.json", vid2caps)
    _write_json(cap_dir, "cap2vid.json", cap2vid)
    _write_json(clip_dir, "vid2clips.json", vid2clips)
    _write_json(clip_dir, "clip2vid.json", clip2vid)

    return {"sub": sub_dir, "vfeat": vfeat_dir, "query": q_dir,
            "qa_query": qa_dir, "violin_query": vl_dir, "cap": cap_root,
            "vids": vids}
