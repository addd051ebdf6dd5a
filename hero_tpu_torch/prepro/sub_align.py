"""Subtitle-frame alignment (a copy of ``hero_tpu/prepro/sub_align.py``;
reference ``scripts/prepro_sub.py:95-243``).

Pure logic, behavior-identical to the reference:

- each sub covers frames ``[floor(st/Δ), ceil(ed/Δ))``;
- subs starting past the clip end are dropped; a >16 s *final* sub is
  clipped to 11 frames ("extra long" rule);
- every frame is uniquely assigned to the overlapping sub with max
  temporal IoU (frame [i, i+1] vs sub span in frame units);
- unmatched frames are collected in contiguous groups.

Returns the same ``info`` dict schema the reference stores per video
(``unique_sub2frames``, ``sub2frames``, ``frame2subs``,
``frame2unique_sub``, ``unmatched_frames``, stats).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple


def temporal_iou(span_a: Sequence[float], span_b: Sequence[float]) -> float:
    """IoU of two [st, ed) spans (reference prepro_sub.py:84-93)."""
    inter = (min(span_a[1], span_b[1]) - max(span_a[0], span_b[0]))
    if inter <= 0:
        return 0.0
    union = max(span_a[1], span_b[1]) - min(span_a[0], span_b[0])
    return inter / union


def process_single_vid_sub(sub_listdicts: List[dict], frame_length: float,
                           num_of_frames: int) -> Tuple[dict, int]:
    """Align one video's subtitles to its frames.

    ``sub_listdicts``: [{"text", "start", "end"}] sorted by start time.
    """
    if len(sub_listdicts) == 0 or num_of_frames == 0:
        return ({"num_of_frames": num_of_frames, "max_sub_length": 0,
                 "max_sub_duration": 0, "max_gap_time": 0,
                 "max_overlap_time": 0, "max_matched_frame_len": 0,
                 "max_unmatched_group_len": frame_length,
                 "extra_long_subs": 0}, 0)

    max_sub_length = max(len(e["text"].split(" ")) for e in sub_listdicts)
    orig = [(float(e["start"]), float(e["end"])) for e in sub_listdicts]
    starts = [s for s, _ in orig]
    assert starts == sorted(starts), "subs must be sorted by start time"
    spans_f = [(s / frame_length, e / frame_length) for s, e in orig]

    overlapped = 0
    sub2frames: Dict[int, List[int]] = {}
    prev = -1
    max_gap = 0.0
    max_overlap = 0.0
    max_duration = 0.0
    extra_long = 0
    clip_end = frame_length * num_of_frames
    for i, (sf, ef) in enumerate(spans_f):
        frames = list(range(math.floor(sf), math.ceil(ef)))
        if prev > 0:
            overlapped += int(orig[prev][1] > orig[i][0])
            gap = orig[i][0] - orig[prev][1]
            max_gap = max(max_gap, gap)
            max_overlap = max(max_overlap, -gap)
        start_t = orig[i][0]
        end_t = min(orig[i][1], clip_end)
        if start_t >= clip_end:
            continue
        duration = end_t - start_t
        if i == len(sub_listdicts) - 1 and duration > 16:
            extra_long += 1
            frames = frames[:11]
        else:
            max_duration = max(max_duration, duration)
        sub2frames[i] = frames
        prev = i

    frame2subs: Dict[str, List[int]] = {}
    frame2unique: Dict[int, int] = {}
    unmatched_groups: List[List[int]] = []
    cur_group: List[int] = []
    for f in range(num_of_frames):
        matched = [s for s, v in sub2frames.items() if f in set(v)]
        if matched:
            frame2subs[str(f)] = matched
            best, best_iou = 0, 0.0
            for s in matched:
                iou = temporal_iou([f, f + 1], spans_f[s])
                if iou > best_iou:
                    best_iou, best = iou, s
            frame2unique[f] = best
        else:
            if cur_group and f > cur_group[-1] + 1:
                unmatched_groups.append(list(cur_group))
                cur_group = []
            cur_group.append(f)
    if cur_group:
        unmatched_groups.append(list(cur_group))

    unique_sub2frames: Dict[int, List[int]] = {}
    for s in range(len(spans_f)):
        frames = sorted(f for f, u in frame2unique.items() if u == s)
        unique_sub2frames[s] = frames

    info = {
        "num_of_frames": num_of_frames,
        "unique_sub2frames": unique_sub2frames,
        "sub2frames": sub2frames,
        "frame2subs": frame2subs,
        "frame2unique_sub": frame2unique,
        "unmatched_frames": [f for g in unmatched_groups for f in g],
        "max_sub_length": max_sub_length,
        "max_sub_duration": max_duration,
        "max_gap_time": max_gap,
        "max_overlap_time": max_overlap,
        "max_matched_frame_len": max(
            len(v) for v in unique_sub2frames.values()),
        "max_unmatched_group_len": (max(len(g) for g in unmatched_groups)
                                    if unmatched_groups else 0),
        "extra_long_subs": extra_long,
    }
    return info, overlapped


def empty_sub_fallback(num_of_frames: int,
                       bucket: int = 5) -> Dict[int, List[int]]:
    """Videos with no subtitles: pseudo-subs over 5-frame buckets
    (reference prepro_sub.py:291-302)."""
    out = {}
    for i, start in enumerate(range(0, num_of_frames, bucket)):
        out[i] = list(range(start, min(start + bucket, num_of_frames)))
    return out
