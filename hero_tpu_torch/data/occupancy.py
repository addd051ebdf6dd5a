"""The bucket-occupancy and FLOP audit on TV-distribution videos (a copy
of ``hero_tpu/data/occupancy.py``).

The fixed-shape pipeline pads every axis to a bucket (``bench.py``:
n_subs 16, txt_len 40, frames_per_sub 16, n_frames 100).  The torch
reference pads each batch to its in-batch maxima instead
(``data/data.py:406-512`` of the reference): one f-encoder row a real
sub, each padded to ``max_vl + max_sl`` over the batch, the clip to the
batch's longest.  :func:`audit` samples TV videos (:func:`sample_tv_video`,
aligned by the prepro logic of ``prepro/sub_align.py``) and prices three
train-FLOP models on them:

- **bucket**: the fixed shapes (what the port executes);
- **refpad**: the reference's in-batch-max padding;
- **ideal**: no padding (a lower bound neither reaches);

with each axis' occupancy of the bucket.  :func:`refpad_flops_per_example`
is a benchmark's denominator for the reference's work an example.

    python -m hero_tpu_torch.data.occupancy     # prints the table
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from hero_tpu_torch.prepro.sub_align import process_single_vid_sub

VFEAT_INTERVAL = 1.5        # seconds/frame (reference vfeat_interval)
MAX_CLIP_LEN = 100          # recipe hard clamp
MAX_TXT_LEN = 60            # recipe max_txt_len (BPE per sub)


@dataclass
class VideoShape:
    """Real (unpadded) shapes of one video's model inputs."""
    n_frames: int                 # clip frames
    sub_txt_lens: List[int]       # BPE tokens per sub row (incl. lead SEP)
    sub_n_frames: List[int]       # matched frames per sub row (>= 1)


def sample_tv_video(r: np.random.RandomState) -> VideoShape:
    """One TV-episode clip, shaped like the TVR distribution:

    - clip duration ~ U(60, 90) s, frames every 1.5 s, capped at 100;
    - dialogue subs: inter-start gaps ~ lognormal(ln 4.3, 0.35) clipped
      [2, 12] s, duration = gap * U(0.7, 1.0);
    - sub text ~ lognormal(ln 14, 0.40) BPE clipped [4, 60], + the lead SEP;
    - frame matching = the prepro unique-IoU assignment
      (``prepro/sub_align.process_single_vid_sub``).
    """
    duration = r.uniform(60.0, 90.0)
    n_frames = min(int(np.ceil(duration / VFEAT_INTERVAL)), MAX_CLIP_LEN)
    subs, t = [], float(r.uniform(0.0, 2.0))
    while t < duration:
        gap = float(np.clip(r.lognormal(np.log(4.3), 0.35), 2.0, 12.0))
        ed = t + gap * float(r.uniform(0.7, 1.0))
        subs.append({"text": "w " * 8, "start": t, "end": min(ed, duration)})
        t += gap
    info, _ = process_single_vid_sub(subs, VFEAT_INTERVAL, n_frames)
    txt_lens, n_match = [], []
    for si in range(len(subs)):
        frames = info["unique_sub2frames"].get(si, [])
        bpe = int(np.clip(r.lognormal(np.log(14.0), 0.40), 4, MAX_TXT_LEN))
        txt_lens.append(bpe + 1)              # + lead SEP token
        n_match.append(max(1, len(frames)))   # unmatched sub -> 1 zero row
    return VideoShape(n_frames, txt_lens, n_match)


# ---------------------------------------------------------------------------
# FLOP models (the flagship config: 768 / 3072, 6 + 3 layers)
# ---------------------------------------------------------------------------

D, INTER, VDIM = 768, 3072, 4352
F_LAYERS, C_LAYERS = 6, 3
TRAIN_MULT = 3.0     # forward + backward ~= 3x the forward's matmul FLOPs


def _enc_flops(n_layers: int, seqs) -> float:
    """Forward matmul FLOPs of an encoder stack over rows of length
    ``seqs`` (2mnk a product; the scores and context are seq^2)."""
    seqs = np.asarray(seqs, np.float64)
    attn = 4 * seqs * D * D + 2 * seqs * seqs * D
    ffn = 2 * seqs * D * INTER
    return float(n_layers * np.sum(2 * (attn + ffn)))


def _common_flops(n_frames, n_queries: int, query_len: int) -> float:
    """The c-encoder's, the frame projection's and the queries' FLOPs for
    the given clip length(s)."""
    nf = np.asarray(n_frames, np.float64)
    c = _enc_flops(C_LAYERS, nf)
    c += float(np.sum(2 * nf * VDIM * D))         # frame_transform
    q = _enc_flops(1, [query_len] * n_queries * len(np.atleast_1d(nf)))
    return c + q


def video_flops_bucket(v: VideoShape, n_subs=16, txt_len=40,
                       frames_per_sub=16, n_frames=100, n_queries=2,
                       query_len=30) -> float:
    """The fixed bucket: n_subs rows of (Fs + Lt) slots, the clip at
    n_frames."""
    rows = [frames_per_sub + txt_len] * n_subs
    f = _enc_flops(F_LAYERS, rows)
    f += 2 * n_subs * frames_per_sub * VDIM * D   # per-slot img projection
    return TRAIN_MULT * (f + _common_flops([n_frames], n_queries,
                                           query_len))


def batch_flops_refpad(videos: List[VideoShape], n_queries=2,
                       query_len=30) -> float:
    """The reference's padding of one batch: one row a real sub, padded
    to the batch's (max_vl + max_sl); the clip to its longest (reference
    data/data.py:423-438, 445-462)."""
    max_sl = max(n for v in videos for n in v.sub_txt_lens)
    max_vl = max(n for v in videos for n in v.sub_n_frames)
    total_subs = sum(len(v.sub_txt_lens) for v in videos)
    rows = [max_vl + max_sl] * total_subs
    f = _enc_flops(F_LAYERS, rows)
    f += 2 * total_subs * max_vl * VDIM * D
    max_nf = max(v.n_frames for v in videos)
    return TRAIN_MULT * (f + _common_flops([max_nf] * len(videos),
                                           n_queries, query_len))


def batch_flops_ideal(videos: List[VideoShape], n_queries=2,
                      query_len=30) -> float:
    """No padding: every row at its own length (a lower bound)."""
    total = 0.0
    for v in videos:
        rows = [nf + tl for nf, tl in zip(v.sub_n_frames, v.sub_txt_lens)]
        f = _enc_flops(F_LAYERS, rows)
        f += 2 * sum(v.sub_n_frames) * VDIM * D
        total += f + _common_flops([v.n_frames], n_queries, query_len)
    return TRAIN_MULT * total


# ---------------------------------------------------------------------------
# occupancy and the three models
# ---------------------------------------------------------------------------

def audit(n_batches: int = 16, batch: int = 32, seed: int = 0,
          n_subs: int = 16, txt_len: int = 40, frames_per_sub: int = 16,
          n_frames: int = 100) -> Dict[str, float]:
    """Each axis' occupancy of the bucket (real slots over bucket slots;
    rows past the bucket count as truncated) and the three models' FLOPs
    an example, over ``n_batches`` batches of ``batch`` sampled videos."""
    r = np.random.RandomState(seed)
    videos = [sample_tv_video(r) for _ in range(n_batches * batch)]
    sub_rows = np.array([len(v.sub_txt_lens) for v in videos], np.float64)
    txt = np.array([n for v in videos for n in v.sub_txt_lens[:n_subs]],
                   np.float64)
    frm = np.array([n for v in videos for n in v.sub_n_frames[:n_subs]],
                   np.float64)
    clip = np.array([v.n_frames for v in videos], np.float64)
    occ = {
        "n_subs": float(np.minimum(sub_rows, n_subs).mean() / n_subs),
        "n_subs_p50": float(np.median(sub_rows)),
        "n_subs_truncated_frac": float((sub_rows > n_subs).mean()),
        # the content the bucket drops that the reference processes
        "subs_dropped_frac": float(
            1.0 - np.minimum(sub_rows, n_subs).sum() / sub_rows.sum()),
        "txt_len": float(np.minimum(txt, txt_len).mean() / txt_len),
        "txt_len_p50": float(np.median(txt)),
        "txt_len_truncated_frac": float((txt > txt_len).mean()),
        "frames_per_sub": float(np.minimum(frm, frames_per_sub).mean()
                                / frames_per_sub),
        "frames_per_sub_p50": float(np.median(frm)),
        "frames_truncated_frac": float((frm > frames_per_sub).mean()),
        "n_frames": float(np.minimum(clip, n_frames).mean() / n_frames),
        "n_frames_p50": float(np.median(clip)),
        # real slots of the (Fs + Lt) row layout
        "f_row_slots": float(
            (np.minimum(txt, txt_len).sum()
             + np.minimum(frm, frames_per_sub).sum())
            / (len(txt) * (txt_len + frames_per_sub))),
    }
    fl_bucket = sum(video_flops_bucket(
        v, n_subs=n_subs, txt_len=txt_len, frames_per_sub=frames_per_sub,
        n_frames=n_frames) for v in videos)
    fl_refpad, fl_ideal = 0.0, 0.0
    for b in range(n_batches):
        bv = videos[b * batch:(b + 1) * batch]
        fl_refpad += batch_flops_refpad(bv)
        fl_ideal += batch_flops_ideal(bv)
    n = len(videos)
    occ.update({
        "flops_per_ex_bucket": fl_bucket / n,
        "flops_per_ex_refpad": fl_refpad / n,
        "flops_per_ex_ideal": fl_ideal / n,
        "bucket_over_refpad": fl_bucket / fl_refpad,
        "bucket_over_ideal": fl_bucket / fl_ideal,
        "refpad_over_ideal": fl_refpad / fl_ideal,
    })
    return occ


def refpad_flops_per_example(seed: int = 0, **audit_kw) -> float:
    """Train FLOPs an example of the reference's in-batch-max padding on
    the TV distribution (a fixed seed, so the number is stable)."""
    return audit(seed=seed, **audit_kw)["flops_per_ex_refpad"]


def main() -> None:
    occ = audit()
    print("# Bucket occupancy on the TV distribution "
          "(512 videos, 16 batches of 32)")
    rows = [
        ("n_subs (bucket 16)", "n_subs", "n_subs_p50",
         "n_subs_truncated_frac"),
        ("txt_len (bucket 40)", "txt_len", "txt_len_p50",
         "txt_len_truncated_frac"),
        ("frames_per_sub (bucket 16)", "frames_per_sub",
         "frames_per_sub_p50", "frames_truncated_frac"),
        ("n_frames (bucket 100)", "n_frames", "n_frames_p50", None),
    ]
    print(f"{'axis':<28} {'occupancy':>9} {'p50':>6} {'trunc%':>7}")
    for label, o, p, t in rows:
        tr = f"{100 * occ[t]:.1f}%" if t else "-"
        print(f"{label:<28} {100 * occ[o]:>8.1f}% {occ[p]:>6.1f} {tr:>7}")
    print(f"{'f-row slots (Fs+Lt layout)':<28} "
          f"{100 * occ['f_row_slots']:>8.1f}%")
    print()
    print(f"train FLOPs/ex   bucket: {occ['flops_per_ex_bucket']:.3e}  "
          f"refpad: {occ['flops_per_ex_refpad']:.3e}  "
          f"ideal: {occ['flops_per_ex_ideal']:.3e}")
    print(f"bucket/refpad = {occ['bucket_over_refpad']:.3f}   "
          f"bucket/ideal = {occ['bucket_over_ideal']:.3f}   "
          f"refpad/ideal = {occ['refpad_over_ideal']:.3f}")
    print()
    print(json.dumps({k: round(v, 4) for k, v in occ.items()}))


if __name__ == "__main__":
    main()
