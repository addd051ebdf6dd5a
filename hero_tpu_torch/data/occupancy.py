"""TV-distribution video shapes (a copy of ``sample_tv_video`` from
``hero_tpu/data/occupancy.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

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
