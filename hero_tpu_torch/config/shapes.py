"""Static-shape (bucket) configuration (a copy of
``hero_tpu/config/shapes.py``).

A :class:`BucketShape` fixes every axis of the canonical video batch:

- ``n_videos``            B   videos per (per-host) batch
- ``subs_per_video``      S/B subtitle slots per video (slot ``s`` belongs to
                              video ``s // subs_per_video``)
- ``frames_per_sub``      Fv  frame slots per subtitle sequence
- ``sub_len``             Lt  subtitle BPE tokens per subtitle sequence
- ``clip_len``            L   frames per clip (reference MAX_FRM_SEQ_LEN=100)

The stage-1 cross-modal sequence is the fixed layout ``[Fv frame slots ; Lt
text slots]`` with per-slot validity masks; masked slots are attention-inert,
so this is numerically equivalent to the reference's compacted layout.
"""

from __future__ import annotations

import dataclasses


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class BucketShape:
    n_videos: int = 8
    subs_per_video: int = 8
    frames_per_sub: int = 16
    sub_len: int = 64
    clip_len: int = 100
    # query-side axes (VSM / VCMR / QA / caption batches)
    queries_per_video: int = 5
    query_len: int = 64

    @property
    def n_subs(self) -> int:
        return self.n_videos * self.subs_per_video

    @property
    def f_seq_len(self) -> int:
        """Stage-1 sequence length: frames then text."""
        return self.frames_per_sub + self.sub_len

    @property
    def n_queries(self) -> int:
        return self.n_videos * self.queries_per_video

    def replace(self, **kw) -> "BucketShape":
        return dataclasses.replace(self, **kw)


def tiny_bucket() -> BucketShape:
    """Miniature bucket for unit tests."""
    return BucketShape(n_videos=2, subs_per_video=3, frames_per_sub=4,
                       sub_len=8, clip_len=16, queries_per_video=2,
                       query_len=8)
