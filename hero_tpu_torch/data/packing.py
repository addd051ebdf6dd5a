"""Sub packing: several subtitles per f-encoder row (a copy of the sub
packer in ``hero_tpu/data/packing.py``).

Subs go first-fit, in subtitle order, into the first row with room for
their tokens AND frames, at most ``PACK_MAX_SEGS`` segments per row; subs
that fit no row are dropped.  Each sub becomes one segment of its row: the
attention mask is block-diagonal over segments, positions restart per
segment, and ``sub_frame_idx`` stays per slot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from hero_tpu_torch.const import PACK_MAX_SEGS


@dataclass
class Placement:
    """Where one sub landed: row index + text/frame slot offsets."""
    row: int
    seg: int          # segment id within the row
    toff: int         # first text slot
    tlen: int
    foff: int         # first frame slot
    flen: int


def pack_subs(lens: Sequence[Tuple[int, int]], n_rows: int, txt_len: int,
              frames_per_sub: int, max_segs: int = PACK_MAX_SEGS
              ) -> List[Optional[Placement]]:
    """First-fit sub -> row assignment.

    ``lens``: per-sub (n_text_tokens, n_frames).  Returns one
    :class:`Placement` per sub (None = dropped: no row had room).
    """
    t_used = [0] * n_rows
    f_used = [0] * n_rows
    segs = [0] * n_rows
    out: List[Optional[Placement]] = []
    for tlen, flen in lens:
        placed = None
        for r in range(n_rows):
            if (t_used[r] + tlen <= txt_len
                    and f_used[r] + flen <= frames_per_sub
                    and segs[r] < max_segs):
                placed = Placement(r, segs[r], t_used[r], tlen,
                                   f_used[r], flen)
                t_used[r] += tlen
                f_used[r] += flen
                segs[r] += 1
                break
        out.append(placed)
    return out
