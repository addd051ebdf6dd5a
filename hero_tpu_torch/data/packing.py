"""Sub and query packing: several subtitles per f-encoder row, several
queries per query-encoder row (a copy of ``hero_tpu/data/packing.py``).

Subs go first-fit, in subtitle order, into the first row with room for
their tokens AND frames, at most ``PACK_MAX_SEGS`` segments per row; subs
that fit no row are dropped.  Queries go best-fit-decreasing and are never
dropped (:func:`pack_queries`).  Each sub or query becomes one segment of
its row: the attention mask is block-diagonal over segments, positions
restart per segment, and ``sub_frame_idx`` stays per slot.
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


def pack_queries(lens: Sequence[int], row_len: int, max_segs: int = 4
                 ) -> Tuple[List[Placement], int]:
    """Best-fit-decreasing query -> row packing (serving phase 2).

    Queries go longest first (ties by index) into the open row whose
    remaining capacity is the smallest that fits; a row closes when it
    holds ``max_segs`` segments or is full, and a new row opens when no
    open row fits, so every query with ``0 < len <= row_len`` lands
    exactly once (others raise).  Rows are indexed by remaining capacity,
    so this is O(N * row_len).  Returns (placements indexed like
    ``lens``, n_rows)."""
    order = sorted(range(len(lens)), key=lambda i: (-lens[i], i))
    by_rem: List[List[int]] = [[] for _ in range(row_len + 1)]
    t_used: List[int] = []
    segs: List[int] = []
    out: List[Optional[Placement]] = [None] * len(lens)
    for i in order:
        tl = lens[i]
        if not 0 < tl <= row_len:
            raise ValueError(f"query length {tl} outside (0, {row_len}]")
        row = None
        for rem in range(tl, row_len + 1):     # smallest sufficient rem
            if by_rem[rem]:
                row = by_rem[rem].pop()
                break
        if row is None:
            row = len(t_used)
            t_used.append(0)
            segs.append(0)
        out[i] = Placement(row, segs[row], t_used[row], tl, 0, 0)
        t_used[row] += tl
        segs[row] += 1
        if segs[row] < max_segs and t_used[row] < row_len:
            by_rem[row_len - t_used[row]].append(row)
    return out, len(t_used)           # type: ignore[return-value]


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
