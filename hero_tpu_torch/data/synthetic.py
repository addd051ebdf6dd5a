"""Synthetic fixed-shape batches (copies from ``hero_tpu/data/synthetic.py``
and ``bench.py``; the same seed gives the same arrays).

- :func:`base_batch`: backbone ('repr') batch, one sub per row.
- :func:`tv_vsm_batch`: TV-distribution videos (``occupancy.sample_tv_video``)
  in the packed (or unpacked) layout: the backbone keys, the four
  segment/position keys and the VSM query keys.
- :func:`vsm_batch`, :func:`mlm_batch`, :func:`mfm_batch`,
  :func:`fom_batch`, :func:`task_batch` and :func:`tv_task_batch`: the
  pretraining tasks' batches.
- ``TV_PACKED`` / ``TV_PACKED_OVERFLOW`` and :func:`partition_videos`:
  ``bench.py``'s two buckets and its routing of each video between them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from hero_tpu_torch.const import VFEAT_DIM
from hero_tpu_torch.data.packing import pack_subs


@dataclasses.dataclass(frozen=True)
class BatchShape:
    """Fixed bucket sizes."""
    batch: int = 8            # videos
    n_subs: int = 8           # subtitle rows per video
    txt_len: int = 40         # BPE tokens per sub (incl. leading SEP)
    frames_per_sub: int = 16  # frame slots per sub
    n_frames: int = 100       # clip length (MAX_FRM_SEQ_LEN)
    n_queries: int = 2        # queries per video (VSM)
    query_len: int = 30
    vfeat_dim: int = VFEAT_DIM
    vocab_size: int = 50272
    max_masked: int = 12      # MLM positions per sub

    def replace(self, **kw) -> "BatchShape":
        return dataclasses.replace(self, **kw)


TINY = BatchShape(batch=2, n_subs=3, txt_len=8, frames_per_sub=4,
                  n_frames=16, n_queries=2, query_len=6, vfeat_dim=64,
                  vocab_size=128, max_masked=3)

# packed TV bucket: rows of (16 frame + 88 text) slots hold 3-5 subs
TV_PACKED = BatchShape(batch=32, n_subs=4, txt_len=88,
                       frames_per_sub=16, n_frames=100, n_queries=2,
                       query_len=30)
# bench.py's overflow bucket for the TV videos the primary packed bucket
# cannot hold drop-free (4 x (24 f + 120 t) packs every one of them)
TV_PACKED_OVERFLOW = TV_PACKED.replace(txt_len=120, frames_per_sub=24)


def partition_videos(videos, shape: BatchShape):
    """(fit, overflow): a video goes to ``shape``'s bucket iff the
    first-fit packer places all its subs there (``bench.py``
    ``_partition_videos``)."""
    fit, over = [], []
    for v in videos:
        lens = list(zip(v.sub_txt_lens, v.sub_n_frames))
        ok = all(pl is not None for pl in pack_subs(
            lens, shape.n_subs, shape.txt_len, shape.frames_per_sub))
        (fit if ok else over).append(v)
    return fit, over


def base_batch(shape: BatchShape, seed: int = 0) -> Dict[str, np.ndarray]:
    """Backbone ('repr') batch with contiguous sub->frame assignment."""
    r = np.random.RandomState(seed)
    B, S, Lt = shape.batch, shape.n_subs, shape.txt_len
    Fs, F = shape.frames_per_sub, shape.n_frames
    sub_input_ids = r.randint(3, shape.vocab_size,
                              (B, S, Lt)).astype(np.int32)
    txt_lens = r.randint(Lt // 2, Lt + 1, (B, S))
    sub_txt_mask = (np.arange(Lt)[None, None, :]
                    < txt_lens[..., None]).astype(np.float32)
    sub_input_ids[sub_txt_mask == 0] = 1  # pad idx

    # each sub s covers frames [s*F//S, s*F//S + n)
    frames_per = max(1, F // S)
    starts = (np.arange(S) * frames_per)[None, :, None]
    offs = np.arange(Fs)[None, None, :]
    sub_frame_idx = np.minimum(starts + offs, F - 1).astype(np.int32)
    n_valid = r.randint(1, min(Fs, frames_per) + 1, (B, S))
    sub_frame_mask = (np.arange(Fs)[None, None, :]
                      < n_valid[..., None]).astype(np.float32)
    sub_frame_idx = np.broadcast_to(sub_frame_idx, (B, S, Fs)).copy()

    nf = r.randint(F // 2, F + 1, (B,))
    c_attn_masks = (np.arange(F)[None, :] < nf[:, None]).astype(np.float32)
    # float16 mirrors the production feature store dtype
    c_v_feats = r.randn(B, F, shape.vfeat_dim).astype(np.float16)
    c_v_feats *= c_attn_masks[..., None]

    return {
        "sub_input_ids": sub_input_ids,
        "sub_txt_mask": sub_txt_mask,
        "sub_frame_idx": sub_frame_idx,
        "sub_frame_mask": sub_frame_mask,
        "sub_mask": np.ones((B, S), np.float32),
        "c_v_feats": c_v_feats,
        "c_attn_masks": c_attn_masks,
    }


def tv_vsm_batch(videos, shape: BatchShape, seed: int = 0,
                 packed: bool = True
                 ) -> tuple[Dict[str, np.ndarray], float]:
    """VSM batch holding ``videos`` (occupancy.VideoShape list) in the
    packed (first-fit, segment ids) or unpacked (one sub a row, each cut
    to the row's budgets) layout.  Returns (batch dict, fraction of subs
    dropped).  Equal, key for key, to the JAX package's
    ``tv_vsm_batch(videos, shape, packed, seed)``: the random draws come
    in its order (features, query ids, span targets)."""
    r = np.random.RandomState(seed)
    B, S, Lt, Fs = (len(videos), shape.n_subs, shape.txt_len,
                    shape.frames_per_sub)
    Q, F = shape.n_queries, shape.n_frames
    out = {
        "c_v_feats": r.randn(B, F, shape.vfeat_dim).astype(np.float16),
        "c_attn_masks": np.zeros((B, F), np.float32),
        "query_input_ids": r.randint(
            3, shape.vocab_size, (B, Q, shape.query_len)).astype(np.int32),
        "query_attn_masks": np.ones((B, Q, shape.query_len), np.float32),
        "q_mask": np.ones((B, Q), np.float32),
        "targets": np.stack([r.randint(0, F // 2, (B, Q)),
                             r.randint(F // 2, F - 1, (B, Q))],
                            -1).astype(np.int32),
        "sub_input_ids": np.ones((B, S, Lt), np.int32),
        "sub_txt_mask": np.zeros((B, S, Lt), np.float32),
        "sub_frame_idx": np.zeros((B, S, Fs), np.int32),
        "sub_frame_mask": np.zeros((B, S, Fs), np.float32),
        "sub_mask": np.zeros((B, S), np.float32),
    }
    if packed:
        out.update({
            "sub_txt_seg": np.full((B, S, Lt), -1, np.int32),
            "sub_frame_seg": np.full((B, S, Fs), -1, np.int32),
            "sub_txt_pos": np.zeros((B, S, Lt), np.int32),
            "sub_frame_pos": np.zeros((B, S, Fs), np.int32),
        })
    dropped = total = 0
    for b, v in enumerate(videos):
        out["c_attn_masks"][b, :v.n_frames] = 1.0
        lens = list(zip(v.sub_txt_lens, v.sub_n_frames))
        total += len(lens)
        f0 = 0
        if not packed:
            dropped += max(0, len(lens) - S)
            for s, (tl, fl) in enumerate(lens[:S]):
                tl, fl = min(tl, Lt), min(fl, Fs)
                out["sub_input_ids"][b, s, :tl] = 5
                out["sub_txt_mask"][b, s, :tl] = 1.0
                idx = (f0 + np.arange(fl)) % v.n_frames
                out["sub_frame_idx"][b, s, :fl] = idx
                out["sub_frame_mask"][b, s, :fl] = 1.0
                out["sub_mask"][b, s] = 1.0
                f0 += fl
            continue
        pls = pack_subs(lens, S, Lt, Fs)
        for (tl, fl), pl in zip(lens, pls):
            if pl is None:
                dropped += 1
                continue
            t0, t1 = pl.toff, pl.toff + pl.tlen
            out["sub_input_ids"][b, pl.row, t0:t1] = 5
            out["sub_txt_mask"][b, pl.row, t0:t1] = 1.0
            out["sub_txt_seg"][b, pl.row, t0:t1] = pl.seg
            out["sub_txt_pos"][b, pl.row, t0:t1] = np.arange(pl.tlen)
            if pl.flen:
                q0, q1 = pl.foff, pl.foff + pl.flen
                idx = (f0 + np.arange(pl.flen)) % v.n_frames
                out["sub_frame_idx"][b, pl.row, q0:q1] = idx
                out["sub_frame_mask"][b, pl.row, q0:q1] = 1.0
                out["sub_frame_seg"][b, pl.row, q0:q1] = pl.seg
                out["sub_frame_pos"][b, pl.row, q0:q1] = np.arange(pl.flen)
                f0 += pl.flen
            out["sub_mask"][b, pl.row] = 1.0
    return out, dropped / max(total, 1)


# ---------------------------------------------------------------------------
# the pretraining tasks' batches (``hero_tpu/data/synthetic.py:111-197``
# and ``:269-333``)
# ---------------------------------------------------------------------------

def vsm_batch(shape: BatchShape, seed: int = 0) -> Dict[str, np.ndarray]:
    """:func:`base_batch` plus Q queries a video with span targets."""
    r = np.random.RandomState(seed + 1)
    b = base_batch(shape, seed)
    B, Q, Lq, F = (shape.batch, shape.n_queries, shape.query_len,
                   shape.n_frames)
    q_ids = r.randint(3, shape.vocab_size, (B, Q, Lq)).astype(np.int32)
    q_lens = r.randint(Lq // 2, Lq + 1, (B, Q))
    q_mask_tok = (np.arange(Lq)[None, None, :]
                  < q_lens[..., None]).astype(np.float32)
    q_ids[q_mask_tok == 0] = 1
    st = r.randint(0, F // 2, (B, Q))
    ed = st + r.randint(0, F // 2, (B, Q))
    b.update({
        "query_input_ids": q_ids,
        "query_attn_masks": q_mask_tok,
        "q_mask": np.ones((B, Q), np.float32),
        "targets": np.stack([st, np.minimum(ed, F - 1)],
                            -1).astype(np.int32),
    })
    return b


def mlm_batch(shape: BatchShape, seed: int = 0) -> Dict[str, np.ndarray]:
    """:func:`base_batch` with M mask positions a row, ~80% of them
    labelled and their input ids set to 3."""
    r = np.random.RandomState(seed + 2)
    b = base_batch(shape, seed)
    B, S, Lt, M = (shape.batch, shape.n_subs, shape.txt_len,
                   shape.max_masked)
    mask_pos = r.randint(0, Lt, (B, S, M)).astype(np.int32)
    labels = np.where(r.rand(B, S, M) < 0.8,
                      r.randint(3, shape.vocab_size, (B, S, M)),
                      -1).astype(np.int32)
    bi, si, mi = np.nonzero(labels >= 0)
    b["sub_input_ids"][bi, si, mask_pos[bi, si, mi]] = 3
    b["mlm_mask_pos"] = mask_pos
    b["mlm_labels"] = labels
    return b


def mfm_batch(shape: BatchShape, seed: int = 0) -> Dict[str, np.ndarray]:
    """:func:`base_batch` with a 15% frame mask, frame 0 of each clip
    always masked."""
    r = np.random.RandomState(seed + 3)
    b = base_batch(shape, seed)
    B, F = shape.batch, shape.n_frames
    m = (r.rand(B, F) < 0.15).astype(np.float32) * b["c_attn_masks"]
    m[:, 0] = b["c_attn_masks"][:, 0]
    b["c_v_masks"] = m
    return b


def _fom_orders(r, c_attn_masks):
    """15% of each clip's valid frames (at least one) permuted among
    themselves: (shuffled_orders, fom_targets)."""
    B, F = c_attn_masks.shape
    orders = np.tile(np.arange(F, dtype=np.int32), (B, 1))
    targets = np.full((B, F), -1, np.int32)
    for bi in range(B):
        nf = int(c_attn_masks[bi].sum())
        sel = r.choice(nf, max(1, int(nf * 0.15)), replace=False)
        perm = r.permutation(sel)
        orders[bi, sel] = perm
        targets[bi, perm] = sel.astype(np.int32)
    return orders, targets


def fom_batch(shape: BatchShape, seed: int = 0) -> Dict[str, np.ndarray]:
    r = np.random.RandomState(seed + 4)
    b = base_batch(shape, seed)
    b["shuffled_orders"], b["fom_targets"] = _fom_orders(r,
                                                         b["c_attn_masks"])
    return b


def task_batch(task: str, shape: BatchShape,
               seed: int = 0) -> Dict[str, np.ndarray]:
    if task == "vsm":
        return vsm_batch(shape, seed)
    if task.startswith("mlm"):
        return mlm_batch(shape, seed)
    if task in ("mfm-nce", "mffr"):
        return mfm_batch(shape, seed)
    if task == "fom":
        return fom_batch(shape, seed)
    return base_batch(shape, seed)


def tv_task_batch(task: str, videos, shape: BatchShape, packed: bool,
                  seed: int = 0, max_masked: Optional[int] = None):
    """TV-distribution batch of any pretraining task, packed or unpacked:
    the sub layout of :func:`tv_vsm_batch` plus the task's extras.
    ``max_masked``: MLM slots a row, by default
    ``mlm_row_cap(0.15, txt_len)``.  Returns (batch, subs dropped)."""
    b, dropped = tv_vsm_batch(videos, shape, seed, packed=packed)
    r = np.random.RandomState(seed + 7)
    B, S, Lt, F = len(videos), shape.n_subs, shape.txt_len, shape.n_frames
    if task == "vsm":
        return b, dropped
    if task.startswith("mlm"):
        if max_masked is None:
            from hero_tpu_torch.data.pretrain_tasks import mlm_row_cap
            max_masked = mlm_row_cap(0.15, Lt)
        M = max_masked
        mask_pos = np.zeros((B, S, M), np.int32)
        labels = np.full((B, S, M), -1, np.int32)
        for bi in range(B):
            for si in range(S):
                valid = np.where(b["sub_txt_mask"][bi, si] > 0)[0]
                if not len(valid):
                    continue
                k = min(M, max(1, int(len(valid) * 0.15)))
                picks = r.choice(valid, k, replace=False)
                mask_pos[bi, si, :k] = picks
                labels[bi, si, :k] = r.randint(3, shape.vocab_size, k)
                b["sub_input_ids"][bi, si, picks] = 3  # [MASK]
        b["mlm_mask_pos"] = mask_pos
        b["mlm_labels"] = labels
    elif task in ("mfm-nce", "mffr"):
        m = (r.rand(B, F) < 0.15).astype(np.float32) * b["c_attn_masks"]
        m[:, 0] = b["c_attn_masks"][:, 0]   # >= 1 masked frame a video
        b["c_v_masks"] = m
    elif task == "fom":
        b["shuffled_orders"], b["fom_targets"] = _fom_orders(
            r, b["c_attn_masks"])
    else:
        raise ValueError(task)
    return b, dropped
