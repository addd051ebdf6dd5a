"""Full-corpus VCMR / SVMR / VR evaluation -- the serving path
(counterpart of ``hero_tpu/evaluation/vcmr_eval.py``), on one device or
on the ranks of a process group (``parallel/dist``).

- **Phase 1** embeds every video through the backbone into a corpus
  tensor ``(Nv, max_clip_len, D)`` kept resident on the device.
- **Phase 2** encodes each query batch and scores it against the whole
  corpus: video-level cosine scores sharpened by ``exp(q2c_alpha * s)``,
  an exact top-``max_vcmr_video`` over videos, st/ed span probabilities on
  the selected videos only, the in-band (st, ed) span scores and an exact
  top-``max_before_nms`` over them.  Both top-k's order by value
  descending with ties to the lowest flat index, as ``lax.top_k`` does.
- **Packed queries** (``pack_queries``): phase 2 first encodes the whole
  query set with several queries a row behind the block-diagonal segment
  mask (:func:`encode_queries_packed`), then scores per-batch slices of
  the pooled (Nq, D) matrix.  Only the layout changes.
- **Chunked corpus** (``corpus_chunk_videos``): phases 1 and 2 run
  ``corpus_chunk_videos`` videos at a time and the per-chunk top-k's merge
  exactly on the host (:func:`_chunked_score_all`); the corpus tensor is
  never whole on the device.
- The host decodes the flat indices into (video, st, ed) seconds, builds
  the reference-schema submission and computes the metrics.
- **Several ranks**: phase 1 embeds video batch i on rank i % W and
  all-gathers the corpus in the single process's video order; with
  ``distributed`` query batches (each rank's share of the queries) the
  metrics merge by example count (:func:`aggregate_distributed_metrics`)
  and the submissions by query (:func:`_merge_process_submissions`).
  The chunked corpus stays single-process.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from hero_tpu_torch import resolve_device
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.const import VCMR_IOU_THDS
from hero_tpu_torch.data.packing import pack_queries
from hero_tpu_torch.evaluation import tvr_metrics
from hero_tpu_torch.models import nn
from hero_tpu_torch.models import pretrain as pretrain_lib
from hero_tpu_torch.models.model import without_task_heads
from hero_tpu_torch.models import vcmr as vcmr_lib
from hero_tpu_torch.models.pretrain import VsmConfig
from hero_tpu_torch.parallel import dist


@dataclasses.dataclass(frozen=True)
class VcmrEvalOpts:
    """Inference options (reference train-tvr-8gpu.json / eval_vcmr flags)."""
    q2c_alpha: float = 20.0
    max_vcmr_video: int = 100
    min_pred_l: int = 2
    max_pred_l: int = 16
    max_before_nms: int = 200
    max_after_nms: int = 100
    nms_thd: float = -1.0
    vfeat_interval: float = 1.5
    max_clip_len: int = 100
    full_eval_tasks: Tuple[str, ...] = ("VCMR", "SVMR", "VR")
    eval_with_query_type: bool = True
    # >0: embed and score the corpus this many videos at a time (a whole
    # number of video batches); exact, see _chunked_score_all
    corpus_chunk_videos: int = 0
    # encode several queries a row behind the segment mask; exact, see
    # encode_queries_packed
    pack_queries: bool = False
    query_pack_segs: int = 4
    query_pack_rows_per_call: int = 64


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The numpy arrays of a host batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def embed_video_corpus(params, cfg: HeroConfig,
                       video_batches: Iterable[Dict[str, np.ndarray]],
                       dtype: torch.dtype = torch.bfloat16,
                       device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1: (Nv, max_clip_len, D) frame embeddings + (Nv, L) masks, on
    ``device``.  On W ranks, rank r embeds batches r, r + W, ... (another
    rank's batch may be None) and the whole corpus is all-gathered back
    into the batches' order, the same on every rank.  W and r are the
    data ranks' (the ranks of an inner group embed the same batches)."""
    device = resolve_device(device)
    params = nn.tree_to(without_task_heads(params), device)
    world, rank = dist.data_world(), dist.data_rank()
    embs, masks = [], []
    n_batches = 0
    with torch.inference_mode():
        for i, batch in enumerate(video_batches):
            n_batches += 1
            if i % world != rank:
                continue
            tb = batch_to_device(batch, device)
            embs.append(vcmr_lib.encode_video_corpus(params, cfg, tb, dtype))
            masks.append(tb["c_attn_masks"])
    if world == 1:
        return torch.cat(embs, 0), torch.cat(masks, 0)
    return (_gather_batches(embs, n_batches, device),
            _gather_batches(masks, n_batches, device))


def _gather_batches(mine: List[torch.Tensor], n_batches: int, device
                    ) -> torch.Tensor:
    """Every data rank's batches (data rank r held batches r, r + W, ...),
    all rows of batch 0, then of batch 1, and so on: the single process's
    order.  Ranks may hold different counts and row counts."""
    world = dist.data_world()
    rows = dist.data_allgather([int(t.shape[0]) for t in mine])
    like = dist.data_allgather(
        (tuple(mine[0].shape[1:]), mine[0].dtype) if mine else None)
    tail, dtype = next(x for x in like if x is not None)
    most = max(sum(r) for r in rows)
    local = torch.zeros((most,) + tail, dtype=dtype, device=device)
    if mine:
        local[:sum(rows[dist.data_rank()])] = torch.cat(mine, 0)
    every = dist.all_gather_tensor(local).reshape((world, most) + tail)
    parts = []
    for i in range(n_batches):
        r, k = i % world, i // world
        at = sum(rows[r][:k])
        parts.append(every[r, at:at + rows[r][k]])
    return torch.cat(parts, 0)


def _check_ranking_weights(vsm: VsmConfig):
    if vsm.lw_neg_ctx == 0 and vsm.lw_neg_q == 0:
        raise ValueError(
            "VCMR corpus eval needs video-level ranking scores, but "
            "lw_neg_ctx == lw_neg_q == 0 disables the ranking head. "
            "Check that the eval config carries the VSM loss weights.")


def topk_lowest_index(x: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis, by value descending with ties to the
    lowest index (``lax.top_k``'s order; ``torch.topk`` promises no order
    among ties on the card).  Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _make_ranker(opts: VcmrEvalOpts, n_videos: int, n_rows: int, L: int,
                 device):
    """The post-encoder phase-2 core: sharpen -> exact top-``max_v``
    videos -> st/ed convs, masking and softmaxes on the selected and
    ground-truth rows -> in-band span scores -> exact top-k.  ``n_rows``
    >= ``n_videos`` rows of the corpus, trailing pad rows never ranked.
    Returns (rank, max_v); ``rank(sim, scores, gt_vidx, head, fmask32)``
    gives (st_gt, ed_gt, top_scores, top_idx, flat_scores, flat_idx) with
    flat indices into the (max_v, L, L) span cube."""
    max_v = min(opts.max_vcmr_video, n_videos)
    # the min/max span-length band keeps ~(max_l - min_l) of the L
    # diagonals of the (st, ed) matrix: score only those positions
    band = tvr_metrics.generate_min_max_length_mask(
        (1, 1, L, L), opts.min_pred_l, opts.max_pred_l)[0, 0]
    band_pos = torch.from_numpy(np.flatnonzero(band.reshape(-1))).to(device)
    band_st, band_ed = band_pos // L, band_pos % L
    n_band = int(band_pos.numel())
    k = min(opts.max_before_nms, max_v * n_band)

    def rank(sim, scores, gt_vidx, head, fmask32):
        nq = sim.shape[0]
        sharp = torch.exp(opts.q2c_alpha * scores.float())
        if n_videos < n_rows:
            # pad rows score strictly below every real exp(a*s) > 0
            sharp[:, n_videos:] = -1.0
        top_scores, top_idx = topk_lowest_index(sharp, max_v)
        # conv, masking and softmax are row-local over L, so they run on
        # the selected rows only and commute exactly with the selection
        sim_sel = torch.gather(sim, 1, top_idx[..., None].expand(-1, -1, L))
        st_sel, ed_sel = pretrain_lib.conv_st_ed_masked(
            head, sim_sel, fmask32[top_idx])
        st_sel = torch.softmax(st_sel.float(), -1)
        ed_sel = torch.softmax(ed_sel.float(), -1)
        # SVMR ground-truth rows
        sim_gt = sim[torch.arange(nq, device=sim.device), gt_vidx]
        st_gt, ed_gt = pretrain_lib.conv_st_ed_masked(head, sim_gt,
                                                      fmask32[gt_vidx])
        st_gt = torch.softmax(st_gt.float(), -1)
        ed_gt = torch.softmax(ed_gt.float(), -1)
        vals = (st_sel[..., band_st] * ed_sel[..., band_ed]
                * top_scores[..., None])                  # (Nq, max_v, nb)
        flat_scores, pos = topk_lowest_index(vals.reshape(nq, -1), k)
        flat_idx = (pos // n_band) * (L * L) + band_pos[pos % n_band]
        return st_gt, ed_gt, top_scores, top_idx, flat_scores, flat_idx

    return rank, max_v


def _corpus_scorer(params, vsm: VsmConfig, opts: VcmrEvalOpts,
                   frame_embs: torch.Tensor, frame_masks: torch.Tensor,
                   n_real_videos: Optional[int]):
    """(score_mod, max_v): ``score_mod(mod, gt_vidx)`` ranks the resident
    corpus for pooled queries ``mod`` (Nq, D) (see :func:`_make_ranker`);
    trailing corpus rows past ``n_real_videos`` are never ranked."""
    _check_ranking_weights(vsm)
    n_rows, L = int(frame_embs.shape[0]), int(frame_embs.shape[1])
    rank, max_v = _make_ranker(
        opts, n_real_videos if n_real_videos is not None else n_rows,
        n_rows, L, frame_embs.device)
    fmask32 = frame_masks.float()

    def score_mod(mod, gt_vidx):
        sim = pretrain_lib.get_st_ed_sim(params["head"], mod, frame_embs)
        scores = pretrain_lib.get_video_level_scores(mod, frame_embs,
                                                     fmask32)
        return rank(sim, scores, gt_vidx, params["head"], fmask32)

    return score_mod, max_v


def _gt_tensor(gt_vidx, n: int, device) -> torch.Tensor:
    if gt_vidx is None:
        return torch.zeros(n, dtype=torch.int64, device=device)
    return torch.as_tensor(gt_vidx, device=device).long()


def make_query_scorer(params, cfg: HeroConfig, vsm: VsmConfig,
                      opts: VcmrEvalOpts, frame_embs: torch.Tensor,
                      frame_masks: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16,
                      n_real_videos: Optional[int] = None):
    """Phase-2 function scoring one query batch against the resident
    corpus.  ``n_real_videos`` keeps trailing pad rows of the corpus out of
    the ranking.  Returns (score, max_v); ``score(q_ids, q_masks, gt_vidx)``
    gives the ranker's outputs (see :func:`_make_ranker`) on the device."""
    score_mod, max_v = _corpus_scorer(params, vsm, opts, frame_embs,
                                      frame_masks, n_real_videos)
    device = frame_embs.device

    @torch.inference_mode()
    def score(q_ids, q_masks, gt_vidx=None):
        q_ids = torch.as_tensor(q_ids, device=device)
        mod = pretrain_lib.encode_query(
            params, cfg, q_ids, torch.as_tensor(q_masks, device=device),
            dtype=dtype)
        return score_mod(mod, _gt_tensor(gt_vidx, q_ids.shape[0], device))

    return score, max_v


def pack_query_arrays(q_ids: np.ndarray, q_lens: np.ndarray,
                      max_segs: int = 4, rows_per_call: int = 64
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Host half of packed query encoding: pack the whole query set
    (:func:`data.packing.pack_queries`, never drops) into rows of
    ``q_ids.shape[1]`` slots, the row count padded to a ``rows_per_call``
    multiple with all-pad rows.  Returns (p_ids, p_seg, p_pos, gather)
    int32, where ``gather[qi]`` is the flat (row * max_segs + seg) slot of
    query ``qi``'s pooled vector (``hero_tpu/evaluation/vcmr_eval.py:
    119-144``)."""
    nq, row_len = q_ids.shape
    # zero-mask pad queries (tail batches padded to the batch size) still
    # need a slot: packed as length-1 garbage, sliced off later
    lens = np.maximum(np.asarray(q_lens, np.int64), 1)
    pls, n_rows = pack_queries([int(x) for x in lens], row_len, max_segs)
    R = -(-n_rows // rows_per_call) * rows_per_call
    p_ids = np.zeros((R, row_len), np.int32)
    p_seg = np.full((R, row_len), -1, np.int32)
    p_pos = np.zeros((R, row_len), np.int32)
    gather = np.zeros((nq,), np.int32)
    for qi, pl in enumerate(pls):
        p_ids[pl.row, pl.toff:pl.toff + pl.tlen] = q_ids[qi, :pl.tlen]
        p_seg[pl.row, pl.toff:pl.toff + pl.tlen] = pl.seg
        p_pos[pl.row, pl.toff:pl.toff + pl.tlen] = np.arange(pl.tlen)
        gather[qi] = pl.row * max_segs + pl.seg
    return p_ids, p_seg, p_pos, gather


def encode_packed_rows(params, cfg: HeroConfig, p_ids, p_seg, p_pos,
                       gather, max_segs: int, rows_per_call: int,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Device half of packed query encoding: the packed query encoder over
    ``rows_per_call``-row slices of the (R, L) tensors, the per-segment
    pooled vectors gathered back into query order -> (Nq, D)."""
    outs = []
    with torch.inference_mode():
        for s in range(0, p_ids.shape[0], rows_per_call):
            e = s + rows_per_call
            out = pretrain_lib.encode_query_packed(
                params, cfg, p_ids[s:e], p_seg[s:e], p_pos[s:e], max_segs,
                dtype=dtype)
            outs.append(out.reshape(-1, out.shape[-1]))
        return torch.cat(outs, 0).index_select(0, gather.long())


def encode_queries_packed(params, cfg: HeroConfig, q_ids: np.ndarray,
                          q_lens: np.ndarray, max_segs: int = 4,
                          rows_per_call: int = 64,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Encode ALL queries packed -> (Nq, D) on the parameters' device:
    host packing (:func:`pack_query_arrays`) and device encoding
    (:func:`encode_packed_rows`).  Equal to per-row ``encode_query`` up to
    summation order (``hero_tpu/evaluation/vcmr_eval.py:164-179``)."""
    device = params["head"]["video_query_linear"]["weight"].device
    arrs = pack_query_arrays(q_ids, q_lens, max_segs, rows_per_call)
    return encode_packed_rows(
        params, cfg, *(torch.from_numpy(a).to(device) for a in arrs),
        max_segs, rows_per_call, dtype)


def make_fused_packed_scorer(params, cfg: HeroConfig, vsm: VsmConfig,
                             opts: VcmrEvalOpts, frame_embs: torch.Tensor,
                             frame_masks: torch.Tensor,
                             dtype: torch.dtype = torch.bfloat16,
                             n_real_videos: Optional[int] = None,
                             max_segs: int = 4):
    """A whole query set in one call: packed encoding, the pooled-vector
    gather and the corpus ranking (``hero_tpu/evaluation/vcmr_eval.py:
    362-401``).  Returns (run, max_v); ``run(p_ids, p_seg, p_pos, gather,
    gt_vidx)`` takes :func:`pack_query_arrays`' arrays (every row in one
    encoder call) and gives the ranker's outputs, one row a query.
    ``validate_full_vcmr`` does not call it (it encodes the query set
    ``rows_per_call`` rows at a time, then ranks per batch); it is kept
    as the public counterpart of the JAX function and held against it by
    ``tests/test_torch_vcmr_serve.py``."""
    score_mod, max_v = _corpus_scorer(params, vsm, opts, frame_embs,
                                      frame_masks, n_real_videos)
    device = frame_embs.device

    @torch.inference_mode()
    def run(p_ids, p_seg, p_pos, gather, gt_vidx=None):
        p_ids, p_seg, p_pos, gather = (torch.as_tensor(a, device=device)
                                       for a in (p_ids, p_seg, p_pos,
                                                 gather))
        mod = encode_packed_rows(params, cfg, p_ids, p_seg, p_pos, gather,
                                 max_segs, p_ids.shape[0], dtype)
        return score_mod(mod, _gt_tensor(gt_vidx, gather.shape[0], device))

    return run, max_v


def _band_setup(opts: VcmrEvalOpts, L: int) -> np.ndarray:
    """Flat (st * L + ed) positions of the min/max span-length band."""
    band = tvr_metrics.generate_min_max_length_mask(
        (1, 1, L, L), opts.min_pred_l, opts.max_pred_l)[0, 0]
    return np.flatnonzero(band.reshape(-1)).astype(np.int32)


def _chunked_score_all(params, cfg: HeroConfig, vsm: VsmConfig,
                       opts: VcmrEvalOpts, video_batches,
                       query_batches: List[Dict[str, Any]],
                       video2idx_local: Dict[str, int], n_real_videos: int,
                       dtype: torch.dtype, device) -> List[Tuple]:
    """Phases 1 and 2 over a corpus too large to keep resident
    (``hero_tpu/evaluation/vcmr_eval.py:411-565``): ``corpus_chunk_videos``
    videos are embedded and every query batch scored against them at a
    time.  Every per-(query, video) quantity is chunk-independent, so the
    global top-``max_vcmr_video`` is a merge of per-chunk top-k's and the
    flat top-``max_before_nms`` merges the per-video top-k1 band
    candidates of the merged videos; the host merge orders ties by the
    lowest index, as ``lax.top_k`` does.  Returns one (st_gt, ed_gt,
    top_scores, top_idx, flat_scores, flat_idx) tuple of numpy arrays per
    query batch, in the resident ranker's layout."""
    _check_ranking_weights(vsm)
    Nc = int(opts.corpus_chunk_videos)
    L = opts.max_clip_len
    band_pos = _band_setup(opts, L)
    n_band = int(band_pos.shape[0])
    band_t = torch.from_numpy(band_pos.astype(np.int64)).to(device)
    band_st, band_ed = band_t // L, band_t % L
    max_v = min(opts.max_vcmr_video, n_real_videos)
    kc = min(max_v, Nc)                       # per-chunk video top-k
    k1 = min(opts.max_before_nms, n_band)     # per-video band top-k
    queries = [(torch.as_tensor(b["query_input_ids"], device=device),
                torch.as_tensor(b["query_attn_masks"], device=device))
               for b in query_batches]

    def score_chunk(chunk_embs, chunk_masks, q_ids, q_masks, gt_local):
        scores, st, ed = vcmr_lib.get_pred_from_raw_query(
            params, cfg, vsm, chunk_embs, chunk_masks, q_ids, q_masks,
            cross=True, dtype=dtype)
        sharp = torch.exp(opts.q2c_alpha * scores.float())
        top_sc, top_ix = topk_lowest_index(sharp, kc)          # (Nq, kc)
        idx = top_ix[..., None].expand(-1, -1, L)
        st_sel = torch.softmax(torch.gather(st, 1, idx).float(), -1)
        ed_sel = torch.softmax(torch.gather(ed, 1, idx).float(), -1)
        vals = (st_sel[..., band_st] * ed_sel[..., band_ed]
                * top_sc[..., None])                       # (Nq, kc, n_band)
        sc1, idx1 = topk_lowest_index(vals, k1)            # (Nq, kc, k1)
        rows = torch.arange(st.shape[0], device=device)
        st_gt = torch.softmax(st[rows, gt_local].float(), -1)
        ed_gt = torch.softmax(ed[rows, gt_local].float(), -1)
        return top_sc, top_ix, sc1, idx1, st_gt, ed_gt

    per_chunk: List[List[Any]] = [[] for _ in query_batches]

    def flush_chunk(embs, masks, offset):
        e, m = torch.cat(embs, 0), torch.cat(masks, 0)
        if e.shape[0] < Nc:
            # the last chunk padded with zero-mask rows: their scores sit
            # at exp(-q2c_alpha * 1e4) = 0 and the merge drops them
            e = torch.cat([e, e.new_zeros((Nc - e.shape[0],) + e.shape[1:])])
            m = torch.cat([m, m.new_zeros((Nc - m.shape[0],) + m.shape[1:])])
        for bi, (batch, (q_ids, q_masks)) in enumerate(
                zip(query_batches, queries)):
            gt_local = np.zeros((q_ids.shape[0],), np.int64)
            for qi, v in enumerate(batch["vids"]):
                a = video2idx_local.get(v, 0)
                if offset <= a < offset + Nc:
                    gt_local[qi] = a - offset
            out = score_chunk(e, m, q_ids, q_masks,
                              torch.from_numpy(gt_local).to(device))
            per_chunk[bi].append((offset,) + tuple(
                x.cpu().numpy() for x in out))

    embs, masks, offset, n_in_chunk = [], [], 0, 0
    with torch.inference_mode():
        for vb in video_batches:
            tb = batch_to_device(vb, device)
            embs.append(vcmr_lib.encode_video_corpus(params, cfg, tb, dtype))
            masks.append(tb["c_attn_masks"])
            n_in_chunk += embs[-1].shape[0]
            if n_in_chunk >= Nc:
                # a chunk is a whole number of video batches: a batch
                # split across two chunks would change the chunk's shape
                assert n_in_chunk == Nc, (
                    "corpus_chunk_videos must be a multiple of the video "
                    f"batch size (chunk {n_in_chunk} vs {Nc})")
                flush_chunk(embs, masks, offset)
                offset += Nc
                embs, masks, n_in_chunk = [], [], 0
        if embs:
            flush_chunk(embs, masks, offset)

    # host merge, per query batch (the JAX package's numpy, unchanged)
    k = min(opts.max_before_nms, max_v * n_band)
    results = []
    for bi, batch in enumerate(query_batches):
        n_rows = batch["query_input_ids"].shape[0]
        vids = batch["vids"]
        tsc = np.zeros((n_rows, max_v), np.float32)
        tidx = np.zeros((n_rows, max_v), np.int64)
        fsc = np.zeros((n_rows, k), np.float32)
        fidx = np.zeros((n_rows, k), np.int64)
        st_gt = np.zeros((n_rows, L), np.float32)
        ed_gt = np.zeros((n_rows, L), np.float32)
        chunks = per_chunk[bi]
        for qi in range(n_rows):
            # video-level merge: (-score, absolute index) is lax.top_k's
            # lowest-index order over the whole corpus
            cand_sc, cand_abs, cand_loc = [], [], []
            for ci, (off, c_tsc, c_tix, _, _, _, _) in enumerate(chunks):
                abs_ix = c_tix[qi].astype(np.int64) + off
                keep = abs_ix < n_real_videos     # drop chunk pad rows
                cand_sc.append(c_tsc[qi][keep])
                cand_abs.append(abs_ix[keep])
                cand_loc.append(np.stack(
                    [np.full(int(keep.sum()), ci),
                     np.flatnonzero(keep)], 1))
            sc = np.concatenate(cand_sc)
            ab = np.concatenate(cand_abs)
            loc = np.concatenate(cand_loc, 0)
            order = np.lexsort((ab, -sc))[:max_v]
            tsc[qi] = sc[order]
            tidx[qi] = ab[order]
            # flat merge: the per-video top-k1 band rows of the selected
            # videos, in merged-rank order (the resident layout)
            rows_sc = np.empty((max_v, k1), np.float32)
            rows_band = np.empty((max_v, k1), np.int64)
            for rank, oi in enumerate(order):
                ci, local_rank = loc[oi]
                _, _, _, c_sc1, c_idx1, _, _ = chunks[ci]
                rows_sc[rank] = c_sc1[qi, local_rank]
                rows_band[rank] = c_idx1[qi, local_rank]
            flat_sc = rows_sc.reshape(-1)
            # ties by position in the (max_v * k1) layout: lax.top_k over
            # the resident vector
            top = np.lexsort((np.arange(flat_sc.size), -flat_sc))[:k]
            fsc[qi] = flat_sc[top]
            ranks = top // k1
            fidx[qi] = ranks * (L * L) + band_pos[rows_band.reshape(-1)[top]]
            # the SVMR ground-truth rows come from the chunk owning the
            # ground-truth video
            gt_abs = video2idx_local.get(vids[qi], 0) if qi < len(vids) \
                else 0
            ci = min(gt_abs // Nc, len(chunks) - 1)
            st_gt[qi] = chunks[ci][5][qi]
            ed_gt[qi] = chunks[ci][6][qi]
        results.append((st_gt, ed_gt, tsc, tidx, fsc, fidx))
    return results


def validate_full_vcmr(params, cfg: HeroConfig, vsm: VsmConfig,
                       opts: VcmrEvalOpts,
                       video_batches: Iterable[Dict[str, np.ndarray]],
                       query_batches: Iterable[Dict[str, Any]],
                       video_ids: List[str],
                       video2idx_global: Dict[str, int],
                       query_data: Dict[Any, dict],
                       dtype: torch.dtype = torch.bfloat16,
                       device="cuda", distributed: bool = False):
    """Run the full two-phase evaluation
    (``hero_tpu/evaluation/vcmr_eval.py:568-798``).

    ``query_batches`` yield dicts with numpy ``query_input_ids`` (N, Lq),
    ``query_attn_masks``, plus host lists ``qids`` and ``vids`` (GT video
    per query, "" if unknown).  ``opts.corpus_chunk_videos`` below the
    corpus size takes the chunked path (not with ``opts.pack_queries``:
    ValueError).  Every rank of a process group calls it: phase 1 is
    shared out by video batch (:func:`embed_video_corpus`), and with
    ``distributed`` the query batches are this rank's share of the
    queries (``VcmrFullEvalDataset(distributed=True)``), the metrics and
    the submission those of every rank's queries.  Returns (val_log,
    submission, metrics)."""
    device = resolve_device(device)
    params = nn.tree_to(without_task_heads(params), device)
    video2idx_local = {v: i for i, v in enumerate(video_ids)}
    query_batches = list(query_batches)
    chunk_outs = None
    chunked = (opts.corpus_chunk_videos
               and opts.corpus_chunk_videos < len(video_ids))
    if chunked:
        if dist.world_size() > 1:
            raise NotImplementedError(
                f"corpus_chunk_videos={opts.corpus_chunk_videos} on "
                f"{dist.world_size()} ranks: the chunked corpus is served "
                "by one process, as in the JAX package (its chunked path "
                "takes a mesh of one device); run one process, or drop "
                "corpus_chunk_videos")
        if opts.pack_queries:
            raise ValueError(
                "pack_queries is not supported together with "
                "corpus_chunk_videos (the chunked scorer re-encodes "
                "queries per chunk); drop one of the two flags")
        chunk_outs = _chunked_score_all(
            params, cfg, vsm, opts, video_batches, query_batches,
            video2idx_local, len(video_ids), dtype, device)
        max_v = min(opts.max_vcmr_video, len(video_ids))
        L = opts.max_clip_len
    else:
        frame_embs, frame_masks = embed_video_corpus(
            params, cfg, video_batches, dtype, device)
        L = int(frame_embs.shape[1])
        if opts.pack_queries:
            # the whole query set encoded packed, then scored in per-batch
            # slices of the pooled (Nq, D) matrix
            score_mod, max_v = _corpus_scorer(
                params, vsm, opts, frame_embs, frame_masks, len(video_ids))
            mod_all = encode_queries_packed(
                params, cfg,
                np.concatenate([b["query_input_ids"]
                                for b in query_batches], 0),
                np.concatenate([np.asarray(b["query_attn_masks"]).sum(1)
                                for b in query_batches],
                               0).astype(np.int64),
                max_segs=opts.query_pack_segs,
                rows_per_call=opts.query_pack_rows_per_call, dtype=dtype)

            @torch.inference_mode()
            def score_batch(batch, q_off, gt_vidx):
                n = batch["query_input_ids"].shape[0]
                return score_mod(mod_all[q_off:q_off + n],
                                 _gt_tensor(gt_vidx, n, device))
        else:
            scorer, max_v = make_query_scorer(
                params, cfg, vsm, opts, frame_embs, frame_masks, dtype,
                n_real_videos=len(video_ids))

            def score_batch(batch, q_off, gt_vidx):
                return scorer(
                    torch.from_numpy(np.asarray(batch["query_input_ids"])),
                    torch.from_numpy(np.asarray(batch["query_attn_masks"])),
                    torch.from_numpy(gt_vidx))

    total_qids, total_vids = [], []
    svmr_st, svmr_ed = [], []
    top_scores_all, top_idx_all = [], []
    flat_scores_all, flat_idx_all = [], []
    has_gt_target = True
    n_ex = 0
    partial_query_data = []
    q_off = 0
    for bi, batch in enumerate(query_batches):
        qids, vids = batch["qids"], batch["vids"]
        total_qids.extend(qids)
        total_vids.extend(vids)
        for qid in qids:
            if qid in query_data:
                partial_query_data.append(query_data[qid])
        n_ex += len(qids)
        if any(v == "" or v is None for v in vids):
            has_gt_target = False
        if has_gt_target:
            missing = [v for v in vids if v not in video2idx_local]
            if missing:
                raise KeyError(
                    "ground-truth video(s) missing from the embedded "
                    f"corpus: {missing[:5]} -- the eval corpus must contain "
                    "every GT video")
        # query arrays may be padded past the real query count; pad rows
        # are zero-masked, scored as garbage and sliced off here
        n_real = len(qids)
        n_rows = batch["query_input_ids"].shape[0]
        if chunk_outs is not None:
            out = chunk_outs[bi]
        else:
            gt_vidx = np.zeros((n_rows,), dtype=np.int64)
            gt_vidx[:n_real] = [video2idx_local.get(v, 0) for v in vids]
            out = [x.cpu().numpy()
                   for x in score_batch(batch, q_off, gt_vidx)]
        q_off += n_rows
        st_gt, ed_gt, tsc, tidx, fsc, fidx = (x[:n_real] for x in out)
        if "SVMR" in opts.full_eval_tasks and has_gt_target:
            svmr_st.append(st_gt)
            svmr_ed.append(ed_gt)
        top_scores_all.append(tsc)
        top_idx_all.append(tidx)
        flat_scores_all.append(fsc)
        flat_idx_all.append(fidx)

    sorted_q2c_scores = np.concatenate(top_scores_all, 0)
    sorted_q2c_indices = np.concatenate(top_idx_all, 0)
    flat_scores = np.concatenate(flat_scores_all, 0)
    flat_indices = np.concatenate(flat_idx_all, 0)

    svmr_res, vr_res, vcmr_res = [], [], []
    if "SVMR" in opts.full_eval_tasks and has_gt_target and svmr_st:
        st_total = np.concatenate(svmr_st, 0)
        ed_total = np.concatenate(svmr_ed, 0)
        prod = np.einsum("bm,bn->bmn", st_total, ed_total)
        prod *= tvr_metrics.generate_min_max_length_mask(
            prod.shape, opts.min_pred_l, opts.max_pred_l)
        triples = tvr_metrics.find_max_triples_from_upper_triangle_product(
            prod, top_n=opts.max_before_nms)
        for i, (qid, vid) in enumerate(zip(total_qids, total_vids)):
            t = triples[i]
            t[:, 1] += 1                       # ed index is inclusive
            t[:, :2] *= opts.vfeat_interval
            svmr_res.append(dict(
                desc_id=int(qid), desc="",
                predictions=[[video2idx_global[vid]] + row
                             for row in t.tolist()]))

    if "VR" in opts.full_eval_tasks:
        for i in range(len(total_qids)):
            preds = []
            for sc, vi in zip(sorted_q2c_scores[i, :100],
                              sorted_q2c_indices[i, :100]):
                preds.append([video2idx_global[video_ids[int(vi)]], 0, 0,
                              float(sc)])
            vr_res.append(dict(desc_id=int(total_qids[i]), desc="",
                               predictions=preds))

    if "VCMR" in opts.full_eval_tasks:
        for i in range(len(total_qids)):
            v_loc, st_i, ed_i = np.unravel_index(
                flat_indices[i], shape=(max_v, L, L))
            v_meta = sorted_q2c_indices[i, v_loc]
            st_sec = st_i.astype(np.float32) * opts.vfeat_interval
            ed_sec = (ed_i.astype(np.float32) * opts.vfeat_interval
                      + opts.vfeat_interval)
            preds = []
            for j, (vm, sc) in enumerate(zip(v_meta, flat_scores[i])):
                preds.append([video2idx_global[video_ids[int(vm)]],
                              float(st_sec[j]), float(ed_sec[j]),
                              float(sc)])
            vcmr_res.append(dict(desc_id=int(total_qids[i]), desc="",
                                 predictions=preds))

    eval_res = dict(SVMR=svmr_res, VCMR=vcmr_res, VR=vr_res)
    eval_res = {k: v for k, v in eval_res.items() if len(v) != 0}
    eval_res["video2idx"] = video2idx_global
    submission = tvr_metrics.get_submission_top_n(
        eval_res, top_n=opts.max_after_nms)

    val_log: Dict[str, float] = {}
    metrics = None
    if has_gt_target and partial_query_data:
        metrics = tvr_metrics.eval_retrieval(
            submission, partial_query_data, iou_thds=VCMR_IOU_THDS,
            match_number=True, verbose=False,
            use_desc_type=opts.eval_with_query_type)
        metrics = _merged_metrics(metrics, n_ex, distributed)
        for task_type, task_metric in metrics.items():
            for k, v in task_metric.items():
                val_log[f"valid_{task_type}/{task_type}_{k}"] = v
        if opts.nms_thd != -1:
            # NMS runs on the already top-max_after_nms lists and its
            # result is what the submission carries (the reference's
            # aliasing quirk, as reproduced by the JAX package)
            after = dict(video2idx=submission["video2idx"])
            if "SVMR" in submission:
                after["SVMR"] = tvr_metrics.post_processing_svmr_nms(
                    submission["SVMR"], nms_thd=opts.nms_thd,
                    max_before_nms=opts.max_before_nms,
                    max_after_nms=opts.max_after_nms)
            if "VCMR" in submission:
                after["VCMR"] = tvr_metrics.post_processing_vcmr_nms(
                    submission["VCMR"], nms_thd=opts.nms_thd,
                    max_before_nms=opts.max_before_nms,
                    max_after_nms=opts.max_after_nms)
            metrics_nms = tvr_metrics.eval_retrieval(
                after, partial_query_data, iou_thds=VCMR_IOU_THDS,
                match_number=True, verbose=False,
                use_desc_type=opts.eval_with_query_type)
            metrics_nms = _merged_metrics(metrics_nms, n_ex, distributed)
            for task_type, task_metric in metrics_nms.items():
                for k, v in task_metric.items():
                    val_log[f"valid_{task_type}_nms_{opts.nms_thd}/"
                            f"{task_type}_{k}"] = v
    if distributed:
        # each rank scored its own queries: the returned submission
        # carries every rank's, merged after the per-rank metrics above
        submission = _merge_process_submissions(submission)
    return val_log, submission, metrics


def _merged_metrics(metrics, n_ex: int, distributed: bool):
    """The metrics of every rank's queries (``distributed``), else of this
    rank's, through the example-weighted merge either way: it drops
    ``desc_type_ratio`` and evaluates n*m/n exactly as the JAX package's
    does, so the floats agree bit for bit."""
    if distributed:
        return aggregate_distributed_metrics(metrics, n_ex)
    return _weighted([n_ex], [metrics], metrics)


def _weighted(n_per_rank, m_per_rank, metrics):
    total = sum(n_per_rank)
    return {task_type: {k: sum(n * m_per_rank[i][task_type][k]
                               for i, n in enumerate(n_per_rank))
                        / max(total, 1)
                        for k in task_metric if k != "desc_type_ratio"}
            for task_type, task_metric in metrics.items()}


def aggregate_distributed_metrics(metrics, n_ex: int):
    """Example-count-weighted metric averaging across the ranks
    (``hero_tpu/evaluation/vcmr_eval.py:817-833``; reference
    eval_vcmr.py:430-448); the same value on every rank."""
    return _weighted(dist.data_allgather(n_ex), dist.data_allgather(metrics),
                     metrics)


def _merge_process_submissions(submission):
    """Every rank's submission rows, rank after rank, so every rank holds
    the whole query set (``hero_tpu/evaluation/vcmr_eval.py:801-814``;
    reference ``all_gather_list(results)``, eval_vcmr.py:125-140);
    identity for a single process."""
    if dist.data_world() == 1:
        return submission
    subs = dist.data_allgather(submission)
    merged = {"video2idx": submission["video2idx"]}
    for task in ("SVMR", "VCMR", "VR"):
        rows = [r for s in subs for r in s.get(task, [])]
        if rows:
            merged[task] = rows
    return merged
