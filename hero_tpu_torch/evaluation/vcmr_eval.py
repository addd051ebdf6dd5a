"""Full-corpus VCMR / SVMR / VR evaluation -- the serving path
(counterpart of ``hero_tpu/evaluation/vcmr_eval.py``).

- **Phase 1** embeds every video through the backbone into a corpus
  tensor ``(Nv, max_clip_len, D)`` kept resident on the device.
- **Phase 2** encodes each query batch and scores it against the whole
  corpus: video-level cosine scores sharpened by ``exp(q2c_alpha * s)``,
  an exact top-``max_vcmr_video`` over videos, st/ed span probabilities on
  the selected videos only, the in-band (st, ed) span scores and an exact
  top-``max_before_nms`` over them.  Both top-k's order by value
  descending with ties to the lowest flat index, as ``lax.top_k`` does.
- The host decodes the flat indices into (video, st, ed) seconds, builds
  the reference-schema submission and computes the metrics.

Only the resident-corpus, single-device, one-row-per-query branch is
ported; the chunked corpus and packed queries raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from hero_tpu_torch import resolve_device
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.const import VCMR_IOU_THDS
from hero_tpu_torch.evaluation import tvr_metrics
from hero_tpu_torch.models import nn
from hero_tpu_torch.models import pretrain as pretrain_lib
from hero_tpu_torch.models.model import without_task_heads
from hero_tpu_torch.models import vcmr as vcmr_lib
from hero_tpu_torch.models.pretrain import VsmConfig


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
    # not ported yet (ROADMAP A3): nonzero / True raise NotImplementedError
    corpus_chunk_videos: int = 0
    pack_queries: bool = False


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The numpy arrays of a host batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def embed_video_corpus(params, cfg: HeroConfig,
                       video_batches: Iterable[Dict[str, np.ndarray]],
                       dtype: torch.dtype = torch.bfloat16,
                       device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1: (Nv, max_clip_len, D) frame embeddings + (Nv, L) masks, on
    ``device``."""
    device = resolve_device(device)
    params = nn.tree_to(without_task_heads(params), device)
    embs, masks = [], []
    with torch.inference_mode():
        for batch in video_batches:
            tb = batch_to_device(batch, device)
            embs.append(vcmr_lib.encode_video_corpus(params, cfg, tb, dtype))
            masks.append(tb["c_attn_masks"])
    return torch.cat(embs, 0), torch.cat(masks, 0)


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


def make_query_scorer(params, cfg: HeroConfig, vsm: VsmConfig,
                      opts: VcmrEvalOpts, frame_embs: torch.Tensor,
                      frame_masks: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16,
                      n_real_videos: Optional[int] = None):
    """Phase-2 function scoring one query batch against the resident
    corpus.  ``n_real_videos`` keeps trailing pad rows of the corpus out of
    the ranking.  Returns (score, max_v); ``score(q_ids, q_masks, gt_vidx)``
    gives the ranker's outputs (see :func:`_make_ranker`) on the device."""
    _check_ranking_weights(vsm)
    device = frame_embs.device
    n_rows, L = int(frame_embs.shape[0]), int(frame_embs.shape[1])
    rank, max_v = _make_ranker(
        opts, n_real_videos if n_real_videos is not None else n_rows,
        n_rows, L, device)
    fmask32 = frame_masks.float()

    @torch.inference_mode()
    def score(q_ids, q_masks, gt_vidx=None):
        q_ids = torch.as_tensor(q_ids, device=device)
        q_masks = torch.as_tensor(q_masks, device=device)
        gt_vidx = (torch.zeros(q_ids.shape[0], dtype=torch.int64,
                               device=device)
                   if gt_vidx is None
                   else torch.as_tensor(gt_vidx, device=device).long())
        mod = pretrain_lib.encode_query(params, cfg, q_ids, q_masks,
                                        dtype=dtype)
        sim = pretrain_lib.get_st_ed_sim(params["head"], mod, frame_embs)
        scores = pretrain_lib.get_video_level_scores(mod, frame_embs,
                                                     fmask32)
        return rank(sim, scores, gt_vidx, params["head"], fmask32)

    return score, max_v


def validate_full_vcmr(params, cfg: HeroConfig, vsm: VsmConfig,
                       opts: VcmrEvalOpts,
                       video_batches: Iterable[Dict[str, np.ndarray]],
                       query_batches: Iterable[Dict[str, Any]],
                       video_ids: List[str],
                       video2idx_global: Dict[str, int],
                       query_data: Dict[Any, dict],
                       dtype: torch.dtype = torch.bfloat16,
                       device="cuda"):
    """Run the full two-phase evaluation.

    ``query_batches`` yield dicts with numpy ``query_input_ids`` (N, Lq),
    ``query_attn_masks``, plus host lists ``qids`` and ``vids`` (GT video
    per query, "" if unknown).  Returns (val_log, submission, metrics)."""
    if opts.corpus_chunk_videos and opts.corpus_chunk_videos < len(video_ids):
        raise NotImplementedError(
            "corpus_chunk_videos (chunked corpus scoring) is not ported yet; "
            "see ROADMAP A3 (chunked corpus)")
    if opts.pack_queries:
        raise NotImplementedError(
            "pack_queries (packed query encoding) is not ported yet; see "
            "ROADMAP A3 (packed queries)")
    device = resolve_device(device)
    params = nn.tree_to(without_task_heads(params), device)
    video2idx_local = {v: i for i, v in enumerate(video_ids)}
    frame_embs, frame_masks = embed_video_corpus(
        params, cfg, video_batches, dtype, device)
    scorer, max_v = make_query_scorer(
        params, cfg, vsm, opts, frame_embs, frame_masks, dtype,
        n_real_videos=len(video_ids))
    L = int(frame_embs.shape[1])

    total_qids, total_vids = [], []
    svmr_st, svmr_ed = [], []
    top_scores_all, top_idx_all = [], []
    flat_scores_all, flat_idx_all = [], []
    has_gt_target = True
    n_ex = 0
    partial_query_data = []
    for batch in query_batches:
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
        gt_vidx = np.zeros((n_rows,), dtype=np.int64)
        gt_vidx[:n_real] = [video2idx_local.get(v, 0) for v in vids]
        out = scorer(torch.from_numpy(np.asarray(batch["query_input_ids"])),
                     torch.from_numpy(np.asarray(batch["query_attn_masks"])),
                     torch.from_numpy(gt_vidx))
        st_gt, ed_gt, tsc, tidx, fsc, fidx = (
            x.cpu().numpy()[:n_real] for x in out)
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
        metrics = _example_weighted(metrics, n_ex)
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
            metrics_nms = _example_weighted(metrics_nms, n_ex)
            for task_type, task_metric in metrics_nms.items():
                for k, v in task_metric.items():
                    val_log[f"valid_{task_type}_nms_{opts.nms_thd}/"
                            f"{task_type}_{k}"] = v
    return val_log, submission, metrics


def _example_weighted(metrics, n_ex: int):
    """The single-process case of the JAX package's example-weighted
    metric merge: drops ``desc_type_ratio`` and evaluates n*m/n exactly as
    that merge does, so the floats agree bit for bit."""
    return {task_type: {k: sum([n_ex * v]) / max(n_ex, 1)
                        for k, v in task_metric.items()
                        if k != "desc_type_ratio"}
            for task_type, task_metric in metrics.items()}
