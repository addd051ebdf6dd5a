"""TVR retrieval metrics and temporal NMS (a copy of
``hero_tpu/evaluation/tvr_metrics.py``, without its CLI).

Protocol-exact re-implementation of the reference evaluators
(``utils/tvr_eval_utils.py``, ``utils/tvr_standalone_eval.py``), quirks
included, so submission files and evaluation servers agree:

- temporal "IoU" uses span-hull as the union (not the true union);
- greedy NMS keeps at most ``max_after_nms`` and then appends one more
  (possibly lower-scored) leftover if room remains;
- R@K x IoU recall counts a query correct if >= 1 of its top-K predictions
  matches; DiDeMo-style multi-GT (>= 4 spans) requires overlap with >= 2 GT
  spans; percentages are rounded to 2 decimals;
- the min/max span-length mask is an upper-triangle band (min_l <= ed-st
  < max_l, with ed exclusive before the +1 decode shift).

Submission schema: ``{"video2idx": {...}, "VCMR"|"SVMR"|"VR":
[{"desc_id", "desc", "predictions": [[vidx, st, ed, score], ...]}]}``.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

TASK_TYPES = OrderedDict([
    ("VCMR", "Video Corpus Moment Retrieval"),
    ("SVMR", "Single Video Moment Retrieval"),
    ("VR", "regular Video Retrieval"),
])

DESC_TYPE2IDX = {"v": 0, "t": 1, "vt": 2}


def temporal_iou(pred: Sequence[float], gt: Sequence[float]) -> float:
    """Span-hull IoU of two [st, ed] spans (reference
    tvr_eval_utils.py:14-32 — the "union" is the hull, kept for parity)."""
    inter = max(0.0, min(pred[1], gt[1]) - max(pred[0], gt[0]))
    union = max(pred[1], gt[1]) - min(pred[0], gt[0])
    return inter / union if union != 0 else 0.0


def temporal_iou_batch(preds: np.ndarray, gt: Sequence[float]) -> np.ndarray:
    """(N, 2) spans vs one GT span → (N,) IoU (tvr_standalone_eval:58-74)."""
    inter = np.maximum(
        0, np.minimum(preds[:, 1], gt[1]) - np.maximum(preds[:, 0], gt[0]))
    union = np.maximum(preds[:, 1], gt[1]) - np.minimum(preds[:, 0], gt[0])
    return np.divide(inter, union, out=np.zeros_like(inter),
                     where=union != 0)


def temporal_nms(predictions: List[List[float]], nms_threshold: float,
                 max_after_nms: int = 100) -> List[List[float]]:
    """Greedy temporal NMS over [st, ed, score] rows, larger score wins
    (reference tvr_eval_utils.py:35-92, incl. the append-last behavior)."""
    if len(predictions) == 1:
        return predictions
    preds = sorted(predictions, key=lambda x: x[2], reverse=True)
    tst = [e[0] for e in preds]
    ted = [e[1] for e in preds]
    tsc = [e[2] for e in preds]
    rst, red, rsc = [], [], []
    while len(tst) > 1 and len(rsc) < max_after_nms:
        idx = 1
        while idx < len(tst):
            if temporal_iou([tst[0], ted[0]],
                            [tst[idx], ted[idx]]) > nms_threshold:
                tst.pop(idx); ted.pop(idx); tsc.pop(idx)
            else:
                idx += 1
        rst.append(tst.pop(0)); red.append(ted.pop(0)); rsc.append(tsc.pop(0))
    if len(rsc) < max_after_nms and len(tst) >= 1:
        rst.append(tst.pop(0)); red.append(ted.pop(0)); rsc.append(tsc.pop(0))
    return [[st, ed, sc] for sc, st, ed in zip(rsc, rst, red)]


def top_n_array_2d(array_2d: np.ndarray, top_n: int) -> np.ndarray:
    """Top-N (row, col, value) of a 2-D array, value-descending
    (reference tvr_eval_utils.py:95-108)."""
    rows, cols = np.unravel_index(np.argsort(array_2d, axis=None),
                                  array_2d.shape)
    rows = rows[::-1][:top_n]
    cols = cols[::-1][:top_n]
    vals = array_2d[rows, cols]
    return np.stack([rows, cols, vals], axis=1)


def find_max_triples_from_upper_triangle_product(
        upper_product: np.ndarray, top_n: int = 5,
        prob_thd: Optional[float] = None) -> List[np.ndarray]:
    """(N, L, L) span-score cubes → per-query top-N (st, ed, score)
    (reference tvr_eval_utils.py:111-131)."""
    out = []
    for mat in upper_product:
        triples = top_n_array_2d(mat, top_n=top_n)
        if prob_thd is not None:
            triples = triples[triples[:, 2] >= prob_thd]
        out.append(triples)
    return out


def generate_min_max_length_mask(array_shape, min_l: int,
                                 max_l: int) -> np.ndarray:
    """Upper-triangle band mask: valid iff min_l ≤ col-row < max_l
    (reference tvr_eval_utils.py:237-260)."""
    single = (1,) * (len(array_shape) - 2)
    ones = np.ones(single + tuple(array_shape[-2:]), dtype=np.float32)
    return np.triu(ones, k=min_l) * (1 - np.triu(ones, k=max_l))


def filter_vcmr_by_nms(all_video_predictions, nms_threshold=0.6,
                       max_before_nms=1000, max_after_nms=100,
                       score_col_idx=3):
    """Group by video → per-video NMS → global re-sort
    (reference tvr_eval_utils.py:134-174)."""
    by_video = defaultdict(list)
    for pred in all_video_predictions[:max_before_nms]:
        by_video[pred[0]].append(pred[1:])
    out = []
    for vidx, grouped in by_video.items():
        for pred in temporal_nms(grouped, nms_threshold=nms_threshold):
            out.append([vidx] + pred)
    out = sorted(out, key=lambda x: x[score_col_idx],
                 reverse=True)[:max_after_nms]
    return out


def post_processing_vcmr_nms(vcmr_res, nms_thd=0.6, max_before_nms=1000,
                             max_after_nms=100):
    for e in vcmr_res:
        e["predictions"] = filter_vcmr_by_nms(
            e["predictions"], nms_threshold=nms_thd,
            max_before_nms=max_before_nms, max_after_nms=max_after_nms)
    return vcmr_res


def post_processing_svmr_nms(svmr_res, nms_thd=0.6, max_before_nms=1000,
                             max_after_nms=100):
    for e in svmr_res:
        preds = [d[1:] for d in e["predictions"][:max_before_nms]]
        preds = temporal_nms(preds, nms_threshold=nms_thd)[:max_after_nms]
        vidx = e["predictions"][0][0]
        e["predictions"] = [[vidx] + d for d in preds]
    return svmr_res


def get_submission_top_n(submission, top_n=100):
    out = dict(video2idx=submission["video2idx"])
    for k, v in submission.items():
        if k == "video2idx":
            continue
        out[k] = [dict(e, predictions=e["predictions"][:top_n]) for e in v]
    return out


def _pct(x, n_floats=2):
    return round(float(x) * 100, n_floats)


def eval_by_task_type(moment_predictions, video2idx, ground_truth,
                      iou_thds=(0.5, 0.7), recall_topks=(1, 5, 10, 100),
                      task_type="SVMR", max_pred_per_query=100,
                      match_number=True, verbose=False, use_desc_type=True):
    """R@K×IoU evaluator (reference tvr_standalone_eval.py:88-258)."""
    assert task_type in TASK_TYPES
    preds_by_id = {e["desc_id"]: e for e in moment_predictions}
    gt_by_id = {e["desc_id"]: e for e in ground_truth}
    if match_number:
        assert set(gt_by_id) == set(preds_by_id), (
            "desc_ids in predictions and ground_truth must match")

    rows_list, desc_types = [], []
    for k, gt_item in gt_by_id.items():
        if not match_number and k not in preds_by_id:
            continue
        mat = np.array([e[:3] for e in
                        preds_by_id[k]["predictions"][:max_pred_per_query]],
                       dtype=np.float32)                      # (n_pred, 3)
        if use_desc_type:
            desc_types.append(DESC_TYPE2IDX[gt_item["type"]])
        vid_match = mat[:, 0] == video2idx[gt_item["vid_name"]]
        mat = np.concatenate([mat, vid_match[:, None]], axis=1)
        if "ts" in gt_item:
            iou_cols = []
            if len(gt_item["ts"]) >= 4:   # DiDeMo multi-GT, ≥2-overlap rule
                per_thd = defaultdict(list)
                for single_ts in gt_item["ts"]:
                    ious = temporal_iou_batch(
                        mat[:, 1:3], np.asarray(single_ts,
                                                np.float32)) * vid_match
                    for thd in iou_thds:
                        per_thd[thd].append(ious >= thd)
                for thd in iou_thds:
                    iou_cols.append((sum(per_thd[thd]) >= 2)[:, None])
            else:
                ious = temporal_iou_batch(
                    mat[:, 1:3],
                    np.asarray(gt_item["ts"], np.float32)) * vid_match
                for thd in iou_thds:
                    iou_cols.append((ious >= thd)[:, None])
            mat = np.concatenate([mat] + iou_cols, axis=1)
        rows_list.append(mat)

    n_desc = len(rows_list)
    max_pred = max(len(m) for m in rows_list)
    width = rows_list[0].shape[1]
    coll = np.zeros((n_desc, max_pred, width), np.float32)
    for i, m in enumerate(rows_list):
        coll[i, :len(m)] = m
    desc_types = np.asarray(desc_types)

    metrics, metrics_by_type = OrderedDict(), OrderedDict()
    off = 4
    if task_type == "VCMR":
        for ti, thd in enumerate(iou_thds):
            iou_ok = coll[:, :, off + ti].astype(bool)
            for k in recall_topks:
                metrics[f"{thd}-r{k}"] = _pct(
                    np.mean(np.sum(iou_ok[:, :k], axis=1) >= 1))
        if use_desc_type:
            for dt, dti in DESC_TYPE2IDX.items():
                sel = desc_types == dti
                n_t = max(np.sum(sel), 1)
                for ti, thd in enumerate(iou_thds):
                    iou_ok = coll[:, :, off + ti].astype(bool)
                    for k in recall_topks:
                        metrics_by_type[f"{dt}-{thd}-r{k}"] = _pct(
                            np.sum((np.sum(iou_ok[:, :k], axis=1) >= 1)
                                   & sel) / n_t)
    elif task_type == "SVMR":
        vid_ok = coll[:, :, 3].astype(bool)
        for ti, thd in enumerate(iou_thds):
            iou_ok = coll[:, :, off + ti].astype(bool)
            for k in recall_topks:
                metrics[f"{thd}-r{k}"] = _pct(np.mean(
                    [np.sum(iou_ok[i][vid_ok[i]][:k]) >= 1
                     for i in range(n_desc)]))
        if use_desc_type:
            for dt, dti in DESC_TYPE2IDX.items():
                sel = desc_types == dti
                n_t = max(np.sum(sel), 1)
                for ti, thd in enumerate(iou_thds):
                    iou_ok = coll[:, :, off + ti].astype(bool)
                    for k in recall_topks:
                        metrics_by_type[f"{dt}-{thd}-r{k}"] = _pct(
                            np.sum([np.sum(iou_ok[i][vid_ok[i]][:k]) >= 1
                                    and sel[i] for i in range(n_desc)])
                            / n_t)
    elif task_type == "VR":
        vid_ok = coll[:, :, 3].astype(bool)
        for k in recall_topks:
            metrics[f"r{k}"] = _pct(
                np.mean(np.sum(vid_ok[:, :k], axis=1) >= 1))
        if use_desc_type:
            for dt, dti in DESC_TYPE2IDX.items():
                sel = desc_types == dti
                n_t = max(np.sum(sel), 1)
                for k in recall_topks:
                    metrics_by_type[f"{dt}-r{k}"] = _pct(
                        np.sum((np.sum(vid_ok[:, :k], axis=1) >= 1) & sel)
                        / n_t)
    if use_desc_type and len(desc_types):
        metrics_by_type["desc_type_ratio"] = "v {} t {} vt {}".format(
            *[_pct(np.sum(desc_types == DESC_TYPE2IDX[k]) / len(desc_types))
              for k in ["v", "t", "vt"]])
    return metrics, metrics_by_type


def eval_retrieval(submission, ground_truth, iou_thds=(0.5, 0.7),
                   verbose=False, match_number=True, use_desc_type=True):
    """Evaluate every task type found in the submission
    (reference tvr_standalone_eval.py:260-283)."""
    video2idx = submission["video2idx"]
    tasks = [k for k in TASK_TYPES if k in submission]
    eval_metrics = OrderedDict()
    raw = {}
    for t in tasks:
        m, mbt = eval_by_task_type(
            submission[t], video2idx, ground_truth, iou_thds=iou_thds,
            recall_topks=(1, 5, 10, 100), task_type=t,
            max_pred_per_query=100, match_number=match_number,
            verbose=verbose, use_desc_type=use_desc_type)
        raw[t] = m
        raw[t + "_by_type"] = mbt
    for t in tasks:
        eval_metrics[t] = raw[t]
    if use_desc_type:
        for t in tasks:
            eval_metrics[t + "_by_type"] = raw[t + "_by_type"]
    return eval_metrics
