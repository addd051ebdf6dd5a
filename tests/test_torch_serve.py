"""hero_tpu_torch serving path against the JAX package: the two-phase
``validate_full_vcmr`` on the same weights (through the bridge) and the
same numpy batches, and the exact top-k ranker on tie-heavy inputs.
Everything is fp32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config.model_config import tiny_hero_config as jax_tiny_config
from hero_tpu.data import synthetic as jsyn
from hero_tpu.data.occupancy import VideoShape
from hero_tpu.evaluation import vcmr_eval as jeval
from hero_tpu.models import pretrain as jpre
from hero_tpu.training.save import flatten_tree
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert.from_jax import load_jax_params
from hero_tpu_torch.evaluation import tvr_metrics
from hero_tpu_torch.evaluation import vcmr_eval as teval
from hero_tpu_torch.models import pretrain as tpre

VSM = dict(lw_neg_ctx=1.0, lw_neg_q=1.0, lw_st_ed=0.01)
INTERVAL = 1.5


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny_config()
    params = jpre.init_hero_for_pretraining(jax.random.PRNGKey(0), jcfg)
    tparams = load_jax_params(flatten_tree(jax.device_get(params)),
                              device="cpu")
    return jcfg, tiny_hero_config(), params, tparams


def _video_batches(kind):
    if kind == "unpacked":
        shape = dataclasses.replace(jsyn.TINY, batch=3)
        return [jsyn.base_batch(shape, seed=10 + i) for i in range(2)]
    shape = dataclasses.replace(jsyn.TINY, batch=3, n_subs=3, txt_len=12,
                                frames_per_sub=6)
    r = np.random.RandomState(20)
    out = []
    for i in range(2):
        videos = []
        for _ in range(shape.batch):
            n = r.randint(2, 6)
            videos.append(VideoShape(
                int(r.randint(8, 17)), [int(x) for x in r.randint(2, 9, n)],
                [int(x) for x in r.randint(1, 4, n)]))
        b, _ = jsyn.tv_vsm_batch(videos, shape, packed=True, seed=30 + i)
        out.append({k: v for k, v in b.items()
                    if k.startswith(("sub_", "c_"))})
    return out


def _queries(video_ids, n_q=7, seed=0):
    r = np.random.RandomState(seed)
    gt = [video_ids[r.randint(len(video_ids))] for _ in range(n_q)]
    qd = {}
    for q in range(n_q):
        st = r.randint(0, 8)
        qd[q] = {"desc_id": q, "desc": "", "vid_name": gt[q],
                 "ts": [st * INTERVAL, (st + r.randint(2, 6)) * INTERVAL],
                 "type": ("v", "t", "vt")[q % 3]}
    lens = r.randint(3, 7, (n_q,))
    batches = []
    for s in (0, 4):                       # a full batch and a short tail
        e = min(s + 4, n_q)
        batches.append({
            "qids": list(range(s, e)), "vids": gt[s:e],
            "query_input_ids": r.randint(3, 128, (e - s, 6)).astype(np.int32),
            "query_attn_masks": (np.arange(6)[None] < lens[s:e, None]
                                 ).astype(np.float32)})
    return batches, qd


@pytest.mark.parametrize("corpus", ["unpacked", "packed"])
def test_validate_full_vcmr_matches_jax(setup, corpus):
    jcfg, tcfg, params, tparams = setup
    video_ids = [f"vid{i}" for i in range(6)]
    video2idx = {v: 100 + i for i, v in enumerate(video_ids)}
    qbatches, qd = _queries(video_ids)
    opts = dict(max_vcmr_video=5, min_pred_l=2, max_pred_l=8,
                max_before_nms=40, max_after_nms=20, nms_thd=0.5,
                vfeat_interval=INTERVAL, max_clip_len=jsyn.TINY.n_frames)
    jlog, jsub, jmet = jeval.validate_full_vcmr(
        params, jcfg, jpre.VsmConfig(**VSM), jeval.VcmrEvalOpts(**opts),
        _video_batches(corpus), [dict(b) for b in qbatches], video_ids,
        video2idx, qd, dtype=jnp.float32)
    tlog, tsub, tmet = teval.validate_full_vcmr(
        tparams, tcfg, tpre.VsmConfig(**VSM), teval.VcmrEvalOpts(**opts),
        _video_batches(corpus), [dict(b) for b in qbatches], video_ids,
        video2idx, qd, dtype=torch.float32, device="cpu")

    assert set(tsub) == set(jsub) == {"video2idx", "VR", "VCMR", "SVMR"}
    for task in ("VR", "VCMR", "SVMR"):
        assert len(tsub[task]) == len(jsub[task]) == len(qd)
        for te, je in zip(tsub[task], jsub[task]):
            assert te["desc_id"] == je["desc_id"]
            tp = np.asarray(te["predictions"])
            jp = np.asarray(je["predictions"])
            assert tp.shape == jp.shape
            # (video, st, ed) exactly; scores to fp32 noise amplified by
            # exp(q2c_alpha * s) with q2c_alpha = 20
            np.testing.assert_array_equal(tp[:, :3], jp[:, :3],
                                          err_msg=task)
            np.testing.assert_allclose(tp[:, 3], jp[:, 3], rtol=1e-4,
                                       atol=1e-12, err_msg=task)
    assert tmet == jmet
    assert tlog == jlog
    assert any("nms" in k for k in tlog)


def test_ranker_exact_with_ties_matches_jax_and_numpy():
    """The port's ranker (two stable-sort top-k's) on tie-heavy quantized
    inputs with corpus pad rows equals a brute-force numpy ranking (value
    descending, flat (video, st*L+ed) ascending: ``lax.top_k``'s order)
    index for index, and picks the same videos and span values as the
    JAX package's chunked ranker."""
    L, n_videos, n_rows, nq = 16, 20, 24, 5
    kw = dict(max_vcmr_video=10, min_pred_l=2, max_pred_l=6,
              max_before_nms=60, vfeat_interval=1.5, max_clip_len=L)
    r = np.random.RandomState(3)
    sim = (np.round(r.randn(nq, n_rows, L) * 2) / 2).astype(np.float32)
    scores = (np.round(r.randn(nq, n_rows) * 4) / 8).astype(np.float32)
    scores[:, n_videos:] = 10.0      # pad rows must never be selected
    gt = r.randint(0, n_videos, (nq,))
    fmask = np.ones((n_rows, L), np.float32)
    fmask[:, L - 3:] = 0.0

    jhead = {"video_st_predictor": {"kernel": jnp.ones((1,), jnp.float32)},
             "video_ed_predictor": {"kernel": jnp.full((1,), 2.0,
                                                       jnp.float32)}}
    jrank, max_v = jeval._make_ranker(jeval.VcmrEvalOpts(**kw), n_videos,
                                      n_rows, L)
    jout = [np.asarray(x) for x in jax.jit(jrank)(
        jnp.asarray(sim), jnp.asarray(scores), jnp.asarray(gt, jnp.int32),
        jhead, jnp.asarray(fmask))]

    thead = {"video_st_predictor": {"kernel": torch.ones(1)},
             "video_ed_predictor": {"kernel": torch.full((1,), 2.0)}}
    trank, tmax_v = teval._make_ranker(teval.VcmrEvalOpts(**kw), n_videos,
                                       n_rows, L, torch.device("cpu"))
    t = torch.from_numpy
    tout = [x.numpy() for x in trank(t(sim), t(scores), t(gt), thead,
                                     t(fmask))]
    assert tmax_v == max_v
    st_gt, ed_gt, tsc, tidx, sc2, fidx = tout

    # brute force with the port's own exp and softmax (ties are decided
    # by the values each framework computes)
    sharp = torch.exp(20.0 * t(scores)).numpy()
    sharp[:, n_videos:] = -1.0
    st_p = torch.softmax(t(sim + (1.0 - fmask[None]) * -1e4), -1).numpy()
    ed_p = torch.softmax(t(sim * 2 + (1.0 - fmask[None]) * -1e4),
                         -1).numpy()
    band = tvr_metrics.generate_min_max_length_mask(
        (1, 1, L, L), kw["min_pred_l"], kw["max_pred_l"])[0, 0]
    band_flat = np.flatnonzero(band.reshape(-1))
    k = kw["max_before_nms"]
    for qi in range(nq):
        order = np.argsort(-sharp[qi], kind="stable")[:max_v]
        np.testing.assert_array_equal(tidx[qi], order)
        cands = []
        for rank_i, vi in enumerate(order):
            cube = (np.outer(st_p[qi, vi], ed_p[qi, vi])
                    * sharp[qi, vi]).reshape(-1)
            cands += [(-cube[f], rank_i * L * L + f, cube[f])
                      for f in band_flat]
        cands.sort()
        np.testing.assert_array_equal(fidx[qi], [c[1] for c in cands[:k]])
        np.testing.assert_allclose(sc2[qi], [c[2] for c in cands[:k]],
                                   rtol=1e-6)
    np.testing.assert_array_equal(st_gt, st_p[np.arange(nq), gt])

    # against the JAX package: the same videos in the same order, the
    # same values; among span candidates whose values the two frameworks
    # round one ulp apart the order may differ, so JAX's flat indices are
    # held by the values they pick in the port's cube
    for name, a, b in zip(("st_gt", "ed_gt", "tsc", "sc2"),
                          (st_gt, ed_gt, tsc, sc2),
                          (jout[0], jout[1], jout[2], jout[4])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-30,
                                   err_msg=name)
    np.testing.assert_array_equal(tidx, jout[3])
    v_loc, st_i, ed_i = np.unravel_index(jout[5], (max_v, L, L))
    vid = np.take_along_axis(tidx, v_loc, 1)
    q = np.arange(nq)[:, None]
    picked = st_p[q, vid, st_i] * ed_p[q, vid, ed_i] * sharp[q, vid]
    np.testing.assert_allclose(picked, sc2, rtol=1e-6)


def test_topk_lowest_index_breaks_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0]])
    vals, idx = teval.topk_lowest_index(x, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]


@pytest.mark.parametrize("opt", [{"corpus_chunk_videos": 2,
                                  "pack_queries": True},
                                 {"corpus_chunk_videos": 2}])
def test_unported_serving_options_raise(setup, opt):
    """The serving options' invalid uses raise as the JAX package's do:
    packed queries with the chunked corpus (ValueError), and a chunk that
    is not a whole number of video batches (3-video batches, chunks of 2)."""
    _, tcfg, _, tparams = setup
    video_ids = [f"vid{i}" for i in range(6)]
    qbatches, qd = _queries(video_ids)
    err, match = ((ValueError, "pack_queries") if opt.get("pack_queries")
                  else (AssertionError, "multiple of the video batch"))
    with pytest.raises(err, match=match):
        teval.validate_full_vcmr(
            tparams, tcfg, tpre.VsmConfig(**VSM),
            teval.VcmrEvalOpts(max_clip_len=jsyn.TINY.n_frames, **opt),
            _video_batches("unpacked"), qbatches, video_ids,
            {v: i for i, v in enumerate(video_ids)}, qd,
            dtype=torch.float32, device="cpu")
