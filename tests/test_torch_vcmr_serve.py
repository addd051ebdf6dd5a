"""hero_tpu_torch's VCMR serving as a program against the JAX package:
query packing (``pack_queries``, ``pack_query_arrays``), packed query
encoding and the fused packed scorer, ``validate_full_vcmr`` with packed
queries and with the chunked corpus, ``get_pred_from_raw_query``, the
evaluation's query batches and inputs from herostore stores, the
evaluation options, ``drivers.eval_vcmr.main`` from a run directory, and
the ``--pp_stages`` guard.

One tiny model, one 12-video corpus and one set of stores serve every
test.  Everything is fp32 on the CPU (the JAX side too), on one torch
thread.
"""

import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config import opts as jopts
from hero_tpu.config.model_config import tiny_hero_config as jax_tiny_config
from hero_tpu.data import packing as jpacking
from hero_tpu.data import synthetic as jsyn
from hero_tpu.data.downstream_tasks import \
    VcmrFullEvalDataset as JVcmrFullEvalDataset
from hero_tpu.data.store import QueryTokStore as JQueryTokStore
from hero_tpu.drivers import common as jcommon
from hero_tpu.drivers import eval_vcmr as jdrv
from hero_tpu.drivers import train_vcmr as jtrain_vcmr
from hero_tpu.evaluation import vcmr_eval as jeval
from hero_tpu.models import pretrain as jpre
from hero_tpu.models import vcmr as jvcmr
from hero_tpu.training.save import unflatten_tree
from hero_tpu_torch.config import opts as topts
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert.from_jax import load_jax_params
from hero_tpu_torch.data import packing as tpacking
from hero_tpu_torch.data import testing as ttesting
from hero_tpu_torch.data.downstream_tasks import VcmrFullEvalDataset
from hero_tpu_torch.data.store import QueryTokStore
from hero_tpu_torch.drivers import common as tcommon
from hero_tpu_torch.drivers import eval_vcmr as tdrv
from hero_tpu_torch.drivers import pretrain as tpretrain_drv
from hero_tpu_torch.drivers import train_vcmr as ttrain_vcmr
from hero_tpu_torch.evaluation import vcmr_eval as teval
from hero_tpu_torch.models import pretrain as tpre
from hero_tpu_torch.models import vcmr as tvcmr
from hero_tpu_torch.parallel import pipeline as tpipeline

VSM = dict(lw_neg_ctx=1.0, lw_neg_q=1.0, lw_st_ed=0.01)
INTERVAL = 1.5
LQ = 6                       # query slots of the model-level tests
N_VIDEOS, VIDEO_BS = 12, 3   # the corpus: 4 video batches


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The tiny model in both packages, the 12-video corpus (4 batches of
    3), 9 queries of 2-6 tokens in batches of 5 and 4 with ground truth,
    and VCMR options."""
    jcfg, tcfg = jax_tiny_config(), tiny_hero_config()
    flat = tpre.init_flat_params(tcfg, tpre.VsmConfig(**VSM), seed=0)
    params = jax.tree.map(jnp.asarray, unflatten_tree(flat))
    tparams = load_jax_params(flat, device="cpu", heads=False)
    shape = dataclasses.replace(jsyn.TINY, batch=VIDEO_BS)
    videos = [jsyn.base_batch(shape, seed=30 + i)
              for i in range(N_VIDEOS // VIDEO_BS)]
    video_ids = [f"v{i}" for i in range(N_VIDEOS)]
    r = np.random.RandomState(21)
    nq = 9
    lens = r.randint(2, LQ + 1, (nq,))
    q_ids = r.randint(3, 128, (nq, LQ)).astype(np.int32)
    q_mask = (np.arange(LQ)[None] < lens[:, None]).astype(np.float32)
    q_ids[q_mask == 0] = 1
    gt = [video_ids[r.randint(N_VIDEOS)] for _ in range(nq)]
    qd = {q: {"desc_id": q, "desc": "", "vid_name": gt[q],
              "ts": [0.0, 4.5], "type": ("v", "t", "vt")[q % 3]}
          for q in range(nq)}
    qbatches = [{"qids": list(range(s, e)), "vids": gt[s:e],
                 "query_input_ids": q_ids[s:e],
                 "query_attn_masks": q_mask[s:e]}
                for s, e in ((0, 5), (5, 9))]
    opts = dict(max_vcmr_video=7, min_pred_l=1, max_pred_l=8,
                max_before_nms=25, max_after_nms=10, nms_thd=0.5,
                vfeat_interval=INTERVAL, max_clip_len=shape.n_frames)
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, params=params, tparams=tparams,
        videos=videos, video_ids=video_ids, q_ids=q_ids, q_mask=q_mask,
        lens=lens, qbatches=qbatches, qd=qd, opts=opts)


@pytest.fixture(scope="module")
def corpus(setup):
    """Both packages' resident fp32 corpus tensors of the 12 videos."""
    jembs, jmasks = jeval.embed_video_corpus(
        setup.params, setup.jcfg, setup.videos, setup.opts["max_clip_len"],
        dtype=jnp.float32)
    tembs, tmasks = teval.embed_video_corpus(
        setup.tparams, setup.tcfg, setup.videos, torch.float32, "cpu")
    return jembs, jmasks, tembs, tmasks


def _validate(pkg, s, **over):
    """``validate_full_vcmr`` of ``pkg`` ("jax" or "torch") on the fixture,
    fp32, with ``over`` replacing options."""
    kw = dict(s.opts, **over)
    qb = [dict(b) for b in s.qbatches]
    v2i = {v: i for i, v in enumerate(s.video_ids)}
    if pkg == "jax":
        return jeval.validate_full_vcmr(
            s.params, s.jcfg, jpre.VsmConfig(**VSM), jeval.VcmrEvalOpts(**kw),
            s.videos, qb, s.video_ids, v2i, s.qd, dtype=jnp.float32)
    return teval.validate_full_vcmr(
        s.tparams, s.tcfg, tpre.VsmConfig(**VSM), teval.VcmrEvalOpts(**kw),
        s.videos, qb, s.video_ids, v2i, s.qd, dtype=torch.float32,
        device="cpu")


def _assert_same_submission(a, b, rtol, n):
    """Every task's entries: the same ids, (video, st, ed) exactly, scores
    within ``rtol``."""
    assert set(a) == set(b) == {"video2idx", "VR", "VCMR", "SVMR"}
    for task in ("VR", "VCMR", "SVMR"):
        assert len(a[task]) == len(b[task]) == n
        for ea, eb in zip(a[task], b[task]):
            assert ea["desc_id"] == eb["desc_id"]
            pa, pb = np.asarray(ea["predictions"]), \
                np.asarray(eb["predictions"])
            assert pa.shape == pb.shape
            np.testing.assert_array_equal(pa[:, :3], pb[:, :3], err_msg=task)
            np.testing.assert_allclose(pa[:, 3], pb[:, 3], rtol=rtol,
                                       atol=1e-12, err_msg=task)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_len,max_segs,seed",
                         [(30, 4, 0), (30, 3, 1), (8, 2, 2), (16, 4, 3)])
def test_pack_queries_placements_equal_jax(row_len, max_segs, seed):
    r = np.random.RandomState(seed)
    lens = [int(x) for x in r.randint(1, row_len + 1, 200)]
    got, n_got = tpacking.pack_queries(lens, row_len, max_segs)
    want, n_want = jpacking.pack_queries(lens, row_len, max_segs)
    assert n_got == n_want < len(lens)
    assert [dataclasses.astuple(p) for p in got] == \
        [dataclasses.astuple(p) for p in want]


@pytest.mark.parametrize("lens", [[31], [5, 0]])
def test_pack_queries_refuses_a_query_outside_the_row(lens):
    for pack in (tpacking.pack_queries, jpacking.pack_queries):
        with pytest.raises(ValueError, match="outside"):
            pack(lens, 30)


def test_pack_query_arrays_equal_jax(setup):
    """Including a zero-length (pad) query, packed as length 1, and the
    rows padded to a ``rows_per_call`` multiple with all-pad rows."""
    lens = setup.lens.copy()
    lens[3] = 0
    got = teval.pack_query_arrays(setup.q_ids, lens, 3, 4)
    want = jeval.pack_query_arrays(setup.q_ids, lens, 3, 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert (got[1][-1] == -1).all()                # an all-pad row


# ---------------------------------------------------------------------------
# packed query encoding and scoring
# ---------------------------------------------------------------------------

def test_encode_queries_packed_matches_jax_and_per_row(setup):
    """Packed encoding (3 segments a row, 4 rows a call: 2 calls, the
    last with all-pad rows) equals the port's per-row ``encode_query`` and the JAX
    package's packed encoding; the all-pad row's pooled vectors are
    finite.  rtol / atol 2e-5: the same fp32 sums, packed and unpacked,
    in other orders (the JAX twin's bound)."""
    s = setup
    packed = teval.encode_queries_packed(
        s.tparams, s.tcfg, s.q_ids, s.lens, max_segs=3, rows_per_call=4,
        dtype=torch.float32).numpy()
    per_row = tpre.encode_query(s.tparams, s.tcfg,
                                torch.from_numpy(s.q_ids),
                                torch.from_numpy(s.q_mask)).detach().numpy()
    jpacked = np.asarray(jeval.encode_queries_packed(
        s.params, s.jcfg, s.q_ids, s.lens, max_segs=3, rows_per_call=4,
        dtype=jnp.float32))
    assert packed.shape == per_row.shape == (len(s.lens), 32)
    np.testing.assert_allclose(packed, per_row, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(packed, jpacked, rtol=2e-5, atol=2e-5)

    p_ids, p_seg, p_pos, _ = teval.pack_query_arrays(s.q_ids, s.lens, 3, 4)
    assert p_ids.shape[0] == 8 and (p_seg[-1] == -1).all()
    with torch.inference_mode():
        rows = tpre.encode_query_packed(
            s.tparams, s.tcfg, *(torch.from_numpy(a)
                                 for a in (p_ids, p_seg, p_pos)), 3)
    assert rows.shape == (p_ids.shape[0], 3, 32)
    assert bool(torch.isfinite(rows).all())


def test_fused_packed_scorer_matches_jax(setup, corpus):
    """The whole query set in one call (packed encoding, gather, ranking)
    against the JAX package's fused program on the same packed arrays:
    integer outputs equal; floats rtol 2e-4, atol 1e-6 (the JAX twin's
    bound: exp(q2c_alpha * s) amplifies the fp32 noise of s)."""
    s = setup
    jembs, jmasks, tembs, tmasks = corpus
    opts = dict(s.opts, max_vcmr_video=4, max_before_nms=12)
    gt = np.random.RandomState(13).randint(0, N_VIDEOS, (len(s.lens),))
    arrs = teval.pack_query_arrays(s.q_ids, s.lens, max_segs=3,
                                   rows_per_call=2)
    run, _ = teval.make_fused_packed_scorer(
        s.tparams, s.tcfg, tpre.VsmConfig(**VSM), teval.VcmrEvalOpts(**opts),
        tembs, tmasks, torch.float32, max_segs=3)
    got = run(*arrs, gt)
    jrun, _ = jeval.make_fused_packed_scorer(
        s.params, s.jcfg, jpre.VsmConfig(**VSM), jeval.VcmrEvalOpts(**opts),
        jembs, jmasks, jnp.float32, max_segs=3)
    want = jrun(*(jnp.asarray(a) for a in arrs),
                jnp.asarray(gt.astype(np.int32)))
    for name, a, b in zip(("st_gt", "ed_gt", "tsc", "tidx", "sc2", "fidx"),
                          got, want):
        a, b = a.numpy(), np.asarray(b)
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6,
                                       err_msg=name)


def test_validate_full_vcmr_pack_queries_matches_jax(setup):
    """``pack_queries`` (3 segments, 2 rows a call) in both packages: the
    same metrics and validation log, the same (video, st, ed) everywhere,
    scores rtol 1e-4; and the port's packed submission holds the same
    predictions as its unpacked one."""
    s = setup
    over = dict(pack_queries=True, query_pack_segs=3,
                query_pack_rows_per_call=2)
    jlog, jsub, jmet = _validate("jax", s, **over)
    tlog, tsub, tmet = _validate("torch", s, **over)
    _assert_same_submission(tsub, jsub, 1e-4, len(s.qd))
    assert tmet == jmet and tlog == jlog
    _, usub, umet = _validate("torch", s)
    _assert_same_submission(tsub, usub, 1e-4, len(s.qd))
    assert tmet == umet


# ---------------------------------------------------------------------------
# the chunked corpus
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chunked(setup):
    """The port's resident and chunked (chunks of 3) results, the JAX
    package's chunked result; nms_thd 0.5."""
    return (_validate("torch", setup), _validate("torch", setup,
                                                 corpus_chunk_videos=3),
            _validate("jax", setup, corpus_chunk_videos=3))


def test_chunked_corpus_equals_resident_bit_for_bit(chunked):
    """The chunked path's per-(query, video) numbers are the resident
    path's (the same products, softmaxes and products of probabilities),
    merged exactly: submission, metrics and log equal, floats included."""
    (rlog, rsub, rmet), (clog, csub, cmet), _ = chunked
    assert csub == rsub
    assert cmet == rmet and clog == rlog


def test_chunked_corpus_matches_jax(setup, chunked):
    """Against the JAX package's chunked path: ids exact, scores rtol 1e-4
    (fp32 sums in other orders through exp(20 s)), metrics equal."""
    _, (clog, csub, cmet), (jlog, jsub, jmet) = chunked
    _assert_same_submission(csub, jsub, 1e-4, len(setup.qd))
    assert cmet == jmet and clog == jlog


@pytest.mark.parametrize("cross", [True, False])
def test_get_pred_from_raw_query_matches_jax(setup, corpus, cross):
    """Cross mode (every query against every video) and paired mode (query
    n against video n); rtol / atol 2e-5."""
    s = setup
    jembs, jmasks, tembs, tmasks = corpus
    n = tembs.shape[0] if cross else len(s.lens)
    sl = slice(0, n)
    got = tvcmr.get_pred_from_raw_query(
        s.tparams, s.tcfg, tpre.VsmConfig(**VSM), tembs[sl], tmasks[sl],
        torch.from_numpy(s.q_ids), torch.from_numpy(s.q_mask), cross=cross)
    want = jax.jit(functools.partial(
        jvcmr.get_pred_from_raw_query, cfg=s.jcfg, vsm=jpre.VsmConfig(**VSM),
        cross=cross, dtype=jnp.float32))(
        s.params, frame_embeddings=jembs[sl], c_attn_masks=jmasks[sl],
        query_input_ids=jnp.asarray(s.q_ids),
        query_attn_masks=jnp.asarray(s.q_mask))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=2e-5, atol=2e-5)
    vr = tvcmr.get_vr_scores_from_raw_query(
        s.tparams, s.tcfg, tembs[sl], tmasks[sl], torch.from_numpy(s.q_ids),
        torch.from_numpy(s.q_mask))
    assert torch.equal(vr, got[0])


# ---------------------------------------------------------------------------
# the program: options, stores, eval inputs, drivers.eval_vcmr.main
# ---------------------------------------------------------------------------

MODEL_CFG = {
    "f_config": {"hidden_size": 32, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "intermediate_size": 64,
                 "max_position_embeddings": 64, "vocab_size": 128,
                 "type_vocab_size": 2},
    "c_config": {"hidden_size": 32, "num_hidden_layers": 1,
                 "num_attention_heads": 4, "intermediate_size": 64,
                 "max_position_embeddings": 64, "type_vocab_size": 2},
    "q_config": {"hidden_size": 32, "num_hidden_layers": 0,
                 "num_attention_heads": 4, "intermediate_size": 64,
                 "max_position_embeddings": 64, "vocab_size": 128,
                 "type_vocab_size": 1},
}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A finetune run's directory as the JAX driver leaves it: stores of
    the synthetic corpus (7 videos, 21 queries), ``log/hps.json`` through
    the JAX options (video batches of 3, query batches of 8: both last
    batches ragged) and ``ckpt/model_step_5.npz`` holding the whole JAX
    tree (the port's numpy init at seed 3)."""
    root = str(tmp_path_factory.mktemp("serve"))
    dbs = ttesting.build_synthetic_corpus(root, n_videos=7, max_frames=16,
                                          vfeat_dim=64)
    mc_path = os.path.join(root, "model.json")
    with open(mc_path, "w") as f:
        json.dump(MODEL_CFG, f)
    out = os.path.join(root, "out")
    exp = {"sub_txt_db": dbs["sub"], "vfeat_db": dbs["vfeat"],
           "val_query_txt_db": dbs["query"], "model_config": mc_path,
           "output_dir": out, "max_clip_len": 16, "max_txt_len": 12,
           "vfeat_interval": INTERVAL, "vfeat_dim": 64, "lw_neg_q": 8.0,
           "lw_neg_ctx": 8.0, "max_vcmr_video": 6, "max_before_nms": 50,
           "max_after_nms": 20, "nms_thd": 0.5, "min_pred_l": 1,
           "max_pred_l": 8, "vcmr_eval_video_batch_size": 3,
           "vcmr_eval_batch_size": 8, "bucket_n_subs": 4,
           "bucket_frames_per_sub": 12, "bucket_query_len": 12,
           "query_pack_segs": 3}
    cfg_path = os.path.join(root, "exp.json")
    with open(cfg_path, "w") as f:
        json.dump(exp, f)
    hps = vars(jopts.get_vcmr_args(["--config", cfg_path]))
    os.makedirs(os.path.join(out, "log"))
    os.makedirs(os.path.join(out, "ckpt"))
    with open(os.path.join(out, "log", "hps.json"), "w") as f:
        json.dump(hps, f)
    opts = tdrv.load_serve_opts(out)
    np.savez(os.path.join(out, "ckpt", "model_step_5.npz"),
             **tpre.init_flat_params(tcommon.model_config_from_opts(opts),
                                     tcommon.vsm_config_from_opts(opts),
                                     seed=3))
    return types.SimpleNamespace(root=root, out=out, dbs=dbs, cfg_path=cfg_path)


def test_vcmr_options_equal_jax(run_dir):
    """``get_vcmr_args`` (and its ``get_vr_args`` alias) read the same
    config JSON into the JAX parser's namespace; ``eval_opts_from`` gives
    the JAX package's options, plus the packing options the config sets
    (``query_pack_segs`` 3), which the JAX package leaves at their
    defaults."""
    argv = ["--config", run_dir.cfg_path, "--nms_thd", "0.7"]
    t, j = topts.get_vcmr_args(argv), jopts.get_vcmr_args(argv)
    assert vars(t) == vars(j)
    assert vars(topts.get_vr_args(argv)) == vars(j)
    got = dataclasses.asdict(tcommon.eval_opts_from(t))
    want = dataclasses.asdict(jcommon.eval_opts_from(j))
    assert got.pop("query_pack_segs") == 3 and want.pop("query_pack_segs") == 4
    assert got == want


def _eval_inputs(pkg, run_dir):
    s, c = (jdrv, jcommon) if pkg == "jax" else (tdrv, tcommon)
    opts = s.load_serve_opts(run_dir.out)
    video_db = c.load_video_sub_dataset(
        opts, c.shapes_from_opts(opts).replace(n_queries=1))
    qcls = JQueryTokStore if pkg == "jax" else QueryTokStore
    query_db = qcls(opts.val_query_txt_db, max_txt_len=opts.max_txt_len)
    build = (jtrain_vcmr if pkg == "jax" else ttrain_vcmr).build_eval_inputs
    vb, qb, vids, v2i, qdata = build(video_db, query_db, opts)
    return list(vb), list(qb), vids, v2i, qdata, query_db, opts


def test_eval_inputs_equal_jax(run_dir):
    """``build_eval_inputs`` over the same stores: every video and query
    batch bit for bit (the padded last batches included), the ids, the
    global index and the query data; and ``VcmrFullEvalDataset.batches``
    with and without ``pad_to_full``."""
    tvb, tqb, tvids, tv2i, tqd, tqdb, opts = _eval_inputs("torch", run_dir)
    jvb, jqb, jvids, jv2i, jqd, jqdb, _ = _eval_inputs("jax", run_dir)
    assert tvids == jvids and tv2i == jv2i and tqd == jqd
    assert len(tvb) == len(jvb) == 3 and len(tqb) == len(jqb) == 3
    for tb, jb in zip(tvb + tqb, jvb + jqb):
        assert list(tb) == list(jb)
        for k in tb:
            if isinstance(jb[k], np.ndarray):
                assert tb[k].dtype == jb[k].dtype, k
                assert np.array_equal(tb[k], jb[k]), k
            else:
                assert tb[k] == jb[k], k
    assert (tvb[-1]["c_attn_masks"][1:] == 0).all()       # 7 = 3 + 3 + 1
    assert len(tqb[-1]["qids"]) == 5 and \
        (tqb[-1]["query_attn_masks"][5:] == 0).all()
    shapes = tcommon.shapes_from_opts(opts)
    for pad in (True, False):
        got = list(VcmrFullEvalDataset(list(tqdb.id2len), tqdb,
                                       shapes).batches(4, pad))
        want = list(JVcmrFullEvalDataset(list(jqdb.id2len), jqdb,
                                         shapes).batches(4, pad))
        assert [b["qids"] for b in got] == [b["qids"] for b in want]
        for g, w in zip(got, want):
            assert np.array_equal(g["query_input_ids"],
                                  w["query_input_ids"])
            assert np.array_equal(g["query_attn_masks"],
                                  w["query_attn_masks"])


def test_eval_vcmr_main_matches_jax(run_dir, monkeypatch):
    """``drivers.eval_vcmr.main`` on the CPU against the JAX driver on the
    same run directory, both fp32 (the JAX driver's ``validate_full_vcmr``
    given fp32; its 8 virtual devices shard the corpus): the same
    metrics, the same (video, st, ed) everywhere, scores rtol 1e-4; each
    writes ``results_5_test_all.json`` holding its submission."""
    monkeypatch.setattr(jdrv, "validate_full_vcmr", functools.partial(
        jeval.validate_full_vcmr, dtype=jnp.float32))
    argv = ["--output_dir", run_dir.out, "--checkpoint", "5", "--split",
            "test"]
    path = os.path.join(run_dir.out, "results_5_test_all.json")
    jmet, jsub = jdrv.main(jdrv.build_argparser().parse_args(argv))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(jsub))
    os.remove(path)
    tmet, tsub = tdrv.main(tdrv.build_argparser().parse_args(argv),
                           device="cpu", dtype=torch.float32)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(tsub))
    _assert_same_submission(tsub, jsub, 1e-4, 21)
    assert tmet == jmet


def test_eval_vcmr_main_refuses_a_pt_checkpoint(run_dir):
    """A reference ``.pt`` checkpoint now loads: ``.pt`` of the run's
    step-5 tree with 120 of its 128 word rows (``reference_state_dict``)
    serves the submission of the equal ``.npz`` (that tree with the rows
    past 120 zeroed), written as ``results_model_test_all.json``; the
    port's load of it equals ``hero_tpu.drivers.common.load_checkpoint_into``
    (the name is the one this test had when a ``.pt`` raised)."""
    step5 = os.path.join(run_dir.out, "ckpt", "model_step_5.npz")
    with np.load(step5) as z:
        tree = {k: z[k] for k in z.files}
    pt = os.path.join(run_dir.root, "model.pt")
    torch.save({"model": ttesting.reference_state_dict(tree, vocab=120)}, pt)
    for k in ("v_encoder/f_encoder/embeddings/word_emb",
              "v_encoder/f_encoder/lm_head/bias"):
        tree[k] = tree[k].copy()
        tree[k][120:] = 0.0
    np.savez(os.path.join(run_dir.out, "ckpt", "model_step_6.npz"), **tree)
    got = {}
    for ckpt in (pt, "6"):
        args = tdrv.build_argparser().parse_args(
            ["--output_dir", run_dir.out, "--checkpoint", ckpt, "--split",
             "test"])
        got[ckpt] = tdrv.main(args, device="cpu", dtype=torch.float32)
    assert got[pt] == got["6"]
    with open(os.path.join(run_dir.out, "results_model_test_all.json")) as f:
        assert json.load(f) == json.loads(json.dumps(got[pt][1]))
    opts = tdrv.load_serve_opts(run_dir.out)
    cfg = tcommon.model_config_from_opts(opts)
    init = tpre.init_flat_params(cfg, tcommon.vsm_config_from_opts(opts))
    info, jinfo = {}, {}
    flat = tcommon.load_checkpoint_into(init, pt, 128, info=info)
    want = jcommon.load_checkpoint_into(unflatten_tree(init), pt, 128,
                                        info=jinfo)
    assert info == jinfo == {"vocab_padded": True}
    assert sorted(flat) == sorted(tree)
    for k, v in jax.tree_util.tree_flatten_with_path(want)[0]:
        key = "/".join(p.key for p in k)
        np.testing.assert_array_equal(flat[key], np.asarray(v), err_msg=key)
        np.testing.assert_array_equal(flat[key], tree[key], err_msg=key)


# ---------------------------------------------------------------------------
# the --pp_stages guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["main", "run_pretrain"])
def test_pp_stages_raises_and_names_a8(tmp_path, entry):
    """``--pp_stages 2`` in a world of 1 (the name is the test's from when
    the flag raised naming ROADMAP A8): one rank cannot hold 2 pipeline
    stages, so both pretraining entry points raise before any work (no
    output directory is made), as the JAX ``driver_mesh`` asserts; the
    refusal no longer cites A8.  ``--zero1`` alone builds the plain grid
    of one rank."""
    out = str(tmp_path / "run")
    opts = topts.get_pretrain_args(["--pp_stages", "2", "--pp_microbatches",
                                    "4", "--output_dir", out])
    fn = getattr(tpretrain_drv, entry)
    with pytest.raises(ValueError, match="cannot hold 2 stages") as err:
        fn(opts, device="cpu") if entry == "main" else fn(opts, {},
                                                          device="cpu")
    assert "A8" not in str(err.value)
    assert not os.path.exists(out)
    grid = tpipeline.driver_grid(topts.get_pretrain_args(["--zero1"]), 8)
    assert (grid.axis, grid.data_world, grid.inner_world) == ("data", 1, 1)
