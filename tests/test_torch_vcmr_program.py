"""hero_tpu_torch's VCMR and VR finetuning as programs against the JAX
package, from a reference-layout ``.pt`` checkpoint: the checkpoint
converter and the RoBERTa init (``convert/torch_checkpoint``,
``convert/roberta_init``) on every key family, the test fixture
``reference_state_dict`` as the converter's inverse, the VCMR/VR datasets
and ``build_batch``, the video-only dataset, ``forward_vcmr`` /
``forward_vr``, ``drivers.train_vcmr.main`` and ``drivers.train_vr.main``
against the JAX programs on one config (TVR with subtitles and
accumulation, DiDeMo video-only, ``--pack_subs``, MSR-VTT with subtitles
and video-only), ``drivers.eval_vr.main`` and the packed run's
``eval_vcmr`` against the JAX drivers, and ``main`` stopped by SIGTERM in
a subprocess and resumed.

One tiny model (``tests/test_driver_vcmr.py``'s, every dropout rate 0:
the two frameworks' random streams differ) on one 6-video synthetic
corpus; every run starts from one ``.pt`` that holds the whole
pretraining tree with 120 word rows (padded to the config's 128).
Everything is fp32 on the CPU, the port on one torch thread.  The JAX
programs run as they are, except that their fp32 is asked for
(``forward_vsm`` in the train step, ``validate_full_vcmr``) and their
eager init is replaced by the tree the ``.pt`` was written from (which
the ``.pt`` overlays key by key anyway); TensorBoard is kept out of both
programs.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config import opts as jopts
from hero_tpu.config.model_config import tiny_hero_config as jax_tiny_config
from hero_tpu.convert import roberta_init as jroberta
from hero_tpu.convert import torch_checkpoint as jtc
from hero_tpu.data import downstream_tasks as jdt
from hero_tpu.data.store import QueryTokStore as JQueryTokStore
from hero_tpu.drivers import common as jcommon
from hero_tpu.drivers import eval_vcmr as jeval_vcmr
from hero_tpu.drivers import eval_vr as jeval_vr
from hero_tpu.drivers import train_vcmr as jtrain
from hero_tpu.drivers import train_vr as jtrain_vr
from hero_tpu.evaluation import vcmr_eval as jeval
from hero_tpu.models import pretrain as jpre
from hero_tpu.models import tvc as jtvc
from hero_tpu.models import vcmr as jvcmr
from hero_tpu.training import save as jsave
from hero_tpu_torch.config import opts as topts
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert import roberta_init as troberta
from hero_tpu_torch.convert import torch_checkpoint as ttc
from hero_tpu_torch.convert.from_jax import load_jax_params
from hero_tpu_torch.data import downstream_tasks as tdt
from hero_tpu_torch.data import testing as ttesting
from hero_tpu_torch.data.store import QueryTokStore
from hero_tpu_torch.drivers import common as tcommon
from hero_tpu_torch.drivers import eval_vcmr as teval_vcmr
from hero_tpu_torch.drivers import eval_vr as teval_vr
from hero_tpu_torch.drivers import train_vcmr as ttrain
from hero_tpu_torch.drivers import train_vr as ttrain_vr
from hero_tpu_torch.models import pretrain as tpre
from hero_tpu_torch.models import tvc as ttvc
from hero_tpu_torch.models import vcmr as tvcmr
from tests.test_roberta_init import fake_roberta_sd

REPO = pathlib.Path(__file__).resolve().parents[1]
MAX_FRAMES = 16
VOCAB, PT_ROWS = 128, 120
LAYER = {"hidden_size": 32, "num_attention_heads": 4,
         "intermediate_size": 64, "max_position_embeddings": 64,
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
MODEL_CFG = {   # tests/test_driver_vcmr.py's model, dropout 0
    "f_config": dict(LAYER, num_hidden_layers=2, vocab_size=VOCAB,
                     type_vocab_size=2),
    "c_config": dict(LAYER, num_hidden_layers=1, type_vocab_size=2),
    "q_config": dict(LAYER, num_hidden_layers=0, vocab_size=VOCAB,
                     type_vocab_size=1),
}
VSM = dict(lw_neg_ctx=8.0, lw_neg_q=8.0, lw_st_ed=0.02)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """Both programs' scalar writers keep to JSONL."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


def _assert_trees_equal(got, want, path=""):
    """Nested dicts of arrays, lists and bools: the same keys, and arrays
    of one dtype and shape with equal elements."""
    assert isinstance(got, dict) and isinstance(want, dict), path
    assert sorted(got) == sorted(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            _assert_trees_equal(g, w, f"{path}/{k}")
        elif isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, \
                f"{path}/{k}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")
        else:
            assert g == w, f"{path}/{k}"


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# the pooler kernels: no loss reads them, and AdamW decays them
POOLER_KERNELS = tuple(f"v_encoder/{e}/pooler/dense/kernel"
                       for e in ("f_encoder", "c_encoder"))


def _assert_restore_files_close(tdir, jdir):
    """The port's ``restore.npz`` against the JAX run's: the same keys,
    the step equal, every parameter and AdamW moment within the
    parameters' atol 1e-5."""
    got = _npz(os.path.join(tdir, "restore.npz"))
    want = _npz(os.path.join(jdir, "restore.npz"))
    assert sorted(got) == sorted(want)
    assert int(got.pop("__step__")) == int(want.pop("__step__"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the converter, on every key family
# ---------------------------------------------------------------------------

def _qa_violin_heads(seed, D=32):
    """The VideoQA and VIOLIN heads' JAX-layout leaves (random)."""
    r = np.random.RandomState(seed)
    out = {}

    def mlp(key, d_out):
        out[f"{key}/linear_1/kernel"] = r.randn(D, 2 * D)
        out[f"{key}/linear_1/bias"] = r.randn(2 * D)
        out[f"{key}/ln/scale"] = r.randn(2 * D)
        out[f"{key}/ln/bias"] = r.randn(2 * D)
        out[f"{key}/linear_2/kernel"] = r.randn(2 * D, d_out)
        out[f"{key}/linear_2/bias"] = r.randn(d_out)

    for pool, head, d_out in (("qa_pool", "qa_pred_head", 1),
                              ("st_ed_pool", "st_ed_pred_head", 2),
                              ("violin_pool", "violin_pred_head", 1)):
        out[f"head/{pool}/kernel"] = r.randn(D, 1)
        mlp(f"head/{head}", d_out)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _family_tree(family, tcfg):
    """A flat JAX-layout tree holding the backbone and one family of task
    keys (or all of them)."""
    vsm = tpre.VsmConfig(**VSM)
    pre = tpre.init_flat_params(tcfg, vsm, seed=1)
    backbone = {k: v for k, v in pre.items()
                if k.startswith("v_encoder/") and not any(
                    s in k for s in ("feat_regress", "mask_embedding",
                                     "fom_output", "lm_head"))}
    heads = {k: v for k, v in pre.items() if k not in backbone}
    pre_heads = {k: v for k, v in heads.items() if k.startswith("v_enc")}
    vcmr_head = {k: v for k, v in heads.items() if k.startswith("head/")}
    tvc = {k: v for k, v in ttvc.init_flat_tvc_params(tcfg, seed=2).items()
           if not k.startswith("v_encoder/")}
    qa = _qa_violin_heads(3)
    return dict(backbone, **{
        "backbone_pretrain_heads": pre_heads, "vcmr_head": vcmr_head,
        "videoqa_violin_heads": qa, "tvc_decoder": tvc,
        "all": dict(pre_heads, **vcmr_head, **qa, **tvc)}[family])


def _prefixed(sd):
    """The reference's older spellings: LayerNorm ``.gamma``/``.beta``,
    the ``module.`` prefix of a DataParallel save, the buffers the
    reference registers, and a key no family holds."""
    out = {}
    for k, v in sd.items():
        if "LayerNorm" in k or k.endswith("_LayerNorm.weight"):
            k = k.replace(".weight", ".gamma").replace(".bias", ".beta")
        out["module." + k] = v
    out["module.pad"] = torch.zeros(1)
    out["module.v_encoder.f_encoder.embeddings.pad"] = torch.zeros(1)
    out["module.decoder.tri_mask"] = torch.ones(4, 4)
    out["module.label_smoothing.one_hot"] = torch.ones(VOCAB)
    out["module.some_head.weight"] = torch.ones(2, 2)
    return out


CONVERTER_CASES = ["backbone_pretrain_heads", "vcmr_head",
                   "videoqa_violin_heads", "tvc_decoder", "all",
                   "prefixes_buffers_unknown", "vocab_padded",
                   "vocab_not_padded"]


@pytest.mark.parametrize("case", CONVERTER_CASES)
def test_convert_state_dict_equals_jax(case):
    """Twin of ``test_converter_covers_released_key_families`` on
    reference-layout dicts this test writes: ``convert_state_dict`` gives
    exactly what ``hero_tpu``'s gives, for each key family on its own
    (with the backbone) and all together, for the older key spellings
    with buffers and an unknown key (reported in ``__unexpected__``), and
    with 120 word rows (padded to 128) or 128 (not padded)."""
    family = case if case in CONVERTER_CASES[:5] else "all"
    tree = _family_tree(family, tiny_hero_config())
    rows = VOCAB if case == "vocab_not_padded" else PT_ROWS
    sd = ttesting.reference_state_dict(tree, vocab=rows)
    if case == "prefixes_buffers_unknown":
        sd = _prefixed(sd)
    got = ttc.convert_state_dict(sd, vocab_size=VOCAB)
    want = jtc.convert_state_dict(sd, vocab_size=VOCAB)
    _assert_trees_equal(got, want)
    assert got["__vocab_padded__"] is (rows < VOCAB)
    if case == "prefixes_buffers_unknown":
        assert got["__unexpected__"] == ["some_head.weight"]
    else:
        assert "__unexpected__" not in got
        # the fixture is the converter's inverse: every leaf comes back,
        # the cut word rows as zeros
        flat = jsave.flatten_tree({k: v for k, v in got.items()
                                   if not k.startswith("__")})
        assert sorted(flat) == sorted(tree)
        for k, v in tree.items():
            if flat[k].shape[0] == VOCAB and k.endswith(("word_emb",
                                                         "lm_head/bias")):
                np.testing.assert_array_equal(flat[k][:rows], v[:rows])
                assert not flat[k][rows:].any()
            else:
                np.testing.assert_array_equal(flat[k], v, err_msg=k)


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_and_convert_equals_jax(tmp_path, wrapped):
    """``load_and_convert`` of a ``.pt`` saved as the state dict itself or
    as ``{"model": sd}``: the same tree as ``hero_tpu``'s;
    ``infer_max_frm_seq_len`` reads the frame rows from either."""
    tree = _family_tree("all", tiny_hero_config())
    sd = ttesting.reference_state_dict(tree, vocab=PT_ROWS)
    path = str(tmp_path / "hero.pt")
    torch.save({"model": sd} if wrapped else sd, path)
    got = ttc.load_and_convert(path, vocab_size=VOCAB)
    _assert_trees_equal(got, jtc.load_and_convert(path, vocab_size=VOCAB))
    _assert_trees_equal(got, ttc.convert_state_dict(sd, VOCAB))
    assert ttc.infer_max_frm_seq_len(sd) == jtc.infer_max_frm_seq_len(
        sd) == MAX_FRAMES
    assert ttc.infer_max_frm_seq_len({}) is None


@pytest.mark.parametrize("n_types", [1, 2])
def test_roberta_init_equals_jax(n_types):
    """Twin of ``tests/test_roberta_init.py``: ``subsample_layers`` (the
    12 -> 6 and 12 -> 2 strides), ``roberta_to_f_encoder`` (the type
    embedding's row 0 copied to row 1, from one row or two) and
    ``init_f_encoder_from_roberta`` over the tiny init give exactly what
    ``hero_tpu``'s give."""
    sd = fake_roberta_sd(hidden=32, vocab=120, n_types=n_types)
    for n in (6, 2):
        got, want = (m.subsample_layers(sd, n) for m in (troberta,
                                                         jroberta))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert troberta.subsample_layers(sd, 6, skip_layers=False) == sd
    got = troberta.roberta_to_f_encoder(sd, n_layers=2, vocab_size=VOCAB)
    _assert_trees_equal(got, jroberta.roberta_to_f_encoder(
        sd, n_layers=2, vocab_size=VOCAB))
    np.testing.assert_array_equal(got["embeddings"]["type_emb"][1],
                                  got["embeddings"]["type_emb"][0])
    init = jsave.unflatten_tree(tpre.init_flat_params(tiny_hero_config(),
                                                      seed=4))
    got = troberta.init_f_encoder_from_roberta(init, sd, n_layers=2,
                                               vocab_size=VOCAB)
    want = jroberta.init_f_encoder_from_roberta(
        jax.tree.map(jnp.asarray, init), sd, n_layers=2, vocab_size=VOCAB)
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("tree", ["pretrain", "tvc"])
def test_reference_state_dict_inverts_the_converter(tree):
    """``convert_state_dict(reference_state_dict(t)) == t`` for the tiny
    pretraining and TVC inits (the port's numpy inits, whose keys and
    shapes are the JAX inits'), every key a reference-layout key."""
    tcfg, jcfg = tiny_hero_config(), jax_tiny_config()
    if tree == "pretrain":
        flat = tpre.init_flat_params(tcfg, tpre.VsmConfig(**VSM), seed=5)
        shapes = jax.eval_shape(lambda k: jpre.init_hero_for_pretraining(
            k, jcfg, jpre.VsmConfig(**VSM)), jax.random.PRNGKey(0))
    else:
        flat = ttvc.init_flat_tvc_params(tcfg, seed=5)
        shapes = jax.eval_shape(lambda k: jtvc.init_hero_for_tvc(k, jcfg),
                                jax.random.PRNGKey(0))
    got = {"/".join(k.key for k in path): leaf.shape for path, leaf in
           jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert got == {k: v.shape for k, v in flat.items()}
    sd = ttesting.reference_state_dict(flat)
    assert all("/" not in k and isinstance(v, torch.Tensor)
               for k, v in sd.items())
    back = ttc.convert_state_dict(sd, vocab_size=VOCAB)
    assert back.pop("__vocab_padded__") is False
    _assert_trees_equal(back, jsave.unflatten_tree(flat))
    if tree == "pretrain":
        assert tuple(sd["video_st_predictor.weight"].shape) == (1, 1, 5)
    else:
        assert "decoder.layer.0.intermidiate.dense.weight" in sd



# ---------------------------------------------------------------------------
# the corpus, the .pt and the run configs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The 6-video corpus, MODEL_CFG in both packages, the pretraining tree
    of the port's init at seed 9 written as a reference ``.pt`` with 120
    word rows (``{"model": sd}``), and ``cfg(name, **over)``, which writes
    a run config (``tests/test_driver_vcmr.py``'s options: 4 steps of 4
    queries, the hard negatives from step 2, validation at step 4, saves
    every 2) and returns its path."""
    root = str(tmp_path_factory.mktemp("vcmr_program"))
    corpus = ttesting.build_synthetic_corpus(root, n_videos=6,
                                             max_frames=MAX_FRAMES,
                                             vfeat_dim=64)
    mc = os.path.join(root, "model.json")
    with open(mc, "w") as f:
        json.dump(MODEL_CFG, f)
    ns = types.SimpleNamespace(model_config=mc, max_clip_len=MAX_FRAMES,
                               vfeat_dim=64)
    tcfg = tcommon.model_config_from_opts(ns)
    flat = tpre.init_flat_params(tcfg, tpre.VsmConfig(**VSM), seed=9)
    pt = os.path.join(root, "hero-tv.pt")
    torch.save({"model": ttesting.reference_state_dict(flat, PT_ROWS)}, pt)
    base = dict(
        task="tvr", sub_txt_db=corpus["sub"], vfeat_db=corpus["vfeat"],
        train_query_txt_db=corpus["query"], val_query_txt_db=corpus["query"],
        model_config=mc, checkpoint=pt, max_clip_len=MAX_FRAMES,
        max_txt_len=12, vfeat_interval=1.5, vfeat_dim=64,
        train_batch_size=4, gradient_accumulation_steps=1,
        learning_rate=1e-3, valid_steps=4, save_steps=2, num_train_steps=4,
        warmup_steps=1, grad_norm=1.0, hard_pool_size=[4],
        hard_neg_weights=[10], hard_negtiave_start_step=[2],
        train_span_start_step=0, sub_ctx_len=0, seed=7, max_vcmr_video=6,
        max_before_nms=50, max_after_nms=20, nms_thd=0.5, min_pred_l=1,
        max_pred_l=8, vcmr_eval_video_batch_size=4, vcmr_eval_batch_size=10,
        bucket_n_subs=4, bucket_frames_per_sub=12, bucket_query_len=16,
        **VSM)

    def cfg(name, **over):
        d = dict(base, output_dir=os.path.join(root, name), **over)
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(d, f)
        return path

    return types.SimpleNamespace(
        root=root, corpus=corpus, cfg=cfg, pt=pt, flat=flat, tcfg=tcfg,
        jcfg=jcommon.model_config_from_opts(ns),
        template=tcommon.load_checkpoint_into(flat, pt, VOCAB),
        jinit=jax.tree.map(jnp.asarray, jsave.unflatten_tree(flat)))


def _jax_fp32(fn):
    """``fn`` with ``dtype`` forced to fp32 (the JAX program's bf16 sites)."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        return fn(*a, **dict(k, dtype=jnp.float32))
    return wrapped


def _jax_patches(mp, env):
    """The JAX programs in fp32 (the train step's ``forward_vsm`` and both
    programs' ``validate_full_vcmr``), their eager init replaced by the
    tree the ``.pt`` was written from."""
    mp.setattr(jpre, "forward_vsm", _jax_fp32(jpre.forward_vsm))
    val = functools.partial(jeval.validate_full_vcmr, dtype=jnp.float32)
    mp.setattr(jtrain, "validate_full_vcmr", val)
    mp.setattr(jeval_vcmr, "validate_full_vcmr", val)
    mp.setattr(jpre, "init_hero_for_pretraining",
               lambda rng, cfg, vsm=None: env.jinit)


# ---------------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------------

def _video_dbs(env, **over):
    """The sub dataset of the run config in both packages."""
    opts = jopts.get_vcmr_args(["--config", env.cfg("data", **over)])
    out = []
    for c in (tcommon, jcommon):
        out.append(c.load_video_sub_dataset(
            opts, c.shapes_from_opts(opts).replace(n_queries=1)))
    return opts, out


def _assert_items_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("sampled_by_q", [True, False])
def test_vcmr_and_vr_datasets_equal_jax(env, sampled_by_q):
    """``VcmrDataset`` (span targets) and ``VrDataset`` (none) sampled by
    query, or by video with 4 queries each (repeat-filled by the seeded
    draw), and ``build_batch`` of them with and without
    ``flatten_rows``: bit for bit the JAX package's."""
    opts, (tvideo, jvideo) = _video_dbs(env)
    stores = (QueryTokStore(opts.train_query_txt_db, opts.max_txt_len),
              JQueryTokStore(opts.train_query_txt_db, opts.max_txt_len))
    vids = sorted(tvideo.txt_db.id2len)
    for tcls, jcls in ((tdt.VcmrDataset, jdt.VcmrDataset),
                       (tdt.VrDataset, jdt.VrDataset)):
        kw = dict(sampled_by_q=sampled_by_q, seed=3, max_num_query=4)
        t = tcls(vids, tvideo, stores[0], **kw)
        j = jcls(vids, jvideo, stores[1], **kw)
        assert len(t) == len(j) == (18 if sampled_by_q else 6)
        assert t.vid2idx == j.vid2idx and t.qids == j.qids
        for i in range(len(j)):
            _assert_items_equal(t[i], j[i])
        targets = np.stack([t[i]["targets"] for i in range(len(t))])
        assert (targets >= 0).any() if tcls is tdt.VcmrDataset \
            else (targets == -1).all()
        for flatten in (False, True):
            _assert_items_equal(tdt.build_batch(t, [0, 2, 3], flatten),
                                jdt.build_batch(j, [0, 2, 3], flatten))


@pytest.mark.parametrize("meta", ["query_store", "none"])
def test_video_only_dataset_equals_jax(env, meta):
    """``load_video_only_dataset``: one [CLS] row over max(12, 16) frame
    slots, the special ids from the query store's ``meta.json`` (or
    RoBERTa's without a query store), every video's item bit for bit the
    JAX package's; ``is_video_only_task``; the VCMR items over it."""
    over = dict(sub_txt_db=None, task="didemo_video_only")
    if meta == "none":
        over.update(train_query_txt_db=None, val_query_txt_db=None)
    opts = jopts.get_vcmr_args(["--config", env.cfg("data", **over)])
    got, want = (c.load_video_only_dataset(
        opts, c.shapes_from_opts(opts).replace(n_queries=1))
        for c in (tcommon, jcommon))
    assert got.shapes == tcommon.FixedShapes(**vars(want.shapes))
    assert (got.shapes.n_subs, got.shapes.frames_per_sub) == (1, 16)
    ids = ("cls_", "sep", "pad", "mask")
    assert [getattr(got.txt_db, k) for k in ids] == \
        [getattr(want.txt_db, k) for k in ids] == \
        ([0, 2, 1, 50] if meta == "query_store" else [0, 2, 1, 50264])
    assert got.vids == want.vids and got.vid2idx == want.vid2idx
    for vid in want.vids:
        _assert_items_equal(got.video_item(vid), want.video_item(vid))
        assert got.nframes(vid) == want.nframes(vid)
    for task in ("didemo_video_only", "msrvtt_video_only", "tvr",
                 "msrvtt_video_sub"):
        assert tcommon.is_video_only_task(task) == \
            jcommon.is_video_only_task(task)
    if meta == "query_store":
        t = tdt.VcmrDataset(got.vids, got, QueryTokStore(
            opts.train_query_txt_db, opts.max_txt_len))
        j = jdt.VcmrDataset(want.vids, want, JQueryTokStore(
            opts.train_query_txt_db, opts.max_txt_len))
        for i in range(len(j)):
            _assert_items_equal(t[i], j[i])


# ---------------------------------------------------------------------------
# the finetune forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head,compute_loss", [
    ("vcmr", True), ("vcmr", False), ("vr", True), ("vr", False)])
def test_forward_vcmr_and_vr_equal_jax(env, head, compute_loss):
    """``forward_vcmr`` (with the curriculum's hard negatives and span
    weight) and ``forward_vr`` on 3 videos x 2 queries from
    ``VcmrDataset``: the losses, or the (6, 3) scores and (for VCMR) the
    (6, 16) span logits, within atol 1e-5 of the JAX functions' (fp32)."""
    opts, (tvideo, jvideo) = _video_dbs(env)
    qdb = QueryTokStore(opts.train_query_txt_db, opts.max_txt_len)
    ds = tdt.VcmrDataset(sorted(tvideo.txt_db.id2len), tvideo, qdb,
                         sampled_by_q=False, max_num_query=2, seed=1)
    batch = {k: v for k, v in tdt.build_batch(ds, [0, 1, 2]).items()
             if not k.startswith("__")}
    if head == "vcmr":
        vsm = tpre.VsmConfig(**VSM)
        tfn, jfn = tvcmr.forward_vcmr, jvcmr.forward_vcmr
    else:
        vsm = tpre.VsmConfig(lw_neg_ctx=1.0, lw_neg_q=1.0, lw_st_ed=0.0)
        tfn, jfn = tvcmr.forward_vr, jvcmr.forward_vr
    jvsm = jpre.VsmConfig(**{f: getattr(vsm, f) for f in (
        "lw_neg_ctx", "lw_neg_q", "lw_st_ed")})
    kw = {}
    if compute_loss and head == "vcmr":
        kw = dict(use_hard_negative=True, hard_pool_size=2,
                  hard_neg_weight=10.0, lw_st_ed=0.02)
    params = load_jax_params(env.template, device="cpu")
    got = tfn(params, env.tcfg, vsm,
              {k: torch.from_numpy(v) for k, v in batch.items()},
              compute_loss=compute_loss, **kw)
    want = jax.jit(lambda p, b: jfn(p, env.jcfg, jvsm, b,
                                    compute_loss=compute_loss, **kw))(
        jax.tree.map(jnp.asarray, jsave.unflatten_tree(env.template)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == {("vcmr", True): 3, ("vcmr", False): 3,
                                     ("vr", True): 2,
                                     ("vr", False): 1}[head, compute_loss]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-5)
    if not compute_loss:
        assert tuple(got[0].shape) == (6, 3)
        if head == "vcmr":
            assert tuple(got[1].shape) == (6, MAX_FRAMES)
    else:
        assert all(float(g) > 0 for g in got[1:])


# ---------------------------------------------------------------------------
# train_vcmr.main / train_vr.main against the JAX programs
# ---------------------------------------------------------------------------

# run name -> (program, config overrides, extra flags)
PROGRAMS = {
    # TVR with subtitles, two micro-batches a step
    "tvr": ("vcmr", dict(gradient_accumulation_steps=2), []),
    "didemo_video_only": ("vcmr", dict(task="didemo_video_only",
                                       sub_txt_db=None), []),
    # tests/test_driver_vcmr.py::test_train_and_eval_vcmr_pack_subs
    "pack_subs": ("vcmr", dict(bucket_n_subs=2, bucket_txt_len=24,
                               bucket_frames_per_sub=16),
                  ["--pack_subs", "--pack_queries"]),
    # tests/test_drivers_all.py::test_vr_driver (no validation)
    "msrvtt_video_sub": ("vr", dict(task="msrvtt_video_sub", lw_st_ed=0,
                                    lw_neg_q=1.0, lw_neg_ctx=1.0,
                                    val_query_txt_db=None), []),
    # ::test_vr_video_only_driver, validating VR as its config does
    "msrvtt_video_only": ("vr", dict(task="msrvtt_video_only",
                                     sub_txt_db=None, lw_st_ed=0,
                                     lw_neg_q=1.0, lw_neg_ctx=1.0,
                                     full_eval_tasks=["VR"]), []),
}


@pytest.fixture(scope="module")
def programs(env):
    """``programs(name)``: the JAX program's and the port's run of
    PROGRAMS[name] on one config each, run once: (jax dir, port dir,
    port options, port final state)."""
    done = {}

    def run(name):
        if name not in done:
            kind, over, flags = PROGRAMS[name]
            jdrv, tdrv, args = (
                (jtrain, ttrain, jopts.get_vcmr_args) if kind == "vcmr"
                else (jtrain_vr, ttrain_vr, jopts.get_vr_args))
            jpath = env.cfg(f"jax_{name}", **over)
            with pytest.MonkeyPatch.context() as mp:
                _jax_patches(mp, env)
                jdrv.main(args(["--config", jpath] + flags))
            topt = topts.get_vcmr_args(
                ["--config", env.cfg(f"torch_{name}", **over)] + flags)
            state = tdrv.main(topt, device="cpu", dtype=torch.float32)
            done[name] = (os.path.join(env.root, f"jax_{name}"),
                          topt.output_dir, topt, state)
        return done[name]
    return run


def _assert_same_submission(a, b, tasks, rtol=1e-4):
    """Every task's entries: the same query ids in order, (video, st, ed)
    exactly, scores within ``rtol``."""
    assert set(a) == set(b) == {"video2idx", *tasks}
    assert a["video2idx"] == b["video2idx"]
    for task in tasks:
        assert len(a[task]) == len(b[task]) > 0
        for ea, eb in zip(a[task], b[task]):
            assert ea["desc_id"] == eb["desc_id"]
            pa, pb = np.asarray(ea["predictions"]), \
                np.asarray(eb["predictions"])
            assert pa.shape == pb.shape and len(pa)
            np.testing.assert_array_equal(pa[:, :3], pb[:, :3], err_msg=task)
            np.testing.assert_allclose(pa[:, 3], pb[:, 3], rtol=rtol,
                                       atol=1e-12, err_msg=task)


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_train_program_matches_jax(env, programs, name):
    """Twins of ``test_train_vcmr_driver_end_to_end``,
    ``test_train_and_eval_vcmr_pack_subs`` (its training half),
    ``test_vr_driver`` and ``test_vr_video_only_driver``, against the JAX
    programs on the same config from the same ``.pt``: every key of
    ``model_step_4.npz``, and every parameter and moment of
    ``restore.npz``, within atol 1e-5 of the JAX run's, the poolers
    included (no loss reads them; both AdamWs decay their kernels); both
    files marked ``__vocab_padded__``; the step-4 submission's
    ids and (video, st, ed) equal and its scores within rtol 1e-4 (VR
    only for the video-only VR run, none without a validation store);
    ``log/`` with the checkpoint records of steps 2 and 4."""
    jdir, tdir, topt, state = programs(name)
    assert state.global_step == 4
    got = _npz(os.path.join(tdir, "ckpt", "model_step_4.npz"))
    want = _npz(os.path.join(jdir, "ckpt", "model_step_4.npz"))
    assert sorted(got) == sorted(want) == sorted(
        [*env.template, "__vocab_padded__"])
    assert bool(got.pop("__vocab_padded__")) is True
    assert bool(want.pop("__vocab_padded__")) is True
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
        moved += not np.array_equal(want[k], env.template[k])
    assert moved > len(want) // 2
    for k in POOLER_KERNELS:
        assert not np.array_equal(got[k], env.template[k]), k
    _assert_restore_files_close(tdir, jdir)
    results = os.path.join(tdir, "results_4_all.json")
    if topt.val_query_txt_db is None:
        assert not os.path.exists(results)
    else:
        tasks = topt.full_eval_tasks
        _assert_same_submission(_json(results), _json(os.path.join(
            jdir, "results_4_all.json")), tasks)
    rec = _json(os.path.join(tdir, "log", "checkpoints.json"))
    assert [r["step"] for r in rec["model"]] == [4]
    assert [r["step"] for r in rec["restore"]] == [2, 4]
    assert _json(os.path.join(tdir, "log", "hps.json")) == vars(topt)
    if name == "pack_subs":
        assert topt.pack_subs and topt.pack_queries


@pytest.mark.parametrize("name,program", [("pack_subs", "eval_vcmr"),
                                          ("msrvtt_video_sub", "eval_vr")])
def test_eval_program_matches_jax(env, programs, name, program):
    """Twins of ``test_train_and_eval_vcmr_pack_subs`` (its serving half)
    and ``test_eval_vr_standalone``: on the port's run directory at step
    4, ``eval_vcmr`` (packed sub rows and queries, from ``hps.json``) and
    ``eval_vr`` (the MSR-VTT query keys, VR only: no ``VCMR`` in the
    submission) equal the JAX drivers: the same metrics, ids and (video,
    st, ed), scores within rtol 1e-4, each writing its submission."""
    _, tdir, _, _ = programs(name)
    tdrv, jdrv = ((teval_vcmr, jeval_vcmr) if program == "eval_vcmr"
                  else (teval_vr, jeval_vr))
    argv = ["--output_dir", tdir, "--checkpoint", "4", "--query_txt_db",
            env.corpus["query"], "--split", "test"]
    path = os.path.join(tdir, "results_4_test_all.json")
    with pytest.MonkeyPatch.context() as mp:
        _jax_patches(mp, env)
        jmet, jsub = jdrv.main(jeval_vcmr.build_argparser().parse_args(argv))
    os.remove(path)
    tmet, tsub = tdrv.main(teval_vcmr.build_argparser().parse_args(argv),
                           device="cpu", dtype=torch.float32)
    assert _json(path) == json.loads(json.dumps(tsub))
    tasks = ["VCMR", "SVMR", "VR"] if program == "eval_vcmr" else ["VR"]
    _assert_same_submission(tsub, jsub, tasks)
    assert tmet == jmet and set(tmet) >= set(tasks)


def test_eval_vr_serves_a_video_only_run(env, programs):
    """``eval_vr`` on the MSR-VTT video-only run (no sub store: the video
    dataset by task, as training took it) serves the run's step-4
    validation, the same submission (the JAX ``eval_vcmr`` opens a sub
    store for every run, so it has no such path to compare with)."""
    _, tdir, _, _ = programs("msrvtt_video_only")
    args = teval_vcmr.build_argparser().parse_args(
        ["--output_dir", tdir, "--checkpoint", "4"])
    metrics, sub = teval_vr.main(args, device="cpu", dtype=torch.float32)
    assert json.loads(json.dumps(sub)) == _json(
        os.path.join(tdir, "results_4_all.json"))
    assert set(sub) == {"video2idx", "VR"} and set(metrics) >= {"VR"}


# run in a fresh interpreter: main on the CPU with SIGTERM sent after step
# 2 (signal handlers need the main thread, which a test worker may not be)
_INTERRUPTED = """
import os, signal, sys, threading
sys.modules["torch.utils.tensorboard"] = None
import torch
torch.set_num_threads(1)
from hero_tpu_torch.config import opts
from hero_tpu_torch.drivers import train_vcmr

def on_step(step, task, metrics):
    if step == 2:
        os.kill(os.getpid(), signal.SIGTERM)

state = train_vcmr.main(opts.get_vcmr_args(["--config", sys.argv[1]]),
                        device="cpu", on_step=on_step, dtype=torch.float32)
assert state.global_step == 2, state.global_step
assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
assert threading.active_count() == 1, threading.enumerate()
"""


def test_main_resumed_after_sigterm_equals_the_uninterrupted_run(env,
                                                                 programs):
    """Twin of ``test_restore_resumes``: the TVR run (two micro-batches a
    step) stopped by SIGTERM after step 2 leaves ``restore.npz`` and the
    model at step 2; resumed from the ``.pt`` config, it skips the four
    batches taken and ends with the uninterrupted run's
    ``model_step_4.npz``, ``restore.npz`` and step-4 submission, bit for
    bit."""
    _, adir, aopt, astate = programs("tvr")
    path = env.cfg("resumed", **PROGRAMS["tvr"][1])
    out = os.path.join(env.root, "resumed")
    penv = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _INTERRUPTED, path],
                          cwd=env.root, env=penv, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(os.path.join(out, "restore.npz")) as z:
        assert int(z["__step__"]) == 2
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "model_step_2.npz"]
    state = ttrain.main(topts.get_vcmr_args(["--config", path]),
                        device="cpu", dtype=torch.float32)
    assert state.global_step == 4
    for name in ("ckpt/model_step_4.npz", "restore.npz"):
        got, want = (_npz(os.path.join(d, name)) for d in (out, adir))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert _json(os.path.join(out, "results_4_all.json")) == _json(
        os.path.join(adir, "results_4_all.json"))
    rec = _json(os.path.join(out, "log", "checkpoints.json"))
    assert rec["restore_ms"] > 0 and [r["step"] for r in rec["model"]] == [4]


@pytest.mark.parametrize("program", ["train_vcmr", "train_vr", "eval_vr"])
def test_programs_default_to_the_card(env, programs, program, tmp_path):
    """Without a card the default device raises before any work (no
    output directory is made), instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if program == "eval_vr":
            _, tdir, _, _ = programs("msrvtt_video_sub")
            teval_vr.main(teval_vcmr.build_argparser().parse_args(
                ["--output_dir", tdir, "--checkpoint", "4"]))
        else:
            drv = ttrain if program == "train_vcmr" else ttrain_vr
            over = dict(PROGRAMS["msrvtt_video_sub"][1]) \
                if program == "train_vr" else {}
            drv.main(topts.get_vcmr_args(
                ["--config", env.cfg("nocard", **over), "--output_dir",
                 out]))
    assert not os.path.exists(out)
