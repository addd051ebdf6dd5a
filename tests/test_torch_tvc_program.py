"""hero_tpu_torch's TVC programs against the JAX package: the caption
metrics (and the two stemmers), the caption store and the clip datasets
from it, ``get_tvc_args``, the TVC tree's inverse bridge and checkpoint
files, ``drivers.train_tvc.main`` against ``hero_tpu.drivers.train_tvc.main``
on one run directory (the ``clip.db`` branch; the caption-only branch's
records against the JAX ``generate_captions``; ``--pack_subs``),
``main`` stopped by SIGTERM in a subprocess and resumed, and
``drivers.inf_tvc.main`` against ``hero_tpu.drivers.inf_tvc.main``
(caption store, ``--target_clip``, ``--beam 3``, ``--reference``).

One tiny model (``tests/test_drivers_all.py``'s, every dropout rate 0:
the two frameworks' random streams differ) on one 6-video synthetic
corpus.  Everything is fp32 on the CPU, the port on one torch thread.
The JAX programs run as they are, except that their fp32 is asked for
(``forward_tvc``, and ``greedy_decode`` in ``generate_captions``), their
eager init is replaced by the init checkpoint's tree (which overlays
every key anyway), and their detokenizer gives None; TensorBoard is
kept out of both programs.
"""

import copy
import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config import opts as jopts
from hero_tpu.data import downstream_tasks as jdt
from hero_tpu.data.store import SubTokStore as JSubTokStore
from hero_tpu.data.store import VideoFeatStore as JVideoFeatStore
from hero_tpu.data.video import VideoFeatSubTokDataset as JVideoDataset
from hero_tpu.drivers import common as jcommon
from hero_tpu.drivers import inf_tvc as jinf
from hero_tpu.drivers import train_tvc as jtrain
from hero_tpu.evaluation import caption_metrics as jcm
from hero_tpu.evaluation import porter as jporter
from hero_tpu.evaluation import snowball as jsnowball
from hero_tpu.models import tvc as jtvc
from hero_tpu.training import save as jsave
from hero_tpu_torch.config import opts as topts
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert import from_jax
from hero_tpu_torch.data import downstream_tasks as tdt
from hero_tpu_torch.data import testing as ttesting
from hero_tpu_torch.drivers import common as ttcommon
from hero_tpu_torch.drivers import inf_tvc as tinf
from hero_tpu_torch.drivers import train_tvc as ttrain
from hero_tpu_torch.evaluation import caption_metrics as tcm
from hero_tpu_torch.evaluation import porter as tporter
from hero_tpu_torch.evaluation import snowball as tsnowball
from hero_tpu_torch.models.tvc import init_flat_tvc_params
from hero_tpu_torch.prepro.tokenize import ROBERTA_VOCAB
from hero_tpu_torch.training import optim as toptim
from hero_tpu_torch.training import save as tsave
from tests.test_drivers_all import MODEL_CFG as DRIVER_MODEL_CFG

REPO = pathlib.Path(__file__).resolve().parents[1]
MAX_FRAMES = 16
UNUSED_TVC = sorted(from_jax.UNUSED_TVC_JAX_KEYS)
MODEL_CFG = {name: dict(c, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
             for name, c in DRIVER_MODEL_CFG.items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """Both programs' scalar writers keep to JSONL; no ``transformers``
    probe may wait on the network."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setenv("HF_HUB_OFFLINE", "1")
        yield


# ---------------------------------------------------------------------------
# caption metrics
# ---------------------------------------------------------------------------

WORDS = ("a man woman guy lady sits down takes seat walks away leaves the "
         "room happy glad he she they is are was running runs ran dying "
         "skies early generously it's don't can't gonna 3.5 u.s. (quietly) "
         "\"hello\" well-known red, blue; green: yes! why? ... -- Tom's "
         "ponies caresses hopping meeting").split()
SYNONYMS = "man s1\nguy s1\nwoman s2\nlady s2\nhappy s3\nglad s3\n"
PARAPHRASES = ("sits down ||| takes a seat\n"
               "# a comment\n"
               "0.5 ||| walks away ||| leaves the room\n")


def _sentence(r, n):
    return " ".join(WORDS[i] for i in r.randint(0, len(WORDS), n))


def _captions(seed, n_items=16):
    """{clip id: [reference texts]} and {clip id: hypothesis text}: the
    hypothesis a shuffled part of its first reference plus other words."""
    r = np.random.RandomState(seed)
    refs, hyps = {}, {}
    for i in range(n_items):
        refs[str(i)] = [_sentence(r, r.randint(4, 14))
                        for _ in range(r.randint(1, 4))]
        words = refs[str(i)][0].split()
        r.shuffle(words)
        hyps[str(i)] = " ".join(words[:r.randint(2, len(words) + 1)]
                                + _sentence(r, r.randint(0, 4)).split())
    return refs, hyps


def _tokenized(mod, refs, hyps):
    return ({k: [mod.ptb_tokenize(t) for t in v] for k, v in refs.items()},
            {k: mod.ptb_tokenize(v) for k, v in hyps.items()})


def _metric(name, mod, stem_mods, refs, hyps, ref_path):
    porter, snowball = stem_mods
    if name == "ptb_tokenize":
        return [mod.ptb_tokenize(t) for v in refs.values() for t in v]
    if name in ("porter_stem", "snowball_stem"):
        fn = (porter.porter_stem if name == "porter_stem"
              else snowball.snowball_stem)
        words = sorted({w for v in refs.values() for t in v
                        for w in mod.ptb_tokenize(t)})
        return [fn(w) for w in words + ["generously", "caresses", "dying",
                                        "skies", "hopping", "meeting"]]
    if name == "meteor_variant":
        return mod.meteor_variant()
    if name == "TVCEval":
        return mod.TVCEval(ref_path)(
            [{"clip_id": int(k), "descs": [{"desc": v}]}
             for k, v in hyps.items()])
    gts, res = _tokenized(mod, refs, hyps)
    return getattr(mod, name)(gts, res)


METRIC_CASES = ([(m, "off") for m in (
    "ptb_tokenize", "porter_stem", "snowball_stem", "bleu", "rouge_l",
    "cider_d", "meteor", "TVCEval", "meteor_variant")]
    + [(m, "on") for m in ("meteor", "TVCEval", "meteor_variant")])


@pytest.mark.parametrize("name,stages", METRIC_CASES,
                         ids=[f"{m}-{s}" for m, s in METRIC_CASES])
def test_caption_metrics_equal_jax(name, stages, tmp_path, monkeypatch):
    """Each function of the port's ``caption_metrics`` (with ``porter``
    and ``snowball``) returns exactly what ``hero_tpu``'s returns on two
    seeded corpora; METEOR with its synonym and paraphrase stages off
    (no data: the ``nltk`` probe fails closed) and on (toy files through
    the environment, both modules' one-shot probes reset)."""
    for mod in (jcm, tcm):
        for attr, val in (("_SYN_TABLE", None), ("_SYN_SOURCE", None),
                          ("_SYN_LOADED", False), ("_PARA_TABLE", None),
                          ("_PARA_MAX_LEN", 1), ("_PARA_LOADED", False)):
            monkeypatch.setattr(mod, attr, val)
    if stages == "on":
        for var, text in (("HERO_METEOR_SYNONYMS", SYNONYMS),
                          ("HERO_METEOR_PARAPHRASES", PARAPHRASES)):
            path = tmp_path / var.lower()
            path.write_text(text)
            monkeypatch.setenv(var, str(path))
    else:
        monkeypatch.delenv("HERO_METEOR_SYNONYMS", raising=False)
        monkeypatch.delenv("HERO_METEOR_PARAPHRASES", raising=False)
    for seed in (0, 1):
        refs, hyps = _captions(seed)
        ref_path = tmp_path / f"ref{seed}.jsonl"
        with open(ref_path, "w") as f:
            for k, v in refs.items():
                f.write(json.dumps({"clip_id": int(k), "descs": [
                    {"desc": t} for t in v]}) + "\n")
        got = _metric(name, tcm, (tporter, tsnowball), refs, hyps,
                      str(ref_path))
        want = _metric(name, jcm, (jporter, jsnowball), refs, hyps,
                       str(ref_path))
        assert got == want
    variant = tcm.meteor_variant()
    assert ("+synonym[file]+paraphrase[file]" in variant) == (stages == "on")


# ---------------------------------------------------------------------------
# the caption store, the clip datasets and the options
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tvc_corpus"))
    dbs = ttesting.build_synthetic_corpus(root, n_videos=6,
                                          max_frames=MAX_FRAMES,
                                          vfeat_dim=64)
    return types.SimpleNamespace(root=root, dbs=dbs)


def _video_db(pkg, dbs):
    from hero_tpu_torch.data.store import SubTokStore, VideoFeatStore
    from hero_tpu_torch.data.video import (FixedShapes,
                                           VideoFeatSubTokDataset)
    shapes = FixedShapes(n_subs=4, txt_len=24, frames_per_sub=12,
                         n_frames=MAX_FRAMES, n_queries=2, query_len=16,
                         max_masked=4, vfeat_dim=64)
    if pkg == "jax":
        return JVideoDataset(JSubTokStore(dbs["sub"], max_clip_len=MAX_FRAMES),
                             JVideoFeatStore(dbs["vfeat"],
                                             max_clip_len=MAX_FRAMES),
                             shapes, max_txt_len=12, sub_ctx_len=1)
    return VideoFeatSubTokDataset(
        SubTokStore(dbs["sub"], max_clip_len=MAX_FRAMES),
        VideoFeatStore(dbs["vfeat"], max_clip_len=MAX_FRAMES), shapes,
        max_txt_len=12, sub_ctx_len=1)


def test_caption_store_equals_jax(corpus):
    """``TvcCaptionStore`` over the same ``cap.db``/``clip.db``: the
    special ids, the four id maps, every caption (BOS/EOS shift, cut to
    ``max_txt_len``) and every clip record."""
    path = corpus.dbs["cap"]
    for max_len in (-1, 5):
        got = tdt.TvcCaptionStore(path, max_txt_len=max_len)
        want = jdt.TvcCaptionStore(path, max_txt_len=max_len)
        for attr in ("pad", "bos", "eos", "max_txt_len", "cap2vid",
                     "vid2caps", "vid2clips", "clip2vid"):
            assert getattr(got, attr) == getattr(want, attr), attr
        for cid in want.cap2vid:
            assert got[cid] == want[cid], cid
            if max_len == 5:
                assert len(got[cid]["input_ids"]) <= 5
        for cid in want.clip2vid:
            assert got.get_clip(cid) == want.get_clip(cid), cid
    shutil.copytree(path, os.path.join(corpus.root, "no_clip"),
                    ignore=shutil.ignore_patterns("clip.db"))
    bare = tdt.TvcCaptionStore(os.path.join(corpus.root, "no_clip"))
    assert bare.clip_db is None and bare.vid2clips == {}
    with pytest.raises(AssertionError, match="no clip.db"):
        bare.get_clip("0")


@pytest.mark.parametrize("source", ["caption_db", "jsonl"])
def test_clip_datasets_equal_jax(corpus, source, tmp_path):
    """``TvcClipDataset.from_caption_db`` / ``.from_jsonl`` (3 clips an
    item, so videos span items and items carry pad slots): the items'
    order and every ``build_tvc_clip_batch`` array bit for bit, with the
    host lists."""
    kw = dict(clips_per_item=3, seg_len=MAX_FRAMES)
    jstore = jdt.TvcCaptionStore(corpus.dbs["cap"])
    if source == "caption_db":
        tds = tdt.TvcClipDataset.from_caption_db(
            _video_db("torch", corpus.dbs),
            tdt.TvcCaptionStore(corpus.dbs["cap"]), **kw)
        jds = jdt.TvcClipDataset.from_caption_db(
            _video_db("jax", corpus.dbs), jstore, **kw)
    else:
        path = str(tmp_path / "clips.jsonl")
        with open(path, "w") as f:
            for i, cid in enumerate(sorted(jstore.clip2vid, key=int)[::-1]):
                ex = jstore.get_clip(cid)
                rec = {"vid_name": ex["vid_name"], "clip_id": int(cid),
                       "ts": ex["ts"]}
                if i % 2:
                    rec["descs"] = [{"desc": c["text"]}
                                    for c in ex["captions"]]
                f.write(json.dumps(rec) + "\n\n")
        tds = tdt.TvcClipDataset.from_jsonl(_video_db("torch", corpus.dbs),
                                            path, **kw)
        jds = jdt.TvcClipDataset.from_jsonl(_video_db("jax", corpus.dbs),
                                            path, **kw)
    assert tds.items == jds.items and len(tds) == len(jds) >= 6
    for idx in ([0, 1], [len(jds) - 1, 2, 0]):
        tb = tdt.build_tvc_clip_batch(tds, idx)
        jb = jdt.build_tvc_clip_batch(jds, idx)
        assert set(tb) == set(jb)
        for k in jb:
            if k.startswith("__"):
                assert tb[k] == jb[k], k
            else:
                assert tb[k].dtype == jb[k].dtype, k
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_tvc_options_equal_jax(corpus):
    """``get_tvc_args`` reads ``config/train-tvc.json`` (and a flag that
    overrides it) into the JAX parser's namespace."""
    argv = ["--config", str(REPO / "config" / "train-tvc.json"),
            "--lsr", "0.2", "--max_gen_step", "7"]
    got, want = topts.get_tvc_args(argv), jopts.get_tvc_args(argv)
    assert vars(got) == vars(want)
    assert (got.lsr, got.max_gen_step, got.cap_db) == (
        0.2, 7, "/txt/tvc_cap_db_root")


# ---------------------------------------------------------------------------
# the TVC tree's inverse bridge and checkpoint files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def template():
    return init_flat_tvc_params(tiny_hero_config(), seed=3)


def _random_like(flat, seed, positive=False):
    r = np.random.RandomState(seed)
    out = {k: r.randn(*v.shape).astype(np.float32) for k, v in flat.items()}
    return {k: np.abs(v) for k, v in out.items()} if positive else out


def _assert_flat_equal(got, want, skip=()):
    assert sorted(got) == sorted(want)
    for k in want:
        if k in skip:
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_trees_equal(got, want):
    for path, g, w in zip(toptim.tree_paths(want), toptim.tree_leaves(got),
                          toptim.tree_leaves(want)):
        assert torch.equal(g, w), "/".join(path)


def test_tvc_inverse_bridge_is_exact_both_ways(template):
    """``to_jax_tvc_params(load_jax_tvc_params(f), f) == f`` on every key,
    and ``load_jax_tvc_params(to_jax_tvc_params(p, t)) == p`` for any
    tree; the keys the TVC tree does not hold (poolers, task heads other
    than the LM head) come from the template, their moments zero."""
    t = template
    assert set(UNUSED_TVC) <= set(t)
    _assert_flat_equal(from_jax.to_jax_tvc_params(
        from_jax.load_jax_tvc_params(t, device="cpu"), t), t)
    other = _random_like(t, 1)
    p = from_jax.load_jax_tvc_params(other, device="cpu")
    back = from_jax.to_jax_tvc_params(p, t)
    _assert_flat_equal(back, other, skip=UNUSED_TVC)
    for k in UNUSED_TVC:
        np.testing.assert_array_equal(back[k], t[k])
    _assert_trees_equal(from_jax.load_jax_tvc_params(back, device="cpu"), p)
    mu, nu = _random_like(t, 2), _random_like(t, 3, True)
    state = from_jax.load_jax_tvc_train_state(other, mu, nu, 7, 7,
                                              device="cpu")
    fp, fm, fn, step = from_jax.to_jax_tvc_train_state(state, t)
    assert step == 7
    _assert_flat_equal(fp, back)
    _assert_flat_equal(fm, mu, skip=UNUSED_TVC)
    _assert_flat_equal(fn, nu, skip=UNUSED_TVC)
    for k in UNUSED_TVC:
        assert not fm[k].any() and not fn[k].any()
    with pytest.raises(KeyError, match="template"):
        from_jax.to_jax_tvc_params(p, {**t, "decoder/extra": np.ones(1)})
    with pytest.raises(KeyError):        # the pretraining layout
        from_jax.to_jax_params(p, t)


HPS = {"num_train_steps": 10, "learning_rate": 1e-3}


def test_tvc_checkpoint_files_both_ways(tmp_path, template):
    """The port's TVC ``model_step_N.npz`` and ``restore.npz`` read in
    ``hero_tpu.training.save`` as the inverse bridge's trees; a JAX
    ``restore.npz`` of a TVC state restores in the port equal to
    ``load_jax_tvc_train_state`` of the same trees."""
    other = _random_like(template, 7)
    mu, nu = _random_like(template, 8), _random_like(template, 9, True)
    state = from_jax.load_jax_tvc_train_state(other, mu, nu, 5, 5,
                                              device="cpu")
    writer = tsave.AsyncCheckpointWriter()
    saver = tsave.ModelSaver(str(tmp_path / "ckpt"), template,
                             writer=writer, tree="tvc")
    restorer = tsave.TrainingRestorer(str(tmp_path), HPS, template,
                                      writer=writer, tree="tvc")
    path = saver.save(state.params, 5)
    restorer.step(state, save_steps=5)
    writer.close()
    want_p, want_mu, want_nu, _ = from_jax.to_jax_tvc_train_state(state,
                                                                  template)
    _assert_flat_equal(jsave.flatten_tree(jsave.load_params(path)), want_p)
    jstate = jsave.TrainingRestorer(str(tmp_path), HPS).restore(None)
    assert int(jstate.global_step) == 5 == int(jstate.opt.step)
    _assert_flat_equal(jsave.flatten_tree(jstate.params), want_p)
    _assert_flat_equal(jsave.flatten_tree(jstate.opt.mu), want_mu)
    _assert_flat_equal(jsave.flatten_tree(jstate.opt.nu), want_nu)

    from hero_tpu.training.optim import AdamWState
    from hero_tpu.training.step import TrainState as JState
    jdir = tmp_path / "jax"
    un = jsave.unflatten_tree
    jsave.TrainingRestorer(str(jdir), HPS).save(
        JState(params=un(other), opt=AdamWState(step=8, mu=un(mu),
                                                nu=un(nu)),
               global_step=8), global_step=8)
    tr = tsave.TrainingRestorer(str(jdir), HPS, tree="tvc")
    got = tr.restore("cpu")
    want = from_jax.load_jax_tvc_train_state(other, mu, nu, 8, 8,
                                             device="cpu")
    assert (got.global_step, got.opt.step, tr.global_step) == (8, 8, 8)
    for g, w in ((got.params, want.params), (got.opt.mu, want.opt.mu),
                 (got.opt.nu, want.opt.nu)):
        _assert_trees_equal(g, w)
    _assert_flat_equal(tr.template, other)


# ---------------------------------------------------------------------------
# train_tvc.main against the JAX program
# ---------------------------------------------------------------------------

def _jax_fp32(fn):
    """``fn`` with ``dtype`` forced to fp32 (the JAX program's bf16 sites)."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        return fn(*a, **dict(k, dtype=jnp.float32))
    return wrapped


@pytest.fixture(scope="module")
def run(corpus):
    """The run configs over the corpus: a model config with dropout 0 and
    an init checkpoint holding the whole TVC tree of the JAX init
    (``init_hero_for_tvc`` at seed 9); ``cfg(name, **over)`` writes a
    config (4 steps of 2 videos, ``config/train-tvc.json``'s lr 1e-4 with
    ``lr_mul`` 10 and label smoothing 0.1, validation and saves at step
    4) and returns its path."""
    root = corpus.root
    mc = os.path.join(root, "model.json")
    with open(mc, "w") as f:
        json.dump(MODEL_CFG, f)
    jcfg = jcommon.model_config_from_opts(types.SimpleNamespace(
        model_config=mc, max_clip_len=MAX_FRAMES, vfeat_dim=64))
    init = jax.jit(lambda k: jtvc.init_hero_for_tvc(k, jcfg))(
        jax.random.PRNGKey(9))
    flat = {k: np.asarray(v)
            for k, v in jsave.flatten_tree(jax.device_get(init)).items()}
    ckpt = os.path.join(root, "init_tvc.npz")
    np.savez(ckpt, **flat)
    base = dict(
        sub_txt_db=corpus.dbs["sub"], vfeat_db=corpus.dbs["vfeat"],
        cap_db=corpus.dbs["cap"], model_config=mc, checkpoint=ckpt,
        max_clip_len=MAX_FRAMES, max_txt_len=12, vfeat_interval=1.5,
        vfeat_dim=64, train_batch_size=2, val_batch_size=2,
        gradient_accumulation_steps=1, learning_rate=1e-4, lr_mul=10.0,
        valid_steps=4, save_steps=4, num_train_steps=4, warmup_steps=1,
        grad_norm=1.0, sub_ctx_len=0, seed=3, bucket_n_subs=4,
        bucket_frames_per_sub=12, task="tvc", lsr=0.1, max_gen_step=5)

    def cfg(name, **over):
        d = dict(base, output_dir=os.path.join(root, name), **over)
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(d, f)
        return path

    return types.SimpleNamespace(root=root, cfg=cfg, init=init, flat=flat,
                                 ckpt=ckpt, jcfg=jcfg, cap=corpus.dbs["cap"])


def _jax_patches(mp, run):
    """The JAX programs in fp32, their eager init replaced by the init
    checkpoint's tree (every key of which the checkpoint overlays), no
    detokenizer."""
    mp.setattr(jtvc, "forward_tvc", _jax_fp32(jtvc.forward_tvc))
    mp.setattr(jtvc, "init_hero_for_tvc", lambda rng, cfg: run.init)
    mp.setattr(jinf, "detokenizer", lambda: None)


def _main(name, run, dtype=torch.float32, **over):
    opts = topts.get_tvc_args(["--config", run.cfg(name, **over)])
    state = ttrain.main(opts, device="cpu", dtype=dtype)
    return opts, state


@pytest.fixture(scope="module")
def jax_run(run):
    path = run.cfg("jax")
    with pytest.MonkeyPatch.context() as mp:
        _jax_patches(mp, run)
        jtrain.main(jopts.get_tvc_args(["--config", path]))
    return os.path.join(run.root, "jax")


@pytest.fixture(scope="module")
def port_run(run):
    opts, state = _main("a", run)
    return types.SimpleNamespace(out=opts.output_dir, state=state,
                                 opts=opts)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_train_tvc_main_matches_jax(run, jax_run, port_run):
    """Twin of ``test_tvc_driver_and_inf``'s training half, against the
    JAX program on the same config from the same init checkpoint (the
    ``clip.db`` branch): every parameter the TVC tree holds within atol
    1e-5 of the JAX run's ``model_step_4.npz`` (the tolerance of
    ``test_tvc_train_step_matches_jax``); the other keys are the
    checkpoint's, where the JAX AdamW decays them; the step-4 caption
    records equal, every clip once; the JAX package reads the port's
    files; ``log/`` holds the JAX schema and the checkpoint records."""
    got = _npz(os.path.join(port_run.out, "ckpt", "model_step_4.npz"))
    want = _npz(os.path.join(jax_run, "ckpt", "model_step_4.npz"))
    assert sorted(got) == sorted(want) == sorted(run.flat)
    moved = 0
    for k in want:
        if k in UNUSED_TVC:
            np.testing.assert_array_equal(got[k], run.flat[k], err_msg=k)
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
        moved += not np.array_equal(want[k], run.flat[k])
    assert moved > len(want) // 2
    assert any(not np.array_equal(want[k], run.flat[k]) for k in UNUSED_TVC)
    recs = _jsonl(os.path.join(port_run.out, "tvc_gen_4.jsonl"))
    assert recs == _jsonl(os.path.join(jax_run, "tvc_gen_4.jsonl"))
    clips = jdt.TvcCaptionStore(run.cap).clip2vid
    assert sorted(str(r["clip_id"]) for r in recs) == sorted(clips)
    assert len(recs) == len(clips)
    jstate = jsave.TrainingRestorer(
        port_run.out, {"num_train_steps": 4, "learning_rate": 1e-4}
    ).restore(None)
    assert int(jstate.global_step) == 4
    _assert_flat_equal({k: np.asarray(v) for k, v in jsave.flatten_tree(
        jstate.params).items()}, got)
    log = pathlib.Path(port_run.out, "log")
    assert json.loads((log / "hps.json").read_text()) == vars(port_run.opts)
    rec = json.loads((log / "checkpoints.json").read_text())
    assert [r["step"] for r in rec["model"]] == [4]
    assert [r["step"] for r in rec["restore"]] == [4]
    assert "training done at step 4" in (log / "log.txt").read_text()


def test_caption_only_store_validates_as_jax_does(run, port_run, corpus):
    """Twin of ``test_tvc_driver_caption_only_db``: a caption store
    without ``clip.db`` takes the token branch at the first validation
    and finishes.  Its training equals run A's bit for bit (the same
    captions); its records are ``generate_captions``' and equal the JAX
    ``generate_captions`` (given fp32) on the same weights, and their
    scores ``score_token_captions``' and the JAX function's."""
    cap2 = os.path.join(corpus.root, "cap_only")
    if not os.path.exists(cap2):
        shutil.copytree(corpus.dbs["cap"], cap2,
                        ignore=shutil.ignore_patterns("clip.db"))
    opts, state = _main("caption_only", run, cap_db=cap2)
    _assert_trees_equal(state.params, port_run.state.params)
    recs = _jsonl(os.path.join(opts.output_dir, "tvc_gen_4.jsonl"))
    assert recs and all(set(r) == {"clip_id", "descs", "vid_name"}
                        and set(r["descs"][0]) == {"desc_token_ids"}
                        for r in recs)
    # the JAX token branch on the port's final weights
    final = _npz(os.path.join(opts.output_dir, "ckpt", "model_step_4.npz"))
    jopt = jopts.get_tvc_args(["--config", run.cfg("caption_only",
                                                   cap_db=cap2)])
    jcap = jdt.TvcCaptionStore(cap2, max_txt_len=jopt.max_txt_len)
    jvideo = jcommon.load_video_sub_dataset(jopt,
                                            jcommon.shapes_from_opts(jopt))
    jds = jdt.TvcTrainDataset(jvideo, jcap, caps_per_video=2,
                              cap_len=jopt.max_txt_len + 2,
                              seg_len=jopt.max_clip_len, seed=jopt.seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtvc, "greedy_decode", _jax_fp32(jtvc.greedy_decode))
        want = jtrain.generate_captions(jsave.unflatten_tree(final),
                                        run.jcfg, jds, jopt)
    assert recs == json.loads(json.dumps(want))
    tcap = tdt.TvcCaptionStore(cap2, max_txt_len=opts.max_txt_len)
    assert ttrain.score_token_captions(recs, tcap) == \
        jtrain.score_token_captions(want, jcap)


# run in a fresh interpreter: main on the CPU with SIGTERM sent after step
# 2 (signal handlers need the main thread, which a test worker may not be)
_INTERRUPTED = """
import os, signal, sys, threading
sys.modules["torch.utils.tensorboard"] = None
import torch
torch.set_num_threads(1)
from hero_tpu_torch.config import opts
from hero_tpu_torch.drivers import train_tvc

def on_step(step, task, metrics):
    if step == 2:
        os.kill(os.getpid(), signal.SIGTERM)

state = train_tvc.main(opts.get_tvc_args(["--config", sys.argv[1]]),
                       device="cpu", on_step=on_step, dtype=torch.float32)
assert state.global_step == 2, state.global_step
assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
assert threading.active_count() == 1, threading.enumerate()
"""


def test_main_resumed_after_sigterm_equals_the_uninterrupted_run(run,
                                                                 port_run):
    """SIGTERM after step 2 leaves ``restore.npz`` and the model at step
    2; the resumed run skips the two batches taken and ends with run A's
    ``model_step_4.npz``, ``restore.npz`` and step-4 records, bit for
    bit."""
    path = run.cfg("b")
    out = os.path.join(run.root, "b")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _INTERRUPTED, path],
                          cwd=run.root, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(os.path.join(out, "restore.npz")) as z:
        assert int(z["__step__"]) == 2
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "model_step_2.npz"]
    state = ttrain.main(topts.get_tvc_args(["--config", path]),
                        device="cpu", dtype=torch.float32)
    assert state.global_step == 4
    _assert_trees_equal(state.params, port_run.state.params)
    _assert_trees_equal(state.opt.mu, port_run.state.opt.mu)
    for name in ("ckpt/model_step_4.npz", "restore.npz"):
        _assert_flat_equal(_npz(os.path.join(out, name)),
                           _npz(os.path.join(port_run.out, name)))
    assert _jsonl(os.path.join(out, "tvc_gen_4.jsonl")) == _jsonl(
        os.path.join(port_run.out, "tvc_gen_4.jsonl"))
    rec = json.loads(pathlib.Path(out, "log", "checkpoints.json")
                     .read_text())
    assert rec["restore_ms"] > 0 and [r["step"] for r in rec["model"]] == [4]


def test_pack_subs_run_captions_every_clip(run, port_run, monkeypatch):
    """Twin of ``test_tvc_driver_pack_subs``, port only: ``--pack_subs``
    (2 packed rows of 32 slots) trains in bf16, the program's dtype, and
    validates through the packed f-encoder layout, decoding in fp32 as
    the JAX program does; its records have the unpacked run's schema,
    clips and order."""
    dtypes = []

    def spy(*a, **k):
        dtypes.append(k["dtype"])
        return generate(*a, **k)

    generate = ttrain.generate_clip_captions
    monkeypatch.setattr(ttrain, "generate_clip_captions", spy)
    opts, state = _main("pack", run, dtype=torch.bfloat16, pack_subs=True,
                        bucket_n_subs=2, bucket_txt_len=32,
                        bucket_frames_per_sub=16)
    assert opts.pack_subs and state.global_step == 4
    assert dtypes == [torch.float32]
    recs = _jsonl(os.path.join(opts.output_dir, "tvc_gen_4.jsonl"))
    want = _jsonl(os.path.join(port_run.out, "tvc_gen_4.jsonl"))
    assert [(r["vid_name"], r["clip_id"], r["ts"], list(r["descs"][0]))
            for r in recs] == [(r["vid_name"], r["clip_id"], r["ts"],
                                list(r["descs"][0])) for r in want]
    for leaf in toptim.tree_leaves(state.params):
        assert torch.isfinite(leaf).all()


# ---------------------------------------------------------------------------
# inf_tvc.main against the JAX program
# ---------------------------------------------------------------------------

INF_CASES = {"caption_db": [], "target_clip": ["--target_clip"],
             "beam3": ["--beam", "3"]}


@pytest.mark.parametrize("case", list(INF_CASES))
def test_inf_tvc_main_matches_jax(run, port_run, case, tmp_path,
                                  monkeypatch):
    """Twin of ``test_tvc_driver_and_inf``'s inference half, on run A's
    directory at step 4: the port's and the JAX program's submissions are
    equal record for record, from the caption store (with
    ``--reference``: the same ``TVCEval`` scores, printed and beside the
    submission), from a 3-clip ``--target_clip`` jsonl (exactly those
    clips) and by beam 3; every clip of the source once."""
    cap = jdt.TvcCaptionStore(run.cap)
    clips = sorted(cap.clip2vid, key=int)
    extra = list(INF_CASES[case])
    if case == "target_clip":
        target = str(tmp_path / "target.jsonl")
        with open(target, "w") as f:
            for cid in clips[:3]:
                ex = cap.get_clip(cid)
                f.write(json.dumps({"vid_name": ex["vid_name"],
                                    "clip_id": int(cid),
                                    "ts": ex["ts"]}) + "\n")
        extra.append(target)
        clips = clips[:3]
    if case == "caption_db":
        ref = str(tmp_path / "ref.jsonl")
        with open(ref, "w") as f:
            for cid in clips:
                ex = cap.get_clip(cid)
                f.write(json.dumps({"clip_id": int(cid), "descs": [
                    {"desc": c["text"]} for c in ex["captions"]]}) + "\n")
        extra += ["--reference", ref]
    out = {}
    monkeypatch.setattr(tinf, "detokenizer", lambda: None)
    with pytest.MonkeyPatch.context() as mp:
        _jax_patches(mp, run)
        for pkg, drv in (("torch", tinf), ("jax", jinf)):
            sub = str(tmp_path / f"{pkg}.jsonl")
            args = drv.build_argparser().parse_args(
                ["--output_dir", port_run.out, "--checkpoint", "4",
                 "--submission", sub] + extra)
            res = (drv.main(args, device="cpu") if pkg == "torch"
                   else drv.main(args))
            out[pkg] = (res, _jsonl(sub))
    (tres, trecs), (jres, jrecs) = out["torch"], out["jax"]
    assert trecs == jrecs
    assert sorted((str(r["clip_id"]) for r in trecs), key=int) == clips
    if case == "caption_db":
        assert tres == jres and set(tres) == {
            "Bleu@4", "ROUGE-L", "CIDEr", "METEOR", "METEOR_variant"}
        with open(str(tmp_path / "torch.jsonl") + ".scores.json") as f:
            assert json.load(f) == tres
    else:
        assert json.loads(json.dumps(tres)) == trecs


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def _assert_pt_load_equals_jax(pt, run):
    """The port's ``load_checkpoint_into`` of ``pt`` over the TVC init
    equals ``hero_tpu.drivers.common.load_checkpoint_into``'s, and both
    record the pad decision: none (all 128 word rows)."""
    init = init_flat_tvc_params(_tvc_cfg(run), seed=0)
    info, jinfo = {}, {}
    got = ttcommon.load_checkpoint_into(init, pt, 128, info=info)
    want = jcommon.load_checkpoint_into(jsave.unflatten_tree(init), pt, 128,
                                        info=jinfo)
    assert info == jinfo == {"vocab_padded": False}
    _assert_flat_equal(got, {k: np.asarray(v) for k, v in
                             jsave.flatten_tree(want).items()})


def _tvc_cfg(run):
    return ttcommon.model_config_from_opts(types.SimpleNamespace(
        model_config=os.path.join(run.root, "model.json"),
        max_clip_len=MAX_FRAMES, vfeat_dim=64))


@pytest.mark.parametrize("case", ["train_pt", "inf_pt", "pp_stages",
                                  "train_no_card", "inf_no_card"])
def test_tvc_programs_refuse_what_they_cannot_run(run, port_run, case,
                                                  tmp_path):
    """A reference ``.pt`` checkpoint now loads in both programs (the
    ``.pt`` cases keep the names they had when it raised): ``train_tvc``
    from a ``.pt`` of the init checkpoint's tree (``reference_state_dict``)
    trains to run A's parameters and step-4 captions, bit for bit;
    ``inf_tvc`` from a ``.pt`` of run A's step-4 tree gives the records of
    ``--checkpoint 4``; the port's load of either equals the JAX
    package's.  ``--pp_stages 2`` in a world of 1 raises before any work
    (one rank cannot hold 2 pipeline stages); the
    default device without a card raises instead of running on the
    CPU."""
    inf_args = tinf.build_argparser().parse_args(
        ["--output_dir", port_run.out, "--checkpoint", "4",
         "--submission", str(tmp_path / "s.jsonl")])
    if case == "train_pt":
        pt = str(tmp_path / "init_tvc.pt")
        torch.save({"model": ttesting.reference_state_dict(run.flat)}, pt)
        _assert_pt_load_equals_jax(pt, run)
        opts, state = _main("pt", run, checkpoint=pt)
        _assert_trees_equal(state.params, port_run.state.params)
        assert _jsonl(os.path.join(opts.output_dir, "tvc_gen_4.jsonl")) == \
            _jsonl(os.path.join(port_run.out, "tvc_gen_4.jsonl"))
        assert tsave.checkpoint_vocab_padded(os.path.join(
            opts.output_dir, "ckpt", "model_step_4.npz")) is False
    elif case == "inf_pt":
        pt = str(tmp_path / "model_4.pt")
        torch.save(ttesting.reference_state_dict(_npz(os.path.join(
            port_run.out, "ckpt", "model_step_4.npz"))), pt)
        _assert_pt_load_equals_jax(pt, run)
        recs = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tinf, "detokenizer", lambda: None)
            for ckpt in ("4", pt):
                sub = str(tmp_path / f"{os.path.basename(ckpt)}.jsonl")
                args = tinf.build_argparser().parse_args(
                    ["--output_dir", port_run.out, "--checkpoint", ckpt,
                     "--submission", sub])
                recs[ckpt] = tinf.main(args, device="cpu")
                assert _jsonl(sub) == json.loads(json.dumps(recs[ckpt]))
        assert recs[pt] == recs["4"] and recs[pt]
    elif case == "pp_stages":
        out = str(tmp_path / "pp")
        opts = topts.get_tvc_args(["--config", run.cfg("pp"),
                                   "--pp_stages", "2", "--output_dir", out])
        with pytest.raises(ValueError, match="cannot hold 2 stages"):
            ttrain.main(opts, device="cpu")
        assert not os.path.exists(out)
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            if case == "train_no_card":
                ttrain.main(copy.copy(port_run.opts))
            else:
                tinf.main(inf_args)


class _FakeTokenizer:
    """``RobertaTokenizer`` as ``from_pretrained`` returns it: ``n``
    tokens, ``decode`` of ids as text."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def decode(self, ids, skip_special_tokens):
        assert skip_special_tokens
        return "-".join(map(str, ids))


@pytest.mark.parametrize("installed", ["absent", "vocabless", "full"])
def test_detokenizer_needs_roberta_vocabulary(installed, monkeypatch,
                                              caplog):
    """Without ``transformers``, or with a tokenizer that lacks
    roberta-base's vocabulary (offline, ``transformers`` 5 builds one of
    its 5 special tokens, which decodes every caption to ''), the
    detokenizer is None and warns once, and the program joins the ids by
    spaces; with the vocabulary it decodes, reading the local cache
    only."""
    calls = []

    def from_pretrained(name, **kw):
        calls.append((name, kw))
        return _FakeTokenizer(5 if installed == "vocabless"
                              else ROBERTA_VOCAB)

    fake = types.SimpleNamespace(RobertaTokenizer=types.SimpleNamespace(
        from_pretrained=from_pretrained))
    monkeypatch.setitem(sys.modules, "transformers",
                        None if installed == "absent" else fake)
    tinf.detokenizer.cache_clear()
    try:
        with caplog.at_level("WARNING", logger="hero_tpu_torch"):
            got = [tinf.detokenizer(), tinf.detokenizer()]
    finally:
        tinf.detokenizer.cache_clear()
    warned = [r.getMessage() for r in caplog.records]
    if installed == "full":
        assert got[0] is got[1] and got[0]([7, 8]) == "7-8"
        assert warned == []
    else:
        assert got == [None, None]
        assert warned == ["RobertaTokenizer unavailable; emitting token ids"]
    assert calls == ([] if installed == "absent" else
                     [("roberta-base", {"local_files_only": True})])
