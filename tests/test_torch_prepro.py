"""hero_tpu_torch's data preparation and remaining helpers against the JAX
package: the store builders byte for byte, the tokenizers, the prepro
entry points from raw files to dataset items, the data facade, bucket
sizing and ``suggest_bucket``, the FLOP audit, the standalone TVR scorer
and attention-head pruning.

The JAX side is numpy (its builders, stores and datasets import no JAX);
only the pruning test runs JAX ops, eagerly, on one small block.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from hero_tpu.config.model_config import tiny_hero_config as jax_tiny_config
from hero_tpu.data import downstream_tasks as jdt
from hero_tpu.data import load_data as jld
from hero_tpu.data import occupancy as joc
from hero_tpu.data import store as jstore
from hero_tpu.data import testing as jtesting
from hero_tpu.data import video as jvideo
from hero_tpu.evaluation import tvr_metrics as jtvr
from hero_tpu.prepro import build_dbs as jbuild
from hero_tpu.prepro import tokenize as jtok
from hero_tpu.utils import basic_utils as jbu
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert import from_jax
from hero_tpu_torch.data import downstream_tasks as tdt
from hero_tpu_torch.data import load_data as tld
from hero_tpu_torch.data import occupancy as toc
from hero_tpu_torch.data import store as tstore
from hero_tpu_torch.data import video as tvideo
from hero_tpu_torch.evaluation import tvr_metrics as ttvr
from hero_tpu_torch.models import nn as tnn
from hero_tpu_torch.models import transformer as ttransformer
from hero_tpu_torch.prepro import build_dbs as tbuild
from hero_tpu_torch.prepro import convert_videodb as tconvert
from hero_tpu_torch.prepro import prepro_query as tquery
from hero_tpu_torch.prepro import prepro_tvc as ttvc
from hero_tpu_torch.prepro import suggest_bucket as tbucket
from hero_tpu_torch.prepro import tokenize as ttok
from hero_tpu_torch.utils import basic_utils as tbu

REPO = pathlib.Path(__file__).resolve().parents[1]
MAX_FRAMES = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _same_tree(got, want):
    g, w = _files(got), _files(want)
    assert list(g) == list(w) and w
    for name in w:
        assert g[name] == w[name], name


def _same(got, want):
    """Deep equality; arrays by dtype, shape and bytes."""
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert (got.dtype, got.shape) == (want.dtype, want.shape)
        assert got.tobytes() == want.tobytes()
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif dataclasses.is_dataclass(want):      # the packages' own classes
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# raw inputs, made from a seed
# ---------------------------------------------------------------------------

def _subs(r, n_frames):
    """A subtitle track: overlapping and gapped subs, one past the clip's
    end and a long last one."""
    track, t = [], float(r.uniform(0, 2))
    for i in range(int(r.randint(2, 6))):
        ed = t + float(r.uniform(0.5, 6))
        track.append({"text": f"line {i} HELLO &amp; w{r.randint(50)}",
                      "start": round(t, 2), "end": round(ed, 2)})
        t = ed - float(r.uniform(-1, 1.5))
    track.append({"text": "THE END", "start": round(t, 2),
                  "end": round(t + 20.0, 2)})
    track.append({"text": "after", "start": n_frames * 1.5 + 3,
                  "end": n_frames * 1.5 + 5})
    return sorted(track, key=lambda s: s["start"])


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Features, subtitles, queries, QA and captions for 5 videos (v4 has
    no subtitles); a garbage ``.npz``, one without ``features`` and an
    ``.npy``, each of which the video builders quarantine."""
    root = tmp_path_factory.mktemp("raw")
    r = np.random.RandomState(0)
    (root / "slowfast").mkdir()
    (root / "resnet").mkdir()
    vid2nframe, vid2subs, queries, qa, caps = {}, {}, [], [], []
    for i in range(5):
        vid = f"show_s0{i}_v{i}"
        nf = int(r.randint(8, 14))
        vid2nframe[vid] = nf
        np.savez(root / "slowfast" / f"{vid}.npz",
                 features=r.randn(nf, 40).astype(np.float32))
        np.savez(root / "resnet" / f"{vid}.npz",
                 features=r.randn(nf + 1, 24).astype(np.float16))
        vid2subs[vid] = _subs(r, nf) if i < 4 else []
        for q in range(2):
            st = float(r.uniform(0, nf * 0.75))
            queries.append({"desc_id": 2 * i + q, "vid_name": vid,
                            "desc": f"Query &quot;{q}&quot; ABOUT {i}",
                            "ts": [st, st + float(r.uniform(1, 5))],
                            "type": ("v", "t", "vt")[q]})
        queries[-1]["ts"] = None
        qa.append({"qid": f"q{i}", "vid_name": vid, "q": f"who is {i}?",
                   "answers": [f"answer {a} of {i}" for a in range(3)],
                   "answer_idx": i % 3, "ts": [0.0, 3.0 + i]})
        caps.append({"vid_name": vid, "clip_id": 100 + i, "duration": nf * 1.5,
                     "ts": [1.0, 1.0 + nf * 0.5],
                     "descs": [{"desc_id": 1000 + 10 * i + d,
                                "desc": f"a CAPTION {d} of {i}"}
                               for d in range(1 + i % 3)]})
    queries.append({"desc_id": 99, "desc": "no video"})
    paths = {v: {"slowfast": str(root / "slowfast" / f"{v}.npz"),
                 "resnet": str(root / "resnet" / f"{v}.npz")}
             for v in vid2nframe}
    (root / "garbage.npz").write_bytes(b"xx")
    np.savez(root / "nofeat.npz", other=np.zeros(3))
    np.save(root / "plain.npy", np.zeros((4, 8), np.float16))
    corrupt = dict(paths, bad={"slowfast": str(root / "garbage.npz"),
                               "resnet": paths["show_s00_v0"]["resnet"]},
                   nofeat={"slowfast": str(root / "nofeat.npz")},
                   npy={"slowfast": str(root / "plain.npy")})
    files = {"subs.jsonl": [{"vid_name": v, "sub": s}
                            for v, s in vid2subs.items()],
             "queries.jsonl": queries, "qa.jsonl": qa, "caps.jsonl": caps}
    for name, rows in files.items():
        with open(root / name, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in rows)
    with open(root / "vid2nframe.json", "w") as f:
        json.dump(vid2nframe, f)
    return {"root": root, "vid2nframe": vid2nframe, "vid2subs": vid2subs,
            "paths": paths, "corrupt": corrupt, "queries": queries,
            "qa": qa, "caps": caps}


# ---------------------------------------------------------------------------
# the builders write the JAX bytes
# ---------------------------------------------------------------------------

def _build(pkg, tok, which, raw, out):
    out = str(out)
    if which == "sub":
        pkg.build_sub_db(out, raw["vid2subs"], raw["vid2nframe"], 1.5,
                         tok, split="val",
                         vid2idx={v: 7 * i for i, v in
                                  enumerate(raw["vid2nframe"])})
    elif which == "video":
        return pkg.build_video_db(out, raw["paths"])
    elif which == "video_clips":
        return pkg.build_video_db(out, raw["paths"], clip_interval=6.0,
                                  frame_length=1.5)
    elif which == "video_corrupted":
        return pkg.build_video_db(out, raw["corrupt"])
    elif which == "query":
        pkg.build_query_db(out, raw["queries"], tok)
    elif which == "qa":
        pkg.build_qa_query_db(out, raw["qa"], tok)
    elif which == "caption":
        pkg.build_caption_db(out, raw["caps"], tok)
    elif which == "sidecar":
        pkg.build_sub_db(out, raw["vid2subs"], raw["vid2nframe"], 1.5, tok)
        path = os.path.join(out, "vid2sub_len.json")
        with open(path) as f:
            written = json.load(f)
        os.remove(path)
        assert pkg.emit_sub_len_sidecar(out) == path
        with open(path) as f:
            assert json.load(f) == written
    return None


@pytest.mark.parametrize("which", ["sub", "video", "video_clips",
                                   "video_corrupted", "query", "qa",
                                   "caption", "sidecar"])
def test_builders_write_the_jax_bytes(tmp_path, raw, which):
    got = _build(tbuild, ttok.hash_tokenizer(), which, raw, tmp_path / "t")
    want = _build(jbuild, jtok.hash_tokenizer(), which, raw, tmp_path / "j")
    assert got == want
    if which == "video_corrupted":
        assert want == ["bad", "nofeat", "npy"]
    _same_tree(tmp_path / "t", tmp_path / "j")


def test_sidecar_backfill_of_a_jax_corpus(tmp_path):
    """``emit_sub_len_sidecar`` twin of ``tests/test_data_layer.py:553``:
    it reproduces the sidecar the corpus was written with."""
    corpus = jtesting.build_synthetic_corpus(str(tmp_path / "c"),
                                             n_videos=4, vfeat_dim=16)
    for name, fn in (("t", tbuild.emit_sub_len_sidecar),
                     ("j", jbuild.emit_sub_len_sidecar)):
        dst = tmp_path / name
        shutil.copytree(corpus["sub"], dst)
        os.remove(dst / "vid2sub_len.json")
        fn(str(dst))
    _same_tree(tmp_path / "t", corpus["sub"])
    _same_tree(tmp_path / "t", tmp_path / "j")


def test_basic_utils_match_jax(tmp_path):
    data = [{"a": 1, "b": [1.5, "x"]}, {"c": None}]
    for name, fn in (("save_json", lambda m, p: m.save_json(data, p)),
                     ("pretty", lambda m, p: m.save_json(
                         data, p, save_pretty=True, sort_keys=True)),
                     ("jsonl", lambda m, p: m.save_jsonl(data, p)),
                     ("pickle", lambda m, p: m.save_pickle(data, p))):
        fn(tbu, tmp_path / f"t_{name}")
        fn(jbu, tmp_path / f"j_{name}")
        assert ((tmp_path / f"t_{name}").read_bytes()
                == (tmp_path / f"j_{name}").read_bytes()), name
    assert tbu.load_json(tmp_path / "j_save_json") == data
    assert tbu.load_jsonl(tmp_path / "j_jsonl") == data
    assert tbu.load_pickle(tmp_path / "j_pickle") == data
    x = np.arange(24).reshape(4, 6)
    for dim, lens in ((0, [1, 3]), (1, [2, 0, 4])):
        _same(tbu.dissect_by_lengths(x, lens, dim=dim),
              jbu.dissect_by_lengths(x, lens, dim=dim))
    with pytest.raises(ValueError):
        tbu.dissect_by_lengths(x, [1, 1])
    for v in ("friends_s01e02_seg02_clip_00", "met_s1", "s05e12_seg01",
              "grey_x", "castle"):
        assert tbu.get_show_name(v) == jbu.get_show_name(v)


# ---------------------------------------------------------------------------
# the tokenizers
# ---------------------------------------------------------------------------

TEXTS = ["Hello &amp; goodbye", "I SAID NO!", "Tom &lt;3 Jerry &#39;s",
         "MIXED Case TEXT", "", "  spaces   here ", "caf&eacute; &quot;x&quot;",
         "ALL CAPS &AMP; MORE", "12 34"]


def test_hash_tokenizer_ids_equal_jax():
    for vr in ((3, 50260), (5, 100)):
        t, j = ttok.hash_tokenizer(vr), jtok.hash_tokenizer(vr)
        for s in TEXTS:
            assert t(s) == j(s), s
    t, j = ttok.get_tokenizer("hash"), jtok.get_tokenizer("hash")
    assert [t(s) for s in TEXTS] == [j(s) for s in TEXTS]
    with pytest.raises(ValueError, match="roberta or hash"):
        ttok.get_tokenizer("bpe")


def test_roberta_tokenizer_refuses_without_its_vocabulary(tmp_path, raw,
                                                          monkeypatch):
    """No silent fallback to the hash tokenizer (the JAX package falls
    back): the error names the vocabulary and ``--tokenizer hash``, and
    the entry point writes nothing."""
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="--tokenizer hash") as e:
        ttok.get_tokenizer("roberta")
    assert "roberta-base vocabulary" in str(e.value)
    out = tmp_path / "q"
    with pytest.raises(RuntimeError, match="--tokenizer hash"):
        tquery.main(["--query_jsonl", str(raw["root"] / "queries.jsonl"),
                     "--output", str(out)])
    assert not out.exists()


# ---------------------------------------------------------------------------
# the entry points: raw files -> stores -> dataset items
# ---------------------------------------------------------------------------

def _load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_script(monkeypatch, name, *args):
    """``scripts/<name>.py`` of the JAX package, in this process."""
    mod = _load_script(REPO / "scripts" / f"{name}.py", f"_jax_{name}")
    monkeypatch.setattr(sys, "argv", [name, *args])
    mod.main()


@pytest.fixture(scope="module")
def pipeline(raw, tmp_path_factory):
    """The raw files through the port's entry points (``prepro_sub`` as a
    ``python -m`` subprocess, the others' ``main`` here) and through the
    JAX scripts."""
    root = raw["root"]
    out = tmp_path_factory.mktemp("pipeline")
    mp = pytest.MonkeyPatch()
    try:
        for side in ("t", "j"):
            d = out / side
            video = ["--slowfast_dir", str(root / "slowfast"),
                     "--resnet_dir", str(root / "resnet"),
                     "--output", str(d / "video_db")]
            sub = ["--sub_jsonl", str(root / "subs.jsonl"),
                   "--vid2nframe", str(root / "vid2nframe.json"),
                   "--output", str(d / "sub_db"), "--tokenizer", "hash"]
            query = ["--query_jsonl", str(root / "queries.jsonl"),
                     "--output", str(d / "query_db"), "--tokenizer", "hash"]
            qa = ["--query_jsonl", str(root / "qa.jsonl"), "--task", "tvqa",
                  "--output", str(d / "qa_db"), "--tokenizer", "hash"]
            cap = ["--caption_jsonl", str(root / "caps.jsonl"),
                   "--output", str(d / "tvc"), "--tokenizer", "hash"]
            if side == "t":
                tconvert.main(video)
                proc = subprocess.run(
                    [sys.executable, "-m", "hero_tpu_torch.prepro.prepro_sub",
                     *sub], cwd=REPO, capture_output=True, text=True,
                    timeout=120)
                assert proc.returncode == 0, proc.stderr[-3000:]
                tquery.main(query)
                tquery.main(qa)
                ttvc.main(cap)
            else:
                for name, args in (("convert_videodb", video),
                                   ("prepro_sub", sub),
                                   ("prepro_query", query),
                                   ("prepro_query", qa),
                                   ("prepro_tvc", cap)):
                    _jax_script(mp, name, *args)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("store", ["sub_db", "query_db", "qa_db", "tvc"])
def test_entry_points_write_the_jax_stores(pipeline, store):
    _same_tree(pipeline / "t" / store, pipeline / "j" / store)


def test_entry_points_to_dataset_items(pipeline, raw):
    """The twin of ``tests/test_prepro_pipeline.py::
    test_prepro_pipeline_to_model``: the port's stores read back, and
    ``VideoFeatSubTokDataset.video_item`` on them equals the JAX item on
    the JAX-built stores bit for bit."""
    t, j = pipeline / "t", pipeline / "j"
    tv = tstore.VideoFeatStore(str(t / "video_db"), max_clip_len=MAX_FRAMES)
    jv = jstore.VideoFeatStore(str(j / "video_db"), max_clip_len=MAX_FRAMES)
    assert tv.name2nframe == jv.name2nframe == raw["vid2nframe"]
    for vid, paths in raw["paths"].items():
        with np.load(paths["slowfast"]) as a, np.load(paths["resnet"]) as b:
            n = raw["vid2nframe"][vid]
            want = np.concatenate([a["features"][:n], b["features"][:n]],
                                  -1).astype(np.float16)
        _same(tv[vid], want)
    tsub = tstore.SubTokStore(str(t / "sub_db"), max_clip_len=MAX_FRAMES)
    jsub = jstore.SubTokStore(str(j / "sub_db"), max_clip_len=MAX_FRAMES)
    assert tsub.vid_sub2frame == jsub.vid_sub2frame
    for vid in raw["vid2nframe"]:
        frames = [f for _, fs in tsub.vid_sub2frame[vid] for f in fs]
        assert len(frames) == len(set(frames))
    tq = tstore.QueryTokStore(str(t / "query_db"))
    hash_ids = ttok.hash_tokenizer()
    for item in raw["queries"]:
        assert tq[str(item["desc_id"])]["input_ids"] == hash_ids(item["desc"])
    assert tq.query2video["0"] == "show_s00_v0"
    kw = dict(n_subs=4, txt_len=16, frames_per_sub=12, n_frames=MAX_FRAMES,
              n_queries=1, query_len=12, max_masked=3, vfeat_dim=64)
    for pack in (False, True):
        tdb = tvideo.VideoFeatSubTokDataset(
            tsub, tv, tvideo.FixedShapes(**kw), max_txt_len=10, pack=pack)
        jdb = jvideo.VideoFeatSubTokDataset(
            jsub, jv, jvideo.FixedShapes(**kw), max_txt_len=10, pack=pack)
        for vid in raw["vid2nframe"]:
            _same(tdb.video_item(vid), jdb.video_item(vid))


def test_entry_points_run_as_modules(pipeline, raw, tmp_path):
    """Every ``python -m`` entry point of the slice runs (one process,
    ``runpy`` as ``-m`` does), writes what its ``main`` writes here and
    imports no ``torch`` (data preparation needs no card)."""
    root, t = raw["root"], pipeline / "t"
    sub_copy = tmp_path / "sub_db"
    shutil.copytree(t / "sub_db", sub_copy)
    os.remove(sub_copy / "vid2sub_len.json")
    r = np.random.RandomState(3)
    submission, gt = _random_submission(r, n_q=6, n_videos=4, n_pred=20,
                                        L=16)
    with open(tmp_path / "sub.json", "w") as f:
        json.dump(submission, f)
    with open(tmp_path / "gt.jsonl", "w") as f:
        f.writelines(json.dumps(g) + "\n" for g in gt)
    runs = [
        ("hero_tpu_torch.prepro.convert_videodb",
         ["--slowfast_dir", str(root / "slowfast"), "--resnet_dir",
          str(root / "resnet"), "--output", str(tmp_path / "video_db")]),
        ("hero_tpu_torch.prepro.prepro_query",
         ["--query_jsonl", str(root / "queries.jsonl"), "--output",
          str(tmp_path / "query_db"), "--tokenizer", "hash"]),
        ("hero_tpu_torch.prepro.prepro_tvc",
         ["--caption_jsonl", str(root / "caps.jsonl"), "--output",
          str(tmp_path / "tvc"), "--tokenizer", "hash"]),
        ("hero_tpu_torch.prepro.build_dbs", [str(sub_copy)]),
        ("hero_tpu_torch.prepro.suggest_bucket",
         ["--sub_txt_db", str(t / "sub_db"), "--max_clip_len", "16",
          "--pack"]),
        ("hero_tpu_torch.evaluation.tvr_metrics",
         ["--submission_path", str(tmp_path / "sub.json"), "--gt_path",
          str(tmp_path / "gt.jsonl"), "--save_path",
          str(tmp_path / "metrics.json"), "--not_verbose"]),
    ]
    code = ("import runpy, sys, json\n"
            "for mod, argv in json.loads(sys.argv[1]):\n"
            "    sys.argv = [mod] + argv\n"
            "    runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
            "assert 'torch' not in sys.modules, 'data preparation imported "
            "torch'\n")
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(runs)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "converted 5 videos (0 corrupted)" in proc.stdout
    for name in ("query_db", "tvc"):
        _same_tree(tmp_path / name, t / name)
    _same_tree(sub_copy, t / "sub_db")
    flags = json.loads([ln for ln in proc.stdout.splitlines()
                        if ln.startswith("{")][0])
    assert flags["pack_subs"] and flags["bucket_n_subs"] >= 1
    with open(tmp_path / "metrics.json") as f:
        assert f.read() == json.dumps(jtvr.eval_retrieval(
            submission, gt, iou_thds=(0.5, 0.7), verbose=False), indent=4)


# ---------------------------------------------------------------------------
# the data facade, bucket sizing and suggest_bucket
# ---------------------------------------------------------------------------

SHAPES = dict(n_subs=4, txt_len=24, frames_per_sub=12, n_frames=MAX_FRAMES,
              n_queries=2, query_len=16, max_masked=4, vfeat_dim=64)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return jtesting.build_synthetic_corpus(root, n_videos=6,
                                           max_frames=MAX_FRAMES,
                                           vfeat_dim=64)


@pytest.mark.parametrize("task", ["tvr", "tvqa", "violin", "video_only"])
def test_load_data_facade_matches_jax(corpus, task):
    """The twin of ``tests/test_data_layer.py:405``: every item equal."""
    kw = dict(max_clip_len=MAX_FRAMES, max_txt_len=10)
    tdb = tld.load_video_sub_dataset(corpus["vfeat"], corpus["sub"],
                                     tvideo.FixedShapes(**SHAPES), **kw)
    jdb = jld.load_video_sub_dataset(corpus["vfeat"], corpus["sub"],
                                     jvideo.FixedShapes(**SHAPES), **kw)
    assert tld.get_video_ids(tdb.txt_db) == jld.get_video_ids(jdb.txt_db)
    if task == "video_only":
        for meta_db in (None, corpus["query"]):
            t = tld.load_video_only_dataset(
                corpus["vfeat"], meta_db, tvideo.FixedShapes(**SHAPES),
                max_clip_len=MAX_FRAMES)
            j = jld.load_video_only_dataset(
                corpus["vfeat"], meta_db, jvideo.FixedShapes(**SHAPES),
                max_clip_len=MAX_FRAMES)
            assert t.vids == j.vids
            for vid in j.vids:
                _same(t.video_item(vid), j.video_item(vid))
        return
    query = {"tvr": "query", "tvqa": "qa_query", "violin": "violin_query"}
    t = tld.build_downstream_dataset(task, tdb, corpus[query[task]])
    j = jld.build_downstream_dataset(task, jdb, corpus[query[task]])
    assert len(t) == len(j) > 0
    for i in range(len(j)):
        _same(t[i], j[i])
    with pytest.raises(ValueError, match="Unrecognized task"):
        tld.build_downstream_dataset("nope", tdb, corpus["query"])


@pytest.mark.parametrize("append_len,max_rows", [(0, 32), (16, 32),
                                                 (0, 1)])
def test_suggest_packed_shapes_matches_jax(corpus, append_len, max_rows):
    """Twins of ``tests/test_packing.py:137`` and ``:294`` (and the
    unpacked fallback when no bucket reaches the coverage)."""
    tsub = tstore.SubTokStore(corpus["sub"], max_clip_len=MAX_FRAMES)
    jsub = jstore.SubTokStore(corpus["sub"], max_clip_len=MAX_FRAMES)
    for coverage in (1.0, 0.5):
        for sidecar in (True, False):
            if not sidecar:
                tsub.vid2sub_lens = jsub.vid2sub_lens = None
            kw = dict(coverage=coverage, max_txt_len=8, max_rows=max_rows,
                      append_len=append_len)
            got = tvideo.suggest_packed_shapes(
                tsub, base=tvideo.FixedShapes(**SHAPES), **kw)
            want = jvideo.suggest_packed_shapes(
                jsub, base=jvideo.FixedShapes(**SHAPES), **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_suggest_downstream_lens_matches_jax(corpus):
    """The twin of ``tests/test_packing.py:257``."""
    for task, db in (("tvqa", "qa_query"), ("videoqa", "qa_query"),
                     ("violin", "violin_query"), ("tvc", "cap")):
        for coverage in (1.0, 0.6):
            kw = dict(coverage=coverage, frame_interval=1.5,
                      max_clip_len=MAX_FRAMES)
            assert (tdt.suggest_downstream_lens(task, corpus[db], **kw)
                    == jdt.suggest_downstream_lens(task, corpus[db], **kw))
    with pytest.raises(ValueError, match="no downstream bucket"):
        tdt.suggest_downstream_lens("tvr", corpus["query"])


def test_suggest_bucket_prints_the_tool_flags(corpus, capsys, monkeypatch):
    """``prepro.suggest_bucket.main`` prints what ``tools/suggest_bucket.py``
    prints."""
    tool = _load_script(REPO / "tools" / "suggest_bucket.py",
                        "_jax_suggest_bucket")
    sub = ["--sub_txt_db", corpus["sub"], "--max_clip_len", "16",
           "--max_txt_len", "8"]
    for args in (sub, sub + ["--pack", "--sub_ctx_len", "1"],
                 sub + ["--task", "tvqa", "--query_txt_db",
                        corpus["qa_query"], "--pack"],
                 ["--task", "violin", "--query_txt_db",
                  corpus["violin_query"], "--coverage", "0.5"],
                 ["--task", "tvc", "--cap_db", corpus["cap"],
                  "--max_clip_len", "16"]):
        tbucket.main(args)
        got = capsys.readouterr()
        monkeypatch.setattr(sys, "argv", ["suggest_bucket.py", *args])
        tool.main()
        want = capsys.readouterr()
        assert (got.out, got.err) == (want.out, want.err)
        assert got.out.startswith("{")


# ---------------------------------------------------------------------------
# the FLOP audit
# ---------------------------------------------------------------------------

def test_occupancy_audit_matches_jax(capsys):
    """The twin of ``tests/test_data_layer.py:621``: the audit's dict
    exactly, each FLOP model, and the printed table."""
    assert (toc.audit(n_batches=4, batch=16, seed=3)
            == joc.audit(n_batches=4, batch=16, seed=3))
    tight = dict(n_batches=2, batch=8, seed=1, n_subs=12, txt_len=30)
    assert toc.audit(**tight) == joc.audit(**tight)
    assert (toc.refpad_flops_per_example(n_batches=2, batch=8)
            == joc.refpad_flops_per_example(n_batches=2, batch=8))
    r = np.random.RandomState(5)
    videos = [toc.sample_tv_video(r) for _ in range(6)]
    jvideos = [joc.VideoShape(*dataclasses.astuple(v)) for v in videos]
    assert (toc.batch_flops_refpad(videos, n_queries=3, query_len=20)
            == joc.batch_flops_refpad(jvideos, n_queries=3, query_len=20))
    assert (toc.batch_flops_ideal(videos)
            == joc.batch_flops_ideal(jvideos))
    assert ([toc.video_flops_bucket(v, n_subs=8) for v in videos]
            == [joc.video_flops_bucket(v, n_subs=8) for v in jvideos])
    toc.main()
    got = capsys.readouterr().out
    joc.main()
    assert got == capsys.readouterr().out


# ---------------------------------------------------------------------------
# the standalone TVR scorer
# ---------------------------------------------------------------------------

def _random_submission(r, n_q, n_videos, n_pred, L):
    video2idx = {f"v{i}": 10 + i for i in range(n_videos)}
    sub = {"video2idx": video2idx}
    for task in ("VR", "SVMR", "VCMR"):
        rows = []
        for q in range(n_q):
            st = r.randint(0, L, n_pred) * 1.5
            preds = [[10 + int(r.randint(n_videos)), float(s),
                      float(s + 1.5 * r.randint(1, 6)), float(sc)]
                     for s, sc in zip(st, np.sort(r.rand(n_pred))[::-1])]
            rows.append({"desc_id": q, "desc": "", "predictions": preds})
        sub[task] = rows
    gt = [{"desc_id": q, "desc": "", "vid_name": f"v{r.randint(n_videos)}",
           "ts": [1.5 * (t := int(r.randint(0, L - 6))),
                  1.5 * (t + int(r.randint(1, 6)))],
           "type": ("v", "t", "vt")[q % 3]} for q in range(n_q)]
    return sub, gt


@pytest.mark.parametrize("verbose", [False, True])
def test_tvr_eval_main_writes_the_jax_results(tmp_path, capsys, verbose):
    r = np.random.RandomState(8)
    submission, gt = _random_submission(r, n_q=9, n_videos=5, n_pred=30,
                                        L=20)
    with open(tmp_path / "sub.json", "w") as f:
        json.dump(submission, f)
    with open(tmp_path / "gt.jsonl", "w") as f:
        f.writelines(json.dumps(g) + "\n" for g in gt)
    argv = ["--submission_path", str(tmp_path / "sub.json"),
            "--gt_path", str(tmp_path / "gt.jsonl"),
            "--save_path", str(tmp_path / "got.json")]
    ttvr.eval_main(argv + ([] if verbose else ["--not_verbose"]))
    printed = capsys.readouterr().out
    want = jtvr.eval_retrieval(submission, gt, iou_thds=(0.5, 0.7),
                               verbose=False)
    with open(tmp_path / "got.json") as f:
        assert f.read() == json.dumps(want, indent=4)
    if verbose:
        assert json.loads(printed[printed.index("{"):]) == json.loads(
            json.dumps(want))


# ---------------------------------------------------------------------------
# attention-head pruning
# ---------------------------------------------------------------------------

def test_prune_attention_heads_matches_jax():
    """The twin of ``tests/test_backbone.py:201``: the port's pruned block
    is the JAX pruned kernels, transposed and fused, and the pruned
    attention with H - 1 heads equals JAX's output in fp32."""
    import jax.numpy as jnp
    from hero_tpu.models import nn as jnn
    from hero_tpu.models import transformer as jtransformer

    jcfg = jax_tiny_config().f_config
    tcfg = tiny_hero_config().f_config
    D, H = jcfg.hidden_size, jcfg.num_attention_heads
    r = np.random.RandomState(4)

    def lin(d_in, d_out):
        return {"kernel": (0.2 * r.randn(d_in, d_out)).astype(np.float32),
                "bias": (0.1 * r.randn(d_out)).astype(np.float32)}

    jp = {n: lin(D, D) for n in ("query", "key", "value", "out")}
    jp["out_ln"] = {"scale": (1 + 0.1 * r.randn(D)).astype(np.float32),
                    "bias": (0.1 * r.randn(D)).astype(np.float32)}

    def bridged(tree):
        flat = {f"a/{k}/{leaf}": torch.from_numpy(np.asarray(v))
                for k, sub in tree.items() for leaf, v in sub.items()}
        return from_jax._attention(flat.__getitem__, "a")

    d_head = D // H
    for heads in ([0], [1, 3]):
        jpr = jnn.prune_attention_heads(jp, heads, H)
        tpr = tnn.prune_attention_heads(bridged(jp), heads, H)
        _same({k: {n: v.numpy() for n, v in sub.items()}
               for k, sub in tpr.items()},
              {k: {n: v.numpy() for n, v in sub.items()}
               for k, sub in bridged(jpr).items()})
        assert tpr["qkv"]["weight"].shape == (3 * (D - len(heads) * d_head),
                                              D)
    x = r.randn(2, 5, D).astype(np.float32)
    mask = np.ones((2, 5), np.float32)
    mask[1, 3:] = 0
    small_j = jcfg.replace(num_attention_heads=H - 1)
    small_t = dataclasses.replace(tcfg, num_attention_heads=H - 1)
    jpr = jnn.prune_attention_heads(jp, [2], H)
    want = np.asarray(jtransformer.attention(
        jax_tree(jpr, jnp), jnp.asarray(x), jnp.asarray(mask), small_j))
    got = ttransformer.attention(
        tnn.prune_attention_heads(bridged(jp), [2], H), torch.from_numpy(x),
        small_t, kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def jax_tree(tree, jnp):
    return {k: {n: jnp.asarray(v) for n, v in sub.items()}
            for k, sub in tree.items()}
