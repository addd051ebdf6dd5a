"""hero_tpu_torch's stores, checkpoints and pretraining program against the
JAX package: the msgpack subset against ``msgpack`` itself, the stores
and the synthetic corpus against ``hero_tpu.data``, the native reader and
LZ4 against ``hero_tpu.native``, the inverse bridge, the checkpoint files
against ``hero_tpu.training.save`` both ways, ``build_targets`` against
the JAX driver's, and ``drivers.pretrain.main`` interrupted by SIGTERM and
resumed against the uninterrupted run.

Nothing here compiles a JAX program: the JAX side is its numpy stores and
file I/O.  The port's runs are fp32 and bf16 on the CPU at a tiny model.
"""

import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import types

import msgpack
import numpy as np
import pytest
import torch

from hero_tpu.data import store as jstore
from hero_tpu.data import testing as jtesting
from hero_tpu.training import save as jsave
from hero_tpu_torch.config import opts as topts
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert import from_jax
from hero_tpu_torch.data import msgpack_codec
from hero_tpu_torch.data import store as tstore
from hero_tpu_torch.data import testing as ttesting
from hero_tpu_torch.drivers import common as tcommon
from hero_tpu_torch.drivers import pretrain as tdrv
from hero_tpu_torch.models.pretrain import init_flat_params
from hero_tpu_torch.native import herostore as tnative
from hero_tpu_torch.training import optim as toptim
from hero_tpu_torch.training import save as tsave
from hero_tpu_torch.training.step import TrainState

REPO = pathlib.Path(__file__).resolve().parents[1]
MAX_FRAMES = 16
POOLERS = sorted(from_jax.UNUSED_JAX_KEYS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model on one intra-op thread.  Beside other test workers,
    each with a full OpenMP pool, the train loop's threads starved: a
    3 s run took minutes.  The results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------

def _jax_packb(v):
    return msgpack.packb(v, use_bin_type=True, default=jstore._pack_default)


def _jax_unpackb(b):
    return msgpack.unpackb(b, raw=False, ext_hook=jstore._unpack_ext)


def _same(got, want):
    """Deep equality with ndarrays compared by dtype, shape and bytes."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert (got.dtype, got.shape) == (want.dtype, want.shape)
        assert got.tobytes() == want.tobytes()
        assert got.flags.writeable == want.flags.writeable
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif dataclasses.is_dataclass(want):
        # the packer's placements: each package has its own class
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    else:
        assert type(got) is type(want) and got == want, (got, want)


INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2**31, -2**31 - 1, -2**63]
LEN_EDGES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]
DTYPES = ["float16", "float32", "float64", "int8", "int16", "int32",
          "int64", "uint8", "uint16", "uint32", "uint64", "bool"]


def _random_value(r, depth=0):
    kind = r.randint(11 if depth < 3 else 7)
    if kind == 0:
        return None
    if kind == 1:
        return bool(r.randint(2))
    if kind == 2:
        v = int(r.choice(INT_EDGES)) + int(r.randint(-2, 3))
        return v if -2**63 <= v < 2**64 else int(r.choice(INT_EDGES))
    if kind == 3:
        return float(r.randn()) * 10.0 ** r.randint(-30, 30)
    if kind == 4:
        return "ü" * int(r.randint(40)) + "x" * int(r.choice(LEN_EDGES[:8]))
    if kind == 5:
        return bytes(r.randint(0, 256, size=int(r.choice(LEN_EDGES[:8])))
                     .astype(np.uint8))
    if kind == 6:
        dt = np.dtype(str(r.choice(DTYPES)))
        shape = tuple(int(n) for n in r.randint(0, 5, size=r.randint(4)))
        return np.array(np.abs(r.randn(*shape) * 100), dtype=dt)
    if kind == 7:
        return [_random_value(r, depth + 1) for _ in range(r.randint(20))]
    if kind == 8:
        return tuple(_random_value(r, depth + 1) for _ in range(r.randint(5)))
    if kind == 9:
        return {f"k{i}": _random_value(r, depth + 1)
                for i in range(r.randint(20))}
    return [np.int64(r.randint(-10**6, 10**6)), np.float32(r.randn()),
            np.uint8(7), np.float64(r.randn())]


def _cases(family, seed):
    r = np.random.RandomState(seed)
    if family == "edges":
        return ([None, True, False, 0.5, -0.0, float("inf"), 1e308]
                + INT_EDGES
                + ["s" * n for n in LEN_EDGES] + ["é" * 20]
                + [b"b" * n for n in LEN_EDGES] + [bytearray(b"xy")]
                + [list(range(n)) for n in LEN_EDGES]
                + [tuple(range(17))]
                + [{str(i): i for i in range(n)} for n in LEN_EDGES[:8]]
                + [{"k": {str(i): None for i in range(65536)}}])
    if family == "index":
        # a store's index.bin and a sub store's msg values
        return [{f"vid{i:05d}": (int(r.randint(2**40)), int(r.randint(1,
                2**31)), "raw" if i % 3 else "msg") for i in range(3000)},
                {"input_ids": [r.randint(3, 50265, size=r.randint(1, 40))
                               .tolist() for _ in range(12)],
                 "unique_sub2frames": [(i, list(range(i, i + 4)))
                                       for i in range(12)],
                 "unmatched_frames": []}]
    if family == "ndarrays":
        # every ext framing: fixext 16 (a 5-byte uint8 vector), ext 8,
        # ext 16 and ext 32 payloads; 0-d, empty and non-contiguous arrays
        arrs = [np.zeros(5, np.uint8), np.arange(40, dtype=np.int32),
                np.ones((10, 100), np.float16), np.ones(20000, np.float32),
                np.array(3.5), np.zeros((0, 3), np.int64),
                np.arange(12.0).reshape(3, 4)[:, ::2]]
        arrs += [np.abs(r.randn(3, 4) * 50).astype(dt) for dt in DTYPES]
        return [{"feat": a, "nested": [a, {"x": a}]} for a in arrs]
    return [_random_value(r) for _ in range(60)]


@pytest.mark.parametrize("family,seed", [("edges", 0), ("index", 1),
                                         ("ndarrays", 2), ("random", 3),
                                         ("random", 4)])
def test_msgpack_codec_bytes_equal_msgpack(family, seed):
    """``packb`` writes msgpack's bytes (``use_bin_type=True`` with the
    store's ndarray default) and ``unpackb`` reads them back as
    ``msgpack.unpackb`` with the store's ext hook does."""
    for v in _cases(family, seed):
        want = _jax_packb(v)
        got = msgpack_codec.packb(v)
        assert got == want, repr(v)[:200]
        _same(msgpack_codec.unpackb(got), _jax_unpackb(want))


def test_msgpack_codec_rejects_what_is_outside_the_subset():
    for v in (set(), 1j, object(), np.bool_(True), 2**64, -2**63 - 1,
              [1, {2}]):
        with pytest.raises(TypeError):
            _jax_packb(v)
        with pytest.raises(TypeError):
            msgpack_codec.packb(v)
    for other in (msgpack.packb(1.5, use_single_float=True),
                  msgpack.packb(msgpack.ExtType(5, b"abc")),
                  msgpack.packb(msgpack.Timestamp(1))):
        with pytest.raises(TypeError):
            msgpack_codec.unpackb(other)
    packed = msgpack_codec.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(packed[:-1])
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(packed + b"\x00")
    with pytest.raises(ValueError):          # msgpack's strict_map_key
        msgpack_codec.unpackb(_jax_packb({1: 2}))


@pytest.mark.parametrize("value", [
    np.arange(24, dtype=np.float16).reshape(2, 3, 4),
    np.zeros((0,), np.int32), np.array(True),
    {"input_ids": [[3, 4], [5]], "target": [1.5, 2.25]},
    [np.ones(3, np.uint8), "x"]], ids=["raw", "raw-empty", "raw-0d",
                                       "msg", "msg-ndarray"])
def test_pack_value_matches_jax(value):
    got, want = tstore.pack_value(value), jstore.pack_value(value)
    assert got == want
    _same(tstore.unpack_value(*got), jstore.unpack_value(*want))


# ---------------------------------------------------------------------------
# stores, the synthetic corpus, the native reader
# ---------------------------------------------------------------------------

def _files(root):
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("correlated", [False, True])
def test_synthetic_corpus_is_byte_identical(tmp_path, correlated):
    kw = dict(n_videos=7, max_frames=12, vfeat_dim=24, seed=5,
              correlated=correlated)
    want = jtesting.build_synthetic_corpus(str(tmp_path / "jax"), **kw)
    got = ttesting.build_synthetic_corpus(str(tmp_path / "port"), **kw)
    assert {k: os.path.relpath(v, tmp_path / "port") for k, v in got.items()
            if k != "vids"} == \
        {k: os.path.relpath(v, tmp_path / "jax") for k, v in want.items()
         if k != "vids"}
    jf, tf = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert list(tf) == list(jf) and len(jf) > 20
    for name in jf:
        assert tf[name] == jf[name], name


@pytest.fixture(scope="module")
def jax_corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_corpus"))
    return jtesting.build_synthetic_corpus(root, n_videos=6,
                                           max_frames=MAX_FRAMES,
                                           vfeat_dim=64)


def _store_dirs(corpus):
    cap = corpus["cap"]
    return [corpus[k] for k in ("sub", "vfeat", "query", "qa_query",
                                "violin_query")] + [
        os.path.join(cap, "cap.db"), os.path.join(cap, "clip.db")]


@pytest.mark.parametrize("reader", ["native", "mmap"])
def test_port_stores_read_a_jax_corpus(jax_corpus, monkeypatch, reader):
    """Every key of every store, and every typed wrapper's tables, as the
    JAX stores read them, through each reader."""
    if reader == "mmap":
        monkeypatch.setattr(tstore, "_native_reader", lambda: None)
    elif not tnative.available():
        pytest.fail("g++ could not build the native reader")
    for d in _store_dirs(jax_corpus):
        got, want = tstore.HeroStore(d), jstore.HeroStore(d)
        assert got.reader == reader
        assert list(got.keys()) == list(want.keys()) and len(got) > 0
        for k in want.keys():
            _same(got[k], want[k])
        got.close()
        with pytest.raises(ValueError, match="closed"):
            got[k]
    for mcl in (-1, 10):
        tv = tstore.VideoFeatStore(jax_corpus["vfeat"], max_clip_len=mcl)
        jv = jstore.VideoFeatStore(jax_corpus["vfeat"], max_clip_len=mcl)
        assert tv.name2nframe == jv.name2nframe
        for vid in jv.name2nframe:
            assert tv[vid].dtype == np.float16
            _same(tv[vid], jv[vid])
        ts = tstore.SubTokStore(jax_corpus["sub"], max_clip_len=mcl)
        js = jstore.SubTokStore(jax_corpus["sub"], max_clip_len=mcl)
        for attr in ("id2len", "vid_sub2frame", "vid2vonly_frames",
                     "vid2dur", "vid2idx", "vid2sub_lens", "vid2max_len",
                     "meta", "cls_", "sep", "pad", "bos", "eos", "mask",
                     "v_range"):
            assert getattr(ts, attr) == getattr(js, attr), attr
    for cls in ("TxtTokStore", "QueryTokStore", "MsrvttQueryTokStore"):
        t = getattr(tstore, cls)(jax_corpus["query"], max_txt_len=6)
        j = getattr(jstore, cls)(jax_corpus["query"], max_txt_len=6)
        for attr in ("id2len", "query2video", "video2query", "query_data"):
            assert getattr(t, attr, None) == getattr(j, attr, None), attr
        for k in j.id2len:
            _same(t[k], j[k])
    shards = [jax_corpus["vfeat"], jax_corpus["vfeat"]]
    ts = tstore.ShardedVideoFeatStore(shards, max_clip_len=10)
    js = jstore.ShardedVideoFeatStore(shards, max_clip_len=10)
    assert ts.name2nframe == js.name2nframe
    for vid in js.name2nframe:
        assert vid in ts
        _same(ts[vid], js[vid])


def test_native_lz4_and_gather_match_jax(jax_corpus):
    from hero_tpu.native import herostore as jnative
    if not (tnative.available() and jnative.available()):
        pytest.fail("g++ could not build the native libraries")
    r = np.random.RandomState(0)
    for data in (b"", b"a", bytes(r.randint(0, 4, 5000).astype(np.uint8)),
                 b"abcd" * 3000, r.bytes(70000)):
        comp = tnative.lz4_compress(data)
        assert comp == jnative.lz4_compress(data)
        assert tnative.lz4_decompress(comp, len(data)) == data
    assert len(tnative.lz4_compress(b"\0" * 100000)) < 1000
    store = tstore.HeroStore(jax_corpus["vfeat"])
    offs = [store._index[k][0] for k in store.keys()]
    lens = [store._index[k][1] for k in store.keys()]
    buf, starts = tnative.read_many(store._handle, offs, lens)
    handle = jnative.open(os.path.join(jax_corpus["vfeat"], "data.bin"))
    jbuf, jstarts = jnative.read_many(handle, offs, lens)
    assert buf == jbuf and starts.tolist() == jstarts.tolist()
    store.close()


def test_native_build_is_portable_and_checks_provenance(tmp_path,
                                                        monkeypatch):
    """The library builds with portable flags into the port's own
    directory (``native/build``, git-ignored), named by source hash and
    machine; a sidecar that does not match (another compiler or flags)
    is rebuilt, never loaded."""
    assert tnative._BUILD_DIR == os.path.join(
        os.path.dirname(tnative.__file__), "build")
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", "hero_tpu_torch/native/build/x.so"],
        cwd=REPO, timeout=30)
    assert ignored.returncode == 0
    assert "-march=native" not in tnative._CFLAGS
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path))
    tnative._reset_for_tests()
    try:
        assert tnative.available()
        prov = tnative._provenance()
        lib = tnative._lib_path(prov)
        assert os.path.dirname(lib) == str(tmp_path)
        with open(lib + ".json") as f:
            assert json.load(f) == prov
        stale = dict(prov, compiler="g++0.0")
        with open(lib + ".json", "w") as f:
            json.dump(stale, f)
        before = os.stat(lib).st_mtime_ns
        tnative._reset_for_tests()
        assert tnative.available()
        with open(lib + ".json") as f:
            assert json.load(f) == prov
        assert os.stat(lib).st_mtime_ns != before
    finally:
        monkeypatch.undo()
        tnative._reset_for_tests()


# ---------------------------------------------------------------------------
# the inverse bridge and the checkpoint files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def template():
    return init_flat_params(tiny_hero_config(), seed=3)


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


def test_inverse_bridge_is_exact_both_ways(template):
    """``to_jax_params(load_jax_params(f), f) == f`` on every key, and
    ``load_jax_params(to_jax_params(p, t)) == p`` for any tree ``p``; the
    poolers come from the template, their moments are zero."""
    _assert_flat_equal(from_jax.to_jax_params(
        from_jax.load_jax_params(template, device="cpu"), template),
        template)
    other = _random_like(template, 1)
    p = from_jax.load_jax_params(other, device="cpu")
    back = from_jax.to_jax_params(p, template)
    _assert_flat_equal(back, other, skip=POOLERS)
    for k in POOLERS:
        np.testing.assert_array_equal(back[k], template[k])
    _assert_trees_equal(from_jax.load_jax_params(back, device="cpu"), p)
    mu, nu = _random_like(template, 2), _random_like(template, 3, True)
    state = from_jax.load_jax_train_state(other, mu, nu, 7, 7, device="cpu")
    fp, fm, fn, step = from_jax.to_jax_train_state(state, template)
    assert step == 7
    _assert_flat_equal(fp, back)
    _assert_flat_equal(fm, mu, skip=POOLERS)
    _assert_flat_equal(fn, nu, skip=POOLERS)
    for k in POOLERS:
        assert not fm[k].any() and not fn[k].any()
    with pytest.raises(KeyError, match="template"):
        from_jax.to_jax_params(p, {**template, "v_encoder/extra": np.ones(1)})


def _jax_state(flat, mu, nu, step):
    from hero_tpu.training.optim import AdamWState
    from hero_tpu.training.step import TrainState as JState
    un = jsave.unflatten_tree
    return JState(params=un(flat), opt=AdamWState(step=step, mu=un(mu),
                                                  nu=un(nu)),
                  global_step=step)


HPS = {"num_train_steps": 10, "learning_rate": 1e-3}


def test_jax_restore_file_restores_in_the_port(tmp_path, template):
    """A JAX ``TrainingRestorer.save`` of a numpy state restores in the
    port equal to ``load_jax_train_state`` of the same trees; an
    unreadable ``restore.npz`` falls back to the backup; changed hps
    refuse to resume."""
    mu, nu = _random_like(template, 4), _random_like(template, 5, True)
    jr = jsave.TrainingRestorer(str(tmp_path), HPS)
    jr.save(_jax_state(template, mu, nu, 7), global_step=7)
    other = _random_like(template, 6)
    jr.save(_jax_state(other, mu, nu, 8), global_step=8)
    tr = tsave.TrainingRestorer(str(tmp_path), HPS)
    assert tr.can_restore()
    state = tr.restore("cpu")
    want = from_jax.load_jax_train_state(other, mu, nu, 8, 8, device="cpu")
    assert (state.global_step, state.opt.step, tr.global_step) == (8, 8, 8)
    for got_t, want_t in ((state.params, want.params),
                          (state.opt.mu, want.opt.mu),
                          (state.opt.nu, want.opt.nu)):
        _assert_trees_equal(got_t, want_t)
    _assert_flat_equal(tr.template, other)
    with open(tr.save_path, "r+b") as f:         # a write cut short
        f.truncate(100)
    assert tsave.TrainingRestorer(str(tmp_path), HPS).restore(
        "cpu").global_step == 7
    with pytest.raises(ValueError, match="hps changed"):
        tsave.TrainingRestorer(str(tmp_path), dict(HPS, learning_rate=1.0))


def test_port_checkpoints_read_by_jax(tmp_path, template):
    """The port's ``model_step_N.npz`` (with the vocab-pad marker) and
    ``restore.npz``, written through the checkpoint thread, read in the
    JAX package as the inverse bridge's trees: the poolers are the
    template's, with zero moments."""
    other = _random_like(template, 7)
    mu, nu = _random_like(template, 8), _random_like(template, 9, True)
    state = from_jax.load_jax_train_state(other, mu, nu, 5, 5, device="cpu")
    writer = tsave.AsyncCheckpointWriter()
    saver = tsave.ModelSaver(str(tmp_path / "ckpt"), template,
                             vocab_padded=True, writer=writer)
    restorer = tsave.TrainingRestorer(str(tmp_path), HPS, template,
                                      writer=writer)
    path = saver.save(state.params, 5)
    restorer.step(state, save_steps=5)
    writer.close()
    want_p, want_mu, want_nu, _ = from_jax.to_jax_train_state(state,
                                                              template)
    _assert_flat_equal(jsave.flatten_tree(jsave.load_params(path)), want_p)
    assert jsave.checkpoint_vocab_padded(path) is True
    assert tsave.checkpoint_vocab_padded(path) is True
    assert [r["step"] for r in saver.records] == [5]
    assert saver.records[0]["bytes"] == os.path.getsize(path)
    assert restorer.saved_step == 5 and restorer.records[0]["write_ms"] > 0
    jstate = jsave.TrainingRestorer(str(tmp_path), HPS).restore(None)
    assert int(jstate.global_step) == 5 == int(jstate.opt.step)
    _assert_flat_equal(jsave.flatten_tree(jstate.params), want_p)
    _assert_flat_equal(jsave.flatten_tree(jstate.opt.mu), want_mu)
    _assert_flat_equal(jsave.flatten_tree(jstate.opt.nu), want_nu)
    for k in POOLERS:
        np.testing.assert_array_equal(want_p[k], template[k])
        assert not want_mu[k].any() and not want_nu[k].any()


def test_async_writer_raises_a_failed_write():
    writer = tsave.AsyncCheckpointWriter()

    def fail():
        raise OSError("disk full")

    writer.submit(fail)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        writer.flush()
    writer.close()


def test_checkpoint_overlay_and_pt_checkpoints(tmp_path, template):
    """``load_checkpoint_into``: an ``.npz`` overlays the init key by key
    (a wrong shape keeps the init), its marker reaches ``info``; a
    reference ``.pt`` raises, naming ROADMAP A4."""
    ckpt = dict(_random_like(template, 10))
    bad = "v_encoder/mask_embedding"
    ckpt[bad] = np.ones((1, 1), np.float32)
    ckpt["__vocab_padded__"] = np.asarray(False)
    path = str(tmp_path / "init.npz")
    np.savez(path, **ckpt)
    info = {}
    got = tcommon.load_checkpoint_into(template, path, info=info)
    assert info == {"vocab_padded": False}
    _assert_flat_equal(got, {k: (template[k] if k == bad else ckpt[k])
                             for k in template})
    jinfo = {}
    from hero_tpu.drivers import common as jcommon
    jgot = jcommon.load_checkpoint_into(jsave.unflatten_tree(template), path,
                                        info=jinfo)
    assert jinfo == info
    _assert_flat_equal(got, {k: np.asarray(v) for k, v in
                             jsave.flatten_tree(jgot).items()})
    with pytest.raises(NotImplementedError, match="A4"):
        tcommon.load_checkpoint_into(template, str(tmp_path / "x.pt"))


# ---------------------------------------------------------------------------
# build_targets and main
# ---------------------------------------------------------------------------

def _write_shards(corpus, root):
    """The corpus' features split over two shard stores."""
    src = jstore.VideoFeatStore(corpus["vfeat"])
    vids = list(src.name2nframe)
    dirs = []
    for i, part in enumerate((vids[:3], vids[3:])):
        d = os.path.join(root, f"shard{i}")
        with tstore.HeroStoreWriter(d) as w:
            for vid in part:
                w.put(vid, src[vid])
        with open(os.path.join(d, "id2nframe.json"), "w") as f:
            json.dump({v: src.name2nframe[v] for v in part}, f)
        dirs.append(d)
    return dirs


@pytest.mark.parametrize("multi", [False, True])
def test_build_targets_matches_jax(jax_corpus, tmp_path, multi):
    """Single target from ``sub_txt_db``/``vfeat_db``, or two targets (one
    with ``vfeat_shards``, its own tasks and a target ratio): the same
    names, ratios and items as the JAX ``build_targets``."""
    from hero_tpu.drivers import pretrain as jdrv
    opts = types.SimpleNamespace(
        max_clip_len=MAX_FRAMES, max_txt_len=12, vfeat_interval=1.5,
        sub_ctx_len=1, pack_subs=multi, vfeat_dim=64, bucket_n_subs=4,
        bucket_txt_len=24, bucket_frames_per_sub=12, query_per_video=2,
        bucket_query_len=16, bucket_max_masked=4, mask_prob=0.15)
    if multi:
        opts.targets = [
            {"name": "a", "sub_txt_db": jax_corpus["sub"],
             "vfeat_db": jax_corpus["vfeat"], "tasks": {"mlm": 2, "vsm": 1}},
            {"name": "b", "sub_txt_db": jax_corpus["sub"],
             "vfeat_shards": _write_shards(jax_corpus, str(tmp_path)),
             "vfeat_interval": 2.0}]
        opts.targets_ratio = [1, 3]
    else:
        opts.sub_txt_db, opts.vfeat_db = jax_corpus["sub"], jax_corpus["vfeat"]
    got, got_r = tdrv.build_targets(opts)
    want, want_r = jdrv.build_targets(opts)
    assert got_r == want_r and list(got) == list(want)
    if multi:
        assert got_r == {"mlm@a": 2, "vsm@a": 1, "mlm@b": 6,
                         "mfm-nce@b": 6, "fom@b": 3, "vsm@b": 6}
        assert got["b"].img_db.frame_interval == 2.0
    for name in want:
        assert got[name].vids == want[name].vids
        for vid in want[name].vids:
            g, w = got[name].video_item(vid), want[name].video_item(vid)
            assert list(g) == list(w)
            for k in w:
                _same(g[k], w[k])


def _model_json(root):
    path = os.path.join(root, "model.json")
    with open(path, "w") as f:
        json.dump(tiny_hero_config(max_clip_len=MAX_FRAMES).to_dict(), f)
    return path


def _main_config(root, corpus, ckpt, name):
    cfg = dict(
        targets=[{"name": "tv", "sub_txt_db": corpus["sub"],
                  "vfeat_db": corpus["vfeat"],
                  "tasks": {"mlm": 2, "mfm-nce": 2, "fom": 1, "vsm": 2}}],
        targets_ratio=[1], model_config=_model_json(root), checkpoint=ckpt,
        output_dir=os.path.join(root, name), max_clip_len=MAX_FRAMES,
        max_txt_len=12, vfeat_interval=1.5, vfeat_dim=64, pack_subs=True,
        bucket_n_subs=2, train_batch_size=2, val_batch_size=2,
        n_val_batches=1,
        gradient_accumulation_steps=2, learning_rate=1e-3, valid_steps=3,
        save_steps=4, num_train_steps=6, warmup_steps=2, grad_norm=1.0,
        sub_ctx_len=0, seed=11, query_per_video=2, bucket_query_len=16,
        lw_neg_q=1.0, lw_neg_ctx=1.0, lw_st_ed=0.01, drop_svmr_prob=0.5,
        hard_pool_size=[2], hard_neg_weights=[10],
        hard_negtiave_start_step=[4], train_span_start_step=0,
        profile_step=1)
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


# run in a fresh interpreter: main on the CPU with SIGTERM sent after step
# 3 (signal handlers need the main thread, which a test worker may not be)
_INTERRUPTED = """
import os, signal, sys, threading
sys.modules["torch.utils.tensorboard"] = None
from hero_tpu_torch.config import opts
from hero_tpu_torch.drivers import pretrain

def on_step(step, task, metrics):
    if step == 3:
        os.kill(os.getpid(), signal.SIGTERM)

state = pretrain.main(opts.get_pretrain_args(["--config", sys.argv[1]]),
                      device="cpu", on_step=on_step)
assert state.global_step == 3, state.global_step
assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
# the prefetch and checkpoint threads ended with the run
assert threading.active_count() == 1, threading.enumerate()
"""


@pytest.fixture(scope="module")
def main_runs(tmp_path_factory):
    """The port's corpus; a JAX-written init checkpoint (another seed, a
    vocab-pad marker); run A, ``main`` uninterrupted for 6 steps; run B,
    the same config stopped by SIGTERM after step 3 in a subprocess, then
    resumed to step 6 here.  TensorBoard is kept out (JSONL scalars)."""
    root = str(tmp_path_factory.mktemp("main"))
    corpus = ttesting.build_synthetic_corpus(root, n_videos=6,
                                             max_frames=MAX_FRAMES,
                                             vfeat_dim=64)
    init = init_flat_params(tiny_hero_config(max_clip_len=MAX_FRAMES),
                            seed=5)
    ckpt_dir = os.path.join(root, "init")
    path = jsave.ModelSaver(ckpt_dir, vocab_padded=False).save(
        jsave.unflatten_tree(init), 0)
    cfg_a = _main_config(root, corpus, path, "a")
    cfg_b = _main_config(root, corpus, path, "b")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        handler = signal.getsignal(signal.SIGTERM)
        state_a = tdrv.main(topts.get_pretrain_args(["--config", cfg_a]),
                            device="cpu")
        assert signal.getsignal(signal.SIGTERM) is handler
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        out = subprocess.run([sys.executable, "-c", _INTERRUPTED, cfg_b],
                             cwd=root, env=env, capture_output=True,
                             text=True, timeout=240)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        with np.load(os.path.join(root, "b", "restore.npz")) as z:
            interrupted_step = int(z["__step__"])
        state_b = tdrv.main(topts.get_pretrain_args(["--config", cfg_b]),
                            device="cpu")
    return types.SimpleNamespace(root=root, init=init, init_path=path,
                                 cfg_a=cfg_a, state_a=state_a,
                                 state_b=state_b,
                                 interrupted_step=interrupted_step)


def _load_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_main_resumed_after_sigterm_equals_the_uninterrupted_run(main_runs):
    """Twin of tests/test_resume_equivalence.py: SIGTERM after step 3
    leaves ``restore.npz`` at step 3 and the step-3 model; the resumed run
    ends with the uninterrupted run's checkpoint, bit for bit, and the
    file bridged back is the run's final state, bit for bit."""
    r = main_runs
    assert r.interrupted_step == 3
    assert r.state_a.global_step == r.state_b.global_step == 6
    a = _load_npz(os.path.join(r.root, "a", "ckpt", "model_step_6.npz"))
    b = _load_npz(os.path.join(r.root, "b", "ckpt", "model_step_6.npz"))
    _assert_flat_equal(b, a)
    assert sorted(os.listdir(os.path.join(r.root, "b", "ckpt"))) == [
        "model_step_3.npz", "model_step_6.npz"]
    a.pop("__vocab_padded__")
    _assert_trees_equal(from_jax.load_jax_params(a, device="cpu"),
                        r.state_a.params)
    _assert_trees_equal(r.state_b.params, r.state_a.params)
    _assert_trees_equal(r.state_b.opt.nu, r.state_a.opt.nu)
    rec = json.loads(pathlib.Path(r.root, "b", "log",
                                  "checkpoints.json").read_text())
    assert rec["restore_ms"] > 0
    assert [x["step"] for x in rec["restore"]] == [4]
    assert [x["step"] for x in rec["model"]] == [6]
    scalars = pathlib.Path(r.root, "a", "log", "scalars.jsonl")
    assert scalars.exists()
    # profile_step 1: a torch.profiler trace of the second step
    trace = pathlib.Path(r.root, "a", "trace", "step_2.json")
    assert "traceEvents" in trace.read_text()


def test_main_loads_the_checkpoint_and_writes_jax_files(main_runs):
    """Run A started from the JAX-written checkpoint (the init at another
    seed): ``init_params`` is the checkpoint's tree; its model and restore
    files read in the JAX package, with the pad marker threaded through
    and the poolers of the checkpoint; the hps and the git record are
    the JAX package's schema."""
    r = main_runs
    opts = topts.get_pretrain_args(["--config", r.cfg_a])
    cfg = tcommon.model_config_from_opts(opts)
    info = {}
    _assert_flat_equal(tdrv.init_params(opts, cfg,
                                        tcommon.vsm_config_from_opts(opts),
                                        info=info), r.init)
    assert info == {"vocab_padded": False}
    path = os.path.join(r.root, "a", "ckpt", "model_step_6.npz")
    assert jsave.checkpoint_vocab_padded(path) is False
    got = jsave.flatten_tree(jsave.load_params(path))
    for k in POOLERS:
        np.testing.assert_array_equal(got[k], r.init[k])
    jstate = jsave.TrainingRestorer(
        os.path.join(r.root, "a"),
        {"num_train_steps": 6, "learning_rate": 1e-3}).restore(None)
    assert int(jstate.global_step) == 4
    hps = json.loads(pathlib.Path(r.root, "a", "log",
                                  "hps.json").read_text())
    assert hps == vars(opts)
    log = pathlib.Path(r.root, "a", "log")
    assert (log / "git_info.json").exists() or (log / "code.zip").exists()
    assert "training done at step 6" in (log / "log.txt").read_text()


def test_main_equals_run_pretrain(main_runs):
    """``main`` is ``run_pretrain`` over ``build_targets``' datasets from
    ``init_params``, plus files: the same final state, bit for bit."""
    opts = topts.get_pretrain_args(["--config", main_runs.cfg_a])
    opts.output_dir = None
    dbs, ratios = tdrv.build_targets(opts)
    state = tdrv.run_pretrain(opts, dbs, ratios, device="cpu")
    assert isinstance(state, TrainState) and state.global_step == 6
    _assert_trees_equal(state.params, main_runs.state_a.params)
    _assert_trees_equal(state.opt.mu, main_runs.state_a.opt.mu)


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdrv.main(types.SimpleNamespace(seed=0))
