"""hero_tpu_torch housekeeping: the weight bridge's key coverage, the numpy
parameter init, the copied numpy modules (batch builders, packing, video
shapes, TVR metrics) against their JAX-package originals bit for bit,
and import hygiene (the port never imports ``jax``, ``hero_tpu`` or ``msgpack``).
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hero_tpu.config.model_config import tiny_hero_config as jax_tiny_config
from hero_tpu.data import occupancy as joccupancy
from hero_tpu.data import packing as jpacking
from hero_tpu.data import synthetic as jsyn
from hero_tpu.evaluation import tvr_metrics as jmetrics
from hero_tpu.models import pretrain as jpre
from hero_tpu.prepro import sub_align as jsub_align
from hero_tpu.training.save import flatten_tree
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert import from_jax
from hero_tpu_torch.data import occupancy as toccupancy
from hero_tpu_torch.data import packing as tpacking
from hero_tpu_torch.data import synthetic as tsyn
from hero_tpu_torch.evaluation import tvr_metrics as tmetrics
from hero_tpu_torch.models.model import without_task_heads
from hero_tpu_torch.models.pretrain import VsmConfig, init_flat_params
from hero_tpu_torch.prepro import sub_align as tsub_align
from hero_tpu_torch.training import optim

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_flat():
    params = jpre.init_hero_for_pretraining(jax.random.PRNGKey(0),
                                            jax_tiny_config())
    return flatten_tree(jax.device_get(params))


# ---------------------------------------------------------------------------
# weight bridge and numpy init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [True, False])
def test_bridge_maps_every_jax_key(jax_flat, heads):
    """Every JAX key is read: with the task heads, the whole pretraining
    tree, the two poolers included; without them (the serving paths)
    every key but the LM head, MFM's mask embeddings and regression head,
    and FOM's head."""
    if heads:
        _, used = from_jax.convert(jax_flat, device="cpu")
        unread = frozenset()
    else:
        _, used = from_jax.convert(
            jax_flat, device="cpu",
            tree=lambda get: from_jax._port_tree(get, heads=False))
        unread = from_jax.TASK_HEAD_JAX_KEYS
    assert not used & unread
    assert used | unread == set(jax_flat)
    assert {k for k in jax_flat if "pooler" in k.split("/")} <= used
    heads_of = {"lm_head", "mask_emb", "mask_embedding", "feat_regress",
                "fom_output"}
    for k in from_jax.TASK_HEAD_JAX_KEYS:
        assert heads_of & set(k.split("/")), k
    p = from_jax.load_jax_params(jax_flat, device="cpu", heads=heads)
    v = p["v_encoder"]
    assert ("fom_output" in v) == ("lm_head" in v["f_encoder"]) == heads
    assert ("mask_emb" in v["f_encoder"]["img_embeddings"]) == heads
    for enc in ("f_encoder", "c_encoder"):
        assert set(v[enc]["pooler"]["dense"]) == {"weight", "bias"}
    if not heads:
        # what the serving paths move to the card
        full = from_jax.load_jax_params(jax_flat, device="cpu")
        assert optim.tree_paths(without_task_heads(full)) == \
            optim.tree_paths(p)


def test_bridge_fails_on_missing_or_unexpected_keys(jax_flat):
    from_jax.load_jax_params(jax_flat, device="cpu")
    missing = dict(jax_flat)
    missing.pop("v_encoder/f_encoder/embeddings/ln/scale")
    with pytest.raises(KeyError, match="missing"):
        from_jax.load_jax_params(missing, device="cpu")
    for heads in (True, False):
        # a task head's key, read or named unused, must be there
        head_missing = dict(jax_flat)
        head_missing.pop("v_encoder/fom_output/ln/bias")
        with pytest.raises(KeyError, match="fom_output"):
            from_jax.load_jax_params(head_missing, device="cpu",
                                     heads=heads)
    pooler_missing = dict(jax_flat)
    pooler_missing.pop("v_encoder/c_encoder/pooler/dense/bias")
    with pytest.raises(KeyError, match="pooler"):
        from_jax.load_jax_params(pooler_missing, device="cpu")
    extra = dict(jax_flat)
    extra["v_encoder/extra/kernel"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        from_jax.load_jax_params(extra, device="cpu")


@pytest.mark.parametrize("heads", [True, False])
def test_bridge_loads_a_jax_pretraining_train_state(jax_flat, heads):
    """A JAX pretraining TrainState (parameters, AdamW moments, counters)
    crosses with its task heads: each head's parameter and moments land
    at their place in the port's layout ((out, in) weights, LayerNorm
    weight/bias); without heads they are dropped with their moments."""
    mu = {k: np.full(v.shape, i + 1, np.float32)
          for i, (k, v) in enumerate(sorted(jax_flat.items()))}
    nu = {k: 2 * v for k, v in mu.items()}
    st = from_jax.load_jax_train_state(jax_flat, mu, nu, 9, 4,
                                       device="cpu", heads=heads)
    assert (st.opt.step, st.global_step) == (9, 4)
    assert optim.tree_paths(st.opt.mu) == optim.tree_paths(st.params) == \
        optim.tree_paths(st.opt.nu)
    v, m = st.params["v_encoder"], st.opt.mu["v_encoder"]
    if not heads:
        assert "lm_head" not in v["f_encoder"] and "fom_output" not in m
        return
    fe = "v_encoder/f_encoder"
    cases = [
        (v["f_encoder"]["lm_head"]["dense"]["weight"],
         m["f_encoder"]["lm_head"]["dense"]["weight"],
         f"{fe}/lm_head/dense/kernel", True),
        (v["f_encoder"]["lm_head"]["bias"], m["f_encoder"]["lm_head"]["bias"],
         f"{fe}/lm_head/bias", False),
        (v["f_encoder"]["img_embeddings"]["mask_emb"],
         m["f_encoder"]["img_embeddings"]["mask_emb"],
         f"{fe}/img_embeddings/mask_emb", False),
        (v["feat_regress"]["dense_2"]["weight"],
         m["feat_regress"]["dense_2"]["weight"],
         "v_encoder/feat_regress/dense_2/kernel", True),
        (v["feat_regress"]["ln"]["weight"], m["feat_regress"]["ln"]["weight"],
         "v_encoder/feat_regress/ln/scale", False),
        (v["mask_embedding"], m["mask_embedding"],
         "v_encoder/mask_embedding", False),
        (v["fom_output"]["linear_1"]["weight"],
         m["fom_output"]["linear_1"]["weight"],
         "v_encoder/fom_output/linear_1/kernel", True),
        (v["fom_output"]["ln"]["bias"], m["fom_output"]["ln"]["bias"],
         "v_encoder/fom_output/ln/bias", False),
        (v["c_encoder"]["pooler"]["dense"]["weight"],
         m["c_encoder"]["pooler"]["dense"]["weight"],
         "v_encoder/c_encoder/pooler/dense/kernel", True)]
    for param, moment, key, transposed in cases:
        want = jax_flat[key].T if transposed else jax_flat[key]
        np.testing.assert_array_equal(param.numpy(), want, err_msg=key)
        assert (moment == mu[key].flat[0]).all(), key
    assert (st.opt.nu["v_encoder"]["mask_embedding"]
            == nu["v_encoder/mask_embedding"].flat[0]).all()


def test_bridge_layout(jax_flat):
    """(in, out) kernels become (out, in) weights; the stacked layers
    become a list; q/k/v fuse in that order."""
    p = from_jax.load_jax_params(jax_flat, device="cpu")
    layers = p["v_encoder"]["f_encoder"]["encoder"]["layers"]
    assert len(layers) == jax_tiny_config().f_config.num_hidden_layers
    key = "v_encoder/f_encoder/encoder/layers/attention"
    qkv = layers[1]["attention"]["qkv"]
    for i, name in enumerate(("query", "key", "value")):
        w = jax_flat[f"{key}/{name}/kernel"][1]
        D = w.shape[0]
        np.testing.assert_array_equal(qkv["weight"][i * D:(i + 1) * D],
                                      w.T)
        np.testing.assert_array_equal(qkv["bias"][i * D:(i + 1) * D],
                                      jax_flat[f"{key}/{name}/bias"][1])


def _other_config(hero_config_cls):
    """A second small shape: other widths, depths and feature size."""
    base = jax_tiny_config().f_config.replace(
        hidden_size=48, num_hidden_layers=3, num_attention_heads=3,
        intermediate_size=96, vocab_size=200, max_position_embeddings=40)
    return hero_config_cls(
        f_config=base, c_config=base.replace(num_hidden_layers=2),
        q_config=base.replace(num_hidden_layers=0, type_vocab_size=1),
        vfeat_dim=40, max_frm_seq_len=12, max_clip_len=12)


def _flat_shapes(tree, prefix=""):
    """{"a/b/c": (shape, dtype)} of a tree of shape structs, keyed as
    ``flatten_tree`` keys it."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shapes(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: (tuple(tree.shape), np.dtype(tree.dtype))}


@pytest.mark.parametrize("which", ["tiny", "other"])
def test_numpy_init_has_the_jax_tree(which):
    """``init_flat_params`` draws the keys, shapes and dtypes of
    ``flatten_tree(init_hero_for_pretraining(...))``, with its
    distributions: normal(0.02) weights and embeddings (padding rows
    zero), zero biases, LayerNorm scale 1, conv taps U(-1/sqrt5, 1/sqrt5).
    """
    if which == "tiny":
        jcfg, cfg = jax_tiny_config(), tiny_hero_config()
    else:
        jcfg = _other_config(type(jax_tiny_config()))
        cfg = tiny_hero_config().from_dict(jcfg.to_dict())
    flat = init_flat_params(cfg, VsmConfig(), seed=0)
    shapes = jax.eval_shape(
        lambda: jpre.init_hero_for_pretraining(jax.random.PRNGKey(1), jcfg))
    assert ({k: (v.shape, v.dtype) for k, v in flat.items()}
            == _flat_shapes(shapes))
    if which != "tiny":
        return
    want = flatten_tree(jax.device_get(jpre.init_hero_for_pretraining(
        jax.random.PRNGKey(1), jcfg)))
    for k, v in flat.items():
        leaf = k.split("/")[-1]
        if k.endswith("predictor/kernel"):
            assert 0 < np.abs(v).max() <= 1.0 / np.sqrt(5), k
        elif leaf == "scale":
            assert (v == 1).all(), k
        elif leaf == "bias" and not (want[k] != 0).any():
            assert (v == 0).all(), k
        elif v.size >= 1024:
            nz = v[v != 0]
            assert abs(nz.std() - 0.02) < 0.002, k
            assert abs(want[k][want[k] != 0].std() - 0.02) < 0.002, k
    word = flat["v_encoder/f_encoder/embeddings/word_emb"]
    assert (word[1] == 0).all() and (word[0] != 0).any()


# ---------------------------------------------------------------------------
# copied numpy modules, bit for bit
# ---------------------------------------------------------------------------

def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 7])
def test_base_batch_copy_is_exact(seed):
    for shape in (jsyn.TINY, jsyn.BatchShape(batch=2, vfeat_dim=96)):
        tshape = tsyn.BatchShape(**dataclasses.asdict(shape))
        _assert_batches_equal(tsyn.base_batch(tshape, seed),
                              jsyn.base_batch(shape, seed))


def test_tv_video_and_packed_batch_copies_are_exact():
    rj, rt = np.random.RandomState(5), np.random.RandomState(5)
    jvideos = [joccupancy.sample_tv_video(rj) for _ in range(6)]
    tvideos = [toccupancy.sample_tv_video(rt) for _ in range(6)]
    assert [dataclasses.astuple(v) for v in tvideos] == \
        [dataclasses.astuple(v) for v in jvideos]
    jshape = dataclasses.replace(jsyn.TV_PACKED, batch=6, vfeat_dim=32)
    tshape = tsyn.BatchShape(**dataclasses.asdict(jshape))
    jb, jdrop = jsyn.tv_vsm_batch(jvideos, jshape, packed=True, seed=9)
    tb, tdrop = tsyn.tv_vsm_batch(tvideos, tshape, seed=9)
    assert tdrop == jdrop
    # every key: the serving keys and the VSM query keys, drawn in the
    # JAX package's batch function's order
    assert {"query_input_ids", "query_attn_masks", "q_mask",
            "targets"} <= set(tb)
    _assert_batches_equal(tb, jb)


def test_pack_subs_and_sub_align_copies_are_exact():
    r = np.random.RandomState(11)
    for _ in range(20):
        lens = [(int(r.randint(1, 40)), int(r.randint(1, 9)))
                for _ in range(r.randint(1, 25))]
        n_rows, txt, fps = int(r.randint(1, 6)), int(r.randint(30, 90)), 16
        assert ([dataclasses.astuple(p) if p else None
                 for p in tpacking.pack_subs(lens, n_rows, txt, fps)]
                == [dataclasses.astuple(p) if p else None
                    for p in jpacking.pack_subs(lens, n_rows, txt, fps)])
    subs = [{"text": "a b", "start": 0.3, "end": 2.9},
            {"text": "c", "start": 2.0, "end": 6.1},
            {"text": "d e f", "start": 9.0, "end": 9.4}]
    for n_frames in (4, 8):
        assert (tsub_align.process_single_vid_sub(subs, 1.5, n_frames)
                == jsub_align.process_single_vid_sub(subs, 1.5, n_frames))


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


def test_tvr_metrics_copy_is_exact():
    r = np.random.RandomState(12)
    x = r.rand(4, 12, 12).astype(np.float32)
    mask_t = tmetrics.generate_min_max_length_mask(x.shape, 2, 6)
    np.testing.assert_array_equal(
        mask_t, jmetrics.generate_min_max_length_mask(x.shape, 2, 6))
    np.testing.assert_array_equal(
        tmetrics.find_max_triples_from_upper_triangle_product(
            x * mask_t, top_n=15),
        jmetrics.find_max_triples_from_upper_triangle_product(
            x * mask_t, top_n=15))
    sub, gt = _random_submission(r, n_q=9, n_videos=5, n_pred=30, L=20)
    for top_n in (10, 100):
        assert (tmetrics.get_submission_top_n(sub, top_n)
                == jmetrics.get_submission_top_n(sub, top_n))
    for use_desc_type in (True, False):
        assert (tmetrics.eval_retrieval(sub, gt, use_desc_type=use_desc_type,
                                        verbose=False)
                == jmetrics.eval_retrieval(sub, gt,
                                           use_desc_type=use_desc_type,
                                           verbose=False))
    for fn in ("post_processing_vcmr_nms", "post_processing_svmr_nms"):
        assert (getattr(tmetrics, fn)(sub["VCMR"], nms_thd=0.5,
                                      max_before_nms=25, max_after_nms=12)
                == getattr(jmetrics, fn)(sub["VCMR"], nms_thd=0.5,
                                         max_before_nms=25,
                                         max_after_nms=12))


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def _port_sources():
    return sorted((REPO / "hero_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_hero_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "hero_tpu", "flax",
                               "msgpack"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, pkgutil, importlib, hero_tpu_torch\n"
            "for m in pkgutil.walk_packages(hero_tpu_torch.__path__, "
            "'hero_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hero_tpu', 'msgpack'))\n"
            "print(len([m for m in sys.modules "
            "if m.startswith('hero_tpu_torch.')]), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20


def test_entry_points_default_to_the_card():
    """Without a card, the default device raises instead of running on
    the CPU (the tests pass device='cpu' explicitly)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from hero_tpu_torch import resolve_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
