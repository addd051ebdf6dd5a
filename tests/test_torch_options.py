"""The options the port gained to match the JAX package, each held to its
JAX counterpart on the CPU in fp32 at tiny widths: the four
``hidden_act`` activations (an encoder layer, a decoder layer and the LM
head, outputs and every gradient), the poolers, RoBERTa position ids,
the cross-mode span logits, ``make_zipfile``'s keywords, the bucket
shapes, the logger's members.  Weights are numpy-seeded and bridged by
``convert/from_jax``'s tree functions.
"""

import dataclasses
import json
import os
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config import shapes as jshapes
from hero_tpu.config.model_config import tiny_hero_config as jax_tiny_config
from hero_tpu.models import embed as jembed
from hero_tpu.models import encoder as jenc
from hero_tpu.models import pretrain as jpre
from hero_tpu.models import transformer as jtrm
from hero_tpu.training.save import flatten_tree, unflatten_tree
from hero_tpu.utils import basic_utils as jbasic
from hero_tpu.utils import logger as jlogger
import hero_tpu_torch.config as tconfig
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert import from_jax
from hero_tpu_torch.models import embed as tembed
from hero_tpu_torch.models import encoder as tenc
from hero_tpu_torch.models import nn as tnn
from hero_tpu_torch.models import pretrain as tpre
from hero_tpu_torch.models import transformer as ttrm
from hero_tpu_torch.training import optim as toptim
from hero_tpu_torch.utils import basic_utils as tbasic
from hero_tpu_torch.utils import logger as tlogger

ACTS = ["gelu", "relu", "swish", "gelu_new"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _numpy_like(tree, seed):
    """Numpy-seeded fp32 leaves of ``tree``'s flat shapes: N(0, 0.2)
    weights, LayerNorm scales about 1."""
    r = np.random.RandomState(seed)
    out = {}
    for k, v in flatten_tree(jax.device_get(tree)).items():
        x = (0.2 * r.randn(*v.shape)).astype(np.float32)
        out[k] = x + 1.0 if k.endswith("/scale") else x
    return out


def _getter(flat):
    return lambda k: _t(flat[k])


def _port_layer(flat):
    get = _getter(flat)
    return {"attention": from_jax._attention(get, "attention"),
            "ffn": from_jax._ffn(get, "ffn")}


def _port_decoder(flat):
    get = _getter(flat)
    return from_jax._layers({
        "self_attention": from_jax._attention(get, "layers/self_attention"),
        "cross_attention": from_jax._attention(get,
                                               "layers/cross_attention"),
        "ffn": from_jax._ffn(get, "layers/ffn")})


def _port_lm_head(flat):
    get = _getter(flat)
    return {"dense": from_jax._linear(get, "dense"),
            "ln": from_jax._ln(get, "ln"), "bias": get("bias")}


def _port_grads(fn, tree, *inputs):
    """(output, [d sum(out * w) / d leaf of tree], [d / d input])."""
    leaves = [p.clone().requires_grad_(True)
              for p in toptim.tree_leaves(tree)]
    xs = [x.clone().requires_grad_(True) for x in inputs]
    out = fn(toptim.tree_unflatten(tree, leaves), *xs)
    w = _t(np.random.RandomState(5).randn(*out.shape).astype(np.float32))
    grads = torch.autograd.grad((out * w).sum(), leaves + xs)
    return out.detach(), grads[:len(leaves)], grads[len(leaves):]


def _jax_grads(fn, params, *inputs):
    out = fn(params, *inputs)
    w = jnp.asarray(np.random.RandomState(5).randn(*out.shape)
                    .astype(np.float32))
    gp, *gx = jax.grad(lambda p, *x: jnp.sum(fn(p, *x) * w),
                       argnums=tuple(range(1 + len(inputs))))(params, *inputs)
    return np.asarray(out), flatten_tree(jax.device_get(gp)), gx


def _assert_close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


def _check(jfn, tfn, jparams, port_of, inputs, atol=1e-5):
    """Outputs and every gradient (parameters through ``port_of``, the
    bridge's tree function, and inputs) of the JAX and port functions."""
    want, jgp, jgx = _jax_grads(jfn, jparams, *map(jnp.asarray, inputs))
    tree = port_of(flatten_tree(jax.device_get(jparams)))
    got, tgp, tgx = _port_grads(tfn, tree, *map(_t, inputs))
    _assert_close(got, want, atol, "output")
    paths = toptim.tree_paths(tree)
    for path, g, w in zip(paths, tgp, toptim.tree_leaves(port_of(jgp))):
        _assert_close(g, w, atol, "/".join(path))
    for i, (g, w) in enumerate(zip(tgx, jgx)):
        _assert_close(g, w, atol, f"input {i}")
    return got


def _configs(act):
    jc = jax_tiny_config().f_config.replace(
        hidden_act=act, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    tc = tiny_hero_config().f_config.replace(
        hidden_act=act, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    return jc, tc


def test_activations_match_jax():
    """``nn.ACT2FN`` elementwise against JAX's, and ``gelu_new`` is the
    tanh form, not the erf one."""
    from hero_tpu.models import nn as jnn
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    assert set(tnn.ACT2FN) == set(jnn.ACT2FN)
    for name in ACTS:
        _assert_close(tnn.ACT2FN[name](_t(x)), jnn.ACT2FN[name](
            jnp.asarray(x)), 1e-6, name)
    assert not torch.equal(tnn.gelu_new(_t(x)), tnn.gelu(_t(x)))


@pytest.mark.parametrize("act", ACTS)
def test_hidden_act_layers_match_jax(act):
    """An encoder layer (with pad keys), the decoder (causal
    self-attention, cross-attention, FFN) and the tied LM head under
    ``hidden_act``: outputs and every gradient within 1e-5."""
    jc, tc = _configs(act)
    D = jc.hidden_size
    r = np.random.RandomState(7)
    x = r.randn(2, 6, D).astype(np.float32)
    mask = (np.arange(6)[None] < np.array([[6], [4]])).astype(np.float32)
    layer = unflatten_tree(_numpy_like(jtrm.init_encoder_layer(
        jax.random.PRNGKey(1), jc), 11))
    _check(lambda p, x: jtrm.encoder_layer(p, x, jnp.asarray(mask), jc),
           lambda p, x: ttrm.encoder_layer(p, x, tc, kv_mask=_t(mask)),
           layer, _port_layer, [x])
    enc = r.randn(2, 5, D).astype(np.float32)
    enc_mask = (np.arange(5)[None] < np.array([[5], [2]])).astype(np.float32)
    jd = jc.replace(num_hidden_layers=1)
    dec = unflatten_tree(_numpy_like(jtrm.init_decoder(
        jax.random.PRNGKey(2), jd), 12))
    _check(lambda p, x, e: jtrm.decoder(p, x, e, jnp.asarray(enc_mask), jd),
           lambda p, x, e: ttrm.decoder(p, x, e, _t(enc_mask), tc),
           dec, _port_decoder, [x, enc])
    head = unflatten_tree(_numpy_like(jtrm.init_lm_head(
        jax.random.PRNGKey(3), jc, 40), 13))
    word_emb = (0.2 * r.randn(40, D)).astype(np.float32)
    _check(lambda p, x, e: jtrm.lm_head(p, e, x, jc),
           lambda p, x, e: ttrm.lm_head(p, e, x, tc),
           head, _port_lm_head, [x, word_emb])


@pytest.fixture(scope="module")
def backbone():
    flat = tpre.init_flat_params(tiny_hero_config(), seed=4)
    params = from_jax.load_jax_params(flat, device="cpu")
    return jax.tree.map(jnp.asarray, unflatten_tree(flat)), params


def test_poolers_match_jax(backbone):
    """``transformer.pooler``, ``encoder.cross_modal_pooled`` and
    ``temporal_trm(pool=True, position_ids=)`` (and its unpooled output
    at those positions) within 1e-6 of JAX's."""
    jp, tp = backbone
    jv, tv = jp["v_encoder"], tp["v_encoder"]
    jc, tc = jax_tiny_config(), tiny_hero_config()
    r = np.random.RandomState(8)
    D = jc.f_config.hidden_size
    seq = r.randn(3, 5, D).astype(np.float32)
    _assert_close(ttrm.pooler(tv["f_encoder"]["pooler"], _t(seq)),
                  jtrm.pooler(jv["f_encoder"]["pooler"], jnp.asarray(seq)),
                  1e-6, "pooler")
    _assert_close(tenc.cross_modal_pooled(tv["f_encoder"], _t(seq)),
                  jenc.cross_modal_pooled(jv["f_encoder"], jnp.asarray(seq)),
                  1e-6, "cross_modal_pooled")
    Dc = jc.c_config.hidden_size
    frames = r.randn(2, 7, Dc).astype(np.float32)
    mask = (np.arange(7)[None] < np.array([[7], [5]])).astype(np.float32)
    pos = np.stack([np.arange(7) + 2, np.arange(7)]).astype(np.int32)
    for pool in (True, False):
        want = jenc.temporal_trm(jv["c_encoder"], jc.c_config,
                                 jnp.asarray(frames), jnp.asarray(mask),
                                 position_ids=jnp.asarray(pos), pool=pool)
        got = tenc.temporal_trm(tv["c_encoder"], tc.c_config, _t(frames),
                                _t(mask), position_ids=_t(pos), pool=pool)
        assert got.shape == want.shape == ((2, Dc) if pool else (2, 7, Dc))
        _assert_close(got, want, 1e-6, f"temporal_trm pool={pool}")


def test_roberta_position_ids_and_cross_span_logits_match_jax(backbone):
    """``embed.roberta_position_ids`` equal to JAX's, and
    ``get_st_ed_logits(cross=True)`` (every query against every video)
    within 1e-5."""
    ids = np.array([[0, 5, 1, 7, 1, 1], [3, 4, 5, 6, 7, 8]], np.int32)
    np.testing.assert_array_equal(
        tembed.roberta_position_ids(_t(ids)).numpy(),
        np.asarray(jembed.roberta_position_ids(jnp.asarray(ids))))
    jp, tp = backbone
    D = jax_tiny_config().c_config.hidden_size
    r = np.random.RandomState(9)
    q = r.randn(4, D).astype(np.float32)
    frames = r.randn(3, 6, D).astype(np.float32)
    mask = (np.arange(6)[None] < np.array([[6], [3], [5]])).astype(
        np.float32)
    want = jpre.get_st_ed_logits(jp["head"], *map(jnp.asarray,
                                                  (q, frames, mask)),
                                 cross=True)
    got = tpre.get_st_ed_logits(tp["head"], *map(_t, (q, frames, mask)),
                                cross=True)
    for g, w in zip(got, want):
        assert g.shape == (4, 3, 6)
        _assert_close(g, w, 1e-5, "st/ed")


def test_make_zipfile_members_match_jax(tmp_path):
    """The same member names as the JAX package's, with and without
    ``enclosing_dir``, ``exclude_dirs``, ``exclude_extensions`` and
    ``exclude_dirs_substring``."""
    src = tmp_path / "src"
    for f in ("a.py", "b.txt", "sub/c.py", "sub/deep/d.json", "build/e.py",
              "__pycache__/f.pyc", "skipme/g.py", "skipme/inner/h.py"):
        (src / f).parent.mkdir(parents=True, exist_ok=True)
        (src / f).write_text(f)
    for kw in ({}, dict(enclosing_dir="code", exclude_dirs=("build",),
                        exclude_extensions=(".pyc", ".txt"),
                        exclude_dirs_substring="skipme")):
        names = []
        for i, fn in enumerate((jbasic.make_zipfile, tbasic.make_zipfile)):
            out = str(tmp_path / f"{i}.zip")
            fn(str(src), out, **kw)
            with zipfile.ZipFile(out) as z:
                names.append(z.namelist())
        assert names[1] == names[0], kw
        assert any(n.endswith("a.py") for n in names[1])
    assert "code/sub/c.py" in names[1]
    assert not any(n.endswith((".txt", ".pyc", "e.py", "g.py", "h.py"))
                   for n in names[1])


def test_bucket_shapes_match_jax():
    """``config/shapes``: ``BucketShape`` field for field (the default, the
    tiny bucket and a replaced one, with the derived sizes),
    ``round_up``, and the package's exports."""
    for j, t in ((jshapes.BucketShape(), tconfig.BucketShape()),
                 (jshapes.tiny_bucket(), tconfig.tiny_bucket()),
                 (jshapes.tiny_bucket().replace(n_videos=5, sub_len=12),
                  tconfig.tiny_bucket().replace(n_videos=5, sub_len=12))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.n_subs, t.f_seq_len, t.n_queries) == (
            j.n_subs, j.f_seq_len, j.n_queries)
    for x, m in ((0, 8), (1, 8), (8, 8), (9, 8), (100, 64), (5, 1)):
        assert tconfig.round_up(x, m) == jshapes.round_up(x, m)
    from hero_tpu import config as jconfig
    assert set(jconfig.__all__) <= set(tconfig.__all__)


def test_logger_members_match_jax(tmp_path, monkeypatch):
    """``RunningMeter``'s ``name`` and ``val``, and
    ``ScalarWriter.set_step``: the same ``scalars.jsonl`` lines as the
    JAX package's writer."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    meters = [m.RunningMeter("loss/mlm") for m in (jlogger, tlogger)]
    assert meters[1].val == meters[0].val == 0.0
    for v in (1.0, float("nan"), 3.0, float("inf"), 0.5):
        for m in meters:
            m(v)
    j, t = meters
    assert (t.name, t.val) == (j.name, j.val)
    lines = []
    for i, mod in enumerate((jlogger, tlogger)):
        d = str(tmp_path / str(i))
        w = mod.ScalarWriter(d)
        w.add_scalar("first", 1.5)
        w.set_step(7)
        w.add_scalar("a", 2)
        w.log_scalar_dict({"x": 1, "y": 2.5, "s": "skipped"})
        w.log_scalar_dict({"z": 3}, step=9)
        w.close()
        with open(os.path.join(d, "scalars.jsonl")) as f:
            lines.append([json.loads(line) for line in f])
    assert lines[1] == lines[0]
    assert {"step": 7, "y": 2.5} in lines[1]

