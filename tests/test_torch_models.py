"""hero_tpu_torch model stack against the JAX package on the same weights.

The JAX parameters come from ``init_hero_for_pretraining`` on
``tiny_hero_config``, pass through ``flatten_tree`` and the port's bridge
(``convert/from_jax.load_jax_params``), and both packages see the same
numpy batches.  Everything runs in fp32 on the CPU, where the port takes
its plain attention and LayerNorm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config.model_config import tiny_hero_config as jax_tiny_config
from hero_tpu.data import synthetic as jsyn
from hero_tpu.data.occupancy import VideoShape as JaxVideoShape
from hero_tpu.models import model as jmodel
from hero_tpu.models import pretrain as jpre
from hero_tpu.training.save import flatten_tree
from hero_tpu_torch.config.model_config import tiny_hero_config
from hero_tpu_torch.convert.from_jax import load_jax_params
from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
from hero_tpu_torch.models import model as tmodel
from hero_tpu_torch.models import pretrain as tpre

# fp32 on the CPU: the two frameworks sum 32-wide dots, 128-wide FFN
# rows and <= 40-term softmax rows in different orders, and the errors
# pass through 2+1 post-LN layers; outputs are O(1) (LN-scaled), and
# 2e-5 is ~100 fp32 ulps of them
ATOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny_config()
    params = jpre.init_hero_for_pretraining(jax.random.PRNGKey(0), jcfg)
    flat = flatten_tree(jax.device_get(params))
    tparams = load_jax_params(flat, device="cpu")
    return jcfg, tiny_hero_config(), params, tparams


def tiny_videos(seed, n):
    """Small TV-like video shapes that fit ``synthetic.TINY`` packed rows
    (``sample_tv_video`` draws clips of 40-60 frames)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        n_subs = r.randint(2, 6)
        out.append(JaxVideoShape(
            n_frames=int(r.randint(8, 17)),
            sub_txt_lens=[int(x) for x in r.randint(2, 9, n_subs)],
            sub_n_frames=[int(x) for x in r.randint(1, 4, n_subs)]))
    return out


PACKED_TINY = dataclasses.replace(jsyn.TINY, batch=3, n_subs=3, txt_len=12,
                                  frames_per_sub=6)


def _batch(kind):
    if kind == "unpacked":
        return jsyn.base_batch(jsyn.TINY, seed=3)
    b, _ = jsyn.tv_vsm_batch(tiny_videos(4, PACKED_TINY.batch), PACKED_TINY,
                             packed=True, seed=5)
    return {k: v for k, v in b.items() if k.startswith(("sub_", "c_"))}


@pytest.mark.parametrize("kind", ["unpacked", "packed"])
def test_forward_repr_matches_jax(models, kind):
    jcfg, tcfg, params, tparams = models
    batch = _batch(kind)
    if kind == "packed":
        assert {"sub_txt_seg", "sub_txt_pos", "sub_frame_seg",
                "sub_frame_pos"} <= set(batch)
    want = np.asarray(jmodel.forward_repr(params["v_encoder"], jcfg,
                                          batch))
    got = tmodel.forward_repr(tparams["v_encoder"], tcfg,
                              batch_to_device(batch, "cpu")).numpy()
    assert got.shape == want.shape == (batch["c_v_feats"].shape[0],
                                       jcfg.max_clip_len,
                                       jcfg.c_config.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_encode_query_matches_jax(models):
    jcfg, tcfg, params, tparams = models
    r = np.random.RandomState(6)
    ids = r.randint(3, 128, (5, 9)).astype(np.int32)
    lens = r.randint(3, 10, (5,))
    mask = (np.arange(9)[None] < lens[:, None]).astype(np.float32)
    want = np.asarray(jpre.encode_query(params, jcfg, ids, mask))
    got = tpre.encode_query(tparams, tcfg, torch.from_numpy(ids),
                            torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (5, jcfg.q_config.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_corpus_scores_match_jax(models):
    """Video-level cosine scores, the pre-conv span similarity and the
    st/ed convolutions with frame masking, on the same numpy inputs."""
    _, _, params, tparams = models
    r = np.random.RandomState(7)
    mod = r.randn(4, 32).astype(np.float32)
    frames = r.randn(6, 16, 32).astype(np.float32)
    fmask = (np.arange(16)[None] < r.randint(4, 17, (6,))[:, None]
             ).astype(np.float32)
    t = torch.from_numpy
    want = np.asarray(jpre.get_video_level_scores(
        jnp.asarray(mod), jnp.asarray(frames), jnp.asarray(fmask)))
    got = tpre.get_video_level_scores(t(mod), t(frames), t(fmask)).numpy()
    # cosines of unit vectors: |s| <= 1, 32-term dots
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    jsim = jpre.get_st_ed_sim(params["head"], jnp.asarray(mod),
                              jnp.asarray(frames))
    tsim = tpre.get_st_ed_sim(tparams["head"], t(mod), t(frames))
    np.testing.assert_allclose(tsim.numpy(), np.asarray(jsim), atol=1e-5,
                               rtol=1e-6)
    jst, jed = jpre.conv_st_ed_masked(params["head"], jsim,
                                      jnp.asarray(fmask)[None])
    tst, ted = tpre.conv_st_ed_masked(tparams["head"], t(np.array(jsim)),
                                      t(fmask)[None])
    # the five fp32 taps in the same order: equal up to the masked -1e4
    # offset's rounding
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-3,
                               rtol=1e-6)
    np.testing.assert_allclose(ted.numpy(), np.asarray(jed), atol=1e-3,
                               rtol=1e-6)
    valid = np.broadcast_to(fmask[None] > 0, tst.shape)
    np.testing.assert_allclose(tst.numpy()[valid], np.asarray(jst)[valid],
                               atol=1e-6, rtol=0)


def test_conv1d_same_matches_jax():
    r = np.random.RandomState(8)
    x = r.randn(3, 7, 20).astype(np.float32)
    for k in (1, 3, 5):
        kern = r.uniform(-1, 1, (k,)).astype(np.float32)
        want = np.asarray(jpre.conv1d_same(jnp.asarray(kern),
                                           jnp.asarray(x)))
        got = tpre.conv1d_same(torch.from_numpy(kern),
                               torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_packed_rows_equal_one_sub_per_row(models):
    """Sub packing is exact in the port too: a packed f-encoder row gives
    each sub's frame outputs as if the sub had a row of its own."""
    _, tcfg, _, tparams = models
    videos = tiny_videos(9, 2)
    shape_p = dataclasses.replace(PACKED_TINY, batch=2)
    shape_u = dataclasses.replace(shape_p, n_subs=8, txt_len=8,
                                  frames_per_sub=3)
    bp, drop_p = jsyn.tv_vsm_batch(videos, shape_p, packed=True, seed=1)
    bu, drop_u = jsyn.tv_vsm_batch(videos, shape_u, packed=False, seed=1)
    assert drop_p == drop_u == 0.0
    outs = [tmodel.forward_repr(
        tparams["v_encoder"], tcfg,
        batch_to_device({k: v for k, v in b.items()
                         if k.startswith(("sub_", "c_"))}, "cpu"))
        for b in (bp, bu)]
    torch.testing.assert_close(outs[0], outs[1], atol=ATOL, rtol=0)
