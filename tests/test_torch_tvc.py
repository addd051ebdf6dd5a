"""hero_tpu_torch TVC caption serving against the JAX package.

The head-major attention (``multi_head_attention``) and the causal mode of
the packed attention against JAX's plain path and its Pallas kernels in
interpret mode; the decoder, the KV-cached decode step, ``encode``,
``decode``, greedy and beam decoding and ``generate_clip_captions`` on the
same weights (``init_hero_for_tvc`` on ``tiny_hero_config`` through the
TVC bridge) and the same numpy batches; the copied TVC data builders bit
for bit; the bridge's key coverage, the config and the numpy init.
Everything runs in fp32 on the CPU, where the port takes its plain
versions.
"""

import dataclasses
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config.model_config import HeroConfig as JaxHeroConfig
from hero_tpu.config.model_config import tiny_hero_config as jax_tiny_config
from hero_tpu.data import downstream_tasks as jdt
from hero_tpu.data import synthetic as jsyn
from hero_tpu.data.occupancy import VideoShape as JaxVideoShape
from hero_tpu.drivers import inf_tvc as jinf
from hero_tpu.models import transformer as jtrm
from hero_tpu.models import tvc as jtvc
from hero_tpu.ops import attention as jatt
from hero_tpu.training.save import flatten_tree
from hero_tpu_torch.config.model_config import (flagship_tvc_config,
                                                tiny_hero_config)
from hero_tpu_torch.convert import from_jax
from hero_tpu_torch.data import downstream_tasks as tdt
from hero_tpu_torch.data import synthetic as tsyn
from hero_tpu_torch.drivers import inf_tvc as tinf
from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
from hero_tpu_torch.models import transformer as ttrm
from hero_tpu_torch.models import tvc as ttvc
from hero_tpu_torch.ops import attention as tatt
from hero_tpu_torch.ops.dropout import attention_keep_mask

# fp32 on the CPU: the frameworks sum 64-term dots, <= 30-term softmax and
# P.V rows, 32/128-wide projections in other orders, through 2+1 encoder
# and 1 decoder post-LN layers; outputs are O(1), 2e-5 is ~100 fp32 ulps
ATOL = 2e-5
BOS, EOS = 0, 2
REPO = pathlib.Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny_config()
    params = jtvc.init_hero_for_tvc(jax.random.PRNGKey(0), jcfg)
    flat = flatten_tree(jax.device_get(params))
    tparams = from_jax.load_jax_tvc_params(flat, device="cpu")
    return jcfg, tiny_hero_config(), params, tparams, flat


# ---------------------------------------------------------------------------
# attention: head-major, and the causal mode of the packed layout
# ---------------------------------------------------------------------------

MHA_CASES = {  # (Lq, Lk, causal, JAX takes its Pallas kernel)
    "self": (20, 20, False, True),
    "self_causal": (20, 20, True, True),
    "decode_step": (1, 30, False, True),
    "causal_lq_lt_lk": (5, 12, True, False),
}


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_multi_head_attention_matches_jax(case):
    """Port vs JAX's ``mha_reference`` and, where JAX takes it, its Pallas
    kernel in interpret mode (which pads both lengths to 64: every row here
    has a valid key, so padding changes nothing)."""
    Lq, Lk, causal, pallas = MHA_CASES[case]
    B, H, d = 2, 2, 64
    r = np.random.RandomState(40 + Lq)
    q = r.randn(B, H, Lq, d).astype(np.float32)
    k, v = (r.randn(B, H, Lk, d).astype(np.float32) for _ in range(2))
    if case == "decode_step":
        mask = np.broadcast_to(np.arange(Lk) <= 7, (B, Lk))
    else:
        mask = np.arange(Lk)[None] < np.array([[Lk], [Lk - 3]])
    mask = mask.astype(np.float32)
    got = tatt.multi_head_attention(_t(q), _t(k), _t(v), _t(mask),
                                    causal=causal).numpy()
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    want = np.asarray(jatt.mha_reference(jq, jk, jv, jm, causal=causal))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tatt.mha_reference(_t(q), _t(k), _t(v), _t(mask),
                           causal=causal).numpy(), want, atol=ATOL, rtol=0)
    if pallas:
        want_p = np.asarray(jatt.multi_head_attention(
            jq, jk, jv, jm, causal=causal, use_pallas=True))
        np.testing.assert_allclose(got, want_p, atol=ATOL, rtol=0)


def test_multi_head_attention_dropout_is_the_philox_mask():
    """With value rows e_j, out[..., j] is the dropped probability of key
    j: zero exactly where the plain Philox mask drops it, p / (1 - r)
    elsewhere."""
    B, H, Lq, Lk, d = 2, 3, 4, 10, 16
    r = np.random.RandomState(41)
    q, k = (_t(r.randn(B, H, L, d).astype(np.float32)) for L in (Lq, Lk))
    v = torch.eye(Lk, d).expand(B, H, Lk, d)
    seed, rate = 2 ** 40 + 7, 0.3
    out = tatt.multi_head_attention(q, k, v, dropout_rate=rate, seed=seed)
    p = tatt.multi_head_attention(q, k, v)[..., :Lk]
    keep = attention_keep_mask(seed, B, H, Lq, Lk, rate)
    assert torch.equal(out[..., :Lk] != 0, keep)
    torch.testing.assert_close(out[..., :Lk][keep], p[keep] / (1 - rate),
                               atol=1e-6, rtol=1e-6)


def test_multi_head_attention_has_no_backward_yet():
    """The backward (Pallas #5) is ported now: a gradient through the
    head-major attention no longer raises, and equals autograd through
    the plain forward (``tests/test_torch_tvc_train.py`` holds it to
    ``jax.grad``)."""
    q = torch.randn(1, 2, 3, 8, requires_grad=True)
    out = tatt.multi_head_attention(q, q.detach(), q.detach())
    (got,) = torch.autograd.grad(out.sum(), q)
    (want,) = torch.autograd.grad(
        tatt.mha_reference(q, q.detach(), q.detach()).sum(), q)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("Lq, Lk", [(20, 20), (6, 15)])
def test_packed_causal_matches_jax(Lq, Lk):
    """Packed causal attention vs JAX's plain path and, at Lq == Lk (the
    only causal shape JAX sends to its kernel), the Pallas kernel in
    interpret mode."""
    B, H, d = 2, 2, 64
    r = np.random.RandomState(42)
    q = r.randn(B, Lq, H * d).astype(np.float32)
    k, v = (r.randn(B, Lk, H * d).astype(np.float32) for _ in range(2))
    mask = (np.arange(Lk)[None] < np.array([[Lk], [Lk - 4]])).astype(
        np.float32)
    got = tatt.packed_attention(_t(q), _t(k), _t(v), H, kv_mask=_t(mask),
                                causal=True).numpy()
    args = [jnp.asarray(x) for x in (q, k, v)] + [H, jnp.asarray(mask)]
    want = np.asarray(jatt.packed_attention(*args, causal=True,
                                            use_pallas=False))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if Lq == Lk:
        want_p = np.asarray(jatt.packed_attention(*args, causal=True,
                                                  use_pallas=True))
        np.testing.assert_allclose(got, want_p, atol=ATOL, rtol=0)


def test_packed_causal_gradients_come_from_the_causal_probabilities():
    """``PackedAttention`` saves the causal probabilities: its backward
    equals autograd through the plain causal forward."""
    B, L, H, d = 2, 9, 2, 8
    r = np.random.RandomState(43)
    qkv = [_t(r.randn(B, L, H * d).astype(np.float32)).requires_grad_(True)
           for _ in range(3)]
    g = _t(r.randn(B, L, H * d).astype(np.float32))
    got = torch.autograd.grad(
        (tatt.packed_attention(*qkv, H, causal=True) * g).sum(), qkv)
    want = torch.autograd.grad(
        (tatt.packed_reference(*qkv, H, causal=True) * g).sum(), qkv)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="segment"):
        tatt.packed_attention(*qkv, H, causal=True,
                              seg=torch.zeros(B, L, dtype=torch.int32))


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _dec_inputs(seed, N=3, Lt=5, Lv=7, D=32):
    r = np.random.RandomState(seed)
    x = r.randn(N, Lt, D).astype(np.float32)
    enc = r.randn(N, Lv, D).astype(np.float32)
    mask = (np.arange(Lv)[None] < r.randint(1, Lv + 1, (N, 1))).astype(
        np.float32)
    mask[-1] = 0.0                 # a padded clip slot: no valid frame
    return x, enc, mask


def test_decoder_matches_jax(models):
    jcfg, tcfg, params, tparams, _ = models
    x, enc, mask = _dec_inputs(44)
    want = np.asarray(jtrm.decoder(params["decoder"], jnp.asarray(x),
                                   jnp.asarray(enc), jnp.asarray(mask),
                                   jcfg.d_config))
    got = ttrm.decoder(tparams["decoder"], _t(x), _t(enc), _t(mask),
                       tcfg.d_config).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_decoder_step_matches_jax(models):
    """Four cached steps: each step's output and the whole cache."""
    jcfg, tcfg, params, tparams, _ = models
    x, enc, mask = _dec_inputs(45, Lt=4)
    N, T = x.shape[0], 6
    jcache = jtrm.init_decode_cache(jcfg.d_config, N, T)
    tcache = ttrm.init_decode_cache(tcfg.d_config, N, T)
    for t in range(4):
        xt = x[:, t:t + 1]
        jy, jcache = jtrm.decoder_step(
            params["decoder"], jnp.asarray(xt), jcache, jnp.int32(t),
            jnp.asarray(enc), jnp.asarray(mask), jcfg.d_config)
        ty, tcache = ttrm.decoder_step(tparams["decoder"], _t(xt), tcache, t,
                                       _t(enc), _t(mask), tcfg.d_config)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                                   rtol=0, err_msg=f"step {t}")
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the TVC model
# ---------------------------------------------------------------------------

PACKED_TINY = dataclasses.replace(jsyn.TINY, batch=3, n_subs=3, txt_len=12,
                                  frames_per_sub=6)


def tiny_videos(seed, n):
    """Small TV-like video shapes that fit ``PACKED_TINY``'s rows."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        n_subs = r.randint(2, 6)
        out.append(JaxVideoShape(
            n_frames=int(r.randint(8, 17)),
            sub_txt_lens=[int(x) for x in r.randint(2, 9, n_subs)],
            sub_n_frames=[int(x) for x in r.randint(1, 4, n_subs)]))
    return out


def _tvc_batch(seed=46, Ncap=4, Lv=6, Lt=5):
    """A packed video batch plus caption rows; the last caption row is a
    padded clip slot (``seg_mask`` all zero)."""
    r = np.random.RandomState(seed)
    b, _ = jsyn.tv_vsm_batch(tiny_videos(seed, PACKED_TINY.batch),
                             PACKED_TINY, packed=True, seed=seed)
    batch = {k: v for k, v in b.items() if k.startswith(("sub_", "c_"))}
    batch["cap_vidx"] = r.randint(0, PACKED_TINY.batch, (Ncap,)).astype(
        np.int32)
    batch["seg_idx"] = np.sort(r.randint(0, 16, (Ncap, Lv)), 1).astype(
        np.int32)
    seg_mask = (np.arange(Lv)[None] < r.randint(1, Lv + 1, (Ncap, 1)))
    seg_mask[-1] = False
    batch["seg_mask"] = seg_mask.astype(np.float32)
    batch["cap_input_ids"] = r.randint(3, 128, (Ncap, Lt)).astype(np.int32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_encode_and_decode_logits_match_jax(models):
    jcfg, tcfg, params, tparams, _ = models
    batch = _tvc_batch()
    tb = batch_to_device(batch, "cpu")
    want_enc = jtvc.encode(params, jcfg, _jax(batch))
    got_enc = ttvc.encode(tparams, tcfg, tb)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc),
                               atol=ATOL, rtol=0)
    want = np.asarray(jtvc.decode(params, jcfg, want_enc,
                                  jnp.asarray(batch["seg_mask"]),
                                  jnp.asarray(batch["cap_input_ids"])))
    got = ttvc.decode(tparams, tcfg, got_enc, tb["seg_mask"],
                      tb["cap_input_ids"]).numpy()
    assert got.shape == want.shape == (4, 5, jcfg.f_config.vocab_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_greedy_ids_match_jax(models):
    jcfg, tcfg, params, tparams, _ = models
    batch = _tvc_batch(seed=47)
    want = np.asarray(jtvc.greedy_decode(params, jcfg, _jax(batch),
                                         max_step=6, bos=BOS, eos=EOS))
    got = ttvc.greedy_decode(tparams, tcfg, batch_to_device(batch, "cpu"),
                             max_step=6, bos=BOS, eos=EOS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_beam_ids_match_jax(models):
    jcfg, tcfg, params, tparams, _ = models
    batch = _tvc_batch(seed=48)
    # an EOS the model emits, so finished beams and the length penalty
    # take part
    eos = int(np.asarray(jtvc.greedy_decode(params, jcfg, _jax(batch),
                                            max_step=3, bos=BOS,
                                            eos=EOS))[0, 1])
    want = np.asarray(jtvc.beam_decode(params, jcfg, _jax(batch), max_step=5,
                                       bos=BOS, eos=eos, beam=3))
    got = ttvc.beam_decode(tparams, tcfg, batch_to_device(batch, "cpu"),
                           max_step=5, bos=BOS, eos=eos, beam=3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == eos).any()


@pytest.mark.parametrize("penalty", [0.0, 1.3])
def test_beam_ids_match_jax_at_a_length_penalty(models, penalty):
    """``beam_decode(length_penalty=)`` against JAX's at no length
    normalisation and at a stronger one than the default 0.6."""
    jcfg, tcfg, params, tparams, _ = models
    batch = _tvc_batch(seed=48)
    eos = int(np.asarray(jtvc.greedy_decode(params, jcfg, _jax(batch),
                                            max_step=3, bos=BOS,
                                            eos=EOS))[0, 1])
    kw = dict(max_step=5, bos=BOS, eos=eos, beam=3, length_penalty=penalty)
    want = np.asarray(jtvc.beam_decode(params, jcfg, _jax(batch), **kw))
    got = ttvc.beam_decode(tparams, tcfg, batch_to_device(batch, "cpu"),
                           **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_cached_greedy_equals_teacher_forced_replay(models):
    """The twin of ``test_tvc_greedy_kv_cache_matches_full_decoder``: each
    cached greedy token is the argmax of the full causal decoder run over
    the generated prefix."""
    _, tcfg, _, tparams, _ = models
    batch = batch_to_device(_tvc_batch(seed=49), "cpu")
    T = 6
    out = ttvc.greedy_decode(tparams, tcfg, batch, max_step=T, bos=BOS,
                             eos=EOS)
    enc = ttvc.encode(tparams, tcfg, batch)
    prefix = torch.cat([torch.full((out.shape[0], 1), BOS,
                                   dtype=torch.int32), out[:, :-1]], 1)
    for t in range(T):
        logits = ttvc.decode(tparams, tcfg, enc, batch["seg_mask"],
                             prefix[:, :t + 1])
        assert torch.equal(logits[:, -1].argmax(-1).int(), out[:, t]), t
    # one decode over the whole prefix: the causal bias hides the future
    full = ttvc.decode(tparams, tcfg, enc, batch["seg_mask"], prefix)
    assert torch.equal(full.argmax(-1).int(), out)


# ---------------------------------------------------------------------------
# data and the generation driver
# ---------------------------------------------------------------------------

class MemVideoStore:
    """In-memory video store for the TVC datasets: the packed backbone
    arrays of each video, its frame count and the frame interval."""

    def __init__(self, videos, shape, seed, syn=tsyn):
        b, _ = syn.tv_vsm_batch(videos, shape, seed=seed,
                                **({"packed": True} if syn is jsyn else {}))
        self.vids = [f"vid{i:03d}" for i in range(len(videos))]
        self._items = {vid: {k: v[i] for k, v in b.items()
                             if k.startswith(("sub_", "c_"))}
                       for i, vid in enumerate(self.vids)}
        self._n = {vid: v.n_frames for vid, v in zip(self.vids, videos)}
        self.img_db = types.SimpleNamespace(frame_interval=1.5)

    def video_item(self, vid):
        return {k: v.copy() for k, v in self._items[vid].items()}

    def nframes(self, vid):
        return self._n[vid]


def _clips(store, seed, max_clips=6, max_len=6):
    """1..max_clips clips per video, 1..max_len frames each, at 1.5 s."""
    r = np.random.RandomState(seed)
    clips = []
    for vid in store.vids:
        for c in range(int(r.randint(1, max_clips + 1))):
            n = int(r.randint(1, max_len + 1))
            st = int(r.randint(0, store.nframes(vid) - n + 1))
            clips.append((vid, f"{vid}_{c}", [st * 1.5, (st + n) * 1.5],
                          None))
    return clips


def test_tvc_data_copies_are_exact():
    r = np.random.RandomState(50)
    for _ in range(200):
        ts = sorted(r.uniform(0, 90, 2).tolist())
        for round_ed in (False, True):
            assert (tdt.get_st_ed_label(ts, 60, 1.5, round_ed)
                    == jdt.get_st_ed_label(ts, 60, 1.5, round_ed))
    videos = tiny_videos(51, 5)
    store = MemVideoStore(videos, PACKED_TINY, seed=52)
    clips = _clips(store, 53)
    tds = tdt.TvcClipDataset(store, clips, clips_per_item=4, seg_len=8)
    jds = jdt.TvcClipDataset(store, clips, clips_per_item=4, seg_len=8)
    assert len(tds) == len(jds) > 5
    for idx in ([0, 1, 2], [len(tds) - 1] * 3):
        tb = tdt.build_tvc_clip_batch(tds, idx)
        jb = jdt.build_tvc_clip_batch(jds, idx)
        assert set(tb) == set(jb)
        assert {"sub_txt_seg", "sub_txt_pos", "sub_frame_seg",
                "sub_frame_pos"} <= set(tb)
        for k in tb:
            if k.startswith("__"):
                assert tb[k] == jb[k], k
            else:
                assert tb[k].dtype == jb[k].dtype, k
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    # the store of the port's batch builder equals one built by JAX's
    jstore = MemVideoStore(videos, PACKED_TINY, seed=52, syn=jsyn)
    for vid in store.vids:
        for k, v in store.video_item(vid).items():
            np.testing.assert_array_equal(v, jstore.video_item(vid)[k])


def test_generate_clip_captions_matches_jax(models):
    """Every clip exactly once (the tail batch padded by repeating its
    last item, padded slots dropped), ids cut at the first EOS, the
    reference schema -- and the records of the JAX driver, equal."""
    jcfg, tcfg, params, tparams, _ = models
    store = MemVideoStore(tiny_videos(54, 5), PACKED_TINY, seed=55)
    clips = _clips(store, 56)
    kw = dict(clips_per_item=4, seg_len=8)
    tds = tdt.TvcClipDataset(store, clips, **kw)
    assert len(tds) % 3                       # a partial tail batch
    first = tdt.build_tvc_clip_batch(tds, [0, 1, 2])
    # an EOS the model emits at step 2 of the first clip: the cut shows
    eos = int(ttvc.greedy_decode(tparams, tcfg,
                                 batch_to_device(first, "cpu"), max_step=6,
                                 bos=BOS, eos=EOS)[0, 2])
    got = tinf.generate_clip_captions(tparams, tcfg, tds, bos=BOS, eos=eos,
                                      batch_size=3, max_gen_step=6,
                                      dtype=torch.float32, device="cpu")
    want = jinf.generate_clip_captions(
        params, jcfg, jdt.TvcClipDataset(store, clips, **kw), bos=BOS,
        eos=eos, batch_size=3, max_gen_step=6)
    assert got == want
    assert len(got) == len(clips)
    for rec, clip in zip(got, clips):
        assert set(rec) == {"vid_name", "clip_id", "ts", "descs"}
        assert (rec["vid_name"], rec["clip_id"], rec["ts"]) == clip[:3]
        toks = [int(t) for t in rec["descs"][0]["desc"].split()]
        assert eos not in toks and len(toks) <= 6
    assert len(got[0]["descs"][0]["desc"].split()) == 2


def test_beam_generation_covers_every_clip(models):
    _, tcfg, _, tparams, _ = models
    store = MemVideoStore(tiny_videos(57, 3), PACKED_TINY, seed=58)
    clips = _clips(store, 59)
    tds = tdt.TvcClipDataset(store, clips, clips_per_item=4, seg_len=8)
    recs = tinf.generate_clip_captions(tparams, tcfg, tds, bos=BOS, eos=EOS,
                                       batch_size=2, max_gen_step=4, beam=3,
                                       dtype=torch.float32, device="cpu")
    assert [r["clip_id"] for r in recs] == [c[1] for c in clips]


# ---------------------------------------------------------------------------
# bridge, config and numpy init
# ---------------------------------------------------------------------------

def test_tvc_bridge_uses_every_tvc_key(models):
    *_, flat = models
    _, used = from_jax.convert(flat, device="cpu", tree=from_jax._tvc_tree)
    assert used == set(flat)
    assert from_jax.TASK_HEAD_JAX_KEYS <= used
    assert {k for k in used if "pooler" in k.split("/")} and not {
        k for k in used if k.startswith("head/")}
    missing = dict(flat)
    missing.pop("decoder/layers/cross_attention/key/kernel")
    with pytest.raises(KeyError, match="missing"):
        from_jax.load_jax_tvc_params(missing, device="cpu")
    extra = dict(flat, **{"decoder/extra/kernel": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match="unexpected"):
        from_jax.load_jax_tvc_params(extra, device="cpu")


def test_flagship_tvc_config_is_hero_tvc_json():
    cfg = flagship_tvc_config()
    want = JaxHeroConfig.from_json(str(REPO / "config" / "hero_tvc.json"))
    assert cfg.to_dict() == want.to_dict()
    d = cfg.d_config
    assert (d.hidden_size, d.num_attention_heads, d.intermediate_size,
            d.vocab_size, d.num_hidden_layers,
            d.max_position_embeddings) == (768, 12, 3072, 50272, 2, 1024)
    assert (cfg.f_config.num_hidden_layers,
            cfg.c_config.num_hidden_layers) == (6, 3)


def test_numpy_tvc_init_has_the_jax_tree():
    jcfg = jax_tiny_config()
    flat = ttvc.init_flat_tvc_params(tiny_hero_config(), seed=0)
    shapes = jax.eval_shape(
        lambda: jtvc.init_hero_for_tvc(jax.random.PRNGKey(1), jcfg))
    want = {"/".join(str(k.key) for k in path):
            (tuple(v.shape), np.dtype(v.dtype))
            for path, v in jax.tree_util.tree_leaves_with_path(shapes)}
    assert {k: (v.shape, v.dtype) for k, v in flat.items()} == want
    pos = flat["position_embeddings"]
    assert abs(pos.std() - 0.02) < 0.004
    assert (flat["emb_ln/scale"] == 1).all()
