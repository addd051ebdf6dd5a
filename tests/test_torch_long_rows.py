"""The packed attention backward's slice at rows past its old length
ceilings, against the JAX package: the fp32 VR loss of an MSR-VTT
video-only batch (``models/vcmr.forward_vr``) and every parameter
gradient, against ``jax.grad`` of JAX's ``forward_vr``.

A video-only row is one pseudo-subtitle: 100 frames and 61 text slots
(``data/video.VideoOnlyDataset``), so every f-encoder attention call runs
on 161 slots, the MSR-VTT video-only rows of ``config/train-msrvtt_video_
only.json``, where the port's kernels once stopped (fp32 at 154 rows).
On the CPU the port takes the plain versions of those kernels, so this
holds the slice's arithmetic at that length; ``test_torch_kernels.py``
holds the kernels against the plain versions on the card.

The model is cut to 1 f-layer and 1 c-layer of width 128 (2 heads of
64, the flagship head width); the weights are one numpy init, carried to
the port by ``convert/from_jax``; everything is fp32 with dropout off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hero_tpu.config.model_config import HeroConfig as JHeroConfig
from hero_tpu.models import pretrain as jpre
from hero_tpu.models import vcmr as jvcmr
from hero_tpu.training.save import flatten_tree, unflatten_tree
from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.convert.from_jax import load_jax_params
from hero_tpu_torch.data.downstream_tasks import VrDataset, build_batch
from hero_tpu_torch.data.video import FixedShapes, VideoOnlyDataset
from hero_tpu_torch.models import pretrain as tpre
from hero_tpu_torch.models import vcmr as tvcmr
from hero_tpu_torch.training import optim as toptim

VOCAB, VFEAT, FRAMES, TXT = 128, 64, 100, 61
LAYER = {"hidden_size": 128, "num_attention_heads": 2,
         "intermediate_size": 512, "max_position_embeddings": 128,
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
MODEL = {"f_config": dict(LAYER, num_hidden_layers=1, vocab_size=VOCAB,
                          type_vocab_size=2),
         "c_config": dict(LAYER, num_hidden_layers=1, type_vocab_size=2),
         "q_config": dict(LAYER, num_hidden_layers=0, vocab_size=VOCAB,
                          type_vocab_size=1),
         "vfeat_dim": VFEAT, "max_frm_seq_len": FRAMES,
         "max_clip_len": FRAMES}
VSM = dict(lw_neg_ctx=1.0, lw_neg_q=1.0, lw_st_ed=0.0)


class _Feats:
    """An in-memory video feature store: 3 videos of 100, 83 and 100
    frames."""
    frame_interval = 1.5

    def __init__(self, r):
        self.name2nframe = {"v0": 100, "v1": 83, "v2": 100}
        self.feats = {v: r.randn(n, VFEAT).astype(np.float16)
                      for v, n in self.name2nframe.items()}

    def __getitem__(self, vid):
        return self.feats[vid]


class _Queries:
    """An in-memory query store: two queries a video, ids from the
    vocabulary, the special ids RoBERTa's (CLS 0, pad 1)."""
    cls_, pad = 0, 1

    def __init__(self, r):
        self.query_data = {}
        self.video2query = {}
        for vid in ("v0", "v1", "v2"):
            for q in range(2):
                qid = f"{vid}_{q}"
                n = int(r.randint(5, 20))
                self.query_data[qid] = {
                    "input_ids": r.randint(3, VOCAB, (n,)).tolist()}
                self.video2query.setdefault(vid, []).append(qid)
        self.id2len = {q: len(v["input_ids"])
                       for q, v in self.query_data.items()}
        self.query2video = {q: q.split("_")[0] for q in self.query_data}

    def __getitem__(self, qid):
        return self.query_data[qid]


def _vr_batch():
    r = np.random.RandomState(18)
    shapes = FixedShapes(n_subs=1, txt_len=TXT, frames_per_sub=FRAMES,
                         n_frames=FRAMES, n_queries=2, query_len=24,
                         vfeat_dim=VFEAT)
    videos = VideoOnlyDataset(_Feats(r), _Queries(r), shapes)
    ds = VrDataset(videos.vids, videos, _Queries(r), max_num_query=2,
                   sampled_by_q=False)
    return {k: v for k, v in build_batch(ds, [0, 1, 2]).items()
            if not k.startswith("__")}


def test_vr_loss_and_grads_at_161_slots_match_jax():
    """Both VR losses within 2e-6 and every gradient within atol 1e-5 of
    JAX's: fp32 sums of up to 161 products (the attention rows) and 512
    (the FFN) taken in other orders through two post-LN layers."""
    batch = _vr_batch()
    S, Lt = batch["sub_input_ids"].shape[1:]
    Fs = batch["sub_frame_idx"].shape[2]
    assert (S, Fs + Lt) == (1, FRAMES + TXT)          # one 161-slot row
    assert batch["sub_frame_mask"][1].sum() == 83     # a shorter video
    tcfg, jcfg = HeroConfig.from_dict(MODEL), JHeroConfig.from_dict(MODEL)
    vsm = tpre.VsmConfig(**VSM)
    flat = tpre.init_flat_params(tcfg, vsm, seed=18)

    def jloss(params, b):
        a, c = jvcmr.forward_vr(params, jcfg, jpre.VsmConfig(**VSM), b)
        return a + c, (a, c)

    grad_fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    (_, (ja, jc)), jgrads = grad_fn(
        jax.tree.map(jnp.asarray, unflatten_tree(flat)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    want = load_jax_params(flatten_tree(jax.device_get(jgrads)),
                           device="cpu")

    params = load_jax_params(flat, device="cpu")
    leaves = toptim.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    a, c = tvcmr.forward_vr(params, tcfg, vsm,
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    got = torch.autograd.grad(a + c, leaves, allow_unused=True)
    a, c = a.detach(), c.detach()
    assert float(a) == pytest.approx(float(ja), abs=2e-6)
    assert float(c) == pytest.approx(float(jc), abs=2e-6)
    assert float(a) > 0 and float(c) > 0
    n_nonzero = 0
    for path, g, w in zip(toptim.tree_paths(want), got,
                          toptim.tree_leaves(want)):
        g = torch.zeros_like(w) if g is None else g
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0,
                                   err_msg="/".join(path))
        n_nonzero += bool(float(w.abs().max()) > 0)
    assert n_nonzero > 10
