"""The VSM heads and losses, the VSM forward, and a numpy parameter init
(counterpart of ``hero_tpu/models/pretrain.py``).

:func:`forward_vsm` is the pretraining VSM task: clip and query encoding,
the span loss and the in-batch ranking losses over all negatives or one
sampled negative (``use_all_neg=False``), with the curriculum's
hard-negative weighting.  :func:`forward_pretrain` dispatches the four
pretraining tasks (MLM, MFM-NCE / MFFR, FOM, VSM).

:func:`init_flat_params` draws weights with the same tree and
distributions as ``init_hero_for_pretraining`` but with numpy, in the flat
``{"a/b/c": array}`` JAX layout that ``convert/from_jax.py`` loads: it is
how a run with no JAX (the card's machine) gets weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hero_tpu_torch.config.model_config import HeroConfig, TransformerConfig
from hero_tpu_torch.const import NEG_INF
from hero_tpu_torch.models import encoder as enc
from hero_tpu_torch.models import model as backbone
from hero_tpu_torch.models import nn
from hero_tpu_torch.parallel import dist

Params = Dict[str, Any]

PAD_IDX = 1          # RoBERTa padding token id (zero row of word_emb)


@dataclasses.dataclass(frozen=True)
class VsmConfig:
    """Static VSM loss configuration (reference model/pretrain.py:20-60)."""
    conv_kernel_size: int = 5
    conv_stride: int = 1
    ranking_loss_type: str = "hinge"   # or "lse"
    margin: float = 0.1
    lw_neg_ctx: float = 0.0
    lw_neg_q: float = 0.0
    lw_st_ed: float = 0.01
    drop_svmr_prob: float = 0.0
    use_all_neg: bool = True

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def conv1d_same(kernel: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """1-channel 1-D convolution, SAME padding, no bias, as k shifted fp32
    taps (exact, and no TF32 convolution on the card).  x: (..., L)."""
    k = kernel.shape[0]
    half = k // 2
    xf = x.float()
    L = x.shape[-1]
    padded = F.pad(xf, (half, half))
    out = torch.zeros_like(xf)
    for i in range(k):
        out = out + kernel[i].float() * padded[..., i:i + L]
    return out


def encode_query(params: Params, cfg: HeroConfig, input_ids, attn_mask, *,
                 train: bool = False, seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Query text -> f-encoder ('txt') -> query-feature encoder pooled
    vector (N, D) (``hero_tpu/models/pretrain.py:105-115``)."""
    txt_out = backbone.forward_txt(params["v_encoder"], cfg, input_ids,
                                   attn_mask, train=train,
                                   seed=nn.rng_for(seed, "txt"), dtype=dtype)
    return enc.query_feat_encoder(params["head"]["q_feat_attn"],
                                  cfg.q_config, txt_out, attn_mask,
                                  train=train, seed=nn.rng_for(seed, "qattn"),
                                  dtype=dtype)


def encode_query_packed(params: Params, cfg: HeroConfig, p_ids, p_seg,
                        p_pos, max_segs: int, *,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed :func:`encode_query` (inference): several queries share one
    f-encoder text row behind the block-diagonal segment mask
    (``hero_tpu/models/pretrain.py:118-136``).  p_ids / p_seg / p_pos
    (R, L) int32: token ids, segment ids (-1 = pad slot) and positions
    restarting per segment.  Returns (R, max_segs, D) per-segment pooled
    vectors."""
    txt_out = enc.cross_modal_txt(params["v_encoder"]["f_encoder"],
                                  cfg.f_config, p_ids, seg=p_seg,
                                  position_ids=p_pos, dtype=dtype)
    return enc.query_feat_encoder_packed(params["head"]["q_feat_attn"],
                                         cfg.q_config, txt_out, p_seg,
                                         p_pos, max_segs, dtype=dtype)


def get_st_ed_sim(head: Params, mod_query: torch.Tensor,
                  frame_emb: torch.Tensor) -> torch.Tensor:
    """Pre-conv query.frame similarity (Nq, Nv, L), fp32.  The inputs are
    upcast so the product and its sum are fp32 (a bf16 matmul would round
    the result to bf16 and create ties in the ranking)."""
    q = nn.linear(head["video_query_linear"], mod_query, mod_query.dtype)
    return torch.einsum("md,nld->mnl", q.float(), frame_emb.float())


def conv_st_ed_masked(head: Params, sim: torch.Tensor, fmask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """st/ed convolutions + frame masking over (..., L) similarity rows."""
    st = conv1d_same(head["video_st_predictor"]["kernel"], sim)
    ed = conv1d_same(head["video_ed_predictor"]["kernel"], sim)
    return nn.mask_logits(st, fmask), nn.mask_logits(ed, fmask)


def get_video_level_scores(mod_query: torch.Tensor, frame_emb: torch.Tensor,
                           frame_mask: torch.Tensor) -> torch.Tensor:
    """Max-pooled cosine scores: mod_query (Nq, D), frame_emb (Nv, L, D)
    -> (Nq, Nv), fp32 (``hero_tpu/models/pretrain.py:184-203``)."""
    def normalize(x):
        inv = torch.rsqrt(torch.clamp(
            x.float().square().sum(-1, keepdim=True), min=1e-10))
        return x * inv.to(x.dtype)

    q, c = normalize(mod_query), normalize(frame_emb)
    scores = torch.einsum("md,nld->mnl", q.float(), c.float())
    scores = nn.mask_logits(scores, frame_mask[None])            # (Nq,Nv,L)
    return scores.max(dim=-1).values


def get_st_ed_logits(head: Params, mod_query: torch.Tensor,
                     frame_emb: torch.Tensor, frame_mask: torch.Tensor,
                     cross: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paired-mode span logits: query n scores its own video.
    mod_query (B, Q, D), frame_emb (B, L, D), frame_mask (B, L) ->
    st, ed (B, Q, L) fp32 (``hero_tpu/models/pretrain.py:164-181``; the
    JAX package repeats each video's frames per query, the einsum over
    the video axis gives the same products).  With ``cross`` every query
    scores every video: mod_query (Nq, D), frame_emb (Nv, L, D) ->
    (Nq, Nv, L)."""
    if cross:
        return conv_st_ed_masked(head, get_st_ed_sim(head, mod_query,
                                                     frame_emb),
                                 frame_mask[None])
    q = nn.linear(head["video_query_linear"], mod_query, mod_query.dtype)
    sim = torch.einsum("bqd,bld->bql", q.float(), frame_emb.float())
    return conv_st_ed_masked(head, sim, frame_mask[:, None, :])


def ranking_loss(pos: torch.Tensor, neg: torch.Tensor, loss_type: str,
                 margin: float) -> torch.Tensor:
    """hinge: max(0, m + S_neg - S_pos); lse: log1p(exp(S_neg - S_pos))
    (``hero_tpu/models/pretrain.py:206-214``)."""
    if loss_type == "hinge":
        return torch.clamp(margin + neg - pos, min=0.0)
    if loss_type == "lse":
        return torch.log1p(torch.exp(neg - pos))
    raise NotImplementedError(loss_type)


def video_level_loss(scores: torch.Tensor, q_mask: torch.Tensor,
                     num_q_per_v: int, vsm: VsmConfig, *,
                     use_hard_negative: bool = False,
                     hard_pool_size: int = 20, hard_neg_weight: float = 10.0,
                     seed: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-batch ranking losses over (Nq, Nv) scores
    (``hero_tpu/models/pretrain.py:217-285``).  Query j's positive video
    is j // num_q_per_v; ``q_mask`` (Nq,) drops padded queries out of the
    means.  All negatives (``vsm.use_all_neg``): hard-negative weights
    apply to the sorted negative columns.  Otherwise one sampled negative
    a query and a video (:func:`_sampled_neg_loss`, drawn from ``seed``).
    Returns (loss_neg_ctx, loss_neg_q)."""
    nq, nv = scores.shape
    if nv == 1:
        # a one-video batch has no negative contexts (the reference
        # returns zero losses for bsz_v == 1)
        zero = scores.new_zeros(())
        return zero, zero
    dev = scores.device
    q_mask = q_mask.float()
    pos_vid = torch.arange(nq, device=dev) // num_q_per_v
    is_pos = torch.arange(nv, device=dev)[None, :] == pos_vid[:, None]
    pos_scores = scores.gather(1, pos_vid[:, None])[:, 0]
    scores_masked = torch.where(is_pos, _BIG, scores)
    if not vsm.use_all_neg:
        return _sampled_neg_loss(scores_masked, pos_scores, q_mask,
                                 num_q_per_v, vsm,
                                 use_hard_negative=use_hard_negative,
                                 hard_pool_size=hard_pool_size, seed=seed)

    def weights(n_cols):
        if not use_hard_negative:
            return torch.ones(n_cols, device=dev)
        col = torch.arange(n_cols, device=dev)
        return torch.where(col < hard_pool_size, float(hard_neg_weight), 0.1)

    # negative contexts per query: the masked positive sorts first
    neg_ctx = _sort_desc(scores_masked)[:, 1:]                 # (Nq, Nv-1)
    l_ctx = ranking_loss(pos_scores[:, None], neg_ctx, vsm.ranking_loss_type,
                         vsm.margin) * weights(nv - 1)[None, :]
    l_ctx_per_q = l_ctx.mean(1) * q_mask

    neg_q = _sort_desc(_video_rows(scores_masked, q_mask, num_q_per_v))[
        :, num_q_per_v:]                                       # (Nv, Nq-Q)
    pos_per_v = pos_scores.reshape(nv, num_q_per_v)
    l_q = ranking_loss(pos_per_v[:, :, None], neg_q[:, None, :],
                       vsm.ranking_loss_type, vsm.margin)
    l_q = l_q * weights(nq - num_q_per_v)[None, None, :]
    l_q_per_q = l_q.mean(2).reshape(nq) * q_mask

    n_valid = torch.clamp(q_mask.sum(), min=1.0)
    return l_ctx_per_q.sum() / n_valid, l_q_per_q.sum() / n_valid


_BIG = 999.0                     # the masked positives' score: sorts first


def _sort_desc(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1, descending=True, stable=True).values


def _video_rows(scores_masked: torch.Tensor, q_mask: torch.Tensor,
                num_q_per_v: int) -> torch.Tensor:
    """(Nv, Nq) scores of every query against each video: invalid queries
    at -1e4 (they sort last), each video's own num_q_per_v queries at
    999 (they sort first)."""
    nq, nv = scores_masked.shape
    pos_vid = torch.arange(nq, device=scores_masked.device) // num_q_per_v
    own = (torch.arange(nv, device=scores_masked.device)[:, None]
           == pos_vid[None, :])
    vq = torch.where(q_mask[None, :] > 0, scores_masked.T, NEG_INF)
    return torch.where(own, _BIG, vq)


def _sampled_neg_loss(scores_masked: torch.Tensor, pos_scores: torch.Tensor,
                      q_mask: torch.Tensor, num_q_per_v: int,
                      vsm: VsmConfig, *, use_hard_negative: bool,
                      hard_pool_size: int, seed: Optional[int] = None,
                      uniforms: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``use_all_neg=False`` (``hero_tpu/models/pretrain.py:288-330``):
    one sampled negative context a query and one negative query a video
    instead of all of them.  A row's sorted negatives are drawn at
    ``int(min_idx + u * (max_idx - min_idx))`` in fp32, clipped to the
    row, with ``max_idx = min(min_idx + hard_pool_size, width)`` under
    hard-negative mining and the row width otherwise.

    ``uniforms`` = (u_ctx (Nq,), u_q (Nv,)) fp32 in [0, 1); by default
    they are drawn on the host from two generators seeded with the
    ``ctx`` and ``q`` sub-seeds of ``seed`` (0 when None), so the card and
    the CPU draw the same."""
    nq, nv = scores_masked.shape
    dev = scores_masked.device
    if uniforms is None:
        base = 0 if seed is None else seed
        uniforms = tuple(
            torch.rand(n, generator=torch.Generator().manual_seed(
                nn.rng_for(base, tag)))
            for n, tag in ((nq, "ctx"), (nv, "q")))
    u_ctx, u_q = (u.to(device=dev, dtype=torch.float32) for u in uniforms)

    def sample_sorted(sorted_rows, u, width, min_idx):
        max_idx = (float(min(min_idx + hard_pool_size, width))
                   if use_hard_negative else float(width))
        idx = (min_idx + u * (max_idx - min_idx)).to(torch.int64)
        idx = idx.clamp(min_idx, width - 1)
        return sorted_rows.gather(1, idx[:, None])[:, 0]

    neg_ctx = sample_sorted(_sort_desc(scores_masked), u_ctx, nv, 1)
    l_ctx = ranking_loss(pos_scores, neg_ctx, vsm.ranking_loss_type,
                         vsm.margin) * q_mask
    neg_q = sample_sorted(_sort_desc(_video_rows(scores_masked, q_mask,
                                                 num_q_per_v)),
                          u_q, nq, num_q_per_v)                # (Nv,)
    pos_per_v = pos_scores.reshape(nv, num_q_per_v)
    l_q = ranking_loss(pos_per_v, neg_q[:, None], vsm.ranking_loss_type,
                       vsm.margin).reshape(nq) * q_mask
    n_valid = torch.clamp(q_mask.sum(), min=1.0)
    return l_ctx.sum() / n_valid, l_q.sum() / n_valid


def forward_vsm(params: Params, cfg: HeroConfig, vsm: VsmConfig,
                batch: Dict[str, torch.Tensor], *, compute_loss: bool = True,
                use_hard_negative: bool = False, hard_pool_size: int = 20,
                hard_neg_weight: float = 10.0,
                lw_st_ed: Optional[float] = None,
                compute_st_ed: bool = True, train: bool = False,
                seed: Optional[int] = None,
                dtype: torch.dtype = torch.float32):
    """VSM forward (``hero_tpu/models/pretrain.py:333-416``): clip encoding
    and query encoding, then (w_st_ed * span loss, lw_neg_ctx *
    loss_neg_ctx, lw_neg_q * loss_neg_q), fp32 scalars.  The curriculum
    arguments (``drivers/common.Curriculum``): hard-negative mining and
    its pool and weight, and ``lw_st_ed``, the span loss's weight in
    place of ``vsm.lw_st_ed``.  The span path runs when ``compute_st_ed``
    and either ``lw_st_ed`` is None or ``vsm.lw_st_ed`` is not 0, as in
    the JAX package.

    ``compute_loss=False`` returns (q2v scores (B*Q, B), or None when both
    ranking weights are 0; st and ed logits (B*Q, F), or None when the
    span path is off): query n scores its own video.

    ``train`` with an integer ``seed`` turns on dropout and the
    ``drop_svmr_prob`` skip of the span loss, drawn on the host from a
    generator seeded with the ``drop_svmr`` sub-seed (the JAX package
    draws it on the device and branches with ``lax.cond``); the sampled
    negatives draw from the ``sampled_neg`` sub-seed."""
    frame_emb = backbone.forward_repr(params["v_encoder"], cfg, batch,
                                      train=train,
                                      seed=nn.rng_for(seed, "repr"),
                                      dtype=dtype)                 # (B, F, D)
    B, Q, Lq = batch["query_input_ids"].shape
    mod_query = encode_query(
        params, cfg, batch["query_input_ids"].reshape(B * Q, Lq),
        batch["query_attn_masks"].reshape(B * Q, Lq), train=train,
        seed=nn.rng_for(seed, "query"), dtype=dtype)              # (B*Q, D)
    frame_mask = batch["c_attn_masks"].float()
    q_mask = batch["q_mask"].reshape(B * Q)
    st_ed_active = compute_st_ed and (lw_st_ed is None
                                      or vsm.lw_st_ed != 0)

    def span_logits():
        st, ed = get_st_ed_logits(params["head"],
                                  mod_query.reshape(B, Q, -1), frame_emb,
                                  frame_mask)
        L = st.shape[-1]
        return st.reshape(B * Q, L), ed.reshape(B * Q, L)

    def video_scores():
        if vsm.lw_neg_ctx != 0 or vsm.lw_neg_q != 0:
            return get_video_level_scores(mod_query, frame_emb, frame_mask)
        return None

    if not compute_loss:
        st = ed = None
        if st_ed_active:
            st, ed = span_logits()
        return video_scores(), st, ed

    zero = frame_emb.new_zeros((), dtype=torch.float32)
    loss_st_ed = zero
    keep_span = st_ed_active
    if keep_span and train and vsm.drop_svmr_prob > 0 and seed is not None:
        gen = torch.Generator().manual_seed(nn.rng_for(seed, "drop_svmr"))
        keep_span = float(torch.rand((), generator=gen)) > vsm.drop_svmr_prob
    if keep_span:
        # rule (a) of parallel/dist: each query's span is its own item
        targets = batch["targets"].reshape(B * Q, 2)
        st, ed = span_logits()
        s_sum, s_cnt = backbone.masked_cross_entropy(st, targets[:, 0])
        e_sum, e_cnt = backbone.masked_cross_entropy(ed, targets[:, 1])
        loss_st_ed = (dist.global_mean(s_sum, s_cnt)
                      + dist.global_mean(e_sum, e_cnt))

    loss_neg_ctx = loss_neg_q = zero
    if vsm.lw_neg_ctx != 0 or vsm.lw_neg_q != 0:
        # rule (b): every query ranks against every video of the global
        # batch, so the scores are the gathered rows' (the hard-negative
        # sort and the sampled uniforms see the global batch too)
        g = dist.gather_rows
        scores = get_video_level_scores(g(mod_query), g(frame_emb),
                                        g(frame_mask))
        loss_neg_ctx, loss_neg_q = (dist.replicated(x) for x in
                                    video_level_loss(
            scores, g(q_mask), Q, vsm, use_hard_negative=use_hard_negative,
            hard_pool_size=hard_pool_size, hard_neg_weight=hard_neg_weight,
            seed=nn.rng_for(seed, "sampled_neg")))
    w_st_ed = vsm.lw_st_ed if lw_st_ed is None else lw_st_ed
    return (w_st_ed * loss_st_ed, vsm.lw_neg_ctx * loss_neg_ctx,
            vsm.lw_neg_q * loss_neg_q)


def forward_pretrain(params: Params, cfg: HeroConfig, vsm: VsmConfig,
                     batch: Dict[str, torch.Tensor], task: str, *,
                     compute_loss: bool = True, train: bool = False,
                     seed: Optional[int] = None,
                     dtype: torch.dtype = torch.float32,
                     mask_prob: float = 0.15, **vsm_kw):
    """Task dispatch (``hero_tpu/models/pretrain.py:419-448``): ``vsm``,
    ``mlm*``, ``mffr``, ``mfm-nce`` or ``fom``.  ``vsm_kw`` are
    :func:`forward_vsm`'s curriculum arguments."""
    kw = dict(train=train, seed=seed, dtype=dtype)
    if task == "vsm":
        return forward_vsm(params, cfg, vsm, batch, **kw, **vsm_kw)
    v = params["v_encoder"]
    if task.startswith("mlm"):
        return backbone.forward_mlm(v, cfg, batch,
                                    compute_loss=compute_loss, **kw)
    if task in ("mffr", "mfm-nce"):
        return backbone.forward_mfm(
            v, cfg, batch, loss="regression" if task == "mffr" else "nce",
            compute_loss=compute_loss, mask_prob=mask_prob, **kw)
    if task == "fom":
        return backbone.forward_fom(v, cfg, batch,
                                    compute_loss=compute_loss, **kw)
    raise ValueError(f"Unrecognized task {task}")


# ---------------------------------------------------------------------------
# numpy init in the JAX parameter layout
# ---------------------------------------------------------------------------

class FlatInit:
    """Accumulates ``{"a/b/c": array}`` entries from one numpy Generator."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.flat: Dict[str, np.ndarray] = {}

    def normal(self, key, shape, std=0.02, zero_row=None):
        w = self.rng.standard_normal(shape, dtype=np.float32)
        w *= np.float32(std)
        if zero_row is not None:
            w[zero_row] = 0.0
        self.flat[key] = w

    def const(self, key, shape, value):
        self.flat[key] = np.full(shape, value, np.float32)

    def linear(self, key, d_in, d_out, std=0.02, bias=True, lead=()):
        self.normal(f"{key}/kernel", lead + (d_in, d_out), std)
        if bias:
            self.const(f"{key}/bias", lead + (d_out,), 0.0)

    def layer_norm(self, key, d, lead=()):
        self.const(f"{key}/scale", lead + (d,), 1.0)
        self.const(f"{key}/bias", lead + (d,), 0.0)

    def mlp_layer(self, key, d_in, d_out):
        """``nn.init_mlp_layer``'s leaves (``hero_tpu/models/nn.py:
        135-141``): linear(d, 2d), LayerNorm(2d), linear(2d, out)."""
        self.linear(f"{key}/linear_1", d_in, 2 * d_in)
        self.layer_norm(f"{key}/ln", 2 * d_in)
        self.linear(f"{key}/linear_2", 2 * d_in, d_out)

    def attention(self, key, cfg: TransformerConfig, lead=()):
        D, std = cfg.hidden_size, cfg.initializer_range
        for name in ("query", "key", "value", "out"):
            self.linear(f"{key}/{name}", D, D, std, lead=lead)
        self.layer_norm(f"{key}/out_ln", D, lead)

    def encoder(self, key, cfg: TransformerConfig):
        if cfg.num_hidden_layers == 0:
            return
        lead = (cfg.num_hidden_layers,)
        std = cfg.initializer_range
        self.attention(f"{key}/layers/attention", cfg, lead)
        self.linear(f"{key}/layers/ffn/intermediate", cfg.hidden_size,
                    cfg.intermediate_size, std, lead=lead)
        self.linear(f"{key}/layers/ffn/output", cfg.intermediate_size,
                    cfg.hidden_size, std, lead=lead)
        self.layer_norm(f"{key}/layers/ffn/ln", cfg.hidden_size, lead)


def init_flat_v_encoder(it: FlatInit, cfg: HeroConfig) -> None:
    """The backbone's ``v_encoder/...`` entries
    (``hero_tpu/models/model.py:45-70``), drawn from ``it``."""
    f, c = cfg.f_config, cfg.c_config
    D, V = f.hidden_size, cfg.vfeat_dim
    fe = "v_encoder/f_encoder"
    it.normal(f"{fe}/embeddings/word_emb", (f.vocab_size, D),
              f.initializer_range, zero_row=PAD_IDX)
    it.normal(f"{fe}/embeddings/pos_emb", (f.max_position_embeddings, D),
              f.initializer_range)
    it.normal(f"{fe}/embeddings/type_emb", (f.type_vocab_size, D),
              f.initializer_range)
    it.layer_norm(f"{fe}/embeddings/ln", D)
    it.layer_norm(f"{fe}/img_embeddings/img_ln", V)
    it.linear(f"{fe}/img_embeddings/img_linear", V, D, f.initializer_range)
    it.normal(f"{fe}/img_embeddings/pos_emb", (cfg.max_frm_seq_len, D),
              f.initializer_range)
    it.normal(f"{fe}/img_embeddings/mask_emb", (2, V), f.initializer_range,
              zero_row=0)
    it.layer_norm(f"{fe}/img_embeddings/ln", D)
    it.encoder(f"{fe}/encoder", f)
    it.linear(f"{fe}/pooler/dense", D, D, f.initializer_range)
    it.linear(f"{fe}/lm_head/dense", D, D, f.initializer_range)
    it.layer_norm(f"{fe}/lm_head/ln", D)
    it.const(f"{fe}/lm_head/bias", (f.vocab_size,), 0.0)

    it.linear("v_encoder/frame_transform/dense", V, D)
    it.layer_norm("v_encoder/frame_transform/ln", V)

    ce, Dc = "v_encoder/c_encoder", c.hidden_size
    it.normal(f"{ce}/embeddings/pos_emb", (c.max_position_embeddings, Dc),
              c.initializer_range)
    it.layer_norm(f"{ce}/embeddings/ln", Dc)
    it.encoder(f"{ce}/encoder", c)
    it.linear(f"{ce}/pooler/dense", Dc, Dc, c.initializer_range)

    it.linear("v_encoder/feat_regress/dense_1", D, D)
    it.layer_norm("v_encoder/feat_regress/ln", D)
    it.linear("v_encoder/feat_regress/dense_2", D, V)
    it.normal("v_encoder/mask_embedding", (2, V), zero_row=0)
    it.mlp_layer("v_encoder/fom_output", Dc, cfg.max_clip_len)


def init_flat_params(cfg: HeroConfig, vsm: VsmConfig = VsmConfig(),
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights in the flat JAX layout of ``init_hero_for_pretraining``
    (``hero_tpu/models/pretrain.py:55-82``): normal(initializer_range)
    weights with the padding rows zeroed, zero biases, LayerNorm 1/0, and
    the st/ed conv taps U(-1/sqrt(k), 1/sqrt(k))."""
    it = FlatInit(seed)
    init_flat_v_encoder(it, cfg)
    q, D = cfg.q_config, cfg.f_config.hidden_size
    Dq, Dc, k = q.hidden_size, cfg.c_config.hidden_size, vsm.conv_kernel_size
    it.linear("head/video_query_linear", Dq, Dc)
    bound = 1.0 / (k ** 0.5)
    for name in ("video_st_predictor", "video_ed_predictor"):
        it.flat[f"head/{name}/kernel"] = it.rng.uniform(
            -bound, bound, (k,)).astype(np.float32)
    qa = "head/q_feat_attn"
    it.linear(f"{qa}/query_input_proj/dense", D, Dq)
    it.layer_norm(f"{qa}/query_input_proj/ln", D)
    it.normal(f"{qa}/pos_embed/pos_emb", (q.max_position_embeddings, Dq),
              q.initializer_range)
    it.layer_norm(f"{qa}/pos_embed/ln", Dq)
    it.attention(f"{qa}/attention", q)
    it.linear(f"{qa}/modular_vector", Dq, 1, q.initializer_range,
              bias=False)
    return it.flat
