"""VSM heads used by serving, and a numpy parameter init
(counterpart of ``hero_tpu/models/pretrain.py``).

:func:`init_flat_params` draws weights with the same tree and
distributions as ``init_hero_for_pretraining`` but with numpy, in the flat
``{"a/b/c": array}`` JAX layout that ``convert/from_jax.py`` loads: it is
how a run with no JAX (the card's machine) gets weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hero_tpu_torch.config.model_config import HeroConfig, TransformerConfig
from hero_tpu_torch.models import encoder as enc
from hero_tpu_torch.models import model as backbone
from hero_tpu_torch.models import nn

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
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Query text -> f-encoder ('txt') -> query-feature encoder pooled
    vector (N, D) (``hero_tpu/models/pretrain.py:105-115``)."""
    txt_out = backbone.forward_txt(params["v_encoder"], cfg, input_ids,
                                   attn_mask, dtype=dtype)
    return enc.query_feat_encoder(params["head"]["q_feat_attn"],
                                  cfg.q_config, txt_out, attn_mask,
                                  dtype=dtype)


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


# ---------------------------------------------------------------------------
# numpy init in the JAX parameter layout
# ---------------------------------------------------------------------------

class _Init:
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


def init_flat_params(cfg: HeroConfig, vsm: VsmConfig = VsmConfig(),
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights in the flat JAX layout of ``init_hero_for_pretraining``
    (``hero_tpu/models/pretrain.py:55-82``): normal(initializer_range)
    weights with the padding rows zeroed, zero biases, LayerNorm 1/0, and
    the st/ed conv taps U(-1/sqrt(k), 1/sqrt(k))."""
    f, c, q = cfg.f_config, cfg.c_config, cfg.q_config
    D, V = f.hidden_size, cfg.vfeat_dim
    it = _Init(seed)
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
    it.linear("v_encoder/fom_output/linear_1", Dc, 2 * Dc)
    it.layer_norm("v_encoder/fom_output/ln", 2 * Dc)
    it.linear("v_encoder/fom_output/linear_2", 2 * Dc, cfg.max_clip_len)

    Dq, k = q.hidden_size, vsm.conv_kernel_size
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
