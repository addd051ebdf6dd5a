"""The HERO backbone forward (counterpart of ``hero_tpu/models/model.py``).

Batch contract (tensors on one device), as in the JAX package:

==================  ============  =======================================
key                 shape         meaning
==================  ============  =======================================
sub_input_ids       (B, S, Lt)    subtitle BPE ids, pad = 1
sub_txt_mask        (B, S, Lt)    1 = valid text token
sub_frame_idx       (B, S, Fs)    clip-frame index per sub frame-slot
sub_frame_mask      (B, S, Fs)    1 = valid frame slot
sub_mask            (B, S)        1 = valid subtitle row
c_v_feats           (B, F, vdim)  clip-level frame features (fp16 store)
c_attn_masks        (B, F)        1 = valid frame
==================  ============  =======================================

A packed batch adds ``sub_txt_seg``/``sub_txt_pos`` (B, S, Lt) and
``sub_frame_seg``/``sub_frame_pos`` (B, S, Fs): segment ids (-1 = pad
slot) and positions restarting per segment.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.models import encoder as enc
from hero_tpu_torch.models import nn
from hero_tpu_torch.parallel import dist

Params = Dict[str, Any]


def gather_sub_frames(c_v_feats: torch.Tensor,
                      sub_frame_idx: torch.Tensor) -> torch.Tensor:
    """c_v_feats (B, F, vdim), sub_frame_idx (B, S, Fs) -> (B, S, Fs, vdim)."""
    B, S, Fs = sub_frame_idx.shape
    rows = torch.arange(B, device=c_v_feats.device)[:, None]
    out = c_v_feats[rows, sub_frame_idx.reshape(B, S * Fs).long()]
    return out.reshape(B, S, Fs, -1)


def collect_frame_outputs(frame_hidden: torch.Tensor,
                          sub_frame_idx: torch.Tensor, valid: torch.Tensor,
                          num_frames: int) -> torch.Tensor:
    """Scatter-add per-sub frame outputs onto the clip timeline:
    ``out[b, sub_frame_idx[b, s, f]] += frame_hidden[b, s, f] * valid``.

    frame_hidden (B, S, Fs, D); sub_frame_idx/valid (B, S, Fs) -> (B, F, D)
    fp32, as a batched fp32 product with the (B, F, S*Fs) one-hot of the
    slot-to-frame map.  Unlike ``index_add_``, whose atomics add on the
    card in launch order, the product sums in a fixed order, so a step
    repeats bit for bit (a rematerialised step is held to that)."""
    B, S, Fs, D = frame_hidden.shape
    frames = torch.arange(num_frames, device=frame_hidden.device)
    onehot = ((sub_frame_idx.reshape(B, S * Fs, 1) == frames)
              * valid.reshape(B, S * Fs, 1)).float()
    return torch.bmm(onehot.transpose(1, 2),
                     frame_hidden.reshape(B, S * Fs, D).float())


def _flatten_subs(batch: Dict[str, torch.Tensor]):
    """(B, S, ...) -> (B*S, ...) views of the f-level inputs."""
    B, S, Lt = batch["sub_input_ids"].shape
    Fs = batch["sub_frame_idx"].shape[2]

    def flat(x):
        return x.reshape((B * S,) + tuple(x.shape[2:]))

    return B, S, Lt, Fs, flat


def _packed_extras(batch: Dict[str, torch.Tensor], flat
                   ) -> Optional[Dict[str, torch.Tensor]]:
    """Sub-packing extras for the f-encoder, or None for an unpacked batch
    (presence of ``sub_txt_seg`` marks a packed batch)."""
    if "sub_txt_seg" not in batch:
        return None
    return {"txt_seg": flat(batch["sub_txt_seg"]),
            "txt_pos": flat(batch["sub_txt_pos"]),
            "frame_seg": flat(batch["sub_frame_seg"]),
            "frame_pos": flat(batch["sub_frame_pos"])}


def forward_repr(p: Params, cfg: HeroConfig, batch: Dict[str, torch.Tensor],
                 *, encode_clip: bool = True, train: bool = False,
                 seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stage-1 fused encoding per sub row -> scatter onto the clip timeline
    -> residual with the projected raw features -> stage-2 temporal
    encoding.  Returns (B, F, D) (``hero_tpu/models/model.py:198-260``),
    or with ``encode_clip=False`` the c-encoder's input (FOM shuffles it
    first).  ``train`` with a ``seed`` turns on every dropout site."""
    B, S, Lt, Fs, flat = _flatten_subs(batch)
    c_v_feats = batch["c_v_feats"]
    sub_v_feats = gather_sub_frames(c_v_feats, batch["sub_frame_idx"])
    sub_v_feats = sub_v_feats * batch["sub_frame_mask"][..., None].to(
        sub_v_feats.dtype)
    seq_out = enc.cross_modal_repr(
        p["f_encoder"], cfg.f_config,
        flat(batch["sub_input_ids"]), flat(batch["sub_txt_mask"]),
        flat(sub_v_feats), flat(batch["sub_frame_mask"]),
        packed=_packed_extras(batch, flat), train=train,
        seed=nn.rng_for(seed, "f_enc"), dtype=dtype)
    transformed = _clip_inputs(p, cfg, batch, seq_out, c_v_feats, train,
                               seed, dtype)
    if not encode_clip:
        return transformed
    # sequence parallelism (dist.enable_seq_parallel), here alone, as the
    # JAX package applies it (hero_tpu/models/model.py:252-256)
    trm = (enc.temporal_trm_seq_parallel if dist.seq_parallel()
           else enc.temporal_trm)
    return trm(p["c_encoder"], cfg.c_config, transformed,
               batch["c_attn_masks"], train=train,
               seed=nn.rng_for(seed, "c_enc"), dtype=dtype)


def _clip_inputs(p: Params, cfg: HeroConfig, batch, seq_out, c_feats_in,
                 train: bool, seed: Optional[int], dtype) -> torch.Tensor:
    """The c-encoder's input (B, F, D): the f-encoder's frame outputs
    scattered onto the clip timeline plus ``frame_transform`` of
    ``c_feats_in`` (B, F, vdim)."""
    B, S, Fs = batch["sub_frame_idx"].shape
    frame_part = seq_out[:, :Fs].reshape(B, S, Fs, -1)
    valid = batch["sub_frame_mask"] * batch["sub_mask"][..., None]
    matched = collect_frame_outputs(frame_part, batch["sub_frame_idx"],
                                    valid, c_feats_in.shape[1])
    transformed = nn.linear_layer(
        p["frame_transform"], c_feats_in.to(dtype), relu=True,
        dropout_rate=cfg.f_config.hidden_dropout_prob if train else 0.0,
        seed=nn.rng_for(seed, "frame_tf"), dtype=dtype)
    return transformed + matched.to(dtype)


def forward_txt(p: Params, cfg: HeroConfig, input_ids, attn_mask, *,
                train: bool = False, seed: Optional[int] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Text-only path through the f-encoder ('txt' mode)."""
    return enc.cross_modal_txt(p["f_encoder"], cfg.f_config, input_ids,
                               attn_mask, train=train, seed=seed,
                               dtype=dtype)


def streamed_lse(logits: torch.Tensor) -> torch.Tensor:
    """fp32 log-sum-exp over the last axis of logits kept in the model
    dtype (``hero_tpu/models/model.py:300-313``): the row max is held
    constant (no gradient), so the backward is the exact softmax.  Shared
    by :func:`masked_cross_entropy` and TVC's label-smoothing loss."""
    m = logits.detach().amax(-1, keepdim=True).float()
    return m[..., 0] + torch.log(torch.exp(logits.float() - m).sum(-1))


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the cross entropy over labels != ignore_index, their count)
    (``hero_tpu/models/model.py:316-332``), through :func:`streamed_lse`."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    lse = streamed_lse(logits)
    picked = logits.gather(-1, safe[..., None])[..., 0].float()
    nll = torch.where(valid, lse - picked, 0.0)
    return nll.sum(), valid.sum().float()


def feat_regress(p: Params, x: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """FrameFeatureRegression: linear -> GELU -> LayerNorm -> linear to
    the feature width (``hero_tpu/models/model.py:67-70``)."""
    h = nn.gelu(nn.linear(p["dense_1"], x, dtype))
    h = nn.apply_layer_norm(p["ln"], h)
    return nn.linear(p["dense_2"], h, dtype)


# ---------------------------------------------------------------------------
# MLM
# ---------------------------------------------------------------------------

def forward_mlm(p: Params, cfg: HeroConfig, batch: Dict[str, torch.Tensor],
                *, compute_loss: bool = True, train: bool = False,
                seed: Optional[int] = None,
                dtype: torch.dtype = torch.float32):
    """Masked subtitle-word prediction (``hero_tpu/models/model.py:
    274-297``): ``mlm_mask_pos`` (B, S, M) indexes text slots,
    ``mlm_labels`` (B, S, M) holds vocab ids or -1.  Returns the logits
    (B*S, M, vocab), or (sum of the cross entropy, valid count)."""
    B, S, Lt, Fs, flat = _flatten_subs(batch)
    sub_v_feats = gather_sub_frames(batch["c_v_feats"],
                                    batch["sub_frame_idx"])
    sub_v_feats = sub_v_feats * batch["sub_frame_mask"][..., None].to(
        sub_v_feats.dtype)
    logits = enc.cross_modal_mlm(
        p["f_encoder"], cfg.f_config,
        flat(batch["sub_input_ids"]), flat(batch["sub_txt_mask"]),
        flat(sub_v_feats), flat(batch["sub_frame_mask"]),
        flat(batch["mlm_mask_pos"]), packed=_packed_extras(batch, flat),
        train=train, seed=nn.rng_for(seed, "f_enc"), dtype=dtype)
    if not compute_loss:
        return logits
    return masked_cross_entropy(logits, flat(batch["mlm_labels"]))


# ---------------------------------------------------------------------------
# MFM (masked frame modelling: regression / NCE)
# ---------------------------------------------------------------------------

def forward_mfm(p: Params, cfg: HeroConfig, batch: Dict[str, torch.Tensor],
                *, loss: str = "nce", compute_loss: bool = True,
                train: bool = False, seed: Optional[int] = None,
                dtype: torch.dtype = torch.float32,
                mask_prob: float = 0.15):
    """Masked frame modelling (``hero_tpu/models/model.py:339-416``, its
    per-slot projection path).  ``c_v_masks`` (B, F), 1 = masked frame:
    the masked clip features are zeroed; stage 1 takes the zeroed
    features with the f-level mask flags (gathered from ``c_v_masks``
    through ``sub_frame_idx``, so ``img_embeddings/mask_emb`` is added),
    stage 2 ``frame_transform`` of the zeroed features plus the c-level
    ``mask_embedding``.  Returns the predicted features (B, F, vdim), or
    the loss pair: ``loss="regression"`` (MFFR) the summed squared error
    over masked valid frames and their count times vdim, ``"nce"`` the
    contrastive :func:`_mfm_nce_loss`."""
    assert loss in ("regression", "nce")
    c_mask = batch["c_v_masks"].float()                      # (B, F)
    c_v_feats = batch["c_v_feats"] * (1.0 - c_mask)[..., None]
    c_v_feats_in = c_v_feats + nn.embedding_lookup(
        p["mask_embedding"], c_mask.long(), c_v_feats.dtype)
    B, S, Lt, Fs, flat = _flatten_subs(batch)
    f_img_masks = c_mask.gather(1, batch["sub_frame_idx"].reshape(
        B, S * Fs).long()).reshape(B, S, Fs)
    sub_v_feats = gather_sub_frames(c_v_feats, batch["sub_frame_idx"])
    sub_v_feats = sub_v_feats * batch["sub_frame_mask"][..., None].to(
        sub_v_feats.dtype)
    seq_out = enc.cross_modal_repr(
        p["f_encoder"], cfg.f_config,
        flat(batch["sub_input_ids"]), flat(batch["sub_txt_mask"]),
        flat(sub_v_feats), flat(batch["sub_frame_mask"]),
        img_masks=flat(f_img_masks), packed=_packed_extras(batch, flat),
        train=train, seed=nn.rng_for(seed, "f_enc"), dtype=dtype)
    transformed = _clip_inputs(p, cfg, batch, seq_out, c_v_feats_in, train,
                               seed, dtype)
    clip_out = enc.temporal_trm(p["c_encoder"], cfg.c_config, transformed,
                                batch["c_attn_masks"], train=train,
                                seed=nn.rng_for(seed, "c_enc"), dtype=dtype)
    pred = feat_regress(p["feat_regress"], clip_out, dtype)  # (B, F, vdim)
    if not compute_loss:
        return pred

    targets = batch["c_v_feats"].float()
    frame_valid = batch["c_attn_masks"].float()
    masked = c_mask * frame_valid
    if loss == "regression":
        err = (pred.float() - targets).square().sum(-1)
        return (err * masked).sum(), masked.sum() * targets.shape[-1]
    # rule (b) of parallel/dist: the NCE contrasts every masked frame with
    # the global batch's targets and predictions, so its inputs are the
    # gathered rows, the row cap and the masked-first order the global
    # batch's; (sum, count) are then the global batch's on every rank
    g = dist.gather_rows
    return _mfm_nce_loss(g(pred), g(targets), g(masked),
                         g(frame_valid * (1.0 - c_mask)), cfg.nce_temp,
                         mask_prob=mask_prob)


def _mfm_nce_row_cap(mask_prob: float, N: int, n_clips: int = 0) -> int:
    """Static cap on the NCE rows (``hero_tpu/models/model.py:419-436``):
    the configured mask rate plus a binomial tail margin of max(0.1, 6
    sigma at N), plus one forced row a clip, rounded up to 128 (896 at
    mask_prob 0.15, N = 3200, 32 clips).  Rows past the cap would leave
    the loss and its count alike."""
    margin = max(0.1, 6.0 * math.sqrt(mask_prob * (1.0 - mask_prob)
                                      / max(N, 1)))
    rows = min(N, int(min(1.0, mask_prob + margin) * N) + n_clips)
    return min(N, max((rows + 127) // 128 * 128, 128))


class _MatmulF32(torch.autograd.Function):
    """``a @ b.T`` with fp32 logits from bf16 operands on the card: one
    cuBLAS product that accumulates and writes fp32
    (``torch.mm(..., out_dtype=torch.float32)``), as the JAX package's
    ``preferred_element_type=float32``; the operands stay bf16.  The
    gradients are bf16 products of the cotangent rounded to bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b.T, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b, g.T @ a


def _logits_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, N) fp32 ``a @ b.T`` of two (., V) operands in the model dtype.
    fp32 operands: a plain fp32 product.  bf16 on the card: one bf16
    product with fp32 output (:class:`_MatmulF32`).  bf16 on the CPU: the
    bf16 product, widened (the CPU has no mixed-output product)."""
    if a.dtype == torch.float32:
        return a @ b.T
    if a.is_cuda:
        return _MatmulF32.apply(a, b)
    return (a @ b.T).float()


def _mfm_nce_loss(pred: torch.Tensor, targets: torch.Tensor,
                  masked: torch.Tensor, unmasked: torch.Tensor, temp: float,
                  mask_prob: float = 0.15
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contrastive MFM (``hero_tpu/models/model.py:439-483``): each masked
    frame's prediction scores [every masked target ; every unmasked
    prediction], its label its own column.  The masked rows come first by
    a stable sort of the mask, capped at :func:`_mfm_nce_row_cap` rows, so
    the two products are (M, N)-shaped with no host read of the mask;
    columns of dropped rows carry -1e4 logits, which the fp32 softmax
    sends to exactly 0.  Returns (sum of the row losses, row count)."""
    B, F, V = pred.shape
    N = B * F
    predf = pred.reshape(N, V)
    tgtf = targets.to(pred.dtype).reshape(N, V)
    mflat, uflat = masked.reshape(N), unmasked.reshape(N)
    M = _mfm_nce_row_cap(mask_prob, N, n_clips=B)
    sel = torch.argsort(mflat, descending=True, stable=True)[:M]
    row_valid = mflat[sel]                                   # (M,)
    pred_m = predf[sel]                                      # (M, V)
    pos_logits = nn.mask_logits(_logits_f32(pred_m, tgtf[sel]),
                                row_valid[None, :])          # (M, M)
    neg_logits = nn.mask_logits(_logits_f32(pred_m, predf),
                                uflat[None, :])              # (M, N)
    logits = torch.cat([pos_logits, neg_logits], dim=1) / temp
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.diagonal()
    return (nll * row_valid).sum(), row_valid.sum()


# ---------------------------------------------------------------------------
# FOM (frame order modelling)
# ---------------------------------------------------------------------------

def forward_fom(p: Params, cfg: HeroConfig, batch: Dict[str, torch.Tensor],
                *, compute_loss: bool = True, train: bool = False,
                seed: Optional[int] = None,
                dtype: torch.dtype = torch.float32):
    """Frame order modelling (``hero_tpu/models/model.py:486-509``): the
    c-encoder's input moved to the shuffled slots, re-encoded, and each
    slot classified by its original position.  ``shuffled_orders`` (B, F)
    is a permutation (frame i goes to slot ``shuffled_orders[i]``), so the
    move is an index scatter, exact (the JAX package multiplies by its
    one-hot on the matrix unit); ``fom_targets`` (B, F) hold the original
    position or -1.  Returns the logits (B, F, max_clip_len) or the loss
    pair."""
    feats = forward_repr(p, cfg, batch, encode_clip=False, train=train,
                         seed=seed, dtype=dtype)             # (B, F, D)
    dest = batch["shuffled_orders"].long()[..., None].expand_as(feats)
    shuffled = torch.zeros_like(feats).scatter(1, dest, feats)
    clip_out = enc.temporal_trm(p["c_encoder"], cfg.c_config, shuffled,
                                batch["c_attn_masks"], train=train,
                                seed=nn.rng_for(seed, "c_enc"), dtype=dtype)
    logits = nn.mlp_layer(p["fom_output"], clip_out, dtype)
    if not compute_loss:
        return logits
    return masked_cross_entropy(logits, batch["fom_targets"])


# the JAX tree's task heads that only pretraining reads (MLM's tied LM
# head, MFM's two mask embeddings and feature regression, FOM's head)
TASK_HEADS = (("f_encoder", "lm_head"), ("f_encoder", "img_embeddings",
                                         "mask_emb"),
              ("feat_regress",), ("mask_embedding",), ("fom_output",))


def without_task_heads(params: Params) -> Params:
    """The parameter tree without the pretraining task heads
    (:data:`TASK_HEADS`, under ``v_encoder``): what the serving paths
    move to the card."""
    def drop(tree, path):
        if len(path) == 1:
            return {k: v for k, v in tree.items() if k != path[0]}
        if path[0] not in tree:
            return tree
        return {**tree, path[0]: drop(tree[path[0]], path[1:])}

    v = params["v_encoder"]
    for path in TASK_HEADS:
        v = drop(v, path)
    return {**params, "v_encoder": v}
