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

from typing import Any, Dict, Optional

import torch

from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.models import encoder as enc
from hero_tpu_torch.models import nn

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
    fp32.  The JAX package does this as a one-hot matmul on the TPU's
    matrix unit; here it is ``index_add_`` accumulated in fp32."""
    B, S, Fs, D = frame_hidden.shape
    src = (frame_hidden.float() * valid[..., None].float()).reshape(-1, D)
    base = torch.arange(B, device=frame_hidden.device)[:, None] * num_frames
    index = (base + sub_frame_idx.reshape(B, S * Fs).long()).reshape(-1)
    out = torch.zeros((B * num_frames, D), dtype=torch.float32,
                      device=frame_hidden.device)
    out.index_add_(0, index, src)
    return out.reshape(B, num_frames, D)


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
                 *, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stage-1 fused encoding per sub row -> scatter onto the clip timeline
    -> residual with the projected raw features -> stage-2 temporal
    encoding.  Returns (B, F, D) (``hero_tpu/models/model.py:198-260``)."""
    B, S, Lt, Fs, flat = _flatten_subs(batch)
    c_v_feats = batch["c_v_feats"]
    F = c_v_feats.shape[1]

    sub_v_feats = gather_sub_frames(c_v_feats, batch["sub_frame_idx"])
    sub_v_feats = sub_v_feats * batch["sub_frame_mask"][..., None].to(
        sub_v_feats.dtype)
    seq_out = enc.cross_modal_repr(
        p["f_encoder"], cfg.f_config,
        flat(batch["sub_input_ids"]), flat(batch["sub_txt_mask"]),
        flat(sub_v_feats), flat(batch["sub_frame_mask"]),
        packed=_packed_extras(batch, flat), dtype=dtype)

    frame_part = seq_out[:, :Fs].reshape(B, S, Fs, -1)
    valid = batch["sub_frame_mask"] * batch["sub_mask"][..., None]
    matched = collect_frame_outputs(frame_part, batch["sub_frame_idx"],
                                    valid, F)
    transformed = nn.linear_layer(p["frame_transform"], c_v_feats.to(dtype),
                                  relu=True, dtype=dtype)
    transformed = transformed + matched.to(dtype)
    return enc.temporal_trm(p["c_encoder"], cfg.c_config, transformed,
                            batch["c_attn_masks"], dtype=dtype)


def forward_txt(p: Params, cfg: HeroConfig, input_ids, attn_mask, *,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Text-only path through the f-encoder ('txt' mode)."""
    return enc.cross_modal_txt(p["f_encoder"], cfg.f_config, input_ids,
                               attn_mask, dtype=dtype)
