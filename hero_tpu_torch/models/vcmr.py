"""Moment-retrieval and video-retrieval heads (counterpart of
``hero_tpu/models/vcmr.py``): the finetune forwards, which are the VSM
forward (:func:`forward_vcmr`, and :func:`forward_vr` without the span
path), the phase-1 corpus embedding, and the inference scorers of a query
batch against a (sub-)corpus of frame embeddings."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.models import model as backbone
from hero_tpu_torch.models import pretrain
from hero_tpu_torch.models.pretrain import VsmConfig

Params = Dict[str, Any]

VCMR_TASKS = ("tvr", "how2r", "didemo_video_sub", "didemo_video_only")
VR_TASKS = ("msrvtt_video_sub", "msrvtt_video_only")

# the flat JAX-layout init of the pretraining tree, which VCMR and VR
# finetune (``hero_tpu/models/vcmr.py:26``)
init_hero_for_vcmr = pretrain.init_flat_params


def forward_vcmr(params: Params, cfg: HeroConfig, vsm: VsmConfig,
                 batch: Dict[str, torch.Tensor], *, compute_loss: bool = True,
                 train: bool = False, seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, **vsm_kw):
    """VCMR finetune forward = the VSM forward (reference
    model/vcmr.py:29-35; ``hero_tpu/models/vcmr.py:29-35``): its three
    losses, or with ``compute_loss=False`` (scores, st, ed)."""
    return pretrain.forward_vsm(params, cfg, vsm, batch,
                                compute_loss=compute_loss, train=train,
                                seed=seed, dtype=dtype, **vsm_kw)


def forward_vr(params: Params, cfg: HeroConfig, vsm: VsmConfig,
               batch: Dict[str, torch.Tensor], *, compute_loss: bool = True,
               train: bool = False, seed: Optional[int] = None,
               dtype: torch.dtype = torch.float32, **vsm_kw):
    """VR = VCMR without the span path (reference model/vr.py:12-45;
    ``hero_tpu/models/vcmr.py:38-53``): ``vsm.lw_st_ed`` must be 0 and a
    ranking weight not 0.  Returns (loss_neg_ctx, loss_neg_q), or the
    (B*Q, B) scores with ``compute_loss=False``."""
    assert vsm.lw_st_ed == 0, "For VR, lw_st_ed should be 0"
    assert vsm.lw_neg_ctx != 0 or vsm.lw_neg_q != 0
    out = pretrain.forward_vsm(params, cfg, vsm, batch,
                               compute_loss=compute_loss,
                               compute_st_ed=False, train=train, seed=seed,
                               dtype=dtype, **vsm_kw)
    if compute_loss:
        _, loss_neg_ctx, loss_neg_q = out
        return loss_neg_ctx, loss_neg_q
    scores, _, _ = out
    return scores


def encode_video_corpus(params: Params, cfg: HeroConfig,
                        batch: Dict[str, torch.Tensor],
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Phase-1 corpus embedding: the backbone 'repr' forward on a video
    batch.  Returns (Nv, F, D)."""
    return backbone.forward_repr(params["v_encoder"], cfg, batch,
                                 dtype=dtype)


def get_pred_from_raw_query(params: Params, cfg: HeroConfig, vsm: VsmConfig,
                            frame_embeddings: torch.Tensor,
                            c_attn_masks: torch.Tensor,
                            query_input_ids: torch.Tensor,
                            query_attn_masks: torch.Tensor, *,
                            cross: bool = True,
                            dtype: torch.dtype = torch.float32
                            ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                       torch.Tensor]:
    """Phase-2 query scoring against frame_embeddings (Nv, F, D); queries
    (Nq, Lq) (``hero_tpu/models/vcmr.py:66-90``).  Returns
    (q2video scores (Nq, Nv), or None when both ranking weights are 0,
    st_logits, ed_logits): the span logits are (Nq, Nv, F) in cross mode,
    (N, F) paired (query n against video n)."""
    mod_query = pretrain.encode_query(params, cfg, query_input_ids,
                                      query_attn_masks, dtype=dtype)
    fmask = c_attn_masks.float()
    head = params["head"]
    if cross:
        st, ed = pretrain.conv_st_ed_masked(
            head, pretrain.get_st_ed_sim(head, mod_query, frame_embeddings),
            fmask[None])
    else:
        st, ed = (x[:, 0] for x in pretrain.get_st_ed_logits(
            head, mod_query[:, None], frame_embeddings, fmask))
    scores = None
    if vsm.lw_neg_ctx != 0 or vsm.lw_neg_q != 0:
        scores = pretrain.get_video_level_scores(mod_query,
                                                 frame_embeddings, fmask)
    return scores, st, ed


def get_vr_scores_from_raw_query(params: Params, cfg: HeroConfig,
                                 frame_embeddings: torch.Tensor,
                                 c_attn_masks: torch.Tensor,
                                 query_input_ids: torch.Tensor,
                                 query_attn_masks: torch.Tensor,
                                 dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """VR inference: the (Nq, Nv) video-level scores only
    (``hero_tpu/models/vcmr.py:93-103``).  No serving path of the port
    calls it (the serving paths rank through
    :func:`get_pred_from_raw_query` or ``evaluation/vcmr_eval``'s resident
    scorer); it is kept as the public counterpart of the JAX function and
    held against it by ``tests/test_torch_vcmr_serve.py``."""
    mod_query = pretrain.encode_query(params, cfg, query_input_ids,
                                      query_attn_masks, dtype=dtype)
    return pretrain.get_video_level_scores(mod_query, frame_embeddings,
                                           c_attn_masks.float())
