"""HeroForVideoQA: multiple-choice QA with span supervision (counterpart
of ``hero_tpu/models/videoqa.py``; reference ``model/videoQA.py:21-112``).

The backbone rows are (video x answer) pairs: B' = Nv * A rows, every A
consecutive rows one video with a different question-answer text.
Extras of the batch:

- ``qa_input_ids`` / ``qa_attn_masks`` (B', Lqa): ``[SEP] q [SEP] a``
  ids appended after the frames for the temporal encoder;
- ``targets`` (Nv,) answer index or -1;
- ``ts_targets`` (Nv, 2) start/end frame index or -1;
- ``num_answers`` A, a Python int (5 for TVQA/How2QA).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from hero_tpu_torch.config.model_config import HeroConfig
from hero_tpu_torch.models import embed, nn, transformer
from hero_tpu_torch.models import model as backbone
from hero_tpu_torch.models.pretrain import FlatInit, init_flat_v_encoder
from hero_tpu_torch.parallel import dist

Params = Dict[str, Any]


def init_hero_for_videoqa(cfg: HeroConfig, seed: int = 0
                          ) -> Dict[str, np.ndarray]:
    """Random weights in the flat JAX layout of ``init_hero_for_videoqa``
    (``hero_tpu/models/videoqa.py:32-43``): the backbone's ``v_encoder``
    keys (``pretrain.init_flat_v_encoder``) and ``head/qa_pool``,
    ``qa_pred_head``, ``st_ed_pool``, ``st_ed_pred_head``, with the JAX
    init's distributions."""
    it = FlatInit(seed)
    init_flat_v_encoder(it, cfg)
    D = cfg.c_config.hidden_size
    it.linear("head/qa_pool", D, 1, bias=False)
    it.mlp_layer("head/qa_pred_head", D, 1)
    it.linear("head/st_ed_pool", D, 1, bias=False)
    it.mlp_layer("head/st_ed_pred_head", D, 2)
    return it.flat


def _fuse_video_text(params: Params, cfg: HeroConfig,
                     batch: Dict[str, torch.Tensor], txt_ids: torch.Tensor,
                     txt_mask: torch.Tensor, *, train: bool = False,
                     seed: Optional[int] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The VideoQA/VIOLIN fusion (reference videoQA.py:68-85;
    ``hero_tpu/models/videoqa.py:46-75``): the c-encoder's input frames
    with its frame position embeddings, then the text embedded by the
    f-encoder's embeddings, both through the c-encoder behind the mask
    ``[frames | text]`` (valid frames, pad frames, valid tokens, pad
    tokens: not a prefix).  Returns the frame part (B', F, D)."""
    ve = params["v_encoder"]
    c_rate = cfg.c_config.hidden_dropout_prob if train else 0.0
    f_rate = cfg.f_config.hidden_dropout_prob if train else 0.0
    frame_feats = backbone.forward_repr(ve, cfg, batch, encode_clip=False,
                                        train=train,
                                        seed=nn.rng_for(seed, "repr"),
                                        dtype=dtype)
    frame_emb = embed.frame_embeddings(
        ve["c_encoder"]["embeddings"], frame_feats, dropout_rate=c_rate,
        seed=nn.rng_for(seed, "fpos"), dtype=dtype)
    txt_emb = embed.sub_embeddings(
        ve["f_encoder"]["embeddings"], txt_ids, dropout_rate=f_rate,
        seed=nn.rng_for(seed, "txt"), dtype=dtype)
    fused_in = torch.cat([frame_emb, txt_emb], dim=1)
    fused_mask = torch.cat([batch["c_attn_masks"].float(),
                            txt_mask.float()], dim=1)
    fused = transformer.encoder(ve["c_encoder"]["encoder"], fused_in,
                                cfg.c_config, kv_mask=fused_mask,
                                train=train, seed=nn.rng_for(seed, "cenc"),
                                dtype=dtype)
    return fused[:, :frame_feats.shape[1], :]


def get_modularized_video(head: Params, frame_emb: torch.Tensor,
                          frame_mask: torch.Tensor,
                          dtype: torch.dtype = torch.float32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two attention-pooled views (reference videoQA.py:36-59): the span
    view pools over the *answer* axis for each frame, the QA view over the
    *frame* axis for each answer; both softmaxes in fp32.  frame_emb
    (Nv, A, F, D), frame_mask (Nv, A, F) -> ((Nv, F, D), (Nv, A, D))."""
    st_scores = nn.linear(head["st_ed_pool"], frame_emb, dtype)  # (Nv,A,F,1)
    qa_scores = nn.linear(head["qa_pool"], frame_emb, dtype)
    st_scores = nn.mask_logits(st_scores, frame_mask[..., None])
    qa_scores = nn.mask_logits(qa_scores, frame_mask[..., None])
    st_att = torch.softmax(st_scores.float(), dim=1)
    qa_att = torch.softmax(qa_scores.float(), dim=2)
    st_pooled = torch.einsum("vqlm,vqld->vlmd", st_att.to(dtype),
                             frame_emb.to(dtype))[:, :, 0]
    qa_pooled = torch.einsum("vqlm,vqld->vqmd", qa_att.to(dtype),
                             frame_emb.to(dtype))[:, :, 0]
    return st_pooled, qa_pooled


def forward_videoqa(params: Params, cfg: HeroConfig,
                    batch: Dict[str, torch.Tensor], *, num_answers: int = 5,
                    compute_loss: bool = True, train: bool = False,
                    seed: Optional[int] = None,
                    dtype: torch.dtype = torch.float32):
    """Reference videoQA.py:61-112 (``hero_tpu/models/videoqa.py:
    97-129``): (qa_loss, temporal_loss), the mean answer cross entropy
    and the mean of the start and end cross entropies over the labelled
    questions, or with ``compute_loss=False`` the fp32 answer logits
    (Nv, A)."""
    video_emb = _fuse_video_text(params, cfg, batch, batch["qa_input_ids"],
                                 batch["qa_attn_masks"], train=train,
                                 seed=seed, dtype=dtype)
    Bp, F, D = video_emb.shape
    Nv = Bp // num_answers
    video_emb = video_emb.reshape(Nv, num_answers, F, D)
    video_masks = batch["c_attn_masks"].reshape(Nv, num_answers, F).float()
    st_pooled, qa_pooled = get_modularized_video(
        params["head"], video_emb, video_masks, dtype)
    pred_st_ed = nn.mlp_layer(params["head"]["st_ed_pred_head"], st_pooled,
                              dtype)                        # (Nv, F, 2)
    st_logits = nn.mask_logits(pred_st_ed[:, :, 0].float(),
                               video_masks[:, 0])
    ed_logits = nn.mask_logits(pred_st_ed[:, :, 1].float(),
                               video_masks[:, 0])
    logits = nn.mlp_layer(params["head"]["qa_pred_head"], qa_pooled,
                          dtype)[..., 0].float()             # (Nv, A)
    if not compute_loss:
        return logits
    targets = batch["targets"].reshape(Nv)
    ts = batch["ts_targets"].reshape(Nv, 2)
    st_s, st_n = backbone.masked_cross_entropy(st_logits, ts[:, 0])
    ed_s, ed_n = backbone.masked_cross_entropy(ed_logits, ts[:, 1])
    # rule (a) of parallel/dist: each question is its own item
    temporal_loss = (dist.global_mean(st_s, st_n)
                     + dist.global_mean(ed_s, ed_n)) / 2.0
    qa_s, qa_n = backbone.masked_cross_entropy(logits, targets)
    qa_loss = dist.global_mean(qa_s, qa_n)
    return qa_loss, temporal_loss
