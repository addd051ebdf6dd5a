"""Initialize the f_encoder from a plain RoBERTa checkpoint (a copy of
``hero_tpu/convert/roberta_init.py``, over the port's converter and
``drivers/common.merge_params``; trees in the JAX layout).

Reference ``load_partial_pretrained`` (``model/model.py:356-364``) +
``load_partial_checkpoint`` (``modeling_utils.py:46-65``): the 12-layer
RoBERTa stack is subsampled by stride (layers gap-1, 2·gap-1, … for a
gap = 12 / n_layers) into the 6-layer cross-modal encoder; the vocab is
padded to a multiple of 8; the type embedding is re-initialized with row 0
copied into row 1 (``encoder.py:287-295``).

Accepts either a HF ``roberta-base`` state dict (``roberta.*`` /
``lm_head.*`` keys) or the fairseq-style naming the reference consumes.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from hero_tpu_torch.convert.torch_checkpoint import (_linear, _ln, _np,
                                                     _pad_vocab, _set,
                                                     _stack_layers,
                                                     normalize_keys)


def subsample_layers(sd: Dict[str, np.ndarray], n_layers: int,
                     prefix: str = "roberta.encoder.layer.",
                     skip_layers: bool = True) -> Dict[str, np.ndarray]:
    """Stride-subsample a 12-layer stack to n_layers (reference gap rule)."""
    if not skip_layers:
        return dict(sd)
    gap = 12 // n_layers
    keep = {str(l): str(i)
            for i, l in enumerate(range(gap - 1, 12, gap))}
    out = {}
    for k, v in sd.items():
        if prefix in k:
            parts = k.split(".")
            lnum = parts[3]
            if lnum in keep:
                parts[3] = keep[lnum]
                out[".".join(parts)] = v
        else:
            out[k] = v
    return out


def roberta_to_f_encoder(state_dict: Dict[str, Any], n_layers: int = 6,
                         vocab_size: int = 50272,
                         hidden: int = 768) -> Dict[str, Any]:
    """HF/fairseq RoBERTa ckpt → f_encoder params subtree (embeddings,
    stacked encoder layers, pooler if present, lm_head)."""
    sd = normalize_keys(state_dict)
    sd = subsample_layers(sd, n_layers)
    tree: Dict[str, Any] = {}
    p = "roberta"

    raw_word = sd[f"{p}.embeddings.word_embeddings.weight"]
    word = _pad_vocab(raw_word, vocab_size)
    # actual pad decision, threaded to ModelSaver (not shape-inferred)
    tree["__vocab_padded__"] = bool(
        np.asarray(raw_word).shape[0] < vocab_size)
    _set(tree, "embeddings/word_emb", word)
    _set(tree, "embeddings/pos_emb",
         sd[f"{p}.embeddings.position_embeddings.weight"])
    # type embedding re-init quirk: RoBERTa has 1 type; HERO uses 2 with
    # row 0 duplicated (reference init_type_embedding)
    type_emb = _np(sd[f"{p}.embeddings.token_type_embeddings.weight"])
    if type_emb.shape[0] == 1:
        type_emb = np.concatenate([type_emb, type_emb], 0)
    else:
        type_emb = type_emb.copy()
        type_emb[1] = type_emb[0]
    _set(tree, "embeddings/type_emb", type_emb)
    _ln(tree, "embeddings/ln", sd, f"{p}.embeddings.LayerNorm")

    _stack_layers(tree, "encoder/layers", sd, f"{p}.encoder.layer",
                  n_layers)
    if f"{p}.pooler.dense.weight" in sd:
        _linear(tree, "pooler/dense", sd, f"{p}.pooler.dense")
    if "lm_head.dense.weight" in sd:
        _linear(tree, "lm_head/dense", sd, "lm_head.dense")
        _ln(tree, "lm_head/ln", sd, "lm_head.layer_norm")
        _set(tree, "lm_head/bias", _pad_vocab(sd["lm_head.bias"],
                                              vocab_size))
    return tree


def init_f_encoder_from_roberta(params: Dict[str, Any],
                                state_dict: Dict[str, Any],
                                n_layers: int = 6,
                                vocab_size: int = 50272) -> Dict[str, Any]:
    """Overlay a RoBERTa checkpoint onto freshly-initialized HERO params
    (the reference's pretraining init path)."""
    from hero_tpu_torch.drivers.common import merge_params
    sub = roberta_to_f_encoder(state_dict, n_layers, vocab_size)
    new_f = merge_params(params["v_encoder"]["f_encoder"], sub)
    out = dict(params)
    out["v_encoder"] = dict(params["v_encoder"])
    out["v_encoder"]["f_encoder"] = new_f
    return out
