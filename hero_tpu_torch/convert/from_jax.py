"""Bridge from JAX parameters to the port's parameter tree.

Input: the flat ``{"a/b/c": np.ndarray}`` dict of the JAX package's
``flatten_tree`` -- also what ``np.load`` of a JAX ``model_step_N.npz``
checkpoint gives.  In the JAX layout linear kernels are ``(in, out)`` and
the encoder layers are stacked on a leading axis.  The port's tree
(``models/nn.py``) has ``(out, in)`` linear weights, LayerNorm
``weight``/``bias``, one fused ``qkv`` projection per self-attention block
(rows ordered query, key, value), and a list of per-layer dicts per encoder.

The bridge fails on any missing or unexpected key: every JAX key is either
read into the port's tree or named in :data:`UNUSED_JAX_KEYS`.

The map is linear (transpose, concatenation, per-layer split), so it
carries any tree shaped like the parameters: AdamW's ``mu`` and ``nu``
(:func:`load_jax_train_state`, which resumes a JAX run in the port) and
gradients (the tests compare the port's with ``jax.grad``'s through it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Set, Tuple

import numpy as np
import torch

from hero_tpu_torch import resolve_device

# JAX keys of modules outside the serving slice: the f-encoder pooler and
# tied LM head (MLM), the MFM frame-mask embeddings and feature regression,
# the FOM head, and the c-encoder pooler.
UNUSED_JAX_KEYS = frozenset({
    "v_encoder/f_encoder/pooler/dense/kernel",
    "v_encoder/f_encoder/pooler/dense/bias",
    "v_encoder/f_encoder/lm_head/dense/kernel",
    "v_encoder/f_encoder/lm_head/dense/bias",
    "v_encoder/f_encoder/lm_head/ln/scale",
    "v_encoder/f_encoder/lm_head/ln/bias",
    "v_encoder/f_encoder/lm_head/bias",
    "v_encoder/f_encoder/img_embeddings/mask_emb",
    "v_encoder/c_encoder/pooler/dense/kernel",
    "v_encoder/c_encoder/pooler/dense/bias",
    "v_encoder/feat_regress/dense_1/kernel",
    "v_encoder/feat_regress/dense_1/bias",
    "v_encoder/feat_regress/ln/scale",
    "v_encoder/feat_regress/ln/bias",
    "v_encoder/feat_regress/dense_2/kernel",
    "v_encoder/feat_regress/dense_2/bias",
    "v_encoder/mask_embedding",
    "v_encoder/fom_output/linear_1/kernel",
    "v_encoder/fom_output/linear_1/bias",
    "v_encoder/fom_output/ln/scale",
    "v_encoder/fom_output/ln/bias",
    "v_encoder/fom_output/linear_2/kernel",
    "v_encoder/fom_output/linear_2/bias",
})

Getter = Callable[[str], torch.Tensor]


def _linear(get: Getter, key: str, bias: bool = True) -> Dict[str, Any]:
    out = {"weight": get(f"{key}/kernel").transpose(-1, -2).contiguous()}
    if bias:
        out["bias"] = get(f"{key}/bias")
    return out


def _ln(get: Getter, key: str) -> Dict[str, Any]:
    return {"weight": get(f"{key}/scale"), "bias": get(f"{key}/bias")}


def _attention(get: Getter, key: str) -> Dict[str, Any]:
    q, k, v = (_linear(get, f"{key}/{n}") for n in ("query", "key", "value"))
    return {"qkv": {"weight": torch.cat([q["weight"], k["weight"],
                                         v["weight"]], -2),
                    "bias": torch.cat([q["bias"], k["bias"], v["bias"]], -1)},
            "out": _linear(get, f"{key}/out"),
            "out_ln": _ln(get, f"{key}/out_ln")}


def _encoder(get: Getter, key: str) -> Dict[str, Any]:
    """Stacked (n_layers, ...) JAX layers -> a list of per-layer dicts."""
    stacked = {
        "attention": _attention(get, f"{key}/layers/attention"),
        "ffn": {"intermediate": _linear(get, f"{key}/layers/ffn/intermediate"),
                "output": _linear(get, f"{key}/layers/ffn/output"),
                "ln": _ln(get, f"{key}/layers/ffn/ln")},
    }

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i]

    n = stacked["attention"]["out_ln"]["weight"].shape[0]
    return {"layers": [layer(stacked, i) for i in range(n)]}


def _port_tree(get: Getter) -> Dict[str, Any]:
    fe, ce = "v_encoder/f_encoder", "v_encoder/c_encoder"
    qa = "head/q_feat_attn"
    return {
        "v_encoder": {
            "f_encoder": {
                "embeddings": {
                    "word_emb": get(f"{fe}/embeddings/word_emb"),
                    "pos_emb": get(f"{fe}/embeddings/pos_emb"),
                    "type_emb": get(f"{fe}/embeddings/type_emb"),
                    "ln": _ln(get, f"{fe}/embeddings/ln")},
                "img_embeddings": {
                    "img_ln": _ln(get, f"{fe}/img_embeddings/img_ln"),
                    "img_linear": _linear(get,
                                          f"{fe}/img_embeddings/img_linear"),
                    "pos_emb": get(f"{fe}/img_embeddings/pos_emb"),
                    "ln": _ln(get, f"{fe}/img_embeddings/ln")},
                "encoder": _encoder(get, f"{fe}/encoder")},
            "frame_transform": {
                "dense": _linear(get, "v_encoder/frame_transform/dense"),
                "ln": _ln(get, "v_encoder/frame_transform/ln")},
            "c_encoder": {
                "embeddings": {
                    "pos_emb": get(f"{ce}/embeddings/pos_emb"),
                    "ln": _ln(get, f"{ce}/embeddings/ln")},
                "encoder": _encoder(get, f"{ce}/encoder")},
        },
        "head": {
            "video_query_linear": _linear(get, "head/video_query_linear"),
            "video_st_predictor": {
                "kernel": get("head/video_st_predictor/kernel")},
            "video_ed_predictor": {
                "kernel": get("head/video_ed_predictor/kernel")},
            "q_feat_attn": {
                "query_input_proj": {
                    "dense": _linear(get, f"{qa}/query_input_proj/dense"),
                    "ln": _ln(get, f"{qa}/query_input_proj/ln")},
                "pos_embed": {
                    "pos_emb": get(f"{qa}/pos_embed/pos_emb"),
                    "ln": _ln(get, f"{qa}/pos_embed/ln")},
                "attention": _attention(get, f"{qa}/attention"),
                "modular_vector": _linear(get, f"{qa}/modular_vector",
                                          bias=False)},
        },
    }


def convert(flat: Mapping[str, np.ndarray], device="cuda"
            ) -> Tuple[Dict[str, Any], Set[str]]:
    """(port tree on ``device``, the JAX keys it was built from)."""
    device = resolve_device(device)
    used: Set[str] = set()

    def get(key: str) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"JAX parameter {key!r} is missing")
        used.add(key)
        return torch.from_numpy(
            np.array(flat[key], dtype=np.float32)).to(device)

    return _port_tree(get), used


def load_jax_params(flat: Mapping[str, np.ndarray], device="cuda"
                    ) -> Dict[str, Any]:
    """The port's fp32 parameter tree from flat JAX parameters.  Raises
    KeyError if a key is missing or not accounted for."""
    params, used = convert(flat, device)
    missing = UNUSED_JAX_KEYS - set(flat)
    unexpected = set(flat) - used - UNUSED_JAX_KEYS
    if missing or unexpected:
        raise KeyError(f"JAX parameters do not match the port: missing "
                       f"{sorted(missing)}, unexpected {sorted(unexpected)}")
    return params


def load_jax_train_state(flat_params: Mapping[str, np.ndarray],
                         flat_mu: Mapping[str, np.ndarray],
                         flat_nu: Mapping[str, np.ndarray], opt_step: int,
                         global_step: int, device="cuda"):
    """The port's ``TrainState`` from the flat parameters, AdamW moments
    and step counters of a JAX ``TrainState``.  The moments of the JAX
    keys outside the slice (:data:`UNUSED_JAX_KEYS`) are dropped with
    their parameters."""
    from hero_tpu_torch.training.optim import AdamWState
    from hero_tpu_torch.training.step import TrainState
    return TrainState(
        params=load_jax_params(flat_params, device),
        opt=AdamWState(step=int(opt_step),
                       mu=load_jax_params(flat_mu, device),
                       nu=load_jax_params(flat_nu, device)),
        global_step=int(global_step))
