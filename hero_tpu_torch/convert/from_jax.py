"""Bridge from JAX parameters to the port's parameter tree.

Input: the flat ``{"a/b/c": np.ndarray}`` dict of the JAX package's
``flatten_tree`` -- also what ``np.load`` of a JAX ``model_step_N.npz``
checkpoint gives.  In the JAX layout linear kernels are ``(in, out)`` and
the encoder layers are stacked on a leading axis.  The port's tree
(``models/nn.py``) has ``(out, in)`` linear weights, LayerNorm
``weight``/``bias``, one fused ``qkv`` projection per self-attention block
(rows ordered query, key, value), and a list of per-layer dicts per encoder.

The bridge reads every key of the JAX pretraining, TVC, VideoQA and
VIOLIN trees and fails on any missing or unexpected key.  Each tree holds
the whole backbone: the f- and c-encoder poolers and every pretraining
task head (MLM's tied LM head, MFM's mask embeddings and feature
regression, FOM's head), although no loss of a finetuning task reads
them, because the JAX AdamW decays every parameter every step
(``hero_tpu/training/optim.py:118-150``) and the port's step does the
same.  Only ``load_jax_params(..., heads=False)``, the serving trees,
leaves :data:`TASK_HEAD_JAX_KEYS` unread.

The map is linear (transpose, concatenation, per-layer split), so it
carries any tree shaped like the parameters: AdamW's ``mu`` and ``nu``
(:func:`load_jax_train_state`, which resumes a JAX run in the port) and
gradients (the tests compare the port's with ``jax.grad``'s through it).

The map is also a permutation of elements, which gives its inverse
(:func:`to_jax_params`, :func:`to_jax_train_state`, and for the TVC,
VideoQA and VIOLIN trees ``to_jax_{tvc,videoqa,violin}_params`` and
``..._train_state``; what the port's checkpoints write): the forward
map run over element numbers instead of values says where each element
of the port's tree sits in the JAX layout, and one scatter on the
tensors' device puts it back there.  Every element of the file comes
from the port's tree, so the files of a port run equal a JAX run's at
every key.  The inverse's ``template`` is a flat JAX tree of the same
model (the run's init or checkpoint): it gives the file's keys, their
order and their shapes, which the port's tree alone does not say (the
JAX layout stacks layers and splits ``qkv``); none of its values is
read.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Set, Tuple

import numpy as np
import torch

from hero_tpu_torch import resolve_device

# The pretraining task heads: MLM's tied LM head, MFM's two mask
# embeddings and feature regression, FOM's head.  ``heads=False`` leaves
# them unread (the serving paths).
TASK_HEAD_JAX_KEYS = frozenset({
    "v_encoder/f_encoder/lm_head/dense/kernel",
    "v_encoder/f_encoder/lm_head/dense/bias",
    "v_encoder/f_encoder/lm_head/ln/scale",
    "v_encoder/f_encoder/lm_head/ln/bias",
    "v_encoder/f_encoder/lm_head/bias",
    "v_encoder/f_encoder/img_embeddings/mask_emb",
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


def _ffn(get: Getter, key: str) -> Dict[str, Any]:
    return {"intermediate": _linear(get, f"{key}/intermediate"),
            "output": _linear(get, f"{key}/output"),
            "ln": _ln(get, f"{key}/ln")}


def _layers(stacked: Dict[str, Any]) -> Dict[str, Any]:
    """Stacked (n_layers, ...) JAX layers -> a list of per-layer dicts."""
    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i]

    n = next(iter(stacked.values()))["out_ln"]["weight"].shape[0]
    return {"layers": [layer(stacked, i) for i in range(n)]}


def _encoder(get: Getter, key: str) -> Dict[str, Any]:
    return _layers({"attention": _attention(get, f"{key}/layers/attention"),
                    "ffn": _ffn(get, f"{key}/layers/ffn")})


def _v_encoder(get: Getter, heads: bool) -> Dict[str, Any]:
    """The backbone with its two poolers, and with ``heads`` every
    pretraining task head."""
    fe, ce = "v_encoder/f_encoder", "v_encoder/c_encoder"
    f_encoder = {
        "embeddings": {
            "word_emb": get(f"{fe}/embeddings/word_emb"),
            "pos_emb": get(f"{fe}/embeddings/pos_emb"),
            "type_emb": get(f"{fe}/embeddings/type_emb"),
            "ln": _ln(get, f"{fe}/embeddings/ln")},
        "img_embeddings": {
            "img_ln": _ln(get, f"{fe}/img_embeddings/img_ln"),
            "img_linear": _linear(get, f"{fe}/img_embeddings/img_linear"),
            "pos_emb": get(f"{fe}/img_embeddings/pos_emb"),
            "ln": _ln(get, f"{fe}/img_embeddings/ln")},
        "encoder": _encoder(get, f"{fe}/encoder"),
        "pooler": {"dense": _linear(get, f"{fe}/pooler/dense")}}
    out = {
        "f_encoder": f_encoder,
        "frame_transform": {
            "dense": _linear(get, "v_encoder/frame_transform/dense"),
            "ln": _ln(get, "v_encoder/frame_transform/ln")},
        "c_encoder": {
            "embeddings": {
                "pos_emb": get(f"{ce}/embeddings/pos_emb"),
                "ln": _ln(get, f"{ce}/embeddings/ln")},
            "encoder": _encoder(get, f"{ce}/encoder"),
            "pooler": {"dense": _linear(get, f"{ce}/pooler/dense")}},
    }
    if heads:
        f_encoder["lm_head"] = {"dense": _linear(get, f"{fe}/lm_head/dense"),
                                "ln": _ln(get, f"{fe}/lm_head/ln"),
                                "bias": get(f"{fe}/lm_head/bias")}
        f_encoder["img_embeddings"]["mask_emb"] = get(
            f"{fe}/img_embeddings/mask_emb")
        fr, fo = "v_encoder/feat_regress", "v_encoder/fom_output"
        out.update({
            "feat_regress": {"dense_1": _linear(get, f"{fr}/dense_1"),
                             "ln": _ln(get, f"{fr}/ln"),
                             "dense_2": _linear(get, f"{fr}/dense_2")},
            "mask_embedding": get("v_encoder/mask_embedding"),
            "fom_output": {"linear_1": _linear(get, f"{fo}/linear_1"),
                           "ln": _ln(get, f"{fo}/ln"),
                           "linear_2": _linear(get, f"{fo}/linear_2")}})
    return out


def _port_tree(get: Getter, heads: bool = True) -> Dict[str, Any]:
    qa = "head/q_feat_attn"
    return {
        "v_encoder": _v_encoder(get, heads),
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


def _tvc_tree(get: Getter) -> Dict[str, Any]:
    dec = "decoder/layers"
    return {
        "v_encoder": _v_encoder(get, heads=True),
        "position_embeddings": get("position_embeddings"),
        "emb_ln": _ln(get, "emb_ln"),
        "decoder": _layers({
            "self_attention": _attention(get, f"{dec}/self_attention"),
            "cross_attention": _attention(get, f"{dec}/cross_attention"),
            "ffn": _ffn(get, f"{dec}/ffn")}),
    }


def _mlp(get: Getter, key: str) -> Dict[str, Any]:
    return {"linear_1": _linear(get, f"{key}/linear_1"),
            "ln": _ln(get, f"{key}/ln"),
            "linear_2": _linear(get, f"{key}/linear_2")}


def _head_tree(pools: Tuple[str, ...], mlps: Tuple[str, ...]):
    """The tree builder of a task whose ``head`` holds the bias-free
    linears ``pools`` and the MLP layers ``mlps`` beside the whole
    backbone (the pretraining task heads included)."""
    def tree(get: Getter) -> Dict[str, Any]:
        head = {p: _linear(get, f"head/{p}", bias=False) for p in pools}
        head.update({m: _mlp(get, f"head/{m}") for m in mlps})
        return {"v_encoder": _v_encoder(get, heads=True), "head": head}
    return tree


# ``init_hero_for_videoqa`` / ``init_hero_for_violin``
# (``hero_tpu/models/videoqa.py:32-43``, ``violin.py:26-35``)
_videoqa_tree = _head_tree(("qa_pool", "st_ed_pool"),
                           ("qa_pred_head", "st_ed_pred_head"))
_violin_tree = _head_tree(("violin_pool",), ("violin_pred_head",))


def convert(flat: Mapping[str, np.ndarray], device="cuda",
            tree: Callable[[Getter], Dict[str, Any]] = _port_tree
            ) -> Tuple[Dict[str, Any], Set[str]]:
    """(port tree on ``device``, the JAX keys it was built from).
    ``tree`` builds the pretraining tree or, with ``_tvc_tree``, TVC's."""
    device = resolve_device(device)
    used: Set[str] = set()

    def get(key: str) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"JAX parameter {key!r} is missing")
        used.add(key)
        return torch.from_numpy(
            np.array(flat[key], dtype=np.float32)).to(device)

    return tree(get), used


def _load(flat, device, tree, unread=frozenset()) -> Dict[str, Any]:
    params, used = convert(flat, device, tree)
    missing = unread - set(flat)
    unexpected = set(flat) - used - unread
    if missing or unexpected:
        raise KeyError(f"JAX parameters do not match the port: missing "
                       f"{sorted(missing)}, unexpected {sorted(unexpected)}")
    return params


def load_jax_params(flat: Mapping[str, np.ndarray], device="cuda",
                    heads: bool = True) -> Dict[str, Any]:
    """The port's fp32 parameter tree from flat JAX parameters: the whole
    pretraining tree, or with ``heads=False`` the tree without the task
    heads (:data:`TASK_HEAD_JAX_KEYS`, left unread: what VCMR serving
    reads).  Raises KeyError if a key is missing or unexpected."""
    if heads:
        return _load(flat, device, _port_tree)
    return _load(flat, device, lambda get: _port_tree(get, heads=False),
                 TASK_HEAD_JAX_KEYS)


def load_jax_tvc_params(flat: Mapping[str, np.ndarray], device="cuda"
                        ) -> Dict[str, Any]:
    """The port's fp32 TVC tree from the flat parameters of
    ``init_hero_for_tvc`` (``hero_tpu/models/tvc.py:35-46``): the backbone
    with its poolers and every pretraining task head (the LM head tied to
    the decoder's output), the decoder position embedding and LayerNorm,
    and the decoder layers (self-attention, cross-attention, FFN; each
    attention block with one fused ``qkv``).  Raises KeyError if a key is
    missing or unexpected."""
    return _load(flat, device, _tvc_tree)


def load_jax_videoqa_params(flat: Mapping[str, np.ndarray], device="cuda"
                            ) -> Dict[str, Any]:
    """The port's fp32 VideoQA tree from the flat parameters of
    ``init_hero_for_videoqa``: the backbone with its poolers and every
    pretraining task head, and ``head`` with ``qa_pool``,
    ``qa_pred_head``, ``st_ed_pool`` and ``st_ed_pred_head``.  Raises
    KeyError if a key is missing or unexpected."""
    return _load(flat, device, _videoqa_tree)


def load_jax_violin_params(flat: Mapping[str, np.ndarray], device="cuda"
                           ) -> Dict[str, Any]:
    """:func:`load_jax_videoqa_params` for ``init_hero_for_violin``'s
    tree: ``head`` with ``violin_pool`` and ``violin_pred_head``."""
    return _load(flat, device, _violin_tree)


def _train_state(load, flat_params, flat_mu, flat_nu, opt_step,
                 global_step, device, **kw):
    from hero_tpu_torch.training.optim import AdamWState
    from hero_tpu_torch.training.step import TrainState
    return TrainState(
        params=load(flat_params, device, **kw),
        opt=AdamWState(step=int(opt_step), mu=load(flat_mu, device, **kw),
                       nu=load(flat_nu, device, **kw)),
        global_step=int(global_step))


def load_jax_train_state(flat_params: Mapping[str, np.ndarray],
                         flat_mu: Mapping[str, np.ndarray],
                         flat_nu: Mapping[str, np.ndarray], opt_step: int,
                         global_step: int, device="cuda",
                         heads: bool = True):
    """The port's ``TrainState`` from the flat parameters, AdamW moments
    and step counters of a JAX pretraining ``TrainState``: every
    parameter with its moments, the poolers and task heads included
    (``heads=False`` drops the task heads as :func:`load_jax_params`
    does)."""
    return _train_state(load_jax_params, flat_params, flat_mu, flat_nu,
                        opt_step, global_step, device, heads=heads)


def load_jax_tvc_train_state(flat_params: Mapping[str, np.ndarray],
                             flat_mu: Mapping[str, np.ndarray],
                             flat_nu: Mapping[str, np.ndarray],
                             opt_step: int, global_step: int,
                             device="cuda"):
    """:func:`load_jax_train_state` for the TVC tree
    (:func:`load_jax_tvc_params`): a JAX TVC run's parameters and AdamW
    moments, so a step of each package starts from one state."""
    return _train_state(load_jax_tvc_params, flat_params, flat_mu, flat_nu,
                        opt_step, global_step, device)


def load_jax_videoqa_train_state(flat_params, flat_mu, flat_nu,
                                 opt_step: int, global_step: int,
                                 device="cuda"):
    """:func:`load_jax_train_state` for the VideoQA tree."""
    return _train_state(load_jax_videoqa_params, flat_params, flat_mu,
                        flat_nu, opt_step, global_step, device)


def load_jax_violin_train_state(flat_params, flat_mu, flat_nu,
                                opt_step: int, global_step: int,
                                device="cuda"):
    """:func:`load_jax_train_state` for the VIOLIN tree."""
    return _train_state(load_jax_violin_params, flat_params, flat_mu,
                        flat_nu, opt_step, global_step, device)


def _layout(template: Mapping[str, np.ndarray], device,
            tree: Callable[[Getter], Dict[str, Any]]):
    """(the tree of element numbers, {key: (offset, shape)}, total
    elements): the forward map ``tree`` applied to the position of every
    element of ``template`` laid end to end.  A template key that
    ``tree`` does not read raises, and so does a tree that holds another
    number of elements than the template."""
    offsets, total = {}, 0
    for key, value in template.items():
        shape = tuple(np.shape(value))
        offsets[key] = (total, shape)
        total += int(np.prod(shape, dtype=np.int64))
    used: Set[str] = set()

    def get(key: str) -> torch.Tensor:
        if key not in offsets:
            raise KeyError(f"JAX parameter {key!r} is missing from the "
                           "template")
        used.add(key)
        off, shape = offsets[key]
        n = int(np.prod(shape, dtype=np.int64))
        return torch.arange(off, off + n, device=device).reshape(shape)

    index = tree(get)
    unexpected = set(template) - used
    if unexpected:
        raise KeyError(f"template keys the port does not hold: "
                       f"{sorted(unexpected)}")
    # the forward map is a permutation: as many elements as the template,
    # so the scatter writes every element of its buffer
    from hero_tpu_torch.training.optim import tree_leaves
    read = sum(idx.numel() for idx in tree_leaves(index))
    if read != total:
        raise ValueError(f"the port's tree holds {read} elements, the "
                         f"template {total}")
    return index, offsets, total


def _scatter_to_jax(tree, index, offsets, total) -> Dict[str, np.ndarray]:
    """``tree`` (the port's layout) as a flat JAX-layout dict of fp32
    numpy arrays: one scatter on the device, one copy to the host."""
    from hero_tpu_torch.training.optim import tree_leaves, tree_paths
    idx_leaves, leaves = tree_leaves(index), tree_leaves(tree)
    if len(idx_leaves) != len(leaves):
        raise ValueError(f"the tree has {len(leaves)} leaves, the JAX "
                         f"layout {len(idx_leaves)}")
    device = idx_leaves[0].device
    buf = torch.empty(total, dtype=torch.float32, device=device)
    for path, idx, leaf in zip(tree_paths(index), idx_leaves, leaves):
        if tuple(idx.shape) != tuple(leaf.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(leaf.shape)}"
                             f", the JAX layout gives {tuple(idx.shape)}")
        buf.index_copy_(0, idx.reshape(-1),
                        leaf.detach().reshape(-1).to(device, torch.float32))
    host = buf.cpu().numpy()
    return {key: host[off:off + int(np.prod(shape, dtype=np.int64))]
            .reshape(shape) for key, (off, shape) in offsets.items()}


def _device_of(tree) -> torch.device:
    from hero_tpu_torch.training.optim import tree_leaves
    return tree_leaves(tree)[0].device


def _to_jax_params(params, template, tree):
    return _scatter_to_jax(params, *_layout(template, _device_of(params),
                                            tree))


def _to_jax_train_state(state, template, tree):
    layout = _layout(template, _device_of(state.params), tree)
    return (*(_scatter_to_jax(t, *layout)
              for t in (state.params, state.opt.mu, state.opt.nu)),
            int(state.global_step))


def to_jax_params(params, template: Mapping[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
    """The flat JAX-layout dict of the port's pretraining tree ``params``
    (inverse of :func:`load_jax_params`; kernels transposed back, ``qkv``
    split, layers stacked), fp32 numpy, keys, order and shapes
    ``template``'s (see the module docstring).  Exact both ways:
    ``load_jax_params(to_jax_params(p, t)) == p``."""
    return _to_jax_params(params, template, _port_tree)


def to_jax_train_state(state, template: Mapping[str, np.ndarray]
                       ) -> Tuple[Dict[str, np.ndarray],
                                  Dict[str, np.ndarray],
                                  Dict[str, np.ndarray], int]:
    """(flat params, flat mu, flat nu, step) of the port's pretraining
    ``TrainState`` in the JAX layout of ``template`` (inverse of
    :func:`load_jax_train_state`); ``step`` the optimizer steps taken."""
    return _to_jax_train_state(state, template, _port_tree)


def to_jax_tvc_params(params, template: Mapping[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """:func:`to_jax_params` for the TVC tree (inverse of
    :func:`load_jax_tvc_params`).  Exact both ways:
    ``load_jax_tvc_params(to_jax_tvc_params(p, t)) == p``."""
    return _to_jax_params(params, template, _tvc_tree)


def to_jax_tvc_train_state(state, template: Mapping[str, np.ndarray]
                           ) -> Tuple[Dict[str, np.ndarray],
                                      Dict[str, np.ndarray],
                                      Dict[str, np.ndarray], int]:
    """:func:`to_jax_train_state` for the TVC tree (inverse of
    :func:`load_jax_tvc_train_state`)."""
    return _to_jax_train_state(state, template, _tvc_tree)


def to_jax_videoqa_params(params, template: Mapping[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """:func:`to_jax_params` for the VideoQA tree (inverse of
    :func:`load_jax_videoqa_params`)."""
    return _to_jax_params(params, template, _videoqa_tree)


def to_jax_videoqa_train_state(state, template: Mapping[str, np.ndarray]):
    """:func:`to_jax_train_state` for the VideoQA tree."""
    return _to_jax_train_state(state, template, _videoqa_tree)


def to_jax_violin_params(params, template: Mapping[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """:func:`to_jax_params` for the VIOLIN tree (inverse of
    :func:`load_jax_violin_params`)."""
    return _to_jax_params(params, template, _violin_tree)


def to_jax_violin_train_state(state, template: Mapping[str, np.ndarray]):
    """:func:`to_jax_train_state` for the VIOLIN tree."""
    return _to_jax_train_state(state, template, _violin_tree)
