"""Bridge from JAX parameters to the port's parameter tree.

Input: the flat ``{"a/b/c": np.ndarray}`` dict of the JAX package's
``flatten_tree`` -- also what ``np.load`` of a JAX ``model_step_N.npz``
checkpoint gives.  In the JAX layout linear kernels are ``(in, out)`` and
the encoder layers are stacked on a leading axis.  The port's tree
(``models/nn.py``) has ``(out, in)`` linear weights, LayerNorm
``weight``/``bias``, one fused ``qkv`` projection per self-attention block
(rows ordered query, key, value), and a list of per-layer dicts per encoder.

The bridge fails on any missing or unexpected key: every JAX key is either
read into the port's tree or named in :data:`UNUSED_JAX_KEYS` (the
pretraining tree: the two poolers; with ``heads=False`` also
:data:`TASK_HEAD_JAX_KEYS`) or :data:`UNUSED_TVC_JAX_KEYS`
(``init_hero_for_tvc``'s tree, :func:`load_jax_tvc_params`, which reads
the LM head of the task heads).  The VideoQA and VIOLIN trees
(:func:`load_jax_videoqa_params`, :func:`load_jax_violin_params`) hold
the whole backbone, the pretraining task heads included, which no loss
of theirs reads but the AdamW step decays, and their own heads; only
the poolers stay unread.

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
tensors' device puts it back there.

The inverse takes a ``template``, the flat JAX tree the run started from
(its init or checkpoint): the keys the port does not hold (the two
poolers; for TVC also the task heads other than the LM head) are
written from it, with zero AdamW moments.  The JAX package's
AdamW decays the pooler kernels every step although no pretraining loss
reads them (``hero_tpu/training/optim.py:142-144``,
``hero_tpu/models/encoder.py:155,187``); the port leaves them as they
were, so its files differ from a JAX run's there and nowhere else.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Set, Tuple

import numpy as np
import torch

from hero_tpu_torch import resolve_device

# JAX keys that no path of the port reads: the f- and c-encoder poolers
# (``hero_tpu/models/encoder.py:155,186``).
UNUSED_JAX_KEYS = frozenset({
    "v_encoder/f_encoder/pooler/dense/kernel",
    "v_encoder/f_encoder/pooler/dense/bias",
    "v_encoder/c_encoder/pooler/dense/kernel",
    "v_encoder/c_encoder/pooler/dense/bias",
})

# The pretraining task heads: MLM's tied LM head, MFM's two mask
# embeddings and feature regression, FOM's head.  ``heads=False`` leaves
# them unread (the serving and VSM paths), and TVC reads the LM head only.
LM_HEAD_JAX_KEYS = frozenset({
    "v_encoder/f_encoder/lm_head/dense/kernel",
    "v_encoder/f_encoder/lm_head/dense/bias",
    "v_encoder/f_encoder/lm_head/ln/scale",
    "v_encoder/f_encoder/lm_head/ln/bias",
    "v_encoder/f_encoder/lm_head/bias",
})
TASK_HEAD_JAX_KEYS = LM_HEAD_JAX_KEYS | frozenset({
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
UNUSED_TVC_JAX_KEYS = UNUSED_JAX_KEYS | (TASK_HEAD_JAX_KEYS
                                         - LM_HEAD_JAX_KEYS)

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


def _v_encoder(get: Getter, lm_head: bool,
               task_heads: bool = False) -> Dict[str, Any]:
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
        "encoder": _encoder(get, f"{fe}/encoder")}
    if lm_head or task_heads:
        f_encoder["lm_head"] = {"dense": _linear(get, f"{fe}/lm_head/dense"),
                                "ln": _ln(get, f"{fe}/lm_head/ln"),
                                "bias": get(f"{fe}/lm_head/bias")}
    out = {
        "f_encoder": f_encoder,
        "frame_transform": {
            "dense": _linear(get, "v_encoder/frame_transform/dense"),
            "ln": _ln(get, "v_encoder/frame_transform/ln")},
        "c_encoder": {
            "embeddings": {
                "pos_emb": get(f"{ce}/embeddings/pos_emb"),
                "ln": _ln(get, f"{ce}/embeddings/ln")},
            "encoder": _encoder(get, f"{ce}/encoder")},
    }
    if task_heads:
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
        "v_encoder": _v_encoder(get, lm_head=False, task_heads=heads),
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
        "v_encoder": _v_encoder(get, lm_head=True),
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
        return {"v_encoder": _v_encoder(get, lm_head=True, task_heads=True),
                "head": head}
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


def _load(flat, device, tree, unused_keys) -> Dict[str, Any]:
    params, used = convert(flat, device, tree)
    missing = unused_keys - set(flat)
    unexpected = set(flat) - used - unused_keys
    if missing or unexpected:
        raise KeyError(f"JAX parameters do not match the port: missing "
                       f"{sorted(missing)}, unexpected {sorted(unexpected)}")
    return params


def load_jax_params(flat: Mapping[str, np.ndarray], device="cuda",
                    heads: bool = True) -> Dict[str, Any]:
    """The port's fp32 parameter tree from flat JAX parameters: the whole
    pretraining tree, or with ``heads=False`` the tree without the task
    heads (:data:`TASK_HEAD_JAX_KEYS`, left unread: what VCMR serving and
    the VSM step read).  Raises KeyError if a key is missing or not
    accounted for."""
    if heads:
        return _load(flat, device, _port_tree, UNUSED_JAX_KEYS)
    return _load(flat, device, lambda get: _port_tree(get, heads=False),
                 UNUSED_JAX_KEYS | TASK_HEAD_JAX_KEYS)


def load_jax_tvc_params(flat: Mapping[str, np.ndarray], device="cuda"
                        ) -> Dict[str, Any]:
    """The port's fp32 TVC tree from the flat parameters of
    ``init_hero_for_tvc`` (``hero_tpu/models/tvc.py:35-46``): the backbone
    with its tied LM head, the decoder position embedding and LayerNorm,
    and the decoder layers (self-attention, cross-attention, FFN; each
    attention block with one fused ``qkv``).  Raises KeyError if a key is
    missing or not accounted for (:data:`UNUSED_TVC_JAX_KEYS`)."""
    return _load(flat, device, _tvc_tree, UNUSED_TVC_JAX_KEYS)


def load_jax_videoqa_params(flat: Mapping[str, np.ndarray], device="cuda"
                            ) -> Dict[str, Any]:
    """The port's fp32 VideoQA tree from the flat parameters of
    ``init_hero_for_videoqa``: the backbone with every pretraining task
    head, and ``head`` with ``qa_pool``, ``qa_pred_head``,
    ``st_ed_pool`` and ``st_ed_pred_head``.  Raises KeyError if a key
    is missing or not accounted for (:data:`UNUSED_JAX_KEYS`)."""
    return _load(flat, device, _videoqa_tree, UNUSED_JAX_KEYS)


def load_jax_violin_params(flat: Mapping[str, np.ndarray], device="cuda"
                           ) -> Dict[str, Any]:
    """:func:`load_jax_videoqa_params` for ``init_hero_for_violin``'s
    tree: ``head`` with ``violin_pool`` and ``violin_pred_head``."""
    return _load(flat, device, _violin_tree, UNUSED_JAX_KEYS)


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
    parameter with its moments, the task heads included (``heads=False``
    drops them as :func:`load_jax_params` does).  The poolers' moments
    (:data:`UNUSED_JAX_KEYS`) are dropped with their parameters."""
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
            tree: Callable[[Getter], Dict[str, Any]],
            unused_keys: frozenset):
    """(the tree of element numbers, the keys it reads, {key: (offset,
    shape)}, total elements): the forward map ``tree`` applied to the
    position of every element of ``template`` laid end to end.  A
    template key that ``tree`` does not read and ``unused_keys`` does not
    name raises."""
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
    unexpected = set(template) - used - unused_keys
    if unexpected:
        raise KeyError(f"template keys the port does not hold: "
                       f"{sorted(unexpected)}")
    return index, used, offsets, total


def _scatter_to_jax(tree, index, used, offsets, total, fill
                    ) -> Dict[str, np.ndarray]:
    """``tree`` (the port's layout) as a flat JAX-layout dict of fp32
    numpy arrays: one scatter on the device, one copy to the host; keys
    outside ``used`` come from ``fill(key)``."""
    from hero_tpu_torch.training.optim import tree_leaves, tree_paths
    idx_leaves, leaves = tree_leaves(index), tree_leaves(tree)
    if len(idx_leaves) != len(leaves):
        raise ValueError(f"the tree has {len(leaves)} leaves, the JAX "
                         f"layout {len(idx_leaves)}")
    device = idx_leaves[0].device
    buf = torch.zeros(total, dtype=torch.float32, device=device)
    for path, idx, leaf in zip(tree_paths(index), idx_leaves, leaves):
        if tuple(idx.shape) != tuple(leaf.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(leaf.shape)}"
                             f", the JAX layout gives {tuple(idx.shape)}")
        buf.index_copy_(0, idx.reshape(-1),
                        leaf.detach().reshape(-1).to(device, torch.float32))
    host = buf.cpu().numpy()
    out = {}
    for key, (off, shape) in offsets.items():
        n = int(np.prod(shape, dtype=np.int64))
        out[key] = (host[off:off + n].reshape(shape) if key in used
                    else fill(key))
    return out


def _device_of(tree) -> torch.device:
    from hero_tpu_torch.training.optim import tree_leaves
    return tree_leaves(tree)[0].device


def _to_jax_params(params, template, tree, unused_keys):
    index, used, offsets, total = _layout(template, _device_of(params),
                                          tree, unused_keys)
    return _scatter_to_jax(params, index, used, offsets, total,
                           lambda k: np.asarray(template[k], np.float32))


def _to_jax_train_state(state, template, tree, unused_keys):
    index, used, offsets, total = _layout(template,
                                          _device_of(state.params), tree,
                                          unused_keys)

    def zeros(k):
        return np.zeros(np.shape(template[k]), np.float32)

    flat = [_scatter_to_jax(t, index, used, offsets, total, fill)
            for t, fill in ((state.params,
                             lambda k: np.asarray(template[k], np.float32)),
                            (state.opt.mu, zeros), (state.opt.nu, zeros))]
    return flat[0], flat[1], flat[2], int(state.global_step)


def to_jax_params(params, template: Mapping[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
    """The flat JAX-layout dict of the port's pretraining tree ``params``
    (inverse of :func:`load_jax_params`; kernels transposed back, ``qkv``
    split, layers stacked), fp32 numpy, keys in ``template``'s order; the
    poolers are ``template``'s (see the module docstring).  Exact both
    ways: ``load_jax_params(to_jax_params(p, t)) == p``."""
    return _to_jax_params(params, template, _port_tree, UNUSED_JAX_KEYS)


def to_jax_train_state(state, template: Mapping[str, np.ndarray]
                       ) -> Tuple[Dict[str, np.ndarray],
                                  Dict[str, np.ndarray],
                                  Dict[str, np.ndarray], int]:
    """(flat params, flat mu, flat nu, step) of the port's pretraining
    ``TrainState`` in the JAX layout (inverse of
    :func:`load_jax_train_state`): the poolers' parameters from
    ``template`` and their moments zero; ``step`` the optimizer steps
    taken."""
    return _to_jax_train_state(state, template, _port_tree, UNUSED_JAX_KEYS)


def to_jax_tvc_params(params, template: Mapping[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """:func:`to_jax_params` for the TVC tree (inverse of
    :func:`load_jax_tvc_params`): the keys the TVC tree does not hold
    (:data:`UNUSED_TVC_JAX_KEYS`: the poolers and the task heads other
    than the LM head) are ``template``'s.  Exact both ways:
    ``load_jax_tvc_params(to_jax_tvc_params(p, t)) == p``."""
    return _to_jax_params(params, template, _tvc_tree, UNUSED_TVC_JAX_KEYS)


def to_jax_tvc_train_state(state, template: Mapping[str, np.ndarray]
                           ) -> Tuple[Dict[str, np.ndarray],
                                      Dict[str, np.ndarray],
                                      Dict[str, np.ndarray], int]:
    """:func:`to_jax_train_state` for the TVC tree (inverse of
    :func:`load_jax_tvc_train_state`): the keys of
    :data:`UNUSED_TVC_JAX_KEYS` from ``template``, with zero moments."""
    return _to_jax_train_state(state, template, _tvc_tree,
                               UNUSED_TVC_JAX_KEYS)


def to_jax_videoqa_params(params, template: Mapping[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """:func:`to_jax_params` for the VideoQA tree (inverse of
    :func:`load_jax_videoqa_params`): the poolers are ``template``'s."""
    return _to_jax_params(params, template, _videoqa_tree, UNUSED_JAX_KEYS)


def to_jax_videoqa_train_state(state, template: Mapping[str, np.ndarray]):
    """:func:`to_jax_train_state` for the VideoQA tree."""
    return _to_jax_train_state(state, template, _videoqa_tree,
                               UNUSED_JAX_KEYS)


def to_jax_violin_params(params, template: Mapping[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """:func:`to_jax_params` for the VIOLIN tree (inverse of
    :func:`load_jax_violin_params`)."""
    return _to_jax_params(params, template, _violin_tree, UNUSED_JAX_KEYS)


def to_jax_violin_train_state(state, template: Mapping[str, np.ndarray]):
    """:func:`to_jax_train_state` for the VIOLIN tree."""
    return _to_jax_train_state(state, template, _violin_tree,
                               UNUSED_JAX_KEYS)
