"""Convert HERO torch checkpoints (e.g. ``hero-tv-ht100.pt``) to the JAX
parameter layout (a copy of ``hero_tpu/convert/torch_checkpoint.py``: the
same state dict gives the same tree).  The port overlays that tree on its
init (``drivers/common.load_checkpoint_into``) and bridges it to its own
layout (``convert/from_jax.py``).

Handles the reference's checkpoint conventions (SURVEY.md §5.4):

- ``.gamma``/``.beta`` LayerNorm key renames
  (``model/modeling_utils.py:68-121``);
- vocab padding to a multiple of 8 (50265 → 50272,
  ``model/encoder.py:226-235``) — applied when the target config expects
  the padded size;
- tied word embedding / ``lm_head.decoder.weight`` (dropped, we tie);
- torch ``(out, in)`` Linear kernels → JAX ``(in, out)``;
- Conv1d ``(1, 1, k)`` st/ed predictors → ``(k,)`` (XLA convs are
  cross-correlations like torch — direct copy);
- per-layer ``encoder.layer.{i}.*`` → stacked arrays with a leading layer
  axis (for the ``lax.scan`` encoder);
- ``max_frm_seq_len`` is inferable from the frame-position-embedding shape
  via :func:`infer_max_frm_seq_len` (``pretrain.py:187-192``).

Entry points: :func:`convert_state_dict` (dict of numpy/torch tensors →
pytree) and :func:`load_and_convert` (.pt path → pytree; needs torch).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def normalize_keys(state_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """gamma/beta renames + strip a leading ``module.`` if present."""
    out = {}
    for k, v in state_dict.items():
        if k.endswith(".gamma"):
            k = k[:-len(".gamma")] + ".weight"
        elif k.endswith(".beta"):
            k = k[:-len(".beta")] + ".bias"
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = _np(v)
    return out


def infer_max_frm_seq_len(state_dict: Dict[str, Any]) -> Optional[int]:
    for k, v in state_dict.items():
        if k.endswith("f_encoder.img_embeddings.position_embeddings.weight"):
            return _np(v).shape[0]
    return None


def _set(tree: dict, path: str, value: np.ndarray):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _linear(tree, prefix_out, sd, prefix_in):
    _set(tree, prefix_out + "/kernel", sd[prefix_in + ".weight"].T)
    if prefix_in + ".bias" in sd:
        _set(tree, prefix_out + "/bias", sd[prefix_in + ".bias"])


def _ln(tree, prefix_out, sd, prefix_in):
    _set(tree, prefix_out + "/scale", sd[prefix_in + ".weight"])
    _set(tree, prefix_out + "/bias", sd[prefix_in + ".bias"])


def _stack_layers(tree, out_prefix, sd, in_prefix, n_layers,
                  decoder: bool = False):
    """encoder.layer.{i}.* → stacked pytree for the scanned stack."""
    def gather(fmt):
        return np.stack([sd[fmt.format(i)] for i in range(n_layers)])

    def lin(out_path, fmt):
        _set(tree, f"{out_prefix}/{out_path}/kernel",
             np.stack([sd[fmt.format(i) + ".weight"].T
                       for i in range(n_layers)]))
        _set(tree, f"{out_prefix}/{out_path}/bias",
             gather(fmt + ".bias"))

    def lnorm(out_path, fmt):
        _set(tree, f"{out_prefix}/{out_path}/scale",
             gather(fmt + ".weight"))
        _set(tree, f"{out_prefix}/{out_path}/bias", gather(fmt + ".bias"))

    if not decoder:
        lin("attention/query", in_prefix + ".{}.attention.self.query")
        lin("attention/key", in_prefix + ".{}.attention.self.key")
        lin("attention/value", in_prefix + ".{}.attention.self.value")
        lin("attention/out", in_prefix + ".{}.attention.output.dense")
        lnorm("attention/out_ln",
              in_prefix + ".{}.attention.output.LayerNorm")
        lin("ffn/intermediate", in_prefix + ".{}.intermediate.dense")
        lin("ffn/output", in_prefix + ".{}.output.dense")
        lnorm("ffn/ln", in_prefix + ".{}.output.LayerNorm")
    else:
        # BertDecoderLayer (reference model/tvc.py:107-122; note the
        # reference's 'intermidiate' spelling)
        lin("self_attention/query", in_prefix + ".{}.self_attention.query")
        lin("self_attention/key", in_prefix + ".{}.self_attention.key")
        lin("self_attention/value", in_prefix + ".{}.self_attention.value")
        lin("self_attention/out", in_prefix + ".{}.add_norm_1.dense")
        lnorm("self_attention/out_ln", in_prefix + ".{}.add_norm_1.LayerNorm")
        lin("cross_attention/query",
            in_prefix + ".{}.dec_enc_attention.query")
        lin("cross_attention/key", in_prefix + ".{}.dec_enc_attention.key")
        lin("cross_attention/value",
            in_prefix + ".{}.dec_enc_attention.value")
        lin("cross_attention/out", in_prefix + ".{}.add_norm_2.dense")
        lnorm("cross_attention/out_ln",
              in_prefix + ".{}.add_norm_2.LayerNorm")
        lin("ffn/intermediate", in_prefix + ".{}.intermidiate.dense")
        lin("ffn/output", in_prefix + ".{}.add_norm_3.dense")
        lnorm("ffn/ln", in_prefix + ".{}.add_norm_3.LayerNorm")


def _count_layers(sd, prefix):
    n = -1
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.")
    for k in sd:
        m = pat.match(k)
        if m:
            n = max(n, int(m.group(1)))
    return n + 1


def _pad_vocab(emb: np.ndarray, target: int) -> np.ndarray:
    if emb.shape[0] < target:
        pad = np.zeros((target - emb.shape[0],) + emb.shape[1:],
                       emb.dtype)
        emb = np.concatenate([emb, pad], 0)
    return emb


def _convert_cross_modal(tree, sd, prefix, out_prefix, vocab_size):
    p, o = prefix, out_prefix
    _set(tree, f"{o}/embeddings/word_emb",
         _pad_vocab(sd[f"{p}.embeddings.word_embeddings.weight"],
                    vocab_size))
    _set(tree, f"{o}/embeddings/pos_emb",
         sd[f"{p}.embeddings.position_embeddings.weight"])
    _set(tree, f"{o}/embeddings/type_emb",
         sd[f"{p}.embeddings.token_type_embeddings.weight"])
    _ln(tree, f"{o}/embeddings/ln", sd, f"{p}.embeddings.LayerNorm")
    _linear(tree, f"{o}/img_embeddings/img_linear", sd,
            f"{p}.img_embeddings.img_linear")
    _ln(tree, f"{o}/img_embeddings/img_ln", sd,
        f"{p}.img_embeddings.img_LayerNorm")
    _set(tree, f"{o}/img_embeddings/pos_emb",
         sd[f"{p}.img_embeddings.position_embeddings.weight"])
    _set(tree, f"{o}/img_embeddings/mask_emb",
         sd[f"{p}.img_embeddings.mask_embedding.weight"])
    _ln(tree, f"{o}/img_embeddings/ln", sd, f"{p}.img_embeddings.LayerNorm")
    n = _count_layers(sd, f"{p}.encoder.layer")
    _stack_layers(tree, f"{o}/encoder/layers", sd, f"{p}.encoder.layer", n)
    _linear(tree, f"{o}/pooler/dense", sd, f"{p}.pooler.dense")
    if f"{p}.lm_head.dense.weight" in sd:
        _linear(tree, f"{o}/lm_head/dense", sd, f"{p}.lm_head.dense")
        _ln(tree, f"{o}/lm_head/ln", sd, f"{p}.lm_head.LayerNorm")
        _set(tree, f"{o}/lm_head/bias",
             _pad_vocab(sd[f"{p}.lm_head.bias"], vocab_size))


def _convert_temporal(tree, sd, prefix, out_prefix):
    p, o = prefix, out_prefix
    _set(tree, f"{o}/embeddings/pos_emb",
         sd[f"{p}.embeddings.position_embeddings.weight"])
    _ln(tree, f"{o}/embeddings/ln", sd, f"{p}.embeddings.LayerNorm")
    n = _count_layers(sd, f"{p}.encoder.layer")
    _stack_layers(tree, f"{o}/encoder/layers", sd, f"{p}.encoder.layer", n)
    _linear(tree, f"{o}/pooler/dense", sd, f"{p}.pooler.dense")


def _convert_mlp(tree, sd, prefix, out_prefix):
    _linear(tree, f"{out_prefix}/linear_1", sd, f"{prefix}.linear_1")
    _ln(tree, f"{out_prefix}/ln", sd, f"{prefix}.LayerNorm")
    _linear(tree, f"{out_prefix}/linear_2", sd, f"{prefix}.linear_2")


def _convert_linear_layer(tree, sd, prefix, out_prefix):
    """reference LinearLayer: LayerNorm + net.1 Linear."""
    if f"{prefix}.LayerNorm.weight" in sd:
        _ln(tree, f"{out_prefix}/ln", sd, f"{prefix}.LayerNorm")
    _linear(tree, f"{out_prefix}/dense", sd, f"{prefix}.net.1")


def _convert_query_feat_encoder(tree, sd, prefix, out_prefix):
    p, o = prefix, out_prefix
    _convert_linear_layer(tree, sd, f"{p}.query_input_proj",
                          f"{o}/query_input_proj")
    _set(tree, f"{o}/pos_embed/pos_emb",
         sd[f"{p}.query_pos_embed.position_embeddings.weight"])
    _ln(tree, f"{o}/pos_embed/ln", sd, f"{p}.query_pos_embed.LayerNorm")
    _linear(tree, f"{o}/attention/query", sd,
            f"{p}.query_self_attention.self.query")
    _linear(tree, f"{o}/attention/key", sd,
            f"{p}.query_self_attention.self.key")
    _linear(tree, f"{o}/attention/value", sd,
            f"{p}.query_self_attention.self.value")
    _linear(tree, f"{o}/attention/out", sd,
            f"{p}.query_self_attention.output.dense")
    _ln(tree, f"{o}/attention/out_ln", sd,
        f"{p}.query_self_attention.output.LayerNorm")
    if f"{p}.modular_vector_mapping.weight" in sd:
        _set(tree, f"{o}/modular_vector/kernel",
             sd[f"{p}.modular_vector_mapping.weight"].T)


def convert_state_dict(state_dict: Dict[str, Any],
                       vocab_size: int = 50272) -> Dict[str, Any]:
    """Full HERO checkpoint → JAX-layout params pytree.

    Recognizes backbone (``v_encoder.*``) plus whichever task head the
    checkpoint carries (pretrain/VCMR/VR conv heads, VideoQA, VIOLIN, TVC
    decoder).  Unrecognized keys are reported in ``tree['__unexpected__']``
    mirroring the reference's missing/unexpected-key reporting.
    """
    sd = normalize_keys(state_dict)
    tree: Dict[str, Any] = {}
    consumed_prefixes = []

    _convert_cross_modal(tree, sd, "v_encoder.f_encoder",
                         "v_encoder/f_encoder", vocab_size)
    consumed_prefixes.append("v_encoder.f_encoder.")
    _convert_temporal(tree, sd, "v_encoder.c_encoder",
                      "v_encoder/c_encoder")
    consumed_prefixes.append("v_encoder.c_encoder.")
    _convert_linear_layer(tree, sd, "v_encoder.frame_transform",
                          "v_encoder/frame_transform")
    consumed_prefixes.append("v_encoder.frame_transform.")
    if "v_encoder.feat_regress.net.0.weight" in sd:
        _linear(tree, "v_encoder/feat_regress/dense_1", sd,
                "v_encoder.feat_regress.net.0")
        _ln(tree, "v_encoder/feat_regress/ln", sd,
            "v_encoder.feat_regress.net.2")
        _linear(tree, "v_encoder/feat_regress/dense_2", sd,
                "v_encoder.feat_regress.net.3")
        consumed_prefixes.append("v_encoder.feat_regress.")
    if "v_encoder.mask_embedding.weight" in sd:
        _set(tree, "v_encoder/mask_embedding",
             sd["v_encoder.mask_embedding.weight"])
        consumed_prefixes.append("v_encoder.mask_embedding.")
    if "v_encoder.fom_output.linear_1.weight" in sd:
        _convert_mlp(tree, sd, "v_encoder.fom_output",
                     "v_encoder/fom_output")
        consumed_prefixes.append("v_encoder.fom_output.")

    # ---- pretrain / VCMR / VR head
    if "video_query_linear.weight" in sd:
        _linear(tree, "head/video_query_linear", sd, "video_query_linear")
        _set(tree, "head/video_st_predictor/kernel",
             sd["video_st_predictor.weight"].reshape(-1))
        _set(tree, "head/video_ed_predictor/kernel",
             sd["video_ed_predictor.weight"].reshape(-1))
        _convert_query_feat_encoder(tree, sd, "q_feat_attn",
                                    "head/q_feat_attn")
        consumed_prefixes += ["video_query_linear.", "video_st_predictor.",
                              "video_ed_predictor.", "q_feat_attn."]
    # ---- videoQA head
    if "qa_pool.weight" in sd:
        _set(tree, "head/qa_pool/kernel", sd["qa_pool.weight"].T)
        _convert_mlp(tree, sd, "qa_pred_head", "head/qa_pred_head")
        _set(tree, "head/st_ed_pool/kernel", sd["st_ed_pool.weight"].T)
        _convert_mlp(tree, sd, "st_ed_pred_head", "head/st_ed_pred_head")
        consumed_prefixes += ["qa_pool.", "qa_pred_head.", "st_ed_pool.",
                              "st_ed_pred_head."]
    # ---- violin head
    if "violin_pool.weight" in sd:
        _set(tree, "head/violin_pool/kernel", sd["violin_pool.weight"].T)
        _convert_mlp(tree, sd, "violin_pred_head", "head/violin_pred_head")
        consumed_prefixes += ["violin_pool.", "violin_pred_head."]
    # ---- TVC decoder
    if "position_embeddings.weight" in sd:
        _set(tree, "position_embeddings", sd["position_embeddings.weight"])
        _ln(tree, "emb_ln", sd, "emb_LayerNorm")
        n = _count_layers(sd, "decoder.layer")
        _stack_layers(tree, "decoder/layers", sd, "decoder.layer", n,
                      decoder=True)
        consumed_prefixes += ["position_embeddings.", "emb_LayerNorm.",
                              "decoder."]

    def _is_buffer(k: str) -> bool:
        # torch buffers that are not parameters (reference registers a
        # 'pad' scratch, the decoder 'tri_mask', LabelSmoothing 'one_hot')
        return (k.endswith(".pad") or k == "pad"
                or k.endswith("tri_mask") or k.endswith("one_hot"))

    unexpected = [k for k in sd
                  if not any(k.startswith(p) for p in consumed_prefixes)
                  and not k.endswith("lm_head.decoder.weight")
                  and not _is_buffer(k)]
    if unexpected:
        tree["__unexpected__"] = unexpected
    # record whether _pad_vocab actually ADDED rows (reference ModelSaver
    # sets vocab_padded from the applied pad decision, utils/save.py:119-127
    # — inferring it later from shape % 8 would mislabel a naturally
    # mult-of-8 vocab as padded)
    word_key = "v_encoder.f_encoder.embeddings.word_embeddings.weight"
    if word_key in sd:
        tree["__vocab_padded__"] = bool(
            np.asarray(sd[word_key]).shape[0] < vocab_size)
    return tree


def load_and_convert(path: str, vocab_size: int = 50272):
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model" in sd and isinstance(
            sd["model"], dict):
        sd = sd["model"]
    return convert_state_dict(sd, vocab_size=vocab_size)
