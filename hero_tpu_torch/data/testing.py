"""Test fixtures: a synthetic corpus builder (a copy of
``hero_tpu/data/testing.py``), which writes a full herostore DB suite, the
JAX builder's files byte for byte; and :func:`reference_state_dict`, a
reference-layout HERO state dict from JAX-layout parameters, which stands
in for the released ``.pt`` checkpoints where none can be had.

Produces the same artifact layout the real prepro emits (SURVEY.md §2.2):
sub db (+ vid2len.json, vid2max_frame_sub_len.json, vid2dur_idx.json),
video-feature db (+ id2nframe.json), query db (+ id2len.json,
query2video.json, query_data.jsonl), TVC cap db.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from hero_tpu_torch.data.store import HeroStoreWriter

META = {"CLS": 0, "SEP": 2, "PAD": 1, "BOS": 0, "EOS": 2, "MASK": 50,
        "v_range": (3, 100)}


def _write_json(db_dir, name, obj):
    with open(os.path.join(db_dir, name), "w") as f:
        json.dump(obj, f)


def build_synthetic_corpus(root: str, n_videos: int = 6,
                           max_frames: int = 16, vfeat_dim: int = 64,
                           frame_interval: float = 1.5,
                           n_queries_per_video: int = 3,
                           n_answers: int = 3, seed: int = 0,
                           correlated: bool = False) -> Dict[str, str]:
    """Returns dict of db paths: sub, vfeat, query, qa_query, cap.

    With ``correlated=True`` the corpus carries a learnable retrieval
    signal: video ``v`` gets a distinctive feature direction and its
    queries/subtitles carry video-identity tokens, so VSM/VCMR training
    must drive corpus R@1 well above chance (used by the flagship-scale
    TPU drive and the learning-signal tests)."""
    rng = random.Random(seed)
    npr = np.random.RandomState(seed)
    vids = [f"vid{i}" for i in range(n_videos)]

    def id_tok(vi: int) -> int:
        # per-video identity token in the corpus vocab band [3, 99)
        return 3 + (vi % 96)

    # --- video features
    vfeat_dir = os.path.join(root, "video_db")
    id2nframe = {}
    with HeroStoreWriter(vfeat_dir) as w:
        for vi, vid in enumerate(vids):
            nf = rng.randint(max_frames // 2, max_frames)
            id2nframe[vid] = nf
            feat = npr.randn(nf, vfeat_dim).astype(np.float32)
            if correlated:
                feat *= 0.1
                feat[:, (3 * vi) % vfeat_dim] += 3.0   # identity direction
            w.put(vid, feat.astype(np.float16))
    _write_json(vfeat_dir, "id2nframe.json", id2nframe)

    # --- subtitles
    sub_dir = os.path.join(root, "sub_db")
    vid2len, vid2max_len, vid2sub_len = {}, {}, {}
    vid2dur_idx = {"train": {}}
    with HeroStoreWriter(sub_dir) as w:
        for vi, vid in enumerate(vids):
            nf = id2nframe[vid]
            n_subs = rng.randint(2, 4)
            bounds = sorted(rng.sample(range(1, nf), min(n_subs - 1,
                                                         nf - 1)))
            spans = []
            prev = 0
            for b in bounds + [nf]:
                spans.append(list(range(prev, b)))
                prev = b
            input_ids = [[rng.randint(3, 99)
                          for _ in range(rng.randint(3, 8))]
                         for _ in spans]
            if correlated:
                # subtitles open with the video-identity token
                input_ids = [[id_tok(vi)] + row[1:] for row in input_ids]
            w.put(vid, {
                "input_ids": input_ids,
                "unique_sub2frames": [(i, s) for i, s in enumerate(spans)],
                "unmatched_frames": [],
            })
            vid2len[vid] = nf
            vid2sub_len[vid] = [len(t) for t in input_ids]
            vid2max_len[vid] = max(len(t) for t in input_ids) + max(
                len(s) for s in spans)
            vid2dur_idx["train"][vid] = [nf * frame_interval, vi]
    _write_json(sub_dir, "meta.json", META)
    _write_json(sub_dir, "vid2len.json", vid2len)
    _write_json(sub_dir, "vid2max_frame_sub_len.json", vid2max_len)
    _write_json(sub_dir, "vid2dur_idx.json", vid2dur_idx)
    _write_json(sub_dir, "vid2sub_len.json", vid2sub_len)

    # --- retrieval queries
    q_dir = os.path.join(root, "query_db")
    id2len, q2v = {}, {}
    with HeroStoreWriter(q_dir) as w, open(
            os.path.join(root, "query_data.jsonl"), "w") as jf:
        qid = 0
        for vi, vid in enumerate(vids):
            nf = id2nframe[vid]
            for _ in range(n_queries_per_video):
                ids = [rng.randint(3, 99)
                       for _ in range(rng.randint(3, 10))]
                if correlated:
                    # query is dominated by the identity token of its video
                    ids = [id_tok(vi)] * max(4, len(ids) - 1) + ids[:1]
                st = rng.uniform(0, nf * frame_interval / 2)
                ed = st + rng.uniform(frame_interval,
                                      nf * frame_interval / 2)
                w.put(str(qid), {"input_ids": ids, "target": [st, ed]})
                id2len[str(qid)] = len(ids)
                q2v[str(qid)] = vid
                rec = {"desc_id": qid, "desc": "", "vid_name": vid,
                       "ts": [st, ed], "type": rng.choice(["v", "t", "vt"])}
                jf.write(json.dumps(rec) + "\n")
                qid += 1
    _write_json(q_dir, "meta.json", META)
    _write_json(q_dir, "id2len.json", id2len)
    _write_json(q_dir, "query2video.json", q2v)
    os.replace(os.path.join(root, "query_data.jsonl"),
               os.path.join(q_dir, "query_data.jsonl"))

    # --- QA queries (q + A answers, target answer idx + ts)
    qa_dir = os.path.join(root, "qa_query_db")
    qa_id2len, qa_q2v = {}, {}
    with HeroStoreWriter(qa_dir) as w:
        qid = 0
        for vid in vids:
            nf = id2nframe[vid]
            q_ids = [rng.randint(3, 99) for _ in range(5)]
            answers = [[rng.randint(3, 99) for _ in range(4)]
                       for _ in range(n_answers)]
            st = rng.uniform(0, nf * frame_interval / 2)
            w.put(str(qid), {
                "input_ids": [q_ids] + answers,
                "target": rng.randrange(n_answers),
                "ts": [st, st + frame_interval * 2],
            })
            qa_id2len[str(qid)] = len(q_ids)
            qa_q2v[str(qid)] = vid
            qid += 1
    _write_json(qa_dir, "meta.json", META)
    _write_json(qa_dir, "id2len.json", qa_id2len)
    _write_json(qa_dir, "query2video.json", qa_q2v)

    # --- VIOLIN statements (paired _0/_1)
    vl_dir = os.path.join(root, "violin_query_db")
    vl_id2len, vl_q2v = {}, {}
    with HeroStoreWriter(vl_dir) as w:
        for i, vid in enumerate(vids):
            for suffix, tgt in (("_0", 0), ("_1", 1)):
                q = f"s{i}{suffix}"
                ids = [rng.randint(3, 99) for _ in range(6)]
                if correlated:
                    # entailment carries a learnable rule: a TRUE statement
                    # opens with its own video's identity token, a FALSE
                    # one with another video's — so the binary head must
                    # learn "statement token matches the video's feature
                    # direction" (the same video-identity structure the
                    # retrieval signal uses), not memorize labels
                    match = i if tgt == 1 else (i + 1) % len(vids)
                    ids = [id_tok(match)] * 3 + ids[3:]
                w.put(q, {"input_ids": ids, "target": tgt})
                vl_id2len[q] = len(ids)
                vl_q2v[q] = vid
    _write_json(vl_dir, "meta.json", META)
    _write_json(vl_dir, "id2len.json", vl_id2len)
    _write_json(vl_dir, "query2video.json", vl_q2v)

    # --- TVC captions
    cap_root = os.path.join(root, "cap_db_root")
    cap_dir = os.path.join(cap_root, "cap.db")
    clip_dir = os.path.join(cap_root, "clip.db")
    vid2caps, cap2vid = {}, {}
    vid2clips, clip2vid = {}, {}
    os.makedirs(cap_root, exist_ok=True)
    with HeroStoreWriter(cap_dir) as w, HeroStoreWriter(clip_dir) as cw:
        cid = 0
        for vid in vids:
            nf = id2nframe[vid]
            caps = []
            for _ in range(2):
                ids = [rng.randint(3, 99)
                       for _ in range(rng.randint(4, 9))]
                st = rng.uniform(0, nf * frame_interval / 2)
                ts = [st, st + rng.uniform(2, 8)]
                w.put(str(cid), {
                    "input_ids": ids,
                    "ts": ts,
                    "clip_id": cid,
                })
                # one clip per caption here (TVC has ~2-4 captions per
                # clip in the real data; 1:1 keeps the corpus small)
                cw.put(str(cid), {
                    "vid_name": vid, "ts": ts,
                    "captions": [{"id": str(cid),
                                  "text": " ".join(map(str, ids))}],
                })
                clip2vid[str(cid)] = vid
                vid2clips.setdefault(vid, []).append(str(cid))
                caps.append(str(cid))
                cap2vid[str(cid)] = vid
                cid += 1
            vid2caps[vid] = caps
    _write_json(cap_root, "meta.json", META)
    _write_json(cap_dir, "vid2caps.json", vid2caps)
    _write_json(cap_dir, "cap2vid.json", cap2vid)
    _write_json(clip_dir, "vid2clips.json", vid2clips)
    _write_json(clip_dir, "clip2vid.json", clip2vid)

    return {"sub": sub_dir, "vfeat": vfeat_dir, "query": q_dir,
            "qa_query": qa_dir, "violin_query": vl_dir, "cap": cap_root,
            "vids": vids}


# JAX-layout encoder-layer leaves -> the reference's per-layer module names
# (BertLayer; the TVC decoder's BertDecoderLayer keeps its 'intermidiate'
# spelling, reference model/tvc.py:107-122)
_ENCODER_LAYER = (("attention/query", "attention.self.query"),
                  ("attention/key", "attention.self.key"),
                  ("attention/value", "attention.self.value"),
                  ("attention/out", "attention.output.dense"),
                  ("attention/out_ln", "attention.output.LayerNorm"),
                  ("ffn/intermediate", "intermediate.dense"),
                  ("ffn/output", "output.dense"),
                  ("ffn/ln", "output.LayerNorm"))
_DECODER_LAYER = (("self_attention/query", "self_attention.query"),
                  ("self_attention/key", "self_attention.key"),
                  ("self_attention/value", "self_attention.value"),
                  ("self_attention/out", "add_norm_1.dense"),
                  ("self_attention/out_ln", "add_norm_1.LayerNorm"),
                  ("cross_attention/query", "dec_enc_attention.query"),
                  ("cross_attention/key", "dec_enc_attention.key"),
                  ("cross_attention/value", "dec_enc_attention.value"),
                  ("cross_attention/out", "add_norm_2.dense"),
                  ("cross_attention/out_ln", "add_norm_2.LayerNorm"),
                  ("ffn/intermediate", "intermidiate.dense"),
                  ("ffn/output", "add_norm_3.dense"),
                  ("ffn/ln", "add_norm_3.LayerNorm"))

# (JAX subtree, reference module, kind) of every module outside the
# encoder stacks; 'linear' and 'ln' name a kernel/bias or scale/bias pair,
# 'emb' one array, 'conv' a (k,) tap vector, 'vector' a bias-free (D, 1)
# kernel.  A row whose JAX subtree is absent is skipped.
_MODULES = (
    ("v_encoder/f_encoder/embeddings/word_emb",
     "v_encoder.f_encoder.embeddings.word_embeddings", "vocab"),
    ("v_encoder/f_encoder/embeddings/pos_emb",
     "v_encoder.f_encoder.embeddings.position_embeddings", "emb"),
    ("v_encoder/f_encoder/embeddings/type_emb",
     "v_encoder.f_encoder.embeddings.token_type_embeddings", "emb"),
    ("v_encoder/f_encoder/embeddings/ln",
     "v_encoder.f_encoder.embeddings.LayerNorm", "ln"),
    ("v_encoder/f_encoder/img_embeddings/img_linear",
     "v_encoder.f_encoder.img_embeddings.img_linear", "linear"),
    ("v_encoder/f_encoder/img_embeddings/img_ln",
     "v_encoder.f_encoder.img_embeddings.img_LayerNorm", "ln"),
    ("v_encoder/f_encoder/img_embeddings/pos_emb",
     "v_encoder.f_encoder.img_embeddings.position_embeddings", "emb"),
    ("v_encoder/f_encoder/img_embeddings/mask_emb",
     "v_encoder.f_encoder.img_embeddings.mask_embedding", "emb"),
    ("v_encoder/f_encoder/img_embeddings/ln",
     "v_encoder.f_encoder.img_embeddings.LayerNorm", "ln"),
    ("v_encoder/f_encoder/pooler/dense",
     "v_encoder.f_encoder.pooler.dense", "linear"),
    ("v_encoder/f_encoder/lm_head/dense",
     "v_encoder.f_encoder.lm_head.dense", "linear"),
    ("v_encoder/f_encoder/lm_head/ln",
     "v_encoder.f_encoder.lm_head.LayerNorm", "ln"),
    ("v_encoder/c_encoder/embeddings/pos_emb",
     "v_encoder.c_encoder.embeddings.position_embeddings", "emb"),
    ("v_encoder/c_encoder/embeddings/ln",
     "v_encoder.c_encoder.embeddings.LayerNorm", "ln"),
    ("v_encoder/c_encoder/pooler/dense",
     "v_encoder.c_encoder.pooler.dense", "linear"),
    ("v_encoder/frame_transform/ln", "v_encoder.frame_transform.LayerNorm",
     "ln"),
    ("v_encoder/frame_transform/dense", "v_encoder.frame_transform.net.1",
     "linear"),
    ("v_encoder/feat_regress/dense_1", "v_encoder.feat_regress.net.0",
     "linear"),
    ("v_encoder/feat_regress/ln", "v_encoder.feat_regress.net.2", "ln"),
    ("v_encoder/feat_regress/dense_2", "v_encoder.feat_regress.net.3",
     "linear"),
    ("v_encoder/mask_embedding", "v_encoder.mask_embedding", "emb"),
    ("v_encoder/fom_output/linear_1", "v_encoder.fom_output.linear_1",
     "linear"),
    ("v_encoder/fom_output/ln", "v_encoder.fom_output.LayerNorm", "ln"),
    ("v_encoder/fom_output/linear_2", "v_encoder.fom_output.linear_2",
     "linear"),
    ("head/video_query_linear", "video_query_linear", "linear"),
    ("head/video_st_predictor/kernel", "video_st_predictor", "conv"),
    ("head/video_ed_predictor/kernel", "video_ed_predictor", "conv"),
    ("head/q_feat_attn/query_input_proj/ln",
     "q_feat_attn.query_input_proj.LayerNorm", "ln"),
    ("head/q_feat_attn/query_input_proj/dense",
     "q_feat_attn.query_input_proj.net.1", "linear"),
    ("head/q_feat_attn/pos_embed/pos_emb",
     "q_feat_attn.query_pos_embed.position_embeddings", "emb"),
    ("head/q_feat_attn/pos_embed/ln", "q_feat_attn.query_pos_embed.LayerNorm",
     "ln"),
    ("head/q_feat_attn/attention/query",
     "q_feat_attn.query_self_attention.self.query", "linear"),
    ("head/q_feat_attn/attention/key",
     "q_feat_attn.query_self_attention.self.key", "linear"),
    ("head/q_feat_attn/attention/value",
     "q_feat_attn.query_self_attention.self.value", "linear"),
    ("head/q_feat_attn/attention/out",
     "q_feat_attn.query_self_attention.output.dense", "linear"),
    ("head/q_feat_attn/attention/out_ln",
     "q_feat_attn.query_self_attention.output.LayerNorm", "ln"),
    ("head/q_feat_attn/modular_vector/kernel",
     "q_feat_attn.modular_vector_mapping", "vector"),
    ("head/qa_pool/kernel", "qa_pool", "vector"),
    ("head/qa_pred_head/linear_1", "qa_pred_head.linear_1", "linear"),
    ("head/qa_pred_head/ln", "qa_pred_head.LayerNorm", "ln"),
    ("head/qa_pred_head/linear_2", "qa_pred_head.linear_2", "linear"),
    ("head/st_ed_pool/kernel", "st_ed_pool", "vector"),
    ("head/st_ed_pred_head/linear_1", "st_ed_pred_head.linear_1", "linear"),
    ("head/st_ed_pred_head/ln", "st_ed_pred_head.LayerNorm", "ln"),
    ("head/st_ed_pred_head/linear_2", "st_ed_pred_head.linear_2", "linear"),
    ("head/violin_pool/kernel", "violin_pool", "vector"),
    ("head/violin_pred_head/linear_1", "violin_pred_head.linear_1",
     "linear"),
    ("head/violin_pred_head/ln", "violin_pred_head.LayerNorm", "ln"),
    ("head/violin_pred_head/linear_2", "violin_pred_head.linear_2",
     "linear"),
    ("position_embeddings", "position_embeddings", "emb"),
    ("emb_ln", "emb_LayerNorm", "ln"),
)
_STACKS = (("v_encoder/f_encoder/encoder/layers",
            "v_encoder.f_encoder.encoder.layer", _ENCODER_LAYER),
           ("v_encoder/c_encoder/encoder/layers",
            "v_encoder.c_encoder.encoder.layer", _ENCODER_LAYER),
           ("decoder/layers", "decoder.layer", _DECODER_LAYER))


def _flat(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def reference_state_dict(tree: Mapping[str, Any],
                         vocab: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
    """The reference-layout state dict (``hero-tv-ht100.pt``'s key names and
    shapes) of a JAX-layout parameter tree, nested or flat ``{"a/b/c":
    array}``: the inverse of ``convert/torch_checkpoint.convert_state_dict``.
    Linear weights are written ``(out, in)``, the st/ed conv taps
    ``(1, 1, k)``, the encoder and decoder stacks as per-layer keys, and
    the tied ``lm_head.decoder.weight`` beside the word embedding.
    ``vocab`` cuts the word rows and the LM bias to that many (the
    released file has RoBERTa's 50265).  Keys the tree lacks are left
    out; fp32 CPU tensors."""
    flat = {k: np.asarray(v, np.float32) for k, v in _flat(tree).items()
            if not k.startswith("__")}
    sd: Dict[str, np.ndarray] = {}

    def rows(x):
        return x if vocab is None else x[:vocab]

    def put(ref: str, jax_key: str, kind: str):
        if kind in ("linear", "ln"):
            w, b = ("kernel", "bias") if kind == "linear" else ("scale",
                                                                "bias")
            if f"{jax_key}/{w}" not in flat:
                return
            x = flat[f"{jax_key}/{w}"]
            sd[f"{ref}.weight"] = x.T if kind == "linear" else x
            if f"{jax_key}/{b}" in flat:
                sd[f"{ref}.bias"] = flat[f"{jax_key}/{b}"]
            return
        if jax_key not in flat:
            return
        x = flat[jax_key]
        sd[f"{ref}.weight"] = {"vocab": rows, "emb": lambda a: a,
                               "conv": lambda a: a.reshape(1, 1, -1),
                               "vector": lambda a: a.T}[kind](x)

    for jax_key, ref, kind in _MODULES:
        put(ref, jax_key, kind)
    lm_bias = "v_encoder/f_encoder/lm_head/bias"
    if lm_bias in flat:
        sd["v_encoder.f_encoder.lm_head.bias"] = rows(flat[lm_bias])
        sd["v_encoder.f_encoder.lm_head.decoder.weight"] = rows(
            flat["v_encoder/f_encoder/embeddings/word_emb"])
    for jax_stack, ref_stack, layer in _STACKS:
        first = f"{jax_stack}/{layer[0][0]}/kernel"
        if first not in flat:
            continue
        for i in range(flat[first].shape[0]):
            for jax_sub, ref_sub in layer:
                ref = f"{ref_stack}.{i}.{ref_sub}"
                leaf = f"{jax_stack}/{jax_sub}"
                if f"{leaf}/kernel" in flat:
                    sd[f"{ref}.weight"] = flat[f"{leaf}/kernel"][i].T
                else:
                    sd[f"{ref}.weight"] = flat[f"{leaf}/scale"][i]
                sd[f"{ref}.bias"] = flat[f"{leaf}/bias"][i]
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}
