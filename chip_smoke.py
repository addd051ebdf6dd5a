#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's VCMR serving path on one GPU and check it.

    python3 chip_smoke.py                  # on a machine with one CUDA card
    python3 chip_smoke.py --json-out F     # also write the full record to F
    python3 chip_smoke.py --rehearse       # CPU, tiny config, plain versions

What the card run does, in order (any failure exits non-zero):

1. builds the port's CUDA kernels from ``hero_tpu_torch/ops/csrc`` (one
   nvcc per source, all at once);
2. holds every kernel against its plain PyTorch version at the serving
   path's shapes, in fp32 (tight) and bf16, including a fully masked row
   that must come out finite, and times kernel, plain version and one
   PyTorch library call (the yardstick);
3. initialises the flagship HERO weights (hidden 768, f-encoder 6 layers,
   c-encoder 3 layers, 12 heads, vocab 50272, 4352-d features) from a seed
   with numpy, in the JAX layout, and loads them through the bridge;
4. times phase 1 (embedding a 2000-video corpus in the packed TV layout,
   batches of 50) and phase 2 (512 queries in batches of 64) in bf16;
5. runs the whole serving path -- ``validate_full_vcmr`` with synthetic
   ground truth -- with every kernel launch counter at 0 before and read
   after, and checks the submission and metrics;
6. checks, in fp32, that a small corpus ranked through the kernels on the
   card gives the same top-10 videos per query as the plain path on the
   CPU, with scores within tolerance.

It prints one ``phases`` JSON line, one ``kernels`` JSON line, the card's
name and power limit (nvidia-smi), and as the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # CUDA cores, no tensor cores
N_VIDEOS, VIDEO_BS = 2000, 50
N_QUERIES, QUERY_BS, QUERY_SLOTS = 512, 64, 30
PHASE_RUNS = 3                     # timed runs of each phase; median kept


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls.

    A spin kernel holds the card while the host queues the calls, so a
    call whose launch costs the host more than the card's work (the
    30-key attention, the plain versions' many small ops) is timed on the
    card, not at the host's launch rate.  The spin is lengthened until
    the start event is still pending when the last call is queued."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 1 << 22                                   # clock cycles
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        if spin >= 1 << 34:
            raise RuntimeError("the host did not queue the timed calls "
                               "within a spin of 2^34 cycles")
        spin *= 4


def bound_ms(n_bytes, n_flops, dtype_name):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_class(name):
    if "packed_attention_kernel" in name:
        return "attention_kernel"
    if "layer_norm_kernel" in name:
        return "layer_norm_kernel"
    if any(t in name.lower() for t in ("gemm", "cutlass", "sm90_xmma",
                                       "nvjet", "cublas")):
        return "matmul"
    if "sort" in name.lower() or "radix" in name.lower():
        return "sort"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copy"
    return "other"


def profile_breakdown(torch, fn, iters=3):
    """Device time of ``fn`` by kernel class over ``iters`` calls, from a
    torch.profiler trace, beside the host wall time of the same window:
    the idle share is 1 - busy / wall (one stream, so kernels do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, by_kernel, n_events = {}, {}, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_events += 1
        ms = ev.time_range.elapsed_us() / 1e3 / iters
        cls = _kernel_class(ev.name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        by_kernel[ev.name[:80]] = by_kernel.get(ev.name[:80], 0.0) + ms
    if not n_events:
        return {"device_events": 0, "note": "the trace holds no device "
                "events: device time not measured"}
    busy = sum(by_class.values())
    wall_ms = wall * 1e3 / iters
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"device_events": n_events, "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_ms_by_class": by_class, "top_kernels_ms": dict(top)}


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def _bf16_tol(ref):
    # kernel and plain version read the same bf16 inputs, compute in fp32
    # and round once: they differ by at most one bf16 ulp of the output,
    # <= 2^-7 * max|out|
    return float(ref.float().abs().max()) * 2.0 ** -7


def check_attention(torch, F, att, B, L, D, H, mask, seg_mode,
                    timing_dtype):
    """Hold the attention kernel against ``packed_reference`` at (B, L, D)
    with the path's own mask / segment ids; row 0 fully masked."""
    dev = mask.device
    gen = torch.Generator(device=dev).manual_seed(B * L)
    mask = mask.clone()
    mask[0] = -1 if seg_mode else 0            # fully masked row
    kw = {"seg": mask} if seg_mode else {"kv_mask": mask}
    launch = att.seg_attention_cuda if seg_mode else att.valid_attention_cuda
    rows, record = {}, {}
    for dtype, tol_fn, why in (
            (torch.float32, lambda ref: 1e-4,
             "fp32: reassociated 64-term dots and <=104-term softmax/P.V "
             "sums, ~200 ulp at |out|~4"),
            (torch.bfloat16, _bf16_tol, "bf16: one bf16 ulp of max|out|")):
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
        q, k, v = qkv.split(D, dim=-1)
        out = launch(q, k, v, H, mask)
        ref = att.packed_reference(q, k, v, H, **kw)
        err = float((out.float() - ref.float()).abs().max())
        tol = tol_fn(ref)
        # the fully masked row: the -1e4 added to every key cancels in the
        # softmax, so the row is finite and equals unmasked attention up to
        # the fp32 rounding of s - 1e4 (half an ulp of 1e4 = 2^-11 in s,
        # ~2^-10 relative in the probabilities)
        free = att.packed_reference(q[:1], k[:1], v[:1], H)[0]
        row_err = float((out[0].float() - free.float()).abs().max())
        row_tol = 2.0 ** -9 * float(v[0].float().abs().max()) + tol
        rec = {"max_abs_err": err, "tol": tol, "tol_reason": why,
               "masked_row_err": row_err, "masked_row_tol": row_tol}
        ok = (err <= tol and row_err <= row_tol
              and bool(torch.isfinite(out).all()))
        if dtype == torch.float32:
            # the plain version on the card can round exactly as the
            # kernel does (same fma order in cuBLAS, the same warp-shuffle
            # softmax); the CPU's sums are another order altogether
            cpu = att.packed_reference(
                *(t.cpu() for t in (q, k, v)), H,
                **{n: m.cpu() for n, m in kw.items()})
            rec["cpu_plain_err"] = float((out.cpu() - cpu).abs().max())
            ok = ok and rec["cpu_plain_err"] <= tol
        rec["ok"] = ok
        record[str(dtype).split(".")[1]] = rec
        rows[dtype] = (q, k, v, ref)
        if not ok:
            raise AssertionError(f"attention {[B, L, D]} {dtype}: {rec}")
    q, k, v, _ = rows[timing_dtype]
    ms = time_ms(torch, lambda: launch(q, k, v, H, mask))
    plain_ms = time_ms(torch, lambda: att.packed_reference(q, k, v, H, **kw))
    d = D // H
    if seg_mode:
        allowed = (mask[:, :, None] == mask[:, None, :]) & (mask >= 0)[:, :,
                                                                      None]
    else:
        allowed = (mask[:, None, :] > 0).expand(B, L, L)
    bias = torch.where(allowed, 0.0, -1e4).to(q.dtype)[:, None]

    def heads(t):
        return t.view(B, L, H, d).transpose(1, 2)

    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        heads(q), heads(k), heads(v), attn_mask=bias))
    elt = q.element_size()
    n_bytes = 4 * B * L * D * elt + B * L * 4
    n_flops = 4 * B * H * L * L * d
    b_ms, by = bound_ms(n_bytes, n_flops, str(timing_dtype).split(".")[1])
    return {"shape": [B, L, D], "heads": H, "dtype": "bfloat16",
            "max_abs_err": record["bfloat16"]["max_abs_err"],
            "tol": record["bfloat16"]["tol"], "checks": record,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def check_layer_norm(torch, F, lnm, n, d, x_bf16):
    dev = x_bf16.device
    gen = torch.Generator(device=dev).manual_seed(n + d)
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    b = 0.1 * torch.randn(d, generator=gen, device=dev)
    record = {}
    for dtype, tol_fn, why in (
            (torch.float32, lambda ref: 1e-4,
             "fp32: reassociated row sums of up to 4352 terms"),
            (torch.bfloat16, _bf16_tol, "bf16: one bf16 ulp of max|out|")):
        x = x_bf16.to(dtype)
        out = lnm.layer_norm_cuda(x, w, b)
        ref = lnm.layer_norm_reference(x, w, b)
        err = float((out.float() - ref.float()).abs().max())
        tol = tol_fn(ref)
        record[str(dtype).split(".")[1]] = {"max_abs_err": err, "tol": tol,
                                            "tol_reason": why,
                                            "ok": err <= tol}
        if err > tol:
            raise AssertionError(f"layer_norm {[n, d]} {dtype}: err "
                                 f"{err:.3g} (tol {tol:.3g})")
    x = x_bf16
    ms = time_ms(torch, lambda: lnm.layer_norm_cuda(x, w, b))
    plain_ms = time_ms(torch, lambda: lnm.layer_norm_reference(x, w, b))
    w16, b16 = w.to(x.dtype), b.to(x.dtype)
    lib_ms = time_ms(torch, lambda: F.layer_norm(x, (d,), w16, b16, 1e-5))
    # ~8 fp32 operations per element on the CUDA cores (no tensor-core
    # work): two passes of sums, the centring, the scale and the affine
    b_ms, by = bound_ms(2 * n * d * x.element_size() + 2 * d * 4,
                        8 * n * d, "float32")
    return {"shape": [n, d], "dtype": "bfloat16",
            "max_abs_err": record["bfloat16"]["max_abs_err"],
            "tol": record["bfloat16"]["tol"], "checks": record,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def check_kernels(torch, first_batch, query_masks, cfg):
    """Every kernel of the path at the path's shapes (bf16 timings)."""
    import torch.nn.functional as F
    from hero_tpu_torch.models.model import gather_sub_frames
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import layernorm as lnm
    dev = torch.device("cuda")
    D, H = cfg.f_config.hidden_size, cfg.f_config.num_attention_heads
    b = {k: torch.from_numpy(v).to(dev) for k, v in first_batch.items()}
    B, S, Lt = b["sub_input_ids"].shape
    Fs = b["sub_frame_idx"].shape[2]
    seg = torch.cat([b["sub_frame_seg"], b["sub_txt_seg"]],
                    dim=2).reshape(B * S, Fs + Lt)
    qm = torch.from_numpy(query_masks).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    # the two 4352-wide LayerNorm inputs: the gathered per-slot frame
    # features (img_ln) and the clip features (frame_transform)
    feats = b["c_v_feats"].reshape(-1, cfg.vfeat_dim)
    img_rows = (gather_sub_frames(b["c_v_feats"], b["sub_frame_idx"])
                * b["sub_frame_mask"][..., None].half()
                ).reshape(-1, cfg.vfeat_dim)
    # one entry per kernel; its first shape is the one its top-level
    # numbers are taken at, every shape is checked and timed
    kernels = [
        ("attention_seg", "attention.cu", "attention.py:304",
         "_fwd3_seg_kernel", "seg_attention_cuda",
         "F.scaled_dot_product_attention, additive mask",
         [check_attention(torch, F, att, B * S, Fs + Lt, D, H, seg, True,
                          torch.bfloat16)]),
        ("attention_valid", "attention.cu", "attention.py:277",
         "_fwd3_kernel", "valid_attention_cuda",
         "F.scaled_dot_product_attention, additive mask",
         [check_attention(torch, F, att, B, b["c_attn_masks"].shape[1], D,
                          cfg.c_config.num_attention_heads,
                          b["c_attn_masks"], False, torch.bfloat16),
          check_attention(torch, F, att, qm.shape[0], qm.shape[1], D, H, qm,
                          False, torch.bfloat16)]),
        ("layer_norm", "layernorm.cu", "layernorm.py:53", "_fwd_kernel",
         "layer_norm_cuda", "F.layer_norm (bf16 weights)",
         [check_layer_norm(torch, F, lnm, feats.shape[0], cfg.vfeat_dim,
                           feats.to(torch.bfloat16)),
          check_layer_norm(torch, F, lnm, img_rows.shape[0], cfg.vfeat_dim,
                           img_rows.to(torch.bfloat16)),
          check_layer_norm(torch, F, lnm, B * S * (Fs + Lt), D,
                           torch.randn((B * S * (Fs + Lt), D), generator=gen,
                                       device=dev).to(torch.bfloat16))]),
    ]
    out = []
    for name, src, tpu, tpu_fn, counter, lib_call, shapes in kernels:
        main = shapes[0]
        out.append({"name": name, "route": "cuda",
                    "source": f"hero_tpu_torch/ops/csrc/{src}",
                    "replaces": f"hero_tpu/ops/{tpu}", "tpu_kernel": tpu_fn,
                    "counter": counter, "library_call": lib_call,
                    **{k: main[k] for k in (
                        "shape", "dtype", "max_abs_err", "tol", "ms",
                        "plain_ms", "bound_ms", "bound_by", "library_ms")},
                    "shapes": shapes})
    return out


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------

def make_corpus(n_videos, video_bs, shape, seed=3):
    """TV-distribution videos in the packed layout, ``video_bs`` per batch."""
    from hero_tpu_torch.data.occupancy import sample_tv_video
    from hero_tpu_torch.data.synthetic import tv_vsm_batch
    r = np.random.RandomState(seed)
    batches, dropped = [], []
    for i in range(n_videos // video_bs):
        videos = [sample_tv_video(r) for _ in range(video_bs)]
        b, drop = tv_vsm_batch(videos, shape, seed=seed + 1 + i)
        batches.append(b)
        dropped.append(drop)
    return batches, float(np.mean(dropped))


def make_queries(n_queries, query_bs, slots, vocab, video_ids, interval,
                 seed=0):
    """Query batches with TVR-like lengths N(15, 4) clipped to [5, slots]
    and synthetic ground truth (a random video and span per query)."""
    r = np.random.RandomState(seed)
    lens = np.clip(np.round(r.normal(15.0, 4.0, n_queries)), 5,
                   slots).astype(np.int64)
    ids = r.randint(3, vocab, (n_queries, slots)).astype(np.int32)
    masks = (np.arange(slots)[None, :] < lens[:, None]).astype(np.float32)
    gt = [video_ids[r.randint(len(video_ids))] for _ in range(n_queries)]
    types = ("v", "t", "vt")
    query_data = {}
    for q in range(n_queries):
        st = int(r.randint(0, 50))
        ed = st + int(r.randint(2, 16))
        query_data[q] = {"desc_id": q, "desc": "", "vid_name": gt[q],
                         "ts": [st * interval, ed * interval],
                         "type": types[q % 3]}
    batches = [{"qids": list(range(s, s + query_bs)),
                "vids": gt[s:s + query_bs],
                "query_input_ids": ids[s:s + query_bs],
                "query_attn_masks": masks[s:s + query_bs]}
               for s in range(0, n_queries, query_bs)]
    return batches, query_data


def counters():
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import layernorm as lnm
    return {"seg_attention_cuda": att.seg_attention_cuda,
            "valid_attention_cuda": att.valid_attention_cuda,
            "layer_norm_cuda": lnm.layer_norm_cuda}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def check_submission(sub, metrics, n_queries, n_videos, opts):
    for task in ("VCMR", "SVMR", "VR"):
        if len(sub[task]) != n_queries:
            raise AssertionError(f"{task}: {len(sub[task])} entries")
        for e in sub[task]:
            preds = np.asarray(e["predictions"], np.float64)
            want = (min(100, n_videos) if task == "VR"
                    else opts.max_after_nms)
            if preds.shape != (want, 4) or not np.isfinite(preds).all():
                raise AssertionError(f"{task} entry {e['desc_id']}: "
                                     f"predictions {preds.shape}")
            if np.any(np.diff(preds[:, 3]) > 0) and task != "SVMR":
                raise AssertionError(f"{task} scores not sorted")
            if task == "VR" and len(set(preds[:, 0])) != want:
                raise AssertionError("VR repeats a video")
            if task == "VCMR" and np.any(preds[:, 2] <= preds[:, 1]):
                raise AssertionError("VCMR span with ed <= st")
    for task in ("VCMR", "SVMR", "VR"):
        vals = list(metrics[task].values())
        if not vals or not all(0.0 <= v <= 100.0 for v in vals):
            raise AssertionError(f"{task} metrics out of range: "
                                 f"{metrics[task]}")


def integration_check(torch, cfg, flat, vsm, opts, batches, queries,
                      device_kernel, device_plain):
    """fp32: the scorer's top-10 videos through the kernels on the card
    equal those of the plain path on the CPU; scores within tolerance."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.evaluation.vcmr_eval import (embed_video_corpus,
                                                     make_query_scorer)
    outs = {}
    for dev in (device_kernel, device_plain):
        params = load_jax_params(flat, device=dev)
        embs, masks = embed_video_corpus(params, cfg, batches, torch.float32,
                                         dev)
        score, _ = make_query_scorer(params, cfg, vsm, opts, embs, masks,
                                     torch.float32)
        res = score(torch.from_numpy(queries["query_input_ids"]),
                    torch.from_numpy(queries["query_attn_masks"]))
        outs[dev] = (embs.cpu(), res[2].cpu(), res[3].cpu())
    (ek, sk, ik), (ep, sp, ip) = outs[device_kernel], outs[device_plain]
    emb_err = float((ek - ep).abs().max())
    k = min(10, ik.shape[1])
    # exp(q2c_alpha * s) multiplies the ~1e-6 fp32 noise of the cosine s
    # by q2c_alpha = 20
    rtol = 1e-3
    score_rel = float(((sk[:, :k] - sp[:, :k]).abs()
                       / sp[:, :k].abs().clamp(min=1e-30)).max())
    same = bool(torch.equal(ik[:, :k], ip[:, :k]))
    rec = {"n_videos": int(ek.shape[0]), "n_queries": int(ik.shape[0]),
           "top_k": k, "top_idx_equal": same, "score_max_rel_err": score_rel,
           "score_rtol": rtol, "frame_emb_max_abs_err": emb_err}
    if not same or score_rel > rtol:
        raise AssertionError(f"fp32 kernel path vs plain CPU path: {rec}")
    return rec


def gpu_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json-out", default=None,
                    help="also write the full record (JSON) to this file")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at a tiny size with the plain "
                         "versions; prints no result line")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one phase-1 batch and one query batch "
                         "with torch.profiler and record device time by "
                         "kernel class (in the --json-out record)")
    args = ap.parse_args(argv)

    import torch
    rehearse = args.rehearse
    if not rehearse and not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this check "
            "needs one CUDA card")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hero_tpu_torch.config.model_config import (HeroConfig,
                                                    TransformerConfig,
                                                    flagship_config)
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.data.synthetic import TV_PACKED
    from hero_tpu_torch.evaluation.vcmr_eval import (VcmrEvalOpts,
                                                     embed_video_corpus,
                                                     make_query_scorer,
                                                     validate_full_vcmr)
    from hero_tpu_torch.models.pretrain import VsmConfig, init_flat_params
    from hero_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    record = {}
    if rehearse:
        dev, dtype = "cpu", torch.float32
        base = TransformerConfig(hidden_size=64, num_hidden_layers=1,
                                 num_attention_heads=2, intermediate_size=128)
        cfg = HeroConfig(f_config=base, c_config=base,
                         q_config=base.replace(num_hidden_layers=0,
                                               type_vocab_size=1),
                         vfeat_dim=64)
        n_videos, video_bs, n_queries, query_bs = 20, 10, 32, 16
    else:
        dev, dtype = "cuda", torch.bfloat16
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("fp32 matmuls must not run in TF32")
        record["versions"] = {"python": sys.version.split()[0],
                              "torch": torch.__version__,
                              "cuda": torch.version.cuda}
        t0 = time.perf_counter()
        cuda_build.build()
        record["build_s"] = time.perf_counter() - t0
        log(f"kernels built in {record['build_s']:.1f} s")
        cfg = flagship_config()
        n_videos, video_bs = N_VIDEOS, VIDEO_BS
        n_queries, query_bs = N_QUERIES, QUERY_BS

    vsm = VsmConfig(lw_neg_ctx=8.0, lw_neg_q=8.0, lw_st_ed=0.01)
    opts = VcmrEvalOpts(max_vcmr_video=100, min_pred_l=2, max_pred_l=16,
                        max_before_nms=200, vfeat_interval=1.5,
                        max_clip_len=100)
    shape = dataclasses.replace(TV_PACKED, batch=video_bs, n_queries=1,
                                vfeat_dim=cfg.vfeat_dim)
    t0 = time.perf_counter()
    batches, dropped = make_corpus(n_videos, video_bs, shape)
    video_ids = [f"video{i:05d}" for i in range(n_videos)]
    video2idx = {v: i for i, v in enumerate(video_ids)}
    query_batches, query_data = make_queries(
        n_queries, query_bs, QUERY_SLOTS, 50265, video_ids,
        opts.vfeat_interval)
    flat = init_flat_params(cfg, vsm, seed=0)
    params = load_jax_params(flat, device=dev)
    record["setup_s"] = time.perf_counter() - t0
    record["subs_dropped_frac"] = dropped
    log(f"setup (corpus, queries, weights) {record['setup_s']:.1f} s")

    if not rehearse:
        record["kernels"] = check_kernels(
            torch, batches[0], query_batches[0]["query_attn_masks"], cfg)
        log("kernel checks passed")

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    # phase 1 and phase 2 alone, timed, with per-batch launch counts
    embed_video_corpus(params, cfg, batches[:1], dtype, dev)     # warm-up
    sync()
    reset_counts()
    embed_video_corpus(params, cfg, batches[:1], dtype, dev)
    sync()
    per_video_batch = read_counts()
    p1_runs = []
    for _ in range(PHASE_RUNS):
        frame_embs = frame_masks = None
        t0 = time.perf_counter()
        frame_embs, frame_masks = embed_video_corpus(params, cfg, batches,
                                                     dtype, dev)
        sync()
        p1_runs.append(time.perf_counter() - t0)
    scorer, _ = make_query_scorer(params, cfg, vsm, opts, frame_embs,
                                  frame_masks, dtype)
    qb0 = query_batches[0]

    def run_query_batch(qb):
        out = scorer(torch.from_numpy(qb["query_input_ids"]),
                     torch.from_numpy(qb["query_attn_masks"]))
        return [x.cpu() for x in out]

    run_query_batch(qb0)                                         # warm-up
    reset_counts()
    run_query_batch(qb0)
    per_query_batch = read_counts()
    p2_runs = []
    for _ in range(PHASE_RUNS):
        t0 = time.perf_counter()
        for qb in query_batches:
            run_query_batch(qb)
        sync()
        p2_runs.append(time.perf_counter() - t0)
    if args.profile and not rehearse:
        record["profile"] = {
            "phase1_batch": profile_breakdown(
                torch, lambda: embed_video_corpus(params, cfg, batches[:1],
                                                  dtype, dev)),
            "phase2_batch": profile_breakdown(
                torch, lambda: run_query_batch(qb0))}
    del frame_embs, frame_masks, scorer
    t_p1, t_p2 = float(np.median(p1_runs)), float(np.median(p2_runs))
    record["phases"] = {
        "phase1": {"videos": n_videos, "batch": video_bs, "wall_s": t_p1,
                   "wall_s_runs": p1_runs, "videos_per_s": n_videos / t_p1,
                   "launches_per_batch": per_video_batch},
        "phase2": {"queries": n_queries, "batch": query_bs, "wall_s": t_p2,
                   "wall_s_runs": p2_runs, "queries_per_s": n_queries / t_p2,
                   "launches_per_batch": per_query_batch}}

    # the serving path end to end, counters from 0
    reset_counts()
    t0 = time.perf_counter()
    val_log, submission, metrics = validate_full_vcmr(
        params, cfg, vsm, opts, batches, query_batches, video_ids,
        video2idx, query_data, dtype=dtype, device=dev)
    sync()
    record["main_path_wall_s"] = time.perf_counter() - t0
    launches = read_counts()
    record["main_path_launches"] = launches
    check_submission(submission, metrics, n_queries, n_videos, opts)
    record["metrics"] = {t: metrics[t] for t in ("VCMR", "SVMR", "VR")}
    if not rehearse and min(launches.values()) == 0:
        raise AssertionError(f"a kernel was never launched: {launches}")

    small = dataclasses.replace(shape, batch=10)
    small_batches, _ = make_corpus(20, 10, small, seed=11)
    small_q, _ = make_queries(16, 16, QUERY_SLOTS, 50265,
                              [f"s{i}" for i in range(20)], 1.5, seed=12)
    record["integration_fp32"] = integration_check(
        torch, cfg, flat, vsm, opts, small_batches, small_q[0],
        "cpu" if rehearse else "cuda", "cpu")
    record["total_s"] = time.perf_counter() - t_start

    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"phases": record["phases"],
                      "main_path_wall_s": record["main_path_wall_s"],
                      "integration_fp32": record["integration_fp32"]}))
    if rehearse:
        log(f"rehearsal passed in {record['total_s']:.1f} s")
        return 0
    kernels = [{k: row[k] for k in (
        "name", "route", "source", "replaces", "tpu_kernel", "shape", "dtype",
        "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
        | {"launches": launches[row["counter"]],
           "shapes": [{k: sh[k] for k in (
               "shape", "max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")} for sh in row["shapes"]]}
        for row in record["kernels"]]
    print(json.dumps({"kernels": kernels}))
    print(gpu_identity())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
