#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's VCMR serving path, VSM train step and TVC
caption serving on one GPU and check them.

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
   CPU, with scores within tolerance;
7. the train phase: holds the training kernels (the forward with dropout
   and saved probabilities, the attention and LayerNorm backwards, the
   Philox masks) against their plain versions in fp32 and bf16 at the
   train step's shapes; times the VSM train step at ``bench.py``'s layout
   (32 TV videos a step, the packed bucket and its overflow bucket, bf16,
   dropout 0.1, ``drop_svmr_prob`` 0.8) as the median of 3 runs of 20 fit
   and 8 overflow steps with the launch counters read from 0 around them;
   checks that the loss falls over 20 steps on one batch; and holds one
   fp32 train step through the kernels against the plain path on the CPU;
8. the TVC phase, at ``config/hero_tvc.json``'s model (the flagship
   backbone and a 2-layer decoder): holds the head-major attention
   kernel (#4) against its plain version at the decode step's shapes
   (greedy 32 rows, beam-3 96 rows, 30 keys; causal Lq = Lk = 31; a
   fully masked row; its dropout bits against the plain Philox mask) and
   #2 at the decoder's causal and cross-attention shapes; builds 64
   synthetic TV videos with 4 clips each in an in-memory store; times
   greedy ``generate_clip_captions`` over all 256 clips in bf16 (8
   videos = 32 caption rows a batch, 30 steps; median of 3 runs after a
   warm-up batch, launch counters read from 0 around the first) and one
   beam-3 pass over 2 batches; checks the records (every clip once, the
   schema, ids cut at EOS); and, in fp32 on one batch, that the card's
   greedy ids equal the plain path's on the CPU and a teacher-forced
   replay through ``decode``, both up to the first step whose reference
   top-2 logit gap is below ``TVC_GAP_TOL``.

It prints one ``phases`` JSON line, one train JSON line with
``train_examples_per_s``, one TVC JSON line with ``tvc_captions_per_s``,
one ``kernels`` JSON line, the card's name and power limit (nvidia-smi),
and as the last line ``{"ok": true, "device": {...}}``.  ``--profile``
adds torch.profiler breakdowns of a phase-1 batch, a query batch, one
fit-bucket train step and one greedy TVC batch to the JSON record.
Imports nothing of JAX.
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
import types

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
    the start event is still pending when the last call is queued.  A
    function that launches more kernels than the card's launch queue
    holds (the plain Philox dropout: hundreds of elementwise launches a
    call) blocks the host behind the spin; it is timed without the spin,
    and its card time, far above its launch cost, is then what the
    events measure."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 1 << 22                                   # clock cycles
    while spin <= 1 << 30:
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
        spin *= 4
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_flops, dtype_name):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_class(name):
    if "mha_attention_kernel" in name:
        return "mha_attention_kernel"
    if "packed_attention_bwd_kernel" in name:
        return "attention_bwd_kernel"
    if "packed_attention_kernel" in name:
        return "attention_kernel"
    if "layer_norm_bwd" in name:
        return "layer_norm_bwd_kernels"
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
        out = launch(q, k, v, H, mask)[0]
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
# training kernel checks
# ---------------------------------------------------------------------------

TRAIN_SEED = 2 ** 33 + 12345       # Philox key of the kernel checks
TRAIN_RATE = 0.1                   # the model's dropout rate


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _train_tol(ref, dtype):
    """fp32: sums of <= 144 products (attention) or <= 4352 terms (LN)
    taken in other orders, ~1e-4 of the largest value; bf16: both sides
    read the same bf16 inputs, compute in fp32 and round once: one bf16
    ulp of the largest value."""
    top = float(ref.float().abs().max())
    if dtype == "float32":
        return 1e-4 * max(1.0, top)
    return top * 2.0 ** -7


def check_attention_train(torch, F, att, B, L, D, H, mask, seg_mode):
    """The forward with dropout and saved probabilities and the backward
    kernel, in fp32 and bf16, at rate 0 and 0.1, against the plain
    versions on the same inputs; determinism; bf16 timings at rate 0.1."""
    dev = mask.device
    gen = torch.Generator(device=dev).manual_seed(7 * B + L)
    kw = {"seg": mask} if seg_mode else {"kv_mask": mask}
    launch = att.seg_attention_cuda if seg_mode else att.valid_attention_cuda
    d = D // H
    checks, rows = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
        q, k, v = qkv.split(D, dim=-1)
        dout = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
        for rate in (0.0, TRAIN_RATE):
            out, probs = launch(q, k, v, H, mask, rate, TRAIN_SEED, True)
            ref, rprobs = att.packed_forward_reference(
                q, k, v, H, dropout_rate=rate, seed=TRAIN_SEED,
                save_probs=True, **kw)
            grads = att.attention_bwd_cuda(probs, q, k, v, dout, H, rate,
                                           TRAIN_SEED)
            rgrads = att.packed_backward_reference(probs, q, k, v, dout, H,
                                                   rate, TRAIN_SEED)
            again = att.attention_bwd_cuda(probs, q, k, v, dout, H, rate,
                                           TRAIN_SEED)
            out2 = launch(q, k, v, H, mask, rate, TRAIN_SEED, True)[0]
            rec = {"fwd_err": _err(out, ref), "fwd_tol": _train_tol(ref, name),
                   "probs_err": _err(probs, rprobs),
                   "probs_tol": _train_tol(rprobs, name),
                   "bwd_err": max(_err(a, b) for a, b in zip(grads, rgrads)),
                   "bwd_tol": min(_train_tol(b, name) for b in rgrads),
                   "deterministic": bool(torch.equal(out, out2) and all(
                       torch.equal(a, b) for a, b in zip(grads, again)))}
            rec["ok"] = (rec["fwd_err"] <= rec["fwd_tol"]
                         and rec["probs_err"] <= rec["probs_tol"]
                         and rec["bwd_err"] <= rec["bwd_tol"]
                         and rec["deterministic"]
                         and all(bool(torch.isfinite(g).all())
                                 for g in grads))
            checks[f"{name}_rate{rate}"] = rec
            if not rec["ok"]:
                raise AssertionError(f"attention training kernels "
                                     f"{[B, L, D]} {name} rate {rate}: "
                                     f"{rec}")
        rows[name] = (q, k, v, dout)
    q, k, v, dout = rows["bfloat16"]
    rate = TRAIN_RATE
    probs = launch(q, k, v, H, mask, rate, TRAIN_SEED, True)[1]
    fwd_ms = time_ms(torch, lambda: launch(q, k, v, H, mask, rate,
                                           TRAIN_SEED, True))
    fwd_plain = time_ms(torch, lambda: att.packed_forward_reference(
        q, k, v, H, dropout_rate=rate, seed=TRAIN_SEED, save_probs=True,
        **kw))
    bwd_ms = time_ms(torch, lambda: att.attention_bwd_cuda(
        probs, q, k, v, dout, H, rate, TRAIN_SEED))
    bwd_plain = time_ms(torch, lambda: att.packed_backward_reference(
        probs, q, k, v, dout, H, rate, TRAIN_SEED))
    if seg_mode:
        allowed = ((mask[:, :, None] == mask[:, None, :])
                   & (mask >= 0)[:, :, None])
    else:
        allowed = (mask[:, None, :] > 0).expand(B, L, L)
    bias = torch.where(allowed, 0.0, -1e4).to(q.dtype)[:, None]

    def heads(t):
        return t.reshape(B, L, H, d).transpose(1, 2).detach(
            ).requires_grad_(True)

    hq, hk, hv = heads(q), heads(k), heads(v)
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(hq, hk, hv, attn_mask=bias,
                                                 dropout_p=rate)
    hdo = dout.reshape(B, L, H, d).transpose(1, 2)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        hq.detach(), hk.detach(), hv.detach(), attn_mask=bias,
        dropout_p=rate))
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (hq, hk, hv), hdo, retain_graph=True))
    elt = q.element_size()
    p_bytes = B * H * L * L * elt
    fb, fby = bound_ms(4 * B * L * D * elt + B * L * 4 + p_bytes,
                       4 * B * H * L * L * d, "bfloat16")
    bb, bby = bound_ms(p_bytes + 7 * B * L * D * elt, 8 * B * H * L * L * d,
                       "bfloat16")
    bf = checks["bfloat16_rate0.1"]
    return (
        {"shape": [B, L, D], "mode": "train: dropout 0.1, probs saved",
         "max_abs_err": bf["fwd_err"], "tol": bf["fwd_tol"], "ms": fwd_ms,
         "plain_ms": fwd_plain, "bound_ms": fb, "bound_by": fby,
         "library_ms": lib_fwd, "checks": checks},
        {"shape": [B, L, D], "heads": H, "dtype": "bfloat16",
         "mask": "segment" if seg_mode else "validity",
         "max_abs_err": bf["bwd_err"], "tol": bf["bwd_tol"], "ms": bwd_ms,
         "plain_ms": bwd_plain, "bound_ms": bb, "bound_by": bby,
         "library_ms": lib_bwd, "checks": checks})


def check_dropout_masks(torch, att, drop, shape):
    """The keep mask the kernels draw equals the plain Philox mask, keeps
    Bernoulli(0.9) within 4 sigma, and is the same for one seed."""
    B, H, L = shape
    dev = torch.device("cuda")
    got = att.dropout_keep_mask_cuda(TRAIN_SEED, B, H, L, L, TRAIN_RATE, dev)
    want = drop.attention_keep_mask(TRAIN_SEED, B, H, L, L, TRAIN_RATE,
                                    device=dev)
    again = att.dropout_keep_mask_cuda(TRAIN_SEED, B, H, L, L, TRAIN_RATE,
                                       dev)
    n = got.numel()
    keep = float(got.float().mean())
    sigma = (TRAIN_RATE * (1 - TRAIN_RATE) / n) ** 0.5
    rec = {"shape": [B, H, L, L], "identical_to_plain": bool(
        torch.equal(got, want)), "keep_rate": keep, "sigma": sigma,
        "same_for_one_seed": bool(torch.equal(got, again))}
    rec["ok"] = (rec["identical_to_plain"] and rec["same_for_one_seed"]
                 and abs(keep - (1 - TRAIN_RATE)) <= 4 * sigma)
    if not rec["ok"]:
        raise AssertionError(f"dropout mask: {rec}")
    return rec


def check_layer_norm_bwd(torch, F, lnm, n, d):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(n + 3 * d)
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    x32 = torch.randn((n, d), generator=gen, device=dev) * 2.0 + 0.5
    g32 = torch.randn((n, d), generator=gen, device=dev)
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        x, g = x32.to(dtype), g32.to(dtype)
        got = lnm.layer_norm_bwd_cuda(x, w, g)
        want = lnm.layer_norm_bwd_reference(x, w, g)
        again = lnm.layer_norm_bwd_cuda(x, w, g)
        rec = {"dx_err": _err(got[0], want[0]),
               "dx_tol": _train_tol(want[0], name),
               "dwdb_err": max(_err(got[1], want[1]), _err(got[2], want[2])),
               # fp32 sums of n terms |g xhat| <~ 8 in another order
               "dwdb_tol": 1e-6 * n,
               "deterministic": all(bool(torch.equal(a, b))
                                    for a, b in zip(got, again))}
        rec["ok"] = (rec["dx_err"] <= rec["dx_tol"]
                     and rec["dwdb_err"] <= rec["dwdb_tol"]
                     and rec["deterministic"])
        checks[name] = rec
        if not rec["ok"]:
            raise AssertionError(f"layer_norm backward {[n, d]} {name}: "
                                 f"{rec}")
    x, g = x32.to(torch.bfloat16), g32.to(torch.bfloat16)
    ms = time_ms(torch, lambda: lnm.layer_norm_bwd_cuda(x, w, g))
    plain_ms = time_ms(torch, lambda: lnm.layer_norm_bwd_reference(x, w, g))
    xl = x.detach().requires_grad_(True)
    wl = w.to(x.dtype).requires_grad_(True)
    bl = torch.zeros_like(wl).requires_grad_(True)
    with torch.enable_grad():
        y = F.layer_norm(xl, (d,), wl, bl, 1e-5)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        y, (xl, wl, bl), g, retain_graph=True))
    # read x and g, write dx (bf16); w read and dw/db written in fp32;
    # ~12 fp32 operations per element on the CUDA cores
    b_ms, by = bound_ms(3 * n * d * x.element_size() + 3 * d * 4,
                        12 * n * d, "float32")
    return {"shape": [n, d], "dtype": "bfloat16",
            "max_abs_err": checks["bfloat16"]["dx_err"],
            "tol": checks["bfloat16"]["dx_tol"], "checks": checks, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def check_train_kernels(torch, b_fit, b_over, cfg, kernels):
    """Every kernel of the train step at its shapes.  Adds the training
    forward shapes to the forward kernels' rows of ``kernels`` and returns
    the rows of the two backward kernels."""
    import torch.nn.functional as F
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import dropout as drop
    from hero_tpu_torch.ops import layernorm as lnm
    dev = torch.device("cuda")
    D, H = cfg.f_config.hidden_size, cfg.f_config.num_attention_heads

    def seg_of(b):
        B, S, Lt = b["sub_input_ids"].shape
        Fs = b["sub_frame_idx"].shape[2]
        seg = np.concatenate([b["sub_frame_seg"], b["sub_txt_seg"]], 2)
        return torch.from_numpy(seg.reshape(B * S, Fs + Lt)).to(dev)

    qm = b_fit["query_attn_masks"]
    qm = torch.from_numpy(qm.reshape(-1, qm.shape[-1])).to(dev)
    cm = torch.from_numpy(b_fit["c_attn_masks"]).to(dev)
    fwd, bwd = {"attention_seg": [], "attention_valid": []}, []
    for key, mask, seg_mode in (
            ("attention_seg", seg_of(b_fit), True),
            ("attention_seg", seg_of(b_over), True),
            ("attention_valid", cm, False),
            ("attention_valid", qm, False)):
        f_row, b_row = check_attention_train(
            torch, F, att, mask.shape[0], mask.shape[1], D, H, mask,
            seg_mode)
        fwd[key].append(f_row)
        bwd.append(b_row)
    for row in kernels:
        if row["name"] in fwd:
            row["shapes"] += fwd[row["name"]]
    masks = check_dropout_masks(torch, att, drop, (128, H, 104))
    B, S = b_fit["sub_mask"].shape
    Fs_fit = b_fit["sub_frame_idx"].shape[2]
    F_ = b_fit["c_attn_masks"].shape[1]
    Lf = b_fit["sub_input_ids"].shape[2] + Fs_fit
    Lo = b_over["sub_input_ids"].shape[2] + b_over["sub_frame_idx"].shape[2]
    ln = [check_layer_norm_bwd(torch, F, lnm, n, d) for n, d in (
        (B * F_, cfg.vfeat_dim),                 # frame_transform LN
        (B * S * Fs_fit, cfg.vfeat_dim),         # img_ln, fit bucket
        (B * S * Lf, D),                         # f-encoder LNs, fit
        (B * S * Lo, D))]                        # f-encoder LNs, overflow
    return [
        {"name": "attention_bwd", "route": "cuda",
         "source": "hero_tpu_torch/ops/csrc/attention.cu",
         "replaces": "hero_tpu/ops/attention.py:342",
         "tpu_kernel": "_bwd3_kernel", "counter": "attention_bwd_cuda",
         "library_call": "autograd of F.scaled_dot_product_attention "
                         "(additive mask, dropout_p 0.1): its backward",
         **{k: bwd[0][k] for k in (
             "shape", "dtype", "max_abs_err", "tol", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
         "shapes": bwd, "dropout_masks": masks},
        {"name": "layer_norm_bwd", "route": "cuda",
         "source": "hero_tpu_torch/ops/csrc/layernorm.cu",
         "replaces": "hero_tpu/ops/layernorm.py:64",
         "tpu_kernel": "_bwd_kernel", "counter": "layer_norm_bwd_cuda",
         "library_call": "autograd of F.layer_norm (bf16 weights): its "
                         "backward",
         **{k: ln[0][k] for k in (
             "shape", "dtype", "max_abs_err", "tol", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
         "shapes": ln}]


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
        # serving reads the backbone keys only
        batches.append({k: v for k, v in b.items()
                        if k.startswith(("sub_", "c_"))})
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
            "attention_bwd_cuda": att.attention_bwd_cuda,
            "mha_attention_cuda": att.mha_attention_cuda,
            "layer_norm_cuda": lnm.layer_norm_cuda,
            "layer_norm_bwd_cuda": lnm.layer_norm_bwd_cuda}


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


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

TRAIN_BS = 32                      # videos a step (bench.py)
TRAIN_SAMPLED = 32 * 32            # videos bench.py samples to route
WARMUP_STEPS, FIT_STEPS, OVER_STEPS, TRAIN_RUNS = 3, 20, 8, 3
SIGNAL_STEPS, SIGNAL_LR = 20, 1e-4
BENCH_VSM = dict(lw_neg_ctx=8.0, lw_neg_q=8.0, lw_st_ed=0.01)


def make_train_buckets(vfeat_dim, batch, n_sampled):
    """bench.py's layout: TV videos from RandomState(0), routed to
    TV_PACKED when they pack drop-free and to TV_PACKED_OVERFLOW
    otherwise; one batch of ``batch`` videos per bucket (cycled), seed 2.
    Returns (fit batch, overflow batch, overflow share, subs dropped,
    the fit videos)."""
    from hero_tpu_torch.data.occupancy import sample_tv_video
    from hero_tpu_torch.data.synthetic import (TV_PACKED, TV_PACKED_OVERFLOW,
                                               partition_videos,
                                               tv_vsm_batch)
    r = np.random.RandomState(0)
    videos = [sample_tv_video(r) for _ in range(n_sampled)]
    fit, over = partition_videos(videos, TV_PACKED)
    p_over = len(over) / len(videos)

    def mk(vs, shape):
        shape = dataclasses.replace(shape, batch=batch, vfeat_dim=vfeat_dim)
        return tv_vsm_batch([vs[i % len(vs)] for i in range(batch)], shape,
                            seed=2)

    (b_fit, d_fit), (b_over, d_over) = mk(fit, TV_PACKED), mk(
        over, TV_PACKED_OVERFLOW)
    return b_fit, b_over, p_over, (1 - p_over) * d_fit + p_over * d_over, fit


def vsm_loss_fn(cfg, vsm, dtype, train):
    from hero_tpu_torch.models.pretrain import forward_vsm

    def loss_fn(params, batch, seed):
        a, b, c = forward_vsm(params, cfg, vsm, batch, train=train,
                              seed=seed, dtype=dtype)
        return a + b + c, {"loss_st_ed": a, "loss_neg_ctx": b,
                           "loss_neg_q": c}
    return loss_fn


def train_throughput(torch, cfg, flat, b_fit, b_over, p_over, dev, dtype,
                     steps, sync, profile):
    """bench.py's measurement on the port: warm-up steps on both buckets,
    then ``TRAIN_RUNS`` runs of (fit steps, overflow steps), each bucket
    timed on the host clock up to a synchronise, amortised by the
    overflow share; the median run.  The launch counts are read from 0
    around the timed runs (the train step's main-path run)."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.models.pretrain import VsmConfig
    from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                              make_train_step)
    warmup, n_fit, n_over, n_runs = steps
    vsm = VsmConfig(drop_svmr_prob=0.8, **BENCH_VSM)
    spec = TrainSpec(learning_rate=3e-5, warmup_steps=10000,
                     num_train_steps=100000, grad_norm=2.0)
    step = make_train_step(vsm_loss_fn(cfg, vsm, dtype, True), spec)
    bf, bo = batch_to_device(b_fit, dev), batch_to_device(b_over, dev)
    st = {"state": TrainState.create(load_jax_params(flat, device=dev)),
          "seed": 1000}

    def run(batch, n):
        for _ in range(n):
            st["state"], m = step(st["state"], batch, st["seed"])
            st["seed"] += 1
        return m

    for _ in range(warmup):
        run(bf, 1)
        m = run(bo, 1)
    warm_loss = float(m["loss"])
    reset_counts()
    run(bf, 1)
    sync()
    per_fit = read_counts()
    reset_counts()
    run(bo, 1)
    sync()
    per_over = read_counts()
    reset_counts()
    runs, fit_s, over_s = [], [], []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        run(bf, n_fit)
        sync()
        t1 = time.perf_counter()
        m = run(bo, n_over)
        sync()
        t2 = time.perf_counter()
        t_fit, t_over = (t1 - t0) / n_fit, (t2 - t1) / n_over
        fit_s.append(t_fit)
        over_s.append(t_over)
        runs.append(b_fit["sub_mask"].shape[0]
                    / ((1 - p_over) * t_fit + p_over * t_over))
    launches = read_counts()
    final = {k: float(v) for k, v in m.items()}
    if not all(math.isfinite(v) for v in final.values()):
        raise AssertionError(f"train step metrics not finite: {final}")
    rec = {"train_examples_per_s": float(np.median(runs)),
           "runs_examples_per_s": runs, "fit_step_s": fit_s,
           "overflow_step_s": over_s, "overflow_video_frac": p_over,
           "steps_per_run": [n_fit, n_over], "warmup_loss": warm_loss,
           "last_metrics": final, "launches_per_fit_step": per_fit,
           "launches_per_overflow_step": per_over,
           "main_path_launches": launches}
    if profile:
        rec["profile_fit_step"] = profile_breakdown(
            torch, lambda: step(st["state"], bf, 7))
    return rec


def learning_signal(torch, cfg, flat, b_fit, dev, dtype, n_steps):
    """On one fixed batch with dropout and drop_svmr off (train=False),
    lr 1e-4 from the first step (warm-up 1): the loss of the last step
    must be below the first."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.models.pretrain import VsmConfig
    from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                              make_train_step)
    spec = TrainSpec(learning_rate=SIGNAL_LR, warmup_steps=1,
                     num_train_steps=1000, grad_norm=2.0)
    step = make_train_step(vsm_loss_fn(cfg, VsmConfig(**BENCH_VSM), dtype,
                                       False), spec)
    state = TrainState.create(load_jax_params(flat, device=dev))
    batch = batch_to_device(b_fit, dev)
    losses = []
    for _ in range(n_steps):
        state, m = step(state, batch, None)
        losses.append(float(m["loss"]))
    rec = {"lr": SIGNAL_LR, "warmup_steps": 1, "losses": losses,
           "ok": losses[-1] < losses[0]}
    if not rec["ok"]:
        raise AssertionError(f"the loss did not fall: {losses}")
    return rec


def train_parity(torch, cfg, videos, dev_kernel, dev_plain):
    """fp32, dropout off: one whole train step through the kernels on the
    card against the plain path on the CPU, at the flagship widths with
    the f-encoder cut to 2 layers and the c-encoder to 1, on a batch of 4
    fit-bucket videos.  Compares the loss, every gradient and every
    updated parameter."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.data.synthetic import TV_PACKED, tv_vsm_batch
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.models.pretrain import VsmConfig, init_flat_params
    from hero_tpu_torch.training import optim
    from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                              loss_and_grads,
                                              make_train_step)
    small = cfg.replace(
        f_config=cfg.f_config.replace(num_hidden_layers=2),
        c_config=cfg.c_config.replace(num_hidden_layers=1))
    vsm = VsmConfig(**BENCH_VSM)
    flat = init_flat_params(small, vsm, seed=1)
    shape = dataclasses.replace(TV_PACKED, batch=4, vfeat_dim=cfg.vfeat_dim)
    batch, _ = tv_vsm_batch(videos[:4], shape, seed=2)
    spec = TrainSpec(learning_rate=1e-4, warmup_steps=1,
                     num_train_steps=1000, grad_norm=2.0)
    loss_fn = vsm_loss_fn(small, vsm, torch.float32, False)
    out = {}
    for dev in (dev_kernel, dev_plain):
        params = load_jax_params(flat, device=dev)
        b = batch_to_device(batch, dev)
        loss, _, grads = loss_and_grads(loss_fn, params, b, None)
        state, m = make_train_step(loss_fn, spec)(TrainState.create(params),
                                                   b, None)
        out[dev] = (float(loss), [g.cpu() for g in optim.tree_leaves(grads)],
                    [p.cpu() for p in optim.tree_leaves(state.params)],
                    float(m["loss"]), float(m["grad_norm"]))
    (lk, gk, pk, mk, nk), (lp, gp, pp, mp, np_) = out[dev_kernel], out[
        dev_plain]
    adam = spec.adamw
    sf = math.sqrt(1 - adam.beta2) / (1 - adam.beta1)
    paths = ["/".join(p) for p in optim.tree_paths(
        load_jax_params(flat, device="cpu"))]
    worst_g, worst_p = (0.0, ""), (0.0, "")
    for path, a, b, pa, pb in zip(paths, gk, gp, pk, pp):
        g_err = float((a - b).abs().max())
        # fp32 sums in other orders, and the atomics of the card's
        # scatter-add (index_add_, the embedding and gather backward):
        # within 1e-3 of the leaf's largest gradient
        g_tol = 1e-3 * float(b.abs().max()) + 1e-7
        # AdamW's first step moves an element by lr*sf*g/(|g| + eps),
        # whose slope in g is at most lr*sf/eps: the gradients' noise
        # (4x the measured difference) moves it by at most that much,
        # and never by more than 2*lr*sf
        p_tol = (spec.learning_rate * sf * min(2.0, 4 * g_err / adam.eps)
                 + 1e-6)
        p_err = float((pa - pb).abs().max())
        worst_g = max(worst_g, (g_err / g_tol, path))
        worst_p = max(worst_p, (p_err / p_tol, path))
    rec = {"depth": [2, 1], "batch": 4, "loss": [lk, lp],
           "loss_rel_err": abs(lk - lp) / abs(lp), "loss_rtol": 1e-5,
           "step_loss": [mk, mp], "grad_norm": [nk, np_],
           "worst_grad_err_over_tol": worst_g,
           "worst_param_err_over_tol": worst_p}
    rec["ok"] = (rec["loss_rel_err"] <= 1e-5 and worst_g[0] <= 1.0
                 and worst_p[0] <= 1.0
                 and abs(nk - np_) <= 1e-4 * abs(np_))
    if not rec["ok"]:
        raise AssertionError(f"fp32 train step, kernels vs plain: {rec}")
    return rec


# ---------------------------------------------------------------------------
# TVC caption serving
# ---------------------------------------------------------------------------

TVC_VIDEOS, TVC_CLIPS, TVC_BS = 64, 4, 8   # videos, clips a video, batch
TVC_MAX_STEP, TVC_BOS, TVC_EOS, TVC_BEAM = 30, 0, 2, 3
TVC_SEG_LEN = 100                  # seg_len = max_clip_len (train-tvc.json)
TVC_CLIP_FRAMES = (2, 40)          # clip lengths in frames, 1.5 s apart
TVC_RUNS = 3
# fp32 greedy ids are compared up to the first step at which the
# reference's top-2 logit gap is below this (logits are O(1); the two
# paths' fp32 logits differ by ~1e-5)
TVC_GAP_TOL = 1e-3


class MemVideoStore:
    """In-memory video store for ``TvcClipDataset``: the packed backbone
    arrays of each video (``tv_vsm_batch`` in ``shape``'s layout), its
    frame count and the 1.5 s frame interval."""

    def __init__(self, videos, shape, seed):
        from hero_tpu_torch.data.synthetic import tv_vsm_batch
        b, self.dropped = tv_vsm_batch(videos, shape, seed=seed)
        self.vids = [f"tv{i:04d}" for i in range(len(videos))]
        self._items = {vid: {k: v[i] for k, v in b.items()
                             if k.startswith(("sub_", "c_"))}
                       for i, vid in enumerate(self.vids)}
        self._n = {vid: v.n_frames for vid, v in zip(self.vids, videos)}
        self.img_db = types.SimpleNamespace(frame_interval=1.5)

    def video_item(self, vid):
        return {k: v.copy() for k, v in self._items[vid].items()}

    def nframes(self, vid):
        return self._n[vid]


def make_tvc_data(n_videos, vfeat_dim, seed=21):
    """``n_videos`` TV videos in the packed ``TV_PACKED`` layout, each with
    ``TVC_CLIPS`` clips of 2-40 frames at random starts: (the video store,
    the clips (vid, clip id, ts, None) in corpus order, the share of subs
    the packer dropped)."""
    from hero_tpu_torch.data.occupancy import sample_tv_video
    from hero_tpu_torch.data.synthetic import TV_PACKED
    r = np.random.RandomState(seed)
    videos = [sample_tv_video(r) for _ in range(n_videos)]
    shape = dataclasses.replace(TV_PACKED, batch=n_videos, n_queries=1,
                                vfeat_dim=vfeat_dim)
    store = MemVideoStore(videos, shape, seed + 1)
    clips = []
    for vid in store.vids:
        for c in range(TVC_CLIPS):
            n = int(r.randint(TVC_CLIP_FRAMES[0], TVC_CLIP_FRAMES[1] + 1))
            n = min(n, store.nframes(vid))
            st = int(r.randint(0, store.nframes(vid) - n + 1))
            clips.append((vid, f"{vid}c{c}", [st * 1.5, (st + n) * 1.5],
                          None))
    return store, clips, store.dropped


def tvc_dataset(store, clips):
    from hero_tpu_torch.data.downstream_tasks import TvcClipDataset
    return TvcClipDataset(store, clips, clips_per_item=TVC_CLIPS,
                          seg_len=TVC_SEG_LEN)


def _mha_case(torch, B, H, Lq, Lk, d, kind, dtype, gen, dev):
    q = torch.randn((B, H, Lq, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, H, Lk, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    if kind == "step":             # decode step t: keys <= t valid
        t = torch.randint(0, Lk, (B, 1), generator=gen, device=dev)
        mask = (torch.arange(Lk, device=dev)[None] <= t).float()
    elif kind == "step0":          # the first step: key 0 only
        mask = (torch.arange(Lk, device=dev) == 0).float()[None].repeat(B, 1)
    else:
        mask = torch.ones((B, Lk), device=dev)
    mask[-1] = 0.0                 # a fully masked row
    return q, k, v, mask


def _sdpa_bias(torch, mask, Lq, causal, dtype):
    """The additive (B, 1, Lq, Lk) mask that gives
    ``F.scaled_dot_product_attention`` the kernels' function."""
    B, Lk = mask.shape
    allowed = (mask[:, None, :] > 0).expand(B, Lq, Lk)
    if causal:
        row = torch.arange(Lq, device=mask.device)[:, None]
        allowed = allowed & (torch.arange(Lk, device=mask.device)[None]
                             <= row + (Lk - Lq))
    return torch.where(allowed, 0.0, -1e4).to(dtype)[:, None]


def check_mha(torch, F, att, B, H, Lq, Lk, d, kind, causal):
    """Hold the head-major kernel (#4) against ``mha_reference``: fp32
    within 1e-5 and bf16 within one bf16 ulp on the rows with a valid key;
    the fully masked last row finite and equal to the unmasked attention
    up to the rounding of s - 1e4.  bf16 timings."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(B * Lq + Lk)
    record, rows = {}, {}
    for dtype, tol_fn, why in (
            (torch.float32, lambda ref: 1e-5,
             "fp32: 64-term dots and <= 31-term softmax/P.V sums in "
             "another order, outputs O(1)"),
            (torch.bfloat16, _bf16_tol, "bf16: one bf16 ulp of max|out|")):
        q, k, v, mask = _mha_case(torch, B, H, Lq, Lk, d, kind, dtype, gen,
                                  dev)
        out = att.mha_attention_cuda(q, k, v, mask, causal=causal)
        ref = att.mha_reference(q, k, v, mask, causal=causal)
        err = _err(out[:-1], ref[:-1])
        tol = tol_fn(ref)
        free = att.mha_reference(q[-1:], k[-1:], v[-1:], causal=causal)
        row_err = _err(out[-1:], free)
        row_tol = 2.0 ** -9 * float(v[-1].float().abs().max()) + tol
        rec = {"max_abs_err": err, "tol": tol, "tol_reason": why,
               "masked_row_err": row_err, "masked_row_tol": row_tol,
               "finite": bool(torch.isfinite(out).all())}
        rec["ok"] = err <= tol and row_err <= row_tol and rec["finite"]
        record[str(dtype).split(".")[1]] = rec
        rows[dtype] = (q, k, v, mask)
        if not rec["ok"]:
            raise AssertionError(f"mha attention {[B, H, Lq, Lk, d]} "
                                 f"{kind} causal={causal} {dtype}: {rec}")
    q, k, v, mask = rows[torch.bfloat16]
    ms = time_ms(torch, lambda: att.mha_attention_cuda(q, k, v, mask,
                                                       causal=causal))
    plain_ms = time_ms(torch, lambda: att.mha_reference(q, k, v, mask,
                                                        causal=causal))
    bias = _sdpa_bias(torch, mask, Lq, causal, q.dtype)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias))
    elt = q.element_size()
    b_ms, by = bound_ms(2 * B * H * (Lq + Lk) * d * elt + B * Lk * 4,
                        4 * B * H * Lq * Lk * d, "bfloat16")
    return {"shape": [B, H, Lq, Lk, d], "mode": f"{kind}"
            + (", causal" if causal else ""), "dtype": "bfloat16",
            "max_abs_err": record["bfloat16"]["max_abs_err"],
            "tol": record["bfloat16"]["tol"], "checks": record, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def check_mha_dropout(torch, att, drop, B, H, Lk, d):
    """The kernel's in-kernel keep bits at the decode shape: with value
    rows e_j its output holds drop(p), whose zeros must equal the plain
    Philox mask bit for bit."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((B, H, 1, d), generator=gen, device=dev)
    k = torch.randn((B, H, Lk, d), generator=gen, device=dev)
    v = torch.eye(Lk, d, device=dev).expand(B, H, Lk, d)
    mask = torch.ones((B, Lk), device=dev)
    out = att.mha_attention_cuda(q, k, v, mask, TRAIN_RATE, TRAIN_SEED)
    got = out[..., :Lk] != 0
    want = drop.attention_keep_mask(TRAIN_SEED, B, H, 1, Lk, TRAIN_RATE,
                                    device=dev)
    ref = att.mha_reference(q, k, v, mask, TRAIN_RATE, TRAIN_SEED)
    rec = {"shape": [B, H, 1, Lk], "identical_to_plain": bool(
        torch.equal(got, want)), "keep_rate": float(got.float().mean()),
        "max_abs_err": _err(out, ref), "tol": 1e-5}
    rec["ok"] = rec["identical_to_plain"] and rec["max_abs_err"] <= 1e-5
    if not rec["ok"]:
        raise AssertionError(f"mha attention dropout: {rec}")
    return rec


def check_packed_tvc(torch, F, att, B, Lq, Lk, D, H, causal):
    """#2 at a TVC decoder shape against ``packed_reference``: causal
    self-attention (Lq == Lk) or the decode step's cross-attention
    (Lq = 1 over a clip), the last row a padded clip slot with no valid
    key.  fp32 1e-4 and bf16 one ulp on the other rows; bf16 timings."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3 * B + Lq + Lk)
    lens = torch.randint(2, Lk + 1, (B, 1), generator=gen, device=dev)
    mask = (torch.arange(Lk, device=dev)[None] < lens).float()
    mask[-1] = 0.0
    record, rows = {}, {}
    for dtype, tol_fn in ((torch.float32, lambda ref: 1e-4),
                          (torch.bfloat16, _bf16_tol)):
        q = torch.randn((B, Lq, D), generator=gen, device=dev).to(dtype)
        kv = torch.randn((B, Lk, 2 * D), generator=gen, device=dev).to(dtype)
        k, v = kv.split(D, dim=-1)
        out = att.valid_attention_cuda(q, k, v, H, mask, causal=causal)[0]
        ref = att.packed_reference(q, k, v, H, kv_mask=mask, causal=causal)
        rec = {"max_abs_err": _err(out[:-1], ref[:-1]), "tol": tol_fn(ref),
               "finite": bool(torch.isfinite(out).all())}
        rec["ok"] = rec["max_abs_err"] <= rec["tol"] and rec["finite"]
        record[str(dtype).split(".")[1]] = rec
        rows[dtype] = (q, k, v)
        if not rec["ok"]:
            raise AssertionError(f"packed attention {[B, Lq, Lk, D]} "
                                 f"causal={causal} {dtype}: {rec}")
    q, k, v = rows[torch.bfloat16]
    ms = time_ms(torch, lambda: att.valid_attention_cuda(q, k, v, H, mask,
                                                         causal=causal))
    plain_ms = time_ms(torch, lambda: att.packed_reference(
        q, k, v, H, kv_mask=mask, causal=causal))
    bias = _sdpa_bias(torch, mask, Lq, causal, q.dtype)
    d = D // H

    def heads(t):
        return t.unflatten(-1, (H, d)).transpose(1, 2)

    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        heads(q), heads(k), heads(v), attn_mask=bias))
    elt = q.element_size()
    b_ms, by = bound_ms(2 * B * (Lq + Lk) * D * elt + B * Lk * 4,
                        4 * B * H * Lq * Lk * d, "bfloat16")
    return {"shape": [B, Lq, Lk, D], "mode": "tvc causal self-attention"
            if causal else "tvc cross-attention", "dtype": "bfloat16",
            "max_abs_err": record["bfloat16"]["max_abs_err"],
            "tol": record["bfloat16"]["tol"], "checks": record, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def check_tvc_kernels(torch, cfg, kernels):
    """#4 at the decode shapes and #2 at the decoder's shapes.  Adds #2's
    rows to ``kernels`` and returns #4's row."""
    import torch.nn.functional as F
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import dropout as drop
    d_cfg = cfg.d_config
    D, H = d_cfg.hidden_size, d_cfg.num_attention_heads
    d = D // H
    greedy, beam = TVC_BS * TVC_CLIPS, TVC_BS * TVC_CLIPS * TVC_BEAM
    L = TVC_MAX_STEP + 1
    # the decode step attends over all TVC_MAX_STEP cache slots
    shapes = [check_mha(torch, F, att, greedy, H, 1, TVC_MAX_STEP, d,
                        "step", False),
              check_mha(torch, F, att, beam, H, 1, TVC_MAX_STEP, d, "step0",
                        False),
              check_mha(torch, F, att, greedy, H, L, L, d, "valid", True)]
    masks = check_mha_dropout(torch, att, drop, greedy, H, TVC_MAX_STEP, d)
    for row in kernels:
        if row["name"] == "attention_valid":
            row["shapes"] += [
                check_packed_tvc(torch, F, att, greedy, L, L, D, H, True),
                check_packed_tvc(torch, F, att, greedy, 1, TVC_SEG_LEN, D,
                                 H, False)]
    return {"name": "mha_attention", "route": "cuda",
            "source": "hero_tpu_torch/ops/csrc/attention.cu",
            "replaces": "hero_tpu/ops/attention.py:121",
            "tpu_kernel": "_fwd_kernel", "counter": "mha_attention_cuda",
            "library_call": "F.scaled_dot_product_attention, additive mask",
            **{k: shapes[0][k] for k in (
                "shape", "dtype", "max_abs_err", "tol", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")},
            "shapes": shapes, "dropout_masks": masks}


def gap_rule(ids, logits, ref_ids, tol):
    """``ids`` (N, T) must equal ``ref_ids`` up to the first step at which
    the reference's top-2 gap of ``logits`` (N, T, V) is below ``tol``.
    Returns (ok, rows stopped early by a small gap, steps compared)."""
    top2 = logits.float().topk(2, dim=-1).values
    small = (top2[..., 0] - top2[..., 1]) < tol
    ok, stopped, compared = True, 0, 0
    for row in range(ids.shape[0]):
        hits = small[row].nonzero()
        stop = int(hits[0, 0]) if len(hits) else ids.shape[1]
        stopped += stop < ids.shape[1]
        compared += stop
        ok = ok and bool((ids[row, :stop] == ref_ids[row, :stop]).all())
    return ok, stopped, compared


def tvc_replay(torch, tvc, params, cfg, batch, ids):
    """Teacher-forced logits (N, T, V) of the prefix [BOS, ids[:, :-1]]
    through ``decode``: step t sees positions <= t by the causal bias."""
    enc = tvc.encode(params, cfg, batch, dtype=torch.float32)
    prefix = torch.cat([torch.full_like(ids[:, :1], TVC_BOS), ids[:, :-1]],
                       dim=1)
    return tvc.decode(params, cfg, enc, batch["seg_mask"], prefix,
                      dtype=torch.float32)


def tvc_fp32_checks(torch, cfg, flat, store, clips, dev_kernel, dev_plain):
    """fp32, one batch: (a) the card's KV-cached greedy ids equal the
    plain path's on the CPU, and (b) they equal a teacher-forced replay
    through ``decode`` on the card (#4 against #2's causal mode), both
    under the gap rule."""
    from hero_tpu_torch.convert.from_jax import load_jax_tvc_params
    from hero_tpu_torch.data.downstream_tasks import build_tvc_clip_batch
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.models import tvc
    ds = tvc_dataset(store, clips[:TVC_BS * TVC_CLIPS])
    batch = build_tvc_clip_batch(ds, list(range(len(ds))))
    out = {}
    with torch.inference_mode():
        for dev in (dev_kernel, dev_plain):
            params = load_jax_tvc_params(flat, device=dev)
            b = batch_to_device(batch, dev)
            ids = tvc.greedy_decode(params, cfg, b, max_step=TVC_MAX_STEP,
                                    bos=TVC_BOS, eos=TVC_EOS,
                                    dtype=torch.float32)
            out[dev] = (ids, tvc_replay(torch, tvc, params, cfg, b, ids))
            del params
    (ik, lk), (ip, lp) = out[dev_kernel], out[dev_plain]
    ok_cpu, stop_cpu, n_cpu = gap_rule(ik.cpu(), lp.cpu(), ip.cpu(),
                                       TVC_GAP_TOL)
    ok_rep, stop_rep, n_rep = gap_rule(ik, lk, lk.argmax(-1).int(),
                                       TVC_GAP_TOL)
    rec = {"rows": int(ik.shape[0]), "steps": TVC_MAX_STEP,
           "gap_tol": TVC_GAP_TOL,
           "card_vs_cpu_equal": ok_cpu, "card_vs_cpu_rows_stopped": stop_cpu,
           "card_vs_cpu_steps_compared": n_cpu,
           "ids_identical_to_cpu": bool(torch.equal(ik.cpu(), ip.cpu())),
           "kv_vs_replay_equal": ok_rep, "kv_vs_replay_rows_stopped":
           stop_rep, "kv_vs_replay_steps_compared": n_rep,
           "logits_max_abs_err_vs_cpu": _err(lk.cpu(), lp.cpu())}
    if not (ok_cpu and ok_rep):
        raise AssertionError(f"fp32 TVC greedy ids: {rec}")
    return rec


def check_records(records, clips, max_step, eos):
    """Every clip exactly once, in the reference schema, its ids cut at
    the first EOS."""
    want = {(vid, cid): ts for vid, cid, ts, _ in clips}
    got = [(r["vid_name"], r["clip_id"]) for r in records]
    if len(got) != len(want) or set(got) != set(want):
        raise AssertionError(f"records cover {len(set(got))} of "
                             f"{len(want)} clips in {len(got)} records")
    for r in records:
        if set(r) != {"vid_name", "clip_id", "ts", "descs"} or len(
                r["descs"]) != 1 or set(r["descs"][0]) != {"desc"}:
            raise AssertionError(f"record schema: {r}")
        toks = [int(t) for t in r["descs"][0]["desc"].split()]
        if eos in toks or len(toks) > max_step or r["ts"] != want[
                (r["vid_name"], r["clip_id"])]:
            raise AssertionError(f"record not cut at EOS: {r}")


def tvc_phase(torch, cfg, flat, store, clips, dev, dtype, sync, rehearse,
              profile):
    """``generate_clip_captions`` greedy over every clip (median of
    ``TVC_RUNS`` timed runs after a warm-up batch; launch counters read
    from 0 around the first), one beam pass over two batches, the record
    checks, and the fp32 checks."""
    from hero_tpu_torch.convert.from_jax import load_jax_tvc_params
    from hero_tpu_torch.data.downstream_tasks import build_tvc_clip_batch
    from hero_tpu_torch.drivers.inf_tvc import (cut_at_eos,
                                                generate_clip_captions)
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.models import tvc
    bs = 2 if rehearse else TVC_BS
    params = load_jax_tvc_params(flat, device=dev)
    kw = dict(bos=TVC_BOS, eos=TVC_EOS, batch_size=bs,
              max_gen_step=TVC_MAX_STEP, dtype=dtype, device=dev)
    ds = tvc_dataset(store, clips)
    generate_clip_captions(params, cfg,                         # warm-up
                           tvc_dataset(store, clips[:bs * TVC_CLIPS]), **kw)
    sync()
    runs = []
    for i in range(TVC_RUNS):
        if i == 0:
            reset_counts()
        t0 = time.perf_counter()
        records = generate_clip_captions(params, cfg, ds, **kw)
        sync()
        runs.append(time.perf_counter() - t0)
        if i == 0:
            launches = read_counts()
    check_records(records, clips, TVC_MAX_STEP, TVC_EOS)
    # the records of the first batch are its greedy ids cut at EOS
    b0 = build_tvc_clip_batch(ds, list(range(bs)))
    with torch.inference_mode():
        ids0 = tvc.greedy_decode(params, cfg, batch_to_device(b0, dev),
                                 max_step=TVC_MAX_STEP, bos=TVC_BOS,
                                 eos=TVC_EOS, dtype=dtype).cpu()
    for ri, rec in enumerate(records[:bs * TVC_CLIPS]):
        want = " ".join(map(str, cut_at_eos(ids0[ri].tolist(), TVC_EOS)))
        if rec["descs"][0]["desc"] != want:
            raise AssertionError(f"record {ri} is not its ids cut at EOS")
    n_batches = -(-len(ds) // bs)
    n_layers = cfg.d_config.num_hidden_layers
    want_mha = n_batches * TVC_MAX_STEP * n_layers
    if not rehearse and (launches["mha_attention_cuda"] != want_mha or
                         launches["valid_attention_cuda"] < want_mha):
        raise AssertionError(f"TVC launches {launches}, want "
                             f"mha_attention_cuda == {want_mha}")
    beam_clips = clips[:2 * bs * TVC_CLIPS]
    t0 = time.perf_counter()
    beam_records = generate_clip_captions(
        params, cfg, tvc_dataset(store, beam_clips), beam=TVC_BEAM, **kw)
    sync()
    beam_s = time.perf_counter() - t0
    check_records(beam_records, beam_clips, TVC_MAX_STEP, TVC_EOS)
    n_caps = len(records)
    t_med = float(np.median(runs))
    rec = {"clips": n_caps, "batch": bs, "rows_per_batch": bs * TVC_CLIPS,
           "max_gen_step": TVC_MAX_STEP, "tvc_captions_per_s": n_caps / t_med,
           "wall_s": t_med, "wall_s_runs": runs,
           "runs_captions_per_s": [n_caps / t for t in runs],
           "main_path_launches": launches, "mha_launches_expected": want_mha,
           "beam": TVC_BEAM, "beam_clips": len(beam_records),
           "beam_wall_s": beam_s,
           "beam_captions_per_s": len(beam_records) / beam_s,
           "distinct_descs": len({r["descs"][0]["desc"] for r in records})}
    if profile:
        b = batch_to_device(b0, dev)

        def greedy_batch():
            with torch.inference_mode():
                tvc.greedy_decode(params, cfg, b, max_step=TVC_MAX_STEP,
                                  bos=TVC_BOS, eos=TVC_EOS, dtype=dtype)

        rec["profile_greedy_batch"] = profile_breakdown(torch, greedy_batch,
                                                        iters=2)
    del params
    rec["fp32"] = tvc_fp32_checks(torch, cfg, flat, store, clips,
                                  "cpu" if rehearse else "cuda", "cpu")
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
                    help="also trace one phase-1 batch, one query batch, "
                         "one fit-bucket train step and one greedy TVC "
                         "batch with "
                         "torch.profiler and record device time by kernel "
                         "class (in the --json-out record)")
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
                                                    flagship_config,
                                                    flagship_tvc_config)
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.data.synthetic import TV_PACKED
    from hero_tpu_torch.evaluation.vcmr_eval import (VcmrEvalOpts,
                                                     embed_video_corpus,
                                                     make_query_scorer,
                                                     validate_full_vcmr)
    from hero_tpu_torch.models.pretrain import VsmConfig, init_flat_params
    from hero_tpu_torch.models.tvc import init_flat_tvc_params
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
    serving = ("seg_attention_cuda", "valid_attention_cuda",
               "layer_norm_cuda")
    if not rehearse and min(launches[k] for k in serving) == 0:
        raise AssertionError(f"a kernel was never launched: {launches}")

    small = dataclasses.replace(shape, batch=10)
    small_batches, _ = make_corpus(20, 10, small, seed=11)
    small_q, _ = make_queries(16, 16, QUERY_SLOTS, 50265,
                              [f"s{i}" for i in range(20)], 1.5, seed=12)
    record["integration_fp32"] = integration_check(
        torch, cfg, flat, vsm, opts, small_batches, small_q[0],
        "cpu" if rehearse else "cuda", "cpu")
    log(f"serving phases done at {time.perf_counter() - t_start:.1f} s")

    # the VSM train step at bench.py's layout
    t0 = time.perf_counter()
    train_bs = 4 if rehearse else TRAIN_BS
    b_fit, b_over, p_over, t_dropped, fit_videos = make_train_buckets(
        cfg.vfeat_dim, train_bs, 64 if rehearse else TRAIN_SAMPLED)
    record["train_setup_s"] = time.perf_counter() - t0
    if not rehearse:
        record["kernels"] += check_train_kernels(torch, b_fit, b_over, cfg,
                                                 record["kernels"])
        log("training kernel checks passed")
    steps = ((1, 2, 1, 1) if rehearse
             else (WARMUP_STEPS, FIT_STEPS, OVER_STEPS, TRAIN_RUNS))
    train = train_throughput(torch, cfg, flat, b_fit, b_over, p_over, dev,
                             dtype, steps, sync,
                             args.profile and not rehearse)
    train["subs_dropped_frac"] = t_dropped
    train_launches = train["main_path_launches"]
    if not rehearse and min(v for k, v in train_launches.items()
                            if k != "mha_attention_cuda") == 0:
        raise AssertionError(f"a kernel of the train step was never "
                             f"launched: {train_launches}")
    record["train"] = train
    log(f"train step: {train['train_examples_per_s']:.1f} examples/s")
    record["learning_signal"] = learning_signal(
        torch, cfg, flat, b_fit, dev, dtype, SIGNAL_STEPS)
    record["train_parity_fp32"] = train_parity(
        torch, cfg, fit_videos, "cpu" if rehearse else "cuda", "cpu")
    log(f"train phases done at {time.perf_counter() - t_start:.1f} s")

    # TVC caption serving at config/hero_tvc.json's model
    t0 = time.perf_counter()
    tcfg = (cfg.replace(d_config=cfg.f_config) if rehearse
            else flagship_tvc_config())
    tvc_flat = init_flat_tvc_params(tcfg, seed=0)
    store, clips, tvc_dropped = make_tvc_data(
        5 if rehearse else TVC_VIDEOS, tcfg.vfeat_dim)
    record["tvc_setup_s"] = time.perf_counter() - t0
    if not rehearse:
        record["kernels"].append(check_tvc_kernels(torch, tcfg,
                                                   record["kernels"]))
        log("TVC kernel checks passed")
    tvc = tvc_phase(torch, tcfg, tvc_flat, store, clips, dev, dtype, sync,
                    rehearse, args.profile and not rehearse)
    tvc["subs_dropped_frac"] = tvc_dropped
    tvc_launches = tvc["main_path_launches"]
    if not rehearse and min(tvc_launches[k] for k in (
            "seg_attention_cuda", "valid_attention_cuda",
            "mha_attention_cuda", "layer_norm_cuda")) == 0:
        raise AssertionError(f"a kernel of TVC serving was never "
                             f"launched: {tvc_launches}")
    record["tvc"] = tvc
    log(f"TVC: {tvc['tvc_captions_per_s']:.1f} captions/s greedy, "
        f"{tvc['beam_captions_per_s']:.1f} beam {TVC_BEAM}")
    record["total_s"] = time.perf_counter() - t_start

    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"phases": record["phases"],
                      "main_path_wall_s": record["main_path_wall_s"],
                      "integration_fp32": record["integration_fp32"]}))
    print(json.dumps({
        "train_examples_per_s": train["train_examples_per_s"],
        "runs_examples_per_s": train["runs_examples_per_s"],
        "layout": "packed 4x(16f+88t) + overflow 4x(24f+120t), "
                  f"{train_bs} videos a step",
        "overflow_video_frac": p_over,
        "launches_per_fit_step": train["launches_per_fit_step"],
        "launches_per_overflow_step": train["launches_per_overflow_step"],
        "learning_signal_losses": [record["learning_signal"]["losses"][i]
                                   for i in (0, -1)],
        "train_parity_fp32": {k: record["train_parity_fp32"][k] for k in (
            "loss_rel_err", "worst_grad_err_over_tol",
            "worst_param_err_over_tol", "ok")}}))
    print(json.dumps({
        "tvc_captions_per_s": tvc["tvc_captions_per_s"],
        "runs_captions_per_s": tvc["runs_captions_per_s"],
        "clips": tvc["clips"], "rows_per_batch": tvc["rows_per_batch"],
        "max_gen_step": TVC_MAX_STEP,
        "beam_captions_per_s": tvc["beam_captions_per_s"],
        "beam": TVC_BEAM, "beam_clips": tvc["beam_clips"],
        "launches": tvc_launches, "fp32": tvc["fp32"]}))
    if rehearse:
        log(f"rehearsal passed in {record['total_s']:.1f} s")
        return 0
    kernels = [{k: row[k] for k in (
        "name", "route", "source", "replaces", "tpu_kernel", "shape", "dtype",
        "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
        | {"launches": launches[row["counter"]]
           + train_launches[row["counter"]] + tvc_launches[row["counter"]],
           "launches_by_path": {"serving": launches[row["counter"]],
                                "train": train_launches[row["counter"]],
                                "tvc": tvc_launches[row["counter"]]},
           "shapes": [{k: sh[k] for k in (
               "shape", "max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")} | ({"mode": sh["mode"]}
                                              if "mode" in sh else {})
               for sh in row["shapes"]]}
        for row in record["kernels"]]
    print(json.dumps({"kernels": kernels}))
    print(gpu_identity())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
