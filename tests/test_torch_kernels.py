"""hero_tpu_torch CUDA kernels against their plain PyTorch versions.

The kernel tests need a CUDA card and skip without one; on the card run

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have; this file imports only torch, numpy and the port).
The CPU tests check the dispatch: a CPU tensor takes the plain version
and launches nothing.  The kernels of the backward (attention and
LayerNorm) and the in-kernel Philox dropout are held against their plain
versions on the same inputs, and for determinism; so are the head-major
attention of the TVC decode step (#4) and the causal and cross-attention
shapes of the packed forward (#2), the head-major backward (#5), the
saved-probabilities backward (#3) at the TVC decoder's shapes, and the
fused dropout-add-LayerNorm forward and backward (#8, #9) with their
Philox row mask.  The packed forward in segment mode is held at the
packed query rows of serving (1 to 4 queries of 1 to 30 tokens a row, pad
slots, all-pad rows).  The packed forward (#1/#2), which streams its key
tiles past 112 keys and skips the chunks no row of a tile attends, is
held in both dtypes at every length about its tiles' edges and past its
old ceilings (1 to 2048 keys, head_dim 32, 64 and 128, both mask modes
and the causal bias at Lq != Lk, rates 0 and 0.1), its saved p exactly 0
wherever the plain p is, repeats bit for bit, scores spread past 1e4
(which the skip must leave to the full computation), the skip itself
(NaN value rows no tile attends stay unread), and shared memory that
does not grow with the lengths; the bf16 kernels at their tile edges,
for bit-identical gradients, and for keep bits equal to the plain Philox
mask; the backward (#3), which streams 64-row tiles, in both dtypes at
every length about its tiles' edges and past its old ceilings (1 to
1024 rows, cross and causal heads, head_dim 32, 64 and 128), with shared
memory that does not grow with the lengths; so are the bf16 head-major
forward and backward (1 to 1000 keys, 1 to 65 queries, backward heads to
400 rows), the head-major backward (#5), two streamed kernels, in both
dtypes at 1 to 1024 rows, and the fp32 head-major forward (#4) past its
old 14,464 keys, with shared memory the same at every length.  The
LayerNorm forward and backward are held at their edges: widths about the
16-byte access and a warp's share, single-element widths and the widest
row the wrappers take, row counts about the backward's row groups; so
are the fused dropout-add-LayerNorm kernels (#8, #9), at rates 0 and
0.1, with their keep bits read back, views off the 16-byte alignment and
mixed y/x dtypes.  The embedding lookup's backward (not a kernel of its
own) is held for bit-identical repeats at the position table's shape.
"""

import functools

import numpy as np
import pytest
import torch

from hero_tpu_torch.ops import attention as tatt
from hero_tpu_torch.ops import dropout as tdrop
from hero_tpu_torch.ops import layernorm as tln


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the GPU)")
    return torch.device("cuda")


def _qkv(seed, B, L, D, device, dtype):
    r = np.random.RandomState(seed)
    qkv = torch.from_numpy(r.randn(B, L, 3 * D).astype(np.float32))
    return qkv.to(device, dtype).split(D, dim=-1)


def _validity_mask(seed, B, L):
    r = np.random.RandomState(seed)
    lens = r.randint(1, L + 1, (B,))
    return torch.from_numpy(
        (np.arange(L)[None, :] < lens[:, None]).astype(np.float32))


def _segments(seed, B, L):
    """Segment ids (B, L): runs of 3-20 slots, -1 pad slots between."""
    r = np.random.RandomState(seed)
    seg = np.full((B, L), -1, np.int32)
    for b in range(B):
        pos, s = int(r.randint(0, 3)), 0
        while pos < L - 3 and s < 16:
            n = int(r.randint(3, 21))
            seg[b, pos:pos + n] = s
            pos, s = pos + n + int(r.randint(0, 3)), s + 1
    return torch.from_numpy(seg)


def _tol(want, dtype):
    # fp32: kernel and plain version sum the same terms in other orders
    # (64-term dots, <= 104-term softmax and P.V sums): ~100 ulps of
    # |out| <= 4.  bf16: both read the same bf16 inputs, compute in fp32
    # and round once, so they differ by at most one bf16 ulp of the output
    if dtype == torch.float32:
        return 1e-4
    return float(want.float().abs().max()) * 2.0 ** -7


SHAPES = [  # (B, L, heads, head_dim): the serving path's rows, cut in B
    (3, 104, 12, 64),      # f-encoder packed rows, segment mode
    (4, 100, 12, 64),      # c-encoder clips
    (5, 30, 12, 64),       # query rows and the query-feature attention
    (2, 17, 2, 32),
    (2, 9, 1, 128),
    # the tile edges of the bf16 tensor-core forward (16-key chunks,
    # 16-row warp tiles, 64-row blocks), and the old forward's limit at
    # head_dim 64 (417 keys of fp32 K and V in shared memory)
    (3, 1, 12, 64),
    (2, 17, 12, 64),
    (2, 63, 12, 64),
    (2, 65, 12, 64),
    (2, 200, 12, 64),
    (1, 417, 4, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["validity", "segment"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_kernel_matches_plain(cuda, mode, dtype, shape):
    B, L, H, d = shape
    q, k, v = _qkv(10, B, L, H * d, cuda, dtype)
    if mode == "validity":
        kw = {"kv_mask": _validity_mask(11, B, L).to(cuda)}
        kw["kv_mask"][0] = 0.0                       # a fully masked row
        counter = tatt.valid_attention_cuda
    else:
        kw = {"seg": _segments(12, B, L).to(cuda)}
        kw["seg"][0] = -1
        counter = tatt.seg_attention_cuda
    before = counter.launches
    got = tatt.packed_attention(q, k, v, H, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = tatt.packed_reference(q, k, v, H, **kw)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= _tol(want,
                                                                   dtype)
    # and against the plain version on the CPU (another device's sums)
    cpu = tatt.packed_reference(*(t.cpu() for t in (q, k, v)), H,
                                **{n: m.cpu() for n, m in kw.items()})
    assert float((got.cpu().float() - cpu.float()).abs().max()) <= \
        2 * _tol(cpu, dtype)
    # the fully masked row: the -1e4 on every key cancels in the softmax,
    # so the row is the unmasked attention up to the rounding of s - 1e4
    free = tatt.packed_reference(q[:1], k[:1], v[:1], H)
    row_tol = 2.0 ** -9 * float(v[0].float().abs().max()) + _tol(want,
                                                                  dtype)
    assert float((got[:1].float() - free.float()).abs().max()) <= row_tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_segs", [1, 2, 3, 4])
def test_seg_kernel_at_packed_query_layouts(cuda, dtype, max_segs):
    """#1 in segment mode at the serving path's packed query rows
    (``evaluation/vcmr_eval.pack_query_arrays``): 30 slots, 1 to
    ``max_segs`` queries of 1-30 tokens a row, -1 pad slots behind them,
    and the rows past the packer's padded to a 64-row call, all pads.
    Every slot against the plain version; all-pad rows finite and equal
    to unmasked attention up to the rounding of s - 1e4."""
    from hero_tpu_torch.evaluation.vcmr_eval import pack_query_arrays
    r = np.random.RandomState(max_segs)
    lens = np.concatenate([r.randint(1, 31, (40,)), r.randint(1, 8, (30,))])
    lens[:4] = (1, 30, 29, 2)
    ids = r.randint(3, 100, (70, 30)).astype(np.int32)
    _, p_seg, _, _ = pack_query_arrays(ids, lens, max_segs, 64)
    seg = torch.from_numpy(p_seg).to(cuda)
    pad_rows = (p_seg == -1).all(1)
    assert pad_rows.any() and (p_seg == -1).any(1).sum() > pad_rows.sum()
    assert p_seg.max() == max_segs - 1
    B, L, H, d = p_seg.shape[0], 30, 12, 64
    q, k, v = _qkv(13, B, L, H * d, cuda, dtype)
    before = tatt.seg_attention_cuda.launches
    got = tatt.packed_attention(q, k, v, H, seg=seg)
    torch.cuda.synchronize()
    assert tatt.seg_attention_cuda.launches == before + 1
    want = tatt.packed_reference(q, k, v, H, seg=seg)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= _tol(want,
                                                                   dtype)
    rows = torch.from_numpy(np.flatnonzero(pad_rows)).to(cuda)
    free = tatt.packed_reference(q[rows], k[rows], v[rows], H)
    row_tol = 2.0 ** -9 * float(v[rows].float().abs().max()) + _tol(want,
                                                                     dtype)
    assert float((got[rows].float() - free.float()).abs().max()) <= row_tol


@pytest.mark.cuda
def test_attention_kernel_reads_strided_views(cuda):
    """q/k/v as column slices of one fused projection, as the model
    passes them, give the result of contiguous copies."""
    q, k, v = _qkv(13, 3, 40, 128, cuda, torch.bfloat16)
    assert q.stride(1) == 3 * 128
    mask = _validity_mask(14, 3, 40).to(cuda)
    a = tatt.packed_attention(q, k, v, 2, kv_mask=mask)
    b = tatt.packed_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), 2, kv_mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_attention_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(15, 2, 8, 96, cuda, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        tatt.packed_attention(q, k, v, 2)               # head_dim 48
    with pytest.raises(ValueError, match="seed"):
        tatt.packed_attention(q, k, v, 3, dropout_rate=0.1)
    with pytest.raises(TypeError):
        tatt.packed_attention(q.half(), k.half(), v.half(), 3)
    # the backward streams its tiles and takes what its fp32 kernel once
    # refused (144 rows at head_dim 128) and its bf16 kernel too (384 rows
    # at head_dim 64): both against the plain version
    for L, D, dtype in ((144, 256, torch.float32),
                        (384, 128, torch.bfloat16)):
        q, k, v = _qkv(15, 1, L, D, cuda, dtype)
        g = _qkv(16, 1, L, D, cuda, dtype)[0]
        _, p = tatt.packed_forward_reference(q, k, v, 2, save_probs=True)
        got = tatt.attention_bwd_cuda(p, q, k, v, g, 2)
        want = tatt.packed_backward_reference(p, q, k, v, g, 2)
        for a, b in zip(got, want):
            assert bool(torch.isfinite(a).all())
            assert float((a.float() - b.float()).abs().max()) <= \
                _grad_tol(b, dtype)
    # the forward streams K and V past 112 keys and takes what it once
    # refused (500 keys at head_dim 128 staged whole): against the plain
    # version
    q, k, v = _qkv(15, 1, 500, 128, cuda, torch.bfloat16)
    got = tatt.packed_attention(q, k, v, 1)
    want = tatt.packed_reference(q, k, v, 1)
    assert float((got.float() - want.float()).abs().max()) <= _tol(
        want, torch.bfloat16)


# The LayerNorm kernels' edges: widths about the 16-byte access (8 bf16, 4
# fp32), a warp's 96 accesses and the path's 768 and 4352, widths that
# take single-element accesses, and the widest row the wrappers take
# (16 fp32 bytes a column within 227 KB); row counts about the backward's
# row groups (one, P - 1, P, P + 1, and 2P + 1, whose last group is short)
LN_EDGE_WIDTHS = (1, 7, 8, 9, 255, 256, 257, 767, 768, 769, 1536, 4351,
                  4352, 4353, 227 * 1024 // 16)
LN_EDGE_ROWS = (1, tln.LN_BWD_GROUPS - 1, tln.LN_BWD_GROUPS,
                tln.LN_BWD_GROUPS + 1, 2 * tln.LN_BWD_GROUPS + 1)
LN_EDGE_SHAPES = [(n, d) for d in LN_EDGE_WIDTHS for n in LN_EDGE_ROWS]


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(37, 768), (20800, 768), (11, 4352),
                                  (3200, 4352)] + LN_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_matches_plain(cuda, n, d, dtype):
    r = np.random.RandomState(16)
    x = torch.from_numpy((r.randn(n, d) * 2.0 + 0.5).astype(np.float32))
    w = torch.from_numpy((1.0 + 0.1 * r.randn(d)).astype(np.float32))
    b = torch.from_numpy((0.1 * r.randn(d)).astype(np.float32))
    x, w, b = x.to(cuda, dtype), w.to(cuda), b.to(cuda)
    before = tln.layer_norm_cuda.launches
    got = tln.layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert tln.layer_norm_cuda.launches == before + 1
    want = tln.layer_norm_reference(x, w, b)
    # fp32: reassociated row sums of up to 4352 terms; bf16: one ulp
    assert float((got.float() - want.float()).abs().max()) <= _tol(want,
                                                                   dtype)


BWD_SHAPES = [  # (B, L, heads, head_dim): the train step's rows, cut in B
    (3, 104, 12, 64),      # f-encoder, fit bucket
    (2, 144, 12, 64),      # f-encoder, overflow bucket
    (4, 100, 12, 64),      # c-encoder
    (5, 30, 12, 64),       # query rows and q_feat_attn
    (2, 17, 2, 32),
    (2, 9, 1, 128),
    # the tile edges of the bf16 tensor-core kernels, and the longest
    # row the fp32 backward took at head_dim 64 before it streamed (154)
    (3, 1, 12, 64),
    (2, 17, 12, 64),
    (2, 63, 12, 64),
    (2, 65, 12, 64),
    (1, 154, 12, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode", ["validity", "segment"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_training_kernels_match_plain(cuda, rate, mode, dtype,
                                                shape):
    """Forward with saved probabilities and dropout, then the backward
    kernel from those probabilities, each against its plain version on
    the same inputs; a second launch with the same seed is identical."""
    B, L, H, d = shape
    q, k, v = _qkv(30, B, L, H * d, cuda, dtype)
    r = np.random.RandomState(31)
    dout = torch.from_numpy(r.randn(B, L, H * d).astype(np.float32)).to(
        cuda, dtype)
    if mode == "validity":
        mask, seg_mode = _validity_mask(32, B, L).to(cuda), False
        launch, kw = tatt.valid_attention_cuda, {"kv_mask": mask}
    else:
        mask, seg_mode = _segments(33, B, L).to(cuda), True
        launch, kw = tatt.seg_attention_cuda, {"seg": mask}
    seed = 2 ** 33 + 5
    out, probs = launch(q, k, v, H, mask, rate, seed, True)
    want, wprobs = tatt.packed_forward_reference(
        q, k, v, H, dropout_rate=rate, seed=seed, save_probs=True, **kw)
    assert float((out.float() - want.float()).abs().max()) <= _tol(want,
                                                                   dtype)
    assert float((probs.float() - wprobs.float()).abs().max()) <= _tol(
        wprobs, dtype)
    before = tatt.attention_bwd_cuda.launches
    got = tatt.attention_bwd_cuda(probs, q, k, v, dout, H, rate, seed)
    assert tatt.attention_bwd_cuda.launches == before + 1
    ref = tatt.packed_backward_reference(probs, q, k, v, dout, H, rate, seed)
    for a, b in zip(got, ref):
        # fp32: sums of <= 144 products in other orders; bf16: one ulp
        # of the largest gradient (both round the fp32 sums once)
        tol = (1e-4 * max(1.0, float(b.abs().max()))
               if dtype == torch.float32 else _tol(b, dtype))
        assert float((a.float() - b.float()).abs().max()) <= tol
    again = tatt.attention_bwd_cuda(probs, q, k, v, dout, H, rate, seed)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(launch(q, k, v, H, mask, rate, seed, True)[0], out)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode", ["validity", "segment"])
@pytest.mark.parametrize("L", [200, 240])
def test_bf16_training_kernels_past_the_fp32_limit(cuda, rate, mode, L):
    """The bf16 kernels at rows the fp32 backward once refused (its whole
    head's fp32 tiles stopped at 154 keys at head_dim 64); 240 was the
    longest the bf16 backward took before both streamed.  Forward with
    saved probabilities and dropout, then the backward, against the
    plain versions; one bf16 ulp of the largest value, as in the test
    above."""
    B, H, d = 1, 12, 64
    dtype = torch.bfloat16
    q, k, v = _qkv(36, B, L, H * d, cuda, dtype)
    r = np.random.RandomState(37)
    dout = torch.from_numpy(r.randn(B, L, H * d).astype(np.float32)).to(
        cuda, dtype)
    if mode == "validity":
        mask, launch = _validity_mask(38, B, L).to(cuda), \
            tatt.valid_attention_cuda
        kw = {"kv_mask": mask}
    else:
        mask, launch = _segments(39, B, L).to(cuda), tatt.seg_attention_cuda
        kw = {"seg": mask}
    seed = 2 ** 33 + 7
    out, probs = launch(q, k, v, H, mask, rate, seed, True)
    want, wprobs = tatt.packed_forward_reference(
        q, k, v, H, dropout_rate=rate, seed=seed, save_probs=True, **kw)
    assert float((out.float() - want.float()).abs().max()) <= _tol(want,
                                                                   dtype)
    assert float((probs.float() - wprobs.float()).abs().max()) <= _tol(
        wprobs, dtype)
    got = tatt.attention_bwd_cuda(probs, q, k, v, dout, H, rate, seed)
    ref = tatt.packed_backward_reference(probs, q, k, v, dout, H, rate, seed)
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).abs().max()) <= _tol(b, dtype)


# #3 at every length: the edges of its 64-row tiles and 16-row warp
# tiles, the old kernels' ceilings (fp32 154, bf16 240 rows at head_dim 64)
# and past them; (Lq, Lk, causal): self-attention, the TVC decoder's
# cross-attention and a query row over 700 keys, causal heads
BWD3_SQUARE = (1, 16, 63, 64, 65, 128, 129, 154, 155, 161, 200, 240, 241,
               256, 400, 1024)
BWD3_CASES = ([(L, L, False) for L in BWD3_SQUARE]
              + [(62, 100, False), (3, 700, False), (62, 62, True),
                 (300, 300, True)])


def _bwd3_case(cuda, B, H, d, Lq, Lk, causal, mode, rate, dtype, seed):
    """#3's inputs: q (B, Lq, H*d), k and v column slices of one
    (B, Lk, 2*H*d) tensor (as the model passes them), the output
    gradient, batch row 0 fully masked, and the saved probabilities of
    the plain forward (the forward kernels stage whole heads and stop at
    752 keys).  Returns (probs, q, k, v, g, Philox seed)."""
    r = np.random.RandomState(seed)
    q, g = (torch.from_numpy(r.randn(B, Lq, H * d).astype(np.float32)).to(
        cuda, dtype) for _ in range(2))
    kv = torch.from_numpy(r.randn(B, Lk, 2 * H * d).astype(np.float32)).to(
        cuda, dtype)
    k, v = kv.split(H * d, dim=-1)
    if mode == "segment":
        seg = _segments(seed, B, Lk).to(cuda)
        seg[0] = -1
        kw = {"seg": seg}
    else:
        mask = _validity_mask(seed, B, Lk).to(cuda)
        mask[0] = 0.0
        kw = {"kv_mask": mask}
    pseed = 2 ** 33 + seed
    _, probs = tatt.packed_forward_reference(
        q, k, v, H, dropout_rate=rate, seed=pseed, save_probs=True,
        causal=causal, **kw)
    return probs, q, k, v, g, pseed


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq, Lk, causal", BWD3_CASES,
                         ids=lambda x: str(x))
def test_packed_backward_takes_every_length(cuda, Lq, Lk, causal, dtype,
                                            d):
    """#3 in both dtypes at every length of ``BWD3_CASES``, head_dim 32,
    64 and 128, rates 0 and 0.1, the validity mode and (self-attention)
    the segment mode, against ``packed_backward_reference``: none
    raises, every gradient is finite (the fully masked batch row's too)
    and within the file's tolerances of the plain version (fp32 1e-4 of
    the largest gradient, bf16 one ulp); a call counts one launch."""
    H = 2
    modes = ["validity"] + (["segment"] if Lq == Lk and not causal else [])
    for mode in modes:
        for rate in (0.0, 0.1):
            probs, q, k, v, g, seed = _bwd3_case(
                cuda, 2, H, d, Lq, Lk, causal, mode, rate, dtype,
                Lq + 7 * Lk + d)
            before = tatt.attention_bwd_cuda.launches
            got = tatt.attention_bwd_cuda(probs, q, k, v, g, H, rate, seed)
            torch.cuda.synchronize()
            assert tatt.attention_bwd_cuda.launches == before + 1
            want = tatt.packed_backward_reference(probs, q, k, v, g, H, rate,
                                                  seed)
            for a, b in zip(got, want):
                assert a.shape == b.shape and a.dtype == b.dtype
                assert bool(torch.isfinite(a).all())
                assert float((a.float() - b.float()).abs().max()) <= \
                    _grad_tol(b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_backward_is_bit_identical_at_400_rows(cuda, dtype):
    """Past every old ceiling the two kernels still sum each gradient in
    a fixed order with no atomics: three calls give the same bits."""
    probs, q, k, v, g, seed = _bwd3_case(cuda, 2, 12, 64, 400, 400, False,
                                         "segment", 0.1, dtype, 400)
    first = tatt.attention_bwd_cuda(probs, q, k, v, g, 12, 0.1, seed)
    for _ in range(2):
        again = tatt.attention_bwd_cuda(probs, q, k, v, g, 12, 0.1, seed)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_packed_backward_shared_memory_is_constant(cuda):
    """The backward's shared memory does not depend on Lq or Lk, and at
    head_dim 64 two blocks of it fit an SM (228 KB, 1 KB a block
    reserved)."""
    lib = tatt._lib()
    limit = lib.hero_attention_smem_limit()
    for dtype in (torch.float32, torch.bfloat16):
        code = tatt.cuda_build.DTYPE_CODES[dtype]
        for d in tatt.KERNEL_HEAD_DIMS:
            need = {lib.hero_attention_smem_bytes(code, 1, L, L2, d)
                    for L, L2 in ((64, 64), (100000, 100000), (1, 100000),
                                  (100000, 1), (161, 200))}
            assert len(need) == 1 and need.pop() <= limit
        at64 = lib.hero_attention_smem_bytes(code, 1, 64, 64, 64)
        assert 2 * (at64 + 1024) <= 228 * 1024


# #1/#2 at every length: the edges of the 16-key chunks, the bf16
# kernel's whole-head limit (112 keys) and its 48- and 112-key streamed
# tiles, the fp32 kernel's 64-key tiles, the old forward's ceilings at
# head_dim 64 (fp32 417, bf16 752 keys) and past them
FWD_LENGTHS = (1, 16, 17, 48, 49, 63, 64, 65, 112, 113, 128, 129, 224, 225,
               417, 418, 752, 753, 1024, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", FWD_LENGTHS)
def test_packed_forward_takes_every_length(cuda, L, dtype, d):
    """#1/#2 at L keys, head_dim 32, 64 and 128: self-attention in the
    validity and the segment mode (runs of 3-20 slots, pad slots), and
    the causal bias with Lq = L // 3 query rows (Lq != Lk), at rates 0
    and 0.1 with saved probabilities; batch row 0 fully masked.  Output
    and p within the file's tolerances of ``packed_forward_reference``
    (the rows that may attend nothing -- pad slots, batch row 0 -- up to
    the rounding of s - 1e4 besides, 2^-9 of max |v|, as in
    ``test_attention_kernel_matches_plain``), p exactly 0.0 wherever the
    plain p is (the chunks the kernel skips write zeros), every value
    finite, and a second launch the same bit for bit."""
    H, B = 2, 2
    for mode, Lq, causal in (("validity", L, False), ("segment", L, False),
                             ("validity", max(1, L // 3), True)):
        for rate in (0.0, 0.1):
            r = np.random.RandomState(L + d + Lq)
            q = torch.from_numpy(r.randn(B, Lq, H * d).astype(
                np.float32)).to(cuda, dtype)
            kv = torch.from_numpy(r.randn(B, L, 2 * H * d).astype(
                np.float32)).to(cuda, dtype)
            k, v = kv.split(H * d, dim=-1)
            if mode == "segment":
                mask = _segments(L + d, B, L).to(cuda)
                mask[0] = -1
                launch, kw = tatt.seg_attention_cuda, {"seg": mask}
            else:
                mask = _validity_mask(L + d, B, L).to(cuda)
                mask[0] = 0.0
                launch = functools.partial(tatt.valid_attention_cuda,
                                           causal=causal)
                kw = {"kv_mask": mask, "causal": causal}
            seed = 2 ** 33 + L
            out, p = launch(q, k, v, H, mask, rate, seed, True)
            want, wp = tatt.packed_forward_reference(
                q, k, v, H, dropout_rate=rate, seed=seed, save_probs=True,
                **kw)
            if mode == "segment":
                sq = mask[:, :Lq]
                allowed = (sq[:, :, None] == mask[:, None, :]) & (
                    sq >= 0)[:, :, None]
            else:
                allowed = (mask[:, None, :] > 0).expand(B, Lq, L)
                if causal:
                    allowed = allowed & (
                        torch.arange(L, device=cuda)[None] <=
                        torch.arange(Lq, device=cuda)[:, None] + (L - Lq))
            free = ~allowed.any(-1)                        # (B, Lq)
            err = (out.float() - want.float()).abs().amax(-1)
            assert bool(torch.isfinite(out).all())
            if bool((~free).any()):
                assert float(err[~free].max()) <= _tol(want, dtype)
            if bool(free.any()):
                assert float(err[free].max()) <= _tol(want, dtype) + \
                    2.0 ** -9 * float(v.float().abs().max())
            assert float((p.float() - wp.float()).abs().max()) <= \
                _tol(wp, dtype)
            assert bool(((wp == 0) <= (p == 0)).all())
            again = launch(q, k, v, H, mask, rate, seed, True)
            assert torch.equal(again[0], out) and torch.equal(again[1], p)


@pytest.mark.cuda
def test_packed_forward_shared_memory_is_constant(cuda):
    """The forward's shared memory does not depend on Lq or Lk, in either
    dtype, and at head_dim 64 five bf16 blocks fit an SM (228 KB, 1 KB a
    block reserved)."""
    lib = tatt._lib()
    limit = lib.hero_attention_smem_limit()
    for dtype in (torch.float32, torch.bfloat16):
        code = tatt.cuda_build.DTYPE_CODES[dtype]
        for d in tatt.KERNEL_HEAD_DIMS:
            need = {lib.hero_attention_smem_bytes(code, 0, Lq, Lk, d)
                    for Lq, Lk in ((1, 1), (64, 64), (104, 104), (1, 128),
                                   (1, 129), (417, 417), (753, 753),
                                   (100000, 100000), (1, 100000))}
            assert len(need) == 1 and need.pop() <= limit
    at64 = lib.hero_attention_smem_bytes(
        tatt.cuda_build.DTYPE_CODES[torch.bfloat16], 0, 64, 64, 64)
    assert 5 * (at64 + 1024) <= 228 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_forward_computes_what_the_skip_guard_keeps(cuda, dtype):
    """Scores spread past 1e4 defeat the skip: the rows of segment 0 score
    the keys of segment 1 ~1e4 above their own, so the -1e4 of the mask
    leaves those p near their own keys' and far from 0.  The kernel must
    compute every chunk of such rows and match the plain version (within
    the file's tolerance plus the rounding of scores near 1e4, 2^-9 of
    max |v|, as for the fully masked rows)."""
    B, L, H, d = 2, 104, 1, 64
    q, k, v = _qkv(95, B, L, H * d, cuda, torch.float32)
    seg = torch.from_numpy(np.repeat(np.arange(4, dtype=np.int32),
                                     26)[None].repeat(B, 0)).to(cuda)
    q, k = q.clone(), k.clone()
    q[..., 0] = 10.0
    k[:, 26:52, 0] = 8000.0
    q, k, v = (t.to(dtype) for t in (q, k, v))
    out, p = tatt.seg_attention_cuda(q, k, v, H, seg, 0.0, None, True)
    want, wp = tatt.packed_forward_reference(q, k, v, H, seg=seg,
                                             save_probs=True)
    assert float(wp[:, :, :26, 26:52].float().max()) > 0.01
    tol = _tol(want, dtype) + 2.0 ** -9 * float(v.float().abs().max())
    assert float((out.float() - want.float()).abs().max()) <= tol
    assert float((p.float() - wp.float()).abs().max()) <= \
        _tol(wp, dtype) + 2.0 ** -9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_forward_skips_chunks_no_row_attends(cuda, dtype):
    """The skip is taken: with NaN in the value rows of segment 0 (keys
    0-25 of four 26-slot segments), every row whose 16-row tile (bf16) or
    warp (fp32, 8 rows of a 64-row tile) attends no key of a chunk that
    holds them never touches them and stays finite -- rows 64-103 -- and
    equals the plain version at finite values; the plain version itself
    multiplies the NaN by p = 0 everywhere."""
    B, L, H, d = 1, 104, 1, 64
    q, k, v = _qkv(96, B, L, H * d, cuda, dtype)
    seg = torch.from_numpy(np.repeat(np.arange(4, dtype=np.int32),
                                     26)[None]).to(cuda)
    vn = v.clone()
    vn[:, :26] = float("nan")
    out = tatt.seg_attention_cuda(q, k, vn, H, seg)[0]
    assert bool(torch.isfinite(out[:, 64:]).all())
    want = tatt.packed_reference(q, k, v, H, seg=seg)
    assert float((out[:, 64:].float() - want[:, 64:].float()).abs().max()) \
        <= _tol(want, dtype)


# #5 at every length: the edges of its 64-row tiles and 16-row warp
# tiles and the old whole-head kernels' ceilings (fp32 154 / 139, bf16
# 400 / 208 rows at head_dim 64 / 128) and past them
MHA_BWD_LENGTHS = (1, 16, 17, 63, 64, 65, 128, 129, 139, 140, 154, 155,
                   208, 209, 400, 401, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", MHA_BWD_LENGTHS)
def test_mha_backward_takes_every_length(cuda, L, dtype, d):
    """#5 (the dQ kernel, then the dK/dV kernel) at L rows, head_dim 32,
    64 and 128: square heads causal and not, and L // 3 query rows over L
    keys with the causal bias, rates 0 and 0.1; a partial key mask and a
    fully masked last batch row.  Against ``mha_backward_reference``
    with the file's tolerances (the masked row within 2^-6 of the largest
    gradient), finite, a call one count of ``launches``, a second call
    the same bit for bit."""
    for Lq, causal in ((L, False), (L, True), (max(1, L // 3), True)):
        for rate in (0.0, 0.1):
            q, k, v, mask = _mha_inputs(L + d + Lq, 2, 2, Lq, L, d, "valid",
                                        cuda, dtype)
            r = np.random.RandomState(L + Lq)
            g = torch.from_numpy(r.randn(2, 2, Lq, d).astype(
                np.float32)).to(cuda, dtype)
            seed = 2 ** 34 + L
            before = tatt.mha_attention_bwd_cuda.launches
            got = tatt.mha_attention_bwd_cuda(q, k, v, mask, g, rate, seed,
                                              causal)
            torch.cuda.synchronize()
            assert tatt.mha_attention_bwd_cuda.launches == before + 1
            want = tatt.mha_backward_reference(q, k, v, mask, g, rate, seed,
                                               causal)
            for a, b in zip(got, want):
                assert bool(torch.isfinite(a).all())
                assert float((a[:-1].float() - b[:-1].float()).abs().max()) \
                    <= _grad_tol(b[:-1], dtype)
                assert float((a[-1].float() - b[-1].float()).abs().max()) <= \
                    2.0 ** -6 * max(1.0, float(b.float().abs().max()))
            again = tatt.mha_attention_bwd_cuda(q, k, v, mask, g, rate, seed,
                                                causal)
            assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("B, Lq, Lk, d", [(1, 1, 14465, 64),
                                          (2, 3, 20000, 32),
                                          (1, 2, 16000, 128)])
def test_fp32_mha_forward_past_its_old_ceiling(cuda, B, Lq, Lk, d):
    """fp32 #4 keeps a 64-key tile of scores, not a row's: one to three
    queries over 14,465 to 20,000 keys (its old ceiling 14,464 keys at
    head_dim 64) against ``mha_reference``, within 1e-5 (each p ~1e-4,
    so the long sums stay far below it), the last batch row fully masked
    as in ``test_mha_kernel_matches_plain``."""
    q, k, v, mask = _mha_inputs(Lk, B, 2, Lq, Lk, d, "valid", cuda,
                                torch.float32)
    if B == 1:
        mask[-1] = 1.0
    got = tatt.multi_head_attention(q, k, v, mask)
    want = tatt.mha_reference(q, k, v, mask)
    rows = slice(0, max(1, B - 1))
    assert bool(torch.isfinite(got).all())
    assert float((got[rows] - want[rows]).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_bf16_backward_is_bit_identical_across_runs(cuda):
    """The bf16 backward sums every gradient in a fixed order and uses no
    atomics: five launches on the same inputs give the same bits."""
    B, L, H, d = 4, 144, 12, 64
    q, k, v = _qkv(40, B, L, H * d, cuda, torch.bfloat16)
    r = np.random.RandomState(41)
    dout = torch.from_numpy(r.randn(B, L, H * d).astype(np.float32)).to(
        cuda, torch.bfloat16)
    seg = _segments(42, B, L).to(cuda)
    _, probs = tatt.seg_attention_cuda(q, k, v, H, seg, 0.1, 11, True)
    first = tatt.attention_bwd_cuda(probs, q, k, v, dout, H, 0.1, 11)
    for _ in range(4):
        again = tatt.attention_bwd_cuda(probs, q, k, v, dout, H, 0.1, 11)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_kernels_dropout_is_the_philox_mask(cuda, dtype):
    """With value rows e_j the forward's output holds drop(p), and with
    output-gradient rows e_i the backward's dv holds drop(p)^T: the zeros
    of both are the kernels' keep bits, equal to the plain Philox mask
    bit for bit."""
    B, L, H, d = 2, 60, 2, 64
    q, k, _ = _qkv(43, B, L, H * d, cuda, dtype)
    eye = torch.eye(L, d, device=cuda, dtype=dtype)
    v = eye.repeat(1, H).expand(B, L, H * d)
    seed, rate = 2 ** 36 + 5, 0.1
    keep = tdrop.attention_keep_mask(seed, B, H, L, L, rate, device=cuda)
    out, probs = tatt.valid_attention_cuda(q, k, v, H, torch.ones(
        (B, L), device=cuda), rate, seed, True)
    heads = out.view(B, L, H, d).transpose(1, 2)[..., :L]
    assert torch.equal(heads != 0, keep)
    _, _, dv = tatt.attention_bwd_cuda(probs, q, k, v, v, H, rate, seed)
    dvh = dv.view(B, L, H, d).transpose(1, 2)[..., :L]
    assert torch.equal(dvh != 0, keep.transpose(-1, -2))


@pytest.mark.cuda
def test_dropout_mask_kernel_matches_plain(cuda):
    for seed, rate in ((0, 0.1), (2 ** 64 - 1, 0.1), (12345, 0.5)):
        got = tatt.dropout_keep_mask_cuda(seed, 3, 12, 104, 104, rate, cuda)
        want = tdrop.attention_keep_mask(seed, 3, 12, 104, 104, rate,
                                         device=cuda)
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), tdrop.attention_keep_mask(
            seed, 3, 12, 104, 104, rate))
        n = got.numel()
        sigma = (rate * (1 - rate) / n) ** 0.5
        assert abs(float(got.float().mean()) - (1 - rate)) < 4 * sigma


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(37, 768), (13312, 768), (11, 4352),
                                  (3200, 4352)] + LN_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_backward_kernel_matches_plain(cuda, n, d, dtype):
    r = np.random.RandomState(34)
    x = torch.from_numpy((r.randn(n, d) * 2.0 + 0.5).astype(np.float32))
    g = torch.from_numpy(r.randn(n, d).astype(np.float32))
    w = torch.from_numpy((1.0 + 0.1 * r.randn(d)).astype(np.float32))
    x, g, w = x.to(cuda, dtype), g.to(cuda, dtype), w.to(cuda)
    before = tln.layer_norm_bwd_cuda.launches
    got = tln.layer_norm_bwd_cuda(x, w, g)
    torch.cuda.synchronize()
    assert tln.layer_norm_bwd_cuda.launches == before + 1
    want = tln.layer_norm_bwd_reference(x, w, g)
    # dx: fp32 row means of <= 4352 terms, then one rounding to the input
    # type; dw/db: fp32 sums of n terms of |g * xhat| <~ 8 in another
    # order, at most n * 2^-23 * 8 ~ 1e-6 * n apart.  Below 4 rows one
    # term's own rounding outweighs that: xhat from the two sides' means
    # and variances differs in its last bits, ~2e-6 at |g xhat| ~ 16
    assert float((got[0].float() - want[0].float()).abs().max()) <= _tol(
        want[0], dtype)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-6 * max(n, 4)
    again = tln.layer_norm_bwd_cuda(x, w, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_autograd_runs_the_backward_kernels(cuda):
    """A loss built from the kernels' outputs gets its gradient through
    the backward kernels, for fp32 parameters."""
    q, k, v = _qkv(35, 2, 40, 128, cuda, torch.float32)
    qkv = torch.cat([q, k, v], -1).requires_grad_(True)
    w = torch.ones(128, device=cuda, requires_grad=True)
    b = torch.zeros(128, device=cuda, requires_grad=True)
    counts = (tatt.attention_bwd_cuda.launches,
              tln.layer_norm_bwd_cuda.launches)
    out = tatt.packed_attention(*qkv.split(128, -1), 2, dropout_rate=0.1,
                                seed=3)
    loss = tln.layer_norm(out, w, b).square().sum()
    gq, gw, gb = torch.autograd.grad(loss, (qkv, w, b))
    assert (tatt.attention_bwd_cuda.launches,
            tln.layer_norm_bwd_cuda.launches) == (counts[0] + 1,
                                                  counts[1] + 1)
    assert gw.dtype == torch.float32 and float(gq.abs().max()) > 0
    assert bool(torch.isfinite(gq).all())


def _embedding_grads(device, runs):
    """The table gradient of ``nn.embedding_lookup`` at the text position
    table's shape (514 rows, 35328 reads of 122 positions), ``runs`` times
    with other allocations in between, and ``F.embedding``'s."""
    from hero_tpu_torch.models import nn as tnn
    r = np.random.RandomState(0)
    table = torch.from_numpy(r.randn(514, 768).astype(np.float32)).to(
        device).requires_grad_(True)
    ids = torch.from_numpy(np.tile(np.arange(122), 290)[:35328]).to(device)
    g = torch.from_numpy(r.randn(35328, 768).astype(np.float32)).to(
        device, torch.bfloat16)
    out = []
    for i in range(runs):
        pad = torch.empty((i + 1) << 20, device=device)
        rows = tnn.embedding_lookup(table, ids, torch.bfloat16)
        out.append(torch.autograd.grad(rows, table, g)[0])
        del pad
    rows = torch.nn.functional.embedding(ids, table).to(torch.bfloat16)
    return out, torch.autograd.grad(rows, table, g)[0]


def test_embedding_lookup_gradient_is_f_embedding_on_the_cpu():
    got, want = _embedding_grads("cpu", 1)
    assert torch.equal(got[0], want)
    assert not torch.are_deterministic_algorithms_enabled()


def test_embedding_lookup_gradient_repeats_bit_for_bit(cuda):
    """Rows that share an index sum in a fixed order on the card, so the
    gradient repeats bit for bit (the default CUDA backward did not); it
    stays within fp32 rounding of ``F.embedding``'s."""
    got, want = _embedding_grads(cuda, 3)
    assert all(torch.equal(g, got[0]) for g in got[1:])
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-4)
    assert not torch.are_deterministic_algorithms_enabled()


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers call the plain versions and count no
    launch (the counts say only what ran on the card)."""
    counts = (tatt.seg_attention_cuda.launches,
              tatt.valid_attention_cuda.launches,
              tatt.attention_bwd_cuda.launches,
              tln.layer_norm_cuda.launches, tln.layer_norm_bwd_cuda.launches)
    q, k, v = _qkv(17, 2, 12, 64, "cpu", torch.float32)
    seg = _segments(18, 2, 12)
    torch.testing.assert_close(tatt.packed_attention(q, k, v, 2, seg=seg),
                               tatt.packed_reference(q, k, v, 2, seg=seg),
                               atol=0, rtol=0)
    x = q.reshape(-1, 64)
    w, b = torch.ones(64), torch.zeros(64)
    torch.testing.assert_close(tln.layer_norm(x, w, b),
                               tln.layer_norm_reference(x, w, b),
                               atol=0, rtol=0)
    qg = q.detach().requires_grad_(True)
    out = tatt.packed_attention(qg, k, v, 2, seg=seg, dropout_rate=0.1,
                                seed=1)
    tln.layer_norm(out, w.requires_grad_(True), b).sum().backward()
    assert qg.grad is not None and w.grad is not None
    assert counts == (tatt.seg_attention_cuda.launches,
                      tatt.valid_attention_cuda.launches,
                      tatt.attention_bwd_cuda.launches,
                      tln.layer_norm_cuda.launches,
                      tln.layer_norm_bwd_cuda.launches)


# ---------------------------------------------------------------------------
# the head-major kernel (#4) and the causal mode of the packed forward (#2)
# ---------------------------------------------------------------------------

MHA_SHAPES = [  # (B, H, Lq, Lk, head_dim, causal, mask): the TVC decode path
    (32, 12, 1, 30, 64, False, "step"),        # greedy decode step
    (96, 12, 1, 30, 64, False, "step0"),       # beam 3, step 0: key 0 only
    (32, 12, 31, 31, 64, True, "valid"),       # causal, Lq == Lk
    (4, 2, 7, 19, 32, True, "valid"),          # causal, Lq < Lk
    (3, 2, 5, 300, 128, False, "valid"),
    # the tile edges of the bf16 tensor-core forward (16-key chunks,
    # 64-key streamed tiles, 16-row warp tiles, 64-row blocks); every case
    # has a fully masked batch row
    (3, 2, 1, 1, 64, False, "valid"),
    (3, 2, 16, 16, 64, True, "valid"),
    (3, 2, 17, 17, 64, True, "valid"),
    (3, 2, 65, 64, 64, False, "valid"),        # two query blocks, one tile
    (3, 2, 17, 65, 64, True, "valid"),         # two key tiles, causal Lq < Lk
    (3, 2, 65, 129, 32, True, "valid"),        # three key tiles
    (2, 2, 16, 129, 128, False, "valid"),
    (2, 2, 3, 1000, 64, False, "valid"),       # past the packed forward's 752
]


def _mha_inputs(seed, B, H, Lq, Lk, d, mask_kind, device, dtype):
    r = np.random.RandomState(seed)
    q = torch.from_numpy(r.randn(B, H, Lq, d).astype(np.float32))
    k, v = (torch.from_numpy(r.randn(B, H, Lk, d).astype(np.float32))
            for _ in range(2))
    if mask_kind == "step":
        mask = (np.arange(Lk)[None] <= r.randint(0, Lk, (B, 1)))
    elif mask_kind == "step0":
        mask = np.broadcast_to(np.arange(Lk) == 0, (B, Lk))
    else:
        mask = np.arange(Lk)[None] < r.randint(1, Lk + 1, (B, 1))
    mask = torch.from_numpy(mask.astype(np.float32))
    mask[-1] = 0.0                                # a fully masked row
    return [t.to(device, dtype) for t in (q, k, v)] + [mask.to(device)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MHA_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mha_kernel_matches_plain(cuda, dtype, shape):
    B, H, Lq, Lk, d, causal, kind = shape
    q, k, v, mask = _mha_inputs(60, B, H, Lq, Lk, d, kind, cuda, dtype)
    before = tatt.mha_attention_cuda.launches
    got = tatt.multi_head_attention(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert tatt.mha_attention_cuda.launches == before + 1
    want = tatt.mha_reference(q, k, v, mask, causal=causal)
    assert bool(torch.isfinite(got).all())
    # rows with a valid key: fp32 within 1e-5 (<= 300-term sums in other
    # orders), bf16 one ulp; the fully masked row is the unmasked
    # attention up to the rounding of s - 1e4
    tol = 1e-5 if dtype == torch.float32 else _tol(want, dtype)
    assert float((got[:-1].float() - want[:-1].float()).abs().max()) <= tol
    free = tatt.mha_reference(q[-1:], k[-1:], v[-1:], causal=causal)
    row_tol = 2.0 ** -9 * float(v[-1].float().abs().max()) + _tol(want,
                                                                   dtype)
    assert float((got[-1:].float() - free.float()).abs().max()) <= row_tol


@pytest.mark.cuda
def test_mha_kernel_reads_cache_views(cuda):
    """A layer of a (layers, B, H, T, d) cache and head views of a packed
    projection, as the decode step passes them, give the result of
    contiguous copies."""
    r = np.random.RandomState(61)
    cache = torch.from_numpy(r.randn(2, 2, 8, 3, 30, 64).astype(
        np.float32)).to(cuda, torch.bfloat16)
    proj = torch.from_numpy(r.randn(8, 1, 3 * 3 * 64).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q = tatt.split_heads(proj[..., :192], 3)
    mask = (torch.arange(30, device=cuda) <= 11).float()[None].expand(8, 30)
    k, v = cache[0, 1], cache[1, 1]
    a = tatt.multi_head_attention(q, k, v, mask)
    b = tatt.multi_head_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), mask.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_kernel_dropout_is_the_philox_mask(cuda, dtype):
    """With value rows e_j the output holds drop(p): its zeros are the
    kernel's keep bits, equal to the plain Philox mask bit for bit."""
    B, H, Lq, Lk, d = 32, 12, 1, 30, 64
    q, k, _, _ = _mha_inputs(62, B, H, Lq, Lk, d, "valid", cuda, dtype)
    v = torch.eye(Lk, d, device=cuda, dtype=dtype).expand(B, H, Lk, d)
    seed, rate = 2 ** 35 + 3, 0.1
    out = tatt.multi_head_attention(q, k, v, dropout_rate=rate, seed=seed)
    keep = tdrop.attention_keep_mask(seed, B, H, Lq, Lk, rate, device=cuda)
    assert torch.equal(out[..., :Lk] != 0, keep)
    want = tatt.mha_reference(q, k, v, dropout_rate=rate, seed=seed)
    assert float((out.float() - want.float()).abs().max()) <= (
        1e-5 if dtype == torch.float32 else _tol(want, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, Lq, Lk, causal", [
    (32, 31, 31, True),       # teacher-forced decoder self-attention
    (6, 9, 40, True),         # causal, Lq < Lk
    (32, 1, 100, False),      # decode-step cross-attention over a clip
    (4, 1, 417, False),       # one query over the old forward's limit
    (4, 17, 63, True),        # causal across the 16-key chunk edges
    (2, 65, 200, True),       # causal, two 64-row query blocks
])
def test_packed_causal_and_cross_kernel_match_plain(cuda, dtype, B, Lq, Lk,
                                                    causal):
    H, d = 12, 64
    r = np.random.RandomState(63)
    q = torch.from_numpy(r.randn(B, Lq, H * d).astype(np.float32)).to(
        cuda, dtype)
    kv = torch.from_numpy(r.randn(B, Lk, 2 * H * d).astype(np.float32)).to(
        cuda, dtype)
    k, v = kv.split(H * d, dim=-1)
    mask = _validity_mask(64, B, Lk).to(cuda)
    mask[-1] = 0.0                          # a padded clip slot
    got = tatt.packed_attention(q, k, v, H, kv_mask=mask, causal=causal)
    want = tatt.packed_reference(q, k, v, H, kv_mask=mask, causal=causal)
    assert bool(torch.isfinite(got).all())
    assert float((got[:-1].float() - want[:-1].float()).abs().max()) <= \
        _tol(want, dtype)
    # with saved probabilities and dropout, and the backward from them
    seed, rate = 2 ** 33 + 9, 0.1
    out, probs = tatt.valid_attention_cuda(q, k, v, H, mask, rate, seed,
                                           True, causal)
    ref, rprobs = tatt.packed_forward_reference(
        q, k, v, H, kv_mask=mask, dropout_rate=rate, seed=seed,
        save_probs=True, causal=causal)
    assert float((probs[:-1].float() - rprobs[:-1].float()).abs().max()) \
        <= _tol(rprobs, dtype)
    assert float((out[:-1].float() - ref[:-1].float()).abs().max()) <= \
        _tol(ref, dtype)


def test_cpu_mha_takes_the_plain_version():
    """On the CPU the head-major wrapper calls the plain version and
    counts no launch."""
    before = tatt.mha_attention_cuda.launches
    q, k, v, mask = _mha_inputs(65, 2, 3, 4, 9, 16, "step", "cpu",
                                torch.float32)
    torch.testing.assert_close(
        tatt.multi_head_attention(q, k, v, mask, causal=True),
        tatt.mha_reference(q, k, v, mask, causal=True), atol=0, rtol=0)
    assert tatt.mha_attention_cuda.launches == before


# ---------------------------------------------------------------------------
# the head-major backward (#5), #3 at the decoder's shapes, and the fused
# dropout-add-LayerNorm (#8, #9)
# ---------------------------------------------------------------------------

MHA_BWD_SHAPES = [  # (B, H, Lq, Lk, head_dim, causal): the component path
    (16, 12, 56, 56, 64, False),      # component_bench's shape, cut in B
    (8, 12, 31, 31, 64, True),        # causal, Lq == Lk
    (8, 12, 62, 100, 64, False),      # Lq != Lk
    (4, 2, 7, 19, 32, True),          # causal, Lq < Lk
    (3, 2, 9, 40, 128, False),
    # the tile edges of the bf16 tensor-core backward (16-row and 16-key
    # warp tiles), and the longest square head the fp32 kernel takes at
    # head_dim 64 (154)
    (3, 2, 1, 1, 64, False),
    (3, 2, 16, 16, 64, True),
    (3, 2, 17, 17, 64, True),
    (3, 2, 65, 64, 64, False),
    (3, 2, 17, 65, 64, True),         # causal, Lq < Lk
    (3, 2, 65, 129, 32, True),
    (2, 2, 16, 129, 128, False),
    (2, 12, 154, 154, 64, False),
]


def _grad_tol(want, dtype):
    # fp32: sums of <= 100 products in other orders, and the recomputed
    # probabilities' own rounding: ~1e-4 of the largest gradient; bf16:
    # both sides read the same bf16 inputs, compute in fp32 and round
    # once: one bf16 ulp of the largest gradient
    top = float(want.float().abs().max())
    return 1e-4 * max(1.0, top) if dtype == torch.float32 else top * 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MHA_BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mha_backward_kernel_matches_plain(cuda, rate, dtype, shape):
    """#5 against ``mha_backward_reference`` on the same inputs, with a
    partial key mask and a fully masked last batch row (finite, and the
    unmasked attention's gradients up to the rounding of s - 1e4); a
    second launch is identical; autograd through ``multi_head_attention``
    launches it."""
    B, H, Lq, Lk, d, causal = shape
    q, k, v, mask = _mha_inputs(70, B, H, Lq, Lk, d, "valid", cuda, dtype)
    r = np.random.RandomState(71)
    g = torch.from_numpy(r.randn(B, H, Lq, d).astype(np.float32)).to(
        cuda, dtype)
    seed = 2 ** 34 + 17
    before = tatt.mha_attention_bwd_cuda.launches
    got = tatt.mha_attention_bwd_cuda(q, k, v, mask, g, rate, seed, causal)
    torch.cuda.synchronize()
    assert tatt.mha_attention_bwd_cuda.launches == before + 1
    want = tatt.mha_backward_reference(q, k, v, mask, g, rate, seed, causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert bool(torch.isfinite(a).all())
        assert float((a[:-1].float() - b[:-1].float()).abs().max()) <= \
            _grad_tol(b[:-1], dtype)
        # the masked row's probabilities carry the rounding of s - 1e4
        # (~2^-10 relative): within 2^-6 of the largest gradient
        assert float((a[-1].float() - b[-1].float()).abs().max()) <= \
            2.0 ** -6 * max(1.0, float(b.float().abs().max()))
    again = tatt.mha_attention_bwd_cuda(q, k, v, mask, g, rate, seed, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = tatt.multi_head_attention(*qkv, mask, dropout_rate=rate,
                                    seed=seed, causal=causal)
    auto = torch.autograd.grad(out, qkv, g)
    assert tatt.mha_attention_bwd_cuda.launches == before + 3
    assert all(torch.equal(a, b) for a, b in zip(auto, got))


@pytest.mark.cuda
def test_mha_backward_kernel_reads_strided_views(cuda):
    """Head views of a packed projection give the gradients of contiguous
    copies; the shapes the whole-head kernels once refused compute."""
    r = np.random.RandomState(72)
    B, L, H, d = 4, 40, 3, 64
    proj = torch.from_numpy(r.randn(B, L, 3 * H * d).astype(np.float32)).to(
        cuda)
    q, k, v = (tatt.split_heads(t, H) for t in proj.split(H * d, dim=-1))
    g = torch.from_numpy(r.randn(B, H, L, d).astype(np.float32)).to(cuda)
    mask = torch.ones((B, L), device=cuda)
    a = tatt.mha_attention_bwd_cuda(q, k, v, mask, g, 0.1, 5)
    b = tatt.mha_attention_bwd_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), mask, g, 0.1, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = tatt.mha_attention_bwd_cuda(*(t.bfloat16() for t in (q, k, v)),
                                    mask, g.bfloat16(), 0.1, 5)
    b = tatt.mha_attention_bwd_cuda(*(t.bfloat16().contiguous()
                                      for t in (q, k, v)),
                                    mask, g.bfloat16(), 0.1, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # fp32: the (Lq, Lk) fp32 tiles of 300 rows at head_dim 128; bf16: Q,
    # dO, K and V of 416 rows at head_dim 64 -- past the whole-head
    # kernels' shared memory, now streamed: against the plain version
    for L, d, dtype in ((300, 128, torch.float32), (416, 64, torch.bfloat16)):
        q, k, v, g = (torch.from_numpy(r.randn(1, 1, L, d).astype(
            np.float32)).to(cuda, dtype) for _ in range(4))
        ones = torch.ones((1, L), device=cuda)
        got = tatt.mha_attention_bwd_cuda(q, k, v, ones, g)
        want = tatt.mha_backward_reference(q, k, v, ones, g)
        for x, y in zip(got, want):
            assert float((x.float() - y.float()).abs().max()) <= \
                _grad_tol(y, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L, d", [(240, 64), (400, 64), (208, 128)])
def test_bf16_mha_backward_past_the_fp32_limit(cuda, rate, L, d):
    """The bf16 backward at square heads the fp32 kernel once refused (154
    rows at head_dim 64, 139 at 128) up to the longest the bf16 kernel
    took before both streamed (400 and 208).
    Against the plain version, one bf16 ulp of the largest gradient, as
    in the test above; a fully masked batch row stays finite."""
    B, H = 2, 2
    dtype = torch.bfloat16
    q, k, v, mask = _mha_inputs(78, B, H, L, L, d, "valid", cuda, dtype)
    r = np.random.RandomState(79)
    g = torch.from_numpy(r.randn(B, H, L, d).astype(np.float32)).to(
        cuda, dtype)
    got = tatt.mha_attention_bwd_cuda(q, k, v, mask, g, rate, 13, True)
    want = tatt.mha_backward_reference(q, k, v, mask, g, rate, 13, True)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a[:-1].float() - b[:-1].float()).abs().max()) <= \
            _grad_tol(b[:-1], dtype)


@pytest.mark.cuda
def test_bf16_mha_backward_is_bit_identical_across_runs(cuda):
    """The bf16 head-major backward sums every gradient in a fixed order
    and uses no atomics: five launches on the same inputs, with dropout,
    give the same bits."""
    q, k, v, mask = _mha_inputs(80, 8, 12, 62, 100, 64, "valid", cuda,
                                torch.bfloat16)
    r = np.random.RandomState(81)
    g = torch.from_numpy(r.randn(8, 12, 62, 64).astype(np.float32)).to(
        cuda, torch.bfloat16)
    first = tatt.mha_attention_bwd_cuda(q, k, v, mask, g, 0.1, 15)
    for _ in range(4):
        again = tatt.mha_attention_bwd_cuda(q, k, v, mask, g, 0.1, 15)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_backward_dropout_is_the_philox_mask(cuda, dtype):
    """With output-gradient rows e_i the backward's dv holds drop(p)^T:
    its zeros are the kernel's keep bits, equal to the plain Philox mask
    bit for bit."""
    B, H, L, d = 2, 3, 60, 64
    q, k, v, _ = _mha_inputs(82, B, H, L, L, d, "valid", cuda, dtype)
    eye = torch.eye(L, d, device=cuda, dtype=dtype).expand(B, H, L, d)
    seed, rate = 2 ** 36 + 11, 0.1
    dv = tatt.mha_attention_bwd_cuda(q, k, v, torch.ones((B, L),
                                                         device=cuda),
                                     eye, rate, seed)[2]
    keep = tdrop.attention_keep_mask(seed, B, H, L, L, rate, device=cuda)
    assert torch.equal(dv[..., :L] != 0, keep.transpose(-1, -2))


@pytest.mark.cuda
def test_bf16_mha_kernels_take_every_fp32_shape(cuda):
    """The bf16 forward streams K and V, so its shared memory does not
    grow with Lk past one 64-key tile; the fp32 forward keeps a 64-key
    tile of scores, not a row's, and both backwards stream 64-row tiles:
    their shared memory is the same at every Lq and Lk, within what a
    block may use, so every shape of either dtype is taken."""
    lib = tatt._lib()
    limit = lib.hero_attention_smem_limit()
    f32, b16 = (tatt.cuda_build.DTYPE_CODES[t]
                for t in (torch.float32, torch.bfloat16))
    pairs = [(Lq, Lk) for Lq in (1, 16, 17, 154, 400, 401, 1024, 100000)
             for Lk in (1, 3, 64, 65, 14464, 14465, 100000)]
    for d in tatt.KERNEL_HEAD_DIMS:
        assert lib.hero_mha_smem_bytes(b16, 64, 65, d) == \
            lib.hero_mha_smem_bytes(b16, 64, 100000, d) <= limit
        fwd = {lib.hero_mha_smem_bytes(f32, Lq, Lk, d) for Lq, Lk in pairs}
        assert len(fwd) == 1 and fwd.pop() <= limit
        for code in (f32, b16):
            bwd = {lib.hero_mha_bwd_smem_bytes(code, Lq, Lk, d)
                   for Lq, Lk in pairs}
            assert len(bwd) == 1 and bwd.pop() <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, Lq, Lk, causal", [
    (8, 62, 62, True),        # TVC train: decoder causal self-attention
    (8, 62, 100, False),      # TVC train: cross-attention over the clip
])
def test_packed_backward_at_the_decoder_shapes(cuda, dtype, B, Lq, Lk,
                                               causal):
    """#2 with the causal bias, dropout and saved probabilities, then #3
    from those probabilities (Lq != Lk for the cross-attention), each
    against its plain version; a padded clip slot (no valid key) stays
    finite."""
    H, d = 12, 64
    r = np.random.RandomState(73)
    q = torch.from_numpy(r.randn(B, Lq, H * d).astype(np.float32)).to(
        cuda, dtype)
    kv = torch.from_numpy(r.randn(B, Lk, 2 * H * d).astype(np.float32)).to(
        cuda, dtype)
    k, v = kv.split(H * d, dim=-1)
    dout = torch.from_numpy(r.randn(B, Lq, H * d).astype(np.float32)).to(
        cuda, dtype)
    mask = _validity_mask(74, B, Lk).to(cuda)
    mask[-1] = 0.0
    seed, rate = 2 ** 33 + 21, 0.1
    out, probs = tatt.valid_attention_cuda(q, k, v, H, mask, rate, seed,
                                           True, causal)
    ref, rprobs = tatt.packed_forward_reference(
        q, k, v, H, kv_mask=mask, dropout_rate=rate, seed=seed,
        save_probs=True, causal=causal)
    assert float((out[:-1].float() - ref[:-1].float()).abs().max()) <= \
        _tol(ref, dtype)
    assert float((probs[:-1].float() - rprobs[:-1].float()).abs().max()) \
        <= _tol(rprobs, dtype)
    got = tatt.attention_bwd_cuda(probs, q, k, v, dout, H, rate, seed)
    want = tatt.packed_backward_reference(probs, q, k, v, dout, H, rate,
                                          seed)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).abs().max()) <= _grad_tol(
            b, dtype)


DALN_SHAPES = [(1024, 768), (256, 4352), (37, 768), (5, 4352)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, d", DALN_SHAPES)
def test_daln_kernels_match_plain(cuda, rate, dtype, n, d):
    """#8 and #9 against their plain versions on the same inputs: the
    output, dy, dx within the LayerNorm kernels' tolerances, dw/db within
    fp32 sums of n terms; repeats identical."""
    r = np.random.RandomState(75)
    y, x, g = (torch.from_numpy((r.randn(n, d) * 1.5).astype(
        np.float32)).to(cuda, dtype) for _ in range(3))
    w = torch.from_numpy((1.0 + 0.1 * r.randn(d)).astype(np.float32)).to(
        cuda)
    b = torch.from_numpy((0.1 * r.randn(d)).astype(np.float32)).to(cuda)
    seed = 2 ** 35 + 1
    before = (tln.dropout_add_layer_norm_cuda.launches,
              tln.dropout_add_layer_norm_bwd_cuda.launches)
    out = tln.dropout_add_layer_norm_cuda(y, x, w, b, rate, seed)
    want = tln.dropout_add_layer_norm_reference(y, x, w, b, rate, seed)
    assert out.dtype == dtype
    assert float((out.float() - want.float()).abs().max()) <= _tol(want,
                                                                   dtype)
    got = tln.dropout_add_layer_norm_bwd_cuda(y, x, w, g, rate, seed)
    ref = tln.dropout_add_layer_norm_bwd_reference(y, x, w, g, rate, seed)
    for a, b_ in zip(got[:2], ref[:2]):
        assert float((a.float() - b_.float()).abs().max()) <= _grad_tol(
            b_, dtype)
    for a, b_ in zip(got[2:], ref[2:]):
        assert a.dtype == torch.float32
        assert float((a - b_).abs().max()) <= 1e-6 * n
    assert (tln.dropout_add_layer_norm_cuda.launches,
            tln.dropout_add_layer_norm_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(out, tln.dropout_add_layer_norm_cuda(y, x, w, b, rate,
                                                            seed))
    again = tln.dropout_add_layer_norm_bwd_cuda(y, x, w, g, rate, seed)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("n, d, lo, hi", [(1024, 768, 0.88, 0.92),
                                          (256, 4352, 0.87, 0.93)])
def test_daln_mask_keep_rate_and_consistency(cuda, n, d, lo, hi):
    """The kernels' Philox bits equal the plain row mask: dy is
    keep * dx / (1 - rate) bit for bit, and perturbing only the dropped
    entries of y leaves the output and dx bit-identical (the forward and
    backward draw one mask); the keep rate at 0.1 lies in
    ``tools/tpu_kernel_drive.py``'s band; autograd launches both
    kernels."""
    seed, rate = 2 ** 37 + 9, 0.1
    keep = tdrop.row_keep_mask(seed, n, d, rate, device=cuda)
    assert lo < float(keep.float().mean()) < hi
    r = np.random.RandomState(76)
    y, x, g = (torch.from_numpy(r.randn(n, d).astype(np.float32)).to(cuda)
               for _ in range(3))
    w, b = torch.ones(d, device=cuda), torch.zeros(d, device=cuda)
    out = tln.dropout_add_layer_norm_cuda(y, x, w, b, rate, seed)
    y2 = torch.where(keep, y, y + 100.0)
    assert torch.equal(out, tln.dropout_add_layer_norm_cuda(y2, x, w, b,
                                                            rate, seed))
    dy, dx, _, _ = tln.dropout_add_layer_norm_bwd_cuda(y, x, w, g, rate,
                                                       seed)
    assert torch.equal(dx, tln.dropout_add_layer_norm_bwd_cuda(
        y2, x, w, g, rate, seed)[1])
    assert torch.equal(dy, torch.where(keep, dx * tdrop.keep_scale(rate),
                                       0.0))
    before = (tln.dropout_add_layer_norm_cuda.launches,
              tln.dropout_add_layer_norm_bwd_cuda.launches)
    args = [t.detach().requires_grad_(True) for t in (y, x, w, b)]
    torch.autograd.grad(tln.dropout_add_layer_norm(
        *args, rate=rate, seed=seed), args, g)
    assert (tln.dropout_add_layer_norm_cuda.launches,
            tln.dropout_add_layer_norm_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)


# #8/#9's edges: the LayerNorm edge widths, widths that are a multiple of
# 4 but not of 8 (16-byte accesses in fp32, single elements in bf16) or
# below one Philox quad, and one single-element width for each count of
# accesses a thread (2047, 4095, 4353, 14527: 4, 8, 16 and 32 at 16 warps
# a row); row counts about #9's row groups
DALN_EDGE_WIDTHS = (1, 3, 4, 7, 8, 9, 12, 255, 256, 257, 767, 768, 769, 772,
                    2047, 4095, 4351, 4352, 4353, 14527, 227 * 1024 // 16)
DALN_EDGE_ROWS = (1, tln.DALN_BWD_GROUPS - 1, tln.DALN_BWD_GROUPS,
                  tln.DALN_BWD_GROUPS + 1, 2 * tln.DALN_BWD_GROUPS + 1)


def _daln_inputs(seed, n, d, device, y_dtype, x_dtype):
    r = np.random.RandomState(seed)
    y, x, g = (torch.from_numpy(r.randn(n, d).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy((1.0 + 0.1 * r.randn(d)).astype(np.float32))
    b = torch.from_numpy((0.1 * r.randn(d)).astype(np.float32))
    return (y.to(device, y_dtype), (x * 2.0 + 0.5).to(device, x_dtype),
            w.to(device), b.to(device), g.to(device, x_dtype))


def _check_daln(y, x, w, b, g, rate, seed):
    """#8 and #9 against their plain versions: out, dy, dx within one bf16
    ulp (or 1e-4 in fp32) of each output's largest value, dw/db within
    1e-6 a row (4 rows' worth below 4 rows, where one term's rounding of
    shat outweighs the order of the sums); repeats bit-identical.
    Returns the kernels' results."""
    n = x.shape[0]
    out = tln.dropout_add_layer_norm_cuda(y, x, w, b, rate, seed)
    want = tln.dropout_add_layer_norm_reference(y, x, w, b, rate, seed)
    assert out.dtype == x.dtype
    assert float((out.float() - want.float()).abs().max()) <= _grad_tol(
        want, x.dtype)
    got = tln.dropout_add_layer_norm_bwd_cuda(y, x, w, g, rate, seed)
    ref = tln.dropout_add_layer_norm_bwd_reference(y, x, w, g, rate, seed)
    assert (got[0].dtype, got[1].dtype) == (y.dtype, x.dtype)
    for a, b_ in zip(got[:2], ref[:2]):
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b_.float()).abs().max()) <= _grad_tol(
            b_, b_.dtype)
    for a, b_ in zip(got[2:], ref[2:]):
        assert float((a - b_).abs().max()) <= 1e-6 * max(n, 4)
    assert torch.equal(out, tln.dropout_add_layer_norm_cuda(y, x, w, b, rate,
                                                            seed))
    again = tln.dropout_add_layer_norm_bwd_cuda(y, x, w, g, rate, seed)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    return out, got


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(n, d) for d in DALN_EDGE_WIDTHS
                                  for n in DALN_EDGE_ROWS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_daln_kernels_at_their_edges(cuda, n, d, dtype):
    """#8 and #9 at every edge shape, rates 0 and 0.1 (``_check_daln``);
    in fp32 the keep bits read back: dy is keep * dx / (1 - rate) bit for
    bit with the plain row mask, and adding 100 to the dropped entries of
    y leaves the output and dx bit-identical."""
    seed = 2 ** 36 + 5
    y, x, w, b, g = _daln_inputs(n + d, n, d, cuda, dtype, dtype)
    for rate in (0.0, 0.1):
        out, got = _check_daln(y, x, w, b, g, rate, seed)
    if dtype == torch.float32:
        keep = tdrop.row_keep_mask(seed, n, d, 0.1, device=cuda)
        assert torch.equal(got[0], torch.where(
            keep, got[1] * tdrop.keep_scale(0.1), 0.0))
        y2 = torch.where(keep, y, y + 100.0)
        assert torch.equal(out, tln.dropout_add_layer_norm_cuda(
            y2, x, w, b, 0.1, seed))
        assert torch.equal(got[1], tln.dropout_add_layer_norm_bwd_cuda(
            y2, x, w, g, 0.1, seed)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 769, 4352])
def test_daln_kernels_read_misaligned_views_and_mixed_dtypes(cuda, d):
    """Views of every input off the 16-byte alignment give the aligned
    call's results bit for bit (they are copied, so the access width rests
    on width and dtype alone); mixed y/x dtypes are taken to fp32 and match
    the plain versions, each output in its own input's dtype."""
    n, seed = tln.DALN_BWD_GROUPS + 1, 2 ** 36 + 6

    def off_alignment(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    for dtype in (torch.float32, torch.bfloat16):
        args = _daln_inputs(d, n, d, cuda, dtype, dtype)
        views = [off_alignment(t) for t in args]
        assert all(v.data_ptr() % 16 for v in views)
        out, got = _check_daln(*args, 0.1, seed)
        v_out, v_got = _check_daln(*views, 0.1, seed)
        assert torch.equal(out, v_out)
        assert all(torch.equal(a, c) for a, c in zip(got, v_got))
    for y_dtype, x_dtype in ((torch.bfloat16, torch.float32),
                             (torch.float32, torch.bfloat16)):
        args = _daln_inputs(d + 1, n, d, cuda, y_dtype, x_dtype)
        for rate in (0.0, 0.1):
            _check_daln(*args, rate, seed)


def test_cpu_backward_and_daln_take_the_plain_versions():
    """On the CPU the head-major backward and the fused dropout-add-
    LayerNorm call their plain versions and count no launch."""
    counts = (tatt.mha_attention_bwd_cuda.launches,
              tln.dropout_add_layer_norm_cuda.launches,
              tln.dropout_add_layer_norm_bwd_cuda.launches)
    q, k, v, mask = _mha_inputs(77, 2, 3, 4, 9, 16, "step", "cpu",
                                torch.float32)
    qkv = [t.requires_grad_(True) for t in (q, k, v)]
    g = torch.randn(2, 3, 4, 16)
    got = torch.autograd.grad(tatt.multi_head_attention(
        *qkv, mask, dropout_rate=0.2, seed=4, causal=True), qkv, g)
    want = tatt.mha_backward_reference(q, k, v, mask, g, 0.2, 4, True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    y, x = torch.randn(6, 32), torch.randn(6, 32)
    w, b = torch.ones(32), torch.zeros(32)
    torch.testing.assert_close(
        tln.dropout_add_layer_norm(y, x, w, b, rate=0.1, seed=3),
        tln.dropout_add_layer_norm_reference(y, x, w, b, 0.1, 3),
        atol=0, rtol=0)
    assert counts == (tatt.mha_attention_bwd_cuda.launches,
                      tln.dropout_add_layer_norm_cuda.launches,
                      tln.dropout_add_layer_norm_bwd_cuda.launches)
