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
shapes of the packed forward (#2).
"""

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
    # the backward's fp32 tiles for 144 keys at head_dim 128 exceed the
    # shared memory a block may use
    q, k, v = _qkv(15, 1, 144, 256, cuda, torch.float32)
    p = torch.zeros((1, 2, 144, 144), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tatt.attention_bwd_cuda(p, q, k, v, q.contiguous(), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(37, 768), (20800, 768), (11, 4352),
                                  (3200, 4352)])
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
                                  (3200, 4352)])
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
    # order, at most n * 2^-23 * 8 ~ 1e-6 * n apart
    assert float((got[0].float() - want[0].float()).abs().max()) <= _tol(
        want[0], dtype)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-6 * n
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
