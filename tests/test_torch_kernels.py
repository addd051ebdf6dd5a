"""hero_tpu_torch CUDA kernels against their plain PyTorch versions.

The kernel tests need a CUDA card and skip without one; on the card run

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have; this file imports only torch, numpy and the port).
The CPU tests check the dispatch: a CPU tensor takes the plain version
and launches nothing.
"""

import numpy as np
import pytest
import torch

from hero_tpu_torch.ops import attention as tatt
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
    with pytest.raises(NotImplementedError):
        tatt.packed_attention(q, k, v, 3, dropout_rate=0.1)
    with pytest.raises(TypeError):
        tatt.packed_attention(q.half(), k.half(), v.half(), 3)


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


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers call the plain versions and count no
    launch (the counts say only what ran on the card)."""
    counts = (tatt.seg_attention_cuda.launches,
              tatt.valid_attention_cuda.launches,
              tln.layer_norm_cuda.launches)
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
    assert counts == (tatt.seg_attention_cuda.launches,
                      tatt.valid_attention_cuda.launches,
                      tln.layer_norm_cuda.launches)
