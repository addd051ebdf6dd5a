"""Row LayerNorm and the fused dropout-add-LayerNorm: the plain PyTorch
versions, the CUDA kernels and the ``torch.autograd.Function``s that join
them.

Counterpart of ``hero_tpu/ops/layernorm.py`` (``_fused_layer_norm`` and its
custom VJP).  Statistics are fp32 whatever the input type, the affine
weights are applied in fp32 and the output keeps the input type.  The
backward recomputes the row statistics and gives
``dx = rstd * (g w - mean(g w) - xhat * mean(g w xhat))`` in the input
type and fp32 ``dw = sum g xhat``, ``db = sum g`` over rows.

:func:`layer_norm` goes through :class:`LayerNorm`.  A CPU tensor takes
the plain versions; a CUDA tensor launches the kernels
(``csrc/layernorm.cu``) or raises -- there is no fallback and no width
threshold, so every LayerNorm of the model runs the kernels on the card.

:func:`dropout_add_layer_norm` is ``LN(dropout(y) + x)``, the counterpart
of ``hero_tpu/ops/layernorm.py:175-342`` (Pallas kernels #8 and #9) and
of its jnp path: the dropout keeps ``y`` where the Philox bit of
(seed, row, col) says so (``ops/dropout.row_keep_mask``) and scales it by
1 / (1 - rate); the sum stays fp32 through the LayerNorm; the output
takes ``x``'s dtype (the jnp path's: the Pallas path returns ``y``'s,
which differs only when the two dtypes do).  The backward regenerates
the bits and gives dy = keep * ds / (1 - rate) in y's dtype, dx = ds in
x's, and fp32 dw, db.  As in the JAX package, no model code calls it.
"""

from __future__ import annotations

import ctypes

import torch

from hero_tpu_torch.ops import cuda_build
from hero_tpu_torch.ops.dropout import (float32, keep_scale, row_keep_mask,
                                        seed_words)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5
                         ) -> torch.Tensor:
    """The plain version (``hero_tpu/ops/layernorm.py:30-37``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm_bwd_reference(x: torch.Tensor, weight: torch.Tensor,
                             g: torch.Tensor, eps: float = 1e-5):
    """The plain backward (``hero_tpu/ops/layernorm.py:64-90``): (dx in
    x's dtype, dw, db in fp32) for upstream gradient ``g``."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    gf = g.reshape(-1, d).float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    gw = gf * weight.float()
    m1 = gw.mean(-1, keepdim=True)
    m2 = (gw * xhat).mean(-1, keepdim=True)
    dx = rstd * (gw - m1 - xhat * m2)
    return (dx.to(x.dtype).reshape(x.shape), (gf * xhat).sum(0),
            gf.sum(0))


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("layernorm")
    if lib.hero_layer_norm_fwd.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.hero_layer_norm_fwd.argtypes = [i32, vp, vp, vp, vp,
                                            ctypes.c_longlong, i32,
                                            ctypes.c_float, vp]
        lib.hero_layer_norm_bwd.argtypes = ([i32] + [vp] * 7
                                            + [ctypes.c_longlong, i32, i32,
                                               i32, ctypes.c_float, vp])
        f32, u32 = ctypes.c_float, ctypes.c_uint
        lib.hero_daln_fwd.argtypes = ([i32] + [vp] * 5
                                      + [ctypes.c_longlong, i32, f32, f32,
                                         f32, u32, u32, vp])
        lib.hero_daln_bwd.argtypes = ([i32] + [vp] * 9
                                      + [ctypes.c_longlong, i32, i32, i32,
                                         f32, f32, f32, u32, u32, vp])
        for fn in (lib.hero_layer_norm_fwd, lib.hero_layer_norm_bwd,
                   lib.hero_daln_fwd, lib.hero_daln_bwd):
            fn.restype = ctypes.c_int
    return lib


def _check(x, weight, bias=None):
    if x.dtype not in cuda_build.DTYPE_CODES:
        raise TypeError(f"layer_norm kernel takes float32/bfloat16, "
                        f"got {x.dtype}")
    d = x.shape[-1]
    if weight.shape != (d,) or (bias is not None and bias.shape != (d,)):
        raise ValueError(f"weight/bias must be ({d},), got "
                         f"{tuple(weight.shape)}/"
                         f"{None if bias is None else tuple(bias.shape)}")
    if weight.device != x.device or (bias is not None
                                     and bias.device != x.device):
        raise ValueError("x, weight and bias must be on one device")
    if d * 4 * 4 > 227 * 1024:
        raise ValueError(f"row width {d} exceeds the kernels' shared memory")
    return d


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) at a 16-byte aligned address: a view that starts
    off the alignment is copied.  The kernels take 16-byte accesses only
    where every pointer is aligned, so their access width, and with it the
    order of their sums, depends on the width and dtype alone."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the LayerNorm kernel over the last axis of a CUDA tensor.
    ``layer_norm_cuda.launches`` counts the launches."""
    d = _check(x, weight, bias)
    x2 = _aligned(x.reshape(-1, d).contiguous())
    w = _aligned(weight.float().contiguous())
    b = _aligned(bias.float().contiguous())
    out = torch.empty_like(x2)
    if x2.shape[0]:
        lib = _lib()
        with torch.cuda.device(x.device):
            err = lib.hero_layer_norm_fwd(
                cuda_build.DTYPE_CODES[x.dtype], x2.data_ptr(), w.data_ptr(),
                b.data_ptr(), out.data_ptr(), x2.shape[0], d, float(eps),
                cuda_build.stream_ptr(x))
        cuda_build.check(lib, err, "layer_norm kernel")
        layer_norm_cuda.launches += 1
    return out.reshape(x.shape)


# row groups of the LayerNorm backward's row pass, a block each: two an SM
# of the card's 132, so every group is resident at once and the
# (groups, 2, d) fp32 partials stay a few MB
LN_BWD_GROUPS = 264
# row groups of the fused dropout-add-LayerNorm backward's row pass (#9):
# two an SM too, which beat one, three and four an SM at (14336, 768) and
# (1024, 768) on the H100 (chip_smoke.py --times daln; PERF.md)
DALN_BWD_GROUPS = 264


def row_groups(n: int, max_groups: int):
    """The backward's partition of n rows: (groups, rows a group), group i
    taking rows [i * rows, min(n, (i + 1) * rows)).  At most
    ``max_groups`` groups, none empty, a function of n alone: the partial
    sums, and so dw and db, are the same from run to run."""
    if n <= 0:
        return 0, 0
    rows = -(-n // max_groups)
    return -(-n // rows), rows


def layer_norm_bwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                        g: torch.Tensor, eps: float = 1e-5):
    """Launch the backward kernels, the row pass over
    :func:`row_groups` of ``LN_BWD_GROUPS`` and the column pass over its
    partials: (dx in x's dtype, dw, db fp32).
    ``layer_norm_bwd_cuda.launches`` counts the launches (one per call:
    the row pass and the reduction run as one)."""
    d = _check(x, weight)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("g must have x's shape, dtype and device")
    x2 = _aligned(x.reshape(-1, d).contiguous())
    g2 = _aligned(g.reshape(-1, d).contiguous())
    w = _aligned(weight.float().contiguous())
    n = x2.shape[0]
    dx = torch.empty_like(x2)
    # the column pass writes every entry of dw and db when there are rows
    alloc = torch.empty if n else torch.zeros
    dw = alloc(d, dtype=torch.float32, device=x.device)
    db = alloc(d, dtype=torch.float32, device=x.device)
    if n:
        n_blocks, rows = row_groups(n, LN_BWD_GROUPS)
        partial = torch.empty((n_blocks, 2, d), dtype=torch.float32,
                              device=x.device)
        lib = _lib()
        with torch.cuda.device(x.device):
            err = lib.hero_layer_norm_bwd(
                cuda_build.DTYPE_CODES[x.dtype], x2.data_ptr(), w.data_ptr(),
                g2.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                dw.data_ptr(), db.data_ptr(), n, d, n_blocks, rows,
                float(eps), cuda_build.stream_ptr(x))
        cuda_build.check(lib, err, "layer_norm backward kernel")
        layer_norm_bwd_cuda.launches += 1
    return dx.reshape(x.shape), dw, db


layer_norm_cuda.launches = 0
layer_norm_bwd_cuda.launches = 0


class LayerNorm(torch.autograd.Function):
    """LayerNorm over the last axis with the recompute backward; dw and db
    come back in the parameters' own dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        if x.device.type == "cpu":
            out = layer_norm_reference(x, weight, bias, eps)
        elif x.device.type == "cuda":
            out = layer_norm_cuda(x, weight, bias, eps)
        else:
            raise ValueError(f"layer_norm runs on cpu or cuda, not "
                             f"{x.device}")
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(x, weight)
            ctx.eps = eps
            ctx.dtypes = (weight.dtype, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        bwd = (layer_norm_bwd_reference if x.device.type == "cpu"
               else layer_norm_bwd_cuda)
        dx, dw, db = bwd(x, weight, g.to(x.dtype), ctx.eps)
        return dx, dw.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; any leading shape."""
    return LayerNorm.apply(x, weight, bias, float(eps))


# ---------------------------------------------------------------------------
# fused dropout + add + LayerNorm
# ---------------------------------------------------------------------------

def _daln_rate(rate: float, seed) -> float:
    """The rate the op runs at: a rate with no seed is rate 0, as the JAX
    package's ``rng=None`` is (``hero_tpu/ops/layernorm.py:310-311``).
    The kernels take the rate in fp32, so it must stay below 1 there."""
    if not (0.0 <= rate < 1.0 and float32(rate) < 1.0):
        raise ValueError(f"dropout rate must lie in [0, 1) in fp32, got "
                         f"{rate}")
    if seed is not None and not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be a 64-bit unsigned int, got {seed}")
    return float(rate) if seed is not None else 0.0


def _dropped_sum(y, x, rate: float, seed) -> torch.Tensor:
    """fp32 drop(y) + x over (n, d) rows, and the keep mask (or None)."""
    yf = y.float()
    keep = None
    if rate:
        keep = row_keep_mask(seed, y.shape[0], y.shape[1], rate, y.device)
        yf = torch.where(keep, yf * keep_scale(rate), 0.0)
    return yf + x.float(), keep


def dropout_add_layer_norm_reference(y, x, weight, bias, rate: float = 0.0,
                                     seed=None, eps: float = 1e-5
                                     ) -> torch.Tensor:
    """The plain forward (``hero_tpu/ops/layernorm.py:312-319``, with the
    Philox draw): LN(drop(y) + x) over the last axis in x's dtype."""
    rate = _daln_rate(rate, seed)
    d = x.shape[-1]
    s, _ = _dropped_sum(y.reshape(-1, d), x.reshape(-1, d), rate, seed)
    return layer_norm_reference(s, weight, bias, eps).to(x.dtype).reshape(
        x.shape)


def dropout_add_layer_norm_bwd_reference(y, x, weight, g, rate: float = 0.0,
                                         seed=None, eps: float = 1e-5):
    """The plain backward (``_daln_bwd_kernel``,
    ``hero_tpu/ops/layernorm.py:195-235``): (dy in y's dtype, dx in x's,
    dw, db fp32) for upstream gradient ``g``."""
    rate = _daln_rate(rate, seed)
    d = x.shape[-1]
    s, keep = _dropped_sum(y.reshape(-1, d), x.reshape(-1, d), rate, seed)
    ds, dw, db = layer_norm_bwd_reference(s, weight, g.reshape(-1, d), eps)
    dy = ds if keep is None else torch.where(keep, ds * keep_scale(rate),
                                             0.0)
    return (dy.to(y.dtype).reshape(y.shape), ds.to(x.dtype).reshape(x.shape),
            dw, db)


def _daln_rows(y, x, weight, bias=None):
    """The (n, d) rows the kernels take: one dtype (two dtypes are both
    taken to fp32, exactly, and the results rounded once to their own
    types), contiguous and 16-byte aligned (``_aligned``)."""
    d = _check(x, weight, bias)
    if y.shape != x.shape or y.device != x.device:
        raise ValueError(f"y and x must share shape and device, got "
                         f"{tuple(y.shape)} {y.device} / {tuple(x.shape)} "
                         f"{x.device}")
    if y.dtype not in cuda_build.DTYPE_CODES:
        raise TypeError(f"dropout_add_layer_norm kernel takes "
                        f"float32/bfloat16, got {y.dtype}")
    if y.dtype != x.dtype:
        y, x = y.float(), x.float()
    n = x.numel() // d
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed the kernels' grid")
    return (_aligned(y.reshape(-1, d).contiguous()),
            _aligned(x.reshape(-1, d).contiguous()), d)


def dropout_add_layer_norm_cuda(y, x, weight, bias, rate: float = 0.0,
                                seed=None, eps: float = 1e-5
                                ) -> torch.Tensor:
    """Launch the fused forward kernel (#8) over the last axis of CUDA
    tensors: LN(drop(y) + x) in x's dtype.
    ``dropout_add_layer_norm_cuda.launches`` counts the launches."""
    rate = _daln_rate(rate, seed)
    y2, x2, d = _daln_rows(y, x, weight, bias)
    w = _aligned(weight.float().contiguous())
    b = _aligned(bias.float().contiguous())
    out = torch.empty_like(x2)
    if x2.shape[0]:
        lib = _lib()
        with torch.cuda.device(x.device):
            err = lib.hero_daln_fwd(
                cuda_build.DTYPE_CODES[x2.dtype], y2.data_ptr(),
                x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                x2.shape[0], d, float(eps), rate,
                keep_scale(rate),
                *seed_words(seed), cuda_build.stream_ptr(x))
        cuda_build.check(lib, err, "dropout_add_layer_norm kernel")
        dropout_add_layer_norm_cuda.launches += 1
    return out.to(x.dtype).reshape(x.shape)


def dropout_add_layer_norm_bwd_cuda(y, x, weight, g, rate: float = 0.0,
                                    seed=None, eps: float = 1e-5):
    """Launch the fused backward kernels (#9), the row pass over
    :func:`row_groups` of ``DALN_BWD_GROUPS`` and the column pass over its
    partials: (dy in y's dtype, dx in x's, dw, db fp32).
    ``dropout_add_layer_norm_bwd_cuda.launches`` counts the launches (one
    per call: the row pass and the reduction run as one)."""
    rate = _daln_rate(rate, seed)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError("g must have x's shape and device")
    y2, x2, d = _daln_rows(y, x, weight)
    g2 = _aligned(g.to(x2.dtype).reshape(-1, d).contiguous())
    w = _aligned(weight.float().contiguous())
    n = x2.shape[0]
    dy, dx = torch.empty_like(y2), torch.empty_like(x2)
    # the column pass writes every entry of dw and db when there are rows
    alloc = torch.empty if n else torch.zeros
    dw = alloc(d, dtype=torch.float32, device=x.device)
    db = alloc(d, dtype=torch.float32, device=x.device)
    if n:
        n_blocks, rows = row_groups(n, DALN_BWD_GROUPS)
        partial = torch.empty((n_blocks, 2, d), dtype=torch.float32,
                              device=x.device)
        lib = _lib()
        with torch.cuda.device(x.device):
            err = lib.hero_daln_bwd(
                cuda_build.DTYPE_CODES[x2.dtype], y2.data_ptr(),
                x2.data_ptr(), w.data_ptr(), g2.data_ptr(), dy.data_ptr(),
                dx.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                db.data_ptr(), n, d, n_blocks, rows, float(eps), rate,
                keep_scale(rate), *seed_words(seed),
                cuda_build.stream_ptr(x))
        cuda_build.check(lib, err, "dropout_add_layer_norm backward kernel")
        dropout_add_layer_norm_bwd_cuda.launches += 1
    return (dy.to(y.dtype).reshape(y.shape), dx.to(x.dtype).reshape(x.shape),
            dw, db)


dropout_add_layer_norm_cuda.launches = 0
dropout_add_layer_norm_bwd_cuda.launches = 0


class DropoutAddLayerNorm(torch.autograd.Function):
    """LN(drop(y) + x) over the last axis with the mask-regenerating
    backward; dw and db come back in the parameters' own dtype."""

    @staticmethod
    def forward(ctx, y, x, weight, bias, rate, seed, eps):
        if x.device.type == "cpu":
            out = dropout_add_layer_norm_reference(y, x, weight, bias, rate,
                                                   seed, eps)
        elif x.device.type == "cuda":
            out = dropout_add_layer_norm_cuda(y, x, weight, bias, rate, seed,
                                              eps)
        else:
            raise ValueError(f"dropout_add_layer_norm runs on cpu or cuda, "
                             f"not {x.device}")
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(y, x, weight)
            ctx.args = (rate, seed, eps)
            ctx.dtypes = (weight.dtype, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        y, x, weight = ctx.saved_tensors
        bwd = (dropout_add_layer_norm_bwd_reference if x.device.type == "cpu"
               else dropout_add_layer_norm_bwd_cuda)
        dy, dx, dw, db = bwd(y, x, weight, g.to(x.dtype), *ctx.args)
        return (dy, dx, dw.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None,
                None, None)


def dropout_add_layer_norm(y: torch.Tensor, x: torch.Tensor,
                           weight: torch.Tensor, bias: torch.Tensor,
                           rate: float = 0.0, seed=None,
                           eps: float = 1e-5) -> torch.Tensor:
    """``LN(dropout(y) + x)`` over the last axis
    (``hero_tpu/ops/layernorm.py:298-342``); ``rate`` > 0 with no ``seed``
    runs at rate 0."""
    return DropoutAddLayerNorm.apply(y, x, weight, bias,
                                     _daln_rate(rate, seed), seed, float(eps))
