"""Row LayerNorm: the plain PyTorch version and the CUDA kernel.

Counterpart of ``hero_tpu/ops/layernorm.py``.  Statistics are fp32 whatever
the input type, the affine weights are applied in fp32 and the output keeps
the input type.  :func:`layer_norm` dispatches on the tensor's device: a
CPU tensor takes :func:`layer_norm_reference`; a CUDA tensor launches the
kernel (``csrc/layernorm.cu``) or raises -- there is no fallback and no
width threshold, so every LayerNorm of the model runs the kernel on the
card.
"""

from __future__ import annotations

import ctypes

import torch

from hero_tpu_torch.ops import cuda_build


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5
                         ) -> torch.Tensor:
    """The plain version (``hero_tpu/ops/layernorm.py:30-37``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("layernorm")
    fn = lib.hero_layer_norm_fwd
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib


def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the LayerNorm kernel over the last axis of a CUDA tensor.
    ``layer_norm_cuda.launches`` counts the launches."""
    if x.dtype not in cuda_build.DTYPE_CODES:
        raise TypeError(f"layer_norm kernel takes float32/bfloat16, "
                        f"got {x.dtype}")
    d = x.shape[-1]
    if weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"weight/bias must be ({d},), got "
                         f"{tuple(weight.shape)}/{tuple(bias.shape)}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, weight and bias must be on one device")
    if d * 4 > 227 * 1024:
        raise ValueError(f"row width {d} exceeds the kernel's shared memory")
    x2 = x.reshape(-1, d).contiguous()
    w = weight.float().contiguous()
    b = bias.float().contiguous()
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


layer_norm_cuda.launches = 0


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; any leading shape."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cpu or cuda, not {x.device}")
    return layer_norm_cuda(x, weight, bias, eps)
