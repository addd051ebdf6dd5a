// Shared helpers for the port's CUDA kernels: dtype codes, float
// conversions and warp reductions.  Kernel sources include no PyTorch
// header: each exposes a plain C entry point bound with ctypes
// (hero_tpu_torch/ops/cuda_build.py), which keeps an nvcc build to seconds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes shared with the Python wrappers (cuda_build.DTYPE_CODES)
enum HeroDtype : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round-to-nearest-even, as torch's .to(torch.bfloat16)
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

extern "C" const char* hero_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
