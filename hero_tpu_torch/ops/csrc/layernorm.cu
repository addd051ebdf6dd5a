// Row LayerNorm forward.
//
// Replaces the Pallas kernel hero_tpu/ops/layernorm.py _fwd_kernel (:53),
// reached through _fused_layer_norm / layer_norm.  Per row of x (n, d):
//   mean = sum(x) / d;  var = sum((x - mean)^2) / d   (two-pass, fp32)
//   y = (x - mean) * rsqrt(var + eps) * w + b         (fp32 w, b)
// rounded once to the input type (fp32 or bf16).
//
// Bound on the H100: ~8 flops per element against 2 * sizeof(T) bytes, so
// memory-bound at every width (768 and 4352 on the serving path).  Design:
// one block per row; the row is read from device memory once into shared
// memory as fp32 (17 KB at d = 4352), both reduction passes and the affine
// pass run from there, and the output is written once.
#include "common.cuh"

namespace {

// Sum over the block; every thread gets the total.  ``red`` holds one
// partial per warp and is reused across calls.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < n_warps ? red[lane] : 0.f;
  return warp_sum(v);
}

template <typename T>
__global__ void layer_norm_kernel(const T* __restrict__ x,
                                  const float* __restrict__ w,
                                  const float* __restrict__ bias,
                                  T* __restrict__ y, int d, float eps) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const T* xr = x + r * d;
  T* yr = y + r * d;

  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float t = to_float(xr[i]);
    row[i] = t;
    s += t;
  }
  const float mean = block_sum(s, red) / static_cast<float>(d);
  float s2 = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = row[i] - mean;
    row[i] = c;
    s2 += c * c;
  }
  const float var = block_sum(s2, red) / static_cast<float>(d);
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    yr[i] = from_float<T>(row[i] * rstd * w[i] + bias[i]);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   long long n, int d, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        layer_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = d <= 1024 ? 256 : 512;
  layer_norm_kernel<T><<<static_cast<unsigned>(n), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  x, y: contiguous (n, d);
// w, b: contiguous fp32 (d,).
extern "C" int hero_layer_norm_fwd(int dtype, const void* x, const void* w,
                                   const void* b, void* y, long long n, int d,
                                   float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kFloat32: e = launch<float>(x, w, b, y, n, d, eps, s); break;
    case kBFloat16: e = launch<__nv_bfloat16>(x, w, b, y, n, d, eps, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
