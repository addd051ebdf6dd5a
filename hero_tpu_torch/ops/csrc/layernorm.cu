// Row LayerNorm: forward, and the backward in two passes.
//
// Forward.  Replaces the Pallas kernel hero_tpu/ops/layernorm.py _fwd_kernel
// (:53), reached through _fused_layer_norm / layer_norm.  Per row of x (n, d):
//   mean = sum(x) / d;  var = sum((x - mean)^2) / d   (two-pass, fp32)
//   y = (x - mean) * rsqrt(var + eps) * w + b         (fp32 w, b)
// rounded once to the input type (fp32 or bf16).
//
// Bound on the H100: ~8 flops per element against 2 * sizeof(T) bytes, so
// memory-bound at every width (768 and 4352 on the path).  Design: one
// block per row; the row is read from device memory once into shared
// memory as fp32 (17 KB at d = 4352), both reduction passes and the affine
// pass run from there, and the output is written once.
//
// Backward.  Replaces _bwd_kernel (hero_tpu/ops/layernorm.py:64, pallas_call
// at :128).  It recomputes each row's statistics and gives
//   dx = rstd * (g w - mean(g w) - xhat * mean(g w xhat)),
//   dw = sum over rows of g xhat,   db = sum over rows of g   (fp32).
// The TPU kernel adds dw/db into one output block across its sequential
// grid; blocks on the card run in no order, and atomics would make the
// sums differ from run to run.  So pass 1 gives each block a fixed run of
// rows and writes that run's partial dw/db (each thread owns fixed
// columns and sums its rows in order), and pass 2 reduces the partials of
// every block in block order, a thread per column.  The grads are the same
// from run to run.  Bound: memory (x and g read once, dx written once);
// pass 1 keeps x and g rows and the partial sums in shared memory (70 KB
// at d = 4352) and reads each input element once.
//
// Fused dropout + residual add + LayerNorm, forward and backward (at the
// end of the file).  Replaces the Pallas kernels _daln_fwd_kernel
// (hero_tpu/ops/layernorm.py:175, pallas_call at :257) and
// _daln_bwd_kernel (:195, pallas_call at :277), reached through
// dropout_add_layer_norm.  Per row of y, x (n, d):
//   s = drop(y) + x   (fp32; drop(y) = keep ? y / (1 - r) : 0)
//   out = LN(s) * w + b, rounded once to the input type,
// and the backward, from the same keep bits (philox.cuh, counter (col,
// row, 0xFFFFFFFF)) and the recomputed statistics of s:
//   ds = rstd * (g w - mean(g w) - shat * mean(g w shat)),
//   dx = ds,  dy = keep ? ds / (1 - r) : 0,
//   dw = sum over rows of g shat,  db = sum over rows of g.
// The TPU kernel draws its bits per row block from the TPU PRNG and adds
// dw/db into one block across its sequential grid; here the bits are a
// function of (seed, row, col), and dw/db go through per-block partials
// and the block-ordered reduction of the LayerNorm backward, so the
// grads are the same from run to run.  Bound: memory, as the LayerNorm
// kernels (two inputs read and one output written forward; y, x, g read
// and dy, dx written backward); the Philox draw (10 rounds of two 32-bit
// multiplies a kept-or-dropped element) runs on the CUDA cores beside the
// loads.  Design: the LayerNorm kernels' (a row a block in the forward, a
// fixed run of rows a block in the backward, the row in shared memory as
// fp32).
#include "common.cuh"
#include "philox.cuh"

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

template <typename T>
__global__ void layer_norm_bwd_kernel(const T* __restrict__ x,
                                      const float* __restrict__ w,
                                      const T* __restrict__ g,
                                      T* __restrict__ dx,
                                      float* __restrict__ partial,
                                      long long n, int d, int rows_per_block,
                                      float eps) {
  extern __shared__ float sm[];
  float* xr = sm;             // [d] centred row, then xhat
  float* gr = xr + d;         // [d] g * w
  float* pdw = gr + d;        // [d] this block's partial dw
  float* pdb = pdw + d;       // [d] this block's partial db
  __shared__ float red[32];
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    pdw[i] = 0.f;
    pdb[i] = 0.f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, n);
  const float inv_d = 1.f / static_cast<float>(d);
  for (long long r = r0; r < r1; ++r) {
    const T* xrow = x + r * d;
    const T* grow = g + r * d;
    float s = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float t = to_float(xrow[i]);
      xr[i] = t;
      s += t;
    }
    const float mean = block_sum(s, red) * inv_d;
    float s2 = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float c = xr[i] - mean;
      xr[i] = c;
      s2 += c * c;
    }
    const float rstd = rsqrtf(block_sum(s2, red) * inv_d + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float xh = xr[i] * rstd;
      const float gv = to_float(grow[i]);
      const float gw = gv * w[i];
      xr[i] = xh;
      gr[i] = gw;
      m1 += gw;
      m2 += gw * xh;
      pdw[i] += gv * xh;
      pdb[i] += gv;
    }
    m1 = block_sum(m1, red) * inv_d;
    m2 = block_sum(m2, red) * inv_d;
    T* dxrow = dx + r * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      dxrow[i] = from_float<T>(rstd * (gr[i] - m1 - xr[i] * m2));
    __syncthreads();
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    out[i] = pdw[i];
    out[d + i] = pdb[i];
  }
}

// dw[c] = sum_b partial[b][0][c], db[c] = sum_b partial[b][1][c], summed
// in block order.
__global__ void layer_norm_bwd_reduce_kernel(const float* __restrict__ partial,
                                             int n_blocks, int d,
                                             float* __restrict__ dw,
                                             float* __restrict__ db) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float sw = 0.f, sb = 0.f;
  for (int b = 0; b < n_blocks; ++b) {
    sw += partial[static_cast<long long>(b) * 2 * d + c];
    sb += partial[static_cast<long long>(b) * 2 * d + d + c];
  }
  dw[c] = sw;
  db[c] = sb;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* g, void* dx,
                       float* partial, float* dw, float* db, long long n,
                       int d, int n_blocks, int rows_per_block, float eps,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        layer_norm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = d <= 1024 ? 256 : 512;
  layer_norm_bwd_kernel<T><<<n_blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), partial, n, d,
      rows_per_block, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  layer_norm_bwd_reduce_kernel<<<(d + 255) / 256, 256, 0, stream>>>(
      partial, n_blocks, d, dw, db);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fused dropout + add + LayerNorm
// ---------------------------------------------------------------------------

struct DalnArgs {
  const void* y;
  const void* x;
  const float* w;
  const float* b;   // forward only
  const void* g;    // backward only
  void* out;        // forward: LN(drop(y) + x)
  void* dy;         // backward
  void* dx;         // backward
  float* partial;   // backward: (n_blocks, 2, d)
  long long n;
  int d, rows_per_block;
  float eps, rate, keep_scale;
  PhiloxKey key;
};

template <typename T>
__device__ __forceinline__ float dropped(const DalnArgs& a, const T* yr,
                                         long long r, int i) {
  const float v = to_float(yr[i]);
  if (a.rate <= 0.f) return v;
  return row_dropout_keep(a.key, r, i, a.rate) ? v * a.keep_scale : 0.f;
}

template <typename T>
__global__ void daln_fwd_kernel(DalnArgs a) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const int d = a.d;
  const long long r = blockIdx.x;
  const T* yr = static_cast<const T*>(a.y) + r * d;
  const T* xr = static_cast<const T*>(a.x) + r * d;
  T* orow = static_cast<T*>(a.out) + r * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float t = dropped(a, yr, r, i) + to_float(xr[i]);
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
  const float rstd = rsqrtf(block_sum(s2, red) / static_cast<float>(d)
                            + a.eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    orow[i] = from_float<T>(row[i] * rstd * a.w[i] + a.b[i]);
}

template <typename T>
__global__ void daln_bwd_kernel(DalnArgs a) {
  extern __shared__ float sm[];
  const int d = a.d;
  float* sr = sm;             // [d] centred sum, then shat
  float* gr = sr + d;         // [d] g * w
  float* pdw = gr + d;        // [d] this block's partial dw
  float* pdb = pdw + d;       // [d] this block's partial db
  __shared__ float red[32];
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    pdw[i] = 0.f;
    pdb[i] = 0.f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * a.rows_per_block;
  const long long r1 = min(r0 + a.rows_per_block, a.n);
  const float inv_d = 1.f / static_cast<float>(d);
  for (long long r = r0; r < r1; ++r) {
    const T* yr = static_cast<const T*>(a.y) + r * d;
    const T* xr = static_cast<const T*>(a.x) + r * d;
    const T* grow = static_cast<const T*>(a.g) + r * d;
    float s = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float t = dropped(a, yr, r, i) + to_float(xr[i]);
      sr[i] = t;
      s += t;
    }
    const float mean = block_sum(s, red) * inv_d;
    float s2 = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float c = sr[i] - mean;
      sr[i] = c;
      s2 += c * c;
    }
    const float rstd = rsqrtf(block_sum(s2, red) * inv_d + a.eps);
    float m1 = 0.f, m2 = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float sh = sr[i] * rstd;
      const float gv = to_float(grow[i]);
      const float gw = gv * a.w[i];
      sr[i] = sh;
      gr[i] = gw;
      m1 += gw;
      m2 += gw * sh;
      pdw[i] += gv * sh;
      pdb[i] += gv;
    }
    m1 = block_sum(m1, red) * inv_d;
    m2 = block_sum(m2, red) * inv_d;
    T* dxrow = static_cast<T*>(a.dx) + r * d;
    T* dyrow = static_cast<T*>(a.dy) + r * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float ds = rstd * (gr[i] - m1 - sr[i] * m2);
      dxrow[i] = from_float<T>(ds);
      float dyv = ds;
      if (a.rate > 0.f)
        dyv = row_dropout_keep(a.key, r, i, a.rate) ? ds * a.keep_scale : 0.f;
      dyrow[i] = from_float<T>(dyv);
    }
    __syncthreads();
  }
  float* out = a.partial + static_cast<long long>(blockIdx.x) * 2 * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    out[i] = pdw[i];
    out[d + i] = pdb[i];
  }
}

template <typename T>
cudaError_t launch_daln_fwd(const DalnArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(a.d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        daln_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = a.d <= 1024 ? 256 : 512;
  daln_fwd_kernel<T><<<static_cast<unsigned>(a.n), threads, smem, stream>>>(
      a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_daln_bwd(const DalnArgs& a, int n_blocks, float* dw,
                            float* db, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(a.d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        daln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = a.d <= 1024 ? 256 : 512;
  daln_bwd_kernel<T><<<n_blocks, threads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  layer_norm_bwd_reduce_kernel<<<(a.d + 255) / 256, 256, 0, stream>>>(
      a.partial, n_blocks, a.d, dw, db);
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

// Returns a cudaError_t code (0 = launched).  x, g, dx: contiguous (n, d);
// w: contiguous fp32 (d,); partial: fp32 scratch (n_blocks, 2, d); dw, db:
// fp32 (d,).  Block i takes rows [i * rows_per_block, (i + 1) *
// rows_per_block) of n.
extern "C" int hero_layer_norm_bwd(int dtype, const void* x, const void* w,
                                   const void* g, void* dx, void* partial,
                                   void* dw, void* db, long long n, int d,
                                   int n_blocks, int rows_per_block,
                                   float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  float* pw = static_cast<float*>(dw);
  float* pb = static_cast<float*>(db);
  cudaError_t e;
  switch (dtype) {
    case kFloat32:
      e = launch_bwd<float>(x, w, g, dx, pp, pw, pb, n, d, n_blocks,
                            rows_per_block, eps, s);
      break;
    case kBFloat16:
      e = launch_bwd<__nv_bfloat16>(x, w, g, dx, pp, pw, pb, n, d, n_blocks,
                                    rows_per_block, eps, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Fused dropout + add + LayerNorm forward.  Returns a cudaError_t code
// (0 = launched).  y, x, out: contiguous (n, d) of one dtype; w, b:
// contiguous fp32 (d,); rate 0 draws nothing.
extern "C" int hero_daln_fwd(int dtype, const void* y, const void* x,
                             const void* w, const void* b, void* out,
                             long long n, int d, float eps, float rate,
                             float keep_scale, unsigned int seed_lo,
                             unsigned int seed_hi, void* stream) {
  DalnArgs a{};
  a.y = y;
  a.x = x;
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.out = out;
  a.n = n;
  a.d = d;
  a.eps = eps;
  a.rate = rate;
  a.keep_scale = keep_scale;
  a.key = PhiloxKey{seed_lo, seed_hi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kFloat32: e = launch_daln_fwd<float>(a, s); break;
    case kBFloat16: e = launch_daln_fwd<__nv_bfloat16>(a, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Its backward.  Returns a cudaError_t code (0 = launched).  y, x, g, dy,
// dx: contiguous (n, d) of one dtype; w: contiguous fp32 (d,); partial:
// fp32 scratch (n_blocks, 2, d); dw, db: fp32 (d,).  Block i takes rows
// [i * rows_per_block, (i + 1) * rows_per_block) of n.
extern "C" int hero_daln_bwd(int dtype, const void* y, const void* x,
                             const void* w, const void* g, void* dy, void* dx,
                             void* partial, void* dw, void* db, long long n,
                             int d, int n_blocks, int rows_per_block,
                             float eps, float rate, float keep_scale,
                             unsigned int seed_lo, unsigned int seed_hi,
                             void* stream) {
  DalnArgs a{};
  a.y = y;
  a.x = x;
  a.w = static_cast<const float*>(w);
  a.g = g;
  a.dy = dy;
  a.dx = dx;
  a.partial = static_cast<float*>(partial);
  a.n = n;
  a.d = d;
  a.rows_per_block = rows_per_block;
  a.eps = eps;
  a.rate = rate;
  a.keep_scale = keep_scale;
  a.key = PhiloxKey{seed_lo, seed_hi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pw = static_cast<float*>(dw);
  float* pb = static_cast<float*>(db);
  cudaError_t e;
  switch (dtype) {
    case kFloat32: e = launch_daln_bwd<float>(a, n_blocks, pw, pb, s); break;
    case kBFloat16:
      e = launch_daln_bwd<__nv_bfloat16>(a, n_blocks, pw, pb, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
