// Row LayerNorm: forward, and the backward in two passes.
//
// Forward.  Replaces the Pallas kernel hero_tpu/ops/layernorm.py _fwd_kernel
// (:53), reached through _fused_layer_norm / layer_norm.  Per row of x (n, d):
//   mean = sum(x) / d;  var = sum((x - mean)^2) / d   (two-pass, fp32)
//   y = (x - mean) * rsqrt(var + eps) * w + b         (fp32 w, b)
// rounded once to the input type (fp32 or bf16).
//
// Backward.  Replaces _bwd_kernel (hero_tpu/ops/layernorm.py:64, pallas_call
// at :128).  It recomputes each row's statistics and gives
//   dx = rstd * (g w - mean(g w) - xhat * mean(g w xhat)),
//   dw = sum over rows of g xhat,   db = sum over rows of g   (fp32).
// The TPU kernel adds dw/db into one output block across its sequential
// grid; blocks on the card run in no order, and atomics would make the
// sums differ from run to run.  So the row pass gives each block a fixed
// group of rows (the wrapper's partition, a function of n alone) and
// writes that group's partial dw/db, and the column pass reduces the
// partials in group order.  The grads are the same from run to run.
//
// Bound on the H100: ~8 (forward) and ~12 (backward) fp32 operations per
// element against 2 and 3 elements moved, so memory-bound at every width;
// what counts is bytes moved and bytes in flight.  Design (both kernels):
//   - each row is read from device memory once, with 16-byte accesses (8
//     bf16 or 4 fp32; one element where the width or a pointer does not
//     allow it), by a "slot" of warps: in the forward one warp at d =
//     768 (three accesses a lane) and six at d = 4352, in the backward
//     two and nine, up to 16 at the widest rows;
//   - a slot walks its rows through a ring of three rows in shared
//     memory, filled by cp.async: the next two rows' loads are in flight
//     while this row is reduced and stored; each pass over the row reads
//     the ring again, so registers hold only sums;
//   - sums are warp shuffles plus, where a row spans several warps, one
//     exchange through shared memory under the slot's own named barrier,
//     summed in warp order.  The forward takes the mean, then the centred
//     variance; the backward takes (sum x, sum g w) as one pair, then
//     (sum (x - mean)^2, sum g w (x - mean)) as another, which gives
//     mean(g w xhat) = rstd * mean(g w (x - mean)), then dx: three passes
//     and two exchanges a row;
//   - backward: each thread owns fixed columns and sums g xhat and g over
//     its rows in row order in registers; a block's slots combine in slot
//     order through shared memory, and the block writes one (2, d)
//     partial.  The wrapper takes two groups an SM (LN_BWD_GROUPS), so
//     the partials are a few MB, and the column pass spreads them over a
//     block per 32 columns.
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
// and the LayerNorm backward's column pass, so the grads are the same from
// run to run.  Bound: memory, as the LayerNorm kernels (two inputs read
// and one output written forward; y, x, g read and dy, dx written
// backward); the Philox draw (10 rounds of two 32-bit multiplies a
// kept-or-dropped element) runs on the CUDA cores beside the loads.
// Design: a row a block in the forward, a fixed run of rows a block in
// the backward, the row in shared memory as fp32.
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// row LayerNorm: rows in registers, fed through a shared-memory ring
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 512;          // a block: <= 16 warps
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kStages = 3;                // rows a slot has in its ring

// One access of VEC elements of T: 16 bytes, or a single element.
template <typename T, int VEC> struct Vec;

template <> struct Vec<__nv_bfloat16, 8> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float get(int k) const {
    const unsigned w = (&u.x)[k >> 1];
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    uint4 o;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k]));
      const unsigned hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k + 1]));
      (&o.x)[k] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = o;
  }
};

template <> struct Vec<float, 4> {
  uint4 u;
  __device__ __forceinline__ void load(const float* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float get(int k) const {
    return __uint_as_float((&u.x)[k]);
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename T> struct Vec<T, 1> {
  T u;
  __device__ __forceinline__ void load(const T* p) { u = *p; }
  __device__ __forceinline__ float get(int) const { return to_float(u); }
  __device__ __forceinline__ static void store(T* p, const float* f) {
    *p = from_float<T>(f[0]);
  }
};

// VEC consecutive fp32 values (w, b, partial dw/db): float4 accesses where
// VEC allows (the plan takes VEC > 1 only for 16-byte aligned pointers and
// widths a multiple of VEC).
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* f) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
      f[4 * q] = v.x;
      f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z;
      f[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = __ldg(p + k);
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* f) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = f[k];
  }
}

__device__ __forceinline__ void cp_async16(uint4* smem, const uint4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Sums over the threads of one row (a "slot": wpr warps of the block).
// Warp shuffles, then, where the row spans several warps, one exchange
// through shared memory under the slot's own named barrier, read in warp
// order.  ``red`` has two buffers used in turn, so a sum never overwrites
// values that a warp of the row may still be reading for the one before.
struct RowSum {
  float* red;  // [2 buffers][2 values][kMaxWarps]
  int slot, wpr, warp, lane, buf;

  __device__ __forceinline__ float2 pair(float a, float b) {
    a = warp_sum(a);
    b = warp_sum(b);
    if (wpr == 1) return make_float2(a, b);
    float* r = red + buf * 2 * kMaxWarps;
    const int base = slot * wpr;
    if (lane == 0) {
      r[base + warp] = a;
      r[kMaxWarps + base + warp] = b;
    }
    asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(wpr * 32)
                 : "memory");
    a = 0.f;
    b = 0.f;
    for (int i = 0; i < wpr; ++i) {
      a += r[base + i];
      b += r[kMaxWarps + base + i];
    }
    buf ^= 1;
    return make_float2(a, b);
  }

  __device__ __forceinline__ float one(float a) {
    a = warp_sum(a);
    if (wpr == 1) return a;
    float* r = red + buf * 2 * kMaxWarps;
    const int base = slot * wpr;
    if (lane == 0) r[base + warp] = a;
    asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(wpr * 32)
                 : "memory");
    a = 0.f;
    for (int i = 0; i < wpr; ++i) a += r[base + i];
    buf ^= 1;
    return a;
  }
};

__device__ __forceinline__ RowSum row_sum_for(float* red, int tpr) {
  const int slot = threadIdx.x / tpr;
  const int t = threadIdx.x - slot * tpr;
  return RowSum{red, slot, tpr >> 5, t >> 5,
                static_cast<int>(threadIdx.x & 31), 0};
}

// The rows of one slot, rows first, first + step, ... (cnt of them), of M
// (n, d) tensors, each thread's accesses j = t + k * tpr (k < NV, j <
// nvec).  With S > 1 (16-byte accesses), row i + S - 1 is copied by
// cp.async into stage (i + S - 1) % S of the slot's ring while row i is
// reduced and stored, so S - 1 rows stay in flight, and each pass over
// row i reads its stage again (registers hold only the sums); each thread
// reads back only the vectors it copied, so the ring needs no barrier.
// With S == 1 a row is loaded into registers when it is needed.
template <typename T, int VEC, int NV, int S, int M>
struct RowPipe {
  static_assert(S == 1 || VEC * sizeof(T) == 16, "the ring moves 16 bytes");
  uint4* ring;  // [S][M][NV][tpr]
  const T* src[M];
  long long first, step, cnt;
  int d, t, tpr, nvec;
  const uint4* cur;                                 // S > 1: row i's stage
  Vec<T, VEC> reg[S > 1 ? 1 : M][S > 1 ? 1 : NV];   // S == 1: row i

  __device__ __forceinline__ void issue(long long i) {
    if constexpr (S > 1) {
      if (i < cnt) {
        const long long r = first + i * step;
        uint4* st = ring + static_cast<int>(i % S) * (M * NV) * tpr;
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const int j = t + k * tpr;
            if (j < nvec)
              cp_async16(st + (m * NV + k) * tpr + t,
                         reinterpret_cast<const uint4*>(src[m] + r * d) + j);
          }
      }
      cp_async_commit();
    }
  }

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) issue(s);
  }

  // Makes row i current.
  __device__ __forceinline__ void fetch(long long i) {
    if constexpr (S > 1) {
      issue(i + S - 1);
      cp_async_wait<S - 1>();
      cur = ring + static_cast<int>(i % S) * (M * NV) * tpr;
    } else {
      const long long r = first + i * step;
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int j = t + k * tpr;
          if (j < nvec)
            reg[m][k].load(src[m] + r * d + static_cast<long long>(j) * VEC);
        }
    }
  }

  // Access k of tensor m of the current row (for j = t + k * tpr < nvec).
  __device__ __forceinline__ Vec<T, VEC> at(int m, int k) const {
    if constexpr (S > 1) {
      Vec<T, VEC> a;
      a.u = cur[(m * NV + k) * tpr + t];
      return a;
    } else {
      return reg[m][k];
    }
  }
};

// How a width is laid out on threads: VEC elements an access, NV accesses
// a thread (a compile-time count, masked past the row's end), wpr warps a
// row, ``slots`` rows a block.  A function of (d, dtype, alignment) only.
struct RowPlan {
  int vec, nv, wpr, slots;
};

// About ``per_warp`` accesses a warp, at most kMaxWarps warps a row.  The
// forward takes 96 (three a lane: one warp a row at d = 768 in bf16, six
// at 4352), the backward 64 (two warps at 768, nine at 4352): its rows
// carry more work a row, which more warps share (measured on the H100,
// PERF.md).
template <typename T>
RowPlan plan_rows(int d, bool aligned, int per_warp) {
  constexpr int kVec = 16 / sizeof(T);
  RowPlan p;
  p.vec = (aligned && d % kVec == 0) ? kVec : 1;
  const int nvec = d / p.vec;
  p.wpr = min(kMaxWarps, (nvec + per_warp - 1) / per_warp);
  const int nv = (nvec + 32 * p.wpr - 1) / (32 * p.wpr);
  p.nv = nv <= 4 ? nv : nv <= 8 ? 8 : nv <= 16 ? 16 : 32;
  p.slots = max(1, 8 / p.wpr);
  return p;
}

// The ring's depth for an instance: 16-byte accesses up to three a thread
// (every width up to 12288 bf16 / 6144 fp32); wider rows and
// single-element accesses load straight into registers.
template <int VEC, int NV>
__host__ __device__ constexpr int stages() {
  return VEC > 1 && NV <= 3 ? kStages : 1;
}

// Forward: a slot of wpr warps per row, rows in a grid-stride loop.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ y,
                       long long n, int d, int wpr, float eps) {
  constexpr int S = stages<VEC, NV>();
  extern __shared__ uint4 ring[];  // [slots][S][NV][tpr] when S > 1
  __shared__ float red[2 * 2 * kMaxWarps];
  const int tpr = wpr * 32;
  const int slots = blockDim.x / tpr;
  RowSum rs = row_sum_for(red, tpr);
  const int t = threadIdx.x - rs.slot * tpr;
  const int nvec = d / VEC;
  const float fd = static_cast<float>(d);
  const long long step = static_cast<long long>(gridDim.x) * slots;
  const long long first = static_cast<long long>(blockIdx.x) * slots + rs.slot;
  RowPipe<T, VEC, NV, S, 1> pipe{ring + rs.slot * S * NV * tpr, {x}, first,
                                 step, first < n ? (n - 1 - first) / step + 1
                                                 : 0,
                                 d, t, tpr, nvec};
  pipe.start();
  for (long long i = 0; i < pipe.cnt; ++i) {
    pipe.fetch(i);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (t + k * tpr < nvec) {
        const Vec<T, VEC> a = pipe.at(0, k);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += a.get(e);
      }
    const float mean = rs.one(s) / fd;
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (t + k * tpr < nvec) {
        const Vec<T, VEC> a = pipe.at(0, k);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float c = a.get(e) - mean;
          s2 += c * c;
        }
      }
    const float rstd = rsqrtf(rs.one(s2) / fd + eps);
    T* yr = y + (first + i * step) * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = t + k * tpr;
      if (j < nvec) {
        const Vec<T, VEC> a = pipe.at(0, k);
        float wf[VEC], bf[VEC], o[VEC];
        load_f32<VEC>(w + j * VEC, wf);
        load_f32<VEC>(bias + j * VEC, bf);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[e] = (a.get(e) - mean) * rstd * wf[e] + bf[e];
        Vec<T, VEC>::store(yr + static_cast<long long>(j) * VEC, o);
      }
    }
  }
}

// Backward row pass: block i takes rows [i * rows_per_group, (i + 1) *
// rows_per_group) of n; slot s of the block takes rows r0 + s, r0 + s +
// slots, ...; each thread sums g xhat and g for its columns over its rows
// in row order; the slots combine in slot order and the block writes its
// (2, d) partial [dw; db].
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_bwd_rows_kernel(const T* __restrict__ x,
                           const float* __restrict__ w,
                           const T* __restrict__ g, T* __restrict__ dx,
                           float* __restrict__ partial, long long n, int d,
                           int wpr, int rows_per_group, float eps) {
  constexpr int S = stages<VEC, NV>();
  // [slots][S][2][NV][tpr] ring when S > 1, then [2 d] for the slots'
  // combine when the block has several slots
  extern __shared__ uint4 dyn[];
  __shared__ float red[2 * 2 * kMaxWarps];
  const int tpr = wpr * 32;
  const int slots = blockDim.x / tpr;
  RowSum rs = row_sum_for(red, tpr);
  const int t = threadIdx.x - rs.slot * tpr;
  const int nvec = d / VEC;
  const float inv_d = 1.f / static_cast<float>(d);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_group;
  const long long r1 = min(r0 + rows_per_group, n);
  const long long first = r0 + rs.slot;
  RowPipe<T, VEC, NV, S, 2> pipe{
      dyn + rs.slot * S * 2 * NV * tpr, {x, g}, first, slots,
      first < r1 ? (r1 - 1 - first) / slots + 1 : 0, d, t, tpr, nvec};
  float aw[NV][VEC], ab[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      aw[k][e] = 0.f;
      ab[k][e] = 0.f;
    }
  pipe.start();
  for (long long i = 0; i < pipe.cnt; ++i) {
    pipe.fetch(i);
    // pass 1: sum x and sum g w; pass 2: the centred sum of squares and
    // sum g w (x - mean), so mean(g w xhat) = rstd * that / d; pass 3: dx
    // and the partial sums.  g w is rounded once (no fused multiply-add),
    // as the plain version's, so g w - mean(g w) is exact where they agree.
    float s = 0.f, m1 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = t + k * tpr;
      if (j < nvec) {
        const Vec<T, VEC> a = pipe.at(0, k), b = pipe.at(1, k);
        float wf[VEC];
        load_f32<VEC>(w + j * VEC, wf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          s += a.get(e);
          m1 += __fmul_rn(b.get(e), wf[e]);
        }
      }
    }
    float2 m = rs.pair(s, m1);
    const float mean = m.x * inv_d;
    m1 = m.y * inv_d;
    float s2 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = t + k * tpr;
      if (j < nvec) {
        const Vec<T, VEC> a = pipe.at(0, k), b = pipe.at(1, k);
        float wf[VEC];
        load_f32<VEC>(w + j * VEC, wf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float c = a.get(e) - mean;
          s2 += c * c;
          m2 += __fmul_rn(b.get(e), wf[e]) * c;
        }
      }
    }
    m = rs.pair(s2, m2);
    const float rstd = rsqrtf(m.x * inv_d + eps);
    m2 = m.y * rstd * inv_d;
    T* dxr = dx + (first + i * slots) * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = t + k * tpr;
      if (j < nvec) {
        const Vec<T, VEC> a = pipe.at(0, k), b = pipe.at(1, k);
        float wf[VEC], o[VEC];
        load_f32<VEC>(w + j * VEC, wf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = (a.get(e) - mean) * rstd;
          const float gv = b.get(e);
          const float gw = __fmul_rn(gv, wf[e]);
          o[e] = rstd * (gw - m1 - xh * m2);
          aw[k][e] += gv * xh;
          ab[k][e] += gv;
        }
        Vec<T, VEC>::store(dxr + static_cast<long long>(j) * VEC, o);
      }
    }
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * d;
  if (slots == 1) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = t + k * tpr;
      if (j < nvec) {
        store_f32<VEC>(out + j * VEC, aw[k]);
        store_f32<VEC>(out + d + j * VEC, ab[k]);
      }
    }
    return;
  }
  float* comb =
      reinterpret_cast<float*>(dyn + (S > 1 ? slots * S * 2 * NV * tpr : 0));
  for (int s = 0; s < slots; ++s) {
    if (rs.slot == s) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int j = t + k * tpr;
        if (j < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int c = j * VEC + e;
            comb[c] = s ? comb[c] + aw[k][e] : aw[k][e];
            comb[d + c] = s ? comb[d + c] + ab[k][e] : ab[k][e];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * d; i += blockDim.x) out[i] = comb[i];
}

// Column pass: dw[c] = sum_p partial[p][0][c], db[c] = sum_p
// partial[p][1][c].  A block takes 32 of the 2d columns; warp i sums parts
// i, i + 16, ... in order, and the 16 warp sums are added in warp order.
constexpr int kColWarps = 16;

__global__ void __launch_bounds__(kColWarps * 32)
layer_norm_bwd_cols_kernel(const float* __restrict__ partial, int n_parts,
                           int d, float* __restrict__ dw,
                           float* __restrict__ db) {
  __shared__ float part[kColWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long cols = 2LL * d;
  const long long c = static_cast<long long>(blockIdx.x) * 32 + lane;
  float s = 0.f;
  if (c < cols) {
#pragma unroll 4
    for (int p = warp; p < n_parts; p += kColWarps)
      s += __ldg(partial + p * cols + c);
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < cols) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < kColWarps; ++i) tot += part[i][lane];
    if (c < d)
      dw[c] = tot;
    else
      db[c - d] = tot;
  }
}

cudaError_t launch_cols(const float* partial, int n_parts, int d, float* dw,
                        float* db, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((2LL * d + 31) / 32);
  layer_norm_bwd_cols_kernel<<<blocks, kColWarps * 32, 0, stream>>>(
      partial, n_parts, d, dw, db);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Lets ``kernel`` take ``smem`` bytes of dynamic shared memory (beside its
// static shared memory, past the default 48 KB in all); ``granted``
// remembers what was set.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, int* granted) {
  if (static_cast<int>(smem) <= *granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) *granted = static_cast<int>(smem);
  return e;
}

template <typename T, int VEC, int NV>
cudaError_t launch_fwd(const RowPlan& p, const void* x, const void* w,
                       const void* b, void* y, long long n, int d, float eps,
                       cudaStream_t stream) {
  constexpr int S = stages<VEC, NV>();
  auto kernel = layer_norm_rows_kernel<T, VEC, NV>;
  // blocks the card holds at once, by the plan's warps a row (the block
  // size and shared memory follow from it): the grid of the
  // grid-stride loop
  static int resident[kMaxWarps + 1];
  static int granted;
  const int threads = p.slots * p.wpr * 32;
  const size_t smem = S > 1 ? sizeof(uint4) * S * NV * threads : 0;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  if (!resident[p.wpr]) {
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (e != cudaSuccess) return e;
    if (sms * per_sm == 0) return cudaErrorInvalidConfiguration;
    resident[p.wpr] = sms * per_sm;
  }
  const long long want = (n + p.slots - 1) / p.slots;
  const unsigned blocks = static_cast<unsigned>(
      want < resident[p.wpr] ? want : resident[p.wpr]);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), n, d, p.wpr, eps);
  return cudaGetLastError();
}

template <typename T, int VEC, int NV>
cudaError_t launch_bwd(const RowPlan& p, const void* x, const void* w,
                       const void* g, void* dx, float* partial, float* dw,
                       float* db, long long n, int d, int n_groups,
                       int rows_per_group, float eps, cudaStream_t stream) {
  constexpr int S = stages<VEC, NV>();
  auto kernel = layer_norm_bwd_rows_kernel<T, VEC, NV>;
  static int granted;
  const int threads = p.slots * p.wpr * 32;
  const size_t smem =
      (S > 1 ? sizeof(uint4) * S * 2 * NV * threads : 0) +
      (p.slots > 1 ? 2 * sizeof(float) * d : 0);
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  kernel<<<n_groups, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), partial, n, d, p.wpr,
      rows_per_group, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_cols(partial, n_groups, d, dw, db, stream);
}

// The plan's NV as a template argument: 1-4 and 8 for 16-byte accesses,
// up to 32 for single elements (the widest rows of widths that are not a
// multiple of the vector).
template <typename T, int VEC, typename F>
cudaError_t with_nv(int nv, F&& f) {
  switch (nv) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    default: break;
  }
  if constexpr (VEC == 1) {
    if (nv == 16) return f(std::integral_constant<int, 16>());
    if (nv == 32) return f(std::integral_constant<int, 32>());
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t layer_norm_fwd(const void* x, const void* w, const void* b,
                           void* y, long long n, int d, float eps,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const RowPlan p = plan_rows<T>(
      d, aligned16(x) && aligned16(w) && aligned16(b) && aligned16(y), 96);
  if (p.vec == kVec)
    return with_nv<T, kVec>(p.nv, [&](auto nv) {
      return launch_fwd<T, kVec, decltype(nv)::value>(p, x, w, b, y, n, d,
                                                       eps, stream);
    });
  return with_nv<T, 1>(p.nv, [&](auto nv) {
    return launch_fwd<T, 1, decltype(nv)::value>(p, x, w, b, y, n, d, eps,
                                                  stream);
  });
}

template <typename T>
cudaError_t layer_norm_bwd(const void* x, const void* w, const void* g,
                           void* dx, float* partial, float* dw, float* db,
                           long long n, int d, int n_groups,
                           int rows_per_group, float eps,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const RowPlan p = plan_rows<T>(
      d, aligned16(x) && aligned16(w) && aligned16(g) && aligned16(dx) &&
             aligned16(partial),
      64);
  if (p.vec == kVec)
    return with_nv<T, kVec>(p.nv, [&](auto nv) {
      return launch_bwd<T, kVec, decltype(nv)::value>(
          p, x, w, g, dx, partial, dw, db, n, d, n_groups, rows_per_group,
          eps, stream);
    });
  return with_nv<T, 1>(p.nv, [&](auto nv) {
    return launch_bwd<T, 1, decltype(nv)::value>(
        p, x, w, g, dx, partial, dw, db, n, d, n_groups, rows_per_group, eps,
        stream);
  });
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
  return launch_cols(a.partial, n_blocks, a.d, dw, db, stream);
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  x, y: contiguous (n, d);
// w, b: contiguous fp32 (d,).  16-byte accesses need every pointer 16-byte
// aligned and d a multiple of 16 bytes' worth of elements; otherwise the
// kernel reads one element an access.
extern "C" int hero_layer_norm_fwd(int dtype, const void* x, const void* w,
                                   const void* b, void* y, long long n, int d,
                                   float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kFloat32: e = layer_norm_fwd<float>(x, w, b, y, n, d, eps, s); break;
    case kBFloat16:
      e = layer_norm_fwd<__nv_bfloat16>(x, w, b, y, n, d, eps, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Returns a cudaError_t code (0 = launched).  x, g, dx: contiguous (n, d);
// w: contiguous fp32 (d,); partial: fp32 scratch (n_blocks, 2, d); dw, db:
// fp32 (d,).  Block i takes rows [i * rows_per_block, (i + 1) *
// rows_per_block) of n and writes partial[i]; the column pass sums the
// n_blocks partials in block order.  Access width as the forward's.
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
      e = layer_norm_bwd<float>(x, w, g, dx, pp, pw, pb, n, d, n_blocks,
                                rows_per_block, eps, s);
      break;
    case kBFloat16:
      e = layer_norm_bwd<__nv_bfloat16>(x, w, g, dx, pp, pw, pb, n, d,
                                        n_blocks, rows_per_block, eps, s);
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
