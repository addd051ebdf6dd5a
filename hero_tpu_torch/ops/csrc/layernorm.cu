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
// Fused dropout + residual add + LayerNorm, forward and backward.
// Replaces the Pallas kernels _daln_fwd_kernel (hero_tpu/ops/layernorm.py
// :175, pallas_call at :257) and _daln_bwd_kernel (:195, pallas_call at
// :277), reached through dropout_add_layer_norm.  Per row of y, x (n, d):
//   s = drop(y) + x   (fp32; drop(y) = keep ? y / (1 - r) : 0)
//   out = LN(s) * w + b, rounded once to the input type,
// and the backward, from the same keep bits and the recomputed statistics
// of s:
//   ds = rstd * (g w - mean(g w) - shat * mean(g w shat)),
//   dx = ds,  dy = keep ? ds / (1 - r) : 0,
//   dw = sum over rows of g shat,  db = sum over rows of g.
// The TPU kernel draws its bits per row block from the TPU PRNG and adds
// dw/db into one block across its sequential grid; here the bits are a
// function of (seed, row, col): element (row, col) takes word col & 3 of
// Philox4x32-10 at counter (col >> 2, row lo, row hi, 0xFFFFFFFF)
// (philox.cuh row_keep4), one call per four columns.  Bound: memory (y,
// x read and out written forward; y, x, g read and dy, dx written
// backward); the draw, ~80 integer operations a call, is the largest
// arithmetic cost.  They are the LayerNorm kernels above with a fused
// mode (ADD): the ring carries y beside x (and g), each pass forms s from
// the ring, and the keep bits of a thread's columns are drawn once a row,
// before the row's loads are waited for, and kept in a register bitmask
// through the passes and the dy store; the backward's dw/db partials go
// through the same column pass.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "philox.cuh"

namespace {

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
// (n, d) tensors (src[0 .. M)), each thread's accesses j = t + k * tpr
// (k < NV, j < nvec).  With S > 1 (16-byte accesses), row i + S - 1 is
// copied by cp.async into stage (i + S - 1) % S of the slot's ring while
// row i is reduced and stored, so S - 1 rows stay in flight, and each
// pass over row i reads its stage again (registers hold only the sums);
// each thread reads back only the vectors it copied, so the ring needs no
// barrier.
// With S == 1 a row is loaded into registers when it is needed.
template <typename T, int VEC, int NV, int S, int M>
struct RowPipe {
  static_assert(S == 1 || VEC * sizeof(T) == 16, "the ring moves 16 bytes");
  uint4* ring;  // [S][M][NV][tpr]
  const T* src[3];
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

// The fused mode's dropout: drop(y) = keep ? y * scale : 0, keep from
// row_keep4 with thr = ceil(rate * 2^24) << 8.
struct Dropout {
  float rate, scale;
  PhiloxKey key;
  uint32_t thr;
};

Dropout make_dropout(float rate, float scale, unsigned int seed_lo,
                     unsigned int seed_hi) {
  return Dropout{rate, scale, PhiloxKey{seed_lo, seed_hi},
                 static_cast<uint32_t>(ceilf(rate * 16777216.0f)) << 8};
}

// Keep bits of access j (VEC elements from column j * VEC) of row r: bit
// e for column j * VEC + e.  One Philox call per four columns; a
// single-element access takes its own word of its quad's call.
template <int VEC>
__device__ __forceinline__ uint32_t keep_bits(const Dropout& dp, long long r,
                                              int j) {
  if constexpr (VEC == 1) {
    return row_keep4(dp.key, r, j >> 2, dp.thr) >> (j & 3) & 1u;
  } else {
    static_assert(VEC % 4 == 0, "an access covers whole quads");
    uint32_t m = 0;
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      m |= row_keep4(dp.key, r, j * (VEC / 4) + q, dp.thr) << (4 * q);
    return m;
  }
}

// The keep bits of a thread's accesses to row r, drawn once a row: every
// bit set at rate 0 (drop(y) = y * 1 = y) and outside the fused mode.
template <bool ADD, int VEC, int NV>
__device__ __forceinline__ void draw_row(const Dropout& dp, long long r,
                                         int t, int tpr, int nvec,
                                         uint32_t (&kb)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = t + k * tpr;
    kb[k] = 0xFFu;
    if constexpr (ADD) {
      if (dp.rate > 0.f && j < nvec) kb[k] = keep_bits<VEC>(dp, r, j);
    }
  }
}

// The values of access k of the current row: x, or in the fused mode
// drop(y) + x in fp32, rounded as the plain version rounds it (y * scale,
// then + x, no fused multiply-add), so s is bit for bit the plain s.  y is
// the pipe's last tensor.
template <bool ADD, typename T, int VEC, int NV, int S, int M>
__device__ __forceinline__ void row_values(
    const RowPipe<T, VEC, NV, S, M>& pipe, int k, uint32_t kb, float scale,
    float (&v)[VEC]) {
  const Vec<T, VEC> a = pipe.at(0, k);
  if constexpr (ADD) {
    const Vec<T, VEC> y = pipe.at(M - 1, k);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      v[e] = __fadd_rn((kb >> e) & 1u ? __fmul_rn(y.get(e), scale) : 0.f,
                       a.get(e));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = a.get(e);
  }
}

// Forward: a slot of wpr warps per row, rows in a grid-stride loop.  The
// pipe carries x, and y after it in the fused mode (ADD).
template <typename T, int VEC, int NV, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_rows_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const float* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ out,
                       long long n, int d, int wpr, float eps, Dropout dp) {
  constexpr int S = stages<VEC, NV>();
  constexpr int M = ADD ? 2 : 1;
  extern __shared__ uint4 ring[];  // [slots][S][M][NV][tpr] when S > 1
  __shared__ float red[2 * 2 * kMaxWarps];
  const int tpr = wpr * 32;
  const int slots = blockDim.x / tpr;
  RowSum rs = row_sum_for(red, tpr);
  const int t = threadIdx.x - rs.slot * tpr;
  const int nvec = d / VEC;
  const float fd = static_cast<float>(d);
  const long long step = static_cast<long long>(gridDim.x) * slots;
  const long long first = static_cast<long long>(blockIdx.x) * slots + rs.slot;
  RowPipe<T, VEC, NV, S, M> pipe{ring + rs.slot * S * M * NV * tpr, {x, y},
                                 first, step,
                                 first < n ? (n - 1 - first) / step + 1 : 0,
                                 d, t, tpr, nvec};
  pipe.start();
  for (long long i = 0; i < pipe.cnt; ++i) {
    const long long r = first + i * step;
    uint32_t kb[NV];
    draw_row<ADD, VEC, NV>(dp, r, t, tpr, nvec, kb);
    pipe.fetch(i);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (t + k * tpr < nvec) {
        float v[VEC];
        row_values<ADD>(pipe, k, kb[k], dp.scale, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += v[e];
      }
    const float mean = rs.one(s) / fd;
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (t + k * tpr < nvec) {
        float v[VEC];
        row_values<ADD>(pipe, k, kb[k], dp.scale, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float c = v[e] - mean;
          s2 += c * c;
        }
      }
    const float rstd = rsqrtf(rs.one(s2) / fd + eps);
    T* orow = out + r * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = t + k * tpr;
      if (j < nvec) {
        float v[VEC], wf[VEC], bf[VEC], o[VEC];
        row_values<ADD>(pipe, k, kb[k], dp.scale, v);
        load_f32<VEC>(w + j * VEC, wf);
        load_f32<VEC>(bias + j * VEC, bf);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[e] = (v[e] - mean) * rstd * wf[e] + bf[e];
        Vec<T, VEC>::store(orow + static_cast<long long>(j) * VEC, o);
      }
    }
  }
}

// Backward row pass: block i takes rows [i * rows_per_group, (i + 1) *
// rows_per_group) of n; slot s of the block takes rows r0 + s, r0 + s +
// slots, ...; each thread sums g xhat and g for its columns over its rows
// in row order; the slots combine in slot order and the block writes its
// (2, d) partial [dw; db].  The pipe carries x and g, and y after them in
// the fused mode (ADD), which also writes dy.
template <typename T, int VEC, int NV, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ y,
                           const float* __restrict__ w,
                           const T* __restrict__ g, T* __restrict__ dx,
                           T* __restrict__ dy, float* __restrict__ partial,
                           long long n, int d, int wpr, int rows_per_group,
                           float eps, Dropout dp) {
  constexpr int S = stages<VEC, NV>();
  constexpr int M = ADD ? 3 : 2;
  // [slots][S][M][NV][tpr] ring when S > 1, then [2 d] for the slots'
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
  RowPipe<T, VEC, NV, S, M> pipe{
      dyn + rs.slot * S * M * NV * tpr, {x, g, y}, first, slots,
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
    const long long r = first + i * slots;
    uint32_t kb[NV];
    draw_row<ADD, VEC, NV>(dp, r, t, tpr, nvec, kb);
    pipe.fetch(i);
    // pass 1: sum x and sum g w; pass 2: the centred sum of squares and
    // sum g w (x - mean), so mean(g w xhat) = rstd * that / d; pass 3: dx
    // (and dy) and the partial sums.  g w is rounded once (no fused
    // multiply-add), as the plain version's, so g w - mean(g w) is exact
    // where they agree.  In the fused mode x stands for s = drop(y) + x.
    float s = 0.f, m1 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = t + k * tpr;
      if (j < nvec) {
        const Vec<T, VEC> b = pipe.at(1, k);
        float v[VEC], wf[VEC];
        row_values<ADD>(pipe, k, kb[k], dp.scale, v);
        load_f32<VEC>(w + j * VEC, wf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          s += v[e];
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
        const Vec<T, VEC> b = pipe.at(1, k);
        float v[VEC], wf[VEC];
        row_values<ADD>(pipe, k, kb[k], dp.scale, v);
        load_f32<VEC>(w + j * VEC, wf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float c = v[e] - mean;
          s2 += c * c;
          m2 += __fmul_rn(b.get(e), wf[e]) * c;
        }
      }
    }
    m = rs.pair(s2, m2);
    const float rstd = rsqrtf(m.x * inv_d + eps);
    m2 = m.y * rstd * inv_d;
    T* dxr = dx + r * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = t + k * tpr;
      if (j < nvec) {
        const Vec<T, VEC> b = pipe.at(1, k);
        float v[VEC], wf[VEC], o[VEC];
        row_values<ADD>(pipe, k, kb[k], dp.scale, v);
        load_f32<VEC>(w + j * VEC, wf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = (v[e] - mean) * rstd;
          const float gv = b.get(e);
          const float gw = __fmul_rn(gv, wf[e]);
          o[e] = rstd * (gw - m1 - xh * m2);
          aw[k][e] += gv * xh;
          ab[k][e] += gv;
        }
        Vec<T, VEC>::store(dxr + static_cast<long long>(j) * VEC, o);
        if constexpr (ADD) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            o[e] = (kb[k] >> e) & 1u ? __fmul_rn(o[e], dp.scale) : 0.f;
          Vec<T, VEC>::store(dy + r * d + static_cast<long long>(j) * VEC,
                             o);
        }
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
      reinterpret_cast<float*>(dyn + (S > 1 ? slots * S * M * NV * tpr : 0));
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

// The tensors and scalars of one call: x, w, b, out (forward); x, w, g,
// dx, partial, dw, db (backward); y and dy in the fused mode.
struct RowArgs {
  const void *x, *y, *w, *b, *g;
  void *out, *dx, *dy;
  float *partial, *dw, *db;
  long long n;
  int d, n_groups, rows_per_group;
  float eps;
  Dropout dp;
};

template <typename T, int VEC, int NV, bool ADD>
cudaError_t launch_fwd(const RowPlan& p, const RowArgs& a,
                       cudaStream_t stream) {
  constexpr int S = stages<VEC, NV>();
  constexpr int M = ADD ? 2 : 1;
  auto kernel = layer_norm_rows_kernel<T, VEC, NV, ADD>;
  // blocks the card holds at once, by the plan's warps a row (the block
  // size and shared memory follow from it): the grid of the
  // grid-stride loop
  static int resident[kMaxWarps + 1];
  static int granted;
  const int threads = p.slots * p.wpr * 32;
  const size_t smem = S > 1 ? sizeof(uint4) * S * M * NV * threads : 0;
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
  const long long want = (a.n + p.slots - 1) / p.slots;
  const unsigned blocks = static_cast<unsigned>(
      want < resident[p.wpr] ? want : resident[p.wpr]);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.y),
      static_cast<const float*>(a.w), static_cast<const float*>(a.b),
      static_cast<T*>(a.out), a.n, a.d, p.wpr, a.eps, a.dp);
  return cudaGetLastError();
}

template <typename T, int VEC, int NV, bool ADD>
cudaError_t launch_bwd(const RowPlan& p, const RowArgs& a,
                       cudaStream_t stream) {
  constexpr int S = stages<VEC, NV>();
  constexpr int M = ADD ? 3 : 2;
  auto kernel = layer_norm_bwd_rows_kernel<T, VEC, NV, ADD>;
  static int granted;
  const int threads = p.slots * p.wpr * 32;
  const size_t smem =
      (S > 1 ? sizeof(uint4) * S * M * NV * threads : 0) +
      (p.slots > 1 ? 2 * sizeof(float) * a.d : 0);
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  kernel<<<a.n_groups, threads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.y),
      static_cast<const float*>(a.w), static_cast<const T*>(a.g),
      static_cast<T*>(a.dx), static_cast<T*>(a.dy), a.partial, a.n, a.d,
      p.wpr, a.rows_per_group, a.eps, a.dp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_cols(a.partial, a.n_groups, a.d, a.dw, a.db, stream);
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

// 16-byte accesses need every pointer 16-byte aligned (null ones, which
// the call does not use, pass) and d a multiple of 16 bytes' worth of
// elements; otherwise one element an access.  The forward takes about 96
// accesses a warp, the backward 64 (plan_rows).
template <typename T, bool ADD>
cudaError_t layer_norm_fwd(const RowArgs& a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const RowPlan p = plan_rows<T>(
      a.d, aligned16(a.x) && aligned16(a.y) && aligned16(a.w) &&
               aligned16(a.b) && aligned16(a.out),
      96);
  if (p.vec == kVec)
    return with_nv<T, kVec>(p.nv, [&](auto nv) {
      return launch_fwd<T, kVec, decltype(nv)::value, ADD>(p, a, stream);
    });
  return with_nv<T, 1>(p.nv, [&](auto nv) {
    return launch_fwd<T, 1, decltype(nv)::value, ADD>(p, a, stream);
  });
}

template <typename T, bool ADD>
cudaError_t layer_norm_bwd(const RowArgs& a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const RowPlan p = plan_rows<T>(
      a.d, aligned16(a.x) && aligned16(a.y) && aligned16(a.w) &&
               aligned16(a.g) && aligned16(a.dx) && aligned16(a.dy) &&
               aligned16(a.partial),
      64);
  if (p.vec == kVec)
    return with_nv<T, kVec>(p.nv, [&](auto nv) {
      return launch_bwd<T, kVec, decltype(nv)::value, ADD>(p, a, stream);
    });
  return with_nv<T, 1>(p.nv, [&](auto nv) {
    return launch_bwd<T, 1, decltype(nv)::value, ADD>(p, a, stream);
  });
}

template <bool ADD>
int run_fwd(int dtype, const RowArgs& a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kFloat32: e = layer_norm_fwd<float, ADD>(a, s); break;
    case kBFloat16: e = layer_norm_fwd<__nv_bfloat16, ADD>(a, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

template <bool ADD>
int run_bwd(int dtype, const RowArgs& a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kFloat32: e = layer_norm_bwd<float, ADD>(a, s); break;
    case kBFloat16: e = layer_norm_bwd<__nv_bfloat16, ADD>(a, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  x, y: contiguous (n, d);
// w, b: contiguous fp32 (d,).
extern "C" int hero_layer_norm_fwd(int dtype, const void* x, const void* w,
                                   const void* b, void* y, long long n, int d,
                                   float eps, void* stream) {
  RowArgs a{};
  a.x = x;
  a.w = w;
  a.b = b;
  a.out = y;
  a.n = n;
  a.d = d;
  a.eps = eps;
  return run_fwd<false>(dtype, a, stream);
}

// Returns a cudaError_t code (0 = launched).  x, g, dx: contiguous (n, d);
// w: contiguous fp32 (d,); partial: fp32 scratch (n_blocks, 2, d); dw, db:
// fp32 (d,).  Block i takes rows [i * rows_per_block, (i + 1) *
// rows_per_block) of n and writes partial[i]; the column pass sums the
// n_blocks partials in block order.
extern "C" int hero_layer_norm_bwd(int dtype, const void* x, const void* w,
                                   const void* g, void* dx, void* partial,
                                   void* dw, void* db, long long n, int d,
                                   int n_blocks, int rows_per_block,
                                   float eps, void* stream) {
  RowArgs a{};
  a.x = x;
  a.w = w;
  a.g = g;
  a.dx = dx;
  a.partial = static_cast<float*>(partial);
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  a.n = n;
  a.d = d;
  a.n_groups = n_blocks;
  a.rows_per_group = rows_per_block;
  a.eps = eps;
  return run_bwd<false>(dtype, a, stream);
}

// Fused dropout + add + LayerNorm forward.  Returns a cudaError_t code
// (0 = launched).  y, x, out: contiguous (n, d) of one dtype; w, b:
// contiguous fp32 (d,); rate 0 draws nothing.
extern "C" int hero_daln_fwd(int dtype, const void* y, const void* x,
                             const void* w, const void* b, void* out,
                             long long n, int d, float eps, float rate,
                             float keep_scale, unsigned int seed_lo,
                             unsigned int seed_hi, void* stream) {
  RowArgs a{};
  a.x = x;
  a.y = y;
  a.w = w;
  a.b = b;
  a.out = out;
  a.n = n;
  a.d = d;
  a.eps = eps;
  a.dp = make_dropout(rate, keep_scale, seed_lo, seed_hi);
  return run_fwd<true>(dtype, a, stream);
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
  RowArgs a{};
  a.x = x;
  a.y = y;
  a.w = w;
  a.g = g;
  a.dx = dx;
  a.dy = dy;
  a.partial = static_cast<float*>(partial);
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  a.n = n;
  a.d = d;
  a.n_groups = n_blocks;
  a.rows_per_group = rows_per_block;
  a.eps = eps;
  a.dp = make_dropout(rate, keep_scale, seed_lo, seed_hi);
  return run_bwd<true>(dtype, a, stream);
}
