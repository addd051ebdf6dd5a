// Packed multi-head attention: forward (validity-mask and segment-mask
// modes, optional causal bias, probability dropout and saved
// probabilities) and the saved-probabilities backward; and the head-major
// (B, H, L, d) forward of the decode step (at the end of the file).
//
// Forward.  Replaces the Pallas kernels hero_tpu/ops/attention.py
// _fwd3_kernel (validity mask, :277) and _fwd3_seg_kernel (segment mask,
// :304), as reached through packed_attention.  It computes what
// mha_reference (hero_tpu/ops/attention.py:53) defines, with no key
// padding:
//   p[b, h, i, :] = softmax_j(q_i . k_j / sqrt(d) + bias_ij)
//   out[b, i, h] = sum_j drop(p_ij) v_j,  drop(p) = keep_ij ? p / (1 - r) : 0
// with bias 0 for an allowed key and an ADDITIVE -1e4 otherwise, so on a
// fully masked row the bias cancels in the softmax (never NaN; the row is
// the unmasked attention up to the rounding of s - 1e4).  Validity mode: key j
// allowed iff mask[b, j] == 1 (bias = (1 - mask) * -1e4).  Segment mode:
// allowed iff seg[b, j] == seg[b, i] and seg[b, i] >= 0 (-1 = pad slot);
// this is the one-hot seg . seg^T of the TPU kernel without the matmul.
// Validity mode may add the causal bias (the TVC decoder's self-attention):
// -1e4 more where j > i + (Lk - Lq), aligned by (Lk - Lq) as mha_reference
// defines it for every Lq and Lk, with nothing padded (the Pallas path pads
// both lengths to 64 and so takes its kernel only for Lq == Lk).
// keep_ij is the Philox bit of philox.cuh for (seed, b, h, i, j), the
// same bit the plain version (ops/dropout.py) and the backward draw.  When
// asked (training), the kernel writes the PRE-dropout p to a
// (B, H, Lq, Lk) tensor in the input type, as _fwd3_kernel does; serving
// passes no probability tensor and no rate, and does the work of the
// inference-only kernel.  Scores, softmax statistics and the
// probability-value products are fp32; q/k/v are read in their storage
// type (fp32 or bf16) and the output is rounded once to that type.
//
// Backward.  Replaces _bwd3_kernel (hero_tpu/ops/attention.py:342,
// pallas_call at :449), shared by both mask modes because the mask enters
// only through the saved p.  From p, q, k, v and do:
//   pd = drop(p)             dv = pd^T . do
//   dp = drop(do . v^T)      ds = p o (dp - rowsum(dp o p))
//   dq = ds . k * scale      dk = ds^T . q * scale
// with the dropout mask regenerated from the forward's seed.
//
// Layout: q/k/v/out (and do/dq/dk/dv) are the packed (B, L, H*d) tensors
// the fused QKV projection produces, addressed through batch and row
// strides (q, k and v are column slices of one (B, L, 3*H*d) tensor), so
// no head transposes.
//
// Bound on the H100: at the path's shapes (L <= 144, d = 64) a head's
// tiles fit in shared memory and the work is ~4*L^2*d flops (forward) or
// ~8*L^2*d (backward) per (row, head) against ~8*L*d bytes of q/k/v/out
// plus, in training, the 2*L^2 bytes of saved bf16 probabilities, so the
// ideal is memory-bound.  These first kernels do the products on the CUDA
// cores in fp32 (no wgmma yet).
//
// Forward design: one block per (batch row, head) stages K (padded to d+1
// floats per key, so lanes reading different keys hit different banks)
// and V in shared memory once; each warp owns one query row at a time --
// lanes over keys for the scores, warp shuffles for the softmax max/sum,
// lanes over d for P.V.
//
// Backward design: one block per (batch row, head).  dk and dv are sums
// over query rows, which a warp-per-row pass cannot write without atomics.
// So pass A (a warp per query row, lanes over keys, V staged in shared
// memory) writes the fp32 tiles PD = drop(p) and dS for the whole head to
// shared memory; pass B then stages dO, Q and K in turn in the space V
// used and forms dv, dk and dq with one thread per (output row block,
// channel), each summing its terms in a fixed order: the gradients are the
// same from run to run.  Shared memory is (max(Lq, Lk) * (d + 1)
// + 2 * Lq * Lk + 8 * d) floats: 201 KB at L = 144, d = 64, under the
// 227 KB a block may use; the wrapper refuses larger shapes.
#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 8;
constexpr float kNegInf = -1e4f;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const void* mask;  // float (B, Lk) validity, or int32 (B, Lk) segment ids
  void* probs;       // (B, H, Lq, Lk) in T, or null
  int B, H, Lq, Lk;
  int causal;        // validity mode: add the causal bias
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  float scale;
  float rate;        // dropout rate; 0 = no dropout
  float keep_scale;  // 1 / (1 - rate)
  PhiloxKey key;
};

template <typename T, int DCH, bool SEG>
__global__ void __launch_bounds__(kWarps * 32)
    packed_attention_kernel(AttnArgs a) {
  constexpr int D = DCH * 32;
  const int Lk = a.Lk;
  extern __shared__ float smem[];
  float* ks = smem;                // [Lk][D + 1]
  float* vs = ks + Lk * (D + 1);   // [Lk][D]
  float* kbias = vs + Lk * D;      // [Lk] validity bias, or segment ids
  int* kseg = reinterpret_cast<int*>(kbias);
  float* qs = kbias + Lk;          // [kWarps][D]
  float* ps = qs + kWarps * D;     // [kWarps][Lk]

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x - b * a.H;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_bs + h * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_bs + h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_bs + h * D;
  T* ob = static_cast<T*>(a.out) + b * a.o_bs + h * D;
  T* pb = a.probs == nullptr
              ? nullptr
              : static_cast<T*>(a.probs) +
                    static_cast<long long>(blockIdx.x) * a.Lq * Lk;
  const bool drop = a.rate > 0.f;

  for (int i = threadIdx.x; i < Lk * D; i += blockDim.x) {
    const int j = i / D, c = i - j * D;
    ks[j * (D + 1) + c] = to_float(kb[j * a.k_rs + c]);
    vs[j * D + c] = to_float(vb[j * a.v_rs + c]);
  }
  for (int j = threadIdx.x; j < Lk; j += blockDim.x) {
    const long long m = static_cast<long long>(b) * Lk + j;
    if (SEG)
      kseg[j] = static_cast<const int*>(a.mask)[m];
    else
      kbias[j] = (1.f - static_cast<const float*>(a.mask)[m]) * kNegInf;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = qs + warp * D;
  float* pw = ps + warp * Lk;
  for (int r = warp; r < a.Lq; r += kWarps) {
#pragma unroll
    for (int c = 0; c < DCH; ++c)
      qw[lane + 32 * c] = to_float(qb[r * a.q_rs + lane + 32 * c]);
    const int sq = SEG ? kseg[r] : 0;
    const int last = a.causal ? r + (Lk - a.Lq) : Lk;  // last causal key
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float* kr = ks + j * (D + 1);
      float acc = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) acc = fmaf(qw[c], kr[c], acc);
      float s = acc * a.scale;
      if (SEG) {
        s += (kseg[j] == sq && sq >= 0) ? 0.f : kNegInf;
      } else {
        s += kbias[j];
        if (j > last) s += kNegInf;
      }
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Lk; j += 32) {
      float p = pw[j] / sum;
      if (pb != nullptr) pb[static_cast<long long>(r) * Lk + j] = from_float<T>(p);
      if (drop)
        p = dropout_keep(a.key, b, h, r, j, a.rate) ? p * a.keep_scale : 0.f;
      pw[j] = p;
    }
    __syncwarp();

    float acc[DCH];
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[c] = 0.f;
    for (int j = 0; j < Lk; ++j) {
      const float p = pw[j];
#pragma unroll
      for (int c = 0; c < DCH; ++c)
        acc[c] = fmaf(p, vs[j * D + lane + 32 * c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < DCH; ++c)
      ob[r * a.o_rs + lane + 32 * c] = from_float<T>(acc[c]);
    __syncwarp();
  }
}

size_t fwd_smem(int Lk, int D) {
  return sizeof(float) * (static_cast<size_t>(Lk) * (2 * D + 2)
                          + kWarps * (D + Lk));
}

template <typename T, int DCH, bool SEG>
cudaError_t launch_fwd(const AttnArgs& a, cudaStream_t stream) {
  constexpr int D = DCH * 32;
  const size_t smem = fwd_smem(a.Lk, D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_attention_kernel<T, DCH, SEG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  packed_attention_kernel<T, DCH, SEG>
      <<<a.B * a.H, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool SEG>
cudaError_t fwd_dim(const AttnArgs& a, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_fwd<T, 1, SEG>(a, s);
    case 64: return launch_fwd<T, 2, SEG>(a, s);
    case 128: return launch_fwd<T, 4, SEG>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t fwd_mode(const AttnArgs& a, int seg, int head_dim,
                     cudaStream_t s) {
  return seg ? fwd_dim<T, true>(a, head_dim, s)
             : fwd_dim<T, false>(a, head_dim, s);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* p;  // (B, H, Lq, Lk) saved pre-dropout probabilities, in T
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  int B, H, Lq, Lk;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs;
  long long dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;
  float scale, rate, keep_scale;
  PhiloxKey key;
};

constexpr int kRowBlock = 4;  // output rows per thread in pass B

// Stage rows [0, n) of one head of a packed (., L, H*D) tensor into
// xs[n][D] as fp32.
template <typename T, int D>
__device__ void stage(const T* src, long long row_stride, int n, float* xs) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    xs[i] = to_float(src[r * row_stride + c]);
  }
}

// out[x][c] = scale * sum_{y < ny} m[x * sx + y * sy] * xs[y][c] for
// x < nx, c < D, written to out[x * out_rs + c] in T.  Each thread owns
// one channel and kRowBlock output rows at a time and sums in y order.
template <typename T, int D>
__device__ void contract(const float* m, int sx, int sy, const float* xs,
                         int nx, int ny, float scale, T* out,
                         long long out_rs) {
  const int c = threadIdx.x % D;
  const int group = threadIdx.x / D, n_groups = blockDim.x / D;
  for (int x0 = group * kRowBlock; x0 < nx; x0 += n_groups * kRowBlock) {
    int rows[kRowBlock];
#pragma unroll
    for (int t = 0; t < kRowBlock; ++t) rows[t] = min(x0 + t, nx - 1);
    float acc[kRowBlock];
#pragma unroll
    for (int t = 0; t < kRowBlock; ++t) acc[t] = 0.f;
    for (int y = 0; y < ny; ++y) {
      const float xv = xs[y * D + c];
#pragma unroll
      for (int t = 0; t < kRowBlock; ++t)
        acc[t] = fmaf(m[rows[t] * sx + y * sy], xv, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < kRowBlock; ++t)
      if (x0 + t < nx) out[(x0 + t) * out_rs + c] = from_float<T>(acc[t] * scale);
  }
}

template <typename T, int DCH>
__global__ void __launch_bounds__(kWarps * 32)
    packed_attention_bwd_kernel(BwdArgs a) {
  constexpr int D = DCH * 32;
  const int Lq = a.Lq, Lk = a.Lk;
  extern __shared__ float smem[];
  float* region = smem;                                // [max(Lq,Lk)][D+1]
  float* dsm = region + max(Lq, Lk) * (D + 1);         // [Lq][Lk] dS
  float* pdm = dsm + Lq * Lk;                          // [Lq][Lk] drop(p)
  float* dow = pdm + Lq * Lk;                          // [kWarps][D]

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x - b * a.H;
  const T* pb = static_cast<const T*>(a.p) +
                static_cast<long long>(blockIdx.x) * Lq * Lk;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_bs + h * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_bs + h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_bs + h * D;
  const T* gb = static_cast<const T*>(a.dout) + b * a.do_bs + h * D;
  const bool drop = a.rate > 0.f;

  // pass A: PD and dS, a warp per query row, V padded against bank
  // conflicts
  for (int i = threadIdx.x; i < Lk * D; i += blockDim.x) {
    const int j = i / D, c = i - j * D;
    region[j * (D + 1) + c] = to_float(vb[j * a.v_rs + c]);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* gw = dow + warp * D;
  for (int r = warp; r < Lq; r += kWarps) {
#pragma unroll
    for (int c = 0; c < DCH; ++c)
      gw[lane + 32 * c] = to_float(gb[r * a.do_rs + lane + 32 * c]);
    __syncwarp();
    const T* pr = pb + static_cast<long long>(r) * Lk;
    float* dsr = dsm + r * Lk;
    float* pdr = pdm + r * Lk;
    float acc = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float* vr = region + j * (D + 1);
      float dpd = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dpd = fmaf(gw[c], vr[c], dpd);
      const float p = to_float(pr[j]);
      float dp = dpd, pd = p;
      if (drop) {
        const bool keep = dropout_keep(a.key, b, h, r, j, a.rate);
        dp = keep ? dpd * a.keep_scale : 0.f;
        pd = keep ? p * a.keep_scale : 0.f;
      }
      pdr[j] = pd;
      dsr[j] = dp;
      acc = fmaf(dp, p, acc);
    }
    const float rowsum = warp_sum(acc);
    for (int j = lane; j < Lk; j += 32)
      dsr[j] = to_float(pr[j]) * (dsr[j] - rowsum);
    __syncwarp();
  }
  __syncthreads();

  // pass B: dv = PD^T dO, dk = dS^T Q * scale, dq = dS K * scale
  stage<T, D>(gb, a.do_rs, Lq, region);
  __syncthreads();
  contract<T, D>(pdm, 1, Lk, region, Lk, Lq, 1.f,
                 static_cast<T*>(a.dv) + b * a.dv_bs + h * D, a.dv_rs);
  __syncthreads();
  stage<T, D>(qb, a.q_rs, Lq, region);
  __syncthreads();
  contract<T, D>(dsm, 1, Lk, region, Lk, Lq, a.scale,
                 static_cast<T*>(a.dk) + b * a.dk_bs + h * D, a.dk_rs);
  __syncthreads();
  stage<T, D>(kb, a.k_rs, Lk, region);
  __syncthreads();
  contract<T, D>(dsm, Lk, 1, region, Lq, Lk, a.scale,
                 static_cast<T*>(a.dq) + b * a.dq_bs + h * D, a.dq_rs);
}

size_t bwd_smem(int Lq, int Lk, int D) {
  return sizeof(float) * (static_cast<size_t>(Lq > Lk ? Lq : Lk) * (D + 1)
                          + 2 * static_cast<size_t>(Lq) * Lk + kWarps * D);
}

template <typename T, int DCH>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr int D = DCH * 32;
  const size_t smem = bwd_smem(a.Lq, a.Lk, D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_attention_bwd_kernel<T, DCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  packed_attention_bwd_kernel<T, DCH>
      <<<a.B * a.H, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dim(const BwdArgs& a, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_bwd<T, 1>(a, s);
    case 64: return launch_bwd<T, 2>(a, s);
    case 128: return launch_bwd<T, 4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

__global__ void keep_mask_kernel(PhiloxKey key, int B, int H, int Lq, int Lk,
                                 float rate, unsigned char* out) {
  const long long n = static_cast<long long>(B) * H * Lq * Lk;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long t = e;
    const int j = static_cast<int>(t % Lk); t /= Lk;
    const int i = static_cast<int>(t % Lq); t /= Lq;
    const int h = static_cast<int>(t % H);
    const int b = static_cast<int>(t / H);
    out[e] = dropout_keep(key, b, h, i, j, rate) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// head-major attention
// ---------------------------------------------------------------------------
//
// Replaces the Pallas kernel hero_tpu/ops/attention.py _fwd_kernel (v2,
// :121, pallas_call at :203), reached through multi_head_attention: q, k,
// v are (B, H, L, d) tensors addressed through their batch, head and row
// strides (the TVC decode step passes one layer of its (layers, B, H, T, d)
// KV cache and head views of its projections, none of them copied); out is
// a contiguous (B, H, Lq, d) tensor.  Per (b, h, i) it computes what
// mha_reference defines, unpadded:
//   s_j = q_i . k_j * scale + (1 - mask[b, j]) * -1e4
//         [+ -1e4 where causal and j > i + (Lk - Lq)]
//   out_i = sum_j drop(softmax(s)_j) v_j
// with the dropout bit of philox.cuh for (seed, b, h, i, j), so a backward
// can regenerate it.  Scores, softmax statistics and the probability-value
// products are fp32 (the Pallas kernel rounds p to the input type before
// P.V; mha_reference, the plain version, keeps it fp32, and so does this).
//
// Bound on the H100: at the decode step's shape (Lq = 1, Lk = 30, d = 64,
// B*H = 384 or 1152 rows) every row is 2*Lk*d reads for 4*Lk*d flops, so
// the ideal is memory-bound; the whole call reads 3 MB (greedy, bf16) to
// 9 MB (beam 3), one to three microseconds at the memory rate.  Design: a
// warp per query row, kMhaWarps rows per block, nothing staged in shared
// memory but the row's q and its scores (a key is read by one row only
// when Lq = 1): lanes over keys for the scores (warp shuffles for the max
// and the sum), lanes over d for P.V, which reads each value row
// coalesced.  Shared memory is kMhaWarps * (d + Lk) floats, so Lk is
// bounded only by the 227 KB a block may use.

constexpr int kMhaWarps = 4;

struct MhaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const float* mask;  // (B, Lk) validity, unit stride over keys
  int B, H, Lq, Lk, causal;
  long long q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, m_bs;
  float scale, rate, keep_scale;
  PhiloxKey key;
};

template <typename T, int DCH>
__global__ void __launch_bounds__(kMhaWarps * 32)
    mha_attention_kernel(MhaArgs a) {
  constexpr int D = DCH * 32;
  const int Lk = a.Lk;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = smem + warp * (D + Lk);  // [D] the query row
  float* pw = qw + D;                  // [Lk] its scores, then probabilities

  const long long row = static_cast<long long>(blockIdx.x) * kMhaWarps + warp;
  if (row >= static_cast<long long>(a.B) * a.H * a.Lq) return;
  const int i = static_cast<int>(row % a.Lq);
  const int h = static_cast<int>((row / a.Lq) % a.H);
  const int b = static_cast<int>(row / (static_cast<long long>(a.Lq) * a.H));
  const T* qr = static_cast<const T*>(a.q) + b * a.q_bs + h * a.q_hs +
                i * a.q_rs;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_bs + h * a.k_hs;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_bs + h * a.v_hs;
  const float* mr = a.mask + b * a.m_bs;
  T* orow = static_cast<T*>(a.out) + row * D;
  const int last = a.causal ? i + (Lk - a.Lq) : Lk;  // last causal key

#pragma unroll
  for (int c = 0; c < DCH; ++c)
    qw[lane + 32 * c] = to_float(qr[lane + 32 * c]);
  __syncwarp();

  float mx = -INFINITY;
  for (int j = lane; j < Lk; j += 32) {
    const T* kr = kb + j * a.k_rs;
    float acc = 0.f;
#pragma unroll 16
    for (int c = 0; c < D; ++c) acc = fmaf(qw[c], to_float(kr[c]), acc);
    float s = acc * a.scale;
    s += (1.f - mr[j]) * kNegInf;
    if (j > last) s += kNegInf;
    pw[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < Lk; j += 32) {
    const float e = expf(pw[j] - mx);
    pw[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  const bool drop = a.rate > 0.f;
  for (int j = lane; j < Lk; j += 32) {
    float p = pw[j] / sum;
    if (drop)
      p = dropout_keep(a.key, b, h, i, j, a.rate) ? p * a.keep_scale : 0.f;
    pw[j] = p;
  }
  __syncwarp();

  float acc[DCH];
#pragma unroll
  for (int c = 0; c < DCH; ++c) acc[c] = 0.f;
  for (int j = 0; j < Lk; ++j) {
    const float p = pw[j];
    const T* vr = vb + j * a.v_rs;
#pragma unroll
    for (int c = 0; c < DCH; ++c)
      acc[c] = fmaf(p, to_float(vr[lane + 32 * c]), acc[c]);
  }
#pragma unroll
  for (int c = 0; c < DCH; ++c) orow[lane + 32 * c] = from_float<T>(acc[c]);
}

size_t mha_smem(int Lk, int D) {
  return sizeof(float) * kMhaWarps * (static_cast<size_t>(D) + Lk);
}

template <typename T, int DCH>
cudaError_t launch_mha(const MhaArgs& a, cudaStream_t stream) {
  constexpr int D = DCH * 32;
  const size_t smem = mha_smem(a.Lk, D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_attention_kernel<T, DCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long rows = static_cast<long long>(a.B) * a.H * a.Lq;
  const long long blocks = (rows + kMhaWarps - 1) / kMhaWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mha_attention_kernel<T, DCH><<<static_cast<unsigned>(blocks),
                                 kMhaWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mha_dim(const MhaArgs& a, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_mha<T, 1>(a, s);
    case 64: return launch_mha<T, 2>(a, s);
    case 128: return launch_mha<T, 4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory (bytes) the kernels need at these shapes, so the wrapper
// can refuse a shape before launching.
extern "C" long long hero_attention_smem_bytes(int backward, int Lq, int Lk,
                                               int head_dim) {
  return static_cast<long long>(backward ? bwd_smem(Lq, Lk, head_dim)
                                         : fwd_smem(Lk, head_dim));
}

extern "C" long long hero_attention_smem_limit() { return kMaxSmem; }

extern "C" long long hero_mha_smem_bytes(int Lk, int head_dim) {
  return static_cast<long long>(mha_smem(Lk, head_dim));
}

// Returns a cudaError_t code (0 = launched).  Strides are in elements.
// ``probs`` may be null (serving); ``rate`` 0 draws no dropout; ``causal``
// applies to the validity mode only.
extern "C" int hero_packed_attention_fwd(
    int dtype, int seg_mode, int causal, const void* q, const void* k,
    const void* v, void* out, const void* mask, void* probs, int B, int H,
    int Lq, int Lk, int head_dim, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    long long o_bs, long long o_rs, float scale, float rate,
    float keep_scale, unsigned int seed_lo, unsigned int seed_hi,
    void* stream) {
  const AttnArgs a{q, k, v, out, mask, probs, B, H, Lq, Lk,
                   seg_mode ? 0 : causal,
                   q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs,
                   scale, rate, keep_scale, PhiloxKey{seed_lo, seed_hi}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kFloat32: e = fwd_mode<float>(a, seg_mode, head_dim, s); break;
    case kBFloat16:
      e = fwd_mode<__nv_bfloat16>(a, seg_mode, head_dim, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Returns a cudaError_t code (0 = launched).  p: contiguous
// (B, H, Lq, Lk); the others packed with batch/row strides in elements.
extern "C" int hero_packed_attention_bwd(
    int dtype, const void* p, const void* q, const void* k, const void* v,
    const void* dout, void* dq, void* dk, void* dv, int B, int H, int Lq,
    int Lk, int head_dim, long long q_bs, long long q_rs, long long k_bs,
    long long k_rs, long long v_bs, long long v_rs, long long do_bs,
    long long do_rs, long long dq_bs, long long dq_rs, long long dk_bs,
    long long dk_rs, long long dv_bs, long long dv_rs, float scale,
    float rate, float keep_scale, unsigned int seed_lo, unsigned int seed_hi,
    void* stream) {
  const BwdArgs a{p, q, k, v, dout, dq, dk, dv, B, H, Lq, Lk,
                  q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs,
                  dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs,
                  scale, rate, keep_scale, PhiloxKey{seed_lo, seed_hi}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kFloat32: e = bwd_dim<float>(a, head_dim, s); break;
    case kBFloat16: e = bwd_dim<__nv_bfloat16>(a, head_dim, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Head-major attention.  Returns a cudaError_t code (0 = launched).
// q/k/v: (B, H, L, d) with unit stride over d, the other strides in
// elements; out: contiguous (B, H, Lq, d); mask: float (B, Lk) with unit
// stride over keys and batch stride m_bs (0 = one row for every batch).
extern "C" int hero_mha_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* out,
    const void* mask, int B, int H, int Lq, int Lk, int head_dim, int causal,
    long long q_bs, long long q_hs, long long q_rs, long long k_bs,
    long long k_hs, long long k_rs, long long v_bs, long long v_hs,
    long long v_rs, long long m_bs, float scale, float rate,
    float keep_scale, unsigned int seed_lo, unsigned int seed_hi,
    void* stream) {
  const MhaArgs a{q, k, v, out, static_cast<const float*>(mask),
                  B, H, Lq, Lk, causal,
                  q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, m_bs,
                  scale, rate, keep_scale, PhiloxKey{seed_lo, seed_hi}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kFloat32: e = mha_dim<float>(a, head_dim, s); break;
    case kBFloat16: e = mha_dim<__nv_bfloat16>(a, head_dim, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// The (B, H, Lq, Lk) uint8 keep mask the kernels draw, for checking them
// against the plain version (ops/dropout.py).
extern "C" int hero_dropout_keep_mask(unsigned int seed_lo,
                                      unsigned int seed_hi, int B, int H,
                                      int Lq, int Lk, float rate, void* out,
                                      void* stream) {
  keep_mask_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      PhiloxKey{seed_lo, seed_hi}, B, H, Lq, Lk, rate,
      static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
