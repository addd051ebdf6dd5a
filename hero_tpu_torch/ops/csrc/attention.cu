// Packed multi-head attention forward, validity-mask and segment-mask modes.
//
// Replaces the Pallas kernels hero_tpu/ops/attention.py _fwd3_kernel
// (validity mask, :277) and _fwd3_seg_kernel (segment mask, :304), as
// reached through packed_attention.  It computes what mha_reference
// (hero_tpu/ops/attention.py:53) defines, with no key padding:
//   out[b, i, h] = softmax_j(q_i . k_j / sqrt(d) + bias_ij) . v_j
// with bias 0 for an allowed key and an ADDITIVE -1e4 otherwise, so on a
// fully masked row the bias cancels in the softmax (never NaN; the row is
// the unmasked attention up to the rounding of s - 1e4).  Validity mode: key j
// allowed iff mask[b, j] == 1 (bias = (1 - mask) * -1e4).  Segment mode:
// allowed iff seg[b, j] == seg[b, i] and seg[b, i] >= 0 (-1 = pad slot);
// this is the one-hot seg . seg^T of the TPU kernel without the matmul.
// Scores, softmax statistics and the probability-value products are fp32;
// q/k/v are read in their storage type (fp32 or bf16) and the output is
// rounded once to that type.  Inference only: no dropout, no saved probs.
//
// Layout: q/k/v/out are the packed (B, L, H*d) tensors the fused QKV
// projection produces, addressed through batch and row strides (q, k and v
// are column slices of one (B, L, 3*H*d) tensor), so no head transposes.
//
// Bound on the H100: at the serving shapes (L <= 104, d = 64) a head's K
// and V fit in shared memory and the work is ~4*L^2*d flops per (row, head)
// against ~4*L*d*2 bytes, so the ideal is memory-bound (q/k/v read once,
// out written once).  This first kernel does the products on the CUDA cores
// in fp32 (no wgmma yet): one block per (batch row, head) stages K (padded
// to d+1 floats per key, so lanes reading different keys hit different
// banks) and V in shared memory once; each warp owns one query row at a
// time -- lanes over keys for the scores, warp shuffles for the softmax
// max/sum, lanes over d for P.V.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr float kNegInf = -1e4f;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const void* mask;  // float (B, Lk) validity, or int32 (B, Lk) segment ids
  int B, H, Lq, Lk;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  float scale;
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
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float* kr = ks + j * (D + 1);
      float acc = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) acc = fmaf(qw[c], kr[c], acc);
      float s = acc * a.scale;
      if (SEG)
        s += (kseg[j] == sq && sq >= 0) ? 0.f : kNegInf;
      else
        s += kbias[j];
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
    for (int j = lane; j < Lk; j += 32) pw[j] = pw[j] / sum;
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

template <typename T, int DCH, bool SEG>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  constexpr int D = DCH * 32;
  const size_t smem = sizeof(float) * (static_cast<size_t>(a.Lk) * (2 * D + 2)
                                       + kWarps * (D + a.Lk));
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
cudaError_t dispatch_dim(const AttnArgs& a, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch<T, 1, SEG>(a, s);
    case 64: return launch<T, 2, SEG>(a, s);
    case 128: return launch<T, 4, SEG>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_mode(const AttnArgs& a, int seg, int head_dim,
                          cudaStream_t s) {
  return seg ? dispatch_dim<T, true>(a, head_dim, s)
             : dispatch_dim<T, false>(a, head_dim, s);
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  Strides are in elements.
extern "C" int hero_packed_attention_fwd(
    int dtype, int seg_mode, const void* q, const void* k, const void* v,
    void* out, const void* mask, int B, int H, int Lq, int Lk, int head_dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs,
    float scale, void* stream) {
  const AttnArgs a{q, k, v, out, mask, B, H, Lq, Lk,
                   q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kFloat32: e = dispatch_mode<float>(a, seg_mode, head_dim, s); break;
    case kBFloat16:
      e = dispatch_mode<__nv_bfloat16>(a, seg_mode, head_dim, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
