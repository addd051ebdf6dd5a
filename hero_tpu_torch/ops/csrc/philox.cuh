// Philox4x32-10 keep bits for the attention-probability dropout and the
// row dropout of the fused dropout-add-LayerNorm.
//
// Stands in for the TPU PRNG (pltpu.prng_random_bits) of the Pallas
// kernels, hero_tpu/ops/attention.py _dropout_keep_mask (:89) and
// hero_tpu/ops/layernorm.py _daln_fwd_kernel (:175).  Bit for bit the
// plain PyTorch version hero_tpu_torch/ops/dropout.py: key = (seed lo,
// seed hi), and
//   - attention element (b, h, i, j): counter (j, i, h, b), bits = word 0;
//   - row-tensor element (row, col): counter (col >> 2, row lo, row hi,
//     0xFFFFFFFF), bits = word col & 3, so one call draws four columns;
// keep = (bits >> 8) * 2^-24 >= rate in fp32.  The counter holds the
// element's coordinates, so the mask does not depend on the launch
// geometry and the backward regenerates the forward's mask exactly.
#pragma once

#include <stdint.h>

struct PhiloxKey {
  uint32_t k0, k1;
};

// The four words of Philox4x32-10(key, (c0, c1, c2, c3)).
__device__ __forceinline__ uint4 philox4(PhiloxKey key, uint32_t c0,
                                         uint32_t c1, uint32_t c2,
                                         uint32_t c3) {
  uint32_t k0 = key.k0, k1 = key.k1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Word 0 (the compiler drops the other three words' last-round work).
__device__ __forceinline__ uint32_t philox_bits(PhiloxKey key, uint32_t c0,
                                                uint32_t c1, uint32_t c2,
                                                uint32_t c3) {
  return philox4(key, c0, c1, c2, c3).x;
}

__device__ __forceinline__ bool keep_bit(uint32_t bits, float rate) {
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f) >= rate;
}

__device__ __forceinline__ bool dropout_keep(PhiloxKey key, int b, int h,
                                             int i, int j, float rate) {
  return keep_bit(philox_bits(key, static_cast<uint32_t>(j),
                              static_cast<uint32_t>(i),
                              static_cast<uint32_t>(h),
                              static_cast<uint32_t>(b)),
                  rate);
}

// keep_bit's test as one integer compare, for kernels that draw many
// bits at one rate: with thr = keep_threshold(rate) (rate in [0, 1), so
// rate * 2^24 is exact in fp32 and its ceiling fits 24 bits),
// (bits >> 8) * 2^-24 >= rate  <=>  bits >> 8 >= thr >> 8  <=>  bits >= thr.
__device__ __forceinline__ uint32_t keep_threshold(float rate) {
  return static_cast<uint32_t>(ceilf(rate * 16777216.0f)) << 8;
}

__device__ __forceinline__ bool dropout_keep_thr(PhiloxKey key, int b,
                                                 int h, int i, int j,
                                                 uint32_t thr) {
  return philox_bits(key, static_cast<uint32_t>(j), static_cast<uint32_t>(i),
                     static_cast<uint32_t>(h), static_cast<uint32_t>(b)) >=
         thr;
}

// Keep bits of row-tensor elements (row, 4 q) .. (row, 4 q + 3): bit k
// for column 4 q + k, from one Philox call.  keep_bit's test without the
// conversion to float: with thr = ceil(rate * 2^24) << 8 (the wrapper,
// ops/layernorm.py _daln_rate, keeps rate in [0, 1) in fp32, so rate * 2^24
// is exact and thr fits 32 bits),
// (bits >> 8) * 2^-24 >= rate  <=>  bits >> 8 >= thr >> 8  <=>  bits >= thr.
__device__ __forceinline__ uint32_t row_keep4(PhiloxKey key, long long row,
                                              int q, uint32_t thr) {
  const unsigned long long r = static_cast<unsigned long long>(row);
  const uint4 w = philox4(key, static_cast<uint32_t>(q),
                          static_cast<uint32_t>(r),
                          static_cast<uint32_t>(r >> 32), 0xFFFFFFFFu);
  return static_cast<uint32_t>(w.x >= thr) |
         static_cast<uint32_t>(w.y >= thr) << 1 |
         static_cast<uint32_t>(w.z >= thr) << 2 |
         static_cast<uint32_t>(w.w >= thr) << 3;
}
