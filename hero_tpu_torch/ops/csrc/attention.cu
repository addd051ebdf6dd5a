// Packed multi-head attention: forward (validity-mask and segment-mask
// modes, optional causal bias, probability dropout and saved
// probabilities) and the saved-probabilities backward; and the head-major
// (B, H, L, d) forward of the decode step and its backward (after the
// packed kernels, each section with its own note; the bf16 tensor-core
// kernels of both layouts follow their CUDA-core ones).
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
// Each dtype has its own kernels: bf16, the dtype of every timed path,
// takes the tensor-core kernels (packed_attention_mma_kernel; the
// backward's pair packed_attention_bwd_dq_mma_kernel and
// packed_attention_bwd_dkv_mma_kernel); fp32, which only the checks and
// the fp32 card-versus-CPU parity runs use, takes the CUDA-core kernels
// (packed_attention_kernel; packed_attention_bwd_dq_kernel and
// packed_attention_bwd_dkv_kernel).
//
// Bound on the H100: per (row, head) the forward does ~4*L^2*d flops
// against ~8*L*d bytes of q/k/v/out (plus, in training, the 2*L^2 bytes
// of saved bf16 probabilities), the backward ~8*L^2*d flops against the
// saved p and 14*L*d bytes of q/k/v/do/dq/dk/dv: at the paths' shapes
// (L <= 144, d = 64) under 300 flops a byte, so both are memory-bound.
// The serving f-encoder's (200, 104, 768) forward moves 128 MB (38 us at
// 3.35 TB/s) for 6.6 GFLOP (7 us on the tensor cores).
//
// What holds the bf16 kernels back on the H100 is instruction issue, not
// bytes and not the tensor cores: every score costs a mask, an exp and a
// hi/lo split on the CUDA cores, and in training a Philox draw (~60
// integer instructions, the largest single cost of both kernels there).
// So the exp goes to the special-function unit (ex2.approx of x log2 e,
// relative error near 2^-22), p takes one reciprocal of l per row, and the
// causal and padding fix-ups run only on the chunks that can hold them.
//
// bf16 forward: a block per (batch row, head, tile of up to 64 query
// rows) of 4 warps, a warp per 16 rows.  The tile's Q is staged once.  A
// head of up to 112 keys is staged whole by cp.async (Q, K and the mask in
// a first group, V in a second that lands during sweep 1), as the whole-
// head kernel this replaces did; a longer one streams through two buffers
// of 112 key rows, the next tile in flight while this one is used: sweep
// 1, which reads only K, in 112-key tiles of K, sweep 2 in 48-key tiles
// of K and V (each buffer holds either), so K is read twice (the
// head-major forward's stream, with sweep 1's tiles larger).  Either way
// the kernel takes 224 key rows and the tile's 64 rows of Q, so shared
// memory does not depend on Lq or Lk: 42,880 bytes at d = 64, five blocks
// an SM.  The two ways are two instantiations of one kernel: the whole-
// head kernel keeps within 96 registers a thread at d = 64 (five blocks
// an SM, the occupancy of the kernel it replaces; ptxas, CUDA 12.8: 94-96,
// 8 bytes of spill in segment mode), the streaming loop's state takes
// 120-127 (four blocks).
// Tiles are bf16 rows of d + 8 elements: the 8 of padding put the 8 rows
// of every fragment load and ldmatrix in distinct banks; padded keys are
// zero rows.  Sweep 1 forms S = Q K^T on the tensor cores (mma.sync
// m16n8k16, fp32 accumulation; bf16 x bf16 products are exact in fp32, so
// the sums are the CUDA-core kernel's in another order) a 16-key chunk at
// a time, masks it and keeps the online row max and sum, combined over
// the 4 lanes of a row by shuffles.  Sweep 2 forms S again and
// p = exp(s - m) / l, final before P.V as the plain version has it (no
// rescaling of the accumulator, no register ceiling on Lk), writes p if
// asked, applies the Philox bit of (b, h, i, j) at each accumulator
// element and accumulates O += P V.  A key past Lk scores -inf, so its p is exactly 0 and it never
// joins the softmax (a -1e4 pad would change fully masked rows).  A tile
// of one or two 16-row groups (the decode step's single query, the
// 30-token query rows) would leave warps idle and walk every key on one
// warp, so its warps split the key chunks instead and combine their (max,
// sum) and partial outputs through shared memory in a fixed order.
//
// Dead chunks.  A packed row holds several segments and a token attends
// only its own, so for many (row, key) pairs p is exactly 0.  Sweep 1
// marks every (16-row tile, 16-key chunk) pair whose scores all lie
// kSkipGap (1000) or more below the running max of their rows once the
// chunk is in it -- a lower bound of each row's max, so exp(s - m) is 0 in
// fp32 at every element of the pair, in the plain version as here -- and
// sweep 2 skips the marked pairs: no exp, no Philox draw, no P.V product,
// and zeros written to the saved p; m, l, p and the output do not change
// by a bit.  Only a pair that no row of the tile may attend (every score
// carries a -1e4: another segment, invalid keys, keys past the causal
// limit) lies so low; a tile holding a fully masked row (a pad slot, a
// batch row with no valid key) has that row's scores near its max and
// never skips, and neither do scores spread past ~1e4.  The test costs a
// vote a chunk, and four shuffles and a vote more where every score lies
// under -1000; the marks of the first 64 chunks (1024 keys) are kept in
// two registers.  In segment mode (self-
// attention, Lq <= Lk) sweep 1 starts at the tile of the block's rows and
// each warp at its rows' own chunk, which every row attends, so the
// running max holds a key the row attends before the chunks it does not.
// Elsewhere the keep bits are drawn only where the warp holds a nonzero p
// (a zero p adds 0 whatever its bit).
//
// The hi/lo split: p (and dS in the backward) are fp32 values that meet a
// bf16 tensor core.  Rounding them to bf16, as the Pallas kernel rounds p,
// would move the kernel a bf16 ulp away from the plain version, which
// keeps them in fp32.  So each is split as x = hi + lo, hi = bf16(x),
// lo = bf16(x - hi), and multiplied twice: ~16 mantissa bits, relative
// errors near 2^-17, and a second mma that the tensor cores have room
// for.  (Without dropout, the backward's pd = p is the saved bf16 p
// itself and takes one mma.)
//
// Backward, both dtypes (#3): two kernels in turn on the stream, each
// streaming through shared memory in 64-row tiles, so shared memory does
// not grow with Lq or Lk and every length is computed.
// dK and dV are sums over query rows and dQ over keys: a block owns the
// rows it writes, so neither needs atomics, and every sum runs in a fixed
// order (the same bits from run to run).  The keep bits are drawn again
// from Philox in each kernel (no bit mask that grows with Lk is kept), and
// only where the saved p is not 0: a zero p makes every term of its
// element exactly 0 whatever the bit, so the keys a packed segment does
// not attend, and padded keys, draw nothing (a draw is ~40 integer
// instructions, the largest cost of both kernels under dropout).
//   1. dQ and Delta: a block per (b, h, tile of 64 query rows), dO's tile
//      staged once; V, K and the saved p pass through shared memory in
//      64-key tiles by cp.async, the next tile in flight.  Sweep 1 forms
//      dP = dO V^T, applies the keep bits and sums
//      Delta_i = sum_j dp_ij p_ij in fp32 from the saved p (the rowsum of
//      _bwd3_kernel, not dO . O, which would read a rounded output);
//      sweep 2 forms dS = p o (dp - Delta) and accumulates
//      dQ = dS K * scale.  Delta goes to a (B, H, Lq) fp32 scratch.  The
//      bf16 kernel's sweep 1 keeps the keep bits of the first 256 keys in
//      4 registers a thread (sweep 2's elements are the same thread's),
//      so sweep 2 draws again only past them.
//   2. dK and dV: a block per (b, h, tile of 64 keys), V's tile staged
//      once; tiles of 64 query rows of Q, dO, p (read transposed) and
//      Delta stream through in order: dV += pd^T dO, dP^T = V dO^T,
//      dS^T = p^T o (dP^T - Delta), dK += dS^T Q * scale.  K is not read:
//      dK needs only dS and Q.
// bf16 (tensor cores): 4 warps, a warp per 16 rows of the block's tile
// (a tile of one or two 16-row groups -- a tail of a few rows, or a short
// head -- splits the other side's chunks over the warps, whose partial
// sums combine in a fixed order, as the forward's short tiles do);
// products on mma.sync m16n8k16 with fp32 accumulation, p and dS split
// into bf16 hi + lo (pd without dropout is the saved bf16 p itself, one
// mma).  The saved p's rows start at any element (Lk is any length), so a
// tile's row r lands in shared memory shifted by its start's offset in
// its 16-byte chunk: every global chunk is one 16-byte cp.async, cut off
// at the tile's edge by cp.async's source size (the chunk's leading
// elements, from the row or the one before it, are never read).  Shared
// memory at d = 32, 64, 128: dQ kernel 44,032, 64,512 and 105,472 bytes;
// dK/dV kernel 44,544, 65,024 and 105,984 (dO or V, and two buffers of
// the streamed tiles).  Registers are capped for three blocks an SM at
// d <= 64 (at most 170 a thread), two at d = 128; ptxas (CUDA 12.8,
// sm_90a), no spills: dQ 138, 156 and 210 registers at d = 32, 64, 128,
// dK/dV 136, 161 and 255 (its two D-wide accumulators).  At d = 64 three
// blocks of each fit an SM, by shared memory and by registers.
// fp32 (CUDA cores): 8 warps, a warp per 8 rows of the block's tile; a
// thread forms the dot products of its rows with 2 keys (lanes over
// keys, V padded to d + 1 floats so the lanes hit distinct banks) and
// then accumulates d / 32 channels of its rows' gradients; dS (and pd in
// kernel 2) overwrite the saved p's tile in shared memory, element for
// element, and the gradients' contraction reads them broadcast.  Shared
// memory at d = 32, 64, 128: dQ kernel 74,240, 115,200 and 197,120
// bytes, dK/dV kernel 74,496, 115,456 and 197,376: at d = 64 two blocks
// an SM (228 KB, 1 KB a block reserved), at d = 128 one.  ptxas: 120, 118
// and 146 registers (dQ), 123, 128 and 168 (dK/dV), no spills.  Every
// copy is a cp.async (16 bytes where the rows allow, else 4).
//
// fp32 forward design (packed_attention_kernel): a block per (batch row,
// head, tile of 64 query rows) of 8 warps, warp w owning rows w, w + 8,
// ..., w + 56; K (padded to d + 1 floats per key, so lanes reading
// different keys hit different banks), V and the mask stream through
// shared memory in 64-key tiles, two buffers; lanes over keys for
// the scores (q read broadcast), warp shuffles for the running max, a
// lane's share of the sum, and lanes over d for P.V, p passing through the
// warp's tile of shared memory.  Two passes over the tiles (max and sum,
// then p and P.V) and no row's scores over every key in shared memory, so
// shared memory does not depend on Lq or Lk (91,136 bytes at d = 64).  It
// skips dead half tiles (32 keys) under the bf16 kernel's rule.

#include <math.h>

#include <type_traits>

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
  void* probs;       // (B, H, Lq, Lk) in the input type, or null
  int B, H, Lq, Lk;
  int causal;        // validity mode: add the causal bias
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  float scale;
  float rate;        // dropout rate; 0 = no dropout
  float keep_scale;  // 1 / (1 - rate)
  PhiloxKey key;
};

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* p;  // (B, H, Lq, Lk) saved pre-dropout p, in the input type
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
// bf16 packed attention on the tensor cores (forward and backward)
// ---------------------------------------------------------------------------
//
// mma.sync.m16n8k16 fragments (g = lane / 4, t = lane % 4): A (16 x 16,
// row-major) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
// a3 = (g+8, 2t+8..); B (16 x 8) b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..,
// n g); C (16 x 8, fp32) c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..).  So
// the C tiles of two neighbouring 8-column blocks are, element for element,
// the A fragment of their 16 columns: a probability or dS tile goes from
// one product into the next in registers.

typedef __nv_bfloat16 bf16;

constexpr int kTcFwdWarps = 4;   // a forward block: 64 query rows
constexpr int kFwdTile = 48;     // keys of a streamed K/V tile (forward)
// Sweep 2 of the forward skips a chunk whose scores sweep 1 found at least
// this far below their rows' running max: exp of anything under -104 is 0
// in fp32, so the margin covers every difference of summation order.
constexpr float kSkipGap = 1000.f;
// The bf16 forward's key rows of shared memory: a head of up to kFwdWhole
// keys staged whole (K, then V), or two buffers of kFwdWhole rows, each
// one of sweep 1's tiles of K or one of sweep 2's kFwdTile-key tiles of K
// and V.  With the block's 64 rows of Q, at d = 64 five blocks fit an SM
// (228 KB, 1 KB a block reserved).
constexpr int kFwdWhole = 112;
constexpr int kFwdKeyRows = 2 * kFwdWhole;
static_assert(2 * kFwdTile <= kFwdWhole, "a buffer holds K and V");


__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Query rows of a forward block: up to 64, fewer for short queries (the
// block keeps its 4 warps, which all stage K and V).
__host__ __device__ inline int tc_fwd_rows(int Lq) {
  return min(16 * kTcFwdWarps, round16(Lq));
}

// Key parts of a forward block: its warps over its 16-row tiles, rounded
// down (4 parts for one tile, 2 for two, 1 for three, one warp idle).
__host__ __device__ inline int tc_fwd_split(int rows) {
  return max(1, kTcFwdWarps * 16 / rows);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed, from shared memory: lane l names
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t lds_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + lo with hi and lo bf16 pairs: ~16 mantissa bits of the
// fp32 values, so an fp32 probability or dS tile meets a bf16 tensor core
// with a relative error near 2^-17 (two mmas instead of one).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xffff0000u));
}

// exp(x) as 2^(x log2 e) on the special-function unit: relative error
// near 2^-22, far inside a bf16 ulp; exp(-inf) = 0
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// C tiles c[0] (columns 0-7) and c[1] (8-15) of 16 rows -> A fragments hi
// and lo of the 16 x 16 tile.
__device__ __forceinline__ void c_to_a(const float (&c)[2][4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c[0][0], c[0][1], hi[0], lo[0]);
  split_bf16(c[0][2], c[0][3], hi[1], lo[1]);
  split_bf16(c[1][0], c[1][1], hi[2], lo[2]);
  split_bf16(c[1][2], c[1][3], hi[3], lo[3]);
}

// 16 bytes by cp.async, of which the first ``bytes`` are read from src
// and the rest written 0 (src 16-byte aligned, even when bytes is 0).
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int bytes) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  cp_async16_n(dst, src, fill ? 16 : 0);
}

// One fp32 by cp.async (the mask); ``fill`` false writes 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(fill ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Element offset of (row, col) in a staged bf16 tile of rows of D
// elements.  The packed kernels pad each row to D + 8 elements, so the 8
// rows of every fragment load and ldmatrix fall in distinct banks.  The
// head-major kernels (SWZ) keep rows unpadded and permute each row's
// 16-byte chunks by an XOR with the row, which spreads the same 8 rows
// over the banks without the 16 bytes of padding a row.
template <int D, bool SWZ>
__device__ __forceinline__ int tile_off(int row, int col) {
  if (!SWZ) return row * (D + 8) + col;
  constexpr int U = D / 8;                  // 16-byte chunks a row
  constexpr int R = U >= 8 ? 1 : 8 / U;     // rows that share 128 bytes
  constexpr int M = (U >= 8 ? 8 : U) - 1;
  return row * D + (((col >> 3) ^ ((row / R) & M)) << 3) + (col & 7);
}

// Stage rows [0, n) of one head (src, row stride rs) into the tile dst
// of n_pad rows; rows n..n_pad are zero, so a padded key or query
// multiplies as 0 and never as garbage.  ``vec``: the source rows are
// 16-byte aligned and go by cp.async, every copy in flight at once (the
// caller waits for its group); else by 2-byte loads.
template <int D, bool SWZ = false>
__device__ void stage_rows(const bf16* src, long long rs, int n, int n_pad,
                           bool vec, bf16* dst) {
  constexpr int C = D / 8;
  for (int e = threadIdx.x; e < n_pad * C; e += blockDim.x) {
    const int r = e / C, c = (e - r * C) * 8;
    if (vec) {
      cp_async16(dst + tile_off<D, SWZ>(r, c), r < n ? src + r * rs + c : src,
                 r < n);
      continue;
    }
    union {
      uint4 u;
      bf16 h[8];
    } v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) {
#pragma unroll
      for (int x = 0; x < 8; ++x) v.h[x] = src[r * rs + c + x];
    }
    *reinterpret_cast<uint4*>(dst + tile_off<D, SWZ>(r, c)) = v.u;
  }
}

// A fragments of the 16 rows [r0, r0 + 16) of a staged tile, all D/16
// k-steps.
template <int D, bool SWZ = false>
__device__ __forceinline__ void load_a(const bf16* xs, int r0,
                                       uint32_t (&f)[D / 16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = lds_pair(xs + tile_off<D, SWZ>(r0 + g, c));
    f[kk][1] = lds_pair(xs + tile_off<D, SWZ>(r0 + g + 8, c));
    f[kk][2] = lds_pair(xs + tile_off<D, SWZ>(r0 + g, c + 8));
    f[kk][3] = lds_pair(xs + tile_off<D, SWZ>(r0 + g + 8, c + 8));
  }
}

// c[n] += A . Y^T for the 16 rows [y0, y0 + 16) of a staged tile Y (two
// 8-column C tiles): the scores q . k, or do . v.
template <int D, bool SWZ = false>
__device__ __forceinline__ void mma_abt(const uint32_t (&a)[D / 16][4],
                                        const bf16* ys, int y0,
                                        float (&c)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int n = 0; n < 2; ++n) {   // two independent chains, interleaved
      const int r = y0 + 8 * n + g, col = kk * 16 + 2 * t;
      mma_bf16(c[n], a[kk], lds_pair(ys + tile_off<D, SWZ>(r, col)),
               lds_pair(ys + tile_off<D, SWZ>(r, col + 8)));
    }
}

// acc += A . Y[y0:y0+16, :] for a 16 x 16 A (hi and lo parts) and the
// staged rows of Y, B fragments by ldmatrix.trans: P.V, dS.K, pd^T.dO,
// dS^T.Q.
template <int D, bool SWZ = false>
__device__ __forceinline__ void mma_ay(const uint32_t (&hi)[4],
                                       const uint32_t (&lo)[4], bool with_lo,
                                       const bf16* ys, int y0,
                                       float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int r = y0 + (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 16) {
    uint32_t b[4];
    ldsm_x4_trans(b, ys + tile_off<D, SWZ>(r, c0 + 8 * half));
    if (with_lo) {
      mma_bf16(acc[c0 / 8], lo, b[0], b[1]);
      mma_bf16(acc[c0 / 8 + 1], lo, b[2], b[3]);
    }
    mma_bf16(acc[c0 / 8], hi, b[0], b[1]);
    mma_bf16(acc[c0 / 8 + 1], hi, b[2], b[3]);
  }
}

// Write the 16 x D C tiles of rows (r_lo, r_lo + 8) * scale to a packed
// bf16 output with an even row stride, skipping rows >= n.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           float scale, bf16* out,
                                           long long rs, int r_lo, int n) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r_lo < n)
      *reinterpret_cast<uint32_t*>(out + r_lo * rs + c) =
          pack_bf16(acc[nt][0] * scale, acc[nt][1] * scale);
    if (r_lo + 8 < n)
      *reinterpret_cast<uint32_t*>(out + (r_lo + 8) * rs + c) =
          pack_bf16(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

// Forward: a block per (b, h, tile of up to 64 query rows), a warp per 16
// rows.  A head of up to kFwdWhole keys is staged whole (K and the mask in
// a first group, V in a second that lands during sweep 1); a longer one
// streams through two buffers by cp.async, the next tile in flight while
// this one is used: sweep 1, which reads only K, in kFwdWhole-key tiles,
// sweep 2 in kFwdTile-key tiles of K and V.  Sweep 1 forms S = Q K^T a
// 16-key chunk at a time on the tensor cores, masks it and keeps the
// running row max and sum; sweep 2 forms S again, p = exp(s - m) / l
// (final before P.V, as the plain version has it), writes p if asked,
// applies the Philox keep bit of (b, h, i, j) and accumulates O += P V
// with p split into bf16 hi + lo.  A chunk whose every score sweep 1 finds
// kSkipGap below its row's running max is skipped by sweep 2: no exp, draw
// or product, and zeros in the saved p.
template <int D, bool SEG, bool STREAM>
__global__ void __launch_bounds__(kTcFwdWarps * 32,
                                  D > 64 ? 2 : STREAM ? 4 : 5)
    packed_attention_mma_kernel(AttnArgs a, int vec) {
  constexpr int S = D + 8, KS = D / 16;
  // keys of a tile: sweep 1's (K only), and sweep 2's (K and V)
  constexpr int TK1 = kFwdWhole, TK2 = STREAM ? kFwdTile : kFwdWhole;
  const int Lq = a.Lq, Lk = a.Lk;
  const int rows = tc_fwd_rows(Lq), q0 = blockIdx.y * rows;
  const int n1 = STREAM ? (Lk + TK1 - 1) / TK1 : 1;
  const int n2 = STREAM ? (Lk + TK2 - 1) / TK2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // [64][S]
  bf16* bufs = qs + 16 * kTcFwdWarps * S;     // [kFwdKeyRows][S]: K, V
  float* mbuf = reinterpret_cast<float*>(bufs + kFwdKeyRows * S);  // mask
  float* mlbuf = mbuf + kFwdKeyRows;                       // [4][16][2]
  float* obuf = reinterpret_cast<float*>(bufs);   // [4][16][D + 4], at the end

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x - b * a.H;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_bs + h * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_bs + h * D;
  const float* mrow = static_cast<const float*>(a.mask) +
                      static_cast<long long>(b) * Lk;   // or int32 ids
  // Step s < n1 is sweep 1's tile tile_of(s) (K and the mask), the rest
  // sweep 2's tile s - n1 (K, the mask and V).  Streaming, step s takes
  // buffer s & 1, rows [TK1 (s & 1), + TK1) of the key rows: sweep 1's K
  // tile, or sweep 2's K tile and its V tile after it, so a step's
  // buffer is its predecessor-but-one's across the sweeps too.  Whole,
  // step 0 brings K and the mask and step 1 only V, after K, both in
  // flight from the start; sweep 2 reads step 0's K.  Every streamed
  // step commits a group, empty past the end.  In segment mode (Lq <=
  // Lk) sweep 1 starts at the tile of the block's own rows, and each warp
  // at the chunk of its own rows there: every row attends its own key,
  // so the running max holds a key the row attends before the chunks it
  // does not.
  const int t_first = SEG && STREAM ? (q0 / TK1) % n1 : 0;
  auto tile_of = [&](int s) {
    return s < n1 ? (t_first + s) % n1 : s - n1;
  };
  auto key0 = [&](int s) { return tile_of(s) * (s < n1 ? TK1 : TK2); };
  auto kbase = [&](int s) { return bufs + (STREAM ? (s & 1) * TK1 * S : 0); };
  auto vbase = [&](int s) { return kbase(s) + (STREAM ? TK2 : TK1) * S; };
  auto mbase = [&](int s) { return mbuf + (STREAM ? (s & 1) * TK1 : 0); };
  auto issue = [&](int s) {
    if (s < n1 + n2) {
      const int j0 = key0(s);
      const int n = min(s < n1 ? TK1 : TK2, Lk - j0), n_pad = round16(n);
      if (s < n1 || STREAM) {
        stage_rows<D>(kb + j0 * a.k_rs, a.k_rs, n, n_pad, vec & 2,
                      kbase(s));
        for (int j = threadIdx.x; j < n_pad; j += blockDim.x)
          cp_async4(mbase(s) + j, mrow + j0 + min(j, n - 1), j < n);
      }
      if (s >= n1)
        stage_rows<D>(vb + j0 * a.v_rs, a.v_rs, n, n_pad, vec & 4,
                      vbase(s));
    }
    cp_async_commit();
  };
  stage_rows<D>(static_cast<const bf16*>(a.q) + b * a.q_bs + h * D +
                    q0 * a.q_rs,
                a.q_rs, min(Lq - q0, rows), rows, vec & 1, qs);
  issue(0);   // with Q
  issue(1);

  // every warp stages; warp w takes the 16-row tile w / split of the
  // block's rows and every split-th 16-key chunk from w % split, so a short
  // query tile (the decode step's one query) spreads its keys over the
  // warps instead of walking them on one
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = tc_fwd_split(rows), part = warp % split;
  const int r0 = (warp / split) * 16;
  const bool active = r0 < rows && q0 + r0 < Lq;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const int shift = Lk - Lq;   // causal: row i attends no key j > i + shift
  int sq[2] = {-1, -1}, last[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (SEG && row[r] < Lq)
      sq[r] = static_cast<const int*>(a.mask)[static_cast<long long>(b) *
                                              Lk + row[r]];
    last[r] = a.causal ? row[r] + shift : Lk;   // last causal key
  }
  uint32_t qf[KS][4];

  // the masked, scaled scores of chunk c (keys from j0) of step s's tile;
  // -inf past Lk (the causal bias and the padding only where a chunk can
  // hold them)
  auto scores = [&](int s, int c, int j0, float (&x)[2][4]) {
    mma_abt<D>(qf, kbase(s), 16 * c, x);
    const float* mk = mbase(s) + 16 * c;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, jj = 8 * n + 2 * t + (e & 1);
        float v = x[n][e] * a.scale;
        if (SEG) {
          const int id = __float_as_int(mk[jj]);
          v += (id == sq[r] && sq[r] >= 0) ? 0.f : kNegInf;
        } else {
          v += (1.f - mk[jj]) * kNegInf;
        }
        x[n][e] = v;
      }
    // the causal bias, from the first chunk past the last key of the
    // warp's first row
    if (!SEG && a.causal && j0 + 15 > q0 + r0 + shift)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * n + 2 * t + (e & 1) > last[e >> 1])
            x[n][e] += kNegInf;
    if (j0 + 16 > Lk)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * n + 2 * t + (e & 1) >= Lk) x[n][e] = -INFINITY;
  };
  // 16-key chunks of step s's tile
  auto chunks = [&](int s) {
    return (min(s < n1 ? TK1 : TK2, Lk - key0(s)) + 15) / 16;
  };
  // (m, l) <- the softmax statistics of both key sets; -inf is "none yet"
  auto combine = [](float& m, float& l, float mo, float lo) {
    const float mn = fmaxf(m, mo);
    l = (m == -INFINITY ? 0.f : l * exp_fast(m - mn)) +
        (mo == -INFINITY ? 0.f : lo * exp_fast(mo - mn));
    m = mn;
  };

  // Sweep 1 marks, in ``skip`` (bit j / 16 for the chunk from key j, the
  // first 64 chunks), every chunk whose scores all lie kSkipGap or more
  // below the quad's running max of their rows after it, a lower bound of
  // the row max: exp(s - m) is then 0 in fp32 for each of them, in the
  // plain version as here, so sweep 2 skips the chunk and no bit of m, l,
  // p or the output changes.  Only a chunk that no row of the tile may
  // attend (every score carries a -1e4) lies so low; a fully masked row (a
  // pad slot, a batch row with no valid key) has scores near its max and
  // keeps its tile from skipping, as do scores spread past ~1e4.
  uint32_t skip[2] = {0u, 0u};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int s = 0; s < n1; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    if (s == 0 && active) load_a<D>(qs, r0, qf);
    const int tj = key0(s), nc = chunks(s);
    // the warp's chunks part, part + split, ... from the first at or past
    // its own rows' chunk (segment mode, the first tile), wrapping round
    const int cnt = part < nc ? (nc - part + split - 1) / split : 0;
    int k0 = 0;
    if (SEG && s == 0 && cnt > 0)
      k0 = min((max((q0 + r0 - tj) / 16, part) - part + split - 1) / split,
               cnt - 1);
    for (int kk = 0; active && kk < cnt; ++kk) {
      const int c = part + (k0 + kk < cnt ? k0 + kk : k0 + kk - cnt) * split;
      float x[2][4], mcs[2];
      scores(s, c, tj + 16 * c, x);
      bool low = true;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mc = fmaxf(fmaxf(x[0][2 * r], x[0][2 * r + 1]),
                               fmaxf(x[1][2 * r], x[1][2 * r + 1]));
        const float mn = fmaxf(m[r], mc);
        if (mn != -INFINITY) {   // else only padded keys so far
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < 2; ++n)
            sum += exp_fast(x[n][2 * r] - mn) + exp_fast(x[n][2 * r + 1] - mn);
          l[r] = l[r] * exp_fast(m[r] - mn) + sum;
          m[r] = mn;
        }
        mcs[r] = mc;
        low &= row[r] >= Lq || mc <= -kSkipGap;
      }
      // a chunk whose scores are not all far below 0 holds a key its rows
      // attend (scores of O(10)): only the others take the exact test
      const int bit = tj / 16 + c;
      if (__all_sync(0xffffffffu, low) && bit < 64) {
        low = true;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mq = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
          mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
          low &= row[r] >= Lq || mcs[r] <= mq - kSkipGap;
        }
        if (__all_sync(0xffffffffu, low)) skip[bit >> 5] |= 1u << (bit & 31);
      }
    }
    if (STREAM) {
      __syncthreads();
      issue(s + 2);
    }
  }
  // the quad's four threads hold the row's columns: combine (m, l); the
  // butterfly is symmetric, so all four end with the same bits
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1)
      combine(m[r], l[r], __shfl_xor_sync(0xffffffffu, m[r], o),
              __shfl_xor_sync(0xffffffffu, l[r], o));
  // the tile's key parts: every warp of it combines them in part order
  if (split > 1) {
    if (t == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mlbuf[(warp * 16 + g + 8 * r) * 2] = m[r];
        mlbuf[(warp * 16 + g + 8 * r) * 2 + 1] = l[r];
      }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int k = 0; k < kTcFwdWarps; ++k)
        if (k < split) {
          const float* x = mlbuf + ((warp - part + k) * 16 + g + 8 * r) * 2;
          combine(m[r], l[r], x[0], x[1]);
        }
    }
  }

  bf16* pb = a.probs == nullptr
                 ? nullptr
                 : static_cast<bf16*>(a.probs) +
                       static_cast<long long>(blockIdx.x) * Lq * Lk;
  const bool drop = a.rate > 0.f, even = (Lk & 1) == 0;
  const uint32_t thr = keep_threshold(a.rate);
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  for (int s = n1; s < n1 + n2; ++s) {
    if (STREAM)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int tj = key0(s), nc = chunks(s);
    for (int c = part; active && c < nc; c += split) {
      const int j0 = tj + 16 * c, bit = tj / 16 + c;
      const bool skipped = bit < 64 && ((skip[bit >> 5] >> (bit & 31)) & 1u);
      float x[2][4];
      if (!skipped) scores(s, c, j0, x);
      bool any = false;   // a nonzero p of the thread's real elements
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = row[r], j = j0 + 8 * n + 2 * t;
          float p0 = 0.f, p1 = 0.f;
          if (!skipped) {
            p0 = exp_fast(x[n][2 * r] - m[r]) * inv_l[r];
            p1 = exp_fast(x[n][2 * r + 1] - m[r]) * inv_l[r];
          }
          if (i < Lq) {
            any |= p0 != 0.f || p1 != 0.f;
            if (pb != nullptr) {
              bf16* pr = pb + static_cast<long long>(i) * Lk + j;
              if (even && j < Lk) {
                *reinterpret_cast<uint32_t*>(pr) = pack_bf16(p0, p1);
              } else {
                if (j < Lk) pr[0] = __float2bfloat16_rn(p0);
                if (j + 1 < Lk) pr[1] = __float2bfloat16_rn(p1);
              }
            }
          }
          x[n][2 * r] = p0;
          x[n][2 * r + 1] = p1;
        }
      if (skipped) continue;
      // the keep bits, only where the warp holds a nonzero p (a zero p
      // adds 0 whatever its bit): then all eight draws run, eight
      // independent chains the compiler interleaves
      if (drop && __any_sync(0xffffffffu, any))
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool kp = dropout_keep_thr(
                a.key, b, h, row[e >> 1], j0 + 8 * n + 2 * t + (e & 1), thr);
            x[n][e] = kp ? x[n][e] * a.keep_scale : 0.f;
          }
      uint32_t hi[4], lo[4];
      c_to_a(x, hi, lo);
      mma_ay<D>(hi, lo, true, vbase(s), 16 * c, o);
    }
    if (STREAM) {
      __syncthreads();
      issue(s + 2);
    }
  }
  cp_async_wait<0>();
  bf16* ob = static_cast<bf16*>(a.out) + b * a.o_bs + h * D;
  if (split == 1) {
    if (active) store_rows<D>(o, 1.f, ob, a.o_rs, row[0], Lq);
    return;
  }
  // the key parts' partial outputs, summed in part order by the tile's
  // first warp (the K/V buffers are free once every warp is past them)
  if (!STREAM) __syncthreads();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      obuf[(warp * 16 + g + 8 * (e >> 1)) * (D + 4) + nt * 8 + 2 * t +
           (e & 1)] = o[nt][e];
  __syncthreads();
  if (!active || part != 0) return;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* x = obuf + (warp * 16 + g + 8 * (e >> 1)) * (D + 4) +
                       nt * 8 + 2 * t + (e & 1);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kTcFwdWarps; ++k)
        if (k < split) sum += x[k * 16 * (D + 4)];
      o[nt][e] = sum;
    }
  store_rows<D>(o, 1.f, ob, a.o_rs, row[0], Lq);
}

// Shared memory of the bf16 forward: no term depends on Lq or Lk.
size_t fwd_mma_smem(int D) {
  return (16 * kTcFwdWarps + kFwdKeyRows) * (D + 8) * sizeof(bf16) +
         (kFwdKeyRows + kTcFwdWarps * 32) * sizeof(float);
}

bool rows_aligned16(const void* p, long long bs, long long rs) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && bs % 8 == 0 &&
         rs % 8 == 0;
}

template <int D, bool SEG, bool STREAM>
cudaError_t launch_fwd_mma(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem(D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_attention_mma_kernel<D, SEG, STREAM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int vec = (rows_aligned16(a.q, a.q_bs, a.q_rs) ? 1 : 0) |
                  (rows_aligned16(a.k, a.k_bs, a.k_rs) ? 2 : 0) |
                  (rows_aligned16(a.v, a.v_bs, a.v_rs) ? 4 : 0);
  const int rows = tc_fwd_rows(a.Lq);
  const dim3 grid(a.B * a.H, (a.Lq + rows - 1) / rows);
  packed_attention_mma_kernel<D, SEG, STREAM>
      <<<grid, kTcFwdWarps * 32, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

// A head of up to kFwdWhole keys takes the kernel that stages it whole, a
// longer one the streaming kernel, whose loop state takes registers the
// whole-head kernel does without (five blocks an SM at d = 64, four).
template <int D, bool SEG>
cudaError_t launch_fwd_mma(const AttnArgs& a, cudaStream_t stream) {
  return a.Lk > kFwdWhole ? launch_fwd_mma<D, SEG, true>(a, stream)
                          : launch_fwd_mma<D, SEG, false>(a, stream);
}

template <bool SEG>
cudaError_t fwd_mma_dim(const AttnArgs& a, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_fwd_mma<32, SEG>(a, s);
    case 64: return launch_fwd_mma<64, SEG>(a, s);
    case 128: return launch_fwd_mma<128, SEG>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// packed attention backward (#3): the dQ kernel, then the dK/dV kernel
// ---------------------------------------------------------------------------
//
// See the note at the head of the file.  Both kernels of a dtype take the
// same BwdArgs; the dQ kernel writes Delta to a (B, H, Lq) fp32 scratch
// the dK/dV kernel reads.  Tiles past Lq or Lk are zero in shared memory
// (zero rows of dO, Q, K, V, zero p and Delta), so a padded row or key
// adds exactly 0 to every sum and no mask is needed.

constexpr int kBwdTile = 64;       // query rows or keys of a block's tile
constexpr int kBwdWarps = 4;       // bf16 blocks: a warp per 16 rows
constexpr int kF32BwdWarps = 8;    // fp32 blocks: a warp per 8 rows
constexpr int kPStride = kBwdTile + 8;   // bf16 elements of a staged p row
constexpr int kBitTiles = 4;   // key tiles whose keep bits the dQ kernel's
                               // sweep 1 keeps for sweep 2 (256 keys)

// Element offset of a bf16 address within its 16-byte chunk.
__device__ __forceinline__ int chunk_shift(const bf16* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 1) & 7);
}

// Stage rows [0, nr) x columns [0, nc) of one head's saved bf16 p, row r
// at first + r * Lk, into dst[kBwdTile][kPStride]: row r from column
// chunk_shift(its start) on, so every 16-byte chunk of global memory is
// one 16-byte chunk of shared memory and one cp.async.  The source size
// cuts each row at column nc and zero-fills the rest of the row, and
// every row from nr on.  A row's first chunk also brings the elements
// before the row's start in its chunk (of the row, or of the one before
// it, inside the tensor's allocation); they are never read.
__device__ void stage_p_tile(const bf16* first, long long Lk, int nr, int nc,
                             bf16* dst) {
  constexpr int C = kPStride / 8;      // 9 chunks a row
  const bf16* dummy = first - chunk_shift(first);   // an aligned source
  for (int e = threadIdx.x; e < kBwdTile * C; e += blockDim.x) {
    const int r = e / C, u = e - r * C;
    const bf16* row = first + r * Lk;
    const int sh = chunk_shift(row);
    const int n = r < nr ? min(8, max(0, sh + nc - 8 * u)) : 0;
    cp_async16_n(dst + r * kPStride + 8 * u, n ? row - sh + 8 * u : dummy,
                 2 * n);
  }
}

// p of row r, column c of a tile staged by stage_p_tile, whose first
// element's chunk_shift is sh0 (rows Lk elements apart: row r's shift is
// sh0 + r * Lk mod 8).
__device__ __forceinline__ float p_tile_at(const bf16* pt, int sh0, int lk8,
                                           int r, int c) {
  return __bfloat162float(pt[r * kPStride + ((sh0 + r * lk8) & 7) + c]);
}

// Warps a 16-row group of a tile of n rows splits the other side's
// chunks over: 4 for one group, 2 for two, else 1 (as tc_fwd_split); 1
// when the other side is shorter than a tile, whose few chunks do not pay
// for the parts' combination.
__host__ __device__ inline int bwd_split(int n, int other) {
  return other < kBwdTile ? 1 : max(1, kBwdWarps / ((n + 15) / 16));
}

// acc <- the sum, in part order, of the accumulators of the ``split``
// warps of acc's 16-row group (warp - part .. + split), through obuf
// [kBwdWarps][16][D + 4]; every thread of the block calls it.
template <int D>
__device__ __forceinline__ void combine_parts(float (&acc)[D / 8][4],
                                              float* obuf, int warp,
                                              int part, int split) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      obuf[(warp * 16 + g + 8 * (e >> 1)) * (D + 4) + nt * 8 + 2 * t +
           (e & 1)] = acc[nt][e];
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* x = obuf + ((warp - part) * 16 + g + 8 * (e >> 1)) *
                                  (D + 4) + nt * 8 + 2 * t + (e & 1);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kBwdWarps; ++k)
        if (k < split) sum += x[k * 16 * (D + 4)];
      acc[nt][e] = sum;
    }
}

// bf16 dQ kernel: a block per (b, h, tile of 64 query rows), a warp per
// 16 rows (a tile of one or two 16-row groups splits their keys over the
// four warps).  Sweep 1: dP = dO V^T a 16-key chunk at a time, the keep bits,
// Delta_i = sum_j dp_ij p_ij (fp32, from the saved p); sweep 2: dP again,
// dS = p o (dp - Delta) in bf16 hi + lo, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32, D <= 64 ? 3 : 2)
    packed_attention_bwd_dq_mma_kernel(BwdArgs a, float* delta, int vec) {
  constexpr int S = D + 8, KS = D / 16, T = kBwdTile;
  constexpr int SB = 2 * T * S + T * kPStride;   // a buffer: V, K, p
  const int Lq = a.Lq, Lk = a.Lk;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.y * T, nq = min(T, Lq - q0);
  const int n_tiles = (Lk + T - 1) / T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gs = reinterpret_cast<bf16*>(smem_raw);    // [T][S] dO
  bf16* bufs = gs + T * S;
  auto vbuf = [&](int buf) { return bufs + buf * SB; };            // [T][S]
  auto kbuf = [&](int buf) { return bufs + buf * SB + T * S; };    // [T][S]
  auto pbuf = [&](int buf) { return bufs + buf * SB + 2 * T * S; };

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_bs + h * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_bs + h * D;
  const bf16* ph = static_cast<const bf16*>(a.p) +
                   static_cast<long long>(bh) * Lq * Lk;
  const bf16* p_rows = ph + static_cast<long long>(q0) * Lk;
  stage_rows<D>(static_cast<const bf16*>(a.dout) + b * a.do_bs + h * D +
                    static_cast<long long>(q0) * a.do_rs,
                a.do_rs, nq, T, vec & 8, gs);
  // Step s < n_tiles is sweep 1's tile s (V and p), the rest sweep 2's
  // tile s - n_tiles (V, K and p), each into buffer s & 1.  With one tile,
  // step 0 brings all three and sweep 2 reads them again.  Every step
  // commits a group, empty past the end, so "all but the newest group" is
  // always the step being consumed.
  auto issue = [&](int s) {
    if (s < 2 * n_tiles && (n_tiles > 1 || s == 0)) {
      const int buf = s & 1, j0 = (s < n_tiles ? s : s - n_tiles) * T;
      const int nk = min(T, Lk - j0), nk_pad = round16(nk);
      stage_rows<D>(vb + static_cast<long long>(j0) * a.v_rs, a.v_rs, nk,
                    nk_pad, vec & 4, vbuf(buf));
      if (s >= n_tiles || n_tiles == 1)
        stage_rows<D>(kb + static_cast<long long>(j0) * a.k_rs, a.k_rs, nk,
                      nk_pad, vec & 2, kbuf(buf));
      stage_p_tile(p_rows + j0, Lk, nq, nk, pbuf(buf));
    }
    cp_async_commit();
  };
  issue(0);   // with dO
  issue(1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // warp w takes the tile's 16-row group w / split and every split-th
  // 16-key chunk from w % split: a tile of one or two groups (a tail, or
  // a short query) spreads its keys over the warps instead of walking
  // them on one, and the parts combine in a fixed order below
  const int split = bwd_split(nq, Lk), part = warp % split;
  const int r0 = (warp / split) * 16;        // the warp's rows in the tile
  const bool active = r0 < nq;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const bool drop = a.rate > 0.f;
  const uint32_t thr = keep_threshold(a.rate);
  const int lk8 = static_cast<int>(Lk & 7);
  uint32_t gf[KS][4];

  // dp of the warp's 16 rows and keys [16 c, + 16) of buffer buf's tile
  // (C layout), and the saved p of each element
  auto dp_chunk = [&](int buf, int c, const bf16* pt, int sh0,
                      float (&x)[2][4], float (&pv)[2][4]) {
    mma_abt<D>(gf, vbuf(buf), 16 * c, x);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pv[n][e] = p_tile_at(pt, sh0, lk8, r0 + g + 8 * (e >> 1),
                             16 * c + 8 * n + 2 * t + (e & 1));
  };
  // the chunk's keep bits (bit 4 n + e), 0 where p is 0: a zero p makes
  // every term of its element exactly 0 whatever the bit (tile padding is
  // zero too), so a chunk of the warp without a nonzero p (a key segment
  // its rows do not attend) draws nothing.  Otherwise all eight draws run
  // unconditionally, eight independent chains the compiler interleaves.
  auto draw = [&](int j0, int c, const float (&pv)[2][4]) {
    bool any = false;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) any |= pv[n][e] != 0.f;
    uint32_t m = 0;
    if (!__any_sync(0xffffffffu, any)) return m;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool kp = dropout_keep_thr(
            a.key, b, h, row[e >> 1], j0 + 16 * c + 8 * n + 2 * t + (e & 1),
            thr);
        m |= (kp && pv[n][e] != 0.f ? 1u : 0u) << (4 * n + e);
      }
    return m;
  };
  auto apply = [&](uint32_t m, float (&x)[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[n][e] = (m >> (4 * n + e)) & 1u ? x[n][e] * a.keep_scale : 0.f;
  };
  // sweep 1 keeps the keep bits of the first kBitTiles tiles, 8 bits a
  // chunk and 32 a tile, in registers for sweep 2, whose elements are the
  // same thread's: a fixed 4 words a thread whatever Lk, and past them
  // sweep 2 draws again
  uint32_t kc[kBitTiles];
#pragma unroll
  for (int u = 0; u < kBitTiles; ++u) kc[u] = 0u;

  float dsum[2] = {0.f, 0.f};
  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    if (s == 0) load_a<D>(gs, r0, gf);
    const int buf = s & 1, j0 = s * T;
    const int chunks = (min(T, Lk - j0) + 15) / 16;
    const bf16* pt = pbuf(buf);
    const int sh0 = chunk_shift(p_rows + j0);
    for (int c = part; active && c < chunks; c += split) {
      float x[2][4], pv[2][4];
      dp_chunk(buf, c, pt, sh0, x, pv);
      if (drop) {
        const uint32_t m = draw(j0, c, pv);
#pragma unroll
        for (int u = 0; u < kBitTiles; ++u)
          if (u == s) kc[u] |= m << (8 * c);
        apply(m, x);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            dsum[r] = fmaf(x[n][2 * r + k], pv[n][2 * r + k], dsum[r]);
    }
    __syncthreads();
    issue(s + 2);
  }
  // the quad's four threads hold the row's columns; the butterfly is
  // symmetric, so all four end with the same bits
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
  }
  if (split > 1) {   // the parts' sums, added in part order (dO's tile is
                     // free: every warp has its fragments)
    float* red = reinterpret_cast<float*>(gs);     // [4][16]
    if (t == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) red[warp * 16 + g + 8 * r] = dsum[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dsum[r] = 0.f;
#pragma unroll
      for (int k = 0; k < kBwdWarps; ++k)
        if (k < split) dsum[r] += red[(warp - part + k) * 16 + g + 8 * r];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (t == 0 && part == 0 && row[r] < Lq)
      delta[static_cast<long long>(bh) * Lq + row[r]] = dsum[r];

  float dq[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
  for (int s = n_tiles; s < 2 * n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int tile = s - n_tiles, buf = n_tiles == 1 ? 0 : s & 1;
    const int j0 = tile * T, chunks = (min(T, Lk - j0) + 15) / 16;
    const bf16* pt = pbuf(buf);
    const int sh0 = chunk_shift(p_rows + j0);
    uint32_t cached = 0;
#pragma unroll
    for (int u = 0; u < kBitTiles; ++u)
      if (u == tile) cached = kc[u];
    for (int c = part; active && c < chunks; c += split) {
      float x[2][4], pv[2][4];
      dp_chunk(buf, c, pt, sh0, x, pv);
      if (drop)
        apply(tile < kBitTiles ? (cached >> (8 * c)) & 0xffu
                               : draw(j0, c, pv),
              x);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[n][e] = pv[n][e] * (x[n][e] - dsum[e >> 1]);
      uint32_t hi[4], lo[4];
      c_to_a(x, hi, lo);
      mma_ay<D>(hi, lo, true, kbuf(buf), 16 * c, dq);
    }
    __syncthreads();
    issue(s + 2);
  }
  cp_async_wait<0>();
  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.dq_bs + h * D;
  if (split == 1) {
    if (active) store_rows<D>(dq, a.scale, dqb, a.dq_rs, row[0], Lq);
    return;
  }
  // the parts' partial dQ, summed in part order by the group's first warp
  // (the stage buffers are free: every tile has been used)
  float* obuf = reinterpret_cast<float*>(bufs);    // [4][16][D + 4]
  combine_parts<D>(dq, obuf, warp, part, split);
  if (active && part == 0)
    store_rows<D>(dq, a.scale, dqb, a.dq_rs, row[0], Lq);
}

// bf16 dK/dV kernel: a block per (b, h, tile of 64 keys), a warp per 16
// keys (a tile of one or two 16-key groups splits their query chunks over
// the four warps), V's A fragments loaded once; query tiles of Q, dO, p and Delta
// stream through in order.  A 16-query chunk: dP^T = V dO^T; pd^T and
// dS^T from the saved p read transposed, the keep bits and Delta; dV +=
// pd^T dO, dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32, D <= 64 ? 3 : 2)
    packed_attention_bwd_dkv_mma_kernel(BwdArgs a, const float* delta,
                                        int vec) {
  constexpr int S = D + 8, KS = D / 16, T = kBwdTile;
  constexpr int SB = 2 * T * S + T * kPStride;   // a buffer: Q, dO, p
  const int Lq = a.Lq, Lk = a.Lk;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int k0 = blockIdx.y * T, nk = min(T, Lk - k0);
  const int n_tiles = (Lq + T - 1) / T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* vs = reinterpret_cast<bf16*>(smem_raw);    // [T][S] V
  bf16* bufs = vs + T * S;
  float* dls = reinterpret_cast<float*>(bufs + 2 * SB);   // [2][T] Delta
  auto qbuf = [&](int buf) { return bufs + buf * SB; };            // [T][S]
  auto gbuf = [&](int buf) { return bufs + buf * SB + T * S; };    // [T][S]
  auto pbuf = [&](int buf) { return bufs + buf * SB + 2 * T * S; };

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_bs + h * D;
  const bf16* gb = static_cast<const bf16*>(a.dout) + b * a.do_bs + h * D;
  const bf16* ph = static_cast<const bf16*>(a.p) +
                   static_cast<long long>(bh) * Lq * Lk;
  const float* dlh = delta + static_cast<long long>(bh) * Lq;
  stage_rows<D>(static_cast<const bf16*>(a.v) + b * a.v_bs + h * D +
                    static_cast<long long>(k0) * a.v_rs,
                a.v_rs, nk, T, vec & 4, vs);
  auto issue = [&](int s) {
    if (s < n_tiles) {
      const int buf = s & 1, i0 = s * T;
      const int nq = min(T, Lq - i0), nq_pad = round16(nq);
      stage_rows<D>(qb + static_cast<long long>(i0) * a.q_rs, a.q_rs, nq,
                    nq_pad, vec & 1, qbuf(buf));
      stage_rows<D>(gb + static_cast<long long>(i0) * a.do_rs, a.do_rs, nq,
                    nq_pad, vec & 8, gbuf(buf));
      stage_p_tile(ph + static_cast<long long>(i0) * Lk + k0, Lk, nq, nk,
                   pbuf(buf));
      for (int e = threadIdx.x; e < T; e += blockDim.x)
        cp_async4(dls + buf * T + e, e < nq ? dlh + i0 + e : dlh, e < nq);
    }
    cp_async_commit();
  };
  issue(0);   // with V
  issue(1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // a tile of one or two 16-key groups splits their query chunks over
  // the warps, as the dQ kernel splits its keys
  const int split = bwd_split(nk, Lq), part = warp % split;
  const int kr0 = (warp / split) * 16;       // the warp's keys in the tile
  const bool active = kr0 < nk;
  const bool drop = a.rate > 0.f;
  const uint32_t thr = keep_threshold(a.rate);
  const int lk8 = static_cast<int>(Lk & 7);
  uint32_t vf[KS][4];
  float accv[D / 8][4], acck[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) accv[nt][e] = acck[nt][e] = 0.f;

  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    if (s == 0) load_a<D>(vs, kr0, vf);
    const int buf = s & 1, i0 = s * T;
    const int chunks = (min(T, Lq - i0) + 15) / 16;
    const bf16* pt = pbuf(buf);
    const float* dl = dls + buf * T;
    const int sh0 = chunk_shift(ph + static_cast<long long>(i0) * Lk + k0);
    for (int c = part; active && c < chunks; c += split) {
      float x[2][4], pd[2][4];
      mma_abt<D>(vf, gbuf(buf), 16 * c, x);   // dP^T: rows keys, cols queries
      // p^T of the chunk (query 16 c + 8 n + 2 t + (e & 1), key g + 8 (e >>
      // 1)); the keep bits drawn where p != 0 only, as in the dQ kernel
      bool any = false;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pd[n][e] = p_tile_at(pt, sh0, lk8, 16 * c + 8 * n + 2 * t + (e & 1),
                               kr0 + g + 8 * (e >> 1));
          any |= pd[n][e] != 0.f;
        }
      if (drop && __any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = pd[n][e];   // every draw runs: ILP
            const bool kp =
                dropout_keep_thr(a.key, b, h, i0 + 16 * c + 8 * n + 2 * t +
                                 (e & 1), k0 + kr0 + g + 8 * (e >> 1), thr) &&
                p != 0.f;
            x[n][e] = p * ((kp ? x[n][e] * a.keep_scale : 0.f) -
                           dl[16 * c + 8 * n + 2 * t + (e & 1)]);
            pd[n][e] = kp ? p * a.keep_scale : 0.f;
          }
      } else {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = pd[n][e];   // without dropout pd is p
            x[n][e] = p * ((drop ? 0.f : x[n][e]) -
                           dl[16 * c + 8 * n + 2 * t + (e & 1)]);
          }
      }
      uint32_t hi[4], lo[4];
      c_to_a(pd, hi, lo);   // without dropout p is bf16 and lo is 0
      mma_ay<D>(hi, lo, drop, gbuf(buf), 16 * c, accv);
      c_to_a(x, hi, lo);
      mma_ay<D>(hi, lo, true, qbuf(buf), 16 * c, acck);
    }
    __syncthreads();
    issue(s + 2);
  }
  cp_async_wait<0>();
  if (split > 1) {   // the parts' dV and dK, summed in part order
    float* obuf = reinterpret_cast<float*>(bufs);  // 2 x [4][16][D + 4]
    combine_parts<D>(accv, obuf, warp, part, split);
    combine_parts<D>(acck, obuf + kBwdWarps * 16 * (D + 4), warp, part,
                     split);
  }
  if (!active || part != 0) return;
  const int key0 = k0 + kr0 + g;
  store_rows<D>(accv, 1.f, static_cast<bf16*>(a.dv) + b * a.dv_bs + h * D,
                a.dv_rs, key0, Lk);
  store_rows<D>(acck, a.scale,
                static_cast<bf16*>(a.dk) + b * a.dk_bs + h * D, a.dk_rs,
                key0, Lk);
}

// Stage rows [0, n) of D fp32 columns (row stride rs) into dst rows of
// ``ds`` floats, rows n..n_pad zero; ``vec``: 16-byte copies (source
// rows and ds 16-byte aligned), else 4-byte ones.
template <int D>
__device__ void stage_rows_f32(const float* src, long long rs, int n,
                               int n_pad, int ds, bool vec, float* dst) {
  if (vec) {
    constexpr int C = D / 4;
    for (int e = threadIdx.x; e < n_pad * C; e += blockDim.x) {
      const int r = e / C, c = (e - r * C) * 4;
      cp_async16(dst + r * ds + c, r < n ? src + r * rs + c : src, r < n);
    }
    return;
  }
  for (int e = threadIdx.x; e < n_pad * D; e += blockDim.x) {
    const int r = e / D, c = e - r * D;
    cp_async4(dst + r * ds + c, r < n ? src + r * rs + c : src, r < n);
  }
}

// Stage the fp32 saved-p block rows [0, nr) x columns [0, nc) (row r at
// first + r * Lk) into dst[kBwdTile][kBwdTile], zero past nr and nc.
__device__ void stage_p_tile_f32(const float* first, long long Lk, int nr,
                                 int nc, float* dst) {
  constexpr int T = kBwdTile;
  for (int e = threadIdx.x; e < T * T; e += blockDim.x) {
    const int r = e / T, c = e - r * T;
    const bool ok = r < nr && c < nc;
    cp_async4(dst + e, ok ? first + r * Lk + c : first, ok);
  }
}

// dp[r][k] = x[r] . ys[lane + 32 k] for the RW rows of x (D floats apart,
// read broadcast) and the tile rows of ys (D + 1 floats apart).
template <int D, int RW>
__device__ __forceinline__ void dots_f32(const float* x, const float* ys,
                                         float (&dp)[RW][2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < RW; ++r) dp[r][0] = dp[r][1] = 0.f;
  const float* y0 = ys + lane * (D + 1);
  const float* y1 = ys + (lane + 32) * (D + 1);
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const float v0 = y0[c], v1 = y1[c];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float xv = x[r * D + c];
      dp[r][0] = fmaf(xv, v0, dp[r][0]);
      dp[r][1] = fmaf(xv, v1, dp[r][1]);
    }
  }
}

// acc[r][c] += sum_{y < ny} m[y * T + x0 + r] * ys[y * D + lane + 32 c]:
// the warp's RW output rows (columns x0.. of the T-wide tile m, read
// broadcast) and D / 32 channels a lane, summed in y order.
template <int D, int RW>
__device__ __forceinline__ void contract_f32(const float* m, int x0,
                                             const float* ys, int ny,
                                             float (&acc)[RW][D / 32]) {
  constexpr int DCH = D / 32, T = kBwdTile;
  const int lane = threadIdx.x & 31;
  for (int y = 0; y < ny; ++y) {
    float yv[DCH];
#pragma unroll
    for (int c = 0; c < DCH; ++c) yv[c] = ys[y * D + lane + 32 * c];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float mv = m[y * T + x0 + r];
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[r][c] = fmaf(mv, yv[c], acc[r][c]);
    }
  }
}

// fp32 dQ kernel: a block per (b, h, tile of 64 query rows), a warp per 8
// rows.  A lane forms dp of its warp's rows with keys lane and lane + 32 of
// each tile (sweep 1: Delta, summed over the lane's keys in tile order and
// then over the warp by a symmetric butterfly; sweep 2: dS, written over p
// in shared memory), then dQ of its rows at channels lane + 32 c.
template <int D>
__global__ void __launch_bounds__(kF32BwdWarps * 32, D <= 64 ? 2 : 1)
    packed_attention_bwd_dq_kernel(BwdArgs a, float* delta, int vec) {
  constexpr int T = kBwdTile, DP = D + 1, RW = T / kF32BwdWarps;
  constexpr int DCH = D / 32;
  constexpr int SB = T * DP + T * D + T * T;   // a buffer: V, K, p
  const int Lq = a.Lq, Lk = a.Lk;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.y * T, nq = min(T, Lq - q0);
  const int n_tiles = (Lk + T - 1) / T;
  extern __shared__ __align__(16) float fsm[];
  float* gs = fsm;                                  // [T][D] dO
  float* bufs = gs + T * D;
  auto vbuf = [&](int buf) { return bufs + buf * SB; };              // [T][DP]
  auto kbuf = [&](int buf) { return bufs + buf * SB + T * DP; };     // [T][D]
  auto pbuf = [&](int buf) { return bufs + buf * SB + T * DP + T * D; };

  const float* kb = static_cast<const float*>(a.k) + b * a.k_bs + h * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_bs + h * D;
  const float* p_rows = static_cast<const float*>(a.p) +
                        (static_cast<long long>(bh) * Lq + q0) * Lk;
  stage_rows_f32<D>(static_cast<const float*>(a.dout) + b * a.do_bs +
                        h * D + static_cast<long long>(q0) * a.do_rs,
                    a.do_rs, nq, T, D, vec & 8, gs);
  // the steps of the bf16 dQ kernel
  auto issue = [&](int s) {
    if (s < 2 * n_tiles && (n_tiles > 1 || s == 0)) {
      const int buf = s & 1, j0 = (s < n_tiles ? s : s - n_tiles) * T;
      const int nk = min(T, Lk - j0);
      stage_rows_f32<D>(vb + static_cast<long long>(j0) * a.v_rs, a.v_rs,
                        nk, T, DP, false, vbuf(buf));
      if (s >= n_tiles || n_tiles == 1)
        stage_rows_f32<D>(kb + static_cast<long long>(j0) * a.k_rs, a.k_rs,
                          nk, T, D, vec & 2, kbuf(buf));
      stage_p_tile_f32(p_rows + j0, Lk, nq, nk, pbuf(buf));
    }
    cp_async_commit();
  };
  issue(0);   // with dO
  issue(1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * RW;                  // the warp's rows in the tile
  const bool drop = a.rate > 0.f;
  const uint32_t thr = keep_threshold(a.rate);
  // dp of the warp's rows and keys lane, lane + 32 of buffer buf's tile
  // j0, with the keep bits applied where p != 0 (as in the bf16 kernel: a
  // zero p makes its element's terms 0 whatever the bit)
  auto dp_tile = [&](int buf, int j0, float (&dp)[RW][2]) {
    dots_f32<D, RW>(gs + r0 * D, vbuf(buf), dp);
    if (!drop) return;
    const float* pt = pbuf(buf) + r0 * T + lane;
    bool any = false;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k) any |= pt[r * T + 32 * k] != 0.f;
    if (!__any_sync(0xffffffffu, any)) return;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const bool kp = dropout_keep_thr(a.key, b, h, q0 + r0 + r,
                                         j0 + lane + 32 * k, thr);
        if (pt[r * T + 32 * k] != 0.f)
          dp[r][k] = kp ? dp[r][k] * a.keep_scale : 0.f;
      }
  };

  float dsum[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) dsum[r] = 0.f;
  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int buf = s & 1;
    float dp[RW][2];
    dp_tile(buf, s * T, dp);
    const float* pt = pbuf(buf);
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        dsum[r] = fmaf(dp[r][k], pt[(r0 + r) * T + lane + 32 * k], dsum[r]);
    __syncthreads();
    issue(s + 2);
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    dsum[r] = warp_sum(dsum[r]);   // symmetric: every lane the same bits
    if (lane == 0 && q0 + r0 + r < Lq)
      delta[static_cast<long long>(bh) * Lq + q0 + r0 + r] = dsum[r];
  }

  float acc[RW][DCH];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;
  for (int s = n_tiles; s < 2 * n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int buf = n_tiles == 1 ? 0 : s & 1, j0 = (s - n_tiles) * T;
    float dp[RW][2];
    dp_tile(buf, j0, dp);
    float* pt = pbuf(buf);
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float& x = pt[(r0 + r) * T + lane + 32 * k];   // p, then dS
        x = x * (dp[r][k] - dsum[r]);
      }
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j], summed in key order
    const float* ks = kbuf(buf);
    const int nk = min(T, Lk - j0);
    for (int j = 0; j < nk; ++j) {
      float kv[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) kv[c] = ks[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float x = pt[(r0 + r) * T + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[r][c] = fmaf(x, kv[c], acc[r][c]);
      }
    }
    __syncthreads();
    issue(s + 2);
  }
  cp_async_wait<0>();
  float* dqb = static_cast<float*>(a.dq) + b * a.dq_bs + h * D;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = q0 + r0 + r;
    if (i < Lq)
#pragma unroll
      for (int c = 0; c < DCH; ++c)
        dqb[i * a.dq_rs + lane + 32 * c] = acc[r][c] * a.scale;
  }
}

// fp32 dK/dV kernel: a block per (b, h, tile of 64 keys), 8 warps; query
// tiles of Q, dO, p and Delta stream through in order.  A lane forms
// dP^T of keys lane and lane + 32 with its warp's 8 query rows, then pd
// and dS in registers; pd overwrites p in shared memory for dV, then dS
// overwrites pd for dK; the contractions give a warp 8 keys and a lane
// d / 32 channels, summed in query order.
template <int D>
__global__ void __launch_bounds__(kF32BwdWarps * 32, D <= 64 ? 2 : 1)
    packed_attention_bwd_dkv_kernel(BwdArgs a, const float* delta, int vec) {
  constexpr int T = kBwdTile, DP = D + 1, RW = T / kF32BwdWarps;
  constexpr int DCH = D / 32;
  constexpr int SB = 2 * T * D + T * T + T;   // a buffer: Q, dO, p, Delta
  const int Lq = a.Lq, Lk = a.Lk;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int k0 = blockIdx.y * T, nk = min(T, Lk - k0);
  const int n_tiles = (Lq + T - 1) / T;
  extern __shared__ __align__(16) float fsm[];
  float* vs = fsm;                                  // [T][DP] V
  float* bufs = vs + T * DP;
  auto qbuf = [&](int buf) { return bufs + buf * SB; };              // [T][D]
  auto gbuf = [&](int buf) { return bufs + buf * SB + T * D; };      // [T][D]
  auto pbuf = [&](int buf) { return bufs + buf * SB + 2 * T * D; };  // [T][T]
  auto dbuf = [&](int buf) { return bufs + buf * SB + 2 * T * D + T * T; };

  const float* qb = static_cast<const float*>(a.q) + b * a.q_bs + h * D;
  const float* gb = static_cast<const float*>(a.dout) + b * a.do_bs + h * D;
  const float* ph = static_cast<const float*>(a.p) +
                    static_cast<long long>(bh) * Lq * Lk;
  const float* dlh = delta + static_cast<long long>(bh) * Lq;
  stage_rows_f32<D>(static_cast<const float*>(a.v) + b * a.v_bs + h * D +
                        static_cast<long long>(k0) * a.v_rs,
                    a.v_rs, nk, T, DP, false, vs);
  auto issue = [&](int s) {
    if (s < n_tiles) {
      const int buf = s & 1, i0 = s * T, nq = min(T, Lq - i0);
      stage_rows_f32<D>(qb + static_cast<long long>(i0) * a.q_rs, a.q_rs, nq,
                        T, D, vec & 1, qbuf(buf));
      stage_rows_f32<D>(gb + static_cast<long long>(i0) * a.do_rs, a.do_rs,
                        nq, T, D, vec & 8, gbuf(buf));
      stage_p_tile_f32(ph + static_cast<long long>(i0) * Lk + k0, Lk, nq, nk,
                       pbuf(buf));
      for (int e = threadIdx.x; e < T; e += blockDim.x)
        cp_async4(dbuf(buf) + e, e < nq ? dlh + i0 + e : dlh, e < nq);
    }
    cp_async_commit();
  };
  issue(0);   // with V
  issue(1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * RW;   // the warp's query rows, then its keys
  const bool drop = a.rate > 0.f;
  const uint32_t thr = keep_threshold(a.rate);
  float accv[RW][DCH], acck[RW][DCH];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) accv[r][c] = acck[r][c] = 0.f;

  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int buf = s & 1, i0 = s * T, nq = min(T, Lq - i0);
    float* pt = pbuf(buf);
    const float* gt = gbuf(buf);
    const float* dl = dbuf(buf);
    float dp[RW][2];
    dots_f32<D, RW>(gt + r0 * D, vs, dp);   // dP[i][j] = dO_i . V_j
    // the keep bits where p != 0, as in the dQ kernel
    bool any = false;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        any |= pt[(r0 + r) * T + lane + 32 * k] != 0.f;
    const bool draws = drop && __any_sync(0xffffffffu, any);
    float ds[RW][2];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float& x = pt[(r0 + r) * T + lane + 32 * k];   // p, then pd
        const float p = x;
        float d = dp[r][k];
        if (drop) {
          const bool kp = draws &&
                          dropout_keep_thr(a.key, b, h, i0 + r0 + r,
                                           k0 + lane + 32 * k, thr) &&
                          p != 0.f;
          d = kp ? d * a.keep_scale : 0.f;
          x = kp ? p * a.keep_scale : 0.f;
        }
        ds[r][k] = p * (d - dl[r0 + r]);
      }
    __syncthreads();
    contract_f32<D, RW>(pt, r0, gt, nq, accv);   // dV[j] += pd[i][j] dO[i]
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        pt[(r0 + r) * T + lane + 32 * k] = ds[r][k];
    __syncthreads();
    contract_f32<D, RW>(pt, r0, qbuf(buf), nq, acck);   // dK[j] += dS Q
    __syncthreads();
    issue(s + 2);
  }
  cp_async_wait<0>();
  float* dvb = static_cast<float*>(a.dv) + b * a.dv_bs + h * D;
  float* dkb = static_cast<float*>(a.dk) + b * a.dk_bs + h * D;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int j = k0 + r0 + r;
    if (j < Lk)
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        dvb[j * a.dv_rs + lane + 32 * c] = accv[r][c];
        dkb[j * a.dk_rs + lane + 32 * c] = acck[r][c] * a.scale;
      }
  }
}

// Shared memory of the dQ and the dK/dV kernel: no term depends on Lq or
// Lk.
size_t bwd_smem_dq(int dtype, int D) {
  constexpr size_t T = kBwdTile;
  if (dtype == kBFloat16)
    return (T * (D + 8) + 2 * (2 * T * (D + 8) + T * kPStride)) *
           sizeof(bf16);
  return (T * D + 2 * (T * (D + 1) + T * D + T * T)) * sizeof(float);
}

size_t bwd_smem_dkv(int dtype, int D) {
  constexpr size_t T = kBwdTile;
  if (dtype == kBFloat16) return bwd_smem_dq(dtype, D) + 2 * T * sizeof(float);
  return (T * (D + 1) + 2 * (2 * T * D + T * T + T)) * sizeof(float);
}

bool rows_aligned16_f32(const void* p, long long bs, long long rs) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && bs % 4 == 0 &&
         rs % 4 == 0;
}

// fp32 forward (CUDA cores): a block per (b, h, tile of 64 query rows) of
// 8 warps; warp w owns rows w, w + 8, ..., w + 56 of the tile, so a short
// query spreads over the warps.  K (rows padded to d + 1 floats, so lanes
// reading different keys hit different banks), V and the key mask stream
// through shared memory in 64-key tiles by cp.async, the next tile in
// flight, with the bf16 kernel's steps (sweep 1's tiles from the block's
// own in segment mode).  A lane takes keys lane and lane + 32 of a tile for
// the scores, q read broadcast; pass 1 keeps each row's running max
// (warp-wide, a half tile at a time) and the lane's share of the sum;
// pass 2 forms p = exp(s - m) / l, writes it if asked, applies the keep
// bit where p != 0 and accumulates P.V with lanes over d, p passing
// through the warp's tile of shared memory.  Pass 2 skips a half tile (32
// keys) whose scores pass 1 found kSkipGap below its rows' running max,
// the bf16 kernel's rule.
constexpr int kF32FwdRows = 64;                 // rows of a block's tile
constexpr int kF32FwdRw = kF32FwdRows / kWarps;  // rows of a warp
constexpr int kF32KeyTile = 64;   // keys of a tile of the fp32 kernels

template <int D, bool SEG>
__global__ void __launch_bounds__(kWarps * 32)
    packed_attention_kernel(AttnArgs a, int vec) {
  constexpr int T = kF32KeyTile, DP = D + 1, RW = kF32FwdRw, DCH = D / 32;
  constexpr int SB = T * DP + T * D;     // floats of a buffer: K, V
  const int Lq = a.Lq, Lk = a.Lk;
  const int q0 = blockIdx.y * kF32FwdRows, nq = min(kF32FwdRows, Lq - q0);
  const int n_tiles = (Lk + T - 1) / T;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                             // [64][D]
  float* bufs = qs + kF32FwdRows * D;          // 2 x SB
  float* mbuf = bufs + 2 * SB;                 // [2][T] mask
  float* pws = mbuf + 2 * T;                   // [kWarps][RW][32]

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x - b * a.H;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_bs + h * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_bs + h * D;
  const float* mrow = static_cast<const float*>(a.mask) +
                      static_cast<long long>(b) * Lk;   // or int32 ids
  const int t_first = SEG && n_tiles > 0 ? (q0 / T) % n_tiles : 0;
  auto tile_of = [&](int s) {
    return s < n_tiles ? (t_first + s) % n_tiles : s - n_tiles;
  };
  auto buf_of = [&](int s) { return n_tiles == 1 ? 0 : s & 1; };
  auto issue = [&](int s) {
    if (s < 2 * n_tiles) {
      const int j0 = tile_of(s) * T, buf = buf_of(s);
      const int n = min(T, Lk - j0);
      float* kt = bufs + buf * SB;
      if (s < n_tiles || n_tiles > 1) {
        stage_rows_f32<D>(kb + j0 * a.k_rs, a.k_rs, n, T, DP, false, kt);
        for (int j = threadIdx.x; j < T; j += blockDim.x)
          cp_async4(mbuf + buf * T + j, mrow + j0 + min(j, n - 1), j < n);
      }
      if (s >= n_tiles)
        stage_rows_f32<D>(vb + j0 * a.v_rs, a.v_rs, n, T, D, vec & 4,
                          kt + T * DP);
    }
    cp_async_commit();
  };
  stage_rows_f32<D>(static_cast<const float*>(a.q) + b * a.q_bs + h * D +
                        q0 * a.q_rs,
                    a.q_rs, nq, kF32FwdRows, D, vec & 1, qs);
  issue(0);   // with Q
  issue(1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int shift = Lk - Lq;   // causal: row i attends no key j > i + shift
  bool real[RW];
  int sq[RW], last[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = q0 + warp + kWarps * r;
    real[r] = i < Lq;
    sq[r] = -1;
    if (SEG && real[r])
      sq[r] = static_cast<const int*>(a.mask)[static_cast<long long>(b) *
                                              Lk + i];
    last[r] = a.causal ? i + shift : Lk;   // last causal key
  }

  // the masked, scaled scores of rows r and key jh0 + lane (half hh of
  // buffer buf); -inf past Lk
  auto scores = [&](int buf, int hh, int jh0, float (&x)[RW]) {
    const float* kr = bufs + buf * SB + (32 * hh + lane) * DP;
#pragma unroll
    for (int r = 0; r < RW; ++r) x[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float kv = kr[c];
#pragma unroll
      for (int r = 0; r < RW; ++r)
        x[r] = fmaf(qs[(warp + kWarps * r) * D + c], kv, x[r]);
    }
    const int j = jh0 + lane;
    const float mv = mbuf[buf * T + 32 * hh + lane];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      float s = x[r] * a.scale;
      if (SEG) {
        s += (__float_as_int(mv) == sq[r] && sq[r] >= 0) ? 0.f : kNegInf;
      } else {
        s += (1.f - mv) * kNegInf;
        if (j > last[r]) s += kNegInf;
      }
      x[r] = j < Lk ? s : -INFINITY;
    }
  };

  // pass 1 marks, in ``skip`` (bit 2 tile + half, the first 64 halves),
  // every half whose scores all lie kSkipGap or more below the running
  // max of their rows (the bf16 kernel's rule)
  uint32_t skip[2] = {0u, 0u};
  float m[RW], ls[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = -INFINITY;
    ls[r] = 0.f;
  }
  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int buf = buf_of(s), tj = tile_of(s) * T;
    for (int hh = 0; hh < 2 && tj + 32 * hh < Lk; ++hh) {
      float x[RW];
      scores(buf, hh, tj + 32 * hh, x);
      bool low = true;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float mh = warp_max(x[r]);
        const float mn = fmaxf(m[r], mh);
        ls[r] = ls[r] * expf(m[r] - mn) + expf(x[r] - mn);
        m[r] = mn;
        low &= !real[r] || mh <= mn - kSkipGap;
      }
      const int bit = 2 * tile_of(s) + hh;
      if (low && bit < 64) skip[bit >> 5] |= 1u << (bit & 31);
    }
    __syncthreads();
    issue(s + 2);
  }
  float l[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) l[r] = warp_sum(ls[r]);

  float* pb = a.probs == nullptr
                  ? nullptr
                  : static_cast<float*>(a.probs) +
                        static_cast<long long>(blockIdx.x) * Lq * Lk;
  const bool drop = a.rate > 0.f;
  const uint32_t thr = keep_threshold(a.rate);
  float* pw = pws + warp * RW * 32;
  float acc[RW][DCH];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;
  for (int s = n_tiles; s < 2 * n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int buf = buf_of(s), tile = s - n_tiles, tj = tile * T;
    for (int hh = 0; hh < 2 && tj + 32 * hh < Lk; ++hh) {
      const int jh0 = tj + 32 * hh, nkh = min(32, Lk - jh0);
      const int j = jh0 + lane, bit = 2 * tile + hh;
      if (bit < 64 && ((skip[bit >> 5] >> (bit & 31)) & 1u)) {
        if (pb != nullptr && lane < nkh)
#pragma unroll
          for (int r = 0; r < RW; ++r)
            if (real[r])
              pb[static_cast<long long>(q0 + warp + kWarps * r) * Lk + j] =
                  0.f;
        continue;
      }
      float x[RW];
      scores(buf, hh, jh0, x);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = q0 + warp + kWarps * r;
        float p = expf(x[r] - m[r]) / l[r];
        if (pb != nullptr && real[r] && lane < nkh)
          pb[static_cast<long long>(i) * Lk + j] = p;
        if (drop && p != 0.f)
          p = dropout_keep_thr(a.key, b, h, i, j, thr) ? p * a.keep_scale
                                                       : 0.f;
        pw[r * 32 + lane] = p;
      }
      __syncwarp();
      const float* vt = bufs + buf * SB + T * DP + 32 * hh * D;
      for (int jj = 0; jj < nkh; ++jj) {
        float vv[DCH];
#pragma unroll
        for (int c = 0; c < DCH; ++c) vv[c] = vt[jj * D + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float p = pw[r * 32 + jj];
#pragma unroll
          for (int c = 0; c < DCH; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
      __syncwarp();
    }
    __syncthreads();
    issue(s + 2);
  }
  cp_async_wait<0>();
  float* ob = static_cast<float*>(a.out) + b * a.o_bs + h * D;
#pragma unroll
  for (int r = 0; r < RW; ++r)
    if (real[r])
#pragma unroll
      for (int c = 0; c < DCH; ++c)
        ob[(q0 + warp + kWarps * r) * a.o_rs + lane + 32 * c] = acc[r][c];
}

// Shared memory of the fp32 forward: no term depends on Lq or Lk.
size_t fwd_smem(int D) {
  const size_t T = kF32KeyTile;
  return sizeof(float) * (kF32FwdRows * D + 2 * (T * (D + 1) + T * D) +
                          2 * T + kWarps * kF32FwdRw * 32);
}

template <int D, bool SEG>
cudaError_t launch_fwd(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  const cudaError_t e = cudaFuncSetAttribute(
      packed_attention_kernel<D, SEG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int vec = (rows_aligned16_f32(a.q, a.q_bs, a.q_rs) ? 1 : 0) |
                  (rows_aligned16_f32(a.v, a.v_bs, a.v_rs) ? 4 : 0);
  const dim3 grid(a.B * a.H, (a.Lq + kF32FwdRows - 1) / kF32FwdRows);
  packed_attention_kernel<D, SEG>
      <<<grid, kWarps * 32, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

template <bool SEG>
cudaError_t fwd_dim(const AttnArgs& a, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_fwd<32, SEG>(a, s);
    case 64: return launch_fwd<64, SEG>(a, s);
    case 128: return launch_fwd<128, SEG>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t fwd_mode(const AttnArgs& a, int seg, int head_dim,
                     cudaStream_t s) {
  return seg ? fwd_dim<true>(a, head_dim, s)
             : fwd_dim<false>(a, head_dim, s);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  return e;
}

// The dQ kernel and then the dK/dV kernel on the stream.
template <int D>
cudaError_t launch_bwd(const BwdArgs& a, int dtype, float* delta,
                       cudaStream_t stream) {
  const bool bf = dtype == kBFloat16;
  auto aligned = [&](const void* p, long long bs, long long rs) {
    return bf ? rows_aligned16(p, bs, rs) : rows_aligned16_f32(p, bs, rs);
  };
  const int vec = (aligned(a.q, a.q_bs, a.q_rs) ? 1 : 0) |
                  (aligned(a.k, a.k_bs, a.k_rs) ? 2 : 0) |
                  (aligned(a.v, a.v_bs, a.v_rs) ? 4 : 0) |
                  (aligned(a.dout, a.do_bs, a.do_rs) ? 8 : 0);
  const size_t smem_dq = bwd_smem_dq(dtype, D);
  const size_t smem_dkv = bwd_smem_dkv(dtype, D);
  const dim3 grid_q(a.B * a.H, (a.Lq + kBwdTile - 1) / kBwdTile);
  const dim3 grid_k(a.B * a.H, (a.Lk + kBwdTile - 1) / kBwdTile);
  cudaError_t e;
  if (bf) {
    e = prepare(packed_attention_bwd_dq_mma_kernel<D>, smem_dq);
    if (e != cudaSuccess) return e;
    packed_attention_bwd_dq_mma_kernel<D>
        <<<grid_q, kBwdWarps * 32, smem_dq, stream>>>(a, delta, vec);
    if ((e = cudaGetLastError()) != cudaSuccess || a.Lk == 0) return e;
    e = prepare(packed_attention_bwd_dkv_mma_kernel<D>, smem_dkv);
    if (e != cudaSuccess) return e;
    packed_attention_bwd_dkv_mma_kernel<D>
        <<<grid_k, kBwdWarps * 32, smem_dkv, stream>>>(a, delta, vec);
    return cudaGetLastError();
  }
  e = prepare(packed_attention_bwd_dq_kernel<D>, smem_dq);
  if (e != cudaSuccess) return e;
  packed_attention_bwd_dq_kernel<D>
      <<<grid_q, kF32BwdWarps * 32, smem_dq, stream>>>(a, delta, vec);
  if ((e = cudaGetLastError()) != cudaSuccess || a.Lk == 0) return e;
  e = prepare(packed_attention_bwd_dkv_kernel<D>, smem_dkv);
  if (e != cudaSuccess) return e;
  packed_attention_bwd_dkv_kernel<D>
      <<<grid_k, kF32BwdWarps * 32, smem_dkv, stream>>>(a, delta, vec);
  return cudaGetLastError();
}

cudaError_t bwd_dim(const BwdArgs& a, int dtype, int head_dim, float* delta,
                    cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_bwd<32>(a, dtype, delta, s);
    case 64: return launch_bwd<64>(a, dtype, delta, s);
    case 128: return launch_bwd<128>(a, dtype, delta, s);
    default: return cudaErrorInvalidValue;
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
// Each dtype has one kernel, chosen in hero_mha_attention_fwd: bf16, the
// dtype of every timed path, takes mha_attention_mma_kernel on the tensor
// cores (at the end of the file); fp32, which only the checks and the fp32
// card-versus-CPU parity runs use, takes mha_attention_kernel below.
//
// Bound on the H100: at the decode step's shape (Lq = 1, Lk = 30, d = 64,
// B*H = 384 or 1152 rows) every row is 2*Lk*d reads for 4*Lk*d flops, so
// the ideal is memory-bound; the whole call reads 3 MB (greedy, bf16) to
// 9 MB (beam 3), one to three microseconds at the memory rate, and what
// it costs beyond that is latency: the launch and one round trip to
// memory.  At the component shape (B*H = 3072 heads of 56 x 56) q, k, v
// and out are 88 MB (26 us) for 2.5 GFLOP (2.5 us on the tensor cores):
// memory-bound too, if every key is read once per head and not once per
// query row.
//
// bf16 design (mha_attention_mma_kernel): the packed forward's tiles and
// products, with K, V and the mask streamed: a block per (b, h, tile of
// up to 64 query rows) of 4 warps, a warp per 16 rows, Q's fragments
// loaded once; K, V and the mask pass through shared memory in 64-key
// tiles by cp.async, the next tile in flight while this one is used, so
// shared memory does not grow with Lk and Lk has no ceiling.  Two sweeps
// as in the packed forward (S and the running max and sum; then S again,
// p final before P.V, the keep bit, O += P V with p in bf16 hi + lo).
// When the keys fit one tile (every path shape: 30, 31 and 56 keys) the
// sweeps share it, and K and V are both requested at the start, so a
// decode step costs one round trip to memory.  A short query tile (the
// decode step's single query of each of its 384 or 1152 heads) is bound by
// that latency, not by operations: a block per head, whose warps split
// the 16-key chunks and combine their (max, sum) and partial outputs in a
// fixed order (the packed forward's short tiles), puts a head's two
// chunks on two warps and keeps all 384 heads resident at once on the 132
// SMs.  Shared memory:
// (rows + 2 * keys) * d bf16 (keys = Lk rounded to 16 up to 64, else two
// 64-key buffers), the mask, and the parts' (max, sum): 20 KB at the
// decode step, 25 KB at the component shape.  ptxas (CUDA 12.8, sm_90a):
// 75, 96 and 202 registers at d = 32, 64 and 128, no spills (d <= 64
// capped for five blocks an SM).
//
// fp32 design (mha_attention_kernel): a warp per query row, kMhaWarps rows
// per block, K and V read from memory, nothing in shared memory but the
// row's q and a 64-key tile of its probabilities: pass 1 walks the key
// tiles for the running max (warp-wide) and the lane's share of the sum,
// lanes over keys; pass 2 forms the tile's scores again, p = exp(s - m) /
// l and the keep bits, and accumulates P.V with lanes over d, which reads
// each value row coalesced.  Shared memory is kMhaWarps * (d + 64) floats
// whatever Lk.

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

template <int DCH>
__global__ void __launch_bounds__(kMhaWarps * 32)
    mha_attention_kernel(MhaArgs a) {
  constexpr int D = DCH * 32, T = kF32KeyTile;
  const int Lk = a.Lk;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = smem + warp * (D + T);   // [D] the query row
  float* pw = qw + D;                  // [T] a key tile's probabilities

  const long long row = static_cast<long long>(blockIdx.x) * kMhaWarps + warp;
  if (row >= static_cast<long long>(a.B) * a.H * a.Lq) return;
  const int i = static_cast<int>(row % a.Lq);
  const int h = static_cast<int>((row / a.Lq) % a.H);
  const int b = static_cast<int>(row / (static_cast<long long>(a.Lq) * a.H));
  const float* qr = static_cast<const float*>(a.q) + b * a.q_bs +
                    h * a.q_hs + i * a.q_rs;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_bs + h * a.k_hs;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_bs + h * a.v_hs;
  const float* mr = a.mask + b * a.m_bs;
  float* orow = static_cast<float*>(a.out) + row * D;
  const int last = a.causal ? i + (Lk - a.Lq) : Lk;  // last causal key

#pragma unroll
  for (int c = 0; c < DCH; ++c)
    qw[lane + 32 * c] = qr[lane + 32 * c];
  __syncwarp();

  // the masked, scaled scores of keys j0 + lane and j0 + lane + 32; -inf
  // past Lk
  auto scores = [&](int j0, float (&s)[2]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = j0 + lane + 32 * k;
      s[k] = -INFINITY;
      if (j >= Lk) continue;
      const float* kr = kb + j * a.k_rs;
      float acc = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) acc = fmaf(qw[c], kr[c], acc);
      float x = acc * a.scale;
      x += (1.f - mr[j]) * kNegInf;
      if (j > last) x += kNegInf;
      s[k] = x;
    }
  };
  // pass 1: the running max (warp-wide, a tile at a time) and the lane's
  // share of the sum
  float mx = -INFINITY, ls = 0.f;
  for (int j0 = 0; j0 < Lk; j0 += T) {
    float s[2];
    scores(j0, s);
    const float mn = fmaxf(mx, warp_max(fmaxf(s[0], s[1])));
    ls = ls * expf(mx - mn) + expf(s[0] - mn) + expf(s[1] - mn);
    mx = mn;
  }
  const float sum = warp_sum(ls);
  // pass 2: p = exp(s - m) / l through the warp's tile, then P.V with
  // lanes over d, each value row read coalesced
  const bool drop = a.rate > 0.f;
  float acc[DCH];
#pragma unroll
  for (int c = 0; c < DCH; ++c) acc[c] = 0.f;
  for (int j0 = 0; j0 < Lk; j0 += T) {
    float s[2];
    scores(j0, s);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = j0 + lane + 32 * k;
      float p = expf(s[k] - mx) / sum;
      if (drop && j < Lk)
        p = dropout_keep(a.key, b, h, i, j, a.rate) ? p * a.keep_scale : 0.f;
      pw[lane + 32 * k] = p;
    }
    __syncwarp();
    const int n = min(T, Lk - j0);
    for (int j = 0; j < n; ++j) {
      const float p = pw[j];
      const float* vr = vb + (j0 + j) * a.v_rs;
#pragma unroll
      for (int c = 0; c < DCH; ++c)
        acc[c] = fmaf(p, vr[lane + 32 * c], acc[c]);
    }
    __syncwarp();
  }
#pragma unroll
  for (int c = 0; c < DCH; ++c) orow[lane + 32 * c] = acc[c];
}

size_t mha_smem(int D) {
  return sizeof(float) * kMhaWarps * (static_cast<size_t>(D) + kF32KeyTile);
}

template <int DCH>
cudaError_t launch_mha(const MhaArgs& a, cudaStream_t stream) {
  constexpr int D = DCH * 32;
  const size_t smem = mha_smem(D);
  const long long rows = static_cast<long long>(a.B) * a.H * a.Lq;
  const long long blocks = (rows + kMhaWarps - 1) / kMhaWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mha_attention_kernel<DCH><<<static_cast<unsigned>(blocks),
                              kMhaWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t mha_dim(const MhaArgs& a, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_mha<1>(a, s);
    case 64: return launch_mha<2>(a, s);
    case 128: return launch_mha<4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// head-major attention backward
// ---------------------------------------------------------------------------
//
// Replaces the Pallas kernel hero_tpu/ops/attention.py _bwd_kernel (v2,
// :138, pallas_call at :232), the backward of multi_head_attention.  The
// forward saves no probabilities, so the backward recomputes them from q
// and k, with the forward's mask, causal bias and scale (the same fp32
// arithmetic, in the same order, as mha_attention_kernel), and then
// forms what the saved-probabilities backward above does:
//   pd = drop(p)          dv = pd^T . do
//   dp = drop(do . v^T)   ds = p o (dp - rowsum(dp o p))
//   dq = ds . k * scale   dk = ds^T . q * scale
// with the forward's Philox bits for (seed, b, h, i, j) regenerated.  q,
// k, v and do are read through batch, head and row strides; dq, dk, dv
// are contiguous (B, H, L, d).
//
// Each dtype has a pair of kernels, chosen in hero_mha_attention_bwd and
// launched in turn (a dQ kernel, then a dK/dV kernel; the design is at
// the pair, after the bf16 head-major forward): bf16 takes
// mha_attention_bwd_dq_mma_kernel and mha_attention_bwd_dkv_mma_kernel on
// the tensor cores, fp32 (checks and parity runs only)
// mha_attention_bwd_dq_kernel and mha_attention_bwd_dkv_kernel.  Shared
// memory does not depend on Lq or Lk: every length is computed.
//
// Bound on the H100: at the component shape (B*H = 3072 heads of
// 56 x 56, d = 64) each head reads q, k, v, do and writes dq, dk, dv
// (7 * 56 * 64 elements: 154 MB, 46 us) for ~10 * 56^2 * 64 flops (6.2
// GFLOP, 6 us on the tensor cores): memory-bound, as the forward is, once
// the products leave the CUDA cores.

struct MhaBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* mask;  // (B, Lk) validity, unit stride over keys
  void* dq;           // contiguous (B, H, Lq, d)
  void* dk;           // contiguous (B, H, Lk, d)
  void* dv;           // contiguous (B, H, Lk, d)
  int B, H, Lq, Lk, causal;
  long long q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs;
  long long do_bs, do_hs, do_rs, m_bs;
  float scale, rate, keep_scale;
  PhiloxKey key;
};

// ---------------------------------------------------------------------------
// bf16 head-major attention on the tensor cores (forward and backward)
// ---------------------------------------------------------------------------
//
// The products are the packed kernels' (mma.sync m16n8k16, fp32
// accumulation; the forward's p split into bf16 hi + lo, the backward's
// pd and dS into three bf16 parts) on swizzled tiles (tile_off), kept
// unpadded in shared memory.  Tile padding (keys or
// queries past Lk or Lq, up to a multiple of 16) is zero rows, and a
// padded key scores -inf, so its probability is exactly 0.

// (x0, x1) = hi + mid + lo, three bf16 pairs: the fp32 values to ~2^-26
// relative (hi + lo leaves up to 2^-17).
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float r0 = x0 - __uint_as_float(hi << 16);
  const float r1 = x1 - __uint_as_float(hi & 0xffff0000u);
  mid = pack_bf16(r0, r1);
  lo = pack_bf16(r0 - __uint_as_float(mid << 16),
                 r1 - __uint_as_float(mid & 0xffff0000u));
}

// acc += A . Y[y0:y0+16, :] for a 16 x 16 fp32 C tile pair ``c`` split
// into three bf16 A fragments, smallest first: the backward's dS . K,
// PD^T . dO and dS^T . Q.
template <int D>
__device__ __forceinline__ void mma_ay3(const float (&c)[2][4],
                                        const bf16* ys, int y0,
                                        float (&acc)[D / 8][4]) {
  uint32_t hi[4], mid[4], lo[4];
  split3_bf16(c[0][0], c[0][1], hi[0], mid[0], lo[0]);
  split3_bf16(c[0][2], c[0][3], hi[1], mid[1], lo[1]);
  split3_bf16(c[1][0], c[1][1], hi[2], mid[2], lo[2]);
  split3_bf16(c[1][2], c[1][3], hi[3], mid[3], lo[3]);
  const int lane = threadIdx.x & 31;
  const int r = y0 + (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 16) {
    uint32_t b[4];
    ldsm_x4_trans(b, ys + tile_off<D, true>(r, c0 + 8 * half));
    mma_bf16(acc[c0 / 8], lo, b[0], b[1]);
    mma_bf16(acc[c0 / 8 + 1], lo, b[2], b[3]);
    mma_bf16(acc[c0 / 8], mid, b[0], b[1]);
    mma_bf16(acc[c0 / 8 + 1], mid, b[2], b[3]);
    mma_bf16(acc[c0 / 8], hi, b[0], b[1]);
    mma_bf16(acc[c0 / 8 + 1], hi, b[2], b[3]);
  }
}

bool rows_aligned16(const void* p, long long bs, long long hs,
                    long long rs) {
  return rows_aligned16(p, bs, rs) && hs % 8 == 0;
}

constexpr int kMhaKeyTile = 64;  // keys of a streamed K/V tile

// Keys a K/V buffer holds: all of them, rounded to 16, when they fit one
// tile (both sweeps read that one), else a 64-key tile of the stream.
__host__ __device__ inline int mha_key_tile(int Lk) {
  return Lk <= kMhaKeyTile ? round16(Lk) : kMhaKeyTile;
}

// K/V buffers: one when the keys fit a tile, else two (double buffering).
__host__ __device__ inline int mha_stages(int Lk) {
  return Lk <= kMhaKeyTile ? 1 : 2;
}

// Bytes of the K/V region: the buffers, or, once the last tile is done,
// a short query tile's key parts' partial outputs ([4][16][D + 4] fp32).
__host__ __device__ inline size_t mha_kv_bytes(int Lq, int Lk, int D) {
  const size_t tiles = static_cast<size_t>(mha_stages(Lk)) * 2 *
                       mha_key_tile(Lk) * D * sizeof(bf16);
  const size_t parts = tc_fwd_split(tc_fwd_rows(Lq)) > 1
                           ? static_cast<size_t>(kTcFwdWarps) * 16 *
                                 (D + 4) * sizeof(float)
                           : 0;
  return tiles > parts ? tiles : parts;
}

// Forward: a block per (b, h, tile of up to 64 query rows), a warp per 16
// rows (a short tile's warps split the key chunks); K, V and the mask
// stream through shared memory in 64-key tiles by cp.async, the next
// tile in flight while this one is used.  Sweep 1 forms S = Q K^T and the
// running row max and sum; sweep 2 forms S again, p = exp(s - m) / l,
// applies the keep bit of (b, h, i, j) and accumulates O += P V.  At
// d <= 64 five blocks share an SM (at most 96 registers a thread), so the
// beam step's 1152 heads run in two waves.
template <int D>
__global__ void __launch_bounds__(kTcFwdWarps * 32, D <= 64 ? 5 : 1)
    mha_attention_mma_kernel(MhaArgs a, int vec) {
  constexpr int KS = D / 16;
  const int Lq = a.Lq, Lk = a.Lk;
  const int rows = tc_fwd_rows(Lq), q_tiles = (Lq + rows - 1) / rows;
  const int head = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - head * q_tiles) * rows;
  const int kt = mha_key_tile(Lk);
  const int n_tiles = (Lk + kMhaKeyTile - 1) / kMhaKeyTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                // [rows][D]
  unsigned char* kv = smem_raw + rows * D * sizeof(bf16);       // K/V tiles
  float* mraw = reinterpret_cast<float*>(kv + mha_kv_bytes(Lq, Lk, D));
  float* mlbuf = mraw + mha_stages(Lk) * kt;                   // [4][16][2]
  float* obuf = reinterpret_cast<float*>(kv);            // [4][16][D + 4]

  const int b = head / a.H, h = head - b * a.H;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_bs + h * a.k_hs;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_bs + h * a.v_hs;
  const float* mb = a.mask + b * a.m_bs;
  auto kbuf = [&](int buf) {   // [kt][D] K, then [kt][D] V
    return reinterpret_cast<bf16*>(kv) + buf * 2 * kt * D;
  };
  // Step s of the stream: s < n_tiles is sweep 1's tile s (K and the
  // mask), the rest sweep 2's tile s - n_tiles (K, the mask and V).  With
  // one tile, step 0 brings K and step 1 only V, so both are in flight
  // from the start and sweep 2 reads step 0's K.  Every step commits a
  // group, empty past the end, so "all but the newest group" is always
  // the step being consumed.
  auto issue = [&](int s) {
    if (s < 2 * n_tiles) {
      const int j0 = (s < n_tiles ? s : s - n_tiles) * kMhaKeyTile;
      const int buf = n_tiles == 1 ? 0 : s & 1;
      const int n = min(kMhaKeyTile, Lk - j0), n_pad = round16(n);
      if (s < n_tiles || n_tiles > 1) {
        stage_rows<D, true>(kb + j0 * a.k_rs, a.k_rs, n, n_pad, vec & 2,
                            kbuf(buf));
        for (int j = threadIdx.x; j < n_pad; j += blockDim.x)
          cp_async4(mraw + buf * kt + j, mb + j0 + min(j, n - 1), j < n);
      }
      if (s >= n_tiles)
        stage_rows<D, true>(vb + j0 * a.v_rs, a.v_rs, n, n_pad, vec & 4,
                            kbuf(buf) + kt * D);
    }
    cp_async_commit();
  };
  stage_rows<D, true>(static_cast<const bf16*>(a.q) + b * a.q_bs +
                          h * a.q_hs + q0 * a.q_rs,
                      a.q_rs, min(Lq - q0, rows), rows, vec & 1, qs);
  issue(0);   // with Q
  issue(1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = tc_fwd_split(rows), part = warp % split;
  const int r0 = (warp / split) * 16;
  const bool active = r0 < rows && q0 + r0 < Lq;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  int last[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    last[r] = a.causal ? row[r] + (Lk - Lq) : Lk;   // last causal key
  uint32_t qf[KS][4];

  // the masked, scaled scores of chunk c (16 keys) of step s's tile; -inf
  // past Lk (the causal bias and the padding only where a chunk can hold
  // them)
  auto scores = [&](int s, int c, float (&x)[2][4]) {
    const int buf = n_tiles == 1 ? 0 : s & 1;
    const int j0 = (s < n_tiles ? s : s - n_tiles) * kMhaKeyTile + 16 * c;
    mma_abt<D, true>(qf, kbuf(buf), 16 * c, x);
    const float* mk = mraw + buf * kt + 16 * c;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 mm = *reinterpret_cast<const float2*>(mk + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[n][e] = x[n][e] * a.scale + (1.f - (e & 1 ? mm.y : mm.x)) * kNegInf;
    }
    if (a.causal && j0 + 15 > q0 + r0 + (Lk - Lq))
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * n + 2 * t + (e & 1) > last[e >> 1]) x[n][e] += kNegInf;
    if (j0 + 16 > Lk)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * n + 2 * t + (e & 1) >= Lk) x[n][e] = -INFINITY;
  };
  // 16-key chunks of step s's tile
  auto chunks = [&](int s) {
    const int j0 = (s < n_tiles ? s : s - n_tiles) * kMhaKeyTile;
    return (min(kMhaKeyTile, Lk - j0) + 15) / 16;
  };
  auto combine = [](float& m, float& l, float mo, float lo) {
    const float mn = fmaxf(m, mo);
    l = (m == -INFINITY ? 0.f : l * exp_fast(m - mn)) +
        (mo == -INFINITY ? 0.f : lo * exp_fast(mo - mn));
    m = mn;
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    if (s == 0 && active) load_a<D, true>(qs, r0, qf);
    for (int c = part; active && c < chunks(s); c += split) {
      float x[2][4];
      scores(s, c, x);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mc = fmaxf(fmaxf(x[0][2 * r], x[0][2 * r + 1]),
                               fmaxf(x[1][2 * r], x[1][2 * r + 1]));
        const float mn = fmaxf(m[r], mc);
        if (mn == -INFINITY) continue;   // only padded keys so far
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          sum += exp_fast(x[n][2 * r] - mn) + exp_fast(x[n][2 * r + 1] - mn);
        l[r] = l[r] * exp_fast(m[r] - mn) + sum;
        m[r] = mn;
      }
    }
    __syncthreads();
    issue(s + 2);
  }
  // the quad's four threads hold the row's columns; the butterfly is
  // symmetric, so all four end with the same bits
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1)
      combine(m[r], l[r], __shfl_xor_sync(0xffffffffu, m[r], o),
              __shfl_xor_sync(0xffffffffu, l[r], o));
  if (split > 1) {   // the tile's key parts, combined in part order
    if (t == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mlbuf[(warp * 16 + g + 8 * r) * 2] = m[r];
        mlbuf[(warp * 16 + g + 8 * r) * 2 + 1] = l[r];
      }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int k = 0; k < kTcFwdWarps; ++k)
        if (k < split) {
          const float* x = mlbuf + ((warp - part + k) * 16 + g + 8 * r) * 2;
          combine(m[r], l[r], x[0], x[1]);
        }
    }
  }

  const bool drop = a.rate > 0.f;
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  for (int s = n_tiles; s < 2 * n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int buf = n_tiles == 1 ? 0 : s & 1;
    for (int c = part; active && c < chunks(s); c += split) {
      const int j0 = (s - n_tiles) * kMhaKeyTile + 16 * c;
      float x[2][4];
      scores(s, c, x);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = row[r], j = j0 + 8 * n + 2 * t;
          float p0 = exp_fast(x[n][2 * r] - m[r]) * inv_l[r];
          float p1 = exp_fast(x[n][2 * r + 1] - m[r]) * inv_l[r];
          if (drop && i < Lq) {
            if (j < Lk)
              p0 = dropout_keep(a.key, b, h, i, j, a.rate) ? p0 * a.keep_scale
                                                           : 0.f;
            if (j + 1 < Lk)
              p1 = dropout_keep(a.key, b, h, i, j + 1, a.rate)
                       ? p1 * a.keep_scale
                       : 0.f;
          }
          x[n][2 * r] = p0;
          x[n][2 * r + 1] = p1;
        }
      uint32_t hi[4], lo[4];
      c_to_a(x, hi, lo);
      mma_ay<D, true>(hi, lo, true, kbuf(buf) + kt * D, 16 * c, o);
    }
    __syncthreads();
    issue(s + 2);
  }
  cp_async_wait<0>();

  bf16* ob = static_cast<bf16*>(a.out) + static_cast<long long>(head) * Lq * D;
  if (split == 1) {
    if (active) store_rows<D>(o, 1.f, ob, D, row[0], Lq);
    return;
  }
  // the key parts' partial outputs, summed in part order by the tile's
  // first warp (the K/V buffers are free: every tile has been used)
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      obuf[(warp * 16 + g + 8 * (e >> 1)) * (D + 4) + nt * 8 + 2 * t +
           (e & 1)] = o[nt][e];
  __syncthreads();
  if (!active || part != 0) return;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* x = obuf + (warp * 16 + g + 8 * (e >> 1)) * (D + 4) +
                       nt * 8 + 2 * t + (e & 1);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kTcFwdWarps; ++k)
        if (k < split) sum += x[k * 16 * (D + 4)];
      o[nt][e] = sum;
    }
  store_rows<D>(o, 1.f, ob, D, row[0], Lq);
}

size_t mha_mma_smem(int Lq, int Lk, int D) {
  return static_cast<size_t>(tc_fwd_rows(Lq)) * D * sizeof(bf16) +
         mha_kv_bytes(Lq, Lk, D) +
         static_cast<size_t>(mha_stages(Lk)) * mha_key_tile(Lk) *
             sizeof(float) +
         kTcFwdWarps * 16 * 2 * sizeof(float);
}

template <int D>
cudaError_t launch_mha_mma(const MhaArgs& a, cudaStream_t stream) {
  const size_t smem = mha_mma_smem(a.Lq, a.Lk, D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_attention_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int vec = (rows_aligned16(a.q, a.q_bs, a.q_hs, a.q_rs) ? 1 : 0) |
                  (rows_aligned16(a.k, a.k_bs, a.k_hs, a.k_rs) ? 2 : 0) |
                  (rows_aligned16(a.v, a.v_bs, a.v_hs, a.v_rs) ? 4 : 0);
  const int rows = tc_fwd_rows(a.Lq);
  const long long blocks =
      static_cast<long long>(a.B) * a.H * ((a.Lq + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mha_attention_mma_kernel<D><<<static_cast<unsigned>(blocks),
                                kTcFwdWarps * 32, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

cudaError_t mha_mma_dim(const MhaArgs& a, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_mha_mma<32>(a, s);
    case 64: return launch_mha_mma<64>(a, s);
    case 128: return launch_mha_mma<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// Backward (#5), both dtypes: two kernels in turn on the stream, #3's
// design with p recomputed from q, k, the mask and the rows' statistics
// instead of read saved; each streams through shared memory in 64-row
// tiles, so shared memory does not grow with Lq or Lk.
//   1. dQ: a block per (b, h, tile of 64 query rows), Q's and dO's tiles
//      staged once; K, V and the mask pass through shared memory in 64-key
//      tiles by cp.async, the next tile in flight.  Sweep 1 forms
//      S = Q K^T and dP = dO V^T, applies the keep bits and keeps the
//      running row max m, sum l and u = sum_j exp(s_j - m) dp_j, rescaled
//      with m, so Delta = u / l = sum_j dp_j p_j in fp32 (not dO . O)
//      without a third sweep; sweep 2 forms p = exp(s - m) / l and
//      dS = p o (dp - Delta) again and accumulates dQ = dS K.  m, 1 / l and
//      Delta go to a (B, H, Lq, 3) fp32 scratch (not lse = m + log l,
//      which a row no key may attend rounds to the grid of |m| ~ 2e4,
//      moving its p by up to 0.1%).
//   2. dK and dV: a block per (b, h, tile of 64 keys), K's, V's and the
//      mask's tiles staged once; tiles of 64 query rows of Q, dO and the
//      scratch stream through in order: P^T = exp(K Q^T - m) / l,
//      dP^T = V dO^T, dV += PD^T dO, dK += dS^T Q * scale.
// Every gradient row is summed by one warp (or, for a tile of one or two
// 16-row groups, by parts combined in a fixed order) and written once: no
// atomics, the same bits from run to run.  The keep bits are drawn from
// Philox in each kernel: the dQ kernel's sweep 1 keeps those of the first
// 256 keys in 4 registers a thread for sweep 2, and sweep 2 (past them)
// and the dK/dV kernel draw only where the warp holds a nonzero p.
// bf16 (tensor cores): 4 warps, a warp per 16 rows, products on mma.sync
// with fp32 accumulation; pd and dS meet the tensor cores as three bf16
// parts, hi + mid + lo (~2^-26 relative): with hi + lo alone (up to 2^-17)
// about one gradient element in 2^8 rounds to the other bf16 neighbour of
// the plain version's, and at the component shape's 11M elements of each
// gradient such a flip lands among the largest ones (an 8-16 dK or dV
// element one bf16 ulp, 0.0625, off); with three parts the flips are as
// rare as between two fp32 summation orders.  Tiles are swizzled
// (tile_off), unpadded.  Shared memory at d = 64: 50,432 bytes (dQ) and
// 50,944 (dK/dV), 12 * 64 * d bf16 and the mask, statistics and partial
// sums; at d = 128 the dK/dV kernel reloads K's and V's fragments for each
// query chunk instead of holding them.  ptxas (CUDA 12.8, sm_90a), no
// spills: dQ 150, 164 and 240 registers at d = 32, 64 and 128, dK/dV 142,
// 168 and 255; three blocks an SM at d <= 64.
// fp32 (CUDA cores): 8 warps, a warp per 8 rows, #3's fp32 kernels'
// products (lanes over keys for the dots, K and V padded to d + 1 floats;
// lanes over channels for the contractions); shared memory 116,224 and
// 116,992 bytes at d = 64.

template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32, D <= 64 ? 3 : 2)
    mha_attention_bwd_dq_mma_kernel(MhaBwdArgs a, float* stats, int vec) {
  constexpr int KS = D / 16, T = kBwdTile;
  constexpr int SB = 2 * T * D;          // bf16 elements of a buffer: K, V
  const int Lq = a.Lq, Lk = a.Lk;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.y * T, nq = min(T, Lq - q0);
  const int n_tiles = (Lk + T - 1) / T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // [T][D]
  bf16* gs = qs + T * D;                                   // [T][D] dO
  bf16* bufs = gs + T * D;                                 // 2 x SB
  float* mbuf = reinterpret_cast<float*>(bufs + 2 * SB);   // [2][T] mask
  float* red = mbuf + 2 * T;                               // [4][16][3]
  auto kbuf = [&](int buf) { return bufs + buf * SB; };
  auto vbuf = [&](int buf) { return bufs + buf * SB + T * D; };

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_bs + h * a.k_hs;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_bs + h * a.v_hs;
  const float* mb = a.mask + b * a.m_bs;
  stage_rows<D, true>(static_cast<const bf16*>(a.q) + b * a.q_bs +
                          h * a.q_hs + static_cast<long long>(q0) * a.q_rs,
                      a.q_rs, nq, T, vec & 1, qs);
  stage_rows<D, true>(static_cast<const bf16*>(a.dout) + b * a.do_bs +
                          h * a.do_hs + static_cast<long long>(q0) * a.do_rs,
                      a.do_rs, nq, T, vec & 8, gs);
  // #3's steps: s < n_tiles is sweep 1's tile s, the rest sweep 2's tile
  // s - n_tiles, each K, V and the mask into buffer s & 1; with one tile,
  // step 0 only, read by both sweeps
  auto issue = [&](int s) {
    if (s < 2 * n_tiles && (n_tiles > 1 || s == 0)) {
      const int buf = s & 1, j0 = (s < n_tiles ? s : s - n_tiles) * T;
      const int n = min(T, Lk - j0), n_pad = round16(n);
      stage_rows<D, true>(kb + static_cast<long long>(j0) * a.k_rs, a.k_rs,
                          n, n_pad, vec & 2, kbuf(buf));
      stage_rows<D, true>(vb + static_cast<long long>(j0) * a.v_rs, a.v_rs,
                          n, n_pad, vec & 4, vbuf(buf));
      for (int j = threadIdx.x; j < n_pad; j += blockDim.x)
        cp_async4(mbuf + buf * T + j, mb + j0 + min(j, n - 1), j < n);
    }
    cp_async_commit();
  };
  issue(0);   // with Q and dO
  issue(1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // a tile of one or two 16-row groups splits its keys over the warps
  const int split = bwd_split(nq, Lk), part = warp % split;
  const int r0 = (warp / split) * 16;
  const bool active = r0 < nq;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const int shift = Lk - Lq;   // causal: row i attends no key j > i + shift
  const bool drop = a.rate > 0.f;
  const uint32_t thr = keep_threshold(a.rate);
  uint32_t qf[KS][4], gf[KS][4];

  // the masked, scaled scores of chunk c (keys from j0) of buffer buf;
  // -inf past Lk
  auto scores = [&](int buf, int c, int j0, float (&x)[2][4]) {
    mma_abt<D, true>(qf, kbuf(buf), 16 * c, x);
    const float* mk = mbuf + buf * T + 16 * c;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 mm = *reinterpret_cast<const float2*>(mk + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[n][e] = x[n][e] * a.scale + (1.f - (e & 1 ? mm.y : mm.x)) * kNegInf;
    }
    if (a.causal && j0 + 15 > q0 + r0 + shift)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * n + 2 * t + (e & 1) > row[e >> 1] + shift)
            x[n][e] += kNegInf;
    if (j0 + 16 > Lk)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * n + 2 * t + (e & 1) >= Lk) x[n][e] = -INFINITY;
  };
  // the chunk's keep bits (bit 4 n + e): eight independent draws
  auto draw = [&](int j0) {
    uint32_t m = 0;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m |= (dropout_keep_thr(a.key, b, h, row[e >> 1],
                               j0 + 8 * n + 2 * t + (e & 1), thr)
                  ? 1u
                  : 0u)
             << (4 * n + e);
    return m;
  };
  auto apply = [&](uint32_t m, float (&x)[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[n][e] = (m >> (4 * n + e)) & 1u ? x[n][e] * a.keep_scale : 0.f;
  };
  // (m, l, u) <- the statistics of both key sets; -inf is "none yet"
  auto combine = [](float& m, float& l, float& u, float mo, float lo,
                    float uo) {
    const float mn = fmaxf(m, mo);
    const float fa = m == -INFINITY ? 0.f : exp_fast(m - mn);
    const float fb = mo == -INFINITY ? 0.f : exp_fast(mo - mn);
    l = l * fa + lo * fb;
    u = u * fa + uo * fb;
    m = mn;
  };
  uint32_t kc[kBitTiles];
#pragma unroll
  for (int w = 0; w < kBitTiles; ++w) kc[w] = 0u;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    if (s == 0 && active) {
      load_a<D, true>(qs, r0, qf);
      load_a<D, true>(gs, r0, gf);
    }
    const int buf = s & 1, tj = s * T;
    const int chunks = (min(T, Lk - tj) + 15) / 16;
    for (int c = part; active && c < chunks; c += split) {
      const int j0 = tj + 16 * c;
      float x[2][4], dp[2][4];
      scores(buf, c, j0, x);
      mma_abt<D, true>(gf, vbuf(buf), 16 * c, dp);
      if (drop) {
        const uint32_t bits = draw(j0);
#pragma unroll
        for (int w = 0; w < kBitTiles; ++w)
          if (w == s) kc[w] |= bits << (8 * c);
        apply(bits, dp);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mc = fmaxf(fmaxf(x[0][2 * r], x[0][2 * r + 1]),
                               fmaxf(x[1][2 * r], x[1][2 * r + 1]));
        const float mn = fmaxf(m[r], mc);
        if (mn == -INFINITY) continue;   // only padded keys so far
        const float f = exp_fast(m[r] - mn);
        float sl = 0.f, su = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float e = exp_fast(x[n][2 * r + k] - mn);
            sl += e;
            su = fmaf(e, dp[n][2 * r + k], su);
          }
        l[r] = fmaf(l[r], f, sl);
        u[r] = fmaf(u[r], f, su);
        m[r] = mn;
      }
    }
    __syncthreads();
    issue(s + 2);
  }
  // the quad's four threads hold the row's columns; the butterfly is
  // symmetric, so all four end with the same bits
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1)
      combine(m[r], l[r], u[r], __shfl_xor_sync(0xffffffffu, m[r], o),
              __shfl_xor_sync(0xffffffffu, l[r], o),
              __shfl_xor_sync(0xffffffffu, u[r], o));
  if (split > 1) {   // the key parts, combined in part order
    if (t == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* x = red + (warp * 16 + g + 8 * r) * 3;
        x[0] = m[r];
        x[1] = l[r];
        x[2] = u[r];
      }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = u[r] = 0.f;
#pragma unroll
      for (int k = 0; k < kBwdWarps; ++k)
        if (k < split) {
          const float* x = red + ((warp - part + k) * 16 + g + 8 * r) * 3;
          combine(m[r], l[r], u[r], x[0], x[1], x[2]);
        }
    }
  }
  float il[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    il[r] = 1.f / l[r];
    dl[r] = u[r] / l[r];
    if (active && t == 0 && part == 0 && row[r] < Lq) {
      float* st = stats + (static_cast<long long>(bh) * Lq + row[r]) * 3;
      st[0] = m[r];
      st[1] = il[r];
      st[2] = dl[r];
    }
  }

  float dq[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
  for (int s = n_tiles; s < 2 * n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int tile = s - n_tiles, buf = n_tiles == 1 ? 0 : s & 1;
    const int tj = tile * T, chunks = (min(T, Lk - tj) + 15) / 16;
    uint32_t cached = 0;
#pragma unroll
    for (int w = 0; w < kBitTiles; ++w)
      if (w == tile) cached = kc[w];
    for (int c = part; active && c < chunks; c += split) {
      const int j0 = tj + 16 * c;
      float x[2][4], dp[2][4];
      scores(buf, c, j0, x);
      mma_abt<D, true>(gf, vbuf(buf), 16 * c, dp);
      bool any = false;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[n][e] = exp_fast(x[n][e] - m[e >> 1]) * il[e >> 1];   // p
          any |= x[n][e] != 0.f;
        }
      if (drop) {
        uint32_t bits = 0;
        if (tile < kBitTiles)
          bits = (cached >> (8 * c)) & 0xffu;
        else if (__any_sync(0xffffffffu, any))   // a zero p adds nothing
          bits = draw(j0);
        apply(bits, dp);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[n][e] = x[n][e] * (dp[n][e] - dl[e >> 1]);
      mma_ay3<D>(x, kbuf(buf), 16 * c, dq);
    }
    __syncthreads();
    issue(s + 2);
  }
  cp_async_wait<0>();
  bf16* dqb = static_cast<bf16*>(a.dq) + static_cast<long long>(bh) * Lq * D;
  if (split == 1) {
    if (active) store_rows<D>(dq, a.scale, dqb, D, row[0], Lq);
    return;
  }
  // the parts' partial dQ, summed in part order (the K/V buffers are free)
  combine_parts<D>(dq, reinterpret_cast<float*>(bufs), warp, part, split);
  if (active && part == 0) store_rows<D>(dq, a.scale, dqb, D, row[0], Lq);
}

template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32, D <= 64 ? 3 : 2)
    mha_attention_bwd_dkv_mma_kernel(MhaBwdArgs a, const float* stats,
                                     int vec) {
  constexpr int KS = D / 16, T = kBwdTile;
  constexpr int SB = 2 * T * D;          // bf16 elements of a buffer: Q, dO
  constexpr bool kHold = D <= 64;        // K's and V's fragments held in
                                         // registers (at d = 128 reloaded)
  const int Lq = a.Lq, Lk = a.Lk;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int k0 = blockIdx.y * T, nk = min(T, Lk - k0);
  const int n_tiles = (Lq + T - 1) / T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);            // [T][D]
  bf16* vs = ks + T * D;                                   // [T][D]
  bf16* bufs = vs + T * D;                                 // 2 x SB
  float* sbuf = reinterpret_cast<float*>(bufs + 2 * SB);   // [2][T][3]
  float* mk = sbuf + 2 * 3 * T;                            // [T] mask
  auto qbuf = [&](int buf) { return bufs + buf * SB; };
  auto gbuf = [&](int buf) { return bufs + buf * SB + T * D; };

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_bs + h * a.q_hs;
  const bf16* gb =
      static_cast<const bf16*>(a.dout) + b * a.do_bs + h * a.do_hs;
  const float* st = stats + static_cast<long long>(bh) * Lq * 3;
  stage_rows<D, true>(static_cast<const bf16*>(a.k) + b * a.k_bs +
                          h * a.k_hs + static_cast<long long>(k0) * a.k_rs,
                      a.k_rs, nk, T, vec & 2, ks);
  stage_rows<D, true>(static_cast<const bf16*>(a.v) + b * a.v_bs +
                          h * a.v_hs + static_cast<long long>(k0) * a.v_rs,
                      a.v_rs, nk, T, vec & 4, vs);
  const float* mb = a.mask + b * a.m_bs + k0;
  for (int j = threadIdx.x; j < T; j += blockDim.x)
    cp_async4(mk + j, mb + min(j, nk - 1), j < nk);
  auto issue = [&](int s) {
    if (s < n_tiles) {
      const int buf = s & 1, i0 = s * T;
      const int n = min(T, Lq - i0), n_pad = round16(n);
      stage_rows<D, true>(qb + static_cast<long long>(i0) * a.q_rs, a.q_rs,
                          n, n_pad, vec & 1, qbuf(buf));
      stage_rows<D, true>(gb + static_cast<long long>(i0) * a.do_rs,
                          a.do_rs, n, n_pad, vec & 8, gbuf(buf));
      for (int e = threadIdx.x; e < 3 * T; e += blockDim.x)
        cp_async4(sbuf + buf * 3 * T + e, e < 3 * n ? st + 3 * i0 + e : st,
                  e < 3 * n);
    }
    cp_async_commit();
  };
  issue(0);   // with K, V and the mask
  issue(1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // a tile of one or two 16-key groups splits its query chunks over the
  // warps, as the dQ kernel splits its keys
  const int split = bwd_split(nk, Lq), part = warp % split;
  const int kr0 = (warp / split) * 16;       // the warp's keys in the tile
  const bool active = kr0 < nk;
  const int key[2] = {k0 + kr0 + g, k0 + kr0 + g + 8};
  const int shift = Lk - Lq;   // causal: row i attends no key j > i + shift
  const bool drop = a.rate > 0.f;
  const uint32_t thr = keep_threshold(a.rate);
  uint32_t kf[KS][4], vf[KS][4];
  float kbias[2] = {0.f, 0.f};
  float accv[D / 8][4], acck[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) accv[nt][e] = acck[nt][e] = 0.f;

  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    if (s == 0) {
      kbias[0] = (1.f - mk[kr0 + g]) * kNegInf;
      kbias[1] = (1.f - mk[kr0 + g + 8]) * kNegInf;
      if (kHold && active) {
        load_a<D, true>(ks, kr0, kf);
        load_a<D, true>(vs, kr0, vf);
      }
    }
    const int buf = s & 1, i0 = s * T;
    const int chunks = (min(T, Lq - i0) + 15) / 16;
    const float* sb = sbuf + buf * 3 * T;
    for (int c = part; active && c < chunks; c += split) {
      if (!kHold) {
        load_a<D, true>(ks, kr0, kf);
        load_a<D, true>(vs, kr0, vf);
      }
      float x[2][4], dpt[2][4];
      mma_abt<D, true>(kf, qbuf(buf), 16 * c, x);   // S^T: rows keys
      mma_abt<D, true>(vf, gbuf(buf), 16 * c, dpt);
      const int ic = i0 + 16 * c;
      const bool causal = a.causal && k0 + kr0 + 15 > ic + shift;
      float p[2][4];
      bool any = false;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = 16 * c + 8 * n + 2 * t + (e & 1), i = i0 + il;
          const int j = key[e >> 1];
          float sv = x[n][e] * a.scale + kbias[e >> 1];
          if (causal && j > i + shift) sv += kNegInf;
          p[n][e] = i < Lq && j < Lk
                        ? exp_fast(sv - sb[3 * il]) * sb[3 * il + 1]
                        : 0.f;
          any |= p[n][e] != 0.f;
        }
      // the keep bits where the warp holds a nonzero p (a zero p makes its
      // terms 0 whatever the bit): then all eight draws run
      const bool draws = drop && __any_sync(0xffffffffu, any);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = 16 * c + 8 * n + 2 * t + (e & 1);
          float d = dpt[n][e], pd = p[n][e];
          if (drop) {
            const bool kp = draws && dropout_keep_thr(a.key, b, h, i0 + il,
                                                      key[e >> 1], thr);
            d = kp ? d * a.keep_scale : 0.f;
            pd = kp ? pd * a.keep_scale : 0.f;
          }
          x[n][e] = p[n][e] * (d - sb[3 * il + 2]);   // dS^T
          dpt[n][e] = pd;
        }
      mma_ay3<D>(dpt, gbuf(buf), 16 * c, accv);
      mma_ay3<D>(x, qbuf(buf), 16 * c, acck);
    }
    __syncthreads();
    issue(s + 2);
  }
  cp_async_wait<0>();
  if (split > 1) {   // the parts' dV and dK, summed in part order
    float* obuf = reinterpret_cast<float*>(bufs);   // [4][16][D + 4]
    combine_parts<D>(accv, obuf, warp, part, split);
    combine_parts<D>(acck, obuf, warp, part, split);
  }
  if (!active || part != 0) return;
  const long long head = static_cast<long long>(bh) * Lk * D;
  store_rows<D>(accv, 1.f, static_cast<bf16*>(a.dv) + head, D, key[0], Lk);
  store_rows<D>(acck, a.scale, static_cast<bf16*>(a.dk) + head, D, key[0],
                Lk);
}

// fp32 dQ kernel: a block per (b, h, tile of 64 query rows), a warp per 8
// rows.  A lane forms s and dp of its warp's rows with keys lane and
// lane + 32 of each tile (sweep 1: its share of (m, l, u), then combined
// over the warp by a symmetric butterfly; sweep 2: dS, written to the
// warp's rows of a shared tile), then dQ of its rows at channels
// lane + 32 c.
template <int D>
__global__ void __launch_bounds__(kF32BwdWarps * 32, 1)
    mha_attention_bwd_dq_kernel(MhaBwdArgs a, float* stats, int vec) {
  constexpr int T = kBwdTile, DP = D + 1, RW = T / kF32BwdWarps;
  constexpr int DCH = D / 32;
  constexpr int SB = 2 * T * DP + T;     // floats of a buffer: K, V, mask
  const int Lq = a.Lq, Lk = a.Lk;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.y * T, nq = min(T, Lq - q0);
  const int n_tiles = (Lk + T - 1) / T;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                      // [T][D]
  float* gs = qs + T * D;               // [T][D] dO
  float* bufs = gs + T * D;             // 2 x SB
  float* dss = bufs + 2 * SB;           // [T][T] dS
  auto kbuf = [&](int buf) { return bufs + buf * SB; };
  auto vbuf = [&](int buf) { return bufs + buf * SB + T * DP; };
  auto mkb = [&](int buf) { return bufs + buf * SB + 2 * T * DP; };

  const float* kb = static_cast<const float*>(a.k) + b * a.k_bs + h * a.k_hs;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_bs + h * a.v_hs;
  const float* mb = a.mask + b * a.m_bs;
  stage_rows_f32<D>(static_cast<const float*>(a.q) + b * a.q_bs +
                        h * a.q_hs + static_cast<long long>(q0) * a.q_rs,
                    a.q_rs, nq, T, D, vec & 1, qs);
  stage_rows_f32<D>(static_cast<const float*>(a.dout) + b * a.do_bs +
                        h * a.do_hs + static_cast<long long>(q0) * a.do_rs,
                    a.do_rs, nq, T, D, vec & 8, gs);
  auto issue = [&](int s) {   // the bf16 dQ kernel's steps
    if (s < 2 * n_tiles && (n_tiles > 1 || s == 0)) {
      const int buf = s & 1, j0 = (s < n_tiles ? s : s - n_tiles) * T;
      const int n = min(T, Lk - j0);
      stage_rows_f32<D>(kb + static_cast<long long>(j0) * a.k_rs, a.k_rs, n,
                        T, DP, false, kbuf(buf));
      stage_rows_f32<D>(vb + static_cast<long long>(j0) * a.v_rs, a.v_rs, n,
                        T, DP, false, vbuf(buf));
      for (int j = threadIdx.x; j < T; j += blockDim.x)
        cp_async4(mkb(buf) + j, mb + j0 + min(j, n - 1), j < n);
    }
    cp_async_commit();
  };
  issue(0);   // with Q and dO
  issue(1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * RW;                  // the warp's rows in the tile
  const int shift = Lk - Lq;   // causal: row i attends no key j > i + shift
  const bool drop = a.rate > 0.f;
  const uint32_t thr = keep_threshold(a.rate);
  // s and dp of the warp's rows and keys lane, lane + 32 of buffer buf's
  // tile (keys from j0); s is masked and scaled, -inf past Lk
  auto tile_dots = [&](int buf, int j0, float (&x)[RW][2],
                       float (&dp)[RW][2]) {
    dots_f32<D, RW>(qs + r0 * D, kbuf(buf), x);
    dots_f32<D, RW>(gs + r0 * D, vbuf(buf), dp);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = j0 + lane + 32 * k;
      const float bias = (1.f - mkb(buf)[lane + 32 * k]) * kNegInf;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        float s = x[r][k] * a.scale + bias;
        if (a.causal && j > q0 + r0 + r + shift) s += kNegInf;
        x[r][k] = j < Lk ? s : -INFINITY;
      }
    }
  };
  auto combine = [](float& m, float& l, float& u, float mo, float lo,
                    float uo) {
    const float mn = fmaxf(m, mo);
    const float fa = m == -INFINITY ? 0.f : expf(m - mn);
    const float fb = mo == -INFINITY ? 0.f : expf(mo - mn);
    l = l * fa + lo * fb;
    u = u * fa + uo * fb;
    m = mn;
  };

  float m[RW], l[RW], u[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = -INFINITY;
    l[r] = u[r] = 0.f;
  }
  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int buf = s & 1, j0 = s * T;
    float x[RW][2], dp[RW][2];
    tile_dots(buf, j0, x, dp);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (drop)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          dp[r][k] = dropout_keep_thr(a.key, b, h, q0 + r0 + r,
                                      j0 + lane + 32 * k, thr)
                         ? dp[r][k] * a.keep_scale
                         : 0.f;
      const float mn = fmaxf(m[r], fmaxf(x[r][0], x[r][1]));
      if (mn == -INFINITY) continue;   // only padded keys so far
      const float f = expf(m[r] - mn);
      const float e0 = expf(x[r][0] - mn), e1 = expf(x[r][1] - mn);
      l[r] = l[r] * f + (e0 + e1);
      u[r] = u[r] * f + (e0 * dp[r][0] + e1 * dp[r][1]);
      m[r] = mn;
    }
    __syncthreads();
    issue(s + 2);
  }
  float dl[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)   // symmetric: every lane the same bits
      combine(m[r], l[r], u[r], __shfl_xor_sync(0xffffffffu, m[r], o),
              __shfl_xor_sync(0xffffffffu, l[r], o),
              __shfl_xor_sync(0xffffffffu, u[r], o));
    dl[r] = u[r] / l[r];
    if (lane == 0 && q0 + r0 + r < Lq) {
      float* st = stats + (static_cast<long long>(bh) * Lq + q0 + r0 + r) * 3;
      st[0] = m[r];
      st[1] = 1.f / l[r];
      st[2] = dl[r];
    }
  }

  float acc[RW][DCH];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;
  float* dsw = dss + r0 * T;            // the warp's rows of dS
  for (int s = n_tiles; s < 2 * n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int buf = n_tiles == 1 ? 0 : s & 1, j0 = (s - n_tiles) * T;
    float x[RW][2], dp[RW][2];
    tile_dots(buf, j0, x, dp);
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float p = expf(x[r][k] - m[r]) / l[r];
        float d = dp[r][k];
        if (drop)   // a zero p adds nothing whatever its bit
          d = p != 0.f && dropout_keep_thr(a.key, b, h, q0 + r0 + r,
                                           j0 + lane + 32 * k, thr)
                  ? d * a.keep_scale
                  : 0.f;
        dsw[r * T + lane + 32 * k] = p * (d - dl[r]);
      }
    __syncwarp();
    // dQ[i] += sum_j dS[i][j] K[j], summed in key order
    const float* kt = kbuf(buf);
    const int nk = min(T, Lk - j0);
    for (int j = 0; j < nk; ++j) {
      float kv[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) kv[c] = kt[j * DP + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float x = dsw[r * T + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[r][c] = fmaf(x, kv[c], acc[r][c]);
      }
    }
    __syncthreads();
    issue(s + 2);
  }
  cp_async_wait<0>();
  float* dqb = static_cast<float*>(a.dq) + static_cast<long long>(bh) * Lq * D;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = q0 + r0 + r;
    if (i < Lq)
#pragma unroll
      for (int c = 0; c < DCH; ++c)
        dqb[i * D + lane + 32 * c] = acc[r][c] * a.scale;
  }
}

// fp32 dK/dV kernel: a block per (b, h, tile of 64 keys), 8 warps, K and V
// staged once; query tiles of Q, dO and the rows' statistics stream
// through in order.  A lane forms s and dp of keys lane and lane + 32 with
// its warp's 8 query rows, then p, pd and dS in registers; pd goes to a
// shared tile for dV, then dS for dK; the contractions give a warp 8 keys
// and a lane d / 32 channels, summed in query order (#3's fp32 dK/dV).
template <int D>
__global__ void __launch_bounds__(kF32BwdWarps * 32, 1)
    mha_attention_bwd_dkv_kernel(MhaBwdArgs a, const float* stats, int vec) {
  constexpr int T = kBwdTile, DP = D + 1, RW = T / kF32BwdWarps;
  constexpr int DCH = D / 32;
  constexpr int SB = 2 * T * D + 3 * T;  // floats of a buffer: Q, dO, stats
  const int Lq = a.Lq, Lk = a.Lk;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int k0 = blockIdx.y * T, nk = min(T, Lk - k0);
  const int n_tiles = (Lq + T - 1) / T;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;                      // [T][DP]
  float* vs = ks + T * DP;              // [T][DP]
  float* mk = vs + T * DP;              // [T] mask
  float* bufs = mk + T;                 // 2 x SB
  float* pt = bufs + 2 * SB;            // [T][T] pd, then dS
  auto qbuf = [&](int buf) { return bufs + buf * SB; };
  auto gbuf = [&](int buf) { return bufs + buf * SB + T * D; };
  auto sbuf = [&](int buf) { return bufs + buf * SB + 2 * T * D; };

  const float* qb = static_cast<const float*>(a.q) + b * a.q_bs + h * a.q_hs;
  const float* gb =
      static_cast<const float*>(a.dout) + b * a.do_bs + h * a.do_hs;
  const float* st = stats + static_cast<long long>(bh) * Lq * 3;
  stage_rows_f32<D>(static_cast<const float*>(a.k) + b * a.k_bs +
                        h * a.k_hs + static_cast<long long>(k0) * a.k_rs,
                    a.k_rs, nk, T, DP, false, ks);
  stage_rows_f32<D>(static_cast<const float*>(a.v) + b * a.v_bs +
                        h * a.v_hs + static_cast<long long>(k0) * a.v_rs,
                    a.v_rs, nk, T, DP, false, vs);
  const float* mb = a.mask + b * a.m_bs + k0;
  for (int j = threadIdx.x; j < T; j += blockDim.x)
    cp_async4(mk + j, mb + min(j, nk - 1), j < nk);
  auto issue = [&](int s) {
    if (s < n_tiles) {
      const int buf = s & 1, i0 = s * T, n = min(T, Lq - i0);
      stage_rows_f32<D>(qb + static_cast<long long>(i0) * a.q_rs, a.q_rs, n,
                        T, D, vec & 1, qbuf(buf));
      stage_rows_f32<D>(gb + static_cast<long long>(i0) * a.do_rs, a.do_rs,
                        n, T, D, vec & 8, gbuf(buf));
      for (int e = threadIdx.x; e < 3 * T; e += blockDim.x)
        cp_async4(sbuf(buf) + e, e < 3 * n ? st + 3 * i0 + e : st, e < 3 * n);
    }
    cp_async_commit();
  };
  issue(0);   // with K, V and the mask
  issue(1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * RW;   // the warp's query rows, then its keys
  const int shift = Lk - Lq;   // causal: row i attends no key j > i + shift
  const bool drop = a.rate > 0.f;
  const uint32_t thr = keep_threshold(a.rate);
  float accv[RW][DCH], acck[RW][DCH];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < DCH; ++c) accv[r][c] = acck[r][c] = 0.f;

  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const int buf = s & 1, i0 = s * T, nq = min(T, Lq - i0);
    const float* sb = sbuf(buf);
    float x[RW][2], dp[RW][2];
    dots_f32<D, RW>(qbuf(buf) + r0 * D, ks, x);    // s[i][j] = Q_i . K_j
    dots_f32<D, RW>(gbuf(buf) + r0 * D, vs, dp);   // dP[i][j] = dO_i . V_j
    float ds[RW][2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = k0 + lane + 32 * k;
      const float bias = (1.f - mk[lane + 32 * k]) * kNegInf;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = i0 + r0 + r;
        float sv = x[r][k] * a.scale + bias;
        if (a.causal && j > i + shift) sv += kNegInf;
        const float* sr = sb + 3 * (r0 + r);   // the row's m, 1 / l, Delta
        const float p = i < Lq && j < Lk ? expf(sv - sr[0]) * sr[1] : 0.f;
        float d = dp[r][k], pd = p;
        if (drop) {   // a zero p adds nothing whatever its bit
          const bool kp =
              p != 0.f && dropout_keep_thr(a.key, b, h, i, j, thr);
          d = kp ? d * a.keep_scale : 0.f;
          pd = kp ? p * a.keep_scale : 0.f;
        }
        ds[r][k] = p * (d - sr[2]);
        pt[(r0 + r) * T + lane + 32 * k] = pd;
      }
    }
    __syncthreads();
    contract_f32<D, RW>(pt, r0, gbuf(buf), nq, accv);   // dV[j] += pd dO
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k) pt[(r0 + r) * T + lane + 32 * k] = ds[r][k];
    __syncthreads();
    contract_f32<D, RW>(pt, r0, qbuf(buf), nq, acck);   // dK[j] += dS Q
    __syncthreads();
    issue(s + 2);
  }
  cp_async_wait<0>();
  const long long head = static_cast<long long>(bh) * Lk * D;
  float* dvb = static_cast<float*>(a.dv) + head;
  float* dkb = static_cast<float*>(a.dk) + head;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int j = k0 + r0 + r;
    if (j < Lk)
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        dvb[j * D + lane + 32 * c] = accv[r][c];
        dkb[j * D + lane + 32 * c] = acck[r][c] * a.scale;
      }
  }
}

// Shared memory of #5's dQ and dK/dV kernels: no term depends on Lq or Lk.
size_t mha_bwd_smem_dq(int dtype, int D) {
  constexpr size_t T = kBwdTile;
  if (dtype == kBFloat16)
    return 6 * T * D * sizeof(bf16) + (2 * T + kBwdWarps * 16 * 3) *
                                          sizeof(float);
  return (2 * T * D + 2 * (2 * T * (D + 1) + T) + T * T) * sizeof(float);
}

size_t mha_bwd_smem_dkv(int dtype, int D) {
  constexpr size_t T = kBwdTile;
  if (dtype == kBFloat16)
    return 6 * T * D * sizeof(bf16) + (6 * T + T) * sizeof(float);
  return (2 * T * (D + 1) + T + 2 * (2 * T * D + 3 * T) + T * T) *
         sizeof(float);
}

bool rows_aligned16_f32(const void* p, long long bs, long long hs,
                        long long rs) {
  return rows_aligned16_f32(p, bs, rs) && hs % 4 == 0;
}

// The dQ kernel and then the dK/dV kernel on the stream.
template <int D>
cudaError_t launch_mha_bwd(const MhaBwdArgs& a, int dtype, float* stats,
                           cudaStream_t stream) {
  const bool bf = dtype == kBFloat16;
  auto aligned = [&](const void* p, long long bs, long long hs,
                     long long rs) {
    return bf ? rows_aligned16(p, bs, hs, rs)
              : rows_aligned16_f32(p, bs, hs, rs);
  };
  const int vec = (aligned(a.q, a.q_bs, a.q_hs, a.q_rs) ? 1 : 0) |
                  (aligned(a.k, a.k_bs, a.k_hs, a.k_rs) ? 2 : 0) |
                  (aligned(a.v, a.v_bs, a.v_hs, a.v_rs) ? 4 : 0) |
                  (aligned(a.dout, a.do_bs, a.do_hs, a.do_rs) ? 8 : 0);
  const size_t smem_dq = mha_bwd_smem_dq(dtype, D);
  const size_t smem_dkv = mha_bwd_smem_dkv(dtype, D);
  const dim3 grid_q(a.B * a.H, (a.Lq + kBwdTile - 1) / kBwdTile);
  const dim3 grid_k(a.B * a.H, (a.Lk + kBwdTile - 1) / kBwdTile);
  cudaError_t e;
  if (bf) {
    e = prepare(mha_attention_bwd_dq_mma_kernel<D>, smem_dq);
    if (e != cudaSuccess) return e;
    mha_attention_bwd_dq_mma_kernel<D>
        <<<grid_q, kBwdWarps * 32, smem_dq, stream>>>(a, stats, vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    e = prepare(mha_attention_bwd_dkv_mma_kernel<D>, smem_dkv);
    if (e != cudaSuccess) return e;
    mha_attention_bwd_dkv_mma_kernel<D>
        <<<grid_k, kBwdWarps * 32, smem_dkv, stream>>>(a, stats, vec);
    return cudaGetLastError();
  }
  e = prepare(mha_attention_bwd_dq_kernel<D>, smem_dq);
  if (e != cudaSuccess) return e;
  mha_attention_bwd_dq_kernel<D>
      <<<grid_q, kF32BwdWarps * 32, smem_dq, stream>>>(a, stats, vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = prepare(mha_attention_bwd_dkv_kernel<D>, smem_dkv);
  if (e != cudaSuccess) return e;
  mha_attention_bwd_dkv_kernel<D>
      <<<grid_k, kF32BwdWarps * 32, smem_dkv, stream>>>(a, stats, vec);
  return cudaGetLastError();
}

cudaError_t mha_bwd_dim(const MhaBwdArgs& a, int dtype, int head_dim,
                        float* stats, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_mha_bwd<32>(a, dtype, stats, s);
    case 64: return launch_mha_bwd<64>(a, dtype, stats, s);
    case 128: return launch_mha_bwd<128>(a, dtype, stats, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory (bytes) a block of the kernels takes at these shapes.  No
// attention kernel refuses a length: the packed forward and backward (the
// larger of its two kernels'), #4 in fp32 and #5 (the larger of its two)
// take the same at every Lq and Lk; #4 in bf16 less for Lk < 64.
extern "C" long long hero_attention_smem_bytes(int dtype, int backward,
                                               int Lq, int Lk, int head_dim) {
  (void)Lq;
  (void)Lk;
  if (backward) {
    const size_t dq = bwd_smem_dq(dtype, head_dim);
    const size_t dkv = bwd_smem_dkv(dtype, head_dim);
    return static_cast<long long>(dq > dkv ? dq : dkv);
  }
  return static_cast<long long>(dtype == kBFloat16 ? fwd_mma_smem(head_dim)
                                                   : fwd_smem(head_dim));
}

extern "C" long long hero_attention_smem_limit() { return kMaxSmem; }

extern "C" long long hero_mha_smem_bytes(int dtype, int Lq, int Lk,
                                         int head_dim) {
  return static_cast<long long>(dtype == kBFloat16
                                    ? mha_mma_smem(Lq, Lk, head_dim)
                                    : mha_smem(head_dim));
}

extern "C" long long hero_mha_bwd_smem_bytes(int dtype, int Lq, int Lk,
                                             int head_dim) {
  (void)Lq;
  (void)Lk;
  const size_t dq = mha_bwd_smem_dq(dtype, head_dim);
  const size_t dkv = mha_bwd_smem_dkv(dtype, head_dim);
  return static_cast<long long>(dq > dkv ? dq : dkv);
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
    case kFloat32: e = fwd_mode(a, seg_mode, head_dim, s); break;
    case kBFloat16:
      e = seg_mode ? fwd_mma_dim<true>(a, head_dim, s)
                   : fwd_mma_dim<false>(a, head_dim, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Returns a cudaError_t code (0 = launched).  p: contiguous
// (B, H, Lq, Lk); the others packed with batch/row strides in elements;
// delta: a (B, H, Lq) fp32 scratch, written by the dQ kernel and read by
// the dK/dV kernel.
extern "C" int hero_packed_attention_bwd(
    int dtype, const void* p, const void* q, const void* k, const void* v,
    const void* dout, void* dq, void* dk, void* dv, void* delta, int B,
    int H, int Lq, int Lk, int head_dim, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    long long do_bs, long long do_rs, long long dq_bs, long long dq_rs,
    long long dk_bs, long long dk_rs, long long dv_bs, long long dv_rs,
    float scale, float rate, float keep_scale, unsigned int seed_lo,
    unsigned int seed_hi, void* stream) {
  const BwdArgs a{p, q, k, v, dout, dq, dk, dv, B, H, Lq, Lk,
                  q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs,
                  dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs,
                  scale, rate, keep_scale, PhiloxKey{seed_lo, seed_hi}};
  if (dtype != kFloat32 && dtype != kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bwd_dim(a, dtype, head_dim,
                                  static_cast<float*>(delta),
                                  static_cast<cudaStream_t>(stream)));
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
    case kFloat32: e = mha_dim(a, head_dim, s); break;
    case kBFloat16: e = mha_mma_dim(a, head_dim, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Head-major attention backward.  Returns a cudaError_t code (0 =
// launched).  q/k/v/dout: (B, H, L, d) with unit stride over d, the other
// strides in elements; mask: float (B, Lk) with unit stride over keys and
// batch stride m_bs (0 = one row for every batch); dq, dk, dv contiguous;
// stats: a (B, H, Lq, 3) fp32 scratch (each row's m, 1 / l, Delta), written
// by the dQ kernel and read by the dK/dV kernel.
extern "C" int hero_mha_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* mask, void* dq, void* dk, void* dv, void* stats, int B,
    int H, int Lq, int Lk, int head_dim, int causal, long long q_bs,
    long long q_hs, long long q_rs, long long k_bs, long long k_hs,
    long long k_rs, long long v_bs, long long v_hs, long long v_rs,
    long long do_bs, long long do_hs, long long do_rs, long long m_bs,
    float scale, float rate, float keep_scale, unsigned int seed_lo,
    unsigned int seed_hi, void* stream) {
  const MhaBwdArgs a{q, k, v, dout, static_cast<const float*>(mask),
                     dq, dk, dv, B, H, Lq, Lk, causal,
                     q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs,
                     do_bs, do_hs, do_rs, m_bs,
                     scale, rate, keep_scale, PhiloxKey{seed_lo, seed_hi}};
  if (dtype != kFloat32 && dtype != kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mha_bwd_dim(a, dtype, head_dim,
                                      static_cast<float*>(stats),
                                      static_cast<cudaStream_t>(stream)));
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
