// The Hopper attention core shared by kernel 1 (attention.cu, masked
// attention at head dims 64 and 96) and kernel 6 (bidir_attention.cu,
// LightGlue's bidirectional cross attention): one block computes 192 query
// rows of softmax(Q K^T) V over every key tile of one (batch, head), with an
// online softmax. The core is a template on the head dim D; D = 64 (kernels 1
// and 6) and D = 96 (kernel 1 for LighterGlue's one head of width 96) differ
// only in the tile geometry of Geo<D> below.
//
// What bounds it on the H100: tensor-core issue in principle (at LightGlue's
// shape a call is ~4 * 2048^2 * 64 FLOP per (batch, head) against 1 MB of
// operands, far above the card's ~295 operations per byte), but at head dim
// 64 the softmax's exp2 on the SFUs (16 a clock per SM) needs as many cycles
// as the two products on the tensor cores, and every K or V tile is read from
// L2 once per block. At head dim 96 the products are 1.5 times the work per
// score and the exp2 the same, so the tensor cores bound it more clearly. The
// design:
//
// - Block of four warpgroups. Warpgroups 0-2 consume, each owning 64 query
//   rows, so each K/V tile serves 192 rows; one warp of warpgroup 3 produces.
//   `setmaxnreg` moves the producer's registers to the consumers (32 / 160 a
//   thread). A warpgroup whose rows all lie past the end only releases tiles.
// - TMA-fed tiles. The producer loads the Q tile once and keeps a ring of
//   STAGES (K, V) tiles of BK keys x D bf16 in flight, each signalled on a
//   full mbarrier and released on an empty one. The tensor maps are 3-D,
//   (D, rows, batch x head), so a ragged last tile zero-fills instead of
//   reading the next head's rows. D = 64: one 128-byte swizzled box a row,
//   128-key tiles. D = 96: a 192-byte row is three 64-byte swizzle atoms, so
//   each tile is three 32-column boxes in 64-byte swizzle, stored one after
//   the other (a 96-column row cannot be one 128-byte-swizzled operand: the
//   second atom would be half empty and n = 96 is not a whole number of
//   128-byte atoms for the P V product); 64-key tiles, so that O (48 f32 a
//   thread), S (32) and P (16) fit the 160 registers with S(t) and PV(t - 1)
//   in flight together (at 128 keys they would need 144 before addresses and
//   maxima, and spill).
// - wgmma. S = Q K^T is m64nBKk16 with both operands in shared memory
//   (K-major): D / 16 k-steps of 32 bytes, each inside one swizzle atom. The
//   probabilities are rounded to bf16 and reused from the accumulator
//   registers as the A operand of O += P V (m64nDk16), whose B operand is the
//   V tile as stored, (key, d), read with the transpose bit (MN-major); at
//   D = 96 the descriptor's leading byte offset steps from one 32-column box
//   to the next, so each k-step is one m64n96k16. S of tile t is issued
//   together with PV of tile t - 1, so the tensor cores run PV(t - 1) while
//   tile t's maxima are taken.
// - Masks. The producer turns each key tile's mask into an additive bias
//   (0 valid, -1e30 masked, -inf past the end) stored beside the tile, and
//   skips a tile whose keys are all masked when the batch element has at
//   least one valid key: for a valid query those keys add exp(-1e30 - m) = 0
//   in f32, so the skip is exact. If every key is masked nothing is skipped
//   (kernel 1 then averages all keys uniformly, as the reference does). A
//   query tile whose rows are all masked is written as zeros and skipped.
// - Softmax in registers on the accumulator fragments, the scale folded into
//   exp2; running maxima from -inf (kernel 1) or -1e30 (kernel 6, where a
//   row bias of -1e30 for a masked row is added to S); f32 sums; the output
//   times 1/l (kernel 1) or over max(l, 1e-30) (kernel 6), rounded to bf16.
//   A key tile whose keys are all valid takes a short form (one FFMA and one
//   exp2 per score). Kernel 6 takes it in a warpgroup whose 64 rows are all
//   valid, which runs a second instantiation of the tile loop without row
//   biases: keeping them beside the branch made ptxas spill.
// - Blocks run the ragged last row tiles last, so the last, partial wave
//   holds the cheaper blocks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"  // mbarriers, TMA, the wgmma descriptor and fences

namespace attn_sm90 {

constexpr int BQ = 192;       // query rows per block, 64 per consumer warpgroup
constexpr int STAGES = 4;     // (K, V) tiles in flight
constexpr int CONSUMERS = BQ / 64 * 128;  // threads of the consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;   // warpgroups 0-2 consume, warpgroup 3 produces
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// the tile geometry of head dim D: keys per tile, and the swizzle span in
// bytes, which is the width of one TMA box (D = 64: one 128-byte box a row;
// D = 96: three 64-byte boxes a row)
template <int D>
struct Geo;
template <>
struct Geo<64> {
  static constexpr int BK = 128;
  static constexpr int SW = 128;
};
template <>
struct Geo<96> {
  static constexpr int BK = 64;
  static constexpr int SW = 64;
};

// shared memory, from a 1024-byte aligned base (the swizzle repeats every 8
// rows of SW bytes); a tile of R rows is BOXES boxes of R x SW bytes, one
// after the other; a stage's info is 1 if all its keys are valid, 0 if not,
// -1 for the end marker
template <int D>
struct Smem {
  static constexpr int BK = Geo<D>::BK;
  static constexpr int SW = Geo<D>::SW;
  static constexpr int BOX_COLS = SW / 2;         // bf16 columns a box
  static constexpr int BOXES = D / BOX_COLS;      // boxes a row: 1 (D = 64) or 3 (D = 96)
  static constexpr int TILE_BYTES = BK * D * 2;   // one K or V tile: 16 KB (64), 12 KB (96)
  static constexpr int Q_BYTES = BQ * D * 2;      // the Q tile: 24 KB (64), 36 KB (96)
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * TILE_BYTES;
  static constexpr int OFF_BIAS = OFF_V + STAGES * TILE_BYTES;  // float [STAGES][BK]
  static constexpr int OFF_FLAG = OFF_BIAS + STAGES * BK * 4;   // int [BQ / 16]: kernel 6's warps
  static constexpr int OFF_INFO = OFF_FLAG + 4 * (BQ / 16);     // int [STAGES], below
  static constexpr int OFF_BAR = OFF_INFO + 16 * STAGES;        // u64: q, full[STAGES], empty[STAGES]
  static constexpr int SMEM_BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  // the V descriptor's leading byte offset (16-byte units): the step from one
  // box to the next along d (unused with one box)
  static constexpr uint32_t PV_LBO16 = BOXES == 1 ? (1024 >> 4) : (BK * SW) >> 4;
};

struct Job {
  const CUtensorMap* qmap;  // (D, Nq, B*H) bf16
  const CUtensorMap* kmap;  // (D, Nk, B*H) bf16
  const CUtensorMap* vmap;  // (D, Nk, B*H) bf16
  const uint8_t* qmask;     // (Nq) of this batch element, or null
  const uint8_t* kmask;     // (Nk) of this batch element, or null
  uint16_t* out;            // (Nq, D) of this (batch, head)
  int bh, q0, Nq, Nk;
  float scale_log2;         // the softmax scale times log2(e)
};

using sm90::fence_regs;
using sm90::mbar_arrive;
using sm90::mbar_arrive_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::sw128_desc;
using sm90::sw64_desc;
using sm90::tma_load_3d;
using sm90::wg_commit;
using sm90::wg_fence;
using sm90::wg_wait;

// d (64 x 128 f32 fragments) (+)= A (64 x 16, shared, K-major) B^T (128 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32 fragments) (+)= A (64 x 16, shared, K-major) B^T (64 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32 fragments) += A (64 x 16 bf16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 96 f32 fragments) += A (64 x 16 bf16, registers) B (16 x 96, shared, MN-major)
__device__ __forceinline__ void wgmma_pv(float (&d)[48], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %53, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the wgmma descriptor of a tile in head dim D's swizzle (leading byte
// offset in 16-byte units)
template <int D>
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr, uint32_t lbo16) {
  return Geo<D>::SW == 128 ? sw128_desc(addr, lbo16) : sw64_desc(addr, lbo16);
}

// S (64 x BK) = Q K^T over the head dim: D / 16 k-steps of 16 (32 bytes
// along the swizzled rows); k-step kk lies in box kk / (SW / 32) of both
// tiles, at 32 (kk % (SW / 32)) bytes into its rows. dq is the descriptor of
// this warpgroup's rows in the Q tile's first box.
template <int D, int N>
__device__ __forceinline__ void issue_qk(float (&s)[N], uint64_t dq, uint32_t k_tile) {
  using L = Smem<D>;
  constexpr int KS = L::SW / 32;  // k-steps a box
  const uint64_t dk = tile_desc<D>(k_tile, 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / KS, off = 2 * (kk % KS);
    wgmma_qk(s, dq + box * ((BQ * L::SW) >> 4) + off, dk + box * ((L::BK * L::SW) >> 4) + off,
             kk);
  }
}

// O (64 x D) += P V over BK keys: BK / 16 k-steps of 16 keys, 16 rows of
// SW bytes each in every box
template <int D, int N, int P>
__device__ __forceinline__ void issue_pv(float (&o)[N], const uint32_t (&pa)[P],
                                         uint32_t v_tile) {
  using L = Smem<D>;
  const uint64_t dv = tile_desc<D>(v_tile, L::PV_LBO16);
#pragma unroll
  for (int kk = 0; kk < L::BK / 16; ++kk)
    wgmma_pv(o, pa + 4 * kk, dv + ((16 * L::SW) >> 4) * kk);
}

// The maximum (sum) of row r's N / 2 values s[4 j + 2 r + {0, 1}], r = 0 for
// the thread's first row, 1 for its second: four interleaved chains, so the
// chains stay short and few registers are live.
template <int R, int N>
__device__ __forceinline__ float row_max(const float (&s)[N]) {
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = fmaxf(s[2 * R + 4 * k], s[2 * R + 4 * k + 1]);
#pragma unroll
  for (int j = 4; j < N / 4; ++j) {
    a[j & 3] = fmaxf(a[j & 3], s[4 * j + 2 * R]);
    a[j & 3] = fmaxf(a[j & 3], s[4 * j + 2 * R + 1]);
  }
  return fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
}
template <int R, int N>
__device__ __forceinline__ float row_sum(const float (&s)[N]) {
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = s[2 * R + 4 * k] + s[2 * R + 4 * k + 1];
#pragma unroll
  for (int j = 4; j < N / 4; ++j) a[j & 3] += s[4 * j + 2 * R] + s[4 * j + 2 * R + 1];
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// the new running maxima from the tile maxima of this thread's two rows
// (reduced over the 4 threads of each row); corr rescales the old sums
__device__ __forceinline__ void update_max(const float (&mx)[2], float (&m)[2],
                                           float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[r], v);  // finite: the tile holds a key < Nk
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
}

// Online softmax of one tile of N / 2 keys on the accumulator fragments:
// s[4 j + e] is row r + 8 (e / 2), key 8 j + c + (e % 2) of the tile. Scales,
// adds the key (and row) biases, updates the running maxima m and sums l,
// leaves the probabilities in s and the factor that rescales the old sums in
// corr. ROWB: the rows carry kernel 6's row biases qb. Without them a tile
// whose keys are all valid (bias 0) takes the short form: the maximum of
// s * C is C times that of s (C > 0), and exp2(s * C - m) is one FFMA.
template <bool ROWB, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], const float* bias, bool all_valid,
                                             int c, const float (&qb)[2], float C,
                                             float (&m)[2], float (&l)[2], float (&corr)[2]) {
  if (!ROWB && all_valid) {
    update_max({row_max<0>(s) * C, row_max<1>(s) * C}, m, corr);
    const float negm[2] = {-m[0], -m[1]};
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = ex2(fmaf(s[i], C, negm[(i >> 1) & 1]));
  } else {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float2 kb = *reinterpret_cast<const float2*>(bias + 8 * j + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[4 * j + e] * C + ((e & 1) ? kb.y : kb.x);
        if (ROWB) val += qb[e >> 1];
        s[4 * j + e] = val;
      }
    }
    update_max({row_max<0>(s), row_max<1>(s)}, m, corr);
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = ex2(s[i] - m[(i >> 1) & 1]);
  }
  l[0] = l[0] * corr[0] + row_sum<0>(s);
  l[1] = l[1] * corr[1] + row_sum<1>(s);
}

// Block order: the first n - 1 row tiles of every (batch, head), row tiles
// fastest so that blocks running together share keys and values in L2, then
// the last (ragged) row tile of every (batch, head), so the last wave holds
// the cheaper blocks. Block L of BH * n -> (batch x head, row tile).
__device__ __forceinline__ void block_tile(int L, int BH, int n, int& bh, int& x) {
  const int full = BH * (n - 1);
  if (L < full) {
    bh = L / (n - 1);
    x = L % (n - 1);
  } else {
    bh = L - full;
    x = n - 1;
  }
}

// P rounded to bf16 in the A-fragment order of m64nNk16: for 16 keys kk,
// (row, keys c..c+1), (row + 8, c..c+1), (row, 8 + c..), (row + 8, 8 + c..)
template <int P>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[P], const float (&s)[2 * P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// The tile loop of one consumer warpgroup over its 64 rows (the thread's
// rows r_loc and r_loc + 8, columns 8 j + c and 8 j + c + 1). BIDIR selects
// kernel 6's numerics (maxima from -1e30, output over max(l, 1e-30)); ROWB
// adds its row biases qb. A warpgroup whose rows are all valid runs kernel 6
// without them, so that loop holds no qb and takes the short softmax.
template <int D, bool BIDIR, bool ROWB>
__device__ __forceinline__ void consume(const Job& sjob, uint32_t base, const float* sbias,
                                        const int* sinfo, int wg, int r_loc, int c,
                                        const float (&qb)[2]) {
  using L = Smem<D>;
  constexpr int BK = L::BK;
  const uint32_t bar_q = base + L::OFF_BAR;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // + 8 * stage
  const float C = sjob.scale_log2;
  float m[2] = {BIDIR ? NEG : -INFINITY, BIDIR ? NEG : -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  const uint64_t dq = tile_desc<D>(base + L::OFF_Q + wg * 64 * L::SW, 1);
  float s[BK / 2];      // the scores of the newest tile, then its probabilities
  uint32_t pa[BK / 4];  // the previous tile's P as bf16 A fragments, 4 registers per 16 keys
  float corr[2];
  mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;

  // the first tile (there is one: a skipped tile is all masked, and then
  // some tile has a valid key): S, then its softmax
  mbar_wait(bar_full, 0);
  wg_fence();
  issue_qk<D>(s, dq, base + L::OFF_K);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  softmax_tile<ROWB>(s, sbias, sinfo[0] > 0, c, qb, C, m, l, corr);
  pack_p(pa, s);
  int prev = stage;
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }

  // Steady state: S of tile t is issued with the PV product of tile t - 1,
  // so the softmax of tile t runs on the CUDA cores while the tensor cores
  // run PV(t - 1). Tile t - 1's stage is released once PV(t - 1) is done.
  while (true) {
    mbar_wait(bar_full + 8 * stage, phase);
    const int info = *reinterpret_cast<const volatile int*>(sinfo + stage);
    if (info < 0) break;
    wg_fence();
    issue_qk<D>(s, dq, base + L::OFF_K + stage * L::TILE_BYTES);
    wg_commit();
    issue_pv<D>(o, pa, base + L::OFF_V + prev * L::TILE_BYTES);
    wg_commit();
    wg_wait<1>();  // S(t) is done, PV(t - 1) may still run
    fence_regs(s);
    softmax_tile<ROWB>(s, sbias + stage * BK, info > 0, c, qb, C, m, l, corr);
    wg_wait<0>();
    fence_regs(o);
    fence_regs(pa);  // PV(t - 1) has read them: pa may now be rewritten
    mbar_arrive(bar_empty + 8 * prev);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    pack_p(pa, s);
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wg_fence();
  issue_pv<D>(o, pa, base + L::OFF_V + prev * L::TILE_BYTES);
  wg_commit();
  wg_wait<0>();
  fence_regs(o);
  mbar_arrive(bar_empty + 8 * prev);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = BIDIR ? 1.f / fmaxf(l[r], 1e-30f) : 1.f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = sjob.q0 + r_loc + 8 * r;
    if (row < sjob.Nq) {
      uint16_t* dst = sjob.out + static_cast<size_t>(row) * D + c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

// One block of BQ query rows at head dim D. BIDIR selects kernel 6's
// numerics (row bias, maxima from -1e30, output over max(l, 1e-30)) over
// kernel 1's.
template <int D, bool BIDIR>
__device__ __forceinline__ void attention_block(const Job& job) {
  using L = Smem<D>;
  constexpr int BK = L::BK;
  constexpr int KPL = BK / 32;  // keys a producer lane: 4 (D = 64) or 2 (D = 96)
  extern __shared__ __align__(1024) uint8_t dyn_smem[];
  const int tid = threadIdx.x;
  uint32_t base = smem_u32(dyn_smem);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  uint8_t* sm = dyn_smem + pad;
  base += pad;
  float* sbias = reinterpret_cast<float*>(sm + L::OFF_BIAS);
  int* sinfo = reinterpret_cast<int*>(sm + L::OFF_INFO);
  const uint32_t bar_q = base + L::OFF_BAR;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // + 8 * stage

  // a query tile whose rows are all masked: zeros, nothing else
  bool any_q = job.qmask == nullptr;
  if (!any_q && tid < BQ && job.q0 + tid < job.Nq) any_q = job.qmask[job.q0 + tid] != 0;
  if (!__syncthreads_or(any_q)) {
    for (int i = tid; i < BQ * D / 8; i += THREADS) {
      const int r = job.q0 + i / (D / 8);
      if (r < job.Nq)
        *reinterpret_cast<uint4*>(job.out + static_cast<size_t>(r) * D + (i % (D / 8)) * 8) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  // whether this batch element has a valid key (then all-masked tiles skip)
  bool any_k = job.kmask == nullptr;
  for (int i = tid; !any_k && i < job.Nk; i += THREADS) any_k = job.kmask[i] != 0;
  any_k = __syncthreads_or(any_k);

  // the item's description, read from shared memory after the role split so
  // that the consumers do not hold it in registers through the tile loop
  __shared__ Job sjob;
  if (tid == 0) {
    sjob = job;
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);    // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, CONSUMERS);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------- producer warpgroup: one warp issues, three idle -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (tid < CONSUMERS + 32) {
      const int lane = tid - CONSUMERS;
      if (lane == 0) {
        mbar_arrive_tx(bar_q, L::Q_BYTES);
#pragma unroll
        for (int b = 0; b < L::BOXES; ++b)
          tma_load_3d(base + L::OFF_Q + b * BQ * L::SW, sjob.qmap, bar_q, b * L::BOX_COLS,
                      sjob.q0, sjob.bh);
      }
      const int ntiles = (sjob.Nk + BK - 1) / BK;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        float kb[KPL];
        bool valid = false, all_k = true;
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
          const int key = t * BK + lane * KPL + e;
          const bool ok = key < sjob.Nk && (sjob.kmask == nullptr || sjob.kmask[key] != 0);
          kb[e] = key >= sjob.Nk ? -INFINITY : (ok ? 0.f : NEG);
          valid |= ok;
          all_k &= ok;
        }
        if (!__any_sync(0xffffffffu, valid) && any_k) continue;  // all masked: skip
        const bool all_valid = __all_sync(0xffffffffu, all_k);
        mbar_wait(bar_empty + 8 * stage, phase ^ 1);
        if constexpr (KPL == 4)
          reinterpret_cast<float4*>(sbias + stage * BK)[lane] =
              make_float4(kb[0], kb[1], kb[2], kb[3]);
        else
          reinterpret_cast<float2*>(sbias + stage * BK)[lane] = make_float2(kb[0], kb[1]);
        if (lane == 0) {
          sinfo[stage] = all_valid;
          const uint32_t full = bar_full + 8 * stage;
          const uint32_t k_tile = base + L::OFF_K + stage * L::TILE_BYTES;
          const uint32_t v_tile = base + L::OFF_V + stage * L::TILE_BYTES;
          mbar_arrive_tx(full, 2 * L::TILE_BYTES);
#pragma unroll
          for (int b = 0; b < L::BOXES; ++b)
            tma_load_3d(k_tile + b * BK * L::SW, sjob.kmap, full, b * L::BOX_COLS, t * BK,
                        sjob.bh);
#pragma unroll
          for (int b = 0; b < L::BOXES; ++b)
            tma_load_3d(v_tile + b * BK * L::SW, sjob.vmap, full, b * L::BOX_COLS, t * BK,
                        sjob.bh);
        } else {
          mbar_arrive(bar_full + 8 * stage);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // the end marker
      mbar_wait(bar_empty + 8 * stage, phase ^ 1);
      if (lane == 0) sinfo[stage] = -1;
      mbar_arrive(bar_full + 8 * stage);
    }
  } else {
    // ---------------- consumer warpgroups: 64 query rows each ---------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    if (sjob.q0 + wg * 64 >= sjob.Nq) {
      // every row of this warpgroup is past the end: only release the tiles
      int stage = 0;
      uint32_t phase = 0;
      while (true) {
        mbar_wait(bar_full + 8 * stage, phase);
        if (*reinterpret_cast<volatile int*>(sinfo + stage) < 0) return;
        mbar_arrive(bar_empty + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    const int r_loc = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: r_loc, r_loc + 8
    const int c = (lane % 4) * 2;                      // and columns 8 j + c, 8 j + c + 1
    const float zero[2] = {0.f, 0.f};
    if (!BIDIR) {
      consume<D, false, false>(sjob, base, sbias, sinfo, wg, r_loc, c, zero);
      return;
    }
    // kernel 6: the row biases (-1e30 for a masked row or one past the end);
    // whether all 64 rows of the warpgroup are valid, agreed on through
    // shared memory and the warpgroup's named barrier (wgmma needs the whole
    // warpgroup on one code path)
    float qb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = sjob.q0 + r_loc + 8 * r;
      qb[r] = (row < sjob.Nq && sjob.qmask[row]) ? 0.f : NEG;
    }
    int* sflag = reinterpret_cast<int*>(sm + L::OFF_FLAG) + wg * 4;
    const bool warp_ok = __all_sync(0xffffffffu, qb[0] == 0.f && qb[1] == 0.f);
    if (lane == 0) sflag[warp] = warp_ok;
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (sflag[0] && sflag[1] && sflag[2] && sflag[3])
      consume<D, true, false>(sjob, base, sbias, sinfo, wg, r_loc, c, zero);
    else
      consume<D, true, true>(sjob, base, sbias, sinfo, wg, r_loc, c, qb);
  }
}

// ---------------------------------------------------------------------------
// host side: 3-D tensor maps (D, rows, batch x head) of bf16 in head dim D's
// swizzle, read in boxes of (SW / 2, box_rows, 1); rows past the end read as
// zeros

using sm90::encode_tiled;
using sm90::EncodeTiledFn;

// 0 on success, else a CUDA runtime error code
template <int D>
inline int make_map(CUtensorMap* map, const void* ptr, int rows, int bh,
                    int box_rows = Geo<D>::BK) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};  // bytes, dims 1-2
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Smem<D>::BOX_COLS),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        Geo<D>::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace attn_sm90
