// The float32 form of the Hopper attention core, shared by kernel 1
// (attention.cu: dim_attention_f32 at head dim 64, dim_attention_hd96_f32 at
// 96) and kernel 6 (bidir_attention.cu, dim_bidir_attention_f32): one block
// computes 128 query rows of softmax(Q K^T) V over every key tile of one
// (batch, head), with an online softmax, and every product in split TF32 on
// the tensor cores, so the result keeps f32-level accuracy where one TF32
// product would not. The core is a template on the head dim D (64 or 96);
// the two differ only in the key tile (Geo<D>) and the number of 32-float
// column boxes a row takes.
//
// What bounds it on the H100: tensor-core issue. Split TF32 is three TF32
// products per multiply-add, and TF32 runs at half the bf16 rate, so a call
// is six times the bf16 form's tensor-core work; the exp2 of the softmax
// stays what it was. The design keeps the bf16 core's shape
// (attention_sm90.cuh) where f32 allows it:
//
// - A split pass per call. Q and K are split into TF32 halves,
//   hi = rna_tf32(x) and lo = rna_tf32(x - hi), by a small elementwise
//   kernel (as the assignment, kernel 3, splits its operands), and V is
//   split and transposed to (d, keys): TF32 wgmma has no transpose bit, so
//   both shared-memory operands must be K-major, and V (key, d) is N-major
//   for O += P V. Within each group of 8 keys the transposed V holds the keys
//   in the order 0 2 4 6 1 3 5 7, the order in which the P fragments below
//   reach the product. The pass reads each operand once and writes its two
//   halves; the bound counts the function's bytes only (it is bound by
//   operations either way).
// - Block of three warpgroups: two consume (64 query rows each), one warp of
//   the third produces. The producer loads the Q tile once (hi and lo) and
//   keeps a ring of two stages in flight, each a tile of BK keys of K and V^T
//   in hi and lo, by TMA: 3-D maps with 128-byte swizzle, whose box is 32
//   floats wide, so a row of D floats takes D / 32 boxes; rows and keys past
//   the end read as zeros. D = 64: 64-key stages of 64 KB beside a 64 KB Q
//   tile. D = 96: the Q tile is 96 KB in hi and lo, and a 64-key stage would
//   be 96 KB, so two of them and Q exceed the 227 KB a block can have; the
//   stages are 32 keys (48 KB) instead, and S is m64n32k8.
// - S = Q K^T is wgmma m64nBKk8 with both operands in shared memory, as
//   Qlo.Khi + Qhi.Klo + Qhi.Khi per 8-deep step. P stays in registers: the
//   accumulator gives each thread keys 2c, 2c + 1 of each group of 8, which
//   the A fragment of a k8 product takes as its k and k + 4, so P's halves
//   go to O += P V (m64nDk8, A in registers) unpermuted, against V^T in the
//   permuted key order. The products run one after the other (S, softmax,
//   PV): no overlap of the softmax with the tensor cores.
// - Masks, the skip of all-masked key tiles, all-masked query tiles written
//   as zeros, the running maxima (from -inf for kernel 1, -1e30 with row
//   biases for kernel 6) and the outputs' normalisation are the bf16 core's;
//   the softmax's P stays f32 into the product and the output is f32.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace attn_f32 {

constexpr int BQ = 128;        // query rows per block, 64 per consumer warpgroup
constexpr int STAGES = 2;      // (K, V^T) tiles in flight
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int QBOX = 64 * 128; // one Q box: 64 rows of one 32-float column block, 8 KB
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// keys per tile at head dim D
template <int D>
struct Geo;
template <>
struct Geo<64> {
  static constexpr int BK = 64;
};
template <>
struct Geo<96> {
  static constexpr int BK = 32;
};

// shared memory from a 1024-byte aligned base. Q: box (row half w, column
// block h) at NDB w + h, hi then lo. A stage: K hi (NDB column blocks of BK
// rows), K lo, V^T hi (NKB key blocks of D rows), V^T lo. Stage info: 1 all
// keys valid, 0 not, -1 the end marker.
template <int D>
struct Smem {
  static constexpr int BK = Geo<D>::BK;
  static constexpr int NDB = D / 32;     // 32-float column blocks of a Q or K row
  static constexpr int NKB = BK / 32;    // 32-key blocks of a V^T row
  static constexpr int KBOX = BK * 128;  // one K box
  static constexpr int VBOX = D * 128;   // one V^T box
  static constexpr int OFF_QHI = 0;
  static constexpr int OFF_QLO = 2 * NDB * QBOX;
  static constexpr int Q_BYTES = 4 * NDB * QBOX;
  static constexpr int S_KHI = 0, S_KLO = NDB * KBOX, S_VHI = 2 * NDB * KBOX;
  static constexpr int S_VLO = S_VHI + NKB * VBOX;
  static constexpr int STAGE_BYTES = S_VLO + NKB * VBOX;
  static constexpr int OFF_STAGE = Q_BYTES;
  static constexpr int OFF_BIAS = OFF_STAGE + STAGES * STAGE_BYTES;  // float [STAGES][BK]
  static constexpr int OFF_INFO = OFF_BIAS + STAGES * BK * 4;        // int [STAGES]
  static constexpr int OFF_BAR = OFF_INFO + 16 * STAGES;  // u64: q, full[STAGES], empty[STAGES]
  static constexpr int SMEM_BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

struct Job {
  const CUtensorMap *qhi, *qlo;  // (D, Nq, B*H) f32: the split Q
  const CUtensorMap *khi, *klo;  // (D, Nk, B*H) f32: the split K
  const CUtensorMap *vhi, *vlo;  // (Nkp, D, B*H) f32: the split, transposed V
  const uint8_t* qmask;          // (Nq) of this batch element, or null
  const uint8_t* kmask;          // (Nk) of this batch element, or null
  float* out;                    // (Nq, D) of this (batch, head)
  int bh, q0, Nq, Nk;
  float scale_log2;
};

using sm90::fence_regs;
using sm90::mbar_arrive;
using sm90::mbar_arrive_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::split_tf32;
using sm90::sw128_desc;
using sm90::tma_load_3d;
using sm90::wg_commit;
using sm90::wg_fence;
using sm90::wg_wait;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the maximum (sum) of row r's N / 2 values s[4 j + 2 r + {0, 1}]
template <int R, int N>
__device__ __forceinline__ float row_max(const float (&s)[N]) {
  float a = fmaxf(s[2 * R], s[2 * R + 1]), b = fmaxf(s[4 + 2 * R], s[5 + 2 * R]);
#pragma unroll
  for (int j = 2; j < N / 4; j += 2) {
    a = fmaxf(a, fmaxf(s[4 * j + 2 * R], s[4 * j + 2 * R + 1]));
    b = fmaxf(b, fmaxf(s[4 * j + 4 + 2 * R], s[4 * j + 5 + 2 * R]));
  }
  return fmaxf(a, b);
}
template <int R, int N>
__device__ __forceinline__ float row_sum(const float (&s)[N]) {
  float a = s[2 * R] + s[2 * R + 1], b = s[4 + 2 * R] + s[5 + 2 * R];
#pragma unroll
  for (int j = 2; j < N / 4; j += 2) {
    a += s[4 * j + 2 * R] + s[4 * j + 2 * R + 1];
    b += s[4 * j + 4 + 2 * R] + s[4 * j + 5 + 2 * R];
  }
  return a + b;
}

// new running maxima from the tile maxima of the thread's two rows (over the
// 4 threads of a row); corr rescales the old sums
__device__ __forceinline__ void update_max(const float (&mx)[2], float (&m)[2],
                                           float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[r], v);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
}

// Online softmax of one tile of N / 2 keys on the accumulator fragments:
// s[4 j + e] is row r + 8 (e / 2), key 8 j + c + (e % 2) of the tile. ROWB
// adds kernel 6's row biases qb. Without them a tile whose keys are all
// valid takes the short form, as in the bf16 core.
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

// the split-TF32 products by accumulator width: S (64 x BK) from shared
// memory, O (64 x D) with A in registers
__device__ __forceinline__ void mma_s(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  sm90::wgmma_tf32_n64(d, da, db, acc);
}
__device__ __forceinline__ void mma_s(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  sm90::wgmma_tf32_n32(d, da, db, acc);
}
__device__ __forceinline__ void mma_o(float (&d)[32], const uint32_t* a, uint64_t db) {
  sm90::wgmma_tf32_n64_rs(d, a, db, 1);
}
__device__ __forceinline__ void mma_o(float (&d)[48], const uint32_t* a, uint64_t db) {
  sm90::wgmma_tf32_n96_rs(d, a, db, 1);
}

// Block order as the bf16 core's: the full row tiles of every (batch, head)
// first, the ragged last row tiles last.
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

// The tile loop of one consumer warpgroup over its 64 rows (the thread's
// rows r_loc and r_loc + 8, keys 8 j + c and 8 j + c + 1 of each tile).
template <int D, bool BIDIR>
__device__ __forceinline__ void consume(const Job& sjob, uint32_t base, const float* sbias,
                                        const int* sinfo, int wg, int r_loc, int c,
                                        const float (&qb)[2]) {
  using L = Smem<D>;
  constexpr int BK = L::BK;
  const uint32_t bar_q = base + L::OFF_BAR;
  const uint32_t bar_full = bar_q + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8 * stage
  const float C = sjob.scale_log2;
  float m[2] = {BIDIR ? NEG : -INFINITY, BIDIR ? NEG : -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint64_t dqh[L::NDB], dql[L::NDB];
#pragma unroll
  for (int h = 0; h < L::NDB; ++h) {
    dqh[h] = sw128_desc(base + L::OFF_QHI + (L::NDB * wg + h) * QBOX, 1);
    dql[h] = sw128_desc(base + L::OFF_QLO + (L::NDB * wg + h) * QBOX, 1);
  }
  mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(bar_full + 8 * stage, phase);
    const int info = *reinterpret_cast<const volatile int*>(sinfo + stage);
    if (info < 0) break;
    const uint32_t st = base + L::OFF_STAGE + stage * L::STAGE_BYTES;
    // S = Q K^T: D / 8 steps of 8 along d, 32 bytes each within a 128-byte row
    float s[BK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int h = kk >> 2;
      const uint32_t off = 2 * (kk & 3);
      const uint64_t dkh = sw128_desc(st + L::S_KHI + h * L::KBOX, 1) + off;
      const uint64_t dkl = sw128_desc(st + L::S_KLO + h * L::KBOX, 1) + off;
      mma_s(s, dql[h] + off, dkh, kk);
      mma_s(s, dqh[h] + off, dkl, 1);
      mma_s(s, dqh[h] + off, dkh, 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    float corr[2];
    softmax_tile<BIDIR>(s, sbias + stage * BK, info > 0, c, qb, C, m, l, corr);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    // P's TF32 halves as A fragments: for keys 8 j .. 8 j + 7, k = c / 2 is
    // key 8 j + c and k + 4 key 8 j + c + 1 (V^T holds them in that order)
    uint32_t ph[BK / 2], pl[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      split_tf32(s[4 * j + 0], ph[4 * j + 0], pl[4 * j + 0]);
      split_tf32(s[4 * j + 2], ph[4 * j + 1], pl[4 * j + 1]);
      split_tf32(s[4 * j + 1], ph[4 * j + 2], pl[4 * j + 2]);
      split_tf32(s[4 * j + 3], ph[4 * j + 3], pl[4 * j + 3]);
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int h = j >> 2;
      const uint32_t off = 2 * (j & 3);
      const uint64_t dvh = sw128_desc(st + L::S_VHI + h * L::VBOX, 1) + off;
      const uint64_t dvl = sw128_desc(st + L::S_VLO + h * L::VBOX, 1) + off;
      mma_o(o, pl + 4 * j, dvh);
      mma_o(o, ph + 4 * j, dvl);
      mma_o(o, ph + 4 * j, dvh);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    mbar_arrive(bar_empty + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

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
      float* dst = sjob.out + static_cast<size_t>(row) * D + c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
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
  constexpr int KPL = BK / 32;  // keys a producer lane: 2 (D = 64) or 1 (D = 96)
  extern __shared__ __align__(1024) uint8_t dyn_smem[];
  const int tid = threadIdx.x;
  uint32_t base = smem_u32(dyn_smem);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  uint8_t* sm = dyn_smem + pad;
  base += pad;
  float* sbias = reinterpret_cast<float*>(sm + L::OFF_BIAS);
  int* sinfo = reinterpret_cast<int*>(sm + L::OFF_INFO);
  const uint32_t bar_q = base + L::OFF_BAR;
  const uint32_t bar_full = bar_q + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8 * stage

  // a query tile whose rows are all masked: zeros, nothing else
  bool any_q = job.qmask == nullptr;
  if (!any_q && tid < BQ && job.q0 + tid < job.Nq) any_q = job.qmask[job.q0 + tid] != 0;
  if (!__syncthreads_or(any_q)) {
    for (int i = tid; i < BQ * D / 4; i += THREADS) {
      const int r = job.q0 + i / (D / 4);
      if (r < job.Nq)
        *reinterpret_cast<float4*>(job.out + static_cast<size_t>(r) * D + (i % (D / 4)) * 4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  // whether this batch element has a valid key (then all-masked tiles skip)
  bool any_k = job.kmask == nullptr;
  for (int i = tid; !any_k && i < job.Nk; i += THREADS) any_k = job.kmask[i] != 0;
  any_k = __syncthreads_or(any_k);

  __shared__ Job sjob;
  if (tid == 0) {
    sjob = job;
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);          // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, CONSUMERS);  // every consumer thread
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------- producer warpgroup: one warp issues, three idle -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid < CONSUMERS + 32) {
      const int lane = tid - CONSUMERS;
      if (lane == 0) {
        mbar_arrive_tx(bar_q, L::Q_BYTES);
        for (int w = 0; w < 2; ++w)
          for (int h = 0; h < L::NDB; ++h) {
            tma_load_3d(base + L::OFF_QHI + (L::NDB * w + h) * QBOX, sjob.qhi, bar_q, 32 * h,
                        sjob.q0 + 64 * w, sjob.bh);
            tma_load_3d(base + L::OFF_QLO + (L::NDB * w + h) * QBOX, sjob.qlo, bar_q, 32 * h,
                        sjob.q0 + 64 * w, sjob.bh);
          }
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
        if constexpr (KPL == 2)
          reinterpret_cast<float2*>(sbias + stage * BK)[lane] = make_float2(kb[0], kb[1]);
        else
          sbias[stage * BK + lane] = kb[0];
        if (lane == 0) {
          sinfo[stage] = all_valid;
          const uint32_t full = bar_full + 8 * stage;
          const uint32_t st = base + L::OFF_STAGE + stage * L::STAGE_BYTES;
          mbar_arrive_tx(full, L::STAGE_BYTES);
          // K's column blocks and V^T's key blocks (two of each at D = 64)
          constexpr int NB = L::NDB > L::NKB ? L::NDB : L::NKB;
          for (int h = 0; h < NB; ++h) {
            if (h < L::NDB) {
              tma_load_3d(st + L::S_KHI + h * L::KBOX, sjob.khi, full, 32 * h, t * BK, sjob.bh);
              tma_load_3d(st + L::S_KLO + h * L::KBOX, sjob.klo, full, 32 * h, t * BK, sjob.bh);
            }
            if (h < L::NKB) {
              tma_load_3d(st + L::S_VHI + h * L::VBOX, sjob.vhi, full, t * BK + 32 * h, 0,
                          sjob.bh);
              tma_load_3d(st + L::S_VLO + h * L::VBOX, sjob.vlo, full, t * BK + 32 * h, 0,
                          sjob.bh);
            }
          }
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
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
    const int r_loc = wg * 64 + warp * 16 + lane / 4;  // rows r_loc, r_loc + 8
    const int c = (lane % 4) * 2;                      // keys / columns 8 j + c, + 1
    float qb[2] = {0.f, 0.f};
    if (BIDIR) {
      // kernel 6's row biases: -1e30 for a masked row or one past the end
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = sjob.q0 + r_loc + 8 * r;
        qb[r] = (row < sjob.Nq && sjob.qmask[row]) ? 0.f : NEG;
      }
    }
    consume<D, BIDIR>(sjob, base, sbias, sinfo, wg, r_loc, c, qb);
  }
}

// ---------------------------------------------------------------------------
// the split pass and the host side, local to each source that includes them

namespace {

// hi / lo of n4 float4s of x
__global__ void split_rows_kernel(const float4* __restrict__ x, float4* __restrict__ hi,
                                  float4* __restrict__ lo, int64_t n4) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[i];
    float4 h, l;
    h.x = sm90::rna_tf32(v.x); l.x = sm90::rna_tf32(v.x - h.x);
    h.y = sm90::rna_tf32(v.y); l.y = sm90::rna_tf32(v.y - h.y);
    h.z = sm90::rna_tf32(v.z); l.z = sm90::rna_tf32(v.z - h.z);
    h.w = sm90::rna_tf32(v.w); l.w = sm90::rna_tf32(v.w - h.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// v (BH, N, D) -> hi / lo (BH, D, Np) with Np = N rounded up to 8, keys
// past N zero; within each group of 8 keys, position p holds key 2 p (p < 4)
// or 2 (p - 4) + 1. One block per (batch x head, 64 keys).
template <int D>
__global__ void split_vt_kernel(const float* __restrict__ v, float* __restrict__ hi,
                                float* __restrict__ lo, int N, int Np) {
  __shared__ float t[64][D + 1];
  const int bh = blockIdx.y, k0 = blockIdx.x * 64;
  const float* src = v + static_cast<size_t>(bh) * N * D;
  for (int i = threadIdx.x; i < 64 * D; i += blockDim.x) {
    const int key = k0 + i / D;
    t[i / D][i % D] = key < N ? src[static_cast<size_t>(key) * D + i % D] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * D; i += blockDim.x) {
    const int d = i / 64, p = i % 64, pos = k0 + p;
    if (pos >= Np) continue;
    const int q = p & 7;
    const float x = t[(p & ~7) + (q < 4 ? 2 * q : 2 * (q - 4) + 1)][d];
    const float h = sm90::rna_tf32(x);
    const size_t o = (static_cast<size_t>(bh) * D + d) * Np + pos;
    hi[o] = h;
    lo[o] = sm90::rna_tf32(x - h);
  }
}

// keys of the transposed V, rounded up so that each row is 16-byte aligned
// and whole groups of 8 permute
inline int padded_keys(int N) { return (N + 7) / 8 * 8; }

// hi, lo of x (n floats, n % 4 == 0) into out[0, n) and out[n, 2 n)
inline int split_rows(const float* x, float* out, int64_t n, cudaStream_t s) {
  const int64_t n4 = n / 4;
  const int blocks = static_cast<int>(n4 < 132 * 32 * 256 ? (n4 + 255) / 256 : 132 * 32);
  split_rows_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(x),
                                           reinterpret_cast<float4*>(out),
                                           reinterpret_cast<float4*>(out + n), n4);
  return static_cast<int>(cudaGetLastError());
}

// hi, lo of v (BH, N, D) transposed into out[0, BH D Np) and after it
template <int D>
inline int split_vt(const float* v, float* out, int BH, int N, cudaStream_t s) {
  const int Np = padded_keys(N);
  split_vt_kernel<D><<<dim3((Np + 63) / 64, BH), 256, 0, s>>>(
      v, out, out + static_cast<size_t>(BH) * D * Np, N, Np);
  return static_cast<int>(cudaGetLastError());
}

// 3-D f32 tensor map (inner, rows, bh) in 128-byte swizzle, (32, box_rows,
// 1) boxes; elements past the end read as zeros. 0 on success.
inline int make_map(CUtensorMap* map, const float* ptr, int inner, int rows, int bh,
                    int box_rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(inner), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(bh)};
  const uint32_t box[3] = {32, static_cast<uint32_t>(box_rows), 1};
  return sm90::encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, 3, dims, box);
}

// the maps of a split (hi then lo) row-major operand (BH, N, D), read in
// boxes of box_rows rows: 64 (a warpgroup's query rows) or the key tile
template <int D>
inline int make_row_maps(CUtensorMap* hi, CUtensorMap* lo, const float* split, int N, int BH,
                         int box_rows) {
  int e = make_map(hi, split, D, N, BH, box_rows);
  return e ? e : make_map(lo, split + static_cast<size_t>(BH) * N * D, D, N, BH, box_rows);
}

// the maps of a split transposed V (BH, D, Np), in boxes of 32 keys x D rows
template <int D>
inline int make_vt_maps(CUtensorMap* hi, CUtensorMap* lo, const float* split, int N, int BH) {
  const int Np = padded_keys(N);
  int e = make_map(hi, split, Np, D, BH, D);
  return e ? e : make_map(lo, split + static_cast<size_t>(BH) * D * Np, Np, D, BH, D);
}

}  // namespace

}  // namespace attn_f32
