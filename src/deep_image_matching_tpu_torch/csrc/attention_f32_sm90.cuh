// The float32 form of the Hopper attention core, shared by kernel 1
// (attention.cu: dim_attention_f32 at head dim 64, dim_attention_hd96_f32 at
// 96) and kernel 6 (bidir_attention.cu, dim_bidir_attention_f32): one block
// computes 128 query rows of softmax(Q K^T) V over every key tile of one
// (batch, head), with an online softmax, and every product in split TF32 on
// the tensor cores (hi = rna_tf32(x), lo = rna_tf32(x - hi); lo.hi + hi.lo +
// hi.hi), so the result keeps f32-level accuracy where one TF32 product would
// not. The core is a template on the head dim D (64 or 96); the two differ in
// the key tile (Geo<D>) and the number of 32-float column boxes a row takes.
//
// What bounds it on the H100: the tensor cores, fed by many small products
// and by a split that every block repeats. Split TF32 is three TF32 products
// per multiply-add at half the bf16 rate; with 64 query rows a warpgroup and
// 64-key tiles each product is a wgmma m64n64k8 of 32 K multiply-adds, 96 of
// them a block a tile, and a warpgroup's issue of them returns only as the
// tensor cores take them. An earlier form of the core split Q, K and V into
// TF32 halves in a pass of three launches (kernel 6: four) before the kernel,
// 9-19 % of a call, and its consumers waited for S, ran the softmax, then
// P V (the softmax 21 % of the kernel at LightGlue's shape). The design:
//
// - One launch on the raw f32 operands; the block splits them. Block of
//   three warpgroups: two consume (64 query rows each), the third produces.
//   Producer thread 0 loads the raw Q tile once and keeps two raw (K, V)
//   tiles of BK keys in flight by TMA (K in 128-byte swizzled boxes 32 floats
//   wide, V as one unswizzled box of BK rows); rows and keys past the end
//   read as zeros. All 128 producer threads split each raw tile into the
//   operand slots: K into hi and lo in its own swizzled layout
//   (elementwise), V transposed to (d, keys) in hi and lo (TF32 wgmma has no
//   transpose bit, so both shared-memory operands must be K-major), each
//   group of 8 keys in the order 0 2 4 6 1 3 5 7 in which P's fragments
//   reach the product. The rounding is integer arithmetic (two operations a
//   half) and each thread issues a batch of reads before its writes, so the
//   split waits for one read latency a batch. Every block that reads a key
//   tile splits it (Nq / 128 blocks a (batch, head)); that repeated split is
//   what the core pays for the pass it no longer launches.
// - Q is split once, into registers: each consumer reads its 64 rows from the
//   swizzled raw tile straight into the A fragments of S's products (hi and
//   lo, D / 2 registers each), so S = Q K^T is wgmma m64nBKk8 with A in
//   registers (Qlo.Khi + Qhi.Klo + Qhi.Khi per 8-deep step) and reads only K
//   from shared memory, as P V (m64nDk8, P's halves in registers) reads only
//   V^T; the split's own shared-memory traffic takes the room.
// - S(t) is issued together with P V(t - 1), as in the bf16 core, so the
//   consumers hold two tiles at a time: K slots are a ring of two, released
//   after a tile's softmax, V^T slots a ring of three, released after its
//   P V, the third in the Q tile's place once both consumers have read Q.
//   The accumulator gives each thread keys 2c, 2c + 1 of each group of 8,
//   which the A fragment of a k8 product takes as its k and k + 4, so P's
//   halves go to the product unpermuted. Registers a consumer thread: Q's
//   halves (D), S (BK / 2), P's halves (BK) and O (D / 2): 192 at D = 64 with
//   64-key tiles and at D = 96 with 32-key tiles, within the 224 that
//   `setmaxnreg` gives it (the producer keeps 56).
// - Shared memory at D = 64: the raw Q tile (32 KB), two K slots and two V^T
//   slots in hi and lo (128 KB) and two raw tiles (64 KB), 225 KB of the 227
//   a block can have. At D = 96 a 64-key tile would not fit, so the tiles are
//   32 keys and S is m64n32k8.
// - Every product, the order of the sums, P in f32, the masks, the skip of
//   all-masked key tiles, all-masked query tiles written as zeros, the
//   running maxima (from -inf for kernel 1, -1e30 with row biases for
//   kernel 6) and the outputs' normalisation are the bf16 core's and the
//   earlier f32 core's, so the outputs equal that core's bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace attn_f32 {

constexpr int BQ = 128;        // query rows per block, 64 per consumer warpgroup
constexpr int KSTAGES = 2;     // K operand slots
constexpr int VSTAGES = 3;     // V^T operand slots, the third in the Q tile's place
constexpr int RAWS = 2;        // raw (K, V) tiles in flight
constexpr int CONSUMERS = 256;
constexpr int PRODUCERS = 128;
constexpr int THREADS = CONSUMERS + PRODUCERS;  // warpgroups 0-1 consume, warpgroup 2 produces
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
// block h) at NDB w + h, raw f32. A K slot: NDB column blocks of BK rows,
// hi and lo in two arrays of slots; a V^T slot: NKB key blocks of D rows, hi
// then lo; V^T slots 0 and 1 have their own place, slot 2 takes the Q tile's
// once the consumers hold Q in registers. A raw tile: K as its slot's layout,
// then V (BK rows of D floats). K slot info: 1 all keys valid, 0 not, -1 the
// end marker.
template <int D>
struct Smem {
  static constexpr int BK = Geo<D>::BK;
  static constexpr int NDB = D / 32;     // 32-float column blocks of a Q or K row
  static constexpr int NKB = BK / 32;    // 32-key blocks of a V^T row
  static constexpr int KBOX = BK * 128;  // one K box
  static constexpr int VBOX = D * 128;   // one V^T box
  static constexpr int K_BYTES = NDB * KBOX;  // one K slot, one half
  static constexpr int V_BYTES = NKB * VBOX;  // one V^T slot, one half
  static constexpr int Q_BYTES = 2 * NDB * QBOX;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_KHI = Q_BYTES;
  static constexpr int OFF_KLO = OFF_KHI + KSTAGES * K_BYTES;
  static constexpr int OFF_V = OFF_KLO + KSTAGES * K_BYTES;  // V^T slots 0 and 1
  static constexpr int OFF_RAW = OFF_V + 2 * 2 * V_BYTES;
  static constexpr int RAW_V = K_BYTES;             // V within a raw tile
  static constexpr int RAW_BYTES = K_BYTES + BK * D * 4;
  static constexpr int OFF_BIAS = OFF_RAW + RAWS * RAW_BYTES;  // float [KSTAGES][BK]
  static constexpr int OFF_INFO = OFF_BIAS + KSTAGES * BK * 4;  // int [KSTAGES]
  // u64: q, kfull[KSTAGES], kempty[KSTAGES], vfull[VSTAGES], vempty[VSTAGES],
  // raw[RAWS], q_free
  static constexpr int OFF_BAR = OFF_INFO + 4 * KSTAGES;
  static constexpr int SMEM_BYTES =
      OFF_BAR + 8 * (1 + 2 * KSTAGES + 2 * VSTAGES + RAWS + 1) + 1024;  // + alignment
  static_assert(Q_BYTES >= 2 * V_BYTES, "a V^T slot must fit in the Q tile's place");
  static_assert(OFF_BAR % 8 == 0, "mbarriers are 8-byte aligned");
};
// the block's static shared memory (its Job, padded to 1024 bytes) and the
// dynamic, within the 227 KB a block can have
static_assert(Smem<64>::SMEM_BYTES + 1024 <= 232448 && Smem<96>::SMEM_BYTES + 1024 <= 232448,
              "the f32 core's shared memory exceeds a block's 227 KB");

// the offset of V^T slot s (hi, then lo V_BYTES on)
template <int D>
__device__ __forceinline__ uint32_t vt_slot(int s) {
  using L = Smem<D>;
  return s < 2 ? L::OFF_V + s * 2 * L::V_BYTES : L::OFF_Q;
}

// the barriers' addresses (each + 8 * slot)
struct Bars {
  uint32_t q, kfull, kempty, vfull, vempty, raw, q_free;
  __device__ __forceinline__ explicit Bars(uint32_t bar0)
      : q(bar0),
        kfull(bar0 + 8),
        kempty(kfull + 8 * KSTAGES),
        vfull(kempty + 8 * KSTAGES),
        vempty(vfull + 8 * VSTAGES),
        raw(vempty + 8 * VSTAGES),
        q_free(raw + 8 * RAWS) {}
};

struct Job {
  const CUtensorMap* qmap;  // (D, Nq, B*H) f32, 128-byte swizzle, (32, 64) boxes
  const CUtensorMap* kmap;  // (D, Nk, B*H) f32, 128-byte swizzle, (32, BK) boxes
  const CUtensorMap* vmap;  // (D, Nk, B*H) f32, no swizzle, (D, BK) boxes
  const uint8_t* qmask;     // (Nq) of this batch element, or null
  const uint8_t* kmask;     // (Nk) of this batch element, or null
  float* out;               // (Nq, D) of this (batch, head)
  int bh, q0, Nq, Nk;
  float scale_log2;
};

using sm90::fence_proxy_async;
using sm90::fence_regs;
using sm90::mbar_arrive;
using sm90::mbar_arrive_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::sw128_desc;
using sm90::tma_load_3d;
using sm90::wg_commit;
using sm90::wg_fence;
using sm90::wg_wait;

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (10 mantissa bits, ties
// away from zero): half a TF32 ulp added to the magnitude's bits, the low 13
// bits cleared. Two integer operations at the full issue rate in place of a
// conversion instruction of lower throughput: every block splits every key
// tile it reads.
__device__ __forceinline__ uint32_t rna_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ float rna_tf32(float x) { return __uint_as_float(rna_bits(x)); }

// x split into TF32 halves: hi = rna_tf32(x), lo = rna_tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_bits(x);
  lo = rna_bits(x - __uint_as_float(hi));
}

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

// the split-TF32 products by accumulator width, A in registers: S (64 x BK),
// O (64 x D)
__device__ __forceinline__ void mma_s(float (&d)[32], const uint32_t* a, uint64_t db, int acc) {
  sm90::wgmma_tf32_n64_rs(d, a, db, acc);
}
__device__ __forceinline__ void mma_s(float (&d)[16], const uint32_t* a, uint64_t db, int acc) {
  sm90::wgmma_tf32_n32_rs(d, a, db, acc);
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

// ---------------------------------------------------------------------------
// the consumers

// The warpgroup's 64 rows of Q as the A fragments of S's k8 steps, split
// into TF32 halves: for step kk, a[0] is row 16 warp + g, column 8 kk + t
// (g = lane / 4, t = lane % 4), a[1] the row 8 below, a[2] and a[3] the same
// rows 4 columns on; read from the raw tile's 128-byte swizzle (16-byte
// chunk index XOR row % 8, and row % 8 == g), which spreads a warp's reads
// over all 32 banks.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qh)[D / 2], uint32_t (&ql)[D / 2],
                                       const uint8_t* sm, int wg, int warp, int lane) {
  using L = Smem<D>;
  const int g = lane >> 2, t = lane & 3;
  const float* q = reinterpret_cast<const float*>(sm + L::OFF_Q + L::NDB * wg * QBOX);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + g + 8 * (e & 1);
      const int chunk = (2 * (kk & 3) + (e >> 1)) ^ g;
      const float x = q[(kk >> 2) * (QBOX / 4) + row * 32 + chunk * 4 + t];
      split_tf32(x, qh[4 * kk + e], ql[4 * kk + e]);
    }
  }
}

// S = Q K^T for one K slot (hi, lo): D / 8 steps of 8 along d, 32 bytes each
// within a 128-byte row, three products a step
template <int D, int N>
__device__ __forceinline__ void issue_s(float (&s)[N], const uint32_t (&qh)[D / 2],
                                        const uint32_t (&ql)[D / 2], uint32_t khi,
                                        uint32_t klo) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t box = (kk >> 2) * L::KBOX, off = 2 * (kk & 3);
    const uint64_t dkh = sw128_desc(khi + box, 1) + off;
    const uint64_t dkl = sw128_desc(klo + box, 1) + off;
    mma_s(s, ql + 4 * kk, dkh, kk);
    mma_s(s, qh + 4 * kk, dkl, 1);
    mma_s(s, qh + 4 * kk, dkh, 1);
  }
}

// O += P V for one V^T slot (hi, lo): BK / 8 steps of 8 keys
template <int D, int N>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&ph)[N],
                                         const uint32_t (&pl)[N], uint32_t vhi, uint32_t vlo) {
  using L = Smem<D>;
#pragma unroll
  for (int j = 0; j < L::BK / 8; ++j) {
    const uint32_t box = (j >> 2) * L::VBOX, off = 2 * (j & 3);
    const uint64_t dvh = sw128_desc(vhi + box, 1) + off;
    const uint64_t dvl = sw128_desc(vlo + box, 1) + off;
    mma_o(o, pl + 4 * j, dvh);
    mma_o(o, ph + 4 * j, dvl);
    mma_o(o, ph + 4 * j, dvh);
  }
}

// P's TF32 halves as A fragments: for keys 8 j .. 8 j + 7, k = c / 2 is key
// 8 j + c and k + 4 key 8 j + c + 1 (V^T holds them in that order)
template <int N>
__device__ __forceinline__ void split_p(const float (&s)[N], uint32_t (&ph)[N],
                                        uint32_t (&pl)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    split_tf32(s[4 * j + 0], ph[4 * j + 0], pl[4 * j + 0]);
    split_tf32(s[4 * j + 2], ph[4 * j + 1], pl[4 * j + 1]);
    split_tf32(s[4 * j + 1], ph[4 * j + 2], pl[4 * j + 2]);
    split_tf32(s[4 * j + 3], ph[4 * j + 3], pl[4 * j + 3]);
  }
}

// The tile loop of one consumer warpgroup over its 64 rows (the thread's
// rows r_loc and r_loc + 8, keys 8 j + c and 8 j + c + 1 of each tile).
// Tile t's K slot is released after its softmax, its V^T slot after P V(t),
// which is issued with tile t + 1's S.
template <int D, bool BIDIR>
__device__ __forceinline__ void consume(const Job& sjob, uint32_t base, const uint8_t* sm,
                                        int wg, int warp, int lane, const float (&qb)[2]) {
  using L = Smem<D>;
  constexpr int BK = L::BK;
  const Bars bar(base + L::OFF_BAR);
  const float* sbias = reinterpret_cast<const float*>(sm + L::OFF_BIAS);
  const int* sinfo = reinterpret_cast<const int*>(sm + L::OFF_INFO);
  const int r_loc = wg * 64 + warp * 16 + lane / 4;  // rows r_loc, r_loc + 8
  const int c = (lane % 4) * 2;                      // keys / columns 8 j + c, + 1
  const float C = sjob.scale_log2;
  float m[2] = {BIDIR ? NEG : -INFINITY, BIDIR ? NEG : -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t qh[D / 2], ql[D / 2];
  mbar_wait(bar.q, 0);
  load_q<D>(qh, ql, sm, wg, warp, lane);
  mbar_arrive(bar.q_free);  // the Q tile's place may now take a V^T slot

  float s[BK / 2];                   // the newest tile's scores, then its probabilities
  uint32_t ph[BK / 2], pl[BK / 2];  // the previous tile's P as TF32 A fragments
  float corr[2];
  // the first tile (there is one: a skipped tile is all masked, and then
  // some tile has a valid key): S, then its softmax
  mbar_wait(bar.kfull, 0);
  wg_fence();
  issue_s<D>(s, qh, ql, base + L::OFF_KHI, base + L::OFF_KLO);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  softmax_tile<BIDIR>(s, sbias, sinfo[0] > 0, c, qb, C, m, l, corr);
  mbar_arrive(bar.kempty);
  split_p(s, ph, pl);
  int stage = 1, vs = 0;  // the next tile's K slot, the previous tile's V^T slot
  uint32_t phase = 0, vphase = 0;

  while (true) {
    mbar_wait(bar.kfull + 8 * stage, phase);
    const int info = *reinterpret_cast<const volatile int*>(sinfo + stage);
    if (info < 0) break;
    mbar_wait(bar.vfull + 8 * vs, vphase);
    wg_fence();
    issue_s<D>(s, qh, ql, base + L::OFF_KHI + stage * L::K_BYTES,
               base + L::OFF_KLO + stage * L::K_BYTES);
    wg_commit();
    issue_pv<D>(o, ph, pl, base + vt_slot<D>(vs), base + vt_slot<D>(vs) + L::V_BYTES);
    wg_commit();
    wg_wait<1>();  // S(t) is done, P V(t - 1) may still run
    fence_regs(s);
    softmax_tile<BIDIR>(s, sbias + stage * BK, info > 0, c, qb, C, m, l, corr);
    mbar_arrive(bar.kempty + 8 * stage);
    wg_wait<0>();
    fence_regs(o);
    fence_regs(ph);  // P V(t - 1) has read them: ph and pl may now be rewritten
    fence_regs(pl);
    mbar_arrive(bar.vempty + 8 * vs);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    split_p(s, ph, pl);
    if (++stage == KSTAGES) {
      stage = 0;
      phase ^= 1;
    }
    if (++vs == VSTAGES) {
      vs = 0;
      vphase ^= 1;
    }
  }
  mbar_wait(bar.vfull + 8 * vs, vphase);
  wg_fence();
  issue_pv<D>(o, ph, pl, base + vt_slot<D>(vs), base + vt_slot<D>(vs) + L::V_BYTES);
  wg_commit();
  wg_wait<0>();
  fence_regs(o);

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

// ---------------------------------------------------------------------------
// the producer warpgroup

__device__ __forceinline__ float4 rna4(float4 x) {
  return make_float4(rna_tf32(x.x), rna_tf32(x.y), rna_tf32(x.z), rna_tf32(x.w));
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// The split of a raw tile runs in batches: a batch's shared-memory reads are
// all issued before its writes, which the compiler could not otherwise move
// past the writes of the item before (it cannot tell the two apart), so one
// read latency a batch is waited for, not one an item.
constexpr int K_BATCH = 4;  // 16-byte K items a thread has in flight, at most
constexpr int V_BATCH = 2;  // (d, 8 keys) V items a thread has in flight, at most

// the largest divisor of n not above most
__host__ __device__ constexpr int batch(int n, int most) {
  return most <= 1 || n % most == 0 ? most : batch(n, most - 1);
}

// a raw K tile into a K slot's hi and lo: the same swizzled layout, so
// elementwise, 16 bytes a thread at a time
template <int D>
__device__ __forceinline__ void split_k(uint8_t* sm, int raw, int stage, int ptid) {
  using L = Smem<D>;
  constexpr int ITEMS = L::K_BYTES / 16 / PRODUCERS;  // 8 (D = 64) or 6 (D = 96)
  static_assert(ITEMS * 16 * PRODUCERS == L::K_BYTES, "K items");
  constexpr int NB = batch(ITEMS, K_BATCH);
  const float4* src = reinterpret_cast<const float4*>(sm + L::OFF_RAW + raw * L::RAW_BYTES);
  float4* hi = reinterpret_cast<float4*>(sm + L::OFF_KHI + stage * L::K_BYTES);
  float4* lo = reinterpret_cast<float4*>(sm + L::OFF_KLO + stage * L::K_BYTES);
#pragma unroll
  for (int b = 0; b < ITEMS; b += NB) {
    float4 x[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) x[n] = src[ptid + (b + n) * PRODUCERS];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float4 h = rna4(x[n]);
      hi[ptid + (b + n) * PRODUCERS] = h;
      lo[ptid + (b + n) * PRODUCERS] = rna4(sub4(x[n], h));
    }
  }
}

// a raw V tile (BK rows of D floats) into a V^T slot's hi and lo: row d of
// the slot holds the tile's keys, each group of 8 in the order 0 2 4 6 1 3 5
// 7, in 128-byte swizzled boxes of 32 keys. One thread a (d, group): 8 reads
// down column d (consecutive threads, consecutive d: no bank conflict), four
// 16-byte writes (chunk index XOR d % 8: eight consecutive d cover all banks)
template <int D>
__device__ __forceinline__ void split_v(uint8_t* sm, int raw, int vs, int ptid) {
  using L = Smem<D>;
  constexpr int ITEMS = D * L::BK / 8 / PRODUCERS;  // 4 (D = 64) or 3 (D = 96)
  static_assert(ITEMS * 8 * PRODUCERS == D * L::BK, "V items");
  constexpr int NB = batch(ITEMS, V_BATCH);
  const float* src =
      reinterpret_cast<const float*>(sm + L::OFF_RAW + raw * L::RAW_BYTES + L::RAW_V);
  uint8_t* hi = sm + vt_slot<D>(vs);
  uint8_t* lo = hi + L::V_BYTES;
#pragma unroll
  for (int b = 0; b < ITEMS; b += NB) {
    float4 even[NB], odd[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int i = ptid + (b + n) * PRODUCERS, d = i % D, g = i / D;
      const float* col = src + 8 * g * D + d;
      even[n] = make_float4(col[0], col[2 * D], col[4 * D], col[6 * D]);
      odd[n] = make_float4(col[D], col[3 * D], col[5 * D], col[7 * D]);
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int i = ptid + (b + n) * PRODUCERS, d = i % D, g = i / D;
      const int row = (g >> 2) * L::VBOX + d * 128, chunk = 2 * (g & 3);
      const int a0 = row + ((chunk ^ (d & 7)) << 4), a1 = row + (((chunk + 1) ^ (d & 7)) << 4);
      const float4 he = rna4(even[n]), ho = rna4(odd[n]);
      *reinterpret_cast<float4*>(hi + a0) = he;
      *reinterpret_cast<float4*>(lo + a0) = rna4(sub4(even[n], he));
      *reinterpret_cast<float4*>(hi + a1) = ho;
      *reinterpret_cast<float4*>(lo + a1) = rna4(sub4(odd[n], ho));
    }
  }
}

// The tiles that are not skipped, 64 at a time: a tile whose keys are all
// masked is skipped when the batch element has a valid key. Bit i of live
// is tile w0 + i; every producer warp holds the same (lanes over a tile's
// keys), computed once a window, so finding the next tile reads no mask.
template <int BK>
struct Tiles {
  const Job& sjob;
  int ntiles, lane;
  bool any_k;
  int w0 = -64;
  uint64_t live = 0;

  __device__ __forceinline__ void window(int w) {
    constexpr int KPL = BK / 32;  // keys a lane: 2 (D = 64) or 1 (D = 96)
    w0 = w;
    const int n = min(64, ntiles - w0);
    live = n == 64 ? ~0ull : (1ull << n) - 1;
    if (sjob.kmask == nullptr || !any_k) return;
    uint64_t bits = 0;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      bool valid = false;
#pragma unroll
      for (int e = 0; e < KPL; ++e) {
        const int key = (w0 + i) * BK + lane * KPL + e;
        valid |= key < sjob.Nk && sjob.kmask[key] != 0;
      }
      bits |= static_cast<uint64_t>(__any_sync(0xffffffffu, valid)) << i;
    }
    live = bits;
  }
  // the first tile at or after t not skipped, or ntiles
  __device__ __forceinline__ int next(int t) {
    for (; t < ntiles; t = w0 + 64) {
      if (t >= w0 + 64) window(t & ~63);
      const uint64_t rest = live >> (t - w0);
      if (rest) return t + __ffsll(static_cast<long long>(rest)) - 1;
    }
    return ntiles;
  }
};

// tile t's key biases (0 valid, -1e30 masked, -inf past the end) into a
// slot's row of sbias, and whether all its keys are valid; one warp
template <int BK>
__device__ __forceinline__ void tile_bias(const Job& sjob, int t, float* bias, int* info,
                                          int lane) {
  constexpr int KPL = BK / 32;
  float kb[KPL];
  bool all_k = true;
#pragma unroll
  for (int e = 0; e < KPL; ++e) {
    const int key = t * BK + lane * KPL + e;
    const bool ok = key < sjob.Nk && (sjob.kmask == nullptr || sjob.kmask[key] != 0);
    kb[e] = key >= sjob.Nk ? -INFINITY : (ok ? 0.f : NEG);
    all_k &= ok;
  }
  const bool all_valid = __all_sync(0xffffffffu, all_k);
  if constexpr (KPL == 2)
    reinterpret_cast<float2*>(bias)[lane] = make_float2(kb[0], kb[1]);
  else
    bias[lane] = kb[0];
  if (lane == 0) *info = all_valid;
}

// The producer warpgroup: thread 0 loads Q and the raw tiles, all 128
// threads split each raw tile into its K and V^T slots. V^T slot 2 is the Q
// tile's place, taken once the consumers have read Q.
template <int D>
__device__ __forceinline__ void produce(const Job& sjob, uint32_t base, uint8_t* sm, bool any_k,
                                        int ptid) {
  using L = Smem<D>;
  constexpr int BK = L::BK;
  const Bars bar(base + L::OFF_BAR);
  float* sbias = reinterpret_cast<float*>(sm + L::OFF_BIAS);
  int* sinfo = reinterpret_cast<int*>(sm + L::OFF_INFO);
  const int lane = ptid & 31;
  if (ptid == 0) {
    mbar_arrive_tx(bar.q, L::Q_BYTES);
    for (int w = 0; w < 2; ++w)
      for (int h = 0; h < L::NDB; ++h)
        tma_load_3d(base + L::OFF_Q + (L::NDB * w + h) * QBOX, sjob.qmap, bar.q, 32 * h,
                    sjob.q0 + 64 * w, sjob.bh);
  }
  // the raw K and V of tile t into raw slot r
  auto load_raw = [&](int t, int r) {
    const uint32_t dst = base + L::OFF_RAW + r * L::RAW_BYTES, full = bar.raw + 8 * r;
    mbar_arrive_tx(full, L::RAW_BYTES);
    for (int h = 0; h < L::NDB; ++h)
      tma_load_3d(dst + h * L::KBOX, sjob.kmap, full, 32 * h, t * BK, sjob.bh);
    tma_load_3d(dst + L::RAW_V, sjob.vmap, full, 0, t * BK, sjob.bh);
  };
  Tiles<BK> tiles{sjob, (sjob.Nk + BK - 1) / BK, lane, any_k};
  const int ntiles = tiles.ntiles;
  int t = tiles.next(0);
  if (ptid == 0) load_raw(t, 0);  // there is a first tile (see the consumers)
  int raw = 0, stage = 0, vs = 0;
  uint32_t raw_phase = 0, phase = 0, vphase = 0;
  for (int i = 0; t < ntiles; ++i) {
    const int tn = tiles.next(t + 1);
    // the other raw slot was read through in the last step (the barrier below)
    if (ptid == 0 && tn < ntiles) load_raw(tn, raw ^ 1);
    mbar_wait(bar.raw + 8 * raw, raw_phase);
    mbar_wait(bar.kempty + 8 * stage, phase ^ 1);
    split_k<D>(sm, raw, stage, ptid);
    if (ptid < 32) tile_bias<BK>(sjob, t, sbias + stage * BK, sinfo + stage, lane);
    fence_proxy_async();  // the generic writes, before the products read them
    mbar_arrive(bar.kfull + 8 * stage);
    if (i == VSTAGES - 1) mbar_wait(bar.q_free, 0);
    mbar_wait(bar.vempty + 8 * vs, vphase ^ 1);
    split_v<D>(sm, raw, vs, ptid);
    fence_proxy_async();
    mbar_arrive(bar.vfull + 8 * vs);
    asm volatile("bar.sync 1, %0;" ::"n"(PRODUCERS) : "memory");  // raw slot read through
    raw ^= 1;
    if (raw == 0) raw_phase ^= 1;
    if (++stage == KSTAGES) {
      stage = 0;
      phase ^= 1;
    }
    if (++vs == VSTAGES) {
      vs = 0;
      vphase ^= 1;
    }
    t = tn;
  }
  // the end marker
  mbar_wait(bar.kempty + 8 * stage, phase ^ 1);
  if (ptid == 0) sinfo[stage] = -1;
  mbar_arrive(bar.kfull + 8 * stage);
}

// One block of BQ query rows at head dim D. BIDIR selects kernel 6's
// numerics (row bias, maxima from -1e30, output over max(l, 1e-30)) over
// kernel 1's.
template <int D, bool BIDIR>
__device__ __forceinline__ void attention_block(const Job& job) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) uint8_t dyn_smem[];
  const int tid = threadIdx.x;
  uint32_t base = smem_u32(dyn_smem);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  uint8_t* sm = dyn_smem + pad;
  base += pad;
  const Bars bar(base + L::OFF_BAR);

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
    // the consumer warpgroups with rows before the end release the slots
    const uint32_t consumers = job.q0 + 64 < job.Nq ? CONSUMERS : CONSUMERS / 2;
    mbar_init(bar.q, 1);
    for (int s = 0; s < KSTAGES; ++s) {
      mbar_init(bar.kfull + 8 * s, PRODUCERS);
      mbar_init(bar.kempty + 8 * s, consumers);
    }
    for (int s = 0; s < VSTAGES; ++s) {
      mbar_init(bar.vfull + 8 * s, PRODUCERS);
      mbar_init(bar.vempty + 8 * s, consumers);
    }
    for (int r = 0; r < RAWS; ++r) mbar_init(bar.raw + 8 * r, 1);
    mbar_init(bar.q_free, consumers);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------- producer warpgroup ------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    produce<D>(sjob, base, sm, any_k, tid - CONSUMERS);
  } else {
    // ---------------- consumer warpgroups: 64 query rows each ---------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    if (sjob.q0 + wg * 64 >= sjob.Nq) return;  // every row past the end
    float qb[2] = {0.f, 0.f};
    if (BIDIR) {
      // kernel 6's row biases: -1e30 for a masked row or one past the end
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = sjob.q0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
        qb[r] = (row < sjob.Nq && sjob.qmask[row]) ? 0.f : NEG;
      }
    }
    consume<D, BIDIR>(sjob, base, sm, wg, warp, lane, qb);
  }
}

// ---------------------------------------------------------------------------
// the host side, local to each source that includes it

namespace {

// 3-D f32 tensor map (D, rows, bh) of a row-major (bh, rows, D) tensor, read
// in 128-byte swizzled boxes of (32, box_rows, 1): a warpgroup's 64 query
// rows or a key tile; elements past the end read as zeros. 0 on success.
template <int D>
inline int make_row_map(CUtensorMap* map, const void* ptr, int rows, int bh, int box_rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(bh)};
  const uint32_t box[3] = {32, static_cast<uint32_t>(box_rows), 1};
  return sm90::encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, 3, dims, box);
}

// the same for V, unswizzled, in boxes of a whole key tile (D, BK, 1)
template <int D>
inline int make_v_map(CUtensorMap* map, const void* ptr, int rows, int bh) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(bh)};
  const uint32_t box[3] = {D, static_cast<uint32_t>(Geo<D>::BK), 1};
  return sm90::encode_tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, 3, dims, box,
                                CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace

}  // namespace attn_f32
