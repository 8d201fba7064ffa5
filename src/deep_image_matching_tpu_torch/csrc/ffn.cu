// Fused feed-forward block of the matching transformers, in two modes:
//   mode 0, "ln_gelu" (LightGlue):
//     out = x + W2 . GELU(LN([x | msg] . W1^T + b1) * g + beta) + b2
//   mode 1, "relu" (SuperGlue's propagation MLP, BatchNorm folded into W1):
//     out = x + W2 . relu([x | msg] . W1^T + b1) + b2   (g, beta unused)
//
// Replaces the TPU kernel deep_image_matching_tpu/ops/pallas_ffn.py::ffn_fused
// (_ffn_kernel, both modes), which streams row tiles so the (rows, 2D) f32
// intermediate never reaches device memory.
//
// What bounds it on the H100: at LightGlue's shape (32768 rows, D = 256) one
// call is 25.8 GFLOP of bf16 products (0.026 ms at the tensor cores' peak)
// against 50 MB of activations in and out, so it is bound by tensor-core
// issue, and close behind by the weights' traffic from L2: every 64-row tile
// streams all 768 KB of W1 and W2. The design, on the pattern of the
// attention core (attention_sm90.cuh):
//
// - One block takes 64 rows. Its [x | msg] tile is loaded once by TMA as
//   eight 64 x 64 slabs in the 128-byte swizzle: the K-major A operand of
//   wgmma.
// - A producer warp streams the weights through a ring of two 64 KB stages
//   by TMA (one 64-wide k-slab of W1's 512 rows, then one of W2's 256 rows,
//   16 stages in all), each signalled on a full mbarrier and released on an
//   empty one. The weights stay in nn.Linear (out, in) layout, which is the
//   K-major B operand wgmma takes without a transpose.
// - Two consumer warpgroups hold the same 64 rows of h, 256 columns each:
//   h = [x | msg] W1^T is wgmma m64n256k16 into 128 f32 registers a thread
//   (`setmaxnreg` moves the producer's registers to them). The LayerNorm's
//   row sums and sums of squares are exchanged between the two through 1 KB
//   of shared memory; LayerNorm, the exact-erf GELU (or the relu) run in
//   registers, and the bf16 activation is written over the [x | msg] tile in
//   the swizzled layout the second product's A descriptor reads.
// - The second product (64 x 256, K = 512) is split by output columns: each
//   warpgroup runs m64n128k16 on its half of W2's slab. The epilogue adds b2
//   and the residual x (re-read from global memory) in f32.
// - Weight reuse is the trade-off: each 64-row tile re-streams W1 and W2
//   from L2 (393 MB per call at 32768 rows). A taller tile does not fit
//   (h of 128 rows is 256 KB of f32 registers), and the 192 KB of tiles
//   leave room for one block per SM; a cluster of two blocks sharing each
//   weight slab by TMA multicast would halve the traffic.
//
// Numerics follow the Pallas kernel: f32 accumulation, f32 LayerNorm
// statistics with eps 1e-5 (mean, then the mean of squared deviations),
// exact GELU through erff (the Pallas kernel's Abramowitz-Stegun erf differs
// from it by at most 1.5e-7), or relu of the f32 h, the activation cast to
// bf16 before the second product, the residual added in f32. Rows past the
// end are zero-filled by TMA and never stored. The mode is a template
// parameter: the relu kernel has no LayerNorm code at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int D = 256;            // model width
constexpr int D2 = 2 * D;         // hidden width and concat width
constexpr int BM = 64;            // rows per block
constexpr int SLAB = 64;          // k per slab: one 128-byte swizzle row of bf16
constexpr int NSLAB = D2 / SLAB;  // 8 k-slabs of each product
constexpr int CONSUMERS = 256;    // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int A_SLAB_BYTES = BM * SLAB * 2;       // 8 KB
constexpr int STAGE_BYTES = D2 * SLAB * 2;        // 64 KB: a slab of W1's 512 rows
constexpr int W2_SLAB_BYTES = D * SLAB * 2;       // 32 KB: a slab of W2's 256 rows,
                                                  // or of W1's rows of one warpgroup
constexpr int STAGES = 2;

// shared memory from a 1024-byte aligned base
constexpr int OFF_A = 0;                                  // [x | msg], then the activation
constexpr int OFF_W = OFF_A + NSLAB * A_SLAB_BYTES;       // the weight ring
constexpr int OFF_B1 = OFF_W + STAGES * STAGE_BYTES;      // f32 [512]
constexpr int OFF_G = OFF_B1 + D2 * 4;                    // f32 [512]
constexpr int OFF_BETA = OFF_G + D2 * 4;                  // f32 [512]
constexpr int OFF_B2 = OFF_BETA + D2 * 4;                 // f32 [256]
constexpr int OFF_RED = OFF_B2 + D * 4;                   // f32 [2 stats][2 wg][64 rows]
constexpr int OFF_BAR = OFF_RED + 2 * 2 * BM * 4;         // u64: a, full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack

__device__ __forceinline__ float bf2f(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// the sum over the four threads that share a row of the accumulator layout
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The accumulator layout of m64nNk16 (f32): d[4 j + e] is row
// 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + (e % 2).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
ffn_sm90(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap mmap,
         const __grid_constant__ CUtensorMap w1map, const __grid_constant__ CUtensorMap w2map,
         const uint16_t* __restrict__ x, const uint16_t* __restrict__ b1,
         const uint16_t* __restrict__ gam, const uint16_t* __restrict__ beta,
         const uint16_t* __restrict__ b2, uint16_t* __restrict__ out, int R) {
  extern __shared__ __align__(1024) uint8_t dyn_smem[];
  const int tid = threadIdx.x;
  uint32_t base = smem_u32(dyn_smem);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  uint8_t* sm = dyn_smem + pad;
  base += pad;
  const uint32_t bar_a = base + OFF_BAR;
  const uint32_t bar_full = bar_a + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // + 8 * stage
  const int row0 = blockIdx.x * BM;

  if (tid == 0) {
    mbar_init(bar_a, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------- producer warpgroup: one thread issues ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMERS) {
      mbar_arrive_tx(bar_a, NSLAB * A_SLAB_BYTES);
      for (int s = 0; s < NSLAB / 2; ++s) {
        tma_load_2d(base + OFF_A + s * A_SLAB_BYTES, &xmap, bar_a, s * SLAB, row0);
        tma_load_2d(base + OFF_A + (s + NSLAB / 2) * A_SLAB_BYTES, &mmap, bar_a, s * SLAB, row0);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < 2 * NSLAB; ++t) {
        mbar_wait(bar_empty + 8 * stage, phase ^ 1);
        const uint32_t full = bar_full + 8 * stage, dst = base + OFF_W + stage * STAGE_BYTES;
        if (t < NSLAB) {  // W1 slab t: both 256-row halves
          mbar_arrive_tx(full, STAGE_BYTES);
          tma_load_2d(dst, &w1map, full, t * SLAB, 0);
          tma_load_2d(dst + W2_SLAB_BYTES, &w1map, full, t * SLAB, D);
        } else {          // W2 slab t - 8
          mbar_arrive_tx(full, W2_SLAB_BYTES);
          tma_load_2d(dst, &w2map, full, (t - NSLAB) * SLAB, 0);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int c = (lane % 4) * 2;
  const int rl = warp * 16 + lane / 4;  // this thread's rows rl, rl + 8 of the tile
  float* sb1 = reinterpret_cast<float*>(sm + OFF_B1);
  float* sg = reinterpret_cast<float*>(sm + OFF_G);
  float* sbeta = reinterpret_cast<float*>(sm + OFF_BETA);
  float* sb2 = reinterpret_cast<float*>(sm + OFF_B2);
  float* red = reinterpret_cast<float*>(sm + OFF_RED);
  for (int i = tid; i < D2; i += CONSUMERS) {
    sb1[i] = bf2f(b1[i]);
    if (MODE == 0) {
      sg[i] = bf2f(gam[i]);
      sbeta[i] = bf2f(beta[i]);
    }
    if (i < D) sb2[i] = bf2f(b2[i]);
  }
  consumers_sync();

  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };

  // h = [x | msg] W1^T for columns [256 wg, 256 wg + 256): 8 slabs of 4
  // k-steps; slab s's stage is released once slab s + 1 is issued and s done
  float h[128];
  mbar_wait(bar_a, 0);
  int prev = -1;
#pragma unroll 1
  for (int s = 0; s < NSLAB; ++s) {
    mbar_wait(bar_full + 8 * stage, phase);
    const uint64_t da = sw128_desc(base + OFF_A + s * A_SLAB_BYTES, 1);
    const uint64_t db = sw128_desc(base + OFF_W + stage * STAGE_BYTES + wg * W2_SLAB_BYTES, 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < SLAB / 16; ++kk) wgmma_n256(h, da + 2 * kk, db + 2 * kk, s | kk);
    wg_commit();
    wg_wait<1>();  // slab s - 1 is done (s is still running into the same h)
    if (prev >= 0) mbar_arrive(bar_empty + 8 * prev);
    prev = stage;
    advance();
  }
  wg_wait<0>();
  fence_regs(h);
  mbar_arrive(bar_empty + 8 * prev);

  // + b1, then the activation
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = wg * D + 8 * j + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) h[4 * j + e] += sb1[col + (e & 1)];
  }
  if (MODE == 0) {
    // LayerNorm over the 512 columns of each row: this warpgroup's 256
    // through the quad, the other's through shared memory
    float mu[2], rstd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) sum += h[4 * j + 2 * r] + h[4 * j + 2 * r + 1];
      sum = quad_sum(sum);
      if (c == 0) red[wg * BM + rl + 8 * r] = sum;
    }
    consumers_sync();  // also: both warpgroups are done reading [x | msg]
#pragma unroll
    for (int r = 0; r < 2; ++r) mu[r] = (red[rl + 8 * r] + red[BM + rl + 8 * r]) / D2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float var = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float d0 = h[4 * j + 2 * r] - mu[r], d1 = h[4 * j + 2 * r + 1] - mu[r];
        var += d0 * d0 + d1 * d1;
      }
      var = quad_sum(var);
      if (c == 0) red[2 * BM + wg * BM + rl + 8 * r] = var;
    }
    consumers_sync();
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rstd[r] = rsqrtf((red[2 * BM + rl + 8 * r] + red[3 * BM + rl + 8 * r]) / D2 + 1e-5f);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = wg * D + 8 * j + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float hn = (h[4 * j + e] - mu[r]) * rstd[r] * sg[col + (e & 1)] + sbeta[col + (e & 1)];
        h[4 * j + e] = 0.5f * hn * (1.f + erff(hn * 0.7071067811865476f));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 128; ++i) h[i] = fmaxf(h[i], 0.f);
    consumers_sync();  // both warpgroups are done reading [x | msg]
  }

  // the bf16 activation over the [x | msg] tile, in the swizzled K-major
  // layout: column k of row r is slab k / 64, 16-byte chunk (k % 64) / 8
  // XOR (r % 8)
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int slab = wg * (D / SLAB) + j / 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;
      const int off = OFF_A + slab * A_SLAB_BYTES + row * 128 + (((j & 7) ^ (row & 7)) << 4) + c * 2;
      *reinterpret_cast<uint32_t*>(sm + off) = pack_bf16(h[4 * j + 2 * r], h[4 * j + 2 * r + 1]);
    }
  }
  fence_proxy_async();
  consumers_sync();

  // out = act W2^T for columns [128 wg, 128 wg + 128)
  float o[64];
#pragma unroll 1
  for (int s = 0; s < NSLAB; ++s) {
    mbar_wait(bar_full + 8 * stage, phase);
    const uint64_t da = sw128_desc(base + OFF_A + s * A_SLAB_BYTES, 1);
    const uint64_t db = sw128_desc(base + OFF_W + stage * STAGE_BYTES + wg * (W2_SLAB_BYTES / 2), 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < SLAB / 16; ++kk) wgmma_n128(o, da + 2 * kk, db + 2 * kk, s | kk);
    wg_commit();
    wg_wait<1>();
    if (s > 0) mbar_arrive(bar_empty + 8 * prev);
    prev = stage;
    advance();
  }
  wg_wait<0>();
  fence_regs(o);
  mbar_arrive(bar_empty + 8 * prev);

  // out = x + (o + b2), in f32, rows past the end not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + rl + 8 * r;
    if (row < R) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = wg * (D / 2) + 8 * j + c;
        const uint32_t xv = *reinterpret_cast<const uint32_t*>(x + static_cast<size_t>(row) * D + col);
        const float o0 = __uint_as_float(xv << 16) + (o[4 * j + 2 * r] + sb2[col]);
        const float o1 = __uint_as_float(xv & 0xffff0000u) + (o[4 * j + 2 * r + 1] + sb2[col + 1]);
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * D + col) = pack_bf16(o0, o1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The float32 form (dim_ffn_f32), both modes: the same function with every
// product in split TF32 on the tensor cores (lo.hi + hi.lo + hi.hi, hi =
// rna_tf32(x), lo = rna_tf32(x - hi)) and the activation kept in f32 into
// the second product. The weights come split once per model (hi then lo,
// (2, 512, 512) and (2, 256, 512)). An f32 [x | msg] tile of 64 rows in hi
// and lo (256 KB) does not fit a block, so the design streams it:
//
// - The producer streams 32-wide k-chunks (one 128-byte swizzle row of f32)
//   of [x | msg] (8 KB, unsplit) through a ring of two slots, and W1's chunks
//   (512 rows, hi, then lo: 64 KB each) through a ring of three stages; then
//   W2's chunks (256 rows, hi, then lo: 32 KB) through a ring of two, in the
//   W1 ring's third stage once its last W1 chunk is released.
// - The consumers read the A fragments of each 8-deep step from the chunk
//   (conflict-free in the swizzle), split them in registers and run
//   wgmma m64n256k8 with A in registers (A lo.W1 hi and A hi.W1 hi on the hi
//   stage, A hi.W1 lo on the lo stage), h in 128 f32 registers a thread,
//   three steps in flight (four fragment sets). The products stay in flight
//   across stages: a stage is released once the next one's second step has
//   been issued and everything before it is done, so the tensor cores do not
//   drain at each 32-deep stage, and the ring keeps two stages loading.
// - LayerNorm and the GELU (or the relu) as in the bf16 form; the f32
//   activation (64 x 512, 128 KB) is written over the W1 ring's first two
//   stages in the same swizzled chunks, and the second product reads its A
//   fragments from it (m64n128k8, A in registers, each warpgroup 128 output
//   columns).
// - The epilogue adds b2 and the f32 residual x in f32 and writes with
//   streaming stores, which leave L2 to the weights. (Loading the residuals
//   into registers before the second product made the relu form spill.)
//
// What bounds it: three TF32 products of 64 x 512 x 512 and 64 x 512 x 256
// a block, 40 us of the tensor cores at 495 TFLOP/s, against 3 MB of weight
// halves read from L2. Leaving the weights' L2 reads out (all but the ring's
// first round: probe_proj_f32.py's `w_once`) did not change the time of the
// earlier design, which drained the tensor pipe at every stage; so the
// weights stream to each block from L2 and no cluster shares them.
namespace ffn32 {

constexpr int D = 256, D2 = 512, BM = 64;
constexpr int KC = 32;                       // k per chunk: one 128-byte swizzle row of f32
constexpr int NCH = D2 / KC;                 // 16 chunks of each product
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int A_BYTES = BM * KC * 4;         // 8 KB: a chunk of [x | msg], or of the activation
constexpr int W1_BYTES = D2 * KC * 4;        // 64 KB: a chunk of W1 (hi or lo)
constexpr int W2_BYTES = D * KC * 4;         // 32 KB: a chunk of W2 (hi or lo)
constexpr int W1_STAGES = 3;

// shared memory from a 1024-byte aligned base
constexpr int OFF_W1 = 0;                    // the W1 ring; then the activation (128 KB)
constexpr int OFF_W2 = OFF_W1 + 2 * W1_BYTES;  // the W2 ring, in the W1 ring's third stage
constexpr int OFF_A = OFF_W1 + W1_STAGES * W1_BYTES;
constexpr int OFF_B1 = OFF_A + 2 * A_BYTES;  // f32 [512]
constexpr int OFF_G = OFF_B1 + D2 * 4;         // f32 [512]
constexpr int OFF_BETA = OFF_G + D2 * 4;       // f32 [512]
constexpr int OFF_B2 = OFF_BETA + D2 * 4;      // f32 [256]
constexpr int OFF_RED = OFF_B2 + D * 4;        // f32 [2 stats][2 wg][64 rows]
constexpr int OFF_BAR = OFF_RED + 2 * 2 * BM * 4;  // u64 full / empty of the three rings
constexpr int SMEM_BYTES = OFF_BAR + 8 * (4 + 2 * W1_STAGES + 4) + 1024;

// byte offset of element (row, k) of a 64-row chunk of 32 f32 columns in the
// 128-byte swizzle: 16-byte units XOR-ed with the row's low 3 bits
__device__ __forceinline__ int swz(int row, int k) {
  return row * 128 + ((((k >> 2) ^ row) & 7) << 4) + (k & 3) * 4;
}

// the split A fragment of the 8-deep step at column k0 of a chunk at `chunk`
// (generic pointer): rows r and r + 8, columns k0 + q and k0 + q + 4
__device__ __forceinline__ void a_frag(const uint8_t* chunk, int r, int k0, int q,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float x[4] = {*reinterpret_cast<const float*>(chunk + swz(r, k0 + q)),
                      *reinterpret_cast<const float*>(chunk + swz(r + 8, k0 + q)),
                      *reinterpret_cast<const float*>(chunk + swz(r, k0 + q + 4)),
                      *reinterpret_cast<const float*>(chunk + swz(r + 8, k0 + q + 4))};
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// a ring's position: stage and phase parity
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// One product's k-chunks on a weight ring: `acc` (+)= A W^T, where chunk t / 2
// of A is at `a_chunk(t / 2)` and stage t holds W's chunk t / 2, hi (t even)
// or lo; the hi stage runs A lo.W hi and A hi.W hi, the lo stage A hi.W lo,
// all m64nNk8 with A in registers, each step a commit group. Three groups
// stay in flight: a step's fragments are split while the two before it run
// (four fragment sets, one per step of a stage). A stage is released
// (`release(stage)`) once the second step of the next stage has been
// committed and every group of the stage is done; the last one after the
// final wait. `acc` is overwritten by the first product.
template <int N, typename AChunk, typename Release>
__device__ __forceinline__ void product(float (&acc)[N / 2], uint32_t full, uint32_t w_base,
                                        int w_bytes, int w_stages, int w_off, Ring& ring,
                                        AChunk a_chunk, Release release, int rl, int q) {
  uint32_t fh[4][4], fl[4][4];
  int prev = -1;
#pragma unroll 1
  for (int t = 0; t < 2 * NCH; ++t) {
    const int ch = t / 2, part = t % 2;
    const uint8_t* ac = a_chunk(ch);
    mbar_wait(full + 8 * ring.stage, ring.phase);
    const uint64_t db = sw128_desc(w_base + ring.stage * w_bytes + w_off, 1);
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      a_frag(ac, rl, 8 * kk, q, fh[kk], fl[kk]);
      wg_fence();
      if constexpr (N == 256) {
        if (part == 0) {
          wgmma_tf32_n256_rs(acc, fl[kk], db + 2 * kk, ch | kk);
          wgmma_tf32_n256_rs(acc, fh[kk], db + 2 * kk, 1);
        } else {
          wgmma_tf32_n256_rs(acc, fh[kk], db + 2 * kk, 1);
        }
      } else {
        if (part == 0) {
          wgmma_tf32_n128_rs(acc, fl[kk], db + 2 * kk, ch | kk);
          wgmma_tf32_n128_rs(acc, fh[kk], db + 2 * kk, 1);
        } else {
          wgmma_tf32_n128_rs(acc, fh[kk], db + 2 * kk, 1);
        }
      }
      wg_commit();
      wg_wait<2>();
      fence_regs(fh[(kk + 1) & 3]);
      fence_regs(fl[(kk + 1) & 3]);
      if (kk == 1 && prev >= 0) release(prev);
    }
    prev = ring.stage;
    ring.advance(w_stages);
  }
  wg_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < KC / 8; ++kk) {
    fence_regs(fh[kk]);
    fence_regs(fl[kk]);
  }
  release(prev);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
ffn_f32_sm90(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap mmap,
             const __grid_constant__ CUtensorMap w1map, const __grid_constant__ CUtensorMap w2map,
             const float* __restrict__ x, const float* __restrict__ b1,
             const float* __restrict__ gam, const float* __restrict__ beta,
             const float* __restrict__ b2, float* __restrict__ out, int R) {
  extern __shared__ __align__(1024) uint8_t dyn_smem[];
  const int tid = threadIdx.x;
  uint32_t base = smem_u32(dyn_smem);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  uint8_t* sm = dyn_smem + pad;
  base += pad;
  // full[2], empty[2] of the A ring; full[3], empty[3] of the W1 ring;
  // full[2], empty[2] of the W2 ring
  const uint32_t a_full = base + OFF_BAR, a_empty = a_full + 16;
  const uint32_t w_full = a_empty + 16, w_empty = w_full + 8 * W1_STAGES;
  const uint32_t v_full = w_empty + 8 * W1_STAGES, v_empty = v_full + 16;
  const int row0 = blockIdx.x * BM;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, CONSUMERS);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, CONSUMERS);
    }
    for (int s = 0; s < W1_STAGES; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------- producer warpgroup: one thread issues ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMERS) {
      Ring a, w;
      for (int c = 0; c < NCH; ++c) {
        mbar_wait(a_empty + 8 * a.stage, a.phase ^ 1);
        mbar_arrive_tx(a_full + 8 * a.stage, A_BYTES);
        tma_load_2d(base + OFF_A + a.stage * A_BYTES, c < NCH / 2 ? &xmap : &mmap,
                    a_full + 8 * a.stage, (c % (NCH / 2)) * KC, row0);
        a.advance(2);
        for (int part = 0; part < 2; ++part) {  // W1 hi, then lo (rows 512 on)
          mbar_wait(w_empty + 8 * w.stage, w.phase ^ 1);
          const uint32_t full = w_full + 8 * w.stage, dst = base + OFF_W1 + w.stage * W1_BYTES;
          mbar_arrive_tx(full, W1_BYTES);
          tma_load_2d(dst, &w1map, full, c * KC, part * D2);
          tma_load_2d(dst + W1_BYTES / 2, &w1map, full, c * KC, part * D2 + D);
          w.advance(W1_STAGES);
        }
      }
      // W2 goes into the W1 ring's third stage (the ring stands there after
      // its 32 chunks) once the consumers release its last W1 chunk, the 30th
      static_assert((2 * NCH) % W1_STAGES == 2, "the W2 ring lies in the W1 ring's third stage");
      mbar_wait(w_empty + 8 * w.stage, w.phase ^ 1);
      Ring v;
      for (int t = 0; t < 2 * NCH; ++t) {  // W2 chunk t / 2, hi then lo (rows 256 on)
        mbar_wait(v_empty + 8 * v.stage, v.phase ^ 1);
        mbar_arrive_tx(v_full + 8 * v.stage, W2_BYTES);
        tma_load_2d(base + OFF_W2 + v.stage * W2_BYTES, &w2map, v_full + 8 * v.stage,
                    (t / 2) * KC, (t % 2) * D);
        v.advance(2);
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int c = (lane % 4) * 2, q = lane % 4;
  const int rl = warp * 16 + lane / 4;  // this thread's rows rl, rl + 8 of the tile
  float* sb1 = reinterpret_cast<float*>(sm + OFF_B1);
  float* sg = reinterpret_cast<float*>(sm + OFF_G);
  float* sbeta = reinterpret_cast<float*>(sm + OFF_BETA);
  float* sb2 = reinterpret_cast<float*>(sm + OFF_B2);
  float* red = reinterpret_cast<float*>(sm + OFF_RED);
  for (int i = tid; i < D2; i += CONSUMERS) {
    sb1[i] = b1[i];
    if (MODE == 0) {
      sg[i] = gam[i];
      sbeta[i] = beta[i];
    }
    if (i < D) sb2[i] = b2[i];
  }
  consumers_sync();

  // h = [x | msg] W1^T for columns [256 wg, 256 wg + 256); each A chunk is
  // read by the hi and the lo stage, and released when the next one is taken
  float h[128];
  {
    Ring a, w;
    int held = 0;
    product<256>(
        h, w_full, base + OFF_W1, W1_BYTES, W1_STAGES, wg * (W1_BYTES / 2), w,
        [&](int ch) {
          if (ch != held) {  // chunk ch - 1 is read through
            mbar_arrive(a_empty + 8 * a.stage);
            a.advance(2);
            held = ch;
          }
          mbar_wait(a_full + 8 * a.stage, a.phase);
          return static_cast<const uint8_t*>(sm + OFF_A + a.stage * A_BYTES);
        },
        [&](int stage) { mbar_arrive(w_empty + 8 * stage); }, rl, q);
  }

  // + b1, then the activation
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = wg * D + 8 * j + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) h[4 * j + e] += sb1[col + (e & 1)];
  }
  float mu[2] = {0.f, 0.f}, rstd[2] = {1.f, 1.f};
  if (MODE == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) sum += h[4 * j + 2 * r] + h[4 * j + 2 * r + 1];
      sum = quad_sum(sum);
      if (c == 0) red[wg * BM + rl + 8 * r] = sum;
    }
    consumers_sync();
#pragma unroll
    for (int r = 0; r < 2; ++r) mu[r] = (red[rl + 8 * r] + red[BM + rl + 8 * r]) / D2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float var = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float d0 = h[4 * j + 2 * r] - mu[r], d1 = h[4 * j + 2 * r + 1] - mu[r];
        var += d0 * d0 + d1 * d1;
      }
      var = quad_sum(var);
      if (c == 0) red[2 * BM + wg * BM + rl + 8 * r] = var;
    }
  }
  consumers_sync();  // also: both warpgroups are done with the W1 ring
  if (MODE == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rstd[r] = rsqrtf((red[2 * BM + rl + 8 * r] + red[3 * BM + rl + 8 * r]) / D2 + 1e-5f);
  }

  // the activation, column by column pair, written in f32 over the W1 ring:
  // column k in chunk k / 32; 8 columns a step, so that the compiler does
  // not hold every g and beta at once
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = wg * D + 8 * j + c;
    uint8_t* chunk = sm + OFF_W1 + (col / KC) * A_BYTES;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float hv = h[4 * j + 2 * r + e];
        if (MODE == 0) {
          const float hn = (hv - mu[r]) * rstd[r] * sg[col + e] + sbeta[col + e];
          v[e] = 0.5f * hn * (1.f + erff(hn * 0.7071067811865476f));
        } else {
          v[e] = fmaxf(hv, 0.f);
        }
      }
      *reinterpret_cast<float2*>(chunk + swz(rl + 8 * r, col % KC)) = make_float2(v[0], v[1]);
    }
    asm volatile("" ::: "memory");
  }
  consumers_sync();

  // the residuals of this thread's first row, loaded while the second product
  // runs (both rows' would take 64 registers, and the relu form spilled)
  float2 xres[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    xres[j] = row0 + rl < R ? *reinterpret_cast<const float2*>(
                                  x + static_cast<size_t>(row0 + rl) * D + wg * (D / 2) + 8 * j + c)
                            : make_float2(0.f, 0.f);

  // out = act W2^T for columns [128 wg, 128 wg + 128)
  float o[64];
  {
    Ring v;
    product<128>(
        o, v_full, base + OFF_W2, W2_BYTES, 2, wg * (W2_BYTES / 2), v,
        [&](int ch) { return static_cast<const uint8_t*>(sm + OFF_W1 + ch * A_BYTES); },
        [&](int stage) { mbar_arrive(v_empty + 8 * stage); }, rl, q);
  }

  // out = x + (o + b2), rows past the end not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + rl + 8 * r;
    if (row < R) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = wg * (D / 2) + 8 * j + c;
        const float2 xv = *reinterpret_cast<const float2*>(x + static_cast<size_t>(row) * D + col);
        __stcs(reinterpret_cast<float2*>(out + static_cast<size_t>(row) * D + col),
               make_float2(xv.x + (o[4 * j + 2 * r] + sb2[col]),
                           xv.y + (o[4 * j + 2 * r + 1] + sb2[col + 1])));
      }
    }
  }
}

// a 2-D f32 tensor map (inner, outer) with (32, box_outer) boxes in the
// 128-byte swizzle; rows past the end read as zeros. 0 on success.
int make_map(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
             uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer};
  const uint32_t box[2] = {static_cast<uint32_t>(KC), box_outer};
  return encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, 2, dims, box);
}

}  // namespace ffn32

// a 2-D bf16 tensor map (inner, outer) with (64, box_outer) boxes in the
// 128-byte swizzle; rows past the end read as zeros. 0 on success.
int make_map(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
             uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer};
  const uint32_t box[2] = {static_cast<uint32_t>(SLAB), box_outer};
  return encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, 2, dims, box);
}

}  // namespace

// x, msg, out (R, 256) bf16, x and msg 16-byte aligned; w1 (512, 512) and w2
// (256, 512) bf16 in nn.Linear (out, in) layout, 16-byte aligned; b1, g,
// beta (512,), b2 (256,) bf16. mode 0 is "ln_gelu", mode 1 "relu" (g and
// beta are not read and may be null).
extern "C" int dim_ffn_bf16(int device, const void* x, const void* msg,
                            const void* w1, const void* b1, const void* g,
                            const void* beta, const void* w2, const void* b2,
                            void* out, int R, int mode, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  CUtensorMap xm, mm, w1m, w2m;
  int rc = make_map(&xm, x, D, R, BM);
  if (rc == 0) rc = make_map(&mm, msg, D, R, BM);
  if (rc == 0) rc = make_map(&w1m, w1, D2, D2, D);
  if (rc == 0) rc = make_map(&w2m, w2, D2, D, D);
  if (rc != 0) return rc;
  auto kernel = mode == 0 ? ffn_sm90<0> : ffn_sm90<1>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(R + BM - 1) / BM, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xm, mm, w1m, w2m, static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(b1),
      static_cast<const uint16_t*>(g), static_cast<const uint16_t*>(beta),
      static_cast<const uint16_t*>(b2), static_cast<uint16_t*>(out), R);
  return static_cast<int>(cudaGetLastError());
}

// The float32 form: x, msg, out (R, 256) f32, x and msg 16-byte aligned; w1
// (2, 512, 512) and w2 (2, 256, 512) f32, the TF32 hi and lo halves of the
// nn.Linear (out, in) weights (ops/ffn.py::ffn_weights_tf32), 16-byte
// aligned; b1, g, beta (512,), b2 (256,) f32. Modes as for dim_ffn_bf16.
extern "C" int dim_ffn_f32(int device, const void* x, const void* msg, const void* w1,
                           const void* b1, const void* g, const void* beta, const void* w2,
                           const void* b2, void* out, int R, int mode, void* stream) {
  namespace f = ffn32;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  CUtensorMap xm, mm, w1m, w2m;
  int rc = f::make_map(&xm, x, f::D, R, f::BM);
  if (rc == 0) rc = f::make_map(&mm, msg, f::D, R, f::BM);
  if (rc == 0) rc = f::make_map(&w1m, w1, f::D2, 2 * f::D2, f::D);
  if (rc == 0) rc = f::make_map(&w2m, w2, f::D2, 2 * f::D, f::D);
  if (rc != 0) return rc;
  auto kernel = mode == 0 ? f::ffn_f32_sm90<0> : f::ffn_f32_sm90<1>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(R + f::BM - 1) / f::BM, f::THREADS, f::SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      xm, mm, w1m, w2m, static_cast<const float*>(x), static_cast<const float*>(b1),
      static_cast<const float*>(g), static_cast<const float*>(beta),
      static_cast<const float*>(b2), static_cast<float*>(out), R);
  return static_cast<int>(cudaGetLastError());
}
