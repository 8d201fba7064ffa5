// LightGlue's attention prologue in one pass over row tiles: the input
// projection y = x . W^T + b, its split into S sections of width D = 256
// (q, k, v for the self block; qk, v for the cross block), the head unpack,
// and the rotary embedding on the sections that take it:
//   t = bf16(y),  out = t * bf16(cos) + bf16(rotate_half(y)) * bf16(sin)
// with rotate_half(y)[2i] = -y[2i+1], rotate_half(y)[2i+1] = y[2i], and
// cos, sin per head (hd = 64), shared by the 4 heads.
//
// Replaces the TPU kernel deep_image_matching_tpu/ops/pallas_qkv.py::
// proj_rotary_fused (_proj_rot_kernel), reached through qkv_rotary_fused
// (3 sections, rotary on q and k) and qk_v_fused (2 sections, no rotary).
//
// What bounds it on the H100: at (65536 rows, 256) in 3-section mode it moves
// 151 MB (x 34 MB, cos and sin 17 MB in bf16, the three outputs 101 MB)
// against 26 GFLOP of bf16 products, so it is bound by memory; the weight
// (384 KB) is reread from L2 by every row tile. The design follows the FFN
// (ffn.cu):
//
// - One block takes 128 rows. A producer warp loads the x tile once by TMA
//   as four 64-wide k-slabs in the 128-byte swizzle (the K-major A operand),
//   then streams the weight through a ring of six 16 KB stages: a 64-wide
//   k-slab of 128 output rows (half a section), in nn.Linear (out, in) layout
//   (the K-major B operand), half-section after half-section. Rows past the
//   end read as zeros. 128-row tiles halve the weight's L2 traffic of 64-row
//   tiles (200 MB a self call at 65536 rows).
// - The tile's cos and sin rows come by TMA too, in bf16 (the rotary rounds
//   them to bf16 anyway, so the caller passes them rounded, once per
//   forward), 128 bytes a row in the same swizzle; the consumers wait for
//   them only before the first rotary epilogue.
// - Two consumer warpgroups hold 64 rows each: a half-section's 64 x 128
//   tile is wgmma m64n128k16 into 64 f32 registers a thread, which leaves
//   the epilogue room (a 64 x 256 tile in 128 registers made ptxas spill).
//   In the accumulator layout each thread holds adjacent column pairs
//   (2i, 2i+1), so rotate_half is a register swap with a negation. The bf16
//   tile is staged in shared memory (16-byte chunks XOR-swizzled by row) and
//   written with 16-byte stores into the (B, H, N, 64) head layout the
//   attention kernels take; rows map to (b, n) one by one, so a tile may
//   straddle two images. While a warpgroup stores, the producer already
//   streams the next half-section's slabs.
//
// Numerics follow the Pallas kernel: f32 accumulation, the bias added in f32
// before rounding, the rotary multiply-add in bf16 arithmetic (each product
// rounded to bf16, then their sum).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int D = 256;            // model width (one section)
constexpr int HD = 64;            // head dim
constexpr int HALF = 128;         // output columns per pass: two heads
constexpr int BM = 128;           // rows per block, 64 per consumer warpgroup
constexpr int SLAB = 64;          // k per slab: one 128-byte swizzle row of bf16
constexpr int NSLAB = D / SLAB;   // 4 k-slabs per pass
constexpr int CONSUMERS = 256;    // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int X_SLAB_BYTES = BM * SLAB * 2;     // 16 KB
constexpr int W_SLAB_BYTES = HALF * SLAB * 2;   // 16 KB: 128 output rows
constexpr int STAGES = 6;
constexpr int O_BYTES = 64 * HALF * 2;          // 16 KB: a warpgroup's staged tile
constexpr int CS_BYTES = BM * HD * 2;           // 16 KB: cos (or sin) rows in bf16

// shared memory from a 1024-byte aligned base
constexpr int OFF_X = 0;
constexpr int OFF_W = OFF_X + NSLAB * X_SLAB_BYTES;
constexpr int OFF_O = OFF_W + STAGES * W_SLAB_BYTES;
constexpr int OFF_COS = OFF_O + 2 * O_BYTES;
constexpr int OFF_SIN = OFF_COS + CS_BYTES;
constexpr int OFF_BAR = OFF_SIN + CS_BYTES;  // u64: x, cs, full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = OFF_BAR + 8 * (2 + 2 * STAGES) + 1024;  // + alignment slack

__device__ __forceinline__ float round_bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// byte offset of element (row, d) in a [rows][64] bf16 tile as TMA writes it
// in the 128-byte swizzle: 16-byte chunks XOR-ed with the row's low 3 bits
__device__ __forceinline__ int cs_off(int row, int d) {
  return row * (HD * 2) + ((((d >> 3) ^ row) & 7) << 4) + (d & 7) * 2;
}

// byte offset of 16-byte chunk ch of row `row` in a staged [64][128] bf16
// tile, XOR-swizzled within each 8-chunk head so a warp's stores of 8 rows
// hit distinct banks
__device__ __forceinline__ int o_off(int row, int ch) {
  return row * (HALF * 2) + ((((ch ^ row) & 7) | (ch & 8)) << 4);
}

// The accumulator layout of m64n128k16 (f32): acc[4 j + e] is row
// 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + (e % 2).
__global__ void __launch_bounds__(THREADS, 1)
qkv_sm90(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
         const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap smap,
         const uint16_t* __restrict__ bias, uint16_t* __restrict__ out0,
         uint16_t* __restrict__ out1, uint16_t* __restrict__ out2, int R, int N,
         int sections, int rot_mask) {
  extern __shared__ __align__(1024) uint8_t dyn_smem[];
  const int tid = threadIdx.x;
  uint32_t base = smem_u32(dyn_smem);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  uint8_t* sm = dyn_smem + pad;
  base += pad;
  const uint32_t bar_x = base + OFF_BAR;
  const uint32_t bar_cs = bar_x + 8;
  const uint32_t bar_full = bar_cs + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // + 8 * stage
  const int row0 = blockIdx.x * BM;

  if (tid == 0) {
    mbar_init(bar_x, 1);
    mbar_init(bar_cs, 1);
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
      mbar_arrive_tx(bar_x, NSLAB * X_SLAB_BYTES);
      for (int s = 0; s < NSLAB; ++s)
        tma_load_2d(base + OFF_X + s * X_SLAB_BYTES, &xmap, bar_x, s * SLAB, row0);
      if (rot_mask) {
        mbar_arrive_tx(bar_cs, 2 * CS_BYTES);
        tma_load_2d(base + OFF_COS, &cmap, bar_cs, 0, row0);
        tma_load_2d(base + OFF_SIN, &smap, bar_cs, 0, row0);
      }
      int stage = 0;
      uint32_t phase = 0;
      // slab t: k-slab t % 4 of the 128 output rows starting at (t / 4) * 128
      for (int t = 0; t < sections * (D / HALF) * NSLAB; ++t) {
        mbar_wait(bar_empty + 8 * stage, phase ^ 1);
        const uint32_t full = bar_full + 8 * stage;
        mbar_arrive_tx(full, W_SLAB_BYTES);
        tma_load_2d(base + OFF_W + stage * W_SLAB_BYTES, &wmap, full, (t % NSLAB) * SLAB,
                    (t / NSLAB) * HALF);
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
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int c = (lane % 4) * 2;
  const int rl = warp * 16 + lane / 4;  // this thread's rows rl, rl + 8 of the 64
  uint8_t* ost = sm + OFF_O + wg * O_BYTES;

  int stage = 0;
  uint32_t phase = 0;
  bool cs_ready = false;
  mbar_wait(bar_x, 0);
#pragma unroll 1
  for (int pass = 0; pass < sections * (D / HALF); ++pass) {
    const int sec = pass / (D / HALF), col0 = (pass % (D / HALF)) * HALF;
    // y = x W^T for the pass's 128 columns: 4 slabs of 4 k-steps; a slab's
    // stage is released once the next slab is issued and it is done
    float acc[64];
    int prev = -1;
#pragma unroll 1
    for (int s = 0; s < NSLAB; ++s) {
      mbar_wait(bar_full + 8 * stage, phase);
      const uint64_t da = sw128_desc(base + OFF_X + s * X_SLAB_BYTES + wg * (X_SLAB_BYTES / 2), 1);
      const uint64_t db = sw128_desc(base + OFF_W + stage * W_SLAB_BYTES, 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < SLAB / 16; ++kk) wgmma_n128(acc, da + 2 * kk, db + 2 * kk, s | kk);
      wg_commit();
      wg_wait<1>();
      if (prev >= 0) mbar_arrive(bar_empty + 8 * prev);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * prev);

    // the previous pass's tile is stored before this one is staged
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    const bool rot = (rot_mask >> sec) & 1;
    if (rot && !cs_ready) {
      mbar_wait(bar_cs, 0);
      cs_ready = true;
    }
    const uint16_t* bp = bias + sec * D + col0;
    // by the column within the head: its cos and sin serve both heads
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      uint32_t cv[2] = {0u, 0u}, sv[2] = {0u, 0u};
      if (rot) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = cs_off(wg * 64 + rl + 8 * r, 8 * jj + c);
          cv[r] = *reinterpret_cast<const uint32_t*>(sm + OFF_COS + off);
          sv[r] = *reinterpret_cast<const uint32_t*>(sm + OFF_SIN + off);
        }
      }
#pragma unroll
      for (int h = 0; h < HALF / HD; ++h) {
        const int j = 8 * h + jj;  // columns (8 j + c, 8 j + c + 1) of the pass
        const uint32_t bv = __ldg(reinterpret_cast<const unsigned int*>(bp + 8 * j + c));
        const float b0 = lo_f(bv), b1 = hi_f(bv);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rl + 8 * r;
          const float y0 = acc[4 * j + 2 * r] + b0;
          const float y1 = acc[4 * j + 2 * r + 1] + b1;
          float o0 = y0, o1 = y1;
          if (rot) {
            // bf16 arithmetic: each product rounded, then the sum (rounded
            // when packed)
            const float t0 = round_bf(y0), t1 = round_bf(y1);
            o0 = round_bf(t0 * lo_f(cv[r])) + round_bf(-t1 * lo_f(sv[r]));
            o1 = round_bf(t1 * hi_f(cv[r])) + round_bf(t0 * hi_f(sv[r]));
          }
          *reinterpret_cast<uint32_t*>(ost + o_off(row, j) + c * 2) = pack_f32(o0, o1);
        }
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    // (row, head) runs of 64 bf16 (128 bytes) into the (B, H, N, 64) layout:
    // this thread's 16-byte chunk ch of rows wt / 16 + 8 u
    uint16_t* o = sec == 0 ? out0 : sec == 1 ? out1 : out2;
    const int ch = wt % (HALF / 8);
    const size_t chunk_off =
        static_cast<size_t>(col0 / HD + ch / (HD / 8)) * N * HD + (ch % (HD / 8)) * 8;
#pragma unroll 4
    for (int row = wt / (HALF / 8); row < 64; row += 128 / (HALF / 8)) {
      const int grow = row0 + wg * 64 + row;
      if (grow < R) {
        const int bb = grow / N, n = grow % N;
        const size_t dst =
            static_cast<size_t>(bb) * (D / HD) * N * HD + static_cast<size_t>(n) * HD + chunk_off;
        *reinterpret_cast<uint4*>(o + dst) = *reinterpret_cast<const uint4*>(ost + o_off(row, ch));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The float32 form (dim_qkv_rotary_f32): the projection in split TF32 on the
// tensor cores (lo.hi + hi.lo + hi.hi, hi = rna_tf32(x), lo = rna_tf32(x -
// hi)), the bias and the rotary in f32 with f32 cos and sin. The weight comes
// split once per model (hi then lo, (2, S 256, 256)).
//
// What bounds it: at (65536 rows, 256) in 3-section mode, three TF32
// products (0.156 ms of the tensor cores) against 302 MB of f32 in and out
// (0.090 ms). In the first design the epilogue took 37 % of the time
// (probe_proj_f32.py's `no_epilogue`): cos / sin loaded from global memory
// and 464 bytes of spills a thread, with the tensor cores idle; the drain at
// every stage cost nothing measurable (`no_drain`). The design:
//
// - One block takes 128 rows. The producer streams stages of three boxes: a
//   32-wide k-chunk of the x tile (16 KB, unsplit), and the same chunk of the
//   pass's 128 weight rows, hi and lo (16 KB each), through a ring of three
//   48 KB stages; the x tile is read again from L2 for each pass, which
//   leaves room for the tile's cos and sin rows (64 KB in f32), loaded once
//   by TMA as two 32-column boxes each, and for the bias (3 KB).
// - Two consumer warpgroups, 64 rows each, read the A fragments of each
//   8-deep step from the stage's x chunk and split them in registers once for
//   the three products: x lo.W hi and x hi.W hi step by step, then x hi.W lo
//   for the chunk's four steps (the order of the earlier design, so the sums
//   are the same bit for bit), wgmma m64n128k8 with A in registers into 64
//   f32 registers a thread, one pass per 128 output columns. The hi
//   fragments of two chunks alternate between two register sets; the
//   products stay in flight across stages, and a stage is released once the
//   next stage's first step has been committed and everything before it is
//   done.
// - The epilogue adds the bias, applies the rotary (each product and the sum
//   rounded once, as the plain version's f32 arithmetic) with cos and sin
//   from shared memory, and stores each thread's column pairs into the (B, H,
//   N, 64) f32 outputs: 8-byte streaming stores (evict-first, so the outputs
//   do not push the weights and the x tiles out of L2) that fill whole
//   32-byte sectors. It runs under the next pass's products: the
//   accumulators of two passes alternate, and a pass's tile goes out one
//   8-column slice a chunk of the next pass, behind the chunk's first step.
namespace qkv32 {

constexpr int D = 256, HD = 64, HALF = 128, BM = 128;
constexpr int KC = 32;                 // k per chunk: one 128-byte swizzle row of f32
constexpr int NCH = D / KC;            // 8 chunks per pass
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int X_BYTES = BM * KC * 4;   // 16 KB: a chunk of the x tile
constexpr int W_BYTES = HALF * KC * 4; // 16 KB: a chunk of 128 weight rows (hi or lo)
constexpr int STAGE_BYTES = X_BYTES + 2 * W_BYTES;
constexpr int STAGES = 3;
constexpr int CS_BYTES = BM * 32 * 4;  // 16 KB: 32 columns of cos (or sin) of the tile's rows

// shared memory from a 1024-byte aligned base
constexpr int OFF_RING = 0;
constexpr int OFF_CS = OFF_RING + STAGES * STAGE_BYTES;  // cos d 0-31, 32-63; sin the same
constexpr int OFF_BIAS = OFF_CS + 4 * CS_BYTES;          // f32 [S 256]
constexpr int OFF_BAR = OFF_BIAS + 3 * D * 4;            // u64: cs, full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;

// byte offset of element (row, k) of a chunk of 32 f32 columns in the
// 128-byte swizzle
__device__ __forceinline__ int swz(int row, int k) {
  return row * 128 + ((((k >> 2) ^ row) & 7) << 4) + (k & 3) * 4;
}

// the ring's position and the stage the consumers hold back
struct Pipe {
  int stage = 0, held = -1;
  uint32_t phase = 0;
};

// where one pass's epilogue writes: the section's output at the pass's first
// head, the pass's bias in shared memory, and whether it takes the rotary
struct Epi {
  float* o;
  const float* bias;
  bool rot;
};

// a consumer thread's view of the block: shared memory, the ring's
// barriers, its rows rt and rt + 8 of the tile, its lane's column pair c and
// fragment column q, and its rows' offsets in the (B, H, N, 64) outputs at
// head 0 (-1 past the end; heads `head` apart)
struct Ctx {
  const uint8_t* sm;
  uint32_t base, bar_full, bar_empty;
  int rt, q, c;
  long long head;
  long long rowoff[2];
};

// Chunk ch of a pass from the ring's next stage into `acc`: x lo.W hi and x
// hi.W hi step by step, then x hi.W lo for the chunk's four steps, each x
// fragment read from the stage and split once. The hi fragments stay in `fh`
// until the chunk's lo products are done (the caller alternates two sets by
// chunk: a set is rewritten two chunks on, after the first wait of the chunk
// between has seen its products done); the stage before is released at this
// chunk's first wait, and `then()` runs right after that release, with the
// chunk's first step in flight.
template <typename Then>
__device__ __forceinline__ void chunk_products(float (&acc)[64], uint32_t (&fh)[4][4],
                                               uint32_t (&fl)[2][4], int ch, Pipe& p,
                                               const Ctx& cx, Then then) {
  const int rt = cx.rt, q = cx.q;
  mbar_wait(cx.bar_full + 8 * p.stage, p.phase);
  const uint8_t* xc = cx.sm + OFF_RING + p.stage * STAGE_BYTES;
  const uint64_t dh = sw128_desc(cx.base + OFF_RING + p.stage * STAGE_BYTES + X_BYTES, 1);
  const uint64_t dl = dh + (W_BYTES >> 4);
#pragma unroll
  for (int kk = 0; kk < KC / 8; ++kk) {
    const int k0 = 8 * kk + q;
    const float xv[4] = {*reinterpret_cast<const float*>(xc + swz(rt, k0)),
                         *reinterpret_cast<const float*>(xc + swz(rt + 8, k0)),
                         *reinterpret_cast<const float*>(xc + swz(rt, k0 + 4)),
                         *reinterpret_cast<const float*>(xc + swz(rt + 8, k0 + 4))};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(xv[i], fh[kk][i], fl[kk & 1][i]);
    wg_fence();
    wgmma_tf32_n128_rs(acc, fl[kk & 1], dh + 2 * kk, ch | kk);
    wgmma_tf32_n128_rs(acc, fh[kk], dh + 2 * kk, 1);
    wg_commit();
    wg_wait<1>();
    fence_regs(fl[(kk + 1) & 1]);
    // the stage before is done: its x read, its products complete
    if (kk == 0) {
      if (p.held >= 0) mbar_arrive(cx.bar_empty + 8 * p.held);
      then();
    }
  }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KC / 8; ++kk) wgmma_tf32_n128_rs(acc, fh[kk], dl + 2 * kk, 1);
  wg_commit();
  p.held = p.stage;
  if (++p.stage == STAGES) {
    p.stage = 0;
    p.phase ^= 1;
  }
}

// Columns (d, d + 1), d = 8 jj + c, of both heads of a pass's 64 x 128 tile
// in `a`, for this thread's rows: + bias, the rotary (each product and the
// sum rounded once, as the plain version's f32 arithmetic) with cos and sin
// from shared memory, stored into the (B, H, N, 64) layout.
__device__ __forceinline__ void store_slice(const float (&a)[64], int jj, const Epi& ep,
                                            const Ctx& cx) {
  const int d = 8 * jj + cx.c;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (cx.rowoff[r] < 0) continue;
    float2 cs = make_float2(1.f, 1.f), sn = make_float2(0.f, 0.f);
    if (ep.rot) {
      const int off = (d / 32) * CS_BYTES + swz(cx.rt + 8 * r, d % 32);
      cs = *reinterpret_cast<const float2*>(cx.sm + OFF_CS + off);
      sn = *reinterpret_cast<const float2*>(cx.sm + OFF_CS + 2 * CS_BYTES + off);
    }
#pragma unroll
    for (int h = 0; h < HALF / HD; ++h) {
      const int j = 8 * h + jj;
      const float2 bv = *reinterpret_cast<const float2*>(ep.bias + HD * h + d);
      const float y0 = a[4 * j + 2 * r] + bv.x;
      const float y1 = a[4 * j + 2 * r + 1] + bv.y;
      float2 v = make_float2(y0, y1);
      if (ep.rot) {
        v.x = __fadd_rn(__fmul_rn(y0, cs.x), __fmul_rn(-y1, sn.x));
        v.y = __fadd_rn(__fmul_rn(y1, cs.y), __fmul_rn(y0, sn.y));
      }
      __stcs(reinterpret_cast<float2*>(ep.o + cx.rowoff[r] + h * cx.head + d), v);
    }
  }
}

// One pass's products into `acc` (a stage a chunk, the accumulator
// overwritten by the first product) while, when `store`, the pass before
// (`done`) is stored a slice a chunk, behind the chunk's first step and after
// the release of the stage before (an arrival orders the thread's earlier
// stores: so a slice's stores have a chunk's time to drain before the next
// release); then the wait for them all and the last stage's release.
__device__ __forceinline__ void run_pass(float (&acc)[64], const float (&done)[64], bool store,
                                         const Epi& ep, Pipe& p, uint32_t (&fa)[4][4],
                                         uint32_t (&fb)[4][4], uint32_t (&fl)[2][4],
                                         const Ctx& cx) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    chunk_products(acc, (ch & 1) ? fb : fa, fl, ch, p, cx, [&] {
      if (store) store_slice(done, ch, ep, cx);
    });
  }
  wg_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < KC / 8; ++kk) {
    fence_regs(fa[kk]);
    fence_regs(fb[kk]);
  }
  mbar_arrive(cx.bar_empty + 8 * p.held);
  p.held = -1;
}

__global__ void __launch_bounds__(THREADS, 1)
qkv_f32_sm90(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
             const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap smap,
             const float* __restrict__ bias, float* __restrict__ out0, float* __restrict__ out1,
             float* __restrict__ out2, int R, int N, int sections, int rot_mask) {
  extern __shared__ __align__(1024) uint8_t dyn_smem[];
  const int tid = threadIdx.x;
  uint32_t base = smem_u32(dyn_smem);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  uint8_t* sm = dyn_smem + pad;
  base += pad;
  const uint32_t bar_cs = base + OFF_BAR;
  const uint32_t bar_full = bar_cs + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // + 8 * stage
  const int row0 = blockIdx.x * BM;
  const int passes = sections * (D / HALF);

  if (tid == 0) {
    mbar_init(bar_cs, 1);
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
      if (rot_mask) {
        mbar_arrive_tx(bar_cs, 4 * CS_BYTES);
        for (int h = 0; h < 2; ++h) {
          tma_load_2d(base + OFF_CS + h * CS_BYTES, &cmap, bar_cs, 32 * h, row0);
          tma_load_2d(base + OFF_CS + (2 + h) * CS_BYTES, &smap, bar_cs, 32 * h, row0);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      // stage t: chunk t % 8 of the x tile and of pass t / 8's 128 weight
      // rows, hi and lo (the rows sections * 256 on)
      for (int t = 0; t < passes * NCH; ++t) {
        mbar_wait(bar_empty + 8 * stage, phase ^ 1);
        const uint32_t full = bar_full + 8 * stage, dst = base + OFF_RING + stage * STAGE_BYTES;
        const int k0 = (t % NCH) * KC, w0 = (t / NCH) * HALF;
        mbar_arrive_tx(full, STAGE_BYTES);
        tma_load_2d(dst, &xmap, full, k0, row0);
        tma_load_2d(dst + X_BYTES, &wmap, full, k0, w0);
        tma_load_2d(dst + X_BYTES + W_BYTES, &wmap, full, k0, sections * D + w0);
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
  const int c = (lane % 4) * 2, q = lane % 4;
  const int rl = warp * 16 + lane / 4;  // this thread's rows rl, rl + 8 of the 64
  const int rt = wg * 64 + rl;          // the same rows of the tile
  float* sbias = reinterpret_cast<float*>(sm + OFF_BIAS);
  for (int i = tid; i < sections * D; i += CONSUMERS) sbias[i] = bias[i];
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");

  Ctx cx{sm, base, bar_full, bar_empty, rt, q, c, static_cast<long long>(N) * HD, {-1, -1}};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int grow = row0 + rt + 8 * r;
    if (grow < R)
      cx.rowoff[r] = (static_cast<long long>(grow / N) * (D / HD) * N + grow % N) * HD;
  }
  auto epi = [&](int pass) {
    const int sec = pass / (D / HALF), col0 = (pass % (D / HALF)) * HALF;
    float* o = sec == 0 ? out0 : sec == 1 ? out1 : out2;
    return Epi{o + (col0 / HD) * cx.head, sbias + sec * D + col0, ((rot_mask >> sec) & 1) != 0};
  };

  // Each pass's products run while the pass before is stored, a slice after
  // each chunk, so the stores spread over the tensor cores' work; the
  // accumulators of two passes alternate.
  Pipe p;
  uint32_t fa[4][4], fb[4][4], fl[2][4];
  float acc_a[64], acc_b[64];
  run_pass(acc_a, acc_b, false, epi(0), p, fa, fb, fl, cx);
  if (rot_mask) mbar_wait(bar_cs, 0);
#pragma unroll 1
  for (int pass = 1;; pass += 2) {
    run_pass(acc_b, acc_a, true, epi(pass - 1), p, fa, fb, fl, cx);
    if (pass + 1 == passes) {
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) store_slice(acc_b, jj, epi(pass), cx);
      break;
    }
    run_pass(acc_a, acc_b, true, epi(pass), p, fa, fb, fl, cx);
    if (pass + 2 == passes) {
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) store_slice(acc_a, jj, epi(pass + 1), cx);
      break;
    }
  }
}

}  // namespace qkv32

}  // namespace

// x (B N, 256) bf16; w (S 256, 256) bf16, rows section-contiguous, nn.Linear
// (out, in) layout; bias (S 256,) bf16; cos, sin (B N, 64) bf16 (may be null
// when rot_mask is 0); x, w, cos and sin 16-byte aligned; out0..out{S-1}
// (B, 4, N, 64) bf16 (unused ones null). sections is 2 or 3; bit s of
// rot_mask applies the rotary to section s.
extern "C" int dim_qkv_rotary_bf16(int device, const void* x, const void* w,
                                   const void* bias, const void* cosv, const void* sinv,
                                   void* out0, void* out1, void* out2, int R, int N,
                                   int sections, int rot_mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sections < 1 || sections > 3 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  CUtensorMap xm, wm, cos_map = {}, sin_map = {};
  const uint64_t xdims[2] = {D, static_cast<uint64_t>(R)};
  const uint32_t xbox[2] = {SLAB, BM};
  const uint64_t wdims[2] = {D, static_cast<uint64_t>(sections) * D};
  const uint32_t wbox[2] = {SLAB, HALF};
  const uint64_t cdims[2] = {HD, static_cast<uint64_t>(R)};
  int rc = encode_sw128(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, 2, xdims, xbox);
  if (rc == 0) rc = encode_sw128(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, 2, wdims, wbox);
  if (rc == 0 && rot_mask)
    rc = encode_sw128(&cos_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, cosv, 2, cdims, xbox);
  if (rc == 0 && rot_mask)
    rc = encode_sw128(&sin_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, sinv, 2, cdims, xbox);
  if (rc != 0) return rc;
  err = cudaFuncSetAttribute(qkv_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  qkv_sm90<<<(R + BM - 1) / BM, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xm, wm, cos_map, sin_map, static_cast<const uint16_t*>(bias), static_cast<uint16_t*>(out0),
      static_cast<uint16_t*>(out1), static_cast<uint16_t*>(out2), R, N, sections, rot_mask);
  return static_cast<int>(cudaGetLastError());
}

// The float32 form: x (B N, 256) f32; w (2, S 256, 256) f32, the TF32 hi and
// lo halves of the section-contiguous nn.Linear weight
// (ops/qkv.py::weights_tf32); bias (S 256,) f32; cos, sin (B N, 64) f32 (may
// be null when rot_mask is 0); x, w, cos and sin 16-byte aligned;
// out0..out{S-1} (B, 4, N, 64) f32 (unused ones null). sections and rot_mask
// as for dim_qkv_rotary_bf16.
extern "C" int dim_qkv_rotary_f32(int device, const void* x, const void* w, const void* bias,
                                  const void* cosv, const void* sinv, void* out0, void* out1,
                                  void* out2, int R, int N, int sections, int rot_mask,
                                  void* stream) {
  namespace k = qkv32;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sections < 1 || sections > 3 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  CUtensorMap xm, wm, cos_map = {}, sin_map = {};
  const uint64_t xdims[2] = {k::D, static_cast<uint64_t>(R)};
  const uint32_t box[2] = {k::KC, k::BM};  // BM = HALF = 128 rows
  const uint64_t wdims[2] = {k::D, 2 * static_cast<uint64_t>(sections) * k::D};
  const uint64_t cdims[2] = {k::HD, static_cast<uint64_t>(R)};
  int rc = encode_sw128(&xm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, 2, xdims, box);
  if (rc == 0) rc = encode_sw128(&wm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w, 2, wdims, box);
  if (rc == 0 && rot_mask)
    rc = encode_sw128(&cos_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, cosv, 2, cdims, box);
  if (rc == 0 && rot_mask)
    rc = encode_sw128(&sin_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sinv, 2, cdims, box);
  if (rc != 0) return rc;
  err = cudaFuncSetAttribute(k::qkv_f32_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             k::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  k::qkv_f32_sm90<<<(R + k::BM - 1) / k::BM, k::THREADS, k::SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      xm, wm, cos_map, sin_map, static_cast<const float*>(bias), static_cast<float*>(out0),
      static_cast<float*>(out1), static_cast<float*>(out2), R, N, sections, rot_mask);
  return static_cast<int>(cudaGetLastError());
}
