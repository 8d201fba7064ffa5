// Row and column statistics of a similarity product in one pass over it,
// for LightGlue's dual-softmax assignment without the (B, M, N) score matrix.
//
// Replaces the TPU kernels of deep_image_matching_tpu/ops/pallas_assignment.py
// (_lse_dot_kernel and _argmax_dot_kernel through _sweep, called four times by
// assignment_fused, twice per direction). With s_ij = scale * a_i . b_j, one
// pass computes, for every row i of a (B, M, Dm) and column j of b (B, N, Dm),
//   mode 0: row_i = logsumexp_j (s_ij + col_bias_j),
//           col_j = logsumexp_i (s_ij + row_bias_i);
//   mode 1: the max and the FIRST argmax of the same two families.
// Two passes (logsumexp, then argmax with biases from it) serve rows and
// columns at once, where the TPU streamed one direction per sweep.
//
// What bounds it on the H100: at the main-path shape (B = 16, M = N = 2048,
// Dm = 256, f32) one pass is 34 GFLOP against 67 MB of operands. In f32 FMA
// (67 TFLOP/s) that is issue-bound at ~0.5 ms a pass; the tensor cores run
// TF32 at 495 TFLOP/s, but one TF32 product (10-bit mantissas) moves the
// argmax. The design:
//
// - Split TF32 ("3xTF32"). Each operand is split once per call, by a small
//   elementwise kernel, into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and
//   every product runs as lo.hi + hi.lo + hi.hi with f32 accumulation on
//   wgmma m64n128k8 (both operands K-major in shared memory). The dropped
//   lo.lo term and the truncation of lo leave a relative error near 2^-22,
//   beside f32 FMA's 2^-24. Both passes reuse the split.
// - A producer warp streams 32-deep k-chunks of a 128-row tile of a and a
//   128-column tile of b, hi and lo of each (64 KB a stage), through a ring of
//   three stages by TMA (3-D maps (Dp, rows, B), 128-byte swizzle, rows past
//   the end zero-filled). a's chunks are reloaded for every column tile: 128
//   rows of a in hi and lo are 256 KB, more than a block holds. That traffic
//   is not what holds it: a pair of blocks sharing b's chunks by TMA
//   multicast ran slower, and 128 x 256 tiles spill at the 168 registers a
//   thread of this block gets (PERF.md).
// - Two consumer warpgroups own 64 rows each and keep 64 f32 accumulators a
//   thread. After a tile's 8 chunks the row statistics (online logsumexp, or
//   max and first argmax) update in registers across the quad that shares a
//   row, and the tile's column statistics over the warpgroup's 64 rows (warp
//   shuffles, then the four warps through shared memory) go to a partial
//   buffer (B, ceil(M / 64), N). A second kernel combines the partials of
//   each column in row order.
// - Masked tiles are skipped, exactly. A row or column whose bias is <= -1e29
//   is masked (the caller's -1e30; masked sums carry it too), and its own
//   statistics come out as 0 (logsumexp: any finite value keeps the next
//   pass's bias of a masked entry at -1e30) or -1e30 at index 0 (max). A
//   column tile whose columns are all masked is neither loaded nor
//   multiplied: its entries are -1e30 in f32 and change no statistic of a row
//   that has a valid column (exp(-1e30 - m) = 0, and -1e30 never beats the
//   running maximum, which starts at -1e30), and a row whose columns are all
//   masked ends at -1e30 either way. The warpgroups write neutral column
//   partials for it (-inf, 0). A block whose 128 rows are all masked only
//   writes neutral partials and its rows' sentinels. Liveness is read from
//   the biases on the device, with no host sync, so scattered masks
//   (LightGlue's pruning) skip as exactly as prefix masks.
// - Longest first. With partial masks the blocks' work differs several-fold
//   (a batch element's live column tiles, or nothing), and blocks start in
//   index order, one per SM. A one-block kernel, run with the split, counts
//   each block's work and orders the blocks heaviest first; both passes use
//   the order (their masks are the same).
//
// Argmax ties keep the first index, as jnp.argmax and the Pallas kernel's
// strict '>' over an initial -1e30 do: inside a thread indices ascend with
// strict '>', across threads, warps and row halves the lower index wins a
// tie, across column tiles strict '>' keeps the earlier, and the running
// maxima start at -1e30. Rows and columns past the end carry -inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;              // rows per block, 64 per consumer warpgroup
constexpr int BN = 128;              // columns per tile
constexpr int KC = 32;               // k per chunk: one 128-byte swizzle row of f32
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;       // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int TILE_BYTES = BM * KC * 4;  // 16 KB: 128 rows (or columns) of one chunk
constexpr int STAGE_BYTES = 4 * TILE_BYTES;  // a hi, a lo, b hi, b lo
constexpr int MAX_CT = 512;          // column tiles: N <= 65536
constexpr float NEG = -1e30f;
constexpr float MASKED = -1e29f;     // a bias at or below it marks a masked entry
constexpr int NO_INDEX = 0x7fffffff;

// shared memory from a 1024-byte aligned base
constexpr int OFF_RING = 0;
constexpr int OFF_RED = OFF_RING + STAGES * STAGE_BYTES;     // per warpgroup [2][4][BN] x 2
constexpr int RED_WG = 2 * 2 * 4 * BN * 4;                   // 8 KB
constexpr int OFF_LIVE = OFF_RED + 2 * RED_WG;               // uint8 [MAX_CT]
constexpr int OFF_BAR = OFF_LIVE + MAX_CT;                   // u64 full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = OFF_BAR + 16 * STAGES + 1024;     // + alignment slack

// (value, index) pairs: the larger value, the lower index on a tie
__device__ __forceinline__ void arg_merge(float& best, int& arg, float ob, int oa) {
  if (ob > best || (ob == best && oa < arg)) {
    best = ob;
    arg = oa;
  }
}

// hi / lo of x (rows, Dm) into (rows, Dp), zero past Dm; Dm % 4 == 0, Dp % 32 == 0
__global__ void tf32_split_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                  float* __restrict__ lo, int64_t rows, int Dm, int Dp) {
  const int64_t n4 = rows * (Dp / 4);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / (Dp / 4);
    const int k = static_cast<int>(i % (Dp / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < Dm) v = *reinterpret_cast<const float4*>(x + r * Dm + k);
    float4 h, l;
    h.x = rna_tf32(v.x); l.x = rna_tf32(v.x - h.x);
    h.y = rna_tf32(v.y); l.y = rna_tf32(v.y - h.y);
    h.z = rna_tf32(v.z); l.z = rna_tf32(v.z - h.z);
    h.w = rna_tf32(v.w); l.w = rna_tf32(v.w - h.w);
    reinterpret_cast<float4*>(hi)[i] = h;
    reinterpret_cast<float4*>(lo)[i] = l;
  }
}

// The accumulator layout of m64n128k8 (f32): acc[4 j + e] is row
// 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + (e % 2) of the
// warpgroup's 64 x 128 tile.
template <bool ARGMAX>
__global__ void __launch_bounds__(THREADS, 1)
assignment_sm90(const __grid_constant__ CUtensorMap ahi_map, const __grid_constant__ CUtensorMap alo_map,
                const __grid_constant__ CUtensorMap bhi_map, const __grid_constant__ CUtensorMap blo_map,
                const int* __restrict__ order, const float* __restrict__ row_bias,
                const float* __restrict__ col_bias, float* __restrict__ row_val,
                int* __restrict__ row_arg, float* __restrict__ part_val,
                float* __restrict__ part_sum, int* __restrict__ part_arg, int M, int N, int chunks,
                float scale) {
  extern __shared__ __align__(1024) uint8_t dyn_smem[];
  const int tid = threadIdx.x;
  uint32_t base = smem_u32(dyn_smem);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  uint8_t* sm = dyn_smem + pad;
  base += pad;
  const uint32_t bar_full = base + OFF_BAR;          // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8 * stage
  uint8_t* live = sm + OFF_LIVE;

  const int RTB = (M + BM - 1) / BM;
  const int id = order[blockIdx.x];  // heaviest blocks first
  const int b = id / RTB, rt = id % RTB;
  const int row0 = rt * BM;
  const int CT = (N + BN - 1) / BN, RT64 = (M + 63) / 64;
  const float* rb = row_bias + static_cast<size_t>(b) * M;
  const float* cb = col_bias + static_cast<size_t>(b) * N;

  // which column tiles hold a valid column, and whether any row is valid
  for (int i = tid; i < CT; i += THREADS) live[i] = 0;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    mbar_init_fence();
  }
  const bool my_row = tid < BM && row0 + tid < M && rb[row0 + tid] > MASKED;
  __syncthreads();
  for (int j = tid; j < N; j += THREADS)
    if (cb[j] > MASKED) live[j / BN] = 1;
  const int any_row = __syncthreads_or(my_row);

  if (!any_row) {
    // every row masked: sentinel rows, neutral column partials
    for (int i = tid; i < BM && row0 + i < M; i += THREADS) {
      row_val[static_cast<size_t>(b) * M + row0 + i] = ARGMAX ? NEG : 0.f;
      if (ARGMAX) row_arg[static_cast<size_t>(b) * M + row0 + i] = 0;
    }
    for (int h = 0; h < 2 && 2 * rt + h < RT64; ++h) {
      const size_t o = (static_cast<size_t>(b) * RT64 + 2 * rt + h) * N;
      for (int j = tid; j < N; j += THREADS) {
        part_val[o + j] = -INFINITY;
        if (ARGMAX) part_arg[o + j] = 0;
        else part_sum[o + j] = 0.f;
      }
    }
    return;
  }

  if (tid >= CONSUMERS) {
    // ---------------- producer warp: one lane issues ----------------------
    if (tid == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int ct = 0; ct < CT; ++ct) {
        if (!live[ct]) continue;
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(bar_empty + 8 * stage, phase ^ 1);
          const uint32_t full = bar_full + 8 * stage;
          const uint32_t dst = base + OFF_RING + stage * STAGE_BYTES;
          mbar_arrive_tx(full, STAGE_BYTES);
          tma_load_3d(dst, &ahi_map, full, kc * KC, row0, b);
          tma_load_3d(dst + TILE_BYTES, &alo_map, full, kc * KC, row0, b);
          tma_load_3d(dst + 2 * TILE_BYTES, &bhi_map, full, kc * KC, ct * BN, b);
          tma_load_3d(dst + 3 * TILE_BYTES, &blo_map, full, kc * KC, ct * BN, b);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ------------------------------------
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32, q = lane % 4;
  const int rl = warp * 16 + lane / 4;        // this thread's rows rl, rl + 8 of the 64
  const int i0 = row0 + wg * 64 + rl, i1 = i0 + 8;
  const float rb0 = i0 < M ? rb[i0] : -INFINITY;
  const float rb1 = i1 < M ? rb[i1] : -INFINITY;
  const int rt64 = 2 * rt + wg;               // this warpgroup's row half
  const size_t part0 = (static_cast<size_t>(b) * RT64 + rt64) * N;
  float* red_v = reinterpret_cast<float*>(sm + OFF_RED + wg * RED_WG);  // [2][4][BN]
  float* red_a = red_v + 2 * 4 * BN;          // sums, or indices as int
  float run_max[2] = {NEG, NEG}, run_sum[2] = {0.f, 0.f};
  int run_arg[2] = {0, 0};

  int stage = 0, buf = 0;
  uint32_t phase = 0;
  for (int ct = 0; ct < CT; ++ct) {
    const int c0 = ct * BN;
    if (!live[ct]) {
      if (rt64 < RT64 && c0 + wt < N) {
        part_val[part0 + c0 + wt] = -INFINITY;
        if (ARGMAX) part_arg[part0 + c0 + wt] = 0;
        else part_sum[part0 + c0 + wt] = 0.f;
      }
      continue;
    }

    // s = a . b^T over the chunks: lo.hi + hi.lo + hi.hi per k-step; a
    // chunk's stage is released once the next chunk is issued and it is done
    float acc[64];
    int prev = -1;
#pragma unroll 1
    for (int kc = 0; kc < chunks; ++kc) {
      mbar_wait(bar_full + 8 * stage, phase);
      const uint32_t st = base + OFF_RING + stage * STAGE_BYTES;
      const uint64_t ahi = sw128_desc(st + wg * (TILE_BYTES / 2), 1);
      const uint64_t alo = sw128_desc(st + TILE_BYTES + wg * (TILE_BYTES / 2), 1);
      const uint64_t bhi = sw128_desc(st + 2 * TILE_BYTES, 1);
      const uint64_t blo = sw128_desc(st + 3 * TILE_BYTES, 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {  // 8 f32 = 32 bytes = 2 descriptor units
        wgmma_tf32(acc, alo + 2 * kk, bhi + 2 * kk, kc | kk);
        wgmma_tf32(acc, ahi + 2 * kk, blo + 2 * kk, 1);
        wgmma_tf32(acc, ahi + 2 * kk, bhi + 2 * kk, 1);
      }
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

    // this thread's 32 columns: biases (-inf past the end)
    float cbv[32];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j + 2 * q;
      cbv[2 * j] = col < N ? cb[col] : -INFINITY;
      cbv[2 * j + 1] = col + 1 < N ? cb[col + 1] : -INFINITY;
    }

    // row statistics over the tile's columns (the quad holds a row)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (ARGMAX) {
        float best = -INFINITY;
        int arg = NO_INDEX;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[4 * j + 2 * r + e] * scale + cbv[2 * j + e];
            if (v > best) {
              best = v;
              arg = c0 + 8 * j + 2 * q + e;
            }
          }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1)
          arg_merge(best, arg, __shfl_xor_sync(0xffffffffu, best, o),
                    __shfl_xor_sync(0xffffffffu, arg, o));
        if (best > run_max[r]) {
          run_max[r] = best;
          run_arg[r] = arg;
        }
      } else {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            tmax = fmaxf(tmax, acc[4 * j + 2 * r + e] * scale + cbv[2 * j + e]);
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        const float m_new = fmaxf(run_max[r], tmax);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            s += __expf(acc[4 * j + 2 * r + e] * scale + cbv[2 * j + e] - m_new);
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        run_sum[r] = run_sum[r] * __expf(run_max[r] - m_new) + s;
        run_max[r] = m_new;
      }
    }

    // column statistics over the warpgroup's 64 rows: the thread's two rows,
    // the 8 row groups of the warp by shuffles, the 4 warps through shared
    // memory
    float* rv = red_v + buf * 4 * BN + warp * BN;
    float* ra = red_a + buf * 4 * BN + warp * BN;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float u0 = acc[4 * j + e] * scale + rb0;
        const float u1 = acc[4 * j + 2 + e] * scale + rb1;
        if (ARGMAX) {
          float best = u0;
          int arg = i0;
          if (u1 > best) {
            best = u1;
            arg = i1;
          }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            arg_merge(best, arg, __shfl_xor_sync(0xffffffffu, best, o),
                      __shfl_xor_sync(0xffffffffu, arg, o));
          if (lane < 4) {
            rv[8 * j + 2 * q + e] = best;
            reinterpret_cast<int*>(ra)[8 * j + 2 * q + e] = arg;
          }
        } else {
          float m = fmaxf(u0, u1);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          const float mm = m == -INFINITY ? 0.f : m;
          float s = __expf(u0 - mm) + __expf(u1 - mm);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (lane < 4) {
            rv[8 * j + 2 * q + e] = m;
            ra[8 * j + 2 * q + e] = s;
          }
        }
      }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (rt64 < RT64 && c0 + wt < N) {
      const float* cv = red_v + buf * 4 * BN + wt;
      const float* ca = red_a + buf * 4 * BN + wt;
      if (ARGMAX) {
        float best = cv[0];
        int arg = reinterpret_cast<const int*>(ca)[0];
#pragma unroll
        for (int w = 1; w < 4; ++w)
          arg_merge(best, arg, cv[w * BN], reinterpret_cast<const int*>(ca)[w * BN]);
        part_val[part0 + c0 + wt] = best;
        part_arg[part0 + c0 + wt] = arg;
      } else {
        float m = cv[0];
#pragma unroll
        for (int w = 1; w < 4; ++w) m = fmaxf(m, cv[w * BN]);
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (cv[w * BN] != -INFINITY) s += ca[w * BN] * __expf(cv[w * BN] - m);
        part_val[part0 + c0 + wt] = m;
        part_sum[part0 + c0 + wt] = s;
      }
    }
    // the next tile writes the other buffer; the one after passes the next
    // tile's barrier first, which every thread reaches after these reads
    buf ^= 1;
  }

  if (q == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r ? i1 : i0;
      if (i < M) {
        const size_t o = static_cast<size_t>(b) * M + i;
        const bool masked = (r ? rb1 : rb0) <= MASKED;
        if (ARGMAX) {
          row_val[o] = masked ? NEG : run_max[r];
          row_arg[o] = masked ? 0 : run_arg[r];
        } else {
          row_val[o] = masked ? 0.f : run_max[r] + logf(fmaxf(run_sum[r], 1e-38f));
        }
      }
    }
  }
}

// combine the column partials of the RT row halves, in row order; masked
// columns get the sentinels
template <bool ARGMAX>
__global__ void combine_cols_kernel(const float* __restrict__ part_val,
                                    const float* __restrict__ part_sum,
                                    const int* __restrict__ part_arg,
                                    const float* __restrict__ col_bias,
                                    float* __restrict__ col_val, int* __restrict__ col_arg,
                                    int B, int RT, int N) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * N) return;
  const int b = idx / N, j = idx % N;
  const size_t base = static_cast<size_t>(b) * RT * N + j;
  if (col_bias[idx] <= MASKED) {
    col_val[idx] = ARGMAX ? NEG : 0.f;
    if (ARGMAX) col_arg[idx] = 0;
    return;
  }
  if (ARGMAX) {
    float best = NEG;
    int arg = 0;
    for (int k = 0; k < RT; ++k) {
      const float v = part_val[base + static_cast<size_t>(k) * N];
      if (v > best) {
        best = v;
        arg = part_arg[base + static_cast<size_t>(k) * N];
      }
    }
    col_val[idx] = best;
    col_arg[idx] = arg;
  } else {
    float m = NEG;
    for (int k = 0; k < RT; ++k) m = fmaxf(m, part_val[base + static_cast<size_t>(k) * N]);
    float s = 0.f;
    for (int k = 0; k < RT; ++k) {
      const size_t o = base + static_cast<size_t>(k) * N;
      s += part_sum[o] * expf(part_val[o] - m);
    }
    col_val[idx] = m + logf(fmaxf(s, 1e-38f));
  }
}

// The order in which blocks take (batch, row tile) pairs: blocks start in
// index order, one per SM, and a block's work is its live column tiles (none
// if its rows are all masked), so the heaviest go first and the short ones
// fill the tail (longest-first list scheduling). Keys are counted, not
// sorted; equal keys land in any order. Past the shared-memory tables'
// sizes the order is the identity.
constexpr int ORDER_THREADS = 1024;
constexpr int ORDER_MAX_BLOCKS = 4096;
constexpr int ORDER_MAX_B = 1024;

__global__ void __launch_bounds__(ORDER_THREADS)
block_order_kernel(const float* __restrict__ row_bias, const float* __restrict__ col_bias,
                   int* __restrict__ order, int B, int M, int N) {
  __shared__ int colcount[ORDER_MAX_B];
  __shared__ uint16_t key[ORDER_MAX_BLOCKS];
  __shared__ int offset[MAX_CT + 1];
  const int tid = threadIdx.x;
  const int RTB = (M + BM - 1) / BM, CT = (N + BN - 1) / BN, nblk = RTB * B;
  if (nblk > ORDER_MAX_BLOCKS || B > ORDER_MAX_B) {
    for (int i = tid; i < nblk; i += ORDER_THREADS) order[i] = i;
    return;
  }
  for (int i = tid; i < B; i += ORDER_THREADS) colcount[i] = 0;
  for (int i = tid; i <= CT; i += ORDER_THREADS) offset[i] = 0;
  __syncthreads();
  for (int t = tid; t < B * CT; t += ORDER_THREADS) {
    const int b = t / CT, c0 = (t % CT) * BN;
    const float* cb = col_bias + static_cast<size_t>(b) * N + c0;
    bool any = false;
    for (int j = 0; j < BN && c0 + j < N && !any; ++j) any = cb[j] > MASKED;
    if (any) atomicAdd(&colcount[b], 1);
  }
  __syncthreads();
  for (int i = tid; i < nblk; i += ORDER_THREADS) {
    const int b = i / RTB, r0 = (i % RTB) * BM;
    const float* rb = row_bias + static_cast<size_t>(b) * M + r0;
    bool any = false;
    for (int j = 0; j < BM && r0 + j < M && !any; ++j) any = rb[j] > MASKED;
    key[i] = static_cast<uint16_t>(any ? colcount[b] : 0);
    atomicAdd(&offset[key[i]], 1);
  }
  __syncthreads();
  if (tid == 0) {  // each key's first slot, the largest key first
    int run = 0;
    for (int k = CT; k >= 0; --k) {
      const int count = offset[k];
      offset[k] = run;
      run += count;
    }
  }
  __syncthreads();
  for (int i = tid; i < nblk; i += ORDER_THREADS) order[atomicAdd(&offset[key[i]], 1)] = i;
}

// the (Dp, rows, B) f32 tensor map of one half of a split buffer
int split_map(CUtensorMap* map, const float* ptr, int rows, int B, int Dp) {
  const uint64_t dims[3] = {static_cast<uint64_t>(Dp), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(B)};
  const uint32_t box[3] = {KC, BM, 1};  // BN == BM: one box serves both operands
  return encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, 3, dims, box);
}

int split(const float* x, float* out, int64_t rows, int Dm, int Dp, cudaStream_t s) {
  const int64_t n4 = rows * (Dp / 4);
  const int blocks = static_cast<int>(n4 < 132 * 32 * 256 ? (n4 + 255) / 256 : 132 * 32);
  tf32_split_kernel<<<blocks, 256, 0, s>>>(x, out, out + rows * Dp, rows, Dm, Dp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (B, M, Dm), bm (B, N, Dm) f32 with Dm % 4 == 0 and 16-byte aligned;
// a_split (2, B, M, Dp) and b_split (2, B, N, Dp) f32 scratch, Dp = Dm
// rounded up to 32, holding the TF32 hi and lo halves of a and bm, and
// order, int32 scratch of B ceil(M/128) block assignments (all written here
// when `fill` is non-zero, else taken as an earlier pass over the same a,
// bm and masks wrote them);
// row_bias (B, M), col_bias (B, N); outputs row_val (B, M) and col_val
// (B, N) f32, row_arg / col_arg int32 (argmax only); scratch part_val
// (B, ceil(M/64), N) f32 and part_aux of the same shape (f32 sums, or int32
// indices for argmax). All contiguous; N <= 65536.
extern "C" int dim_assignment_pass(int device, const void* a, const void* bm, void* a_split,
                                   void* b_split, void* order, int fill, const void* row_bias,
                                   const void* col_bias, void* row_val, void* row_arg,
                                   void* col_val, void* col_arg, void* part_val,
                                   void* part_aux, int B, int M, int N, int Dm, float scale,
                                   int argmax, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || M <= 0 || N <= 0 || Dm <= 0 || Dm % 4 || (N + BN - 1) / BN > MAX_CT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dp = (Dm + KC - 1) / KC * KC;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* as = static_cast<float*>(a_split);
  float* bs = static_cast<float*>(b_split);
  const float* rbias = static_cast<const float*>(row_bias);
  const float* cbias = static_cast<const float*>(col_bias);
  int* blk = static_cast<int*>(order);
  if (fill) {
    int rc = split(static_cast<const float*>(a), as, static_cast<int64_t>(B) * M, Dm, Dp, s);
    if (rc == 0) rc = split(static_cast<const float*>(bm), bs, static_cast<int64_t>(B) * N, Dm, Dp, s);
    if (rc != 0) return rc;
    block_order_kernel<<<1, ORDER_THREADS, 0, s>>>(rbias, cbias, blk, B, M, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  CUtensorMap ahi, alo, bhi, blo;
  int rc = split_map(&ahi, as, M, B, Dp);
  if (rc == 0) rc = split_map(&alo, as + static_cast<size_t>(B) * M * Dp, M, B, Dp);
  if (rc == 0) rc = split_map(&bhi, bs, N, B, Dp);
  if (rc == 0) rc = split_map(&blo, bs + static_cast<size_t>(B) * N * Dp, N, B, Dp);
  if (rc != 0) return rc;
  const int RT = (M + 63) / 64;
  const int grid = (M + BM - 1) / BM * B;
  const int blocks = (B * N + 255) / 256;
  auto kernel = argmax ? assignment_sm90<true> : assignment_sm90<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (argmax) {
    kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        ahi, alo, bhi, blo, blk, rbias, cbias, static_cast<float*>(row_val), static_cast<int*>(row_arg),
        static_cast<float*>(part_val), nullptr, static_cast<int*>(part_aux), M, N, Dp / KC, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    combine_cols_kernel<true><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(part_val), nullptr, static_cast<const int*>(part_aux), cbias,
        static_cast<float*>(col_val), static_cast<int*>(col_arg), B, RT, N);
  } else {
    kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        ahi, alo, bhi, blo, blk, rbias, cbias, static_cast<float*>(row_val), nullptr,
        static_cast<float*>(part_val), static_cast<float*>(part_aux), nullptr, M, N, Dp / KC, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    combine_cols_kernel<false><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(part_val), static_cast<const float*>(part_aux), nullptr, cbias,
        static_cast<float*>(col_val), nullptr, B, RT, N);
  }
  return static_cast<int>(cudaGetLastError());
}
