// Running top-2 nearest neighbours of descriptor sets, without the
// (K0, K1) distance matrix:
//   for every query row i of d0 (B, K0, D) over the columns j of d1 (B, K1, D)
//   of dist_ij = sq1_j - 2 d0_i . d1_j:
//     min1_i = the smallest value, arg_i = the smallest j that reaches it,
//     min2_i = the second element of the multiset {dist_ij}_j (equal to
//              min1_i when the minimum is attained twice).
//
// Replaces the TPU kernel deep_image_matching_tpu/ops/pallas_nn.py::nn_top2
// (_nn_kernel), which streams 512-column tiles through VMEM and carries the
// running (min1, min2, arg) across a sequential grid axis. Columns past K1
// count as padding of squared norm 1e12 and zero descriptor, as the Pallas
// wrapper pads K1 to a multiple of 128.
//
// What bounds it on the H100: at SuperPoint's shape (B = 16, K0 = K1 = 4096,
// D = 256) one call is 137 GFLOP of products against 134 MB of operands. One
// f32 product would run on the CUDA cores at 67 TFLOP/s (2.05 ms); a TF32
// product (10-bit mantissas) on the tensor cores moves argmins of float
// descriptors, so the product runs as three TF32 products, whose bound is
// 3 x 137 GFLOP at 495 TFLOP/s = 0.83 ms; the bytes take 0.04 ms at
// 3.35 TB/s. The design:
//
// - Split TF32 ("3xTF32"), as kernel 3 (assignment.cu) runs it. A small
//   elementwise launch (nn_split_kernel) splits each operand once into
//   hi = rna_tf32(x) and lo = rna_tf32(x - hi), a (2, B, K, D) buffer; the
//   mutual check of nn_match_fused reuses both sides' halves with the roles
//   swapped. Every product runs as lo.hi + hi.lo + hi.hi with f32
//   accumulation on wgmma m64n128k8, both operands K-major in shared memory.
//   The split, the kernel and the merge below are launched by one host call
//   (dim_nn_top2): at the upright probe's shapes the host's dispatch, not
//   the device, sets the time of a call.
//   The dropped lo.lo term and the rounding of lo leave a relative error near
//   2^-22 of |d0| |d1|, beside f32 FMA's 2^-24.
// - Tiles fed by TMA. A producer warp streams 32-deep k-chunks (one 128-byte
//   swizzle row of f32) of the reference tile's hi and lo through a ring of
//   three stages of 64 KB (3-D maps (D, K, B), rows past K and k past D
//   zero-filled), with the 128-row query tile's hi and lo chunks, as kernel
//   3 streams its a. Two consumer warpgroups own 64 query rows each, with 64
//   f32 accumulators a thread (137 registers, no spills). Two other designs
//   were measured and dropped (PERF.md): the query tile resident in shared
//   memory at D <= 128 was within 1-5 % of streaming it, and 256-column
//   tiles (two stages of 96 KB) ran 1.1-3.3x slower.
// - Epilogue in registers. After a column tile's chunks each thread folds
//   its accumulators' distances, sq1_j - 2 acc, into a running top-2 of its
//   two rows, over its own columns in ascending index order (padded columns
//   1e12). At the end the four lanes of a quad, which share a row, merge.
// - Column slices. The wrapper may split the column tiles into slices, one
//   block each, the slices of a query tile neighbours in the grid, and a
//   second launch (nn_merge_kernel) merges each row's partial (min1, min2,
//   arg). It does so where B ceil(K0 / 128) blocks would leave SMs idle (the
//   upright probe's (4, 512) is 16 blocks on 132 SMs), and where streamed
//   query tiles outgrow L2: 132 blocks re-read 132 tiles of 128 x D in hi and
//   lo for every column tile, 130 MB at RIPE's D = 960, so blocks that run
//   together share each query tile in ceil(D / 128) slices (6.0 -> 3.9 ms
//   at (16, 4096, 4096, 960)).
//
// The result does not depend on the order of the merges: min and max are
// order-free, min2 = min(max(m1, n1), min(m2, n2)) is the multiset's second
// element for any split, and ties of min1 keep the smaller index. Byte-valued
// descriptors (SIFT, ORB) are exact: a value <= 255 is exact in TF32 (lo = 0),
// its products are exact, and every partial sum is an integer below 2^24, so
// the result is bitwise that of the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;                  // query rows per block, 64 per consumer warpgroup
constexpr int BN = 128;                  // columns per tile
constexpr int KC = 32;                   // k per chunk: one 128-byte swizzle row of f32
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int TILE_BYTES = BM * KC * 4;  // 16 KB: 128 rows (or columns) of one chunk
constexpr int STAGE_BYTES = 4 * TILE_BYTES;  // a hi, a lo, b hi, b lo
constexpr int OFF_BAR = STAGES * STAGE_BYTES;    // u64 full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = OFF_BAR + 16 * STAGES + 1024;  // + alignment slack
constexpr float INF = 3.0e38f;
constexpr float PAD_SQ = 1.0e12f;

// merge the top-2 state (n1, n2, nb) into (m1, m2, a)
__device__ __forceinline__ void merge_top2(float& m1, float& m2, int& a,
                                           float n1, float n2, int nb) {
  m2 = fminf(fmaxf(m1, n1), fminf(m2, n2));
  a = n1 < m1 ? nb : (m1 < n1 ? a : min(a, nb));
  m1 = fminf(m1, n1);
}

// hi / lo halves of x0 (n0 floats) into s0 (2, n0) and of x1 into s1, in
// one launch; n0 % 4 == n1 % 4 == 0, all 16-byte aligned
__global__ void nn_split_kernel(const float* __restrict__ x0, float* __restrict__ s0, int64_t n0,
                                const float* __restrict__ x1, float* __restrict__ s1,
                                int64_t n1) {
  const int64_t q0 = n0 / 4, total = q0 + n1 / 4;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const bool first = i < q0;
    const int64_t k = first ? i : i - q0;
    const float4 v = reinterpret_cast<const float4*>(first ? x0 : x1)[k];
    float4* hi = reinterpret_cast<float4*>(first ? s0 : s1);
    float4* lo = hi + (first ? q0 : total - q0);
    float4 h, l;
    h.x = rna_tf32(v.x); l.x = rna_tf32(v.x - h.x);
    h.y = rna_tf32(v.y); l.y = rna_tf32(v.y - h.y);
    h.z = rna_tf32(v.z); l.z = rna_tf32(v.z - h.z);
    h.w = rna_tf32(v.w); l.w = rna_tf32(v.w - h.w);
    hi[k] = h;
    lo[k] = l;
  }
}

// One block: 128 query rows of batch element b against the column tiles
// [ct0, ct1) of its slice; the slices of one query tile are neighbours in
// the grid, so blocks that run together share the tile in L2. The
// accumulator layout of m64n128k8 (f32):
// acc[4 j + e] is row 16 warp + lane / 4 + 8 (e / 2), column
// 8 j + 2 (lane % 4) + (e % 2) of the warpgroup's 64 x 128 tile. Outputs go
// to (slice, B, K0) arrays (slice 0 only, the final ones, when unsplit).
__global__ void __launch_bounds__(THREADS, 1)
nn_top2_sm90(const __grid_constant__ CUtensorMap ahi_map, const __grid_constant__ CUtensorMap alo_map,
             const __grid_constant__ CUtensorMap bhi_map, const __grid_constant__ CUtensorMap blo_map,
             const float* __restrict__ sq1, float* __restrict__ min1, float* __restrict__ min2,
             int* __restrict__ arg, int B, int K0, int K1, int chunks, int slices,
             int per_slice) {
  extern __shared__ __align__(1024) uint8_t dyn_smem[];
  const int tid = threadIdx.x;
  uint32_t base = smem_u32(dyn_smem);
  base += (1024u - (base & 1023u)) & 1023u;
  const uint32_t bar_full = base + OFF_BAR;          // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8 * stage

  const int RT = (K0 + BM - 1) / BM;
  const int slice = blockIdx.x % slices, rest = blockIdx.x / slices;
  const int b = rest / RT, row0 = (rest % RT) * BM;
  const int ct0 = slice * per_slice;
  const int ct1 = min((K1 + BN - 1) / BN, ct0 + per_slice);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------- producer warp: one lane issues ----------------------
    if (tid == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int ct = ct0; ct < ct1; ++ct) {
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(bar_empty + 8 * stage, phase ^ 1);
          const uint32_t full = bar_full + 8 * stage;
          const uint32_t dst = base + stage * STAGE_BYTES;
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
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, q = lane % 4;
  const float* sqb = sq1 + static_cast<size_t>(b) * K1;
  float m1[2] = {INF, INF}, m2[2] = {INF, INF};
  int am[2] = {0, 0};

  int stage = 0;
  uint32_t phase = 0;
  for (int ct = ct0; ct < ct1; ++ct) {
    // acc = a . b^T over the chunks: lo.hi + hi.lo + hi.hi per k-step; a
    // chunk's stage is released once the next chunk is issued and it is done
    float acc[64];
    int prev = -1;
#pragma unroll 1
    for (int kc = 0; kc < chunks; ++kc) {
      mbar_wait(bar_full + 8 * stage, phase);
      const uint32_t st = base + stage * STAGE_BYTES;
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

    // distances into the running top-2 of the thread's two rows, columns in
    // ascending order; a tie keeps the earlier index, and min2 takes it
    const int c0 = ct * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + 2 * q + e;
        const float sq = col < K1 ? __ldg(sqb + col) : PAD_SQ;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v = sq - 2.f * acc[4 * j + 2 * r + e];
          if (v < m1[r]) {
            m2[r] = m1[r];
            m1[r] = v;
            am[r] = col;
          } else {
            m2[r] = fminf(m2[r], v);
          }
        }
      }
  }

  // the four lanes of a quad hold the same rows
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float n1 = __shfl_xor_sync(0xffffffffu, m1[r], o);
      const float n2 = __shfl_xor_sync(0xffffffffu, m2[r], o);
      const int nb = __shfl_xor_sync(0xffffffffu, am[r], o);
      merge_top2(m1[r], m2[r], am[r], n1, n2, nb);
    }
  if (q == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
      if (i < K0) {
        const size_t o = (static_cast<size_t>(slice) * B + b) * K0 + i;
        min1[o] = m1[r];
        min2[o] = m2[r];
        arg[o] = am[r];
      }
    }
  }
}

// each row's partials of the `slices` column slices, (slices, n), merged
__global__ void nn_merge_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                                const int* __restrict__ pa, float* __restrict__ min1,
                                float* __restrict__ min2, int* __restrict__ arg, int slices,
                                int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float m1 = p1[i], m2 = p2[i];
  int a = pa[i];
  for (int s = 1; s < slices; ++s) {
    const size_t o = static_cast<size_t>(s) * n + i;
    merge_top2(m1, m2, a, p1[o], p2[o], pa[o]);
  }
  min1[i] = m1;
  min2[i] = m2;
  arg[i] = a;
}

// the (D, rows, B) f32 tensor map of one half of a split buffer
int split_map(CUtensorMap* map, const float* ptr, int rows, int B, int D) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(B)};
  const uint32_t box[3] = {KC, BM, 1};  // BN == BM: one box serves both operands
  return encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, 3, dims, box);
}

}  // namespace

// d0 (B, K0, D) and d1 (B, K1, D) f32, D % 4 == 0; a_split (2, B, K0, D) and
// b_split (2, B, K1, D) f32 scratch holding their TF32 halves, hi then lo
// (written here first when `fill` is non-zero, else taken as an earlier call
// over the same d0 and d1, in either role, wrote them); sq1 (B, K1) f32;
// outputs min1, min2 (B, K0) f32 and arg (B, K0) int32; with slices > 1, part
// (3, slices, B, K0) 4-byte scratch for each column slice's min1, min2 and
// arg, merged into the outputs by a second launch. All contiguous, 16-byte
// aligned but sq1 and the outputs.
extern "C" int dim_nn_top2(int device, const void* d0, const void* d1, void* a_split,
                           void* b_split, int fill, const void* sq1, void* min1, void* min2,
                           void* arg, void* part, int B, int K0, int K1, int D, int slices,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || K0 <= 0 || K1 <= 0 || D <= 0 || D % 4 || slices <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* as = static_cast<float*>(a_split);
  float* bs = static_cast<float*>(b_split);
  const size_t a_half = static_cast<size_t>(B) * K0 * D, b_half = static_cast<size_t>(B) * K1 * D;
  if (fill) {
    const int64_t q = static_cast<int64_t>(a_half + b_half) / 4;
    const int blocks = static_cast<int>(q < 132 * 16 * 256 ? (q + 255) / 256 : 132 * 16);
    nn_split_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(d0), as, a_half,
                                           static_cast<const float*>(d1), bs, b_half);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  CUtensorMap ahi, alo, bhi, blo;
  int rc = split_map(&ahi, as, K0, B, D);
  if (rc == 0) rc = split_map(&alo, as + a_half, K0, B, D);
  if (rc == 0) rc = split_map(&bhi, bs, K1, B, D);
  if (rc == 0) rc = split_map(&blo, bs + b_half, K1, B, D);
  if (rc != 0) return rc;
  const int CT = (K1 + BN - 1) / BN;
  const int per_slice = (CT + slices - 1) / slices;
  const int grid = B * ((K0 + BM - 1) / BM) * slices;
  const int n = B * K0;
  float* p1 = slices > 1 ? static_cast<float*>(part) : static_cast<float*>(min1);
  float* p2 = slices > 1 ? p1 + static_cast<size_t>(slices) * n : static_cast<float*>(min2);
  int* pa = slices > 1 ? reinterpret_cast<int*>(p2 + static_cast<size_t>(slices) * n)
                       : static_cast<int*>(arg);
  err = cudaFuncSetAttribute(nn_top2_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_top2_sm90<<<grid, THREADS, SMEM_BYTES, s>>>(ahi, alo, bhi, blo,
                                                 static_cast<const float*>(sq1), p1, p2, pa, B,
                                                 K0, K1, (D + KC - 1) / KC, slices, per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  nn_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(p1, p2, pa, static_cast<float*>(min1),
                                                  static_cast<float*>(min2),
                                                  static_cast<int*>(arg), slices, n);
  return static_cast<int>(cudaGetLastError());
}
