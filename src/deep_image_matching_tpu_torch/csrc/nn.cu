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
// What bounds it on the H100: at the main-path shape (B = 16, K0 = K1 =
// 4096, D = 256) one call is 137 GFLOP of f32 FMA against 134 MB of operands,
// bound by FMA issue; the dense form writes and re-reads a 1 GB distance
// matrix. Blocks run in no order, so one block per (128 query rows, batch)
// loops over all 128-column tiles itself and nothing is carried across
// blocks: each thread keeps its 8 rows' top-2 over its own columns in
// registers, and the 16 threads that share a row merge theirs at the end.
// Each thread computes an 8 x 8 register tile from float4 loads of 16-deep
// k-chunks in shared memory (the layout of csrc/assignment.cu). Products
// stay f32 FMA: a TF32 or bf16 product would move argmins on float
// descriptors, and on integer-valued ones (SIFT, ORB: every partial sum
// below 2^24) f32 is exact, so the result is bitwise that of the plain
// version.
//
// The result does not depend on the order of the merges: min and max are
// order-free, min2 = min(max(m1, n1), min(m2, n2)) is the multiset's second
// element for any split, and ties of min1 keep the smaller index.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;         // query rows per block, columns per tile
constexpr int KC = 16;         // k-chunk staged in shared memory
constexpr int LDS = T + 4;     // padded shared-memory row (floats)
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr float INF = 3.0e38f;
constexpr float PAD_SQ = 1.0e12f;

// this thread's i-th row (or column) of a 128-wide tile: two groups of 4
__device__ __forceinline__ int sub(int t, int i) { return (i >> 2) * 64 + t * 4 + (i & 3); }

// merge the top-2 state (n1, n2, nb) into (m1, m2, a)
__device__ __forceinline__ void merge_top2(float& m1, float& m2, int& a,
                                           float n1, float n2, int nb) {
  m2 = fminf(fmaxf(m1, n1), fminf(m2, n2));
  a = n1 < m1 ? nb : (m1 < n1 ? a : min(a, nb));
  m1 = fminf(m1, n1);
}

__global__ void __launch_bounds__(THREADS)
nn_top2_kernel(const float* __restrict__ d0, const float* __restrict__ d1,
               const float* __restrict__ sq1, float* __restrict__ min1,
               float* __restrict__ min2, int* __restrict__ arg,
               int K0, int K1, int D) {
  __shared__ __align__(16) float as[KC][LDS];
  __shared__ __align__(16) float bs[KC][LDS];

  const int b = blockIdx.y, row0 = blockIdx.x * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* ab = d0 + static_cast<size_t>(b) * K0 * D;
  const float* bb = d1 + static_cast<size_t>(b) * K1 * D;
  const float* sqb = sq1 + static_cast<size_t>(b) * K1;

  float m1[8], m2[8];
  int am[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m1[r] = INF;
    m2[r] = INF;
    am[r] = 0;
  }

  const int Kn = (K1 + T - 1) / T * T;  // padded as the Pallas wrapper pads
  for (int c0 = 0; c0 < Kn; c0 += T) {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KC) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < T * KC / 4; i += THREADS) {
        const int r = i / (KC / 4), q = (i % (KC / 4)) * 4;
        float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
        if (row0 + r < K0)
          va = *reinterpret_cast<const float4*>(ab + static_cast<size_t>(row0 + r) * D + k0 + q);
        if (c0 + r < K1)
          vb = *reinterpret_cast<const float4*>(bb + static_cast<size_t>(c0 + r) * D + k0 + q);
        as[q][r] = va.x; as[q + 1][r] = va.y; as[q + 2][r] = va.z; as[q + 3][r] = va.w;
        bs[q][r] = vb.x; bs[q + 1][r] = vb.y; bs[q + 2][r] = vb.z; bs[q + 3][r] = vb.w;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
        const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
      }
    }

    // columns past K1 have zero descriptors and squared norm 1e12
    float sqc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = c0 + sub(tx, c);
      sqc[c] = j < K1 ? sqb[j] : PAD_SQ;
    }
    // c ascends with j, so inside a thread indices arrive in order
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        merge_top2(m1[r], m2[r], am[r], sqc[c] - 2.f * acc[r][c], INF, c0 + sub(tx, c));
  }

  // the 16 threads of a row are lanes of one half-warp
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const float n1 = __shfl_xor_sync(0xffffffffu, m1[r], o);
      const float n2 = __shfl_xor_sync(0xffffffffu, m2[r], o);
      const int nb = __shfl_xor_sync(0xffffffffu, am[r], o);
      merge_top2(m1[r], m2[r], am[r], n1, n2, nb);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = row0 + sub(ty, r);
      if (i < K0) {
        const size_t o = static_cast<size_t>(b) * K0 + i;
        min1[o] = m1[r];
        min2[o] = m2[r];
        arg[o] = am[r];
      }
    }
  }
}

}  // namespace

// d0 (B, K0, D), d1 (B, K1, D) f32 with D % 16 == 0 and 16-byte aligned
// rows; sq1 (B, K1) f32; outputs min1, min2 (B, K0) f32 and arg (B, K0)
// int32. All contiguous.
extern "C" int dim_nn_top2(int device, const void* d0, const void* d1, const void* sq1,
                           void* min1, void* min2, void* arg, int B, int K0, int K1,
                           int D, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K0 + T - 1) / T, B);
  nn_top2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d0), static_cast<const float*>(d1),
      static_cast<const float*>(sq1), static_cast<float*>(min1),
      static_cast<float*>(min2), static_cast<int*>(arg), K0, K1, D);
  return static_cast<int>(cudaGetLastError());
}
