// Bidirectional shared-score cross attention, LightGlue's cross block in one
// launch (kernel 6):
//   S  = qk0 . qk1^T * d^-1/2 + bias1 (columns) + bias0 (rows)
//   m0 = softmax_rows(S) . v1,   m1 = softmax_rows(S^T) . v0
// where a masked token's bias is -1e30 (so a masked row against a masked
// column scores -2e30).
//
// Replaces the TPU kernel
// deep_image_matching_tpu/ops/pallas_bidir_attention.py::bidir_cross_attention
// (_kernel), which computes each S tile once and carries direction 1's
// online-softmax state across a sequential grid axis.
//
// What bounds it on the H100: at LightGlue's shape ((16, 4, 2048, 64) bf16
// per side) the function is 6 M N d FLOP per (batch, head), 206 GFLOP against
// 67 MB of operands, so it is bound by tensor-core issue. Blocks run in no
// order here, so nothing is carried between them: one launch with grid
// (row tiles of side 0 + row tiles of side 1, batch x head). A block of the
// first kind takes 192 rows of S and runs the online softmax over v1; a block
// of the second kind takes 192 columns of S, recomputes them as qk1 . qk0^T
// with the same scale and the same two biases, and runs the online softmax
// over v0. Each block is the wgmma / TMA core of attention_sm90.cuh with the
// row bias added to S.
//
// That is four products per tile pair against the function's three. The
// shared-S form, each S tile computed once and direction 1's per-tile
// partials (m, l and a 128 x 64 f32 sum per 128-column strip) combined in
// order afterwards, would write and read back (M / 128) (N / 128) x 128 x 66
// f32 per (batch, head): 34.6 MB at 4096, 2.2 GB over 64 (batch, head) pairs,
// about 1.3 ms at 3.35 TB/s, against about 0.08 ms that the fourth product
// costs at the peak rate. Recomputation wins.
//
// Numerics follow the Pallas kernel: f32 scores, running maxima starting at
// -1e30, p = exp(s - m) cast to bf16 before the PV product with f32
// accumulation, the output divided by max(l, 1e-30) (a row masked on both
// sides against every column comes out zero) and written in bf16. Ragged M
// and N are masked in the kernel: columns past the end contribute nothing.
// Row tiles whose rows are all masked are written as zeros.
//
// The float32 form (dim_bidir_attention_f32) computes the same function with
// every product in split TF32 and P in f32, on the core of
// attention_f32_sm90.cuh, in the same recompute form: one launch on the raw
// f32 operands, which each block splits into TF32 halves itself.

#include "attention_f32_sm90.cuh"
#include "attention_sm90.cuh"

namespace {

using namespace attn_sm90;

constexpr int D = 64;  // kernel 6's head dim (LightGlue's and ALIKED's)

__global__ void __launch_bounds__(THREADS, 1)
bidir_attention_sm90(const __grid_constant__ CUtensorMap map_q0,  // qk0 in BQ-row boxes
                     const __grid_constant__ CUtensorMap map_q1,  // qk1 in BQ-row boxes
                     const __grid_constant__ CUtensorMap map_k0,  // qk0 in BK-row boxes
                     const __grid_constant__ CUtensorMap map_k1,  // qk1 in BK-row boxes
                     const __grid_constant__ CUtensorMap map_v0,
                     const __grid_constant__ CUtensorMap map_v1,
                     const uint8_t* __restrict__ mask0, const uint8_t* __restrict__ mask1,
                     uint16_t* __restrict__ o0, uint16_t* __restrict__ o1, int H, int M, int N,
                     float scale_log2) {
  const int tiles0 = (M + BQ - 1) / BQ, tiles = tiles0 + (N + BQ - 1) / BQ;
  int bh, x;  // x: a row tile of side 0, then of side 1
  block_tile(blockIdx.x, gridDim.x / tiles, tiles, bh, x);
  const int b = bh / H;
  const bool side0 = x < tiles0;
  const uint8_t* m0 = mask0 + static_cast<size_t>(b) * M;
  const uint8_t* m1 = mask1 + static_cast<size_t>(b) * N;
  Job job;
  if (side0) {
    // rows of S: side-0 queries against side-1 keys, values v1 -> o0
    job.qmap = &map_q0;
    job.kmap = &map_k1;
    job.vmap = &map_v1;
    job.qmask = m0;
    job.kmask = m1;
    job.out = o0 + static_cast<size_t>(bh) * M * D;
    job.q0 = x * BQ;
    job.Nq = M;
    job.Nk = N;
  } else {
    // columns of S: side-1 queries against side-0 keys, values v0 -> o1
    job.qmap = &map_q1;
    job.kmap = &map_k0;
    job.vmap = &map_v0;
    job.qmask = m1;
    job.kmask = m0;
    job.out = o1 + static_cast<size_t>(bh) * N * D;
    job.q0 = (x - tiles0) * BQ;
    job.Nq = N;
    job.Nk = M;
  }
  job.bh = bh;
  job.scale_log2 = scale_log2;
  attention_block<D, true>(job);
}

// the float32 form on the core of attention_f32_sm90.cuh: a side's raw rows
// serve as queries (its row tiles) and as keys (the other side's), through
// one map of 64-row boxes, since a query box and a key tile are both 64 rows
// at D = 64
static_assert(attn_f32::Geo<D>::BK == 64, "kernel 6's f32 maps take 64-row key tiles");
__global__ void __launch_bounds__(attn_f32::THREADS, 1)
bidir_attention_f32_sm90(const __grid_constant__ CUtensorMap map_q0,
                         const __grid_constant__ CUtensorMap map_q1,
                         const __grid_constant__ CUtensorMap map_v0,
                         const __grid_constant__ CUtensorMap map_v1,
                         const uint8_t* __restrict__ mask0, const uint8_t* __restrict__ mask1,
                         float* __restrict__ o0, float* __restrict__ o1, int H, int M, int N,
                         float scale_log2) {
  using attn_f32::BQ;
  const int tiles0 = (M + BQ - 1) / BQ, tiles = tiles0 + (N + BQ - 1) / BQ;
  int bh, x;
  attn_f32::block_tile(blockIdx.x, gridDim.x / tiles, tiles, bh, x);
  const int b = bh / H;
  const bool side0 = x < tiles0;
  const uint8_t* m0 = mask0 + static_cast<size_t>(b) * M;
  const uint8_t* m1 = mask1 + static_cast<size_t>(b) * N;
  attn_f32::Job job;
  if (side0) {
    job.qmap = &map_q0;
    job.kmap = &map_q1;
    job.vmap = &map_v1;
    job.qmask = m0;
    job.kmask = m1;
    job.out = o0 + static_cast<size_t>(bh) * M * D;
    job.q0 = x * BQ;
    job.Nq = M;
    job.Nk = N;
  } else {
    job.qmap = &map_q1;
    job.kmap = &map_q0;
    job.vmap = &map_v0;
    job.qmask = m1;
    job.kmask = m0;
    job.out = o1 + static_cast<size_t>(bh) * N * D;
    job.q0 = (x - tiles0) * BQ;
    job.Nq = N;
    job.Nk = M;
  }
  job.bh = bh;
  job.scale_log2 = scale_log2;
  attn_f32::attention_block<D, true>(job);
}

}  // namespace

// qk0, v0, o0 (B, H, M, 64) and qk1, v1, o1 (B, H, N, 64) bf16, contiguous,
// 16-byte aligned; mask0 (B, M) and mask1 (B, N) bool. With M = 0 (N = 0)
// the other side's output is zero.
extern "C" int dim_bidir_attention_bf16(int device, const void* qk0, const void* qk1,
                                        const void* v0, const void* v1,
                                        const void* mask0, const void* mask1, void* o0,
                                        void* o1, int B, int H, int M, int N, float scale,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || M < 0 || N < 0 || M + N == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) {
    // no keys on one side: l = 0, so the other side's rows come out zero
    void* o = M == 0 ? o1 : o0;
    const size_t rows = M == 0 ? N : M;
    return static_cast<int>(cudaMemsetAsync(o, 0, static_cast<size_t>(B) * H * rows * D * 2, st));
  }
  CUtensorMap mq0, mq1, mk0, mk1, mv0, mv1;
  int e;
  if ((e = make_map<D>(&mq0, qk0, M, B * H, BQ)) || (e = make_map<D>(&mq1, qk1, N, B * H, BQ)) ||
      (e = make_map<D>(&mk0, qk0, M, B * H)) || (e = make_map<D>(&mk1, qk1, N, B * H)) ||
      (e = make_map<D>(&mv0, v0, M, B * H)) || (e = make_map<D>(&mv1, v1, N, B * H)))
    return e;
  err = cudaFuncSetAttribute(bidir_attention_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B * H * ((M + BQ - 1) / BQ + (N + BQ - 1) / BQ);
  bidir_attention_sm90<<<grid, THREADS, Smem<D>::SMEM_BYTES, st>>>(
      mq0, mq1, mk0, mk1, mv0, mv1, static_cast<const uint8_t*>(mask0),
      static_cast<const uint8_t*>(mask1), static_cast<uint16_t*>(o0),
      static_cast<uint16_t*>(o1), H, M, N, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// The float32 form: qk0, v0, o0 (B, H, M, 64) and qk1, v1, o1 (B, H, N, 64)
// f32, contiguous, 16-byte aligned; masks as for dim_bidir_attention_bf16.
extern "C" int dim_bidir_attention_f32(int device, const void* qk0, const void* qk1,
                                       const void* v0, const void* v1, const void* mask0,
                                       const void* mask1, void* o0, void* o1, int B, int H, int M,
                                       int N, float scale, void* stream) {
  namespace af = attn_f32;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || M < 0 || N < 0 || M + N == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (M == 0 || N == 0) {
    // no keys on one side: l = 0, so the other side's rows come out zero
    void* o = M == 0 ? o1 : o0;
    const size_t rows = M == 0 ? N : M;
    return static_cast<int>(
        cudaMemsetAsync(o, 0, static_cast<size_t>(BH) * rows * D * 4, st));
  }
  CUtensorMap mq0, mq1, mv0, mv1;
  int e;
  if ((e = af::make_row_map<D>(&mq0, qk0, M, BH, 64)) ||
      (e = af::make_row_map<D>(&mq1, qk1, N, BH, 64)) ||
      (e = af::make_v_map<D>(&mv0, v0, M, BH)) || (e = af::make_v_map<D>(&mv1, v1, N, BH)))
    return e;
  err = cudaFuncSetAttribute(bidir_attention_f32_sm90,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             af::Smem<D>::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = BH * ((M + af::BQ - 1) / af::BQ + (N + af::BQ - 1) / af::BQ);
  bidir_attention_f32_sm90<<<grid, af::THREADS, af::Smem<D>::SMEM_BYTES, st>>>(
      mq0, mq1, mv0, mv1, static_cast<const uint8_t*>(mask0), static_cast<const uint8_t*>(mask1),
      static_cast<float*>(o0), static_cast<float*>(o1), H, M, N, scale * af::LOG2E);
  return static_cast<int>(cudaGetLastError());
}
