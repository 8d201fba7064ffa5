// Masked multi-head attention with an online softmax, for LightGlue's self
// and cross attention, SuperGlue's attention and DINOv2 (kernel 1).
//
// Replaces the TPU kernel reached by
// deep_image_matching_tpu/ops/attention.py::fused_attention (the bundled
// Pallas flash-attention kernel, padding expressed as segment ids).
//
// What bounds it on the H100: at the main-path shape (q, k, v of
// (16, 4, 2048, 64) bf16) one call is 69 GFLOP against 50 MB of operands, so
// it is bound by tensor-core issue, not by memory. The dense form would also
// write and re-read a (B, H, Nq, Nk) f32 score tensor (1 GB per call). The
// block body is the wgmma / TMA core of attention_sm90.cuh: 192 query rows
// per block (three consumer warpgroups of 64), 128-key tiles fed by TMA into
// a shared-memory ring, both products on wgmma, the score tiles kept in
// registers.
//
// Semantics follow xla_attention (the JAX package's dense reference): scores
// are scaled, masked keys get -1e30 (so a query whose keys are all masked
// averages every key uniformly), keys past Nk contribute nothing. Query tiles
// whose queries are all masked are written as zeros and skipped; other rows
// of masked queries are computed like valid rows. Callers read valid rows
// only (their values are undefined in the JAX package too).

#include "attention_sm90.cuh"

namespace {

using namespace attn_sm90;

__global__ void __launch_bounds__(THREADS, 1)
attention_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ q_mask,
               const uint8_t* __restrict__ kv_mask, uint16_t* __restrict__ out, int H, int Nq,
               int Nk, float scale_log2) {
  const int tiles = (Nq + BQ - 1) / BQ;
  int bh, x;
  block_tile(blockIdx.x, gridDim.x / tiles, tiles, bh, x);
  const int b = bh / H;
  Job job;
  job.qmap = &qmap;
  job.kmap = &kmap;
  job.vmap = &vmap;
  job.qmask = q_mask == nullptr ? nullptr : q_mask + static_cast<size_t>(b) * Nq;
  job.kmask = kv_mask == nullptr ? nullptr : kv_mask + static_cast<size_t>(b) * Nk;
  job.out = out + static_cast<size_t>(bh) * Nq * D;
  job.bh = bh;
  job.q0 = x * BQ;
  job.Nq = Nq;
  job.Nk = Nk;
  job.scale_log2 = scale_log2;
  attention_block<false>(job);
}

}  // namespace

// q (B, H, Nq, 64), k and v (B, H, Nk, 64) bf16, contiguous, 16-byte
// aligned; q_mask (B, Nq) and kv_mask (B, Nk) bool or null; out
// (B, H, Nq, 64) bf16. Every size must be positive.
extern "C" int dim_attention_bf16(int device, const void* q, const void* k,
                                  const void* v, const void* q_mask,
                                  const void* kv_mask, void* out, int B, int H,
                                  int Nq, int Nk, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int e;
  if ((e = make_map(&mq, q, Nq, B * H, BQ)) || (e = make_map(&mk, k, Nk, B * H)) ||
      (e = make_map(&mv, v, Nk, B * H)))
    return e;
  err = cudaFuncSetAttribute(attention_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B * H * ((Nq + BQ - 1) / BQ);
  attention_sm90<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<const uint8_t*>(q_mask), static_cast<const uint8_t*>(kv_mask),
      static_cast<uint16_t*>(out), H, Nq, Nk, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
