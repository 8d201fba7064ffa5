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
//
// The float32 form (dim_attention_f32, for tpu.dtype: float32) computes the
// same function with every product in split TF32, on the core of
// attention_f32_sm90.cuh.

#include "attention_f32_sm90.cuh"
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

// the float32 form: the split operands of attention_f32_sm90.cuh
__global__ void __launch_bounds__(attn_f32::THREADS, 1)
attention_f32_sm90(const __grid_constant__ CUtensorMap qhi,
                   const __grid_constant__ CUtensorMap qlo,
                   const __grid_constant__ CUtensorMap khi,
                   const __grid_constant__ CUtensorMap klo,
                   const __grid_constant__ CUtensorMap vhi,
                   const __grid_constant__ CUtensorMap vlo,
                   const uint8_t* __restrict__ q_mask, const uint8_t* __restrict__ kv_mask,
                   float* __restrict__ out, int H, int Nq, int Nk, float scale_log2) {
  const int tiles = (Nq + attn_f32::BQ - 1) / attn_f32::BQ;
  int bh, x;
  attn_f32::block_tile(blockIdx.x, gridDim.x / tiles, tiles, bh, x);
  const int b = bh / H;
  attn_f32::Job job;
  job.qhi = &qhi;
  job.qlo = &qlo;
  job.khi = &khi;
  job.klo = &klo;
  job.vhi = &vhi;
  job.vlo = &vlo;
  job.qmask = q_mask == nullptr ? nullptr : q_mask + static_cast<size_t>(b) * Nq;
  job.kmask = kv_mask == nullptr ? nullptr : kv_mask + static_cast<size_t>(b) * Nk;
  job.out = out + static_cast<size_t>(bh) * Nq * attn_f32::D;
  job.bh = bh;
  job.q0 = x * attn_f32::BQ;
  job.Nq = Nq;
  job.Nk = Nk;
  job.scale_log2 = scale_log2;
  attn_f32::attention_block<false>(job);
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

// The float32 form: q (B, H, Nq, 64), k and v (B, H, Nk, 64) f32, contiguous,
// 16-byte aligned; masks as for dim_attention_bf16; out (B, H, Nq, 64) f32.
// Scratch, f32: q_split (2, B, H, Nq, 64) and k_split (2, B, H, Nk, 64) for
// the TF32 halves, v_split (2, B H, 64, Np) for V's transposed halves, Np =
// Nk rounded up to 8. Every size must be positive.
extern "C" int dim_attention_f32(int device, const void* q, const void* k, const void* v,
                                 const void* q_mask, const void* kv_mask, void* out,
                                 void* q_split, void* k_split, void* v_split, int B, int H,
                                 int Nq, int Nk, float scale, void* stream) {
  namespace af = attn_f32;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  float* qs = static_cast<float*>(q_split);
  float* ks = static_cast<float*>(k_split);
  float* vs = static_cast<float*>(v_split);
  const int64_t nq = static_cast<int64_t>(BH) * Nq * af::D;
  const int64_t nk = static_cast<int64_t>(BH) * Nk * af::D;
  int e;
  if ((e = af::split_rows(static_cast<const float*>(q), qs, nq, st)) ||
      (e = af::split_rows(static_cast<const float*>(k), ks, nk, st)) ||
      (e = af::split_vt(static_cast<const float*>(v), vs, BH, Nk, st)))
    return e;
  CUtensorMap mqh, mql, mkh, mkl, mvh, mvl;
  if ((e = af::make_row_maps(&mqh, &mql, qs, Nq, BH)) ||
      (e = af::make_row_maps(&mkh, &mkl, ks, Nk, BH)) ||
      (e = af::make_vt_maps(&mvh, &mvl, vs, Nk, BH)))
    return e;
  err = cudaFuncSetAttribute(attention_f32_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             af::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = BH * ((Nq + af::BQ - 1) / af::BQ);
  attention_f32_sm90<<<grid, af::THREADS, af::SMEM_BYTES, st>>>(
      mqh, mql, mkh, mkl, mvh, mvl, static_cast<const uint8_t*>(q_mask),
      static_cast<const uint8_t*>(kv_mask), static_cast<float*>(out), H, Nq, Nk,
      scale * af::LOG2E);
  return static_cast<int>(cudaGetLastError());
}
