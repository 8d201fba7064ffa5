// Masked multi-head attention with an online softmax, for LightGlue's self
// and cross attention, SuperGlue's attention, DINOv2 (head dim 64) and
// LighterGlue's attention (one head of width 96) (kernel 1).
//
// Replaces the TPU kernel reached by
// deep_image_matching_tpu/ops/attention.py::fused_attention (the bundled
// Pallas flash-attention kernel, padding expressed as segment ids), in its
// four forms: bf16 and float32, each at head dims 64 and 96.
//
// What bounds it on the H100: at the main-path shape (q, k, v of
// (16, 4, 2048, 64) bf16) one call is 69 GFLOP against 50 MB of operands, so
// it is bound by tensor-core issue, not by memory; at LighterGlue's
// (16, 1, 4096, 96) one call is 103 GFLOP (before masks) against 50 MB, again
// operations. The dense form would also write and re-read a (B, H, Nq, Nk)
// f32 score tensor (1 GB per call at 4096). The block body is the wgmma / TMA
// core of attention_sm90.cuh: 192 query rows per block (three consumer
// warpgroups of 64), key tiles fed by TMA into a shared-memory ring, both
// products on wgmma, the score tiles kept in registers. Each K / V tile is
// read from L2 once per 192 query rows: an earlier head-dim-96 form on
// warp-level mma.sync took 64 rows a block, so each (batch, head)'s K and V
// crossed L2 64 times a call at 4096 queries (~1.6 GB in bf16) where 192-row
// blocks read them 22 times, its four warps each read every tile from shared
// memory, and it visited every key tile; it reached 15 % of its operations
// bound.
//
// Semantics follow xla_attention (the JAX package's dense reference): scores
// are scaled, masked keys get -1e30 (so a query whose keys are all masked
// averages every key uniformly), keys past Nk contribute nothing. Query tiles
// whose queries are all masked are written as zeros and skipped; other rows
// of masked queries are computed like valid rows. Callers read valid rows
// only (their values are undefined in the JAX package too).
//
// The float32 forms (dim_attention_f32, dim_attention_hd96_f32, for
// tpu.dtype: float32) compute the same function with every product in split
// TF32, on the core of attention_f32_sm90.cuh: one launch on the raw f32
// operands, which each block splits into TF32 halves itself (Q into
// registers, K and the transposed V into shared memory), with S of a key
// tile issued beside P V of the one before.
//
// Head dim 96 (dim_attention_hd96_bf16, dim_attention_hd96_f32) is the same
// cores at D = 96: in bf16 each row is three 64-byte swizzled TMA boxes of 32
// columns (a 192-byte row is three 64-byte swizzle atoms), with 64-key tiles so
// that O's 48 accumulator registers fit beside S and P, and P V one m64n96k16
// a k-step; in float32 three 32-float boxes a row and 32-key tiles, since
// 64-key K and V^T slots in hi and lo beside the raw tiles and the 48 KB Q
// tile would not fit in shared memory.

#include "attention_f32_sm90.cuh"
#include "attention_sm90.cuh"

namespace {

using namespace attn_sm90;

// one block of kernel 1 at head dim D: its (batch x head, row tile) and the
// masks and output of that batch element
template <int D>
__device__ __forceinline__ void attention_job(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                              const CUtensorMap& vmap, const uint8_t* q_mask,
                                              const uint8_t* kv_mask, uint16_t* out, int H,
                                              int Nq, int Nk, float scale_log2) {
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
  attention_block<D, false>(job);
}

__global__ void __launch_bounds__(THREADS, 1)
attention_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ q_mask,
               const uint8_t* __restrict__ kv_mask, uint16_t* __restrict__ out, int H, int Nq,
               int Nk, float scale_log2) {
  attention_job<64>(qmap, kmap, vmap, q_mask, kv_mask, out, H, Nq, Nk, scale_log2);
}

__global__ void __launch_bounds__(THREADS, 1)
attention_hd96_sm90(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ q_mask,
                    const uint8_t* __restrict__ kv_mask, uint16_t* __restrict__ out, int H,
                    int Nq, int Nk, float scale_log2) {
  attention_job<96>(qmap, kmap, vmap, q_mask, kv_mask, out, H, Nq, Nk, scale_log2);
}

// the float32 forms: raw f32 operands, split in the block (attention_f32_sm90.cuh)
template <int D>
__device__ __forceinline__ void attention_f32_job(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                                  const CUtensorMap& vmap, const uint8_t* q_mask,
                                                  const uint8_t* kv_mask, float* out, int H,
                                                  int Nq, int Nk, float scale_log2) {
  const int tiles = (Nq + attn_f32::BQ - 1) / attn_f32::BQ;
  int bh, x;
  attn_f32::block_tile(blockIdx.x, gridDim.x / tiles, tiles, bh, x);
  const int b = bh / H;
  attn_f32::Job job;
  job.qmap = &qmap;
  job.kmap = &kmap;
  job.vmap = &vmap;
  job.qmask = q_mask == nullptr ? nullptr : q_mask + static_cast<size_t>(b) * Nq;
  job.kmask = kv_mask == nullptr ? nullptr : kv_mask + static_cast<size_t>(b) * Nk;
  job.out = out + static_cast<size_t>(bh) * Nq * D;
  job.bh = bh;
  job.q0 = x * attn_f32::BQ;
  job.Nq = Nq;
  job.Nk = Nk;
  job.scale_log2 = scale_log2;
  attn_f32::attention_block<D, false>(job);
}

__global__ void __launch_bounds__(attn_f32::THREADS, 1)
attention_f32_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const uint8_t* __restrict__ q_mask, const uint8_t* __restrict__ kv_mask,
                   float* __restrict__ out, int H, int Nq, int Nk, float scale_log2) {
  attention_f32_job<64>(qmap, kmap, vmap, q_mask, kv_mask, out, H, Nq, Nk, scale_log2);
}

__global__ void __launch_bounds__(attn_f32::THREADS, 1)
attention_hd96_f32_sm90(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const uint8_t* __restrict__ q_mask, const uint8_t* __restrict__ kv_mask,
                        float* __restrict__ out, int H, int Nq, int Nk, float scale_log2) {
  attention_f32_job<96>(qmap, kmap, vmap, q_mask, kv_mask, out, H, Nq, Nk, scale_log2);
}

typedef void (*Bf16Kernel)(CUtensorMap, CUtensorMap, CUtensorMap, const uint8_t*,
                           const uint8_t*, uint16_t*, int, int, int, float);
typedef void (*F32Kernel)(CUtensorMap, CUtensorMap, CUtensorMap, const uint8_t*,
                          const uint8_t*, float*, int, int, int, float);

// the bf16 form at head dim D: tensor maps, then the launch
template <int D>
int launch_bf16(Bf16Kernel kernel, int device, const void* q, const void* k, const void* v,
                const void* q_mask, const void* kv_mask, void* out, int B, int H, int Nq,
                int Nk, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int e;
  if ((e = make_map<D>(&mq, q, Nq, B * H, BQ)) || (e = make_map<D>(&mk, k, Nk, B * H)) ||
      (e = make_map<D>(&mv, v, Nk, B * H)))
    return e;
  constexpr int smem = Smem<D>::SMEM_BYTES;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B * H * ((Nq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<const uint8_t*>(q_mask), static_cast<const uint8_t*>(kv_mask),
      static_cast<uint16_t*>(out), H, Nq, Nk, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// the float32 form at head dim D: tensor maps of the raw operands, then the
// launch
template <int D>
int launch_f32(F32Kernel kernel, int device, const void* q, const void* k, const void* v,
               const void* q_mask, const void* kv_mask, void* out, int B, int H, int Nq,
               int Nk, float scale, void* stream) {
  namespace af = attn_f32;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int BH = B * H;
  CUtensorMap mq, mk, mv;
  int e;
  if ((e = af::make_row_map<D>(&mq, q, Nq, BH, 64)) ||
      (e = af::make_row_map<D>(&mk, k, Nk, BH, af::Geo<D>::BK)) ||
      (e = af::make_v_map<D>(&mv, v, Nk, BH)))
    return e;
  constexpr int smem = af::Smem<D>::SMEM_BYTES;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = BH * ((Nq + af::BQ - 1) / af::BQ);
  kernel<<<grid, af::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<const uint8_t*>(q_mask), static_cast<const uint8_t*>(kv_mask),
      static_cast<float*>(out), H, Nq, Nk, scale * af::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Nq, 64), k and v (B, H, Nk, 64) bf16, contiguous, 16-byte
// aligned; q_mask (B, Nq) and kv_mask (B, Nk) bool or null; out
// (B, H, Nq, 64) bf16. Every size must be positive.
extern "C" int dim_attention_bf16(int device, const void* q, const void* k,
                                  const void* v, const void* q_mask,
                                  const void* kv_mask, void* out, int B, int H,
                                  int Nq, int Nk, float scale, void* stream) {
  return launch_bf16<64>(attention_sm90, device, q, k, v, q_mask, kv_mask, out, B, H, Nq, Nk,
                         scale, stream);
}

// The float32 form: q (B, H, Nq, 64), k and v (B, H, Nk, 64) f32, contiguous,
// 16-byte aligned; masks as for dim_attention_bf16; out (B, H, Nq, 64) f32.
// Every size must be positive.
extern "C" int dim_attention_f32(int device, const void* q, const void* k, const void* v,
                                 const void* q_mask, const void* kv_mask, void* out, int B,
                                 int H, int Nq, int Nk, float scale, void* stream) {
  return launch_f32<64>(attention_f32_sm90, device, q, k, v, q_mask, kv_mask, out, B, H, Nq, Nk,
                        scale, stream);
}

// Head dim 96: q (B, H, Nq, 96), k and v (B, H, Nk, 96) bf16, contiguous,
// 16-byte aligned; masks as for dim_attention_bf16; out (B, H, Nq, 96) bf16.
extern "C" int dim_attention_hd96_bf16(int device, const void* q, const void* k, const void* v,
                                       const void* q_mask, const void* kv_mask, void* out, int B,
                                       int H, int Nq, int Nk, float scale, void* stream) {
  return launch_bf16<96>(attention_hd96_sm90, device, q, k, v, q_mask, kv_mask, out, B, H, Nq,
                         Nk, scale, stream);
}

// Head dim 96 in float32 (split TF32): as dim_attention_f32 with 96 for 64.
extern "C" int dim_attention_hd96_f32(int device, const void* q, const void* k, const void* v,
                                      const void* q_mask, const void* kv_mask, void* out, int B,
                                      int H, int Nq, int Nk, float scale, void* stream) {
  return launch_f32<96>(attention_hd96_f32_sm90, device, q, k, v, q_mask, kv_mask, out, B, H, Nq,
                        Nk, scale, stream);
}
