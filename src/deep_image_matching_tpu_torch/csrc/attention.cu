// Masked multi-head attention with an online softmax, for LightGlue's self
// and cross attention.
//
// Replaces the TPU kernel reached by
// deep_image_matching_tpu/ops/attention.py::fused_attention (the bundled
// Pallas flash-attention kernel, padding expressed as segment ids).
//
// What bounds it on the H100: at the main-path shape (q, k, v of
// (16, 4, 2048, 64) bf16) one call is 69 GFLOP against 50 MB of operands, so
// it is bound by tensor-core issue, not by memory. The dense form would also
// write and re-read a (B, H, Nq, Nk) f32 score tensor (1 GB per call). This
// kernel keeps each 64x64 score tile in registers: one block per
// (64-query tile, head, batch), four warps of 16 query rows each, a loop over
// 64-key tiles staged in shared memory, bf16 mma.sync m16n8k16 for both
// products with f32 accumulation, and the FlashAttention-2 register reuse of
// the probabilities as the A operand of the second product. No wgmma, TMA or
// double buffering yet.
//
// Semantics follow xla_attention (the JAX package's dense reference): scores
// are scaled, masked keys get -1e30 (so a query whose keys are all masked
// averages every key uniformly), keys past Nk contribute nothing. Query tiles
// whose queries are all masked are written as zeros and skipped; other rows
// of masked queries are computed like valid rows. Callers read valid rows
// only (their values are undefined in the JAX package too).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;       // head dim
constexpr int BQ = 64;      // query rows per block, 16 per warp
constexpr int BK = 64;      // keys per tile
constexpr int LD = D + 8;   // padded shared-memory row, in bf16 elements
constexpr int THREADS = 128;
constexpr float MASKED = -1e30f;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 bit patterns: lo in bits 0-15 (lower column / k index), hi above
__device__ __forceinline__ uint32_t pack16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS)
attention_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v,
                 const uint8_t* __restrict__ q_mask,
                 const uint8_t* __restrict__ kv_mask,
                 uint16_t* __restrict__ out, int H, int Nq, int Nk,
                 float scale) {
  __shared__ __align__(16) uint16_t sq[BQ * LD];
  __shared__ __align__(16) uint16_t sk[BK * LD];
  __shared__ __align__(16) uint16_t sv[BK * LD];
  __shared__ int skey[BK];  // 0 valid, 1 masked, 2 past Nk
  __shared__ int s_any;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const uint16_t* qb = q + bh * Nq * D;
  const uint16_t* kb = k + bh * Nk * D;
  const uint16_t* vb = v + bh * Nk * D;
  uint16_t* ob = out + bh * Nq * D;

  if (q_mask != nullptr) {
    if (tid == 0) s_any = 0;
    __syncthreads();
    if (tid < BQ && q0 + tid < Nq &&
        q_mask[static_cast<size_t>(b) * Nq + q0 + tid])
      s_any = 1;
    __syncthreads();
    if (!s_any) {
      for (int i = tid; i < BQ * D / 8; i += THREADS) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        if (q0 + r < Nq)
          *reinterpret_cast<uint4*>(ob + static_cast<size_t>(q0 + r) * D + c) =
              make_uint4(0, 0, 0, 0);
      }
      return;
    }
  }

  for (int i = tid; i < BQ * D / 8; i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Nq)
      val = *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(&sq[r * LD + c]) = val;
  }
  __syncthreads();

  const int g = lane / 4;         // fragment row (and B-fragment column)
  const int cc = (lane % 4) * 2;  // fragment column pair
  const int r0 = warp * 16 + g;   // this thread's rows: r0 and r0 + 8

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = ld32(&sq[r0 * LD + kk * 16 + cc]);
    qa[kk][1] = ld32(&sq[(r0 + 8) * LD + kk * 16 + cc]);
    qa[kk][2] = ld32(&sq[r0 * LD + kk * 16 + cc + 8]);
    qa[kk][3] = ld32(&sq[(r0 + 8) * LD + kk * 16 + cc + 8]);
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * D / 8; i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Nk) {
        kv = *reinterpret_cast<const uint4*>(kb + static_cast<size_t>(k0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(vb + static_cast<size_t>(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(&sk[r * LD + c]) = kv;
      *reinterpret_cast<uint4*>(&sv[r * LD + c]) = vv;
    }
    if (tid < BK) {
      const int j = k0 + tid;
      skey[tid] = j >= Nk ? 2
                  : (kv_mask == nullptr || kv_mask[static_cast<size_t>(b) * Nk + j]) ? 0
                                                                                     : 1;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const int key = j * 8 + g;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bf[2];
        bf[0] = ld32(&sk[key * LD + kk * 16 + cc]);
        bf[1] = ld32(&sk[key * LD + kk * 16 + cc + 8]);
        mma_bf16_16816(s[j], qa[kk], bf);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int code = skey[j * 8 + cc + (e & 1)];
        const float val = code == 0 ? s[j][e] * scale : (code == 1 ? MASKED : -INFINITY);
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: the tile holds a key < Nk
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V, P reused from the S accumulators as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + cc;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int dim = j * 8 + g;
        uint32_t bf[2];
        bf[0] = pack16(sv[key * LD + dim], sv[(key + 1) * LD + dim]);
        bf[1] = pack16(sv[(key + 8) * LD + dim], sv[(key + 9) * LD + dim]);
        mma_bf16_16816(acc[j], pa, bf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / l[r];
  }
  const int row0 = q0 + r0, row1 = q0 + r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int dim = j * 8 + cc;
    if (row0 < Nq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row0) * D + dim) =
          pack_f32(acc[j][0] * l[0], acc[j][1] * l[0]);
    if (row1 < Nq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row1) * D + dim) =
          pack_f32(acc[j][2] * l[1], acc[j][3] * l[1]);
  }
}

}  // namespace

// q (B, H, Nq, 64), k and v (B, H, Nk, 64) bf16, contiguous; q_mask (B, Nq)
// and kv_mask (B, Nk) bool or null; out (B, H, Nq, 64) bf16.
extern "C" int dim_attention_bf16(int device, const void* q, const void* k,
                                  const void* v, const void* q_mask,
                                  const void* kv_mask, void* out, int B, int H,
                                  int Nq, int Nk, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Nq + BQ - 1) / BQ, H, B);
  attention_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint8_t*>(q_mask),
      static_cast<const uint8_t*>(kv_mask), static_cast<uint16_t*>(out), H, Nq,
      Nk, scale);
  return static_cast<int>(cudaGetLastError());
}
