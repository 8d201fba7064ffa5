// Fused LightGlue feed-forward block:
//   out = x + W2 . GELU(LN([x | msg] . W1^T + b1) * g + beta) + b2
//
// Replaces the TPU kernel deep_image_matching_tpu/ops/pallas_ffn.py::ffn_fused
// (_ffn_kernel, mode "ln_gelu"), which streams row tiles so the (rows, 2D) f32
// intermediate never reaches device memory.
//
// What bounds it on the H100: at the main-path shape (32768 rows, D = 256)
// one call is 25.8 GFLOP of bf16 matrix products against 34 MB of
// activations and 0.8 MB of weights, so it is bound by tensor-core issue. The
// unfused form writes and re-reads the (rows, 512) f32 intermediate several
// times (LayerNorm, GELU, casts: 67 MB per pass). Here one block takes a
// 32-row tile: [x | msg] (bf16) and then the 32 x 512 f32 h tile live in
// shared memory (99 KB, dynamic), so LayerNorm statistics see the whole
// 512-wide row in one block. Eight warps run bf16 mma.sync m16n8k16 with f32
// accumulation; B fragments come straight from the L2-resident weights in
// nn.Linear (out, in) layout, where two consecutive k of one output are one
// 32-bit load. No wgmma, TMA or weight staging yet.
//
// Numerics follow the Pallas kernel: f32 accumulation, f32 LayerNorm
// statistics with eps 1e-5, exact GELU through erff (the Pallas kernel's
// Abramowitz-Stegun erf differs from it by at most 1.5e-7), the activation
// cast to bf16 before the second product, the residual added in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 256;         // model width
constexpr int D2 = 2 * D;      // hidden width and concat width
constexpr int TM = 32;         // rows per block
constexpr int LDA = D2 + 8;    // bf16 row of the [x | msg] / activation tile
constexpr int LDH = D2 + 4;    // f32 row of h
constexpr int THREADS = 256;   // 8 warps
constexpr size_t SMEM = sizeof(uint16_t) * TM * LDA + sizeof(float) * TM * LDH;

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

__device__ __forceinline__ uint32_t ldg32(const uint16_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float bf2f(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint16_t f2bf(float x) {
  __nv_bfloat16 v = __float2bfloat16_rn(x);
  return *reinterpret_cast<uint16_t*>(&v);
}

// A fragments of rows [16 mt, 16 mt + 16) and k in [16 kk, 16 kk + 16)
__device__ __forceinline__ void load_a(uint32_t a[4], const uint16_t* tile,
                                       int mt, int kk, int g, int cc) {
  const int r = mt * 16 + g, c = kk * 16 + cc;
  a[0] = ld32(&tile[r * LDA + c]);
  a[1] = ld32(&tile[(r + 8) * LDA + c]);
  a[2] = ld32(&tile[r * LDA + c + 8]);
  a[3] = ld32(&tile[(r + 8) * LDA + c + 8]);
}

__global__ void __launch_bounds__(THREADS)
ffn_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ msg,
           const uint16_t* __restrict__ w1, const uint16_t* __restrict__ b1,
           const uint16_t* __restrict__ gam, const uint16_t* __restrict__ beta,
           const uint16_t* __restrict__ w2, const uint16_t* __restrict__ b2,
           uint16_t* __restrict__ out, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem);
  float* hs = reinterpret_cast<float*>(smem + sizeof(uint16_t) * TM * LDA);

  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, cc = (lane % 4) * 2;

  // [x | msg] rows into the tile; rows past R are zero
  for (int i = tid; i < TM * (D2 / 8); i += THREADS) {
    const int r = i / (D2 / 8), c = (i % (D2 / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < R) {
      const uint16_t* src = c < D ? x + static_cast<size_t>(row0 + r) * D + c
                                  : msg + static_cast<size_t>(row0 + r) * D + (c - D);
      val = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>(&tile[r * LDA + c]) = val;
  }
  __syncthreads();

  // h = [x | msg] W1^T + b1: warp w owns h columns [64 w, 64 w + 64)
  {
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    for (int kk = 0; kk < D2 / 16; ++kk) {
      uint32_t a[2][4];
      load_a(a[0], tile, 0, kk, g, cc);
      load_a(a[1], tile, 1, kk, g, cc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint16_t* wrow = w1 + static_cast<size_t>(warp * 64 + j * 8 + g) * D2 + kk * 16 + cc;
        uint32_t bf[2] = {ldg32(wrow), ldg32(wrow + 8)};
        mma_bf16_16816(acc[0][j], a[0], bf);
        mma_bf16_16816(acc[1][j], a[1], bf);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = warp * 64 + j * 8 + cc, r = mt * 16 + g;
        const float bb0 = bf2f(b1[col]), bb1 = bf2f(b1[col + 1]);
        hs[r * LDH + col] = acc[mt][j][0] + bb0;
        hs[r * LDH + col + 1] = acc[mt][j][1] + bb1;
        hs[(r + 8) * LDH + col] = acc[mt][j][2] + bb0;
        hs[(r + 8) * LDH + col + 1] = acc[mt][j][3] + bb1;
      }
  }
  __syncthreads();

  // LayerNorm + GELU per row (warp w: rows 4w .. 4w + 3); the bf16
  // activation overwrites the input tile
  for (int rr = 0; rr < TM / 8; ++rr) {
    const int r = warp * (TM / 8) + rr;
    float vals[D2 / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < D2 / 32; ++i) {
      vals[i] = hs[r * LDH + lane + 32 * i];
      sum += vals[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum / D2;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < D2 / 32; ++i) {
      vals[i] -= mu;
      var += vals[i] * vals[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
    const float rstd = rsqrtf(var / D2 + 1e-5f);
#pragma unroll
    for (int i = 0; i < D2 / 32; ++i) {
      const int col = lane + 32 * i;
      const float hn = vals[i] * rstd * bf2f(gam[col]) + bf2f(beta[col]);
      const float act = 0.5f * hn * (1.f + erff(hn * 0.7071067811865476f));
      tile[r * LDA + col] = f2bf(act);
    }
  }
  __syncthreads();

  // out = x + act W2^T + b2: warp w owns output columns [32 w, 32 w + 32)
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  for (int kk = 0; kk < D2 / 16; ++kk) {
    uint32_t a[2][4];
    load_a(a[0], tile, 0, kk, g, cc);
    load_a(a[1], tile, 1, kk, g, cc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint16_t* wrow = w2 + static_cast<size_t>(warp * 32 + j * 8 + g) * D2 + kk * 16 + cc;
      uint32_t bf[2] = {ldg32(wrow), ldg32(wrow + 8)};
      mma_bf16_16816(acc[0][j], a[0], bf);
      mma_bf16_16816(acc[1][j], a[1], bf);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = warp * 32 + j * 8 + cc;
      const float bb0 = bf2f(b2[col]), bb1 = bf2f(b2[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + mt * 16 + g + 8 * half;
        if (row < R) {
          const uint16_t* xr = x + static_cast<size_t>(row) * D + col;
          const float o0 = bf2f(xr[0]) + (acc[mt][j][2 * half] + bb0);
          const float o1 = bf2f(xr[1]) + (acc[mt][j][2 * half + 1] + bb1);
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * D + col) =
              pack_f32(o0, o1);
        }
      }
    }
}

}  // namespace

// x, msg, out (R, 256) bf16; w1 (512, 512) and w2 (256, 512) bf16 in
// nn.Linear (out, in) layout; b1, g, beta (512,), b2 (256,) bf16.
extern "C" int dim_ffn_bf16(int device, const void* x, const void* msg,
                            const void* w1, const void* b1, const void* g,
                            const void* beta, const void* w2, const void* b2,
                            void* out, int R, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((R + TM - 1) / TM);
  ffn_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(msg),
      static_cast<const uint16_t*>(w1), static_cast<const uint16_t*>(b1),
      static_cast<const uint16_t*>(g), static_cast<const uint16_t*>(beta),
      static_cast<const uint16_t*>(w2), static_cast<const uint16_t*>(b2),
      static_cast<uint16_t*>(out), R);
  return static_cast<int>(cudaGetLastError());
}
