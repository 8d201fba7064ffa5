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
// 168 MB (x 34 MB, cos and sin 34 MB, the three outputs 101 MB) against 26
// GFLOP of bf16 products, so it is bound by memory. The unfused form writes
// and re-reads the (rows, 768) projection and each rotary operand. Here one
// block takes 64 rows: x in shared memory, the weight (section-contiguous
// rows [q | k | v], each ordered (head, hd), in nn.Linear (out, in) layout,
// permuted once at model load) read from L2, one section at a time on bf16
// mma.sync m16n8k16 with f32 accumulators (8 warps x 32 columns). In the
// accumulator layout each thread holds an adjacent column pair (2i, 2i+1),
// so rotate_half is a register swap with a negation. Each section's 64 x 256
// bf16 tile is staged in shared memory and written with 16-byte stores
// straight into the (B, H, N, 64) head layout the attention kernels take.
//
// Numerics follow the Pallas kernel: f32 accumulation, the bias added in f32
// before rounding, the rotary multiply-add in bf16 arithmetic (each product
// rounded to bf16, then their sum).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 256;        // model width (one section)
constexpr int HD = 64;        // head dim
constexpr int TM = 64;        // rows per block
constexpr int LDX = D + 8;    // bf16 row of the staged tiles
constexpr int THREADS = 256;  // 8 warps, 32 columns each
constexpr size_t SMEM = 2 * sizeof(uint16_t) * TM * LDX;

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

__device__ __forceinline__ float round_bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS)
qkv_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
           const uint16_t* __restrict__ bias, const float* __restrict__ cosv,
           const float* __restrict__ sinv, uint16_t* __restrict__ out0,
           uint16_t* __restrict__ out1, uint16_t* __restrict__ out2, int R, int N,
           int sections, int rot_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* ys = xs + TM * LDX;

  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, cc = (lane % 4) * 2;

  for (int i = tid; i < TM * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < R)
      val = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(&xs[r * LDX + c]) = val;
  }
  __syncthreads();

  uint16_t* outs[3] = {out0, out1, out2};
  for (int sec = 0; sec < sections; ++sec) {
    const bool rot = (rot_mask >> sec) & 1;
    // this warp's columns of the section: [32 warp, 32 warp + 32)
    float acc[TM / 16][4][4];
#pragma unroll
    for (int mt = 0; mt < TM / 16; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    const uint16_t* wsec = w + static_cast<size_t>(sec) * D * D;
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint16_t* wrow = wsec + static_cast<size_t>(warp * 32 + j * 8 + g) * D + kk * 16 + cc;
        bf[j][0] = ldg32(wrow);
        bf[j][1] = ldg32(wrow + 8);
      }
#pragma unroll
      for (int mt = 0; mt < TM / 16; ++mt) {
        const int r = mt * 16 + g, c = kk * 16 + cc;
        uint32_t a[4];
        a[0] = ld32(&xs[r * LDX + c]);
        a[1] = ld32(&xs[(r + 8) * LDX + c]);
        a[2] = ld32(&xs[r * LDX + c + 8]);
        a[3] = ld32(&xs[(r + 8) * LDX + c + 8]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[mt][j], a, bf[j]);
      }
    }
    // epilogue: bias in f32, round, rotary on the column pair, stage in bf16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = warp * 32 + j * 8 + cc;  // even: the pair (col, col + 1)
      const float b0 = bf2f(bias[sec * D + col]), b1 = bf2f(bias[sec * D + col + 1]);
      const int d = col % HD;
#pragma unroll
      for (int mt = 0; mt < TM / 16; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + 8 * half;
          const float y0 = acc[mt][j][2 * half] + b0;
          const float y1 = acc[mt][j][2 * half + 1] + b1;
          float o0 = y0, o1 = y1;
          if (rot && row0 + r < R) {
            const float2 c2 = __ldg(reinterpret_cast<const float2*>(
                cosv + static_cast<size_t>(row0 + r) * HD + d));
            const float2 s2 = __ldg(reinterpret_cast<const float2*>(
                sinv + static_cast<size_t>(row0 + r) * HD + d));
            // bf16 arithmetic: each product rounded, then the sum (rounded
            // when packed)
            const float t0 = round_bf(y0), t1 = round_bf(y1);
            o0 = round_bf(t0 * round_bf(c2.x)) + round_bf(-t1 * round_bf(s2.x));
            o1 = round_bf(t1 * round_bf(c2.y)) + round_bf(t0 * round_bf(s2.y));
          }
          *reinterpret_cast<uint32_t*>(&ys[r * LDX + col]) = pack_f32(o0, o1);
        }
      }
    }
    __syncthreads();
    // (row, head) runs of 64 bf16 (128 bytes) into the (B, H, N, 64) layout
    uint16_t* o = outs[sec];
    for (int i = tid; i < TM * (D / 8); i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const int row = row0 + r;
      if (row < R) {
        const int bb = row / N, n = row % N, h = c / HD;
        const size_t dst = ((static_cast<size_t>(bb) * (D / HD) + h) * N + n) * HD + c % HD;
        *reinterpret_cast<uint4*>(o + dst) = *reinterpret_cast<const uint4*>(&ys[r * LDX + c]);
      }
    }
    __syncthreads();  // the staged tile is read before the next section
  }
}

}  // namespace

// x (B N, 256) bf16; w (S 256, 256) bf16, rows section-contiguous, nn.Linear
// (out, in) layout; bias (S 256,) bf16; cos, sin (B N, 64) f32 (may be null
// when rot_mask is 0); out0..out{S-1} (B, 4, N, 64) bf16 (unused ones null).
// sections is 2 or 3; bit s of rot_mask applies the rotary to section s.
extern "C" int dim_qkv_rotary_bf16(int device, const void* x, const void* w,
                                   const void* bias, const void* cosv, const void* sinv,
                                   void* out0, void* out1, void* out2, int R, int N,
                                   int sections, int rot_mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sections < 1 || sections > 3 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((R + TM - 1) / TM);
  qkv_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<const uint16_t*>(bias), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), static_cast<uint16_t*>(out0),
      static_cast<uint16_t*>(out1), static_cast<uint16_t*>(out2), R, N, sections,
      rot_mask);
  return static_cast<int>(cudaGetLastError());
}
