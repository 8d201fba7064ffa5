// One block of RoMa's ConvRefiner at the finest scale, on NHWC f32:
//   y = conv1x1(relu(dwconv5x5_same(x) + b1)) + b2
// with x, y (B, H, W, C), w1 (5, 5, 1, C) depthwise taps, b1 (C),
// w2 (1, 1, C, C) as (in, out), b2 (C). The wrapper launches it once per
// block of the stack, ping-ponging two buffers.
//
// Replaces the TPU kernel deep_image_matching_tpu/ops/pallas_refiner.py::
// refiner_dw_stack (_block_kernel, the pallas_call at :90), which lays a
// row band out as (H, C, W) so that W fills the 128 lanes, rolls lanes for
// the five x-taps and runs R small (C, C) x (C, W) MXU products per band.
// None of that carries over: on the H100 the layout stays NHWC as given.
//
// What bounds it on the H100: at the path's shapes (B = 2 images, 864^2 or
// 560^2, C = 24) one block reads and writes 286.7 MB at 864^2 (85.6 us at
// 3.35 TB/s) and does 3.51 GFLOP of f32 FMA (52 us at 67 TFLOP/s): both
// limits are close, so the design keeps the FMAs off shared-memory bank
// conflicts and reads each input byte from device memory about once.
// One thread block per tile of 8 x 32 output pixels:
//   1. the tile plus its 2-pixel halo (12 x 36 pixels x C) is staged in
//      shared memory with coalesced 16-byte loads (C % 4 == 0; 4-byte loads
//      otherwise), zeros outside the image (the 'same' padding);
//   2. depthwise 5x5: one thread per (column, channel) keeps the 25 taps in
//      registers and slides down the 12 input rows, accumulating the 8
//      output rows in registers; + b1, ReLU, into shared memory (pixel rows
//      at an odd stride, so the next phase reads them without conflicts);
//   3. the C x C mix: one thread per (pixel, 8 output channels) with the
//      1x1 weights in shared memory (the warp reads them as broadcasts);
//   4. the tile is written back through shared memory with coalesced stores,
//      the ragged edge masked.
// Everything is f32 FMA, as the TPU kernel is f32 throughout: no TF32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;          // output rows per block
constexpr int TW = 32;         // output columns per block
constexpr int HALO = 2;        // 5x5 'same' convolution
constexpr int THREADS = 256;
constexpr int G = 8;           // output channels per thread in the 1x1 mix
constexpr int MAX_C = 64;      // keeps the shared memory under 227 KB

__host__ __device__ __forceinline__ int round8(int c) { return (c + 7) / 8 * 8; }
__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) / 4 * 4; }
// odd stride of a pixel's channels in shared memory: conflict-free reads
// when the 32 lanes of a warp read 32 consecutive pixels
__host__ __device__ __forceinline__ int hstride(int c) { return c | 1; }

// shared-memory regions, in floats: staged input (reused for the output),
// the activations after the ReLU, w1, b1, w2 padded to C8 columns, b2
struct Layout {
  int xs, hs, w1s, b1s, w2s, b2s, total;
  __host__ __device__ explicit Layout(int C) {
    const int in = (TH + 2 * HALO) * (TW + 2 * HALO) * C;
    const int act = TH * TW * hstride(C);
    xs = 0;
    hs = xs + align4(in > act ? in : act);
    w1s = hs + align4(act);
    b1s = w1s + align4(25 * C);
    w2s = b1s + align4(C);
    b2s = w2s + C * round8(C);
    total = b2s + round8(C);
  }
};

__global__ void __launch_bounds__(THREADS)
refiner_block_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ y, int H,
                     int W, int C) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(C);
  float* xs = smem + L.xs;
  float* hs = smem + L.hs;
  float* w1s = smem + L.w1s;
  float* b1s = smem + L.b1s;
  float* w2s = smem + L.w2s;
  float* b2s = smem + L.b2s;
  const int C8 = round8(C), HS = hstride(C);
  const int tid = threadIdx.x;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  for (int i = tid; i < 25 * C; i += THREADS) w1s[i] = w1[i];
  for (int i = tid; i < C; i += THREADS) b1s[i] = b1[i];
  for (int i = tid; i < C * C8; i += THREADS) {
    const int ci = i / C8, co = i % C8;
    w2s[i] = co < C ? w2[ci * C + co] : 0.f;
  }
  for (int i = tid; i < C8; i += THREADS) b2s[i] = i < C ? b2[i] : 0.f;

  // 1. the input tile and its halo: tile row r is the contiguous NHWC run of
  // pixels x0 - 2 .. x0 + TW + 1 of image row y0 - 2 + r
  const float* xb = x + static_cast<size_t>(b) * H * W * C;
  const int rowlen = (TW + 2 * HALO) * C;
  if ((C & 3) == 0) {
    const int rowvec = rowlen / 4;
    for (int i = tid; i < (TH + 2 * HALO) * rowvec; i += THREADS) {
      const int r = i / rowvec, e = (i % rowvec) * 4;
      const int gy = y0 - HALO + r, gx = x0 - HALO + e / C;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const float4*>(xb + (static_cast<size_t>(gy) * W + gx) * C + e % C);
      *reinterpret_cast<float4*>(xs + r * rowlen + e) = v;
    }
  } else {
    for (int i = tid; i < (TH + 2 * HALO) * rowlen; i += THREADS) {
      const int r = i / rowlen, e = i % rowlen;
      const int gy = y0 - HALO + r, gx = x0 - HALO + e / C;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = xb[(static_cast<size_t>(gy) * W + gx) * C + e % C];
      xs[r * rowlen + e] = v;
    }
  }
  __syncthreads();

  // 2. depthwise 5x5 + b1 + ReLU; consecutive lanes take consecutive
  // channels, so their shared-memory reads are consecutive words
  for (int it = tid; it < TW * C; it += THREADS) {
    const int px = it / C, c = it % C;
    float wk[25];
#pragma unroll
    for (int t = 0; t < 25; ++t) wk[t] = w1s[t * C + c];
    float acc[TH];
#pragma unroll
    for (int r = 0; r < TH; ++r) acc[r] = b1s[c];
#pragma unroll
    for (int rr = 0; rr < TH + 2 * HALO; ++rr) {
      float v[5];
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) v[dx] = xs[rr * rowlen + (px + dx) * C + c];
      // input row rr feeds output rows rr - dy
#pragma unroll
      for (int dy = 0; dy < 5; ++dy) {
        const int r = rr - dy;
        if (r >= 0 && r < TH) {
#pragma unroll
          for (int dx = 0; dx < 5; ++dx) acc[r] = fmaf(wk[dy * 5 + dx], v[dx], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TH; ++r) hs[(r * TW + px) * HS + c] = fmaxf(acc[r], 0.f);
  }
  __syncthreads();

  // 3. the 1x1 mix into the staging area (the input tile is consumed)
  float* os = xs;
  for (int it = tid; it < TH * TW * (C8 / G); it += THREADS) {
    const int p = it % (TH * TW), g = it / (TH * TW);
    const float4 ba = *reinterpret_cast<const float4*>(b2s + g * G);
    const float4 bb = *reinterpret_cast<const float4*>(b2s + g * G + 4);
    float acc[G] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
    const float* hp = hs + p * HS;
    const float* wp = w2s + g * G;
    for (int ci = 0; ci < C; ++ci) {
      const float h = hp[ci];
      const float4 wa = *reinterpret_cast<const float4*>(wp + ci * C8);
      const float4 wb = *reinterpret_cast<const float4*>(wp + ci * C8 + 4);
      acc[0] = fmaf(h, wa.x, acc[0]);
      acc[1] = fmaf(h, wa.y, acc[1]);
      acc[2] = fmaf(h, wa.z, acc[2]);
      acc[3] = fmaf(h, wa.w, acc[3]);
      acc[4] = fmaf(h, wb.x, acc[4]);
      acc[5] = fmaf(h, wb.y, acc[5]);
      acc[6] = fmaf(h, wb.z, acc[6]);
      acc[7] = fmaf(h, wb.w, acc[7]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (g * G + j < C) os[p * HS + g * G + j] = acc[j];
  }
  __syncthreads();

  // 4. coalesced stores of the tile's rows, masked at the ragged edge
  float* yb = y + static_cast<size_t>(b) * H * W * C;
  const int outrow = TW * C;
  for (int i = tid; i < TH * outrow; i += THREADS) {
    const int r = i / outrow, e = i % outrow, px = e / C, c = e % C;
    const int gy = y0 + r, gx = x0 + px;
    if (gy < H && gx < W)
      yb[(static_cast<size_t>(gy) * W + gx) * C + c] = os[(r * TW + px) * HS + c];
  }
}

}  // namespace

// One refiner block. x, y (B, H, W, C) f32 contiguous, x 16-byte aligned;
// w1 (25, C), b1 (C), w2 (C, C) as (in, out), b2 (C) f32 contiguous;
// 1 <= C <= 64. Returns the CUDA error of the launch (0 on success).
extern "C" int dim_refiner_block(int device, const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* y, int B, int H,
                                 int W, int C, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C < 1 || C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(Layout(C).total) * sizeof(float);
  err = cudaFuncSetAttribute(refiner_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  refiner_block_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(y), H, W, C);
  return static_cast<int>(cudaGetLastError());
}
