// Null vector of each 8x9 epipolar constraint system, one thread per RANSAC
// hypothesis, by an unrolled Householder QR of A^T.
//
// Replaces the TPU kernel deep_image_matching_tpu/ops/pallas_nullspace.py::
// nullspace_planes (_nullspace_kernel), which lays the hypothesis axis over
// vector lanes and the 72 matrix entries over unrolled planes.
//
// What bounds it on the H100: per hypothesis ~1.3k flops on 288 bytes in and
// 36 bytes out, so a launch of 32768 hypotheses moves 10.6 MB and is bound by
// latency and register pressure rather than by bandwidth or FMA rate. The
// same plane layout (9, 8, N) makes every load and store coalesced across
// threads (thread n reads entry (c, r) of hypothesis n at c * 8 * N + r * N
// + n). The 72 entries, the 8 pivot components of the reflectors and their
// betas live in registers: the reflector components below each pivot are the
// column entries that later steps never touch, so they are read in place
// and the kernel stays well under the 255-register limit without spilling
// (the build's ptxas report, build/torch_kernels/ptxas.log, shows it).
//
// The arithmetic is the Pallas kernel's, step for step: the rank-deficiency
// guard neg_tol = 1e-11 * ||A||_F^2 + 1e-30 skips a reflection whose column
// is already eliminated, and vtv is formed from the tail sum (not
// nrm2 - x0^2 + v0^2, which cancels when the pivot dominates), so the
// pure-translation case f33 = 0 stays solved. The result is the last column
// of the complete QR of A^T (sign arbitrary).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
nullspace_kernel(const float* __restrict__ a9, float* __restrict__ f, int N) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;

  float X[9][8];  // X[row][col] of A^T
#pragma unroll
  for (int c = 0; c < 9; ++c)
#pragma unroll
    for (int r = 0; r < 8; ++r)
      X[c][r] = a9[(static_cast<size_t>(c) * 8 + r) * N + n];

  float total2 = X[0][0] * X[0][0];
#pragma unroll
  for (int c = 0; c < 9; ++c)
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (c || r) total2 = total2 + X[c][r] * X[c][r];
  const float neg_tol = total2 * 1e-11f + 1e-30f;

  float vk[8];    // pivot component of reflector k; the rest is X[r][k], r > k
  float beta[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float x0 = X[k][k];
    float tail2 = X[k + 1][k] * X[k + 1][k];
#pragma unroll
    for (int r = k + 2; r < 9; ++r) tail2 = tail2 + X[r][k] * X[r][k];
    const float nrm2 = tail2 + x0 * x0;
    const float alpha = -(x0 >= 0.f ? 1.f : -1.f) * sqrtf(nrm2);
    const float v0 = x0 - alpha;
    const float vtv = tail2 + v0 * v0;
    const float bk = nrm2 > neg_tol ? 2.f / fmaxf(vtv, neg_tol) : 0.f;
#pragma unroll
    for (int j = k + 1; j < 8; ++j) {
      float w = v0 * X[k][j];
#pragma unroll
      for (int r = k + 1; r < 9; ++r) w = w + X[r][k] * X[r][j];
      w = w * bk;
      X[k][j] = X[k][j] - v0 * w;
#pragma unroll
      for (int r = k + 1; r < 9; ++r) X[r][j] = X[r][j] - X[r][k] * w;
    }
    vk[k] = v0;
    beta[k] = bk;
  }

  // q = H_1 ... H_8 e_9 spans null(A)
  float q[9];
#pragma unroll
  for (int r = 0; r < 8; ++r) q[r] = 0.f;
  q[8] = 1.f;
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    float w = vk[k] * q[k];
#pragma unroll
    for (int r = k + 1; r < 9; ++r) w = w + X[r][k] * q[r];
    w = w * beta[k];
    q[k] = q[k] - vk[k] * w;
#pragma unroll
    for (int r = k + 1; r < 9; ++r) q[r] = q[r] - X[r][k] * w;
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) f[static_cast<size_t>(c) * N + n] = q[c];
}

}  // namespace

// a9 (9, 8, N) f32 planes: entry (c, r, n) is A_n[r, c]; f (9, N) f32.
extern "C" int dim_nullspace_8x9(int device, const void* a9, void* f, int N,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + THREADS - 1) / THREADS);
  nullspace_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a9), static_cast<float*>(f), N);
  return static_cast<int>(cudaGetLastError());
}
