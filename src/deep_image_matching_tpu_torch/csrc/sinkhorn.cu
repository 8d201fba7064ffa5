// Log-space Sinkhorn for SuperGlue's optimal transport.
//
// Replaces two TPU kernels of deep_image_matching_tpu/ops/pallas_sinkhorn.py:
// - kernel 7, sinkhorn_iteration (_iter_kernel): one Gauss-Seidel iteration
//     u_i = max(log_mu_i - lse_j(z_ij + v_j), -1e30)
//     v_j = max(log_nu_j - lse_i(z_ij + u_i), -1e30)   (with the NEW u)
//   in one read of z (B, M, N) f32;
// - kernel 8, logsumexp_rows (_row_kernel): u_i = log_mu_i - lse_j(z_ij + v_j),
//   no clamp, the running maximum starting at -1e30.
// Every lse is m + log(max(s, 1e-38)) with accurate expf/logf (no fast-math
// intrinsics), so the -1e30 arithmetic of padded and masked entries comes
// out as on the TPU.
//
// What bounds kernel 7 on the H100: at the main-path shape (B = 16, M = N =
// 4097) z is 1.07 GB and one iteration does two exponentials per entry, so
// it is bound by reading z from device memory (0.32 ms at 3.35 TB/s) and
// close to it by expf issue. The Pallas kernel walks row strips in order
// and carries per-column running (max, sum) across them; blocks on the H100
// run in no order. So each block owns a contiguous run of rows of one batch
// and keeps per-column (max, sum) accumulators over its rows in shared
// memory. It walks its rows in chunks that fit in shared memory: a chunk is
// copied in once with cp.async, every row's u comes from the old v (one warp
// per row), and the chunk's exp(z + u_new) folds into the column
// accumulators; z is read once per iteration. Each block then writes its
// accumulators to a (B, G, N) partial buffer, G blocks per batch (a few per
// batch, enough to fill the card), and a second small kernel combines them
// in block order into v_new.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// kernel 7, pass 1. Grid (G, B); block g owns rows [g * rpb, (g + 1) * rpb)
// and walks them in chunks of R rows. Shared memory: the chunk (R x N), the
// chunk's u (R), the column accumulators (2 x N).
__global__ void __launch_bounds__(THREADS)
sinkhorn_iter_kernel(const float* __restrict__ z, const float* __restrict__ v,
                     const float* __restrict__ log_mu, float* __restrict__ u_out,
                     float* __restrict__ part_max, float* __restrict__ part_sum,
                     int M, int N, int rpb, int R) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                                 // R * N
  float* cmax = smem + static_cast<size_t>(R) * N;  // N
  float* csum = cmax + N;                           // N
  float* us = csum + N;                             // R

  const int b = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r_begin = g * rpb, r_end = min(M, r_begin + rpb);
  const float* vb = v + static_cast<size_t>(b) * N;

  for (int j = tid; j < N; j += THREADS) {
    cmax[j] = NEG;
    csum[j] = 0.f;
  }

  for (int c0 = r_begin; c0 < r_end; c0 += R) {
    const int rows = min(R, r_end - c0);
    // the chunk's rows are one contiguous run of rows * N floats
    const float* zc = z + (static_cast<size_t>(b) * M + c0) * N;
    const int total = rows * N;
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < total; i += THREADS) cp_async4(zs + i, zc + i);
    cp_async_wait_all();
    __syncthreads();

    // rows: u_i from the old v, one warp per row
    for (int r = warp; r < rows; r += WARPS) {
      const float* zr = zs + static_cast<size_t>(r) * N;
      float m = -INFINITY;
      for (int j = lane; j < N; j += 32) m = fmaxf(m, zr[j] + __ldg(vb + j));
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < N; j += 32) s += expf(zr[j] + __ldg(vb + j) - m);
      s = warp_sum(s);
      const float lse = m + logf(fmaxf(s, 1e-38f));
      const size_t o = static_cast<size_t>(b) * M + c0 + r;
      const float un = fmaxf(log_mu[o] - lse, NEG);
      if (lane == 0) {
        us[r] = un;
        u_out[o] = un;
      }
    }
    __syncthreads();

    // columns: fold the chunk's exp(z + u_new) into the running (max, sum)
    for (int j = tid; j < N; j += THREADS) {
      float tmax = -INFINITY;
      for (int r = 0; r < rows; ++r) tmax = fmaxf(tmax, zs[static_cast<size_t>(r) * N + j] + us[r]);
      const float m_old = cmax[j];
      const float m_new = fmaxf(m_old, tmax);
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += expf(zs[static_cast<size_t>(r) * N + j] + us[r] - m_new);
      csum[j] = csum[j] * expf(m_old - m_new) + s;
      cmax[j] = m_new;
    }
  }
  __syncthreads();
  for (int j = tid; j < N; j += THREADS) {
    const size_t o = (static_cast<size_t>(b) * G + g) * N + j;
    part_max[o] = cmax[j];
    part_sum[o] = csum[j];
  }
}

// kernel 7, pass 2: v_j = max(log_nu_j - lse, -1e30) from the G partials
__global__ void sinkhorn_cols_kernel(const float* __restrict__ part_max,
                                     const float* __restrict__ part_sum,
                                     const float* __restrict__ log_nu,
                                     float* __restrict__ v_out, int B, int G, int N) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * N) return;
  const int b = idx / N, j = idx % N;
  const size_t base = static_cast<size_t>(b) * G * N + j;
  float m = NEG;
  for (int k = 0; k < G; ++k) m = fmaxf(m, part_max[base + static_cast<size_t>(k) * N]);
  float s = 0.f;
  for (int k = 0; k < G; ++k) {
    const size_t o = base + static_cast<size_t>(k) * N;
    s += part_sum[o] * expf(part_max[o] - m);
  }
  const float lse = m + logf(fmaxf(s, 1e-38f));
  v_out[idx] = fmaxf(log_nu[idx] - lse, NEG);
}

// kernel 8: one warp per row, each lane an online (max, sum) over its
// columns, merged across the warp
__global__ void __launch_bounds__(256)
lse_rows_kernel(const float* __restrict__ z, const float* __restrict__ v,
                const float* __restrict__ log_mu, float* __restrict__ u_out, int M, int N) {
  const int b = blockIdx.y;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* zr = z + (static_cast<size_t>(b) * M + row) * N;
  const float* vb = v + static_cast<size_t>(b) * N;
  float m = NEG, s = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float x = zr[j] + vb[j];
    if (x > m) {
      s = s * expf(m - x) + 1.f;
      m = x;
    } else {
      s += expf(x - m);
    }
  }
  const float mw = warp_max(m);
  s = warp_sum(s * expf(m - mw));
  if (lane == 0) {
    const size_t o = static_cast<size_t>(b) * M + row;
    u_out[o] = log_mu[o] - (mw + logf(fmaxf(s, 1e-38f)));
  }
}

}  // namespace

// One iteration of kernel 7. z (B, M, N), v (B, N), log_mu (B, M),
// log_nu (B, N) f32; outputs u_out (B, M), v_out (B, N); scratch part_max,
// part_sum (B, G, N). G blocks per batch, each owning ceil(M / G) rows,
// walked in chunks of as many rows (at most 32) as fit in shared memory
// beside the column accumulators. All contiguous; v_out must not alias v.
// Returns cudaErrorInvalidValue when not one row of width N fits.
extern "C" int dim_sinkhorn_iteration(int device, const void* z, const void* v,
                                      const void* log_mu, const void* log_nu,
                                      void* u_out, void* v_out, void* part_max,
                                      void* part_sum, int B, int M, int N, int G,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rpb = (M + G - 1) / G;
  const long long fixed = 2LL * N, per_row = static_cast<long long>(N) + 1;
  long long fit = (smem_max / static_cast<long long>(sizeof(float)) - fixed) / per_row;
  if (fit > 32) fit = 32;
  if (fit > rpb) fit = rpb;
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int R = static_cast<int>(fit);
  const size_t smem = sizeof(float) * (static_cast<size_t>(R) * per_row + fixed);
  err = cudaFuncSetAttribute(sinkhorn_iter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sinkhorn_iter_kernel<<<dim3(G, B), THREADS, smem, s>>>(
      static_cast<const float*>(z), static_cast<const float*>(v),
      static_cast<const float*>(log_mu), static_cast<float*>(u_out),
      static_cast<float*>(part_max), static_cast<float*>(part_sum), M, N, rpb, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_cols_kernel<<<(B * N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_max), static_cast<const float*>(part_sum),
      static_cast<const float*>(log_nu), static_cast<float*>(v_out), B, G, N);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 8. z (B, M, N), v (B, N), log_mu (B, M) f32 -> u_out (B, M).
extern "C" int dim_lse_rows(int device, const void* z, const void* v, const void* log_mu,
                            void* u_out, int B, int M, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_rows_kernel<<<dim3((M + 7) / 8, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(v),
      static_cast<const float*>(log_mu), static_cast<float*>(u_out), M, N);
  return static_cast<int>(cudaGetLastError());
}
