// Row and column statistics of a similarity product in one pass over it,
// for LightGlue's dual-softmax assignment without the (B, M, N) score matrix.
//
// Replaces the TPU kernels of deep_image_matching_tpu/ops/pallas_assignment.py
// (_lse_dot_kernel and _argmax_dot_kernel through _sweep, called four times by
// assignment_fused, twice per direction). With s_ij = scale * a_i . b_j, one
// pass computes, for every row i of a (B, M, Dm) and column j of b (B, N, Dm),
//   mode 0: row_i = logsumexp_j (s_ij + col_bias_j),
//           col_j = logsumexp_i (s_ij + row_bias_i);
//   mode 1: the max and the FIRST argmax of the same two families.
//
// What bounds it on the H100: at the main-path shape (B = 16, M = N = 2048,
// Dm = 256, f32) one pass is 34 GFLOP of f32 FMA against 67 MB of operands,
// bound by FMA issue; the dense form writes and re-reads a 268 MB score
// matrix several times. The TPU kernels streamed one direction per sweep and
// carried running statistics across a sequential grid axis, so the product
// was computed four times. Here one block per (128-row tile, batch) loops
// over all 128-column tiles itself: the row statistics run in registers, and
// each tile's column statistics over the block's rows go to a small partial
// buffer (B, M/128, N) that a second kernel combines in row-tile order. Two
// passes instead of four, each thread an 8 x 8 register tile fed by float4
// loads from 16-deep k-chunks in shared memory. Inputs stay f32, as the
// Pallas kernel takes them: an argmax over bf16 or TF32 products would drift
// from the dense f32 result. No tensor cores yet.
//
// Argmax ties keep the first index, as jnp.argmax and the Pallas kernel's
// strict '>' over an initial -1e30 do: inside a thread indices ascend with
// strict '>', across threads and row tiles the lower index wins a tie, and
// the running maxima start at -1e30. Masked entries carry a -1e30 bias.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 128;         // rows per block, columns per tile
constexpr int KC = 16;         // k-chunk staged in shared memory
constexpr int LDS = T + 4;     // padded shared-memory row (floats)
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr float NEG = -1e30f;
constexpr int NO_INDEX = 0x7fffffff;

// this thread's i-th row (or column) of a 128-wide tile: two groups of 4
__device__ __forceinline__ int sub(int t, int i) { return (i >> 2) * 64 + t * 4 + (i & 3); }

template <bool ARGMAX>
__global__ void __launch_bounds__(THREADS)
dual_pass_kernel(const float* __restrict__ a, const float* __restrict__ bm,
                 const float* __restrict__ row_bias, const float* __restrict__ col_bias,
                 float* __restrict__ row_val, int* __restrict__ row_arg,
                 float* __restrict__ part_val, float* __restrict__ part_sum,
                 int* __restrict__ part_arg, int M, int N, int Dm, float scale) {
  __shared__ __align__(16) float as[KC][LDS];
  __shared__ __align__(16) float bs[KC][LDS];
  __shared__ float red_v[16][T];
  __shared__ float red_s[16][T];
  __shared__ int red_a[16][T];

  const int b = blockIdx.y, rt = blockIdx.x, RT = gridDim.x;
  const int row0 = rt * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* ab = a + static_cast<size_t>(b) * M * Dm;
  const float* bb = bm + static_cast<size_t>(b) * N * Dm;

  float rbias[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = row0 + sub(ty, r);
    rbias[r] = i < M ? row_bias[static_cast<size_t>(b) * M + i] : -INFINITY;
  }
  float run_max[8], run_sum[8];
  int run_arg[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    run_max[r] = NEG;
    run_sum[r] = 0.f;
    run_arg[r] = 0;
  }

  for (int c0 = 0; c0 < N; c0 += T) {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < Dm; k0 += KC) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < T * KC / 4; i += THREADS) {
        const int r = i / (KC / 4), q = (i % (KC / 4)) * 4;
        float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
        if (row0 + r < M)
          va = *reinterpret_cast<const float4*>(ab + static_cast<size_t>(row0 + r) * Dm + k0 + q);
        if (c0 + r < N)
          vb = *reinterpret_cast<const float4*>(bb + static_cast<size_t>(c0 + r) * Dm + k0 + q);
        as[q][r] = va.x; as[q + 1][r] = va.y; as[q + 2][r] = va.z; as[q + 3][r] = va.w;
        bs[q][r] = vb.x; bs[q + 1][r] = vb.y; bs[q + 2][r] = vb.z; bs[q + 3][r] = vb.w;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
        const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
      }
    }

    float cbias[8];
    bool cvalid[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = c0 + sub(tx, c);
      cvalid[c] = j < N;
      cbias[c] = cvalid[c] ? col_bias[static_cast<size_t>(b) * N + j] : 0.f;
    }

    // row statistics over this tile's columns (16 threads share a row)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = cvalid[c] ? acc[r][c] * scale + cbias[c] : -INFINITY;
      if (ARGMAX) {
        float best = -INFINITY;
        int arg = NO_INDEX;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (v[c] > best) {
            best = v[c];
            arg = c0 + sub(tx, c);
          }
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, o);
          const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
          if (ob > best || (ob == best && oa < arg)) {
            best = ob;
            arg = oa;
          }
        }
        if (best > run_max[r]) {
          run_max[r] = best;
          run_arg[r] = arg;
        }
      } else {
        float tmax = v[0];
#pragma unroll
        for (int c = 1; c < 8; ++c) tmax = fmaxf(tmax, v[c]);
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        const float m_new = fmaxf(run_max[r], tmax);
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) s += expf(v[c] - m_new);
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        run_sum[r] = run_sum[r] * expf(run_max[r] - m_new) + s;
        run_max[r] = m_new;
      }
    }

    // column statistics over this block's rows: per thread, then across
    // the 16 thread rows through shared memory
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float u[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) u[r] = acc[r][c] * scale + rbias[r];
      const int col = sub(tx, c);
      if (ARGMAX) {
        float best = -INFINITY;
        int arg = NO_INDEX;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (u[r] > best) {
            best = u[r];
            arg = row0 + sub(ty, r);
          }
        red_v[ty][col] = best;
        red_a[ty][col] = arg;
      } else {
        float m = u[0];
#pragma unroll
        for (int r = 1; r < 8; ++r) m = fmaxf(m, u[r]);
        float s = 0.f;
        if (m != -INFINITY) {
#pragma unroll
          for (int r = 0; r < 8; ++r) s += expf(u[r] - m);
        }
        red_v[ty][col] = m;
        red_s[ty][col] = s;
      }
    }
    __syncthreads();
    if (tid < T && c0 + tid < N) {
      const size_t o = (static_cast<size_t>(b) * RT + rt) * N + c0 + tid;
      if (ARGMAX) {
        float best = -INFINITY;
        int arg = NO_INDEX;
        for (int t = 0; t < 16; ++t) {
          const float v = red_v[t][tid];
          const int ai = red_a[t][tid];
          if (v > best || (v == best && ai < arg)) {
            best = v;
            arg = ai;
          }
        }
        part_val[o] = best;
        part_arg[o] = arg;
      } else {
        float m = -INFINITY;
        for (int t = 0; t < 16; ++t) m = fmaxf(m, red_v[t][tid]);
        float s = 0.f;
        for (int t = 0; t < 16; ++t)
          if (red_v[t][tid] != -INFINITY) s += red_s[t][tid] * expf(red_v[t][tid] - m);
        part_val[o] = m;
        part_sum[o] = s;
      }
    }
    // the next chunk loop's first __syncthreads orders these reads before
    // the next tile's writes to red_*
  }

  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = row0 + sub(ty, r);
      if (i < M) {
        const size_t o = static_cast<size_t>(b) * M + i;
        if (ARGMAX) {
          row_val[o] = run_max[r];
          row_arg[o] = run_arg[r];
        } else {
          row_val[o] = run_max[r] + logf(fmaxf(run_sum[r], 1e-38f));
        }
      }
    }
  }
}

// combine the column partials of the RT row tiles, in row-tile order
template <bool ARGMAX>
__global__ void combine_cols_kernel(const float* __restrict__ part_val,
                                    const float* __restrict__ part_sum,
                                    const int* __restrict__ part_arg,
                                    float* __restrict__ col_val, int* __restrict__ col_arg,
                                    int B, int RT, int N) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * N) return;
  const int b = idx / N, j = idx % N;
  const size_t base = static_cast<size_t>(b) * RT * N + j;
  if (ARGMAX) {
    float best = NEG;
    int arg = 0;
    for (int k = 0; k < RT; ++k) {
      const float v = part_val[base + static_cast<size_t>(k) * N];
      if (v > best) {
        best = v;
        arg = part_arg[base + static_cast<size_t>(k) * N];
      }
    }
    col_val[idx] = best;
    col_arg[idx] = arg;
  } else {
    float m = NEG;
    for (int k = 0; k < RT; ++k) m = fmaxf(m, part_val[base + static_cast<size_t>(k) * N]);
    float s = 0.f;
    for (int k = 0; k < RT; ++k) {
      const size_t o = base + static_cast<size_t>(k) * N;
      s += part_sum[o] * expf(part_val[o] - m);
    }
    col_val[idx] = m + logf(fmaxf(s, 1e-38f));
  }
}

}  // namespace

// a (B, M, Dm), bm (B, N, Dm) f32 with Dm % 16 == 0 and 16-byte aligned
// rows; row_bias (B, M), col_bias (B, N); outputs row_val (B, M) and
// col_val (B, N) f32, row_arg / col_arg int32 (argmax only); scratch
// part_val (B, ceil(M/128), N) f32 and part_aux of the same shape (f32
// sums, or int32 indices for argmax). All contiguous.
extern "C" int dim_assignment_pass(int device, const void* a, const void* bm,
                                   const void* row_bias, const void* col_bias,
                                   void* row_val, void* row_arg, void* col_val,
                                   void* col_arg, void* part_val, void* part_aux,
                                   int B, int M, int N, int Dm, float scale,
                                   int argmax, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int RT = (M + T - 1) / T;
  const dim3 grid(RT, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B * N + 255) / 256;
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(bm);
  const float* rbias = static_cast<const float*>(row_bias);
  const float* cbias = static_cast<const float*>(col_bias);
  if (argmax) {
    dual_pass_kernel<true><<<grid, THREADS, 0, s>>>(
        fa, fb, rbias, cbias, static_cast<float*>(row_val), static_cast<int*>(row_arg),
        static_cast<float*>(part_val), nullptr, static_cast<int*>(part_aux), M, N, Dm, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    combine_cols_kernel<true><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(part_val), nullptr, static_cast<const int*>(part_aux),
        static_cast<float*>(col_val), static_cast<int*>(col_arg), B, RT, N);
  } else {
    dual_pass_kernel<false><<<grid, THREADS, 0, s>>>(
        fa, fb, rbias, cbias, static_cast<float*>(row_val), nullptr,
        static_cast<float*>(part_val), static_cast<float*>(part_aux), nullptr, M, N, Dm, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    combine_cols_kernel<false><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(part_val), static_cast<const float*>(part_aux), nullptr,
        static_cast<float*>(col_val), nullptr, B, RT, N);
  }
  return static_cast<int>(cudaGetLastError());
}
