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
// 4097) z is 1.07 GB and one iteration takes two exponentials per entry, so
// it is bound by reading z from device memory (0.32 ms at 3.35 TB/s), with
// the accurate expf's instruction issue close behind. The Pallas kernel walks
// row strips in order and carries per-column running (max, sum) across them;
// blocks on the H100 run in no order. So each block owns a contiguous run of
// rows of one batch and folds them into per-column (max, sum) accumulators;
// each block writes its accumulators to a (B, G, N) partial buffer, G blocks
// per batch, and a second small kernel combines them in block order into
// v_new. The design keeps z streaming at the HBM rate:
//
// - A ring of z stages in shared memory, each RS = 2 rows (1 for wide
//   rows), as many stages as fit (7 at N = 4097, at most 8). One producer
//   lane keeps them filled with 1-D bulk copies (cp.async.bulk, completion
//   on a full mbarrier per stage); sixteen consumer warps work on the two
//   oldest stages and release each on an empty mbarrier. A chunk of rows is one contiguous run of
//   rows * N floats whose start is not 16-byte aligned when N % 4 != 0: the
//   stage holds z from the aligned-down start, the aligned middle arrives by
//   the bulk copy, and the few head and tail floats by 4-byte cp.async
//   copies whose completion is the stage's second arrival (so the producer
//   never waits on a load).
// - One read of each element per pass, each with one exponential. Consumer
//   thread t owns columns t + 512 k in both passes, so v and the column
//   (max, sum) accumulators stay in registers, in a few instantiated column
//   counts (rows wider than 10240 keep the accumulators in the block's slice
//   of the partial buffer in global memory instead). The row pass keeps an online
//   (max, sum) per row of the chunk: exp(-|x - m|) either adds to the sum or
//   rescales it. The column fold is online in the same way, so it takes one
//   exponential per element and no separate rescale.
// - One barrier per chunk. The rows' sums are merged across the warp and
//   then, through shared memory, across the 16 warps. Chunk c's row pass
//   runs in one basic block with chunk c - 1's u step and column fold, so
//   the merge's latency hides under independent work.
// - What remains is instruction issue: the accurate expf and the online
//   update take ~14 instructions per element and pass, two passes where
//   kernel 8 (one pass, 84 % of the byte bound) takes one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr float NEG = -1e30f;
constexpr int CONSUMERS = 512;            // 16 consumer warps
constexpr int CWARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 32;   // + one producer warp
constexpr int MAX_STAGES = 8;
// the most columns a consumer thread owns: ptxas caps the 544-thread block
// at 96 registers a thread, and wider instantiations spill
constexpr int MAX_KC = 20;
// the instantiated column counts: exact for the N = 2^p + 1 of SuperGlue's
// 2^p keypoints and its dustbin (p = 9..13), the rest rounded up to the next
constexpr int KC_BUCKETS[] = {2, 3, 5, 9, 17, MAX_KC};
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;  // full[MAX_STAGES], empty[MAX_STAGES]

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

// online (max, sum) of exp: one exponential per value; exp(-|x - m|) adds to
// the sum, or rescales it when x raises the maximum; x = -inf changes
// nothing (m is finite or -1e30 where it is folded)
__device__ __forceinline__ void online(float x, float& m, float& s) {
  const float e = expf(-fabsf(x - m));
  s = x > m ? fmaf(s, e, 1.f) : s + e;
  m = fmaxf(m, x);
}

// 4-byte asynchronous copy global -> shared
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have landed
// (.noinc: the arrival is one of those the barrier expects)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// the first element of chunk row c0 (of batch b) in ring stage `stage`: a
// stage holds z from its chunk's 16-byte aligned-down start
__device__ __forceinline__ const float* chunk_ptr(const float* ring, int stage, int stage_floats,
                                                  int b, int M, int N, int c0) {
  const long long start = (static_cast<long long>(b) * M + c0) * N;
  return ring + static_cast<size_t>(stage) * stage_floats + (start & 3LL);
}

// A consumer thread's columns j = tid + 512 k, k < KC: their v and their
// column (max, sum) accumulators, in registers. KC is an instantiated
// bucket (KC_BUCKETS) at least ceil(N / 512). Columns k < KC - 1 past N
// have v = -inf, so the row pass folds in nothing for them; their reads
// stay inside the stage, whose slack past its rows is zeroed (finite), and
// their accumulators are never written. Column KC - 1 runs only where it
// exists (`last`).
template <int KC>
struct Cols {
  float v[KC], m[KC], s[KC];
  bool last;

  __device__ __forceinline__ void init(const float* vb, float*, float*, int N, int tid) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int j = tid + k * CONSUMERS;
      v[k] = j < N ? vb[j] : -INFINITY;
      m[k] = NEG;
      s[k] = 0.f;
    }
    last = tid + (KC - 1) * CONSUMERS < N;
  }

  // the row pass of one chunk over columns [K0, K1): an online (max, sum) of
  // z + v for each of its (at most two) rows; a missing second row folds in
  // -inf
  template <int K0, int K1>
  __device__ __forceinline__ void row_cols(const float* zs, int rows, int N, int tid, float& m0,
                                           float& s0, float& m1, float& s1) const {
    const float* z1 = zs + (rows > 1 ? N : 0);
#pragma unroll
    for (int k = K0; k < K1; ++k) {
      const int j = tid + k * CONSUMERS;
      online(zs[j] + v[k], m0, s0);
      online(rows > 1 ? z1[j] + v[k] : -INFINITY, m1, s1);
    }
  }

  // the column fold of one chunk over columns [K0, K1): exp(z + u_new) into
  // the running (max, sum); a missing second row folds in -inf, which
  // leaves them as they are
  template <int K0, int K1>
  __device__ __forceinline__ void fold_cols(const float* zs, int rows, int N, float u0, float u1,
                                            int tid) {
    const float* z1 = zs + (rows > 1 ? N : 0);
#pragma unroll
    for (int k = K0; k < K1; ++k) {
      const int j = tid + k * CONSUMERS;
      online(zs[j] + u0, m[k], s[k]);
      online(rows > 1 ? z1[j] + u1 : -INFINITY, m[k], s[k]);
    }
  }

  __device__ __forceinline__ void row_pass(const float* zs, int rows, int N, int tid, float& m0,
                                           float& s0, float& m1, float& s1) const {
    row_cols<0, KC - 1>(zs, rows, N, tid, m0, s0, m1, s1);
    if (last) row_cols<KC - 1, KC>(zs, rows, N, tid, m0, s0, m1, s1);
  }

  __device__ __forceinline__ void fold(const float* zs, int rows, int N, float u0, float u1,
                                       int tid) {
    fold_cols<0, KC - 1>(zs, rows, N, u0, u1, tid);
    if (last) fold_cols<KC - 1, KC>(zs, rows, N, u0, u1, tid);
  }

  // the accumulators into the block's slice of the partials
  __device__ __forceinline__ void store(float* pmax, float* psum, int N, int tid) const {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int j = tid + k * CONSUMERS;
      if (j < N) {
        pmax[j] = m[k];
        psum[j] = s[k];
      }
    }
  }
};

// Rows wider than MAX_KC * 512: v is read from global memory, and the
// accumulators live in the block's slice of the partials, each column read
// and written by the one thread that owns it.
template <>
struct Cols<0> {
  const float* v;
  float *m, *s;

  __device__ __forceinline__ void init(const float* vb, float* pmax, float* psum, int N,
                                       int tid) {
    v = vb;
    m = pmax;
    s = psum;
    for (int j = tid; j < N; j += CONSUMERS) {
      m[j] = NEG;
      s[j] = 0.f;
    }
  }

  __device__ __forceinline__ void row_pass(const float* zs, int rows, int N, int tid, float& m0,
                                           float& s0, float& m1, float& s1) const {
    const float* z1 = zs + (rows > 1 ? N : 0);
    for (int j = tid; j < N; j += CONSUMERS) {
      const float vj = __ldg(v + j);
      online(zs[j] + vj, m0, s0);
      online(rows > 1 ? z1[j] + vj : -INFINITY, m1, s1);
    }
  }

  __device__ __forceinline__ void fold(const float* zs, int rows, int N, float u0, float u1,
                                       int tid) {
    const float* z1 = zs + (rows > 1 ? N : 0);
    for (int j = tid; j < N; j += CONSUMERS) {
      float cm = m[j], cs = s[j];
      online(zs[j] + u0, cm, cs);
      online(rows > 1 ? z1[j] + u1 : -INFINITY, cm, cs);
      m[j] = cm;
      s[j] = cs;
    }
  }

  __device__ __forceinline__ void store(float*, float*, int, int) const {}
};

// The warp's row partials of a chunk into slot `par` of the partial buffers
// ([2 parities][2 rows][CWARPS]), then the barrier that publishes them. A
// warp reads a chunk's partials before it reaches the next chunk's barrier,
// so two parities suffice.
__device__ __forceinline__ void publish(float* pm, float* ps, int par, int warp, int lane,
                                        float m0, float s0, float m1, float s1) {
  const float mw0 = warp_max(m0), mw1 = warp_max(m1);
  s0 = warp_sum(s0 > 0.f ? s0 * expf(m0 - mw0) : 0.f);
  s1 = warp_sum(s1 > 0.f ? s1 * expf(m1 - mw1) : 0.f);
  if (lane == 0) {
    const int i = par * 2 * CWARPS + warp;
    pm[i] = mw0;
    ps[i] = s0;
    pm[i + CWARPS] = mw1;
    ps[i + CWARPS] = s1;
  }
  consumers_sync();
}

// u of a chunk's rows from the CWARPS partials of each: lanes 0-15 reduce
// row 0, lanes 16-31 row 1; u_new = max(log_mu - lse, -1e30), written to
// u_out (the chunk's first row) by warp 0 and returned in u0, u1 to every
// lane. lmu: log_mu of this lane's row.
__device__ __forceinline__ void u_step(const float* pm, const float* ps, int par, int lane,
                                       int warp, float lmu, int rows, float* u_out, float& u0,
                                       float& u1) {
  const int rl = lane >> 4;
  const int i = par * 2 * CWARPS + rl * CWARPS + (lane & 15);
  const float pmx = pm[i], psx = ps[i];
  float mr = pmx;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, o));
  float sr = psx > 0.f ? psx * expf(pmx - mr) : 0.f;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) sr += __shfl_xor_sync(0xffffffffu, sr, o);
  const float ul = fmaxf(lmu - (mr + logf(fmaxf(sr, 1e-38f))), NEG);
  if (warp == 0 && (lane & 15) == 0 && rl < rows) u_out[rl] = ul;
  u0 = __shfl_sync(0xffffffffu, ul, 0);
  u1 = __shfl_sync(0xffffffffu, ul, 16);
}

// kernel 7, pass 1. Grid (G, B); block g owns rows [g * rpb, (g + 1) * rpb)
// of batch b, walked in chunks of RS rows through `stages` ring stages of
// stage_floats floats each. KC: columns per consumer thread (`Cols`).
template <int KC>
__global__ void __launch_bounds__(THREADS, 1)
sinkhorn_iter_kernel(const float* __restrict__ z, const float* __restrict__ v,
                     const float* __restrict__ log_mu, float* __restrict__ u_out,
                     float* __restrict__ part_max, float* __restrict__ part_sum,
                     int M, int N, int rpb, int RS, int stages, int stage_floats) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw + BAR_BYTES);
  float* pm = ring + static_cast<size_t>(stages) * stage_floats;  // [2][2][CWARPS] row maxima
  float* ps = pm + 4 * CWARPS;  // [2][2][CWARPS] and sums, by chunk parity, row, warp
  const uint32_t full0 = smem_u32(smem_raw), empty0 = full0 + 8 * MAX_STAGES;

  const int b = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r_begin = g * rpb, r_end = min(M, r_begin + rpb);
  const int nchunks = r_end > r_begin ? (r_end - r_begin + RS - 1) / RS : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 2);          // the producer: bulk copy, head and tail
      mbar_init(empty0 + 8 * s, CWARPS);    // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  if (KC > 0 && (KC - 1) * CONSUMERS > N) {
    // columns past N read the stage's slack: zero it (and the rest of the
    // ring) before the first copy, so those reads are finite
    for (int i = tid; i < stages * stage_floats; i += THREADS) ring[i] = 0.f;
    fence_proxy_async();
  }
  __syncthreads();

  if (warp == CWARPS) {
    // ---------------- producer: one lane fills the ring -------------------
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int c = 0; c < nchunks; ++c) {
        const int c0 = r_begin + c * RS, rows = min(RS, r_end - c0);
        const long long start = (static_cast<long long>(b) * M + c0) * N;
        const long long end = start + static_cast<long long>(rows) * N;
        const long long a0 = start & ~3LL;                // stage position 0
        const long long a = min((start + 3) & ~3LL, end);  // the aligned middle [a, e)
        const long long e = max(end & ~3LL, a);
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        fence_proxy_async();  // the stage's earlier head and tail writes before the bulk copy
        float* dst = ring + static_cast<size_t>(stage) * stage_floats;
        const uint32_t full = full0 + 8 * stage;
        const uint32_t bytes = static_cast<uint32_t>((e - a) * 4);
        if (bytes) {
          mbar_arrive_tx(full, bytes);
          bulk_load(smem_u32(dst + (a - a0)), z + a, bytes, full);
        } else {
          mbar_arrive(full);
        }
        // the head and tail floats (fewer than 4 each), asynchronously: the
        // stage's second arrival comes when they have landed
        for (long long i = start; i < a; ++i) cp_async4(smem_u32(dst + (i - a0)), z + i);
        for (long long i = e; i < end; ++i) cp_async4(smem_u32(dst + (i - a0)), z + i);
        cp_async_arrive(full);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------------------------------------
  // Thread tid owns columns j = tid + 512 k in both passes (`Cols`). In the
  // steady state, chunk c's row pass runs in one basic block with chunk
  // c - 1's u step and column fold, which need the row sums of chunk c - 1
  // from every warp; one barrier per chunk publishes them.
  const size_t slice = (static_cast<size_t>(b) * G + g) * N;
  Cols<KC> cols;
  cols.init(v + static_cast<size_t>(b) * N, part_max + slice, part_sum + slice, N, tid);
  const int rl = lane >> 4;  // the row of the chunk whose u this lane computes
  float lmu = 0.f;
  // row maxima start below any value (z + v >= -2e30 here), so they end as
  // the plain version's unclamped maxima
  constexpr float ROW_INIT = -3.0e38f;
  if (nchunks > 0) {
    const int rows = min(RS, r_end - r_begin);
    const float* zs = chunk_ptr(ring, 0, stage_floats, b, M, N, r_begin);
    lmu = rl < rows ? log_mu[static_cast<size_t>(b) * M + r_begin + rl] : 0.f;
    float m0 = ROW_INIT, s0 = 0.f, m1 = ROW_INIT, s1 = 0.f;
    mbar_wait(full0, 0);
    cols.row_pass(zs, rows, N, tid, m0, s0, m1, s1);
    publish(pm, ps, 0, warp, lane, m0, s0, m1, s1);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int c = 1; c < nchunks; ++c) {
    const int pc0 = r_begin + (c - 1) * RS, prows = min(RS, r_end - pc0);
    const int c0 = pc0 + RS, rows = min(RS, r_end - c0);
    const float* pz = chunk_ptr(ring, stage, stage_floats, b, M, N, pc0);
    const int pstage = stage;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
    const float* zs = chunk_ptr(ring, stage, stage_floats, b, M, N, c0);
    const float lmu_next = rl < rows ? log_mu[static_cast<size_t>(b) * M + c0 + rl] : 0.f;
    mbar_wait(full0 + 8 * stage, phase);
    float u0, u1;
    u_step(pm, ps, (c - 1) & 1, lane, warp, lmu, prows, u_out + static_cast<size_t>(b) * M + pc0,
           u0, u1);
    float m0 = ROW_INIT, s0 = 0.f, m1 = ROW_INIT, s1 = 0.f;
    cols.row_pass(zs, rows, N, tid, m0, s0, m1, s1);
    cols.fold(pz, prows, N, u0, u1, tid);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * pstage);
    publish(pm, ps, c & 1, warp, lane, m0, s0, m1, s1);
    lmu = lmu_next;
  }
  if (nchunks > 0) {
    const int pc0 = r_begin + (nchunks - 1) * RS, prows = min(RS, r_end - pc0);
    const float* pz = chunk_ptr(ring, stage, stage_floats, b, M, N, pc0);
    float u0, u1;
    u_step(pm, ps, (nchunks - 1) & 1, lane, warp, lmu, prows,
           u_out + static_cast<size_t>(b) * M + pc0, u0, u1);
    cols.fold(pz, prows, N, u0, u1, tid);
  }
  cols.store(part_max + slice, part_sum + slice, N, tid);
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

// the instantiation for KC columns per consumer thread
template <int KC>
int launch_iter(const float* z, const float* v, const float* log_mu, float* u_out,
                float* part_max, float* part_sum, int B, int M, int N, int G, int rpb, int RS,
                int stages, int stage_floats, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_iter_kernel<KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_iter_kernel<KC><<<dim3(G, B), THREADS, smem, s>>>(
      z, v, log_mu, u_out, part_max, part_sum, M, N, rpb, RS, stages, stage_floats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One iteration of kernel 7. z (B, M, N) f32, 16-byte aligned; v (B, N),
// log_mu (B, M), log_nu (B, N) f32; outputs u_out (B, M), v_out (B, N);
// scratch part_max, part_sum (B, G, N). G blocks per batch, each owning
// ceil(M / G) rows. All contiguous; v_out must not alias v. Returns
// cudaErrorInvalidValue when two one-row stages do not fit in shared memory
// (N above ~28900 on the H100).
extern "C" int dim_sinkhorn_iteration(int device, const void* z, const void* v,
                                      const void* log_mu, const void* log_nu,
                                      void* u_out, void* v_out, void* part_max,
                                      void* part_sum, int B, int M, int N, int G,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int smem_max[64] = {0};
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem_max[device] == 0) {
    err = cudaDeviceGetAttribute(&smem_max[device], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (N < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the smallest bucket of at least ceil(N / 512) columns a thread, else the
  // wide form (KC = 0)
  const int kc = (N + CONSUMERS - 1) / CONSUMERS;
  int KC = 0;
  for (const int kb : KC_BUCKETS) {
    if (kb >= kc) {
      KC = kb;
      break;
    }
  }
  // a row's columns k < KC - 1 are read without a bound check
  const int reach = KC > 0 ? (KC - 1) * CONSUMERS : 0;
  const int rpb = (M + G - 1) / G;
  // the ring: two-row stages while at least three fit, else one-row stages
  const long long fixed = BAR_BYTES + 4LL * 8 * CWARPS;
  int RS = 2, stages = 0, stage_floats = 0;
  for (; RS >= 1; --RS) {
    // a chunk starts up to 3 floats past its aligned-down start
    const int span = RS * N > (RS - 1) * N + reach ? RS * N : (RS - 1) * N + reach;
    stage_floats = (span + 3 + 3) & ~3;
    const long long fit = (smem_max[device] - fixed) / (4LL * stage_floats);
    stages = static_cast<int>(fit < MAX_STAGES ? fit : MAX_STAGES);
    if (stages >= 3 || (RS == 1 && stages >= 2)) break;
  }
  if (RS < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(fixed) + 4ull * stages * stage_floats;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  const float* vf = static_cast<const float*>(v);
  const float* mu = static_cast<const float*>(log_mu);
  float* uo = static_cast<float*>(u_out);
  float* pmx = static_cast<float*>(part_max);
  float* psm = static_cast<float*>(part_sum);
#define DIM_SINKHORN_LAUNCH(K)                                                                 \
  case K:                                                                                      \
    rc = launch_iter<K>(zf, vf, mu, uo, pmx, psm, B, M, N, G, rpb, RS, stages, stage_floats,   \
                        smem, s);                                                              \
    break;
  int rc = static_cast<int>(cudaErrorInvalidValue);
  switch (KC) {
    DIM_SINKHORN_LAUNCH(0) DIM_SINKHORN_LAUNCH(2) DIM_SINKHORN_LAUNCH(3) DIM_SINKHORN_LAUNCH(5)
    DIM_SINKHORN_LAUNCH(9) DIM_SINKHORN_LAUNCH(17) DIM_SINKHORN_LAUNCH(MAX_KC)
  }
#undef DIM_SINKHORN_LAUNCH
  if (rc != 0) return rc;
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
