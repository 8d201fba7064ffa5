// Bidirectional shared-score cross attention, LightGlue's cross block in one
// launch:
//   S  = qk0 . qk1^T * d^-1/2 + bias1 (columns) + bias0 (rows)
//   m0 = softmax_rows(S) . v1,   m1 = softmax_rows(S^T) . v0
// where a masked token's bias is -1e30 (so a masked row against a masked
// column scores -2e30).
//
// Replaces the TPU kernel
// deep_image_matching_tpu/ops/pallas_bidir_attention.py::bidir_cross_attention
// (_kernel), which computes each S tile once and carries direction 1's
// online-softmax state across a sequential grid axis.
//
// What bounds it on the H100: at LightGlue's shape ((16, 4, 2048, 64) bf16
// per side) one call is 6 M N d FLOP per (batch, head), 206 GFLOP against
// 67 MB of operands, so it is bound by tensor-core issue. Blocks run in no
// order here, so nothing is carried between them: one launch with grid
// (row tiles of side 0 + row tiles of side 1, batch x head). A block of the
// first kind takes 64 rows of S and runs the online softmax over v1; a block
// of the second kind takes 64 columns of S, recomputes them as qk1 . qk0^T
// with the same scale and the same two biases, and runs the online softmax
// over v0. That is four products per tile pair against the TPU's three (the
// shared-S form, each S tile computed once and direction 1's partials
// combined in order, is the later redesign), and one launch instead of two.
// Each block is four warps of 16 rows, keys staged 64 at a time in shared
// memory, bf16 mma.sync m16n8k16 with f32 accumulation for both products,
// the probabilities reused from the score accumulators as A fragments.
//
// Numerics follow the Pallas kernel: f32 scores, running maxima starting at
// -1e30, p = exp(s - m) cast to bf16 before the PV product with f32
// accumulation, the output divided by max(l, 1e-30) (a row masked on both
// sides against every column comes out zero) and written in bf16. Ragged M
// and N are masked in the kernel: columns past the end contribute nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;       // head dim
constexpr int BQ = 64;      // rows per block, 16 per warp
constexpr int BK = 64;      // columns per tile
constexpr int LD = D + 8;   // padded shared-memory row, in bf16 elements
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

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

// One block: BQ rows of q (Nq rows, validity qm) against all Nk rows of k,
// online softmax over v; out (Nq, D). Pointers are already offset to this
// (batch, head); masks to this batch.
__device__ void attend_tile(const uint16_t* __restrict__ q,
                            const uint16_t* __restrict__ k,
                            const uint16_t* __restrict__ v,
                            const uint8_t* __restrict__ qm,
                            const uint8_t* __restrict__ km,
                            uint16_t* __restrict__ out, int q0, int Nq, int Nk,
                            float scale, uint16_t* sq, uint16_t* sk,
                            uint16_t* sv, float* kbias) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < BQ * D / 8; i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Nq)
      val = *reinterpret_cast<const uint4*>(q + static_cast<size_t>(q0 + r) * D + c);
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
  // the row biases of this thread's two rows (rows past Nq: any value)
  float qbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    qbias[r] = (row < Nq && qm[row]) ? 0.f : NEG;
  }

  float m[2] = {NEG, NEG};
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
        kv = *reinterpret_cast<const uint4*>(k + static_cast<size_t>(k0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(v + static_cast<size_t>(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(&sk[r * LD + c]) = kv;
      *reinterpret_cast<uint4*>(&sv[r * LD + c]) = vv;
    }
    if (tid < BK) {
      const int j = k0 + tid;
      // columns past Nk: -inf, so they add nothing to either sum
      kbias[tid] = j >= Nk ? -INFINITY : (km[j] ? 0.f : NEG);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 columns
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

    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = s[j][e] * scale + kbias[j * 8 + cc + (e & 1)] + qbias[e >> 1];
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // >= -1e30: always finite
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
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const int row0 = q0 + r0, row1 = q0 + r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int dim = j * 8 + cc;
    if (row0 < Nq)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row0) * D + dim) =
          pack_f32(acc[j][0] / l[0], acc[j][1] / l[0]);
    if (row1 < Nq)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row1) * D + dim) =
          pack_f32(acc[j][2] / l[1], acc[j][3] / l[1]);
  }
}

__global__ void __launch_bounds__(THREADS)
bidir_kernel(const uint16_t* __restrict__ qk0, const uint16_t* __restrict__ qk1,
             const uint16_t* __restrict__ v0, const uint16_t* __restrict__ v1,
             const uint8_t* __restrict__ mask0, const uint8_t* __restrict__ mask1,
             uint16_t* __restrict__ o0, uint16_t* __restrict__ o1, int H, int M,
             int N, float scale) {
  __shared__ __align__(16) uint16_t sq[BQ * LD];
  __shared__ __align__(16) uint16_t sk[BK * LD];
  __shared__ __align__(16) uint16_t sv[BK * LD];
  __shared__ float kbias[BK];

  const int bh = blockIdx.y, b = bh / H;
  const int tiles0 = (M + BQ - 1) / BQ;
  const size_t off0 = static_cast<size_t>(bh) * M * D;
  const size_t off1 = static_cast<size_t>(bh) * N * D;
  const uint8_t* m0 = mask0 + static_cast<size_t>(b) * M;
  const uint8_t* m1 = mask1 + static_cast<size_t>(b) * N;
  if (static_cast<int>(blockIdx.x) < tiles0) {
    // rows of S: side-0 queries against side-1 keys, values v1 -> m0
    attend_tile(qk0 + off0, qk1 + off1, v1 + off1, m0, m1, o0 + off0,
                blockIdx.x * BQ, M, N, scale, sq, sk, sv, kbias);
  } else {
    // columns of S: side-1 queries against side-0 keys, values v0 -> m1
    attend_tile(qk1 + off1, qk0 + off0, v0 + off0, m1, m0, o1 + off1,
                (blockIdx.x - tiles0) * BQ, N, M, scale, sq, sk, sv, kbias);
  }
}

}  // namespace

// qk0, v0, o0 (B, H, M, 64) and qk1, v1, o1 (B, H, N, 64) bf16, contiguous;
// mask0 (B, M) and mask1 (B, N) bool.
extern "C" int dim_bidir_attention_bf16(int device, const void* qk0, const void* qk1,
                                        const void* v0, const void* v1,
                                        const void* mask0, const void* mask1, void* o0,
                                        void* o1, int B, int H, int M, int N, float scale,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BQ - 1) / BQ + (N + BQ - 1) / BQ, B * H);
  bidir_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(qk0), static_cast<const uint16_t*>(qk1),
      static_cast<const uint16_t*>(v0), static_cast<const uint16_t*>(v1),
      static_cast<const uint8_t*>(mask0), static_cast<const uint8_t*>(mask1),
      static_cast<uint16_t*>(o0), static_cast<uint16_t*>(o1), H, M, N, scale);
  return static_cast<int>(cudaGetLastError());
}
