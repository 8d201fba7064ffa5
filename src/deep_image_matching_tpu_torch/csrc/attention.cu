// Masked multi-head attention with an online softmax, for LightGlue's self
// and cross attention, SuperGlue's attention and DINOv2 (kernel 1).
//
// Replaces the TPU kernel reached by
// deep_image_matching_tpu/ops/attention.py::fused_attention (the bundled
// Pallas flash-attention kernel, padding expressed as segment ids).
//
// What bounds it on the H100: at the main-path shape (q, k, v of
// (16, 4, 2048, 64) bf16) one call is 69 GFLOP against 50 MB of operands, so
// it is bound by tensor-core issue, not by memory. The dense form would also
// write and re-read a (B, H, Nq, Nk) f32 score tensor (1 GB per call). The
// block body is the wgmma / TMA core of attention_sm90.cuh: 192 query rows
// per block (three consumer warpgroups of 64), 128-key tiles fed by TMA into
// a shared-memory ring, both products on wgmma, the score tiles kept in
// registers.
//
// Semantics follow xla_attention (the JAX package's dense reference): scores
// are scaled, masked keys get -1e30 (so a query whose keys are all masked
// averages every key uniformly), keys past Nk contribute nothing. Query tiles
// whose queries are all masked are written as zeros and skipped; other rows
// of masked queries are computed like valid rows. Callers read valid rows
// only (their values are undefined in the JAX package too).
//
// The float32 form (dim_attention_f32, for tpu.dtype: float32) computes the
// same function with every product in split TF32, on the core of
// attention_f32_sm90.cuh.
//
// Head dim 96 (LighterGlue: one head of width 96) takes its own kernel,
// attention_mma below, templated on the head dim, in bf16 (dim_attention_hd96_bf16)
// and in split TF32 (dim_attention_hd96_f32). The wgmma core does not take 96
// cleanly: a 192-byte bf16 row is one and a half 128-byte swizzle atoms, so the
// TMA boxes, the shared-memory descriptors and the P V product (n = 96) would
// all need a 64 + 32 split, and the 48 accumulator registers of O beside S and P
// do not fit the core's 160 registers a consumer thread. attention_mma is the
// plain Ampere-style form instead: warp-level mma.sync, 64 query rows a block
// of four warps (16 rows a warp), Q's fragments in registers (bf16) or Q in
// shared memory (f32), key tiles double-buffered in padded shared memory by
// cp.async, the online softmax on the accumulator fragments. Its semantics are
// kernel 1's: masked keys at -1e30, keys past Nk contribute nothing, a query
// tile whose queries are all masked is written as zeros.

#include "attention_f32_sm90.cuh"
#include "attention_sm90.cuh"

namespace {

using namespace attn_sm90;

__global__ void __launch_bounds__(THREADS, 1)
attention_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ q_mask,
               const uint8_t* __restrict__ kv_mask, uint16_t* __restrict__ out, int H, int Nq,
               int Nk, float scale_log2) {
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
  attention_block<false>(job);
}

// the float32 form: the split operands of attention_f32_sm90.cuh
__global__ void __launch_bounds__(attn_f32::THREADS, 1)
attention_f32_sm90(const __grid_constant__ CUtensorMap qhi,
                   const __grid_constant__ CUtensorMap qlo,
                   const __grid_constant__ CUtensorMap khi,
                   const __grid_constant__ CUtensorMap klo,
                   const __grid_constant__ CUtensorMap vhi,
                   const __grid_constant__ CUtensorMap vlo,
                   const uint8_t* __restrict__ q_mask, const uint8_t* __restrict__ kv_mask,
                   float* __restrict__ out, int H, int Nq, int Nk, float scale_log2) {
  const int tiles = (Nq + attn_f32::BQ - 1) / attn_f32::BQ;
  int bh, x;
  attn_f32::block_tile(blockIdx.x, gridDim.x / tiles, tiles, bh, x);
  const int b = bh / H;
  attn_f32::Job job;
  job.qhi = &qhi;
  job.qlo = &qlo;
  job.khi = &khi;
  job.klo = &klo;
  job.vhi = &vhi;
  job.vlo = &vlo;
  job.qmask = q_mask == nullptr ? nullptr : q_mask + static_cast<size_t>(b) * Nq;
  job.kmask = kv_mask == nullptr ? nullptr : kv_mask + static_cast<size_t>(b) * Nk;
  job.out = out + static_cast<size_t>(bh) * Nq * attn_f32::D;
  job.bh = bh;
  job.q0 = x * attn_f32::BQ;
  job.Nq = Nq;
  job.Nk = Nk;
  job.scale_log2 = scale_log2;
  attn_f32::attention_block<false>(job);
}

// ---------------------------------------------------------------------------
// attention_mma: the head-dim-96 form (any D that is a multiple of 16)

namespace attn_mma {

constexpr int BQ = 64;        // query rows a block: 16 a warp
constexpr int THREADS = 128;  // four warps
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  // src-size 0 zero-fills the 16 bytes (rows past the end)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16 x 8 f32) += a (16 x 16 bf16) b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8 f32) += a (16 x 8 tf32) b (8 x 8 tf32)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <typename T>
struct Form;
// bf16: rows padded by 8 elements (16 bytes), so the eight 16-byte rows an
// ldmatrix phase reads fall in distinct banks
template <>
struct Form<uint16_t> {
  static constexpr int BK = 64;  // keys a tile
  static constexpr int PAD = 8;
};
// f32: rows padded by 4 floats, so the fragment loads (row g, column t and
// row 2 t, column g) fall in distinct banks
template <>
struct Form<float> {
  static constexpr int BK = 32;
  static constexpr int PAD = 4;
};

template <typename T, int D>
struct Smem {
  static constexpr int BK = Form<T>::BK;
  static constexpr int LD = D + Form<T>::PAD;
  static constexpr int Q_ELEMS = sizeof(T) == 4 ? BQ * LD : 0;  // f32 keeps Q in shared memory
  static constexpr int TILE_ELEMS = BK * LD;
  static constexpr int BYTES = (Q_ELEMS + 4 * TILE_ELEMS) * sizeof(T) + 2 * BK * 4;
};

// The masked attention of one block of BQ query rows of one (batch, head)
// over every key tile. T: uint16_t (bf16 bits) or float (split TF32).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const uint8_t* __restrict__ q_mask, const uint8_t* __restrict__ kv_mask,
              T* __restrict__ out, int H, int Nq, int Nk, float C) {
  using S = Smem<T, D>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BK = S::BK, LD = S::LD;
  constexpr int NS = BK / 8;   // n-blocks of 8 keys in S
  constexpr int NO = D / 8;    // n-blocks of 8 columns in O
  extern __shared__ __align__(16) uint8_t dyn_smem[];
  T* sq = reinterpret_cast<T*>(dyn_smem);
  T* sk = sq + S::Q_ELEMS;            // [2][BK][LD]
  T* sv = sk + 2 * S::TILE_ELEMS;     // [2][BK][LD]
  float* sbias = reinterpret_cast<float*>(sv + 2 * S::TILE_ELEMS);  // [2][BK]

  const int qtiles = (Nq + BQ - 1) / BQ;
  const int bh = blockIdx.x / qtiles, q0 = (blockIdx.x % qtiles) * BQ, b = bh / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const T* qb = q + static_cast<size_t>(bh) * Nq * D;
  const T* kb = k + static_cast<size_t>(bh) * Nk * D;
  const T* vb = v + static_cast<size_t>(bh) * Nk * D;
  T* ob = out + static_cast<size_t>(bh) * Nq * D;
  const uint8_t* km = kv_mask == nullptr ? nullptr : kv_mask + static_cast<size_t>(b) * Nk;

  // a query tile whose rows are all masked: zeros, nothing else
  bool any_q = q_mask == nullptr;
  if (!any_q && tid < BQ && q0 + tid < Nq) any_q = q_mask[static_cast<size_t>(b) * Nq + q0 + tid];
  if (!__syncthreads_or(any_q)) {
    for (int i = tid; i < BQ * D; i += THREADS)
      if (q0 + i / D < Nq) ob[static_cast<size_t>(q0) * D + i] = T(0);
    return;
  }

  constexpr int CH = D * sizeof(T) / 16;  // 16-byte chunks a row
  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * BK;
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, key = k0 + r;
      const bool ok = key < Nk;
      const size_t off = static_cast<size_t>(ok ? key : 0) * D + c * (16 / sizeof(T));
      const int dst = (buf * BK + r) * LD + c * (16 / sizeof(T));
      cp_async16(sm90::smem_u32(sk + dst), kb + off, ok);
      cp_async16(sm90::smem_u32(sv + dst), vb + off, ok);
    }
    if (tid < BK) {
      const int key = k0 + tid;
      sbias[buf * BK + tid] =
          key >= Nk ? -INFINITY : ((km == nullptr || km[key] != 0) ? 0.f : NEG);
    }
  };

  // this thread's rows (of the warp's 16): g and g + 8
  const int rw = warp * 16 + g;
  uint32_t qa[F32 ? 1 : D / 16][4];  // bf16: Q's A fragments for the D / 16 k-steps
  if constexpr (F32) {
    for (int i = tid; i < BQ * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = q0 + r < Nq;
      cp_async16(sm90::smem_u32(sq + r * LD + c * 4),
                 qb + static_cast<size_t>(ok ? q0 + r : 0) * D + c * 4, ok);
    }
  } else {
    const int r0 = q0 + rw, r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      auto ld = [&](int row, int col) -> uint32_t {
        return row < Nq ? *reinterpret_cast<const uint32_t*>(qb + static_cast<size_t>(row) * D +
                                                               col)
                        : 0u;
      };
      qa[kk][0] = ld(r0, 16 * kk + 2 * t);
      qa[kk][1] = ld(r1, 16 * kk + 2 * t);
      qa[kk][2] = ld(r0, 16 * kk + 8 + 2 * t);
      qa[kk][3] = ld(r1, 16 * kk + 8 + 2 * t);
    }
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int ntiles = (Nk + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) {
      load_tile(tile + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* K = sk + buf * S::TILE_ELEMS;
    const T* V = sv + buf * S::TILE_ELEMS;

    // S = Q K^T (16 rows x BK keys a warp)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t ah[4], al[4];
        const float* qr = sq + rw * LD + 8 * kk + t;
        sm90::split_tf32(qr[0], ah[0], al[0]);
        sm90::split_tf32(qr[8 * LD], ah[1], al[1]);
        sm90::split_tf32(qr[4], ah[2], al[2]);
        sm90::split_tf32(qr[8 * LD + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* kr = K + (8 * n + g) * LD + 8 * kk + t;
          uint32_t bh0, bl0, bh1, bl1;
          sm90::split_tf32(kr[0], bh0, bl0);
          sm90::split_tf32(kr[4], bh1, bl1);
          mma_tf32(s[n], al, bh0, bh1);
          mma_tf32(s[n], ah, bl0, bl1);
          mma_tf32(s[n], ah, bh0, bh1);
        }
      }
    } else {
      const int mi = lane / 8, row = lane % 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < NS / 2; ++n2) {
          // matrices: keys 16 n2 + {0-7, 8-15} x dims 16 kk + {0-7, 8-15}
          uint32_t r[4];
          ldsm_x4(r, sm90::smem_u32(K + (16 * n2 + (mi >> 1) * 8 + row) * LD + 16 * kk +
                                    (mi & 1) * 8));
          mma_bf16(s[2 * n2], qa[kk], r[0], r[1]);
          mma_bf16(s[2 * n2 + 1], qa[kk], r[2], r[3]);
        }
      }
    }

    // online softmax on the fragments: s[n][e] is row g + 8 (e / 2), key
    // 8 n + 2 t + (e % 2)
    const float* bias = sbias + buf * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 kbias = *reinterpret_cast<const float2*>(bias + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fmaf(s[n][e], C, (e & 1) ? kbias.y : kbias.x);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: the tile holds a key < Nk
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V
    if constexpr (F32) {
      // k-step j covers keys 8 j .. 8 j + 7; the A fragment's column t is key
      // 2 t and column t + 4 key 2 t + 1 (the accumulator's layout), so V's
      // rows are read in that order
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t ph[4], pl[4];
        sm90::split_tf32(s[j][0], ph[0], pl[0]);
        sm90::split_tf32(s[j][2], ph[1], pl[1]);
        sm90::split_tf32(s[j][1], ph[2], pl[2]);
        sm90::split_tf32(s[j][3], ph[3], pl[3]);
        const float* vr = V + (8 * j + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          sm90::split_tf32(vr[8 * n], bh0, bl0);
          sm90::split_tf32(vr[LD + 8 * n], bh1, bl1);
          mma_tf32(o[n], pl, bh0, bh1);
          mma_tf32(o[n], ph, bl0, bl1);
          mma_tf32(o[n], ph, bh0, bh1);
        }
      }
    } else {
      const int mi = lane / 8, row = lane % 8;
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        // P rounded to bf16 in the A-fragment order of keys 16 j .. 16 j + 15
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          // matrices: keys 16 j + {0-7, 8-15} x columns 16 n2 + {0-7, 8-15}, transposed
          uint32_t r[4];
          ldsm_x4_t(r, sm90::smem_u32(V + (16 * j + (mi & 1) * 8 + row) * LD + 16 * n2 +
                                      (mi >> 1) * 8));
          mma_bf16(o[2 * n2], pa, r[0], r[1]);
          mma_bf16(o[2 * n2 + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rowg = q0 + rw + 8 * r;
    if (rowg >= Nq) continue;
    T* dst = ob + static_cast<size_t>(rowg) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float x0 = o[n][2 * r] * inv[r], x1 = o[n][2 * r + 1] * inv[r];
      if constexpr (F32)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(dst + 8 * n) = pack_bf16(x0, x1);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* q_mask, const void* kv_mask,
           void* out, int B, int H, int Nq, int Nk, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = Smem<T, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(attention_mma<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B * H * ((Nq + BQ - 1) / BQ);
  attention_mma<T, D><<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(q_mask), static_cast<const uint8_t*>(kv_mask),
      static_cast<T*>(out), H, Nq, Nk, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_mma

}  // namespace

// q (B, H, Nq, 64), k and v (B, H, Nk, 64) bf16, contiguous, 16-byte
// aligned; q_mask (B, Nq) and kv_mask (B, Nk) bool or null; out
// (B, H, Nq, 64) bf16. Every size must be positive.
extern "C" int dim_attention_bf16(int device, const void* q, const void* k,
                                  const void* v, const void* q_mask,
                                  const void* kv_mask, void* out, int B, int H,
                                  int Nq, int Nk, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int e;
  if ((e = make_map(&mq, q, Nq, B * H, BQ)) || (e = make_map(&mk, k, Nk, B * H)) ||
      (e = make_map(&mv, v, Nk, B * H)))
    return e;
  err = cudaFuncSetAttribute(attention_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B * H * ((Nq + BQ - 1) / BQ);
  attention_sm90<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<const uint8_t*>(q_mask), static_cast<const uint8_t*>(kv_mask),
      static_cast<uint16_t*>(out), H, Nq, Nk, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// The float32 form: q (B, H, Nq, 64), k and v (B, H, Nk, 64) f32, contiguous,
// 16-byte aligned; masks as for dim_attention_bf16; out (B, H, Nq, 64) f32.
// Scratch, f32: q_split (2, B, H, Nq, 64) and k_split (2, B, H, Nk, 64) for
// the TF32 halves, v_split (2, B H, 64, Np) for V's transposed halves, Np =
// Nk rounded up to 8. Every size must be positive.
extern "C" int dim_attention_f32(int device, const void* q, const void* k, const void* v,
                                 const void* q_mask, const void* kv_mask, void* out,
                                 void* q_split, void* k_split, void* v_split, int B, int H,
                                 int Nq, int Nk, float scale, void* stream) {
  namespace af = attn_f32;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  float* qs = static_cast<float*>(q_split);
  float* ks = static_cast<float*>(k_split);
  float* vs = static_cast<float*>(v_split);
  const int64_t nq = static_cast<int64_t>(BH) * Nq * af::D;
  const int64_t nk = static_cast<int64_t>(BH) * Nk * af::D;
  int e;
  if ((e = af::split_rows(static_cast<const float*>(q), qs, nq, st)) ||
      (e = af::split_rows(static_cast<const float*>(k), ks, nk, st)) ||
      (e = af::split_vt(static_cast<const float*>(v), vs, BH, Nk, st)))
    return e;
  CUtensorMap mqh, mql, mkh, mkl, mvh, mvl;
  if ((e = af::make_row_maps(&mqh, &mql, qs, Nq, BH)) ||
      (e = af::make_row_maps(&mkh, &mkl, ks, Nk, BH)) ||
      (e = af::make_vt_maps(&mvh, &mvl, vs, Nk, BH)))
    return e;
  err = cudaFuncSetAttribute(attention_f32_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             af::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = BH * ((Nq + af::BQ - 1) / af::BQ);
  attention_f32_sm90<<<grid, af::THREADS, af::SMEM_BYTES, st>>>(
      mqh, mql, mkh, mkl, mvh, mvl, static_cast<const uint8_t*>(q_mask),
      static_cast<const uint8_t*>(kv_mask), static_cast<float*>(out), H, Nq, Nk,
      scale * af::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// Head dim 96: q (B, H, Nq, 96), k and v (B, H, Nk, 96) bf16, contiguous,
// 16-byte aligned; masks as for dim_attention_bf16; out (B, H, Nq, 96) bf16.
extern "C" int dim_attention_hd96_bf16(int device, const void* q, const void* k, const void* v,
                                       const void* q_mask, const void* kv_mask, void* out, int B,
                                       int H, int Nq, int Nk, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return attn_mma::launch<uint16_t, 96>(q, k, v, q_mask, kv_mask, out, B, H, Nq, Nk, scale,
                                        stream);
}

// Head dim 96 in float32 (split TF32): as dim_attention_hd96_bf16 with f32
// operands and output; no scratch.
extern "C" int dim_attention_hd96_f32(int device, const void* q, const void* k, const void* v,
                                      const void* q_mask, const void* kv_mask, void* out, int B,
                                      int H, int Nq, int Nk, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return attn_mma::launch<float, 96>(q, k, v, q_mask, kv_mask, out, B, H, Nq, Nk, scale, stream);
}
