// RoMa's ConvRefiner at the finest scale, on NHWC f32: N blocks of
//   y = conv1x1(relu(dwconv5x5_same(x) + b1)) + b2
// with x, y (B, H, W, C), w1 (5, 5, 1, C) depthwise taps, b1 (C),
// w2 (1, 1, C, C) as (in, out), b2 (C) per block. One launch per block,
// ping-ponging two buffers between launches.
//
// Replaces the TPU kernel deep_image_matching_tpu/ops/pallas_refiner.py::
// refiner_dw_stack (_block_kernel, the pallas_call at :90), which lays a
// row band out as (H, C, W) so that W fills the 128 lanes, rolls lanes for
// the five x-taps and runs R small (C, C) x (C, W) MXU products per band,
// one call per block. None of that carries over: here the layout stays NHWC.
//
// What bounds it on the H100: at the path's shapes (B = 2 images, 864^2 or
// 560^2, C = 24, N = 9) one read and one write of the activations take
// 85.6 us at 864^2, nine launches 0.770 ms; the taps in f32 FMA and the 1x1
// as three TF32 products 0.334 ms. The design:
//   - a thread block owns a strip of Wt output columns over a band of Hb
//     rows and streams down it one input row a step: at step s it takes
//     input row s (image row Y0 - 2 + s, columns X0 - 2 .. X0 + Wt + 1) into
//     the depthwise sums while the 1x1 mix finishes the row the depthwise
//     finished a step earlier, into y: one barrier a step, the mix's latency
//     under the depthwise. Two thread blocks share an SM (124 registers);
//   - the input rows come by TMA (a 4-D tensor map (C, W, H, B) whose
//     out-of-bounds reads are zeros: the 'same' padding) through a ring of 4
//     rows, issued 3 steps ahead. Where C % 4 != 0 a TMA box cannot hold a
//     pixel row, so a second instantiation loads the rows with plain loads,
//     zeros outside the image, one step ahead;
//   - the depthwise 5x5 in f32 FMA: a thread owns one channel (threads % C
//     == 0 of the 256 take part) and up to 4 columns, keeps the 25 taps in
//     registers, and keeps four running sums per column (its output rows
//     still open), each moved down a slot as a new input row comes, so each
//     input value read from shared memory feeds 5 FMAs; + b1, ReLU, and the
//     activation is split once into TF32 halves;
//   - a step is bound by instruction issue and its latency, so the row
//     buffers are padded to the columns any thread owns, which drops every
//     per-column bounds check (the extra columns compute values no one
//     reads), and RoMa's C = 24 has an instantiation of its own, whose
//     offsets are immediates; other widths take C at run time;
//   - the 1x1 mix on the tensor cores in split TF32 (mma.sync m16n8k8,
//     (lo.hi + hi.lo) + hi.hi with f32 accumulation, hi = rna_tf32(x), lo =
//     rna_tf32(x - hi)), which keeps f32-level results (one TF32 product
//     alone leaves the 1e-5 tolerance after 9 blocks); the weights'
//     fragments are split once per launch into shared memory. K and N pad
//     to multiples of 8, the activations' padding channels zeroed once (the
//     tensor cores give NaN for a zero weight times a NaN left in shared
//     memory). A warp takes a 16-pixel tile and its 8-channel n-tiles at
//     once (NTC at a time for a run-time C), the lo terms and hi.hi in
//     separate accumulators: independent chains of dependent mma, where one
//     chain of all of them is latency-bound.
// Fusing three blocks a launch (halos recomputed, out-of-image pixels
// zeroed between blocks) moved the activations a third as often but ran
// slower: three blocks' taps and sums leave one thread block an SM (PERF.md).
// tests/test_torch_refiner_tiles.py holds a model of this algorithm on the
// CPU against the JAX package's Pallas kernel.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps: two a register-file quarter, so up to 255 registers
constexpr int NWARPS = THREADS / 32;
constexpr int CTAS_PER_SM = 2;
constexpr int NTC = 2;        // n-tiles of the 1x1 mix a warp accumulates at once (run-time C;
                              // three spill in the plain-load instantiation)
constexpr int MAXI = 4;       // output columns a thread owns
constexpr int MAX_C = 64;
constexpr int RING = 4;       // TMA stages of the input rows
constexpr int MAX_BOX = 256;  // a TMA box's extent
constexpr int FAST_C = 24;    // RoMa's width at scale 1: C known at compile time

constexpr __host__ __device__ int round8(int n) { return (n + 7) & ~7; }
constexpr __host__ __device__ int round16(int n) { return (n + 15) & ~15; }
constexpr __host__ __device__ int align32(int n) { return (n + 31) & ~31; }  // 128 bytes

// the output columns a block's threads own: MAXI per taking-part thread,
// at most a TMA box less the halo
__host__ __device__ __forceinline__ int span_of(int C) {
  const int s = MAXI * (THREADS / C);
  return s < MAX_BOX - 4 ? s : MAX_BOX - 4;
}

// shared-memory regions, in floats: the ring of input rows, each `span + 4`
// columns wide (the columns any thread reads); two activation rows in TF32
// halves (round16(span) pixel rows at a stride of C8 + 4 words: the mma's A
// fragments read without bank conflicts; hi at hhi + k hrow, lo at
// hhi + (2 + k) hrow); the 1x1 weights as split B fragments and b2; the
// ring's mbarriers
struct Layout {
  int slot, hhi, hrow, bf, b2, bar, total;
  __host__ __device__ Layout(int C, bool tma) {
    const int C8 = round8(C), HS = C8 + 4, span = span_of(C);
    slot = align32((span + 4) * C);
    hhi = (tma ? RING : 2) * slot;
    hrow = align32(round16(span) * HS);
    bf = hhi + 4 * hrow;
    b2 = bf + (C8 / 8) * (C8 / 8) * 128;
    bar = b2 + align32(C8);
    total = bar + 2 * RING;
  }
};

// d (16 x 8, f32) += A (16 x 8, TF32, row) B (8 x 8, TF32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4], float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// One block over one (image, band, strip) work unit. x (B, H, W, C) is its
// input, y its output. CC is C where it is known at compile time, else 0 and
// C comes as `c`.
template <bool TMA, int CC>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
refiner_block_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ x,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     float* __restrict__ y, int H, int W, int c, int Wt, int Hb, int strips,
                     int bands) {
  extern __shared__ __align__(128) float smem[];
  const int C = CC ? CC : c;
  const Layout L(C, TMA);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  int unit = blockIdx.x;
  const int strip = unit % strips;
  unit /= strips;
  const int band = unit % bands, b = unit / bands;
  const int X0 = strip * Wt, Y0 = band * Hb;
  const int Hr = min(Hb, H - Y0);  // output rows of this band
  const int R0 = Hr + 4;           // its input rows
  const int C8 = round8(C), HS = C8 + 4, KT = C8 / 8;
  const int Q = THREADS / C, ch = tid % C, q = tid / C, span = span_of(C);
  const bool active = q < Q;
  const int Wi = Wt + 4;  // input columns
  constexpr int NSLOTS = TMA ? RING : 2;
  const size_t img = static_cast<size_t>(b) * H * W * C;
  const int in_base = q * C + ch, h_base = q * HS + ch;

  // the 1x1 weights as split B fragments: {hi(k), hi(k + 4), lo(k),
  // lo(k + 4)} at row k = 8 kt + tig, column n = 8 nt + gid of each 8 x 8
  // tile; b2 padded with zeros
  float* bfs = smem + L.bf;
  for (int i = tid; i < KT * KT * 32; i += THREADS) {
    const int ln = i & 31, t = i >> 5, kt = t / KT, nt = t % KT;
    const int k = 8 * kt + (ln & 3), n = 8 * nt + (ln >> 2);
    const float wa = (k < C && n < C) ? w2[k * C + n] : 0.f;
    const float wb = (k + 4 < C && n < C) ? w2[(k + 4) * C + n] : 0.f;
    const float ha = sm90::rna_tf32(wa), hb = sm90::rna_tf32(wb);
    reinterpret_cast<float4*>(bfs)[i] =
        make_float4(ha, hb, sm90::rna_tf32(wa - ha), sm90::rna_tf32(wb - hb));
  }
  for (int n = tid; n < C8; n += THREADS) smem[L.b2 + n] = n < C ? b2[n] : 0.f;
  // the activations' K padding (channels C .. C8 - 1), which the depthwise
  // never writes: zeros, not whatever an earlier kernel left there
  if (C8 != C) {
    const int pad = C8 - C, rows = 4 * round16(span);
    for (int e = tid; e < rows * pad; e += THREADS) {
      const int r = e / pad;
      smem[L.hhi + (r >> 2) * HS + (r & 3) * L.hrow + C + e % pad] = 0.f;
    }
  }
  float tap[25];
#pragma unroll
  for (int t = 0; t < 25; ++t) tap[t] = active ? w1[t * C + ch] : 0.f;
  const float bias = active ? b1[ch] : 0.f;

  const uint32_t bar0 = sm90::smem_u32(smem + L.bar);
  const CUtensorMap* tmap = &map;
  // input row j: image row Y0 - 2 + j, columns X0 - 2 ..
  auto load_row = [&](int j) {
    float* dst = smem + (j % NSLOTS) * L.slot;
    if constexpr (TMA) {
      const uint32_t bar = bar0 + 8 * (j % RING);
      sm90::mbar_arrive_tx(bar, static_cast<uint32_t>(Wi * C * 4));
      sm90::tma_load_4d(sm90::smem_u32(dst), tmap, bar, 0, X0 - 2, Y0 - 2 + j, b);
    } else {
      const int gy = Y0 - 2 + j;
      for (int e = tid; e < Wi * C; e += THREADS) {
        const int gx = X0 - 2 + e / C;
        dst[e] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                     ? x[img + (static_cast<size_t>(gy) * W + gx) * C + e % C]
                     : 0.f;
      }
    }
  };
  if constexpr (TMA) {
    if (tid == 0) {
      for (int i = 0; i < RING; ++i) sm90::mbar_init(bar0 + 8 * i, 1);
      sm90::mbar_init_fence();
      for (int j = 0; j < RING && j < R0; ++j) load_row(j);
    }
  } else {
    load_row(0);
  }
  __syncthreads();

  const int tiles = round16(Wt) / 16;  // the mix's 16-pixel tiles

  // acc[it][j]: the running sum of output row i - 4 + j of column q + it Q,
  // before input row i
  float acc[MAXI][4];
#pragma unroll
  for (int it = 0; it < MAXI; ++it)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[it][k] = 0.f;

  for (int s = 0; s < R0 + 1; ++s) {
    // the ring's slot of row s - 1 is free: refill it with row s - 1 + RING;
    // without TMA, row s + 1 goes into the slot row s - 1 left
    if constexpr (TMA) {
      if (tid == 0 && s >= 1 && s - 1 + RING < R0) {
        sm90::fence_proxy_async();
        load_row(s - 1 + RING);
      }
    } else {
      if (s + 1 < R0) load_row(s + 1);
    }

    // 1. depthwise 5x5: input row s finishes output row s - 4 (tap row 4)
    // into activation buffer s % 2 and moves the sums of rows s - 3 .. s
    // down a slot (tap rows 3 .. 0, row s starting at 0). Columns past the
    // strip compute values in the padding that nothing reads.
    if (s < R0) {
      const float* src = smem + (s % NSLOTS) * L.slot + in_base;
      if constexpr (TMA) sm90::mbar_wait(bar0 + 8 * (s % RING), (s / RING) & 1);
      if (active) {
        float* hh = smem + L.hhi + (s & 1) * L.hrow + h_base;
#pragma unroll
        for (int it = 0; it < MAXI; ++it) {
          if (CC == 0 && q + it * Q >= span) continue;  // a run-time C past the padding
          const float* p = src + it * Q * C;
          float v[5];
#pragma unroll
          for (int dx = 0; dx < 5; ++dx) v[dx] = p[dx * C];
          float* a = acc[it];
          float out = a[0];
#pragma unroll
          for (int dx = 0; dx < 5; ++dx) out = fmaf(tap[20 + dx], v[dx], out);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            float t = a[j + 1];
#pragma unroll
            for (int dx = 0; dx < 5; ++dx) t = fmaf(tap[(3 - j) * 5 + dx], v[dx], t);
            a[j] = t;
          }
          float t = tap[0] * v[0];
#pragma unroll
          for (int dx = 1; dx < 5; ++dx) t = fmaf(tap[dx], v[dx], t);
          a[3] = t;
          if (s >= 4) {
            const float h = fmaxf(out + bias, 0.f);
            const float hi = sm90::rna_tf32(h);
            hh[it * Q * HS] = hi;
            hh[it * Q * HS + 2 * L.hrow] = sm90::rna_tf32(h - hi);
          }
        }
      }
    }

    // 2. the 1x1 mix of output row o = s - 5, finished at step s - 1
    // (activation buffer (s - 1) % 2), on the tensor cores, a 16-pixel tile
    // per warp, into y
    const int o = s - 5;
    if (o >= 0) {
      for (int m = warp; m < tiles; m += NWARPS) {
        const int m0 = 16 * m;
        const float* hh = smem + L.hhi + ((s - 1) & 1) * L.hrow + (m0 + gid) * HS + tig;
        const float* hl = hh + 2 * L.hrow;
        const float4* bfr = reinterpret_cast<const float4*>(smem + L.bf);
        const float* b2s = smem + L.b2;
        const int p0 = m0 + gid, p1 = p0 + 8;
        // all n-tiles at once for C = FAST_C, else NTC at a time; the lo
        // terms and hi.hi in separate accumulators: independent mma chains
        constexpr int NTJ = CC ? round8(CC) / 8 : NTC;
        for (int n0 = 0; n0 < KT; n0 += NTJ) {
          float dl[NTJ][4], dh[NTJ][4];
#pragma unroll
          for (int j = 0; j < NTJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dl[j][e] = dh[j][e] = 0.f;
#pragma unroll
          for (int kt = 0; kt < KT; ++kt) {
            const int k = 8 * kt;
            const float ahi[4] = {hh[k], hh[8 * HS + k], hh[k + 4], hh[8 * HS + k + 4]};
            const float alo[4] = {hl[k], hl[8 * HS + k], hl[k + 4], hl[8 * HS + k + 4]};
#pragma unroll
            for (int j = 0; j < NTJ; ++j) {
              if (CC == 0 && n0 + j >= KT) break;
              const float4 bw = bfr[(kt * KT + n0 + j) * 32 + lane];
              mma_tf32(dl[j], alo, bw.x, bw.y);
              mma_tf32(dl[j], ahi, bw.z, bw.w);
              mma_tf32(dh[j], ahi, bw.x, bw.y);
            }
          }
#pragma unroll
          for (int j = 0; j < NTJ; ++j) {
            if (CC == 0 && n0 + j >= KT) break;
            const int n = 8 * (n0 + j) + 2 * tig;
            if (n >= C) continue;
            const float bn0 = b2s[n], bn1 = b2s[n + 1];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int p = r ? p1 : p0;
              if (p >= Wt || X0 + p >= W) continue;
              const float v0 = (dl[j][2 * r] + dh[j][2 * r]) + bn0;
              const float v1 = (dl[j][2 * r + 1] + dh[j][2 * r + 1]) + bn1;
              float* out = y + img + (static_cast<size_t>(Y0 + o) * W + X0 + p) * C + n;
              if ((C & 1) == 0) {
                *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
              } else {
                out[0] = v0;
                if (n + 1 < C) out[1] = v1;
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

using KernelFn = void (*)(const CUtensorMap, const float*, const float*, const float*,
                          const float*, const float*, float*, int, int, int, int, int, int,
                          int);

}  // namespace

// One refiner block. x, y (B, H, W, C) f32 contiguous, distinct; w1 (25, C),
// b1 (C), w2 (C, C) as (in, out), b2 (C) f32 contiguous, the block's slices
// of the stacked weights; 1 <= C <= 64. The tiles: strips of Wt output
// columns, bands of Hb rows, with Wt <= min(4 (256 / C), 252)
// (ops/refiner.py::refiner_plan). Rows come by TMA where C % 4 == 0 and x is
// 16-byte aligned. Returns the CUDA error of the launch (0 on success).
extern "C" int dim_refiner_block(int device, const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* y, int B, int H, int W,
                                 int C, int Wt, int Hb, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C < 1 || C > MAX_C || Wt < 1 || Hb < 1 || B < 1 || H < 1 || W < 1 || Wt > span_of(C))
    return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (W + Wt - 1) / Wt, bands = (H + Hb - 1) / Hb;
  const long long units = static_cast<long long>(B) * strips * bands;
  if (units > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool tma = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  CUtensorMap map{};
  if (tma) {
    const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                              static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
    const uint32_t box[4] = {static_cast<uint32_t>(C), static_cast<uint32_t>(Wt + 4), 1, 1};
    const int r = sm90::encode_tiled_map(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, 4, dims,
                                         box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (r != 0) return r;
  }
  // TMA where a pixel row fits a box; C = FAST_C on its own instantiation
  const KernelFn fn = !tma ? refiner_block_kernel<false, 0>
                      : C == FAST_C ? refiner_block_kernel<true, FAST_C>
                                    : refiner_block_kernel<true, 0>;
  const size_t smem = static_cast<size_t>(Layout(C, tma).total) * sizeof(float);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<static_cast<unsigned>(units), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(y), H, W, C, Wt, Hb, strips, bands);
  return static_cast<int>(cudaGetLastError());
}
