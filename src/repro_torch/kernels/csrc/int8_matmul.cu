// W8A16 matrix product for Hopper: x @ int8 w with a per-output-column
// fp32 scale applied to the fp32 accumulator, every Parallel-Track track
// of a projection in one launch.
//
// Replaces the Pallas kernel repro/kernels/quant_matmul.py::int8_matmul
// (_kernel): x [M, K] float, w [K, N] int8, scale [1, N] fp32 -> [M, N]
// fp32.  Here with a leading track dim: x [n, M, K], w [n, K, N] (the JAX
// layout, n contiguous), scale [n, 1, N], out [n, M, N] in fp32 (the
// Pallas contract) or bf16 (acc * scale rounded once to nearest even in
// the epilogue: the bits the caller's cast of the fp32 output gave,
// without writing and re-reading the fp32 tensor).
//
// Every route widens the weight with widen4 below: four int8 of a 32-bit
// word become exact fp32 by byte permutes and one FP32 add each, on the
// ALU at full rate, never through the conversion unit (I2F/F2F run at an
// eighth of the FMA rate on Hopper); bf16 pairs are the upper halves of
// two such floats (exact: |q| <= 128 fits bf16's 8-bit significand).
// The weight tile is read from shared memory in words, never bytes.
//
// Routes, chosen by shape in quant_matmul.py::route and passed in:
//   * wgmma_tma (bf16 x, M > 16, K % 8 == 0, N % 16 == 0, 16-byte bases):
//     prefill and chunk products, bound by operations on paper (M = 4096
//     rows give ~4000 flop per weight byte, far above the ~295 flop/byte
//     ridge) and in practice by the bytes each SM takes in per product:
//     a 256 x 64 bf16 x stage feeds 2 M multiply-adds, so the tile is as
//     large as the registers allow.  The product runs transposed, out^T =
//     w^T x^T, as CUTLASS's mixed-input GEMM does: x stays in shared memory
//     as TMA lands it (wgmma's K-major B, 128-byte swizzle) and is read
//     there once per warpgroup, while each thread widens its own weight
//     bytes straight into wgmma's register A fragments, so no widened tile
//     crosses shared memory and the two consumer warpgroups never wait on
//     each other.  A thread's two fragment rows are made adjacent output
//     columns, so its bytes of a k row are one 16-bit load.  One
//     persistent CTA per SM walks 256-row x 128-column tiles (warpgroup cw:
//     columns 64 cw .. + 63, one m64n256k16 per k16 step, 128 fp32
//     accumulators, registers raised with setmaxnreg); a producer thread
//     keeps a 4-stage ring of TMA loads in flight (3-D tensor maps over
//     (inner, rows, track) that zero-fill the ragged M, N and K edges of
//     each track), on into the next tile during an epilogue; the next
//     stage's bytes load and widen while the current stage's products
//     run.  The epilogue scales, rounds to the output type and stages the
//     tile in shared memory for TMA stores, which clip the ragged edges and
//     drain while the next tile runs.
//   * mma_m16 / mma_m64 (bf16 x otherwise: decode at M <= 16, and the
//     shapes TMA cannot take): bound by bytes at decode (each weight byte
//     feeds 2 * M flops).  mma.sync m16n8k16 with fp32 accumulators; the
//     weight tile is stored with the two k of a fragment pair interleaved
//     per column, so a thread reads its two columns' pairs as one word;
//     the columns a thread owns are adjacent (which only relabels
//     columns: every output's products and their order are unchanged), so
//     it stores four adjacent outputs at once.
//   * fma_rows (fp32 x, M <= 16, N % 16 == 0, 16-byte w): the LM head on
//     the int8 path, bound by the weight bytes.  The weight streams in
//     16-byte cp.async copies through a 4-stage ring; each weight is
//     widened once per block and used for all M rows (no padding of M to a
//     16-row tile); the eight warps split k and meet in shared memory.
//   * fma_m16 / fma_m64 (fp32 x otherwise): FMA on the CUDA cores, the
//     tile staged through registers.
// fp32 x runs FMA on the CUDA cores (no TF32), as the Pallas kernel
// upcasts both operands to fp32.
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// widening
// ---------------------------------------------------------------------------

// Four int8 of a word as exact fp32: flip the sign bit (u = q + 128), put
// u in the low byte of 0x4B000000 (the float 2^23 + u) and subtract
// 2^23 + 128.
__device__ __forceinline__ void widen4(uint32_t q, float f[4]) {
  const uint32_t u = q ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// Four int8 of a word as two bf16 pairs (bytes 0,1 and 2,3, the lower byte
// in the low half): the upper halves of the exact floats.
__device__ __forceinline__ uint2 widen4_bf16(uint32_t q) {
  float f[4];
  widen4(q, f);
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// ---------------------------------------------------------------------------
// shared by the routes
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBN = 64;                 // output columns per block
constexpr int kBK = 64;                 // contraction depth per tile

// 16 bytes of int8 weight row k (columns n .. n+15) into registers;
// zeros past K or N.  The vector load needs N % 16 == 0 and an aligned w.
__device__ __forceinline__ uint4 load_w16(const int8_t* wt, int K, int N,
                                          int k, int n, bool vec) {
  if (vec && k < K && n + 16 <= N)
    return *reinterpret_cast<const uint4*>(wt + (size_t)k * N + n);
  uint4 r = make_uint4(0, 0, 0, 0);
  int8_t* b = reinterpret_cast<int8_t*>(&r);
  if (k < K)
    for (int j = 0; j < 16; ++j)
      if (n + j < N) b[j] = wt[(size_t)k * N + n + j];
  return r;
}

// 16 bytes of x row m (elements k .. k + 16 / sizeof(T) - 1); zeros past
// M or K.  The vector load needs K % (16 / sizeof(T)) == 0 and an aligned x.
template <typename T>
__device__ __forceinline__ uint4 load_x16(const T* xt, int M, int K, int m,
                                          int k, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec && m < M && k + E <= K)
    return *reinterpret_cast<const uint4*>(xt + (size_t)m * K + k);
  uint4 r = make_uint4(0, 0, 0, 0);
  T* e = reinterpret_cast<T*>(&r);
  if (m < M)
    for (int j = 0; j < E; ++j)
      if (k + j < K) e[j] = xt[(size_t)m * K + k + j];
  return r;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Two adjacent outputs at p (8-byte fp32 / 4-byte bf16 aligned).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Four adjacent outputs at p (16-byte fp32 / 8-byte bf16 aligned).
__device__ __forceinline__ void store4v(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4v(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                 *reinterpret_cast<const uint32_t*>(&b));
}

// Four adjacent outputs of row `row` from column c (a multiple of 4);
// `vec` when N % 4 == 0, so the four are aligned as store4v needs.
template <typename OutT>
__device__ __forceinline__ void store4(OutT* row, int c, int N,
                                       const float v[4], bool vec) {
  if (vec && c + 4 <= N) {
    store4v(row + c, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < N) store1(row + c + j, v[j]);
}

// ---------------------------------------------------------------------------
// mma_m16 / mma_m64: bf16 x on mma.sync.  Warp w owns tile columns
// [16 w, 16 w + 16): in n8 tile nt, fragment column g is tile column
// 16 w + 2 g + nt, so a thread's two B columns are adjacent and its four
// outputs in a row are tile columns 16 w + 4 t4 .. + 3.
// ---------------------------------------------------------------------------
constexpr int kXPad = 8;                // bf16 per x tile row
constexpr int kWRow = 2 * kBN + 32;     // bytes per k pair; pad: no conflicts

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       OutT* __restrict__ out, int M, int N, int K,
                       int x_vec, int w_vec) {
  constexpr int BM = 16 * MT;
  constexpr int XV = BM * kBK / 8 / kThreads;    // 16 B x vectors / thread
  __shared__ __align__(16) __nv_bfloat16 xs[BM][kBK + kXPad];
  // k pair p, column c: bytes (2p, c), (2p + 1, c) at [p][2 c], [p][2 c + 1]
  __shared__ __align__(16) uint8_t ws[kBK / 2][kWRow];

  const int tr = blockIdx.z;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const __nv_bfloat16* xt = x + (size_t)tr * M * K;
  const int8_t* wt = w + (size_t)tr * K * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;       // mma fragment row / k pair
  const int wp = tid >> 2, wc = (tid & 3) * 16;  // this thread's k pair, columns

  uint4 xr[XV], wr[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * kThreads;
      xr[j] = load_x16(xt, M, K, m0 + i / (kBK / 8), k0 + (i % (kBK / 8)) * 8,
                       x_vec);
    }
    wr[0] = load_w16(wt, K, N, k0 + 2 * wp, n0 + wc, w_vec);
    wr[1] = load_w16(wt, K, N, k0 + 2 * wp + 1, n0 + wc, w_vec);
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * kThreads;
      *reinterpret_cast<uint4*>(&xs[i / (kBK / 8)][(i % (kBK / 8)) * 8]) = xr[j];
    }
    {  // rows 2 wp and 2 wp + 1 interleaved byte by byte
      const uint32_t* a = reinterpret_cast<const uint32_t*>(&wr[0]);
      const uint32_t* b = reinterpret_cast<const uint32_t*>(&wr[1]);
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = __byte_perm(a[j], b[j], 0x5140);
        v[2 * j + 1] = __byte_perm(a[j], b[j], 0x7362);
      }
      *reinterpret_cast<uint4*>(&ws[wp][2 * wc]) =
          make_uint4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<uint4*>(&ws[wp][2 * wc + 16]) =
          make_uint4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * kBK);      // in flight during the math
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      const int k = kk + 2 * t4;
      const int c = warp * 16 + 2 * g;
      // (k, k + 1) and (k + 8, k + 9) at columns c and c + 1
      const uint2 lo = widen4_bf16(
          *reinterpret_cast<const uint32_t*>(&ws[k / 2][2 * c]));
      const uint2 hi = widen4_bf16(
          *reinterpret_cast<const uint32_t*>(&ws[k / 2 + 4][2 * c]));
      const uint32_t b[2][2] = {{lo.x, hi.x}, {lo.y, hi.y}};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + g;
        const uint32_t a[4] = {
            *reinterpret_cast<const uint32_t*>(&xs[r][k]),
            *reinterpret_cast<const uint32_t*>(&xs[r + 8][k]),
            *reinterpret_cast<const uint32_t*>(&xs[r][k + 8]),
            *reinterpret_cast<const uint32_t*>(&xs[r + 8][k + 8])};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
    __syncthreads();
  }

  // epilogue: the per-column scale on the fp32 accumulator
  const float* st = scale + (size_t)tr * N;
  OutT* ot = out + (size_t)tr * M * N;
  const int c = n0 + warp * 16 + 4 * t4;
  float s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = c + j < N ? st[c + j] : 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + mt * 16 + g + 8 * h;
      if (r >= M) continue;
      const float v[4] = {acc[mt][0][2 * h] * s[0], acc[mt][1][2 * h] * s[1],
                          acc[mt][0][2 * h + 1] * s[2],
                          acc[mt][1][2 * h + 1] * s[3]};
      store4(ot + (size_t)r * N, c, N, v, N % 4 == 0);
    }
}

// ---------------------------------------------------------------------------
// fma_m16 / fma_m64: fp32 x, FMA on the CUDA cores.  Thread (ty, tx) of a
// 8 x 16 grid owns RM rows and 4 adjacent columns of the tile.
// ---------------------------------------------------------------------------
constexpr int kXPadF = 4;               // fp32 per x tile row (16 B aligned)
constexpr int kWPad = 16;               // int8 tile row pad: no bank conflicts

template <int MT, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_fma_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       OutT* __restrict__ out, int M, int N, int K,
                       int x_vec, int w_vec) {
  constexpr int BM = 16 * MT;
  constexpr int RM = BM / 8;                     // rows per thread
  constexpr int XV = BM * kBK / 4 / kThreads;    // 16 B x vectors / thread
  constexpr int WV = kBK * kBN / 16 / kThreads;
  __shared__ __align__(16) float xs[BM][kBK + kXPadF];
  __shared__ __align__(16) int8_t ws[kBK][kBN + kWPad];

  const int tr = blockIdx.z;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const float* xt = x + (size_t)tr * M * K;
  const int8_t* wt = w + (size_t)tr * K * N;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  uint4 xr[XV], wr[WV];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * kThreads;
      xr[j] = load_x16(xt, M, K, m0 + i / (kBK / 4), k0 + (i % (kBK / 4)) * 4,
                       x_vec);
    }
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int i = tid + j * kThreads;
      wr[j] = load_w16(wt, K, N, k0 + i / (kBN / 16), n0 + (i % (kBN / 16)) * 16,
                       w_vec);
    }
  };

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * kThreads;
      *reinterpret_cast<uint4*>(&xs[i / (kBK / 4)][(i % (kBK / 4)) * 4]) = xr[j];
    }
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int i = tid + j * kThreads;
      *reinterpret_cast<uint4*>(&ws[i / (kBN / 16)][(i % (kBN / 16)) * 16]) =
          wr[j];
    }
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * kBK);
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float wf[4];
      widen4(*reinterpret_cast<const uint32_t*>(&ws[k][tx * 4]), wf);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float xv = xs[ty * RM + i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, wf[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const float* st = scale + (size_t)tr * N;
  OutT* ot = out + (size_t)tr * M * N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + tx * 4 + j;
    if (c >= N) continue;
    const float s = st[c];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = m0 + ty * RM + i;
      if (r < M) store1(ot + (size_t)r * N + c, acc[i][j] * s);
    }
  }
}

// ---------------------------------------------------------------------------
// fma_rows: fp32 x with M <= MR rows (the LM head at decode).  A block owns
// 128 columns and every row; warp kg takes rows kg * 8 .. + 7 of each
// 64-deep stage, lane cg columns 4 cg .. + 3, so each weight is read as a
// word and widened once.  Stages arrive by cp.async (w in 16-byte copies,
// x transposed to [k][m] in 4-byte copies so a k step's rows are one
// broadcast read); the eight partial sums meet in shared memory.
// ---------------------------------------------------------------------------
namespace rows {
constexpr int kThreads = 256, kBN = 128, kBK = 64, kStages = 4;
constexpr int kGroups = kThreads / 32;           // k groups (warps)
constexpr int kRed = 8;                          // rows per reduction pass
}  // namespace rows

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

template <int MR, typename OutT>
__global__ void __launch_bounds__(rows::kThreads)
int8_matmul_rows_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        OutT* __restrict__ out, int M, int N, int K) {
  constexpr int T = rows::kThreads, BN = rows::kBN, BK = rows::kBK;
  constexpr int S = rows::kStages, G = rows::kGroups, R = rows::kRed;
  static_assert(MR % R == 0, "MR is a multiple of the reduction pass");
  static_assert(S * BK * BN >= G * R * BN * 4,
                "the reduction reuses the weight ring");
  __shared__ __align__(16) int8_t ws[S][BK][BN];
  __shared__ __align__(16) float xs[S][BK][MR];

  const int tr = blockIdx.z, n0 = blockIdx.x * BN;
  const float* xt = x + (size_t)tr * M * K;
  const int8_t* wt = w + (size_t)tr * K * N;
  const int tid = threadIdx.x, kg = tid >> 5, cg = tid & 31;

  auto load = [&](int t, int s) {
    const int k0 = t * BK;
#pragma unroll
    for (int j = 0; j < BK * BN / 16 / T; ++j) {
      const int i = tid + j * T;
      const int k = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const bool in = k0 + k < K && n0 + c < N;
      cp_async16(&ws[s][k][c], in ? wt + (size_t)(k0 + k) * N + n0 + c : wt,
                 in ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < BK * MR / T; ++j) {
      const int i = tid + j * T;
      const int m = i / BK, k = i % BK;
      const bool in = m < M && k0 + k < K;
      cp_async4(&xs[s][k][m], in ? xt + (size_t)m * K + k0 + k : xt,
                in ? 4 : 0);
    }
  };

  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int t = 0; t < nk; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2) : "memory");
    __syncthreads();   // stage t landed for all; stage t - 1 is free
    if (t + S - 1 < nk) load(t + S - 1, (t + S - 1) % S);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int s = t % S;
#pragma unroll
    for (int i = 0; i < BK / G; ++i) {
      const int k = kg * (BK / G) + i;
      float wf[4];
      widen4(*reinterpret_cast<const uint32_t*>(&ws[s][k][cg * 4]), wf);
#pragma unroll
      for (int m4 = 0; m4 < MR; m4 += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[s][k][m4]);
        const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[m4 + m][j] = fmaf(xm[m], wf[j], acc[m4 + m][j]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // the k groups' partial sums meet in the (now idle) weight ring
  float* red = reinterpret_cast<float*>(&ws[0][0][0]);  // [G][R][BN]
  const float* st = scale + (size_t)tr * N;
  OutT* ot = out + (size_t)tr * M * N;
  const int om = tid / (BN / 4), oc = (tid % (BN / 4)) * 4;  // output slot
  const int c = n0 + oc;
  float s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = c + j < N ? st[c + j] : 0.f;
#pragma unroll
  for (int p = 0; p < MR; p += R) {
#pragma unroll
    for (int m = 0; m < R; ++m)
      *reinterpret_cast<float4*>(&red[(kg * R + m) * BN + cg * 4]) =
          make_float4(acc[p + m][0], acc[p + m][1], acc[p + m][2],
                      acc[p + m][3]);
    __syncthreads();
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const float4 r = *reinterpret_cast<const float4*>(
          &red[(q * R + om) * BN + oc]);
      v[0] += r.x, v[1] += r.y, v[2] += r.z, v[3] += r.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] *= s[j];
    if (p + om < M) store4(ot + (size_t)(p + om) * N, c, N, v, true);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// wgmma_tma: bf16 x on wgmma, fed by TMA.  The product runs transposed,
// out^T = w^T x^T: the widened weight is wgmma's register operand A (its
// rows are output columns) and the x tile, as TMA lands it, is operand B
// (its rows are x rows, K-major).  One persistent block (CTA) per SM walks
// output tiles of 256 x rows by 128 columns of a track: warpgroup cw owns
// columns 64 cw .. + 63 and all 256 rows (one m64n256k16 product per k16
// step), widening its own columns straight from the int8 stage into its
// A fragments while the previous stage's products run; warpgroup 0 gives
// up its registers to them, and one of its threads issues the loads, on
// into the next tile's stages during an epilogue.
// ---------------------------------------------------------------------------
namespace wg {
constexpr int kBM = 256, kBN = 128, kBK = 64;
constexpr int kStages = 4;              // TMA ring (x + w per stage)
constexpr int kThreads = 384;           // a producer and two consumer warpgroups
constexpr int kXBytes = kBM * kBK * 2;  // 32 KB, 128-byte rows, swizzled
constexpr int kWBytes = kBK * kBN;      // 8 KB, 128-byte rows, swizzled
constexpr int kOBytes = 64 * 1024;      // output staging
constexpr int kSmem = kStages * (kXBytes + kWBytes) + kOBytes +
                      2 * kStages * 8 + 1024;   // + barriers, alignment
}  // namespace wg

// d[128] = A (64 x 16, bf16 pairs in registers) * B (16 x 256, K-major in
// shared memory) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_m64n256k16_rs(float* d, const uint32_t* a,
                                                    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// This thread's A fragments for one 64-deep stage: its two columns c, c + 1
// are fragment rows g and g + 8; for each k16 step, the k pairs (2 t4, +1)
// and (2 t4 + 8, +9).  fetch_a reads the int8 stage (128-byte rows, 16-byte
// chunks stored at chunk ^ k%8; the bytes of a row at c, c + 1 are one
// load); widen_a turns them into the bf16 fragments.
__device__ __forceinline__ void fetch_a(const uint8_t* wst, int c, int t4,
                                        uint32_t (&h)[16]) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int k = 16 * (q >> 2) + 2 * t4 + (q & 1) + 8 * ((q >> 1) & 1);
    h[q] = *reinterpret_cast<const uint16_t*>(
        wst + k * 128 + ((((c >> 4) ^ (k & 7)) << 4) | (c & 15)));
  }
}

__device__ __forceinline__ void widen_a(const uint32_t (&h)[16],
                                        uint32_t (&a)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // (k, c), (k + 1, c), (k, c + 1), (k + 1, c + 1): the two rows' pairs
    const uint2 lo = widen4_bf16(__byte_perm(h[4 * kk], h[4 * kk + 1], 0x5140));
    const uint2 hi =
        widen4_bf16(__byte_perm(h[4 * kk + 2], h[4 * kk + 3], 0x5140));
    a[4 * kk] = lo.x, a[4 * kk + 1] = lo.y;
    a[4 * kk + 2] = hi.x, a[4 * kk + 3] = hi.y;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(wg::kThreads, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap omap,
                         const float* __restrict__ scale, int n, int M,
                         int N, int K) {
  constexpr int BM = wg::kBM, BN = wg::kBN, BK = wg::kBK, S = wg::kStages;
  constexpr int XB = wg::kXBytes, WB = wg::kWBytes;
  constexpr int CB = 128 / sizeof(OutT);        // output columns per box
  constexpr int RP = 4 * CB;                    // box rows: 32 KB a pass
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ws = xs + S * XB;
  uint8_t* os = ws + S * WB;            // output staging, 32 KB a warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(os + wg::kOBytes);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  // stages per tile, rounded up to even (the consumers take two at a time;
  // TMA zero-fills a stage past K)
  const int nk = (K + 2 * BK - 1) / (2 * BK) * 2;
  // tiles in the order (track, row block, column block), columns fastest:
  // the tiles in flight at once share their x rows and w columns in L2
  const int tn = (N + BN - 1) / BN, tm = (M + BM - 1) / BM;
  const int tiles = tn * tm * n;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {                      // producer: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int it = 0;                       // stages filled, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % tn) * BN, m0 = (tile / tn % tm) * BM;
        const int tr = tile / (tn * tm);
        for (int t = 0; t < nk; ++t, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], XB + WB);
          tma_load_3d(xs + s * XB, &xmap, &full[s], t * BK, m0, tr);
          tma_load_3d(ws + s * WB, &wmap, &full[s], n0, t * BK, tr);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = tid - 128;             // consumer thread
  const int cw = ct >> 7;               // warpgroup: columns 64 cw .. + 63
  const int lane = ct & 31, wq = (ct >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int cc = cw * 64 + wq * 16 + 2 * g;     // this thread's columns cc, +1
  const int total = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x * nk;        // stages this CTA consumes
  float d[128];                         // each tile's first product overwrites
  uint32_t a0[16], a1[16];              // A fragments of even / odd stages

  // one stage's products; while they run, the bytes of stage `it + 1`
  // load (its wait guarded: past the last stage none comes), the stage
  // before is then done and goes back to TMA, and the bytes widen into
  // the fragments it held.  No branch holds a wgmma or its wait: the
  // compiler would serialize them.
  auto stage = [&](int it, int t, const uint32_t (&cur)[16],
                   uint32_t (&nxt)[16]) {
    const int s = it % S;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16_rs(d, cur + 4 * kk, sw128_desc(xs + s * XB + kk * 32),
                          t > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (it + 1 < total) mbar_wait(&full[(it + 1) % S], ((it + 1) / S) & 1);
    uint32_t h[16];
    fetch_a(ws + (it + 1) % S * WB, cc, t4, h);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(d);
    if (t > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
    widen_a(h, nxt);
  };

  if (total > 0) {
    mbar_wait(&full[0], 0);
    uint32_t h[16];
    fetch_a(ws, cc, t4, h);
    widen_a(h, a0);
  }
  int it = 0;                           // stages consumed, over all tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % tn) * BN, m0 = (tile / tn % tm) * BM;
    const int tr = tile / (tn * tm);
    for (int t = 0; t < nk; t += 2, it += 2) {   // nk is even
      stage(it, t, a0, a1);
      stage(it + 1, t + 1, a1, a0);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);

    // epilogue: d[4 j + 2 e + f] is column cc + e, x row 8 j + 2 t4 + f.
    // This warpgroup's 64 columns go through its 32 KB of staging as
    // 128-byte-wide boxes (CB columns, RP rows), swizzled as the output
    // map reads them, in 256 / RP passes; one thread stores each pass with
    // TMA, which clips the ragged M and N edges, while the next tile runs.
    const float* st = scale + (size_t)tr * N;
    const float s0 = n0 + cc < N ? st[n0 + cc] : 0.f;
    const float s1 = n0 + cc + 1 < N ? st[n0 + cc + 1] : 0.f;
    uint8_t* stage_o = os + cw * (wg::kOBytes / 2);
    const int cl = wq * 16 + 2 * g;     // column in this warpgroup's 64
    uint8_t* box = stage_o + cl / CB * (RP * 128);
    const int cb = cl % CB * (int)sizeof(OutT);  // byte in a box row
    constexpr int JP = RP / 8;          // j steps per pass
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {  // one loop, unrolled: d's index fixed
      if (j % JP == 0) {
        if ((ct & 127) == 0)            // the last pass's boxes are read
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
      }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int r = 8 * (j % JP) + 2 * t4 + f;
        store2(reinterpret_cast<OutT*>(
                   box + r * 128 + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15))),
               d[4 * j + f] * s0, d[4 * j + 2 + f] * s1);
      }
      if (j % JP == JP - 1) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
        if ((ct & 127) == 0) {
          for (int i = 0; i < 64 / CB; ++i)
            tma_store_3d(&omap, stage_o + i * (RP * 128),
                         n0 + cw * 64 + i * CB, m0 + j / JP * RP, tr);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
  }
  if ((ct & 127) == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A 3-D map over [n][rows][inner] with a [1][box_rows][box_inner] box,
// 128-byte swizzle, zeros outside the tensor.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                const void* base, int n, int rows, int inner, int box_inner,
                int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * elem_bytes,
                                 (cuuint64_t)inner * rows * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};
  return hopper::tensor_map(map, type, 3, base, dims, strides, box);
}

// route codes, as quant_matmul.py::ROUTES
enum Route { kWgmma = 0, kMma16, kMma64, kFmaRows, kFma16, kFma64 };

template <typename OutT>
int launch(const void* x, const int8_t* w, const float* sp, OutT* op, int n,
           int M, int N, int K, int dtype, int route, cudaStream_t s) {
  const int w_vec = (N % 16 == 0) && aligned16(w);
  if (route == kWgmma) {
    if (dtype != rt::kBFloat16 || K % 8 || N % 16 || !aligned16(x) ||
        !aligned16(w) || !aligned16(op))
      return (int)cudaErrorInvalidValue;
    CUtensorMap xmap, wmap, omap;
    if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, n, M, K,
                    wg::kBK, wg::kBM) ||
        !tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, n, K, N,
                    wg::kBN, wg::kBK) ||
        !tensor_map(&omap,
                    sizeof(OutT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    sizeof(OutT), op, n, M, N, 128 / sizeof(OutT),
                    4 * 128 / sizeof(OutT)))    // the kernel's CB, RP
      return (int)cudaErrorInvalidValue;
    static int sms = 0;                 // once: attributes and SM count
    if (sms == 0) {
      int dev = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(int8_matmul_wgmma_kernel<float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 wg::kSmem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(int8_matmul_wgmma_kernel<__nv_bfloat16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 wg::kSmem);
      if (e != cudaSuccess) {
        sms = 0;
        return (int)e;
      }
    }
    const long tiles = (long)((N + wg::kBN - 1) / wg::kBN) *
                       ((M + wg::kBM - 1) / wg::kBM) * n;
    const int blocks = (int)(tiles < sms ? tiles : sms);
    int8_matmul_wgmma_kernel<OutT><<<blocks, wg::kThreads, wg::kSmem, s>>>(
        xmap, wmap, omap, sp, n, M, N, K);
  } else if (route == kMma16 || route == kMma64) {
    if (dtype != rt::kBFloat16) return (int)cudaErrorInvalidValue;
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    const int x_vec = (K % 8 == 0) && aligned16(x);
    const int bm = route == kMma16 ? 16 : 64;
    const dim3 grid((N + kBN - 1) / kBN, (M + bm - 1) / bm, n);
    if (route == kMma16)
      int8_matmul_mma_kernel<1, OutT><<<grid, kThreads, 0, s>>>(
          xp, w, sp, op, M, N, K, x_vec, w_vec);
    else
      int8_matmul_mma_kernel<4, OutT><<<grid, kThreads, 0, s>>>(
          xp, w, sp, op, M, N, K, x_vec, w_vec);
  } else if (route == kFmaRows) {
    if (dtype != rt::kFloat32 || M > 16 || !w_vec)
      return (int)cudaErrorInvalidValue;
    const float* xp = static_cast<const float*>(x);
    const dim3 grid((N + rows::kBN - 1) / rows::kBN, 1, n);
    if (M <= 8)
      int8_matmul_rows_kernel<8, OutT><<<grid, rows::kThreads, 0, s>>>(
          xp, w, sp, op, M, N, K);
    else
      int8_matmul_rows_kernel<16, OutT><<<grid, rows::kThreads, 0, s>>>(
          xp, w, sp, op, M, N, K);
  } else if (route == kFma16 || route == kFma64) {
    if (dtype != rt::kFloat32) return (int)cudaErrorInvalidValue;
    const float* xp = static_cast<const float*>(x);
    const int x_vec = (K % 4 == 0) && aligned16(x);
    const int bm = route == kFma16 ? 16 : 64;
    const dim3 grid((N + kBN - 1) / kBN, (M + bm - 1) / bm, n);
    if (route == kFma16)
      int8_matmul_fma_kernel<1, OutT><<<grid, kThreads, 0, s>>>(
          xp, w, sp, op, M, N, K, x_vec, w_vec);
    else
      int8_matmul_fma_kernel<4, OutT><<<grid, kThreads, 0, s>>>(
          xp, w, sp, op, M, N, K, x_vec, w_vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, M, K] (fp32 or bf16, `dtype`); w [n, K, N] int8; scale [n, 1, N]
// fp32; out [n, M, N] of `out_dtype` (fp32 or bf16).  All contiguous, on
// one device.  `route` is a code of quant_matmul.py::ROUTES.  Returns
// cudaGetLastError() after the launch, or an error code for a route the
// arguments do not fit.
extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* out, int n, int M,
                                  int N, int K, int dtype, int out_dtype,
                                  int route, void* stream) {
  if (n <= 0 || M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  if (out_dtype == rt::kFloat32)
    return launch(x, wp, sp, static_cast<float*>(out), n, M, N, K, dtype,
                  route, s);
  if (out_dtype == rt::kBFloat16)
    return launch(x, wp, sp, static_cast<__nv_bfloat16*>(out), n, M, N, K,
                  dtype, route, s);
  return (int)cudaErrorInvalidValue;
}
