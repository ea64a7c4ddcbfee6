// W8A16 matrix product for Hopper: x @ int8 w with a per-output-column
// fp32 scale applied to the fp32 accumulator, every Parallel-Track track
// of a projection in one launch.
//
// Replaces the Pallas kernel repro/kernels/quant_matmul.py::int8_matmul
// (_kernel): x [M, K] float, w [K, N] int8, scale [1, N] fp32 -> [M, N]
// fp32.  Here with a leading track dim: x [n, M, K], w [n, K, N],
// scale [n, 1, N], out [n, M, N].
//
// Bound on the H100: at decode (M = 8 rows per track) bytes -- each int8
// weight feeds 2 * M flops, far below the ~295 flop/byte ridge, so the
// kernel can at best stream the weight at 3.35 TB/s; at prefill (M in
// the thousands) operations, on the tensor cores.
// Design:
//   * the weight crosses device memory as int8 and is widened in
//     registers: int8 -> bf16 is exact (|q| <= 127 fits the 8-bit
//     significand), so bf16 x runs mma.sync m16n8k16 with fp32
//     accumulators; fp32 x runs FMA on the CUDA cores (no TF32), as the
//     Pallas kernel upcasts both operands to fp32;
//   * the scale multiplies the accumulator once, in the epilogue;
//   * grid (N / 64, M / BM, n): N is split across blocks so a decode
//     step streams each weight byte once, with BM = 16 rows when M <= 16
//     (decode) and 64 otherwise (prefill);
//   * 64-deep k tiles, 16-byte loads; the next tile's loads are issued
//     into registers before the current tile is multiplied, so loads and
//     math overlap within a block.
// wgmma with TMA pipelining is left to a later optimisation.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 64;                 // output columns per block
constexpr int kBK = 64;                 // contraction depth per tile
constexpr int kWPad = 16;               // int8 tile row pad: no bank conflicts

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two int8 weights as one bf16 pair (exact), the lower k in the low half
__device__ __forceinline__ uint32_t pack_i8(int8_t lo, int8_t hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

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

// ---------------------------------------------------------------------------
// bf16 x: tensor cores.  Warp w owns tile columns [16 w, 16 w + 16) (two n8
// tiles) for all MT m16 row tiles.
// ---------------------------------------------------------------------------
constexpr int kXPad = 8;                // bf16 per x tile row

template <int MT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int M, int N, int K,
                       int x_vec, int w_vec) {
  constexpr int BM = 16 * MT;
  constexpr int XV = BM * kBK / 8 / kThreads;    // 16 B x vectors / thread
  constexpr int WV = kBK * kBN / 16 / kThreads;  // 16 B w vectors / thread
  __shared__ __align__(16) __nv_bfloat16 xs[BM][kBK + kXPad];
  __shared__ __align__(16) int8_t ws[kBK][kBN + kWPad];

  const int tr = blockIdx.z;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const __nv_bfloat16* xt = x + (size_t)tr * M * K;
  const int8_t* wt = w + (size_t)tr * K * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;       // mma fragment row / k pair

  uint4 xr[XV], wr[WV];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * kThreads;
      xr[j] = load_x16(xt, M, K, m0 + i / (kBK / 8), k0 + (i % (kBK / 8)) * 8,
                       x_vec);
    }
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int i = tid + j * kThreads;
      wr[j] = load_w16(wt, K, N, k0 + i / (kBN / 16), n0 + (i % (kBN / 16)) * 16,
                       w_vec);
    }
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
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int i = tid + j * kThreads;
      *reinterpret_cast<uint4*>(&ws[i / (kBN / 16)][(i % (kBN / 16)) * 16]) =
          wr[j];
    }
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * kBK);      // in flight during the math
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      const int k = kk + 2 * t4;
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = warp * 16 + nt * 8 + g;
        b[nt][0] = pack_i8(ws[k][n], ws[k + 1][n]);
        b[nt][1] = pack_i8(ws[k + 8][n], ws[k + 9][n]);
      }
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
  float* ot = out + (size_t)tr * M * N;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int c = n0 + warp * 16 + nt * 8 + 2 * t4;
    const float s0 = c < N ? st[c] : 0.f;
    const float s1 = c + 1 < N ? st[c + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + mt * 16 + g + 8 * h;
        if (r >= M) continue;
        if (c < N) ot[(size_t)r * N + c] = acc[mt][nt][2 * h] * s0;
        if (c + 1 < N) ot[(size_t)r * N + c + 1] = acc[mt][nt][2 * h + 1] * s1;
      }
  }
}

// ---------------------------------------------------------------------------
// fp32 x: FMA on the CUDA cores.  Thread (ty, tx) of a 8 x 16 grid owns RM
// rows and 4 adjacent columns of the tile.
// ---------------------------------------------------------------------------
constexpr int kXPadF = 4;               // fp32 per x tile row (16 B aligned)

template <int MT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_fma_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int M, int N, int K,
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
      const char4 wq = *reinterpret_cast<const char4*>(&ws[k][tx * 4]);
      const float wf[4] = {(float)wq.x, (float)wq.y, (float)wq.z, (float)wq.w};
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
  float* ot = out + (size_t)tr * M * N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + tx * 4 + j;
    if (c >= N) continue;
    const float s = st[c];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = m0 + ty * RM + i;
      if (r < M) ot[(size_t)r * N + c] = acc[i][j] * s;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x [n, M, K] (fp32 or bf16); w [n, K, N] int8; scale [n, 1, N] fp32;
// out [n, M, N] fp32.  All contiguous, on one device.  Returns
// cudaGetLastError() after the launch.
extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* out, int n, int M,
                                  int N, int K, int dtype, void* stream) {
  if (n <= 0 || M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w_vec = (N % 16 == 0) && aligned16(w);
  const bool decode = M <= 16;          // BM = 16 rows, else 64
  const int bm = decode ? 16 : 64;
  const dim3 grid((N + kBN - 1) / kBN, (M + bm - 1) / bm, n);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (dtype == rt::kBFloat16) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    const int x_vec = (K % 8 == 0) && aligned16(x);
    if (decode)
      int8_matmul_mma_kernel<1><<<grid, kThreads, 0, s>>>(xp, wp, sp, op, M,
                                                          N, K, x_vec, w_vec);
    else
      int8_matmul_mma_kernel<4><<<grid, kThreads, 0, s>>>(xp, wp, sp, op, M,
                                                          N, K, x_vec, w_vec);
  } else if (dtype == rt::kFloat32) {
    const float* xp = static_cast<const float*>(x);
    const int x_vec = (K % 4 == 0) && aligned16(x);
    if (decode)
      int8_matmul_fma_kernel<1><<<grid, kThreads, 0, s>>>(xp, wp, sp, op, M,
                                                          N, K, x_vec, w_vec);
    else
      int8_matmul_fma_kernel<4><<<grid, kThreads, 0, s>>>(xp, wp, sp, op, M,
                                                          N, K, x_vec, w_vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
