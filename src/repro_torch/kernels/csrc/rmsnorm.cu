// (1 + scale)-RMSNorm with the residual add before it and, in a
// Parallel-Track model, the track-fusion mean: three routes of one kernel
// source (sm_90a).
//
// Replaces src/repro/kernels/rmsnorm.py::rmsnorm (the Pallas _kernel: a
// block of rows per grid step, each row kept in VMEM between the variance
// and the scale).  The JAX model computes the same function in jnp
// (repro/models/norms.py), after its residual add (repro/models/layers.py)
// and, at a track-block boundary, its fusion mean (repro/core/track.py
// _fuse); the routes fold those into the norm:
//
//   norm       y = cast(x * rsqrt(mean(x^2) + eps) * (1 + s))
//   add_norm   x' = cast(x + delta); y = norm(x')            writes x', y
//   fuse_norm  x'_t = cast(x_t + delta_t) for each track t (x_t itself
//              when delta is null: a track rank's boundary, whose x + delta
//              was added and rounded before its rows were gathered);
//              f = cast(sum_t x'_t / div) (div = n for the mean, 1 for
//              the sum); y_u = norm(f) * (1 + s_u)           writes f, y
//
// All math is fp32, and x' and f are rounded to the storage dtype before
// anything reads them, where the unfused sequence of PyTorch ops rounds
// (its plain version in kernels/rmsnorm.py is that sequence).  The
// product is (x * r) * (1 + s), two roundings, as the plain version.
//
// Layout: x is [n, M, d] (n tracks, M positions) with an element stride
// between tracks that may be 0: one fused row [M, d] that every track
// reads, the broadcast that takes the place of a copy after a fusion;
// delta and x' are [n, M, d], y is [n_y, M, d], all contiguous; s is
// fp32, one row [d] for every track or one row per track [n, d].
//
// Bound on the H100: bytes (a few flops per element).  At the decode shapes
// one call moves 10-60 KB, so its floor is latency, not bandwidth: the
// launch, one DRAM round trip for the loads and the reduction.  The design
// keeps that to one round trip and moves each byte once.  A thread owns
// VPT 16-byte vectors of a row (8 bf16 or 4 fp32; VPT = 1 up to rows of
// 512 vectors, so a row is spread over as many threads as it has vectors),
// and issues every load it needs at once, as raw 16-byte words unpacked
// where they are used:
//   * rows_kernel (norm, add_norm): one CTA per row; x, delta and the
//     scale row's vectors are loaded together, x' stays in registers
//     between the reduction (warp shuffles, then shared memory across the
//     row's warps) and the scale, and x' and y are written once;
//   * fuse_kernel (fuse_norm): one CTA per position; each thread sums its
//     column vectors over the n tracks in registers, in track order (G
//     tracks' loads in flight at once), so the cross-track mean needs no
//     shared memory and no extra pass; it issues the scale rows' loads
//     before the one CTA reduction of f's squares, so they land while it
//     runs.
// Several rows per CTA, and rows kept in registers beside their scale rows
// read after the reduction, were tried on the card and did not pay.  Every
// sum runs in a fixed order, so a launch is bitwise repeatable and a CUDA
// graph's replay equals the eager call.
#include "common.cuh"

namespace {

constexpr int kNorm = 0;
constexpr int kAddNorm = 1;
constexpr int kFuseNorm = 2;

// 16 bytes of fp32 values back to T (round to nearest even)
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

// 16 bytes loaded as they are, unpacked to fp32 where they are used: a
// thread can keep many loads in flight in few registers
__device__ __forceinline__ uint4 load_raw(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& a, float* v);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& a, float* v) {
  v[0] = __uint_as_float(a.x); v[1] = __uint_as_float(a.y);
  v[2] = __uint_as_float(a.z); v[3] = __uint_as_float(a.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& a,
                                                     float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// the fp32 value that v rounds to in T
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the E fp32 scale values under one vector of T: E / 4 raw words
template <int E>
__device__ __forceinline__ void load_scale(const float* s, uint4* w) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) w[i] = load_raw(s + 4 * i);
}

// w = 1 + s from the raw scale words
template <int E>
__device__ __forceinline__ void weight(const uint4* raw, float* w) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) unpack<float>(raw[i], w + 4 * i);
#pragma unroll
  for (int i = 0; i < E; ++i) w[i] = 1.0f + w[i];
}

// The sum of v over the block (blockDim.x a multiple of 32), the same bits
// in every thread.  Every thread calls it once: it synchronises the block
// when the block has several warps.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = rt::warp_sum(v);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < warps; ++i) s += red[i];
  return s;
}

// norm (ADD false) and add_norm (ADD true): CTA r is row r of the n * M
// rows, track t = r / M, position m = r % M.
template <typename T, int VPT, bool ADD>
__global__ void __launch_bounds__(512) rows_kernel(
    const T* __restrict__ x, int64_t x_track, const T* __restrict__ delta,
    T* __restrict__ x_out, T* __restrict__ y,
    const float* __restrict__ scale, int64_t s_track, int M, int d,
    float eps) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float red[32];
  const int t = blockIdx.x / M;
  const int64_t row = blockIdx.x;
  const T* xr = x + t * x_track + (row - (int64_t)t * M) * d;
  const float* sr = scale + t * s_track;
  const int dv = d / E;
  uint4 rx[VPT], rd[VPT], rs[VPT][E / 4];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < dv) {
      rx[k] = load_raw(xr + c * E);
      if (ADD) rd[k] = load_raw(delta + row * d + c * E);
      load_scale<E>(sr + c * E, rs[k]);
    }
  }
  float v[VPT][E];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < dv) {
      unpack<T>(rx[k], v[k]);
      if (ADD) {
        float dl[E];
        unpack<T>(rd[k], dl);
#pragma unroll
        for (int e = 0; e < E; ++e) v[k][e] = round_to<T>(v[k][e] + dl[e]);
        store16(x_out + row * d + c * E, v[k]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) ss += v[k][e] * v[k][e];
    }
  }
  ss = block_sum(ss, red);
  const float r = rsqrtf(__fdiv_rn(ss, (float)d) + eps);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < dv) {
      float w[E], o[E];
      weight<E>(rs[k], w);
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = __fmul_rn(__fmul_rn(v[k][e], r), w[e]);
      store16(y + row * d + c * E, o);
    }
  }
}

// fuse_norm: CTA m is position m; f [M, d]; y [ns, M, d] with scale row u
// for y row u (ns <= n: a track rank normalises under its own rows only).
// ADD false reads no delta: x'_t = x_t, the bits ADD true gives for a zero
// delta (x + 0 rounds to x).
template <typename T, int VPT, bool ADD>
__global__ void __launch_bounds__(512) fuse_kernel(
    const T* __restrict__ x, int64_t x_track, const T* __restrict__ delta,
    T* __restrict__ f_out, T* __restrict__ y,
    const float* __restrict__ scale, int n, int M, int d, int ns, float div,
    float eps) {
  constexpr int E = 16 / sizeof(T);
  constexpr int G = 8 / VPT;       // tracks loaded at once; scale rows too
  __shared__ float red[32];
  const int64_t m = blockIdx.x;
  const int dv = d / E;
  float acc[VPT][E];
#pragma unroll
  for (int k = 0; k < VPT; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[k][e] = 0.0f;
  for (int t0 = 0; t0 < n; t0 += G) {
    uint4 ra[G][VPT], rb[G][VPT];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int t = t0 + i, c = threadIdx.x + k * blockDim.x;
        if (t < n && c < dv) {
          ra[i][k] = load_raw(x + t * x_track + m * d + c * E);
          if (ADD)
            rb[i][k] = load_raw(delta + ((int64_t)t * M + m) * d + c * E);
        }
      }
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int c = threadIdx.x + k * blockDim.x;
        if (t0 + i < n && c < dv) {
          float a[E];
          unpack<T>(ra[i][k], a);
          if (ADD) {
            float b[E];
            unpack<T>(rb[i][k], b);
#pragma unroll
            for (int e = 0; e < E; ++e) a[e] = round_to<T>(a[e] + b[e]);
          }
#pragma unroll
          for (int e = 0; e < E; ++e) acc[k][e] += a[e];
        }
      }
  }
  float ss = 0.0f;
  uint4 rs[G][VPT][E / 4];          // the first G scale rows
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < dv) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[k][e] = round_to<T>(__fdiv_rn(acc[k][e], div));
        ss += acc[k][e] * acc[k][e];
      }
      store16(f_out + m * d + c * E, acc[k]);
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (u < ns) load_scale<E>(scale + (int64_t)u * d + c * E, rs[u][k]);
    }
  }
  ss = block_sum(ss, red);
  const float r = rsqrtf(__fdiv_rn(ss, (float)d) + eps);
  for (int u0 = 0; u0 < ns; u0 += G) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int u = u0 + i;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int c = threadIdx.x + k * blockDim.x;
        if (u < ns && c < dv) {
          if (u0) load_scale<E>(scale + (int64_t)u * d + c * E, rs[i][k]);
          float w[E], o[E];
          weight<E>(rs[i][k], w);
#pragma unroll
          for (int e = 0; e < E; ++e)
            o[e] = __fmul_rn(__fmul_rn(acc[k][e], r), w[e]);
          store16(y + ((int64_t)u * M + m) * d + c * E, o);
        }
      }
    }
  }
}

template <typename T, int VPT>
cudaError_t launch_vpt(int route, const void* x, int64_t x_track,
                       const void* delta, void* x_out, void* y,
                       const float* scale, int64_t s_track, int n, int M,
                       int d, int ns, float div, float eps, int threads,
                       cudaStream_t st) {
  if (route == kFuseNorm && delta != nullptr) {
    fuse_kernel<T, VPT, true><<<M, threads, 0, st>>>(
        (const T*)x, x_track, (const T*)delta, (T*)x_out, (T*)y, scale, n, M,
        d, ns, div, eps);
  } else if (route == kFuseNorm) {
    fuse_kernel<T, VPT, false><<<M, threads, 0, st>>>(
        (const T*)x, x_track, nullptr, (T*)x_out, (T*)y, scale, n, M, d, ns,
        div, eps);
  } else if (route == kAddNorm) {
    rows_kernel<T, VPT, true><<<n * M, threads, 0, st>>>(
        (const T*)x, x_track, (const T*)delta, (T*)x_out, (T*)y, scale,
        s_track, M, d, eps);
  } else {
    rows_kernel<T, VPT, false><<<n * M, threads, 0, st>>>(
        (const T*)x, x_track, nullptr, nullptr, (T*)y, scale, s_track, M, d,
        eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(int route, const void* x, int64_t x_track,
                         const void* delta, void* x_out, void* y,
                         const float* scale, int64_t s_track, int n, int M,
                         int d, int ns, float div, float eps, int threads,
                         int vpt, cudaStream_t st) {
  if (vpt == 1)
    return launch_vpt<T, 1>(route, x, x_track, delta, x_out, y, scale,
                            s_track, n, M, d, ns, div, eps, threads, st);
  if (vpt == 2)
    return launch_vpt<T, 2>(route, x, x_track, delta, x_out, y, scale,
                            s_track, n, M, d, ns, div, eps, threads, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// route: 0 norm, 1 add_norm, 2 fuse_norm.  x [n, M, d] with track stride
// x_track (elements; 0 for a broadcast row); delta [n, M, d] (add_norm;
// fuse_norm, where it may be null); x_out: x' [n, M, d] (add_norm) or f [M, d] (fuse_norm); y
// [n, M, d] (norm, add_norm; scale row t * s_track for track t) or [ns, M,
// d] (fuse_norm; scale row u for y row u); scale fp32; dtype rt::kFloat32 |
// rt::kBFloat16; d a multiple of 16 bytes' elements and every pointer
// 16-byte aligned; n * M < 2^31.  Launch geometry from the caller
// (kernels/rmsnorm.py::launch_plan): ``threads`` per CTA (a multiple of
// 32, at most 512), ``vpt`` 16-byte vectors per thread (1 or 2).  Returns
// the launch error (0 on success).
extern "C" int rmsnorm_launch(int route, const void* x, long long x_track,
                              const void* delta, void* x_out, void* y,
                              const void* scale, long long s_track, int n,
                              int M, int d, int ns, float div, float eps,
                              int dtype, int threads, int vpt, void* stream) {
  if (route < kNorm || route > kFuseNorm || threads % 32 || threads > 512 ||
      threads < 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* s = (const float*)scale;
  if (dtype == rt::kFloat32)
    return (int)launch_typed<float>(route, x, x_track, delta, x_out, y, s,
                                    s_track, n, M, d, ns, div, eps, threads,
                                    vpt, st);
  if (dtype == rt::kBFloat16)
    return (int)launch_typed<__nv_bfloat16>(route, x, x_track, delta, x_out,
                                            y, s, s_track, n, M, d, ns, div,
                                            eps, threads, vpt, st);
  return (int)cudaErrorInvalidValue;
}
