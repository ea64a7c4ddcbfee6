// Linear recurrence h_t = a_t * h_{t-1} + b_t over the sequence axis, for
// the Mamba mixer's selective scan (sm_90a).
//
// Replaces src/repro/kernels/ssm_scan.py::ssm_scan (the Pallas _kernel).
// The TPU kernel walks a sequential grid over chunks of the sequence and
// keeps the carry h in VMEM scratch between grid steps.  On Hopper blocks
// run in no order and nothing carries between them, so the time loop
// lives inside one thread instead: each thread owns V consecutive
// (d_inner, d_state) features of one batch row, keeps their h in
// registers for the whole sequence, reads h0 once and writes h_last once.
//
// Layout: a, b, h [B, S, F] with F = d_inner * d_state (row-major, so step
// t of row b starts at (b * S + t) * F); h0, h_last [B, F].  Neighbouring
// threads own neighbouring features, so every step's loads and stores are
// coalesced: 16-byte fp32 (8-byte bf16) vector loads of a and b and a
// 16-byte store of h when F % 4 == 0, a scalar path (V = 1) otherwise.
// The next step's a and b are loaded before the current step is computed.
// bf16 inputs are widened in registers; h is always fp32.  The update is
// rounded as a product then a sum (no FMA contraction), as the plain
// version computes it.
//
// Bound on the H100: bytes.  Each step moves a and b in and h out with
// two flops per element, so the least time is (|a| + |b| + |h|) / 3.35
// TB/s; at the serve chunk shape (B 8, S 256, d_inner 8192, d_state 16,
// fp32) that is 3.22 GB, 0.96 ms.  B * F / 4 = 262,144 threads there
// keep every SM full with loads in flight.  Fusing the discretisation
// (exp(dt * A), dt * x * B) and the C contraction into this loop would
// remove most of that traffic; that is a later design.
#include <type_traits>

#include "common.cuh"

namespace {

template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    float2 lo = __bfloat1622float2(h[0]);
    float2 hi = __bfloat1622float2(h[1]);
    out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
  }
};

template <typename T>
struct Vec<T, 1> {
  __device__ __forceinline__ static void load(const T* p, float* out) {
    out[0] = rt::to_f(*p);
  }
};

__device__ __forceinline__ void store(float* p, const float* v,
                                      std::integral_constant<int, 4>) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(float* p, const float* v,
                                      std::integral_constant<int, 1>) {
  *p = v[0];
}

template <typename T, int V>
__global__ void ssm_scan_kernel(const T* __restrict__ a,
                                const T* __restrict__ b,
                                const float* __restrict__ h0,
                                float* __restrict__ h,
                                float* __restrict__ h_last, int B, int S,
                                int F) {
  const int per_row = F / V;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)B * per_row) return;
  const int row = (int)(tid / per_row);
  const int f = (int)(tid % per_row) * V;

  float hv[V], av[V], bv[V], an[V], bn[V];
#pragma unroll
  for (int k = 0; k < V; ++k) hv[k] = h0[(int64_t)row * F + f + k];

  const int64_t step = F;
  int64_t off = (int64_t)row * S * F + f;
  if (S > 0) {
    Vec<T, V>::load(a + off, an);
    Vec<T, V>::load(b + off, bn);
  }
  for (int t = 0; t < S; ++t, off += step) {
#pragma unroll
    for (int k = 0; k < V; ++k) { av[k] = an[k]; bv[k] = bn[k]; }
    if (t + 1 < S) {                    // next step's loads in flight
      Vec<T, V>::load(a + off + step, an);
      Vec<T, V>::load(b + off + step, bn);
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
      hv[k] = __fadd_rn(__fmul_rn(av[k], hv[k]), bv[k]);
    store(h + off, hv, std::integral_constant<int, V>());
  }
#pragma unroll
  for (int k = 0; k < V; ++k) h_last[(int64_t)row * F + f + k] = hv[k];
}

template <typename T>
cudaError_t launch_typed(const void* a, const void* b, const void* h0,
                         void* h, void* h_last, int B, int S, int F,
                         cudaStream_t stream) {
  constexpr int kThreads = 256;
  const bool vec = F % 4 == 0;
  const int64_t threads = (int64_t)B * (vec ? F / 4 : F);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (vec) {
    ssm_scan_kernel<T, 4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)a, (const T*)b, (const float*)h0, (float*)h,
        (float*)h_last, B, S, F);
  } else {
    ssm_scan_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)a, (const T*)b, (const float*)h0, (float*)h,
        (float*)h_last, B, S, F);
  }
  return cudaGetLastError();
}

}  // namespace

// a, b: [B, S, F] of dtype (rt::kFloat32 | rt::kBFloat16); h0 [B, F] fp32;
// h [B, S, F] fp32 and h_last [B, F] fp32 are written.  Returns the launch
// error (0 on success).
extern "C" int ssm_scan_launch(const void* a, const void* b, const void* h0,
                               void* h, void* h_last, int B, int S, int F,
                               int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == rt::kFloat32)
    return (int)launch_typed<float>(a, b, h0, h, h_last, B, S, F, st);
  if (dtype == rt::kBFloat16)
    return (int)launch_typed<__nv_bfloat16>(a, b, h0, h, h_last, B, S, F, st);
  return (int)cudaErrorInvalidValue;
}
