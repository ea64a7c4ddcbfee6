// Linear recurrence h_t = a_t * h_{t-1} + b_t over the sequence axis, in
// two routes (sm_90a): the scan (a and b given) and the selective scan of
// the Mamba mixer (a and b formed in registers, y = h . C written).
//
// Replaces src/repro/kernels/ssm_scan.py::ssm_scan (the Pallas _kernel).
// The TPU kernel walks a sequential grid over chunks of the sequence and
// keeps the carry h in VMEM scratch between grid steps.  On Hopper blocks
// run in no order and nothing carries between them, so the time loop
// lives inside a thread: each thread owns features of one batch row,
// keeps their h in registers for the whole sequence, reads h0 once and
// writes h_last once.  The recurrence stays sequential in t, rounded as a
// product then a sum (no FMA contraction), as the plain version computes
// it; a scan split along the sequence would re-associate the products.
//
// 1. The scan route, ssm_scan_launch: a, b, h [B, S, F] with F = every
//    feature of a row (d_inner * d_state for Mamba, d_inner for the
//    RG-LRU), row-major, so step t of row b starts at (b * S + t) * F;
//    h0, h_last [B, F]; bf16 inputs widened in registers, h always fp32.
//    Bound on the H100: bytes, (|a| + |b| + |h|) / 3.35 TB/s.  Two paths,
//    bitwise equal (the same products and sums in the same order):
//    - TMA: a block owns kFT = 128 features of one row, one a thread, and
//      streams their a and b through a ring of kStages stages of kSteps
//      steps in shared memory, filled by bulk copies (cp.async.bulk, one
//      row of 128 features a copy, issued by warp 0, completing on an
//      mbarrier per stage).  Three stages (48 KB in fp32) stay in flight
//      a block while it computes the fourth.  h is stored straight from
//      registers (512 contiguous bytes a step).  Built for few features:
//      recurrentgemma-9b's a, b [8, 2048, 4096] are 32,768 sequences,
//      256 blocks; a thread owning 4 features with one step's 32 bytes
//      in flight (this kernel's first design: 8192 threads) kept ~256 KB
//      in flight across the card, a tenth of what HBM's latency asks
//      (1.2046 ms on an H100, 19.9 % of the bound, against 0.3084 on
//      this path).  At wide rows (falcon-mamba's [8, 256, 8192, 16]) the
//      two tie (1.0954 against 1.0961 ms, 88 % of the bound).
//    - registers: one thread a feature, the next step's a and b loaded
//      before the current one is computed.  It takes what the copies
//      cannot: F * sizeof(T) not a multiple of 16 bytes (fp32 F % 4 != 0,
//      bf16 F % 8 != 0) and bases off 16 bytes.  No served model's scan
//      lands here.
//    ssm_scan_launch picks the TMA path wherever its copies are aligned,
//    the register path elsewhere.
//
// 2. The selective-scan route, selective_scan_launch: the Mamba mixer's
//    discretisation, chunk mask, recurrence and C contraction in one
//    pass, so a, b and h ([B, S, d_inner, d_state] fp32, 1.07 GB each at
//    falcon-mamba's chunk) never reach HBM.  Per (row, i) sequence, the
//    d_state values of h in registers, each step t:
//      a_z = expf(dt * A[i, z])             (an fp32 product, then expf)
//      b_z = (dt * x) * B_t[z]               (in that order)
//      a_z, b_z = 1, 0 where t >= lens[row]  (the chunk mask)
//      h_z = a_z * h_z + b_z                 (a product, then a sum)
//      y_t = sum_z h_z * C_t[z]              (fma, z ascending)
//    which is what models/ssm.py's unfused composition rounds (PyTorch's
//    CUDA exp of fp32 is expf), so h_last is bitwise the unfused route's;
//    y sums in another order than cuBLAS's einsum.  The D skip stays in
//    the model.  Layout: one thread a sequence (128 a block, one batch
//    row a block), B_t and C_t rows staged for kSelSteps steps in shared
//    memory (double-buffered, the next chunk fetched into registers while
//    this one runs) and read as broadcasts.  Bound: bytes (dt, x in, y
//    out, plus A, B, C, h0, h_last: 0.21 GB at falcon-mamba's chunk, 0.064
//    ms); the 268 M expf and ~15 instructions a state update make it
//    issue-bound in practice.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// the scan route, register path
// ---------------------------------------------------------------------------

template <typename T>
__global__ void ssm_scan_kernel(const T* __restrict__ a,
                                const T* __restrict__ b,
                                const float* __restrict__ h0,
                                float* __restrict__ h,
                                float* __restrict__ h_last, int B, int S,
                                int F) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)B * F) return;
  const int row = (int)(tid / F);
  const int f = (int)(tid % F);

  float hv = h0[(int64_t)row * F + f], an = 0.f, bn = 0.f;
  int64_t off = (int64_t)row * S * F + f;
  if (S > 0) {
    an = rt::to_f(a[off]);
    bn = rt::to_f(b[off]);
  }
  for (int t = 0; t < S; ++t, off += F) {
    const float av = an, bv = bn;
    if (t + 1 < S) {                    // next step's loads in flight
      an = rt::to_f(a[off + F]);
      bn = rt::to_f(b[off + F]);
    }
    hv = __fadd_rn(__fmul_rn(av, hv), bv);
    h[off] = hv;
  }
  h_last[(int64_t)row * F + f] = hv;
}

template <typename T>
cudaError_t launch_register(const void* a, const void* b, const void* h0,
                            void* h, void* h_last, int B, int S, int F,
                            cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = ((int64_t)B * F + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  ssm_scan_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)a, (const T*)b, (const float*)h0, (float*)h, (float*)h_last,
      B, S, F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the scan route, TMA path
// ---------------------------------------------------------------------------

constexpr int kFT = 128;          // features a block, one a thread
constexpr int kSteps = 16;        // steps a stage (one copy a step and input)
constexpr int kStages = 4;

template <typename T>
constexpr int tma_smem_bytes() {
  return 2 * kStages * kSteps * kFT * (int)sizeof(T);
}

// one 1-D bulk copy global -> shared, completing on `bar` (16-byte aligned
// addresses, a size that is a multiple of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(hopper::smem_u32(bar))
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kFT)
    ssm_scan_tma_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        const float* __restrict__ h0, float* __restrict__ h,
                        float* __restrict__ h_last, int S, int F,
                        int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  T* sa = reinterpret_cast<T*>(smem);            // [kStages][kSteps][kFT]
  T* sb = sa + kStages * kSteps * kFT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / tiles;
  const int f0 = (blockIdx.x % tiles) * kFT;
  const int nf = min(kFT, F - f0);
  const int chunks = (S + kSteps - 1) / kSteps;
  const int64_t base = (int64_t)row * S * F + f0;   // (row, t = 0, f0)
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp 0 fills chunk c's stage: lane k copies step k of a, lane 16 + k
  // step k of b, one row of nf features each
  auto issue = [&](int c) {
    const int st = c % kStages, t0 = c * kSteps;
    const int n = min(kSteps, S - t0);
    const uint32_t bytes = (uint32_t)nf * sizeof(T);
    if (lane == 0) hopper::mbar_expect_tx(&full[st], 2 * n * bytes);
    __syncwarp();
    const int k = lane % kSteps;
    if (k < n) {
      const T* src = (lane < kSteps ? a : b) + base + (int64_t)(t0 + k) * F;
      T* dst = (lane < kSteps ? sa : sb) + (st * kSteps + k) * kFT;
      bulk_load(dst, src, bytes, &full[st]);
    }
  };
  if (warp == 0)
    for (int c = 0; c < min(kStages, chunks); ++c) issue(c);

  const bool on = tid < nf;
  float hv = on ? h0[(int64_t)row * F + f0 + tid] : 0.f;
  float* hp = h + base + tid;
  for (int c = 0; c < chunks; ++c) {
    const int st = c % kStages, t0 = c * kSteps;
    const int n = min(kSteps, S - t0);
    hopper::mbar_wait(&full[st], (c / kStages) & 1);
    if (on) {
      const T* pa = sa + st * kSteps * kFT + tid;
      const T* pb = sb + st * kSteps * kFT + tid;
      float* out = hp + (int64_t)t0 * F;
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        if (k < n) {
          hv = __fadd_rn(__fmul_rn(rt::to_f(pa[k * kFT]), hv),
                         rt::to_f(pb[k * kFT]));
          out[(int64_t)k * F] = hv;
        }
      }
    }
    __syncthreads();                    // every thread is done with stage st
    if (warp == 0 && c + kStages < chunks) issue(c + kStages);
  }
  if (on) h_last[(int64_t)row * F + f0 + tid] = hv;
}

template <typename T>
bool tma_fits(const void* a, const void* b, int F) {
  // every copy starts and ends on 16 bytes: the bases, the row stride
  // F * sizeof(T) and each block's first feature
  return hopper::aligned16(a) && hopper::aligned16(b) &&
         (F * (int)sizeof(T)) % 16 == 0;
}

template <typename T>
cudaError_t launch_tma(const void* a, const void* b, const void* h0, void* h,
                       void* h_last, int B, int S, int F,
                       cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be opted into (once)
  static bool opted = false;
  if (!opted) {
    cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_tma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tma_smem_bytes<T>());
    if (e != cudaSuccess) return e;
    opted = true;
  }
  const int tiles = (F + kFT - 1) / kFT;
  const int64_t blocks = (int64_t)B * tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  ssm_scan_tma_kernel<T><<<(unsigned)blocks, kFT, tma_smem_bytes<T>(),
                           stream>>>((const T*)a, (const T*)b,
                                     (const float*)h0, (float*)h,
                                     (float*)h_last, S, F, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* a, const void* b, const void* h0,
                         void* h, void* h_last, int B, int S, int F,
                         cudaStream_t stream) {
  if (tma_fits<T>(a, b, F))
    return launch_tma<T>(a, b, h0, h, h_last, B, S, F, stream);
  return launch_register<T>(a, b, h0, h, h_last, B, S, F, stream);
}

// ---------------------------------------------------------------------------
// the selective-scan route
// ---------------------------------------------------------------------------

constexpr int kSelThreads = 128;  // sequences (d_inner lanes) a block
constexpr int kSelSteps = 32;     // B_t / C_t rows staged a chunk
constexpr int kGroup = 8;         // steps whose dt and x load together

// DS: the d_state the registers hold; EXACT: ds == DS, so every index is
// known to the compiler (the B_t / C_t rows read as 16-byte vectors)
template <int DS, bool EXACT>
__global__ void __launch_bounds__(kSelThreads)
    selective_scan_kernel(const float* __restrict__ dt,
                          const float* __restrict__ x,
                          const float* __restrict__ A,
                          const float* __restrict__ Bt,
                          const float* __restrict__ Ct,
                          const float* __restrict__ h0,
                          const int* __restrict__ lens,
                          float* __restrict__ y, float* __restrict__ h_last,
                          int S, int di, int ds_, int64_t bc_row,
                          int64_t bc_step) {
  __shared__ __align__(16) float sbc[2][kSelSteps][2 * DS];   // B_t, C_t
  const int ds = EXACT ? DS : ds_;
  constexpr int kPer = (kSelSteps * 2 * DS + kSelThreads - 1) / kSelThreads;
  const int tid = threadIdx.x, row = blockIdx.y;
  const int i = blockIdx.x * kSelThreads + tid;
  const bool on = i < di;
  const int len = lens == nullptr ? S : lens[row];
  const float* Bb = Bt + (int64_t)row * bc_row;
  const float* Cb = Ct + (int64_t)row * bc_row;
  const int width = 2 * ds, per = kSelSteps * width;

  float hv[DS], Av[DS], pre[kPer];
#pragma unroll
  for (int z = 0; z < DS; ++z) {
    const bool ok = on && z < ds;
    hv[z] = ok ? h0[((int64_t)row * di + i) * ds + z] : 0.f;
    Av[z] = ok ? A[(int64_t)i * ds + z] : 0.f;
  }
  // the B / C values of the kSelSteps steps from t0, kPer a thread
  auto fetch = [&](int t0) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int e = tid + r * kSelThreads;
      float v = 0.f;
      if (e < per) {
        const int k = e / width, j = e - k * width;
        if (t0 + k < S)
          v = j < ds ? Bb[(int64_t)(t0 + k) * bc_step + j]
                     : Cb[(int64_t)(t0 + k) * bc_step + j - ds];
      }
      pre[r] = v;
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int e = tid + r * kSelThreads;
      if (e < per) {
        const int k = e / width;
        sbc[buf][k][e - k * width] = pre[r];
      }
    }
  };
  fetch(0);
  put(0);
  __syncthreads();

  const int64_t col = (int64_t)row * S * di + i;     // (row, t = 0, i)
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += kSelSteps, buf ^= 1) {
    const bool more = t0 + kSelSteps < S;
    if (more) fetch(t0 + kSelSteps);
    const int n = min(kSelSteps, S - t0);
    for (int k0 = 0; k0 < n; k0 += kGroup) {
      float dv[kGroup], xv[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool ok = on && k0 + u < n;
        const int64_t o = col + (int64_t)(t0 + k0 + u) * di;
        dv[u] = ok ? dt[o] : 0.f;
        xv[u] = ok ? x[o] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k = k0 + u;
        if (k >= n) break;
        const float* bc = sbc[buf][k];
        const float d = dv[u], dx = __fmul_rn(dv[u], xv[u]);
        float acc = 0.f;
        if (t0 + k < len) {
#pragma unroll
          for (int z = 0; z < DS; ++z) {
            if (z < ds) {
              const float az = expf(__fmul_rn(d, Av[z]));
              const float bz = __fmul_rn(dx, bc[z]);
              hv[z] = __fadd_rn(__fmul_rn(az, hv[z]), bz);
              acc = z == 0 ? __fmul_rn(hv[z], bc[ds + z])
                           : __fmaf_rn(hv[z], bc[ds + z], acc);
            }
          }
        } else {                        // the chunk mask: a = 1, b = 0
#pragma unroll
          for (int z = 0; z < DS; ++z) {
            if (z < ds) {
              hv[z] = __fadd_rn(__fmul_rn(1.f, hv[z]), 0.f);
              acc = z == 0 ? __fmul_rn(hv[z], bc[ds + z])
                           : __fmaf_rn(hv[z], bc[ds + z], acc);
            }
          }
        }
        if (on) y[col + (int64_t)(t0 + k) * di] = acc;
      }
    }
    if (more) put(buf ^ 1);
    __syncthreads();
  }
  if (on) {
#pragma unroll
    for (int z = 0; z < DS; ++z)
      if (z < ds) h_last[((int64_t)row * di + i) * ds + z] = hv[z];
  }
}

template <int DS, bool EXACT>
cudaError_t launch_selective(const float* dt, const float* x, const float* A,
                             const float* Bt, const float* Ct,
                             const float* h0, const int* lens, float* y,
                             float* h_last, int B, int S, int di, int ds,
                             int64_t bc_row, int64_t bc_step,
                             cudaStream_t stream) {
  const dim3 grid((di + kSelThreads - 1) / kSelThreads, B);
  if (B > 65535) return cudaErrorInvalidConfiguration;
  selective_scan_kernel<DS, EXACT><<<grid, kSelThreads, 0, stream>>>(
      dt, x, A, Bt, Ct, h0, lens, y, h_last, S, di, ds, bc_row, bc_step);
  return cudaGetLastError();
}

}  // namespace

// a, b: [B, S, F] of dtype (rt::kFloat32 | rt::kBFloat16); h0 [B, F] fp32;
// h [B, S, F] fp32 and h_last [B, F] fp32 are written (the TMA path where
// its copies are aligned, else the register path).  Returns the launch
// error (0 on success).
extern "C" int ssm_scan_launch(const void* a, const void* b, const void* h0,
                               void* h, void* h_last, int B, int S, int F,
                               int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == rt::kFloat32)
    return (int)launch_typed<float>(a, b, h0, h, h_last, B, S, F, st);
  if (dtype == rt::kBFloat16)
    return (int)launch_typed<__nv_bfloat16>(a, b, h0, h, h_last, B, S, F,
                                            st);
  return (int)cudaErrorInvalidValue;
}

// The selective-scan route, all fp32: dt, x [B, S, di] contiguous; A [di,
// ds]; Bt, Ct [B, S, ds] with row stride bc_row and step stride bc_step
// (elements; the last dim contiguous; Bt and Ct share the strides); h0
// [B, di, ds]; lens [B] int32 or null (no mask); y [B, S, di] and h_last
// [B, di, ds] are written.  ds <= 16.  Returns the launch error.
extern "C" int selective_scan_launch(const void* dt, const void* x,
                                     const void* A, const void* Bt,
                                     const void* Ct, const void* h0,
                                     const void* lens, void* y, void* h_last,
                                     int B, int S, int di, int ds,
                                     long long bc_row, long long bc_step,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  const int* ln = (const int*)lens;
  if (ds == 16)                         // falcon-mamba's
    return (int)launch_selective<16, true>(f(dt), f(x), f(A), f(Bt), f(Ct),
                                           f(h0), ln, (float*)y,
                                           (float*)h_last, B, S, di, ds,
                                           bc_row, bc_step, st);
  if (ds >= 1 && ds <= 16)
    return (int)launch_selective<16, false>(f(dt), f(x), f(A), f(Bt), f(Ct),
                                            f(h0), ln, (float*)y,
                                            (float*)h_last, B, S, di, ds,
                                            bc_row, bc_step, st);
  return (int)cudaErrorInvalidValue;
}
