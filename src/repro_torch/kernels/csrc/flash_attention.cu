// Flash attention for prefill on Hopper: causal or full softmax attention
// with fp32 scores and accumulators, GQA by head index (no expanded K/V
// copy), optional tanh softcap, causal k-tiles above the diagonal skipped.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// ::flash_attention (_kernel).
//
// Bound on the H100: at the serving prefill shape (S = 512, hd = 128) the
// bytes (q, k, v read once, out written once) and the causal flops are
// within a factor of two of each other, so the bound is the larger of the
// two (see PERF.md).  Two kernels share the contract:
//   * bf16 with hd 64 or 128 (the serving path): tensor cores through
//     mma.sync, described at flash_attention_mma_kernel below;
//   * every other case, fp32 above all (so the fp32 reference configs run
//     through it unchanged): the CUDA-core kernel right below, which keeps
//     every intermediate on chip:
//   * grid (ceil(Sq/64), H, batch): a block owns 64 query rows of one head
//     and reads K/V of KV head h / G straight from the [B, S, KH, hd]
//     projections, which cuts the bytes of the expanded copy G-fold;
//   * 256 threads: 4 per query row; each computes 8 of the 32 scores of a
//     k-tile and owns hd/4 output columns of the fp32 accumulator;
//   * the online-softmax state (m, l) stays in registers, the 64x32 tile
//     of probabilities in shared memory; rows reduce over 4 lanes;
//   * causal: the k loop stops at the tile's last row, ragged row and
//     column edges are masked in-kernel, so no length has to tile 64.
// wgmma tiles with TMA pipelining are left to a later optimisation.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 32;                  // keys per tile
constexpr int kThreads = 256;            // 4 threads per query row
constexpr int kMaxHd = 128;
constexpr int kDPerThread = kMaxHd / 4;  // accumulator columns per thread
constexpr int kCPerThread = kBK / 4;     // score columns per thread

inline size_t smem_bytes(int hd) {
  const int ld = hd + 1;                 // +1 float: no bank conflicts
  return sizeof(float) *
         ((size_t)kBQ * ld + 2 * (size_t)kBK * ld + (size_t)kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int KH, int hd, int causal,
                       float softcap, float scale) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, r = tid >> 2, j = tid & 3;
  const int ld = hd + 1;
  extern __shared__ float smem[];
  float* Q_s = smem;                 // [kBQ][ld]
  float* K_s = Q_s + kBQ * ld;       // [kBK][ld]
  float* V_s = K_s + kBK * ld;       // [kBK][ld]
  float* P_s = V_s + kBK * ld;       // [kBQ][kBK + 1]

  const int q0 = qt * kBQ;
  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int rr = idx / hd, d = idx % hd, qi = q0 + rr;
    float x = 0.f;
    if (qi < Sq) x = rt::to_f(q[(((size_t)b * Sq + qi) * H + h) * hd + d]) * scale;
    Q_s[rr * ld + d] = x;
  }

  float acc[kDPerThread];
#pragma unroll
  for (int i = 0; i < kDPerThread; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int row = q0 + r;
  // causal: a k-tile whose first column is past the block's last row
  // contributes nothing and is never loaded
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();   // Q_s is written / the previous tile is consumed
    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int c = idx / hd, d = idx % hd, ki = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (ki < Sk) {
        const size_t off = (((size_t)b * Sk + ki) * KH + kh) * hd + d;
        kx = rt::to_f(k[off]);
        vx = rt::to_f(v[off]);
      }
      K_s[c * ld + d] = kx;
      V_s[c * ld + d] = vx;
    }
    __syncthreads();

    float s[kCPerThread];
#pragma unroll
    for (int i = 0; i < kCPerThread; ++i) s[i] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qd = Q_s[r * ld + d];
#pragma unroll
      for (int i = 0; i < kCPerThread; ++i) s[i] += qd * K_s[(j + 4 * i) * ld + d];
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < kCPerThread; ++i) {
      const int col = k0 + j + 4 * i;
      float x = s[i];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const bool ok = col < Sk && (!causal || col <= row);
      s[i] = ok ? x : -INFINITY;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;  // all masked
    const float alpha = expf(m - m_use);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kCPerThread; ++i) {
      const float p = expf(s[i] - m_use);
      P_s[r * (kBK + 1) + j + 4 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();      // the row's 4 lanes share P_s

#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) {
      const int d = j + 4 * i;
      if (d < hd) {
        float a = acc[i] * alpha;
        for (int c = 0; c < kBK; ++c) a += P_s[r * (kBK + 1) + c] * V_s[c * ld + d];
        acc[i] = a;
      }
    }
  }

  if (row < Sq) {
    const float denom = fmaxf(l, 1e-37f);
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) {
      const int d = j + 4 * i;
      if (d < hd)
        out[(((size_t)b * Sq + row) * H + h) * hd + d] = rt::from_f<T>(acc[i] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel (head dims 64 and 128): mma.sync m16n8k16 with
// fp32 accumulators, FlashAttention-2 style.  Each of the 4 warps owns 16
// query rows; its Q fragments stay in registers for the whole sweep, the
// S = Q K^T accumulators are re-packed in registers as the A operand of
// O += P V (P rounded to bf16, as the Pallas kernel feeds p to its second
// dot in V's dtype), and only the K / V tiles go through shared memory.
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 64;               // query rows per block, 16 per warp
constexpr int kMmaBK = 64;               // keys per tile
constexpr int kMmaThreads = 128;
constexpr int kPad = 8;                  // bf16 per smem row: no bank conflicts

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 in one register, the lower column index in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                           int H, int KH, int causal, float softcap,
                           float scale) {
  constexpr int LD = HD + kPad;
  constexpr int KS = HD / 16;            // k-steps of Q K^T
  constexpr int NT = HD / 8;             // n-tiles of O
  constexpr int CH = HD / 8;             // 16-byte chunks per K / V row
  __shared__ __align__(16) __nv_bfloat16 K_s[kMmaBK * LD];
  __shared__ __align__(16) __nv_bfloat16 V_s[kMmaBK * LD];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row / column pair
  const int q0 = qt * kMmaBQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this thread's rows

  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* q0p = q + (((size_t)b * Sq + r0) * H + h) * HD;
    const __nv_bfloat16* q1p = q + (((size_t)b * Sq + r1) * H + h) * HD;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + t4 * 2;
      qa[ks][0] = r0 < Sq ? ld2(q0p + c) : 0u;
      qa[ks][1] = r1 < Sq ? ld2(q1p + c) : 0u;
      qa[ks][2] = r0 < Sq ? ld2(q0p + c + 8) : 0u;
      qa[ks][3] = r1 < Sq ? ld2(q1p + c + 8) : 0u;
    }
  }

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  // running max and this thread's share of the running sum, per row
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // causal: k-tiles past the block's last row are never loaded
  const int k_end = causal ? min(Sk, q0 + kMmaBQ) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += kMmaBK) {
    __syncthreads();   // the previous tile is consumed
    for (int i = tid; i < kMmaBK * CH; i += kMmaThreads) {
      const int rr = i / CH, c = (i % CH) * 8, ki = k0 + rr;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;   // zero past Sk
      if (ki < Sk) {
        const size_t off = (((size_t)b * Sk + ki) * KH + kh) * HD + c;
        kx = *reinterpret_cast<const uint4*>(k + off);
        vx = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(K_s + rr * LD + c) = kx;
      *reinterpret_cast<uint4*>(V_s + rr * LD + c) = vx;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[kMmaBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kMmaBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* kr = K_s + (nt * 8 + g) * LD + t4 * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_16816(s[nt], qa[ks], ld2(kr + ks * 16), ld2(kr + ks * 16 + 8));
    }

    // scale, softcap, mask; row maxima over the row's 4 lanes
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kMmaBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        float x = s[nt][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = (col < Sk && (!causal || col <= row)) ? x : -INFINITY;
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float u0 = n0 == -INFINITY ? 0.f : n0;   // row all masked so far
    const float u1 = n1 == -INFINITY ? 0.f : n1;
    const float a0 = expf(m0 - u0), a1 = expf(m1 - u1);
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kMmaBK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - u0);
      s[nt][1] = expf(s[nt][1] - u0);
      s[nt][2] = expf(s[nt][2] - u1);
      s[nt][3] = expf(s[nt][3] - u1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= a0;
      o[nt][1] *= a0;
      o[nt][2] *= a1;
      o[nt][3] *= a1;
    }

    // O += P V: the S accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of one m16n8k16 step
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      const uint32_t pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1]),
                              pack2(s[2 * kk][2], s[2 * kk][3]),
                              pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = V_s + (kk * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* vc = vr + nt * 8;
        mma_16816(o[nt], pa, pack2(vc[0], vc[LD]),
                  pack2(vc[8 * LD], vc[9 * LD]));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / fmaxf(l0, 1e-37f), i1 = 1.f / fmaxf(l1, 1e-37f);
  __nv_bfloat16* o0p = out + (((size_t)b * Sq + r0) * H + h) * HD + t4 * 2;
  __nv_bfloat16* o1p = out + (((size_t)b * Sq + r1) * H + h) * HD + t4 * 2;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0p + nt * 8) =
          __floats2bfloat162_rn(o[nt][0] * i0, o[nt][1] * i0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1p + nt * 8) =
          __floats2bfloat162_rn(o[nt][2] * i1, o[nt][3] * i1);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int H, int KH, int causal, float softcap,
               float scale, cudaStream_t s) {
  const dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, H, B);
  flash_attention_mma_kernel<HD><<<grid, kMmaThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Sk, H, KH, causal, softcap, scale);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KH, int hd, int causal, float softcap,
           float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(hd);
  // above 48 KB a block's dynamic shared memory must be opted into
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KH, hd,
      causal, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Sq, H, hd]; k, v [B, Sk, KH, hd]; out [B, Sq, H, hd]; contiguous.
// softcap <= 0 means none.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int KH, int hd,
                                      int causal, float softcap, float scale,
                                      int dtype, void* stream) {
  if (H % KH != 0 || hd > kMaxHd) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch<float>(q, k, v, out, B, Sq, Sk, H, KH, hd, causal, softcap,
                         scale, s);
  if (dtype == rt::kBFloat16) {
    // 16-byte K / V loads: the tensor-core kernel needs aligned operands
    const bool mma = aligned16(q) && aligned16(k) && aligned16(v) &&
                     aligned16(out);
    if (mma && hd == 128)
      return launch_mma<128>(q, k, v, out, B, Sq, Sk, H, KH, causal, softcap,
                             scale, s);
    if (mma && hd == 64)
      return launch_mma<64>(q, k, v, out, B, Sq, Sk, H, KH, causal, softcap,
                            scale, s);
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KH, hd, causal,
                                 softcap, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
