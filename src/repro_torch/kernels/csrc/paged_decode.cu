// Flash-decode for Hopper: one query token per sequence against a K/V
// cache, GQA-aware, in two layouts that share one kernel template:
//   * paged: a block-pool cache read through a per-sequence block table,
//     all Parallel-Track tracks in one launch.  Replaces the Pallas kernel
//     repro/kernels/decode_attention.py::paged_decode_attention
//     (_paged_kernel);
//   * contiguous: a per-slot cache [B, S, KH, hd] (token t of row b at
//     ((b*S + t)*KH + kh)*hd, no table).  Replaces the Pallas kernel
//     repro/kernels/decode_attention.py::decode_attention (_kernel).
// Both layouts have both branches of _online_softmax_step: fp caches, and
// int8 caches with fp32 per-token-per-head scales ([..., KH, 1]).  The
// int8 branch dequantizes each K and V element as float(payload) * scale
// inside the 64-token loop, where _online_softmax_step does it, so only
// int8 (plus one fp32 scale per row) crosses device memory.
//
// Bound on the H100: bytes.  Each live K/V row (and its scale) is read
// once and feeds G query heads with 2*G flops per element, far below the
// ~295 flop/byte ridge, so the kernel can at best stream the live cache at 3.35 TB/s.
// Design:
//   * grid (KH, B, n_tracks): one block per (track, row, KV head), so one
//     launch covers every track of a layer (the JAX vmap over tracks; the
//     contiguous layout folds the tracks into B instead);
//   * a paged block reads its own block-table row (Hopper has no scalar
//     prefetch) and visits only live tokens, min(length, ceil(max_len/bs)
//     blocks) -- dead blocks are never read; a contiguous block computes
//     each row's offset and visits min(length, n_cols) tokens, n_cols the
//     host's max_len cut;
//   * each K/V row is loaded once for all G query heads of its KV head;
//     the online-softmax state (m, l) lives in shared memory and the
//     output accumulators in fp32 registers;
//   * 64 tokens per step: one warp per token for q.k (lanes split the
//     head dim), one warp per head for the softmax update, one thread per
//     output column for P.V, so loads stay coalesced along the head dim.
// A split-KV pass (more blocks in flight for short batches) and TMA
// pipelining are left to a later optimisation.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                        // tokens per softmax step
constexpr int kMaxG = 8;                         // query heads per KV head
constexpr int kMaxHd = 256;
constexpr int kDPerThread = kMaxHd / kThreads;   // output columns / thread

// T: q / out type; P: cache type (T, or int8_t with scale caches);
// kPaged: block-pool layout through `table`, else the contiguous layout
// (N = B, bs = S, n_sweep = columns to visit, table unused)
template <typename T, typename P, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                    const P* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int B, int H, int KH, int hd, int N, int bs, int nmax,
                    int n_sweep, float scale) {
  const int kh = blockIdx.x, b = blockIdx.y, tr = blockIdx.z;
  const int G = H / KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr bool kQuant = std::is_same<P, int8_t>::value;

  __shared__ float q_s[kMaxG * kMaxHd];
  __shared__ float p_s[kMaxG * kTile];
  __shared__ long long row_s[kTile];   // element offset of a token's K/V row
  __shared__ float vs_s[kTile];        // its V scale (int8 pools)
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  // q rows of this KV head's G query heads, pre-scaled (as the Pallas
  // kernel does: q.astype(f32) * scale)
  const size_t q_off = ((size_t)(tr * B + b) * H + (size_t)kh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads)
    q_s[i] = rt::to_f(q[q_off + i]) * scale;
  if (tid < kMaxG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    alpha_s[tid] = 1.f;
  }

  const size_t track_off = (size_t)tr * N * bs * KH * hd;
  const P* kp = k_pool + track_off;
  const P* vp = v_pool + track_off;
  const size_t strack_off = (size_t)tr * N * bs * KH;   // scale pools
  const int L = lengths[b];
  // columns >= L are masked; columns past the sweep are never visited
  const int n_tok =
      kPaged ? max(0, min(L, min((L + bs - 1) / bs, n_sweep) * bs))
             : max(0, min(L, n_sweep));

  float acc[kDPerThread][kMaxG];
#pragma unroll
  for (int j = 0; j < kDPerThread; ++j)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[j][g] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n_tok; t0 += kTile) {
    const int tlen = min(kTile, n_tok - t0);
    // 1. scores s[g][t] = q_g . k_t: one warp per token
    for (int t = warp; t < kTile; t += kWarps) {
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
      long long row = 0;
      float vsc = 1.f;
      if (t < tlen) {
        const int i = t0 + t;
        // token row: through the table, or at (b, i) of the [B, S] cache
        const long long srow =
            kPaged ? ((long long)table[(size_t)b * nmax + i / bs] * bs +
                      (i % bs)) * KH + kh
                   : ((long long)b * bs + i) * KH + kh;
        row = srow * hd;
        float ksc = 1.f;
        if constexpr (kQuant) {
          ksc = k_scale[strack_off + srow];
          vsc = v_scale[strack_off + srow];
        }
        for (int d = lane; d < hd; d += 32) {
          float kd = rt::to_f(kp[row + d]);
          if constexpr (kQuant) kd *= ksc;
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) s[g] += q_s[g * hd + d] * kd;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) s[g] = rt::warp_sum(s[g]);
      if (lane == 0) {
        row_s[t] = row;
        vs_s[t] = vsc;
        for (int g = 0; g < G; ++g)
          p_s[g * kTile + t] = (t < tlen) ? s[g] : -INFINITY;
      }
    }
    __syncthreads();
    // 2. online-softmax update: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* pr = p_s + g * kTile;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_old = m_s[g];
      // finite: every step holds at least one live token
      const float m_new = fmaxf(m_old, rt::warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = rt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first step
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 3. acc = acc * alpha + P . V: one thread per output column
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) {
      const int d = tid + j * kThreads;
      if (d < hd) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) acc[j][g] *= alpha_s[g];
        for (int t = 0; t < tlen; ++t) {
          float vd = rt::to_f(vp[row_s[t] + d]);
          if constexpr (kQuant) vd *= vs_s[t];
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[j][g] += p_s[g * kTile + t] * vd;
        }
      }
    }
    __syncthreads();
  }

  // 4. normalise (an empty row stores zeros, like the Pallas kernel)
  const size_t o_off = ((size_t)(tr * B + b) * H + (size_t)kh * G) * hd;
#pragma unroll
  for (int j = 0; j < kDPerThread; ++j) {
    const int d = tid + j * kThreads;
    if (d < hd) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G)
          out[o_off + (size_t)g * hd + d] =
              rt::from_f<T>(acc[j][g] / fmaxf(l_s[g], 1e-37f));
    }
  }
}

template <typename T, typename P, bool kPaged>
void launch(const dim3 grid, cudaStream_t s, const void* q, const void* k_pool,
            const void* v_pool, const void* k_scale, const void* v_scale,
            const void* table, const void* lengths, void* out, int B, int H,
            int KH, int hd, int N, int bs, int nmax, int n_sweep,
            float scale) {
  decode_kernel<T, P, kPaged><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), B, H, KH, hd, N,
      bs, nmax, n_sweep, scale);
}

// tag values pick the (q type, cache type) instantiation
template <bool kPaged>
int dispatch(const dim3 grid, const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale, const void* table,
             const void* lengths, void* out, int B, int H, int KH, int hd,
             int N, int bs, int nmax, int n_sweep, float scale, int dtype,
             int cache_dtype, void* stream) {
  if (H % KH != 0 || H / KH > kMaxG || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const bool quant = cache_dtype == rt::kInt8;
  if (quant ? (k_scale == nullptr || v_scale == nullptr)
            : cache_dtype != dtype)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto t, auto p) {
    launch<decltype(t), decltype(p), kPaged>(grid, s, q, k, v, k_scale,
                                             v_scale, table, lengths, out, B,
                                             H, KH, hd, N, bs, nmax, n_sweep,
                                             scale);
  };
  if (dtype == rt::kFloat32 && quant)
    go(float{}, int8_t{});
  else if (dtype == rt::kFloat32)
    go(float{}, float{});
  else if (dtype == rt::kBFloat16 && quant)
    go(__nv_bfloat16{}, int8_t{});
  else if (dtype == rt::kBFloat16)
    go(__nv_bfloat16{}, __nv_bfloat16{});
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// q [n, B, H, hd]; k_pool/v_pool [n, N, bs, KH, hd] of q's dtype, or int8
// (pool_dtype rt::kInt8) with k_scale/v_scale [n, N, bs, KH, 1] fp32
// (null for fp pools); table [B, nmax] int32; lengths [B] int32; out
// [n, B, H, hd] of q's dtype.  All contiguous, on one device.  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, void* out, int n, int B, int H, int KH, int hd,
    int N, int bs, int nmax, int n_sweep, float scale, int dtype,
    int pool_dtype, void* stream) {
  return dispatch<true>(dim3(KH, B, n), q, k_pool, v_pool, k_scale, v_scale,
                        table, lengths, out, B, H, KH, hd, N, bs, nmax,
                        n_sweep, scale, dtype, pool_dtype, stream);
}

// q [B, H, hd]; k_cache/v_cache [B, S, KH, hd] of q's dtype, or int8
// (cache_dtype rt::kInt8) with k_scale/v_scale [B, S, KH, 1] fp32 (null
// for fp caches); lengths [B] int32; n_cols (1..S) the columns the sweep
// may visit; out [B, H, hd] of q's dtype.  All contiguous, on one device.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* lengths, void* out,
    int B, int H, int KH, int hd, int S, int n_cols, float scale, int dtype,
    int cache_dtype, void* stream) {
  return dispatch<false>(dim3(KH, B, 1), q, k_cache, v_cache, k_scale,
                         v_scale, nullptr, lengths, out, B, H, KH, hd, B, S,
                         1, n_cols, scale, dtype, cache_dtype, stream);
}
