// Split-KV flash-decode for Hopper: one query token per sequence against a
// K/V cache, GQA-aware, in two layouts that share one kernel template:
//   * paged: a block-pool cache read through a per-sequence block table,
//     all Parallel-Track tracks in one launch.  Replaces the Pallas kernel
//     src/repro/kernels/decode_attention.py:187 paged_decode_attention
//     (_paged_kernel :153);
//   * contiguous: a per-slot cache [B, S, KH, hd] (token t of row b at
//     ((b*S + t)*KH + kh)*hd, no table).  Replaces the Pallas kernel
//     src/repro/kernels/decode_attention.py:92 decode_attention (_kernel :60).
// Both layouts have both branches of _online_softmax_step (:34): fp caches,
// and int8 caches with fp32 per-token-per-head scales ([..., KH, 1]).  The
// int8 branch dequantizes in registers: float(payload) * scale, with the
// row's scale applied to its dot product (K) and to its softmax weight (V),
// which is the per-element product factored out of the sum; only int8 and
// one fp32 scale per row cross device memory.
//
// Bound on the H100: bytes.  Each live K/V row (and its scale) is read once
// and feeds G <= 8 query heads with 2*G flops per element, far below the
// ~295 flop/byte ridge, so the kernel can at best stream the live cache at
// 3.35 TB/s.  Design:
//   * a split over the sequence: grid (split, KV head, track x row).  The
//     host plans the split (decode_attention.py::split_plan) with no device
//     sync: the split size from the cache's capacity and the base block
//     count, the number of splits from its max_len bucket.  At the serve
//     shapes (64 base blocks, capacity 592) splits of 128 tokens, 5 of them
//     (320 blocks on 132 SMs) at the full sweep.  Paged splits are whole
//     pages, so a block reads its split's table entries once, into shared
//     memory;
//   * no block-wide barrier in the sweep.  Each warp streams its own tiles
//     of K and V rows through a ring of shared-memory stages filled by
//     16-byte cp.async copies (4 KB of K per warp, one to three tiles ahead
//     of the one it scores), so the bytes in flight cost no registers.  A
//     lane group ("worker") of hd / kE lanes owns one token at a time: each
//     lane reads kE elements of the K and V rows from the tile (16 bytes of
//     fp32 or bf16, 8 of int8, to keep q and the accumulators in
//     registers), scores all G heads against q held in fp32 registers,
//     reduces by shuffles within the group, one level for all kU * G scores
//     at once, and keeps its own online-softmax state (m, l, acc) over its
//     tokens.  The block merges its workers (shuffles) and warps (shared
//     memory) once, at the end;
//   * the combine in the same launch: with more than one split each block
//     writes its partial (m, l, acc) in fp32 to the workspace, takes a ticket
//     (__threadfence + atomicAdd on its (track, row, KV head) counter), and
//     the last block reads all partials in one round of coalesced loads,
//     merges them in split order, writes out and resets its counter to 0.
//     No float atomics, so two calls on the same inputs give the same bits.
//     The counters are one zero-initialised buffer per device that every
//     launch leaves at zero; the port launches on one stream, so no two
//     launches share it at once.  One split writes out directly;
//   * the bits do not follow the sweep bound.  A split past a row's live
//     tokens has m = -inf, l = 0 and acc = 0: its merge weight is
//     exp2(-inf) = 0 and it adds exact zeros, after the live splits, in
//     split order.  With one live split the merge computes A * 1 + 0 and
//     L * 1 + 0, which are A and L (A starts at +0, so it is never -0):
//     the one-split path's A / L.  So for the same live tokens and split
//     size, any number of launched splits gives the same bits;
//   * rows whose width is not a multiple of 16 bytes (or not a power-of-two
//     number of 16-byte words up to 512 bytes), or whose base is not 16-byte
//     aligned, take the scalar instantiation of the same template: a whole
//     warp per token, lane d owning elements d + 32 j, loaded straight from
//     device memory;
//   * no wgmma and no TMA: G <= 8 query rows per KV head are far below
//     wgmma's 64-row tile, and the work is bytes-bound, so CUDA cores do it.
// Scores live in the log2 domain (q pre-scaled by hd^-0.5 * log2 e), so the
// softmax uses exp2f.  Columns >= lengths[b] and past the host's sweep are
// never visited; a row with no live column stores zeros.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;                  // query heads per KV head
constexpr int kMaxHd = 256;
constexpr int kMaxSplits = 64;            // decode_attention.py _MAX_SPLITS
constexpr int kMaxPages = 256;            // decode_attention.py _MAX_PAGES
constexpr int kScalarE = kMaxHd / 32;     // elements per lane, scalar path
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* lengths;
  void* out;
  float* ws;        // [base][n_split][G][hd] acc, then [base][n_split][G][2]
  int* counters;    // [base], zero between launches
  int B, H, KH, hd;
  int N, bs, nmax;  // paged: pool blocks, block size, table width;
                    // contiguous: N = B, bs = S, nmax unused
  int sweep;        // tokens the sweep may visit (the host's max_len cut)
  int n_split, split_len;
  float scale;
};

// One lane's kE elements of a K or V row.  Vector path: kE consecutive
// elements from r * kE, read from a shared-memory tile as 16- or 8-byte
// words and unpacked in registers; scalar path: elements r + 32 j (< hd),
// loaded from device memory.
template <typename P, int kE, bool kVec>
struct Slice {
  static constexpr int kWords = kVec ? kE * (int)sizeof(P) / 4 : 1;
  uint32_t w[kWords];
  float f[kVec ? 1 : kE];

  // scalar path
  __device__ __forceinline__ void load(const P* __restrict__ row, int r,
                                       int hd) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int d = r + 32 * j;
      f[j] = d < hd ? rt::to_f(row[d]) : 0.f;
    }
  }

  // vector path: the lane's words from a tile in shared memory
  __device__ __forceinline__ void load_shared(const unsigned char* p) {
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 x = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = x.x;
        w[4 * i + 1] = x.y;
        w[4 * i + 2] = x.z;
        w[4 * i + 3] = x.w;
      }
    } else {
      static_assert(kWords == 2, "8- or 16-byte words");
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x;
      w[1] = x.y;
    }
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
#pragma unroll
    for (int j = 0; j < (kVec ? 1 : kE); ++j) f[j] = 0.f;
  }

  __device__ __forceinline__ float get(int j) const {
    if constexpr (!kVec) {
      return f[j];
    } else if constexpr (std::is_same<P, float>::value) {
      return __uint_as_float(w[j]);
    } else if constexpr (std::is_same<P, __nv_bfloat16>::value) {
      // bf16 is the top half of an fp32: exact
      return __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u)
                                     : (w[j >> 1] << 16));
    } else {
      return (float)((int)(w[j >> 2] << (24 - 8 * (j & 3))) >> 24);
    }
  }
};

// kU tokens of a worker: their K and V slices, scales and liveness.
template <typename P, int kE, bool kVec, int kU>
struct Batch {
  Slice<P, kE, kVec> k[kU], v[kU];
  float ks[kU], vs[kU];
  bool live[kU];
};

// The element a lane's slot j holds.
template <int kE, bool kVec>
__device__ __forceinline__ int elem(int r, int j) {
  return kVec ? r * kE + j : r + 32 * j;
}

// Merge (m2, l2) into (m, l): the weights of the two sides, in the log2
// domain; an empty side (m = -inf) weighs 0.
__device__ __forceinline__ void merge_w(float m, float m2, float& a,
                                        float& a2, float& mn) {
  mn = fmaxf(m, m2);
  const float mr = mn == -INFINITY ? 0.f : mn;
  a = exp2f(m - mr);
  a2 = exp2f(m2 - mr);
}

// cp.async: src_bytes 0 fills the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Compile-time shape of an instantiation.
template <typename P, int kG, int kE, bool kVec>
struct Shape {
  static constexpr int kU = kG * kE > 32 ? 2 : 4;  // tokens / worker / step
  // vector path: one tile = one step of a warp's workers (32 * kU lanes'
  // words of K, as many of V); a ring of kRingBytes of K per warp
  static constexpr int kTileBytes = 32 * kU * kE * (int)sizeof(P);
  static constexpr int kRingBytes = 4096;
  static constexpr int kStages =
      kVec ? (kRingBytes / kTileBytes < 2 ? 2 : kRingBytes / kTileBytes) : 0;
  static constexpr int kMaxT = 32 * kU;             // tokens of a tile
  static constexpr bool kQuant = std::is_same<P, int8_t>::value;
  static constexpr int kStageBytes =
      2 * kTileBytes + (kQuant ? 2 * kMaxT * 4 : 0);
  static constexpr int kPipeBytes = kWarps * kStages * kStageBytes;
  static constexpr int kMergeBytes = kWarps * kG * kMaxHd * 4;
  static constexpr int kSmem = kPipeBytes > kMergeBytes ? kPipeBytes
                                                        : kMergeBytes;
};

// T: q / out type; P: cache type (T, or int8_t with scales); kPaged: the
// block-pool layout through the table; kG: register slots for G <= kG heads;
// kE: elements per lane of a row; kVec: the vector path (cp.async tiles).
template <typename T, typename P, bool kPaged, int kG, int kE, bool kVec>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Args a) {
  using S = Shape<P, kG, kE, kVec>;
  constexpr bool kQuant = S::kQuant;
  constexpr int kU = S::kU;
  const int split = blockIdx.x, kh = blockIdx.y, z = blockIdx.z;
  const int b = z % a.B, tr = z / a.B;       // z = track * B + row
  const int hd = a.hd, KH = a.KH, G = a.H / KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpr = kVec ? hd / kE : 32;       // lanes per row (a worker)
  const int r = lane & (lpr - 1);
  const int tpw = 32 / lpr;                  // workers per warp
  const int wkw = lane / lpr;                // this lane's worker in the warp

  extern __shared__ __align__(16) unsigned char dyn_s[];
  __shared__ int page_s[kPaged ? kMaxPages : 1];
  __shared__ float wm_s[kWarps][kG], wl_s[kWarps][kG];
  __shared__ float sm_s[kMaxSplits][kG], sl_s[kMaxSplits][kG];
  __shared__ float tot_s[kG];
  __shared__ int last_s;

  const int t_begin = split * a.split_len;
  const size_t track_rows = (size_t)tr * a.N * a.bs * KH;  // rows before
  const P* kp = static_cast<const P*>(a.k) + track_rows * hd;
  const P* vp = static_cast<const P*>(a.v) + track_rows * hd;
  const int bs_shift = (a.bs & (a.bs - 1)) ? -1 : __popc(a.bs - 1);
  if constexpr (kPaged) {
    // the split's table entries, once per page (t_begin is page-aligned),
    // read beside the length: entries past a row's blocks are read, never
    // followed
    const int p0 = t_begin / a.bs;
    const int np = min(a.split_len / a.bs, a.nmax - p0);
    const int* trow = a.table + (size_t)b * a.nmax + p0;
    for (int i = tid; i < np; i += kThreads) page_s[i] = trow[i];
  }
  const int n_tok = max(0, min(a.lengths[b], a.sweep));
  const int t_end = min(t_begin + a.split_len, n_tok);
  // token t's row (token x KV head) within its track
  auto row_of = [&](int t) -> long long {
    if constexpr (kPaged) {
      const int i = t - t_begin;
      const int pg = bs_shift >= 0 ? i >> bs_shift : i / a.bs;
      const int in = bs_shift >= 0 ? i & (a.bs - 1) : i % a.bs;
      return ((long long)page_s[pg] * a.bs + in) * KH + kh;
    } else {
      return ((long long)b * a.bs + t) * KH + kh;
    }
  };

  // this lane's q slice for the G heads, pre-scaled into the log2 domain
  // (read once the first tiles are on their way)
  const size_t q_off = ((size_t)z * a.H + (size_t)kh * G) * hd;
  float qf[kG][kE], acc[kG][kE], m[kG], l[kG];
  auto load_q = [&]() {
    const T* q = static_cast<const T*>(a.q) + q_off;
    const float qs = a.scale * kLog2e;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int d = elem<kE, kVec>(r, j);
        qf[g][j] = (g < G && d < hd) ? rt::to_f(q[g * hd + d]) * qs : 0.f;
        acc[g][j] = 0.f;
      }
    }
  };
  if constexpr (kPaged) __syncthreads();

  // one step of the worker's online softmax over its kU tokens
  auto step = [&](const Batch<P, kE, kVec, kU>& x) {
    // scores s[u][g] = q_g . k_u, reduced over the worker's lanes one
    // shuffle level at a time, so the kU * G reductions overlap
    float s[kU][kG];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[kE];
#pragma unroll
      for (int j = 0; j < kE; ++j) kf[j] = x.k[u].get(j);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kE; ++j) dot = fmaf(qf[g][j], kf[j], dot);
        s[u][g] = dot;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o < lpr) {
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int g = 0; g < kG; ++g)
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
      }
    }
    float p[kU][kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        s[u][g] = x.live[u] ? s[u][g] * x.ks[u] : -INFINITY;
        mx = fmaxf(mx, s[u][g]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float mr = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[g] - mr);   // 0 before the first token
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        p[u][g] = exp2f(s[u][g] - mr);       // 0 for a dead slot
        sum += p[u][g];
        p[u][g] *= x.vs[u];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int j = 0; j < kE; ++j) acc[g][j] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[kE];
#pragma unroll
      for (int j = 0; j < kE; ++j) vf[j] = x.v[u].get(j);
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int j = 0; j < kE; ++j)
          acc[g][j] = fmaf(p[u][g], vf[j], acc[g][j]);
    }
  };

  if constexpr (kVec) {
    // Each warp streams its own tiles of kT tokens (tile i of warp w starts
    // at t_begin + (i * kWarps + w) * kT) through a ring of kStages
    // shared-memory stages filled by cp.async, kStages - 1 tiles ahead of
    // the one it scores: no block barrier in the sweep.
    const int kT = tpw * kU;
    const int row_bytes = hd * (int)sizeof(P);
    const int wshift = __ffs(row_bytes >> 4) - 1;   // log2 16-byte words
    unsigned char* ring = dyn_s + warp * S::kStages * S::kStageBytes;
    const int n_tiles =
        max(0, (t_end - t_begin + kT - 1) / kT - warp + kWarps - 1) / kWarps;
    auto fill = [&](int i) {
      if (i < n_tiles) {
        unsigned char* st = ring + (i % S::kStages) * S::kStageBytes;
        const int t0 = t_begin + (i * kWarps + warp) * kT;
#pragma unroll
        for (int c = 0; c < S::kTileBytes / 16 / 32; ++c) {
          const int w = lane + 32 * c;
          const int t = t0 + (w >> wshift);
          const bool live = t < t_end;
          const long long off =
              live ? row_of(t) * row_bytes + ((w & ((1 << wshift) - 1)) << 4)
                   : 0;
          cp_async16(st + w * 16, reinterpret_cast<const char*>(kp) + off,
                     live ? 16 : 0);
          cp_async16(st + S::kTileBytes + w * 16,
                     reinterpret_cast<const char*>(vp) + off, live ? 16 : 0);
        }
        if constexpr (kQuant) {
          float* sc = reinterpret_cast<float*>(st + 2 * S::kTileBytes);
          for (int tt = lane; tt < kT; tt += 32) {
            const int t = t0 + tt;
            const bool live = t < t_end;
            const long long rw = live ? track_rows + row_of(t) : 0;
            cp_async4(sc + tt, a.k_scale + rw, live ? 4 : 0);
            cp_async4(sc + S::kMaxT + tt, a.v_scale + rw, live ? 4 : 0);
          }
        }
      }
      cp_async_commit();   // an empty group keeps the count uniform
    };
#pragma unroll
    for (int i = 0; i < S::kStages - 1; ++i) fill(i);
    load_q();
    for (int i = 0; i < n_tiles; ++i) {
      fill(i + S::kStages - 1);
      cp_async_wait<S::kStages - 1>();
      __syncwarp();
      const unsigned char* st = ring + (i % S::kStages) * S::kStageBytes;
      const int t0 = t_begin + (i * kWarps + warp) * kT;
      Batch<P, kE, kVec, kU> x;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int tt = u * tpw + wkw;
        const unsigned char* kr =
            st + tt * row_bytes + r * kE * (int)sizeof(P);
        x.k[u].load_shared(kr);
        x.v[u].load_shared(kr + S::kTileBytes);
        x.live[u] = t0 + tt < t_end;
        if constexpr (kQuant) {
          const float* sc = reinterpret_cast<const float*>(
              st + 2 * S::kTileBytes);
          x.ks[u] = sc[tt];
          x.vs[u] = sc[S::kMaxT + tt];
        } else {
          x.ks[u] = x.vs[u] = 1.f;
        }
      }
      step(x);
      __syncwarp();   // the stage is refilled next iteration
    }
    cp_async_wait<0>();
  } else {
    // scalar path: a whole warp per token, kU tokens per warp per step,
    // loaded straight into registers
    load_q();
    for (int t0 = t_begin + warp * kU; t0 < t_end; t0 += kWarps * kU) {
      Batch<P, kE, kVec, kU> x;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + u;
        x.live[u] = t < t_end;
        if (x.live[u]) {
          const long long row = row_of(t);
          x.k[u].load(kp + row * hd, r, hd);
          x.v[u].load(vp + row * hd, r, hd);
          if constexpr (kQuant) {
            x.ks[u] = a.k_scale[track_rows + row];
            x.vs[u] = a.v_scale[track_rows + row];
          } else {
            x.ks[u] = x.vs[u] = 1.f;
          }
        } else {
          x.k[u].zero();
          x.v[u].zero();
          x.ks[u] = x.vs[u] = 0.f;
        }
      }
      step(x);
    }
  }

  // merge the workers of each warp (lanes r, r + lpr, ...), then the warps
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
      float w1, w2, mn;
      merge_w(m[g], m2, w1, w2, mn);
      l[g] = l[g] * w1 + l2 * w2;
      m[g] = mn;
#pragma unroll
      for (int j = 0; j < kE; ++j)
        acc[g][j] = acc[g][j] * w1 +
                    __shfl_xor_sync(0xffffffffu, acc[g][j], o) * w2;
    }
  }
  __syncthreads();   // the ring is done with: it holds the warps' results
  float* wacc_s = reinterpret_cast<float*>(dyn_s);   // [kWarps][G * hd]
  const int n_out = G * hd;
  if (lane < lpr) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int d = elem<kE, kVec>(r, j);
        if (d < hd) wacc_s[warp * n_out + g * hd + d] = acc[g][j];
      }
      if (lane == 0) {
        wm_s[warp][g] = m[g];
        wl_s[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out) + q_off;
  const int bid = z * KH + kh;
  const size_t n_slots = (size_t)gridDim.z * KH * a.n_split;
  const size_t slot = (size_t)bid * a.n_split + split;
  float* ws_acc = a.ws;
  float* ws_ml = a.ws + n_slots * n_out;
  for (int i = tid; i < n_out; i += kThreads) {
    const int g = i / hd;
    float M = wm_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, wm_s[w][g]);
    const float mr = M == -INFINITY ? 0.f : M;
    float Lb = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(wm_s[w][g] - mr);
      Lb += wl_s[w][g] * e;
      A += wacc_s[w * n_out + i] * e;
    }
    if (a.n_split == 1) {
      out[i] = rt::from_f<T>(Lb > 0.f ? A / Lb : 0.f);
    } else {
      ws_acc[slot * n_out + i] = A;   // an empty split writes zeros
      if (i % hd == 0) {
        ws_ml[(slot * G + g) * 2] = M;
        ws_ml[(slot * G + g) * 2 + 1] = Lb;
      }
    }
  }
  if (a.n_split == 1) return;

  // ticket: the last split of this (track, row, KV head) merges them all
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_s = atomicAdd(a.counters + bid, 1) == a.n_split - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last_s) return;
  const size_t slot0 = (size_t)bid * a.n_split;
  float* part_s = reinterpret_cast<float*>(dyn_s);
  const int chunk = S::kSmem / 4 / n_out;   // >= kWarps splits
  const float* src = ws_acc + slot0 * n_out;
  // a chunk of the splits' partial accumulators into shared memory
  // (coalesced, all loads in flight at once; n_out = G * hd is a multiple
  // of 4)
  auto fetch = [&](int sp0, int n_sp) {
    const float4* src4 =
        reinterpret_cast<const float4*>(src + (size_t)sp0 * n_out);
#pragma unroll 8
    for (int e = tid; e < n_sp * n_out / 4; e += kThreads)
      reinterpret_cast<float4*>(part_s)[e] = __ldcg(src4 + e);
  };
  fetch(0, min(chunk, a.n_split));   // in flight with the (m, l) loads
  for (int i = tid; i < a.n_split * G; i += kThreads) {
    const int sp = i / G, g = i % G;
    sm_s[sp][g] = __ldcg(ws_ml + ((slot0 + sp) * G + g) * 2);
    sl_s[sp][g] = __ldcg(ws_ml + ((slot0 + sp) * G + g) * 2 + 1);
  }
  __syncthreads();
  if (tid < G) {
    float M = -INFINITY;
    for (int sp = 0; sp < a.n_split; ++sp) M = fmaxf(M, sm_s[sp][tid]);
    const float mr = M == -INFINITY ? 0.f : M;
    float Lt = 0.f;
    for (int sp = 0; sp < a.n_split; ++sp) {   // split order
      const float e = exp2f(sm_s[sp][tid] - mr);
      sm_s[sp][tid] = e;
      Lt += sl_s[sp][tid] * e;
    }
    tot_s[tid] = Lt;
  }
  __syncthreads();
  // the partial accumulators, a chunk of splits at a time, summed in split
  // order
  constexpr int kPerThread = kMaxG * kMaxHd / kThreads;   // outputs a thread
  float A[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) A[k] = 0.f;
  for (int sp0 = 0; sp0 < a.n_split; sp0 += chunk) {
    const int n_sp = min(chunk, a.n_split - sp0);
    if (sp0 > 0) {
      __syncthreads();
      fetch(sp0, n_sp);
      __syncthreads();
    }
#pragma unroll 1
    for (int k = 0; k < kPerThread; ++k) {
      const int i = tid + k * kThreads;
      if (i < n_out) {
        const int g = i / hd;
        for (int sp = 0; sp < n_sp; ++sp)
          A[k] = fmaf(part_s[sp * n_out + i], sm_s[sp0 + sp][g], A[k]);
      }
    }
  }
  if (tid == 0) a.counters[bid] = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = tid + k * kThreads;
    if (i < n_out) {
      const float Lt = tot_s[i / hd];
      out[i] = rt::from_f<T>(Lt > 0.f ? A[k] / Lt : 0.f);
    }
  }
}

// elements per lane of the vector path: 16 bytes of fp32 or bf16, 8 bytes
// of int8 (16 int8 elements for G heads of q and of the accumulators would
// cost 2 G * 16 registers and a third of the blocks an SM holds)
template <typename P>
constexpr int vec_elems() {
  return std::is_same<P, float>::value ? 4 : 8;
}

// one launch; the dynamic shared memory (with the static, it may pass the
// default 48 KB) is asked for once per device
template <typename T, typename P, bool kPaged, int kG, int kE, bool kVec>
int go(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr int smem = Shape<P, kG, kE, kVec>::kSmem;
  auto kernel = decode_kernel<T, P, kPaged, kG, kE, kVec>;
  static unsigned long long asked = 0;   // bit per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(asked >> dev & 1ull)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    asked |= 1ull << dev;
  }
  kernel<<<grid, kThreads, smem, s>>>(a);
  return 0;
}

template <typename T, typename P, bool kPaged, int kG>
int launch_g(const Args& a, dim3 grid, cudaStream_t s, bool vec) {
  if (vec) {
    constexpr int kE = vec_elems<P>();
    const int lpr = a.hd / kE;
    const uintptr_t align = kE * sizeof(P);
    // the wrapper checked the rows; refuse a layout the kernel cannot take
    if (a.hd % kE || lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) ||
        (uintptr_t)a.k % align || (uintptr_t)a.v % align)
      return (int)cudaErrorInvalidValue;
    return go<T, P, kPaged, kG, kE, true>(a, grid, s);
  }
  return go<T, P, kPaged, kG, kScalarE, false>(a, grid, s);
}

template <typename T, typename P, bool kPaged>
int launch_tp(const Args& a, dim3 grid, cudaStream_t s, bool vec) {
  const int G = a.H / a.KH;
  if (G <= 1) return launch_g<T, P, kPaged, 1>(a, grid, s, vec);
  if (G <= 2) return launch_g<T, P, kPaged, 2>(a, grid, s, vec);
  if (G <= 4) return launch_g<T, P, kPaged, 4>(a, grid, s, vec);
  return launch_g<T, P, kPaged, 8>(a, grid, s, vec);
}

// tag values pick the (q type, cache type) instantiation
template <bool kPaged>
int dispatch(const Args& a, int n_bases_z, int dtype, int cache_dtype,
             int vec, void* stream) {
  if (a.H % a.KH != 0 || a.H / a.KH > kMaxG || a.hd > kMaxHd || a.hd < 1 ||
      a.n_split < 1 || a.n_split > kMaxSplits || a.split_len < 1 ||
      (a.n_split > 1 && (a.ws == nullptr || a.counters == nullptr)) ||
      (kPaged && (a.split_len % a.bs || a.split_len / a.bs > kMaxPages)))
    return (int)cudaErrorInvalidValue;
  const bool quant = cache_dtype == rt::kInt8;
  if (quant ? (a.k_scale == nullptr || a.v_scale == nullptr)
            : cache_dtype != dtype)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.n_split, a.KH, n_bases_z);
  int err;
  if (dtype == rt::kFloat32 && quant)
    err = launch_tp<float, int8_t, kPaged>(a, grid, s, vec);
  else if (dtype == rt::kFloat32)
    err = launch_tp<float, float, kPaged>(a, grid, s, vec);
  else if (dtype == rt::kBFloat16 && quant)
    err = launch_tp<__nv_bfloat16, int8_t, kPaged>(a, grid, s, vec);
  else if (dtype == rt::kBFloat16)
    err = launch_tp<__nv_bfloat16, __nv_bfloat16, kPaged>(a, grid, s, vec);
  else
    return (int)cudaErrorInvalidValue;
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// q [n, B, H, hd]; k_pool/v_pool [n, N, bs, KH, hd] of q's dtype, or int8
// (pool_dtype rt::kInt8) with k_scale/v_scale [n, N, bs, KH, 1] fp32 (null
// for fp pools); table [B, nmax] int32; lengths [B] int32; out [n, B, H, hd]
// of q's dtype; n_sweep the table columns the sweep may visit; n_split
// splits of split_len tokens (a multiple of bs); ws fp32 [n*B*KH*n_split*G*
// (hd + 2)] and counters int32 [n*B*KH], zero, when n_split > 1 (else
// null); vec 1 for the vector path (rows of 16-byte words, 16-byte aligned).
// All contiguous, on one device.  Returns cudaGetLastError() after the
// launch.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, void* out, void* ws, void* counters, int n, int B,
    int H, int KH, int hd, int N, int bs, int nmax, int n_sweep, int n_split,
    int split_len, float scale, int dtype, int pool_dtype, int vec,
    void* stream) {
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(table),
               static_cast<const int*>(lengths), out,
               static_cast<float*>(ws), static_cast<int*>(counters), B, H, KH,
               hd, N, bs, nmax, n_sweep * bs, n_split, split_len, scale};
  return dispatch<true>(a, n * B, dtype, pool_dtype, vec, stream);
}

// q [B, H, hd]; k_cache/v_cache [B, S, KH, hd] of q's dtype, or int8
// (cache_dtype rt::kInt8) with k_scale/v_scale [B, S, KH, 1] fp32 (null for
// fp caches); lengths [B] int32; n_cols (1..S) the columns the sweep may
// visit; out [B, H, hd] of q's dtype; n_split, split_len, ws, counters and
// vec as for the paged entry (counters [B*KH]).  All contiguous, on one
// device.  Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* lengths, void* out,
    void* ws, void* counters, int B, int H, int KH, int hd, int S,
    int n_cols, int n_split, int split_len, float scale, int dtype,
    int cache_dtype, int vec, void* stream) {
  const Args a{q, k_cache, v_cache, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), nullptr,
               static_cast<const int*>(lengths), out,
               static_cast<float*>(ws), static_cast<int*>(counters), B, H, KH,
               hd, B, S, 1, n_cols, n_split, split_len, scale};
  return dispatch<false>(a, B, dtype, cache_dtype, vec, stream);
}
