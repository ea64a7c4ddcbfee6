// Flash attention for prefill on Hopper: causal or full softmax attention
// with fp32 scores and accumulators, GQA by head index (no expanded K/V
// copy), optional tanh softcap, causal k-tiles above the diagonal skipped.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// ::flash_attention (_kernel; pallas_call at :104).  Contract: q [B, Sq,
// H, hd], k [B, Sk, KH, hd] and v [B, Sk, KH, dv] un-expanded (query head
// h reads KV head h / (H / KH)), dv <= hd (MLA's prefill: q / k 192 wide,
// v 128, as the Pallas kernel's dv), out [B, Sq, H, dv] in q's dtype,
// scale hd^-0.5; row i sees key columns
// j <= i when causal; softcap s -> cap * tanh(s / cap) before the mask;
// out = (sum_j p_j v_j) / max(l, 1e-37).  Beyond the Pallas kernel: a
// sliding window W (row i sees only j > i - W; key tiles wholly before a
// query tile's window are skipped), and per batch row b a query offset
// and a key length (row b's query i sits at position q_off[b] + i and
// sees keys j < k_len[b]), with which the chunk program attends a
// prompt's tail over its K/V gathered from the cache.
//
// Offsets and bits: a row visits the key tiles from its window's (or
// key 0's) tile on, in order, up to its query tile's last row, whatever
// its offset.  A tile past a row's diagonal has every score masked to
// -inf: its max leaves m as it is, its rescale factor is exp2(0) = 1 and
// its probabilities are exact zeros, so it leaves m, l and the
// accumulator unchanged bit for bit.  A row's sums thus run over the
// same tiles in the same order as in a prefill from position 0, and per
// row the arithmetic does not depend on where the row sits in its tile:
// a warm tail's rows get the cold prefill's bits.
//
// Two routes, chosen by shape on the host (flash_attention.py::route) and
// passed in.  What bounds each at the serve shapes (pt-6b-d4: q
// [64,512,4,128], k, v [64,512,1,128]; dense-6b: q [8,512,32,128], k, v
// [8,512,8,128]; both bf16, causal): q, k, v read once and out written
// once are 83.9 MB, 0.0250 ms at 3.35 TB/s; the causal products, 4 B H
// hd S (S + 1) / 2 = 17.2 GFLOP, take 0.0174 ms at 989 TFLOP/s (bf16
// tensor cores) and 0.257 ms at 67 TFLOP/s (fp32 on the CUDA cores).
//
//   * wgmma_tma (bf16, (hd, dv) (64, 64), (128, 128), MLA's (192, 128),
//     or the gemma heads' (256, 256), (288, 288) and (320, 320), 16-byte-
//     aligned bases; the serve path): bound by the bytes at hd 128, with
//     the products close behind (by the products at hd 256-320), so only
//     wgmma gets near it.  On the SM the products (at 128 x 128 tiles the
//     causal diagonal is computed whole: 21.5 GFLOP, 0.0217 ms), the
//     softmax's 42 M exponentials (MUFU, 16 a clock on each SM: ~0.011 ms)
//     and the K / V tiles that each of the G query heads re-reads from L2
//     (~200 MB into shared memory) all compete.  The design:
//     - a persistent grid, one block per SM, walks (q-tile, head, batch)
//       tiles heaviest causal q-tile first, the G query heads of one KV
//       head side by side so their K / V reads hit L2;
//     - a block is three warpgroups: a producer that gives its registers
//       away (setmaxnreg) and whose one thread issues every TMA load, and
//       two consumers, each owning 64 of the tile's 128 query rows;
//     - TMA moves Q (double buffered at hd 64 and 128: the next tile's Q
//       lands during this one) and K, V tiles of BK keys (128 up to hd
//       192) through 4-D tensor maps over (hd,
//       heads, S, B) with 128-byte swizzle: an hd-128 row is two 64-column
//       boxes; S being its own dimension, TMA zero-fills the ragged end of
//       each sequence without touching the next batch row, and the KV
//       head is a coordinate.  K and V have 2-stage rings of their own on
//       mbarriers, K one tile ahead: a K stage goes back to the producer
//       as soon as its Q K^T is done, a V stage once its P V is;
//     - S = Q K^T is wgmma m64nBKk16 with both operands K-major in shared
//       memory;
//     - the softmax stays in registers: scale * log2(e) folded into one
//       FMA before ex2, row max and sum over the 4 lanes that share a row,
//       the causal and ragged-Sk mask only on k-tiles that cross the
//       diagonal or the end of the keys, the softcap a template flag;
//     - P is rounded to bf16 into wgmma's register A operand (the m64nN
//       accumulator's layout is the k16 A fragment's, as in
//       FlashAttention-3), and O += P V reads V from shared memory as an
//       MN-major operand (the transpose flag): no fragment is gathered by
//       hand;
//     - within a warpgroup, k-tile j's Q K^T and k-tile j-1's P V are
//       issued together and the softmax of j runs under the P V; the two
//       warpgroups take turns issuing (a ping-pong on named barriers), so
//       one's softmax runs under the other's products;
//     - the epilogue divides by max(l, 1e-37), rounds to bf16 (nearest
//       even) into the warpgroup's half of the Q buffer, which its own
//       last Q K^T has freed, and TMA stores it, clipping the ragged rows;
//       the buffer goes back to the producer after the next q-tile's first
//       issue, so no thread waits on the store.
//     At (192, 128) two Q buffers, two K and two V stages would take 256
//     KB: that instantiation keeps one Q buffer (208 KB), whose output
//     store the warpgroup waits for before it hands the buffer back, so
//     the next q-tile's Q loads start after this tile's epilogue (its
//     first K stage is issued before that wait).
//     The wide heads (a block has 227 KB; a Q buffer is 128 hd 2 bytes,
//     a K or V stage BK hd 2) keep one Q buffer and two K and two V
//     stages, with the key tile BK a function of the width (Smem::kBK):
//       hd 256, BK 64: Q 64 KB + K 2 x 32 + V 2 x 32 = 192 KB;
//       hd 320, BK 64 would be 80 + 80 + 80 = 240 KB: BK 48 is 80 + 60 +
//       60 = 200 KB.
//     S = Q K^T is then m64n64k16 / m64n48k16 over hd / 16 k-steps; P V
//     (N at most 256) runs as n128 products on two-box boundaries and an
//     n64 for a last odd box (320 = 128 + 128 + 64), so no descriptor
//     starts inside a 128-byte swizzle atom.  Registers: ptxas holds the
//     consumers to setmaxnreg's 232 (without it, to the launch's 168).
//     The fp32 output accumulator is dv / 2 registers a thread (128 at 256,
//     160 at 320), S BK / 2 and P BK / 4, so a wide warpgroup issues k-tile
//     j - 1's P V and j's Q K^T together and runs the softmax of j after
//     both (Smem::kIssue, fa::kJoint): S, P and O are live together only
//     while they issue, and S not at all from its packing into P to the
//     next Q K^T (fresh_regs).  The Q, K and V descriptors (at every
//     width) are one opaque base each plus constant steps, else the
//     compiler hoists the hd / 16 loop-invariant Q descriptors into
//     registers; the wide instantiations then build with 0 spill bytes.
//     The two warpgroups' ping-pong stays.  Every key tile is computed:
//     skipping warpgroup 0's tiles wholly past its rows' diagonal
//     measured no faster (a branch around a
//     product needs a warp-uniform warpgroup index, from a shuffle, else
//     ptxas serializes every wgmma: C7520).  hd 288 is 4.5 boxes of 64
//     columns: it runs the 320 instantiation over maps of the true width
//     288 (576-byte rows); TMA fills columns 288-319 of q, k and v with
//     zeros, which add exact zeros to Q K^T and give output columns
//     288-319 that the store's map clips.  At hd 256 a 64-key tile's Q K^T
//     reads its A and B operands from shared memory (128 KB a block),
//     beside the P V's V (64 KB) and the TMA writes (64 KB): 256 KB a tile
//     against 2048 clocks of products, the shared memory's 128 bytes a
//     clock, so the route sits near 58 % of the products' bound there.
//     The (64, 64), (128, 128) and (192, 128) instantiations issue the
//     same products in the same order as before, so their outputs are
//     the same bits.
//     Measured on an H100 80GB HBM3 at 700 W at the pt-6b-d4 shape
//     (tools/flash_attention_variants.py, device work): ~0.047 ms whole;
//     0.040 without the products, 0.042 without the softmax, 0.044
//     without the store, 0.022 with the loads alone.  So the SM's chain of
//     loads, softmax and products, not the bytes, sets the time; a third
//     Q buffer or K stage does not shorten it.
//   * cuda_core (fp32, other widths up to 320, unaligned bases): bound by
//     the fp32 operations on the CUDA cores (no TF32: the fp32 reference
//     configs keep fp32 products).  The kernel right below keeps every
//     intermediate on chip:
//     - grid (ceil(Sq/64), H, batch): a block owns 64 query rows of one
//       head and reads K/V of KV head h / G straight from the [B, S, KH,
//       hd] projections, which cuts the bytes of the expanded copy G-fold;
//     - 256 threads: 4 per query row; each computes 8 of the 32 scores of
//       a k-tile and owns hd/4 output columns of the fp32 accumulator (32
//       registers up to hd 128, 80 up to hd 320, two instantiations);
//     - the online-softmax state (m, l) stays in registers, the 64x32 tile
//       of probabilities in shared memory; rows reduce over 4 lanes;
//     - causal: the k loop stops at the tile's last row, ragged row and
//       column edges are masked in-kernel, so no length has to tile 64.
//
// Rounding: the Pallas kernel casts q, k and v to fp32 and runs both of
// its products in fp32.  The wgmma_tma route multiplies bf16 q, k, v as
// they are (exact products, fp32 sums) and rounds P to bf16 before P V,
// as FlashAttention-2 and -3 do (a choice of this port, not the Pallas
// kernel's); the row sums l add the unrounded fp32 p.  The cuda_core
// route keeps everything in fp32.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 32;                  // keys per tile
constexpr int kThreads = 256;            // 4 threads per query row
constexpr int kMaxHd = 320;
constexpr int kCPerThread = kBK / 4;     // score columns per thread

inline size_t smem_bytes(int hd) {
  const int ld = hd + 1;                 // +1 float: no bank conflicts
  return sizeof(float) *
         ((size_t)kBQ * ld + 2 * (size_t)kBK * ld + (size_t)kBQ * (kBK + 1));
}

// DPT: accumulator columns per thread (hd <= 4 DPT)
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       const int* __restrict__ q_off,
                       const int* __restrict__ k_len, int Sq, int Sk, int H,
                       int KH, int hd, int dv, int causal, int window,
                       float softcap, float scale) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int qo = q_off ? q_off[b] : 0;   // position of the row's query 0
  const int kl = k_len ? k_len[b] : Sk;  // the row's keys
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

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int row = q0 + r;
  const int pos = qo + row;              // the query's position
  // causal: a k-tile whose first column is past the block's last row
  // contributes nothing and is never loaded; with a window, neither does
  // one wholly before the block's first row's window
  const int k_end = causal ? min(kl, qo + q0 + kBQ) : kl;
  const int k_begin = window > 0 ? max(0, qo + q0 - window + 1) / kBK * kBK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // Q_s is written / the previous tile is consumed
    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int c = idx / hd, d = idx % hd, ki = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (ki < kl) {
        const size_t row = ((size_t)b * Sk + ki) * KH + kh;
        kx = rt::to_f(k[row * hd + d]);
        if (d < dv) vx = rt::to_f(v[row * dv + d]);
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
      const bool ok = col < kl && (!causal || col <= pos) &&
                      (window <= 0 || col > pos - window);
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
    for (int i = 0; i < DPT; ++i) {
      const int d = j + 4 * i;
      if (d < dv) {
        float a = acc[i] * alpha;
        for (int c = 0; c < kBK; ++c) a += P_s[r * (kBK + 1) + c] * V_s[c * ld + d];
        acc[i] = a;
      }
    }
  }

  if (row < Sq) {
    const float denom = fmaxf(l, 1e-37f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = j + 4 * i;
      if (d < dv)
        out[(((size_t)b * Sq + row) * H + h) * dv + d] = rt::from_f<T>(acc[i] / denom);
    }
  }
}


// ---------------------------------------------------------------------------
// wgmma_tma route
// ---------------------------------------------------------------------------
namespace fa {
constexpr int kBQ = 128;                // query rows per tile, 64 a consumer
constexpr int kKStages = 2;             // K ring
constexpr int kVStages = 2;             // V ring
constexpr int kThreads = 384;           // producer + two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;        // a block's opt-in shared memory
// how a consumer warpgroup issues k-tile j's Q K^T and k-tile j - 1's P V
// in its turn: kOverlapped (both, then the softmax of j while the P V
// runs: S, P and O live together beside the softmax's temporaries) or
// kJoint (both, then the softmax once both are done: S, P and O live
// together only while they issue, S not at all between its packing into P
// and the next Q K^T)
constexpr int kOverlapped = 0, kJoint = 1;
// HD: the q / k width, DV: the value (and output) width the boxes hold (a
// tensor map may be narrower: hd 288 runs <320, 320>)
template <int HD, int DV>
struct Smem {
  // keys per K / V stage: 128 up to q / k width 192; 64 at 256 and 48 at
  // 320, where one Q buffer and two K and two V stages of 128 keys would
  // not fit (the arithmetic is in the header)
  static constexpr int kBK = HD <= 192 ? 128 : HD <= 256 ? 64 : 48;
  // the dv / 2 accumulator registers, S (BK / 2) and P (BK / 4) fit the
  // consumers' 232 with the softmax's temporaries up to width 192; at 320
  // (160 + 24 + 12) only while they issue.  At 256 (128 + 32 + 16) both
  // fit, and took the same time within the runs' spread
  // (tools/flash_attention_variants.py)
  static constexpr int kIssue = HD <= 192 ? kOverlapped : kJoint;
  static constexpr int kQ = kBQ * HD * 2;       // one Q buffer (32 KB at 128)
  static constexpr int kK = kBK * HD * 2;       // one K stage
  static constexpr int kV = kBK * DV * 2;       // one V stage
  static constexpr int bytes(int q_bufs) {
    return q_bufs * kQ + kKStages * kK + kVStages * kV +
           16 * (q_bufs + kKStages + kVStages) + 1024;  // barriers, alignment
  }
  // the Q ring (a Q buffer is also the output's staging): two buffers
  // where they fit (the next q-tile's Q lands during this one), else one
  static constexpr int kQBufs = bytes(2) <= kMaxSmem ? 2 : 1;
  static constexpr int kBytes = bytes(kQBufs);
};
}  // namespace fa

// d[64] = A (64 x 16, K-major in shared memory) * B (16 x 128, K-major in
// shared memory) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d[32] = A (64 x 16, K-major in shared memory) * B (16 x 64, K-major in
// shared memory) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[24] = A (64 x 16, K-major in shared memory) * B (16 x 48, K-major in
// shared memory) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, "
      "p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64] = A (64 x 16, bf16 pairs in registers) * B (16 x 128, MN-major in
// shared memory: the transpose flag) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_rs_n128t(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
      "%67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d[32] = A (64 x 16, bf16 pairs in registers) * B (16 x 64, MN-major in
// shared memory: the transpose flag) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_rs_n64t(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// keeps the compiler from moving register reads or writes across the
// asynchronous wgmma (accumulators and the register A operand)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// gives d fresh values (zeros) for a Q K^T whose first step overwrites
// them: S is then dead, and its registers free, from its last read to here
template <int N>
__device__ __forceinline__ void fresh_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("mov.b32 %0, 0;\n" : "=f"(d[i]));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The two consumer warpgroups take turns issuing their products (named
// barrier 3 + w, 256 threads: warpgroup w's sync meets the other's
// arrive), so one's softmax runs while the other's products do.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two bf16 in one register (round to nearest even), the lower column in
// the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// S = Q K^T for one warpgroup: q its 64 rows in the Q buffer (HD / 64
// boxes of 128-byte rows, kBQ rows apart), k the stage's BK keys (boxes BK
// rows apart), m64nBKk16 (BK 128, 64 or 48).  The k16 step kk starts 32
// (kk % 4) bytes into the rows of box kk / 4.
template <int HD, int BK>
__device__ __forceinline__ void qk(float (&s)[BK / 2], const uint8_t* q,
                                   const uint8_t* k) {
  // one descriptor per operand, opaque to the compiler, and each step's
  // a constant on (its address field, in 16-byte units, cannot carry
  // below 256 KB): the HD / 16 loop-invariant Q descriptors would
  // otherwise be hoisted out of the key loop into registers
  uint64_t qd = sw128_desc(q), kd = sw128_desc(k);
  asm volatile("" : "+l"(qd), "+l"(kd));
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk / 4) * (fa::kBQ * 128) + (kk % 4) * 32;
    const int koff = (kk / 4) * (BK * 128) + (kk % 4) * 32;
    const uint64_t da = qd + (off >> 4), db = kd + (koff >> 4);
    if constexpr (BK == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else if constexpr (BK == 64)
      wgmma_ss_n64(s, da, db, kk > 0);
    else
      wgmma_ss_n48(s, da, db, kk > 0);
  }
}

// N registers of an accumulator from register `at` on: columns 2 at ..
// 2 (at + N) - 1 of a wider m64nN one (its registers are its n8 blocks in
// order, 4 a block)
template <int N, int M>
__device__ __forceinline__ float (&cols(float (&o)[M], int at))[N] {
  return *reinterpret_cast<float(*)[N]>(&o[at]);
}

// O += P V: the k16 step kk takes keys 16 kk .. + 15 (2 KB into each
// box); V is MN-major, its 64-column boxes LBO = BK * 128 bytes apart, its
// 8-key groups SBO = 1 KB apart.  N is at most 256, so O's columns go as
// n128 products on two-box boundaries and, where DV % 128 is 64, an n64
// for the last box (320 = 128 + 128 + 64): a product that started inside
// a box would start its descriptor inside a 128-byte swizzle atom.
template <int DV, int BK>
__device__ __forceinline__ void pv(float (&o)[DV / 2],
                                   const uint32_t (&p)[BK / 16][4],
                                   const uint8_t* v, int acc) {
  // one opaque descriptor and constant steps, as qk's
  uint64_t vd = sw128_desc(v, BK * 128, 1024);
  asm volatile("" : "+l"(vd));
  auto at = [&](int bytes) { return vd + (bytes >> 4); };
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < DV / 128; ++c)
      wgmma_rs_n128t(cols<64>(o, 64 * c), p[kk],
                     at(c * 2 * (BK * 128) + kk * 16 * 128), acc || kk > 0);
    if constexpr (DV % 128 != 0)
      wgmma_rs_n64t(cols<32>(o, DV / 2 - 32), p[kk],
                    at((DV / 64 - 1) * (BK * 128) + kk * 16 * 128),
                    acc || kk > 0);
  }
}

// One k-tile's online softmax on this thread's scores s (rows at
// positions r0 = its fragment row g's, r0 + 8; columns k0 + 8 j + 2 t4 +
// (e & 1) of s[4 j + e], e < 2 on r0).  Scores become probabilities in
// place, in the units of x * c2 (CAP: x = cap tanh(s pre), c2 = log2 e;
// else x = s, c2 = scale log2 e); m is the running max of x, l this
// thread's share of the running sum; returns the factors the accumulator
// rows are rescaled by.  `mask`: the tile crosses the diagonal, the end
// of the keys (kl) or the start of a window.  N: BK / 2 scores.
template <bool CAP, int N>
__device__ __forceinline__ float2 softmax_tile(float (&s)[N], float& m0,
                                               float& m1, float& l0,
                                               float& l1, bool mask, int k0,
                                               int t4, int r0, int kl,
                                               int causal, int window,
                                               float c2, float pre,
                                               float cap) {
  if (CAP) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = cap * tanhf(s[i] * pre);
  }
  if (mask) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int row = r0 + ((i & 2) ? 8 : 0);
      if (col >= kl || (causal && col > row) ||
          (window > 0 && col <= row - window))
        s[i] = -INFINITY;
    }
  }
  float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i & 2) x1 = fmaxf(x1, s[i]);
    else x0 = fmaxf(x0, s[i]);
  }
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
  const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
  const float u0 = n0 == -INFINITY ? 0.f : n0;   // a row masked so far
  const float u1 = n1 == -INFINITY ? 0.f : n1;
  const float a0 = ex2((m0 - u0) * c2), a1 = ex2((m1 - u1) * c2);
  const float b0 = u0 * c2, b1 = u1 * c2;
  m0 = n0;
  m1 = n1;
  float p0 = 0.f, p1 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i & 2) {
      s[i] = ex2(fmaf(s[i], c2, -b1));
      p1 += s[i];
    } else {
      s[i] = ex2(fmaf(s[i], c2, -b0));
      p0 += s[i];
    }
  }
  l0 = l0 * a0 + p0;
  l1 = l1 * a1 + p1;
  return make_float2(a0, a1);
}

// the probabilities of s as wgmma's A fragments: k16 step kk is score
// columns 16 kk .. + 15, i.e. accumulator n8 blocks 2 kk and 2 kk + 1
template <int K>
__device__ __forceinline__ void pack_p(const float (&s)[8 * K],
                                       uint32_t (&p)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[kk][e] = pack2(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

template <int HD, int DV, bool CAP>
__global__ void __launch_bounds__(fa::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap omap,
                             const int* __restrict__ q_off,
                             const int* __restrict__ k_len, int B, int Sq,
                             int Sk, int H, int KH, int causal, int window,
                             float c2, float pre, float cap) {
  using SM = fa::Smem<HD, DV>;
  constexpr int BQ = fa::kBQ, BK = SM::kBK;
  constexpr int QS = SM::kQBufs, KS = fa::kKStages, VS = fa::kVStages;
  constexpr int NB = HD / 64;           // 64-column boxes per q / k row
  constexpr int NV = DV / 64;           // per v / output row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + QS * SM::kQ;
  uint8_t* vs = ks + KS * SM::kK;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + VS * SM::kV);
  uint64_t* q_empty = q_full + QS;
  uint64_t* k_full = q_empty + QS;
  uint64_t* k_empty = k_full + KS;
  uint64_t* v_full = k_empty + KS;
  uint64_t* v_empty = v_full + VS;

  const int tid = threadIdx.x;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int tiles = n_qt * H * B;
  const int G = H / KH;
  if (tid == 0) {
    for (int i = 0; i < QS; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 2);        // one arrival per consumer warpgroup
    }
    for (int i = 0; i < KS; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&k_empty[i], 8);        // one arrival per consumer warp
    }
    for (int i = 0; i < VS; ++i) {
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile t: q-tile (the heaviest causal ones first), then batch, then
  // head fastest, so the G heads of a KV head run side by side.  The tile
  // reads key tiles j0 .. j0 + n - 1 of its batch row (qo: the position
  // of the row's query 0, kl: its keys)
  auto decode = [&](int t, int& q0, int& h, int& b, int& n, int& j0,
                    int& qo, int& kl) {
    const int qt = causal ? n_qt - 1 - t / (H * B) : t / (H * B);
    const int r = t % (H * B);
    b = r / H;
    h = r % H;
    q0 = qt * BQ;
    qo = q_off ? q_off[b] : 0;
    kl = k_len ? k_len[b] : Sk;
    const int k_end = causal ? min(kl, qo + q0 + BQ) : kl;
    const int j_end = (k_end + BK - 1) / BK;
    j0 = window > 0 ? max(0, qo + q0 - window + 1) / BK : 0;
    j0 = max(0, min(j0, j_end - 1));
    n = max(1, j_end - j0);
  };

  if (tid < 128) {                      // producer: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      // K / V tile u (counted over all tiles) in stage u % KS of the K
      // ring and u % VS of the V ring.  K runs one tile ahead of V, as
      // the consumers use them: tile j's Q K^T beside tile j - 1's P V.
      auto load_k = [&](int u, int j, int kh, int b) {
        const int s = u % KS;
        mbar_wait(&k_empty[s], ((u / KS) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], SM::kK);
        for (int x = 0; x < NB; ++x)
          tma_load_4d(ks + s * SM::kK + x * (BK * 128), &kmap, &k_full[s],
                      64 * x, kh, j * BK, b);
      };
      auto load_v = [&](int u, int j, int kh, int b) {
        const int s = u % VS;
        mbar_wait(&v_empty[s], ((u / VS) & 1) ^ 1);
        mbar_expect_tx(&v_full[s], SM::kV);
        for (int x = 0; x < NV; ++x)
          tma_load_4d(vs + s * SM::kV + x * (BK * 128), &vmap, &v_full[s],
                      64 * x, kh, j * BK, b);
      };
      int u = 0, i = 0;                 // K / V tiles, q-tiles so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        int q0, h, b, n, j0, qo, kl;
        decode(t, q0, h, b, n, j0, qo, kl);
        const int qb = i % QS;
        // one Q buffer: it is free only once the previous q-tile's output
        // store has read it, so this tile's first K stage goes first
        constexpr int early = QS == 1 ? 1 : 0;
        if (early) load_k(u, j0, h / G, b);
        mbar_wait(&q_empty[qb], ((i / QS) & 1) ^ 1);
        mbar_expect_tx(&q_full[qb], SM::kQ);
        for (int x = 0; x < NB; ++x)
          tma_load_4d(qs + qb * SM::kQ + x * (BQ * 128), &qmap, &q_full[qb],
                      64 * x, h, q0, b);
        for (int j = 0; j < n; ++j) {
          if (j >= early) load_k(u + j, j0 + j, h / G, b);
          if (j > 0) load_v(u + j - 1, j0 + j - 1, h / G, b);
        }
        load_v(u + n - 1, j0 + n - 1, h / G, b);
        u += n;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = tid - 128;             // consumer thread
  const int cw = ct >> 7;               // warpgroup: rows 64 cw .. + 63
  const int lane = ct & 31, wq = (ct >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int rl = 16 * wq + g;           // this thread's rows rl, rl + 8 of 64
  const bool leader = (ct & 127) == 0;  // issues the warpgroup's stores
  float s[BK / 2];                      // scores, then probabilities
  float o[DV / 2];                      // each tile's first P V overwrites
  uint32_t p[BK / 16][4];               // P as wgmma A fragments
  int u = 0, i = 0;                     // K / V tiles, q-tiles so far
  int pend = -1;                        // Q buffer a store still reads
  if (cw == 1) turn_pass(cw);           // warpgroup 0 issues first
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    int q0, h, b, n, j0, qo, kl;
    decode(t, q0, h, b, n, j0, qo, kl);
    const int qb = i % QS;
    uint8_t* qh = qs + qb * SM::kQ + cw * (64 * 128);  // the warpgroup's rows
    const int lo = qo + q0 + 64 * cw;           // its first row's position
    const int r0 = lo + rl;                     // this thread's rows r0, r0 + 8
    auto needs_mask = [&](int k0) {
      return k0 + BK > kl || (causal && k0 + BK - 1 > lo) ||
             (window > 0 && k0 <= lo + 63 - window);
    };
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(&q_full[qb], (i / QS) & 1);

    // k-tile 0: S, its softmax, P
    mbar_wait(&k_full[u % KS], (u / KS) & 1);
    if constexpr (SM::kIssue == fa::kOverlapped)
      fence_regs(s);
    else
      fresh_regs(s);
    turn_wait(cw);
    wgmma_fence();
    qk<HD, BK>(s, qh, ks + (u % KS) * SM::kK);
    wgmma_commit();
    turn_pass(cw);
    if (leader && pend >= 0) {
      // the previous tile's store has read its staging by now: the buffer
      // goes back to the producer for the q-tile after next
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(&q_empty[pend]);
    }
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&k_empty[u % KS]);
    softmax_tile<CAP>(s, m0, m1, l0, l1, needs_mask(j0 * BK), j0 * BK, t4, r0,
                      kl, causal, window, c2, pre, cap);
    pack_p(s, p);

    // k-tile j: its Q K^T and k-tile j - 1's P V in one turn, as
    // SM::kIssue says; o takes the same products in the same order
    for (int j = 1; j < n; ++j) {
      const int uk = u + j, uv = u + j - 1;
      mbar_wait(&k_full[uk % KS], (uk / KS) & 1);
      mbar_wait(&v_full[uv % VS], (uv / VS) & 1);
      if constexpr (SM::kIssue == fa::kOverlapped)
        fence_regs(s);
      else
        fresh_regs(s);
      fence_regs(o);
      fence_regs(p);
      turn_wait(cw);
      wgmma_fence();
      if constexpr (SM::kIssue == fa::kOverlapped) {
        qk<HD, BK>(s, qh, ks + (uk % KS) * SM::kK);
        wgmma_commit();
        pv<DV, BK>(o, p, vs + (uv % VS) * SM::kV, j > 1);
        wgmma_commit();
        turn_pass(cw);
        wgmma_wait<1>();
      } else {
        pv<DV, BK>(o, p, vs + (uv % VS) * SM::kV, j > 1);
        wgmma_commit();
        qk<HD, BK>(s, qh, ks + (uk % KS) * SM::kK);
        wgmma_commit();
        turn_pass(cw);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(&v_empty[uv % VS]);
      }
      fence_regs(s);
      if (lane == 0) mbar_arrive(&k_empty[uk % KS]);
      const int k0 = (j0 + j) * BK;
      const float2 a = softmax_tile<CAP>(s, m0, m1, l0, l1, needs_mask(k0),
                                         k0, t4, r0, kl, causal, window, c2,
                                         pre, cap);
      if constexpr (SM::kIssue == fa::kOverlapped) {
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(&v_empty[uv % VS]);
      }
#pragma unroll
      for (int c = 0; c < DV / 2; ++c) o[c] *= (c & 2) ? a.y : a.x;
      pack_p(s, p);
    }

    // the last k-tile's P V
    {
      const int uv = u + n - 1;
      mbar_wait(&v_full[uv % VS], (uv / VS) & 1);
      fence_regs(o);
      fence_regs(p);
      turn_wait(cw);
      wgmma_fence();
      pv<DV, BK>(o, p, vs + (uv % VS) * SM::kV, n > 1);
      wgmma_commit();
      // after the block's last issue no turn of warpgroup 0's is left to
      // meet warpgroup 1's pass
      if (cw == 0 || t + (int)gridDim.x < tiles) turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&v_empty[uv % VS]);
    }
    u += n;

    // epilogue: O / l rounded to bf16 into this warpgroup's half of the Q
    // buffer (its last Q K^T is done), swizzled as the output map reads
    // it: element (row r, column c) of box c / 64 at r * 128 + 16 ((c % 64
    // / 8) ^ (r % 8)) + 2 (c % 8); one thread stores the boxes with TMA
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / fmaxf(l0, 1e-37f), i1 = 1.f / fmaxf(l1, 1e-37f);
#pragma unroll
    for (int jn = 0; jn < DV / 8; ++jn) {
      uint8_t* box = qh + (jn / 8) * (BQ * 128);
      const int chunk = ((jn % 8) ^ g) * 16 + 4 * t4;
      *reinterpret_cast<uint32_t*>(box + rl * 128 + chunk) =
          pack2(o[4 * jn] * i0, o[4 * jn + 1] * i0);
      *reinterpret_cast<uint32_t*>(box + (rl + 8) * 128 + chunk) =
          pack2(o[4 * jn + 2] * i1, o[4 * jn + 3] * i1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (leader) {
      for (int x = 0; x < NV; ++x)
        tma_store_4d(&omap, qh + x * (BQ * 128), 64 * x, h, q0 + 64 * cw, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if constexpr (QS == 1) {
        // one Q buffer: the next q-tile's Q goes into it, so it goes back
        // to the producer once the store has read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(&q_empty[qb]);
      } else {
        pend = qb;
      }
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// hd, dv: the tensors' widths, at most HD, DV (hd 288 on <320, 320>: TMA
// reads zeros past column 288 of q, k and v, which add exact zeros to Q K^T
// and give output columns that the store clips)
template <int HD, int DV, bool CAP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 const int* q_off, const int* k_len, int B, int Sq, int Sk,
                 int H, int KH, int hd, int dv, int causal, int window,
                 float softcap, float scale, cudaStream_t s) {
  using SM = fa::Smem<HD, DV>;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // (width, heads, S, B), innermost first; boxes of 64 columns of one head
  auto map = [&](CUtensorMap* m, const void* base, int width, int heads,
                 int len, int rows) {
    const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                                (cuuint64_t)len, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)width * 2,
                                   (cuuint64_t)heads * width * 2,
                                   (cuuint64_t)len * heads * width * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
    return tensor_map(m, bf, 4, base, dims, strides, box);
  };
  CUtensorMap qm, km, vm, om;
  if (!map(&qm, q, hd, H, Sq, fa::kBQ) || !map(&km, k, hd, KH, Sk, SM::kBK) ||
      !map(&vm, v, dv, KH, Sk, SM::kBK) || !map(&om, out, dv, H, Sq, 64))
    return (int)cudaErrorInvalidValue;
  static int sms = 0;                   // once per instantiation
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD, DV, CAP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SM::kBytes);
    if (e != cudaSuccess) return (int)e;
    sms = n;
  }
  const long tiles = (long)((Sq + fa::kBQ - 1) / fa::kBQ) * H * B;
  const int blocks = (int)(tiles < sms ? tiles : sms);
  const float log2e = fa::kLog2e;
  flash_attention_wgmma_kernel<HD, DV, CAP>
      <<<blocks, fa::kThreads, SM::kBytes, s>>>(
          qm, km, vm, om, q_off, k_len, B, Sq, Sk, H, KH, causal, window,
          CAP ? log2e : scale * log2e, CAP ? scale / softcap : 0.f,
          CAP ? softcap : 0.f);
  return (int)cudaGetLastError();
}

template <int HD, int DV>
int dispatch_wgmma(const void* q, const void* k, const void* v, void* out,
                   const int* q_off, const int* k_len, int B, int Sq, int Sk,
                   int H, int KH, int hd, int dv, int causal, int window,
                   float softcap, float scale, cudaStream_t s) {
  static_assert(fa::Smem<HD, DV>::kBytes <= fa::kMaxSmem, "shared memory");
  if (softcap > 0.f)
    return launch_wgmma<HD, DV, true>(q, k, v, out, q_off, k_len, B, Sq, Sk,
                                      H, KH, hd, dv, causal, window, softcap,
                                      scale, s);
  return launch_wgmma<HD, DV, false>(q, k, v, out, q_off, k_len, B, Sq, Sk, H,
                                     KH, hd, dv, causal, window, softcap,
                                     scale, s);
}

template <typename T, int DPT>
int launch_dpt(const void* q, const void* k, const void* v, void* out,
               const int* q_off, const int* k_len, int B, int Sq, int Sk,
               int H, int KH, int hd, int dv, int causal, int window,
               float softcap, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(hd);
  // above 48 KB a block's dynamic shared memory must be opted into
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, DPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DPT><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), q_off, k_len, Sq, Sk,
      H, KH, hd, dv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* q_off, const int* k_len, int B, int Sq, int Sk, int H,
           int KH, int hd, int dv, int causal, int window, float softcap,
           float scale, cudaStream_t s) {
  if (hd <= 128)
    return launch_dpt<T, 32>(q, k, v, out, q_off, k_len, B, Sq, Sk, H, KH,
                             hd, dv, causal, window, softcap, scale, s);
  return launch_dpt<T, kMaxHd / 4>(q, k, v, out, q_off, k_len, B, Sq, Sk, H,
                                   KH, hd, dv, causal, window, softcap, scale,
                                   s);
}

}  // namespace

// q [B, Sq, H, hd]; k [B, Sk, KH, hd]; v [B, Sk, KH, dv]; out [B, Sq, H,
// dv]; 1 <= dv <= hd; contiguous, Sq, Sk >= 1.  q_off, k_len: int32 [B] (both or neither; null: 0 and Sk),
// k_len[b] <= Sk.  window <= 0 and softcap <= 0 mean none.  `route` is a
// code of flash_attention.py::ROUTES (0 wgmma_tma, 1 cuda_core).  Returns
// cudaGetLastError() after the launch, or an error code for a route the
// arguments do not fit.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      const void* q_off, const void* k_len,
                                      int B, int Sq, int Sk, int H, int KH,
                                      int hd, int dv, int causal, int window,
                                      float softcap, float scale, int dtype,
                                      int route, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 || hd > kMaxHd ||
      dv < 1 || dv > hd || (q_off == nullptr) != (k_len == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* qo = static_cast<const int*>(q_off);
  const int* kl = static_cast<const int*>(k_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (dtype != rt::kBFloat16 || !aligned16(q) || !aligned16(k) ||
        !aligned16(v) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
    if (hd == 128 && dv == 128)
      return dispatch_wgmma<128, 128>(q, k, v, out, qo, kl, B, Sq, Sk, H, KH,
                                      hd, dv, causal, window, softcap, scale,
                                      s);
    if (hd == 64 && dv == 64)
      return dispatch_wgmma<64, 64>(q, k, v, out, qo, kl, B, Sq, Sk, H, KH,
                                    hd, dv, causal, window, softcap, scale, s);
    if (hd == 192 && dv == 128)
      return dispatch_wgmma<192, 128>(q, k, v, out, qo, kl, B, Sq, Sk, H, KH,
                                      hd, dv, causal, window, softcap, scale,
                                      s);
    if (hd == 256 && dv == 256)
      return dispatch_wgmma<256, 256>(q, k, v, out, qo, kl, B, Sq, Sk, H, KH,
                                      hd, dv, causal, window, softcap, scale,
                                      s);
    if ((hd == 288 || hd == 320) && dv == hd)
      return dispatch_wgmma<320, 320>(q, k, v, out, qo, kl, B, Sq, Sk, H, KH,
                                      hd, dv, causal, window, softcap, scale,
                                      s);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  if (dtype == rt::kFloat32)
    return launch<float>(q, k, v, out, qo, kl, B, Sq, Sk, H, KH, hd, dv,
                         causal, window, softcap, scale, s);
  if (dtype == rt::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, out, qo, kl, B, Sq, Sk, H, KH, hd,
                                 dv, causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
