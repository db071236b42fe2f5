// K6: flash-attention forward for Hopper.
//
// Replaces the Pallas kernel `flash_attention_kernel` (body `_kernel`) in
// src/repro/kernels/flash_attention.py. For every (batch, head) and query
// row i:
//
//   o[i] = sum_j softmax_j(q[i] . k[j] * scale, masked) v[j]
//
// with f32 accumulation and o in q's type. Masks: causal `i >= j` aligned
// top-left (both positions count from 0, as the Pallas kernel and
// `ref.attention_ref` have it), keys j >= Skv, and nothing is written for
// rows i >= Sq, so any Sq and Skv work: the Pallas wrapper needed both to
// be multiples of its tile and fell back to the dense reference otherwise.
// With `window` > 0 a key also needs i - j < window (a sliding window,
// the reference model's `_block_mask`; recurrentgemma's local attention).
// KV tiles strictly above the diagonal, and with a window those wholly
// below the band, are skipped: a query tile visits the KV tiles from
// max(0, q0 - window + 1) / bk on. Grouped-query
// attention reads kv head h / G in place. Every tensor is addressed
// through (batch, head, row) strides with a contiguous last dim, so the
// model's (B, S, H, D) projections go in without a transpose.
//
// Bound on the H100: operations. 4 * D flops for each (query, key) pair
// the mask lets through, against q, k, v and o read or written once: at
// the qwen2-0.5b prefill shape (56 heads, S 4096, D 64, bf16) about
// 1.2e11 flops and 67 MB, 0.12 ms at the 989 TFLOP/s bf16 tensor-core
// peak and 0.02 ms at 3.35 TB/s. At D 64 the exponentials cost about as
// much as the products: one ex2 a pair at 16 a clock on each SM.
//
// Arithmetic, in every variant, is the Pallas kernel's: f32 scores and
// accumulators, an online softmax whose running max starts at -1e30, p
// cast to v's type before P V (flash_attention.py:64) while the
// normaliser sums the unrounded p in f32, and max(l, 1e-30) at the end,
// so a row that saw no key returns 0. The bf16 variants take the
// exponentials in base 2 on the special-function unit, p = 2^(s * scale *
// log2(e) - m) (in the wgmma variant one FFMA and one ex2 an element);
// the f32 variant keeps expf. Masked scores are -inf, so their p is
// exactly 0. The bf16 variants mask only the tiles that cross the
// diagonal, the end of the keys or the window's lower edge.
//
// For the backward (K6b, flash_attention_bwd.cu) every variant writes,
// when given a non-null `lse` (B, H, Sq) float32, each query row's
// log-sum-exp of its scaled scores, m + log(max(l, 1e-30)) in natural
// units, as `_flash_fwd_scan` returns it: the base-2 variants convert
// their running max (m ln 2). A null `lse` writes nothing: inference pays
// one predicated branch a row.
//
// Three variants, chosen by the dispatcher (kernels/ops.py) from the
// dtype and D alone, each counted on its own:
//   * wgmma (bf16, D 64 and 128): persistent, one block of 512 (D 64) or
//     384 (D 128) threads an SM, walking work tiles of (64 C query rows,
//     batch * head), the heaviest causal tiles first, in rounds walked in
//     alternating directions: C = 3 consumer warpgroups at D 64, 2 at
//     D 128, and one producer warpgroup.
//     The producer, its registers lowered by setmaxnreg, issues TMA
//     loads: a tile's Q once, then K and V tiles of 128 keys through a
//     ring of three shared-memory stages guarded by full and empty
//     mbarriers that runs on across the block's work tiles, so the next
//     tile's loads overlap the last one's epilogue. The tensor maps are
//     4-D, (D, heads, rows, batch), built on the host for each call from
//     the tensors' own strides: no transpose or copy, GQA reads kv head
//     h / G in place, and TMA's zero fill of out-of-range rows replaces
//     tail handling. Each consumer warpgroup, registers raised, owns 64
//     query rows: S = Q K^T is wgmma.m64n128k16 with both operands in
//     shared memory (128-byte swizzle, K-major); P, the S accumulator
//     cast to bf16, stays in registers as wgmma's A operand for
//     O += P V, with V read as an MN-major B operand, so V is never
//     transposed. A warpgroup issues tile j's Q K^T together with tile
//     j - 1's P V and computes tile j's softmax while P V runs; the
//     warpgroups take turns to issue (named barriers), so one's softmax
//     overlaps the others' products. What bounds it is the softmax's
//     instruction stream on the CUDA cores (max, FFMA, ex2, sum and the
//     bf16 pack of 64 elements a thread a tile), not the tensor cores.
//   * mma (bf16, D 256, where the wgmma ring and a 64 x 256 accumulator
//     per warpgroup do not fit; also built at D 64, to be timed beside
//     wgmma at the LM's shape): one block of 128 threads per (64 query
//     rows, batch * head); K and V tiles of 64 keys double-buffered by
//     cp.async; fragments by ldmatrix (V by ldmatrix.trans);
//     mma.sync.m16n8k16 with P kept in registers.
//   * f32 (any D): 256 threads on the CUDA cores (a tensor-core product
//     would round the operands to tf32). Each thread computes a 4 x 4
//     piece of the 64 x 64 score tile; one warp per 8 rows does the
//     softmax in a shared-memory score tile; each thread then owns 4 rows
//     x D/16 columns of O. No cp.async: loads and products do not overlap.
#include <cuda.h>

#include <chrono>
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

using namespace pcdn;
using namespace pcdn::sm90;

namespace {

constexpr int kBlockQ = 64;         // the mma and f32 variants' tiles
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;   // the running max's start, as in Pallas
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                       // (B, H, Sq) or null
  int H, G, Sq, Skv, causal;
  int window;                       // 0: no band
  float scale;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
};

// grid (batch * head, query tiles): the last query tiles, which visit the
// most KV tiles under the causal mask, go first. Under a window the work
// a tile grows with q0 up to the window's width and then stays level
// (the band slides with the tile), so the order is still heaviest first.
__device__ __forceinline__ int q_tile_index() {
  return gridDim.y - 1 - blockIdx.y;
}

// KV tiles [first, end) of length bk that a query tile [q0, q0 + bq)
// visits: all, or those not strictly above the diagonal, and with a
// window from the tile holding key q0 - window + 1 (the lowest key the
// tile's first row keeps) on. Never empty: a tile whose rows keep no key
// at all (rows past Skv + window - 1) visits the last tile, all masked,
// and writes zeros.
struct KvRange {
  int first, end;
};

__device__ __forceinline__ KvRange kv_range(const Args& a, int q0, int bq,
                                            int bk, int window) {
  const int all = (a.Skv + bk - 1) / bk;
  KvRange r{0, a.causal ? min(all, (q0 + bq - 1) / bk + 1) : all};
  if (window > 0) r.first = min(max(0, q0 - window + 1) / bk, r.end - 1);
  return r;
}

// whether a (row, key) pair is masked out
__device__ __forceinline__ bool masked(int row, int col, int skv, int causal,
                                       int window) {
  return col >= skv || (causal && col > row) ||
         (window > 0 && row - col >= window);
}

// whether a tile of rows [r0, r0 + nr) and keys [k0, k0 + nk) needs the
// element masks: it crosses the diagonal, the end of the keys or the
// band's lower edge
__device__ __forceinline__ bool tile_masked(int r0, int nr, int k0, int nk,
                                            int skv, int causal,
                                            int window) {
  return k0 + nk > skv || (causal && k0 + nk - 1 > r0) ||
         (window > 0 && r0 + nr - 1 - k0 >= window);
}

template <typename T>
__device__ __forceinline__ void head_ptrs(const Args& a, const T*& q,
                                          const T*& k, const T*& v, T*& o) {
  const int bh = blockIdx.x;
  const long long b = bh / a.H;
  const long long h = bh % a.H;
  const long long hk = h / a.G;
  q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
}

// the max over the quad of lanes that share a row of an mma fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------- bf16, wgmma and TMA ---

namespace wg {

constexpr int kN = 128;             // keys a KV tile

// A block: kConsumers warpgroups of 64 query rows (three at D 64, whose
// accumulators are small, two at D 128) and one producer warpgroup; the
// register split moves all a block may hold to the consumers
// (32 * 128 + 160 * 384 = 40 * 128 + 232 * 256 = 65536).
// Shared memory: Q, the K stages, the V stages, then the mbarriers. A
// tile of R rows is D / 64 swizzle atoms of R rows x 128 bytes, one after
// the other, each 1024-byte aligned as the 128-byte swizzle requires.
template <int D>
struct Layout {
  static constexpr int kConsumers = D == 64 ? 3 : 2;
  static constexpr int kM = 64 * kConsumers;   // query rows a block
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kProducerRegs = kConsumers == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 232;
  static constexpr int kAtoms = D / 64;
  static constexpr int kStages = 3;   // tiles j - 1 and j in use, j + 1 loading
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kTileBytes = kN * D * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  // q_full, q_empty, k_full[stages], v_full[stages], empty[stages]
  static constexpr int kBytes = kBars + 8 * (2 + 3 * kStages) + 1024;
};

// S (64 x 128) = Q K^T: D / 16 steps of 16; a step moves 32 bytes along
// a 128-byte swizzled row, or on to the next atom (R rows x 128 bytes).
// dq, dk: descriptors of the tiles' starts; an offset adds to their
// address field in 16-byte units (shared addresses stay below 2^18, so
// the field never carries)
template <int D>
__device__ __forceinline__ void qk(float (&sc)[kN / 2], uint64_t dq,
                                   uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;
    wgmma_ss_n128(sc, dq + ((kk / 4) * Layout<D>::kM * 128 + off) / 16,
                  dk + ((kk / 4) * kN * 128 + off) / 16, kk > 0);
  }
}

// O += P V: V MN-major, 16 keys (2 KB of swizzled rows) a step; the
// second 64 columns of D (D 128) one atom, kN * 128 bytes, further (the
// descriptor's leading byte offset)
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2],
                                   const uint32_t (&pa)[kN / 16][4],
                                   uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    if constexpr (D == 64) {
      wgmma_rs_n64(o, pa[kk], dv + kk * 16 * 128 / 16);
    } else {
      wgmma_rs_n128(o, pa[kk], dv + kk * 16 * 128 / 16);
    }
  }
}

// P as wgmma's register A operand: keys 16 kk .. 16 kk + 15 are the S
// chunks 2 kk and 2 kk + 1
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kN / 16][4],
                                       const float (&sc)[kN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// a thread's online softmax over its two rows, row0 and row0 + 8, of a
// warpgroup's 64 (element 4 n + 2 i + c of an S tile is row row0 + 8 i,
// key k0 + 8 n + cq + c); l0/l1 are the thread's partial normalisers
// kWindow: the band's masks are compiled in (a launch with a window);
// without it the causal launch's code is what it was before the window
template <bool kWindow>
struct Softmax {
  int qw, row0, cq, skv, causal, window;
  float sl2;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float corr0 = 1.0f, corr1 = 1.0f;

  // S -> p in place, in base 2, masked only where the tile crosses the
  // diagonal, the end of the keys or the window's lower edge. kFused
  // (sl2 > 0, the scale every caller passes): the max is taken on the
  // raw scores, which a positive scale keeps in order, and p = 2^(s * sl2
  // - m) is one FFMA and one ex2 an element; otherwise the scores are
  // scaled first.
  template <bool kFused>
  __device__ __forceinline__ void step_as(float (&sc)[kN / 2], int k0) {
    if (!kFused) {
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) sc[e] *= sl2;
    }
    if (tile_masked(qw, 64, k0, kN, skv, causal, kWindow ? window : 0)) {
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) {
        const int col = k0 + 8 * (e / 4) + cq + (e & 1);
        const int row = row0 + 4 * (e & 2);
        if (masked(row, col, skv, causal, kWindow ? window : 0)) {
          sc[e] = -INFINITY;
        }
      }
    }
    // row max and (below) row sum over four interleaved partials each,
    // so the dependent chains are a quarter as long
    float mx0[4], mx1[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      mx0[n] = fmaxf(sc[4 * n], sc[4 * n + 1]);
      mx1[n] = fmaxf(sc[4 * n + 2], sc[4 * n + 3]);
    }
#pragma unroll
    for (int n = 4; n < kN / 8; ++n) {
      mx0[n % 4] = fmaxf(mx0[n % 4], fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1[n % 4] = fmaxf(mx1[n % 4], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    const float f = kFused ? sl2 : 1.0f;
    const float mn0 = fmaxf(
        m0, quad_max(fmaxf(fmaxf(mx0[0], mx0[1]), fmaxf(mx0[2], mx0[3]))) * f);
    const float mn1 = fmaxf(
        m1, quad_max(fmaxf(fmaxf(mx1[0], mx1[1]), fmaxf(mx1[2], mx1[3]))) * f);
    corr0 = ex2(m0 - mn0);
    corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float sum1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      sc[4 * n] = ex2(fmaf(sc[4 * n], f, -mn0));
      sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], f, -mn0));
      sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], f, -mn1));
      sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], f, -mn1));
      sum0[n % 4] += sc[4 * n] + sc[4 * n + 1];
      sum1[n % 4] += sc[4 * n + 2] + sc[4 * n + 3];
    }
    l0 = l0 * corr0 + ((sum0[0] + sum0[1]) + (sum0[2] + sum0[3]));
    l1 = l1 * corr1 + ((sum1[0] + sum1[1]) + (sum1[2] + sum1[3]));
  }

  __device__ __forceinline__ void step(float (&sc)[kN / 2], int k0) {
    if (sl2 > 0.0f) {
      step_as<true>(sc, k0);
    } else {
      step_as<false>(sc, k0);
    }
  }

  // O to the new running max
  template <int D>
  __device__ __forceinline__ void rescale(float (&o)[D / 2]) const {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= corr0;
      o[4 * n + 1] *= corr0;
      o[4 * n + 2] *= corr1;
      o[4 * n + 3] *= corr1;
    }
  }
};

// the work of one block, (batch * head, kM query rows), numbered so that
// the heaviest causal tiles come first; it visits KV tiles kv0 ..
// kv0 + n_kv - 1
struct Tile {
  int b, h, q0, kv0, n_kv;
};

template <int D, bool kWindow>
__device__ __forceinline__ Tile tile_at(const Args& a, int t, int n_bh) {
  constexpr int kM = Layout<D>::kM;
  const int n_q = (a.Sq + kM - 1) / kM;
  const int bh = t % n_bh;
  Tile w;
  w.b = bh / a.H;
  w.h = bh % a.H;
  w.q0 = (n_q - 1 - t / n_bh) * kM;
  const KvRange r = kv_range(a, w.q0, kM, kN, kWindow ? a.window : 0);
  w.kv0 = r.first;
  w.n_kv = r.end - r.first;
  return w;
}

// persistent: grid = min(tiles, SMs); the KV ring's stages and phases run
// on across a block's tiles
template <int D, bool kWindow>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Args a,
                   int n_bh, int n_tiles) {
  using L = Layout<D>;
  constexpr int S = L::kStages;
  constexpr int C = L::kConsumers;
  constexpr int kM = L::kM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;          // + 8 s
  const uint32_t v_full = k_full + 8 * S;
  const uint32_t empty = v_full + 8 * S;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, C * 4);                  // one arrive a warp
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, C * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == C) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(L::kProducerRegs));
    if (threadIdx.x == C * 128) {
      int g = 0;                                 // KV tiles loaded so far
      for (int ti = 0; tile_of(ti) < n_tiles; ++ti) {
        const Tile w = tile_at<D, kWindow>(a, tile_of(ti), n_bh);
        const int hk = w.h / a.G;
        if (ti > 0) mbar_wait(q_empty, (ti - 1) & 1);
        mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int at = 0; at < L::kAtoms; ++at) {
          tma_load(sQ + at * kM * 128, &tq, q_full, at * 64, w.h, w.q0, w.b);
        }
        for (int j = 0; j < w.n_kv; ++j, ++g) {
          const int s = g % S;
          if (g >= S) mbar_wait(empty + 8 * s, (g / S - 1) & 1);
          const uint32_t kb = sK + s * L::kTileBytes;
          const uint32_t vb = sV + s * L::kTileBytes;
          mbar_expect_tx(k_full + 8 * s, L::kTileBytes);
#pragma unroll
          for (int at = 0; at < L::kAtoms; ++at) {
            tma_load(kb + at * kN * 128, &tk, k_full + 8 * s, at * 64, hk,
                     (w.kv0 + j) * kN, w.b);
          }
          mbar_expect_tx(v_full + 8 * s, L::kTileBytes);
#pragma unroll
          for (int at = 0; at < L::kAtoms; ++at) {
            tma_load(vb + at * kN * 128, &tv, v_full + 8 * s, at * 64, hk,
                     (w.kv0 + j) * kN, w.b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns query rows [qw, qw + 64) of each tile.
  // Tile 0's Q K^T and softmax first; then iteration j issues S = Q K_j^T
  // and O += P_{j-1} V_{j-1} together and runs tile j's softmax while the
  // P V product is still on the tensor cores; the last P V closes. P
  // stays in registers as wgmma's A operand. The two warpgroups take
  // turns to issue (warpgroup 0 first), so one's softmax overlaps the
  // others' products.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(L::kConsumerRegs));
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int my_turn = 1 + wgi;
  const int next_turn = 1 + (wgi + 1) % C;
  const uint64_t dq = desc(sQ + wgi * 64 * 128, 16, 1024);
  const uint64_t dk = desc(sK, 16, 1024);
  const uint64_t dv = desc(sV, kN * 128, 1024);
  constexpr int kStage = L::kTileBytes / 16;    // a stage, in descriptor units
  int g = 0;                                     // KV tiles consumed so far
  for (int ti = 0; tile_of(ti) < n_tiles; ++ti) {
    const Tile w = tile_at<D, kWindow>(a, tile_of(ti), n_bh);
    const int n_kv = w.n_kv;
    Softmax<kWindow> sm;
    sm.qw = w.q0 + wgi * 64;
    sm.row0 = sm.qw + warp * 16 + lane / 4;    // the thread's two rows
    sm.cq = 2 * (lane % 4);                     // its column in a chunk
    sm.sl2 = a.scale * kLog2e;
    sm.skv = a.Skv;
    sm.causal = a.causal;
    sm.window = a.window;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float sc[kN / 2];
    uint32_t pa[kN / 16][4];

    if (wgi == C - 1) bar_arrive(1);
    mbar_wait(q_full, ti & 1);
    int s = g % S;
    mbar_wait(k_full + 8 * s, (g / S) & 1);
    bar_sync(my_turn);
    wgmma_fence();
    qk<D>(sc, dq, dk + s * kStage);
    wgmma_commit();
    bar_arrive(next_turn);
    wgmma_wait<0>();
    pin(sc);
    if (n_kv == 1 && lane == 0) mbar_arrive(q_empty);   // Q is read
    sm.step(sc, w.kv0 * kN);
    pack_p(pa, sc);

    for (int j = 1; j < n_kv; ++j) {
      const int sp = s;                          // tile j - 1's stage
      const int gp = g + j - 1;
      s = (g + j) % S;
      mbar_wait(k_full + 8 * s, ((g + j) / S) & 1);
      bar_sync(my_turn);
      wgmma_fence();
      qk<D>(sc, dq, dk + s * kStage);
      wgmma_commit();
      mbar_wait(v_full + 8 * sp, (gp / S) & 1);
      pv<D>(o, pa, dv + sp * kStage);
      wgmma_commit();
      bar_arrive(next_turn);
      wgmma_wait<1>();                           // S is in, P V runs on
      pin(sc);
      if (j == n_kv - 1 && lane == 0) mbar_arrive(q_empty);
      sm.step(sc, (w.kv0 + j) * kN);
      wgmma_wait<0>();
      pin(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sp);
      sm.rescale<D>(o);
      pack_p(pa, sc);
    }

    // the last P V; the last warpgroup's last turn of the tile passes to
    // no one
    const int gl = g + n_kv - 1;
    mbar_wait(v_full + 8 * s, (gl / S) & 1);
    bar_sync(my_turn);
    wgmma_fence();
    pv<D>(o, pa, dv + s * kStage);
    wgmma_commit();
    if (wgi != C - 1) bar_arrive(next_turn);
    wgmma_wait<0>();
    pin(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    g += n_kv;

    const int row0 = sm.row0;
    const int row1 = row0 + 8;
    const int cq = sm.cq;
    const float l0 = fmaxf(quad_sum(sm.l0), 1e-30f);
    const float l1 = fmaxf(quad_sum(sm.l1), 1e-30f);
    const float inv0 = 1.0f / l0;
    const float inv1 = 1.0f / l1;
    if (a.lse != nullptr && cq == 0) {
      float* lrow = a.lse + (static_cast<long long>(w.b) * a.H + w.h) * a.Sq;
      if (row0 < a.Sq) lrow[row0] = sm.m0 * kLn2 + logf(l0);
      if (row1 < a.Sq) lrow[row1] = sm.m1 * kLn2 + logf(l1);
    }
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + w.b * a.o_sb +
                        w.h * a.o_sh;
    if (row0 < a.Sq) {
      __nv_bfloat16* orow = og + row0 * a.o_ss + cq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      }
    }
    if (row1 < a.Sq) {
      __nv_bfloat16* orow = og + row1 * a.o_ss + cq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
      }
    }
  }
}

}  // namespace wg

// ---------------------------------------------------- bf16, mma.sync ---

namespace mma {

constexpr int kWarps = 4;                   // 16 query rows a warp
constexpr int kThreads = kWarps * 32;

// Q, then K and V double-buffered, rows padded by 8 elements so that the
// eight row addresses of an ldmatrix hit distinct banks
template <int D>
struct Layout {
  static constexpr int kLD = D + 8;
  static constexpr int kTile = kBlockK * kLD;   // elements
  static constexpr size_t kBytes =
      static_cast<size_t>(kBlockQ * kLD + 4 * kTile) * 2;
};

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16 bytes global -> shared without registers; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [0, n_valid) of a 64-row tile into shared memory (row stride LD),
// the rest zero-filled
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int n_valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r < n_valid;
    cp_async16(dst + r * LD + c, src + (ok ? r : 0) * ss + c, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const Args a) {
  constexpr int LD = Layout<D>::kLD;
  constexpr int kTile = Layout<D>::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockQ * LD;        // two stages
  __nv_bfloat16* Vs = Ks + 2 * kTile;           // two stages

  const __nv_bfloat16 *qg, *kg, *vg;
  __nv_bfloat16* og;
  head_ptrs(a, qg, kg, vg, og);
  const int q0 = q_tile_index() * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;        // fragment row group
  const int t = lane & 3;         // thread in the group
  const int wr = warp * 16;       // the warp's first row in the tile
  const int row0 = q0 + wr + g;   // this thread's two query positions
  const int row1 = row0 + 8;
  const float sl2 = a.scale * kLog2e;
  const KvRange range = kv_range(a, q0, kBlockQ, kBlockK, a.window);
  const int kv0 = range.first * kBlockK;       // the first visited key
  const int n_kv = range.end - range.first;

  load_tile<D, LD>(Qs, qg + q0 * a.q_ss, a.q_ss, a.Sq - q0);
  load_tile<D, LD>(Ks, kg + kv0 * a.k_ss, a.k_ss, a.Skv - kv0);
  load_tile<D, LD>(Vs, vg + kv0 * a.v_ss, a.v_ss, a.Skv - kv0);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = kv0 + j * kBlockK;
    // the next tile's loads fly while this one is computed
    if (j + 1 < n_kv) {
      const int k1 = k0 + kBlockK;
      const int nb = (j + 1) & 1;
      load_tile<D, LD>(Ks + nb * kTile, kg + k1 * a.k_ss, a.k_ss,
                       a.Skv - k1);
      load_tile<D, LD>(Vs + nb * kTile, vg + k1 * a.v_ss, a.v_ss,
                       a.Skv - k1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kb = Ks + (j & 1) * kTile;
    const __nv_bfloat16* Vb = Vs + (j & 1) * kTile;

    // S = Q K^T for the warp's 16 rows x 64 keys: 8 tiles of 16 x 8
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, Qs + (wr + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, Kb + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], af, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
      }
    }

    // scale into base 2, mask only where the tile crosses the diagonal,
    // the end of the keys or the window's edge; the tile's row max over
    // the quad
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] *= sl2;
    }
    if (tile_masked(q0, kBlockQ, k0, kBlockK, a.Skv, a.causal, a.window)) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = k0 + n * 8 + 2 * t + (c & 1);
          const int row = c < 2 ? row0 : row1;
          if (masked(row, col, a.Skv, a.causal, a.window)) {
            s[n][c] = -INFINITY;
          }
        }
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = ex2(m0 - mn0);
    const float corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = ex2(s[n][0] - mn0);
      s[n][1] = ex2(s[n][1] - mn0);
      s[n][2] = ex2(s[n][2] - mn1);
      s[n][3] = ex2(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    // per-thread partial normalisers; the quad sums them at the end
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }

    // O += P V: P (16 x 64) from the S accumulators, 16 keys a step; V's
    // B fragments by ldmatrix.trans, two 8-column tiles at a time
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, Vb + (kk * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * LD +
                              np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pf, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], pf, bf[2], bf[3]);
      }
    }
    __syncthreads();              // this stage is free for the next load
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  const float inv0 = 1.0f / l0;
  const float inv1 = 1.0f / l1;
  if (a.lse != nullptr && t == 0) {
    float* lrow = a.lse + static_cast<long long>(blockIdx.x) * a.Sq;
    if (row0 < a.Sq) lrow[row0] = m0 * kLn2 + logf(l0);
    if (row1 < a.Sq) lrow[row1] = m1 * kLn2 + logf(l1);
  }
  if (row0 < a.Sq) {
    __nv_bfloat16* orow = og + row0 * a.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    }
  }
  if (row1 < a.Sq) {
    __nv_bfloat16* orow = og + row1 * a.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
}

}  // namespace mma

// ----------------------------------------------------------------- f32 ---

constexpr int kThreadsF32 = 256;
constexpr int kSLD = kBlockK + 1;   // score tile row stride

// rows [0, n_valid) of a 64-row tile into shared memory (row stride LD,
// odd, so column reads across rows hit distinct banks); the rest zero
template <int D, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long ss, int n_valid) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreadsF32) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n_valid) val = *reinterpret_cast<const float4*>(src + r * ss + c);
    float* d = dst + r * LD + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_f32_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int kCols = D / 16;     // O columns a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ss = Vs + kBlockK * LD;           // scores, then probabilities
  float* m_s = Ss + kBlockQ * kSLD;        // running max per row
  float* l_s = m_s + kBlockQ;              // running normaliser per row
  float* c_s = l_s + kBlockQ;              // this tile's correction

  const float *qg, *kg, *vg;
  float* og;
  head_ptrs(a, qg, kg, vg, og);
  const int q0 = q_tile_index() * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;          // rows 4 ty .. 4 ty + 3
  const int tx = tid & 15;          // columns tx + 16 c
  const int warp = tid >> 5;
  const int lane = tid & 31;

  load_tile_f32<D, LD>(Qs, qg + q0 * a.q_ss, a.q_ss, a.Sq - q0);
  if (tid < kBlockQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  float o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.0f;
  }

  const KvRange range = kv_range(a, q0, kBlockQ, kBlockK, a.window);
  for (int j = range.first; j < range.end; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();
    load_tile_f32<D, LD>(Ks, kg + k0 * a.k_ss, a.k_ss, a.Skv - k0);
    load_tile_f32<D, LD>(Vs, vg + k0 * a.v_ss, a.v_ss, a.Skv - k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        const bool ok = !masked(row, col, a.Skv, a.causal, a.window);
        Ss[(4 * ty + i) * kSLD + tx + 16 * c] =
            ok ? s[i][c] * a.scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8 w .. 8 w + 7, two keys a lane
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      float* sr = Ss + r * kSLD;
      const float v0 = sr[lane];
      const float v1 = sr[lane + 32];
      float mx = fmaxf(v0, v1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(v0 - m_new);
      const float p1 = expf(v1 - m_new);
      const float sum = warp_sum(p0 + p1);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[4 * ty + i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(4 * ty + i) * kSLD + kk];
      const float* vr = Vs + kk * LD + tx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vr[16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(p[i], vv, o[i][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (q0 + r < a.Sq) {
      const float l = fmaxf(l_s[r], 1e-30f);
      const float inv = 1.0f / l;
      if (a.lse != nullptr && tx == 0) {
        a.lse[static_cast<long long>(blockIdx.x) * a.Sq + q0 + r] =
            m_s[r] + logf(l);
      }
      float* orow = og + (q0 + r) * a.o_ss + tx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) orow[16 * c] = o[i][c] * inv;
    }
  }
}

// --------------------------------------------------------------- launch ---

long long g_encode_ns = 0;   // host time of the last call's three encodes

template <int D>
int launch_wgmma(const Args& a, int B, int Kv, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  const auto t0 = std::chrono::steady_clock::now();
  const bool ok =
      encode(fn, &tq, a.q, D, a.H, a.Sq, B, a.q_sh, a.q_ss, a.q_sb,
             wg::Layout<D>::kM) &&
      encode(fn, &tk, a.k, D, Kv, a.Skv, B, a.k_sh, a.k_ss, a.k_sb,
             wg::kN) &&
      encode(fn, &tv, a.v, D, Kv, a.Skv, B, a.v_sh, a.v_ss, a.v_sb, wg::kN);
  g_encode_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - t0).count();
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = wg::Layout<D>::kBytes;
  // two instantiations: the window's masks only where a launch has one
  const auto kernel = a.window > 0 ? wg::flash_wgmma_kernel<D, true>
                                   : wg::flash_wgmma_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bh = B * a.H;
  const long long tiles =
      static_cast<long long>(n_bh) *
      ((a.Sq + wg::Layout<D>::kM - 1) / wg::Layout<D>::kM);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, wg::Layout<D>::kThreads, bytes, stream>>>(
      tq, tk, tv, a, n_bh, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int launch_simple(Kernel kernel, const Args& a, int B, int threads,
                  size_t bytes, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.H, (a.Sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
size_t f32_smem() {
  return (static_cast<size_t>(kBlockQ + 2 * kBlockK) * (D + 1) +
          kBlockQ * kSLD + 3 * kBlockQ) * 4;
}

enum Variant { kWgmma, kMma, kF32 };

int launch(Variant variant, const void* q, const void* k, const void* v,
           void* o, float* lse, int B, int H, int G, int Sq, int Skv, int D,
           int causal, int window, float scale, const long long* st,
           cudaStream_t stream) {
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || Sq < 1 || Skv < 1 ||
      window < 0 ||
      (Sq + kBlockQ - 1) / kBlockQ > 65535 ||
      static_cast<long long>(B) * H > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a window of Sq or more masks nothing: the causal launch, bit for bit
  const Args a{q, k, v, o, lse, H, G, Sq, Skv, causal,
               window >= Sq ? 0 : window, scale,
               st[0], st[1], st[2], st[3], st[4], st[5],
               st[6], st[7], st[8], st[9], st[10], st[11]};
  const int Kv = H / G;
  switch (variant * 1000 + D) {
    case kWgmma * 1000 + 64: return launch_wgmma<64>(a, B, Kv, stream);
    case kWgmma * 1000 + 128: return launch_wgmma<128>(a, B, Kv, stream);
    case kMma * 1000 + 64:
      return launch_simple(mma::flash_mma_kernel<64>, a, B, mma::kThreads,
                           mma::Layout<64>::kBytes, stream);
    case kMma * 1000 + 256:
      return launch_simple(mma::flash_mma_kernel<256>, a, B, mma::kThreads,
                           mma::Layout<256>::kBytes, stream);
    case kF32 * 1000 + 64:
      return launch_simple(flash_f32_kernel<64>, a, B, kThreadsF32,
                           f32_smem<64>(), stream);
    case kF32 * 1000 + 128:
      return launch_simple(flash_f32_kernel<128>, a, B, kThreadsF32,
                           f32_smem<128>(), stream);
    case kF32 * 1000 + 256:
      return launch_simple(flash_f32_kernel<256>, a, B, kThreadsF32,
                           f32_smem<256>(), stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o, lse ((B, H, Sq) float32, or null); B batches of H query
// heads, G query heads per kv head; window 0 or the band's width;
// strides: (batch, head, row) of q, k, v and o in elements, 12 in all
#define FLASH_ENTRY(NAME, VARIANT)                                          \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      void* lse, int B, int H, int G, int Sq, int Skv,      \
                      int D, int causal, int window, float scale,           \
                      const long long* strides, void* stream) {             \
    return launch(VARIANT, q, k, v, o, static_cast<float*>(lse), B, H, G,   \
                  Sq, Skv, D, causal, window, scale, strides,               \
                  static_cast<cudaStream_t>(stream));                       \
  }

FLASH_ENTRY(flash_attention_wgmma_bf16, kWgmma)   // D 64, 128
FLASH_ENTRY(flash_attention_mma_bf16, kMma)       // D 64, 256
FLASH_ENTRY(flash_attention_f32, kF32)            // D 64, 128, 256

// host nanoseconds the last wgmma launch spent encoding its tensor maps
extern "C" int flash_attention_encode_ns() {
  return static_cast<int>(g_encode_ns);
}
