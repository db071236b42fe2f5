// K6b: flash-attention backward for Hopper.
//
// No Pallas kernel: it replaces the reference's flash backward
// `_flash_mha_bwd` (src/repro/models/attention.py:258), the custom_vjp
// backward of the blockwise attention that K6's forward (`_flash_fwd_scan`
// there, `flash_attention_kernel` in Pallas) computes. From q, k, v, the
// forward's output o and row log-sum-exp lse, and the output's gradient
// dO, for every (batch, head):
//
//   delta_i = sum_d dO[i, d] o[i, d]
//   p_ij    = exp(q_i . k_j * scale - lse_i)      (masked: 0)
//   ds_ij   = p_ij (dO_i . v_j - delta_i)
//   dq_i    = scale * sum_j ds_ij k_j
//   dk_j    = scale * sum_{g, i} ds_ij q_i,   dv_j = sum_{g, i} p_ij dO_i
//
// with dk and dv summed over the G query heads that share kv head h / G,
// f32 sums (the reference's backward widens every operand), and dq, dk,
// dv written in the inputs' type. Masks as K6's: causal `i >= j` aligned
// top-left, keys j >= Skv and rows i >= Sq, so any Sq and Skv, and with
// `window` > 0 also i - j < window (the sliding window of the reference's
// `_block_mask`, recurrentgemma's local attention). Tiles wholly above
// the diagonal, and with a window those wholly below the band, are
// skipped: the dQ pass's query tile [q0, q0 + bq) visits the KV tiles
// from the one holding key q0 - window + 1 on, the dK/dV pass's key tile
// [k0, k0 + bk) the query tiles up to the one holding row k0 + bk - 2 +
// window.
//
// Deterministic, with no floating-point atomics, in both variants: two
// launches, a dQ pass (which forms delta first) and then a dK/dV pass
// (at D 256 in bf16 a third, short one that adds the dK/dV pass's splits
// in split order), every sum in one fixed order, so two calls are
// bit-equal. S and dP are
// formed in both passes: 7 products of 2 S^2 D a head where 5 would do
// (a 5-product design must sum dQ across KV tiles in a fixed order).
//
// Bound on the H100: operations. 5 products of 2 D flops for each
// (query, key) pair the mask lets through: at the qwen2-0.5b train shape
// (B 4, S 4096, 14 heads over 2, D 64, bf16, causal) 3.0e11 flops, 0.30
// ms at the 989 TFLOP/s bf16 tensor-core peak, against 135 MB moved
// (0.04 ms at 3.35 TB/s). The exponentials add 4.7e8 ex2 a pass on the
// special-function units (16 a clock an SM: ~0.12 ms a pass).
//
// Two variants, chosen by the dispatcher (kernels/ops.py) from the dtype
// and D alone, each counted on its own:
//   * wgmma (bf16, D 64 and 128; D 256 below): both passes persistent and
//     warp-specialised like K6's wgmma kernel: one block an SM walking
//     work tiles heaviest-first in rounds of alternating direction
//     (`tile_of`); a producer warpgroup, registers lowered by setmaxnreg,
//     whose one thread keeps TMA loads in flight through a ring of four
//     shared-memory stages (full and empty mbarriers, running on across
//     the block's work tiles); consumer warpgroups, registers raised,
//     that run wgmma with f32 accumulators. The tensor maps are 4-D, (D,
//     heads, rows, batch), built on the host from the tensors' strides:
//     GQA reads kv head h / G in place, TMA's zero fill covers ragged
//     rows. Every product takes K6's operand forms: both operands in
//     shared memory, K-major (S = Q K^T, dP = dO V^T and their
//     transposes), or A from registers and B MN-major (the products with
//     P or dS: P and dS are f32 accumulators cast to bf16 in registers,
//     as K6 feeds P), so no operand is transposed in memory; one form is
//     added, A from registers and B K-major (S^T and dP^T at D 64).
//       - dQ pass: work tiles (batch * head, 64 C query rows), C = 3
//         consumer warpgroups at D 64 and 2 at D 128, each owning 64 rows,
//         with Q and dO resident. Each warpgroup first forms delta for its
//         rows (a pair of threads a row, from o and dO in global memory,
//         a fixed order) and writes lse log2(e) and delta of its rows to
//         the (2, B, H, Sq rounded up to 64) scratch the dK/dV pass reads
//         (rows >= Sq: lse = +inf, delta = 0, so their p is 0). The ring
//         streams K and V tiles of 64 keys: S = Q K^T and dP = dO V^T
//         (ss, issued together), then p = 2^(s scale log2(e) - lse
//         log2(e)) (one FFMA, one ex2), ds = p (dp - delta) in f32
//         registers, and dQ += dS K (rs, K MN-major). Tile j's S and dP
//         are issued with tile j - 1's dQ product, and tile j's ds is
//         formed while that product runs (K6's overlap of Q K^T, P V and
//         the softmax). The KV tile is 64 keys, not K6's 128: at 128, S,
//         dP and the dQ accumulator do not fit in the 160 registers a
//         thread of three consumer warpgroups may hold.
//       - dK/dV pass: work tiles (batch * kv head, 128 keys), two consumer
//         warpgroups of 64 keys each, with K and V resident. The ring
//         streams (Q, dO) tiles of 64 query rows, with their lse log2(e)
//         and delta (bulk copies of the scratch), over the G query heads
//         and the query tiles from the diagonal on: S^T = K Q^T and dP^T
//         = V dO^T (ss, issued together); p^T and ds^T in f32 registers;
//         dV += P^T dO and dK += dS^T Q (rs, dO and Q MN-major, issued
//         together). dK and dV stay in f32 registers across all G query
//         heads and tiles, summed in one order. At D 64 a tile's S^T and
//         dP^T are issued with the previous tile's dV and dK products, as
//         in the dQ pass, and each warpgroup holds its 64 rows of K and V
//         in registers (ldmatrix from the swizzled tile, once a work
//         tile) as the A operand of S^T and dP^T, so those products read
//         only Q and dO from shared memory (A from registers, B K-major)
//         and K and V's buffer is released for the next work tile at
//         once. At D 128 the two 64 x 128 accumulators, S^T and
//         dP^T (192 registers) fit the 232 a consumer thread holds, but
//         not a second tile's bf16 operands beside them: each tile's
//         products run one after the other, p^T and ds^T are cast to
//         their bf16 operands in registers (dS^T is not staged through
//         shared memory), and the query tile stays 64 rows.
//     No product is in flight across a branch (ptxas serializes wgmma
//     there), so each pipeline's first tile and last product are peeled
//     off its loop, and p and ds are cast to bf16 operands only after the
//     product that reads the previous ones has retired.
//     At the train shape the dK/dV pass has 256 work tiles of G (64 - 2 j)
//     query-tile steps; the alternating rounds give the busiest of the
//     132 blocks 448 steps against a mean of 448 (one direction: 672).
//   * wgmma at D 256 (gemma-7b's and recurrentgemma-2b's heads): the same
//     producer, rings and persistent rounds, with its own blocks
//     (`DqLayout<256>`, `KvLayout<256>`) because a 64-row tile of D 256
//     is 32 KB in shared memory and a 64 x 256 f32 accumulator 128
//     registers a thread of a warpgroup:
//       - Registers. The dK/dV pass cannot hold dK and dV (256 registers)
//         for 64 keys in one warpgroup, nor the dQ pass dQ (128) beside S,
//         dP (32 each) and a pipelined tile. So both passes give a work
//         tile of 64 rows to two consumer warpgroups that split D: each
//         sums its 128 columns (dQ: 64 registers; dK and dV: 128), beside
//         one 32-register score tile: warpgroup 0 forms S (S^T) = Q K^T,
//         warpgroup 1 dP (dP^T) = dO V^T, once; 1 puts dP in f32 into
//         shared memory in its register order (16 KB); 0 forms p and ds =
//         p (dP - delta) and writes dS (and P^T) in bf16 as 128-byte
//         swizzled K-major tiles (8 KB each) that both read as the A
//         operand of dQ += dS K (dV += P^T dO, dK += dS^T Q) over their
//         columns (ss, B MN-major, n 128). Named barriers hand dP, dS
//         and the tiles' release between the two. 168 registers, no
//         spills (ptxas).
//       - Shared memory. Two resident 64-row tiles (64 KB) and two ring
//         stages of two 64-row tiles (128 KB), plus dS (P^T), dP and the
//         rows: 222,768 bytes (dQ) and 231,472 (dK/dV) of 232,448. Four
//         stages do not fit; resident Q and dO for 128 rows (as at D 128)
//         leave room for one 64-key stage, or for 32-key ring tiles whose
//         n 32 products, both operands in shared memory, ask more bytes a
//         clock than the SM's shared memory gives (a dQ pass built so ran
//         slower on the card than this one). The dQ pass keeps Q and dO
//         in registers as the A operands of S and dP (64 a thread), so
//         those products read only K and V from shared memory.
//       - Parallelism. The dK/dV pass's work tiles are (batch * kv head,
//         64 keys): 64 at the hybrid's train shape (1 kv head, S 4096) for
//         132 SMs. When they are fewer than the SMs, `splits` CTAs share
//         each (ops.flash_bwd_splits picks the count, at most kMaxSplits,
//         whose busiest block has the least work: 6 there), each taking a
//         contiguous share of the tile's G query heads x query tiles, and
//         write f32 sums to the scratch; `dkdv_sum_kernel` adds them in
//         split order (no atomics). The dQ pass has (batch * head, 64
//         rows) tiles: 640 at the hybrid's shape.
//       - The band. Each pass's KV range (dQ: from the tile of key q0 -
//         window + 1) and query range (dK/dV: up to the tile of row k0 +
//         62 + window) is bounded by it, per work tile (both warpgroups
//         hold all of the tile's rows).
//     Both passes issue the next tile's S (S^T) with this tile's gradient
//     products in warpgroup 0 and the next dP (dP^T) before them in 1, so
//     the tensor cores have work while 0 forms p and ds.
//   * simt (float32 at every D; bf16 through `variant="simt"`): every
//     product on the CUDA cores in f32 from shared memory (each thread a
//     4 x 4 piece of a 64 x 64 tile, BM = BN = 64 at D 64 and 128, 32 at
//     D 256 so the four f32 tiles fit), no asynchronous copies. float32
//     stays here: a tensor-core product would round its operands to tf32
//     (~1e-3 against the 1e-4 limit).
//       - dQ pass: a block per (batch * head, BM query rows). It forms
//         delta for its rows (a warp a row, a fixed butterfly), writes it
//         to the (B, H, Sq) scratch, then walks the KV tiles up to the
//         diagonal: S = Q K^T and dP = dO V^T, P and dS in shared memory,
//         dQ += dS K.
//       - dK/dV pass: a block per (batch * kv head, BN keys), walking the
//         G query heads of its kv head and, for each, the query tiles
//         from the diagonal on: S^T = K Q^T and dP^T = V dO^T, P^T and
//         dS^T in shared memory, dV += P^T dO, dK += dS^T Q.
//
// The wgmma variant rounds p and ds to bf16 for the products with dO, Q
// and K (K6 rounds p the same way); the f32 sums and the output's bf16
// rounding are the rest of its difference from the plain version.
#include <cuda.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

using namespace pcdn;
using namespace pcdn::sm90;

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                 // (B, H, Sq)
  // scratch: simt (B, H, Sq) delta; wgmma (2, B, H, sq_pad), lse log2(e)
  // then delta
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int H, G, Sq, Skv, causal;
  int sq_pad;                       // Sq rounded up to 64 (wgmma)
  long long n_bhp;                  // B H sq_pad: delta in the scratch
  float scale;
  // (batch, head, row) strides in elements of q, k, v, o, dO, dq, dk, dv
  long long st[24];
  // 0: no band. Last, so that the fields before it keep the offsets they
  // had without it: the causal kernels load their parameters as before
  int window;
};

// ----------------------------------------- simt: the CUDA cores, f32 ---

namespace simt {

constexpr int kThreads = 256;       // a 16 x 16 grid of threads


template <int D>
struct Tile {
  static constexpr int kB = D <= 128 ? 64 : 32;   // rows a tile (BM = BN)
  static constexpr int kR = kB / 16;               // rows a thread
  static constexpr int kC = D / 16;                // columns a thread
  static constexpr int kLD = D + 1;                // odd: no bank conflicts
  static constexpr int kPLD = kB + 1;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [r0, r0 + kB) of a (row stride ss) head into dst (row stride LD)
// as f32; rows >= n_valid are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ss, int r0,
                                          int n_valid) {
  using L = Tile<D>;
  for (int e = threadIdx.x; e < L::kB * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    dst[r * L::kLD + d] =
        r0 + r < n_valid ? to_float(src[(r0 + r) * ss + d]) : 0.0f;
  }
}

// whether the pair (query row, key) is masked out: past the keys, above
// the diagonal or below the band
__device__ __forceinline__ bool masked(const Args& a, int row, int col) {
  return col >= a.Skv || (a.causal && col > row) ||
         (a.window > 0 && row - col >= a.window);
}

// KV tiles [first, end) of b keys that query rows [q0, q0 + b) visit: up
// to the diagonal, and with a window from the tile holding key q0 -
// window + 1 on (an empty range writes dq = 0)
struct Range {
  int first, end;
};

__device__ __forceinline__ Range kv_tiles(const Args& a, int q0, int b) {
  const int all = (a.Skv + b - 1) / b;
  Range r{0, a.causal ? min(all, (q0 + b - 1) / b + 1) : all};
  if (a.window > 0) r.first = min(max(0, q0 - a.window + 1) / b, r.end);
  return r;
}

// ------------------------------------------------------------- dQ pass ---

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const Args a) {
  using L = Tile<D>;
  constexpr int B = L::kB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + B * L::kLD;
  float* Ks = dOs + B * L::kLD;
  float* Vs = Ks + B * L::kLD;
  float* dSs = Vs + B * L::kLD;        // B x kPLD
  float* lse_s = dSs + B * L::kPLD;
  float* delta_s = lse_s + B;

  const int bh = blockIdx.x;
  const long long b = bh / a.H;
  const long long h = bh % a.H;
  const long long hk = h / a.G;
  const long long* st = a.st;
  const T* q = static_cast<const T*>(a.q) + b * st[0] + h * st[1];
  const T* k = static_cast<const T*>(a.k) + b * st[3] + hk * st[4];
  const T* v = static_cast<const T*>(a.v) + b * st[6] + hk * st[7];
  const T* o = static_cast<const T*>(a.o) + b * st[9] + h * st[10];
  const T* dO = static_cast<const T*>(a.dout) + b * st[12] + h * st[13];
  T* dq = static_cast<T*>(a.dq) + b * st[15] + h * st[16];
  const float* lse = a.lse + bh * static_cast<long long>(a.Sq);
  float* delta = a.delta + bh * static_cast<long long>(a.Sq);

  const int q0 = (gridDim.y - 1 - blockIdx.y) * B;   // heavy tiles first
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  load_rows<T, D>(Qs, q, st[2], q0, a.Sq);
  load_rows<T, D>(dOs, dO, st[14], q0, a.Sq);
  // delta a warp a row; rows past Sq read p = 0 through lse = +inf
  for (int r = warp; r < B; r += kThreads / 32) {
    const int i = q0 + r;
    float acc = 0.0f;
    if (i < a.Sq) {
      for (int d = lane; d < D; d += 32) {
        acc = fmaf(to_float(dO[i * st[14] + d]), to_float(o[i * st[11] + d]),
                   acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = i < a.Sq ? lse[i] : INFINITY;
      if (i < a.Sq) delta[i] = acc;
    }
  }

  float acc[L::kR][L::kC];
#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
#pragma unroll
    for (int c = 0; c < L::kC; ++c) acc[i][c] = 0.0f;
  }

  const Range kv = kv_tiles(a, q0, B);
  for (int j = kv.first; j < kv.end; ++j) {
    const int k0 = j * B;
    __syncthreads();
    load_rows<T, D>(Ks, k, st[5], k0, a.Skv);
    load_rows<T, D>(Vs, v, st[8], k0, a.Skv);
    __syncthreads();

    // S and dP for rows ty + 16 i, keys tx + 16 c
    float s[L::kR][L::kR], dp[L::kR][L::kR];
#pragma unroll
    for (int i = 0; i < L::kR; ++i) {
#pragma unroll
      for (int c = 0; c < L::kR; ++c) s[i][c] = dp[i][c] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[L::kR], gv[L::kR], kv[L::kR], vv[L::kR];
#pragma unroll
      for (int i = 0; i < L::kR; ++i) {
        qv[i] = Qs[(ty + 16 * i) * L::kLD + d];
        gv[i] = dOs[(ty + 16 * i) * L::kLD + d];
        kv[i] = Ks[(tx + 16 * i) * L::kLD + d];
        vv[i] = Vs[(tx + 16 * i) * L::kLD + d];
      }
#pragma unroll
      for (int i = 0; i < L::kR; ++i) {
#pragma unroll
        for (int c = 0; c < L::kR; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(gv[i], vv[c], dp[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < L::kR; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int c = 0; c < L::kR; ++c) {
        const int col = k0 + tx + 16 * c;
        const float p =
            masked(a, row, col) ? 0.0f : expf(s[i][c] * a.scale - lse_s[r]);
        dSs[r * L::kPLD + tx + 16 * c] = p * (dp[i][c] - delta_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS K for rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < B; ++kk) {
      float ds[L::kR];
#pragma unroll
      for (int i = 0; i < L::kR; ++i) ds[i] = dSs[(ty + 16 * i) * L::kPLD + kk];
      const float* kr = Ks + kk * L::kLD + tx;
#pragma unroll
      for (int c = 0; c < L::kC; ++c) {
        const float kvv = kr[16 * c];
#pragma unroll
        for (int i = 0; i < L::kR; ++i) acc[i][c] = fmaf(ds[i], kvv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < a.Sq) {
      T* dr = dq + row * st[17] + tx;
#pragma unroll
      for (int c = 0; c < L::kC; ++c) store(dr + 16 * c, acc[i][c] * a.scale);
    }
  }
}

// ---------------------------------------------------------- dK/dV pass ---

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const Args a) {
  using L = Tile<D>;
  constexpr int B = L::kB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + B * L::kLD;
  float* Qs = Vs + B * L::kLD;
  float* dOs = Qs + B * L::kLD;
  float* Pt = dOs + B * L::kLD;        // B keys x kPLD
  float* dSt = Pt + B * L::kPLD;
  float* lse_s = dSt + B * L::kPLD;
  float* delta_s = lse_s + B;

  const int Kv = a.H / a.G;
  const long long b = blockIdx.x / Kv;
  const long long hk = blockIdx.x % Kv;
  const long long* st = a.st;
  const T* k = static_cast<const T*>(a.k) + b * st[3] + hk * st[4];
  const T* v = static_cast<const T*>(a.v) + b * st[6] + hk * st[7];
  T* dk = static_cast<T*>(a.dk) + b * st[18] + hk * st[19];
  T* dv = static_cast<T*>(a.dv) + b * st[21] + hk * st[22];

  const int k0 = blockIdx.y * B;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  load_rows<T, D>(Ks, k, st[5], k0, a.Skv);
  load_rows<T, D>(Vs, v, st[8], k0, a.Skv);

  float acc_k[L::kR][L::kC], acc_v[L::kR][L::kC];
#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
#pragma unroll
    for (int c = 0; c < L::kC; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;
  }

  const int n_q = (a.Sq + B - 1) / B;
  const int first = a.causal ? k0 / B : 0;   // rows >= k0 see these keys
  // with a window, rows past k0 + B - 2 + window see none of them
  const int end =
      a.window > 0 ? min(n_q, (k0 + B - 2 + a.window) / B + 1) : n_q;
  for (int g = 0; g < a.G; ++g) {
    const long long h = hk * a.G + g;
    const T* q = static_cast<const T*>(a.q) + b * st[0] + h * st[1];
    const T* dO = static_cast<const T*>(a.dout) + b * st[12] + h * st[13];
    const long long row_base = (b * a.H + h) * a.Sq;
    for (int t = first; t < end; ++t) {
      const int q0 = t * B;
      __syncthreads();
      load_rows<T, D>(Qs, q, st[2], q0, a.Sq);
      load_rows<T, D>(dOs, dO, st[14], q0, a.Sq);
      for (int r = tid; r < B; r += kThreads) {
        const int i = q0 + r;
        lse_s[r] = i < a.Sq ? a.lse[row_base + i] : INFINITY;
        delta_s[r] = i < a.Sq ? a.delta[row_base + i] : 0.0f;
      }
      __syncthreads();

      // S^T and dP^T for keys ty + 16 i, query rows tx + 16 c
      float s[L::kR][L::kR], dp[L::kR][L::kR];
#pragma unroll
      for (int i = 0; i < L::kR; ++i) {
#pragma unroll
        for (int c = 0; c < L::kR; ++c) s[i][c] = dp[i][c] = 0.0f;
      }
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[L::kR], vv[L::kR], qv[L::kR], gv[L::kR];
#pragma unroll
        for (int i = 0; i < L::kR; ++i) {
          kv[i] = Ks[(ty + 16 * i) * L::kLD + d];
          vv[i] = Vs[(ty + 16 * i) * L::kLD + d];
          qv[i] = Qs[(tx + 16 * i) * L::kLD + d];
          gv[i] = dOs[(tx + 16 * i) * L::kLD + d];
        }
#pragma unroll
        for (int i = 0; i < L::kR; ++i) {
#pragma unroll
          for (int c = 0; c < L::kR; ++c) {
            s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
            dp[i][c] = fmaf(vv[i], gv[c], dp[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < L::kR; ++i) {
        const int r = ty + 16 * i;
        const int col = k0 + r;               // the key
#pragma unroll
        for (int c = 0; c < L::kR; ++c) {
          const int qr = tx + 16 * c;
          const int row = q0 + qr;            // the query
          const float p = masked(a, row, col)
                              ? 0.0f
                              : expf(s[i][c] * a.scale - lse_s[qr]);
          Pt[r * L::kPLD + qr] = p;
          dSt[r * L::kPLD + qr] = p * (dp[i][c] - delta_s[qr]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q for keys ty + 16 i, columns tx + 16 c
#pragma unroll 4
      for (int qq = 0; qq < B; ++qq) {
        float pv[L::kR], dsv[L::kR];
#pragma unroll
        for (int i = 0; i < L::kR; ++i) {
          pv[i] = Pt[(ty + 16 * i) * L::kPLD + qq];
          dsv[i] = dSt[(ty + 16 * i) * L::kPLD + qq];
        }
        const float* gr = dOs + qq * L::kLD + tx;
        const float* qr = Qs + qq * L::kLD + tx;
#pragma unroll
        for (int c = 0; c < L::kC; ++c) {
          const float gvv = gr[16 * c];
          const float qvv = qr[16 * c];
#pragma unroll
          for (int i = 0; i < L::kR; ++i) {
            acc_v[i][c] = fmaf(pv[i], gvv, acc_v[i][c]);
            acc_k[i][c] = fmaf(dsv[i], qvv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < a.Skv) {
      T* kr = dk + key * st[20] + tx;
      T* vr = dv + key * st[23] + tx;
#pragma unroll
      for (int c = 0; c < L::kC; ++c) {
        store(kr + 16 * c, acc_k[i][c] * a.scale);
        store(vr + 16 * c, acc_v[i][c]);
      }
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  using L = Tile<D>;
  return (4 * L::kB * L::kLD + L::kB * L::kPLD + 2 * L::kB) * sizeof(float);
}

template <int D>
constexpr size_t dkdv_smem() {
  using L = Tile<D>;
  return (4 * L::kB * L::kLD + 2 * L::kB * L::kPLD + 2 * L::kB) *
         sizeof(float);
}

template <typename T, int D>
int launch_d(const Args& a, int B, cudaStream_t stream) {
  constexpr int kB = Tile<D>::kB;
  constexpr size_t dq_bytes = dq_smem<D>();
  constexpr size_t kv_bytes = dkdv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(B * a.H, (a.Sq + kB - 1) / kB);
  bwd_dq_kernel<T, D><<<grid_q, kThreads, dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(B * (a.H / a.G), (a.Skv + kB - 1) / kB);
  bwd_dkdv_kernel<T, D><<<grid_kv, kThreads, kv_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ------------------------------------ wgmma: bf16, tensor cores and TMA ---

namespace wgb {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 4;

// the dQ pass's block: kConsumers warpgroups of 64 query rows (three at
// D 64, two at D 128, as K6) and one producer warpgroup; the register
// split moves all a block may hold to the consumers (32 * 128 + 160 * 384
// = 40 * 128 + 232 * 256 = 65536). Shared memory: Q, dO (resident), the
// K stages, the V stages, lse log2(e) and delta of the block's rows, then
// the mbarriers. A tile of R rows is D / 64 swizzle atoms of R rows x 128
// bytes, one after the other, each 1024-byte aligned.
template <int D>
struct DqLayout {
  static constexpr int kConsumers = D == 64 ? 3 : 2;
  static constexpr int kM = 64 * kConsumers;   // query rows a work tile
  static constexpr int kN = 64;                // keys a ring tile
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kProducerRegs = kConsumers == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 232;
  static constexpr int kAtoms = D / 64;
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kTileBytes = kN * D * 2;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kRows = kV + kStages * kTileBytes;
  static constexpr int kBars = kRows + 2 * kM * 4;
  // q_full, q_empty, full[stages], empty[stages]
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;
};

// the dK/dV pass's block: two consumer warpgroups of 64 keys and one
// producer warpgroup. Shared memory: K, V (resident, 128 keys), the Q
// stages, the dO stages, the stages' lse log2(e) and delta (64 + 64
// floats a stage), then the mbarriers.
template <int D>
struct KvLayout {
  static constexpr int kConsumers = 2;
  static constexpr int kN = 128;               // keys a work tile
  static constexpr int kM = 64;                // query rows a ring tile
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kAtoms = D / 64;
  static constexpr int kKVBytes = kN * D * 2;
  static constexpr int kTileBytes = kM * D * 2;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kTileBytes;
  static constexpr int kRows = kDO + kStages * kTileBytes;
  static constexpr int kBars = kRows + kStages * 2 * kM * 4;
  // kv_full, kv_empty, full[stages], empty[stages]
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;
};

// the dQ pass's block at D 256 (`bwd_dq_d256_kernel`): 64 query rows a
// work tile, held by two consumer warpgroups that split D (warpgroup w
// sums dQ for columns [128 w, 128 w + 128)), and one producer warpgroup.
// Shared memory: Q, dO (resident, 32 KB each), two stages of K and V (64
// KB a stage), dS in bf16 (8 KB, 128-byte swizzled: both warpgroups' A
// operand of dQ += dS K), dP in f32 (16 KB, in the accumulator's register
// order), lse log2(e) and delta of the rows, then the mbarriers: 222,768
// bytes. (Resident Q and dO for 128 rows, as at D 128, leave room for
// one 64-key stage only, or for 32-key ring tiles, whose S and dP
// products (n 32, both operands in shared memory) ask more bytes of
// shared memory a clock than the SM delivers.)
template <>
struct DqLayout<256> {
  static constexpr int kConsumers = 2;
  static constexpr int kM = 64;                // query rows a work tile
  static constexpr int kN = 64;                // keys a ring tile
  static constexpr int kStages = 2;
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kAtoms = 4;
  static constexpr int kQBytes = kM * 256 * 2;
  static constexpr int kTileBytes = kN * 256 * 2;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kDS = kV + kStages * kTileBytes;
  static constexpr int kX = kDS + kM * kN * 2;
  static constexpr int kRows = kX + kM * kN * 4;
  static constexpr int kBars = kRows + 2 * kM * 4;
  // q_full, q_empty, full[stages], empty[stages]
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;
  static_assert(kBytes <= 232448, "K6b's D 256 dQ block");
};

// the dK/dV pass's block at D 256 (`bwd_dkdv_d256_kernel`): 64 keys a
// work tile, held by two consumer warpgroups that split D, warpgroup w
// summing dK and dV for columns [128 w, 128 w + 128); one producer
// warpgroup. Shared memory: K, V (resident, 32 KB each), two stages of
// Q and dO (64 KB a stage), P^T and dS^T in bf16 (8 KB each, 128-byte
// swizzled, the A operands of both warpgroups' dV and dK products), dP^T
// in f32 (16 KB, in the accumulator's register order), the stages' lse
// log2(e) and delta, then the mbarriers: 231,472 bytes of the 232,448 a
// block may have.
template <>
struct KvLayout<256> {
  static constexpr int kConsumers = 2;
  static constexpr int kN = 64;                // keys a work tile
  static constexpr int kM = 64;                // query rows a ring tile
  static constexpr int kStages = 2;
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kAtoms = 4;
  static constexpr int kKVBytes = kN * 256 * 2;
  static constexpr int kTileBytes = kM * 256 * 2;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kTileBytes;
  static constexpr int kP = kDO + kStages * kTileBytes;
  static constexpr int kDS = kP + kN * kM * 2;
  static constexpr int kX = kDS + kN * kM * 2;
  static constexpr int kRows = kX + kN * kM * 4;
  static constexpr int kBars = kRows + kStages * 2 * kM * 4;
  // kv_full, kv_empty, full[stages], empty[stages]
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;
  static_assert(kBytes <= 232448, "K6b's D 256 dK/dV block");
};

// the most CTAs that share one work tile of the D 256 dK/dV pass (its
// G query heads' query tiles split between them; ops.FLASH_BWD_MAX_SPLITS)
constexpr int kMaxSplits = 8;

// d (64 x 128, f32) += A (64 x 16, shared memory, K-major) * B (16 x 128,
// shared memory, MN-major)
__device__ __forceinline__ void wgmma_ss_n128_mn(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// A (64 x D) * B^T as D / 16 steps of 16 over two K-major tiles: a step
// moves 32 bytes along a 128-byte swizzled row, or on to the next atom
// (R rows x 128 bytes: ra rows for A's tile, rb for B's). da, db:
// descriptors of the tiles' starts; offsets add to the address field in
// 16-byte units
template <int D, int RA, int RB>
__device__ __forceinline__ void mma_kmajor(float (&d)[32], uint64_t da,
                                           uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;
    wgmma_ss_n64(d, da + ((kk / 4) * RA * 128 + off) / 16,
                 db + ((kk / 4) * RB * 128 + off) / 16, kk > 0);
  }
}

// d (64 x D) += A (64 x 64, bf16 registers) * B (64 x D, MN-major): four
// steps of 16 rows (2 KB of swizzled rows) each; the second 64 columns
// of D one atom further (the descriptor's leading byte offset)
template <int D>
__device__ __forceinline__ void mma_rows(float (&d)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 64) {
      wgmma_rs_n64(d, a[kk], db + kk * 16 * 128 / 16);
    } else {
      wgmma_rs_n128(d, a[kk], db + kk * 16 * 128 / 16);
    }
  }
}

// a 64 x 64 accumulator's k-step kk (columns 16 kk .. 16 kk + 15) as
// wgmma's register A operand: the accumulator's chunks 2 kk and 2 kk + 1
__device__ __forceinline__ void pack_step(uint32_t (&f)[4], const float* x) {
  f[0] = pack_bf16(x[0], x[1]);
  f[1] = pack_bf16(x[2], x[3]);
  f[2] = pack_bf16(x[4], x[5]);
  f[3] = pack_bf16(x[6], x[7]);
}

// a 64 x N accumulator (element 4 n + 2 i + c at row r0 + 8 i, column
// c0 + 8 n + cq + c) stored in bf16 times mul to rows < n_rows of out
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ss,
                                           const float (&acc)[N / 2], int r0,
                                           int cq, int n_rows, float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r < n_rows) {
      __nv_bfloat16* row = out + r * ss + cq;
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        *reinterpret_cast<uint32_t*>(row + 8 * n) = pack_bf16(
            acc[4 * n + 2 * i] * mul, acc[4 * n + 2 * i + 1] * mul);
      }
    }
  }
}

// a 64 x 64 accumulator as wgmma's register A operand, four k-steps
__device__ __forceinline__ void pack_all(uint32_t (&f)[4][4],
                                         const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pack_step(f[kk], x + 8 * kk);
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16 registers) * B (16 x 64, shared
// memory, K-major); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// the warpgroup's 64 rows [r0, r0 + 64) of a K-major tile (R rows an
// atom, 128-byte swizzled by TMA: the 16-byte chunk c of row r lies at
// chunk c ^ (r % 8)) as wgmma's register A operand, D / 16 k-steps, by
// ldmatrix: lanes 0-15 address rows 0-15 of the warp's 16 at the step's
// first chunk, lanes 16-31 at its second
template <int D, int R>
__device__ __forceinline__ void load_afrags(uint32_t (&f)[D / 16][4],
                                            uint32_t tile, int r0) {
  const int lane = threadIdx.x % 32;
  const int row = r0 + (threadIdx.x % 128) / 32 * 16 + lane % 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int chunk = 2 * (kk % 4) + lane / 16;
    const uint32_t addr = tile + (kk / 4) * R * 128 + row * 128 +
                          ((chunk ^ (row % 8)) * 16);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(f[kk][0]), "=r"(f[kk][1]), "=r"(f[kk][2]), "=r"(f[kk][3])
        : "r"(addr));
  }
}

// A (64 x D, registers) * B^T over a K-major tile of RB rows an atom
template <int D, int RB>
__device__ __forceinline__ void mma_kmajor_rs(float (&d)[32],
                                              const uint32_t (&a)[D / 16][4],
                                              uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_rs_n64_kmajor(d, a[kk], db + ((kk / 4) * RB * 128 +
                                        (kk % 4) * 32) / 16, kk > 0);
  }
}

struct DqTile {
  int b, h, q0, kv0, n_kv;
};

// the dQ pass's work tile t: (batch * head, kM query rows), numbered so
// that the heaviest causal tiles come first (K6's order); it visits the
// n_kv KV tiles from kv0 on: up to the diagonal, and (kWindow) from the
// tile holding key q0 - window + 1, never none
template <int D, bool kWindow>
__device__ __forceinline__ DqTile dq_tile(const Args& a, int t, int n_bh) {
  using L = DqLayout<D>;
  const int n_q = (a.Sq + L::kM - 1) / L::kM;
  const int bh = t % n_bh;
  DqTile w;
  w.b = bh / a.H;
  w.h = bh % a.H;
  w.q0 = (n_q - 1 - t / n_bh) * L::kM;
  const int all = (a.Skv + L::kN - 1) / L::kN;
  const int end = a.causal ? min(all, (w.q0 + L::kM - 1) / L::kN + 1) : all;
  w.kv0 = kWindow ? min(max(0, w.q0 - a.window + 1) / L::kN, end - 1) : 0;
  w.n_kv = end - w.kv0;
  return w;
}

struct KvTile {
  int b, hk, k0, first, end;
};

// the dK/dV pass's work tile t: (batch * kv head, 128 keys), the lowest
// keys (under the causal mask the most query tiles) first; it visits
// query tiles [first, end) of 64 rows for each of its G query heads: from
// the diagonal, and (kWindow) up to the tile holding row k0 + 126 +
// window, the last that sees one of its keys
template <bool kWindow>
__device__ __forceinline__ KvTile kv_tile(const Args& a, int t, int n_bkv) {
  const int kv = a.H / a.G;
  const int bkv = t % n_bkv;
  KvTile w;
  w.b = bkv / kv;
  w.hk = bkv % kv;
  w.k0 = (t / n_bkv) * KvLayout<64>::kN;
  const int n_q = (a.Sq + 63) / 64;
  w.first = a.causal ? min(w.k0 / 64, n_q) : 0;
  w.end = kWindow ? max(w.first, min(n_q, (w.k0 + KvLayout<64>::kN - 2 +
                                           a.window) / 64 + 1))
                  : n_q;
  return w;
}

// ------------------------------------------------------------- dQ pass ---

template <int D, bool kWindow>
__global__ void __launch_bounds__(DqLayout<D>::kThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a,
                    int n_bh, int n_tiles) {
  using L = DqLayout<D>;
  constexpr int S = kStages;
  constexpr int C = L::kConsumers;
  constexpr int kM = L::kM;
  constexpr int kN = L::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sdO = base + L::kDO;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  float* rows_s = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                           L::kRows);
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full = q_empty + 8;             // + 8 s
  const uint32_t empty = full + 8 * S;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, C * 4);                   // one arrive a warp
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
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
        const DqTile w = dq_tile<D, kWindow>(a, tile_of(ti), n_bh);
        const int hk = w.h / a.G;
        if (ti > 0) mbar_wait(q_empty, (ti - 1) & 1);
        mbar_expect_tx(q_full, 2 * L::kQBytes);
#pragma unroll
        for (int at = 0; at < L::kAtoms; ++at) {
          tma_load(sQ + at * kM * 128, &tq, q_full, at * 64, w.h, w.q0, w.b);
          tma_load(sdO + at * kM * 128, &tdo, q_full, at * 64, w.h, w.q0,
                   w.b);
        }
        for (int j = 0; j < w.n_kv; ++j, ++g) {
          const int s = g % S;
          if (g >= S) mbar_wait(empty + 8 * s, (g / S - 1) & 1);
          mbar_expect_tx(full + 8 * s, 2 * L::kTileBytes);
#pragma unroll
          for (int at = 0; at < L::kAtoms; ++at) {
            tma_load(sK + s * L::kTileBytes + at * kN * 128, &tk,
                     full + 8 * s, at * 64, hk, (w.kv0 + j) * kN, w.b);
            tma_load(sV + s * L::kTileBytes + at * kN * 128, &tv,
                     full + 8 * s, at * 64, hk, (w.kv0 + j) * kN, w.b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns query rows [qw, qw + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(L::kConsumerRegs));
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cq = 2 * (lane % 4);                 // the thread's column pair
  const float sl2 = a.scale * kLog2e;
  const long long* st = a.st;
  float* lse2_s = rows_s + wgi * 128;            // the warpgroup's 64 rows
  float* delta_s = lse2_s + 64;
  // Q and dO: A operands (K-major); K and V: B operands, K-major for S
  // and dP, K MN-major for dQ += dS K
  const uint64_t dq_a = desc(sQ + wgi * 64 * 128, 16, 1024);
  const uint64_t ddo_a = desc(sdO + wgi * 64 * 128, 16, 1024);
  const uint64_t dk_b = desc(sK, 16, 1024);
  const uint64_t dv_b = desc(sV, 16, 1024);
  const uint64_t dk_mn = desc(sK, kN * 128, 1024);
  constexpr int kStage = L::kTileBytes / 16;     // a stage (descriptor units)
  int g = 0;                                     // KV tiles consumed so far
  for (int ti = 0; tile_of(ti) < n_tiles; ++ti) {
    const DqTile w = dq_tile<D, kWindow>(a, tile_of(ti), n_bh);
    const int qw = w.q0 + wgi * 64;
    const int row0 = qw + warp * 16 + lane / 4;  // the thread's two rows
    const long long bh = static_cast<long long>(w.b) * a.H + w.h;

    // delta of the warpgroup's rows, a pair of threads a row (half the
    // columns each, then one shuffle), and lse log2(e); both into shared
    // memory and the scratch the dK/dV pass reads
    wg_sync(1 + wgi);                            // the last tile's reads
    {
      const int r = tid / 2;
      const int i = qw + r;
      float acc = 0.0f;
      if (i < a.Sq) {
        const __nv_bfloat16* orow = static_cast<const __nv_bfloat16*>(a.o) +
                                    w.b * st[9] + w.h * st[10] + i * st[11] +
                                    (tid % 2) * (D / 2);
        const __nv_bfloat16* grow =
            static_cast<const __nv_bfloat16*>(a.dout) + w.b * st[12] +
            w.h * st[13] + i * st[14] + (tid % 2) * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 2; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* g2 =
              reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 gf = __bfloat1622float2(g2[e]);
            acc = fmaf(gf.x, of.x, acc);
            acc = fmaf(gf.y, of.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (tid % 2 == 0) {
        const float l2 = i < a.Sq ? a.lse[bh * a.Sq + i] * kLog2e : INFINITY;
        lse2_s[r] = l2;
        delta_s[r] = acc;
        if (i < a.sq_pad) {
          a.delta[bh * a.sq_pad + i] = l2;
          a.delta[a.n_bhp + bh * a.sq_pad + i] = acc;
        }
      }
    }
    wg_sync(1 + wgi);
    const float lse0 = lse2_s[row0 - qw];
    const float lse1 = lse2_s[row0 + 8 - qw];
    const float del0 = delta_s[row0 - qw];
    const float del1 = delta_s[row0 + 8 - qw];

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
    // the work tile's KV tiles (numbered from w.kv0) this warpgroup's rows
    // see, [m0, m1): up to its diagonal (the block's last warpgroup sees
    // up to n_kv), and with a window from the tile holding key qw - window
    // + 1 (the block's first warpgroup from 0); never none
    const int m1 = a.causal ? min(w.n_kv, qw / kN + 1 - w.kv0) : w.n_kv;
    const int m0 =
        kWindow ? min(max(0, qw - a.window + 1) / kN - w.kv0, m1 - 1) : 0;
    mbar_wait(q_full, ti & 1);
    // The warpgroup's KV tiles m0 .. m1 - 1: tile j's S and dP go to the
    // tensor cores together with tile j - 1's dQ += dS K (its stage sp),
    // and tile j's p and ds are formed while that product runs. No
    // product is in flight across a branch (ptxas would serialize them):
    // tile m0 and the last product are peeled off the loop.
    auto form = [&](float (&sc)[32], const float (&dp)[32], int j) {
      // S -> dS in place: p = 2^(s scale log2(e) - lse log2(e)), masked
      // only where the tile crosses the diagonal, the end of the keys or
      // the band's lower edge
      const int k0 = (w.kv0 + j) * kN;
      const bool edge = k0 + kN > a.Skv || (a.causal && k0 + kN - 1 > qw) ||
                        (kWindow && qw + 63 - k0 >= a.window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {             // element 4 n + 2 i + c
        const int i = (e >> 1) & 1;
        const int col = k0 + 8 * (e / 4) + cq + (e & 1);
        const int row = row0 + 8 * i;
        float p = ex2(fmaf(sc[e], sl2, i ? -lse1 : -lse0));
        if (edge && (col >= a.Skv || (a.causal && col > row) ||
                     (kWindow && row - col >= a.window))) {
          p = 0.0f;
        }
        sc[e] = p * (dp[e] - (i ? del1 : del0));
      }
    };
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
    };
    // tiles below this warpgroup's band: read by the others only
    for (int j = 0; j < m0; ++j) {
      const int s = (g + j) % S;
      mbar_wait(full + 8 * s, ((g + j) / S) & 1);
      release(s);
    }
    uint32_t df[4][4];
    int sp = (g + m0) % S;
    {
      mbar_wait(full + 8 * sp, ((g + m0) / S) & 1);
      float sc[32], dp[32];
      wgmma_fence();
      mma_kmajor<D, kM, kN>(sc, dq_a, dk_b + sp * kStage);
      mma_kmajor<D, kM, kN>(dp, ddo_a, dv_b + sp * kStage);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      pin(dp);
      form(sc, dp, m0);
      pack_all(df, sc);
    }
    for (int j = m0 + 1; j < m1; ++j) {
      const int s = (g + j) % S;
      mbar_wait(full + 8 * s, ((g + j) / S) & 1);
      float sc[32], dp[32];
      wgmma_fence();
      mma_kmajor<D, kM, kN>(sc, dq_a, dk_b + s * kStage);
      mma_kmajor<D, kM, kN>(dp, ddo_a, dv_b + s * kStage);
      wgmma_commit();
      mma_rows<D>(dq, df, dk_mn + sp * kStage);
      wgmma_commit();
      wgmma_wait<1>();                           // S and dP are in
      pin(sc);
      pin(dp);
      form(sc, dp, j);
      wgmma_wait<0>();
      pin(dq);
      release(sp);
      pack_all(df, sc);                          // after the product read df
      sp = s;
    }
    wgmma_fence();
    mma_rows<D>(dq, df, dk_mn + sp * kStage);
    wgmma_commit();
    wgmma_wait<0>();
    pin(dq);
    release(sp);
    // tiles above this warpgroup's diagonal: read by the others only
    for (int j = m1; j < w.n_kv; ++j) {
      const int s = (g + j) % S;
      mbar_wait(full + 8 * s, ((g + j) / S) & 1);
      release(s);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);         // Q and dO are read
    g += w.n_kv;

    __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq) + w.b * st[15] +
                         w.h * st[16];
    store_rows<D>(dqg, st[17], dq, row0, cq, a.Sq, a.scale);
  }
}

// ---------------------------------------------------------- dK/dV pass ---

template <int D, bool kWindow>
__global__ void __launch_bounds__(KvLayout<D>::kThreads, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Args a,
                      int n_bkv, int n_tiles) {
  using L = KvLayout<D>;
  constexpr int S = kStages;
  constexpr int C = L::kConsumers;
  constexpr int kM = L::kM;
  constexpr int kN = L::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = base + L::kV;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sdO = base + L::kDO;
  const uint32_t sRows = base + L::kRows;
  const float* rows_s = reinterpret_cast<const float*>(
      smem_raw + (base - raw) + L::kRows);
  const uint32_t kv_full = base + L::kBars;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8;            // + 8 s
  const uint32_t empty = full + 8 * S;
  const float* lse2_g = a.delta;                 // (B, H, sq_pad) each
  const float* delta_g = a.delta + a.n_bhp;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, C * 4);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, C * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == C) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(L::kProducerRegs));
    if (threadIdx.x == C * 128) {
      int g = 0;                                 // ring tiles loaded so far
      for (int ti = 0; tile_of(ti) < n_tiles; ++ti) {
        const KvTile w = kv_tile<kWindow>(a, tile_of(ti), n_bkv);
        if (ti > 0) mbar_wait(kv_empty, (ti - 1) & 1);
        mbar_expect_tx(kv_full, 2 * L::kKVBytes);
#pragma unroll
        for (int at = 0; at < L::kAtoms; ++at) {
          tma_load(sK + at * kN * 128, &tk, kv_full, at * 64, w.hk, w.k0,
                   w.b);
          tma_load(sV + at * kN * 128, &tv, kv_full, at * 64, w.hk, w.k0,
                   w.b);
        }
        for (int gq = 0; gq < a.G; ++gq) {
          const int h = w.hk * a.G + gq;
          const long long row_base =
              (static_cast<long long>(w.b) * a.H + h) * a.sq_pad;
          for (int t = w.first; t < w.end; ++t, ++g) {
            const int s = g % S;
            if (g >= S) mbar_wait(empty + 8 * s, (g / S - 1) & 1);
            mbar_expect_tx(full + 8 * s, 2 * L::kTileBytes + 2 * kM * 4);
#pragma unroll
            for (int at = 0; at < L::kAtoms; ++at) {
              tma_load(sQ + s * L::kTileBytes + at * kM * 128, &tq,
                       full + 8 * s, at * 64, h, t * kM, w.b);
              tma_load(sdO + s * L::kTileBytes + at * kM * 128, &tdo,
                       full + 8 * s, at * 64, h, t * kM, w.b);
            }
            bulk_load(sRows + s * 2 * kM * 4, lse2_g + row_base + t * kM,
                      kM * 4, full + 8 * s);
            bulk_load(sRows + s * 2 * kM * 4 + kM * 4,
                      delta_g + row_base + t * kM, kM * 4, full + 8 * s);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns keys [kw, kw + 64) of each work tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(L::kConsumerRegs));
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cq = 2 * (lane % 4);
  const float sl2 = a.scale * kLog2e;
  const long long* st = a.st;
  // K and V: A operands (K-major); Q and dO: B operands, K-major for S^T
  // and dP^T, MN-major for dK += dS^T Q and dV += P^T dO
  const uint64_t dk_a = desc(sK + wgi * 64 * 128, 16, 1024);
  const uint64_t dv_a = desc(sV + wgi * 64 * 128, 16, 1024);
  const uint64_t dq_b = desc(sQ, 16, 1024);
  const uint64_t ddo_b = desc(sdO, 16, 1024);
  const uint64_t dq_mn = desc(sQ, kM * 128, 1024);
  const uint64_t ddo_mn = desc(sdO, kM * 128, 1024);
  constexpr int kStage = L::kTileBytes / 16;
  int g = 0;                                     // ring tiles consumed so far
  for (int ti = 0; tile_of(ti) < n_tiles; ++ti) {
    const KvTile w = kv_tile<kWindow>(a, tile_of(ti), n_bkv);
    const int kw = w.k0 + wgi * 64;
    const int key0 = kw + warp * 16 + lane / 4;  // the thread's two keys
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
    mbar_wait(kv_full, ti & 1);
    // For each query head, the warpgroup's query tiles t0 .. t1 - 1 (under
    // the causal mask the second warpgroup's keys lie above tile `first`;
    // under a window the first warpgroup's keys lie below the band of
    // the work tile's last query tile).
    // At D 64 a tile's S^T and dP^T go to the tensor cores together with
    // the previous tile's dV and dK products (their stage sp), and its
    // p^T and ds^T are formed while those run; at D 128 the second pair
    // of bf16 operands does not fit beside the two accumulators, and each
    // tile's products run one after the other. No product is in flight
    // across a branch: a head's first tile and last products are peeled.
    constexpr bool kPipe = D == 64;
    // at D 64 the warpgroup's K and V rows go to registers once a work
    // tile (wgmma's A operand), so S^T and dP^T read only Q and dO from
    // shared memory, and K and V's buffer is free for the next work tile
    constexpr bool kAfrag = D == 64;
    uint32_t kf[D / 16][4], vf[D / 16][4];
    if constexpr (kAfrag) {
      load_afrags<D, kN>(kf, sK, wgi * 64);
      load_afrags<D, kN>(vf, sV, wgi * 64);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty);      // K and V are read
    }
    auto form = [&](float (&sc)[32], float (&dp)[32], int s, int q0) {
      // S^T -> P^T and dP^T -> dS^T in place
      const float* lse2 = rows_s + s * 2 * kM;
      const float* delta = lse2 + kM;
      const bool edge = kw + 64 > a.Skv || (a.causal && kw + 63 > q0) ||
                        (kWindow && q0 + 63 - kw >= a.window);
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        // elements e, e + 1: key key0 + 8 i, queries c, c + 1
        const int i = (e >> 1) & 1;
        const int c = 8 * (e / 4) + cq;          // query column in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
        const float2 d2 = *reinterpret_cast<const float2*>(delta + c);
        float p0 = ex2(fmaf(sc[e], sl2, -l2.x));
        float p1 = ex2(fmaf(sc[e + 1], sl2, -l2.y));
        if (edge) {
          const int key = key0 + 8 * i;
          const int qr = q0 + c;
          if (key >= a.Skv || (a.causal && key > qr) ||
              (kWindow && qr - key >= a.window)) {
            p0 = 0.0f;
          }
          if (key >= a.Skv || (a.causal && key > qr + 1) ||
              (kWindow && qr + 1 - key >= a.window)) {
            p1 = 0.0f;
          }
        }
        sc[e] = p0;
        sc[e + 1] = p1;
        dp[e] = p0 * (dp[e] - d2.x);
        dp[e + 1] = p1 * (dp[e + 1] - d2.y);
      }
    };
    auto scores = [&](float (&sc)[32], float (&dp)[32], int s) {
      if constexpr (kAfrag) {
        mma_kmajor_rs<D, kM>(sc, kf, dq_b + s * kStage);
        mma_kmajor_rs<D, kM>(dp, vf, ddo_b + s * kStage);
      } else {
        mma_kmajor<D, kN, kM>(sc, dk_a, dq_b + s * kStage);
        mma_kmajor<D, kN, kM>(dp, dv_a, ddo_b + s * kStage);
      }
      wgmma_commit();
    };
    auto grads = [&](const uint32_t (&pf)[4][4], const uint32_t (&df)[4][4],
                     int s) {                    // dV += P^T dO, dK += dS^T Q
      mma_rows<D>(dv, pf, ddo_mn + s * kStage);
      mma_rows<D>(dk, df, dq_mn + s * kStage);
      wgmma_commit();
    };
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
    };
    const int skip = a.causal ? min(wgi, w.end - w.first) : 0;
    const int t0 = w.first + skip;
    // with a window, query rows past kw + 62 + window see none of the
    // warpgroup's keys
    const int t1 =
        kWindow ? max(t0, min(w.end, (kw + 62 + a.window) / 64 + 1)) : w.end;
    for (int gq = 0; gq < a.G; ++gq) {
      for (int t = w.first; t < t0; ++t, ++g) {  // above the diagonal
        mbar_wait(full + 8 * (g % S), (g / S) & 1);
        release(g % S);
      }
      if (!kPipe) {
        for (int t = t0; t < t1; ++t, ++g) {
          const int s = g % S;
          mbar_wait(full + 8 * s, (g / S) & 1);
          float sc[32], dp[32];
          uint32_t pf[4][4], df[4][4];
          wgmma_fence();
          scores(sc, dp, s);
          wgmma_wait<0>();
          pin(sc);
          pin(dp);
          form(sc, dp, s, t * kM);
          pack_all(pf, sc);
          pack_all(df, dp);
          wgmma_fence();
          grads(pf, df, s);
          wgmma_wait<0>();
          pin(dv);
          pin(dk);
          release(s);
        }
      } else if (t0 < t1) {
        uint32_t pf[4][4], df[4][4];
        int sp = g % S;
        {
          mbar_wait(full + 8 * sp, (g / S) & 1);
          float sc[32], dp[32];
          wgmma_fence();
          scores(sc, dp, sp);
          wgmma_wait<0>();
          pin(sc);
          pin(dp);
          form(sc, dp, sp, t0 * kM);
          pack_all(pf, sc);
          pack_all(df, dp);
        }
        ++g;
        for (int t = t0 + 1; t < t1; ++t, ++g) {
          const int s = g % S;
          mbar_wait(full + 8 * s, (g / S) & 1);
          float sc[32], dp[32];
          wgmma_fence();
          scores(sc, dp, s);
          grads(pf, df, sp);
          wgmma_wait<1>();                       // S^T and dP^T are in
          pin(sc);
          pin(dp);
          form(sc, dp, s, t * kM);
          wgmma_wait<0>();
          pin(dv);
          pin(dk);
          release(sp);
          pack_all(pf, sc);                      // after the products read them
          pack_all(df, dp);
          sp = s;
        }
        wgmma_fence();
        grads(pf, df, sp);
        wgmma_wait<0>();
        pin(dv);
        pin(dk);
        release(sp);
      }
      for (int t = t1; t < w.end; ++t, ++g) {    // below the band
        mbar_wait(full + 8 * (g % S), (g / S) & 1);
        release(g % S);
      }
    }
    if constexpr (!kAfrag) {
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty);      // K and V are read
    }

    __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk) + w.b * st[18] +
                         w.hk * st[19];
    __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv) + w.b * st[21] +
                         w.hk * st[22];
    store_rows<D>(dkg, st[20], dk, key0, cq, a.Skv, a.scale);
    store_rows<D>(dvg, st[23], dv, key0, cq, a.Skv, 1.0f);
  }
}

// ------------------------------------------------ dK/dV pass at D 256 ---

struct KvSplit {
  int bkv, b, hk, k0, c, first, nt, p0, p1;
};

// the D 256 dK/dV pass's work tile t: (batch * kv head, split c, 64
// keys), the lowest keys first. Its G query heads' query tiles [first,
// first + nt) of 64 rows (from the diagonal, and (kWindow) up to the tile
// holding row k0 + 62 + window, the last that sees one of its keys) are
// numbered p = g nt + (tile - first) and cut into `splits` runs: split c
// takes [p0, p1), possibly none
template <bool kWindow>
__device__ __forceinline__ KvSplit kv_split(const Args& a, int t, int n_bkv,
                                            int splits) {
  using L = KvLayout<256>;
  const int kv = a.H / a.G;
  KvSplit w;
  w.bkv = t % n_bkv;
  w.b = w.bkv / kv;
  w.hk = w.bkv % kv;
  const int r = t / n_bkv;
  w.c = r % splits;
  w.k0 = (r / splits) * L::kN;
  const int n_q = (a.Sq + L::kM - 1) / L::kM;
  w.first = a.causal ? min(w.k0 / L::kM, n_q) : 0;
  const int end =
      kWindow ? max(w.first,
                    min(n_q, (w.k0 + L::kN - 2 + a.window) / L::kM + 1))
              : n_q;
  w.nt = end - w.first;
  const int n = a.G * w.nt;
  w.p0 = w.c * n / splits;
  w.p1 = (w.c + 1) * n / splits;
  return w;
}

// a 64 x N accumulator (as store_rows) in f32 to rows < n_rows of out
template <int N>
__device__ __forceinline__ void store_rows_f32(float* out, long long ss,
                                               const float (&acc)[N / 2],
                                               int r0, int cq, int n_rows) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r < n_rows) {
      float* row = out + r * ss + cq;
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        *reinterpret_cast<float2*>(row + 8 * n) =
            make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
      }
    }
  }
}

// named barriers between the two consumer warpgroups of the D 256
// passes (bar_sync / bar_arrive, 256 threads) and warpgroup 0's own
// (wg_sync)
constexpr int kBarX = 1;       // dP (dP^T) is in shared memory (1 -> 0)
constexpr int kBarP = 2;       // dS (P^T and dS^T) are (0 -> 1)
constexpr int kBarFree = 3;    // 1's products have read them (1 -> 0)
constexpr int kBarWg0 = 4;

// the 16-byte chunk c of row r of a 64-row, 128-byte swizzled tile lies
// at chunk c ^ (r % 8): the 32-bit word of elements e, e + 1 (columns 8
// (e / 4) + cq, + 1) of the thread's row r, as a word index
__device__ __forceinline__ int swizzled_word(int r, int e, int lane) {
  return r * 32 + (((e / 4) ^ (r % 8)) * 4) + lane % 4;
}

// One work tile of 64 query rows, both consumer warpgroups over all of
// them, each summing dQ for its 128 columns of D. A KV tile (stage s):
// warpgroup 0 forms S = Q K^T, warpgroup 1 dP = dO V^T (ss, 16 k-steps
// each); warpgroup 1 puts dP in f32 into shared memory in its register
// order; warpgroup 0 forms p in place, takes dP from there, forms ds = p
// (dP - delta) and writes dS in bf16 as a swizzled K-major tile; then
// each warpgroup runs dQ += dS K over its columns (ss, K MN-major, 4
// k-steps of n128). As in the D 256 dK/dV pass, each warpgroup issues
// the next tile's S or dP with (0) or before (1) this tile's dQ product,
// and no product is in flight across a branch. Warpgroup 0 first forms
// delta of the rows (a pair of threads a row) and writes lse log2(e) and
// delta to the scratch the dK/dV pass reads.
template <bool kWindow>
__global__ void __launch_bounds__(DqLayout<256>::kThreads, 1)
bwd_dq_d256_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Args a,
                   int n_bh, int n_tiles) {
  using L = DqLayout<256>;
  constexpr int S = L::kStages;
  constexpr int C = L::kConsumers;
  constexpr int kM = L::kM;
  constexpr int kN = L::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sdO = base + L::kDO;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t sdS = base + L::kDS;
  uint32_t* const ds_s = reinterpret_cast<uint32_t*>(gbase + L::kDS);
  float* const x_s = reinterpret_cast<float*>(gbase + L::kX);
  float* const lse2_s = reinterpret_cast<float*>(gbase + L::kRows);
  float* const delta_s = lse2_s + kM;
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full = q_empty + 8;             // + 8 s
  const uint32_t empty = full + 8 * S;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, C * 4);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, C * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == C) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(L::kProducerRegs));
    if (threadIdx.x == C * 128) {
      int g = 0;                                 // KV tiles loaded so far
      for (int ti = 0; tile_of(ti) < n_tiles; ++ti) {
        const DqTile w = dq_tile<256, kWindow>(a, tile_of(ti), n_bh);
        const int hk = w.h / a.G;
        if (ti > 0) mbar_wait(q_empty, (ti - 1) & 1);
        mbar_expect_tx(q_full, 2 * L::kQBytes);
#pragma unroll
        for (int at = 0; at < L::kAtoms; ++at) {
          tma_load(sQ + at * kM * 128, &tq, q_full, at * 64, w.h, w.q0, w.b);
          tma_load(sdO + at * kM * 128, &tdo, q_full, at * 64, w.h, w.q0,
                   w.b);
        }
        for (int j = 0; j < w.n_kv; ++j, ++g) {
          const int s = g % S;
          if (g >= S) mbar_wait(empty + 8 * s, (g / S - 1) & 1);
          mbar_expect_tx(full + 8 * s, 2 * L::kTileBytes);
#pragma unroll
          for (int at = 0; at < L::kAtoms; ++at) {
            tma_load(sK + s * L::kTileBytes + at * kN * 128, &tk,
                     full + 8 * s, at * 64, hk, (w.kv0 + j) * kN, w.b);
            tma_load(sV + s * L::kTileBytes + at * kN * 128, &tv,
                     full + 8 * s, at * 64, hk, (w.kv0 + j) * kN, w.b);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(L::kConsumerRegs));
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cq = 2 * (lane % 4);
  const float sl2 = a.scale * kLog2e;
  const long long* st = a.st;
  // S (0) or dP (1): A the resident Q or dO in registers, B K-major from
  // the stage's K or V; dQ += dS K: A K-major from dS (one atom), B
  // MN-major from the stage's K atoms 2 wgi and 2 wgi + 1
  const uint32_t a_tile = wgi == 0 ? sQ : sdO;
  const uint64_t d_b = desc(wgi == 0 ? sK : sV, 16, 1024);
  const uint64_t dds_a = desc(sdS, 16, 1024);
  const uint64_t dk_mn = desc(sK + wgi * 2 * kN * 128, kN * 128, 1024);
  constexpr int kStage = L::kTileBytes / 16;
  int g = 0;                                     // KV tiles consumed so far
  int n_done = 0;                                // tiles 0 wrote dS for
  for (int ti = 0; tile_of(ti) < n_tiles; ++ti) {
    const DqTile w = dq_tile<256, kWindow>(a, tile_of(ti), n_bh);
    const int row0 = w.q0 + warp * 16 + lane / 4;  // the thread's two rows
    const long long bh = static_cast<long long>(w.b) * a.H + w.h;
    float lse0 = 0.0f, lse1 = 0.0f, del0 = 0.0f, del1 = 0.0f;
    if (wgi == 0) {
      // delta of the rows, a pair of threads a row (half the columns
      // each, then one shuffle), and lse log2(e): into shared memory and
      // the scratch the dK/dV pass reads
      wg_sync(kBarWg0);                          // the last tile's reads
      const int r = tid / 2;
      const int i = w.q0 + r;
      float acc = 0.0f;
      if (i < a.Sq) {
        const __nv_bfloat16* orow = static_cast<const __nv_bfloat16*>(a.o) +
                                    w.b * st[9] + w.h * st[10] + i * st[11] +
                                    (tid % 2) * 128;
        const __nv_bfloat16* grow =
            static_cast<const __nv_bfloat16*>(a.dout) + w.b * st[12] +
            w.h * st[13] + i * st[14] + (tid % 2) * 128;
#pragma unroll 4
        for (int c = 0; c < 128; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* g2 =
              reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 gf = __bfloat1622float2(g2[e]);
            acc = fmaf(gf.x, of.x, acc);
            acc = fmaf(gf.y, of.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (tid % 2 == 0) {
        const float l2 = i < a.Sq ? a.lse[bh * a.Sq + i] * kLog2e : INFINITY;
        lse2_s[r] = l2;
        delta_s[r] = acc;
        if (i < a.sq_pad) {
          a.delta[bh * a.sq_pad + i] = l2;
          a.delta[a.n_bhp + bh * a.sq_pad + i] = acc;
        }
      }
      wg_sync(kBarWg0);
      lse0 = lse2_s[row0 - w.q0];
      lse1 = lse2_s[row0 + 8 - w.q0];
      del0 = delta_s[row0 - w.q0];
      del1 = delta_s[row0 + 8 - w.q0];
    }
    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.0f;
    // the warpgroup's A operand of S (Q) or dP (dO), all 64 rows, in
    // registers once a work tile (64 a thread): the products then read
    // only K or V from shared memory, and Q and dO's buffer is free for
    // the next work tile at once
    uint32_t af[16][4];
    mbar_wait(q_full, ti & 1);
    load_afrags<256, kM>(af, a_tile, 0);
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);         // Q and dO are read
    const int n = w.n_kv;
    auto scores = [&](float (&x)[32], int s) {
      mma_kmajor_rs<256, kN>(x, af, d_b + s * kStage);
      wgmma_commit();
    };
    auto grads = [&](int s) {                    // dQ += dS K
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n128_mn(dq, dds_a + kk * 2, dk_mn + s * kStage + kk * 128);
      }
      wgmma_commit();
    };
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
    };
    // warpgroup 0: S -> p in place, then (dP from warpgroup 1) dS, to
    // shared memory in bf16 for both warpgroups
    auto form = [&](float (&x)[32], int j) {
      const int k0 = (w.kv0 + j) * kN;
      const bool edge = k0 + kN > a.Skv ||
                        (a.causal && k0 + kN - 1 > w.q0) ||
                        (kWindow && w.q0 + kM - 1 - k0 >= a.window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {             // element 4 n + 2 i + c
        const int i = (e >> 1) & 1;
        const int col = k0 + 8 * (e / 4) + cq + (e & 1);
        const int row = row0 + 8 * i;
        float p = ex2(fmaf(x[e], sl2, i ? -lse1 : -lse0));
        if (edge && (col >= a.Skv || (a.causal && col > row) ||
                     (kWindow && row - col >= a.window))) {
          p = 0.0f;
        }
        x[e] = p;
      }
      bar_sync(kBarX);                           // dP is in x_s
      if (n_done > 0) bar_sync(kBarFree);        // the last dS read
      ++n_done;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int i = (e >> 1) & 1;
        const float del = i ? del1 : del0;
        const float ds0 = x[e] * (x_s[e * 128 + tid] - del);
        const float ds1 = x[e + 1] * (x_s[(e + 1) * 128 + tid] - del);
        ds_s[swizzled_word(warp * 16 + lane / 4 + 8 * i, e, lane)] =
            pack_bf16(ds0, ds1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(kBarWg0);
      bar_arrive(kBarP);
    };
    // warpgroup 1: dP to shared memory in its register order
    auto put = [&](const float (&x)[32]) {
#pragma unroll
      for (int e = 0; e < 32; ++e) x_s[e * 128 + tid] = x[e];
      bar_arrive(kBarX);
    };
    float x[32];                                 // S (0) or dP (1)
    {
      const int s = g % S;
      mbar_wait(full + 8 * s, (g / S) & 1);
      wgmma_fence();
      scores(x, s);
      wgmma_wait<0>();
      pin(x);
    }
    if (wgi == 0) {
      for (int j = 0; j < n - 1; ++j, ++g) {
        const int s = g % S;
        form(x, j);
        const int s2 = (g + 1) % S;
        mbar_wait(full + 8 * s2, ((g + 1) / S) & 1);
        wgmma_fence();
        grads(s);
        scores(x, s2);
        wgmma_wait<0>();
        pin(x);
        pin(dq);
        release(s);
      }
      const int s = g % S;
      form(x, n - 1);
      wgmma_fence();
      grads(s);
      wgmma_wait<0>();
      pin(dq);
      release(s);
      ++g;
    } else {
      for (int j = 0; j < n - 1; ++j, ++g) {
        const int s = g % S;
        put(x);
        const int s2 = (g + 1) % S;
        mbar_wait(full + 8 * s2, ((g + 1) / S) & 1);
        wgmma_fence();
        scores(x, s2);
        bar_sync(kBarP);                         // dS is in
        grads(s);
        wgmma_wait<0>();
        pin(x);
        pin(dq);
        bar_arrive(kBarFree);
        release(s);
      }
      const int s = g % S;
      put(x);
      bar_sync(kBarP);
      wgmma_fence();
      grads(s);
      wgmma_wait<0>();
      pin(dq);
      bar_arrive(kBarFree);
      release(s);
      ++g;
    }

    __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq) + w.b * st[15] +
                         w.h * st[16] + 128 * wgi;
    store_rows<128>(dqg, st[17], dq, row0, cq, a.Sq, a.scale);
  }
  if (wgi == 0 && n_done > 0) bar_sync(kBarFree);  // 1's last arrival
}

// One work tile of 64 keys, both consumer warpgroups over all of them,
// each summing dK and dV for its 128 columns of D. A query tile (stage
// s): warpgroup 0 forms S^T = K Q^T, warpgroup 1 dP^T = V dO^T (ss, 16
// k-steps each, issued together); warpgroup 1 puts dP^T in f32 into
// shared memory in its register order; warpgroup 0 forms p^T in place,
// takes dP^T from there, forms ds^T = p^T (dP^T - delta) and writes P^T
// and dS^T in bf16 as swizzled K-major tiles; then each warpgroup runs
// dV += P^T dO and dK += dS^T Q over its columns (ss, B MN-major, 2 x 4
// k-steps of n128). Each warpgroup issues the next tile's S^T or dP^T
// with (warpgroup 0) or before (1) this tile's dV and dK products, so the
// tensor cores have work while warpgroup 0 forms p^T and ds^T; each
// tile's first scores and last products are peeled off the loop, so no
// product is in flight across a branch. With `splits` > 1 a split's
// sums go in f32 to `part` ((splits, B Kv, Skv rounded up to 64, dK | dV
// of 2 D floats)) and `dkdv_sum_kernel` adds them up in split order.
template <bool kWindow>
__global__ void __launch_bounds__(KvLayout<256>::kThreads, 1)
bwd_dkdv_d256_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Args a,
                     int n_bkv, int n_tiles, int splits, float* part) {
  using L = KvLayout<256>;
  constexpr int S = L::kStages;
  constexpr int C = L::kConsumers;
  constexpr int kM = L::kM;
  constexpr int kN = L::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t sK = base;
  const uint32_t sV = base + L::kV;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sdO = base + L::kDO;
  const uint32_t sP = base + L::kP;
  const uint32_t sdS = base + L::kDS;
  uint32_t* const p_s = reinterpret_cast<uint32_t*>(gbase + L::kP);
  uint32_t* const ds_s = reinterpret_cast<uint32_t*>(gbase + L::kDS);
  float* const x_s = reinterpret_cast<float*>(gbase + L::kX);
  const uint32_t sRows = base + L::kRows;
  const float* rows_s = reinterpret_cast<const float*>(gbase + L::kRows);
  const uint32_t kv_full = base + L::kBars;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8;            // + 8 s
  const uint32_t empty = full + 8 * S;
  const float* lse2_g = a.delta;                 // (B, H, sq_pad) each
  const float* delta_g = a.delta + a.n_bhp;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, C * 4);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, C * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == C) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(L::kProducerRegs));
    if (threadIdx.x == C * 128) {
      int g = 0;                                 // ring tiles loaded so far
      for (int ti = 0; tile_of(ti) < n_tiles; ++ti) {
        const KvSplit w = kv_split<kWindow>(a, tile_of(ti), n_bkv, splits);
        if (ti > 0) mbar_wait(kv_empty, (ti - 1) & 1);
        mbar_expect_tx(kv_full, 2 * L::kKVBytes);
#pragma unroll
        for (int at = 0; at < L::kAtoms; ++at) {
          tma_load(sK + at * kN * 128, &tk, kv_full, at * 64, w.hk, w.k0,
                   w.b);
          tma_load(sV + at * kN * 128, &tv, kv_full, at * 64, w.hk, w.k0,
                   w.b);
        }
        for (int p = w.p0; p < w.p1; ++p, ++g) {
          const int h = w.hk * a.G + p / w.nt;
          const int t = w.first + p % w.nt;
          const long long row_base =
              (static_cast<long long>(w.b) * a.H + h) * a.sq_pad;
          const int s = g % S;
          if (g >= S) mbar_wait(empty + 8 * s, (g / S - 1) & 1);
          mbar_expect_tx(full + 8 * s, 2 * L::kTileBytes + 2 * kM * 4);
#pragma unroll
          for (int at = 0; at < L::kAtoms; ++at) {
            tma_load(sQ + s * L::kTileBytes + at * kM * 128, &tq,
                     full + 8 * s, at * 64, h, t * kM, w.b);
            tma_load(sdO + s * L::kTileBytes + at * kM * 128, &tdo,
                     full + 8 * s, at * 64, h, t * kM, w.b);
          }
          bulk_load(sRows + s * 2 * kM * 4, lse2_g + row_base + t * kM,
                    kM * 4, full + 8 * s);
          bulk_load(sRows + s * 2 * kM * 4 + kM * 4,
                    delta_g + row_base + t * kM, kM * 4, full + 8 * s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(L::kConsumerRegs));
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cq = 2 * (lane % 4);
  const float sl2 = a.scale * kLog2e;
  const long long* st = a.st;
  // S^T (0) or dP^T (1): A K-major from the resident K or V, B K-major
  // from the stage's Q or dO; dV += P^T dO, dK += dS^T Q: A K-major from
  // P^T and dS^T (one atom), B MN-major from the stage's atoms 2 wgi and
  // 2 wgi + 1 (the warpgroup's 128 columns)
  const uint64_t d_a = desc(wgi == 0 ? sK : sV, 16, 1024);
  const uint64_t d_b = desc(wgi == 0 ? sQ : sdO, 16, 1024);
  const uint64_t dp_a = desc(sP, 16, 1024);
  const uint64_t dds_a = desc(sdS, 16, 1024);
  const uint64_t dq_mn = desc(sQ + wgi * 2 * kM * 128, kM * 128, 1024);
  const uint64_t ddo_mn = desc(sdO + wgi * 2 * kM * 128, kM * 128, 1024);
  constexpr int kStage = L::kTileBytes / 16;
  int g = 0;                                     // ring tiles consumed so far
  int n_done = 0;                                // tiles 0 wrote P^T for
  for (int ti = 0; tile_of(ti) < n_tiles; ++ti) {
    const KvSplit w = kv_split<kWindow>(a, tile_of(ti), n_bkv, splits);
    const int key0 = w.k0 + warp * 16 + lane / 4;  // the thread's two keys
    const int n = w.p1 - w.p0;
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.0f;
    mbar_wait(kv_full, ti & 1);
    auto scores = [&](float (&x)[32], int s) {
      mma_kmajor<256, kN, kM>(x, d_a, d_b + s * kStage);
      wgmma_commit();
    };
    auto grads = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n128_mn(dv, dp_a + kk * 2, ddo_mn + s * kStage + kk * 128);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n128_mn(dk, dds_a + kk * 2, dq_mn + s * kStage + kk * 128);
      }
      wgmma_commit();
    };
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
    };
    // warpgroup 0: S^T -> P^T in place, then (dP^T from warpgroup 1) dS^T;
    // P^T and dS^T to shared memory in bf16, 128-byte swizzled (the 16-byte
    // chunk c of key row r at chunk c ^ (r % 8)), for both warpgroups
    auto form = [&](float (&x)[32], int s, int p) {
      const int q0 = (w.first + p % w.nt) * kM;
      const float* lse2 = rows_s + s * 2 * kM;
      const float* delta = lse2 + kM;
      const bool edge = w.k0 + kN > a.Skv ||
                        (a.causal && w.k0 + kN - 1 > q0) ||
                        (kWindow && q0 + kM - 1 - w.k0 >= a.window);
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        // elements e, e + 1: key key0 + 8 i, queries c, c + 1
        const int i = (e >> 1) & 1;
        const int c = 8 * (e / 4) + cq;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
        float p0 = ex2(fmaf(x[e], sl2, -l2.x));
        float p1 = ex2(fmaf(x[e + 1], sl2, -l2.y));
        if (edge) {
          const int key = key0 + 8 * i;
          const int qr = q0 + c;
          if (key >= a.Skv || (a.causal && key > qr) ||
              (kWindow && qr - key >= a.window)) {
            p0 = 0.0f;
          }
          if (key >= a.Skv || (a.causal && key > qr + 1) ||
              (kWindow && qr + 1 - key >= a.window)) {
            p1 = 0.0f;
          }
        }
        x[e] = p0;
        x[e + 1] = p1;
      }
      bar_sync(kBarX);                           // dP^T is in x_s
      if (n_done > 0) bar_sync(kBarFree);        // the last P^T, dS^T read
      ++n_done;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int i = (e >> 1) & 1;
        const int c = 8 * (e / 4) + cq;
        const float2 d2 = *reinterpret_cast<const float2*>(delta + c);
        const float ds0 = x[e] * (x_s[e * 128 + tid] - d2.x);
        const float ds1 = x[e + 1] * (x_s[(e + 1) * 128 + tid] - d2.y);
        const int word = swizzled_word(warp * 16 + lane / 4 + 8 * i, e, lane);
        p_s[word] = pack_bf16(x[e], x[e + 1]);
        ds_s[word] = pack_bf16(ds0, ds1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(kBarWg0);
      bar_arrive(kBarP);
    };
    // warpgroup 1: dP^T to shared memory in its register order
    auto put = [&](const float (&x)[32]) {
#pragma unroll
      for (int e = 0; e < 32; ++e) x_s[e * 128 + tid] = x[e];
      bar_arrive(kBarX);
    };
    if (n > 0) {
      float x[32];                               // S^T (0) or dP^T (1)
      {
        const int s = g % S;
        mbar_wait(full + 8 * s, (g / S) & 1);
        wgmma_fence();
        scores(x, s);
        wgmma_wait<0>();
        pin(x);
      }
      if (wgi == 0) {
        for (int j = 0; j < n - 1; ++j, ++g) {
          const int s = g % S;
          form(x, s, w.p0 + j);
          const int s2 = (g + 1) % S;
          mbar_wait(full + 8 * s2, ((g + 1) / S) & 1);
          wgmma_fence();
          grads(s);
          scores(x, s2);
          wgmma_wait<0>();
          pin(x);
          pin(dk);
          pin(dv);
          release(s);
        }
        const int s = g % S;
        form(x, s, w.p1 - 1);
        wgmma_fence();
        grads(s);
        wgmma_wait<0>();
        pin(dk);
        pin(dv);
        release(s);
        ++g;
      } else {
        for (int j = 0; j < n - 1; ++j, ++g) {
          const int s = g % S;
          put(x);
          const int s2 = (g + 1) % S;
          mbar_wait(full + 8 * s2, ((g + 1) / S) & 1);
          wgmma_fence();
          scores(x, s2);
          bar_sync(kBarP);                       // P^T and dS^T are in
          grads(s);
          wgmma_wait<0>();
          pin(x);
          pin(dk);
          pin(dv);
          bar_arrive(kBarFree);
          release(s);
        }
        const int s = g % S;
        put(x);
        bar_sync(kBarP);
        wgmma_fence();
        grads(s);
        wgmma_wait<0>();
        pin(dk);
        pin(dv);
        bar_arrive(kBarFree);
        release(s);
        ++g;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty);        // K and V are read

    if (splits == 1) {
      __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk) + w.b * st[18] +
                           w.hk * st[19] + 128 * wgi;
      __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv) + w.b * st[21] +
                           w.hk * st[22] + 128 * wgi;
      store_rows<128>(dkg, st[20], dk, key0, cq, a.Skv, a.scale);
      store_rows<128>(dvg, st[23], dv, key0, cq, a.Skv, 1.0f);
    } else {
      const long long skv_pad = (a.Skv + kN - 1) / kN * kN;
      float* pk = part +
                  (static_cast<long long>(w.c) * n_bkv + w.bkv) * skv_pad *
                      512 + 128 * wgi;
      store_rows_f32<128>(pk, 512, dk, key0, cq, a.Skv);
      store_rows_f32<128>(pk + 256, 512, dv, key0, cq, a.Skv);
    }
  }
  if (wgi == 0 && n_done > 0) bar_sync(kBarFree);  // 1's last arrival
}

// dK and dV of the D 256 pass from its splits' f32 sums, added in split
// order (no atomics: bit-equal twice), dK times the scale, to bf16: a
// thread 4 columns of one key's dK | dV row
__global__ void __launch_bounds__(256)
dkdv_sum_kernel(const Args a, const float* part, int n_bkv, int splits) {
  const int kv = a.H / a.G;
  const long long skv_pad = (a.Skv + 63) / 64 * 64;
  const long long n = static_cast<long long>(n_bkv) * a.Skv * 128;
  const long long* st = a.st;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * 256) {
    const int c4 = static_cast<int>(i % 128) * 4;
    const long long rk = i / 128;
    const int key = static_cast<int>(rk % a.Skv);
    const int bkv = static_cast<int>(rk / a.Skv);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = 0; c < splits; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(
          part + ((static_cast<long long>(c) * n_bkv + bkv) * skv_pad + key) *
                     512 + c4);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const long long b = bkv / kv;
    const long long hk = bkv % kv;
    __nv_bfloat16* out;
    float mul = 1.0f;
    if (c4 < 256) {
      out = static_cast<__nv_bfloat16*>(a.dk) + b * st[18] + hk * st[19] +
            key * st[20] + c4;
      mul = a.scale;
    } else {
      out = static_cast<__nv_bfloat16*>(a.dv) + b * st[21] + hk * st[22] +
            key * st[23] + c4 - 256;
    }
    *reinterpret_cast<uint2*>(out) = make_uint2(
        pack_bf16(acc.x * mul, acc.y * mul), pack_bf16(acc.z * mul,
                                                       acc.w * mul));
  }
}

}  // namespace wgb

// --------------------------------------------------------------- launch ---

template <int D>
int launch_wgmma(const Args& a, int B, int splits, cudaStream_t stream) {
  using LQ = wgb::DqLayout<D>;
  using LK = wgb::KvLayout<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long* st = a.st;
  const int Kv = a.H / a.G;
  // Q and dO as the dQ pass's resident tiles (kM rows) and as the dK/dV
  // pass's ring tiles (64 rows); K and V as the dQ pass's ring tiles (64
  // keys) and the dK/dV pass's resident tiles (128 keys, 64 at D 256)
  CUtensorMap q_res, do_res, k_ring, v_ring, q_ring, do_ring, k_res, v_res;
  const bool ok =
      encode(fn, &q_res, a.q, D, a.H, a.Sq, B, st[1], st[2], st[0],
             LQ::kM) &&
      encode(fn, &do_res, a.dout, D, a.H, a.Sq, B, st[13], st[14], st[12],
             LQ::kM) &&
      encode(fn, &k_ring, a.k, D, Kv, a.Skv, B, st[4], st[5], st[3],
             LQ::kN) &&
      encode(fn, &v_ring, a.v, D, Kv, a.Skv, B, st[7], st[8], st[6],
             LQ::kN) &&
      encode(fn, &q_ring, a.q, D, a.H, a.Sq, B, st[1], st[2], st[0],
             LK::kM) &&
      encode(fn, &do_ring, a.dout, D, a.H, a.Sq, B, st[13], st[14], st[12],
             LK::kM) &&
      encode(fn, &k_res, a.k, D, Kv, a.Skv, B, st[4], st[5], st[3],
             LK::kN) &&
      encode(fn, &v_res, a.v, D, Kv, a.Skv, B, st[7], st[8], st[6], LK::kN);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // two instantiations: the band's masks only where a launch has one, so
  // a causal launch runs the code it ran before the window
  const auto dq_kernel = [&] {
    if constexpr (D == 256) {
      return a.window > 0 ? wgb::bwd_dq_d256_kernel<true>
                          : wgb::bwd_dq_d256_kernel<false>;
    } else {
      return a.window > 0 ? wgb::bwd_dq_wgmma_kernel<D, true>
                          : wgb::bwd_dq_wgmma_kernel<D, false>;
    }
  }();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bh = B * a.H;
  const long long q_tiles =
      static_cast<long long>(n_bh) * ((a.Sq + LQ::kM - 1) / LQ::kM);
  const int n_bkv = B * Kv;
  const long long kv_tiles = static_cast<long long>(n_bkv) *
                             ((a.Skv + LK::kN - 1) / LK::kN) * splits;
  if (q_tiles > 0x7fffffff || kv_tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid_q = static_cast<int>(q_tiles < sms ? q_tiles : sms);
  const int grid_kv = static_cast<int>(kv_tiles < sms ? kv_tiles : sms);
  if constexpr (D == 256) {
    const auto kv_kernel = a.window > 0 ? wgb::bwd_dkdv_d256_kernel<true>
                                        : wgb::bwd_dkdv_d256_kernel<false>;
    err = cudaFuncSetAttribute(kv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LK::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_kernel<<<grid_q, LQ::kThreads, LQ::kBytes, stream>>>(
        q_res, do_res, k_ring, v_ring, a, n_bh, static_cast<int>(q_tiles));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // the splits' sums after the scratch's lse log2(e) and delta
    float* part = a.delta + 2 * a.n_bhp;
    kv_kernel<<<grid_kv, LK::kThreads, LK::kBytes, stream>>>(
        q_ring, do_ring, k_res, v_res, a, n_bkv, static_cast<int>(kv_tiles),
        splits, part);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const long long n = static_cast<long long>(n_bkv) * a.Skv * 128;
    const long long blocks = (n + 255) / 256;
    wgb::dkdv_sum_kernel<<<static_cast<int>(
                               blocks < 8LL * sms ? blocks : 8LL * sms),
                           256, 0, stream>>>(a, part, n_bkv, splits);
    return static_cast<int>(cudaGetLastError());
  } else {
    const auto kv_kernel = a.window > 0
                               ? wgb::bwd_dkdv_wgmma_kernel<D, true>
                               : wgb::bwd_dkdv_wgmma_kernel<D, false>;
    err = cudaFuncSetAttribute(kv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LK::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_kernel<<<grid_q, LQ::kThreads, LQ::kBytes, stream>>>(
        q_res, do_res, k_ring, v_ring, a, n_bh, static_cast<int>(q_tiles));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    kv_kernel<<<grid_kv, LK::kThreads, LK::kBytes, stream>>>(
        q_ring, do_ring, k_res, v_res, a, n_bkv, static_cast<int>(kv_tiles));
    return static_cast<int>(cudaGetLastError());
  }
}

enum Variant { kWgmma, kSimt };

template <typename T>
int launch(Variant variant, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const float* lse, float* delta,
           void* dq, void* dk, void* dv, int B, int H, int G, int Sq,
           int Skv, int D, int causal, int window, int splits, float scale,
           const long long* st, cudaStream_t stream) {
  // splits > 1 only where the D 256 dK/dV pass takes them
  const bool split_ok =
      splits == 1 || (variant == kWgmma && sizeof(T) == 2 && D == 256 &&
                      splits > 1 && splits <= wgb::kMaxSplits);
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || Sq < 1 || Skv < 1 ||
      window < 0 || !split_ok ||
      (Sq + 31) / 32 > 65535 || (Skv + 31) / 32 > 65535 ||
      static_cast<long long>(B) * H > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sq_pad = (Sq + 63) / 64 * 64;
  // a window of Sq or more masks nothing: the causal launch, bit for bit
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, H, G, Sq, Skv, causal,
         sq_pad, static_cast<long long>(B) * H * sq_pad, scale, {},
         window >= Sq ? 0 : window};
  for (int i = 0; i < 24; ++i) a.st[i] = st[i];
  if (variant == kWgmma) {
    if constexpr (sizeof(T) == 2) {
      switch (D) {
        case 64: return launch_wgmma<64>(a, B, 1, stream);
        case 128: return launch_wgmma<128>(a, B, 1, stream);
        case 256: return launch_wgmma<256>(a, B, splits, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 64: return simt::launch_d<T, 64>(a, B, stream);
    case 128: return simt::launch_d<T, 128>(a, B, stream);
    case 256: return simt::launch_d<T, 256>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o, dO, lse (B, H, Sq) float32, the float32 scratch (simt: B H
// Sq floats; wgmma: 2 B H Sq_pad, Sq rounded up to 64, and at D 256 with
// splits > 1 then splits B Kv Skv_pad 2 D, Skv rounded up to 64), dq, dk,
// dv; B batches of H query heads, G query heads per kv head; window 0 or
// the band's width; splits: the CTAs that share a work tile of the D 256
// dK/dV pass (1 elsewhere); strides: (batch, head, row) of q, k, v, o,
// dO, dq, dk, dv in elements, 24 in all
#define FLASH_BWD_ENTRY(NAME, T, VARIANT)                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* o, const void* dout, const void* lse,     \
                      void* delta, void* dq, void* dk, void* dv, int B,     \
                      int H, int G, int Sq, int Skv, int D, int causal,     \
                      int window, int splits, float scale,                  \
                      const long long* strides, void* stream) {             \
    return launch<T>(VARIANT, q, k, v, o, dout,                             \
                     static_cast<const float*>(lse),                        \
                     static_cast<float*>(delta), dq, dk, dv, B, H, G, Sq,   \
                     Skv, D, causal, window, splits, scale, strides,        \
                     static_cast<cudaStream_t>(stream));                    \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_wgmma_bf16, __nv_bfloat16, kWgmma)
FLASH_BWD_ENTRY(flash_attention_bwd_simt_bf16, __nv_bfloat16, kSimt)
FLASH_BWD_ENTRY(flash_attention_bwd_simt_f32, float, kSimt)
