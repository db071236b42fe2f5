// K5, batch entry: one whole SCDN batch on the padded-CSC layout in one
// launch, for Hopper.
//
// Replaces, on SCDN's padded-CSC path, the Pallas kernel
// `pcdn_linesearch_kernel` (body `_kernel`) in
// src/repro/kernels/pcdn_linesearch.py as `jax.vmap` runs it over a batch's
// P_bar racing line searches, and the work around it in the reference's
// `one_batch` (src/repro/core/scdn.py): the slab gather, g/h, the Eq. 5
// directions, the (P, s) per-coordinate deltas and the w and z updates. For
// a batch idx (P,) (duplicates allowed: SCDN draws with replacement):
//
//   g_p, h_p = sum_k c phi'(z_r) x, sum_k c phi''(z_r) x^2 over column
//              j = idx[p] (+ l2 fold, floor);  d_p = Eq. 5
//   Delta_p  = g d + gamma h d^2 + |w_j + d| - |w_j|
//   delta_pr = d_p sum_{k: r_pk = r} x_pk over the column's DISTINCT rows
//   L_pq     = c sum_r [phi(z_r + a_q delta_pr) - phi(z_r)]
//              + |w_j + a_q d_p| - |w_j|
//   alpha_p  = the first a_q with L_pq <= sigma a_q Delta_p, else 0
//   then, every slot having read the same w and z:
//   w[j] += alpha_p d_p;  z[r] += alpha_p delta_pr
//
// The duplicate rows of a column must be merged before phi: phi(z + a(x1 +
// x2) d) - phi(z) is not the sum of the two one-entry terms.
// Bound on the H100: latency. A real-sim batch (P 8, k_max 278) moves the
// 8 columns' slab (17.8 KB), z and y at their live rows and the writes --
// a few ns of HBM -- and most of its coordinates have d = 0 (w_j = 0 and
// |g| <= 1), which leave z alone. The old route paid ~216 device ops a
// batch (a 1.85 MB zero-fill, an index_add_, the (8, s) scan of K5's rows
// entry in two launches); what is left here is one launch and a chain of
// dependent round trips and barriers.
// Design: one launch of one thread-block cluster, a CTA a coordinate up to
// 8 coordinates (coordinate p on CTA p % cluster, p / cluster-th in turn,
// above 8), each CTA in phases:
//   1. its column's rows and values, every z/y gather issued before any is
//      used; while they are in flight each live entry claims its row's
//      slot in an open-addressing table in shared memory (atomicCAS, at
//      least twice as many slots as entries) and records there the
//      lowest entry holding the row (atomicMin) and their count.
//   2. g/h reduced in a fixed order, d and Delta in one thread.
//   3. when d != 0: a row's lowest entry is its head; a block scan over
//      the entries in order compacts the distinct rows with x summed in
//      entry order (a row held once, nearly all, is its entry's x), z, y
//      and phi(z) there, records each row's place in its slot, and sets
//      the row's bit in the CTA's 65,536-bit map (rows hashed mod 65,536:
//      exact up to that many samples, a false hit above costs one lookup).
//      d = 0 coordinates leave z unchanged, so they publish no rows.
//      (A bitonic sort of (row, entry) keys in place of the table measured
//      within noise of it; the table has no sort stages and O(1) lookups.)
//   4. the candidates, 8 a pass: a thread owns (distinct row, candidate)
//      pairs, the 8 sums reduce once through shared memory, one warp forms
//      L with the l1 term and takes the first passing candidate (ballot);
//      the search stops at the first pass that holds one, unless the
//      caller asked for every candidate's loss delta.
//   5. one cluster barrier (every CTA has read w and z, and published its
//      rows), then the updates: a row of z is written by the lowest
//      coordinate that holds it, as z_r + sum over coordinates in index
//      order of alpha d (sum x); each row reads every peer's map word at
//      once (distributed shared memory), and only a row a peer also holds
//      (rare) is looked up in that peer's table.
//      w_j likewise, by the lowest slot holding j. A last cluster barrier,
//      relaxed (nothing to order), keeps each CTA's shared memory alive
//      while peers read it (a release there compiles to a GPU-scope fence
//      that waits for the z stores). Pushing each row's mark into every
//      peer's map before the first barrier, 7 remote atomics a row, was
//      tried in place of these reads and dropped. So was no map at all:
//      each row looked up in the tables of the peers with d != 0 (their
//      nd read once after the barrier) measured 0.8 us slower on a
//      real-sim batch with their home slots read at once, 1.8 us probed
//      in turn, and 1.9 us reading every peer's home slot instead.
// No atomics on floats: the same inputs give the same bits.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace pcdn;

// mirrored field for field by kernels/ops.py (_ScdnArgs); outside the
// anonymous namespace, so the extern "C" launchers that take it keep
// external linkage
struct ScdnArgs {
  const int* col_rows;    // (n, K) int32, sentinel s at padding
  const float* col_vals;  // (n, K) float32
  float* w;               // (n,) weights, updated in place
  float* z;               // (s,) margins, updated in place
  const float* y;         // (s,) labels
  const float* alphas;    // (Q,) candidates, descending
  float c, l2, sigma, gamma;
  int kind, n, K, s, P, Q, cluster, cpc, slots;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 40;
constexpr int kChunk = 8;                    // candidates a pass
constexpr int kRowLanes = kThreads / kChunk;
constexpr int kMaxCluster = 8;
constexpr int kBitmapWords = 2048;           // 65,536 bits
constexpr int kRound = 4;                    // entries a thread loads a round
constexpr int kEmpty = -1;                   // a free slot of the row table
constexpr int kNoEntry = 0x7fffffff;
constexpr int kSmemBudget = 232448 - 1024;   // the static arrays below fit

// dynamic shared memory, in 4-byte words (ops.scdn_batch_smem_bytes)
__host__ __device__ inline long long smem_words(int K, int slots, int cpc,
                                                int P) {
  return 2LL * slots * cpc + 2LL * slots + kBitmapWords + 6LL * K +
         3LL * K * cpc + P + 4LL * cpc;
}

// the same layout in every CTA, so a peer's arrays are map_shared_rank of
// this CTA's
struct Smem {
  int* tab_row;              // [cpc][slots] a coordinate's rows; kEmpty
  int* tab_m;                // [cpc][slots] the row's distinct-row index
  int* tab_first;            // [slots] the row's lowest entry; kNoEntry
  int* tab_cnt;              // [slots] the row's entries
  unsigned* bitmap;          // [kBitmapWords] this CTA's published rows
  int* eslot;                // [K] each entry's slot (-1: no row)
  float* ex;                 // [K] each entry's x, z, y (entry order)
  float* ez;
  float* ey;
  float* dy;                 // [K] y and phi(z, y) at the distinct rows
  float* dp0;
  int* drow;                 // [cpc][K] a coordinate's distinct rows
  float* dxs;                // [cpc][K] their x, summed in entry order
  float* dz;                 // [cpc][K] z there, as read
  int* idx;                  // [P] the batch
  int* nd;                   // [cpc] distinct rows published (0: d = 0)
  float* u;                  // [cpc] alpha d
  float* wj;                 // [cpc] w_j, as read
  float* alpha;              // [cpc] the accepted step

  __device__ Smem(unsigned char* base, int K, int slots, int cpc, int P) {
    tab_row = reinterpret_cast<int*>(base);
    tab_m = tab_row + slots * cpc;
    tab_first = tab_m + slots * cpc;
    tab_cnt = tab_first + slots;
    bitmap = reinterpret_cast<unsigned*>(tab_cnt + slots);
    eslot = reinterpret_cast<int*>(bitmap + kBitmapWords);
    ex = reinterpret_cast<float*>(eslot + K);
    ez = ex + K;
    ey = ez + K;
    dy = ey + K;
    dp0 = dy + K;
    drow = reinterpret_cast<int*>(dp0 + K);
    dxs = reinterpret_cast<float*>(drow + K * cpc);
    dz = dxs + K * cpc;
    idx = reinterpret_cast<int*>(dz + K * cpc);
    nd = idx + P;
    u = reinterpret_cast<float*>(nd + cpc);
    wj = u + cpc;
    alpha = wj + cpc;
  }
};

// a row's home slot in a table of 2^bits slots (Fibonacci hashing)
__device__ __forceinline__ int home_slot(int r, int bits) {
  return static_cast<int>((static_cast<unsigned>(r) * 0x9E3779B1u) >>
                          (32 - bits));
}

__global__ void __launch_bounds__(kThreads, 1)
scdn_batch_kernel(const ScdnArgs a, const int* __restrict__ idx_in,
                  float* __restrict__ alpha_out,
                  float* __restrict__ loss_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_alpha[kMaxQ];
  __shared__ float s_red[kWarps][kChunk];
  __shared__ float s_gh[2][kWarps];
  __shared__ int s_scan[kWarps];
  __shared__ int s_top;
  __shared__ int s_first;
  __shared__ float s_d;
  __shared__ float s_Delta;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = a.cluster;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int K = a.K;
  const int s = a.s;
  const int slots = a.slots;
  const int bits = __ffs(slots) - 1;
  Smem sm(smem_raw, K, slots, a.cpc, a.P);

  for (int i = tid; i < kBitmapWords; i += kThreads) sm.bitmap[i] = 0u;
  for (int i = tid; i < a.P; i += kThreads) sm.idx[i] = idx_in[i];
  for (int q = tid; q < a.Q; q += kThreads) s_alpha[q] = a.alphas[q];
  for (int i = tid; i < slots * a.cpc; i += kThreads) sm.tab_row[i] = kEmpty;
  for (int i = tid; i < slots; i += kThreads) {
    sm.tab_first[i] = kNoEntry;
    sm.tab_cnt[i] = 0;
  }

  for (int lc = 0; lc < a.cpc; ++lc) {
    const int p = lc * C + rank;
    if (p >= a.P) {  // uniform in the CTA
      if (tid == 0) {
        sm.nd[lc] = 0;
        sm.u[lc] = 0.0f;
        sm.wj[lc] = 0.0f;
        sm.alpha[lc] = 0.0f;
      }
      continue;
    }
    if (tid == 0) s_top = 0;
    __syncthreads();  // also: the previous coordinate is done with the temps
    const int j = sm.idx[p];
    const bool live_col = j >= 0 && j < a.n;
    float wj = 0.0f;
    if (tid == 0 && live_col) wj = a.w[j];  // used in the epilogue
    const size_t col = static_cast<size_t>(live_col ? j : 0) * K;
    int* tab = sm.tab_row + lc * slots;

    // -- 1. the column, and every gather at its rows ------------------------
    const int rounds = (K + kThreads * kRound - 1) / (kThreads * kRound);
    float lz[kRound];
    float ly[kRound];
    int lk[kRound];
    int top = 0;  // this thread's last live entry + 1
    for (int rd = 0; rd < rounds; ++rd) {
      int rr[kRound];
      float xx[kRound];
#pragma unroll
      for (int e = 0; e < kRound; ++e) {
        const int k = (rd * kRound + e) * kThreads + tid;
        const bool in = live_col && k < K;
        rr[e] = in ? a.col_rows[col + k] : -1;
        xx[e] = in ? a.col_vals[col + k] : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kRound; ++e) {
        const int k = (rd * kRound + e) * kThreads + tid;
        const bool live = rr[e] >= 0 && rr[e] < s;
        lk[e] = k;
        lz[e] = live ? a.z[rr[e]] : 0.0f;
        ly[e] = live ? a.y[rr[e]] : 1.0f;
      }
#pragma unroll
      for (int e = 0; e < kRound; ++e) {  // the gathers in flight
        const int k = lk[e];
        const int r = rr[e];
        const bool live = r >= 0 && r < s;
        if (k >= K) continue;
        sm.ex[k] = live ? xx[e] : 0.0f;
        int h = -1;
        if (live) {
          h = home_slot(r, bits);
          for (;;) {  // linear probing; at most half the slots are taken
            const int old = atomicCAS(&tab[h], kEmpty, r);
            if (old == kEmpty || old == r) break;
            h = (h + 1) & (slots - 1);
          }
          atomicMin(&sm.tab_first[h], k);
          atomicAdd(&sm.tab_cnt[h], 1);
          top = k + 1;
        }
        sm.eslot[k] = h;
      }
      if (rd + 1 < rounds) {
#pragma unroll
        for (int e = 0; e < kRound; ++e) {
          if (lk[e] < K) {
            sm.ez[lk[e]] = lz[e];
            sm.ey[lk[e]] = ly[e];
          }
        }
      }
    }
    if (top > 0) atomicMax(&s_top, top);

    // -- 2. g/h, d, Delta ----------------------------------------------------
#pragma unroll
    for (int e = 0; e < kRound; ++e) {
      if (lk[e] < K) {
        sm.ez[lk[e]] = lz[e];
        sm.ey[lk[e]] = ly[e];
      }
    }
    __syncthreads();
    const int live_top = s_top;
    float acc_g = 0.0f;
    float acc_h = 0.0f;
    for (int k = tid; k < live_top; k += kThreads) {
      const float x = sm.ex[k];
      float uf, vf;
      loss_factors(a.kind, a.c, sm.ez[k], sm.ey[k], uf, vf);
      acc_g += uf * x;
      acc_h += vf * (x * x);
    }
    acc_g = warp_sum(acc_g);
    acc_h = warp_sum(acc_h);
    if (lane == 0) {
      s_gh[0][warp] = acc_g;
      s_gh[1][warp] = acc_h;
    }
    __syncthreads();
    if (tid == 0) {
      float g_raw = 0.0f;
      float h_raw = 0.0f;
      for (int i = 0; i < kWarps; ++i) {  // warp order
        g_raw += s_gh[0][i];
        h_raw += s_gh[1][i];
      }
      float g, h;
      const float d = fold_direction(g_raw, h_raw, wj, a.l2, g, h);
      // the plain version's order: g d + gamma (h d^2) + (|w + d| - |w|)
      s_Delta = __fadd_rn(
          __fadd_rn(__fmul_rn(g, d),
                    __fmul_rn(a.gamma, __fmul_rn(h, __fmul_rn(d, d)))),
          __fsub_rn(fabsf(__fadd_rn(wj, d)), fabsf(wj)));
      s_d = d;
      sm.wj[lc] = wj;
    }
    __syncthreads();
    const float d = s_d;
    const float Delta = s_Delta;
    const float w0 = sm.wj[lc];
    int* drow = sm.drow + lc * K;
    float* dxs = sm.dxs + lc * K;
    float* dz = sm.dz + lc * K;

    // -- 3. the distinct rows (d != 0 only) ---------------------------------
    int nd = 0;
    if (d != 0.0f) {  // uniform in the CTA
      int* tab_m = sm.tab_m + lc * slots;
      for (int k0 = 0; k0 < live_top; k0 += kThreads) {
        const int k = k0 + tid;
        const int h = (k < live_top) ? sm.eslot[k] : -1;
        const bool head = h >= 0 && sm.tab_first[h] == k;
        const unsigned heads = __ballot_sync(0xffffffffu, head);
        if (lane == 0) s_scan[warp] = __popc(heads);
        __syncthreads();
        int m = nd + __popc(heads & ((1u << lane) - 1u));
        for (int i = 0; i < kWarps; ++i) {
          if (i < warp) m += s_scan[i];
          nd += s_scan[i];
        }
        if (head) {
          const int r = tab[h];
          float xs = sm.ex[k];
          // the row's later entries (a duplicate row: rare), entry order
          for (int k2 = k + 1, left = sm.tab_cnt[h] - 1; left > 0; ++k2) {
            if (sm.eslot[k2] == h) {
              xs += sm.ex[k2];
              --left;
            }
          }
          const float zr = sm.ez[k];
          const float yr = sm.ey[k];
          drow[m] = r;
          dxs[m] = xs;
          dz[m] = zr;
          sm.dy[m] = yr;
          sm.dp0[m] = phi(a.kind, zr, yr);
          tab_m[h] = m;
          atomicOr(&sm.bitmap[(r & 0xffff) >> 5], 1u << (r & 31));
        }
        __syncthreads();  // s_scan is read before the next round writes it
      }
    }
    // the temporaries back to empty for the next coordinate
    for (int k = tid; k < live_top; k += kThreads) {
      const int h = sm.eslot[k];
      if (h >= 0) {
        sm.tab_first[h] = kNoEntry;
        sm.tab_cnt[h] = 0;
      }
    }
    if (tid == 0) sm.nd[lc] = nd;

    // -- 4. the candidates, kChunk a pass ------------------------------------
    const int ql = tid % kChunk;
    int first = -1;
    for (int q0 = 0; q0 < a.Q; q0 += kChunk) {
      const float al = (q0 + ql < a.Q) ? s_alpha[q0 + ql] : 0.0f;
      float lo = 0.0f;
      for (int m = tid / kChunk; m < nd; m += kRowLanes) {
        const float zq = __fadd_rn(dz[m], __fmul_rn(al, __fmul_rn(d, dxs[m])));
        lo += phi(a.kind, zq, sm.dy[m]) - sm.dp0[m];
      }
      // the lanes of one candidate: lane, lane ^ 8, lane ^ 16, lane ^ 24
      lo += __shfl_xor_sync(0xffffffffu, lo, kChunk);
      lo += __shfl_xor_sync(0xffffffffu, lo, 2 * kChunk);
      if (lane < kChunk) s_red[warp][lane] = lo;
      __syncthreads();
      if (warp == 0) {
        bool ok = false;
        const int q = q0 + lane;
        if (lane < kChunk && q < a.Q) {
          float tot = 0.0f;
          for (int i = 0; i < kWarps; ++i) tot += s_red[i][lane];
          const float aq = s_alpha[q];
          const float wq = __fadd_rn(w0, __fmul_rn(aq, d));
          // the plain version's order: c lo + (|w + a d| - |w|), against
          // (sigma a) Delta
          const float f = __fadd_rn(__fmul_rn(a.c, tot),
                                    __fsub_rn(fabsf(wq), fabsf(w0)));
          ok = f <= __fmul_rn(__fmul_rn(a.sigma, aq), Delta);
          if (loss_out != nullptr) {
            loss_out[static_cast<size_t>(p) * a.Q + q] = tot;
          }
        }
        const unsigned hits = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) s_first = hits ? q0 + __ffs(hits) - 1 : -1;
      }
      __syncthreads();
      if (first < 0) first = s_first;
      if (first >= 0 && loss_out == nullptr) break;  // uniform
    }
    if (tid == 0) {
      const float alpha = (first >= 0) ? s_alpha[first] : 0.0f;
      sm.alpha[lc] = alpha;  // written out after the barrier: no global
      sm.u[lc] = __fmul_rn(alpha, d);  // store for its fence to wait on
    }
  }

  // -- 5. every CTA has read w and z and published its rows: update -------
  cluster.sync();
  if (tid < a.cpc && tid * C + rank < a.P) {
    const int lc = tid;
    const int p = lc * C + rank;
    const int j = sm.idx[p];
    alpha_out[p] = sm.alpha[lc];
    // w_j is written by the lowest slot holding j, adding every slot's
    // step in slot order (as index_add_ adds)
    bool owner = j >= 0 && j < a.n;
    bool later = false;
    for (int q = 0; q < a.P; ++q) {
      const int jq = sm.idx[q];
      owner = owner && !(q < p && jq == j);
      later = later || (q > p && jq == j);
    }
    if (owner) {
      float wn = __fadd_rn(sm.wj[lc], sm.u[lc]);
      for (int q = p + 1; later && q < a.P; ++q) {
        if (sm.idx[q] == j) {
          wn = __fadd_rn(wn, *cluster.map_shared_rank(sm.u + q / C, q % C));
        }
      }
      a.w[j] = wn;
    }
  }
  for (int lc = 0; lc < a.cpc; ++lc) {
    const int p = lc * C + rank;
    if (p >= a.P) break;
    const int nd = sm.nd[lc];
    const int* drow = sm.drow + lc * K;
    const float* dxs = sm.dxs + lc * K;
    const float* dz = sm.dz + lc * K;
    const float up = sm.u[lc];
    for (int m = tid; m < nd; m += kThreads) {
      const int r = drow[m];
      const int wi = (r & 0xffff) >> 5;
      const unsigned bit = 1u << (r & 31);
      unsigned words[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        words[q] = *cluster.map_shared_rank(sm.bitmap + wi, min(q, C - 1));
      }
      unsigned hits = 0u;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < C && (words[q] & bit)) hits |= 1u << q;
      }
      float acc = 0.0f;
      bool owner = true;
      // coordinate order: q = qc C + qr
      for (int qc = 0; qc < a.cpc && owner; ++qc) {
        for (int qr = 0; qr < C; ++qr) {
          const int q = qc * C + qr;
          if (q >= a.P) break;
          if (q == p) {
            acc = __fadd_rn(acc, __fmul_rn(up, dxs[m]));
            continue;
          }
          if (!((hits >> qr) & 1u)) continue;
          // q published no rows (d = 0), or its table lacks r
          if (*cluster.map_shared_rank(sm.nd + qc, qr) == 0) continue;
          const int* tab_q = cluster.map_shared_rank(
              sm.tab_row + qc * slots, qr);
          int h = home_slot(r, bits);
          int t;
          while ((t = tab_q[h]) != r && t != kEmpty) h = (h + 1) & (slots - 1);
          if (t != r) continue;
          const int lo = *cluster.map_shared_rank(
              sm.tab_m + qc * slots + h, qr);
          if (q < p) {  // a lower coordinate holds r: it writes the row
            owner = false;
            break;
          }
          acc = __fadd_rn(acc, __fmul_rn(
              *cluster.map_shared_rank(sm.u + qc, qr),
              *cluster.map_shared_rank(sm.dxs + qc * K + lo, qr)));
        }
      }
      if (owner) a.z[r] = __fadd_rn(dz[m], acc);
    }
  }
  // no CTA leaves while a peer may read its shared memory; nothing to
  // order (relaxed: no release fence to wait for the stores above)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

int launch(const ScdnArgs* a, const int* idx, float* alpha, float* loss,
           cudaStream_t stream) {
  const int C = a->cluster;
  if (a->P < 1 || a->Q < 1 || a->Q > kMaxQ || C < 1 || C > kMaxCluster ||
      a->cpc < 1 || C * a->cpc < a->P || a->K < 1 || a->slots < 2 * a->K ||
      (a->slots & (a->slots - 1)) != 0 || a->s < 1 || a->n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bytes = 4 * smem_words(a->K, a->slots, a->cpc, a->P);
  if (bytes > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a kernel must opt in, once a size (per process: one card)
  static long long opted = 48 * 1024;
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        scdn_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, scdn_batch_kernel, *a, idx, alpha, loss);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// launch constants, read once by kernels/build.py and checked against the
// plan in kernels/ops.py
extern "C" int scdn_batch_threads() { return kThreads; }
extern "C" int scdn_batch_max_q() { return kMaxQ; }
extern "C" int scdn_batch_chunk() { return kChunk; }
extern "C" int scdn_batch_max_cluster() { return kMaxCluster; }
extern "C" int scdn_batch_smem_budget() { return kSmemBudget; }
extern "C" int scdn_batch_args_size() {
  return static_cast<int>(sizeof(ScdnArgs));
}

// the dynamic shared memory of a launch in bytes (-1 past 2**31), for the
// plan's check
extern "C" int scdn_batch_smem_bytes(int K, int slots, int cpc, int P) {
  const long long bytes = 4 * smem_words(K, slots, cpc, P);
  return bytes > 0x7fffffffLL ? -1 : static_cast<int>(bytes);
}

// idx (P,) int32; alpha (P,) out; loss (P, Q) out or null
extern "C" int scdn_batch_f32(const ScdnArgs* a, const int* idx,
                              float* alpha, float* loss, void* stream) {
  return launch(a, idx, alpha, loss, static_cast<cudaStream_t>(stream));
}
