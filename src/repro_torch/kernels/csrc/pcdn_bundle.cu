// K1: the whole support-restricted PCDN bundle step in one launch, for
// Hopper.
//
// Replaces the Pallas kernel `pcdn_bundle_kernel` (body `_kernel`) in
// src/repro/kernels/pcdn_bundle.py, the XLA selection epilogue that
// follows it there, and the gathers and updates around it in the support
// scope of `make_bundle_step` (the slab gather, the row support's sorts,
// the z/y gathers at the support, the w and z scatters). One bundle idx
// (P,) goes in, with the design's padded-CSC columns (n, K), z, y, w and
// the Q Armijo candidates; w and z come out updated in place:
//
//   g, h     = sum_k c phi'(z_r) x, sum_k c phi''(z_r) x^2 over each column
//              (+ l2 fold, floor);  d = Eq. 5;  Delta = Eq. 7 decrement
//   delta_R  = X_B d at the bundle's rows
//   f_q      = c sum_r [phi(z_r + a_q delta_r) - phi(z_r)]
//              + ||w + a_q d||_1 - ||w||_1 (+ elastic-net part)
//   alpha    = the first a_q with f_q <= sigma a_q Delta, else 0
//   w[idx] += alpha d;  z[rows] += alpha delta_R
//   n_steps[t] = first + 1 (1 when none passes);  alpha[t] = alpha
//
// Bound on the H100: latency. At P = 32, K = 278 the step moves about 0.2
// MB and does a few million flops -- well under a microsecond of either --
// while the old design paid three launches, a memset and the gaps between
// them, and the step around it ~40 more device ops (two radix sorts among
// them) and ~1 ms of host time a bundle. What is left is a chain of
// dependent memory round trips and barriers.
// Design: one launch of one thread-block cluster (up to 8 CTAs of 512
// threads; fewer CTAs measured slower), in phases:
//   1. columns, support, direction, delta_R: groups of warps take the
//      bundle's features, a column split over a group's warps (common.cuh
//      load_round: all of a round's loads at once). Every live entry
//      claims its row in an (s,) slot map with atomicCAS (-1 between
//      bundles): the row's first entry owns it, and the slot is that
//      entry's own (slot i of entry i), where it writes the row, z and y.
//      This replaces both sorts with O(P K) work at any s; the slot order
//      is free, as the kernel returns no support. The warps' g/h partials
//      meet in shared memory in a fixed order; one thread a feature applies
//      the fold, the floor and Eq. 5 and adds its terms of Delta; then the
//      group adds x d into each entry's slot (atomicAdd; slot delta is 0
//      between bundles, so no entry waits for its row's owner).
//   2. one cluster barrier, after each CTA has pushed its Delta terms into
//      every CTA's shared memory (distributed shared memory; a split
//      barrier arrived at the start makes sure every CTA has started).
//   3. the candidates, a chunk at a time: each CTA scans its share of the
//      R slots, kept in registers (slots that are not live or have delta
//      0 add exactly 0), and the l1/l2 terms of its own features, and
//      pushes its partials into every CTA; after the chunk's barrier each
//      CTA's thread 0 adds them in rank order, so every CTA reaches the
//      same decision, and the search stops at the first chunk that holds a
//      passing candidate. No CTA touches another's shared memory after
//      that barrier, so none waits for the others to finish.
//   4. apply: w at the CTA's features, z at its live slots (each row owns
//      one slot: no races), the map, slot rows and slot deltas back to
//      -1/-1/0, n_steps[t] and alpha[t].
// The workspace (the map and the R = P K slots) is allocated and filled
// once per outer iteration by the caller; the kernel writes every slot it
// reads and leaves the workspace as it found it. The atomics sum a row's
// entries in a run-dependent order, so delta_R and the f_q may differ
// from the plain version in the last bits, which the stated tolerances
// cover.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace pcdn;

// mirrored field for field by kernels/ops.py (_BundleArgs); outside the
// anonymous namespace, so the extern "C" launchers that take it keep
// external linkage
struct BundleArgs {
  const int* col_rows;   // (n, K) int32, sentinel s at padding
  const void* col_vals;  // (n, K) float32 or bfloat16
  float* z;              // (s,) margins, updated in place
  const float* y;        // (s,) labels
  float* w;              // (n,) weights, updated in place
  const float* alphas;   // (Q,) candidates, descending
  int* n_steps;          // (b,) outputs, written at t
  float* alpha;          // (b,)
  int* ws;               // workspace, layout in `Workspace`
  float c, l2, sigma, gamma;
  int kind, n, K, s, P, Q, cluster, nseg;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 64;
// candidates a chunk of the search: the support solve accepts the first
// candidate in nearly every bundle, and chunks of 1 and 2 measured the same
constexpr int kChunk = 2;
constexpr int kMaxCluster = 8;
constexpr int kTerms = 5;  // sum g d, sum h d^2, |w + d|_1, |w|_1, |w|^2
// slots a thread keeps in registers from the search to the update
constexpr int kKeep = 3;

// int32 map[s] and slot row[R]: -1 between bundles; float slot
// delta[R]: 0 between bundles; then each entry's slot, the slots' z and y
// (R each), and the bundle's w_B, d (P each). Slot i belongs to entry i:
// a slot is live when its entry owns its row (row >= 0).
struct Workspace {
  int* map;
  int* slot_row;
  float* slot_d;
  int* epos;
  float* slot_z;
  float* slot_y;
  float* w_B;
  float* d;

  __device__ explicit Workspace(const BundleArgs& a) {
    const size_t R = static_cast<size_t>(a.P) * a.K;
    map = a.ws;
    slot_row = map + a.s;
    slot_d = reinterpret_cast<float*>(slot_row + R);
    epos = reinterpret_cast<int*>(slot_d + R);
    slot_z = reinterpret_cast<float*>(epos + R);
    slot_y = slot_z + R;
    w_B = slot_y + R;
    d = w_B + a.P;
  }
};

// the split cluster barrier: arrive at the start, wait before the first
// access to another CTA's shared memory (every CTA has started by then)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bundle_step_kernel(const BundleArgs a, const int* __restrict__ idx, int t) {
  __shared__ float s_part_g[kWarps];
  __shared__ float s_part_h[kWarps];
  __shared__ float s_d[kWarps];                 // a round's d, by group
  __shared__ float s_group_terms[kWarps][kTerms];
  __shared__ float s_cta_terms[kTerms];
  // written by every CTA of the cluster (distributed shared memory):
  // each CTA's Delta terms, and each CTA's partials of a chunk
  __shared__ float s_terms[kMaxCluster][kTerms];
  __shared__ float s_parts[2][kMaxCluster][3 * kChunk];
  __shared__ float s_red[kWarps][3 * kChunk];
  __shared__ int s_first;
  __shared__ float s_alpha;

  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nc = a.cluster;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int P = a.P;
  const int K = a.K;
  const Workspace ws(a);
  const T* col_vals = static_cast<const T*>(a.col_vals);

  // feature groups of nseg warps; a feature's column is split over its
  // group, and feature j goes to group j % G in round j / G
  const int nseg = a.nseg;
  const int gpc = kWarps / nseg;  // groups a CTA
  const int G = nc * gpc;
  const int rounds = (P + G - 1) / G;
  const int grp = warp / nseg;
  const int seg = warp % nseg;
  const int seg_len = (K + nseg - 1) / nseg;
  const int k0 = min(K, seg * seg_len);
  const int k1 = min(K, k0 + seg_len);
  const bool leader = seg == 0 && lane == 0;

  // -- phase 1: columns, slots, g/h, d, and delta_R --------------------------
  float terms[kTerms] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int rd = 0; rd < rounds; ++rd) {
    const int j = rd * G + rank * gpc + grp;
    const int col = (j < P) ? idx[j] : a.n;
    const bool live_col = col >= 0 && col < a.n;
    const float wj = (live_col && leader) ? a.w[col] : 0.0f;
    const int* rows = a.col_rows + static_cast<size_t>(col) * K;
    const T* vals = col_vals + static_cast<size_t>(col) * K;
    // the first round of the segment stays in registers for the scatter
    int first_slot[kUnroll];
    float first_x[kUnroll];
    float acc_g = 0.0f;
    float acc_h = 0.0f;
    if (live_col) {
      for (int b = k0; b < k1; b += 32 * kUnroll) {
        SegmentRound sr;
        load_round(sr, rows, vals, b, k1, a.z, a.y, a.s);
        int owner[kUnroll];
#pragma unroll
        for (int e = 0; e < kUnroll; ++e) {
          const int eid = j * K + b + e * 32 + lane;
          owner[e] = (sr.row[e] >= 0)
                         ? atomicCAS(&ws.map[sr.row[e]], -1, eid) : 0;
        }
        accumulate_round(sr, a.c, a.kind, acc_g, acc_h);
#pragma unroll
        for (int e = 0; e < kUnroll; ++e) {
          const int eid = j * K + b + e * 32 + lane;
          // the row's first entry owns the slot
          const bool owns = sr.row[e] >= 0 && owner[e] == -1;
          if (owns) {
            ws.slot_row[eid] = sr.row[e];
            ws.slot_z[eid] = sr.z[e];
            ws.slot_y[eid] = sr.y[e];
          }
          const int slot = (sr.row[e] < 0) ? -1 : (owns ? eid : owner[e]);
          if (b == k0) {
            first_slot[e] = slot;
            first_x[e] = sr.x[e];
          } else if (slot >= 0) {
            ws.epos[eid] = slot;
          }
        }
      }
    }
    acc_g = warp_sum(acc_g);
    acc_h = warp_sum(acc_h);
    if (lane == 0) {
      s_part_g[warp] = acc_g;
      s_part_h[warp] = acc_h;
    }
    __syncthreads();
    if (leader && j < P) {
      float g_raw = 0.0f;
      float h_raw = 0.0f;
      for (int i = 0; i < nseg; ++i) {  // the segments in column order
        g_raw += s_part_g[warp + i];
        h_raw += s_part_h[warp + i];
      }
      float g, h;
      const float dj = fold_direction(g_raw, h_raw, wj, a.l2, g, h);
      ws.w_B[j] = wj;
      ws.d[j] = dj;
      s_d[grp] = dj;
      terms[0] += g * dj;
      terms[1] += h * (dj * dj);
      terms[2] += fabsf(wj + dj);
      terms[3] += fabsf(wj);
      terms[4] += wj * wj;
    }
    __syncthreads();
    // delta_R: each live entry adds x d into its row's slot (0 between
    // bundles, so no slot waits for its owner)
    if (live_col) {
      const float dj = s_d[grp];
      for (int b = k0; b < k1; b += 32 * kUnroll) {
#pragma unroll
        for (int e = 0; e < kUnroll; ++e) {
          const int k = b + e * 32 + lane;
          if (b == k0) {
            if (first_slot[e] >= 0) {
              atomicAdd(&ws.slot_d[first_slot[e]], first_x[e] * dj);
            }
          } else if (k < k1) {
            const int r = rows[k];
            if (r >= 0 && r < a.s) {
              atomicAdd(&ws.slot_d[ws.epos[j * K + k]],
                        to_float(vals[k]) * dj);
            }
          }
        }
      }
    }
  }
  if (leader) {
#pragma unroll
    for (int i = 0; i < kTerms; ++i) s_group_terms[grp][i] = terms[i];
  }
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float sum = 0.0f;
    for (int gi = 0; gi < gpc; ++gi) sum += s_group_terms[gi][threadIdx.x];
    s_cta_terms[threadIdx.x] = sum;
  }
  __syncthreads();
  cluster_wait();  // every CTA has started: its shared memory may be written
  if (threadIdx.x < nc * kTerms) {  // this CTA's terms, to every CTA
    const int r = threadIdx.x / kTerms;
    const int i = threadIdx.x % kTerms;
    cluster.map_shared_rank(&s_terms[0][0], r)[rank * kTerms + i] =
        s_cta_terms[i];
  }
  __threadfence();  // the slots and delta_R, to every CTA
  cluster.sync();

  // -- phase 3: the candidates, a chunk at a time --------------------------
  // this CTA's share of the R slots (and of its features) in registers,
  // all loads at once; a slot is live when its row is >= 0
  const int R = P * K;
  const int stride = nc * kThreads;
  const int i0 = rank * kThreads + threadIdx.x;
  int k_row[kKeep];
  float k_z[kKeep];
  float k_y[kKeep];
  float k_d[kKeep];
  float k_p0[kKeep];
#pragma unroll
  for (int e = 0; e < kKeep; ++e) {
    const int i = i0 + e * stride;
    const bool in = i < R;
    k_row[e] = in ? __ldcg(&ws.slot_row[i]) : -1;
    k_z[e] = in ? __ldcg(&ws.slot_z[i]) : 0.0f;
    k_y[e] = in ? __ldcg(&ws.slot_y[i]) : 1.0f;
    k_d[e] = in ? __ldcg(&ws.slot_d[i]) : 0.0f;
  }
  const int n_own = rounds * gpc;  // this CTA's feature slots
  const int f_j = (threadIdx.x < n_own)
                      ? (threadIdx.x / gpc) * G + rank * gpc + threadIdx.x % gpc
                      : P;
  const int f_col = (f_j < P) ? idx[f_j] : a.n;
  const float f_w = (f_j < P) ? ws.w_B[f_j] : 0.0f;
  const float f_d = (f_j < P) ? ws.d[f_j] : 0.0f;
#pragma unroll
  for (int e = 0; e < kKeep; ++e) {
    // slots that are not live, or whose delta is 0, add exactly 0
    if (k_row[e] < 0) k_d[e] = 0.0f;
    k_p0[e] = (k_d[e] != 0.0f) ? phi(a.kind, k_z[e], k_y[e]) : 0.0f;
  }
  float Delta = 0.0f;
  float l1_old = 0.0f;
  float sq_old = 0.0f;
  if (threadIdx.x == 0) {
    float tot[kTerms] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < nc; ++r) {  // rank order: the same sums everywhere
#pragma unroll
      for (int i = 0; i < kTerms; ++i) tot[i] += s_terms[r][i];
    }
    Delta = tot[0] + a.gamma * tot[1] + tot[2] - tot[3];
    l1_old = tot[3];
    sq_old = tot[4];
  }
  int first = -1;
  int buf = 0;
  for (int q0 = 0; q0 < a.Q; q0 += kChunk, buf ^= 1) {
    const int qn = min(kChunk, a.Q - q0);  // the last chunk may be short
    float al[kChunk];
    float lo[kChunk];
    float l1[kChunk];
    float sq[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      al[q] = (q < qn) ? a.alphas[q0 + q] : 0.0f;
      lo[q] = l1[q] = sq[q] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kKeep; ++e) {
      if (k_d[e] == 0.0f) continue;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (q < qn) {
          const float zq = __fadd_rn(k_z[e], __fmul_rn(al[q], k_d[e]));
          lo[q] += phi(a.kind, zq, k_y[e]) - k_p0[e];
        }
      }
    }
    for (int i = i0 + kKeep * stride; i < R; i += stride) {
      if (__ldcg(&ws.slot_row[i]) < 0) continue;
      const float dr = __ldcg(&ws.slot_d[i]);
      if (dr == 0.0f) continue;
      const float zr = __ldcg(&ws.slot_z[i]);
      const float yr = __ldcg(&ws.slot_y[i]);
      const float p0 = phi(a.kind, zr, yr);
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (q < qn) {
          const float zq = __fadd_rn(zr, __fmul_rn(al[q], dr));
          lo[q] += phi(a.kind, zq, yr) - p0;
        }
      }
    }
    for (int i = threadIdx.x; i < n_own; i += kThreads) {
      const int j = (i / gpc) * G + rank * gpc + i % gpc;
      if (j >= P) continue;
      const float wj = (i == threadIdx.x) ? f_w : ws.w_B[j];
      const float dj = (i == threadIdx.x) ? f_d : ws.d[j];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (q < qn) {
          const float wq = __fadd_rn(wj, __fmul_rn(al[q], dj));
          l1[q] += fabsf(wq);
          sq[q] += wq * wq;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (q < qn) {  // qn is the same in every thread
        const float v_lo = warp_sum(lo[q]);
        const float v_l1 = warp_sum(l1[q]);
        const float v_sq = warp_sum(sq[q]);
        if (lane == 0) {
          s_red[warp][q] = v_lo;
          s_red[warp][kChunk + q] = v_l1;
          s_red[warp][2 * kChunk + q] = v_sq;
        }
      }
    }
    __syncthreads();
    // this CTA's partials, summed over its warps in order, to every CTA
    if (threadIdx.x < nc * 3 * kChunk) {
      const int r = threadIdx.x / (3 * kChunk);
      const int i = threadIdx.x % (3 * kChunk);
      if (i % kChunk < qn) {
        float sum = 0.0f;
        for (int wi = 0; wi < kWarps; ++wi) sum += s_red[wi][i];
        cluster.map_shared_rank(&s_parts[buf][0][0], r)
            [rank * 3 * kChunk + i] = sum;
      }
    }
    cluster.sync();  // every CTA's partials of this chunk, here
    if (threadIdx.x == 0) {
      int found = -1;
      for (int q = 0; q < qn && found < 0; ++q) {
        float s_lo = 0.0f;
        float s_l1 = 0.0f;
        float s_sq = 0.0f;
        for (int r = 0; r < nc; ++r) {  // rank order
          s_lo += s_parts[buf][r][q];
          s_l1 += s_parts[buf][r][kChunk + q];
          s_sq += s_parts[buf][r][2 * kChunk + q];
        }
        // the plain version's order: (c lo + l1) - l1_old (+ l2 part)
        float f = __fadd_rn(__fmul_rn(a.c, s_lo), s_l1) - l1_old;
        if (a.l2 != 0.0f) f += 0.5f * a.l2 * (s_sq - sq_old);
        if (f <= __fmul_rn(a.sigma, al[q]) * Delta) {
          found = q0 + q;
          s_alpha = al[q];
        }
      }
      s_first = found;
    }
    __syncthreads();
    first = s_first;
    if (first >= 0) break;  // the same decision in every CTA
  }
  const float alpha = (first >= 0) ? s_alpha : 0.0f;
  // no CTA touches another's shared memory after the last chunk's barrier,
  // so each may finish on its own

  // -- phase 4: apply ------------------------------------------------------
  // w at this CTA's features (w_B is w as phase 1 read it), z at its live
  // slots (each row owns one slot: no races), and the workspace back to
  // how the bundle found it
  if (f_j < P && f_col >= 0 && f_col < a.n) {
    a.w[f_col] = __fadd_rn(f_w, __fmul_rn(alpha, f_d));
  }
  for (int i = threadIdx.x + kThreads; i < n_own; i += kThreads) {
    const int j = (i / gpc) * G + rank * gpc + i % gpc;
    if (j >= P) continue;
    const int col = idx[j];
    if (col >= 0 && col < a.n) {
      a.w[col] = __fadd_rn(ws.w_B[j], __fmul_rn(alpha, ws.d[j]));
    }
  }
#pragma unroll
  for (int e = 0; e < kKeep; ++e) {
    if (k_row[e] < 0) continue;
    const int i = i0 + e * stride;
    a.z[k_row[e]] = __fadd_rn(k_z[e], __fmul_rn(alpha, k_d[e]));
    ws.map[k_row[e]] = -1;
    ws.slot_row[i] = -1;
    ws.slot_d[i] = 0.0f;
  }
  for (int i = i0 + kKeep * stride; i < R; i += stride) {
    const int row = __ldcg(&ws.slot_row[i]);
    if (row < 0) continue;
    a.z[row] = __fadd_rn(__ldcg(&ws.slot_z[i]),
                         __fmul_rn(alpha, __ldcg(&ws.slot_d[i])));
    ws.map[row] = -1;
    ws.slot_row[i] = -1;
    ws.slot_d[i] = 0.0f;
  }
  if (rank == 0 && threadIdx.x == 0) {
    a.n_steps[t] = (first >= 0 ? first : 0) + 1;
    a.alpha[t] = alpha;
  }
}

template <typename T>
int launch(const BundleArgs* a, const int* idx, int t, cudaStream_t stream) {
  if (a->Q < 1 || a->Q > kMaxQ || a->cluster < 1 || a->cluster > kMaxCluster || a->nseg < 1 ||
      kWarps % a->nseg != 0 || a->P < 1 || a->K < 1 || a->s < 1 ||
      a->n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a->cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a->cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, bundle_step_kernel<T>, *a, idx,
                                       t);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// launch constants, read once by kernels/build.py and checked against the
// plan in kernels/ops.py
extern "C" int pcdn_bundle_max_q() { return kMaxQ; }
extern "C" int pcdn_bundle_chunk() { return kChunk; }
extern "C" int pcdn_bundle_max_cluster() { return kMaxCluster; }
extern "C" int pcdn_bundle_threads() { return kThreads; }
extern "C" int pcdn_bundle_args_size() {
  return static_cast<int>(sizeof(BundleArgs));
}

extern "C" int pcdn_bundle_f32(const BundleArgs* a, const int* idx, int t,
                               void* stream) {
  return launch<float>(a, idx, t, static_cast<cudaStream_t>(stream));
}

extern "C" int pcdn_bundle_bf16(const BundleArgs* a, const int* idx, int t,
                                void* stream) {
  return launch<__nv_bfloat16>(a, idx, t, static_cast<cudaStream_t>(stream));
}
