// K5, dense batch entry: one whole SCDN batch on the dense layout, for
// Hopper.
//
// Replaces, on SCDN's dense path, the Pallas kernel `pcdn_linesearch_kernel`
// (body `_kernel`) in src/repro/kernels/pcdn_linesearch.py as `jax.vmap`
// runs it over a batch's P_bar racing line searches, and the work around it
// in the reference's `one_batch` (src/repro/core/scdn.py): the slab gather,
// u and v over all samples, g/h, the Eq. 5 directions, the (P, s)
// per-coordinate deltas, and the w and z updates. For a batch idx (P,)
// (duplicates allowed: SCDN draws with replacement; the sentinel n adds
// nothing), every slot reading the same w and z:
//
//   g_p, h_p = sum_i c phi'(z_i) x_ij, sum_i c phi''(z_i) x_ij^2
//              (j = idx[p]; the l2 fold, the Hessian floor)
//   d_p      = Eq. 5;  Delta_p = g d + gamma h d^2 + |w_j + d| - |w_j|
//   L_pq     = c sum_i [phi(z_i + a_q d_p x_ij) - phi(z_i)]
//              + |w_j + a_q d_p| - |w_j|
//   alpha_p  = the first a_q with L_pq <= sigma a_q Delta_p, else 0
//   w[j]    += alpha_p d_p        (every duplicate slot adds, slot order)
//   z_i     += sum_p alpha_p d_p x_ij
//
// Bound on the H100: bytes, by a little. At gisette's batch (P 64, s
// 6,000, 99% of X nonzero) the columns are 1.5 MB (0.46 us of HBM); the
// losses the search needs (the candidates up to the accepted one, mostly
// the first) and the g/h loss factors are ~9M operations (0.13 us at 67
// TFLOP/s, a transcendental counted as one). The batch has no matrix
// product to give the tensor cores: g, h and X_B (alpha d) are
// matrix-vector products and the search is transcendental, so it all runs
// on the CUDA cores. phi is expf (MUFU.EX2 and a range reduction) and
// log1pf, which compiles to a polynomial chain (cuobjdump -sass on sm_90a:
// MUFU.EX2 and MUFU.RCP only, no MUFU.LG2); the kernel is latency-bound on
// its staging, its cluster barriers and a pass's chain of losses a thread.
// Design: two launches.
//   1. Clusters of `cluster` CTAs, one cluster a coordinate (cluster c
//      takes coordinates c, c + clusters, ... in turn); CTA rank r of it
//      owns rows [r sl, (r + 1) sl) of the samples. The plan sizes the
//      cluster so that P x cluster fills about one wave of the SMs (P 64
//      on 132 SMs: 2 CTAs a coordinate; P 8: 8). Column j is the
//      contiguous row j of the feature-major copy XT (n, s), so a CTA's
//      slice of it, of z and of y is three TMA bulk copies (cp.async.bulk)
//      into shared memory completing one mbarrier, with plain loads for a
//      head and tail that are not 16-byte aligned (s need not be a
//      multiple of 4). z and y stay resident for all of the CTA's
//      coordinates, with phi(z_i) formed once a row; a slice past shared
//      memory is streamed in tiles of kTileRows rows, staged again for
//      each pass (phi(z_i) then formed in the pass). Each CTA sums u x and
//      v x^2 over its rows (rows with x = 0 add exactly 0 and are
//      skipped): warp shuffles, warps in order, then the cluster's CTAs in
//      rank order over distributed shared memory, the same sums in every
//      CTA, so each forms the same d and Delta with no broadcast. The
//      search takes kChunk candidates a pass (a thread a row, the kChunk
//      losses from one read of the row), the pass's sums reduced the same
//      way, and stops at the first pass that holds a passing candidate
//      unless the caller asked for every candidate's loss delta (then all
//      Q; the accepted alpha is the same either way). Rank 0 writes alpha
//      and alpha d of the slot. The loss is a template argument.
//   2. z needs every coordinate's alpha d, and the coordinates live in
//      different clusters: a second, row-parallel launch (a thread a row)
//      adds sum_p alpha_p d_p x_ij over the moving slots in slot order (the
//      columns just read, from L2), and its last block writes w_j as the
//      lowest moving slot holding j, adding every slot's step in slot
//      order (as index_add_ adds). It is launched with programmatic stream
//      serialization, so its launch overlaps the first's and its blocks
//      wait (griddepcontrol.wait) for the first's results. A cooperative
//      launch with a grid barrier would need every cluster resident at
//      once, which clusters and the one-CTA-an-SM plan do not guarantee.
// No atomics on floats: the same inputs give the same bits.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace pcdn;

// mirrored field for field by kernels/ops.py (_ScdnDenseArgs); outside the
// anonymous namespace, so the extern "C" launchers that take it keep
// external linkage
struct DenseArgs {
  const float* XT;        // (n, s) feature-major design
  float* w;               // (n,) weights, updated in place (launch 2)
  float* z;               // (s,) margins, updated in place (launch 2)
  const float* y;         // (s,) labels
  const float* alphas;    // (Q,) candidates, descending
  float* step;            // (P,) each slot's alpha d, launch 1 -> launch 2
  float c, l2, sigma, gamma;
  int kind, n, s, P, Q, cluster, clusters, cpc, sl, tile, resident;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 40;
constexpr int kChunk = 8;                    // candidates a pass
constexpr int kMaxCluster = 8;
constexpr int kTileRows = 8192;              // a streamed tile's rows
constexpr int kUpdateThreads = 256;          // launch 2: a thread a row
constexpr int kUpdateBatch = 8;              // columns whose loads fly at once
constexpr int kSmemBudget = 232448 - 2048;   // the static arrays below fit

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }
// a staged array: a tile of values after at most 3 words of head room
__host__ __device__ inline long long stage_words(int tile) {
  return pad4(tile) + 4LL;
}
// x, z, y and phi(z) (ops.scdn_dense_smem_bytes)
__host__ __device__ inline long long smem_bytes(int tile) {
  return 16LL * stage_words(tile);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// where src[0, len) lands in a staged array: at buf + off, off in [0, 4)
// chosen so that the 16-byte-aligned body of src meets 16-byte-aligned
// shared memory; `head` values before the body and `body` values in it
// (a multiple of 4), the rest a tail
struct Span {
  int off, head, body;
};
__device__ __forceinline__ Span span_of(const float* src, int len) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) &
                                   3);
  const int head = min((4 - mis) & 3, len);
  const int body = ((len - head) >> 2) << 2;
  return {(4 - head) & 3, head, body};
}

struct Staged {
  const float* src;  // null: nothing to stage
  float* buf;
};

// Stage N arrays of len values each into shared memory: the bodies by bulk
// copies (TMA) issued by thread 0 and counted on `bar`, heads and tails by
// plain loads of every thread. Called by the whole CTA; returns with the
// values visible to all threads and each array's offset in off[].
template <int N>
__device__ __forceinline__ void stage(const Staged (&a)[N], int len,
                                      unsigned long long* bar,
                                      unsigned& parity, int (&off)[N]) {
  __syncthreads();  // every thread is done with the buffers' last contents
  Span sp[N];
  unsigned bytes = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sp[k] = a[k].src != nullptr ? span_of(a[k].src, len) : Span{0, 0, 0};
    off[k] = sp[k].off;
    bytes += 4u * static_cast<unsigned>(sp[k].body);
  }
  if (threadIdx.x == 0) {
    // the generic-proxy reads of the buffers before the async-proxy writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (sp[k].body > 0) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];" ::"r"(
                smem_addr(a[k].buf + sp[k].off + sp[k].head)),
            "l"(a[k].src + sp[k].head), "r"(4u * sp[k].body),
            "r"(smem_addr(bar))
            : "memory");
      }
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (a[k].src == nullptr) continue;
    const int edge = len - sp[k].body;  // head + tail
    for (int i = threadIdx.x; i < edge; i += kThreads) {
      const int e = i < sp[k].head ? i : i + sp[k].body;
      a[k].buf[sp[k].off + e] = a[k].src[e];
    }
  }
  bar_wait(bar, parity);
  parity ^= 1u;
  __syncthreads();  // the plain loads are visible
}

// KIND: the loss (common.cuh's numbering), fixed at compile time so that
// phi's branches fold away in the search's inner loop
template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
scdn_dense_batch_kernel(const DenseArgs a, const int* __restrict__ idx,
                        float* __restrict__ alpha_out,
                        float* __restrict__ loss_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_alpha[kMaxQ];
  __shared__ float s_red[kWarps][kChunk];
  __shared__ float s_gh[2][2];       // this CTA's g, h: coordinate parity
  __shared__ float s_lo[2][kChunk];  // this CTA's pass sums: pass parity
  __shared__ float s_dD[2];          // d, Delta
  __shared__ int s_first[2];         // by pass parity
  __shared__ __align__(8) unsigned long long s_bar;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = a.cluster;
  const int cid = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sw = static_cast<int>(stage_words(a.tile));
  float* xs = smem;
  float* zs = xs + sw;
  float* ys = zs + sw;
  float* ps = ys + sw;  // phi(z_i, y_i) of the resident rows
  const int r_lo = min(a.s, rank * a.sl);
  const int len = min(a.sl, a.s - r_lo);
  const int n_tiles = (len + a.tile - 1) / a.tile;
  const bool resident = a.resident != 0;

  for (int q = tid; q < a.Q; q += kThreads) s_alpha[q] = a.alphas[q];
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_addr(&s_bar)),
                 "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the update launch may start now: its blocks wait for this grid's end
  // (griddepcontrol.wait), so its launch overlaps this one
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  __syncthreads();
  unsigned parity = 0u;
  int xoff = 0;
  int zoff = 0;
  int yoff = 0;
  if (resident && len > 0) {
    // z, y and phi(z) once for every coordinate, staged with the first
    // coordinate's column
    const int j0 = cid < a.P ? idx[cid] : -1;
    const Staged st[3] = {
        {a.z + r_lo, zs},
        {a.y + r_lo, ys},
        {j0 >= 0 && j0 < a.n ? a.XT + static_cast<size_t>(j0) * a.s + r_lo
                             : nullptr,
         xs}};
    int off[3];
    stage(st, len, &s_bar, parity, off);
    zoff = off[0];
    yoff = off[1];
    xoff = off[2];
    for (int i = tid; i < len; i += kThreads) {
      ps[i] = phi(KIND, zs[zoff + i], ys[yoff + i]);
    }
    __syncthreads();
  }

  int pass = 0;
  for (int lc = 0; lc < a.cpc; ++lc) {
    const int p = cid + lc * a.clusters;
    if (p >= a.P) break;  // uniform in the cluster
    const int j = idx[p];
    const bool live = j >= 0 && j < a.n;
    const float wj = live ? a.w[j] : 0.0f;
    const float* col = live ? a.XT + static_cast<size_t>(j) * a.s + r_lo
                            : nullptr;

    // -- g, h over the CTA's rows ------------------------------------------
    float acc_g = 0.0f;
    float acc_h = 0.0f;
    for (int t = 0; live && t < n_tiles; ++t) {  // live: uniform
      const int t0 = t * a.tile;
      const int tl = min(a.tile, len - t0);
      if (resident) {
        if (lc > 0) {  // the first coordinate's came with z and y
          const Staged st[1] = {{col, xs}};
          int off[1];
          stage(st, tl, &s_bar, parity, off);
          xoff = off[0];
        }
      } else {
        const Staged st[3] = {
            {col + t0, xs}, {a.z + r_lo + t0, zs}, {a.y + r_lo + t0, ys}};
        int off[3];
        stage(st, tl, &s_bar, parity, off);
        xoff = off[0];
        zoff = off[1];
        yoff = off[2];
      }
      for (int i = tid; i < tl; i += kThreads) {
        const float x = xs[xoff + i];
        if (x == 0.0f) continue;
        float u, v;
        loss_factors(KIND, a.c, zs[zoff + i], ys[yoff + i], u, v);
        acc_g += u * x;
        acc_h += v * (x * x);
      }
    }
    acc_g = warp_sum(acc_g);
    acc_h = warp_sum(acc_h);
    if (lane == 0) {
      s_red[warp][0] = acc_g;
      s_red[warp][1] = acc_h;
    }
    __syncthreads();
    if (tid == 0) {
      float g = 0.0f;
      float h = 0.0f;
      for (int i = 0; i < kWarps; ++i) {  // warp order
        g += s_red[i][0];
        h += s_red[i][1];
      }
      s_gh[lc & 1][0] = g;
      s_gh[lc & 1][1] = h;
    }
    cluster.sync();  // every CTA's partial g, h is written
    if (tid == 0) {
      float g_raw = 0.0f;
      float h_raw = 0.0f;
      for (int q = 0; q < C; ++q) {  // rank order
        const float* peer = cluster.map_shared_rank(&s_gh[lc & 1][0], q);
        g_raw += peer[0];
        h_raw += peer[1];
      }
      float g, h;
      const float d = fold_direction(g_raw, h_raw, wj, a.l2, g, h);
      // the plain version's order: g d + gamma (h d^2) + (|w + d| - |w|)
      s_dD[1] = __fadd_rn(
          __fadd_rn(__fmul_rn(g, d),
                    __fmul_rn(a.gamma, __fmul_rn(h, __fmul_rn(d, d)))),
          __fsub_rn(fabsf(__fadd_rn(wj, d)), fabsf(wj)));
      s_dD[0] = d;
    }
    __syncthreads();
    const float d = s_dD[0];
    const float Delta = s_dD[1];

    // -- the candidates, kChunk a pass -------------------------------------
    // d = 0 (the same in every CTA of the cluster) moves no margin: every
    // candidate's loss delta is 0 and no CTA needs its peers
    const bool moves = d != 0.0f;
    int first = -1;
    for (int q0 = 0, k = 0; q0 < a.Q; q0 += kChunk, ++k) {
      float tot = 0.0f;  // warp 0, lane e: candidate q0 + e's loss delta
      if (moves) {
        float al[kChunk];
        float acc[kChunk];
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          al[e] = q0 + e < a.Q ? s_alpha[q0 + e] : 0.0f;
          acc[e] = 0.0f;
        }
        for (int t = 0; t < n_tiles; ++t) {
          const int t0 = t * a.tile;
          const int tl = min(a.tile, len - t0);
          if (!resident) {
            const Staged st[3] = {{col + t0, xs},
                                  {a.z + r_lo + t0, zs},
                                  {a.y + r_lo + t0, ys}};
            int off[3];
            stage(st, tl, &s_bar, parity, off);
            xoff = off[0];
            zoff = off[1];
            yoff = off[2];
          }
          for (int i = tid; i < tl; i += kThreads) {
            const float x = xs[xoff + i];
            if (x == 0.0f) continue;
            const float zi = zs[zoff + i];
            const float yi = ys[yoff + i];
            const float p0 = resident ? ps[i] : phi(KIND, zi, yi);
            const float dx = __fmul_rn(d, x);
#pragma unroll
            for (int e = 0; e < kChunk; ++e) {
              acc[e] += phi(KIND, __fadd_rn(zi, __fmul_rn(al[e], dx)),
                            yi) - p0;
            }
          }
        }
#pragma unroll
        for (int e = 0; e < kChunk; ++e) acc[e] = warp_sum(acc[e]);
        if (lane == 0) {
#pragma unroll
          for (int e = 0; e < kChunk; ++e) s_red[warp][e] = acc[e];
        }
        __syncthreads();
        if (tid < kChunk) {
          float sum = 0.0f;
          for (int i = 0; i < kWarps; ++i) sum += s_red[i][tid];  // warps
          s_lo[pass & 1][tid] = sum;
        }
        cluster.sync();  // every CTA's pass sums are written
        if (warp == 0 && lane < kChunk) {
          for (int q = 0; q < C; ++q) {  // rank order
            tot += cluster.map_shared_rank(&s_lo[pass & 1][0], q)[lane];
          }
        }
        ++pass;
      }
      if (warp == 0) {
        bool ok = false;
        const int q = q0 + lane;
        if (lane < kChunk && q < a.Q) {
          const float aq = s_alpha[q];
          const float wq = __fadd_rn(wj, __fmul_rn(aq, d));
          // the plain version's order: c lo + (|w + a d| - |w|), against
          // (sigma a) Delta
          const float f = __fadd_rn(__fmul_rn(a.c, tot),
                                    __fsub_rn(fabsf(wq), fabsf(wj)));
          ok = f <= __fmul_rn(__fmul_rn(a.sigma, aq), Delta);
          if (loss_out != nullptr && rank == 0) {
            loss_out[static_cast<size_t>(p) * a.Q + q] = tot;
          }
        }
        const unsigned hits = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) s_first[k & 1] = hits ? q0 + __ffs(hits) - 1 : -1;
      }
      __syncthreads();
      if (first < 0) first = s_first[k & 1];
      if (first >= 0 && loss_out == nullptr) break;  // uniform
    }
    if (tid == 0 && rank == 0) {
      const float alpha = first >= 0 ? s_alpha[first] : 0.0f;
      alpha_out[p] = alpha;
      a.step[p] = __fmul_rn(alpha, d);
    }
  }
  // no CTA leaves while a peer may read its shared memory; nothing to
  // order (relaxed: no release fence to wait for the stores above)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// launch 2 (blocks 0 .. B-1, a thread a row): z_i += sum_p step_p x_ij over
// the moving slots (step != 0: a slot with step 0 adds exactly 0 and its
// column is not read) in slot order, the columns just read, from L2; each
// chunk of slots is first compacted into shared memory, in order, so that
// kUpdateBatch of its columns' loads fly at once. Block B writes each w_j
// once, by the lowest moving slot holding j, adding every moving slot's
// step in slot order (as index_add_ adds). Launched with programmatic
// stream serialization: it waits here for the batch launch's results
__global__ void __launch_bounds__(kUpdateThreads)
scdn_dense_update_kernel(const DenseArgs a, const int* __restrict__ idx) {
  __shared__ int s_j[kUpdateThreads];
  __shared__ float s_u[kUpdateThreads];
  __shared__ int s_warp[kUpdateThreads / 32];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (blockIdx.x == gridDim.x - 1) {  // w
    for (int p = tid; p < a.P; p += kUpdateThreads) {
      const int j = idx[p];
      const float u = a.step[p];
      if (u == 0.0f || j < 0 || j >= a.n) continue;
      bool owner = true;
      for (int q = 0; q < p && owner; ++q) {
        owner = !(idx[q] == j && a.step[q] != 0.0f);
      }
      if (!owner) continue;
      float wn = __fadd_rn(a.w[j], u);
      for (int q = p + 1; q < a.P; ++q) {
        const float uq = a.step[q];
        if (idx[q] == j && uq != 0.0f) wn = __fadd_rn(wn, uq);
      }
      a.w[j] = wn;
    }
    return;
  }
  const int i = blockIdx.x * kUpdateThreads + tid;
  float acc = 0.0f;
  for (int c0 = 0; c0 < a.P; c0 += kUpdateThreads) {
    const int p = c0 + tid;
    const int j = p < a.P ? idx[p] : -1;
    const float u = p < a.P ? a.step[p] : 0.0f;
    const bool moving = u != 0.0f && j >= 0 && j < a.n;
    const unsigned ball = __ballot_sync(0xffffffffu, moving);
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    int pos = __popc(ball & ((1u << lane) - 1u));
    int m = 0;
    for (int k = 0; k < kUpdateThreads / 32; ++k) {  // warps in order
      if (k < warp) pos += s_warp[k];
      m += s_warp[k];
    }
    if (moving) {
      s_j[pos] = j;
      s_u[pos] = u;
    }
    __syncthreads();
    for (int e0 = 0; i < a.s && e0 < m; e0 += kUpdateBatch) {
      float xv[kUpdateBatch];
#pragma unroll
      for (int e = 0; e < kUpdateBatch; ++e) {
        xv[e] = e0 + e < m
                    ? a.XT[static_cast<size_t>(s_j[e0 + e]) * a.s + i]
                    : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kUpdateBatch; ++e) {
        if (e0 + e < m) acc = __fadd_rn(acc, __fmul_rn(s_u[e0 + e], xv[e]));
      }
    }
    __syncthreads();  // the lists are read before the next chunk's
  }
  if (i < a.s) a.z[i] = __fadd_rn(a.z[i], acc);
}

int launch(const DenseArgs* a, const int* idx, float* alpha, float* loss,
           cudaStream_t stream) {
  const int C = a->cluster;
  if (a->P < 1 || a->Q < 1 || a->Q > kMaxQ || C < 1 || C > kMaxCluster ||
      a->clusters < 1 || a->cpc < 1 ||
      static_cast<long long>(a->clusters) * a->cpc < a->P || a->s < 1 ||
      a->n < 1 || a->sl < 1 || static_cast<long long>(a->sl) * C < a->s ||
      a->tile < 1 || a->tile > a->sl ||
      (a->resident ? a->tile != a->sl : a->tile > kTileRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bytes = smem_bytes(a->tile);
  if (bytes > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const DenseArgs, const int*, float*, float*) =
      a->kind == kLogistic       ? scdn_dense_batch_kernel<kLogistic>
      : a->kind == kSquaredHinge ? scdn_dense_batch_kernel<kSquaredHinge>
      : a->kind == kSquared      ? scdn_dense_batch_kernel<kSquared>
                                 : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a kernel must opt in, once a size and loss (per process:
  // one card)
  static long long opted[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  if (bytes > opted[a->kind]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[a->kind] = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a->clusters * C, 1, 1);
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, *a, idx, alpha, loss);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the update: the row blocks and one block for w, its launch
  // overlapping the batch launch's (programmatic stream serialization)
  cudaLaunchConfig_t up = {};
  up.gridDim = dim3((a->s + kUpdateThreads - 1) / kUpdateThreads + 1, 1, 1);
  up.blockDim = dim3(kUpdateThreads, 1, 1);
  up.stream = stream;
  cudaLaunchAttribute up_attr[1];
  up_attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  up_attr[0].val.programmaticStreamSerializationAllowed = 1;
  up.attrs = up_attr;
  up.numAttrs = 1;
  err = cudaLaunchKernelEx(&up, scdn_dense_update_kernel, *a, idx);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// launch constants, read once by kernels/build.py and checked against the
// plan in kernels/ops.py
extern "C" int scdn_dense_batch_threads() { return kThreads; }
extern "C" int scdn_dense_batch_max_q() { return kMaxQ; }
extern "C" int scdn_dense_batch_chunk() { return kChunk; }
extern "C" int scdn_dense_batch_max_cluster() { return kMaxCluster; }
extern "C" int scdn_dense_batch_tile_rows() { return kTileRows; }
extern "C" int scdn_dense_batch_smem_budget() { return kSmemBudget; }
extern "C" int scdn_dense_batch_args_size() {
  return static_cast<int>(sizeof(DenseArgs));
}

// the dynamic shared memory of a launch in bytes (-1 past 2**31), for the
// plan's check
extern "C" int scdn_dense_batch_smem_bytes(int tile) {
  const long long bytes = smem_bytes(tile);
  return bytes > 0x7fffffffLL ? -1 : static_cast<int>(bytes);
}

// idx (P,) int32; alpha (P,) out; loss (P, Q) out or null. Two launches
// on `stream`: the batch, then the w and z updates
extern "C" int scdn_dense_batch_f32(const DenseArgs* a, const int* idx,
                                    float* alpha, float* loss, void* stream) {
  return launch(a, idx, alpha, loss, static_cast<cudaStream_t>(stream));
}
