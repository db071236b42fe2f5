// K3: the PCDN bundle direction over the dense layout, with the slab
// gather, the loss factors and the margin delta inside, in one launch, for
// Hopper.
//
// Replaces the Pallas kernel `pcdn_direction_kernel` in
// src/repro/kernels/pcdn_direction.py, together with the passes that fed
// and followed it in the dense full-scope bundle step: the slab gather
// (`DenseDesign.gather_slab`: a take of the bundle's columns and a mask),
// the loss factors u, v over all samples, and the margin delta
// (`slab_matvec`, X_B d). It reads the design's feature-major copy XT
// (n, s), in which column j of X is the contiguous row XT[j]. For each
// bundle column j (idx[j] >= n: a sentinel of the ragged last bundle,
// whose column is all zero):
//
//   u_i, v_i = c phi'(z_i, y_i), c phi''(z_i, y_i)
//   g_j = sum_i u_i X_ij + l2 w_j
//   h_j = max(sum_i v_i X_ij^2 + l2, 1e-12)
//   d_j = Eq. 5 direction
//   delta_i = sum_j X_ij d_j                     (the (s,) margin delta)
//
// Bound on the H100: bytes. X_B (s * P values) is read once, with about 7
// flops a value; z and y read, delta written. At gisette's s = 6,000 and
// P = 512 that is 12.3 MB, about 3.7 us at 3.35 TB/s. The step this
// replaces moved about 130 MB a bundle: the row-major gather pulled a
// 32-byte sector for each scattered float (about 69 MB read for the 12.3
// MB slab), then wrote the slab, masked it, and read it twice more.
// Design: one launch of clusters of kCluster CTAs of kThreads threads, one
// CTA an SM, as many clusters as the card holds at once where the bundle
// allows (the plan's rule: 15 on an H100; the 16 a first plan launched ran
// in two waves). Cluster c owns `cc` consecutive bundle columns; CTA rank r
// of it owns slice r of the rows (`sl` rows, a multiple of 8), so:
//   1. every CTA forms u, v of its own rows only, and brings its rows of
//      the cluster's columns into shared memory when they fit and their
//      rows are 16-byte aligned (`resident`: gisette, 35 columns x 752
//      rows): one bulk copy (TMA, cp.async.bulk) a column segment, started
//      by a thread a column before u and v are formed, all completing one
//      mbarrier; else it reads them from global memory, in row tiles,
//      twice;
//   2. each warp takes columns and sums u x and v x^2 over the CTA's rows
//      (16-byte steps; u, v read once for the warp's columns); the
//      cluster's CTAs add the partial g, h in rank order through
//      distributed shared memory, and every CTA folds them (l2, the floor,
//      Eq. 5) into the same d;
//   3. each CTA forms delta over its rows, the cluster's live columns in
//      order (a list built by one warp's ballots; a sentinel's column is
//      all zero), into the cluster's partial (no cross-CTA sum: the rows
//      are its own);
//   4. CTA rank r of each cluster bumps counter r behind a fence; the last
//      to arrive sums the clusters' partials of slice r in cluster order
//      into delta and sets its counter back to 0 for the next launch.
// Every sum runs in a fixed order: the result is deterministic.
// The partials entry (`pcdn_direction_partials`, the sharded backend's
// shard-local step) stops after step 2: rank 0 writes the raw g and h
// floored at 1e-12 (no l2, no w, no d), what the reference's sharded
// backend takes from its Pallas K3 called with l2 = 0 before the phase-1
// sum over data shards; steps 3 and 4 and their buffers are skipped. The
// counters are kCluster words the wrapper keeps for each device (zero
// between launches); launches that share them run one after another on
// one stream. Earlier designs: CTAs owning whole columns (a DSMEM sum of
// the (s,) delta partials, every CTA forming u, v of all rows), and before
// that loads issued each after the previous one's use (loads under
// branches, loops of runtime length) in two waves of clusters: 21.02 and
// 44.81 us L2-cold at gisette's shape (PERF.md). The z, y of a thread's
// first rows and the column ids are loaded before the stream starts:
// behind it they wait for the whole stream.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace pcdn;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kMaxClusterCols = 64;  // bundle columns a cluster owns, at most
constexpr int kWarpCols = kMaxClusterCols / kWarps;
constexpr int kTileRows = 4096;      // rows of u, v a CTA holds at once
constexpr int kSumBatch = 16;        // cluster partials loaded at once
constexpr int kPre = 2;  // rows a thread whose z, y are loaded first
constexpr int kSmemBudget = 232448;

// VW values of type T loaded as one unit: 16 bytes, or one value
template <typename T, int VW>
struct Vec;
template <>
struct Vec<float, 1> {
  using R = float;
  __device__ static void unpack(const R& r, float* o) { o[0] = r; }
};
template <>
struct Vec<float, 4> {
  using R = float4;
  __device__ static void unpack(const R& r, float* o) {
    o[0] = r.x;
    o[1] = r.y;
    o[2] = r.z;
    o[3] = r.w;
  }
};
template <>
struct Vec<__nv_bfloat16, 1> {
  using R = __nv_bfloat16;
  __device__ static void unpack(const R& r, float* o) {
    o[0] = __bfloat162float(r);
  }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  using R = uint4;
  __device__ static void unpack(const R& r, float* o) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(p[k]);
      o[2 * k] = f.x;
      o[2 * k + 1] = f.y;
    }
  }
};

struct DirectionArgs {
  const void* XT;     // (n, s) feature-major design
  const int* idx;     // (P,) bundle, sentinel >= n
  const float* z;     // (s,) margins
  const float* y;     // (s,) labels
  const float* w;     // (P,) w_B
  float* d;
  float* g;
  float* h;
  float* delta;       // (s,)
  float* part;        // (clusters, s) cluster partials of delta
  int* counter;       // (kCluster,), 0 between launches
  float c, l2;
  int kind, n, s, P, cc, sl, tile, resident;
  int partials;       // 1: g, h partials only (w, d, delta, part unused)
};

// shared-memory layout, in floats: u and v of a row tile, the partial
// g, h, the d and the ids of the cluster's columns, the live columns'
// list and their (offset, d) pairs, then 16 words of flags and an
// mbarrier, each rounded up to 4 floats so that the
// resident column segments (cc x tile values of T) after them start on 16
// bytes; no static shared memory
__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int tile_pad(int tile) { return pad4(tile); }
// g, h, d, id, live list, (offset, d)
constexpr int kColFloats = 7 * kMaxClusterCols;
constexpr int kFlagFloats = 16;
__host__ __device__ inline size_t smem_floats(int tile) {
  return 2 * static_cast<size_t>(tile_pad(tile)) + kColFloats + kFlagFloats;
}
template <typename T>
size_t smem_bytes(int tile, int cc, int resident) {
  return smem_floats(tile) * sizeof(float) +
         (resident ? static_cast<size_t>(cc) * tile_pad(tile) * sizeof(T)
                   : 0);
}

// VW consecutive floats of shared memory from unit q: 16-byte loads (a
// warp's lanes on consecutive units, so no bank conflicts) where VW allows
template <int VW>
__device__ __forceinline__ void load_floats(const float* p, int q, float* o) {
  if constexpr (VW % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VW / 4; ++j) {
      const float4 f = reinterpret_cast<const float4*>(p)[q * (VW / 4) + j];
      o[4 * j] = f.x;
      o[4 * j + 1] = f.y;
      o[4 * j + 2] = f.z;
      o[4 * j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e) o[e] = p[q * VW + e];
  }
}

// the Hopper pieces: the mbarrier that bulk copies (TMA) complete, and the
// split cluster barrier (arrive when done with the others' shared memory,
// wait before leaving)
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
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// kBulk: the column segments are resident in shared memory, brought in by
// bulk copies (the plan's `resident`, with 16-byte rows); else read from
// global memory, in row tiles, twice
template <typename T, int VW, bool kBulk>
__global__ void __launch_bounds__(kThreads, 1)
dense_direction_kernel(const DirectionArgs a) {
  using V = Vec<T, VW>;
  using R = typename V::R;
  extern __shared__ __align__(16) float smem[];
  const int tp = tile_pad(a.tile);
  float* su = smem;
  float* sv = su + tp;
  float* spart = sv + tp;                          // [kMaxClusterCols][2]
  float* sdir = spart + 2 * kMaxClusterCols;       // by column
  int* scol = reinterpret_cast<int*>(sdir + kMaxClusterCols);  // by column
  int* slive = scol + kMaxClusterCols;             // the live columns
  // by live column: its segment's offset and d (the delta pass's operands)
  float2* scoef = reinterpret_cast<float2*>(slive + kMaxClusterCols);
  int* sflag = reinterpret_cast<int*>(scoef + kMaxClusterCols);  // ticket,
                                                    // live count, mbarrier
  unsigned long long* cols_bar =
      reinterpret_cast<unsigned long long*>(sflag + 2);
  T* sx = reinterpret_cast<T*>(sflag + kFlagFloats);  // [cc][tp], kBulk

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / kCluster;
  const int n_clusters = gridDim.x / kCluster;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s = a.s;
  const T* XT = static_cast<const T*>(a.XT);
  // the cluster's columns [p0, p0 + ncl) and the CTA's rows [r_lo, + len)
  const int p0 = cid * a.cc;
  const int ncl = max(0, min(a.cc, a.P - p0));
  const int r_lo = min(s, rank * a.sl);
  const int len = min(a.sl, s - r_lo);

  // a thread a column: its id, loaded with the thread's first rows' z, y,
  // all before the columns' stream starts (behind it they wait for the
  // whole stream)
  const int j_mine = tid < ncl ? a.idx[p0 + tid] : a.n;
  const float w_mine = tid < ncl && !a.partials ? a.w[p0 + tid] : 0.0f;
  // warp 0 also takes the ids of columns 32-63, for the live list
  const int j_hi = warp == 0 && tid + 32 < ncl ? a.idx[p0 + tid + 32] : a.n;
  float zp[kPre];
  float yp[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const int i = tid + k * kThreads;
    zp[k] = i < min(a.tile, len) ? a.z[r_lo + i] : 0.0f;
    yp[k] = i < min(a.tile, len) ? a.y[r_lo + i] : 1.0f;
  }
  if (kBulk && tid == 0) {
    // an arrival a column; each brings its segment's bytes
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_addr(cols_bar)),
                 "r"(max(ncl, 1))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < 2 * kMaxClusterCols) spart[tid] = 0.0f;
  __syncthreads();
  if (tid < max(ncl, 1)) {
    if (tid < ncl) scol[tid] = j_mine;
    if (kBulk) {
      const bool copy = len > 0 && static_cast<unsigned>(j_mine) <
                                       static_cast<unsigned>(a.n);
      const unsigned bytes =
          copy ? static_cast<unsigned>(len * sizeof(T)) : 0u;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              smem_addr(cols_bar)),
          "r"(bytes)
          : "memory");
      if (copy) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];" ::"r"(smem_addr(sx + tid * tp)),
            "l"(XT + static_cast<size_t>(j_mine) * s + r_lo), "r"(bytes),
            "r"(smem_addr(cols_bar))
            : "memory");
      }
    }
  }
  if (warp == 0) {
    // the live columns in order (a sentinel's column is all zero)
    const unsigned below = (1u << lane) - 1u;
    const bool on_lo =
        static_cast<unsigned>(j_mine) < static_cast<unsigned>(a.n);
    const bool on_hi = static_cast<unsigned>(j_hi) < static_cast<unsigned>(a.n);
    const unsigned lo = __ballot_sync(0xffffffffu, on_lo);
    const unsigned hi = __ballot_sync(0xffffffffu, on_hi);
    if (on_lo) slive[__popc(lo & below)] = lane;
    if (on_hi) slive[__popc(lo) + __popc(hi & below)] = lane + 32;
    if (lane == 0) sflag[1] = __popc(lo) + __popc(hi);
  }

  // 1. partial g, h over the CTA's rows, in row tiles: warp w takes live
  // columns w, w + kWarps, ...; lane l the tile's 16-byte steps l, l + 32
  float acc_g[kWarpCols];
  float acc_h[kWarpCols];
#pragma unroll
  for (int k = 0; k < kWarpCols; ++k) acc_g[k] = acc_h[k] = 0.0f;
  int nlive = 0;
  for (int t0 = 0; t0 < len; t0 += a.tile) {
    const int tl = min(a.tile, len - t0);
    if (t0 > 0) __syncthreads();  // the previous tile's u, v are read
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int i = tid + k * kThreads;
      if (t0 == 0 && i < tl) {
        loss_factors(a.kind, a.c, zp[k], yp[k], su[i], sv[i]);
      }
    }
    for (int i = tid + (t0 == 0 ? kPre * kThreads : 0); i < tl;
         i += kThreads) {
      const int r = r_lo + t0 + i;
      loss_factors(a.kind, a.c, a.z[r], a.y[r], su[i], sv[i]);
    }
    __syncthreads();
    nlive = sflag[1];
    if (kBulk) bar_wait(cols_bar, 0);
    const R* src[kWarpCols];  // the warp's live columns, once a tile
#pragma unroll
    for (int k = 0; k < kWarpCols; ++k) {
      const int kk = warp + k * kWarps;
      // a live column for every slot (the loads past nlive are skipped)
      const int m = nlive > 0 ? slive[min(kk, nlive - 1)] : 0;
      src[k] = kBulk ? reinterpret_cast<const R*>(sx + m * tp)
                     : reinterpret_cast<const R*>(
                           XT + static_cast<size_t>(scol[m]) * s + r_lo + t0);
    }
    const int nvec = tl / VW;  // tl is a multiple of VW (the plan's rule)
    for (int q = lane; q < nvec; q += 32) {
      float u[VW];
      float v[VW];
      load_floats<VW>(su, q, u);
      load_floats<VW>(sv, q, v);
      R raw[kWarpCols];  // the warp's columns' loads, issued together
#pragma unroll
      for (int k = 0; k < kWarpCols; ++k) {
        if (warp + k * kWarps < nlive) raw[k] = src[k][q];
      }
#pragma unroll
      for (int k = 0; k < kWarpCols; ++k) {
        if (warp + k * kWarps >= nlive) break;
        float x[VW];
        V::unpack(raw[k], x);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          acc_g[k] += u[e] * x[e];
          acc_h[k] += v[e] * (x[e] * x[e]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kWarpCols; ++k) {
    const int kk = warp + k * kWarps;
    if (kk >= nlive) break;
    const float pg = warp_sum(acc_g[k]);
    const float ph = warp_sum(acc_h[k]);
    if (lane == 0) {
      spart[2 * slive[kk]] = pg;
      spart[2 * slive[kk] + 1] = ph;
    }
  }
  cluster.sync();  // every CTA's partials are written

  // 2. the cluster's partials in rank order, then fold + Eq. 5, the same
  // in every CTA; rank 0 writes d, g, h
  if (tid < ncl) {
    float pg[kCluster];
    float ph[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      const float* src = cluster.map_shared_rank(spart, q);
      pg[q] = src[2 * tid];
      ph[q] = src[2 * tid + 1];
    }
    float g_raw = 0.0f;
    float h_raw = 0.0f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      g_raw += pg[q];
      h_raw += ph[q];
    }
    float gj, hj;
    const float dj = fold_direction(g_raw, h_raw, w_mine, a.l2, gj, hj);
    sdir[tid] = dj;
    if (rank == 0) {
      if (!a.partials) a.d[p0 + tid] = dj;
      a.g[p0 + tid] = gj;
      a.h[p0 + tid] = hj;
    }
  }
  cluster_arrive_relaxed();  // done with the others' shared memory
  if (a.partials) {
    cluster_wait();
    return;
  }
  __syncthreads();
  nlive = sflag[1];

  // 3. delta over the CTA's rows, the cluster's live columns in order,
  // into the cluster's partial: from shared memory a 16-byte step of rows
  // a thread, else a row a thread
  float* dst = a.part + static_cast<size_t>(cid) * s + r_lo;
  if (kBulk) {
    // each live column's (segment offset, d) packed into one 8-byte word,
    // then a 16-byte step of rows a thread
    if (tid < nlive) {
      const int m = slive[tid];
      scoef[tid] = make_float2(__int_as_float(m * tp), sdir[m]);
    }
    __syncthreads();
    const int nvec = len / VW;
    for (int q = tid; q < nvec; q += kThreads) {
      float t[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) t[e] = 0.0f;
      for (int k0 = 0; k0 < nlive; k0 += 8) {
        R raw[8];  // 8 columns' loads at once, added in column order
        float dm[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float2 cf = scoef[min(k0 + k, nlive - 1)];
          dm[k] = cf.y;
          raw[k] = reinterpret_cast<const R*>(sx + __float_as_int(cf.x))[q];
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k0 + k >= nlive) break;
          float x[VW];
          V::unpack(raw[k], x);
#pragma unroll
          for (int e = 0; e < VW; ++e) t[e] += x[e] * dm[k];
        }
      }
#pragma unroll
      for (int e = 0; e < VW; ++e) dst[q * VW + e] = t[e];
    }
  }
  for (int t0 = 0; t0 < (kBulk ? 0 : len); t0 += a.tile) {
    const int tl = min(a.tile, len - t0);
    for (int i = tid; i < tl; i += kThreads) {
      float t = 0.0f;
      for (int k0 = 0; k0 < nlive; k0 += 8) {
        float x[8];  // 8 columns' loads at once, added in column order
        float dm[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int m = slive[min(k0 + k, nlive - 1)];  // a live column
          dm[k] = sdir[m];
          x[k] = to_float(
              XT[static_cast<size_t>(scol[m]) * s + r_lo + t0 + i]);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k0 + k < nlive) t += x[k] * dm[k];
        }
      }
      dst[t0 + i] = t;
    }
  }

  // 4. for each slice r, the last CTA of rank r to arrive (a counter a
  // slice, behind a fence) sums the clusters' partials of its rows in
  // cluster order into delta and sets the counter back to 0
  __threadfence();
  __syncthreads();
  if (tid == 0) sflag[0] = atomicAdd(a.counter + rank, 1);
  __syncthreads();
  if (sflag[0] == n_clusters - 1) {
    __threadfence();
    for (int i = r_lo + tid; i < r_lo + len; i += kThreads) {
      float t = 0.0f;
      for (int k0 = 0; k0 < n_clusters; k0 += kSumBatch) {
        float v[kSumBatch];  // a batch of partials' loads at once
#pragma unroll
        for (int q = 0; q < kSumBatch; ++q) {
          v[q] = k0 + q < n_clusters
                     ? __ldcg(a.part + static_cast<size_t>(k0 + q) * s + i)
                     : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kSumBatch; ++q) {
          if (k0 + q < n_clusters) t += v[q];
        }
      }
      a.delta[i] = t;
    }
    if (tid == 0) atomicExch(a.counter + rank, 0);
  }
  cluster_wait();  // no CTA leaves while another reads its partials
}

template <typename T, int VW, bool kBulk>
int launch_kernel(const DirectionArgs& a, int ctas, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.tile, a.cc, a.resident);
  // the whole budget, allowed once a kernel, not at every launch
  static const cudaError_t allowed = cudaFuncSetAttribute(
      dense_direction_kernel<T, VW, kBulk>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, dense_direction_kernel<T, VW, kBulk>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// vec: 16-byte loads (4 float32 or 8 bf16 values) when every column's
// rows, slices and tiles start at a 16-byte boundary, else one value;
// resident (with vec): the column segments copied into shared memory
template <typename T, int VW>
int launch(const DirectionArgs& a, int ctas, int vec, cudaStream_t stream) {
  if (a.n < 1 || a.s < 1 || a.P < 1 || a.cc < 1 ||
      a.cc > kMaxClusterCols || ctas < kCluster || ctas % kCluster != 0 ||
      static_cast<long long>(ctas / kCluster) * a.cc < a.P || a.sl < 1 ||
      static_cast<long long>(a.sl) * kCluster < a.s || a.sl % 8 != 0 ||
      a.tile < 1 || a.tile > a.sl || (a.tile < a.sl && a.tile % 8 != 0) ||
      (a.resident && (a.tile != a.sl || !vec)) ||
      smem_bytes<T>(a.tile, a.cc, a.resident) > kSmemBudget) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!vec) return launch_kernel<T, 1, false>(a, ctas, stream);
  if (a.s % VW != 0 || reinterpret_cast<size_t>(a.XT) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return a.resident ? launch_kernel<T, VW, true>(a, ctas, stream)
                    : launch_kernel<T, VW, false>(a, ctas, stream);
}

}  // namespace

// launch constants, read once by kernels/build.py and checked against the
// plan in kernels/ops.py
extern "C" int pcdn_direction_threads() { return kThreads; }
extern "C" int pcdn_direction_cluster() { return kCluster; }
extern "C" int pcdn_direction_max_cluster_cols() { return kMaxClusterCols; }
extern "C" int pcdn_direction_tile_rows() { return kTileRows; }
extern "C" int pcdn_direction_smem_floats(int tile) {
  return static_cast<int>(smem_floats(tile));
}
// clusters of the kernel the card holds at once (one CTA an SM: 15 of 8
// on an H100 SXM, whose GPCs do not all hold two), or a negative
// cudaError_t; the plan keeps a launch within one wave where it can
extern "C" int pcdn_direction_max_clusters() {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBudget;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaFuncSetAttribute(
      dense_direction_kernel<float, 4, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(
        &n, dense_direction_kernel<float, 4, true>, &cfg);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

#define DIRECTION_ENTRY(SUFFIX, T, VW)                                       \
  extern "C" int pcdn_direction_##SUFFIX(                                  \
      const void* XT, const int* idx, const float* z, const float* y,       \
      const float* w, float c, int kind, float l2, int n, int s, int P,      \
      int cc, int ctas, int sl, int tile, int resident, int vec, float* d,   \
      float* g, float* h, float* delta, float* part, int* counter,           \
      void* stream) {                                                        \
    const DirectionArgs a{XT, idx, z,     y,     w,    d,  g,  h,          \
                          delta, part, counter, c, l2, kind, n, s, P, cc,  \
                          sl, tile, resident, 0};                            \
    return launch<T, VW>(a, ctas, vec, static_cast<cudaStream_t>(stream));   \
  }                                                                          \
  extern "C" int pcdn_direction_partials_##SUFFIX(                          \
      const void* XT, const int* idx, const float* z, const float* y,       \
      float c, int kind, int n, int s, int P, int cc, int ctas, int sl,      \
      int tile, int resident, int vec, float* g, float* h, void* stream) {   \
    const DirectionArgs a{XT,      idx,     z,    y,    nullptr, nullptr, \
                          g,       h,       nullptr, nullptr, nullptr, c,  \
                          0.0f,    kind,    n,    s,    P,  cc, sl, tile,    \
                          resident, 1};                                      \
    return launch<T, VW>(a, ctas, vec, static_cast<cudaStream_t>(stream));   \
  }

DIRECTION_ENTRY(f32, float, 4)
DIRECTION_ENTRY(bf16, __nv_bfloat16, 8)
