// K4b: serving margins over a padded-CSC request batch in one launch, for
// Hopper.
//
// Replaces the Pallas kernel `serve_margins_csc_kernel` (body
// `_csc_kernel`) in src/repro/kernels/pcdn_margin.py. The request batch
// arrives feature-major: col_rows/col_vals (n, k_max), the request rows
// of column j's nonzeros, sentinel row id >= B at padding. For each model
// k (idx/val (K, A), sentinel idx >= n at padding):
//
//   z[:, k] = sum_a val[k, a] * X_csc[:, idx[k, a]]      (scatter-add)
//
// Bound on the H100: bytes, but far below anything a launch can reach. A
// model needs, of each of its active columns of the request layout, the
// row ids up to the column's first sentinel (sentinels are packed last)
// and the values of its live entries, each distinct column counted once
// over all models; idx/val (K * A * 8); and it writes (B * K * 4): about
// 0.24 us at the serve shape (B 256, n 20,958, k_max 6, K 8, A 10,901).
// The previous design took 15 us in two launches (scatter into a
// (slices, K, B) scratch, then an ordered sum): launch latency, the
// scratch's round trip and the chain of dependent loads.
// Design: one launch, no scratch. The grid is (cluster, K, row ranges):
// for model k one cluster of up to 8 CTAs splits the model's A features
// into one slice a CTA. Each CTA keeps a (range rows,) margin column in
// shared memory, zeroed at the start. Its threads take the slice's
// (feature, slot) pairs in rounds of kRound pairs a thread, consecutive
// threads on consecutive slots of a column (one coalesced read of
// col_rows however narrow the columns), and issue a round's loads stage by
// stage, every load of a stage before any of them is used (the ids with
// their weights, then the row ids, then the live entries' values), so a
// round costs about three memory latencies; at the serve shape each thread
// has one round. A live entry adds x * val[k, a] into the column with a
// shared-memory atomic. Then the cluster's CTAs sum their columns through
// distributed shared memory, each CTA a slice of the rows, the CTAs in
// rank order, and write out (B, K) directly. When 4 B bytes exceed the
// block's budget the rows are split into ranges (grid z), and each range's
// cluster skips entries outside it. Both sentinels add nothing.
// Shared-memory atomics sum in a run-dependent order, so the last bits may
// differ from run to run; the cluster sum is in a fixed order.
// A second layout was measured and dropped: one cluster walking the
// models' union of ids once, each live request entry read once for all K
// models (ModelBank's union_idx/union_val). With 8 CTAs in all and a
// latency for the K weights of every live slot it took about twice as
// long at the serve shape.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace pcdn;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxCluster = 8;
constexpr int kRound = 8;  // (feature, slot) pairs a thread has in flight
// the margin column a CTA keeps: 48K floats = 192 KB of the 227 KB a block
// may use
constexpr int kMaxRangeRows = 48 * 1024;

struct CscArgs {
  const int* col_rows;
  const void* col_vals;
  const int* idx;
  const void* val;
  float* out;
  int n, k_max, K, A, B, range_rows;
};

template <typename TC, typename TV>
__global__ void __launch_bounds__(kThreads, 1)
margins_csc_kernel(const CscArgs a) {
  extern __shared__ float acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = static_cast<int>(cluster.num_blocks());
  const int k = blockIdx.y;
  const int lo = blockIdx.z * a.range_rows;
  const int len = min(a.range_rows, a.B - lo);
  for (int i = threadIdx.x; i < len; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  const TC* col_vals = static_cast<const TC*>(a.col_vals);
  const int* ids = a.idx + static_cast<size_t>(k) * a.A;
  const TV* val = static_cast<const TV*>(a.val) + static_cast<size_t>(k) * a.A;
  const int slice = (a.A + cl - 1) / cl;
  const int f0 = min(a.A, rank * slice);
  const int f1 = min(a.A, f0 + slice);
  const int k_max = a.k_max;
  // fits an int (checked by the launcher)
  const int n_pairs = (f1 - f0) * k_max;
  for (int base = threadIdx.x; base < n_pairs; base += kThreads * kRound) {
    int slot[kRound];
    int j[kRound];
    float w[kRound];
#pragma unroll
    for (int e = 0; e < kRound; ++e) {  // the ids and their weights
      const int p = base + e * kThreads;
      const bool in = p < n_pairs;
      const int fl = in ? p / k_max : 0;
      slot[e] = p - fl * k_max;
      j[e] = in ? ids[f0 + fl] : a.n;
      w[e] = in ? to_float(val[f0 + fl]) : 0.0f;
    }
    int row[kRound];
#pragma unroll
    for (int e = 0; e < kRound; ++e) {  // the row ids
      const bool ok = static_cast<unsigned>(j[e]) <
                      static_cast<unsigned>(a.n);
      slot[e] = ok ? j[e] * k_max + slot[e] : 0;
      row[e] = ok ? a.col_rows[slot[e]] - lo : -1;
    }
    float x[kRound];
#pragma unroll
    for (int e = 0; e < kRound; ++e) {  // the live entries' values
      if (static_cast<unsigned>(row[e]) >= static_cast<unsigned>(len)) {
        row[e] = -1;
      }
      x[e] = row[e] >= 0 ? to_float(col_vals[slot[e]]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kRound; ++e) {
      if (row[e] >= 0) atomicAdd(&acc[row[e]], x[e] * w[e]);
    }
  }
  cluster.sync();  // every CTA's column is complete
  // rank r finishes its slice of the rows, the CTAs' columns in rank order
  const int part = (len + cl - 1) / cl;
  const int r0 = min(len, rank * part);
  const int r1 = min(len, r0 + part);
  for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
    float v[kMaxCluster];  // the cluster's loads at once, summed in order
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      v[q] = q < cl ? cluster.map_shared_rank(acc, q)[r] : 0.0f;
    }
    float t = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < cl) t += v[q];
    }
    a.out[static_cast<size_t>(lo + r) * a.K + k] = t;
  }
  cluster.sync();  // no CTA leaves while another reads its column
}

template <typename TC, typename TV>
int launch(const CscArgs& a, int cluster, int n_ranges, cudaStream_t stream) {
  if (a.n < 1 || a.k_max < 1 || a.K < 1 || a.A < 1 || a.B < 1 ||
      cluster < 1 || cluster > kMaxCluster || n_ranges < 1 ||
      n_ranges > 65535 || a.K > 65535 || a.range_rows < 1 ||
      a.range_rows > kMaxRangeRows ||
      static_cast<long long>(a.range_rows) * n_ranges < a.B ||
      static_cast<long long>(a.range_rows) * (n_ranges - 1) >= a.B ||
      static_cast<long long>(a.A) * a.k_max > 0x7fffffffLL ||
      static_cast<long long>(a.n) * a.k_max > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the largest column, allowed once a kernel, not at every launch
  static const cudaError_t allowed = cudaFuncSetAttribute(
      margins_csc_kernel<TC, TV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxRangeRows * sizeof(float)));
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, a.K, n_ranges);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(a.range_rows) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, margins_csc_kernel<TC, TV>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// launch constants, read once by kernels/build.py and checked against the
// plan in kernels/ops.py
extern "C" int serve_margins_csc_threads() { return kThreads; }
extern "C" int serve_margins_csc_max_cluster() { return kMaxCluster; }
extern "C" int serve_margins_csc_round() { return kRound; }
extern "C" int serve_margins_csc_max_range_rows() { return kMaxRangeRows; }

// col_vals and val each float32 or bfloat16: four entry points, named
// serve_margins_csc_<col_vals type>_<val type>; out is (B, K) float32
#define MARGINS_CSC_ENTRY(NAME, TC, TV)                                    \
  extern "C" int NAME(const int* col_rows, const void* col_vals,           \
                      const int* idx, const void* val, int n, int k_max,   \
                      int K, int A, int B, int cluster, int n_ranges,      \
                      int range_rows, float* out, void* stream) {          \
    const CscArgs a{col_rows, col_vals, idx, val, out, n, k_max, K, A, B,  \
                    range_rows};                                           \
    return launch<TC, TV>(a, cluster, n_ranges,                            \
                          static_cast<cudaStream_t>(stream));              \
  }

MARGINS_CSC_ENTRY(serve_margins_csc_f32_f32, float, float)
MARGINS_CSC_ENTRY(serve_margins_csc_f32_bf16, float, __nv_bfloat16)
MARGINS_CSC_ENTRY(serve_margins_csc_bf16_f32, __nv_bfloat16, float)
MARGINS_CSC_ENTRY(serve_margins_csc_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
