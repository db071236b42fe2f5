// K2: the PCDN bundle direction over a padded-CSC slab, with the loss
// factors and the margin delta inside, for Hopper; and its two halves as
// entries of their own, for the sharded backend.
//
// Replaces the Pallas kernel `pcdn_sparse_direction_kernel` in
// src/repro/kernels/pcdn_sparse_direction.py, together with the passes
// that fed and followed it in the bundle step: the loss factors u, v over
// all samples before it and the margin delta X_B d (an index_add over the
// slab) after it. For each bundle feature j, with rows >= len(z) padding:
//
//   u_r, v_r = c * phi'(z_r, y_r), c * phi''(z_r, y_r)   at the slab's rows
//   g_j = sum_k u[rows_jk] vals_jk + l2 w_j
//   h_j = max(sum_k v[rows_jk] vals_jk^2 + l2, 1e-12)
//   d_j = Eq. 5 direction
//   delta[r] = sum of vals_jk d_j over the entries with rows_jk = r,
//              in ascending entry id j K + k            (0 at other rows)
//
// The full-scope step passes the margins z and labels y (delta is then the
// (s,) margin change); the backtracking support step passes the support
// positions and z_R, y_R (delta is delta_R). Three entries:
//   * pcdn_sparse_direction: all of the above -> d, g, h, delta;
//   * pcdn_sparse_direction_partials: a shard's raw g (no l2) and h
//     floored at 1e-12, no d and no delta -- what the reference's sharded
//     backend takes from its Pallas K2 called with l2 = 0 before the
//     phase-1 sum over data shards;
//   * pcdn_sparse_scatter: delta = X_B d for a given d (the sharded
//     backend's phase 2, after the global g, h made d).
//
// Bound on the H100: latency. The bytes (the slab, z/y at its rows, delta)
// take well under a microsecond at 3.35 TB/s, but each load of u[r] waits
// on the load of rows[k] before it. The first design (one warp a feature,
// 9 dependent strides at K = 278) paid two memory latencies a stride with
// 512 warps on 132 SMs.
// Design: a feature's column is split over up to 4 warps of one block,
// and each warp walks its segment in rounds (common.cuh load_round) that
// issue all of their row/value loads, then all of their z/y gathers: about
// two latencies a round, one round at K = 278. The warps' partial sums meet
// in shared memory in a fixed order; one thread applies the l2 fold, the
// floor and Eq. 5. Then every warp writes each live entry's term vals * d
// and pushes the entry onto its row's list (common.cuh chain_push), its
// column segment still in L1; a term of 0 changes no sum and is left off
// (a feature with d = 0 pushes nothing, nor do the support scope's
// padding entries, whose positions all name one slot). A second kernel,
// a thread an entry, has the entry at the head of each row's list sum the
// row's terms in ascending entry id (common.cuh ordered_chain_sum) into
// delta; a head alone on its list (most rows of a sparse bundle) writes
// its term, loaded with its row and link before the head. So delta is the
// same in every run, and equal to the plain version's index_add_ order.
// The design before this one added the terms with float atomicAdd
// straight into delta: one launch fewer, but a row's sum in a
// run-dependent order.
#include "common.cuh"

using namespace pcdn;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kEntryThreads = 256;  // the entry-parallel kernels
constexpr int kMaxEntryBlocks = 132 * 8;

// kPartials: the raw g and the floored h only (no w, d, terms or lists)
template <typename T, bool kPartials>
__global__ void __launch_bounds__(kThreads)
sparse_direction_kernel(const int* __restrict__ rows,
                        const T* __restrict__ vals,
                        const float* __restrict__ z,
                        const float* __restrict__ y,
                        const float* __restrict__ w, float c, int kind,
                        float l2, int P, int K, int n_rows, int wpf,
                        float* __restrict__ d_out, float* __restrict__ g_out,
                        float* __restrict__ h_out, int* __restrict__ head,
                        int* __restrict__ next, float* __restrict__ term) {
  __shared__ float part_g[kWarps];
  __shared__ float part_h[kWarps];
  __shared__ float feat_d[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int feat = blockIdx.x * (kWarps / wpf) + warp / wpf;
  const int seg = warp % wpf;
  const bool live = feat < P;
  const int seg_len = (K + wpf - 1) / wpf;
  const int k0 = min(K, seg * seg_len);
  const int k1 = min(K, k0 + seg_len);
  const size_t base = static_cast<size_t>(feat) * K;
  const float wj = (!kPartials && live && seg == 0) ? w[feat] : 0.0f;
  float acc_g = 0.0f;
  float acc_h = 0.0f;
  if (live) {
    for (int b = k0; b < k1; b += 32 * kUnroll) {
      SegmentRound sr;
      load_round(sr, rows + base, vals + base, b, k1, z, y, n_rows);
      accumulate_round(sr, c, kind, acc_g, acc_h);
    }
  }
  acc_g = warp_sum(acc_g);
  acc_h = warp_sum(acc_h);
  if (lane == 0) {
    part_g[warp] = acc_g;
    part_h[warp] = acc_h;
  }
  __syncthreads();
  if (live && seg == 0 && lane == 0) {
    float g_raw = 0.0f;
    float h_raw = 0.0f;
    for (int i = 0; i < wpf; ++i) {  // the segments in column order
      g_raw += part_g[warp + i];
      h_raw += part_h[warp + i];
    }
    float g, h;
    const float dj = fold_direction(g_raw, h_raw, wj, l2, g, h);
    g_out[feat] = g;
    h_out[feat] = h;
    if (!kPartials) {
      d_out[feat] = dj;
      feat_d[warp / wpf] = dj;
    }
  }
  if (kPartials) return;
  __syncthreads();
  if (!live) return;
  const float dj = feat_d[warp / wpf];
  if (dj == 0.0f) return;
  for (int k = k0 + lane; k < k1; k += 32) {
    const int r = rows[base + k];
    const float t = to_float(vals[base + k]) * dj;
    if (r >= 0 && r < n_rows && t != 0.0f) {
      const int e = static_cast<int>(base) + k;
      term[e] = t;
      chain_push(head, next, r, e);
    }
  }
}

// a thread an entry: the term vals * d[j] and the push onto its row's list
template <typename T>
__global__ void __launch_bounds__(kEntryThreads)
scatter_push_kernel(const int* __restrict__ rows, const T* __restrict__ vals,
                    const float* __restrict__ d, int R, int K, int n_rows,
                    int* __restrict__ head, int* __restrict__ next,
                    float* __restrict__ term) {
  for (int e = blockIdx.x * kEntryThreads + threadIdx.x; e < R;
       e += gridDim.x * kEntryThreads) {
    const int r = rows[e];
    const float t = to_float(vals[e]) * d[e / K];
    if (r >= 0 && r < n_rows && t != 0.0f) {
      term[e] = t;
      chain_push(head, next, r, e);
    }
  }
}

// a thread an entry: the entry at the head of its row's list writes the
// row's sum, its terms in ascending entry id
__global__ void __launch_bounds__(kEntryThreads)
ordered_sum_kernel(const int* __restrict__ rows, int R, int n_rows,
                   const int* __restrict__ head, const int* __restrict__ next,
                   const float* __restrict__ term,
                   float* __restrict__ delta) {
  for (int e = blockIdx.x * kEntryThreads + threadIdx.x; e < R;
       e += gridDim.x * kEntryThreads) {
    const int r = rows[e];
    const int nx = __ldcg(next + e);      // read only if e is a head
    const float t = __ldcg(term + e);
    if (r >= 0 && r < n_rows && __ldcg(head + r) == e + 1) {
      delta[r] = nx == 0 ? 0.0f + t
                         : ordered_chain_sum(e + 1, next, term, e, nx, t);
    }
  }
}

int entry_blocks(int R) {
  return max(1, min(kMaxEntryBlocks, (R + kEntryThreads - 1) /
                                         kEntryThreads));
}

bool bad_shape(int P, int K, int n_rows) {
  return P < 1 || K < 1 || n_rows < 1 ||
         static_cast<long long>(P) * K >= 0x7fffffffLL;
}

// delta and the rows' list heads: one (2 n_rows,) buffer, zeroed here
cudaError_t clear_rows(float* delta, int n_rows, cudaStream_t stream) {
  return cudaMemsetAsync(delta, 0, 2 * static_cast<size_t>(n_rows) *
                                       sizeof(float), stream);
}

template <typename T>
int launch(const int* rows, const T* vals, const float* z, const float* y,
           const float* w, float c, int kind, float l2, int P, int K,
           int n_rows, int wpf, float* d, float* g, float* h, float* delta,
           int* links, cudaStream_t stream) {
  if (bad_shape(P, K, n_rows) || (wpf != 1 && wpf != 2 && wpf != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = clear_rows(delta, n_rows, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* head = reinterpret_cast<int*>(delta + n_rows);
  const int R = P * K;
  float* term = reinterpret_cast<float*>(links + R);
  const int features_per_block = kWarps / wpf;
  const int blocks = (P + features_per_block - 1) / features_per_block;
  sparse_direction_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
      rows, vals, z, y, w, c, kind, l2, P, K, n_rows, wpf, d, g, h, head,
      links, term);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ordered_sum_kernel<<<entry_blocks(R), kEntryThreads, 0, stream>>>(
      rows, R, n_rows, head, links, term, delta);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_partials(const int* rows, const T* vals, const float* z,
                    const float* y, float c, int kind, int P, int K,
                    int n_rows, int wpf, float* g, float* h,
                    cudaStream_t stream) {
  if (bad_shape(P, K, n_rows) || (wpf != 1 && wpf != 2 && wpf != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int features_per_block = kWarps / wpf;
  const int blocks = (P + features_per_block - 1) / features_per_block;
  sparse_direction_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
      rows, vals, z, y, nullptr, c, kind, 0.0f, P, K, n_rows, wpf, nullptr,
      g, h, nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter(const int* rows, const T* vals, const float* d, int P,
                   int K, int n_rows, float* delta, int* links,
                   cudaStream_t stream) {
  if (bad_shape(P, K, n_rows)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = clear_rows(delta, n_rows, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* head = reinterpret_cast<int*>(delta + n_rows);
  const int R = P * K;
  float* term = reinterpret_cast<float*>(links + R);
  scatter_push_kernel<T><<<entry_blocks(R), kEntryThreads, 0, stream>>>(
      rows, vals, d, R, K, n_rows, head, links, term);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ordered_sum_kernel<<<entry_blocks(R), kEntryThreads, 0, stream>>>(
      rows, R, n_rows, head, links, term, delta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// delta: (2 n_rows,) floats, the (n_rows,) delta then the rows' list heads;
// links: (2 P K,) words, the entries' list links then their terms
#define SPARSE_ENTRIES(SUFFIX, T)                                            \
  extern "C" int pcdn_sparse_direction_##SUFFIX(                            \
      const int* rows, const void* vals, const float* z, const float* y,    \
      const float* w, float c, int kind, float l2, int P, int K, int n_rows, \
      int wpf, float* d, float* g, float* h, float* delta, int* links,      \
      void* stream) {                                                        \
    return launch<T>(rows, static_cast<const T*>(vals), z, y, w, c, kind,   \
                     l2, P, K, n_rows, wpf, d, g, h, delta, links,          \
                     static_cast<cudaStream_t>(stream));                     \
  }                                                                          \
  extern "C" int pcdn_sparse_direction_partials_##SUFFIX(                   \
      const int* rows, const void* vals, const float* z, const float* y,    \
      float c, int kind, int P, int K, int n_rows, int wpf, float* g,       \
      float* h, void* stream) {                                              \
    return launch_partials<T>(rows, static_cast<const T*>(vals), z, y, c,   \
                              kind, P, K, n_rows, wpf, g, h,                \
                              static_cast<cudaStream_t>(stream));            \
  }                                                                          \
  extern "C" int pcdn_sparse_scatter_##SUFFIX(                              \
      const int* rows, const void* vals, const float* d, int P, int K,      \
      int n_rows, float* delta, int* links, void* stream) {                 \
    return launch_scatter<T>(rows, static_cast<const T*>(vals), d, P, K,    \
                             n_rows, delta, links,                          \
                             static_cast<cudaStream_t>(stream));             \
  }

SPARSE_ENTRIES(f32, float)
SPARSE_ENTRIES(bf16, __nv_bfloat16)
