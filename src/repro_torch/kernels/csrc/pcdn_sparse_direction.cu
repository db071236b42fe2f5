// K2: the PCDN bundle direction over a padded-CSC slab, with the loss
// factors and the margin scatter inside, for Hopper.
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
//   delta[rows_jk] += vals_jk d_j                          (delta zeroed here)
//
// The full-scope step passes the margins z and labels y (delta is then the
// (s,) margin change); the backtracking support step passes the support
// positions and z_R, y_R (delta is delta_R).
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
// floor and Eq. 5; then every warp scatters vals * d into delta with
// atomicAdd, its column segment still in L1. The atomics sum a row's
// entries in a run-dependent order, so delta may differ from the plain
// version in the last bits.
#include "common.cuh"

using namespace pcdn;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_direction_kernel(const int* __restrict__ rows,
                        const T* __restrict__ vals,
                        const float* __restrict__ z,
                        const float* __restrict__ y,
                        const float* __restrict__ w, float c, int kind,
                        float l2, int P, int K, int n_rows, int wpf,
                        float* __restrict__ d_out, float* __restrict__ g_out,
                        float* __restrict__ h_out,
                        float* __restrict__ delta) {
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
  const float wj = (live && seg == 0) ? w[feat] : 0.0f;
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
    d_out[feat] = dj;
    g_out[feat] = g;
    h_out[feat] = h;
    feat_d[warp / wpf] = dj;
  }
  __syncthreads();
  if (!live) return;
  const float dj = feat_d[warp / wpf];
  for (int k = k0 + lane; k < k1; k += 32) {
    const int r = rows[base + k];
    if (r >= 0 && r < n_rows) {
      atomicAdd(&delta[r], to_float(vals[base + k]) * dj);
    }
  }
}

template <typename T>
int launch(const int* rows, const T* vals, const float* z, const float* y,
           const float* w, float c, int kind, float l2, int P, int K,
           int n_rows, int wpf, float* d, float* g, float* h, float* delta,
           cudaStream_t stream) {
  if (P < 1 || K < 1 || n_rows < 1 || (wpf != 1 && wpf != 2 && wpf != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(
      delta, 0, static_cast<size_t>(n_rows) * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int features_per_block = kWarps / wpf;
  const int blocks = (P + features_per_block - 1) / features_per_block;
  sparse_direction_kernel<T><<<blocks, kThreads, 0, stream>>>(
      rows, vals, z, y, w, c, kind, l2, P, K, n_rows, wpf, d, g, h, delta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pcdn_sparse_direction_f32(
    const int* rows, const float* vals, const float* z, const float* y,
    const float* w, float c, int kind, float l2, int P, int K, int n_rows,
    int wpf, float* d, float* g, float* h, float* delta, void* stream) {
  return launch<float>(rows, vals, z, y, w, c, kind, l2, P, K, n_rows, wpf,
                       d, g, h, delta, static_cast<cudaStream_t>(stream));
}

extern "C" int pcdn_sparse_direction_bf16(
    const int* rows, const void* vals, const float* z, const float* y,
    const float* w, float c, int kind, float l2, int P, int K, int n_rows,
    int wpf, float* d, float* g, float* h, float* delta, void* stream) {
  return launch<__nv_bfloat16>(
      rows, static_cast<const __nv_bfloat16*>(vals), z, y, w, c, kind, l2, P,
      K, n_rows, wpf, d, g, h, delta, static_cast<cudaStream_t>(stream));
}
