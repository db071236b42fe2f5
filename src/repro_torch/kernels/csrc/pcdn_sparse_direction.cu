// K2: fused PCDN bundle direction over a padded-CSC slab, for Hopper.
//
// Replaces the Pallas kernel `pcdn_sparse_direction_kernel` in
// src/repro/kernels/pcdn_sparse_direction.py. For each bundle feature j:
//
//   g_j = sum_k u[rows_jk] * vals_jk + l2 * w_j
//   h_j = max(sum_k v[rows_jk] * vals_jk^2 + l2, 1e-12)
//   d_j = Eq. 5 direction
//
// Rows >= s are padding (sentinel == s) and add nothing.
//
// Bound on the H100: bytes. The slab (rows, vals: 8 B per entry) streams
// once and u/v are gathered at the slab's rows (8 B per distinct row), with
// a handful of flops per entry -- far below the card's flop/byte balance.
// Design: one warp per bundle feature. Lanes stride over k, so the slab row
// is read coalesced; u[rows]/v[rows] are gathered straight from device
// memory (L2 serves repeated rows). Nothing is held resident, so unlike the
// Pallas kernel s has no VMEM-sized cap. A butterfly shuffle reduces the
// lane sums in a fixed order, and every lane applies the l2 fold, the
// Hessian floor and Eq. 5; lane 0 stores. bf16 values are upcast here.
#include "common.cuh"

using namespace pcdn;

namespace {

constexpr int kThreads = 128;  // 4 features per block: spreads P over SMs

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_direction_kernel(const int* __restrict__ rows,
                        const T* __restrict__ vals,
                        const float* __restrict__ u,
                        const float* __restrict__ v,
                        const float* __restrict__ w, float l2, int P, int K,
                        int s, float* __restrict__ d_out,
                        float* __restrict__ g_out,
                        float* __restrict__ h_out) {
  const int feat = static_cast<int>(
      (blockIdx.x * static_cast<unsigned>(blockDim.x) + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (feat >= P) return;  // whole warp leaves together
  const size_t base = static_cast<size_t>(feat) * K;
  float acc_g = 0.0f;
  float acc_h = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const int r = rows[base + k];
    if (r >= 0 && r < s) {
      const float x = to_float(vals[base + k]);
      acc_g += u[r] * x;
      acc_h += v[r] * (x * x);
    }
  }
  acc_g = warp_sum(acc_g);
  acc_h = warp_sum(acc_h);
  if (lane == 0) {
    const float wj = w[feat];
    const float g = acc_g + l2 * wj;
    const float h = hessian_floor(acc_h + l2);
    d_out[feat] = newton_direction(g, h, wj);
    g_out[feat] = g;
    h_out[feat] = h;
  }
}

template <typename T>
int launch(const int* rows, const T* vals, const float* u, const float* v,
           const float* w, float l2, int P, int K, int s, float* d, float* g,
           float* h, cudaStream_t stream) {
  const int features_per_block = kThreads / 32;
  const int blocks = (P + features_per_block - 1) / features_per_block;
  sparse_direction_kernel<T><<<blocks, kThreads, 0, stream>>>(
      rows, vals, u, v, w, l2, P, K, s, d, g, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pcdn_sparse_direction_f32(const int* rows, const float* vals,
                                         const float* u, const float* v,
                                         const float* w, float l2, int P,
                                         int K, int s, float* d, float* g,
                                         float* h, void* stream) {
  return launch<float>(rows, vals, u, v, w, l2, P, K, s, d, g, h,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int pcdn_sparse_direction_bf16(const int* rows, const void* vals,
                                          const float* u, const float* v,
                                          const float* w, float l2, int P,
                                          int K, int s, float* d, float* g,
                                          float* h, void* stream) {
  return launch<__nv_bfloat16>(
      rows, static_cast<const __nv_bfloat16*>(vals), u, v, w, l2, P, K, s, d,
      g, h, static_cast<cudaStream_t>(stream));
}
