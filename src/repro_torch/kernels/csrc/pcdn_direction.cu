// K3: fused PCDN bundle direction over a dense (s, P) slab, for Hopper.
//
// Replaces the Pallas kernel `pcdn_direction_kernel` in
// src/repro/kernels/pcdn_direction.py. For each bundle column j:
//
//   g_j = sum_i u_i X_ij + l2 * w_j
//   h_j = max(sum_i v_i X_ij^2 + l2, 1e-12)
//   d_j = Eq. 5 direction
//
// Bound on the H100: bytes. X_B (s * P * 4 B) is read once, with 5 flops
// per element; at s = 6,000 and P = 512 that is 12.3 MB, about 3.7 us at
// 3.35 TB/s. The products are computed here, not by a GEMM library.
// Design: a streaming read. A block is 32 columns by 8 row-threads; the 32
// threads of a warp read 32 neighbouring floats of one row (coalesced), and
// the 8 warps stride down the rows. P = 512 gives only 16 column tiles, so
// s is split across blocks too (grid.y = n_split, chosen by the wrapper to
// fill the SMs). Each block writes its (g, h) partials to an (n_split, P)
// scratch, and a second small kernel sums them in split order and applies
// the epilogue -- a fixed order, so the result is deterministic.
#include "common.cuh"

using namespace pcdn;

namespace {

constexpr int kTileP = 32;
constexpr int kRowThreads = 8;
constexpr int kFinishThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kTileP * kRowThreads)
direction_partial_kernel(const T* __restrict__ XB,
                         const float* __restrict__ u,
                         const float* __restrict__ v, int s, int P,
                         int rows_per_split, float* __restrict__ part_g,
                         float* __restrict__ part_h) {
  __shared__ float sg[kRowThreads][kTileP + 1];
  __shared__ float sh[kRowThreads][kTileP + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int col = blockIdx.x * kTileP + tx;
  const int split = blockIdx.y;
  const int r0 = split * rows_per_split;
  const int r1 = min(s, r0 + rows_per_split);
  float acc_g = 0.0f;
  float acc_h = 0.0f;
  if (col < P) {
#pragma unroll 4
    for (int i = r0 + ty; i < r1; i += kRowThreads) {
      const float x = to_float(XB[static_cast<size_t>(i) * P + col]);
      acc_g += u[i] * x;
      acc_h += v[i] * (x * x);
    }
  }
  sg[ty][tx] = acc_g;
  sh[ty][tx] = acc_h;
  __syncthreads();
  if (ty == 0 && col < P) {
    float G = 0.0f;
    float H = 0.0f;
#pragma unroll
    for (int k = 0; k < kRowThreads; ++k) {
      G += sg[k][tx];
      H += sh[k][tx];
    }
    part_g[static_cast<size_t>(split) * P + col] = G;
    part_h[static_cast<size_t>(split) * P + col] = H;
  }
}

__global__ void __launch_bounds__(kFinishThreads)
direction_finish_kernel(const float* __restrict__ part_g,
                        const float* __restrict__ part_h, int n_split,
                        const float* __restrict__ w, float l2, int P,
                        float* __restrict__ d_out, float* __restrict__ g_out,
                        float* __restrict__ h_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  float G = 0.0f;
  float H = 0.0f;
  for (int k = 0; k < n_split; ++k) {
    G += part_g[static_cast<size_t>(k) * P + j];
    H += part_h[static_cast<size_t>(k) * P + j];
  }
  const float wj = w[j];
  const float g = G + l2 * wj;
  const float h = hessian_floor(H + l2);
  d_out[j] = newton_direction(g, h, wj);
  g_out[j] = g;
  h_out[j] = h;
}

template <typename T>
int launch(const T* XB, const float* u, const float* v, const float* w,
           float l2, int s, int P, int n_split, float* part_g, float* part_h,
           float* d, float* g, float* h, cudaStream_t stream) {
  const int rows_per_split = (s + n_split - 1) / n_split;
  const dim3 block(kTileP, kRowThreads);
  const dim3 grid((P + kTileP - 1) / kTileP, n_split);
  direction_partial_kernel<T><<<grid, block, 0, stream>>>(
      XB, u, v, s, P, rows_per_split, part_g, part_h);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  direction_finish_kernel<<<(P + kFinishThreads - 1) / kFinishThreads,
                            kFinishThreads, 0, stream>>>(
      part_g, part_h, n_split, w, l2, P, d, g, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pcdn_direction_f32(const float* XB, const float* u,
                                  const float* v, const float* w, float l2,
                                  int s, int P, int n_split, float* part_g,
                                  float* part_h, float* d, float* g, float* h,
                                  void* stream) {
  return launch<float>(XB, u, v, w, l2, s, P, n_split, part_g, part_h, d, g,
                       h, static_cast<cudaStream_t>(stream));
}

extern "C" int pcdn_direction_bf16(const void* XB, const float* u,
                                   const float* v, const float* w, float l2,
                                   int s, int P, int n_split, float* part_g,
                                   float* part_h, float* d, float* g,
                                   float* h, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(XB), u, v,
                               w, l2, s, P, n_split, part_g, part_h, d, g, h,
                               static_cast<cudaStream_t>(stream));
}
