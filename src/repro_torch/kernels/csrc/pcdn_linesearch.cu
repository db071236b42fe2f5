// K5: batched multi-candidate Armijo evaluation, for Hopper.
//
// Replaces the Pallas kernel `pcdn_linesearch_kernel` (body `_kernel`) in
// src/repro/kernels/pcdn_linesearch.py. For the s per-sample margins z,
// margin deltas delta and labels y, and Q step candidates alphas:
//
//   out[q] = sum_i phi(z_i + alpha_q * delta_i, y_i) - phi(z_i, y_i)
//
// with phi the logistic, squared-hinge or squared loss in the stable forms
// of common.cuh (the same as the Pallas kernel's `_phi`).
// Bound on the H100: operations, barely. It reads z, delta, y once
// (12 bytes a sample) and evaluates Q losses a sample (about 10 flops
// each, exp and log1p counted as one each): at s = 57,848 and Q = 40,
// 0.69 MB against 23 Mflop.
// Design: a grid-stride reduction over s. Each thread keeps Q partial
// sums in registers (the array is sized by the compile-time kMaxQ, read
// by the wrapper through pcdn_linesearch_max_q), skips samples with
// delta = 0 (they add exactly 0) and evaluates phi(z_i) once per sample.
// A block reduces its partials per candidate (butterfly shuffles, then
// its warps in order) into a (n_blocks, Q) scratch, and a second launch
// sums the blocks in block order: a fixed order, so the result is
// deterministic for a given grid.
#include "common.cuh"

using namespace pcdn;

namespace {

constexpr int kMaxQ = 40;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
linesearch_partial_kernel(const float* __restrict__ z,
                          const float* __restrict__ delta,
                          const float* __restrict__ y,
                          const float* __restrict__ alphas, int kind, int s,
                          int Q, float* __restrict__ partials) {
  __shared__ float s_alpha[kMaxQ];
  __shared__ float red[kWarps][kMaxQ];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x; q < Q; q += kThreads) s_alpha[q] = alphas[q];
  __syncthreads();
  float acc[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) acc[q] = 0.0f;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < s; i += stride) {
    const float d = delta[i];
    if (d == 0.0f) continue;
    const float zi = z[i];
    const float yi = y[i];
    const float p0 = phi(kind, zi, yi);
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      if (q < Q) acc[q] += phi(kind, zi + s_alpha[q] * d, yi) - p0;
    }
  }
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    if (q < Q) {
      const float t = warp_sum(acc[q]);
      if (lane == 0) red[warp][q] = t;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][q];
    partials[static_cast<size_t>(blockIdx.x) * Q + q] = t;
  }
}

__global__ void __launch_bounds__(kMaxQ)
linesearch_finish_kernel(const float* __restrict__ partials, int n_blocks,
                         int Q, float* __restrict__ out) {
  const int q = threadIdx.x;
  if (q >= Q) return;
  float t = 0.0f;
  for (int b = 0; b < n_blocks; ++b) {
    t += partials[static_cast<size_t>(b) * Q + q];
  }
  out[q] = t;
}

}  // namespace

// largest Q the register array holds; the wrapper refuses more
extern "C" int pcdn_linesearch_max_q() { return kMaxQ; }

// threads per block: the wrapper sizes the grid (and the (n_blocks, Q)
// partials scratch) with it
extern "C" int pcdn_linesearch_threads() { return kThreads; }

extern "C" int pcdn_linesearch_f32(const float* z, const float* delta,
                                   const float* y, const float* alphas,
                                   int kind, int s, int Q, int n_blocks,
                                   float* partials, float* out,
                                   void* stream) {
  if (s < 1 || Q < 1 || Q > kMaxQ || n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  linesearch_partial_kernel<<<n_blocks, kThreads, 0, st>>>(
      z, delta, y, alphas, kind, s, Q, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  linesearch_finish_kernel<<<1, kMaxQ, 0, st>>>(partials, n_blocks, Q, out);
  return static_cast<int>(cudaGetLastError());
}
