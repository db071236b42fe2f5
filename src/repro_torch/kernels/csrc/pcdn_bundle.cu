// K1: the fused support-restricted PCDN bundle step, for Hopper.
//
// Replaces the Pallas kernel `pcdn_bundle_kernel` (body `_kernel`) in
// src/repro/kernels/pcdn_bundle.py, together with the XLA selection
// epilogue that follows it there. Given a bundle's padded-CSC slab
// (vals, pos: (P, K)), the margins and labels at its row support
// (z_R, y_R: (R,), R = P * K, sentinel slots z = 0, y = 1), w_B (P,) and
// the Q Armijo candidates alphas (Q,), it computes
//
//   u_R, v_R = c * phi'(z_R), c * phi''(z_R)          (on the fly)
//   g, h     = sum_k u_R[pos] vals, sum_k v_R[pos] vals^2, + l2 fold, floor
//   d        = Eq. 5 direction;  Delta = Eq. 7 decrement
//   delta_R  = scatter of vals * d at pos
//   f_q      = c sum_r [phi(z_r + a_q delta_r) - phi(z_r)]
//              + ||w + a_q d||_1 - ||w||_1 (+ elastic-net part)
//   alpha    = first a_q with f_q <= sigma a_q Delta, else 0
//
// and returns upd_w = alpha d, upd_z = alpha delta_R, alpha and n_steps
// (first + 1; 1 when no candidate passes, as argmax of an all-false mask).
//
// Bound on the H100: launch latency. At P = 32, K = 278 the step reads
// about 0.2 MB and does a few million flops -- well under a microsecond of
// either resource -- while each launch costs several microseconds.
// Design: three short launches on the caller's stream and no host sync.
//   (a) one warp per feature forms u/v from z_R, y_R as it gathers them
//       through pos, reduces g and h with shuffles, applies the epilogue,
//       then scatters vals * d into a zeroed delta_R with atomicAdd;
//   (b) blocks over R tiles evaluate all Q candidates on their slice,
//       skipping rows with delta = 0 (they add exactly 0), and write
//       (tiles, Q) partial sums;
//   (c) one block reduces the partials and the l1/l2 terms in a fixed
//       order, selects the first satisfying candidate, and scales the
//       outputs.
// Shared memory is sized by Q (at most kMaxQ), never by R, so any support
// size fits. The atomicAdd scatter sums a row's entries in a run-dependent
// order: delta_R (and what follows from it) may differ from the plain
// version in the last bits, which the stated tolerances cover.
#include "common.cuh"

using namespace pcdn;

namespace {

constexpr int kMaxQ = 64;
constexpr int kDirThreads = 128;     // 4 features per block in (a)
constexpr int kCandThreads = 128;    // (b)
constexpr int kCandPerThread = 2;
constexpr int kCandTile = kCandThreads * kCandPerThread;
constexpr int kSelectThreads = 256;  // (c)

template <typename T>
__global__ void __launch_bounds__(kDirThreads)
bundle_direction_kernel(const T* __restrict__ vals,
                        const int* __restrict__ pos,
                        const float* __restrict__ z_R,
                        const float* __restrict__ y_R,
                        const float* __restrict__ w, float c, int kind,
                        float l2, int P, int K, float* __restrict__ d_out,
                        float* __restrict__ g_out, float* __restrict__ h_out,
                        float* __restrict__ delta_R) {
  const int feat = static_cast<int>(
      (blockIdx.x * static_cast<unsigned>(blockDim.x) + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (feat >= P) return;  // whole warp leaves together
  const size_t base = static_cast<size_t>(feat) * K;
  float acc_g = 0.0f;
  float acc_h = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const float x = to_float(vals[base + k]);
    const int p = pos[base + k];
    const float zr = z_R[p];
    const float yr = y_R[p];
    acc_g += (c * dphi(kind, zr, yr)) * x;
    acc_h += (c * d2phi(kind, zr, yr)) * (x * x);
  }
  acc_g = warp_sum(acc_g);
  acc_h = warp_sum(acc_h);
  // every lane holds the same sums, hence the same direction
  const float wj = w[feat];
  const float g = acc_g + l2 * wj;
  const float h = hessian_floor(acc_h + l2);
  const float dj = newton_direction(g, h, wj);
  if (lane == 0) {
    d_out[feat] = dj;
    g_out[feat] = g;
    h_out[feat] = h;
  }
  for (int k = lane; k < K; k += 32) {
    const float x = to_float(vals[base + k]);
    if (x != 0.0f) atomicAdd(&delta_R[pos[base + k]], x * dj);
  }
}

__global__ void __launch_bounds__(kCandThreads)
bundle_candidates_kernel(const float* __restrict__ z_R,
                         const float* __restrict__ y_R,
                         const float* __restrict__ delta_R,
                         const float* __restrict__ alphas, int kind, int R,
                         int Q, float* __restrict__ partials) {
  __shared__ float red[kCandThreads / 32][kMaxQ];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float zr[kCandPerThread];
  float yr[kCandPerThread];
  float dr[kCandPerThread];
  float p0[kCandPerThread];
#pragma unroll
  for (int e = 0; e < kCandPerThread; ++e) {
    const int r = blockIdx.x * kCandTile + e * kCandThreads + threadIdx.x;
    dr[e] = (r < R) ? delta_R[r] : 0.0f;
    zr[e] = 0.0f;
    yr[e] = 1.0f;
    p0[e] = 0.0f;
    if (dr[e] != 0.0f) {
      zr[e] = z_R[r];
      yr[e] = y_R[r];
      p0[e] = phi(kind, zr[e], yr[e]);
    }
  }
  for (int q = 0; q < Q; ++q) {
    const float a = alphas[q];
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < kCandPerThread; ++e) {
      if (dr[e] != 0.0f) acc += phi(kind, zr[e] + a * dr[e], yr[e]) - p0[e];
    }
    acc = warp_sum(acc);
    if (lane == 0) red[warp][q] = acc;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += kCandThreads) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < kCandThreads / 32; ++k) t += red[k][q];
    partials[static_cast<size_t>(blockIdx.x) * Q + q] = t;
  }
}

__global__ void __launch_bounds__(kSelectThreads)
bundle_select_kernel(const float* __restrict__ g, const float* __restrict__ h,
                     const float* __restrict__ d, const float* __restrict__ w,
                     int P, const float* __restrict__ partials, int n_tiles,
                     const float* __restrict__ alphas, int Q, float c,
                     float l2, float sigma, float gamma,
                     const float* __restrict__ delta_R, int R,
                     float* __restrict__ upd_w, float* __restrict__ upd_z,
                     float* __restrict__ alpha_out,
                     int* __restrict__ n_steps_out) {
  __shared__ float s_Delta;
  __shared__ float s_l1_old;
  __shared__ float s_sq_old;
  __shared__ float s_alpha;
  __shared__ int s_ok[kMaxQ];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = kSelectThreads / 32;
  if (warp == 0) {
    float lin = 0.0f, quad = 0.0f, l1_new = 0.0f, l1_old = 0.0f;
    float sq_old = 0.0f;
    for (int j = lane; j < P; j += 32) {
      const float dj = d[j];
      const float wj = w[j];
      lin += g[j] * dj;
      quad += h[j] * (dj * dj);
      l1_new += fabsf(wj + dj);
      l1_old += fabsf(wj);
      sq_old += wj * wj;
    }
    lin = warp_sum(lin);
    quad = warp_sum(quad);
    l1_new = warp_sum(l1_new);
    l1_old = warp_sum(l1_old);
    sq_old = warp_sum(sq_old);
    if (lane == 0) {
      s_Delta = lin + gamma * quad + l1_new - l1_old;
      s_l1_old = l1_old;
      s_sq_old = sq_old;
    }
  }
  __syncthreads();
  const float Delta = s_Delta;
  for (int q = warp; q < Q; q += n_warps) {
    const float a = alphas[q];
    float lo = 0.0f, l1 = 0.0f, sq = 0.0f;
    for (int t = lane; t < n_tiles; t += 32) {
      lo += partials[static_cast<size_t>(t) * Q + q];
    }
    for (int j = lane; j < P; j += 32) {
      const float wq = w[j] + a * d[j];
      l1 += fabsf(wq);
      sq += wq * wq;
    }
    lo = warp_sum(lo);
    l1 = warp_sum(l1);
    sq = warp_sum(sq);
    if (lane == 0) {
      float f = c * lo + l1 - s_l1_old;
      if (l2 != 0.0f) f += 0.5f * l2 * (sq - s_sq_old);
      s_ok[q] = (f <= sigma * a * Delta) ? 1 : 0;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int first = 0;
    bool any = false;
    for (int q = 0; q < Q; ++q) {
      if (s_ok[q]) {
        first = q;
        any = true;
        break;
      }
    }
    const float alpha = any ? alphas[first] : 0.0f;
    s_alpha = alpha;
    *alpha_out = alpha;
    *n_steps_out = first + 1;
  }
  __syncthreads();
  const float alpha = s_alpha;
  for (int j = threadIdx.x; j < P; j += kSelectThreads) {
    upd_w[j] = alpha * d[j];
  }
  for (int r = threadIdx.x; r < R; r += kSelectThreads) {
    upd_z[r] = alpha * delta_R[r];
  }
}

template <typename T>
int launch(const T* vals, const int* pos, const float* z_R, const float* y_R,
           const float* w, const float* alphas, float c, int kind, float l2,
           float sigma, float gamma, int P, int K, int R, int Q, float* d,
           float* g, float* h, float* delta_R, float* partials, float* upd_w,
           float* upd_z, float* alpha, int* n_steps, cudaStream_t stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || K < 1 || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(
      delta_R, 0, static_cast<size_t>(R) * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int features_per_block = kDirThreads / 32;
  bundle_direction_kernel<T>
      <<<(P + features_per_block - 1) / features_per_block, kDirThreads, 0,
         stream>>>(vals, pos, z_R, y_R, w, c, kind, l2, P, K, d, g, h,
                   delta_R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (R + kCandTile - 1) / kCandTile;
  bundle_candidates_kernel<<<n_tiles, kCandThreads, 0, stream>>>(
      z_R, y_R, delta_R, alphas, kind, R, Q, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bundle_select_kernel<<<1, kSelectThreads, 0, stream>>>(
      g, h, d, w, P, partials, n_tiles, alphas, Q, c, l2, sigma, gamma,
      delta_R, R, upd_w, upd_z, alpha, n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows of R each candidate block covers: the wrapper sizes the
// (ceil(R / tile), Q) partials scratch with it
extern "C" int pcdn_bundle_tile() { return kCandTile; }

extern "C" int pcdn_bundle_max_q() { return kMaxQ; }

extern "C" int pcdn_bundle_f32(const float* vals, const int* pos,
                               const float* z_R, const float* y_R,
                               const float* w, const float* alphas, float c,
                               int kind, float l2, float sigma, float gamma,
                               int P, int K, int R, int Q, float* d, float* g,
                               float* h, float* delta_R, float* partials,
                               float* upd_w, float* upd_z, float* alpha,
                               int* n_steps, void* stream) {
  return launch<float>(vals, pos, z_R, y_R, w, alphas, c, kind, l2, sigma,
                       gamma, P, K, R, Q, d, g, h, delta_R, partials, upd_w,
                       upd_z, alpha, n_steps,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int pcdn_bundle_bf16(const void* vals, const int* pos,
                                const float* z_R, const float* y_R,
                                const float* w, const float* alphas, float c,
                                int kind, float l2, float sigma, float gamma,
                                int P, int K, int R, int Q, float* d,
                                float* g, float* h, float* delta_R,
                                float* partials, float* upd_w, float* upd_z,
                                float* alpha, int* n_steps, void* stream) {
  return launch<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(vals), pos, z_R, y_R, w, alphas, c,
      kind, l2, sigma, gamma, P, K, R, Q, d, g, h, delta_R, partials, upd_w,
      upd_z, alpha, n_steps, static_cast<cudaStream_t>(stream));
}
