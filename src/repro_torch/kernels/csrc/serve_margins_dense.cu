// K4a: serving margins over a dense request slab, for Hopper.
//
// Replaces the Pallas kernel `serve_margins_dense_kernel` (body
// `_dense_kernel`) in src/repro/kernels/pcdn_margin.py. For K sparse
// models stacked as idx/val (K, A) (sentinel idx >= n at padding) and a
// row-major request slab X (B, n):
//
//   z[b, k] = sum_a val[k, a] * X[b, idx[k, a]]       (sentinels add 0)
//
// Bound on the H100: bytes. Only the models' active columns of X are
// read: B * U * 4 bytes (U = the union of active ids), plus idx/val
// (K * A * 8) and the output (B * K * 4); about 2 flops per gathered
// element. The gather X[b, idx] is not coalesced (neighbouring lanes read
// columns idx[a], idx[a + 1], ... of one row), but a row's active columns
// sit in one B * n slice that the L2 cache holds across the K models.
// Design: one block per (model k, tile of kRowsPerBlock request rows).
// The block stages model k's idx/val in shared memory, kTileA entries at
// a time; each warp owns kRowsPerWarp rows, its lanes stride over a and
// keep one f32 partial per row in registers; after the last tile a
// butterfly shuffle sums the lanes. No atomics: the sum order is fixed,
// so the result is deterministic.
#include "common.cuh"

using namespace pcdn;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTileA = 1024;

template <typename TX, typename TV>
__global__ void __launch_bounds__(kThreads)
margins_dense_kernel(const TX* __restrict__ X, const int* __restrict__ idx,
                     const TV* __restrict__ val, int B, int n, int K, int A,
                     float* __restrict__ out) {
  __shared__ int s_idx[kTileA];
  __shared__ float s_val[kTileA];
  const int k = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kRowsPerBlock + warp * kRowsPerWarp;
  const size_t model = static_cast<size_t>(k) * A;
  float acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.0f;
  for (int a0 = 0; a0 < A; a0 += kTileA) {
    const int len = min(kTileA, A - a0);
    for (int a = threadIdx.x; a < len; a += kThreads) {
      s_idx[a] = idx[model + a0 + a];
      s_val[a] = to_float(val[model + a0 + a]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      if (row < B) {
        const TX* xr = X + static_cast<size_t>(row) * n;
        for (int a = lane; a < len; a += 32) {
          const int j = s_idx[a];
          if (static_cast<unsigned>(j) < static_cast<unsigned>(n)) {
            acc[r] += s_val[a] * to_float(xr[j]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float total = warp_sum(acc[r]);
    const int row = row0 + r;
    if (lane == 0 && row < B) out[static_cast<size_t>(row) * K + k] = total;
  }
}

template <typename TX, typename TV>
int launch(const TX* X, const int* idx, const TV* val, int B, int n, int K,
           int A, float* out, cudaStream_t stream) {
  const int row_tiles = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  if (B < 1 || n < 1 || K < 1 || A < 1 || row_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(K, row_tiles);
  margins_dense_kernel<TX, TV><<<grid, kThreads, 0, stream>>>(
      X, idx, val, B, n, K, A, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X and val each float32 or bfloat16: four entry points, named
// serve_margins_dense_<X type>_<val type>
#define MARGINS_DENSE_ENTRY(NAME, TX, TV)                                  \
  extern "C" int NAME(const void* X, const int* idx, const void* val,      \
                      int B, int n, int K, int A, float* out,              \
                      void* stream) {                                      \
    return launch<TX, TV>(static_cast<const TX*>(X), idx,                  \
                          static_cast<const TV*>(val), B, n, K, A, out,    \
                          static_cast<cudaStream_t>(stream));              \
  }

MARGINS_DENSE_ENTRY(serve_margins_dense_f32_f32, float, float)
MARGINS_DENSE_ENTRY(serve_margins_dense_f32_bf16, float, __nv_bfloat16)
MARGINS_DENSE_ENTRY(serve_margins_dense_bf16_f32, __nv_bfloat16, float)
MARGINS_DENSE_ENTRY(serve_margins_dense_bf16_bf16, __nv_bfloat16,
                    __nv_bfloat16)
