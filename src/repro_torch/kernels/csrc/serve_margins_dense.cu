// K4a: serving margins over a dense request slab, for Hopper.
//
// Replaces the Pallas kernel `serve_margins_dense_kernel` (body
// `_dense_kernel`) in src/repro/kernels/pcdn_margin.py. For K sparse
// models stacked as idx/val (K, A) (sentinel idx >= n at padding) and a
// row-major request slab X (B, n):
//
//   z[b, k] = sum_a val[k, a] * X[b, idx[k, a]]       (sentinels add 0)
//
// Contract: each model's live ids ascend, sentinels after them, as the
// artifact (strictly ascending w_indices) and ModelBank lay them out.
//
// Bound on the H100: bytes. The models' active columns of X (B * U
// values, U the union of active ids), idx/val (K * A * 8 bytes) and the
// output (B * K * 4); about 2 flops per gathered element.
//
// Design: X is cut into tiles of kRows request rows x `width` columns,
// one block a tile, and each tile is read from device memory once, for
// all K models: the block stages its tile in shared memory with
// coalesced loads (neighbouring lanes on neighbouring columns). A warp
// takes one model at a time: it bounds the segment of the model's
// ascending ids that falls in the tile (a warp-wide 32-way search, three
// rounds of loads for 10901 ids), stages the segment's (column, value)
// pairs in shared memory in id order, and walks them with a lane a
// request row: one broadcast load of a pair, one load of X and one FMA
// an entry. A second launch sums the column tiles' partial margins, a
// warp an output, in a fixed order. No float atomics: the result is
// deterministic. Ids that are not ascending drop terms (an id outside
// the tile's columns is never staged, so nothing is read out of bounds
// or counted twice); sentinels never fall in a segment.
#include <cstdint>

#include "common.cuh"

using namespace pcdn;

namespace {

constexpr int kRows = 32;           // request rows a tile: one a lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 192;         // (column, value) pairs a warp stages
constexpr int kSumThreads = 256;

// first positions in ids[0, A) whose id is >= t0 and >= t1, for
// ascending ids, by the whole warp: 32 probes a round narrow each
// [lo, hi] 32-fold, the two searches in lockstep, so A = 10901 takes
// three rounds of loads. Any ids give positions in [0, A].
__device__ __forceinline__ int2 warp_lower_bounds(const int* ids, int A,
                                                  int t0, int t1, int lane) {
  int lo[2] = {0, 0}, hi[2] = {A, A};
  const int t[2] = {t0, t1};
  while (hi[0] - lo[0] > 32 || hi[1] - lo[1] > 32) {
    int step[2], p[2], id[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      step[s] = (hi[s] - lo[s] + 31) / 32;
      p[s] = lo[s] + lane * step[s];
      id[s] = (hi[s] - lo[s] > 32 && p[s] < hi[s]) ? ids[p[s]] : 0;
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (hi[s] - lo[s] <= 32) continue;          // the same in every lane
      const int below = __popc(
          __ballot_sync(0xffffffffu, p[s] < hi[s] && id[s] < t[s]));
      if (below == 0) {
        hi[s] = lo[s];
      } else {
        const int next_lo = lo[s] + (below - 1) * step[s] + 1;
        hi[s] = min(hi[s], lo[s] + below * step[s]);
        lo[s] = next_lo;
      }
    }
  }
  int out[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lo[s] + lane;
    const bool below = q < hi[s] && ids[q] < t[s];
    out[s] = lo[s] + __popc(__ballot_sync(0xffffffffu, below));
  }
  return make_int2(out[0], out[1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// part[cb, k, b]: model k's margin of request b over column tile cb
template <typename TX, typename TV>
__global__ void __launch_bounds__(kThreads)
margins_tile_kernel(const TX* __restrict__ X, const int* __restrict__ idx,
                    const TV* __restrict__ val, int B, int n, int K, int A,
                    int width, float* __restrict__ part) {
  extern __shared__ float xs[];                 // kRows x (width + 1)
  const int ld = width + 1;                     // odd: rows on distinct banks
  int* seg = reinterpret_cast<int*>(xs + kRows * ld);   // [lo, hi) a model
  const int cb = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int c0 = cb * width;
  const int cw = min(n - c0, width);
  const int rows = min(kRows, B - r0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the warp's staged pairs: column in the tile, value's bits
  int2* pairs = reinterpret_cast<int2*>(seg + 2 * K) + warp * kChunk;

  // the tile: f32 rows by cp.async, every load in flight at once and no
  // registers held (the search below runs meanwhile); bf16 rows through
  // registers, 2 bytes being below cp.async's smallest copy
  for (int r = warp; r < kRows; r += kWarps) {
    float* dst = xs + r * ld;
    if (r >= rows) {
      for (int c = lane; c < cw; c += 32) dst[c] = 0.0f;
    } else if constexpr (sizeof(TX) == 4) {
      // rows start at any 4-byte boundary (n * 4 bytes apart), and the
      // shared rows must stay 4 * (width + 1) bytes apart for the gather,
      // so the copies are 4 bytes, neighbouring lanes on neighbouring
      // columns
      const TX* src = X + static_cast<size_t>(r0 + r) * n + c0;
      for (int c = lane; c < cw; c += 32) cp_async4(dst + c, src + c);
    } else {
      const TX* src = X + static_cast<size_t>(r0 + r) * n + c0;
#pragma unroll 8
      for (int c = lane; c < cw; c += 32) dst[c] = to_float(src[c]);
    }
  }
  // each warp bounds the segments of the models it will gather for
  for (int k = warp; k < K; k += kWarps) {
    const int* ik = idx + static_cast<size_t>(k) * A;
    const int2 b = warp_lower_bounds(ik, A, c0, c0 + cw, lane);
    if (lane == 0) {
      seg[2 * k] = b.x;
      seg[2 * k + 1] = b.y;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const float* xr = xs + lane * ld;
  for (int k = warp; k < K; k += kWarps) {
    const int* ik = idx + static_cast<size_t>(k) * A;
    const TV* vk = val + static_cast<size_t>(k) * A;
    const int lo = seg[2 * k];
    const int hi = seg[2 * k + 1];
    float acc = 0.0f;
    for (int base = lo; base < hi; base += kChunk) {
      // the chunk's ids and values, every load in flight at once; then
      // the entries that lie in this tile staged in order (ids outside
      // it, possible only when ids are out of order, drop out)
      int j[kChunk / 32];
      float v[kChunk / 32];
#pragma unroll
      for (int q = 0; q < kChunk / 32; ++q) {
        const int e = base + 32 * q + lane;
        j[q] = e < hi ? ik[e] - c0 : -1;
        v[q] = e < hi ? to_float(vk[e]) : 0.0f;
      }
      int count = 0;
#pragma unroll
      for (int q = 0; q < kChunk / 32; ++q) {
        const bool in =
            static_cast<unsigned>(j[q]) < static_cast<unsigned>(cw);
        const unsigned m = __ballot_sync(0xffffffffu, in);
        if (in) {
          pairs[count + __popc(m & ((1u << lane) - 1u))] =
              make_int2(j[q], __float_as_int(v[q]));
        }
        count += __popc(m);
      }
      __syncwarp();
#pragma unroll 8
      for (int t = 0; t < count; ++t) {
        const int2 pr = pairs[t];
        acc = fmaf(__int_as_float(pr.y), xr[pr.x], acc);
      }
      __syncwarp();
    }
    if (lane < rows) {
      part[(static_cast<size_t>(cb) * K + k) * B + r0 + lane] = acc;
    }
  }
}

// out[b, k] = sum over the column tiles of part[cb, k, b]: a warp an
// output, lanes over the tiles in a fixed order, then a fixed butterfly
__global__ void __launch_bounds__(kSumThreads)
margins_sum_kernel(const float* __restrict__ part, int n_tiles, int K, int B,
                   float* __restrict__ out) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x) / 32;
  if (i >= static_cast<long long>(K) * B) return;   // whole warps
  const int lane = threadIdx.x & 31;
  const size_t stride = static_cast<size_t>(K) * B;
  float acc = 0.0f;
  for (int cb = lane; cb < n_tiles; cb += 32) acc += part[cb * stride + i];
  acc = warp_sum(acc);
  if (lane == 0) {
    const int k = static_cast<int>(i / B);
    out[static_cast<size_t>(i - static_cast<long long>(k) * B) * K + k] = acc;
  }
}

template <typename TX, typename TV>
int launch(const TX* X, const int* idx, const TV* val, int B, int n, int K,
           int A, int width, float* part, float* out, cudaStream_t stream) {
  if (B < 1 || n < 1 || K < 1 || A < 1 || width < 32 || width % 32 ||
      static_cast<long long>(K) * B > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (n + width - 1) / width;
  const int row_tiles = (B + kRows - 1) / kRows;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      (static_cast<size_t>(kRows) * (width + 1) + 2 * K) * sizeof(float) +
      static_cast<size_t>(kWarps) * kChunk * sizeof(int2);
  cudaError_t err = cudaFuncSetAttribute(
      margins_tile_kernel<TX, TV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  margins_tile_kernel<TX, TV><<<dim3(n_tiles, row_tiles), kThreads, bytes,
                                stream>>>(X, idx, val, B, n, K, A, width,
                                          part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps = static_cast<long long>(K) * B;
  const int blocks =
      static_cast<int>((warps * 32 + kSumThreads - 1) / kSumThreads);
  margins_sum_kernel<<<blocks, kSumThreads, 0, stream>>>(part, n_tiles, K, B,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X and val each float32 or bfloat16: four entry points, named
// serve_margins_dense_<X type>_<val type>; width (a multiple of 32) is
// the column tile, part scratch for ceil(n / width) * K * B floats
#define MARGINS_DENSE_ENTRY(NAME, TX, TV)                                  \
  extern "C" int NAME(const void* X, const int* idx, const void* val,      \
                      int B, int n, int K, int A, int width, float* part,  \
                      float* out, void* stream) {                          \
    return launch<TX, TV>(static_cast<const TX*>(X), idx,                  \
                          static_cast<const TV*>(val), B, n, K, A, width,  \
                          part, out, static_cast<cudaStream_t>(stream));   \
  }

MARGINS_DENSE_ENTRY(serve_margins_dense_f32_f32, float, float)
MARGINS_DENSE_ENTRY(serve_margins_dense_f32_bf16, float, __nv_bfloat16)
MARGINS_DENSE_ENTRY(serve_margins_dense_bf16_f32, __nv_bfloat16, float)
MARGINS_DENSE_ENTRY(serve_margins_dense_bf16_bf16, __nv_bfloat16,
                    __nv_bfloat16)
