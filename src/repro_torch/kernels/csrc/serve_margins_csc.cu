// K4b: serving margins over a padded-CSC request batch, for Hopper.
//
// Replaces the Pallas kernel `serve_margins_csc_kernel` (body
// `_csc_kernel`) in src/repro/kernels/pcdn_margin.py. The request batch
// arrives feature-major: col_rows/col_vals (n, k_max), the request rows
// of column j's nonzeros, sentinel row id >= B at padding. For each
// model k (idx/val (K, A), sentinel idx >= n at padding):
//
//   z[:, k] = sum_a val[k, a] * X_csc[:, idx[k, a]]      (scatter-add)
//
// Bound on the H100: bytes. A model needs, of each of its active columns
// of the request layout, the row ids up to the column's first sentinel
// (sentinels are packed last) and the values of its live entries, each
// distinct column counted once over all models; idx/val (K * A * 8); and
// it writes (B * K * 4); about 2 flops per gathered entry.
// Design: the Pallas grid is one program per model, scatter-adding into a
// (B,) vector. Here a block owns one model k, one range of request rows
// and one slice of the model's active features (grid (K, row ranges,
// feature slices)). It keeps its (range,) margin column in shared memory:
// it zeroes it, its threads walk the slice's (feature, slot) pairs in
// order -- consecutive threads take consecutive slots of one column, so a
// column's slots are one coalesced read of col_rows and however narrow
// the columns are (the batcher packs each chunk at its own k_max) no lane
// idles -- and add val[k, a] * x into shared memory with atomicAdd; a
// slot's value is read only when its row id is live. Then the block
// writes the column to a (slices, K, B) scratch in one coalesced pass. A
// second launch sums the slices in slice order into out (K, B). No global
// atomics. One model's active features are too many for one block (at
// A = 10,901, k_max = 75 a single block per model took 1.4 ms), so the
// wrapper picks enough feature slices to give every SM a few blocks. When
// 4 * B exceeds the shared-memory budget the rows are split into ranges
// of at most kMaxRangeRows and each block skips entries outside its
// range. Both sentinels (idx >= n, row id >= B) add nothing. Shared-memory
// atomics sum in a run-dependent order, so the last bits may differ from
// run to run.
#include "common.cuh"

using namespace pcdn;

namespace {

constexpr int kThreads = 256;
// rows per block: 48K floats = 192 KB of the 227 KB a block may use
constexpr int kMaxRangeRows = 48 * 1024;
constexpr int kSumThreads = 256;

template <typename TC, typename TV>
__global__ void __launch_bounds__(kThreads)
margins_csc_kernel(const int* __restrict__ col_rows,
                   const TC* __restrict__ col_vals,
                   const int* __restrict__ idx, const TV* __restrict__ val,
                   int n, int k_max, int K, int A, int B, int range_rows,
                   int slice_len, float* __restrict__ part) {
  extern __shared__ float acc[];
  const int k = blockIdx.x;
  const int lo = blockIdx.y * range_rows;
  const int len = min(range_rows, B - lo);
  const int a0 = blockIdx.z * slice_len;
  const int a1 = min(A, a0 + slice_len);
  for (int i = threadIdx.x; i < len; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  const size_t model = static_cast<size_t>(k) * A;
  // the slice's (feature, slot) pairs, feature-major; fits an int (checked
  // by the launcher)
  const int n_pairs = max(a1 - a0, 0) * k_max;
  for (int f = threadIdx.x; f < n_pairs; f += kThreads) {
    const int a = a0 + f / k_max;
    const int j = idx[model + a];
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(n)) continue;
    const size_t slot =
        static_cast<size_t>(j) * k_max + (f - (a - a0) * k_max);
    const int r = col_rows[slot] - lo;
    if (static_cast<unsigned>(r) < static_cast<unsigned>(len)) {
      atomicAdd(&acc[r], to_float(val[model + a]) * to_float(col_vals[slot]));
    }
  }
  __syncthreads();
  float* dst = part + (static_cast<size_t>(blockIdx.z) * K + k) * B + lo;
  for (int i = threadIdx.x; i < len; i += kThreads) dst[i] = acc[i];
}

// out[e] = sum over slices s of part[s, e], in slice order (e < K * B)
__global__ void __launch_bounds__(kSumThreads)
margins_csc_sum_kernel(const float* __restrict__ part, int n_slices,
                       size_t n_out, float* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kSumThreads +
                   threadIdx.x;
  if (e >= n_out) return;
  float t = 0.0f;
  for (int s = 0; s < n_slices; ++s) t += part[s * n_out + e];
  out[e] = t;
}

template <typename TC, typename TV>
int launch(const int* col_rows, const TC* col_vals, const int* idx,
           const TV* val, int n, int k_max, int K, int A, int B,
           int n_slices, float* part, float* out, cudaStream_t stream) {
  if (n < 1 || k_max < 1 || K < 1 || A < 1 || B < 1 || n_slices < 1 ||
      n_slices > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_ranges = (B + kMaxRangeRows - 1) / kMaxRangeRows;
  const int range_rows = (B + n_ranges - 1) / n_ranges;
  const int slice_len = (A + n_slices - 1) / n_slices;
  const size_t smem = static_cast<size_t>(range_rows) * sizeof(float);
  if (n_ranges > 65535 ||
      static_cast<long long>(slice_len) * k_max > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        margins_csc_kernel<TC, TV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(K, n_ranges, n_slices);
  margins_csc_kernel<TC, TV><<<grid, kThreads, smem, stream>>>(
      col_rows, col_vals, idx, val, n, k_max, K, A, B, range_rows,
      slice_len, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_out = static_cast<size_t>(K) * B;
  const size_t blocks = (n_out + kSumThreads - 1) / kSumThreads;
  margins_csc_sum_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0,
                           stream>>>(part, n_slices, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// col_vals and val each float32 or bfloat16: four entry points, named
// serve_margins_csc_<col_vals type>_<val type>; part is the (n_slices, K,
// B) scratch, out is (K, B) float32
#define MARGINS_CSC_ENTRY(NAME, TC, TV)                                    \
  extern "C" int NAME(const int* col_rows, const void* col_vals,           \
                      const int* idx, const void* val, int n, int k_max,   \
                      int K, int A, int B, int n_slices, float* part,      \
                      float* out, void* stream) {                          \
    return launch<TC, TV>(col_rows, static_cast<const TC*>(col_vals), idx, \
                          static_cast<const TV*>(val), n, k_max, K, A, B,  \
                          n_slices, part, out,                             \
                          static_cast<cudaStream_t>(stream));              \
  }

MARGINS_CSC_ENTRY(serve_margins_csc_f32_f32, float, float)
MARGINS_CSC_ENTRY(serve_margins_csc_f32_bf16, float, __nv_bfloat16)
MARGINS_CSC_ENTRY(serve_margins_csc_bf16_f32, __nv_bfloat16, float)
MARGINS_CSC_ENTRY(serve_margins_csc_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
