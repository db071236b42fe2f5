// Device helpers shared by the PCDN kernels (K1-K3) of the PyTorch port.
//
// The losses and the Eq. 5 direction are written exactly as the plain
// PyTorch versions compute them (repro_torch/core/losses.py, direction.py):
// the stable softplus form of the logistic loss, expf/log1pf (the sources
// are built without --use_fast_math), the Hessian floor applied after the
// elastic-net fold, and Eq. 5's branch order (g + 1 <= h w first).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pcdn {

constexpr float kHessianFloor = 1e-12f;

// loss kinds, numbered as kernels/ops.py passes them
constexpr int kLogistic = 0;
constexpr int kSquaredHinge = 1;
constexpr int kSquared = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// butterfly sum: every lane ends with the same total, in a fixed order
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

__device__ __forceinline__ float sigmoid(float m) {
  return 1.0f / (1.0f + expf(-m));
}

// phi(z, y)
__device__ __forceinline__ float phi(int kind, float z, float y) {
  if (kind == kLogistic) {
    const float m = -y * z;
    return fmaxf(m, 0.0f) + log1pf(expf(-fabsf(m)));
  }
  if (kind == kSquaredHinge) {
    const float t = fmaxf(1.0f - y * z, 0.0f);
    return t * t;
  }
  const float t = z - y;
  return 0.5f * (t * t);
}

// d phi / d z
__device__ __forceinline__ float dphi(int kind, float z, float y) {
  if (kind == kLogistic) return (sigmoid(y * z) - 1.0f) * y;
  if (kind == kSquaredHinge) return -2.0f * y * fmaxf(1.0f - y * z, 0.0f);
  return z - y;
}

// d^2 phi / d z^2 (generalized for the squared hinge)
__device__ __forceinline__ float d2phi(int kind, float z, float y) {
  if (kind == kLogistic) {
    const float t = sigmoid(y * z);
    return t * (1.0f - t);
  }
  if (kind == kSquaredHinge) return (y * z < 1.0f) ? 2.0f : 0.0f;
  return 1.0f;
}

// c phi'(z, y) and c phi''(z, y) together: the values of dphi and d2phi,
// the logistic sigmoid formed once
__device__ __forceinline__ void loss_factors(int kind, float c, float z,
                                             float y, float& u, float& v) {
  if (kind == kLogistic) {
    const float t = sigmoid(y * z);
    u = c * ((t - 1.0f) * y);
    v = c * (t * (1.0f - t));
    return;
  }
  u = c * dphi(kind, z, y);
  v = c * d2phi(kind, z, y);
}

// max(h, floor) that keeps a NaN, as torch.clamp_min does
__device__ __forceinline__ float hessian_floor(float h) {
  return (h < kHessianFloor) ? kHessianFloor : h;
}

// Eq. 5 soft-threshold Newton direction, branches in the paper's order
__device__ __forceinline__ float newton_direction(float g, float h, float w) {
  const float hw = h * w;
  if (g + 1.0f <= hw) return -(g + 1.0f) / h;
  if (g - 1.0f >= hw) return -(g - 1.0f) / h;
  return -w;
}

// The epilogue of a feature's reduction: the elastic-net fold, the Hessian
// floor, then Eq. 5. Returns d; g and h as folded.
__device__ __forceinline__ float fold_direction(float g_raw, float h_raw,
                                                float w, float l2, float& g,
                                                float& h) {
  g = g_raw + l2 * w;
  h = hessian_floor(h_raw + l2);
  return newton_direction(g, h, w);
}

// -- the per-feature gather-and-reduce of K1 and K2 --------------------------
//
// A warp takes a segment [k0, k1) of one feature's padded-CSC column and
// walks it in rounds of kUnroll entries a lane. A round issues all of its
// (row, value) loads first, then all of the z/y gathers at those rows, so
// it waits about two memory latencies, not two for each stride of 32.
// Rows outside [0, n_rows) (the sentinel) are marked -1 and add nothing.
constexpr int kUnroll = 4;

struct SegmentRound {
  int row[kUnroll];    // -1: padding or past the segment
  float x[kUnroll];
  float z[kUnroll];
  float y[kUnroll];
};

template <typename T>
__device__ __forceinline__ void load_round(SegmentRound& sr,
                                           const int* __restrict__ rows,
                                           const T* __restrict__ vals,
                                           int base, int k1,
                                           const float* __restrict__ z,
                                           const float* __restrict__ y,
                                           int n_rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < kUnroll; ++e) {
    const int k = base + e * 32 + lane;
    const bool in = k < k1;
    sr.row[e] = in ? rows[k] : -1;
    sr.x[e] = in ? to_float(vals[k]) : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < kUnroll; ++e) {
    const int r = sr.row[e];
    const bool live = r >= 0 && r < n_rows;
    sr.row[e] = live ? r : -1;
    sr.z[e] = live ? z[r] : 0.0f;
    sr.y[e] = live ? y[r] : 1.0f;
  }
}

// g += u x and h += v x^2 over a round's live entries, with u = c phi'(z)
// and v = c phi''(z) formed at each entry's row (the loss factors are
// never materialised over all samples)
__device__ __forceinline__ void accumulate_round(const SegmentRound& sr,
                                                 float c, int kind,
                                                 float& acc_g, float& acc_h) {
#pragma unroll
  for (int e = 0; e < kUnroll; ++e) {
    if (sr.row[e] >= 0) {
      const float x = sr.x[e];
      acc_g += (c * dphi(kind, sr.z[e], sr.y[e])) * x;
      acc_h += (c * d2phi(kind, sr.z[e], sr.y[e])) * (x * x);
    }
  }
}

// -- fixed-order sums of scattered entries (K1, K2) ---------------------------
//
// A bundle step adds x d for every live entry of its padded-CSC slab into
// the entry's row. A float atomicAdd would sum a row's entries in an order
// that changes from run to run. Instead each entry writes its term and
// pushes itself onto its row's list (an integer atomicExch: `chain_push`),
// and after a barrier one thread a row sums the row's terms in ascending
// entry id (`ordered_chain_sum`) -- the order in which the plain versions'
// index_add_ adds them, the same in every run. Lists hold entry id + 1,
// so 0 ends a list and a zero-filled head array is empty.
constexpr int kChainSort = 64;  // list entries sorted in local memory

__device__ __forceinline__ void chain_push(int* head, int* next, int row,
                                           int e) {
  next[e] = atomicExch(head + row, e + 1);
}

// the terms of the list that starts at `first` (an id + 1), summed from
// 0.0f in ascending id. Each entry's term is loaded with its link, and
// the caller's own entry `own` (its link and term already in registers)
// costs no load, so a list of L entries holding it costs L - 1 dependent
// round trips
__device__ __forceinline__ float ordered_chain_sum(int first,
                                                   const int* next,
                                                   const float* term,
                                                   int own, int own_next,
                                                   float own_term) {
  int ids[kChainSort];
  float vals[kChainSort];
  int n = 0;
  for (int e1 = first; e1 != 0;) {
    if (n == kChainSort) {
      n = -1;
      break;
    }
    const int e = e1 - 1;
    const float t = e == own ? own_term : __ldcg(term + e);
    e1 = e == own ? own_next : __ldcg(next + e);
    int i = n++;
    while (i > 0 && ids[i - 1] > e) {  // insertion: ascending ids
      ids[i] = ids[i - 1];
      vals[i] = vals[i - 1];
      --i;
    }
    ids[i] = e;
    vals[i] = t;
  }
  float sum = 0.0f;
  if (n >= 0) {
    for (int i = 0; i < n; ++i) sum += vals[i];
    return sum;
  }
  // a longer list: a walk for each term, each finding the next larger id
  int last = -1;
  for (;;) {
    int best = 0x7fffffff;
    for (int e1 = first; e1 != 0; e1 = __ldcg(next + e1 - 1)) {
      const int e = e1 - 1;
      if (e > last && e < best) best = e;
    }
    if (best == 0x7fffffff) break;
    sum += __ldcg(term + best);
    last = best;
  }
  return sum;
}

}  // namespace pcdn
