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

}  // namespace pcdn
