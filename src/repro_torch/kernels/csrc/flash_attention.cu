// K6: flash-attention forward for Hopper.
//
// Replaces the Pallas kernel `flash_attention_kernel` (body `_kernel`) in
// src/repro/kernels/flash_attention.py. For every (batch, head) and query
// row i:
//
//   o[i] = sum_j softmax_j(q[i] . k[j] * scale, masked) v[j]
//
// with f32 accumulation and o in q's type. Masks: causal `i >= j` aligned
// top-left (both positions count from 0, as the Pallas kernel and
// `ref.attention_ref` have it), keys j >= Skv, and nothing is written for
// rows i >= Sq, so any Sq and Skv work: the Pallas wrapper needed both to
// be multiples of its tile and fell back to the dense reference otherwise.
// KV tiles strictly above the diagonal are skipped (j0 > i0 + Bq - 1).
// Grouped-query attention indexes kv head h / G, so kv heads are never
// copied out to the query heads. Every tensor is addressed through
// (batch, head, row) strides with a contiguous last dim, so the model's
// (B, S, H, D) projections go in without a transpose.
//
// Bound on the H100: operations. 4 * Sq * Skv * D flops a (batch, head)
// (halved when causal) against q, k, v and o read or written once: at the
// qwen2-0.5b prefill shape (56 heads, S 4096, D 64, bf16) about 1.2e11
// flops and 67 MB, 0.12 ms at the 989 TFLOP/s bf16 tensor-core peak and
// 0.02 ms at 3.35 TB/s.
//
// Design: one block per (64 query rows, batch * head), the heaviest causal
// tiles launched first. The block keeps its Q tile and one K and one V
// tile of 64 rows in shared memory (rows padded by 8 elements so the
// fragment loads hit distinct banks) and walks the KV tiles with an
// online softmax: a running max and normaliser per row and f32 output
// accumulators in registers. Masked scores are -inf and their
// probabilities exactly 0; the running max starts at -1e30 as in the
// Pallas kernel, and a row that saw no key returns 0 through the same
// max(l, 1e-30) guard.
//   * bf16: four warps, each owning 16 query rows, issue
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate) for S = Q K^T and for
//     O += P V. The S accumulators of two neighbouring 8-key tiles are the
//     A operand of P V, so P never leaves the registers. As in the Pallas
//     kernel (flash_attention.py:64), p goes into P V cast to v's type
//     and the normaliser sums it in f32.
//   * f32: 256 threads on the CUDA cores (a tensor-core product would
//     round the operands to tf32). Each thread computes a 4 x 4 piece of
//     the 64 x 64 score tile; one warp per 8 rows does the softmax in a
//     shared-memory score tile; each thread then owns 4 rows x D/16
//     columns of O.
// No cp.async, TMA or wgmma yet: loads and products do not overlap.
#include <cmath>
#include <cstdint>

#include "common.cuh"

using namespace pcdn;

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;   // the running max's start, as in Pallas

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, G, Sq, Skv, causal;
  float scale;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
};

// the block's query tile (heaviest causal tiles first) and how many KV
// tiles it visits: all of them, or those not strictly above the diagonal
__device__ __forceinline__ int q_tile_index() {
  return gridDim.x - 1 - blockIdx.x;
}

__device__ __forceinline__ int kv_tiles(const Args& a, int q0) {
  const int all = (a.Skv + kBlockK - 1) / kBlockK;
  if (!a.causal) return all;
  return min(all, (q0 + kBlockQ - 1) / kBlockK + 1);
}

template <typename T>
__device__ __forceinline__ void head_ptrs(const Args& a, const T*& q,
                                          const T*& k, const T*& v, T*& o) {
  const int bh = blockIdx.y;
  const long long b = bh / a.H;
  const long long h = bh % a.H;
  const long long hk = h / a.G;
  q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
}

// ---------------------------------------------------------------- bf16 ---

constexpr int kWarpsBf16 = 4;                   // 16 query rows a warp
constexpr int kThreadsBf16 = kWarpsBf16 * 32;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [0, n_valid) of a 64-row tile from global (row stride ss) into
// shared memory (row stride LD), 16 bytes a thread; the rest zero
template <int D, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long ss, int n_valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) {
      val = *reinterpret_cast<const uint4*>(src + r * ss + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
flash_bf16_kernel(const Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockQ * LD;
  __nv_bfloat16* Vs = Ks + kBlockK * LD;
  const unsigned short* Vh = reinterpret_cast<const unsigned short*>(Vs);

  const __nv_bfloat16 *qg, *kg, *vg;
  __nv_bfloat16* og;
  head_ptrs(a, qg, kg, vg, og);
  const int q0 = q_tile_index() * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;        // fragment row group
  const int t = lane & 3;         // thread in the group
  const int wr = warp * 16;       // the warp's first row in the tile
  const int row0 = q0 + wr + g;   // this thread's two query positions
  const int row1 = row0 + 8;

  load_tile_bf16<D, LD>(Qs, qg + q0 * a.q_ss, a.q_ss, a.Sq - q0);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  const int n_kv = kv_tiles(a, q0);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();              // the previous tile's readers are done
    load_tile_bf16<D, LD>(Ks, kg + k0 * a.k_ss, a.k_ss, a.Skv - k0);
    load_tile_bf16<D, LD>(Vs, vg + k0 * a.v_ss, a.v_ss, a.Skv - k0);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys: 8 tiles of 16 x 8
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qp = Qs + (wr + g) * LD + kk * 16 + 2 * t;
      const uint32_t af[4] = {ld32(qp), ld32(qp + 8 * LD), ld32(qp + 8),
                              ld32(qp + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], af, ld32(kp), ld32(kp + 8));
      }
    }

    // scale, mask, the tile's row max over the quad that shares the rows
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + n * 8 + 2 * t + (c & 1);
        const int row = c < 2 ? row0 : row1;
        const bool ok = col < a.Skv && (!a.causal || row >= col);
        const float val = ok ? s[n][c] * a.scale : -INFINITY;
        s[n][c] = val;
        if (c < 2) {
          mx0 = fmaxf(mx0, val);
        } else {
          mx1 = fmaxf(mx1, val);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0);
    const float corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    // per-thread partial normalisers; the quad sums them at the end
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }

    // O += P V: P (16 x 64) from the S accumulators, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const unsigned short* vr = Vh + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const unsigned short* vp = vr + n * 8;
        const uint32_t b0 = static_cast<uint32_t>(vp[0]) |
                            (static_cast<uint32_t>(vp[LD]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(vp[8 * LD]) |
                            (static_cast<uint32_t>(vp[9 * LD]) << 16);
        mma_bf16(o[n], pf, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  if (row0 < a.Sq) {
    __nv_bfloat16* orow = og + row0 * a.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    }
  }
  if (row1 < a.Sq) {
    __nv_bfloat16* orow = og + row1 * a.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int kThreadsF32 = 256;
constexpr int kSLD = kBlockK + 1;   // score tile row stride

// rows [0, n_valid) of a 64-row tile into shared memory (row stride LD,
// odd, so column reads across rows hit distinct banks); the rest zero
template <int D, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long ss, int n_valid) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreadsF32) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n_valid) val = *reinterpret_cast<const float4*>(src + r * ss + c);
    float* d = dst + r * LD + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_f32_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int kCols = D / 16;     // O columns a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ss = Vs + kBlockK * LD;           // scores, then probabilities
  float* m_s = Ss + kBlockQ * kSLD;        // running max per row
  float* l_s = m_s + kBlockQ;              // running normaliser per row
  float* c_s = l_s + kBlockQ;              // this tile's correction

  const float *qg, *kg, *vg;
  float* og;
  head_ptrs(a, qg, kg, vg, og);
  const int q0 = q_tile_index() * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;          // rows 4 ty .. 4 ty + 3
  const int tx = tid & 15;          // columns tx + 16 c
  const int warp = tid >> 5;
  const int lane = tid & 31;

  load_tile_f32<D, LD>(Qs, qg + q0 * a.q_ss, a.q_ss, a.Sq - q0);
  if (tid < kBlockQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  float o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.0f;
  }

  const int n_kv = kv_tiles(a, q0);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();
    load_tile_f32<D, LD>(Ks, kg + k0 * a.k_ss, a.k_ss, a.Skv - k0);
    load_tile_f32<D, LD>(Vs, vg + k0 * a.v_ss, a.v_ss, a.Skv - k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        const bool ok = col < a.Skv && (!a.causal || row >= col);
        Ss[(4 * ty + i) * kSLD + tx + 16 * c] =
            ok ? s[i][c] * a.scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8 w .. 8 w + 7, two keys a lane
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      float* sr = Ss + r * kSLD;
      const float v0 = sr[lane];
      const float v1 = sr[lane + 32];
      float mx = fmaxf(v0, v1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(v0 - m_new);
      const float p1 = expf(v1 - m_new);
      const float sum = warp_sum(p0 + p1);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[4 * ty + i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(4 * ty + i) * kSLD + kk];
      const float* vr = Vs + kk * LD + tx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vr[16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(p[i], vv, o[i][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (q0 + r < a.Sq) {
      const float inv = 1.0f / fmaxf(l_s[r], 1e-30f);
      float* orow = og + (q0 + r) * a.o_ss + tx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) orow[16 * c] = o[i][c] * inv;
    }
  }
}

// --------------------------------------------------------------- launch ---

template <typename T>
struct Kernel;

template <>
struct Kernel<__nv_bfloat16> {
  template <int D>
  static void* fn() { return reinterpret_cast<void*>(flash_bf16_kernel<D>); }
  static constexpr int threads = kThreadsBf16;
  static constexpr size_t smem(int D) {
    return static_cast<size_t>(kBlockQ + 2 * kBlockK) * (D + 8) * 2;
  }
  template <int D>
  static void launch(dim3 grid, size_t bytes, cudaStream_t st,
                     const Args& a) {
    flash_bf16_kernel<D><<<grid, threads, bytes, st>>>(a);
  }
};

template <>
struct Kernel<float> {
  template <int D>
  static void* fn() { return reinterpret_cast<void*>(flash_f32_kernel<D>); }
  static constexpr int threads = kThreadsF32;
  static constexpr size_t smem(int D) {
    return (static_cast<size_t>(kBlockQ + 2 * kBlockK) * (D + 1) +
            kBlockQ * kSLD + 3 * kBlockQ) * 4;
  }
  template <int D>
  static void launch(dim3 grid, size_t bytes, cudaStream_t st,
                     const Args& a) {
    flash_f32_kernel<D><<<grid, threads, bytes, st>>>(a);
  }
};

template <typename T, int D>
int launch_d(const Args& a, int BH, cudaStream_t stream) {
  const size_t bytes = Kernel<T>::smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      Kernel<T>::template fn<D>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, BH);
  Kernel<T>::template launch<D>(grid, bytes, stream, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int G, int Sq, int Skv, int D, int causal, float scale,
           const long long* st, cudaStream_t stream) {
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || Sq < 1 || Skv < 1 ||
      static_cast<long long>(B) * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, H, G, Sq, Skv, causal, scale,
               st[0], st[1], st[2], st[3], st[4], st[5],
               st[6], st[7], st[8], st[9], st[10], st[11]};
  switch (D) {
    case 64: return launch_d<T, 64>(a, B * H, stream);
    case 128: return launch_d<T, 128>(a, B * H, stream);
    case 256: return launch_d<T, 256>(a, B * H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: (batch, head, row) of q, k, v and o, in elements, 12 in all;
// heads H of q, G query heads per kv head; D in {64, 128, 256}
#define FLASH_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      int B, int H, int G, int Sq, int Skv, int D,          \
                      int causal, float scale, const long long* strides,    \
                      void* stream) {                                       \
    return launch<T>(q, k, v, o, B, H, G, Sq, Skv, D, causal, scale,        \
                     strides, static_cast<cudaStream_t>(stream));           \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
