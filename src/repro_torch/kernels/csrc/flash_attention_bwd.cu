// K6b: flash-attention backward for Hopper.
//
// No Pallas kernel: it replaces the reference's flash backward
// `_flash_mha_bwd` (src/repro/models/attention.py:258), the custom_vjp
// backward of the blockwise attention that K6's forward (`_flash_fwd_scan`
// there, `flash_attention_kernel` in Pallas) computes. From q, k, v, the
// forward's output o and row log-sum-exp lse, and the output's gradient
// dO, for every (batch, head):
//
//   delta_i = sum_d dO[i, d] o[i, d]
//   p_ij    = exp(q_i . k_j * scale - lse_i)      (masked: 0)
//   ds_ij   = p_ij (dO_i . v_j - delta_i)
//   dq_i    = scale * sum_j ds_ij k_j
//   dk_j    = scale * sum_{g, i} ds_ij q_i,   dv_j = sum_{g, i} p_ij dO_i
//
// with dk and dv summed over the G query heads that share kv head h / G,
// f32 throughout (the reference's backward widens every operand), and
// dq, dk, dv written in the inputs' type. Masks as K6's: causal `i >= j`
// aligned top-left, keys j >= Skv and rows i >= Sq, so any Sq and Skv;
// tiles wholly above the diagonal are skipped.
//
// Deterministic, with no floating-point atomics: two launches.
//   * dQ pass: a block per (batch * head, BM query rows). It forms delta
//     for its rows (a warp a row, a fixed butterfly), writes it to the
//     (B, H, Sq) scratch, then walks the KV tiles up to the diagonal:
//     S = Q K^T and dP = dO V^T, P and dS in shared memory, dQ += dS K.
//   * dK/dV pass: a block per (batch * kv head, BN keys), walking the G
//     query heads of its kv head and, for each, the query tiles from the
//     diagonal on: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in shared
//     memory, dV += P^T dO, dK += dS^T Q. Every sum has one order, so
//     two calls are bit-equal.
// S and dP are formed in both passes: 7 products of 2 S^2 D a head where
// 5 would do.
//
// Bound on the H100: operations. 5 products of 2 D flops for each
// (query, key) pair the mask lets through: at the qwen2-0.5b train shape
// (B 4, S 4096, 14 heads over 2, D 64, bf16, causal) 3.0e11 flops, 0.30
// ms at the 989 TFLOP/s bf16 tensor-core peak, against 135 MB moved
// (0.04 ms at 3.35 TB/s). This first design runs every product on the
// CUDA cores in f32 from shared memory (each thread a 4 x 4 piece of a
// 64 x 64 tile, BM = BN = 64 at D 64 and 128, 32 at D 256 so the four
// f32 tiles fit), so it is far from that bound; a tensor-core (mma.sync
// or wgmma) design is later work.
#include <cmath>
#include <cstdint>

#include "common.cuh"

using namespace pcdn;

namespace {

constexpr int kThreads = 256;       // a 16 x 16 grid of threads

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                 // (B, H, Sq)
  float* delta;                     // (B, H, Sq) scratch
  void* dq;
  void* dk;
  void* dv;
  int H, G, Sq, Skv, causal;
  float scale;
  // (batch, head, row) strides in elements of q, k, v, o, dO, dq, dk, dv
  long long st[24];
};

template <int D>
struct Tile {
  static constexpr int kB = D <= 128 ? 64 : 32;   // rows a tile (BM = BN)
  static constexpr int kR = kB / 16;               // rows a thread
  static constexpr int kC = D / 16;                // columns a thread
  static constexpr int kLD = D + 1;                // odd: no bank conflicts
  static constexpr int kPLD = kB + 1;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [r0, r0 + kB) of a (row stride ss) head into dst (row stride LD)
// as f32; rows >= n_valid are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ss, int r0,
                                          int n_valid) {
  using L = Tile<D>;
  for (int e = threadIdx.x; e < L::kB * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    dst[r * L::kLD + d] =
        r0 + r < n_valid ? to_float(src[(r0 + r) * ss + d]) : 0.0f;
  }
}

// KV tiles of kB keys that query rows [q0, q0 + kB) visit
__device__ __forceinline__ int kv_tiles(const Args& a, int q0, int b) {
  const int all = (a.Skv + b - 1) / b;
  if (!a.causal) return all;
  return min(all, (q0 + b - 1) / b + 1);
}

// ------------------------------------------------------------- dQ pass ---

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const Args a) {
  using L = Tile<D>;
  constexpr int B = L::kB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + B * L::kLD;
  float* Ks = dOs + B * L::kLD;
  float* Vs = Ks + B * L::kLD;
  float* dSs = Vs + B * L::kLD;        // B x kPLD
  float* lse_s = dSs + B * L::kPLD;
  float* delta_s = lse_s + B;

  const int bh = blockIdx.x;
  const long long b = bh / a.H;
  const long long h = bh % a.H;
  const long long hk = h / a.G;
  const long long* st = a.st;
  const T* q = static_cast<const T*>(a.q) + b * st[0] + h * st[1];
  const T* k = static_cast<const T*>(a.k) + b * st[3] + hk * st[4];
  const T* v = static_cast<const T*>(a.v) + b * st[6] + hk * st[7];
  const T* o = static_cast<const T*>(a.o) + b * st[9] + h * st[10];
  const T* dO = static_cast<const T*>(a.dout) + b * st[12] + h * st[13];
  T* dq = static_cast<T*>(a.dq) + b * st[15] + h * st[16];
  const float* lse = a.lse + bh * static_cast<long long>(a.Sq);
  float* delta = a.delta + bh * static_cast<long long>(a.Sq);

  const int q0 = (gridDim.y - 1 - blockIdx.y) * B;   // heavy tiles first
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  load_rows<T, D>(Qs, q, st[2], q0, a.Sq);
  load_rows<T, D>(dOs, dO, st[14], q0, a.Sq);
  // delta a warp a row; rows past Sq read p = 0 through lse = +inf
  for (int r = warp; r < B; r += kThreads / 32) {
    const int i = q0 + r;
    float acc = 0.0f;
    if (i < a.Sq) {
      for (int d = lane; d < D; d += 32) {
        acc = fmaf(to_float(dO[i * st[14] + d]), to_float(o[i * st[11] + d]),
                   acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = i < a.Sq ? lse[i] : INFINITY;
      if (i < a.Sq) delta[i] = acc;
    }
  }

  float acc[L::kR][L::kC];
#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
#pragma unroll
    for (int c = 0; c < L::kC; ++c) acc[i][c] = 0.0f;
  }

  const int n_kv = kv_tiles(a, q0, B);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * B;
    __syncthreads();
    load_rows<T, D>(Ks, k, st[5], k0, a.Skv);
    load_rows<T, D>(Vs, v, st[8], k0, a.Skv);
    __syncthreads();

    // S and dP for rows ty + 16 i, keys tx + 16 c
    float s[L::kR][L::kR], dp[L::kR][L::kR];
#pragma unroll
    for (int i = 0; i < L::kR; ++i) {
#pragma unroll
      for (int c = 0; c < L::kR; ++c) s[i][c] = dp[i][c] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[L::kR], gv[L::kR], kv[L::kR], vv[L::kR];
#pragma unroll
      for (int i = 0; i < L::kR; ++i) {
        qv[i] = Qs[(ty + 16 * i) * L::kLD + d];
        gv[i] = dOs[(ty + 16 * i) * L::kLD + d];
        kv[i] = Ks[(tx + 16 * i) * L::kLD + d];
        vv[i] = Vs[(tx + 16 * i) * L::kLD + d];
      }
#pragma unroll
      for (int i = 0; i < L::kR; ++i) {
#pragma unroll
        for (int c = 0; c < L::kR; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(gv[i], vv[c], dp[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < L::kR; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int c = 0; c < L::kR; ++c) {
        const int col = k0 + tx + 16 * c;
        const bool ok = col < a.Skv && (!a.causal || row >= col);
        const float p = ok ? expf(s[i][c] * a.scale - lse_s[r]) : 0.0f;
        dSs[r * L::kPLD + tx + 16 * c] = p * (dp[i][c] - delta_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS K for rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < B; ++kk) {
      float ds[L::kR];
#pragma unroll
      for (int i = 0; i < L::kR; ++i) ds[i] = dSs[(ty + 16 * i) * L::kPLD + kk];
      const float* kr = Ks + kk * L::kLD + tx;
#pragma unroll
      for (int c = 0; c < L::kC; ++c) {
        const float kvv = kr[16 * c];
#pragma unroll
        for (int i = 0; i < L::kR; ++i) acc[i][c] = fmaf(ds[i], kvv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < a.Sq) {
      T* dr = dq + row * st[17] + tx;
#pragma unroll
      for (int c = 0; c < L::kC; ++c) store(dr + 16 * c, acc[i][c] * a.scale);
    }
  }
}

// ---------------------------------------------------------- dK/dV pass ---

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const Args a) {
  using L = Tile<D>;
  constexpr int B = L::kB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + B * L::kLD;
  float* Qs = Vs + B * L::kLD;
  float* dOs = Qs + B * L::kLD;
  float* Pt = dOs + B * L::kLD;        // B keys x kPLD
  float* dSt = Pt + B * L::kPLD;
  float* lse_s = dSt + B * L::kPLD;
  float* delta_s = lse_s + B;

  const int Kv = a.H / a.G;
  const long long b = blockIdx.x / Kv;
  const long long hk = blockIdx.x % Kv;
  const long long* st = a.st;
  const T* k = static_cast<const T*>(a.k) + b * st[3] + hk * st[4];
  const T* v = static_cast<const T*>(a.v) + b * st[6] + hk * st[7];
  T* dk = static_cast<T*>(a.dk) + b * st[18] + hk * st[19];
  T* dv = static_cast<T*>(a.dv) + b * st[21] + hk * st[22];

  const int k0 = blockIdx.y * B;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  load_rows<T, D>(Ks, k, st[5], k0, a.Skv);
  load_rows<T, D>(Vs, v, st[8], k0, a.Skv);

  float acc_k[L::kR][L::kC], acc_v[L::kR][L::kC];
#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
#pragma unroll
    for (int c = 0; c < L::kC; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;
  }

  const int n_q = (a.Sq + B - 1) / B;
  const int first = a.causal ? k0 / B : 0;   // rows >= k0 see these keys
  for (int g = 0; g < a.G; ++g) {
    const long long h = hk * a.G + g;
    const T* q = static_cast<const T*>(a.q) + b * st[0] + h * st[1];
    const T* dO = static_cast<const T*>(a.dout) + b * st[12] + h * st[13];
    const long long row_base = (b * a.H + h) * a.Sq;
    for (int t = first; t < n_q; ++t) {
      const int q0 = t * B;
      __syncthreads();
      load_rows<T, D>(Qs, q, st[2], q0, a.Sq);
      load_rows<T, D>(dOs, dO, st[14], q0, a.Sq);
      for (int r = tid; r < B; r += kThreads) {
        const int i = q0 + r;
        lse_s[r] = i < a.Sq ? a.lse[row_base + i] : INFINITY;
        delta_s[r] = i < a.Sq ? a.delta[row_base + i] : 0.0f;
      }
      __syncthreads();

      // S^T and dP^T for keys ty + 16 i, query rows tx + 16 c
      float s[L::kR][L::kR], dp[L::kR][L::kR];
#pragma unroll
      for (int i = 0; i < L::kR; ++i) {
#pragma unroll
        for (int c = 0; c < L::kR; ++c) s[i][c] = dp[i][c] = 0.0f;
      }
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[L::kR], vv[L::kR], qv[L::kR], gv[L::kR];
#pragma unroll
        for (int i = 0; i < L::kR; ++i) {
          kv[i] = Ks[(ty + 16 * i) * L::kLD + d];
          vv[i] = Vs[(ty + 16 * i) * L::kLD + d];
          qv[i] = Qs[(tx + 16 * i) * L::kLD + d];
          gv[i] = dOs[(tx + 16 * i) * L::kLD + d];
        }
#pragma unroll
        for (int i = 0; i < L::kR; ++i) {
#pragma unroll
          for (int c = 0; c < L::kR; ++c) {
            s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
            dp[i][c] = fmaf(vv[i], gv[c], dp[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < L::kR; ++i) {
        const int r = ty + 16 * i;
        const int col = k0 + r;               // the key
#pragma unroll
        for (int c = 0; c < L::kR; ++c) {
          const int qr = tx + 16 * c;
          const int row = q0 + qr;            // the query
          const bool ok = col < a.Skv && (!a.causal || row >= col);
          const float p = ok ? expf(s[i][c] * a.scale - lse_s[qr]) : 0.0f;
          Pt[r * L::kPLD + qr] = p;
          dSt[r * L::kPLD + qr] = p * (dp[i][c] - delta_s[qr]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q for keys ty + 16 i, columns tx + 16 c
#pragma unroll 4
      for (int qq = 0; qq < B; ++qq) {
        float pv[L::kR], dsv[L::kR];
#pragma unroll
        for (int i = 0; i < L::kR; ++i) {
          pv[i] = Pt[(ty + 16 * i) * L::kPLD + qq];
          dsv[i] = dSt[(ty + 16 * i) * L::kPLD + qq];
        }
        const float* gr = dOs + qq * L::kLD + tx;
        const float* qr = Qs + qq * L::kLD + tx;
#pragma unroll
        for (int c = 0; c < L::kC; ++c) {
          const float gvv = gr[16 * c];
          const float qvv = qr[16 * c];
#pragma unroll
          for (int i = 0; i < L::kR; ++i) {
            acc_v[i][c] = fmaf(pv[i], gvv, acc_v[i][c]);
            acc_k[i][c] = fmaf(dsv[i], qvv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < a.Skv) {
      T* kr = dk + key * st[20] + tx;
      T* vr = dv + key * st[23] + tx;
#pragma unroll
      for (int c = 0; c < L::kC; ++c) {
        store(kr + 16 * c, acc_k[i][c] * a.scale);
        store(vr + 16 * c, acc_v[i][c]);
      }
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  using L = Tile<D>;
  return (4 * L::kB * L::kLD + L::kB * L::kPLD + 2 * L::kB) * sizeof(float);
}

template <int D>
constexpr size_t dkdv_smem() {
  using L = Tile<D>;
  return (4 * L::kB * L::kLD + 2 * L::kB * L::kPLD + 2 * L::kB) *
         sizeof(float);
}

template <typename T, int D>
int launch_d(const Args& a, int B, cudaStream_t stream) {
  constexpr int kB = Tile<D>::kB;
  constexpr size_t dq_bytes = dq_smem<D>();
  constexpr size_t kv_bytes = dkdv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(B * a.H, (a.Sq + kB - 1) / kB);
  bwd_dq_kernel<T, D><<<grid_q, kThreads, dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(B * (a.H / a.G), (a.Skv + kB - 1) / kB);
  bwd_dkdv_kernel<T, D><<<grid_kv, kThreads, kv_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int G, int Sq, int Skv, int D,
           int causal, float scale, const long long* st,
           cudaStream_t stream) {
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || Sq < 1 || Skv < 1 ||
      (Sq + 31) / 32 > 65535 || (Skv + 31) / 32 > 65535 ||
      static_cast<long long>(B) * H > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, H, G, Sq, Skv, causal,
         scale, {}};
  for (int i = 0; i < 24; ++i) a.st[i] = st[i];
  switch (D) {
    case 64: return launch_d<T, 64>(a, B, stream);
    case 128: return launch_d<T, 128>(a, B, stream);
    case 256: return launch_d<T, 256>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o, dO, lse (B, H, Sq) float32, delta (B, H, Sq) float32
// scratch, dq, dk, dv; B batches of H query heads, G query heads per kv
// head; strides: (batch, head, row) of q, k, v, o, dO, dq, dk, dv in
// elements, 24 in all
#define FLASH_BWD_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* o, const void* dout, const void* lse,     \
                      void* delta, void* dq, void* dk, void* dv, int B,     \
                      int H, int G, int Sq, int Skv, int D, int causal,     \
                      float scale, const long long* strides,                \
                      void* stream) {                                       \
    return launch<T>(q, k, v, o, dout, static_cast<const float*>(lse),      \
                     static_cast<float*>(delta), dq, dk, dv, B, H, G, Sq,   \
                     Skv, D, causal, scale, strides,                        \
                     static_cast<cudaStream_t>(stream));                    \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_f32, float)
FLASH_BWD_ENTRY(flash_attention_bwd_bf16, __nv_bfloat16)
