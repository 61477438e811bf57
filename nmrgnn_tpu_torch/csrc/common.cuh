// Device code shared by banded.cu and poly.cu: the activations, float32 /
// bfloat16 element access, the band-row writer of the band builds, and the
// banded MP tile kernel (with or without its epilogue).
//
// bfloat16 follows the TPU kernels' mixed precision: operands are bf16,
// products and sums are float32 (a bf16 x bf16 product is exact in f32),
// and a value is rounded to bf16 (round to nearest even) only where the
// JAX kernel casts it: h before the second product, and the stored output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Act { kLinear = 0, kRelu = 1, kSoftplus = 2, kTanh = 3 };

// softplus as max(x, 0) + log1p(exp(-|x|)), the form of jax.nn.softplus.
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.0f);
    case kSoftplus:
      return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
    case kTanh:
      return tanhf(x);
    default:
      return x;
  }
}

// -- element access --------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the identity for float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Four consecutive elements (16-byte aligned for float, 8 for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned int*>(&a);
  u.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// -- band rows -------------------------------------------------------------

// One band row: out[n * channel_stride + w] = sum of ev[k * E + n] over
// the slots k with rel[k] == w, taken in slot order, for w in [0, W); the
// float32 sum is rounded once to OutT. Duplicate indices add; indices
// outside [0, W) (other windows, and -1 padding) match nothing.
template <int E, typename OutT>
__device__ __forceinline__ void band_row(const int* rel, const float* ev, int K, int W,
                                         OutT* out, size_t channel_stride, int tid,
                                         int nthreads) {
  for (int w = tid; w < W; w += nthreads) {
    float acc[E];
#pragma unroll
    for (int n = 0; n < E; ++n) acc[n] = 0.0f;
    for (int k = 0; k < K; ++k) {
      if (rel[k] == w) {
#pragma unroll
        for (int n = 0; n < E; ++n) acc[n] += ev[k * E + n];
      }
    }
#pragma unroll
    for (int n = 0; n < E; ++n) out[n * channel_stride + w] = from_f32<OutT>(acc[n]);
  }
}

// -- banded MP tile --------------------------------------------------------
//
// Replaces the bodies of _mp_banded_kernel (nmrgnn_tpu/ops/banded.py:
// 555-579) and, without the epilogue, _mp_banded_partial_kernel
// (:833-852):
//   acc = sum_n round_T(M[t, n] @ table[lo_t : lo_t + W]) @ w[n]
//   full:    out[tile rows] = T(act(acc * inv_degree) + table[tile rows])
//   partial: out[tile rows] = acc (float32)
// A block takes RB rows of one tile and all F columns, so neither product
// is recomputed by another block. The window (and then W_n) is staged
// through shared memory kMpChunk rows at a time, converted to float32,
// with the band values of all E channels for the block's rows; each
// thread accumulates a 4 x 4 register tile per channel. h_n = M_n @
// window goes through shared memory (rounded to T) into the second
// product. The products run as float32 FMA on the CUDA cores, so bf16
// halves the bytes read but not the arithmetic. Bound: bytes at the main
// path's shapes (the band is under 2% nonzero, so its nonzero products
// are few); the kernel does the dense products, 2*T*E*B*W*F +
// 2*T*E*B*F*F, which is what it actually spends its time on.

constexpr int kMpThreads = 256;
constexpr int kMpChunk = 16;

template <int F>
constexpr int mp_rows_per_block() {
  return (kMpThreads / (F / 4)) * 4;
}

template <int F, int E, typename T, bool kPartial>
__global__ void __launch_bounds__(kMpThreads)
    mp_banded_kernel(const T* __restrict__ M,      // [T, E, B, W]
                     const int* __restrict__ lo,   // [T]
                     const T* __restrict__ table,  // [n_table, F] window source
                     const T* __restrict__ w,      // [E, F, F]
                     const float* __restrict__ inv,  // [T*B] (full only)
                     void* __restrict__ out_,        // [T*B, F]: T, or float if partial
                     int B, int W, int n_table, int act) {
  constexpr int CG = F / 4;            // column groups of 4
  constexpr int RG = kMpThreads / CG;  // row groups of 4 rows
  constexpr int RB = RG * 4;           // rows per block
  __shared__ float4 s_stage[kMpChunk * CG];   // window rows, then W_n rows
  __shared__ float s_m[E][RB][kMpChunk];      // band values of the block's rows
  __shared__ float4 s_h[RB * CG];             // h_n = M_n @ window, [RB][F]

  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int rg = tid / CG;
  const int per_tile = B / RB;
  const int t = blockIdx.x / per_tile;
  const int r0 = (blockIdx.x - t * per_tile) * RB;
  const int base = lo[t];

  float h[E][4][4];
#pragma unroll
  for (int n = 0; n < E; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[n][i][j] = 0.0f;

  for (int w0 = 0; w0 < W; w0 += kMpChunk) {
    for (int i = tid; i < kMpChunk * CG; i += kMpThreads) {
      const int r = i / CG;
      const int c = i - r * CG;
      const int src = base + w0 + r;  // the plan keeps lo + W <= n_table
      s_stage[i] = (src >= 0 && src < n_table) ? load4(table + (size_t)src * F + c * 4)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = tid; i < E * RB * kMpChunk; i += kMpThreads) {
      const int n = i / (RB * kMpChunk);
      const int rem = i - n * RB * kMpChunk;
      const int r = rem / kMpChunk;
      const int c = rem - r * kMpChunk;
      s_m[n][r][c] = to_f32(M[((size_t)(t * E + n) * B + r0 + r) * W + w0 + c]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMpChunk; ++k) {
      const float4 v = s_stage[k * CG + cg];
#pragma unroll
      for (int n = 0; n < E; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float m = s_m[n][rg * 4 + i][k];
          h[n][i][0] = fmaf(m, v.x, h[n][i][0]);
          h[n][i][1] = fmaf(m, v.y, h[n][i][1]);
          h[n][i][2] = fmaf(m, v.z, h[n][i][2]);
          h[n][i][3] = fmaf(m, v.w, h[n][i][3]);
        }
    }
    __syncthreads();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const float* s_hf = reinterpret_cast<const float*>(s_h);
#pragma unroll
  for (int n = 0; n < E; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s_h[(rg * 4 + i) * CG + cg] =
          make_float4(round_to<T>(h[n][i][0]), round_to<T>(h[n][i][1]),
                      round_to<T>(h[n][i][2]), round_to<T>(h[n][i][3]));
    const T* wn = w + (size_t)n * F * F;
    for (int l0 = 0; l0 < F; l0 += kMpChunk) {
      for (int i = tid; i < kMpChunk * CG; i += kMpThreads)
        s_stage[i] = load4(wn + (size_t)l0 * F + i * 4);
      __syncthreads();  // also publishes this channel's s_h
#pragma unroll
      for (int k = 0; k < kMpChunk; ++k) {
        const float4 v = s_stage[k * CG + cg];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float hv = s_hf[(rg * 4 + i) * F + l0 + k];
          acc[i][0] = fmaf(hv, v.x, acc[i][0]);
          acc[i][1] = fmaf(hv, v.y, acc[i][1]);
          acc[i][2] = fmaf(hv, v.z, acc[i][2]);
          acc[i][3] = fmaf(hv, v.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)t * B + r0 + rg * 4 + i;
    if constexpr (kPartial) {
      store4(static_cast<float*>(out_) + row * F + cg * 4,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    } else {
      const float s = inv[row];
      const float4 res = load4(table + row * F + cg * 4);
      store4(static_cast<T*>(out_) + row * F + cg * 4,
             make_float4(activate(acc[i][0] * s, act) + res.x,
                         activate(acc[i][1] * s, act) + res.y,
                         activate(acc[i][2] * s, act) + res.z,
                         activate(acc[i][3] * s, act) + res.w));
    }
  }
}

template <int F, int E, typename T, bool kPartial>
cudaError_t launch_mp(const T* M, const int* lo, const T* table, const T* w, const float* inv,
                      void* out, int T_, int B, int W, int n_table, int act,
                      cudaStream_t stream) {
  constexpr int RB = mp_rows_per_block<F>();
  if (B % RB != 0) return cudaErrorInvalidValue;
  mp_banded_kernel<F, E, T, kPartial><<<T_ * (B / RB), kMpThreads, 0, stream>>>(
      M, lo, table, w, inv, out, B, W, n_table, act);
  return cudaGetLastError();
}

// Dispatch on the runtime (F, E) to the instantiated kernels.
template <typename T, bool kPartial>
cudaError_t launch_mp_any(int F, int E, const T* M, const int* lo, const T* table,
                          const T* w, const float* inv, void* out, int T_, int B, int W,
                          int n_table, int act, cudaStream_t s) {
  if (T_ < 1 || B < 1 || W < 1 || W % kMpChunk != 0 || n_table < 1)
    return cudaErrorInvalidValue;
#define NMR_MP_CASE(FF, EE)                                                              \
  if (F == FF && E == EE)                                                                \
    return launch_mp<FF, EE, T, kPartial>(M, lo, table, w, inv, out, T_, B, W, n_table, \
                                          act, s);
#define NMR_MP_F(FF) NMR_MP_CASE(FF, 1) NMR_MP_CASE(FF, 2) NMR_MP_CASE(FF, 3) NMR_MP_CASE(FF, 4)
  NMR_MP_F(64)
  NMR_MP_F(128)
  NMR_MP_F(256)
#undef NMR_MP_F
#undef NMR_MP_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
