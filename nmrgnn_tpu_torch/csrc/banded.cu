// Hand-written Hopper kernels for the band builds of the exact
// RCM-banded message-passing path of nmrgnn_tpu_torch (ops/banded.py
// holds the wrappers and the plain PyTorch version of each kernel).
//
// Built by ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the extern "C" functions at the end. Each
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.
//
// The MP layer's kernel, for every path, is in hbm.cu.
//
// All arithmetic is float32 on the CUDA cores; a bfloat16 compute type
// rounds the EdgeFC products' operands to bfloat16 and keeps them in
// float32, so each product is exact and every sum float32, and a bfloat16
// output rounds the float32 band once. There is no fast-math flag: expf,
// log1pf and tanhf are the accurate library versions, as the exact serving
// path needs.
//
// Layouts follow the JAX package: M is [T, E, B, W] (tile, edge channel,
// row in tile, window column), nodes are [N_pad, F], nlist [N_pad, K]
// with -1 on padded rows.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Band build. Replaces _build_band_kernel (nmrgnn_tpu/ops/banded.py:484-507)
// behind build_band (:510) and build_band_tracedlo (:788):
//   M[t, n, b, w] = sum_k e[tB + b, k, n] * [nlist[tB + b, k] == lo[t] + w]
// with lo read from device memory, so any caller-given window start works;
// an index outside [lo[t], lo[t] + W), negative ones included, matches no
// column. One block per band row; its K indices and K x E values sit in
// shared memory, and the threads walk the W columns, so every store is
// coalesced; the float32 sum is rounded once to OutT. Bound: the M write
// (T*E*B*W values of OutT); the compares are K per column.

constexpr int kBuildThreads = 128;
constexpr int kMaxK = 128;

template <int E, typename OutT>
__global__ void __launch_bounds__(kBuildThreads)
    build_band_kernel(const int* __restrict__ nlist,  // [T*B, K]
                      const float* __restrict__ e,    // [T*B, K, E]
                      const int* __restrict__ lo,     // [T]
                      OutT* __restrict__ M,           // [T, E, B, W]
                      int B, int K, int W) {
  __shared__ int s_rel[kMaxK];
  __shared__ float s_e[kMaxK * E];
  const int row = blockIdx.x;
  const int t = row / B;
  const int b = row - t * B;
  const int base = lo[t];
  for (int i = threadIdx.x; i < K; i += kBuildThreads)
    s_rel[i] = nlist[(size_t)row * K + i] - base;
  for (int i = threadIdx.x; i < K * E; i += kBuildThreads)
    s_e[i] = e[(size_t)row * K * E + i];
  __syncthreads();
  band_row<E, OutT>(s_rel, s_e, K, W, M + ((size_t)t * E * B + b) * W, (size_t)B * W,
                    threadIdx.x, kBuildThreads);
}

// ---------------------------------------------------------------------------
// Fused edge stage. Replaces _fused_edge_band_kernel
// (nmrgnn_tpu/ops/banded.py:1107-1170): RBF of the distances, the hidden
// EdgeFC layers (Dense H x H + activation), the final Dense H x E, the
// d > 0 mask, then the band build, without writing the [N, K, H]
// activations to device memory.
//
// A block takes 128 consecutive edge slots (128 / K atoms). Its
// activations live in shared memory feature-major (xT[h][s]), the current
// layer's [H, H] kernel beside them: 128 KB of dynamic shared memory. Each
// of the 256 threads computes an 8 x 8 register tile of the 128 x 128
// layer output (slots ty*4+{0..3}, 64+ty*4+{0..3}; features tx*4+{0..3},
// 64+tx*4+{0..3}), so both operands are read as float4 without bank
// conflicts. Bound: the EdgeFC products, 2*N*K*H*H per hidden layer, in
// float32 on the CUDA cores; the M write is the byte term.
//
// The compute type (build_band_fused's compute_dtype, :1173-1254) is a
// runtime flag: with ct_bf16 every operand of an EdgeFC product (the RBF
// and each layer's activations, each layer's kernel) is rounded to
// bfloat16 as it is written to shared memory and held there in float32,
// as ops/edge.py's as_operand emulates jnp.dot(x.astype(bf16),
// k.astype(bf16), preferred_element_type=float32). The RBF, biases,
// activations, the d > 0 mask and the band sum stay float32; M is rounded
// once to OutT. The flag only rounds stored values, so the float32 path
// computes what it did before it existed.

constexpr int kH = 128;
constexpr int kSlots = 128;
constexpr int kFusedThreads = 256;
constexpr size_t kFusedSmem = (size_t)(kH * kSlots + kH * kH) * sizeof(float);

// v as an EdgeFC operand: rounded to bfloat16 when the compute type is.
__device__ __forceinline__ float operand(float v, int ct_bf16) {
  return ct_bf16 ? round_to<__nv_bfloat16>(v) : v;
}

template <int E, typename OutT>
__global__ void __launch_bounds__(kFusedThreads)
    fused_edge_band_kernel(const int* __restrict__ nlist,  // [N_pad, K]
                           const float* __restrict__ d,    // [N_pad, K]
                           const int* __restrict__ lo,     // [T]
                           const float* __restrict__ wh,   // [Lh, H, H]
                           const float* __restrict__ bh,   // [Lh, H]
                           const float* __restrict__ wf,   // [H, E]
                           const float* __restrict__ bf,   // [E]
                           OutT* __restrict__ M,           // [T, E, B, W]
                           int B, int K, int W, int n_hidden, float rbf_low,
                           float gap, float inv_gap, int act, int ct_bf16) {
  extern __shared__ float4 smem4[];
  float* xT = reinterpret_cast<float*>(smem4);  // [kH][kSlots]
  float* sw = xT + kH * kSlots;                 // [kH][kH]
  __shared__ float s_d[kSlots];
  __shared__ float s_mask[kSlots];
  __shared__ int s_rel[kSlots];
  __shared__ float s_e[kSlots * E];

  const int tid = threadIdx.x;
  const size_t slot0 = (size_t)blockIdx.x * kSlots;
  const int rows = kSlots / K;
  const int row0 = blockIdx.x * rows;

  for (int s = tid; s < kSlots; s += kFusedThreads) {
    const float dv = d[slot0 + s];
    s_d[s] = dv;
    s_mask[s] = dv > 0.0f ? 1.0f : 0.0f;
    s_rel[s] = nlist[slot0 + s] - lo[(row0 + s / K) / B];
  }
  __syncthreads();

  // RBF with centers h * gap + low (rounded as two operations, as the
  // TPU kernel computes them), divided by the gap, not the gap squared.
  for (int i = tid; i < kH * kSlots; i += kFusedThreads) {
    const int h = i / kSlots;
    const int s = i - h * kSlots;
    const float c = __fadd_rn(__fmul_rn((float)h, gap), rbf_low);
    const float x = s_d[s] - c;
    xT[i] = operand(expf(-(x * x) * inv_gap) * s_mask[s], ct_bf16);
  }

  const int ty = tid % 16;
  const int tx = tid / 16;
  for (int l = 0; l < n_hidden; ++l) {
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(wh + (size_t)l * kH * kH);
    float4* dst = reinterpret_cast<float4*>(sw);
    for (int i = tid; i < kH * kH / 4; i += kFusedThreads) {
      const float4 v = src[i];
      dst[i] = make_float4(operand(v.x, ct_bf16), operand(v.y, ct_bf16),
                           operand(v.z, ct_bf16), operand(v.w, ct_bf16));
    }
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < kH; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xT + k * kSlots + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(xT + k * kSlots + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sw + k * kH + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(sw + k * kH + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // every read of xT is done before it is overwritten

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
      const float bias = bh[(size_t)l * kH + f];
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = operand(activate(acc[i][j] + bias, act), ct_bf16);
      const float4 v0 = make_float4(v[0], v[1], v[2], v[3]);
      const float4 v1 = make_float4(v[4], v[5], v[6], v[7]);
      *reinterpret_cast<float4*>(xT + f * kSlots + ty * 4) = v0;
      *reinterpret_cast<float4*>(xT + f * kSlots + 64 + ty * 4) = v1;
    }
  }
  __syncthreads();

  // Final linear layer H -> E, bias, then the d > 0 mask.
  for (int i = tid; i < kH * E; i += kFusedThreads) sw[i] = operand(wf[i], ct_bf16);
  __syncthreads();
  for (int o = tid; o < kSlots * E; o += kFusedThreads) {
    const int n = o / kSlots;
    const int s = o - n * kSlots;
    float acc = 0.0f;
    for (int k = 0; k < kH; ++k) acc = fmaf(xT[k * kSlots + s], sw[k * E + n], acc);
    s_e[s * E + n] = (acc + bf[n]) * s_mask[s];
  }
  __syncthreads();

  for (int a = 0; a < rows; ++a) {
    const int row = row0 + a;
    const int t = row / B;
    const int b = row - t * B;
    band_row<E, OutT>(s_rel + a * K, s_e + a * K * E, K, W,
                      M + ((size_t)t * E * B + b) * W, (size_t)B * W, tid, kFusedThreads);
  }
}

template <int E, typename OutT>
cudaError_t launch_build(const int* nlist, const float* e, const int* lo, void* M, int T,
                         int B, int K, int W, cudaStream_t stream) {
  build_band_kernel<E, OutT><<<T * B, kBuildThreads, 0, stream>>>(
      nlist, e, lo, static_cast<OutT*>(M), B, K, W);
  return cudaGetLastError();
}

template <int E, typename OutT>
cudaError_t launch_fused(const int* nlist, const float* d, const int* lo, const float* wh,
                         const float* bh, const float* wf, const float* bf, void* M,
                         int n_pad, int B, int K, int W, int n_hidden, float rbf_low,
                         float gap, float inv_gap, int act, int ct_bf16,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_edge_band_kernel<E, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kFusedSmem);
  if (err != cudaSuccess) return err;
  const int blocks = (int)(((size_t)n_pad * K) / kSlots);
  fused_edge_band_kernel<E, OutT><<<blocks, kFusedThreads, kFusedSmem, stream>>>(
      nlist, d, lo, wh, bh, wf, bf, static_cast<OutT*>(M), B, K, W, n_hidden, rbf_low, gap,
      inv_gap, act, ct_bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The band build over T tiles with window starts lo (any int32 values);
// out_bf16 selects the output type (0: float32, 1: bfloat16).
int nmr_build_band(const int* nlist, const float* e, const int* lo, void* M, int T, int B,
                   int K, int E, int W, int out_bf16, void* stream) {
  if (T < 1 || B < 1 || K < 1 || K > kMaxK || W < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NMR_BUILD_CASE(EE)                                                             \
  if (E == EE)                                                                         \
    return out_bf16 ? launch_build<EE, __nv_bfloat16>(nlist, e, lo, M, T, B, K, W, s) \
                    : launch_build<EE, float>(nlist, e, lo, M, T, B, K, W, s);
  NMR_BUILD_CASE(1)
  NMR_BUILD_CASE(2)
  NMR_BUILD_CASE(3)
  NMR_BUILD_CASE(4)
#undef NMR_BUILD_CASE
  return cudaErrorInvalidValue;
}

// The fused edge stage + band build; out_bf16 selects the output type,
// compute_bf16 the EdgeFC products' operand type (0: float32, 1: bfloat16).
int nmr_build_band_fused(const int* nlist, const float* d, const int* lo, const float* wh,
                         const float* bh, const float* wf, const float* bf, void* M,
                         int n_pad, int B, int K, int E, int W, int H, int n_hidden,
                         float rbf_low, float gap, float inv_gap, int act, int out_bf16,
                         int compute_bf16, void* stream) {
  if (H != kH || K < 1 || kSlots % K != 0 || B % (kSlots / K) != 0 || n_pad % B != 0 ||
      W < 1 || n_hidden < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NMR_FUSED_CASE(EE)                                                                  \
  if (E == EE)                                                                              \
    return out_bf16 ? launch_fused<EE, __nv_bfloat16>(nlist, d, lo, wh, bh, wf, bf, M,      \
                                                      n_pad, B, K, W, n_hidden, rbf_low,    \
                                                      gap, inv_gap, act, compute_bf16, s)   \
                    : launch_fused<EE, float>(nlist, d, lo, wh, bh, wf, bf, M, n_pad, B, K, \
                                              W, n_hidden, rbf_low, gap, inv_gap, act,      \
                                              compute_bf16, s);
  NMR_FUSED_CASE(1)
  NMR_FUSED_CASE(2)
  NMR_FUSED_CASE(3)
  NMR_FUSED_CASE(4)
#undef NMR_FUSED_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
