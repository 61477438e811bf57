// The attention MP layer (AMPLayer) of the gather forward, with its
// residual (ops/attention.py's amp): for each atom i, over all K neighbor
// slots k, padding slots included, j = nlist[i, k],
//
//   q        = nodes[i] @ wq                                  [E]
//   logit[k] = inv_degree[i] * <edges[i, k] @ wk, q>
//   a        = softmax over k of logit
//   out[i]   = act(sum_k a[k] P[j]) + nodes[i],   P = nodes @ wv
//
// P [N, F] is the caller's (one float32 product a layer). A padding slot
// gets weight and sends the row its index names: the reference's quirk,
// which ops/message_passing.py's amp_layer keeps.
//
// No TPU kernel: the JAX package's gather AMPLayer (nmrgnn_tpu/ops/
// message_passing.py amp_layer) is plain jnp. The plain version forms the
// values of every slot, nodes[nlist] @ wv: N K F^2 products and two
// [N, K, F] tensors (the gathered rows and the values) written and read
// back, then a batched gemv; this kernel writes only out [N, F].
//
// Built by ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the extern "C" functions at the end. The
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.
//
// Bound: bytes. Reading nodes, P, nlist, edges and inv_degree once and
// writing out once: at 44,676 atoms, K = 16, F = 256, E = 3, 103 MB a
// layer, 0.031 ms at 3.35 TB/s (portbench/flops/attention.py); its
// operations (2 K F a slot's weighted sum, 2 F E the query) take less.
// Design: one warp an atom. Lane l holds C = F / (32 G) channels of the
// sum in registers for each of G channel groups (G = 1 up to F = 256),
// laid out so that each load instruction of the warp reads 32 V
// consecutive floats (V = 4 where C allows: 16-byte loads). The query's
// E sums are warp reductions kept in shared memory; the lane of slot k
// computes its logit, the slots' max and the softmax's sum are warp
// reductions, and each slot's weight and row index are broadcast by
// shuffles, so that a lane keeps 8 rows' loads in flight. P and nodes
// are read through the read-only path: P is 45.7 MB at the cell's size,
// under the 50 MB L2, and the serving order puts neighbors close
// together. No atomics: each output is one lane's sum, in slot order, so
// the result does not change from run to run. A negative index counts
// from the end, as nodes[nlist.long()] does; K above 32 is taken 32
// slots at a time.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 atoms a block
constexpr int kWarpAtoms = kThreads / 32;
constexpr int kInFlight = 8;    // rows of P loaded before they are summed
constexpr int kMaxE = 1024;     // the query in shared memory: kWarpAtoms E floats
constexpr unsigned kFull = 0xffffffffu;

// The floats of a lane's vector: 4 where C allows, else 2, else 1.
template <int C>
__host__ __device__ constexpr int vec_width() {
  return C % 4 == 0 ? 4 : (C % 2 == 0 ? 2 : 1);
}

// The channel of a 32 C-wide group that lane `lane` holds as its c-th:
// vector v = c / V covers channels [32 V v + V lane, + V).
template <int C>
__device__ __forceinline__ int channel(int c, int lane) {
  constexpr int V = vec_width<C>();
  return 32 * V * (c / V) + V * lane + c % V;
}

// This lane's C channels of a 32 C-wide group starting at `row`.
template <int C>
__device__ __forceinline__ void load_group(const float* __restrict__ row, int lane,
                                           float (&r)[C]) {
  constexpr int V = vec_width<C>();
#pragma unroll
  for (int v = 0; v < C / V; ++v) {
    const float* p = row + 32 * V * v + V * lane;
    if constexpr (V == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p));
      r[4 * v] = t.x;
      r[4 * v + 1] = t.y;
      r[4 * v + 2] = t.z;
      r[4 * v + 3] = t.w;
    } else if constexpr (V == 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p));
      r[2 * v] = t.x;
      r[2 * v + 1] = t.y;
    } else {
      r[v] = __ldg(p);
    }
  }
}

template <int C>
__device__ __forceinline__ void store_group(float* __restrict__ row, int lane,
                                            const float (&r)[C]) {
  constexpr int V = vec_width<C>();
#pragma unroll
  for (int v = 0; v < C / V; ++v) {
    float* p = row + 32 * V * v + V * lane;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(r[4 * v], r[4 * v + 1], r[4 * v + 2],
                                                  r[4 * v + 3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(r[2 * v], r[2 * v + 1]);
    } else {
      p[0] = r[v];
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// inv * <e @ wk, q> for a slot's edge features e [E], in the plain
// version's order: the key's E sums, then the dot product, then the scale.
__device__ __forceinline__ float slot_logit(const float* __restrict__ e,
                                            const float* __restrict__ wk, const float* q,
                                            int E, float inv) {
  float dot = 0.0f;
  for (int c = 0; c < E; ++c) {
    float key = 0.0f;
    for (int d = 0; d < E; ++d) key += __ldg(e + d) * __ldg(wk + d * E + c);
    dot += key * q[c];
  }
  return inv * dot;
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    amp_layer_kernel(const float* __restrict__ nodes, const float* __restrict__ p,
                     const float* __restrict__ wq, const float* __restrict__ wk,
                     const int* __restrict__ nlist, const float* __restrict__ edges,
                     const float* __restrict__ inv_degree, float* __restrict__ out, int n,
                     int K, int F, int E, int act) {
  extern __shared__ float q_all[];  // kWarpAtoms x E
  constexpr int W = 32 * C;         // a channel group's width
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarpAtoms + warp;
  if (i >= n) return;  // the whole warp; no block-wide barrier follows
  float* q = q_all + warp * E;
  const float* node_i = nodes + (size_t)i * F;
  const float* edges_i = edges + (size_t)i * K * E;
  const int* nlist_i = nlist + (size_t)i * K;

  // the query: E sums over F channels, each a lane's C, then the warp's
  for (int c = 0; c < E; ++c) {
    float part = 0.0f;
    for (int g0 = 0; g0 < F; g0 += W) {
      float x[C];
      load_group<C>(node_i + g0, lane, x);
#pragma unroll
      for (int t = 0; t < C; ++t)
        part += x[t] * __ldg(wq + (size_t)(g0 + channel<C>(t, lane)) * E + c);
    }
    part = warp_sum(part);
    if (lane == 0) q[c] = part;
  }
  __syncwarp();

  // the softmax's max and sum over all K slots, a lane a slot
  const float inv = inv_degree[i];
  float m = -CUDART_INF_F;
  for (int k = lane; k < K; k += 32)
    m = fmaxf(m, slot_logit(edges_i + (size_t)k * E, wk, q, E, inv));
  m = warp_max(m);
  float s = 0.0f;
  for (int k = lane; k < K; k += 32)
    s += expf(slot_logit(edges_i + (size_t)k * E, wk, q, E, inv) - m);
  s = warp_sum(s);

  // the weighted sum of P's rows, in slot order, a channel group at a time
  for (int g0 = 0; g0 < F; g0 += W) {
    float acc[C];
#pragma unroll
    for (int t = 0; t < C; ++t) acc[t] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      int j = 0;
      float a = 0.0f;
      if (k < K) {
        j = nlist_i[k];
        if (j < 0) j += n;  // counted from the end, as the plain gather counts it
        a = expf(slot_logit(edges_i + (size_t)k * E, wk, q, E, inv) - m) / s;
      }
      const int live = min(32, K - k0);
      for (int b0 = 0; b0 < live; b0 += kInFlight) {
        float r[kInFlight][C];
        float w[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int jb = __shfl_sync(kFull, j, b0 + u);
          w[u] = __shfl_sync(kFull, a, b0 + u);
          if (b0 + u < live) load_group<C>(p + (size_t)jb * F + g0, lane, r[u]);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (b0 + u < live) {
#pragma unroll
            for (int t = 0; t < C; ++t) acc[t] += w[u] * r[u][t];
          }
        }
      }
    }
    float x[C];
    load_group<C>(node_i + g0, lane, x);
#pragma unroll
    for (int t = 0; t < C; ++t) x[t] = activate(acc[t], act) + x[t];
    store_group<C>(out + (size_t)i * F + g0, lane, x);
  }
}

template <int C>
cudaError_t launch_amp(const float* nodes, const float* p, const float* wq, const float* wk,
                       const int* nlist, const float* edges, const float* inv_degree,
                       float* out, int n, int K, int F, int E, int act, cudaStream_t stream) {
  const int blocks = (n + kWarpAtoms - 1) / kWarpAtoms;
  const size_t smem = sizeof(float) * kWarpAtoms * E;
  amp_layer_kernel<C><<<blocks, kThreads, smem, stream>>>(nodes, p, wq, wk, nlist, edges,
                                                          inv_degree, out, n, K, F, E, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The layer (above) over n atoms of K slots, F channels (a multiple of
// 32), E edge features (1 to 1,024) and activation code `act` (common.cuh
// Act). nodes, p and out [n, F] (16-byte aligned), wq [F, E], wk [E, E],
// nlist and inv_degree [n(, K)], edges [n, K, E], all contiguous float32
// but nlist int32. Each lane holds the largest C <= 8 channels a group
// that divides F / 32.
int nmr_amp_layer(const float* nodes, const float* p, const float* wq, const float* wk,
                  const int* nlist, const float* edges, const float* inv_degree, float* out,
                  int n, int K, int F, int E, int act, void* stream) {
  if (n < 0 || K < 0 || F < 32 || F % 32 != 0 || E < 1 || E > kMaxE || act < kLinear ||
      act > kTanh)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int C = 8;
  while ((F / 32) % C) --C;
#define NMR_AMP_CASE(CC) \
  case CC:               \
    return launch_amp<CC>(nodes, p, wq, wk, nlist, edges, inv_degree, out, n, K, F, E, act, st);
  switch (C) {
    NMR_AMP_CASE(1)
    NMR_AMP_CASE(2)
    NMR_AMP_CASE(3)
    NMR_AMP_CASE(4)
    NMR_AMP_CASE(5)
    NMR_AMP_CASE(6)
    NMR_AMP_CASE(7)
    NMR_AMP_CASE(8)
  }
#undef NMR_AMP_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
