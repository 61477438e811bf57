// Hand-written Hopper kernels for the band builds of the exact
// RCM-banded message-passing path of nmrgnn_tpu_torch and for serving's
// request preparation (ops/banded.py holds the wrappers and the plain
// PyTorch version of each kernel).
//
// Built by ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the extern "C" functions at the end. Each
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.
//
// The MP layer's kernel, for every path, is mp.cuh's; the fused edge
// stage's (B3) is fused.cuh's, instantiated here at EdgeFC widths 128 and
// 256 and by fused_wide.cu at 512 to 2,048.
//
// The band sums are float32 and a bfloat16 output rounds the float32 band
// once. The fused edge stage's EdgeFC products run in float32 on the CUDA
// cores, or with a bfloat16 compute type on the tensor cores (bfloat16
// operands, each product exact, float32 sums). There is no fast-math
// flag: expf, log1pf and tanhf are the accurate library versions, as the
// exact serving path needs.
//
// Layouts follow the JAX package: M is [T, E, B, W] (tile, edge channel,
// row in tile, window column), nodes are [N_pad, F], nlist [N_pad, K]
// with -1 on padded rows.

#include "fused.cuh"

namespace {

// ---------------------------------------------------------------------------
// Band build. Replaces _build_band_kernel (nmrgnn_tpu/ops/banded.py:484-507)
// behind build_band (:510) and build_band_tracedlo (:788):
//   M[t, n, b, w] = sum_k e[tB + b, k, n] * [nlist[tB + b, k] == lo[t] + w]
// with lo read from device memory, so any caller-given window start works;
// an index outside [lo[t], lo[t] + W), negative ones included, matches no
// column. Bound: the M write (T*E*B*W values of OutT; the band is more
// than 97% zeros); the reads of nlist and e are a few percent of it.
//
// A block takes `rows` rows of one tile (4 with 128 threads; common.cuh's
// band_group_ok, band_threads): their rows * K indices and rows * K * E
// values, consecutive in nlist and e, come in one coalesced pass of
// 16-byte loads (4-byte ones where rows * K or rows * K * E is not a
// multiple of 4) into shared memory, then one barrier, then common.cuh's
// band_rows writes the rows, a warp a row, 16 bytes a lane a store,
// walking only the slots that land in a pass's columns. One block a row
// with 128 threads, each summing 4 columns over all K slots and storing
// 8 bytes in bfloat16, took 0.1146 ms alone for the 44,676-atom band in
// bfloat16; this design 0.0915 (tools/ab_band_builds.py, NVIDIA H100
// 80GB HBM3, 700 W).

template <int E, typename OutT>
__global__ void __launch_bounds__(kBandMaxThreads)
    build_band_kernel(const int* __restrict__ nlist,  // [T*B, K]
                      const float* __restrict__ e,    // [T*B, K, E]
                      const int* __restrict__ lo,     // [T]
                      OutT* __restrict__ M,           // [T, m_e, B, W] at the group
                      int B, int K, int W, int rows, int es, int m_e) {
  extern __shared__ float4 smem4[];
  const int n = rows * K;
  float* s_e = reinterpret_cast<float*>(smem4);  // [rows * K * E]
  int* s_rel = reinterpret_cast<int*>(s_e + n * E);  // [rows * K]
  const int groups = B / rows;
  const int t = blockIdx.x / groups;
  const int b0 = (blockIdx.x - t * groups) * rows;
  const size_t slot0 = ((size_t)t * B + b0) * K;  // a multiple of rows * K
  const int base = lo[t];
  const int* g_nl = nlist + slot0;
  const float* g_e = e + slot0 * es;
  if ((n & 3) == 0) {
    for (int j = threadIdx.x; j < n / 4; j += blockDim.x) {
      const int4 v = reinterpret_cast<const int4*>(g_nl)[j];
      reinterpret_cast<int4*>(s_rel)[j] = make_int4(v.x - base, v.y - base, v.z - base, v.w - base);
    }
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) s_rel[j] = g_nl[j] - base;
  }
  if (es == E && ((n * E) & 3) == 0) {
    for (int j = threadIdx.x; j < n * E / 4; j += blockDim.x)
      reinterpret_cast<float4*>(s_e)[j] = reinterpret_cast<const float4*>(g_e)[j];
  } else {  // a channel group of wider edge values, or an odd count
    for (int j = threadIdx.x; j < n * E; j += blockDim.x) s_e[j] = g_e[(j / E) * es + j % E];
  }
  __syncthreads();
  band_rows<E, OutT>(s_rel, s_e, rows, K, W, M + ((size_t)t * m_e * B + b0) * W,
                     (size_t)B * W, threadIdx.x, blockDim.x);
}

template <int E, typename OutT>
cudaError_t launch_build(const int* nlist, const float* e, const int* lo, void* M, int T,
                         int B, int K, int W, int rows, int es, int m_e, cudaStream_t stream) {
  const size_t smem = (size_t)rows * K * (E + 1) * sizeof(float);
  if (smem > kBandDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        build_band_kernel<E, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  build_band_kernel<E, OutT><<<T * (B / rows), band_threads(rows), smem, stream>>>(
      nlist, e, lo, static_cast<OutT*>(M), B, K, W, rows, es, m_e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Request preparation (no TPU kernel: the JAX package permutes and plans on
// the host), behind ops/banded.py's permute_tile_bounds: a served graph in
// the RCM order, as data/reorder.py's permute_graph(pin_zero=False) writes
// it,
//   atoms_p[r] = atoms[order[r]], edges_p[r] = edges[order[r]],
//   inv_degree_p[r] = inv_degree[order[r]],
//   nlist_p[r, k] = inverse[nlist[order[r], k]] (a negative index counted
//   from the end, as numpy counts it; one outside [-n, n) left as it is),
// and for each tile of `rows` rows the smallest and largest of its
// permuted indices whose distance is > 0, (INT_MAX, INT_MIN) for a tile
// with none. With order null the graph is read for the bounds alone.
//
// A block takes one tile: its slots, then its atom features and degrees,
// a thread to a value in turn (each row's K slots are 64 contiguous bytes
// at K = 16, gathered from wherever order puts the row), then a warp-
// shuffle and shared-memory reduction of the bounds. Bound: reading and
// writing the graph once (the inverse's 4 * n bytes stay in L2).

constexpr int kPrepThreads = 256;
constexpr int kNoMin = 0x7fffffff;
constexpr int kNoMax = -0x7fffffff - 1;

__global__ void __launch_bounds__(kPrepThreads)
    permute_tile_bounds_kernel(const float* __restrict__ atoms, const int* __restrict__ nlist,
                               const float* __restrict__ edges,
                               const float* __restrict__ inv_degree,
                               const int* __restrict__ order, const int* __restrict__ inverse,
                               float* __restrict__ atoms_p, int* __restrict__ nlist_p,
                               float* __restrict__ edges_p, float* __restrict__ inv_degree_p,
                               int* __restrict__ bounds, int n, int V, int K, int rows) {
  __shared__ int s_lo[kPrepThreads / 32], s_hi[kPrepThreads / 32];
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n - r0);
  const bool permute = order != nullptr;
  int lo = kNoMin, hi = kNoMax;
  for (int j = threadIdx.x; j < nr * K; j += blockDim.x) {
    const int r = r0 + j / K;
    const int k = j - (j / K) * K;
    const size_t src = (size_t)(permute ? order[r] : r) * K + k;
    int v = nlist[src];
    const float e = edges[src];
    if (permute) {
      if (v >= -n && v < n) v = inverse[v < 0 ? v + n : v];
      const size_t dst = (size_t)r * K + k;
      nlist_p[dst] = v;
      edges_p[dst] = e;
    }
    if (e > 0.0f) {
      lo = min(lo, v);
      hi = max(hi, v);
    }
  }
  if (permute) {
    for (int j = threadIdx.x; j < nr * V; j += blockDim.x) {
      const int r = r0 + j / V;
      atoms_p[(size_t)r * V + (j - (j / V) * V)] =
          atoms[(size_t)order[r] * V + (j - (j / V) * V)];
    }
    for (int j = threadIdx.x; j < nr; j += blockDim.x)
      inv_degree_p[r0 + j] = inv_degree[order[r0 + j]];
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x / 32); ++w) {
      lo = min(lo, s_lo[w]);
      hi = max(hi, s_hi[w]);
    }
    bounds[2 * blockIdx.x] = lo;
    bounds[2 * blockIdx.x + 1] = hi;
  }
}

// compute 0: float32 on the CUDA cores; 1: bfloat16 on the tensor cores;
// 2: bfloat16 operands on the CUDA cores (b16ops). H 128 or 256 here; the
// wider EdgeFCs are fused_wide.cu's.
template <int E>
cudaError_t launch_fused_any(int out_bf16, int compute, int H, const int* nlist,
                             const float* d, const int* lo, const void* wh, const float* bh,
                             const float* wf, const float* bf, void* M, int n_pad, int B, int K,
                             int W, int n_hidden, float rbf_low, float gap, float inv_gap,
                             int act, int rows, int m_e, cudaStream_t s) {
  const int b16ops = compute == 2;
#define NMR_FUSED_H(OT, TC, HH)                                                                \
  if (H == HH)                                                                                 \
    return launch_fused<E, OT, TC, HH>(nlist, d, lo, wh, bh, wf, bf, M, n_pad, B, K, W,        \
                                       n_hidden, rbf_low, gap, inv_gap, act, rows, m_e,        \
                                       b16ops, s);
#define NMR_FUSED_OUT(OT)                                                                      \
  if (compute == 1) {                                                                          \
    NMR_FUSED_H(OT, true, 128)                                                                 \
    NMR_FUSED_H(OT, true, 256)                                                                 \
  } else {                                                                                     \
    NMR_FUSED_H(OT, false, 128)                                                                \
    NMR_FUSED_H(OT, false, 256)                                                                \
  }
  if (out_bf16) {
    NMR_FUSED_OUT(__nv_bfloat16)
  } else {
    NMR_FUSED_OUT(float)
  }
#undef NMR_FUSED_OUT
#undef NMR_FUSED_H
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The band build over T tiles with window starts lo (any int32 values),
// a block to each `rows` rows of a tile; out_bf16 selects the output type
// (0: float32, 1: bfloat16). A channel group of E channels: e and M point
// at its first channel, es is e's channel count a slot, m_e M's a tile.
int nmr_build_band(const int* nlist, const float* e, const int* lo, void* M, int T, int B,
                   int K, int E, int W, int rows, int out_bf16, int es, int m_e,
                   void* stream) {
  if (T < 1 || W < 1 || !band_group_ok(B, K, rows) || es < E || m_e < E)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NMR_BUILD_CASE(EE)                                                                  \
  if (E == EE)                                                                              \
    return out_bf16                                                                         \
               ? launch_build<EE, __nv_bfloat16>(nlist, e, lo, M, T, B, K, W, rows, es, m_e, \
                                                 s)                                         \
               : launch_build<EE, float>(nlist, e, lo, M, T, B, K, W, rows, es, m_e, s);
  NMR_BUILD_CASE(1)
  NMR_BUILD_CASE(2)
  NMR_BUILD_CASE(3)
  NMR_BUILD_CASE(4)
#undef NMR_BUILD_CASE
  return cudaErrorInvalidValue;
}

// The graph permuted and its tile bounds (above), one block a tile of
// `rows` rows; order and inverse null: the bounds alone, and the *_p
// outputs are not written.
int nmr_permute_tile_bounds(const float* atoms, const int* nlist, const float* edges,
                            const float* inv_degree, const int* order, const int* inverse,
                            float* atoms_p, int* nlist_p, float* edges_p,
                            float* inv_degree_p, int* bounds, int n, int V, int K, int rows,
                            void* stream) {
  if (n < 1 || V < 0 || K < 0 || rows < 1 || (order == nullptr) != (inverse == nullptr))
    return cudaErrorInvalidValue;
  const int tiles = (n + rows - 1) / rows;
  permute_tile_bounds_kernel<<<tiles, kPrepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      atoms, nlist, edges, inv_degree, order, inverse, atoms_p, nlist_p, edges_p,
      inv_degree_p, bounds, n, V, K, rows);
  return cudaGetLastError();
}

// The fused edge stage + band build; out_bf16 selects the output type,
// compute the EdgeFC products' (0: float32, 1: bfloat16 on the tensor
// cores, H 128 or 256; 2: bfloat16 operands on the CUDA cores) and the
// layout of the hidden kernels wh: float32 [Lh, H_in, H_out] (2: rounded
// to bfloat16 by the caller), or bfloat16 [Lh, H_out, H_in] (1). H is 128
// or 256 (fused_wide.cu takes 512 to 2,048); a block takes `rows` atoms (rows dividing B)
// and runs their rows * K slots through the EdgeFC in passes of 16384 / H.
// A channel group of E channels: wf [H, E] and bf [E] are its own, M
// points at its first channel and m_e is M's channel count.
int nmr_build_band_fused(const int* nlist, const float* d, const int* lo, const void* wh,
                         const float* bh, const float* wf, const float* bf, void* M,
                         int n_pad, int B, int K, int E, int W, int H, int n_hidden,
                         float rbf_low, float gap, float inv_gap, int act, int out_bf16,
                         int compute, int rows, int m_e, void* stream) {
  if (K < 1 || rows < 1 || B % rows != 0 || n_pad % B != 0 || W < 1 || n_hidden < 0 ||
      m_e < E || compute < 0 || compute > 2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NMR_FUSED_CASE(EE)                                                                   \
  if (E == EE)                                                                               \
    return launch_fused_any<EE>(out_bf16, compute, H, nlist, d, lo, wh, bh, wf, bf, M,       \
                                n_pad, B, K, W, n_hidden, rbf_low, gap, inv_gap, act, rows,  \
                                m_e, s);
  NMR_FUSED_CASE(1)
  NMR_FUSED_CASE(2)
  NMR_FUSED_CASE(3)
  NMR_FUSED_CASE(4)
#undef NMR_FUSED_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
