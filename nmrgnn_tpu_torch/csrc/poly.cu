// Hand-written Hopper kernels for the "fast" serving precision of
// nmrgnn_tpu_torch: the Chebyshev band build, uniform and per window
// class. (The partial MP layer of the class-bucketed forward is hbm.cu's
// MP kernel without its epilogue.)
// ops/banded.py holds the wrappers and the plain PyTorch version of each.
//
// Built by ops/_cuda.py like banded.cu (nvcc, sm_90a, -O3, no fast math)
// and bound with ctypes through the extern "C" functions at the end. Each
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.
//
// Layouts follow the JAX package: M is [T, E, B, W], nlist and the
// distances are [N_pad, K] (nlist -1 and distance 0 on padded rows), the
// Chebyshev coefficients [degree + 1, E].

#include "common.cuh"

namespace {

constexpr int kPolyMaxCoeffs = 1024;  // (degree + 1) * E

// ---------------------------------------------------------------------------
// Chebyshev band build. Replaces _poly_band_kernel + _poly_build_tile
// (nmrgnn_tpu/ops/banded.py:1268-1290, 1418-1448) and, given a tile-id
// array, build_band_poly_cls (:1645-1700) and, with caller-given window
// starts, build_band_poly_tracedlo (:1363):
//   x = 2 (clamp(d, d_lo, d_hi) - d_lo) / (d_hi - d_lo) - 1
//   e_n = (sum_p c[p, n] T_p(x)) * [d > 0],  T_p = 2x T_{p-1} - T_{p-2}
//   M[i, n, b, w] = sum_k e_n[row, k] * [nlist[row, k] == lo[i] + w]
// where row = tile * B + b and tile = ids[i] (or i without ids); a bad id
// reads nothing. The TPU bakes the coefficients into the kernel as
// constants; here they are a small device array staged in shared memory,
// and the degree is a runtime value.
//
// Bound: bytes, writing M (T*E*B*W values of OutT, more than 97% zeros;
// 241 MB in bfloat16 at 44,676 atoms). The recurrence is K * degree *
// (2 + 2E) flops a row, a few percent of the card's float32 rate at that
// size, but each slot's is a chain of `degree` dependent steps.
//
// A block takes `rows` rows of one tile (4 with 128 threads; common.cuh's
// band_group_ok, band_threads), stages the coefficients once, and spreads
// the rows * K slots over its threads: each evaluates a slot's recurrence
// with common.cuh's cheb_edge (every product and sum rounded separately,
// so every value keeps its bits) into shared memory, skipping slots whose
// index lies outside the window (no column reads them). Then one barrier,
// and common.cuh's band_rows writes the rows, a warp a row, 16 bytes a
// lane a store, walking only the slots that land in a pass's columns.
// One block a row (16 of its 128 threads running the recurrence, the
// coefficients restaged by each, every thread comparing its 4 columns
// with all K slots) took 0.1541 ms alone for the 44,676-atom band in
// bfloat16; this design 0.1077 (tools/ab_band_builds.py, NVIDIA H100
// 80GB HBM3, 700 W).

template <int E, typename OutT>
__global__ void __launch_bounds__(kBandMaxThreads)
    build_band_poly_kernel(const int* __restrict__ nlist,   // [N_pad, K]
                           const float* __restrict__ d,     // [N_pad, K]
                           const int* __restrict__ lo,      // [Tg]
                           const int* __restrict__ ids,     // [Tg] tile ids, or null
                           const float* __restrict__ c,     // [degree + 1, E]
                           OutT* __restrict__ M,            // [Tg, m_e, B, W] at the group
                           int n_src, int B, int K, int W, int rows, int degree, float d_lo,
                           float d_hi, float span, int m_e) {
  extern __shared__ float4 smem4[];
  const int nc = (degree + 1) * E;
  const int n = rows * K;
  float* s_c = reinterpret_cast<float*>(smem4);         // [nc]
  float* s_e = s_c + nc;                                // [rows * K * E]
  int* s_rel = reinterpret_cast<int*>(s_e + n * E);     // [rows * K]
  const int groups = B / rows;
  const int i = blockIdx.x / groups;
  const int b0 = (blockIdx.x - i * groups) * rows;
  const int tile = ids != nullptr ? ids[i] : i;
  const bool valid = tile >= 0 && tile < n_src;  // a bad id reads nothing
  const size_t slot0 = ((size_t)(valid ? tile : 0) * B + b0) * K;
  const int base = lo[i];
  for (int j = threadIdx.x; j < nc; j += blockDim.x) s_c[j] = c[j];
  __syncthreads();
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int rel = valid ? nlist[slot0 + s] - base : -1;
    s_rel[s] = rel;
    if (static_cast<unsigned>(rel) < static_cast<unsigned>(W))
      cheb_edge<E>(d[slot0 + s], s_c, degree, d_lo, d_hi, span, s_e + s * E);
  }
  __syncthreads();
  band_rows<E, OutT>(s_rel, s_e, rows, K, W, M + ((size_t)i * m_e * B + b0) * W,
                     (size_t)B * W, threadIdx.x, blockDim.x);
}

template <int E, typename OutT>
cudaError_t launch_poly(const int* nlist, const float* d, const int* lo, const int* ids,
                        const float* c, void* M, int tiles, int n_src, int B, int K, int W,
                        int rows, int degree, float d_lo, float d_hi, float span, int m_e,
                        cudaStream_t stream) {
  // at most 4 KB of coefficients and 160 KB of slots (common.cuh)
  const size_t smem = ((size_t)(degree + 1) * E + (size_t)rows * K * (E + 1)) * sizeof(float);
  if (smem > kBandDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(build_band_poly_kernel<E, OutT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  build_band_poly_kernel<E, OutT><<<tiles * (B / rows), band_threads(rows), smem, stream>>>(
      nlist, d, lo, ids, c, static_cast<OutT*>(M), n_src, B, K, W, rows, degree, d_lo, d_hi,
      span, m_e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The Chebyshev band build over `tiles` grid tiles, a block to each `rows`
// rows of a tile; `ids` maps grid tile i to the tile of the n_src tiles of
// nlist and d whose rows it reads (null: tile i). out_bf16 selects the
// output type (0: float32, 1: bfloat16). A channel group of E channels: c
// [degree + 1, E] is its own, M points at its first channel and m_e is M's
// channel count.
int nmr_build_band_poly(const int* nlist, const float* d, const int* lo, const int* ids,
                        const float* c, void* M, int tiles, int n_src, int B, int K, int E,
                        int W, int rows, int degree, float d_lo, float d_hi, float span,
                        int out_bf16, int m_e, void* stream) {
  if (tiles < 1 || n_src < 1 || W < 1 || degree < 1 || (degree + 1) * E > kPolyMaxCoeffs ||
      !band_group_ok(B, K, rows) || m_e < E)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NMR_POLY_CASE(EE)                                                                   \
  if (E == EE)                                                                              \
    return out_bf16 ? launch_poly<EE, __nv_bfloat16>(nlist, d, lo, ids, c, M, tiles, n_src,  \
                                                     B, K, W, rows, degree, d_lo, d_hi, span, \
                                                     m_e, s)                                \
                    : launch_poly<EE, float>(nlist, d, lo, ids, c, M, tiles, n_src, B, K,   \
                                             W, rows, degree, d_lo, d_hi, span, m_e, s);
  NMR_POLY_CASE(1)
  NMR_POLY_CASE(2)
  NMR_POLY_CASE(3)
  NMR_POLY_CASE(4)
#undef NMR_POLY_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
