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

// ---------------------------------------------------------------------------
// Chebyshev band build. Replaces _poly_band_kernel + _poly_build_tile
// (nmrgnn_tpu/ops/banded.py:1268-1290, 1418-1448) and, given a tile-id
// array, build_band_poly_cls (:1645-1700):
//   x = 2 (clamp(d, d_lo, d_hi) - d_lo) / (d_hi - d_lo) - 1
//   e_n = (sum_p c[p, n] T_p(x)) * [d > 0],  T_p = 2x T_{p-1} - T_{p-2}
//   M[i, n, b, w] = sum_k e_n[row, k] * [nlist[row, k] == lo[i] + w]
// where row = tile * B + b and tile = ids[i] (or i without ids). The TPU
// bakes the coefficients into the kernel as constants; here they are a
// small device array staged in shared memory, and the degree is a runtime
// value. One block per band row: its K slots' E values come from the
// forward recurrence (one thread per slot, common.cuh's cheb_edge, every
// product and sum rounded separately) into shared memory, then the threads
// walk the W columns with the compare-in-slot-order loop of build_band,
// so the stores are coalesced, duplicates add, and out-of-window indices
// and -1 padding match nothing. Bound: bytes, writing M (T*E*B*W values
// of OutT); the recurrence is K * degree * (2 + 2E) flops per row.

constexpr int kPolyThreads = 128;
constexpr int kPolyMaxK = 128;
constexpr int kPolyMaxCoeffs = 1024;

template <int E, typename OutT>
__global__ void __launch_bounds__(kPolyThreads)
    build_band_poly_kernel(const int* __restrict__ nlist,   // [N_pad, K]
                           const float* __restrict__ d,     // [N_pad, K]
                           const int* __restrict__ lo,      // [Tg]
                           const int* __restrict__ ids,     // [Tg] tile ids, or null
                           const float* __restrict__ c,     // [degree + 1, E]
                           OutT* __restrict__ M,            // [Tg, E, B, W]
                           int n_src, int B, int K, int W, int degree, float d_lo,
                           float d_hi, float span) {
  __shared__ float s_c[kPolyMaxCoeffs];
  __shared__ int s_rel[kPolyMaxK];
  __shared__ float s_e[kPolyMaxK * E];
  const int i = blockIdx.x / B;
  const int b = blockIdx.x - i * B;
  const int tile = ids != nullptr ? ids[i] : i;
  const bool valid = tile >= 0 && tile < n_src;  // a bad id reads nothing
  const size_t row = (size_t)(valid ? tile : 0) * B + b;
  const int base = lo[i];
  for (int j = threadIdx.x; j < (degree + 1) * E; j += kPolyThreads) s_c[j] = c[j];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kPolyThreads) {
    if (!valid) {
      s_rel[k] = -1;
#pragma unroll
      for (int n = 0; n < E; ++n) s_e[k * E + n] = 0.0f;
      continue;
    }
    s_rel[k] = nlist[row * K + k] - base;
    cheb_edge<E>(d[row * K + k], s_c, degree, d_lo, d_hi, span, s_e + k * E);
  }
  __syncthreads();
  band_row<E, OutT>(s_rel, s_e, K, W, M + ((size_t)i * E * B + b) * W, (size_t)B * W,
                    threadIdx.x, kPolyThreads);
}

template <int E, typename OutT>
cudaError_t launch_poly(const int* nlist, const float* d, const int* lo, const int* ids,
                        const float* c, void* M, int tiles, int n_src, int B, int K, int W,
                        int degree, float d_lo, float d_hi, float span, cudaStream_t stream) {
  build_band_poly_kernel<E, OutT><<<tiles * B, kPolyThreads, 0, stream>>>(
      nlist, d, lo, ids, c, static_cast<OutT*>(M), n_src, B, K, W, degree, d_lo, d_hi, span);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The Chebyshev band build over `tiles` grid tiles; `ids` maps grid tile i
// to the tile of the n_src tiles of nlist and d whose rows it reads (null:
// tile i). out_bf16 selects the output type (0: float32, 1: bfloat16).
int nmr_build_band_poly(const int* nlist, const float* d, const int* lo, const int* ids,
                        const float* c, void* M, int tiles, int n_src, int B, int K, int E,
                        int W, int degree, float d_lo, float d_hi, float span, int out_bf16,
                        void* stream) {
  if (tiles < 1 || n_src < 1 || B < 1 || K < 1 || K > kPolyMaxK || W < 1 || degree < 1 ||
      (degree + 1) * E > kPolyMaxCoeffs)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NMR_POLY_CASE(EE)                                                                  \
  if (E == EE)                                                                             \
    return out_bf16 ? launch_poly<EE, __nv_bfloat16>(nlist, d, lo, ids, c, M, tiles, n_src, \
                                                     B, K, W, degree, d_lo, d_hi, span, s)       \
                    : launch_poly<EE, float>(nlist, d, lo, ids, c, M, tiles, n_src, B, K,  \
                                             W, degree, d_lo, d_hi, span, s);
  NMR_POLY_CASE(1)
  NMR_POLY_CASE(2)
  NMR_POLY_CASE(3)
  NMR_POLY_CASE(4)
#undef NMR_POLY_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
