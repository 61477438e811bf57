// The Chebyshev band build fused with MP layer 1 (B13), behind
// mp_banded_poly_fused in ops/banded.py: the entry points of mp.cuh's MP
// kernel in its kBuild mode. It replaces _poly_mp_fused_kernel +
// mp_banded_poly_fused (nmrgnn_tpu/ops/banded.py:1451-1604); mp.cuh holds
// the kernel and its design. It is a source of its own, not more entry
// points of hbm.cu, so that its 24 instantiations build in parallel with
// hbm.cu's 48.
//
// Built by ops/_cuda.py like banded.cu (nvcc, sm_90a, -O3, no fast math)
// and bound with ctypes through the extern "C" functions below. Each
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include "mp.cuh"

namespace {

constexpr int kMaxCoeffs = 1024;

template <typename T>
int launch_fused_first(const int* nlist, const float* d, const float* c, const int* lo,
                       const T* table, const T* w, const float* inv, T* out, void* m_out,
                       int tiles, int E, int B, int W, int F, int ldt, int K, int degree,
                       float d_lo, float d_hi, float span, int m_bf16, int act, int m_e,
                       const float* acc_in, void* stream) {
  if (K < 1 || K > kBandMaxK || degree < 1 || (degree + 1) * E > kMaxCoeffs)
    return cudaErrorInvalidValue;
  const ChebBuild bld{nlist, d, c, m_out, K, degree, m_bf16, d_lo, d_hi, span};
  return launch_mp_any<T, kBuild>(F, E, nullptr, nullptr, lo, nullptr, table, w, inv, out, tiles,
                                  B, W, tiles * B, ldt, act, m_e, acc_in, bld,
                                  static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Layer 1 of `tiles` tiles over the node table [tiles * B, F] (table's
// type T), the band built in the block from nlist and d ([tiles * B, K],
// padded rows -1 and 0) and written to m_out [tiles, E, B, W] as float32
// (m_bf16 0) or bfloat16 (1). w: [E, F_in, F_out] in float32, [E, F_out,
// F_in] in bfloat16. The last of a layer's channel groups: m_out and w
// point at its first channel, m_e is m_out's channel count and acc_in the
// earlier groups' float32 sum (or null); ldt is the table's row stride in elements
// (mp.cuh's F-split).
int nmr_mp_banded_poly_fused(const int* nlist, const float* d, const float* c, const int* lo,
                             const float* table, const float* w, const float* inv, float* out,
                             void* m_out, int tiles, int E, int B, int W, int F, int ldt,
                             int K, int degree, float d_lo, float d_hi, float span, int m_bf16,
                             int act, int m_e, const float* acc_in, void* stream) {
  return launch_fused_first<float>(nlist, d, c, lo, table, w, inv, out, m_out, tiles, E, B, W,
                                   F, ldt, K, degree, d_lo, d_hi, span, m_bf16, act, m_e, acc_in,
                                   stream);
}

int nmr_mp_banded_poly_fused_bf16(const int* nlist, const float* d, const float* c,
                                  const int* lo, const __nv_bfloat16* table,
                                  const __nv_bfloat16* w, const float* inv,
                                  __nv_bfloat16* out, void* m_out, int tiles, int E, int B,
                                  int W, int F, int ldt, int K, int degree, float d_lo,
                                  float d_hi, float span, int m_bf16, int act, int m_e,
                                  const float* acc_in, void* stream) {
  return launch_fused_first<__nv_bfloat16>(nlist, d, c, lo, table, w, inv, out, m_out, tiles,
                                           E, B, W, F, ldt, K, degree, d_lo, d_hi, span, m_bf16,
                                           act, m_e, acc_in, stream);
}

}  // extern "C"
