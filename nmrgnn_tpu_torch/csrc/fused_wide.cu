// The fused edge stage + band build (B3) of nmrgnn_tpu_torch at EdgeFC
// widths 512, 1,024 and 2,048: the entry point of fused.cuh's kernel in
// its float32 design (the hidden kernel streamed through the ring), with
// float32 or bfloat16 operands (fused.cuh's "Widths"). banded.cu holds
// the widths 128 and 256; ops/banded.py's build_band_fused picks the
// source by the padded width.
//
// Built by ops/_cuda.py like banded.cu (nvcc, sm_90a, -O3, no fast math)
// and bound with ctypes through the extern "C" function below, which
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() after the launch.

#include "fused.cuh"

namespace {

template <int E>
cudaError_t launch_wide_any(int out_bf16, int b16ops, int H, const int* nlist, const float* d,
                            const int* lo, const float* wh, const float* bh, const float* wf,
                            const float* bf, void* M, int n_pad, int B, int K, int W,
                            int n_hidden, float rbf_low, float gap, float inv_gap, int act,
                            int rows, int m_e, cudaStream_t s) {
#define NMR_WIDE_H(OT, HH)                                                                    \
  if (H == HH)                                                                                \
    return launch_fused<E, OT, false, HH>(nlist, d, lo, wh, bh, wf, bf, M, n_pad, B, K, W,    \
                                          n_hidden, rbf_low, gap, inv_gap, act, rows, m_e,    \
                                          b16ops, s);
#define NMR_WIDE_OUT(OT) NMR_WIDE_H(OT, 512) NMR_WIDE_H(OT, 1024) NMR_WIDE_H(OT, 2048)
  if (out_bf16) {
    NMR_WIDE_OUT(__nv_bfloat16)
  } else {
    NMR_WIDE_OUT(float)
  }
#undef NMR_WIDE_OUT
#undef NMR_WIDE_H
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The fused edge stage + band build at H 512, 1,024 or 2,048 (see
// banded.cu's nmr_build_band_fused): wh float32 [Lh, H_in, H_out], rounded
// to bfloat16 by the caller when b16ops is 1 (bfloat16 operands, float32
// sums); out_bf16 selects the output type.
int nmr_build_band_fused_wide(const int* nlist, const float* d, const int* lo,
                              const float* wh, const float* bh, const float* wf,
                              const float* bf, void* M, int n_pad, int B, int K, int E, int W,
                              int H, int n_hidden, float rbf_low, float gap, float inv_gap,
                              int act, int out_bf16, int b16ops, int rows, int m_e,
                              void* stream) {
  if (K < 1 || rows < 1 || B % rows != 0 || n_pad % B != 0 || W < 1 || n_hidden < 0 ||
      m_e < E)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NMR_WIDE_CASE(EE)                                                                    \
  if (E == EE)                                                                               \
    return launch_wide_any<EE>(out_bf16, b16ops, H, nlist, d, lo, wh, bh, wf, bf, M, n_pad,  \
                               B, K, W, n_hidden, rbf_low, gap, inv_gap, act, rows, m_e, s);
  NMR_WIDE_CASE(1)
  NMR_WIDE_CASE(2)
  NMR_WIDE_CASE(3)
  NMR_WIDE_CASE(4)
#undef NMR_WIDE_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
