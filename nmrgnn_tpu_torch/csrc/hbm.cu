// The MP layers of nmrgnn_tpu_torch with their band read from device
// memory: the entry points of mp.cuh's kernel in its kFull and kPartial
// modes, behind mp_banded (B1), mp_banded_hbm (B5), mp_banded_hbm_cls
// (B9) and mp_banded_partial (B6), and of the two band-occupancy passes
// that feed it (band_occupancy, band_occupancy_from_band). mp.cuh holds
// the kernels, what they replace and their design.
//
// Built by ops/_cuda.py like banded.cu (nvcc, sm_90a, -O3, no fast math)
// and bound with ctypes through the extern "C" functions below. Each
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include "mp.cuh"

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One MP layer (activation(aggregate) + residual) over `tiles` grid tiles.
// ids null: tile i updates rows [i*B, (i+1)*B) (mp_banded, mp_banded_hbm);
// else grid tile i updates tile ids[i] into output rows [i*B, (i+1)*B)
// (mp_banded_hbm_cls). n_table: rows of the node table, a multiple of B;
// ldt: its row stride in elements (F, or the full width when the table
// pointer is a column block of a wider table, mp.cuh's F-split).
// occ: the band's occupancy [tiles * B, ceil(W / 512)] (mp.cuh). w:
// [E, F_in, F_out] in float32, [E, F_out, F_in] in bfloat16. A channel
// group: M and w point at its first channel, m_e is M's channel count and
// acc_in (or null) the earlier groups' float32 sum (mp.cuh).
int nmr_mp_banded(const float* M, const unsigned* occ, const int* lo, const int* ids,
                  const float* table, const float* w, const float* inv, float* out, int tiles,
                  int E, int B, int W, int F, int n_table, int ldt, int act, int m_e,
                  const float* acc_in, void* stream) {
  return launch_mp_any<float, kFull>(F, E, M, occ, lo, ids, table, w, inv, out, tiles, B, W,
                                     n_table, ldt, act, m_e, acc_in, ChebBuild{},
                                     static_cast<cudaStream_t>(stream));
}

int nmr_mp_banded_bf16(const __nv_bfloat16* M, const unsigned* occ, const int* lo,
                       const int* ids, const __nv_bfloat16* table, const __nv_bfloat16* w,
                       const float* inv, __nv_bfloat16* out, int tiles, int E, int B, int W,
                       int F, int n_table, int ldt, int act, int m_e, const float* acc_in,
                       void* stream) {
  return launch_mp_any<__nv_bfloat16, kFull>(F, E, M, occ, lo, ids, table, w, inv, out, tiles,
                                             B, W, n_table, ldt, act, m_e, acc_in, ChebBuild{},
                                             static_cast<cudaStream_t>(stream));
}

// The partial layer (mp_banded_partial): float32 acc (+ acc_in) of every
// grid tile's rows, no inv_degree, activation or residual; the table may
// have any number of rows.
int nmr_mp_banded_partial(const float* M, const unsigned* occ, const int* lo,
                          const float* table, const float* w, float* out, int tiles, int E,
                          int B, int W, int F, int n_table, int ldt, int m_e,
                          const float* acc_in, void* stream) {
  return launch_mp_any<float, kPartial>(F, E, M, occ, lo, nullptr, table, w, nullptr, out,
                                        tiles, B, W, n_table, ldt, kLinear, m_e, acc_in,
                                        ChebBuild{},
                                        static_cast<cudaStream_t>(stream));
}

int nmr_mp_banded_partial_bf16(const __nv_bfloat16* M, const unsigned* occ, const int* lo,
                               const __nv_bfloat16* table, const __nv_bfloat16* w, float* out,
                               int tiles, int E, int B, int W, int F, int n_table, int ldt,
                               int m_e, const float* acc_in, void* stream) {
  return launch_mp_any<__nv_bfloat16, kPartial>(F, E, M, occ, lo, nullptr, table, w, nullptr,
                                                out, tiles, B, W, n_table, ldt, kLinear, m_e,
                                                acc_in, ChebBuild{},
                                                static_cast<cudaStream_t>(stream));
}

// The occupancy of `tiles` grid tiles' bands [tiles, E, B, W] from the
// neighbor list (band_occupancy): grid tile i reads rows ids[i] * B + r of
// nlist and d ([n_rows, K]; ids null: i * B + r), n_tiles source tiles.
int nmr_band_occupancy(const int* nlist, const float* d, const int* lo, const int* ids,
                       unsigned* occ, int tiles, int n_rows, int n_tiles, int B, int K, int W,
                       void* stream) {
  return launch_band_occupancy(nlist, d, lo, ids, occ, tiles, n_rows, n_tiles, B, K, W,
                               static_cast<cudaStream_t>(stream));
}

// The occupancy of a band M [tiles, E, B, W] read from M itself
// (band_occupancy_from_band).
int nmr_band_occupancy_from_band(const float* M, unsigned* occ, int tiles, int E, int B, int W,
                                 void* stream) {
  return launch_occupancy_from_band(M, occ, tiles, E, B, W, static_cast<cudaStream_t>(stream));
}

int nmr_band_occupancy_from_band_bf16(const __nv_bfloat16* M, unsigned* occ, int tiles, int E,
                                      int B, int W, void* stream) {
  return launch_occupancy_from_band(M, occ, tiles, E, B, W, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
