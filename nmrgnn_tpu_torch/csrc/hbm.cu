// The hand-written Hopper kernel of every banded MP layer of
// nmrgnn_tpu_torch: the node table read from device memory (HBM) through a
// two-stage cp.async pipeline, over all row tiles or over one window
// class's tiles, with or without the epilogue. ops/banded.py holds the
// wrappers (one per TPU kernel, each with its launch count) and the plain
// PyTorch version of each.
//
// Built by ops/_cuda.py like banded.cu (nvcc, sm_90a, -O3, no fast math)
// and bound with ctypes through the extern "C" functions at the end. Each
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.
//
// The TPU has four MP kernels: _mp_banded_kernel (nmrgnn_tpu/ops/
// banded.py:555-579) keeps the whole node table in VMEM,
// _mp_banded_hbm_kernel (:656-773) leaves it in HBM and DMAs tile t + 1's
// [W, F] window and [B, F] residual rows into a two-slot VMEM buffer while
// tile t computes, _mp_banded_hbm_cls_kernel (:1703-1823) does that over
// one class's tiles, and _mp_banded_partial_kernel (:833-894) drops the
// epilogue. On Hopper no table is resident on chip, so all four are this
// one kernel:
//   acc = sum_n round_T(M[i, n] @ table[lo_i : lo_i + W]) @ w[n]
//   full:    out[i*B + r] = T(act(acc * inv_degree) + table[tile*B + r])
//   partial: out[i*B + r] = acc (float32)
// where grid tile i updates tile = ids[i] (ids null: tile = i).
//
// A block takes RB rows of one tile and all F columns (8 blocks per
// 128-row tile at F = 256), so neither product is recomputed by another
// block. The window and band (then the weights W_n) stream through shared
// memory in chunks of kMpChunk rows, copied by 16-byte cp.async.cg into
// two stages, so chunk c + 1 is in flight while chunk c's FMAs run; the
// block's residual rows are fetched with the first chunk. Operands stay in
// their own type in shared memory (bfloat16 as bfloat16) and are widened
// to float32 as they are read; each thread accumulates a 4 x 4 register
// tile per channel; h_n goes through shared memory, rounded to T, into
// the second product. The epilogue is float32, rounded once to T. An id
// outside [0, n_table / B) reads nothing and writes zeros. Window rows
// outside the table read as zeros.
//
// Bound: the kernel does the dense products, 2*T*E*B*W*F + 2*T*E*B*F*F
// FMAs in float32 on the CUDA cores, and that is what it spends its time
// on; the data-dependent bound (the band's nonzeros) is operations in
// float32 and bytes in bfloat16 at the main paths' shapes.

#include "common.cuh"

namespace {

constexpr int kMpThreads = 256;
constexpr int kMpChunk = 16;

template <int F>
__host__ __device__ constexpr int mp_rows_per_block() {
  return (kMpThreads / (F / 4)) * 4;
}

// Shared memory of one block, in bytes: two stages (a chunk of window rows
// or of W_n rows, and the band chunk), h as float32, the residual rows
// (full only).
template <int F, int E, typename T>
__host__ __device__ constexpr size_t mp_stage_bytes() {
  return (size_t)kMpChunk * F * sizeof(T) +
         (size_t)E * mp_rows_per_block<F>() * kMpChunk * sizeof(T);
}
template <int F, int E, typename T, bool kPartial>
__host__ __device__ constexpr size_t mp_smem_bytes() {
  return 2 * mp_stage_bytes<F, E, T>() + (size_t)mp_rows_per_block<F>() * F * sizeof(float) +
         (kPartial ? 0 : (size_t)mp_rows_per_block<F>() * F * sizeof(T));
}

template <int F, int E, typename T, bool kPartial>
__global__ void __launch_bounds__(kMpThreads)
    mp_banded_kernel(const T* __restrict__ M,        // [tiles, E, B, W]
                     const int* __restrict__ lo,     // [tiles] window starts
                     const int* __restrict__ ids,    // [tiles] tile ids, or null
                     const T* __restrict__ table,    // [n_table, F] node table
                     const T* __restrict__ w,        // [E, F, F]
                     const float* __restrict__ inv,  // [n_table] (full only)
                     void* __restrict__ out_,        // [tiles * B, F]: T, or float if partial
                     int B, int W, int n_table, int act) {
  constexpr int CG = F / 4;            // column groups of 4
  constexpr int RG = kMpThreads / CG;  // row groups of 4 rows
  constexpr int RB = RG * 4;           // rows per block
  constexpr int SEG_ROW = F * (int)sizeof(T) / 16;       // 16-byte pieces of a table row
  constexpr int SEG_M = kMpChunk * (int)sizeof(T) / 16;  // of a band row's chunk
  constexpr size_t STAGE = mp_stage_bytes<F, E, T>();
  constexpr size_t ROWS_BYTES = (size_t)kMpChunk * F * sizeof(T);
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* s_h = reinterpret_cast<float*>(smem + 2 * STAGE);                // [RB][F]
  T* s_res = reinterpret_cast<T*>(smem + 2 * STAGE + (size_t)RB * F * 4);  // [RB][F]

  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int rg = tid / CG;
  const int per_tile = B / RB;
  const int i = blockIdx.x / per_tile;  // grid tile
  const int r0 = (blockIdx.x - i * per_tile) * RB;
  const int tile = ids != nullptr ? ids[i] : i;  // the tile whose rows it updates
  const size_t out_row0 = (size_t)i * B + r0;
  if (!kPartial && (tile < 0 || tile >= n_table / B)) {  // a bad id reads nothing
    T* out_rows = static_cast<T*>(out_) + out_row0 * F;
    for (int s = tid; s < RB * CG; s += kMpThreads)
      store4(out_rows + (size_t)s * 4, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  const int base = lo[i];
  const int nw = W / kMpChunk;      // window chunks
  constexpr int NL = F / kMpChunk;  // W_n chunks per channel
  const int total = nw + E * NL;

  // Chunk c < nw: window rows [base + c*16, +16) and the band's columns
  // [c*16, +16) of the block's rows; else W_n rows [l0, l0 + 16).
  auto load_chunk = [&](int c) {
    char* st = smem + (c & 1) * STAGE;
    if (c < nw) {
      const int w0 = c * kMpChunk;
      for (int s = tid; s < kMpChunk * SEG_ROW; s += kMpThreads) {
        const int r = s / SEG_ROW;
        const int q = s - r * SEG_ROW;
        const int src = base + w0 + r;
        const bool ok = src >= 0 && src < n_table;
        const char* g = reinterpret_cast<const char*>(table + (size_t)(ok ? src : 0) * F);
        cp_async16(st + (size_t)s * 16, g + q * 16, ok);
      }
      char* sm = st + ROWS_BYTES;
      for (int s = tid; s < E * RB * SEG_M; s += kMpThreads) {
        const int nr = s / SEG_M;  // n * RB + r
        const int q = s - nr * SEG_M;
        const int n = nr / RB;
        const int r = nr - n * RB;
        const T* g = M + ((size_t)(i * E + n) * B + r0 + r) * W + w0;
        cp_async16(sm + (size_t)s * 16, reinterpret_cast<const char*>(g) + q * 16, true);
      }
    } else {
      const int n = (c - nw) / NL;
      const int l0 = (c - nw - n * NL) * kMpChunk;
      const char* g = reinterpret_cast<const char*>(w + (size_t)n * F * F + (size_t)l0 * F);
      for (int s = tid; s < kMpChunk * SEG_ROW; s += kMpThreads)
        cp_async16(st + (size_t)s * 16, g + (size_t)s * 16, true);
    }
  };

  load_chunk(0);
  if (!kPartial) {
    const char* g = reinterpret_cast<const char*>(table + ((size_t)tile * B + r0) * F);
    char* d = reinterpret_cast<char*>(s_res);
    for (int s = tid; s < RB * SEG_ROW; s += kMpThreads)
      cp_async16(d + (size_t)s * 16, g + (size_t)s * 16, true);
  }
  cp_async_commit();

  float h[E][4][4];
#pragma unroll
  for (int n = 0; n < E; ++n)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[n][a][j] = 0.0f;

  for (int c = 0; c < nw; ++c) {
    if (c + 1 < total) load_chunk(c + 1);
    cp_async_commit();  // possibly empty: the wait below counts groups
    cp_async_wait_one();
    __syncthreads();
    const T* sw = reinterpret_cast<const T*>(smem + (c & 1) * STAGE);
    const T* sm = reinterpret_cast<const T*>(smem + (c & 1) * STAGE + ROWS_BYTES);
#pragma unroll
    for (int k = 0; k < kMpChunk; ++k) {
      const float4 v = load4(sw + k * F + cg * 4);
#pragma unroll
      for (int n = 0; n < E; ++n)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float m = to_f32(sm[(n * RB + rg * 4 + a) * kMpChunk + k]);
          h[n][a][0] = fmaf(m, v.x, h[n][a][0]);
          h[n][a][1] = fmaf(m, v.y, h[n][a][1]);
          h[n][a][2] = fmaf(m, v.z, h[n][a][2]);
          h[n][a][3] = fmaf(m, v.w, h[n][a][3]);
        }
    }
    __syncthreads();  // stage c & 1 is refilled by the next iteration's load_chunk
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.0f;
#pragma unroll
  for (int n = 0; n < E; ++n) {
    // every read of the previous channel's h ended at the last barrier
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(s_h + (rg * 4 + a) * F + cg * 4) =
          make_float4(round_to<T>(h[n][a][0]), round_to<T>(h[n][a][1]),
                      round_to<T>(h[n][a][2]), round_to<T>(h[n][a][3]));
    for (int l = 0; l < NL; ++l) {
      const int c = nw + n * NL + l;
      if (c + 1 < total) load_chunk(c + 1);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();  // also publishes this channel's s_h
      const T* sw = reinterpret_cast<const T*>(smem + (c & 1) * STAGE);
      const int l0 = l * kMpChunk;
#pragma unroll
      for (int k = 0; k < kMpChunk; ++k) {
        const float4 v = load4(sw + k * F + cg * 4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float hv = s_h[(rg * 4 + a) * F + l0 + k];
          acc[a][0] = fmaf(hv, v.x, acc[a][0]);
          acc[a][1] = fmaf(hv, v.y, acc[a][1]);
          acc[a][2] = fmaf(hv, v.z, acc[a][2]);
          acc[a][3] = fmaf(hv, v.w, acc[a][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = rg * 4 + a;
    const size_t o = (out_row0 + r) * F + cg * 4;
    if constexpr (kPartial) {
      store4(static_cast<float*>(out_) + o,
             make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
    } else {
      const float s = inv[(size_t)tile * B + r0 + r];
      const float4 res = load4(s_res + (size_t)r * F + cg * 4);
      store4(static_cast<T*>(out_) + o,
             make_float4(activate(acc[a][0] * s, act) + res.x,
                         activate(acc[a][1] * s, act) + res.y,
                         activate(acc[a][2] * s, act) + res.z,
                         activate(acc[a][3] * s, act) + res.w));
    }
  }
}

template <int F, int E, typename T, bool kPartial>
cudaError_t launch_mp(const T* M, const int* lo, const int* ids, const T* table, const T* w,
                      const float* inv, void* out, int tiles, int B, int W, int n_table,
                      int act, cudaStream_t stream) {
  constexpr int RB = mp_rows_per_block<F>();
  constexpr size_t smem = mp_smem_bytes<F, E, T, kPartial>();
  if (B % RB != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mp_banded_kernel<F, E, T, kPartial>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mp_banded_kernel<F, E, T, kPartial><<<tiles * (B / RB), kMpThreads, smem, stream>>>(
      M, lo, ids, table, w, inv, out, B, W, n_table, act);
  return cudaGetLastError();
}

// Dispatch on the runtime (F, E) to the instantiated kernels. The full
// layer reads whole B-row tiles of the table; the partial one any rows.
template <typename T, bool kPartial>
cudaError_t launch_mp_any(int F, int E, const T* M, const int* lo, const int* ids,
                          const T* table, const T* w, const float* inv, void* out, int tiles,
                          int B, int W, int n_table, int act, cudaStream_t s) {
  if (tiles < 1 || B < 1 || W < 1 || W % kMpChunk != 0 || n_table < 1 ||
      (!kPartial && (n_table < B || n_table % B != 0)))
    return cudaErrorInvalidValue;
#define NMR_MP_CASE(FF, EE)                                                                   \
  if (F == FF && E == EE)                                                                     \
    return launch_mp<FF, EE, T, kPartial>(M, lo, ids, table, w, inv, out, tiles, B, W, n_table, \
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

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One MP layer (activation(aggregate) + residual) over `tiles` grid tiles.
// ids null: tile i updates rows [i*B, (i+1)*B) (mp_banded, mp_banded_hbm);
// else grid tile i updates tile ids[i] into output rows [i*B, (i+1)*B)
// (mp_banded_hbm_cls). n_table: rows of the node table, a multiple of B.
int nmr_mp_banded(const float* M, const int* lo, const int* ids, const float* table,
                  const float* w, const float* inv, float* out, int tiles, int E, int B, int W,
                  int F, int n_table, int act, void* stream) {
  return launch_mp_any<float, false>(F, E, M, lo, ids, table, w, inv, out, tiles, B, W, n_table,
                                     act, static_cast<cudaStream_t>(stream));
}

int nmr_mp_banded_bf16(const __nv_bfloat16* M, const int* lo, const int* ids,
                       const __nv_bfloat16* table, const __nv_bfloat16* w, const float* inv,
                       __nv_bfloat16* out, int tiles, int E, int B, int W, int F, int n_table,
                       int act, void* stream) {
  return launch_mp_any<__nv_bfloat16, false>(F, E, M, lo, ids, table, w, inv, out, tiles, B, W,
                                             n_table, act, static_cast<cudaStream_t>(stream));
}

// The partial layer (mp_banded_partial): float32 acc of every grid tile's
// rows, no inv_degree, activation or residual; the table may have any
// number of rows.
int nmr_mp_banded_partial(const float* M, const int* lo, const float* table, const float* w,
                          float* out, int tiles, int E, int B, int W, int F, int n_table,
                          void* stream) {
  return launch_mp_any<float, true>(F, E, M, lo, nullptr, table, w, nullptr, out, tiles, B, W,
                                    n_table, kLinear, static_cast<cudaStream_t>(stream));
}

int nmr_mp_banded_partial_bf16(const __nv_bfloat16* M, const int* lo,
                               const __nv_bfloat16* table, const __nv_bfloat16* w, float* out,
                               int tiles, int E, int B, int W, int F, int n_table,
                               void* stream) {
  return launch_mp_any<__nv_bfloat16, true>(F, E, M, lo, nullptr, table, w, nullptr, out, tiles,
                                            B, W, n_table, kLinear,
                                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
