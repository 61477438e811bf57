// The hand-written Hopper kernel of every banded MP layer of
// nmrgnn_tpu_torch: the node table read from device memory (HBM) through a
// two-stage cp.async pipeline, over all row tiles or over one window
// class's tiles, with or without the epilogue, reading its band from
// device memory or building it in the block (B13). hbm.cu instantiates the
// first two modes, fused_first.cu the third, so the two sources build in
// parallel; ops/banded.py holds the wrappers (one per TPU kernel, each
// with its launch count) and the plain PyTorch version of each.
//
// The TPU has five MP kernels: _mp_banded_kernel (nmrgnn_tpu/ops/
// banded.py:555-579) keeps the whole node table in VMEM,
// _mp_banded_hbm_kernel (:656-773) leaves it in HBM and DMAs tile t + 1's
// [W, F] window and [B, F] residual rows into a two-slot VMEM buffer while
// tile t computes, _mp_banded_hbm_cls_kernel (:1703-1823) does that over
// one class's tiles, _mp_banded_partial_kernel (:833-894) drops the
// epilogue, and _poly_mp_fused_kernel (:1451-1519) builds tile t's
// Chebyshev band into VMEM scratch while the MXU runs layer 1 on tile
// t - 1. On Hopper no table is resident on chip, so all five are this one
// kernel:
//   acc = sum_n round_T(M[i, n] @ table[lo_i : lo_i + W]) @ w[n]
//   kFull:    out[i*B + r] = T(act(acc * inv_degree) + table[tile*B + r])
//   kPartial: out[i*B + r] = acc (float32)
//   kBuild:   kFull with ids null, where M[i] is not read but built in the
//             block from the raw distances (the Chebyshev band build of
//             poly.cu) and written once to m_out
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
// kBuild (B13). The TPU kernel overlaps the build of tile t with the
// matmuls of tile t - 1 along its sequential grid; Hopper has no such
// order, and what the fusion saves is the band's round trip through
// device memory between the build and layer 1. So the block builds its
// own rows' band: at its start, the Chebyshev values of its RB x K slots
// (common.cuh's cheb_edge, the function of poly.cu, so the values equal
// B4's bit for bit) and their window-relative indices go to shared
// memory, with a bit per row and window chunk that says whether any of
// the row's slots falls in the chunk; then, while chunk c + 1's window
// rows are in flight, the block compare-accumulates chunk c + 1's
// [E, RB, 16] band in float32 in slot order (a row whose bit is clear
// skips the compares: its 16 neighbors touch a few of the W / 16 chunks),
// writes it once to m_out in its output type (each band row belongs to
// exactly one block: no atomics) and stores it, rounded to T, into the
// stage where the cp.async kernel modes would have loaded M.
// Layer 1 thus uses the float32 band rounded to the table's type, as
// _poly_mp_fused_kernel does (m_scratch[slot, n].astype(win.dtype),
// :1489-1491), whatever m_out's type.
//
// Bound: the kernel does the dense products, 2*T*E*B*W*F + 2*T*E*B*F*F
// FMAs in float32 on the CUDA cores, and that is what it spends its time
// on; the data-dependent bound (the band's nonzeros) is operations in
// float32 and bytes in bfloat16 at the main paths' shapes. The build adds
// K compares per band entry, 16 x 16 x K x E per chunk against the
// chunk's 16 x 16 x F x E FMAs.

#pragma once

#include "common.cuh"

namespace {

constexpr int kMpThreads = 256;
constexpr int kMpChunk = 16;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use

// What one launch computes (see above).
enum MpMode { kFull = 0, kPartial = 1, kBuild = 2 };

// The in-block band build of kBuild (unused by the other modes).
struct ChebBuild {
  const int* nlist;  // [T*B, K], -1 on padded rows
  const float* d;    // [T*B, K] raw distances, 0 on padded rows
  const float* c;    // [degree + 1, E] Chebyshev coefficients
  void* m_out;       // [T, E, B, W], float32 or bfloat16 (m_bf16)
  int K, degree, m_bf16;
  float d_lo, d_hi, span;
};

template <int F>
__host__ __device__ constexpr int mp_rows_per_block() {
  return (kMpThreads / (F / 4)) * 4;
}

// Shared memory of one block, in bytes: two stages (a chunk of window rows
// or of W_n rows, and the band chunk), h as float32, the residual rows
// (not kPartial).
template <int F, int E, typename T>
__host__ __device__ constexpr size_t mp_stage_bytes() {
  return (size_t)kMpChunk * F * sizeof(T) +
         (size_t)E * mp_rows_per_block<F>() * kMpChunk * sizeof(T);
}
template <int F, int E, typename T, int kMode>
__host__ __device__ constexpr size_t mp_smem_bytes() {
  return 2 * mp_stage_bytes<F, E, T>() + (size_t)mp_rows_per_block<F>() * F * sizeof(float) +
         (kMode == kPartial ? 0 : (size_t)mp_rows_per_block<F>() * F * sizeof(T));
}

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// kBuild's shared memory after mp_smem_bytes: the coefficients, the
// RB x K slots' window-relative indices, each row's chunk bits
// (ceil(W / 16 / 32) words), then the slots' E values.
__host__ __device__ constexpr size_t build_coeff_bytes(int E, int degree) {
  return round16((size_t)(degree + 1) * E * sizeof(float));
}
__host__ __device__ constexpr size_t build_rel_bytes(int RB, int K) {
  return round16((size_t)RB * K * sizeof(int));
}
__host__ __device__ constexpr int build_mask_words(int W) { return (W / kMpChunk + 31) / 32; }
__host__ __device__ constexpr size_t build_mask_bytes(int RB, int W) {
  return round16((size_t)RB * build_mask_words(W) * sizeof(unsigned));
}
__host__ __device__ constexpr size_t build_smem_bytes(int RB, int E, int K, int degree, int W) {
  return build_coeff_bytes(E, degree) + build_rel_bytes(RB, K) + build_mask_bytes(RB, W) +
         (size_t)RB * K * E * sizeof(float);
}

template <int F, int E, typename T, int kMode>
__global__ void __launch_bounds__(kMpThreads)
    mp_banded_kernel(const T* __restrict__ M,        // [tiles, E, B, W] (not kBuild)
                     const int* __restrict__ lo,     // [tiles] window starts
                     const int* __restrict__ ids,    // [tiles] tile ids, or null
                     const T* __restrict__ table,    // [n_table, F] node table
                     const T* __restrict__ w,        // [E, F, F]
                     const float* __restrict__ inv,  // [n_table] (not kPartial)
                     void* __restrict__ out_,        // [tiles * B, F]: T, or float if partial
                     int B, int W, int n_table, int act, ChebBuild bld) {
  constexpr bool kPart = kMode == kPartial;
  constexpr int CG = F / 4;            // column groups of 4
  constexpr int RG = kMpThreads / CG;  // row groups of 4 rows
  constexpr int RB = RG * 4;           // rows per block
  constexpr int SEG_ROW = F * (int)sizeof(T) / 16;       // 16-byte pieces of a table row
  constexpr int SEG_M = kMpChunk * (int)sizeof(T) / 16;  // of a band row's chunk
  constexpr size_t STAGE = mp_stage_bytes<F, E, T>();
  constexpr size_t ROWS_BYTES = (size_t)kMpChunk * F * sizeof(T);
  constexpr size_t BASE_BYTES = mp_smem_bytes<F, E, T, kMode>();
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
  if (!kPart && (tile < 0 || tile >= n_table / B)) {  // a bad id reads nothing
    T* out_rows = static_cast<T*>(out_) + out_row0 * F;
    for (int s = tid; s < RB * CG; s += kMpThreads)
      store4(out_rows + (size_t)s * 4, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  const int base = lo[i];
  const int nw = W / kMpChunk;      // window chunks
  constexpr int NL = F / kMpChunk;  // W_n chunks per channel
  const int total = nw + E * NL;

  // Chunk c < nw: window rows [base + c*16, +16) and (not kBuild) the
  // band's columns [c*16, +16) of the block's rows; else W_n rows
  // [l0, l0 + 16).
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
      if constexpr (kMode != kBuild) {
        char* sm = st + ROWS_BYTES;
        for (int s = tid; s < E * RB * SEG_M; s += kMpThreads) {
          const int nr = s / SEG_M;  // n * RB + r
          const int q = s - nr * SEG_M;
          const int n = nr / RB;
          const int r = nr - n * RB;
          const T* g = M + ((size_t)(i * E + n) * B + r0 + r) * W + w0;
          cp_async16(sm + (size_t)s * 16, reinterpret_cast<const char*>(g) + q * 16, true);
        }
      }
    } else {
      const int n = (c - nw) / NL;
      const int l0 = (c - nw - n * NL) * kMpChunk;
      const char* g = reinterpret_cast<const char*>(w + (size_t)n * F * F + (size_t)l0 * F);
      for (int s = tid; s < kMpChunk * SEG_ROW; s += kMpThreads)
        cp_async16(st + (size_t)s * 16, g + (size_t)s * 16, true);
    }
  };

  // kBuild: the block's slots, then chunk c's band built into its stage
  // and written to m_out.
  const int MW = build_mask_words(W);
  char* bld_smem = smem + BASE_BYTES;
  float* s_c = reinterpret_cast<float*>(bld_smem);
  bld_smem += build_coeff_bytes(E, bld.degree);
  int* s_rel = reinterpret_cast<int*>(bld_smem);  // [RB][K]
  bld_smem += build_rel_bytes(RB, bld.K);
  unsigned* s_bits = reinterpret_cast<unsigned*>(bld_smem);  // [RB][MW]
  float* s_e = reinterpret_cast<float*>(bld_smem + build_mask_bytes(RB, W));  // [RB][K][E]
  auto build_chunk = [&](int c) {
    T* sm = reinterpret_cast<T*>(smem + (c & 1) * STAGE + ROWS_BYTES);  // [E][RB][16]
    const int w0 = c * kMpChunk;
    for (int s = tid; s < RB * kMpChunk; s += kMpThreads) {
      const int r = s / kMpChunk;
      const int j = s - r * kMpChunk;
      const int* rel = s_rel + r * bld.K;
      const float* ev = s_e + (size_t)r * bld.K * E;
      float acc[E];
#pragma unroll
      for (int n = 0; n < E; ++n) acc[n] = 0.0f;
      if (s_bits[r * MW + (c >> 5)] & (1u << (c & 31))) {
#pragma unroll 4
        for (int k = 0; k < bld.K; ++k) {
          if (rel[k] == w0 + j) {
#pragma unroll
            for (int n = 0; n < E; ++n) acc[n] += ev[k * E + n];
          }
        }
      }
#pragma unroll
      for (int n = 0; n < E; ++n) {
        sm[(n * RB + r) * kMpChunk + j] = from_f32<T>(acc[n]);
        const size_t o = ((size_t)(i * E + n) * B + r0 + r) * W + w0 + j;
        if (bld.m_bf16)
          static_cast<__nv_bfloat16*>(bld.m_out)[o] = __float2bfloat16_rn(acc[n]);
        else
          static_cast<float*>(bld.m_out)[o] = acc[n];
      }
    }
  };

  load_chunk(0);
  if constexpr (!kPart) {
    const char* g = reinterpret_cast<const char*>(table + ((size_t)tile * B + r0) * F);
    char* d = reinterpret_cast<char*>(s_res);
    for (int s = tid; s < RB * SEG_ROW; s += kMpThreads)
      cp_async16(d + (size_t)s * 16, g + (size_t)s * 16, true);
  }
  cp_async_commit();
  if constexpr (kMode == kBuild) {
    for (int j = tid; j < (bld.degree + 1) * E; j += kMpThreads) s_c[j] = bld.c[j];
    for (int j = tid; j < RB * MW; j += kMpThreads) s_bits[j] = 0u;
    __syncthreads();
    const size_t slot0 = ((size_t)i * B + r0) * bld.K;  // rows r0.. of tile i
    for (int s = tid; s < RB * bld.K; s += kMpThreads) {
      const int rel = bld.nlist[slot0 + s] - base;
      s_rel[s] = rel;
      if (rel >= 0 && rel < W) {
        const int c = rel / kMpChunk;
        atomicOr(s_bits + (s / bld.K) * MW + (c >> 5), 1u << (c & 31));
      }
      cheb_edge<E>(bld.d[slot0 + s], s_c, bld.degree, bld.d_lo, bld.d_hi, bld.span,
                   s_e + (size_t)s * E);
    }
    __syncthreads();
    build_chunk(0);  // published by the first iteration's barrier
  }

  float h[E][4][4];
#pragma unroll
  for (int n = 0; n < E; ++n)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[n][a][j] = 0.0f;

  for (int c = 0; c < nw; ++c) {
    if (c + 1 < total) load_chunk(c + 1);
    if constexpr (kMode == kBuild) {
      if (c + 1 < nw) build_chunk(c + 1);  // stage (c + 1) & 1 is free since the last barrier
    }
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
    if constexpr (kPart) {
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

template <int F, int E, typename T, int kMode>
cudaError_t launch_mp(const T* M, const int* lo, const int* ids, const T* table, const T* w,
                      const float* inv, void* out, int tiles, int B, int W, int n_table,
                      int act, const ChebBuild& bld, cudaStream_t stream) {
  constexpr int RB = mp_rows_per_block<F>();
  const size_t smem = mp_smem_bytes<F, E, T, kMode>() +
                      (kMode == kBuild ? build_smem_bytes(RB, E, bld.K, bld.degree, W) : 0);
  if (B % RB != 0 || smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mp_banded_kernel<F, E, T, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mp_banded_kernel<F, E, T, kMode><<<tiles * (B / RB), kMpThreads, smem, stream>>>(
      M, lo, ids, table, w, inv, out, B, W, n_table, act, bld);
  return cudaGetLastError();
}

// Dispatch on the runtime (F, E) to the instantiated kernels. The full
// layer reads whole B-row tiles of the table; the partial one any rows.
template <typename T, int kMode>
cudaError_t launch_mp_any(int F, int E, const T* M, const int* lo, const int* ids,
                          const T* table, const T* w, const float* inv, void* out, int tiles,
                          int B, int W, int n_table, int act, const ChebBuild& bld,
                          cudaStream_t s) {
  if (tiles < 1 || B < 1 || W < 1 || W % kMpChunk != 0 || n_table < 1 ||
      (kMode != kPartial && (n_table < B || n_table % B != 0)))
    return cudaErrorInvalidValue;
#define NMR_MP_CASE(FF, EE)                                                                \
  if (F == FF && E == EE)                                                                  \
    return launch_mp<FF, EE, T, kMode>(M, lo, ids, table, w, inv, out, tiles, B, W, n_table, \
                                       act, bld, s);
#define NMR_MP_F(FF) NMR_MP_CASE(FF, 1) NMR_MP_CASE(FF, 2) NMR_MP_CASE(FF, 3) NMR_MP_CASE(FF, 4)
  NMR_MP_F(64)
  NMR_MP_F(128)
  NMR_MP_F(256)
#undef NMR_MP_F
#undef NMR_MP_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
