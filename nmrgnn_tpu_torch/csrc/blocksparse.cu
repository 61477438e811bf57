// The hand-written Hopper kernels of the block-sparse path of
// nmrgnn_tpu_torch: the adjacency build and the block-sparse MP layer.
// ops/blocksparse.py holds the wrappers (one per TPU kernel, each with its
// launch count) and the plain PyTorch version of each.
//
// Built by ops/_cuda.py like the other sources (nvcc, sm_90a, -O3, no fast
// math) and bound with ctypes through the extern "C" functions at the end.
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch. All offsets into A are
// 64-bit: at 100,000 atoms A holds about 1.1e9 elements (4.3 GB in f32).
//
// The structure (host, ops/blocksparse.block_structure) lists the active
// (row block, col block) pairs sorted by row block; padding pairs have
// pair_valid 0 and sit at the end of a row's run (group > 1) or of the
// list (row nb - 1, col 0).
//
// -- Adjacency build ---------------------------------------------------------
// Replaces _build_adj_kernel (nmrgnn_tpu/ops/blocksparse.py:215-293), one
// grid step per pair that compares the row block's K slots with the col
// block's B lanes:
//   A[p, n, b, q] = valid[p] * sum_k e[rB + b, k, n] * [nlist[rB + b, k] == cB + q]
// Here one block per pair; a warp takes one row b at a time, its lanes
// read the row's K slots (index and E values) and pass them round by
// shuffle, and each lane owns four adjacent columns q of every channel, so
// the float32 sum runs in slot order (duplicate neighbors add) and is
// rounded once to the output type. A padding pair writes zeros; a padded
// row (nlist -1) matches nothing. Bound: writing A, P*E*B*B elements, at
// the card's memory rate; at K = 16 the shuffle loop issues in less time
// than the stores take, so the kernel's design is to keep the stores
// 16-byte (8 in bf16), coalesced across the warp, and never read A.
//
// -- Block-sparse MP layer ---------------------------------------------------
// Replaces _mp_bs_kernel and _mp_bs_kernel_grouped (:301-443), which walk
// the pairs in row order carrying h [E, B, F] in VMEM across grid steps and
// finalize a row block on its last pair:
//   h_n  = sum over the pairs p of row block r of A[p, n] @ nodes[col block]
//   out_r = T(act((sum_n h_n @ w[n]) * inv_degree) + nodes_r)
// Blocks run in no order on Hopper, so the carry becomes a loop inside the
// block over its row block's pairs (CSR offsets row_ptr). h for a whole
// 128-row block is 393 KB in float32 at F = 256, so a block takes RB rows
// of the row block and all F columns (8 blocks per row block at F = 256),
// each thread a 4 x 4 register tile per channel, as hbm.cu's MP kernel
// does. The pairs' node rows and A columns stream through shared memory in
// chunks of 16, then the weights, copied by 16-byte cp.async into two
// stages so chunk c + 1 is in flight while chunk c's FMAs run. A is about
// 0.5% nonzero at 100,000 atoms: a chunk whose A values are all zero for
// the block's rows skips its FMAs (it adds only zeros). Unlike the banded
// layer, h stays float32 into the second product (the TPU kernel's
// jnp.dot(h_acc[n], w_ref[n]) promotes the bf16 weights to float32); the
// epilogue is float32, rounded once to T. A pair col outside [0, nb)
// reads zero node rows and row_ptr offsets are clamped to [0, P], so a
// bad structure given on the card reads nothing out of bounds. Walking a
// padding pair adds zeros, so the grouped TPU kernel (G pairs a grid
// step) is this kernel too, on a structure built with group = G. Bound: reading A once (its
// nonzeros' products are a fraction of that time). The kernel spends its
// time on the float32 FMAs of the nonzero chunks (2*E*RB*16*F each) and
// of the W product (2*nb*E*B*F*F), and on staging every chunk of A and of
// the col blocks' node rows through shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;
constexpr unsigned kFullMask = 0xffffffffu;

// -- adjacency build ---------------------------------------------------------

template <int E, typename OutT>
__global__ void __launch_bounds__(kThreads)
    build_adj_kernel(const int* __restrict__ nlist,      // [nb * B, K], -1 on padded rows
                     const float* __restrict__ e,        // [nb * B, K, E]
                     const int* __restrict__ pair_rows,  // [P]
                     const int* __restrict__ pair_cols,  // [P]
                     const int* __restrict__ pair_valid, // [P]
                     OutT* __restrict__ A,               // [P, E, B, B]
                     int nb, int B, int K) {
  const int p = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = pair_rows[p];
  const int c = pair_cols[p];
  // uniform over the block, so every lane below takes part in the shuffles
  const bool valid = pair_valid[p] != 0 && r >= 0 && r < nb && c >= 0 && c < nb;
  const size_t pair_base = (size_t)p * E * B * B;
  const int col0 = c * B;
  for (int b = warp; b < B; b += kThreads / 32) {
    const size_t row = (size_t)r * B + b;
    for (int qb = 0; qb < B; qb += 128) {
      const int q0 = qb + lane * 4;
      float acc[E][4];
#pragma unroll
      for (int n = 0; n < E; ++n)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[n][l] = 0.0f;
      if (valid) {
        for (int k0 = 0; k0 < K; k0 += 32) {
          const int k = k0 + lane;
          int rel = -1;
          float ev[E];
#pragma unroll
          for (int n = 0; n < E; ++n) ev[n] = 0.0f;
          if (k < K) {
            rel = nlist[row * K + k] - col0;
#pragma unroll
            for (int n = 0; n < E; ++n) ev[n] = e[(row * K + k) * E + n];
          }
          const int kn = min(32, K - k0);
          for (int j = 0; j < kn; ++j) {  // slot order
            const int d = __shfl_sync(kFullMask, rel, j) - q0;
            float ej[E];
#pragma unroll
            for (int n = 0; n < E; ++n) ej[n] = __shfl_sync(kFullMask, ev[n], j);
            if (static_cast<unsigned>(d) < 4u) {
#pragma unroll
              for (int l = 0; l < 4; ++l)
                if (d == l) {
#pragma unroll
                  for (int n = 0; n < E; ++n) acc[n][l] += ej[n];
                }
            }
          }
        }
      }
      if (q0 < B) {
#pragma unroll
        for (int n = 0; n < E; ++n)
          store4(A + pair_base + ((size_t)n * B + b) * B + q0,
                 make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]));
      }
    }
  }
}

template <int E, typename OutT>
cudaError_t launch_adj(const int* nlist, const float* e, const int* rows, const int* cols,
                       const int* valid, OutT* A, int P, int nb, int B, int K,
                       cudaStream_t stream) {
  build_adj_kernel<E, OutT><<<P, kThreads, 0, stream>>>(nlist, e, rows, cols, valid, A, nb, B, K);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_adj_any(int E, const int* nlist, const float* e, const int* rows,
                           const int* cols, const int* valid, OutT* A, int P, int nb, int B,
                           int K, cudaStream_t s) {
  if (P < 1 || nb < 1 || B < 4 || B % 4 != 0 || K < 1) return cudaErrorInvalidValue;
  switch (E) {
    case 1: return launch_adj<1, OutT>(nlist, e, rows, cols, valid, A, P, nb, B, K, s);
    case 2: return launch_adj<2, OutT>(nlist, e, rows, cols, valid, A, P, nb, B, K, s);
    case 3: return launch_adj<3, OutT>(nlist, e, rows, cols, valid, A, P, nb, B, K, s);
    case 4: return launch_adj<4, OutT>(nlist, e, rows, cols, valid, A, P, nb, B, K, s);
    default: return cudaErrorInvalidValue;
  }
}

// -- block-sparse MP layer ---------------------------------------------------

template <int F>
__host__ __device__ constexpr int bs_rows_per_block() {
  return (kThreads / (F / 4)) * 4;
}

// Shared memory of one block, in bytes: two stages (16 node rows or 16
// W_n rows, and the A chunk of the block's rows), h as float32, the
// residual rows.
template <int F, int E, typename T>
__host__ __device__ constexpr size_t bs_stage_bytes() {
  return (size_t)kChunk * F * sizeof(T) + (size_t)E * bs_rows_per_block<F>() * kChunk * sizeof(T);
}
template <int F, int E, typename T>
__host__ __device__ constexpr size_t bs_smem_bytes() {
  return 2 * bs_stage_bytes<F, E, T>() + (size_t)bs_rows_per_block<F>() * F * sizeof(float) +
         (size_t)bs_rows_per_block<F>() * F * sizeof(T);
}

template <int F, int E, typename T>
__global__ void __launch_bounds__(kThreads)
    mp_blocksparse_kernel(const T* __restrict__ A,            // [P, E, B, B]
                          const int* __restrict__ row_ptr,    // [nb + 1]
                          const int* __restrict__ pair_cols,  // [P]
                          const T* __restrict__ nodes,        // [nb * B, F]
                          const T* __restrict__ w,            // [E, F, F]
                          const float* __restrict__ inv,      // [nb * B]
                          T* __restrict__ out,                // [nb * B, F]
                          int P, int nb, int B, int act) {
  constexpr int CG = F / 4;          // column groups of 4
  constexpr int RG = kThreads / CG;  // row groups of 4 rows
  constexpr int RB = RG * 4;         // rows per block
  constexpr int SEG_ROW = F * (int)sizeof(T) / 16;     // 16-byte pieces of a table row
  constexpr int SEG_A = kChunk * (int)sizeof(T) / 16;  // of an A row's chunk
  constexpr int A_WORDS = E * RB * kChunk * (int)sizeof(T) / 4;
  constexpr size_t STAGE = bs_stage_bytes<F, E, T>();
  constexpr size_t ROWS_BYTES = (size_t)kChunk * F * sizeof(T);
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* s_h = reinterpret_cast<float*>(smem + 2 * STAGE);                // [RB][F]
  T* s_res = reinterpret_cast<T*>(smem + 2 * STAGE + (size_t)RB * F * 4);  // [RB][F]

  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int rg = tid / CG;
  const int per_row = B / RB;
  const int r = blockIdx.x / per_row;  // row block
  const int r0 = (blockIdx.x - r * per_row) * RB;
  const size_t row0 = (size_t)r * B + r0;  // the block's first table row
  // offsets outside [0, P] are clamped: a block reads only pairs that exist
  const int p0 = min(max(row_ptr[r], 0), P);
  const int cpp = B / kChunk;  // chunks per pair
  const int nw = (min(max(row_ptr[r + 1], p0), P) - p0) * cpp;
  constexpr int NL = F / kChunk;  // W_n chunks per channel
  const int total = nw + E * NL;

  // Chunk c < nw: node rows [cB + s, +16) of pair p's col block c and A's
  // columns [s, +16) of the block's rows; else W_n rows [l0, l0 + 16).
  auto load_chunk = [&](int ch) {
    char* st = smem + (ch & 1) * STAGE;
    if (ch < nw) {
      const int p = p0 + ch / cpp;
      const int s0 = (ch % cpp) * kChunk;
      const int col = pair_cols[p];
      const bool ok = col >= 0 && col < nb;  // a col out of range reads zeros
      const char* g = reinterpret_cast<const char*>(nodes + ((size_t)(ok ? col : 0) * B + s0) * F);
      for (int s = tid; s < kChunk * SEG_ROW; s += kThreads)
        cp_async16(st + (size_t)s * 16, g + (size_t)s * 16, ok);
      char* sa = st + ROWS_BYTES;
      for (int s = tid; s < E * RB * SEG_A; s += kThreads) {
        const int nr = s / SEG_A;  // n * RB + row
        const int q = s - nr * SEG_A;
        const int n = nr / RB;
        const T* ga = A + (((size_t)p * E + n) * B + r0 + (nr - n * RB)) * B + s0;
        cp_async16(sa + (size_t)s * 16, reinterpret_cast<const char*>(ga) + q * 16, true);
      }
    } else {
      const int n = (ch - nw) / NL;
      const int l0 = (ch - nw - n * NL) * kChunk;
      const char* g = reinterpret_cast<const char*>(w + (size_t)n * F * F + (size_t)l0 * F);
      for (int s = tid; s < kChunk * SEG_ROW; s += kThreads)
        cp_async16(st + (size_t)s * 16, g + (size_t)s * 16, true);
    }
  };

  load_chunk(0);
  {
    const char* g = reinterpret_cast<const char*>(nodes + row0 * F);
    char* d = reinterpret_cast<char*>(s_res);
    for (int s = tid; s < RB * SEG_ROW; s += kThreads)
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

  for (int ch = 0; ch < nw; ++ch) {
    if (ch + 1 < total) load_chunk(ch + 1);
    cp_async_commit();  // possibly empty: the wait below counts groups
    cp_async_wait_one();
    __syncthreads();
    const T* sw = reinterpret_cast<const T*>(smem + (ch & 1) * STAGE);
    const T* sa = reinterpret_cast<const T*>(smem + (ch & 1) * STAGE + ROWS_BYTES);
    unsigned any = 0;
    for (int i = tid; i < A_WORDS; i += kThreads) any |= reinterpret_cast<const unsigned*>(sa)[i];
    if (__syncthreads_or(any != 0)) {  // an all-zero chunk adds nothing
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float4 v = load4(sw + k * F + cg * 4);
#pragma unroll
        for (int n = 0; n < E; ++n)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float m = to_f32(sa[(n * RB + rg * 4 + a) * kChunk + k]);
            h[n][a][0] = fmaf(m, v.x, h[n][a][0]);
            h[n][a][1] = fmaf(m, v.y, h[n][a][1]);
            h[n][a][2] = fmaf(m, v.z, h[n][a][2]);
            h[n][a][3] = fmaf(m, v.w, h[n][a][3]);
          }
      }
    }
    __syncthreads();  // stage ch & 1 is refilled by the next iteration's load_chunk
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.0f;
#pragma unroll
  for (int n = 0; n < E; ++n) {
    // every read of the previous channel's h ended at the last barrier;
    // h goes in as float32, not rounded to T
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(s_h + (rg * 4 + a) * F + cg * 4) =
          make_float4(h[n][a][0], h[n][a][1], h[n][a][2], h[n][a][3]);
    for (int l = 0; l < NL; ++l) {
      const int ch = nw + n * NL + l;
      if (ch + 1 < total) load_chunk(ch + 1);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();  // also publishes this channel's s_h
      const T* sw = reinterpret_cast<const T*>(smem + (ch & 1) * STAGE);
      const int l0 = l * kChunk;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
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
    const int rr = rg * 4 + a;
    const float s = inv[row0 + rr];
    const float4 res = load4(s_res + (size_t)rr * F + cg * 4);
    store4(out + (row0 + rr) * F + cg * 4,
           make_float4(activate(acc[a][0] * s, act) + res.x, activate(acc[a][1] * s, act) + res.y,
                       activate(acc[a][2] * s, act) + res.z,
                       activate(acc[a][3] * s, act) + res.w));
  }
}

template <int F, int E, typename T>
cudaError_t launch_mp(const T* A, const int* row_ptr, const int* cols, const T* nodes, const T* w,
                      const float* inv, T* out, int P, int nb, int B, int act,
                      cudaStream_t stream) {
  constexpr int RB = bs_rows_per_block<F>();
  constexpr size_t smem = bs_smem_bytes<F, E, T>();
  if (B % RB != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mp_blocksparse_kernel<F, E, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mp_blocksparse_kernel<F, E, T><<<nb * (B / RB), kThreads, smem, stream>>>(
      A, row_ptr, cols, nodes, w, inv, out, P, nb, B, act);
  return cudaGetLastError();
}

// Dispatch on the runtime (F, E) to the instantiated kernels.
template <typename T>
cudaError_t launch_mp_any(int F, int E, const T* A, const int* row_ptr, const int* cols,
                          const T* nodes, const T* w, const float* inv, T* out, int P, int nb,
                          int B, int act, cudaStream_t s) {
  if (P < 0 || nb < 1 || B < kChunk || B % kChunk != 0) return cudaErrorInvalidValue;
#define NMR_BS_CASE(FF, EE) \
  if (F == FF && E == EE)   \
    return launch_mp<FF, EE, T>(A, row_ptr, cols, nodes, w, inv, out, P, nb, B, act, s);
#define NMR_BS_F(FF) NMR_BS_CASE(FF, 1) NMR_BS_CASE(FF, 2) NMR_BS_CASE(FF, 3) NMR_BS_CASE(FF, 4)
  NMR_BS_F(64)
  NMR_BS_F(128)
  NMR_BS_F(256)
#undef NMR_BS_F
#undef NMR_BS_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A [P, E, B, B] (float32, or bfloat16 with out_bf16) from the padded
// neighbor lists nlist [nb * B, K] (-1 on padded rows) and edge values
// e [nb * B, K, E] (float32).
int nmr_build_block_adjacency(const int* nlist, const float* e, const int* pair_rows,
                              const int* pair_cols, const int* pair_valid, void* A, int P, int nb,
                              int B, int K, int E, int out_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_adj_any<__nv_bfloat16>(E, nlist, e, pair_rows, pair_cols, pair_valid,
                                         static_cast<__nv_bfloat16*>(A), P, nb, B, K, s);
  return launch_adj_any<float>(E, nlist, e, pair_rows, pair_cols, pair_valid,
                               static_cast<float*>(A), P, nb, B, K, s);
}

// One block-sparse MP layer (activation(aggregate) + residual) over the nb
// row blocks; the pairs of row block r are [row_ptr[r], row_ptr[r + 1]) of
// the P pairs.
int nmr_mp_blocksparse(const float* A, const int* row_ptr, const int* pair_cols,
                       const float* nodes, const float* w, const float* inv, float* out, int P,
                       int nb, int E, int B, int F, int act, void* stream) {
  return launch_mp_any<float>(F, E, A, row_ptr, pair_cols, nodes, w, inv, out, P, nb, B, act,
                              static_cast<cudaStream_t>(stream));
}

int nmr_mp_blocksparse_bf16(const __nv_bfloat16* A, const int* row_ptr, const int* pair_cols,
                            const __nv_bfloat16* nodes, const __nv_bfloat16* w, const float* inv,
                            __nv_bfloat16* out, int P, int nb, int E, int B, int F, int act,
                            void* stream) {
  return launch_mp_any<__nv_bfloat16>(F, E, A, row_ptr, pair_cols, nodes, w, inv, out, P, nb, B,
                                      act, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
