// The hand-written Hopper kernels of the block-sparse path of
// nmrgnn_tpu_torch: the adjacency build, the block occupancy and the
// block-sparse MP layer (mp.cuh's kernel in its kPairs mode).
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
// Replaces _mp_bs_kernel and _mp_bs_kernel_grouped (:299-443), which walk
// the pairs in row order carrying h [E, B, F] in VMEM across grid steps and
// finalize a row block on its last pair:
//   h_n  = sum over the pairs p of row block r of A[p, n] @ nodes[col block]
//   out_r = T(act((sum_n h_n @ w[n]) * inv_degree) + nodes_r)
// mp.cuh's MP kernel computes it in its kPairs mode (the band's window
// becomes each pair's col block), instantiated here: a block takes 32 rows
// of a row block, lists the (pair, 16-column chunk) entries its slab of A
// occupies, stages only those (node rows and A chunk, cp.async, 4 stages
// in float32, 6 in bfloat16), walks their nonzeros in ascending order with
// fmaf, and runs the second product with h in float32 (bfloat16: split
// into two bfloat16 halves on the tensor cores). mp.cuh says why and what
// bounds it. It walks the pairs in CSR order and never lists a padding
// pair, so the grouped TPU kernel (G pairs a grid step) is this kernel
// too, on a structure built with group = G, and equals it bit for bit.
//
// -- The block occupancy -------------------------------------------------------
// A kernel of the port with no TPU counterpart, feeding kPairs: one bit per
// (pair, 32-row slab, 16-column chunk), bit s * (B / 16) + c of pair p's
// pair_words(B) words, set when A[p, :, 32 s : +32, 16 c : +16] holds a
// nonzero. From the neighbor list (block_occupancy_kernel, made once per
// structure and frame and shared by the forward's 4 layers): a slot of row
// rB + b with d > 0 and target t marks chunk ((b / 32), (t % B) / 16) of
// the first valid pair of row block r whose col is t / B, the pair whose
// block B10 adds it to; exact because the forwards' edge values are zero
// where d <= 0. One thread a slot, a linear scan over the row block's
// pairs (about 27 at 100,000 atoms) and a global atomicOr into words the
// wrapper zeroes; bound by reading nlist and d. From A itself
// (block_occupancy_from_adjacency_kernel, for a call with only the JAX
// signature): one block a pair reads its E * B * B values once (16 bytes a
// thread a step); bound by reading A.

#include "mp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// -- adjacency build ---------------------------------------------------------

template <int E, typename OutT>
__global__ void __launch_bounds__(kThreads)
    build_adj_kernel(const int* __restrict__ nlist,      // [nb * B, K], -1 on padded rows
                     const float* __restrict__ e,        // [nb * B, K, E]
                     const int* __restrict__ pair_rows,  // [P]
                     const int* __restrict__ pair_cols,  // [P]
                     const int* __restrict__ pair_valid, // [P]
                     OutT* __restrict__ A,               // [P, m_e, B, B] at the group
                     int nb, int B, int K, int es, int m_e) {
  const int p = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = pair_rows[p];
  const int c = pair_cols[p];
  // uniform over the block, so every lane below takes part in the shuffles
  const bool valid = pair_valid[p] != 0 && r >= 0 && r < nb && c >= 0 && c < nb;
  const size_t pair_base = (size_t)p * m_e * B * B;
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
            for (int n = 0; n < E; ++n) ev[n] = e[(row * K + k) * es + n];
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
                       const int* valid, OutT* A, int P, int nb, int B, int K, int es, int m_e,
                       cudaStream_t stream) {
  build_adj_kernel<E, OutT><<<P, kThreads, 0, stream>>>(nlist, e, rows, cols, valid, A, nb, B, K,
                                                        es, m_e);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_adj_any(int E, const int* nlist, const float* e, const int* rows,
                           const int* cols, const int* valid, OutT* A, int P, int nb, int B,
                           int K, int es, int m_e, cudaStream_t s) {
  if (P < 1 || nb < 1 || B < 4 || B % 4 != 0 || K < 1 || es < E || m_e < E)
    return cudaErrorInvalidValue;
  switch (E) {
    case 1: return launch_adj<1, OutT>(nlist, e, rows, cols, valid, A, P, nb, B, K, es, m_e, s);
    case 2: return launch_adj<2, OutT>(nlist, e, rows, cols, valid, A, P, nb, B, K, es, m_e, s);
    case 3: return launch_adj<3, OutT>(nlist, e, rows, cols, valid, A, P, nb, B, K, es, m_e, s);
    case 4: return launch_adj<4, OutT>(nlist, e, rows, cols, valid, A, P, nb, B, K, es, m_e, s);
    default: return cudaErrorInvalidValue;
  }
}

// -- the block occupancy -------------------------------------------------------

__global__ void __launch_bounds__(256)
    block_occupancy_kernel(const int* __restrict__ nlist,      // [n_rows, K]
                           const float* __restrict__ d,        // [n_rows, K]
                           const int* __restrict__ row_ptr,    // [nb + 1]
                           const int* __restrict__ pair_cols,  // [P]
                           const int* __restrict__ pair_valid, // [P]
                           unsigned* __restrict__ occ,         // [P, pair_words(B)], zeroed
                           int n_rows, int K, int nb, int B, int P) {
  const long long s = (long long)blockIdx.x * 256 + threadIdx.x;
  if (s >= (long long)n_rows * K) return;
  const int row = (int)(s / K);
  const int t = nlist[s];
  if (!(d[s] > 0.0f) || t < 0 || t >= nb * B || row >= nb * B) return;
  const int r = row / B;
  const int cb = t / B;
  const int p0 = min(max(row_ptr[r], 0), P);
  const int p1 = min(max(row_ptr[r + 1], p0), P);
  for (int p = p0; p < p1; ++p) {
    if (pair_cols[p] == cb && pair_valid[p] != 0) {
      const int bit = ((row - r * B) / kMpRows) * (B / kMpChunk) + (t - cb * B) / kMpChunk;
      atomicOr(occ + (size_t)p * pair_words(B) + (bit >> 5), 1u << (bit & 31));
      return;
    }
  }
}

// One block a pair; a value is nonzero when its bits other than the sign
// are (NaN included). Every word of the pair is written.
template <typename T>
__global__ void __launch_bounds__(256)
    block_occupancy_from_adjacency_kernel(const T* __restrict__ A,  // [P, E, B, B]
                                          unsigned* __restrict__ occ, int E, int B) {
  constexpr int PER = 16 / (int)sizeof(T);  // values of a 16-byte piece
  constexpr unsigned kMag = sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu;
  __shared__ unsigned s_w[32];
  const int p = blockIdx.x;
  const int wpp = pair_words(B);
  for (int j = threadIdx.x; j < wpp; j += 256) s_w[j] = 0u;
  __syncthreads();
  const uint4* a = reinterpret_cast<const uint4*>(A + (size_t)p * E * B * B);
  const int pieces = E * B * B / PER;
  for (int q = threadIdx.x; q < pieces; q += 256) {
    const uint4 u = __ldg(a + q);
    if ((u.x & kMag) | (u.y & kMag) | (u.z & kMag) | (u.w & kMag)) {
      const int rc = (q * PER) % (B * B);  // row * B + col of its first value
      const int bit = (rc / B / kMpRows) * (B / kMpChunk) + (rc % B) / kMpChunk;
      atomicOr(s_w + (bit >> 5), 1u << (bit & 31));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < wpp; j += 256) occ[(size_t)p * wpp + j] = s_w[j];
}

}  // namespace

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A [P, E, B, B] (float32, or bfloat16 with out_bf16) from the padded
// neighbor lists nlist [nb * B, K] (-1 on padded rows) and edge values
// e [nb * B, K, es] (float32). A channel group of E channels: e and A
// point at its first channel, es is e's channel count a slot, m_e A's.
int nmr_build_block_adjacency(const int* nlist, const float* e, const int* pair_rows,
                              const int* pair_cols, const int* pair_valid, void* A, int P, int nb,
                              int B, int K, int E, int out_bf16, int es, int m_e,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_adj_any<__nv_bfloat16>(E, nlist, e, pair_rows, pair_cols, pair_valid,
                                         static_cast<__nv_bfloat16*>(A), P, nb, B, K, es, m_e,
                                         s);
  return launch_adj_any<float>(E, nlist, e, pair_rows, pair_cols, pair_valid,
                               static_cast<float*>(A), P, nb, B, K, es, m_e, s);
}

// One block-sparse MP layer (activation(aggregate) + residual) over the nb
// row blocks (mp.cuh's kPairs); the pairs of row block r are
// [row_ptr[r], row_ptr[r + 1]) of the P pairs, occ their occupancy
// [P, pair_words(B)]. w: [E, F_in, F_out] in float32, [E, F_out, F_in] in
// bfloat16. A channel group: A and w point at its first channel, m_e is
// A's channel count, acc_in (or null) the earlier groups' float32 sum; inv
// null writes the float32 sum [nb * B, F] (with acc_in) and no epilogue;
// ldt is the node table's row stride in elements (mp.cuh's F-split).
int nmr_mp_blocksparse(const float* A, const unsigned* occ, const int* row_ptr,
                       const int* pair_cols, const float* nodes, const float* w,
                       const float* inv, void* out, int P, int nb, int E, int B, int F, int ldt,
                       int act, int m_e, const float* acc_in, void* stream) {
  return launch_mp_any<float, kPairs>(F, E, A, occ, nullptr, nullptr, nodes, w, inv, out, nb, B,
                                      B, nb * B, ldt, act, m_e, acc_in, ChebBuild{},
                                      static_cast<cudaStream_t>(stream),
                                      PairList{row_ptr, pair_cols, P});
}

int nmr_mp_blocksparse_bf16(const __nv_bfloat16* A, const unsigned* occ, const int* row_ptr,
                            const int* pair_cols, const __nv_bfloat16* nodes,
                            const __nv_bfloat16* w, const float* inv, void* out, int P, int nb,
                            int E, int B, int F, int ldt, int act, int m_e, const float* acc_in,
                            void* stream) {
  return launch_mp_any<__nv_bfloat16, kPairs>(F, E, A, occ, nullptr, nullptr, nodes, w, inv, out,
                                              nb, B, B, nb * B, ldt, act, m_e, acc_in,
                                              ChebBuild{},
                                              static_cast<cudaStream_t>(stream),
                                              PairList{row_ptr, pair_cols, P});
}

// The block occupancy [P, pair_words(B)] from the neighbor list and the
// distances ([n_rows, K], n_rows <= nb * B); occ must be zeroed.
int nmr_block_occupancy(const int* nlist, const float* d, const int* row_ptr,
                        const int* pair_cols, const int* pair_valid, unsigned* occ, int n_rows,
                        int K, int nb, int B, int P, void* stream) {
  if (n_rows < 0 || K < 1 || nb < 1 || B < kMpRows || B % kMpRows != 0 || B > 512 || P < 1 ||
      n_rows > nb * B)
    return cudaErrorInvalidValue;
  const long long slots = (long long)n_rows * K;
  if (slots == 0) return cudaSuccess;
  block_occupancy_kernel<<<(unsigned)((slots + 255) / 256), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      nlist, d, row_ptr, pair_cols, pair_valid, occ, n_rows, K, nb, B, P);
  return cudaGetLastError();
}

// The block occupancy of A [P, E, B, B] read from A itself.
int nmr_block_occupancy_from_adjacency(const void* A, unsigned* occ, int P, int E, int B,
                                       int a_bf16, void* stream) {
  if (P < 1 || E < 1 || B < kMpRows || B % kMpRows != 0 || B > 512)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bf16)
    block_occupancy_from_adjacency_kernel<__nv_bfloat16><<<P, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), occ, E, B);
  else
    block_occupancy_from_adjacency_kernel<float><<<P, 256, 0, s>>>(
        static_cast<const float*>(A), occ, E, B);
  return cudaGetLastError();
}

}  // extern "C"
