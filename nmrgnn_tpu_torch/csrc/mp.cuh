// The hand-written Hopper kernel of every MP layer of nmrgnn_tpu_torch,
// banded and block-sparse, and the band-occupancy passes that feed it.
// hbm.cu instantiates the kernel with the band read from device memory
// (over all row tiles, or over one window class's tiles through an ids
// array; with or without the epilogue) and holds the occupancy passes;
// fused_first.cu instantiates it with the band built in the block (B13);
// blocksparse.cu with the block-sparse adjacency's pairs (B11, B12), so
// the three sources build in parallel. ops/banded.py and
// ops/blocksparse.py hold the wrappers (one per TPU kernel, each with its
// launch count) and the plain PyTorch version of each.
//
// It replaces the TPU's seven MP kernels: _mp_banded_kernel (nmrgnn_tpu/
// ops/banded.py:555-579, B1), _mp_banded_hbm_kernel (:656-773, B5),
// _mp_banded_partial_kernel (:833-894, B6), _poly_mp_fused_kernel
// (:1451-1519, B13), _mp_banded_hbm_cls_kernel (:1703-1823, B9), and
// _mp_bs_kernel / _mp_bs_kernel_grouped (nmrgnn_tpu/ops/blocksparse.py:
// 299-443, B11 / B12). On Hopper no node table is resident on chip, so
// all seven are one kernel:
//   acc = sum_n round_T(M[i, n] @ table[lo_i : lo_i + W]) @ w[n]
//   kFull:    out[i*B + r] = T(act(acc * inv_degree) + table[tile*B + r])
//   kPartial: out[i*B + r] = acc (float32)
//   kBuild:   kFull with ids null, where M[i] is not read but built in the
//             block from the raw distances (the Chebyshev band build of
//             poly.cu) and written whole to m_out
//   kPairs:   kFull with ids null over the row blocks i of the block-sparse
//             adjacency A [P, E, B, B] (M with W = B): the window of pair p
//             is the node rows of its col block, cols[p] * B + [0, B), the
//             pairs of row block i are [row_ptr[i], row_ptr[i + 1]) in CSR
//             order, and h_n = sum_p A[p, n] @ window_p stays float32 into
//             the second product (_mp_bs_kernel's jnp.dot(h_acc[n],
//             w_ref[n], preferred_element_type=float32), :336)
// where grid tile i updates tile = ids[i] (ids null: tile = i). An id
// outside [0, n_table / B) reads nothing and writes zeros; window rows
// outside the table, and a pair's col outside [0, n_table / B), read as
// zeros; row_ptr offsets are clamped to [0, P].
//
// What bounds it. The band holds about 16 nonzeros in a row of W ~ 900
// (under 2%), so the dense first product (2*T*E*B*W*F flops, what the TPU's
// MXU does) is 50x the work the band needs. What is left is the second
// product, 2*E*N*F*F flops (1.0 GFLOP a layer at 2,482 atoms), and the
// bytes: the nonempty band chunks, the window rows they reference, W and
// the table's residual rows. In float32 the second product bounds it
// (67 TFLOP/s, no TF32: the exact tolerance is 2e-4); in bfloat16, on the
// tensor cores, the bytes do.
//
// The design.
// 1. The band's nonzeros, not its dense chunks. A 16-column window chunk
//    is nonempty for a block when it holds a nonzero of one of the block's
//    rows. The occupancy (one bit per row and chunk, [tiles * B, NW]
//    32-bit words, NW = ceil(W / 16 / 32)) is exact: every nonzero of M
//    lies in a marked chunk. The forwards make it once per band from nlist,
//    the distances and lo (band_occupancy_kernel: a slot with d > 0 inside
//    the window marks its chunk; every band build of the port gives a
//    d <= 0 slot the value 0) and share it by the 4 layers that read the
//    band; a direct call with only the JAX signature derives it from M in
//    one pass (band_occupancy_from_band_kernel). kBuild marks its rows'
//    chunks itself from the slots it stages. A block ORs its rows' words
//    into a list of its nonempty chunks and stages only those (window rows
//    and band chunk, cp.async into 4 stages in float32 or 6 in bfloat16,
//    all but one in flight while one is used). In a staged chunk each warp takes 4 rows: a ballot
//    over the [E, 4, 16] entries gives each row's nonzero columns, and the
//    warp walks them in ascending order, each lane accumulating F / 32
//    columns of h for the E channels in float32 registers (fmaf, the order
//    of the dense loop with its zero terms dropped: fmaf(0, v, h) == h for
//    a finite table, so the float32 h equals the dense loop's bit for bit).
// 2. Rows and columns per block. A block takes 32 rows of one tile (W_n is
//    read once for 32 rows, against 16 before). The output columns are
//    two slices of F / 2 at F >= 128 (one at F = 64). While the 32-row
//    blocks alone would not fill the SMs twice over, a block takes one
//    slice: it computes its rows' h_n in full (the first product is cheap
//    to repeat) and reads only its slice of W_n. Past that, a block takes
//    every slice of its rows, so phase 1 and W_n are read once per 32
//    rows. At 2,482 atoms (T = 20, B = 128, F = 256) the uniform layer
//    launches 20 * 4 * 2 = 160 blocks on the 132 SMs and the class
//    launches (B6: 5, 7 and 8 tiles) 40, 56 and 64; at 44,676 atoms B5
//    launches 1,400 blocks and B9's (77, 155 and 118 tiles) 308, 620 and
//    472. Up to E = 3 a thread keeps to 128 registers and a block to
//    115 KB of shared memory, so two blocks share an SM: one block's chunk
//    loads overlap the other's second product.
// 3. The second product. h_n, rounded to T (round_to<T>, the JAX
//    semantics), goes to shared memory. bfloat16: mma.sync.m16n8k16 on the
//    tensor cores with float32 accumulation; a warp owns F_out / 16 (or
//    / 8) output columns and all 32 rows, reads its B fragments of W_n
//    ([E, F_out, F_in], k contiguous) from L2 and its A fragments of h_n
//    from shared memory, 64 bits at a time (the k order inside a 16-wide
//    step is permuted alike for both operands, so the sum is unchanged).
//    float32: CUDA-core FMAs, each thread a 4 x 4 (or 2 x 4) register tile,
//    W_n ([E, F_in, F_out]) streamed through shared memory in 8-row chunks
//    of the block's slices, 4 stages, one barrier a chunk; every output
//    sums n, then k, in ascending order, as the dense-band kernel did.
// 4. The epilogue is float32, rounded once to T; the residual rows and
//    inv_degree are read from device memory.
// 5. Widths. The kernel is instantiated for F in {64, 128, 256} with
//    E <= 4 and F = 512 with E <= 2 (h [E, 32, F] and its registers hold
//    no more). ops/banded.py pads other F with zero columns and runs more
//    channels as groups: M (and kBuild's m_out) and w point at a group's
//    first channel, m_e is M's channel count, and acc_in, the float32 sum
//    of the groups before (a kPartial launch's output, or kPairs' with
//    inv null), is added to acc before the epilogue or the partial store.
//    Each group restages the window rows, so E = 8 reads them twice.
//    A table wider than 512 runs as column blocks of 256 (the F-split):
//    `table` points at an input block's first column and ldt is the full
//    table's row stride, w at the block (input, output) of the weights, and
//    an output block chains the launches of every input block and channel
//    group through acc_in, its own input block last, so that the epilogue
//    reads the residual from the columns it writes (table + src * ldt)
//    and runs once, on the full sum. The output blocks are separate
//    launches; ops/banded.py joins them.
//
// kPairs (B11, B12). The occupancy is one bit per (pair, 32-row slab,
// 16-column chunk): bit s * (B / 16) + c of pair p's ceil(B * B / 512)
// words (one word at B = 128) says whether A[p, :, 32 s : 32 s + 32,
// 16 c : 16 c + 16] holds a nonzero. ops/blocksparse.py's forwards make it
// once per structure and frame from nlist, the distances and the pairs
// (blocksparse.cu's block_occupancy_kernel); a direct call derives it from
// A. A block (row block i, slab s) has warp 0 list the set bits of its
// slab over the row block's pairs, in pair order and ascending chunk
// order, in segments of at most kPairCap entries (one segment unless a
// row block holds more than about 250 occupied pairs; the pipeline drains
// between segments), then stages and walks them as the band's chunks: the
// same ascending fmaf chain over (pair, column) as a dense loop over
// every pair and column, zero terms dropped. Padding pairs (A zero) are
// never listed, so a structure built with group = G gives B12 the
// entries, and the result bits, of B11. The second product: float32 as
// above; bfloat16 splits h into h_hi = bf16(h) and h_lo = bf16(h - h_hi)
// (|h - h_hi - h_lo| <= 2^-16 |h|) and runs both through the tensor cores
// with float32 sums, so h is not rounded to bfloat16 as the banded modes
// round it.
//
// kBuild (B13). The block stages its rows' K slots (window-relative index,
// the E Chebyshev values of common.cuh's cheb_edge, the function of
// poly.cu, so the values equal B4's bit for bit) and their chunk bits at
// its start, then builds each nonempty chunk's [E, 32, 16] band in float32
// in slot order into the stage where kFull loads M, rounded to the table's
// type (_poly_mp_fused_kernel's m_scratch[slot, n].astype(win.dtype),
// :1489-1491). Every entry of m_out is written once, zeros included:
// chunk c by the block of column slice c % S. The product code is shared
// with kFull, and the walk touches exactly the nonzero entries in the same
// order whatever chunks a mode stages, so B13 equals B4 + B1 bit for bit.

#pragma once

#include "common.cuh"

namespace {

constexpr int kMpThreads = 256;
constexpr int kMpWarps = kMpThreads / 32;
constexpr int kMpChunk = 16;                      // window columns of a chunk
constexpr int kMpRows = 32;                       // rows per block
constexpr int kMpWarpRows = kMpRows / kMpWarps;   // rows per warp in the first product
static_assert(kMpRows == 32, "the occupancy OR takes one row a lane");
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use

// What one launch computes (see above).
enum MpMode { kFull = 0, kPartial = 1, kBuild = 2, kPairs = 3 };

// kPairs' adjacency structure (unused by the other modes).
struct PairList {
  const int* row_ptr;  // [nb + 1] CSR offsets of each row block's pairs
  const int* cols;     // [P] col block of each pair
  int P;
};

// kPairs: list entries of one segment (pair << 5 | chunk).
constexpr int kPairCap = 2048;

// kPairs: occupancy words of a pair, at B rows and columns.
__host__ __device__ constexpr int pair_words(int B) {
  return ((B / kMpRows) * (B / kMpChunk) + 31) / 32;
}

// The in-block band build of kBuild (unused by the other modes).
struct ChebBuild {
  const int* nlist;  // [T*B, K], -1 on padded rows
  const float* d;    // [T*B, K] raw distances, 0 on padded rows
  const float* c;    // [degree + 1, E] Chebyshev coefficients
  void* m_out;       // [T, E, B, W], float32 or bfloat16 (m_bf16)
  int K, degree, m_bf16;
  float d_lo, d_hi, span;
};

// float32's second product: W_n rows of a column slice per stage, and
// stages (all but one in flight).
constexpr int kWRows = 8;
constexpr int kWStages = 4;

// Chunks staged at once (all but one in flight): 4 of 22 KB in float32,
// 6 of 11 KB in bfloat16 at F = 256, within two blocks an SM.
template <typename T>
__host__ __device__ constexpr int mp_stages() {
  return sizeof(T) == 2 ? 6 : 4;
}

// Output columns of a column slice, and slices per 32 rows.
template <int F>
__host__ __device__ constexpr int mp_slice() {
  return F >= 128 ? F / 2 : F;
}
template <int F>
__host__ __device__ constexpr int mp_slices() {
  return F / mp_slice<F>();
}

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int occ_words(int W) { return (W / kMpChunk + 31) / 32; }

// Row stride of h_n in shared memory, in elements: bfloat16 rows move 32
// bytes a row, so the mma A-fragment loads (4 rows x 32 bytes per half
// warp) hit distinct banks; float32 rows are read as broadcasts and keep
// F, so that two blocks fit an SM.
template <int F, typename T>
__host__ __device__ constexpr int mp_h_stride() {
  return F + (sizeof(T) == 4 ? 0 : 16);
}

// Shared memory. Phase 1 (the first product): mp_stages<T>() stages of [16, F]
// window rows and the [E, 32, 16] band chunk, the chunk list (nw ints, or
// kPairs' kPairCap), the block's OR'd occupancy words, and kBuild's slots.
// Phase 2 (the second product) reuses it: h [parts, E, 32, stride] in T
// (kPairs' bfloat16 h_hi and h_lo: two parts) and, in float32, kWStages
// stages of [kWRows, slice] W_n rows.
template <int F, int E, typename T>
__host__ __device__ constexpr size_t mp_stage_bytes() {
  return (size_t)kMpChunk * F * sizeof(T) + (size_t)E * kMpRows * kMpChunk * sizeof(T);
}
template <typename T, int kMode>
__host__ __device__ constexpr int mp_h_parts() {
  return kMode == kPairs && sizeof(T) == 2 ? 2 : 1;
}
template <int F, int E, typename T, int kMode>
__host__ __device__ constexpr size_t mp_phase2_bytes() {
  return (size_t)mp_h_parts<T, kMode>() * E * kMpRows * mp_h_stride<F, T>() * sizeof(T) +
         (sizeof(T) == 4 ? (size_t)kWStages * kWRows * mp_slice<F>() * sizeof(float) : 0);
}
template <int kMode>
__host__ __device__ constexpr size_t list_bytes(int W) {
  return kMode == kPairs ? round16((size_t)kPairCap * sizeof(int))
                         : round16((size_t)(W / kMpChunk) * sizeof(int)) +
                               round16((size_t)occ_words(W) * sizeof(unsigned));
}

// kBuild's shared memory after the stages and the list: the coefficients,
// the 32 x K slots' window-relative indices, each row's chunk bits, then
// the slots' E values.
__host__ __device__ constexpr size_t build_coeff_bytes(int E, int degree) {
  return round16((size_t)(degree + 1) * E * sizeof(float));
}
__host__ __device__ constexpr size_t build_rel_bytes(int K) {
  return round16((size_t)kMpRows * K * sizeof(int));
}
__host__ __device__ constexpr size_t build_mask_bytes(int W) {
  return round16((size_t)kMpRows * occ_words(W) * sizeof(unsigned));
}
__host__ __device__ constexpr size_t build_smem_bytes(int E, int K, int degree, int W) {
  return build_coeff_bytes(E, degree) + build_rel_bytes(K) + build_mask_bytes(W) +
         (size_t)kMpRows * K * E * sizeof(float);
}

template <int F, int E, typename T, int kMode>
__host__ __device__ constexpr size_t mp_smem_bytes(int W, int K, int degree) {
  const size_t p1 = mp_stages<T>() * mp_stage_bytes<F, E, T>() + list_bytes<kMode>(W) +
                    (kMode == kBuild ? build_smem_bytes(E, K, degree, W) : 0);
  const size_t p2 = mp_phase2_bytes<F, E, T, kMode>();
  return p1 > p2 ? p1 : p2;
}

// VEC consecutive elements (4, 8 or 16 bytes) to float32, and back.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[q]));
      v[2 * q] = f.x, v[2 * q + 1] = f.y;
    }
  } else if constexpr (VEC == 4) {
    const float4 a = load4(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x, v[1] = f.y;
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
#pragma unroll
  for (int q = 0; q < VEC; q += 2)
    *reinterpret_cast<__nv_bfloat162*>(p + q) = __floats2bfloat162_rn(v[q], v[q + 1]);
}

// Two blocks an SM for E <= 3 (at most 128 registers a thread), so that
// one block's chunk loads overlap the other's second product.
template <int F, int E, typename T, int kMode>
__global__ void __launch_bounds__(kMpThreads, E <= 3 && F <= 256 ? 2 : 1)
    mp_banded_kernel(const T* __restrict__ M,           // [tiles, E, B, W] (not kBuild);
                                                        // kPairs: A [P, E, B, B]
                     const unsigned* __restrict__ occ,  // [tiles * B, NW] (not kBuild);
                                                        // kPairs: [P, pair_words(B)]
                     const int* __restrict__ lo,        // [tiles] window starts (not kPairs)
                     const int* __restrict__ ids,       // [tiles] tile ids, or null
                     const T* __restrict__ table,       // [n_table, F] node table
                     const T* __restrict__ w,           // [E, F, F] (see the note)
                     const float* __restrict__ inv,     // [n_table] (not kPartial)
                     void* __restrict__ out_,           // [tiles * B, F]: T, or float if partial
                     int B, int W, int n_table,
                     int ldt,                           // table row stride, in elements
                     int act, int spb,
                     int m_e,                           // channels of M (or m_out) a tile
                     const float* acc_in,               // [tiles * B, F] float32, or null
                     ChebBuild bld, PairList prs) {
  constexpr bool kPart = kMode == kPartial;
  // kPairs without inv_degree is partial too (a channel group's sum)
  const bool part = kPart || (kMode == kPairs && inv == nullptr);
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int RB = kMpRows;
  constexpr int FS = mp_slice<F>();
  constexpr int S = mp_slices<F>();
  constexpr int NST = mp_stages<T>();
  constexpr int CPL = F / 32;                                    // h columns per lane
  constexpr int VEC = (16 / (int)sizeof(T)) < CPL ? 16 / (int)sizeof(T) : CPL;
  constexpr int NP = CPL / VEC;                                  // pieces per lane
  constexpr int HS = mp_h_stride<F, T>();
  constexpr int SEG_ROW = F * (int)sizeof(T) / 16;               // 16-byte pieces of a table row
  constexpr int SEG_M = kMpChunk * (int)sizeof(T) / 16;          // of a band row's chunk
  constexpr size_t TAB = (size_t)kMpChunk * F * sizeof(T);
  constexpr size_t STAGE = mp_stage_bytes<F, E, T>();
  constexpr int NH = mp_h_parts<T, kMode>();                   // parts of h in phase 2
  extern __shared__ float4 smem4[];
  __shared__ int s_nc;
  __shared__ int s_pnext;  // kPairs: the first pair of the next segment
  char* smem = reinterpret_cast<char*>(smem4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per_tile = B / RB;
  const int nbs = S / spb;                  // blocks per 32 rows
  const int cs0 = (blockIdx.x % nbs) * spb;  // its column slices [cs0, cs0 + spb)
  const int rest = blockIdx.x / nbs;
  const int i = rest / per_tile;  // grid tile
  const int r0 = (rest - i * per_tile) * RB;
  const int tile = ids != nullptr ? ids[i] : i;  // the tile whose rows it updates
  const size_t out_row0 = (size_t)i * B + r0;
  if (!kPart && (tile < 0 || tile >= n_table / B)) {  // a bad id reads nothing
    T* out_rows = static_cast<T*>(out_) + out_row0 * F + cs0 * FS;
    const int cw = spb * FS / 4;  // 4-column groups of the block's slices
    for (int s = tid; s < RB * cw; s += kMpThreads) {
      const int r = s / cw;
      store4(out_rows + (size_t)r * F + (s - r * cw) * 4, make_float4(0.f, 0.f, 0.f, 0.f));
    }
    return;
  }
  const int base = kMode == kPairs ? 0 : lo[i];
  const int nw = W / kMpChunk;  // window chunks
  const int NW = occ_words(W);

  // -- shared memory -----------------------------------------------------------
  char* list_smem = smem + NST * STAGE;
  int* s_list = reinterpret_cast<int*>(list_smem);  // [nw] nonempty chunks (kPairs: entries)
  unsigned* s_or =
      reinterpret_cast<unsigned*>(list_smem + round16((size_t)nw * sizeof(int)));  // [NW]
  char* bld_smem = list_smem + list_bytes<kMode>(W);
  float* s_c = reinterpret_cast<float*>(bld_smem);
  bld_smem += build_coeff_bytes(E, bld.degree);
  int* s_rel = reinterpret_cast<int*>(bld_smem);  // [RB][K]
  bld_smem += build_rel_bytes(bld.K);
  unsigned* s_bits = reinterpret_cast<unsigned*>(bld_smem);  // [RB][NW]
  float* s_e = reinterpret_cast<float*>(bld_smem + build_mask_bytes(W));  // [RB][K][E]
  T* s_h = reinterpret_cast<T*>(smem);  // phase 2: [NH][E][RB][HS]

  // -- the block's nonempty chunks -------------------------------------------------
  if constexpr (kMode == kBuild) {
    for (int j = tid; j < (bld.degree + 1) * E; j += kMpThreads) s_c[j] = bld.c[j];
    for (int j = tid; j < RB * NW; j += kMpThreads) s_bits[j] = 0u;
    __syncthreads();
    const size_t slot0 = ((size_t)i * B + r0) * bld.K;  // rows r0.. of tile i
    for (int s = tid; s < RB * bld.K; s += kMpThreads) {
      const float dv = bld.d[slot0 + s];
      const int rel = bld.nlist[slot0 + s] - base;
      s_rel[s] = rel;
      if (dv > 0.0f && rel >= 0 && rel < W) {
        const int c = rel / kMpChunk;
        atomicOr(s_bits + (s / bld.K) * NW + (c >> 5), 1u << (c & 31));
      }
      cheb_edge<E>(dv, s_c, bld.degree, bld.d_lo, bld.d_hi, bld.span, s_e + (size_t)s * E);
    }
    __syncthreads();
  }
  if constexpr (kMode != kPairs) {
    // the OR of the block's rows' words: warp j % 8 takes word j, lane = row
    for (int j = warp; j < NW; j += kMpWarps) {
      const unsigned v =
          kMode == kBuild ? s_bits[lane * NW + j] : occ[(out_row0 + lane) * NW + j];
      const unsigned o = __reduce_or_sync(0xffffffffu, v);
      if (lane == 0) s_or[j] = o;
    }
    __syncthreads();
    if (warp == 0) {
      int count = 0;
      for (int j = 0; j < NW; ++j) {
        const int c = j * 32 + lane;
        const bool set = c < nw && ((s_or[j] >> lane) & 1u);
        const unsigned bal = __ballot_sync(0xffffffffu, set);
        if (set) s_list[count + __popc(bal & ((1u << lane) - 1u))] = c;
        count += __popc(bal);
      }
      if (lane == 0) s_nc = count;
    }
    __syncthreads();
  }

  // kPairs: the row block's pairs (offsets clamped to [0, P]); list_pairs
  // has warp 0 list the next segment's entries, pair << 5 | chunk, from
  // pair p_next on: the set bits of the block's slab, pairs in order (32
  // at a time, a prefix sum over the lanes), chunks ascending, until the
  // next 32 pairs' entries would pass kPairCap.
  const int p_lo = kMode == kPairs ? min(max(prs.row_ptr[i], 0), prs.P) : 0;
  const int p_hi = kMode == kPairs ? min(max(prs.row_ptr[i + 1], p_lo), prs.P) : 0;
  int p_next = p_lo;
  auto list_pairs = [&]() {
    if (warp == 0) {
      const int nch = B / kMpChunk;
      const int wpp = pair_words(B);
      const int b0 = (r0 / RB) * nch;  // the slab's first bit
      const unsigned keep = nch >= 32 ? 0xffffffffu : (1u << nch) - 1u;
      int count = 0;
      int p = p_next;
      for (; p < p_hi; p += 32) {
        const int q = p + lane;
        unsigned bits = 0u;
        if (q < p_hi) {
          const unsigned* o = occ + (size_t)q * wpp + (b0 >> 5);
          const int sh = b0 & 31;
          bits = o[0] >> sh;
          if (sh + nch > 32) bits |= o[1] << (32 - sh);
          bits &= keep;
        }
        const int cnt = __popc(bits);
        int incl = cnt;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += t;
        }
        const int total = __shfl_sync(0xffffffffu, incl, 31);
        if (count + total > kPairCap) break;  // uniform: the next segment's
        int pos = count + incl - cnt;
        while (bits) {
          const int c = __ffs(bits) - 1;
          bits &= bits - 1u;
          s_list[pos++] = (q << 5) | c;
        }
        count += total;
      }
      if (lane == 0) {
        s_nc = count;
        s_pnext = min(p, p_hi);
      }
    }
    __syncthreads();
    p_next = s_pnext;
  };

  // kBuild: every entry of m_out is written once, chunk c by the block of
  // slice c % S; here the empty chunks' zeros.
  auto writes = [&](int c) { return (unsigned)(c % S - cs0) < (unsigned)spb; };
  if constexpr (kMode == kBuild) {
    const int ob = bld.m_bf16 ? 2 : 4;
    const int seg = kMpChunk * ob / 16;  // 16-byte pieces of a row's chunk
    for (int c = 0; c < nw; ++c) {
      if (!writes(c) || ((s_or[c >> 5] >> (c & 31)) & 1u)) continue;
      for (int s = tid; s < E * RB * seg; s += kMpThreads) {
        const int nr = s / seg;
        const int n = nr / RB;
        const int r = nr - n * RB;
        const size_t o = ((size_t)(i * m_e + n) * B + r0 + r) * W + (size_t)c * kMpChunk;
        reinterpret_cast<float4*>(static_cast<char*>(bld.m_out) + o * ob)[s - nr * seg] =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  // Stage of list entry idx: window rows [base + c*16, +16) and (not
  // kBuild) the band's columns [c*16, +16) of the block's rows; kPairs:
  // pair p's col block's rows [cols[p]*B + c*16, +16) and A[p]'s columns.
  auto load_chunk = [&](int idx) {
    char* st = smem + (idx % NST) * STAGE;
    int w0, src0;
    size_t mt;  // M's tile: the grid tile, or kPairs' pair
    bool col_ok = true;
    if constexpr (kMode == kPairs) {
      const int e = s_list[idx];
      const int col = prs.cols[e >> 5];
      col_ok = col >= 0 && col < n_table / B;
      w0 = (e & 31) * kMpChunk;
      src0 = (col_ok ? col : 0) * B + w0;
      mt = (size_t)(e >> 5);
    } else {
      w0 = s_list[idx] * kMpChunk;
      src0 = base + w0;
      mt = (size_t)i;
    }
    for (int s = tid; s < kMpChunk * SEG_ROW; s += kMpThreads) {
      const int r = s / SEG_ROW;
      const int q = s - r * SEG_ROW;
      const int src = src0 + r;
      const bool ok = col_ok && src >= 0 && src < n_table;
      const char* g = reinterpret_cast<const char*>(table + (size_t)(ok ? src : 0) * ldt);
      cp_async16(st + (size_t)s * 16, g + q * 16, ok);
    }
    if constexpr (kMode != kBuild) {
      char* sm = st + TAB;
      for (int s = tid; s < E * RB * SEG_M; s += kMpThreads) {
        const int nr = s / SEG_M;  // n * RB + r
        const int q = s - nr * SEG_M;
        const int n = nr / RB;
        const int r = nr - n * RB;
        const T* g = M + ((mt * m_e + n) * B + r0 + r) * W + w0;
        cp_async16(sm + (size_t)s * 16, reinterpret_cast<const char*>(g) + q * 16, true);
      }
    }
  };

  // kBuild: list entry idx's band, built in float32 in slot order into its
  // stage (rounded to T) and, by the block of slice c % S, into m_out.
  auto build_chunk = [&](int idx) {
    T* sm = reinterpret_cast<T*>(smem + (idx % NST) * STAGE + TAB);  // [E][RB][16]
    const int c = s_list[idx];
    const int w0 = c * kMpChunk;
    const bool writer = writes(c);
    for (int s = tid; s < RB * kMpChunk; s += kMpThreads) {
      const int r = s / kMpChunk;
      const int j = s - r * kMpChunk;
      const int* rel = s_rel + r * bld.K;
      const float* ev = s_e + (size_t)r * bld.K * E;
      float acc[E];
#pragma unroll
      for (int n = 0; n < E; ++n) acc[n] = 0.0f;
      if (s_bits[r * NW + (c >> 5)] & (1u << (c & 31))) {
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
        if (writer) {
          const size_t o = ((size_t)(i * m_e + n) * B + r0 + r) * W + w0 + j;
          if (bld.m_bf16)
            static_cast<__nv_bfloat16*>(bld.m_out)[o] = __float2bfloat16_rn(acc[n]);
          else
            static_cast<float*>(bld.m_out)[o] = acc[n];
        }
      }
    }
  };

  // -- phase 1: h_n = M[i, n] @ window over the nonempty chunks ---------------------
  float hacc[E][kMpWarpRows][CPL];
#pragma unroll
  for (int n = 0; n < E; ++n)
#pragma unroll
    for (int a = 0; a < kMpWarpRows; ++a)
#pragma unroll
      for (int q = 0; q < CPL; ++q) hacc[n][a][q] = 0.0f;
  const int wr0 = warp * kMpWarpRows;  // the warp's first row

  // One segment of list entries (kPairs: until the row block's pairs are
  // listed; the other modes list every chunk at once).
  for (;;) {
    if constexpr (kMode == kPairs) list_pairs();
    const int nc = s_nc;
    // NST - 1 chunks in flight; list entry idx lands in group idx
    for (int p = 0; p < NST - 1; ++p) {
      if (p < nc) {
        load_chunk(p);
        if constexpr (kMode == kBuild) build_chunk(p);  // published by iteration p's barrier
      }
      cp_async_commit();  // possibly empty: the waits count groups
    }
    for (int idx = 0; idx < nc; ++idx) {
      cp_async_wait<NST - 2>();  // entry idx has landed
      __syncthreads();  // ... for every thread, and every thread is done with entry idx - 1
      if (idx + NST - 1 < nc) {  // into entry idx - 1's stage
        load_chunk(idx + NST - 1);
        if constexpr (kMode == kBuild) build_chunk(idx + NST - 1);
      }
      cp_async_commit();
      const T* sw = reinterpret_cast<const T*>(smem + (idx % NST) * STAGE);
      const T* sm = reinterpret_cast<const T*>(smem + (idx % NST) * STAGE + TAB);
      // each of the warp's rows' nonzero columns: lanes 0-15 row a, 16-31 row
      // a + 1, one bit per column
      unsigned bal[kMpWarpRows / 2];
#pragma unroll
      for (int p = 0; p < kMpWarpRows / 2; ++p) {
        const int r = wr0 + 2 * p + (lane >> 4);
        bool nz = false;
#pragma unroll
        for (int n = 0; n < E; ++n) nz |= to_f32(sm[(n * RB + r) * kMpChunk + (lane & 15)]) != 0.0f;
        bal[p] = __ballot_sync(0xffffffffu, nz);
      }
#pragma unroll
      for (int a = 0; a < kMpWarpRows; ++a) {
        unsigned mk = (bal[a >> 1] >> ((a & 1) * 16)) & 0xffffu;
        const T* mrow = sm + (wr0 + a) * kMpChunk;
        while (mk) {
          const int j = __ffs(mk) - 1;
          mk &= mk - 1u;
          float v[CPL];
#pragma unroll
          for (int p = 0; p < NP; ++p)
            load_vec<VEC>(sw + j * F + p * 32 * VEC + lane * VEC, v + p * VEC);
#pragma unroll
          for (int n = 0; n < E; ++n) {
            const float m = to_f32(mrow[n * RB * kMpChunk + j]);
#pragma unroll
            for (int q = 0; q < CPL; ++q) hacc[n][a][q] = fmaf(m, v[q], hacc[n][a][q]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // phase 2, or the next segment, reuses the stages
    if (kMode != kPairs || p_next >= p_hi) break;
  }

  // h_n rounded to T, into shared memory; kPairs in bfloat16: h_hi = bf16(h)
  // in part 0 and h_lo = bf16(h - h_hi) in part 1 (h - h_hi is exact)
#pragma unroll
  for (int n = 0; n < E; ++n)
#pragma unroll
    for (int a = 0; a < kMpWarpRows; ++a)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        T* dst = s_h + (size_t)(n * RB + wr0 + a) * HS + p * 32 * VEC + lane * VEC;
        if constexpr (NH == 2) {
          float hi[VEC], rest[VEC];
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            hi[q] = round_to<T>(hacc[n][a][p * VEC + q]);
            rest[q] = hacc[n][a][p * VEC + q] - hi[q];
          }
          store_vec<VEC>(dst, hi);
          store_vec<VEC>(dst + (size_t)E * RB * HS, rest);
        } else {
          store_vec<VEC>(dst, &hacc[n][a][p * VEC]);
        }
      }
  __syncthreads();

  // -- phase 2: acc = sum_n h_n @ W_n[:, slice], for each of the block's slices ------
  if constexpr (kBf16) {
    // tensor cores: warp `warp` owns columns [c0 + warp*WC, +WC) and all rows
    constexpr int WC = FS / kMpWarps;
    constexpr int NT = WC / 8;
    const int g = lane >> 2;
    const int t4 = (lane & 3) * 4;
    const int t2 = (lane & 3) * 2;
    const __nv_bfloat16* hs = reinterpret_cast<const __nv_bfloat16*>(s_h);
    const __nv_bfloat16* wt = reinterpret_cast<const __nv_bfloat16*>(w);  // [E][F_out][F_in]
    for (int cs = cs0; cs < cs0 + spb; ++cs) {
      const int wc0 = cs * FS + warp * WC;
      float d[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[mt][nt][q] = 0.0f;
#pragma unroll
      for (int n = 0; n < E; ++n) {
        const __nv_bfloat16* hn = hs + (size_t)n * RB * HS + t4;
#pragma unroll  // all of a channel's B fragments in flight at once
        for (int k0 = 0; k0 < F; k0 += 16) {
          // physical k0 + t4 .. + 3 is logical (2t, 2t+1, 2t+8, 2t+9) in both operands
          unsigned a[NH][2][4];
#pragma unroll
          for (int hp = 0; hp < NH; ++hp)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const __nv_bfloat16* hr = hn + (size_t)hp * E * RB * HS;
              const uint2 x = *reinterpret_cast<const uint2*>(hr + (mt * 16 + g) * HS + k0);
              const uint2 y = *reinterpret_cast<const uint2*>(hr + (mt * 16 + g + 8) * HS + k0);
              a[hp][mt][0] = x.x, a[hp][mt][1] = y.x, a[hp][mt][2] = x.y, a[hp][mt][3] = y.y;
            }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 b = __ldg(reinterpret_cast<const uint2*>(
                wt + ((size_t)n * F + wc0 + nt * 8 + g) * F + k0 + t4));
#pragma unroll
            for (int hp = 0; hp < NH; ++hp)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) mma_bf16(d[mt][nt], a[hp][mt], b.x, b.y);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + half * 8;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = wc0 + nt * 8 + t2;
            float x0 = d[mt][nt][2 * half], x1 = d[mt][nt][2 * half + 1];
            const size_t o = (out_row0 + r) * F + col;
            if (acc_in != nullptr) {  // the earlier channel groups' sum
              const float2 a = *reinterpret_cast<const float2*>(acc_in + o);
              x0 += a.x, x1 += a.y;
            }
            if (part) {
              *reinterpret_cast<float2*>(static_cast<float*>(out_) + o) = make_float2(x0, x1);
            } else {
              const size_t src = (size_t)tile * B + r0 + r;
              const float sc = inv[src];
              const float2 res = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(table + src * ldt + col));
              *reinterpret_cast<__nv_bfloat162*>(static_cast<T*>(out_) + o) =
                  __floats2bfloat162_rn(activate(x0 * sc, act) + res.x,
                                        activate(x1 * sc, act) + res.y);
            }
          }
        }
    }
  } else {
    // CUDA cores: thread (rg, cg) owns rows [rg*TR, +TR) and columns
    // [c0 + cg*4, +4) of each slice. W_n streams through kWStages stages of
    // kWRows rows of the slice, one sequence over (slice, channel, rows),
    // all but one stage in flight.
    constexpr int KW = kWRows;
    constexpr int NSW = kWStages;
    constexpr int CG = FS / 4;
    constexpr int TR = RB / (kMpThreads / CG);
    constexpr int NL = F / KW;  // W_n chunks per channel
    constexpr int SEG_W = FS * (int)sizeof(float) / 16;
    constexpr size_t WSTAGE = (size_t)KW * FS * sizeof(float);
    const int cg = tid % CG;
    const int rg = tid / CG;
    const float* hs = reinterpret_cast<const float*>(s_h);
    char* wst = smem + (size_t)E * RB * HS * sizeof(float);
    const int total = spb * E * NL;
    auto load_w = [&](int ci) {
      const int sl = ci / (E * NL);
      const int rem = ci - sl * (E * NL);
      const int n = rem / NL;
      const int l0 = (rem - n * NL) * KW;
      char* st = wst + (ci % NSW) * WSTAGE;
      const float* g =
          reinterpret_cast<const float*>(w) + ((size_t)n * F + l0) * F + (cs0 + sl) * FS;
      for (int s = tid; s < KW * SEG_W; s += kMpThreads) {
        const int r = s / SEG_W;
        cp_async16(st + (size_t)s * 16,
                   reinterpret_cast<const char*>(g + (size_t)r * F) + (s - r * SEG_W) * 16, true);
      }
    };
    float acc[TR][4];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = 0.0f;
    for (int p = 0; p < NSW - 1; ++p) {
      if (p < total) load_w(p);
      cp_async_commit();
    }
    for (int ci = 0; ci < total; ++ci) {
      cp_async_wait<NSW - 2>();  // chunk ci has landed
      __syncthreads();           // ... for every thread; chunk ci - 1's stage is free
      if (ci + NSW - 1 < total) load_w(ci + NSW - 1);
      cp_async_commit();
      const int sl = ci / (E * NL);
      const int rem = ci - sl * (E * NL);
      const int n = rem / NL;
      const int l0 = (rem - n * NL) * KW;
      const float* sw = reinterpret_cast<const float*>(wst + (ci % NSW) * WSTAGE);
#pragma unroll
      for (int k4 = 0; k4 < KW; k4 += 4) {
        float4 hv[TR];
#pragma unroll
        for (int a = 0; a < TR; ++a)
          hv[a] = *reinterpret_cast<const float4*>(hs + (size_t)(n * RB + rg * TR + a) * HS + l0 +
                                                   k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = *reinterpret_cast<const float4*>(sw + (k4 + kk) * FS + cg * 4);
#pragma unroll
          for (int a = 0; a < TR; ++a) {
            const float x = kk == 0 ? hv[a].x : kk == 1 ? hv[a].y : kk == 2 ? hv[a].z : hv[a].w;
            acc[a][0] = fmaf(x, v.x, acc[a][0]);
            acc[a][1] = fmaf(x, v.y, acc[a][1]);
            acc[a][2] = fmaf(x, v.z, acc[a][2]);
            acc[a][3] = fmaf(x, v.w, acc[a][3]);
          }
        }
      }
      if (rem != E * NL - 1) continue;
      // the slice's last chunk: its epilogue
      const int col = (cs0 + sl) * FS + cg * 4;
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const int r = rg * TR + a;
        const size_t o = (out_row0 + r) * F + col;
        if (acc_in != nullptr) {  // the earlier channel groups' sum
          const float4 a4 = load4(acc_in + o);
          acc[a][0] += a4.x, acc[a][1] += a4.y, acc[a][2] += a4.z, acc[a][3] += a4.w;
        }
        if (part) {
          store4(static_cast<float*>(out_) + o,
                 make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
        } else {
          const size_t src = (size_t)tile * B + r0 + r;
          const float sc = inv[src];
          const float4 res = load4(table + src * ldt + col);
          store4(static_cast<T*>(out_) + o,
                 make_float4(activate(acc[a][0] * sc, act) + res.x,
                             activate(acc[a][1] * sc, act) + res.y,
                             activate(acc[a][2] * sc, act) + res.z,
                             activate(acc[a][3] * sc, act) + res.w));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] = 0.0f;
      }
    }
  }
}

// The card's SM count (device of the calling thread), read once.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      n = v;
  }
  return n > 0 ? n : 132;
}

template <int F, int E, typename T, int kMode>
cudaError_t launch_mp(const T* M, const unsigned* occ, const int* lo, const int* ids,
                      const T* table, const T* w, const float* inv, void* out, int tiles, int B,
                      int W, int n_table, int ldt, int act, int m_e, const float* acc_in,
                      const ChebBuild& bld, const PairList& prs, cudaStream_t stream) {
  const size_t smem = mp_smem_bytes<F, E, T, kMode>(W, bld.K, bld.degree);
  if (B % kMpRows != 0 || smem > kMaxSmem || (kMode != kBuild && occ == nullptr) || m_e < E)
    return cudaErrorInvalidValue;
  if (kMode == kPairs && (prs.row_ptr == nullptr || prs.cols == nullptr || ids != nullptr ||
                          W != B || B / kMpChunk > 32 || prs.P < 0 || prs.P >= (1 << 26)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mp_banded_kernel<F, E, T, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // all of the SM's shared memory, for two blocks
    err = cudaFuncSetAttribute(mp_banded_kernel<F, E, T, kMode>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // One block takes all of its rows' column slices once the row blocks
  // alone fill the card twice over (phase 1 and W_n read once per 32
  // rows); else one slice each, so that a small structure still fills it.
  const int row_blocks = tiles * (B / kMpRows);
  const int spb = row_blocks >= 2 * sm_count() ? mp_slices<F>() : 1;
  const int blocks = row_blocks * (mp_slices<F>() / spb);
  mp_banded_kernel<F, E, T, kMode><<<blocks, kMpThreads, smem, stream>>>(
      M, occ, lo, ids, table, w, inv, out, B, W, n_table, ldt, act, spb, m_e, acc_in, bld, prs);
  return cudaGetLastError();
}

// Dispatch on the runtime (F, E) to the instantiated kernels: F in {64,
// 128, 256} with E <= 4, and F = 512 with E <= 2 (its h registers and
// shared memory hold two channels). ops/banded.py pads other widths up to
// these and runs more channels as groups: M and w point at a group's first
// channel, m_e is M's channel count, and acc_in (float32 [tiles * B, F],
// or null) is the earlier groups' sum, added before the epilogue. The full
// layer reads whole B-row tiles of the table; the partial one any rows.
template <typename T, int kMode>
cudaError_t launch_mp_any(int F, int E, const T* M, const unsigned* occ, const int* lo,
                          const int* ids, const T* table, const T* w, const float* inv,
                          void* out, int tiles, int B, int W, int n_table, int ldt, int act,
                          int m_e, const float* acc_in, const ChebBuild& bld, cudaStream_t s,
                          const PairList& prs = PairList{}) {
  if (tiles < 1 || B < 1 || W < 1 || W % kMpChunk != 0 || n_table < 1 || ldt < F ||
      ldt * (int)sizeof(T) % 16 != 0 || (kMode != kPartial && (n_table < B || n_table % B != 0)))
    return cudaErrorInvalidValue;
#define NMR_MP_CASE(FF, EE)                                                                  \
  if (F == FF && E == EE)                                                                    \
    return launch_mp<FF, EE, T, kMode>(M, occ, lo, ids, table, w, inv, out, tiles, B, W,     \
                                       n_table, ldt, act, m_e, acc_in, bld, prs, s);
#define NMR_MP_F(FF) NMR_MP_CASE(FF, 1) NMR_MP_CASE(FF, 2) NMR_MP_CASE(FF, 3) NMR_MP_CASE(FF, 4)
  NMR_MP_F(64)
  NMR_MP_F(128)
  NMR_MP_F(256)
  NMR_MP_CASE(512, 1)
  NMR_MP_CASE(512, 2)
#undef NMR_MP_F
#undef NMR_MP_CASE
  return cudaErrorInvalidValue;
}

// -- the band occupancy ------------------------------------------------------
// occ[g * NW + j] bit b: window chunk 32 j + b of grid row g holds a nonzero.

// From the neighbor list: grid row g = i * B + r reads row ids[i] * B + r
// (ids null: i * B + r) of nlist / d ([n_rows, K]; rows at or past n_rows
// and a tile id outside [0, n_tiles) mark nothing); slot k marks chunk
// (nlist - lo[i]) / 16 when d > 0 and the index lies in [lo[i], lo[i] + W).
// One warp a row, the lanes over the slots, a warp OR per word: no atomics,
// every word written.
__global__ void __launch_bounds__(256)
    band_occupancy_kernel(const int* __restrict__ nlist, const float* __restrict__ d,
                          const int* __restrict__ lo, const int* __restrict__ ids,
                          unsigned* __restrict__ occ, int rows, int n_rows, int n_tiles, int B,
                          int K, int W) {
  const int g = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= rows) return;
  const int i = g / B;
  const int r = g - i * B;
  const int tile = ids != nullptr ? ids[i] : i;
  const long long src = (long long)tile * B + r;
  const bool valid = tile >= 0 && tile < n_tiles && src < n_rows;
  const int base = lo[i];
  const int NW = occ_words(W);
  for (int j = 0; j < NW; ++j) {
    unsigned bits = 0u;
    if (valid) {
      for (int k = lane; k < K; k += 32) {
        const int rel = nlist[src * K + k] - base;
        if (d[src * K + k] > 0.0f && rel >= 0 && rel < W) {
          const int c = rel / kMpChunk;
          if ((c >> 5) == j) bits |= 1u << (c & 31);
        }
      }
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0) occ[(size_t)g * NW + j] = bits;
  }
}

// From the band itself, one pass that reads M [tiles, E, B, W] once: one
// warp a grid row, lane l of word j the chunk 32 j + l; a value is nonzero
// when its bits other than the sign are (NaN included).
template <typename T>
__global__ void __launch_bounds__(256)
    band_occupancy_from_band_kernel(const T* __restrict__ M, unsigned* __restrict__ occ,
                                    int rows, int E, int B, int W) {
  constexpr int PIECES = kMpChunk * (int)sizeof(T) / 16;  // uint4 of a row's chunk
  constexpr unsigned kMag = sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu;
  const int g = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= rows) return;
  const int i = g / B;
  const int r = g - i * B;
  const int nw = W / kMpChunk;
  const int NW = occ_words(W);
  for (int j = 0; j < NW; ++j) {
    const int c = j * 32 + lane;
    unsigned any = 0u;
    if (c < nw) {
      for (int n = 0; n < E; ++n) {
        const uint4* p = reinterpret_cast<const uint4*>(M + ((size_t)(i * E + n) * B + r) * W +
                                                        (size_t)c * kMpChunk);
#pragma unroll
        for (int q = 0; q < PIECES; ++q) {
          const uint4 u = __ldg(p + q);
          any |= (u.x & kMag) | (u.y & kMag) | (u.z & kMag) | (u.w & kMag);
        }
      }
    }
    const unsigned bits = __ballot_sync(0xffffffffu, any != 0u);
    if (lane == 0) occ[(size_t)g * NW + j] = bits;
  }
}

cudaError_t launch_band_occupancy(const int* nlist, const float* d, const int* lo,
                                  const int* ids, unsigned* occ, int tiles, int n_rows,
                                  int n_tiles, int B, int K, int W, cudaStream_t s) {
  if (tiles < 1 || B < 1 || K < 1 || W < 1 || W % kMpChunk != 0 || n_rows < 0 || n_tiles < 0)
    return cudaErrorInvalidValue;
  const int rows = tiles * B;
  band_occupancy_kernel<<<(rows + 7) / 8, 256, 0, s>>>(nlist, d, lo, ids, occ, rows, n_rows,
                                                       n_tiles, B, K, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_occupancy_from_band(const T* M, unsigned* occ, int tiles, int E, int B,
                                       int W, cudaStream_t s) {
  if (tiles < 1 || E < 1 || B < 1 || W < 1 || W % kMpChunk != 0) return cudaErrorInvalidValue;
  const int rows = tiles * B;
  band_occupancy_from_band_kernel<T><<<(rows + 7) / 8, 256, 0, s>>>(M, occ, rows, E, B, W);
  return cudaGetLastError();
}

}  // namespace
