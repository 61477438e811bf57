// Device code shared by banded.cu, poly.cu, hbm.cu, fused_first.cu,
// blocksparse.cu and attention.cu: the activations, float32 / bfloat16
// element access, the cp.async staging, the tensor cores' bfloat16
// product, the Chebyshev edge stage, and the band-row writer and row
// groups of the band builds.
//
// bfloat16 follows the TPU kernels' mixed precision: operands are bf16,
// products and sums are float32 (a bf16 x bf16 product is exact in f32),
// and a value is rounded to bf16 (round to nearest even) only where the
// JAX kernel casts it: h before the second product, and the stored output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Act { kLinear = 0, kRelu = 1, kSoftplus = 2, kTanh = 3 };

// softplus as max(x, 0) + log1p(exp(-|x|)), the form of jax.nn.softplus.
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.0f);
    case kSoftplus:
      return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
    case kTanh:
      return tanhf(x);
    default:
      return x;
  }
}

// -- element access --------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the identity for float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Four consecutive elements (16-byte aligned for float, 8 for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned int*>(&a);
  u.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// -- cp.async staging (mp.cuh, banded.cu) ------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- tensor cores (mp.cuh, banded.cu) ----------------------------------------

// D += A @ B on the tensor cores: A 16 x 16 bf16 (row major), B 16 x 8
// bf16 (column major), D 16 x 8 float32 (PTX ISA's m16n8k16 fragments).
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- the Chebyshev edge stage (poly.cu, fused_first.cu) ----------------------

// The E edge values of one slot at distance dv: the clamped distance mapped
// onto [-1, 1], x = 2 (clamp(dv) - d_lo) / span - 1, the forward recurrence
// T_p = 2x T_{p-1} - T_{p-2} summed in degree order with the coefficients
// c[p * E + n], then the d > 0 mask. Every product and sum is rounded
// separately, as the JAX kernel (_poly_build_tile, nmrgnn_tpu/ops/
// banded.py:1418-1438) and the plain version round them, so no FMA
// contraction changes a bit and every build gives the same values.
template <int E>
__device__ __forceinline__ void cheb_edge(float dv, const float* c, int degree, float d_lo,
                                          float d_hi, float span, float* e_out) {
  const float clamped = fminf(fmaxf(dv, d_lo), d_hi);
  const float x =
      __fsub_rn(__fdiv_rn(__fmul_rn(2.0f, __fsub_rn(clamped, d_lo)), span), 1.0f);
  const float x2 = __fmul_rn(2.0f, x);
  float e[E];
#pragma unroll
  for (int n = 0; n < E; ++n) e[n] = __fadd_rn(c[n], __fmul_rn(c[E + n], x));
  float tp_prev = 1.0f;
  float tp = x;
  for (int p = 2; p <= degree; ++p) {
    const float tn = __fsub_rn(__fmul_rn(x2, tp), tp_prev);
    tp_prev = tp;
    tp = tn;
#pragma unroll
    for (int n = 0; n < E; ++n) e[n] = __fadd_rn(e[n], __fmul_rn(c[p * E + n], tp));
  }
  const float mask = dv > 0.0f ? 1.0f : 0.0f;
#pragma unroll
  for (int n = 0; n < E; ++n) e_out[n] = __fmul_rn(e[n], mask);
}

// -- band rows -------------------------------------------------------------

// Sixteen bytes of consecutive elements (16-byte aligned): 4 float32 or 8
// bfloat16 values, each rounded to nearest even.
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  unsigned u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    u[j] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// The rows of a row group of one tile: for r in [0, rows) and w in
// [0, W), out[n * channel_stride + r * W + w] = the sum of
// ev[(r * K + k) * E + n] over the slots k of row r with rel[r * K + k]
// == w, taken in slot order from 0 in float32 and rounded once to OutT.
// Duplicate indices add; indices outside [0, W) (other windows, and -1
// padding) match nothing, and their ev is never read. rel and ev lie in
// shared memory. The one band-row writer of B2, B3, B4, B7 and B8, so
// their bands agree bit for bit.
//
// The band is more than 97% zeros and bound by its write, so the stores
// set the pace: a warp writes a row, a lane 16 bytes (a vector of 4
// float32 or 8 bfloat16 columns) a store, a warp 32 vectors (128 or 256
// consecutive columns) a pass. In each pass the warp finds, by a ballot
// over the row's slots (32 a step), the slots whose index lands in its
// columns, and walks them in slot order: the lane owning a slot's column
// adds its E values. A row's K indices touch a few of its W / 4 or W / 8
// vectors, so most stores are zeros computed with no compare. (Spreading
// a row's passes over several warps measured slower on the card.) Where
// W is not a multiple of the vector, out rows are not 16-byte aligned and
// the values are stored one by one. Every warp of the block calls it
// (nthreads a multiple of 32).
template <int E, typename OutT>
__device__ __forceinline__ void band_rows(const int* rel, const float* ev, int rows, int K,
                                          int W, OutT* out, size_t channel_stride, int tid,
                                          int nthreads) {
  constexpr int V = 16 / (int)sizeof(OutT);
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = tid & 31;
  const int nvec = (W + V - 1) / V;
  const bool vec = W % V == 0;
  for (int r = tid >> 5; r < rows; r += nthreads >> 5) {
    const int* rr = rel + r * K;
    const float* er = ev + (size_t)r * K * E;
    OutT* orow = out + (size_t)r * W;
    for (int v0 = 0; v0 < nvec; v0 += 32) {
      const int w0 = (v0 + lane) * V;
      float acc[E][V];
#pragma unroll
      for (int n = 0; n < E; ++n)
#pragma unroll
        for (int q = 0; q < V; ++q) acc[n][q] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int c = k0 + lane < K ? rr[k0 + lane] : -1;
        unsigned hits = __ballot_sync(
            kAll, static_cast<unsigned>(c) < static_cast<unsigned>(W) &&
                      static_cast<unsigned>(c - v0 * V) < static_cast<unsigned>(32 * V));
        while (hits) {  // the pass's slots, in slot order
          const int j = __ffs(hits) - 1;
          hits &= hits - 1;
          const int dq = __shfl_sync(kAll, c, j) - w0;
          if (static_cast<unsigned>(dq) < static_cast<unsigned>(V)) {
#pragma unroll
            for (int q = 0; q < V; ++q)
              if (dq == q) {
#pragma unroll
                for (int n = 0; n < E; ++n) acc[n][q] += er[(k0 + j) * E + n];
              }
          }
        }
      }
      if (w0 < W) {
#pragma unroll
        for (int n = 0; n < E; ++n) {
          OutT* o = orow + n * channel_stride + w0;
          if (vec) {
            store_vec(o, acc[n]);
          } else {
#pragma unroll
            for (int q = 0; q < V; ++q)
              if (w0 + q < W) o[q] = from_f32<OutT>(acc[n][q]);
          }
        }
      }
    }
  }
}

// -- band builds (banded.cu, poly.cu) ---------------------------------------

// A block of the band builds B2, B4, B7 and B8 takes `rows` rows of one
// tile (rows divides the tile's B rows; ops/banded.py's build_rows picks
// 4, which measured best or near it on the card at 2,482 and 44,676 atoms
// among 1 to 32), stages their rows * K slots (window-relative index and E values)
// in shared memory and writes them with band_rows, with band_threads(rows)
// threads: a warp a row up to 8 rows, 2 warps at least, 256 at most.
// band_rows walks a row's slots 32 at a time, so K is bounded only by the
// staging: rows * K * (E + 1) floats, past 48 KB with the block opted in
// to more (build_rows in ops/banded.py shrinks `rows` as K grows), at
// most 8,192 slots (160 KB at one row of 4 channels, with B4's 4 KB of
// coefficients under the 227 KB a block may use).
constexpr int kBandMaxThreads = 256;
constexpr int kBandMaxRows = 16;
constexpr int kBandMaxK = 8192;
constexpr size_t kBandDefaultSmem = 48 * 1024;  // a block's shared memory without opting in

__host__ __device__ constexpr int band_threads(int rows) {
  return rows >= 8 ? kBandMaxThreads : (rows > 2 ? 32 * rows : 64);
}

__host__ __device__ constexpr bool band_group_ok(int B, int K, int rows) {
  return rows >= 1 && rows <= kBandMaxRows && B % rows == 0 && K >= 1 && K <= kBandMaxK;
}

}  // namespace
