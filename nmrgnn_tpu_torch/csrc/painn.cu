// The message of a PaiNN interaction block (ops/painn.py's message): for
// each atom i, over its real neighbor slots k (edges > 0), j = nlist[i, k],
//
//   s_out[i]    = s[i]    + sum_k W_a[i, k] ctx_a[j]
//   v_out[i, x] = v[i, x] + sum_k (W_b[i, k] ctx_b[j] r^[i, k, x]
//                                  + W_c[i, k] ctx_c[j] v[j, x])
//
// with (W_a, W_b, W_c) the block's 3F filter columns of slot (i, k) and
// (ctx_a, ctx_b, ctx_c) the context Dense output [N, 3F]. No TPU kernel:
// the JAX package has no PaiNN. The plain version (message_sums_plain)
// gathers [N, K, 3F] and [N, K, 3, F] products over every slot and sums
// them away; this kernel writes only s_out [N, F] and v_out [N, 3, F].
//
// Built by ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the extern "C" functions at the end. The
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.
//
// Bound: reading W's real slots, 3F floats each, once: at 44,676 atoms,
// 2.45 M real slots and F = 128, 3.76 GB a block, 1.12 ms at 3.35 TB/s.
// W is the block's column slice of the filter [N, K, 3BF], read in place
// by its row strides (never copied). Design: one warp an atom, lane l
// holding channels [C l, C l + C) of a, b and c (C = F / 32) in
// registers, 16-byte loads where C allows. A ballot over the atom's slots
// (32 at a time) skips the padding ones, whose filter is exactly 0; the
// live slots are taken in slot order, two at a time (F <= 128), their
// index and direction broadcast by shuffles, so each lane has 18 loads of
// C floats in flight. W streams with an evict-first hint; the context and
// v rows of the neighbors (the serving order puts them close together)
// are read through the read-only path and stay in L1 / L2. No atomics,
// no shared memory: each output is one lane's sum, in slot order, so the
// result does not change from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 atoms a block
constexpr int kWarpAtoms = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// C consecutive floats at p into r: 16-byte loads where C is a multiple
// of 4, 8-byte ones where of 2. kStream: read once, evict first.
template <int C, bool kStream>
__device__ __forceinline__ void load_ch(const float* __restrict__ p, float (&r)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C; q += 4) {
      const float4* a = reinterpret_cast<const float4*>(p + q);
      float4 t;
      if constexpr (kStream)
        t = __ldcs(a);
      else
        t = __ldg(a);
      r[q] = t.x;
      r[q + 1] = t.y;
      r[q + 2] = t.z;
      r[q + 3] = t.w;
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int q = 0; q < C; q += 2) {
      const float2* a = reinterpret_cast<const float2*>(p + q);
      float2 t;
      if constexpr (kStream)
        t = __ldcs(a);
      else
        t = __ldg(a);
      r[q] = t.x;
      r[q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < C; ++q) r[q] = kStream ? __ldcs(p + q) : __ldg(p + q);
  }
}

template <int C>
__device__ __forceinline__ void store_ch(float* __restrict__ p, const float (&r)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C; q += 4)
      *reinterpret_cast<float4*>(p + q) = make_float4(r[q], r[q + 1], r[q + 2], r[q + 3]);
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int q = 0; q < C; q += 2) *reinterpret_cast<float2*>(p + q) = make_float2(r[q], r[q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < C; ++q) p[q] = r[q];
  }
}

// One live slot's operands, this lane's channels.
template <int C>
struct Slot {
  float wa[C], wb[C], wc[C];  // the filter
  float xa[C], xb[C], xc[C];  // the neighbor's context
  float vj[3][C];             // the neighbor's vector state
  float ux, uy, uz;           // r^
};

// Issues the loads of slot `b` of the 32 slots from k0 (the lanes' own
// index j and direction, broadcast from lane b).
template <int C>
__device__ __forceinline__ void fetch(Slot<C>& t, const float* __restrict__ w_i,
                                      long long w_slot, const float* __restrict__ ctx,
                                      const float* __restrict__ v, int k0, int b, int j,
                                      float ux, float uy, float uz, int c0) {
  constexpr int F = 32 * C;
  const int jb = __shfl_sync(kFull, j, b);
  t.ux = __shfl_sync(kFull, ux, b);
  t.uy = __shfl_sync(kFull, uy, b);
  t.uz = __shfl_sync(kFull, uz, b);
  const float* wk = w_i + (size_t)(k0 + b) * (size_t)w_slot + c0;
  load_ch<C, true>(wk, t.wa);
  load_ch<C, true>(wk + F, t.wb);
  load_ch<C, true>(wk + 2 * F, t.wc);
  const float* cj = ctx + (size_t)jb * (3 * F) + c0;
  load_ch<C, false>(cj, t.xa);
  load_ch<C, false>(cj + F, t.xb);
  load_ch<C, false>(cj + 2 * F, t.xc);
  const float* vr = v + (size_t)jb * (3 * F) + c0;
#pragma unroll
  for (int x = 0; x < 3; ++x) load_ch<C, false>(vr + x * F, t.vj[x]);
}

// The slot's terms, each product rounded as the plain version rounds it.
template <int C>
__device__ __forceinline__ void accumulate(const Slot<C>& t, float (&as)[C],
                                           float (&av)[3][C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    as[c] += t.wa[c] * t.xa[c];
    const float b = t.wb[c] * t.xb[c];
    const float cc = t.wc[c] * t.xc[c];
    av[0][c] += b * t.ux + cc * t.vj[0][c];
    av[1][c] += b * t.uy + cc * t.vj[1][c];
    av[2][c] += b * t.uz + cc * t.vj[2][c];
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    painn_message_kernel(const float* __restrict__ s, const float* __restrict__ v,
                         const float* __restrict__ ctx, const float* __restrict__ w,
                         const float* __restrict__ unit, const int* __restrict__ nlist,
                         const float* __restrict__ edges, float* __restrict__ s_out,
                         float* __restrict__ v_out, int n, int K, long long w_atom,
                         long long w_slot) {
  constexpr int F = 32 * C;
  constexpr bool kPairs = C <= 4;  // two slots in flight where the registers allow
  const int i = blockIdx.x * kWarpAtoms + threadIdx.x / 32;
  if (i >= n) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int c0 = lane * C;
  const float* w_i = w + (size_t)i * (size_t)w_atom;
  float as[C], av[3][C];
#pragma unroll
  for (int c = 0; c < C; ++c) as[c] = av[0][c] = av[1][c] = av[2][c] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    int j = 0;
    float ux = 0.0f, uy = 0.0f, uz = 0.0f;
    bool live = false;
    if (k < K) {
      const size_t ik = (size_t)i * K + k;
      live = edges[ik] > 0.0f;
      j = nlist[ik];
      if (j < 0) j += n;  // counted from the end, as the plain gather counts it
      ux = unit[3 * ik];
      uy = unit[3 * ik + 1];
      uz = unit[3 * ik + 2];
    }
    unsigned todo = __ballot_sync(kFull, live);
    while (todo) {
      const int b0 = __ffs(todo) - 1;
      todo &= todo - 1;
      Slot<C> t0;
      fetch<C>(t0, w_i, w_slot, ctx, v, k0, b0, j, ux, uy, uz, c0);
      if (kPairs && todo) {
        const int b1 = __ffs(todo) - 1;
        todo &= todo - 1;
        Slot<C> t1;
        fetch<C>(t1, w_i, w_slot, ctx, v, k0, b1, j, ux, uy, uz, c0);
        accumulate<C>(t0, as, av);
        accumulate<C>(t1, as, av);
      } else {
        accumulate<C>(t0, as, av);
      }
    }
  }
  float r[C];
  load_ch<C, false>(s + (size_t)i * F + c0, r);
#pragma unroll
  for (int c = 0; c < C; ++c) r[c] += as[c];
  store_ch<C>(s_out + (size_t)i * F + c0, r);
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const size_t o = ((size_t)i * 3 + x) * F + c0;
    load_ch<C, false>(v + o, r);
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] += av[x][c];
    store_ch<C>(v_out + o, r);
  }
}

template <int C>
cudaError_t launch_message(const float* s, const float* v, const float* ctx, const float* w,
                           const float* unit, const int* nlist, const float* edges,
                           float* s_out, float* v_out, int n, int K, long long w_atom,
                           long long w_slot, cudaStream_t stream) {
  const int blocks = (n + kWarpAtoms - 1) / kWarpAtoms;
  painn_message_kernel<C><<<blocks, kThreads, 0, stream>>>(s, v, ctx, w, unit, nlist, edges,
                                                           s_out, v_out, n, K, w_atom, w_slot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A block's message (above) over n atoms of K slots at F = 32 C channels,
// C 1 to 8. s [n, F], v [n, 3, F], ctx [n, 3F], unit [n, K, 3], nlist and
// edges [n, K] contiguous; w points at the block's first filter column of
// atom 0, slot 0, with w_atom and w_slot floats between atoms and slots
// (the filter's row strides), all 16-byte aligned.
int nmr_painn_message(const float* s, const float* v, const float* ctx, const float* w,
                      const float* unit, const int* nlist, const float* edges, float* s_out,
                      float* v_out, int n, int K, int F, long long w_atom, long long w_slot,
                      void* stream) {
  if (n < 0 || K < 0 || F % 32 != 0 || F < 32 || F > 256 || w_atom < 0 || w_slot < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NMR_PAINN_CASE(CC)                                                                   \
  case CC:                                                                                   \
    return launch_message<CC>(s, v, ctx, w, unit, nlist, edges, s_out, v_out, n, K, w_atom, \
                              w_slot, st);
  switch (F / 32) {
    NMR_PAINN_CASE(1)
    NMR_PAINN_CASE(2)
    NMR_PAINN_CASE(3)
    NMR_PAINN_CASE(4)
    NMR_PAINN_CASE(5)
    NMR_PAINN_CASE(6)
    NMR_PAINN_CASE(7)
    NMR_PAINN_CASE(8)
  }
#undef NMR_PAINN_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
