// The fused edge stage + band build (B3) of nmrgnn_tpu_torch, shared by
// banded.cu (EdgeFC widths 128 and 256) and fused_wide.cu (512, 1,024 and
// 2,048), two sources so that their instantiations build in parallel.
// ops/banded.py holds the wrapper (build_band_fused) and its plain version.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Fused edge stage. Replaces _fused_edge_band_kernel
// (nmrgnn_tpu/ops/banded.py:1107-1170): RBF of the distances, the hidden
// EdgeFC layers (Dense H x H + activation), the final Dense H x E, the
// d > 0 mask, then the band build, without writing the [N, K, H]
// activations to device memory.
//
// What bounds it: the EdgeFC products, 2*N*K*H*H flops per hidden layer
// (70.5 GFLOP at 44,676 atoms with 3 hidden layers: 1.05 ms in float32 at
// 67 TFLOP/s), then the accurate transcendentals (the RBF's expf, the
// activations' log1pf(expf) or tanhf: about a fifth of the products'
// issue slots in float32) on the same CUDA cores; the M write is the
// byte term.
//
// An EdgeFC pass of a block takes 128 consecutive edge slots (128 / K
// atoms; fewer slots at wider H and more passes at larger K, see "Widths"
// below), 256 threads, two blocks an SM (at most 128 registers a thread,
// at most 102 KB of shared memory a block in float32 at K = 16), so one
// block's RBF, activations and band writes overlap the other's products.
// The compute type is a template argument:
//
// float32 (CUDA cores, no TF32: the exact tolerance). The activations
// live in shared memory feature-major (xT[h][s], 64 KB); each layer's
// [H, H] kernel streams through a 2-stage cp.async ring of 32-row chunks
// (32 KB; the first chunk is in flight during the RBF pass, the next
// layer's during this layer's epilogue; 4 barriers a layer). Each thread computes an 8 x 8
// register tile of the 128 x 128 layer output (slots ty*4+{0..3},
// 64+ty*4+{0..3}; features tx*4+{0..3}, 64+tx*4+{0..3}), both operands
// read as float4 without bank conflicts; the k sum is one fmaf chain in
// ascending order, so every value equals the one-block-an-SM kernel's it
// replaced bit for bit.
//
// bfloat16 (ops/edge.py's as_operand: jnp.dot(x.astype(bf16),
// k.astype(bf16), preferred_element_type=float32)): the RBF and each
// layer's activations are stored as bfloat16 in shared memory
// ([s][h], rows padded to 288 bytes, 36 KB) and every hidden layer runs on
// the tensor cores, mma.sync.m16n8k16 with float32 accumulation: warp w
// owns slots (w % 2) * 64 + [0, 64) and features (w / 2) * 32 + [0, 32)
// and reads its A fragments and its B fragments, from the layer's kernel
// given transposed in bfloat16 ([H_out, H_in], k contiguous, staged in
// shared memory by cp.async during the RBF or the previous epilogue,
// 36 KB), 64 bits at a time with the k order inside a 16-wide step
// permuted alike in both operands. Each product is exact and
// every sum float32, in another order than the plain version's. The final
// Dense H x E sums each slot's 128 terms over a warp's lanes.
//
// Both: the RBF centres __fadd_rn(__fmul_rn(h, gap), low), divided by the
// gap, not its square; biases, activations (accurate expf, log1pf, tanhf),
// the final layer and the d > 0 mask in float32; the band rows summed in
// float32 in slot order (duplicate indices add) and rounded once to
// OutT by common.cuh's band_rows, the writer of every band build.

// Widths. More than 4 edge channels run as groups of 4 (the hidden
// layers again for each group, the final kernel's columns of the group,
// M's channels through its channel stride m_e). An EdgeFC pass of a block
// covers kFusedOut / H consecutive edge slots (128 at H = 128, 64 at 256,
// 32 at 512, 16 at 1,024, 8 at 2,048), so that every width keeps the same
// per-thread tiles; ops/banded.py pads other hidden widths up to one of
// these with zero weights (exact: a padded unit's act(0) meets a zero row
// of the next kernel, a padded RBF centre a zero row of the first).
// Past H = 256 the hidden kernel [H, H] no longer fits shared memory
// beside the activations, so the widths 512 to 2,048 run the float32
// design above, which streams it through the ring in 4096 / H-row chunks
// whatever H is; a bfloat16 compute type there (ops/banded.py's
// "bf16 operands on the CUDA cores", b16ops) stores the RBF and every
// activation rounded to bfloat16 and is handed the hidden kernels rounded
// to bfloat16, so each product is exact and every sum float32, as on the
// tensor cores. The block takes `rows` whole atoms (rows the largest power
// of two dividing B whose rows * K slots fit one pass, else 1) and runs
// its rows * K slots through the EdgeFC in passes of kFusedOut / H slots,
// each pass's edge values kept in shared memory; after the last pass the
// band rows are written from all of them (slot order, as the plain
// version). So K is bounded only by the slots' shared memory: rows * K *
// (E + 1) floats beside the pass's buffers.
constexpr int kFusedOut = 128 * 128;  // slots x H of one EdgeFC pass
constexpr int kFusedThreads = 256;
constexpr int kWStages = 2;           // ring stages, one in flight (float32)

template <int H>
__host__ __device__ constexpr int fused_slots() { return kFusedOut / H; }
template <int H>
__host__ __device__ constexpr int fused_kc() { return 4096 / H; }  // ring rows: 16 KB a stage
template <int H>
__host__ __device__ constexpr int fused_xs() { return H + 16; }  // bfloat16 row stride

// The pass's buffers. float32: xT and the ring; bfloat16: the activations
// and the layer's kernel, [slots][H + 16] and [H][H + 16]. The block's
// slots' edge values and window-relative indices follow.
template <bool kTC, int H>
__host__ __device__ constexpr size_t fused_smem_bytes() {
  return kTC ? (size_t)(fused_slots<H>() + H) * fused_xs<H>() * sizeof(__nv_bfloat16)
             : (size_t)(H * fused_slots<H>() + kWStages * fused_kc<H>() * H) * sizeof(float);
}

// f(std::integral_constant<int, act>()): the epilogues see the activation
// as a constant, so their 64 elements are scheduled together rather than
// each behind its own branch.
template <typename Fn>
__device__ __forceinline__ void with_activation(int act, Fn&& f) {
  switch (act) {
    case kRelu: f(std::integral_constant<int, kRelu>()); break;
    case kSoftplus: f(std::integral_constant<int, kSoftplus>()); break;
    case kTanh: f(std::integral_constant<int, kTanh>()); break;
    default: f(std::integral_constant<int, kLinear>()); break;
  }
}

template <int E, typename OutT, bool kTC, int H>
__global__ void __launch_bounds__(kFusedThreads, 2)
    fused_edge_band_kernel(const int* __restrict__ nlist,  // [N_pad, K]
                           const float* __restrict__ d,    // [N_pad, K]
                           const int* __restrict__ lo,     // [T]
                           const void* __restrict__ wh_,   // f32 [Lh, H_in, H_out];
                                                           // kTC: bf16 [Lh, H_out, H_in]
                           const float* __restrict__ bh,   // [Lh, H]
                           const float* __restrict__ wf,   // [H, E] (the group's channels)
                           const float* __restrict__ bf,   // [E]
                           OutT* __restrict__ M,           // [T, m_e, B, W] at the group
                           int B, int K, int W, int n_hidden, float rbf_low, float gap,
                           float inv_gap, int act, int rows, int m_e, int b16ops) {
  constexpr int SL = fused_slots<H>();
  constexpr int KC = fused_kc<H>();
  constexpr int XS = fused_xs<H>();
  extern __shared__ float4 smem4[];
  __shared__ float s_d[SL];
  __shared__ float s_mask[SL];
  __shared__ float s_wf[H * E];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nsl = rows * K;  // the block's slots, in passes of SL
  const size_t slot0 = (size_t)blockIdx.x * nsl;
  const int row0 = blockIdx.x * rows;
  const bool round_ops = kTC || b16ops;
  float* s_e = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                        fused_smem_bytes<kTC, H>());  // [nsl * E]
  int* s_rel = reinterpret_cast<int*>(s_e + (size_t)nsl * E);        // [nsl]

  // float32: the hidden kernels' rows, chunk c = rows [KC c, +KC) of all
  // layers laid end to end; each pass's first in flight before its RBF
  float* xT = reinterpret_cast<float*>(smem4);  // [H][SL]
  float* wring = xT + H * SL;                   // [kWStages][KC][H]
  const float* wh = static_cast<const float*>(wh_);
  const int total = kTC ? 0 : n_hidden * (H / KC);
  auto load_w = [&](int c) {
    const float* g = wh + (size_t)c * KC * H;
    float* st = wring + (c % kWStages) * KC * H;
    for (int s = tid; s < KC * H / 4; s += kFusedThreads)
      cp_async16(st + s * 4, g + s * 4, true);
  };
  for (int i = tid; i < H * E; i += kFusedThreads)
    s_wf[i] = round_ops ? round_to<__nv_bfloat16>(wf[i]) : wf[i];

  for (int cb = 0; cb < nsl; cb += SL) {  // one EdgeFC pass over slots [cb, cb + SL)
    if constexpr (!kTC) {
      for (int c = 0; c < kWStages - 1; ++c) {
        if (c < total) load_w(c);
        cp_async_commit();  // possibly empty: the waits count groups
      }
    }
    for (int s = tid; s < SL; s += kFusedThreads) {
      const bool ok = cb + s < nsl;
      const float dv = ok ? d[slot0 + cb + s] : 0.0f;
      s_d[s] = dv;
      s_mask[s] = dv > 0.0f ? 1.0f : 0.0f;
      if (ok) s_rel[cb + s] = nlist[slot0 + cb + s] - lo[(row0 + (cb + s) / K) / B];
    }
    __syncthreads();

    if constexpr (!kTC) {
      // RBF with centers h * gap + low (rounded as two operations, as the
      // TPU kernel computes them), divided by the gap, not the gap squared.
      for (int i = tid; i < H * SL; i += kFusedThreads) {
        const int h = i / SL;
        const int s = i - h * SL;
        const float c = __fadd_rn(__fmul_rn((float)h, gap), rbf_low);
        const float x = s_d[s] - c;
        const float v = expf(-(x * x) * inv_gap) * s_mask[s];
        xT[i] = b16ops ? round_to<__nv_bfloat16>(v) : v;
      }

      // thread (ty, tx): slots ty*4 + {0..3}, SL/2 + ty*4 + {0..3}; features
      // tx*4 + {0..3}, H/2 + tx*4 + {0..3}
      const int ty = tid % (SL / 8);
      const int tx = tid / (SL / 8);
      for (int l = 0; l < n_hidden; ++l) {
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        for (int cl = 0; cl < H / KC; ++cl) {
          const int c = l * (H / KC) + cl;
          cp_async_wait<kWStages - 2>();  // chunk c has landed
          __syncthreads();  // ... for every thread; chunk c - 1's stage is free; xT published
          if (c + kWStages - 1 < total) load_w(c + kWStages - 1);
          cp_async_commit();
          const float* sw = wring + (c % kWStages) * KC * H;
          const float* xk = xT + cl * KC * SL;
#pragma unroll 4
          for (int k = 0; k < KC; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(xk + k * SL + ty * 4);
            const float4 a1 = *reinterpret_cast<const float4*>(xk + k * SL + SL / 2 + ty * 4);
            const float4 b0 = *reinterpret_cast<const float4*>(sw + k * H + tx * 4);
            const float4 b1 = *reinterpret_cast<const float4*>(sw + k * H + H / 2 + tx * 4);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
        __syncthreads();  // every read of xT is done before it is overwritten

        with_activation(act, [&](auto ka) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int f = (j < 4) ? tx * 4 + j : H / 2 + tx * 4 + (j - 4);
            const float bias = bh[(size_t)l * H + f];
            float v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              v[i] = activate(acc[i][j] + bias, decltype(ka)::value);
              if (b16ops) v[i] = round_to<__nv_bfloat16>(v[i]);
            }
            *reinterpret_cast<float4*>(xT + f * SL + ty * 4) = make_float4(v[0], v[1], v[2], v[3]);
            *reinterpret_cast<float4*>(xT + f * SL + SL / 2 + ty * 4) =
                make_float4(v[4], v[5], v[6], v[7]);
          }
        });
      }
      cp_async_wait<0>();
      __syncthreads();

      // Final linear layer H -> E, bias, then the d > 0 mask.
      for (int o = tid; o < SL * E; o += kFusedThreads) {
        const int n = o / SL;
        const int s = o - n * SL;
        if (cb + s >= nsl) continue;
        float acc = 0.0f;
        for (int k = 0; k < H; ++k) acc = fmaf(xT[k * SL + s], s_wf[k * E + n], acc);
        s_e[(size_t)(cb + s) * E + n] = (acc + bf[n]) * s_mask[s];
      }
    } else {
      __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem4);  // [SL][XS]
      __nv_bfloat16* Ws = X + SL * XS;  // [H][XS]: layer l's [H_out, H_in] kernel
      const __nv_bfloat16* wt = static_cast<const __nv_bfloat16*>(wh_);
      auto load_wt = [&](int l) {
        const __nv_bfloat16* g = wt + (size_t)l * H * H;
        for (int s = tid; s < H * H / 8; s += kFusedThreads) {  // 16 bytes each
          const int r = s / (H / 8);
          const int q = s - r * (H / 8);
          cp_async16(Ws + r * XS + q * 8, g + r * H + q * 8, true);
        }
      };
      if (n_hidden > 0) load_wt(0);  // in flight during the RBF
      cp_async_commit();
      for (int i = tid; i < H * SL; i += kFusedThreads) {
        const int s = i / H;
        const int h = i - s * H;
        const float c = __fadd_rn(__fmul_rn((float)h, gap), rbf_low);
        const float x = s_d[s] - c;
        X[s * XS + h] = __float2bfloat16_rn(expf(-(x * x) * inv_gap) * s_mask[s]);
      }
      const int g = lane >> 2;
      const int t4 = (lane & 3) * 4;
      const int t2 = (lane & 3) * 2;
      constexpr int SG = SL / 64;          // warps along the slots
      const int sm0 = (warp % SG) * 64;    // the warp's 64 slots
      const int fn0 = (warp / SG) * 32;    // and 32 features
      for (int l = 0; l < n_hidden; ++l) {
        cp_async_wait<0>();
        __syncthreads();  // the RBF or the last epilogue, and layer l's kernel, are published
        float acc[4][4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;
#pragma unroll 2
        for (int k0 = 0; k0 < H; k0 += 16) {
          // physical k0 + t4 .. + 3 is logical (2t, 2t+1, 2t+8, 2t+9) in both operands
          unsigned a[4][4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const __nv_bfloat16* xr = X + (sm0 + mt * 16 + g) * XS + k0 + t4;
            const uint2 x = *reinterpret_cast<const uint2*>(xr);
            const uint2 y = *reinterpret_cast<const uint2*>(xr + 8 * XS);
            a[mt][0] = x.x, a[mt][1] = y.x, a[mt][2] = x.y, a[mt][3] = y.y;
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint2 b =
                *reinterpret_cast<const uint2*>(Ws + (fn0 + nt * 8 + g) * XS + k0 + t4);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], a[mt], b.x, b.y);
          }
        }
        __syncthreads();  // every read of X and Ws is done before they are overwritten
        if (l + 1 < n_hidden) load_wt(l + 1);  // in flight during the epilogue
        cp_async_commit();
        with_activation(act, [&](auto ka) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int f = fn0 + nt * 8 + t2;
            const float b0 = bh[(size_t)l * H + f];
            const float b1 = bh[(size_t)l * H + f + 1];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int s = sm0 + mt * 16 + g + half * 8;
                *reinterpret_cast<__nv_bfloat162*>(X + s * XS + f) = __floats2bfloat162_rn(
                    activate(acc[mt][nt][2 * half] + b0, decltype(ka)::value),
                    activate(acc[mt][nt][2 * half + 1] + b1, decltype(ka)::value));
              }
          }
        });
      }
      cp_async_wait<0>();
      __syncthreads();

      // Final linear layer H -> E: a warp a slot at a time, lane l the terms
      // k = l * H / 32 .. (their kernel rows held in registers), summed over
      // the lanes; bias, then the d > 0 mask.
      constexpr int KPL = H / 32;
      float wreg[KPL][E];
#pragma unroll
      for (int q = 0; q < KPL; ++q)
#pragma unroll
        for (int n = 0; n < E; ++n) wreg[q][n] = s_wf[(lane * KPL + q) * E + n];
      for (int s = warp; s < SL; s += kFusedThreads / 32) {
        if (cb + s >= nsl) break;  // uniform over the warp
        float xv[KPL];
#pragma unroll
        for (int q = 0; q < KPL; q += 2) {
          const float2 x2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(X + s * XS + lane * KPL + q));
          xv[q] = x2.x, xv[q + 1] = x2.y;
        }
#pragma unroll
        for (int n = 0; n < E; ++n) {
          float acc = 0.0f;
#pragma unroll
          for (int q = 0; q < KPL; ++q) acc = fmaf(xv[q], wreg[q][n], acc);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
          if (lane == 0) s_e[(size_t)(cb + s) * E + n] = (acc + bf[n]) * s_mask[s];
        }
      }
    }
    __syncthreads();  // the pass's edge values are published; its buffers are free
  }

  // The band rows (all of one tile: rows divides B), through the writer
  // B2 and B4 share.
  const int t = row0 / B;
  band_rows<E, OutT>(s_rel, s_e, rows, K, W, M + ((size_t)t * m_e * B + (row0 - t * B)) * W,
                     (size_t)B * W, tid, kFusedThreads);
}

template <int E, typename OutT, bool kTC, int H>
cudaError_t launch_fused(const int* nlist, const float* d, const int* lo, const void* wh,
                         const float* bh, const float* wf, const float* bf, void* M,
                         int n_pad, int B, int K, int W, int n_hidden, float rbf_low,
                         float gap, float inv_gap, int act, int rows, int m_e, int b16ops,
                         cudaStream_t stream) {
  // the pass's buffers, then the block's slots: rows * K edge values and indices
  const size_t smem = fused_smem_bytes<kTC, H>() + (size_t)rows * K * (E + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_edge_band_kernel<E, OutT, kTC, H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // float32: two blocks of 96 KB an SM
    err = cudaFuncSetAttribute(fused_edge_band_kernel<E, OutT, kTC, H>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  fused_edge_band_kernel<E, OutT, kTC, H><<<n_pad / rows, kFusedThreads, smem, stream>>>(
      nlist, d, lo, wh, bh, wf, bf, static_cast<OutT*>(M), B, K, W, n_hidden, rbf_low, gap,
      inv_gap, act, rows, m_e, b16ops);
  return cudaGetLastError();
}

}  // namespace
