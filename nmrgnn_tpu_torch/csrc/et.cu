// The attention stage of an equivariant-transformer layer (ops/et.py's
// fused_attention; its plain version is attention): for each atom i and
// each head h (D columns of F = H D), over the real slots of i's row of
// the Geometry (an index j in [0, N): a graph edge or the self term; a
// slot whose index is N is no edge and adds exactly 0 in the plain
// version, so it is skipped),
//
//   (dk, s, m1, m2) = SiLU(f W_h + b_h)           f the slot's R basis values
//   a               = SiLU(sum_d q_i k_j dk) C     C the slot's cutoff
//   Sx_i           += a (s v_j)                    v_j's s part
//   Sv_i[x]        += v_state_j[x] (m1 v_j) + (m2 v_j) r^[x]
//
// with W_h the head's D columns of each of dk's kernel [R, F] and dv's
// three parts (kernel [R, 3F], columns ordered (head, part, dim) as
// Dense(R, 3F) gives them, as v [N, 3F] is), b_h the same columns of the
// biases. The basis's column R is its column of ones: its product with
// the bias row is the bias row, which is where each sum starts. Only Sx
// [N, F] and Sv [N, 3, F] are written.
//
// No TPU kernel: the JAX package has no such family. It was added because
// the plain version writes the filters dk [rows, K + 1, F] and dv [rows,
// K + 1, 3F] and the gathered k, v and v_state rows of every slot (about
// 56 KB a slot at F = 256) and reads them back through about 20 launches
// a block of rows, and forms the filters of the slots that are no edge
// too.
//
// Built by ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the extern "C" functions at the end. The
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.
//
// Bound: operations. The filters take 8 R F multiply-adds a real slot
// (2 x 65 x 1,024 FLOP at R = 64, F = 256): 2.62 TFLOP of FFMA a forward
// of the ET cell (2.50 M real slots with the self terms, 8 layers), 39 ms
// at 67 TFLOP/s float32; the 128 SiLUs a slot and head add about a third
// as many instructions again. The gathered rows (7F floats a slot, about
// 141 GB a forward) come mostly from L1 and L2, as the serving order puts
// neighbours close together: on the card, reading every slot's rows from
// its own atom's (perfect locality) saves 2%, so the stage is bound by
// its instructions, not by the gathers.
//
// Design: a block takes one head of a tile of 32 atoms (the grid runs the
// H heads of a tile next to each other, so the tile's basis rows are read
// from DRAM about once). The head's W slice and bias, (R + 1) x 4D floats
// (33 KB at D = 32), sit in shared memory. A warp takes an atom at a time:
// a ballot over its row's slots lists the real ones in slot order, which
// it takes in passes of 8 (D = 32), their basis rows copied to shared
// memory asynchronously (cp.async), the next pass's while this one runs.
// Each lane holds a register tile of 4 slots x 8 columns (2 of a head's D
// in each of dk, s, m1 and m2): per pair of basis values, 4 8-byte loads of
// f and 4 16-byte loads of W (broadcast or conflict-free) feed 64 FFMA. A
// pass whose last rows hold no real slot runs the filters of its first
// rows only. The lanes of a slot reduce its logit by shuffles, read their
// 2 columns of the neighbour's k, v and v_state rows (8-byte loads, a
// 128-byte segment a row at D = 32) and keep Sx and Sv in registers across
// the passes; the slot lanes' sums are added by shuffles at the end. No
// atomics: the result does not change from run to run. With `bf16` the
// basis and W are rounded to bfloat16 as they are staged (as_operand), the
// products and sums stay float32. Tried on the card at the ET cell's
// shapes (a layer, H100): 4 x 16 tiles 22.0 ms (spilling at 128
// registers), 2 x 16 15.6 ms, 8 x 8 18.8-24.4 ms, the neighbour rows
// copied to shared memory with cp.async 17.6 ms, this 4 x 8 14.5 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAtomsPerWarp = 4;
constexpr int kTileAtoms = kWarps * kAtomsPerWarp;  // a block's atoms
constexpr int kRows = 4;          // slots a lane holds (rows of its register tile)
constexpr int kMaxR = 128;        // radial functions
constexpr int kMaxSlots = 129;    // a row's slots: K up to 128 and the self term
constexpr int kMaxShared = 232448;
constexpr unsigned kFull = 0xffffffffu;

// SiLU as torch writes it for float32.
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// t rounded to bfloat16 and back (a product's operand).
__device__ __forceinline__ float bf16_operand(float t) {
  return __bfloat162float(__float2bfloat16_rn(t));
}

// The basis values a pass stages for a slot: R rounded up to 4 (columns
// from R on meet zero rows of the staged W).
__host__ __device__ constexpr int staged_r(int R) { return (R + 3) / 4 * 4; }

// The row stride of the staged basis, in floats: at least rm and 4 more
// than a multiple of 32, so that the slot lanes' loads of one column fall
// in distinct banks.
__host__ __device__ constexpr int basis_stride(int rm) { return (rm - 4 + 31) / 32 * 32 + 4; }

// The slots a warp takes in a pass at head width D: kRows a lane, the
// lanes of a slot holding 2 of its D columns each.
__host__ __device__ constexpr int pass_slots(int D) { return kRows * (32 / (D / 2)); }

// At most 176 KB (D = 16, R = 128, S = 129).
__host__ __device__ inline size_t shared_bytes(int D, int R, int S) {
  const int rm = staged_r(R);
  return sizeof(float) * ((size_t)(rm + 1) * 4 * D +
                          (size_t)kWarps * 2 * pass_slots(D) * basis_stride(rm)) +
         sizeof(int) * 2 * kWarps * (size_t)S;
}

// acc[j] += f[j] W over the staged basis rows of the lane's slots j < JN
// (row j SL + sl of the pass), two basis values at a time: per pair, JN
// 8-byte loads of f, 4 16-byte loads of W, 16 JN FFMA.
template <int JN, int CL, int SL>
__device__ __forceinline__ void filters(float (&acc)[kRows][8], const float* fs,
                                        const float* ws, int stride, int rm, int sl, int cl) {
#pragma unroll 2
  for (int r = 0; r < rm; r += 2) {
    float2 f[JN];
#pragma unroll
    for (int j = 0; j < JN; ++j)
      f[j] = *reinterpret_cast<const float2*>(fs + (j * SL + sl) * stride + r);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(ws + (((r + rr) * 2) * CL + cl) * 4);
      const float4 b = *reinterpret_cast<const float4*>(ws + (((r + rr) * 2 + 1) * CL + cl) * 4);
      const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float x = rr == 0 ? f[j].x : f[j].y;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[j][c] = fmaf(x, w[c], acc[j][c]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    et_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ vec,
                        const long long* __restrict__ nlist, const float* __restrict__ basis,
                        const float* __restrict__ cut, const float* __restrict__ unit,
                        const float* __restrict__ w_dk, const float* __restrict__ b_dk,
                        const float* __restrict__ w_dv, const float* __restrict__ b_dv,
                        float* __restrict__ sx, float* __restrict__ sv, int n, int S, int H,
                        int R, int Rw, int bf16) {
  constexpr int CL = D / 2;         // lanes across the head's D columns, 2 each
  constexpr int SL = 32 / CL;       // lanes across slots
  constexpr int P = pass_slots(D);  // slots a pass
  const int F = H * D;
  const int h = blockIdx.x % H;
  const int tile = blockIdx.x / H;
  const int rm = staged_r(R);
  const int stride = basis_stride(rm);
  const bool round = bf16 != 0;

  extern __shared__ float4 shared4[];
  // W_h and its bias (row rm), [rm + 1][2][CL][4]: lane cl's 8 columns (its
  // 2 of D in dk, s, m1, m2) as two 16-byte halves, (dk, s) then (m1, m2)
  float* ws = reinterpret_cast<float*>(shared4);
  float* fs_all = ws + (size_t)(rm + 1) * 4 * D;  // [kWarps][2][P][stride]: basis rows
  int* ks_all = reinterpret_cast<int*>(fs_all + (size_t)kWarps * 2 * P * stride);
  int* js_all = ks_all + kWarps * S;  // [kWarps][S] each: the real slots and their rows

  // the head's W slice and bias, zero rows from R to rm
  for (int e = threadIdx.x; e < (rm + 1) * 4 * CL; e += kThreads) {
    const int r = e / (4 * CL), part = (e / CL) % 4, c = e % CL;
    float2 w = make_float2(0.0f, 0.0f);
    if (r == rm || r < R) {
      const bool b = r == rm;
      const float* row = part == 0
                             ? (b ? b_dk : w_dk + (size_t)r * F) + h * D
                             : (b ? b_dv : w_dv + (size_t)r * 3 * F) + h * 3 * D + (part - 1) * D;
      w = ldg2(row + 2 * c);
      if (round) w = make_float2(bf16_operand(w.x), bf16_operand(w.y));
    }
    *reinterpret_cast<float2*>(ws + ((r * 2 + part / 2) * CL + c) * 4 + (part % 2) * 2) = w;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sl = lane / CL, cl = lane % CL;
  float* fs = fs_all + (size_t)warp * 2 * P * stride;
  int* ks = ks_all + warp * S;
  int* js = js_all + warp * S;
  const float* bias = ws + (size_t)rm * 4 * D;
  const int nv = rm / 4;

  for (int t = 0; t < kAtomsPerWarp; ++t) {
    const int i = tile * kTileAtoms + t * kWarps + warp;
    if (i >= n) break;  // the whole warp; no block-wide barrier follows

    // the row's real slots in slot order: an index counted from the end
    // of the plain version's N + 1 rows, N (its zero row) no edge
    int count = 0;
    for (int k0 = 0; k0 < S; k0 += 32) {
      const int kk = k0 + lane;
      int j = -1;
      if (kk < S) {
        long long jj = nlist[(size_t)i * S + kk];
        if (jj < 0) jj += (long long)n + 1;
        if (jj >= 0 && jj < n) j = (int)jj;
      }
      const unsigned live = __ballot_sync(kFull, j >= 0);
      if (j >= 0) {
        const int at = count + __popc(live & ((1u << lane) - 1u));
        ks[at] = kk;
        js[at] = j;
      }
      count += __popc(live);
    }
    __syncwarp();

    // a pass's basis rows into buffer b of fs (zeros past the last real
    // slot), copied asynchronously: the next pass's while this one runs
    auto stage = [&](int base, int b) {
      for (int e = lane; e < P * nv; e += 32) {
        const int s = e / nv, c = 4 * (e % nv);
        const bool ok = base + s < count;
        cp_async16(fs + (b * P + s) * stride + c,
                   ok ? basis + ((size_t)i * S + ks[base + s]) * Rw + c : basis, ok);
      }
      cp_async_commit();
    };
    if (count > 0) stage(0, 0);

    const float2 qi = ldg2(q + (size_t)i * F + h * D + 2 * cl);
    float ax[2] = {0.0f, 0.0f};
    float av[3][2] = {};

    for (int base = 0, b = 0; base < count; base += P, b ^= 1) {
      if (base + P < count) {
        stage(base + P, b ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      const float* fb = fs + b * P * stride;
      if (round) {  // this lane's own copies, as as_operand rounds the basis
        for (int e = lane; e < P * nv; e += 32) {
          float4* f = reinterpret_cast<float4*>(fs + (b * P + e / nv) * stride + 4 * (e % nv));
          *f = make_float4(bf16_operand(f->x), bf16_operand(f->y), bf16_operand(f->z),
                           bf16_operand(f->w));
        }
      }
      __syncwarp();

      // the filters of the lane's slots j SL + sl, from the bias row:
      // acc[j] = (dk, s, m1, m2) at its 2 columns each
      float acc[kRows][8];
      {
        const float4 a = *reinterpret_cast<const float4*>(bias + cl * 4);
        const float4 c = *reinterpret_cast<const float4*>(bias + (CL + cl) * 4);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          acc[j][0] = a.x, acc[j][1] = a.y, acc[j][2] = a.z, acc[j][3] = a.w;
          acc[j][4] = c.x, acc[j][5] = c.y, acc[j][6] = c.z, acc[j][7] = c.w;
        }
      }
      const int rows = (count - base + SL - 1) / SL;  // rows holding a real slot
      if (rows > kRows / 2)
        filters<kRows, CL, SL>(acc, fb, ws, stride, rm, sl, cl);
      else if (rows > kRows / 4)
        filters<kRows / 2, CL, SL>(acc, fb, ws, stride, rm, sl, cl);
      else
        filters<kRows / 4, CL, SL>(acc, fb, ws, stride, rm, sl, cl);

      // each slot's logit, weight and sums
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j >= rows) break;  // the whole warp
        const int s = base + j * SL + sl;
        const bool ok = s < count;
        const int slot = ok ? ks[s] : 0;
        const size_t jn = ok ? js[s] : 0;
        const float2 kj = ok ? ldg2(k + jn * F + h * D + 2 * cl) : make_float2(0.0f, 0.0f);
        float logit = silu(acc[j][0]) * kj.x * qi.x;
        logit += silu(acc[j][1]) * kj.y * qi.y;
#pragma unroll
        for (int o = CL / 2; o > 0; o >>= 1) logit += __shfl_xor_sync(kFull, logit, o);
        if (ok) {
          const size_t e = (size_t)i * S + slot;
          const float a = silu(logit) * __ldg(cut + e);
          const float* vj = v + jn * 3 * F + h * 3 * D + 2 * cl;
          const float2 vs = ldg2(vj), v1 = ldg2(vj + D), v2 = ldg2(vj + 2 * D);
          const float vv[3][2] = {{vs.x, vs.y}, {v1.x, v1.y}, {v2.x, v2.y}};
          float u[3], vx[3][2];
#pragma unroll
          for (int x = 0; x < 3; ++x) {
            u[x] = __ldg(unit + 3 * e + x);
            const float2 t2 = ldg2(vec + (jn * 3 + x) * F + h * D + 2 * cl);
            vx[x][0] = t2.x;
            vx[x][1] = t2.y;
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float sc = silu(acc[j][2 + c]) * vv[0][c];
            const float m1 = silu(acc[j][4 + c]) * vv[1][c];
            const float m2 = silu(acc[j][6 + c]) * vv[2][c];
            ax[c] = fmaf(sc, a, ax[c]);
#pragma unroll
            for (int x = 0; x < 3; ++x) av[x][c] += fmaf(vx[x][c], m1, m2 * u[x]);
          }
        }
      }
      __syncwarp();  // the pass after next restages this buffer
    }

    // the slot lanes' sums, then the head's columns of Sx and Sv
#pragma unroll
    for (int o = CL; o < 32; o <<= 1) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        ax[c] += __shfl_xor_sync(kFull, ax[c], o);
#pragma unroll
        for (int x = 0; x < 3; ++x) av[x][c] += __shfl_xor_sync(kFull, av[x][c], o);
      }
    }
    if (sl == 0) {
      const size_t col = (size_t)h * D + 2 * cl;
      *reinterpret_cast<float2*>(sx + (size_t)i * F + col) = make_float2(ax[0], ax[1]);
#pragma unroll
      for (int x = 0; x < 3; ++x)
        *reinterpret_cast<float2*>(sv + ((size_t)i * 3 + x) * F + col) =
            make_float2(av[x][0], av[x][1]);
    }
    __syncwarp();  // the next atom relists ks and js
  }
}

template <int D>
cudaError_t launch_et(const float* q, const float* k, const float* v, const float* vec,
                      const long long* nlist, const float* basis, const float* cut,
                      const float* unit, const float* w_dk, const float* b_dk,
                      const float* w_dv, const float* b_dv, float* sx, float* sv, int n, int S,
                      int H, int R, int Rw, int bf16, cudaStream_t stream) {
  const size_t smem = shared_bytes(D, R, S);
  if (smem > (size_t)kMaxShared) return cudaErrorInvalidValue;
  const long long blocks = (long long)((n + kTileAtoms - 1) / kTileAtoms) * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(et_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  et_attention_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, vec, nlist, basis, cut, unit, w_dk, b_dk, w_dv, b_dv, sx, sv, n, S, H, R, Rw,
      bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The stage (above) over n atoms of S = K + 1 slots (1 to 129), H heads of
// D = 16, 32 or 64 columns, R radial functions (1 to 128) in basis rows of
// Rw floats (a multiple of 4, at least R + 1; column R the ones). q, k
// [n, H D], v [n, 3 H D], vec and sv [n, 3, H D], sx [n, H D], nlist int64
// [n, S], basis [n, S, Rw], cut [n, S], unit [n, S, 3], w_dk [R, H D],
// b_dk [H D], w_dv [R, 3 H D], b_dv [3 H D]: contiguous float32 but
// nlist, 16-byte aligned. bf16: the basis and W as bfloat16 operands.
int nmr_et_attention(const float* q, const float* k, const float* v, const float* vec,
                     const long long* nlist, const float* basis, const float* cut,
                     const float* unit, const float* w_dk, const float* b_dk, const float* w_dv,
                     const float* b_dv, float* sx, float* sv, int n, int S, int H, int D, int R,
                     int Rw, int bf16, void* stream) {
  if (n < 0 || S < 1 || S > kMaxSlots || H < 1 || R < 1 || R > kMaxR || Rw % 4 != 0 ||
      Rw < R + 1)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NMR_ET_CASE(DD)                                                                        \
  case DD:                                                                                     \
    return launch_et<DD>(q, k, v, vec, nlist, basis, cut, unit, w_dk, b_dk, w_dv, b_dv, sx, sv, \
                         n, S, H, R, Rw, bf16, st);
  switch (D) {
    NMR_ET_CASE(16)
    NMR_ET_CASE(32)
    NMR_ET_CASE(64)
  }
#undef NMR_ET_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
