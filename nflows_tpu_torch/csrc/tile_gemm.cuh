// Tile GEMMs shared by the whole-chain kernels (nsf_flow_kernel.cu, B2;
// nsf_train.cu, B3 and B4).
//
// A block holds a tile of ROWS samples with its activations feature-major
// in shared memory ([features][RS] fp32, RS >= ROWS the row stride) and
// streams weight matrices from global memory, where they stay resident in
// L2 across blocks.
// - tile_gemm: out = W in (+ bias), a register-tiled fp32 FMA loop in the
//   SIMT layout of CUTLASS, weight rows staged into shared memory 32 at a
//   time with cp.async, double-buffered. The same routine serves the input
//   cotangent g_in = W^T g_out, whose in-major matrix is the [out][in]
//   layout the weights are trained in.
// - tile_wgrad: gW[o][k] += sum_s g[o][s] in[k][s], the reduction over the
//   tile's samples, added into global memory with atomics because blocks
//   run in no order. It reads four samples a load, so RS is ROWS + 4 in the
//   training kernels: with rows 4 banks apart and a lane's rows interleaved
//   (o = lane/8 + 4 i, k = lane%8 + 8 j) a warp's loads hit distinct banks.
//
// tile_gemm's weight type WT is float (every kernel's fp32 instantiation)
// or __nv_bfloat16 (the bf16-weight serving paths of B2, B9 and B11, the
// JAX kernels' dtype=bfloat16). With bf16 weights the GEMM is the TPU
// kernels' _dot: both operands in bf16, the products summed in fp32. The
// weights are staged as they are stored, 8 to a 16-byte cp.async (so O is
// then a multiple of 8), and widened in registers, which is exact; each
// activation is rounded to bf16 (round to nearest even) before the
// product, after the relu where there is one, so the product of the two is
// exact in fp32 and only the order of the fp32 sums differs from the TPU
// kernel's. Where an operand is rounded: as it is loaded (8 conversions a
// lane to its 32 FMAs), which covers every operand however it was produced
// (the inputs, h and relu(h), which stay fp32 for the residual sum, the
// context); except a residual block's inner activation t, whose only
// reader is the block's second GEMM: the first GEMM's epilogue stores it
// rounded (ROUND = kRoundOut) and the second skips the load's rounding
// (kRoundedIn). On the H100 that is 8.5-9.9% faster than rounding t at
// the load too (tools/checkout_ab.py --dtype bfloat16, PERF.md). The
// bias, the sums and the rest of the epilogue stay fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace nflows {

constexpr int KC = 32;   // weight rows per staged chunk
constexpr int OC = 256;  // output columns per pass (32 lanes x 8)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename WT>
constexpr bool kBf16Weights = std::is_same<WT, __nv_bfloat16>::value;

// the four weights w[0..3] of a lane's columns, widened to fp32
__device__ __forceinline__ float4 load_weights4(const float* w) {
  return *reinterpret_cast<const float4*>(w);
}
__device__ __forceinline__ float4 load_weights4(const __nv_bfloat16* w) {
  const uint2 raw = *reinterpret_cast<const uint2*>(w);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// v rounded to bf16 (nearest even) and widened back: the value a bf16
// operand carries into the product
__device__ __forceinline__ float4 round_bf16(float4 v) {
  const float2 lo = __bfloat1622float2(__float22bfloat162_rn(make_float2(v.x, v.y)));
  const float2 hi = __bfloat1622float2(__float22bfloat162_rn(make_float2(v.z, v.w)));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// ROUND flags of tile_gemm, which act with bf16 weights only: kRoundOut
// stores the output rounded to bf16 (after the relu), for an output whose
// only reader is a later GEMM; kRoundedIn skips the rounding of the
// operand at the load, for such an input.
constexpr int kRoundOut = 1, kRoundedIn = 2;

template <int ROWS, int RS, bool RELU, typename WT, bool ROUND_IN = true>
__device__ __forceinline__ void chunk_fma(const float* in_c, const WT* ws, int kn,
                                          int s_off, int c_off, float (&acc)[8][4]) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    float4 a0 = *reinterpret_cast<const float4*>(in_c + k * RS + s_off);
    float4 a1 = *reinterpret_cast<const float4*>(in_c + k * RS + s_off + 16);
    if (RELU) {
      a0.x = fmaxf(a0.x, 0.0f); a0.y = fmaxf(a0.y, 0.0f);
      a0.z = fmaxf(a0.z, 0.0f); a0.w = fmaxf(a0.w, 0.0f);
      a1.x = fmaxf(a1.x, 0.0f); a1.y = fmaxf(a1.y, 0.0f);
      a1.z = fmaxf(a1.z, 0.0f); a1.w = fmaxf(a1.w, 0.0f);
    }
    if constexpr (kBf16Weights<WT> && ROUND_IN) {
      a0 = round_bf16(a0);
      a1 = round_bf16(a1);
    }
    const float4 b0 = load_weights4(ws + k * OC + c_off);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// the context GLU gate, 1 / (1 + exp(-v)) as the JAX kernel writes it
__device__ __forceinline__ float gate_sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// out[o][s] (= or +=) g(sum_k f(in[k][s]) W[k][o] + bias[o]) for the ROWS
// samples of the tile; f is relu when relu_in, g when relu_out. Activations are
// feature-major in shared memory ([features][RS]); W is [I][O] in global
// memory, O a multiple of 16 / sizeof(WT); bias may be null. With mask, the product is
// zeroed where mask[o][s] <= 0 before it is added or stored (the adjoint of
// a relu whose output or input mask holds); with stash, the result is also
// written to stash[o][s] in global memory. Warps tile the pass as (ROWS/32) x 8
// blocks of 32 samples x 32 columns; lanes as 4 x 8, each lane owning
// samples {4ls..4ls+3, 4ls+16..4ls+19} and columns {4lc..4lc+3} of its
// warp's block, so every float4 it loads serves 8 (activations) or 4
// (weights) lanes. A warp with no live columns in the pass skips its
// FMAs. With GATE (a residual block's context GLU), the product is
// multiplied by sigmoid(gate[o][s]) (gate feature-major in shared memory,
// [O][RS]) before it is added or stored, and the product before that
// multiplication is written to pre[o][s] in global memory where pre is not
// null. out may be mask or gate: each element is read before it is
// written, by the same thread. Ends with a barrier.
template <int ROWS, int RS = ROWS, bool GATE = false, typename WT = float, int ROUND = 0>
__device__ void tile_gemm(const float* in, int I, const WT* __restrict__ W,
                          const float* __restrict__ bias, int O, float* out, bool relu_in,
                          bool relu_out, bool accumulate, float* wst,
                          const float* mask = nullptr, float* stash = nullptr,
                          const float* gate = nullptr, float* pre = nullptr) {
  constexpr int NT = ROWS * 8;
  constexpr int SW = ROWS / 32;  // warps along the samples
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s_off = (warp % SW) * 32 + (lane & 3) * 4;
  const int c_off = (warp / SW) * 32 + (lane >> 2) * 4;
  const int nchunks = (I + KC - 1) / KC;
  for (int oc = 0; oc < O; oc += OC) {
    const int live = min(OC, O - oc);  // live columns in this pass
    const bool active = (warp / SW) * 32 < live;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    auto stage = [&](int c) {
      WT* dst = reinterpret_cast<WT*>(wst) + (c & 1) * KC * OC;
      const int k0 = c * KC;
      const int kn = min(KC, I - k0);
      constexpr int V = 16 / sizeof(WT);  // weights a 16-byte copy
      const int fv = live / V;
      for (int e = tid; e < kn * fv; e += NT) {
        const int r = e / fv, cv = (e % fv) * V;
        cp_async16(dst + r * OC + cv, W + (size_t)(k0 + r) * O + oc + cv, 16);
      }
      cp_async_commit();
    };

    stage(0);
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) stage(c + 1);
      else cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      if (active) {
        const WT* ws = reinterpret_cast<const WT*>(wst) + (c & 1) * KC * OC;
        const float* in_c = in + c * KC * RS;
        const int kn = min(KC, I - c * KC);
        constexpr bool kRoundIn = !(ROUND & kRoundedIn);
        if (relu_in) chunk_fma<ROWS, RS, true, WT, kRoundIn>(in_c, ws, kn, s_off, c_off, acc);
        else chunk_fma<ROWS, RS, false, WT, kRoundIn>(in_c, ws, kn, s_off, c_off, acc);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = oc + c_off + j;
      if (col < O) {
        const float bj = bias ? bias[col] : 0.0f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const size_t at = (size_t)col * RS + s_off + 16 * half;
          float4* dst = reinterpret_cast<float4*>(out + at);
          float4 v = make_float4(acc[4 * half + 0][j] + bj, acc[4 * half + 1][j] + bj,
                                 acc[4 * half + 2][j] + bj, acc[4 * half + 3][j] + bj);
          if (mask) {
            const float4 m = *reinterpret_cast<const float4*>(mask + at);
            v.x = m.x > 0.0f ? v.x : 0.0f; v.y = m.y > 0.0f ? v.y : 0.0f;
            v.z = m.z > 0.0f ? v.z : 0.0f; v.w = m.w > 0.0f ? v.w : 0.0f;
          }
          if constexpr (GATE) {
            if (pre) *reinterpret_cast<float4*>(pre + at) = v;
            const float4 g = *reinterpret_cast<const float4*>(gate + at);
            v.x *= gate_sigmoid(g.x); v.y *= gate_sigmoid(g.y);
            v.z *= gate_sigmoid(g.z); v.w *= gate_sigmoid(g.w);
          }
          if (accumulate) {
            const float4 o = *dst;
            v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
          }
          if (relu_out) {
            v.x = fmaxf(v.x, 0.0f); v.y = fmaxf(v.y, 0.0f);
            v.z = fmaxf(v.z, 0.0f); v.w = fmaxf(v.w, 0.0f);
          }
          if constexpr (kBf16Weights<WT> && (ROUND & kRoundOut)) v = round_bf16(v);
          *dst = v;
          if (stash) *reinterpret_cast<float4*>(stash + at) = v;
        }
      }
    }
  }
  __syncthreads();
}

// gW[o * ld + k] += sum_s g[o][s] * in[k][s] over the tile's ROWS samples,
// for o < O and k < I; g and in are [.][RS] in shared memory. A warp owns a
// block of 32 rows o x 64 rows k, a lane 8 x 8 of them, interleaved so that
// its float4 loads along s are free of bank conflicts. Rows beyond O or I
// are read clamped and not added. Samples beyond the batch must hold zero
// cotangents. No barrier inside: the caller separates it from writers.
template <int ROWS, int RS>
__device__ void tile_wgrad(const float* g, int O, const float* in, int I, float* gW, int ld) {
  constexpr int NW = ROWS / 4;  // warps of the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = lane >> 3, lk = lane & 7;
  const int nbk = (I + 63) / 64;
  const int nblocks = ((O + 31) / 32) * nbk;
  for (int wb = warp; wb < nblocks; wb += NW) {
    const int ob = (wb / nbk) * 32 + lo, kb = (wb % nbk) * 64 + lk;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int s = 0; s < ROWS; s += 4) {
      float4 gv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        gv[i] = *reinterpret_cast<const float4*>(g + min(ob + 4 * i, O - 1) * RS + s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(in + min(kb + 8 * j, I - 1) * RS + s);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i][j] += gv[i].x * a.x + gv[i].y * a.y + gv[i].z * a.z + gv[i].w * a.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = ob + 4 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = kb + 8 * j;
        if (o < O && k < I) atomicAdd(gW + (size_t)o * ld + k, acc[i][j]);
      }
    }
  }
}

// gb[o] += sum_s g[o][s] for o < O.
template <int ROWS, int RS>
__device__ void tile_bgrad(const float* g, int O, float* gb) {
  for (int o = threadIdx.x; o < O; o += ROWS * 8) {
    float sum = 0.0f;
    for (int s = 0; s < ROWS; ++s) sum += g[o * RS + s];
    atomicAdd(gb + o, sum);
  }
}

}  // namespace nflows
