// B2: the whole L-layer coupling chain in one launch, for either weight
// type (nsf_flow_kernel.cu: fp32; nsf_flow_kernel_bf16.cu: bf16).
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/nsf_flow_kernel.py:_kernel
// (fp32 or bf16 weights, with and without a per-sample context). For each layer:
// permutation and coupling split (static index lists), the ResidualNet
// conditioner (initial layer, plus wc0 ctx under a context; num_blocks x
// [relu, linear, relu, linear, times sigmoid(wcb ctx + bcb) under a
// context, residual add]; final layer),
// the coupling stage of the chain's family on the transformed features
// (coupling_stage.cuh: the rq, lrs, linear, quadratic or cubic spline with
// linear tails, or the affine or additive coupling), the merge, and the
// running logabsdet sum.
//
// Bound on the H100: operations. At the flagship (D 6, hidden 256, 10
// layers, 2 blocks, 8 bins) a sample costs about 5.6 MFLOP of fp32 GEMM on
// the CUDA cores; it reads and writes 28 bytes. The coupling stage is a few
// percent of the work in every family (the cubic inverse's 30 halvings
// included).
//
// Design. The TPU kernel keeps every layer's weights resident in VMEM; here
// the 11 MB of fp32 weights do not fit in shared memory (227 KB), so each
// block holds a tile of ROWS samples and streams each layer's weights from
// global memory, where they stay resident in the 50 MB L2 across blocks.
// - The activations h and t of the tile live in shared memory,
//   feature-major ([H][ROWS] fp32); they never touch device memory.
// - Each GEMM (tile_gemm.cuh, shared with the training kernels) is a
//   register-tiled fp32 FMA loop in the SIMT layout of CUTLASS: a warp
//   owns 32 samples x 32 columns, a lane 8 x 4 of them, so each
//   shared-memory float4 a lane loads is shared with other lanes.
//   One block fills an SM's shared memory, so its warps are all the SM
//   has: the small warp tile gives 8 warps per 32-sample tile and 16 per
//   64-sample tile, for latency hiding. Weight rows are
//   staged into shared memory 32 at a time with cp.async,
//   double-buffered, so the next chunk's copy overlaps this chunk's FMAs.
// - The conditioner's output P ([TM][ROWS], K-major as extracted) stays in
//   shared memory; one thread per (sample, transformed feature) runs the
//   family's stage on it with stride T ROWS. The family is a template
//   parameter, picked on the host: each instantiation holds one stage's
//   code (a switch over all seven in one kernel cost the rq chain some 5%
//   on the card, measured with tools/checkout_ab.py). Weights that do not
//   carry the softmax 1/sqrt(H) (the trainers') get it on the first
//   min(2 K T, TM) rows of P first (wh_scale): the widths and heights of
//   rq, lrs and cubic, every row of quadratic, whose 2K - 1 parameters a
//   feature are fewer than 2K.
// - Permutation, split and merge use the per-layer index lists of
//   NSFLayerIndices, read from a small int array.
// - A context [C][ROWS] stays resident in shared memory for the whole
//   chain. Its projections are tile_gemms of the same routine, C deep: the
//   initial layer's accumulates onto the tile's h, and each block's gate
//   goes to a buffer [H][ROWS] that the second linear's epilogue multiplies
//   in as sigmoid(gate) before the residual add (the pattern of
//   mademog.cuh). The context path is a template flag, so the
//   unconditional kernels hold no code of it.
// - The weight type WT is a template parameter of every GEMM
//   (tile_gemm.cuh): the matrices w0, wb, wf, wc0 and wcb are WT, the
//   biases and everything else fp32. With bf16 weights each GEMM rounds
//   its activation operand to bf16, as the TPU kernel's _dot casts it: the
//   identity features, relu(h), h and the context where they are loaded,
//   t where the block's first GEMM stores it (tile_gemm.cuh).
// - The ragged last tile computes on zero rows and skips their stores.
// ROWS is 64 (512 threads) for large batches and 32 (256 threads) when
// 64-row tiles would leave SMs idle or, with a context, do not fit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "coupling_stage.cuh"
#include "tile_gemm.cuh"

namespace {

using nflows::KC;
using nflows::OC;
using nflows::tile_gemm;

template <typename WT>
struct FlowArgs {
  const float* x;
  float* y;
  float* lad;
  int64_t n;
  int D, L, H, Tid, I4, T, TMp, TB, nb2;
  int scaled_rows;  // rows of P that wh_scale multiplies: min(2 K T, TM)
  const WT* w0;  // [L][I4][H]
  const float* b0;  // [L][H]
  const WT* wb;  // [L][nb2][H][H]  (in-major)
  const float* bb;  // [L][nb2][H]
  const WT* wf;  // [L][H][TMp]
  const float* bf;  // [L][TMp]
  const int* idx;   // [L][2 Tid + 2 T + 2 D]
  const float* ctx;  // [n][C], null when C = 0
  int C;             // context features (0: unconditional)
  const WT* wc0;  // [L][C][H]          (in-major)
  const WT* wcb;  // [L][nb2 / 2][C][H] (in-major)
  const float* bcb;  // [L][nb2 / 2][H]
  int inverse;
  float wh_scale;   // multiplies the first scaled_rows rows of P (1: already folded)
  nflows::StageConfig cfg;
};

template <int ROWS, int FAMILY, bool CTX, typename WT>
__global__ void __launch_bounds__(ROWS * 8) nsf_flow_kernel(FlowArgs<WT> a) {
  constexpr int NT = ROWS * 8;
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, H = a.H, Tid = a.Tid, I4 = a.I4, T = a.T, TMp = a.TMp;
  float* wst = smem;                    // [2][KC][OC]
  float* hbuf = wst + 2 * KC * OC;      // [H][ROWS]
  float* tbuf = hbuf + H * ROWS;        // [TB][ROWS]: identity split, t, then P
  float* xs = tbuf + a.TB * ROWS;       // [ROWS][D] state
  float* xn = xs + ROWS * D;            // [ROWS][D] next state
  float* ybuf = xn + ROWS * D;          // [ROWS][T] spline outputs
  float* lbuf = ybuf + ROWS * T;        // [ROWS][T] spline logabsdets
  float* ladacc = lbuf + ROWS * T;      // [ROWS]
  float* gbuf = ladacc + ROWS;          // [H][ROWS] context gate (CTX)
  float* cs = gbuf + H * ROWS;          // [C][ROWS] context (CTX)

  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * ROWS;
  const int rows = (int)min((int64_t)ROWS, a.n - base);

  for (int e = tid; e < ROWS * D; e += NT) {
    const int s = e / D;
    xs[e] = s < rows ? a.x[(base + s) * D + (e % D)] : 0.0f;
  }
  for (int s = tid; s < ROWS; s += NT) ladacc[s] = 0.0f;
  if constexpr (CTX) {
    for (int e = tid; e < a.C * ROWS; e += NT) {
      const int c = e / ROWS, s = e % ROWS;
      cs[e] = s < rows ? a.ctx[(base + s) * a.C + c] : 0.0f;
    }
  }
  __syncthreads();

  const int idx_stride = 2 * Tid + 2 * T + 2 * D;
  for (int step = 0; step < a.L; ++step) {
    const int l = a.inverse ? a.L - 1 - step : step;
    const int* li = a.idx + l * idx_stride;
    // forward: id_rows, tr_rows, merge_fwd; inverse: id_idx, tr_idx, merge_inv
    const int* id_src = a.inverse ? li + Tid + T + D : li;
    const int* tr_src = a.inverse ? li + 2 * Tid + T + D : li + Tid;
    const int* merge = a.inverse ? li + 2 * Tid + 2 * T + D : li + Tid + T;

    for (int e = tid; e < I4 * ROWS; e += NT) {
      const int i = e / ROWS, s = e % ROWS;
      tbuf[e] = i < Tid ? xs[s * D + id_src[i]] : 0.0f;
    }
    __syncthreads();

    tile_gemm<ROWS>(tbuf, I4, a.w0 + (size_t)l * I4 * H, a.b0 + (size_t)l * H, H, hbuf, false,
                    false, false, wst);
    if constexpr (CTX) {
      // h += Wc0 ctx
      tile_gemm<ROWS>(cs, a.C, a.wc0 + (size_t)l * a.C * H, nullptr, H, hbuf, false, false, true,
                      wst);
    }
    for (int j = 0; j < a.nb2; j += 2) {
      // h += W1 relu(W0 relu(h) + b0) + b1; t is stored already relu'd
      const size_t m = (size_t)l * a.nb2 + j;
      tile_gemm<ROWS, ROWS, false, WT, nflows::kRoundOut>(hbuf, H, a.wb + m * H * H, a.bb + m * H,
                                                          H, tbuf, true, true, false, wst);
      if constexpr (CTX) {
        // h += (W1 t + b1) sigmoid(Wcb ctx + bcb)
        const size_t g = (size_t)l * (a.nb2 / 2) + j / 2;
        tile_gemm<ROWS>(cs, a.C, a.wcb + g * a.C * H, a.bcb + g * H, H, gbuf, false, false, false,
                        wst);
        tile_gemm<ROWS, ROWS, true, WT, nflows::kRoundedIn>(tbuf, H, a.wb + (m + 1) * H * H,
                                                            a.bb + (m + 1) * H, H, hbuf,
                                    false, false, true, wst, nullptr, nullptr, gbuf);
      } else {
        tile_gemm<ROWS, ROWS, false, WT, nflows::kRoundedIn>(tbuf, H, a.wb + (m + 1) * H * H,
                                                             a.bb + (m + 1) * H, H, hbuf, false,
                                                             false, true, wst);
      }
    }
    tile_gemm<ROWS>(hbuf, H, a.wf + (size_t)l * H * TMp, a.bf + (size_t)l * TMp, TMp, tbuf,
                    false, false, false, wst);

    // P = tbuf is [TM][ROWS], K-major rows: parameter j of feature t at row j*T + t;
    // weights that do not carry the softmax 1/sqrt(H) get it here
    if (a.wh_scale != 1.0f) {
      for (int e = tid; e < a.scaled_rows * ROWS; e += NT) tbuf[e] *= a.wh_scale;
      __syncthreads();
    }
    for (int e = tid; e < T * ROWS; e += NT) {
      const int t = e / ROWS, s = e % ROWS;
      nflows::coupling_stage<FAMILY>(xs[s * D + tr_src[t]], tbuf + t * ROWS + s, T * ROWS,
                                     a.inverse != 0, a.cfg, ybuf + s * T + t,
                                     lbuf + s * T + t);
    }
    __syncthreads();

    // x_next[r] = concat(identity, spline outputs)[merge[r]]
    for (int e = tid; e < ROWS * D; e += NT) {
      const int s = e / D, m = merge[e % D];
      xn[e] = m < Tid ? xs[s * D + id_src[m]] : ybuf[s * T + (m - Tid)];
    }
    for (int s = tid; s < ROWS; s += NT) {
      float sum = 0.0f;
      for (int t = 0; t < T; ++t) sum += lbuf[s * T + t];
      ladacc[s] += sum;
    }
    __syncthreads();
    float* tmp = xs; xs = xn; xn = tmp;
  }

  for (int e = tid; e < rows * D; e += NT) a.y[base * D + e] = xs[e];
  for (int s = tid; s < rows; s += NT) a.lad[base + s] = ladacc[s];
}

template <typename WT>
size_t smem_bytes(int rows, const FlowArgs<WT>& a) {
  return sizeof(float) * ((size_t)2 * KC * OC + (size_t)rows * (a.H + a.TB + 2 * a.D + 2 * a.T + 1 +
                                                                (a.C ? a.C + a.H : 0)));
}

template <int ROWS, int FAMILY, bool CTX, typename WT>
int launch(const FlowArgs<WT>& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(ROWS, a);
  cudaError_t err = cudaFuncSetAttribute(nsf_flow_kernel<ROWS, FAMILY, CTX, WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (a.n + ROWS - 1) / ROWS;
  nsf_flow_kernel<ROWS, FAMILY, CTX, WT><<<(unsigned)blocks, ROWS * 8, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// one instantiation of the kernel a family (see coupling_stage.cuh), with
// and without the context path
template <int ROWS, bool CTX, typename WT>
int launch_family(const FlowArgs<WT>& a, cudaStream_t stream) {
  switch (a.cfg.family) {
    case nflows::kRQ: return launch<ROWS, nflows::kRQ, CTX, WT>(a, stream);
    case nflows::kLRS: return launch<ROWS, nflows::kLRS, CTX, WT>(a, stream);
    case nflows::kLinear: return launch<ROWS, nflows::kLinear, CTX, WT>(a, stream);
    case nflows::kQuadratic: return launch<ROWS, nflows::kQuadratic, CTX, WT>(a, stream);
    case nflows::kCubic: return launch<ROWS, nflows::kCubic, CTX, WT>(a, stream);
    default: return launch<ROWS, nflows::kAffine, CTX, WT>(a, stream);  // kAffine, kAdditive
  }
}

template <int ROWS, typename WT>
int launch_context(const FlowArgs<WT>& a, cudaStream_t stream) {
  return a.C ? launch_family<ROWS, true>(a, stream) : launch_family<ROWS, false>(a, stream);
}

// family: a CouplingFamily (coupling_stage.cuh), scale_act a ScaleActivation
// (affine only); num_bins is 0 for the affine and additive couplings, and a
// family ignores the floats it has no use for. ctx [n][C] and the context
// weights (in-major, as nsf_flow_kernel.py:pack_weights lays them) with
// C > 0, or null pointers and C = 0. rows_per_block: 32 or 64.
// WT is the matrices' type (float or __nv_bfloat16); the biases are fp32.
// Returns a cudaError_t value (0 on success).
template <typename WT>
int nsf_flow_entry(const float* x, float* y, float* lad, int64_t n, int D, int L,
                   int H, int Tid, int I4, int T, int TM, int TMp, int nb2,
                   const WT* w0, const float* b0, const WT* wb,
                   const float* bb, const WT* wf, const float* bf,
                   const int* idx, int inverse, int family, int scale_act,
                   int num_bins, float wh_scale, float tail_bound,
                   float min_bin_width, float min_bin_height, float min_derivative,
                   float min_lambda, float edge_derivative, float log_inv_bins,
                   const float* ctx, int C, const WT* wc0, const WT* wcb,
                   const float* bcb, int rows_per_block, void* stream) {
  if (n == 0) return 0;
  constexpr int kOut = 16 / sizeof(WT);  // weights a 16-byte copy stages
  if (H % kOut || I4 % 4 || TMp % kOut || nb2 % 2 || TM > TMp || family < nflows::kRQ ||
      family > nflows::kAdditive || C < 0 || (C && !(ctx && wc0 && wcb && bcb)))
    return (int)cudaErrorInvalidValue;
  FlowArgs<WT> a;
  a.x = x; a.y = y; a.lad = lad; a.n = n;
  a.D = D; a.L = L; a.H = H; a.Tid = Tid; a.I4 = I4; a.T = T; a.TMp = TMp;
  a.TB = H > TMp ? H : TMp;
  if (I4 > a.TB) a.TB = I4;
  a.nb2 = nb2;
  a.scaled_rows = 2 * num_bins * T < TM ? 2 * num_bins * T : TM;
  a.w0 = w0; a.b0 = b0; a.wb = wb; a.bb = bb; a.wf = wf; a.bf = bf; a.idx = idx;
  a.ctx = ctx; a.C = C; a.wc0 = wc0; a.wcb = wcb; a.bcb = bcb;
  a.inverse = inverse;
  a.wh_scale = wh_scale;
  a.cfg = nflows::make_stage_config(family, scale_act, num_bins, tail_bound, min_bin_width,
                                    min_bin_height, min_derivative, min_lambda,
                                    edge_derivative, log_inv_bins);
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_block == 32) return launch_context<32, WT>(a, s);
  if (rows_per_block == 64) return launch_context<64, WT>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
