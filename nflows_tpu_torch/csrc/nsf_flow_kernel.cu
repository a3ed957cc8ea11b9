// B2: the whole L-layer RQ-NSF coupling chain in one launch.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/nsf_flow_kernel.py:_kernel
// (rq family, fp32, no context). For each layer: permutation and coupling
// split (static index lists), the ResidualNet conditioner (initial layer,
// num_blocks x [relu, linear, relu, linear, residual add], final layer),
// the RQ spline of the transformed features with boundary derivatives of
// exactly 1, the merge, and the running logabsdet sum.
//
// Bound on the H100: operations. At the flagship (D 6, hidden 256, 10
// layers, 2 blocks, 8 bins) a sample costs about 5.6 MFLOP of fp32 GEMM on
// the CUDA cores; it reads and writes 28 bytes. The spline stage is a few
// percent of the work.
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
//   shared rq_spline_eval (rq_spline.cuh) on it with stride T. Weights that
//   do not carry the softmax 1/sqrt(H) (the trainers') get it on the width
//   and height rows of P first (wh_scale).
// - Permutation, split and merge use the per-layer index lists of
//   NSFLayerIndices, read from a small int array.
// - The ragged last tile computes on zero rows and skips their stores.
// ROWS is 64 (512 threads) for large batches and 32 (256 threads) when
// 64-row tiles would leave SMs idle.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rq_spline.cuh"
#include "tile_gemm.cuh"

namespace {

using nflows::KC;
using nflows::OC;
using nflows::tile_gemm;

struct FlowArgs {
  const float* x;
  float* y;
  float* lad;
  int64_t n;
  int D, L, H, Tid, I4, T, TMp, TB, nb2;
  const float* w0;  // [L][I4][H]
  const float* b0;  // [L][H]
  const float* wb;  // [L][nb2][H][H]  (in-major)
  const float* bb;  // [L][nb2][H]
  const float* wf;  // [L][H][TMp]
  const float* bf;  // [L][TMp]
  const int* idx;   // [L][2 Tid + 2 T + 2 D]
  int inverse;
  float wh_scale;   // multiplies the width and height rows of P (1: already folded)
  nflows::RQConfig cfg;
};

template <int ROWS>
__global__ void __launch_bounds__(ROWS * 8) nsf_flow_kernel(FlowArgs a) {
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

  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * ROWS;
  const int rows = (int)min((int64_t)ROWS, a.n - base);

  for (int e = tid; e < ROWS * D; e += NT) {
    const int s = e / D;
    xs[e] = s < rows ? a.x[(base + s) * D + (e % D)] : 0.0f;
  }
  for (int s = tid; s < ROWS; s += NT) ladacc[s] = 0.0f;
  __syncthreads();

  const int K = a.cfg.num_bins;
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
    for (int j = 0; j < a.nb2; j += 2) {
      // h += W1 relu(W0 relu(h) + b0) + b1; t is stored already relu'd
      const size_t m = (size_t)l * a.nb2 + j;
      tile_gemm<ROWS>(hbuf, H, a.wb + m * H * H, a.bb + m * H, H, tbuf, true, true, false, wst);
      tile_gemm<ROWS>(tbuf, H, a.wb + (m + 1) * H * H, a.bb + (m + 1) * H, H, hbuf, false,
                      false, true, wst);
    }
    tile_gemm<ROWS>(hbuf, H, a.wf + (size_t)l * H * TMp, a.bf + (size_t)l * TMp, TMp, tbuf,
                    false, false, false, wst);

    // P = tbuf is [TM][ROWS], K-major rows: parameter j of feature t at row j*T + t;
    // weights that do not carry the softmax 1/sqrt(H) get it here
    if (a.wh_scale != 1.0f) {
      for (int e = tid; e < 2 * K * T * ROWS; e += NT) tbuf[e] *= a.wh_scale;
      __syncthreads();
    }
    for (int e = tid; e < T * ROWS; e += NT) {
      const int t = e / ROWS, s = e % ROWS;
      const float* P = tbuf + t * ROWS + s;
      nflows::rq_spline_eval(xs[s * D + tr_src[t]], P, P + K * T * ROWS, P + 2 * K * T * ROWS,
                             T * ROWS, a.inverse != 0, a.cfg, ybuf + s * T + t,
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

size_t smem_bytes(int rows, const FlowArgs& a) {
  return sizeof(float) * ((size_t)2 * KC * OC + (size_t)rows * (a.H + a.TB + 2 * a.D + 2 * a.T + 1));
}

template <int ROWS>
int launch(const FlowArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(ROWS, a);
  cudaError_t err = cudaFuncSetAttribute(nsf_flow_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (a.n + ROWS - 1) / ROWS;
  nsf_flow_kernel<ROWS><<<(unsigned)blocks, ROWS * 8, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// rows_per_block: 32 or 64. Returns a cudaError_t value (0 on success).
extern "C" int nsf_flow_launch(const float* x, float* y, float* lad, int64_t n, int D, int L,
                               int H, int Tid, int I4, int T, int TMp, int nb2,
                               const float* w0, const float* b0, const float* wb,
                               const float* bb, const float* wf, const float* bf,
                               const int* idx, int inverse, float wh_scale, int num_bins,
                               float tail_bound,
                               float min_bin_width, float min_bin_height,
                               float min_derivative, int rows_per_block, void* stream) {
  if (n == 0) return 0;
  if (H % 4 || I4 % 4 || TMp % 4 || nb2 % 2) return (int)cudaErrorInvalidValue;
  FlowArgs a;
  a.x = x; a.y = y; a.lad = lad; a.n = n;
  a.D = D; a.L = L; a.H = H; a.Tid = Tid; a.I4 = I4; a.T = T; a.TMp = TMp;
  a.TB = H > TMp ? H : TMp;
  if (I4 > a.TB) a.TB = I4;
  a.nb2 = nb2;
  a.w0 = w0; a.b0 = b0; a.wb = wb; a.bb = bb; a.wf = wf; a.bf = bf; a.idx = idx;
  a.inverse = inverse;
  a.wh_scale = wh_scale;
  a.cfg = nflows::RQConfig{num_bins, tail_bound, min_bin_width, min_bin_height, min_derivative,
                           1.0f};
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_block == 32) return launch<32>(a, s);
  if (rows_per_block == 64) return launch<64>(a, s);
  return (int)cudaErrorInvalidValue;
}
