// B9: a whole L-layer autoregressive flow (MAF, NSF-AR, IAF) in one launch.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/maf_flow_kernel.py:_kernel
// (affine and rq transformers, wrapped layers, fp32, no context). For each
// layer: the permutation (a static row gather, before the AR op going
// forward, after it coming back), the residual MADE on mask-folded weights
// (initial layer, num_blocks x [relu, linear, relu, linear, residual add],
// final layer), the transformer (affine: softplus scale + 1e-3 and shift;
// rq: the linear-tail RQ spline of rq_spline.cuh with boundary derivatives
// of exactly 1), and the running logabsdet sum. Going forward an unwrapped
// layer is one MADE pass. Coming back it is the D-step fixed point
// xi = 0; D times xi = elementwise_inverse(z, MADE(xi)); then one more MADE
// pass for the logabsdet: D + 1 passes. A wrapped layer swaps the two.
//
// Bound on the H100: operations. A MADE pass of a layer is
// 2 (D H + 2 nb H^2 + H P) fp32 FLOP a sample on the CUDA cores (the dense
// count: about half of a masked matrix is structural zeros, which the
// kernel multiplies like any other entry), against 4 (2 D + 1) bytes a
// sample. At features 10, hidden 256, 5 layers, 2 blocks that is 2.7 MFLOP a
// sample forward and 11 times that on the inverse.
//
// Design: B2's (nsf_flow_kernel.cu), with a loop around the conditioner.
// - A block holds a tile of ROWS samples. The activations h and t live in
//   shared memory, feature-major ([H][ROWS] fp32), and so do the state, the
//   operand z of the fixed point and its iterate ([D4][ROWS] each, the pad
//   rows zero): x is both the MADE's input and the transformer's operand,
//   so it has to survive the MADE.
// - Each GEMM is tile_gemm (tile_gemm.cuh): weights streamed from global
//   memory, where the flow's 5.4 MB stay resident in L2, in 32-row chunks
//   with double-buffered cp.async. The fixed point re-streams a layer's
//   weights D + 1 times for every tile; larger tiles halve that traffic,
//   so ROWS is 64 where that still gives every SM a tile.
// - The conditioner's output P ([P][ROWS], param-major: parameter j of
//   feature t at row j*D + t) stays in shared memory; one thread per
//   (sample, feature) runs the transformer on it with stride D. Weights
//   that do not carry the softmax 1/sqrt(H) (the trainer's) get it on the
//   width and height rows of P first (wh_scale).
// - The ragged last tile computes on zero rows and skips their stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rq_spline.cuh"
#include "tile_gemm.cuh"

namespace {

using nflows::KC;
using nflows::OC;
using nflows::tile_gemm;

constexpr float kAffineEpsilon = 1e-3f;

struct MafArgs {
  const float* x;
  float* y;
  float* lad;
  int64_t n;
  int D, L, H, D4, P, Pp, TB, nb2;
  const float* wi;  // [L][D4][H]  (in-major, mask folded)
  const float* bi;  // [L][H]
  const float* wb;  // [L][nb2][H][H]  (in-major)
  const float* bb;  // [L][nb2][H]
  const float* wf;  // [L][H][Pp]
  const float* bf;  // [L][Pp]
  const int* idx;   // [L][2 D + 1]: perm_rows, inv_perm_rows, wrapped
  int inverse;
  int rq;           // 0: affine transformer, 1: RQ spline
  float wh_scale;   // multiplies the width and height rows of P (1: already folded)
  nflows::RQConfig cfg;
};

// P = MADE(xin) into tbuf; xin is [D4][ROWS] with zero pad rows.
template <int ROWS>
__device__ __forceinline__ void made_pass(const MafArgs& a, int l, const float* xin,
                                          float* hbuf, float* tbuf, float* wst) {
  constexpr int NT = ROWS * 8;
  const int H = a.H;
  tile_gemm<ROWS>(xin, a.D4, a.wi + (size_t)l * a.D4 * H, a.bi + (size_t)l * H, H, hbuf, false,
                  false, false, wst);
  for (int j = 0; j < a.nb2; j += 2) {
    // h += W1 relu(W0 relu(h) + b0) + b1; t is stored already relu'd
    const size_t m = (size_t)l * a.nb2 + j;
    tile_gemm<ROWS>(hbuf, H, a.wb + m * H * H, a.bb + m * H, H, tbuf, true, true, false, wst);
    tile_gemm<ROWS>(tbuf, H, a.wb + (m + 1) * H * H, a.bb + (m + 1) * H, H, hbuf, false, false,
                    true, wst);
  }
  tile_gemm<ROWS>(hbuf, H, a.wf + (size_t)l * H * a.Pp, a.bf + (size_t)l * a.Pp, a.Pp, tbuf,
                  false, false, false, wst);
  if (a.rq && a.wh_scale != 1.0f) {
    const int scaled = 2 * a.cfg.num_bins * a.D * ROWS;
    for (int e = threadIdx.x; e < scaled; e += NT) tbuf[e] *= a.wh_scale;
    __syncthreads();
  }
}

// out[t][s], lad[t][s] = transformer(z[t][s]; P[., t, s]) for the tile; out
// or lad may be null. Ends with a barrier.
template <int ROWS>
__device__ __forceinline__ void apply_transformer(const MafArgs& a, const float* z, const float* P,
                                            bool inv, float* out, float* lad) {
  constexpr int NT = ROWS * 8;
  const int D = a.D;
  for (int e = threadIdx.x; e < D * ROWS; e += NT) {
    float o, l;
    if (a.rq) {
      const int KD = a.cfg.num_bins * D * ROWS;
      nflows::rq_spline_eval(z[e], P + e, P + KD + e, P + 2 * KD + e, D * ROWS, inv, a.cfg, &o,
                             &l);
    } else {
      const float scale = nflows::softplus(P[e]) + kAffineEpsilon;
      const float shift = P[D * ROWS + e];
      const float log_s = logf(scale);
      o = inv ? (z[e] - shift) / scale : scale * z[e] + shift;
      l = inv ? -log_s : log_s;
    }
    if (out) out[e] = o;
    if (lad) lad[e] = l;
  }
  __syncthreads();
}

template <int ROWS>
__global__ void __launch_bounds__(ROWS * 8) maf_flow_kernel(MafArgs a) {
  constexpr int NT = ROWS * 8;
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, H = a.H, D4 = a.D4;
  float* wst = smem;                    // [2][KC][OC]
  float* hbuf = wst + 2 * KC * OC;      // [H][ROWS]
  float* tbuf = hbuf + H * ROWS;        // [TB][ROWS]: t, then P
  float* xs = tbuf + a.TB * ROWS;       // [D4][ROWS] state
  float* zb = xs + D4 * ROWS;           // [D4][ROWS] the AR op's input
  float* xi = zb + D4 * ROWS;           // [D4][ROWS] the AR op's output / fixed-point iterate
  float* lbuf = xi + D4 * ROWS;         // [D][ROWS] elementwise logabsdets
  float* ladacc = lbuf + D * ROWS;      // [ROWS]

  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * ROWS;
  const int rows = (int)min((int64_t)ROWS, a.n - base);

  for (int e = tid; e < D4 * ROWS; e += NT) {
    const int i = e / ROWS, s = e % ROWS;
    xs[e] = (i < D && s < rows) ? a.x[(base + s) * D + i] : 0.0f;
    zb[e] = 0.0f;
    xi[e] = 0.0f;
  }
  for (int s = tid; s < ROWS; s += NT) ladacc[s] = 0.0f;
  __syncthreads();

  for (int step = 0; step < a.L; ++step) {
    const int l = a.inverse ? a.L - 1 - step : step;
    const int* perm = a.idx + l * (2 * D + 1);
    const int* inv_perm = perm + D;
    const bool wrapped = perm[2 * D] != 0;

    // going forward the permutation comes before the AR op
    for (int e = tid; e < D * ROWS; e += NT) {
      const int i = e / ROWS, s = e % ROWS;
      zb[e] = a.inverse ? xs[e] : xs[perm[i] * ROWS + s];
    }
    __syncthreads();

    // one MADE pass and the elementwise forward; or the D-step fixed point
    // from zeros, then one more pass for the logabsdet
    const bool fixed_point = (a.inverse != 0) != wrapped;
    if (fixed_point) {
      for (int e = tid; e < D * ROWS; e += NT) xi[e] = 0.0f;
      __syncthreads();
    }
    const int passes = fixed_point ? D + 1 : 1;
    for (int it = 0; it < passes; ++it) {
      made_pass<ROWS>(a, l, fixed_point ? xi : zb, hbuf, tbuf, wst);
      const bool last = it == passes - 1;
      apply_transformer<ROWS>(a, zb, tbuf, fixed_point, (fixed_point && last) ? nullptr : xi,
                              last ? lbuf : nullptr);
    }

    // coming back the inverse permutation comes after the AR op
    for (int e = tid; e < D * ROWS; e += NT) {
      const int i = e / ROWS, s = e % ROWS;
      xs[e] = a.inverse ? xi[inv_perm[i] * ROWS + s] : xi[e];
    }
    for (int s = tid; s < ROWS; s += NT) {
      float sum = 0.0f;
      for (int t = 0; t < D; ++t) sum += lbuf[t * ROWS + s];
      ladacc[s] += sum;
    }
    __syncthreads();
  }

  for (int e = tid; e < rows * D; e += NT) a.y[base * D + e] = xs[(e % D) * ROWS + e / D];
  for (int s = tid; s < rows; s += NT) a.lad[base + s] = ladacc[s];
}

size_t smem_bytes(int rows, const MafArgs& a) {
  return sizeof(float) *
         ((size_t)2 * KC * OC + (size_t)rows * (a.H + a.TB + 3 * a.D4 + a.D + 1));
}

template <int ROWS>
int launch(const MafArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(ROWS, a);
  cudaError_t err = cudaFuncSetAttribute(maf_flow_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (a.n + ROWS - 1) / ROWS;
  maf_flow_kernel<ROWS><<<(unsigned)blocks, ROWS * 8, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// transformer: 0 affine (P = 2 D), 1 rq (P = (3 K - 1) D). rows_per_block: 32
// or 64. Returns a cudaError_t value (0 on success).
extern "C" int maf_flow_launch(const float* x, float* y, float* lad, int64_t n, int D, int L,
                               int H, int D4, int P, int Pp, int nb2, const float* wi,
                               const float* bi, const float* wb, const float* bb,
                               const float* wf, const float* bf, const int* idx, int inverse,
                               int transformer, float wh_scale, int num_bins, float tail_bound,
                               float min_bin_width, float min_bin_height, float min_derivative,
                               int rows_per_block, void* stream) {
  if (n == 0) return 0;
  if (H % 4 || D4 % 4 || Pp % 4 || nb2 % 2 || D4 < D || Pp < P) return (int)cudaErrorInvalidValue;
  if (transformer != 0 && transformer != 1) return (int)cudaErrorInvalidValue;
  if (P != (transformer ? (3 * num_bins - 1) * D : 2 * D)) return (int)cudaErrorInvalidValue;
  MafArgs a;
  a.x = x; a.y = y; a.lad = lad; a.n = n;
  a.D = D; a.L = L; a.H = H; a.D4 = D4; a.P = P; a.Pp = Pp;
  a.TB = H > Pp ? H : Pp;
  if (D4 > a.TB) a.TB = D4;
  a.nb2 = nb2;
  a.wi = wi; a.bi = bi; a.wb = wb; a.bb = bb; a.wf = wf; a.bf = bf; a.idx = idx;
  a.inverse = inverse;
  a.rq = transformer;
  a.wh_scale = wh_scale;
  a.cfg = nflows::RQConfig{num_bins, tail_bound, min_bin_width, min_bin_height, min_derivative,
                           1.0f};
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_block == 32) return launch<32>(a, s);
  if (rows_per_block == 64) return launch<64>(a, s);
  return (int)cudaErrorInvalidValue;
}
