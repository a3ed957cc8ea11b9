// B11: the log-density of a MixtureOfGaussiansMADE in one launch.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/mademog_fused.py:_kernel
// (fp32, with and without context). Per sample: the masked residual MADE
// (initial layer, plus relu(Wci c + bci) under a context; num_blocks x
// [relu, linear, + (Wcb_j c + bcb_j), relu, linear, residual add]; final
// layer to 3 K D parameters in the K-major layout), then the mixture head:
// per feature, a max-subtracted log-softmax over the K logits, stds
// softplus(u) + eps, the K component log-densities and their
// max-subtracted logsumexp; the sum over the features is lp.
//
// Bound on the H100: operations. The pass is 2 (D H + C H (nb + 1)
// + 2 nb H^2 + 3 K D H) fp32 FLOP a sample on the CUDA cores (the dense
// count; the masks leave about half of the MADE's weights), against
// 4 (D + C + 1) bytes of a sample's inputs and output and 1.4 MB of weights
// at features 10, hidden 256, 2 blocks, 10 components, context 10.
//
// Design: B9's MADE pass (maf_flow_kernel.cu) without the chain.
// - A block holds a tile of 32 samples, feature-major in shared memory: the
//   inputs x [D][32] and the context [C][32], the hidden state h [H][32],
//   and t, then the parameters P [max(H, Pp)][32] (300 x 32 fp32, 38.4 KB,
//   at full width).
// - Every GEMM is tile_gemm (tile_gemm.cuh): weights streamed from global
//   memory, where they stay resident in L2, in 32-row chunks with
//   double-buffered cp.async. The context projections are GEMMs of the same
//   routine, each written where its sum starts, so the MADE GEMM after it
//   accumulates onto it (mademog.cuh).
// - The head is one thread per (feature, sample) over P; the per-sample
//   sum over the features is taken in order in shared memory.
// - The ragged last tile computes on zero rows and skips their stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mademog.cuh"
#include "tile_gemm.cuh"

namespace {

using nflows::KC;
using nflows::MogDims;
using nflows::MogFeature;
using nflows::MogWeights;
using nflows::OC;

constexpr int ROWS = 32;
constexpr int NT = ROWS * 8;

struct MogArgs {
  const float* x;    // [n][D]
  const float* ctx;  // [n][C], null when C = 0
  float* lp;         // [n]
  int64_t n;
  int TB;            // rows of the t / P buffer: max(H, Pp)
  MogDims d;
  MogWeights w;
};

__global__ void __launch_bounds__(NT) mademog_log_prob_kernel(MogArgs a) {
  extern __shared__ __align__(16) float smem[];
  const MogDims& d = a.d;
  const int D = d.D, C = d.C;
  float* wst = smem;                   // [2][KC][OC]
  float* hb = wst + 2 * KC * OC;       // [H][ROWS]
  float* tb = hb + d.H * ROWS;         // [TB][ROWS]: t, then P
  float* xs = tb + a.TB * ROWS;        // [D][ROWS]
  float* lpd = xs + D * ROWS;          // [D][ROWS] per-feature log-densities
  float* cs = lpd + D * ROWS;          // [C][ROWS]

  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * ROWS;
  const int rows = (int)min((int64_t)ROWS, a.n - base);

  for (int e = tid; e < D * ROWS; e += NT) {
    const int i = e / ROWS, s = e % ROWS;
    xs[e] = s < rows ? a.x[(base + s) * D + i] : 0.0f;
  }
  for (int e = tid; e < C * ROWS; e += NT) {
    const int i = e / ROWS, s = e % ROWS;
    cs[e] = s < rows ? a.ctx[(base + s) * C + i] : 0.0f;
  }
  __syncthreads();

  nflows::mog_made_forward<ROWS, ROWS>(d, a.w, xs, cs, hb, tb, wst, nullptr);

  for (int e = tid; e < D * ROWS; e += NT) {
    const MogFeature f(tb + e, d.K, D * ROWS, d.eps, xs[e]);
    lpd[e] = f.log_prob();
  }
  __syncthreads();
  for (int s = tid; s < rows; s += NT) {
    float sum = 0.0f;
    for (int t = 0; t < D; ++t) sum += lpd[t * ROWS + s];
    a.lp[base + s] = sum;
  }
}

size_t smem_bytes(const MogArgs& a) {
  return sizeof(float) *
         ((size_t)2 * KC * OC + (size_t)ROWS * (a.d.H + a.TB + 2 * a.d.D + a.d.C));
}

}  // namespace

// C = 0: no context (ctx and the context weights may be null). P = 3 K D,
// Pp = P rounded up to a multiple of 4. Returns a cudaError_t value (0 on
// success).
extern "C" int mademog_log_prob_launch(const float* x, const float* ctx, float* lp, int64_t n,
                                       int D, int C, int K, int H, int P, int Pp, int nb,
                                       float eps, const float* wi, const float* bi,
                                       const float* wb, const float* bb, const float* wf,
                                       const float* bf, const float* wci, const float* bci,
                                       const float* wcb, const float* bcb, void* stream) {
  if (n == 0) return 0;
  if (H % 4 || Pp % 4 || Pp < P || P != 3 * K * D || C < 0) return (int)cudaErrorInvalidValue;
  if (C > 0 && !(ctx && wci && bci && wcb && bcb)) return (int)cudaErrorInvalidValue;
  MogArgs a;
  a.x = x; a.ctx = ctx; a.lp = lp; a.n = n;
  a.TB = H > Pp ? H : Pp;
  a.d = MogDims{D, C, K, H, P, Pp, nb, eps};
  a.w = MogWeights{wi, bi, wb, bb, wf, bf, wci, bci, wcb, bcb};
  const size_t bytes = smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(mademog_log_prob_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n + ROWS - 1) / ROWS;
  mademog_log_prob_kernel<<<(unsigned)blocks, NT, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
