// B12: backward of the MixtureOfGaussiansMADE log-density (B11).
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/mademog_train.py:_bwd_kernel
// (fp32, with and without context). It recomputes B11's MADE pass and head
// from x (and the context) and pulls a given cotangent glp of lp back to
// gx, gctx and every weight gradient. The kernel reads mask-folded weights
// and returns dense gradients: the caller multiplies gwi, gwb and gwf by the
// masks (the chain rule of the fold), so a masked entry's gradient is
// exactly zero.
//
// Bound on the H100: operations. Recompute, input cotangents and weight
// gradients are three forward-equivalents of fp32 GEMM work, 3 x 2 (D H +
// C H (nb + 1) + 2 nb H^2 + 3 K D H) FLOP a sample (dense count, masked
// zeros included), against 4 (2 D + 2 C + 1) bytes a sample and 1.4 MB of
// weights read and as much of gradients written at features 10, hidden 256,
// 2 blocks, 10 components, context 10.
//
// Design: B10's (maf_train.cu), with the mixture head's adjoint in place of
// the transformer's.
// - The TPU kernel differentiates the model with jax.vjp traced inside the
//   kernel. Here the adjoint is written out (mademog_train.py, whose plain
//   version derives it). Per (feature, sample), with g = glp: the head
//   recomputes a = log_softmax(logits), s = softplus(u) + eps,
//   z = (x - mu) / s and the component log-densities c; r = softmax_k(c),
//   pi = exp(a); then g_logit = g (r - pi), g_mu = g r z / s,
//   g_u = g r (z^2 - 1) / s sigmoid(u), and x's direct cotangent
//   -g sum_k r z / s.
// - A block walks over tiles of 32 samples (a persistent grid of at most
//   one block an SM). Per tile: the forward pass keeps, in a per-block
//   scratch in global memory, c_init, the hidden state before each residual
//   block and after the last, and each block's relu'd inner activation; the
//   head's adjoint runs on P while it is still in shared memory; then the
//   backward sweep over the final layer, the blocks and the initial layer.
// - GEMMs (tile_gemm.cuh): forward on the packed in-major weights B11
//   reads; input cotangents with the same routine on the [out][in]
//   matrices, relu masks in its epilogue; weight gradients with tile_wgrad,
//   added into the global buffers with fp32 atomics because blocks run in
//   no order (the wrapper zeroes them before each launch; gradients agree
//   run to run only to fp32 rounding). The products into the D inputs and
//   the C context features are plain loops: D and C are too narrow for the
//   staged GEMM's float4 rows.
// - Context: block j's pre-relu cotangent gives gWcb_j, gbcb_j and
//   Wcb_j^T of it into gctx; the initial layer's cotangent through
//   relu'(c_init) gives gWci, gbci and Wci^T of it into gctx.
// - The ragged last tile computes on zero rows with zero cotangents, so it
//   adds nothing for them, and skips their stores.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mademog.cuh"
#include "tile_gemm.cuh"

namespace {

using nflows::KC;
using nflows::MogDims;
using nflows::MogFeature;
using nflows::MogWeights;
using nflows::OC;
using nflows::tile_bgrad;
using nflows::tile_gemm;
using nflows::tile_wgrad;

constexpr int ROWS = 32;
constexpr int NT = ROWS * 8;
constexpr int RS = ROWS + 4;

struct MogTrainArgs {
  const float* x;    // [n][D]
  const float* ctx;  // [n][C], null when C = 0
  const float* glp;  // [n]
  float* gx;         // [n][D]
  float* gctx;       // [n][C], null when C = 0
  int64_t n;
  int TB;            // rows of the X, Y, Z buffers: max(H, Pp)
  MogDims d;
  MogWeights pw;     // forward weights, in-major and padded (mademog_fused.py:pack_weights)
  // the extracted layout, [out][in], mask folded
  const float* wi;   // [H][D]
  const float* wb;   // [2 nb][H][H]
  const float* wf;   // [P][H]
  const float* wci;  // [H][C]
  const float* wcb;  // [nb][H][C]
  // gradients, in the extracted layout, zeroed by the caller
  float *gwi, *gbi, *gwb, *gbb, *gwf, *gbf, *gwci, *gbci, *gwcb, *gbcb;
  float* stash;      // [grid][2 + 2 nb][H][RS]
};

// rows x [RS] floats from the block's scratch in global memory into shared
// memory, relu'd on the way if asked. Read past L1: another tile of this
// block wrote the same addresses before.
__device__ __forceinline__ void restore(float* dst, const float* src, int rows, bool relu) {
  for (int e = threadIdx.x; e < rows * (RS / 4); e += NT) {
    float4 v = __ldcg(reinterpret_cast<const float4*>(src) + e);
    if (relu) {
      v.x = fmaxf(v.x, 0.0f); v.y = fmaxf(v.y, 0.0f);
      v.z = fmaxf(v.z, 0.0f); v.w = fmaxf(v.w, 0.0f);
    }
    reinterpret_cast<float4*>(dst)[e] = v;
  }
}

// gc[c][s] += sum_o W[o][c] g[o][s]: the cotangent of the C context
// features through a projection W [H][C]. Each (c, s) belongs to one thread
// in every call, so gc needs no barrier of its own.
__device__ __forceinline__ void context_cotangent(const float* W, const float* g, int H, int C,
                                                  float* gc) {
  for (int e = threadIdx.x; e < C * ROWS; e += NT) {
    const int c = e / ROWS, s = e % ROWS;
    float sum = 0.0f;
    for (int o = 0; o < H; ++o) sum += W[o * C + c] * g[o * RS + s];
    gc[c * RS + s] += sum;
  }
}

__global__ void __launch_bounds__(NT) mademog_train_bwd_kernel(MogTrainArgs a) {
  extern __shared__ __align__(16) float smem[];
  const MogDims& d = a.d;
  const int D = d.D, C = d.C, K = d.K, H = d.H, P = d.P, nb = d.nb;
  float* wst = smem;                  // [2][KC][OC]
  float* X = wst + 2 * KC * OC;       // [TB][RS]
  float* Y = X + a.TB * RS;           // [TB][RS]
  float* Z = Y + a.TB * RS;           // [TB][RS]
  float* xs = Z + a.TB * RS;          // [D][RS] inputs
  float* gxd = xs + D * RS;           // [D][RS] x's direct cotangent through the head
  float* cs = gxd + D * RS;           // [C][RS] context
  float* gcs = cs + C * RS;           // [C][RS] its cotangent
  float* glp = gcs + C * RS;          // [ROWS]

  const int tid = threadIdx.x;
  const size_t HR = (size_t)H * RS;
  float* st = a.stash + (size_t)blockIdx.x * (2 + 2 * nb) * HR;
  const int64_t ntiles = (a.n + ROWS - 1) / ROWS;

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = tile * ROWS;
    const int rows = (int)min((int64_t)ROWS, a.n - base);

    for (int e = tid; e < D * ROWS; e += NT) {
      const int i = e / ROWS, s = e % ROWS;
      xs[i * RS + s] = s < rows ? a.x[(base + s) * D + i] : 0.0f;
    }
    for (int e = tid; e < C * ROWS; e += NT) {
      const int i = e / ROWS, s = e % ROWS;
      cs[i * RS + s] = s < rows ? a.ctx[(base + s) * C + i] : 0.0f;
      gcs[i * RS + s] = 0.0f;
    }
    for (int s = tid; s < ROWS; s += NT) glp[s] = s < rows ? a.glp[base + s] : 0.0f;
    __syncthreads();

    // ---- forward pass, keeping what the backward needs: X = h_nb, Y = P ------
    nflows::mog_made_forward<ROWS, RS>(d, a.pw, xs, cs, X, Y, wst, st);

    // ---- the head's adjoint: gP into Z, x's direct cotangent into gxd ----------
    for (int e = tid; e < D * ROWS; e += NT) {
      const int t = e / ROWS, s = e % ROWS;
      const int ks = D * RS;
      const MogFeature f(Y + t * RS + s, K, ks, d.eps, xs[t * RS + s]);
      const float cm = f.max_component();
      float sc = 0.0f;
      for (int k = 0; k < K; ++k) sc += expf(f.component(k) - cm);
      const float g = glp[s];
      float* G = Z + t * RS + s;
      float gx = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float r = expf(f.component(k) - cm) / sc;
        const float sd = f.sdev(k);
        const float z = (f.x - f.mean(k)) / sd;
        const float grz = g * r * z / sd;
        G[k * ks] = g * (r - expf(f.log_coef(k)));
        G[(K + k) * ks] = grz;
        G[(2 * K + k) * ks] = g * r * (z * z - 1.0f) / sd * nflows::mog_sigmoid(f.ustd(k));
        gx -= grz;
      }
      gxd[t * RS + s] = gx;
    }
    __syncthreads();

    // ---- final layer: gWf += gP h^T, gbf += gP 1, Y = g_h = Wf^T gP -------------
    tile_wgrad<ROWS, RS>(Z, P, X, H, a.gwf, H);
    tile_bgrad<ROWS, RS>(Z, P, a.gbf);
    tile_gemm<ROWS, RS>(Z, P, a.wf, nullptr, H, Y, false, false, false, wst);

    // ---- residual blocks, last first; Y holds g_h --------------------------------
    for (int j = nb - 1; j >= 0; --j) {
      const size_t m = 2 * (size_t)j;
      restore(X, st + (2 + nb + j) * HR, H, false);  // t_j = relu(W0 relu(h_j) + b0 [+ c_j])
      __syncthreads();
      tile_wgrad<ROWS, RS>(Y, H, X, H, a.gwb + (m + 1) * H * H, H);
      tile_bgrad<ROWS, RS>(Y, H, a.gbb + (m + 1) * H);
      // Z = g_t = (W1^T g_h) where t_j > 0: the cotangent before the inner relu
      tile_gemm<ROWS, RS>(Y, H, a.wb + (m + 1) * H * H, nullptr, H, Z, false, false, false, wst,
                          X);
      if (C) {
        tile_wgrad<ROWS, RS>(Z, H, cs, C, a.gwcb + (size_t)j * H * C, C);
        tile_bgrad<ROWS, RS>(Z, H, a.gbcb + (size_t)j * H);
        context_cotangent(a.wcb + (size_t)j * H * C, Z, H, C, gcs);
      }
      restore(X, st + (1 + j) * HR, H, true);  // relu(h_j)
      __syncthreads();
      tile_wgrad<ROWS, RS>(Z, H, X, H, a.gwb + m * H * H, H);
      tile_bgrad<ROWS, RS>(Z, H, a.gbb + m * H);
      // g_h += (W0^T g_t) where h_j > 0
      tile_gemm<ROWS, RS>(Z, H, a.wb + m * H * H, nullptr, H, Y, false, false, true, wst, X);
    }

    // ---- initial layer, and the context projection added to it; Y = g_h0 ---------
    if (C) {
      restore(X, st, H, false);  // c_init = relu(Wci c + bci)
      __syncthreads();
      for (int e = tid; e < H * ROWS; e += NT) {
        const int o = e / ROWS, s = e % ROWS;
        Z[o * RS + s] = X[o * RS + s] > 0.0f ? Y[o * RS + s] : 0.0f;
      }
      __syncthreads();
      tile_wgrad<ROWS, RS>(Z, H, cs, C, a.gwci, C);
      tile_bgrad<ROWS, RS>(Z, H, a.gbci);
      context_cotangent(a.wci, Z, H, C, gcs);
    }
    tile_wgrad<ROWS, RS>(Y, H, xs, D, a.gwi, D);
    tile_bgrad<ROWS, RS>(Y, H, a.gbi);
    // gx = Wi^T g_h0 + the head's direct term
    for (int e = tid; e < D * ROWS; e += NT) {
      const int i = e / ROWS, s = e % ROWS;
      float sum = gxd[i * RS + s];
      for (int o = 0; o < H; ++o) sum += a.wi[o * D + i] * Y[o * RS + s];
      if (s < rows) a.gx[(base + s) * D + i] = sum;
    }
    for (int e = tid; e < C * ROWS; e += NT) {
      const int i = e / ROWS, s = e % ROWS;
      if (s < rows) a.gctx[(base + s) * C + i] = gcs[i * RS + s];
    }
    __syncthreads();
  }
}

size_t smem_bytes(const MogTrainArgs& a) {
  return sizeof(float) * ((size_t)2 * KC * OC +
                          (size_t)RS * (3 * a.TB + 2 * a.d.D + 2 * a.d.C) + ROWS);
}

}  // namespace

// C = 0: no context (ctx, gctx and the context weights and gradients may be
// null). P = 3 K D, Pp = P rounded up to a multiple of 4. grid: blocks to
// launch; stash holds grid x (2 + 2 nb) x H x 36 floats. Returns a
// cudaError_t value (0 on success).
extern "C" int mademog_train_launch(
    const float* x, const float* ctx, const float* glp, float* gx, float* gctx, int64_t n, int D,
    int C, int K, int H, int P, int Pp, int nb, float eps, const float* pwi, const float* bi,
    const float* pwb, const float* bb, const float* pwf, const float* pbf, const float* pwci,
    const float* bci, const float* pwcb, const float* bcb, const float* wi, const float* wb,
    const float* wf, const float* wci, const float* wcb, float* gwi, float* gbi, float* gwb,
    float* gbb, float* gwf, float* gbf, float* gwci, float* gbci, float* gwcb, float* gbcb,
    float* stash, int grid, void* stream) {
  if (n == 0) return 0;
  if (H % 4 || Pp % 4 || Pp < P || P != 3 * K * D || C < 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (C > 0 && !(ctx && gctx && pwci && bci && pwcb && bcb && wci && wcb && gwci && gbci &&
                 gwcb && gbcb))
    return (int)cudaErrorInvalidValue;
  MogTrainArgs a;
  a.x = x; a.ctx = ctx; a.glp = glp; a.gx = gx; a.gctx = gctx; a.n = n;
  a.TB = H > Pp ? H : Pp;
  a.d = MogDims{D, C, K, H, P, Pp, nb, eps};
  a.pw = MogWeights{pwi, bi, pwb, bb, pwf, pbf, pwci, bci, pwcb, bcb};
  a.wi = wi; a.wb = wb; a.wf = wf; a.wci = wci; a.wcb = wcb;
  a.gwi = gwi; a.gbi = gbi; a.gwb = gwb; a.gbb = gbb; a.gwf = gwf; a.gbf = gbf;
  a.gwci = gwci; a.gbci = gbci; a.gwcb = gwcb; a.gbcb = gbcb;
  a.stash = stash;
  const size_t bytes = smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(mademog_train_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  mademog_train_bwd_kernel<<<(unsigned)grid, NT, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
