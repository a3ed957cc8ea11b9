// Shared by kernel B12 in both its layouts: one block a tile
// (mademog_train.cu) and one thread-block cluster a tile
// (mademog_train_cluster.cu). The launch arguments (MogTrainArgs), the
// mixture head's adjoint and the C entry points' parameter list
// (train_tile.cuh: the restore of kept activations and the context's
// cotangent).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mademog.cuh"
#include "train_tile.cuh"

namespace {

struct MogTrainArgs {
  const float* x;    // [n][D]
  const float* ctx;  // [n][C], null when C = 0
  const float* glp;  // [n]
  float* gx;         // [n][D]
  float* gctx;       // [n][C], null when C = 0
  int64_t n;
  int TB;            // rows of the X, Y, Z buffers: max(H, Pp)
  nflows::MogDims d;
  nflows::MogWeights pw;  // forward weights, in-major and padded (mademog_fused.py:pack_weights)
  // the extracted layout, [out][in], mask folded
  const float* wi;   // [H][D]
  const float* wb;   // [2 nb][H][H]
  const float* wf;   // [P][H]
  const float* wci;  // [H][C]
  const float* wcb;  // [nb][H][C]
  // gradients, in the extracted layout, zeroed by the caller
  float *gwi, *gbi, *gwb, *gbb, *gwf, *gbf, *gwci, *gbci, *gwcb, *gbcb;
  float* stash;      // [blocks or clusters][2 + 2 nb][H][ROWS + 4]
};

// The mixture head's adjoint for a tile of ROWS samples (the formulas in
// mademog_train.cu's header): from P ([Pp][ROWS + 4], the K-major rows of
// mademog.cuh), the inputs xs [D][ROWS + 4] and the cotangents glp [ROWS],
// the cotangent of P into G ([P][ROWS + 4]) and x's direct cotangent into
// gxd [D][ROWS + 4]. A (feature, sample) a thread; no barrier.
template <int ROWS>
__device__ __forceinline__ void head_adjoint(const nflows::MogDims& d, const float* P,
                                             const float* xs, const float* glp, float* G,
                                             float* gxd) {
  constexpr int NT = ROWS * 8, RS = ROWS + 4;
  const int D = d.D, K = d.K, ks = D * RS;
  for (int e = threadIdx.x; e < D * ROWS; e += NT) {
    const int t = e / ROWS, s = e % ROWS;
    const nflows::MogFeature f(P + t * RS + s, K, ks, d.eps, xs[t * RS + s]);
    const float cm = f.max_component();
    float sc = 0.0f;
    for (int k = 0; k < K; ++k) sc += expf(f.component(k) - cm);
    const float g = glp[s];
    float* Gt = G + t * RS + s;
    float gx = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float r = expf(f.component(k) - cm) / sc;
      const float sd = f.sdev(k);
      const float z = (f.x - f.mean(k)) / sd;
      const float grz = g * r * z / sd;
      Gt[k * ks] = g * (r - expf(f.log_coef(k)));
      Gt[(K + k) * ks] = grz;
      Gt[(2 * K + k) * ks] = g * r * (z * z - 1.0f) / sd * nflows::mog_sigmoid(f.ustd(k));
      gx -= grz;
    }
    gxd[t * RS + s] = gx;
  }
}

// The parameters of both C entry points, mademog_train_launch
// (mademog_train.cu) and mademog_train_cluster_launch
// (mademog_train_cluster.cu), and their names in order.
#define MOG_TRAIN_LAUNCH_PARAMS                                                                 \
  const float *x, const float *ctx, const float *glp, float *gx, float *gctx, int64_t n, int D, \
      int C, int K, int H, int P, int Pp, int nb, float eps, const float *pwi,                 \
      const float *bi, const float *pwb, const float *bb, const float *pwf, const float *pbf,  \
      const float *pwci, const float *bci, const float *pwcb, const float *bcb,                \
      const float *wi, const float *wb, const float *wf, const float *wci, const float *wcb,   \
      float *gwi, float *gbi, float *gwb, float *gbb, float *gwf, float *gbf, float *gwci,     \
      float *gbci, float *gwcb, float *gbcb, float *stash, int grid, int cluster_size,         \
      void *stream
#define MOG_TRAIN_LAUNCH_NAMES                                                                  \
  x, ctx, glp, gx, gctx, n, D, C, K, H, P, Pp, nb, eps, pwi, bi, pwb, bb, pwf, pbf, pwci, bci,  \
      pwcb, bcb, wi, wb, wf, wci, wcb, gwi, gbi, gwb, gbb, gwf, gbf, gwci, gbci, gwcb, gbcb,   \
      stash, grid, cluster_size, stream

// Checks the arguments the entry points share and packs them into `a`.
// Returns a cudaError_t value (0 when they are valid).
int pack_mog_train_args(MogTrainArgs& a, MOG_TRAIN_LAUNCH_PARAMS) {
  if (H % 4 || Pp % 4 || Pp < P || P != 3 * K * D || C < 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (C > 0 && !(ctx && gctx && pwci && bci && pwcb && bcb && wci && wcb && gwci && gbci &&
                 gwcb && gbcb))
    return (int)cudaErrorInvalidValue;
  a.x = x; a.ctx = ctx; a.glp = glp; a.gx = gx; a.gctx = gctx; a.n = n;
  a.TB = H > Pp ? H : Pp;
  a.d = nflows::MogDims{D, C, K, H, P, Pp, nb, eps};
  a.pw = nflows::MogWeights{pwi, bi, pwb, bb, pwf, pbf, pwci, bci, pwcb, bcb};
  a.wi = wi; a.wb = wb; a.wf = wf; a.wci = wci; a.wcb = wcb;
  a.gwi = gwi; a.gbi = gbi; a.gwb = gwb; a.gbb = gbb; a.gwf = gwf; a.gbf = gbf;
  a.gwci = gwci; a.gbci = gbci; a.gwcb = gwcb; a.gbcb = gbcb;
  a.stash = stash;
  return 0;
}

}  // namespace
