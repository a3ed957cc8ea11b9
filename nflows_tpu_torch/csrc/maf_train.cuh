// Shared by kernel B10 in both its layouts: one block a tile
// (maf_train.cu) and one thread-block cluster a tile (maf_train_cluster.cu).
// The launch arguments (MafTrainArgs) and the C entry points' parameter
// list (train_tile.cuh: the restore of kept activations and the context's
// cotangent).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rq_spline.cuh"
#include "train_tile.cuh"

namespace {

struct MafTrainArgs {
  const float* x;     // [n][D]
  const float* ctx;   // [n][C], null when C = 0
  const float* gy;    // [n][D]  cotangent of the chain's output
  const float* glad;  // [n]     cotangent of the logabsdet
  float* gx;          // [n][D]  cotangent of x
  float* gctx;        // [n][C]  cotangent of the context
  int64_t n;
  int D, L, H, D4, P, Pp, TB, nb2;
  int C, C4;          // context features, and rounded up to a multiple of 4
  int inverse;        // 0: forward through unwrapped layers; 1: back through wrapped ones
  // forward weights, in-major and padded (maf_flow_kernel.py:pack_weights)
  const float* pwi;  // [L][D4][H]
  const float* pwb;  // [L][nb2][H][H]
  const float* pwf;  // [L][H][Pp]
  const float* pbf;  // [L][Pp]
  const float* pwci;  // [L][C4][H]
  const float* pwcb;  // [L][nb][C4][H]
  // the extracted layout, [out][in], mask folded
  const float* wi;   // [L][H][D]
  const float* bi;   // [L][H]
  const float* wb;   // [L][nb2][H][H]
  const float* bb;   // [L][nb2][H]
  const float* wf;   // [L][P][H]
  const float* wci;  // [L][H][C]
  const float* bci;  // [L][H]
  const float* wcb;  // [L][nb][H][C]
  const float* bcb;  // [L][nb][H]
  const int* idx;    // [L][2 D + 1]: perm_rows, inv_perm_rows, wrapped
  // gradients, in the extracted layout, zeroed by the caller
  float* gwi;
  float* gbi;
  float* gwb;
  float* gbb;
  float* gwf;
  float* gbf;
  float* gwci;
  float* gbci;
  float* gwcb;
  float* gbcb;
  float* stash;  // [blocks or clusters][L][(nb2 + 1) H + Pp][ROWS + 4]
  int rq;        // 0: affine transformer, 1: RQ spline
  float wh_scale;
  nflows::RQConfig cfg;
};

// The parameters of both C entry points, maf_train_launch (maf_train.cu) and
// maf_train_cluster_launch (maf_train_cluster.cu), and their names in order.
#define MAF_TRAIN_LAUNCH_PARAMS                                                                  \
  const float *x, const float *ctx, const float *gy, const float *glad, float *gx, float *gctx, \
      int64_t n, int D, int L, int H, int D4, int P, int Pp, int nb2, int C, int C4,            \
      const float *pwi, const float *pwb, const float *pwf, const float *pbf,                   \
      const float *pwci, const float *pwcb, const float *wi, const float *bi, const float *wb,  \
      const float *bb, const float *wf, const float *wci, const float *bci, const float *wcb,   \
      const float *bcb, const int *idx, float *gwi, float *gbi, float *gwb, float *gbb,         \
      float *gwf, float *gbf, float *gwci, float *gbci, float *gwcb, float *gbcb,               \
      float *stash, int grid, int cluster_size, int inverse, int transformer, float wh_scale,   \
      int num_bins, float tail_bound, float min_bin_width, float min_bin_height,                \
      float min_derivative, int rows_per_block, void *stream
#define MAF_TRAIN_LAUNCH_NAMES                                                                   \
  x, ctx, gy, glad, gx, gctx, n, D, L, H, D4, P, Pp, nb2, C, C4, pwi, pwb, pwf, pbf, pwci, pwcb, \
      wi, bi, wb, bb, wf, wci, bci, wcb, bcb, idx, gwi, gbi, gwb, gbb, gwf, gbf, gwci, gbci,    \
      gwcb, gbcb, stash, grid, cluster_size, inverse, transformer, wh_scale, num_bins,          \
      tail_bound, min_bin_width, min_bin_height, min_derivative, rows_per_block, stream

// Checks the arguments the entry points share and packs them into `a`.
// Returns a cudaError_t value (0 when they are valid).
int pack_maf_train_args(MafTrainArgs& a, MAF_TRAIN_LAUNCH_PARAMS) {
  if (H % 4 || D4 % 4 || Pp % 4 || nb2 % 2 || D4 < D || Pp < P || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (C < 0 || C4 % 4 || C4 < C || (C == 0 && C4 != 0) || (inverse != 0 && inverse != 1))
    return (int)cudaErrorInvalidValue;
  if (C > 0 && !(ctx && gctx && pwci && pwcb && wci && bci && wcb && bcb && gwci && gbci &&
                 gwcb && gbcb))
    return (int)cudaErrorInvalidValue;
  if (transformer != 0 && transformer != 1) return (int)cudaErrorInvalidValue;
  if (P != (transformer ? (3 * num_bins - 1) * D : 2 * D)) return (int)cudaErrorInvalidValue;
  a.x = x; a.ctx = ctx; a.gy = gy; a.glad = glad; a.gx = gx; a.gctx = gctx; a.n = n;
  a.C = C; a.C4 = C4; a.inverse = inverse;
  a.pwci = pwci; a.pwcb = pwcb; a.wci = wci; a.bci = bci; a.wcb = wcb; a.bcb = bcb;
  a.gwci = gwci; a.gbci = gbci; a.gwcb = gwcb; a.gbcb = gbcb;
  a.D = D; a.L = L; a.H = H; a.D4 = D4; a.P = P; a.Pp = Pp;
  a.TB = H > Pp ? H : Pp;
  if (D4 > a.TB) a.TB = D4;
  a.nb2 = nb2;
  a.pwi = pwi; a.pwb = pwb; a.pwf = pwf; a.pbf = pbf;
  a.wi = wi; a.bi = bi; a.wb = wb; a.bb = bb; a.wf = wf; a.idx = idx;
  a.gwi = gwi; a.gbi = gbi; a.gwb = gwb; a.gbb = gbb; a.gwf = gwf; a.gbf = gbf;
  a.stash = stash;
  a.rq = transformer;
  a.wh_scale = wh_scale;
  a.cfg = nflows::RQConfig{num_bins, tail_bound, min_bin_width, min_bin_height, min_derivative,
                           1.0f};
  return 0;
}

}  // namespace
