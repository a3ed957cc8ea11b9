// Shared by the training kernels B3 and B4 in both their layouts: one
// block a tile (nsf_train.cu) and one thread-block cluster a tile
// (nsf_train_cluster.cu). The launch arguments (TrainArgs) and the C entry
// points' parameter list, the restore of kept activations, the context's
// cotangent and the stage adjoints of the seven coupling families.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "coupling_stage.cuh"
#include "cubic_spline_bwd.cuh"
#include "linear_spline_bwd.cuh"
#include "lrs_spline_bwd.cuh"
#include "quadratic_spline_bwd.cuh"
#include "rq_spline_bwd.cuh"

namespace {
struct TrainArgs {
  const float* x;     // [n][D]
  const float* gy;    // [n][D]  B4: cotangent of the chain's output
  const float* glad;  // [n]     B4: cotangent of the logabsdet
  float* lp;          // [n]     B3: log_prob
  float* gx;          // [n][D]  B4: cotangent of x
  int64_t n;
  int D, L, H, Tid, I4, T, TM, TMp, TB, nb2;
  int scaled_rows;   // rows of P that wh_scale multiplies: min(2 K T, TM)
  // forward weights, in-major and padded (pack_weights)
  const float* pw0;  // [L][I4][H]
  const float* pwb;  // [L][nb2][H][H]
  const float* pwf;  // [L][H][TMp]
  const float* pbf;  // [L][TMp]
  // the trained layout, [out][in]
  const float* w0;   // [L][H][Tid]
  const float* b0;   // [L][H]
  const float* wb;   // [L][nb2][H][H]
  const float* bb;   // [L][nb2][H]
  const float* wf;   // [L][TM][H]
  const int* idx;    // [L][2 Tid + 2 T + 2 D]
  // gradients, in the trained layout, zeroed by the caller
  float* gw0;
  float* gb0;
  float* gwb;
  float* gbb;
  float* gwf;
  float* gbf;
  float* stash;  // [blocks or clusters][L][SRB H + TMp][ROWS + 4]
  int SRB;       // kept H-row matrices a layer before P: nb2 + 1, and nb2 / 2 more with a context
  // the context (C = 0: none)
  int C;
  const float* ctx;   // [n][C]
  float* gctx;        // [n][C]  B4: cotangent of the context
  const float* pwc0;  // [L][C][H]       forward, in-major
  const float* pwcb;  // [L][nb][C][H]   forward, in-major
  const float* bcb;   // [L][nb][H]
  const float* wc0;   // [L][H][C]       the trained layout, [out][in]
  const float* wcb;   // [L][nb][H][C]
  float* gwc0;        // [L][H][C]
  float* gwcb;        // [L][nb][H][C]
  float* gbcb;        // [L][nb][H]
  float wh_scale, inv_n, log_z;
  nflows::StageConfig cfg;
};

// rows x [RS] floats from the block's scratch in global memory into shared
// memory, relu'd on the way if asked. Read past L1: another tile of this
// block wrote the same addresses before.
template <int ROWS>
__device__ __forceinline__ void restore(float* dst, const float* src, int rows, bool relu) {
  constexpr int NT = ROWS * 8, RS = ROWS + 4;
  for (int e = threadIdx.x; e < rows * (RS / 4); e += NT) {
    float4 v = __ldcg(reinterpret_cast<const float4*>(src) + e);
    if (relu) {
      v.x = fmaxf(v.x, 0.0f); v.y = fmaxf(v.y, 0.0f);
      v.z = fmaxf(v.z, 0.0f); v.w = fmaxf(v.w, 0.0f);
    }
    reinterpret_cast<float4*>(dst)[e] = v;
  }
}

// gcs[c][s] += sum_o w[o][c] G[o][s] for the tile's samples: the context's
// cotangent through a projection w [H][C] ([out][in]) of it; G is [H][RS].
// Thread e owns (c, s) = (e / ROWS, e % ROWS) in every call, so the sums
// need no barrier between calls.
template <int ROWS>
__device__ __forceinline__ void add_context_cotangent(const float* G, const float* w, int H,
                                                      int C, float* gcs) {
  constexpr int NT = ROWS * 8, RS = ROWS + 4;
  for (int e = threadIdx.x; e < C * ROWS; e += NT) {
    const int c = e / ROWS, s = e % ROWS;
    float sum = 0.0f;
    for (int o = 0; o < H; ++o) sum += w[o * C + c] * G[o * RS + s];
    gcs[e] += sum;
  }
}

// The adjoint of family FAMILY's forward stage for one element: P holds its
// parameters and G receives their cotangents, both K-major with `stride`
// (see coupling_stage.cuh for the rows); g_x the input's cotangent.
template <int FAMILY>
__device__ __forceinline__ void stage_adjoint(float x, const float* P, float* G, int stride,
                                              const nflows::StageConfig& c, float g_out,
                                              float g_lad, float wh_scale, float* g_x) {
  const int K = c.rq.num_bins, ks = K * stride;
  if constexpr (FAMILY == nflows::kRQ) {
    nflows::rq_spline_forward_adjoint(x, P, P + ks, P + 2 * ks, stride, c.rq, g_out, g_lad,
                                      wh_scale, g_x, G, G + ks, G + 2 * ks);
  } else if constexpr (FAMILY == nflows::kLRS) {
    nflows::lrs_spline_forward_adjoint(x, P, P + ks, P + 3 * ks, P + 2 * ks, stride, c.lrs,
                                       g_out, g_lad, wh_scale, g_x, G, G + ks, G + 3 * ks,
                                       G + 2 * ks);
  } else if constexpr (FAMILY == nflows::kLinear) {
    nflows::linear_spline_forward_adjoint(x, P, stride, c.linear, g_out, g_lad, wh_scale, g_x,
                                          G);
  } else if constexpr (FAMILY == nflows::kQuadratic) {
    nflows::quadratic_spline_forward_adjoint(x, P, P + ks, stride, c.quadratic, g_out, g_lad,
                                             wh_scale, g_x, G, G + ks);
  } else if constexpr (FAMILY == nflows::kCubic) {
    nflows::cubic_spline_forward_adjoint(x, P, P + ks, P[2 * ks], P[2 * ks + stride], stride,
                                         c.cubic, g_out, g_lad, wh_scale, g_x, G, G + ks,
                                         G + 2 * ks, G + 2 * ks + stride);
  } else {  // kAffine, kAdditive (scale_act kScaleNone)
    nflows::affine_coupling_forward_adjoint(x, P, stride, c.scale_act, g_out, g_lad, g_x, G);
  }
}

// stage_adjoint of the family c.family, chosen at run time.
__device__ __forceinline__ void stage_adjoint_eval(float x, const float* P, float* G, int stride,
                                                   const nflows::StageConfig& c, float g_out,
                                                   float g_lad, float wh_scale, float* g_x) {
  switch (c.family) {
    case nflows::kRQ:
      stage_adjoint<nflows::kRQ>(x, P, G, stride, c, g_out, g_lad, wh_scale, g_x);
      break;
    case nflows::kLRS:
      stage_adjoint<nflows::kLRS>(x, P, G, stride, c, g_out, g_lad, wh_scale, g_x);
      break;
    case nflows::kLinear:
      stage_adjoint<nflows::kLinear>(x, P, G, stride, c, g_out, g_lad, wh_scale, g_x);
      break;
    case nflows::kQuadratic:
      stage_adjoint<nflows::kQuadratic>(x, P, G, stride, c, g_out, g_lad, wh_scale, g_x);
      break;
    case nflows::kCubic:
      stage_adjoint<nflows::kCubic>(x, P, G, stride, c, g_out, g_lad, wh_scale, g_x);
      break;
    default:
      stage_adjoint<nflows::kAffine>(x, P, G, stride, c, g_out, g_lad, wh_scale, g_x);
  }
}


// The parameters of both C entry points, nsf_train_launch (nsf_train.cu) and
// nsf_train_cluster_launch (nsf_train_cluster.cu), and their names in order.
#define NSF_TRAIN_LAUNCH_PARAMS                                                                \
  int loss, const float *x, const float *gy, const float *glad, float *lp, float *gx,         \
      int64_t n, int D, int L, int H, int Tid, int I4, int T, int TM, int TMp, int nb2,       \
      const float *pw0, const float *pwb, const float *pwf, const float *pbf,                 \
      const float *w0, const float *b0, const float *wb, const float *bb, const float *wf,    \
      const int *idx, float *gw0, float *gb0, float *gwb, float *gbb, float *gwf, float *gbf, \
      float *stash, int C, const float *ctx, float *gctx, const float *pwc0,                  \
      const float *pwcb, const float *bcb, const float *wc0, const float *wcb, float *gwc0,   \
      float *gwcb, float *gbcb, int grid, int cluster_size, float wh_scale, float inv_n,      \
      int family, int scale_act, int num_bins, float tail_bound, float min_bin_width,         \
      float min_bin_height, float min_derivative, float min_lambda, float edge_derivative,    \
      float log_inv_bins, int rows_per_block, void *stream
#define NSF_TRAIN_LAUNCH_NAMES                                                                 \
  loss, x, gy, glad, lp, gx, n, D, L, H, Tid, I4, T, TM, TMp, nb2, pw0, pwb, pwf, pbf, w0, b0, \
      wb, bb, wf, idx, gw0, gb0, gwb, gbb, gwf, gbf, stash, C, ctx, gctx, pwc0, pwcb, bcb,    \
      wc0, wcb, gwc0, gwcb, gbcb, grid, cluster_size, wh_scale, inv_n, family, scale_act,     \
      num_bins, tail_bound, min_bin_width, min_bin_height, min_derivative, min_lambda,        \
      edge_derivative, log_inv_bins, rows_per_block, stream

// Checks the arguments an entry point shares and packs them into `a`.
// Returns a cudaError_t value (0 when they are valid).
int pack_train_args(TrainArgs& a, NSF_TRAIN_LAUNCH_PARAMS) {
  if (H % 4 || I4 % 4 || TMp % 4 || nb2 % 2 || grid < 1 || TM > TMp ||
      family < nflows::kRQ || family > nflows::kAdditive || C < 0 ||
      (C && !(ctx && pwc0 && pwcb && bcb && wc0 && wcb && gwc0 && gwcb && gbcb &&
              (loss || gctx))))
    return (int)cudaErrorInvalidValue;
  a.x = x; a.gy = gy; a.glad = glad; a.lp = lp; a.gx = gx; a.n = n;
  a.D = D; a.L = L; a.H = H; a.Tid = Tid; a.I4 = I4; a.T = T; a.TM = TM; a.TMp = TMp;
  a.TB = H > TMp ? H : TMp;
  if (I4 > a.TB) a.TB = I4;
  a.nb2 = nb2;
  a.scaled_rows = 2 * num_bins * T < TM ? 2 * num_bins * T : TM;
  a.pw0 = pw0; a.pwb = pwb; a.pwf = pwf; a.pbf = pbf;
  a.w0 = w0; a.b0 = b0; a.wb = wb; a.bb = bb; a.wf = wf; a.idx = idx;
  a.gw0 = gw0; a.gb0 = gb0; a.gwb = gwb; a.gbb = gbb; a.gwf = gwf; a.gbf = gbf;
  a.stash = stash;
  a.SRB = nb2 + 1 + (C ? nb2 / 2 : 0);
  a.C = C; a.ctx = ctx; a.gctx = gctx; a.pwc0 = pwc0; a.pwcb = pwcb; a.bcb = bcb;
  a.wc0 = wc0; a.wcb = wcb; a.gwc0 = gwc0; a.gwcb = gwcb; a.gbcb = gbcb;
  a.wh_scale = wh_scale;
  a.inv_n = inv_n;
  a.log_z = 0.5f * (float)D * logf(2.0f * 3.14159265358979323846f);
  a.cfg = nflows::make_stage_config(family, scale_act, num_bins, tail_bound, min_bin_width,
                                    min_bin_height, min_derivative, min_lambda,
                                    edge_derivative, log_inv_bins);
  return 0;
}

}  // namespace
