// Rational-quadratic spline with linear tails, for one element.
//
// The RQ math of the whole-chain kernels (B2's coupling stage, B9, B10),
// one element a thread; the elementwise kernel B1 (rq_spline.cu) runs the
// same steps on a group of lanes an element and ends in the same evaluation
// of the selected bin (rq_bin_eval). Mirrors the TPU kernel's
// arithmetic (nflows_tpu/ops/pallas/rq_spline.py:_kernel and
// _spline_common.py:53-109): softmax with min-bin mixing, cumulative edges
// pinned to +-B, softplus derivatives, sum-of-ge bin search, RQ evaluation
// or the stable quadratic root 2c / (-b - sqrt(disc)), identity and zero
// logabsdet outside [-B, B].
//
// The K parameters of one element are read with a stride, so the same
// function reads [..., K] rows (stride 1) and B2's K-major shared memory
// tile (stride T). Nothing is held in a K-long register array:
// K is a run-time value and a dynamically indexed array would go to local
// memory. The parameters are read three times instead (maxima, softmax
// sums, edge walk), from L1 or shared memory.
//
// Bin search: the edges come from running sums of positive bin sizes, so
// they are non-decreasing in floating point too, and the set of interior
// edges <= x is a prefix. The last bin whose lower edge is <= x is then
// exactly the sum-of-ge index of the TPU kernel.
#pragma once

#include <math.h>

namespace nflows {

struct RQConfig {
  int num_bins;          // K
  float tail_bound;      // B
  float min_bin_width;
  float min_bin_height;
  float min_derivative;
  float edge_derivative; // derivative at +-B (1, or min_derivative + softplus(pad constant))
};

// jnp.logaddexp(v, 0): max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// The RQ spline in its selected bin, from x (clamped into [-B, B]): the
// bin's lower edges cw, ch, its width and height xw, xh, the derivatives d0,
// d1 at its knots. rq_spline_eval ends here, and so does B1 (rq_spline.cu),
// which finds the bin on a group of lanes.
__device__ __forceinline__ void rq_bin_eval(float x_orig, bool inside, float x, float sel_cw,
                                            float sel_ch, float sel_xw, float sel_xh, float d0,
                                            float d1, bool inverse, float* out, float* lad) {
  const float delta = sel_xh / sel_xw;
  const float d_sum = d0 + d1 - 2.0f * delta;
  float theta, y;
  if (inverse) {
    const float y_rel = x - sel_ch;
    const float a = y_rel * d_sum + sel_xh * (delta - d0);
    const float b = sel_xh * d0 - y_rel * d_sum;
    const float c = -delta * y_rel;
    const float disc = fmaxf(b * b - 4.0f * a * c, 0.0f);
    theta = (2.0f * c) / (-b - sqrtf(disc));
    y = theta * sel_xw + sel_cw;
  } else {
    theta = (x - sel_cw) / sel_xw;
    const float num = sel_xh * (delta * theta * theta + d0 * theta * (1.0f - theta));
    const float den = delta + d_sum * theta * (1.0f - theta);
    y = sel_ch + num / den;
  }
  const float tomt = theta * (1.0f - theta);
  const float denominator = delta + d_sum * tomt;
  const float deriv_num = delta * delta *
      (d1 * theta * theta + 2.0f * delta * tomt + d0 * (1.0f - theta) * (1.0f - theta));
  float l = logf(deriv_num) - 2.0f * logf(denominator);
  if (inverse) l = -l;
  *out = inside ? y : x_orig;
  *lad = inside ? l : 0.0f;
}


// uw, uh: K unnormalised widths / heights at w[k * stride];
// ud: K-1 interior unnormalised derivatives at ud[k * stride].
__device__ __forceinline__ void rq_spline_eval(
    float x_orig, const float* uw, const float* uh, const float* ud,
    int stride, bool inverse, const RQConfig& cfg, float* out, float* lad) {
  const int K = cfg.num_bins;
  const float B = cfg.tail_bound;
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float x = fminf(fmaxf(x_orig, -B), B);

  float wmax = uw[0], hmax = uh[0];
  for (int k = 1; k < K; ++k) {
    wmax = fmaxf(wmax, uw[k * stride]);
    hmax = fmaxf(hmax, uh[k * stride]);
  }
  float wsum = 0.0f, hsum = 0.0f;
  for (int k = 0; k < K; ++k) {
    wsum += expf(uw[k * stride] - wmax);
    hsum += expf(uh[k * stride] - hmax);
  }
  const float winv = 1.0f / wsum, hinv = 1.0f / hsum;
  const float wmix = 1.0f - cfg.min_bin_width * K;
  const float hmix = 1.0f - cfg.min_bin_height * K;
  const float two_b = 2.0f * B;

  // walk the bins: edge_lo is edge k, edge_hi edge k+1 (pinned at k = K-1)
  float runw = 0.0f, runh = 0.0f;
  float ew_lo = -B, eh_lo = -B;
  int sel = 0;
  float sel_cw = -B, sel_ch = -B, sel_xw = 0.0f, sel_xh = 0.0f;
  for (int k = 0; k < K; ++k) {
    runw += cfg.min_bin_width + (wmix * expf(uw[k * stride] - wmax)) * winv;
    runh += cfg.min_bin_height + (hmix * expf(uh[k * stride] - hmax)) * hinv;
    const float ew_hi = (k == K - 1) ? B : two_b * runw - B;
    const float eh_hi = (k == K - 1) ? B : two_b * runh - B;
    if (k == 0 || x >= (inverse ? eh_lo : ew_lo)) {
      sel = k;
      sel_cw = ew_lo;
      sel_ch = eh_lo;
      sel_xw = ew_hi - ew_lo;
      sel_xh = eh_hi - eh_lo;
    }
    ew_lo = ew_hi;
    eh_lo = eh_hi;
  }
  const float d0 = (sel == 0) ? cfg.edge_derivative
                              : cfg.min_derivative + softplus(ud[(sel - 1) * stride]);
  const float d1 = (sel == K - 1) ? cfg.edge_derivative
                                  : cfg.min_derivative + softplus(ud[sel * stride]);

  rq_bin_eval(x_orig, inside, x, sel_cw, sel_ch, sel_xw, sel_xh, d0, d1, inverse, out, lad);
}

}  // namespace nflows
