// Piecewise-quadratic spline with linear tails (K-1 heights), for one
// element.
//
// Mirrors the TPU kernel (nflows_tpu/ops/pallas/quadratic_spline.py
// _kernel, with the plain version's order of sums): softmax widths with
// min-bin mixing; interior knot heights softplus(h) + 1e-3; the boundary
// height solved for so that the normalised pdf is 1 at both ends; the
// trapezoid area normalisation and the min-height floor; CDF and location
// knots as running sums with the last pinned to 1; the sum-of-ge bin
// search (a prefix, the knots being non-decreasing); then the quadratic
// forward, or the stable root -2c / (b + sqrt(max(disc, 0))). Identity and
// zero logabsdet outside [-B, B].
//
// Knot height k of the K+1 is the solved boundary value at k = 0 and
// k = K and interior height k-1 otherwise; it is recomputed where needed
// rather than held in a K-long register array (K is a run-time value).
#pragma once

#include "spline_common.cuh"

namespace nflows {

struct QuadraticConfig {
  int num_bins;      // K
  float tail_bound;  // B
  float min_bin_width;
  float min_bin_height;
};

// The quadratic in its selected bin, from x normalised to [0, 1]: the
// bin's lower location and CDF knots loc, cdf, its width w and the heights
// h0, h1 at its knots. quadratic_spline_eval ends here, and so does B7
// (quadratic_spline.cu), which finds the bin on a group of lanes.
__device__ __forceinline__ void quadratic_bin_eval(float x_orig, bool inside, float x,
                                                   float sel_loc, float sel_cdf, float sel_w,
                                                   float sel_h0, float sel_h1, bool inverse,
                                                   float B, float* out, float* lad) {
  const float a = 0.5f * (sel_h1 - sel_h0) * sel_w;
  const float b = sel_h0 * sel_w;
  const float c = sel_cdf;
  float out01, l;
  if (inverse) {
    const float c_ = c - x;
    const float disc = fmaxf(b * b - 4.0f * a * c_, 0.0f);
    const float alpha = (-2.0f * c_) / (b + sqrtf(disc));
    out01 = fminf(fmaxf(alpha * sel_w + sel_loc, 0.0f), 1.0f);
    l = -logf(alpha * (sel_h1 - sel_h0) + sel_h0);
  } else {
    const float alpha = (x - sel_loc) / sel_w;
    out01 = fminf(fmaxf(a * alpha * alpha + b * alpha + c, 0.0f), 1.0f);
    l = logf(alpha * (sel_h1 - sel_h0) + sel_h0);
  }
  *out = inside ? out01 * (2.0f * B) - B : x_orig;
  *lad = inside ? l : 0.0f;
}

// uw: K unnormalised widths at uw[k * stride]; uh: K-1 unnormalised heights.
__device__ __forceinline__ void quadratic_spline_eval(
    float x_orig, const float* uw, const float* uh, int stride, bool inverse,
    const QuadraticConfig& cfg, float* out, float* lad) {
  const int K = cfg.num_bins;
  const float B = cfg.tail_bound;
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float x = (fminf(fmaxf(x_orig, -B), B) + B) / (2.0f * B);

  const Softmax sw = softmax_of(uw, K, stride);
  const float wmix = 1.0f - cfg.min_bin_width * K;
  auto width = [&](int k) { return bin_size(uw, k, stride, sw, cfg.min_bin_width, wmix); };
  auto interior = [&](int k) { return softplus(uh[k * stride]) + 1e-3f; };

  // boundary heights (reference quadratic.py:88-104)
  const float first_w = 0.5f * width(0), last_w = 0.5f * width(K - 1);
  float inner = 0.0f;
  for (int k = 1; k < K - 1; ++k)
    inner += ((interior(k - 1) + interior(k)) / 2.0f) * width(k);
  const float numerator = 0.5f * first_w * interior(0) + 0.5f * last_w * interior(K - 2) + inner;
  const float edge = numerator / (1.0f - 0.5f * first_w - 0.5f * last_w);
  auto knot = [&](int k) { return (k == 0 || k == K) ? edge : interior(k - 1); };

  float area = 0.0f;
  float hk = edge;
  for (int k = 0; k < K; ++k) {
    const float hn = knot(k + 1);
    area += ((hk + hn) / 2.0f) * width(k);
    hk = hn;
  }
  auto height = [&](float unnorm) {
    return cfg.min_bin_height + (1.0f - cfg.min_bin_height) * (unnorm / area);
  };

  float cdf_lo = 0.0f, loc_lo = 0.0f, run_cdf = 0.0f, run_loc = 0.0f;
  float h0 = height(edge);
  float sel_loc = 0.0f, sel_w = 0.0f, sel_cdf = 0.0f, sel_h0 = 0.0f, sel_h1 = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float wk = width(k);
    const float h1 = height(knot(k + 1));
    run_cdf += ((h0 + h1) / 2.0f) * wk;
    run_loc += wk;
    if (k == 0 || x >= (inverse ? cdf_lo : loc_lo)) {
      sel_loc = loc_lo;
      sel_w = wk;
      sel_cdf = cdf_lo;
      sel_h0 = h0;
      sel_h1 = h1;
    }
    cdf_lo = (k == K - 1) ? 1.0f : run_cdf;
    loc_lo = (k == K - 1) ? 1.0f : run_loc;
    h0 = h1;
  }

  quadratic_bin_eval(x_orig, inside, x, sel_loc, sel_cdf, sel_w, sel_h0, sel_h1, inverse, B, out,
                     lad);
}

}  // namespace nflows
