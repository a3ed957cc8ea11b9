// Monotone cubic spline with linear tails, for one element.
//
// Mirrors the TPU kernel (nflows_tpu/ops/pallas/cubic_spline.py _kernel)
// and the plain version's order of operations (ops/splines/cubic.py):
// softmax widths and heights with min-bin mixing, knots as running sums
// with the last pinned to 1, slopes h/w, Steffen's interior derivatives
// min(min(|s_{k-1}|, |s_k|), (w_k s_{k-1} + w_{k-1} s_k) / 2(w_{k-1} + w_k))
// (sign(s_{k-1}) + sign(s_k)) with sign(0) = 0, boundary derivatives
// 3 sigmoid(d) s, the cubic's coefficients for the selected bin only, then
// the forward, or the inverse by 30 bisection halvings of [0, bin width]
// and one Newton step. Identity and zero logabsdet outside [-B, B].
//
// Bound on the H100: memory for the forward; the inverse adds 30 halvings
// of ~8 operations each, still below the card's operations-to-bytes ratio.
#pragma once

#include "spline_common.cuh"

namespace nflows {

struct CubicConfig {
  int num_bins;      // K
  float tail_bound;  // B
  float min_bin_width;
  float min_bin_height;
};

constexpr int kCubicBisectionSteps = 30;

__device__ __forceinline__ float sign0(float v) {
  return (v > 0.0f) ? 1.0f : ((v < 0.0f) ? -1.0f : 0.0f);
}

// Steffen's derivative at the knot between two bins of slopes sp, sn and
// widths wp, wn (sign(0) = 0)
__device__ __forceinline__ float steffen_derivative(float sp, float sn, float wp, float wn) {
  const float m1 = fminf(fabsf(sp), fabsf(sn));
  const float m2 = 0.5f * (wn * sp + wp * sn) / (wp + wn);
  return fminf(m1, m2) * (sign0(sp) + sign0(sn));
}

// The cubic a t^3 + b t^2 + c t + d of the selected bin, t = x - left_w,
// from x normalised to [0, 1], the bin's knots left_w, right_w: forward, or
// the inverse by bisection of [0, right_w - left_w] and one Newton step.
// cubic_spline_eval ends here, and so does B8 (cubic_spline.cu), which finds
// the bin on a group of lanes.
__device__ __forceinline__ void cubic_bin_eval(float x_orig, bool inside, float x, float a,
                                               float b, float c, float d, float left_w,
                                               float right_w, bool inverse, float B, float* out,
                                               float* lad) {
  float shifted, out01, l;
  if (inverse) {
    float lo = 0.0f, hi = right_w - left_w;
    for (int i = 0; i < kCubicBisectionSteps; ++i) {
      const float mid = 0.5f * (lo + hi);
      const float fmid = ((a * mid + b) * mid + c) * mid + d - x;
      const bool go_right = fmid < 0.0f;
      lo = go_right ? mid : lo;
      hi = go_right ? hi : mid;
    }
    const float t = 0.5f * (lo + hi);
    const float deriv = 3.0f * a * (t * t) + 2.0f * b * t + c;
    const float f = ((a * t + b) * t + c) * t + d - x;
    shifted = t - f / deriv;
    out01 = shifted + left_w;
    l = -logf(3.0f * a * (shifted * shifted) + 2.0f * b * shifted + c);
  } else {
    shifted = x - left_w;
    out01 = a * (shifted * shifted * shifted) + b * (shifted * shifted) + c * shifted + d;
    l = logf(3.0f * a * (shifted * shifted) + 2.0f * b * shifted + c);
  }
  out01 = fminf(fmaxf(out01, 0.0f), 1.0f);
  *out = inside ? out01 * (2.0f * B) - B : x_orig;
  *lad = inside ? l : 0.0f;
}


// uw, uh: K values at [k * stride]; dl, dr: the two boundary parameters.
__device__ __forceinline__ void cubic_spline_eval(
    float x_orig, const float* uw, const float* uh, float dl, float dr,
    int stride, bool inverse, const CubicConfig& cfg, float* out, float* lad) {
  const int K = cfg.num_bins;
  const float B = cfg.tail_bound;
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float x = (fminf(fmaxf(x_orig, -B), B) + B) / (2.0f * B);

  const Softmax sw = softmax_of(uw, K, stride), sh = softmax_of(uh, K, stride);
  const float wmix = 1.0f - cfg.min_bin_width * K;
  const float hmix = 1.0f - cfg.min_bin_height * K;
  auto width = [&](int k) { return bin_size(uw, k, stride, sw, cfg.min_bin_width, wmix); };
  auto height = [&](int k) { return bin_size(uh, k, stride, sh, cfg.min_bin_height, hmix); };
  auto slope = [&](int k) { return height(k) / width(k); };

  float runw = 0.0f, runh = 0.0f, cw_lo = 0.0f, ch_lo = 0.0f;
  int sel = 0;
  float left_w = 0.0f, right_w = 0.0f, sel_ch = 0.0f;
  for (int k = 0; k < K; ++k) {
    runw += width(k);
    runh += height(k);
    const float cw_hi = (k == K - 1) ? 1.0f : runw;
    const float ch_hi = (k == K - 1) ? 1.0f : runh;
    if (k == 0 || x >= (inverse ? ch_lo : cw_lo)) {
      sel = k;
      left_w = cw_lo;
      right_w = cw_hi;
      sel_ch = ch_lo;
    }
    cw_lo = cw_hi;
    ch_lo = ch_hi;
  }

  auto derivative = [&](int k) {
    if (k == 0) return sigmoid(dl) * 3.0f * slope(0);
    if (k == K) return sigmoid(dr) * 3.0f * slope(K - 1);
    const float sp = slope(k - 1), sn = slope(k);
    const float wp = width(k - 1), wn = width(k);
    return steffen_derivative(sp, sn, wp, wn);
  };
  const float ws = width(sel), ss = slope(sel);
  const float d0 = derivative(sel), d1 = derivative(sel + 1);
  const float a = (d0 + d1 - 2.0f * ss) / (ws * ws);
  const float b = (3.0f * ss - 2.0f * d0 - d1) / ws;
  const float c = d0;
  const float d = sel_ch;

  cubic_bin_eval(x_orig, inside, x, a, b, c, d, left_w, right_w, inverse, B, out, lad);
}

}  // namespace nflows
