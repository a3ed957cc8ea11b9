// Linear-rational spline with linear tails, for one element.
//
// Mirrors the TPU kernel's arithmetic (nflows_tpu/ops/pallas/lrs_spline.py
// _kernel, and ops/splines/linear_rational.py where the derivation is
// written out): softmax widths and heights with min-bin mixing, cumulative
// edges pinned to +-B, softplus derivatives with the boundary slopes given
// (edge_derivative), lambda = min + (1 - 2 min) sigmoid, the sum-of-ge bin
// search, then two Möbius pieces joined at lambda: the forward chooses its
// piece by theta <= lambda, the inverse by y <= ym and solves the piece's
// linear equation for theta. Identity and zero logabsdet outside [-B, B].
//
// Only the chosen piece is evaluated (the TPU kernel evaluates both and
// selects); its inputs still pass the min/max clamps the plain version
// applies, which are the identity on the piece that is taken, so the
// arithmetic is the same. The bin walk is rq_spline_eval's: see
// rq_spline.cuh for why the last bin whose lower edge is <= x is the
// sum-of-ge index.
#pragma once

#include "spline_common.cuh"

namespace nflows {

struct LRSConfig {
  int num_bins;          // K
  float tail_bound;      // B
  float min_bin_width;
  float min_bin_height;
  float min_derivative;
  float min_lambda;
  float edge_derivative; // min_derivative + softplus(pad constant)
};

// The two Möbius pieces of the selected bin, from x (clamped into
// [-B, B]): the bin's lower edges x0, y0, its width and height w, h, the
// derivatives d0, d1 at its knots and its lambda. lrs_spline_eval ends
// here, and so does B5 (lrs_spline.cu), which finds the bin on a group of
// lanes.
__device__ __forceinline__ void lrs_bin_eval(float x_orig, bool inside, float x, float x0,
                                             float y0, float w, float h, float d0, float d1,
                                             float lam, bool inverse, float* out, float* lad) {
  const float y1 = y0 + h;
  const float wb = sqrtf(d0 / d1);
  const float ym = ((1.0f - lam) * y0 + lam * wb * y1) / ((1.0f - lam) + lam * wb);
  const float wm = d0 * lam * w / (ym - y0);

  float theta;
  bool use_a;
  if (inverse) {
    use_a = x <= ym;
    if (use_a) {
      const float ya = fminf(x, ym);
      theta = lam * (ya - y0) / (wm * (ym - ya) + (ya - y0));
    } else {
      const float yb = fmaxf(x, ym);
      theta = (wm * (ym - yb) + wb * lam * (yb - y1)) / (wm * (ym - yb) + wb * (yb - y1));
    }
  } else {
    theta = (x - x0) / w;
    use_a = theta <= lam;
  }

  float y, l;
  if (use_a) {
    const float ta = fminf(theta, lam);
    const float den = (lam - ta) + wm * ta;
    y = (y0 * (lam - ta) + wm * ym * ta) / den;
    l = logf(wm) + logf(lam) + logf(ym - y0) - 2.0f * logf(den) - logf(w);
  } else {
    const float tb = fmaxf(theta, lam);
    const float den = wm * (1.0f - tb) + wb * (tb - lam);
    y = (wm * ym * (1.0f - tb) + wb * y1 * (tb - lam)) / den;
    l = logf(wm) + logf(wb) + log1pf(-lam) + logf(y1 - ym) - 2.0f * logf(den) - logf(w);
  }
  if (inverse) {
    y = x0 + theta * w;
    l = -l;
  }
  *out = inside ? y : x_orig;
  *lad = inside ? l : 0.0f;
}

// uw, uh, ul: K values at [k * stride]; ud: K-1 interior derivatives.
__device__ __forceinline__ void lrs_spline_eval(
    float x_orig, const float* uw, const float* uh, const float* ud,
    const float* ul, int stride, bool inverse, const LRSConfig& cfg,
    float* out, float* lad) {
  const int K = cfg.num_bins;
  const float B = cfg.tail_bound;
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float x = fminf(fmaxf(x_orig, -B), B);

  const Softmax sw = softmax_of(uw, K, stride), sh = softmax_of(uh, K, stride);
  const float wmix = 1.0f - cfg.min_bin_width * K;
  const float hmix = 1.0f - cfg.min_bin_height * K;
  const float two_b = 2.0f * B;

  float runw = 0.0f, runh = 0.0f, ew_lo = -B, eh_lo = -B;
  int sel = 0;
  float x0 = -B, y0 = -B, w = 0.0f, h = 0.0f;
  for (int k = 0; k < K; ++k) {
    runw += bin_size(uw, k, stride, sw, cfg.min_bin_width, wmix);
    runh += bin_size(uh, k, stride, sh, cfg.min_bin_height, hmix);
    const float ew_hi = (k == K - 1) ? B : two_b * runw - B;
    const float eh_hi = (k == K - 1) ? B : two_b * runh - B;
    if (k == 0 || x >= (inverse ? eh_lo : ew_lo)) {
      sel = k;
      x0 = ew_lo;
      y0 = eh_lo;
      w = ew_hi - ew_lo;
      h = eh_hi - eh_lo;
    }
    ew_lo = ew_hi;
    eh_lo = eh_hi;
  }
  const float d0 = (sel == 0) ? cfg.edge_derivative
                              : cfg.min_derivative + softplus(ud[(sel - 1) * stride]);
  const float d1 = (sel == K - 1) ? cfg.edge_derivative
                                  : cfg.min_derivative + softplus(ud[sel * stride]);
  const float lam = cfg.min_lambda +
                    (1.0f - 2.0f * cfg.min_lambda) * sigmoid(ul[sel * stride]);

  lrs_bin_eval(x_orig, inside, x, x0, y0, w, h, d0, d1, lam, inverse, out, lad);
}

}  // namespace nflows
