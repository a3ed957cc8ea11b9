// Piecewise-linear spline with linear tails, for one element.
//
// Mirrors the TPU kernel (nflows_tpu/ops/pallas/linear_spline.py _kernel):
// the input normalised to [0, 1], a softmax pdf over K equal-width bins and
// its CDF, whose last knot is pinned to exactly 1. The forward bins by
// floor(x K) clamped to [0, K-1] (x = 1 lands in bin K-1), the inverse by
// the sum-of-ge search over the CDF's interior knots (a prefix, since the
// running sums of positive terms are non-decreasing in floating point);
// logabsdet log(pdf) - log(1/K) forward, -log(slope) inverse. Identity and
// zero logabsdet outside [-B, B].
#pragma once

#include "spline_common.cuh"

namespace nflows {

struct LinearConfig {
  int num_bins;      // K
  float tail_bound;  // B
  float log_inv_bins;  // log(1/K), as the plain version's constant rounds it
};

// The bin's evaluation, which linear_spline_eval and B6 (linear_spline.cu,
// which finds the bin on a group of lanes) both run. Each branch has its
// own: linear_spline_eval joining the two into one function moved the
// registers of the training kernels that inline it (coupling_stage.cuh).
//
// The forward in its bin, at alpha = x K - bin: the bin's lower CDF knot lo
// and its pdf give out01 on [0, 1] and the logabsdet l.
__device__ __forceinline__ void linear_forward_bin(float alpha, float lo, float pdf,
                                                   const LinearConfig& cfg, float& out01,
                                                   float& l) {
  out01 = fminf(fmaxf(lo + alpha * pdf, 0.0f), 1.0f);
  l = logf(pdf) - cfg.log_inv_bins;
}

// The inverse in its bin sel, from x on [0, 1]: the bin's CDF knots lo and hi
// give the slope and offset as the TPU kernel computes them.
__device__ __forceinline__ void linear_inverse_bin(float x, int sel, float lo, float hi, int K,
                                                   float& out01, float& l) {
  const float slope = (hi - lo) * (float)K;
  const float offset = hi - slope * ((float)(sel + 1) / (float)K);
  out01 = fminf(fmaxf((x - offset) / slope, 0.0f), 1.0f);
  l = -logf(slope);
}

// up: K unnormalised pdf values at up[k * stride].
__device__ __forceinline__ void linear_spline_eval(
    float x_orig, const float* up, int stride, bool inverse,
    const LinearConfig& cfg, float* out, float* lad) {
  const int K = cfg.num_bins;
  const float B = cfg.tail_bound;
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float x = (fminf(fmaxf(x_orig, -B), B) + B) / (2.0f * B);
  const Softmax sp = softmax_of(up, K, stride);

  float out01, l;
  if (inverse) {
    // knot k+1 is the running sum of pdf_0..pdf_k, knot K pinned to 1
    float lo = 0.0f, run = 0.0f;
    int sel = 0;
    float sel_lo = 0.0f, sel_hi = 1.0f;
    for (int k = 0; k < K; ++k) {
      run += softmax_at(up, k, stride, sp);
      const float hi = (k == K - 1) ? 1.0f : run;
      if (k == 0 || x >= lo) {
        sel = k;
        sel_lo = lo;
        sel_hi = hi;
      }
      lo = hi;
    }
    linear_inverse_bin(x, sel, sel_lo, sel_hi, K, out01, l);
  } else {
    const float bin_pos = x * (float)K;
    const float fidx = fminf(fmaxf(floorf(bin_pos), 0.0f), (float)(K - 1));
    const float alpha = bin_pos - fidx;
    const int idx = (int)fidx;
    float cdf = 0.0f;
    for (int k = 0; k < idx; ++k) cdf += softmax_at(up, k, stride, sp);
    linear_forward_bin(alpha, cdf, softmax_at(up, idx, stride, sp), cfg, out01, l);
  }
  *out = inside ? out01 * (2.0f * B) - B : x_orig;
  *lad = inside ? l : 0.0f;
}

}  // namespace nflows
