// Adjoint of the linear-tail quadratic spline's forward branch (K-1
// interior heights), for one element, by explicit formulas.
//
// The TPU training kernels (nflows_tpu/ops/pallas/nsf_train.py) get this
// adjoint from jax.vjp traced inside the kernel; here it is derived by hand
// from quadratic_spline_eval (quadratic_spline.cuh, inverse = false) for
// kernels B3 and B4. Its plain PyTorch version is
// ops/splines/quadratic.py:quadratic_spline_forward_adjoint_plain, which
// repeats this arithmetic line for line and is held against autograd.
//
// What flows where. The selected bin's output a alpha^2 + b alpha + c
// (clipped to [0, 1]; a clipped output carries no gradient) and logabsdet
// log(alpha (h1 - h0) + h0) depend on its location (the widths below it),
// its width, its cdf (the trapezoids below it) and its two knot heights.
// Every knot height is normalised by the area of all the trapezoids, and the
// two boundary knots are solved from every width and interior height (the
// `edge` of the forward), so one bin's cotangent reaches every parameter.
//
// Nothing K-long is held in registers: the width cotangents are gathered in
// g_uw and the interior-height ones written to g_uh (both with the
// parameters' stride), then the softmax adjoint reads g_uw back. Every
// cotangent is multiplied by wh_scale: a quadratic spline's caller scales
// all its parameters.
#pragma once

#include "quadratic_spline.cuh"

namespace nflows {

// g_uw: K entries at [k * stride]; g_uh: K-1.
__device__ __forceinline__ void quadratic_spline_forward_adjoint(
    float x_orig, const float* uw, const float* uh, int stride, const QuadraticConfig& cfg,
    float g_out, float g_lad, float wh_scale, float* g_x, float* g_uw, float* g_uh) {
  const int K = cfg.num_bins;
  const float B = cfg.tail_bound;
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float x = (fminf(fmaxf(x_orig, -B), B) + B) / (2.0f * B);

  const Softmax sw = softmax_of(uw, K, stride);
  const float wmix = 1.0f - cfg.min_bin_width * K;
  const float hmix = 1.0f - cfg.min_bin_height;
  auto width = [&](int k) { return bin_size(uw, k, stride, sw, cfg.min_bin_width, wmix); };
  auto interior = [&](int k) { return softplus(uh[k * stride]) + 1e-3f; };

  // the forward: boundary heights, area, then the walk over the bins
  const float first_w = 0.5f * width(0), last_w = 0.5f * width(K - 1);
  float inner = 0.0f;
  for (int k = 1; k < K - 1; ++k)
    inner += ((interior(k - 1) + interior(k)) / 2.0f) * width(k);
  const float numerator = 0.5f * first_w * interior(0) + 0.5f * last_w * interior(K - 2) + inner;
  const float dd = 1.0f - 0.5f * first_w - 0.5f * last_w;
  const float edge = numerator / dd;
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
  int sel = 0;
  float sel_loc = 0.0f, sel_w = 0.0f, sel_cdf = 0.0f, sel_h0 = 0.0f, sel_h1 = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float wk = width(k);
    const float h1 = height(knot(k + 1));
    run_cdf += ((h0 + h1) / 2.0f) * wk;
    run_loc += wk;
    if (k == 0 || x >= loc_lo) {
      sel = k;
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

  const float alpha = (x - sel_loc) / sel_w;
  const float a = 0.5f * (sel_h1 - sel_h0) * sel_w;
  const float b = sel_h0 * sel_w;
  const float raw = a * alpha * alpha + b * alpha + sel_cdf;
  const float ld = alpha * (sel_h1 - sel_h0) + sel_h0;

  // cotangents of the selected bin's quantities
  const float g_y = inside ? g_out : 0.0f;
  const float g_l = inside ? g_lad : 0.0f;
  const float g_raw = (raw >= 0.0f && raw <= 1.0f) ? g_y * (2.0f * B) : 0.0f;
  const float g_ld = g_l / ld;
  const float g_a = g_raw * alpha * alpha;
  const float g_b = g_raw * alpha;
  const float g_cdf = g_raw;
  const float g_alpha = g_raw * (2.0f * a * alpha + b) + g_ld * (sel_h1 - sel_h0);
  const float g_h1 = g_a * 0.5f * sel_w + g_ld * alpha;
  const float g_h0 = -g_a * 0.5f * sel_w + g_b * sel_w + g_ld * (1.0f - alpha);
  const float g_wsel = g_a * 0.5f * (sel_h1 - sel_h0) + g_b * sel_h0 - g_alpha * alpha / sel_w;
  const float g_loc = -g_alpha / sel_w;
  const float g_x01 = g_alpha / sel_w;

  // knot heights: the selected bin's two, and the trapezoids below it
  // (sel_cdf); each normalised by the area
  auto g_height = [&](int j) {
    float g = (sel == j ? g_h0 : 0.0f) + (sel == j - 1 ? g_h1 : 0.0f);
    if (j < K && sel > j) g += g_cdf * width(j) / 2.0f;
    if (j > 0 && sel >= j) g += g_cdf * width(j - 1) / 2.0f;
    return g;
  };
  const float scale = hmix / area;
  float g_area = 0.0f;
  for (int j = 0; j <= K; ++j) g_area -= g_height(j) * scale * (knot(j) / area);
  auto g_knot = [&](int j) {
    float g = g_height(j) * scale;
    if (j < K) g += g_area * width(j) / 2.0f;
    if (j > 0) g += g_area * width(j - 1) / 2.0f;
    return g;
  };

  // the boundary knots: edge = numerator / dd
  const float g_edge = g_knot(0) + g_knot(K);
  const float g_num = g_edge / dd;
  const float g_dd = -g_edge * edge / dd;
  const float g_first = g_num * 0.5f * interior(0) - 0.5f * g_dd;
  const float g_last = g_num * 0.5f * interior(K - 2) - 0.5f * g_dd;

  // width cotangents into g_uw; interior heights through softplus' = sigmoid
  for (int k = 0; k < K; ++k) {
    float g = g_area * (knot(k) + knot(k + 1)) / 2.0f;
    if (sel > k) g += g_loc + g_cdf * (height(knot(k)) + height(knot(k + 1))) / 2.0f;
    if (sel == k) g += g_wsel;
    if (k == 0) g += 0.5f * g_first;
    if (k == K - 1) g += 0.5f * g_last;
    if (k > 0 && k < K - 1) g += g_num * (interior(k - 1) + interior(k)) / 2.0f;
    g_uw[k * stride] = g;
  }
  for (int i = 0; i < K - 1; ++i) {
    float g = g_knot(i + 1);
    if (i == 0) g += g_num * 0.5f * first_w;
    if (i == K - 2) g += g_num * 0.5f * last_w;
    if (i + 1 < K - 1) g += g_num * width(i + 1) / 2.0f;
    if (i > 0) g += g_num * width(i) / 2.0f;
    g_uh[i * stride] = wh_scale * g * sigmoid(uh[i * stride]);
  }

  // softmax adjoint of the widths
  float dot = 0.0f;
  for (int k = 0; k < K; ++k) dot += softmax_at(uw, k, stride, sw) * (wmix * g_uw[k * stride]);
  for (int k = 0; k < K; ++k)
    g_uw[k * stride] =
        wh_scale * softmax_at(uw, k, stride, sw) * (wmix * g_uw[k * stride] - dot);
  *g_x = inside ? g_x01 / (2.0f * B) : g_out;
}

}  // namespace nflows
