// Adjoint of the linear-tail rational-quadratic spline's forward branch,
// for one element, by explicit formulas.
//
// The TPU training kernels (nflows_tpu/ops/pallas/nsf_train.py) get this
// adjoint from jax.vjp traced inside the kernel; CUDA has no tracer, so it
// is derived by hand from rq_spline_eval (rq_spline.cuh, inverse = false)
// and written here once for kernels B3 and B4. Its plain PyTorch version is
// ops/splines/rational_quadratic.py:rq_spline_forward_adjoint_plain, which
// repeats this arithmetic line for line and is held against autograd.
//
// What flows where. y = ch + num / den and lad = log(deriv_num) - 2 log(den)
// depend on the selected bin's lower edges (cw, ch), sizes (xw, xh) and end
// slopes (d0, d1). An interior edge m is 2B * (sizes of the bins below m) - B
// and the edges -B and +B are constants, so the cotangent of edge sel goes
// to every bin below sel and that of edge sel + 1 to every bin up to sel;
// the last bin's size is B - edge, not its own softmax term. Sizes are
// min + (1 - K min) softmax(u): all K entries get a gradient, the max
// subtraction none. Boundary slopes are constants; interior ones are
// min_derivative + softplus(ud). The bin index is piecewise constant.
// Outside [-B, B] the layer is the identity: g_x = g_out, nothing else.
//
// Parameters are read with a stride as in rq_spline_eval, and the parameter
// cotangents are written with the same stride; nothing K-long is held in
// registers. g_uw and g_uh are multiplied by wh_scale, the factor the
// caller applied to the width and height rows before the spline read them.
#pragma once

#include "rq_spline.cuh"

namespace nflows {

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

// g_uw, g_uh: K entries at [k * stride]; g_ud: K-1 entries at [k * stride].
__device__ __forceinline__ void rq_spline_forward_adjoint(
    float x_orig, const float* uw, const float* uh, const float* ud, int stride,
    const RQConfig& cfg, float g_out, float g_lad, float wh_scale, float* g_x, float* g_uw,
    float* g_uh, float* g_ud) {
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

  // the forward's walk over the bins
  float runw = 0.0f, runh = 0.0f;
  float ew_lo = -B, eh_lo = -B;
  int sel = 0;
  float sel_cw = -B, sel_xw = 0.0f, sel_xh = 0.0f;
  for (int k = 0; k < K; ++k) {
    runw += cfg.min_bin_width + (wmix * expf(uw[k * stride] - wmax)) * winv;
    runh += cfg.min_bin_height + (hmix * expf(uh[k * stride] - hmax)) * hinv;
    const float ew_hi = (k == K - 1) ? B : two_b * runw - B;
    const float eh_hi = (k == K - 1) ? B : two_b * runh - B;
    if (k == 0 || x >= ew_lo) {
      sel = k;
      sel_cw = ew_lo;
      sel_xw = ew_hi - ew_lo;
      sel_xh = eh_hi - eh_lo;
    }
    ew_lo = ew_hi;
    eh_lo = eh_hi;
  }
  const bool first = sel == 0, last = sel == K - 1;
  const float ud_lo = first ? 0.0f : ud[(sel - 1) * stride];
  const float ud_hi = last ? 0.0f : ud[sel * stride];
  const float d0 = first ? cfg.edge_derivative : cfg.min_derivative + softplus(ud_lo);
  const float d1 = last ? cfg.edge_derivative : cfg.min_derivative + softplus(ud_hi);

  const float delta = sel_xh / sel_xw;
  const float d_sum = d0 + d1 - 2.0f * delta;
  const float theta = (x - sel_cw) / sel_xw;
  const float omt = 1.0f - theta;
  const float tomt = theta * omt;
  const float nn = delta * theta * theta + d0 * tomt;  // numerator / bin height
  const float num = sel_xh * nn;
  const float den = delta + d_sum * tomt;
  const float ss = d1 * theta * theta + 2.0f * delta * tomt + d0 * omt * omt;
  const float deriv_num = delta * delta * ss;

  // cotangents of num, den and deriv_num; nothing flows outside [-B, B]
  const float g_y = inside ? g_out : 0.0f;
  const float g_l = inside ? g_lad : 0.0f;
  const float g_num = g_y / den;
  const float g_den = -g_y * num / (den * den) - 2.0f * g_l / den;
  const float g_dn = g_l / deriv_num;
  const float one_m2t = 1.0f - 2.0f * theta;
  const float g_delta = g_num * sel_xh * theta * theta + g_den * (1.0f - 2.0f * tomt) +
                        g_dn * (2.0f * delta * ss + 2.0f * delta * delta * tomt);
  const float g_d0 = g_num * sel_xh * tomt + g_den * tomt + g_dn * delta * delta * omt * omt;
  const float g_d1 = g_den * tomt + g_dn * delta * delta * theta * theta;
  const float g_theta =
      g_num * sel_xh * (2.0f * delta * theta + d0 * one_m2t) + g_den * d_sum * one_m2t +
      g_dn * delta * delta * (2.0f * d1 * theta + 2.0f * delta * one_m2t - 2.0f * d0 * omt);
  const float g_xh = g_num * nn + g_delta / sel_xw;
  const float g_xw = -(g_delta * delta + g_theta * theta) / sel_xw;
  const float g_xin = g_theta / sel_xw;
  const float g_cw = -g_xin;
  const float g_ch = g_y;

  // edge sel carries g_c - g_x to the bins below sel, edge sel + 1 carries
  // g_x to the bins up to sel; then the softmax adjoint
  const float w_lo = first ? 0.0f : (two_b * wmix) * (g_cw - g_xw);
  const float w_hi = last ? 0.0f : (two_b * wmix) * g_xw;
  const float h_lo = first ? 0.0f : (two_b * hmix) * (g_ch - g_xh);
  const float h_hi = last ? 0.0f : (two_b * hmix) * g_xh;
  float wdot = 0.0f, hdot = 0.0f;
  for (int k = 0; k <= sel; ++k) {
    const float sw = expf(uw[k * stride] - wmax) * winv;
    const float sh = expf(uh[k * stride] - hmax) * hinv;
    wdot += ((k < sel ? w_lo : 0.0f) + w_hi) * sw;
    hdot += ((k < sel ? h_lo : 0.0f) + h_hi) * sh;
  }
  for (int k = 0; k < K; ++k) {
    const float sw = expf(uw[k * stride] - wmax) * winv;
    const float sh = expf(uh[k * stride] - hmax) * hinv;
    const float gw = (k < sel ? w_lo : 0.0f) + (k <= sel ? w_hi : 0.0f);
    const float gh = (k < sel ? h_lo : 0.0f) + (k <= sel ? h_hi : 0.0f);
    g_uw[k * stride] = wh_scale * sw * (gw - wdot);
    g_uh[k * stride] = wh_scale * sh * (gh - hdot);
  }

  // interior slopes: softplus' = sigmoid
  for (int k = 0; k < K - 1; ++k) {
    float g = 0.0f;
    if (!first && k == sel - 1) g += g_d0 * sigmoidf(ud_lo);
    if (!last && k == sel) g += g_d1 * sigmoidf(ud_hi);
    g_ud[k * stride] = g;
  }
  *g_x = inside ? g_xin : g_out;
}

}  // namespace nflows
