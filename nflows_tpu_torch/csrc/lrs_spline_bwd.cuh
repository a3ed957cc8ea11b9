// Adjoint of the linear-tail linear-rational spline's forward branch, for
// one element, by explicit formulas.
//
// The TPU training kernels (nflows_tpu/ops/pallas/nsf_train.py) get this
// adjoint from jax.vjp traced inside the kernel; here it is derived by hand
// from lrs_spline_eval (lrs_spline.cuh, inverse = false) for kernels B3 and
// B4. Its plain PyTorch version is
// ops/splines/linear_rational.py:linear_rational_spline_forward_adjoint_plain,
// which repeats this arithmetic line for line and is held against autograd.
//
// What flows where. theta = (x - x0) / w picks the Möbius piece at lambda;
// the piece's output num / den and its logabsdet (log wm + log lambda +
// log(ym - y0) on piece a, log wm + log wb + log1p(-lambda) + log(y1 - ym)
// on piece b, both minus 2 log den and log w) depend on y0, y1 = y0 + h,
// lambda, and the weights wb = sqrt(d0 / d1) and wm = d0 lambda w / (ym - y0)
// through the join ym. The piece's clamp of theta is the identity on the
// piece taken, so theta carries the whole cotangent. The bin's edges and
// sizes carry theirs to the softmax as in rq_spline_bwd.cuh; the end slopes
// are min_derivative + softplus of an interior derivative, or the constant
// edge_derivative at +-B; lambda is min + (1 - 2 min) sigmoid. Outside
// [-B, B] the layer is the identity.
//
// Parameters are read, and their cotangents written, with a stride as in
// lrs_spline_eval. g_uw and g_uh are multiplied by wh_scale (the caller
// scales widths and heights), g_ud and g_ul are not.
#pragma once

#include "lrs_spline.cuh"

namespace nflows {

// g_uw, g_uh, g_ul: K entries at [k * stride]; g_ud: K-1.
__device__ __forceinline__ void lrs_spline_forward_adjoint(
    float x_orig, const float* uw, const float* uh, const float* ud, const float* ul,
    int stride, const LRSConfig& cfg, float g_out, float g_lad, float wh_scale, float* g_x,
    float* g_uw, float* g_uh, float* g_ud, float* g_ul) {
  const int K = cfg.num_bins;
  const float B = cfg.tail_bound;
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float x = fminf(fmaxf(x_orig, -B), B);

  const Softmax sw = softmax_of(uw, K, stride), sh = softmax_of(uh, K, stride);
  const float wmix = 1.0f - cfg.min_bin_width * K;
  const float hmix = 1.0f - cfg.min_bin_height * K;
  const float two_b = 2.0f * B;

  // the forward's walk over the bins
  float runw = 0.0f, runh = 0.0f, ew_lo = -B, eh_lo = -B;
  int sel = 0;
  float x0 = -B, y0 = -B, w = 0.0f, h = 0.0f;
  for (int k = 0; k < K; ++k) {
    runw += bin_size(uw, k, stride, sw, cfg.min_bin_width, wmix);
    runh += bin_size(uh, k, stride, sh, cfg.min_bin_height, hmix);
    const float ew_hi = (k == K - 1) ? B : two_b * runw - B;
    const float eh_hi = (k == K - 1) ? B : two_b * runh - B;
    if (k == 0 || x >= ew_lo) {
      sel = k;
      x0 = ew_lo;
      y0 = eh_lo;
      w = ew_hi - ew_lo;
      h = eh_hi - eh_lo;
    }
    ew_lo = ew_hi;
    eh_lo = eh_hi;
  }
  const bool first = sel == 0, last = sel == K - 1;
  const float ud_lo = first ? 0.0f : ud[(sel - 1) * stride];
  const float ud_hi = last ? 0.0f : ud[sel * stride];
  const float d0 = first ? cfg.edge_derivative : cfg.min_derivative + softplus(ud_lo);
  const float d1 = last ? cfg.edge_derivative : cfg.min_derivative + softplus(ud_hi);
  const float sig_l = sigmoid(ul[sel * stride]);
  const float lam = cfg.min_lambda + (1.0f - 2.0f * cfg.min_lambda) * sig_l;

  const float y1 = y0 + h;
  const float wb = sqrtf(d0 / d1);
  const float q_num = (1.0f - lam) * y0 + lam * wb * y1;
  const float q_den = (1.0f - lam) + lam * wb;
  const float ym = q_num / q_den;
  const float r = ym - y0;
  const float wm = d0 * lam * w / r;
  const float theta = (x - x0) / w;
  const bool use_a = theta <= lam;

  // the piece taken and its cotangents
  const float g_y = inside ? g_out : 0.0f;
  const float g_l = inside ? g_lad : 0.0f;
  const float den = use_a ? (lam - theta) + wm * theta
                          : wm * (1.0f - theta) + wb * (theta - lam);
  const float num = use_a ? y0 * (lam - theta) + wm * ym * theta
                          : wm * ym * (1.0f - theta) + wb * y1 * (theta - lam);
  const float y = num / den;
  const float g_num = g_y / den;
  const float g_den = -g_y * y / den - 2.0f * g_l / den;
  // the log terms: log(wm) - log(w) on both pieces, then the piece's own
  float g_wm = g_l / wm;
  float g_w = -g_l / w;
  float g_lam, g_ym, g_y0, g_y1, g_wb, g_theta;
  if (use_a) {
    g_lam = g_l / lam + (g_num * y0 + g_den);
    g_ym = g_l / r + g_num * wm * theta;
    g_y0 = -g_l / r + g_num * (lam - theta);
    g_y1 = 0.0f;
    g_wb = 0.0f;
    g_theta = g_num * (wm * ym - y0) + g_den * (wm - 1.0f);
    g_wm += g_num * ym * theta + g_den * theta;
  } else {
    g_lam = -g_l / (1.0f - lam) + (-g_num * wb * y1 - g_den * wb);
    g_ym = -g_l / (y1 - ym) + g_num * wm * (1.0f - theta);
    g_y0 = 0.0f;
    g_y1 = g_l / (y1 - ym) + g_num * wb * (theta - lam);
    g_wb = g_l / wb + (g_num * y1 + g_den) * (theta - lam);
    g_theta = g_num * (wb * y1 - wm * ym) + g_den * (wb - wm);
    g_wm += g_num * ym * (1.0f - theta) + g_den * (1.0f - theta);
  }

  // theta = (x - x0) / w
  const float g_xin = g_theta / w;
  const float g_x0 = -g_xin;
  g_w -= g_theta * theta / w;
  // wm = d0 lam w / r, r = ym - y0
  float g_d0 = g_wm * lam * w / r;
  g_lam += g_wm * d0 * w / r;
  g_w += g_wm * d0 * lam / r;
  g_ym -= g_wm * wm / r;
  g_y0 += g_wm * wm / r;
  // ym = q_num / q_den
  const float g_qn = g_ym / q_den;
  const float g_qd = -g_ym * ym / q_den;
  g_lam += g_qn * (wb * y1 - y0) + g_qd * (wb - 1.0f);
  g_y0 += g_qn * (1.0f - lam);
  g_wb += g_qn * lam * y1 + g_qd * lam;
  g_y1 += g_qn * lam * wb;
  // wb = sqrt(d0 / d1); y1 = y0 + h
  g_d0 += g_wb * wb / (2.0f * d0);
  const float g_d1 = -g_wb * wb / (2.0f * d1);
  g_y0 += g_y1;
  const float g_h = g_y1;

  // edge sel carries g_x0 - g_w to the bins below sel, edge sel + 1 carries
  // g_w to the bins up to sel; then the softmax adjoint
  const float w_lo = first ? 0.0f : (two_b * wmix) * (g_x0 - g_w);
  const float w_hi = last ? 0.0f : (two_b * wmix) * g_w;
  const float h_lo = first ? 0.0f : (two_b * hmix) * (g_y0 - g_h);
  const float h_hi = last ? 0.0f : (two_b * hmix) * g_h;
  float wdot = 0.0f, hdot = 0.0f;
  for (int k = 0; k <= sel; ++k) {
    wdot += ((k < sel ? w_lo : 0.0f) + w_hi) * softmax_at(uw, k, stride, sw);
    hdot += ((k < sel ? h_lo : 0.0f) + h_hi) * softmax_at(uh, k, stride, sh);
  }
  for (int k = 0; k < K; ++k) {
    const float gw = (k < sel ? w_lo : 0.0f) + (k <= sel ? w_hi : 0.0f);
    const float gh = (k < sel ? h_lo : 0.0f) + (k <= sel ? h_hi : 0.0f);
    g_uw[k * stride] = wh_scale * softmax_at(uw, k, stride, sw) * (gw - wdot);
    g_uh[k * stride] = wh_scale * softmax_at(uh, k, stride, sh) * (gh - hdot);
    g_ul[k * stride] =
        k == sel ? g_lam * (1.0f - 2.0f * cfg.min_lambda) * sig_l * (1.0f - sig_l) : 0.0f;
  }

  // interior slopes: softplus' = sigmoid
  for (int k = 0; k < K - 1; ++k) {
    float g = 0.0f;
    if (!first && k == sel - 1) g += g_d0 * sigmoid(ud_lo);
    if (!last && k == sel) g += g_d1 * sigmoid(ud_hi);
    g_ud[k * stride] = g;
  }
  *g_x = inside ? g_xin : g_out;
}

}  // namespace nflows
