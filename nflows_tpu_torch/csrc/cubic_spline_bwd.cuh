// Adjoint of the linear-tail cubic spline's forward branch, for one element,
// by explicit formulas.
//
// The TPU training kernels (nflows_tpu/ops/pallas/nsf_train.py) get this
// adjoint from jax.vjp traced inside the kernel; here it is derived by hand
// from cubic_spline_eval (cubic_spline.cuh, inverse = false) for kernels B3
// and B4, which run the forward only, so the bisection of the inverse needs
// no adjoint. Its plain PyTorch version is
// ops/splines/cubic.py:cubic_spline_forward_adjoint_plain, which repeats
// this arithmetic line for line and is held against autograd.
//
// What flows where. The selected bin's cubic a t^3 + b t^2 + c t + d
// (clipped to [0, 1]; a clipped output carries no gradient) and logabsdet
// log(3 a t^2 + 2 b t + c) depend on the bin's width and slope, the knot
// derivatives d0 and d1 at its ends, and the widths and heights below it
// (t's origin and d). An interior knot derivative is Steffen's
// min(min(|s_{k-1}|, |s_k|), m2) (sign(s_{k-1}) + sign(s_k)); its cotangent
// follows the branch fminf took (an exact tie does not occur with real
// parameters), to the slopes and widths of the two bins beside the knot. At
// the ends it is 3 sigmoid(p) times the end bin's slope. Slopes are h / w;
// the softmax sends every width and height cotangent to all K parameters.
//
// The width and height cotangents are gathered in g_uw and g_uh (with the
// parameters' stride) before the softmax adjoints read them back: nothing
// K-long is held in registers. g_uw and g_uh are multiplied by wh_scale (the
// caller scales widths and heights), g_dl and g_dr are not.
#pragma once

#include "cubic_spline.cuh"

namespace nflows {

// g_uw, g_uh: K entries at [k * stride]; g_dl, g_dr: one each.
__device__ __forceinline__ void cubic_spline_forward_adjoint(
    float x_orig, const float* uw, const float* uh, float dl, float dr, int stride,
    const CubicConfig& cfg, float g_out, float g_lad, float wh_scale, float* g_x, float* g_uw,
    float* g_uh, float* g_dl, float* g_dr) {
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

  // the forward's walk over the bins
  float runw = 0.0f, runh = 0.0f, cw_lo = 0.0f, ch_lo = 0.0f;
  int sel = 0;
  float left_w = 0.0f, sel_ch = 0.0f;
  for (int k = 0; k < K; ++k) {
    runw += width(k);
    runh += height(k);
    if (k == 0 || x >= cw_lo) {
      sel = k;
      left_w = cw_lo;
      sel_ch = ch_lo;
    }
    cw_lo = (k == K - 1) ? 1.0f : runw;
    ch_lo = (k == K - 1) ? 1.0f : runh;
  }

  auto derivative = [&](int k) {
    if (k == 0) return sigmoid(dl) * 3.0f * slope(0);
    if (k == K) return sigmoid(dr) * 3.0f * slope(K - 1);
    const float sp = slope(k - 1), sn = slope(k);
    const float wp = width(k - 1), wn = width(k);
    const float m1 = fminf(fabsf(sp), fabsf(sn));
    const float m2 = 0.5f * (wn * sp + wp * sn) / (wp + wn);
    return fminf(m1, m2) * (sign0(sp) + sign0(sn));
  };
  const float ws = width(sel), ss = slope(sel);
  const float d0 = derivative(sel), d1 = derivative(sel + 1);
  const float a = (d0 + d1 - 2.0f * ss) / (ws * ws);
  const float b = (3.0f * ss - 2.0f * d0 - d1) / ws;
  const float c = d0;
  const float t = x - left_w;
  const float raw = a * (t * t * t) + b * (t * t) + c * t + sel_ch;
  const float q = 3.0f * a * (t * t) + 2.0f * b * t + c;

  // cotangents of the cubic's coefficients and of t
  const float g_y = inside ? g_out : 0.0f;
  const float g_l = inside ? g_lad : 0.0f;
  const float g_raw = (raw >= 0.0f && raw <= 1.0f) ? g_y * (2.0f * B) : 0.0f;
  const float g_q = g_l / q;
  const float g_a = g_raw * (t * t * t) + 3.0f * g_q * (t * t);
  const float g_b = g_raw * (t * t) + 2.0f * g_q * t;
  const float g_c = g_raw * t + g_q;
  const float g_d = g_raw;
  const float g_t = g_raw * q + g_q * (6.0f * a * t + 2.0f * b);
  const float g_d0 = g_a / (ws * ws) - 2.0f * g_b / ws + g_c;
  const float g_d1 = g_a / (ws * ws) - g_b / ws;
  const float g_ss = -2.0f * g_a / (ws * ws) + 3.0f * g_b / ws;
  const float g_ws = -2.0f * a * g_a / ws - b * g_b / ws;

  // width cotangents gather in g_uw, slope cotangents in g_uh (turned into
  // height cotangents below): t's origin and d sum the bins below sel
  for (int k = 0; k < K; ++k) {
    g_uw[k * stride] = (k < sel ? -g_t : 0.0f) + (k == sel ? g_ws : 0.0f);
    g_uh[k * stride] = k == sel ? g_ss : 0.0f;
  }
  float gdl = 0.0f, gdr = 0.0f;
  // knot derivative k's cotangent to the slopes and widths beside knot k, or
  // to a boundary parameter
  auto derivative_adjoint = [&](int k, float g_k) {
    if (k == 0) {
      const float s = sigmoid(dl);
      gdl += g_k * 3.0f * slope(0) * s * (1.0f - s);
      g_uh[0] += g_k * s * 3.0f;
      return;
    }
    if (k == K) {
      const float s = sigmoid(dr);
      gdr += g_k * 3.0f * slope(K - 1) * s * (1.0f - s);
      g_uh[(K - 1) * stride] += g_k * s * 3.0f;
      return;
    }
    const float sp = slope(k - 1), sn = slope(k);
    const float wp = width(k - 1), wn = width(k);
    const float m1 = fminf(fabsf(sp), fabsf(sn));
    const float den = wp + wn;
    const float m2 = 0.5f * (wn * sp + wp * sn) / den;
    const float g_m = g_k * (sign0(sp) + sign0(sn));
    const bool take_m1 = m1 <= m2;
    const bool take_sp = fabsf(sp) <= fabsf(sn);
    const float g_m1 = take_m1 ? g_m : 0.0f;
    const float g_m2 = take_m1 ? 0.0f : g_m;
    const float g_n = g_m2 * 0.5f / den;
    const float g_den = -g_m2 * m2 / den;
    g_uh[(k - 1) * stride] += (take_sp ? g_m1 * sign0(sp) : 0.0f) + g_n * wn;
    g_uh[k * stride] += (take_sp ? 0.0f : g_m1 * sign0(sn)) + g_n * wp;
    g_uw[(k - 1) * stride] += g_n * sn + g_den;
    g_uw[k * stride] += g_n * sp + g_den;
  };
  derivative_adjoint(sel, g_d0);
  derivative_adjoint(sel + 1, g_d1);

  // slopes h / w, then the softmax adjoints
  for (int k = 0; k < K; ++k) {
    const float wk = width(k), g_s = g_uh[k * stride];
    g_uh[k * stride] = (k < sel ? g_d : 0.0f) + g_s / wk;
    g_uw[k * stride] -= g_s * (height(k) / wk) / wk;
  }
  float wdot = 0.0f, hdot = 0.0f;
  for (int k = 0; k < K; ++k) {
    wdot += (wmix * g_uw[k * stride]) * softmax_at(uw, k, stride, sw);
    hdot += (hmix * g_uh[k * stride]) * softmax_at(uh, k, stride, sh);
  }
  for (int k = 0; k < K; ++k) {
    g_uw[k * stride] =
        wh_scale * softmax_at(uw, k, stride, sw) * (wmix * g_uw[k * stride] - wdot);
    g_uh[k * stride] =
        wh_scale * softmax_at(uh, k, stride, sh) * (hmix * g_uh[k * stride] - hdot);
  }
  *g_dl = gdl;
  *g_dr = gdr;
  *g_x = inside ? g_t / (2.0f * B) : g_out;
}

}  // namespace nflows
