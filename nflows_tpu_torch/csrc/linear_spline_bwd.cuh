// Adjoint of the linear-tail linear spline's forward branch, for one
// element, by explicit formulas.
//
// The TPU training kernels (nflows_tpu/ops/pallas/nsf_train.py) get this
// adjoint from jax.vjp traced inside the kernel; here it is derived by hand
// from linear_spline_eval (linear_spline.cuh, inverse = false) for kernels
// B3 and B4. Its plain PyTorch version is
// ops/splines/linear.py:linear_spline_forward_adjoint_plain, which repeats
// this arithmetic line for line and is held against autograd.
//
// What flows where. On the unit interval the output is cdf_idx + alpha
// pdf_idx, clipped to [0, 1] (a clipped output carries no gradient), with
// idx = floor(u K) piecewise constant; the logabsdet is log(pdf_idx) -
// log(1/K). The cdf sums the pdf below idx, so the softmax adjoint gets g_cdf
// on every bin below idx and g_pdf on bin idx, and its dot product is
// g_cdf cdf + g_pdf pdf_idx. Outside [-B, B] the layer is the identity.
//
// Parameters are read, and their cotangents written, with a stride as in
// linear_spline_eval. g_up is multiplied by wh_scale, the factor the caller
// applied to the parameters before the spline read them.
#pragma once

#include "linear_spline.cuh"

namespace nflows {

// g_up: K entries at [k * stride].
__device__ __forceinline__ void linear_spline_forward_adjoint(
    float x_orig, const float* up, int stride, const LinearConfig& cfg, float g_out,
    float g_lad, float wh_scale, float* g_x, float* g_up) {
  const int K = cfg.num_bins;
  const float B = cfg.tail_bound;
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float x = (fminf(fmaxf(x_orig, -B), B) + B) / (2.0f * B);
  const Softmax sp = softmax_of(up, K, stride);

  const float bin_pos = x * (float)K;
  const float fidx = fminf(fmaxf(floorf(bin_pos), 0.0f), (float)(K - 1));
  const float alpha = bin_pos - fidx;
  const int idx = (int)fidx;
  float cdf = 0.0f;
  for (int k = 0; k < idx; ++k) cdf += softmax_at(up, k, stride, sp);
  const float pdf = softmax_at(up, idx, stride, sp);
  const float raw = cdf + alpha * pdf;

  const float g_y = inside ? g_out : 0.0f;
  const float g_l = inside ? g_lad : 0.0f;
  const float g_raw = (raw >= 0.0f && raw <= 1.0f) ? g_y * (2.0f * B) : 0.0f;
  const float g_pdf = g_raw * alpha + g_l / pdf;  // cotangent of pdf_idx
  const float g_x01 = g_raw * pdf * (float)K;

  // softmax adjoint: g_cdf = g_raw goes to every bin below idx
  const float dot = g_raw * cdf + g_pdf * pdf;
  for (int k = 0; k < K; ++k) {
    const float g = (k < idx ? g_raw : 0.0f) + (k == idx ? g_pdf : 0.0f);
    g_up[k * stride] = wh_scale * softmax_at(up, k, stride, sp) * (g - dot);
  }
  *g_x = inside ? g_x01 / (2.0f * B) : g_out;
}

}  // namespace nflows
