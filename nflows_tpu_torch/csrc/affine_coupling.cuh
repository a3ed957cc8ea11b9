// Affine (RealNVP) and additive (NICE) coupling stage, for one element, and
// the adjoint of its forward direction.
//
// Mirrors the TPU kernel's stage (nflows_tpu/ops/pallas/nsf_flow_kernel.py
// _affine_TR) and the couplings (transforms/coupling.py:152-204): the
// conditioner gives the shift at P[0] and, for the affine coupling, the
// unconstrained scale at P[stride]. The scale activation is
//   default: sigmoid(raw + 2) + 1e-3,
//   general: clip(softplus(raw) + 1e-3, 0, 3),
//   none (additive): scale 1, logabsdet 0.
// Forward y = x * scale + shift, logabsdet log(scale); inverse
// x = (y - shift) / scale, logabsdet -log(scale).
//
// The adjoint is written out for the training kernels B3 and B4 (the TPU
// kernels take it from jax.vjp): with s = scale(raw),
//   g_x = g_y s,  g_shift = g_y,  g_raw = (g_y x + g_lad / s) s',
// s' = sigma (1 - sigma) at raw + 2 (default), sigmoid(raw) where
// softplus(raw) + 1e-3 <= 3 and 0 above (general; at exactly 3 the clip
// passes the gradient, as torch.clamp's backward does); the additive stage
// passes g_x = g_y and g_shift = g_y.
#pragma once

#include "spline_common.cuh"

namespace nflows {

enum ScaleActivation { kScaleDefault = 0, kScaleGeneral = 1, kScaleNone = 2 };

__device__ __forceinline__ float affine_scale(float raw, int act) {
  if (act == kScaleDefault) return sigmoid(raw + 2.0f) + 1e-3f;
  return fminf(fmaxf(softplus(raw) + 1e-3f, 0.0f), 3.0f);
}

// P: the shift at P[0], the unconstrained scale at P[stride] (not read for
// the additive stage).
__device__ __forceinline__ void affine_coupling_eval(float x, const float* P, int stride,
                                                     bool inverse, int act, float* out,
                                                     float* lad) {
  const float shift = P[0];
  if (act == kScaleNone) {
    *out = inverse ? x - shift : x + shift;
    *lad = 0.0f;
    return;
  }
  const float scale = affine_scale(P[stride], act);
  const float log_scale = logf(scale);
  if (inverse) {
    *out = (x - shift) / scale;
    *lad = -log_scale;
  } else {
    *out = x * scale + shift;
    *lad = log_scale;
  }
}

// Cotangents of the forward stage: g_x, and g_shift at G[0], g_raw at
// G[stride] (affine only).
__device__ __forceinline__ void affine_coupling_forward_adjoint(
    float x, const float* P, int stride, int act, float g_out, float g_lad, float* g_x,
    float* G) {
  G[0] = g_out;
  if (act == kScaleNone) {
    *g_x = g_out;
    return;
  }
  const float raw = P[stride];
  float scale, dscale;
  if (act == kScaleDefault) {
    const float sg = sigmoid(raw + 2.0f);
    scale = sg + 1e-3f;
    dscale = sg * (1.0f - sg);
  } else {
    const float sp = softplus(raw) + 1e-3f;
    scale = fminf(fmaxf(sp, 0.0f), 3.0f);
    dscale = sp <= 3.0f ? sigmoid(raw) : 0.0f;
  }
  *g_x = g_out * scale;
  G[stride] = (g_out * x + g_lad / scale) * dscale;
}

}  // namespace nflows
