// The coupling stage of the whole-chain kernels (nsf_flow_kernel.cu, B2;
// nsf_train.cu, B3 and B4): one element of one of the seven families the
// TPU kernel's _SPLINES_TR table holds (nflows_tpu/ops/pallas/
// nsf_flow_kernel.py:1049-1056): rq, lrs, linear, quadratic and cubic
// splines with linear tails, and the affine and additive couplings.
//
// The conditioner's output P is a shared-memory tile whose rows are
// K-major, parameter j of transformed feature t at row j T + t (affine:
// shift rows, then scale rows), so the M parameters of one element lie
// `stride` floats apart. Each family's math is its own header's, shared
// with the elementwise kernels B1 and B5-B8:
//   rq         widths [0, K), heights [K, 2K), interior derivatives [2K, 3K-1)
//   lrs        widths, heights, lambdas [2K, 3K), derivatives [3K, 4K-1)
//   linear     the unnormalised pdf [0, K)
//   quadratic  widths [0, K), interior heights [K, 2K-1)
//   cubic      widths, heights, left and right boundary derivatives 2K, 2K+1
//   affine     shift 0, unconstrained scale 1; additive: shift 0
// The boundary derivatives of the rq and lrs splines are `edge_derivative`
// of their config: exactly 1 for rq, as the TPU kernel has it, and the
// float32 evaluation of the padding constant for lrs, as its plain version
// and B5 have it.
#pragma once

#include "affine_coupling.cuh"
#include "cubic_spline.cuh"
#include "linear_spline.cuh"
#include "lrs_spline.cuh"
#include "quadratic_spline.cuh"
#include "rq_spline.cuh"

namespace nflows {

enum CouplingFamily {
  kRQ = 0,
  kLRS = 1,
  kLinear = 2,
  kQuadratic = 3,
  kCubic = 4,
  kAffine = 5,
  kAdditive = 6,
};

struct StageConfig {
  int family;     // CouplingFamily
  int scale_act;  // ScaleActivation (affine and additive)
  RQConfig rq;
  LRSConfig lrs;
  LinearConfig linear;
  QuadraticConfig quadratic;
  CubicConfig cubic;
};

// Every family's config from the host's values; num_bins is 0 for the
// affine and additive couplings.
inline StageConfig make_stage_config(int family, int scale_act, int num_bins, float tail_bound,
                                     float min_bin_width, float min_bin_height,
                                     float min_derivative, float min_lambda,
                                     float edge_derivative, float log_inv_bins) {
  StageConfig c;
  c.family = family;
  c.scale_act = family == kAdditive ? kScaleNone : scale_act;
  c.rq = RQConfig{num_bins, tail_bound, min_bin_width, min_bin_height, min_derivative,
                  edge_derivative};
  c.lrs = LRSConfig{num_bins, tail_bound, min_bin_width, min_bin_height, min_derivative,
                    min_lambda, edge_derivative};
  c.linear = LinearConfig{num_bins, tail_bound, log_inv_bins};
  c.quadratic = QuadraticConfig{num_bins, tail_bound, min_bin_width, min_bin_height};
  c.cubic = CubicConfig{num_bins, tail_bound, min_bin_width, min_bin_height};
  return c;
}

// The stage of family FAMILY, fixed at compile time: B2 instantiates its
// kernel once a family, so each instantiation holds one stage's code and
// the rq chain compiles as it did before the other stages came.
template <int FAMILY>
__device__ __forceinline__ void coupling_stage(float x, const float* P, int stride,
                                               bool inverse, const StageConfig& c, float* out,
                                               float* lad) {
  const int K = c.rq.num_bins;
  if constexpr (FAMILY == kRQ) {
    rq_spline_eval(x, P, P + K * stride, P + 2 * K * stride, stride, inverse, c.rq, out, lad);
  } else if constexpr (FAMILY == kLRS) {
    lrs_spline_eval(x, P, P + K * stride, P + 3 * K * stride, P + 2 * K * stride, stride,
                    inverse, c.lrs, out, lad);
  } else if constexpr (FAMILY == kLinear) {
    linear_spline_eval(x, P, stride, inverse, c.linear, out, lad);
  } else if constexpr (FAMILY == kQuadratic) {
    quadratic_spline_eval(x, P, P + K * stride, stride, inverse, c.quadratic, out, lad);
  } else if constexpr (FAMILY == kCubic) {
    cubic_spline_eval(x, P, P + K * stride, P[2 * K * stride], P[(2 * K + 1) * stride], stride,
                      inverse, c.cubic, out, lad);
  } else {  // kAffine, kAdditive (scale_act kScaleNone)
    affine_coupling_eval(x, P, stride, inverse, c.scale_act, out, lad);
  }
}

// The stage of the family c.family, chosen at run time (B3 and B4).
__device__ __forceinline__ void coupling_stage_eval(float x, const float* P, int stride,
                                                    bool inverse, const StageConfig& c,
                                                    float* out, float* lad) {
  switch (c.family) {
    case kRQ: coupling_stage<kRQ>(x, P, stride, inverse, c, out, lad); break;
    case kLRS: coupling_stage<kLRS>(x, P, stride, inverse, c, out, lad); break;
    case kLinear: coupling_stage<kLinear>(x, P, stride, inverse, c, out, lad); break;
    case kQuadratic: coupling_stage<kQuadratic>(x, P, stride, inverse, c, out, lad); break;
    case kCubic: coupling_stage<kCubic>(x, P, stride, inverse, c, out, lad); break;
    default: coupling_stage<kAffine>(x, P, stride, inverse, c, out, lad);
  }
}

}  // namespace nflows
