// Bin helpers shared by the linear-rational, linear, quadratic and cubic
// spline device functions (lrs_spline.cuh, linear_spline.cuh,
// quadratic_spline.cuh, cubic_spline.cuh), as _spline_common.py serves the
// TPU kernels: the softmax over a row of K unnormalised bin sizes and the
// min-size mixing of normalize_bins. The K values of a row are read at
// u[k * stride], so one function reads a [..., K] row (stride 1) or a
// K-major shared-memory tile (stride T). softplus comes from rq_spline.cuh.
#pragma once

#include <math.h>

#include "rq_spline.cuh"

namespace nflows {

// The maximum of a row and 1 / sum(exp(u_k - max)).
struct Softmax {
  float vmax;
  float inv;
};

__device__ __forceinline__ Softmax softmax_of(const float* u, int K, int stride) {
  float m = u[0];
  for (int k = 1; k < K; ++k) m = fmaxf(m, u[k * stride]);
  float s = 0.0f;
  for (int k = 0; k < K; ++k) s += expf(u[k * stride] - m);
  return {m, 1.0f / s};
}

// softmax_k itself (linear spline: no minimum size)
__device__ __forceinline__ float softmax_at(const float* u, int k, int stride,
                                            Softmax sm) {
  return expf(u[k * stride] - sm.vmax) * sm.inv;
}

// min_size + (1 - K min_size) softmax_k (normalize_bins)
__device__ __forceinline__ float bin_size(const float* u, int k, int stride,
                                          Softmax sm, float min_size, float mix) {
  return min_size + mix * softmax_at(u, k, stride, sm);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

}  // namespace nflows
