// B8: elementwise linear-tail monotone cubic spline, forward or inverse,
// with the per-element logabsdet.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/cubic_spline.py:_kernel.
//
// Bound on the H100: memory. Each element reads x and 2K+2 parameters and
// writes two values (84 bytes at K = 8); the forward does about a hundred
// floating-point operations, the inverse adds 30 bisection halvings of
// about eight, still below the card's ratio of operations to bytes. At the
// serving shape (4,096 x 3 elements a coupling) the launch itself is the
// cost.
//
// Design: one thread per element on the JAX public layout ([..., K] widths
// and heights, [..., 1] boundary parameters), math in cubic_spline.cuh for
// the whole-chain kernel's family stage.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cubic_spline.cuh"

namespace {

__global__ void __launch_bounds__(256) cubic_spline_kernel(
    const float* __restrict__ x, const float* __restrict__ uw,
    const float* __restrict__ uh, const float* __restrict__ dl,
    const float* __restrict__ dr, float* __restrict__ out,
    float* __restrict__ lad, int64_t n, int inverse, nflows::CubicConfig cfg) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int K = cfg.num_bins;
  nflows::cubic_spline_eval(x[i], uw + i * K, uh + i * K, dl[i], dr[i], 1,
                            inverse != 0, cfg, out + i, lad + i);
}

}  // namespace

extern "C" int cubic_spline_launch(const float* x, const float* uw,
                                   const float* uh, const float* dl,
                                   const float* dr, float* out, float* lad,
                                   int64_t n, int num_bins, int inverse,
                                   float tail_bound, float min_bin_width,
                                   float min_bin_height, void* stream) {
  if (n == 0) return 0;
  nflows::CubicConfig cfg{num_bins, tail_bound, min_bin_width, min_bin_height};
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  cubic_spline_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, uw, uh, dl, dr, out, lad, n, inverse, cfg);
  return (int)cudaGetLastError();
}
