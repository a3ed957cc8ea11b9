// B6: elementwise linear-tail piecewise-linear spline, forward or inverse,
// with the per-element logabsdet.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/linear_spline.py:_kernel.
//
// Bound on the H100: memory. Each element reads x and K parameters and
// writes two values (44 bytes at K = 8) for well under a hundred
// floating-point operations. At the serving shape (4,096 x 3 elements a
// coupling) the launch itself is the cost.
//
// Design: one thread per element on the JAX public layout ([..., K] rows),
// math in linear_spline.cuh for the whole-chain kernel's family stage.
#include <cuda_runtime.h>
#include <stdint.h>

#include "linear_spline.cuh"

namespace {

__global__ void __launch_bounds__(256) linear_spline_kernel(
    const float* __restrict__ x, const float* __restrict__ up,
    float* __restrict__ out, float* __restrict__ lad, int64_t n, int inverse,
    nflows::LinearConfig cfg) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  nflows::linear_spline_eval(x[i], up + i * cfg.num_bins, 1, inverse != 0, cfg,
                             out + i, lad + i);
}

}  // namespace

extern "C" int linear_spline_launch(const float* x, const float* up,
                                    float* out, float* lad, int64_t n,
                                    int num_bins, int inverse,
                                    float tail_bound, float log_inv_bins,
                                    void* stream) {
  if (n == 0) return 0;
  nflows::LinearConfig cfg{num_bins, tail_bound, log_inv_bins};
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  linear_spline_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, up, out, lad, n, inverse, cfg);
  return (int)cudaGetLastError();
}
