// B1: elementwise linear-tail rational-quadratic spline, forward or inverse,
// with the per-element logabsdet.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/rq_spline.py:_kernel.
//
// Bound on the H100: memory. Each element reads x and 3K-1 parameters and
// writes two values (about 104 bytes at K = 8) for a few hundred
// floating-point operations, well below the card's ratio of operations to
// bytes. At the serving shape (4,096 x 3 elements a coupling) the launch
// itself is the cost.
//
// Design: one thread per element, in the JAX public layout ([..., K]
// parameter rows, K-1 interior derivatives), so the coupling hands over its
// parameter tensors without a transpose. The boundary derivative is passed
// in (min_derivative + softplus(pad constant), computed by the wrapper), so
// no padded derivative tensor is built. A thread reads its K contiguous
// parameters three times; the second and third reads hit L1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rq_spline.cuh"

namespace {

__global__ void __launch_bounds__(256) rq_spline_kernel(
    const float* __restrict__ x, const float* __restrict__ uw,
    const float* __restrict__ uh, const float* __restrict__ ud,
    float* __restrict__ out, float* __restrict__ lad, int64_t n, int inverse,
    nflows::RQConfig cfg) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int K = cfg.num_bins;
  nflows::rq_spline_eval(x[i], uw + i * K, uh + i * K, ud + i * (K - 1), 1,
                         inverse != 0, cfg, out + i, lad + i);
}

}  // namespace

extern "C" int rq_spline_launch(const float* x, const float* uw,
                                const float* uh, const float* ud, float* out,
                                float* lad, int64_t n, int num_bins,
                                int inverse, float tail_bound,
                                float min_bin_width, float min_bin_height,
                                float min_derivative, float edge_derivative,
                                void* stream) {
  if (n == 0) return 0;
  nflows::RQConfig cfg{num_bins, tail_bound, min_bin_width, min_bin_height,
                       min_derivative, edge_derivative};
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  rq_spline_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, uw, uh, ud, out, lad, n, inverse, cfg);
  return (int)cudaGetLastError();
}
