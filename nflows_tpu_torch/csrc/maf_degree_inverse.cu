// B9's fixed-point direction with fp32 weights, solved in the order of the
// MADE's degrees: MAF and NSF-AR sampling (the inverse), the IAF's density
// direction (wrapped layers going forward), with and without a context.
//
// Replaces the fixed-point branch of the TPU kernel
// nflows_tpu/ops/pallas/maf_flow_kernel.py:_kernel with fp32 weights. The
// kernel is maf_degree_inverse.cuh instantiated with float weights.
//
// Bound on the H100: operations, 2 (nnz(masks) + (1 + nb) C H) fp32 FLOP a
// sample a layer on the CUDA cores (67 TFLOP/s), one masked MADE pass.
#include "maf_degree_inverse.cuh"

// The arguments of degree::maf_degree_entry (maf_degree_inverse.cuh).
extern "C" int maf_degree_launch(
    const float* x, const float* ctx, float* y, float* lad, int64_t n, int D, int L, int H,
    int M, int nb, int C, const float* stream, const int* chunks, int nchunks,
    const int* offsets, const float* bi, const float* bb, const float* bf, const float* bci,
    const float* bcb, const int* idx, int inverse, int transformer, float wh_scale,
    int num_bins, float tail_bound, float min_bin_width, float min_bin_height,
    float min_derivative, int rows, void* cuda_stream) {
  return degree::maf_degree_entry(x, ctx, y, lad, n, D, L, H, M, nb, C, stream, chunks, nchunks,
                                  offsets, bi, bb, bf, bci, bcb, idx, inverse, transformer,
                                  wh_scale, num_bins, tail_bound, min_bin_width, min_bin_height,
                                  min_derivative, rows, cuda_stream);
}
