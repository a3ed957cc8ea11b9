// B9 with fp32 weights: a whole L-layer autoregressive flow (MAF, NSF-AR,
// IAF) in one launch, forward or by the D-step fixed point.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/maf_flow_kernel.py:_kernel
// with fp32 weights (fuse_maf(dtype=float32) and the fused MAF and IAF
// trainers), with and without a context. The kernel is maf_flow_kernel.cuh
// instantiated with float weights.
//
// Bound on the H100: operations, 2 (D H + 2 nb H^2 + H P) fp32 FLOP a
// sample a MADE pass on the CUDA cores (67 TFLOP/s), one pass a layer
// forward and D + 1 coming back, against 4 (2 D + 1) bytes a sample.
#include "maf_flow_kernel.cuh"

// The arguments of maf_flow_entry (maf_flow_kernel.cuh).
extern "C" int maf_flow_launch(
    const float* x, const float* ctx, float* y, float* lad, int64_t n, int D, int L, int H,
    int D4, int P, int Pp, int nb2, int C, int C4, const float* wi, const float* bi,
    const float* wb, const float* bb, const float* wf, const float* bf, const float* wci,
    const float* bci, const float* wcb, const float* bcb, const int* idx, int inverse,
    int transformer, float wh_scale, int num_bins, float tail_bound, float min_bin_width,
    float min_bin_height, float min_derivative, int rows_per_block, void* stream) {
  return maf_flow_entry(x, ctx, y, lad, n, D, L, H, D4, P, Pp, nb2, C, C4, wi, bi, wb, bb, wf, bf,
                        wci, bci, wcb, bcb, idx, inverse, transformer, wh_scale, num_bins,
                        tail_bound, min_bin_width, min_bin_height, min_derivative,
                        rows_per_block, stream);
}
