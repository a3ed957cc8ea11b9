// B2 with fp32 weights: the whole L-layer coupling chain in one launch.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/nsf_flow_kernel.py:_kernel
// with fp32 weights (fuse_nsf(dtype=float32) and the trainers'
// composable route), with and without a per-sample context. The kernel is
// nsf_flow_kernel.cuh instantiated with float weights.
//
// Bound on the H100: operations, 2 N L (Tid H + C H + 4 H^2 + nb C H
// + H TM) fp32 FLOP on the CUDA cores (67 TFLOP/s); at the flagship about
// 5.6 MFLOP a sample against 28 bytes a sample of inputs and outputs.
#include "nsf_flow_kernel.cuh"

// The arguments of nsf_flow_entry (nsf_flow_kernel.cuh).
extern "C" int nsf_flow_launch(
    const float* x, float* y, float* lad, int64_t n, int D, int L, int H, int Tid, int I4, int T,
    int TM, int TMp, int nb2, const float* w0, const float* b0, const float* wb, const float* bb,
    const float* wf, const float* bf, const int* idx, int inverse, int family, int scale_act,
    int num_bins, float wh_scale, float tail_bound, float min_bin_width, float min_bin_height,
    float min_derivative, float min_lambda, float edge_derivative, float log_inv_bins,
    const float* ctx, int C, const float* wc0, const float* wcb, const float* bcb,
    int rows_per_block, void* stream) {
  return nsf_flow_entry(x, y, lad, n, D, L, H, Tid, I4, T, TM, TMp, nb2, w0, b0, wb, bb, wf, bf,
                        idx, inverse, family, scale_act, num_bins, wh_scale, tail_bound,
                        min_bin_width, min_bin_height, min_derivative, min_lambda,
                        edge_derivative, log_inv_bins, ctx, C, wc0, wcb, bcb, rows_per_block,
                        stream);
}
