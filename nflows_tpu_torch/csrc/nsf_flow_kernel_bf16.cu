// B2 with bf16 weights: the whole L-layer coupling chain in one launch.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/nsf_flow_kernel.py:_kernel
// with bf16 weights, the JAX package's default deployment
// (fuse_nsf(dtype=bfloat16), NeuralSplineFlow.fused(), CompiledFlow(dtype=
// bfloat16)), with and without a per-sample context. The kernel is
// nsf_flow_kernel.cuh instantiated with __nv_bfloat16 weights; a source of
// its own so that nvcc builds it beside the fp32 one.
//
// What bf16 changes (tile_gemm.cuh): the matrices are stored and staged in
// bf16, half the bytes streamed from L2, and widened exactly in registers;
// each GEMM's activation operand is rounded to bf16 (nearest even), where
// it is loaded or, for a block's inner activation, where it is stored, so
// every product is exact in fp32 as in the TPU kernel's
// _dot with preferred_element_type=float32. The FMAs stay fp32 on the CUDA
// cores, so the kernel is bound as the fp32 one is, by its fp32 FMAs, plus
// the rounding. Its ideal bound is the same operation count on the bf16
// tensor cores (989 TFLOP/s dense), which this kernel does not use.
#include "nsf_flow_kernel.cuh"

using bf16 = __nv_bfloat16;

// The arguments of nsf_flow_entry (nsf_flow_kernel.cuh).
extern "C" int nsf_flow_launch_bf16(
    const float* x, float* y, float* lad, int64_t n, int D, int L, int H, int Tid, int I4, int T,
    int TM, int TMp, int nb2, const bf16* w0, const float* b0, const bf16* wb, const float* bb,
    const bf16* wf, const float* bf, const int* idx, int inverse, int family, int scale_act,
    int num_bins, float wh_scale, float tail_bound, float min_bin_width, float min_bin_height,
    float min_derivative, float min_lambda, float edge_derivative, float log_inv_bins,
    const float* ctx, int C, const bf16* wc0, const bf16* wcb, const float* bcb,
    int rows_per_block, void* stream) {
  return nsf_flow_entry(x, y, lad, n, D, L, H, Tid, I4, T, TM, TMp, nb2, w0, b0, wb, bb, wf, bf,
                        idx, inverse, family, scale_act, num_bins, wh_scale, tail_bound,
                        min_bin_width, min_bin_height, min_derivative, min_lambda,
                        edge_derivative, log_inv_bins, ctx, C, wc0, wcb, bcb, rows_per_block,
                        stream);
}
