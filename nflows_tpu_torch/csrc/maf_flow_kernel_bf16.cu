// B9 with bf16 weights: a whole L-layer autoregressive flow (MAF, NSF-AR,
// IAF) in one launch, forward or by the D-step fixed point.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/maf_flow_kernel.py:_kernel
// with bf16 weights, the JAX package's default deployment
// (fuse_maf(dtype=bfloat16), CompiledFlow(dtype=bfloat16)), with and without
// a context. The kernel is maf_flow_kernel.cuh instantiated with
// __nv_bfloat16 weights; a source of its own so that nvcc builds it beside
// the fp32 one.
//
// What bf16 changes (tile_gemm.cuh): the masked matrices are stored and
// staged in bf16, half the bytes streamed from L2 (and re-streamed D + 1
// times a layer by the fixed point), widened exactly in registers; each
// GEMM's activation operand is rounded to bf16 (nearest even) where it is
// loaded or, for a block's inner activation, where it is stored, so every
// product is exact in fp32 as in the TPU kernel's _dot.
// The fixed point iterates on those GEMMs; the transformer, its operand and
// the logabsdet stay fp32. The FMAs stay fp32 on the CUDA cores, so the
// kernel is bound as the fp32 one is, plus the rounding; its ideal bound is
// the same operation count on the bf16 tensor cores (989 TFLOP/s dense).
#include "maf_flow_kernel.cuh"

using bf16 = __nv_bfloat16;

// The arguments of maf_flow_entry (maf_flow_kernel.cuh).
extern "C" int maf_flow_launch_bf16(
    const float* x, const float* ctx, float* y, float* lad, int64_t n, int D, int L, int H,
    int D4, int P, int Pp, int nb2, int C, int C4, const bf16* wi, const float* bi,
    const bf16* wb, const float* bb, const bf16* wf, const float* bf, const bf16* wci,
    const float* bci, const bf16* wcb, const float* bcb, const int* idx, int inverse,
    int transformer, float wh_scale, int num_bins, float tail_bound, float min_bin_width,
    float min_bin_height, float min_derivative, int rows_per_block, void* stream) {
  return maf_flow_entry(x, ctx, y, lad, n, D, L, H, D4, P, Pp, nb2, C, C4, wi, bi, wb, bb, wf, bf,
                        wci, bci, wcb, bcb, idx, inverse, transformer, wh_scale, num_bins,
                        tail_bound, min_bin_width, min_bin_height, min_derivative,
                        rows_per_block, stream);
}
