// B9's fixed-point direction with bf16 weights, solved in the order of the
// MADE's degrees (fuse_maf(dtype=bfloat16), CompiledFlow(dtype=bfloat16)),
// with and without a context.
//
// Replaces the fixed-point branch of the TPU kernel
// nflows_tpu/ops/pallas/maf_flow_kernel.py:_kernel with bf16 weights. The
// kernel is maf_degree_inverse.cuh instantiated with __nv_bfloat16 slabs,
// a source of its own so that nvcc builds it beside the fp32 one: the slabs
// take half the bytes (a ring slot holds twice the rows), each GEMM's
// activation operand is rounded to bf16 as tile_gemm.cuh rounds it, and
// the products are summed in fp32 on the CUDA cores.
//
// Bound on the H100: the same operation count; on the bf16 tensor cores
// (989 TFLOP/s dense) its ideal bound, which the SIMT FMAs do not reach.
#include "maf_degree_inverse.cuh"

using bf16 = __nv_bfloat16;

// The arguments of degree::maf_degree_entry (maf_degree_inverse.cuh).
extern "C" int maf_degree_launch_bf16(
    const float* x, const float* ctx, float* y, float* lad, int64_t n, int D, int L, int H,
    int M, int nb, int C, const bf16* stream, const int* chunks, int nchunks,
    const int* offsets, const float* bi, const float* bb, const float* bf, const float* bci,
    const float* bcb, const int* idx, int inverse, int transformer, float wh_scale,
    int num_bins, float tail_bound, float min_bin_width, float min_bin_height,
    float min_derivative, int rows, void* cuda_stream) {
  return degree::maf_degree_entry(x, ctx, y, lad, n, D, L, H, M, nb, C, stream, chunks, nchunks,
                                  offsets, bi, bb, bf, bci, bcb, idx, inverse, transformer,
                                  wh_scale, num_bins, tail_bound, min_bin_width, min_bin_height,
                                  min_derivative, rows, cuda_stream);
}
