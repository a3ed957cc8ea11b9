// B9's one-pass direction with bf16 weights on the tensor cores: a whole
// L-layer autoregressive flow in one launch where every layer runs one MADE
// pass in the requested direction (a MAF's or NSF-AR's log_prob, an IAF's
// sample).
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/maf_flow_kernel.py:_kernel
// with bf16 weights, the JAX package's default deployment
// (fuse_maf(dtype=bfloat16), CompiledFlow(dtype=bfloat16)), on those
// chains, with and without a per-sample context, where the widths suit
// wgmma (ops/cuda/maf_flow_kernel.py: gemm_route); csrc/maf_flow_kernel_bf16.cu
// takes every other one-pass chain. The kernel is maf_flow_wgmma.cuh
// instantiated with __nv_bfloat16 weights: the TPU kernel's _dot, both
// operands bf16 (the activation rounded where the epilogue writes it), the
// exact products summed in fp32 on bf16 wgmma.
//
// Bound on the H100: operations, M FLOP the masks leave at 989 TFLOP/s
// (0.0062 ms for the MAF at N = 4,096); each tile reads the 2.9 MB bf16
// image from L2.
#include "maf_flow_wgmma.cuh"

// The arguments of maf_wgmma_entry (maf_flow_wgmma.cuh).
extern "C" int maf_wgmma_launch_bf16(
    const float* x, const float* ctx, float* y, float* lad, int64_t n, int D, int L, int H,
    int Ip, int P, int TMp, int nb, int C, int Cp, const void* image, int64_t layer_bytes,
    const float* bi, const float* bb, const float* bf, const float* bci, const float* bcb,
    const int* idx, int inverse, int transformer, float wh_scale, int num_bins,
    float tail_bound, float min_bin_width, float min_bin_height, float min_derivative,
    void* stream) {
  return wg::maf_wgmma_entry<__nv_bfloat16>(
      x, ctx, y, lad, n, D, L, H, Ip, P, TMp, nb, C, Cp, image, layer_bytes, bi, bb, bf, bci,
      bcb, idx, inverse, transformer, wh_scale, num_bins, tail_bound, min_bin_width,
      min_bin_height, min_derivative, stream);
}
