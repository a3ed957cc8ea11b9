// B2 with bf16 weights on the tensor cores: the whole L-layer coupling
// chain in one launch.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/nsf_flow_kernel.py:_kernel
// with bf16 weights, the JAX package's default deployment
// (fuse_nsf(dtype=bfloat16), CompiledFlow(dtype=bfloat16)), with and
// without a per-sample context, where the widths suit wgmma
// (ops/cuda/nsf_flow_kernel.py: gemm_route); csrc/nsf_flow_kernel_bf16.cu
// takes every other shape. The kernel is nsf_flow_wgmma.cuh instantiated
// with __nv_bfloat16 weights: the TPU kernel's _dot, both operands bf16
// (the activation rounded where the epilogue writes it), the exact
// products summed in fp32 on bf16 wgmma.
//
// Bound on the H100: the weight stream. The operations take 0.023 ms at
// N = 4,096 on the flagship (989 TFLOP/s dense); each of the 128 tiles
// reads the 5.6 MB of bf16 weights from L2.
#include "nsf_flow_wgmma.cuh"

using bf16 = __nv_bfloat16;

// The arguments of nsf_wgmma_entry (nsf_flow_wgmma.cuh).
extern "C" int nsf_wgmma_launch_bf16(
    const float* x, float* y, float* lad, int64_t n, int D, int L, int H, int Tid, int Ip, int T,
    int TM, int TMp, int nb, const void* image, int64_t layer_bytes, const float* b0,
    const float* bb, const float* bf, const float* bcb, const int* idx, int inverse, int family,
    int scale_act, int num_bins, float wh_scale, float tail_bound, float min_bin_width,
    float min_bin_height, float min_derivative, float min_lambda, float edge_derivative,
    float log_inv_bins, const float* ctx, int C, int Cp, void* stream) {
  return wg::nsf_wgmma_entry<bf16>(x, y, lad, n, D, L, H, Tid, Ip, T, TM, TMp, nb, image,
                                   layer_bytes, b0, bb, bf, bcb, idx, inverse, family,
                                   scale_act, num_bins, wh_scale, tail_bound, min_bin_width,
                                   min_bin_height, min_derivative, min_lambda,
                                   edge_derivative, log_inv_bins, ctx, C, Cp, stream);
}

// One GEMM through the kernel's ring and warpgroups (wgmma_gemm_entry).
extern "C" int wgmma_gemm_launch_bf16(const bf16* image, const float* act, float* out,
                                      int64_t n, int K, int O, void* stream) {
  return wg::wgmma_gemm_entry<bf16>(image, act, out, n, K, O, stream);
}
