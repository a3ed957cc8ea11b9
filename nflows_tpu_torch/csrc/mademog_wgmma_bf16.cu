// B11 with bf16 weights on the tensor cores: the log-density of a
// MixtureOfGaussiansMADE or a conditional MADEMoG in one launch.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/mademog_fused.py:_kernel
// with bf16 weights, the JAX package's default deployment
// (fuse_mademog(dtype=bfloat16), CompiledFlow(dtype=bfloat16)), with and
// without a per-sample context, where the widths suit wgmma
// (ops/cuda/mademog_fused.py: gemm_route); csrc/mademog_fused.cu's bf16
// instantiation takes every other model. The kernel is mademog_wgmma.cuh
// instantiated with __nv_bfloat16 weights: the TPU kernel's dots, both
// operands bf16 (the activation rounded where the epilogue writes it), the
// exact products summed in fp32 on bf16 wgmma.
//
// Bound on the H100: operations, M FLOP the masks leave at 989 TFLOP/s
// (0.0015 ms for the MoG-MADE at N = 4,096); each tile reads the 0.70 MB
// bf16 image from L2.
#include "mademog_wgmma.cuh"

// The arguments of mademog_wgmma_entry (mademog_wgmma.cuh).
extern "C" int mademog_wgmma_launch_bf16(const float* x, const float* ctx, float* lp,
                                         int64_t n, int D, int C, int K, int H, int Ip, int Cp,
                                         int TMp, int nb, float eps, const void* image,
                                         const float* bi, const float* bb, const float* bf,
                                         const float* bci, const float* bcb, void* stream) {
  return wg::mademog_wgmma_entry<__nv_bfloat16>(x, ctx, lp, n, D, C, K, H, Ip, Cp, TMp, nb, eps,
                                                image, bi, bb, bf, bci, bcb, stream);
}
