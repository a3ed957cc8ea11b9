// B11 with fp32 weights on the tensor cores (3xTF32): the log-density of a
// MixtureOfGaussiansMADE or a conditional MADEMoG in one launch.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/mademog_fused.py:_kernel
// with fp32 weights (fuse_mademog(dtype=float32)), with and without a
// per-sample context, where the widths suit wgmma (hidden a multiple of 64
// up to 256, the final layer's rows padded to at most 512, the tile in
// shared memory; ops/cuda/mademog_fused.py: gemm_route);
// csrc/mademog_fused.cu takes every other model and the fused trainer's
// forward. The kernel is mademog_wgmma.cuh instantiated with float
// weights: each product is three TF32 products of the operands' hi and lo
// parts, summed in fp32.
//
// Bound on the H100: operations, 3 M TF32 FLOP on the tensor cores at
// 495 TFLOP/s, M the FLOP the masks leave (0.0092 ms for the MoG-MADE at
// N = 4,096); each tile reads the 1.39 MB fp32 image from L2.
#include "mademog_wgmma.cuh"

// The arguments of mademog_wgmma_entry (mademog_wgmma.cuh).
extern "C" int mademog_wgmma_launch(const float* x, const float* ctx, float* lp, int64_t n,
                                    int D, int C, int K, int H, int Ip, int Cp, int TMp, int nb,
                                    float eps, const void* image, const float* bi,
                                    const float* bb, const float* bf, const float* bci,
                                    const float* bcb, void* stream) {
  return wg::mademog_wgmma_entry<float>(x, ctx, lp, n, D, C, K, H, Ip, Cp, TMp, nb, eps, image,
                                        bi, bb, bf, bci, bcb, stream);
}
