// B9's one-pass direction with fp32 weights on the tensor cores (3xTF32):
// a whole L-layer autoregressive flow in one launch where every layer runs
// one MADE pass in the requested direction (a MAF's or NSF-AR's log_prob,
// an IAF's sample).
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/maf_flow_kernel.py:_kernel
// with fp32 weights (fuse_maf(dtype=float32)) on those chains, with and
// without a per-sample context, where the widths suit wgmma (hidden a
// multiple of 64 up to 256, the tile in shared memory;
// ops/cuda/maf_flow_kernel.py: gemm_route); csrc/maf_flow_kernel.cu takes
// every other one-pass chain and the trainers' forward. The kernel is
// maf_flow_wgmma.cuh instantiated with float weights: each product is
// three TF32 products of the operands' hi and lo parts, summed in fp32.
//
// Bound on the H100: operations, 3 M TF32 FLOP on the tensor cores at
// 495 TFLOP/s, M the FLOP the masks leave (0.037 ms for the MAF at
// N = 4,096); each tile reads the 5.8 MB fp32 image from L2.
#include "maf_flow_wgmma.cuh"

// The arguments of maf_wgmma_entry (maf_flow_wgmma.cuh).
extern "C" int maf_wgmma_launch(
    const float* x, const float* ctx, float* y, float* lad, int64_t n, int D, int L, int H,
    int Ip, int P, int TMp, int nb, int C, int Cp, const void* image, int64_t layer_bytes,
    const float* bi, const float* bb, const float* bf, const float* bci, const float* bcb,
    const int* idx, int inverse, int transformer, float wh_scale, int num_bins,
    float tail_bound, float min_bin_width, float min_bin_height, float min_derivative,
    void* stream) {
  return wg::maf_wgmma_entry<float>(x, ctx, y, lad, n, D, L, H, Ip, P, TMp, nb, C, Cp, image,
                                    layer_bytes, bi, bb, bf, bci, bcb, idx, inverse,
                                    transformer, wh_scale, num_bins, tail_bound, min_bin_width,
                                    min_bin_height, min_derivative, stream);
}
