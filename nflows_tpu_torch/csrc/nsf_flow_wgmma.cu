// B2 with fp32 weights on the tensor cores (3xTF32): the whole L-layer
// coupling chain in one launch.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/nsf_flow_kernel.py:_kernel
// with fp32 weights (fuse_nsf(dtype=float32)), with and without a
// per-sample context, where the widths suit wgmma (hidden a multiple of 64
// up to 256, the tile in shared memory; ops/cuda/nsf_flow_kernel.py:
// gemm_route); csrc/nsf_flow_kernel.cu takes every other shape. The kernel
// is nsf_flow_wgmma.cuh instantiated with float weights: each product is
// three TF32 products of the operands' hi and lo parts, summed in fp32.
//
// Bound on the H100: operations, 3 F TF32 FLOP on the tensor cores
// (495 TFLOP/s), F = 2 N L (Tid H + C H + 4 H^2 + nb C H + H TM); at the
// flagship 0.139 ms at N = 4,096, beside 11.3 MB of fp32 weights that each
// of the 128 tiles reads from L2.
#include "nsf_flow_wgmma.cuh"

// The arguments of nsf_wgmma_entry (nsf_flow_wgmma.cuh).
extern "C" int nsf_wgmma_launch(
    const float* x, float* y, float* lad, int64_t n, int D, int L, int H, int Tid, int Ip, int T,
    int TM, int TMp, int nb, const void* image, int64_t layer_bytes, const float* b0,
    const float* bb, const float* bf, const float* bcb, const int* idx, int inverse, int family,
    int scale_act, int num_bins, float wh_scale, float tail_bound, float min_bin_width,
    float min_bin_height, float min_derivative, float min_lambda, float edge_derivative,
    float log_inv_bins, const float* ctx, int C, int Cp, void* stream) {
  return wg::nsf_wgmma_entry<float>(x, y, lad, n, D, L, H, Tid, Ip, T, TM, TMp, nb, image,
                                    layer_bytes, b0, bb, bf, bcb, idx, inverse, family,
                                    scale_act, num_bins, wh_scale, tail_bound, min_bin_width,
                                    min_bin_height, min_derivative, min_lambda,
                                    edge_derivative, log_inv_bins, ctx, C, Cp, stream);
}

// One GEMM through the kernel's ring and warpgroups (wgmma_gemm_entry).
extern "C" int wgmma_gemm_launch(const float* image, const float* act, float* out, int64_t n,
                                 int K, int O, void* stream) {
  return wg::wgmma_gemm_entry<float>(image, act, out, n, K, O, stream);
}
