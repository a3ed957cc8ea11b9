// Device code shared by the mixture-density kernels (mademog_fused.cu, B11;
// mademog_train.cu, B12): the residual MADE pass with its additive context
// projections, and the mixture-of-Gaussians head.
//
// Activations are feature-major in shared memory ([rows][RS] fp32, RS the
// row stride) and the GEMMs are tile_gemm (tile_gemm.cuh) on in-major
// weights with the masks folded in. The head reads the MADE's output P in
// the K-major layout of the JAX package: row (j K + k) D + d is parameter j
// (logit, mean, unconstrained std) of component k of feature d.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_gemm.cuh"

namespace nflows {

struct MogDims {
  int D;      // features
  int C;      // context features (0: unconditional)
  int K;      // mixture components
  int H;      // hidden width
  int P;      // 3 K D MADE outputs
  int Pp;     // P rounded up to a multiple of 4
  int nb;     // residual blocks
  float eps;  // added to the softplus stds
};

// In-major [in][out] weights, masks folded (mademog_fused.py:pack_weights);
// the matrices are WT (float, or __nv_bfloat16 for B11's bf16 path), the
// biases fp32.
template <typename WT>
struct MogWeightsT {
  const WT* wi;      // [D][H]
  const float* bi;   // [H]
  const WT* wb;      // [2 nb][H][H]
  const float* bb;   // [2 nb][H]
  const WT* wf;      // [H][Pp]
  const float* bf;   // [Pp]
  const WT* wci;     // [C][H]
  const float* bci;  // [H]
  const WT* wcb;     // [nb][C][H]
  const float* bcb;  // [nb][H]
};
using MogWeights = MogWeightsT<float>;

// The MADE pass of a tile: hb = h after the last block, tb = P ([Pp][RS]);
// xs [D][RS] and cs [C][RS] are the inputs and the context. With a context
// the initial layer adds c_init = relu(Wci c + bci) and block j adds
// c_j = Wcb_j c + bcb_j before its inner relu; each projection is one
// tile_gemm, computed just before the GEMM it feeds. With st (global
// memory, [2 + 2 nb][H][RS]), the pass also keeps c_init at block 0, h_j at
// block 1 + j (j = 0..nb) and the relu'd inner activation t_j at block
// 2 + nb + j, for the backward. With bf16 weights every GEMM rounds its
// activation operand to bf16 (tile_gemm.cuh), the context included, as the
// TPU kernel's dots cast it: t where the block's first GEMM stores it, the
// others where they are loaded. Ends with a barrier.
template <int ROWS, int RS, typename WT>
__device__ void mog_made_forward(const MogDims& d, const MogWeightsT<WT>& w,
                                 const float* xs, const float* cs, float* hb, float* tb,
                                 float* wst, float* st) {
  const int H = d.H;
  const size_t HR = (size_t)H * RS;
  auto kept = [&](int block) { return st ? st + block * HR : nullptr; };
  if (d.C) {
    tile_gemm<ROWS, RS>(cs, d.C, w.wci, w.bci, H, hb, false, true, false, wst, nullptr, kept(0));
  }
  tile_gemm<ROWS, RS>(xs, d.D, w.wi, w.bi, H, hb, false, false, d.C != 0, wst, nullptr, kept(1));
  for (int j = 0; j < d.nb; ++j) {
    // t = relu(W0 relu(h) + b0 [+ c_j]); h += W1 t + b1
    if (d.C) {
      tile_gemm<ROWS, RS>(cs, d.C, w.wcb + (size_t)j * d.C * H, w.bcb + (size_t)j * H, H, tb,
                          false, false, false, wst);
    }
    const size_t m = 2 * (size_t)j;
    tile_gemm<ROWS, RS, false, WT, kRoundOut>(hb, H, w.wb + m * H * H, w.bb + m * H, H, tb, true,
                                              true, d.C != 0, wst, nullptr, kept(2 + d.nb + j));
    tile_gemm<ROWS, RS, false, WT, kRoundedIn>(tb, H, w.wb + (m + 1) * H * H, w.bb + (m + 1) * H,
                                               H, hb, false, false, true, wst, nullptr,
                                               kept(2 + j));
  }
  tile_gemm<ROWS, RS>(hb, H, w.wf, w.bf, d.Pp, tb, false, false, false, wst);
}

// jnp.logaddexp(u, 0): max(u, 0) + log1p(exp(-|u|))
__device__ __forceinline__ float mog_softplus(float u) {
  return fmaxf(u, 0.0f) + log1pf(expf(-fabsf(u)));
}

__device__ __forceinline__ float mog_sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

constexpr float kLog2Pi = 1.8378770664093453f;

// One feature's mixture at one sample. lg points at the logit of
// component 0 (P + t RS + s for feature t, sample s); component k's logit,
// mean and unconstrained std are lg[k ks], lg[(K + k) ks], lg[(2K + k) ks],
// with ks = D RS.
struct MogFeature {
  const float* lg;
  int K;
  int ks;
  float eps;
  float x;
  float m;    // max of the logits
  float lse;  // log of sum exp(logit - m)

  __device__ MogFeature(const float* lg_, int K_, int ks_, float eps_, float x_)
      : lg(lg_), K(K_), ks(ks_), eps(eps_), x(x_) {
    m = -INFINITY;
    for (int k = 0; k < K; ++k) m = fmaxf(m, lg[k * ks]);
    float se = 0.0f;
    for (int k = 0; k < K; ++k) se += expf(lg[k * ks] - m);
    lse = logf(se);
  }
  __device__ float log_coef(int k) const { return (lg[k * ks] - m) - lse; }
  __device__ float mean(int k) const { return lg[(K + k) * ks]; }
  __device__ float ustd(int k) const { return lg[(2 * K + k) * ks]; }
  __device__ float sdev(int k) const { return mog_softplus(ustd(k)) + eps; }
  // component log-density c_k = a_k - (log 2 pi + 2 log s_k + z_k^2) / 2
  __device__ float component(int k) const {
    const float s = sdev(k);
    const float z = (x - mean(k)) / s;
    return log_coef(k) - 0.5f * (kLog2Pi + 2.0f * logf(s) + z * z);
  }
  __device__ float max_component() const {
    float cm = -INFINITY;
    for (int k = 0; k < K; ++k) cm = fmaxf(cm, component(k));
    return cm;
  }
  // logsumexp over the components, max subtracted
  __device__ float log_prob() const {
    const float cm = max_component();
    float sc = 0.0f;
    for (int k = 0; k < K; ++k) sc += expf(component(k) - cm);
    return cm + logf(sc);
  }
};

}  // namespace nflows
