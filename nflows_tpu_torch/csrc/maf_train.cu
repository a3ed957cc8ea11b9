// B10: backward of the autoregressive chain's one-pass direction.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/maf_train.py:_bwd_kernel
// (directions "forward" and "inverse", affine and rq transformers, fp32,
// with or without a context). It recomputes the chain from x and pulls
// given cotangents (gy, glad) back to gx, gctx and every weight gradient;
// it is the backward of B9 (maf_flow_kernel.cu) where B9 runs one MADE
// pass a layer: going forward through unwrapped [permutation, MADE +
// transformer] layers (the MAF's log_prob), or coming back through wrapped
// ones (the IAF's sampling pass: layers L-1 ... 0, the MADE and transformer
// on the layer's input as it is, then the inverse permutation). The
// direction is a run-time flag: it only moves the permutation, from a
// gather of the layer's input (whose backward scatters the input's
// cotangent) to a scatter of its output (whose backward gathers the
// output's cotangent before the layer's adjoint). The kernel reads
// mask-folded weights and returns dense gradients: the caller multiplies
// gwi, gwb and gwf by the masks (the chain rule of the fold), so a masked
// entry's gradient is exactly zero.
//
// Bound on the H100: operations. One chain pass and its backward are three
// forward-equivalents of fp32 GEMM work (forward, input cotangents, weight
// gradients), 8.1 MFLOP a sample at features 10, hidden 256, 5 layers, 2
// blocks (dense count, masked zeros included), against 84 bytes a sample
// and 5.4 MB of weights read and as much of gradients written. A context
// of C features adds 3 x 2 (1 + nb) C H FLOP and 8 C bytes a sample.
//
// Design: B4's (nsf_train.cu), whose device code it shares.
// - The TPU kernel differentiates each layer with jax.vjp traced inside the
//   kernel. Here the adjoint is written out. The layer's input enters twice,
//   as the MADE's input and as the transformer's operand:
//   g_x = g_y * dy/dx (elementwise) + Wi^T g_h (through the MADE). Affine: s = softplus(u) + 1e-3,
//   y = s x + t, lad = log s, so g_u = (g_y x + g_lad / s) sigmoid(u),
//   g_t = g_y, g_x = g_y s. RQ: rq_spline_forward_adjoint
//   (rq_spline_bwd.cuh), which also carries wh_scale to the width and
//   height cotangents.
// - A block walks over tiles of 32 or 64 samples (a persistent grid of at
//   most one block an SM). Where 32-sample tiles would leave SMs idle,
//   maf_train_cluster.cu spreads each over a thread-block cluster instead
//   (ops/cuda/maf_train.py: launch_layout). Per tile: one forward pass
//   that keeps each layer's input in shared memory and, in a per-block
//   scratch in global memory, the hidden state before each residual block
//   and after the last, the relu'd inner activation of each block and the
//   transformer's parameters P; then the backward sweep over the layers.
// - Three GEMM shapes (tile_gemm.cuh): forward on the packed in-major
//   weights B9 reads; input cotangents with the same routine on the
//   [out][in] matrices, relu masks in its epilogue; weight gradients with
//   tile_wgrad, added into the global buffers with fp32 atomics because
//   blocks run in no order. The wrapper zeroes the buffers before each
//   launch; gradients agree run to run only to fp32 rounding.
// - Context (a template flag, CTX, so the unconditional kernels carry none
//   of its code): the context tile [C4][RS] stays in shared memory. The
//   forward recompute adds relu(Wci c + bci) to h and Wcb_j c + bcb_j to
//   block j's first linear, as B9 does. Block j's pre-relu cotangent g_t
//   gives gWcb_j, gbcb_j and Wcb_j^T g_t into gctx; the initial layer's
//   cotangent where Wci c + bci > 0 gives gWci, gbci and Wci^T of it into
//   gctx. Wci c + bci is recomputed for that mask, not kept: the scratch is
//   already about 1 MB a block. gctx builds up over the layers in a [C4][RS]
//   tile and is written once a tile.
// - The ragged last tile computes on zero rows with zero cotangents, so it
//   adds nothing for them, and skips their stores.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "maf_train.cuh"
#include "rq_spline.cuh"
#include "rq_spline_bwd.cuh"
#include "tile_gemm.cuh"

namespace {

using nflows::KC;
using nflows::OC;
using nflows::tile_bgrad;
using nflows::tile_gemm;
using nflows::tile_wgrad;

constexpr float kAffineEpsilon = 1e-3f;

template <int ROWS, bool CTX>
__global__ void __launch_bounds__(ROWS * 8) maf_train_bwd_kernel(MafTrainArgs a) {
  constexpr int NT = ROWS * 8, RS = ROWS + 4;
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, L = a.L, H = a.H, D4 = a.D4, P = a.P, Pp = a.Pp;
  const int nb2 = a.nb2, nb = a.nb2 / 2;
  float* wst = smem;                        // [2][KC][OC]
  float* X = wst + 2 * KC * OC;             // [TB][RS]
  float* Y = X + a.TB * RS;                 // [TB][RS]
  float* Z = Y + a.TB * RS;                 // [TB][RS]
  float* xs = Z + a.TB * RS;                // [L + 1][ROWS][D] layer inputs, then the output
  float* gcur = xs + (L + 1) * ROWS * D;    // [ROWS][D] cotangent of the layer's output
  float* gnext = gcur + ROWS * D;           // [ROWS][D] cotangent of the layer's input
  float* ybuf = gnext + ROWS * D;           // [ROWS][D] cotangent through the transformer
  float* ga0 = ybuf + ROWS * D;             // [D][ROWS] cotangent through the MADE
  float* gladv = ga0 + D * ROWS;            // [ROWS] cotangent of the logabsdet
  float* cs = gladv + ROWS;                 // [C4][RS] context (CTX only)
  float* gcs = cs + a.C4 * RS;              // [C4][RS] its cotangent (CTX only)
  const bool inv = a.inverse != 0;

  const int tid = threadIdx.x;
  const int KD = a.cfg.num_bins * D;
  const int idx_stride = 2 * D + 1;
  const size_t SR = (size_t)(nb2 + 1) * H + Pp;  // scratch rows a layer
  float* stash = a.stash + (size_t)blockIdx.x * L * SR * RS;
  const int64_t ntiles = (a.n + ROWS - 1) / ROWS;

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = tile * ROWS;
    const int rows = (int)min((int64_t)ROWS, a.n - base);

    for (int e = tid; e < ROWS * D; e += NT) {
      const int s = e / D;
      xs[e] = s < rows ? a.x[(base + s) * D + (e % D)] : 0.0f;
    }
    if constexpr (CTX) {
      for (int e = tid; e < a.C4 * ROWS; e += NT) {
        const int i = e / ROWS, s = e % ROWS;
        cs[i * RS + s] = (i < a.C && s < rows) ? a.ctx[(base + s) * a.C + i] : 0.0f;
        gcs[i * RS + s] = 0.0f;
      }
    }
    __syncthreads();

    // ---- forward pass, keeping what the backward needs ------------------------
    // step k runs layer l: k going forward, L - 1 - k coming back; xs holds
    // each step's input. Going forward the layer's input is gathered by the
    // permutation; coming back its output is scattered by it.
    for (int step = 0; step < L; ++step) {
      const int l = inv ? L - 1 - step : step;
      const float* xl = xs + step * ROWS * D;
      float* xn = xs + (step + 1) * ROWS * D;
      const int* perm = a.idx + l * idx_stride;
      float* st = stash + (size_t)l * SR * RS;

      for (int e = tid; e < D4 * ROWS; e += NT) {
        const int i = e / ROWS, s = e % ROWS;
        Y[i * RS + s] = i < D ? xl[s * D + (inv ? i : perm[i])] : 0.0f;
      }
      __syncthreads();

      // h_0 [+ relu(Wci c + bci)], then
      // h_{j+1} = h_j + W1 relu(W0 relu(h_j) + b0 [+ Wcb_j c + bcb_j]) + b1
      if constexpr (CTX) {
        tile_gemm<ROWS, RS>(cs, a.C4, a.pwci + (size_t)l * a.C4 * H, a.bci + (size_t)l * H, H, X,
                            false, true, false, wst);
      }
      tile_gemm<ROWS, RS>(Y, D4, a.pwi + (size_t)l * D4 * H, a.bi + (size_t)l * H, H, X, false,
                          false, CTX, wst, nullptr, st);
      for (int j = 0; j < nb; ++j) {
        const size_t m = (size_t)l * nb2 + 2 * j;
        if constexpr (CTX) {
          const size_t mc = (size_t)l * nb + j;
          tile_gemm<ROWS, RS>(cs, a.C4, a.pwcb + mc * a.C4 * H, a.bcb + mc * H, H, Y, false,
                              false, false, wst);
        }
        tile_gemm<ROWS, RS>(X, H, a.pwb + m * H * H, a.bb + m * H, H, Y, true, true, CTX, wst,
                            nullptr, st + (size_t)(nb + 1 + j) * H * RS);
        tile_gemm<ROWS, RS>(Y, H, a.pwb + (m + 1) * H * H, a.bb + (m + 1) * H, H, X, false,
                            false, true, wst, nullptr, st + (size_t)(j + 1) * H * RS);
      }
      tile_gemm<ROWS, RS>(X, H, a.pwf + (size_t)l * H * Pp, a.pbf + (size_t)l * Pp, Pp, Y, false,
                          false, false, wst);

      // P = Y is [P][RS], param-major rows; the softmax 1/sqrt(H) goes on the
      // RQ width and height rows here, and P is kept as the transformer reads it
      float* pst = st + (size_t)(nb2 + 1) * H * RS;
      for (int e = tid; e < Pp * ROWS; e += NT) {
        const int r = e / ROWS, at = r * RS + e % ROWS;
        const float v = (a.rq && r < 2 * KD) ? Y[at] * a.wh_scale : Y[at];
        Y[at] = v;
        pst[at] = v;
      }
      __syncthreads();

      for (int e = tid; e < D * ROWS; e += NT) {
        const int t = e / ROWS, s = e % ROWS;
        const float xv = xl[s * D + (inv ? t : perm[t])];
        const float* Pt = Y + t * RS + s;
        float o;
        if (a.rq) {
          float unused;
          nflows::rq_spline_eval(xv, Pt, Pt + KD * RS, Pt + 2 * KD * RS, D * RS, false, a.cfg,
                                 &o, &unused);
        } else {
          o = (nflows::softplus(Pt[0]) + kAffineEpsilon) * xv + Pt[D * RS];
        }
        xn[s * D + (inv ? perm[t] : t)] = o;
      }
      __syncthreads();
    }

    // ---- cotangents of the chain's output --------------------------------------
    for (int s = tid; s < ROWS; s += NT) gladv[s] = s < rows ? a.glad[base + s] : 0.0f;
    for (int e = tid; e < ROWS * D; e += NT) gcur[e] = e / D < rows ? a.gy[base * D + e] : 0.0f;
    __syncthreads();

    // ---- backward sweep ----------------------------------------------------------
    for (int step = L - 1; step >= 0; --step) {
      const int l = inv ? L - 1 - step : step;
      const float* xl = xs + step * ROWS * D;
      const int* perm = a.idx + l * idx_stride;
      const float* st = stash + (size_t)l * SR * RS;

      restore<ROWS>(X, st + (size_t)(nb2 + 1) * H * RS, Pp, false);  // P
      for (int e = tid; e < (Pp - P) * RS; e += NT) Y[P * RS + e] = 0.0f;
      __syncthreads();

      // transformer adjoint: gP into Y, the operand's cotangent into ybuf
      for (int e = tid; e < D * ROWS; e += NT) {
        const int t = e / ROWS, s = e % ROWS;
        const float xv = xl[s * D + (inv ? t : perm[t])];
        const float g = gcur[s * D + (inv ? perm[t] : t)], gl = gladv[s];
        const float* Pt = X + t * RS + s;
        float* G = Y + t * RS + s;
        if (a.rq) {
          nflows::rq_spline_forward_adjoint(xv, Pt, Pt + KD * RS, Pt + 2 * KD * RS, D * RS, a.cfg,
                                            g, gl, a.wh_scale, ybuf + s * D + t, G, G + KD * RS,
                                            G + 2 * KD * RS);
        } else {
          const float u = Pt[0];
          const float scale = nflows::softplus(u) + kAffineEpsilon;
          G[0] = (g * xv + gl / scale) * nflows::sigmoidf(u);
          G[D * RS] = g;
          ybuf[s * D + t] = g * scale;
        }
      }
      __syncthreads();

      // final layer: gWf += gP h^T, gbf += gP 1, g_h = Wf^T gP
      restore<ROWS>(X, st + (size_t)nb * H * RS, H, false);  // h after the last block
      __syncthreads();
      tile_wgrad<ROWS, RS>(Y, P, X, H, a.gwf + (size_t)l * P * H, H);
      tile_bgrad<ROWS, RS>(Y, P, a.gbf + (size_t)l * P);
      tile_gemm<ROWS, RS>(Y, P, a.wf + (size_t)l * P * H, nullptr, H, Z, false, false, false,
                          wst);

      // residual blocks, last first; Z holds g_h
      for (int j = nb - 1; j >= 0; --j) {
        const size_t m = (size_t)l * nb2 + 2 * j;
        restore<ROWS>(X, st + (size_t)(nb + 1 + j) * H * RS, H, false);  // t = relu(W0 relu(h) + b0)
        __syncthreads();
        tile_wgrad<ROWS, RS>(Z, H, X, H, a.gwb + (m + 1) * H * H, H);
        tile_bgrad<ROWS, RS>(Z, H, a.gbb + (m + 1) * H);
        // g_t = (W1^T g_h) where t > 0
        tile_gemm<ROWS, RS>(Z, H, a.wb + (m + 1) * H * H, nullptr, H, Y, false, false, false,
                            wst, X);
        if constexpr (CTX) {
          // g_t is the cotangent of Wcb_j c + bcb_j too
          const size_t mc = (size_t)l * nb + j;
          tile_wgrad<ROWS, RS>(Y, H, cs, a.C, a.gwcb + mc * H * a.C, a.C);
          tile_bgrad<ROWS, RS>(Y, H, a.gbcb + mc * H);
          context_cotangent<ROWS>(a.wcb + mc * H * a.C, Y, H, a.C, gcs);
        }
        restore<ROWS>(X, st + (size_t)j * H * RS, H, true);  // relu(h_j)
        __syncthreads();
        tile_wgrad<ROWS, RS>(Y, H, X, H, a.gwb + m * H * H, H);
        tile_bgrad<ROWS, RS>(Y, H, a.gbb + m * H);
        // g_h += (W0^T g_t) where h_j > 0
        tile_gemm<ROWS, RS>(Y, H, a.wb + m * H * H, nullptr, H, Z, false, false, true, wst, X);
      }

      if constexpr (CTX) {
        // the initial layer's context term: Y = g_h where Wci c + bci > 0
        tile_gemm<ROWS, RS>(cs, a.C4, a.pwci + (size_t)l * a.C4 * H, a.bci + (size_t)l * H, H, X,
                            false, false, false, wst);
        for (int e = tid; e < H * ROWS; e += NT) {
          const int o = e / ROWS, s = e % ROWS;
          Y[o * RS + s] = X[o * RS + s] > 0.0f ? Z[o * RS + s] : 0.0f;
        }
        __syncthreads();
        tile_wgrad<ROWS, RS>(Y, H, cs, a.C, a.gwci + (size_t)l * H * a.C, a.C);
        tile_bgrad<ROWS, RS>(Y, H, a.gbci + (size_t)l * H);
        context_cotangent<ROWS>(a.wci + (size_t)l * H * a.C, Y, H, a.C, gcs);
      }

      // initial layer: gWi += g_h xp^T, gbi += g_h 1, and Wi^T g_h
      const float* wi = a.wi + (size_t)l * H * D;
      for (int e = tid; e < H * D; e += NT) {
        const int o = e / D, src = inv ? e % D : perm[e % D];
        float sum = 0.0f;
        for (int s = 0; s < ROWS; ++s) sum += Z[o * RS + s] * xl[s * D + src];
        atomicAdd(a.gwi + (size_t)l * H * D + e, sum);
      }
      tile_bgrad<ROWS, RS>(Z, H, a.gbi + (size_t)l * H);
      for (int e = tid; e < D * ROWS; e += NT) {
        const int i = e / ROWS, s = e % ROWS;
        float sum = 0.0f;
        for (int o = 0; o < H; ++o) sum += wi[o * D + i] * Z[o * RS + s];
        ga0[e] = sum;
      }
      __syncthreads();

      // the layer's input fed both the transformer and the MADE; going
      // forward the scatter undoes the gather xp[i] = x[perm[i]]
      for (int e = tid; e < ROWS * D; e += NT) {
        const int s = e / D, i = e % D;
        gnext[s * D + (inv ? i : perm[i])] = ybuf[e] + ga0[i * ROWS + s];
      }
      __syncthreads();
      float* tmp = gcur; gcur = gnext; gnext = tmp;
    }

    for (int e = tid; e < rows * D; e += NT) a.gx[base * D + e] = gcur[e];
    if constexpr (CTX) {
      for (int e = tid; e < a.C * ROWS; e += NT) {
        const int c = e / ROWS, s = e % ROWS;
        if (s < rows) a.gctx[(base + s) * a.C + c] = gcs[c * RS + s];
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int rows, const MafTrainArgs& a) {
  return sizeof(float) * ((size_t)2 * KC * OC + (size_t)(3 * a.TB + 2 * a.C4) * (rows + 4) +
                          (size_t)rows * ((a.L + 5) * a.D + 1));
}

template <int ROWS, bool CTX>
int launch(const MafTrainArgs& a, int grid, cudaStream_t stream) {
  const size_t bytes = smem_bytes(ROWS, a);
  cudaError_t err = cudaFuncSetAttribute(maf_train_bwd_kernel<ROWS, CTX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  maf_train_bwd_kernel<ROWS, CTX><<<(unsigned)grid, ROWS * 8, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// transformer: 0 affine (P = 2 D), 1 rq (P = (3 K - 1) D). inverse: 0 the
// forward direction (unwrapped layers), 1 the inverse (wrapped layers). C =
// 0: no context (ctx, gctx and the context stacks and gradients may be
// null). grid: blocks to launch; stash holds grid x L x ((nb2 + 1) H + Pp) x
// (rows_per_block + 4) floats. rows_per_block: 32 or 64; cluster_size: 1
// (maf_train_cluster.cu spreads a tile over a cluster). Returns a
// cudaError_t value (0 on success).
extern "C" int maf_train_launch(MAF_TRAIN_LAUNCH_PARAMS) {
  if (n == 0) return 0;
  MafTrainArgs a;
  const int err = pack_maf_train_args(a, MAF_TRAIN_LAUNCH_NAMES);
  if (err) return err;
  if (cluster_size != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C > 0) {
    if (rows_per_block == 32) return launch<32, true>(a, grid, s);
    if (rows_per_block == 64) return launch<64, true>(a, grid, s);
  } else {
    if (rows_per_block == 32) return launch<32, false>(a, grid, s);
    if (rows_per_block == 64) return launch<64, false>(a, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}
