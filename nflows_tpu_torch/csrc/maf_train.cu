// B10: backward of the autoregressive chain's log_prob direction.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/maf_train.py:_bwd_kernel
// (direction "forward", affine and rq transformers, fp32, no context). It
// recomputes the chain of unwrapped [permutation, MADE + transformer]
// layers from x and pulls given cotangents (gy, glad) back to gx and every
// weight gradient; it is the backward of B9 (maf_flow_kernel.cu) going
// forward. The kernel reads mask-folded weights and returns dense
// gradients: the caller multiplies gwi, gwb and gwf by the masks (the chain
// rule of the fold), so a masked entry's gradient is exactly zero.
//
// Bound on the H100: operations. One chain pass and its backward are three
// forward-equivalents of fp32 GEMM work (forward, input cotangents, weight
// gradients), 8.1 MFLOP a sample at features 10, hidden 256, 5 layers, 2
// blocks (dense count, masked zeros included), against 84 bytes a sample
// and 5.4 MB of weights read and as much of gradients written.
//
// Design: B4's (nsf_train.cu), whose device code it shares.
// - The TPU kernel differentiates each layer with jax.vjp traced inside the
//   kernel. Here the adjoint is written out. The layer's input enters twice,
//   as the MADE's input and as the transformer's operand:
//   g_x = g_y * dy/dx (elementwise) + Wi^T g_h (through the MADE), then the
//   scatter that undoes the permutation. Affine: s = softplus(u) + 1e-3,
//   y = s x + t, lad = log s, so g_u = (g_y x + g_lad / s) sigmoid(u),
//   g_t = g_y, g_x = g_y s. RQ: rq_spline_forward_adjoint
//   (rq_spline_bwd.cuh), which also carries wh_scale to the width and
//   height cotangents.
// - A block walks over tiles of 32 samples (a persistent grid of at most
//   one block an SM). Per tile: one forward pass that keeps each layer's
//   input in shared memory and, in a per-block scratch in global memory,
//   the hidden state before each residual block and after the last, the
//   relu'd inner activation of each block and the transformer's parameters
//   P; then the backward sweep over the layers.
// - Three GEMM shapes (tile_gemm.cuh): forward on the packed in-major
//   weights B9 reads; input cotangents with the same routine on the
//   [out][in] matrices, relu masks in its epilogue; weight gradients with
//   tile_wgrad, added into the global buffers with fp32 atomics because
//   blocks run in no order. The wrapper zeroes the buffers before each
//   launch; gradients agree run to run only to fp32 rounding.
// - The ragged last tile computes on zero rows with zero cotangents, so it
//   adds nothing for them, and skips their stores.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

struct MafTrainArgs {
  const float* x;     // [n][D]
  const float* gy;    // [n][D]  cotangent of the chain's output
  const float* glad;  // [n]     cotangent of the logabsdet
  float* gx;          // [n][D]  cotangent of x
  int64_t n;
  int D, L, H, D4, P, Pp, TB, nb2;
  // forward weights, in-major and padded (maf_flow_kernel.py:pack_weights)
  const float* pwi;  // [L][D4][H]
  const float* pwb;  // [L][nb2][H][H]
  const float* pwf;  // [L][H][Pp]
  const float* pbf;  // [L][Pp]
  // the extracted layout, [out][in], mask folded
  const float* wi;   // [L][H][D]
  const float* bi;   // [L][H]
  const float* wb;   // [L][nb2][H][H]
  const float* bb;   // [L][nb2][H]
  const float* wf;   // [L][P][H]
  const int* idx;    // [L][2 D + 1]: perm_rows, inv_perm_rows, wrapped
  // gradients, in the extracted layout, zeroed by the caller
  float* gwi;
  float* gbi;
  float* gwb;
  float* gbb;
  float* gwf;
  float* gbf;
  float* stash;  // [grid][L][(nb2 + 1) H + Pp][ROWS + 4]
  int rq;        // 0: affine transformer, 1: RQ spline
  float wh_scale;
  nflows::RQConfig cfg;
};

// rows x [RS] floats from the block's scratch in global memory into shared
// memory, relu'd on the way if asked. Read past L1: another tile of this
// block wrote the same addresses before.
template <int ROWS>
__device__ __forceinline__ void restore(float* dst, const float* src, int rows, bool relu) {
  constexpr int NT = ROWS * 8, RS = ROWS + 4;
  for (int e = threadIdx.x; e < rows * (RS / 4); e += NT) {
    float4 v = __ldcg(reinterpret_cast<const float4*>(src) + e);
    if (relu) {
      v.x = fmaxf(v.x, 0.0f); v.y = fmaxf(v.y, 0.0f);
      v.z = fmaxf(v.z, 0.0f); v.w = fmaxf(v.w, 0.0f);
    }
    reinterpret_cast<float4*>(dst)[e] = v;
  }
}

template <int ROWS>
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
    __syncthreads();

    // ---- forward pass, keeping what the backward needs ------------------------
    for (int l = 0; l < L; ++l) {
      const float* xl = xs + l * ROWS * D;
      float* xn = xs + (l + 1) * ROWS * D;
      const int* perm = a.idx + l * idx_stride;
      float* st = stash + (size_t)l * SR * RS;

      for (int e = tid; e < D4 * ROWS; e += NT) {
        const int i = e / ROWS, s = e % ROWS;
        Y[i * RS + s] = i < D ? xl[s * D + perm[i]] : 0.0f;
      }
      __syncthreads();

      // h_0, then h_{j+1} = h_j + W1 relu(W0 relu(h_j) + b0) + b1
      tile_gemm<ROWS, RS>(Y, D4, a.pwi + (size_t)l * D4 * H, a.bi + (size_t)l * H, H, X, false,
                          false, false, wst, nullptr, st);
      for (int j = 0; j < nb; ++j) {
        const size_t m = (size_t)l * nb2 + 2 * j;
        tile_gemm<ROWS, RS>(X, H, a.pwb + m * H * H, a.bb + m * H, H, Y, true, true, false, wst,
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
        const float xv = xl[s * D + perm[t]];
        const float* Pt = Y + t * RS + s;
        float o;
        if (a.rq) {
          float unused;
          nflows::rq_spline_eval(xv, Pt, Pt + KD * RS, Pt + 2 * KD * RS, D * RS, false, a.cfg,
                                 &o, &unused);
        } else {
          o = (nflows::softplus(Pt[0]) + kAffineEpsilon) * xv + Pt[D * RS];
        }
        xn[s * D + t] = o;
      }
      __syncthreads();
    }

    // ---- cotangents of the chain's output --------------------------------------
    for (int s = tid; s < ROWS; s += NT) gladv[s] = s < rows ? a.glad[base + s] : 0.0f;
    for (int e = tid; e < ROWS * D; e += NT) gcur[e] = e / D < rows ? a.gy[base * D + e] : 0.0f;
    __syncthreads();

    // ---- backward sweep ----------------------------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      const float* xl = xs + l * ROWS * D;
      const int* perm = a.idx + l * idx_stride;
      const float* st = stash + (size_t)l * SR * RS;

      restore<ROWS>(X, st + (size_t)(nb2 + 1) * H * RS, Pp, false);  // P
      for (int e = tid; e < (Pp - P) * RS; e += NT) Y[P * RS + e] = 0.0f;
      __syncthreads();

      // transformer adjoint: gP into Y, the operand's cotangent into ybuf
      for (int e = tid; e < D * ROWS; e += NT) {
        const int t = e / ROWS, s = e % ROWS;
        const float xv = xl[s * D + perm[t]];
        const float g = gcur[s * D + t], gl = gladv[s];
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
        restore<ROWS>(X, st + (size_t)j * H * RS, H, true);  // relu(h_j)
        __syncthreads();
        tile_wgrad<ROWS, RS>(Y, H, X, H, a.gwb + m * H * H, H);
        tile_bgrad<ROWS, RS>(Y, H, a.gbb + m * H);
        // g_h += (W0^T g_t) where h_j > 0
        tile_gemm<ROWS, RS>(Y, H, a.wb + m * H * H, nullptr, H, Z, false, false, true, wst, X);
      }

      // initial layer: gWi += g_h xp^T, gbi += g_h 1, and Wi^T g_h
      const float* wi = a.wi + (size_t)l * H * D;
      for (int e = tid; e < H * D; e += NT) {
        const int o = e / D, src = perm[e % D];
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

      // the permuted input fed both the transformer and the MADE; the
      // scatter undoes the gather xp[i] = x[perm[i]]
      for (int e = tid; e < ROWS * D; e += NT) {
        const int s = e / D, i = e % D;
        gnext[s * D + perm[i]] = ybuf[e] + ga0[i * ROWS + s];
      }
      __syncthreads();
      float* tmp = gcur; gcur = gnext; gnext = tmp;
    }

    for (int e = tid; e < rows * D; e += NT) a.gx[base * D + e] = gcur[e];
    __syncthreads();
  }
}

size_t smem_bytes(int rows, const MafTrainArgs& a) {
  return sizeof(float) * ((size_t)2 * KC * OC + (size_t)3 * a.TB * (rows + 4) +
                          (size_t)rows * ((a.L + 5) * a.D + 1));
}

template <int ROWS>
int launch(const MafTrainArgs& a, int grid, cudaStream_t stream) {
  const size_t bytes = smem_bytes(ROWS, a);
  cudaError_t err = cudaFuncSetAttribute(maf_train_bwd_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  maf_train_bwd_kernel<ROWS><<<(unsigned)grid, ROWS * 8, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// transformer: 0 affine (P = 2 D), 1 rq (P = (3 K - 1) D). grid: blocks to
// launch; stash holds grid x L x ((nb2 + 1) H + Pp) x (rows_per_block + 4)
// floats. rows_per_block: 32 or 64. Returns a cudaError_t value (0 on
// success).
extern "C" int maf_train_launch(
    const float* x, const float* gy, const float* glad, float* gx, int64_t n, int D, int L, int H,
    int D4, int P, int Pp, int nb2, const float* pwi, const float* pwb, const float* pwf,
    const float* pbf, const float* wi, const float* bi, const float* wb, const float* bb,
    const float* wf, const int* idx, float* gwi, float* gbi, float* gwb, float* gbb, float* gwf,
    float* gbf, float* stash, int grid, int transformer, float wh_scale, int num_bins,
    float tail_bound, float min_bin_width, float min_bin_height, float min_derivative,
    int rows_per_block, void* stream) {
  if (n == 0) return 0;
  if (H % 4 || D4 % 4 || Pp % 4 || nb2 % 2 || D4 < D || Pp < P || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (transformer != 0 && transformer != 1) return (int)cudaErrorInvalidValue;
  if (P != (transformer ? (3 * num_bins - 1) * D : 2 * D)) return (int)cudaErrorInvalidValue;
  MafTrainArgs a;
  a.x = x; a.gy = gy; a.glad = glad; a.gx = gx; a.n = n;
  a.D = D; a.L = L; a.H = H; a.D4 = D4; a.P = P; a.Pp = Pp;
  a.TB = H > Pp ? H : Pp;
  if (D4 > a.TB) a.TB = D4;
  a.nb2 = nb2;
  a.pwi = pwi; a.pwb = pwb; a.pwf = pwf; a.pbf = pbf;
  a.wi = wi; a.bi = bi; a.wb = wb; a.bb = bb; a.wf = wf; a.idx = idx;
  a.gwi = gwi; a.gbi = gbi; a.gwb = gwb; a.gbb = gbb; a.gwf = gwf; a.gbf = gbf;
  a.stash = stash;
  a.rq = transformer;
  a.wh_scale = wh_scale;
  a.cfg = nflows::RQConfig{num_bins, tail_bound, min_bin_width, min_bin_height, min_derivative,
                           1.0f};
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_block == 32) return launch<32>(a, grid, s);
  if (rows_per_block == 64) return launch<64>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}
