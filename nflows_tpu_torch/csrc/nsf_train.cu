// B3 and B4: training kernels of the RQ-NSF coupling chain.
//
// B3 (nsf_loss_grad_kernel) replaces the TPU kernel
// nflows_tpu/ops/pallas/nsf_train.py:_loss_grad_kernel: one launch gives the
// per-sample log_prob under the StandardNormal base and every weight
// gradient of loss = -mean(log_prob); the cotangents are analytic
// (d loss / dy = y / N, d loss / dlogabsdet = -1 / N).
// B4 (nsf_train_bwd_kernel) replaces nsf_train.py:_bwd_kernel: it recomputes
// the chain from x and pulls given cotangents (gy, glad) back to gx and
// every weight gradient; it is the backward of B2 (nsf_flow_kernel.cu).
// Both are rq family, fp32, no context, and share all their device code.
//
// Bound on the H100: operations. One chain pass and its backward are three
// forward-equivalents of fp32 GEMM work (forward, input cotangents, weight
// gradients), about 17 MFLOP a sample at the flagship, against 28 to 52
// bytes a sample and 22 MB of weights read and gradients written.
//
// Design.
// - The TPU kernels differentiate each layer with jax.vjp traced inside the
//   kernel. Here the adjoints are written out: the conditioner's backward as
//   tile GEMMs (tile_gemm.cuh), the spline's by rq_spline_bwd.cuh.
// - A block walks over tiles of ROWS samples (a persistent grid of at most
//   one block an SM). Per tile: one forward pass of the chain that keeps
//   what the backward needs, then the backward sweep over the layers.
// - What is kept: each layer's input ([D][ROWS], in shared memory) and, per
//   layer, the hidden state before each residual block and after the last,
//   the relu'd inner activation of each block, and the spline parameters P.
//   At the flagship that is (5 x 256 + 72) rows x 36 floats x 10 layers =
//   1.9 MB a block, which shared memory (227 KB) cannot hold. It goes to a
//   per-block scratch in global memory, written from the GEMM epilogues and
//   read back a matrix at a time; 132 blocks hold 257 MB, more than the L2,
//   so these activations do travel to device memory and back (the TPU
//   kernels keep them in VMEM). That costs a few percent of the step's
//   time and saves re-running every layer's forward in the backward.
// - Three GEMM shapes. Forward out = W in reads the packed in-major weights
//   B2 reads (nsf_flow_kernel.py:pack_weights, re-packed after each
//   optimizer step). The input cotangent g_in = W^T g_out is the same
//   routine on the [out][in] matrices the weights are trained in. The
//   weight gradient gW[o][k] = sum_s g[o][s] in[k][s] is tile_wgrad.
// - Blocks run in no order, so a tile's weight gradients are added into the
//   global gradient buffers with atomicAdd (fp32, red.global.add); the
//   wrapper zeroes the buffers before each launch. The order of the adds
//   changes from run to run, so gradients agree run to run only to fp32
//   rounding of a sum over the batch. The sum does not depend on the tile
//   size beyond that rounding.
// - The ragged last tile computes on zero rows with zero cotangents, so it
//   adds nothing for them, and skips their stores.
// Shared memory holds the weight staging buffers and three activation
// matrices [max(H, TM)][ROWS + 4]; ROWS is 32, or 64 where that fits.
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

struct TrainArgs {
  const float* x;     // [n][D]
  const float* gy;    // [n][D]  B4: cotangent of the chain's output
  const float* glad;  // [n]     B4: cotangent of the logabsdet
  float* lp;          // [n]     B3: log_prob
  float* gx;          // [n][D]  B4: cotangent of x
  int64_t n;
  int D, L, H, Tid, I4, T, TM, TMp, TB, nb2;
  // forward weights, in-major and padded (pack_weights)
  const float* pw0;  // [L][I4][H]
  const float* pwb;  // [L][nb2][H][H]
  const float* pwf;  // [L][H][TMp]
  const float* pbf;  // [L][TMp]
  // the trained layout, [out][in]
  const float* w0;   // [L][H][Tid]
  const float* b0;   // [L][H]
  const float* wb;   // [L][nb2][H][H]
  const float* bb;   // [L][nb2][H]
  const float* wf;   // [L][TM][H]
  const int* idx;    // [L][2 Tid + 2 T + 2 D]
  // gradients, in the trained layout, zeroed by the caller
  float* gw0;
  float* gb0;
  float* gwb;
  float* gbb;
  float* gwf;
  float* gbf;
  float* stash;  // [grid][L][(nb2 + 1) H + TMp][ROWS + 4]
  float wh_scale, inv_n, log_z;
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

template <int ROWS, bool LOSS>
__device__ void train_block(const TrainArgs& a) {
  constexpr int NT = ROWS * 8, RS = ROWS + 4;
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, L = a.L, H = a.H, Tid = a.Tid, I4 = a.I4, T = a.T;
  const int TM = a.TM, TMp = a.TMp, nb2 = a.nb2, nb = a.nb2 / 2;
  float* wst = smem;                        // [2][KC][OC]
  float* X = wst + 2 * KC * OC;             // [TB][RS]
  float* Y = X + a.TB * RS;                 // [TB][RS]
  float* Z = Y + a.TB * RS;                 // [TB][RS]
  float* xs = Z + a.TB * RS;                // [L + 1][ROWS][D] layer inputs, then the output
  float* gcur = xs + (L + 1) * ROWS * D;    // [ROWS][D] cotangent of the layer's output
  float* gnext = gcur + ROWS * D;           // [ROWS][D] cotangent of the layer's input
  float* gcat = gnext + ROWS * D;           // [ROWS][D] cotangent of concat(identity, spline)
  float* ybuf = gcat + ROWS * D;            // [ROWS][T] spline outputs / input cotangents
  float* lbuf = ybuf + ROWS * T;            // [ROWS][T] spline logabsdets
  float* ga0 = lbuf + ROWS * T;             // [Tid][ROWS] cotangent of the identity split
  float* ladacc = ga0 + Tid * ROWS;         // [ROWS]
  float* gladv = ladacc + ROWS;             // [ROWS] cotangent of the logabsdet

  const int tid = threadIdx.x;
  const int K = a.cfg.num_bins;
  const int KT = K * T;
  const int idx_stride = 2 * Tid + 2 * T + 2 * D;
  const size_t SR = (size_t)(nb2 + 1) * H + TMp;  // scratch rows a layer
  float* stash = a.stash + (size_t)blockIdx.x * L * SR * RS;
  const int64_t ntiles = (a.n + ROWS - 1) / ROWS;

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = tile * ROWS;
    const int rows = (int)min((int64_t)ROWS, a.n - base);

    for (int e = tid; e < ROWS * D; e += NT) {
      const int s = e / D;
      xs[e] = s < rows ? a.x[(base + s) * D + (e % D)] : 0.0f;
    }
    for (int s = tid; s < ROWS; s += NT) ladacc[s] = 0.0f;
    __syncthreads();

    // ---- forward pass, keeping what the backward needs ------------------------
    for (int l = 0; l < L; ++l) {
      const float* xl = xs + l * ROWS * D;
      float* xn = xs + (l + 1) * ROWS * D;
      const int* id_src = a.idx + l * idx_stride;
      const int* tr_src = id_src + Tid;
      const int* merge = tr_src + T;
      float* st = stash + (size_t)l * SR * RS;

      for (int e = tid; e < I4 * ROWS; e += NT) {
        const int i = e / ROWS, s = e % ROWS;
        Y[i * RS + s] = i < Tid ? xl[s * D + id_src[i]] : 0.0f;
      }
      __syncthreads();

      // h_0, then h_{j+1} = h_j + W1 relu(W0 relu(h_j) + b0) + b1
      tile_gemm<ROWS, RS>(Y, I4, a.pw0 + (size_t)l * I4 * H, a.b0 + (size_t)l * H, H, X, false,
                          false, false, wst, nullptr, st);
      for (int j = 0; j < nb; ++j) {
        const size_t m = (size_t)l * nb2 + 2 * j;
        tile_gemm<ROWS, RS>(X, H, a.pwb + m * H * H, a.bb + m * H, H, Y, true, true, false, wst,
                            nullptr, st + (size_t)(nb + 1 + j) * H * RS);
        tile_gemm<ROWS, RS>(Y, H, a.pwb + (m + 1) * H * H, a.bb + (m + 1) * H, H, X, false,
                            false, true, wst, nullptr, st + (size_t)(j + 1) * H * RS);
      }
      tile_gemm<ROWS, RS>(X, H, a.pwf + (size_t)l * H * TMp, a.pbf + (size_t)l * TMp, TMp, Y,
                          false, false, false, wst);

      // P = Y is [TM][RS], K-major rows; the softmax 1/sqrt(H) goes on the
      // width and height rows here, and P is kept as the spline reads it
      float* pst = st + (size_t)(nb2 + 1) * H * RS;
      for (int e = tid; e < TMp * ROWS; e += NT) {
        const int r = e / ROWS, at = r * RS + e % ROWS;
        const float v = r < 2 * KT ? Y[at] * a.wh_scale : Y[at];
        Y[at] = v;
        pst[at] = v;
      }
      __syncthreads();

      for (int e = tid; e < T * ROWS; e += NT) {
        const int t = e / ROWS, s = e % ROWS;
        const float* P = Y + t * RS + s;
        nflows::rq_spline_eval(xl[s * D + tr_src[t]], P, P + KT * RS, P + 2 * KT * RS, T * RS,
                               false, a.cfg, ybuf + s * T + t, lbuf + s * T + t);
      }
      __syncthreads();

      for (int e = tid; e < ROWS * D; e += NT) {
        const int s = e / D, m = merge[e % D];
        xn[e] = m < Tid ? xl[s * D + id_src[m]] : ybuf[s * T + (m - Tid)];
      }
      for (int s = tid; s < ROWS; s += NT) {
        float sum = 0.0f;
        for (int t = 0; t < T; ++t) sum += lbuf[s * T + t];
        ladacc[s] += sum;
      }
      __syncthreads();
    }

    // ---- cotangents of the chain's output --------------------------------------
    const float* y = xs + L * ROWS * D;
    if (LOSS) {
      for (int s = tid; s < ROWS; s += NT) {
        float sq = 0.0f;
        for (int d = 0; d < D; ++d) sq += y[s * D + d] * y[s * D + d];
        if (s < rows) a.lp[base + s] = -0.5f * sq - a.log_z + ladacc[s];
        gladv[s] = s < rows ? -a.inv_n : 0.0f;
      }
      for (int e = tid; e < ROWS * D; e += NT) gcur[e] = e / D < rows ? y[e] * a.inv_n : 0.0f;
    } else {
      for (int s = tid; s < ROWS; s += NT) gladv[s] = s < rows ? a.glad[base + s] : 0.0f;
      for (int e = tid; e < ROWS * D; e += NT)
        gcur[e] = e / D < rows ? a.gy[base * D + e] : 0.0f;
    }
    __syncthreads();

    // ---- backward sweep ----------------------------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      const float* xl = xs + l * ROWS * D;
      const int* id_src = a.idx + l * idx_stride;
      const int* tr_src = id_src + Tid;
      const int* merge = tr_src + T;
      const float* st = stash + (size_t)l * SR * RS;

      // y[r] = concat(identity, spline)[merge[r]]
      for (int e = tid; e < ROWS * D; e += NT) gcat[(e / D) * D + merge[e % D]] = gcur[e];
      restore<ROWS>(X, st + (size_t)(nb2 + 1) * H * RS, TMp, false);  // P
      for (int e = tid; e < (TMp - TM) * RS; e += NT) Y[TM * RS + e] = 0.0f;
      __syncthreads();

      // spline adjoint: gP into Y, the transformed inputs' cotangents into ybuf
      for (int e = tid; e < T * ROWS; e += NT) {
        const int t = e / ROWS, s = e % ROWS;
        const float* P = X + t * RS + s;
        float* G = Y + t * RS + s;
        nflows::rq_spline_forward_adjoint(
            xl[s * D + tr_src[t]], P, P + KT * RS, P + 2 * KT * RS, T * RS, a.cfg,
            gcat[s * D + Tid + t], gladv[s], a.wh_scale, ybuf + s * T + t, G, G + KT * RS,
            G + 2 * KT * RS);
      }
      __syncthreads();

      // final layer: gWf += gP h^T, gbf += gP 1, g_h = Wf^T gP
      restore<ROWS>(X, st + (size_t)nb * H * RS, H, false);  // h after the last block
      __syncthreads();
      tile_wgrad<ROWS, RS>(Y, TM, X, H, a.gwf + (size_t)l * TM * H, H);
      tile_bgrad<ROWS, RS>(Y, TM, a.gbf + (size_t)l * TM);
      tile_gemm<ROWS, RS>(Y, TM, a.wf + (size_t)l * TM * H, nullptr, H, Z, false, false, false,
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

      // initial layer: gW0 += g_h identity^T, gb0 += g_h 1, g_identity = W0^T g_h
      const float* w0 = a.w0 + (size_t)l * H * Tid;
      for (int e = tid; e < H * Tid; e += NT) {
        const int o = e / Tid, src = id_src[e % Tid];
        float sum = 0.0f;
        for (int s = 0; s < ROWS; ++s) sum += Z[o * RS + s] * xl[s * D + src];
        atomicAdd(a.gw0 + (size_t)l * H * Tid + e, sum);
      }
      tile_bgrad<ROWS, RS>(Z, H, a.gb0 + (size_t)l * H);
      for (int e = tid; e < Tid * ROWS; e += NT) {
        const int i = e / ROWS, s = e % ROWS;
        float sum = 0.0f;
        for (int o = 0; o < H; ++o) sum += w0[o * Tid + i] * Z[o * RS + s];
        ga0[e] = sum;
      }
      __syncthreads();

      // the identity half feeds both the output and the conditioner
      for (int e = tid; e < ROWS * Tid; e += NT) {
        const int s = e / Tid, i = e % Tid;
        gnext[s * D + id_src[i]] = gcat[s * D + i] + ga0[i * ROWS + s];
      }
      for (int e = tid; e < ROWS * T; e += NT) {
        const int s = e / T, t = e % T;
        gnext[s * D + tr_src[t]] = ybuf[e];
      }
      __syncthreads();
      float* tmp = gcur; gcur = gnext; gnext = tmp;
    }

    if (!LOSS)
      for (int e = tid; e < rows * D; e += NT) a.gx[base * D + e] = gcur[e];
    __syncthreads();
  }
}

template <int ROWS>
__global__ void __launch_bounds__(ROWS * 8) nsf_loss_grad_kernel(TrainArgs a) {
  train_block<ROWS, true>(a);
}

template <int ROWS>
__global__ void __launch_bounds__(ROWS * 8) nsf_train_bwd_kernel(TrainArgs a) {
  train_block<ROWS, false>(a);
}

size_t smem_bytes(int rows, const TrainArgs& a) {
  return sizeof(float) * ((size_t)2 * KC * OC + (size_t)3 * a.TB * (rows + 4) +
                          (size_t)rows * ((a.L + 4) * a.D + 2 * a.T + a.Tid + 2));
}

template <int ROWS, bool LOSS>
int launch(const TrainArgs& a, int grid, cudaStream_t stream) {
  const size_t bytes = smem_bytes(ROWS, a);
  auto kernel = LOSS ? nsf_loss_grad_kernel<ROWS> : nsf_train_bwd_kernel<ROWS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, ROWS * 8, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point for both kernels: loss != 0 runs B3 (writes lp; gy, glad and
// gx unused), loss == 0 runs B4 (reads gy and glad, writes gx; lp unused).
// grid: blocks to launch; stash holds grid x L x ((nb2 + 1) H + TMp) x
// (rows_per_block + 4) floats. rows_per_block: 32 or 64. Returns a
// cudaError_t value (0 on success).
extern "C" int nsf_train_launch(
    int loss, const float* x, const float* gy, const float* glad, float* lp, float* gx,
    int64_t n, int D, int L, int H, int Tid, int I4, int T, int TM, int TMp, int nb2,
    const float* pw0, const float* pwb, const float* pwf, const float* pbf, const float* w0,
    const float* b0, const float* wb, const float* bb, const float* wf, const int* idx,
    float* gw0, float* gb0, float* gwb, float* gbb, float* gwf, float* gbf, float* stash,
    int grid, float wh_scale, float inv_n, int num_bins, float tail_bound, float min_bin_width,
    float min_bin_height, float min_derivative, int rows_per_block, void* stream) {
  if (n == 0) return 0;
  if (H % 4 || I4 % 4 || TMp % 4 || nb2 % 2 || grid < 1) return (int)cudaErrorInvalidValue;
  TrainArgs a;
  a.x = x; a.gy = gy; a.glad = glad; a.lp = lp; a.gx = gx; a.n = n;
  a.D = D; a.L = L; a.H = H; a.Tid = Tid; a.I4 = I4; a.T = T; a.TM = TM; a.TMp = TMp;
  a.TB = H > TMp ? H : TMp;
  if (I4 > a.TB) a.TB = I4;
  a.nb2 = nb2;
  a.pw0 = pw0; a.pwb = pwb; a.pwf = pwf; a.pbf = pbf;
  a.w0 = w0; a.b0 = b0; a.wb = wb; a.bb = bb; a.wf = wf; a.idx = idx;
  a.gw0 = gw0; a.gb0 = gb0; a.gwb = gwb; a.gbb = gbb; a.gwf = gwf; a.gbf = gbf;
  a.stash = stash;
  a.wh_scale = wh_scale;
  a.inv_n = inv_n;
  a.log_z = 0.5f * (float)D * logf(2.0f * 3.14159265358979323846f);
  a.cfg = nflows::RQConfig{num_bins, tail_bound, min_bin_width, min_bin_height, min_derivative,
                           1.0f};
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_block == 32) return loss ? launch<32, true>(a, grid, s) : launch<32, false>(a, grid, s);
  if (rows_per_block == 64) return loss ? launch<64, true>(a, grid, s) : launch<64, false>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}
