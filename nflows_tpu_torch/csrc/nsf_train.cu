// B3 and B4: training kernels of the coupling chain, all seven coupling
// families.
//
// B3 (nsf_loss_grad_kernel) replaces the TPU kernel
// nflows_tpu/ops/pallas/nsf_train.py:_loss_grad_kernel: one launch gives the
// per-sample log_prob under the StandardNormal base and every weight
// gradient of loss = -mean(log_prob); the cotangents are analytic
// (d loss / dy = y / N, d loss / dlogabsdet = -1 / N).
// B4 (nsf_train_bwd_kernel) replaces nsf_train.py:_bwd_kernel: it recomputes
// the chain from x and pulls given cotangents (gy, glad) back to gx and
// every weight gradient; it is the backward of B2 (nsf_flow_kernel.cu).
// Both run every family B2 runs (the rq, lrs, linear, quadratic and cubic
// splines with linear tails, the affine and additive couplings), fp32, with
// and without a per-sample context, and share all their device code. With
// a context, B3 also gives the gradients of the context weights (gwc0,
// gwcb, gbcb) and B4 those and gctx, the cotangent of the context itself,
// through which an embedding net outside the kernel trains.
//
// Bound on the H100: operations. One chain pass and its backward are three
// forward-equivalents of fp32 GEMM work (forward, input cotangents, weight
// gradients), about 17 MFLOP a sample at the flagship, against 28 to 52
// bytes a sample and 22 MB of weights read and gradients written.
//
// Design.
// - The TPU kernels differentiate each layer with jax.vjp traced inside the
//   kernel. Here the adjoints are written out: the conditioner's backward as
//   tile GEMMs (tile_gemm.cuh), the coupling stage's by the family's
//   header: rq_spline_bwd.cuh, lrs_spline_bwd.cuh, linear_spline_bwd.cuh,
//   quadratic_spline_bwd.cuh, cubic_spline_bwd.cuh, or affine_coupling.cuh
//   (affine, additive). Each differentiates the forward branch only: the
//   training kernels never run a stage's inverse. The forward runs the
//   shared stage of coupling_stage.cuh.
// - The family is a run-time switch (stage_adjoint_eval), uniform over the
//   grid, where B2 instantiates its kernel once a family: the GEMMs set
//   these kernels' registers, and on an H100 the rq and affine B3/B4 read
//   within 1.3% of one instantiation a family, while this source built in
//   112 s against 263 s for 24 instantiations (PERF.md §6).
// - A block walks over tiles of ROWS samples (a persistent grid of at most
//   one block an SM). Per tile: one forward pass of the chain that keeps
//   what the backward needs, then the backward sweep over the layers.
// - What is kept: each layer's input ([D][ROWS], in shared memory) and, per
//   layer, the hidden state before each residual block and after the last,
//   the relu'd inner activation of each block, with a context the output
//   u = W1 t + b1 of each block's second linear before its gate, and the
//   spline parameters P.
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
// - The context. Its tile [C][ROWS + 4] stays in shared memory for the
//   whole tile, as in B2. A block's output is h' = h + u s with
//   s = sigmoid(g), g = Wcb ctx + bcb; its adjoint, written out:
//   du = dh' s, dg = dh' u s (1 - s), gWcb += dg ctx^T, gbcb += sum dg, and
//   the initial layer's gWc0 += dh0 ctx^T. The forward keeps u (u from
//   (h' - h) / s would lose it where s underflows); the backward recomputes
//   g, a C-deep tile_gemm, about C / H of an H-deep one, rather than keep it
//   too. B4 sums gctx = sum over layers of (Wc0^T dh0 + sum_j Wcb_j^T dg_j)
//   in a shared-memory tile [C][ROWS]: one thread a (feature, sample), a
//   loop over H, as for the identity half's cotangent; a tile_gemm C4 wide
//   would run on one warp. The context path is a template flag, as in B2:
//   with it in a run-time branch on C, the unconditional kernels' registers
//   at 32 rows went from 214-246 to 254-255 and their spill loads at 64 rows
//   doubled. So the source holds 8 kernels: {B3, B4} x {32, 64 rows} x
//   {with, without a context}.
// - The ragged last tile computes on zero rows with zero cotangents, so it
//   adds nothing for them, and skips their stores.
// Shared memory holds the weight staging buffers and three activation
// matrices [max(H, TM)][ROWS + 4], plus the context's two tiles; ROWS is 32,
// or 64 where that fits.
// Where the tiles would leave SMs idle, the wrapper runs the same kernels
// with each 32-sample tile spread over a thread-block cluster instead
// (nsf_train_cluster.cu); both sources share nsf_train.cuh.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nsf_train.cuh"
#include "tile_gemm.cuh"

namespace {

using nflows::KC;
using nflows::OC;
using nflows::tile_bgrad;
using nflows::tile_gemm;
using nflows::tile_wgrad;

template <int ROWS, bool LOSS, bool CTX>
__device__ void train_block(const TrainArgs& a) {
  constexpr int NT = ROWS * 8, RS = ROWS + 4;
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, L = a.L, H = a.H, Tid = a.Tid, I4 = a.I4, T = a.T;
  const int TM = a.TM, TMp = a.TMp, nb2 = a.nb2, nb = a.nb2 / 2;
  const int C = CTX ? a.C : 0;
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
  float* cs = gladv + ROWS;                 // [C][RS] the context
  float* gcs = cs + C * RS;                 // [C][ROWS] B4: the context's cotangent

  const int tid = threadIdx.x;
  const int idx_stride = 2 * Tid + 2 * T + 2 * D;
  const size_t SR = (size_t)a.SRB * H + TMp;  // scratch rows a layer
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
    if constexpr (CTX) {
      for (int e = tid; e < C * ROWS; e += NT) {
        const int c = e / ROWS, s = e % ROWS;
        cs[c * RS + s] = s < rows ? a.ctx[(base + s) * C + c] : 0.0f;
        if (!LOSS) gcs[e] = 0.0f;
      }
    }
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

      // h_0 (+ Wc0 ctx), then h_{j+1} = h_j + u_j (times sigmoid(Wcb_j ctx + bcb_j)),
      // u_j = W1 relu(W0 relu(h_j) + b0) + b1; Z holds the gate
      tile_gemm<ROWS, RS>(Y, I4, a.pw0 + (size_t)l * I4 * H, a.b0 + (size_t)l * H, H, X, false,
                          false, false, wst, nullptr, CTX ? nullptr : st);
      if constexpr (CTX)
        tile_gemm<ROWS, RS>(cs, C, a.pwc0 + (size_t)l * C * H, nullptr, H, X, false, false, true,
                            wst, nullptr, st);
      for (int j = 0; j < nb; ++j) {
        const size_t m = (size_t)l * nb2 + 2 * j;
        tile_gemm<ROWS, RS>(X, H, a.pwb + m * H * H, a.bb + m * H, H, Y, true, true, false, wst,
                            nullptr, st + (size_t)(nb + 1 + j) * H * RS);
        if constexpr (CTX) {
          const size_t g = (size_t)l * nb + j;
          tile_gemm<ROWS, RS>(cs, C, a.pwcb + g * C * H, a.bcb + g * H, H, Z, false, false, false,
                              wst);
          tile_gemm<ROWS, RS, true>(Y, H, a.pwb + (m + 1) * H * H, a.bb + (m + 1) * H, H, X,
                                    false, false, true, wst, nullptr,
                                    st + (size_t)(j + 1) * H * RS, Z,
                                    st + (size_t)(nb2 + 1 + j) * H * RS);
        } else {
          tile_gemm<ROWS, RS>(Y, H, a.pwb + (m + 1) * H * H, a.bb + (m + 1) * H, H, X, false,
                              false, true, wst, nullptr, st + (size_t)(j + 1) * H * RS);
        }
      }
      tile_gemm<ROWS, RS>(X, H, a.pwf + (size_t)l * H * TMp, a.pbf + (size_t)l * TMp, TMp, Y,
                          false, false, false, wst);

      // P = Y is [TM][RS], K-major rows; the softmax 1/sqrt(H) goes on the
      // width and height rows here, and P is kept as the stage reads it
      float* pst = st + (size_t)a.SRB * H * RS;
      for (int e = tid; e < TMp * ROWS; e += NT) {
        const int r = e / ROWS, at = r * RS + e % ROWS;
        const float v = r < a.scaled_rows ? Y[at] * a.wh_scale : Y[at];
        Y[at] = v;
        pst[at] = v;
      }
      __syncthreads();

      for (int e = tid; e < T * ROWS; e += NT) {
        const int t = e / ROWS, s = e % ROWS;
        nflows::coupling_stage_eval(xl[s * D + tr_src[t]], Y + t * RS + s, T * RS, false,
                                    a.cfg, ybuf + s * T + t, lbuf + s * T + t);
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
      restore<ROWS>(X, st + (size_t)a.SRB * H * RS, TMp, false);  // P
      for (int e = tid; e < (TMp - TM) * RS; e += NT) Y[TM * RS + e] = 0.0f;
      __syncthreads();

      // stage adjoint: gP into Y, the transformed inputs' cotangents into ybuf
      for (int e = tid; e < T * ROWS; e += NT) {
        const int t = e / ROWS, s = e % ROWS;
        stage_adjoint_eval(xl[s * D + tr_src[t]], X + t * RS + s, Y + t * RS + s, T * RS,
                           a.cfg, gcat[s * D + Tid + t], gladv[s], a.wh_scale,
                           ybuf + s * T + t);
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
        if constexpr (CTX) {
          // the gate: g = Wcb ctx + bcb into Y, u into X; then dg into Y, du into X
          const size_t g = (size_t)l * nb + j;
          restore<ROWS>(X, st + (size_t)(nb2 + 1 + j) * H * RS, H, false);  // u
          tile_gemm<ROWS, RS>(cs, C, a.pwcb + g * C * H, a.bcb + g * H, H, Y, false, false,
                              false, wst);
          for (int e = tid; e < H * ROWS; e += NT) {
            const int at = (e / ROWS) * RS + e % ROWS;
            const float sg = nflows::gate_sigmoid(Y[at]), dh = Z[at];
            Y[at] = dh * X[at] * sg * (1.0f - sg);
            X[at] = dh * sg;
          }
          __syncthreads();
          tile_wgrad<ROWS, RS>(Y, H, cs, C, a.gwcb + g * H * C, C);
          tile_bgrad<ROWS, RS>(Y, H, a.gbcb + g * H);
          if (!LOSS) add_context_cotangent<ROWS>(Y, a.wcb + g * H * C, H, C, gcs);
          __syncthreads();
          restore<ROWS>(Y, st + (size_t)(nb + 1 + j) * H * RS, H, false);  // t
          __syncthreads();
          tile_wgrad<ROWS, RS>(X, H, Y, H, a.gwb + (m + 1) * H * H, H);
          tile_bgrad<ROWS, RS>(X, H, a.gbb + (m + 1) * H);
          // g_t = (W1^T du) where t > 0, written over t
          tile_gemm<ROWS, RS>(X, H, a.wb + (m + 1) * H * H, nullptr, H, Y, false, false, false,
                              wst, Y);
        } else {
          restore<ROWS>(X, st + (size_t)(nb + 1 + j) * H * RS, H, false);  // t = relu(W0 relu(h) + b0)
          __syncthreads();
          tile_wgrad<ROWS, RS>(Z, H, X, H, a.gwb + (m + 1) * H * H, H);
          tile_bgrad<ROWS, RS>(Z, H, a.gbb + (m + 1) * H);
          // g_t = (W1^T g_h) where t > 0
          tile_gemm<ROWS, RS>(Z, H, a.wb + (m + 1) * H * H, nullptr, H, Y, false, false, false,
                              wst, X);
        }
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
      if constexpr (CTX) {  // gWc0 += g_h ctx^T, gctx += Wc0^T g_h
        tile_wgrad<ROWS, RS>(Z, H, cs, C, a.gwc0 + (size_t)l * H * C, C);
        if (!LOSS) add_context_cotangent<ROWS>(Z, a.wc0 + (size_t)l * H * C, H, C, gcs);
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

    if (!LOSS) {
      for (int e = tid; e < rows * D; e += NT) a.gx[base * D + e] = gcur[e];
      if constexpr (CTX)
        for (int e = tid; e < rows * C; e += NT)
          a.gctx[base * C + e] = gcs[(e % C) * ROWS + e / C];
    }
    __syncthreads();
  }
}

template <int ROWS, bool CTX>
__global__ void __launch_bounds__(ROWS * 8) nsf_loss_grad_kernel(TrainArgs a) {
  train_block<ROWS, true, CTX>(a);
}

template <int ROWS, bool CTX>
__global__ void __launch_bounds__(ROWS * 8) nsf_train_bwd_kernel(TrainArgs a) {
  train_block<ROWS, false, CTX>(a);
}

size_t smem_bytes(int rows, const TrainArgs& a) {
  return sizeof(float) * ((size_t)2 * KC * OC + (size_t)3 * a.TB * (rows + 4) +
                          (size_t)rows * ((a.L + 4) * a.D + 2 * a.T + a.Tid + 2) +
                          (size_t)a.C * (2 * rows + 4));
}

template <int ROWS, bool LOSS, bool CTX>
int launch(const TrainArgs& a, int grid, cudaStream_t stream) {
  const size_t bytes = smem_bytes(ROWS, a);
  auto kernel = LOSS ? nsf_loss_grad_kernel<ROWS, CTX> : nsf_train_bwd_kernel<ROWS, CTX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, ROWS * 8, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int ROWS, bool CTX>
int launch_rows(const TrainArgs& a, int loss, int grid, cudaStream_t stream) {
  return loss ? launch<ROWS, true, CTX>(a, grid, stream)
              : launch<ROWS, false, CTX>(a, grid, stream);
}

}  // namespace

// One entry point for both kernels: loss != 0 runs B3 (writes lp; gy, glad and
// gx unused), loss == 0 runs B4 (reads gy and glad, writes gx; lp unused).
// family: a CouplingFamily (coupling_stage.cuh), scale_act a
// ScaleActivation (affine only); num_bins is 0 for the affine and additive
// couplings, and a family ignores the floats it has no use for (as B2's
// nsf_flow_launch takes them).
// grid: blocks to launch; stash holds grid x L x (SRB H + TMp) x
// (rows_per_block + 4) floats, SRB = nb2 + 1 + (C ? nb2 / 2 : 0). With a
// context (C > 0): ctx [n][C], its weights in-major for the forward (pwc0,
// pwcb, as nsf_flow_kernel.py:pack_weights lays them), bcb, the trained
// layout wc0 [L][H][C] and wcb [L][nb][H][C], their gradients (zeroed by the
// caller, as the others), and for B4 gctx [n][C]; C = 0 leaves them unread.
// cluster_size: 1 (a tile a block; nsf_train_cluster_launch takes the
// others). rows_per_block: 32 or 64. Returns a cudaError_t value (0 on
// success).
extern "C" int nsf_train_launch(NSF_TRAIN_LAUNCH_PARAMS) {
  if (n == 0) return 0;
  TrainArgs a;
  const int err = pack_train_args(a, NSF_TRAIN_LAUNCH_NAMES);
  if (err || cluster_size != 1) return err ? err : (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_block == 32) return C ? launch_rows<32, true>(a, loss, grid, s)
                                     : launch_rows<32, false>(a, loss, grid, s);
  if (rows_per_block == 64) return C ? launch_rows<64, true>(a, loss, grid, s)
                                     : launch_rows<64, false>(a, loss, grid, s);
  return (int)cudaErrorInvalidValue;
}
