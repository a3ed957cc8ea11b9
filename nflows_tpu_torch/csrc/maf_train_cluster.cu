// B10 with a tile spread over a thread-block cluster: the same function as
// maf_train.cu (which see, for the TPU kernel it replaces, its bound, the
// adjoint and the stash), laid out so that a small batch fills the card.
// There a block holds a tile of 32 samples and walks the whole chain alone,
// so a batch of 512 runs 16 blocks on the H100's 132 SMs, and the kernel's
// time is the latency of one tile's pass on one SM. Here the CS blocks of a
// cluster share each tile, as B3 and B4 do in nsf_train_cluster.cu: block r
// owns columns [r H / CS, (r + 1) H / CS) of every H-wide GEMM and its share
// of the final layer's Pp columns, cut in groups of four, computes them from
// full copies of the activation tiles X, Y and Z in its shared memory and
// stores them into every block's copy through distributed shared memory
// (cl_gemm, csrc/cluster_gemm.cuh); a cluster barrier separates those
// stores from the next reader. Where the MADE differs from B3/B4:
// 1. The MADE passes. The forward recompute runs the initial layer, the two
//    linears of each residual block and the final layer; the backward
//    Wf^T gP, W1^T g_h where t > 0 and W0^T g_t where h > 0. Each is a
//    cl_gemm over the block's columns ending in one cluster barrier, on the
//    mask-folded dense stacks as maf_train.cu reads them (the masked zeros
//    are multiplied; the caller masks the gradients). Weight gradients by
//    rows: block r adds the rows o of gwi, gbi, gwb and gbb in its H slice
//    and those of gwf and gbf in its P slice (cl_wgrad, cl_bgrad), so the
//    number of atomics does not grow.
// 2. The initial layer's backward, hand-written in maf_train.cu: each block
//    adds gwi for its own rows o only (one atomic an (o, i)). ga0 = Wi^T g_h
//    is computed in every block from its full copy of g_h, a warp an
//    element: D x 32 dot products of depth H cost less than the
//    distributed-shared-memory reduction and the cluster barrier that a sum
//    over owned rows would need, and gcur / gnext then agree in every block
//    with no further exchange.
// 3. The transformer (affine or rq, with wh_scale) and its adjoint run in
//    every block on its full copies: each block keeps its own rows of P in
//    the cluster's stash and restores P whole from it in the backward. The
//    permutation's gather or scatter (by `inverse`) stays a small step in
//    every block. Only rank 0 stores gx.
// 4. Context (CTX). Wci c + bci and Wcb_j c + bcb_j are cl_gemms on the
//    block's own columns only (the next GEMM adds its product into those
//    columns and exchanges the sum), so they are never exchanged; so is
//    Wci c + bci recomputed for the initial layer's relu mask in the
//    backward. The context's cotangent (context_cotangent) is summed by each
//    block over its rows o, and the partial sums are added into rank 0's
//    with distributed-shared-memory atomics at the tile's end, as B4's gctx
//    is; gwci, gbci, gwcb and gbcb go by rows.
// 5. The stash holds one slot a cluster, not a block: grid / CS x L x
//    ((nb2 + 1) H + Pp) x 36 floats; each block writes its columns of the
//    kept matrices.
// 6. Shared memory: maf_train.cu's tiles with cl_gemm's buffer in place of
//    tile_gemm's (smem_bytes; ops/cuda/maf_train.py: shared_memory_bytes).
// Barriers: one cluster barrier after each exchanged GEMM, which also orders
// the next GEMM's stores after every read of its output's old contents (no
// block reads another block's columns of a GEMM's output in the same
// phase), one between the forward and the backward (the last layer's P is
// restored whole from the rows each block stashed), one at the end of each
// layer's backward (ga0 reads all of g_h before the next layer's Wf^T gP is
// stored over it) and, with a context, one before rank 0 reads the summed
// gctx. The order of each dot product's sum differs from maf_train.cu's (the
// depth is split over warps), so results agree with it to fp32 rounding.
// Tiles are 32 samples; CS is a template parameter, instantiated at 2, 4 and
// 8 (ops/cuda/maf_train.py: launch_layout chooses). The launch is
// cudaLaunchKernelEx with a cluster dimension, a persistent grid of at most
// cudaOccupancyMaxActiveClusters clusters walking over the tiles.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_gemm.cuh"
#include "maf_train.cuh"
#include "rq_spline.cuh"
#include "rq_spline_bwd.cuh"

namespace {

using nflows::cl_bgrad;
using nflows::cl_gemm;
using nflows::cl_wgrad;
using nflows::cluster_sync;
using nflows::cl::CW;
using nflows::cl::KCL;
using nflows::cl::NSTAGE;
using nflows::cl::WBUF;

constexpr float kAffineEpsilon = 1e-3f;

template <int CS, bool CTX>
__global__ void __launch_bounds__(nflows::cl::NT, 1)
    maf_train_bwd_cluster_kernel(MafTrainArgs a) {
  constexpr int ROWS = nflows::cl::ROWS, NT = nflows::cl::NT, RS = nflows::cl::RS;
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, L = a.L, H = a.H, D4 = a.D4, P = a.P, Pp = a.Pp;
  const int nb2 = a.nb2, nb = a.nb2 / 2;
  const int C = CTX ? a.C : 0, C4 = CTX ? a.C4 : 0;
  float* buf = smem;                        // [WBUF] weight ring and partial tiles
  float* X = buf + WBUF;                    // [TB][RS]
  float* Y = X + a.TB * RS;                 // [TB][RS]
  float* Z = Y + a.TB * RS;                 // [TB][RS]
  float* xs = Z + a.TB * RS;                // [L + 1][ROWS][D] layer inputs, then the output
  float* gcur = xs + (L + 1) * ROWS * D;    // [ROWS][D] cotangent of the layer's output
  float* gnext = gcur + ROWS * D;           // [ROWS][D] cotangent of the layer's input
  float* ybuf = gnext + ROWS * D;           // [ROWS][D] cotangent through the transformer
  float* ga0 = ybuf + ROWS * D;             // [D][ROWS] cotangent through the MADE
  float* gladv = ga0 + D * ROWS;            // [ROWS] cotangent of the logabsdet
  float* cs = gladv + ROWS;                 // [C4][RS] context (CTX only)
  float* gcs = cs + C4 * RS;                // [C4][RS] its cotangent, this block's rows o
  const bool inv = a.inverse != 0;

  const int rank = nflows::cluster_rank();
  int h0, h1, p0, p1;
  nflows::owned_cols(H, rank, CS, h0, h1);   // this block's rows of the H-wide matrices
  nflows::owned_cols(Pp, rank, CS, p0, p1);  // and of P
  const int pt1 = max(p0, min(p1, P));       // its rows of the final layer's weights
  const int tid = threadIdx.x;
  const int KD = a.cfg.num_bins * D;
  const int idx_stride = 2 * D + 1;
  const size_t SR = (size_t)(nb2 + 1) * H + Pp;  // scratch rows a layer
  const int64_t cluster = blockIdx.x / CS, nclusters = gridDim.x / CS;
  float* stash = a.stash + (size_t)cluster * L * SR * RS;
  const int64_t ntiles = (a.n + ROWS - 1) / ROWS;

  for (int64_t tile = cluster; tile < ntiles; tile += nclusters) {
    const int64_t base = tile * ROWS;
    const int rows = (int)min((int64_t)ROWS, a.n - base);

    for (int e = tid; e < ROWS * D; e += NT) {
      const int s = e / D;
      xs[e] = s < rows ? a.x[(base + s) * D + (e % D)] : 0.0f;
    }
    if constexpr (CTX) {
      for (int e = tid; e < C4 * ROWS; e += NT) {
        const int i = e / ROWS, s = e % ROWS;
        cs[i * RS + s] = (i < C && s < rows) ? a.ctx[(base + s) * C + i] : 0.0f;
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
      // h_{j+1} = h_j + W1 relu(W0 relu(h_j) + b0 [+ Wcb_j c + bcb_j]) + b1;
      // the context terms at this block's columns only
      if constexpr (CTX) {
        cl_gemm<CS>(cs, C4, a.pwci + (size_t)l * C4 * H, a.bci + (size_t)l * H, H, X, false,
                    true, false, false, buf);
      }
      cl_gemm<CS>(Y, D4, a.pwi + (size_t)l * D4 * H, a.bi + (size_t)l * H, H, X, false, false,
                  CTX, true, buf, nullptr, st);
      for (int j = 0; j < nb; ++j) {
        const size_t m = (size_t)l * nb2 + 2 * j;
        if constexpr (CTX) {
          const size_t mc = (size_t)l * nb + j;
          cl_gemm<CS>(cs, C4, a.pwcb + mc * C4 * H, a.bcb + mc * H, H, Y, false, false, false,
                      false, buf);
        }
        cl_gemm<CS>(X, H, a.pwb + m * H * H, a.bb + m * H, H, Y, true, true, CTX, true, buf,
                    nullptr, st + (size_t)(nb + 1 + j) * H * RS);
        cl_gemm<CS>(Y, H, a.pwb + (m + 1) * H * H, a.bb + (m + 1) * H, H, X, false, false, true,
                    true, buf, nullptr, st + (size_t)(j + 1) * H * RS);
      }
      cl_gemm<CS>(X, H, a.pwf + (size_t)l * H * Pp, a.pbf + (size_t)l * Pp, Pp, Y, false, false,
                  false, true, buf);

      // P = Y is [P][RS], param-major rows; the softmax 1/sqrt(H) goes on the
      // RQ width and height rows here, and each block keeps its rows of P
      float* pst = st + (size_t)(nb2 + 1) * H * RS;
      for (int e = tid; e < Pp * ROWS; e += NT) {
        const int r = e / ROWS, at = r * RS + e % ROWS;
        const float v = (a.rq && r < 2 * KD) ? Y[at] * a.wh_scale : Y[at];
        Y[at] = v;
        if (r >= p0 && r < p1) pst[at] = v;
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
    cluster_sync();  // every block's rows of the last layer's P are in the stash

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

      // final layer: gWf += gP h^T, gbf += gP 1 (this block's rows of P), g_h = Wf^T gP
      restore<ROWS>(X, st + (size_t)nb * H * RS, H, false);  // h after the last block
      __syncthreads();
      cl_wgrad(Y, p0, pt1, X, H, a.gwf + (size_t)l * P * H, H, buf);
      cl_bgrad(Y, p0, pt1, a.gbf + (size_t)l * P);
      cl_gemm<CS>(Y, P, a.wf + (size_t)l * P * H, nullptr, H, Z, false, false, false, true, buf);

      // residual blocks, last first; Z holds g_h
      for (int j = nb - 1; j >= 0; --j) {
        const size_t m = (size_t)l * nb2 + 2 * j;
        restore<ROWS>(X, st + (size_t)(nb + 1 + j) * H * RS, H, false);  // t = relu(W0 relu(h) + b0)
        __syncthreads();
        cl_wgrad(Z, h0, h1, X, H, a.gwb + (m + 1) * H * H, H, buf);
        cl_bgrad(Z, h0, h1, a.gbb + (m + 1) * H);
        // g_t = (W1^T g_h) where t > 0
        cl_gemm<CS>(Z, H, a.wb + (m + 1) * H * H, nullptr, H, Y, false, false, false, true, buf,
                    X);
        if constexpr (CTX) {
          // g_t is the cotangent of Wcb_j c + bcb_j too (this block's rows)
          const size_t mc = (size_t)l * nb + j;
          cl_wgrad(Y, h0, h1, cs, C, a.gwcb + mc * H * C, C, buf);
          cl_bgrad(Y, h0, h1, a.gbcb + mc * H);
          context_cotangent<ROWS>(a.wcb + mc * H * C + (size_t)h0 * C, Y + h0 * RS, h1 - h0, C,
                                  gcs);
        }
        restore<ROWS>(X, st + (size_t)j * H * RS, H, true);  // relu(h_j)
        __syncthreads();
        cl_wgrad(Y, h0, h1, X, H, a.gwb + m * H * H, H, buf);
        cl_bgrad(Y, h0, h1, a.gbb + m * H);
        // g_h += (W0^T g_t) where h_j > 0
        cl_gemm<CS>(Y, H, a.wb + m * H * H, nullptr, H, Z, false, false, true, true, buf, X);
      }

      if constexpr (CTX) {
        // the initial layer's context term: Y = g_h where Wci c + bci > 0, at
        // this block's rows
        cl_gemm<CS>(cs, C4, a.pwci + (size_t)l * C4 * H, a.bci + (size_t)l * H, H, X, false,
                    false, false, false, buf);
        for (int e = tid; e < (h1 - h0) * ROWS; e += NT) {
          const int at = (h0 + e / ROWS) * RS + e % ROWS;
          Y[at] = X[at] > 0.0f ? Z[at] : 0.0f;
        }
        __syncthreads();
        cl_wgrad(Y, h0, h1, cs, C, a.gwci + (size_t)l * H * C, C, buf);
        cl_bgrad(Y, h0, h1, a.gbci + (size_t)l * H);
        context_cotangent<ROWS>(a.wci + (size_t)l * H * C + (size_t)h0 * C, Y + h0 * RS,
                                h1 - h0, C, gcs);
      }

      // initial layer: gWi += g_h xp^T, gbi += g_h 1 (this block's rows), and
      // Wi^T g_h (every block, all of it)
      const float* wi = a.wi + (size_t)l * H * D;
      for (int e = tid; e < (h1 - h0) * D; e += NT) {
        const int o = h0 + e / D, i = e % D, src = inv ? i : perm[i];
        float sum = 0.0f;
        for (int s = 0; s < ROWS; ++s) sum += Z[o * RS + s] * xl[s * D + src];
        atomicAdd(a.gwi + (size_t)l * H * D + (size_t)o * D + i, sum);
      }
      cl_bgrad(Z, h0, h1, a.gbi + (size_t)l * H);
      for (int e = tid >> 5; e < D * ROWS; e += NT / 32) {  // a warp an element
        const int i = e / ROWS, s = e % ROWS;
        float sum = 0.0f;
        for (int o = tid & 31; o < H; o += 32) sum += wi[o * D + i] * Z[o * RS + s];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
        if ((tid & 31) == 0) ga0[e] = sum;
      }
      __syncthreads();

      // the layer's input fed both the transformer and the MADE; going
      // forward the scatter undoes the gather xp[i] = x[perm[i]]
      for (int e = tid; e < ROWS * D; e += NT) {
        const int s = e / D, i = e % D;
        gnext[s * D + (inv ? i : perm[i])] = ybuf[e] + ga0[i * ROWS + s];
      }
      cluster_sync();  // and every block has read g_h before the next layer stores into it
      float* tmp = gcur; gcur = gnext; gnext = tmp;
    }

    if (rank == 0)
      for (int e = tid; e < rows * D; e += NT) a.gx[base * D + e] = gcur[e];
    if constexpr (CTX) {
      if (rank != 0) {
        float* total = cooperative_groups::this_cluster().map_shared_rank(gcs, 0);
        for (int e = tid; e < C * ROWS; e += NT) {
          const int at = (e / ROWS) * RS + e % ROWS;
          atomicAdd(total + at, gcs[at]);
        }
      }
      cluster_sync();
      if (rank == 0) {
        for (int e = tid; e < C * ROWS; e += NT) {
          const int c = e / ROWS, s = e % ROWS;
          if (s < rows) a.gctx[(base + s) * C + c] = gcs[c * RS + s];
        }
      }
    }
    __syncthreads();
  }
  cluster_sync();  // no block leaves while another may still store into it
}

// the GEMM buffer and, as maf_train.cu's smem_bytes, the activation tiles,
// the context's tiles, the layer inputs and cotangents
size_t smem_bytes(int rows, const MafTrainArgs& a) {
  return sizeof(float) * ((size_t)NSTAGE * KCL * CW + (size_t)(rows / 4) * CW * rows +
                          (size_t)(3 * a.TB + 2 * a.C4) * (rows + 4) +
                          (size_t)rows * ((a.L + 5) * a.D + 1));
}

template <int CS, bool CTX>
cudaLaunchConfig_t cluster_config(int grid, size_t bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr, cudaError_t* err) {
  *err = cudaFuncSetAttribute(maf_train_bwd_cluster_kernel<CS, CTX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)grid);
  config.blockDim = dim3(nflows::cl::NT);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CS;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <int CS, bool CTX>
int launch(const MafTrainArgs& a, int grid, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaError_t err;
  const cudaLaunchConfig_t config =
      cluster_config<CS, CTX>(grid, smem_bytes(nflows::cl::ROWS, a), stream, &attr, &err);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&config, maf_train_bwd_cluster_kernel<CS, CTX>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int CS, bool CTX>
int active_clusters(size_t bytes, int* clusters) {
  cudaLaunchAttribute attr;
  cudaError_t err;
  const cudaLaunchConfig_t config = cluster_config<CS, CTX>(CS, bytes, 0, &attr, &err);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, maf_train_bwd_cluster_kernel<CS, CTX>,
                                             &config);
}

template <int CS>
int launch_cs(const MafTrainArgs& a, int grid, cudaStream_t s) {
  return a.C ? launch<CS, true>(a, grid, s) : launch<CS, false>(a, grid, s);
}

template <int CS>
int active_cs(int context, size_t bytes, int* clusters) {
  return context ? active_clusters<CS, true>(bytes, clusters)
                 : active_clusters<CS, false>(bytes, clusters);
}

}  // namespace

// B10 with each tile of 32 samples spread over a cluster of cluster_size
// blocks: the arguments of maf_train_launch (maf_train.cu), with grid a
// multiple of cluster_size (the clusters times their size) and the stash
// one slot a cluster: grid / cluster_size x L x ((nb2 + 1) H + Pp) x 36
// floats. cluster_size: 2, 4 or 8; rows_per_block: 32. Returns a
// cudaError_t value (0 on success).
extern "C" int maf_train_cluster_launch(MAF_TRAIN_LAUNCH_PARAMS) {
  if (n == 0) return 0;
  MafTrainArgs a;
  const int err = pack_maf_train_args(a, MAF_TRAIN_LAUNCH_NAMES);
  if (err) return err;
  if (rows_per_block != nflows::cl::ROWS || cluster_size < 1 || grid % cluster_size)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster_size == 8) return launch_cs<8>(a, grid, s);
  if (cluster_size == 4) return launch_cs<4>(a, grid, s);
  if (cluster_size == 2) return launch_cs<2>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}

// The most clusters of cluster_size blocks of B10, with or without a
// context, that the card holds at once with smem_bytes of dynamic shared
// memory a block (cudaOccupancyMaxActiveClusters) into *clusters. Returns a
// cudaError_t value.
extern "C" int maf_train_cluster_occupancy(int context, int cluster_size, int64_t smem_bytes,
                                           int* clusters) {
  *clusters = 0;
  if (cluster_size == 8) return active_cs<8>(context, (size_t)smem_bytes, clusters);
  if (cluster_size == 4) return active_cs<4>(context, (size_t)smem_bytes, clusters);
  if (cluster_size == 2) return active_cs<2>(context, (size_t)smem_bytes, clusters);
  return (int)cudaErrorInvalidValue;
}
