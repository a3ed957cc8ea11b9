// B12 with a tile spread over a thread-block cluster: the same function as
// mademog_train.cu (which see, for the TPU kernel it replaces, its bound,
// the head's adjoint and the stash), laid out so that a small batch fills
// the card. There a block holds a tile of 32 samples and walks the whole
// MADE alone, so a batch of 512 runs 16 blocks on the H100's 132 SMs, and
// the kernel's time is the latency of one tile's pass on one SM. Here the
// CS blocks of a cluster share each tile, as B10 does in
// maf_train_cluster.cu: block r owns columns [r H / CS, (r + 1) H / CS) of
// every H-wide GEMM and its share of the final layer's Pp columns, cut in
// groups of four (owned_cols: uneven where Pp / 4 does not divide by CS),
// computes them from full copies of the activation tiles X, Y and Z in its
// shared memory and stores them into every block's copy through
// distributed shared memory (cl_gemm, csrc/cluster_gemm.cuh); a cluster
// barrier separates those stores from the next reader.
// 1. The MADE passes. The forward recompute runs the initial layer, the two
//    linears of each residual block and the final layer; the backward
//    Wf^T gP, W1^T g_h where t > 0 and W0^T g_t where h > 0. Each is a
//    cl_gemm over the block's columns ending in one cluster barrier: on the
//    packed in-major weights going forward, on the mask-folded [out][in]
//    stacks coming back (the masked zeros are multiplied; the caller masks
//    the gradients). Weight gradients by rows: block r adds the rows o of
//    gwi, gbi, gwb and gbb in its H slice and those of gwf and gbf in its P
//    slice (cl_wgrad, cl_bgrad), so the number of atomics does not grow.
// 2. The head's adjoint needs all 3K rows of a feature, so every block runs
//    it on its full copy of P right after the forward: D x 32 (feature,
//    sample) pairs of K components, cheaper than the barrier an exchange of
//    gP would take. Every block then holds the whole gP for Wf^T gP, and
//    its gxd. One cluster barrier follows it: Wf^T gP is stored over P,
//    which slower blocks may still be reading.
// 3. Context (CTX). Wci c + bci and Wcb_j c + bcb_j are cl_gemms on the
//    block's own columns only (the next GEMM adds its product into those
//    columns and exchanges the sum), so they are never exchanged; so is
//    Wci c + bci recomputed for the initial layer's relu mask in the
//    backward. The context's cotangent (context_cotangent) is summed by
//    each block over its rows o, and each block adds its partial sums into
//    gctx in global memory with atomics (the wrapper zeroes gctx): B12 has
//    no barrier at a layer's end for distributed-shared-memory adds into
//    one block to ride on, as B10's gctx does; gwci, gbci, gwcb and gbcb go
//    by rows.
// 4. gx = Wi^T g_h0 + gxd from every block's full g_h0: block r computes and
//    stores its share of the tile's D x 32 entries.
// 5. The stash holds one slot a cluster, not a block: grid / CS x (2 + 2 nb)
//    x H x 36 floats in mademog_train.cu's layout; each block writes its
//    columns of h_j and t_j and restores them whole in the backward
//    (c_init is recomputed, h_nb is still in X).
// 6. Shared memory: mademog_train.cu's tiles with cl_gemm's buffer in place
//    of tile_gemm's (smem_bytes; ops/cuda/mademog_train.py:
//    shared_memory_bytes).
// Barriers: one cluster barrier after each exchanged GEMM, which also orders
// the next GEMM's stores after every read of its output's old contents (no
// block reads another block's columns of a GEMM's output in the same
// phase), one after the head's adjoint, and one before the kernel ends. The
// stash's reads of other blocks' columns come after several cluster
// barriers. The order of each dot product's sum differs from
// mademog_train.cu's (the depth is split over warps), so results agree with
// it to fp32 rounding. The ragged last tile computes on zero rows with zero
// cotangents and skips their stores. Tiles are 32 samples; CS is a template
// parameter, instantiated at 2, 4 and 8 (ops/cuda/mademog_train.py:
// launch_layout chooses). The launch is cudaLaunchKernelEx with a cluster
// dimension, a persistent grid of at most cudaOccupancyMaxActiveClusters
// clusters walking over the tiles.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_gemm.cuh"
#include "mademog_train.cuh"

namespace {

using nflows::cl_bgrad;
using nflows::cl_gemm;
using nflows::cl_wgrad;
using nflows::cluster_sync;
using nflows::cl::CW;
using nflows::cl::KCL;
using nflows::cl::NSTAGE;
using nflows::cl::NT;
using nflows::cl::ROWS;
using nflows::cl::RS;
using nflows::cl::WBUF;

template <int CS, bool CTX>
__global__ void __launch_bounds__(NT, 1) mademog_train_bwd_cluster_kernel(MogTrainArgs a) {
  extern __shared__ __align__(16) float smem[];
  const nflows::MogDims& d = a.d;
  const nflows::MogWeights& w = a.pw;
  const int D = d.D, H = d.H, P = d.P, Pp = d.Pp, nb = d.nb;
  const int C = CTX ? d.C : 0;
  float* buf = smem;             // [WBUF] weight ring and partial tiles
  float* X = buf + WBUF;         // [TB][RS]
  float* Y = X + a.TB * RS;      // [TB][RS]
  float* Z = Y + a.TB * RS;      // [TB][RS]
  float* xs = Z + a.TB * RS;     // [D][RS] inputs
  float* gxd = xs + D * RS;      // [D][RS] x's direct cotangent through the head
  float* cs = gxd + D * RS;      // [C][RS] context (CTX only)
  float* gcs = cs + C * RS;      // [C][RS] its cotangent, this block's rows o
  float* glp = gcs + C * RS;     // [ROWS]

  const int rank = nflows::cluster_rank();
  int h0, h1, p0, p1;
  nflows::owned_cols(H, rank, CS, h0, h1);   // this block's rows of the H-wide matrices
  nflows::owned_cols(Pp, rank, CS, p0, p1);  // and of P
  const int pt1 = max(p0, min(p1, P));       // its rows of the final layer's weights
  const int g0 = rank * D * ROWS / CS, g1 = (rank + 1) * D * ROWS / CS;  // its entries of gx
  const int tid = threadIdx.x;
  const size_t HR = (size_t)H * RS;
  const int64_t cluster = blockIdx.x / CS, nclusters = gridDim.x / CS;
  float* st = a.stash + (size_t)cluster * (2 + 2 * nb) * HR;
  const int64_t ntiles = (a.n + ROWS - 1) / ROWS;

  for (int64_t tile = cluster; tile < ntiles; tile += nclusters) {
    const int64_t base = tile * ROWS;
    const int rows = (int)min((int64_t)ROWS, a.n - base);

    for (int e = tid; e < D * ROWS; e += NT) {
      const int i = e / ROWS, s = e % ROWS;
      xs[i * RS + s] = s < rows ? a.x[(base + s) * D + i] : 0.0f;
    }
    if constexpr (CTX) {
      for (int e = tid; e < C * ROWS; e += NT) {
        const int i = e / ROWS, s = e % ROWS;
        cs[i * RS + s] = s < rows ? a.ctx[(base + s) * C + i] : 0.0f;
        gcs[i * RS + s] = 0.0f;
      }
    }
    for (int s = tid; s < ROWS; s += NT) glp[s] = s < rows ? a.glp[base + s] : 0.0f;
    __syncthreads();

    // ---- forward pass, keeping h_j and t_j: X = h_nb, Y = P --------------------
    // h_0 = Wi x + bi [+ relu(Wci c + bci)], then
    // h_{j+1} = h_j + W1 relu(W0 relu(h_j) + b0 [+ Wcb_j c + bcb_j]) + b1;
    // the context terms at this block's columns only
    if constexpr (CTX) {
      cl_gemm<CS>(cs, C, w.wci, w.bci, H, X, false, true, false, false, buf);
    }
    cl_gemm<CS>(xs, D, w.wi, w.bi, H, X, false, false, CTX, true, buf, nullptr, st + HR);
    for (int j = 0; j < nb; ++j) {
      const size_t m = 2 * (size_t)j;
      if constexpr (CTX) {
        cl_gemm<CS>(cs, C, w.wcb + (size_t)j * C * H, w.bcb + (size_t)j * H, H, Y, false, false,
                    false, false, buf);
      }
      cl_gemm<CS>(X, H, w.wb + m * H * H, w.bb + m * H, H, Y, true, true, CTX, true, buf,
                  nullptr, st + (2 + nb + j) * HR);
      cl_gemm<CS>(Y, H, w.wb + (m + 1) * H * H, w.bb + (m + 1) * H, H, X, false, false, true,
                  true, buf, nullptr, st + (2 + j) * HR);
    }
    cl_gemm<CS>(X, H, w.wf, w.bf, Pp, Y, false, false, false, true, buf);

    // ---- the head's adjoint, in every block: gP into Z, x's direct cotangent
    // into gxd
    head_adjoint<ROWS>(d, Y, xs, glp, Z, gxd);
    __syncthreads();

    // ---- final layer: gWf += gP h^T, gbf += gP 1 (this block's rows of P),
    // Y = g_h = Wf^T gP once every block is done with P
    cl_wgrad(Z, p0, pt1, X, H, a.gwf, H, buf);
    cl_bgrad(Z, p0, pt1, a.gbf);
    cluster_sync();
    cl_gemm<CS>(Z, P, a.wf, nullptr, H, Y, false, false, false, true, buf);

    // ---- residual blocks, last first; Y holds g_h -------------------------------
    for (int j = nb - 1; j >= 0; --j) {
      const size_t m = 2 * (size_t)j;
      // t_j = relu(W0 relu(h_j) + b0 [+ c_j])
      restore<ROWS>(X, st + (2 + nb + j) * HR, H, false);
      __syncthreads();
      cl_wgrad(Y, h0, h1, X, H, a.gwb + (m + 1) * H * H, H, buf);
      cl_bgrad(Y, h0, h1, a.gbb + (m + 1) * H);
      // Z = g_t = (W1^T g_h) where t_j > 0: the cotangent before the inner relu
      cl_gemm<CS>(Y, H, a.wb + (m + 1) * H * H, nullptr, H, Z, false, false, false, true, buf,
                  X);
      if constexpr (CTX) {
        // g_t is the cotangent of Wcb_j c + bcb_j too (this block's rows)
        cl_wgrad(Z, h0, h1, cs, C, a.gwcb + (size_t)j * H * C, C, buf);
        cl_bgrad(Z, h0, h1, a.gbcb + (size_t)j * H);
        context_cotangent<ROWS>(a.wcb + (size_t)j * H * C + (size_t)h0 * C, Z + h0 * RS,
                                h1 - h0, C, gcs);
      }
      restore<ROWS>(X, st + (1 + j) * HR, H, true);  // relu(h_j)
      __syncthreads();
      cl_wgrad(Z, h0, h1, X, H, a.gwb + m * H * H, H, buf);
      cl_bgrad(Z, h0, h1, a.gbb + m * H);
      // g_h += (W0^T g_t) where h_j > 0
      cl_gemm<CS>(Z, H, a.wb + m * H * H, nullptr, H, Y, false, false, true, true, buf, X);
    }

    // ---- initial layer, and the context projection added to it; Y = g_h0 --------
    if constexpr (CTX) {
      // Z = g_h0 where Wci c + bci > 0, at this block's rows
      cl_gemm<CS>(cs, C, w.wci, w.bci, H, X, false, false, false, false, buf);
      for (int e = tid; e < (h1 - h0) * ROWS; e += NT) {
        const int at = (h0 + e / ROWS) * RS + e % ROWS;
        Z[at] = X[at] > 0.0f ? Y[at] : 0.0f;
      }
      __syncthreads();
      cl_wgrad(Z, h0, h1, cs, C, a.gwci, C, buf);
      cl_bgrad(Z, h0, h1, a.gbci);
      context_cotangent<ROWS>(a.wci + (size_t)h0 * C, Z + h0 * RS, h1 - h0, C, gcs);
    }
    cl_wgrad(Y, h0, h1, xs, D, a.gwi, D, buf);
    cl_bgrad(Y, h0, h1, a.gbi);
    // gx = Wi^T g_h0 + the head's direct term, this block's share
    for (int e = g0 + tid; e < g1; e += NT) {
      const int i = e / ROWS, s = e % ROWS;
      float sum = gxd[i * RS + s];
      for (int o = 0; o < H; ++o) sum += a.wi[o * D + i] * Y[o * RS + s];
      if (s < rows) a.gx[(base + s) * D + i] = sum;
    }
    if constexpr (CTX) {
      for (int e = tid; e < C * ROWS; e += NT) {
        const int i = e / ROWS, s = e % ROWS;
        if (s < rows) atomicAdd(a.gctx + (base + s) * C + i, gcs[i * RS + s]);
      }
    }
    __syncthreads();
  }
  cluster_sync();  // no block leaves while another may still store into it
}

// the GEMM buffer and, as mademog_train.cu's smem_bytes, the activation
// tiles, the inputs, the context and their cotangents
size_t smem_bytes(const MogTrainArgs& a) {
  return sizeof(float) * ((size_t)NSTAGE * KCL * CW + (size_t)(ROWS / 4) * CW * ROWS +
                          (size_t)RS * (3 * a.TB + 2 * a.d.D + 2 * a.d.C) + ROWS);
}

template <int CS, bool CTX>
cudaLaunchConfig_t cluster_config(int grid, size_t bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr, cudaError_t* err) {
  *err = cudaFuncSetAttribute(mademog_train_bwd_cluster_kernel<CS, CTX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)grid);
  config.blockDim = dim3(NT);
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
int launch(const MogTrainArgs& a, int grid, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaError_t err;
  const cudaLaunchConfig_t config =
      cluster_config<CS, CTX>(grid, smem_bytes(a), stream, &attr, &err);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&config, mademog_train_bwd_cluster_kernel<CS, CTX>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int CS, bool CTX>
int active_clusters(size_t bytes, int* clusters) {
  cudaLaunchAttribute attr;
  cudaError_t err;
  const cudaLaunchConfig_t config = cluster_config<CS, CTX>(CS, bytes, 0, &attr, &err);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(clusters,
                                             mademog_train_bwd_cluster_kernel<CS, CTX>, &config);
}

template <int CS>
int launch_cs(const MogTrainArgs& a, int grid, cudaStream_t s) {
  return a.d.C ? launch<CS, true>(a, grid, s) : launch<CS, false>(a, grid, s);
}

template <int CS>
int active_cs(int context, size_t bytes, int* clusters) {
  return context ? active_clusters<CS, true>(bytes, clusters)
                 : active_clusters<CS, false>(bytes, clusters);
}

}  // namespace

// B12 with each tile of 32 samples spread over a cluster of cluster_size
// blocks: the arguments of mademog_train_launch (mademog_train.cu), with
// grid a multiple of cluster_size (the clusters times their size), the
// stash one slot a cluster, grid / cluster_size x (2 + 2 nb) x H x 36
// floats, and gctx zeroed by the caller (the blocks add into it).
// cluster_size: 2, 4 or 8. Returns a cudaError_t value (0 on success).
extern "C" int mademog_train_cluster_launch(MOG_TRAIN_LAUNCH_PARAMS) {
  if (n == 0) return 0;
  MogTrainArgs a;
  const int err = pack_mog_train_args(a, MOG_TRAIN_LAUNCH_NAMES);
  if (err) return err;
  if (cluster_size < 1 || grid % cluster_size) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster_size == 8) return launch_cs<8>(a, grid, s);
  if (cluster_size == 4) return launch_cs<4>(a, grid, s);
  if (cluster_size == 2) return launch_cs<2>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}

// The most clusters of cluster_size blocks of B12, with or without a
// context, that the card holds at once with smem_bytes of dynamic shared
// memory a block (cudaOccupancyMaxActiveClusters) into *clusters. Returns a
// cudaError_t value.
extern "C" int mademog_train_cluster_occupancy(int context, int cluster_size, int64_t smem_bytes,
                                               int* clusters) {
  *clusters = 0;
  if (cluster_size == 8) return active_cs<8>(context, (size_t)smem_bytes, clusters);
  if (cluster_size == 4) return active_cs<4>(context, (size_t)smem_bytes, clusters);
  if (cluster_size == 2) return active_cs<2>(context, (size_t)smem_bytes, clusters);
  return (int)cudaErrorInvalidValue;
}
