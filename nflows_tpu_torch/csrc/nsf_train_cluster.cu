// B3 and B4 with a tile spread over a thread-block cluster: the same
// functions as nsf_train.cu (which see, for the TPU kernels they replace,
// their bound, the adjoints and the stash), laid out so that a small batch
// fills the card. There a block holds a tile of 32 samples and walks the whole chain
// alone, so a batch of 512 runs 16 blocks on the H100's 132 SMs, and the
// kernel's time is the latency of one tile's pass on one SM. Here the CS
// blocks of a cluster share each tile (csrc/cluster_gemm.cuh):
// - Block r owns columns [r H / CS, (r + 1) H / CS) of every H-wide GEMM
//   (the initial layer, both linears of each residual block, and in the
//   backward the input cotangents W^T g) and its share of the final layer's
//   TMp columns, cut in groups of four. It stages only its columns of each
//   weight matrix, so the L2 traffic for weights stays what it is with one
//   block a tile, computes them with the depth split over its 8 warps, and
//   stores them into every block's copy of the activation tiles X, Y and Z
//   through distributed shared memory; a cluster barrier separates those
//   stores from the next reader. Each block so keeps full copies of X, Y
//   and Z, and its GEMM inputs are local reads.
// - The gate g = Wcb ctx + bcb of a conditional block is read only at the
//   owner's columns (the GATE epilogue, and the gate's adjoint, which each
//   block computes for its own rows), so it is never exchanged; the
//   adjoint's du is, before the W1^T du GEMM.
// - Weight gradients by rows: block r adds the rows o of gw0, gb0, gwb, gbb
//   (and gwc0, gwcb, gbcb) in its H slice and those of gwf, gbf in its P
//   slice, so the number of atomics does not grow.
// - The small steps run in every block on its full copies: the coupling
//   stage and its adjoint (T x 32 elements), the merge of the identity half
//   and its cotangent ga0 = W0^T g_h, the logabsdet sum and the loss's
//   cotangents; so gcur and gnext agree in every block with no exchange.
//   Only rank 0 stores lp, gx and gctx. B4's context cotangent is summed by
//   each block over its rows o and the partials are added into rank 0's
//   with distributed-shared-memory atomics at the tile's end.
// - Each block writes its columns of the kept matrices into its cluster's
//   stash and restores whole matrices from it in the backward.
// - Barriers: one cluster barrier after each exchanged GEMM, which also
//   orders the next GEMM's stores after every read of its output's old
//   contents (no block reads another block's columns of a GEMM's output in
//   the same phase), plus one at the end of each layer's backward (ga0 reads
//   all of g_h before the next layer's final-layer cotangent is stored over
//   it), one between the forward and the backward (the last layer's P is
//   restored whole from the rows each block stashed) and, with a context,
//   one after the du exchange and one before g_t = W1^T du is stored over
//   the t that the weight gradient reads.
// The order of each dot product's sum differs from nsf_train.cu's (the
// depth is split over warps), so results agree with it to fp32 rounding.
// Tiles are 32 samples; CS is a template parameter, instantiated at 2, 4
// and 8 (ops/cuda/nsf_train.py: cluster_size chooses). The launch is
// cudaLaunchKernelEx with a cluster dimension, a persistent grid of at most
// cudaOccupancyMaxActiveClusters clusters walking over the tiles.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_gemm.cuh"
#include "nsf_train.cuh"

namespace {

using nflows::cl_bgrad;
using nflows::cl_gemm;
using nflows::cl_wgrad;
using nflows::cluster_sync;
using nflows::cl::CW;
using nflows::cl::KCL;
using nflows::cl::NSTAGE;
using nflows::cl::WBUF;

template <bool LOSS, bool CTX, int CS>
__device__ void train_cluster(const TrainArgs& a) {
  constexpr int ROWS = nflows::cl::ROWS, NT = nflows::cl::NT, RS = nflows::cl::RS;
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, L = a.L, H = a.H, Tid = a.Tid, I4 = a.I4, T = a.T;
  const int TM = a.TM, TMp = a.TMp, nb2 = a.nb2, nb = a.nb2 / 2;
  const int C = CTX ? a.C : 0;
  float* buf = smem;                        // [WBUF] weight ring and partial tiles
  float* X = buf + WBUF;                    // [TB][RS]
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

  const int rank = nflows::cluster_rank();
  int h0, h1, p0, p1;
  nflows::owned_cols(H, rank, CS, h0, h1);    // this block's rows of the H-wide matrices
  nflows::owned_cols(TMp, rank, CS, p0, p1);  // and of P
  const int pt1 = max(p0, min(p1, TM));       // its rows of the final layer's weights
  const int tid = threadIdx.x;
  const int idx_stride = 2 * Tid + 2 * T + 2 * D;
  const size_t SR = (size_t)a.SRB * H + TMp;  // scratch rows a layer
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
      // u_j = W1 relu(W0 relu(h_j) + b0) + b1; Z holds the gate at this block's columns
      if constexpr (CTX) {
        cl_gemm<CS>(Y, I4, a.pw0 + (size_t)l * I4 * H, a.b0 + (size_t)l * H, H, X, false,
                    false, false, false, buf);
        cl_gemm<CS>(cs, C, a.pwc0 + (size_t)l * C * H, nullptr, H, X, false, false, true, true,
                    buf, nullptr, st);
      } else {
        cl_gemm<CS>(Y, I4, a.pw0 + (size_t)l * I4 * H, a.b0 + (size_t)l * H, H, X, false,
                    false, false, true, buf, nullptr, st);
      }
      for (int j = 0; j < nb; ++j) {
        const size_t m = (size_t)l * nb2 + 2 * j;
        cl_gemm<CS>(X, H, a.pwb + m * H * H, a.bb + m * H, H, Y, true, true, false, true, buf,
                    nullptr, st + (size_t)(nb + 1 + j) * H * RS);
        if constexpr (CTX) {
          const size_t g = (size_t)l * nb + j;
          cl_gemm<CS>(cs, C, a.pwcb + g * C * H, a.bcb + g * H, H, Z, false, false, false,
                      false, buf);
          cl_gemm<CS, true>(Y, H, a.pwb + (m + 1) * H * H, a.bb + (m + 1) * H, H, X, false,
                            false, true, true, buf, nullptr, st + (size_t)(j + 1) * H * RS, Z,
                            st + (size_t)(nb2 + 1 + j) * H * RS);
        } else {
          cl_gemm<CS>(Y, H, a.pwb + (m + 1) * H * H, a.bb + (m + 1) * H, H, X, false, false,
                      true, true, buf, nullptr, st + (size_t)(j + 1) * H * RS);
        }
      }
      cl_gemm<CS>(X, H, a.pwf + (size_t)l * H * TMp, a.pbf + (size_t)l * TMp, TMp, Y, false,
                  false, false, true, buf);

      // P = Y is [TM][RS], K-major rows; the softmax 1/sqrt(H) goes on the
      // width and height rows here, and each block keeps its rows of P
      float* pst = st + (size_t)a.SRB * H * RS;
      for (int e = tid; e < TMp * ROWS; e += NT) {
        const int r = e / ROWS, at = r * RS + e % ROWS;
        const float v = r < a.scaled_rows ? Y[at] * a.wh_scale : Y[at];
        Y[at] = v;
        if (r >= p0 && r < p1) pst[at] = v;
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
        if (rank == 0 && s < rows) a.lp[base + s] = -0.5f * sq - a.log_z + ladacc[s];
        gladv[s] = s < rows ? -a.inv_n : 0.0f;
      }
      for (int e = tid; e < ROWS * D; e += NT) gcur[e] = e / D < rows ? y[e] * a.inv_n : 0.0f;
    } else {
      for (int s = tid; s < ROWS; s += NT) gladv[s] = s < rows ? a.glad[base + s] : 0.0f;
      for (int e = tid; e < ROWS * D; e += NT)
        gcur[e] = e / D < rows ? a.gy[base * D + e] : 0.0f;
    }
    cluster_sync();  // every block's rows of the last layer's P are in the stash

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

      // final layer: gWf += gP h^T, gbf += gP 1 (this block's rows of P), g_h = Wf^T gP
      restore<ROWS>(X, st + (size_t)nb * H * RS, H, false);  // h after the last block
      __syncthreads();
      cl_wgrad(Y, p0, pt1, X, H, a.gwf + (size_t)l * TM * H, H, buf);
      cl_bgrad(Y, p0, pt1, a.gbf + (size_t)l * TM);
      cl_gemm<CS>(Y, TM, a.wf + (size_t)l * TM * H, nullptr, H, Z, false, false, false, true,
                  buf);

      // residual blocks, last first; Z holds g_h
      for (int j = nb - 1; j >= 0; --j) {
        const size_t m = (size_t)l * nb2 + 2 * j;
        if constexpr (CTX) {
          // the gate at this block's rows: g = Wcb ctx + bcb into Y, u into X;
          // then dg into Y, du into X, and du into every block
          const size_t g = (size_t)l * nb + j;
          restore<ROWS>(X + h0 * RS, st + (size_t)(nb2 + 1 + j) * H * RS + h0 * RS, h1 - h0,
                        false);  // u
          cl_gemm<CS>(cs, C, a.pwcb + g * C * H, a.bcb + g * H, H, Y, false, false, false,
                      false, buf);
          for (int e = tid; e < (h1 - h0) * ROWS; e += NT) {
            const int at = (h0 + e / ROWS) * RS + e % ROWS;
            const float sg = nflows::gate_sigmoid(Y[at]), dh = Z[at];
            Y[at] = dh * X[at] * sg * (1.0f - sg);
            X[at] = dh * sg;
          }
          __syncthreads();
          cl_wgrad(Y, h0, h1, cs, C, a.gwcb + g * H * C, C, buf);
          cl_bgrad(Y, h0, h1, a.gbcb + g * H);
          if (!LOSS)
            add_context_cotangent<ROWS>(Y + h0 * RS, a.wcb + g * H * C + h0 * C, h1 - h0, C,
                                        gcs);
          for (int e = tid; e < (h1 - h0) * (RS / 4); e += NT) {
            float* at = X + h0 * RS + 4 * e;
            nflows::push<CS>(at, *reinterpret_cast<const float4*>(at));
          }
          cluster_sync();
          restore<ROWS>(Y, st + (size_t)(nb + 1 + j) * H * RS, H, false);  // t
          __syncthreads();
          cl_wgrad(X, h0, h1, Y, H, a.gwb + (m + 1) * H * H, H, buf);
          cl_bgrad(X, h0, h1, a.gbb + (m + 1) * H);
          cluster_sync();  // every block has read t before g_t is stored over it
          // g_t = (W1^T du) where t > 0, written over t
          cl_gemm<CS>(X, H, a.wb + (m + 1) * H * H, nullptr, H, Y, false, false, false, true,
                      buf, Y);
        } else {
          // t = relu(W0 relu(h) + b0)
          restore<ROWS>(X, st + (size_t)(nb + 1 + j) * H * RS, H, false);
          __syncthreads();
          cl_wgrad(Z, h0, h1, X, H, a.gwb + (m + 1) * H * H, H, buf);
          cl_bgrad(Z, h0, h1, a.gbb + (m + 1) * H);
          // g_t = (W1^T g_h) where t > 0
          cl_gemm<CS>(Z, H, a.wb + (m + 1) * H * H, nullptr, H, Y, false, false, false, true,
                      buf, X);
        }
        restore<ROWS>(X, st + (size_t)j * H * RS, H, true);  // relu(h_j)
        __syncthreads();
        cl_wgrad(Y, h0, h1, X, H, a.gwb + m * H * H, H, buf);
        cl_bgrad(Y, h0, h1, a.gbb + m * H);
        // g_h += (W0^T g_t) where h_j > 0
        cl_gemm<CS>(Y, H, a.wb + m * H * H, nullptr, H, Z, false, false, true, true, buf, X);
      }

      // initial layer: gW0 += g_h identity^T, gb0 += g_h 1 (this block's rows),
      // g_identity = W0^T g_h (every block, all rows)
      const float* w0 = a.w0 + (size_t)l * H * Tid;
      for (int e = tid; e < (h1 - h0) * Tid; e += NT) {
        const int o = h0 + e / Tid, src = id_src[e % Tid];
        float sum = 0.0f;
        for (int s = 0; s < ROWS; ++s) sum += Z[o * RS + s] * xl[s * D + src];
        atomicAdd(a.gw0 + (size_t)l * H * Tid + (size_t)o * Tid + e % Tid, sum);
      }
      cl_bgrad(Z, h0, h1, a.gb0 + (size_t)l * H);
      for (int e = tid >> 5; e < Tid * ROWS; e += NT / 32) {  // a warp an element
        const int i = e / ROWS, s = e % ROWS;
        float sum = 0.0f;
        for (int o = tid & 31; o < H; o += 32) sum += w0[o * Tid + i] * Z[o * RS + s];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
        if ((tid & 31) == 0) ga0[e] = sum;
      }
      if constexpr (CTX) {  // gWc0 += g_h ctx^T, gctx += Wc0^T g_h (this block's rows)
        cl_wgrad(Z, h0, h1, cs, C, a.gwc0 + (size_t)l * H * C, C, buf);
        if (!LOSS)
          add_context_cotangent<ROWS>(Z + h0 * RS, a.wc0 + (size_t)l * H * C + h0 * C, h1 - h0,
                                      C, gcs);
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
      cluster_sync();  // and every block has read g_h before the next layer stores into it
      float* tmp = gcur; gcur = gnext; gnext = tmp;
    }

    if (!LOSS) {
      if (rank == 0)
        for (int e = tid; e < rows * D; e += NT) a.gx[base * D + e] = gcur[e];
      if constexpr (CTX) {
        if (rank != 0) {
          float* total = cooperative_groups::this_cluster().map_shared_rank(gcs, 0);
          for (int e = tid; e < C * ROWS; e += NT) atomicAdd(total + e, gcs[e]);
        }
        cluster_sync();
        if (rank == 0)
          for (int e = tid; e < rows * C; e += NT)
            a.gctx[base * C + e] = gcs[(e % C) * ROWS + e / C];
      }
    }
    __syncthreads();
  }
  cluster_sync();  // no block leaves while another may still store into it
}

template <bool CTX, int CS>
__global__ void __launch_bounds__(nflows::cl::NT, 1) nsf_loss_grad_cluster_kernel(TrainArgs a) {
  train_cluster<true, CTX, CS>(a);
}

template <bool CTX, int CS>
__global__ void __launch_bounds__(nflows::cl::NT, 1) nsf_train_bwd_cluster_kernel(TrainArgs a) {
  train_cluster<false, CTX, CS>(a);
}

// the GEMM buffer and, as nsf_train.cu's smem_bytes, the activation tiles,
// the layer inputs, cotangents and the context's tiles
size_t smem_bytes(int rows, const TrainArgs& a) {
  return sizeof(float) * ((size_t)NSTAGE * KCL * CW + (size_t)(rows / 4) * CW * rows +
                          (size_t)3 * a.TB * (rows + 4) +
                          (size_t)rows * ((a.L + 4) * a.D + 2 * a.T + a.Tid + 2) +
                          (size_t)a.C * (2 * rows + 4));
}

template <bool LOSS, bool CTX, int CS>
cudaLaunchConfig_t cluster_config(int grid, size_t bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr, cudaError_t* err) {
  auto kernel =
      LOSS ? nsf_loss_grad_cluster_kernel<CTX, CS> : nsf_train_bwd_cluster_kernel<CTX, CS>;
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

template <bool LOSS, bool CTX, int CS>
int launch(const TrainArgs& a, int grid, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaError_t err;
  const cudaLaunchConfig_t config =
      cluster_config<LOSS, CTX, CS>(grid, smem_bytes(nflows::cl::ROWS, a), stream, &attr, &err);
  if (err != cudaSuccess) return (int)err;
  auto kernel =
      LOSS ? nsf_loss_grad_cluster_kernel<CTX, CS> : nsf_train_bwd_cluster_kernel<CTX, CS>;
  err = cudaLaunchKernelEx(&config, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool LOSS, bool CTX, int CS>
int active_clusters(size_t bytes, int* clusters) {
  cudaLaunchAttribute attr;
  cudaError_t err;
  const cudaLaunchConfig_t config = cluster_config<LOSS, CTX, CS>(CS, bytes, 0, &attr, &err);
  if (err != cudaSuccess) return (int)err;
  auto kernel =
      LOSS ? nsf_loss_grad_cluster_kernel<CTX, CS> : nsf_train_bwd_cluster_kernel<CTX, CS>;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
}

template <int CS>
int launch_cs(const TrainArgs& a, int loss, int grid, cudaStream_t s) {
  if (a.C) return loss ? launch<true, true, CS>(a, grid, s) : launch<false, true, CS>(a, grid, s);
  return loss ? launch<true, false, CS>(a, grid, s) : launch<false, false, CS>(a, grid, s);
}

template <int CS>
int active_cs(int loss, int context, size_t bytes, int* clusters) {
  if (context)
    return loss ? active_clusters<true, true, CS>(bytes, clusters)
                : active_clusters<false, true, CS>(bytes, clusters);
  return loss ? active_clusters<true, false, CS>(bytes, clusters)
              : active_clusters<false, false, CS>(bytes, clusters);
}

}  // namespace

// B3 (loss != 0) or B4 (loss == 0) with each tile of 32 samples spread over a
// cluster of cluster_size blocks: the arguments of nsf_train_launch
// (nsf_train.cu), with grid a multiple of cluster_size (the clusters times
// their size) and the stash one slot a cluster: grid / cluster_size x L x
// (SRB H + TMp) x 36 floats. cluster_size: 2, 4 or 8; rows_per_block: 32.
// Returns a cudaError_t value (0 on success).
extern "C" int nsf_train_cluster_launch(NSF_TRAIN_LAUNCH_PARAMS) {
  if (n == 0) return 0;
  TrainArgs a;
  const int err = pack_train_args(a, NSF_TRAIN_LAUNCH_NAMES);
  if (err) return err;
  if (rows_per_block != nflows::cl::ROWS || cluster_size < 1 || grid % cluster_size)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster_size == 8) return launch_cs<8>(a, loss, grid, s);
  if (cluster_size == 4) return launch_cs<4>(a, loss, grid, s);
  if (cluster_size == 2) return launch_cs<2>(a, loss, grid, s);
  return (int)cudaErrorInvalidValue;
}

// The most clusters of cluster_size blocks of B3 (loss != 0) or B4, with or
// without a context, that the card holds at once with smem_bytes of dynamic
// shared memory a block (cudaOccupancyMaxActiveClusters) into *clusters.
// Returns a cudaError_t value.
extern "C" int nsf_train_cluster_occupancy(int loss, int context, int cluster_size,
                                           int64_t smem_bytes, int* clusters) {
  *clusters = 0;
  if (cluster_size == 8) return active_cs<8>(loss, context, (size_t)smem_bytes, clusters);
  if (cluster_size == 4) return active_cs<4>(loss, context, (size_t)smem_bytes, clusters);
  if (cluster_size == 2) return active_cs<2>(loss, context, (size_t)smem_bytes, clusters);
  return (int)cudaErrorInvalidValue;
}
