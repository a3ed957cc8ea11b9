// B2 on Hopper's tensor cores: the whole L-layer coupling chain in one
// launch, its GEMMs on wgmma, for either weight type
// (nsf_flow_wgmma.cu: fp32 weights on 3xTF32; nsf_flow_wgmma_bf16.cu: bf16
// weights on bf16 wgmma).
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/nsf_flow_kernel.py:_kernel
// (its products through _dot, its conditioner at :101-110), as
// nsf_flow_kernel.cuh does: the same chain (permutation and split, the
// ResidualNet conditioner with the context GLU under a context, the
// family's coupling stage of coupling_stage.cuh, merge and the logabsdet
// sum), with every GEMM on the tensor cores instead of fp32 FMAs.
//
// Bound on the H100. bf16: 2.30e10 FLOP at N = 4,096 on the flagship at
// 989 TFLOP/s, 0.023 ms; every tile reads the 5.98 MB packed image from
// L2 (0.77 GB over 128 tiles). fp32 on 3xTF32: three TF32 products a
// product, 6.9e10 FLOP at 495 TFLOP/s (0.139 ms), and 11.96 MB a tile.
//
// Design.
// - Weights on wgmma's M, samples on its N: a GEMM is D[64 outputs][32
//   samples] = W[64][K] act[K][32] for each 64-row slab of the outputs
//   (m64n32k16 in bf16, m64n32k8 in tf32). A 32-sample tile a block: 128
//   blocks at N = 4,096 on the 132 SMs.
// - Both operands K-major, in core matrices of 8 rows x 16 bytes without
//   swizzle (tf32 takes no other). A (the weights) comes as the host
//   packed it (ops/cuda/nsf_flow_kernel.py: pack_weights_wgmma): each
//   layer's GEMMs in the order the kernel runs them, each cut into chunks
//   of whole wgmma steps over all its slabs, each chunk the exact
//   shared-memory image its descriptors read. B (the activations) is a
//   sample-major operand buffer [32][K] in the same core-matrix layout,
//   written by each GEMM's epilogue from the accumulator fragments.
// - A producer warp streams the chunks in order with TMA bulk copies into
//   a ring of 4 mbarriered 32 KB slots (maf_degree_inverse.cuh's ring), a
//   lane a slot, as far ahead of the consumers as the ring allows, across
//   epilogues and the coupling stage; two consumer warpgroups issue wgmma
//   on each chunk that has arrived (warpgroup w on the slabs w, w + 2 of
//   every GEMM: H and the padded parameter rows TMp are at most 256) and
//   release its slot when their products are done, one chunk behind.
// - The residual stream h stays fp32 in the consumers' registers, in the
//   accumulators' layout; so do a block's context gate. Each epilogue
//   applies bias, relu, the gate and the residual add as tile_gemm.cuh
//   does, then writes the next GEMM's operand: relu(h), t, h for the final
//   layer. The final layer's epilogue writes P [32][TMp + 4] fp32 over the
//   operand buffer; the coupling stage reads parameter j of feature t at
//   column j T + t. One operand buffer serves the chain: a barrier of the
//   consumers separates a GEMM's reads from its epilogue's writes.
// - bf16: the weights are bf16 in the image; each operand is rounded to
//   bf16 (nearest even) where the epilogue writes it, after the relu, as
//   the TPU kernel's _dot casts it; the products are exact and summed in
//   fp32, so only the order of the sums differs from the JAX kernel's.
// - fp32: 3xTF32, never one TF32 product. Each operand x is split into
//   hi = tf32(x) (cvt.rna, in two integer operations) and lo = tf32(x -
//   hi), and a GEMM accumulates A_lo B_hi + A_hi B_lo + A_hi B_hi in fp32.
//   The activations are split where the epilogue writes them (hi and lo
//   planes of the operand); the weights on chip, after their chunk
//   arrives: each thread loads its fragments of wgmma's A from the slot
//   into registers and splits them there (wgmma with A from registers),
//   so the L2 stream stays at the fp32 bytes and shared memory is read
//   once for them. ptxas serializes these wgmmas (its C7511, whatever the
//   chunk's size); splitting the weights in place in shared memory, with
//   a lo shadow a slot, kept the pipeline and was slower all the same on
//   the H100 (PERF.md).
// - ptxas also serializes every wgmma of a kernel with a loop whose trip
//   count differs between threads (C7520): the consumers' loops over
//   elements all run the same count (for_consumers). With a context the
//   bf16 kernels' wgmmas are serialized too (C7515), as registers move
//   between the branches of the slab dispatch (Consumer::gemm).
// - The initial layer's depth (Tid), the context's (C) and the final
//   layer's rows (TM) are padded with zeros in the image: depth to 16,
//   rows to a multiple of 64.
// - The ragged last tile computes on zero rows and skips their stores.
// - The ring, the operand buffers, the consumers' walk and the epilogue's
//   helpers are in wgmma_chain.cuh, which B9's one-pass kernel
//   (maf_flow_wgmma.cuh) shares.
#pragma once

#include "wgmma_chain.cuh"
#include "coupling_stage.cuh"

namespace {
namespace wg {

template <typename WT>
struct Args {
  const float* x;
  float* y;
  float* lad;
  int64_t n;
  int D, L, H, Tid, T, Ip, Cp, TMp, PS, nb, C;
  int scaled_rows;       // rows of P that wh_scale multiplies: min(2 K T, TM)
  const char* image;     // the packed weights, pack_weights_wgmma
  int64_t layer_bytes;   // one layer's part of it
  const float* b0;       // [L][H]
  const float* bb;       // [L][2 nb][H]
  const float* bf;       // [L][TMp], zero past TM
  const float* bcb;      // [L][nb][H]
  const int* idx;        // [L][2 Tid + 2 T + 2 D]
  const float* ctx;      // [n][C], null when C = 0
  int inverse;
  float wh_scale;
  nflows::StageConfig cfg;
};

// the context GLU gate, 1 / (1 + exp(-v)) as the JAX kernel writes it
__device__ __forceinline__ float gate_sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// Lanes 0..S-1 of the producer warp: every chunk of the launch in order,
// lane q % S sending chunk q. They walk the layers as the consumers do,
// each layer's GEMMs as the image holds them.
template <typename WT>
__device__ void produce(const Args<WT>& a, const Ring<WT>& ring, int lane) {
  int q = 0;
  const int nsH = a.H / 64;
  for (int step = 0; step < a.L; ++step) {
    const int l = a.inverse ? a.L - 1 - step : step;
    const char* src = a.image + (size_t)l * a.layer_bytes;
    auto gemm = [&](int K, int ns) { src = send_gemm(ring, q, lane, src, K, ns); };
    gemm(a.Ip, nsH);
    if (a.C) gemm(a.Cp, nsH);
    for (int j = 0; j < a.nb; ++j) {
      gemm(a.H, nsH);
      if (a.C) gemm(a.Cp, nsH);
      gemm(a.H, nsH);
    }
    gemm(a.H, a.TMp / 64);
  }
}

template <typename WT>
size_t wgmma_smem_bytes(const Args<WT>& a) {
  constexpr int es = sizeof(WT);
  const int KX = a.H > a.Ip ? a.H : a.Ip;
  size_t op = (size_t)ROWS * KX * es;
  const size_t pbytes = (size_t)ROWS * a.PS * 4;
  if (pbytes > op) op = pbytes;
  const int planes = kSplit<WT> ? 2 : 1;
  size_t bytes = (size_t)kSlots * kSlotBytes;              // ring
  bytes += op + (kSplit<WT> ? (size_t)ROWS * KX * es : 0);     // operand hi (and P), lo
  bytes += (size_t)planes * ROWS * a.Cp * es;                 // context operand
  bytes += (size_t)16 * kSlots;                           // barriers
  bytes += sizeof(float) * (size_t)ROWS * (2 * a.D + 2 * a.T + 1);
  return bytes;
}

template <int FAMILY, bool CTX, typename WT>
__global__ void __launch_bounds__(NT, 1) nsf_flow_wgmma_kernel(Args<WT> a) {
  constexpr int S = kSlots;
  constexpr int es = sizeof(WT);
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, H = a.H, Tid = a.Tid, T = a.T, Ip = a.Ip, PS = a.PS;
  const int KX = H > Ip ? H : Ip;
  size_t opb = (size_t)ROWS * KX * es;
  if ((size_t)ROWS * PS * 4 > opb) opb = (size_t)ROWS * PS * 4;
  char* p = reinterpret_cast<char*>(smem);
  Ring<WT> ring;
  ring.slots = p;                                    p += (size_t)S * kSlotBytes;
  Operand<WT> op;
  op.hi = p;                                         p += opb;
  op.lo = p;                                         if (kSplit<WT>) p += (size_t)ROWS * KX * es;
  Operand<WT> cop;
  cop.hi = p;                                        p += (size_t)ROWS * a.Cp * es;
  cop.lo = p;                                        if (kSplit<WT>) p += (size_t)ROWS * a.Cp * es;
  ring.full = reinterpret_cast<uint64_t*>(p);        p += 8 * S;
  ring.empty = reinterpret_cast<uint64_t*>(p);       p += 8 * S;
  float* xs = reinterpret_cast<float*>(p);  // [ROWS][D] state
  float* xn = xs + ROWS * D;                // [ROWS][D] next state
  float* ybuf = xn + ROWS * D;              // [ROWS][T] stage outputs
  float* lbuf = ybuf + ROWS * T;            // [ROWS][T] stage logabsdets
  float* ladacc = lbuf + ROWS * T;          // [ROWS]
  float* P = reinterpret_cast<float*>(op.hi);  // [ROWS][PS], over the operand

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, NCT / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the roles by warp, through a shuffle so that the compiler sees them
  // uniform across each warp: wgmma on a path it takes for divergent is
  // serialized
  if (__shfl_sync(0xffffffffu, tid >> 5, 0) >= NCT / 32) {
    if (tid - NCT < S) produce(a, ring, tid - NCT);
    return;
  }

  const int64_t base = (int64_t)blockIdx.x * ROWS;
  const int rows = (int)min((int64_t)ROWS, a.n - base);
  for_consumers(ROWS * D, tid, [&](int e) {
    const int s = e / D;
    xs[e] = s < rows ? a.x[(base + s) * D + (e % D)] : 0.0f;
  });
  for_consumers(ROWS, tid, [&](int s) { ladacc[s] = 0.0f; });
  if constexpr (CTX) {
    for_consumers(ROWS * a.Cp, tid, [&](int e) {
      const int s = e / a.Cp, c = e % a.Cp;
      cop.put(s, c, s < rows && c < a.C ? a.ctx[(base + s) * a.C + c] : 0.0f);
    });
  }
  consumers_sync();

  // the warpgroup, through a shuffle so that the compiler sees it uniform
  // across the warp: a branch on it around wgmma would serialize the products
  Consumer<WT> cw{ring, 0, __shfl_sync(0xffffffffu, tid >> 7, 0), tid & 127};
  const int w = cw.w, t = cw.t;
  const int nsH = H / 64, nsF = a.TMp / 64;
  float h[kOwned][16], acc[kOwned][16], gate[kOwned][16];
  // the epilogue's walk of this thread's fragment values: f(j, i, output, sample)
  // f(j, i, output, sample, operand offset)
  const uint32_t t0 = frag_offset0<WT>(t);
  auto each = [&](int ns, auto&& f) { each_owned<WT>(w, t, t0, ns, f); };
  // the biases of this thread's two output rows in each owned slab
  auto bias = [&](const float* b, int ns, float (&bv)[kOwned][2]) { load_bias(w, t, b, ns, bv); };
  float bv[kOwned][2], bg[kOwned][2];

  const int idx_stride = 2 * Tid + 2 * T + 2 * D;
  for (int step = 0; step < a.L; ++step) {
    const int l = a.inverse ? a.L - 1 - step : step;
    const int* li = a.idx + l * idx_stride;
    // forward: id_rows, tr_rows, merge_fwd; inverse: id_idx, tr_idx, merge_inv
    const int* id_src = a.inverse ? li + Tid + T + D : li;
    const int* tr_src = a.inverse ? li + 2 * Tid + T + D : li + Tid;
    const int* merge = a.inverse ? li + 2 * Tid + 2 * T + D : li + Tid + T;

    // the identity features, the initial layer's operand
    for_consumers(ROWS * Ip, tid, [&](int e) {
      const int s = e / Ip, i = e % Ip;
      op.put(s, i, i < Tid ? xs[s * D + id_src[i]] : 0.0f);
    });
    fence_proxy_async();
    consumers_sync();

    // h = W0 x (+ Wc0 ctx) + b0
    bias(a.b0 + (size_t)l * H, nsH, bv);
    zero(acc);
    cw.gemm(Ip, nsH, op, acc);
    if constexpr (CTX) cw.gemm(a.Cp, nsH, cop, acc);
    consumers_sync();
    {
      const bool relu = a.nb > 0;
      each(nsH, [&](int j, int i, int, int, uint32_t at) {
        h[j][i] = acc[j][i] + bv[j][(i & 3) >> 1];
        op.put_at(at, relu ? fmaxf(h[j][i], 0.0f) : h[j][i]);
      });
    }
    fence_proxy_async();
    consumers_sync();

    for (int j = 0; j < a.nb; ++j) {
      const size_t m = (size_t)l * 2 * a.nb + 2 * j;
      // t = relu(W0 relu(h) + b0)
      bias(a.bb + m * H, nsH, bv);
      zero(acc);
      cw.gemm(H, nsH, op, acc);
      consumers_sync();
      each(nsH, [&](int jj, int i, int, int, uint32_t at) {
        op.put_at(at, fmaxf(acc[jj][i] + bv[jj][(i & 3) >> 1], 0.0f));
      });
      fence_proxy_async();
      consumers_sync();
      bias(a.bb + (m + 1) * H, nsH, bv);
      if constexpr (CTX) {
        // the block's gate: Wcb ctx + bcb
        bias(a.bcb + ((size_t)l * a.nb + j) * H, nsH, bg);
        zero(gate);
        cw.gemm(a.Cp, nsH, cop, gate);
      }
      // h += (W1 t + b1) [* sigmoid(gate)]
      zero(acc);
      cw.gemm(H, nsH, op, acc);
      consumers_sync();
      {
        const bool relu = j + 1 < a.nb;
        each(nsH, [&](int jj, int i, int, int, uint32_t at) {
          float v = acc[jj][i] + bv[jj][(i & 3) >> 1];
          if constexpr (CTX) v *= gate_sigmoid(gate[jj][i] + bg[jj][(i & 3) >> 1]);
          h[jj][i] += v;
          op.put_at(at, relu ? fmaxf(h[jj][i], 0.0f) : h[jj][i]);
        });
      }
      fence_proxy_async();
      consumers_sync();
    }

    // P = (Wf h + bf), its first scaled_rows rows times wh_scale, over the operand
    bias(a.bf + (size_t)l * a.TMp, nsF, bv);
    zero(acc);
    cw.gemm(H, nsF, op, acc);
    consumers_sync();
    each(nsF, [&](int j, int i, int o, int s, uint32_t) {
      const float v = acc[j][i] + bv[j][(i & 3) >> 1];
      P[s * PS + o] = o < a.scaled_rows ? v * a.wh_scale : v;
    });
    consumers_sync();

    for_consumers(T * ROWS, tid, [&](int e) {
      const int tt = e / ROWS, s = e % ROWS;
      nflows::coupling_stage<FAMILY>(xs[s * D + tr_src[tt]], P + s * PS + tt, T,
                                     a.inverse != 0, a.cfg, ybuf + s * T + tt,
                                     lbuf + s * T + tt);
    });
    consumers_sync();

    // x_next[r] = concat(identity, stage outputs)[merge[r]]
    for_consumers(ROWS * D, tid, [&](int e) {
      const int s = e / D, mg = merge[e % D];
      xn[e] = mg < Tid ? xs[s * D + id_src[mg]] : ybuf[s * T + (mg - Tid)];
    });
    for_consumers(ROWS, tid, [&](int s) {
      float sum = 0.0f;
      for (int tt = 0; tt < T; ++tt) sum += lbuf[s * T + tt];
      ladacc[s] += sum;
    });
    consumers_sync();
    float* tmp = xs; xs = xn; xn = tmp;
  }

  for_consumers(rows * D, tid, [&](int e) { a.y[base * D + e] = xs[e]; });
  for_consumers(rows, tid, [&](int s) { a.lad[base + s] = ladacc[s]; });
}

template <int FAMILY, bool CTX, typename WT>
int launch(const Args<WT>& a, cudaStream_t stream) {
  const size_t bytes = wgmma_smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(nsf_flow_wgmma_kernel<FAMILY, CTX, WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (a.n + ROWS - 1) / ROWS;
  nsf_flow_wgmma_kernel<FAMILY, CTX, WT><<<(unsigned)blocks, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// one instantiation a family (coupling_stage.cuh), with and without the
// context path
template <bool CTX, typename WT>
int launch_family(const Args<WT>& a, cudaStream_t stream) {
  switch (a.cfg.family) {
    case nflows::kRQ: return launch<nflows::kRQ, CTX, WT>(a, stream);
    case nflows::kLRS: return launch<nflows::kLRS, CTX, WT>(a, stream);
    case nflows::kLinear: return launch<nflows::kLinear, CTX, WT>(a, stream);
    case nflows::kQuadratic: return launch<nflows::kQuadratic, CTX, WT>(a, stream);
    case nflows::kCubic: return launch<nflows::kCubic, CTX, WT>(a, stream);
    default: return launch<nflows::kAffine, CTX, WT>(a, stream);  // kAffine, kAdditive
  }
}

// The chain on the tensor cores. image: pack_weights_wgmma's image of the
// matrices (layer_bytes a layer); the biases fp32, b0 [L][H], bb [L][2 nb][H],
// bf [L][TMp] (zero past TM), bcb [L][nb][H]; ctx [n][C] with C > 0, or null
// and C = 0. Ip and Cp: Tid and C padded to 16; TMp: TM padded to a
// multiple of 64. Returns a cudaError_t value (0 on success).
template <typename WT>
int nsf_wgmma_entry(const float* x, float* y, float* lad, int64_t n, int D, int L, int H,
                    int Tid, int Ip, int T, int TM, int TMp, int nb, const void* image,
                    int64_t layer_bytes, const float* b0, const float* bb, const float* bf,
                    const float* bcb, const int* idx, int inverse, int family, int scale_act,
                    int num_bins, float wh_scale, float tail_bound, float min_bin_width,
                    float min_bin_height, float min_derivative, float min_lambda,
                    float edge_derivative, float log_inv_bins, const float* ctx, int C,
                    int Cp, void* stream) {
  if (n == 0) return 0;
  if (H % 64 || H > 64 * kMaxSlabs || TMp % 64 || TMp > 64 * kMaxSlabs || TM > TMp ||
      Ip % 16 || Ip < Tid || Cp % 16 || Cp < C || nb < 0 || family < nflows::kRQ ||
      family > nflows::kAdditive || C < 0 || (C && !(ctx && bcb)) || (C == 0) != (Cp == 0))
    return (int)cudaErrorInvalidValue;
  Args<WT> a;
  a.x = x; a.y = y; a.lad = lad; a.n = n;
  a.D = D; a.L = L; a.H = H; a.Tid = Tid; a.T = T; a.Ip = Ip; a.Cp = Cp; a.TMp = TMp;
  a.PS = TMp + 4;
  a.nb = nb; a.C = C;
  a.scaled_rows = 2 * num_bins * T < TM ? 2 * num_bins * T : TM;
  a.image = static_cast<const char*>(image);
  a.layer_bytes = layer_bytes;
  a.b0 = b0; a.bb = bb; a.bf = bf; a.bcb = bcb; a.idx = idx; a.ctx = ctx;
  a.inverse = inverse;
  a.wh_scale = wh_scale;
  a.cfg = nflows::make_stage_config(family, scale_act, num_bins, tail_bound, min_bin_width,
                                    min_bin_height, min_derivative, min_lambda,
                                    edge_derivative, log_inv_bins);
  cudaStream_t s = (cudaStream_t)stream;
  return C ? launch_family<true, WT>(a, s) : launch_family<false, WT>(a, s);
}

// ---- one GEMM through the same ring and warpgroups ---------------------------
// out[o][s] = sum_k W[o][k] act[s][k] for a [n][K] fp32 act and one matrix
// packed as a layer of its own (pack_weights_wgmma's layout, O = 64 ns):
// the descriptors, the split, the ring and the fragment layout of the chain,
// held alone against the plain product on the card.
template <typename WT>
__global__ void __launch_bounds__(NT, 1) wgmma_gemm_kernel(const WT* image, const float* act,
                                                           float* out, int64_t n, int K, int O) {
  constexpr int S = kSlots;
  constexpr int es = sizeof(WT);
  extern __shared__ __align__(128) unsigned char smem[];
  char* p = reinterpret_cast<char*>(smem);
  Ring<WT> ring;
  ring.slots = p;                                    p += (size_t)S * kSlotBytes;
  Operand<WT> op;
  op.hi = p;                                         p += (size_t)ROWS * K * es;
  op.lo = p;                                         if (kSplit<WT>) p += (size_t)ROWS * K * es;
  ring.full = reinterpret_cast<uint64_t*>(p);        p += 8 * S;
  ring.empty = reinterpret_cast<uint64_t*>(p);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, NCT / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int ns = O / 64;
  if (__shfl_sync(0xffffffffu, tid >> 5, 0) >= NCT / 32) {
    if (tid - NCT < S) {
      const int nk = K * es / 32, kc = chunk_steps(nk, ns);
      const char* src = reinterpret_cast<const char*>(image);
      int q = 0;
      for (int k0 = 0; k0 < nk; k0 += kc, ++q) {
        const unsigned bytes = (unsigned)(ns * min(kc, nk - k0) * kStepBytes);
        send(ring, q, tid - NCT, src, bytes);
        src += bytes;
      }
    }
    return;
  }
  const int64_t base = (int64_t)blockIdx.x * ROWS;
  const int rows = (int)min((int64_t)ROWS, n - base);
  for_consumers(ROWS * K, tid, [&](int e) {
    const int s = e / K, k = e % K;
    op.put(s, k, s < rows ? act[(base + s) * K + k] : 0.0f);
  });
  fence_proxy_async();
  consumers_sync();
  Consumer<WT> cw{ring, 0, __shfl_sync(0xffffffffu, tid >> 7, 0), tid & 127};
  float acc[kOwned][16];
  zero(acc);
  cw.gemm(K, ns, op, acc);
#pragma unroll
  for (int j = 0; j < kOwned; ++j) {
    const int s = cw.w + NCW * j;
    if (s < ns) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int o = s * 64 + frag_row(cw.t, i), c = frag_col(cw.t, i);
        if (c < rows) out[(size_t)o * n + base + c] = acc[j][i];
      }
    }
  }
}

template <typename WT>
int wgmma_gemm_entry(const WT* image, const float* act, float* out, int64_t n, int K, int O,
                     void* stream) {
  if (n == 0) return 0;
  if (O % 64 || O > 64 * kMaxSlabs || K % 16 || K < 16) return (int)cudaErrorInvalidValue;
  const int planes = kSplit<WT> ? 2 : 1;
  const size_t bytes = (size_t)kSlots * kSlotBytes +
                       (size_t)planes * ROWS * K * sizeof(WT) + 16 * kSlots;
  cudaError_t err = cudaFuncSetAttribute(wgmma_gemm_kernel<WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n + ROWS - 1) / ROWS;
  wgmma_gemm_kernel<WT><<<(unsigned)blocks, NT, bytes, (cudaStream_t)stream>>>(image, act, out,
                                                                               n, K, O);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace
