// B11 on Hopper's tensor cores: the log-density of a MixtureOfGaussiansMADE
// (or a conditional MADEMoG) in one launch, its GEMMs on wgmma, for either
// weight type (mademog_wgmma.cu: fp32 weights on 3xTF32;
// mademog_wgmma_bf16.cu: bf16 weights on bf16 wgmma).
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/mademog_fused.py:_kernel,
// as mademog_fused.cu does on fp32 FMAs, where the widths suit wgmma
// (ops/cuda/mademog_fused.py: gemm_route). Per sample: the masked residual
// MADE on mask-folded weights, h = Wi x + bi (plus relu(Wci c + bci) under
// a context), nb blocks of t = relu(W0 relu(h) + b0 (+ Wcb c + bcb)),
// h += W1 t + b1, then P = Wf h + bf, 3 K D parameters in the K-major
// layout (row (j K + k) D + d: logit, mean, unconstrained std of component
// k of feature d); then the mixture head (nflows::MogFeature, mademog.cuh:
// a max-subtracted log-softmax over the K logits, stds softplus(u) + eps,
// the component log-densities and their max-subtracted logsumexp) and the
// sum over the features, lp.
//
// Bound on the H100: operations. The masks leave M = 2 N (nnz(masks) +
// context weights) FLOP, 1.52 GFLOP at N = 4,096 for the MoG-MADE at
// features 10, hidden 256, 2 blocks, 10 components: bf16 0.0015 ms at 989
// TFLOP/s, 3xTF32 (three TF32 products a product) 0.0092 ms at 495
// TFLOP/s. The tensor cores multiply the structural zeros and the pads too
// (the final layer's 300 rows padded to 320). Every tile reads the packed
// image from L2: 0.70 MB in bf16, 1.39 MB in fp32.
//
// Design: B9's one-pass kernel (maf_flow_wgmma.cuh) cut to one MADE, with
// the head in place of the transformer, over the pieces of wgmma_chain.cuh.
// - Weights on wgmma's M, a 32-sample tile on N. A producer warp streams
//   the image (ops/cuda/mademog_fused.py: pack_weights_wgmma, the GEMMs in
//   run order) into the 4-slot ring, a lane a slot; two consumer
//   warpgroups own slabs w and w + 2 of every GEMM.
// - h stays fp32 in the consumers' registers. Each epilogue writes the
//   next operand: bf16-rounded in bf16 (where mademog.cuh's
//   mog_made_forward rounds it, and the TPU kernel's dots cast it: x, the
//   context, relu(h), t and h), tf32 hi and lo planes in fp32.
// - The context terms, as B9's: relu(Wci c + bci) is a GEMM of its own,
//   run first into the accumulators and kept in h's registers; each
//   block's Wcb c rides its first linear, two GEMMs of the stream into the
//   same accumulators. The context operand stays in shared memory.
// - fp32: each ring chunk's 3xTF32 products are summed apart and added to
//   the accumulators in fp32 (Consumer::gemm_folded): chained through a
//   GEMM in the tensor cores, whose accumulation truncates, they drift.
// - The final layer has more rows than a GEMM's four slabs (300 rows,
//   padded to 320, at the width above). It runs as passes of at most
//   kMaxSlabs slabs over the same operand h, rows 0-255 then the rest; the
//   image holds each pass as a GEMM of its own. The first pass's sums wait
//   in h's registers (h is spent once its operand is written), so that P
//   [32][TMp + 4] fp32 can overlay the operand planes once the last pass
//   has read them: in fp32 a buffer of its own beside the ring, both
//   operand planes and the context would not fit (244,800 bytes at the
//   width above, against the 232,448 a block may have).
// - The head runs a thread a (feature, sample) on P, the sum over the
//   features in order; x stays fp32 for it.
// - Depths (D, C) are padded to 16, 32 or a multiple of 64, so that an
//   fp32 GEMM's chunks are 2, 4 or 8 wgmma steps.
// - The ragged last tile computes on zero rows and skips their stores.
#pragma once

#include "wgmma_chain.cuh"
#include "mademog.cuh"

namespace {
namespace wg {

constexpr int kPassRows = 64 * kMaxSlabs;  // rows of the final layer a pass holds
constexpr int kMaxPasses = 2;              // the final layer's passes: TMp <= 512

template <typename WT>
struct MogWgArgs {
  const float* x;     // [n][D]
  const float* ctx;   // [n][C], null when C = 0
  float* lp;          // [n]
  int64_t n;
  int D, K, H, Ip, Cp, TMp, PS, nb, C;
  float eps;
  const char* image;  // the packed weights, pack_weights_wgmma
  const float* bi;    // [H]
  const float* bb;    // [2 nb][H]
  const float* bf;    // [TMp], zero past 3 K D
  const float* bci;   // [H]
  const float* bcb;   // [nb][H]
};

// Lanes 0..S-1 of the producer warp: every chunk of the launch in order,
// the GEMMs as the image holds them (the context's first, each block's
// context GEMM after its first linear, the final layer's passes last).
template <typename WT>
__device__ void mog_produce(const MogWgArgs<WT>& a, const Ring<WT>& ring, int lane) {
  int q = 0;
  const int nsH = a.H / 64, nsF = a.TMp / 64;
  const char* src = a.image;
  if (a.C) src = send_gemm(ring, q, lane, src, a.Cp, nsH);
  src = send_gemm(ring, q, lane, src, a.Ip, nsH);
  for (int j = 0; j < a.nb; ++j) {
    src = send_gemm(ring, q, lane, src, a.H, nsH);
    if (a.C) src = send_gemm(ring, q, lane, src, a.Cp, nsH);
    src = send_gemm(ring, q, lane, src, a.H, nsH);
  }
  for (int s0 = 0; s0 < nsF; s0 += kMaxSlabs)
    src = send_gemm(ring, q, lane, src, a.H, min(kMaxSlabs, nsF - s0));
}

// The operand planes' bytes, which P overlays: the larger of the planes
// and P [32][PS] fp32.
template <typename WT>
__host__ __device__ size_t mog_operand_bytes(int H, int Ip, int PS) {
  const int KX = H > Ip ? H : Ip;
  const size_t planes = (size_t)(kSplit<WT> ? 2 : 1) * ROWS * KX * sizeof(WT);
  const size_t pbytes = (size_t)ROWS * PS * 4;
  return planes > pbytes ? planes : pbytes;
}

template <typename WT>
size_t mog_wgmma_smem_bytes(const MogWgArgs<WT>& a) {
  size_t bytes = (size_t)kSlots * kSlotBytes;                               // ring
  bytes += mog_operand_bytes<WT>(a.H, a.Ip, a.PS);                         // operand, P
  bytes += (size_t)(kSplit<WT> ? 2 : 1) * ROWS * a.Cp * sizeof(WT);        // context
  bytes += (size_t)16 * kSlots;                                            // barriers
  bytes += sizeof(float) * (size_t)ROWS * 2 * a.D;  // x, per-feature log-densities
  return bytes;
}

template <bool CTX, typename WT>
__global__ void __launch_bounds__(NT, 1) mademog_wgmma_kernel(MogWgArgs<WT> a) {
  constexpr int S = kSlots;
  constexpr int es = sizeof(WT);
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, H = a.H, Ip = a.Ip, PS = a.PS;
  const int KX = H > Ip ? H : Ip;
  char* p = reinterpret_cast<char*>(smem);
  Ring<WT> ring;
  ring.slots = p;                                    p += (size_t)S * kSlotBytes;
  Operand<WT> op;
  op.hi = p;
  op.lo = p + (size_t)ROWS * KX * es;                // fp32 only
  float* P = reinterpret_cast<float*>(p);            // [ROWS][PS], over the planes
  p += mog_operand_bytes<WT>(H, Ip, PS);
  Operand<WT> cop;
  cop.hi = p;                                        p += (size_t)ROWS * a.Cp * es;
  cop.lo = p;                                        if (kSplit<WT>) p += (size_t)ROWS * a.Cp * es;
  ring.full = reinterpret_cast<uint64_t*>(p);        p += 8 * S;
  ring.empty = reinterpret_cast<uint64_t*>(p);       p += 8 * S;
  float* xs = reinterpret_cast<float*>(p);  // [ROWS][D] the inputs, fp32
  float* lpd = xs + ROWS * D;               // [D][ROWS] per-feature log-densities

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
  // uniform across each warp (nsf_flow_wgmma.cuh)
  if (__shfl_sync(0xffffffffu, tid >> 5, 0) >= NCT / 32) {
    if (tid - NCT < S) mog_produce(a, ring, tid - NCT);
    return;
  }

  const int64_t base = (int64_t)blockIdx.x * ROWS;
  const int rows = (int)min((int64_t)ROWS, a.n - base);
  // x for the head, and the initial layer's operand, its pad columns zero
  for_consumers(ROWS * Ip, tid, [&](int e) {
    const int s = e / Ip, i = e % Ip;
    float v = 0.0f;
    if (i < D) {
      v = s < rows ? a.x[(base + s) * D + i] : 0.0f;
      xs[s * D + i] = v;
    }
    op.put(s, i, v);
  });
  if constexpr (CTX) {
    for_consumers(ROWS * a.Cp, tid, [&](int e) {
      const int s = e / a.Cp, c = e % a.Cp;
      cop.put(s, c, s < rows && c < a.C ? a.ctx[(base + s) * a.C + c] : 0.0f);
    });
  }
  fence_proxy_async();
  consumers_sync();

  Consumer<WT> cw{ring, 0, __shfl_sync(0xffffffffu, tid >> 7, 0), tid & 127};
  const int w = cw.w, t = cw.t;
  const int nsH = H / 64, nsF = a.TMp / 64;
  float h[kOwned][16], acc[kOwned][16], part[kOwned][16];
  float bv[kOwned][2], bg[kOwned][2];
  const uint32_t t0 = frag_offset0<WT>(t);
  auto each = [&](int ns, auto&& f) { each_owned<WT>(w, t, t0, ns, f); };
  // acc += W B: fp32 weights sum each chunk's 3xTF32 products apart
  // (Consumer::gemm_folded)
  auto gemm = [&](int K, int ns, const Operand<WT>& B) {
    if constexpr (kSplit<WT>) cw.gemm_folded(K, ns, B, acc, part);
    else cw.gemm(K, ns, B, acc);
  };

  // h = Wi x + bi (+ relu(Wci c + bci), into h first)
  if constexpr (CTX) {
    load_bias(w, t, a.bci, nsH, bg);
    zero(acc);
    gemm(a.Cp, nsH, cop);
    each(nsH, [&](int j, int i, int, int, uint32_t) {
      h[j][i] = fmaxf(acc[j][i] + bg[j][(i & 3) >> 1], 0.0f);
    });
  }
  load_bias(w, t, a.bi, nsH, bv);
  zero(acc);
  gemm(Ip, nsH, op);
  consumers_sync();
  {
    const bool relu = a.nb > 0;
    each(nsH, [&](int j, int i, int, int, uint32_t at) {
      const float v = acc[j][i] + bv[j][(i & 3) >> 1];
      h[j][i] = CTX ? v + h[j][i] : v;
      op.put_at(at, relu ? fmaxf(h[j][i], 0.0f) : h[j][i]);
    });
  }
  fence_proxy_async();
  consumers_sync();

  for (int j = 0; j < a.nb; ++j) {
    // t = relu(W0 relu(h) + b0 (+ Wcb c + bcb))
    load_bias(w, t, a.bb + (size_t)2 * j * H, nsH, bv);
    if constexpr (CTX) load_bias(w, t, a.bcb + (size_t)j * H, nsH, bg);
    zero(acc);
    gemm(H, nsH, op);
    if constexpr (CTX) gemm(a.Cp, nsH, cop);
    consumers_sync();
    each(nsH, [&](int jj, int i, int, int, uint32_t at) {
      float v = acc[jj][i] + bv[jj][(i & 3) >> 1];
      if constexpr (CTX) v += bg[jj][(i & 3) >> 1];
      op.put_at(at, fmaxf(v, 0.0f));
    });
    fence_proxy_async();
    consumers_sync();
    // h += W1 t + b1
    load_bias(w, t, a.bb + (size_t)(2 * j + 1) * H, nsH, bv);
    zero(acc);
    gemm(H, nsH, op);
    consumers_sync();
    {
      const bool relu = j + 1 < a.nb;
      each(nsH, [&](int jj, int i, int, int, uint32_t at) {
        h[jj][i] += acc[jj][i] + bv[jj][(i & 3) >> 1];
        op.put_at(at, relu ? fmaxf(h[jj][i], 0.0f) : h[jj][i]);
      });
    }
    fence_proxy_async();
    consumers_sync();
  }

  // P = Wf h + bf in passes over the operand h: the first pass's rows wait
  // in h's registers while the second reads the operand; then every pass
  // writes P over the operand planes
  const int ns0 = min(nsF, kMaxSlabs), ns1 = nsF - ns0;
  load_bias(w, t, a.bf, ns0, bv);
  zero(acc);
  gemm(H, ns0, op);
  each(ns0, [&](int j, int i, int, int, uint32_t) { h[j][i] = acc[j][i] + bv[j][(i & 3) >> 1]; });
  if (ns1) {
    load_bias(w, t, a.bf + kPassRows, ns1, bg);
    zero(acc);
    gemm(H, ns1, op);
  }
  consumers_sync();
  each(ns0, [&](int j, int i, int o, int s, uint32_t) { P[s * PS + o] = h[j][i]; });
  each(ns1, [&](int j, int i, int o, int s, uint32_t) {
    P[s * PS + kPassRows + o] = acc[j][i] + bg[j][(i & 3) >> 1];
  });
  consumers_sync();

  // the head, a thread a (feature, sample); then the sum over the features
  for_consumers(D * ROWS, tid, [&](int e) {
    const int d = e / ROWS, s = e % ROWS;
    const nflows::MogFeature f(P + s * PS + d, a.K, D, a.eps, xs[s * D + d]);
    lpd[e] = f.log_prob();
  });
  consumers_sync();
  for_consumers(rows, tid, [&](int s) {
    float sum = 0.0f;
    for (int d = 0; d < D; ++d) sum += lpd[d * ROWS + s];
    a.lp[base + s] = sum;
  });
}

template <bool CTX, typename WT>
int mog_launch(const MogWgArgs<WT>& a, cudaStream_t stream) {
  const size_t bytes = mog_wgmma_smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(mademog_wgmma_kernel<CTX, WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (a.n + ROWS - 1) / ROWS;
  mademog_wgmma_kernel<CTX, WT><<<(unsigned)blocks, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// B11 on the tensor cores. image: pack_weights_wgmma's image of the
// matrices; the biases fp32, bi [H], bb [2 nb][H], bf [TMp] (zero past
// 3 K D), bci [H], bcb [nb][H]; ctx [n][C] with C > 0, or null and C = 0.
// Ip and Cp: D and C padded to 16, 32 or a multiple of 64; TMp: 3 K D
// padded to a multiple of 64, at most kMaxPasses passes of kPassRows.
// Returns a cudaError_t value (0 on success).
template <typename WT>
int mademog_wgmma_entry(const float* x, const float* ctx, float* lp, int64_t n, int D, int C,
                        int K, int H, int Ip, int Cp, int TMp, int nb, float eps,
                        const void* image, const float* bi, const float* bb, const float* bf,
                        const float* bci, const float* bcb, void* stream) {
  if (n == 0) return 0;
  if (D < 1 || K < 1 || H % 64 || H > 64 * kMaxSlabs || TMp % 64 ||
      TMp > kMaxPasses * kPassRows || 3 * K * D > TMp || Ip % 16 || Ip < D || Cp % 16 ||
      Cp < C || nb < 0 || C < 0 || (C == 0) != (Cp == 0) || (C && !(ctx && bci && bcb)))
    return (int)cudaErrorInvalidValue;
  MogWgArgs<WT> a;
  a.x = x; a.ctx = ctx; a.lp = lp; a.n = n;
  a.D = D; a.K = K; a.H = H; a.Ip = Ip; a.Cp = Cp; a.TMp = TMp; a.PS = TMp + 4;
  a.nb = nb; a.C = C; a.eps = eps;
  a.image = static_cast<const char*>(image);
  a.bi = bi; a.bb = bb; a.bf = bf; a.bci = bci; a.bcb = bcb;
  cudaStream_t s = (cudaStream_t)stream;
  return C ? mog_launch<true, WT>(a, s) : mog_launch<false, WT>(a, s);
}

}  // namespace wg
}  // namespace
