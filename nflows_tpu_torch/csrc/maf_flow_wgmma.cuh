// B9's one-pass direction on Hopper's tensor cores: a whole L-layer
// autoregressive flow (MAF, NSF-AR, IAF) in one launch where every layer
// runs one MADE pass in the requested direction, its GEMMs on wgmma, for
// either weight type (maf_flow_wgmma.cu: fp32 weights on 3xTF32;
// maf_flow_wgmma_bf16.cu: bf16 weights on bf16 wgmma).
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/maf_flow_kernel.py:_kernel
// for those chains, as maf_flow_kernel.cuh does on fp32 FMAs: unwrapped
// layers going forward (a MAF's or NSF-AR's log_prob), wrapped layers
// coming back (an IAF's sample). For each layer: the permutation (a static
// row gather, before the AR op going forward, after it coming back); the
// residual MADE on mask-folded weights, h = Wi x + bi (plus relu(Wci c +
// bci) under a context), nb blocks of t = relu(W0 relu(h) + b0 (+ Wcb c +
// bcb)), h += W1 t + b1, then P = Wf h + bf (its width and height rows
// times wh_scale for the rq transformer); the transformer forward (affine:
// softplus scale + 1e-3 and shift; rq: the linear-tail spline of
// rq_spline.cuh with boundary derivatives of exactly 1); the running
// logabsdet sum. The fixed-point directions stay on maf_degree_inverse.cuh
// and maf_flow_kernel.cuh.
//
// Bound on the H100: operations. The masks leave M = 2 N (nnz(masks) +
// context weights) FLOP, 6.1 GFLOP at N = 4,096 for the MAF at features 10,
// hidden 256, 5 layers, 2 blocks: bf16 0.0062 ms at 989 TFLOP/s, 3xTF32
// (three TF32 products a product) 0.037 ms at 495 TFLOP/s. The tensor cores
// multiply the structural zeros too: the padded dense count is 11.6 GFLOP,
// 0.070 ms on 3xTF32, still under the masked count's 0.091 ms on the CUDA
// cores. Every tile reads the packed image from L2: 2.9 MB in bf16, 5.8 MB
// in fp32.
//
// Design: B2's (nsf_flow_wgmma.cuh), with the pieces of wgmma_chain.cuh.
// - Weights on wgmma's M, a 32-sample tile on N: m64n32k16 in bf16,
//   m64n32k8 in tf32. A producer warp streams the image
//   (ops/cuda/maf_flow_kernel.py: pack_weights_wgmma, the layers in run
//   order) into the 4-slot ring, a lane a slot; two consumer warpgroups own
//   slabs w and w + 2.
// - h stays fp32 in the consumers' registers. Each epilogue writes the
//   next operand: bf16-rounded in bf16 (where the SIMT bf16 kernel rounds
//   it: the MADE's input, relu(h), t, h and the context), tf32 hi and lo
//   planes in fp32. The final layer's epilogue writes P [32][TMp + 4] fp32
//   over the operand buffer: parameter j of feature t at column j D + t.
// - The context terms. The initial layer's passes a relu before it is
//   added, so it is a GEMM of its own, run first into the accumulators
//   and kept in h's registers as relu(Wci c + bci); the initial layer then
//   adds onto it. The block's rides the first linear: W0 relu(h) and
//   Wcb c accumulate into the same accumulators, two GEMMs of the stream
//   in a row, so one accumulator array serves every GEMM. The context
//   operand [32][Cp] stays in shared memory for the launch.
// - fp32: each chunk's 3xTF32 products are summed apart and added to the
//   accumulators in fp32 (Consumer::gemm_folded): chained through a whole
//   GEMM in the tensor cores, whose accumulation truncates, they drifted
//   8 times further from float64 than the fp32 plain version on a MAF as
//   initialised.
// - ptxas serializes the fp32 kernels' wgmmas (C7511, A from registers,
//   as B2's) and, once a kernel, the bf16 context kernels' (C7515, as
//   B2's); PERF.md has each instantiation's notes.
// - Depths (D, C) are padded to 16, 32 or a multiple of 64, so that an
//   fp32 GEMM's chunks are 2, 4 or 8 wgmma steps; the final layer's rows
//   to a multiple of 64, at most 256 (the NSF-AR's 230 to 256).
// - The transformer runs a thread a (sample, feature) on P; its operand,
//   the permuted state, stays fp32.
// - The ragged last tile computes on zero rows and skips their stores.
#pragma once

#include "wgmma_chain.cuh"
#include "rq_spline.cuh"

namespace {
namespace wg {

constexpr float kMafAffineEpsilon = 1e-3f;  // MaskedAffineAutoregressiveTransform._EPSILON

template <typename WT>
struct MafArgs {
  const float* x;
  const float* ctx;      // [n][C], null when C = 0
  float* y;
  float* lad;
  int64_t n;
  int D, L, H, Ip, Cp, TMp, PS, nb, C;
  int scaled_rows;       // rows of P that wh_scale multiplies: 2 K D (rq), else 0
  const char* image;     // the packed weights, pack_weights_wgmma
  int64_t layer_bytes;   // one layer's part of it
  const float* bi;       // [L][H]
  const float* bb;       // [L][2 nb][H]
  const float* bf;       // [L][TMp], zero past P
  const float* bci;      // [L][H]
  const float* bcb;      // [L][nb][H]
  const int* idx;        // [L][2 D + 1]: perm_rows, inv_perm_rows, wrapped
  int inverse;
  float wh_scale;
  nflows::RQConfig cfg;
};

// Lanes 0..S-1 of the producer warp: every chunk of the launch in order,
// each layer's GEMMs as the image holds them (context first in the
// initial layer, the block's context GEMM after its first linear).
template <typename WT>
__device__ void maf_produce(const MafArgs<WT>& a, const Ring<WT>& ring, int lane) {
  int q = 0;
  const int nsH = a.H / 64;
  for (int step = 0; step < a.L; ++step) {
    const int l = a.inverse ? a.L - 1 - step : step;
    const char* src = a.image + (size_t)l * a.layer_bytes;
    if (a.C) src = send_gemm(ring, q, lane, src, a.Cp, nsH);
    src = send_gemm(ring, q, lane, src, a.Ip, nsH);
    for (int j = 0; j < a.nb; ++j) {
      src = send_gemm(ring, q, lane, src, a.H, nsH);
      if (a.C) src = send_gemm(ring, q, lane, src, a.Cp, nsH);
      src = send_gemm(ring, q, lane, src, a.H, nsH);
    }
    send_gemm(ring, q, lane, src, a.H, a.TMp / 64);
  }
}

template <typename WT>
size_t maf_wgmma_smem_bytes(const MafArgs<WT>& a) {
  constexpr int es = sizeof(WT);
  const int KX = a.H > a.Ip ? a.H : a.Ip;
  size_t op = (size_t)ROWS * KX * es;
  const size_t pbytes = (size_t)ROWS * a.PS * 4;
  if (pbytes > op) op = pbytes;
  const int planes = kSplit<WT> ? 2 : 1;
  size_t bytes = (size_t)kSlots * kSlotBytes;                    // ring
  bytes += op + (kSplit<WT> ? (size_t)ROWS * KX * es : 0);      // operand hi (and P), lo
  bytes += (size_t)planes * ROWS * a.Cp * es;                   // context operand
  bytes += (size_t)16 * kSlots;                                 // barriers
  bytes += sizeof(float) * (size_t)ROWS * (3 * a.D + 1);        // state, AR input, lads, sum
  return bytes;
}

template <bool RQ, bool CTX, typename WT>
__global__ void __launch_bounds__(NT, 1) maf_flow_wgmma_kernel(MafArgs<WT> a) {
  constexpr int S = kSlots;
  constexpr int es = sizeof(WT);
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, H = a.H, Ip = a.Ip, PS = a.PS;
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
  float* zb = xs + ROWS * D;                // [ROWS][D] the AR op's input
  float* lbuf = zb + ROWS * D;              // [ROWS][D] elementwise logabsdets
  float* ladacc = lbuf + ROWS * D;          // [ROWS]
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
  // uniform across each warp (nsf_flow_wgmma.cuh)
  if (__shfl_sync(0xffffffffu, tid >> 5, 0) >= NCT / 32) {
    if (tid - NCT < S) maf_produce(a, ring, tid - NCT);
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

  for (int step = 0; step < a.L; ++step) {
    const int l = a.inverse ? a.L - 1 - step : step;
    const int* perm = a.idx + l * (2 * D + 1);

    // the AR op's input: the state permuted going forward, as it is coming
    // back; the initial layer's operand, its pad columns zero
    for_consumers(ROWS * Ip, tid, [&](int e) {
      const int s = e / Ip, i = e % Ip;
      float v = 0.0f;
      if (i < D) {
        v = xs[s * D + (a.inverse ? i : perm[i])];
        zb[s * D + i] = v;
      }
      op.put(s, i, v);
    });
    fence_proxy_async();
    consumers_sync();

    // h = Wi x + bi (+ relu(Wci c + bci), into h first)
    if constexpr (CTX) {
      load_bias(w, t, a.bci + (size_t)l * H, nsH, bg);
      zero(acc);
      gemm(a.Cp, nsH, cop);
      each(nsH, [&](int j, int i, int, int, uint32_t) {
        h[j][i] = fmaxf(acc[j][i] + bg[j][(i & 3) >> 1], 0.0f);
      });
    }
    load_bias(w, t, a.bi + (size_t)l * H, nsH, bv);
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
      const size_t m = (size_t)l * 2 * a.nb + 2 * j;
      // t = relu(W0 relu(h) + b0 (+ Wcb c + bcb))
      load_bias(w, t, a.bb + m * H, nsH, bv);
      if constexpr (CTX) load_bias(w, t, a.bcb + ((size_t)l * a.nb + j) * H, nsH, bg);
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
      load_bias(w, t, a.bb + (m + 1) * H, nsH, bv);
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

    // P = Wf h + bf, its first scaled_rows rows times wh_scale, over the operand
    load_bias(w, t, a.bf + (size_t)l * a.TMp, nsF, bv);
    zero(acc);
    gemm(H, nsF, op);
    consumers_sync();
    each(nsF, [&](int j, int i, int o, int s, uint32_t) {
      const float v = acc[j][i] + bv[j][(i & 3) >> 1];
      P[s * PS + o] = o < a.scaled_rows ? v * a.wh_scale : v;
    });
    consumers_sync();

    // the transformer forward on the AR op's input; the result into the
    // state, through the inverse permutation coming back
    for_consumers(D * ROWS, tid, [&](int e) {
      const int tt = e / ROWS, s = e % ROWS;
      const float z = zb[s * D + tt];
      const float* ps = P + s * PS + tt;
      float o, ld;
      if constexpr (RQ) {
        const int KD = a.cfg.num_bins * D;
        nflows::rq_spline_eval(z, ps, ps + KD, ps + 2 * KD, D, false, a.cfg, &o, &ld);
      } else {
        const float scale = nflows::softplus(ps[0]) + kMafAffineEpsilon;
        o = scale * z + ps[D];
        ld = logf(scale);
      }
      xs[s * D + (a.inverse ? perm[tt] : tt)] = o;
      lbuf[s * D + tt] = ld;
    });
    consumers_sync();
    for_consumers(ROWS, tid, [&](int s) {
      float sum = 0.0f;
      for (int tt = 0; tt < D; ++tt) sum += lbuf[s * D + tt];
      ladacc[s] += sum;
    });
  }
  consumers_sync();

  for_consumers(rows * D, tid, [&](int e) { a.y[base * D + e] = xs[e]; });
  for_consumers(rows, tid, [&](int s) { a.lad[base + s] = ladacc[s]; });
}

template <bool RQ, bool CTX, typename WT>
int maf_launch(const MafArgs<WT>& a, cudaStream_t stream) {
  const size_t bytes = maf_wgmma_smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(maf_flow_wgmma_kernel<RQ, CTX, WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (a.n + ROWS - 1) / ROWS;
  maf_flow_wgmma_kernel<RQ, CTX, WT><<<(unsigned)blocks, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// B9's one-pass chain on the tensor cores. image: pack_weights_wgmma's
// image of the matrices (layer_bytes a layer, the layers in their own
// order); the biases fp32, bi [L][H], bb [L][2 nb][H], bf [L][TMp] (zero
// past P), bci [L][H], bcb [L][nb][H]; idx [L][2 D + 1]; ctx [n][C] with
// C > 0, or null and C = 0. Ip and Cp: D and C padded to 16, 32 or a
// multiple of 64; TMp: P padded to a multiple of 64. inverse: 0 runs
// unwrapped layers forward, 1 wrapped layers coming back (the wrapper
// refuses any other chain). transformer: 0 affine (P = 2 D), 1 rq
// (P = (3 K - 1) D). Returns a cudaError_t value (0 on success).
template <typename WT>
int maf_wgmma_entry(const float* x, const float* ctx, float* y, float* lad, int64_t n, int D,
                    int L, int H, int Ip, int P, int TMp, int nb, int C, int Cp,
                    const void* image, int64_t layer_bytes, const float* bi, const float* bb,
                    const float* bf, const float* bci, const float* bcb, const int* idx,
                    int inverse, int transformer, float wh_scale, int num_bins,
                    float tail_bound, float min_bin_width, float min_bin_height,
                    float min_derivative, void* stream) {
  if (n == 0) return 0;
  if (H % 64 || H > 64 * kMaxSlabs || TMp % 64 || TMp > 64 * kMaxSlabs || P > TMp ||
      Ip % 16 || Ip < D || Cp % 16 || Cp < C || nb < 0 || C < 0 || (C == 0) != (Cp == 0) ||
      (C && !(ctx && bci && bcb)) || (transformer != 0 && transformer != 1))
    return (int)cudaErrorInvalidValue;
  if (P != (transformer ? (3 * num_bins - 1) * D : 2 * D)) return (int)cudaErrorInvalidValue;
  MafArgs<WT> a;
  a.x = x; a.ctx = ctx; a.y = y; a.lad = lad; a.n = n;
  a.D = D; a.L = L; a.H = H; a.Ip = Ip; a.Cp = Cp; a.TMp = TMp; a.PS = TMp + 4;
  a.nb = nb; a.C = C;
  a.scaled_rows = transformer ? 2 * num_bins * D : 0;
  a.image = static_cast<const char*>(image);
  a.layer_bytes = layer_bytes;
  a.bi = bi; a.bb = bb; a.bf = bf; a.bci = bci; a.bcb = bcb; a.idx = idx;
  a.inverse = inverse;
  a.wh_scale = wh_scale;
  a.cfg = nflows::RQConfig{num_bins, tail_bound, min_bin_width, min_bin_height, min_derivative,
                           1.0f};
  cudaStream_t s = (cudaStream_t)stream;
  if (transformer) return C ? maf_launch<true, true, WT>(a, s) : maf_launch<true, false, WT>(a, s);
  return C ? maf_launch<false, true, WT>(a, s) : maf_launch<false, false, WT>(a, s);
}

}  // namespace wg
}  // namespace
