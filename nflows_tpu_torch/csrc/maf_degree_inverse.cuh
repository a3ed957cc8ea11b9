// B9's fixed-point direction, solved in the order of the MADE's degrees:
// a whole L-layer autoregressive flow (MAF and NSF-AR coming back, an IAF
// going forward) in one launch, for either weight type
// (maf_degree_inverse.cu: fp32; maf_degree_inverse_bf16.cu: bf16).
//
// Replaces the fixed-point branch of the TPU kernel
// nflows_tpu/ops/pallas/maf_flow_kernel.py:_kernel (lines 184-191: D full
// MADE passes from zeros, then one more for the logabsdet), which
// maf_flow_kernel.cuh runs as written. Same function, another schedule.
// A residual MADE gives hidden unit u a degree d_u (it sees inputs
// 1..d_u); every hidden mask is d_out >= d_in and the output mask of
// feature t is t > d_in. So once features 1..k are known, the units of
// degree k, stage by stage, depend only on values that are final, and
// feature k + 1's parameters only on units of degree <= k. The packer
// (ops/cuda/maf_flow_kernel.py: pack_degree_order) sorts the units by
// degree (one permutation for every stage of a layer) and lays out every
// product the schedule needs as slabs [depth][width] in the order the
// kernel runs them. Each layer: the permutation, then D steps; step k
// computes the degree-k units of the initial layer (k deep; with a
// context, relu(Wci c + bci) first), of each block's two linears (depth
// the units of degree <= k; with a context, Wcb_j c + bcb_j first), then
// feature k + 1's parameters (same depth), its elementwise inverse and
// logabsdet; then the inverse permutation and the logabsdet sum. The sums
// are the fixed point's, less its structural zeros and recomputed outputs,
// added in another order.
//
// Bound on the H100: operations, 2 (nnz(masks) + (1 + nb) C H) fp32 FLOP a
// sample a layer on the CUDA cores (67 TFLOP/s), the work of one masked
// MADE pass. The schedule has no tensor cores: a step's GEMMs are
// 4 samples x <= 32 columns x <= H deep a warp, so it is bound by the
// latency of D x (2 + 2 nb) short dependent phases a layer, not by the FMA
// rate; the fp32 route stays fp32.
//
// Design.
// - A block holds a tile of ROWS samples (16 or 32). Consumer warp w owns
//   samples 4w..4w+3 of it from the first load to the last store: every
//   activation a warp reads it wrote itself, so warps need no barrier
//   between them; a lane owns one output column (its 4 samples), or, for a
//   slab narrower than 16 columns, a share of the depth, summed by
//   shuffles at the end.
// - Every stage's activations stay resident across the D steps, feature-
//   major ([units][ROWS] fp32): h_0, then t_j and h_(j+1) for each block
//   (1 + 2 nb buffers: 160 KB at hidden 256, two blocks, 32 samples), the
//   state, the AR op's input and output, one feature's parameters and the
//   context.
// - The weights stream from global memory (resident in L2 across blocks)
//   through a ring of 8 KB slots. The slabs do not depend on the data, so
//   the copies run ahead of the compute as far as the ring allows; a slab
//   is cut into chunks of whole rows of one slot each (the chunk table).
//   A producer warp fills the ring with TMA bulk copies, each completing
//   on its slot's "full" mbarrier; consumer warps wait on "full" and
//   release each slot on its "empty" mbarrier, so no warp ever waits for
//   another consumer. (A block-synchronous ring, every thread copying with
//   cp.async and one block barrier a chunk, was 18-28% slower on the H100:
//   PERF.md.)
// - With bf16 weights the slabs are bf16, widened exactly in registers,
//   and each GEMM's activation operand is rounded to bf16 (nearest even)
//   where it is loaded, after the relu: the inputs, relu(h), h and the
//   context; a block's inner activation t is stored rounded by the first
//   GEMM, as tile_gemm.cuh does. Sums, biases, the transformer and the
//   logabsdet stay fp32.
// - The ragged last tile computes on zero rows and skips their stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rq_spline.cuh"
#include "tile_gemm.cuh"

namespace {
namespace degree {

constexpr int kSlotBytes = 8192;  // one ring slot
// samples a consumer warp owns: 4, a float4 of each activation row (on the
// H100, 8 a warp was slower at every tile size, with fewer
// warps to hide the steps' latency; 2 a warp spilled and was slower too)
constexpr int SPW = 4;
constexpr float kAffineEpsilon = 1e-3f;

// ring slots a tile size takes: 32-sample tiles fill a block's shared
// memory, 16-sample ones leave room for a second block on the SM
template <int ROWS>
__host__ __device__ constexpr int ring_slots() { return ROWS == 32 ? 6 : 3; }

template <typename WT>
struct Args {
  const float* x;    // [n][D]
  const float* ctx;  // [n][C], null when C = 0
  float* y;
  float* lad;
  int64_t n;
  int D, L, H, M, nb, C;  // M: parameters a feature (2, or 3K - 1)
  const WT* stream;       // the slabs, in the order the kernel runs them
  const int* chunks;      // [nchunks][2]: element offset, element count
  int nchunks;
  const int* offsets;  // [L][D + 1]: first sorted unit of each degree
  const float* bi;     // [L][H] sorted units
  const float* bb;     // [L][2 nb][H]
  const float* bf;     // [L][M D] param-major
  const float* bci;    // [L][H]
  const float* bcb;    // [L][nb][H]
  const int* idx;      // [L][2 D + 1]: perm_rows, inv_perm_rows, wrapped
  int inverse;
  int rq;
  float wh_scale;
  nflows::RQConfig cfg;
};

// ---- the ring's synchronisation on sm_90: mbarriers, TMA bulk copies ----
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// a chunk that never comes is a fault of the walk, not a wait: trap
// rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spins = 0; !mbar_try_wait(bar, parity); ++spins)
    if (spins > (1ll << 26)) __trap();
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// ---------------------------------------------------------------------------

__device__ __forceinline__ float widen(float w) { return w; }
__device__ __forceinline__ float widen(__nv_bfloat16 w) { return __bfloat162float(w); }

// the ring of weight chunks; q counts the chunks of the whole launch
template <int ROWS, typename WT>
struct Ring {
  static constexpr int S = ring_slots<ROWS>();
  WT* slots;
  uint64_t* full;   // [S]
  uint64_t* empty;  // [S]
  const Args<WT>* a;

  __device__ WT* slot(int q) const {
    return slots + (size_t)(q % S) * (kSlotBytes / sizeof(WT));
  }
  // the producer warp's lane 0: every chunk in order, each into its slot
  // once the consumers have released it
  __device__ void produce() const {
    for (int q = 0; q < a->nchunks; ++q) {
      if (q >= S) mbar_wait(empty + q % S, ((q / S) - 1) & 1);
      const unsigned bytes = (unsigned)a->chunks[2 * q + 1] * sizeof(WT);
      mbar_expect_tx(full + q % S, bytes);
      bulk_copy(slot(q), a->stream + a->chunks[2 * q], bytes, full + q % S);
    }
  }
  __device__ const WT* acquire(int q) const {
    mbar_wait(full + q % S, (q / S) & 1);
    return slot(q);
  }
  __device__ void release(int q) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + q % S);
  }
};

// a slab's width: its live columns rounded up to a 16-byte row
template <typename WT>
__device__ __forceinline__ int slab_width(int live) {
  constexpr int V = 16 / sizeof(WT);
  return min(32, (live + V - 1) / V * V);
}

// a warp's SPW = 4 samples of one row, as a float4 (s0 and ROWS are
// multiples of 4)
__device__ __forceinline__ void store(float* at, const float (&v)[SPW]) {
  *reinterpret_cast<float4*>(at) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load(const float* at, float (&v)[SPW]) {
  const float4 x = *reinterpret_cast<const float4*>(at);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// One consumer warp's walk of the chunk stream; the warp owns SPW samples.
template <int ROWS, typename WT>
struct Warp {
  static constexpr int kSlotElems = kSlotBytes / sizeof(WT);
  const Args<WT>& a;
  Ring<ROWS, WT> ring;
  int q;  // the next chunk
  int lane, s0;

  // acc[i] = sum_v f(act[v][s0 + i]) W[v][c] over the slab's depth rows,
  // f a relu (RELU) and the bf16 rounding (ROUND_IN, bf16 weights); lane
  // c < width of the slab's columns, or with a narrow slab a share of the
  // rows, reduced by shuffles so that every lane of column c holds it. A
  // chunk holds kSlotElems / width rows of the slab (pack_degree_order).
  template <bool RELU, bool ROUND_IN>
  __device__ void gemm(const float* act, int depth, int width, float (&acc)[SPW]) {
    const int wp = width <= 4 ? 4 : width <= 8 ? 8 : width <= 16 ? 16 : 32;
    const int split = 32 / wp, c = lane & (wp - 1), r = lane / wp;
    const int per = kSlotElems / width;
#pragma unroll
    for (int i = 0; i < SPW; ++i) acc[i] = 0.0f;
    for (int v0 = 0; v0 < depth; v0 += per) {
      if (q >= a.nchunks) __trap();  // the walk and the chunk table disagree
      const int rows = min(per, depth - v0);
      const WT* ws = ring.acquire(q);
      if (c < width) {
        const float* in = act + (size_t)v0 * ROWS + s0;
#pragma unroll 4
        for (int i = r; i < rows; i += split) {
          const float w = widen(ws[i * width + c]);
          float4 x = *reinterpret_cast<const float4*>(in + (size_t)i * ROWS);
          if (RELU) {
            x.x = fmaxf(x.x, 0.0f); x.y = fmaxf(x.y, 0.0f);
            x.z = fmaxf(x.z, 0.0f); x.w = fmaxf(x.w, 0.0f);
          }
          if constexpr (nflows::kBf16Weights<WT> && ROUND_IN) x = nflows::round_bf16(x);
          acc[0] += x.x * w;
          acc[1] += x.y * w;
          acc[2] += x.z * w;
          acc[3] += x.w * w;
        }
      }
      ring.release(q);
      ++q;
    }
    for (int o = wp; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < SPW; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    }
  }
};

template <int ROWS, bool CTX, typename WT>
__global__ void __launch_bounds__(ROWS / SPW * 32 + 32)
    maf_degree_inverse_kernel(Args<WT> a) {
  constexpr int S = ring_slots<ROWS>();
  constexpr int NW = ROWS / SPW;  // consumer warps
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WT* slots = reinterpret_cast<WT*>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (size_t)S * kSlotBytes);
  uint64_t* empty = full + S;
  float* fl = reinterpret_cast<float*>(empty + S);
  const int D = a.D, H = a.H, nb = a.nb, M = a.M, C = a.C;
  float* stage = fl;                               // h_0..h_nb, t_0..t_(nb-1): [H][ROWS] each
  float* xs = stage + (size_t)(1 + 2 * nb) * H * ROWS;  // [D][ROWS] state
  float* zb = xs + D * ROWS;                       // [D][ROWS] the AR op's input
  float* xi = zb + D * ROWS;                       // [D][ROWS] its output, solved so far
  float* pb = xi + D * ROWS;                       // [M][ROWS] one feature's parameters
  float* cs = pb + M * ROWS;                       // [C][ROWS] context
  auto hbuf = [&](int j) { return stage + (size_t)j * H * ROWS; };
  auto tbuf = [&](int j) { return stage + (size_t)(nb + 1 + j) * H * ROWS; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring<ROWS, WT> ring{slots, full, empty, &a};
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NW);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == NW) {
    if (lane == 0) ring.produce();
    return;
  }

  const int s0 = warp * SPW;
  const int64_t base = (int64_t)blockIdx.x * ROWS;
  const int rows = (int)min((int64_t)ROWS, a.n - base);
  for (int e = lane; e < SPW * D; e += 32) {
    const int s = e / D, i = e % D;
    xs[i * ROWS + s0 + s] = s0 + s < rows ? a.x[(base + s0 + s) * D + i] : 0.0f;
  }
  if constexpr (CTX) {
    for (int e = lane; e < SPW * C; e += 32) {
      const int s = e / C, i = e % C;
      cs[i * ROWS + s0 + s] = s0 + s < rows ? a.ctx[(base + s0 + s) * C + i] : 0.0f;
    }
  }
  __syncwarp();

  Warp<ROWS, WT> w{a, ring, 0, lane, s0};
  float acc[SPW], acc_c[SPW];
  float lad_total = 0.0f;
  const int K = a.cfg.num_bins;
  // the warp's SPW samples of row u of a feature-major buffer
  auto row = [&](float* buf, int u) { return buf + (size_t)u * ROWS + s0; };
  for (int step = 0; step < a.L; ++step) {
    const int l = a.inverse ? a.L - 1 - step : step;
    const int* perm = a.idx + l * (2 * D + 1);
    const int* inv_perm = perm + D;
    const int* off = a.offsets + l * (D + 1);
    // going forward (a wrapped layer) the permutation comes before the AR op
    for (int e = lane; e < SPW * D; e += 32) {
      const int i = e / SPW, s = s0 + e % SPW;
      zb[i * ROWS + s] = a.inverse ? xs[i * ROWS + s] : xs[perm[i] * ROWS + s];
    }
    __syncwarp();
    float lsum = 0.0f;
    for (int k = 0; k < D; ++k) {
      const int g0 = off[k], dh = off[k + 1], G = dh - g0;
      // the degree-k units of the initial layer: (Wi x + bi) [+ relu(Wci c + bci)]
      for (int p = 0; p < G; p += 32) {
        const int live = min(32, G - p), width = slab_width<WT>(live), u = g0 + p + lane;
        const float b = lane < live ? a.bi[l * H + u] : 0.0f;
        const float bc = CTX && lane < live ? a.bci[l * H + u] : 0.0f;
        if constexpr (CTX) w.template gemm<false, true>(cs, C, width, acc_c);
        w.template gemm<false, true>(xi, k, width, acc);
        if (lane < live) {
          float v[SPW];
#pragma unroll
          for (int i = 0; i < SPW; ++i)
            v[i] = CTX ? (acc[i] + b) + fmaxf(acc_c[i] + bc, 0.0f) : acc[i] + b;
          store(row(hbuf(0), u), v);
        }
        __syncwarp();
      }
      // ... of each block: t = relu((W0 relu(h) + b0) [+ (Wcb c + bcb)]),
      // then h' = (W1 t + b1) + h
      for (int j = 0; j < nb; ++j) {
        const size_t m0 = (size_t)(l * 2 * nb + 2 * j) * H, m1 = m0 + H;
        for (int p = 0; p < G; p += 32) {
          const int live = min(32, G - p), width = slab_width<WT>(live), u = g0 + p + lane;
          const float b = lane < live ? a.bb[m0 + u] : 0.0f;
          const float bc = CTX && lane < live ? a.bcb[(size_t)(l * nb + j) * H + u] : 0.0f;
          if constexpr (CTX) w.template gemm<false, true>(cs, C, width, acc_c);
          w.template gemm<true, true>(hbuf(j), dh, width, acc);
          if (lane < live) {
            float v[SPW];
#pragma unroll
            for (int i = 0; i < SPW; ++i)
              v[i] = fmaxf(CTX ? (acc[i] + b) + (acc_c[i] + bc) : acc[i] + b, 0.0f);
            float4 t = make_float4(v[0], v[1], v[2], v[3]);
            if constexpr (nflows::kBf16Weights<WT>) t = nflows::round_bf16(t);
            *reinterpret_cast<float4*>(row(tbuf(j), u)) = t;
          }
          __syncwarp();
        }
        for (int p = 0; p < G; p += 32) {
          const int live = min(32, G - p), width = slab_width<WT>(live), u = g0 + p + lane;
          const float b = lane < live ? a.bb[m1 + u] : 0.0f;
          w.template gemm<false, false>(tbuf(j), dh, width, acc);
          if (lane < live) {
            float v[SPW];
            load(row(hbuf(j), u), v);
#pragma unroll
            for (int i = 0; i < SPW; ++i) v[i] = (acc[i] + b) + v[i];
            store(row(hbuf(j + 1), u), v);
          }
          __syncwarp();
        }
      }
      // feature k's parameters from the units of degree <= k
      for (int p = 0; p < M; p += 32) {
        const int live = min(32, M - p), width = slab_width<WT>(live), m = p + lane;
        const float b = lane < live ? a.bf[(size_t)l * M * D + (size_t)m * D + k] : 0.0f;
        w.template gemm<false, true>(hbuf(nb), dh, width, acc);
        if (lane < live) {
          const float scale = (a.rq && m < 2 * K) ? a.wh_scale : 1.0f;
          float v[SPW];
#pragma unroll
          for (int i = 0; i < SPW; ++i) v[i] = (acc[i] + b) * scale;
          store(row(pb, m), v);
        }
      }
      __syncwarp();
      // its elementwise inverse and logabsdet, a lane a sample
      if (lane < SPW) {
        const int s = s0 + lane;
        const float z = zb[k * ROWS + s];
        float o, ld;
        if (a.rq) {
          nflows::rq_spline_eval(z, pb + s, pb + K * ROWS + s, pb + 2 * K * ROWS + s, ROWS, true,
                                 a.cfg, &o, &ld);
        } else {
          const float scale = nflows::softplus(pb[s]) + kAffineEpsilon;
          o = (z - pb[ROWS + s]) / scale;
          ld = -logf(scale);
        }
        xi[k * ROWS + s] = o;
        lsum += ld;
      }
      __syncwarp();
    }
    // coming back the inverse permutation comes after the AR op
    for (int e = lane; e < SPW * D; e += 32) {
      const int i = e / SPW, s = s0 + e % SPW;
      xs[i * ROWS + s] = a.inverse ? xi[inv_perm[i] * ROWS + s] : xi[i * ROWS + s];
    }
    lad_total += lsum;
    __syncwarp();
  }

  for (int e = lane; e < SPW * D; e += 32) {
    const int s = e / D, i = e % D;
    if (s0 + s < rows) a.y[(base + s0 + s) * D + i] = xs[i * ROWS + s0 + s];
  }
  if (lane < SPW && s0 + lane < rows) a.lad[base + s0 + lane] = lad_total;
}

template <typename WT>
size_t degree_smem_bytes(int rows, const Args<WT>& a) {
  const int slots = rows == 32 ? ring_slots<32>() : ring_slots<16>();
  return (size_t)slots * kSlotBytes + (size_t)16 * slots +
         sizeof(float) * (size_t)rows * ((size_t)(1 + 2 * a.nb) * a.H + 3 * a.D + a.M + a.C + 1);
}

template <int ROWS, bool CTX, typename WT>
int launch(const Args<WT>& a, cudaStream_t stream) {
  const size_t bytes = degree_smem_bytes(ROWS, a);
  cudaError_t err = cudaFuncSetAttribute(maf_degree_inverse_kernel<ROWS, CTX, WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (a.n + ROWS - 1) / ROWS;
  maf_degree_inverse_kernel<ROWS, CTX, WT>
      <<<(unsigned)blocks, ROWS / SPW * 32 + 32, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// transformer: 0 affine (M = 2), 1 rq (M = 3 K - 1). C = 0: no context
// (ctx, bci and bcb may be null). rows: 16 or 32. WT is the slabs' type (float
// or __nv_bfloat16); the biases are fp32. Returns a cudaError_t value (0 on
// success).
template <typename WT>
int maf_degree_entry(const float* x, const float* ctx, float* y, float* lad, int64_t n, int D,
                     int L, int H, int M, int nb, int C, const WT* stream, const int* chunks,
                     int nchunks, const int* offsets, const float* bi, const float* bb,
                     const float* bf, const float* bci, const float* bcb, const int* idx,
                     int inverse, int transformer, float wh_scale, int num_bins,
                     float tail_bound, float min_bin_width, float min_bin_height,
                     float min_derivative, int rows, void* cuda_stream) {
  if (n == 0) return 0;
  if (D < 1 || L < 1 || H < 1 || nb < 0 || C < 0 || nchunks < 0)
    return (int)cudaErrorInvalidValue;
  if (transformer != 0 && transformer != 1) return (int)cudaErrorInvalidValue;
  if (M != (transformer ? 3 * num_bins - 1 : 2)) return (int)cudaErrorInvalidValue;
  if (C > 0 && !(ctx && bci && bcb)) return (int)cudaErrorInvalidValue;
  Args<WT> a;
  a.x = x; a.ctx = ctx; a.y = y; a.lad = lad; a.n = n;
  a.D = D; a.L = L; a.H = H; a.M = M; a.nb = nb; a.C = C;
  a.stream = stream; a.chunks = chunks; a.nchunks = nchunks; a.offsets = offsets;
  a.bi = bi; a.bb = bb; a.bf = bf; a.bci = bci; a.bcb = bcb; a.idx = idx;
  a.inverse = inverse;
  a.rq = transformer;
  a.wh_scale = wh_scale;
  a.cfg = nflows::RQConfig{num_bins, tail_bound, min_bin_width, min_bin_height, min_derivative,
                           1.0f};
  cudaStream_t s = (cudaStream_t)cuda_stream;
  if (C > 0) {
    if (rows == 16) return launch<16, true, WT>(a, s);
    if (rows == 32) return launch<32, true, WT>(a, s);
  } else {
    if (rows == 16) return launch<16, false, WT>(a, s);
    if (rows == 32) return launch<32, false, WT>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace degree
}  // namespace
