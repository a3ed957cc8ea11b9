// The pieces of a whole-model kernel on Hopper's tensor cores that B2's
// (nsf_flow_wgmma.cuh) and B9's one-pass direction (maf_flow_wgmma.cuh)
// share: a 32-sample tile a block, a producer warp that streams a packed
// weight image chunk by chunk by TMA bulk copies into a ring of 4
// mbarriered 32 KB slots, two consumer warpgroups that run wgmma on the
// chunks that have arrived (warpgroup w on the 64-row slabs w and w + 2 of
// every GEMM), and the operand buffers and accumulator layout their
// epilogues write and read. nsf_flow_wgmma.cuh's note says why each piece
// is as it is. The image's layout is ops/cuda/nsf_flow_kernel.py's
// wgmma_positions; a GEMM of depth K over ns slabs is cut into chunks of
// chunk_steps(K es / 32, ns) wgmma steps. Consumer::gemm_folded, which
// B9's fp32 kernel takes, sums each chunk's 3xTF32 products apart and adds
// them to the accumulators in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {
namespace wg {

constexpr int ROWS = 32;                   // samples a tile: wgmma's N
constexpr int NCW = 2;                     // consumer warpgroups
constexpr int NCT = NCW * 128;             // consumer threads
constexpr int NT = NCT + 32;               // and the producer warp
constexpr int kSlotBytes = 32768;          // weight bytes a ring slot holds
constexpr int kStepBytes = 2048;           // one slab's A tile of one wgmma: 64 rows x 32 bytes
constexpr int kMaxSlabs = 4;               // 64-row slabs of a GEMM: H, TMp <= 256
constexpr int kOwned = kMaxSlabs / NCW;    // slabs a warpgroup owns
constexpr int kOpStep = ROWS / 8 * 256;    // bytes of an operand's wgmma step: 32 B of K x 32 rows

template <typename WT>
constexpr bool kSplit = std::is_same<WT, float>::value;  // 3xTF32
constexpr int kSlots = 4;                  // ring slots

// wgmma steps a chunk of a GEMM of nk steps over ns slabs holds: the
// largest power of two up to 8 that a slot takes, or nk
// (ops/cuda/nsf_flow_kernel.py: _chunk_steps)
__host__ __device__ __forceinline__ int chunk_steps(int nk, int ns) {
  int per = 8;  // a power of two up to 8: an fp32 chunk's fragments are registers
  while (per * ns * kStepBytes > kSlotBytes) per >>= 1;
  return per < nk ? per : nk;
}

// ---- the ring's synchronisation on sm_90: mbarriers, TMA bulk copies ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// ---- wgmma -----------------------------------------------------------------
// A shared-memory matrix descriptor without swizzle: start address, LBO
// (the stride between the two 16-byte core-matrix columns along K) and SBO
// (the stride between 8-row groups along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// A: a slab's step, [2 core columns][8 row groups][128 B]
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) { return make_desc(addr, 1024, 128); }
// B: an operand's step, [2 core columns][4 sample groups][128 B]
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return make_desc(addr, ROWS / 8 * 128, 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory, visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define NSF_WG_ACC                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d[64 x 32] += A[64 x 16] B[16 x 32], bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db, __nv_bfloat16) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : NSF_WG_ACC
      : "l"(da), "l"(db));
}
// d[64 x 32] += A[64 x 8] B[8 x 32], tf32, A from the warpgroup's
// registers: a[0..3] of thread t hold rows 16 (t / 32) + (t % 32) / 4 and
// that + 8, columns t % 4 and that + 4 (a0: row, col; a1: row + 8, col;
// a2: row, col + 4; a3: row + 8, col + 4)
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : NSF_WG_ACC
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
#undef NSF_WG_ACC

// keeps the compiler from moving accesses of accumulators across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&acc)[kOwned][16]) {
#pragma unroll
  for (int j = 0; j < kOwned; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(acc[j][i])::"memory");
}

// cvt.rna.tf32.f32 on finite values (round the magnitude to 10 mantissa
// bits, ties away from zero) in two integer operations: the conversion
// instruction's rate made the weights' split a third of a warp's cycles
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}
// ---------------------------------------------------------------------------

// f(e) for e < n, spread over the consumer threads in a loop whose trip
// count is the same for every thread: ptxas serializes every wgmma of a
// kernel that has a loop whose trip count differs between threads (its
// warning C7520, "compiler-inserted WG.AR in divergent path")
template <typename F>
__device__ __forceinline__ void for_consumers(int n, int tid, F&& f) {
  for (int i = 0; i < n; i += NCT) {
    const int e = i + tid;
    if (e < n) f(e);
  }
}

// the consumers' barrier (the producer warp takes no part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory");
}

// byte offset of element (s, k) of a [32][K] K-major operand of es-byte
// elements: core matrices [K es / 16][4][8 rows x 16 B]
__device__ __forceinline__ uint32_t op_offset(int s, int k, int es) {
  const int kb = k * es;
  return (uint32_t)(((kb >> 4) * (ROWS / 8) + (s >> 3)) * 128 + (s & 7) * 16 + (kb & 15));
}

// An operand buffer: bf16, or hi and lo tf32 planes of fp32.
template <typename WT>
struct Operand {
  char* hi;
  char* lo;  // fp32 only
  // v at byte offset at, rounded to bf16 or split into tf32 hi and lo
  __device__ void put_at(uint32_t at, float v) const {
    if constexpr (kSplit<WT>) {
      const float h = tf32_rna(v);
      *reinterpret_cast<float*>(hi + at) = h;
      *reinterpret_cast<float*>(lo + at) = tf32_rna(v - h);
    } else {
      *reinterpret_cast<__nv_bfloat16*>(hi + at) = __float2bfloat16_rn(v);
    }
  }
  __device__ void put(int s, int k, float v) const { put_at(op_offset(s, k, sizeof(WT)), v); }
};

// The operand offset of fragment value i of slab `slab` of thread t, as
// op_offset(frag_col(t, i), 64 slab + frag_row(t, i)) splits it: a part of
// the thread (t0 = frag_offset0(t)) and one of the slab and the value,
// which the compiler folds for each unrolled i.
template <typename WT>
__device__ __forceinline__ uint32_t frag_offset0(int t) {
  return op_offset(2 * (t & 3), 16 * (t >> 5) + ((t & 31) >> 2), sizeof(WT));
}
template <typename WT>
__device__ __forceinline__ uint32_t frag_offset(uint32_t t0, int slab, int i) {
  constexpr uint32_t es = sizeof(WT);
  return t0 + (uint32_t)slab * 64 * es * 32 + ((i & 3) >> 1) * es * 256 + (i >> 2) * 128 +
         (i & 1) * 16;
}

// The ring of weight chunks and one consumer warpgroup's walk of it; q
// counts the chunks of the launch, in the order the producer sends them.
template <typename WT>
struct Ring {
  static constexpr int S = kSlots;
  char* slots;      // [S][kSlotBytes]
  uint64_t* full;   // [S]
  uint64_t* empty;  // [S]

  __device__ char* slot(int q) const { return slots + (size_t)(q % S) * kSlotBytes; }
};

// One chunk of the stream into its slot, by the producer lane that owns
// the slot, once the consumers have released the slot's last chunk. A
// lane a slot: on the H100 one thread's bulk copies run one after another,
// S lanes' overlap (tools/l2_stream.py).
template <typename WT>
__device__ __forceinline__ void send(const Ring<WT>& ring, int q, int lane, const char* src,
                                     unsigned bytes) {
  constexpr int S = Ring<WT>::S;
  if (q % S != lane) return;
  if (q >= S) mbar_wait(ring.empty + lane, ((q / S) - 1) & 1);
  mbar_expect_tx(ring.full + lane, bytes);
  bulk_copy(ring.slot(q), src, bytes, ring.full + lane);
}

// One GEMM's chunks (depth K, ns slabs) from src on, in order, chunk q
// by the producer lane that owns its slot; returns where the next GEMM's
// chunks start.
template <typename WT>
__device__ __forceinline__ const char* send_gemm(const Ring<WT>& ring, int& q, int lane,
                                                 const char* src, int K, int ns) {
  constexpr int es = sizeof(WT);
  const int nk = K * es / 32;
  const int kc = chunk_steps(nk, ns);
  for (int k0 = 0; k0 < nk; k0 += kc) {
    const unsigned bytes = (unsigned)(ns * min(kc, nk - k0) * kStepBytes);
    send(ring, q, lane, src, bytes);
    src += bytes;
    ++q;
  }
  return src;
}

// One consumer warpgroup: w (0 or 1) owns slabs w and w + 2 of every GEMM.
template <typename WT>
struct Consumer {
  Ring<WT> ring;
  int q;      // the next chunk
  int w;      // the warpgroup
  int t;      // thread in the warpgroup

  // acc[j] += W[slab w + 2 j] B over the GEMM's K (ns slabs), B an
  // operand buffer. The products of chunk q run while chunk q + 1 is
  // awaited (and split); chunk q is released once they are done.
  __device__ void gemm(int K, int ns, const Operand<WT>& B, float (&acc)[kOwned][16]) {
    // the slabs this warpgroup owns, each branch free of conditions around
    // its wgmmas: the compiler serializes wgmma on a conditional path
    const int nj = (ns - w + NCW - 1) / NCW;
    if (nj == 2) walk<2>(K, ns, B, acc);
    else if (nj == 1) walk<1>(K, ns, B, acc);
    else walk<0>(K, ns, B, acc);
  }

  template <int NJ>
  __device__ void walk(int K, int ns, const Operand<WT>& B, float (&acc)[kOwned][16]) {
    constexpr int es = sizeof(WT);
    const int nk = K * es / 32;
    const int kc = chunk_steps(nk, ns);
    const uint32_t bh = smem_addr(B.hi);
    const uint32_t bl = kSplit<WT> ? smem_addr(B.lo) : 0u;
    for (int k0 = 0; k0 < nk; k0 += kc) {
      const int kn = min(kc, nk - k0);
      mbar_wait(ring.full + q % Ring<WT>::S, (q / Ring<WT>::S) & 1);
      const char* slot = ring.slot(q);
      if constexpr (NJ > 0 && kSplit<WT>) {
        // chunks of 2, 4 or 8 steps (chunk_steps)
        if (kn == 8) chunk_tf32<NJ, 8>(slot, k0, bh, bl, acc);
        else if (kn == 4) chunk_tf32<NJ, 4>(slot, k0, bh, bl, acc);
        else if (kn == 2) chunk_tf32<NJ, 2>(slot, k0, bh, bl, acc);
        else __trap();
      } else {
        if constexpr (NJ > 0) {
          const uint32_t sa = smem_addr(slot);
          fence_acc(acc);
          wgmma_fence();
          for (int kk = 0; kk < kn; ++kk) {
            const uint32_t bo = (uint32_t)(k0 + kk) * kOpStep;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const uint32_t ao = (uint32_t)((w + NCW * j) * kn + kk) * kStepBytes;
              mma(acc[j], desc_a(sa + ao), desc_b(bh + bo), WT());
            }
          }
          wgmma_commit();
          wgmma_wait<1>();
        }
        if (k0 > 0) release(q - 1);
      }
      ++q;
    }
    if constexpr (NJ > 0) {
      wgmma_wait<0>();
      fence_acc(acc);
    }
    release(q - 1);
  }

  // 3xTF32 on one chunk of KN steps (fp32 weights): the weights' fragments
  // come from the slot into registers (wgmma's A from registers) and are
  // split there into hi and lo, so that the weights are read from shared
  // memory once and nothing is written back; then acc[j] += A_lo B_hi +
  // A_hi B_lo + A_hi B_hi, step by step, one commit group. The fragments
  // load once the chunk before is done (and its slot released), since an
  // instruction may not write a wgmma's input registers while wgmmas are
  // in flight.
  template <int NJ, int KN>
  __device__ void chunk_tf32(const char* slot, int k0, uint32_t bh, uint32_t bl,
                             float (&acc)[kOwned][16]) {
    // the thread's A fragment: rows 16 (t / 32) + (t % 32) / 4 (+ 8),
    // columns t % 4 (+ 4) of a slab's step, in its core-matrix layout
    const char* frag = slot + (t >> 5) * 256 + (t & 31) * 4;
    wgmma_wait<0>();
    if (k0 > 0) release(q - 1);
    uint32_t hi[KN][NJ][4], lo[KN][NJ][4];
#pragma unroll
    for (int kk = 0; kk < KN; ++kk)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const char* at = frag + ((w + NCW * j) * KN + kk) * kStepBytes;
        const float v[4] = {*reinterpret_cast<const float*>(at),
                            *reinterpret_cast<const float*>(at + 128),
                            *reinterpret_cast<const float*>(at + 1024),
                            *reinterpret_cast<const float*>(at + 1152)};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float h = tf32_rna(v[r]);
          hi[kk][j][r] = __float_as_uint(h);
          lo[kk][j][r] = __float_as_uint(tf32_rna(v[r] - h));
        }
      }
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      const uint32_t bo = (uint32_t)(k0 + kk) * kOpStep;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma_rs(acc[j], lo[kk][j], desc_b(bh + bo));
        mma_rs(acc[j], hi[kk][j], desc_b(bl + bo));
        mma_rs(acc[j], hi[kk][j], desc_b(bh + bo));
      }
    }
    wgmma_commit();
  }

  // gemm for fp32 weights (3xTF32) with each chunk's products summed apart
  // in part and added to acc in fp32: the tensor cores' accumulation
  // truncates, so a GEMM that chains every product of its depth into one
  // accumulator drifts by several times fp32's rounding (PERF.md); a chunk
  // chains at most 24. part is scratch.
  __device__ void gemm_folded(int K, int ns, const Operand<WT>& B, float (&acc)[kOwned][16],
                              float (&part)[kOwned][16]) {
    static_assert(kSplit<WT>, "gemm_folded is the 3xTF32 GEMM");
    const int nj = (ns - w + NCW - 1) / NCW;
    if (nj == 2) walk_folded<2>(K, ns, B, acc, part);
    else if (nj == 1) walk_folded<1>(K, ns, B, acc, part);
    else walk<0>(K, ns, B, acc);
  }

  template <int NJ>
  __device__ void walk_folded(int K, int ns, const Operand<WT>& B, float (&acc)[kOwned][16],
                              float (&part)[kOwned][16]) {
    const int nk = K * 4 / 32;
    const int kc = chunk_steps(nk, ns);
    const uint32_t bh = smem_addr(B.hi), bl = smem_addr(B.lo);
#pragma unroll
    for (int j = 0; j < kOwned; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) part[j][i] = 0.0f;
    for (int k0 = 0; k0 < nk; k0 += kc) {
      const int kn = min(kc, nk - k0);
      mbar_wait(ring.full + q % Ring<WT>::S, (q / Ring<WT>::S) & 1);
      // the chunk before's products are done: into acc, part from zero
      wgmma_wait<0>();
      fold(acc, part);
      if (kn == 8) chunk_tf32<NJ, 8>(ring.slot(q), k0, bh, bl, part);
      else if (kn == 4) chunk_tf32<NJ, 4>(ring.slot(q), k0, bh, bl, part);
      else if (kn == 2) chunk_tf32<NJ, 2>(ring.slot(q), k0, bh, bl, part);
      else __trap();
      ++q;
    }
    wgmma_wait<0>();
    fold(acc, part);
    fence_acc(acc);
    release(q - 1);
  }

  __device__ static void fold(float (&acc)[kOwned][16], float (&part)[kOwned][16]) {
    fence_acc(part);
#pragma unroll
    for (int j = 0; j < kOwned; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        acc[j][i] += part[j][i];
        part[j][i] = 0.0f;
      }
  }

  __device__ void release(int c) const {
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(ring.empty + c % Ring<WT>::S);
  }
};

// The accumulator fragment of m64n32: value i of thread t of a warpgroup
// holds output row 16 (t / 32) + (t % 32) / 4 + 8 ((i % 4) / 2) of the
// slab, sample 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ int frag_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i & 3) >> 1);
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

__device__ __forceinline__ void zero(float (&acc)[kOwned][16]) {
#pragma unroll
  for (int j = 0; j < kOwned; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[j][i] = 0.0f;
}

// An epilogue's walk of consumer thread t's accumulator values (warpgroup
// w) over the slabs it owns of an ns-slab GEMM: f(j, i, output, sample,
// operand offset), t0 = frag_offset0<WT>(t).
template <typename WT, typename F>
__device__ __forceinline__ void each_owned(int w, int t, uint32_t t0, int ns, F&& f) {
#pragma unroll
  for (int j = 0; j < kOwned; ++j) {
    const int s = w + NCW * j;
    if (s < ns) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        f(j, i, s * 64 + frag_row(t, i), frag_col(t, i), frag_offset<WT>(t0, s, i));
    }
  }
}

// The biases of thread t's two output rows in each slab it owns of an
// ns-slab GEMM, read before the GEMM whose epilogue adds them (reading them
// from shared memory in the epilogue instead was 18% slower in bf16 on the
// H100)
__device__ __forceinline__ void load_bias(int w, int t, const float* b, int ns,
                                          float (&bv)[kOwned][2]) {
#pragma unroll
  for (int j = 0; j < kOwned; ++j) {
    const int s = w + NCW * j;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      bv[j][r] = s < ns ? __ldg(b + s * 64 + frag_row(t, 2 * r)) : 0.0f;
  }
}

}  // namespace wg
}  // namespace
