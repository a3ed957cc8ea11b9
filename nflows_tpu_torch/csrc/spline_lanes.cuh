// A group of lanes an element, for the elementwise spline kernels B1
// (rq_spline.cu), B5 (lrs_spline.cu), B6 (linear_spline.cu), B7
// (quadratic_spline.cu) and B8 (cubic_spline.cu).
//
// The TPU kernels lay each bin out as a lane-dense plane
// (nflows_tpu/ops/pallas/_spline_common.py): every K-loop is a row of
// vector operations. On the card the same idea becomes lanes over bins: G
// lanes of a warp (a power of two, 2 to 32) take one element, lane j
// holding V = 4 neighbouring bins, 4 j to 4 j + 3, so G is the
// power of two at least K / 4. Where K > 128 the group is the whole warp
// and walks the bins in chunks of 128. A row of parameters is read by
// neighbouring lanes at neighbouring addresses (16 bytes a lane where the
// rows allow it), each exp and softplus is taken once a bin, and what one
// thread of the one-thread-an-element design did in K-long serial loops
// becomes a few shuffles:
//
// - max and sum: a lane's V values in order, then butterflies of
//   __shfl_xor_sync over the group; after log2 G steps every lane holds
//   the same value (fp32 addition commutes);
// - running sums: each lane's total in order, an inclusive Hillis-Steele
//   scan of the totals with __shfl_up_sync (log2 G steps, lane j adding
//   the partial sum of lane j - 2^s at step s), and within a lane the
//   scan of the lanes before plus its own running sum (running(); B8's
//   searched knots compensated, running_compensated());
// - the bin search: __ballot_sync, for each of a lane's V bins, of "x at
//   or above the upper edge of this bin" over the bins 0..K-2 (the
//   interior edges), masked to the group; the summed popcounts are the TPU
//   kernel's sum-of-ge index (bin_index_ge), which needs no prefix
//   property of the edges;
// - the selected bin's values: __shfl_sync from the lane that holds it,
//   the lower edges from the lane of the bin before and, for B8's knot
//   derivatives, the sizes of the bin after from its lane (Gather).
//
// Every shuffle names the full warp: no lane leaves a kernel before its
// last shuffle, and groups past the last element take part on row 0 and
// store nothing. The sums are taken in another order than the plain version's
// sequential ones; tests/test_torch_spline_lanes.py repeats this order on
// the CPU (tests/test_torch_spline_lanes_lrs_cubic.py for B5 and B8,
// tests/test_torch_spline_lanes_linear.py for B6) and
// holds it against the TPU kernels in interpret mode.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace nflows {
namespace lanes {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int V = 4;  // the bins a lane holds

// a[k] for a run-time k < V, without a local-memory array
__device__ __forceinline__ float pick(const float (&a)[V], int k) {
  float v = a[0];
#pragma unroll
  for (int t = 1; t < V; ++t) v = k == t ? a[t] : v;
  return v;
}

// A lane's V bins b0 .. b0 + V - 1 of a row of K values (fill past bin
// K - 1); one 16-byte load where vec says the rows allow it (K a multiple
// of 4, the tensor 16-byte aligned) and the lane's bins are all there.
__device__ __forceinline__ void load_bins(const float* __restrict__ row, int K, int b0, bool vec,
                                          float fill, float (&out)[V]) {
  if constexpr (V == 4) {  // V = 1 (one bin a lane) builds too, for tools/kernel_ab.py
    if (vec && b0 + 3 < K) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row + b0));
      out[0] = t.x;
      out[1] = t.y;
      out[2] = t.z;
      out[3] = t.w;
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) out[v] = b0 + v < K ? __ldg(row + b0 + v) : fill;
}

// whether rows of K floats at p can be read 16 bytes at a time
__device__ __forceinline__ bool rows_of_float4(const float* p, int K) {
  return K % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a + b, and its rounding error in err (Knuth's TwoSum, exact in
// round-to-nearest; __fadd_rn and __fsub_rn keep the compiler from
// contracting or reordering the steps)
__device__ __forceinline__ float two_sum(float a, float b, float& err) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return s;
}

// The group of G lanes (2 to 32, a power of two) that holds the calling
// lane, within a block of 1-D threads, each lane holding V bins.
template <int G>
struct Group {
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two, 2 to 32");
  static constexpr int kBins = G * V;  // bins a chunk
  int j;     // the lane's index in its group
  int base;  // the group's first lane in the warp

  __device__ __forceinline__ Group() {
    const int lane = threadIdx.x & 31;
    j = lane & (G - 1);
    base = lane - j;
  }

  // the bin of a lane's value v in chunk c
  __device__ __forceinline__ int bin(int c, int v) const { return c * kBins + j * V + v; }

  __device__ __forceinline__ float max(float v) const {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) v = fmaxf(v, __shfl_xor_sync(kFullWarp, v, o, G));
    return v;
  }

  __device__ __forceinline__ float sum(float v) const {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) v = v + __shfl_xor_sync(kFullWarp, v, o, G);
    return v;
  }

  // inclusive running sum in lane order
  __device__ __forceinline__ float scan(float v) const {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      const float t = __shfl_up_sync(kFullWarp, v, o, G);
      if (j >= o) v = v + t;
    }
    return v;
  }

  // Running sums of a chunk's bins in bin order after carry: out[V - 1] =
  // carry + (the inclusive scan of the lanes' totals), and for v < V - 1
  // carry + (the scan of the lanes before + the lane's own running sum);
  // the carry is left out where there is none (one chunk). The next chunk
  // starts from the last lane's out[V - 1].
  template <bool CARRY>
  __device__ __forceinline__ void running(const float (&x)[V], float carry,
                                          float (&out)[V]) const {
    float own[V];
    own[0] = x[0];
#pragma unroll
    for (int v = 1; v < V; ++v) own[v] = own[v - 1] + x[v];
    const float incl = scan(own[V - 1]);
    if constexpr (V > 1) {
      float before = __shfl_up_sync(kFullWarp, incl, 1, G);
      if (j == 0) before = 0.0f;
#pragma unroll
      for (int v = 0; v < V - 1; ++v) out[v] = CARRY ? carry + (before + own[v]) : before + own[v];
    }
    out[V - 1] = CARRY ? carry + incl : incl;
  }

  // running() with each addition's rounding error carried beside its sum
  // (two_sum) and added once at the end, so that every out lies within
  // about an ulp of the exact running sum of x whatever the order of the
  // additions: B8's knots, where an ulp of a knot can move the logabsdet by
  // 1e-3 (a steep cubic in a narrow bin: 6 a t + 2 b about 1e4 times the
  // derivative)
  template <bool CARRY>
  __device__ __forceinline__ void running_compensated(const float (&x)[V], float carry,
                                                      float (&out)[V]) const {
    float own[V], own_err[V];
    own[0] = x[0];
    own_err[0] = 0.0f;
#pragma unroll
    for (int v = 1; v < V; ++v) {
      float e;
      own[v] = two_sum(own[v - 1], x[v], e);
      own_err[v] = own_err[v - 1] + e;
    }
    // the inclusive scan of the lanes' (sum, error) pairs in lane order
    float hi = own[V - 1], lo = own_err[V - 1];
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      const float t_hi = __shfl_up_sync(kFullWarp, hi, o, G);
      const float t_lo = __shfl_up_sync(kFullWarp, lo, o, G);
      if (j >= o) {
        float e;
        hi = two_sum(t_hi, hi, e);
        lo = (t_lo + lo) + e;
      }
    }
    float before_hi = __shfl_up_sync(kFullWarp, hi, 1, G);
    float before_lo = __shfl_up_sync(kFullWarp, lo, 1, G);
    if (j == 0) before_hi = before_lo = 0.0f;
    // carry + (s + err), rounded once
    auto finish = [&](float s, float err) {
      if constexpr (CARRY) {
        float e;
        const float t = two_sum(carry, s, e);
        return t + (err + e);
      } else {
        return s + err;
      }
    };
#pragma unroll
    for (int v = 0; v < V - 1; ++v) {
      float e;
      const float t = two_sum(before_hi, own[v], e);
      out[v] = finish(t, (before_lo + own_err[v]) + e);
    }
    out[V - 1] = finish(hi, lo);
  }

  // lane j - 1's value (lane 0 gets its own)
  __device__ __forceinline__ float up(float v) const {
    return __shfl_up_sync(kFullWarp, v, 1, G);
  }

  // lane src's value
  __device__ __forceinline__ float at(float v, int src) const {
    return __shfl_sync(kFullWarp, v, src, G);
  }

  // the value of bin b (b < kBins: of this chunk) of a[], in every lane
  __device__ __forceinline__ float at_bin(const float (&a)[V], int b) const {
    return at(pick(a, b % V), b / V);
  }

  // how many lanes of the group hold pred
  __device__ __forceinline__ int count(bool pred) const {
    const unsigned bits = __ballot_sync(kFullWarp, pred) >> base;
    if constexpr (G == 32) {
      return __popc(bits);
    } else {
      return __popc(bits & ((1u << G) - 1u));
    }
  }
};

// A warp works on up to 32 elements, P = 32 / G a round, in R rounds: in
// round r group g (lanes g G to g G + G - 1) takes element r P + g, and lane
// L keeps what its group found for element L (round L / P, group L % P), so
// that after the last round each lane evaluates and writes one element:
// the spline of the selected bin once an element and not once a lane, and
// the stores coalesced. R is chosen at launch (launch_groups).
template <int G>
struct Rounds {
  static constexpr int P = 32 / G;  // elements a round
  int lane;
  int rounds;

  __device__ __forceinline__ explicit Rounds(int r) : lane(threadIdx.x & 31), rounds(r) {}

  // the warp's first element
  __device__ __forceinline__ int64_t first() const {
    return (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * (int64_t)(rounds * P);
  }
  // this lane's group's element in round r, after first()
  __device__ __forceinline__ int element(int r) const { return r * P + lane / G; }
  // whether round r works on this lane's element
  __device__ __forceinline__ bool keeps(int r) const { return lane / P == r; }
  // the first lane of the group that works on this lane's element
  __device__ __forceinline__ int group_of_mine() const { return (lane % P) * G; }
  // whether this lane holds an element at all
  __device__ __forceinline__ bool holds() const { return lane < rounds * P; }
};

// Gathers, in a round, what the group working on this lane's element holds
// of its selected bin sel (the group's own sel, the same in its lanes; an
// index into the chunk that holds it): from the lane of bin sel; of bin
// sel - 1 from its lane, or, where sel is the chunk's first bin, the value
// below the chunk (lo0); of bin sel + 1 from its lane, or, where sel is the
// chunk's last bin, the value above the chunk (hi0). Each lane offers the
// values its own group asks for. bin is the selected bin of this lane's
// element, counted from bin 0.
template <int G>
struct Gather {
  static constexpr int kBins = G * V;
  int bin, src, src_below, src_above, own;
  bool first, last;

  __device__ __forceinline__ Gather(const Rounds<G>& w, int sel) {
    const int base = w.group_of_mine();
    bin = __shfl_sync(kFullWarp, sel, base);
    const int s = bin % kBins;
    src = base + s / V;
    src_below = s % V ? src : src - 1;
    src_above = s % V < V - 1 ? src : src + 1;
    first = s == 0;
    last = s == kBins - 1;
    own = sel % kBins % V;
  }
  __device__ __forceinline__ float at(const float (&a)[V]) const {
    return __shfl_sync(kFullWarp, pick(a, own), src);
  }
  __device__ __forceinline__ float below(const float (&a)[V], float lo0) const {
    const float offer = own ? pick(a, own - 1) : a[V - 1];
    const float t = __shfl_sync(kFullWarp, offer, src_below);
    return first ? lo0 : t;
  }
  __device__ __forceinline__ float above(const float (&a)[V], float hi0) const {
    const float offer = own < V - 1 ? pick(a, own + 1) : a[0];
    const float t = __shfl_sync(kFullWarp, offer, src_above);
    return last ? hi0 : t;
  }
};

constexpr int kThreads = 256;  // a block: 8 warps

// the power of two at least k, 2 to 32
constexpr int lanes_for(int k) {
  return k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : 32;
}

// The SMs of the card current at the first launch, read once: it sets only
// how many rounds a warp takes, not what a kernel computes.
inline int multiprocessors() {
  static const int sms = [] {
    int device = 0, count = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        count <= 0) {
      (void)cudaGetLastError();
      return 132;  // an H100 SXM's
    }
    return count;
  }();
  return sms;
}

// Launch n elements of K bins: calls launch(G, chunked, blocks, rounds)
// with std::integral_constant<int, G> and std::bool_constant<K > 128>, and
// returns cudaGetLastError(). Rounds: 32 elements a warp where that still
// gives every SM 32 warps (half of what it holds), else halved until it
// does or a warp runs one round: a small batch is bound by a round's
// latency, a large one by the instructions an element issues.
template <typename Launch>
int launch_groups(int64_t n, int K, Launch&& launch) {
  const int sms = multiprocessors();
  const int G = lanes_for((K + V - 1) / V), P = 32 / G;
  int rounds = G;
  while (rounds > 1 && (n + rounds * P - 1) / (rounds * P) < 32LL * sms) rounds /= 2;
  const int64_t per_block = (int64_t)(kThreads / 32) * rounds * P;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  using Flat = std::false_type;
  switch (G) {
    case 2: launch(std::integral_constant<int, 2>{}, Flat{}, grid, rounds); break;
    case 4: launch(std::integral_constant<int, 4>{}, Flat{}, grid, rounds); break;
    case 8: launch(std::integral_constant<int, 8>{}, Flat{}, grid, rounds); break;
    case 16: launch(std::integral_constant<int, 16>{}, Flat{}, grid, rounds); break;
    default:
      if (K > 32 * V) {
        launch(std::integral_constant<int, 32>{}, std::true_type{}, grid, rounds);
      } else {
        launch(std::integral_constant<int, 32>{}, Flat{}, grid, rounds);
      }
  }
  return (int)cudaGetLastError();
}

}  // namespace lanes
}  // namespace nflows
