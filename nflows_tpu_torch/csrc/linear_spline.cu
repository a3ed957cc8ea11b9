// B6: elementwise linear-tail piecewise-linear spline, forward or inverse,
// with the per-element logabsdet.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/linear_spline.py:_kernel.
//
// Bound on the H100: memory. Each element reads x and K parameters and
// writes two values (44 bytes at K = 8) for well under a hundred
// floating-point operations. At the serving shape (4,096 x 3 elements a
// coupling) the launch itself is the cost.
//
// Design: a group of lanes an element (spline_lanes.cuh), as B1
// (rq_spline.cu), on the JAX public layout ([..., K] rows). A lane reads its
// V bins of the row once (neighbouring lanes at neighbouring addresses) and
// takes each exp once; the group finds the softmax's maximum and sum by
// butterflies and the CDF knots by a scan (knot K pinned to 1). The forward
// needs no search: its bin, floor(x K) clamped, is the same in every lane
// of the group. The inverse counts by ballot the interior knots at or
// below x. Shuffles from the lanes of bins sel and sel - 1 then give the
// bin's lower knot and its pdf (forward) or upper knot (inverse). A warp
// takes up to 32 elements in rounds, each lane keeping one element's bin,
// loading the next round's row and x while it computes this one, and then
// every lane evaluates its element's bin (linear_forward_bin or
// linear_inverse_bin, as linear_spline_eval does) and writes out and lad.
// Where K > 128 the warp walks the bins in chunks of 128, carrying the
// running sum, recomputing each chunk's exps in each of its passes and the
// chunk of the selected bin once more, and evaluates each element within
// its round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "linear_spline.cuh"
#include "spline_lanes.cuh"

namespace {

using nflows::lanes::V;

// What a lane holds of its V bins: their pdf and upper CDF knots; and, the
// same in every lane, the knot below the chunk's first bin.
struct LinearBins {
  float pdf[V], hi[V];
  float lo0;
};

// The selected bin of an element: its index, lower CDF knot, and its pdf
// (forward) or upper CDF knot (inverse).
struct Selected {
  int bin;
  float lo, top;
};

// element i in its bin s
__device__ __forceinline__ void linear_bin(const float* __restrict__ x, int64_t i, int inverse,
                                           const nflows::LinearConfig& cfg, const Selected& s,
                                           float* __restrict__ out, float* __restrict__ lad) {
  const int K = cfg.num_bins;
  const float B = cfg.tail_bound;
  const float x_orig = __ldg(x + i);
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float xn = (fminf(fmaxf(x_orig, -B), B) + B) / (2.0f * B);
  float out01, l;
  if (inverse) {
    nflows::linear_inverse_bin(xn, s.bin, s.lo, s.top, K, out01, l);
  } else {
    nflows::linear_forward_bin(xn * (float)K - (float)s.bin, s.lo, s.top, cfg, out01, l);
  }
  out[i] = inside ? out01 * (2.0f * B) - B : x_orig;
  lad[i] = inside ? l : 0.0f;
}

template <int G, bool CHUNKED>
__global__ void __launch_bounds__(nflows::lanes::kThreads) linear_spline_kernel(
    const float* __restrict__ x, const float* __restrict__ up,
    float* __restrict__ out, float* __restrict__ lad, int64_t n, int inverse,
    nflows::LinearConfig cfg, int rounds) {
  const nflows::lanes::Group<G> g;
  const nflows::lanes::Rounds<G> warp(rounds);
  const bool vec = nflows::lanes::rows_of_float4(up, cfg.num_bins);
  const int64_t e0 = warp.first();
  const int K = cfg.num_bins;
  const int chunks = CHUNKED ? (K + g.kBins - 1) / g.kBins : 1;
  const float B = cfg.tail_bound;

  // a group past the last element reads row 0
  auto row_of = [&](int r) {
    const int64_t i = e0 + warp.element(r);
    return i < n ? i : (int64_t)0;
  };
  // chunk c of a row's unnormalised pdf (-inf past the last bin: out of
  // the maximum, 0 after the exp)
  auto load = [&](int64_t row, int c, float (&a)[V]) {
    nflows::lanes::load_bins(up + row * K, K, g.bin(c, 0), vec, -INFINITY, a);
  };
  // one chunk: the next round's row and x, loaded while this round computes
  float u_next[V], x_next = 0.0f;
  if (!CHUNKED) {
    load(row_of(0), 0, u_next);
    x_next = x[row_of(0)];
  }

  Selected m{};  // this lane's element's bin
  for (int r = 0; r < rounds; ++r) {
    const int64_t i = e0 + warp.element(r);
    const bool valid = i < n;
    const int64_t row = row_of(r);
    float u[V], xr;
    if (CHUNKED) {
      xr = x[row];
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) u[v] = u_next[v];
      xr = x_next;
      if (r + 1 < rounds) {
        load(row_of(r + 1), 0, u_next);
        x_next = x[row_of(r + 1)];
      }
    }
    const float xn = (fminf(fmaxf(xr, -B), B) + B) / (2.0f * B);

    // softmax maximum and sum; one chunk: the row's values and exps stay
    // in registers
    float e[V];
    float vmax = -INFINITY;
    for (int c = 0; c < chunks; ++c) {
      if (CHUNKED) load(row, c, u);
#pragma unroll
      for (int v = 0; v < V; ++v) vmax = fmaxf(vmax, u[v]);
    }
    vmax = g.max(vmax);
    float sum = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      if (CHUNKED) load(row, c, u);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        e[v] = expf(u[v] - vmax);
        sum = sum + e[v];
      }
    }
    const float inv = 1.0f / g.sum(sum);

    // chunk c's pdf and upper knots, after the running sum of the chunks
    // before it
    float run = 0.0f;
    auto bins = [&](int c) {
      LinearBins q;
      float cdf[V];
      if (CHUNKED) load(row, c, u);
#pragma unroll
      for (int v = 0; v < V; ++v) q.pdf[v] = (CHUNKED ? expf(u[v] - vmax) : e[v]) * inv;
      g.template running<CHUNKED>(q.pdf, run, cdf);
#pragma unroll
      for (int v = 0; v < V; ++v) q.hi[v] = g.bin(c, v) == K - 1 ? 1.0f : cdf[v];
      q.lo0 = run;
      if (CHUNKED) run = g.at(cdf[V - 1], G - 1);
      return q;
    };

    int sel = 0;
    LinearBins q{};
    if (inverse) {
      // the bin: how many of the interior knots 1..K-1 (the upper knots of
      // bins 0..K-2) lie at or below x
      for (int c = 0; c < chunks; ++c) {
        q = bins(c);
#pragma unroll
        for (int v = 0; v < V; ++v) sel += g.count(g.bin(c, v) < K - 1 && xn >= q.hi[v]);
      }
      if (CHUNKED) {
        run = 0.0f;
        for (int c = 0; c <= sel / g.kBins; ++c) q = bins(c);
      }
    } else {
      // the bin of x's equal-width position, floor(x K) clamped to
      // [0, K-1] as linear_spline_eval takes it: the same in every lane
      sel = (int)fminf(fmaxf(floorf(xn * (float)K), 0.0f), (float)(K - 1));
      for (int c = 0; c <= (CHUNKED ? sel / g.kBins : 0); ++c) q = bins(c);
    }
    float top[V];
#pragma unroll
    for (int v = 0; v < V; ++v) top[v] = inverse ? q.hi[v] : q.pdf[v];
    const nflows::lanes::Gather<G> take(warp, sel);
    const Selected s{take.bin, take.below(q.hi, q.lo0), take.at(top)};
    if (warp.keeps(r)) {
      // one element a round where the bins come in chunks: evaluated now
      if (CHUNKED && valid) linear_bin(x, i, inverse, cfg, s, out, lad);
      m = s;
    }
  }

  // this lane's element
  const int64_t i = e0 + warp.lane;
  if (!CHUNKED && warp.holds() && i < n) linear_bin(x, i, inverse, cfg, m, out, lad);
}

}  // namespace

extern "C" int linear_spline_launch(const float* x, const float* up,
                                    float* out, float* lad, int64_t n,
                                    int num_bins, int inverse,
                                    float tail_bound, float log_inv_bins,
                                    void* stream) {
  if (n == 0) return 0;
  nflows::LinearConfig cfg{num_bins, tail_bound, log_inv_bins};
  return nflows::lanes::launch_groups(
      n, num_bins, [&](auto G, auto chunked, unsigned grid, int rounds) {
        linear_spline_kernel<decltype(G)::value, decltype(chunked)::value>
            <<<grid, nflows::lanes::kThreads, 0, (cudaStream_t)stream>>>(
                x, up, out, lad, n, inverse, cfg, rounds);
      });
}
