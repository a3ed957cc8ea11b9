// B7: elementwise linear-tail piecewise-quadratic spline (K-1 heights),
// forward or inverse, with the per-element logabsdet.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/quadratic_spline.py:_kernel.
//
// Bound on the H100: memory. Each element reads x and 2K-1 parameters and
// writes two values (72 bytes at K = 8) for a few hundred floating-point
// operations. At the serving shape (4,096 x 3 elements a coupling) the
// launch itself is the cost.
//
// Design: a group of lanes an element (spline_lanes.cuh) on the JAX public
// layout ([..., K] widths, [..., K-1] heights). A lane reads its V widths
// and interior heights (knots j V + 1 to j V + V) of the row and takes each
// exp and softplus once, as the TPU kernel does; the group finds the width
// softmax's maximum and sum by butterflies, the boundary height's
// numerator and the trapezoid area as group sums (a lane's lowest knot from
// the lane before), normalises the heights by 1 / area as the TPU kernel
// does, finds the CDF and location knots by scans (the last pinned to 1),
// the bin by a ballot of the interior knots and the selected bin's knots by
// shuffles from the lanes of bins sel and sel - 1. A warp takes up to 32
// elements in rounds, each lane keeping one element's bin, and then every
// lane evaluates the quadratic of its element's bin (quadratic_bin_eval,
// where quadratic_spline_eval ends too) and writes out and lad. Where K > 128 the warp walks the bins
// in chunks of 128, recomputing each chunk's exps and softplus in each of
// its passes and the chunk of the selected bin once more, and evaluates
// each element within its round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quadratic_spline.cuh"
#include "spline_lanes.cuh"

namespace {

using nflows::lanes::V;

// What a lane holds of its V bins: their widths and unnormalised knot
// heights, interior ones only (the boundary knots 0 and K are solved for).
struct QuadKnots {
  float w[V], lo[V], hi[V];
};

// ... and after normalisation: the upper location and CDF knots, the width
// and the two knot heights; and, the same in every lane, the location and
// CDF knots below the chunk's first bin.
struct QuadBins {
  float loc_hi[V], cdf_hi[V], w[V], h0[V], h1[V];
  float loc_lo0, cdf_lo0;
};

// The selected bin of an element: lower location and CDF knots, width, and
// the heights at both knots.
struct Selected {
  float loc, cdf, w, h0, h1;
};

// element i in its bin s (quadratic_bin_eval, as quadratic_spline_eval ends)
__device__ __forceinline__ void quadratic_bin(const float* __restrict__ x, int64_t i, float B,
                                              int inverse, const Selected& s,
                                              float* __restrict__ out,
                                              float* __restrict__ lad) {
  const float x_orig = __ldg(x + i);
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float xn = (fminf(fmaxf(x_orig, -B), B) + B) / (2.0f * B);
  nflows::quadratic_bin_eval(x_orig, inside, xn, s.loc, s.cdf, s.w, s.h0, s.h1, inverse != 0, B,
                             out + i, lad + i);
}

template <int G, bool CHUNKED>
__global__ void __launch_bounds__(nflows::lanes::kThreads) quadratic_spline_kernel(
    const float* __restrict__ x, const float* __restrict__ uw,
    const float* __restrict__ uh, float* __restrict__ out,
    float* __restrict__ lad, int64_t n, int inverse,
    nflows::QuadraticConfig cfg, int rounds) {
  const nflows::lanes::Group<G> g;
  const nflows::lanes::Rounds<G> warp(rounds);
  const bool vec = nflows::lanes::rows_of_float4(uw, cfg.num_bins);
  const int64_t e0 = warp.first();
  const int K = cfg.num_bins;
  const int chunks = CHUNKED ? (K + g.kBins - 1) / g.kBins : 1;
  const float B = cfg.tail_bound;
  const float wmix = 1.0f - cfg.min_bin_width * K;

  Selected m{};  // this lane's element's bin
  for (int r = 0; r < rounds; ++r) {
    const int64_t i = e0 + warp.element(r);
    const bool valid = i < n;
    const int64_t row = valid ? i : 0;  // a group past the last element reads row 0
    const float xn = (fminf(fmaxf(x[row], -B), B) + B) / (2.0f * B);

    // a chunk's unnormalised widths (-inf past the last bin)
    auto raw = [&](int c, float (&a)[V]) {
      nflows::lanes::load_bins(uw + row * K, K, g.bin(c, 0), vec, -INFINITY, a);
    };
    // interior knot height b + 1 (reference quadratic.py: softplus + 1e-3)
    auto interior = [&](int b) {
      return b < K - 1 ? nflows::softplus(__ldg(uh + row * (K - 1) + b)) + 1e-3f : 0.0f;
    };

    // width softmax; one chunk: the row's values, exps and interior
    // heights stay in registers, its loads all issued at once
    float w[V], ew[V], he[V];
    float wmax = -INFINITY;
    for (int c = 0; c < chunks; ++c) {
      raw(c, w);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (!CHUNKED) he[v] = interior(g.bin(c, v));
        wmax = fmaxf(wmax, w[v]);
      }
    }
    wmax = g.max(wmax);
    float wsum = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      if (CHUNKED) raw(c, w);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        ew[v] = expf(w[v] - wmax);
        wsum = wsum + ew[v];
      }
    }
    const float winv = 1.0f / g.sum(wsum);

    auto knots = [&](int c) {
      QuadKnots k;
      if (CHUNKED) raw(c, w);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int b = g.bin(c, v);
        const float e = CHUNKED ? expf(w[v] - wmax) : ew[v];
        k.w[v] = b < K ? cfg.min_bin_width + (wmix * e) * winv : 0.0f;
        k.hi[v] = CHUNKED ? interior(b) : he[v];
      }
      const float below = g.up(k.hi[V - 1]);
      k.lo[0] = g.j > 0 ? below : c == 0 ? 0.0f : interior(c * g.kBins - 1);
#pragma unroll
      for (int v = 1; v < V; ++v) k.lo[v] = k.hi[v - 1];
      return k;
    };
    QuadKnots k0{};
    if (!CHUNKED) k0 = knots(0);
    auto knots_of = [&](int c) { return CHUNKED ? knots(c) : k0; };

    // boundary heights (reference quadratic.py:88-104)
    float inner = 0.0f, first_w = 0.0f, first_h = 0.0f, last_w = 0.0f, last_h = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      const QuadKnots k = knots_of(c);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int b = g.bin(c, v);
        if (b >= 1 && b <= K - 2) inner = inner + ((k.lo[v] + k.hi[v]) / 2.0f) * k.w[v];
      }
      if (c == 0) {
        first_w = 0.5f * g.at(k.w[0], 0);
        first_h = g.at(k.hi[0], 0);
      }
      if (c == (K - 1) / g.kBins) last_w = 0.5f * g.at_bin(k.w, (K - 1) % g.kBins);
      if (c == (K - 2) / g.kBins) last_h = g.at_bin(k.hi, (K - 2) % g.kBins);
    }
    inner = g.sum(inner);
    const float numerator = 0.5f * first_w * first_h + 0.5f * last_w * last_h + inner;
    const float edge = numerator / (1.0f - 0.5f * first_w - 0.5f * last_w);

    // trapezoid area
    float area = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      const QuadKnots k = knots_of(c);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int b = g.bin(c, v);
        if (b < K) {
          const float lo = b == 0 ? edge : k.lo[v], hi = b == K - 1 ? edge : k.hi[v];
          area = area + ((lo + hi) / 2.0f) * k.w[v];
        }
      }
    }
    // the TPU kernel's normalisation: (1 - min) h / area as (1 - min) h * (1 / area)
    const float inv_area = 1.0f / g.sum(area);
    auto height = [&](float unnorm) {
      return cfg.min_bin_height + (1.0f - cfg.min_bin_height) * unnorm * inv_area;
    };

    // chunk c's knots, after the running sums of the chunks before it
    float run_cdf = 0.0f, run_loc = 0.0f;
    auto bins = [&](int c) {
      const QuadKnots k = knots_of(c);
      QuadBins q;
      float mass[V], cdf[V], loc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int b = g.bin(c, v);
        q.w[v] = k.w[v];
        q.h0[v] = height(b == 0 ? edge : k.lo[v]);
        q.h1[v] = height(b == K - 1 ? edge : k.hi[v]);
        mass[v] = b < K ? ((q.h0[v] + q.h1[v]) / 2.0f) * k.w[v] : 0.0f;
      }
      g.template running<CHUNKED>(mass, run_cdf, cdf);
      g.template running<CHUNKED>(k.w, run_loc, loc);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int b = g.bin(c, v);
        q.cdf_hi[v] = b == K - 1 ? 1.0f : cdf[v];
        q.loc_hi[v] = b == K - 1 ? 1.0f : loc[v];
      }
      q.cdf_lo0 = run_cdf;
      q.loc_lo0 = run_loc;
      if (CHUNKED) {
        run_cdf = g.at(cdf[V - 1], G - 1);
        run_loc = g.at(loc[V - 1], G - 1);
      }
      return q;
    };

    // the bin: how many of the interior knots 1..K-1 (the upper knots of
    // bins 0..K-2) lie at or below x
    int sel = 0;
    QuadBins q{};
    for (int c = 0; c < chunks; ++c) {
      q = bins(c);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sel += g.count(g.bin(c, v) < K - 1 && xn >= (inverse ? q.cdf_hi[v] : q.loc_hi[v]));
      }
    }
    if (CHUNKED) {
      run_cdf = run_loc = 0.0f;
      for (int c = 0; c <= sel / g.kBins; ++c) q = bins(c);
    }
    const nflows::lanes::Gather<G> take(warp, sel);
    const Selected s{take.below(q.loc_hi, q.loc_lo0), take.below(q.cdf_hi, q.cdf_lo0),
                     take.at(q.w), take.at(q.h0), take.at(q.h1)};
    if (warp.keeps(r)) {
      // one element a round where the bins come in chunks: evaluated now
      if (CHUNKED && valid) quadratic_bin(x, i, B, inverse, s, out, lad);
      m = s;
    }
  }

  // this lane's element
  const int64_t i = e0 + warp.lane;
  if (!CHUNKED && warp.holds() && i < n) quadratic_bin(x, i, B, inverse, m, out, lad);
}

}  // namespace

extern "C" int quadratic_spline_launch(const float* x, const float* uw,
                                       const float* uh, float* out, float* lad,
                                       int64_t n, int num_bins, int inverse,
                                       float tail_bound, float min_bin_width,
                                       float min_bin_height, void* stream) {
  if (n == 0) return 0;
  nflows::QuadraticConfig cfg{num_bins, tail_bound, min_bin_width, min_bin_height};
  return nflows::lanes::launch_groups(
      n, num_bins, [&](auto G, auto chunked, unsigned grid, int rounds) {
        quadratic_spline_kernel<decltype(G)::value, decltype(chunked)::value>
            <<<grid, nflows::lanes::kThreads, 0, (cudaStream_t)stream>>>(
                x, uw, uh, out, lad, n, inverse, cfg, rounds);
      });
}
