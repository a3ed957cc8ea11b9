// B8: elementwise linear-tail monotone cubic spline, forward or inverse,
// with the per-element logabsdet.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/cubic_spline.py:_kernel.
//
// Bound on the H100: memory. Each element reads x and 2K+2 parameters and
// writes two values (84 bytes at K = 8); the forward does about a hundred
// floating-point operations, the inverse adds 30 bisection halvings of
// about eight, still below the card's ratio of operations to bytes. At the
// serving shape (4,096 x 3 elements a coupling) the launch itself is the
// cost, and at a million elements the accurate exps and divisions an
// element issues.
//
// Design: a group of lanes an element (spline_lanes.cuh), as B1
// (rq_spline.cu), on the JAX public layout ([..., K] widths and heights,
// [..., 1] boundary parameters). A lane reads its V widths and heights of
// the row (neighbouring lanes at neighbouring addresses) and takes each exp
// once; the group finds the softmax maxima and sums by butterflies, the
// knots in [0, 1] by scans (the last pinned to 1; those the bin search and
// the logabsdet read compensated, within about an ulp of the exact running
// sums: the logabsdet of a steep cubic moves by up to 1e4 times a knot's
// error), the bin by a ballot of
// the interior knots against the normalised x, and by shuffles the
// selected bin's knots and the sizes of bins sel - 1, sel and sel + 1, from
// their lanes (Gather::below, at, above). A warp takes up to 32 elements in
// rounds, each lane keeping one element's bin, and then every lane takes
// its element's three slopes, two knot derivatives (Steffen's, or 3
// sigmoid(dl or dr) times the end bin's slope at the ends, the boundary
// parameters read coalesced, lane L element L's) and the cubic's
// coefficients once, and evaluates the forward or the bisection inverse
// (cubic_bin_eval, where cubic_spline_eval ends too), all 32 lanes on
// distinct elements. Where K > 128 the warp walks the bins in chunks of 128,
// carrying the running sums, computes the chunk of the selected bin once
// more, reads the sizes of the bins either side of that chunk from the row,
// and evaluates each element within its round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cubic_spline.cuh"
#include "spline_lanes.cuh"

namespace {

using nflows::lanes::V;

// What a lane holds of its V bins: the upper width and height knots, the
// bin sizes; and, the same in every lane, the knots below the chunk's
// first bin.
struct CubicBins {
  float cw_hi[V], ch_hi[V], wb[V], hb[V];
  float cw_lo0, ch_lo0;
};

// The selected bin of an element: its index, its width knots, its lower
// height knot, and the widths and heights of bins sel - 1, sel and sel + 1
// (those past either end unused).
struct Selected {
  int bin;
  float left_w, right_w, sel_ch, wp, ws, wn, hp, hs, hn;
};

// element i in its bin s: the slopes, knot derivatives and coefficients,
// then cubic_bin_eval, as cubic_spline_eval ends
__device__ __forceinline__ void cubic_bin(const float* __restrict__ x,
                                          const float* __restrict__ dl,
                                          const float* __restrict__ dr, int64_t i, int inverse,
                                          const nflows::CubicConfig& cfg, const Selected& s,
                                          float* __restrict__ out, float* __restrict__ lad) {
  const int K = cfg.num_bins;
  const float B = cfg.tail_bound;
  const float x_orig = __ldg(x + i);
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float xn = (fminf(fmaxf(x_orig, -B), B) + B) / (2.0f * B);
  const float ss = s.hs / s.ws;
  const float d0 = s.bin == 0 ? nflows::sigmoid(__ldg(dl + i)) * 3.0f * ss
                              : nflows::steffen_derivative(s.hp / s.wp, ss, s.wp, s.ws);
  const float d1 = s.bin == K - 1 ? nflows::sigmoid(__ldg(dr + i)) * 3.0f * ss
                                  : nflows::steffen_derivative(ss, s.hn / s.wn, s.ws, s.wn);
  const float a = (d0 + d1 - 2.0f * ss) / (s.ws * s.ws);
  const float b = (3.0f * ss - 2.0f * d0 - d1) / s.ws;
  nflows::cubic_bin_eval(x_orig, inside, xn, a, b, d0, s.sel_ch, s.left_w, s.right_w,
                         inverse != 0, B, out + i, lad + i);
}

template <int G, bool CHUNKED>
__global__ void __launch_bounds__(nflows::lanes::kThreads) cubic_spline_kernel(
    const float* __restrict__ x, const float* __restrict__ uw,
    const float* __restrict__ uh, const float* __restrict__ dl,
    const float* __restrict__ dr, float* __restrict__ out,
    float* __restrict__ lad, int64_t n, int inverse, nflows::CubicConfig cfg, int rounds) {
  const nflows::lanes::Group<G> g;
  const nflows::lanes::Rounds<G> warp(rounds);
  const bool vec = nflows::lanes::rows_of_float4(uw, cfg.num_bins) &&
                   nflows::lanes::rows_of_float4(uh, cfg.num_bins);
  const int64_t e0 = warp.first();
  const int K = cfg.num_bins;
  const int chunks = CHUNKED ? (K + g.kBins - 1) / g.kBins : 1;
  const float B = cfg.tail_bound;
  const float wmix = 1.0f - cfg.min_bin_width * K;
  const float hmix = 1.0f - cfg.min_bin_height * K;

  Selected m{};  // this lane's element's bin
  for (int r = 0; r < rounds; ++r) {
    const int64_t i = e0 + warp.element(r);
    const bool valid = i < n;
    const int64_t row = valid ? i : 0;  // a group past the last element reads row 0
    const float xn = (fminf(fmaxf(x[row], -B), B) + B) / (2.0f * B);

    // a chunk's unnormalised widths or heights (-inf past the last bin:
    // out of the maxima, 0 after the exp)
    auto raw = [&](const float* u, int c, float (&a)[V]) {
      nflows::lanes::load_bins(u + row * K, K, g.bin(c, 0), vec, -INFINITY, a);
    };

    // softmax maxima and sums; one chunk: the row's values and exps stay
    // in registers, its loads all issued at once
    float w[V], h[V], ew[V], eh[V];
    float wmax = -INFINITY, hmax = -INFINITY;
    for (int c = 0; c < chunks; ++c) {
      raw(uw, c, w);
      raw(uh, c, h);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        wmax = fmaxf(wmax, w[v]);
        hmax = fmaxf(hmax, h[v]);
      }
    }
    wmax = g.max(wmax);
    hmax = g.max(hmax);
    float wsum = 0.0f, hsum = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      if (CHUNKED) {
        raw(uw, c, w);
        raw(uh, c, h);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        ew[v] = expf(w[v] - wmax);
        eh[v] = expf(h[v] - hmax);
        wsum = wsum + ew[v];
        hsum = hsum + eh[v];
      }
    }
    const float winv = 1.0f / g.sum(wsum), hinv = 1.0f / g.sum(hsum);
    auto width = [&](float e) { return cfg.min_bin_width + (wmix * e) * winv; };
    auto height = [&](float e) { return cfg.min_bin_height + (hmix * e) * hinv; };

    // chunk c's bin sizes and upper knots, after the running sums of the
    // chunks before it
    float run_w = 0.0f, run_h = 0.0f;
    auto bins = [&](int c) {
      CubicBins q;
      float cw[V], ch[V];
      if (CHUNKED) {
        raw(uw, c, w);
        raw(uh, c, h);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int b = g.bin(c, v);
        q.wb[v] = b < K ? width(CHUNKED ? expf(w[v] - wmax) : ew[v]) : 0.0f;
        q.hb[v] = b < K ? height(CHUNKED ? expf(h[v] - hmax) : eh[v]) : 0.0f;
      }
      // compensated where the bin search and the logabsdet read the knots:
      // the widths' forward, the heights' inverse (the other axis's knot
      // only adds to the output)
      if (inverse) {
        g.template running<CHUNKED>(q.wb, run_w, cw);
        g.template running_compensated<CHUNKED>(q.hb, run_h, ch);
      } else {
        g.template running_compensated<CHUNKED>(q.wb, run_w, cw);
        g.template running<CHUNKED>(q.hb, run_h, ch);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int b = g.bin(c, v);
        q.cw_hi[v] = (b == K - 1) ? 1.0f : cw[v];
        q.ch_hi[v] = (b == K - 1) ? 1.0f : ch[v];
      }
      q.cw_lo0 = run_w;
      q.ch_lo0 = run_h;
      if (CHUNKED) {
        run_w = g.at(cw[V - 1], G - 1);
        run_h = g.at(ch[V - 1], G - 1);
      }
      return q;
    };

    // the bin: how many of the interior knots 1..K-1 (the upper knots of
    // bins 0..K-2) lie at or below x
    int sel = 0;
    CubicBins q{};
    for (int c = 0; c < chunks; ++c) {
      q = bins(c);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sel += g.count(g.bin(c, v) < K - 1 && xn >= (inverse ? q.ch_hi[v] : q.cw_hi[v]));
      }
    }
    // the sizes of the bins below and above the selected bin's chunk (read
    // where the bins come in chunks; else unused: bin 0 and bin K - 1 take
    // the boundary derivatives)
    float w_lo0 = 0.0f, h_lo0 = 0.0f, w_hi0 = 0.0f, h_hi0 = 0.0f;
    if (CHUNKED) {
      run_w = run_h = 0.0f;
      const int c_sel = sel / g.kBins;
      for (int c = 0; c <= c_sel; ++c) q = bins(c);
      const int below = c_sel * g.kBins - 1, above = below + g.kBins + 1;
      if (below >= 0) {
        w_lo0 = width(expf(__ldg(uw + row * K + below) - wmax));
        h_lo0 = height(expf(__ldg(uh + row * K + below) - hmax));
      }
      if (above < K) {
        w_hi0 = width(expf(__ldg(uw + row * K + above) - wmax));
        h_hi0 = height(expf(__ldg(uh + row * K + above) - hmax));
      }
    }
    const nflows::lanes::Gather<G> take(warp, sel);
    const Selected s{take.bin,
                     take.below(q.cw_hi, q.cw_lo0), take.at(q.cw_hi),
                     take.below(q.ch_hi, q.ch_lo0),
                     take.below(q.wb, w_lo0), take.at(q.wb), take.above(q.wb, w_hi0),
                     take.below(q.hb, h_lo0), take.at(q.hb), take.above(q.hb, h_hi0)};
    if (warp.keeps(r)) {
      // one element a round where the bins come in chunks: evaluated now
      if (CHUNKED && valid) cubic_bin(x, dl, dr, i, inverse, cfg, s, out, lad);
      m = s;
    }
  }

  // this lane's element
  const int64_t i = e0 + warp.lane;
  if (!CHUNKED && warp.holds() && i < n) cubic_bin(x, dl, dr, i, inverse, cfg, m, out, lad);
}

}  // namespace

extern "C" int cubic_spline_launch(const float* x, const float* uw,
                                   const float* uh, const float* dl,
                                   const float* dr, float* out, float* lad,
                                   int64_t n, int num_bins, int inverse,
                                   float tail_bound, float min_bin_width,
                                   float min_bin_height, void* stream) {
  if (n == 0) return 0;
  nflows::CubicConfig cfg{num_bins, tail_bound, min_bin_width, min_bin_height};
  return nflows::lanes::launch_groups(
      n, num_bins, [&](auto G, auto chunked, unsigned grid, int rounds) {
        cubic_spline_kernel<decltype(G)::value, decltype(chunked)::value>
            <<<grid, nflows::lanes::kThreads, 0, (cudaStream_t)stream>>>(
                x, uw, uh, dl, dr, out, lad, n, inverse, cfg, rounds);
      });
}
