// B1: elementwise linear-tail rational-quadratic spline, forward or inverse,
// with the per-element logabsdet.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/rq_spline.py:_kernel.
//
// Bound on the H100: memory. Each element reads x and 3K-1 parameters and
// writes two values (about 104 bytes at K = 8) for a few hundred
// floating-point operations, well below the card's ratio of operations to
// bytes. At the serving shape (4,096 x 3 elements a coupling) the launch
// itself is the cost.
//
// Design: a group of lanes an element (spline_lanes.cuh), in the JAX
// public layout ([..., K] parameter rows, K-1 interior derivatives), so the
// coupling hands over its parameter tensors without a transpose. A lane
// reads its V widths, heights and derivatives of the row (a warp reads
// neighbouring rows, contiguous bytes) and takes each exp and softplus
// once; the group finds the softmax maxima and sums by butterflies, the
// cumulative edges by a scan (the last pinned to B), the bin by a ballot of
// the interior edges, and the selected bin's edges and slopes by shuffles
// from the lanes of bins sel and sel - 1. A warp takes up to 32 elements in
// rounds, each lane keeping one element's bin, and then every lane
// evaluates the RQ spline of its element's bin (rq_bin_eval, where
// rq_spline_eval ends too) and writes out and lad. The boundary derivative is
// passed in (min_derivative + softplus(pad constant), computed by the
// wrapper), so no padded derivative tensor is built. Where K > 128 the warp
// walks the bins in chunks of 128, carrying the running sums, computes the
// chunk of the selected bin once more, and evaluates each element within
// its round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rq_spline.cuh"
#include "spline_lanes.cuh"

namespace {

using nflows::lanes::V;

// What a lane holds of its V bins: the upper edges of the widths and the
// heights and the derivative at the upper knot; and, the same in every
// lane, those of the knot below the chunk's first bin.
struct RQBins {
  float w_hi[V], h_hi[V], d_hi[V];
  float w_lo0, h_lo0, d_lo0;
};

// The selected bin of an element: lower and upper edges of the widths and
// the heights, derivatives at both knots.
struct Selected {
  float cw, ch, ew, eh, d0, d1;
};

// element i in its bin s (rq_bin_eval, as rq_spline_eval ends)
__device__ __forceinline__ void rq_bin(const float* __restrict__ x, int64_t i, float B,
                                       int inverse, const Selected& s,
                                       float* __restrict__ out, float* __restrict__ lad) {
  const float x_orig = __ldg(x + i);
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float xc = fminf(fmaxf(x_orig, -B), B);
  nflows::rq_bin_eval(x_orig, inside, xc, s.cw, s.ch, s.ew - s.cw, s.eh - s.ch, s.d0, s.d1,
                      inverse != 0, out + i, lad + i);
}

template <int G, bool CHUNKED>
__global__ void __launch_bounds__(nflows::lanes::kThreads) rq_spline_kernel(
    const float* __restrict__ x, const float* __restrict__ uw,
    const float* __restrict__ uh, const float* __restrict__ ud,
    float* __restrict__ out, float* __restrict__ lad, int64_t n, int inverse,
    nflows::RQConfig cfg, int rounds) {
  const nflows::lanes::Group<G> g;
  const nflows::lanes::Rounds<G> warp(rounds);
  const bool vec = nflows::lanes::rows_of_float4(uw, cfg.num_bins) &&
                   nflows::lanes::rows_of_float4(uh, cfg.num_bins);
  const int64_t e0 = warp.first();
  const int K = cfg.num_bins;
  const int chunks = CHUNKED ? (K + g.kBins - 1) / g.kBins : 1;
  const float B = cfg.tail_bound;
  const float two_b = 2.0f * B;
  const float wmix = 1.0f - cfg.min_bin_width * K;
  const float hmix = 1.0f - cfg.min_bin_height * K;

  Selected m{};  // this lane's element's bin
  for (int r = 0; r < rounds; ++r) {
    const int64_t i = e0 + warp.element(r);
    const bool valid = i < n;
    const int64_t row = valid ? i : 0;  // a group past the last element reads row 0
    const float xc = fminf(fmaxf(x[row], -B), B);

    // a chunk's unnormalised widths or heights (-inf past the last bin:
    // out of the maxima, 0 after the exp)
    auto raw = [&](const float* u, int c, float (&a)[V]) {
      nflows::lanes::load_bins(u + row * K, K, g.bin(c, 0), vec, -INFINITY, a);
    };
    // the derivative at knot b + 1, the upper knot of bin b
    auto deriv = [&](int b) {
      return b < K - 1 ? cfg.min_derivative + nflows::softplus(__ldg(ud + row * (K - 1) + b))
                       : cfg.edge_derivative;
    };

    // softmax maxima and sums; one chunk: the row's values, exps and
    // derivatives stay in registers, its loads all issued at once
    float w[V], h[V], d[V], ew[V], eh[V];
    float wmax = -INFINITY, hmax = -INFINITY;
    for (int c = 0; c < chunks; ++c) {
      raw(uw, c, w);
      raw(uh, c, h);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (!CHUNKED) d[v] = deriv(g.bin(c, v));
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

    // chunk c's upper edges and derivatives, after the running sums of the
    // chunks before it
    float run_w = 0.0f, run_h = 0.0f;
    auto bins = [&](int c) {
      float wb[V], hb[V], cw[V], ch[V];
      if (CHUNKED) {
        raw(uw, c, w);
        raw(uh, c, h);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int b = g.bin(c, v);
        const float e_w = CHUNKED ? expf(w[v] - wmax) : ew[v];
        const float e_h = CHUNKED ? expf(h[v] - hmax) : eh[v];
        wb[v] = b < K ? cfg.min_bin_width + (wmix * e_w) * winv : 0.0f;
        hb[v] = b < K ? cfg.min_bin_height + (hmix * e_h) * hinv : 0.0f;
      }
      g.template running<CHUNKED>(wb, run_w, cw);
      g.template running<CHUNKED>(hb, run_h, ch);
      RQBins q;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int b = g.bin(c, v);
        q.w_hi[v] = (b == K - 1) ? B : two_b * cw[v] - B;
        q.h_hi[v] = (b == K - 1) ? B : two_b * ch[v] - B;
        q.d_hi[v] = CHUNKED ? deriv(b) : d[v];
      }
      q.w_lo0 = c == 0 ? -B : two_b * run_w - B;
      q.h_lo0 = c == 0 ? -B : two_b * run_h - B;
      q.d_lo0 = c == 0 ? cfg.edge_derivative : deriv(c * g.kBins - 1);
      if (CHUNKED) {
        run_w = g.at(cw[V - 1], G - 1);
        run_h = g.at(ch[V - 1], G - 1);
      }
      return q;
    };

    // the bin: how many of the interior edges 1..K-1 (the upper edges of
    // bins 0..K-2) lie at or below x
    int sel = 0;
    RQBins q{};
    for (int c = 0; c < chunks; ++c) {
      q = bins(c);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sel += g.count(g.bin(c, v) < K - 1 && xc >= (inverse ? q.h_hi[v] : q.w_hi[v]));
      }
    }
    if (CHUNKED) {
      run_w = run_h = 0.0f;
      for (int c = 0; c <= sel / g.kBins; ++c) q = bins(c);
    }
    const nflows::lanes::Gather<G> take(warp, sel);
    const Selected s{take.below(q.w_hi, q.w_lo0), take.below(q.h_hi, q.h_lo0),
                     take.at(q.w_hi),           take.at(q.h_hi),
                     take.below(q.d_hi, q.d_lo0), take.at(q.d_hi)};
    if (warp.keeps(r)) {
      // one element a round where the bins come in chunks: evaluated now
      if (CHUNKED && valid) rq_bin(x, i, B, inverse, s, out, lad);
      m = s;
    }
  }

  // this lane's element
  const int64_t i = e0 + warp.lane;
  if (!CHUNKED && warp.holds() && i < n) rq_bin(x, i, B, inverse, m, out, lad);
}

}  // namespace

extern "C" int rq_spline_launch(const float* x, const float* uw,
                                const float* uh, const float* ud, float* out,
                                float* lad, int64_t n, int num_bins,
                                int inverse, float tail_bound,
                                float min_bin_width, float min_bin_height,
                                float min_derivative, float edge_derivative,
                                void* stream) {
  if (n == 0) return 0;
  nflows::RQConfig cfg{num_bins, tail_bound, min_bin_width, min_bin_height,
                       min_derivative, edge_derivative};
  return nflows::lanes::launch_groups(
      n, num_bins, [&](auto G, auto chunked, unsigned grid, int rounds) {
        rq_spline_kernel<decltype(G)::value, decltype(chunked)::value>
            <<<grid, nflows::lanes::kThreads, 0, (cudaStream_t)stream>>>(
                x, uw, uh, ud, out, lad, n, inverse, cfg, rounds);
      });
}
