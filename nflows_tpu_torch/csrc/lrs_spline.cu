// B5: elementwise linear-tail linear-rational spline, forward or inverse,
// with the per-element logabsdet.
//
// Replaces the TPU kernel nflows_tpu/ops/pallas/lrs_spline.py:_kernel.
//
// Bound on the H100: memory. Each element reads x and 4K-1 parameters and
// writes two values (136 bytes at K = 8) for a few hundred floating-point
// operations, below the card's ratio of operations to bytes. At the
// serving shape (4,096 x 3 elements a coupling) the launch itself is the
// cost, and at a million elements the accurate exps, logs and divisions an
// element issues.
//
// Design: a group of lanes an element (spline_lanes.cuh), as B1
// (rq_spline.cu), in the JAX public layout ([..., K] widths, heights and
// lambdas, K-1 interior derivatives), so the coupling hands over its
// parameter tensors without a transpose, and the boundary derivative comes
// in as a value, so no padded tensor is built. A lane reads its V widths
// and heights of the row (neighbouring lanes at neighbouring addresses) and
// takes each exp once; the group finds the softmax maxima and sums by
// butterflies, the cumulative edges by a scan (the last pinned to B), the
// bin by a ballot of the interior edges, and the selected bin's edges by
// shuffles from the lanes of bins sel and sel - 1. A warp takes up to 32
// elements in rounds, each lane keeping one element's bin, and then every
// lane reads its element's two derivatives and lambda of that bin alone (2
// softplus and a sigmoid an element, not K - 1 and K) and evaluates the
// chosen Möbius piece (lrs_bin_eval), as lrs_spline_eval ends. Where
// K > 128 the warp walks the bins in chunks of 128, carrying the running
// sums, computes the chunk of the selected bin once more, and evaluates
// each element within its round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lrs_spline.cuh"
#include "spline_lanes.cuh"

namespace {

using nflows::lanes::V;

// What a lane holds of its V bins: the upper edges of the widths and the
// heights; and, the same in every lane, those below the chunk's first bin.
struct LRSBins {
  float w_hi[V], h_hi[V];
  float w_lo0, h_lo0;
};

// The selected bin of an element: its index, lower and upper edges of the
// widths and the heights.
struct Selected {
  int bin;
  float cw, ch, ew, eh;
};

// element i in its bin s: the bin's derivatives and lambda, then its
// Möbius pieces, as lrs_spline_eval ends
__device__ __forceinline__ void lrs_bin(const float* __restrict__ x, const float* __restrict__ ud,
                                        const float* __restrict__ ul, int64_t i, int inverse,
                                        const nflows::LRSConfig& cfg, const Selected& s,
                                        float* __restrict__ out, float* __restrict__ lad) {
  const int K = cfg.num_bins;
  const float B = cfg.tail_bound;
  const float x_orig = __ldg(x + i);
  const bool inside = (x_orig >= -B) && (x_orig <= B);
  const float xc = fminf(fmaxf(x_orig, -B), B);
  // as lrs_spline_eval takes them (kept apart: a shared helper moved B4's
  // register count)
  const float* d = ud + i * (K - 1);
  const float d0 = (s.bin == 0) ? cfg.edge_derivative
                                : cfg.min_derivative + nflows::softplus(__ldg(d + s.bin - 1));
  const float d1 = (s.bin == K - 1) ? cfg.edge_derivative
                                    : cfg.min_derivative + nflows::softplus(__ldg(d + s.bin));
  const float lam = cfg.min_lambda + (1.0f - 2.0f * cfg.min_lambda) *
                                         nflows::sigmoid(__ldg(ul + i * K + s.bin));
  nflows::lrs_bin_eval(x_orig, inside, xc, s.cw, s.ch, s.ew - s.cw, s.eh - s.ch, d0, d1, lam,
                       inverse != 0, out + i, lad + i);
}

template <int G, bool CHUNKED>
__global__ void __launch_bounds__(nflows::lanes::kThreads) lrs_spline_kernel(
    const float* __restrict__ x, const float* __restrict__ uw,
    const float* __restrict__ uh, const float* __restrict__ ud,
    const float* __restrict__ ul, float* __restrict__ out,
    float* __restrict__ lad, int64_t n, int inverse, nflows::LRSConfig cfg, int rounds) {
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

    // chunk c's upper edges, after the running sums of the chunks before it
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
      LRSBins q;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int b = g.bin(c, v);
        q.w_hi[v] = (b == K - 1) ? B : two_b * cw[v] - B;
        q.h_hi[v] = (b == K - 1) ? B : two_b * ch[v] - B;
      }
      q.w_lo0 = c == 0 ? -B : two_b * run_w - B;
      q.h_lo0 = c == 0 ? -B : two_b * run_h - B;
      if (CHUNKED) {
        run_w = g.at(cw[V - 1], G - 1);
        run_h = g.at(ch[V - 1], G - 1);
      }
      return q;
    };

    // the bin: how many of the interior edges 1..K-1 (the upper edges of
    // bins 0..K-2) lie at or below x
    int sel = 0;
    LRSBins q{};
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
    const Selected s{take.bin, take.below(q.w_hi, q.w_lo0), take.below(q.h_hi, q.h_lo0),
                     take.at(q.w_hi), take.at(q.h_hi)};
    if (warp.keeps(r)) {
      // one element a round where the bins come in chunks: evaluated now
      if (CHUNKED && valid) lrs_bin(x, ud, ul, i, inverse, cfg, s, out, lad);
      m = s;
    }
  }

  // this lane's element
  const int64_t i = e0 + warp.lane;
  if (!CHUNKED && warp.holds() && i < n) lrs_bin(x, ud, ul, i, inverse, cfg, m, out, lad);
}

}  // namespace

extern "C" int lrs_spline_launch(const float* x, const float* uw,
                                 const float* uh, const float* ud,
                                 const float* ul, float* out, float* lad,
                                 int64_t n, int num_bins, int inverse,
                                 float tail_bound, float min_bin_width,
                                 float min_bin_height, float min_derivative,
                                 float min_lambda, float edge_derivative,
                                 void* stream) {
  if (n == 0) return 0;
  nflows::LRSConfig cfg{num_bins, tail_bound, min_bin_width, min_bin_height,
                        min_derivative, min_lambda, edge_derivative};
  return nflows::lanes::launch_groups(
      n, num_bins, [&](auto G, auto chunked, unsigned grid, int rounds) {
        lrs_spline_kernel<decltype(G)::value, decltype(chunked)::value>
            <<<grid, nflows::lanes::kThreads, 0, (cudaStream_t)stream>>>(
                x, uw, uh, ud, ul, out, lad, n, inverse, cfg, rounds);
      });
}
