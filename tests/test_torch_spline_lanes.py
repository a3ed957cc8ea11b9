"""The order of sums of the group-of-lanes spline kernels B1
(``csrc/rq_spline.cu``) and B7 (``csrc/quadratic_spline.cu``), repeated on
the CPU, against the JAX Pallas kernels in interpret mode and the port's
plain versions (B5 and B8: ``tests/test_torch_spline_lanes_lrs_cubic.py``,
B6: ``tests/test_torch_spline_lanes_linear.py``, on this file's helpers).

The kernels give each element a group of G lanes (``csrc/spline_lanes.cuh``:
lane j holds the 4 bins 4 j to 4 j + 3, G is the power of two at least
K / 4, 2 to 32; past 128 bins the warp walks chunks of 128). This file
repeats their arithmetic in float32 torch, step for step in their order:
the softmax max and sum as lane-local values over a lane's bins and the
chunks, then butterflies (lane j adds lane j ^ 2^s); the running sums as
each lane's own running sum, a Hillis-Steele scan of the lanes' totals in
lane order (lane j adds lane j - 2^s) and the scan of the lanes before,
chunk by chunk after the running sum of the chunks before; the
bin as the count of lanes of bins 0..K-2 whose upper edge (an interior
edge) is at or below x; the selected bin's values gathered from its lane
and the lower ones from the lane of the bin before. CUDA C++ has no
interpret mode, so this is what the CPU can say of the kernels' order; the
card holds the kernels themselves (``chip_smoke.py`` phases 3 and 17,
``tests/test_torch_cuda.py``).

Tolerance: 1e-5 on outputs (a few fp32 ulps of values up to the tail bound
3: the sums are taken in another order than the plain version's
sequential ones, which moves an edge by an ulp or two), and the 1e-4
interop bar on the logabsdet; or, where fp32 rounding moves the references
themselves apart by more than that, as the repo's holds do
(``chip_smoke.hold``): no further from the float64 plain version than
twice the fp32 plain version is, and no further from each JAX evaluation
than twice the plain version is. At K = 40 the plain version and the JAX
XLA path already differ by more than the bar on the inverse's logabsdet,
and at N(0, 1) parameters by far more: steep bins amplify an ulp of an
edge. Inputs from numpy with
a seed: parameters 0.5 N(0, 1) (``SCALE``, as tests/test_torch_cuda.py
draws them; the card holds N(0, 1) parameters as its stress case), x at
+-B, outside [-B, B] and on a knot of the plain version.

The inputs on a knot are held against the plain version and the JAX
package's XLA path, not against the Pallas kernel in interpret mode: there
XLA recomputes an edge in each fusion that reads it, rounded differently,
so at an input within that rounding of a knot its selects disagree on the
bin. At K = 2, seed 2, x = -0.7962172 (a knot), the kernel in interpret
mode takes bin 1's width with bin 0's lower edges and returns -3.0, where
the XLA path and the plain version return 0.36409235 and an input one ulp
either side returns 0.3640921 or 0.36409244.
"""

import numpy as np
import pytest
import torch

from nflows_tpu.ops import splines as jax_splines
from nflows_tpu.ops.pallas.quadratic_spline import quadratic_spline_pallas
from nflows_tpu.ops.pallas.rq_spline import rq_spline_pallas
from nflows_tpu_torch.ops import binning
from nflows_tpu_torch.ops.cuda import rq_spline as b1
from nflows_tpu_torch.ops.splines import quadratic as q_ref
from nflows_tpu_torch.ops.splines import rational_quadratic as rq_ref

torch.set_num_threads(1)

B = 3.0
OUT_TOL = 1e-5
LAD_TOL = 1e-4
# each layout of the kernels (G = lanes_for(ceil(K / 4)) lanes of 4 bins):
# G = 2 at K = 2 to 8, G = 4 at 16, G = 8 at 24, G = 16 at 40, the whole warp
# at 100, and past 128 bins the whole warp walking chunks
BINS = [2, 3, 5, 8, 16, 24, 40, 100, 130]
# held against the Pallas kernels too (at K = 100 and 130 a case of those
# takes 15 and 25 s in interpret mode; the XLA path computes the same function)
PALLAS_BINS = {2, 3, 5, 8, 16, 24, 40}
SCALE = 0.5


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def lanes_for(k):
    """csrc/spline_lanes.cuh lanes_for: the power of two at least k, 2 to 32"""
    return 2 if k <= 2 else 4 if k <= 4 else 8 if k <= 8 else 16 if k <= 16 else 32


class Group:
    """The shuffles of ``nflows::lanes::Group`` on [..., G] tensors."""

    def __init__(self, G):
        self.G, self.j = G, torch.arange(G)

    def steps(self):
        o = 1
        while o < self.G:
            yield o
            o <<= 1

    def max(self, v):
        for o in self.steps():
            v = torch.maximum(v, v[..., self.j ^ o])
        return v

    def sum(self, v):
        for o in self.steps():
            v = v + v[..., self.j ^ o]
        return v

    def scan(self, v):
        for o in self.steps():
            t = v[..., (self.j - o).clamp_min(0)]
            v = torch.where(self.j >= o, v + t, v)
        return v


class Lanes:
    """An element's bins on its group, as the kernels lay them out: V = 4
    bins a lane, G lanes, C chunks; lane j of chunk c holds bins
    c G V + j V + v. Values are [N, C, G, V] tensors."""

    V = 4  # csrc/spline_lanes.cuh V

    def __init__(self, K):
        self.K = K
        self.G = lanes_for(-(-K // self.V))
        self.C = -(-K // (self.G * self.V))
        self.g = Group(self.G)
        self.b = torch.arange(self.C * self.G * self.V).reshape(self.C, self.G, self.V)

    def pad(self, u, fill):
        """[N, P] laid out as [N, C, G, V], ``fill`` past bin P - 1."""
        out = torch.full((u.shape[0], self.b.numel()), fill, dtype=torch.float32)
        out[:, :u.shape[1]] = u
        return out.reshape(-1, self.C, self.G, self.V)

    def lane_sums(self, v):
        """A lane's values summed in order over its chunks and bins, then
        the butterfly: [N, G]."""
        s = torch.zeros_like(v[:, 0, :, 0])
        for c in range(self.C):
            for t in range(self.V):
                s = s + v[:, c, :, t]
        return self.g.sum(s)

    def running(self, v):
        """Group.running, chunk by chunk after the last lane's sum of the
        chunk before."""
        run = torch.zeros_like(v[:, 0, :1, 0])
        j = self.g.j
        out = []
        for c in range(self.C):
            own = [v[:, c, :, 0]]
            for t in range(1, self.V):
                own.append(own[-1] + v[:, c, :, t])
            incl = self.g.scan(own[-1])
            before = torch.where(j == 0, 0.0, incl[:, (j - 1).clamp_min(0)])
            cum = [run + (before + o) for o in own[:-1]] + [run + incl]
            out.append(torch.stack(cum, -1))
            run = cum[-1][:, -1:]
        return torch.stack(out, 1)

    def bin(self, x, upper):
        """The ballot: the count of the bins b < K - 1 with x at or above
        their upper edge, [N, 1]."""
        b = self.b.reshape(-1)
        hit = (b < self.K - 1) & (x[:, None] >= upper.reshape(x.shape[0], -1))
        return hit.sum(-1, keepdim=True)

    def select(self, x, upper, *values):
        """The selected bin's values (the bin of :meth:`bin`)."""
        sel = self.bin(x, upper)
        return [torch.gather(v.reshape(x.shape[0], -1), 1, sel)[:, 0] for v in values]

    def below(self, hi, first):
        """A bin's lower knot: bin b - 1's upper one (``first`` at b = 0)."""
        flat = hi.reshape(hi.shape[0], -1)
        return torch.cat([torch.full_like(flat[:, :1], first), flat[:, :-1]], 1).reshape(hi.shape)

    def softmax(self, u, min_size):
        """min_size + (1 - K min_size) softmax, and 0 past the last bin."""
        v = self.pad(u, -np.inf)
        vmax = self.g.max(v.amax((1, 3)))[:, None, :, None]
        e = torch.exp(v - vmax)
        inv = (1.0 / self.lane_sums(e))[:, None, :, None]
        mix = 1.0 - _f32(min_size) * self.K
        return torch.where(self.b < self.K, _f32(min_size) + (mix * e) * inv, 0.0)


def softplus(v):
    """csrc/rq_spline.cuh softplus"""
    return v.clamp_min(0.0) + torch.log1p(torch.exp(-v.abs()))


def rq_lanes(x_orig, uw, uh, ud, inverse):
    """B1's arithmetic in its order (defaults of the wrapper's minima)."""
    K = uw.shape[-1]
    L = Lanes(K)
    min_d = rq_ref.DEFAULT_MIN_DERIVATIVE
    edge_d = _f32(b1._edge_derivative(min_d))
    inside = (x_orig >= -B) & (x_orig <= B)
    x = x_orig.clamp(-B, B)
    two_b = _f32(2.0 * B)
    w_hi = torch.where(L.b == K - 1, B,
                       two_b * L.running(L.softmax(uw, rq_ref.DEFAULT_MIN_BIN_WIDTH)) - B)
    h_hi = torch.where(L.b == K - 1, B,
                       two_b * L.running(L.softmax(uh, rq_ref.DEFAULT_MIN_BIN_HEIGHT)) - B)
    d_hi = torch.where(L.b < K - 1, _f32(min_d) + softplus(L.pad(ud, 0.0)), edge_d)
    w_lo, h_lo, d_lo = L.below(w_hi, -B), L.below(h_hi, -B), L.below(d_hi, float(edge_d))
    cw, ch, hw, hh, d0, d1 = L.select(x, h_hi if inverse else w_hi,
                                      w_lo, h_lo, w_hi, h_hi, d_lo, d_hi)
    xw, xh = hw - cw, hh - ch
    delta = xh / xw
    d_sum = d0 + d1 - 2.0 * delta
    if inverse:
        y_rel = x - ch
        a = y_rel * d_sum + xh * (delta - d0)
        b = xh * d0 - y_rel * d_sum
        c = -delta * y_rel
        disc = (b * b - 4.0 * a * c).clamp_min(0.0)
        theta = (2.0 * c) / (-b - torch.sqrt(disc))
        y = theta * xw + cw
    else:
        theta = (x - cw) / xw
        num = xh * (delta * theta * theta + d0 * theta * (1.0 - theta))
        den = delta + d_sum * theta * (1.0 - theta)
        y = ch + num / den
    tomt = theta * (1.0 - theta)
    denominator = delta + d_sum * tomt
    deriv_num = delta * delta * (d1 * theta * theta + 2.0 * delta * tomt
                                 + d0 * (1.0 - theta) * (1.0 - theta))
    lad = torch.log(deriv_num) - 2.0 * torch.log(denominator)
    if inverse:
        lad = -lad
    return torch.where(inside, y, x_orig), torch.where(inside, lad, 0.0)


def quadratic_lanes(x_orig, uw, uh, inverse):
    """B7's arithmetic in its order (defaults of the wrapper's minima)."""
    K = uw.shape[-1]
    L = Lanes(K)
    b = L.b
    min_h = _f32(q_ref.DEFAULT_MIN_BIN_HEIGHT)
    inside = (x_orig >= -B) & (x_orig <= B)
    x = (x_orig.clamp(-B, B) + B) / _f32(2.0 * B)
    w = L.softmax(uw, q_ref.DEFAULT_MIN_BIN_WIDTH)
    hi = torch.where(b < K - 1, softplus(L.pad(uh, 0.0)) + _f32(1e-3), 0.0)
    lo = L.below(hi, 0.0)
    flat_w, flat_hi = w.reshape(w.shape[0], -1), hi.reshape(hi.shape[0], -1)
    # boundary heights: group sums of lane-local sums
    inner = L.lane_sums(torch.where((b >= 1) & (b <= K - 2), ((lo + hi) / 2.0) * w, 0.0))[:, 0]
    first_w, first_h = 0.5 * flat_w[:, 0], flat_hi[:, 0]
    last_w, last_h = 0.5 * flat_w[:, K - 1], flat_hi[:, K - 2]
    numerator = 0.5 * first_w * first_h + 0.5 * last_w * last_h + inner
    edge = (numerator / (1.0 - 0.5 * first_w - 0.5 * last_w))[:, None, None, None]
    knot_lo = torch.where(b == 0, edge, lo)
    knot_hi = torch.where(b == K - 1, edge, hi)
    area = L.lane_sums(torch.where(b < K, ((knot_lo + knot_hi) / 2.0) * w, 0.0))[:, 0]
    inv_area = (1.0 / area)[:, None, None, None]
    h0 = min_h + (1.0 - min_h) * knot_lo * inv_area
    h1 = min_h + (1.0 - min_h) * knot_hi * inv_area
    cdf = L.running(torch.where(b < K, ((h0 + h1) / 2.0) * w, 0.0))
    loc = L.running(w)
    cdf_hi = torch.where(b == K - 1, 1.0, cdf)
    loc_hi = torch.where(b == K - 1, 1.0, loc)
    cdf_lo, loc_lo = L.below(cdf_hi, 0.0), L.below(loc_hi, 0.0)
    s_loc, s_w, s_cdf, s_h0, s_h1 = L.select(x, cdf_hi if inverse else loc_hi,
                                             loc_lo, w, cdf_lo, h0, h1)
    a = 0.5 * (s_h1 - s_h0) * s_w
    bb = s_h0 * s_w
    if inverse:
        c_ = s_cdf - x
        disc = (bb * bb - 4.0 * a * c_).clamp_min(0.0)
        alpha = (-2.0 * c_) / (bb + torch.sqrt(disc))
        out01 = (alpha * s_w + s_loc).clamp(0.0, 1.0)
        lad = -torch.log(alpha * (s_h1 - s_h0) + s_h0)
    else:
        alpha = (x - s_loc) / s_w
        out01 = (a * alpha * alpha + bb * alpha + s_cdf).clamp(0.0, 1.0)
        lad = torch.log(alpha * (s_h1 - s_h0) + s_h0)
    return (torch.where(inside, out01 * _f32(2.0 * B) - B, x_orig),
            torch.where(inside, lad, 0.0))


def _inputs(widths, seed, n=257):
    rng = np.random.default_rng(seed)
    x = (2.5 * rng.standard_normal(n)).astype(np.float32)
    x[:4] = [B, -B, B + 0.5, -B - 0.5]
    return [x] + [(SCALE * rng.standard_normal((n, p))).astype(np.float32) for p in widths]


KNOTS = np.arange(4, 36)  # the inputs set on a knot


def _on_knots(x, knots):
    """x[KNOTS] set on interior knots of the plain version (float32)."""
    K = knots.shape[-1] - 1
    x[KNOTS] = knots[KNOTS, 1 + KNOTS % (K - 1)]
    return x


def _max(a, b, rows=slice(None)):
    return float(np.abs(np.asarray(a, np.float64)[rows] - np.asarray(b, np.float64)[rows]).max())


def _hold(got, plain, plain64, xla, pallas, x):
    """(out, lad) of the emulation against the plain version (or float64),
    the XLA path, and the Pallas kernel (where given) off the knots (see the
    module doc)."""
    off = np.ones(x.shape, bool)
    off[KNOTS] = False
    for i, tol in enumerate((OUT_TOL, LAD_TOL)):
        a, p = got[i], plain[i]
        gap, err, err_plain = _max(a, p), _max(a, plain64[i]), _max(p, plain64[i])
        assert gap <= tol or err <= 2.0 * err_plain, (i, gap, err, err_plain)
        refs = [(xla[i], slice(None))] + ([(pallas[i], off)] if pallas is not None else [])
        for ref, rows in refs:
            gap, base = _max(a, ref, rows), _max(p, ref, rows)
            assert gap <= tol or gap <= 2.0 * base, (i, gap, base)
    outside = np.abs(x) > B
    assert outside.any()
    np.testing.assert_array_equal(got[0].numpy()[outside], x[outside])
    np.testing.assert_array_equal(got[1].numpy()[outside], 0.0)


@pytest.mark.parametrize("K", BINS)
@pytest.mark.parametrize("inverse", [False, True])
def test_rq_group_order_matches_pallas_and_plain(K, inverse):
    x, w, h, d = _inputs((K, K, K - 1), seed=K)
    sizes = h if inverse else w
    _, knots = binning.edges_on(torch.from_numpy(sizes), K, 1e-3, -B, B)
    x = _on_knots(x, knots.numpy())
    t = [torch.from_numpy(a) for a in (x, w, h, d)]
    _hold(rq_lanes(*t, inverse),
          rq_ref.unconstrained_rational_quadratic_spline_plain(*t, inverse=inverse,
                                                               tail_bound=B),
          rq_ref.unconstrained_rational_quadratic_spline_plain(
              *[a.double() for a in t], inverse=inverse, tail_bound=B),
          jax_splines.unconstrained_rational_quadratic_spline(
              x, w, h, d, inverse=inverse, tails="linear", tail_bound=B),
          rq_spline_pallas(x, w, h, d, inverse=inverse, tail_bound=B, interpret=True)
          if K in PALLAS_BINS else None, x)


@pytest.mark.parametrize("K", BINS)
@pytest.mark.parametrize("inverse", [False, True])
def test_quadratic_group_order_matches_pallas_and_plain(K, inverse):
    x, w, h = _inputs((K, K - 1), seed=100 + K)
    t = [torch.from_numpy(a) for a in (x, w, h)]
    if inverse:
        # the plain version's CDF knots: its outputs at its location knots
        locs = binning.unit_knots(binning.normalize_bins(t[1], K, 1e-3)) * (2 * B) - B
        knots, _ = q_ref.unconstrained_quadratic_spline_plain(
            locs, t[1][:, None].expand(-1, K + 1, -1), t[2][:, None].expand(-1, K + 1, -1),
            tail_bound=B)
    else:
        knots = binning.unit_knots(binning.normalize_bins(t[1], K, 1e-3)) * (2 * B) - B
    x = _on_knots(x, knots.numpy().astype(np.float32))
    t[0] = torch.from_numpy(x)
    _hold(quadratic_lanes(*t, inverse),
          q_ref.unconstrained_quadratic_spline_plain(*t, inverse=inverse, tail_bound=B),
          q_ref.unconstrained_quadratic_spline_plain(*[a.double() for a in t],
                                                     inverse=inverse, tail_bound=B),
          jax_splines.unconstrained_quadratic_spline(x, w, h, inverse=inverse, tails="linear",
                                                     tail_bound=B),
          quadratic_spline_pallas(x, w, h, inverse=inverse, tail_bound=B, interpret=True)
          if K in PALLAS_BINS else None, x)


@pytest.mark.parametrize("K", [1, 2, 3, 5, 8, 9, 16, 17, 32, 33, 40, 64, 100, 128, 129, 300])
def test_layout_covers_every_bin(K):
    """Every bin has one place: G a power of two, 2 to 32, with 4 G at
    least K up to 128 bins; past that ceil(K / 128) chunks of the whole
    warp; a block of 256 threads holds whole groups."""
    L = Lanes(K)
    assert L.G in (2, 4, 8, 16, 32) and 256 % L.G == 0
    assert (L.G * L.V >= K) == (L.C == 1) and L.C * L.G * L.V >= K > (L.C - 1) * L.G * L.V
    assert L.C == 1 or L.G == 32
    assert L.b.reshape(-1)[:K].tolist() == list(range(K))


# the six instantiations of each kernel: (G, whether the warp walks chunks)
EVERY_LAYOUT = {(2, False), (4, False), (8, False), (16, False), (32, False), (32, True)}


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bins", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("where", ["BINS", "B1_LAYOUT_BINS", "B5_LAYOUT_BINS", "B6_LAYOUT_BINS",
                                   "B7_LAYOUT_BINS", "B8_LAYOUT_BINS"])
def test_held_bins_reach_every_layout(where):
    """This file's BINS and the K at which chip_smoke.py holds B1, B5, B6,
    B7 and B8 on the card each reach every instantiation of the kernels."""
    bins = BINS if where == "BINS" else getattr(_chip_smoke(), where)
    assert {(Lanes(K).G, Lanes(K).C > 1) for K in bins} == EVERY_LAYOUT
