"""The order of sums of the group-of-lanes spline kernels B5
(``csrc/lrs_spline.cu``) and B8 (``csrc/cubic_spline.cu``), repeated on the
CPU, against the JAX Pallas kernels in interpret mode, the JAX XLA path and
the port's plain versions.

Both kernels lay an element's bins out as B1 and B7 do
(``csrc/spline_lanes.cuh``, repeated by ``tests/test_torch_spline_lanes.py``,
whose helpers this file uses): the softmax max and sum by butterflies, the
edges or knots by the lanes' running sums and a Hillis-Steele scan, the bin
by the ballot's count of interior edges at or below x (B8's searched
knots by compensated running sums, ``running_compensated``). Then each
element's
bin alone is evaluated. B5 reads that bin's two derivatives and its lambda
(the boundary derivative at the first and last bin). B8 takes the sizes of
bins sel - 1, sel and sel + 1 as ``Gather`` shuffles them: from the lane
that holds each bin, the lane before or after where the bin is a lane's
first or last, and, where sel is a chunk's first or last bin, the value
below or above the chunk; its three slopes give Steffen's knot derivatives,
or 3 sigmoid(d) times the end bin's slope at the ends. ``gather_three``
repeats those lanes and chunks (at K = 8, G = 2, bin 4 lies in the lane
after bin 3's; at K = 130 bin 128 in the chunk after bin 127's).

Tolerances and inputs as ``tests/test_torch_spline_lanes.py``: 1e-5 on
outputs and 1e-4 on the logabsdet, or within twice the fp32 plain version's
distance from float64 (and twice the plain version's from each JAX
evaluation); inputs on a knot are held against the plain version and the
XLA path, not the Pallas kernel in interpret mode, which mixes bins there.
"""

import numpy as np
import pytest
import torch

from nflows_tpu.ops import splines as jax_splines
from nflows_tpu.ops.pallas.cubic_spline import cubic_spline_pallas
from nflows_tpu.ops.pallas.lrs_spline import lrs_spline_pallas
from nflows_tpu_torch.ops import binning
from nflows_tpu_torch.ops.cuda import rq_spline as b1
from nflows_tpu_torch.ops.splines import cubic as cub_ref
from nflows_tpu_torch.ops.splines import linear_rational as lrs_ref
from test_torch_spline_lanes import (B, BINS, PALLAS_BINS, Lanes, _f32, _hold, _inputs,
                                     _on_knots, softplus)

torch.set_num_threads(1)


def sigmoid(v):
    """csrc/spline_common.cuh sigmoid"""
    return 1.0 / (1.0 + torch.exp(-v))


def _row(u, sel):
    """u[n, sel[n]] of [N, P] rows (sel clamped into the row)."""
    return torch.gather(u, 1, sel.clamp(0, u.shape[1] - 1))[:, 0]


def lrs_lanes(x_orig, uw, uh, ud, ul, inverse):
    """B5's arithmetic in its order (defaults of the wrapper's minima)."""
    K = uw.shape[-1]
    L = Lanes(K)
    min_d, min_l = _f32(lrs_ref.DEFAULT_MIN_DERIVATIVE), _f32(lrs_ref.DEFAULT_MIN_LAMBDA)
    edge_d = _f32(b1._edge_derivative(lrs_ref.DEFAULT_MIN_DERIVATIVE))
    inside = (x_orig >= -B) & (x_orig <= B)
    x = x_orig.clamp(-B, B)
    two_b = _f32(2.0 * B)
    w_hi = torch.where(L.b == K - 1, B,
                       two_b * L.running(L.softmax(uw, lrs_ref.DEFAULT_MIN_BIN_WIDTH)) - B)
    h_hi = torch.where(L.b == K - 1, B,
                       two_b * L.running(L.softmax(uh, lrs_ref.DEFAULT_MIN_BIN_HEIGHT)) - B)
    upper = h_hi if inverse else w_hi
    sel = L.bin(x, upper)
    x0, y0, ew, eh = L.select(x, upper, L.below(w_hi, -B), L.below(h_hi, -B), w_hi, h_hi)
    s = sel[:, 0]
    # the selected bin's derivatives and lambda, in the evaluating lane
    d0 = torch.where(s == 0, edge_d, min_d + softplus(_row(ud, sel - 1)))
    d1 = torch.where(s == K - 1, edge_d, min_d + softplus(_row(ud, sel)))
    lam = min_l + (1.0 - 2.0 * min_l) * sigmoid(_row(ul, sel))
    # lrs_bin_eval
    w, h = ew - x0, eh - y0
    y1 = y0 + h
    wb = torch.sqrt(d0 / d1)
    ym = ((1.0 - lam) * y0 + lam * wb * y1) / ((1.0 - lam) + lam * wb)
    wm = d0 * lam * w / (ym - y0)
    if inverse:
        use_a = x <= ym
        ya, yb = torch.minimum(x, ym), torch.maximum(x, ym)
        theta = torch.where(
            use_a, lam * (ya - y0) / (wm * (ym - ya) + (ya - y0)),
            (wm * (ym - yb) + wb * lam * (yb - y1)) / (wm * (ym - yb) + wb * (yb - y1)))
    else:
        theta = (x - x0) / w
        use_a = theta <= lam
    ta, tb = torch.minimum(theta, lam), torch.maximum(theta, lam)
    den_a = (lam - ta) + wm * ta
    den_b = wm * (1.0 - tb) + wb * (tb - lam)
    y = torch.where(use_a, (y0 * (lam - ta) + wm * ym * ta) / den_a,
                    (wm * ym * (1.0 - tb) + wb * y1 * (tb - lam)) / den_b)
    lad = torch.where(
        use_a,
        torch.log(wm) + torch.log(lam) + torch.log(ym - y0) - 2.0 * torch.log(den_a)
        - torch.log(w),
        torch.log(wm) + torch.log(wb) + torch.log1p(-lam) + torch.log(y1 - ym)
        - 2.0 * torch.log(den_b) - torch.log(w))
    if inverse:
        y = x0 + theta * w
        lad = -lad
    return torch.where(inside, y, x_orig), torch.where(inside, lad, 0.0)


def two_sum(a, b):
    """csrc/spline_lanes.cuh two_sum: a + b and its rounding error"""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def running_compensated(L, v):
    """``Group::running_compensated`` chunk by chunk (B8's knots): each
    lane's running sums and the scan of the lanes' (sum, error) pairs with
    every addition's rounding error carried beside it, added once at the
    end; each chunk starts from the last lane's rounded knot."""
    run = torch.zeros_like(v[:, 0, :1, 0])
    j = L.g.j
    out = []
    for c in range(L.C):
        own, err = [v[:, c, :, 0]], [torch.zeros_like(v[:, c, :, 0])]
        for t in range(1, L.V):
            s, e = two_sum(own[-1], v[:, c, :, t])
            own.append(s)
            err.append(err[-1] + e)
        hi, lo = own[-1], err[-1]
        for o in L.g.steps():
            src = (j - o).clamp_min(0)
            s, e = two_sum(hi[:, src], hi)
            take = j >= o
            hi, lo = torch.where(take, s, hi), torch.where(take, (lo[:, src] + lo) + e, lo)
        b_hi = torch.where(j == 0, 0.0, hi[:, (j - 1).clamp_min(0)])
        b_lo = torch.where(j == 0, 0.0, lo[:, (j - 1).clamp_min(0)])

        def finish(s, e):
            if c == 0:
                return s + e
            t, e2 = two_sum(run, s)
            return t + (e + e2)

        cum = []
        for t in range(L.V - 1):
            s, e = two_sum(b_hi, own[t])
            cum.append(finish(s, (b_lo + err[t]) + e))
        cum.append(finish(hi, lo))
        out.append(torch.stack(cum, -1))
        run = cum[-1][:, -1:]
    return torch.stack(out, 1)


def gather_three(L, v, sel):
    """Bins sel - 1, sel and sel + 1 of the [N, C, G, V] values ``v`` as
    ``Gather::below``, ``at`` and ``above`` take them: the lane of bin s
    (s = sel within its chunk) is s // V; bin s - 1 lies in that lane or,
    at a lane's first bin, in the lane before, and bin s + 1 in that lane
    or the lane after; at the chunk's first or last bin the value below or
    above the chunk (read from the row where the bins come in chunks, else
    0: bins 0 and K - 1 take the boundary derivatives)."""
    V, kbins = L.V, L.G * L.V
    n = torch.arange(v.shape[0])
    c, s = (sel // kbins)[:, 0], (sel % kbins)[:, 0]
    src, own = s // V, s % V
    flat = v.reshape(v.shape[0], -1)
    if L.C > 1:
        lo0 = _row(flat, (c * kbins - 1)[:, None])
        hi0 = torch.where((c + 1) * kbins < L.K, _row(flat, ((c + 1) * kbins)[:, None]), 0.0)
        lo0 = torch.where(c > 0, lo0, 0.0)
    else:
        lo0 = hi0 = torch.zeros(v.shape[0])
    at = v[n, c, src, own]
    below = torch.where(own > 0, v[n, c, src, (own - 1).clamp_min(0)],
                        v[n, c, (src - 1).clamp_min(0), V - 1])
    above = torch.where(own < V - 1, v[n, c, src, (own + 1).clamp_max(V - 1)],
                        v[n, c, (src + 1).clamp_max(L.G - 1), 0])
    return torch.where(s == 0, lo0, below), at, torch.where(s == kbins - 1, hi0, above)


def steffen(sp, sn, wp, wn):
    """csrc/cubic_spline.cuh steffen_derivative"""
    m1 = torch.minimum(sp.abs(), sn.abs())
    m2 = 0.5 * (wn * sp + wp * sn) / (wp + wn)
    return torch.minimum(m1, m2) * (torch.sign(sp) + torch.sign(sn))


def cubic_lanes(x_orig, uw, uh, dl, dr, inverse):
    """B8's arithmetic in its order (defaults of the wrapper's minima)."""
    K = uw.shape[-1]
    L = Lanes(K)
    inside = (x_orig >= -B) & (x_orig <= B)
    x = (x_orig.clamp(-B, B) + B) / _f32(2.0 * B)
    wb = L.softmax(uw, cub_ref.DEFAULT_MIN_BIN_WIDTH)
    hb = L.softmax(uh, cub_ref.DEFAULT_MIN_BIN_HEIGHT)
    # the knots of the searched axis compensated, the other's as B1's
    cw = L.running(wb) if inverse else running_compensated(L, wb)
    ch = running_compensated(L, hb) if inverse else L.running(hb)
    cw_hi = torch.where(L.b == K - 1, 1.0, cw)
    ch_hi = torch.where(L.b == K - 1, 1.0, ch)
    upper = ch_hi if inverse else cw_hi
    sel = L.bin(x, upper)
    left_w, right_w, sel_ch = L.select(x, upper, L.below(cw_hi, 0.0), cw_hi,
                                       L.below(ch_hi, 0.0))
    wp, ws, wn = gather_three(L, wb, sel)
    hp, hs, hn = gather_three(L, hb, sel)
    s = sel[:, 0]
    # the slopes, knot derivatives and coefficients, in the evaluating lane
    ss = hs / ws
    d0 = torch.where(s == 0, sigmoid(dl[:, 0]) * 3.0 * ss, steffen(hp / wp, ss, wp, ws))
    d1 = torch.where(s == K - 1, sigmoid(dr[:, 0]) * 3.0 * ss, steffen(ss, hn / wn, ws, wn))
    a = (d0 + d1 - 2.0 * ss) / (ws * ws)
    b = (3.0 * ss - 2.0 * d0 - d1) / ws
    c, d = d0, sel_ch
    # cubic_bin_eval
    if inverse:
        lo, hi = torch.zeros_like(x), right_w - left_w
        for _ in range(cub_ref.BISECTION_STEPS):
            mid = 0.5 * (lo + hi)
            go_right = ((a * mid + b) * mid + c) * mid + d - x < 0.0
            lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
        t = 0.5 * (lo + hi)
        deriv = 3.0 * a * (t * t) + 2.0 * b * t + c
        shifted = t - (((a * t + b) * t + c) * t + d - x) / deriv
        out01 = shifted + left_w
        lad = -torch.log(3.0 * a * (shifted * shifted) + 2.0 * b * shifted + c)
    else:
        shifted = x - left_w
        out01 = a * (shifted * shifted * shifted) + b * (shifted * shifted) + c * shifted + d
        lad = torch.log(3.0 * a * (shifted * shifted) + 2.0 * b * shifted + c)
    out01 = out01.clamp(0.0, 1.0)
    return (torch.where(inside, out01 * _f32(2.0 * B) - B, x_orig),
            torch.where(inside, lad, 0.0))


@pytest.mark.parametrize("K", BINS)
@pytest.mark.parametrize("inverse", [False, True])
def test_lrs_group_order_matches_pallas_and_plain(K, inverse):
    x, w, h, d, lam = _inputs((K, K, K - 1, K), seed=200 + K)
    sizes = h if inverse else w
    _, knots = binning.edges_on(torch.from_numpy(sizes), K, 1e-3, -B, B)
    x = _on_knots(x, knots.numpy())
    t = [torch.from_numpy(a) for a in (x, w, h, d, lam)]
    _hold(lrs_lanes(*t, inverse),
          lrs_ref.unconstrained_linear_rational_spline_plain(*t, inverse=inverse,
                                                             tail_bound=B),
          lrs_ref.unconstrained_linear_rational_spline_plain(
              *[a.double() for a in t], inverse=inverse, tail_bound=B),
          jax_splines.unconstrained_linear_rational_spline(
              x, w, h, d, lam, inverse=inverse, tails="linear", tail_bound=B),
          lrs_spline_pallas(x, w, h, d, lam, inverse=inverse, tail_bound=B, interpret=True)
          if K in PALLAS_BINS else None, x)


@pytest.mark.parametrize("K", BINS)
@pytest.mark.parametrize("inverse", [False, True])
def test_cubic_group_order_matches_pallas_and_plain(K, inverse):
    x, w, h, dl, dr = _inputs((K, K, 1, 1), seed=300 + K)
    sizes = h if inverse else w
    _, knots = binning.edges_on(torch.from_numpy(sizes), K, 1e-3, -B, B)
    x = _on_knots(x, knots.numpy())
    t = [torch.from_numpy(a) for a in (x, w, h, dl, dr)]
    _hold(cubic_lanes(*t, inverse),
          cub_ref.unconstrained_cubic_spline_plain(*t, inverse=inverse, tail_bound=B),
          cub_ref.unconstrained_cubic_spline_plain(*[a.double() for a in t], inverse=inverse,
                                                   tail_bound=B),
          jax_splines.unconstrained_cubic_spline(x, w, h, dl, dr, inverse=inverse,
                                                 tails="linear", tail_bound=B),
          cubic_spline_pallas(x, w, h, dl, dr, inverse=inverse, tail_bound=B, interpret=True)
          if K in PALLAS_BINS else None, x)


@pytest.mark.parametrize("K", [8, 130])
def test_cubic_gather_crosses_lanes_and_chunks(K):
    """gather_three against plain indexing, at every bin: the neighbours of
    a lane's last and first bins come from the lanes beside it, and those
    of a chunk's last and first bins from the chunks beside it."""
    L = Lanes(K)
    rng = np.random.default_rng(K)
    v = torch.from_numpy(rng.standard_normal((K, K)).astype(np.float32))
    sel = torch.arange(K)[:, None]
    below, at, above = gather_three(L, L.pad(v, 0.0), sel)
    rows = torch.arange(K)
    torch.testing.assert_close(at, v[rows, rows], rtol=0, atol=0)
    torch.testing.assert_close(below[1:], v[rows[1:], rows[1:] - 1], rtol=0, atol=0)
    torch.testing.assert_close(above[:-1], v[rows[:-1], rows[:-1] + 1], rtol=0, atol=0)
    crossed = [k for k in range(K - 1) if k % L.V == L.V - 1]
    assert crossed and (L.C == 1 or (L.G * L.V - 1) in crossed)
