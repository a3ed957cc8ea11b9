"""The order of sums of the group-of-lanes linear spline kernel B6
(``csrc/linear_spline.cu``), repeated on the CPU, against the JAX Pallas
kernel in interpret mode, the JAX XLA path and the port's plain version.

B6 lays an element's bins out as B1 and B7 do (``csrc/spline_lanes.cuh``,
repeated by ``tests/test_torch_spline_lanes.py``, whose helpers this file
uses): the softmax max and sum by butterflies, each exp taken once a bin and
pdf_k = e_k (1 / sum), the CDF knots by the lanes' running sums and a
Hillis-Steele scan, chunk by chunk after the chunks before, knot K pinned to
1. The forward takes no search: its bin is floor(x K) clamped to [0, K - 1],
the same in every lane of the group, and the bin's lower knot and pdf are
gathered from the lanes that hold them. The inverse's bin is the ballot's
count of interior knots at or below x, and the bin's two knots give the
slope and offset as the JAX kernel computes them.

Tolerances and inputs as ``tests/test_torch_spline_lanes.py``: 1e-5 on
outputs and 1e-4 on the logabsdet, or within twice the fp32 plain version's
distance from float64 (and twice the plain version's from each JAX
evaluation); inputs on a knot (the forward's equal-width edges -B + 2 B k /
K, the inverse's CDF knots) are held against the plain version and the XLA
path, not the Pallas kernel in interpret mode, which mixes bins there. K = 1,
one bin whose only knots are the ends, is held beside ``BINS``.

Unlike the other families' logabsdets, the linear spline's jumps at every
knot: the pdf is constant in a bin. The inverse's knots are running sums,
and B6 sums them in another order than the plain version, so a knot of the
kernel lies an ulp or so either side of the plain version's, and on a knot
the kernel may take the bin on either side of it. There its output is held
as everywhere (the spline is continuous), and its logabsdet against the
plain version's on each side of the knot (``_one_sided``). The forward's
bin, floor(x K), is computed as the plain version computes it.
"""

import numpy as np
import pytest
import torch

from nflows_tpu.ops import splines as jax_splines
from nflows_tpu.ops.pallas.linear_spline import linear_spline_pallas
from nflows_tpu_torch.ops import binning
from nflows_tpu_torch.ops.splines import linear as lin_ref
from test_torch_spline_lanes import (B, BINS, KNOTS, LAD_TOL, PALLAS_BINS, Lanes, _f32, _hold,
                                     _inputs)

torch.set_num_threads(1)


def linear_lanes(x_orig, up, inverse):
    """B6's arithmetic in its order."""
    K = up.shape[-1]
    L = Lanes(K)
    inside = (x_orig >= -B) & (x_orig <= B)
    x = (x_orig.clamp(-B, B) + B) / _f32(2.0 * B)
    pdf = L.softmax(up, 0.0)  # e_k (1 / sum), 0 past the last bin
    hi = torch.where(L.b == K - 1, 1.0, L.running(pdf))
    lo = L.below(hi, 0.0)
    if inverse:
        sel = L.bin(x, hi)[:, 0]
        s_lo, s_hi = L.select(x, hi, lo, hi)
        slope = (s_hi - s_lo) * K
        offset = s_hi - slope * ((sel + 1).float() / K)
        out01 = ((x - offset) / slope).clamp(0.0, 1.0)
        lad = -torch.log(slope)
    else:
        sel = torch.floor(x * K).clamp(0.0, K - 1.0).long()
        flat_lo, flat_pdf = lo.reshape(x.shape[0], -1), pdf.reshape(x.shape[0], -1)
        s_lo = torch.gather(flat_lo, 1, sel[:, None])[:, 0]
        s_pdf = torch.gather(flat_pdf, 1, sel[:, None])[:, 0]
        alpha = x * K - sel.float()
        out01 = (s_lo + alpha * s_pdf).clamp(0.0, 1.0)
        lad = torch.log(s_pdf) - _f32(np.log(1.0 / K))
    return (torch.where(inside, out01 * _f32(2.0 * B) - B, x_orig),
            torch.where(inside, lad, 0.0))


def _on_knots(x, knots):
    """x[KNOTS] set on knots of the plain version (float32): interior ones,
    or at K = 1 the two ends."""
    K = knots.shape[-1] - 1
    x[KNOTS] = knots[KNOTS, 1 + KNOTS % (K - 1) if K > 1 else KNOTS % 2]
    return x


# how far a knot input is moved to read the plain version's logabsdet on
# either side: past the rounding of a knot (a few 1e-7 of 2 B), within the
# narrowest bin of these draws
DELTA = 1e-5 * B


def _one_sided(got, t):
    """The inverse's logabsdet on the knots ``KNOTS``: within LAD_TOL of the
    plain version's just below the knot or just above it. Returns ``got``
    with those rows' logabsdet set to the plain version's at the knot, for
    ``_hold`` to hold the rest."""
    x, up = t[0][KNOTS], t[1][KNOTS]
    sides = [lin_ref.unconstrained_linear_spline_plain(x + d, up, inverse=True,
                                                       tail_bound=B)[1]
             for d in (-DELTA, 0.0, DELTA)]
    gap = torch.stack([(got[1][KNOTS] - s).abs() for s in sides]).amin(0)
    assert gap.max() <= LAD_TOL, gap.max()
    lad = got[1].clone()
    lad[KNOTS] = sides[1]
    return got[0], lad


@pytest.mark.parametrize("K", [1] + BINS)
@pytest.mark.parametrize("inverse", [False, True])
def test_linear_group_order_matches_pallas_and_plain(K, inverse):
    x, up = _inputs((K,), seed=400 + K)
    t = [torch.from_numpy(x), torch.from_numpy(up)]
    if inverse:
        knots = binning.unit_knots(torch.softmax(t[1], -1)) * (2 * B) - B
    else:
        knots = torch.from_numpy(np.tile(-B + 2 * B * np.arange(K + 1) / K, (x.shape[0], 1)))
    x = _on_knots(x, knots.numpy().astype(np.float32))
    t[0] = torch.from_numpy(x)
    got = linear_lanes(*t, inverse)
    _hold(_one_sided(got, t) if inverse else got,
          lin_ref.unconstrained_linear_spline_plain(*t, inverse=inverse, tail_bound=B),
          lin_ref.unconstrained_linear_spline_plain(*[a.double() for a in t], inverse=inverse,
                                                    tail_bound=B),
          jax_splines.unconstrained_linear_spline(x, up, inverse=inverse, tails="linear",
                                                  tail_bound=B),
          linear_spline_pallas(x, up, inverse=inverse, tail_bound=B, interpret=True)
          if K in PALLAS_BINS else None, x)
