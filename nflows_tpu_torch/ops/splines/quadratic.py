"""Piecewise-quadratic spline (Neural Importance Sampling, Müller et al.
2018), plain PyTorch (counterpart of nflows_tpu/ops/splines/quadratic.py;
reference nflows/transforms/splines/quadratic.py).

The pdf is piecewise linear through K+1 knot heights, so the CDF is
piecewise quadratic. With K-1 heights (the linear-tail variant) the two
boundary heights are solved for so that the normalised pdf is exactly 1 at
both ends. The inverse takes the stable root ``-2c / (b + sqrt(disc))``.

This is also the plain version of kernel B7: on a CUDA tensor
:func:`unconstrained_quadratic_spline` hands the work to B7
(``ops/cuda/quadratic_spline.py``).
:func:`quadratic_spline_forward_adjoint_plain` is the plain version of the
forward branch's adjoint that the training kernels B3 and B4 run
(``csrc/quadratic_spline_bwd.cuh``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from nflows_tpu_torch.ops import binning

__all__ = [
    "quadratic_spline",
    "unconstrained_quadratic_spline",
    "unconstrained_quadratic_spline_plain",
    "quadratic_spline_forward_adjoint_plain",
    "DEFAULT_MIN_BIN_WIDTH",
    "DEFAULT_MIN_BIN_HEIGHT",
]

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3


def quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadratic spline on [left,right] -> [bottom,top].

    inputs [...]; widths [..., K]; heights [..., K+1] (or [..., K-1] for the
    normalised-boundary variant).
    """
    if inverse:
        inputs = (inputs.clamp(bottom, top) - bottom) / (top - bottom)
    else:
        inputs = (inputs.clamp(left, right) - left) / (right - left)

    num_bins = unnormalized_widths.shape[-1]
    if min_bin_width * num_bins > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * num_bins > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")

    widths = binning.normalize_bins(unnormalized_widths, num_bins, min_bin_width)
    unnorm_heights_exp = binning.softplus(unnormalized_heights) + 1e-3

    if unnorm_heights_exp.shape[-1] == num_bins - 1:
        # boundary heights that make the normalised heights exactly 1 at
        # both ends (reference quadratic.py:88-104)
        first_widths = 0.5 * widths[..., 0]
        last_widths = 0.5 * widths[..., -1]
        numerator = (
            0.5 * first_widths * unnorm_heights_exp[..., 0]
            + 0.5 * last_widths * unnorm_heights_exp[..., -1]
            + torch.sum(
                ((unnorm_heights_exp[..., :-1] + unnorm_heights_exp[..., 1:]) / 2)
                * widths[..., 1:-1], dim=-1)
        )
        constant = (numerator / (1 - 0.5 * first_widths - 0.5 * last_widths))[..., None]
        unnorm_heights_exp = torch.cat([constant, unnorm_heights_exp, constant], dim=-1)

    unnormalized_area = torch.sum(
        ((unnorm_heights_exp[..., :-1] + unnorm_heights_exp[..., 1:]) / 2) * widths,
        dim=-1, keepdim=True)
    heights = unnorm_heights_exp / unnormalized_area
    heights = min_bin_height + (1 - min_bin_height) * heights

    bin_left_cdf = binning.unit_knots(
        ((heights[..., :-1] + heights[..., 1:]) / 2) * widths)
    bin_locations = binning.unit_knots(widths)

    idx = binning.bin_index(bin_left_cdf if inverse else bin_locations, inputs)
    input_bin_locations = binning.select_bin(bin_locations[..., :-1], idx)
    input_bin_widths = binning.select_bin(widths, idx)
    input_left_cdf = binning.select_bin(bin_left_cdf[..., :-1], idx)
    input_left_heights = binning.select_bin(heights[..., :-1], idx)
    input_right_heights = binning.select_bin(heights[..., 1:], idx)

    a = 0.5 * (input_right_heights - input_left_heights) * input_bin_widths
    b = input_left_heights * input_bin_widths
    c = input_left_cdf

    if inverse:
        c_ = c - inputs
        disc = (b ** 2 - 4 * a * c_).clamp_min(0.0)
        alpha = (-2.0 * c_) / (b + torch.sqrt(disc))
        outputs = (alpha * input_bin_widths + input_bin_locations).clamp(0.0, 1.0)
        logabsdet = -torch.log(
            alpha * (input_right_heights - input_left_heights) + input_left_heights)
    else:
        alpha = (inputs - input_bin_locations) / input_bin_widths
        outputs = (a * alpha ** 2 + b * alpha + c).clamp(0.0, 1.0)
        logabsdet = torch.log(
            alpha * (input_right_heights - input_left_heights) + input_left_heights)

    if inverse:
        outputs = outputs * (right - left) + left
    else:
        outputs = outputs * (top - bottom) + bottom
    return outputs, logabsdet


def unconstrained_quadratic_spline_plain(
    inputs, unnormalized_widths, unnormalized_heights, inverse=False,
    tail_bound=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
):
    """Quadratic spline on [-B, B] with K-1 heights, identity with zero
    logabsdet outside, in plain PyTorch (kernel B7's plain version)."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    spline_out, spline_lad = quadratic_spline(
        inputs.clamp(-tail_bound, tail_bound), unnormalized_widths,
        unnormalized_heights, inverse=inverse, left=-tail_bound,
        right=tail_bound, bottom=-tail_bound, top=tail_bound,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height)
    outputs = torch.where(inside, spline_out, inputs)
    logabsdet = torch.where(inside, spline_lad, torch.zeros_like(spline_lad))
    return outputs, logabsdet


def unconstrained_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    tails: str = "linear",
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadratic spline on [-B, B] with identity tails; heights must have
    K-1 entries so the boundary pdf values normalise to 1 (reference
    quadratic.py:12-52).

    On a CUDA tensor this runs kernel B7 (ops/cuda/quadratic_spline.py);
    otherwise the plain version."""
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented.")
    num_bins = unnormalized_widths.shape[-1]
    if unnormalized_heights.shape[-1] != num_bins - 1:
        raise ValueError(
            f"linear tails take K-1 = {num_bins - 1} heights, got "
            f"{unnormalized_heights.shape[-1]}")
    kw = dict(inverse=inverse, tail_bound=tail_bound,
              min_bin_width=min_bin_width, min_bin_height=min_bin_height)
    if inputs.is_cuda:
        from nflows_tpu_torch.ops.cuda.quadratic_spline import quadratic_spline_cuda
        return quadratic_spline_cuda(inputs.contiguous(), unnormalized_widths.contiguous(),
                                     unnormalized_heights.contiguous(), **kw)
    return unconstrained_quadratic_spline_plain(
        inputs, unnormalized_widths, unnormalized_heights, **kw)


def quadratic_spline_forward_adjoint_plain(
    inputs, unnormalized_widths, unnormalized_heights, grad_outputs, grad_logabsdet,
    tail_bound=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT, wh_scale=1.0,
):
    """Adjoint of the linear-tail quadratic spline's forward branch (K-1
    heights) by explicit formulas (no autograd): the plain version of
    ``csrc/quadratic_spline_bwd.cuh``, which repeats this arithmetic line
    for line, one bin at a time.

    inputs [...]; widths [..., K]; interior heights [..., K-1]; the
    cotangents of the outputs and of the per-element logabsdet [...].
    ``wh_scale`` multiplies every parameter cotangent (the factor the caller
    applied to all of them). Returns (g_inputs [...], g_widths [..., K],
    g_heights [..., K-1]).

    What flows where. The selected bin's output a alpha^2 + b alpha + c
    (clipped to [0, 1]; a clipped output carries no gradient) and
    logabsdet log(alpha (h1 - h0) + h0) depend on its location (the widths
    below it), width, cdf (the trapezoids below it) and two knot heights.
    Every knot height is normalised by the area of all the trapezoids, and
    the two boundary knots are solved from every width and interior height,
    so one bin's cotangent reaches every parameter.
    """
    x_orig, uw, uh = inputs, unnormalized_widths, unnormalized_heights
    K = uw.shape[-1]
    B = float(tail_bound)
    inside = (x_orig >= -B) & (x_orig <= B)
    x = (x_orig.clamp(-B, B) + B) / (2.0 * B)
    e = torch.exp(uw - uw.max(dim=-1, keepdim=True).values)
    sw = e / e.sum(dim=-1, keepdim=True)            # softmax, [..., K]
    wmix = 1.0 - min_bin_width * K
    hmix = 1.0 - min_bin_height
    w = [min_bin_width + wmix * sw[..., k] for k in range(K)]
    interior = [binning.softplus(uh[..., k]) + 1e-3 for k in range(K - 1)]

    # the forward: boundary heights, area, then the walk over the bins
    first_w, last_w = 0.5 * w[0], 0.5 * w[K - 1]
    inner = torch.zeros_like(x)
    for k in range(1, K - 1):
        inner = inner + ((interior[k - 1] + interior[k]) / 2.0) * w[k]
    numerator = 0.5 * first_w * interior[0] + 0.5 * last_w * interior[K - 2] + inner
    dd = 1.0 - 0.5 * first_w - 0.5 * last_w
    edge = numerator / dd
    knot = [edge] + interior + [edge]
    area = torch.zeros_like(x)
    for k in range(K):
        area = area + ((knot[k] + knot[k + 1]) / 2.0) * w[k]
    H = [min_bin_height + hmix * (u / area) for u in knot]

    zero = torch.zeros_like(x)
    cdf_lo, loc_lo, run_cdf, run_loc = zero, zero, zero, zero
    sel = torch.zeros_like(x, dtype=torch.int64)
    sel_loc, sel_w, sel_cdf, h0, h1 = zero, zero, zero, zero, zero
    for k in range(K):
        run_cdf = run_cdf + ((H[k] + H[k + 1]) / 2.0) * w[k]
        run_loc = run_loc + w[k]
        take = (x >= loc_lo) if k else torch.ones_like(inside)
        sel = torch.where(take, torch.full_like(sel, k), sel)
        sel_loc = torch.where(take, loc_lo, sel_loc)
        sel_w = torch.where(take, w[k], sel_w)
        sel_cdf = torch.where(take, cdf_lo, sel_cdf)
        h0 = torch.where(take, H[k], h0)
        h1 = torch.where(take, H[k + 1], h1)
        cdf_lo = torch.ones_like(x) if k == K - 1 else run_cdf
        loc_lo = torch.ones_like(x) if k == K - 1 else run_loc

    alpha = (x - sel_loc) / sel_w
    a = 0.5 * (h1 - h0) * sel_w
    b = h0 * sel_w
    raw = a * alpha * alpha + b * alpha + sel_cdf
    ld = alpha * (h1 - h0) + h0

    # cotangents of the selected bin's quantities
    g_y = torch.where(inside, grad_outputs, zero)
    g_l = torch.where(inside, grad_logabsdet, zero)
    g_raw = torch.where((raw >= 0.0) & (raw <= 1.0), g_y * (2.0 * B), zero)
    g_ld = g_l / ld
    g_a = g_raw * alpha * alpha
    g_b = g_raw * alpha
    g_cdf = g_raw
    g_alpha = g_raw * (2.0 * a * alpha + b) + g_ld * (h1 - h0)
    g_h1 = g_a * 0.5 * sel_w + g_ld * alpha
    g_h0 = -g_a * 0.5 * sel_w + g_b * sel_w + g_ld * (1.0 - alpha)
    g_wsel = g_a * 0.5 * (h1 - h0) + g_b * h0 - g_alpha * alpha / sel_w
    g_loc = -g_alpha / sel_w
    g_x01 = g_alpha / sel_w

    # knot heights: the selected bin's two, and the trapezoids below it
    # (sel_cdf); each normalised by the area
    def g_height(j):
        g = torch.where(sel == j, g_h0, zero) + torch.where(sel == j - 1, g_h1, zero)
        if j < K:
            g = g + torch.where(sel > j, g_cdf * w[j] / 2.0, zero)
        if j > 0:
            g = g + torch.where(sel >= j, g_cdf * w[j - 1] / 2.0, zero)
        return g

    scale = hmix / area
    g_area = zero
    for j in range(K + 1):
        g_area = g_area - g_height(j) * scale * (knot[j] / area)

    def g_knot(j):
        g = g_height(j) * scale
        if j < K:
            g = g + g_area * w[j] / 2.0
        if j > 0:
            g = g + g_area * w[j - 1] / 2.0
        return g

    # the boundary knots: edge = numerator / dd
    g_edge = g_knot(0) + g_knot(K)
    g_num = g_edge / dd
    g_dd = -g_edge * edge / dd
    g_first = g_num * 0.5 * interior[0] - 0.5 * g_dd
    g_last = g_num * 0.5 * interior[K - 2] - 0.5 * g_dd

    g_w = []
    for k in range(K):
        g = g_area * (knot[k] + knot[k + 1]) / 2.0
        g = g + torch.where(sel > k, g_loc + g_cdf * (H[k] + H[k + 1]) / 2.0, zero)
        g = g + torch.where(sel == k, g_wsel, zero)
        if k == 0:
            g = g + 0.5 * g_first
        if k == K - 1:
            g = g + 0.5 * g_last
        if 0 < k < K - 1:
            g = g + g_num * (interior[k - 1] + interior[k]) / 2.0
        g_w.append(g)
    g_uh = []
    for i in range(K - 1):
        g = g_knot(i + 1)
        if i == 0:
            g = g + g_num * 0.5 * first_w
        if i == K - 2:
            g = g + g_num * 0.5 * last_w
        if i + 1 < K - 1:
            g = g + g_num * w[i + 1] / 2.0
        if i > 0:
            g = g + g_num * w[i] / 2.0
        g_uh.append(wh_scale * g * torch.sigmoid(uh[..., i]))

    # softmax adjoint of the widths
    dot = zero
    for k in range(K):
        dot = dot + sw[..., k] * (wmix * g_w[k])
    g_uw = [wh_scale * sw[..., k] * (wmix * g_w[k] - dot) for k in range(K)]
    g_x = torch.where(inside, g_x01 / (2.0 * B), grad_outputs)
    return g_x, torch.stack(g_uw, dim=-1), torch.stack(g_uh, dim=-1)
