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
"""

from __future__ import annotations

from typing import Tuple

import torch

from nflows_tpu_torch.ops import binning

__all__ = [
    "quadratic_spline",
    "unconstrained_quadratic_spline",
    "unconstrained_quadratic_spline_plain",
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
