"""Piecewise-cubic spline with monotone (Steffen) derivatives, plain
PyTorch (counterpart of nflows_tpu/ops/splines/cubic.py; forward as the
reference nflows/transforms/splines/cubic.py).

The inverse is the JAX package's own, not the reference's closed forms
(which overflow float32 for realistic parameters, DESIGN.md §7.7): the
in-bin cubic is monotone, so its root is found by 30 bisection halvings on
[0, bin width], then re-attached to the parameters by one Newton step
taken from the detached root with a detached slope. Without the detaching
the root would be piecewise constant in the parameters under autograd (zero
sensitivity through the selects); with it the gradient is the implicit
function's, -df/dtheta / f'(t).

This is also the plain version of kernel B8: on a CUDA tensor
:func:`unconstrained_cubic_spline` hands the work to B8
(``ops/cuda/cubic_spline.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from nflows_tpu_torch.ops import binning

__all__ = [
    "cubic_spline",
    "unconstrained_cubic_spline",
    "unconstrained_cubic_spline_plain",
    "DEFAULT_MIN_BIN_WIDTH",
    "DEFAULT_MIN_BIN_HEIGHT",
    "DEFAULT_EPS",
    "DEFAULT_QUADRATIC_THRESHOLD",
    "BISECTION_STEPS",
]

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_EPS = 1e-5
DEFAULT_QUADRATIC_THRESHOLD = 1e-3
BISECTION_STEPS = 30


def cubic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnorm_derivatives_left: torch.Tensor,
    unnorm_derivatives_right: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    eps: float = DEFAULT_EPS,
    quadratic_threshold: float = DEFAULT_QUADRATIC_THRESHOLD,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monotone cubic spline CDF on [left,right] -> [bottom,top].

    inputs [...]; widths/heights [..., K]; boundary derivative params
    [..., 1]. ``eps`` and ``quadratic_threshold`` belong to the reference's
    closed-form inverse and are kept for its signature; bisection needs
    neither.
    """
    num_bins = unnormalized_widths.shape[-1]
    if min_bin_width * num_bins > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * num_bins > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")

    if inverse:
        inputs = (inputs.clamp(bottom, top) - bottom) / (top - bottom)
    else:
        inputs = (inputs.clamp(left, right) - left) / (right - left)

    widths = binning.normalize_bins(unnormalized_widths, num_bins, min_bin_width)
    cumwidths = binning.unit_knots(widths)
    heights = binning.normalize_bins(unnormalized_heights, num_bins, min_bin_height)
    cumheights = binning.unit_knots(heights)

    # monotone interior derivatives (Steffen 1990, reference cubic.py:113-132)
    slopes = heights / widths
    min_something_1 = torch.minimum(slopes[..., :-1].abs(), slopes[..., 1:].abs())
    min_something_2 = (
        0.5 * (widths[..., 1:] * slopes[..., :-1] + widths[..., :-1] * slopes[..., 1:])
        / (widths[..., :-1] + widths[..., 1:]))
    min_something = torch.minimum(min_something_1, min_something_2)
    derivatives_left = torch.sigmoid(unnorm_derivatives_left) * 3 * slopes[..., :1]
    derivatives_right = torch.sigmoid(unnorm_derivatives_right) * 3 * slopes[..., -1:]
    derivatives = min_something * (torch.sign(slopes[..., :-1]) + torch.sign(slopes[..., 1:]))
    derivatives = torch.cat([derivatives_left, derivatives, derivatives_right], dim=-1)

    # per-bin cubic coefficients: y = a t^3 + b t^2 + c t + d, t = x - x_left
    a = (derivatives[..., :-1] + derivatives[..., 1:] - 2 * slopes) / widths ** 2
    b = (3 * slopes - 2 * derivatives[..., :-1] - derivatives[..., 1:]) / widths
    c = derivatives[..., :-1]
    d = cumheights[..., :-1]

    idx = binning.bin_index(cumheights if inverse else cumwidths, inputs)
    inputs_a = binning.select_bin(a, idx)
    inputs_b = binning.select_bin(b, idx)
    inputs_c = binning.select_bin(c, idx)
    inputs_d = binning.select_bin(d, idx)
    input_left_cumwidths = binning.select_bin(cumwidths[..., :-1], idx)
    input_right_cumwidths = binning.select_bin(cumwidths[..., 1:], idx)

    if inverse:
        lo = torch.zeros_like(inputs)
        hi = input_right_cumwidths - input_left_cumwidths
        for _ in range(BISECTION_STEPS):
            mid = 0.5 * (lo + hi)
            fmid = ((inputs_a * mid + inputs_b) * mid + inputs_c) * mid + inputs_d - inputs
            go_right = fmid < 0.0
            lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
        # Newton re-attachment: the value barely moves (|f(t*)| ~ 2^-30), the
        # gradient becomes the implicit-function derivative
        t_star = (0.5 * (lo + hi)).detach()
        deriv = 3 * inputs_a * t_star ** 2 + 2 * inputs_b * t_star + inputs_c
        f_val = ((inputs_a * t_star + inputs_b) * t_star + inputs_c) * t_star + inputs_d - inputs
        shifted = t_star - f_val / deriv.detach()
        outputs = shifted + input_left_cumwidths
        logabsdet = -torch.log(3 * inputs_a * shifted ** 2 + 2 * inputs_b * shifted + inputs_c)
    else:
        shifted = inputs - input_left_cumwidths
        outputs = (inputs_a * shifted ** 3 + inputs_b * shifted ** 2
                   + inputs_c * shifted + inputs_d)
        logabsdet = torch.log(3 * inputs_a * shifted ** 2 + 2 * inputs_b * shifted + inputs_c)

    outputs = outputs.clamp(0.0, 1.0)
    if inverse:
        outputs = outputs * (right - left) + left
    else:
        outputs = outputs * (top - bottom) + bottom
    return outputs, logabsdet


def unconstrained_cubic_spline_plain(
    inputs, unnormalized_widths, unnormalized_heights, unnorm_derivatives_left,
    unnorm_derivatives_right, inverse=False, tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH, min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
):
    """Cubic spline on [-B, B], identity with zero logabsdet outside, in
    plain PyTorch (kernel B8's plain version)."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    spline_out, spline_lad = cubic_spline(
        inputs.clamp(-tail_bound, tail_bound), unnormalized_widths,
        unnormalized_heights, unnorm_derivatives_left, unnorm_derivatives_right,
        inverse=inverse, left=-tail_bound, right=tail_bound,
        bottom=-tail_bound, top=tail_bound, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height)
    outputs = torch.where(inside, spline_out, inputs)
    logabsdet = torch.where(inside, spline_lad, torch.zeros_like(spline_lad))
    return outputs, logabsdet


def unconstrained_cubic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnorm_derivatives_left: torch.Tensor,
    unnorm_derivatives_right: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    tails: str = "linear",
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    eps: float = DEFAULT_EPS,
    quadratic_threshold: float = DEFAULT_QUADRATIC_THRESHOLD,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cubic spline on [-B, B] with identity tails (reference cubic.py:15-60).

    On a CUDA tensor this runs kernel B8 (ops/cuda/cubic_spline.py);
    otherwise the plain version. ``eps`` and ``quadratic_threshold`` are
    kept for the signature (see :func:`cubic_spline`)."""
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented.")
    kw = dict(inverse=inverse, tail_bound=tail_bound,
              min_bin_width=min_bin_width, min_bin_height=min_bin_height)
    params = (unnormalized_widths, unnormalized_heights, unnorm_derivatives_left,
              unnorm_derivatives_right)
    if inputs.is_cuda:
        from nflows_tpu_torch.ops.cuda.cubic_spline import cubic_spline_cuda
        return cubic_spline_cuda(inputs.contiguous(), *(p.contiguous() for p in params),
                                 **kw)
    return unconstrained_cubic_spline_plain(inputs, *params, **kw)
