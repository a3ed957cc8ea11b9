"""Monotonic rational-quadratic spline (Neural Spline Flows), plain PyTorch
(counterpart of nflows_tpu/ops/splines/rational_quadratic.py).

Out-of-domain inputs to the constrained spline clamp to the boundary
instead of raising; the unconstrained (linear-tail) variant is exact by
construction. The inverse takes the cancellation-stable root
``2c / (-b - sqrt(b^2 - 4ac))``.

This is also the plain version of kernel B1: on a CUDA tensor with K-1
derivative parameters and no identity init,
:func:`unconstrained_rational_quadratic_spline` hands the work to B1
(``ops/cuda/rq_spline.py``), as the JAX function hands it to its Pallas
kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nflows_tpu_torch.ops import binning

__all__ = [
    "rational_quadratic_spline",
    "unconstrained_rational_quadratic_spline",
    "DEFAULT_MIN_BIN_WIDTH",
    "DEFAULT_MIN_BIN_HEIGHT",
    "DEFAULT_MIN_DERIVATIVE",
]

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _softplus(x, beta=1.0):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if beta == 1.0:
        return torch.logaddexp(x, zero)
    return torch.logaddexp(beta * x, zero) / beta


def _edges(unnormalized, num_bins, min_size, lo, hi):
    """Bin sizes and cumulative edges on [lo, hi], endpoints pinned."""
    sizes = binning.normalize_bins(unnormalized, num_bins, min_size)
    cum = binning.pad_zero_left(torch.cumsum(sizes, dim=-1))
    cum = (hi - lo) * cum + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], hi)], dim=-1)
    return cum[..., 1:] - cum[..., :-1], cum


def _spline(inputs, unnormalized_widths, unnormalized_heights, derivatives,
            inverse, left, right, bottom, top, min_bin_width, min_bin_height):
    """RQ spline from normalised derivatives [..., K+1]."""
    num_bins = unnormalized_widths.shape[-1]
    if min_bin_width * num_bins > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * num_bins > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")

    inputs = inputs.clamp(bottom, top) if inverse else inputs.clamp(left, right)
    widths, cumwidths = _edges(unnormalized_widths, num_bins, min_bin_width,
                               left, right)
    heights, cumheights = _edges(unnormalized_heights, num_bins,
                                 min_bin_height, bottom, top)

    idx = binning.bin_index(cumheights if inverse else cumwidths, inputs)
    input_cumwidths = binning.select_bin(cumwidths[..., :-1], idx)
    input_bin_widths = binning.select_bin(widths, idx)
    input_cumheights = binning.select_bin(cumheights[..., :-1], idx)
    input_delta = binning.select_bin(heights / widths, idx)
    # only entries 0..K are reachable by the bin index (reference gather)
    input_derivatives = binning.select_bin(derivatives[..., :num_bins], idx)
    input_derivatives_plus_one = binning.select_bin(
        derivatives[..., 1:num_bins + 1], idx)
    input_heights = binning.select_bin(heights, idx)

    d_sum = input_derivatives + input_derivatives_plus_one - 2 * input_delta

    if inverse:
        y_rel = inputs - input_cumheights
        a = y_rel * d_sum + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - y_rel * d_sum
        c = -input_delta * y_rel
        discriminant = (b ** 2 - 4 * a * c).clamp_min(0.0)
        theta = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = theta * input_bin_widths + input_cumwidths
    else:
        theta = (inputs - input_cumwidths) / input_bin_widths
        numerator = input_heights * (
            input_delta * theta ** 2 + input_derivatives * theta * (1 - theta))
        denominator = input_delta + d_sum * theta * (1 - theta)
        outputs = input_cumheights + numerator / denominator

    theta_one_minus_theta = theta * (1 - theta)
    denominator = input_delta + d_sum * theta_one_minus_theta
    derivative_numerator = input_delta ** 2 * (
        input_derivatives_plus_one * theta ** 2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2
    )
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, (-logabsdet if inverse else logabsdet)


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
    enable_identity_init: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RQ spline on [left,right] -> [bottom,top]; K+1 derivative params.

    inputs [...]; widths/heights [..., K]; derivatives [..., K+1].
    Returns (outputs [...], logabsdet [...]) -- per-element logabsdet.
    """
    # beta chosen so zero params give the identity map (reference rq.py:100-104)
    beta = float(np.log(2.0) / (1.0 - min_derivative)) if enable_identity_init else 1.0
    derivatives = min_derivative + _softplus(unnormalized_derivatives, beta=beta)
    return _spline(inputs, unnormalized_widths, unnormalized_heights,
                   derivatives, inverse, left, right, bottom, top,
                   min_bin_width, min_bin_height)


def linear_tails_spline(inputs, unnormalized_widths, unnormalized_heights,
                        derivatives, inverse, tail_bound, min_bin_width,
                        min_bin_height):
    """RQ spline on [-B, B] from normalised derivatives [..., K+1], identity
    with zero logabsdet outside."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    spline_out, spline_lad = _spline(
        inputs.clamp(-tail_bound, tail_bound), unnormalized_widths,
        unnormalized_heights, derivatives, inverse,
        -tail_bound, tail_bound, -tail_bound, tail_bound,
        min_bin_width, min_bin_height)
    outputs = torch.where(inside, spline_out, inputs)
    logabsdet = torch.where(inside, spline_lad, torch.zeros_like(spline_lad))
    return outputs, logabsdet


def boundary_constant(min_derivative: float) -> float:
    """Unnormalised derivative whose softplus makes the boundary slope 1."""
    return float(np.log(np.exp(1 - min_derivative) - 1))


def unconstrained_rational_quadratic_spline_plain(
    inputs, unnormalized_widths, unnormalized_heights,
    unnormalized_derivatives, inverse=False, tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH, min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE, enable_identity_init=False,
):
    """Linear-tail RQ spline in plain PyTorch (kernel B1's plain version):
    derivative params padded with the constant making boundary slopes 1."""
    unnormalized_derivatives = F.pad(
        unnormalized_derivatives, (1, 1),
        value=boundary_constant(min_derivative))
    beta = float(np.log(2.0) / (1.0 - min_derivative)) if enable_identity_init else 1.0
    derivatives = min_derivative + _softplus(unnormalized_derivatives, beta=beta)
    return linear_tails_spline(
        inputs, unnormalized_widths, unnormalized_heights, derivatives,
        inverse, tail_bound, min_bin_width, min_bin_height)


def unconstrained_rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tails: str = "linear",
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
    enable_identity_init: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RQ spline on [-B, B] with identity (linear) tails outside
    (reference rational_quadratic.py:13-63).

    On a CUDA tensor with K-1 derivative params and no identity init this
    runs kernel B1 (ops/cuda/rq_spline.py); otherwise the plain version."""
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented.")
    if (
        inputs.is_cuda
        and not enable_identity_init
        and unnormalized_derivatives.shape[-1] == unnormalized_widths.shape[-1] - 1
    ):
        from nflows_tpu_torch.ops.cuda.rq_spline import rq_spline_cuda
        return rq_spline_cuda(
            inputs.contiguous(), unnormalized_widths.contiguous(),
            unnormalized_heights.contiguous(),
            unnormalized_derivatives.contiguous(), inverse=inverse,
            tail_bound=tail_bound, min_bin_width=min_bin_width,
            min_bin_height=min_bin_height, min_derivative=min_derivative,
        )
    return unconstrained_rational_quadratic_spline_plain(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=inverse, tail_bound=tail_bound,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative,
        enable_identity_init=enable_identity_init)
