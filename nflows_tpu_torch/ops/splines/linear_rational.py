"""Monotonic linear-rational spline (Dolatabadi et al. 2020,
arXiv:2001.05168), plain PyTorch (counterpart of
nflows_tpu/ops/splines/linear_rational.py, where the derivation is written
out).

Each bin maps through two monotone Möbius pieces joined C1-continuously at
a split point lambda in (0, 1); the inverse of each piece is linear in
theta. Both pieces are evaluated on inputs clamped into their own range
before the select, so the piece not taken stays finite and its zero
gradient stays zero.

This is also the plain version of kernel B5: on a CUDA tensor with K-1
derivative parameters, :func:`unconstrained_linear_rational_spline` hands
the work to B5 (``ops/cuda/lrs_spline.py``), as the JAX function hands it
to its Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from nflows_tpu_torch.ops import binning
from nflows_tpu_torch.ops.splines.rational_quadratic import boundary_constant

__all__ = [
    "linear_rational_spline",
    "unconstrained_linear_rational_spline",
    "unconstrained_linear_rational_spline_plain",
    "DEFAULT_MIN_BIN_WIDTH",
    "DEFAULT_MIN_BIN_HEIGHT",
    "DEFAULT_MIN_DERIVATIVE",
    "DEFAULT_MIN_LAMBDA",
]

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3
DEFAULT_MIN_LAMBDA = 0.025


def linear_rational_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    unnormalized_lambdas: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
    min_lambda: float = DEFAULT_MIN_LAMBDA,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LRS on [left,right] -> [bottom,top].

    inputs [...]; widths/heights/lambdas [..., K]; derivatives [..., K+1].
    Returns (outputs [...], logabsdet [...]) -- per-element logabsdet.
    """
    num_bins = unnormalized_widths.shape[-1]
    if min_bin_width * num_bins > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * num_bins > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")

    inputs = inputs.clamp(bottom, top) if inverse else inputs.clamp(left, right)
    widths, cumwidths = binning.edges_on(unnormalized_widths, num_bins,
                                         min_bin_width, left, right)
    heights, cumheights = binning.edges_on(unnormalized_heights, num_bins,
                                           min_bin_height, bottom, top)
    derivatives = min_derivative + binning.softplus(unnormalized_derivatives)
    lambdas = min_lambda + (1.0 - 2.0 * min_lambda) * torch.sigmoid(
        unnormalized_lambdas)

    idx = binning.bin_index(cumheights if inverse else cumwidths, inputs)
    x0 = binning.select_bin(cumwidths[..., :-1], idx)
    w = binning.select_bin(widths, idx)
    y0 = binning.select_bin(cumheights[..., :-1], idx)
    h = binning.select_bin(heights, idx)
    d0 = binning.select_bin(derivatives[..., :num_bins], idx)
    d1 = binning.select_bin(derivatives[..., 1:num_bins + 1], idx)
    lam = binning.select_bin(lambdas, idx)
    y1 = y0 + h

    # weights of the two Möbius pieces (wa = 1)
    wb = torch.sqrt(d0 / d1)
    ym = ((1.0 - lam) * y0 + lam * wb * y1) / ((1.0 - lam) + lam * wb)
    wm = d0 * lam * w / (ym - y0)

    if inverse:
        y = inputs
        use_a = y <= ym
        y_a = torch.minimum(y, ym)
        y_b = torch.maximum(y, ym)
        theta_a_inv = lam * (y_a - y0) / (wm * (ym - y_a) + (y_a - y0))
        den_b_inv = wm * (ym - y_b) + wb * (y_b - y1)
        theta_b_inv = (wm * (ym - y_b) + wb * lam * (y_b - y1)) / den_b_inv
        theta = torch.where(use_a, theta_a_inv, theta_b_inv)
    else:
        theta = (inputs - x0) / w
        use_a = theta <= lam

    theta_a = torch.minimum(theta, lam)
    theta_b = torch.maximum(theta, lam)
    den_a = (lam - theta_a) + wm * theta_a
    den_b = wm * (1.0 - theta_b) + wb * (theta_b - lam)

    if inverse:
        outputs = x0 + theta * w
    else:
        out_a = (y0 * (lam - theta_a) + wm * ym * theta_a) / den_a
        out_b = (wm * ym * (1.0 - theta_b) + wb * y1 * (theta_b - lam)) / den_b
        outputs = torch.where(use_a, out_a, out_b)

    log_deriv_a = (torch.log(wm) + torch.log(lam) + torch.log(ym - y0)
                   - 2.0 * torch.log(den_a) - torch.log(w))
    log_deriv_b = (torch.log(wm) + torch.log(wb) + torch.log1p(-lam)
                   + torch.log(y1 - ym) - 2.0 * torch.log(den_b) - torch.log(w))
    logabsdet = torch.where(use_a, log_deriv_a, log_deriv_b)
    return outputs, (-logabsdet if inverse else logabsdet)


def unconstrained_linear_rational_spline_plain(
    inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
    unnormalized_lambdas, inverse=False, tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH, min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE, min_lambda=DEFAULT_MIN_LAMBDA,
):
    """Linear-tail LRS in plain PyTorch (kernel B5's plain version):
    derivative params padded with the constant making boundary slopes 1."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    unnormalized_derivatives = F.pad(
        unnormalized_derivatives, (1, 1), value=boundary_constant(min_derivative))
    spline_out, spline_lad = linear_rational_spline(
        inputs.clamp(-tail_bound, tail_bound), unnormalized_widths,
        unnormalized_heights, unnormalized_derivatives, unnormalized_lambdas,
        inverse=inverse, left=-tail_bound, right=tail_bound,
        bottom=-tail_bound, top=tail_bound, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative,
        min_lambda=min_lambda)
    outputs = torch.where(inside, spline_out, inputs)
    logabsdet = torch.where(inside, spline_lad, torch.zeros_like(spline_lad))
    return outputs, logabsdet


def unconstrained_linear_rational_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    unnormalized_lambdas: torch.Tensor,
    inverse: bool = False,
    tails: str = "linear",
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
    min_lambda: float = DEFAULT_MIN_LAMBDA,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LRS on [-B, B] with identity tails; derivative params [..., K-1] are
    padded so the boundary derivatives are exactly 1.

    On a CUDA tensor with K-1 derivative params this runs kernel B5
    (ops/cuda/lrs_spline.py); otherwise the plain version."""
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented.")
    kw = dict(inverse=inverse, tail_bound=tail_bound,
              min_bin_width=min_bin_width, min_bin_height=min_bin_height,
              min_derivative=min_derivative, min_lambda=min_lambda)
    if (inputs.is_cuda
            and unnormalized_derivatives.shape[-1] == unnormalized_widths.shape[-1] - 1):
        from nflows_tpu_torch.ops.cuda.lrs_spline import lrs_spline_cuda
        return lrs_spline_cuda(
            inputs.contiguous(), unnormalized_widths.contiguous(),
            unnormalized_heights.contiguous(),
            unnormalized_derivatives.contiguous(),
            unnormalized_lambdas.contiguous(), **kw)
    return unconstrained_linear_rational_spline_plain(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, unnormalized_lambdas, **kw)
