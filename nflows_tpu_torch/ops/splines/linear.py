"""Piecewise-linear spline (Neural Importance Sampling, Müller et al. 2018),
plain PyTorch (counterpart of nflows_tpu/ops/splines/linear.py; reference
nflows/transforms/splines/linear.py).

K equal-width bins with a softmax pdf; the forward finds its bin from
``floor(x K)``, the inverse by searching the CDF, whose last knot is pinned
to exactly 1. Out-of-domain inputs to the constrained spline clamp to the
boundary instead of raising.

This is also the plain version of kernel B6: on a CUDA tensor
:func:`unconstrained_linear_spline` hands the work to B6
(``ops/cuda/linear_spline.py``). :func:`linear_spline_forward_adjoint_plain`
is the plain version of the forward branch's adjoint that the training
kernels B3 and B4 run (``csrc/linear_spline_bwd.cuh``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nflows_tpu_torch.ops import binning

__all__ = ["linear_spline", "unconstrained_linear_spline",
           "unconstrained_linear_spline_plain", "linear_spline_forward_adjoint_plain"]


def linear_spline(
    inputs: torch.Tensor,
    unnormalized_pdf: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear spline with K equal-width bins and softmax-normalised pdf.

    inputs [...]; unnormalized_pdf [..., K].
    """
    if inverse:
        inputs = (inputs.clamp(bottom, top) - bottom) / (top - bottom)
    else:
        inputs = (inputs.clamp(left, right) - left) / (right - left)

    num_bins = unnormalized_pdf.shape[-1]
    pdf = torch.softmax(unnormalized_pdf, dim=-1)
    cdf = binning.unit_knots(pdf)

    if inverse:
        idx = binning.bin_index(cdf, inputs)
        # equal-width bins: slope_k = pdf_k K, offset_k = cdf_{k+1} - slope_k (k+1)/K
        boundaries = torch.arange(1, num_bins + 1, dtype=inputs.dtype,
                                  device=inputs.device) / num_bins
        slopes = (cdf[..., 1:] - cdf[..., :-1]) * num_bins
        offsets = cdf[..., 1:] - slopes * boundaries
        input_slopes = binning.select_bin(slopes, idx)
        input_offsets = binning.select_bin(offsets, idx)
        outputs = ((inputs - input_offsets) / input_slopes).clamp(0.0, 1.0)
        logabsdet = -torch.log(input_slopes)
    else:
        bin_pos = inputs * num_bins
        idx = torch.floor(bin_pos).long().clamp(0, num_bins - 1)
        alpha = bin_pos - idx.to(inputs.dtype)
        input_pdfs = binning.select_bin(pdf, idx)
        outputs = (binning.select_bin(cdf[..., :-1], idx)
                   + alpha * input_pdfs).clamp(0.0, 1.0)
        logabsdet = torch.log(input_pdfs) - float(np.log(1.0 / num_bins))

    if inverse:
        outputs = outputs * (right - left) + left
    else:
        outputs = outputs * (top - bottom) + bottom
    return outputs, logabsdet


def unconstrained_linear_spline_plain(inputs, unnormalized_pdf, inverse=False,
                                      tail_bound=1.0):
    """Linear spline on [-B, B], identity with zero logabsdet outside, in
    plain PyTorch (kernel B6's plain version)."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    spline_out, spline_lad = linear_spline(
        inputs.clamp(-tail_bound, tail_bound), unnormalized_pdf,
        inverse=inverse, left=-tail_bound, right=tail_bound,
        bottom=-tail_bound, top=tail_bound)
    outputs = torch.where(inside, spline_out, inputs)
    logabsdet = torch.where(inside, spline_lad, torch.zeros_like(spline_lad))
    return outputs, logabsdet


def unconstrained_linear_spline(
    inputs: torch.Tensor,
    unnormalized_pdf: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    tails: str = "linear",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear spline on [-B, B], identity outside (reference linear.py:9-36).

    On a CUDA tensor this runs kernel B6 (ops/cuda/linear_spline.py);
    otherwise the plain version."""
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented.")
    if inputs.is_cuda:
        from nflows_tpu_torch.ops.cuda.linear_spline import linear_spline_cuda
        return linear_spline_cuda(inputs.contiguous(), unnormalized_pdf.contiguous(),
                                  inverse=inverse, tail_bound=tail_bound)
    return unconstrained_linear_spline_plain(inputs, unnormalized_pdf,
                                             inverse=inverse, tail_bound=tail_bound)


def linear_spline_forward_adjoint_plain(inputs, unnormalized_pdf, grad_outputs,
                                        grad_logabsdet, tail_bound=1.0, wh_scale=1.0):
    """Adjoint of the linear-tail linear spline's forward branch by explicit
    formulas (no autograd): the plain version of
    ``csrc/linear_spline_bwd.cuh``, which repeats this arithmetic line for
    line.

    inputs [...]; unnormalized_pdf [..., K]; the cotangents of the outputs
    and of the per-element logabsdet [...]. ``wh_scale`` multiplies the
    parameter cotangents: the factor the caller applied to the parameters
    before the spline read them. Returns (g_inputs [...], g_pdf [..., K]).

    The output is cdf_idx + alpha pdf_idx on the unit interval, clipped to
    [0, 1] (a clipped output carries no gradient), with idx = floor(u K)
    piecewise constant; the logabsdet is log(pdf_idx) - log(1/K). The
    softmax sends the cotangents of the bins below idx (through the cdf)
    and of bin idx to every parameter. Outside [-B, B] the layer is the
    identity.
    """
    x_orig, up = inputs, unnormalized_pdf
    K = up.shape[-1]
    B = float(tail_bound)
    inside = (x_orig >= -B) & (x_orig <= B)
    x = (x_orig.clamp(-B, B) + B) / (2.0 * B)
    e = torch.exp(up - up.max(dim=-1, keepdim=True).values)
    pdf = e / e.sum(dim=-1, keepdim=True)           # softmax, [..., K]

    bin_pos = x * K
    idx = torch.floor(bin_pos).clamp(0.0, K - 1.0)
    alpha = bin_pos - idx
    idx = idx.long()
    ks = torch.arange(K, device=x.device)
    below = ks < idx[..., None]
    cdf = torch.where(below, pdf, torch.zeros_like(pdf)).sum(dim=-1)
    sel_pdf = binning.select_bin(pdf, idx)
    raw = cdf + alpha * sel_pdf

    zero = torch.zeros_like(x)
    g_y = torch.where(inside, grad_outputs, zero)
    g_l = torch.where(inside, grad_logabsdet, zero)
    g_raw = torch.where((raw >= 0.0) & (raw <= 1.0), g_y * (2.0 * B), zero)
    g_pdf = g_raw * alpha + g_l / sel_pdf           # cotangent of pdf_idx
    g_x01 = g_raw * sel_pdf * K

    # softmax adjoint: g_cdf = g_raw goes to every bin below idx
    dot = g_raw * cdf + g_pdf * sel_pdf
    g_soft = (torch.where(below, g_raw[..., None], zero[..., None])
              + torch.where(ks == idx[..., None], g_pdf[..., None], zero[..., None]))
    g_up = wh_scale * pdf * (g_soft - dot[..., None])
    g_x = torch.where(inside, g_x01 / (2.0 * B), grad_outputs)
    return g_x, g_up
