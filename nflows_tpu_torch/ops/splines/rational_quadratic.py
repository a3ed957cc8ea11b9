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
    "rq_spline_forward_adjoint_plain",
    "DEFAULT_MIN_BIN_WIDTH",
    "DEFAULT_MIN_BIN_HEIGHT",
    "DEFAULT_MIN_DERIVATIVE",
]

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _softplus(x, beta=1.0):
    if beta == 1.0:
        return binning.softplus(x)
    return binning.softplus(beta * x) / beta


def _spline(inputs, unnormalized_widths, unnormalized_heights, derivatives,
            inverse, left, right, bottom, top, min_bin_width, min_bin_height):
    """RQ spline from normalised derivatives [..., K+1]."""
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


def rq_spline_forward_adjoint_plain(
    inputs, unnormalized_widths, unnormalized_heights,
    unnormalized_derivatives, grad_outputs, grad_logabsdet, tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH, min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE, edge_derivative=1.0,
):
    """Adjoint of the linear-tail RQ spline's forward branch by explicit
    formulas (no autograd): the plain version of
    ``csrc/rq_spline_bwd.cuh``, which repeats this arithmetic line for line.

    inputs [...]; widths and heights [..., K]; interior derivatives
    [..., K-1]; the cotangents of the outputs and of the per-element
    logabsdet [...]. The slopes at +-B are the constant ``edge_derivative``.
    Returns (g_inputs [...], g_widths [..., K], g_heights [..., K],
    g_derivatives [..., K-1]).

    The forward being differentiated walks the bins by running sums of
    ``min + (1 - K min) softmax`` sizes with the last edge pinned to +B, so
    the selected bin's lower edge and size carry their cotangents to every
    bin at or below it; outside [-B, B] the layer is the identity.
    """
    x_orig = inputs
    uw, uh, ud = unnormalized_widths, unnormalized_heights, unnormalized_derivatives
    K = uw.shape[-1]
    B = float(tail_bound)
    inside = (x_orig >= -B) & (x_orig <= B)
    x = x_orig.clamp(-B, B)

    wmax = uw.max(dim=-1, keepdim=True).values
    hmax = uh.max(dim=-1, keepdim=True).values
    ew, eh = torch.exp(uw - wmax), torch.exp(uh - hmax)
    sw = ew / ew.sum(dim=-1, keepdim=True)          # softmax, [..., K]
    sh = eh / eh.sum(dim=-1, keepdim=True)
    wmix = 1.0 - min_bin_width * K
    hmix = 1.0 - min_bin_height * K
    two_b = 2.0 * B

    # walk the bins as the forward does: edge_lo is edge k, edge_hi edge k+1
    runw = torch.zeros_like(x)
    runh = torch.zeros_like(x)
    ew_lo = torch.full_like(x, -B)
    eh_lo = torch.full_like(x, -B)
    sel = torch.zeros_like(x, dtype=torch.int64)
    sel_cw = ew_lo.clone()
    sel_xw, sel_xh = torch.zeros_like(x), torch.zeros_like(x)
    for k in range(K):
        runw = runw + (min_bin_width + wmix * sw[..., k])
        runh = runh + (min_bin_height + hmix * sh[..., k])
        ew_hi = torch.full_like(x, B) if k == K - 1 else two_b * runw - B
        eh_hi = torch.full_like(x, B) if k == K - 1 else two_b * runh - B
        take = (x >= ew_lo) if k else torch.ones_like(inside)
        sel = torch.where(take, torch.full_like(sel, k), sel)
        sel_cw = torch.where(take, ew_lo, sel_cw)
        sel_xw = torch.where(take, ew_hi - ew_lo, sel_xw)
        sel_xh = torch.where(take, eh_hi - eh_lo, sel_xh)
        ew_lo, eh_lo = ew_hi, eh_hi

    first, last = sel == 0, sel == K - 1
    edge = torch.full_like(x, edge_derivative)
    ud_lo = torch.gather(ud, -1, (sel - 1).clamp_min(0)[..., None])[..., 0]
    ud_hi = torch.gather(ud, -1, sel.clamp_max(K - 2)[..., None])[..., 0]
    d0 = torch.where(first, edge, min_derivative + _softplus(ud_lo))
    d1 = torch.where(last, edge, min_derivative + _softplus(ud_hi))

    delta = sel_xh / sel_xw
    d_sum = d0 + d1 - 2.0 * delta
    theta = (x - sel_cw) / sel_xw
    omt = 1.0 - theta
    tomt = theta * omt
    nn = delta * theta * theta + d0 * tomt          # numerator / bin height
    num = sel_xh * nn
    den = delta + d_sum * tomt
    ss = d1 * theta * theta + 2.0 * delta * tomt + d0 * omt * omt
    deriv_num = delta * delta * ss

    # cotangents of num, den and deriv_num (y = ch + num / den,
    # lad = log(deriv_num) - 2 log(den)); nothing flows outside [-B, B]
    zero = torch.zeros_like(x)
    g_y = torch.where(inside, grad_outputs, zero)
    g_l = torch.where(inside, grad_logabsdet, zero)
    g_num = g_y / den
    g_den = -g_y * num / (den * den) - 2.0 * g_l / den
    g_dn = g_l / deriv_num
    one_m2t = 1.0 - 2.0 * theta
    g_delta = (g_num * sel_xh * theta * theta + g_den * (1.0 - 2.0 * tomt)
               + g_dn * (2.0 * delta * ss + 2.0 * delta * delta * tomt))
    g_d0 = g_num * sel_xh * tomt + g_den * tomt + g_dn * delta * delta * omt * omt
    g_d1 = g_den * tomt + g_dn * delta * delta * theta * theta
    g_theta = (g_num * sel_xh * (2.0 * delta * theta + d0 * one_m2t)
               + g_den * d_sum * one_m2t
               + g_dn * delta * delta * (2.0 * d1 * theta + 2.0 * delta * one_m2t
                                         - 2.0 * d0 * omt))
    g_xh = g_num * nn + g_delta / sel_xw
    g_xw = -(g_delta * delta + g_theta * theta) / sel_xw
    g_xin = g_theta / sel_xw
    g_cw = -g_xin
    g_ch = g_y

    # edges: edge[sel] carries g_c - g_x, edge[sel + 1] carries g_x; the
    # edges -B and +B are constants; interior edge m is 2B * (sizes of the
    # bins below m) - B
    def sizes_adjoint(g_c, g_x, soft, mix):
        lo = torch.where(first, zero, g_c - g_x)    # to bins j < sel
        hi = torch.where(last, zero, g_x)           # to bins j <= sel
        ks = torch.arange(K, device=x.device)
        g_soft = (two_b * mix) * (
            torch.where(ks < sel[..., None], lo[..., None], zero[..., None])
            + torch.where(ks <= sel[..., None], hi[..., None], zero[..., None]))
        dot = (g_soft * soft).sum(dim=-1, keepdim=True)
        return soft * (g_soft - dot)                # softmax adjoint

    g_uw = sizes_adjoint(g_cw, g_xw, sw, wmix)
    g_uh = sizes_adjoint(g_ch, g_xh, sh, hmix)

    # interior derivatives: softplus' = sigmoid
    g_ud = torch.zeros_like(ud)
    g_ud.scatter_add_(-1, (sel - 1).clamp_min(0)[..., None],
                      torch.where(first, zero, g_d0 * torch.sigmoid(ud_lo))[..., None])
    g_ud.scatter_add_(-1, sel.clamp_max(K - 2)[..., None],
                      torch.where(last, zero, g_d1 * torch.sigmoid(ud_hi))[..., None])

    g_x = torch.where(inside, g_xin, grad_outputs)
    return g_x, g_uw, g_uh, g_ud
