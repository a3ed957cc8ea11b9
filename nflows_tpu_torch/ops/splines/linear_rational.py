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
to its Pallas kernel. :func:`linear_rational_spline_forward_adjoint_plain`
is the plain version of the forward branch's adjoint that the training
kernels B3 and B4 run (``csrc/lrs_spline_bwd.cuh``).
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
    "linear_rational_spline_forward_adjoint_plain",
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


def linear_rational_spline_forward_adjoint_plain(
    inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
    unnormalized_lambdas, grad_outputs, grad_logabsdet, tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH, min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE, min_lambda=DEFAULT_MIN_LAMBDA,
    edge_derivative=None, wh_scale=1.0,
):
    """Adjoint of the linear-tail LRS's forward branch by explicit formulas
    (no autograd): the plain version of ``csrc/lrs_spline_bwd.cuh``, which
    repeats this arithmetic line for line.

    inputs [...]; widths, heights and lambdas [..., K]; interior
    derivatives [..., K-1]; the cotangents of the outputs and of the
    per-element logabsdet [...]. The slopes at +-B are ``edge_derivative``
    (None: min_derivative + softplus of the padding constant, as
    :func:`unconstrained_linear_rational_spline_plain` computes them).
    ``wh_scale`` multiplies the width and height cotangents (the factor the
    caller applied to those parameters). Returns (g_inputs [...],
    g_widths [..., K], g_heights [..., K], g_derivatives [..., K-1],
    g_lambdas [..., K]).

    What flows where. theta = (x - x0) / w picks the Möbius piece at
    lambda; the piece's output and its logabsdet (four or five log terms)
    depend on y0, the height, lambda, and the weights wb = sqrt(d0 / d1)
    and wm = d0 lambda w / (ym - y0) through the join ym. The bin's edges
    and sizes carry their cotangents to the softmax as in the RQ spline's
    adjoint; the two end slopes are softplus of an interior derivative or
    the constant at +-B; lambda is a sigmoid. Outside [-B, B] the layer is
    the identity.
    """
    x_orig = inputs
    uw, uh, ud, ul = (unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
                      unnormalized_lambdas)
    K = uw.shape[-1]
    B = float(tail_bound)
    if edge_derivative is None:
        edge_derivative = min_derivative + float(binning.softplus(
            torch.tensor(boundary_constant(min_derivative), dtype=torch.float64)))
    inside = (x_orig >= -B) & (x_orig <= B)
    x = x_orig.clamp(-B, B)
    ew = torch.exp(uw - uw.max(dim=-1, keepdim=True).values)
    eh = torch.exp(uh - uh.max(dim=-1, keepdim=True).values)
    sw = ew / ew.sum(dim=-1, keepdim=True)          # softmax, [..., K]
    sh = eh / eh.sum(dim=-1, keepdim=True)
    wmix = 1.0 - min_bin_width * K
    hmix = 1.0 - min_bin_height * K
    two_b = 2.0 * B

    # the forward's walk over the bins
    zero = torch.zeros_like(x)
    runw, runh = zero, zero
    ew_lo, eh_lo = torch.full_like(x, -B), torch.full_like(x, -B)
    sel = torch.zeros_like(x, dtype=torch.int64)
    x0, y0, w, h = ew_lo, eh_lo, zero, zero
    for k in range(K):
        runw = runw + (min_bin_width + wmix * sw[..., k])
        runh = runh + (min_bin_height + hmix * sh[..., k])
        ew_hi = torch.full_like(x, B) if k == K - 1 else two_b * runw - B
        eh_hi = torch.full_like(x, B) if k == K - 1 else two_b * runh - B
        take = (x >= ew_lo) if k else torch.ones_like(inside)
        sel = torch.where(take, torch.full_like(sel, k), sel)
        x0 = torch.where(take, ew_lo, x0)
        y0 = torch.where(take, eh_lo, y0)
        w = torch.where(take, ew_hi - ew_lo, w)
        h = torch.where(take, eh_hi - eh_lo, h)
        ew_lo, eh_lo = ew_hi, eh_hi

    first, last = sel == 0, sel == K - 1
    edge = torch.full_like(x, edge_derivative)
    ud_lo = torch.gather(ud, -1, (sel - 1).clamp_min(0)[..., None])[..., 0]
    ud_hi = torch.gather(ud, -1, sel.clamp_max(K - 2)[..., None])[..., 0]
    d0 = torch.where(first, edge, min_derivative + binning.softplus(ud_lo))
    d1 = torch.where(last, edge, min_derivative + binning.softplus(ud_hi))
    sig_l = torch.sigmoid(binning.select_bin(ul, sel))
    lam = min_lambda + (1.0 - 2.0 * min_lambda) * sig_l

    y1 = y0 + h
    wb = torch.sqrt(d0 / d1)
    q_num = (1.0 - lam) * y0 + lam * wb * y1
    q_den = (1.0 - lam) + lam * wb
    ym = q_num / q_den
    r = ym - y0
    wm = d0 * lam * w / r
    theta = (x - x0) / w
    use_a = theta <= lam

    # the two pieces and their cotangents; theta is the clamped theta of
    # the piece taken
    g_y = torch.where(inside, grad_outputs, zero)
    g_l = torch.where(inside, grad_logabsdet, zero)
    den_a = (lam - theta) + wm * theta
    num_a = y0 * (lam - theta) + wm * ym * theta
    den_b = wm * (1.0 - theta) + wb * (theta - lam)
    num_b = wm * ym * (1.0 - theta) + wb * y1 * (theta - lam)
    den = torch.where(use_a, den_a, den_b)
    y = torch.where(use_a, num_a, num_b) / den
    g_num = g_y / den
    g_den = -g_y * y / den - 2.0 * g_l / den
    # the log terms common to both: log(wm) - log(w)
    g_wm = g_l / wm
    g_w = -g_l / w
    # piece a: log(lam) + log(ym - y0); piece b: log(wb) + log1p(-lam) + log(y1 - ym)
    g_lam = torch.where(use_a, g_l / lam, -g_l / (1.0 - lam))
    g_ym = torch.where(use_a, g_l / r, -g_l / (y1 - ym))
    g_y0 = torch.where(use_a, -g_l / r, zero)
    g_y1 = torch.where(use_a, zero, g_l / (y1 - ym))
    g_wb = torch.where(use_a, zero, g_l / wb)
    # the numerators and denominators
    g_y0 = g_y0 + torch.where(use_a, g_num * (lam - theta), zero)
    g_lam = g_lam + torch.where(use_a, g_num * y0 + g_den,
                                -g_num * wb * y1 - g_den * wb)
    g_theta = torch.where(use_a, g_num * (wm * ym - y0) + g_den * (wm - 1.0),
                          g_num * (wb * y1 - wm * ym) + g_den * (wb - wm))
    g_wm = g_wm + torch.where(use_a, g_num * ym * theta + g_den * theta,
                              g_num * ym * (1.0 - theta) + g_den * (1.0 - theta))
    g_ym = g_ym + torch.where(use_a, g_num * wm * theta, g_num * wm * (1.0 - theta))
    g_wb = g_wb + torch.where(use_a, zero, (g_num * y1 + g_den) * (theta - lam))
    g_y1 = g_y1 + torch.where(use_a, zero, g_num * wb * (theta - lam))

    # theta = (x - x0) / w
    g_xin = g_theta / w
    g_x0 = -g_xin
    g_w = g_w - g_theta * theta / w
    # wm = d0 lam w / r, r = ym - y0
    g_d0 = g_wm * lam * w / r
    g_lam = g_lam + g_wm * d0 * w / r
    g_w = g_w + g_wm * d0 * lam / r
    g_ym = g_ym - g_wm * wm / r
    g_y0 = g_y0 + g_wm * wm / r
    # ym = q_num / q_den
    g_qn = g_ym / q_den
    g_qd = -g_ym * ym / q_den
    g_lam = g_lam + g_qn * (wb * y1 - y0) + g_qd * (wb - 1.0)
    g_y0 = g_y0 + g_qn * (1.0 - lam)
    g_wb = g_wb + g_qn * lam * y1 + g_qd * lam
    g_y1 = g_y1 + g_qn * lam * wb
    # wb = sqrt(d0 / d1); y1 = y0 + h
    g_d0 = g_d0 + g_wb * wb / (2.0 * d0)
    g_d1 = -g_wb * wb / (2.0 * d1)
    g_y0 = g_y0 + g_y1
    g_h = g_y1

    # edges: edge[sel] carries g_x0 - g_w, edge[sel + 1] carries g_w (as the
    # RQ spline's adjoint); the edges -B and +B are constants
    def sizes_adjoint(g_c, g_size, soft, mix):
        lo = torch.where(first, zero, g_c - g_size)  # to bins j < sel
        hi = torch.where(last, zero, g_size)         # to bins j <= sel
        ks = torch.arange(K, device=x.device)
        g_soft = (two_b * mix) * (
            torch.where(ks < sel[..., None], lo[..., None], zero[..., None])
            + torch.where(ks <= sel[..., None], hi[..., None], zero[..., None]))
        dot = (g_soft * soft).sum(dim=-1, keepdim=True)
        return wh_scale * soft * (g_soft - dot)      # softmax adjoint

    g_uw = sizes_adjoint(g_x0, g_w, sw, wmix)
    g_uh = sizes_adjoint(g_y0, g_h, sh, hmix)

    # interior derivatives: softplus' = sigmoid; lambda: a sigmoid
    g_ud = torch.zeros_like(ud)
    g_ud.scatter_add_(-1, (sel - 1).clamp_min(0)[..., None],
                      torch.where(first, zero, g_d0 * torch.sigmoid(ud_lo))[..., None])
    g_ud.scatter_add_(-1, sel.clamp_max(K - 2)[..., None],
                      torch.where(last, zero, g_d1 * torch.sigmoid(ud_hi))[..., None])
    g_ul = torch.zeros_like(ul)
    g_ul.scatter_(-1, sel[..., None],
                  (g_lam * (1.0 - 2.0 * min_lambda) * sig_l * (1.0 - sig_l))[..., None])

    g_x = torch.where(inside, g_xin, grad_outputs)
    return g_x, g_uw, g_uh, g_ud, g_ul
