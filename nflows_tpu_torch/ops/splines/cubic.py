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
(``ops/cuda/cubic_spline.py``). :func:`cubic_spline_forward_adjoint_plain`
is the plain version of the forward branch's adjoint that the training
kernels B3 and B4 run (``csrc/cubic_spline_bwd.cuh``); the inverse needs
none, the training kernels running the forward only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nflows_tpu_torch.ops import binning

__all__ = [
    "cubic_spline",
    "unconstrained_cubic_spline",
    "unconstrained_cubic_spline_plain",
    "cubic_spline_forward_adjoint_plain",
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


def cubic_spline_forward_adjoint_plain(
    inputs, unnormalized_widths, unnormalized_heights, unnorm_derivatives_left,
    unnorm_derivatives_right, grad_outputs, grad_logabsdet, tail_bound=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH, min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    wh_scale=1.0,
):
    """Adjoint of the linear-tail cubic spline's forward branch by explicit
    formulas (no autograd): the plain version of
    ``csrc/cubic_spline_bwd.cuh``, which repeats this arithmetic line for
    line.

    inputs [...]; widths and heights [..., K]; the two boundary-derivative
    parameters [..., 1]; the cotangents of the outputs and of the
    per-element logabsdet [...]. ``wh_scale`` multiplies the width and
    height cotangents (the factor the caller applied to those parameters),
    not the boundary ones. Returns (g_inputs [...], g_widths [..., K],
    g_heights [..., K], g_left [..., 1], g_right [..., 1]).

    What flows where. The selected bin's cubic a t^3 + b t^2 + c t + d
    (clipped to [0, 1]; a clipped output carries no gradient) and its
    logabsdet log(3 a t^2 + 2 b t + c) depend on the bin's width and slope,
    the knot derivatives at both its ends, and the widths and heights below
    it (t's origin and d). A knot derivative is Steffen's
    min(min(|s_{k-1}|, |s_k|), m2) (sign(s_{k-1}) + sign(s_k)): its
    cotangent follows the branch the min took, to the slopes and widths of
    the two bins beside the knot; at the ends it is 3 sigmoid(p) times the
    end bin's slope. Slopes are h / w. The softmax then sends every width
    and height cotangent to all K parameters.
    """
    x_orig, uw, uh = inputs, unnormalized_widths, unnormalized_heights
    dl, dr = unnorm_derivatives_left[..., 0], unnorm_derivatives_right[..., 0]
    K = uw.shape[-1]
    B = float(tail_bound)
    inside = (x_orig >= -B) & (x_orig <= B)
    x = (x_orig.clamp(-B, B) + B) / (2.0 * B)
    ew = torch.exp(uw - uw.max(dim=-1, keepdim=True).values)
    eh = torch.exp(uh - uh.max(dim=-1, keepdim=True).values)
    sw = ew / ew.sum(dim=-1, keepdim=True)          # softmax, [..., K]
    sh = eh / eh.sum(dim=-1, keepdim=True)
    wmix = 1.0 - min_bin_width * K
    hmix = 1.0 - min_bin_height * K
    w = [min_bin_width + wmix * sw[..., k] for k in range(K)]
    h = [min_bin_height + hmix * sh[..., k] for k in range(K)]
    slope = [h[k] / w[k] for k in range(K)]

    # the forward's walk over the bins
    zero = torch.zeros_like(x)
    runw, cw_lo = zero, zero
    runh, ch_lo = zero, zero
    sel = torch.zeros_like(x, dtype=torch.int64)
    left_w, sel_ch = zero, zero
    for k in range(K):
        runw = runw + w[k]
        runh = runh + h[k]
        take = (x >= cw_lo) if k else torch.ones_like(inside)
        sel = torch.where(take, torch.full_like(sel, k), sel)
        left_w = torch.where(take, cw_lo, left_w)
        sel_ch = torch.where(take, ch_lo, sel_ch)
        cw_lo = torch.ones_like(x) if k == K - 1 else runw
        ch_lo = torch.ones_like(x) if k == K - 1 else runh

    def pick(values, j):
        """values[j] per element, j an index tensor (clamped into range)."""
        return binning.select_bin(torch.stack(values, dim=-1), j.clamp(0, len(values) - 1))

    def derivative(k):
        """Knot derivative k (an index tensor in [0, K])."""
        sp, sn = pick(slope, k - 1), pick(slope, k)
        wp, wn = pick(w, k - 1), pick(w, k)
        m1 = torch.minimum(sp.abs(), sn.abs())
        m2 = 0.5 * (wn * sp + wp * sn) / (wp + wn)
        inner = torch.minimum(m1, m2) * (torch.sign(sp) + torch.sign(sn))
        left = torch.sigmoid(dl) * 3.0 * slope[0]
        right = torch.sigmoid(dr) * 3.0 * slope[K - 1]
        return torch.where(k == 0, left, torch.where(k == K, right, inner))

    ws, ss = pick(w, sel), pick(slope, sel)
    d0, d1 = derivative(sel), derivative(sel + 1)
    a = (d0 + d1 - 2.0 * ss) / (ws * ws)
    b = (3.0 * ss - 2.0 * d0 - d1) / ws
    c = d0
    t = x - left_w
    raw = a * (t * t * t) + b * (t * t) + c * t + sel_ch
    q = 3.0 * a * (t * t) + 2.0 * b * t + c

    # cotangents of the cubic's coefficients and of t
    g_y = torch.where(inside, grad_outputs, zero)
    g_l = torch.where(inside, grad_logabsdet, zero)
    g_raw = torch.where((raw >= 0.0) & (raw <= 1.0), g_y * (2.0 * B), zero)
    g_q = g_l / q
    g_a = g_raw * (t * t * t) + 3.0 * g_q * (t * t)
    g_b = g_raw * (t * t) + 2.0 * g_q * t
    g_c = g_raw * t + g_q
    g_d = g_raw
    g_t = g_raw * q + g_q * (6.0 * a * t + 2.0 * b)
    g_d0 = g_a / (ws * ws) - 2.0 * g_b / ws + g_c
    g_d1 = g_a / (ws * ws) - g_b / ws
    g_ss = -2.0 * g_a / (ws * ws) + 3.0 * g_b / ws
    g_ws = -2.0 * a * g_a / ws - b * g_b / ws

    # width and height cotangents: t's origin and d sum the bins below sel
    ks = torch.arange(K, device=x.device)
    below = ks < sel[..., None]
    g_w = torch.where(below, -g_t[..., None], zero[..., None])
    g_h = torch.where(below, g_d[..., None], zero[..., None])
    g_slope = torch.zeros_like(g_w)
    at_sel = ks == sel[..., None]
    g_w = g_w + torch.where(at_sel, g_ws[..., None], zero[..., None])
    g_slope = g_slope + torch.where(at_sel, g_ss[..., None], zero[..., None])
    g_dl, g_dr = zero, zero

    def derivative_adjoint(k, g_k, g_w, g_slope, g_dl, g_dr):
        """Send knot derivative k's cotangent g_k to the slopes and widths
        of the bins beside knot k, or to a boundary parameter."""
        sp, sn = pick(slope, k - 1), pick(slope, k)
        wp, wn = pick(w, k - 1), pick(w, k)
        left, right = k == 0, k == K
        s_l, s_r = torch.sigmoid(dl), torch.sigmoid(dr)
        g_dl = g_dl + torch.where(left, g_k * 3.0 * slope[0] * s_l * (1.0 - s_l), zero)
        g_dr = g_dr + torch.where(right, g_k * 3.0 * slope[K - 1] * s_r * (1.0 - s_r), zero)
        g_s0 = torch.where(left, g_k * s_l * 3.0, zero)          # to slope 0
        g_s1 = torch.where(right, g_k * s_r * 3.0, zero)         # to slope K-1
        inner = ~(left | right)
        m1 = torch.minimum(sp.abs(), sn.abs())
        den = wp + wn
        m2 = 0.5 * (wn * sp + wp * sn) / den
        g_m = torch.where(inner, g_k * (torch.sign(sp) + torch.sign(sn)), zero)
        take_m1 = m1 <= m2
        take_sp = sp.abs() <= sn.abs()
        g_m1 = torch.where(take_m1, g_m, zero)
        g_m2 = torch.where(take_m1, zero, g_m)
        g_n = g_m2 * 0.5 / den
        g_den = -g_m2 * m2 / den
        g_sp = torch.where(take_sp, g_m1 * torch.sign(sp), zero) + g_n * wn
        g_sn = torch.where(take_sp, zero, g_m1 * torch.sign(sn)) + g_n * wp
        g_wp = g_n * sn + g_den
        g_wn = g_n * sp + g_den
        prev, cur = ks == (k - 1)[..., None], ks == k[..., None]
        g_slope = (g_slope + torch.where(prev, g_sp[..., None], zero[..., None])
                   + torch.where(cur, g_sn[..., None], zero[..., None])
                   + torch.where(ks == 0, g_s0[..., None], zero[..., None])
                   + torch.where(ks == K - 1, g_s1[..., None], zero[..., None]))
        g_w = (g_w + torch.where(prev, g_wp[..., None], zero[..., None])
               + torch.where(cur, g_wn[..., None], zero[..., None]))
        return g_w, g_slope, g_dl, g_dr

    g_w, g_slope, g_dl, g_dr = derivative_adjoint(sel, g_d0, g_w, g_slope, g_dl, g_dr)
    g_w, g_slope, g_dl, g_dr = derivative_adjoint(sel + 1, g_d1, g_w, g_slope, g_dl, g_dr)

    # slopes h / w, then the softmax adjoints
    wt, ht = torch.stack(w, dim=-1), torch.stack(h, dim=-1)
    g_h = g_h + g_slope / wt
    g_w = g_w - g_slope * (ht / wt) / wt
    g_sw, g_sh = wmix * g_w, hmix * g_h
    g_uw = wh_scale * sw * (g_sw - (g_sw * sw).sum(dim=-1, keepdim=True))
    g_uh = wh_scale * sh * (g_sh - (g_sh * sh).sum(dim=-1, keepdim=True))
    g_x = torch.where(inside, g_t / (2.0 * B), grad_outputs)
    return g_x, g_uw, g_uh, g_dl[..., None], g_dr[..., None]
