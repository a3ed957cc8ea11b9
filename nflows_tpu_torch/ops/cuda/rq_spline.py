"""Kernel B1: the elementwise linear-tail RQ spline on the card
(counterpart of nflows_tpu/ops/pallas/rq_spline.py; source
``csrc/rq_spline.cu``, spline math in ``csrc/rq_spline.cuh``).

``rq_spline_cuda`` keeps the JAX public layout: inputs [...], widths and
heights [..., K], interior derivatives [..., K-1]. A CPU tensor runs the
plain version (ops/splines/rational_quadratic.py); a CUDA tensor runs the
kernel or raises. Gradients: the kernel is forward-only; the backward
recomputes the plain version under autograd, as the JAX package's
``make_spline_core`` differentiates its XLA reference
(_spline_common.py:170-196).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from nflows_tpu_torch.ops.cuda import _build
from nflows_tpu_torch.ops.splines import rational_quadratic as rq_ref

__all__ = ["rq_spline_cuda", "launch_count"]

launch_count = 0  # kernel launches since the last reset


def _declare(lib):
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.rq_spline_launch.argtypes = [p, p, p, p, p, p, ctypes.c_int64, i, i,
                                     f, f, f, f, f, p]
    lib.rq_spline_launch.restype = i


def _edge_derivative(min_derivative: float) -> float:
    """min_derivative + softplus(pad constant) in float32, as the TPU
    kernel computes the boundary slope from its padded derivative row."""
    c = np.float32(rq_ref.boundary_constant(min_derivative))
    return float(np.float32(min_derivative) + np.logaddexp(c, np.float32(0.0)))


def _launch(inputs, uw, uh, ud, inverse, tail_bound, min_bin_width,
            min_bin_height, min_derivative):
    global launch_count
    K = uw.shape[-1]
    shape = tuple(inputs.shape)
    tensors = (inputs, uw, uh, ud)
    for name, t in zip(("inputs", "widths", "heights", "derivatives"), tensors):
        if not t.is_cuda or t.device != inputs.device:
            raise ValueError(f"rq_spline_cuda: {name} must be on {inputs.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"rq_spline_cuda: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rq_spline_cuda: {name} must be contiguous")
    if tuple(uw.shape) != shape + (K,) or tuple(uh.shape) != shape + (K,):
        raise ValueError("rq_spline_cuda: widths/heights must be inputs.shape + (K,)")
    if tuple(ud.shape) != shape + (K - 1,):
        raise ValueError("rq_spline_cuda: derivatives must be inputs.shape + (K-1,)")
    if min_bin_width * K > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * K > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")

    lib = _build.load_library("rq_spline", _declare)
    out = torch.empty_like(inputs)
    lad = torch.empty_like(inputs)
    stream = torch.cuda.current_stream(inputs.device).cuda_stream
    with torch.cuda.device(inputs.device):
        code = lib.rq_spline_launch(
            inputs.data_ptr(), uw.data_ptr(), uh.data_ptr(), ud.data_ptr(),
            out.data_ptr(), lad.data_ptr(), inputs.numel(), K, int(inverse),
            tail_bound, min_bin_width, min_bin_height, min_derivative,
            _edge_derivative(min_derivative), stream)
    launch_count += 1
    _build.check(code, "rq_spline_launch")
    return out, lad


class _RQSpline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, uw, uh, ud, statics):
        ctx.save_for_backward(inputs, uw, uh, ud)
        ctx.statics = statics
        return _launch(inputs, uw, uh, ud, *statics)

    @staticmethod
    def backward(ctx, grad_out, grad_lad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad)]
            inverse, tail_bound, mbw, mbh, md = ctx.statics
            out, lad = rq_ref.unconstrained_rational_quadratic_spline_plain(
                *leaves, inverse=inverse, tail_bound=tail_bound,
                min_bin_width=mbw, min_bin_height=mbh, min_derivative=md)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad((out, lad), wanted,
                                             (grad_out, grad_lad)))
        return tuple(next(grads) if t.requires_grad else None
                     for t in leaves) + (None,)


def rq_spline_cuda(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    min_bin_width: float = rq_ref.DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = rq_ref.DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = rq_ref.DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear-tail RQ spline; same contract as
    ``unconstrained_rational_quadratic_spline`` with tails='linear' and K-1
    derivative params. Returns (outputs, per-element logabsdet)."""
    if inputs.device.type == "cpu":
        return rq_ref.unconstrained_rational_quadratic_spline_plain(
            inputs, unnormalized_widths, unnormalized_heights,
            unnormalized_derivatives, inverse=inverse, tail_bound=tail_bound,
            min_bin_width=min_bin_width, min_bin_height=min_bin_height,
            min_derivative=min_derivative)
    statics = (bool(inverse), float(tail_bound), float(min_bin_width),
               float(min_bin_height), float(min_derivative))
    return _RQSpline.apply(inputs, unnormalized_widths, unnormalized_heights,
                           unnormalized_derivatives, statics)
