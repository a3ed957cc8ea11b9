"""Kernel B1: the elementwise linear-tail RQ spline on the card
(counterpart of nflows_tpu/ops/pallas/rq_spline.py; source
``csrc/rq_spline.cu``, spline math in ``csrc/rq_spline.cuh``).

``rq_spline_cuda`` keeps the JAX public layout: inputs [...], widths and
heights [..., K], interior derivatives [..., K-1]. A CPU tensor runs the
plain version (ops/splines/rational_quadratic.py); a CUDA tensor runs the
kernel or raises. Gradients: the kernel is forward-only; the backward
recomputes the plain version under autograd (``_spline_common.KernelSpline``),
as the JAX package's ``make_spline_core`` differentiates its XLA reference
(_spline_common.py:170-196).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nflows_tpu_torch.ops.cuda import _spline_common as sc
from nflows_tpu_torch.ops.splines import rational_quadratic as rq_ref

__all__ = ["rq_spline_cuda", "launch_count"]

launch_count = 0  # kernel launches since the last reset


def _edge_derivative(min_derivative: float) -> float:
    """min_derivative + softplus(pad constant) in float32, as the TPU
    kernel computes the boundary slope from its padded derivative row."""
    c = np.float32(rq_ref.boundary_constant(min_derivative))
    return float(np.float32(min_derivative) + np.logaddexp(c, np.float32(0.0)))


def _launch(inputs, uw, uh, ud, inverse, tail_bound, min_bin_width,
            min_bin_height, min_derivative):
    global launch_count
    K = uw.shape[-1]
    sc.check_inputs("rq_spline_cuda", inputs, widths=(uw, K), heights=(uh, K),
                    derivatives=(ud, K - 1))
    if min_bin_width * K > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * K > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")
    result = sc.launch("rq_spline", inputs, (uw, uh, ud), K, inverse,
                       (tail_bound, min_bin_width, min_bin_height, min_derivative,
                        _edge_derivative(min_derivative)))
    launch_count += 1
    return result


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
    statics = dict(inverse=bool(inverse), tail_bound=float(tail_bound),
                   min_bin_width=float(min_bin_width),
                   min_bin_height=float(min_bin_height),
                   min_derivative=float(min_derivative))
    tensors = (inputs, unnormalized_widths, unnormalized_heights,
               unnormalized_derivatives)
    if inputs.device.type == "cpu":
        return rq_ref.unconstrained_rational_quadratic_spline_plain(*tensors, **statics)
    return sc.KernelSpline.apply(
        _launch, rq_ref.unconstrained_rational_quadratic_spline_plain, statics, *tensors)
