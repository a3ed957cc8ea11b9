"""Kernel B5: the elementwise linear-tail linear-rational spline on the card
(counterpart of nflows_tpu/ops/pallas/lrs_spline.py; source
``csrc/lrs_spline.cu``, spline math in ``csrc/lrs_spline.cuh``).

``lrs_spline_cuda`` keeps the JAX public layout: inputs [...], widths,
heights and lambdas [..., K], interior derivatives [..., K-1]. A CPU tensor
runs the plain version (ops/splines/linear_rational.py); a CUDA tensor runs
the kernel or raises. Gradients: the backward recomputes the plain version
under autograd (``_spline_common.KernelSpline``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from nflows_tpu_torch.ops.cuda import _spline_common as sc
from nflows_tpu_torch.ops.cuda.rq_spline import _edge_derivative
from nflows_tpu_torch.ops.splines import linear_rational as lrs_ref

__all__ = ["lrs_spline_cuda", "launch_count"]

launch_count = 0  # kernel launches since the last reset


def _launch(inputs, uw, uh, ud, ul, inverse, tail_bound, min_bin_width,
            min_bin_height, min_derivative, min_lambda):
    global launch_count
    K = uw.shape[-1]
    sc.check_inputs("lrs_spline_cuda", inputs, widths=(uw, K), heights=(uh, K),
                    derivatives=(ud, K - 1), lambdas=(ul, K))
    if min_bin_width * K > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * K > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")
    result = sc.launch("lrs_spline", inputs, (uw, uh, ud, ul), K, inverse,
                       (tail_bound, min_bin_width, min_bin_height, min_derivative,
                        min_lambda, _edge_derivative(min_derivative)))
    launch_count += 1
    return result


def lrs_spline_cuda(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    unnormalized_lambdas: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    min_bin_width: float = lrs_ref.DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = lrs_ref.DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = lrs_ref.DEFAULT_MIN_DERIVATIVE,
    min_lambda: float = lrs_ref.DEFAULT_MIN_LAMBDA,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear-tail LRS spline; same contract as
    ``unconstrained_linear_rational_spline`` with tails='linear' and K-1
    derivative params. Returns (outputs, per-element logabsdet)."""
    statics = dict(inverse=bool(inverse), tail_bound=float(tail_bound),
                   min_bin_width=float(min_bin_width),
                   min_bin_height=float(min_bin_height),
                   min_derivative=float(min_derivative), min_lambda=float(min_lambda))
    tensors = (inputs, unnormalized_widths, unnormalized_heights,
               unnormalized_derivatives, unnormalized_lambdas)
    if inputs.device.type == "cpu":
        return lrs_ref.unconstrained_linear_rational_spline_plain(*tensors, **statics)
    return sc.KernelSpline.apply(
        _launch, lrs_ref.unconstrained_linear_rational_spline_plain, statics, *tensors)
