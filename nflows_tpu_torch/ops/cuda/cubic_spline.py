"""Kernel B8: the elementwise linear-tail monotone cubic spline on the card
(counterpart of nflows_tpu/ops/pallas/cubic_spline.py; source
``csrc/cubic_spline.cu``, spline math in ``csrc/cubic_spline.cuh``).

``cubic_spline_cuda`` keeps the JAX public layout: inputs [...], widths
and heights [..., K], boundary derivative parameters [..., 1]. A CPU
tensor runs the plain version (ops/splines/cubic.py); a CUDA tensor runs
the kernel or raises. The inverse is 30 bisection halvings and one Newton
step, as the plain version's. Gradients: the backward recomputes the plain
version under autograd (``_spline_common.KernelSpline``), whose Newton
re-attachment gives the inverse its parameter sensitivity.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nflows_tpu_torch.ops.cuda import _spline_common as sc
from nflows_tpu_torch.ops.splines import cubic as cub_ref

__all__ = ["cubic_spline_cuda", "launch_count"]

launch_count = 0  # kernel launches since the last reset


def _launch(inputs, uw, uh, dl, dr, inverse, tail_bound, min_bin_width,
            min_bin_height):
    global launch_count
    K = uw.shape[-1]
    sc.check_inputs("cubic_spline_cuda", inputs, widths=(uw, K), heights=(uh, K),
                    derivatives_left=(dl, 1), derivatives_right=(dr, 1))
    if min_bin_width * K > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * K > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")
    result = sc.launch("cubic_spline", inputs, (uw, uh, dl, dr), K, inverse,
                       (tail_bound, min_bin_width, min_bin_height))
    launch_count += 1
    return result


def cubic_spline_cuda(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnorm_derivatives_left: torch.Tensor,
    unnorm_derivatives_right: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    min_bin_width: float = cub_ref.DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = cub_ref.DEFAULT_MIN_BIN_HEIGHT,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear-tail cubic spline; same contract as
    ``unconstrained_cubic_spline``. Returns (outputs, per-element
    logabsdet)."""
    statics = dict(inverse=bool(inverse), tail_bound=float(tail_bound),
                   min_bin_width=float(min_bin_width), min_bin_height=float(min_bin_height))
    tensors = (inputs, unnormalized_widths, unnormalized_heights,
               unnorm_derivatives_left, unnorm_derivatives_right)
    if inputs.device.type == "cpu":
        return cub_ref.unconstrained_cubic_spline_plain(*tensors, **statics)
    return sc.KernelSpline.apply(_launch, cub_ref.unconstrained_cubic_spline_plain,
                                 statics, *tensors)
