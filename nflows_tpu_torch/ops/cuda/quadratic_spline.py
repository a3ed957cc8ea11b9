"""Kernel B7: the elementwise linear-tail piecewise-quadratic spline on the
card (counterpart of nflows_tpu/ops/pallas/quadratic_spline.py; source
``csrc/quadratic_spline.cu``, spline math in ``csrc/quadratic_spline.cuh``).

``quadratic_spline_cuda`` keeps the JAX public layout: inputs [...], widths
[..., K], heights [..., K-1] (the normalised-boundary variant). A CPU
tensor runs the plain version (ops/splines/quadratic.py); a CUDA tensor runs
the kernel or raises. Gradients: the backward recomputes the plain version
under autograd (``_spline_common.KernelSpline``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from nflows_tpu_torch.ops.cuda import _spline_common as sc
from nflows_tpu_torch.ops.splines import quadratic as q_ref

__all__ = ["quadratic_spline_cuda", "launch_count"]

launch_count = 0  # kernel launches since the last reset


def _launch(inputs, uw, uh, inverse, tail_bound, min_bin_width, min_bin_height):
    global launch_count
    K = uw.shape[-1]
    sc.check_inputs("quadratic_spline_cuda", inputs, widths=(uw, K), heights=(uh, K - 1))
    if K < 2:
        raise ValueError("quadratic_spline_cuda: needs at least 2 bins (K - 1 heights)")
    if min_bin_width * K > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * K > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")
    result = sc.launch("quadratic_spline", inputs, (uw, uh), K, inverse,
                       (tail_bound, min_bin_width, min_bin_height))
    launch_count += 1
    return result


def quadratic_spline_cuda(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    min_bin_width: float = q_ref.DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = q_ref.DEFAULT_MIN_BIN_HEIGHT,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear-tail quadratic spline; same contract as
    ``unconstrained_quadratic_spline`` (K-1 heights). Returns (outputs,
    per-element logabsdet)."""
    statics = dict(inverse=bool(inverse), tail_bound=float(tail_bound),
                   min_bin_width=float(min_bin_width), min_bin_height=float(min_bin_height))
    tensors = (inputs, unnormalized_widths, unnormalized_heights)
    if inputs.device.type == "cpu":
        return q_ref.unconstrained_quadratic_spline_plain(*tensors, **statics)
    return sc.KernelSpline.apply(_launch, q_ref.unconstrained_quadratic_spline_plain,
                                 statics, *tensors)
