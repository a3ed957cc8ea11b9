"""Kernel B6: the elementwise linear-tail piecewise-linear spline on the card
(counterpart of nflows_tpu/ops/pallas/linear_spline.py; source
``csrc/linear_spline.cu``, spline math in ``csrc/linear_spline.cuh``).

``linear_spline_cuda`` keeps the JAX public layout: inputs [...], the
unnormalised pdf [..., K]. A CPU tensor runs the plain version
(ops/splines/linear.py); a CUDA tensor runs the kernel or raises.
Gradients: the backward recomputes the plain version under autograd
(``_spline_common.KernelSpline``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nflows_tpu_torch.ops.cuda import _spline_common as sc
from nflows_tpu_torch.ops.splines import linear as lin_ref

__all__ = ["linear_spline_cuda", "launch_count"]

launch_count = 0  # kernel launches since the last reset


def _launch(inputs, up, inverse, tail_bound):
    global launch_count
    K = up.shape[-1]
    sc.check_inputs("linear_spline_cuda", inputs, pdf=(up, K))
    # log(1/K) rounded to float32 once, as the plain version's constant is
    result = sc.launch("linear_spline", inputs, (up,), K, inverse,
                       (tail_bound, float(np.log(1.0 / K))))
    launch_count += 1
    return result


def linear_spline_cuda(
    inputs: torch.Tensor,
    unnormalized_pdf: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear-tail piecewise-linear spline; same contract as
    ``unconstrained_linear_spline``. Returns (outputs, per-element
    logabsdet)."""
    statics = dict(inverse=bool(inverse), tail_bound=float(tail_bound))
    if inputs.device.type == "cpu":
        return lin_ref.unconstrained_linear_spline_plain(inputs, unnormalized_pdf, **statics)
    return sc.KernelSpline.apply(_launch, lin_ref.unconstrained_linear_spline_plain,
                                 statics, inputs, unnormalized_pdf)
