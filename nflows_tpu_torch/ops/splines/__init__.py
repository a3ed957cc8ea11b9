"""Plain PyTorch splines (counterpart of nflows_tpu/ops/splines)."""

from nflows_tpu_torch.ops.splines import rational_quadratic
from nflows_tpu_torch.ops.splines.rational_quadratic import (
    rational_quadratic_spline,
    unconstrained_rational_quadratic_spline,
)

__all__ = ["rational_quadratic", "rational_quadratic_spline",
           "unconstrained_rational_quadratic_spline"]
