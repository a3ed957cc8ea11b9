"""Plain PyTorch splines (counterpart of nflows_tpu/ops/splines). Each
family's ``DEFAULT_*`` constants live in its module."""

from nflows_tpu_torch.ops.splines import (
    cubic,
    linear,
    linear_rational,
    quadratic,
    rational_quadratic,
)
from nflows_tpu_torch.ops.splines.cubic import cubic_spline, unconstrained_cubic_spline
from nflows_tpu_torch.ops.splines.linear import linear_spline, unconstrained_linear_spline
from nflows_tpu_torch.ops.splines.linear_rational import (
    linear_rational_spline,
    unconstrained_linear_rational_spline,
)
from nflows_tpu_torch.ops.splines.quadratic import (
    quadratic_spline,
    unconstrained_quadratic_spline,
)
from nflows_tpu_torch.ops.splines.rational_quadratic import (
    rational_quadratic_spline,
    unconstrained_rational_quadratic_spline,
)

__all__ = ["cubic", "linear", "linear_rational", "quadratic", "rational_quadratic",
           "cubic_spline", "unconstrained_cubic_spline",
           "linear_spline", "unconstrained_linear_spline",
           "linear_rational_spline", "unconstrained_linear_rational_spline",
           "quadratic_spline", "unconstrained_quadratic_spline",
           "rational_quadratic_spline", "unconstrained_rational_quadratic_spline"]
