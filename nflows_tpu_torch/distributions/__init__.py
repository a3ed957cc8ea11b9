"""Distributions (counterpart of nflows_tpu/distributions)."""

from nflows_tpu_torch.distributions.base import Distribution
from nflows_tpu_torch.distributions.mixture import MADEMoG
from nflows_tpu_torch.distributions.normal import (
    ConditionalDiagonalNormal,
    DiagonalNormal,
    StandardNormal,
)

__all__ = ["ConditionalDiagonalNormal", "DiagonalNormal", "Distribution", "MADEMoG",
           "StandardNormal"]
