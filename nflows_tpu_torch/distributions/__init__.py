"""Distributions (counterpart of nflows_tpu/distributions)."""

from nflows_tpu_torch.distributions.base import Distribution
from nflows_tpu_torch.distributions.mixture import MADEMoG
from nflows_tpu_torch.distributions.normal import StandardNormal

__all__ = ["Distribution", "MADEMoG", "StandardNormal"]
