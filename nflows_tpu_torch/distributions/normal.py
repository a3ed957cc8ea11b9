"""Standard normal base distribution (counterpart of
nflows_tpu/distributions/normal.py; reference nflows/distributions/normal.py).

The log-normaliser ``0.5 * D * log(2 pi)`` is computed in float64 on the
host at construction, like the reference's float64 buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from nflows_tpu_torch.distributions.base import Distribution
from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = ["StandardNormal"]


class StandardNormal(Distribution):
    """Multivariate normal, zero mean, unit covariance."""

    def __init__(self, shape):
        super().__init__()
        self.shape = tuple(shape)
        self.log_z = float(0.5 * np.prod(self.shape) * np.log(2 * np.pi))
        # follows the module's device (flow.to(...)) so samples land there
        self.register_buffer("_anchor", torch.zeros(()), persistent=False)

    def _log_prob(self, inputs, context):
        if tuple(inputs.shape[1:]) != self.shape:
            raise ValueError(
                f"Expected input of shape {self.shape}, got {tuple(inputs.shape[1:])}")
        neg_energy = -0.5 * shapeutils.sum_except_batch(inputs ** 2, num_batch_dims=1)
        return neg_energy - self.log_z

    def _sample(self, generator, num_samples, context):
        dev = self._anchor.device
        if context is None:
            return torch.randn((num_samples, *self.shape), generator=generator,
                               device=dev)
        context_size = context.shape[0]
        samples = torch.randn((context_size * num_samples, *self.shape),
                              generator=generator, device=dev)
        return shapeutils.split_leading_dim(samples, [context_size, num_samples])
