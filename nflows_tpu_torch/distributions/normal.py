"""Normal base distributions (counterpart of
nflows_tpu/distributions/normal.py; reference nflows/distributions/normal.py):
``StandardNormal``, ``ConditionalDiagonalNormal`` (mean and log-std from a
context encoder) and ``DiagonalNormal`` (trainable mean and log-std).

The log-normaliser ``0.5 * D * log(2 pi)`` is computed in float64 on the
host at construction, like the reference's float64 buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from nflows_tpu_torch.distributions.base import Distribution
from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = ["StandardNormal", "ConditionalDiagonalNormal", "DiagonalNormal"]


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


class ConditionalDiagonalNormal(Distribution):
    """Diagonal normal whose means and log-stds are ``context_encoder(context)``
    split in half along the last dim (reference normal.py:53-132); None
    means the context is those parameters itself."""

    def __init__(self, shape, context_encoder=None):
        super().__init__()
        self.shape = tuple(shape)
        self.context_encoder = context_encoder
        self.log_z = float(0.5 * np.prod(self.shape) * np.log(2 * np.pi))

    def _compute_params(self, context):
        if context is None:
            raise ValueError("Context can't be None.")
        params = context if self.context_encoder is None else self.context_encoder(context)
        if params.shape[-1] % 2 != 0:
            raise RuntimeError(
                "The context encoder must return a tensor whose last dimension is even.")
        if params.shape[0] != context.shape[0]:
            raise RuntimeError(
                "The batch dimension of the parameters is inconsistent with the input.")
        split = params.shape[-1] // 2
        means = params[..., :split].reshape(params.shape[0], *self.shape)
        log_stds = params[..., split:].reshape(params.shape[0], *self.shape)
        return means, log_stds

    def _log_prob(self, inputs, context):
        if tuple(inputs.shape[1:]) != self.shape:
            raise ValueError(
                f"Expected input of shape {self.shape}, got {tuple(inputs.shape[1:])}")
        means, log_stds = self._compute_params(context)
        norm_inputs = (inputs - means) * torch.exp(-log_stds)
        log_prob = -0.5 * shapeutils.sum_except_batch(norm_inputs ** 2, num_batch_dims=1)
        log_prob = log_prob - shapeutils.sum_except_batch(log_stds, num_batch_dims=1)
        return log_prob - self.log_z

    def _sample(self, generator, num_samples, context):
        means, log_stds = self._compute_params(context)
        means = shapeutils.repeat_rows(means, num_samples)
        stds = shapeutils.repeat_rows(torch.exp(log_stds), num_samples)
        context_size = context.shape[0]
        noise = torch.randn((context_size * num_samples, *self.shape), generator=generator,
                            device=means.device, dtype=means.dtype)
        return shapeutils.split_leading_dim(means + stds * noise, [context_size, num_samples])


class DiagonalNormal(Distribution):
    """Diagonal normal with a trainable mean and log-std, each [1, D], both
    starting at zero (reference normal.py:135-180). It has no sampler, as
    in the reference."""

    def __init__(self, shape, device=None):
        super().__init__()
        self.shape = tuple(shape)
        self.mean_ = torch.nn.Parameter(torch.zeros(1, int(np.prod(self.shape)), device=device))
        self.log_std_ = torch.nn.Parameter(
            torch.zeros(1, int(np.prod(self.shape)), device=device))
        self.log_z = float(0.5 * np.prod(self.shape) * np.log(2 * np.pi))

    def _log_prob(self, inputs, context):
        if tuple(inputs.shape[1:]) != self.shape:
            raise ValueError(
                f"Expected input of shape {self.shape}, got {tuple(inputs.shape[1:])}")
        norm_inputs = (inputs - self.mean_) * torch.exp(-self.log_std_)
        log_prob = -0.5 * shapeutils.sum_except_batch(norm_inputs ** 2, num_batch_dims=1)
        log_prob = log_prob - shapeutils.sum_except_batch(
            self.log_std_.expand(inputs.shape), num_batch_dims=1)
        return log_prob - self.log_z

    def _sample(self, generator, num_samples, context):
        raise NotImplementedError()
