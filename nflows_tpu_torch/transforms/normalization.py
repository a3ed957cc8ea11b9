"""Normalization transforms: BatchNorm and ActNorm (counterpart of
nflows_tpu/transforms/normalization.py; reference
nflows/transforms/normalization.py:72-218).

- ``BatchNorm``: in training mode (``nn.Module.training``) it normalises by
  the batch's mean and unbiased variance; in eval mode by its running
  statistics, and only then has an inverse (``InverseNotAvailable``
  otherwise, as in the reference). As in the JAX package the forward does
  not update the running statistics: ``update_running_stats(batch)`` takes
  one EMA step of them and ``initialize_with_data(batch)`` sets them to the
  batch's statistics, both in place.
- ``ActNorm``: Glow's per-feature affine map with data-dependent
  initialisation by ``initialize_with_data(batch)``, in place and once: an
  initialised ActNorm's ``initialized`` flag (a persistent bool buffer, so
  it travels in the state dict) turns further calls into a plain forward.
  2-D inputs only here; image inputs wait for the image path.

Global-batch statistics under a mesh axis (``stats_axis``) are not ported:
a non-None ``stats_axis`` raises. No kernel runs here: the batch statistics
are PyTorch's on the tensor's device, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from nflows_tpu_torch.nn.nets.resnet import refuse_stats_axis
from nflows_tpu_torch.transforms.base import InverseNotAvailable, Transform
from nflows_tpu_torch.transforms.linear import _per_sample
from nflows_tpu_torch.transforms.lu import _softplus
from nflows_tpu_torch.utils.shapes import is_positive_int

__all__ = ["BatchNorm", "ActNorm"]


class BatchNorm(Transform):
    """Batch-normalization transform for 1-dim inputs: ``unconstrained_weight``
    (the scale before the softplus) and ``bias``, with the running
    statistics as buffers."""

    def __init__(self, features, eps=1e-5, momentum=0.1, affine=True, training=True,
                 stats_axis=None, device=None):
        super().__init__()
        if not is_positive_int(features):
            raise TypeError("Number of features must be a positive integer.")
        refuse_stats_axis(stats_axis)
        del affine  # kept for the signature; weight and bias are always present
        self.momentum = momentum
        self.eps = eps
        constant = float(np.log(np.exp(1 - eps) - 1))
        self.unconstrained_weight = nn.Parameter(
            torch.full((features,), constant, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.zeros(features, device=device))
        self.train(training)

    @property
    def weight(self):
        return _softplus(self.unconstrained_weight) + self.eps

    @staticmethod
    def _batch_stats(inputs):
        """The batch's mean and unbiased variance."""
        return torch.mean(inputs, dim=0), torch.var(inputs, dim=0, correction=1)

    def forward(self, inputs, context=None):
        if inputs.ndim != 2:
            raise ValueError(f"Expected 2-dim inputs, got inputs of shape: {tuple(inputs.shape)}")
        if self.training:
            mean, var = self._batch_stats(inputs)
        else:
            mean, var = self.running_mean, self.running_var
        weight = self.weight
        outputs = weight * ((inputs - mean) / torch.sqrt(var + self.eps)) + self.bias
        logabsdet = torch.sum(torch.log(weight) - 0.5 * torch.log(var + self.eps))
        return outputs, _per_sample(logabsdet, inputs)

    def inverse(self, inputs, context=None):
        if self.training:
            raise InverseNotAvailable(
                "Batch norm inverse is only available in eval mode, not in training mode.")
        if inputs.ndim != 2:
            raise ValueError(f"Expected 2-dim inputs, got inputs of shape: {tuple(inputs.shape)}")
        weight = self.weight
        outputs = (torch.sqrt(self.running_var + self.eps) * ((inputs - self.bias) / weight)
                   + self.running_mean)
        logabsdet = torch.sum(-torch.log(weight) + 0.5 * torch.log(self.running_var + self.eps))
        return outputs, _per_sample(logabsdet, inputs)

    @torch.no_grad()
    def update_running_stats(self, inputs) -> "BatchNorm":
        """One EMA step of the running statistics towards the batch's
        (reference normalization.py:104-107), in place; returns ``self``."""
        mean, var = self._batch_stats(inputs)
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        return self

    def initialize_with_data(self, inputs, context=None):
        """Set the running statistics to the batch's, with no momentum
        (they start at zero, so an EMA step would leave them at momentum
        times the statistics), in place. Returns ``(self, outputs)``."""
        with torch.no_grad():
            mean, var = self._batch_stats(inputs)
            self.running_mean.copy_(mean)
            self.running_var.copy_(var)
        outputs, _ = self.forward(inputs, context)
        return self, outputs


class ActNorm(Transform):
    """Glow activation normalization for 2-D inputs: ``log_scale`` and
    ``shift`` a feature."""

    def __init__(self, features, device=None):
        super().__init__()
        if not is_positive_int(features):
            raise TypeError("Number of features must be a positive integer.")
        self.register_buffer("initialized", torch.tensor(False, device=device))
        self.log_scale = nn.Parameter(torch.zeros(features, device=device))
        self.shift = nn.Parameter(torch.zeros(features, device=device))

    @property
    def scale(self):
        return torch.exp(self.log_scale)

    @staticmethod
    def _check(inputs):
        if inputs.ndim == 4:
            raise NotImplementedError(
                "ActNorm on 4-D (image) inputs waits for the image path, "
                "ROADMAP.md queue A item 6c")
        if inputs.ndim != 2:
            raise ValueError("Expecting inputs to be a 2D or a 4D tensor.")

    def forward(self, inputs, context=None):
        self._check(inputs)
        outputs = self.scale * inputs + self.shift
        return outputs, _per_sample(torch.sum(self.log_scale), inputs)

    def inverse(self, inputs, context=None):
        self._check(inputs)
        outputs = (inputs - self.shift) / self.scale
        return outputs, _per_sample(-torch.sum(self.log_scale), inputs)

    def initialize_with_data(self, inputs, context=None):
        """Set the map so that its outputs on ``inputs`` have zero mean and
        unit (unbiased) variance a feature (reference
        normalization.py:206-218), in place, unless already initialised.
        Returns ``(self, outputs)``."""
        self._check(inputs)
        if not bool(self.initialized):
            with torch.no_grad():
                std = torch.std(inputs, dim=0, correction=1)
                mu = torch.mean(inputs / std, dim=0)
                self.log_scale.copy_(-torch.log(std))
                self.shift.copy_(-mu)
                self.initialized.fill_(True)
        outputs, _ = self.forward(inputs, context)
        return self, outputs
