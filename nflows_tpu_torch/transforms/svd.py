"""SVD-parameterised linear transform (counterpart of
nflows_tpu/transforms/svd.py; reference nflows/transforms/svd.py:11-127).

W = U diag(s) V^T with U and V^T Householder products and s
softplus-positive: no dense product at all, O(D) logdet. No kernel runs
here: the reflections are PyTorch's, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.transforms.linear import Linear, _per_sample
from nflows_tpu_torch.transforms.lu import _identity_diag_constant, _softplus, _uniform
from nflows_tpu_torch.transforms.orthogonal import HouseholderSequence

__all__ = ["SVDLinear"]


class SVDLinear(Linear):
    """Linear transform parameterising the SVD of its weight:
    ``orthogonal_1`` (U) and ``orthogonal_2`` (V^T), ``num_householder``
    reflections each (an even number), and ``unconstrained_diagonal``, the
    singular values before the softplus (1 at ``identity_init``, else
    U(-1/sqrt(D), 1/sqrt(D)) draws from ``generator``)."""

    def __init__(self, features, num_householder, using_cache=False, identity_init=True,
                 eps=1e-3, generator=None, device=None):
        super().__init__(features, using_cache, device=device)
        assert num_householder % 2 == 0
        self.eps = eps
        self.orthogonal_1 = HouseholderSequence(features=features,
                                                num_transforms=num_householder, device=device)
        if identity_init:
            diagonal = torch.full((features,), _identity_diag_constant(eps))
        else:
            diagonal = _uniform((features,), 1.0 / math.sqrt(features),
                                default_generator(generator))
        self.unconstrained_diagonal = nn.Parameter(diagonal.to(device))
        self.orthogonal_2 = HouseholderSequence(features=features,
                                                num_transforms=num_householder, device=device)

    @property
    def diagonal(self):
        return self.eps + _softplus(self.unconstrained_diagonal)

    @property
    def log_diagonal(self):
        return torch.log(self.diagonal)

    def forward_no_cache(self, inputs):
        outputs, _ = self.orthogonal_2.forward(inputs)
        outputs, _ = self.orthogonal_1.forward(outputs * self.diagonal)
        return outputs + self.bias, _per_sample(self.logabsdet(), inputs)

    def inverse_no_cache(self, inputs):
        outputs, _ = self.orthogonal_1.inverse(inputs - self.bias)
        outputs, _ = self.orthogonal_2.inverse(outputs / self.diagonal)
        return outputs, _per_sample(-self.logabsdet(), inputs)

    def weight(self):
        weight, _ = self.orthogonal_2.inverse(torch.diag(self.diagonal))
        weight, _ = self.orthogonal_1.forward(weight.T)
        return weight.T

    def weight_inverse(self):
        weight_inverse, _ = self.orthogonal_1.forward(torch.diag(1.0 / self.diagonal))
        weight_inverse, _ = self.orthogonal_2.inverse(weight_inverse.T)
        return weight_inverse.T

    def logabsdet(self):
        return torch.sum(self.log_diagonal)
