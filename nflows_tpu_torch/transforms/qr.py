"""QR-parameterised linear transform (counterpart of
nflows_tpu/transforms/qr.py; reference nflows/transforms/qr.py:11-114).

W = Q R with Q a Householder product and R upper-triangular with an exp
diagonal: always invertible, O(D) logdet. No kernel runs here: the
products, the reflections and ``torch.linalg.solve_triangular`` are
PyTorch's, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.transforms.linear import Linear, _per_sample
from nflows_tpu_torch.transforms.lu import _scatter, _triangle_indices, _uniform
from nflows_tpu_torch.transforms.orthogonal import HouseholderSequence

__all__ = ["QRLinear"]


class QRLinear(Linear):
    """Linear transform parameterising the QR decomposition of its weight:
    ``upper_entries`` R's strict upper triangle and ``log_upper_diag`` its
    log-diagonal, both U(-1/sqrt(D), 1/sqrt(D)) draws from ``generator``,
    and ``orthogonal`` Q, ``num_householder`` reflections."""

    def __init__(self, features, num_householder, using_cache=False, generator=None,
                 device=None):
        super().__init__(features, using_cache, device=device)
        generator = default_generator(generator)
        self.register_buffer("upper_indices", _triangle_indices(features, False).to(device),
                             persistent=False)
        n_triangular_entries = ((features - 1) * features) // 2
        stdv = 1.0 / math.sqrt(features)
        self.upper_entries = nn.Parameter(
            _uniform((n_triangular_entries,), stdv, generator).to(device))
        self.log_upper_diag = nn.Parameter(_uniform((features,), stdv, generator).to(device))
        self.orthogonal = HouseholderSequence(features=features,
                                              num_transforms=num_householder, device=device)

    def _create_upper(self):
        upper = _scatter(self.upper_entries, self.upper_indices, self.features)
        return upper + torch.diag(torch.exp(self.log_upper_diag))

    def forward_no_cache(self, inputs):
        outputs = F.linear(inputs, self._create_upper())
        outputs, _ = self.orthogonal.forward(outputs)  # logabsdet is zero
        return outputs + self.bias, _per_sample(self.logabsdet(), inputs)

    def inverse_no_cache(self, inputs):
        outputs, _ = self.orthogonal.inverse(inputs - self.bias)
        outputs = torch.linalg.solve_triangular(self._create_upper(), outputs.T, upper=True).T
        return outputs, _per_sample(-self.logabsdet(), inputs)

    def weight(self):
        weight, _ = self.orthogonal.forward(self._create_upper().T)
        return weight.T

    def weight_inverse(self):
        upper = self._create_upper()
        identity = torch.eye(self.features, dtype=upper.dtype, device=upper.device)
        upper_inverse = torch.linalg.solve_triangular(upper, identity, upper=True)
        weight_inverse, _ = self.orthogonal.forward(upper_inverse)
        return weight_inverse

    def logabsdet(self):
        return torch.sum(self.log_upper_diag)
