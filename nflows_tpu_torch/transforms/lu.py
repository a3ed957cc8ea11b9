"""LU-parameterised linear transform (counterpart of
nflows_tpu/transforms/lu.py; reference nflows/transforms/lu.py:10-129).

W = L U with a unit lower-triangular L and an upper-triangular U whose
diagonal is softplus-positive: always invertible, O(D^2) to apply, O(D)
logdet, triangular solves for the inverse. The strict triangles' indices
are non-persistent buffers made once, so building L and U is a scatter on
the parameters' device with no host copy (it runs inside a captured CUDA
graph). No kernel runs here: the products and
``torch.linalg.solve_triangular`` are PyTorch's, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.transforms.linear import Linear, _per_sample

__all__ = ["LULinear"]


def _softplus(x):
    """The JAX package's softplus, ``logaddexp(x, 0)``: ``F.softplus``
    turns linear above 20 and would depart from it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _identity_diag_constant(eps):
    """The unconstrained value whose softplus plus ``eps`` is 1."""
    return float(np.log(np.exp(1 - eps) - 1))


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def _triangle_indices(features, lower):
    """[2, D (D - 1) / 2] indices of the strict lower or upper triangle, in
    ``np.tril_indices`` / ``np.triu_indices`` order."""
    rows, cols = (np.tril_indices(features, k=-1) if lower
                  else np.triu_indices(features, k=1))
    return torch.from_numpy(np.stack([rows, cols]).astype(np.int64))


def _scatter(entries, indices, features):
    """A [D, D] matrix holding ``entries`` at ``indices`` and 0 elsewhere."""
    matrix = entries.new_zeros(features, features)
    return matrix.index_put((indices[0], indices[1]), entries)


class LULinear(Linear):
    """Linear transform parameterising the LU decomposition of its weight:
    ``lower_entries`` and ``upper_entries`` the strict triangles,
    ``unconstrained_upper_diag`` U's diagonal before the softplus. With
    ``identity_init=False`` all three are U(-1/sqrt(D), 1/sqrt(D)) draws
    from ``generator``."""

    def __init__(self, features, using_cache=False, identity_init=True, eps=1e-3,
                 generator=None, device=None):
        super().__init__(features, using_cache, device=device)
        self.eps = eps
        self.register_buffer("lower_indices", _triangle_indices(features, True).to(device),
                             persistent=False)
        self.register_buffer("upper_indices", _triangle_indices(features, False).to(device),
                             persistent=False)
        n_triangular_entries = ((features - 1) * features) // 2
        if identity_init:
            lower = torch.zeros(n_triangular_entries)
            upper = torch.zeros(n_triangular_entries)
            diag = torch.full((features,), _identity_diag_constant(eps))
        else:
            generator = default_generator(generator)
            stdv = 1.0 / math.sqrt(features)
            lower = _uniform((n_triangular_entries,), stdv, generator)
            upper = _uniform((n_triangular_entries,), stdv, generator)
            diag = _uniform((features,), stdv, generator)
        self.lower_entries = nn.Parameter(lower.to(device))
        self.upper_entries = nn.Parameter(upper.to(device))
        self.unconstrained_upper_diag = nn.Parameter(diag.to(device))

    def _create_lower_upper(self):
        D = self.features
        eye = torch.eye(D, dtype=self.lower_entries.dtype, device=self.lower_entries.device)
        lower = _scatter(self.lower_entries, self.lower_indices, D) + eye
        upper = _scatter(self.upper_entries, self.upper_indices, D) + torch.diag(self.upper_diag)
        return lower, upper

    @property
    def upper_diag(self):
        return _softplus(self.unconstrained_upper_diag) + self.eps

    def forward_no_cache(self, inputs):
        lower, upper = self._create_lower_upper()
        outputs = F.linear(F.linear(inputs, upper), lower, self.bias)
        return outputs, _per_sample(self.logabsdet(), inputs)

    def inverse_no_cache(self, inputs):
        lower, upper = self._create_lower_upper()
        outputs = (inputs - self.bias).T
        outputs = torch.linalg.solve_triangular(lower, outputs, upper=False,
                                                unitriangular=True)
        outputs = torch.linalg.solve_triangular(upper, outputs, upper=True)
        return outputs.T, _per_sample(-self.logabsdet(), inputs)

    def weight(self):
        lower, upper = self._create_lower_upper()
        return lower @ upper

    def weight_inverse(self):
        lower, upper = self._create_lower_upper()
        identity = torch.eye(self.features, dtype=lower.dtype, device=lower.device)
        lower_inverse = torch.linalg.solve_triangular(lower, identity, upper=False,
                                                      unitriangular=True)
        return torch.linalg.solve_triangular(upper, lower_inverse, upper=True)

    def logabsdet(self):
        return torch.sum(torch.log(self.upper_diag))
