"""Permutation transforms (counterpart of
nflows_tpu/transforms/permutations.py). The permutation is an integer
buffer, so it travels with the model's state; logabsdet is zero."""

from __future__ import annotations

import numpy as np
import torch

from nflows_tpu_torch.transforms.base import Transform
from nflows_tpu_torch.utils.shapes import is_positive_int

__all__ = ["Permutation", "RandomPermutation", "ReversePermutation"]


class Permutation(Transform):
    """Permutes inputs along a given dim using a fixed permutation."""

    def __init__(self, permutation, dim: int = 1, device=None):
        super().__init__()
        permutation = torch.as_tensor(np.asarray(permutation), dtype=torch.int64)
        if permutation.ndim != 1:
            raise ValueError("Permutation must be a 1D tensor.")
        if not is_positive_int(dim):
            raise ValueError("dim must be a positive integer.")
        self.register_buffer("permutation", permutation.to(device))
        self.dim = dim

    @property
    def inverse_permutation(self):
        return torch.argsort(self.permutation)

    @staticmethod
    def _permute(inputs, permutation, dim):
        if dim >= inputs.ndim:
            raise ValueError(f"No dimension {dim} in inputs.")
        if inputs.shape[dim] != permutation.shape[0]:
            raise ValueError(
                f"Dimension {dim} in inputs must be of size {permutation.shape[0]}.")
        outputs = torch.index_select(inputs, dim, permutation)
        logabsdet = torch.zeros(inputs.shape[0], dtype=inputs.dtype,
                                device=inputs.device)
        return outputs, logabsdet

    def forward(self, inputs, context=None):
        return self._permute(inputs, self.permutation, self.dim)

    def inverse(self, inputs, context=None):
        return self._permute(inputs, self.inverse_permutation, self.dim)


class RandomPermutation(Permutation):
    """A random but fixed permutation, drawn from the numpy ``rng``."""

    def __init__(self, features: int, dim: int = 1, rng=None, device=None):
        if not is_positive_int(features):
            raise ValueError("Number of features must be a positive integer.")
        if rng is None:
            rng = np.random.default_rng()
        super().__init__(rng.permutation(features), dim, device=device)


class ReversePermutation(Permutation):
    """Reverses the elements of the input."""

    def __init__(self, features: int, dim: int = 1, device=None):
        if not is_positive_int(features):
            raise ValueError("Number of features must be a positive integer.")
        super().__init__(np.arange(features - 1, -1, -1), dim, device=device)
