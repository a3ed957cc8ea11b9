"""Orthogonal transform as a product of Householder reflections
(counterpart of nflows_tpu/transforms/orthogonal.py; reference
nflows/transforms/orthogonal.py:10-110).

K reflections applied in turn, a rank-1 update each: a Python loop of
PyTorch operations on the tensor's device, where the JAX package scans
them in XLA. logabsdet is 0; the inverse is the same reflections in
reverse order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from nflows_tpu_torch.transforms.base import Transform
from nflows_tpu_torch.utils.shapes import is_positive_int

__all__ = ["HouseholderSequence"]


def _eye_tiled_init(num_transforms: int, features: int) -> np.ndarray:
    """Rows of eye(K // 2, F) each repeated twice, plus a standard-basis row
    when K is odd (reference orthogonal.py:40-57). Equal pairs of
    reflections cancel, so the map starts as the identity (K even) or one
    reflection."""
    qv = np.repeat(np.eye(num_transforms // 2, features, dtype=np.float32), 2, axis=0)
    if num_transforms % 2 != 0:
        extra = np.zeros((1, features), dtype=np.float32)
        extra[0, num_transforms // 2] = 1.0
        qv = np.concatenate([qv, extra], axis=0)
    return qv


class HouseholderSequence(Transform):
    """Sequence of Householder reflections parameterising an orthogonal
    map; ``q_vectors`` [K, D]."""

    def __init__(self, features, num_transforms, device=None):
        super().__init__()
        if not is_positive_int(features):
            raise TypeError("Number of features must be a positive integer.")
        if not is_positive_int(num_transforms):
            raise TypeError("Number of transforms must be a positive integer.")
        self.features = features
        self.num_transforms = num_transforms
        self.q_vectors = nn.Parameter(
            torch.from_numpy(_eye_tiled_init(num_transforms, features)).to(device))

    @staticmethod
    def _apply_transforms(inputs, q_vectors):
        squared_norms = torch.sum(q_vectors ** 2, dim=-1)
        outputs = inputs
        for q_vector, squared_norm in zip(q_vectors, squared_norms):
            temp = outputs @ q_vector
            outputs = outputs - torch.outer(temp, (2.0 / squared_norm) * q_vector)
        logabsdet = torch.zeros(inputs.shape[0], dtype=inputs.dtype, device=inputs.device)
        return outputs, logabsdet

    def forward(self, inputs, context=None):
        return self._apply_transforms(inputs, self.q_vectors)

    def inverse(self, inputs, context=None):
        # each reflection is its own inverse
        return self._apply_transforms(inputs, self.q_vectors.flip(0))

    def matrix(self):
        """The dense [D, D] matrix of the whole map (orthogonal.py:99-110)."""
        identity = torch.eye(self.features, dtype=self.q_vectors.dtype,
                             device=self.q_vectors.device)
        outputs, _ = self.inverse(identity)
        return outputs
