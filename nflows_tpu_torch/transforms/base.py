"""Transform protocol and combinators (counterpart of
nflows_tpu/transforms/base.py; reference nflows/transforms/base.py).

A ``Transform`` is an ``nn.Module`` with two methods::

    forward(inputs, context=None) -> (outputs, logabsdet)   # x -> y
    inverse(inputs, context=None) -> (outputs, logabsdet)   # y -> x

with ``logabsdet`` shaped ``[batch]``. Composition is a running sum.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

__all__ = ["InverseNotAvailable", "InputOutsideDomain", "Transform",
           "CompositeTransform", "InverseTransform"]


class InverseNotAvailable(Exception):
    """Thrown when a transform does not have an inverse."""


class InputOutsideDomain(Exception):
    """Thrown when the input to a transform is outside its domain."""


class Transform(nn.Module):
    """Base class for all transform objects."""

    def forward(self, inputs, context=None):
        raise NotImplementedError()

    def inverse(self, inputs, context=None):
        raise InverseNotAvailable()


class CompositeTransform(Transform):
    """Composes several transforms into one, in the order given."""

    def __init__(self, transforms: Sequence[Transform]):
        super().__init__()
        self.transforms = nn.ModuleList(transforms)

    @staticmethod
    def _cascade(inputs, funcs, context):
        outputs = inputs
        total_logabsdet = torch.zeros(inputs.shape[0], dtype=inputs.dtype,
                                      device=inputs.device)
        for func in funcs:
            outputs, logabsdet = func(outputs, context)
            total_logabsdet = total_logabsdet + logabsdet
        return outputs, total_logabsdet

    def forward(self, inputs, context=None):
        return self._cascade(inputs, [t.forward for t in self.transforms], context)

    def inverse(self, inputs, context=None):
        return self._cascade(
            inputs, [t.inverse for t in reversed(self.transforms)], context)


class InverseTransform(Transform):
    """Swaps forward and inverse."""

    def __init__(self, transform: Transform):
        super().__init__()
        self.transform = transform

    def forward(self, inputs, context=None):
        return self.transform.inverse(inputs, context)

    def inverse(self, inputs, context=None):
        return self.transform.forward(inputs, context)
