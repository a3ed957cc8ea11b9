"""Invertible linear transforms: the abstract base and NaiveLinear
(counterpart of nflows_tpu/transforms/linear.py; reference
nflows/transforms/linear.py).

``Linear.precompute()`` bakes (weight, inverse, logabsdet) into three
non-persistent buffers, in place, for repeated evaluation; the cached
forward and inverse are then one fp32 product each (fp32 under PyTorch's
default ``torch.backends.cuda.matmul.allow_tf32 = False``, as the JAX
package asks ``Precision.HIGHEST``). ``invalidate_cache()`` empties them.
The caches are computed without gradients: precompute for serving, not for
training. No kernel runs here: the products, ``slogdet`` and the LU solves
are PyTorch's on the tensor's device, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.transforms.base import Transform
from nflows_tpu_torch.utils import linalg
from nflows_tpu_torch.utils.shapes import is_positive_int

__all__ = ["Linear", "NaiveLinear", "precompute_linear_caches"]

CACHES = ("cache_weight", "cache_inverse", "cache_logabsdet")


def _per_sample(value, inputs):
    """A scalar logabsdet repeated for each row of ``inputs``."""
    return value * torch.ones(inputs.shape[0], dtype=inputs.dtype, device=inputs.device)


class Linear(Transform):
    """Abstract base for transforms y = W x + b with a parameterised W.

    Subclasses implement ``forward_no_cache`` / ``inverse_no_cache`` /
    ``weight`` / ``weight_inverse`` / ``logabsdet``. ``weight()`` is
    [out, in]: application is ``x @ W.T + b``."""

    def __init__(self, features, using_cache=False, device=None):
        super().__init__()
        if not is_positive_int(features):
            raise TypeError("Number of features must be a positive integer.")
        self.features = features
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.using_cache = using_cache
        for name in CACHES:
            self.register_buffer(name, None, persistent=False)

    @torch.no_grad()
    def precompute(self) -> "Linear":
        """Fill the caches (one factorisation where the subclass shares
        one, as NaiveLinear's LU) and use them; returns ``self``."""
        inverse, logabsdet = self.weight_inverse_and_logabsdet()
        # a copy: NaiveLinear's weight() is its parameter, which training moves
        self.cache_weight = self.weight().detach().clone()
        self.cache_inverse = inverse
        self.cache_logabsdet = logabsdet
        self.using_cache = True
        return self

    def invalidate_cache(self) -> "Linear":
        """Empty the caches and stop using them; returns ``self``."""
        for name in CACHES:
            setattr(self, name, None)
        self.using_cache = False
        return self

    def forward(self, inputs, context=None):
        if self.using_cache and self.cache_weight is not None:
            outputs = inputs @ self.cache_weight.T + self.bias
            return outputs, _per_sample(self.cache_logabsdet, inputs)
        return self.forward_no_cache(inputs)

    def inverse(self, inputs, context=None):
        if self.using_cache and self.cache_inverse is not None:
            outputs = (inputs - self.bias) @ self.cache_inverse.T
            return outputs, _per_sample(-self.cache_logabsdet, inputs)
        return self.inverse_no_cache(inputs)

    def weight_and_logabsdet(self):
        return self.weight(), self.logabsdet()

    def weight_inverse_and_logabsdet(self):
        return self.weight_inverse(), self.logabsdet()

    def forward_no_cache(self, inputs):
        raise NotImplementedError()

    def inverse_no_cache(self, inputs):
        raise NotImplementedError()

    def weight(self):
        raise NotImplementedError()

    def weight_inverse(self):
        raise NotImplementedError()

    def logabsdet(self):
        raise NotImplementedError()


class NaiveLinear(Linear):
    """Unconstrained weight matrix ``weight_param``: slogdet in the forward,
    an LU solve in the inverse (reference linear.py:129-229). Its start is a
    Haar-random orthogonal matrix, or U(-1/sqrt(D), 1/sqrt(D)) entries, drawn
    from ``generator``."""

    def __init__(self, features, orthogonal_initialization=True, using_cache=False,
                 generator=None, device=None):
        super().__init__(features, using_cache, device=device)
        generator = default_generator(generator)
        if orthogonal_initialization:
            weight = linalg.random_orthogonal(features, generator=generator)
        else:
            stdv = 1.0 / math.sqrt(features)
            weight = (torch.rand(features, features, generator=generator) * 2.0 - 1.0) * stdv
        self.weight_param = nn.Parameter(weight.to(device))

    def forward_no_cache(self, inputs):
        outputs = F.linear(inputs, self.weight_param, self.bias)
        return outputs, _per_sample(linalg.logabsdet(self.weight_param), inputs)

    def inverse_no_cache(self, inputs):
        lu, pivots = torch.linalg.lu_factor(self.weight_param)
        outputs = torch.linalg.lu_solve(lu, pivots, (inputs - self.bias).T).T
        logabsdet = -torch.sum(torch.log(torch.abs(torch.diagonal(lu))))
        return outputs, _per_sample(logabsdet, inputs)

    def weight(self):
        return self.weight_param

    def weight_inverse(self):
        return torch.linalg.inv(self.weight_param)

    def weight_inverse_and_logabsdet(self):
        lu, pivots = torch.linalg.lu_factor(self.weight_param)
        identity = torch.eye(self.features, dtype=lu.dtype, device=lu.device)
        weight_inverse = torch.linalg.lu_solve(lu, pivots, identity)
        return weight_inverse, torch.sum(torch.log(torch.abs(torch.diagonal(lu))))

    def logabsdet(self):
        return linalg.logabsdet(self.weight_param)


def precompute_linear_caches(module: nn.Module) -> nn.Module:
    """``precompute()`` every :class:`Linear` in ``module``, in place, for
    serving; returns ``module``."""
    for m in module.modules():
        if isinstance(m, Linear):
            m.precompute()
    return module
