"""Basic layers: Dense, glu, Dropout (counterpart of
nflows_tpu/nn/primitives.py).

Initialisation matches the JAX package's Dense: weight and bias
~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), or U(-s, s) with ``w_init_scale=s``.
Values are drawn on the CPU from an explicit ``torch.Generator`` and then
moved to ``device``, so one seed gives the same weights on every device.
The weight is PyTorch's [out, in]; the JAX package stores [in, out].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from nflows_tpu_torch.core.stochastic import next_generator

__all__ = ["Dense", "Dropout", "glu", "default_generator"]


def default_generator(generator: Optional[torch.Generator] = None) -> torch.Generator:
    """``generator``, or a fresh nondeterministically seeded CPU generator
    (the counterpart of ``ensure_key``)."""
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    return generator


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Gated linear unit: split in half along ``dim``, a * sigmoid(b)."""
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class Dense(nn.Linear):
    """Affine layer y = x W^T + b with the JAX package's initialisation."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = True, w_init_scale: Optional[float] = None,
                 device=None):
        super().__init__(in_features, out_features, bias=use_bias, device="meta")
        generator = default_generator(generator)
        bound = w_init_scale if w_init_scale is not None else 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(
            _uniform((out_features, in_features), bound, generator).to(device))
        if use_bias:
            self.bias = nn.Parameter(
                _uniform((out_features,), bound, generator).to(device))


class Dropout(nn.Module):
    """Dropout active only when a generator is available, as the JAX Dropout
    is active only with a key: pass ``generator=`` directly, or enter
    ``nflows_tpu_torch.core.stochastic(generator)`` around the loss and every
    dropout site draws from it (``make_train_step``'s ``generator=`` does
    that). No generator (the default) = evaluation = identity. The
    generator must be on the inputs' device."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0:
            return x
        if generator is None:
            generator = next_generator()
        if generator is None:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))
