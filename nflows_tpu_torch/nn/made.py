"""MADE: masked autoregressive conditioner (counterpart of
nflows_tpu/nn/made.py; reference nflows/transforms/made.py).

Degrees and masks are computed on the host with numpy when the model is
built; a mask is a float buffer of its layer, so it travels with the
model's state. A masked layer is ``x @ (W * M)^T + b``.

``MaskedDense`` is an ``nn.Linear``, so its weight is [out, in] where the
JAX package stores [in, out]; the mask has the weight's orientation. Output
k depends only on inputs before k: the autoregressive transforms rest on
that property.

Batch norm inside the blocks is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nflows_tpu_torch.nn.primitives import Dense, Dropout, default_generator

__all__ = ["MaskedDense", "MaskedFeedforwardBlock", "MaskedResidualBlock", "MADE"]


def _get_input_degrees(in_features: int) -> np.ndarray:
    """Degrees 1..D for MADE inputs (reference made.py:12-14)."""
    return np.arange(1, in_features + 1)


def _mask_and_degrees(in_degrees: np.ndarray, out_features: int,
                      autoregressive_features: int, random_mask: bool,
                      is_output: bool, rng=None):
    """The [out, in] binary mask and the output degrees (reference
    made.py:42-69)."""
    if is_output:
        base = _get_input_degrees(autoregressive_features)
        reps = out_features // autoregressive_features
        # each degree repeated `reps` times contiguously, so reshaping the
        # output to [batch, features, multiplier] keeps feature k's
        # parameters at [:, k, :]
        out_degrees = np.repeat(base, reps)
        mask = (out_degrees[:, None] > in_degrees[None, :]).astype(np.float32)
    else:
        if random_mask:
            if rng is None:
                rng = np.random.default_rng()
            min_in_degree = min(int(np.min(in_degrees)), autoregressive_features - 1)
            out_degrees = rng.integers(
                low=min_in_degree, high=autoregressive_features, size=out_features)
        else:
            max_ = max(1, autoregressive_features - 1)
            min_ = min(1, autoregressive_features - 1)
            out_degrees = np.arange(out_features) % max_ + min_
        mask = (out_degrees[:, None] >= in_degrees[None, :]).astype(np.float32)
    return mask, out_degrees.astype(np.int64)


class MaskedDense(Dense):
    """Linear layer with a fixed binary mask enforcing the degree ordering
    (reference MaskedLinear, made.py:17-72)."""

    def __init__(self, in_degrees, out_features, autoregressive_features,
                 random_mask, is_output, generator=None, use_bias=True, rng=None,
                 w_init_scale=None, device=None):
        in_degrees = np.asarray(in_degrees)
        super().__init__(len(in_degrees), out_features, generator=generator,
                         use_bias=use_bias, w_init_scale=w_init_scale, device=device)
        mask, degrees = _mask_and_degrees(
            in_degrees, out_features, autoregressive_features, random_mask,
            is_output, rng=rng)
        self.register_buffer("mask", torch.from_numpy(mask).to(device))
        self.degrees = tuple(int(d) for d in degrees)

    def forward(self, x):
        return F.linear(x, self.weight * self.mask, self.bias)


def _refuse_batch_norm(use_batch_norm, what):
    if use_batch_norm:
        raise NotImplementedError(f"batch norm inside {what} is not ported yet")


class MaskedFeedforwardBlock(nn.Module):
    """Masked linear -> activation -> dropout (reference made.py:75-123).
    The output is as wide as the input."""

    def __init__(self, in_degrees, autoregressive_features, context_features=None,
                 random_mask=False, generator=None, activation=F.relu,
                 dropout_probability=0.0, use_batch_norm=False, rng=None,
                 device=None):
        super().__init__()
        del context_features  # unused, kept for constructor parity
        _refuse_batch_norm(use_batch_norm, "MaskedFeedforwardBlock")
        in_degrees = np.asarray(in_degrees)
        self.batch_norm = None
        self.linear = MaskedDense(
            in_degrees=in_degrees, out_features=len(in_degrees),
            autoregressive_features=autoregressive_features,
            random_mask=random_mask, is_output=False, generator=generator,
            rng=rng, device=device)
        self.activation = activation
        self.dropout = Dropout(dropout_probability)

    @property
    def degrees(self):
        return self.linear.degrees

    def forward(self, inputs, context=None, generator=None):
        temps = self.linear(inputs)
        temps = self.activation(temps)
        return self.dropout(temps, generator=generator)


class MaskedResidualBlock(nn.Module):
    """Residual block of two masked linears with additive context
    (reference made.py:126-202). Needs non-random masks and output degrees
    no smaller than the input degrees (checked when built)."""

    def __init__(self, in_degrees, autoregressive_features, context_features=None,
                 random_mask=False, generator=None, activation=F.relu,
                 dropout_probability=0.0, use_batch_norm=False,
                 zero_initialization=True, device=None):
        super().__init__()
        if random_mask:
            raise ValueError("Masked residual block can't be used with random masks.")
        _refuse_batch_norm(use_batch_norm, "MaskedResidualBlock")
        generator = default_generator(generator)
        in_degrees = np.asarray(in_degrees)
        features = len(in_degrees)
        self.context_layer = (
            Dense(context_features, features, generator=generator, device=device)
            if context_features is not None else None)
        self.batch_norm_0 = None
        self.batch_norm_1 = None
        self.linear_0 = MaskedDense(
            in_degrees=in_degrees, out_features=features,
            autoregressive_features=autoregressive_features,
            random_mask=False, is_output=False, generator=generator, device=device)
        self.linear_1 = MaskedDense(
            in_degrees=np.asarray(self.linear_0.degrees), out_features=features,
            autoregressive_features=autoregressive_features,
            random_mask=False, is_output=False, generator=generator,
            w_init_scale=1e-3 if zero_initialization else None, device=device)
        if not np.all(np.asarray(self.linear_1.degrees) >= in_degrees):
            raise RuntimeError(
                "In a masked residual block, the output degrees can't be"
                " less than the corresponding input degrees.")
        self.activation = activation
        self.dropout = Dropout(dropout_probability)

    @property
    def degrees(self):
        return self.linear_1.degrees

    def forward(self, inputs, context=None, generator=None):
        temps = self.activation(inputs)
        temps = self.linear_0(temps)
        if context is not None:
            temps = temps + self.context_layer(context)
        temps = self.activation(temps)
        temps = self.dropout(temps, generator=generator)
        temps = self.linear_1(temps)
        return inputs + temps


class MADE(nn.Module):
    """Masked autoregressive network: initial masked layer (plus a context
    projection), ``num_blocks`` blocks, final masked layer with
    ``features * output_multiplier`` outputs (reference made.py:205-283).
    Output column ``k * output_multiplier + j`` is parameter j of feature k.

    Weights are drawn from ``generator`` and random hidden degrees from the
    numpy ``rng``."""

    def __init__(self, features, hidden_features, context_features=None,
                 num_blocks=2, output_multiplier=1, use_residual_blocks=True,
                 random_mask=False, generator=None, activation=F.relu,
                 dropout_probability=0.0, use_batch_norm=False, rng=None,
                 device=None):
        super().__init__()
        if use_residual_blocks and random_mask:
            raise ValueError("Residual blocks can't be used with random masks.")
        generator = default_generator(generator)
        if rng is None:
            rng = np.random.default_rng()
        self.features = features
        self.hidden_features = hidden_features

        self.initial_layer = MaskedDense(
            in_degrees=_get_input_degrees(features), out_features=hidden_features,
            autoregressive_features=features, random_mask=random_mask,
            is_output=False, generator=generator, rng=rng, device=device)
        self.context_layer = (
            Dense(context_features, hidden_features, generator=generator,
                  device=device)
            if context_features is not None else None)
        self.use_residual_blocks = use_residual_blocks
        self.activation = activation

        block_ctor = MaskedResidualBlock if use_residual_blocks else MaskedFeedforwardBlock
        blocks = []
        prev_degrees = np.asarray(self.initial_layer.degrees)
        for _ in range(num_blocks):
            block = block_ctor(
                in_degrees=prev_degrees, autoregressive_features=features,
                context_features=context_features, random_mask=random_mask,
                generator=generator, activation=activation,
                dropout_probability=dropout_probability,
                use_batch_norm=use_batch_norm, device=device,
                **({} if use_residual_blocks else {"rng": rng}))
            blocks.append(block)
            prev_degrees = np.asarray(block.degrees)
        self.blocks = nn.ModuleList(blocks)

        self.final_layer = MaskedDense(
            in_degrees=prev_degrees, out_features=features * output_multiplier,
            autoregressive_features=features, random_mask=random_mask,
            is_output=True, generator=generator, rng=rng, device=device)

    def forward(self, inputs, context=None, generator: Optional[torch.Generator] = None):
        temps = self.initial_layer(inputs)
        if context is not None:
            temps = temps + self.activation(self.context_layer(context))
        if not self.use_residual_blocks:
            temps = self.activation(temps)
        for block in self.blocks:
            temps = block(temps, context, generator=generator)
        return self.final_layer(temps)
