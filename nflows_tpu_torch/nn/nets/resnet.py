"""Residual conditioner network (counterpart of
nflows_tpu/nn/nets/resnet.py; reference nflows/nn/nets/resnet.py:9-100).

Initial layer on [inputs || context], ``num_blocks`` pre-activation
residual blocks with a context GLU, final projection. The second linear
layer of each block starts near zero (U(-1e-3, 1e-3)), so couplings start
near the identity. Batch norm inside the blocks is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from nflows_tpu_torch.nn.primitives import Dense, Dropout, default_generator, glu

__all__ = ["ResidualBlock", "ResidualNet"]


class ResidualBlock(nn.Module):
    """Pre-activation residual block for 1-dim inputs."""

    def __init__(self, features, context_features, generator=None,
                 activation=F.relu, dropout_probability=0.0,
                 use_batch_norm=False, zero_initialization=True, device=None):
        super().__init__()
        if use_batch_norm:
            raise NotImplementedError(
                "batch norm inside ResidualBlock is not ported yet")
        generator = default_generator(generator)
        self.activation = activation
        self.batch_norm_0 = None
        self.context_layer = (
            Dense(context_features, features, generator=generator, device=device)
            if context_features is not None else None)
        self.linear_0 = Dense(features, features, generator=generator, device=device)
        self.linear_1 = Dense(
            features, features, generator=generator, device=device,
            w_init_scale=1e-3 if zero_initialization else None)
        self.dropout = Dropout(dropout_probability)

    def forward(self, inputs, context=None, generator=None):
        temps = self.activation(inputs)
        temps = self.linear_0(temps)
        temps = self.activation(temps)
        temps = self.dropout(temps, generator=generator)
        temps = self.linear_1(temps)
        if context is not None:
            temps = glu(torch.cat([temps, self.context_layer(context)], dim=1), dim=1)
        return inputs + temps


class ResidualNet(nn.Module):
    """General-purpose residual conditioner for 1-dim inputs."""

    def __init__(self, in_features, out_features, hidden_features,
                 context_features=None, num_blocks=2, generator=None,
                 activation=F.relu, dropout_probability=0.0,
                 use_batch_norm=False, device=None):
        super().__init__()
        generator = default_generator(generator)
        self.context_features = context_features
        self.hidden_features = hidden_features
        self.initial_layer = Dense(in_features + (context_features or 0),
                                   hidden_features, generator=generator,
                                   device=device)
        self.blocks = nn.ModuleList(
            ResidualBlock(hidden_features, context_features, generator=generator,
                          activation=activation,
                          dropout_probability=dropout_probability,
                          use_batch_norm=use_batch_norm, device=device)
            for _ in range(num_blocks))
        self.final_layer = Dense(hidden_features, out_features,
                                 generator=generator, device=device)

    def forward(self, inputs, context=None, generator=None):
        if context is None:
            temps = self.initial_layer(inputs)
        else:
            temps = self.initial_layer(torch.cat([inputs, context], dim=1))
        for block in self.blocks:
            temps = block(temps, context=context, generator=generator)
        return self.final_layer(temps)
