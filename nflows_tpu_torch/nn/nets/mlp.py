"""Plain MLP with shape checking (counterpart of nflows_tpu/nn/nets/mlp.py;
reference nflows/nn/nets/mlp.py:9-68)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nflows_tpu_torch.nn.primitives import Dense, default_generator

__all__ = ["MLP"]


class MLP(nn.Module):
    """A multi-layer perceptron over flattened inputs: ``in_shape`` ->
    ``hidden_sizes`` (each followed by ``activation``) -> ``out_shape``,
    with the activation on the output too when ``activate_output``."""

    def __init__(self, in_shape, out_shape, hidden_sizes, generator=None,
                 activation=F.relu, activate_output: bool = False, device=None):
        super().__init__()
        if len(hidden_sizes) == 0:
            raise ValueError("List of hidden sizes can't be empty.")
        generator = default_generator(generator)
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.activation = activation
        self.activate_output = activate_output
        self.input_layer = Dense(int(np.prod(in_shape)), hidden_sizes[0],
                                 generator=generator, device=device)
        self.hidden_layers = nn.ModuleList(
            Dense(in_size, out_size, generator=generator, device=device)
            for in_size, out_size in zip(hidden_sizes[:-1], hidden_sizes[1:]))
        self.output_layer = Dense(hidden_sizes[-1], int(np.prod(out_shape)),
                                  generator=generator, device=device)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        if tuple(inputs.shape[1:]) != self.in_shape:
            raise ValueError(
                f"Expected inputs of shape {self.in_shape}, got {tuple(inputs.shape[1:])}.")
        outputs = inputs.reshape(-1, int(np.prod(self.in_shape)))
        outputs = self.activation(self.input_layer(outputs))
        for layer in self.hidden_layers:
            outputs = self.activation(layer(outputs))
        outputs = self.output_layer(outputs)
        if self.activate_output:
            outputs = self.activation(outputs)
        return outputs.reshape(-1, *self.out_shape)
