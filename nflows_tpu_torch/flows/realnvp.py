"""Prebuilt simplified RealNVP (counterpart of nflows_tpu/flows/realnvp.py;
reference nflows/flows/realnvp.py:17-71).

Affine (or, volume-preserving, additive) coupling layers on a 1-dim
checkerboard mask that flips every layer, with ResidualNet conditioners
and a StandardNormal base; no permutations, no multiscale. With
``batch_norm_between_layers`` a ``BatchNorm`` follows each coupling, and
the flow samples only in eval mode, after
``flow.transform.initialize_with_data(batch)``.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from nflows_tpu_torch.distributions.normal import StandardNormal
from nflows_tpu_torch.flows.base import Flow
from nflows_tpu_torch.nn import nets
from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.transforms.base import CompositeTransform
from nflows_tpu_torch.transforms.coupling import (
    AdditiveCouplingTransform,
    AffineCouplingTransform,
)
from nflows_tpu_torch.transforms.normalization import BatchNorm
from nflows_tpu_torch.utils.device import resolve_device

__all__ = ["SimpleRealNVP"]


class SimpleRealNVP(Flow):
    """RealNVP for 1-dim inputs: checkerboard masking, no multiscale.

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; None =
    fresh seed). The model lives on ``device``: ``cuda`` by default, which
    must exist; pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, features, hidden_features, num_layers,
                 num_blocks_per_layer, use_volume_preserving=False,
                 generator=None, activation=F.relu, dropout_probability=0.0,
                 batch_norm_within_layers=False, batch_norm_between_layers=False,
                 device=None):
        device = resolve_device(device)
        generator = default_generator(generator)
        coupling_constructor = (AdditiveCouplingTransform if use_volume_preserving
                                else AffineCouplingTransform)

        def create_resnet(in_features, out_features):
            return nets.ResidualNet(
                in_features, out_features, hidden_features=hidden_features,
                num_blocks=num_blocks_per_layer, generator=generator,
                activation=activation, dropout_probability=dropout_probability,
                use_batch_norm=batch_norm_within_layers, device=device)

        mask = np.ones(features, dtype=np.float32)
        mask[::2] = -1
        layers = []
        for _ in range(num_layers):
            layers.append(coupling_constructor(
                mask=mask, transform_net_create_fn=create_resnet, device=device))
            mask = mask * -1
            if batch_norm_between_layers:
                layers.append(BatchNorm(features, device=device))

        super().__init__(transform=CompositeTransform(layers),
                         distribution=StandardNormal([features]))
        self.to(device)
