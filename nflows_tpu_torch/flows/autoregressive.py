"""Prebuilt Masked Autoregressive Flow (counterpart of
nflows_tpu/flows/autoregressive.py; reference
nflows/flows/autoregressive.py:13-62).

``num_layers`` x [permutation, affine masked-autoregressive transform,
and with ``batch_norm_between_layers`` a ``BatchNorm``], StandardNormal
base. With batch norm the flow samples only in eval mode, after
``flow.transform.initialize_with_data(batch)`` has set the running
statistics.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from nflows_tpu_torch.distributions.normal import StandardNormal
from nflows_tpu_torch.flows.base import Flow
from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.transforms.autoregressive import (
    MaskedAffineAutoregressiveTransform,
)
from nflows_tpu_torch.transforms.base import CompositeTransform
from nflows_tpu_torch.transforms.normalization import BatchNorm
from nflows_tpu_torch.transforms.permutations import (
    RandomPermutation,
    ReversePermutation,
)
from nflows_tpu_torch.utils.device import resolve_device

__all__ = ["MaskedAutoregressiveFlow"]


class MaskedAutoregressiveFlow(Flow):
    """MAF (Papamakarios et al., NeurIPS 2017).

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; None =
    fresh seed) and random permutations from the numpy ``rng``. The model
    lives on ``device``: ``cuda`` by default, which must exist; pass
    ``device="cpu"`` for the CPU.
    """

    def __init__(self, features, hidden_features, num_layers,
                 num_blocks_per_layer, use_residual_blocks=True,
                 use_random_masks=False, use_random_permutations=False,
                 generator=None, activation=F.relu, dropout_probability=0.0,
                 batch_norm_within_layers=False, batch_norm_between_layers=False,
                 rng=None, device=None):
        device = resolve_device(device)
        generator = default_generator(generator)
        if rng is None:
            rng = np.random.default_rng()

        layers = []
        for _ in range(num_layers):
            if use_random_permutations:
                layers.append(RandomPermutation(features, rng=rng, device=device))
            else:
                layers.append(ReversePermutation(features, device=device))
            layers.append(MaskedAffineAutoregressiveTransform(
                features=features,
                hidden_features=hidden_features,
                num_blocks=num_blocks_per_layer,
                use_residual_blocks=use_residual_blocks,
                random_mask=use_random_masks,
                generator=generator,
                activation=activation,
                dropout_probability=dropout_probability,
                use_batch_norm=batch_norm_within_layers,
                device=device,
            ))
            if batch_norm_between_layers:
                layers.append(BatchNorm(features, device=device))

        super().__init__(
            transform=CompositeTransform(layers),
            distribution=StandardNormal([features]),
        )
        self.to(device)
