"""Autoregressive Neural Spline Flow prebuilt, RQ-NSF (AR) (counterpart of
nflows_tpu/models/nsf_ar.py).

``num_layers`` x [permutation, RQ-spline masked-autoregressive transform
with linear tails] (Durkan et al. 2019, Table 1). One MADE pass a layer for
log_prob and training; sampling costs D sequential passes a layer. The
constructor mirrors :class:`~nflows_tpu_torch.models.NeuralSplineFlow`'s.
``use_linear_layers=True`` puts an ``LULinear`` (identity at the start)
after each permutation, the NSF paper's AR configuration for the UCI
datasets (arXiv:1906.04032, section 3.2); such a chain runs unfused.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from nflows_tpu_torch.distributions.normal import StandardNormal
from nflows_tpu_torch.flows.base import Flow
from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.transforms.autoregressive import (
    MaskedPiecewiseRationalQuadraticAutoregressiveTransform,
)
from nflows_tpu_torch.transforms.base import CompositeTransform
from nflows_tpu_torch.transforms.lu import LULinear
from nflows_tpu_torch.transforms.permutations import (
    RandomPermutation,
    ReversePermutation,
)
from nflows_tpu_torch.utils.device import resolve_device

__all__ = ["NeuralSplineFlowAR"]


class NeuralSplineFlowAR(Flow):
    """RQ-NSF (autoregressive) for tabular data.

    Weights are drawn from ``generator`` and permutations from the numpy
    ``rng`` (None = derived from the generator's seed, so different seeds
    give different permutations, reproducibly). The model lives on
    ``device``: ``cuda`` by default; pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, features, hidden_features, num_layers=10,
                 num_blocks_per_layer=2, num_bins=8, tail_bound=3.0,
                 context_features=None, use_random_permutations=True,
                 use_linear_layers=False, generator=None, activation=F.relu,
                 dropout_probability=0.0, batch_norm_within_layers=False,
                 rng=None, device=None):
        device = resolve_device(device)
        generator = default_generator(generator)
        if rng is None:
            rng = np.random.default_rng(generator.initial_seed())

        layers = []
        for _ in range(num_layers):
            if use_random_permutations:
                layers.append(RandomPermutation(features, rng=rng, device=device))
            else:
                layers.append(ReversePermutation(features, device=device))
            if use_linear_layers:
                layers.append(LULinear(features, identity_init=True, device=device))
            layers.append(MaskedPiecewiseRationalQuadraticAutoregressiveTransform(
                features=features,
                hidden_features=hidden_features,
                context_features=context_features,
                num_bins=num_bins,
                tails="linear",
                tail_bound=tail_bound,
                num_blocks=num_blocks_per_layer,
                generator=generator,
                activation=activation,
                dropout_probability=dropout_probability,
                use_batch_norm=batch_norm_within_layers,
                device=device,
            ))

        super().__init__(
            transform=CompositeTransform(layers),
            distribution=StandardNormal([features]),
        )
        self.to(device)
