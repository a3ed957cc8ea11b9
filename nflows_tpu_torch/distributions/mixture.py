"""Mixture distributions (counterpart of nflows_tpu/distributions/mixture.py;
reference nflows/distributions/mixture.py:7-42)."""

from __future__ import annotations

import torch.nn.functional as F

from nflows_tpu_torch.distributions.base import Distribution
from nflows_tpu_torch.nn.nde import MixtureOfGaussiansMADE

__all__ = ["MADEMoG"]


class MADEMoG(Distribution):
    """Wraps MixtureOfGaussiansMADE as a Distribution. Its defaults are the
    reference's: one component, no custom initialisation."""

    def __init__(self, features, hidden_features, context_features,
                 num_blocks=2, num_mixture_components=1,
                 use_residual_blocks=True, random_mask=False, generator=None,
                 activation=F.relu, dropout_probability=0.0,
                 use_batch_norm=False, custom_initialization=False, rng=None,
                 device=None):
        super().__init__()
        self.made = MixtureOfGaussiansMADE(
            features=features,
            hidden_features=hidden_features,
            context_features=context_features,
            num_blocks=num_blocks,
            num_mixture_components=num_mixture_components,
            use_residual_blocks=use_residual_blocks,
            random_mask=random_mask,
            generator=generator,
            activation=activation,
            dropout_probability=dropout_probability,
            use_batch_norm=use_batch_norm,
            custom_initialization=custom_initialization,
            rng=rng,
            device=device,
        )

    def _log_prob(self, inputs, context=None):
        return self.made.log_prob(inputs, context=context)

    def _sample(self, generator, num_samples, context=None):
        return self.made.sample(generator, num_samples, context=context)
