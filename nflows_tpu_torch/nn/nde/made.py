"""MixtureOfGaussiansMADE (counterpart of nflows_tpu/nn/nde/made.py;
reference nflows/nn/nde/made.py:284-427).

A MADE with 3 K outputs per feature: a mixture logit, a mean and an
unconstrained std for each of K components. ``log_prob`` is one parallel
pass and a logsumexp over the components; ``sample`` is the sequential
per-feature pass: D MADE passes, each followed by a categorical and a
normal draw for one feature, from an explicit ``torch.Generator``.

The fused log_prob kernel B11 (``ops/cuda/mademog_fused.py``) computes the
same density in one launch; sampling stays here, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from nflows_tpu_torch.nn.made import MADE
from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = ["MixtureOfGaussiansMADE"]


class MixtureOfGaussiansMADE(MADE):
    """MADE whose outputs parameterize a per-feature mixture of Gaussians.
    Output column ``d * 3K + k * 3 + j`` is parameter j (logit, mean,
    unconstrained std) of component k of feature d."""

    def __init__(self, features, hidden_features, context_features=None,
                 num_blocks=2, num_mixture_components=5,
                 use_residual_blocks=True, random_mask=False, generator=None,
                 activation=F.relu, dropout_probability=0.0,
                 use_batch_norm=False, epsilon=1e-2,
                 custom_initialization=True, rng=None, device=None):
        if use_residual_blocks and random_mask:
            raise ValueError("Residual blocks can't be used with random masks.")
        generator = default_generator(generator)
        super().__init__(
            features, hidden_features,
            context_features=context_features,
            num_blocks=num_blocks,
            output_multiplier=3 * num_mixture_components,
            use_residual_blocks=use_residual_blocks,
            random_mask=random_mask,
            generator=generator,
            activation=activation,
            dropout_probability=dropout_probability,
            use_batch_norm=use_batch_norm,
            rng=rng,
            device=device,
        )
        self.num_mixture_components = num_mixture_components
        self.epsilon = epsilon
        if custom_initialization:
            self._custom_initialize(generator)

    def _custom_initialize(self, generator):
        """Near-uniform mixture coefficients and stds near 1 at init
        (reference nde/made.py:390-427). The weight is ``nn.Linear``'s
        [out, in], so the strided output slots are rows (the JAX package's
        [in, out] weight has them as columns)."""
        eps = self.epsilon
        weight, bias = self.final_layer.weight, self.final_layer.bias
        n_out = self.features * self.num_mixture_components
        fan_in = weight.shape[1]

        def noise(*shape):
            return (eps * torch.randn(shape, generator=generator)).to(weight.device)

        constant = float(np.log(np.exp(1 - eps) - 1))
        with torch.no_grad():
            weight[0::3] = noise(n_out, fan_in)          # logits
            bias[0::3] = noise(n_out)
            weight[2::3] = noise(n_out, fan_in)          # unconstrained stds:
            bias[2::3] = constant + noise(n_out)         # softplus^-1(1 - eps) + noise

    def _mixture_params(self, outputs, batch_shape):
        outputs = outputs.reshape(*batch_shape, self.num_mixture_components, 3)
        logits = outputs[..., 0]
        means = outputs[..., 1]
        unconstrained_stds = outputs[..., 2]
        log_mixture_coefficients = torch.log_softmax(logits, dim=-1)
        # softplus as logaddexp(u, 0), the JAX head's (no threshold branch)
        stds = torch.logaddexp(unconstrained_stds, torch.zeros_like(unconstrained_stds))
        return log_mixture_coefficients, means, stds + self.epsilon

    def log_prob(self, inputs, context=None):
        outputs = self(inputs, context)
        log_coef, means, stds = self._mixture_params(outputs, inputs.shape)
        return torch.sum(
            torch.logsumexp(
                log_coef - 0.5 * (
                    math.log(2 * math.pi)
                    + 2 * torch.log(stds)
                    + ((inputs[..., None] - means) / stds) ** 2
                ),
                dim=-1,
            ),
            dim=-1,
        )

    @torch.no_grad()
    def sample(self, generator: Optional[torch.Generator], num_samples: int,
               context=None):
        """Sequential per-feature ancestral sampling (reference
        nde/made.py:355-388): [num_samples, D], or [C, num_samples, D] for a
        context of C rows. The component is drawn by Gumbel-max, as
        ``jax.random.categorical`` does."""
        if context is not None:
            context = shapeutils.repeat_rows(context, num_samples)
            total = context.shape[0]
        else:
            total = num_samples
        device = self.final_layer.weight.device
        K = self.num_mixture_components
        samples = torch.zeros(total, self.features, device=device)
        tiny = torch.finfo(samples.dtype).tiny
        for feature in range(self.features):
            outputs = self(samples, context)
            log_coef, means, stds = self._mixture_params(outputs, samples.shape)
            u = torch.rand(total, K, generator=generator, device=device).clamp_min(tiny)
            comp = (log_coef[:, feature] - torch.log(-torch.log(u))).argmax(dim=-1,
                                                                            keepdim=True)
            mean = means[:, feature].gather(1, comp)[:, 0]
            std = stds[:, feature].gather(1, comp)[:, 0]
            noise = torch.randn(total, generator=generator, device=device)
            samples[:, feature] = mean + noise * std
        if context is not None:
            return samples.reshape(-1, num_samples, self.features)
        return samples

    def sample_and_log_prob(self, generator, num_samples, context=None):
        """Samples and their log probability, the Distribution contract, so
        that ``CompiledFlow`` serves a bare model as it serves a MADEMoG."""
        from nflows_tpu_torch.distributions.base import Distribution

        return Distribution.sample_and_log_prob(self, generator, num_samples, context)
