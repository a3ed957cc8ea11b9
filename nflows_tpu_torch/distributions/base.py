"""Distribution protocol (counterpart of nflows_tpu/distributions/base.py;
reference nflows/distributions/base.py:16-128).

Sampling takes an explicit ``torch.Generator`` first, where the JAX
package takes a PRNG key (None draws from PyTorch's default generator of
the device)::

    reference: dist.sample(num_samples, context)
    here:      dist.sample(generator, num_samples, context)

Shape contracts are the reference's:

- ``log_prob(inputs[B, ...], context[B, ...]) -> [B]``
- ``sample(generator, n)                -> [n, ...]``
- ``sample(generator, n, context[C,..]) -> [C, n, ...]``
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = ["Distribution"]


class Distribution(nn.Module):
    """Base class for all distribution objects."""

    def log_prob(self, inputs: torch.Tensor,
                 context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Log probability of ``inputs`` (optionally given ``context``): [batch]."""
        if context is not None and inputs.shape[0] != context.shape[0]:
            raise ValueError(
                "Number of input items must be equal to number of context items.")
        return self._log_prob(inputs, context)

    def _log_prob(self, inputs, context):
        raise NotImplementedError()

    def sample(self, generator: Optional[torch.Generator], num_samples: int,
               context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Samples of shape [n, ...], or [context_size, n, ...] with context."""
        if not shapeutils.is_positive_int(num_samples):
            raise TypeError("Number of samples must be a positive integer.")
        return self._sample(generator, num_samples, context)

    def _sample(self, generator, num_samples, context):
        raise NotImplementedError()

    def sample_and_log_prob(self, generator: Optional[torch.Generator],
                            num_samples: int,
                            context: Optional[torch.Tensor] = None):
        """Samples together with their log probability."""
        samples = self.sample(generator, num_samples, context=context)
        if context is not None:
            samples = shapeutils.merge_leading_dims(samples, num_dims=2)
            context = shapeutils.repeat_rows(context, num_reps=num_samples)
        log_prob = self.log_prob(samples, context=context)
        if context is not None:
            samples = shapeutils.split_leading_dim(samples, [-1, num_samples])
            log_prob = shapeutils.split_leading_dim(log_prob, [-1, num_samples])
        return samples, log_prob
