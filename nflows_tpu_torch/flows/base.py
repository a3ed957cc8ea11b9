"""Flow = Distribution(transform of base) (counterpart of
nflows_tpu/flows/base.py; reference nflows/flows/base.py:12-120).

The API is the reference's -- ``log_prob``, ``sample``,
``sample_and_log_prob``, ``transform_to_noise``, with the
``[context_size, num_samples, ...]`` shape convention -- except that
sampling takes an explicit ``torch.Generator`` first, where the JAX
package takes a key.
"""

from __future__ import annotations

from inspect import signature
from typing import Optional

from nflows_tpu_torch.distributions.base import Distribution
from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = ["Flow"]


class Flow(Distribution):
    """Base class for all flow objects."""

    def __init__(self, transform, distribution, embedding_net=None,
                 context_used_in_base: Optional[bool] = None):
        """Args:
            transform: a `Transform` mapping data into noise.
            distribution: base `Distribution` generating the noise.
            embedding_net: optional module encoding the context; None means
                identity.
            context_used_in_base: whether the base distribution consumes
                context. Default: auto-detect from the signature of
                ``distribution.log_prob``.
        """
        super().__init__()
        self.transform = transform
        self.distribution = distribution
        self.embedding_net = embedding_net
        if context_used_in_base is None:
            context_used_in_base = "context" in signature(
                distribution.log_prob).parameters
        self.context_used_in_base = bool(context_used_in_base)

    def _embed(self, context):
        if self.embedding_net is None or context is None:
            return context
        return self.embedding_net(context)

    def _log_prob(self, inputs, context):
        embedded_context = self._embed(context)
        noise, logabsdet = self.transform.forward(inputs, context=embedded_context)
        if self.context_used_in_base:
            log_prob = self.distribution.log_prob(noise, context=embedded_context)
        else:
            log_prob = self.distribution.log_prob(noise)
        return log_prob + logabsdet

    def _noise(self, generator, num_samples, embedded_context, with_log_prob):
        """Base noise (and its log prob), flattened to [C * n, ...] rows
        when there is a context."""
        base = self.distribution
        if embedded_context is None:
            if with_log_prob:
                return base.sample_and_log_prob(generator, num_samples)
            return base.sample(generator, num_samples), None
        if self.context_used_in_base:
            ctx = embedded_context
            n = num_samples
        else:
            # context-free base under a conditional transform: independent
            # noise per (context, sample) pair
            ctx = None
            n = num_samples * embedded_context.shape[0]
        if with_log_prob:
            noise, log_prob = base.sample_and_log_prob(generator, n, context=ctx)
        else:
            noise, log_prob = base.sample(generator, n, context=ctx), None
        noise = noise.reshape(-1, *noise.shape[(2 if ctx is not None else 1):])
        if log_prob is not None:
            log_prob = log_prob.reshape(-1)
        return noise, log_prob

    def _sample(self, generator, num_samples, context):
        embedded_context = self._embed(context)
        noise, _ = self._noise(generator, num_samples, embedded_context, False)
        if embedded_context is not None:
            embedded_context = shapeutils.repeat_rows(embedded_context,
                                                      num_reps=num_samples)
        samples, _ = self.transform.inverse(noise, context=embedded_context)
        if embedded_context is not None:
            samples = shapeutils.split_leading_dim(samples, [-1, num_samples])
        return samples

    def sample_and_log_prob(self, generator, num_samples, context=None):
        """Samples and their log probs in one transform pass."""
        if not shapeutils.is_positive_int(num_samples):
            raise TypeError("Number of samples must be a positive integer.")
        embedded_context = self._embed(context)
        noise, log_prob = self._noise(generator, num_samples, embedded_context, True)
        if embedded_context is not None:
            embedded_context = shapeutils.repeat_rows(embedded_context,
                                                      num_reps=num_samples)
        samples, logabsdet = self.transform.inverse(noise, context=embedded_context)
        log_prob = log_prob - logabsdet
        if embedded_context is not None:
            samples = shapeutils.split_leading_dim(samples, [-1, num_samples])
            log_prob = shapeutils.split_leading_dim(log_prob, [-1, num_samples])
        return samples, log_prob

    def transform_to_noise(self, inputs, context=None):
        """Transforms data into base-distribution noise."""
        noise, _ = self.transform.forward(inputs, context=self._embed(context))
        return noise
