"""Serving surface of the fused inference views (counterpart of
nflows_tpu/ops/pallas/_fused_view_common.py).

``FusedFlowView`` owns the Transform contract (forward / inverse) and the
Distribution contract (log_prob / sample / sample_and_log_prob) around a
whole-chain kernel. Subclasses set ``features``, ``context_features`` and
``device`` and implement ``_run(x, inverse) -> (y, logabsdet)`` on
[N, features] float32 rows. The kernel masks its ragged last tile, so
unlike the TPU views nothing is padded to a lane tile.

Unconditional only in this slice: a view refuses a context.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["FusedFlowView"]


class FusedFlowView:
    """Common fused-view endpoints; see nsf_fused for usage."""

    def _run(self, x, inverse):
        raise NotImplementedError

    def _check_context(self, context):
        if context is not None:
            raise ValueError(
                "this flow was fused without context support but a "
                "context was passed")

    def _apply(self, inputs, inverse):
        if inputs.ndim != 2 or inputs.shape[1] != self.features:
            raise ValueError(
                f"expected [N, {self.features}] inputs, got {tuple(inputs.shape)}")
        return self._run(inputs.float().contiguous(), inverse)

    # -- transform contract ------------------------------------------------

    def forward(self, inputs, context=None):
        self._check_context(context)
        return self._apply(inputs, inverse=False)

    def inverse(self, inputs, context=None):
        self._check_context(context)
        return self._apply(inputs, inverse=True)

    # -- distribution contract ---------------------------------------------

    def _log_base(self, noise):
        return (-0.5 * (noise ** 2).sum(dim=1)
                - 0.5 * self.features * np.log(2 * np.pi))

    def log_prob(self, inputs, context=None):
        noise, logabsdet = self.forward(inputs, context)
        return self._log_base(noise) + logabsdet

    def _noise(self, generator, num_samples):
        return torch.randn((num_samples, self.features), generator=generator,
                           device=self.device)

    def sample(self, generator, num_samples, context=None):
        self._check_context(context)
        samples, _ = self._apply(self._noise(generator, num_samples), inverse=True)
        return samples

    def sample_and_log_prob(self, generator, num_samples, context=None):
        self._check_context(context)
        noise = self._noise(generator, num_samples)
        samples, logabsdet = self._apply(noise, inverse=True)
        return samples, self._log_base(noise) - logabsdet
