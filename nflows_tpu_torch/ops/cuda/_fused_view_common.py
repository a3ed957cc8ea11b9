"""Serving surface of the fused inference views (counterpart of
nflows_tpu/ops/pallas/_fused_view_common.py).

``FusedFlowView`` owns the Transform contract (forward / inverse) and the
Distribution contract (log_prob / sample / sample_and_log_prob) around a
whole-chain kernel, with the context's embedding and checks. Subclasses
set ``features``, ``context_features``, ``device`` and, for a conditional
flow, ``_embedding_net`` (None: identity), and implement
``_run(x, inverse, context) -> (y, logabsdet)`` on [N, features] float32
rows with the embedded context [N, context_features] or None. Inputs and
contexts of another floating dtype (bf16 requests to a bf16 view) are
widened to fp32 first, as the JAX views cast them. The kernel
masks its ragged last tile, so unlike the TPU views nothing is padded to a
lane tile.

A conditional view runs the flow's embedding net once a call, in PyTorch on
the flow's device, outside the kernel, as ``Flow._embed`` does for a
context that is not None. Conditional sampling draws the noise and repeats
the context rows in the layout of ``Flow._sample``'s context-free-base
branch (flows/base.py), so that the fused and unfused endpoints agree
sample for sample given the same generator.
"""

from __future__ import annotations

import numpy as np
import torch

from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = ["FusedFlowView"]


class FusedFlowView:
    """Common fused-view endpoints; see nsf_fused for usage."""

    _embedding_net = None

    def _run(self, x, inverse, context=None):
        raise NotImplementedError

    def _embed(self, context):
        # a bf16 context (CompiledFlow(dtype=torch.bfloat16)) is widened
        # first: the kernels take fp32 rows
        if context is None:
            return None
        context = context.float()
        return context if self._embedding_net is None else self._embedding_net(context)

    def _check_context(self, context, n):
        if self.context_features is None:
            if context is not None:
                raise ValueError(
                    "this flow was fused without context support but a "
                    "context was passed")
            return None
        if context is None:
            raise ValueError(
                "this flow is conditional; a context of shape "
                f"[N, ...] matching the {n} inputs is required")
        if context.shape[0] != n:
            raise ValueError(
                f"context has {context.shape[0]} rows but inputs have {n}")
        return context

    def _apply(self, inputs, inverse, embedded_context=None):
        if inputs.ndim != 2 or inputs.shape[1] != self.features:
            raise ValueError(
                f"expected [N, {self.features}] inputs, got {tuple(inputs.shape)}")
        if embedded_context is not None:
            embedded_context = embedded_context.float().contiguous()
        return self._run(inputs.float().contiguous(), inverse, embedded_context)

    # -- transform contract ------------------------------------------------

    def forward(self, inputs, context=None):
        context = self._check_context(context, inputs.shape[0])
        return self._apply(inputs, inverse=False, embedded_context=self._embed(context))

    def inverse(self, inputs, context=None):
        context = self._check_context(context, inputs.shape[0])
        return self._apply(inputs, inverse=True, embedded_context=self._embed(context))

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

    def _sample_conditional(self, generator, num_samples, context):
        """([M, n, D] samples, [M, n] log probs) for the M context rows: the
        noise of ``Flow._sample`` with a context-free base ([M n, D] from
        the generator) and each embedded context row repeated n times."""
        if self.context_features is None:
            raise ValueError(
                "this flow was fused without context support but a "
                "context was passed")
        embedded = self._embed(context)
        m = context.shape[0]
        noise = self._noise(generator, num_samples * m)
        samples, logabsdet = self._apply(
            noise, inverse=True,
            embedded_context=shapeutils.repeat_rows(embedded, num_reps=num_samples))
        return (samples.reshape(m, num_samples, self.features),
                (self._log_base(noise) - logabsdet).reshape(m, num_samples))

    def sample(self, generator, num_samples, context=None):
        if context is not None:
            return self._sample_conditional(generator, num_samples, context)[0]
        self._check_context(None, num_samples)
        samples, _ = self._apply(self._noise(generator, num_samples), inverse=True)
        return samples

    def sample_and_log_prob(self, generator, num_samples, context=None):
        if context is not None:
            return self._sample_conditional(generator, num_samples, context)
        self._check_context(None, num_samples)
        noise = self._noise(generator, num_samples)
        samples, logabsdet = self._apply(noise, inverse=True)
        return samples, self._log_base(noise) - logabsdet
