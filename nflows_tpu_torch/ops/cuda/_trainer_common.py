"""Shared machinery of the fused trainers (counterpart of
nflows_tpu/ops/pallas/_trainer_common.py, its single-device part).

``FusedTrainerBase`` owns what a fused trainer of any family shares: batch
validation, the conditionality guard, the NLL loss on the fused apply, and
the train steps. Subclasses set ``weights`` (a dict of leaf tensors that
require grad), ``features``, ``context_features``, ``device`` and
``_has_ctx``, and provide:

- ``_apply(weights, x) -> (y, logabsdet)``: the differentiable fused
  forward (its backward is a kernel);
- ``_build_loss_grad()``: optionally, a one-kernel
  ``(weights, x) -> (loss, grads)``;
- ``_tile_rows(n)``: the kernels' tile size for a batch of n.

Every step routes through ``loss_fn`` / ``_loss_from_apply``, so a subclass
that redefines the loss changes every step at once.

Where the JAX class is functional (``step(weights, opt_state, batch)``
returns new ones), PyTorch's optimizers update in place: a step here takes
the batch, updates ``trainer.weights`` through the optimizer and returns
the loss. The data-parallel, ZeRO and scanned-window steps are still to
port.
"""

from __future__ import annotations

import math

import torch

__all__ = ["FusedTrainerBase"]


class FusedTrainerBase:
    """Common train-step machinery; see nsf_train for usage."""

    def _init_batching(self, batch_size):
        self.batch_size = int(batch_size)
        if self.batch_size % 128:
            raise ValueError(
                f"batch_size={batch_size} must be a multiple of 128 (the "
                "kernel lane width of the JAX package, kept so that one call "
                "behaves the same in both)")
        # samples a block of the kernels holds at a time (None on the CPU)
        self._rows = self._tile_rows(self.batch_size)

    # -- hooks -------------------------------------------------------------

    def _tile_rows(self, n):
        raise NotImplementedError

    def _apply(self, weights, x):
        raise NotImplementedError

    def _build_loss_grad(self):
        """Optional one-kernel ``(weights, x) -> (loss, grads)``. It must
        encode the objective of ``_loss_from_apply``; a subclass that
        overrides that loss is sent to autograd over its own loss by
        ``_value_and_grad`` even if it inherits this hook."""
        return None

    # -- loss --------------------------------------------------------------

    def _guard_ctx(self, context):
        """A conditional trainer must not run without its context, and an
        unconditional one must not drop a context it was given."""
        if self._has_ctx and context is None:
            raise ValueError(
                "this trainer wraps a conditional flow "
                f"(context_features={self.context_features}); pass the "
                "context -- omitting it would silently drop the context "
                "weights from the kernel")
        if not self._has_ctx and context is not None:
            raise ValueError(
                "this trainer wraps an unconditional flow; got an unexpected "
                "context")

    def _loss_from_apply(self, apply):
        """-mean log_prob through a given fused apply."""
        log_z = 0.5 * self.features * math.log(2.0 * math.pi)

        def loss(weights, batch, context=None):
            self._guard_ctx(context)
            y, lad = apply(weights, batch)
            lp = -0.5 * (y * y).sum(dim=1) - log_z + lad
            return -lp.mean()

        return loss

    def loss_fn(self, weights, batch, context=None):
        """-mean log_prob of ``batch`` [N, D], differentiable with respect
        to ``weights`` (and ``batch``) through the fused apply."""
        return self._loss_from_apply(self._apply)(weights, batch, context)

    def _value_and_grad(self):
        """``(weights, batch, context) -> (loss, grads)``: the one-kernel
        route when the subclass provides one and the loss is the base NLL,
        else autograd over the fused apply (forward kernel, then backward
        kernel)."""
        custom_loss = (type(self)._loss_from_apply
                       is not FusedTrainerBase._loss_from_apply)
        lg = None if custom_loss else self._build_loss_grad()
        if lg is None:
            loss_of = self._loss_from_apply(self._apply)

            def vag(weights, batch, context=None):
                loss = loss_of(weights, batch, context)
                keys = list(weights)
                grads = torch.autograd.grad(loss, [weights[k] for k in keys])
                return loss.detach(), dict(zip(keys, grads))

            return vag

        def vag(weights, batch, context=None):
            self._guard_ctx(context)
            with torch.no_grad():
                return lg(weights, batch)

        return vag

    # -- train steps ---------------------------------------------------------

    def init_opt(self, optimizer):
        """The optimizer over the trainer's weights. ``optimizer`` is a
        callable from a list of tensors to a ``torch.optim.Optimizer``, e.g.
        ``lambda p: torch.optim.Adam(p, lr=3e-4)``."""
        return optimizer([self.weights[k] for k in self.weights])

    def _check_batch(self, batch):
        if tuple(batch.shape) != (self.batch_size, self.features):
            raise ValueError(
                f"expected a batch of shape {(self.batch_size, self.features)}, "
                f"got {tuple(batch.shape)}")
        return batch.to(torch.float32).contiguous()

    def _update(self, vag, optimizer, batch, context):
        loss, grads = vag(self.weights, self._check_batch(batch), context)
        for k, w in self.weights.items():
            w.grad = grads[k]
        optimizer.step()
        return loss

    def make_train_step(self, optimizer):
        """``step(batch[, context]) -> loss`` over ``trainer.weights``, which
        ``optimizer`` (from :meth:`init_opt`) updates in place. The loss is
        a 0-dim tensor on the device; reading it synchronises. For another
        objective, differentiate :meth:`loss_fn` (or the fused apply) with
        autograd: its backward is the backward kernel."""
        vag = self._value_and_grad()

        def step(batch, context=None):
            return self._update(vag, optimizer, batch, context)

        return step

    def init_loop_state(self, optimizer):
        """A ``TrainState`` carrying the kernel-layout weights as its
        ``params``, for loops written against ``step(state, batch)``."""
        from nflows_tpu_torch.training.train import TrainState

        return TrainState(params=self.weights, optimizer=self.init_opt(optimizer))

    def make_loop_step(self):
        """``step(state, batch[, context]) -> (state, {"loss": loss})`` over
        the fused loss: the contract of ``training.make_train_step``. Pair
        with :meth:`init_loop_state`."""
        vag = self._value_and_grad()

        def step(state, batch, context=None):
            loss = self._update(vag, state.optimizer, batch, context)
            state.step += 1
            return state, {"loss": loss}

        return step
