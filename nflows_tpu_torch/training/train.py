"""Single-device training building blocks (counterpart of
nflows_tpu/training/train.py): the eager route.

    state = create_train_state(flow, lambda p: torch.optim.Adam(p, lr=3e-4))
    step = make_train_step()
    state, metrics = step(state, batch)          # metrics["loss"]: 0-dim tensor

One step is ``loss_fn(flow, batch, context)``, ``backward()`` and
``optimizer.step()``: autograd through the unfused chain, whose couplings
run their spline kernel on the card (B1, or B5-B8 for the other spline
families; each kernel's backward is autograd of its plain version).
The conditioner's GEMMs are ``nn.Linear``, as the JAX package leaves them to
XLA. For the fused route see :mod:`nflows_tpu_torch.training.fused`.

Where the JAX package partitions the flow into trainable and static leaves
and threads an optax state through a jitted step, here the flow is an
``nn.Module`` and the optimizer a ``torch.optim.Optimizer``; both update in
place, and the state returned by a step is the state passed in. ``jit``,
``donate`` and ``remat`` have no counterpart and are not arguments.

Dropout: where the JAX step takes ``key=``, the port's takes ``generator=``,
a ``torch.Generator`` on the flow's device, made ambient around the loss
(:func:`nflows_tpu_torch.core.stochastic`); without one every dropout is
the identity, as without a key.

A window of steps in one dispatch, the counterpart of the JAX package's
``lax.scan`` over steps::

    state = create_train_state(
        flow, lambda p: torch.optim.Adam(p, lr=3e-4, capturable=True))
    steps = make_scan_train_step()
    state, losses = steps(state, batches)        # batches [S, N, D], losses [S]

On the card the window's first steps at a new batch shape run eagerly, and
the rest replay a CUDA graph of eight steps captured after them
(``core._window``); the optimizer must be capturable (``capturable=True``
or ``fused=True``, else a ``ValueError``). On the CPU it is a loop of
:func:`make_train_step`'s step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from nflows_tpu_torch.core.stochastic import stochastic
from nflows_tpu_torch.core._window import StepWindow

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_scan_train_step",
           "nll_loss"]


@dataclass
class TrainState:
    """What a train step carries: the trainable ``params`` (the flow itself
    on the eager route, the kernel-layout weight dict on the fused route),
    the optimizer bound to them, and the number of steps taken."""

    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def flow(self):
        if not isinstance(self.params, torch.nn.Module):
            raise AttributeError(
                "this state carries kernel-layout weights; the trainer's "
                "to_flow() gives the flow")
        return self.params


def create_train_state(flow, optimizer) -> TrainState:
    """``optimizer`` is a callable from the flow's parameters to a
    ``torch.optim.Optimizer``, or an optimizer already built over them."""
    if not isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer([p for p in flow.parameters() if p.requires_grad])
    return TrainState(params=flow, optimizer=optimizer)


def nll_loss(flow, batch, context=None):
    """Maximum-likelihood loss: mean negative log-probability."""
    return -flow.log_prob(batch, context).mean()


def _update(state: TrainState, loss_fn, batch, context, generator):
    """One step on ``state``: the loss (under ``generator`` where given),
    its backward and the optimizer's update. Returns the detached loss."""
    state.optimizer.zero_grad(set_to_none=True)
    if generator is None:
        loss = loss_fn(state.flow, batch, context)
    else:
        with stochastic(generator):
            loss = loss_fn(state.flow, batch, context)
    loss.backward()
    state.optimizer.step()
    return loss.detach()


def make_train_step(loss_fn: Callable = nll_loss):
    """Build ``step(state, batch, context=None, generator=None) -> (state,
    metrics)``.

    The flow's parameters and the optimizer's moments update in place;
    ``metrics["loss"]`` is a detached 0-dim tensor on the flow's device
    (reading it synchronises). ``generator`` (a ``torch.Generator`` on the
    flow's device) activates dropout, the counterpart of the JAX step's
    ``key``; each draw advances it, so consecutive steps drop different
    units."""

    def step(state: TrainState, batch, context=None, generator=None):
        loss = _update(state, loss_fn, batch, context, generator)
        state.step += 1
        return state, {"loss": loss}

    return step


def make_scan_train_step(loss_fn: Callable = nll_loss):
    """Build ``steps(state, batches, generator=None) -> (state, losses)``:
    one step of :func:`make_train_step` for each ``batches[i]`` of
    ``batches`` [S, N, D], in one dispatch. ``losses`` [S] are on the flow's
    device; the parameters and the optimizer's moments update in place and
    ``state.step`` advances by S. As the JAX window, it takes no context.
    ``generator`` activates dropout as in :func:`make_train_step`; every
    step draws fresh masks.

    On a CUDA flow the window's first two steps at a new batch shape (or
    with a new optimizer) run eagerly, and the rest replay CUDA graphs of
    eight steps (and one of the remainder), captured once for each batch
    shape; the optimizer must be built with ``capturable=True`` (or
    ``fused=True``). The graphs are kept until ``steps`` is collected. On
    a CPU flow the window is a loop of the same step."""
    window = StepWindow()

    def steps(state: TrainState, batches, generator=None):
        device = next(state.flow.parameters()).device

        def one(batch):
            return _update(state, loss_fn, batch, None, generator)

        losses = window.run(one, (batches,), state.optimizer, device, generator)
        state.step += batches.shape[0]
        return state, losses

    steps.window = window
    return steps
