"""Single-device training building blocks (counterpart of
nflows_tpu/training/train.py): the eager route.

    state = create_train_state(flow, lambda p: torch.optim.Adam(p, lr=3e-4))
    step = make_train_step()
    state, metrics = step(state, batch)          # metrics["loss"]: 0-dim tensor

One step is ``loss_fn(flow, batch, context)``, ``backward()`` and
``optimizer.step()``: autograd through the unfused chain, whose couplings
run kernel B1 on the card (B1's backward is autograd of its plain version).
The conditioner's GEMMs are ``nn.Linear``, as the JAX package leaves them to
XLA. For the fused route see :mod:`nflows_tpu_torch.training.fused`.

Where the JAX package partitions the flow into trainable and static leaves
and threads an optax state through a jitted step, here the flow is an
``nn.Module`` and the optimizer a ``torch.optim.Optimizer``; both update in
place, and the state returned by a step is the state passed in. ``jit``,
``donate`` and ``remat`` have no counterpart and are not arguments. A
window of steps in one dispatch (``make_scan_train_step``) is still to port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

__all__ = ["TrainState", "create_train_state", "make_train_step", "nll_loss"]


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


def make_train_step(loss_fn: Callable = nll_loss):
    """Build ``step(state, batch, context=None) -> (state, metrics)``.

    The flow's parameters and the optimizer's moments update in place;
    ``metrics["loss"]`` is a detached 0-dim tensor on the flow's device
    (reading it synchronises)."""

    def step(state: TrainState, batch, context=None):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.flow, batch, context)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step
