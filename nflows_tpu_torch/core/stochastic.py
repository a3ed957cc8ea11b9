"""Ambient random generator for stochastic layers (dropout) (counterpart of
nflows_tpu/core/stochastic.py).

Rather than threading a ``generator`` argument through every
``forward(inputs, context)`` of the library, stochastic layers read the
generator of the innermost ``stochastic`` context::

    with stochastic(torch.Generator(device="cuda").manual_seed(0)):
        loss = -flow.log_prob(batch).mean()      # every Dropout draws from it

No context (the default) is evaluation: dropout is the identity.

Where the JAX package folds a per-site counter into its key so that every
dropout site gets an independent stream, consecutive draws from one
``torch.Generator`` are already independent streams (each draw advances the
generator's state), so the frame holds the generator alone. On the card a
draw advances the generator's Philox offset; a CUDA graph that draws from it
must register it (``CUDAGraph.register_generator_state``), and then every
replay draws afresh, as the JAX scan folds ``state.step`` into its key.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

__all__ = ["stochastic", "next_generator", "has_stochastic_context"]

_local = threading.local()


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


@contextlib.contextmanager
def stochastic(generator: torch.Generator):
    """Provide ``generator`` to every stochastic layer in the dynamic scope."""
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"stochastic() takes a torch.Generator, got {type(generator).__name__}")
    _stack().append(generator)
    try:
        yield
    finally:
        _stack().pop()


def has_stochastic_context() -> bool:
    return bool(_stack())


def next_generator() -> Optional[torch.Generator]:
    """The innermost context's generator, or None outside any context."""
    stack = _stack()
    return stack[-1] if stack else None
