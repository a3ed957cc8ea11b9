"""A window of train steps in one dispatch, shared by the eager route
(``training.make_scan_train_step``) and the fused trainers
(``FusedTrainerBase.make_scan_train_step``): the counterpart of the JAX
package's ``lax.scan`` over steps.

On the card a window is a CUDA graph of ``GRAPH_STEPS`` steps (forward,
backward and ``optimizer.step()``), captured once for each (step count,
input shapes and dtypes, device) and replayed across the window; the host
then makes one input copy, one graph launch and one loss copy a replay where
it made a step's worth of launches. A capture or replay that fails raises:
there is no quiet fallback to a loop of steps.

Capture follows PyTorch's recipe for whole-network capture: warm-up steps
on a side stream, the gradients set to None, then the capture. The warm-up
steps are the window's own first steps, run eagerly on its first inputs:
they create the optimizer's state, the trainers' packed weights and
gradient buffers, load the kernels' libraries and fill the
cluster-occupancy caches, none of which may happen inside a capture. A
window of S steps is therefore exactly S steps whatever the optimizer. They
are taken once for each input shape and optimizer (and again when dropout
is switched on or off); a window after them only replays.

On the CPU, where CUDA graphs do not exist, the window is a loop of the
same step: the window's plain version, which the tests run.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

__all__ = ["StepWindow", "check_capturable", "GRAPH_STEPS", "WARMUP_STEPS"]

# steps a graph holds: 8 steps were faster than 1, or within 0.4%, for every
# trainer windowed on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
# windows phase)
GRAPH_STEPS = 8
WARMUP_STEPS = 2  # a window's first steps, run eagerly on a side stream before a capture


def check_capturable(optimizer) -> None:
    """Raise unless every parameter group of ``optimizer`` can be captured
    in a CUDA graph: ``capturable=True`` (or ``fused=True``), which keeps
    the step count on the device. The window never rebuilds the caller's
    optimizer."""
    for group in optimizer.param_groups:
        if not (group.get("capturable") or group.get("fused")):
            raise ValueError(
                f"a window of steps captures {type(optimizer).__name__}.step() in a CUDA "
                "graph, which needs capturable=True (or fused=True) in every parameter "
                "group; build the optimizer with it, e.g. "
                "lambda p: torch.optim.Adam(p, lr=3e-4, capturable=True)")


def _settings(optimizer):
    """The settings a captured ``optimizer.step()`` bakes in: every group's
    scalars by value, its tensors (a tensor learning rate, read at each
    replay) by address. A change recaptures."""
    def value(v):
        return ("tensor", v.data_ptr()) if torch.is_tensor(v) else v
    return tuple(tuple((k, value(v)) for k, v in sorted(g.items()) if k != "params")
                 for g in optimizer.param_groups)


class _Captured:
    """A graph of some steps, its static input and loss slots, and what it
    was captured for: the optimizer (and so the parameters and state whose
    addresses it reads), the generator it draws from and the settings."""

    def __init__(self, graph, slots, losses, optimizer, generator, settings):
        self.graph, self.slots, self.losses = graph, slots, losses
        self.optimizer, self.generator, self.settings = optimizer, generator, settings

    def fits(self, optimizer, generator, settings) -> bool:
        return (self.optimizer is optimizer and self.generator is generator
                and self.settings == settings)


class StepWindow:
    """Runs windows of one train step. Holds one captured graph (and its
    memory pool) for each step count, input shapes and dtypes and device,
    replaced in place when the optimizer, the generator or the optimizer's
    settings change, until it is collected with the ``steps`` function that
    owns it.

    A graph reads the addresses it captured: the parameters and the
    optimizer's state must be updated in place (as every step of the port
    does), not replaced. After replacing them (``load_state_dict`` of the
    optimizer, new parameter tensors), build a new window."""

    def __init__(self):
        self._graphs = {}   # (count, shapes, device) -> _Captured
        self._warm = {}     # (shapes, device) -> (optimizer, dropout, eager steps taken)

    @property
    def captured(self) -> int:
        """The graphs held."""
        return len(self._graphs)

    def run(self, step: Callable, inputs: Sequence[torch.Tensor], optimizer,
            device: torch.device, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
        """``step(*xs) -> loss`` is one train step, ``optimizer.step()``
        included, on ``xs``, the i-th slice of each of ``inputs`` [S, ...].
        Returns the S losses, float32 on ``device``: on the CPU a loop of
        ``step``, elsewhere graph replays after the warm-up steps."""
        S = inputs[0].shape[0]
        if S < 1 or any(t.ndim < 1 or t.shape[0] != S for t in inputs):
            raise ValueError("a window takes one or more steps' inputs, each [S, ...] with "
                             f"one S; got {[tuple(t.shape) for t in inputs]}")
        if device.type == "cpu":
            return torch.stack([step(*(t[i] for t in inputs)) for i in range(S)]).float()
        check_capturable(optimizer)
        if device.type != "cuda":
            raise ValueError(f"a window runs on the CPU or a CUDA device, not {device}")
        if not torch.cuda.is_available():
            raise RuntimeError(f"a window on {device} is a CUDA graph, and no CUDA device "
                               "is available; pass CPU tensors for a loop of steps")
        for t in inputs:
            if t.device != device:
                raise ValueError(f"a window on {device} got inputs on {t.device}")
        if generator is not None and generator.device.type != "cuda":
            raise ValueError(f"the generator is on {generator.device}; dropout on {device} "
                             "draws from a CUDA generator")
        shapes = tuple((tuple(t.shape[1:]), t.dtype) for t in inputs)
        losses = torch.empty(S, dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            done = self._warm_up(step, inputs, losses, optimizer, device, generator, shapes)
            while done < S:
                count = min(GRAPH_STEPS, S - done)
                cap = self._capture(count, step, shapes, optimizer, device, generator)
                for t, slot in zip(inputs, cap.slots):
                    slot.copy_(t[done:done + count])
                cap.graph.replay()
                losses[done:done + count].copy_(cap.losses)
                done += count
        return losses

    def _warm_up(self, step, inputs, losses, optimizer, device, generator, shapes):
        """Run the window's first steps eagerly on a side stream, as many as
        the warm-up at these shapes, with this optimizer (and dropout on or
        off) still wants; returns how many."""
        key = (shapes, device)
        dropout = generator is not None
        owner, had_dropout, taken = self._warm.get(key, (None, None, 0))
        if owner is not optimizer or had_dropout != dropout:
            taken = 0
        count = min(WARMUP_STEPS - taken, losses.shape[0])
        if count <= 0:
            return 0
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for i in range(count):
                losses[i].copy_(step(*(t[i] for t in inputs)))
        torch.cuda.current_stream(device).wait_stream(side)
        self._warm[key] = (optimizer, dropout, taken + count)
        return count

    def _capture(self, count, step, shapes, optimizer, device, generator):
        key = (count, shapes, device)
        settings = _settings(optimizer)
        cap = self._graphs.get(key)
        if cap is not None and cap.fits(optimizer, generator, settings):
            return cap
        self._graphs.pop(key, None)   # release the old graph's pool before capturing anew
        slots = [torch.empty((count,) + shape, dtype=dtype, device=device)
                 for shape, dtype in shapes]
        optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        out = torch.empty(count, dtype=torch.float32, device=device)
        with torch.cuda.graph(graph):
            for j in range(count):
                out[j].copy_(step(*(slot[j] for slot in slots)))
        cap = _Captured(graph, slots, out, optimizer, generator, settings)
        self._graphs[key] = cap
        return cap
