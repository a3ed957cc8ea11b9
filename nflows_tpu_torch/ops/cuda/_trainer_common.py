"""Shared machinery of the fused trainers (counterpart of
nflows_tpu/ops/pallas/_trainer_common.py, its single-device part).

``FusedTrainerBase`` owns what a fused trainer of any family shares: batch
validation, the conditionality guard, the NLL loss on the fused apply, and
the train steps; and the rule by which the training kernels B3, B4, B10
and B12 spread a tile over a thread-block cluster (:func:`cluster_size`,
:func:`cluster_layout`, :func:`query_active_clusters`). Subclasses set
``weights`` (a dict of leaf tensors that require grad), ``features``,
``context_features``, ``device`` and ``_has_ctx``, and provide:

- ``_apply(weights, x, context=None) -> (y, logabsdet)``: the
  differentiable fused forward (its backward is a kernel);
- ``_build_loss_grad()``: optionally, a one-kernel
  ``(weights, x, context=None) -> (loss, grads)``;
- ``_tile_rows(n)``: the kernels' tile size for a batch of n.

Every step routes through ``loss_fn`` / ``_loss_from_apply``, so a subclass
that redefines the loss changes every step at once.

Where the JAX class is functional (``step(weights, opt_state, batch)``
returns new ones), PyTorch's optimizers update in place: a step here takes
the batch, updates ``trainer.weights`` through the optimizer and returns
the loss. :meth:`FusedTrainerBase.make_scan_train_step` runs a window of
such steps in one dispatch: on the card a CUDA graph of a few steps,
captured once and replayed (``core._window``), with an optimizer built
``capturable=True`` (or ``fused=True``); on the CPU a loop of the step. The
data-parallel and ZeRO steps are still to port.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict

import torch

from nflows_tpu_torch.ops.cuda import _build
from nflows_tpu_torch.core._window import StepWindow

__all__ = ["FusedTrainerBase", "CLUSTER_SIZES", "cluster_gemm_floats", "cluster_size",
           "cluster_layout", "query_active_clusters"]

# the cluster sizes the cluster layouts of B3/B4 (csrc/nsf_train_cluster.cu),
# B10 (csrc/maf_train_cluster.cu) and B12 (csrc/mademog_train_cluster.cu)
# instantiate
CLUSTER_SIZES = (2, 4, 8)


def cluster_gemm_floats(rows: int) -> int:
    """The GEMM buffer of a block of a cluster layout, in floats
    (csrc/cluster_gemm.cuh: WBUF): a ring of two 128 x 32 weight chunks and
    the warps' partial tiles [rows / 4][32][rows]."""
    return 2 * 128 * 32 + rows // 4 * 32 * rows


def cluster_size(n: int, rows: int, sms: int, active_clusters: Dict[int, int]) -> int:
    """The blocks a tile of a training kernel is spread over: the largest
    cluster size CS of ``active_clusters`` ({CS: the clusters of CS blocks
    the card holds at once}) whose clusters hold every 32-sample tile in one
    wave, else 1, one block a tile (``sms`` blocks hold ``sms`` tiles at
    once)."""
    tiles = -(-n // rows)
    best = 1
    if rows != 32 or tiles >= sms:
        return best
    for cs, clusters in sorted(active_clusters.items()):
        if clusters < 1:
            raise ValueError(f"no cluster of {cs} blocks fits the card")
        if clusters >= tiles:
            best = cs
    return best


def cluster_layout(n: int, rows: int, sms: int, active: Callable[[int], int],
                   cluster=None, what="the training kernel"):
    """(cluster size, grid) of a launch over ``n`` samples in tiles of
    ``rows``: ``cluster`` as given (1, or one of CLUSTER_SIZES with
    32-sample tiles), or chosen by :func:`cluster_size`, asking
    ``active(cs)`` for the occupancy only where a cluster could help. The
    grid is min(tiles, SMs) blocks, or the cluster size times min(tiles,
    active clusters)."""
    tiles = -(-n // rows)
    if cluster is None:
        idle = rows == 32 and tiles < sms   # where a cluster could help
        cluster = cluster_size(n, rows, sms, {cs: active(cs) for cs in CLUSTER_SIZES
                                              if idle and cs <= sms})
    elif cluster != 1 and (cluster not in CLUSTER_SIZES or rows != 32):
        raise ValueError(f"{what}: clusters of {cluster} blocks are not built for tiles of "
                         f"{rows} samples (sizes {CLUSTER_SIZES}, 32-sample tiles)")
    grid = max(1, min(tiles, sms)) if cluster == 1 else cluster * min(tiles, active(cluster))
    return cluster, grid


def query_active_clusters(cache: dict, key, dev, query, what: str, cs: int, smem: int) -> int:
    """cudaOccupancyMaxActiveClusters through a C entry point: ``query(found)``
    writes it into the ``ctypes.c_int`` behind the pointer ``found`` and
    returns a cudaError_t. Asked once for each ``key`` and kept in ``cache``;
    raises where it is 0."""
    if key not in cache:
        found = ctypes.c_int(0)
        with torch.cuda.device(dev):
            code = query(ctypes.byref(found))
        _build.check(code, what)
        if found.value < 1:
            raise RuntimeError(f"no cluster of {cs} blocks with {smem} bytes of shared "
                               "memory a block fits the card")
        cache[key] = found.value
    return cache[key]


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

    def _apply(self, weights, x, context=None):
        raise NotImplementedError

    def _build_loss_grad(self):
        """Optional one-kernel ``(weights, x, context) -> (loss, grads)``. It must
        encode the objective of ``_loss_from_apply``; a subclass that
        overrides that loss is sent to autograd over its own loss by
        ``_value_and_grad`` even if it inherits this hook."""
        return None

    # -- loss --------------------------------------------------------------

    def _guard_ctx(self, context, batch=None):
        """A conditional trainer must not run without its context, and an
        unconditional one must not drop a context it was given. Returns the
        context as contiguous float32, checked against ``batch``'s rows."""
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
        if context is not None and batch is not None:
            if tuple(context.shape) != (batch.shape[0], self.context_features):
                raise ValueError(
                    "expected a context of shape "
                    f"{(batch.shape[0], self.context_features)}, got {tuple(context.shape)}")
            context = context.to(torch.float32).contiguous()
        return context

    def _loss_from_apply(self, apply):
        """-mean log_prob through a given fused apply."""
        log_z = 0.5 * self.features * math.log(2.0 * math.pi)

        def loss(weights, batch, context=None):
            context = self._guard_ctx(context, batch)
            y, lad = apply(weights, batch, context)
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
            context = self._guard_ctx(context, batch)
            with torch.no_grad():
                return lg(weights, batch, context)

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

    def make_scan_train_step(self, optimizer):
        """``steps(batches[, contexts]) -> losses``: one step of
        :meth:`make_train_step` for each ``batches[i]`` of ``batches``
        [S, N, D] (and ``contexts[i]`` of ``contexts`` [S, N, C] for a
        conditional trainer), in one dispatch; ``losses`` [S] are on the
        trainer's device and ``trainer.weights`` update in place. It runs
        the same kernels as a step (B3 for couplings, B9 + B10 for MAF and
        NSF-AR, B11 + B12 for the MoG-MADEs).

        On the card the window's first two steps at a new batch shape (or
        with a new optimizer) run eagerly, and the rest replay CUDA graphs of
        eight steps (and one of the remainder), captured once for each batch
        shape; ``optimizer`` (from :meth:`init_opt`) must be built with
        ``capturable=True`` (or ``fused=True``), e.g.
        ``trainer.init_opt(lambda p: torch.optim.Adam(p, lr=3e-4,
        capturable=True))``. The graphs are kept until ``steps`` is
        collected. On the CPU the window is a loop of the step."""
        vag = self._value_and_grad()
        window = StepWindow()

        def one(batch, context=None):
            return self._update(vag, optimizer, batch, context)

        if self._has_ctx:
            def steps(batches, contexts):
                return window.run(one, (batches, contexts), optimizer, self.device)
        else:
            def steps(batches):
                return window.run(one, (batches,), optimizer, self.device)

        steps.window = window
        return steps

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
