"""Serving: fixed-shape flow endpoints (counterpart of nflows_tpu/serving.py).

    served = CompiledFlow(flow, batch_size=1024, features=6)
    lp = served.log_prob(x)                       # x: [1024, 6]
    s  = served.sample(generator)                 # [num_samples, 6]
    s, lp = served.sample_and_log_prob(generator)

The JAX class compiles each endpoint ahead of time; PyTorch runs eagerly,
so nothing is compiled here and the name is kept for the surface. Requests
of another shape are refused, as there.

Serving is the amortised-inference context, so a fused kernel is the
default whenever the model qualifies (``use_fused=None``): B2 for RQ
coupling chains (``fuse_nsf``), B9 for autoregressive chains
(``fuse_maf``), B11 for the log_prob of a MADEMoG or a bare
MixtureOfGaussiansMADE (``fuse_mademog``; its sampling endpoints run the
model's sequential sampler, as in the JAX package), probed in that order.
Only a structural ``ValueError``/``AttributeError`` from every prober sends
a flow to the unfused chain (where each RQ spline launches kernel B1 on the
card); a kernel that fails to build or launch raises. ``use_fused=True``
raises with each prober's reason when the flow does not qualify;
``use_fused=False`` serves the unfused chain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nflows_tpu_torch.utils.device import resolve_device

__all__ = ["CompiledFlow"]


class CompiledFlow:
    """Fixed-shape serving wrapper around a Flow."""

    def __init__(self, flow, batch_size: int, features: int,
                 num_samples: Optional[int] = None,
                 context_features: Optional[int] = None,
                 dtype=torch.float32, use_fused: Optional[bool] = None,
                 device=None):
        self.device = resolve_device(device)
        flow_devices = {p.device for p in flow.parameters()}
        if flow_devices - {self.device}:
            raise ValueError(
                f"the flow's parameters live on {sorted(map(str, flow_devices))} "
                f"but CompiledFlow serves on {self.device}")
        if dtype != torch.float32:
            raise NotImplementedError(
                f"serving runs float32 only so far, not {dtype}")
        self._flow = flow
        self.batch_size = batch_size
        self.features = features
        self.num_samples = num_samples or batch_size
        self.context_features = context_features
        self._dtype = dtype
        # the JAX class also checks the weights against the TPU's VMEM
        # budget; B2 and B9 stream weights from L2, so the probers check
        # their shared-memory tile instead
        self._fused = None
        if use_fused is None or use_fused:
            self._fused = self._try_build_fused(flow, required=bool(use_fused))

    @property
    def is_fused(self) -> bool:
        """True when requests run a fused kernel rather than the unfused
        chain."""
        return self._fused is not None

    def _try_build_fused(self, flow, required: bool):
        from nflows_tpu_torch.ops.cuda.mademog_fused import fuse_mademog
        from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf
        from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf

        errors = []
        for fuse in (fuse_nsf, fuse_maf, fuse_mademog):
            try:
                fused = fuse(flow, dtype=self._dtype)
            except (ValueError, AttributeError) as e:
                errors.append(f"{fuse.__name__}: {e}")
                continue
            if (fused.context_features is None) != (self.context_features is None):
                msg = ("flow conditionality does not match CompiledFlow's "
                       f"context_features={self.context_features}")
                if required:
                    raise ValueError(msg)
                errors.append(f"{fuse.__name__}: {msg}")
                continue
            return fused
        if required:
            raise ValueError(
                "use_fused=True but this flow matches no fused kernel's "
                "structure. Prober reasons:\n  " + "\n  ".join(errors))
        return None

    # -- request-time validation ----------------------------------------------

    def _check_inputs(self, x):
        if tuple(x.shape) != (self.batch_size, self.features):
            raise ValueError(
                f"CompiledFlow expects inputs of shape "
                f"{(self.batch_size, self.features)}, got {tuple(x.shape)}")
        if x.device != self.device:
            raise ValueError(
                f"CompiledFlow serves on {self.device}; inputs are on {x.device}")

    def _check_context(self, context):
        if self.context_features is None:
            if context is not None:
                raise ValueError(
                    "CompiledFlow was built without context_features but a "
                    "context was passed — it would be silently ignored; "
                    "rebuild with context_features=<dim>")
            return
        if context is None:
            raise ValueError(
                "CompiledFlow was built with "
                f"context_features={self.context_features}; a context of "
                f"shape {(self.batch_size, self.context_features)} is required")
        expected = (self.batch_size, self.context_features)
        if tuple(context.shape) != expected:
            raise ValueError(
                f"CompiledFlow expects context of shape {expected}, got "
                f"{tuple(context.shape)}")

    def _check_generator(self, generator):
        if not isinstance(generator, torch.Generator):
            raise TypeError(
                "CompiledFlow endpoints take a torch.Generator on the serving "
                f"device; got {generator!r}")
        if generator.device.type != self.device.type:
            raise TypeError(
                f"the generator is on {generator.device} but CompiledFlow "
                f"serves on {self.device}")
        return generator

    # -- endpoints -------------------------------------------------------------

    @torch.no_grad()
    def log_prob(self, inputs, context=None):
        self._check_inputs(inputs)
        self._check_context(context)
        if self._fused is not None:
            return self._fused.log_prob(inputs, context)
        return self._flow.log_prob(inputs, context)

    @torch.no_grad()
    def sample(self, generator, context=None):
        generator = self._check_generator(generator)
        self._check_context(context)
        if self._fused is not None:
            return self._fused.sample(generator, self.num_samples, context=context)
        return self._flow.sample(generator, self.num_samples, context=context)

    @torch.no_grad()
    def sample_and_log_prob(self, generator, context=None) -> Tuple:
        generator = self._check_generator(generator)
        self._check_context(context)
        if self._fused is not None:
            return self._fused.sample_and_log_prob(
                generator, self.num_samples, context=context)
        return self._flow.sample_and_log_prob(
            generator, self.num_samples, context=context)
