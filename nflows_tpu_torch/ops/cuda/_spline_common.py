"""What the elementwise spline wrappers B1 and B5-B8 share (counterpart of
nflows_tpu/ops/pallas/_spline_common.py): the checks of what a kernel
takes, the launch through a C entry point of one shape, and the autograd
wiring.

Every entry point is ``<stem>_launch(x, *params, out, lad, int64 n, int K,
int inverse, *floats, stream)`` on float32 tensors in the JAX public
layout (inputs [...], parameters [..., P]), contiguous. The kernels are
forward-only: :class:`KernelSpline` runs one forward and recomputes the
plain version under autograd for the backward, as the JAX package's
``make_spline_core`` differentiates its XLA reference
(_spline_common.py:170-196).
"""

from __future__ import annotations

import ctypes

import torch

from nflows_tpu_torch.ops.cuda import _build

__all__ = ["check_inputs", "launch", "KernelSpline"]


def check_inputs(fn: str, inputs, **params) -> None:
    """Raise unless ``inputs`` and every ``name=(tensor, P)`` parameter are
    float32, contiguous and on one CUDA device, each parameter of shape
    ``inputs.shape + (P,)``."""
    for name, t in [("inputs", inputs)] + [(k, t) for k, (t, _) in params.items()]:
        if not t.is_cuda or t.device != inputs.device:
            raise ValueError(f"{fn}: {name} must be on {inputs.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    shape = tuple(inputs.shape)
    for name, (t, p) in params.items():
        if tuple(t.shape) != shape + (p,):
            raise ValueError(
                f"{fn}: {name} must have shape inputs.shape + ({p},) = {shape + (p,)}, "
                f"got {tuple(t.shape)}")


def _declare(stem, num_params, num_floats):
    def declare(lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, f"{stem}_launch")
        fn.argtypes = ([p] * (num_params + 3) + [ctypes.c_int64, i, i]
                       + [ctypes.c_float] * num_floats + [p])
        fn.restype = i
    return declare


def launch(stem, inputs, params, num_bins, inverse, floats):
    """Launch ``csrc/<stem>.cu`` on checked tensors. Returns (out, lad)."""
    lib = _build.load_library(stem, _declare(stem, len(params), len(floats)))
    out = torch.empty_like(inputs)
    lad = torch.empty_like(inputs)
    stream = torch.cuda.current_stream(inputs.device).cuda_stream
    with torch.cuda.device(inputs.device):
        code = getattr(lib, f"{stem}_launch")(
            inputs.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(),
            lad.data_ptr(), inputs.numel(), int(num_bins), int(inverse),
            *(float(f) for f in floats), stream)
    _build.check(code, f"{stem}_launch")
    return out, lad


class KernelSpline(torch.autograd.Function):
    """``apply(launch, plain, statics, inputs, *params)``: the forward is
    ``launch(inputs, *params, **statics)`` (a kernel), the backward autograd
    of ``plain(inputs, *params, **statics)`` recomputed on the saved
    inputs."""

    @staticmethod
    def forward(ctx, launch_fn, plain, statics, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.plain, ctx.statics = plain, statics
        return launch_fn(*tensors, **statics)

    @staticmethod
    def backward(ctx, grad_out, grad_lad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad[3:])]
            out, lad = ctx.plain(*leaves, **ctx.statics)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad((out, lad), wanted, (grad_out, grad_lad),
                                             allow_unused=True))
        return (None, None, None) + tuple(next(grads) if t.requires_grad else None
                                          for t in leaves)
