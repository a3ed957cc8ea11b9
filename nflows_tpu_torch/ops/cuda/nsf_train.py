"""Fused training of tabular RQ-NSF coupling flows: kernels B3 and B4
(counterpart of nflows_tpu/ops/pallas/nsf_train.py; source
``csrc/nsf_train.cu``, spline adjoint in ``csrc/rq_spline_bwd.cuh``).

- :func:`nsf_loss_grad_cuda` (B3): one launch gives the per-sample
  log_prob under the StandardNormal base and every weight gradient of
  ``loss = -mean(log_prob)``.
- :func:`nsf_train_bwd_cuda` (B4): recomputes the chain and pulls given
  cotangents back to the inputs and the weights. :func:`nsf_train_apply`
  is the ``torch.autograd.Function`` whose forward is B2 with ``wh_scale``
  and whose backward is B4: the composable path.
- :class:`FusedNSFTrainer` owns the kernel-layout weights as the trainable
  tensors. Extraction does not fold the softmax 1/sqrt(hidden) rescale
  (the kernels apply it), so every weight is a transpose or permutation of
  the model's own: an elementwise optimizer (Adam) follows the same
  trajectory as on the model, and :meth:`FusedNSFTrainer.to_flow` maps the
  trained weights back into a standard flow.

Samples are rows, as for B2: x is [N, D]. The weights are the dict
``nsf_fused._extract(flow, fold_wh_scale=False)`` gives (w0, b0, wb, bb,
wf, bf, fp32, the JAX package's layout); gradients come back in the same
shapes. This slice covers the rq family in fp32 without context.

The plain versions (:func:`nsf_loss_grad_plain`,
:func:`nsf_train_bwd_plain`) are ``torch.autograd`` over
``nsf_flow_kernel_plain``, independent of the kernels' hand-derived
adjoints. A wrapper given a CPU tensor runs its plain version; given a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import copy
import ctypes
import math
from typing import Dict

import numpy as np
import torch

from nflows_tpu_torch.ops.cuda import _build, nsf_flow_kernel
from nflows_tpu_torch.ops.cuda._trainer_common import FusedTrainerBase
from nflows_tpu_torch.ops.cuda.nsf_flow_kernel import (
    MAX_SHARED_MEMORY,
    _round4,
    nsf_flow_kernel_plain,
    pack_weights,
)

__all__ = ["FusedNSFTrainer", "nsf_loss_grad_cuda", "nsf_loss_grad_plain",
           "nsf_train_bwd_cuda", "nsf_train_bwd_plain", "nsf_train_apply",
           "shared_memory_bytes", "tile_rows", "loss_grad_launch_count",
           "bwd_launch_count"]

WEIGHT_KEYS = ("w0", "b0", "wb", "bb", "wf", "bf")

loss_grad_launch_count = 0  # B3 launches since the last reset
bwd_launch_count = 0        # B4 launches since the last reset


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nsf_train_launch.argtypes = (
        [i] + [p] * 5 + [ctypes.c_int64] + [i] * 9 + [p] * 17 + [i, f, f, i]
        + [f] * 4 + [i, p])
    lib.nsf_train_launch.restype = i


def _dims(weights, layer_indices, num_blocks, num_bins):
    L, H, Tid = weights["w0"].shape
    T = len(layer_indices[0].tr_rows)
    return dict(L=L, H=H, Tid=Tid, T=T, D=Tid + T, TM=T * (3 * num_bins - 1),
                nb2=2 * num_blocks)


def shared_memory_bytes(rows: int, D: int, L: int, H: int, Tid: int, T: int,
                        TM: int) -> int:
    """Dynamic shared memory of one block of ``rows`` samples
    (csrc/nsf_train.cu: smem_bytes)."""
    TB = max(H, _round4(TM), _round4(Tid))
    return 4 * (2 * nsf_flow_kernel._KC * nsf_flow_kernel._OC + 3 * TB * (rows + 4)
                + rows * ((L + 4) * D + 2 * T + Tid + 2))


def tile_rows(n: int, d: Dict[str, int], sms: int) -> int:
    """Samples a block holds at a time: 64 where that fits in shared memory
    and still gives every SM a tile, else 32; 0 if neither fits."""
    def fits(rows):
        return shared_memory_bytes(rows, d["D"], d["L"], d["H"], d["Tid"], d["T"],
                                   d["TM"]) <= MAX_SHARED_MEMORY
    if fits(64) and -(-n // 64) >= sms:
        return 64
    return 32 if fits(32) else 0


def _log_z(features: int) -> float:
    return 0.5 * features * math.log(2.0 * math.pi)


# -- plain versions ---------------------------------------------------------


def nsf_loss_grad_plain(x, weights, layer_indices, *, wh_scale, **static):
    """B3 in plain PyTorch: (loss, log_prob [N], gradients) by autograd over
    the plain chain, in x's dtype."""
    leaves = {k: weights[k].detach().clone().requires_grad_(True) for k in WEIGHT_KEYS}
    with torch.enable_grad():
        y, lad = nsf_flow_kernel_plain(x.detach(), leaves, layer_indices, inverse=False,
                                       wh_scale=wh_scale, **static)
        lp = -0.5 * (y * y).sum(dim=1) - _log_z(x.shape[1]) + lad
        loss = -lp.mean()
        grads = torch.autograd.grad(loss, [leaves[k] for k in WEIGHT_KEYS])
    return loss.detach(), lp.detach(), dict(zip(WEIGHT_KEYS, grads))


def nsf_train_bwd_plain(x, gy, glad, weights, layer_indices, *, wh_scale, **static):
    """B4 in plain PyTorch: (gx [N, D], gradients) by autograd over the plain
    chain with the cotangents (gy [N, D], glad [N]), in x's dtype."""
    leaves = {k: weights[k].detach().clone().requires_grad_(True) for k in WEIGHT_KEYS}
    x = x.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        y, lad = nsf_flow_kernel_plain(x, leaves, layer_indices, inverse=False,
                                       wh_scale=wh_scale, **static)
        grads = torch.autograd.grad((y, lad), [x] + [leaves[k] for k in WEIGHT_KEYS],
                                    (gy, glad))
    return grads[0], dict(zip(WEIGHT_KEYS, grads[1:]))


# -- the kernels --------------------------------------------------------------


def _check(name, t, shape, device, dtype=torch.float32):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _launch(loss, x, gy, glad, weights, layer_indices, static, wh_scale, packed,
            grads, rows, inv_n):
    """Shared launch of B3 (``loss``) and B4. Returns (lp or gx, grads)."""
    global loss_grad_launch_count, bwd_launch_count
    what = "nsf_loss_grad_cuda" if loss else "nsf_train_bwd_cuda"
    dev = x.device
    if x.ndim != 2:
        raise ValueError(f"{what}: x must be [N, D], got {tuple(x.shape)}")
    n, D = x.shape
    d = _dims(weights, layer_indices, static["num_blocks"], static["num_bins"])
    if D != d["D"]:
        raise ValueError(f"{what}: x has {D} features, the weights {d['D']}")
    _check(f"{what}: x", x, (n, D), dev)
    if not loss:
        _check(f"{what}: gy", gy, (n, D), dev)
        _check(f"{what}: glad", glad, (n,), dev)
    L, H, Tid, T, TM, nb2 = (d[k] for k in ("L", "H", "Tid", "T", "TM", "nb2"))
    shapes = dict(w0=(L, H, Tid), b0=(L, H, 1), wb=(L, nb2, H, H), bb=(L, nb2, H, 1),
                  wf=(L, TM, H), bf=(L, TM, 1))
    for k in WEIGHT_KEYS:
        _check(f"{what}: weights[{k!r}]", weights[k], shapes[k], dev)
    if packed is None:
        packed = pack_weights(weights, layer_indices)
    I4, TMp = _round4(Tid), _round4(TM)
    packed_shapes = dict(w0=(L, I4, H), wb=(L, nb2, H, H), wf=(L, H, TMp), bf=(L, TMp))
    for k, shape in packed_shapes.items():
        _check(f"{what}: packed[{k!r}]", packed[k], shape, dev)
    _check(f"{what}: packed['idx']", packed["idx"], (L, 2 * D + 2 * Tid + 2 * T), dev,
           torch.int32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if rows is None:
        rows = tile_rows(n, d, sms)
    if rows not in (32, 64) or H % 4 or (
            shared_memory_bytes(rows, D, L, H, Tid, T, TM) > MAX_SHARED_MEMORY):
        raise ValueError(f"{what}: hidden width {H} does not fit the kernel's "
                         f"shared-memory tile of {rows} samples")
    if grads is None:
        grads = {k: torch.empty(shapes[k], dtype=torch.float32, device=dev)
                 for k in WEIGHT_KEYS}
    for k in WEIGHT_KEYS:
        _check(f"{what}: grads[{k!r}]", grads[k], shapes[k], dev)
        grads[k].zero_()  # the kernel adds into them

    lib = _build.load_library("nsf_train", _declare)
    grid = max(1, min(-(-n // rows), sms))
    # per-block scratch for the kept activations (see csrc/nsf_train.cu)
    stash = torch.empty(grid * L * ((nb2 + 1) * H + TMp) * (rows + 4),
                        dtype=torch.float32, device=dev)
    out = (torch.empty(n, dtype=torch.float32, device=dev) if loss
           else torch.empty_like(x))
    null = 0  # the pointers the other kernel reads or writes
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.nsf_train_launch(
            int(loss), x.data_ptr(), null if loss else gy.data_ptr(),
            null if loss else glad.data_ptr(), out.data_ptr() if loss else null,
            null if loss else out.data_ptr(), n, D, L, H, Tid, I4, T, TM, TMp, nb2,
            packed["w0"].data_ptr(), packed["wb"].data_ptr(), packed["wf"].data_ptr(),
            packed["bf"].data_ptr(), weights["w0"].data_ptr(), weights["b0"].data_ptr(),
            weights["wb"].data_ptr(), weights["bb"].data_ptr(), weights["wf"].data_ptr(),
            packed["idx"].data_ptr(), *(grads[k].data_ptr() for k in WEIGHT_KEYS),
            stash.data_ptr(), grid, 1.0 if wh_scale is None else wh_scale, inv_n,
            static["num_bins"], static["tail_bound"], static["min_bin_width"],
            static["min_bin_height"], static["min_derivative"], rows, stream)
    if loss:
        loss_grad_launch_count += 1
    else:
        bwd_launch_count += 1
    _build.check(code, "nsf_train_launch")
    return out, grads


def nsf_loss_grad_cuda(x, weights, layer_indices, *, wh_scale, packed=None, grads=None,
                       rows=None, **static):
    """B3: x [N, D] -> (loss, log_prob [N], gradients of the loss).

    ``packed`` is ``pack_weights(weights, layer_indices)``, built here when
    not given. ``grads``, when given, are the tensors the gradients are
    written into (zeroed here first). ``rows`` forces the tile size (32 or
    64); None chooses by shared memory and SM count."""
    if x.device.type == "cpu":
        return nsf_loss_grad_plain(x, weights, layer_indices, wh_scale=wh_scale, **static)
    lp, grads = _launch(True, x, None, None, weights, layer_indices, static, wh_scale,
                        packed, grads, rows, 1.0 / max(x.shape[0], 1))
    return -lp.mean(), lp, grads


def nsf_train_bwd_cuda(x, gy, glad, weights, layer_indices, *, wh_scale, packed=None,
                       grads=None, rows=None, **static):
    """B4: (x [N, D], gy [N, D], glad [N]) -> (gx [N, D], weight gradients),
    the pull-back of the cotangents through the chain."""
    if x.device.type == "cpu":
        return nsf_train_bwd_plain(x, gy, glad, weights, layer_indices,
                                   wh_scale=wh_scale, **static)
    return _launch(False, x, gy, glad, weights, layer_indices, static, wh_scale, packed,
                   grads, rows, 0.0)


class _NSFTrainApply(torch.autograd.Function):
    """forward: B2 with ``wh_scale``; backward: B4."""

    @staticmethod
    def forward(ctx, x, meta, *ws):
        layer_indices, static, wh_scale, packed = meta
        weights = dict(zip(WEIGHT_KEYS, ws))
        if packed is None:
            packed = pack_weights(weights, layer_indices)
        ctx.save_for_backward(x, *ws)
        ctx.meta = (layer_indices, static, wh_scale, packed)
        return nsf_flow_kernel.nsf_flow_kernel_cuda(
            x, weights, layer_indices, inverse=False, packed=packed, wh_scale=wh_scale,
            **static)

    @staticmethod
    def backward(ctx, gy, glad):
        x, *ws = ctx.saved_tensors
        layer_indices, static, wh_scale, packed = ctx.meta
        gx, grads = nsf_train_bwd_cuda(
            x, gy.contiguous(), glad.contiguous(), dict(zip(WEIGHT_KEYS, ws)),
            layer_indices, wh_scale=wh_scale, packed=packed, **static)
        return (gx, None) + tuple(grads[k] for k in WEIGHT_KEYS)


def nsf_train_apply(weights, x, layer_indices, static, wh_scale, packed=None):
    """The differentiable fused forward: (y [N, D], logabsdet [N]) whose
    gradients with respect to ``x`` and ``weights`` come from B4. On a CPU
    tensor it is the plain chain under autograd."""
    if x.device.type == "cpu":
        return nsf_flow_kernel_plain(x, weights, layer_indices, inverse=False,
                                     wh_scale=wh_scale, **static)
    return _NSFTrainApply.apply(x, (layer_indices, static, wh_scale, packed),
                                *(weights[k] for k in WEIGHT_KEYS))


# -- the trainer ----------------------------------------------------------------


class FusedNSFTrainer(FusedTrainerBase):
    """Train a tabular NSF with the fused kernels.

        trainer = FusedNSFTrainer(flow, batch_size=512)
        optimizer = trainer.init_opt(lambda p: torch.optim.Adam(p, lr=3e-4))
        step = trainer.make_train_step(optimizer)
        loss = step(batch)                      # batch [N, D]; one B3 launch
        trained_flow = trainer.to_flow()

    ``trainer.weights`` are the fp32 kernel-layout tensors (leaf tensors that
    require grad, on the flow's device) and are updated in place by the
    optimizer. Because extraction is a pure transpose and permutation, Adam
    on them follows the trajectory of Adam on the model's own parameters.
    """

    def __init__(self, flow, batch_size):
        from nflows_tpu_torch.ops.cuda.nsf_fused import _extract

        (self._indices, weights, self._static, self.features,
         self.context_features) = _extract(flow, torch.float32, fold_wh_scale=False)
        self.weights = {k: weights[k].clone().contiguous().requires_grad_(True)
                        for k in WEIGHT_KEYS}
        self.device = self.weights["w0"].device
        self._flow_template = flow
        self._has_ctx = self.context_features is not None
        self._wh_scale = 1.0 / math.sqrt(self.weights["w0"].shape[1])
        self._dims = _dims(self.weights, self._indices, self._static["num_blocks"],
                           self._static["num_bins"])
        self._packed = None   # kernel layout of the forward weights, re-packed a step
        self._grads = None    # the tensors B3 writes the gradients into
        self._init_batching(batch_size)

    # -- hooks of FusedTrainerBase -----------------------------------------

    def _tile_rows(self, n):
        if self.device.type != "cuda":
            return None
        sms = torch.cuda.get_device_properties(self.device).multi_processor_count
        rows = tile_rows(n, self._dims, sms)
        if not rows:
            raise ValueError(
                f"hidden width {self._dims['H']} does not fit the training kernels' "
                "shared-memory tile; train on the eager route (training.make_train_step)")
        return rows

    def _repack(self, weights):
        if self.device.type != "cuda":
            return None
        self._packed = pack_weights(weights, self._indices, out=self._packed)
        return self._packed

    def _apply(self, weights, x):
        return nsf_train_apply(weights, x, self._indices, self._static, self._wh_scale,
                               packed=self._repack(weights))

    def _build_loss_grad(self):
        def loss_and_grad(weights, x):
            if self._grads is None and self.device.type == "cuda":
                flat = torch.empty(sum(w.numel() for w in weights.values()),
                                   dtype=torch.float32, device=self.device)
                sizes = [weights[k].numel() for k in WEIGHT_KEYS]
                self._grads = {k: g.view(weights[k].shape)
                               for k, g in zip(WEIGHT_KEYS, flat.split(sizes))}
            loss, _, grads = nsf_loss_grad_cuda(
                x, weights, self._indices, wh_scale=self._wh_scale,
                packed=self._repack(weights), grads=self._grads, rows=self._rows,
                **self._static)
            return loss, grads
        return loss_and_grad

    # -- export ---------------------------------------------------------------

    def to_flow(self, weights=None):
        """Write kernel-layout weights back into a copy of the flow (the
        inverse of extraction: un-transpose and inverse K-major reorder)."""
        from nflows_tpu_torch.ops.cuda.nsf_fused import _layer_groups

        w = self.weights if weights is None else weights
        flow = copy.deepcopy(self._flow_template)
        with torch.no_grad():
            for l, (_, cpl) in enumerate(_layer_groups(flow.transform)):
                net = cpl.transform_net
                T = cpl.num_transform_features
                M = w["wf"].shape[1] // T
                order = np.array([t * M + j for j in range(M) for t in range(T)])
                inv_order = torch.as_tensor(np.argsort(order), device=w["wf"].device)
                net.initial_layer.weight.copy_(w["w0"][l])
                net.initial_layer.bias.copy_(w["b0"][l, :, 0])
                for j, blk in enumerate(net.blocks):
                    blk.linear_0.weight.copy_(w["wb"][l, 2 * j])
                    blk.linear_0.bias.copy_(w["bb"][l, 2 * j, :, 0])
                    blk.linear_1.weight.copy_(w["wb"][l, 2 * j + 1])
                    blk.linear_1.bias.copy_(w["bb"][l, 2 * j + 1, :, 0])
                net.final_layer.weight.copy_(w["wf"][l][inv_order])
                net.final_layer.bias.copy_(w["bf"][l, :, 0][inv_order])
        return flow
