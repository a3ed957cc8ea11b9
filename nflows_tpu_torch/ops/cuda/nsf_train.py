"""Fused training of tabular coupling flows: kernels B3 and B4 (counterpart
of nflows_tpu/ops/pallas/nsf_train.py; source ``csrc/nsf_train.cu``, the
stages' adjoints in ``csrc/{rq,lrs,linear,quadratic,cubic}_spline_bwd.cuh``
and ``csrc/affine_coupling.cuh``).

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

Each kernel has two layouts: a tile of samples a block (``csrc/nsf_train.cu``)
and, where the tiles would leave SMs idle, a tile of 32 samples a
thread-block cluster of CS blocks (``csrc/nsf_train_cluster.cu``), chosen
by :func:`cluster_size`.

Samples are rows, as for B2: x is [N, D], the context [N, C]. The weights
are the dict ``nsf_fused._extract(flow, fold_wh_scale=False)`` gives (w0,
b0, wb, bb, wf, bf, and wc0, wcb, bcb for a conditional chain; fp32, the
JAX package's layout); gradients come back in the same shapes. The kernels
run all seven coupling families of B2 (the rq, lrs, linear, quadratic and
cubic splines, the affine and additive couplings) in fp32, with or without
a context; each stage's adjoint is written by hand for its forward branch,
the only one training runs, and so is the context's (the GLU gate and the
initial layer's context columns). B4 also gives the context's cotangent,
under the key ``"ctx"`` of its gradients, so that an embedding net
composed outside :func:`nsf_train_apply` trains under autograd.

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
from nflows_tpu_torch.ops.cuda._trainer_common import (
    CLUSTER_SIZES,
    FusedTrainerBase,
    cluster_gemm_floats,
    cluster_layout,
    cluster_size,
    query_active_clusters,
)
from nflows_tpu_torch.ops.cuda.nsf_flow_kernel import (
    MAX_SHARED_MEMORY,
    _round4,
    nsf_flow_kernel_plain,
    pack_weights,
)

__all__ = ["FusedNSFTrainer", "CONTEXT_KEYS", "family_wh_scale", "nsf_loss_grad_cuda",
           "nsf_loss_grad_plain",
           "nsf_train_bwd_cuda", "nsf_train_bwd_plain", "nsf_train_apply",
           "shared_memory_bytes", "tile_rows", "cluster_size", "launch_layout",
           "active_clusters", "CLUSTER_SIZES", "loss_grad_launch_count", "bwd_launch_count"]

WEIGHT_KEYS = ("w0", "b0", "wb", "bb", "wf", "bf")
CONTEXT_KEYS = ("wc0", "wcb", "bcb")

loss_grad_launch_count = 0  # B3 launches since the last reset
bwd_launch_count = 0        # B4 launches since the last reset

def _launch_argtypes():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return ([i] + [p] * 5 + [ctypes.c_int64] + [i] * 9 + [p] * 17 + [i] + [p] * 10
            + [i, i, f, f, i, i, i] + [f] * 7 + [i, p])


def _declare(lib):
    lib.nsf_train_launch.argtypes = _launch_argtypes()
    lib.nsf_train_launch.restype = ctypes.c_int


def _declare_cluster(lib):
    lib.nsf_train_cluster_launch.argtypes = _launch_argtypes()
    lib.nsf_train_cluster_launch.restype = ctypes.c_int
    lib.nsf_train_cluster_occupancy.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    lib.nsf_train_cluster_occupancy.restype = ctypes.c_int


def _keys(weights):
    """The weight stacks of a chain: WEIGHT_KEYS, and CONTEXT_KEYS where it
    has a context."""
    return WEIGHT_KEYS + (CONTEXT_KEYS if "wc0" in weights else ())


def _dims(weights, layer_indices, static):
    L, H, Tid = weights["w0"].shape
    T = len(layer_indices[0].tr_rows)
    M = nsf_flow_kernel.params_per_feature(static["spline"], static.get("num_bins", 0))
    C = weights["wc0"].shape[2] if "wc0" in weights else 0
    return dict(L=L, H=H, Tid=Tid, T=T, D=Tid + T, TM=T * M, nb2=2 * static["num_blocks"], C=C)


def family_wh_scale(static, hidden):
    """The softmax 1/sqrt(hidden) the kernels apply to unfolded weights, by
    family (the JAX package's ``_family_spline_config``): rq, lrs, cubic and
    quadratic carry it, linear, affine and additive do not (None)."""
    if static["spline"] in nsf_flow_kernel.RESCALED_FAMILIES:
        return 1.0 / math.sqrt(hidden)
    return None


def shared_memory_bytes(rows: int, D: int, L: int, H: int, Tid: int, T: int,
                        TM: int, C: int = 0, cluster: int = 1) -> int:
    """Dynamic shared memory of one block of ``rows`` samples
    (csrc/nsf_train.cu: smem_bytes; with ``cluster`` > 1, a block of a
    cluster, csrc/nsf_train_cluster.cu: smem_bytes, whose GEMM buffer is
    ``cluster_gemm_floats``); a context of C features adds its tile
    [C][rows + 4] and its cotangent's [C][rows]."""
    TB = max(H, _round4(TM), _round4(Tid))
    gemm = (cluster_gemm_floats(rows) if cluster > 1
            else 2 * nsf_flow_kernel._KC * nsf_flow_kernel._OC)
    return 4 * (gemm + 3 * TB * (rows + 4)
                + rows * ((L + 4) * D + 2 * T + Tid + 2) + C * (2 * rows + 4))


def tile_rows(n: int, d: Dict[str, int], sms: int) -> int:
    """Samples a block holds at a time: 64 where that fits in shared memory
    and still gives every SM a tile, else 32; 0 if neither fits."""
    def fits(rows):
        return shared_memory_bytes(rows, d["D"], d["L"], d["H"], d["Tid"], d["T"],
                                   d["TM"], d.get("C", 0)) <= MAX_SHARED_MEMORY
    if fits(64) and -(-n // 64) >= sms:
        return 64
    return 32 if fits(32) else 0


_ACTIVE_CLUSTERS = {}  # (device, loss, context, CS, shared memory) -> clusters


def active_clusters(dev, loss, context, cs, smem):
    """cudaOccupancyMaxActiveClusters of a B3 (``loss``) or B4 kernel, with
    or without a ``context``, in clusters of ``cs`` blocks with ``smem``
    bytes of shared memory a block: queried once and cached; raises where
    it is 0."""
    def query(found):
        lib = _build.load_library("nsf_train_cluster", _declare_cluster)
        return lib.nsf_train_cluster_occupancy(int(loss), int(bool(context)), cs, smem, found)

    return query_active_clusters(
        _ACTIVE_CLUSTERS, (dev.index, bool(loss), bool(context), cs, smem), dev, query,
        "nsf_train_cluster_occupancy", cs, smem)


def launch_layout(loss, n, d, dev, rows=None, cluster=None, what="nsf_train"):
    """(rows, cluster size, grid) of a B3 (``loss``) or B4 launch over ``n``
    samples of a chain of dims ``d`` (``_dims``) on ``dev``: ``rows`` and
    ``cluster`` as given, or chosen (:func:`tile_rows`, :func:`cluster_size`
    on the occupancy the card reports); the grid is min(tiles, SMs) blocks,
    or the cluster size times min(tiles, active clusters)."""
    D, L, H, Tid, T, TM, C = (d[k] for k in ("D", "L", "H", "Tid", "T", "TM", "C"))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if rows is None:
        rows = tile_rows(n, d, sms)
    if rows not in (32, 64) or H % 4 or (
            shared_memory_bytes(rows, D, L, H, Tid, T, TM, C) > MAX_SHARED_MEMORY):
        raise ValueError(f"{what}: hidden width {H} does not fit the kernel's "
                         f"shared-memory tile of {rows} samples")

    def active(cs):
        return active_clusters(dev, loss, C, cs,
                               shared_memory_bytes(rows, D, L, H, Tid, T, TM, C, cs))

    cluster, grid = cluster_layout(n, rows, sms, active, cluster, what)
    return rows, cluster, grid


def _log_z(features: int) -> float:
    return 0.5 * features * math.log(2.0 * math.pi)


# -- plain versions ---------------------------------------------------------


def nsf_loss_grad_plain(x, weights, layer_indices, *, wh_scale, context=None, **static):
    """B3 in plain PyTorch: (loss, log_prob [N], gradients) by autograd over
    the plain chain, in x's dtype; with ``context`` [N, C] the gradients
    include the context stacks'."""
    keys = _keys(weights)
    leaves = {k: weights[k].detach().clone().requires_grad_(True) for k in keys}
    context = None if context is None else context.detach()
    with torch.enable_grad():
        y, lad = nsf_flow_kernel_plain(x.detach(), leaves, layer_indices, inverse=False,
                                       wh_scale=wh_scale, context=context, **static)
        lp = -0.5 * (y * y).sum(dim=1) - _log_z(x.shape[1]) + lad
        loss = -lp.mean()
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
    return loss.detach(), lp.detach(), dict(zip(keys, grads))


def nsf_train_bwd_plain(x, gy, glad, weights, layer_indices, *, wh_scale, context=None,
                        **static):
    """B4 in plain PyTorch: (gx [N, D], gradients) by autograd over the plain
    chain with the cotangents (gy [N, D], glad [N]), in x's dtype; with
    ``context`` [N, C] the gradients include the context stacks' and, under
    ``"ctx"``, the context's cotangent [N, C]."""
    keys = _keys(weights)
    leaves = {k: weights[k].detach().clone().requires_grad_(True) for k in keys}
    x = x.detach().clone().requires_grad_(True)
    inputs = [x] + [leaves[k] for k in keys]
    if context is not None:
        context = context.detach().clone().requires_grad_(True)
        inputs.append(context)
        keys = keys + ("ctx",)
    with torch.enable_grad():
        y, lad = nsf_flow_kernel_plain(x, leaves, layer_indices, inverse=False,
                                       wh_scale=wh_scale, context=context, **static)
        # the additive coupling's logabsdet is a constant 0
        outs = [(o, g) for o, g in ((y, gy), (lad, glad)) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in outs], inputs, [g for _, g in outs])
    return grads[0], dict(zip(keys, grads[1:]))


# -- the kernels --------------------------------------------------------------


def _check(name, t, shape, device, dtype=torch.float32):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _launch(loss, x, gy, glad, weights, layer_indices, static, wh_scale, packed,
            grads, rows, inv_n, context=None, cluster=None):
    """Shared launch of B3 (``loss``) and B4. ``cluster`` forces the cluster
    size (1, or one of CLUSTER_SIZES with 32-sample tiles); None chooses
    (:func:`cluster_size`). Returns (lp or gx, grads); B4's grads hold the
    context's cotangent under "ctx" where there is a context."""
    global loss_grad_launch_count, bwd_launch_count
    what = "nsf_loss_grad_cuda" if loss else "nsf_train_bwd_cuda"
    dev = x.device
    if x.ndim != 2:
        raise ValueError(f"{what}: x must be [N, D], got {tuple(x.shape)}")
    n, D = x.shape
    d = _dims(weights, layer_indices, static)
    if D != d["D"]:
        raise ValueError(f"{what}: x has {D} features, the weights {d['D']}")
    _check(f"{what}: x", x, (n, D), dev)
    if not loss:
        _check(f"{what}: gy", gy, (n, D), dev)
        _check(f"{what}: glad", glad, (n,), dev)
    L, H, Tid, T, TM, nb2, C = (d[k] for k in ("L", "H", "Tid", "T", "TM", "nb2", "C"))
    nsf_flow_kernel._check_context(what, x, weights, context)
    keys = _keys(weights)
    shapes = dict(w0=(L, H, Tid), b0=(L, H, 1), wb=(L, nb2, H, H), bb=(L, nb2, H, 1),
                  wf=(L, TM, H), bf=(L, TM, 1), wc0=(L, H, C), wcb=(L, nb2 // 2, H, C),
                  bcb=(L, nb2 // 2, H, 1))
    for k in keys:
        _check(f"{what}: weights[{k!r}]", weights[k], shapes[k], dev)
    if C:
        _check(f"{what}: context", context, (n, C), dev)
    if packed is None:
        packed = pack_weights(weights, layer_indices)
    I4, TMp = _round4(Tid), _round4(TM)
    packed_shapes = dict(w0=(L, I4, H), wb=(L, nb2, H, H), wf=(L, H, TMp), bf=(L, TMp))
    if C:
        packed_shapes.update(wc0=(L, C, H), wcb=(L, nb2 // 2, C, H), bcb=(L, nb2 // 2, H))
    for k, shape in packed_shapes.items():
        if k not in packed:
            raise ValueError(f"{what}: packed has no {k!r}")
        _check(f"{what}: packed[{k!r}]", packed[k], shape, dev)
    _check(f"{what}: packed['idx']", packed["idx"], (L, 2 * D + 2 * Tid + 2 * T), dev,
           torch.int32)
    rows, cluster, grid = launch_layout(loss, n, d, dev, rows, cluster, what)
    if grads is None:
        grads = {k: torch.empty(shapes[k], dtype=torch.float32, device=dev) for k in keys}
    for k in keys:
        _check(f"{what}: grads[{k!r}]", grads[k], shapes[k], dev)
        grads[k].zero_()  # the kernel adds into them

    if cluster == 1:
        entry = _build.load_library("nsf_train", _declare).nsf_train_launch
    else:
        entry = _build.load_library("nsf_train_cluster",
                                    _declare_cluster).nsf_train_cluster_launch
    # scratch for the kept activations, one slot a block or a cluster (see
    # csrc/nsf_train.cu)
    kept = nb2 + 1 + (nb2 // 2 if C else 0)   # kept [H] matrices a layer before P
    stash = torch.empty(grid // cluster * L * (kept * H + TMp) * (rows + 4),
                        dtype=torch.float32, device=dev)
    out = (torch.empty(n, dtype=torch.float32, device=dev) if loss
           else torch.empty_like(x))
    gctx = torch.empty_like(context) if C and not loss else None
    ptr = nsf_flow_kernel._ptr
    null = 0  # the pointers the other kernel reads or writes
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = entry(
            int(loss), x.data_ptr(), null if loss else gy.data_ptr(),
            null if loss else glad.data_ptr(), out.data_ptr() if loss else null,
            null if loss else out.data_ptr(), n, D, L, H, Tid, I4, T, TM, TMp, nb2,
            packed["w0"].data_ptr(), packed["wb"].data_ptr(), packed["wf"].data_ptr(),
            packed["bf"].data_ptr(), weights["w0"].data_ptr(), weights["b0"].data_ptr(),
            weights["wb"].data_ptr(), weights["bb"].data_ptr(), weights["wf"].data_ptr(),
            packed["idx"].data_ptr(), *(grads[k].data_ptr() for k in WEIGHT_KEYS),
            stash.data_ptr(), C, ptr(context), ptr(gctx), ptr(packed.get("wc0")),
            ptr(packed.get("wcb")), ptr(packed.get("bcb")), ptr(weights.get("wc0")),
            ptr(weights.get("wcb")), ptr(grads.get("wc0")), ptr(grads.get("wcb")),
            ptr(grads.get("bcb")), grid, cluster, 1.0 if wh_scale is None else wh_scale,
            inv_n,
            nsf_flow_kernel.FAMILIES.index(static["spline"]),
            nsf_flow_kernel.SCALE_ACTIVATIONS.index(static.get("scale_act") or "none"),
            static.get("num_bins", 0), *nsf_flow_kernel.stage_floats(**static), rows, stream)
    if gctx is not None:
        grads = {**grads, "ctx": gctx}
    if loss:
        loss_grad_launch_count += 1
    else:
        bwd_launch_count += 1
    _build.check(code, "nsf_train_launch" if cluster == 1 else "nsf_train_cluster_launch")
    return out, grads


def nsf_loss_grad_cuda(x, weights, layer_indices, *, wh_scale, packed=None, grads=None,
                       rows=None, context=None, cluster=None, **static):
    """B3: x [N, D] (and the context [N, C] of a conditional chain) ->
    (loss, log_prob [N], gradients of the loss).

    ``packed`` is ``pack_weights(weights, layer_indices)``, built here when
    not given. ``grads``, when given, are the tensors the gradients are
    written into (zeroed here first). ``rows`` forces the tile size (32 or
    64); None chooses by shared memory and SM count. ``cluster`` forces the
    blocks a tile is spread over (1, or one of CLUSTER_SIZES at 32-sample
    tiles); None chooses (:func:`cluster_size`)."""
    if x.device.type == "cpu":
        return nsf_loss_grad_plain(x, weights, layer_indices, wh_scale=wh_scale,
                                   context=context, **static)
    lp, grads = _launch(True, x, None, None, weights, layer_indices, static, wh_scale,
                        packed, grads, rows, 1.0 / max(x.shape[0], 1), context, cluster)
    return -lp.mean(), lp, grads


def nsf_train_bwd_cuda(x, gy, glad, weights, layer_indices, *, wh_scale, packed=None,
                       grads=None, rows=None, context=None, cluster=None, **static):
    """B4: (x [N, D], gy [N, D], glad [N], and the context [N, C] of a
    conditional chain) -> (gx [N, D], gradients), the pull-back of the
    cotangents through the chain; with a context the gradients also hold
    the context's cotangent [N, C] under ``"ctx"``. ``rows`` and ``cluster``
    as for :func:`nsf_loss_grad_cuda`."""
    if x.device.type == "cpu":
        return nsf_train_bwd_plain(x, gy, glad, weights, layer_indices,
                                   wh_scale=wh_scale, context=context, **static)
    return _launch(False, x, gy, glad, weights, layer_indices, static, wh_scale, packed,
                   grads, rows, 0.0, context, cluster)


class _NSFTrainApply(torch.autograd.Function):
    """forward: B2 with ``wh_scale``; backward: B4."""

    @staticmethod
    def forward(ctx, x, context, meta, *ws):
        layer_indices, static, wh_scale, packed, keys = meta
        weights = dict(zip(keys, ws))
        if packed is None:
            packed = pack_weights(weights, layer_indices)
        ctx.save_for_backward(x, context, *ws)
        ctx.meta = (layer_indices, static, wh_scale, packed, keys)
        # the SIMT route: it reads pack_weights' layout, which the trainer
        # re-packs in place after each optimizer step
        return nsf_flow_kernel.nsf_flow_kernel_cuda(
            x, weights, layer_indices, inverse=False, packed=packed, wh_scale=wh_scale,
            context=context, gemm="simt", **static)

    @staticmethod
    def backward(ctx, gy, glad):
        x, context, *ws = ctx.saved_tensors
        layer_indices, static, wh_scale, packed, keys = ctx.meta
        gx, grads = nsf_train_bwd_cuda(
            x, gy.contiguous(), glad.contiguous(), dict(zip(keys, ws)),
            layer_indices, wh_scale=wh_scale, packed=packed, context=context, **static)
        return (gx, grads.get("ctx"), None) + tuple(grads[k] for k in keys)


def nsf_train_apply(weights, x, layer_indices, static, wh_scale, packed=None, context=None):
    """The differentiable fused forward: (y [N, D], logabsdet [N]) whose
    gradients with respect to ``x``, ``weights`` and the ``context`` [N, C]
    of a conditional chain come from B4, so that a module computing the
    context (an embedding net) trains through it. On a CPU tensor it is the
    plain chain under autograd."""
    if x.device.type == "cpu":
        return nsf_flow_kernel_plain(x, weights, layer_indices, inverse=False,
                                     wh_scale=wh_scale, context=context, **static)
    if context is not None:
        context = context.float().contiguous()
    keys = _keys(weights)
    return _NSFTrainApply.apply(x, context, (layer_indices, static, wh_scale, packed, keys),
                                *(weights[k] for k in keys))


# -- the trainer ----------------------------------------------------------------


class FusedNSFTrainer(FusedTrainerBase):
    """Train a tabular coupling flow with the fused kernels: an RQ or LRS
    NSF, a chain of linear, quadratic or cubic spline couplings, a
    SimpleRealNVP (affine or additive couplings) or a chain of affine
    couplings with the GENERAL scale activation, each with or without a
    context.

        trainer = FusedNSFTrainer(flow, batch_size=512)
        optimizer = trainer.init_opt(lambda p: torch.optim.Adam(p, lr=3e-4))
        step = trainer.make_train_step(optimizer)
        loss = step(batch)            # batch [N, D]; step(batch, context) if conditional
        trained_flow = trainer.to_flow()

    The kernels take the context as the conditioners see it: a conditional
    flow with an ``embedding_net`` is refused, and trains on the eager route
    or through :func:`nsf_train_apply` composed with the embedding net under
    autograd (B4 gives the context's cotangent).

    ``trainer.weights`` are the fp32 kernel-layout tensors (leaf tensors that
    require grad, on the flow's device) and are updated in place by the
    optimizer. Because extraction is a pure transpose and permutation, Adam
    on them follows the trajectory of Adam on the model's own parameters.
    """

    def __init__(self, flow, batch_size):
        from nflows_tpu_torch.ops.cuda.nsf_fused import _extract

        (self._indices, weights, self._static, self.features,
         self.context_features) = _extract(flow, torch.float32, fold_wh_scale=False)
        if (self.context_features is not None
                and getattr(flow, "embedding_net", None) is not None):
            raise ValueError(
                "fused training takes the RAW context (identity embedding "
                "only); flows with an embedding_net train on the eager "
                "route (training.make_train_step), or compose nsf_train_apply "
                "with the embedding net under autograd -- B4 gives the "
                "context's gradient")
        self.weights = {k: weights[k].clone().contiguous().requires_grad_(True)
                        for k in _keys(weights)}
        self.device = self.weights["w0"].device
        self._flow_template = flow
        self._has_ctx = self.context_features is not None
        self._wh_scale = family_wh_scale(self._static, self.weights["w0"].shape[1])
        self._dims = _dims(self.weights, self._indices, self._static)
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

    def _apply(self, weights, x, context=None):
        return nsf_train_apply(weights, x, self._indices, self._static, self._wh_scale,
                               packed=self._repack(weights), context=context)

    def _build_loss_grad(self):
        def loss_and_grad(weights, x, context=None):
            keys = _keys(weights)
            if self._grads is None and self.device.type == "cuda":
                flat = torch.empty(sum(w.numel() for w in weights.values()),
                                   dtype=torch.float32, device=self.device)
                sizes = [weights[k].numel() for k in keys]
                self._grads = {k: g.view(weights[k].shape)
                               for k, g in zip(keys, flat.split(sizes))}
            loss, _, grads = nsf_loss_grad_cuda(
                x, weights, self._indices, wh_scale=self._wh_scale,
                packed=self._repack(weights), grads=self._grads, rows=self._rows,
                context=context, **self._static)
            return loss, grads
        return loss_and_grad

    # -- export ---------------------------------------------------------------

    def to_flow(self, weights=None):
        """Write kernel-layout weights back into a copy of the flow (the
        inverse of extraction: un-transpose and, for the splines, the
        inverse K-major reorder; the context stacks into the initial layer's
        columns past the identity features and each block's context layer)."""
        from nflows_tpu_torch.ops.cuda.nsf_fused import _layer_groups

        w = self.weights if weights is None else weights
        flow = copy.deepcopy(self._flow_template)
        with torch.no_grad():
            for l, (_, cpl) in enumerate(_layer_groups(flow.transform)):
                net = cpl.transform_net
                T = cpl.num_transform_features
                M = w["wf"].shape[1] // T
                order = np.array([t * M + j for j in range(M) for t in range(T)])
                if self._static["spline"] in ("affine", "additive"):
                    order = np.arange(T * M)   # param-major already
                inv_order = torch.as_tensor(np.argsort(order), device=w["wf"].device)
                Tid = w["w0"].shape[2]
                net.initial_layer.weight[:, :Tid].copy_(w["w0"][l])
                net.initial_layer.bias.copy_(w["b0"][l, :, 0])
                for j, blk in enumerate(net.blocks):
                    blk.linear_0.weight.copy_(w["wb"][l, 2 * j])
                    blk.linear_0.bias.copy_(w["bb"][l, 2 * j, :, 0])
                    blk.linear_1.weight.copy_(w["wb"][l, 2 * j + 1])
                    blk.linear_1.bias.copy_(w["bb"][l, 2 * j + 1, :, 0])
                net.final_layer.weight.copy_(w["wf"][l][inv_order])
                net.final_layer.bias.copy_(w["bf"][l, :, 0][inv_order])
                if self._has_ctx:
                    net.initial_layer.weight[:, Tid:].copy_(w["wc0"][l])
                    for j, blk in enumerate(net.blocks):
                        blk.context_layer.weight.copy_(w["wcb"][l, j])
                        blk.context_layer.bias.copy_(w["bcb"][l, j, :, 0])
        return flow
