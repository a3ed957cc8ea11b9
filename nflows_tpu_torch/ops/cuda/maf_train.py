"""Fused training of autoregressive flows (MAF, NSF-AR): kernel B10
(counterpart of nflows_tpu/ops/pallas/maf_train.py; source
``csrc/maf_train.cu``).

- :func:`maf_train_bwd_cuda` (B10): recomputes the chain's log_prob
  direction (one MADE pass a layer, no fixed point) and pulls given
  cotangents back to the inputs and the weights.
- :func:`maf_train_apply` is the ``torch.autograd.Function`` whose forward
  is B9 (``maf_flow_kernel.py``) and whose backward is B10. The JAX package
  has no loss-and-gradient kernel for this family either, so a fused step
  is these two launches.
- :class:`FusedMAFTrainer` owns the UNFOLDED fp32 kernel-layout weights as
  the trainable tensors, plus the MADE masks in kernel layout. A trainable
  set of mask-FOLDED weights would let masked entries drift under Adam
  (the kernel's gradients are dense) and break the autoregressive
  property. So the trainer folds ``w * mask`` every step, outside the
  kernels and under autograd: the chain rule through that product zeroes
  the gradient of every masked entry exactly, as ``MaskedDense`` does on
  the eager route, and Adam leaves a zero-gradient entry where it is. The
  RQ 1/sqrt(hidden) rescale is likewise left out of the weights and applied
  by the kernels (``wh_scale``). Every weight is then a transpose or
  permutation of the model's own, Adam on them follows the trajectory of
  Adam on the model, and :meth:`FusedMAFTrainer.to_flow` maps them back.

IAF (InverseTransform-wrapped) layers are refused: their density direction
is a D-step fixed point these kernels do not differentiate. Training them
in their sampling direction (the JAX package's ``FusedIAFTrainer``) is
still to port, as are conditional flows.

Samples are rows: x is [N, D]. Weights are the flat stacks of
``maf_fused._extract`` (wi, bi, wb, bb, wf, bf); gradients come back in
the same shapes.

:func:`maf_train_bwd_plain` is B10's plain version: the adjoint derived by
hand, step for step as the kernel computes it (the TPU kernel gets it from
``jax.vjp`` traced inside the kernel; CUDA has no tracer). The CPU tests
hold it against autograd over ``maf_flow_kernel_plain`` in float64 and
against ``jax.grad``. A wrapper given a CPU tensor runs its plain version;
given a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import copy
import ctypes
import math
from typing import Dict

import numpy as np
import torch

from nflows_tpu_torch.ops.cuda import _build, maf_flow_kernel
from nflows_tpu_torch.ops.cuda._trainer_common import FusedTrainerBase
from nflows_tpu_torch.ops.cuda.maf_flow_kernel import (
    _EPSILON,
    TRANSFORMERS,
    _check_transformer,
    _dims,
    pack_weights,
)
from nflows_tpu_torch.ops.cuda.nsf_flow_kernel import (
    _KC,
    _OC,
    MAX_SHARED_MEMORY,
    _round4,
)
from nflows_tpu_torch.ops.splines import rational_quadratic as rq_ref

__all__ = ["FusedMAFTrainer", "maf_train_bwd_cuda", "maf_train_bwd_plain",
           "maf_train_apply", "shared_memory_bytes", "tile_rows",
           "bwd_launch_count"]

WEIGHT_KEYS = ("wi", "bi", "wb", "bb", "wf", "bf")
MASKED_KEYS = ("wi", "wb", "wf")

bwd_launch_count = 0  # B10 launches since the last reset


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.maf_train_launch.argtypes = (
        [p] * 4 + [ctypes.c_int64] + [i] * 7 + [p] * 17 + [i, i, f, i] + [f] * 4
        + [i, p])
    lib.maf_train_launch.restype = i


def shared_memory_bytes(rows: int, D: int, L: int, H: int, P: int) -> int:
    """Dynamic shared memory of one block of ``rows`` samples
    (csrc/maf_train.cu: smem_bytes)."""
    TB = max(H, _round4(P), _round4(D))
    return 4 * (2 * _KC * _OC + 3 * TB * (rows + 4) + rows * ((L + 5) * D + 1))


def tile_rows(n: int, d: Dict[str, int], sms: int) -> int:
    """Samples a block holds at a time: 64 where that fits in shared memory
    and still gives every SM a tile, else 32; 0 if neither fits."""
    def fits(rows):
        return shared_memory_bytes(rows, d["D"], d["L"], d["H"], d["P"]) <= MAX_SHARED_MEMORY
    if fits(64) and -(-n // 64) >= sms:
        return 64
    return 32 if fits(32) else 0


def _check_static(what, layer_static, transformer, spline_kw, wh_scale):
    _check_transformer(transformer, spline_kw, wh_scale)
    if any(ls.wrapped for ls in layer_static):
        raise ValueError(
            f"{what}: InverseTransform-wrapped (IAF) layers are not supported "
            "here: the density direction is a fixed point")


# -- plain version ------------------------------------------------------------


def maf_train_bwd_plain(x, gy, glad, weights, layer_static, *, num_blocks,
                        transformer="affine", spline_kw=None, wh_scale=None):
    """B10 in plain PyTorch, the adjoint written out as the kernel computes
    it: (x [N, D], gy [N, D], glad [N]) -> (gx [N, D], gradients in the
    stacks' shapes), in x's dtype. ``weights`` are mask-folded and the
    gradients dense, as the kernel's."""
    _check_static("maf_train_bwd_plain", layer_static, transformer, spline_kw, wh_scale)
    d = _dims(weights, layer_static, num_blocks)
    L, H, D, P, nb2 = (d[k] for k in ("L", "H", "D", "P", "nb2"))
    n = x.shape[0]
    wi, bi = weights["wi"].view(L, H, D), weights["bi"].view(L, H)
    wb, bb = weights["wb"].view(L, nb2, H, H), weights["bb"].view(L, nb2, H)
    wf, bf = weights["wf"].view(L, P, H), weights["bf"].view(L, P)
    K = spline_kw["num_bins"] if transformer == "rq" else 0
    skw = {k: v for k, v in (spline_kw or {}).items() if k != "num_bins"}

    def split(params):
        """[n, P] param-major columns -> widths, heights, derivatives [n, D, .]."""
        p3 = params.reshape(n, -1, D).transpose(1, 2)
        return p3[..., :K], p3[..., K:2 * K], p3[..., 2 * K:]

    with torch.no_grad():
        # forward pass, keeping what the backward needs
        kept = []
        cur = x
        for l in range(L):
            xp = cur[:, list(layer_static[l].perm_rows)]
            hs = [xp @ wi[l].T + bi[l]]
            ts = []
            for j in range(num_blocks):
                ts.append(torch.relu(torch.relu(hs[-1]) @ wb[l, 2 * j].T + bb[l, 2 * j]))
                hs.append(hs[-1] + ts[-1] @ wb[l, 2 * j + 1].T + bb[l, 2 * j + 1])
            params = hs[-1] @ wf[l].T + bf[l]
            if wh_scale is not None:
                params = torch.cat([params[:, :2 * K * D] * wh_scale,
                                    params[:, 2 * K * D:]], dim=1)
            if transformer == "affine":
                cur = (rq_ref._softplus(params[:, :D]) + _EPSILON) * xp + params[:, D:]
            else:
                uw, uh, ud = split(params)
                one = torch.ones_like(ud[..., :1])
                derivs = torch.cat(
                    [one, skw["min_derivative"] + rq_ref._softplus(ud), one], dim=-1)
                cur, _ = rq_ref.linear_tails_spline(
                    xp, uw, uh, derivs, False, skw["tail_bound"], skw["min_bin_width"],
                    skw["min_bin_height"])
            kept.append((xp, hs, ts, params))

        # backward sweep
        grads = {k: torch.zeros_like(weights[k]) for k in WEIGHT_KEYS}
        gwi, gbi = grads["wi"].view(L, H, D), grads["bi"].view(L, H)
        gwb, gbb = grads["wb"].view(L, nb2, H, H), grads["bb"].view(L, nb2, H)
        gwf, gbf = grads["wf"].view(L, P, H), grads["bf"].view(L, P)
        g = gy
        for l in range(L - 1, -1, -1):
            xp, hs, ts, params = kept[l]
            if transformer == "affine":
                u = params[:, :D]
                scale = rq_ref._softplus(u) + _EPSILON
                g_u = (g * xp + glad[:, None] / scale) * torch.sigmoid(u)
                g_params = torch.cat([g_u, g], dim=1)
                g_xp = g * scale
            else:
                uw, uh, ud = split(params)
                g_xp, g_uw, g_uh, g_ud = rq_ref.rq_spline_forward_adjoint_plain(
                    xp, uw, uh, ud, g, glad[:, None].expand(n, D), edge_derivative=1.0,
                    **skw)
                if wh_scale is not None:
                    g_uw, g_uh = g_uw * wh_scale, g_uh * wh_scale
                g_params = torch.cat([g_uw, g_uh, g_ud], dim=-1).transpose(1, 2).reshape(n, P)
            # final layer
            gwf[l] = g_params.T @ hs[-1]
            gbf[l] = g_params.sum(dim=0)
            g_h = g_params @ wf[l]
            # residual blocks, last first
            for j in range(num_blocks - 1, -1, -1):
                gwb[l, 2 * j + 1] = g_h.T @ ts[j]
                gbb[l, 2 * j + 1] = g_h.sum(dim=0)
                g_t = (g_h @ wb[l, 2 * j + 1]) * (ts[j] > 0)
                gwb[l, 2 * j] = g_t.T @ torch.relu(hs[j])
                gbb[l, 2 * j] = g_t.sum(dim=0)
                g_h = g_h + (g_t @ wb[l, 2 * j]) * (hs[j] > 0)
            # initial layer; the permuted input fed the transformer and the MADE
            gwi[l] = g_h.T @ xp
            gbi[l] = g_h.sum(dim=0)
            g_xp = g_xp + g_h @ wi[l]
            g = torch.empty_like(g_xp)
            g[:, list(layer_static[l].perm_rows)] = g_xp
    return g, grads


# -- the kernel ---------------------------------------------------------------


def _check(name, t, shape, device, dtype=torch.float32):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def maf_train_bwd_cuda(x, gy, glad, weights, layer_static, *, num_blocks,
                       transformer="affine", spline_kw=None, wh_scale=None,
                       packed=None, grads=None, rows=None):
    """B10: (x [N, D], gy [N, D], glad [N]) -> (gx [N, D], weight gradients),
    the pull-back of the cotangents through the chain's forward direction.

    ``weights`` are the mask-folded stacks; the gradients are dense (multiply
    them by the masks for the unfolded weights' gradients). ``packed`` is
    ``pack_weights(weights, ...)``, built here when not given. ``grads``,
    when given, are the tensors the gradients are written into (zeroed here
    first). ``rows`` forces the tile size (32 or 64); None chooses by shared
    memory and SM count."""
    global bwd_launch_count
    kw = dict(num_blocks=num_blocks, transformer=transformer, spline_kw=spline_kw,
              wh_scale=wh_scale)
    if x.device.type == "cpu":
        return maf_train_bwd_plain(x, gy, glad, weights, layer_static, **kw)
    what = "maf_train_bwd_cuda"
    _check_static(what, layer_static, transformer, spline_kw, wh_scale)
    dev = x.device
    if x.ndim != 2:
        raise ValueError(f"{what}: x must be [N, D], got {tuple(x.shape)}")
    n, D = x.shape
    d = _dims(weights, layer_static, num_blocks)
    if D != d["D"]:
        raise ValueError(f"{what}: x has {D} features, the weights {d['D']}")
    L, H, P, nb2 = (d[k] for k in ("L", "H", "P", "nb2"))
    K = spline_kw["num_bins"] if transformer == "rq" else 0
    if P != (2 * D if transformer == "affine" else (3 * K - 1) * D):
        raise ValueError(f"{what}: the final layer has {P} rows a layer, which is not "
                         f"what transformer={transformer!r} takes at {D} features")
    _check(f"{what}: x", x, (n, D), dev)
    _check(f"{what}: gy", gy, (n, D), dev)
    _check(f"{what}: glad", glad, (n,), dev)
    shapes = dict(wi=(L * H, D), bi=(L * H, 1), wb=(L * nb2 * H, H), bb=(L * nb2 * H, 1),
                  wf=(L * P, H), bf=(L * P, 1))
    for k in WEIGHT_KEYS:
        _check(f"{what}: weights[{k!r}]", weights[k], shapes[k], dev)
    if packed is None:
        packed = pack_weights(weights, layer_static, num_blocks)
    D4, Pp = _round4(D), _round4(P)
    packed_shapes = dict(wi=(L, D4, H), wb=(L, nb2, H, H), wf=(L, H, Pp), bf=(L, Pp))
    for k, shape in packed_shapes.items():
        _check(f"{what}: packed[{k!r}]", packed[k], shape, dev)
    _check(f"{what}: packed['idx']", packed["idx"], (L, 2 * D + 1), dev, torch.int32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if rows is None:
        rows = tile_rows(n, d, sms)
    if rows not in (32, 64) or H % 4 or (
            shared_memory_bytes(rows, D, L, H, P) > MAX_SHARED_MEMORY):
        raise ValueError(f"{what}: hidden width {H} does not fit the kernel's "
                         f"shared-memory tile of {rows} samples")
    if grads is None:
        grads = {k: torch.empty(shapes[k], dtype=torch.float32, device=dev)
                 for k in WEIGHT_KEYS}
    for k in WEIGHT_KEYS:
        _check(f"{what}: grads[{k!r}]", grads[k], shapes[k], dev)
        grads[k].zero_()  # the kernel adds into them

    lib = _build.load_library("maf_train", _declare)
    grid = max(1, min(-(-n // rows), sms))
    # per-block scratch for the kept activations (see csrc/maf_train.cu)
    stash = torch.empty(grid * L * ((nb2 + 1) * H + Pp) * (rows + 4),
                        dtype=torch.float32, device=dev)
    gx = torch.empty_like(x)
    skw = spline_kw or dict(num_bins=0, tail_bound=0.0, min_bin_width=0.0,
                            min_bin_height=0.0, min_derivative=0.0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.maf_train_launch(
            x.data_ptr(), gy.data_ptr(), glad.data_ptr(), gx.data_ptr(), n, D, L, H,
            D4, P, Pp, nb2, packed["wi"].data_ptr(), packed["wb"].data_ptr(),
            packed["wf"].data_ptr(), packed["bf"].data_ptr(), weights["wi"].data_ptr(),
            weights["bi"].data_ptr(), weights["wb"].data_ptr(), weights["bb"].data_ptr(),
            weights["wf"].data_ptr(), packed["idx"].data_ptr(),
            *(grads[k].data_ptr() for k in WEIGHT_KEYS), stash.data_ptr(), grid,
            TRANSFORMERS.index(transformer), 1.0 if wh_scale is None else wh_scale,
            skw["num_bins"], skw["tail_bound"], skw["min_bin_width"],
            skw["min_bin_height"], skw["min_derivative"], rows, stream)
    bwd_launch_count += 1
    _build.check(code, "maf_train_launch")
    return gx, grads


class _MAFTrainApply(torch.autograd.Function):
    """forward: B9 going forward, with ``wh_scale``; backward: B10. On CPU
    tensors both wrappers run their plain versions."""

    @staticmethod
    def forward(ctx, x, meta, *ws):
        layer_static, static, wh_scale, packed, rows = meta
        weights = dict(zip(WEIGHT_KEYS, ws))
        if packed is None and x.device.type == "cuda":
            packed = pack_weights(weights, layer_static, static["num_blocks"])
        ctx.save_for_backward(x, *ws)
        ctx.meta = (layer_static, static, wh_scale, packed, rows)
        return maf_flow_kernel.maf_flow_kernel_cuda(
            x, weights, layer_static, inverse=False, wh_scale=wh_scale, packed=packed,
            **static)

    @staticmethod
    def backward(ctx, gy, glad):
        x, *ws = ctx.saved_tensors
        layer_static, static, wh_scale, packed, rows = ctx.meta
        kw = dict(packed=packed, rows=rows) if x.device.type == "cuda" else {}
        gx, grads = maf_train_bwd_cuda(
            x, gy.contiguous(), glad.contiguous(), dict(zip(WEIGHT_KEYS, ws)),
            layer_static, wh_scale=wh_scale, **static, **kw)
        return (gx, None) + tuple(grads[k] for k in WEIGHT_KEYS)


def maf_train_apply(weights, x, layer_static, static, wh_scale, packed=None, rows=None):
    """The differentiable fused forward: (y [N, D], logabsdet [N]) whose
    gradients with respect to ``x`` and the mask-folded ``weights`` come
    from B10. ``static`` holds ``num_blocks``, ``transformer`` and
    ``spline_kw``."""
    _check_static("maf_train_apply", layer_static, static["transformer"],
                  static["spline_kw"], wh_scale)
    return _MAFTrainApply.apply(x, (layer_static, static, wh_scale, packed, rows),
                                *(weights[k].contiguous() for k in WEIGHT_KEYS))


# -- the trainer ----------------------------------------------------------------


def _ar_layers(flow):
    """The flow's AR transforms, unwrapped, in order."""
    from nflows_tpu_torch.ops.cuda.maf_fused import _unwrap

    return [_unwrap(t)[0] for t in list(flow.transform.transforms)[1::2]]


class FusedMAFTrainer(FusedTrainerBase):
    """Train a MAF or NSF-AR with the fused kernels.

        trainer = FusedMAFTrainer(flow, batch_size=512)
        optimizer = trainer.init_opt(lambda p: torch.optim.Adam(p, lr=3e-4))
        step = trainer.make_train_step(optimizer)
        loss = step(batch)                      # batch [N, D]; one B9, one B10
        trained_flow = trainer.to_flow()

    ``trainer.weights`` are the unfolded fp32 kernel-layout tensors (leaf
    tensors that require grad, on the flow's device), updated in place by the
    optimizer; masked entries never move.
    """

    def __init__(self, flow, batch_size):
        from nflows_tpu_torch.ops.cuda.maf_fused import _extract

        if getattr(flow, "embedding_net", None) is not None:
            raise ValueError(
                "fused training takes the RAW context (identity embedding "
                "only); flows with an embedding_net train on the eager "
                "route (training.make_train_step)")
        (self._layers, weights, num_blocks, self.features, transformer, spline_kw,
         self.context_features, masks) = _extract(
            flow, torch.float32, fold_masks=False, fold_wh_scale=False,
            allow_wrapped=False, return_masks=True)
        self.weights = {k: weights[k].clone().contiguous().requires_grad_(True)
                        for k in WEIGHT_KEYS}
        self._masks = {k: masks[k].contiguous() for k in MASKED_KEYS}
        self._static = dict(num_blocks=num_blocks, transformer=transformer,
                            spline_kw=spline_kw)
        self.device = self.weights["wi"].device
        self._flow_template = flow
        self._has_ctx = self.context_features is not None
        self._dims = _dims(self.weights, self._layers, num_blocks)
        self._wh_scale = (1.0 / math.sqrt(self._dims["H"])) if transformer == "rq" else None
        self._packed = None   # kernel layout of the folded weights, re-packed a step
        self._init_batching(batch_size)

    # -- hooks of FusedTrainerBase -----------------------------------------

    def _tile_rows(self, n):
        if self.device.type != "cuda":
            return None
        sms = torch.cuda.get_device_properties(self.device).multi_processor_count
        rows = tile_rows(n, self._dims, sms)
        if not rows:
            raise ValueError(
                f"hidden width {self._dims['H']} does not fit the training kernel's "
                "shared-memory tile; train on the eager route (training.make_train_step)")
        return rows

    def _fold(self, weights):
        """``w * mask`` for the masked stacks, under autograd: the chain rule
        of the product gives every masked entry a gradient of exactly zero."""
        folded = dict(weights)
        for k in MASKED_KEYS:
            folded[k] = weights[k] * self._masks[k]
        return folded

    def _repack(self, folded):
        if self.device.type != "cuda":
            return None
        self._packed = pack_weights(folded, self._layers, self._static["num_blocks"],
                                    out=self._packed)
        return self._packed

    def _apply(self, weights, x):
        folded = self._fold(weights)
        return maf_train_apply(folded, x, self._layers, self._static, self._wh_scale,
                               packed=self._repack(folded), rows=self._rows)

    # -- export ---------------------------------------------------------------

    def to_flow(self, weights=None):
        """Write kernel-layout weights back into a copy of the flow (the
        inverse of extraction: split the stacks and undo the param-major
        reorder; the masks stay the model's own buffers)."""
        w = self.weights if weights is None else weights
        flow = copy.deepcopy(self._flow_template)
        L, H, D, P, nb2 = (self._dims[k] for k in ("L", "H", "D", "P", "nb2"))
        mult = P // D
        order = np.array([t * mult + j for j in range(mult) for t in range(D)])
        inv_order = torch.as_tensor(np.argsort(order), device=self.device)
        with torch.no_grad():
            wi, bi = w["wi"].view(L, H, D), w["bi"].view(L, H)
            wb, bb = w["wb"].view(L, nb2, H, H), w["bb"].view(L, nb2, H)
            wf, bf = w["wf"].view(L, P, H), w["bf"].view(L, P)
            for l, ar in enumerate(_ar_layers(flow)):
                made = ar.autoregressive_net
                made.initial_layer.weight.copy_(wi[l])
                made.initial_layer.bias.copy_(bi[l])
                for j, blk in enumerate(made.blocks):
                    blk.linear_0.weight.copy_(wb[l, 2 * j])
                    blk.linear_0.bias.copy_(bb[l, 2 * j])
                    blk.linear_1.weight.copy_(wb[l, 2 * j + 1])
                    blk.linear_1.bias.copy_(bb[l, 2 * j + 1])
                made.final_layer.weight.copy_(wf[l][inv_order])
                made.final_layer.bias.copy_(bf[l][inv_order])
        return flow
