"""Fused training of autoregressive flows (MAF, NSF-AR, and IAF by
variational inference): kernel B10 (counterpart of
nflows_tpu/ops/pallas/maf_train.py; sources ``csrc/maf_train.cu`` and
``csrc/maf_train_cluster.cu``).

- :func:`maf_train_bwd_cuda` (B10): recomputes the chain in its one-pass
  direction (the log_prob of a MAF or NSF-AR, the sampling of an IAF; one
  MADE pass a layer, no fixed point) and pulls given cotangents back to the
  inputs, the context and the weights. It has two layouts: a tile of
  samples a block (``csrc/maf_train.cu``) and, where the tiles would leave
  SMs idle, a tile of 32 samples a thread-block cluster of 2, 4 or 8 blocks
  (``csrc/maf_train_cluster.cu``), chosen by :func:`launch_layout` with the
  rule B3 and B4 follow (``_trainer_common.cluster_size``); ``cluster=``
  forces one.
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

Conditional flows train fused: the context enters every MADE additively,
and B10 returns the gradients of its projections and of the context
itself. IAF (InverseTransform-wrapped) layers are refused by
``FusedMAFTrainer``: their density direction is a D-step fixed point these
kernels do not differentiate. :class:`FusedIAFTrainer` trains them in their
sampling direction instead (one MADE pass a layer, B10's
``direction="inverse"``) by reverse KL.

Samples are rows: x is [N, D], a context [N, C]. Weights are the flat
stacks of ``maf_fused._extract`` (wi, bi, wb, bb, wf, bf, and wci, bci, wcb,
bcb under a context); gradients come back in the same shapes.

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
from nflows_tpu_torch.ops.cuda._trainer_common import (
    CLUSTER_SIZES,
    FusedTrainerBase,
    cluster_gemm_floats,
    cluster_layout,
    query_active_clusters,
)
from nflows_tpu_torch.ops.cuda.maf_flow_kernel import (
    _EPSILON,
    CONTEXT_KEYS,
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

__all__ = ["FusedIAFTrainer", "FusedMAFTrainer", "maf_train_bwd_cuda", "maf_train_bwd_plain",
           "maf_train_apply", "shared_memory_bytes", "tile_rows", "launch_layout",
           "active_clusters", "CLUSTER_SIZES", "bwd_launch_count", "cluster_launch_count"]

WEIGHT_KEYS = ("wi", "bi", "wb", "bb", "wf", "bf")
MASKED_KEYS = ("wi", "wb", "wf")
DIRECTIONS = ("forward", "inverse")

# B10 launches since the last reset by cluster size (1: one block a tile)
cluster_launch_count = {1: 0, **{cs: 0 for cs in CLUSTER_SIZES}}


def __getattr__(name):
    # bwd_launch_count: every B10 launch since the last reset, the name the
    # other training modules give their counts
    if name == "bwd_launch_count":
        return sum(cluster_launch_count.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _launch_argtypes():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return ([p] * 6 + [ctypes.c_int64] + [i] * 9 + [p] * 27 + [i, i, i, i, f, i] + [f] * 4
            + [i, p])


def _declare(lib):
    lib.maf_train_launch.argtypes = _launch_argtypes()
    lib.maf_train_launch.restype = ctypes.c_int


def _declare_cluster(lib):
    lib.maf_train_cluster_launch.argtypes = _launch_argtypes()
    lib.maf_train_cluster_launch.restype = ctypes.c_int
    lib.maf_train_cluster_occupancy.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    lib.maf_train_cluster_occupancy.restype = ctypes.c_int


def shared_memory_bytes(rows: int, D: int, L: int, H: int, P: int, C: int = 0,
                        cluster: int = 1) -> int:
    """Dynamic shared memory of one block of ``rows`` samples
    (csrc/maf_train.cu: smem_bytes; with ``cluster`` > 1, a block of a
    cluster, csrc/maf_train_cluster.cu: smem_bytes, whose GEMM buffer is
    ``cluster_gemm_floats``); C context features add the context and its
    cotangent, [C4][rows + 4] each."""
    TB = max(H, _round4(P), _round4(D))
    gemm = cluster_gemm_floats(rows) if cluster > 1 else 2 * _KC * _OC
    return 4 * (gemm + (3 * TB + 2 * _round4(C)) * (rows + 4) + rows * ((L + 5) * D + 1))


def tile_rows(n: int, d: Dict[str, int], sms: int) -> int:
    """Samples a block holds at a time: 64 where that fits in shared memory
    and still gives every SM a tile, else 32; 0 if neither fits."""
    def fits(rows):
        return shared_memory_bytes(rows, d["D"], d["L"], d["H"], d["P"],
                                   d.get("C", 0)) <= MAX_SHARED_MEMORY
    if fits(64) and -(-n // 64) >= sms:
        return 64
    return 32 if fits(32) else 0


_ACTIVE_CLUSTERS = {}  # (device, context, CS, shared memory) -> clusters


def active_clusters(dev, context, cs, smem):
    """cudaOccupancyMaxActiveClusters of B10's cluster kernel, with or
    without a ``context``, in clusters of ``cs`` blocks with ``smem`` bytes
    of shared memory a block: queried once and cached; raises where it is
    0."""
    def query(found):
        lib = _build.load_library("maf_train_cluster", _declare_cluster)
        return lib.maf_train_cluster_occupancy(int(bool(context)), cs, smem, found)

    return query_active_clusters(_ACTIVE_CLUSTERS, (dev.index, bool(context), cs, smem), dev,
                                 query, "maf_train_cluster_occupancy", cs, smem)


def launch_layout(n, d, dev, rows=None, cluster=None, what="maf_train_bwd_cuda"):
    """(rows, cluster size, grid) of a B10 launch over ``n`` samples of a
    chain of dims ``d`` (``_dims``) on ``dev``: ``rows`` and ``cluster`` as
    given, or chosen (:func:`tile_rows`, ``_trainer_common.cluster_size``
    on the occupancy the card reports); the grid is min(tiles, SMs) blocks,
    or the cluster size times min(tiles, active clusters)."""
    D, L, H, P, C = (d[k] for k in ("D", "L", "H", "P", "C"))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if rows is None:
        rows = tile_rows(n, d, sms)
    if rows not in (32, 64) or H % 4 or (
            shared_memory_bytes(rows, D, L, H, P, C) > MAX_SHARED_MEMORY):
        raise ValueError(f"{what}: hidden width {H} does not fit the kernel's "
                         f"shared-memory tile of {rows} samples")

    def active(cs):
        return active_clusters(dev, C, cs, shared_memory_bytes(rows, D, L, H, P, C, cs))

    cluster, grid = cluster_layout(n, rows, sms, active, cluster, what)
    return rows, cluster, grid


def _check_static(what, layer_static, transformer, spline_kw, wh_scale,
                  direction="forward"):
    _check_transformer(transformer, spline_kw, wh_scale)
    if direction not in DIRECTIONS:
        raise ValueError(f"{what}: direction must be one of {DIRECTIONS}, got {direction!r}")
    wrapped = [ls.wrapped for ls in layer_static]
    if direction == "forward" and any(wrapped):
        raise ValueError(
            f"{what}: InverseTransform-wrapped (IAF) layers are not supported "
            "here: the density direction is a fixed point")
    if direction == "inverse" and not all(wrapped):
        raise ValueError(
            f"{what}: direction='inverse' is an IAF's sampling direction; it "
            "requires an all-wrapped (InverseTransform'd AR) chain")


# -- plain version ------------------------------------------------------------


def maf_train_bwd_plain(x, gy, glad, weights, layer_static, *, num_blocks,
                        transformer="affine", spline_kw=None, wh_scale=None,
                        context=None, direction="forward"):
    """B10 in plain PyTorch, the adjoint written out as the kernel computes
    it: (x [N, D], gy [N, D], glad [N]) -> (gx [N, D], gradients in the
    stacks' shapes), in x's dtype. ``weights`` are mask-folded and the
    gradients dense, as the kernel's. With ``context`` [N, C] (required
    exactly when the weights hold context projections) the gradients hold
    the four context stacks' and ``"ctx"``, the context's cotangent.
    ``direction="forward"`` differentiates the log_prob direction of
    unwrapped layers (B9 with ``inverse=False``); ``"inverse"`` the
    sampling direction of wrapped ones (B9 with ``inverse=True``: layers
    L-1 ... 0, no gather before the AR op, the inverse permutation after)."""
    what = "maf_train_bwd_plain"
    _check_static(what, layer_static, transformer, spline_kw, wh_scale, direction)
    maf_flow_kernel._check_context(what, weights, context)
    d = _dims(weights, layer_static, num_blocks)
    L, H, D, P, nb2, C = (d[k] for k in ("L", "H", "D", "P", "nb2", "C"))
    nb = nb2 // 2
    n = x.shape[0]
    wi, bi = weights["wi"].view(L, H, D), weights["bi"].view(L, H)
    wb, bb = weights["wb"].view(L, nb2, H, H), weights["bb"].view(L, nb2, H)
    wf, bf = weights["wf"].view(L, P, H), weights["bf"].view(L, P)
    if C:
        wci, bci = weights["wci"].view(L, H, C), weights["bci"].view(L, H)
        wcb, bcb = weights["wcb"].view(L, nb, H, C), weights["bcb"].view(L, nb, H)
    K = spline_kw["num_bins"] if transformer == "rq" else 0
    skw = {k: v for k, v in (spline_kw or {}).items() if k != "num_bins"}
    inv = direction == "inverse"
    order = range(L - 1, -1, -1) if inv else range(L)

    def split(params):
        """[n, P] param-major columns -> widths, heights, derivatives [n, D, .]."""
        p3 = params.reshape(n, -1, D).transpose(1, 2)
        return p3[..., :K], p3[..., K:2 * K], p3[..., 2 * K:]

    with torch.no_grad():
        # forward pass, keeping what the backward needs
        kept = {}
        cur = x
        for l in order:
            ls = layer_static[l]
            xp = cur if inv else cur[:, list(ls.perm_rows)]
            h0 = xp @ wi[l].T + bi[l]
            c_pre = None
            if C:
                c_pre = context @ wci[l].T + bci[l]
                h0 = h0 + torch.relu(c_pre)
            hs = [h0]
            ts = []
            for j in range(num_blocks):
                t = torch.relu(hs[-1]) @ wb[l, 2 * j].T + bb[l, 2 * j]
                if C:
                    t = t + context @ wcb[l, j].T + bcb[l, j]
                ts.append(torch.relu(t))
                hs.append(hs[-1] + ts[-1] @ wb[l, 2 * j + 1].T + bb[l, 2 * j + 1])
            params = hs[-1] @ wf[l].T + bf[l]
            if wh_scale is not None:
                params = torch.cat([params[:, :2 * K * D] * wh_scale,
                                    params[:, 2 * K * D:]], dim=1)
            if transformer == "affine":
                y = (rq_ref._softplus(params[:, :D]) + _EPSILON) * xp + params[:, D:]
            else:
                uw, uh, ud = split(params)
                one = torch.ones_like(ud[..., :1])
                derivs = torch.cat(
                    [one, skw["min_derivative"] + rq_ref._softplus(ud), one], dim=-1)
                y, _ = rq_ref.linear_tails_spline(
                    xp, uw, uh, derivs, False, skw["tail_bound"], skw["min_bin_width"],
                    skw["min_bin_height"])
            cur = y[:, list(ls.inv_perm_rows)] if inv else y
            kept[l] = (xp, hs, ts, params, c_pre)

        # backward sweep
        keys = WEIGHT_KEYS + (CONTEXT_KEYS if C else ())
        grads = {k: torch.zeros_like(weights[k]) for k in keys}
        gwi, gbi = grads["wi"].view(L, H, D), grads["bi"].view(L, H)
        gwb, gbb = grads["wb"].view(L, nb2, H, H), grads["bb"].view(L, nb2, H)
        gwf, gbf = grads["wf"].view(L, P, H), grads["bf"].view(L, P)
        if C:
            gwci, gbci = grads["wci"].view(L, H, C), grads["bci"].view(L, H)
            gwcb, gbcb = grads["wcb"].view(L, nb, H, C), grads["bcb"].view(L, nb, H)
            gctx = torch.zeros_like(context)
        g = gy
        for l in reversed(order):
            ls = layer_static[l]
            xp, hs, ts, params, c_pre = kept[l]
            if inv:
                # out[:, i] = y[:, inv_perm[i]], so y's feature t went to perm[t]
                g = g[:, list(ls.perm_rows)]
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
                if C:
                    # the cotangent of the block's pre-relu sum feeds its context term
                    gwcb[l, j] = g_t.T @ context
                    gbcb[l, j] = g_t.sum(dim=0)
                    gctx = gctx + g_t @ wcb[l, j]
                gwb[l, 2 * j] = g_t.T @ torch.relu(hs[j])
                gbb[l, 2 * j] = g_t.sum(dim=0)
                g_h = g_h + (g_t @ wb[l, 2 * j]) * (hs[j] > 0)
            if C:
                # h_0 holds relu(Wci c + bci)
                g_c = g_h * (c_pre > 0)
                gwci[l] = g_c.T @ context
                gbci[l] = g_c.sum(dim=0)
                gctx = gctx + g_c @ wci[l]
            # initial layer; the layer's input fed the transformer and the MADE
            gwi[l] = g_h.T @ xp
            gbi[l] = g_h.sum(dim=0)
            g_xp = g_xp + g_h @ wi[l]
            if inv:
                g = g_xp
            else:
                g = torch.empty_like(g_xp)
                g[:, list(ls.perm_rows)] = g_xp
        if C:
            grads["ctx"] = gctx
    return g, grads


# -- the kernel ---------------------------------------------------------------


def _check(name, t, shape, device, dtype=torch.float32):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def maf_train_bwd_cuda(x, gy, glad, weights, layer_static, *, num_blocks,
                       transformer="affine", spline_kw=None, wh_scale=None,
                       context=None, direction="forward", packed=None, grads=None,
                       rows=None, cluster=None):
    """B10: (x [N, D], gy [N, D], glad [N]) -> (gx [N, D], weight gradients),
    the pull-back of the cotangents through the chain's one-pass direction
    (``direction``, and the context, as in :func:`maf_train_bwd_plain`; with
    a context the gradients hold ``"ctx"`` too).

    ``weights`` are the mask-folded stacks; the gradients are dense (multiply
    them by the masks for the unfolded weights' gradients). ``packed`` is
    ``pack_weights(weights, ...)``, built here when not given. ``grads``,
    when given, are the tensors the weight gradients are written into
    (zeroed here first). ``rows`` forces the tile size (32 or 64); None
    chooses by shared memory and SM count. ``cluster`` forces the blocks a
    tile is spread over (1, or one of CLUSTER_SIZES at 32-sample tiles);
    None chooses (:func:`launch_layout`)."""
    kw = dict(num_blocks=num_blocks, transformer=transformer, spline_kw=spline_kw,
              wh_scale=wh_scale, context=context, direction=direction)
    if x.device.type == "cpu":
        return maf_train_bwd_plain(x, gy, glad, weights, layer_static, **kw)
    return _launch(x, gy, glad, weights, layer_static, packed=packed, grads=grads, rows=rows,
                   cluster=cluster, **kw)


def _launch(x, gy, glad, weights, layer_static, *, num_blocks, transformer, spline_kw,
            wh_scale, context, direction, packed, grads, rows, cluster):
    """B10's launch on CUDA tensors: :func:`maf_train_bwd_cuda` past its CPU
    branch."""
    what = "maf_train_bwd_cuda"
    _check_static(what, layer_static, transformer, spline_kw, wh_scale, direction)
    maf_flow_kernel._check_context(what, weights, context)
    dev = x.device
    if x.ndim != 2:
        raise ValueError(f"{what}: x must be [N, D], got {tuple(x.shape)}")
    n, D = x.shape
    d = _dims(weights, layer_static, num_blocks)
    if D != d["D"]:
        raise ValueError(f"{what}: x has {D} features, the weights {d['D']}")
    L, H, P, nb2, C = (d[k] for k in ("L", "H", "P", "nb2", "C"))
    nb = nb2 // 2
    K = spline_kw["num_bins"] if transformer == "rq" else 0
    if P != (2 * D if transformer == "affine" else (3 * K - 1) * D):
        raise ValueError(f"{what}: the final layer has {P} rows a layer, which is not "
                         f"what transformer={transformer!r} takes at {D} features")
    _check(f"{what}: x", x, (n, D), dev)
    _check(f"{what}: gy", gy, (n, D), dev)
    _check(f"{what}: glad", glad, (n,), dev)
    shapes = dict(wi=(L * H, D), bi=(L * H, 1), wb=(L * nb2 * H, H), bb=(L * nb2 * H, 1),
                  wf=(L * P, H), bf=(L * P, 1))
    if C:
        _check(f"{what}: context", context, (n, C), dev)
        shapes.update(wci=(L * H, C), bci=(L * H, 1), wcb=(L * nb * H, C),
                      bcb=(L * nb * H, 1))
    keys = tuple(shapes)
    for k in keys:
        _check(f"{what}: weights[{k!r}]", weights[k], shapes[k], dev)
    if packed is None:
        packed = pack_weights(weights, layer_static, num_blocks)
    D4, Pp, C4 = _round4(D), _round4(P), _round4(C)
    packed_shapes = dict(wi=(L, D4, H), wb=(L, nb2, H, H), wf=(L, H, Pp), bf=(L, Pp))
    if C:
        packed_shapes.update(wci=(L, C4, H), wcb=(L, nb, C4, H))
    for k, shape in packed_shapes.items():
        if k not in packed:
            raise ValueError(f"{what}: packed has no {k}: pack the conditional weights "
                             "with pack_weights")
        _check(f"{what}: packed[{k!r}]", packed[k], shape, dev)
    _check(f"{what}: packed['idx']", packed["idx"], (L, 2 * D + 1), dev, torch.int32)
    rows, cluster, grid = launch_layout(n, d, dev, rows, cluster, what)
    if grads is None:
        grads = {k: torch.empty(shapes[k], dtype=torch.float32, device=dev) for k in keys}
    for k in keys:
        _check(f"{what}: grads[{k!r}]", grads[k], shapes[k], dev)
        grads[k].zero_()  # the kernel adds into them

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    if cluster == 1:
        entry = _build.load_library("maf_train", _declare).maf_train_launch
    else:
        entry = _build.load_library("maf_train_cluster",
                                    _declare_cluster).maf_train_cluster_launch
    # scratch for the kept activations, one slot a block or a cluster (see
    # csrc/maf_train.cu)
    stash = torch.empty(grid // cluster * L * ((nb2 + 1) * H + Pp) * (rows + 4),
                        dtype=torch.float32, device=dev)
    gx = torch.empty_like(x)
    gctx = torch.empty_like(context) if C else None
    skw = spline_kw or dict(num_bins=0, tail_bound=0.0, min_bin_width=0.0,
                            min_bin_height=0.0, min_derivative=0.0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = entry(
            x.data_ptr(), ptr(context), gy.data_ptr(), glad.data_ptr(), gx.data_ptr(),
            ptr(gctx), n, D, L, H, D4, P, Pp, nb2, C, C4,
            packed["wi"].data_ptr(), packed["wb"].data_ptr(), packed["wf"].data_ptr(),
            packed["bf"].data_ptr(), ptr(packed.get("wci")), ptr(packed.get("wcb")),
            *(weights[k].data_ptr() for k in ("wi", "bi", "wb", "bb", "wf")),
            *(ptr(weights.get(k)) for k in CONTEXT_KEYS), packed["idx"].data_ptr(),
            *(grads[k].data_ptr() for k in WEIGHT_KEYS),
            *(ptr(grads.get(k)) for k in CONTEXT_KEYS),
            stash.data_ptr(), grid, cluster, DIRECTIONS.index(direction),
            TRANSFORMERS.index(transformer), 1.0 if wh_scale is None else wh_scale,
            skw["num_bins"], skw["tail_bound"], skw["min_bin_width"],
            skw["min_bin_height"], skw["min_derivative"], rows, stream)
    cluster_launch_count[cluster] += 1
    _build.check(code, "maf_train_launch" if cluster == 1 else "maf_train_cluster_launch")
    if C:
        grads = {**grads, "ctx": gctx}
    return gx, grads


class _MAFTrainApply(torch.autograd.Function):
    """forward: B9 in the one-pass direction on its SIMT kernel (the
    trainer re-packs its weights in place every step; the wgmma route would
    pack an image too), with ``wh_scale``; backward: B10. On CPU tensors
    both wrappers run their plain versions."""

    @staticmethod
    def forward(ctx, x, context, meta, *ws):
        layer_static, static, wh_scale, packed, rows, direction, keys = meta
        weights = dict(zip(keys, ws))
        if packed is None and x.device.type == "cuda":
            packed = pack_weights(weights, layer_static, static["num_blocks"])
        ctx.save_for_backward(x, context, *ws)
        ctx.meta = (layer_static, static, wh_scale, packed, rows, direction, keys)
        return maf_flow_kernel.maf_flow_kernel_cuda(
            x, weights, layer_static, inverse=direction == "inverse", wh_scale=wh_scale,
            context=context, packed=packed, gemm="simt", **static)

    @staticmethod
    def backward(ctx, gy, glad):
        x, context, *ws = ctx.saved_tensors
        layer_static, static, wh_scale, packed, rows, direction, keys = ctx.meta
        kw = dict(packed=packed, rows=rows) if x.device.type == "cuda" else {}
        gx, grads = maf_train_bwd_cuda(
            x, gy.contiguous(), glad.contiguous(), dict(zip(keys, ws)), layer_static,
            wh_scale=wh_scale, context=context, direction=direction, **static, **kw)
        return (gx, grads.get("ctx"), None) + tuple(grads[k] for k in keys)


def maf_train_apply(weights, x, layer_static, static, wh_scale, packed=None, rows=None,
                    context=None, direction="forward"):
    """The differentiable fused one-pass chain: (y [N, D], logabsdet [N])
    whose gradients with respect to ``x``, ``context`` and the mask-folded
    ``weights`` come from B10. ``static`` holds ``num_blocks``,
    ``transformer`` and ``spline_kw``. ``direction="forward"`` is the
    log_prob direction of unwrapped layers (B9 going forward);
    ``"inverse"`` the sampling direction of an all-wrapped chain (an IAF;
    B9 coming back), where x is the base noise and y the sample. An
    embedding net outside the kernel trains through the context's
    gradient. ``rows`` goes to B10 (:func:`maf_train_bwd_cuda`; None
    chooses), which chooses its cluster size."""
    _check_static("maf_train_apply", layer_static, static["transformer"],
                  static["spline_kw"], wh_scale, direction)
    maf_flow_kernel._check_context("maf_train_apply", weights, context)
    keys = WEIGHT_KEYS + (CONTEXT_KEYS if context is not None else ())
    return _MAFTrainApply.apply(
        x, context, (layer_static, static, wh_scale, packed, rows, direction, keys),
        *(weights[k].contiguous() for k in keys))


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
        loss = step(batch, context)             # a conditional flow: context [N, C]
        trained_flow = trainer.to_flow()

    ``trainer.weights`` are the unfolded fp32 kernel-layout tensors (leaf
    tensors that require grad, on the flow's device), updated in place by the
    optimizer; masked entries never move. A conditional flow adds the
    MADE's context projections (``wci``, ``bci``, ``wcb``, ``bcb``, plain
    denses without masks) and takes the raw context in every step.
    """

    _direction = "forward"   # the IAF subclass trains the sampling direction

    def __init__(self, flow, batch_size):
        from nflows_tpu_torch.ops.cuda.maf_fused import _extract

        wrapped_ok = self._direction == "inverse"
        if getattr(flow, "embedding_net", None) is not None:
            raise ValueError(
                "fused training takes the RAW context (identity embedding "
                "only); flows with an embedding_net train on the eager "
                "route (training.make_train_step), or compose "
                "maf_train_apply with the embedding net, whose gradient "
                "flows through the context's")
        (self._layers, weights, num_blocks, self.features, transformer, spline_kw,
         self.context_features, masks) = _extract(
            flow, torch.float32, fold_masks=False, fold_wh_scale=False,
            allow_wrapped=wrapped_ok, return_masks=True)
        if wrapped_ok and not all(ls.wrapped for ls in self._layers):
            raise ValueError(
                "the IAF trainer requires an all-wrapped "
                "(InverseTransform'd AR) chain; train plain MAF layers "
                "with FusedMAFTrainer")
        self._has_ctx = self.context_features is not None
        keys = WEIGHT_KEYS + (CONTEXT_KEYS if self._has_ctx else ())
        self.weights = {k: weights[k].clone().contiguous().requires_grad_(True)
                        for k in keys}
        self._masks = {k: masks[k].contiguous() for k in MASKED_KEYS}
        self._static = dict(num_blocks=num_blocks, transformer=transformer,
                            spline_kw=spline_kw)
        self.device = self.weights["wi"].device
        self._flow_template = flow
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

    def _apply(self, weights, x, context=None):
        folded = self._fold(weights)
        return maf_train_apply(folded, x, self._layers, self._static, self._wh_scale,
                               packed=self._repack(folded), rows=self._rows,
                               context=context, direction=self._direction)

    # -- export ---------------------------------------------------------------

    def to_flow(self, weights=None):
        """Write kernel-layout weights back into a copy of the flow (the
        inverse of extraction: split the stacks and undo the param-major
        reorder; the masks stay the model's own buffers; the context
        projections go back to the MADE's context layers)."""
        w = self.weights if weights is None else weights
        flow = copy.deepcopy(self._flow_template)
        L, H, D, P, nb2, C = (self._dims[k] for k in ("L", "H", "D", "P", "nb2", "C"))
        nb = nb2 // 2
        mult = P // D
        order = np.array([t * mult + j for j in range(mult) for t in range(D)])
        inv_order = torch.as_tensor(np.argsort(order), device=self.device)
        with torch.no_grad():
            wi, bi = w["wi"].view(L, H, D), w["bi"].view(L, H)
            wb, bb = w["wb"].view(L, nb2, H, H), w["bb"].view(L, nb2, H)
            wf, bf = w["wf"].view(L, P, H), w["bf"].view(L, P)
            if C:
                wci, bci = w["wci"].view(L, H, C), w["bci"].view(L, H)
                wcb, bcb = w["wcb"].view(L, nb, H, C), w["bcb"].view(L, nb, H)
            for l, ar in enumerate(_ar_layers(flow)):
                made = ar.autoregressive_net
                made.initial_layer.weight.copy_(wi[l])
                made.initial_layer.bias.copy_(bi[l])
                if C:
                    made.context_layer.weight.copy_(wci[l])
                    made.context_layer.bias.copy_(bci[l])
                for j, blk in enumerate(made.blocks):
                    blk.linear_0.weight.copy_(wb[l, 2 * j])
                    blk.linear_0.bias.copy_(bb[l, 2 * j])
                    blk.linear_1.weight.copy_(wb[l, 2 * j + 1])
                    blk.linear_1.bias.copy_(bb[l, 2 * j + 1])
                    if C:
                        blk.context_layer.weight.copy_(wcb[l, j])
                        blk.context_layer.bias.copy_(bcb[l, j])
                made.final_layer.weight.copy_(wf[l][inv_order])
                made.final_layer.bias.copy_(bf[l][inv_order])
        return flow


class FusedIAFTrainer(FusedMAFTrainer):
    """Train an IAF (every AR layer InverseTransform-wrapped) with the fused
    kernels in its sampling direction, by variational inference.

    An IAF's log_prob is a D-step fixed point (the reason
    :class:`FusedMAFTrainer` refuses it), but its sampling pass, base noise
    through ``transform.inverse``, is one MADE pass a layer: B9 coming back,
    and B10 with ``direction="inverse"`` its backward. The objective is the
    reverse KL, the negative ELBO over the flow's own samples::

        trainer = FusedIAFTrainer(iaf, batch_size=512)
        optimizer = trainer.init_opt(lambda p: torch.optim.Adam(p, lr=1e-3))
        step = trainer.make_vi_train_step(optimizer, target_log_prob)
        loss = step(torch.Generator(device=trainer.device).manual_seed(0))

    ``target_log_prob`` is any differentiable [N, D] -> [N] PyTorch function
    (an unnormalised posterior); its gradient enters B10 through the
    samples' cotangent. ``sample_and_log_prob_fn`` gives the fused (samples,
    log q) pair for other objectives, with the sign of
    ``Flow.sample_and_log_prob``: log q = log N(z) - logabsdet.
    """

    _direction = "inverse"

    def sample_and_log_prob_fn(self, weights, z, context=None):
        """(weights, z [N, D][, context [N, C]]) -> (x [N, D], log q [N]),
        differentiable with respect to the weights (and z and the context)
        through B9 and B10."""
        context = self._guard_ctx(context, z)
        x, lad = self._apply(weights, z, context)
        log_z = 0.5 * self.features * math.log(2.0 * math.pi)
        return x, -0.5 * (z * z).sum(dim=1) - log_z - lad

    def _loss_from_apply(self, apply):
        # every inherited step builder goes through this hook, so none of
        # them can optimise the density direction, which is not available
        raise NotImplementedError(
            "an IAF's log_prob direction is a fixed point; this trainer "
            "optimizes the SAMPLING direction -- use make_vi_train_step "
            "(negative ELBO) or sample_and_log_prob_fn for a custom "
            "objective")

    def make_vi_train_step(self, optimizer, target_log_prob):
        """The reverse-KL step: minimise E_q[log q(x) - log p~(x)] over the
        flow's own samples. ``step(generator[, context]) -> loss`` draws
        ``batch_size`` rows of base noise from ``generator``, a
        ``torch.Generator`` on the trainer's device, takes the mean of
        ``log q - target_log_prob(x)``, and steps ``optimizer`` (from
        :meth:`init_opt`), which updates ``trainer.weights`` in place. A
        conditional IAF takes a context [batch_size, C] as well."""
        def vag(weights, z, context=None):
            x, lq = self.sample_and_log_prob_fn(weights, z, context)
            loss = (lq - target_log_prob(x)).mean()
            grads = torch.autograd.grad(loss, list(weights.values()))
            return loss.detach(), dict(zip(weights, grads))

        def step(generator, context=None):
            if not isinstance(generator, torch.Generator):
                raise TypeError("make_vi_train_step: pass an explicit torch.Generator")
            if generator.device.type != self.device.type:
                raise ValueError(
                    f"the generator is on {generator.device}, the trainer on {self.device}")
            z = torch.randn(self.batch_size, self.features, generator=generator,
                            device=self.device)
            return self._update(vag, optimizer, z, context)

        return step
