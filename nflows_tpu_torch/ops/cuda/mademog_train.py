"""Fused training of the mixture-density family (MADEMoG,
MixtureOfGaussiansMADE): kernel B12 (counterpart of
nflows_tpu/ops/pallas/mademog_train.py; source ``csrc/mademog_train.cu``).

- :func:`mademog_train_bwd_cuda` (B12): recomputes B11's MADE pass and
  mixture head for a tile of samples and pulls the cotangent of lp back to
  the inputs, the context and every weight.
- :func:`mademog_train_apply` is the ``torch.autograd.Function`` whose
  forward is B11 (``mademog_fused.py``) and whose backward is B12: a fused
  step is these two launches.
- :class:`FusedMADEMoGTrainer` owns the UNFOLDED fp32 kernel-layout weights
  as the trainable tensors, plus the MADE masks in kernel layout, and folds
  ``w * mask`` every step under autograd, as ``FusedMAFTrainer`` does: the
  chain rule through the product gives a masked entry a gradient of exactly
  zero, so Adam never moves it. Every weight is a transpose or permutation
  of the model's own, Adam on them follows the trajectory of Adam on the
  model, and :meth:`FusedMADEMoGTrainer.to_dist` maps them back.

:func:`mademog_train_bwd_plain` is B12's plain version: the adjoint written
out, as the kernel computes it (the TPU kernel gets it from ``jax.vjp``
traced inside the kernel). Per sample and feature, with g the cotangent of
lp, a = log_softmax(logits), s = softplus(u) + eps, z = (x - mu) / s,
c_k = a_k - log s_k - log(2 pi) / 2 - z_k^2 / 2, r = softmax_k(c) and
pi = softmax_k(logits):

    g_logit_k = g (r_k - pi_k)
    g_mu_k    = g r_k z_k / s_k
    g_u_k     = g r_k (z_k^2 - 1) / s_k * sigmoid(u_k)
    g_x       = -g sum_k r_k z_k / s_k  (+ Wi^T g_h0 through the MADE)

then the MADE backward, B10's, with the context projections: block j's
pre-relu cotangent gives gWcb_j, gbcb_j and Wcb_j^T of it into gctx, and
the initial layer's cotangent through relu'(c_init) gives gWci, gbci and
Wci^T of it into gctx. The CPU tests hold it against autograd over
``mademog_log_prob_plain`` in float64 and against ``jax.grad``. A wrapper
given a CPU tensor runs its plain version; given a CUDA tensor it launches
the kernel or raises.

Samples are rows: x is [N, D], the context [N, C], glp [N].
"""

from __future__ import annotations

import copy
import ctypes

import numpy as np
import torch

from nflows_tpu_torch.ops.cuda import _build, mademog_fused
from nflows_tpu_torch.ops.cuda._trainer_common import FusedTrainerBase
from nflows_tpu_torch.ops.cuda.mademog_fused import (
    CONTEXT_KEYS,
    MASKED_KEYS,
    ROWS,
    WEIGHT_KEYS,
    _extract,
    check_inputs,
    check_packed,
    data_ptr,
    head_terms,
    k_major_order,
    pack_weights,
)
from nflows_tpu_torch.ops.cuda.nsf_flow_kernel import (
    _KC,
    _OC,
    MAX_SHARED_MEMORY,
    _round4,
)

__all__ = ["FusedMADEMoGTrainer", "mademog_train_bwd_cuda", "mademog_train_bwd_plain",
           "mademog_train_apply", "shared_memory_bytes", "bwd_launch_count"]

bwd_launch_count = 0  # B12 launches since the last reset


def _keys(weights):
    return WEIGHT_KEYS + (CONTEXT_KEYS if "wci" in weights else ())


# -- plain version ------------------------------------------------------------


def mademog_train_bwd_plain(x, glp, weights, static, context=None):
    """B12 in plain PyTorch, the adjoint written out as the kernel computes
    it: (x [N, D], glp [N], context [N, C] or None) -> (gx [N, D], gctx
    [N, C] or None, gradients in the stacks' shapes), in x's dtype.
    ``weights`` are mask-folded and the gradients dense, as the kernel's."""
    K, nb, eps = static["K"], static["num_blocks"], static["epsilon"]
    H = weights["bi"].shape[0]
    n = x.shape[0]
    w = weights
    blk = lambda j: slice(j * H, (j + 1) * H)  # noqa: E731
    with torch.no_grad():
        # forward, keeping what the backward needs
        c_init = None
        h = x @ w["wi"].T + w["bi"][:, 0]
        if context is not None:
            c_init = torch.relu(context @ w["wci"].T + w["bci"][:, 0])
            h = h + c_init
        hs, ts = [h], []
        for j in range(nb):
            pre = torch.relu(hs[-1]) @ w["wb"][blk(2 * j)].T + w["bb"][blk(2 * j), 0]
            if context is not None:
                pre = pre + (context @ w["wcb"][blk(j)].T + w["bcb"][blk(j), 0])
            ts.append(torch.relu(pre))
            hs.append(hs[-1] + ts[-1] @ w["wb"][blk(2 * j + 1)].T + w["bb"][blk(2 * j + 1), 0])
        P = hs[-1] @ w["wf"].T + w["bf"][:, 0]

        # the head's adjoint
        u, log_coef, s, z, comp = head_terms(x, P, K, eps)
        e = torch.exp(comp - comp.max(dim=1, keepdim=True).values)
        r = e / e.sum(dim=1, keepdim=True)
        g = glp[:, None, None]
        grz = g * r * z / s
        gP = torch.stack([g * (r - torch.exp(log_coef)), grz,
                          g * r * (z * z - 1) / s * torch.sigmoid(u)], dim=1).reshape(n, -1)
        gx = -grz.sum(dim=1)

        grads = {k: torch.zeros_like(w[k]) for k in _keys(w)}
        gctx = None if context is None else torch.zeros_like(context)
        grads["wf"] = gP.T @ hs[-1]
        grads["bf"] = gP.sum(dim=0)[:, None]
        g_h = gP @ w["wf"]
        # residual blocks, last first
        for j in range(nb - 1, -1, -1):
            r0, r1 = blk(2 * j), blk(2 * j + 1)
            grads["wb"][r1] = g_h.T @ ts[j]
            grads["bb"][r1, 0] = g_h.sum(dim=0)
            g_t = (g_h @ w["wb"][r1]) * (ts[j] > 0)
            if context is not None:
                grads["wcb"][blk(j)] = g_t.T @ context
                grads["bcb"][blk(j), 0] = g_t.sum(dim=0)
                gctx = gctx + g_t @ w["wcb"][blk(j)]
            grads["wb"][r0] = g_t.T @ torch.relu(hs[j])
            grads["bb"][r0, 0] = g_t.sum(dim=0)
            g_h = g_h + (g_t @ w["wb"][r0]) * (hs[j] > 0)
        # initial layer and the context projection added to it
        if context is not None:
            g_c = g_h * (c_init > 0)
            grads["wci"] = g_c.T @ context
            grads["bci"] = g_c.sum(dim=0)[:, None]
            gctx = gctx + g_c @ w["wci"]
        grads["wi"] = g_h.T @ x
        grads["bi"] = g_h.sum(dim=0)[:, None]
        gx = gx + g_h @ w["wi"]
    return gx, gctx, grads


# -- the kernel ---------------------------------------------------------------


def shared_memory_bytes(D: int, C: int, K: int, H: int) -> int:
    """Dynamic shared memory of one block (csrc/mademog_train.cu: smem_bytes)."""
    TB = max(H, _round4(3 * K * D))
    RS = ROWS + 4
    return 4 * (2 * _KC * _OC + RS * (3 * TB + 2 * D + 2 * C) + ROWS)


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mademog_train_launch.argtypes = (
        [p] * 5 + [ctypes.c_int64] + [i] * 7 + [f] + [p] * 10 + [p] * 5 + [p] * 10
        + [p, i, p])
    lib.mademog_train_launch.restype = i


def mademog_train_bwd_cuda(x, glp, weights, static, context=None, packed=None, grads=None):
    """B12: (x [N, D], glp [N], context [N, C] or None) -> (gx [N, D], gctx
    [N, C] or None, weight gradients), the pull-back of glp through B11.

    ``weights`` are the mask-folded stacks; the gradients are dense (multiply
    them by the masks for the unfolded weights' gradients). ``packed`` is
    ``pack_weights(weights, static)``, built here when not given. ``grads``,
    when given, are the tensors the gradients are written into (zeroed here
    first)."""
    global bwd_launch_count
    if x.device.type == "cpu":
        return mademog_train_bwd_plain(x, glp, weights, static, context)
    what = "mademog_train_bwd_cuda"
    dev = x.device
    Cf = weights["wci"].shape[1] if "wci" in weights else None
    check_inputs(what, x, context, static, Cf)
    n = x.shape[0]
    if tuple(glp.shape) != (n,) or glp.dtype != torch.float32 or not glp.is_contiguous() \
            or glp.device != dev:
        raise ValueError(f"{what}: glp must be a contiguous [{n}] float32 tensor on {dev}")
    D, K, H, nb = static["D"], static["K"], static["H"], static["num_blocks"]
    C = Cf or 0
    shapes = dict(wi=(H, D), bi=(H, 1), wb=(2 * nb * H, H), bb=(2 * nb * H, 1),
                  wf=(3 * K * D, H), bf=(3 * K * D, 1))
    if Cf is not None:
        shapes.update(wci=(H, C), bci=(H, 1), wcb=(nb * H, C), bcb=(nb * H, 1))
    for k, shape in shapes.items():
        t = weights[k]
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{what}: weights[{k!r}] must be a contiguous {shape} float32 "
                             f"tensor on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if packed is None:
        packed = pack_weights(weights, static)
    check_packed(what, packed, static, Cf, dev)
    if H % 4 or shared_memory_bytes(D, C, K, H) > MAX_SHARED_MEMORY:
        raise ValueError(f"{what}: hidden width {H} does not fit the kernel's "
                         "shared-memory tile")
    if grads is None:
        grads = {k: torch.empty(shapes[k], dtype=torch.float32, device=dev) for k in shapes}
    for k in shapes:
        if tuple(grads[k].shape) != shapes[k] or grads[k].dtype != torch.float32 \
                or grads[k].device != dev or not grads[k].is_contiguous():
            raise ValueError(f"{what}: grads[{k!r}] must be a contiguous {shapes[k]} float32 "
                             f"tensor on {dev}")
        grads[k].zero_()  # the kernel adds into them

    lib = _build.load_library("mademog_train", _declare)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-n // ROWS), sms))
    # per-block scratch for the kept activations (see csrc/mademog_train.cu)
    stash = torch.empty(grid * (2 + 2 * nb) * H * (ROWS + 4), dtype=torch.float32, device=dev)
    gx = torch.empty_like(x)
    gctx = None if context is None else torch.empty_like(context)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.mademog_train_launch(
            x.data_ptr(), data_ptr(context), glp.data_ptr(), gx.data_ptr(), data_ptr(gctx),
            n, D, C, K, H, 3 * K * D, _round4(3 * K * D), nb, static["epsilon"],
            *(data_ptr(packed.get(k)) for k in WEIGHT_KEYS + CONTEXT_KEYS),
            *(data_ptr(weights.get(k)) for k in ("wi", "wb", "wf", "wci", "wcb")),
            *(data_ptr(grads.get(k)) for k in WEIGHT_KEYS + CONTEXT_KEYS),
            stash.data_ptr(), grid, stream)
    bwd_launch_count += 1
    _build.check(code, "mademog_train_launch")
    return gx, gctx, grads


class _MADEMoGTrainApply(torch.autograd.Function):
    """forward: B11; backward: B12. On CPU tensors both wrappers run their
    plain versions."""

    @staticmethod
    def forward(ctx, x, context, meta, *ws):
        static, keys, packed = meta
        weights = dict(zip(keys, ws))
        if packed is None and x.device.type == "cuda":
            packed = pack_weights(weights, static)
        ctx.save_for_backward(x, context, *ws)
        ctx.meta = (static, keys, packed)
        return mademog_fused.mademog_log_prob_cuda(x, weights, static, context=context,
                                                   packed=packed)

    @staticmethod
    def backward(ctx, glp):
        x, context, *ws = ctx.saved_tensors
        static, keys, packed = ctx.meta
        kw = dict(packed=packed) if x.device.type == "cuda" else {}
        gx, gctx, grads = mademog_train_bwd_cuda(
            x, glp.contiguous(), dict(zip(keys, ws)), static, context=context, **kw)
        return (gx, gctx, None) + tuple(grads[k] for k in keys)


def mademog_train_apply(weights, x, static, context=None, packed=None):
    """The differentiable fused log_prob: lp [N] whose gradients with
    respect to ``x``, ``context`` and the mask-folded ``weights`` come from
    B12."""
    keys = _keys(weights)
    return _MADEMoGTrainApply.apply(x, context, (static, keys, packed),
                                    *(weights[k].contiguous() for k in keys))


# -- the trainer ----------------------------------------------------------------


class FusedMADEMoGTrainer(FusedTrainerBase):
    """Train a MADEMoG or a MixtureOfGaussiansMADE with the fused kernels.

        trainer = FusedMADEMoGTrainer(dist, batch_size=512)
        optimizer = trainer.init_opt(lambda p: torch.optim.Adam(p, lr=3e-4))
        step = trainer.make_train_step(optimizer)
        loss = step(batch)            # [N, D]; step(batch, context) if conditional
        trained = trainer.to_dist()

    ``trainer.weights`` are the unfolded fp32 kernel-layout tensors (leaf
    tensors that require grad, on the model's device), updated in place by
    the optimizer; masked entries never move. The loss is -mean(lp): the
    mixture head is the density, there is no base distribution.
    """

    def __init__(self, dist, batch_size):
        weights, self._static, self.context_features, masks = _extract(
            dist, torch.float32, fold_masks=False, return_masks=True)
        self.weights = {k: weights[k].clone().contiguous().requires_grad_(True)
                        for k in _keys(weights)}
        self._masks = {k: masks[k].contiguous() for k in MASKED_KEYS}
        self.features = self._static["D"]
        self.device = self.weights["wi"].device
        self._dist_template = dist
        self._has_ctx = self.context_features is not None
        self._packed = None   # kernel layout of the folded weights, re-packed a step
        self._init_batching(batch_size)

    # -- hooks of FusedTrainerBase -----------------------------------------

    def _tile_rows(self, n):
        if self.device.type != "cuda":
            return None
        s = self._static
        if shared_memory_bytes(s["D"], self.context_features or 0, s["K"],
                               s["H"]) > MAX_SHARED_MEMORY:
            raise ValueError(
                f"hidden width {s['H']} does not fit the training kernel's shared-memory "
                "tile; train on the eager route (training.make_train_step)")
        return ROWS

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
        self._packed = pack_weights(folded, self._static, out=self._packed)
        return self._packed

    def _apply(self, weights, x, context=None):
        if context is not None:
            if context.shape[0] != x.shape[0]:
                raise ValueError(
                    f"context has {context.shape[0]} rows but the batch has {x.shape[0]}")
            context = context.to(torch.float32).contiguous()
        folded = self._fold(weights)
        return mademog_train_apply(folded, x, self._static, context=context,
                                   packed=self._repack(folded))

    def _loss_from_apply(self, apply):
        """-mean log_prob; the kernel returns lp itself (no base-measure
        term), so the base class's noise-plus-logdet assembly is replaced."""

        def loss(weights, batch, context=None):
            self._guard_ctx(context)
            return -apply(weights, batch, context).mean()

        return loss

    # -- export ---------------------------------------------------------------

    def to_dist(self, weights=None):
        """A copy of the model the trainer was built from (a MADEMoG or a
        bare MixtureOfGaussiansMADE) holding ``weights`` (default: the
        trainer's): the inverse of extraction, which undoes the K-major
        reorder; the masks stay the model's own buffers."""
        w = self.weights if weights is None else weights
        dist = copy.deepcopy(self._dist_template)
        made = getattr(dist, "made", dist)
        H = self._static["H"]
        inv_order = torch.as_tensor(
            np.argsort(k_major_order(self.features, self._static["K"])), device=self.device)
        blk = lambda j: slice(j * H, (j + 1) * H)  # noqa: E731

        def write(layer, weight, bias):
            layer.weight.copy_(weight)
            layer.bias.copy_(bias[:, 0])

        with torch.no_grad():
            write(made.initial_layer, w["wi"], w["bi"])
            for j, block in enumerate(made.blocks):
                write(block.linear_0, w["wb"][blk(2 * j)], w["bb"][blk(2 * j)])
                write(block.linear_1, w["wb"][blk(2 * j + 1)], w["bb"][blk(2 * j + 1)])
                if self._has_ctx:
                    write(block.context_layer, w["wcb"][blk(j)], w["bcb"][blk(j)])
            write(made.final_layer, w["wf"][inv_order], w["bf"][inv_order])
            if self._has_ctx:
                write(made.context_layer, w["wci"], w["bci"])
        return dist

    def to_made(self, weights=None):
        """Like :meth:`to_dist`, the MixtureOfGaussiansMADE itself."""
        dist = self.to_dist(weights)
        return getattr(dist, "made", dist)
