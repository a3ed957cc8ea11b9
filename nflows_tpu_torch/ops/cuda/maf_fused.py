"""Fused autoregressive-flow inference path (counterpart of
nflows_tpu/ops/pallas/maf_fused.py): extract a MAF, NSF-AR or IAF into
the whole-chain kernel B9 (maf_flow_kernel.py) and serve sample /
log_prob / sample_and_log_prob as one launch each.

``fuse_maf(flow)`` validates the structure: L x [Permutation, AR layer]
over a StandardNormal base, where the AR layer is a
MaskedAffineAutoregressiveTransform (MAF), a
MaskedPiecewiseRationalQuadraticAutoregressiveTransform with linear tails
(NSF-AR), or either wrapped in InverseTransform (IAF), each with a
residual-block relu MADE without dropout or batch norm. Masks are folded
into the weights, the final layer is reordered param-major (with the RQ
width and height rescale folded in), and the result is a :class:`FusedMAF`.

The same extraction serves fused training (maf_train.py) through
``fold_masks`` / ``fold_wh_scale`` / ``return_masks``.

So far only fp32 without context is fused; a conditional flow raises
``ValueError`` here, so ``CompiledFlow`` serves it on the unfused chain.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nflows_tpu_torch.ops.cuda import maf_flow_kernel
from nflows_tpu_torch.ops.cuda._fused_view_common import FusedFlowView
from nflows_tpu_torch.ops.cuda.maf_flow_kernel import MAFLayerStatic

__all__ = ["FusedMAF", "fuse_maf", "can_fuse_maf"]


def can_fuse_maf(flow) -> bool:
    """True if :func:`fuse_maf` accepts this flow."""
    try:
        _extract(flow, torch.float32)
        return True
    except (ValueError, AttributeError):
        return False


def _unwrap(t):
    from nflows_tpu_torch.transforms.base import InverseTransform

    if isinstance(t, InverseTransform):
        return t.transform, True
    return t, False


def _is_relu(fn) -> bool:
    return fn in (F.relu, torch.relu)


def _extract(flow, dtype, fold_masks=True, fold_wh_scale=True,
             allow_wrapped=True, return_masks=False):
    """Re-lay a qualifying AR flow's weights for the kernel, in the JAX
    package's layout. Returns (layer_static, weights, num_blocks, features,
    transformer, spline_kw, context_features[, masks]).

    Serving uses the defaults (masks and the RQ width/height rescale folded
    into the weights). Fused training passes ``fold_masks=False,
    fold_wh_scale=False, return_masks=True``: the trainable weights stay
    pure transposes and permutations of the model's own, the masks come back
    in kernel layout for the trainer's per-step fold, and the kernel applies
    the rescale (``wh_scale``). ``allow_wrapped=False`` rejects
    InverseTransform-wrapped (IAF) layers, whose density direction is a
    fixed point the training kernel does not differentiate.
    """
    from nflows_tpu_torch.distributions.normal import StandardNormal
    from nflows_tpu_torch.nn.made import MADE, MaskedResidualBlock
    from nflows_tpu_torch.transforms.autoregressive import (
        MaskedAffineAutoregressiveTransform,
        MaskedPiecewiseRationalQuadraticAutoregressiveTransform,
    )
    from nflows_tpu_torch.transforms.base import CompositeTransform
    from nflows_tpu_torch.transforms.permutations import Permutation

    ar_classes = (MaskedAffineAutoregressiveTransform,
                  MaskedPiecewiseRationalQuadraticAutoregressiveTransform)

    if not isinstance(flow.distribution, StandardNormal):
        raise ValueError("fused path requires a StandardNormal base")
    t = flow.transform
    if not isinstance(t, CompositeTransform):
        raise ValueError("expected a CompositeTransform chain")
    ts = list(t.transforms)
    if len(ts) % 2 or not ts:
        raise ValueError("expected [permutation, affine-AR] pairs")
    for i in range(0, len(ts), 2):
        if not isinstance(ts[i], Permutation):
            raise ValueError("layer must start with a feature Permutation")
        if type(_unwrap(ts[i + 1])[0]) not in ar_classes:
            raise ValueError(
                "only affine / RQ-spline autoregressive layers are fused")

    layer_static = []
    wis, bis, wbs, bbs, wfs, bfs = [], [], [], [], [], []
    mis, mbs, mfs = [], [], []
    ref_cfg = None
    for i in range(0, len(ts), 2):
        perm = ts[i]
        ar, wrapped = _unwrap(ts[i + 1])
        if perm.dim != 1:
            raise ValueError("layer must start with a feature Permutation")
        if type(ar) is MaskedAffineAutoregressiveTransform:
            transformer = "affine"
            mult = 2
            spline_cfg = None
        else:
            if ar.tails != "linear":
                raise ValueError("fused NSF-AR requires tails='linear'")
            transformer = "rq"
            mult = 3 * ar.num_bins - 1
            spline_cfg = (ar.num_bins, float(ar.tail_bound),
                          float(ar.min_bin_width), float(ar.min_bin_height),
                          float(ar.min_derivative))
        made = ar.autoregressive_net
        if not isinstance(made, MADE) or not made.use_residual_blocks:
            raise ValueError("fused path requires residual-block MADE")
        if not _is_relu(made.activation):
            raise ValueError("fused MADE requires relu activation")
        for blk in made.blocks:
            if not isinstance(blk, MaskedResidualBlock):
                raise ValueError("fused path requires residual MADE blocks")
            if blk.dropout.rate != 0.0:
                raise ValueError("dropout MADE not fused")
            if blk.batch_norm_0 is not None:
                raise ValueError("batch-norm MADE not fused")
            if not _is_relu(blk.activation):
                raise ValueError("fused MADE requires relu activation")
        if made.context_layer is not None:
            raise ValueError("conditional flows are not fused in this port yet")

        D = made.features
        H = made.hidden_features
        cfg = (transformer, mult, D, H, len(made.blocks), spline_cfg, None)
        if ref_cfg is None:
            ref_cfg = cfg
        elif cfg != ref_cfg:
            raise ValueError("layers must be homogeneous to fuse")

        if wrapped and not allow_wrapped:
            raise ValueError(
                "InverseTransform-wrapped (IAF) layers are not supported "
                "here: the density direction is a fixed point")

        p = perm.permutation.cpu().numpy()
        layer_static.append(MAFLayerStatic(
            perm_rows=tuple(int(v) for v in p),
            inv_perm_rows=tuple(int(v) for v in np.argsort(p)),
            wrapped=wrapped,
        ))

        def w_out_in(md):
            # nn.Linear keeps [out, in], which is already the kernel's
            # transposed layout of the JAX package
            w = md.weight.detach().float()
            return w * md.mask if fold_masks else w

        def column(md):
            return md.bias.detach().float()[:, None]

        wis.append(w_out_in(made.initial_layer))                  # [H, D]
        bis.append(column(made.initial_layer))
        if return_masks:
            mis.append(made.initial_layer.mask)
        for blk in made.blocks:
            for lin in (blk.linear_0, blk.linear_1):
                wbs.append(w_out_in(lin))                         # [H, H]
                bbs.append(column(lin))
                if return_masks:
                    mbs.append(lin.mask)
        # final layer [mult*D, H]: the model packs parameters feature-major
        # (row t*mult + j is parameter j of feature t); reorder param-major
        # (row j*D + t) for the kernel. For the RQ transformer also fold the
        # 1/sqrt(hidden) rescale of widths AND heights into the weights,
        # unless the kernel is to apply it (training).
        wf = w_out_in(made.final_layer)
        bf = column(made.final_layer)
        order = torch.as_tensor(
            np.array([t * mult + j for j in range(mult) for t in range(D)]),
            device=wf.device)
        scale = torch.ones(mult * D, dtype=wf.dtype, device=wf.device)
        if transformer == "rq" and fold_wh_scale:
            scale[: 2 * ar.num_bins * D] = float(np.float32(1.0 / np.sqrt(H)))
        wfs.append(wf[order] * scale[:, None])
        bfs.append(bf[order] * scale[:, None])
        if return_masks:
            mfs.append(made.final_layer.mask[order])

    transformer, mult, D, H, num_blocks, spline_cfg, Cf = ref_cfg
    if dtype != torch.float32:
        raise NotImplementedError(
            f"the fused AR kernel runs fp32 weights only so far, not {dtype}")
    if H % 4 or not maf_flow_kernel.tile_rows(1, D, H, mult * D, sms=1):
        raise ValueError(
            f"hidden width {H} does not fit the fused kernel's shared-memory tile")
    weights = dict(wi=torch.cat(wis), bi=torch.cat(bis), wb=torch.cat(wbs),
                   bb=torch.cat(bbs), wf=torch.cat(wfs), bf=torch.cat(bfs))
    spline_kw = None
    if transformer == "rq":
        K, tb, mbw, mbh, md = spline_cfg
        spline_kw = dict(num_bins=K, tail_bound=tb, min_bin_width=mbw,
                         min_bin_height=mbh, min_derivative=md)
    out = (tuple(layer_static), weights, num_blocks, D, transformer, spline_kw, Cf)
    if not return_masks:
        return out
    masks = dict(wi=torch.cat(mis).float(), wb=torch.cat(mbs).float(),
                 wf=torch.cat(mfs).float())
    return out + (masks,)


class FusedMAF(FusedFlowView):
    """B9-backed inference view of an autoregressive flow.

    ``forward``/``inverse`` have the Transform contract; ``log_prob``,
    ``sample`` and ``sample_and_log_prob`` the Distribution contract. On a
    CUDA flow each call is one launch of B9; on a CPU flow it runs B9's
    plain version. Build with :func:`fuse_maf`.
    """

    def __init__(self, flow, dtype=torch.float32):
        (self._static, self._weights, self._num_blocks, self.features,
         self._transformer, self._spline_kw,
         self.context_features) = _extract(flow, dtype)
        self.device = self._weights["wi"].device
        self._packed = (
            maf_flow_kernel.pack_weights(self._weights, self._static, self._num_blocks)
            if self.device.type == "cuda" else None)

    def _run(self, x, inverse):
        return maf_flow_kernel.maf_flow_kernel_cuda(
            x, self._weights, self._static, inverse=inverse,
            num_blocks=self._num_blocks, transformer=self._transformer,
            spline_kw=self._spline_kw, packed=self._packed)


def fuse_maf(flow, dtype=torch.float32) -> FusedMAF:
    """Build the fused inference view of an autoregressive flow.

    ``dtype`` sets the MADE GEMM precision; only fp32 runs so far (the
    JAX package defaults to bf16) and raises ``NotImplementedError`` for
    anything else.
    """
    return FusedMAF(flow, dtype=dtype)
