"""Fused NSF inference path (counterpart of
nflows_tpu/ops/pallas/nsf_fused.py): extract a tabular RQ-NSF flow into
the whole-chain kernel B2 (nsf_flow_kernel.py) and serve sample /
log_prob / sample_and_log_prob as one launch each.

``fuse_nsf(flow)`` validates the structure (homogeneous
[Permutation?, RQ coupling(ResidualNet)] layers, tails='linear', relu, no
dropout or batch norm, StandardNormal base, no context) and re-lays the
weights out as the JAX package's ``_extract`` does: transposed, final
layer rows permuted K-major, softmax 1/sqrt(hidden) folded in.

This slice fuses the rq family in fp32 without context; other families,
conditional flows and bf16 weights are still to port. A flow that does not
qualify raises ``ValueError``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nflows_tpu_torch.ops.cuda import nsf_flow_kernel
from nflows_tpu_torch.ops.cuda._fused_view_common import FusedFlowView

__all__ = ["NSFLayerIndices", "FusedNSF", "fuse_nsf", "can_fuse_nsf"]


class NSFLayerIndices(NamedTuple):
    """Static per-layer row-index lists (host ints), all in x-row space.

    forward layer l:  identity = x[id_rows], transform = x[tr_rows],
                      x_next = concat(identity, spline_fwd)[merge_fwd]
    inverse layer l:  identity = y[id_idx], transform = y[tr_idx],
                      x = concat(identity, spline_inv)[merge_inv]
    """

    id_rows: Tuple[int, ...]     # perm composed with mask identity split
    tr_rows: Tuple[int, ...]     # perm composed with mask transform split
    merge_fwd: Tuple[int, ...]   # argsort(concat(id_idx, tr_idx))
    id_idx: Tuple[int, ...]      # mask identity split (coupling coords)
    tr_idx: Tuple[int, ...]
    merge_inv: Tuple[int, ...]   # merge then inverse permutation, composed


def _layer_groups(transform):
    """(permutation-or-None, coupling) pairs of the flow's transform."""
    from nflows_tpu_torch.transforms.base import CompositeTransform
    from nflows_tpu_torch.transforms.coupling import CouplingTransform
    from nflows_tpu_torch.transforms.permutations import Permutation

    if not isinstance(transform, CompositeTransform):
        raise ValueError(f"unsupported transform type {type(transform).__name__}")
    ts = list(transform.transforms)
    pairs = []
    i = 0
    while i < len(ts):
        t = ts[i]
        if isinstance(t, Permutation):
            if i + 1 >= len(ts):
                raise ValueError("trailing permutation with no coupling")
            pairs.append((t, ts[i + 1]))
            i += 2
        elif isinstance(t, CouplingTransform):
            pairs.append((None, t))
            i += 1
        else:
            raise ValueError(f"unsupported transform in chain: {type(t).__name__}")
    return pairs


def can_fuse_nsf(flow) -> bool:
    """True if :func:`fuse_nsf` accepts this flow."""
    try:
        _extract(flow, torch.float32)
        return True
    except (ValueError, AttributeError):
        return False


def _extract(flow, dtype, fold_wh_scale=True):
    """Re-lay a qualifying flow's weights for B2, in the JAX package's
    layout. Returns (layer_indices, weights, static, features,
    context_features).

    ``fold_wh_scale=False`` leaves the softmax 1/sqrt(hidden) rescale out of
    the final layer's width and height rows; the kernel then applies it
    (``wh_scale``). Every weight is then a transpose or permutation of the
    model's own, which is what the fused trainer optimises."""
    from nflows_tpu_torch.distributions.normal import StandardNormal
    from nflows_tpu_torch.nn.nets.resnet import ResidualNet
    from nflows_tpu_torch.transforms.coupling import (
        PiecewiseRationalQuadraticCouplingTransform,
    )
    from nflows_tpu_torch.transforms.permutations import Permutation

    if not isinstance(flow.distribution, StandardNormal):
        raise ValueError("fused path requires a StandardNormal base")
    pairs = _layer_groups(flow.transform)
    if not pairs:
        raise ValueError("empty transform chain")

    layer_indices = []
    w0s, b0s, wbs, bbs, wfs, bfs = [], [], [], [], [], []
    ref_cfg = None
    for perm, cpl in pairs:
        if perm is not None and (not isinstance(perm, Permutation) or perm.dim != 1):
            raise ValueError("layer must start with a feature Permutation")
        if not isinstance(cpl, PiecewiseRationalQuadraticCouplingTransform):
            raise ValueError("only RQ-spline couplings are fused in this port so far")
        if cpl.tails != "linear":
            raise ValueError("fused path requires tails='linear'")
        net = cpl.transform_net
        if not isinstance(net, ResidualNet):
            raise ValueError("conditioner must be a ResidualNet")
        if net.context_features is not None:
            raise ValueError("conditional flows are not fused in this port yet")
        for blk in net.blocks:
            if blk.batch_norm_0 is not None or blk.dropout.rate != 0.0:
                raise ValueError("batch-norm/dropout conditioners not fused")
            if blk.activation not in (F.relu, torch.relu):
                raise ValueError("fused conditioner requires relu activation")

        T = cpl.num_transform_features
        Tid = cpl.num_identity_features
        H = net.hidden_features
        K = cpl.num_bins
        M = 3 * K - 1
        cfg = (K, T, Tid, H, len(net.blocks), cpl.tail_bound, cpl.min_bin_width,
               cpl.min_bin_height, cpl.min_derivative)
        if ref_cfg is None:
            ref_cfg = cfg
        elif cfg != ref_cfg:
            raise ValueError("layers must be homogeneous to fuse")

        p = (np.arange(cpl.features) if perm is None
             else perm.permutation.cpu().numpy())
        id_idx = cpl.identity_features.cpu().numpy()
        tr_idx = cpl.transform_features.cpu().numpy()
        merge_fwd = np.argsort(np.concatenate([id_idx, tr_idx]))
        merge_inv = merge_fwd[np.argsort(p)]
        layer_indices.append(NSFLayerIndices(
            id_rows=tuple(int(i) for i in p[id_idx]),
            tr_rows=tuple(int(i) for i in p[tr_idx]),
            merge_fwd=tuple(int(i) for i in merge_fwd),
            id_idx=tuple(int(i) for i in id_idx),
            tr_idx=tuple(int(i) for i in tr_idx),
            merge_inv=tuple(int(i) for i in merge_inv),
        ))

        # nn.Linear keeps [out, in], which is already the kernel's
        # transposed [H, in] layout of the JAX package
        w_init = net.initial_layer.weight.detach().float()
        w0s.append(w_init[:, :Tid])
        b0s.append(net.initial_layer.bias.detach().float()[:, None])
        linears = [lin for blk in net.blocks for lin in (blk.linear_0, blk.linear_1)]
        wbs.append(torch.stack([lin.weight.detach().float() for lin in linears]))
        bbs.append(torch.stack([lin.bias.detach().float()[:, None] for lin in linears]))
        # final layer: rows K-major (new row j*T+t = old t*M+j) and, when
        # folding, the softmax 1/sqrt(H) on the width/height rows
        wf = net.final_layer.weight.detach().float()
        order = torch.tensor([t * M + j for j in range(M) for t in range(T)],
                             device=wf.device)
        wf, bf = wf[order], net.final_layer.bias.detach().float()[order]
        if fold_wh_scale:
            scale = torch.ones(T * M, dtype=torch.float32, device=wf.device)
            scale[:2 * K * T] = float(np.float32(1.0 / np.sqrt(H)))
            wf, bf = wf * scale[:, None], bf * scale
        wfs.append(wf)
        bfs.append(bf[:, None])

    (K, T, Tid, H, num_blocks, tail_bound, mbw, mbh, md) = ref_cfg
    if dtype != torch.float32:
        raise NotImplementedError(
            f"the fused NSF kernel runs fp32 weights only so far, not {dtype}")
    smem = nsf_flow_kernel.shared_memory_bytes(32, Tid + T, H, Tid, T, T * (3 * K - 1))
    if H % 4 or smem > nsf_flow_kernel.MAX_SHARED_MEMORY:
        raise ValueError(
            f"hidden width {H} does not fit the fused kernel's shared-memory tile")
    weights = dict(w0=torch.stack(w0s), b0=torch.stack(b0s),
                   wb=torch.stack(wbs), bb=torch.stack(bbs),
                   wf=torch.stack(wfs), bf=torch.stack(bfs))
    static = dict(num_bins=K, num_blocks=num_blocks, tail_bound=float(tail_bound),
                  min_bin_width=float(mbw), min_bin_height=float(mbh),
                  min_derivative=float(md))
    return tuple(layer_indices), weights, static, Tid + T, None


class FusedNSF(FusedFlowView):
    """B2-backed inference view of a tabular RQ coupling flow.

    ``forward``/``inverse`` have the Transform contract; ``log_prob``,
    ``sample`` and ``sample_and_log_prob`` the Distribution contract. On a
    CUDA flow each call is one launch of B2; on a CPU flow it runs B2's
    plain version. Build with :func:`fuse_nsf`.
    """

    def __init__(self, flow, dtype=torch.float32):
        (self._indices, self._weights, self._static,
         self.features, self.context_features) = _extract(flow, dtype)
        self.device = self._weights["w0"].device
        self._packed = (nsf_flow_kernel.pack_weights(self._weights, self._indices)
                        if self.device.type == "cuda" else None)

    def _run(self, x, inverse):
        return nsf_flow_kernel.nsf_flow_kernel_cuda(
            x, self._weights, self._indices, inverse=inverse,
            packed=self._packed, **self._static)


def fuse_nsf(flow, dtype=torch.float32) -> FusedNSF:
    """Build the fused inference view of ``flow``.

    ``dtype`` sets the conditioner GEMM precision; this slice runs fp32
    only (the JAX package defaults to bf16) and raises
    ``NotImplementedError`` for anything else.
    """
    return FusedNSF(flow, dtype=dtype)
