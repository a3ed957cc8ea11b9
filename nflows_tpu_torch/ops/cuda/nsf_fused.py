"""Fused inference path of tabular coupling flows (counterpart of
nflows_tpu/ops/pallas/nsf_fused.py): extract a coupling chain into the
whole-chain kernel B2 (nsf_flow_kernel.py) and serve sample / log_prob /
sample_and_log_prob as one launch each.

``fuse_nsf(flow)`` validates the structure (homogeneous
[Permutation?, coupling(ResidualNet)] layers of one of the seven families
B2 has a stage for: the rq, lrs, linear, quadratic and cubic splines with
tails='linear', and the affine coupling with the DEFAULT or GENERAL scale
activation, or the additive one; relu, no dropout or batch norm, no
unconditional transform of the identity half, StandardNormal base, with or
without a context) and re-lays the weights out
as the JAX package's ``_extract`` does: transposed, the final layer's rows
permuted K-major for the splines (the affine parameters are already
param-major), each family's softmax 1/sqrt(hidden) folded in. A
conditioner with a context adds three stacks: the initial layer's context
columns ``wc0`` [L, H, C] and each block's GLU projection ``wcb``
[L, num_blocks, H, C], ``bcb`` [L, num_blocks, H, 1]. The flow's
``embedding_net`` runs outside the kernel (``_fused_view_common``).

``dtype`` is the matrices' type: fp32 (the default here) or bf16 (the JAX
package's default), cast after the fold as there; the biases stay fp32. A
flow that does not qualify raises ``ValueError``; ``CompiledFlow`` then
serves it on the unfused chain.
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


def _family(cpl):
    """(family, scale activation) of a coupling, as the JAX ``_extract``
    names them; raises for a coupling B2 has no stage for."""
    from nflows_tpu_torch.transforms import coupling as c

    families = ((c.PiecewiseRationalQuadraticCouplingTransform, "rq"),
                (c.PiecewiseLinearRationalCouplingTransform, "lrs"),
                (c.PiecewiseLinearCouplingTransform, "linear"),
                (c.PiecewiseQuadraticCouplingTransform, "quadratic"),
                (c.PiecewiseCubicCouplingTransform, "cubic"),
                (c.AdditiveCouplingTransform, "additive"))  # before Affine, its base
    for cls, family in families:
        if isinstance(cpl, cls):
            return family, ("none" if family == "additive" else None)
    if isinstance(cpl, c.AffineCouplingTransform):
        if cpl.scale_activation is c._default_scale_activation:
            return "affine", "default"
        if cpl.scale_activation is c._general_scale_activation:
            return "affine", "general"
        raise ValueError("only the DEFAULT/GENERAL scale activations are fused")
    raise ValueError(
        f"{type(cpl).__name__} is not fused: only spline (rq/lrs/linear/quadratic/"
        "cubic) and affine/additive couplings are")


def _extract(flow, dtype, fold_wh_scale=True):
    """Re-lay a qualifying flow's weights for B2, in the JAX package's
    layout. Returns (layer_indices, weights, static, features,
    context_features).

    ``fold_wh_scale=False`` leaves the softmax 1/sqrt(hidden) rescale out of
    the final layer's rows; the kernel then applies it (``wh_scale``). Every
    weight is then a transpose or permutation of the model's own, which is
    what the fused trainer optimises."""
    from nflows_tpu_torch.distributions.normal import StandardNormal
    from nflows_tpu_torch.nn.nets.resnet import ResidualNet
    from nflows_tpu_torch.transforms.permutations import Permutation

    if not isinstance(flow.distribution, StandardNormal):
        raise ValueError("fused path requires a StandardNormal base")
    pairs = _layer_groups(flow.transform)
    if not pairs:
        raise ValueError("empty transform chain")

    layer_indices = []
    w0s, b0s, wbs, bbs, wfs, bfs = [], [], [], [], [], []
    wc0s, wcbs, bcbs = [], [], []
    ref_cfg = None
    for perm, cpl in pairs:
        if perm is not None and (not isinstance(perm, Permutation) or perm.dim != 1):
            raise ValueError("layer must start with a feature Permutation")
        spline, scale_act = _family(cpl)
        if spline not in ("affine", "additive") and cpl.tails != "linear":
            raise ValueError("fused path requires tails='linear'")
        # B2 has no stage for a map of the identity half: fusing would drop it
        if cpl.unconditional_transform is not None:
            raise ValueError("unconditional_transform not supported")
        net = cpl.transform_net
        if not isinstance(net, ResidualNet):
            raise ValueError("conditioner must be a ResidualNet")
        for blk in net.blocks:
            if blk.batch_norm_0 is not None or blk.dropout.rate != 0.0:
                raise ValueError("batch-norm/dropout conditioners not fused")
            if blk.activation not in (F.relu, torch.relu):
                raise ValueError("fused conditioner requires relu activation")

        T = cpl.num_transform_features
        Tid = cpl.num_identity_features
        H = net.hidden_features
        K = 0 if spline in ("affine", "additive") else cpl.num_bins
        M = nsf_flow_kernel.params_per_feature(spline, K)
        spline_cfg = tuple(getattr(cpl, name, None) for name in (
            "tail_bound", "min_bin_width", "min_bin_height", "min_derivative", "min_lambda"))
        cfg = (spline, scale_act, K, T, Tid, H, len(net.blocks)) + spline_cfg + (
            net.context_features,)
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
        # transposed [H, in] layout of the JAX package; the initial layer runs
        # on [inputs || context], so its columns past Tid are the context's
        w_init = net.initial_layer.weight.detach().float()
        w0s.append(w_init[:, :Tid])
        b0s.append(net.initial_layer.bias.detach().float()[:, None])
        linears = [lin for blk in net.blocks for lin in (blk.linear_0, blk.linear_1)]
        wbs.append(torch.stack([lin.weight.detach().float() for lin in linears]))
        bbs.append(torch.stack([lin.bias.detach().float()[:, None] for lin in linears]))
        if net.context_features is not None:
            wc0s.append(w_init[:, Tid:])
            wcbs.append(torch.stack([blk.context_layer.weight.detach().float()
                                     for blk in net.blocks]))
            bcbs.append(torch.stack([blk.context_layer.bias.detach().float()[:, None]
                                     for blk in net.blocks]))
        # final layer: spline rows K-major (new row j*T+t = old t*M+j); the
        # affine parameters are already param-major ([shift(T), scale(T)],
        # coupling.py:178-181). When folding, each family's softmax
        # 1/sqrt(H) goes on its first rows: rq, lrs and cubic rescale widths
        # and heights, quadratic all its parameters (its _softmax_rescale
        # covers both groups), linear, affine and additive nothing
        wf = net.final_layer.weight.detach().float()
        bf = net.final_layer.bias.detach().float()
        if spline not in ("affine", "additive"):
            order = torch.tensor([t * M + j for j in range(M) for t in range(T)],
                                 device=wf.device)
            wf, bf = wf[order], bf[order]
        n_scaled = _scaled_rows(spline, K, T)
        if fold_wh_scale and n_scaled:
            scale = torch.ones(T * M, dtype=torch.float32, device=wf.device)
            scale[:n_scaled] = float(np.float32(1.0 / np.sqrt(H)))
            wf, bf = wf * scale[:, None], bf * scale
        wfs.append(wf)
        bfs.append(bf[:, None])

    (spline, scale_act, K, T, Tid, H, num_blocks, tail_bound, mbw, mbh, md, ml,
     context_features) = ref_cfg
    if dtype not in nsf_flow_kernel.WEIGHT_DTYPES:
        raise ValueError(f"the fused NSF kernel takes float32 or bfloat16 weights, not {dtype}")
    TM = T * nsf_flow_kernel.params_per_feature(spline, K)
    smem = nsf_flow_kernel.shared_memory_bytes(32, Tid + T, H, Tid, T, TM,
                                               context_features or 0, dtype)
    if H % nsf_flow_kernel._out_align(dtype) or smem > nsf_flow_kernel.MAX_SHARED_MEMORY:
        raise ValueError(
            f"hidden width {H} does not fit the fused kernel's shared-memory tile")
    # the matrices in dtype, after the fold; the biases fp32
    weights = dict(w0=torch.stack(w0s).to(dtype), b0=torch.stack(b0s),
                   wb=torch.stack(wbs).to(dtype), bb=torch.stack(bbs),
                   wf=torch.stack(wfs).to(dtype), bf=torch.stack(bfs))
    if context_features is not None:
        weights.update(wc0=torch.stack(wc0s).to(dtype), wcb=torch.stack(wcbs).to(dtype),
                       bcb=torch.stack(bcbs))
    # the static dicts of the JAX package's _extract, key for key
    if spline in ("affine", "additive"):
        static = dict(num_blocks=num_blocks, spline=spline, scale_act=scale_act)
    elif spline == "linear":
        static = dict(num_bins=K, num_blocks=num_blocks, spline=spline,
                      tail_bound=float(tail_bound))
    elif spline in ("quadratic", "cubic"):
        static = dict(num_bins=K, num_blocks=num_blocks, spline=spline,
                      tail_bound=float(tail_bound), min_bin_width=float(mbw),
                      min_bin_height=float(mbh))
    else:
        static = dict(num_bins=K, num_blocks=num_blocks, tail_bound=float(tail_bound),
                      min_bin_width=float(mbw), min_bin_height=float(mbh),
                      min_derivative=float(md), spline=spline,
                      min_lambda=None if ml is None else float(ml))
    return tuple(layer_indices), weights, static, Tid + T, context_features


def _scaled_rows(spline, num_bins, T):
    """Rows of a layer's K-major parameters that carry the softmax
    1/sqrt(hidden): min(2K, M) T, as the kernels scale them (2KT for rq,
    lrs and cubic, all (2K-1)T for quadratic), none for linear, affine and
    additive."""
    if spline not in nsf_flow_kernel.RESCALED_FAMILIES:
        return 0
    return T * min(2 * num_bins, nsf_flow_kernel.params_per_feature(spline, num_bins))


class FusedNSF(FusedFlowView):
    """B2-backed inference view of a tabular coupling flow.

    ``forward``/``inverse`` have the Transform contract; ``log_prob``,
    ``sample`` and ``sample_and_log_prob`` the Distribution contract. On a
    CUDA flow each call is one launch of B2; on a CPU flow it runs B2's
    plain version. A conditional flow takes a context in every call: its
    embedding net runs first, outside the kernel, and the embedded context
    enters each conditioner in the kernel. Build with :func:`fuse_nsf`.
    """

    def __init__(self, flow, dtype=torch.float32):
        (self._indices, self._weights, self._static,
         self.features, self.context_features) = _extract(flow, dtype)
        self._embedding_net = getattr(flow, "embedding_net", None)
        self.device = self._weights["w0"].device
        self._packed = None
        if self.device.type == "cuda":
            # both routes' layouts where the shape takes the wgmma route: the
            # route B2 takes, and the other one for a caller that forces it
            # (gemm=)
            self._packed = nsf_flow_kernel.pack_weights(self._weights, self._indices)
            if nsf_flow_kernel.weights_route(self._weights, self._indices) == "wgmma":
                self._packed["wgmma"] = nsf_flow_kernel.pack_weights_wgmma(self._weights,
                                                                           self._indices)

    def _run(self, x, inverse, context=None):
        return nsf_flow_kernel.nsf_flow_kernel_cuda(
            x, self._weights, self._indices, inverse=inverse,
            packed=self._packed, context=context, **self._static)


def fuse_nsf(flow, dtype=torch.float32) -> FusedNSF:
    """Build the fused inference view of ``flow``.

    ``dtype`` sets the conditioner GEMM precision: torch.float32 (the
    default here) or torch.bfloat16, the JAX package's default, where each
    GEMM takes bf16 operands and sums in fp32 (kernel
    ``csrc/nsf_flow_wgmma_bf16.cu``, or ``csrc/nsf_flow_kernel_bf16.cu`` on
    the widths the tensor-core route does not take). Inputs and results
    are fp32 either way."""
    return FusedNSF(flow, dtype=dtype)
