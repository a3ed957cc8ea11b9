"""Kernel B11: the log-density of a MixtureOfGaussiansMADE / MADEMoG in one
launch (counterpart of nflows_tpu/ops/pallas/mademog_fused.py; source
``csrc/mademog_fused.cu``).

The density is one masked residual MADE pass and a per-feature
mixture-of-Gaussians head (nn/nde/made.py): no chain and no fixed point.
The kernel runs both for a tile of samples: the MADE GEMMs with the masks
folded into the weights, the context projections where the model has a
context, then the head on the K-major parameter layout (log-softmax over
the components, softplus stds plus epsilon, logsumexp over the components,
sum over the features).

Weights come in the layout ``_extract`` gives, which is the JAX package's:
``wi [H, D]``, ``bi [H, 1]``, ``wb [2 nb H, H]`` (out, in), ``bb``,
``wf [3KD, H]`` with K-major rows (row ``(j K + k) D + d`` is parameter j of
component k of feature d; j = logit, mean, unconstrained std), ``bf``, and
for a conditional model ``wci [H, C]``, ``bci``, ``wcb [nb H, C]``, ``bcb``.
:func:`pack_weights` re-lays them for the kernel as in-major [in, out]
matrices, the final layer's outputs zero-padded to a multiple of 4.

Samples are rows: x is [N, D], the context [N, C], the result lp [N].
:func:`mademog_log_prob_plain` computes the same in PyTorch on the same
stacks; a wrapper call with a CPU tensor runs it, a CUDA tensor runs the
kernel or raises. Only fp32 weights are ported so far.

Sampling stays on the module (``MixtureOfGaussiansMADE.sample``: D
sequential MADE passes with categorical and normal draws), as in the JAX
package; ``FusedMADEMoG.sample`` delegates to it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch

from nflows_tpu_torch.ops.cuda import _build
from nflows_tpu_torch.ops.cuda.maf_fused import _is_relu
from nflows_tpu_torch.ops.cuda.nsf_flow_kernel import (
    _KC,
    _OC,
    MAX_SHARED_MEMORY,
    _round4,
)
from nflows_tpu_torch.ops.splines import rational_quadratic as rq_ref
from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = ["FusedMADEMoG", "fuse_mademog", "can_fuse_mademog", "mademog_log_prob_cuda",
           "mademog_log_prob_plain", "pack_weights", "shared_memory_bytes",
           "launch_count"]

launch_count = 0  # B11 launches since the last reset

ROWS = 32                # samples a block holds
WEIGHT_KEYS = ("wi", "bi", "wb", "bb", "wf", "bf")
CONTEXT_KEYS = ("wci", "bci", "wcb", "bcb")
MASKED_KEYS = ("wi", "wb", "wf")


def can_fuse_mademog(dist) -> bool:
    """True if :func:`fuse_mademog` accepts this model."""
    try:
        _validate(dist)
        return True
    except (ValueError, AttributeError):
        return False


def _validate(dist):
    """The model's MixtureOfGaussiansMADE, if the kernel takes it; raises
    ValueError with the reason otherwise."""
    from nflows_tpu_torch.distributions.mixture import MADEMoG
    from nflows_tpu_torch.nn.made import MaskedResidualBlock
    from nflows_tpu_torch.nn.nde.made import MixtureOfGaussiansMADE

    made = dist.made if isinstance(dist, MADEMoG) else dist
    if not isinstance(made, MixtureOfGaussiansMADE):
        raise ValueError("expected a MixtureOfGaussiansMADE (or MADEMoG)")
    if not made.use_residual_blocks:
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
    return made


def k_major_order(D: int, K: int) -> np.ndarray:
    """Kernel row -> model column of the final layer: the model packs
    column ``d 3K + k 3 + j``, the kernel row ``(j K + k) D + d``, so each
    parameter j is K stacked [D]-blocks."""
    return np.array([d * 3 * K + k * 3 + j
                     for j in range(3) for k in range(K) for d in range(D)])


def _extract(dist, dtype, fold_masks=True, return_masks=False):
    """Re-lay a qualifying model's weights for the kernel, in the JAX
    package's layout. Returns (weights, static, context_features[, masks]).

    Serving uses the defaults (masks folded into the weights). The fused
    trainer passes ``fold_masks=False, return_masks=True``: the trainable
    weights stay pure permutations of the model's own, and the masks come
    back in kernel layout for the trainer's per-step fold."""
    made = _validate(dist)
    D, K, H = made.features, made.num_mixture_components, made.hidden_features
    Cf = None if made.context_layer is None else made.context_layer.in_features
    if dtype != torch.float32:
        raise NotImplementedError(
            f"the fused MADEMoG kernel runs fp32 weights only so far, not {dtype}")
    if H % 4 or shared_memory_bytes(D, Cf or 0, K, H) > MAX_SHARED_MEMORY:
        raise ValueError(
            f"hidden width {H} does not fit the fused kernel's shared-memory tile")

    def w_out_in(md):
        # nn.Linear keeps [out, in], the kernel layout of the JAX package
        w = md.weight.detach().float()
        return w * md.mask if fold_masks else w

    def column(md):
        return md.bias.detach().float()[:, None]

    layers = [lin for blk in made.blocks for lin in (blk.linear_0, blk.linear_1)]
    order = torch.as_tensor(k_major_order(D, K), device=made.final_layer.weight.device)
    weights = dict(
        wi=w_out_in(made.initial_layer), bi=column(made.initial_layer),
        wb=torch.cat([w_out_in(lin) for lin in layers]),
        bb=torch.cat([column(lin) for lin in layers]),
        wf=w_out_in(made.final_layer)[order], bf=column(made.final_layer)[order])
    if Cf is not None:
        weights.update(
            wci=made.context_layer.weight.detach().float(), bci=column(made.context_layer),
            wcb=torch.cat([blk.context_layer.weight.detach().float() for blk in made.blocks]),
            bcb=torch.cat([column(blk.context_layer) for blk in made.blocks]))
    static = dict(D=D, K=K, H=H, num_blocks=len(made.blocks), epsilon=float(made.epsilon))
    if not return_masks:
        return weights, static, Cf
    masks = dict(wi=made.initial_layer.mask.float(),
                 wb=torch.cat([lin.mask.float() for lin in layers]),
                 wf=made.final_layer.mask.float()[order])
    return weights, static, Cf, masks


# -- plain version ---------------------------------------------------------------


def _made_params(x, weights, num_blocks, context):
    """The residual MADE on the stacks: x [N, D] -> P [N, 3KD], K-major
    columns. Context enters additively: relu(Wci c + bci) after the initial
    layer, Wcb_j c + bcb_j after each block's first linear."""
    H = weights["bi"].shape[0]
    h = x @ weights["wi"].T + weights["bi"][:, 0]
    if context is not None:
        h = h + torch.relu(context @ weights["wci"].T + weights["bci"][:, 0])
    wb, bb = weights["wb"], weights["bb"][:, 0]
    for j in range(num_blocks):
        r0, r1 = slice(2 * j * H, (2 * j + 1) * H), slice((2 * j + 1) * H, (2 * j + 2) * H)
        t = torch.relu(h) @ wb[r0].T + bb[r0]
        if context is not None:
            rc = slice(j * H, (j + 1) * H)
            t = t + (context @ weights["wcb"][rc].T + weights["bcb"][rc, 0])
        h = h + torch.relu(t) @ wb[r1].T + bb[r1]
    return h @ weights["wf"].T + weights["bf"][:, 0]


def head_terms(x, P, K, epsilon):
    """The mixture head's terms on K-major parameters P [N, 3KD], each
    [N, K, D]: the unconstrained stds u, log_coef = log_softmax(logits), the
    stds s = softplus(u) + epsilon, z = (x - mu) / s and the component
    log-densities c. The log-softmax subtracts its max, as the kernel does."""
    n, D = x.shape
    p = P.reshape(n, 3, K, D)
    logits, means, u = p[:, 0], p[:, 1], p[:, 2]
    stds = rq_ref._softplus(u) + epsilon
    m = logits.max(dim=1, keepdim=True).values
    log_coef = (logits - m) - torch.log(torch.exp(logits - m).sum(dim=1, keepdim=True))
    z = (x[:, None] - means) / stds
    comp = log_coef - 0.5 * (math.log(2 * math.pi) + 2 * torch.log(stds) + z * z)
    return u, log_coef, stds, z, comp


def mog_head(x, P, K, epsilon):
    """lp [N]: the logsumexp of the component log-densities over the
    components, its max subtracted, summed over the features."""
    comp = head_terms(x, P, K, epsilon)[-1]
    cm = comp.max(dim=1).values
    return (cm + torch.log(torch.exp(comp - cm[:, None]).sum(dim=1))).sum(dim=1)


def mademog_log_prob_plain(x: torch.Tensor, weights: Dict[str, torch.Tensor], static: dict,
                           context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B11 in plain PyTorch on the stacks: x [N, D] (and the context
    [N, C]) -> lp [N], in x's dtype. Differentiable."""
    P = _made_params(x, weights, static["num_blocks"], context)
    return mog_head(x, P, static["K"], static["epsilon"])


# -- the kernel -------------------------------------------------------------------


def shared_memory_bytes(D: int, C: int, K: int, H: int) -> int:
    """Dynamic shared memory of one block (csrc/mademog_fused.cu: smem_bytes)."""
    TB = max(H, _round4(3 * K * D))
    return 4 * (2 * _KC * _OC + ROWS * (H + TB + 2 * D + C))


def pack_weights(weights: Dict[str, torch.Tensor], static: dict,
                 out: Dict[str, torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Kernel layout of the (mask-folded) stacks: in-major [in, out] fp32
    matrices on the weights' device, the final layer's outputs padded to a
    multiple of 4, the biases flat. With ``out``, an earlier result for the
    same model, the tensors are refilled in place: the trainer re-packs this
    way each step."""
    H, D, nb = static["H"], static["D"], static["num_blocks"]
    P = weights["wf"].shape[0]
    Pp = _round4(P)
    if out is None:
        f32 = dict(dtype=torch.float32, device=weights["wi"].device)
        out = dict(wi=torch.empty(D, H, **f32), bi=torch.empty(H, **f32),
                   wb=torch.empty(2 * nb, H, H, **f32), bb=torch.empty(2 * nb * H, **f32),
                   wf=torch.zeros(H, Pp, **f32), bf=torch.zeros(Pp, **f32))
        if "wci" in weights:
            C = weights["wci"].shape[1]
            out.update(wci=torch.empty(C, H, **f32), bci=torch.empty(H, **f32),
                       wcb=torch.empty(nb, C, H, **f32), bcb=torch.empty(nb * H, **f32))
    with torch.no_grad():
        out["wi"].copy_(weights["wi"].T)
        out["wb"].copy_(weights["wb"].view(2 * nb, H, H).transpose(1, 2))
        out["wf"][:, :P].copy_(weights["wf"].T)
        out["bf"][:P].copy_(weights["bf"][:, 0])
        for k in ("bi", "bb"):
            out[k].copy_(weights[k][:, 0])
        if "wci" in weights:
            C = weights["wci"].shape[1]
            out["wci"].copy_(weights["wci"].T)
            out["wcb"].copy_(weights["wcb"].view(nb, H, C).transpose(1, 2))
            for k in ("bci", "bcb"):
                out[k].copy_(weights[k][:, 0])
    return out


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mademog_log_prob_launch.argtypes = (
        [p, p, p, ctypes.c_int64] + [i] * 7 + [f] + [p] * 10 + [p])
    lib.mademog_log_prob_launch.restype = i


def check_inputs(what, x, context, static, context_features):
    """Shapes and types the kernels take: x [N, D] and, for a conditional
    model, context [N, C], contiguous float32 on one device."""
    D = static["D"]
    if x.ndim != 2 or x.shape[1] != D or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous [N, {D}] float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if (context is None) != (context_features is None):
        raise ValueError(f"{what}: context presence must match the weights' context stacks")
    if context is not None and (
            tuple(context.shape) != (x.shape[0], context_features)
            or context.dtype != torch.float32 or not context.is_contiguous()
            or context.device != x.device):
        raise ValueError(f"{what}: context must be a contiguous [{x.shape[0]}, "
                         f"{context_features}] float32 tensor on {x.device}, got "
                         f"{tuple(context.shape)} {context.dtype} on {context.device}")


def check_packed(what, packed, static, context_features, device):
    """Shapes and types of :func:`pack_weights`' tensors for this model."""
    D, K, H, nb = static["D"], static["K"], static["H"], static["num_blocks"]
    Pp = _round4(3 * K * D)
    shapes = dict(wi=(D, H), bi=(H,), wb=(2 * nb, H, H), bb=(2 * nb * H,), wf=(H, Pp),
                  bf=(Pp,))
    if context_features is not None:
        C = context_features
        shapes.update(wci=(C, H), bci=(H,), wcb=(nb, C, H), bcb=(nb * H,))
    for name, shape in shapes.items():
        t = packed[name]
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: packed {name} must be a contiguous {shape} float32 "
                             f"tensor on {device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")


def data_ptr(t):
    """A tensor's address for the C entry points; None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def mademog_log_prob_cuda(x: torch.Tensor, weights: Dict[str, torch.Tensor], static: dict,
                          context: Optional[torch.Tensor] = None,
                          packed: Dict[str, torch.Tensor] = None) -> torch.Tensor:
    """B11: x [N, D] (and the context [N, C]) -> lp [N].

    ``weights`` are the mask-folded stacks of :func:`_extract`; ``packed``
    is :func:`pack_weights` of them, built here when not given (callers that
    launch repeatedly keep it)."""
    global launch_count
    if x.device.type == "cpu":
        return mademog_log_prob_plain(x, weights, static, context)
    what = "mademog_log_prob_cuda"
    Cf = weights["wci"].shape[1] if "wci" in weights else None
    check_inputs(what, x, context, static, Cf)
    if packed is None:
        packed = pack_weights(weights, static)
    check_packed(what, packed, static, Cf, x.device)
    D, K, H, nb = static["D"], static["K"], static["H"], static["num_blocks"]
    if H % 4 or shared_memory_bytes(D, Cf or 0, K, H) > MAX_SHARED_MEMORY:
        raise ValueError(f"{what}: hidden width {H} does not fit the kernel's "
                         "shared-memory tile")
    n = x.shape[0]
    lib = _build.load_library("mademog_fused", _declare)
    lp = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.mademog_log_prob_launch(
            x.data_ptr(), data_ptr(context), lp.data_ptr(), n, D, Cf or 0, K, H, 3 * K * D,
            _round4(3 * K * D), nb, static["epsilon"],
            *(data_ptr(packed.get(k)) for k in WEIGHT_KEYS + CONTEXT_KEYS), stream)
    launch_count += 1
    _build.check(code, "mademog_log_prob_launch")
    return lp


# -- the serving view --------------------------------------------------------------


class FusedMADEMoG:
    """B11-backed log_prob of a MixtureOfGaussiansMADE / MADEMoG: one launch
    a call on a CUDA model, the plain version on a CPU one. Sampling
    delegates to the module's sequential sampler. Build with
    :func:`fuse_mademog`."""

    def __init__(self, dist, dtype=torch.float32):
        self._weights, self._static, self.context_features = _extract(dist, dtype)
        self._dist = dist
        self.features = self._static["D"]
        self.device = self._weights["wi"].device
        self._packed = (pack_weights(self._weights, self._static)
                        if self.device.type == "cuda" else None)

    def log_prob(self, inputs, context=None):
        n = inputs.shape[0]
        if inputs.ndim != 2 or inputs.shape[1] != self.features:
            raise ValueError(
                f"expected [N, {self.features}] inputs, got {tuple(inputs.shape)}")
        if (context is None) != (self.context_features is None):
            raise ValueError("context presence must match the MADE's context_features")
        if context is not None and context.shape[0] != n:
            raise ValueError(f"context has {context.shape[0]} rows but inputs have {n}")
        if context is not None:
            context = context.float().contiguous()
        return mademog_log_prob_cuda(inputs.float().contiguous(), self._weights,
                                     self._static, context=context, packed=self._packed)

    def sample(self, generator, num_samples, context=None):
        made = getattr(self._dist, "made", self._dist)
        return made.sample(generator, num_samples, context=context)

    def sample_and_log_prob(self, generator, num_samples, context=None):
        """Samples from the sequential sampler and their log_prob from B11."""
        samples = self.sample(generator, num_samples, context=context)
        if context is None:
            return samples, self.log_prob(samples)
        flat = shapeutils.merge_leading_dims(samples, num_dims=2)
        lp = self.log_prob(flat, shapeutils.repeat_rows(context, num_reps=num_samples))
        return samples, shapeutils.split_leading_dim(lp, [-1, num_samples])


def fuse_mademog(dist, dtype=torch.float32) -> FusedMADEMoG:
    """Build the fused log_prob view of a MADEMoG / MixtureOfGaussiansMADE.

    ``dtype`` sets the MADE GEMM precision; only fp32 runs so far (the JAX
    package defaults to bf16) and raises ``NotImplementedError`` for
    anything else."""
    return FusedMADEMoG(dist, dtype=dtype)
