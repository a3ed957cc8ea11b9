"""Kernel B11: the log-density of a MixtureOfGaussiansMADE / MADEMoG in one
launch (counterpart of nflows_tpu/ops/pallas/mademog_fused.py; sources
``csrc/mademog_wgmma.cu``, ``csrc/mademog_wgmma_bf16.cu`` and
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
matrices, the final layer's outputs zero-padded to a multiple of 4 (of 8
with bf16 weights, which a 16-byte copy of them needs).

Samples are rows: x is [N, D], the context [N, C], the result lp [N].
:func:`mademog_log_prob_plain` computes the same in PyTorch on the same
stacks; a wrapper call with a CPU tensor runs it, a CUDA tensor runs the
kernel or raises. The weights are fp32 or bf16 (``fuse_mademog(dtype=
torch.bfloat16)``, the JAX package's default): with bf16, the matrices are
bf16 and the biases fp32, and every GEMM rounds its operand, the context
included, to bf16 and sums the exact products in fp32
(``nsf_flow_kernel.gemm``; JAX ``mademog_fused.py:194-202``).

B11 has two routes (:func:`gemm_route`, like B2's and B9's). ``"wgmma"``
(``csrc/mademog_wgmma.cuh``) runs every GEMM on Hopper's tensor cores,
bf16 wgmma for bf16 weights and 3xTF32 for fp32 ones, the weights streamed
from :func:`pack_weights_wgmma`'s image (B2's layout,
``nsf_flow_kernel.wgmma_positions``) through a ring of shared-memory
slots; the final layer's rows, more than one GEMM's 256, run as passes of
at most 256 over the same operand. It takes every model whose hidden width
is a multiple of 64 up to 256, whose padded parameter rows are at most 512
and whose tile fits. ``"simt"`` (``csrc/mademog_fused.cu``) runs fp32
FMAs and takes the rest, and the fused trainer's forward, whose weights
move every step. ``gemm=`` on :func:`mademog_log_prob_cuda` forces one.

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
from nflows_tpu_torch.ops.cuda.maf_flow_kernel import _pad_depth
from nflows_tpu_torch.ops.cuda.maf_fused import _is_relu
from nflows_tpu_torch.ops.cuda.nsf_flow_kernel import (
    _KC,
    _OC,
    _WG_MAX_ROWS,
    _WG_ROWS,
    _WG_SLOT,
    _WG_SLOTS,
    GEMM_ROUTES,
    MAX_SHARED_MEMORY,
    WEIGHT_DTYPES,
    _out_align,
    _round_out,
    _round_to,
    gemm,
    wgmma_positions,
)
from nflows_tpu_torch.ops.splines import rational_quadratic as rq_ref
from nflows_tpu_torch.utils import shapes as shapeutils

__all__ = ["FusedMADEMoG", "fuse_mademog", "can_fuse_mademog", "mademog_log_prob_cuda",
           "mademog_log_prob_plain", "pack_weights", "shared_memory_bytes", "final_passes",
           "gemm_route", "pack_weights_wgmma", "weights_route", "wgmma_dims", "wgmma_gemms",
           "wgmma_shared_memory_bytes", "launch_count", "bf16_launch_count",
           "route_launch_count"]

launch_count = 0  # B11 launches since the last reset (fp32 weights, either route)
bf16_launch_count = 0  # launches of a bf16-weight B11 kernel since the last reset
# launches by route and weight type since the last reset: "wgmma"
# (csrc/mademog_wgmma.cu), "simt" (csrc/mademog_fused.cu) and their "_bf16"
# twins
route_launch_count = {"simt": 0, "wgmma": 0, "simt_bf16": 0, "wgmma_bf16": 0}

ROWS = 32                # samples a block holds
WEIGHT_KEYS = ("wi", "bi", "wb", "bb", "wf", "bf")
CONTEXT_KEYS = ("wci", "bci", "wcb", "bcb")
MASKED_KEYS = ("wi", "wb", "wf")
MATRICES = ("wi", "wb", "wf", "wci", "wcb")  # bf16 with bf16 weights; the rest fp32
# csrc/mademog_wgmma.cuh: the final layer runs as kMaxPasses passes of at
# most kPassRows (four 64-row slabs)
_WG_MAX_FINAL_ROWS = 2 * _WG_MAX_ROWS


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
    back in kernel layout for the trainer's per-step fold. ``dtype``
    (float32 or bfloat16) is the matrices' type, cast after the masks are
    folded in, as the JAX package casts them; the biases and masks stay
    fp32."""
    made = _validate(dist)
    D, K, H = made.features, made.num_mixture_components, made.hidden_features
    Cf = None if made.context_layer is None else made.context_layer.in_features
    if dtype not in WEIGHT_DTYPES:
        raise ValueError(
            f"the fused MADEMoG kernel takes float32 or bfloat16 weights, not {dtype}")
    if H % _out_align(dtype) or shared_memory_bytes(D, Cf or 0, K, H, dtype) > MAX_SHARED_MEMORY:
        raise ValueError(
            f"hidden width {H} does not fit the fused kernel's shared-memory tile")

    def w_out_in(md):
        # nn.Linear keeps [out, in], the kernel layout of the JAX package
        w = md.weight.detach().float()
        return (w * md.mask if fold_masks else w).to(dtype)

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
            wci=made.context_layer.weight.detach().float().to(dtype),
            bci=column(made.context_layer),
            wcb=torch.cat([blk.context_layer.weight.detach().float()
                           for blk in made.blocks]).to(dtype),
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
    layer, Wcb_j c + bcb_j after each block's first linear. With bf16
    matrices every GEMM is ``gemm`` (bf16 operands, fp32 sums)."""
    H = weights["bi"].shape[0]
    h = gemm(x, weights["wi"]) + weights["bi"][:, 0]
    if context is not None:
        h = h + torch.relu(gemm(context, weights["wci"]) + weights["bci"][:, 0])
    wb, bb = weights["wb"], weights["bb"][:, 0]
    for j in range(num_blocks):
        r0, r1 = slice(2 * j * H, (2 * j + 1) * H), slice((2 * j + 1) * H, (2 * j + 2) * H)
        t = gemm(torch.relu(h), wb[r0]) + bb[r0]
        if context is not None:
            rc = slice(j * H, (j + 1) * H)
            t = t + (gemm(context, weights["wcb"][rc]) + weights["bcb"][rc, 0])
        h = h + gemm(torch.relu(t), wb[r1]) + bb[r1]
    return gemm(h, weights["wf"]) + weights["bf"][:, 0]


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


def shared_memory_bytes(D: int, C: int, K: int, H: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one block (csrc/mademog_fused.cu: smem_bytes);
    ``dtype``, the weights', pads the final layer's outputs."""
    TB = max(H, _round_out(3 * K * D, dtype))
    return 4 * (2 * _KC * _OC + ROWS * (H + TB + 2 * D + C))


def pack_weights(weights: Dict[str, torch.Tensor], static: dict,
                 out: Dict[str, torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Kernel layout of the (mask-folded) stacks: in-major [in, out]
    matrices on the weights' device, bf16 where the stacks are, else fp32,
    the final layer's outputs padded to a multiple of 4 (8 in bf16), the
    biases flat and fp32. With ``out``, an earlier result for the
    same model, the tensors are refilled in place: the trainer re-packs this
    way each step."""
    H, D, nb = static["H"], static["D"], static["num_blocks"]
    P = weights["wf"].shape[0]
    wdt = torch.bfloat16 if weights["wi"].dtype == torch.bfloat16 else torch.float32
    Pp = _round_out(P, wdt)
    if out is None:
        f32 = dict(dtype=torch.float32, device=weights["wi"].device)
        mat = dict(dtype=wdt, device=weights["wi"].device)
        out = dict(wi=torch.empty(D, H, **mat), bi=torch.empty(H, **f32),
                   wb=torch.empty(2 * nb, H, H, **mat), bb=torch.empty(2 * nb * H, **f32),
                   wf=torch.zeros(H, Pp, **mat), bf=torch.zeros(Pp, **f32))
        if "wci" in weights:
            C = weights["wci"].shape[1]
            out.update(wci=torch.empty(C, H, **mat), bci=torch.empty(H, **f32),
                       wcb=torch.empty(nb, C, H, **mat), bcb=torch.empty(nb * H, **f32))
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
    for fn in (lib.mademog_log_prob_launch, lib.mademog_log_prob_launch_bf16):
        fn.argtypes = [p, p, p, ctypes.c_int64] + [i] * 7 + [f] + [p] * 10 + [p]
        fn.restype = i


# -- the wgmma route -----------------------------------------------------------------


def _declare_wgmma(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (getattr(lib, name, None) for name in ("mademog_wgmma_launch",
                                                     "mademog_wgmma_launch_bf16")):
        if fn is not None:
            fn.argtypes = [p, p, p, ctypes.c_int64] + [i] * 8 + [f] + [p] * 6 + [p]
            fn.restype = i


def wgmma_dims(D: int, K: int, C: int = 0) -> dict:
    """The wgmma route's padded widths: the initial layer's depth Ip and the
    context's Cp (``maf_flow_kernel._pad_depth``: 16, 32 or a multiple of
    64), the final layer's 3 K D rows TMp to a multiple of 64 (wgmma's M)."""
    return dict(Ip=_pad_depth(D), Cp=_pad_depth(C) if C else 0, TMp=_round_to(3 * K * D, 64))


def final_passes(TMp: int) -> list:
    """The final layer's passes on the wgmma route: (first row, rows) of
    each, at most four 64-row slabs (256 rows) a pass, over the same
    operand h (csrc/mademog_wgmma.cuh)."""
    return [(r, min(_WG_MAX_ROWS, TMp - r)) for r in range(0, TMp, _WG_MAX_ROWS)]


def wgmma_gemms(num_blocks: int, context: bool, TMp: int) -> list:
    """The GEMMs in the order the kernel runs them and the image holds
    them: (stack, index), the index a block's for wb (2 j, 2 j + 1) and wcb
    (j), a pass of :func:`final_passes` for wf. Under a context the initial
    layer's projection comes first (its relu'd result is h's start) and each
    block's rides its first linear."""
    out = ([("wci", None)] if context else []) + [("wi", None)]
    for j in range(num_blocks):
        out += [("wb", 2 * j)] + ([("wcb", j)] if context else []) + [("wb", 2 * j + 1)]
    return out + [("wf", p) for p in range(len(final_passes(TMp)))]


def pack_weights_wgmma(weights: Dict[str, torch.Tensor], static: dict) -> Dict[str, torch.Tensor]:
    """The wgmma route's layout of the (mask-folded) stacks, built once on
    the weights' device with tensor operations: ``image``, the matrices as
    :func:`wgmma_gemms` orders them, each [out, in] zero-padded to
    :func:`wgmma_dims` (the final layer cut into :func:`final_passes`) and
    laid out by ``nsf_flow_kernel.wgmma_positions``, in the weights' type
    (bf16 or fp32; the kernel bulk-copies it chunk by chunk into its ring);
    the biases fp32 (bi [H], bb [2 nb, H], bf [TMp] zero past 3 K D,
    bci [H], bcb [nb, H]) and the padded widths."""
    D, K, H, nb = static["D"], static["K"], static["H"], static["num_blocks"]
    C = weights["wci"].shape[1] if "wci" in weights else 0
    dims = wgmma_dims(D, K, C)
    wdt = torch.bfloat16 if weights["wi"].dtype == torch.bfloat16 else torch.float32
    dev = weights["wi"].device

    def padded(t, shape, rows, cols):
        t = t.detach().reshape(*shape)
        out = torch.zeros(*shape[:-2], rows, cols, dtype=wdt, device=dev)
        out[..., :shape[-2], :shape[-1]] = t
        return out

    P = 3 * K * D
    mats = dict(wi=padded(weights["wi"], (H, D), H, dims["Ip"]),
                wb=weights["wb"].detach().to(wdt).reshape(2 * nb, H, H),
                wf=padded(weights["wf"], (P, H), dims["TMp"], H))
    if C:
        mats.update(wci=padded(weights["wci"], (H, C), H, dims["Cp"]),
                    wcb=padded(weights["wcb"], (nb, H, C), H, dims["Cp"]))
    passes = final_passes(dims["TMp"])
    parts = []
    for name, j in wgmma_gemms(nb, bool(C), dims["TMp"]):
        if name == "wf":
            r0, rows = passes[j]
            m = mats["wf"][r0:r0 + rows]
        else:
            m = mats[name] if j is None else mats[name][j]
        flat = torch.empty(m.numel(), dtype=wdt, device=dev)
        flat[wgmma_positions(m.shape[0], m.shape[1], wdt, dev).reshape(-1)] = m.reshape(-1)
        parts.append(flat)
    f32 = lambda name, *shape: weights[name].detach().float().reshape(*shape).contiguous()  # noqa: E731
    bf = torch.zeros(dims["TMp"], dtype=torch.float32, device=dev)
    bf[:P] = weights["bf"].detach().float().reshape(P)
    out = dict(image=torch.cat(parts).contiguous(), bi=f32("bi", H), bb=f32("bb", 2 * nb, H),
               bf=bf, **dims)
    if C:
        out.update(bci=f32("bci", H), bcb=f32("bcb", nb, H))
    return out


def _image_elems(H: int, nb: int, dims: dict) -> int:
    """Elements of :func:`pack_weights_wgmma`'s image."""
    Cp = dims["Cp"]
    return H * (dims["Ip"] + Cp + nb * (2 * H + Cp) + dims["TMp"])


def wgmma_shared_memory_bytes(D: int, K: int, H: int, C: int = 0,
                              dtype=torch.float32) -> int:
    """Dynamic shared memory of a block of the wgmma route
    (csrc/mademog_wgmma.cuh: mog_wgmma_smem_bytes): the ring, the operand
    planes (hi, and lo for fp32) or P [32][TMp + 4] fp32 over them, whichever
    is larger, the context operand, the barriers, x and the per-feature
    log-densities."""
    es = torch.empty((), dtype=dtype).element_size()
    planes = 2 if dtype == torch.float32 else 1
    dims = wgmma_dims(D, K, C)
    KX = max(H, dims["Ip"])
    op = max(planes * _WG_ROWS * KX * es, _WG_ROWS * (dims["TMp"] + 4) * 4)
    return (_WG_SLOTS * _WG_SLOT + op + planes * _WG_ROWS * dims["Cp"] * es + 16 * _WG_SLOTS
            + 4 * _WG_ROWS * 2 * D)


def gemm_route(D: int, K: int, H: int, C: int = 0, dtype=torch.float32,
               gemm: str = None) -> str:
    """The route B11 takes for a model of these widths: ``"wgmma"`` where the
    hidden width is a multiple of 64 up to 256, the final layer's padded
    rows are at most 512 (two passes) and the tile fits in shared memory;
    else ``"simt"``. ``gemm`` forces one; forcing ``"wgmma"`` on a shape it
    cannot take raises."""
    fits = (H % 64 == 0 and H <= _WG_MAX_ROWS
            and wgmma_dims(D, K, C)["TMp"] <= _WG_MAX_FINAL_ROWS
            and wgmma_shared_memory_bytes(D, K, H, C, dtype) <= MAX_SHARED_MEMORY)
    if gemm is None:
        return "wgmma" if fits else "simt"
    if gemm not in GEMM_ROUTES:
        raise ValueError(f"gemm must be one of {GEMM_ROUTES} or None, got {gemm!r}")
    if gemm == "wgmma" and not fits:
        raise ValueError(f"gemm='wgmma' does not take hidden width {H} with {3 * K * D} "
                         "parameter rows: the hidden width must be a multiple of 64 up to 256, "
                         "the parameter rows at most 512, the tile within shared memory")
    return gemm


def weights_route(weights: Dict[str, torch.Tensor], static: dict, gemm: str = None) -> str:
    """:func:`gemm_route` for a model's stacks."""
    C = weights["wci"].shape[1] if "wci" in weights else 0
    return gemm_route(static["D"], static["K"], static["H"], C, weights["wi"].dtype, gemm)


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


def check_packed(what, packed, static, context_features, device, dtype=torch.float32):
    """Shapes and types of :func:`pack_weights`' tensors for this model, its
    matrices in ``dtype``."""
    D, K, H, nb = static["D"], static["K"], static["H"], static["num_blocks"]
    Pp = _round_out(3 * K * D, dtype)
    shapes = dict(wi=(D, H), bi=(H,), wb=(2 * nb, H, H), bb=(2 * nb * H,), wf=(H, Pp),
                  bf=(Pp,))
    if context_features is not None:
        C = context_features
        shapes.update(wci=(C, H), bci=(H,), wcb=(nb, C, H), bcb=(nb * H,))
    for name, shape in shapes.items():
        t = packed[name]
        want = dtype if name in MATRICES else torch.float32
        if (tuple(t.shape) != shape or t.dtype != want or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: packed {name} must be a contiguous {shape} {want} "
                             f"tensor on {device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")


def data_ptr(t):
    """A tensor's address for the C entry points; None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def mademog_log_prob_cuda(x: torch.Tensor, weights: Dict[str, torch.Tensor], static: dict,
                          context: Optional[torch.Tensor] = None,
                          packed: Dict[str, torch.Tensor] = None,
                          gemm: str = None) -> torch.Tensor:
    """B11: x [N, D] (and the context [N, C]) -> lp [N].

    ``weights`` are the mask-folded stacks of :func:`_extract`; ``packed``
    is :func:`pack_weights` of them, and its entry ``"wgmma"``
    :func:`pack_weights_wgmma`, each built here when its route runs
    without it (callers that launch repeatedly keep them). ``gemm`` picks
    the route (see the module doc): None takes :func:`gemm_route`'s,
    ``"wgmma"`` or ``"simt"`` forces one; a forced ``"wgmma"`` raises on a
    shape it cannot take, on the CPU too. fp32 weights launch an fp32
    kernel, bf16 weights (the matrices bf16, the biases fp32) a bf16 one; x
    and the context are fp32 either way. A CPU tensor runs the plain
    version."""
    route = weights_route(weights, static, gemm)
    if x.device.type == "cpu":
        return mademog_log_prob_plain(x, weights, static, context)
    what = "mademog_log_prob_cuda"
    Cf = weights["wci"].shape[1] if "wci" in weights else None
    check_inputs(what, x, context, static, Cf)
    wdt = weights["wi"].dtype
    if wdt not in WEIGHT_DTYPES:
        raise ValueError(f"{what}: weights must be float32 or bfloat16, got {wdt}")
    bf16 = wdt == torch.bfloat16
    if route == "wgmma":
        wp = None if packed is None else packed.get("wgmma")
        if wp is None:
            wp = pack_weights_wgmma(weights, static)
        return _launch_wgmma(x, weights, static, context, wp)
    if packed is None:
        packed = pack_weights(weights, static)
    check_packed(what, packed, static, Cf, x.device, wdt)
    D, K, H, nb = static["D"], static["K"], static["H"], static["num_blocks"]
    if H % _out_align(wdt) or shared_memory_bytes(D, Cf or 0, K, H, wdt) > MAX_SHARED_MEMORY:
        raise ValueError(f"{what}: hidden width {H} does not fit the kernel's "
                         "shared-memory tile")
    n = x.shape[0]
    lib = _build.load_library("mademog_fused", _declare)
    launch = lib.mademog_log_prob_launch_bf16 if bf16 else lib.mademog_log_prob_launch
    lp = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = launch(
            x.data_ptr(), data_ptr(context), lp.data_ptr(), n, D, Cf or 0, K, H, 3 * K * D,
            _round_out(3 * K * D, wdt), nb, static["epsilon"],
            *(data_ptr(packed.get(k)) for k in WEIGHT_KEYS + CONTEXT_KEYS), stream)
    _count("simt", bf16)
    _build.check(code, "mademog_log_prob_launch_bf16" if bf16 else "mademog_log_prob_launch")
    return lp


def _count(route: str, bf16: bool) -> None:
    """One launch of B11 on ``route``: its own counter and the weight type's
    total."""
    global launch_count, bf16_launch_count
    route_launch_count[route + ("_bf16" if bf16 else "")] += 1
    if bf16:
        bf16_launch_count += 1
    else:
        launch_count += 1


def _launch_wgmma(x, weights, static, context, wp):
    """B11 on the wgmma route (csrc/mademog_wgmma.cuh) with
    :func:`pack_weights_wgmma`'s ``wp``."""
    what = "mademog_log_prob_cuda (wgmma)"
    D, K, H, nb = static["D"], static["K"], static["H"], static["num_blocks"]
    C = context.shape[1] if context is not None else 0
    dims = wgmma_dims(D, K, C)
    f32 = torch.float32
    expected = dict(bi=(H,), bb=(2 * nb, H), bf=(dims["TMp"],))
    if C:
        expected.update(bci=(H,), bcb=(nb, H))
    for name, shape in expected.items():
        t = wp.get(name)
        if t is None or tuple(t.shape) != shape or t.dtype != f32 or t.device != x.device or (
                not t.is_contiguous()):
            raise ValueError(f"{what}: packed['wgmma'][{name!r}] must be a contiguous {shape} "
                             f"float32 tensor on {x.device}")
    image, wdt = wp["image"], weights["wi"].dtype
    if (any(wp.get(k) != v for k, v in dims.items()) or image.dtype != wdt
            or image.numel() != _image_elems(H, nb, dims) or image.device != x.device
            or not image.is_contiguous()):
        raise ValueError(f"{what}: packed['wgmma'] is not pack_weights_wgmma of these weights")
    bf16 = wdt == torch.bfloat16
    lib = _build.load_library("mademog_wgmma_bf16" if bf16 else "mademog_wgmma",
                              _declare_wgmma)
    launch = lib.mademog_wgmma_launch_bf16 if bf16 else lib.mademog_wgmma_launch
    n = x.shape[0]
    lp = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = launch(
            x.data_ptr(), data_ptr(context), lp.data_ptr(), n, D, C, K, H, dims["Ip"],
            dims["Cp"], dims["TMp"], nb, static["epsilon"], image.data_ptr(),
            wp["bi"].data_ptr(), wp["bb"].data_ptr(), wp["bf"].data_ptr(),
            data_ptr(wp.get("bci")), data_ptr(wp.get("bcb")), stream)
    _count("wgmma", bf16)
    _build.check(code, "mademog_wgmma_launch_bf16" if bf16 else "mademog_wgmma_launch")
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
        self._packed = None
        if self.device.type == "cuda":
            # both routes' layouts: the SIMT one for an explicit
            # gemm="simt", the wgmma image where the shape takes that route
            self._packed = pack_weights(self._weights, self._static)
            if weights_route(self._weights, self._static) == "wgmma":
                self._packed["wgmma"] = pack_weights_wgmma(self._weights, self._static)

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
        if context is not None:
            context = context.float()
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

    ``dtype`` sets the MADE GEMM precision: torch.float32 (the default
    here) or torch.bfloat16, the JAX package's default, where each GEMM takes
    bf16 operands and sums in fp32 (kernels ``csrc/mademog_wgmma_bf16.cu``
    at widths the tensor cores take, else ``csrc/mademog_fused.cu``).
    Inputs, contexts and results are fp32 either way (a bf16 input or
    context is widened first)."""
    return FusedMADEMoG(dist, dtype=dtype)
