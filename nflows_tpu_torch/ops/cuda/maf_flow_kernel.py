"""Kernel B9: a whole autoregressive flow (MAF, NSF-AR, IAF) in one launch
(counterpart of nflows_tpu/ops/pallas/maf_flow_kernel.py; source
``csrc/maf_flow_kernel.cu``).

Forward (the log_prob direction) is one MADE pass a layer. The inverse
(ancestral sampling) is, per layer, the D-step fixed point the unfused
transform runs (start from zeros; D times a MADE pass and the elementwise
inverse) plus one more MADE pass for the logabsdet: D + 1 passes a layer
in one launch, where the unfused chain launches some ten small kernels a
pass. A ``wrapped`` layer (``InverseTransform`` of an AR transform, IAF)
swaps which of the two runs in which direction.

Weights come in the layout ``maf_fused._extract`` gives, which is the JAX
package's: flat 2-D stacks ``wi [L*H, D]``, ``bi [L*H, 1]``,
``wb [L*2nb*H, H]`` (out, in), ``bb [L*2nb*H, 1]``, ``wf [L*P, H]`` with
param-major rows (row ``j*D + t`` is parameter j of feature t) and
``bf [L*P, 1]``; P is 2 D for the affine transformer and (3K-1) D for the
RQ one. A conditional flow adds the MADE's context projections (plain
denses, no mask): ``wci [L*H, C]``, ``bci [L*H, 1]`` of the initial layer
(h gets ``relu(Wci ctx + bci)``) and ``wcb [L*nb*H, C]``, ``bcb
[L*nb*H, 1]`` of each residual block (its first linear gets
``Wcb_j ctx + bcb_j`` before the inner relu). The masks are folded into
the weights before they get here: a masked dense is a dense with zeros.
For the RQ transformer the softmax 1/sqrt(H) is either folded into the
width and height rows of wf and bf (serving) or applied by the kernel
(``wh_scale``; training).
:func:`pack_weights` re-lays the stacks for the kernel: in-major [in, out]
matrices, the initial layer's inputs and the final layer's outputs
zero-padded to multiples of 4, and the per-layer permutations as one int32
array; the context stacks in-major as well, their C inputs padded to C4.

Samples are rows here: x is [N, D], the context [N, C], and the result is
(y [N, D], lad [N]), with fp32 or bf16 weights, with or without a context.
With bf16 weights (``csrc/maf_flow_kernel_bf16.cu``, the JAX package's
default deployment) the matrices wi, wb, wf, wci and wcb are bf16 and the
biases fp32; every GEMM rounds its activation operand to bf16 and sums the
exact products in fp32 (``nsf_flow_kernel.gemm``), and the packed final
layer's outputs are padded to a multiple of 8.

:func:`maf_flow_kernel_plain` computes the same chain step by step in
PyTorch on the same stacks, with the same iteration count. The CPU tests
use it, and so does the chip smoke test as B9's reference on the card; a
wrapper call with a CPU tensor runs it, a CUDA tensor runs the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from nflows_tpu_torch.ops.cuda import _build
from nflows_tpu_torch.ops.cuda.nsf_flow_kernel import (
    _KC,
    _OC,
    MAX_SHARED_MEMORY,
    WEIGHT_DTYPES,
    _out_align,
    _round4,
    _round_out,
    gemm,
)
from nflows_tpu_torch.ops.splines import rational_quadratic as rq_ref

__all__ = ["CONTEXT_KEYS", "MAFLayerStatic", "maf_flow_kernel_cuda", "maf_flow_kernel_plain",
           "pack_weights", "shared_memory_bytes", "tile_rows", "launch_count",
           "bf16_launch_count"]

launch_count = 0  # kernel launches since the last reset (fp32 weights)
bf16_launch_count = 0  # launches of the bf16-weight kernel since the last reset

_EPSILON = 1e-3  # MaskedAffineAutoregressiveTransform._EPSILON
TRANSFORMERS = ("affine", "rq")
CONTEXT_KEYS = ("wci", "bci", "wcb", "bcb")  # the MADE's context projections
MATRICES = ("wi", "wb", "wf", "wci", "wcb")  # bf16 with bf16 weights; the rest fp32


class MAFLayerStatic(NamedTuple):
    perm_rows: Tuple[int, ...]      # forward: x_perm[i] = x[perm_rows[i]]
    inv_perm_rows: Tuple[int, ...]  # inverse of the above
    wrapped: bool = False           # True: InverseTransform(AR) (IAF); the
    #                                 elementwise direction swaps, the
    #                                 permutation stays where it is


def _check_transformer(transformer, spline_kw, wh_scale):
    if transformer not in TRANSFORMERS:
        raise ValueError(f"unknown transformer {transformer!r}")
    if transformer == "rq" and not spline_kw:
        raise ValueError("spline_kw is required for transformer='rq'")
    if wh_scale is not None and transformer != "rq":
        raise ValueError("wh_scale is the RQ softmax rescale; invalid for "
                         f"transformer={transformer!r}")


def _dims(weights, layer_static, num_blocks):
    L = len(layer_static)
    H, D = weights["wi"].shape[0] // L, weights["wi"].shape[1]
    C = weights["wci"].shape[1] if "wci" in weights else 0
    return dict(L=L, H=H, D=D, P=weights["wf"].shape[0] // L, nb2=2 * num_blocks, C=C)


def _check_context(what, weights, context):
    """A conditional chain needs its context and an unconditional one takes
    none: nothing is dropped quietly."""
    if ("wci" in weights) != (context is not None):
        raise ValueError(
            f"{what}: " + ("the weights hold context projections; pass the context"
                           if context is None else
                           "got a context for weights without context projections"))


def shared_memory_bytes(rows: int, D: int, H: int, P: int, C: int = 0,
                        dtype=torch.float32) -> int:
    """Dynamic shared memory of one block of ``rows`` samples
    (csrc/maf_flow_kernel.cuh: smem_bytes); C context features add a
    [C4][rows] tile. ``dtype``, the weights', pads P."""
    D4 = _round4(D)
    TB = max(H, _round_out(P, dtype), D4)
    return 4 * (2 * _KC * _OC + rows * (H + TB + 3 * D4 + D + 1 + _round4(C)))


def tile_rows(n: int, D: int, H: int, P: int, sms: int, C: int = 0,
              dtype=torch.float32) -> int:
    """Samples a block holds: 64 where that fits and still gives every SM a
    tile, else 32; 0 if neither fits. At features 10, hidden 256, 5 layers
    on an NVIDIA H100 80GB HBM3 (700 W, 132 SMs; chip_smoke.py) 64-sample
    tiles take 7.995 ms against 5.024 ms for a 4,096-sample inverse, where
    they fill 64 SMs, and 64.55 ms against 81.20 ms for 65,536 samples."""
    def fits(rows):
        return shared_memory_bytes(rows, D, H, P, C, dtype) <= MAX_SHARED_MEMORY
    if fits(64) and -(-n // 64) >= sms:
        return 64
    return 32 if fits(32) else 0


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (getattr(lib, name, None) for name in ("maf_flow_launch", "maf_flow_launch_bf16")):
        if fn is not None:
            fn.argtypes = ([p, p, p, p, ctypes.c_int64] + [i] * 9 + [p] * 11 + [i, i, f, i]
                           + [f] * 4 + [i, p])
            fn.restype = i


def pack_weights(weights: Dict[str, torch.Tensor], layer_static: Sequence,
                 num_blocks: int, out: Dict[str, torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Kernel layout of the (mask-folded) stacks: contiguous, on the
    weights' device, the matrices bf16 where the stacks are, else fp32, the
    biases fp32. With ``out``, an earlier result for the same model, the
    matrices are copied into its tensors and the index array is kept: the
    trainer re-packs this way each step. The context stacks, where there
    are any, go in-major with their inputs padded to C4 (wci [L, C4, H],
    wcb [L, nb, C4, H], bci [L, H], bcb [L, nb, H])."""
    d = _dims(weights, layer_static, num_blocks)
    L, H, D, P, nb2, C = (d[k] for k in ("L", "H", "D", "P", "nb2", "C"))
    wdt = torch.bfloat16 if weights["wi"].dtype == torch.bfloat16 else torch.float32
    D4, Pp, C4, nb = _round4(D), _round_out(P, wdt), _round4(C), nb2 // 2
    dev = weights["wi"].device
    if out is None:
        f32 = dict(dtype=torch.float32, device=dev)
        mat = dict(dtype=wdt, device=dev)
        out = dict(
            wi=torch.zeros(L, D4, H, **mat), wb=torch.empty(L, nb2, H, H, **mat),
            wf=torch.zeros(L, H, Pp, **mat), bf=torch.zeros(L, Pp, **f32),
            idx=torch.tensor(
                [list(ls.perm_rows) + list(ls.inv_perm_rows) + [int(ls.wrapped)]
                 for ls in layer_static], dtype=torch.int32, device=dev))
        if C:
            out["wci"] = torch.zeros(L, C4, H, **mat)
            out["wcb"] = torch.zeros(L, nb, C4, H, **mat)
    with torch.no_grad():
        out["wi"][:, :D].copy_(weights["wi"].view(L, H, D).transpose(1, 2))
        out["wb"].copy_(weights["wb"].view(L, nb2, H, H).transpose(2, 3))
        out["wf"][:, :, :P].copy_(weights["wf"].view(L, P, H).transpose(1, 2))
        out["bf"][:, :P].copy_(weights["bf"].view(L, P))
        # the biases need no re-laying: views where the weights are fp32
        out["bi"] = weights["bi"].detach().float().view(L, H).contiguous()
        out["bb"] = weights["bb"].detach().float().view(L, nb2, H).contiguous()
        if C:
            out["wci"][:, :C].copy_(weights["wci"].view(L, H, C).transpose(1, 2))
            out["wcb"][:, :, :C].copy_(weights["wcb"].view(L, nb, H, C).transpose(2, 3))
            out["bci"] = weights["bci"].detach().float().view(L, H).contiguous()
            out["bcb"] = weights["bcb"].detach().float().view(L, nb, H).contiguous()
    return out


def maf_flow_kernel_plain(
    x: torch.Tensor, weights: Dict[str, torch.Tensor], layer_static,
    *, inverse: bool, num_blocks: int, transformer: str = "affine",
    spline_kw: dict = None, wh_scale: float = None, context: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain in plain PyTorch on the extracted stacks, step by step as
    the kernel runs it (D + 1 MADE passes for a layer's fixed point, RQ
    boundary derivatives exactly 1). Computes in x's dtype, so float64
    inputs and weights give a high-precision reference. ``wh_scale``
    multiplies the RQ width and height parameters before the spline, for
    weights extracted without the rescale folded in. ``context`` [N, C] is
    required exactly when the weights hold context projections; like the
    kernel, every MADE pass recomputes them. With bf16 matrices every GEMM
    is ``gemm`` (bf16 operands, fp32 sums), as the bf16 kernel computes it.
    Differentiable."""
    _check_transformer(transformer, spline_kw, wh_scale)
    _check_context("maf_flow_kernel_plain", weights, context)
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

    def conditioner(l, xin):
        h = gemm(xin, wi[l]) + bi[l]
        if C:
            h = h + torch.relu(gemm(context, wci[l]) + bci[l])
        for j in range(num_blocks):
            t = gemm(torch.relu(h), wb[l, 2 * j]) + bb[l, 2 * j]
            if C:
                t = t + gemm(context, wcb[l, j]) + bcb[l, j]
            t = gemm(torch.relu(t), wb[l, 2 * j + 1]) + bb[l, 2 * j + 1]
            h = h + t
        params = gemm(h, wf[l]) + bf[l]                    # [n, P], column j*D + t
        if wh_scale is not None:
            params = torch.cat([params[:, :2 * K * D] * wh_scale,
                                params[:, 2 * K * D:]], dim=1)
        return params

    def elementwise(xin, params, inv):
        if transformer == "affine":
            scale = rq_ref._softplus(params[:, :D]) + _EPSILON
            log_s = torch.log(scale)
            if inv:
                return (xin - params[:, D:]) / scale, -log_s
            return scale * xin + params[:, D:], log_s
        p3 = params.reshape(n, -1, D).transpose(1, 2)      # [n, D, 3K-1]
        one = torch.ones_like(p3[..., :1])
        derivs = torch.cat(
            [one, spline_kw["min_derivative"] + rq_ref._softplus(p3[..., 2 * K:]), one],
            dim=-1)
        return rq_ref.linear_tails_spline(
            xin, p3[..., :K], p3[..., K:2 * K], derivs, inv, spline_kw["tail_bound"],
            spline_kw["min_bin_width"], spline_kw["min_bin_height"])

    def ar_forward(l, xin):
        return elementwise(xin, conditioner(l, xin), False)

    def ar_inverse(l, z):
        xi = torch.zeros_like(z)
        for _ in range(D):
            xi, _ = elementwise(z, conditioner(l, xi), True)
        _, lad_el = elementwise(z, conditioner(l, xi), True)
        return xi, lad_el

    lad = torch.zeros(n, dtype=x.dtype, device=x.device)
    for l in (range(L - 1, -1, -1) if inverse else range(L)):
        ls = layer_static[l]
        if inverse:
            y, lad_el = (ar_forward if ls.wrapped else ar_inverse)(l, x)
            x = y[:, list(ls.inv_perm_rows)]
        else:
            xp = x[:, list(ls.perm_rows)]
            x, lad_el = (ar_inverse if ls.wrapped else ar_forward)(l, xp)
        lad = lad + lad_el.sum(dim=1)
    return x, lad


def maf_flow_kernel_cuda(
    x: torch.Tensor, weights: Dict[str, torch.Tensor], layer_static,
    *, inverse: bool, num_blocks: int, transformer: str = "affine",
    spline_kw: dict = None, wh_scale: float = None, context: torch.Tensor = None,
    packed: Dict[str, torch.Tensor] = None, rows: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the chain: x [N, D] (and context [N, C] for a conditional flow)
    -> (y [N, D], logabsdet [N]).

    ``packed`` is :func:`pack_weights` of ``weights``, built here when not
    given (callers that launch repeatedly keep it). ``wh_scale``: see
    :func:`maf_flow_kernel_plain`. ``rows`` forces the tile size (32 or 64);
    None chooses by shared memory and SM count. fp32 weights launch the fp32
    kernel, bf16 weights (wi, wb, wf, wci, wcb bf16, the biases fp32) the
    bf16 one; x and the context are fp32 either way."""
    global launch_count, bf16_launch_count
    kw = dict(inverse=inverse, num_blocks=num_blocks, transformer=transformer,
              spline_kw=spline_kw, wh_scale=wh_scale, context=context)
    if x.device.type == "cpu":
        return maf_flow_kernel_plain(x, weights, layer_static, **kw)
    _check_transformer(transformer, spline_kw, wh_scale)
    _check_context("maf_flow_kernel_cuda", weights, context)
    wdt = weights["wi"].dtype
    if wdt not in WEIGHT_DTYPES:
        raise ValueError(f"maf_flow_kernel_cuda: weights must be float32 or bfloat16, got {wdt}")
    bf16 = wdt == torch.bfloat16
    if packed is None:
        packed = pack_weights(weights, layer_static, num_blocks)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.ndim != 2:
        raise ValueError("maf_flow_kernel_cuda: x must be a contiguous [N, D] float32")
    n, D = x.shape
    L, nb2 = len(layer_static), 2 * num_blocks
    H = packed["bi"].shape[1]
    K = spline_kw["num_bins"] if transformer == "rq" else 0
    P = 2 * D if transformer == "affine" else (3 * K - 1) * D
    C = 0 if context is None else weights["wci"].shape[1]
    D4, Pp, C4 = _round4(D), _round_out(P, wdt), _round4(C)
    expected = dict(wi=(L, D4, H), bi=(L, H), wb=(L, nb2, H, H), bb=(L, nb2, H),
                    wf=(L, H, Pp), bf=(L, Pp), idx=(L, 2 * D + 1))
    if C:
        if (context.dtype != torch.float32 or not context.is_contiguous()
                or tuple(context.shape) != (n, C) or context.device != x.device):
            raise ValueError(f"maf_flow_kernel_cuda: the context must be a contiguous "
                             f"({n}, {C}) float32 tensor on {x.device}, got "
                             f"{tuple(context.shape)} {context.dtype} on {context.device}")
        expected.update(wci=(L, C4, H), bci=(L, H), wcb=(L, num_blocks, C4, H),
                        bcb=(L, num_blocks, H))
    for name, shape in expected.items():
        if name not in packed:
            raise ValueError(f"maf_flow_kernel_cuda: packed has no {name}: pack the "
                             "conditional weights with pack_weights")
        t = packed[name]
        dtype = (torch.int32 if name == "idx" else wdt if name in MATRICES
                 else torch.float32)
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"maf_flow_kernel_cuda: packed {name} must be a contiguous "
                             f"{shape} {dtype} tensor on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if rows is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        rows = tile_rows(n, D, H, P, sms, C, wdt)
    if rows not in (32, 64) or H % _out_align(wdt) or (
            shared_memory_bytes(rows, D, H, P, C, wdt) > MAX_SHARED_MEMORY):
        raise ValueError(f"maf_flow_kernel_cuda: hidden width {H} does not fit "
                         f"the kernel's shared-memory tile of {rows} samples")

    lib = _build.load_library("maf_flow_kernel_bf16" if bf16 else "maf_flow_kernel", _declare)
    launch = lib.maf_flow_launch_bf16 if bf16 else lib.maf_flow_launch
    y = torch.empty_like(x)
    lad = torch.empty(n, dtype=torch.float32, device=x.device)
    skw = spline_kw or dict(num_bins=0, tail_bound=0.0, min_bin_width=0.0,
                            min_bin_height=0.0, min_derivative=0.0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = launch(
            x.data_ptr(), 0 if C == 0 else context.data_ptr(), y.data_ptr(), lad.data_ptr(),
            n, D, L, H, D4, P, Pp, nb2, C, C4,
            packed["wi"].data_ptr(), packed["bi"].data_ptr(),
            packed["wb"].data_ptr(), packed["bb"].data_ptr(),
            packed["wf"].data_ptr(), packed["bf"].data_ptr(),
            *(0 if C == 0 else packed[k].data_ptr() for k in CONTEXT_KEYS),
            packed["idx"].data_ptr(), int(inverse), TRANSFORMERS.index(transformer),
            1.0 if wh_scale is None else wh_scale, skw["num_bins"], skw["tail_bound"],
            skw["min_bin_width"], skw["min_bin_height"], skw["min_derivative"],
            rows, stream)
    if bf16:
        bf16_launch_count += 1
    else:
        launch_count += 1
    _build.check(code, "maf_flow_launch_bf16" if bf16 else "maf_flow_launch")
    return y, lad
