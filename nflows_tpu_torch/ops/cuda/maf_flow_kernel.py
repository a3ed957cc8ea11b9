"""Kernel B9: a whole autoregressive flow (MAF, NSF-AR, IAF) in one launch
(counterpart of nflows_tpu/ops/pallas/maf_flow_kernel.py; sources
``csrc/maf_flow_wgmma.cu``, ``csrc/maf_flow_kernel.cu`` and
``csrc/maf_degree_inverse.cu``).

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

The inverse has a second schedule and a kernel of its own
(``csrc/maf_degree_inverse.cuh``): the MADE's degrees order the fixed point.
Hidden unit u of a residual MADE has a degree d_u (it sees inputs 1..d_u),
every hidden mask is d_out >= d_in and the output mask of feature t is
t > d_in. So once features 1..k are known, every unit of degree k, stage by
stage, depends only on values already final, and feature k + 1's parameters
only on units of degree <= k. :func:`degree_order` reads the degrees from the
masks (a unit's degree is the row sum of the initial layer's mask) and
sorts the units by degree, one permutation for every hidden stage of a
layer; the ``"degrees"`` schedule then solves a layer in D steps, step k
computing the degree-k units of each stage once, then feature k + 1's
parameters, its inverse and its logabsdet: the work of one masked MADE pass.
In exact arithmetic it is the fixed point's function (masked weights are
exact zeros, and the D-th iterate is the sequential solution).
:func:`pack_degree_order` re-lays a model's weights for that kernel once;
``maf_flow_kernel_cuda`` routes by shape (``schedule=None``): the degree
kernel when every layer is a fixed point in the requested direction, the
masks are in degree form and its stage buffers fit a tile of 16 or 32
samples, else the fixed-point kernel. ``schedule=`` forces one.

The one-pass direction (every layer one MADE pass: unwrapped layers going
forward, a MAF's or NSF-AR's log_prob; wrapped ones coming back, an IAF's
sample) has two routes (:func:`gemm_route`, like B2's). ``"wgmma"``
(``csrc/maf_flow_wgmma.cuh``) runs every GEMM on Hopper's tensor cores,
bf16 wgmma for bf16 weights and 3xTF32 for fp32 ones, the weights streamed
from :func:`pack_weights_wgmma`'s image (B2's layout,
``nsf_flow_kernel.wgmma_positions``) through a ring of shared-memory
slots. It takes every such chain whose hidden width is a multiple of 64 up
to 256, whose padded parameter rows are at most 256 and whose tile fits.
``"simt"``
(``csrc/maf_flow_kernel.cuh``) runs fp32 FMAs and takes the rest, and the
trainers' forward, whose weights move every step. ``gemm=`` on
:func:`maf_flow_kernel_cuda` forces one.

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
    _WG_MAX_ROWS,
    _WG_ROWS,
    _WG_SLOT,
    _WG_SLOTS,
    GEMM_ROUTES,
    MAX_SHARED_MEMORY,
    WEIGHT_DTYPES,
    _out_align,
    _ptr,
    _round4,
    _round_out,
    _round_to,
    gemm,
    wgmma_positions,
)
from nflows_tpu_torch.ops.splines import rational_quadratic as rq_ref

__all__ = ["CONTEXT_KEYS", "MAFLayerStatic", "SCHEDULES",
           "degree_order", "degree_shared_memory_bytes", "degree_tile_rows", "gemm_route",
           "maf_flow_kernel_cuda", "maf_flow_kernel_plain", "one_pass", "pack_degree_order",
           "pack_weights", "pack_weights_wgmma", "shared_memory_bytes", "tile_rows",
           "weights_route", "wgmma_dims", "wgmma_gemms", "wgmma_shared_memory_bytes",
           "launch_count", "bf16_launch_count", "degree_launch_count", "route_launch_count"]

launch_count = 0  # kernel launches since the last reset (fp32 weights, every kernel)
bf16_launch_count = 0  # launches of a bf16-weight kernel since the last reset
degree_launch_count = 0  # launches of the degree-ordered inverse (either weight type)
# launches of the one-pass kernels by route and weight type since the last
# reset: "wgmma" (csrc/maf_flow_wgmma.cu), "simt" (csrc/maf_flow_kernel.cu,
# in either direction) and their "_bf16" twins
route_launch_count = {"simt": 0, "wgmma": 0, "simt_bf16": 0, "wgmma_bf16": 0}

_EPSILON = 1e-3  # MaskedAffineAutoregressiveTransform._EPSILON
TRANSFORMERS = ("affine", "rq")
CONTEXT_KEYS = ("wci", "bci", "wcb", "bcb")  # the MADE's context projections
MATRICES = ("wi", "wb", "wf", "wci", "wcb")  # bf16 with bf16 weights; the rest fp32
SCHEDULES = ("degrees", "fixed_point")
# csrc/maf_degree_inverse.cuh: a ring slot's bytes, the slots a tile size
# takes, the columns a slab holds at most (one a lane)
DEGREE_SLOT_BYTES = 8192
DEGREE_RING_SLOTS = {16: 3, 32: 6}
_SLAB = 32


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


def degree_shared_memory_bytes(rows: int, D: int, H: int, M: int, num_blocks: int,
                               C: int = 0) -> int:
    """Dynamic shared memory of one block of the degree kernel
    (csrc/maf_degree_inverse.cuh: degree_smem_bytes): the weight ring and its
    barriers, then [rows] columns of fp32 for the 1 + 2 nb stage buffers of H
    units, the state, the AR op's input and output (D each), one feature's M
    parameters, the context (C) and the logabsdet. M is the parameters a
    feature (2, or 3K - 1)."""
    slots = DEGREE_RING_SLOTS[rows]
    return (slots * DEGREE_SLOT_BYTES + 16 * slots
            + 4 * rows * ((1 + 2 * num_blocks) * H + 3 * D + M + C + 1))


def degree_tile_rows(n: int, D: int, H: int, M: int, num_blocks: int, sms: int,
                     C: int = 0) -> int:
    """Samples a block of the degree kernel holds: 16 where 16-sample tiles
    give each tile an SM of its own (twice the SMs that 32-sample ones
    would fill), else 32 where that fits, else 16; 0 if neither fits. At
    features 10, hidden 256, 5 layers, 2 blocks on an NVIDIA H100 80GB HBM3
    (700 W, 132 SMs; chip_smoke.py, PERF.md) 16-sample tiles take 9-16% less
    time than 32-sample ones at N = 512 and 2,048 (the MAF's inverse 0.566
    and 0.573 ms against 0.655 and 0.658; the NSF-AR and both with a
    context alike), and the two are within 2% at N = 4,096, where both
    fill the card."""
    def fits(rows):
        return degree_shared_memory_bytes(rows, D, H, M, num_blocks, C) <= MAX_SHARED_MEMORY
    if fits(16) and -(-n // 16) <= sms:
        return 16
    if fits(32):
        return 32
    return 16 if fits(16) else 0


def degree_order(weights: Dict[str, torch.Tensor], layer_static: Sequence, num_blocks: int,
                 masks: Dict[str, torch.Tensor] = None):
    """The degree order of each layer's hidden units, or None where a mask
    is not in degree form. ``masks`` has the stacks' layout (``_extract``'s
    ``return_masks``); without it the weights' nonzero entries stand for
    the masks (folded weights are masked denses with zeros). A unit's degree
    is the row sum of the initial layer's mask, whose row must then be that
    prefix of the inputs; every hidden mask must lie within d_out >= d_in
    and the final one within d_out > d_in (feature t of the param-major rows
    has degree t + 1). Returns, per layer, (order, offsets): the units
    sorted by degree (stable), one permutation for every hidden stage, and
    D + 1 offsets, offsets[d] the count of units of degree below d."""
    d = _dims(weights, layer_static, num_blocks)
    L, H, D, P, nb2 = (d[k] for k in ("L", "H", "D", "P", "nb2"))
    src = weights if masks is None else masks
    mi = (src["wi"].detach() != 0).cpu().view(L, H, D)
    mb = (src["wb"].detach() != 0).cpu().view(L, nb2, H, H)
    mf = (src["wf"].detach() != 0).cpu().view(L, P, H)
    feature_degree = torch.arange(1, D + 1).repeat(P // D)
    out = []
    for l in range(L):
        deg = mi[l].sum(dim=1)
        if not torch.equal(mi[l], torch.arange(D)[None, :] < deg[:, None]):
            return None
        if (mb[l] & (deg[:, None] < deg[None, :])).any():
            return None
        if (mf[l] & (feature_degree[:, None] <= deg[None, :])).any():
            return None
        order = torch.sort(deg, stable=True).indices
        counts = torch.bincount(deg, minlength=D + 1)[:D]
        offsets = [0] + torch.cumsum(counts, 0).tolist()
        out.append((order, offsets))
    return out


def _degree_slabs(D, M, C, num_blocks, offsets, align):
    """The kernel's walk of one layer, slab by slab: (what, block, step,
    first column, live columns, depth, width). ``what``: "ci", "i", "cb",
    "b0", "b1" (a group's units of the initial layer's context projection,
    of the initial layer, of block j's context projection, first and second
    linear) or "f" (feature k's parameters). Widths are the live columns
    rounded up to ``align`` (a 16-byte row of the slab), at most 32."""
    width = lambda live: min(_SLAB, -(-live // align) * align)  # noqa: E731
    for k in range(D):
        g0, dh = offsets[k], offsets[k + 1]
        G = dh - g0
        pieces = [(g0 + p, min(_SLAB, G - p)) for p in range(0, G, _SLAB)]
        for u0, live in pieces:
            if C:
                yield "ci", 0, k, u0, live, C, width(live)
            yield "i", 0, k, u0, live, k, width(live)
        for j in range(num_blocks if G else 0):
            for u0, live in pieces:
                if C:
                    yield "cb", j, k, u0, live, C, width(live)
                yield "b0", j, k, u0, live, dh, width(live)
            for u0, live in pieces:
                yield "b1", j, k, u0, live, dh, width(live)
        for p in range(0, M, _SLAB):
            live = min(_SLAB, M - p)
            yield "f", 0, k, p, live, dh, width(live)


def pack_degree_order(weights: Dict[str, torch.Tensor], layer_static: Sequence,
                      num_blocks: int, masks: Dict[str, torch.Tensor] = None,
                      order=None) -> Dict[str, torch.Tensor]:
    """The degree kernel's layout of a model, built once (``fuse_maf``,
    ``CompiledFlow``): raises where a mask is not in degree form
    (:func:`degree_order`) or the layers are not all wrapped or all
    unwrapped. ``stream`` holds every slab the kernel multiplies, in the
    order it runs them (the layers in the fixed point's direction, then the
    walk of ``_degree_slabs``), each slab [depth][width] in-major with its
    pad columns zero, in the weights' type; ``chunks`` [Q, 2] int32 cuts
    it into the pieces one ring slot takes (element offset, element count;
    whole rows of one slab, ``DEGREE_SLOT_BYTES`` at most). ``offsets``
    [L, D + 1] int32, the biases (fp32) in sorted unit order: bi [L, H],
    bb [L, 2 nb, H], bci [L, H], bcb [L, nb, H]; bf [L, P] param-major as
    in the stacks; ``idx`` as :func:`pack_weights`'."""
    d = _dims(weights, layer_static, num_blocks)
    L, H, D, P, nb2, C = (d[k] for k in ("L", "H", "D", "P", "nb2", "C"))
    nb, M = nb2 // 2, P // D
    if order is None:
        order = degree_order(weights, layer_static, num_blocks, masks)
    if order is None:
        raise ValueError("pack_degree_order: a MADE mask is not in degree form "
                         "(hidden d_out >= d_in, output d_out > d_in)")
    wrapped = {bool(ls.wrapped) for ls in layer_static}
    if len(wrapped) != 1:
        raise ValueError("pack_degree_order: the layers must be all wrapped or all unwrapped")
    wdt = torch.bfloat16 if weights["wi"].dtype == torch.bfloat16 else torch.float32
    dev = weights["wi"].device
    f32 = lambda name, *shape: weights[name].detach().cpu().float().view(*shape)  # noqa: E731
    wi, wb, wf = f32("wi", L, H, D), f32("wb", L, nb2, H, H), f32("wf", L, P, H)
    bi, bb, bf = f32("bi", L, H), f32("bb", L, nb2, H), f32("bf", L, P)
    if C:
        wci, bci = f32("wci", L, H, C), f32("bci", L, H)
        wcb, bcb = f32("wcb", L, nb, H, C), f32("bcb", L, nb, H)
    align = _out_align(wdt)
    slot = DEGREE_SLOT_BYTES // (2 if wdt == torch.bfloat16 else 4)
    slabs, chunks, at = [], [], 0
    # the fixed point runs unwrapped layers coming back, wrapped ones forward
    for l in (range(L) if wrapped.pop() else range(L - 1, -1, -1)):
        sigma, offsets = order[l]
        wb_s = wb[l][:, sigma][:, :, sigma]
        rows_of = {  # [out rows in sorted unit order, in] of each matrix
            "i": wi[l][sigma], "b0": wb_s[0::2], "b1": wb_s[1::2], "f": wf[l][:, sigma]}
        if C:
            rows_of.update(ci=wci[l][sigma], cb=wcb[l][:, sigma])
        for what, j, k, u0, live, depth, width in _degree_slabs(D, M, C, nb, offsets, align):
            mat = rows_of[what]
            mat = mat[j] if what in ("b0", "b1", "cb") else mat
            rows = ([(u0 + c) * D + k for c in range(live)] if what == "f"
                    else list(range(u0, u0 + live)))
            slab = torch.zeros(depth, width)
            slab[:, :live] = mat[rows, :depth].T
            slabs.append(slab.flatten())
            per = slot // width
            for r0 in range(0, depth, per):
                chunks.append((at + r0 * width, min(per, depth - r0) * width))
            at += depth * width
    perm = lambda t: torch.stack([t[l][order[l][0]] for l in range(L)])  # noqa: E731
    out = dict(
        stream=torch.cat(slabs).to(wdt).to(dev),
        chunks=torch.tensor(chunks, dtype=torch.int32).view(-1, 2).to(dev),
        offsets=torch.tensor([o for _, o in order], dtype=torch.int32, device=dev),
        bi=perm(bi).to(dev), bb=torch.stack([bb[l][:, order[l][0]] for l in range(L)]).to(dev),
        bf=bf.contiguous().to(dev),
        idx=torch.tensor([list(ls.perm_rows) + list(ls.inv_perm_rows) + [int(ls.wrapped)]
                          for ls in layer_static], dtype=torch.int32, device=dev))
    if C:
        out["bci"] = perm(bci).to(dev)
        out["bcb"] = torch.stack([bcb[l][:, order[l][0]] for l in range(L)]).to(dev)
    return out


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (getattr(lib, name, None) for name in ("maf_flow_launch", "maf_flow_launch_bf16")):
        if fn is not None:
            fn.argtypes = ([p, p, p, p, ctypes.c_int64] + [i] * 9 + [p] * 11 + [i, i, f, i]
                           + [f] * 4 + [i, p])
            fn.restype = i


def _declare_degrees(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (getattr(lib, name, None)
               for name in ("maf_degree_launch", "maf_degree_launch_bf16")):
        if fn is not None:
            fn.argtypes = ([p, p, p, p, ctypes.c_int64] + [i] * 6 + [p, p, i] + [p] * 7
                           + [i, i, f, i] + [f] * 4 + [i, p])
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


# -- the one-pass direction's wgmma route -----------------------------------------


def _declare_wgmma(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (getattr(lib, name, None) for name in ("maf_wgmma_launch",
                                                     "maf_wgmma_launch_bf16")):
        if fn is not None:
            fn.argtypes = ([p, p, p, p, ctypes.c_int64] + [i] * 9 + [p, ctypes.c_int64]
                           + [p] * 6 + [i, i, f, i] + [f] * 4 + [p])
            fn.restype = i


def _pad_depth(n: int) -> int:
    """A GEMM's depth on the wgmma route: 16, 32 or a multiple of 64, so that
    an fp32 GEMM's ring chunks are 2, 4 or 8 wgmma steps
    (``nsf_flow_kernel._chunk_steps``; csrc/wgmma_chain.cuh)."""
    return 16 if n <= 16 else 32 if n <= 32 else _round_to(n, 64)


def wgmma_dims(D: int, P: int, C: int = 0) -> dict:
    """The wgmma route's padded widths: the initial layer's depth Ip and the
    context's Cp (:func:`_pad_depth`), the final layer's rows TMp to a
    multiple of 64 (wgmma's M)."""
    return dict(Ip=_pad_depth(D), Cp=_pad_depth(C) if C else 0, TMp=_round_to(P, 64))


def wgmma_gemms(num_blocks: int, context: bool) -> list:
    """One layer's GEMMs in the order the kernel runs them and the image
    holds them: (stack, index), the index a block's for wb (2 j, 2 j + 1)
    and wcb (j). Under a context the initial layer's projection comes
    first (its relu'd result is h's start) and each block's rides its first
    linear."""
    out = ([("wci", None)] if context else []) + [("wi", None)]
    for j in range(num_blocks):
        out += [("wb", 2 * j)] + ([("wcb", j)] if context else []) + [("wb", 2 * j + 1)]
    return out + [("wf", None)]


def pack_weights_wgmma(weights: Dict[str, torch.Tensor], layer_static: Sequence,
                       num_blocks: int) -> Dict[str, torch.Tensor]:
    """The wgmma route's layout of the (mask-folded) stacks, built once on
    the weights' device with tensor operations: ``image``, each layer's
    matrices (as :func:`wgmma_gemms` orders them, each [out, in] zero-padded
    to :func:`wgmma_dims` and laid out by ``nsf_flow_kernel.wgmma_positions``)
    one layer after another in layer order, in the weights' type (bf16 or
    fp32; the kernel bulk-copies it chunk by chunk into its ring);
    ``layer_bytes``, one layer's share; the biases fp32 (bi [L, H],
    bb [L, 2 nb, H], bf [L, TMp] zero past P, bci [L, H], bcb [L, nb, H]),
    :func:`pack_weights`' index array and the padded widths."""
    d = _dims(weights, layer_static, num_blocks)
    L, H, D, P, nb2, C = (d[k] for k in ("L", "H", "D", "P", "nb2", "C"))
    nb = nb2 // 2
    dims = wgmma_dims(D, P, C)
    wdt = torch.bfloat16 if weights["wi"].dtype == torch.bfloat16 else torch.float32
    dev = weights["wi"].device

    def padded(t, shape, rows, cols):
        t = t.detach().reshape(*shape)
        out = torch.zeros(*shape[:-2], rows, cols, dtype=wdt, device=dev)
        out[..., :shape[-2], :shape[-1]] = t
        return out

    mats = dict(wi=padded(weights["wi"], (L, H, D), H, dims["Ip"]),
                wb=weights["wb"].detach().to(wdt).reshape(L, nb2, H, H),
                wf=padded(weights["wf"], (L, P, H), dims["TMp"], H))
    if C:
        mats.update(wci=padded(weights["wci"], (L, H, C), H, dims["Cp"]),
                    wcb=padded(weights["wcb"], (L, nb, H, C), H, dims["Cp"]))
    parts = []
    for name, j in wgmma_gemms(nb, bool(C)):
        m = mats[name] if j is None else mats[name][:, j]
        flat = torch.empty(L, m.shape[1] * m.shape[2], dtype=wdt, device=dev)
        flat[:, wgmma_positions(m.shape[1], m.shape[2], wdt, dev).reshape(-1)] = m.reshape(L, -1)
        parts.append(flat)
    image = torch.cat(parts, dim=1)
    f32 = lambda name, *shape: weights[name].detach().float().reshape(*shape).contiguous()  # noqa: E731
    bf = torch.zeros(L, dims["TMp"], dtype=torch.float32, device=dev)
    bf[:, :P] = weights["bf"].detach().float().reshape(L, P)
    out = dict(image=image.reshape(-1).contiguous(),
               layer_bytes=image.shape[1] * image.element_size(),
               bi=f32("bi", L, H), bb=f32("bb", L, nb2, H), bf=bf,
               idx=torch.tensor([list(ls.perm_rows) + list(ls.inv_perm_rows) + [int(ls.wrapped)]
                                 for ls in layer_static], dtype=torch.int32, device=dev),
               **dims)
    if C:
        out.update(bci=f32("bci", L, H), bcb=f32("bcb", L, nb, H))
    return out


def wgmma_shared_memory_bytes(D: int, H: int, P: int, C: int = 0,
                              dtype=torch.float32) -> int:
    """Dynamic shared memory of a block of the wgmma route
    (csrc/maf_flow_wgmma.cuh: maf_wgmma_smem_bytes): the ring, the operand
    buffer (also P [32][TMp + 4] fp32) and, for fp32, its lo plane, the
    context operand, the barriers, the state, the AR op's input, the
    elementwise logabsdets and their sum."""
    es = torch.empty((), dtype=dtype).element_size()
    split = dtype == torch.float32
    dims = wgmma_dims(D, P, C)
    KX = max(H, dims["Ip"])
    op = max(_WG_ROWS * KX * es, _WG_ROWS * (dims["TMp"] + 4) * 4)
    return (_WG_SLOTS * _WG_SLOT + op + (_WG_ROWS * KX * es if split else 0)
            + (2 if split else 1) * _WG_ROWS * dims["Cp"] * es + 16 * _WG_SLOTS
            + 4 * _WG_ROWS * (3 * D + 1))


def one_pass(layer_static: Sequence, inverse: bool) -> bool:
    """Every layer runs one MADE pass in this direction: unwrapped layers
    going forward, wrapped (IAF) layers coming back."""
    return all(bool(inverse) == bool(ls.wrapped) for ls in layer_static)


def gemm_route(H: int, D: int, P: int, C: int = 0, dtype=torch.float32,
               gemm: str = None) -> str:
    """The route B9's one-pass direction takes for a chain of these widths:
    ``"wgmma"`` where the hidden width is a multiple of 64 up to 256, the
    final layer's padded rows are at most 256 and the tile fits in shared
    memory; else ``"simt"``. ``gemm`` forces one; forcing ``"wgmma"`` on a
    shape it cannot take raises.

    Both transformers take wgmma in fp32 too (B2 keeps some coupling
    families on SIMT there): 3xTF32, each chunk's products summed apart
    (csrc/wgmma_chain.cuh: gemm_folded), holds the fp32 band (1e-3) on every
    check of the card, on the full-width MAF as initialised 5.6e-7 from
    float64 (the fp32 plain version 2.3e-7), on the trained MAF's weights
    1.2e-5 (1.3e-6), the served trained conditional MAF 2.0e-4 from its
    trainer (chip_smoke.py phases 9, 12, 29 on an NVIDIA H100; PERF.md). The
    affine transformer only multiplies in the one-pass direction, where B2's
    affine coupling divides."""
    fits = (H % 64 == 0 and H <= _WG_MAX_ROWS
            and wgmma_dims(D, P, C)["TMp"] <= _WG_MAX_ROWS
            and wgmma_shared_memory_bytes(D, H, P, C, dtype) <= MAX_SHARED_MEMORY)
    if gemm is None:
        return "wgmma" if fits else "simt"
    if gemm not in GEMM_ROUTES:
        raise ValueError(f"gemm must be one of {GEMM_ROUTES} or None, got {gemm!r}")
    if gemm == "wgmma" and not fits:
        raise ValueError(f"gemm='wgmma' does not take hidden width {H} with {P} parameter "
                         "rows: the hidden width must be a multiple of 64 up to 256, the "
                         "parameter rows at most 256, the tile within shared memory")
    return gemm


def weights_route(weights: Dict[str, torch.Tensor], layer_static: Sequence, num_blocks: int,
                  gemm: str = None) -> str:
    """:func:`gemm_route` for a chain's stacks."""
    d = _dims(weights, layer_static, num_blocks)
    return gemm_route(d["H"], d["D"], d["P"], d["C"], weights["wi"].dtype, gemm)


def maf_flow_kernel_plain(
    x: torch.Tensor, weights: Dict[str, torch.Tensor], layer_static,
    *, inverse: bool, num_blocks: int, transformer: str = "affine",
    spline_kw: dict = None, wh_scale: float = None, context: torch.Tensor = None,
    schedule: str = "fixed_point", masks: Dict[str, torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain in plain PyTorch on the extracted stacks, step by step as
    the kernel runs it (RQ boundary derivatives exactly 1). A layer's fixed
    point is solved by ``schedule``: ``"fixed_point"``, D + 1 MADE passes as
    the fixed-point kernel runs them; ``"degrees"``, the degree kernel's D
    steps on the units sorted by :func:`degree_order` (of ``masks``, or of
    the weights' nonzero entries; raises where they are not in degree form),
    each GEMM on the prefix of units the step may read. Computes in x's
    dtype, so float64 inputs and weights give a high-precision reference.
    ``wh_scale`` multiplies the RQ width and height parameters before the
    spline, for weights extracted without the rescale folded in.
    ``context`` [N, C] is required exactly when the weights hold context
    projections; like the kernels, every MADE pass (every step) recomputes
    them. With bf16 matrices every GEMM is ``gemm`` (bf16 operands, fp32
    sums), as the bf16 kernels compute it. Differentiable."""
    _check_transformer(transformer, spline_kw, wh_scale)
    _check_context("maf_flow_kernel_plain", weights, context)
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    order = None
    if schedule == "degrees":
        order = degree_order(weights, layer_static, num_blocks, masks)
        if order is None:
            raise ValueError("maf_flow_kernel_plain: schedule='degrees' needs masks in "
                             "degree form (hidden d_out >= d_in, output d_out > d_in)")
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

    def elementwise(xin, params, inv, D=D):
        # D features: params [n, M D], param-major
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
        if order is not None:
            return degree_inverse(l, z)
        xi = torch.zeros_like(z)
        for _ in range(D):
            xi, _ = elementwise(z, conditioner(l, xi), True)
        _, lad_el = elementwise(z, conditioner(l, xi), True)
        return xi, lad_el

    def degree_inverse(l, z):
        # step k: the degree-k units [a, b) of each stage from the units
        # below b (and the features solved so far), then feature k's
        # parameters from the last stage's units below b, as the degree
        # kernel adds them: (W h + b) + residual, (W0 relu(h) + b0) + (Wcb c + bcb)
        sigma, offsets = order[l]
        wi_s, bi_s = wi[l][sigma], bi[l][sigma]
        wb_s, bb_s = wb[l][:, sigma][:, :, sigma], bb[l][:, sigma]
        wf_s, M = wf[l][:, sigma], P // D
        if C:
            wci_s, bci_s = wci[l][sigma], bci[l][sigma]
            wcb_s, bcb_s = wcb[l][:, sigma], bcb[l][:, sigma]
        hs = [[] for _ in range(num_blocks + 1)]          # stage j's groups, [n, G] each
        ts = [[] for _ in range(num_blocks)]
        solved, lads = [], []
        for k in range(D):
            a, b = offsets[k], offsets[k + 1]
            if b > a:
                xin = torch.stack(solved, dim=1) if k else z[:, :0]
                h = gemm(xin, wi_s[a:b, :k]) + bi_s[a:b]
                if C:
                    h = h + torch.relu(gemm(context, wci_s[a:b]) + bci_s[a:b])
                hs[0].append(h)
                for j in range(num_blocks):
                    t = gemm(torch.relu(torch.cat(hs[j], dim=1)), wb_s[2 * j, a:b, :b]) \
                        + bb_s[2 * j, a:b]
                    if C:
                        t = t + (gemm(context, wcb_s[j, a:b]) + bcb_s[j, a:b])
                    ts[j].append(torch.relu(t))
                    t = gemm(torch.cat(ts[j], dim=1), wb_s[2 * j + 1, a:b, :b]) \
                        + bb_s[2 * j + 1, a:b]
                    hs[j + 1].append(t + hs[j][-1])
            rows = [m * D + k for m in range(M)]
            last = torch.cat(hs[num_blocks], dim=1) if b else z[:, :0]
            params = gemm(last, wf_s[rows, :b]) + bf[l][rows]
            if wh_scale is not None:
                params = torch.cat([params[:, :2 * K] * wh_scale, params[:, 2 * K:]], dim=1)
            x_k, lad_k = elementwise(z[:, k:k + 1], params, True, D=1)
            solved.append(x_k[:, 0])
            lads.append(lad_k[:, 0])
        return torch.stack(solved, dim=1), torch.stack(lads, dim=1)

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
    packed: Dict[str, torch.Tensor] = None, rows: int = None, schedule: str = None,
    gemm: str = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the chain: x [N, D] (and context [N, C] for a conditional flow)
    -> (y [N, D], logabsdet [N]).

    ``packed`` is :func:`pack_weights` of ``weights``, built here when not
    given (callers that launch repeatedly keep it); its entry ``"degrees"``,
    where there is one, is :func:`pack_degree_order` of the model, or None
    for masks not in degree form; its entry ``"wgmma"`` is
    :func:`pack_weights_wgmma`, built here when the wgmma route runs
    without it. ``gemm`` picks the route of a chain whose every layer runs
    one pass in this direction (see the module doc): None takes
    :func:`gemm_route`'s, ``"wgmma"`` or ``"simt"`` forces one; a forced
    ``"wgmma"`` raises on a shape it cannot take, on a chain with a fixed
    point in this direction and beside ``schedule`` or ``rows``; ``"simt"``
    leaves fixed points to ``schedule``; ``rows`` (a tile of the other
    kernels) keeps them. ``schedule`` picks the kernel of a fixed
    point (see the module doc): None routes by shape, ``"degrees"`` or
    ``"fixed_point"`` forces one; a forced ``"degrees"`` that cannot run
    (a one-pass layer, masks out of degree form, stage buffers too large)
    raises. Without a ``"degrees"`` entry the degree form is read from the
    weights' nonzero entries (the masks folded in), and the degree layout is
    built for the call. ``wh_scale``: see
    :func:`maf_flow_kernel_plain`. ``rows`` forces the tile size: 32 or 64
    for the fixed-point kernel, 16 or 32 for the degree kernel (with
    ``schedule=None``, 64 takes the fixed-point kernel); None chooses by
    shared memory and SM count (:func:`tile_rows`, :func:`degree_tile_rows`).
    fp32 weights launch the fp32 kernels, bf16 weights (wi,
    wb, wf, wci, wcb bf16, the biases fp32) the bf16 ones; x and the context
    are fp32 either way. On CPU tensors the plain version runs, with the
    fixed-point schedule unless ``schedule`` asks for the other: the two are
    one function, and the fixed-point plain repeats the unfused transform's
    arithmetic."""
    kw = dict(inverse=inverse, num_blocks=num_blocks, transformer=transformer,
              spline_kw=spline_kw, wh_scale=wh_scale, context=context)
    _check_transformer(transformer, spline_kw, wh_scale)
    _check_context("maf_flow_kernel_cuda", weights, context)
    wgmma = _wgmma_route(weights, layer_static, inverse, num_blocks, schedule, rows, gemm)
    if x.device.type == "cpu":
        if schedule is not None:
            _route(weights, layer_static, inverse, num_blocks, schedule, rows, packed)
        return maf_flow_kernel_plain(x, weights, layer_static, schedule=schedule or "fixed_point",
                                     **kw)
    if wgmma:
        wp = None if packed is None else packed.get("wgmma")
        if wp is None:
            wp = pack_weights_wgmma(weights, layer_static, num_blocks)
        return _launch_wgmma(x, weights, layer_static, wp, **kw)
    route, order = _route(weights, layer_static, inverse, num_blocks, schedule, rows, packed)
    if route == "degrees":
        return _launch_degrees(x, weights, layer_static, packed, order, rows, **kw)
    return _launch_fixed_point(x, weights, layer_static, packed, rows, **kw)


def _wgmma_route(weights, layer_static, inverse, num_blocks, schedule, rows, gemm):
    """True where this call takes the wgmma route; raises on a forced
    ``"wgmma"`` that cannot run (see maf_flow_kernel_cuda)."""
    if gemm is not None and gemm not in GEMM_ROUTES:
        raise ValueError(f"gemm must be one of {GEMM_ROUTES} or None, got {gemm!r}")
    passes = one_pass(layer_static, inverse)
    if gemm == "wgmma" and not (passes and schedule is None and rows is None):
        raise ValueError("gemm='wgmma' runs chains whose every layer is one MADE pass in this "
                         "direction, with schedule=None and rows=None")
    if not passes or schedule is not None or rows is not None:
        return False
    return weights_route(weights, layer_static, num_blocks, gemm) == "wgmma"


def _route(weights, layer_static, inverse, num_blocks, schedule, rows, packed):
    """(schedule, degree order or None) for this call; see maf_flow_kernel_cuda."""
    if schedule is not None and schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES} or None, got {schedule!r}")
    if schedule == "fixed_point":
        return schedule, None
    d = _dims(weights, layer_static, num_blocks)
    fits = any(degree_shared_memory_bytes(r, d["D"], d["H"], d["P"] // d["D"], num_blocks,
                                          d["C"]) <= MAX_SHARED_MEMORY
               for r in (16, 32) if rows in (None, r))
    # every layer a fixed point: unwrapped layers coming back, wrapped (IAF)
    # layers going forward
    fixed = all(bool(inverse) != bool(ls.wrapped) for ls in layer_static)
    if schedule is None and not (fixed and fits):
        return "fixed_point", None
    if schedule == "degrees" and not fixed:
        raise ValueError("schedule='degrees' solves fixed points; a layer of this chain runs "
                         "one pass in this direction")
    if schedule == "degrees" and not fits:
        raise ValueError(f"schedule='degrees': the stage buffers of hidden width {d['H']} do "
                         f"not fit a tile of {rows or '16 or 32'} samples")
    order = None
    if packed is not None and "degrees" in packed:
        form = packed["degrees"] is not None
    else:
        order = degree_order(weights, layer_static, num_blocks)
        form = order is not None
    if schedule == "degrees" and not form:
        raise ValueError("schedule='degrees' needs masks in degree form "
                         "(hidden d_out >= d_in, output d_out > d_in)")
    return ("degrees" if form else "fixed_point"), order


def _check_tensor(what, name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device or (
            not t.is_contiguous()):
        raise ValueError(f"{what}: {name} must be a contiguous {tuple(shape)} {dtype} tensor "
                         f"on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_rows(x, context, C):
    if x.dtype != torch.float32 or not x.is_contiguous() or x.ndim != 2:
        raise ValueError("maf_flow_kernel_cuda: x must be a contiguous [N, D] float32")
    if C:
        _check_tensor("maf_flow_kernel_cuda", "the context", context, (x.shape[0], C),
                      torch.float32, x.device)


def _spline_args(spline_kw):
    skw = spline_kw or dict(num_bins=0, tail_bound=0.0, min_bin_width=0.0,
                            min_bin_height=0.0, min_derivative=0.0)
    return (skw["num_bins"], skw["tail_bound"], skw["min_bin_width"], skw["min_bin_height"],
            skw["min_derivative"])


def _launch_degrees(x, weights, layer_static, packed, order, rows, *,
                    inverse, num_blocks, transformer, spline_kw, wh_scale, context):
    global launch_count, bf16_launch_count, degree_launch_count
    what = "maf_flow_kernel_cuda (degrees)"
    wdt = weights["wi"].dtype
    if wdt not in WEIGHT_DTYPES:
        raise ValueError(f"{what}: weights must be float32 or bfloat16, got {wdt}")
    bf16 = wdt == torch.bfloat16
    dp = packed["degrees"] if packed is not None and "degrees" in packed else (
        pack_degree_order(weights, layer_static, num_blocks, order=order))
    d = _dims(weights, layer_static, num_blocks)
    L, H, D, P, C, nb = d["L"], d["H"], d["D"], d["P"], d["C"], num_blocks
    _check_rows(x, context, C)
    n, M = x.shape[0], P // D
    if x.shape[1] != D:
        raise ValueError(f"{what}: x has {x.shape[1]} features, the weights {D}")
    dev, f32 = x.device, torch.float32
    expected = dict(offsets=((L, D + 1), torch.int32), bi=((L, H), f32),
                    bb=((L, 2 * nb, H), f32), bf=((L, P), f32), idx=((L, 2 * D + 1), torch.int32),
                    chunks=((dp["chunks"].shape[0], 2), torch.int32),
                    stream=((dp["stream"].numel(),), wdt))
    if C:
        expected.update(bci=((L, H), f32), bcb=((L, nb, H), f32))
    for name, (shape, dtype) in expected.items():
        _check_tensor(what, f"the degree layout's {name}", dp[name], shape, dtype, dev)
    if rows is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rows = degree_tile_rows(n, D, H, M, nb, sms, C)
    if rows not in DEGREE_RING_SLOTS or (
            degree_shared_memory_bytes(rows, D, H, M, nb, C) > MAX_SHARED_MEMORY):
        raise ValueError(f"{what}: hidden width {H} does not fit the kernel's shared-memory "
                         f"tile of {rows} samples")
    lib = _build.load_library("maf_degree_inverse_bf16" if bf16 else "maf_degree_inverse",
                              _declare_degrees)
    launch = lib.maf_degree_launch_bf16 if bf16 else lib.maf_degree_launch
    y = torch.empty_like(x)
    lad = torch.empty(n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda name: dp[name].data_ptr() if name in dp else 0  # noqa: E731
    with torch.cuda.device(dev):
        code = launch(
            x.data_ptr(), 0 if C == 0 else context.data_ptr(), y.data_ptr(), lad.data_ptr(),
            n, D, L, H, M, nb, C, ptr("stream"), ptr("chunks"), dp["chunks"].shape[0],
            ptr("offsets"), ptr("bi"), ptr("bb"), ptr("bf"), ptr("bci") if C else 0,
            ptr("bcb") if C else 0, ptr("idx"), int(inverse), TRANSFORMERS.index(transformer),
            1.0 if wh_scale is None else wh_scale, *_spline_args(spline_kw), rows, stream)
    if bf16:
        bf16_launch_count += 1
    else:
        launch_count += 1
    degree_launch_count += 1
    _build.check(code, "maf_degree_launch_bf16" if bf16 else "maf_degree_launch")
    return y, lad


def _launch_fixed_point(x, weights, layer_static, packed, rows, *, inverse, num_blocks,
                        transformer, spline_kw, wh_scale, context):
    wdt = weights["wi"].dtype
    if wdt not in WEIGHT_DTYPES:
        raise ValueError(f"maf_flow_kernel_cuda: weights must be float32 or bfloat16, got {wdt}")
    bf16 = wdt == torch.bfloat16
    if packed is None:
        packed = pack_weights(weights, layer_static, num_blocks)
    C = 0 if context is None else weights["wci"].shape[1]
    _check_rows(x, context, C)
    n, D = x.shape
    L, nb2 = len(layer_static), 2 * num_blocks
    H = packed["bi"].shape[1]
    K = spline_kw["num_bins"] if transformer == "rq" else 0
    P = 2 * D if transformer == "affine" else (3 * K - 1) * D
    D4, Pp, C4 = _round4(D), _round_out(P, wdt), _round4(C)
    expected = dict(wi=(L, D4, H), bi=(L, H), wb=(L, nb2, H, H), bb=(L, nb2, H),
                    wf=(L, H, Pp), bf=(L, Pp), idx=(L, 2 * D + 1))
    if C:
        expected.update(wci=(L, C4, H), bci=(L, H), wcb=(L, num_blocks, C4, H),
                        bcb=(L, num_blocks, H))
    for name, shape in expected.items():
        if name not in packed:
            raise ValueError(f"maf_flow_kernel_cuda: packed has no {name}: pack the "
                             "conditional weights with pack_weights")
        dtype = (torch.int32 if name == "idx" else wdt if name in MATRICES
                 else torch.float32)
        _check_tensor("maf_flow_kernel_cuda", f"packed {name}", packed[name], shape, dtype,
                      x.device)
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
            1.0 if wh_scale is None else wh_scale, *_spline_args(spline_kw), rows, stream)
    _count("simt", bf16)
    _build.check(code, "maf_flow_launch_bf16" if bf16 else "maf_flow_launch")
    return y, lad


def _count(route: str, bf16: bool) -> None:
    """One launch of a one-pass kernel of ``route``: its own counter and the
    weight type's total."""
    global launch_count, bf16_launch_count
    route_launch_count[route + ("_bf16" if bf16 else "")] += 1
    if bf16:
        bf16_launch_count += 1
    else:
        launch_count += 1


def _launch_wgmma(x, weights, layer_static, wp, *, inverse, num_blocks, transformer,
                  spline_kw, wh_scale, context):
    """B9's one-pass chain on the wgmma route (csrc/maf_flow_wgmma.cuh) with
    :func:`pack_weights_wgmma`'s ``wp``."""
    what = "maf_flow_kernel_cuda (wgmma)"
    d = _dims(weights, layer_static, num_blocks)
    L, H, D, P, C, nb = d["L"], d["H"], d["D"], d["P"], d["C"], num_blocks
    _check_rows(x, context, C)
    if x.shape[1] != D:
        raise ValueError(f"{what}: x has {x.shape[1]} features, the weights {D}")
    dims = wgmma_dims(D, P, C)
    f32 = torch.float32
    expected = dict(bi=((L, H), f32), bb=((L, 2 * nb, H), f32), bf=((L, dims["TMp"]), f32),
                    idx=((L, 2 * D + 1), torch.int32))
    if C:
        expected.update(bci=((L, H), f32), bcb=((L, nb, H), f32))
    for name, (shape, dtype) in expected.items():
        if name not in wp:
            raise ValueError(f"{what}: packed['wgmma'] has no {name}")
        _check_tensor(what, f"packed['wgmma'][{name!r}]", wp[name], shape, dtype, x.device)
    image, wdt = wp["image"], weights["wi"].dtype
    layer_elems = sum(
        (dims["TMp"] if name == "wf" else H)
        * {"wi": dims["Ip"], "wci": dims["Cp"], "wcb": dims["Cp"]}.get(name, H)
        for name, _ in wgmma_gemms(nb, bool(C)))
    if (any(wp.get(k) != v for k, v in dims.items()) or image.dtype != wdt
            or image.numel() != L * layer_elems
            or wp["layer_bytes"] != layer_elems * image.element_size()
            or image.device != x.device or not image.is_contiguous()):
        raise ValueError(f"{what}: packed['wgmma'] is not pack_weights_wgmma of these weights")
    bf16 = wdt == torch.bfloat16
    lib = _build.load_library("maf_flow_wgmma_bf16" if bf16 else "maf_flow_wgmma",
                              _declare_wgmma)
    launch = lib.maf_wgmma_launch_bf16 if bf16 else lib.maf_wgmma_launch
    n = x.shape[0]
    y = torch.empty_like(x)
    lad = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = launch(
            x.data_ptr(), _ptr(context), y.data_ptr(), lad.data_ptr(), n, D, L, H, dims["Ip"],
            P, dims["TMp"], nb, C, dims["Cp"], image.data_ptr(), wp["layer_bytes"],
            wp["bi"].data_ptr(), wp["bb"].data_ptr(), wp["bf"].data_ptr(), _ptr(wp.get("bci")),
            _ptr(wp.get("bcb")), wp["idx"].data_ptr(), int(inverse),
            TRANSFORMERS.index(transformer), 1.0 if wh_scale is None else wh_scale,
            *_spline_args(spline_kw), stream)
    _count("wgmma", bf16)
    _build.check(code, launch.__name__)
    return y, lad
