"""Kernel B2: the whole coupling chain in one launch (counterpart of
nflows_tpu/ops/pallas/nsf_flow_kernel.py; sources ``csrc/nsf_flow_wgmma.cu``
and ``csrc/nsf_flow_kernel.cu``, the coupling stages in
``csrc/coupling_stage.cuh``).

B2 has two routes (:func:`gemm_route`). ``"wgmma"``
(``csrc/nsf_flow_wgmma.cuh``) runs every GEMM on Hopper's tensor cores:
bf16 wgmma for bf16 weights, 3xTF32 for fp32 ones, the weights streamed
from :func:`pack_weights_wgmma`'s image through a ring of shared-memory
slots. It takes every chain whose hidden width is a multiple of 64 up to
256 and whose tile fits in shared memory, save the fp32 affine couplings
(``FP32_SIMT_FAMILIES``). ``"simt"`` (``csrc/nsf_flow_kernel.cuh``) runs
fp32 FMAs on the CUDA cores and takes the rest. ``gemm=`` on
:func:`nsf_flow_kernel_cuda` forces one.

The chain is L layers of [permutation, coupling with a ResidualNet
conditioner] of one family (``spline=``, as the JAX kernel's ``_SPLINES_TR``
names them): the rq, lrs, linear, quadratic or cubic spline with linear
tails, or the affine (``scale_act`` "default" or "general") or additive
coupling.

Weights come in the layout ``nsf_fused._extract`` gives, which is the JAX
package's: w0 [L, H, Tid], b0 [L, H, 1], wb [L, 2 nb, H, H] (out, in),
bb [L, 2 nb, H, 1], wf [L, TM, H] with K-major rows, bf [L, TM, 1], where
TM = T M and M is the family's parameter count a feature
(:func:`params_per_feature`); a conditional chain adds wc0 [L, H, C],
wcb [L, nb, H, C] and bcb [L, nb, H, 1]. With a per-sample context
[N, C], the initial layer adds wc0 ctx and each residual block gates its
second linear's output with sigmoid(wcb ctx + bcb) before the residual add
(the JAX kernel's ``_conditioner``, reference resnet.py:51). The softmax
1/sqrt(H) is either folded into the final layer's rows (serving) or
applied by the kernel to the first min(2 K T, TM) rows of the
conditioner's output (``wh_scale``; training, where the weights stay a
pure transpose of the model's).
:func:`pack_weights` re-lays them for the kernel: in-major [in, out]
matrices, the initial layer's inputs and the final layer's outputs
zero-padded to multiples of 4, and the per-layer index lists as one int32
array.

Samples are rows here: x is [N, D], the context [N, C], and the result is
(y [N, D], lad [N]). B2 runs fp32 or bf16 weights, with or without a
context, on either route. With bf16 weights (``csrc/nsf_flow_wgmma_bf16.cu``
and ``csrc/nsf_flow_kernel_bf16.cu``, the JAX package's default
deployment) the matrices w0, wb, wf, wc0 and wcb are bf16 and the biases
fp32, and every GEMM is the JAX kernel's ``_dot``: the activation operand
rounded to bf16, the products summed in fp32 (:func:`gemm`); the SIMT
route's packed matrices' output widths are then padded to multiples of 8,
which a 16-byte copy of bf16 weights needs. With fp32 weights the wgmma
route forms each product as three TF32 products (3xTF32: hi and lo parts
of both operands), never one, and keeps fp32's bands.

:func:`nsf_flow_kernel_plain` computes the same chain step by step in
PyTorch on the extracted weights, with the port's plain splines
(``ops/splines``) as each family's stage. The CPU tests use it, and so does
the chip smoke test as B2's reference on the card; a wrapper call with a CPU
tensor runs it, a CUDA tensor runs the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from nflows_tpu_torch.ops.cuda import _build
from nflows_tpu_torch.ops.cuda.rq_spline import _edge_derivative
from nflows_tpu_torch.ops.splines import cubic as cubic_ref
from nflows_tpu_torch.ops.splines import linear as linear_ref
from nflows_tpu_torch.ops.splines import linear_rational as lrs_ref
from nflows_tpu_torch.ops.splines import quadratic as quadratic_ref
from nflows_tpu_torch.ops.splines import rational_quadratic as rq_ref

__all__ = ["nsf_flow_kernel_cuda", "nsf_flow_kernel_plain", "pack_weights",
           "pack_weights_wgmma", "wgmma_positions", "wgmma_gemms", "wgmma_dims",
           "gemm_route", "weights_route", "gemm_wgmma", "shared_memory_bytes",
           "FP32_SIMT_FAMILIES", "wgmma_shared_memory_bytes", "params_per_feature",
           "stage_floats", "FAMILIES", "GEMM_ROUTES", "gemm", "launch_count",
           "bf16_launch_count", "route_launch_count"]

# the coupling families, in the order of csrc/coupling_stage.cuh's CouplingFamily
FAMILIES = ("rq", "lrs", "linear", "quadratic", "cubic", "affine", "additive")
# the affine scale activations, in the order of csrc/affine_coupling.cuh
SCALE_ACTIVATIONS = ("default", "general", "none")
# the families whose first min(2K, M) parameters a feature (widths and
# heights; all of a quadratic spline's) carry the softmax 1/sqrt(hidden),
# as the JAX package's _family_spline_config has it
RESCALED_FAMILIES = ("rq", "lrs", "quadratic", "cubic")
# the packed stacks that are matrices (bf16 with bf16 weights); the rest fp32
MATRICES = ("w0", "wb", "wf", "wc0", "wcb")

launch_count = 0  # kernel launches since the last reset (fp32 weights, either route)
bf16_launch_count = 0  # launches of a bf16-weight kernel since the last reset
# launches by route and weight type since the last reset: "simt", "wgmma",
# "simt_bf16", "wgmma_bf16"
route_launch_count = {"simt": 0, "wgmma": 0, "simt_bf16": 0, "wgmma_bf16": 0}
gemm_probe_launch_count = 0  # launches of gemm_wgmma's kernel
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)
GEMM_ROUTES = ("wgmma", "simt")

# Shared memory a block may use on Hopper (H100/H200), and the layout the
# kernel carves from it (csrc/nsf_flow_kernel.cuh: smem_bytes).
MAX_SHARED_MEMORY = 232448
_KC, _OC = 32, 256
# the wgmma route's tile (csrc/nsf_flow_wgmma.cuh): 32 samples, a ring of 4
# slots of 32 KB, one slab's A tile of one wgmma 64 rows x 32 bytes, at
# most 4 slabs of 64 rows a GEMM
_WG_ROWS, _WG_SLOT, _WG_STEP, _WG_MAX_ROWS, _WG_SLOTS = 32, 32768, 2048, 256, 4


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _out_align(dtype=torch.float32) -> int:
    """The weights one 16-byte cp.async stages (4 fp32, 8 bf16;
    csrc/tile_gemm.cuh): a packed matrix's output width, H among them, is a
    multiple of it."""
    return 8 if dtype == torch.bfloat16 else 4


def _round_out(n: int, dtype=torch.float32) -> int:
    """A packed matrix's output width: n rounded up to ``_out_align``."""
    align = _out_align(dtype)
    return -(-n // align) * align


def gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` as the kernels compute it: with bf16 weights, the operand
    ``a`` rounded to bf16 (nearest even) and the exact products summed in
    fp32, the JAX kernels' ``_dot`` with ``preferred_element_type=float32``;
    otherwise in the operands' own dtype."""
    if w.dtype == torch.bfloat16:
        return a.to(torch.bfloat16).float() @ w.float().T
    return a @ w.T


def params_per_feature(spline: str, num_bins: int = 0) -> int:
    """M, the conditioner's outputs a transformed feature, by family."""
    K = num_bins
    table = {"rq": 3 * K - 1, "lrs": 4 * K - 1, "linear": K, "quadratic": 2 * K - 1,
             "cubic": 2 * K + 2, "affine": 2, "additive": 1}
    if spline not in table:
        raise ValueError(f"spline must be one of {FAMILIES}, got {spline!r}")
    return table[spline]


def shared_memory_bytes(rows: int, D: int, H: int, Tid: int, T: int,
                        TM: int, C: int = 0, dtype=torch.float32) -> int:
    """Dynamic shared memory of one block of ``rows`` samples; a context of
    C features adds its tile [C][rows] and the gate buffer [H][rows]. bf16
    weights take the same layout (their staging uses half its buffer)."""
    TB = max(H, _round_out(TM, dtype), _round4(Tid))
    return 4 * (2 * _KC * _OC + rows * (H + TB + 2 * D + 2 * T + 1 + (C + H if C else 0)))


def stage_floats(spline: str, num_bins: int = 0, tail_bound: float = None,
                 min_bin_width: float = None, min_bin_height: float = None,
                 min_derivative: float = None, min_lambda: float = None,
                 **_) -> list:
    """The seven floats of a coupling stage's config, in the order the
    launchers of B2, B3 and B4 take them (csrc/coupling_stage.cuh
    ``make_stage_config``): tail_bound, min_bin_width, min_bin_height,
    min_derivative, min_lambda, the boundary slope of the rq and lrs splines
    and the linear spline's log(1/K). A family ignores the values it has no
    use for; the other keys of a ``static`` dict are ignored here."""
    floats = [tail_bound, min_bin_width, min_bin_height, min_derivative, min_lambda]
    floats = [0.0 if v is None else float(v) for v in floats]
    edge = _edge_derivative(min_derivative) if spline == "lrs" else 1.0
    log_inv_bins = float(np.log(1.0 / num_bins)) if spline == "linear" else 0.0
    return floats + [edge, log_inv_bins]


def _ptr(t) -> int:
    """A tensor's device address, 0 for None."""
    return 0 if t is None else t.data_ptr()


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (getattr(lib, name, None) for name in ("nsf_flow_launch", "nsf_flow_launch_bf16")):
        if fn is not None:
            fn.argtypes = ([p, p, p, ctypes.c_int64] + [i] * 9 + [p] * 7 + [i] * 4 + [f] * 8
                           + [p, i, p, p, p] + [i, p])
            fn.restype = i
    for fn in (getattr(lib, name, None) for name in ("nsf_wgmma_launch",
                                                     "nsf_wgmma_launch_bf16")):
        if fn is not None:
            fn.argtypes = ([p, p, p, ctypes.c_int64] + [i] * 9 + [p, ctypes.c_int64]
                           + [p] * 5 + [i] * 4 + [f] * 8 + [p, i, i, p])
            fn.restype = i
    for fn in (getattr(lib, name, None) for name in ("wgmma_gemm_launch",
                                                     "wgmma_gemm_launch_bf16")):
        if fn is not None:
            fn.argtypes = [p, p, p, ctypes.c_int64, i, i, p]
            fn.restype = i


def _index_array(layer_indices, device) -> torch.Tensor:
    """The per-layer index lists as one int32 array [L, 2 Tid + 2 T + 2 D]:
    id_rows, tr_rows, merge_fwd, id_idx, tr_idx, merge_inv."""
    return torch.tensor(
        [list(li.id_rows) + list(li.tr_rows) + list(li.merge_fwd)
         + list(li.id_idx) + list(li.tr_idx) + list(li.merge_inv)
         for li in layer_indices], dtype=torch.int32, device=device)


def pack_weights(weights: Dict[str, torch.Tensor], layer_indices: Sequence,
                 out: Dict[str, torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Kernel layout of the extracted weights (contiguous, on the weights'
    device): the matrices bf16 where the extracted ones are, else fp32, the
    biases fp32. With ``out``, an earlier result for the same model,
    the matrices are copied into its tensors and the index array is kept:
    the trainers re-pack this way after each optimizer step. The context
    stacks, where there are any, go in-major too (wc0 [L, C, H], wcb
    [L, nb, C, H], bcb [L, nb, H])."""
    w0, wf = weights["w0"], weights["wf"]
    L, H, Tid = w0.shape
    TM = wf.shape[1]
    wdt = torch.bfloat16 if w0.dtype == torch.bfloat16 else torch.float32
    I4, TMp = _round4(Tid), _round_out(TM, wdt)
    dev = w0.device
    if out is None:
        f32 = dict(dtype=torch.float32, device=dev)
        mat = dict(dtype=wdt, device=dev)
        out = dict(
            w0=torch.zeros(L, I4, H, **mat), wb=torch.empty(weights["wb"].shape, **mat),
            wf=torch.zeros(L, H, TMp, **mat), bf=torch.zeros(L, TMp, **f32),
            idx=_index_array(layer_indices, dev))
        if "wc0" in weights:
            out["wc0"] = torch.empty(weights["wc0"].transpose(1, 2).shape, **mat)
            out["wcb"] = torch.empty(weights["wcb"].transpose(2, 3).shape, **mat)
    with torch.no_grad():
        out["w0"][:, :Tid].copy_(w0.transpose(1, 2))
        out["wb"].copy_(weights["wb"].transpose(2, 3))
        out["wf"][:, :, :TM].copy_(wf.transpose(1, 2))
        out["bf"][:, :TM].copy_(weights["bf"][..., 0])
        # the biases need no re-laying: views where the weights are fp32
        out["b0"] = weights["b0"][..., 0].detach().float().contiguous()
        out["bb"] = weights["bb"][..., 0].detach().float().contiguous()
        if "wc0" in weights:
            out["wc0"].copy_(weights["wc0"].transpose(1, 2))
            out["wcb"].copy_(weights["wcb"].transpose(2, 3))
            out["bcb"] = weights["bcb"][..., 0].detach().float().contiguous()
    return out


# -- the wgmma route's weight image ------------------------------------------------


def _round_to(n: int, m: int) -> int:
    return -(-n // m) * m


def wgmma_dims(Tid: int, TM: int, C: int = 0) -> dict:
    """The wgmma route's padded widths: the initial layer's depth Ip and the
    context's Cp to 16 (one bf16 wgmma step), the final layer's rows TMp to
    a multiple of 64 (wgmma's M)."""
    return dict(Ip=_round_to(Tid, 16), Cp=_round_to(C, 16) if C else 0, TMp=_round_to(TM, 64))


def wgmma_gemms(num_blocks: int, context: bool) -> list:
    """One layer's GEMMs in the order the kernel runs them and the image
    holds them: (stack, index), the index into the stack's second axis for
    wb and wcb."""
    out = [("w0", None)] + ([("wc0", None)] if context else [])
    for j in range(num_blocks):
        out += [("wb", 2 * j)] + ([("wcb", j)] if context else []) + [("wb", 2 * j + 1)]
    return out + [("wf", None)]


def _chunk_steps(nk: int, ns: int) -> int:
    """wgmma steps a chunk of a GEMM of ``nk`` steps over ``ns`` slabs
    holds: the largest power of two up to 8 that a ring slot takes, or
    ``nk`` (csrc/nsf_flow_wgmma.cuh: chunk_steps)."""
    per = 8
    while per * ns * _WG_STEP > _WG_SLOT:
        per //= 2
    return min(nk, per)


def wgmma_positions(O: int, K: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The layout of one GEMM's matrix in the wgmma route's image: element
    (o, k) of the padded [O][K] matrix (O a multiple of 64, K of 16; K
    contiguous, as the weights are extracted) lies at ``pos[o, k]``
    elements from the GEMM's start. The GEMM is cut into chunks of whole
    wgmma steps (32 bytes of K) over all its 64-row slabs, a ring slot
    each (:func:`_chunk_steps`); a chunk holds, slab by slab and step by
    step, the step's two 16-byte core-matrix columns along K, each eight
    8-row core matrices of 128 bytes along M: the K-major, unswizzled
    shared-memory layout the kernel's wgmma descriptors read (LBO 1024,
    SBO 128). The packer scatters through it and the tests decode through
    it."""
    es = torch.empty((), dtype=dtype).element_size()
    if O % 64 or K % 16:
        raise ValueError(f"wgmma_positions: O {O} must be a multiple of 64 and K {K} of 16")
    V = 16 // es                  # elements of a 16-byte core-matrix row
    step = 2 * V                  # K elements of one wgmma
    ns, nk = O // 64, K // step
    kc = _chunk_steps(nk, ns)
    o = torch.arange(O, device=device)[:, None]
    k = torch.arange(K, device=device)[None, :]
    ks = k // step
    c, kk = ks // kc, ks % kc
    kn = torch.clamp(nk - c * kc, max=kc)
    slab_step = _WG_STEP // es     # elements of one slab's step
    return (c * kc * ns * slab_step + ((o // 64) * kn + kk) * slab_step
            + ((k % step) // V) * (1024 // es) + ((o % 64) // 8) * (128 // es)
            + (o % 8) * V + k % V)


def pack_weights_wgmma(weights: Dict[str, torch.Tensor],
                       layer_indices: Sequence) -> Dict[str, torch.Tensor]:
    """The wgmma route's layout of the extracted weights, built once on the
    weights' device with tensor operations: ``image``, every layer's
    matrices (w0, wc0, wb, wcb, wf as :func:`wgmma_gemms` orders them, each
    zero-padded to :func:`wgmma_dims` and laid out by
    :func:`wgmma_positions`) one layer after another, in the weights' type
    (bf16 or fp32; the kernel bulk-copies it chunk by chunk into its ring);
    ``layer_bytes``, one layer's share; the biases fp32 (b0 [L, H],
    bb [L, 2 nb, H], bf [L, TMp] zero past TM, bcb [L, nb, H]) and the index
    lists of :func:`pack_weights`."""
    w0, wf = weights["w0"], weights["wf"]
    L, H, Tid = w0.shape
    TM = wf.shape[1]
    ctx = "wc0" in weights
    C = weights["wc0"].shape[2] if ctx else 0
    nb = weights["wb"].shape[1] // 2
    dims = wgmma_dims(Tid, TM, C)
    wdt = torch.bfloat16 if w0.dtype == torch.bfloat16 else torch.float32
    dev = w0.device

    def padded(t, rows, cols):
        out = torch.zeros(*t.shape[:-2], rows, cols, dtype=wdt, device=dev)
        out[..., :t.shape[-2], :t.shape[-1]] = t.detach()
        return out

    mats = dict(w0=padded(w0, H, dims["Ip"]), wb=weights["wb"].detach().to(wdt),
                wf=padded(wf, dims["TMp"], H))
    if ctx:
        mats.update(wc0=padded(weights["wc0"], H, dims["Cp"]),
                    wcb=padded(weights["wcb"], H, dims["Cp"]))
    parts = []
    for name, j in wgmma_gemms(nb, ctx):
        m = mats[name] if j is None else mats[name][:, j]
        flat = torch.empty(L, m.shape[1] * m.shape[2], dtype=wdt, device=dev)
        flat[:, wgmma_positions(m.shape[1], m.shape[2], wdt, dev).reshape(-1)] = m.reshape(L, -1)
        parts.append(flat)
    image = torch.cat(parts, dim=1)
    with torch.no_grad():
        bf = torch.zeros(L, dims["TMp"], dtype=torch.float32, device=dev)
        bf[:, :TM] = weights["bf"][..., 0]
        out = dict(image=image.reshape(-1).contiguous(),
                   layer_bytes=image.shape[1] * image.element_size(),
                   b0=weights["b0"][..., 0].detach().float().contiguous(),
                   bb=weights["bb"][..., 0].detach().float().contiguous(), bf=bf,
                   idx=_index_array(layer_indices, dev), **dims)
        if ctx:
            out["bcb"] = weights["bcb"][..., 0].detach().float().contiguous()
    return out


def wgmma_shared_memory_bytes(D: int, H: int, Tid: int, T: int, TM: int, C: int = 0,
                              dtype=torch.float32) -> int:
    """Dynamic shared memory of a block of the wgmma route
    (csrc/nsf_flow_wgmma.cuh: wgmma_smem_bytes): the ring, the operand
    buffer (also P [32][TMp + 4] fp32) and, for fp32, its lo plane, the
    context operand, the barriers, the state and stage buffers."""
    es = torch.empty((), dtype=dtype).element_size()
    split = dtype == torch.float32
    dims = wgmma_dims(Tid, TM, C)
    planes = 2 if split else 1
    KX = max(H, dims["Ip"])
    op = max(_WG_ROWS * KX * es, _WG_ROWS * (dims["TMp"] + 4) * 4)
    return (_WG_SLOTS * _WG_SLOT + op + (_WG_ROWS * KX * es if split else 0)
            + planes * _WG_ROWS * dims["Cp"] * es + 16 * _WG_SLOTS
            + 4 * _WG_ROWS * (2 * D + 2 * T + 1))


# the families whose fp32 chain keeps the SIMT route: the affine coupling's
# inverse divides by scales down to 1e-3, and there 3xTF32 on the tensor
# cores (about 4 times fp32's rounding a product on the H100, its
# accumulation included) missed the fp32 band on an untamed RealNVP
# (tests/test_torch_cuda.py, PERF.md)
FP32_SIMT_FAMILIES = ("affine",)


def gemm_route(H: int, D: int, Tid: int, T: int, TM: int, C: int = 0,
               dtype=torch.float32, gemm: str = None, spline: str = None) -> str:
    """The route B2 takes for a chain of these widths: ``"wgmma"`` where
    the hidden width is a multiple of 64 up to 256, the final layer's
    padded rows are at most 256 and the tile fits in shared memory, save
    the fp32 chains of ``FP32_SIMT_FAMILIES``; else ``"simt"``. ``gemm``
    forces one; forcing ``"wgmma"`` on a shape it cannot take raises."""
    fits = (H % 64 == 0 and H <= _WG_MAX_ROWS
            and wgmma_dims(Tid, TM, C)["TMp"] <= _WG_MAX_ROWS
            and wgmma_shared_memory_bytes(D, H, Tid, T, TM, C, dtype) <= MAX_SHARED_MEMORY)
    if gemm is None:
        keep = dtype == torch.float32 and spline in FP32_SIMT_FAMILIES
        return "wgmma" if fits and not keep else "simt"
    if gemm not in GEMM_ROUTES:
        raise ValueError(f"gemm must be one of {GEMM_ROUTES} or None, got {gemm!r}")
    if gemm == "wgmma" and not fits:
        raise ValueError(f"gemm='wgmma' does not take hidden width {H} with {TM} parameter "
                         "rows: the hidden width must be a multiple of 64 up to 256, the "
                         "parameter rows at most 256, the tile within shared memory")
    return gemm


def weights_route(weights: Dict[str, torch.Tensor], layer_indices, gemm: str = None,
                  spline: str = None) -> str:
    """:func:`gemm_route` for a chain's extracted weights (of family
    ``spline``)."""
    L, H, Tid = weights["w0"].shape
    T = len(layer_indices[0].tr_rows)
    C = weights["wc0"].shape[2] if "wc0" in weights else 0
    return gemm_route(H, Tid + T, Tid, T, weights["wf"].shape[1], C, weights["w0"].dtype, gemm,
                      spline)


def gemm_wgmma(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` through the wgmma route's ring, split and fragment
    layout, one GEMM alone (a [N, K] fp32; w [O, K], fp32 on 3xTF32 or bf16
    with ``a`` rounded to bf16; K is padded to 16 and O to 64 here, O at
    most 256). Its plain version is :func:`gemm`, which a CPU tensor runs."""
    global gemm_probe_launch_count
    if a.device.type == "cpu":
        return gemm(a, w)
    wdt = w.dtype
    if wdt not in WEIGHT_DTYPES or a.dtype != torch.float32 or a.ndim != 2 or w.ndim != 2:
        raise ValueError("gemm_wgmma: a must be [N, K] float32 and w [O, K] float32 or bfloat16")
    n, K = a.shape
    O = w.shape[0]
    Kp, Op = _round_to(K, 16), _round_to(O, 64)
    if w.shape[1] != K or Op > _WG_MAX_ROWS:
        raise ValueError(f"gemm_wgmma: w must be [O <= 256, {K}], got {tuple(w.shape)}")
    wp = torch.zeros(Op, Kp, dtype=wdt, device=a.device)
    wp[:O, :K] = w
    image = torch.empty(Op * Kp, dtype=wdt, device=a.device)
    image[wgmma_positions(Op, Kp, wdt, a.device).reshape(-1)] = wp.reshape(-1)
    ap = torch.zeros(n, Kp, dtype=torch.float32, device=a.device)
    ap[:, :K] = a
    out = torch.empty(Op, n, dtype=torch.float32, device=a.device)
    bf16 = wdt == torch.bfloat16
    lib = _build.load_library("nsf_flow_wgmma_bf16" if bf16 else "nsf_flow_wgmma", _declare)
    fn = lib.wgmma_gemm_launch_bf16 if bf16 else lib.wgmma_gemm_launch
    with torch.cuda.device(a.device):
        code = fn(image.data_ptr(), ap.data_ptr(), out.data_ptr(), n, Kp, Op,
                  torch.cuda.current_stream(a.device).cuda_stream)
    gemm_probe_launch_count += 1
    _build.check(code, fn.__name__)
    return out[:O].T


def _affine_stage(x, shift, raw, inverse, scale_act):
    """The affine or additive coupling on [n, T] (the JAX kernel's
    ``_affine_TR``; the activations of transforms/coupling.py)."""
    if scale_act == "none":
        return (x - shift if inverse else x + shift), torch.zeros_like(x)
    from nflows_tpu_torch.transforms.coupling import (
        _default_scale_activation,
        _general_scale_activation,
    )
    activation = {"default": _default_scale_activation,
                  "general": _general_scale_activation}[scale_act]
    scale = activation(raw)
    log_scale = torch.log(scale)
    if inverse:
        return (x - shift) / scale, -log_scale
    return x * scale + shift, log_scale


def _stage(transform, P, inverse, spline, num_bins, tail_bound, min_bin_width,
           min_bin_height, min_derivative, min_lambda, scale_act):
    """One layer's coupling stage on the transformed features [n, T] with
    the parameters P [n, T, M]: the family's plain spline, or the affine
    stage."""
    K = num_bins
    if spline in ("affine", "additive"):
        return _affine_stage(transform, P[..., 0], P[..., 1] if spline == "affine" else None,
                             inverse, scale_act)
    kw = dict(inverse=inverse, tail_bound=tail_bound)
    if spline == "linear":
        return linear_ref.unconstrained_linear_spline_plain(transform, P, **kw)
    kw.update(min_bin_width=min_bin_width, min_bin_height=min_bin_height)
    if spline == "quadratic":
        return quadratic_ref.unconstrained_quadratic_spline_plain(
            transform, P[..., :K], P[..., K:], **kw)
    if spline == "cubic":
        return cubic_ref.unconstrained_cubic_spline_plain(
            transform, P[..., :K], P[..., K:2 * K], P[..., 2 * K:2 * K + 1],
            P[..., 2 * K + 1:], **kw)
    if spline == "lrs":
        return lrs_ref.unconstrained_linear_rational_spline_plain(
            transform, P[..., :K], P[..., K:2 * K], P[..., 3 * K:], P[..., 2 * K:3 * K],
            min_derivative=min_derivative, min_lambda=min_lambda, **kw)
    # rq: boundary derivatives exactly 1, as in the JAX kernel
    one = torch.ones_like(P[..., :1])
    derivs = torch.cat([one, min_derivative + rq_ref._softplus(P[..., 2 * K:]), one], dim=-1)
    return rq_ref.linear_tails_spline(
        transform, P[..., :K], P[..., K:2 * K], derivs, inverse, tail_bound,
        min_bin_width, min_bin_height)


def _check_context(what, x, weights, context):
    """A context goes with the weights' context stacks, and only with them:
    [N, C] for the N rows of x."""
    if (context is None) != ("wc0" not in weights):
        raise ValueError(f"{what}: a context must be given exactly when the weights have "
                         "context stacks (wc0, wcb, bcb)")
    if context is not None and (context.ndim != 2 or context.shape[0] != x.shape[0]
                                or context.shape[1] != weights["wc0"].shape[2]):
        raise ValueError(f"{what}: context must be [{x.shape[0]}, "
                         f"{weights['wc0'].shape[2]}], got {tuple(context.shape)}")


def nsf_flow_kernel_plain(
    x: torch.Tensor, weights: Dict[str, torch.Tensor], layer_indices,
    *, inverse: bool, num_blocks: int, spline: str = "rq", num_bins: int = 0,
    tail_bound: float = None, min_bin_width: float = None, min_bin_height: float = None,
    min_derivative: float = None, min_lambda: float = None, scale_act: str = None,
    wh_scale: float = None, context: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain in plain PyTorch on the extracted weights, step by step as
    the kernel runs it (the JAX kernel's ``_conditioner`` in each layer).
    Computes in x's dtype, so float64 inputs and weights give a
    high-precision reference. ``wh_scale`` multiplies the first 2K
    parameters of every feature (all of a quadratic spline's) before the
    stage, for weights extracted without the softmax rescale folded in.
    ``context`` [N, C] goes with the weights' context stacks. Differentiable
    (in the context too): the training kernels' plain versions are autograd
    over this function. With bf16 matrices every GEMM is :func:`gemm`, as
    the bf16 kernel computes it (bf16 operands, fp32 sums); the rest of the
    chain stays in x's dtype, fp32."""
    _check_context("nsf_flow_kernel_plain", x, weights, context)
    K = num_bins
    n = x.shape[0]
    lad = torch.zeros(n, dtype=x.dtype, device=x.device)
    L = len(layer_indices)
    for l in (range(L - 1, -1, -1) if inverse else range(L)):
        li = layer_indices[l]
        id_src = li.id_idx if inverse else li.id_rows
        tr_src = li.tr_idx if inverse else li.tr_rows
        merge = li.merge_inv if inverse else li.merge_fwd
        identity = x[:, list(id_src)]
        transform = x[:, list(tr_src)]
        T = transform.shape[1]
        h = gemm(identity, weights["w0"][l]) + weights["b0"][l, :, 0]
        if context is not None:
            h = h + gemm(context, weights["wc0"][l])
        for j in range(num_blocks):
            t = gemm(torch.relu(h), weights["wb"][l, 2 * j]) + weights["bb"][l, 2 * j, :, 0]
            t = (gemm(torch.relu(t), weights["wb"][l, 2 * j + 1])
                 + weights["bb"][l, 2 * j + 1, :, 0])
            if context is not None:
                t = t * torch.sigmoid(gemm(context, weights["wcb"][l, j])
                                      + weights["bcb"][l, j, :, 0])
            h = h + t
        P = gemm(h, weights["wf"][l]) + weights["bf"][l, :, 0]   # [n, TM]
        P = P.reshape(n, -1, T).transpose(1, 2)                   # [n, T, M]
        if wh_scale is not None:
            P = torch.cat([P[..., :2 * K] * wh_scale, P[..., 2 * K:]], dim=-1)
        out, lad_el = _stage(transform, P, inverse, spline, K, tail_bound, min_bin_width,
                             min_bin_height, min_derivative, min_lambda, scale_act)
        lad = lad + lad_el.sum(dim=1)
        x = torch.cat([identity, out], dim=1)[:, list(merge)]
    return x, lad


def nsf_flow_kernel_cuda(
    x: torch.Tensor, weights: Dict[str, torch.Tensor], layer_indices,
    *, inverse: bool, num_blocks: int, spline: str = "rq", num_bins: int = 0,
    tail_bound: float = None, min_bin_width: float = None, min_bin_height: float = None,
    min_derivative: float = None, min_lambda: float = None, scale_act: str = None,
    packed: Dict[str, torch.Tensor] = None, wh_scale: float = None,
    context: torch.Tensor = None, gemm: str = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the chain: x [N, D] (and the context [N, C] of a conditional
    chain) -> (y [N, D], logabsdet [N]).

    The family's configuration is the ``static`` dict of
    ``nsf_fused._extract``. ``gemm`` forces a route, ``"wgmma"`` or
    ``"simt"``; None takes :func:`gemm_route`'s. ``packed`` is
    :func:`pack_weights` of ``weights``, with the wgmma route's
    :func:`pack_weights_wgmma` under ``"wgmma"``; the route's part is built
    here when not given (callers that launch repeatedly keep it).
    ``wh_scale``: see :func:`nsf_flow_kernel_plain`; None leaves the
    parameters as they are. fp32 weights launch the route's fp32 kernel,
    bf16 weights (w0, wb, wf, wc0, wcb bf16, the biases fp32) its bf16 one;
    x and the context are fp32 either way."""
    kw = dict(inverse=inverse, num_blocks=num_blocks, spline=spline, num_bins=num_bins,
              tail_bound=tail_bound, min_bin_width=min_bin_width,
              min_bin_height=min_bin_height, min_derivative=min_derivative,
              min_lambda=min_lambda, scale_act=scale_act, wh_scale=wh_scale)
    if gemm is not None:
        # a forced route the shape cannot take raises
        weights_route(weights, layer_indices, gemm, spline)
    if x.device.type == "cpu":
        return nsf_flow_kernel_plain(x, weights, layer_indices, context=context, **kw)
    _check_context("nsf_flow_kernel_cuda", x, weights, context)
    wdt = weights["w0"].dtype
    if wdt not in WEIGHT_DTYPES:
        raise ValueError(f"nsf_flow_kernel_cuda: weights must be float32 or bfloat16, got {wdt}")
    M = params_per_feature(spline, num_bins)
    if spline == "affine" and scale_act not in ("default", "general"):
        raise ValueError("spline='affine' takes scale_act 'default' or 'general', "
                         f"got {scale_act!r}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.ndim != 2:
        raise ValueError("nsf_flow_kernel_cuda: x must be a contiguous [N, D] float32")
    n, D = x.shape
    L = len(layer_indices)
    Tid = len(layer_indices[0].id_rows)
    T = D - Tid
    TM = T * M
    H = weights["w0"].shape[1]
    C = 0 if context is None else context.shape[1]
    if C and (context.dtype != torch.float32 or not context.is_contiguous()
              or context.device != x.device):
        raise ValueError("nsf_flow_kernel_cuda: context must be a contiguous float32 "
                         f"tensor on {x.device}")
    stage = (FAMILIES.index(spline), SCALE_ACTIVATIONS.index(scale_act or "none"), num_bins,
             1.0 if wh_scale is None else wh_scale,
             *stage_floats(spline, num_bins, tail_bound, min_bin_width, min_bin_height,
                           min_derivative, min_lambda))
    if gemm_route(H, D, Tid, T, TM, C, wdt, gemm, spline) == "wgmma":
        wp = None if packed is None else packed.get("wgmma")
        if wp is None:
            wp = pack_weights_wgmma(weights, layer_indices)
        return _launch_wgmma(x, context, wp, L, H, Tid, T, TM, num_blocks, inverse, stage)
    if packed is None:
        packed = pack_weights(weights, layer_indices)
    TMp = _round_out(TM, wdt)
    expected = dict(w0=(L, _round4(Tid), H), b0=(L, H), wb=(L, 2 * num_blocks, H, H),
                    bb=(L, 2 * num_blocks, H), wf=(L, H, TMp),
                    bf=(L, TMp), idx=(L, 2 * D + 2 * Tid + 2 * T))
    if C:
        expected.update(wc0=(L, C, H), wcb=(L, num_blocks, C, H), bcb=(L, num_blocks, H))
    for name, shape in expected.items():
        t = packed.get(name)
        if t is None:
            raise ValueError(f"nsf_flow_kernel_cuda: packed has no {name!r}")
        dtype = (torch.int32 if name == "idx" else wdt if name in MATRICES
                 else torch.float32)
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"nsf_flow_kernel_cuda: packed {name} must be a contiguous "
                             f"{shape} {dtype} tensor on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    # 64-sample tiles unless they would leave SMs idle or not fit
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows = 64 if -(-n // 64) >= sms else 32
    if shared_memory_bytes(rows, D, H, Tid, T, TM, C, wdt) > MAX_SHARED_MEMORY:
        rows = 32
    bf16 = wdt == torch.bfloat16
    if H % _out_align(wdt) or shared_memory_bytes(rows, D, H, Tid, T, TM, C,
                                                  wdt) > MAX_SHARED_MEMORY:
        raise ValueError(f"nsf_flow_kernel_cuda: hidden width {H} does not fit "
                         "the kernel's shared-memory tile")
    lib = _build.load_library("nsf_flow_kernel_bf16" if bf16 else "nsf_flow_kernel", _declare)
    launch = lib.nsf_flow_launch_bf16 if bf16 else lib.nsf_flow_launch
    y = torch.empty_like(x)
    lad = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = launch(
            x.data_ptr(), y.data_ptr(), lad.data_ptr(), n, D, L, H, Tid,
            _round4(Tid), T, TM, TMp, 2 * num_blocks,
            packed["w0"].data_ptr(), packed["b0"].data_ptr(),
            packed["wb"].data_ptr(), packed["bb"].data_ptr(),
            packed["wf"].data_ptr(), packed["bf"].data_ptr(),
            packed["idx"].data_ptr(), int(inverse), *stage,
            _ptr(context), C, _ptr(packed.get("wc0")), _ptr(packed.get("wcb")),
            _ptr(packed.get("bcb")), rows, stream)
    _count("simt", bf16)
    _build.check(code, "nsf_flow_launch_bf16" if bf16 else "nsf_flow_launch")
    return y, lad


def _count(route: str, bf16: bool) -> None:
    """One launch of ``route``'s kernel: its own counter and the weight
    type's total."""
    global launch_count, bf16_launch_count
    route_launch_count[route + ("_bf16" if bf16 else "")] += 1
    if bf16:
        bf16_launch_count += 1
    else:
        launch_count += 1


def _launch_wgmma(x, context, wp, L, H, Tid, T, TM, num_blocks, inverse, stage):
    """B2 on the wgmma route (csrc/nsf_flow_wgmma.cuh) with
    :func:`pack_weights_wgmma`'s ``wp``; ``stage`` the family's launch
    arguments."""
    n, D = x.shape
    C = 0 if context is None else context.shape[1]
    wdt = wp["image"].dtype
    dims = wgmma_dims(Tid, TM, C)
    nb = num_blocks
    expected = dict(b0=((L, H), torch.float32), bb=((L, 2 * nb, H), torch.float32),
                    bf=((L, dims["TMp"]), torch.float32),
                    idx=((L, 2 * D + 2 * Tid + 2 * T), torch.int32))
    if C:
        expected["bcb"] = ((L, nb, H), torch.float32)
    for name, (shape, dtype) in expected.items():
        t = wp.get(name)
        if (t is None or tuple(t.shape) != shape or t.dtype != dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"nsf_flow_kernel_cuda: packed['wgmma'][{name!r}] must be a "
                             f"contiguous {shape} {dtype} tensor on {x.device}")
    layer_elems = sum(
        (dims["TMp"] if name == "wf" else H)
        * {"w0": dims["Ip"], "wc0": dims["Cp"], "wcb": dims["Cp"]}.get(name, H)
        for name, _ in wgmma_gemms(nb, bool(C)))
    image = wp["image"]
    if (any(wp.get(k) != v for k, v in dims.items()) or image.numel() != L * layer_elems
            or wp["layer_bytes"] != layer_elems * image.element_size()
            or image.device != x.device or not image.is_contiguous()):
        raise ValueError("nsf_flow_kernel_cuda: packed['wgmma'] is not pack_weights_wgmma "
                         "of these weights")
    bf16 = wdt == torch.bfloat16
    lib = _build.load_library("nsf_flow_wgmma_bf16" if bf16 else "nsf_flow_wgmma", _declare)
    launch = lib.nsf_wgmma_launch_bf16 if bf16 else lib.nsf_wgmma_launch
    y = torch.empty_like(x)
    lad = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = launch(
            x.data_ptr(), y.data_ptr(), lad.data_ptr(), n, D, L, H, Tid, dims["Ip"], T, TM,
            dims["TMp"], nb, image.data_ptr(), wp["layer_bytes"], wp["b0"].data_ptr(),
            wp["bb"].data_ptr(), wp["bf"].data_ptr(), _ptr(wp.get("bcb")),
            wp["idx"].data_ptr(), int(inverse), *stage, _ptr(context), C, dims["Cp"], stream)
    _count("wgmma", bf16)
    _build.check(code, launch.__name__)
    return y, lad
