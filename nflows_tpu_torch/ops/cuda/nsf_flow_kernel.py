"""Kernel B2: the whole RQ-NSF coupling chain in one launch
(counterpart of nflows_tpu/ops/pallas/nsf_flow_kernel.py; source
``csrc/nsf_flow_kernel.cu``).

Weights come in the layout ``nsf_fused._extract`` gives, which is the JAX
package's: w0 [L, H, Tid], b0 [L, H, 1], wb [L, 2 nb, H, H] (out, in),
bb [L, 2 nb, H, 1], wf [L, TM, H] with K-major rows, bf [L, TM, 1]. The
softmax 1/sqrt(H) is either folded into the width and height rows of wf and
bf (serving) or applied by the kernel to those rows of the conditioner's
output (``wh_scale``; training, where the weights stay a pure transpose of
the model's). :func:`pack_weights` re-lays them for the kernel: in-major
[in, out] matrices, the initial layer's inputs and the final layer's outputs
zero-padded to multiples of 4, and the per-layer index lists as one int32
array.

Samples are rows here: x is [N, D] and the result is (y [N, D], lad [N]).
This slice covers the rq family in fp32 without context.

:func:`nsf_flow_kernel_plain` computes the same chain step by step in
PyTorch on the extracted weights. The CPU tests use it, and so does the
chip smoke test as B2's reference on the card; a wrapper call with a CPU
tensor runs it, a CUDA tensor runs the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from nflows_tpu_torch.ops.cuda import _build
from nflows_tpu_torch.ops.splines import rational_quadratic as rq_ref

__all__ = ["nsf_flow_kernel_cuda", "nsf_flow_kernel_plain", "pack_weights",
           "shared_memory_bytes", "launch_count"]

launch_count = 0  # kernel launches since the last reset

# Shared memory a block may use on Hopper (H100/H200), and the layout the
# kernel carves from it (csrc/nsf_flow_kernel.cu: smem_bytes).
MAX_SHARED_MEMORY = 232448
_KC, _OC = 32, 256


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def shared_memory_bytes(rows: int, D: int, H: int, Tid: int, T: int,
                        TM: int) -> int:
    """Dynamic shared memory of one block of ``rows`` samples."""
    TB = max(H, _round4(TM), _round4(Tid))
    return 4 * (2 * _KC * _OC + rows * (H + TB + 2 * D + 2 * T + 1))


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nsf_flow_launch.argtypes = (
        [p, p, p, ctypes.c_int64] + [i] * 8 + [p] * 7 + [i, f, i] + [f] * 4
        + [i, p])
    lib.nsf_flow_launch.restype = i


def pack_weights(weights: Dict[str, torch.Tensor], layer_indices: Sequence,
                 out: Dict[str, torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Kernel layout of the extracted weights (fp32, contiguous, on the
    weights' device). With ``out``, an earlier result for the same model,
    the matrices are copied into its tensors and the index array is kept:
    the trainers re-pack this way after each optimizer step."""
    w0, wf = weights["w0"], weights["wf"]
    L, H, Tid = w0.shape
    TM = wf.shape[1]
    I4, TMp = _round4(Tid), _round4(TM)
    dev = w0.device
    if out is None:
        f32 = dict(dtype=torch.float32, device=dev)
        out = dict(
            w0=torch.zeros(L, I4, H, **f32), wb=torch.empty(weights["wb"].shape, **f32),
            wf=torch.zeros(L, H, TMp, **f32), bf=torch.zeros(L, TMp, **f32),
            idx=torch.tensor(
                [list(li.id_rows) + list(li.tr_rows) + list(li.merge_fwd)
                 + list(li.id_idx) + list(li.tr_idx) + list(li.merge_inv)
                 for li in layer_indices], dtype=torch.int32, device=dev))
    with torch.no_grad():
        out["w0"][:, :Tid].copy_(w0.transpose(1, 2))
        out["wb"].copy_(weights["wb"].transpose(2, 3))
        out["wf"][:, :, :TM].copy_(wf.transpose(1, 2))
        out["bf"][:, :TM].copy_(weights["bf"][..., 0])
        # the biases need no re-laying: views where the weights are fp32
        out["b0"] = weights["b0"][..., 0].detach().float().contiguous()
        out["bb"] = weights["bb"][..., 0].detach().float().contiguous()
    return out


def nsf_flow_kernel_plain(
    x: torch.Tensor, weights: Dict[str, torch.Tensor], layer_indices,
    *, inverse: bool, num_blocks: int, num_bins: int, tail_bound: float,
    min_bin_width: float, min_bin_height: float, min_derivative: float,
    wh_scale: float = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain in plain PyTorch on the extracted weights, step by step as
    the kernel runs it (boundary derivatives exactly 1). Computes in x's
    dtype, so float64 inputs and weights give a high-precision reference.
    ``wh_scale`` multiplies the width and height parameters before the
    spline, for weights extracted without the softmax rescale folded in.
    Differentiable: the training kernels' plain versions are autograd over
    this function."""
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
        h = identity @ weights["w0"][l].T + weights["b0"][l, :, 0]
        for j in range(num_blocks):
            t = torch.relu(h) @ weights["wb"][l, 2 * j].T + weights["bb"][l, 2 * j, :, 0]
            t = (torch.relu(t) @ weights["wb"][l, 2 * j + 1].T
                 + weights["bb"][l, 2 * j + 1, :, 0])
            h = h + t
        P = h @ weights["wf"][l].T + weights["bf"][l, :, 0]       # [n, TM]
        P = P.reshape(n, -1, T).transpose(1, 2)                   # [n, T, 3K-1]
        if wh_scale is not None:
            P = torch.cat([P[..., :2 * K] * wh_scale, P[..., 2 * K:]], dim=-1)
        one = torch.ones_like(P[..., :1])
        derivs = torch.cat(
            [one, min_derivative + rq_ref._softplus(P[..., 2 * K:]), one], dim=-1)
        out, lad_el = rq_ref.linear_tails_spline(
            transform, P[..., :K], P[..., K:2 * K], derivs, inverse,
            tail_bound, min_bin_width, min_bin_height)
        lad = lad + lad_el.sum(dim=1)
        x = torch.cat([identity, out], dim=1)[:, list(merge)]
    return x, lad


def nsf_flow_kernel_cuda(
    x: torch.Tensor, weights: Dict[str, torch.Tensor], layer_indices,
    *, inverse: bool, num_blocks: int, num_bins: int, tail_bound: float,
    min_bin_width: float, min_bin_height: float, min_derivative: float,
    packed: Dict[str, torch.Tensor] = None, wh_scale: float = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the chain: x [N, D] -> (y [N, D], logabsdet [N]).

    ``packed`` is :func:`pack_weights` of ``weights``, built here when not
    given (callers that launch repeatedly keep it). ``wh_scale``: see
    :func:`nsf_flow_kernel_plain`; None leaves the parameters as they are."""
    global launch_count
    kw = dict(inverse=inverse, num_blocks=num_blocks, num_bins=num_bins,
              tail_bound=tail_bound, min_bin_width=min_bin_width,
              min_bin_height=min_bin_height, min_derivative=min_derivative,
              wh_scale=wh_scale)
    if x.device.type == "cpu":
        return nsf_flow_kernel_plain(x, weights, layer_indices, **kw)
    if packed is None:
        packed = pack_weights(weights, layer_indices)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.ndim != 2:
        raise ValueError("nsf_flow_kernel_cuda: x must be a contiguous [N, D] float32")
    n, D = x.shape
    L = len(layer_indices)
    Tid = len(layer_indices[0].id_rows)
    T = D - Tid
    TM = T * (3 * num_bins - 1)
    H = packed["b0"].shape[1]
    expected = dict(w0=(L, _round4(Tid), H), b0=(L, H), wb=(L, 2 * num_blocks, H, H),
                    bb=(L, 2 * num_blocks, H), wf=(L, H, _round4(TM)),
                    bf=(L, _round4(TM)), idx=(L, 2 * D + 2 * Tid + 2 * T))
    for name, shape in expected.items():
        t = packed[name]
        dtype = torch.int32 if name == "idx" else torch.float32
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"nsf_flow_kernel_cuda: packed {name} must be a contiguous "
                             f"{shape} {dtype} tensor on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    # 64-sample tiles unless they would leave SMs idle or not fit
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows = 64 if -(-n // 64) >= sms else 32
    if shared_memory_bytes(rows, D, H, Tid, T, TM) > MAX_SHARED_MEMORY:
        rows = 32
    if H % 4 or shared_memory_bytes(rows, D, H, Tid, T, TM) > MAX_SHARED_MEMORY:
        raise ValueError(f"nsf_flow_kernel_cuda: hidden width {H} does not fit "
                         "the kernel's shared-memory tile")

    lib = _build.load_library("nsf_flow_kernel", _declare)
    y = torch.empty_like(x)
    lad = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.nsf_flow_launch(
            x.data_ptr(), y.data_ptr(), lad.data_ptr(), n, D, L, H, Tid,
            _round4(Tid), T, _round4(TM), 2 * num_blocks,
            packed["w0"].data_ptr(), packed["b0"].data_ptr(),
            packed["wb"].data_ptr(), packed["bb"].data_ptr(),
            packed["wf"].data_ptr(), packed["bf"].data_ptr(),
            packed["idx"].data_ptr(), int(inverse),
            1.0 if wh_scale is None else wh_scale, num_bins, tail_bound,
            min_bin_width, min_bin_height, min_derivative, rows, stream)
    launch_count += 1
    _build.check(code, "nsf_flow_launch")
    return y, lad
