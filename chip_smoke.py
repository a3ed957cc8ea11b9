"""Smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nflows_tpu_torch/csrc`` with nvcc
(sm_90a), holds each against its plain PyTorch version on the card, then
serves the flagship NeuralSplineFlow at full width (features 6, hidden
256, 10 layers x 2 blocks, 8 bins, tail bound 3; random weights from a
fixed seed) through ``CompiledFlow``: fused (kernel B2, one launch a
request) and unfused (kernel B1 in each of the 10 couplings). Every phase
raises on failure, so the exit code is non-zero.

Prints, before the last line, the card's name and power limit, a JSON
line ``{"kernels": [...]}`` with each kernel's launches on the main path,
error against its plain version, device time, plain time, bound and
library time; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Tolerances. Each kernel is held to its plain PyTorch version on the same
inputs: max |kernel - plain| within the stated tolerance, or, where fp32
rounding moves the plain version itself by more than that, max
|kernel - f64| within twice max |plain - f64|, f64 being the plain version
evaluated in float64 on the same inputs. B1 on the values the main path
hands it (the flagship's first coupling): 1e-4 on outputs (a few fp32 ulps
of values up to the tail bound 3) and 1e-3 on the per-element logabsdet (a
log of ratios of small bin quantities, which loses more digits). B1 on
N(0, 1) parameters, a stress case: 1e-2 against float64 on both, because
such parameters make bins ~1e-2 wide with slopes down to 1e-3, where a
one-ulp error of a bin edge moves the inverse by up to ~1e3 ulps; there
the plain fp32 version itself moves by several 1e-4, and the run prints
both. B2: 1e-3 on outputs and logabsdet at random init (ten layers of
fp32 GEMMs and splines, summed over 30 elements).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM data sheet, dense, at the 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

SERVE_BATCH = 4096
FLAGSHIP = dict(features=6, hidden_features=256, num_layers=10,
                num_blocks_per_layer=2, num_bins=8, tail_bound=3.0)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def call_ms(torch, fn, iters):
    """Mean time of one call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events, after one warm-up call: device time plus any gap
    the host leaves between launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters, kernel=None):
    """Mean device time of one call of ``fn``: the summed duration of the
    kernels it runs (those whose name contains ``kernel``, or all), from
    torch.profiler's CUDA trace. Falls back to :func:`call_ms` if the
    trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if kernel is None or kernel in evt.key:
            total_us += getattr(evt, "self_device_time_total", 0.0) or 0.0
    if total_us <= 0.0:
        log("  (profiler saw no device time; timing with CUDA events)")
        return call_ms(torch, fn, iters)
    return total_us / 1e3 / iters


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def hold(name, kernel, plain32, plain64, tol):
    """Hold a kernel result to its plain version (see the module doc).
    Returns max |kernel - plain|."""
    err_kp = max_err(kernel, plain32)
    err_k64 = max_err(kernel, plain64)
    err_p64 = max_err(plain32, plain64)
    ok = err_kp <= tol or err_k64 <= 2.0 * err_p64
    log(f"  {name}: |kernel-plain| {err_kp:.3e}  |kernel-f64| {err_k64:.3e}  "
        f"|plain-f64| {err_p64:.3e}  tol {tol:.0e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err_kp


def hold_exact(name, kernel, plain32, plain64, tol):
    """Hold a kernel result to the float64 plain version within ``tol``."""
    err = max_err(kernel, plain64)
    log(f"  {name}: |kernel-f64| {err:.3e}  |plain-f64| {max_err(plain32, plain64):.3e}  "
        f"|kernel-plain| {max_err(kernel, plain32):.3e}  tol {tol:.0e}")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel is {err:.3e} from float64")
    return err


def coupling_inputs(flow, x):
    """What the first coupling of ``flow`` hands B1 for inputs ``x``: the
    transformed features and the spline parameters (widths and heights
    already rescaled), as contiguous tensors."""
    perm, cpl = flow.transform.transforms[0], flow.transform.transforms[1]
    z, _ = perm(x)
    params = cpl.transform_net(z[:, cpl.identity_features])
    params = params.reshape(x.shape[0], cpl.num_transform_features, -1)
    K = cpl.num_bins
    w, h = cpl._softmax_rescale(params[..., :K], params[..., K:2 * K])
    return [t.contiguous() for t in (z[:, cpl.transform_features], w, h,
                                     params[..., 2 * K:])]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from nflows_tpu_torch import CompiledFlow, NeuralSplineFlow
    from nflows_tpu_torch.ops.cuda import _build, nsf_flow_kernel, rq_spline
    from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf
    from nflows_tpu_torch.ops.splines import rational_quadratic as rq

    # -- phase 1: device and settings ----------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- phase 2: build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for stem, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")

    # -- phase 3: B1 against its plain version ---------------------------------
    flow = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                            rng=np.random.default_rng(0), device=dev, **FLAGSHIP)
    flow.eval()
    K, B = FLAGSHIP["num_bins"], FLAGSHIP["tail_bound"]
    D = FLAGSHIP["features"]
    gen = torch.Generator().manual_seed(0)
    b1 = {}
    with torch.no_grad():
        for samples in (SERVE_BATCH, (1 << 20) // 3):
            args = coupling_inputs(flow, torch.randn(samples, D, generator=gen).to(dev))
            args[0].view(-1)[:4] = torch.tensor([B, -B, B + 0.5, -B - 0.5])
            stress = [args[0], *(torch.randn(t.shape, generator=gen).to(dev)
                                 for t in args[1:])]
            n = args[0].numel()
            log(f"B1 at {n} elements (flagship coupling 1, then N(0,1) parameters):")
            errs = []
            for inverse in (False, True):
                kw = dict(inverse=inverse, tail_bound=B)
                tag = "inverse" if inverse else "forward"
                out, lad = rq_spline.rq_spline_cuda(*args, **kw)
                p_out, p_lad = rq.unconstrained_rational_quadratic_spline_plain(*args, **kw)
                d_out, d_lad = rq.unconstrained_rational_quadratic_spline_plain(
                    *[t.double() for t in args], **kw)
                torch.cuda.synchronize()
                errs.append(hold(f"{tag} out", out, p_out, d_out, 1e-4))
                errs.append(hold(f"{tag} lad", lad, p_lad, d_lad, 1e-3))
                out, lad = rq_spline.rq_spline_cuda(*stress, **kw)
                p_out, p_lad = rq.unconstrained_rational_quadratic_spline_plain(*stress, **kw)
                d_out, d_lad = rq.unconstrained_rational_quadratic_spline_plain(
                    *[t.double() for t in stress], **kw)
                torch.cuda.synchronize()
                hold_exact(f"stress {tag} out", out, p_out, d_out, 1e-2)
                hold_exact(f"stress {tag} lad", lad, p_lad, d_lad, 1e-2)
            run = lambda: rq_spline.rq_spline_cuda(*args, tail_bound=B)  # noqa: E731
            run_plain = lambda: rq.unconstrained_rational_quadratic_spline_plain(  # noqa: E731
                *args, tail_bound=B)
            ms = device_ms(torch, run, 100, kernel="rq_spline_kernel")
            plain_ms = device_ms(torch, run_plain, 10)
            log(f"  a call, events: kernel {call_ms(torch, run, 100):.4f} ms  "
                f"plain {call_ms(torch, run_plain, 10):.4f} ms")
            nbytes = 4 * n * (1 + 2 * K + (K - 1) + 2)  # x, widths, heights, derivs; out, lad
            nops = n * (12 * K + 60)                     # compares, exps, sums, RQ evaluation
            bound_ms = 1e3 * max(nbytes / PEAK_BYTES, nops / PEAK_FP32_FLOPS)
            bound_by = "bytes" if nbytes / PEAK_BYTES >= nops / PEAK_FP32_FLOPS else "operations"
            log(f"  time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.5f} ms "
                f"({bound_by})")
            b1[n] = dict(err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)

    # -- phase 4: B2 against its plain version (full-width flagship) -----------
    fused = fuse_nsf(flow)
    static, idx = fused._static, fused._indices
    w32 = fused._weights
    w64 = {k: v.double() for k, v in w32.items()}
    L, H = FLAGSHIP["num_layers"], FLAGSHIP["hidden_features"]
    Tid, T = len(idx[0].id_idx), len(idx[0].tr_idx)
    TM = T * (3 * K - 1)
    nb = FLAGSHIP["num_blocks_per_layer"]
    weight_bytes = 4 * sum(v.numel() for v in w32.values())
    b2 = {}
    for n in (SERVE_BATCH, 1 << 16):
        x = torch.randn(n, D, generator=gen).to(dev)
        log(f"B2 at N={n}:")
        errs = []
        for inverse in (False, True):
            kw = dict(inverse=inverse, **static)
            y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(x, w32, idx, packed=fused._packed, **kw)
            p_y, p_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, w32, idx, **kw)
            d_y, d_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x.double(), w64, idx, **kw)
            torch.cuda.synchronize()
            if not (torch.isfinite(y).all() and torch.isfinite(lad).all()):
                raise AssertionError("B2 produced non-finite values")
            tag = "inverse" if inverse else "forward"
            errs.append(hold(f"{tag} out", y, p_y, d_y, 1e-3))
            errs.append(hold(f"{tag} lad", lad, p_lad, d_lad, 1e-3))
        kw = dict(inverse=False, **static)
        run = lambda: nsf_flow_kernel.nsf_flow_kernel_cuda(  # noqa: E731
            x, w32, idx, packed=fused._packed, **kw)
        run_plain = lambda: nsf_flow_kernel.nsf_flow_kernel_plain(x, w32, idx, **kw)  # noqa: E731
        ms = device_ms(torch, run, 10, kernel="nsf_flow_kernel")
        plain_ms = device_ms(torch, run_plain, 5)
        log(f"  a call, events: kernel {call_ms(torch, run, 10):.4f} ms  "
            f"plain {call_ms(torch, run_plain, 5):.4f} ms")
        nops = 2 * n * L * (Tid * H + 2 * nb * H * H + H * TM)
        nbytes = weight_bytes + 4 * n * (2 * D + 1)
        bound_ms = 1e3 * max(nops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if nops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        log(f"  time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
            f"({bound_by}, {nops / 1e9:.1f} GFLOP)  {nops / ms / 1e9:.1f} TFLOP/s")
        b2[n] = dict(err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by)

    # -- phase 5: serving through CompiledFlow ---------------------------------
    x = torch.randn(SERVE_BATCH, D, generator=gen).to(dev)
    served = CompiledFlow(flow, batch_size=SERVE_BATCH, features=D)
    if not served.is_fused:
        raise AssertionError("CompiledFlow did not select the fused kernel")
    unfused = CompiledFlow(flow, batch_size=SERVE_BATCH, features=D, use_fused=False)

    def requests(server, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        lp = server.log_prob(x)
        s = server.sample(g)
        s2, lp2 = server.sample_and_log_prob(g)
        torch.cuda.synchronize()
        return lp, s, s2, lp2

    launches = {}
    for name, server, kernel_of_path in (("fused", served, "B2"), ("unfused", unfused, "B1")):
        rq_spline.launch_count = 0
        nsf_flow_kernel.launch_count = 0
        lp, s, s2, lp2 = requests(server, 1)
        counts = {"B1": rq_spline.launch_count, "B2": nsf_flow_kernel.launch_count}
        log(f"serving ({name}): launches {counts}")
        expected = {"B2": {"B1": 0, "B2": 3}, "B1": {"B1": 3 * L, "B2": 0}}[kernel_of_path]
        if counts != expected:
            raise AssertionError(f"{name} path launched {counts}, expected {expected}")
        launches[kernel_of_path] = counts[kernel_of_path]
        for t, shape in ((lp, (SERVE_BATCH,)), (s, (SERVE_BATCH, D)), (s2, (SERVE_BATCH, D)),
                         (lp2, (SERVE_BATCH,))):
            if tuple(t.shape) != shape or not torch.isfinite(t).all():
                raise AssertionError(f"{name}: bad output {tuple(t.shape)}")
        consistency = max_err(lp2, server.log_prob(s2))
        log(f"  sample_and_log_prob vs log_prob(samples): {consistency:.3e} (limit 5e-3)")
        if consistency > 5e-3:
            raise AssertionError(f"{name}: sample_and_log_prob disagrees with log_prob")
        if name == "fused":
            lp_fused = lp
        else:
            gap = max_err(lp, lp_fused)
            log(f"  unfused vs fused log_prob: {gap:.3e} (limit 1e-3)")
            if gap > 1e-3:
                raise AssertionError("unfused and fused log_prob disagree")
        for endpoint, fn in (("log_prob", lambda: server.log_prob(x)),
                             ("sample", lambda: server.sample(
                                 torch.Generator(device=dev).manual_seed(2)))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 10
            log(f"  {endpoint}: {wall:.3f} ms a request of {SERVE_BATCH} (host clock), "
                f"device busy {device_ms(torch, fn, 10):.3f} ms")

    # -- phase 6: the kernels line ---------------------------------------------
    rows = []
    for kid, stats, source, replaces, tpu in (
            ("B1", b1[SERVE_BATCH * 3], "nflows_tpu_torch/csrc/rq_spline.cu",
             "nflows_tpu/ops/pallas/rq_spline.py:39", "ops/pallas/rq_spline.py:_kernel"),
            ("B2", b2[SERVE_BATCH], "nflows_tpu_torch/csrc/nsf_flow_kernel.cu",
             "nflows_tpu/ops/pallas/nsf_flow_kernel.py:1095",
             "ops/pallas/nsf_flow_kernel.py:_kernel")):
        rows.append({
            "name": {"B1": "rq_spline", "B2": "nsf_flow_kernel"}[kid], "id": kid,
            "route": "cuda", "source": source, "replaces": replaces, "tpu": tpu,
            "launches": launches[kid], "max_abs_err": stats["err"], "max_err": stats["err"],
            "ms": stats["ms"], "kernel_ms": stats["ms"], "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
