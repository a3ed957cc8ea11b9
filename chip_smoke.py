"""Smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nflows_tpu_torch/csrc`` with nvcc
(sm_90a), holds each against its plain PyTorch version on the card, then
drives the flagship NeuralSplineFlow at full width (features 6, hidden
256, 10 layers x 2 blocks, 8 bins, tail bound 3; random weights from a
fixed seed) through the entry points a user calls. Serving through
``CompiledFlow``: fused (kernel B2, one launch a request) and unfused
(kernel B1 in each of the 10 couplings). Training, 20 Adam steps at batch
512 on both routes: fused (``fused_trainer``: kernel B3, one launch a step;
its composable variant runs B2 forward and B4 backward) and eager
(``make_train_step``: autograd through the unfused chain, ten B1 a
forward). Every phase raises on failure, so the exit code is non-zero.

Prints, before the last line, the card's name and power limit, a JSON
line ``{"kernels": [...]}`` with each kernel's launches on the main path
(a serving request for B1 and B2, a train step for B3 and B4), error
against its plain version, device time, plain time, bound and library time
at the main path's shape; the last line is
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
B3 and B4: log_prob 1e-3 and loss 1e-4 as B2's logabsdet and its mean;
each gradient stack 2e-4 absolute, the bar the JAX package holds its
training kernels to (a weight gradient of the mean loss is a sum over the
batch of fp32 products, taken tile by tile and added with atomics, where
autograd sums in cuBLAS's order); B4's input cotangent 5e-3 after scaling by
N (its cotangents are drawn at scale 1/N, as a mean loss gives them; pulled
back through ten spline layers the scaled values grow well past 1, the run
prints the largest, and the plain fp32 version is itself up to 7e-4 from
float64). Two B3
launches on the same buffers: 1e-5 absolute plus 1e-4 relative, since only
the order of the atomic adds differs. Fused against eager training losses
over the first three steps: 2e-3 (two different fp32 evaluations of an NLL
near 10, then Adam steps whose direction can differ where a gradient is
near zero).
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
TRAIN_BATCH = 512
TRAIN_STEPS = 20
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
    from nflows_tpu_torch import (
        CompiledFlow,
        NeuralSplineFlow,
        create_train_state,
        fused_trainer,
        make_train_step,
    )
    from nflows_tpu_torch.ops.cuda import _build, nsf_flow_kernel, nsf_train, rq_spline
    from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf
    from nflows_tpu_torch.training.fused import MIN_AUTO_BATCH
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
        """log_prob, then the two sampling requests; launches counted
        separately for the first request and for the other two."""
        g = torch.Generator(device=dev).manual_seed(seed)
        reset_counts()
        lp = server.log_prob(x)
        torch.cuda.synchronize()
        first = read_counts()
        reset_counts()
        s = server.sample(g)
        s2, lp2 = server.sample_and_log_prob(g)
        torch.cuda.synchronize()
        return lp, s, s2, lp2, first, read_counts()

    def reset_counts():
        rq_spline.launch_count = 0
        nsf_flow_kernel.launch_count = 0
        nsf_train.loss_grad_launch_count = 0
        nsf_train.bwd_launch_count = 0

    def read_counts():
        return {"B1": rq_spline.launch_count, "B2": nsf_flow_kernel.launch_count,
                "B3": nsf_train.loss_grad_launch_count, "B4": nsf_train.bwd_launch_count}

    def expect_counts(what, counts, **expected):
        expected = {**dict(B1=0, B2=0, B3=0, B4=0), **expected}
        if counts != expected:
            raise AssertionError(f"{what} launched {counts}, expected {expected}")

    launches = {}
    for name, server, kernel_of_path in (("fused", served, "B2"), ("unfused", unfused, "B1")):
        lp, s, s2, lp2, first, rest = requests(server, 1)
        log(f"serving ({name}): launches a request {first}, two more requests {rest}")
        per_request = {"B2": 1, "B1": L}[kernel_of_path]
        expect_counts(f"one {name} request", first, **{kernel_of_path: per_request})
        expect_counts(f"two {name} requests", rest, **{kernel_of_path: 2 * per_request})
        launches[kernel_of_path] = first[kernel_of_path]
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

    # -- phase 6: B3 and B4 against their plain versions (full-width flagship) ----
    trainer = fused_trainer(flow, TRAIN_BATCH)
    tw32 = {k: v.detach() for k, v in trainer.weights.items()}
    tw64 = {k: v.double() for k, v in tw32.items()}
    tkw = dict(wh_scale=trainer._wh_scale, **trainer._static)
    stacks = nsf_train.WEIGHT_KEYS
    grad_bytes = 4 * sum(v.numel() for v in tw32.values())
    b3, b4 = {}, {}
    for n in (TRAIN_BATCH, SERVE_BATCH):
        x = (1.5 * torch.randn(n, D, generator=gen)).to(dev)
        nops = 3 * 2 * n * L * (Tid * H + 2 * nb * H * H + H * TM)
        log(f"B3 at N={n}:")
        loss, lp, grads = nsf_train.nsf_loss_grad_cuda(x, tw32, idx, **tkw)
        p_loss, p_lp, p_grads = nsf_train.nsf_loss_grad_plain(x, tw32, idx, **tkw)
        d_loss, d_lp, d_grads = nsf_train.nsf_loss_grad_plain(x.double(), tw64, idx, **tkw)
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in (loss, lp, *grads.values())):
            raise AssertionError("B3 produced non-finite values")
        errs = [hold("loss", loss, p_loss, d_loss, 1e-4), hold("lp", lp, p_lp, d_lp, 1e-3)]
        errs += [hold(f"g{k}", grads[k], p_grads[k], d_grads[k], 2e-4) for k in stacks]
        first = {k: v.clone() for k, v in grads.items()}
        _, _, again = nsf_train.nsf_loss_grad_cuda(x, tw32, idx, grads=grads, **tkw)
        torch.cuda.synchronize()
        drift = max(max_err(again[k], first[k]) for k in stacks)
        log(f"  a second launch into the same buffers moves a gradient by {drift:.3e} at most "
            "(limit 1e-5 + 1e-4 relative)")
        if not all(torch.allclose(again[k], first[k], atol=1e-5, rtol=1e-4) for k in stacks):
            raise AssertionError("B3: a second launch added to the first one's gradients")
        packed = nsf_flow_kernel.pack_weights(tw32, idx)
        run = lambda: nsf_train.nsf_loss_grad_cuda(  # noqa: E731
            x, tw32, idx, packed=packed, grads=grads, **tkw)
        run_plain = lambda: nsf_train.nsf_loss_grad_plain(x, tw32, idx, **tkw)  # noqa: E731
        ms = device_ms(torch, run, 10, kernel="nsf_loss_grad_kernel")
        plain_ms = device_ms(torch, run_plain, 3)
        nbytes = weight_bytes + grad_bytes + 4 * n * (D + 1)
        bound_ms = 1e3 * max(nops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if nops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        log(f"  time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
            f"({bound_by}, {nops / 1e9:.1f} GFLOP)  {nops / ms / 1e9:.1f} TFLOP/s")
        b3[n] = dict(err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by)

        log(f"B4 at N={n}:")
        gy = (torch.randn(n, D, generator=gen) / n).to(dev)
        glad = (torch.randn(n, generator=gen) / n).to(dev)
        gx, grads = nsf_train.nsf_train_bwd_cuda(x, gy, glad, tw32, idx, **tkw)
        p_gx, p_grads = nsf_train.nsf_train_bwd_plain(x, gy, glad, tw32, idx, **tkw)
        d_gx, d_grads = nsf_train.nsf_train_bwd_plain(
            x.double(), gy.double(), glad.double(), tw64, idx, **tkw)
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in (gx, *grads.values())):
            raise AssertionError("B4 produced non-finite values")
        log(f"  largest |gx * N|: {float((d_gx * n).abs().max()):.3f}")
        errs = [hold("gx * N", gx * n, p_gx * n, d_gx * n, 5e-3)]
        errs += [hold(f"g{k}", grads[k], p_grads[k], d_grads[k], 2e-4) for k in stacks]
        run = lambda: nsf_train.nsf_train_bwd_cuda(  # noqa: E731
            x, gy, glad, tw32, idx, packed=packed, grads=grads, **tkw)
        run_plain = lambda: nsf_train.nsf_train_bwd_plain(  # noqa: E731
            x, gy, glad, tw32, idx, **tkw)
        ms = device_ms(torch, run, 10, kernel="nsf_train_bwd_kernel")
        plain_ms = device_ms(torch, run_plain, 3)
        nbytes = weight_bytes + grad_bytes + 4 * n * (3 * D + 1)
        bound_ms = 1e3 * max(nops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if nops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        log(f"  time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
            f"({bound_by}, {nops / 1e9:.1f} GFLOP)  {nops / ms / 1e9:.1f} TFLOP/s")
        b4[n] = dict(err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by)

    # -- phase 7: the trainers on the card --------------------------------------
    import copy

    adam = lambda params: torch.optim.Adam(params, lr=3e-4)  # noqa: E731
    mix = torch.randn(D, D, generator=gen).to(dev) / D ** 0.5

    def batches(n, count, seed):
        """Seeded synthetic data: correlated Gaussian features, scale 1.5."""
        g = torch.Generator(device=dev).manual_seed(seed)
        return [1.5 * torch.randn(n, D, generator=g, device=dev) @ mix + 0.5
                for _ in range(count)]

    def routes(n):
        """Fresh trainers of the three routes from the flagship's initial
        weights: name -> step(batch) -> loss, and the objects behind them."""
        fused_tr = fused_trainer(copy.deepcopy(flow), n)
        split_tr = fused_trainer(copy.deepcopy(flow), n)
        split_opt = split_tr.init_opt(adam)
        state = create_train_state(copy.deepcopy(flow).train(), adam)
        eager_step = make_train_step()

        def autograd_step(batch):
            # the composable route: loss_fn under autograd, B2 then B4
            split_opt.zero_grad(set_to_none=True)
            loss = split_tr.loss_fn(split_tr.weights, batch)
            loss.backward()
            split_opt.step()
            return loss.detach()

        steps = {
            "fused": fused_tr.make_train_step(fused_tr.init_opt(adam)),
            "fused-autograd": autograd_step,
            "eager": lambda batch: eager_step(state, batch)[1]["loss"],
        }
        return steps, fused_tr, state

    steps, fused_tr, state = routes(TRAIN_BATCH)
    data = batches(TRAIN_BATCH, TRAIN_STEPS, seed=3)
    losses = {}
    for name, expected in (("fused", dict(B3=1)), ("fused-autograd", dict(B2=1, B4=1)),
                           ("eager", dict(B1=L))):
        reset_counts()
        first = steps[name](data[0])
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"training ({name}): launches a step {counts}")
        expect_counts(f"one {name} step", counts, **expected)
        for kid in expected:
            launches.setdefault(kid, counts[kid])
        rest = [steps[name](batch) for batch in data[1:]]
        losses[name] = [float(v) for v in [first, *rest]]
        log(f"  {TRAIN_STEPS} Adam steps (lr 3e-4, batch {TRAIN_BATCH}): loss "
            f"{losses[name][0]:.4f} -> {losses[name][-1]:.4f}")
        if not all(np.isfinite(losses[name])) or not losses[name][-1] < losses[name][0]:
            raise AssertionError(f"{name}: the loss is not finite and falling: {losses[name]}")
    for name in ("fused-autograd", "eager"):
        gap = max(abs(a - b) for a, b in zip(losses["fused"][:3], losses[name][:3]))
        log(f"  first three losses, fused vs {name}: {gap:.3e} apart (limit 2e-3)")
        if gap > 2e-3:
            raise AssertionError(f"the fused and {name} routes disagree at the start")
    held = batches(TRAIN_BATCH, 1, seed=4)[0]
    trained = fused_tr.to_flow().eval()
    served_lp = CompiledFlow(trained, batch_size=TRAIN_BATCH, features=D).log_prob(held)
    _, trainer_lp, _ = nsf_train.nsf_loss_grad_cuda(
        held, fused_tr.weights, fused_tr._indices, wh_scale=fused_tr._wh_scale,
        **fused_tr._static)
    gap = max_err(served_lp, trainer_lp)
    log(f"  to_flow() served through CompiledFlow vs the trainer's log_prob: {gap:.3e} "
        "(limit 1e-3)")
    if gap > 1e-3:
        raise AssertionError("the trained flow served disagrees with the trainer")
    eager_gap = max_err(served_lp, state.flow.log_prob(held).detach())
    log(f"  fused-trained vs eager-trained log_prob after {TRAIN_STEPS} steps: {eager_gap:.3e}")

    log("train step times (host clock over 20 steps ending in a synchronise; device busy "
        "from torch.profiler):")
    step_ms = {}
    for n in (TRAIN_BATCH, 2048, SERVE_BATCH):
        steps, fused_tr, _ = routes(n)
        data = batches(n, 4, seed=5)
        for name, step in steps.items():
            for batch in data[:3]:
                step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(20):
                step(data[i % 4])
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 20
            busy = device_ms(torch, lambda: step(data[0]), 10)  # noqa: B023
            step_ms[(name, n)] = wall
            log(f"  batch {n} {name}: {wall:.3f} ms a step ({1e3 / wall:.1f} steps/s), "
                f"device busy {busy:.3f} ms, idle {100 * max(0.0, 1 - busy / wall):.0f}%")
        repack = device_ms(torch, lambda: fused_tr._repack(fused_tr.weights), 20)  # noqa: B023
        log(f"  batch {n}: re-packing the weights for the forward GEMMs {repack:.4f} ms a step")
    faster = [n for n in (TRAIN_BATCH, 2048, SERVE_BATCH)
              if step_ms[("fused", n)] < step_ms[("eager", n)]]
    log(f"  fused faster than eager at batches {faster}; fused_trainer(auto=True) takes the "
        f"fused route from batch {MIN_AUTO_BATCH['nsf']}")

    # -- phase 8: the kernels line ---------------------------------------------
    rows = []
    for kid, stats, source, replaces, tpu in (
            ("B1", b1[SERVE_BATCH * 3], "nflows_tpu_torch/csrc/rq_spline.cu",
             "nflows_tpu/ops/pallas/rq_spline.py:39", "ops/pallas/rq_spline.py:_kernel"),
            ("B2", b2[SERVE_BATCH], "nflows_tpu_torch/csrc/nsf_flow_kernel.cu",
             "nflows_tpu/ops/pallas/nsf_flow_kernel.py:1095",
             "ops/pallas/nsf_flow_kernel.py:_kernel"),
            ("B3", b3[TRAIN_BATCH], "nflows_tpu_torch/csrc/nsf_train.cu",
             "nflows_tpu/ops/pallas/nsf_train.py:295",
             "ops/pallas/nsf_train.py:_loss_grad_kernel"),
            ("B4", b4[TRAIN_BATCH], "nflows_tpu_torch/csrc/nsf_train.cu",
             "nflows_tpu/ops/pallas/nsf_train.py:163",
             "ops/pallas/nsf_train.py:_bwd_kernel")):
        rows.append({
            "name": {"B1": "rq_spline", "B2": "nsf_flow_kernel", "B3": "nsf_loss_grad",
                     "B4": "nsf_train_bwd"}[kid], "id": kid,
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
