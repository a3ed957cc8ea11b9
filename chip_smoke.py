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
forward). Then the autoregressive family at full width (features 10,
hidden 256, 5 layers x 2 blocks, ReversePermutation, no context): the
whole-chain kernel B9 and its backward B10 against their plain versions on
a MAF (affine), an NSF-AR (rq, 8 bins) and a wrapped IAF chain; the MAF and
the NSF-AR served through ``CompiledFlow`` fused (B9, one launch a request)
and unfused; the MAF trained for 20 Adam steps on the fused route
(``fused_trainer``: B9 forward and B10 backward a step) and the eager one.
Then the mixture-density family at full width (a MixtureOfGaussiansMADE of
features 10, hidden 256, 2 blocks, 10 components, and its conditional twin,
a MADEMoG with context 10): the log-prob kernel B11 and its backward B12
against their plain versions; both models served through ``CompiledFlow``
fused (B11, one launch a log_prob request; sampling is the model's
sequential sampler) and unfused; both trained for 20 Adam steps on the
fused route (B11 forward and B12 backward a step) and the eager one.
Every phase raises on failure, so the exit code is non-zero. Each report
line starts with the seconds since the script began.

Prints, before the last line, the card's name and power limit, a JSON
line ``{"kernels": [...]}`` with each kernel's launches on the main path
(a serving request for B1, B2, B9 and B11, a train step for B3, B4, B10 and
B12),
error against its plain version, device time (``ms_source`` says whether
torch.profiler or CUDA events gave it), plain time, bound and library time at
the main path's shape; the last line is
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
B9 forward: 1e-3 on outputs and logabsdet, as B2. B9 where it runs the fixed
point (the inverse of a MAF or NSF-AR, the forward of an IAF): 5e-3, because
each of the D + 1 MADE passes of a layer feeds its fp32 rounding into the
next through D features and every layer, so two fp32 evaluations in
different summation orders drift apart; the float64 plain version bounds
that drift (the kernel may be no further from it than twice the plain fp32
version is), and the round trip forward(inverse(z)) must return within 5e-3
of z and of -logabsdet: the plain version bounds the arithmetic, float64 the
rounding, the round trip the fixed point itself. Those absolute tolerances
are held on MAF and IAF chains whose final MADE weights are scaled by 0.1.
The MAF as initialised is held too, by relative error: there the sampling
direction is ill-conditioned (samples of N(0, 1) noise reach 1e18, and the
plain fp32 version is itself up to 2e-2 relative from float64), so the
per-sample relative error against float64, |a - f64| / (1 + |f64|), the
largest over a sample's features, is compared between kernel and plain
version: the kernel's median and 90th percentile over the batch may be at
most twice the plain version's, its 99th percentile at most four times and
its maximum at most ten times. The quantiles are what separates a fault at
extreme scales from rounding: over four seeds the kernel's median and 90th
percentile were 1.1 to 1.5 times the plain version's (a 256-term sum in one
fp32 accumulator against cuBLAS's blocked sums) and its 99th percentile 1.0
to 1.9 times. The maximum is one sample's rounding at the largest condition
number, and the ratio of two such draws spreads: 0.6 to 3.5 over the same
seeds, hence ten. B9 with 32- against
64-sample tiles: 1e-5, a sample's arithmetic does not depend on its tile.
B10: as B4 (gradient stacks
2e-4, gx x N 5e-3). Masked weights after 20 Adam steps: bit-equal.
B11: 1e-3 on lp, as B2 (fp32 GEMMs in another order than cuBLAS, then a
logsumexp a feature summed over 10 features). B12: as B10, and gctx x N
5e-3 like gx x N.

Bounds. ``bound_ms`` is the larger of the bytes a function must move over
3.35 TB/s and the fp32 operations it needs over 67 TFLOP/s. For B9 and B10
the operations are counted from the MADE masks of the model in the run: two
for every weight a mask leaves, once a sample for B9 in either direction
(the autoregressive inverse needs each hidden unit and each parameter once,
when the features before it are known), three times for B10. The kernels
multiply the masked zeros too, and B9's inverse runs D + 1 full passes a
layer; ``schedule_ms`` is that dense count at the same peak rate. B11 and
B12 count the same way: two FLOP for every MADE weight the masks leave and
every context weight, once a sample for B11 and three times for B12; their
rows carry the conditional twin's numbers as ``context_*``.
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
# the autoregressive family at full width: MAF (affine) and NSF-AR (rq)
MAF = dict(features=10, hidden_features=256, num_layers=5, num_blocks_per_layer=2)
NSF_AR = dict(**MAF, num_bins=8, tail_bound=3.0)
# the mixture-density family: "a typical neural-density-estimation config"
# (benchmarks/bench_fused_mademog.py), and its conditional twin
MOG = dict(features=10, hidden_features=256, num_blocks=2, num_mixture_components=10)
MOG_CONTEXT = 10


_START = time.perf_counter()


def log(*args):
    """A line of the run's report, after the seconds since the script began."""
    print(f"[{time.perf_counter() - _START:6.1f} s]", *args, flush=True)


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
    kernels it runs (those whose name contains ``kernel``, of which ``fn``
    launches one a call; or all), from torch.profiler's CUDA trace. Falls
    back to :func:`call_ms` if the trace holds no device time or not every
    launch of the named kernel. ``device_ms.source`` says which of the two
    the last reading came from: ``"profiler"`` or ``"events"``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the trace can lose the records nearest its ends: pad both with a
        # one-element fill, so that what is lost is the padding
        pad.zero_()
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        pad.zero_()
        torch.cuda.synchronize()
    total_us, seen = 0.0, 0
    for evt in prof.key_averages():
        if kernel is None or kernel in evt.key:
            total_us += getattr(evt, "self_device_time_total", 0.0) or 0.0
            seen += evt.count
    if total_us <= 0.0 or (kernel is not None and seen != iters):
        log(f"  (the profiler's trace is incomplete: {seen} records of {kernel or 'any kernel'} "
            f"for {iters} calls; timing with CUDA events)")
        device_ms.source = "events"
        return call_ms(torch, fn, iters)
    device_ms.source = "profiler"
    return total_us / 1e3 / iters


def host_ops(fn, iters=10, top=8):
    """Where the host's time goes in ``fn``: the operations with the most
    self CPU time over ``iters`` calls, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            fn()
    events = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    total = sum(e.self_cpu_time_total for e in events) / 1e3 / iters
    log(f"  host time of a call, by operation ({total:.3f} ms of self CPU time a call in "
        "all, under the profiler):")
    for e in events[:top]:
        log(f"    {e.key}: {e.self_cpu_time_total / 1e3 / iters:.3f} ms, "
            f"{e.count // iters} a call")


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


def hold_relative(torch, name, kernel, plain32, plain64):
    """Hold a kernel to its plain version where values span many orders of
    magnitude and both fp32 evaluations are far from float64 (see the module
    doc): per-sample relative errors against float64, the kernel's quantiles
    against the plain version's."""
    def quantiles(t):
        e = (t.double() - plain64).abs() / (1.0 + plain64.abs())
        e = e.reshape(e.shape[0], -1).max(dim=1).values
        q = torch.quantile(e, torch.tensor([0.5, 0.9, 0.99], dtype=e.dtype, device=e.device))
        return [*q.tolist(), float(e.max())]

    k, p = quantiles(kernel), quantiles(plain32)
    limits = (2.0, 2.0, 4.0, 10.0)
    ok = all(a <= f * b for a, b, f in zip(k, p, limits))
    fmt = lambda v: " ".join(f"{x:.2e}" for x in v)  # noqa: E731
    log(f"  {name}, relative error against f64 (median, 90%, 99%, max): kernel {fmt(k)}  "
        f"plain {fmt(p)}  limits x2 x2 x4 x10  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the kernel's error is not the plain version's rounding")
    return k, p


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
        InverseAutoregressiveFlow,
        MADEMoG,
        MaskedAutoregressiveFlow,
        MixtureOfGaussiansMADE,
        NeuralSplineFlow,
        NeuralSplineFlowAR,
        create_train_state,
        fused_trainer,
        make_train_step,
    )
    from nflows_tpu_torch.ops.cuda import (
        _build,
        mademog_fused,
        mademog_train,
        maf_flow_kernel,
        maf_train,
        nsf_flow_kernel,
        nsf_train,
        rq_spline,
    )
    from nflows_tpu_torch.ops.cuda.maf_fused import _extract as extract_maf
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf
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
            ms_source = device_ms.source
            plain_ms = device_ms(torch, run_plain, 10)
            log(f"  a call, events: kernel {call_ms(torch, run, 100):.4f} ms  "
                f"plain {call_ms(torch, run_plain, 10):.4f} ms")
            nbytes = 4 * n * (1 + 2 * K + (K - 1) + 2)  # x, widths, heights, derivs; out, lad
            nops = n * (12 * K + 60)                     # compares, exps, sums, RQ evaluation
            bound_ms = 1e3 * max(nbytes / PEAK_BYTES, nops / PEAK_FP32_FLOPS)
            bound_by = "bytes" if nbytes / PEAK_BYTES >= nops / PEAK_FP32_FLOPS else "operations"
            log(f"  time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.5f} ms "
                f"({bound_by})")
            b1[n] = dict(err=max(errs), ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)

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
        ms_source = device_ms.source
        plain_ms = device_ms(torch, run_plain, 5)
        log(f"  a call, events: kernel {call_ms(torch, run, 10):.4f} ms  "
            f"plain {call_ms(torch, run_plain, 5):.4f} ms")
        nops = 2 * n * L * (Tid * H + 2 * nb * H * H + H * TM)
        nbytes = weight_bytes + 4 * n * (2 * D + 1)
        bound_ms = 1e3 * max(nops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if nops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        log(f"  time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
            f"({bound_by}, {nops / 1e9:.1f} GFLOP)  {nops / ms / 1e9:.1f} TFLOP/s")
        b2[n] = dict(err=max(errs), ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by)

    # -- phase 5: serving through CompiledFlow ---------------------------------
    def reset_counts():
        rq_spline.launch_count = 0
        nsf_flow_kernel.launch_count = 0
        nsf_train.loss_grad_launch_count = 0
        nsf_train.bwd_launch_count = 0
        maf_flow_kernel.launch_count = 0
        maf_train.bwd_launch_count = 0
        mademog_fused.launch_count = 0
        mademog_train.bwd_launch_count = 0

    def read_counts():
        return {"B1": rq_spline.launch_count, "B2": nsf_flow_kernel.launch_count,
                "B3": nsf_train.loss_grad_launch_count, "B4": nsf_train.bwd_launch_count,
                "B9": maf_flow_kernel.launch_count, "B10": maf_train.bwd_launch_count,
                "B11": mademog_fused.launch_count, "B12": mademog_train.bwd_launch_count}

    def expect_counts(what, counts, **expected):
        expected = {**dict(B1=0, B2=0, B3=0, B4=0, B9=0, B10=0, B11=0, B12=0), **expected}
        if counts != expected:
            raise AssertionError(f"{what} launched {counts}, expected {expected}")

    launches = {}

    def serve(model, flow, features, fused_kernel, unfused_log_prob, unfused_sample,
              fused_sample=None, context_features=None):
        """Serve ``flow`` through CompiledFlow on both paths: a log_prob
        request, then the two sampling requests, with the launches of each
        counted from zero; ``fused_kernel`` must run once a fused log_prob
        request and ``fused_sample`` (default: twice) in the two sampling
        requests, and the unfused path must launch exactly
        ``unfused_log_prob`` / ``unfused_sample`` a request. A conditional
        model is served one sample a context row."""
        x = torch.randn(SERVE_BATCH, features, generator=gen).to(dev)
        ctx = (None if context_features is None
               else torch.randn(SERVE_BATCH, context_features, generator=gen).to(dev))
        kw = dict(batch_size=SERVE_BATCH, features=features, context_features=context_features,
                  num_samples=None if ctx is None else 1)
        served = CompiledFlow(flow, **kw)
        if not served.is_fused:
            raise AssertionError(f"{model}: CompiledFlow did not select the fused kernel")
        unfused = CompiledFlow(flow, use_fused=False, **kw)
        lp_fused = None
        for name, server in (("fused", served), ("unfused", unfused)):
            g = torch.Generator(device=dev).manual_seed(1)
            reset_counts()
            lp = server.log_prob(x, ctx)
            torch.cuda.synchronize()
            first = read_counts()
            reset_counts()
            s = server.sample(g, ctx).reshape(SERVE_BATCH, features)
            s2, lp2 = server.sample_and_log_prob(g, ctx)
            s2, lp2 = s2.reshape(SERVE_BATCH, features), lp2.reshape(SERVE_BATCH)
            torch.cuda.synchronize()
            rest = read_counts()
            log(f"serving {model} ({name}): launches a request {first}, two more requests "
                f"{rest}")
            if name == "fused":
                expect_counts(f"one fused {model} request", first, **{fused_kernel: 1})
                expect_counts(f"two fused {model} requests", rest,
                              **(fused_sample or {fused_kernel: 2}))
                launches.setdefault(fused_kernel, first[fused_kernel])
            else:
                expect_counts(f"one unfused {model} request", first, **unfused_log_prob)
                expect_counts(f"two unfused {model} requests", rest,
                              **{k: 2 * v for k, v in unfused_sample.items()})
                for kid in unfused_log_prob:
                    launches.setdefault(kid, first[kid])
            for t, shape in ((lp, (SERVE_BATCH,)), (s, (SERVE_BATCH, features)),
                             (s2, (SERVE_BATCH, features)), (lp2, (SERVE_BATCH,))):
                if tuple(t.shape) != shape or not torch.isfinite(t).all():
                    raise AssertionError(f"{model} {name}: bad output {tuple(t.shape)}")
            consistency = max_err(lp2, server.log_prob(s2, ctx))
            log(f"  sample_and_log_prob vs log_prob(samples): {consistency:.3e} (limit 5e-3)")
            if consistency > 5e-3:
                raise AssertionError(
                    f"{model} {name}: sample_and_log_prob disagrees with log_prob")
            if name == "fused":
                lp_fused = lp
            else:
                gap = max_err(lp, lp_fused)
                log(f"  unfused vs fused log_prob: {gap:.3e} (limit 1e-3)")
                if gap > 1e-3:
                    raise AssertionError(f"{model}: unfused and fused log_prob disagree")
            for endpoint, fn in (("log_prob", lambda: server.log_prob(x, ctx)),  # noqa: B023
                                 ("sample", lambda: server.sample(  # noqa: B023
                                     torch.Generator(device=dev).manual_seed(2), ctx))):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / 10
                # the unfused path's profile holds thousands of launches a call:
                # fewer calls keep its cost to the run down
                busy = device_ms(torch, fn, 10 if name == "fused" else 3)
                log(f"  {endpoint}: {wall:.3f} ms a request of {SERVE_BATCH} (host clock), "
                    f"device busy {busy:.3f} ms")

    serve("NSF", flow, D, "B2", dict(B1=L), dict(B1=L))

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
        ms_source = device_ms.source
        plain_ms = device_ms(torch, run_plain, 3)
        nbytes = weight_bytes + grad_bytes + 4 * n * (D + 1)
        bound_ms = 1e3 * max(nops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if nops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        log(f"  time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
            f"({bound_by}, {nops / 1e9:.1f} GFLOP)  {nops / ms / 1e9:.1f} TFLOP/s")
        b3[n] = dict(err=max(errs), ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by)

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
        ms_source = device_ms.source
        plain_ms = device_ms(torch, run_plain, 3)
        nbytes = weight_bytes + grad_bytes + 4 * n * (3 * D + 1)
        bound_ms = 1e3 * max(nops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if nops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        log(f"  time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
            f"({bound_by}, {nops / 1e9:.1f} GFLOP)  {nops / ms / 1e9:.1f} TFLOP/s")
        b4[n] = dict(err=max(errs), ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by)

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
            # an eager step is some thousand launches: three profiled steps
            busy = device_ms(torch, lambda: step(data[0]),  # noqa: B023
                             3 if name == "eager" else 10)
            step_ms[(name, n)] = wall
            log(f"  batch {n} {name}: {wall:.3f} ms a step ({1e3 / wall:.1f} steps/s), "
                f"device busy {busy:.3f} ms, idle {100 * max(0.0, 1 - busy / wall):.0f}%")
        repack = device_ms(torch, lambda: fused_tr._repack(fused_tr.weights), 20)  # noqa: B023
        log(f"  batch {n}: re-packing the weights for the forward GEMMs {repack:.4f} ms a step")
    faster = [n for n in (TRAIN_BATCH, 2048, SERVE_BATCH)
              if step_ms[("fused", n)] < step_ms[("eager", n)]]
    log(f"  fused faster than eager at batches {faster}; fused_trainer(auto=True) takes the "
        f"fused route from batch {MIN_AUTO_BATCH['nsf']}")

    # -- phase 9: B9 against its plain version (full-width MAF and NSF-AR) ---------
    def bound(nops, nbytes):
        by_ops = nops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES
        return (1e3 * max(nops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES),
                "operations" if by_ops else "bytes")

    seeded = lambda seed: dict(generator=torch.Generator().manual_seed(seed),  # noqa: E731
                               rng=np.random.default_rng(seed), device=dev)

    def tame(ar_flow, factor=0.1):
        """Scale the final MADE layer's weights of every affine AR layer. At
        the library's initialisation a full-width MAF's fixed point on N(0, 1)
        noise is ill-conditioned: a large early feature drives the later
        scales toward 1e-3, and the samples reach 1e13, where absolute errors
        mean nothing. A trained flow's inverse maps noise to data; smaller
        final weights give the random model that conditioning."""
        with torch.no_grad():
            for t in ar_flow.transform.transforms:
                net = getattr(getattr(t, "transform", t), "autoregressive_net", None)
                if net is not None:
                    net.final_layer.weight.mul_(factor)
        return ar_flow.eval()

    raw_maf = MaskedAutoregressiveFlow(**MAF, **seeded(0)).eval()
    maf = tame(MaskedAutoregressiveFlow(**MAF, **seeded(0)))
    nsf_ar = NeuralSplineFlowAR(**NSF_AR, **seeded(0)).eval()
    iaf = tame(InverseAutoregressiveFlow(**MAF, use_random_permutations=True, **seeded(1)))
    DA, HA, LA = MAF["features"], MAF["hidden_features"], MAF["num_layers"]
    nba = MAF["num_blocks_per_layer"]
    RAGGED = SERVE_BATCH - 95   # leaves a last tile of one sample
    LARGE_BATCH = 1 << 16
    default_rows = maf_flow_kernel.tile_rows(
        LARGE_BATCH, DA, HA, 2 * DA, torch.cuda.get_device_properties(dev).multi_processor_count)

    def masked_ops(n, ar_flow):
        """fp32 FLOP that one MADE pass of every layer needs on n samples:
        two for each weight the masks leave (about 55% of the matrices)."""
        masks = extract_maf(ar_flow, torch.float32, return_masks=True)[-1]
        return 2 * n * sum(int(m.sum()) for m in masks.values())

    def dense_ops(n, P):
        """fp32 FLOP of the same pass as the kernels run it: the folded
        weights' structural zeros are multiplied like any other entry."""
        return 2 * n * LA * (DA * HA + 2 * nba * HA * HA + HA * P)

    # the MAF as initialised, the configuration a user builds: its sampling
    # direction on N(0, 1) noise, held by relative error
    view = fuse_maf(raw_maf)
    x = torch.randn(SERVE_BATCH, DA, generator=gen).to(dev)
    kw = dict(inverse=True, num_blocks=view._num_blocks, transformer=view._transformer,
              spline_kw=view._spline_kw)
    y, lad = maf_flow_kernel.maf_flow_kernel_cuda(
        x, view._weights, view._static, packed=view._packed, **kw)
    p_y, p_lad = maf_flow_kernel.maf_flow_kernel_plain(x, view._weights, view._static, **kw)
    d_y, d_lad = maf_flow_kernel.maf_flow_kernel_plain(
        x.double(), {k: v.double() for k, v in view._weights.items()}, view._static, **kw)
    torch.cuda.synchronize()
    log(f"B9 on the MAF as initialised, inverse of N(0, 1) noise at N={SERVE_BATCH}: largest "
        f"|sample| {float(d_y.abs().max()):.3e}")
    if not (torch.isfinite(y).all() and torch.isfinite(lad).all()):
        raise AssertionError("B9 produced non-finite values on the MAF as initialised")
    hold_relative(torch, "inverse out", y, p_y, d_y)
    hold_relative(torch, "inverse lad", lad, p_lad, d_lad)

    b9 = {}
    for model, ar_flow in (("MAF", maf), ("NSF-AR", nsf_ar), ("IAF", iaf)):
        view = fuse_maf(ar_flow)
        w32 = view._weights
        w64 = {k: v.double() for k, v in w32.items()}
        skw = dict(num_blocks=view._num_blocks, transformer=view._transformer,
                   spline_kw=view._spline_kw)
        P = w32["wf"].shape[0] // LA
        ar_bytes = 4 * sum(v.numel() for v in w32.values())
        need = masked_ops(1, ar_flow)
        for n in ((SERVE_BATCH,) if model == "IAF" else (SERVE_BATCH, RAGGED)):
            x = torch.randn(n, DA, generator=gen).to(dev)
            log(f"B9 on {model} at N={n}:")
            errs = {}
            for inverse in (False, True):
                kw = dict(inverse=inverse, **skw)
                y, lad = maf_flow_kernel.maf_flow_kernel_cuda(
                    x, w32, view._static, packed=view._packed, **kw)
                p_y, p_lad = maf_flow_kernel.maf_flow_kernel_plain(x, w32, view._static, **kw)
                d_y, d_lad = maf_flow_kernel.maf_flow_kernel_plain(
                    x.double(), w64, view._static, **kw)
                torch.cuda.synchronize()
                if not (torch.isfinite(y).all() and torch.isfinite(lad).all()):
                    raise AssertionError("B9 produced non-finite values")
                tag = "inverse" if inverse else "forward"
                fixed_point = inverse != (model == "IAF")
                tol = 5e-3 if fixed_point else 1e-3
                errs[tag] = max(hold(f"{tag} out", y, p_y, d_y, tol),
                                hold(f"{tag} lad", lad, p_lad, d_lad, tol))
                back, lad_back = maf_flow_kernel.maf_flow_kernel_cuda(
                    y, w32, view._static, packed=view._packed, **{**kw, "inverse": not inverse})
                trip = max(max_err(back, x), max_err(lad_back, -lad))
                log(f"  {tag} then back: {trip:.3e} from the input (limit 5e-3)")
                if trip > 5e-3:
                    raise AssertionError(f"B9 {model}: the round trip does not close")
            if model == "IAF" or n != SERVE_BATCH:
                continue
            stats = dict(err=errs["forward"], inverse_err=errs["inverse"])
            for inverse in (False, True):
                kw = dict(inverse=inverse, **skw)
                run = lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
                    x, w32, view._static, packed=view._packed, **kw)
                run_plain = lambda: maf_flow_kernel.maf_flow_kernel_plain(  # noqa: E731
                    x, w32, view._static, **kw)
                ms = device_ms(torch, run, 10, kernel="maf_flow_kernel")
                ms_source = device_ms.source
                plain_ms = device_ms(torch, run_plain, 3)
                log(f"  a call, events: kernel {call_ms(torch, run, 10):.4f} ms  "
                    f"plain {call_ms(torch, run_plain, 3):.4f} ms")
                # the bound counts what the function needs: the weights the
                # masks leave, once. That holds for the inverse too: feature k
                # depends on the features before it alone, so every hidden unit
                # and every parameter can be computed once, when its inputs are
                # known, and the logabsdet comes from the same parameters. The
                # kernel runs D + 1 dense passes a layer instead.
                nops = n * need
                run_ops = dense_ops(n, P) * ((DA + 1) if inverse else 1)
                io_bytes = ar_bytes + 4 * n * (2 * DA + 1)
                bound_ms, bound_by = bound(nops, io_bytes)
                tag = "inverse" if inverse else "forward"
                log(f"  {tag} time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
                    f"{bound_ms:.4f} ms ({bound_by}, {nops / 1e9:.2f} GFLOP needed); the "
                    f"kernel's schedule multiplies {run_ops / 1e9:.1f} GFLOP "
                    f"({bound(run_ops, io_bytes)[0]:.4f} ms at the peak rate), "
                    f"{run_ops / ms / 1e9:.1f} TFLOP/s")
                pre = "inverse_" if inverse else ""
                stats.update({pre + "ms": ms, pre + "ms_source": ms_source,
                              pre + "plain_ms": plain_ms,
                              pre + "bound_ms": bound_ms, pre + "bound_by": bound_by,
                              pre + "schedule_ms": bound(run_ops, io_bytes)[0]})
                if inverse:
                    # the tile-size diagnostic: 64-sample tiles halve the weight
                    # traffic of the fixed point but fill half the SMs here
                    ref_y, ref_lad = run()
                    for rows in (32, 64):
                        tiled = lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
                            x, w32, view._static, packed=view._packed, rows=rows, **kw)  # noqa: B023
                        t = device_ms(torch, tiled, 10, kernel="maf_flow_kernel")
                        t_y, t_lad = tiled()
                        gap = max(max_err(t_y, ref_y), max_err(t_lad, ref_lad))
                        log(f"    inverse with {rows}-sample tiles: {t:.4f} ms, {gap:.3e} from "
                            "the default tile's result (limit 1e-5)")
                        if gap > 1e-5:
                            raise AssertionError(f"B9 {model}: the result depends on the tile")
            xt = x[:TRAIN_BATCH].contiguous()
            ms512 = device_ms(torch, lambda: maf_flow_kernel.maf_flow_kernel_cuda(
                xt, w32, view._static, packed=view._packed, inverse=False, **skw), 10,
                kernel="maf_flow_kernel")
            log(f"  forward at N={TRAIN_BATCH}: kernel {ms512:.4f} ms  bound "
                f"{bound(TRAIN_BATCH * need, ar_bytes)[0]:.4f} ms")
            # the wrapper's own choice of tile at a large batch: 64 samples,
            # once that gives every SM a tile, against 32
            xl = torch.randn(LARGE_BATCH, DA, generator=gen).to(dev)
            for inverse in (False, True):
                times = {}
                for rows in (32, None):
                    tiled = lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
                        xl, w32, view._static, packed=view._packed, rows=rows,  # noqa: B023
                        inverse=inverse, **skw)  # noqa: B023
                    times[rows] = device_ms(torch, tiled, 3, kernel="maf_flow_kernel")
                tag = "inverse" if inverse else "forward"
                log(f"  {tag} at N={LARGE_BATCH}: 32-sample tiles {times[32]:.4f} ms, the "
                    f"default ({default_rows}-sample tiles) {times[None]:.4f} ms, bound "
                    f"{bound(LARGE_BATCH * need, ar_bytes)[0]:.4f} ms")
                stats[f"{tag}_ms_at_{LARGE_BATCH}"] = {"rows_32": times[32],
                                                      f"rows_{default_rows}": times[None]}
            b9[model] = stats

    # -- phase 10: serving the autoregressive flows through CompiledFlow ------------
    # the unfused MAF launches no kernel of the port (its transformer is plain
    # tensor code); the unfused NSF-AR runs B1 once a MADE pass: LA a log_prob,
    # LA x DA a sampling request
    serve("MAF", maf, DA, "B9", {}, {})
    serve("NSF-AR", nsf_ar, DA, "B9", dict(B1=LA), dict(B1=LA * DA))

    # -- phase 11: B10 against its plain version (full-width MAF and NSF-AR) --------
    b10 = {}
    mstacks = maf_train.WEIGHT_KEYS
    for model, ar_flow in (("MAF", maf), ("NSF-AR", nsf_ar)):
        mtr = fused_trainer(ar_flow, TRAIN_BATCH)
        if not isinstance(mtr, maf_train.FusedMAFTrainer):
            raise AssertionError(f"fused_trainer gave {type(mtr).__name__} for {model}")
        f32 = {k: v.detach().contiguous() for k, v in mtr._fold(mtr.weights).items()}
        f64 = {k: v.double() for k, v in f32.items()}
        mkw = dict(wh_scale=mtr._wh_scale, **mtr._static)
        P = mtr._dims["P"]
        ar_bytes = 4 * sum(v.numel() for v in f32.values())
        need = masked_ops(1, ar_flow)
        mpacked = maf_flow_kernel.pack_weights(f32, mtr._layers, nba)
        for n in (TRAIN_BATCH, SERVE_BATCH):
            log(f"B10 on {model} at N={n}:")
            x = (1.5 * torch.randn(n, DA, generator=gen)).to(dev)
            gy = (torch.randn(n, DA, generator=gen) / n).to(dev)
            glad = (torch.randn(n, generator=gen) / n).to(dev)
            gx, grads = maf_train.maf_train_bwd_cuda(x, gy, glad, f32, mtr._layers, **mkw)
            p_gx, p_grads = maf_train.maf_train_bwd_plain(x, gy, glad, f32, mtr._layers, **mkw)
            d_gx, d_grads = maf_train.maf_train_bwd_plain(
                x.double(), gy.double(), glad.double(), f64, mtr._layers, **mkw)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in (gx, *grads.values())):
                raise AssertionError("B10 produced non-finite values")
            log(f"  largest |gx * N|: {float((d_gx * n).abs().max()):.3f}")
            errs = [hold("gx * N", gx * n, p_gx * n, d_gx * n, 5e-3)]
            errs += [hold(f"g{k}", grads[k], p_grads[k], d_grads[k], 2e-4) for k in mstacks]
            run = lambda: maf_train.maf_train_bwd_cuda(  # noqa: E731
                x, gy, glad, f32, mtr._layers, packed=mpacked, grads=grads, **mkw)
            run_plain = lambda: maf_train.maf_train_bwd_plain(  # noqa: E731
                x, gy, glad, f32, mtr._layers, **mkw)
            ms = device_ms(torch, run, 10, kernel="maf_train_bwd_kernel")
            ms_source = device_ms.source
            plain_ms = device_ms(torch, run_plain, 3)
            # recompute, input cotangents and weight gradients, each over the
            # weights the masks leave; the kernel runs the three dense
            nops = 3 * n * need
            run_ops = 3 * dense_ops(n, P)
            io_bytes = 2 * ar_bytes + 4 * n * (3 * DA + 1)
            bound_ms, bound_by = bound(nops, io_bytes)
            log(f"  time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by}, {nops / 1e9:.2f} GFLOP needed); the kernel's schedule multiplies "
                f"{run_ops / 1e9:.1f} GFLOP ({bound(run_ops, io_bytes)[0]:.4f} ms at the peak "
                f"rate), {run_ops / ms / 1e9:.1f} TFLOP/s")
            b10[(model, n)] = dict(err=max(errs), ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   schedule_ms=bound(run_ops, io_bytes)[0])

    # -- phase 12: training the MAF on the card ----------------------------------------
    mix_a = torch.randn(DA, DA, generator=gen).to(dev) / DA ** 0.5

    def maf_batches(n, count, seed):
        """Seeded synthetic data: correlated Gaussian features in 10 dimensions."""
        g = torch.Generator(device=dev).manual_seed(seed)
        return [1.5 * torch.randn(n, DA, generator=g, device=dev) @ mix_a + 0.5
                for _ in range(count)]

    def maf_routes(n):
        fused_tr = fused_trainer(copy.deepcopy(maf), n)
        state = create_train_state(copy.deepcopy(maf).train(), adam)
        eager_step = make_train_step()
        steps = {"fused": fused_tr.make_train_step(fused_tr.init_opt(adam)),
                 "eager": lambda batch: eager_step(state, batch)[1]["loss"]}
        return steps, fused_tr, state

    steps, fused_tr, state = maf_routes(TRAIN_BATCH)
    start = {k: v.detach().clone() for k, v in fused_tr.weights.items()}
    data = maf_batches(TRAIN_BATCH, TRAIN_STEPS, seed=6)
    losses = {}
    for name, expected in (("fused", dict(B9=1, B10=1)), ("eager", {})):
        reset_counts()
        first = steps[name](data[0])
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"training MAF ({name}): launches a step {counts}")
        expect_counts(f"one {name} MAF step", counts, **expected)
        if name == "fused":
            launches["B10"] = counts["B10"]
        rest = [steps[name](batch) for batch in data[1:]]
        losses[name] = [float(v) for v in [first, *rest]]
        log(f"  {TRAIN_STEPS} Adam steps (lr 3e-4, batch {TRAIN_BATCH}): loss "
            f"{losses[name][0]:.4f} -> {losses[name][-1]:.4f}")
        if not all(np.isfinite(losses[name])) or not losses[name][-1] < losses[name][0]:
            raise AssertionError(f"MAF {name}: the loss is not finite and falling: "
                                 f"{losses[name]}")
    gap = max(abs(a - b) for a, b in zip(losses["fused"][:3], losses["eager"][:3]))
    log(f"  first three losses, fused vs eager: {gap:.3e} apart (limit 2e-3)")
    if gap > 2e-3:
        raise AssertionError("the fused and eager MAF routes disagree at the start")
    for k in maf_train.MASKED_KEYS:
        dead = fused_tr._masks[k] == 0
        moved = not torch.equal(fused_tr.weights[k].detach()[dead], start[k][dead])
        live = not torch.equal(fused_tr.weights[k].detach()[~dead], start[k][~dead])
        log(f"  {k}: {int(dead.sum())} masked entries bit-equal after {TRAIN_STEPS} steps: "
            f"{not moved}; the others moved: {live}")
        if moved or not live:
            raise AssertionError(f"MAF {k}: masked entries moved, or nothing trained")
    held = maf_batches(TRAIN_BATCH, 1, seed=7)[0]
    trained = fused_tr.to_flow().eval()
    served_lp = CompiledFlow(trained, batch_size=TRAIN_BATCH, features=DA).log_prob(held)
    with torch.no_grad():
        y, lad = fused_tr._apply(fused_tr.weights, held)
        trainer_lp = -0.5 * (y * y).sum(dim=1) - 0.5 * DA * np.log(2 * np.pi) + lad
    gap = max_err(served_lp, trainer_lp)
    log(f"  to_flow() served through CompiledFlow vs the trainer's log_prob: {gap:.3e} "
        "(limit 1e-3)")
    if gap > 1e-3:
        raise AssertionError("the trained MAF served disagrees with the trainer")
    log(f"  fused-trained vs eager-trained log_prob after {TRAIN_STEPS} steps: "
        f"{max_err(served_lp, state.flow.log_prob(held).detach()):.3e}")

    log("MAF train step times (host clock over 20 steps ending in a synchronise; device "
        "busy from torch.profiler):")
    maf_step_ms = {}
    for n in (TRAIN_BATCH, 2048, SERVE_BATCH):
        steps, fused_tr, _ = maf_routes(n)
        data = maf_batches(n, 4, seed=8)
        for name, step in steps.items():
            for batch in data[:3]:
                step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(20):
                step(data[i % 4])
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 20
            busy = device_ms(torch, lambda: step(data[0]),  # noqa: B023
                             3 if name == "eager" else 10)
            maf_step_ms[(name, n)] = wall
            log(f"  batch {n} {name}: {wall:.3f} ms a step ({1e3 / wall:.1f} steps/s), "
                f"device busy {busy:.3f} ms, idle {100 * max(0.0, 1 - busy / wall):.0f}%")
        fold = device_ms(torch, lambda: fused_tr._repack(  # noqa: B023
            fused_tr._fold(fused_tr.weights)), 20)
        log(f"  batch {n}: folding the masks and re-packing the weights {fold:.4f} ms a step")
    faster = [n for n in (TRAIN_BATCH, 2048, SERVE_BATCH)
              if maf_step_ms[("fused", n)] < maf_step_ms[("eager", n)]]
    log(f"  fused faster than eager at batches {faster}; fused_trainer(auto=True) takes the "
        f"fused route from batch {MIN_AUTO_BATCH['maf']}")


    # -- phase 13: B11 against its plain version (full-width MADEMoG) ------------------
    mog = MixtureOfGaussiansMADE(**MOG, **seeded(0)).eval()
    mog_ctx = MADEMoG(**MOG, context_features=MOG_CONTEXT, custom_initialization=True,
                      **seeded(1)).eval()
    DM = MOG["features"]
    mog_models = (("MoG-MADE", mog, None), ("MADEMoG, context", mog_ctx, MOG_CONTEXT))

    def mog_ops(model, n):
        """fp32 FLOP of one MADE pass on n samples: the weights the masks
        leave and every context weight (``need``), and the dense count the
        kernels run (``dense``), two for each."""
        weights, _, cf, masks = mademog_fused._extract(model, torch.float32, return_masks=True)
        ctx_weights = sum(weights[k].numel() for k in ("wci", "wcb") if cf)
        dense = sum(weights[k].numel() for k in ("wi", "wb", "wf")) + ctx_weights
        need = sum(int(m.sum()) for m in masks.values()) + ctx_weights
        return 2 * n * need, 2 * n * dense

    b11 = {}
    for model, dist, cf in mog_models:
        view = mademog_fused.fuse_mademog(dist)
        w32 = view._weights
        w64 = {k: v.double() for k, v in w32.items()}
        mog_bytes = 4 * sum(v.numel() for v in w32.values())
        for n in (SERVE_BATCH, LARGE_BATCH, RAGGED):
            x = (1.5 * torch.randn(n, DM, generator=gen)).to(dev)
            c = None if cf is None else torch.randn(n, cf, generator=gen).to(dev)
            log(f"B11 on the {model} at N={n}:")
            lp = mademog_fused.mademog_log_prob_cuda(x, w32, view._static, c,
                                                     packed=view._packed)
            p_lp = mademog_fused.mademog_log_prob_plain(x, w32, view._static, c)
            d_lp = mademog_fused.mademog_log_prob_plain(
                x.double(), w64, view._static, None if c is None else c.double())
            torch.cuda.synchronize()
            if not torch.isfinite(lp).all():
                raise AssertionError("B11 produced non-finite values")
            err = hold("lp", lp, p_lp, d_lp, 1e-3)
            if n == RAGGED:
                continue
            run = lambda: mademog_fused.mademog_log_prob_cuda(  # noqa: E731
                x, w32, view._static, c, packed=view._packed)  # noqa: B023
            run_plain = lambda: mademog_fused.mademog_log_prob_plain(  # noqa: E731
                x, w32, view._static, c)  # noqa: B023
            ms = device_ms(torch, run, 10, kernel="mademog_log_prob_kernel")
            ms_source = device_ms.source
            plain_ms = device_ms(torch, run_plain, 5)
            need, dense = mog_ops(dist, n)
            io_bytes = mog_bytes + 4 * n * (DM + (cf or 0) + 1)
            bound_ms, bound_by = bound(need, io_bytes)
            log(f"  time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by}, {need / 1e9:.2f} GFLOP needed); the kernel's schedule "
                f"multiplies {dense / 1e9:.2f} GFLOP ({bound(dense, io_bytes)[0]:.4f} ms at "
                f"the peak rate), {dense / ms / 1e9:.1f} TFLOP/s")
            b11[(model, n)] = dict(err=err, ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   schedule_ms=bound(dense, io_bytes)[0])

    # -- phase 14: serving the mixture-density models through CompiledFlow ------------
    # log_prob is one B11 launch; sample runs the model's sequential sampler
    # (no kernel of the port) and sample_and_log_prob adds one B11 for the
    # samples' log_prob; the unfused path is cuBLAS only
    serve("MoG-MADE", mog, DM, "B11", {}, {}, fused_sample=dict(B11=1))
    serve("MADEMoG, context", mog_ctx, DM, "B11", {}, {}, fused_sample=dict(B11=1),
          context_features=MOG_CONTEXT)

    # -- phase 15: B12 against its plain version (full-width MADEMoG) -------------------
    b12 = {}
    gstacks = mademog_fused.WEIGHT_KEYS + mademog_fused.CONTEXT_KEYS
    for model, dist, cf in mog_models:
        mtr = fused_trainer(dist, TRAIN_BATCH)
        if not isinstance(mtr, mademog_train.FusedMADEMoGTrainer):
            raise AssertionError(f"fused_trainer gave {type(mtr).__name__} for the {model}")
        f32 = {k: v.detach().contiguous() for k, v in mtr._fold(mtr.weights).items()}
        f64 = {k: v.double() for k, v in f32.items()}
        mpacked = mademog_fused.pack_weights(f32, mtr._static)
        mog_bytes = 4 * sum(v.numel() for v in f32.values())
        for n in (TRAIN_BATCH, SERVE_BATCH, RAGGED):
            log(f"B12 on the {model} at N={n}:")
            x = (1.5 * torch.randn(n, DM, generator=gen)).to(dev)
            c = None if cf is None else torch.randn(n, cf, generator=gen).to(dev)
            glp = (torch.randn(n, generator=gen) / n).to(dev)
            gx, gctx, grads = mademog_train.mademog_train_bwd_cuda(x, glp, f32, mtr._static, c)
            p_gx, p_gctx, p_grads = mademog_train.mademog_train_bwd_plain(
                x, glp, f32, mtr._static, c)
            d_gx, d_gctx, d_grads = mademog_train.mademog_train_bwd_plain(
                x.double(), glp.double(), f64, mtr._static, None if c is None else c.double())
            torch.cuda.synchronize()
            outs = [gx, *grads.values()] + ([] if gctx is None else [gctx])
            if not all(torch.isfinite(t).all() for t in outs):
                raise AssertionError("B12 produced non-finite values")
            log(f"  largest |gx * N|: {float((d_gx * n).abs().max()):.3f}")
            errs = [hold("gx * N", gx * n, p_gx * n, d_gx * n, 5e-3)]
            if cf is not None:
                errs.append(hold("gctx * N", gctx * n, p_gctx * n, d_gctx * n, 5e-3))
            errs += [hold(f"g{k}", grads[k], p_grads[k], d_grads[k], 2e-4)
                     for k in gstacks if k in grads]
            if n == RAGGED:
                continue
            run = lambda: mademog_train.mademog_train_bwd_cuda(  # noqa: E731
                x, glp, f32, mtr._static, c, packed=mpacked, grads=grads)  # noqa: B023
            run_plain = lambda: mademog_train.mademog_train_bwd_plain(  # noqa: E731
                x, glp, f32, mtr._static, c)  # noqa: B023
            ms = device_ms(torch, run, 10, kernel="mademog_train_bwd_kernel")
            ms_source = device_ms.source
            plain_ms = device_ms(torch, run_plain, 3)
            # recompute, input cotangents and weight gradients, each over the
            # weights the masks leave and the context weights; the kernel runs
            # the three dense
            need, dense = (3 * v for v in mog_ops(dist, n))
            io_bytes = 2 * mog_bytes + 4 * n * (2 * DM + 2 * (cf or 0) + 1)
            bound_ms, bound_by = bound(need, io_bytes)
            log(f"  time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by}, {need / 1e9:.2f} GFLOP needed); the kernel's schedule "
                f"multiplies {dense / 1e9:.2f} GFLOP ({bound(dense, io_bytes)[0]:.4f} ms at "
                f"the peak rate), {dense / ms / 1e9:.1f} TFLOP/s")
            b12[(model, n)] = dict(err=max(errs), ms=ms, ms_source=ms_source,
                                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                   schedule_ms=bound(dense, io_bytes)[0])

    # -- phase 16: training the mixture-density models on the card --------------------
    mix_c = torch.randn(MOG_CONTEXT, DM, generator=gen).to(dev) / MOG_CONTEXT ** 0.5

    def mog_batches(n, count, seed, cf):
        """Seeded synthetic data: the MAF's correlated features, shifted by a
        linear function of a N(0, 1) context where the model has one."""
        g = torch.Generator(device=dev).manual_seed(seed)
        out = []
        for x in maf_batches(n, count, seed):
            c = None if cf is None else torch.randn(n, cf, generator=g, device=dev)
            out.append((x if c is None else x + c @ mix_c, c))
        return out

    def mog_routes(dist, n):
        fused_tr = fused_trainer(copy.deepcopy(dist), n)
        state = create_train_state(copy.deepcopy(dist).train(), adam)
        eager_step = make_train_step()
        fused_step = fused_tr.make_train_step(fused_tr.init_opt(adam))
        steps = {"fused": lambda batch: fused_step(*batch),
                 "eager": lambda batch: eager_step(state, *batch)[1]["loss"]}
        return steps, fused_tr, state

    mog_step_ms = {}
    for model, dist, cf in mog_models:
        steps, fused_tr, state = mog_routes(dist, TRAIN_BATCH)
        start = {k: v.detach().clone() for k, v in fused_tr.weights.items()}
        data = mog_batches(TRAIN_BATCH, TRAIN_STEPS, 9, cf)
        losses = {}
        for name, expected in (("fused", dict(B11=1, B12=1)), ("eager", {})):
            reset_counts()
            first = steps[name](data[0])
            torch.cuda.synchronize()
            counts = read_counts()
            log(f"training the {model} ({name}): launches a step {counts}")
            expect_counts(f"one {name} {model} step", counts, **expected)
            if name == "fused":
                launches.setdefault("B12", counts["B12"])
            rest = [steps[name](batch) for batch in data[1:]]
            losses[name] = [float(v) for v in [first, *rest]]
            log(f"  {TRAIN_STEPS} Adam steps (lr 3e-4, batch {TRAIN_BATCH}): loss "
                f"{losses[name][0]:.4f} -> {losses[name][-1]:.4f}")
            if not all(np.isfinite(losses[name])) or not losses[name][-1] < losses[name][0]:
                raise AssertionError(f"{model} {name}: the loss is not finite and falling: "
                                     f"{losses[name]}")
        gap = max(abs(a - b) for a, b in zip(losses["fused"][:3], losses["eager"][:3]))
        log(f"  first three losses, fused vs eager: {gap:.3e} apart (limit 2e-3)")
        if gap > 2e-3:
            raise AssertionError(f"the fused and eager {model} routes disagree at the start")
        for k in mademog_fused.MASKED_KEYS:
            dead = fused_tr._masks[k] == 0
            moved = not torch.equal(fused_tr.weights[k].detach()[dead], start[k][dead])
            live = not torch.equal(fused_tr.weights[k].detach()[~dead], start[k][~dead])
            log(f"  {k}: {int(dead.sum())} masked entries bit-equal after {TRAIN_STEPS} "
                f"steps: {not moved}; the others moved: {live}")
            if moved or not live:
                raise AssertionError(f"{model} {k}: masked entries moved, or nothing trained")
        held, held_c = mog_batches(TRAIN_BATCH, 1, 10, cf)[0]
        trained = fused_tr.to_dist().eval()
        served_lp = CompiledFlow(trained, batch_size=TRAIN_BATCH, features=DM,
                                 context_features=cf).log_prob(held, held_c)
        with torch.no_grad():
            trainer_lp = fused_tr._apply(fused_tr.weights, held, held_c)
        gap = max_err(served_lp, trainer_lp)
        log(f"  to_dist() served through CompiledFlow vs the trainer's log_prob: {gap:.3e} "
            "(limit 1e-3)")
        if gap > 1e-3:
            raise AssertionError(f"the trained {model} served disagrees with the trainer")
        log(f"  fused-trained vs eager-trained log_prob after {TRAIN_STEPS} steps: "
            f"{max_err(served_lp, state.flow.log_prob(held, held_c).detach()):.3e}")

        log(f"{model} train step times (host clock over 20 steps ending in a synchronise; "
            "device busy from torch.profiler):")
        for n in (TRAIN_BATCH, 2048, SERVE_BATCH):
            steps, fused_tr, _ = mog_routes(dist, n)
            data = mog_batches(n, 4, 11, cf)
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
                mog_step_ms[(model, name, n)] = wall
                log(f"  batch {n} {name}: {wall:.3f} ms a step ({1e3 / wall:.1f} steps/s), "
                    f"device busy {busy:.3f} ms, idle {100 * max(0.0, 1 - busy / wall):.0f}%")
            fold = device_ms(torch, lambda: fused_tr._repack(  # noqa: B023
                fused_tr._fold(fused_tr.weights)), 20)
            log(f"  batch {n}: folding the masks and re-packing the weights {fold:.4f} ms a "
                "step")
            if n == TRAIN_BATCH and cf is None:
                host_ops(lambda: steps["fused"](data[0]))  # noqa: B023
        faster = [n for n in (TRAIN_BATCH, 2048, SERVE_BATCH)
                  if mog_step_ms[(model, "fused", n)] < mog_step_ms[(model, "eager", n)]]
        log(f"  fused faster than eager at batches {faster}; fused_trainer(auto=True) takes "
            f"the fused route from batch {MIN_AUTO_BATCH['mademog']}")

    # -- phase 8: the kernels line ---------------------------------------------
    names = {"B1": "rq_spline", "B2": "nsf_flow_kernel", "B3": "nsf_loss_grad",
             "B4": "nsf_train_bwd", "B9": "maf_flow_kernel", "B10": "maf_train_bwd",
             "B11": "mademog_log_prob", "B12": "mademog_train_bwd"}

    def with_context(stats, ctx_stats, **more):
        """A MADEMoG row: the unconditional model's numbers, the conditional
        twin's beside them."""
        return {**stats, **{f"context_{k}": v for k, v in ctx_stats.items()}, **more}

    uncond, cond = (m for m, _, _ in mog_models)
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
             "ops/pallas/nsf_train.py:_bwd_kernel"),
            ("B9", b9["MAF"], "nflows_tpu_torch/csrc/maf_flow_kernel.cu",
             "nflows_tpu/ops/pallas/maf_flow_kernel.py:99",
             "ops/pallas/maf_flow_kernel.py:_kernel"),
            ("B10", b10[("MAF", TRAIN_BATCH)], "nflows_tpu_torch/csrc/maf_train.cu",
             "nflows_tpu/ops/pallas/maf_train.py:161",
             "ops/pallas/maf_train.py:_bwd_kernel"),
            ("B11", with_context(b11[(uncond, SERVE_BATCH)], b11[(cond, SERVE_BATCH)],
                                 ms_at_65536=b11[(uncond, LARGE_BATCH)]["ms"]),
             "nflows_tpu_torch/csrc/mademog_fused.cu",
             "nflows_tpu/ops/pallas/mademog_fused.py:169",
             "ops/pallas/mademog_fused.py:_kernel"),
            ("B12", with_context(b12[(uncond, TRAIN_BATCH)], b12[(cond, TRAIN_BATCH)],
                                 ms_at_4096=b12[(uncond, SERVE_BATCH)]["ms"]),
             "nflows_tpu_torch/csrc/mademog_train.cu",
             "nflows_tpu/ops/pallas/mademog_train.py:88",
             "ops/pallas/mademog_train.py:_bwd_kernel")):
        rows.append({
            "name": names[kid], "id": kid,
            "route": "cuda", "source": source, "replaces": replaces, "tpu": tpu,
            "launches": launches[kid], "max_abs_err": stats["err"], "max_err": stats["err"],
            "ms": stats["ms"], "kernel_ms": stats["ms"], "ms_source": stats["ms_source"],
            "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
            "library_ms": None,
            **{k: v for k, v in stats.items()
               if k.startswith(("inverse_", "forward_", "schedule_", "context_", "ms_at_"))},
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
