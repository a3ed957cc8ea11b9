"""Look at the samples where B4's input cotangents depart most from the
float64 plain version, on the small flows of ``tests/test_torch_cuda.py``
(``_context_flow``: 4 layers, hidden 32, 8 bins; context 3, and its
unconditional twin from the same seed), and tell a tie from a precision
fault.

    python3 tools/tie_probe.py [--family cubic] [--n 4096] [--seeds 0 1] [--top 3]
    python3 tools/tie_probe.py --held

A tie is a sample whose path passes within fp32 rounding of a point where
the chain's gradient jumps (a relu's zero, a knot, the tail bound). For each
run (flow seed s, data seed n + 5 + s, drawn as the test draws them) this
prints one JSON line: the largest kernel-to-float64 error of gx x N and
gctx x N and the fp32 plain version's, the count past 2e-4, and for the
``top`` samples the error, the value, the plain version's error, each
layer's distance from a transformed input to its nearest knot and the
smallest |input| of its conditioner's relus (float64; relu_unit counts
block by block, two relus of H a block), the fp32 plain chain's drift from
float64 at each, and how far the float64 cotangents move when x moves by
1e-6 along one feature (large where a kink lies that close). Needs the
card.

With ``--held`` it probes instead the tie that chip_smoke.py holds
(``chip_smoke.TIE_X``: one sample of the cubic chain at the flagship's
widths, random weights from seed 0, its cotangents scaled by
``chip_smoke.TIE_N``): B4 at one block a tile and at every cluster size,
and the same per-sample report, with the float64 cotangents' move at steps
of 1e-7, 1e-6 and 1e-5 and, for each kernel, the nearest float64
cotangent at the sample moved by 1e-6 along one feature.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import chip_smoke  # noqa: E402

import torch  # noqa: E402
from test_torch_cuda import _context_flow, _train_args  # noqa: E402

from nflows_tpu_torch.ops import binning  # noqa: E402
from nflows_tpu_torch.ops.cuda import nsf_flow_kernel, nsf_train  # noqa: E402

BAND = 2e-4
STEP = 1e-6


def layer_stages(x, w, idx, ctx, kw):
    """Per layer, the plain chain's transformed inputs [n, T], parameters
    [n, T, M] and the inputs of its conditioner's relus [n, 2 nb H], in x's
    dtype."""
    seen, relus, stage, relu = [], [], nsf_flow_kernel._stage, torch.relu

    def spy(transform, P, *args, **kwargs):
        seen.append((transform, P, torch.cat(relus, 1)))
        relus.clear()
        return stage(transform, P, *args, **kwargs)

    def spy_relu(t):
        relus.append(t)
        return relu(t)

    nsf_flow_kernel._stage, torch.relu = spy, spy_relu
    try:
        with torch.no_grad():
            nsf_flow_kernel.nsf_flow_kernel_plain(x, w, idx, inverse=False, context=ctx, **kw)
    finally:
        nsf_flow_kernel._stage, torch.relu = stage, relu
    return seen


def knot_distance(transform, P, kw):
    """|input - nearest knot| [n, T]; the tail bound counts as a knot."""
    K, B = kw["num_bins"], kw["tail_bound"]
    if kw["spline"] == "linear":
        widths = torch.full(P.shape[:-1] + (K,), 1.0 / K, dtype=P.dtype, device=P.device)
    else:
        widths = binning.normalize_bins(P[..., :K], K, kw["min_bin_width"])
    knots = 2 * B * binning.unit_knots(widths) - B
    return (transform[..., None] - knots).abs().amin(-1)


def cotangents(x, gy, glad, w, idx, ctx, kw):
    gx, grads = nsf_train.nsf_train_bwd_plain(x, gy, glad, w, idx, context=ctx, **kw)
    return gx, grads.get("ctx")


def moved_cotangents(x, gy, glad, w64, idx, ctx64, kw, step):
    """The float64 cotangents (gx, and gctx where there is a context) of one
    sample (rows [1, .]) moved by -step, +step along each feature in turn
    (``chip_smoke.moved_cotangents``): [2 D, .] each."""
    gx, grads = chip_smoke.moved_cotangents(
        lambda *a, **c: nsf_train.nsf_train_bwd_plain(*a, w64, idx, **c, **kw),
        x, gy, glad, step, ctx64)
    return gx, grads.get("ctx")


def probe(s, x, gy, glad, w, idx, ctx, kw, d, n):
    """Sample s's path through the chain: for each layer its transformed
    input's distance to the nearest knot and its conditioner's smallest
    |relu input| in float64, the fp32 chain's drift at each, and how far
    the float64 cotangents x n (``d``) move when x moves by STEP along one
    feature."""
    w64 = {k: v.detach().double() for k, v in w.items()}
    ctx64 = None if ctx is None else ctx.double()
    stages = layer_stages(x.double(), w64, idx, ctx64, kw)
    stages32 = layer_stages(x, {k: v.detach() for k, v in w.items()}, idx, ctx, kw)
    layers = []
    for (t64, P64, r64), (t32, _, r32) in zip(stages, stages32):
        dist = knot_distance(t64[s:s + 1], P64[s:s + 1], kw)[0]
        f, r = int(dist.argmin()), int(r64[s].abs().argmin())
        layers.append(dict(knot_distance=float(dist[f]),
                           fp32_drift=float((t32[s, f].double() - t64[s, f]).abs()),
                           relu_margin=float(r64[s, r].abs()), relu_unit=r,
                           relu_fp32_drift=float((r32[s, r].double() - r64[s, r]).abs())))
    here = moved_cotangents(x[s:s + 1], gy[s:s + 1], glad[s:s + 1], w64, idx,
                            None if ctx64 is None else ctx64[s:s + 1], kw, STEP)
    names = ["gx"] + (["gctx"] if ctx is not None else [])
    jump = {k: float(((a - b[s:s + 1]).abs() * n).amax()) for k, a, b in zip(names, here, d)}
    return dict(moved_1e6=jump, layers=layers)


def run(family, n, seed, context, top, dev=torch.device("cuda", 0)):
    flow = _context_flow(dev, family, context=context, seed=seed)
    g = torch.Generator().manual_seed(n + 5 + seed)
    x = (1.5 * torch.randn(n, 6, generator=g)).to(dev)
    c = torch.randn(n, 3, generator=g).to(dev)
    ctx = c if context else None
    tr = nsf_train.FusedNSFTrainer(flow, 128)
    (w, idx), kw = _train_args(tr)
    w64 = {k: v.detach().double() for k, v in w.items()}
    gy = torch.randn(n, 6, generator=g).to(dev) / n
    glad = torch.randn(n, generator=g).to(dev) / n
    gx, grads = nsf_train.nsf_train_bwd_cuda(x, gy, glad, w, idx, context=ctx, **kw)
    p = cotangents(x, gy, glad, w, idx, ctx, kw)
    ctx64 = None if ctx is None else ctx.double()
    d = cotangents(x.double(), gy.double(), glad.double(), w64, idx, ctx64, kw)
    names = ["gx"] + (["gctx"] if context else [])
    got = [gx, grads.get("ctx")]
    err = {k: ((a.double() - b).abs() * n).amax(1) for k, a, b in zip(names, got, d)}
    err_plain = {k: ((a.double() - b).abs() * n).amax(1) for k, a, b in zip(names, p, d)}
    worst = sum(err.values()).argsort(descending=True)[:top].tolist()
    samples = [dict(
        sample=s, **{f"{k}_err": float(err[k][s]) for k in names},
        **{f"{k}_plain_err": float(err_plain[k][s]) for k in names},
        **{f"{k}_value": float((d[i][s] * n).abs().amax()) for i, k in enumerate(names)},
        **probe(s, x, gy, glad, w, idx, ctx, kw, d, n)) for s in worst]
    others = torch.ones(n, dtype=torch.bool, device=dev)
    others[worst] = False
    return dict(
        family=family, n=n, flow_seed=seed, context=context,
        **{f"{k}_max_err": float(err[k].max()) for k in names},
        **{f"{k}_plain_max_err": float(err_plain[k].max()) for k in names},
        **{f"{k}_past_band": int((err[k] > BAND).sum()) for k in names},
        **{f"{k}_max_err_of_the_rest": float(err[k][others].max()) for k in names},
        samples=samples)


def held(dev=torch.device("cuda", 0)):
    """The tie chip_smoke.py holds, probed as ``run`` probes a sample, with
    B4's error at one block a tile and at every cluster size."""
    tr = nsf_train.FusedNSFTrainer(chip_smoke.family_flow("cubic", dev, seed=0),
                                   chip_smoke.TRAIN_BATCH)
    (w, idx), kw = _train_args(tr)
    w64 = {k: v.detach().double() for k, v in w.items()}
    n = chip_smoke.TIE_N
    row = lambda vs: torch.tensor([[float.fromhex(v) for v in vs]], device=dev)  # noqa: E731
    x, gy, glad = row(chip_smoke.TIE_X), row(chip_smoke.TIE_GY), row([chip_smoke.TIE_GLAD])[0]
    d = cotangents(x.double(), gy.double(), glad.double(), w64, idx, None, kw)
    p = cotangents(x, gy, glad, w, idx, None, kw)
    moves = {step: ((moved_cotangents(x, gy, glad, w64, idx, None, kw, step)[0] - d[0]).abs()
                    * n).amax(1) for step in (1e-7, STEP, 1e-5)}
    here = moved_cotangents(x, gy, glad, w64, idx, None, kw, STEP)[0]
    kernels = {}
    for c in (1, *nsf_train.CLUSTER_SIZES):
        gx, _ = nsf_train.nsf_train_bwd_cuda(x, gy, glad, w, idx, rows=32, cluster=c, **kw)
        near = ((here - gx.double()).abs() * n).amax(1)
        e = int(near.argmin())
        kernels[c] = dict(err=float(((gx.double() - d[0]).abs() * n).max()),
                          nearest_moved=dict(feature=e // 2, step=STEP if e % 2 else -STEP,
                                             distance=float(near[e])))
    return dict(family="cubic", n=n, held=True,
                gx_plain_err=float(((p[0].double() - d[0]).abs() * n).max()),
                gx_value=float((d[0] * n).abs().max()),
                largest_move={str(k): float(v.max()) for k, v in moves.items()},
                kernels=kernels, **probe(0, x, gy, glad, w, idx, None, kw, d, n))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", default="cubic")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--top", type=int, default=3)
    ap.add_argument("--held", action="store_true", help="probe chip_smoke.py's held tie")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.held:
        print(json.dumps(held()), flush=True)
        return
    for seed in args.seeds:
        for context in (3, None):
            print(json.dumps(run(args.family, args.n, seed, context, args.top)), flush=True)


if __name__ == "__main__":
    main()
