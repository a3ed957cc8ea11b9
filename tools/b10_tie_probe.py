"""Look at the samples where B10's input cotangent departs most from the
float64 plain version on chip_smoke.py's full-width NSF-AR (phase 11:
``chip_smoke.NSF_AR``, random weights from seed 0; the inputs at N drawn as
phase 11 draws them at 2,048, from a generator seeded with N), at one block
a tile and at every cluster size, and tell a tie from a precision fault.

    python3 tools/b10_tie_probe.py [--n 2048] [--top 3]

A tie is a sample whose path passes within fp32 rounding of a point where
the chain's gradient jumps: a knot of a layer's spline (the tail bound
counts as one) or a relu's zero. Prints the card line, then one JSON line
for each launch (cluster size 1, 2, 4, 8; 32-sample tiles): the largest
kernel-to-float64 error of gx x N, the fp32 plain version's, and the
samples past the band (5e-3, chip_smoke.py's). Then, for the ``top``
samples by error over all launches, one JSON line each: its error at each
cluster size and the plain version's; each layer's distance from the
transformer's input to the nearest knot and from its MADE's relu inputs to
zero, in float64, beside the fp32 plain chain's drift there; and for each
launch the nearest float64 cotangent at the sample moved by 1e-7, 1e-6 or
1e-5 along one feature (a kernel that landed on the far side of a kink lies
close to one of them). Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nflows_tpu_torch import NeuralSplineFlowAR  # noqa: E402
from nflows_tpu_torch.ops import binning  # noqa: E402
from nflows_tpu_torch.ops.cuda import maf_train  # noqa: E402
from nflows_tpu_torch.ops.splines import rational_quadratic as rq_ref  # noqa: E402

BAND = 5e-3


def layer_paths(x, w, layers, kw):
    """Per layer of the plain chain at x (in x's dtype): the transformer's
    inputs [n, D], its knots [n, D, K + 1] and the MADE's relu inputs
    [n, R]."""
    spline, relu = rq_ref.linear_tails_spline, torch.relu
    K, B = kw["spline_kw"]["num_bins"], kw["spline_kw"]["tail_bound"]
    seen, relus = [], []

    def spy_spline(xp, uw, *args):
        widths = binning.normalize_bins(uw, K, kw["spline_kw"]["min_bin_width"])
        seen.append((xp, 2 * B * binning.unit_knots(widths) - B, torch.cat(relus, 1)))
        relus.clear()
        return spline(xp, uw, *args)

    def spy_relu(t):
        relus.append(t)
        return relu(t)

    rq_ref.linear_tails_spline, torch.relu = spy_spline, spy_relu
    try:
        maf_train.maf_train_bwd_plain(x, torch.zeros_like(x), torch.zeros_like(x[:, 0]), w,
                                      layers, **kw)
    finally:
        rq_ref.linear_tails_spline, torch.relu = spline, relu
    return seen


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--top", type=int, default=3)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev, n = torch.device("cuda", 0), args.n
    flow = NeuralSplineFlowAR(**chip_smoke.NSF_AR, generator=torch.Generator().manual_seed(0),
                              rng=np.random.default_rng(0), device=dev).eval()
    tr = maf_train.FusedMAFTrainer(flow, chip_smoke.TRAIN_BATCH)
    w = {k: v.detach().contiguous() for k, v in tr._fold(tr.weights).items()}
    w64 = {k: v.double() for k, v in w.items()}
    kw = dict(wh_scale=tr._wh_scale, **tr._static)
    D = chip_smoke.NSF_AR["features"]
    draw = torch.Generator().manual_seed(n)
    x = (1.5 * torch.randn(n, D, generator=draw)).to(dev)
    gy = (torch.randn(n, D, generator=draw) / n).to(dev)
    glad = (torch.randn(n, generator=draw) / n).to(dev)
    p_gx, _ = maf_train.maf_train_bwd_plain(x, gy, glad, w, tr._layers, **kw)
    d_gx, _ = maf_train.maf_train_bwd_plain(x.double(), gy.double(), glad.double(), w64,
                                            tr._layers, **kw)
    plain_err = ((p_gx.double() - d_gx).abs() * n).amax(1)
    errs, got = {}, {}
    for c in (1, *maf_train.CLUSTER_SIZES):
        gx, _ = maf_train.maf_train_bwd_cuda(x, gy, glad, w, tr._layers, rows=32, cluster=c,
                                             **kw)
        got[c] = gx
        errs[c] = ((gx.double() - d_gx).abs() * n).amax(1)
        past = (errs[c] > BAND).nonzero()[:, 0].tolist()
        print(json.dumps({"cluster_size": c, "n": n, "gx_max_err": float(errs[c].max()),
                          "gx_plain_max_err": float(plain_err.max()), "past_band": past}),
              flush=True)
    worst = torch.stack(list(errs.values())).amax(0).argsort(descending=True)[:args.top]
    paths64 = layer_paths(x.double(), w64, tr._layers, kw)
    backward = lambda *a, **c: maf_train.maf_train_bwd_plain(  # noqa: E731
        *a, w64, tr._layers, **c, **kw)
    paths32 = layer_paths(x, w, tr._layers, kw)
    for s in worst.tolist():
        layers = []
        for (t64, k64, r64), (t32, k32, r32) in zip(paths64, paths32):
            dist = (t64[s, :, None] - k64[s]).abs()
            f, j = divmod(int(dist.argmin()), dist.shape[1])
            r = int(r64[s].abs().argmin())
            layers.append(dict(
                knot_distance=float(dist[f, j]), feature=f, knot=j,
                fp32_drift=float(((t32[s, f] - k32[s, f, j]).double()
                                  - (t64[s, f] - k64[s, f, j])).abs()),
                relu_margin=float(r64[s, r].abs()), relu_unit=r,
                relu_fp32_drift=float((r32[s, r].double() - r64[s, r]).abs())))
        nearest = {}
        for step in chip_smoke.TIE_STEPS:
            here, _ = chip_smoke.moved_cotangents(backward, x[s:s + 1], gy[s:s + 1],
                                                  glad[s:s + 1], step)
            nearest[str(step)] = {
                "largest_move": float(((here - d_gx[s]).abs() * n).amax()),
                **{str(c): float(((here - got[c][s].double()).abs() * n).amax(1).min())
                   for c in got}}
        print(json.dumps({
            "sample": s, "gx_err": {str(c): float(e[s]) for c, e in errs.items()},
            "gx_plain_err": float(plain_err[s]), "gx_value": float((d_gx[s] * n).abs().max()),
            "layers": layers, "nearest_moved": nearest}), flush=True)


if __name__ == "__main__":
    main()
