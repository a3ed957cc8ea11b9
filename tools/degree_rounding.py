"""How far each fp32 evaluation of B9's fixed point lies from float64 on the
16,384-sample inputs of tests/test_torch_cuda.py, where the small flows
as initialised send a few samples past 1e3 and rounding is amplified.

    python3 tools/degree_rounding.py [--cpu]

For each case (the MAF's, NSF-AR's and IAF's fixed point, with and
without a context, on the inputs of test_b9_degree_kernel_matches_both_
plain_versions, test_b9_matches_plain and test_b9_with_context_matches_
plain) prints one JSON line: for the degree kernel (the route), the
fixed-point kernel (forced), the degree plain and the fixed-point plain,
all fp32, the largest |y - f64| and |lad - f64| over the samples, the
per-sample relative errors |y - f64| / (1 + |f64|) at the median, 90%,
99% and max, and each one's |y - f64| at the sample where the degree
kernel is furthest; then the largest |degree kernel - plain| of y and lad
for each plain version (the tests' 5e-3 band). ``--cpu`` runs the plain
versions alone (no card)."""

from __future__ import annotations

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

N = 16384


def cases():
    """(name, kind, context features, seed of the inputs) of every
    16,384-sample fixed-point case of the tests."""
    for kind in ("affine", "rq", "iaf"):
        for context in (None, 3):
            yield f"degree_kernel_test/{kind}/ctx{context}", kind, context, N + 7
    for kind in ("affine", "rq", "iaf"):
        yield f"b9_matches_plain/{kind}", kind, None, N
        yield f"b9_with_context/{kind}", kind, 3, N + 2


def main():
    import test_torch_cuda as T

    from nflows_tpu_torch.ops.cuda import maf_flow_kernel as mfk
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    on_card = "--cpu" not in sys.argv[1:]
    if on_card and not torch.cuda.is_available():
        sys.exit("degree_rounding: no CUDA device (pass --cpu for the plain versions alone)")
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    if on_card:
        print(torch.cuda.get_device_name(0), flush=True)
    for name, kind, context, seed in cases():
        flow = T._ar_flow(dev, kind) if context is None else T._cond_ar_flow(dev, kind)
        fused = fuse_maf(flow)
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(N, 5, generator=g).to(dev)
        ctx = None if context is None else torch.randn(N, context, generator=g).to(dev)
        kw = dict(inverse=kind != "iaf", context=ctx, **T._maf_kw(fused))
        w, st = fused._weights, fused._static
        runs = {
            "degree_plain": lambda: mfk.maf_flow_kernel_plain(  # noqa: E731
                x, w, st, schedule="degrees", masks=fused._masks, **kw),
            "fixed_point_plain": lambda: mfk.maf_flow_kernel_plain(x, w, st, **kw),
        }
        if on_card:
            runs["degree_kernel"] = lambda: mfk.maf_flow_kernel_cuda(  # noqa: E731
                x, w, st, packed=fused._packed, schedule="degrees", **kw)
            runs["fixed_point_kernel"] = lambda: mfk.maf_flow_kernel_cuda(  # noqa: E731
                x, w, st, packed=fused._packed, schedule="fixed_point", **kw)
        d_y, d_lad = mfk.maf_flow_kernel_plain(
            x.double(), {k: v.double() for k, v in w.items()}, st,
            **{**kw, "context": None if ctx is None else ctx.double()})
        with torch.no_grad():
            got = {k: run() for k, run in runs.items()}
        worst = int((got.get("degree_kernel", got["degree_plain"])[0].double() - d_y)
                    .abs().max(dim=1).values.argmax())
        line = dict(case=name, largest_abs_f64=float(d_y.abs().max()), worst_sample=worst,
                    worst_sample_abs_f64=float(d_y[worst].abs().max()))
        for k, (y, lad) in got.items():
            e = (y.double() - d_y).abs()
            rel = (e / (1.0 + d_y.abs())).max(dim=1).values
            q = torch.quantile(rel, torch.tensor([0.5, 0.9, 0.99], dtype=rel.dtype,
                                                 device=rel.device))
            line[k] = dict(out=float(e.max()), lad=float((lad.double() - d_lad).abs().max()),
                           rel_quantiles=[*q.tolist(), float(rel.max())],
                           at_worst_sample=float(e[worst].max()))
        if on_card:
            ky, klad = got["degree_kernel"]
            line["degree_kernel_gap"] = {
                k: [float((ky - got[k][0]).abs().max()), float((klad - got[k][1]).abs().max())]
                for k in ("degree_plain", "fixed_point_plain")}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
