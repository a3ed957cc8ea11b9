"""How far a window of fused flagship steps (B3) drifts from the same steps
run one by one, under Adam and under SGD, against how far the per-step
loop drifts from a twin of itself.

    python3 tools/b3_window_drift.py [--out FILE]

B3 adds its gradient partial sums with atomics, so two launches on the same
inputs differ in the last bits of the gradients. For each optimizer (Adam
at 3e-4, capturable; SGD at 1e-3 and 1e-2, and at 1e-3 with momentum 0.9,
each fused) and each batch (512 and 4,096), twice: a trainer runs three
windows of 40 steps (``make_scan_train_step``) on chip_smoke.py's flagship
(random weights from seed 0) and seeded data; before each window a twin and
a third trainer take its weights and optimizer state, and each runs the
same 40 steps one by one. Prints for each window whether the first loss is
bit-equal, the largest loss gap of the window to the loop over the first 16
and over all 40 steps, the same for the third trainer against the loop (the
spread of the loop itself), and the loop's first and last loss; writes all
of it as JSON to ``--out``. Needs the card; builds B3's two sources only.
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

FLAGSHIP = dict(features=6, hidden_features=256, num_layers=10,
                num_blocks_per_layer=2, num_bins=8, tail_bound=3.0)
STEPS = 40


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "b3_window_drift.json"))
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from nflows_tpu_torch.ops.cuda import _build

    every = _build._sources
    _build._sources = lambda: [p for p in every() if p.stem.startswith("nsf_train")]
    from nflows_tpu_torch import NeuralSplineFlow, fused_trainer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    flow = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                            rng=np.random.default_rng(0), device=dev, **FLAGSHIP)
    d = FLAGSHIP["features"]
    mix = (torch.randn(d, d, generator=torch.Generator().manual_seed(0)) / d ** 0.5).to(dev)

    def batches(n):
        g = torch.Generator(device=dev).manual_seed(31)
        return torch.stack([1.5 * torch.randn(n, d, generator=g, device=dev) @ mix + 0.5
                            for _ in range(STEPS)])

    def copy_state(dst, dst_opt, src, src_opt):
        with torch.no_grad():
            for k in src.weights:
                dst.weights[k].copy_(src.weights[k])
                for key, v in src_opt.state[src.weights[k]].items():
                    dst_opt.state[dst.weights[k]][key].copy_(v)

    def gap(a, b):
        return float((a - b).abs().max())

    optimizers = {
        "adam 3e-4": lambda p: torch.optim.Adam(p, lr=3e-4, capturable=True),
        "sgd 1e-3": lambda p: torch.optim.SGD(p, lr=1e-3, fused=True),
        "sgd 1e-2": lambda p: torch.optim.SGD(p, lr=1e-2, fused=True),
        "sgd 1e-3 momentum 0.9": lambda p: torch.optim.SGD(p, lr=1e-3, momentum=0.9,
                                                           fused=True),
    }
    found = {}
    for name, make in optimizers.items():
        for n in (512, 4096):
            data = batches(n)
            for rep in range(2):
                trainers = [fused_trainer(copy.deepcopy(flow), n) for _ in range(3)]
                opts_ = [t.init_opt(make) for t in trainers]
                steps = trainers[0].make_scan_train_step(opts_[0])
                loop, twin = (t.make_train_step(o) for t, o in zip(trainers[1:], opts_[1:]))
                rows = []
                for w in range(3):
                    for t, o in zip(trainers[1:], opts_[1:]):
                        if w:
                            copy_state(t, o, trainers[0], opts_[0])
                    win = steps(data)
                    ref = torch.stack([loop(x) for x in data])
                    other = torch.stack([twin(x) for x in data])
                    rows.append(dict(window=w, first_eq=bool(win[0] == ref[0]),
                                     head16=gap(win[:16], ref[:16]), all=gap(win, ref),
                                     twin_head16=gap(other[:16], ref[:16]),
                                     twin_all=gap(other, ref), l0=float(ref[0]),
                                     l_last=float(ref[-1]),
                                     finite=bool(torch.isfinite(win).all())))
                key = f"{name}, n={n}, repeat {rep}"
                found[key] = rows
                print(key, " | ".join(
                    f"window {r['window']}: first bit-equal {r['first_eq']}, window "
                    f"{r['head16']:.1e} / {r['all']:.1e}, twin {r['twin_head16']:.1e} / "
                    f"{r['twin_all']:.1e}, loss {r['l0']:.3f} -> {r['l_last']:.3f}"
                    for r in rows), flush=True)
                del steps, loop, twin, trainers, opts_
    pathlib.Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(opts.out).write_text(json.dumps(found, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
