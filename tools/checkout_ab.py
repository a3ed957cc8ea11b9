"""A/B two checkouts of the port on one card: the whole-chain kernel B2
(forward and inverse at N = 4,096) and the training kernels B3 (N = 512 and
4,096) and B4 (N = 512) on the full-width flagship NSF, and B2 (forward at
N = 4,096), B3 and B4 (N = 512) on RealNVP at the same widths
(``chip_smoke.realnvp_flow``; random weights from seed 0), and B3 and B4 at
N = 16,384 on the flagship at hidden 128, where they take 64-sample tiles.
All without a context, the paths both sides have.

    python3 tools/checkout_ab.py OLD_CHECKOUT [NEW_CHECKOUT] [--rounds R]

Where ``tools/kernel_ab.py`` swaps one kernel library inside one process
(and needs the same C interface on both sides), this runs each side in a
process of its own, from its own checkout, through the wrappers' Python
interface (``fuse_nsf``, ``nsf_flow_kernel_cuda``, ``FusedNSFTrainer``,
``nsf_loss_grad_cuda``), so the two sides may differ in their C
interfaces. The turns are old, new, new, old, ``R`` rounds (default 2);
each turn prints one JSON line of device ms (``chip_smoke.device_ms``:
torch.profiler, CUDA events where its trace is incomplete). NEW_CHECKOUT
defaults to this checkout. Make OLD_CHECKOUT with ``git archive <commit> |
tar -x -C <dir>`` into a directory that .gitignore lists; each side builds
its kernels into its own ``build/`` at its first turn.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One turn, run with the checkout as its working directory and first on
# sys.path; prints {"b2_forward": ms, "b2_inverse": ms, "b3_512": ms, "b3_4096": ms,
# "b4_512": ms, "affine_b2_forward": ms, "affine_b3_512": ms, "affine_b4_512": ms,
# "narrow_b3_16384": ms, "narrow_b4_16384": ms}.
TURN = r"""
import json, sys
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from nflows_tpu_torch import NeuralSplineFlow
from nflows_tpu_torch.ops.cuda import _build, nsf_flow_kernel as nfk, nsf_train
from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf
cs.log = lambda *args: None
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
flow = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                        rng=np.random.default_rng(0), device="cuda", **cs.FLAGSHIP)
gen = torch.Generator().manual_seed(1)
D = cs.FLAGSHIP["features"]
out = {}
fused = fuse_nsf(flow)
x = torch.randn(4096, D, generator=gen).cuda()
for inverse in (False, True):
    kw = dict(inverse=inverse, **fused._static)
    run = lambda: nfk.nsf_flow_kernel_cuda(x, fused._weights, fused._indices,
                                           packed=fused._packed, **kw)
    out["b2_inverse" if inverse else "b2_forward"] = cs.device_ms(torch, run, 20,
                                                                  kernel="nsf_flow_kernel")
affine = cs.realnvp_flow("affine", "cuda", seed=0)
fused = fuse_nsf(affine)
run = lambda: nfk.nsf_flow_kernel_cuda(x, fused._weights, fused._indices, packed=fused._packed,
                                       inverse=False, **fused._static)
out["affine_b2_forward"] = cs.device_ms(torch, run, 20, kernel="nsf_flow_kernel")
narrow = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                          rng=np.random.default_rng(0), device="cuda",
                          **dict(cs.FLAGSHIP, hidden_features=128))
for tag, model, sizes in (("", flow, (512, 4096)), ("affine_", affine, (512,)),
                          ("narrow_", narrow, (16384,))):
    trainer = nsf_train.FusedNSFTrainer(model, 512)
    w = {k: v.detach() for k, v in trainer.weights.items()}
    kw = dict(wh_scale=trainer._wh_scale, **trainer._static)
    packed = nfk.pack_weights(w, trainer._indices)
    grads = {k: torch.empty_like(v) for k, v in w.items()}
    for n in sizes:
        xb = (1.5 * torch.randn(n, D, generator=gen)).cuda()
        run = lambda: nsf_train.nsf_loss_grad_cuda(xb, w, trainer._indices, packed=packed,
                                                   grads=grads, **kw)
        out[f"{tag}b3_{n}"] = cs.device_ms(torch, run, 20, kernel="nsf_loss_grad_kernel")
    n = sizes[0]
    gy = (torch.randn(n, D, generator=gen) / n).cuda()
    glad = (torch.randn(n, generator=gen) / n).cuda()
    xb = (1.5 * torch.randn(n, D, generator=gen)).cuda()
    run = lambda: nsf_train.nsf_train_bwd_cuda(xb, gy, glad, w, trainer._indices,
                                               packed=packed, grads=grads, **kw)
    out[f"{tag}b4_{n}"] = cs.device_ms(torch, run, 20, kernel="nsf_train_bwd_kernel")
print(json.dumps(out))
"""


def turn(checkout: str) -> dict:
    done = subprocess.run([sys.executable, "-c", TURN], cwd=checkout, check=True,
                          capture_output=True, text=True)
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    rounds = 2
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if not 1 <= len(argv) <= 2:
        sys.exit(__doc__)
    old = os.path.abspath(argv[0])
    new = os.path.abspath(argv[1]) if len(argv) == 2 else ROOT
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for r in range(rounds):
        for tag, checkout in (("old", old), ("new", new), ("new", new), ("old", old)):
            print(json.dumps({"round": r, "side": tag, **turn(checkout)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
