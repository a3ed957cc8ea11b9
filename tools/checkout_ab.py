"""A/B two checkouts of the port on one card: the whole-chain kernel B2
(forward and inverse at N = 4,096) and the training kernels B3 and B4 (N =
512, 2,048 and 4,096) on the full-width flagship NSF, and B2 (forward at
N = 4,096), B3 and B4 (N = 512) on RealNVP at the same widths
(``chip_smoke.realnvp_flow``; random weights from seed 0), B3 and B4 at
N = 16,384 on the flagship at hidden 128, where they take 64-sample tiles,
and B3 and B4 at 512, 2,048 and 4,096 on the conditional flagship (context
10, ``chip_smoke.MOG_CONTEXT``; seed 20). Each side runs the cluster size
its own wrapper chooses. With ``--family maf``
it times the autoregressive kernels instead: B9 forward and inverse at
N = 4,096 and B10 at N = 512, 2,048 and 4,096 on the full-width MAF
(``chip_smoke.MAF``), and B9 forward and inverse and B10 at 512 on the
NSF-AR (``chip_smoke.NSF_AR``), unconditional, random weights from seed 0;
the inverse on whichever kernel each side's wrapper routes it to (the
degree kernel, where a checkout has one, else the fixed-point kernel), and
B10 on whichever layout it chooses (a thread-block cluster a tile,
csrc/maf_train_cluster.cu, where a checkout has it and the tiles leave SMs
idle, else csrc/maf_train.cu).
With ``--family unfused`` it times what a user of the unfused chains waits
for instead: ``CompiledFlow(use_fused=False)`` ``log_prob`` and ``sample``
requests of 4,096 on the full-width flagship NSF (ten B1 launches a
request) and on its quadratic twin (``chip_smoke.family_flow``, ten B7),
random weights from seed 0, each request's wall on the host's clock (the
median of five means of ten requests, after three) and its device busy
time (``chip_smoke.device_ms``); each side builds only B1's and B7's
sources, which is all those chains launch.
With ``--dtype bfloat16`` it times the serving kernels' bf16-weight
instantiations instead, on the same models: B2 (forward and inverse on the
flagship, forward on RealNVP), or with ``--family maf`` B9; both sides must
have them (the training kernels are fp32 only and are left out).

    python3 tools/checkout_ab.py OLD_CHECKOUT [NEW_CHECKOUT] [--rounds R] [--family maf|unfused]
        [--dtype bfloat16]

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
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One turn, run with the checkout as its working directory and first on
# sys.path; prints {"b2_forward": ms, "b2_inverse": ms, "b3_512": ms, "b4_512": ms, ...
# "b3_4096": ms, "b4_4096": ms, "affine_b2_forward": ms, "affine_b3_512": ms,
# "affine_b4_512": ms, "narrow_b3_16384": ms, "narrow_b4_16384": ms, "context_b3_512":
# ms, ... "context_b4_4096": ms}.
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
DTYPE = torch.__DTYPE__
_build.build_all()
flow = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                        rng=np.random.default_rng(0), device="cuda", **cs.FLAGSHIP)
gen = torch.Generator().manual_seed(1)
D = cs.FLAGSHIP["features"]
out = {}
fused = fuse_nsf(flow, dtype=DTYPE)
x = torch.randn(4096, D, generator=gen).cuda()
for inverse in (False, True):
    kw = dict(inverse=inverse, **fused._static)
    run = lambda: nfk.nsf_flow_kernel_cuda(x, fused._weights, fused._indices,
                                           packed=fused._packed, **kw)
    out["b2_inverse" if inverse else "b2_forward"] = cs.device_ms(torch, run, 20,
                                                                  kernel="nsf_flow_kernel")
affine = cs.realnvp_flow("affine", "cuda", seed=0)
fused = fuse_nsf(affine, dtype=DTYPE)
run = lambda: nfk.nsf_flow_kernel_cuda(x, fused._weights, fused._indices, packed=fused._packed,
                                       inverse=False, **fused._static)
out["affine_b2_forward"] = cs.device_ms(torch, run, 20, kernel="nsf_flow_kernel")
narrow = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                          rng=np.random.default_rng(0), device="cuda",
                          **dict(cs.FLAGSHIP, hidden_features=128))
conditional = NeuralSplineFlow(generator=torch.Generator().manual_seed(20),
                               rng=np.random.default_rng(20), device="cuda",
                               context_features=cs.MOG_CONTEXT, **cs.FLAGSHIP)
for tag, model, sizes in (() if DTYPE == torch.bfloat16 else (
        ("", flow, (512, 2048, 4096)), ("affine_", affine, (512,)),
        ("narrow_", narrow, (16384,)), ("context_", conditional, (512, 2048, 4096)))):
    trainer = nsf_train.FusedNSFTrainer(model, 512)
    w = {k: v.detach() for k, v in trainer.weights.items()}
    kw = dict(wh_scale=trainer._wh_scale, **trainer._static)
    packed = nfk.pack_weights(w, trainer._indices)
    grads = {k: torch.empty_like(v) for k, v in w.items()}
    for n in sizes:
        xb = (1.5 * torch.randn(n, D, generator=gen)).cuda()
        ctx = (torch.randn(n, cs.MOG_CONTEXT, generator=gen).cuda() if tag == "context_"
               else None)
        run = lambda: nsf_train.nsf_loss_grad_cuda(xb, w, trainer._indices, packed=packed,
                                                   grads=grads, context=ctx, **kw)
        out[f"{tag}b3_{n}"] = cs.device_ms(torch, run, 20, kernel="nsf_loss_grad")
        gy = (torch.randn(n, D, generator=gen) / n).cuda()
        glad = (torch.randn(n, generator=gen) / n).cuda()
        run = lambda: nsf_train.nsf_train_bwd_cuda(xb, gy, glad, w, trainer._indices,
                                                   packed=packed, grads=grads, context=ctx,
                                                   **kw)
        out[f"{tag}b4_{n}"] = cs.device_ms(torch, run, 20, kernel="nsf_train_bwd")
print(json.dumps(out))
"""

# The same for the autoregressive kernels; prints {"maf_b9_forward": ms,
# "maf_b9_inverse": ms, "maf_b10_512": ms, "maf_b10_2048": ms, "maf_b10_4096": ms,
# "nsf_ar_b9_forward": ms, "nsf_ar_b9_inverse": ms, "nsf_ar_b10_512": ms}.
TURN_MAF = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from nflows_tpu_torch import MaskedAutoregressiveFlow, NeuralSplineFlowAR
from nflows_tpu_torch.ops.cuda import _build, maf_flow_kernel as mfk, maf_train
from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf
cs.log = lambda *args: None
torch.backends.cuda.matmul.allow_tf32 = False
DTYPE = torch.__DTYPE__
_build.build_all()
gen = torch.Generator().manual_seed(1)
D = cs.MAF["features"]
out = {}
for tag, cls, cfg, sizes in (("maf_", MaskedAutoregressiveFlow, cs.MAF, (512, 2048, 4096)),
                             ("nsf_ar_", NeuralSplineFlowAR, cs.NSF_AR, (512,))):
    flow = cls(generator=torch.Generator().manual_seed(0), device="cuda", **cfg).eval()
    view = fuse_maf(flow, dtype=DTYPE)
    kw = dict(num_blocks=view._num_blocks, transformer=view._transformer,
              spline_kw=view._spline_kw)
    x = torch.randn(4096, D, generator=gen).cuda()
    for inverse in (False, True):
        run = lambda: mfk.maf_flow_kernel_cuda(x, view._weights, view._static,
                                               packed=view._packed, inverse=inverse, **kw)
        # "maf_": the fixed point runs on the degree kernel where a checkout
        # has one (maf_degree_inverse_kernel), else on maf_flow_kernel
        out[tag + ("b9_inverse" if inverse else "b9_forward")] = cs.device_ms(
            torch, run, 10 if inverse else 20, kernel="maf_")
    if DTYPE == torch.bfloat16:
        continue
    trainer = maf_train.FusedMAFTrainer(flow, 512)
    w = {k: v.detach().contiguous() for k, v in trainer._fold(trainer.weights).items()}
    mkw = dict(wh_scale=trainer._wh_scale, **trainer._static)
    packed = mfk.pack_weights(w, trainer._layers, trainer._static["num_blocks"])
    grads = {k: torch.empty_like(v) for k, v in w.items()}
    for n in sizes:
        xb = (1.5 * torch.randn(n, D, generator=gen)).cuda()
        gy = (torch.randn(n, D, generator=gen) / n).cuda()
        glad = (torch.randn(n, generator=gen) / n).cuda()
        run = lambda: maf_train.maf_train_bwd_cuda(xb, gy, glad, w, trainer._layers,
                                                   packed=packed, grads=grads, **mkw)
        # maf_train_bwd_kernel, or maf_train_bwd_cluster_kernel where a
        # checkout has it
        out[f"{tag}b10_{n}"] = cs.device_ms(torch, run, 20, kernel="maf_train_bwd")
print(json.dumps(out))
"""

# The unfused requests; prints {"flagship_log_prob_wall": ms, "flagship_log_prob_busy":
# ms, "flagship_sample_wall": ms, ..., "quadratic_sample_busy": ms}.
TURN_UNFUSED = r"""
import json, statistics, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from nflows_tpu_torch import NeuralSplineFlow
from nflows_tpu_torch.ops.cuda import _build
from nflows_tpu_torch.serving import CompiledFlow
cs.log = lambda *args: None
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the unfused chains launch B1 and B7 only: build those two sources
_sources = _build._sources
_build._sources = lambda: [p for p in _sources() if p.stem in ("rq_spline", "quadratic_spline")]
D, N = cs.FLAGSHIP["features"], cs.SERVE_BATCH
flows = {"flagship": NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                                      rng=np.random.default_rng(0), device="cuda",
                                      **cs.FLAGSHIP).eval(),
         "quadratic": cs.family_flow("quadratic", "cuda", seed=0)}
x = torch.randn(N, D, generator=torch.Generator().manual_seed(1)).cuda()
out = {}
for tag, flow in flows.items():
    server = CompiledFlow(flow, batch_size=N, features=D, use_fused=False)
    assert not server.is_fused
    for endpoint, fn in (
            ("log_prob", lambda: server.log_prob(x)),
            ("sample", lambda: server.sample(torch.Generator(device="cuda").manual_seed(2)))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        means = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            means.append(1e3 * (time.perf_counter() - t0) / 10)
        out[f"{tag}_{endpoint}_wall"] = statistics.median(means)
        out[f"{tag}_{endpoint}_busy"] = cs.device_ms(torch, fn, 3)
print(json.dumps(out))
"""


def turn(checkout: str, code: str) -> dict:
    done = subprocess.run([sys.executable, "-c", code], cwd=checkout, check=True,
                          capture_output=True, text=True)
    return json.loads(done.stdout.strip().splitlines()[-1])


def _option(argv, name, default):
    if name not in argv:
        return argv, default
    i = argv.index(name)
    return argv[:i] + argv[i + 2:], argv[i + 1]


def main(argv) -> int:
    argv, rounds = _option(argv, "--rounds", "2")
    argv, family = _option(argv, "--family", "coupling")
    argv, dtype = _option(argv, "--dtype", "float32")
    if (not 1 <= len(argv) <= 2 or family not in ("coupling", "maf", "unfused")
            or dtype not in ("float32", "bfloat16")):
        sys.exit(__doc__)
    code = {"maf": TURN_MAF, "unfused": TURN_UNFUSED}.get(family, TURN).replace(
        "__DTYPE__", dtype)
    old = os.path.abspath(argv[0])
    new = os.path.abspath(argv[1]) if len(argv) == 2 else ROOT
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    seen = {"old": [], "new": []}
    for r in range(int(rounds)):
        for tag, checkout in (("old", old), ("new", new), ("new", new), ("old", old)):
            times = turn(checkout, code)
            seen[tag].append(times)
            print(json.dumps({"round": r, "side": tag, **times}), flush=True)
    # medians and ranges of each side's turns, and the new side's change
    for key in seen["old"][0]:
        med = {tag: statistics.median(t[key] for t in turns) for tag, turns in seen.items()}
        span = {tag: [min(t[key] for t in turns), max(t[key] for t in turns)]
                for tag, turns in seen.items()}
        print(json.dumps({"key": key, "old_ms": med["old"], "new_ms": med["new"],
                          "old_range": span["old"], "new_range": span["new"],
                          "change_percent": 100.0 * (med["new"] / med["old"] - 1.0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
