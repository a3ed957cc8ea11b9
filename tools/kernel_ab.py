"""A/B two versions of a whole-chain kernel on one card: B2
(``nsf_flow_kernel``), the training kernel B3 (``nsf_train``), the
autoregressive chain B9 (``maf_flow_kernel``) or its backward B10
(``maf_train``).

    python3 tools/kernel_ab.py OLD_CSRC_DIR [STEM] [more old dirs]

STEM is one of nsf_flow_kernel (the default), nsf_train, maf_flow_kernel,
maf_train.

Builds ``OLD_CSRC_DIR/<kernel>.cu`` beside the checkout's own
``nflows_tpu_torch/csrc/<kernel>.cu`` (same nvcc flags), holds both against
the kernel's plain version on the full-width flagship (random weights from
seed 0), and times them in turns (old, new, new, old) with torch.profiler
device time: B2 at N = 4,096 and 65,536, B3 at N = 512 and 4,096, B9 forward
and inverse at N = 4,096 and B10 at N = 512 and 4,096 on the full-width MAF
(features 10, hidden 256, 5 layers, final-layer weights scaled as in
chip_smoke.py). Further
directories are timed as well, each in turns with the checkout's kernel.
The old source must have the checkout's C interface. Make OLD_CSRC_DIR with
``git archive <commit> nflows_tpu_torch/csrc | tar -x -C <dir>`` into a
directory that .gitignore lists.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(kernel: str, old_dirs) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nflows_tpu_torch import NeuralSplineFlow
    from nflows_tpu_torch.ops.cuda import _build
    from nflows_tpu_torch.ops.cuda import nsf_flow_kernel as nfk
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel as mfk
    from nflows_tpu_torch.ops.cuda import maf_train, nsf_train
    from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    declare = {"nsf_flow_kernel": nfk._declare, "nsf_train": nsf_train._declare,
               "maf_flow_kernel": mfk._declare, "maf_train": maf_train._declare}[kernel]
    new = _build.build_all()[kernel]
    declare(new)
    olds = []
    for i, old_dir in enumerate(old_dirs):
        old_lib = os.path.join(_build.BUILD_ROOT, f"ab_old{i}_lib{kernel}.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", old_dir, "-o", old_lib,
                        os.path.join(old_dir, f"{kernel}.cu")], check=True,
                       capture_output=True)
        olds.append((f"old{i}" if i else "old", ctypes.CDLL(old_lib)))
        declare(olds[-1][1])

    def use(lib):
        _build.load_library = lambda stem, declare: lib

    flow = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                            rng=np.random.default_rng(0), device="cuda", **cs.FLAGSHIP)
    gen = torch.Generator().manual_seed(1)
    D = cs.FLAGSHIP["features"]

    def turns(n, what, run, name):
        for tag, old in olds:
            times = []
            for t, lib in ((tag, old), ("new", new), ("new", new), (tag, old)):
                use(lib)
                times.append(f"{t} {cs.device_ms(torch, run, 10, kernel=name):.4f}")
            print(f"N={n} {what} device ms: " + ", ".join(times))
        use(new)
        print(f"N={n} new, under load: {clocks_under_load(torch, run)}")

    if kernel in ("maf_flow_kernel", "maf_train"):
        return maf_turns(torch, kernel, olds, new, use, turns, gen)

    if kernel == "nsf_flow_kernel":
        fused = fuse_nsf(flow)
        args = (fused._weights, fused._indices)
        for n in (4096, 65536):
            x = torch.randn(n, D, generator=gen).cuda()
            for inverse in (False, True):
                kw = dict(inverse=inverse, **fused._static)
                p_y, p_lad = nfk.nsf_flow_kernel_plain(x, *args, **kw)
                for tag, lib in (*olds, ("new", new)):
                    use(lib)
                    y, lad = nfk.nsf_flow_kernel_cuda(x, *args, packed=fused._packed, **kw)
                    torch.cuda.synchronize()
                    print(f"N={n} inverse={inverse} {tag}: |y-plain| {cs.max_err(y, p_y):.3e} "
                          f"|lad-plain| {cs.max_err(lad, p_lad):.3e}")
            kw = dict(inverse=False, **fused._static)
            turns(n, "forward", lambda: nfk.nsf_flow_kernel_cuda(  # noqa: B023
                x, *args, packed=fused._packed, **kw), "nsf_flow_kernel")
        return 0

    trainer = nsf_train.FusedNSFTrainer(flow, 512)
    w = {k: v.detach() for k, v in trainer.weights.items()}
    kw = dict(wh_scale=trainer._wh_scale, **trainer._static)
    packed = nfk.pack_weights(w, trainer._indices)
    for n in (512, 4096):
        x = (1.5 * torch.randn(n, D, generator=gen)).cuda()
        _, p_lp, p_grads = nsf_train.nsf_loss_grad_plain(x, w, trainer._indices, **kw)
        for tag, lib in (*olds, ("new", new)):
            use(lib)
            _, lp, grads = nsf_train.nsf_loss_grad_cuda(x, w, trainer._indices,
                                                        packed=packed, **kw)
            torch.cuda.synchronize()
            worst = max(cs.max_err(grads[k], p_grads[k]) for k in grads)
            print(f"N={n} {tag}: |lp-plain| {cs.max_err(lp, p_lp):.3e} "
                  f"|grads-plain| {worst:.3e}")
        grads = {k: torch.empty_like(v) for k, v in w.items()}
        turns(n, "loss and gradients", lambda: nsf_train.nsf_loss_grad_cuda(  # noqa: B023
            x, w, trainer._indices, packed=packed, grads=grads, **kw), "nsf_loss_grad_kernel")
    return 0


def maf_turns(torch, kernel, olds, new, use, turns, gen):
    """B9 or B10 on the full-width MAF: each library against the plain
    version, then the timed turns."""
    import chip_smoke as cs
    from nflows_tpu_torch import MaskedAutoregressiveFlow
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel as mfk
    from nflows_tpu_torch.ops.cuda import maf_train

    flow = MaskedAutoregressiveFlow(generator=torch.Generator().manual_seed(0),
                                    device="cuda", **cs.MAF)
    with torch.no_grad():
        for t in list(flow.transform.transforms)[1::2]:
            t.autoregressive_net.final_layer.weight.mul_(0.1)
    D = cs.MAF["features"]
    trainer = maf_train.FusedMAFTrainer(flow, 512)
    w = {k: v.detach().contiguous() for k, v in trainer._fold(trainer.weights).items()}
    layers, static = trainer._layers, trainer._static
    packed = mfk.pack_weights(w, layers, static["num_blocks"])
    if kernel == "maf_flow_kernel":
        x = torch.randn(4096, D, generator=gen).cuda()
        for inverse in (False, True):
            kw = dict(inverse=inverse, **static)
            p_y, p_lad = mfk.maf_flow_kernel_plain(x, w, layers, **kw)
            for tag, lib in (*olds, ("new", new)):
                use(lib)
                y, lad = mfk.maf_flow_kernel_cuda(x, w, layers, packed=packed, **kw)
                torch.cuda.synchronize()
                print(f"N=4096 inverse={inverse} {tag}: |y-plain| {cs.max_err(y, p_y):.3e} "
                      f"|lad-plain| {cs.max_err(lad, p_lad):.3e}")
            turns(4096, "inverse" if inverse else "forward",
                  lambda: mfk.maf_flow_kernel_cuda(x, w, layers, packed=packed, **kw),  # noqa: B023
                  "maf_flow_kernel")
        return 0
    for n in (512, 4096):
        x = (1.5 * torch.randn(n, D, generator=gen)).cuda()
        gy = (torch.randn(n, D, generator=gen) / n).cuda()
        glad = (torch.randn(n, generator=gen) / n).cuda()
        p_gx, p_grads = maf_train.maf_train_bwd_plain(x, gy, glad, w, layers, **static)
        for tag, lib in (*olds, ("new", new)):
            use(lib)
            gx, grads = maf_train.maf_train_bwd_cuda(x, gy, glad, w, layers, packed=packed,
                                                     **static)
            torch.cuda.synchronize()
            worst = max(cs.max_err(grads[k], p_grads[k]) for k in grads)
            print(f"N={n} {tag}: |gx-plain| * N {n * cs.max_err(gx, p_gx):.3e} "
                  f"|grads-plain| {worst:.3e}")
        grads = {k: torch.empty_like(v) for k, v in w.items()}
        turns(n, "backward", lambda: maf_train.maf_train_bwd_cuda(  # noqa: B023
            x, gy, glad, w, layers, packed=packed, grads=grads, **static),
            "maf_train_bwd_kernel")
    return 0


def clocks_under_load(torch, fn, seconds=1.0):
    """SM clock and power draw sampled by nvidia-smi every 100 ms while
    ``fn`` runs back to back for about ``seconds``."""
    import time

    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            fn()
            torch.cuda.synchronize()
    finally:
        sampler.terminate()
        out, _ = sampler.communicate()
    samples = [line.strip() for line in out.splitlines() if line.strip()]
    return "; ".join(samples[2:])  # the first samples may predate the load


if __name__ == "__main__":
    STEMS = ("nsf_flow_kernel", "nsf_train", "maf_flow_kernel", "maf_train")
    dirs = [a for a in sys.argv[1:] if a not in STEMS]
    kernels = [a for a in sys.argv[1:] if a in STEMS]
    if not dirs or len(kernels) > 1:
        sys.exit(__doc__)
    sys.exit(main(kernels[0] if kernels else "nsf_flow_kernel", dirs))
