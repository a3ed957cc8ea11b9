"""A/B two versions of the whole-chain kernel B2 on one card.

    python3 tools/kernel_ab.py OLD_CSRC_DIR

Builds ``OLD_CSRC_DIR/nsf_flow_kernel.cu`` beside the checkout's own
``nflows_tpu_torch/csrc/nsf_flow_kernel.cu`` (same nvcc flags), holds both
against B2's plain version on the full-width flagship (random weights
from seed 0), and times them in turns (old, new, new, old) at N = 4,096
and N = 65,536 with torch.profiler device time. Make OLD_CSRC_DIR with
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


def main(old_dir: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nflows_tpu_torch import NeuralSplineFlow
    from nflows_tpu_torch.ops.cuda import _build
    from nflows_tpu_torch.ops.cuda import nsf_flow_kernel as nfk
    from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    new = _build.build_all()["nsf_flow_kernel"]
    nfk._declare(new)
    old_lib = os.path.join(_build.BUILD_ROOT, "ab_old_libnsf_flow_kernel.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", old_dir, "-o", old_lib,
                    os.path.join(old_dir, "nsf_flow_kernel.cu")], check=True,
                   capture_output=True)
    old = ctypes.CDLL(old_lib)
    nfk._declare(old)

    def use(lib):
        _build.load_library = lambda stem, declare: lib

    flow = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                            rng=np.random.default_rng(0), device="cuda", **cs.FLAGSHIP)
    fused = fuse_nsf(flow)
    args = (fused._weights, fused._indices)
    gen = torch.Generator().manual_seed(1)
    for n in (4096, 65536):
        x = torch.randn(n, cs.FLAGSHIP["features"], generator=gen).cuda()
        for inverse in (False, True):
            kw = dict(inverse=inverse, **fused._static)
            p_y, p_lad = nfk.nsf_flow_kernel_plain(x, *args, **kw)
            for tag, lib in (("old", old), ("new", new)):
                use(lib)
                y, lad = nfk.nsf_flow_kernel_cuda(x, *args, packed=fused._packed, **kw)
                torch.cuda.synchronize()
                print(f"N={n} inverse={inverse} {tag}: |y-plain| {cs.max_err(y, p_y):.3e} "
                      f"|lad-plain| {cs.max_err(lad, p_lad):.3e}")
        kw = dict(inverse=False, **fused._static)

        def run():
            return nfk.nsf_flow_kernel_cuda(x, *args, packed=fused._packed, **kw)

        times = []
        for tag, lib in (("old", old), ("new", new), ("new", new), ("old", old)):
            use(lib)
            times.append(f"{tag} {cs.device_ms(torch, run, 10, kernel='nsf_flow_kernel'):.4f}")
        print(f"N={n} forward device ms: " + ", ".join(times))
        print(f"N={n} new, under load: {clocks_under_load(torch, run)}")
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
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
