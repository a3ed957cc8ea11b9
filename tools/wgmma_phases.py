"""Where a consumer warp's time goes in B2's wgmma route
(csrc/nsf_flow_wgmma.cuh) on one card: an instrumented copy of the kernel
reads ``clock64()`` on thread 0 of block 0 (lane 0 of the first consumer
warp) at each phase boundary of its GEMMs and sums the cycles by phase;
lane 0 of the producer warp of the same block sums the cycles it waits
for a free ring slot (its slot's). This is the count that decides whether the weight stream holds
the consumers back (the chunk waits' share).

    python3 tools/wgmma_phases.py

Copies ``nflows_tpu_torch/csrc`` to ``build/wgmma_phases/csrc``, inserts
the probes by pattern, builds both weight types' sources with the port's
nvcc flags and runs the flagship's forward (``chip_smoke.FLAGSHIP``,
random weights from seed 0) at N = 4,096, fp32 and bf16, once for the
probes after a warm-up, then 20 times for the kernel's time (CUDA
events). Prints the card line, then one JSON line per weight type: the
phases in thousands of cycles of that warp and their shares, and the
producer's wait. The probes cost some percent of the kernel's time.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "wgmma_phases"
NAMES = {1: "set-up of a GEMM", 2: "wait for the chunk",
         3: "load and split of the weights' fragments (fp32)",
         4: "issue of the wgmmas", 5: "wait for the products, release",
         6: "epilogues, merge, operand writes", 7: "consumer barriers",
         8: "coupling stage"}
PROBE = ('__device__ unsigned long long prof_acc[16];\n__device__ long long prof_last;\n'
         '__device__ unsigned long long prof_producer[2];\n'
         '#define PROF(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) { long long t_ = '
         'clock64(); prof_acc[k] += t_ - prof_last; prof_last = t_; } } while (0)\n')
PATCHES = (
    ('#include "coupling_stage.cuh"\n', '#include "coupling_stage.cuh"\n' + PROBE),
    ('  asm volatile("bar.sync 1, %0;\\n" ::"n"(NCT) : "memory");\n',
     '  PROF(6);\n  asm volatile("bar.sync 1, %0;\\n" ::"n"(NCT) : "memory");\n  PROF(7);\n'),
    ("    for_consumers(T * ROWS, tid, [&](int e) {\n",
     "    PROF(6);\n    for_consumers(T * ROWS, tid, [&](int e) {\n"),
    ("                                     lbuf + s * T + tt);\n    });\n",
     "                                     lbuf + s * T + tt);\n    });\n    PROF(8);\n"),
    ("    for (int k0 = 0; k0 < nk; k0 += kc) {\n      const int kn = min(kc, nk - k0);\n",
     "    for (int k0 = 0; k0 < nk; k0 += kc) {\n      const int kn = min(kc, nk - k0);\n"
     "      PROF(1);\n"),
    ("      mbar_wait(ring.full + q % Ring<WT>::S, (q / Ring<WT>::S) & 1);\n"
     "      const char* slot",
     "      mbar_wait(ring.full + q % Ring<WT>::S, (q / Ring<WT>::S) & 1);\n"
     "      PROF(2);\n      const char* slot"),
    # bf16: weights from shared memory
    ("          wgmma_commit();\n          wgmma_wait<1>();\n        }\n"
     "        if (k0 > 0) release(q - 1);\n",
     "          wgmma_commit();\n          PROF(4);\n          wgmma_wait<1>();\n        }\n"
     "        if (k0 > 0) release(q - 1);\n        PROF(5);\n"),
    # fp32: fragments in registers
    ("    wgmma_wait<0>();\n    if (k0 > 0) release(q - 1);\n",
     "    wgmma_wait<0>();\n    if (k0 > 0) release(q - 1);\n    PROF(5);\n"),
    ("    fence_acc(acc);\n    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < KN;",
     "    PROF(3);\n    fence_acc(acc);\n    wgmma_fence();\n#pragma unroll\n"
     "    for (int kk = 0; kk < KN;"),
    ("    wgmma_commit();\n  }\n\n",
     "    wgmma_commit();\n    PROF(4);\n  }\n\n"),
    ("      fence_acc(acc);\n    }\n    release(q - 1);\n",
     "      fence_acc(acc);\n    }\n    release(q - 1);\n    PROF(5);\n"),
    ("  if (__shfl_sync(0xffffffffu, tid >> 5, 0) >= NCT / 32) {\n"
     "    if (tid - NCT < S) produce(a, ring, tid - NCT);\n",
     "  if (tid == 0 && blockIdx.x == 0) prof_last = clock64();\n"
     "  if (__shfl_sync(0xffffffffu, tid >> 5, 0) >= NCT / 32) {\n"
     "    if (tid - NCT < S) produce(a, ring, tid - NCT);\n"),
    ("  if (q >= S) mbar_wait(ring.empty + lane, ((q / S) - 1) & 1);\n",
     "  const long long t0_ = clock64();\n"
     "  if (q >= S) mbar_wait(ring.empty + lane, ((q / S) - 1) & 1);\n"
     "  if (blockIdx.x == 0 && lane == 0) prof_producer[0] += clock64() - t0_;\n"),
    ("  int q = 0;\n  const int nsH = a.H / 64;\n",
     "  int q = 0;\n  const int nsH = a.H / 64;\n  const long long start_ = clock64();\n"),
    ("    gemm(a.H, a.TMp / 64);\n  }\n}\n",
     "    gemm(a.H, a.TMp / 64);\n  }\n"
     "  if (blockIdx.x == 0 && lane == 0) prof_producer[1] += clock64() - start_;\n}\n"),
)
READERS = ('\nextern "C" int prof_read(unsigned long long* out) {\n'
           '  cudaError_t e = cudaMemcpyFromSymbol(out, prof_acc, sizeof(prof_acc));\n'
           '  if (e != cudaSuccess) return (int)e;\n'
           '  return (int)cudaMemcpyFromSymbol(out + 16, prof_producer,\n'
           '                                   sizeof(prof_producer));\n}\n'
           'extern "C" int prof_reset() {\n  unsigned long long z[16] = {0};\n'
           '  cudaError_t e = cudaMemcpyToSymbol(prof_acc, z, sizeof(prof_acc));\n'
           '  if (e != cudaSuccess) return (int)e;\n'
           '  return (int)cudaMemcpyToSymbol(prof_producer, z, sizeof(prof_producer));\n}\n')
STEMS = ("nsf_flow_wgmma", "nsf_flow_wgmma_bf16")


def instrument(src: pathlib.Path, dst: pathlib.Path) -> None:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    text = (dst / "nsf_flow_wgmma.cuh").read_text()
    for old, new in PATCHES:
        if old not in text:
            raise RuntimeError(f"nsf_flow_wgmma.cuh no longer has {old!r}")
        text = text.replace(old, new)
    (dst / "nsf_flow_wgmma.cuh").write_text(text)
    for stem in STEMS:
        with open(dst / f"{stem}.cu", "a") as f:
            f.write(READERS)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wgmma_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from nflows_tpu_torch import NeuralSplineFlow
    from nflows_tpu_torch.ops.cuda import _build
    from nflows_tpu_torch.ops.cuda import nsf_flow_kernel as k
    from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf

    print(cs.card_line(), flush=True)
    csrc = OUT / "csrc"
    instrument(ROOT / "nflows_tpu_torch" / "csrc", csrc)
    procs = {stem: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
         str(OUT / f"lib{stem}_phases.so"), str(csrc / f"{stem}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for stem in STEMS}
    libs = {}
    for stem, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {stem}:\n{log.decode()[-4000:]}")
        lib = ctypes.CDLL(str(OUT / f"lib{stem}_phases.so"))
        k._declare(lib)
        libs[stem] = lib
    load = _build.load_library
    _build.load_library = lambda stem, declare: libs[stem] if stem in libs else load(stem,
                                                                                      declare)
    flow = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                            rng=np.random.default_rng(0), device="cuda", **cs.FLAGSHIP).eval()
    x = torch.randn(cs.SERVE_BATCH, cs.FLAGSHIP["features"],
                    generator=torch.Generator().manual_seed(1)).cuda()
    for dtype, stem in zip((torch.float32, torch.bfloat16), STEMS):
        view = fuse_nsf(flow, dtype=dtype)
        run = lambda: k.nsf_flow_kernel_cuda(  # noqa: E731
            x, view._weights, view._indices, inverse=False, packed=view._packed,  # noqa: B023
            gemm="wgmma", **view._static)  # noqa: B023
        lib = libs[stem]
        run()
        torch.cuda.synchronize()
        lib.prof_reset()
        run()
        torch.cuda.synchronize()
        acc = (ctypes.c_ulonglong * 18)()
        lib.prof_read(acc)
        ms = cs.call_ms(torch, run, 20)
        total = sum(acc[:16])
        print(json.dumps({
            "dtype": str(dtype)[6:], "ms": ms, "warp_kcycles": total / 1e3,
            "phases_kcycles": {NAMES[i]: round(acc[i] / 1e3, 1) for i in NAMES if acc[i]},
            "phases_percent": {NAMES[i]: round(100 * acc[i] / total, 1)
                               for i in NAMES if acc[i]},
            "producer_wait_kcycles": acc[16] / 1e3,
            "producer_kcycles": acc[17] / 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
