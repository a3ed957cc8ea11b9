"""Where a consumer warp's time goes in a wgmma kernel on one card: B2's
(csrc/nsf_flow_wgmma.cuh) or B11's (csrc/mademog_wgmma.cuh), both over
csrc/wgmma_chain.cuh. An instrumented copy of the kernel reads
``clock64()`` on thread 0 of block 0 (lane 0 of the first consumer warp)
at each phase boundary of its GEMMs and sums the cycles by phase; lane 0
of the producer warp of the same block sums the cycles it waits for a
free ring slot (its slot's). This is the count that decides whether the
weight stream holds the consumers back (the chunk waits' share).

    python3 tools/wgmma_phases.py [--family nsf|mademog]

Copies ``nflows_tpu_torch/csrc`` to ``build/wgmma_phases/csrc``, inserts
the probes by pattern, builds both weight types' sources with the port's
nvcc flags and runs, at N = 4,096, fp32 and bf16, the flagship's forward
(``nsf``, the default: ``chip_smoke.FLAGSHIP``, random weights from seed
0) or the MoG-MADE's log_prob (``mademog``: ``chip_smoke.MOG``, seed 0),
once for the probes after a warm-up, then 20 times for the kernel's time
(CUDA events, the calls queued: ``chip_smoke.queued_ms``). Prints the
card line, then one JSON line per weight type: the phases in thousands of
cycles of that warp and their shares, and the producer's wait. The probes
cost some percent of the kernel's time.
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
         6: "epilogues, merge, operand writes", 7: "consumer barriers"}
STAGE = {"nsf": "coupling stage", "mademog": "mixture head"}   # phase 8
PROBE = ('__device__ unsigned long long prof_acc[16];\n__device__ long long prof_last;\n'
         '__device__ unsigned long long prof_producer[2];\n'
         '#define PROF(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) { long long t_ = '
         'clock64(); prof_acc[k] += t_ - prof_last; prof_last = t_; } } while (0)\n')
# the ring, the consumers' GEMM walk and barrier (csrc/wgmma_chain.cuh)
CHAIN_PATCHES = (
    ("#include <type_traits>\n", "#include <type_traits>\n" + PROBE),
    ('  asm volatile("bar.sync 1, %0;\\n" ::"n"(NCT) : "memory");\n',
     '  PROF(6);\n  asm volatile("bar.sync 1, %0;\\n" ::"n"(NCT) : "memory");\n  PROF(7);\n'),
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
    ("  if (q >= S) mbar_wait(ring.empty + lane, ((q / S) - 1) & 1);\n",
     "  const long long t0_ = clock64();\n"
     "  if (q >= S) mbar_wait(ring.empty + lane, ((q / S) - 1) & 1);\n"
     "  if (blockIdx.x == 0 && lane == 0) prof_producer[0] += clock64() - t0_;\n"),
)
# each kernel's own pieces: its stage or head, its roles and its producer
FAMILIES = {
    "nsf": ("nsf_flow_wgmma.cuh", (
        ("    for_consumers(T * ROWS, tid, [&](int e) {\n",
         "    PROF(6);\n    for_consumers(T * ROWS, tid, [&](int e) {\n"),
        ("                                     lbuf + s * T + tt);\n    });\n",
         "                                     lbuf + s * T + tt);\n    });\n    PROF(8);\n"),
        ("  if (__shfl_sync(0xffffffffu, tid >> 5, 0) >= NCT / 32) {\n"
         "    if (tid - NCT < S) produce(a, ring, tid - NCT);\n",
         "  if (tid == 0 && blockIdx.x == 0) prof_last = clock64();\n"
         "  if (__shfl_sync(0xffffffffu, tid >> 5, 0) >= NCT / 32) {\n"
         "    if (tid - NCT < S) produce(a, ring, tid - NCT);\n"),
        ("  int q = 0;\n  const int nsH = a.H / 64;\n",
         "  int q = 0;\n  const int nsH = a.H / 64;\n  const long long start_ = clock64();\n"),
        ("    gemm(a.H, a.TMp / 64);\n  }\n}\n",
         "    gemm(a.H, a.TMp / 64);\n  }\n"
         "  if (blockIdx.x == 0 && lane == 0) prof_producer[1] += clock64() - start_;\n}\n"),
    ), ("nsf_flow_wgmma", "nsf_flow_wgmma_bf16")),
    "mademog": ("mademog_wgmma.cuh", (
        ("  for_consumers(D * ROWS, tid, [&](int e) {\n",
         "  PROF(6);\n  for_consumers(D * ROWS, tid, [&](int e) {\n"),
        ("    lpd[e] = f.log_prob();\n  });\n",
         "    lpd[e] = f.log_prob();\n  });\n  PROF(8);\n"),
        ("  if (__shfl_sync(0xffffffffu, tid >> 5, 0) >= NCT / 32) {\n"
         "    if (tid - NCT < S) mog_produce(a, ring, tid - NCT);\n",
         "  if (tid == 0 && blockIdx.x == 0) prof_last = clock64();\n"
         "  if (__shfl_sync(0xffffffffu, tid >> 5, 0) >= NCT / 32) {\n"
         "    if (tid - NCT < S) mog_produce(a, ring, tid - NCT);\n"),
        ("  int q = 0;\n  const int nsH = a.H / 64, nsF = a.TMp / 64;\n",
         "  int q = 0;\n  const int nsH = a.H / 64, nsF = a.TMp / 64;\n"
         "  const long long start_ = clock64();\n"),
        ("    src = send_gemm(ring, q, lane, src, a.H, min(kMaxSlabs, nsF - s0));\n}\n",
         "    src = send_gemm(ring, q, lane, src, a.H, min(kMaxSlabs, nsF - s0));\n"
         "  if (blockIdx.x == 0 && lane == 0) prof_producer[1] += clock64() - start_;\n}\n"),
    ), ("mademog_wgmma", "mademog_wgmma_bf16")),
}
READERS = ('\nextern "C" int prof_read(unsigned long long* out) {\n'
           '  cudaError_t e = cudaMemcpyFromSymbol(out, prof_acc, sizeof(prof_acc));\n'
           '  if (e != cudaSuccess) return (int)e;\n'
           '  return (int)cudaMemcpyFromSymbol(out + 16, prof_producer,\n'
           '                                   sizeof(prof_producer));\n}\n'
           'extern "C" int prof_reset() {\n  unsigned long long z[16] = {0};\n'
           '  cudaError_t e = cudaMemcpyToSymbol(prof_acc, z, sizeof(prof_acc));\n'
           '  if (e != cudaSuccess) return (int)e;\n'
           '  return (int)cudaMemcpyToSymbol(prof_producer, z, sizeof(prof_producer));\n}\n')


def _patch(path: pathlib.Path, patches) -> None:
    text = path.read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"{path.name} no longer has {old!r}")
        text = text.replace(old, new)
    path.write_text(text)


def instrument(src: pathlib.Path, dst: pathlib.Path, family: str) -> None:
    header, patches, stems = FAMILIES[family]
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    _patch(dst / "wgmma_chain.cuh", CHAIN_PATCHES)
    _patch(dst / header, patches)
    for stem in stems:
        with open(dst / f"{stem}.cu", "a") as f:
            f.write(READERS)


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--family", choices=sorted(FAMILIES), default="nsf")
    family = parser.parse_args().family
    if not torch.cuda.is_available():
        print("wgmma_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from nflows_tpu_torch import MixtureOfGaussiansMADE, NeuralSplineFlow
    from nflows_tpu_torch.ops.cuda import _build
    from nflows_tpu_torch.ops.cuda import mademog_fused, nsf_flow_kernel
    from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf

    print(cs.card_line(), flush=True)
    csrc = OUT / "csrc"
    instrument(ROOT / "nflows_tpu_torch" / "csrc", csrc, family)
    stems = FAMILIES[family][2]
    procs = {stem: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
         str(OUT / f"lib{stem}_phases.so"), str(csrc / f"{stem}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for stem in stems}
    libs = {}
    declare = (mademog_fused._declare_wgmma if family == "mademog"
               else nsf_flow_kernel._declare)
    for stem, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {stem}:\n{log.decode()[-4000:]}")
        lib = ctypes.CDLL(str(OUT / f"lib{stem}_phases.so"))
        declare(lib)
        libs[stem] = lib
    load = _build.load_library
    _build.load_library = lambda stem, declare: libs[stem] if stem in libs else load(stem,
                                                                                      declare)
    seeded = dict(generator=torch.Generator().manual_seed(0), rng=np.random.default_rng(0),
                  device="cuda")
    if family == "mademog":
        model = MixtureOfGaussiansMADE(**cs.MOG, **seeded).eval()
        x = 1.5 * torch.randn(cs.SERVE_BATCH, cs.MOG["features"],
                              generator=torch.Generator().manual_seed(1)).cuda()
    else:
        model = NeuralSplineFlow(**cs.FLAGSHIP, **seeded).eval()
        x = torch.randn(cs.SERVE_BATCH, cs.FLAGSHIP["features"],
                        generator=torch.Generator().manual_seed(1)).cuda()
    names = {**NAMES, 8: STAGE[family]}
    for dtype, stem in zip((torch.float32, torch.bfloat16), stems):
        if family == "mademog":
            view = mademog_fused.fuse_mademog(model, dtype=dtype)
            run = lambda: mademog_fused.mademog_log_prob_cuda(  # noqa: E731
                x, view._weights, view._static, packed=view._packed, gemm="wgmma")  # noqa: B023
        else:
            view = fuse_nsf(model, dtype=dtype)
            run = lambda: nsf_flow_kernel.nsf_flow_kernel_cuda(  # noqa: E731
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
        ms = cs.queued_ms(torch, run, 20)
        total = sum(acc[:16])
        print(json.dumps({
            "family": family, "dtype": str(dtype)[6:], "ms": ms, "warp_kcycles": total / 1e3,
            "phases_kcycles": {names[i]: round(acc[i] / 1e3, 1) for i in names if acc[i]},
            "phases_percent": {names[i]: round(100 * acc[i] / total, 1)
                               for i in names if acc[i]},
            "producer_wait_kcycles": acc[16] / 1e3,
            "producer_kcycles": acc[17] / 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
