"""Where a tile's time goes in B3's cluster layout (csrc/nsf_train_cluster.cu)
on one card: an instrumented copy of the kernel reads ``clock64()`` on thread
0 of block 0 at each phase boundary and sums the cycles by phase.

    python3 tools/cluster_phases.py [CLUSTER_SIZE ...]

Copies ``nflows_tpu_torch/csrc`` to ``build/cluster_phases/csrc``, inserts
the probes by pattern (each GEMM's first-chunk wait, its K loop, its
reduction, epilogue and stores into the other blocks, its cluster barrier;
the restores, weight gradients, the coupling stage and its adjoint, the
initial layer, the merges), builds it with the port's nvcc flags and runs
B3 on the full-width flagship (``chip_smoke.FLAGSHIP``, random weights
from seed 0) at N = 512 on clusters of each size given (default 8 and 4),
once for the probes after a warm-up, then 20 times for the kernel's device
time. Prints the card line, then per cluster size one JSON line and the
phases with more than 0.5% of the cycles, in thousands of cycles a tile of
block 0 of cluster 0. The probes cost a few percent of the kernel's time;
block 0 waits at every barrier for the others, so a phase that ends in a
barrier carries their imbalance.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "cluster_phases"
NAMES = {0: "tile load", 5: "P scale + stash", 6: "forward stage", 7: "forward merge",
         8: "loss + cluster barrier", 10: "stage adjoint", 14: "restores", 15: "weight gradients",
         17: "initial layer (gw0, gb0, ga0)", 18: "merge + layer cluster barrier",
         3: "GEMM call sites", 20: "GEMM: K loop after the first chunk",
         21: "GEMM: reduction, epilogue, stores", 22: "GEMM: final barrier",
         23: "GEMM: staging and wait of the first chunk"}
CHUNK_BARRIER = "      __syncthreads();  // chunk c is in; every warp is done with chunk c - 1\n"
GEMM_END = "  if (exchange) cluster_sync();\n  else __syncthreads();\n}"
PARTIALS = "\n#pragma unroll\n    for (int j = 0; j < 4; ++j)\n#pragma unroll\n      for (int half"
PROBE = ('__device__ unsigned long long prof_acc[32];\n__device__ long long prof_last;\n'
         '#define PROF(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) { long long t_ = '
         'clock64(); prof_acc[k] += t_ - prof_last; prof_last = t_; } } while (0)\n')


def instrument(src: pathlib.Path, dst: pathlib.Path) -> None:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    gemm = (dst / "cluster_gemm.cuh").read_text()
    for old, new in (
            ('#include "tile_gemm.cuh"\n', '#include "tile_gemm.cuh"\n' + PROBE),
            (CHUNK_BARRIER, CHUNK_BARRIER + "      if (c == 0) PROF(23);\n"),
            (PARTIALS, "\n    PROF(20);" + PARTIALS),
            (GEMM_END, "  PROF(21);\n" + GEMM_END[:-2] + "\n  PROF(22);\n}")):
        if old not in gemm:
            raise RuntimeError(f"cluster_gemm.cuh no longer has {old!r}")
        gemm = gemm.replace(old, new)
    (dst / "cluster_gemm.cuh").write_text(gemm)
    after_barrier = {"xs[e] = s < rows": 0, "nflows::coupling_stage_eval": 6,
                     "stage_adjoint_eval(": 10, "restore<ROWS>(": 14,
                     "const float* w0 = a.w0": 17, "pst[at] = v;": 5, "ladacc[s] += sum;": 7,
                     "gnext[s * D + tr_src[t]] = ybuf[e];": 18}
    after_statement = {"cl_wgrad(": 15, "cl_gemm<CS": 3}
    out, wait_barrier, wait_statement = [], [], []
    for line in (dst / "nsf_train_cluster.cu").read_text().split("\n"):
        out.append(line)
        st = line.strip()
        if wait_barrier and st.startswith(("__syncthreads();", "cluster_sync();")):
            out += [f"PROF({k});" for k in wait_barrier]
            wait_barrier = []
        for mark, k in after_barrier.items():
            if mark in line and k not in wait_barrier:
                wait_barrier.append(k)
        for mark, k in after_statement.items():
            if mark in line:
                wait_statement.append(k)
        if wait_statement and st.endswith(";"):
            out += [f"PROF({k});" for k in wait_statement]
            wait_statement = []
        if "every block's rows of the last layer's P" in line:
            out.append("PROF(8);")
    text = "\n".join(out).replace(
        "  const int rank = nflows::cluster_rank();",
        "  if (threadIdx.x == 0 && blockIdx.x == 0) prof_last = clock64();\n"
        "  const int rank = nflows::cluster_rank();")
    text += ('\nextern "C" int prof_read(unsigned long long* out) {\n'
             '  return (int)cudaMemcpyFromSymbol(out, prof_acc, sizeof(prof_acc));\n}\n'
             'extern "C" int prof_reset() {\n  unsigned long long z[32] = {0};\n'
             '  return (int)cudaMemcpyToSymbol(prof_acc, z, sizeof(z));\n}\n')
    (dst / "nsf_train_cluster.cu").write_text(text)


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cluster_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nflows_tpu_torch import NeuralSplineFlow
    from nflows_tpu_torch.ops.cuda import _build, nsf_train
    from nflows_tpu_torch.ops.cuda import nsf_flow_kernel as nfk

    sizes = [int(a) for a in argv] or [8, 4]
    print(cs.card_line(), flush=True)
    instrument(ROOT / "nflows_tpu_torch" / "csrc", OUT / "csrc")
    lib_path = OUT / "libnsf_train_cluster_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(OUT / "csrc"), "-o",
                    str(lib_path), str(OUT / "csrc" / "nsf_train_cluster.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    nsf_train._declare_cluster(lib)
    load = _build.load_library
    _build.load_library = lambda stem, declare: (lib if stem == "nsf_train_cluster"
                                                 else load(stem, declare))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    flow = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                            rng=np.random.default_rng(0), device=dev, **cs.FLAGSHIP).eval()
    tr = nsf_train.FusedNSFTrainer(flow, 512)
    w = {k: v.detach() for k, v in tr.weights.items()}
    kw = dict(wh_scale=tr._wh_scale, **tr._static)
    packed = nfk.pack_weights(w, tr._indices)
    grads = {k: torch.empty_like(v) for k, v in w.items()}
    n = 512
    x = (1.5 * torch.randn(n, cs.FLAGSHIP["features"],
                           generator=torch.Generator().manual_seed(1))).to(dev)
    for c in sizes:
        run = lambda: nsf_train.nsf_loss_grad_cuda(  # noqa: E731
            x, w, tr._indices, packed=packed, grads=grads, rows=32, cluster=c, **kw)
        _, _, grid = nsf_train.launch_layout(True, n, tr._dims, dev, 32, c)
        tiles = len(range(0, -(-n // 32), grid // c))  # the tiles of cluster 0
        run()
        torch.cuda.synchronize()
        lib.prof_reset()
        run()
        torch.cuda.synchronize()
        acc = (ctypes.c_ulonglong * 32)()
        lib.prof_read(acc)
        ms = cs.device_ms(torch, run, 20, kernel="nsf_loss_grad")
        total = sum(acc)
        print(json.dumps({"cluster_size": c, "n": n, "grid": grid, "kernel_ms": ms,
                          "tiles_of_cluster_0": tiles,
                          "kcycles_a_tile": total / tiles / 1e3}), flush=True)
        for k in sorted(range(32), key=lambda k: -acc[k]):
            if acc[k] > total / 200:
                print(f"  {NAMES.get(k, k):44s} {acc[k] / tiles / 1e3:9.1f} kcycles a tile "
                      f"{100 * acc[k] / total:5.1f}%", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
