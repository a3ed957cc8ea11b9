"""Where a consumer warp's time goes in B9's degree kernel
(csrc/maf_degree_inverse.cuh) on one card: an instrumented copy of the
kernel reads ``clock64()`` on lane 0 of warp 0 of block 0 at each phase
boundary and sums the cycles by phase; lane 0 of the producer warp of the
same block sums the cycles it waits for a free ring slot.

    python3 tools/degree_phases.py

Copies ``nflows_tpu_torch/csrc`` to ``build/degree_phases/csrc``, inserts
the probes by pattern, builds ``maf_degree_inverse.cu`` with the port's
nvcc flags and runs the fixed point of the full-width MAF and NSF-AR
(``chip_smoke.MAF``, ``chip_smoke.NSF_AR``, random weights from seed 0, the
MAF's final weights x 0.1 as in chip_smoke.py) at N = 4,096 at each tile
size, once for the probes after a warm-up, then 20 times for the kernel's
time (CUDA events). Prints the card line, then per model and tile size one
JSON line: the phases in thousands of cycles of that warp, and the
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
OUT = ROOT / "build" / "degree_phases"
NAMES = {1: "slab set-up, epilogue of the slab before, step logic",
         2: "wait for the chunk", 3: "FMA loop", 4: "release of the slot",
         5: "depth-split reduction", 6: "transformer (and the parameters' store)",
         7: "layer permutation and logabsdet sum"}
PROBE = ('__device__ unsigned long long prof_acc[16];\n__device__ long long prof_last;\n'
         '__device__ unsigned long long prof_producer[2];\n'
         '#define PROF(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) { long long t_ = '
         'clock64(); prof_acc[k] += t_ - prof_last; prof_last = t_; } } while (0)\n')
PATCHES = (
    ('#include "tile_gemm.cuh"\n', '#include "tile_gemm.cuh"\n' + PROBE),
    ("      const WT* ws = ring.acquire(q);\n",
     "      PROF(1);\n      const WT* ws = ring.acquire(q);\n      PROF(2);\n"),
    ("      ring.release(q);\n      ++q;\n",
     "      PROF(3);\n      ring.release(q);\n      PROF(4);\n      ++q;\n"),
    ("      for (int i = 0; i < SPW; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);\n"
     "    }\n",
     "      for (int i = 0; i < SPW; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);\n"
     "    }\n    PROF(5);\n"),
    ("        xi[k * ROWS + s] = o;\n        lsum += ld;\n      }\n      __syncwarp();\n",
     "        xi[k * ROWS + s] = o;\n        lsum += ld;\n      }\n      __syncwarp();\n"
     "      PROF(6);\n"),
    ("    lad_total += lsum;\n    __syncwarp();\n",
     "    lad_total += lsum;\n    __syncwarp();\n    PROF(7);\n"),
    ("  __syncthreads();\n  if (warp == NW) {",
     "  __syncthreads();\n  if (tid == 0 && blockIdx.x == 0) prof_last = clock64();\n"
     "  if (warp == NW) {"),
    ("      if (q >= S) mbar_wait(empty + q % S, ((q / S) - 1) & 1);\n",
     "      const long long t0_ = clock64();\n"
     "      if (q >= S) mbar_wait(empty + q % S, ((q / S) - 1) & 1);\n"
     "      if (blockIdx.x == 0) prof_producer[0] += clock64() - t0_;\n"),
    ("  __device__ void produce() const {\n",
     "  __device__ void produce() const {\n    const long long start_ = clock64();\n"),
    ("      bulk_copy(slot(q), a->stream + a->chunks[2 * q], bytes, full + q % S);\n    }\n",
     "      bulk_copy(slot(q), a->stream + a->chunks[2 * q], bytes, full + q % S);\n    }\n"
     "    if (blockIdx.x == 0) prof_producer[1] += clock64() - start_;\n"),
)


def instrument(src: pathlib.Path, dst: pathlib.Path) -> None:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    text = (dst / "maf_degree_inverse.cuh").read_text()
    for old, new in PATCHES:
        if old not in text:
            raise RuntimeError(f"maf_degree_inverse.cuh no longer has {old!r}")
        text = text.replace(old, new)
    (dst / "maf_degree_inverse.cuh").write_text(text)
    with open(dst / "maf_degree_inverse.cu", "a") as f:
        f.write('\nextern "C" int prof_read(unsigned long long* out) {\n'
                '  cudaError_t e = cudaMemcpyFromSymbol(out, prof_acc, sizeof(prof_acc));\n'
                '  if (e != cudaSuccess) return (int)e;\n'
                '  return (int)cudaMemcpyFromSymbol(out + 16, prof_producer,\n'
                '                                   sizeof(prof_producer));\n}\n'
                'extern "C" int prof_reset() {\n  unsigned long long z[16] = {0};\n'
                '  cudaError_t e = cudaMemcpyToSymbol(prof_acc, z, sizeof(prof_acc));\n'
                '  if (e != cudaSuccess) return (int)e;\n'
                '  return (int)cudaMemcpyToSymbol(prof_producer, z, sizeof(prof_producer));\n}\n')


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("degree_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nflows_tpu_torch import MaskedAutoregressiveFlow, NeuralSplineFlowAR
    from nflows_tpu_torch.ops.cuda import _build
    from nflows_tpu_torch.ops.cuda import maf_flow_kernel as mfk
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    csrc = OUT / "csrc"
    instrument(ROOT / "nflows_tpu_torch" / "csrc", csrc)
    lib_path = OUT / "libmaf_degree_inverse_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib_path),
                    str(csrc / "maf_degree_inverse.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    mfk._declare_degrees(lib)
    load = _build.load_library
    _build.load_library = lambda stem, declare: (lib if stem == "maf_degree_inverse"
                                                 else load(stem, declare))
    flows = {
        "MAF": MaskedAutoregressiveFlow(generator=torch.Generator().manual_seed(0),
                                        device="cuda", **cs.MAF),
        "NSF-AR": NeuralSplineFlowAR(generator=torch.Generator().manual_seed(0),
                                     device="cuda", **cs.NSF_AR),
    }
    with torch.no_grad():
        for t in list(flows["MAF"].transform.transforms)[1::2]:
            t.autoregressive_net.final_layer.weight.mul_(0.1)
    gen = torch.Generator().manual_seed(1)
    for model, flow in flows.items():
        view = fuse_maf(flow.eval())
        x = torch.randn(4096, cs.MAF["features"], generator=gen).cuda()
        kw = dict(inverse=True, num_blocks=view._num_blocks, transformer=view._transformer,
                  spline_kw=view._spline_kw)
        for rows in (16, 32):
            run = lambda: mfk.maf_flow_kernel_cuda(  # noqa: E731
                x, view._weights, view._static, packed=view._packed, rows=rows,  # noqa: B023
                **kw)  # noqa: B023
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
                "model": model, "rows": rows, "ms": ms, "warp_kcycles": total / 1e3,
                "phases_kcycles": {NAMES[k]: round(acc[k] / 1e3, 1) for k in NAMES if acc[k]},
                "phases_percent": {NAMES[k]: round(100 * acc[k] / total, 1)
                                   for k in NAMES if acc[k]},
                "producer_wait_kcycles": acc[16] / 1e3,
                "producer_kcycles": acc[17] / 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
