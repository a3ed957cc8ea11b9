"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` at first use. All sources compile at
once, one nvcc process each. Outputs go to ``build/nflows_tpu_torch/<hash>/``
beside the package, where the hash covers every source and header and the
compiler flags: a changed source builds anew, an unchanged one loads what
is there. No ``--use_fast_math``: trained splines are sensitive to exp/log
accuracy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build_all", "load_library", "check", "BUILD_LOG"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "nflows_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BUILD_LOG = {}  # source stem -> nvcc output (ptxas register / spill report)
_LIBS = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source that has no library yet (in parallel), load all.
    Returns {stem: ctypes.CDLL}."""
    with _LOCK:
        if _LIBS:
            return dict(_LIBS)
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = [src for src in _sources()
                if not (out_dir / f"lib{src.stem}.so").exists()]
        procs = []
        for src in todo:
            tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out_dir / f"lib{src.stem}.so")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in _sources():
            _LIBS[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
        return dict(_LIBS)


def load_library(stem: str, declare) -> ctypes.CDLL:
    """The library built from ``csrc/<stem>.cu``; ``declare(lib)`` sets its
    argtypes once."""
    lib = build_all()[stem]
    if not getattr(lib, "_nflows_declared", False):
        declare(lib)
        lib._nflows_declared = True
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if code != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {code}")
