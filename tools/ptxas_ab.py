"""Compare the ptxas report of two checkouts of the port, kernel by kernel:
registers, spill stores and loads, and stack frame of every function nvcc
compiles for sm_90a.

    python3 tools/ptxas_ab.py OLD_CHECKOUT [NEW_CHECKOUT]

Each side builds its ``csrc/*.cu`` anew with its own ``ops/cuda/_build.py``
(``-Xptxas -v``), into its own build directory, where the libraries stay
for later runs (``tools/checkout_ab.py``), in a process of its own, both at
once. Function names are demangled
(``cu++filt``, else ``c++filt``) and the weight-type template argument
``float`` dropped, so that an fp32 instantiation of a kernel that gained a
weight type pairs with its parent. Prints the card line, one JSON line for
every function on both sides whose numbers differ or that only one side
has, then a summary; exits 1 if a function both sides have differs.
NEW_CHECKOUT defaults to this checkout. Make OLD_CHECKOUT with ``git archive
<commit> | tar -x -C <dir>`` into a directory that .gitignore lists.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BUILD = r"""
import json, shutil, sys
sys.path.insert(0, ".")
from nflows_tpu_torch.ops.cuda import _build
shutil.rmtree(_build.BUILD_ROOT / _build._digest(), ignore_errors=True)
_build.build_all()
print(json.dumps(_build.BUILD_LOG))
"""

ENTRY = re.compile(r"Compiling entry function '(\S+)'")
PROPS = re.compile(r"Function properties for (\S+)")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")


def _demangler():
    for name in ("cu++filt", "c++filt"):
        found = shutil.which(name) or shutil.which(
            os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name))
        if found:
            return found
    raise RuntimeError("neither cu++filt nor c++filt was found")


def parse(log: str) -> dict:
    """{mangled name: {"registers", "stack", "spill_stores", "spill_loads"}}"""
    out, current = {}, None
    for line in log.splitlines():
        for pattern in (ENTRY, PROPS):
            m = pattern.search(line)
            if m:
                current = m.group(1)
                out.setdefault(current, {})
        m = FRAME.search(line)
        if m and current:
            out[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = REGS.search(line)
        if m and current:
            out[current]["registers"] = int(m.group(1))
    return out


def normalise(names):
    """Demangled names with the ``float`` weight-type argument, references to
    template parameters (``FlowArgs<T4>``) and the return type of template
    functions dropped."""
    text = subprocess.run([_demangler()], input="\n".join(names), capture_output=True,
                          text=True, check=True).stdout.splitlines()
    out = []
    for t in text:
        t = re.sub(r", float>", ">", t)
        t = re.sub(r"<(float|T\d+)>", "", t)
        out.append(re.sub(r"^void ", "", t))
    return out


def report(checkout: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", BUILD], cwd=checkout, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def table(proc) -> dict:
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(stderr)
    logs = json.loads(stdout.strip().splitlines()[-1])
    out = {}
    for stem, log in logs.items():
        funcs = parse(log)
        for name, norm in zip(funcs, normalise(list(funcs))):
            out[(stem, norm)] = funcs[name]
    return out


def main(argv) -> int:
    if not 1 <= len(argv) <= 2:
        sys.exit(__doc__)
    old = os.path.abspath(argv[0])
    new = os.path.abspath(argv[1]) if len(argv) == 2 else ROOT
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    procs = report(old), report(new)
    before, after = (table(p) for p in procs)
    differ = 0
    for key in sorted(set(before) | set(after)):
        a, b = before.get(key), after.get(key)
        if a == b:
            continue
        if a is not None and b is not None:
            differ += 1
        print(json.dumps({"source": key[0], "function": key[1], "old": a, "new": b}))
    both = set(before) & set(after)
    print(json.dumps({"functions_old": len(before), "functions_new": len(after),
                      "on_both_sides": len(both), "differing": differ,
                      "only_new": len(set(after) - set(before)),
                      "only_old": len(set(before) - set(after))}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
