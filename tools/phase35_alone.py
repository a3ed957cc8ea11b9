"""chip_smoke.py's phase 35 (the linear and normalization transforms of
queue A6) alone, with the ``cuda`` tests of tests/test_torch_cuda.py that
hold the same paths, building B1's source only: a check in minutes, not
the whole script's build, after touching these transforms or the NSF-AR's
B1 path.

    python3 tools/phase35_alone.py

Runs, on the card: B1 as the NSF-AR with LU layers calls it (both
directions), an LULinear against float64 uncached and cached, the launches
of a small NSF-AR-LU request (the ``cuda`` tests, called directly, so
without pytest and its conftest), then ``chip_smoke.phase_a6`` with the B1
launch counter, which prints each hold, each request's wall and busy time,
the eager steps and the windows against the per-step loop. Needs the card.
"""

from __future__ import annotations

import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import torch

    if not torch.cuda.is_available():
        print("phase35_alone: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from nflows_tpu_torch.ops.cuda import _build, rq_spline

    every = _build._sources
    _build._sources = lambda: [p for p in every() if p.stem == "rq_spline"]
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build of B1: {time.perf_counter() - t0:.1f} s", flush=True)

    import test_torch_cuda as cuda_tests

    dev = torch.device("cuda", 0)
    for inverse in (False, True):
        cuda_tests.test_b1_as_the_nsf_ar_lu_flow_calls_it(dev, inverse)
    cuda_tests.test_lu_on_the_card_is_fp32_against_float64(dev)
    cuda_tests.test_an_nsf_ar_lu_request_launches_b1(dev)
    print("the A6 cuda tests passed", flush=True)

    print(chip_smoke.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def reset():
        rq_spline.launch_count = 0

    def expect(what, counts, **expected):
        expected = {**{k: 0 for k in counts}, **expected}
        if counts != expected:
            raise AssertionError(f"{what} launched {counts}, expected {expected}")

    counts = types.SimpleNamespace(reset=reset, expect=expect,
                                   read=lambda: {"B1": rq_spline.launch_count})
    keys, _ = chip_smoke.phase_a6(torch, dev, counts, {})
    print(keys)
    return 0


if __name__ == "__main__":
    sys.exit(main())
