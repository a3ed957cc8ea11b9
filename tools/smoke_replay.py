"""Replay the inputs B4 met on the cubic chain at N = 2,048 in the first chip
run of B3/B4's cluster layout, when chip_smoke.py drew its 2,048-sample
inputs from its shared generator (it now draws them from a generator of
their own, so the shared one draws for every later phase what it drew
before that size was added).

    python3 tools/smoke_replay.py

Writes a copy of chip_smoke.py to ``build/smoke_replay/chip_smoke_replay.py``
that draws those inputs from the shared generator again and stops at the
cubic chain's B4 at 2,048 in phase 21, and runs it. There it saves x, gy,
glad and the generator's state to ``build/smoke_replay/replay_cubic2048.pt``,
launches B4 40 times at one block a tile and at each cluster size, and
prints for each the samples whose gx x N lies past 5e-3 of the float64
plain version (and in how many launches), the largest difference between
launches and the error of the worst samples of the first launch. Needs the
card; takes as long as chip_smoke.py takes to reach phase 21 (about six
minutes on an H100, the build included). ``tools/tie_probe.py --held``
then probes the sample that fails (``chip_smoke.TIE_X``).
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "smoke_replay"

HOOK = '''
REPLAY = {}


def investigate(x, gy, glad, tw32, tidx, tkw, d_gx, n):
    import torch

    from nflows_tpu_torch.ops.cuda import nsf_train

    torch.save(dict(x=x.cpu(), gy=gy.cpu(), glad=glad.cpu(), gen_state=REPLAY["state"]),
               os.path.join(REPLAY_OUT, "replay_cubic2048.pt"))
    err = lambda g: (g.double() - d_gx).abs().amax(1) * n  # noqa: E731
    worst = None
    for c in (1, *nsf_train.CLUSTER_SIZES):
        first, counts, spread, largest = None, {}, 0.0, 0.0
        for _ in range(40):
            g, _ = nsf_train.nsf_train_bwd_cuda(x, gy, glad, tw32, tidx, rows=32, cluster=c,
                                               **tkw)
            e = err(g)
            for s in (e > 5e-3).nonzero()[:, 0].tolist():
                counts[s] = counts.get(s, 0) + 1
            first = g.clone() if first is None else first
            spread = max(spread, float((g - first).abs().max()))
            largest = max(largest, float(e.max()))
        if worst is None:
            worst = err(first).argsort(descending=True)[:3].tolist()
        log(f"REPLAY cluster size {c}: " + json.dumps(dict(
            past_band=counts, largest_difference_between_launches=spread, max_err=largest,
            worst_of_the_first_launch={s: float(err(first)[s]) for s in worst})))
    log("REPLAY done")
    sys.exit(0)
'''


def patched(src: str) -> str:
    def sub(old, new):
        if old not in src:
            raise RuntimeError(f"chip_smoke.py no longer has {old!r}")
        return src.replace(old, new, 1)

    src = sub("fresh=(2048,)):", "fresh=()):")
    src = sub("            draw = torch.Generator().manual_seed(n) if n in fresh else gen\n",
              "            REPLAY['state'] = gen.get_state().clone()\n"
              "            draw = torch.Generator().manual_seed(n) if n in fresh else gen\n")
    src = sub('            log(f"  largest |gx * N|: {float((d_gx * n).abs().max()):.3f}")\n'
              '            errs = [hold("gx * N", gx * n',
              '            log(f"  largest |gx * N|: {float((d_gx * n).abs().max()):.3f}")\n'
              "            if REPLAY.get('fam') == 'cubic' and n == 2048:\n"
              "                investigate(x, gy, glad, tw32, tidx, tkw, d_gx, n)\n"
              '            errs = [hold("gx * N", gx * n')
    src = sub('        log(f"B3 and B4 on the {fam} chain:")\n',
              '        log(f"B3 and B4 on the {fam} chain:")\n'
              "        REPLAY['fam'] = fam\n")
    return sub("def main() -> int:\n",
               f"REPLAY_OUT = {str(OUT)!r}\n" + HOOK + "\n\ndef main() -> int:\n")


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    script = OUT / "chip_smoke_replay.py"
    script.write_text(patched((ROOT / "chip_smoke.py").read_text()))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.call([sys.executable, str(script)], cwd=ROOT, env=env)


if __name__ == "__main__":
    sys.exit(main())
