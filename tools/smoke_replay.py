"""Replay inputs that B4 met in an earlier card run of chip_smoke.py, when
the script drew them from its shared generator (it now draws them from
generators of their own, so the shared one draws for every later phase
what it drew before), and show whether the cluster path fails on them.

    python3 tools/smoke_replay.py [--case cubic2048|context4096]

``cubic2048`` (the default): the cubic chain at N = 2,048 in phase 21, as
the first card run of B3/B4's cluster layout drew it. ``context4096``: the
conditional flagship (context 10) at N = 4,096 in phase 24, as a run
during the work on B2's tensor-core route drew it, with one more batch (the
ragged N of phase 4) taken from the shared generator.

Writes a copy of chip_smoke.py to ``build/smoke_replay/chip_smoke_replay.py``
that draws those inputs from the shared generator again and stops at that
B4 launch, and runs it. There it saves x, gy, glad (and the context) and
the generator's state to ``build/smoke_replay/replay_<case>.pt``, launches
B4 40 times at one block a tile and at each cluster size, and prints for
each the samples whose gx x N (and gctx x N) lies past 5e-3 of the float64
plain version (and in how many launches), the largest difference between
launches and the error of the worst samples of the first launch. For
``context4096`` it then probes each sample past the band with
``tools/tie_probe.py``'s ``probe``: each layer's distance to its nearest
knot and smallest |relu input| in float64, and how far the float64
cotangents move when the sample moves by 1e-6 along one feature; a tie
passes within fp32 rounding of such a kink. Needs the card; takes as long
as chip_smoke.py takes to reach the phase (six to ten minutes on an H100,
the build included). ``tools/tie_probe.py --held`` probes the sample that
failed in ``cubic2048`` (``chip_smoke.TIE_X``).
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "smoke_replay"

HOOK = '''
REPLAY = {}


def investigate(x, gy, glad, tw32, tidx, tkw, d_gx, n, d_gctx=None):
    import torch

    from nflows_tpu_torch.ops.cuda import nsf_train

    ctx = tkw.get("context")
    torch.save(dict(x=x.cpu(), gy=gy.cpu(), glad=glad.cpu(),
                    ctx=None if ctx is None else ctx.cpu(), gen_state=REPLAY["state"]),
               os.path.join(REPLAY_OUT, f"replay_{REPLAY_CASE}.pt"))

    def err(g, gc):
        e = (g.double() - d_gx).abs().amax(1) * n
        if gc is not None:
            e = torch.maximum(e, (gc.double() - d_gctx).abs().amax(1) * n)
        return e

    worst, failing = None, set()
    for c in (1, *nsf_train.CLUSTER_SIZES):
        first, counts, spread, largest = None, {}, 0.0, 0.0
        for _ in range(40):
            g, grads = nsf_train.nsf_train_bwd_cuda(x, gy, glad, tw32, tidx, rows=32,
                                                    cluster=c, **tkw)
            gc = grads.get("ctx")
            e = err(g, gc)
            for s in (e > 5e-3).nonzero()[:, 0].tolist():
                counts[s] = counts.get(s, 0) + 1
            if first is None:
                first = (g.clone(), None if gc is None else gc.clone())
            spread = max(spread, float((g - first[0]).abs().max()))
            largest = max(largest, float(e.max()))
        failing.update(counts)
        e_first = err(*first)
        if worst is None:
            worst = e_first.argsort(descending=True)[:3].tolist()
        log(f"REPLAY cluster size {c}: " + json.dumps(dict(
            past_band=counts, largest_difference_between_launches=spread, max_err=largest,
            worst_of_the_first_launch={s: float(e_first[s]) for s in worst})))
    if REPLAY_CASE == "context4096":
        sys.path.insert(0, os.path.join(REPLAY_ROOT, "tools"))
        import tie_probe

        skw = {k: v for k, v in tkw.items() if k != "context"}
        w64 = {k: v.double() for k, v in tw32.items()}
        d = (d_gx, d_gctx)
        for s in sorted(failing)[:5] or worst[:1]:
            row = lambda t: None if t is None else t[s:s + 1]  # noqa: E731
            log(f"REPLAY probe of sample {s}: " + json.dumps(tie_probe.probe(
                s, x, gy, glad, tw32, tidx, ctx, skw, d, n)))
            log(f"REPLAY sample {s}: x " + json.dumps([v.hex() for v in row(x)[0].tolist()])
                + " gy " + json.dumps([v.hex() for v in row(gy)[0].tolist()])
                + " glad " + json.dumps(float(glad[s]).hex())
                + " ctx " + json.dumps([v.hex() for v in row(ctx)[0].tolist()]))
    log("REPLAY done")
    sys.exit(0)
'''


def patched(src: str, case: str) -> str:
    def sub(old, new):
        if old not in src:
            raise RuntimeError(f"chip_smoke.py no longer has {old!r}")
        return src.replace(old, new, 1)

    if case == "cubic2048":
        src = sub("fresh=(2048,)):", "fresh=()):")
        stop = "REPLAY.get('fam') == 'cubic' and n == 2048"
        src = sub('        log(f"B3 and B4 on the {fam} chain:")\n',
                  '        log(f"B3 and B4 on the {fam} chain:")\n'
                  "        REPLAY['fam'] = fam\n")
    else:
        # phase 4's ragged batch from the shared generator, as it was drawn
        src = sub("        draw = torch.Generator().manual_seed(n) if n == RAGGED else gen\n",
                  "        draw = gen\n")
        stop = "REPLAY.get('fam') == 'conditional NSF' and n == 4096"
        src = sub('    log(f"B3 and B4 on the conditional NSF (context {C}):")\n',
                  '    log(f"B3 and B4 on the conditional NSF (context {C}):")\n'
                  "    REPLAY['fam'] = 'conditional NSF'\n")
    src = sub("            draw = torch.Generator().manual_seed(n) if n in fresh else gen\n",
              "            REPLAY['state'] = gen.get_state().clone()\n"
              "            draw = torch.Generator().manual_seed(n) if n in fresh else gen\n")
    src = sub('            log(f"  largest |gx * N|: {float((d_gx * n).abs().max()):.3f}")\n'
              '            errs = [hold("gx * N", gx * n',
              '            log(f"  largest |gx * N|: {float((d_gx * n).abs().max()):.3f}")\n'
              f"            if {stop}:\n"
              "                investigate(x, gy, glad, tw32, tidx, tkw, d_gx, n,\n"
              "                            d_grads.get('ctx'))\n"
              '            errs = [hold("gx * N", gx * n')
    head = (f"REPLAY_OUT = {str(OUT)!r}\nREPLAY_ROOT = {str(ROOT)!r}\n"
            f"REPLAY_CASE = {case!r}\n")
    return sub("def main() -> int:\n", head + HOOK + "\n\ndef main() -> int:\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=("cubic2048", "context4096"), default="cubic2048")
    args = ap.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    script = OUT / "chip_smoke_replay.py"
    script.write_text(patched((ROOT / "chip_smoke.py").read_text(), args.case))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.call([sys.executable, str(script)], cwd=ROOT, env=env)


if __name__ == "__main__":
    sys.exit(main())
