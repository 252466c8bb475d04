"""Run one `chip_smoke.py` phase from several checkouts in turns, each in a
process of its own, on the card in one call.

    git archive <commit> | tar -x -C build/parent    # a git-ignored copy
    python3 tools/phase_ab.py --phase kernels,batched_kernels \
        --tree parent=build/parent --tree this=. [--turns parent,this,this,parent]

Each turn imports the checkout's own `chip_smoke.py` and `src/repro_torch`
(its kernels built from its own sources into its own `build/kernels/`),
runs each `phase_<name>(peaks)` (or `phase_<name>()` when the phase takes
no peaks) in order and prints the phases' JSON lines, each tagged with
the turn's tree name and turn number. Compare two versions only within
one call, in turns (the card's power limit and its host's load differ
from call to call). Needs a CUDA card and nvcc; imports neither jax nor the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import inspect, json, sys
sys.path[:0] = ["src", "."]
import torch
import chip_smoke as cs
peaks = cs.peaks_for(torch.cuda.get_device_name(0))[1]
emit = cs.emit
def tagged(obj):
    emit(dict(obj, tree={tree!r}, turn={turn}))
cs.emit = tagged
for name in {phases!r}:
    phase = getattr(cs, "phase_" + name)
    phase(*((peaks,) if "peaks" in inspect.signature(phase).parameters else ()))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", required=True)
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=PATH of a checkout")
    ap.add_argument("--turns", default=None,
                    help="comma-separated tree names, in order "
                         "(default: each tree, then each in reverse)")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    turns = args.turns.split(",") if args.turns else \
        list(trees) + list(trees)[::-1]
    for turn, name in enumerate(turns):
        root = Path(trees[name]).resolve()
        code = RUN.format(phases=args.phase.split(","), tree=name, turn=turn)
        res = subprocess.run([sys.executable, "-c", code], cwd=root,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
        for ln in res.stdout.splitlines():
            if ln.startswith("{"):
                print(ln, flush=True)
        if res.returncode != 0:
            print(json.dumps(dict(tree=name, turn=turn, rc=res.returncode,
                                  stderr=res.stderr[-3000:])), flush=True)
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
