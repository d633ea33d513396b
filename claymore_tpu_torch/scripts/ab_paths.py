"""Time ``chip_smoke.py``'s main paths in two checkouts on one card.

    python -m claymore_tpu_torch.scripts.ab_paths DIR_A DIR_B [--pairs 3]
        [--path dambreak_sdf:4] [--path dambreak12m:4] [--path sphere25m:1:4] ...

Each ``DIR`` is a checkout of this repository (``git archive`` of a
commit unpacked into a ``.gitignore``d directory).  Runs alternate A B B A
A B ...; each is a subprocess started in its checkout with it first on
``PYTHONPATH``, which builds that checkout's kernels and drives every
``--path`` (``scene:defrag_every[:rebucket_every]``, 80 timed substeps,
dambreak_sdf its 1,749; ``rebucket_every`` 3..8 runs the span-4 arenas with
the scene's own rebuild trigger, drift for every bench scene) through
``chip_smoke.drive``.  Prints one ``AB {...}`` JSON line
per run: the checkout, and per path ms/substep, the rebuilds by kind
(full, incremental, fallen back to the full sort) with their mean ms, and
the failed checks.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r'''
import json, sys
import chip_smoke as cs
from claymore_tpu_torch.ops import _build
_build.build()
_build.library()
keys = ("ms_per_substep", "ms_drift_only", "rebuilds", "rebuilds_full", "rebuilds_incremental", "rebuilds_fallback",
        "ms_rebuilding_full", "ms_rebuilding_incremental", "ms_rebuilding_fallback",
        "mass_rel_err", "failed_checks")
out = {}
for spec in sys.argv[1:]:
    name, defrag, *every = spec.split(":")
    steps = cs.SDF_STEPS if name == "dambreak_sdf" else 80
    kw = {"rebucket_every": int(every[0])} if every else {}
    m = cs.drive(name, steps=steps, facts="", strict=False,
                 defrag_every=int(defrag), **kw)["metrics"]
    out[spec] = {k: m[k] for k in keys}
print("AB " + json.dumps(out), flush=True)
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("ab_paths", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dirs", nargs=2, help="the two checkouts, A and B")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--path", action="append", dest="paths",
                    help="scene:defrag_every[:rebucket_every] (default dambreak12m:4, "
                         "dambreak_sdf:4, dambreak_sdf:1)")
    args = ap.parse_args(argv)
    paths = args.paths or ["dambreak12m:4", "dambreak_sdf:4", "dambreak_sdf:1"]
    order = "".join("AB" if i % 2 == 0 else "BA" for i in range(args.pairs))
    failed = 0
    for v in order:
        tree = os.path.abspath(args.dirs[v == "B"])
        proc = subprocess.run([sys.executable, "-c", _CHILD, *paths], cwd=tree,
                              capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": tree})
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode or not line:
            print(f"run {v} in {tree} failed ({proc.returncode}):\n{proc.stderr[-3000:]}",
                  file=sys.stderr, flush=True)
            failed += 1
            continue
        print("AB " + json.dumps({"checkout": v, "dir": args.dirs[v == "B"],
                                  **json.loads(line[0][3:])}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
