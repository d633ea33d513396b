"""Time ``chip_smoke.py``'s main paths in two checkouts on one card.

    python -m claymore_tpu_torch.scripts.ab_paths DIR_A DIR_B [--pairs 3]
        [--path dambreak_sdf:4] [--path dambreak12m:4] [--path sphere25m:1:4]
        [--path multi:sphere25m:2x2] [--path multi:config5:4x2] [--path ops:cube:2x2] ...

Each ``DIR`` is a checkout of this repository (``git archive`` of a
commit unpacked into a ``.gitignore``d directory).  Runs alternate A B B A
A B ...; each is a subprocess started in its checkout with it first on
``PYTHONPATH``, which builds that checkout's kernels and drives every
``--path`` (``scene:defrag_every[:rebucket_every]``, 80 timed substeps,
dambreak_sdf its 1,749; ``rebucket_every`` 3..8 runs the span-4 arenas with
the scene's own rebuild trigger, drift for every bench scene) through
``chip_smoke.drive``, and every ``multi:scene:mesh`` (a bench scene on a
mesh such as ``2x2`` or ``4``, every shard on the card, as
``chip_smoke.multi_run`` builds it; ``multi:config5:4x2`` is
``scenes/sphere_100m_8dev.json`` through ``load_scene``): one warm-up
substep, then 20 substeps (config 5: 6), each stage timed by CUDA events
where ``substep_impl`` calls ``on_stage``.  Prints one ``AB {...}`` JSON
line per run: the checkout, and per path ms/substep, the rebuilds by kind
(full, incremental, fallen back to the full sort) with their mean ms, and
the failed checks; per mesh ms/substep, the stage means, the peak and the
loss counters.  Every ``ops:scene:mesh`` counts the device operations
(``torch.profiler``, ``utils.timers.device_ops``) of one ``exchange_halo``
with its ``wait_halo``, every shard's ``halo_mass_mask`` and ``add_halo``,
and one ``migrate`` with every shard rebuilding, on the mesh's state after
one substep, through the checkout's own ``HaloComm``; the profiler slows
what runs after it in the process, so give ``ops:`` paths last.  Needs a
card.
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


def multi(name, mesh, steps):
    import time
    import numpy as np
    import torch
    import claymore_tpu_torch as ct
    torch.cuda.reset_peak_memory_stats()
    if name == "config5":
        from claymore_tpu_torch.io.scene import load_scene
        eng = load_scene(str(cs.C5_SCENE), device="cuda", tile_chunk=64)
        eng, state = eng.engine, eng.state
    else:
        cfg, mats, parts, v0s, cols = cs.scene(name)
        eng = ct.MultiChipEngine(cfg, mats, mesh_shape=mesh, device="cuda", tile_chunk=64,
                                 migration_capacity=cs.MIG_CAP, colliders=cols,
                                 particle_capacity_factor=2.5 if name == "dambreak12m" else 1.5)
        state = eng.init_state(parts, v0s)
    fe = np.float32(1e9)
    state = eng.substep(state, fe)
    events = []
    def on_stage(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1].append((stage, ev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        events.append([("start", start)])
        state = eng.substep(state, fe, on_stage=on_stage)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = {}
    for evs in events:
        for (_, a), (stage, b) in zip(evs[:-1], evs[1:]):
            stages.setdefault(stage, []).append(a.elapsed_time(b))
    d = eng.diagnostics(state)
    return {"ms_per_substep": wall / steps * 1e3, "rebuilds": eng.rebuilds,
            "stage_ms": {k: float(np.mean(v)) for k, v in stages.items()},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "active": d["model0_active"], "migration_dropped": d["migration_dropped"],
            "halo_overflow": d["halo_overflow"], "block_overflow": d["block_overflow"]}


def ops(name, mesh):
    import numpy as np
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.utils.timers import device_ops
    cfg, mats, parts, v0s, cols = cs.scene(name)
    eng = ct.MultiChipEngine(cfg, mats, mesh_shape=mesh, device="cuda", tile_chunk=64,
                             migration_capacity=cs.MIG_CAP, colliders=cols)
    state = eng.substep(eng.init_state(parts, v0s), np.float32(1e9))
    comm = eng.comm
    got = {}
    def exchange():
        got["received"], _ = comm.exchange_halo([s.grid for s in state],
                                                [s.partition for s in state])
        comm.wait_halo()
    out = {"exchange_halo": device_ops(exchange)}
    rv = got["received"]
    out["halo_mass_mask"] = device_ops(lambda: [comm.halo_mass_mask(r) for r in rv])
    pools = [s.grid.clone() for s in state]
    out["add_halo"] = device_ops(lambda: [comm.add_halo(p, s.partition, r)
                                          for p, s, r in zip(pools, state, rv)])
    models = [list(s.models) for s in state]
    out["migrate"] = device_ops(lambda: comm.migrate(models, [True] * len(state)))
    out["received_directions"] = [len(r) for r in rv]
    return out


out = {}
for spec in sys.argv[1:]:
    if spec.startswith("ops:"):
        _, name, mesh = spec.split(":")
        out[spec] = ops(name, tuple(int(x) for x in mesh.split("x")))
        continue
    if spec.startswith("multi:"):
        _, name, mesh = spec.split(":")
        out[spec] = multi(name, tuple(int(x) for x in mesh.split("x")),
                          6 if name == "config5" else 20)
        continue
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
                    help="scene:defrag_every[:rebucket_every], multi:scene:mesh or "
                         "ops:scene:mesh "
                         "(default dambreak12m:4, dambreak_sdf:4, dambreak_sdf:1)")
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
