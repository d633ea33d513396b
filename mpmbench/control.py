"""Readings for the check's limits, at a cell's own size (run on a card).

    python3 mpmbench/control.py --workload <cell> [--program-seeds 1,2,...]
        [--control-seeds 7,8,9] [--faults unchanged,half,altered,...]
        [--fault-seeds 11,12,13] [--seconds 1] [--out FILE]

* program seeds: whole runs of the cell (a short window), each the
  program's compared numbers; the largest over a dozen seeds or more is a
  number's lower reading;
* control seeds: the control, the reference computed in bfloat16 (the
  precision below the configuration's float32; positions stay float32, see
  ``reference/mpm.py``) put in the program's place and compared with the
  float32 reference over the substeps the program's check compares
  (``--substeps``, or what the cell's first program run compared); the
  least over three seeds or more is an upper reading;
* faults (``faults.py``): whole runs with the timed path broken
  underneath, on the fault seeds (a mesh's also ``halo_dropped`` and
  ``migrants_lost``).

A mesh cell's program runs also give ``moved``, the particles held by
another shard than at set-up when compared.

Each reading is one JSON line on standard output (and appended to
``--out``).  The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("mpmbench.control", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--substeps", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from mpmbench import check, harness, scene
    from mpmbench.reference.mpm import DenseMPM, expected_mass

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cell = scene.load_cell(args.workload)
    config = cell["configuration"]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, cell=args.workload, device=torch.cuda.get_device_name(dev)))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    substeps = args.substeps
    runs = [("program", s, None) for s in args.program_seeds]
    runs += [("fault", s, f) for f in args.faults.split(",") if f for s in args.fault_seeds]
    for kind, seed, fault in runs:
        t0 = time.time()
        r = harness.run_cell(cell, seed, args.seconds, False, dev, t_start=t0, fault=fault,
                             log=lambda s: print(s, flush=True))
        emit({"kind": kind, "fault": fault, "seed": seed, "correct": r["correct"],
              "checks": {k: v for k, (v, _) in r["checks"].items()},
              "failed": r["failed"], "attempted": r["attempted"],
              "compared_substeps": r["compared_substeps"], "rebuilds": r["rebuilds"],
              "moved": r.get("moved"),
              "substeps": r["substeps"], "setup_s": r["setup_s"],
              "seconds": time.time() - t0})
        if kind == "program" and substeps is None:
            substeps = r["compared_substeps"]
        del r
        free()

    counts = [int(m["particles"]) for m in config["models"]]
    dx = 1.0 / (1 << int(config["sim"]["domain_bits"]))
    frame_end = float(cell["traffic"]["frame_end"])
    for seed in args.control_seeds:
        t0 = time.time()
        ref = DenseMPM(config, scene.make_inputs(config, seed, dev), torch.float32, dev,
                       frame_end).run(substeps).outputs()
        t_ref = time.time() - t0
        low = DenseMPM(config, scene.make_inputs(config, seed, dev), torch.bfloat16, dev,
                       frame_end).run(substeps).outputs()
        checks, attempted, failed = check.compare(low, ref, dx, expected_mass(config, counts),
                                                  cell["check"]["limits"])
        emit({"kind": "control", "seed": seed, "substeps": substeps,
              "checks": {k: v for k, (v, _) in checks.items()},
              "correct": check.passed(checks), "failed": failed, "attempted": attempted,
              "reference_s": t_ref, "seconds": time.time() - t0})
        del ref, low
        free()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
