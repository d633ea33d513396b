"""Stage timings of the full rebuild on the 1M-particle cube.

    python -m claymore_tpu_torch.scripts.prof_rebuild [--device cuda|cpu]
        [--quick] [--iters 10] [--reps 3]

The port of ``scripts/prof_rebuild.py``: ``bench.py``'s cube (1,061,208
FixedCorotated particles; 226,981 with ``--quick``) with tile capacities
``exact_tiles(slack=1.25)``, after ``init_state``, timed one stage after
another under the JAX script's names:

* ``sort``: the home-block keys and their stable sort, alone
  (``ops/rebucket_kernel.py:sort_keys``: on a card the keys kernel, then
  torch's sort);
* ``sort_permute``: the full rebucket as the engine runs it,
  ``ops/rebucket_kernel.py:sort_permute`` (on a card the sort, then the
  CUDA kernels of ``csrc/rebucket.cu``; on the CPU the plain version);
* ``table_rebuild+remap``: the partition rebuild as the engine runs it,
  ``ops/partition_kernel.py:rebuild`` (the oct set, its compaction, the
  table and the pool rows remapped; on a card the kernels of
  ``csrc/partition.cu``, on the CPU the plain ``core/partition.py:rebuild``).

Each is the best of ``--reps`` runs of ``--iters`` calls back to back (CUDA
events on a card, the host clock on the CPU).  ``permute`` is
``sort_permute`` less ``sort``: what the slot plan and the placement add to
the sort; ``plan`` and ``place`` time those two stages alone on the sorted
keys (``tile_plan``, ``place``).  ``sort_gkeys_per_s`` is the keys sorted
per second.  On a card, after the timings, ``device_ops`` counts the
device operations (``torch.profiler``) of one partition rebuild +
``finalize_tiles`` and of one ``first_marked`` of the slots' free flags
(into at most 262,144 indices, a mesh's migration capacity), through the
kernels and through their plain twins.  Prints one JSON line; exits 2 when
``--device cuda`` finds no card.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("prof_rebuild", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quick", action="store_true", help="bench.py's quick cube")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("prof_rebuild: --device cuda but no CUDA device is available",
              file=sys.stderr)
        return 2
    from .. import MPMEngine
    from ..core import partition as part
    from ..ops import partition_kernel as pk
    from ..ops import rebucket_kernel as rk
    from ..utils.timers import best_ms, device_label, device_ops
    from .prof_k1 import scene

    dev = torch.device(args.device)
    cfg, mat, pos, v0 = scene("cube_quick" if args.quick else "cube")
    eng = MPMEngine(cfg, [mat], tile_chunk=64, device=dev)
    state = eng.init_state([pos], [v0])
    model = state.models[0]
    nt = model.tiles.block.shape[0]
    tk = part.tile_block_keys(cfg, model.tiles)
    skey, perm, _ = rk.sort_keys(cfg, model)
    dstart, dlen, _, _ = rk.tile_plan(cfg, skey, nt)

    stages = {
        "sort": lambda: rk.sort_keys(cfg, model),
        "sort_permute": lambda: rk.sort_permute(cfg, model, nt),
        "table_rebuild+remap": lambda: pk.rebuild(cfg, state.grid, state.partition, (tk,)),
        "plan": lambda: rk.tile_plan(cfg, skey, nt),
        "place": lambda: rk.place(cfg, model, perm, dstart, dlen),
    }
    out = {k: best_ms(f, dev, iters=args.iters, reps=args.reps) for k, f in stages.items()}
    out["permute"] = out["sort_permute"] - out["sort"]
    slots = int(model.pos.shape[1])
    out.update(particles=int(pos.shape[0]), slots=slots,
               sort_gkeys_per_s=slots / out["sort"] / 1e6, device=device_label(dev))
    if dev.type == "cuda":
        free, k = ~model.active, min(262144, slots)
        chains = {
            "rebuild+finalize": lambda m: m[1](cfg, m[0](cfg, state.grid, state.partition,
                                                         (tk,))[0], tk, model.tiles.dropped),
            "first_marked": lambda m: m[2](free, k, slots)}
        ways = {"kernels": (pk.rebuild, pk.finalize_tiles, pk.first_marked),
                "plain": (part.rebuild, part.finalize_tiles, part._first_marked)}
        out["device_ops"] = {name: {w: device_ops(lambda: chain(fns)) for w, fns in ways.items()}
                             for name, chain in chains.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
