"""What a mesh costs on one device, and what its exchanges copy.

    python -m claymore_tpu_torch.scripts.prof_multichip [--device cuda|cpu]
        [--quick] [--steps 20] [--reps 3]

The port of ``scripts/prof_multichip.py``, on ``bench.py``'s cube
(1,061,208 FixedCorotated particles; 226,981 with ``--quick``; a 5-bit
domain box on the CPU with ``--quick --device cpu``):

* ``single_ms_per_step``: ``MPMEngine``, milliseconds per substep (host
  clock around ``--steps`` substeps ended by a synchronise, best of
  ``--reps``, after two warm-up substeps);
* ``mesh1_ms_per_step``: ``MultiChipEngine`` on a mesh of one shard, the
  same way, and ``spmd_overhead_pct``, its cost over ``MPMEngine``'s (both
  engines size their tiles alike, ``exact_tiles(slack=1.3)``);
* ``mesh1_bytes``, ``2x2_bytes``: ``HaloComm.exchanged_bytes`` of the
  mesh of one (nothing) and of a 2x2 mesh of four shards on the device
  after its init: the halo bytes copied per substep at the static
  ``halo_capacity``, what a trimmed exchange would copy, and the migration
  bytes of a substep on which every shard rebuilds;
* ``config5_4x2_bytes``: the same count for ``scenes/sphere_100m_8dev.json``'s
  capacities (domain_bits 10, a 4x2 mesh, ``halo_capacity`` 8192), from
  the shapes alone;
* with ``--config5shard``, one shard of that scene on one device, as the
  JAX script's mode of the same name times it: ``MPMEngine`` at
  domain_bits 10 (``max_active_blocks`` 40960, dt 5e-5, drift-triggered
  rebuilds, tiles of 512 sized by ``exact_tiles(slack=1.25)``) on a
  FixedCorotated sphere of radius 0.0703 at (0.5, 0.55, 0.5), ~12.5M
  particles, falling at 0.5: ``config5_shard_particles``,
  ``config5_shard_ms_per_step`` (two warm-up substeps, then ``--steps``,
  best of ``--reps``) and ``config5_shard_dropped`` (particles dropped
  from the tiles).  With ``--quick`` the sphere's radius alone shrinks,
  to 0.01 (~36K particles); the grid stays at domain_bits 10.

Prints one JSON line; exits 2 when ``--device cuda`` finds no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

C5_CENTER = (0.5, 0.55, 0.5)
C5_RADIUS = 0.0703          # 12.5M particles = (4/3) pi r^3 * 1024^3 cells * 8 ppc
C5_QUICK_RADIUS = 0.01


def config5_shard(radius: float = C5_RADIUS):
    """(cfg, material, positions, v0) of one shard of config 5 (the JAX
    script's ``--config5shard``, ``scripts/prof_multichip.py:137-166``)."""
    import claymore_tpu_torch as ct
    from ..io.sampler import sample_sphere

    cfg = ct.SimConfig(domain_bits=10, max_active_blocks=40960, default_dt=5e-5,
                       rebucket_auto=True, particle_tile=512)
    pos = sample_sphere(cfg.dx, C5_CENTER, radius, cfg.ppc)
    cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, [pos], slack=1.25))
    mat = ct.FixedCorotated(volume=cfg.default_volume(), e=5e3, nu=0.4)
    return cfg, mat, pos, (0.0, -0.5, 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("prof_multichip", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quick", action="store_true",
                    help="bench.py's quick cube; with --config5shard the shard's sphere "
                         f"shrinks to radius {C5_QUICK_RADIUS} (the grid stays at "
                         "domain_bits 10)")
    ap.add_argument("--config5shard", action="store_true",
                    help="also time one shard of config 5 (12.5M particles, domain_bits 10)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("prof_multichip: --device cuda but no CUDA device is available",
              file=sys.stderr)
        return 2
    import claymore_tpu_torch as ct
    from ..io.sampler import sample_uniform_box_world
    from ..parallel.multi import HaloComm, LocalGroup
    from ..utils.timers import device_label
    from .bench import build

    dev = torch.device(args.device)
    if args.quick and dev.type == "cpu":
        cfg = ct.SimConfig(domain_bits=5, max_active_blocks=256, default_dt=5e-4,
                           rebucket_auto=True)
        mat = ct.FixedCorotated(volume=cfg.default_volume(), e=5e3, nu=0.4)
        pos = sample_uniform_box_world(cfg.dx, [0.35] * 3, [0.6] * 3, cfg.ppc)
        v0, chunk = (0.0, -0.5, 0.0), 4
    else:
        cfg, (mat,), (pos,), (v0,), _ = build("cube", args.quick)
        chunk = 64
    cfg = dataclasses.replace(cfg, max_tiles=0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def ms_per_step(eng, state):
        """(best ms/substep, the final state)."""
        state = eng.run_steps(state, 2, 1e9)
        best = float("inf")
        for _ in range(args.reps):
            sync()
            t0 = time.perf_counter()
            state = eng.run_steps(state, args.steps, 1e9)
            sync()
            best = min(best, time.perf_counter() - t0)
        return best / args.steps * 1e3, state

    out = {"particles": int(pos.shape[0]), "device": device_label(dev)}
    single = ct.MPMEngine(cfg, [mat], tile_chunk=chunk, device=dev)
    out["single_ms_per_step"], _ = ms_per_step(single, single.init_state([pos], [v0]))
    mesh1 = ct.MultiChipEngine(cfg, [mat], n_devices=1, tile_chunk=chunk, device=dev,
                               particle_capacity_factor=1.3)
    st = mesh1.init_state([pos], [v0])
    out["mesh1_ms_per_step"], _ = ms_per_step(mesh1, st)
    out["spmd_overhead_pct"] = (out["mesh1_ms_per_step"] / out["single_ms_per_step"] - 1) * 100
    out["mesh1_bytes"] = mesh1.comm.exchanged_bytes([s.partition for s in st],
                                                    st[0].models)
    del st
    mesh4 = ct.MultiChipEngine(cfg, [mat], mesh_shape=(2, 2), tile_chunk=chunk, device=dev)
    st = mesh4.init_state([pos], [v0])
    out["2x2_bytes"] = mesh4.comm.exchanged_bytes([s.partition for s in st], st[0].models)
    out["2x2_halo_capacity"] = mesh4.comm.halo_capacity
    del st
    cfg5 = ct.SimConfig(domain_bits=10, max_active_blocks=65536, default_dt=1e-4,
                        rebucket_auto=True, particle_tile=512)
    reach = max(cfg5.arena_lo + cfg5.arena_span - 1, -cfg5.arena_lo, 1)
    comm5 = HaloComm(cfg5, (("x", 0), ("z", 2)), (4, 2), reach, 262144, 8192,
                     group=LocalGroup((4, 2), ["cpu"] * 8))
    out["config5_4x2_bytes"] = comm5.exchanged_bytes()
    if args.config5shard:
        cfgs, mats, poss, v0s = config5_shard(C5_QUICK_RADIUS if args.quick else C5_RADIUS)
        eng = ct.MPMEngine(cfgs, [mats], tile_chunk=chunk, device=dev)
        out["config5_shard_particles"] = int(poss.shape[0])
        out["config5_shard_ms_per_step"], st = ms_per_step(eng, eng.init_state([poss], [v0s]))
        out["config5_shard_dropped"] = eng.diagnostics(st)["model0_dropped_tiles"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
