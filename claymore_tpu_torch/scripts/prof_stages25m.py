"""Stage split of a substep at the 25M-particle flagship, and the transfer's
particle-stream floor.

    python -m claymore_tpu_torch.scripts.prof_stages25m [--device cuda|cpu]
        [--domain-bits 8] [--radius 0.3547] [--max-blocks 65536]
        [--iters 8] [--reps 2]

The port of ``scripts/prof_stages25m.py``: ``bench.py``'s sphere25m
(25,088,753 FixedCorotated particles at the defaults) with tile capacities
``exact_tiles(slack=1.25)``, one substep, then ``MPMEngine.profile_stages``
(ms per call of grid_update / g2p2g / rebuild / substep / overhead).  Last,
the transfer K1 timed with every tile's ``tvalid`` cleared.  On the TPU
that split the transfer into its window streams and its compute; the CUDA
kernel does no arena work at all for a dead tile (it copies the particle
state through), so this number is the *particle-stream floor*: the time to
read and write every slot's particle state once.  The probes P5 and P6
(``prof_dma``) give the arena side.  Prints three lines starting with
``PROF25M``; exits 2 when ``--device cuda`` finds no card.  Smaller
``--domain-bits``, ``--radius`` and ``--max-blocks`` make a run the CPU can
take.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("prof_stages25m", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--domain-bits", type=int, default=8)
    ap.add_argument("--radius", type=float, default=0.3547)
    ap.add_argument("--max-blocks", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("prof_stages25m: --device cuda but no CUDA device is available",
              file=sys.stderr)
        return 2
    from .. import FixedCorotated, MPMEngine, SimConfig, exact_tiles
    from ..core.engine import time_state_loop
    from ..io.sampler import sample_sphere
    from ..ops import g2p2g_kernel
    from ..utils.timers import device_label

    dev = torch.device(args.device)
    label = device_label(dev)
    cfg = SimConfig(domain_bits=args.domain_bits, max_active_blocks=args.max_blocks,
                    default_dt=1e-4, rebucket_auto=True, particle_tile=512)
    pos = sample_sphere(cfg.dx, (0.5, 0.55, 0.5), args.radius, cfg.ppc)
    cfg = dataclasses.replace(cfg, max_tiles=exact_tiles(cfg, [pos], slack=1.25))
    mat = FixedCorotated(volume=cfg.default_volume(), e=5e3, nu=0.4)
    eng = MPMEngine(cfg, [mat], tile_chunk=64, device=dev)
    state = eng.init_state([pos], [(0.0, -0.5, 0.0)])
    state = eng.substep(state, np.float32(1e9))
    print(f"PROF25M particles: {pos.shape[0]} tiles: {cfg.max_tiles} octs: "
          f"{int(state.partition.count[0])} | {label}", flush=True)

    out = eng.profile_stages(state, iters=args.iters, reps=args.reps)
    print("PROF25M stages", json.dumps({k: round(v, 4) for k, v in out.items()}),
          f"| {label}", flush=True)

    def dead(s):
        """K1 on ``s`` with every tile dead, its tiles put back after."""
        m0 = s.models[0]
        md = dataclasses.replace(m0, tiles=dataclasses.replace(
            m0.tiles, tvalid=torch.zeros_like(m0.tiles.tvalid)))
        m, nxt, _ = g2p2g_kernel.g2p2g(cfg, mat, s.grid, s.partition.table, md, s.dt,
                                       s.dt, torch.zeros_like(s.grid), eng.tile_chunk)
        m.tiles = m0.tiles
        return dataclasses.replace(s, grid=nxt, models=(m,))

    floor = time_state_loop(dead, state, iters=6, reps=args.reps, device=dev)
    print(f"PROF25M particle_stream_floor_ms {floor:.4f} | {label}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
