"""The shape check at the 100M-particle scene's resolution.

    python -m claymore_tpu_torch.scripts.validate_scale [n_devices]
        [--device cuda|cpu]

The port of ``scripts/validate_scale.py``: ``MultiChipEngine`` at
``domain_bits=10`` (a 1024^3-cell domain, 256^3 blocks per shard's table)
over ``n_devices`` x-slabs (4 by default), every shard on ``--device``,
with a thin rod of particles from x = 0.3 to 0.7 (across the middle slab
faces), three substeps.  It
checks that nothing overflows, drops or leaks: partition overflow 0, mass
within 1e-4 of the particles', halo overflow and migration losses 0, every
particle active.  Prints the blocks per shard and ``scale validation: OK``;
exits 1 on a failed check, 2 when ``--device cuda`` finds no card.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("validate_scale", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("validate_scale: --device cuda but no CUDA device is available",
              file=sys.stderr)
        return 2
    import claymore_tpu_torch as ct
    from ..io.sampler import sample_uniform_box_world
    from ..utils.timers import device_label

    cfg = ct.SimConfig(domain_bits=10, max_active_blocks=2048, default_dt=1e-4)
    mat = ct.FixedCorotated(volume=cfg.default_volume(), e=5e3, nu=0.4)
    pos = sample_uniform_box_world(cfg.dx, [0.3, 0.5, 0.49], [0.7, 0.505, 0.51], cfg.ppc)
    eng = ct.MultiChipEngine(cfg, [mat], n_devices=args.n_devices, tile_chunk=8,
                             migration_capacity=4096, halo_capacity=512, device=args.device)
    st = eng.init_state([pos], [(0.3, -0.4, 0.0)])
    n = pos.shape[0]
    st = eng.run_steps(st, 3, 1e9)
    d = eng.diagnostics(st)
    expected = n * mat.mass
    checks = {
        "partition overflow": d["block_overflow"] == 0,
        "mass": abs(d["grid_mass"] - expected) < 1e-4 * expected,
        "halo overflow": d["halo_overflow"] == 0,
        "migration": d["migration_dropped"] == 0,
        "active": d["model0_active"] == n,
    }
    print(f"domain_bits=10 x {args.n_devices} shards on {device_label(args.device)}: "
          f"{n} particles, blocks/shard {d['active_blocks']}, mass {d['grid_mass']:.6f} "
          f"(expected {expected:.6f}), t={d['t']:.5f}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        print(f"scale validation FAILED: {failed} ({d})", file=sys.stderr)
        return 1
    print("scale validation: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
