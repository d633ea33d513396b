"""Dynamic lane-offset reads and writes in shared memory: the probes P1-P4.

    python -m claymore_tpu_torch.scripts.prof_laneops [--device cuda|cpu]
        [--tiles 65536]

The port of ``scripts/prof_laneops.py``.  First each probe on the TPU
script's own input, one f32[16, 128] tile ``arange(2048)`` (P3: a [16, 384]
one) with the shift 48, printed as that script prints it,
``  <probe>: OK   sum=<sum of the output>``.  Then, unless ``--tiles 0``,
each probe on ``--tiles`` random tiles with random shifts in its range
(seed 0), timed as the best of 3 runs of 10 launches (CUDA events),
with the bytes of the lanes it reads and writes over that time.  The last
line, ``launches {...}``, gives the kernel launches of the run per probe
(``probe_kernels.launches``; 0 on the CPU).  Exits 1 if a probe fails, 2
when ``--device cuda`` finds no card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# (label of the TPU script, probe, lanes per row of its input, shifts drawn from)
PROBES = (
    ("dynamic roll (traced shift)", "dyn_roll", 128, (0, 127)),
    ("dynamic lane ds read [16,128]->32", "dyn_lane_read", 128, (0, 96)),
    ("dynamic lane ds read [16,384]->32", "dyn_lane_read_wide", 384, (0, 240)),
    ("dynamic lane ds write/accum", "dyn_lane_write", 128, (0, 80)),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("prof_laneops", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiles", type=int, default=65536,
                    help="tiles of the timed runs (0: none)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("prof_laneops: --device cuda but no CUDA device is available",
              file=sys.stderr)
        return 2
    from ..ops import probe_kernels as pk
    from ..utils.timers import best_ms, device_label

    dev = torch.device(args.device)
    label = device_label(dev)
    print(f"prof_laneops on {label}")
    shift = torch.tensor([3 * 16], dtype=torch.int32, device=dev)
    failed = 0
    for text, name, lanes, _ in PROBES:
        x = torch.arange(16 * lanes, dtype=torch.float32, device=dev).reshape(1, 16, lanes)
        try:
            out = getattr(pk, name)(x, shift)
            print(f"  {text}: OK   sum={float(out.double().sum()):.1f}")
        except Exception as e:       # reported, as the TPU script does
            failed += 1
            msg = str(e).split("\n")[0][:160]
            print(f"  {text}: FAIL {type(e).__name__}: {msg}")

    if args.tiles > 0 and not failed:
        g = args.tiles
        rng = np.random.default_rng(0)
        gen = torch.Generator(device=dev).manual_seed(0)
        print(f"== {g} tiles, random shifts: best of 3 x 10 launches ==")
        for text, name, lanes, (lo, hi) in PROBES:
            x = torch.randn((g, 16, lanes), generator=gen, device=dev)
            s = torch.from_numpy(rng.integers(lo, hi + 1, size=g).astype(np.int32)).to(dev)
            fn = getattr(pk, name)
            ms = best_ms(lambda: fn(x, s), dev)
            nbytes = pk.laneop_bytes(name, g)
            print(f"  {name} G={g}: {ms:.4f} ms  {nbytes / ms / 1e6:.1f} GB/s "
                  f"(lanes read + written)  {ms * 1e6 / g:.3f} ns/tile | {label}")
            del x, s
    print(f"launches {json.dumps(pk.launches)}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
