"""Command-line scene runner of the PyTorch/CUDA port.

Loads a JSON scene, runs the frame loop on one device and streams per-frame
``.bgeo`` particle dumps through the async IO thread (port of
``claymore_tpu/__main__.py``):

    python -m claymore_tpu_torch -f scene.json [-o outdir] [--frames N]
        [--tile-chunk N] [--no-output] [--profile] [--device cuda|cpu]

``--device`` defaults to ``cuda``; without a CUDA device the runner exits
with an error rather than running on the CPU.  Checkpoints
(``--checkpoint-every``/``--resume``) are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("claymore_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-f", "--file", default="scenes/scene.json",
                    help="scene configuration file")
    ap.add_argument("-o", "--out", default="output", help="output directory")
    ap.add_argument("--frames", type=int, default=None,
                    help="override frame count")
    ap.add_argument("--tile-chunk", type=int, default=64)
    ap.add_argument("--no-output", action="store_true",
                    help="simulate without writing .bgeo frames")
    ap.add_argument("--profile", action="store_true",
                    help="print per-stage timings at the end")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to simulate on (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("claymore_tpu_torch: --device cuda but no CUDA device is "
              "available (use --device cpu to run the plain PyTorch versions)",
              file=sys.stderr)
        return 2

    from .io import checkpoint as ckpt
    from .io.scene import load_scene
    from .utils.timers import StageTimer

    print(f"loading scene [{args.file}] on {args.device}")
    scene = load_scene(args.file, device=args.device, tile_chunk=args.tile_chunk)
    engine, state = scene.engine, scene.state
    frames = args.frames if args.frames is not None else scene.frames
    os.makedirs(args.out, exist_ok=True)
    timer = StageTimer(enabled=True, device=engine.device)

    def dump(frame_idx, st):
        if args.no_output:
            return
        for mi in range(len(scene.materials)):
            path = os.path.join(args.out, f"model{mi}_frame{frame_idx:04d}.bgeo")
            ckpt.save_frame_bgeo(path, engine, st, mi)

    dump(-1, state)  # the initial cloud, as the reference writes it too
    t_start = time.perf_counter()
    for f in range(frames):
        timer.tick()
        state = engine.run(state, 1)
        timer.tock("frame")
        d = engine.diagnostics(state)
        print(f"frame {f + 1}/{frames}: t={d['t']:.5f} steps={d['step']} "
              f"dt={d['dt']:.3e} mass={d['grid_mass']:.6f}")
        dump(f, state)
    wall = time.perf_counter() - t_start
    ckpt.flush_io()
    print(f"done: {frames} frames in {wall:.2f}s")
    if args.profile:
        print(timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
