"""Command-line scene runner of the PyTorch/CUDA port.

Loads a JSON scene, runs the frame loop and streams per-frame ``.bgeo``
particle dumps through the asynchronous writers (``io/bgeo.py``: the native
C++ writer and its worker thread, numpy where no compiler is found; port of
``claymore_tpu/__main__.py``):

    python -m claymore_tpu_torch -f scene.json [-o outdir] [--frames N]
        [--tile-chunk N] [--no-output] [--checkpoint-every N]
        [--resume ckpt.npz] [--profile] [--device DEVICE[,DEVICE...]]

``--checkpoint-every N`` writes ``ckpt_{frame:04d}.npz`` (``io/checkpoint.py``,
the JAX package's format) into the output directory after every N-th frame
(and, as the JAX runner does, one of the initial state as
``ckpt_-001.npz``); ``--resume`` loads one into the scene's engine and runs
``--frames`` more frames from it.  ``--device`` defaults to ``cuda``; a
scene with a multi-device ``device`` block puts every shard on it, or one
shard on each device of a comma-separated list (``cuda:0,cuda:1,...``).
Without a CUDA device the runner exits with an error rather than running
on the CPU.  ``--profile`` prints the wall time per frame, per frame dump
(the copy to the host and the queueing) and of the final wait for the
writes; a line after the frames says which writer took them.
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
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a resumable checkpoint every N frames")
    ap.add_argument("--resume", default=None,
                    help="checkpoint file to resume from")
    ap.add_argument("--profile", action="store_true",
                    help="print per-stage timings at the end")
    ap.add_argument("--device", default="cuda",
                    help="device to simulate on, or a comma-separated list with "
                         "one per shard of a multi-device scene (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    devices = [d.strip() for d in args.device.split(",")]
    try:
        devices = [torch.device(d) for d in devices]
    except RuntimeError as err:
        ap.error(f"--device {args.device}: {err}")
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        print("claymore_tpu_torch: --device cuda but no CUDA device is "
              "available (use --device cpu to run the plain PyTorch versions)",
              file=sys.stderr)
        return 2

    from .io import checkpoint as ckpt
    from .io.scene import load_scene
    from .utils.timers import StageTimer

    print(f"loading scene [{args.file}] on {args.device}")
    t_load = time.perf_counter()
    scene = load_scene(args.file, device=devices if len(devices) > 1 else devices[0],
                       tile_chunk=args.tile_chunk)
    engine, state = scene.engine, scene.state
    frames = args.frames if args.frames is not None else scene.frames
    print(f"loaded {sum(p.shape[0] for p in scene.positions)} particles in "
          f"{time.perf_counter() - t_load:.2f}s")
    os.makedirs(args.out, exist_ok=True)
    if args.resume:
        state = ckpt.load_state(args.resume, state)
        first = state[0] if isinstance(state, tuple) else state
        print(f"resumed from {args.resume} at t={float(first.t):.6f} "
              f"step={int(first.step)}")
    timer = StageTimer(enabled=True, device=engine.device)

    writers = {"native": 0, "numpy": 0}

    def dump(frame_idx, st):
        if not args.no_output:
            for mi in range(len(scene.materials)):
                path = os.path.join(args.out, f"model{mi}_frame{frame_idx:04d}.bgeo")
                timer.tick()
                writers[ckpt.save_frame_bgeo(path, engine, st, mi)] += 1
                timer.tock("write (copy to host, queue)")
        if args.checkpoint_every and (frame_idx + 1) % args.checkpoint_every == 0:
            ckpt.save_state(os.path.join(args.out, f"ckpt_{frame_idx:04d}.npz"), st)

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
    timer.tick()
    ckpt.flush_io()
    timer.tock("flush (wait for the writes)")
    print(f"done: {frames} frames in {wall:.2f}s")
    if not args.no_output:
        print(f"frames written: native {writers['native']}, numpy {writers['numpy']}")
    if args.profile:
        print(timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
