"""K1 by material and slot order, the particle-stream floor, the drift
check, the drift-only substep and the lane-window probes P2/P3, on one card.

    python -m claymore_tpu_torch.scripts.prof_k1 [--substeps 64] [--reps 10]
    PYTHONPATH=<another checkout> python3 claymore_tpu_torch/scripts/prof_k1.py

CUDA-event milliseconds (median of ``--reps`` calls after a warm-up) of:

* K1-FC on ``bench.py``'s sphere25m (25,088,753 particles) after one
  substep and after ``--substeps``, with every tile's slots as they are,
  permuted by a seeded permutation, and sorted by G2P stencil base
  (``permute_tiles``); and with every tile dead, which leaves only the
  particle state streaming through (``stream_floor``);
* K1-JF on dambreak12m (12,103,168 JFluid) after 20 substeps, K1-SD and
  K1-NC on the 2,132,820-particle sand and nacc boxes after 40 substeps,
  their grid velocities stirred so that the return maps branch;
* the drift check on the sphere25m state (what the substep does after K1
  to decide on a rebuild, host read included) and, on the host clock, its
  drift-only substep (median of 20 synchronised substeps);
* P2 ``dyn_lane_read`` and P3 ``dyn_lane_read_wide`` at 65,536 random tiles,
  and ``torch.gather`` with a precomputed index doing the same (each timed
  10 calls back to back).

Prints one JSON line.  Only the package's entry points are used, so the
script runs against any checkout whose ``g2p2g`` returns ``(model, pool)``
or ``(model, pool, margin)``: run as a file with another checkout first on
``PYTHONPATH``, it times that checkout's kernels, and two checkouts compare
on one card within one call.  Needs a CUDA device (exit 2 without one).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

SEED = 0


def permute_tiles(cfg, state, order: str, seed: int = SEED, model_idx: int = 0):
    """``state`` with the slots of every tile of one model reordered, which
    keeps it valid (tiles, partition and grid are untouched): ``"permuted"``
    by a seeded random permutation per tile, ``"sorted"`` by each slot's
    G2P stencil base (inactive slots last; K1 bins its particles by the
    base after advection, mostly the same one)."""
    from claymore_tpu_torch.core import partition

    m = state.models[model_idx]
    t, n = m.tiles.tvalid.shape[0], cfg.particle_tile
    dev = m.pos.device
    if order == "permuted":
        gen = torch.Generator(device=dev).manual_seed(seed)
        key = torch.rand((t, n), generator=gen, device=dev)
    elif order == "sorted":
        org = (m.tiles.bcoord * cfg.block_size)[:, :, None]           # [3, T, 1]
        rel = partition.base_cell(cfg, m.pos).reshape(3, t, n) - org
        lo = rel.clamp(0, cfg.arena_cells - 3)
        w = cfg.arena_cells - 2
        key = (lo[0] * w + lo[1]) * w + lo[2]
        key = torch.where(m.active.reshape(t, n), key, torch.full_like(key, w ** 3))
    else:
        raise ValueError(order)
    idx = (torch.argsort(key, dim=1, stable=True)
           + torch.arange(t, device=dev)[:, None] * n).reshape(-1)

    def take(x):
        return x[..., idx].contiguous()

    model = dataclasses.replace(m, pos=take(m.pos), active=take(m.active), pid=take(m.pid),
                                fields={k: take(v) for k, v in m.fields.items()})
    models = list(state.models)
    models[model_idx] = model
    return dataclasses.replace(state, models=tuple(models))


def stir(state, scale: float = 0.5, seed: int = SEED):
    """``state`` with seeded noise added to the grid velocity (momentum
    noise times mass)."""
    gen = torch.Generator(device=state.grid.device).manual_seed(seed)
    grid = state.grid.clone()
    m = grid[:, 0:4].reshape(-1, 1, 4, 128)
    noise = torch.randn((grid.shape[0], 3, 4, 128), generator=gen,
                        device=grid.device) * scale
    grid[:, 4:16] += (noise * m).reshape(-1, 12, 128)
    return dataclasses.replace(state, grid=grid)


def scene(name: str):
    """(cfg, material, positions, v0) of a one-model scene of ``bench.py``
    (``scripts/bench.py:build``): sphere25m, dambreak12m, sand, nacc, cube
    and ``cube_quick`` (``bench.py``'s ``--quick`` cube)."""
    from claymore_tpu_torch.scripts.bench import build

    quick = name == "cube_quick"
    cfg, mats, parts, v0s, _ = build("cube" if quick else name, quick)
    return cfg, mats[0], parts[0], v0s[0]


def median_ms(fn, reps: int, batch: int = 1) -> float:
    """Median over ``reps`` samples of CUDA-event milliseconds per call,
    each sample ``batch`` calls back to back."""
    from claymore_tpu_torch.utils.timers import device_ms

    def run():
        for _ in range(batch):
            fn()

    fn()
    return float(np.median([device_ms(run, "cuda") for _ in range(reps)])) / batch


def k1_ms(cfg, mat, state, reps: int, dead: bool = False) -> float:
    """K1 from one grid update of ``state`` into a pool it keeps adding to
    (the accumulator's contents do not change the work)."""
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    pool_v, _ = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt)
    model = state.models[0]
    if dead:
        model = dataclasses.replace(model, tiles=dataclasses.replace(
            model.tiles, tvalid=torch.zeros_like(model.tiles.tvalid)))
    acc = torch.zeros_like(state.grid)
    return median_ms(lambda: g2p2g_kernel.g2p2g(cfg, mat, pool_v, state.partition.table,
                                                model, state.dt, state.dt, acc, 64), reps)


def drift_check_ms(cfg, mat, state, reps: int) -> float:
    """What the substep does after K1 to decide on a rebuild: the host read
    of the margin K1 returned, or ``arena_margin`` and its host read where
    K1 returns none."""
    from claymore_tpu_torch.core import partition
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    pool_v, _ = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt)
    out = g2p2g_kernel.g2p2g(cfg, mat, pool_v, state.partition.table, state.models[0],
                             state.dt, state.dt, torch.zeros_like(state.grid), 64)
    if len(out) == 3:
        margin = out[2]
        return median_ms(lambda: bool(margin <= 0.0), reps)
    model = out[0]
    return median_ms(lambda: bool(partition.arena_margin(cfg, model) <= 0.0), reps)


def engine(name: str, steps: int, stirred: bool = False):
    import claymore_tpu_torch as ct

    cfg, mat, pos, v0 = scene(name)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=64, device="cuda")
    state = eng.run_steps(eng.init_state([pos], [v0]), steps, np.float32(1e9))
    return eng, cfg, mat, stir(state) if stirred else state


def lane_probe_ms(reps: int, tiles: int = 65536) -> dict:
    from claymore_tpu_torch.ops import probe_kernels as pk

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for name, lanes, smax, base in (("dyn_lane_read", 128, 96, 0),
                                    ("dyn_lane_read_wide", 384, 240, 112)):
        x = torch.randn((tiles, 16, lanes), generator=gen, device="cuda")
        s = torch.from_numpy(rng.integers(0, smax + 1, size=tiles).astype(np.int32)).cuda()
        kernel = getattr(pk, name)
        index = (s.long()[:, None] + base + torch.arange(32, device="cuda"))[:, None, :]
        index = index.expand(-1, 16, -1)
        out[name] = {"ms": median_ms(lambda: kernel(x, s), reps * 2, batch=10),
                     "gather_ms": median_ms(lambda: torch.gather(x, 2, index), reps * 2,
                                            batch=10)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("prof_k1", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--substeps", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_k1: no CUDA device is available", file=sys.stderr)
        return 2
    import claymore_tpu_torch
    from claymore_tpu_torch.utils.timers import device_label

    res = {"package": os.path.dirname(os.path.abspath(claymore_tpu_torch.__file__)),
           "device": device_label("cuda")}
    t0 = time.perf_counter()
    eng, cfg, mat, state = engine("sphere25m", 1)
    fe = torch.tensor(1e9, device="cuda")
    for label, steps in (("after_1", 0), (f"after_{1 + args.substeps}", args.substeps)):
        state = eng.run_steps(state, steps, fe)
        res[f"fc_{label}"] = {order: k1_ms(cfg, mat, st, args.reps) for order, st in (
            ("as_is", state), ("permuted", permute_tiles(cfg, state, "permuted")),
            ("sorted", permute_tiles(cfg, state, "sorted")))}
    res["stream_floor_ms"] = k1_ms(cfg, mat, state, args.reps, dead=True)
    res["drift_check_ms"] = drift_check_ms(cfg, mat, state, args.reps)
    sub = []
    for _ in range(21):
        t1 = time.perf_counter()
        state = eng.substep(state, fe)
        torch.cuda.synchronize()
        sub.append((time.perf_counter() - t1) * 1e3)
    res["substep_ms"] = float(np.median(sub[1:]))
    res["substep_rebuilds"] = eng.rebuilds
    del eng, state
    torch.cuda.empty_cache()
    for key, name, steps, stirred in (("jf_dambreak12m", "dambreak12m", 20, False),
                                      ("sd_sand", "sand", 40, True),
                                      ("nc_nacc", "nacc", 40, True)):
        _, cfg, mat, state = engine(name, steps, stirred)
        res[key] = k1_ms(cfg, mat, state, args.reps)
        del state
        torch.cuda.empty_cache()
    res.update(lane_probe_ms(args.reps))
    res["wall_s"] = time.perf_counter() - t0
    print("PROFK1", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
