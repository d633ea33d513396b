"""The grid kernels K2, K2-AC and K2-SDF on one card, at the pools that
matter to the collider kernels.

    python -m claymore_tpu_torch.scripts.prof_k2 [--reps 20]
    PYTHONPATH=<another checkout> python3 claymore_tpu_torch/scripts/prof_k2.py

CUDA-event milliseconds (median of ``--reps`` calls after a warm-up) of:

* K2 (no colliders), K2-AC (the three colliders of
  tests/test_pallas_grid.py:92-99, ``pallas_colliders``) and K2-SDF
  (``sdf_colliders``: bench.py's 128^3 dome, a half-space and an animated
  96x80x64 spinner) at the 65,537-row check pool of ``chip_smoke.py``
  (every oct of the 256^3 domain active, random mass and momenta), the
  colliders posed at t = 0.37;
* K2-AC and K2-SDF at the straddle pools: every row an oct whose cells lie
  on both sides of one of the kernel's own colliders' surfaces
  (``straddle_octs``), repeated to fill the 65,536 rows: every row crosses
  one collider's surface, so that collider is never culled on it;
* K2-AC on ``dambreak_hs`` after 41 substeps and K2-SDF on
  ``dambreak_sdf`` after 1,750 (the fluid has reached the dome), with each
  scene's drift-only substep on the host clock (median of 20 synchronised
  substeps that did not rebuild), and each state's
  ``utils/bounds.py:grid_bound``.  ``dambreak_sdf`` runs at tile slack
  ``SDF_SLACK`` in place of bench.py's 1.25: the spreading fluid keeps
  every particle for 3,000 substeps, where bench.py runs 81.

Prints one line, ``PROFK2 {json}``.  Only the package's entry points are
used: run as a file with another checkout first on ``PYTHONPATH``, it
times that checkout's kernels, and two checkouts compare on one card
within one call.  Needs a CUDA device (exit 2 without one).
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

from claymore_tpu_torch.utils.timers import median_ms

SEED = 0
CHECK_T = 0.37
SDF_SLACK = 2.5           # dambreak_sdf's tile slack for its 1,750 substeps


def pallas_colliders():
    """The three colliders of tests/test_pallas_grid.py:92-99: a slip
    half-space with friction, a moving, rotating separate sphere with
    friction, and a sticky box."""
    from claymore_tpu_torch.models.boundary import Box, HalfSpace, RigidMotion, Sphere

    return (
        HalfSpace((0.0, 0.3, 0.0), (0.1, 1.0, 0.0), kind="slip", friction=0.3),
        Sphere((0.5, 0.5, 0.5), 0.2, kind="separate", friction=0.1,
               motion=RigidMotion(trans_vel=(0.05, 0.0, 0.0), omega=(0.0, 1.5, 0.0))),
        Box((0.6, 0.1, 0.6), (0.9, 0.4, 0.9), kind="sticky"),
    )


def sdf_spinner():
    """An animated SDF collider: a 96x80x64 ellipsoid grid at 1/96 that
    translates and rotates, separate with friction 0.3."""
    from claymore_tpu_torch.models.boundary import RigidMotion, SignedDistanceCollider

    dx = 1.0 / 96
    ax = [np.arange(n, dtype=np.float32) * dx for n in (96, 80, 64)]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    sdf = (np.sqrt(((X - 0.45) / 0.25) ** 2 + ((Y - 0.4) / 0.15) ** 2
                   + ((Z - 0.33) / 0.2) ** 2) - 1.0) * 0.15
    return SignedDistanceCollider(
        sdf, dx, kind="separate", friction=0.3, bound_cells=4,
        motion=RigidMotion(trans=(0.03, 0.05, 0.1), trans_vel=(0.1, 0.0, -0.05),
                           omega=(0.4, 1.2, -0.3)))


def sdf_colliders():
    """K2-SDF's check list: the dome, a half-space, the spinner (list order
    mixes analytic and SDF colliders)."""
    from claymore_tpu_torch.models.boundary import HalfSpace
    from claymore_tpu_torch.scripts.bench import sdf_dome

    return (sdf_dome(), HalfSpace((0.0, 0.3, 0.0), (0.1, 1.0, 0.0), kind="slip",
                                  friction=0.3), sdf_spinner())


def grid_inputs(cfg, n_active: int = 0, seed: int = SEED, octs=None):
    """A partition and pool on the card: ``n_active`` distinct random octs
    (or the given ``octs``, repeats allowed) with random mass (~30% of
    cells empty) and momenta, boundary octs among them, mass in the null
    row (the cases of tests/test_pallas_grid.py)."""
    from claymore_tpu_torch.core.types import Partition

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    no, nb = cfg.num_oct_keys, cfg.max_active_octs
    keys = np.full((nb,), no, np.int32)
    if octs is None:
        octs = rng.choice(no, size=n_active, replace=False)
    n_active = len(octs)
    keys[:n_active] = octs
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = torch.zeros((nb + 1, 16, 128), dtype=torch.float32, device=dev)
    mass = torch.rand((n_active, 4, 128), generator=gen, device=dev) * 2.0
    mass[mass < 0.6] = 0.0
    pool[:n_active, 0:4] = mass
    pool[:n_active, 4:16] = torch.randn((n_active, 12, 128), generator=gen,
                                        device=dev) * 1e-3
    pool[-1, 0:4] = 1.0
    pool[-1, 4:8] = 0.25
    i32 = dict(dtype=torch.int32, device=dev)
    part = Partition(table=torch.zeros((no + 1,), **i32),
                     keys=torch.from_numpy(keys).to(dev),
                     count=torch.full((1,), n_active, **i32),
                     overflow=torch.zeros((1,), **i32))
    return part, pool


def straddle_octs(cfg, colliders, t: float = CHECK_T):
    """(octs, crossed): the octs of the whole domain whose cells lie on both
    sides (sd <= 0 and sd > 0) of one of ``colliders``' surfaces, posed at
    ``t``, by the plain ``pose`` + ``sdf_and_normal_soa``, and for each the
    index in ``colliders`` of the first surface it crosses."""
    from claymore_tpu_torch.core import grid
    from claymore_tpu_torch.core.types import Partition

    octs = np.arange(cfg.num_oct_keys, dtype=np.int32)
    i32 = dict(dtype=torch.int32, device="cuda")
    part = Partition(table=torch.zeros((len(octs) + 1,), **i32),
                     keys=torch.from_numpy(octs).cuda(),
                     count=torch.full((1,), len(octs), **i32),
                     overflow=torch.zeros((1,), **i32))
    full = dataclasses.replace(cfg, max_active_blocks=cfg.num_oct_keys)
    x3 = tuple(c[:-1] for c in grid.cell_positions(full, part))
    tt = torch.tensor(t, dtype=torch.float32, device="cuda")
    crossed = torch.full((len(octs),), -1, dtype=torch.int64, device="cuda")
    for i, col in enumerate(colliders):
        _, x_mat, _ = col.pose(x3, tt)
        sd = col.sdf_and_normal_soa(x_mat)[0].reshape(len(octs), -1)
        cross = (sd <= 0.0).any(dim=1) & (sd > 0.0).any(dim=1)
        crossed = torch.where(cross & (crossed < 0), i, crossed)
        del sd, x_mat
    crossed = crossed.cpu().numpy()
    return octs[crossed >= 0], crossed[crossed >= 0]


def fill(octs: np.ndarray, rows: int) -> np.ndarray:
    """``octs`` repeated in order to ``rows`` entries."""
    return np.resize(octs, rows).astype(np.int32)


def k2_ms(cfg, pool, part, colliders, t, reps: int) -> float:
    from claymore_tpu_torch.ops import grid_kernel

    dt = torch.tensor(3e-4, dtype=torch.float32, device="cuda")
    tt = t if torch.is_tensor(t) else torch.tensor(t, dtype=torch.float32, device="cuda")
    if not colliders:
        return median_ms(lambda: grid_kernel.grid_update(cfg, pool, part, dt), reps)
    table = grid_kernel.pack_colliders(colliders, "cuda")
    ptrs = grid_kernel.sdf_table_pointers(colliders, "cuda")
    return median_ms(lambda: grid_kernel.grid_update(cfg, pool, part, dt, colliders, tt,
                                                     table, ptrs), reps)


def scene_run(name: str, steps: int, reps: int) -> dict:
    """K2 of the scene's kind on bench.py's scene ``name`` after ``steps``
    substeps, the state's bound, and the median drift-only substep of 20
    more."""
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.scripts.bench import build
    from claymore_tpu_torch.utils.bounds import grid_bound

    cfg, mats, parts, v0s, cols = build(name, quick=False)
    if name == "dambreak_sdf":
        cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, parts, slack=SDF_SLACK))
    eng = ct.MPMEngine(cfg, mats, cols, tile_chunk=64, device="cuda")
    fe = torch.tensor(1e9, device="cuda")
    state = eng.run_steps(eng.init_state(parts, v0s), steps, fe)
    torch.cuda.synchronize()
    out = {"k2_ms": k2_ms(cfg, state.grid, state.partition, cols, state.t, reps),
           "massive_cells": int((state.grid[:, 0:4] > 0.0).sum()),
           "bound_ms": grid_bound(cfg, state.grid, state.partition, cols,
                                  float(state.t))["bound_ms"]}
    sub = []
    for _ in range(40):
        before = eng.rebuilds
        t0 = time.perf_counter()
        state = eng.substep(state, fe)
        torch.cuda.synchronize()
        if eng.rebuilds == before:
            sub.append((time.perf_counter() - t0) * 1e3)
        if len(sub) == 20:
            break
    out["substep_drift_only_ms"] = float(np.median(sub))
    out["substeps_timed"] = len(sub)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("prof_k2", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_k2: no CUDA device is available", file=sys.stderr)
        return 2
    import claymore_tpu_torch
    from claymore_tpu_torch.models.boundary import SignedDistanceCollider
    from claymore_tpu_torch.scripts.bench import build
    from claymore_tpu_torch.utils.timers import device_label

    res = {"package": os.path.dirname(os.path.abspath(claymore_tpu_torch.__file__)),
           "device": device_label("cuda")}
    t0 = time.perf_counter()
    cfg = build("sphere25m", False)[0]
    part, pool = grid_inputs(cfg, cfg.num_oct_keys)
    res["k2_check"] = k2_ms(cfg, pool, part, (), CHECK_T, args.reps)
    for key, cols in (("ac", pallas_colliders()), ("sdf", sdf_colliders())):
        res[f"{key}_check"] = k2_ms(cfg, pool, part, cols, CHECK_T, args.reps)
        own = [c for c in cols if (key == "sdf") == isinstance(c, SignedDistanceCollider)]
        octs, _ = straddle_octs(cfg, own)
        spart, spool = grid_inputs(cfg, octs=fill(octs, cfg.max_active_octs), seed=SEED + 1)
        res[f"{key}_straddle"] = k2_ms(cfg, spool, spart, cols, CHECK_T, args.reps)
        res[f"{key}_straddle_octs"] = int(len(octs))
        del spart, spool
    del part, pool
    torch.cuda.empty_cache()
    for key, name, steps in (("ac", "dambreak_hs", 41), ("sdf", "dambreak_sdf", 1750)):
        res[f"{key}_{name}"] = scene_run(name, steps, args.reps)
        torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    print("PROFK2", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
