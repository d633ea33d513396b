"""The benchmark entry point: ``bench.py``'s scenes, timed loop, one JSON
line and kernel-against-oracle gate, for the port on one card.

    python -m claymore_tpu_torch.scripts.bench [--scene=sphere25m] [--quick]
        [--nogate] [--device cuda|cpu] [--validate-out=PATH]

Scenes (``build``): ``bench.py``'s ten, with its domains, materials, boxes,
initial velocities, block capacities, colliders (the tilted half-space ramp,
the procedural 128^3 SDF dome) and tile capacities (``exact_tiles``, slack
1.25, 2.5 for dambreak12m).  ``--quick`` shrinks every box but sphere25m's
and dambreak12m's, and the window to 5 substeps.

The run: ``MPMEngine(tile_chunk=64)``, one warm-up substep and one warm-up
window, then the best of 3 windows (20 substeps, 60 above 10M particles),
each on the host clock and ended by a synchronise and a host read.  The
output ends with ``launches {...}`` (the kernel launches from
``init_state`` to the end of the last window; 0 on the CPU, where the
wrappers run the plain versions) and one JSON line: ``bench.py``'s keys, in
its order, less its TPU knobs (``mxu_precision``, ``g2p_arena_dtype``),
plus ``power_limit_w``, ``roofline_share``, ``ms_per_step_reps``,
``rebuilds_per_rep`` (``MPMEngine.rebuilds`` during each window) and
``validate_ok``.  ``vs_baseline`` divides by ``bench.py``'s 250 Mpps, the
reference's own estimate for its Quadro P6000, not a number measured here.
The movement probe finds particles 0..4095 of every model by id (slot order
changes at every rebucket) and ``displacement`` is the least of the models'
largest moves.

Roofline: ``model_tflops`` and ``model_hbm_gbs`` are one substep's
operations and bytes at the final state, from ``utils/bounds.py`` (K1's
``g2p2g_bound`` for every model plus K2's ``grid_bound``, the counts of the
kernels' bounds), over the best window's time per substep;
``roofline_share`` is those bytes over 3.35 TB/s, divided by that time.
``bench.py``'s per-particle constants (``bench.py:397-398``) price its TPU
program's one-hot matmuls and are not used.  The three are null on the CPU.

The gate (``validate``, ``bench.py``'s ``_write_validate_artifact``) runs
before the benchmark on a card unless ``--quick`` or ``--nogate``: each of
its pairs runs 4 substeps of one scene from the same positions through
``MPMEngine`` on the card (the CUDA kernels) and on the CPU (their plain
versions, the oracle) and compares them by pid and through
``pool_to_dense``.  It writes ``build/validate_torch.json`` (never the root
``VALIDATE.json``); an exception in it goes there and into ``validate_ok:
false``, and the benchmark still runs and exits 0, as in ``bench.py``.
Exits 2 when ``--device cuda`` finds no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

CLAYMORE_BASELINE_MPPS = 250.0
SCENES = ("cube", "sphere25m", "sphere", "dambreak12m", "dambreak", "dambreak_hs",
          "dambreak_sdf", "sand", "nacc", "multimat")
REPS = 3
PROBE = 4096

# the gate: bench.py:205-211's pair, and its bounds on the exact pairs
# (bench.py:270, 289-297); the mass bounds are those of its default and
# flagship pairs
GATE_SUBSTEPS = 4
GATE_V0 = (0.2, -0.4, 0.1)
GATE_BOUNDS = {"grid_err": 1e-4, "cloud_err": 1e-5, "grid_mass_rel": 1e-6,
               "mass_vs_analytic": 1e-6}


# --------------------------------------------------------------------------
# scenes (bench.py:25-177)
# --------------------------------------------------------------------------

def sdf_dome():
    """bench.py's dambreak_sdf collider (bench.py:133-140): a solid dome
    (sphere cap) on the floor, 128^3 nodes at 1/128, slip, friction 0.1."""
    from ..models.boundary import SignedDistanceCollider

    res, sdx = 128, 1.0 / 128
    ax = (np.arange(res, dtype=np.float32) + 0.5) * sdx
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = np.sqrt((X - 0.55) ** 2 + (Y - 0.02) ** 2 + (Z - 0.35) ** 2) - 0.12
    return SignedDistanceCollider(sdf, sdx, kind="slip", friction=0.1)


def build(scene: str, quick: bool):
    """(cfg, materials, positions, velocities, colliders) of ``bench.py``'s
    scene ``scene`` (``bench.py:35-177``; its ``--quick`` form with
    ``quick``)."""
    from .. import FixedCorotated, JFluid, NACC, Sand, SimConfig, exact_tiles
    from ..io.sampler import sample_sphere, sample_uniform_box_world
    from ..models.boundary import HalfSpace

    box = sample_uniform_box_world
    cfg = SimConfig(domain_bits=8, max_active_blocks=8192, default_dt=1e-4,
                    rebucket_auto=True, particle_tile=512)
    vol = cfg.default_volume()
    span = 0.12 if quick else 0.2
    lo, hi = 0.4 - span / 2, 0.4 + span / 2
    colliders, slack = (), 1.25

    if scene == "cube":
        mats = [FixedCorotated(volume=vol, e=5e3, nu=0.4)]
        parts = [box(cfg.dx, [lo, 0.5, lo], [hi, 0.5 + span, hi], cfg.ppc)]
        v0s = [(0.0, -0.5, 0.0)]
    elif scene == "sphere25m":
        # BASELINE.md's flagship: the ~25M-particle elastic sphere, whatever
        # --quick says
        cfg = dataclasses.replace(cfg, max_active_blocks=65536)
        mats = [FixedCorotated(volume=vol, e=5e3, nu=0.4)]
        parts = [sample_sphere(cfg.dx, (0.5, 0.55, 0.5), 0.3547, cfg.ppc)]
        v0s = [(0.0, -0.5, 0.0)]
    elif scene == "sphere":
        mats = [FixedCorotated(volume=vol, e=5e3, nu=0.4)]
        parts = [sample_sphere(cfg.dx, (0.4, 0.6, 0.4), span / 2 * 1.24, cfg.ppc)]
        v0s = [(0.0, -0.5, 0.0)]
    elif scene == "dambreak12m":
        # the 12M-particle launched water column, whatever --quick says;
        # slack 2.5 because the column spreads (bench.py:95-100)
        cfg = dataclasses.replace(cfg, max_active_blocks=65536)
        mats = [JFluid(volume=vol)]
        parts = [box(cfg.dx, [0.1, 0.1, 0.1], [0.4, 0.7, 0.6], cfg.ppc)]
        v0s = [(2.0, -2.0, 0.0)]
        slack = 2.5
    elif scene in ("dambreak", "dambreak_hs", "dambreak_sdf"):
        cfg = dataclasses.replace(cfg, max_active_blocks=24576)
        mats = [JFluid(volume=vol)]
        parts = [box(cfg.dx, [0.1, 0.1, 0.1],
                     [0.1 + span, 0.1 + 2 * span, 0.1 + 2 * span], cfg.ppc)]
        v0s = [(0.0, 0.0, 0.0)]
        if scene == "dambreak_hs":
            colliders = (HalfSpace((0.0, 0.12, 0.0), (0.25, 1.0, 0.0), kind="slip",
                                   friction=0.2),)
        elif scene == "dambreak_sdf":
            v0s = [(1.0, 0.0, 0.0)]
            colliders = (sdf_dome(),)
    elif scene in ("sand", "nacc"):
        mats = [Sand(volume=vol, e=1e4, rho=1500.0) if scene == "sand"
                else NACC(volume=vol, e=1e4)]
        parts = [box(cfg.dx, [0.4, 0.1, 0.4], [0.4 + span, 0.1 + 2 * span, 0.4 + span],
                     cfg.ppc)]
        v0s = [(0.0, 0.0, 0.0)]
    elif scene == "multimat":
        cfg = dataclasses.replace(cfg, max_active_blocks=16384)
        h = span
        mats = [FixedCorotated(volume=vol, e=5e3, nu=0.4), JFluid(volume=vol),
                Sand(volume=vol, e=1e4, rho=1500.0)]
        parts = [box(cfg.dx, [0.2, 0.5, 0.2], [0.2 + h, 0.5 + h, 0.2 + h], cfg.ppc),
                 box(cfg.dx, [0.5, 0.1, 0.5], [0.5 + h, 0.1 + h, 0.5 + h], cfg.ppc),
                 box(cfg.dx, [0.6, 0.5, 0.2], [0.6 + h, 0.5 + h, 0.2 + h], cfg.ppc)]
        v0s = [(0.0, -0.5, 0.0)] * 3
    else:
        raise ValueError(f"unknown scene {scene!r}")
    cfg = dataclasses.replace(cfg, max_tiles=exact_tiles(cfg, parts, slack=slack))
    return cfg, mats, parts, v0s, colliders


def window(n: int, quick: bool) -> int:
    """Substeps in a timed window: long enough on the big scenes to hold
    their drift-triggered rebuilds (bench.py:374-376)."""
    return 5 if quick else (60 if n > 10_000_000 else 20)


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------

def probe(state, n: int = PROBE, model_idx: int = 0) -> np.ndarray:
    """Positions [3, n] of particles 0..n-1 of a model, found by id; NaN
    where a particle is not active."""
    m = state.models[model_idx]
    sel = m.active & (m.pid < n)
    out = torch.full((3, n), float("nan"), dtype=torch.float32, device=m.pos.device)
    out[:, m.pid[sel].long()] = m.pos[:, sel]
    return out.cpu().numpy()


def max_move(p1: np.ndarray, p0: np.ndarray) -> float:
    """The largest coordinate change between two probes, over the particles
    found in both."""
    d = np.abs(p1 - p0)
    d = d[np.isfinite(d)]
    return float(d.max()) if d.size else 0.0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts():
    """The launch counters of the path's kernel wrappers (K2, K1)."""
    from ..ops import g2p2g_kernel, grid_kernel

    return grid_kernel.grid_update.launches, g2p2g_kernel.g2p2g.launches


def power_limit_w(device: torch.device):
    """The card's power limit in watts, as nvidia-smi reports it (None
    where nvidia-smi cannot be run or prints no number)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=60)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def substep_bound(cfg, mats, colliders, state) -> dict:
    """One substep's bytes and operations on ``state`` (``utils/bounds.py``:
    K1 of every model and K2), and their bound on the card."""
    from ..utils.bounds import bound, g2p2g_bound, grid_bound

    parts = [g2p2g_bound(cfg, mat, state, i) for i, mat in enumerate(mats)]
    parts.append(grid_bound(cfg, state.grid, state.partition, colliders, float(state.t)))
    return bound(sum(p["bytes"] for p in parts), sum(p["ops"] for p in parts))


def measure(scene: str, cfg, mats, parts, v0s, colliders, device: torch.device,
            steps: int):
    """The timed run of ``main``: returns (final state, the JSON record
    less ``validate_ok``, the launches from ``init_state`` on)."""
    from .. import MPMEngine
    from ..utils.bounds import PEAK_BYTES_S

    eng = MPMEngine(cfg, mats, colliders, tile_chunk=64, device=device)
    counts = launch_counts()
    for c in counts:
        for k in c:
            c[k] = 0
    state = eng.init_state(parts, v0s)
    probes = [min(PROBE, p.shape[0]) for p in parts]
    p0 = [probe(state, k, i) for i, k in enumerate(probes)]
    fe = np.float32(1e9)
    state = eng.substep(state, fe)
    sync(device)
    float(state.t)
    state = eng.run_steps(state, steps, fe)
    sync(device)
    float(state.t)
    reps_s, rebuilds = [], []
    for _ in range(REPS):
        before = eng.rebuilds
        t0 = time.perf_counter()
        state = eng.run_steps(state, steps, fe)
        sync(device)
        float(state.grid[0, 0, 0])
        reps_s.append(time.perf_counter() - t0)
        rebuilds.append(eng.rebuilds - before)
    launches = {k: v for c in counts for k, v in c.items()}

    n = sum(p.shape[0] for p in parts)
    best = min(reps_s)
    mpps = n * steps / best / 1e6
    s_step = best / steps
    on_card = device.type == "cuda"
    work = substep_bound(cfg, mats, colliders, state) if on_card else None
    expected = sum(p.shape[0] * m.mass for p, m in zip(parts, mats))
    mass = float(state.grid[:-1, 0:4].double().sum())
    disp = min(max_move(probe(state, k, i), p0[i]) for i, k in enumerate(probes))
    backend = "cuda" if on_card else "cpu"
    record = {
        "metric": ("M particle-steps/sec/chip (elastic cube, fixed corotated)"
                   if scene == "cube" else f"M particle-steps/sec/chip ({scene})"),
        "value": mpps,
        "unit": "Mpps",
        "vs_baseline": mpps / CLAYMORE_BASELINE_MPPS,
        "particles": n,
        "ms_per_step": s_step * 1e3,
        "steps": steps,
        "backend": backend,
        # on a card MPMEngine has refused a collider list the CUDA grid
        # kernel does not take (grid_kernel.check_collider_count)
        "grid_backend": backend,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "power_limit_w": power_limit_w(device) if on_card else None,
        "active_particles": sum(int(m.active.sum()) for m in state.models),
        "dropped_tiles": sum(int(m.tiles.dropped[0]) for m in state.models),
        "block_overflow": int(state.partition.overflow[0]),
        "model_tflops": work["ops"] / s_step / 1e12 if on_card else None,
        "model_hbm_gbs": work["bytes"] / s_step / 1e9 if on_card else None,
        "roofline_share": work["bytes"] / PEAK_BYTES_S / s_step if on_card else None,
        "mass_rel_err": abs(mass - expected) / expected,
        "displacement": disp,
        "moves": disp > 0.0,
        "ms_per_step_reps": [s / steps * 1e3 for s in reps_s],
        "rebuilds_per_rep": rebuilds,
    }
    return state, record, launches


# --------------------------------------------------------------------------
# the gate (bench.py:180-301)
# --------------------------------------------------------------------------

def gate_side(cfg, mat, device):
    """One side of a gate pair: ``bench.py``'s box of ``mat`` launched at
    ``GATE_V0`` through ``MPMEngine`` on ``device`` for ``GATE_SUBSTEPS``
    substeps.  Returns (positions [N, 3], final state); particle i is
    input row i."""
    from .. import MPMEngine
    from ..io.sampler import sample_uniform_box_world

    pos = sample_uniform_box_world(cfg.dx, [0.4] * 3, [0.6] * 3, cfg.ppc)
    eng = MPMEngine(cfg, [mat], tile_chunk=8, device=device)
    state = eng.run_steps(eng.init_state([pos], [GATE_V0]), GATE_SUBSTEPS, 1.0)
    return pos, state


def moves(r: dict) -> bool:
    """The kernel's particles moved at least half as far as the oracle's,
    which moved: a frozen transfer keeps every conservation number perfect
    (bench.py:221-229)."""
    return bool(r["displacement"] > 0.5 * r["displacement_oracle"] > 0.0)


def pair_ok(r: dict) -> bool:
    """A pair's verdict: every error under its bound in ``GATE_BOUNDS``,
    and ``moves``."""
    return moves(r) and all(r[k] < b for k, b in GATE_BOUNDS.items())


def gate_pair(cfg, mat, device) -> dict:
    """The same run on ``device`` (the kernels) and on the CPU (the
    oracle), compared: dense grids (``pool_to_dense``), positions by pid,
    each grid's mass against the other's and the kernel's against the
    analytic total, and the movement of both."""
    from ..utils.debug import pool_to_dense

    pos, sk = gate_side(cfg, mat, device)
    _, so = gate_side(cfg, mat, torch.device("cpu"))
    n = pos.shape[0]
    pk, po = probe(sk, n), probe(so, n)
    mk, momk = pool_to_dense(cfg, sk)
    mo, momo = pool_to_dense(cfg, so)
    mass_k = float(sk.grid[:-1, 0:4].double().sum())
    mass_o = float(so.grid[:-1, 0:4].double().sum())
    expected = n * mat.mass
    r = {
        "grid_err": float(max(np.abs(mk - mo).max(), np.abs(momk - momo).max())),
        "grid_mass_rel": abs(mass_k - mass_o) / max(mass_o, 1e-30),
        "mass_vs_analytic": abs(mass_k - expected) / expected,
        # a particle missing on either side is an error of inf
        "cloud_err": float(np.nan_to_num(np.abs(pk - po), nan=np.inf).max()),
        "displacement": max_move(pk, pos.T),
        "displacement_oracle": max_move(po, pos.T),
        "particles": n,
    }
    r["moves"] = moves(r)
    r["ok"] = pair_ok(r)
    return r


def validate(device, path) -> dict:
    """``bench.py``'s gate for the port: the CUDA kernels against their
    plain versions on its pairs (FixedCorotated, Sand and NACC at
    domain_bits 6; FixedCorotated at the flagship geometry, domain_bits 7
    and tiles of 512).  Writes the artifact to ``path`` and returns it."""
    from .. import NACC, FixedCorotated, Sand, SimConfig
    from ..utils.timers import device_label

    t0 = time.perf_counter()
    device = torch.device(device)
    base = SimConfig(domain_bits=6, max_active_blocks=512, default_dt=2e-4)
    flag = SimConfig(domain_bits=7, max_active_blocks=2048, default_dt=2e-4,
                     particle_tile=512)
    vol = base.default_volume()
    art = {
        "check": f"CUDA kernels (MPMEngine on {device_label(device)}) against their "
                 f"plain PyTorch versions (MPMEngine on the CPU), {GATE_SUBSTEPS} "
                 "substeps; db=6 and the flagship geometry (db=7, tile 512); particles "
                 "matched by pid, grids through pool_to_dense",
        "bounds": GATE_BOUNDS,
        "exact": gate_pair(base, FixedCorotated(volume=vol, e=1e4, nu=0.3), device),
        "default": "no counterpart: the port computes in float32 throughout and has "
                   "no reduced-precision defaults to hold against the oracle",
        "sand": gate_pair(base, Sand(volume=vol, e=1e4, rho=1500.0), device),
        "nacc": gate_pair(base, NACC(volume=vol, e=1e4), device),
        "flagship_geom": gate_pair(
            flag, FixedCorotated(volume=flag.default_volume(), e=1e4, nu=0.3), device),
    }
    art["ok"] = all(art[k]["ok"] for k in ("exact", "sand", "nacc", "flagship_geom"))
    art["seconds"] = time.perf_counter() - t0
    write_artifact(path, art)
    return art


def write_artifact(path, art: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(art, indent=1))


def default_validate_out() -> Path:
    """``build/validate_torch.json`` beside the port's kernel builds."""
    from ..ops import _build

    return _build.BUILD_DIR.parent / "validate_torch.json"


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="sphere25m", choices=SCENES)
    ap.add_argument("--quick", action="store_true",
                    help="smaller boxes (not sphere25m, dambreak12m), 5-substep window")
    ap.add_argument("--nogate", action="store_true", help="skip the kernel-vs-oracle gate")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--validate-out", default=None,
                    help="the gate's artifact (default build/validate_torch.json)")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: --device cuda but no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    cfg, mats, parts, v0s, colliders = build(args.scene, args.quick)

    validate_ok = None
    if device.type != "cuda":
        print("gate: skipped, no kernel to gate on the CPU (the plain versions run)")
    elif args.quick or args.nogate:
        print(f"gate: skipped ({'--quick' if args.quick else '--nogate'})")
    else:
        out = Path(args.validate_out) if args.validate_out else default_validate_out()
        t0 = time.perf_counter()
        try:
            validate_ok = validate(device, out)["ok"]
        except Exception as e:     # recorded; never blocks the number (bench.py:340-346)
            traceback.print_exc()
            write_artifact(out, {"ok": False, "error": repr(e)[:500]})
            validate_ok = False
        print(f"gate: ok {validate_ok} in {time.perf_counter() - t0:.1f} s -> {out}")

    n = sum(p.shape[0] for p in parts)
    _, record, launches = measure(args.scene, cfg, mats, parts, v0s, colliders,
                                     device, window(n, args.quick))
    record["validate_ok"] = validate_ok
    print(f"launches {json.dumps(launches)}")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
