"""Smoke run of the PyTorch/CUDA port (claymore_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``claymore_tpu_torch/csrc``, holds each against
its plain PyTorch version on the card, and drives the port's main paths
through ``MPMEngine`` with their invariants checked:

* the ~25M-particle FixedCorotated sphere of ``bench.py --scene=sphere25m``
  and the ``run()`` entry point on the 1M-particle cube;
* the 12.1M-particle JFluid dam break of ``bench.py --scene=dambreak12m``,
  whose drift-triggered rebuilds fire every few substeps;
* the bench-size ``sand``, ``nacc``, ``multimat`` and ``dambreak_hs``
  scenes (Sand, NACC, three materials in one pool, a frictional half-space
  ramp resolved inside the grid kernel);
* the CLI, ``python -m claymore_tpu_torch -f scenes/dambreak.json``.

Every phase raises on failure.  The line before the last is a JSON object
with one entry per kernel; the last line is ``{"ok": true, "device":
{...}}``.  Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_facts() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the device, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# --------------------------------------------------------------------------
# kernel checks (also used by tests/test_torch_kernels_cuda.py)
# --------------------------------------------------------------------------

def random_grid_inputs(cfg, n_active: int, seed: int = SEED):
    """A random partition and pool on the device with boundary octs, empty
    cells and mass in the null row (the cases of tests/test_pallas_grid.py)."""
    from claymore_tpu_torch.core.types import Partition

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    no, nb = cfg.num_oct_keys, cfg.max_active_octs
    keys = np.full((nb,), no, np.int32)
    keys[:n_active] = rng.choice(no, size=n_active, replace=False)
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


def check_grid_kernel(cfg, n_active: int, time_it: bool = True) -> dict:
    """K2 against core.grid.grid_update on the card: mass rows bit-equal,
    velocities within rtol 1e-5 / atol 1e-7 (FMA contraction), max |v|^2
    within 1e-6 relative, and a NaN momentum giving inf in both."""
    from claymore_tpu_torch.core import grid
    from claymore_tpu_torch.ops import grid_kernel

    part, pool = random_grid_inputs(cfg, n_active)
    dt = torch.tensor(3e-4, dtype=torch.float32, device=DEVICE)
    kv, km = grid_kernel.grid_update(cfg, pool, part, dt)
    pv, pm = grid.grid_update(cfg, pool, part, dt)
    torch.cuda.synchronize()
    if not torch.equal(kv[:, 0:4], pv[:, 0:4]):
        raise AssertionError("grid kernel: mass rows differ")
    torch.testing.assert_close(kv[:, 4:16], pv[:, 4:16], rtol=1e-5, atol=1e-7)
    km, pm = float(km), float(pm)
    if not (pm > 0.0 and abs(km - pm) <= 1e-6 * pm):
        raise AssertionError(f"grid kernel: max|v|^2 {km} vs {pm}")
    err = float((kv - pv).abs().max())

    # a NaN x-momentum with mass in an oct whose x lies outside the slab
    from claymore_tpu_torch.core.octpool import oct_coord

    bx = oct_coord(cfg, part.keys.clamp(max=cfg.num_oct_keys - 1))[0]
    b, g = cfg.bound_blocks, cfg.grid_size
    row = int(torch.nonzero((bx >= b) & (bx < g - b))[0])
    nan_pool = pool.clone()
    nan_pool[row, 5, 7] = float("nan")           # mom-x row of cell cx=1
    nan_pool[row, 1, 7] = 1.0
    _, km_nan = grid_kernel.grid_update(cfg, nan_pool, part, dt)
    _, pm_nan = grid.grid_update(cfg, nan_pool, part, dt)
    if not (np.isinf(float(km_nan)) and np.isinf(float(pm_nan))):
        raise AssertionError(f"grid kernel: NaN gave {float(km_nan)}, {float(pm_nan)}")

    out = {"max_abs_err": err}
    if time_it:
        out["ms"] = cuda_ms(lambda: grid_kernel.grid_update(cfg, pool, part, dt))
        out["plain_ms"] = cuda_ms(lambda: grid.grid_update(cfg, pool, part, dt))
    return out


def stir(state, scale: float = 0.5, seed: int = SEED):
    """``state`` with seeded noise added to the grid velocity (momentum
    noise times mass), so a transfer from it shears and compresses the
    material and takes every branch of its return map."""
    gen = torch.Generator(device=state.grid.device).manual_seed(seed)
    grid = state.grid.clone()
    m = grid[:, 0:4].reshape(-1, 1, 4, 128)
    noise = torch.randn((grid.shape[0], 3, 4, 128), generator=gen,
                        device=grid.device) * scale
    grid[:, 4:16] += (noise * m).reshape(-1, 12, 128)
    return dataclasses.replace(state, grid=grid)


def check_g2p2g_kernel(cfg, mat, state, tile_chunk: int, time_it: bool = True,
                       reps: int = 20, model_idx: int = 0) -> dict:
    """K1 (the variant of ``mat``) against core.transfer.g2p2g_model on the
    card, from one grid update of ``state``: dense grids within 1e-5 x the
    largest grid value (float atomics reorder the sums), identical active
    sets, positions of the same particle within 2e-6, and every field (F,
    J, logJp) within 1e-5 x max(1, its largest value), but for the few
    NACC particles its discontinuous return map sends to another branch
    (see below)."""
    from claymore_tpu_torch.core import grid, transfer
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel
    from claymore_tpu_torch.utils.debug import pool_to_dense

    pool_v, mvs = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt)
    next_dt = grid.compute_dt(cfg, mvs, state.t + state.dt,
                              torch.tensor(1e9, device=DEVICE))
    table, model = state.partition.table, state.models[model_idx]

    def kernel(acc):
        return g2p2g_kernel.g2p2g(cfg, mat, pool_v, table, model, state.dt,
                                  next_dt, acc, tile_chunk)

    def plain(acc):
        return transfer.g2p2g_model(cfg, mat, pool_v, table, model, state.dt,
                                    next_dt, acc, tile_chunk)

    mk, pk = kernel(torch.zeros_like(state.grid))
    mt, pt = plain(torch.zeros_like(state.grid))
    torch.cuda.synchronize()
    if not torch.equal(mk.active, mt.active) or not torch.equal(mk.pid, mt.pid):
        raise AssertionError("g2p2g kernel: active sets differ")
    if int(mk.active.sum()) == 0:
        raise AssertionError("g2p2g kernel: no active particle")
    # both keep the slot layout, so equal pids sit in equal slots
    act = mk.active
    pos_err = float((mk.pos[:, act] - mt.pos[:, act]).abs().max())
    if set(mk.fields) != set(model.fields) or set(mt.fields) != set(model.fields):
        raise AssertionError(f"g2p2g kernel: fields {sorted(mk.fields)}")
    # fields: within 1e-5 x max(1, |field|) per particle.  NACC alone has a
    # discontinuous return map (the projection to the tip and the hardening
    # switch, where F and logJp jump by the size of the plastic correction),
    # so f32 roundoff of A may send particles on a branch boundary the other
    # way: at most 1e-3 of them, each within 5e-2 x max(1, |field|)
    nacc = mat.name == "nacc"
    field_err, flipped = {}, {}
    n_act = int(act.sum())
    for k in model.fields:
        a, b = mk.fields[k][..., act], mt.fields[k][..., act]
        per = (a - b).abs().reshape(-1, n_act).amax(dim=0)
        scale = max(1.0, float(b.abs().max()))
        field_err[k] = float(per.max())
        flipped[k] = int((per > 1e-5 * scale).sum())
        if (flipped[k] > (1e-3 * n_act if nacc else 0)
                or field_err[k] > (5e-2 if nacc else 1e-5) * scale):
            worst = int(per.argmax())
            raise AssertionError(
                f"g2p2g kernel: field {k} err {field_err[k]} (scale {scale}); "
                f"{flipped[k]} of {n_act} particles over 1e-5 x scale; worst "
                f"kernel {a[..., worst].tolist()} plain {b[..., worst].tolist()}")
    dk = pool_to_dense(cfg, dataclasses.replace(state, grid=pk))
    dp = pool_to_dense(cfg, dataclasses.replace(state, grid=pt))
    grid_err = max(float(np.abs(a - b).max()) for a, b in zip(dk, dp))
    grid_max = max(float(np.abs(b).max()) for b in dp)
    if float(pk[cfg.null_oct].abs().sum()) != 0.0:
        raise AssertionError("g2p2g kernel: null row not zero")
    if not (pos_err <= 2e-6 and grid_err <= 1e-5 * grid_max):
        raise AssertionError(f"g2p2g kernel: pos {pos_err} grid "
                             f"{grid_err} (max {grid_max})")
    if float((mk.pos[:, act] - model.pos[:, act]).abs().max()) == 0.0:
        raise AssertionError("g2p2g kernel: particles did not move")
    out = {"max_abs_err": grid_err, "grid_max": grid_max, "pos_err": pos_err,
           "field_err": field_err, "flipped": flipped, "active": n_act}
    if time_it:
        acc = torch.zeros_like(state.grid)
        out["ms"] = cuda_ms(lambda: kernel(acc.zero_()), reps=reps)
        out["plain_ms"] = cuda_ms(lambda: plain(acc.zero_()), reps=max(3, reps // 4),
                                  warmup=1)
    return out


def pallas_grid_colliders():
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


def check_grid_colliders_kernel(cfg, n_active: int, t: float = 0.37,
                                time_it: bool = True) -> dict:
    """K2 with the analytic colliders against core.grid.grid_update on the
    card, at collider time ``t``: mass rows bit-equal, velocities within
    rtol 1e-5 / atol 1e-7 (sinf/cosf/sqrtf may round apart from PyTorch's
    by an ulp; everything else is the same IEEE operations in the same
    order), max |v|^2 within 1e-6 relative, and the colliders changed
    cells."""
    from claymore_tpu_torch.core import grid
    from claymore_tpu_torch.ops import grid_kernel

    part, pool = random_grid_inputs(cfg, n_active)
    cols = pallas_grid_colliders()
    table = grid_kernel.pack_colliders(cols, DEVICE)
    dt = torch.tensor(3e-4, dtype=torch.float32, device=DEVICE)
    tt = torch.tensor(t, dtype=torch.float32, device=DEVICE)
    kv, km = grid_kernel.grid_update(cfg, pool, part, dt, cols, tt, table)
    pv, pm = grid.grid_update(cfg, pool, part, dt, cols, tt)
    free, _ = grid.grid_update(cfg, pool, part, dt)
    torch.cuda.synchronize()
    if not torch.equal(kv[:, 0:4], pv[:, 0:4]):
        raise AssertionError("grid collider kernel: mass rows differ")
    torch.testing.assert_close(kv[:, 4:16], pv[:, 4:16], rtol=1e-5, atol=1e-7)
    km, pm = float(km), float(pm)
    if not (pm > 0.0 and abs(km - pm) <= 1e-6 * pm):
        raise AssertionError(f"grid collider kernel: max|v|^2 {km} vs {pm}")
    hit = int((pv[:, 4:16] != free[:, 4:16]).sum())
    if hit == 0:
        raise AssertionError("grid collider kernel: no cell met a collider")
    out = {"max_abs_err": float((kv - pv).abs().max()), "cells_changed": hit}
    if time_it:
        out["ms"] = cuda_ms(lambda: grid_kernel.grid_update(cfg, pool, part, dt, cols,
                                                            tt, table))
        out["plain_ms"] = cuda_ms(lambda: grid.grid_update(cfg, pool, part, dt, cols,
                                                           tt), reps=5, warmup=1)
    return out


# --------------------------------------------------------------------------
# scenes (bench.py:48-177)
# --------------------------------------------------------------------------

def scene(name: str):
    """(cfg, materials, positions, velocities, colliders) of a bench.py
    scene, with the capacities bench.py gives it."""
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.io.sampler import sample_sphere, sample_uniform_box_world
    from claymore_tpu_torch.models.boundary import HalfSpace

    cfg = ct.SimConfig(domain_bits=8, max_active_blocks=8192, default_dt=1e-4,
                       rebucket_auto=True, particle_tile=512)
    box = sample_uniform_box_world
    vol = cfg.default_volume()
    slack, colliders = 1.25, ()
    if name == "cube":
        mats = [ct.FixedCorotated(volume=vol, e=5e3, nu=0.4)]
        parts = [box(cfg.dx, [0.3, 0.5, 0.3], [0.5, 0.7, 0.5], cfg.ppc)]
        v0s = [(0.0, -0.5, 0.0)]
    elif name == "sphere25m":
        cfg = dataclasses.replace(cfg, max_active_blocks=65536)
        mats = [ct.FixedCorotated(volume=vol, e=5e3, nu=0.4)]
        parts = [sample_sphere(cfg.dx, (0.5, 0.55, 0.5), 0.3547, cfg.ppc)]
        v0s = [(0.0, -0.5, 0.0)]
    elif name == "dambreak12m":
        # launched, so the drift-triggered rebuild fires every few
        # substeps; slack 2.5 because the column spreads (bench.py:95-100)
        cfg = dataclasses.replace(cfg, max_active_blocks=65536)
        mats = [ct.JFluid(volume=vol)]
        parts = [box(cfg.dx, [0.1, 0.1, 0.1], [0.4, 0.7, 0.6], cfg.ppc)]
        v0s = [(2.0, -2.0, 0.0)]
        slack = 2.5
    elif name in ("dambreak_hs", "sand", "nacc"):
        if name == "dambreak_hs":
            cfg = dataclasses.replace(cfg, max_active_blocks=24576)
            mats = [ct.JFluid(volume=vol)]
            parts = [box(cfg.dx, [0.1, 0.1, 0.1], [0.3, 0.5, 0.5], cfg.ppc)]
            colliders = (HalfSpace((0.0, 0.12, 0.0), (0.25, 1.0, 0.0), kind="slip",
                                   friction=0.2),)
        else:
            mats = [ct.Sand(volume=vol, e=1e4, rho=1500.0) if name == "sand"
                    else ct.NACC(volume=vol, e=1e4)]
            parts = [box(cfg.dx, [0.4, 0.1, 0.4], [0.6, 0.5, 0.6], cfg.ppc)]
        v0s = [(0.0, 0.0, 0.0)]
    elif name == "multimat":
        cfg = dataclasses.replace(cfg, max_active_blocks=16384)
        h = 0.2
        mats = [ct.FixedCorotated(volume=vol, e=5e3, nu=0.4), ct.JFluid(volume=vol),
                ct.Sand(volume=vol, e=1e4, rho=1500.0)]
        parts = [box(cfg.dx, [0.2, 0.5, 0.2], [0.2 + h, 0.5 + h, 0.2 + h], cfg.ppc),
                 box(cfg.dx, [0.5, 0.1, 0.5], [0.5 + h, 0.1 + h, 0.5 + h], cfg.ppc),
                 box(cfg.dx, [0.6, 0.5, 0.2], [0.6 + h, 0.5 + h, 0.2 + h], cfg.ppc)]
        v0s = [(0.0, -0.5, 0.0)] * 3
    else:
        raise ValueError(name)
    cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, parts, slack=slack))
    return cfg, mats, parts, v0s, colliders


def probe(state, n: int = 4096, model_idx: int = 0) -> np.ndarray:
    """Positions [3, n] of particles 0..n-1 of a model, found by id."""
    m = state.models[model_idx]
    sel = m.active & (m.pid < n)
    pid = m.pid[sel].long()
    out = torch.empty((3, n), dtype=torch.float32, device=m.pos.device)
    out[:, pid] = m.pos[:, sel]
    if int(sel.sum()) != n:
        raise AssertionError("probe particles missing")
    return out.cpu().numpy()


def reset_counts() -> None:
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    for counts in (grid_kernel.grid_update.launches, g2p2g_kernel.g2p2g.launches):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    return {**grid_kernel.grid_update.launches, **g2p2g_kernel.g2p2g.launches}


def drive(name: str, steps: int, facts: str, tile_chunk: int = 64) -> dict:
    """One main path: build the bench scene ``name``, zero the launch
    counts, init, one warm-up substep and ``steps`` timed substeps (each
    ended by a synchronise, so rebuilding substeps are timed apart), read
    the counts, and check the invariants.  Returns the metrics, the engine
    and the final state."""
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.ops.g2p2g_kernel import _LAYOUT

    cfg, mats, parts, v0s, cols = scene(name)
    n = sum(p.shape[0] for p in parts)
    eng = ct.MPMEngine(cfg, mats, cols, tile_chunk=tile_chunk, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = eng.init_state(parts, v0s)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_probe = [min(4096, p.shape[0]) for p in parts]
    p0 = [probe(state, n_probe[i], i) for i in range(len(mats))]
    fe = np.float32(1e9)
    state = eng.substep(state, fe)
    torch.cuda.synchronize()
    plain_ms, rebuild_ms = [], []
    for _ in range(steps):
        before = eng.rebuilds
        t0 = time.perf_counter()
        state = eng.substep(state, fe)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        (rebuild_ms if eng.rebuilds > before else plain_ms).append(ms)
    launches = read_counts()
    substeps = 1 + steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    d = eng.diagnostics(state)
    mass = float(state.grid[:-1, 0:4].double().sum())
    expected = sum(p.shape[0] * m.mass for p, m in zip(parts, mats))
    mass_err = abs(mass - expected) / expected
    disp = min(float(np.abs(probe(state, n_probe[i], i) - p0[i]).max())
               for i in range(len(mats)))
    grid_name = "grid_update_colliders" if cols else "grid_update"
    used = [grid_name] + [_LAYOUT[type(m)][0] for m in mats]
    checks = {
        "mass": mass_err < 1e-5,
        "null_row": d["null_block_mass"] == 0.0,
        "dropped": all(d[f"model{i}_dropped_tiles"] == 0 for i in range(len(mats))),
        "active": all(d[f"model{i}_active"] == p.shape[0] for i, p in enumerate(parts)),
        "overflow": d["block_overflow"] == 0,
        "finite": bool(np.isfinite(d["t"]) and np.isfinite(float(state.max_vel))),
        "moves": disp > 0.0,
        "launches": min(launches[k] for k in used) >= substeps,
        "steps": d["step"] == substeps,
    }
    total_ms = sum(plain_ms) + sum(rebuild_ms)
    out = {
        "particles": n, "substeps": substeps, "ms_per_substep": total_ms / steps,
        "mpps": n * steps / total_ms / 1e3, "rebuilds": eng.rebuilds,
        "ms_rebuilding": float(np.mean(rebuild_ms)) if rebuild_ms else None,
        "ms_drift_only": float(np.mean(plain_ms)) if plain_ms else None,
        "init_s": init_s, "peak_gib": peak_gib, "mass_rel_err": mass_err,
        "displacement": disp, "launches": {k: launches[k] for k in used},
    }
    log(f"main path {name}: {n} particles, {substeps} substeps, "
        f"{out['ms_per_substep']:.3f} ms/substep, {out['mpps']:.2f} M particle-steps/s, "
        f"rebuilds {eng.rebuilds} (auto), rebuilding substep "
        f"{out['ms_rebuilding'] if out['ms_rebuilding'] is None else round(out['ms_rebuilding'], 3)} ms, "
        f"drift-only substep {out['ms_drift_only'] if out['ms_drift_only'] is None else round(out['ms_drift_only'], 3)} ms, "
        f"init {init_s:.2f} s, peak {peak_gib:.2f} GiB, mass_rel_err {mass_err:.3e}, "
        f"displacement {disp:.3e}, launches {out['launches']} | {facts}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path {name} checks failed: {failed} ({d}, "
                             f"launches {launches})")
    return {"metrics": out, "engine": eng, "state": state, "cfg": cfg, "mats": mats}


def stage_breakdown(cfg, mats, state, reps: int = 10, tile_chunk: int = 64) -> dict:
    """Median CUDA-event milliseconds of each stage of a substep on
    ``state`` (single model): K2, the CFL step, K1, the drift check with
    its host read, and the three parts of a rebuild.  Not counted."""
    from claymore_tpu_torch.core import grid, partition
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    mat, model = mats[0], state.models[0]
    fe = torch.tensor(1e9, device=DEVICE)
    pool_v, mvs = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt)
    next_dt = grid.compute_dt(cfg, mvs, state.t + state.dt, fe)
    acc = torch.zeros_like(state.grid)
    nt = model.tiles.block.shape[0]
    pm, tk, dr = partition.sort_permute(cfg, model, nt)
    part, _ = partition.rebuild(cfg, state.grid, state.partition, (tk,))
    stages = {
        "K2 grid_update": lambda: grid_kernel.grid_update(
            cfg, state.grid, state.partition, state.dt),
        "compute_dt": lambda: grid.compute_dt(cfg, mvs, state.t + state.dt, fe),
        "K1 g2p2g": lambda: g2p2g_kernel.g2p2g(
            cfg, mat, pool_v, state.partition.table, model, state.dt, next_dt,
            acc.zero_(), tile_chunk),
        "arena_margin + host read": lambda: bool(
            partition.arena_margin(cfg, model) <= 0.0),
        "sort_permute": lambda: partition.sort_permute(cfg, model, nt),
        "rebuild": lambda: partition.rebuild(cfg, state.grid, state.partition, (tk,)),
        "finalize_tiles": lambda: partition.finalize_tiles(cfg, part, tk, dr),
    }
    return {k: cuda_ms(f, reps=reps) for k, f in stages.items()}


def log_k1(label: str, k1: dict, facts: str) -> None:
    log(f"K1 {label} vs plain: grid err {k1['max_abs_err']:.3e} (max "
        f"{k1['grid_max']:.3e}), pos {k1['pos_err']:.3e}, fields "
        f"{ {k: float(f'{v:.3e}') for k, v in k1['field_err'].items()} } "
        f"(particles over 1e-5 x scale: {k1['flipped']} of {k1['active']}), "
        f"kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms | {facts}")


def run_cli(facts: str) -> dict:
    """The CLI on scenes/dambreak.json, one frame, on the card, as a
    subprocess; the .bgeo it writes must hold every particle."""
    from claymore_tpu_torch.io import bgeo
    from claymore_tpu_torch.io.scene import _model_positions
    from claymore_tpu_torch.config import SimConfig

    root = Path(__file__).resolve().parent
    scene_file = root / "scenes" / "dambreak.json"
    out_dir = root / "build" / "smoke_cli"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "claymore_tpu_torch", "-f", str(scene_file),
         "--frames", "1", "-o", str(out_dir), "--device", "cuda", "--profile"],
        cwd=root, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    tail = "\n".join(proc.stdout.strip().splitlines()[-6:])
    if proc.returncode != 0:
        raise AssertionError(f"CLI exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    doc = json.loads(scene_file.read_text())
    g = doc["grid"]
    cfg = SimConfig(domain_bits=g["domain_bits"], max_active_blocks=g["max_active_blocks"])
    n = _model_positions(doc["models"][0], cfg, str(scene_file.parent)).shape[0]
    pos, _ = bgeo.read_bgeo(str(out_dir / "model0_frame0000.bgeo"))
    if pos.shape != (n, 3) or not np.all(np.isfinite(pos)):
        raise AssertionError(f"CLI wrote {pos.shape} positions, scene has {n}")
    log(f"CLI dambreak.json --frames 1: exit 0 in {wall:.1f} s, {pos.shape[0]} "
        f"particles read back from model0_frame0000.bgeo (scene: {n})\n{tail}"
        f"\n| {facts}")
    return {"particles": n, "wall_s": wall}


# --------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.ops import _build

    t_start = time.perf_counter()
    # 1. facts
    facts = gpu_facts()
    log(f"gpu: {facts}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")

    # 2. build (one nvcc per source, in parallel; -Xptxas -v lists
    #    registers and spills per kernel)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {_build.BUILD_DIR / _build.LIB_NAME}")

    # 3. K2 and K2 with colliders at the flagship pool shape
    cfg25, mats25, parts25, v0s25, _ = scene("sphere25m")
    mat25, pos25, v0 = mats25[0], parts25[0], v0s25[0]
    k2 = check_grid_kernel(cfg25, n_active=cfg25.num_oct_keys)
    log(f"K2 grid_update vs plain, pool {cfg25.max_active_octs + 1}x16x128: "
        f"max_abs_err {k2['max_abs_err']:.3e}, kernel {k2['ms']:.4f} ms, "
        f"plain {k2['plain_ms']:.4f} ms | {facts}")
    k2c = check_grid_colliders_kernel(cfg25, n_active=cfg25.num_oct_keys)
    log(f"K2 grid_update_colliders vs plain, pool {cfg25.max_active_octs + 1}x16x128, "
        f"3 colliders, t=0.37: max_abs_err {k2c['max_abs_err']:.3e}, "
        f"{k2c['cells_changed']} velocity values changed by colliders, kernel "
        f"{k2c['ms']:.4f} ms, plain {k2c['plain_ms']:.4f} ms | {facts}")

    # 4. K1 on the 1.07M cube after init and one grid update
    cfgc, matsc, partsc, v0sc, _ = scene("cube")
    matc, posc, v0c = matsc[0], partsc[0], v0sc[0]
    engc = ct.MPMEngine(cfgc, [matc], tile_chunk=64, device=DEVICE)
    sc = engc.init_state([posc], [v0c])
    k1c = check_g2p2g_kernel(cfgc, matc, sc, tile_chunk=64)
    log_k1(f"g2p2g_fixed_corotated, cube {posc.shape[0]} particles", k1c, facts)
    del sc

    # 5. main path 1: the 25M sphere, counted launches
    n = pos25.shape[0]
    eng = ct.MPMEngine(cfg25, [mat25], tile_chunk=64, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = eng.init_state([pos25], [v0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p0 = probe(state)
    fe = np.float32(1e9)
    state = eng.substep(state, fe)
    torch.cuda.synchronize()
    steps = 60
    t0 = time.perf_counter()
    state = eng.run_steps(state, steps, fe)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    auto_rebuilds = eng.rebuilds
    eng_every = ct.MPMEngine(dataclasses.replace(cfg25, rebucket_auto=False), [mat25],
                             tile_chunk=64, device=DEVICE)
    t0 = time.perf_counter()
    state = eng_every.run_steps(state, 3, fe)
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) / 3 * 1e3
    counts = read_counts()
    launches = {k: counts[k] for k in ("grid_update", "g2p2g_fixed_corotated")}
    substeps = 1 + steps + 3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rebuilds = auto_rebuilds + eng_every.rebuilds

    d = eng.diagnostics(state)
    mass = float(state.grid[:-1, 0:4].double().sum())
    expected = n * mat25.mass
    mass_err = abs(mass - expected) / expected
    disp = float(np.abs(probe(state) - p0).max())
    checks = {
        "mass": mass_err < 1e-5,
        "null_row": d["null_block_mass"] == 0.0,
        "dropped": d["model0_dropped_tiles"] == 0,
        "overflow": d["block_overflow"] == 0,
        "finite": bool(np.isfinite(d["t"]) and np.isfinite(float(state.max_vel))),
        "moves": disp > 0.0,
        "rebuilt": eng_every.rebuilds == 3,
        "launches": min(launches.values()) >= substeps,
        "steps": d["step"] == substeps,
    }
    ms = elapsed / steps * 1e3
    log(f"main path sphere25m: {n} particles, {substeps} substeps, {ms:.3f} ms/substep, "
        f"{n * steps / elapsed / 1e6:.2f} M particle-steps/s, rebuilds {rebuilds} "
        f"(auto {auto_rebuilds}), {rebuild_ms:.3f} ms/substep with a rebuild, "
        f"init {init_s:.2f} s, peak {peak_gib:.2f} GiB, "
        f"mass_rel_err {mass_err:.3e}, displacement {disp:.3e}, launches {launches} "
        f"| {facts}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed} ({d})")

    # kernels at the main path's shapes, on its final state (not counted)
    k1 = check_g2p2g_kernel(cfg25, mat25, state, tile_chunk=64, reps=10)
    log_k1("g2p2g_fixed_corotated, sphere25m state", k1, facts)
    del state, eng, eng_every

    # 6. the run() entry point on the cube
    engc = ct.MPMEngine(cfgc, [matc], tile_chunk=64, device=DEVICE)
    sc = engc.init_state([posc], [v0c])
    sc = engc.run(sc, frames=1, check_health=True)
    engc.check_health(sc, strict=True)
    dc = engc.diagnostics(sc)
    log(f"run(frames=1) cube: {dc['step']} substeps, t {dc['t']:.6f}, "
        f"rebuilds {engc.rebuilds}, active {dc['model0_active']}/{posc.shape[0]}")
    if abs(dc["t"] - cfgc.frame_dt()) > 1e-6 or dc["model0_active"] != posc.shape[0]:
        raise AssertionError(f"run(): {dc}")
    del sc, engc

    # 7. main path 2: the 12.1M JFluid dam break, drift-triggered rebuilds
    paths = {"sphere25m": {"launches": launches}}
    db = drive("dambreak12m", steps=80, facts=facts)
    if db["metrics"]["rebuilds"] == 0:
        raise AssertionError("dambreak12m: no drift-triggered rebuild fired")
    paths["dambreak12m"] = db["metrics"]
    stages = stage_breakdown(db["cfg"], db["mats"], db["state"])
    log("dambreak12m stages on its final state (ms, median of 10): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f" | {facts}")
    del db

    # 8. scenes at bench size; each material's K1 variant held against its
    #    plain version on a stirred copy of the scene's final state (not
    #    counted)
    k1v = {}
    for name, steps, model_idx in (("sand", 40, 0), ("nacc", 40, 0),
                                   ("multimat", 40, 1), ("dambreak_hs", 40, None)):
        run = drive(name, steps=steps, facts=facts)
        paths[name] = run["metrics"]
        if model_idx is not None:
            mat = run["mats"][model_idx]
            key = "g2p2g_" + mat.name
            k1v[key] = check_g2p2g_kernel(run["cfg"], mat, stir(run["state"]),
                                          tile_chunk=64, reps=10, model_idx=model_idx)
            n_model = int(run["state"].models[model_idx].active.sum())
            log_k1(f"{key}, {name} state, model {model_idx}, {n_model} particles",
                   k1v[key], facts)
        del run

    # 9. the CLI
    run_cli(facts)

    src = "claymore_tpu_torch/csrc/"
    k1_call = "claymore_tpu/ops/pallas_g2p2g.py:783"

    def k1_entry(name, path, check):
        return {"name": name, "route": "cuda", "source": src + "g2p2g.cu",
                "replaces": k1_call, "launches": paths[path]["launches"][name],
                "max_abs_err": check["max_abs_err"], "ms": check["ms"],
                "plain_ms": check["plain_ms"]}

    kernels = [
        {"name": "grid_update", "route": "cuda", "source": src + "grid_update.cu",
         "replaces": "claymore_tpu/ops/pallas_grid.py:192",
         "launches": paths["sphere25m"]["launches"]["grid_update"],
         "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
        {"name": "grid_update_colliders", "route": "cuda",
         "source": src + "grid_update.cu",
         "replaces": "claymore_tpu/ops/pallas_grid.py:192",
         "launches": paths["dambreak_hs"]["launches"]["grid_update_colliders"],
         "max_abs_err": k2c["max_abs_err"], "ms": k2c["ms"],
         "plain_ms": k2c["plain_ms"]},
        k1_entry("g2p2g_fixed_corotated", "sphere25m", k1),
        k1_entry("g2p2g_jfluid", "dambreak12m", k1v["g2p2g_jfluid"]),
        k1_entry("g2p2g_sand", "sand", k1v["g2p2g_sand"]),
        k1_entry("g2p2g_nacc", "nacc", k1v["g2p2g_nacc"]),
    ]
    if min(k["launches"] for k in kernels) <= 0:
        raise AssertionError(f"a kernel was not launched on its main path: {kernels}")
    log(f"paths: {json.dumps(paths)}")
    log(f"whole script: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(facts)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
