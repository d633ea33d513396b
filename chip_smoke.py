"""Smoke run of the PyTorch/CUDA port (claymore_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``claymore_tpu_torch/csrc``, holds each against
its plain PyTorch version on the card, drives the main path (the ~25M
particle FixedCorotated sphere of ``bench.py --scene=sphere25m``) through
``MPMEngine`` and checks its invariants, then runs the ``run()`` entry
point on the 1M-particle cube.  Every phase raises on failure.  The line
before the last is a JSON object with one entry per kernel; the last line
is ``{"ok": true, "device": {...}}``.  Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

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


def check_g2p2g_kernel(cfg, mat, state, tile_chunk: int, time_it: bool = True,
                       reps: int = 20) -> dict:
    """K1 against core.transfer.g2p2g_model on the card, from one grid update
    of ``state``: dense grids within 1e-5 x the largest grid value (float
    atomics reorder the sums), identical active sets, positions of the same
    particle within 2e-6 and F within 1e-5."""
    from claymore_tpu_torch.core import grid, transfer
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel
    from claymore_tpu_torch.utils.debug import pool_to_dense

    pool_v, mvs = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt)
    next_dt = grid.compute_dt(cfg, mvs, state.t + state.dt,
                              torch.tensor(1e9, device=DEVICE))
    table, model = state.partition.table, state.models[0]

    def kernel(acc):
        return g2p2g_kernel.g2p2g(cfg, mat, pool_v, table, model, state.dt,
                                  next_dt, acc)

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
    f_err = float((mk.fields["F"][:, act] - mt.fields["F"][:, act]).abs().max())
    dk = pool_to_dense(cfg, dataclasses.replace(state, grid=pk))
    dp = pool_to_dense(cfg, dataclasses.replace(state, grid=pt))
    grid_err = max(float(np.abs(a - b).max()) for a, b in zip(dk, dp))
    grid_max = max(float(np.abs(b).max()) for b in dp)
    if float(pk[cfg.null_oct].abs().sum()) != 0.0:
        raise AssertionError("g2p2g kernel: null row not zero")
    if not (pos_err <= 2e-6 and f_err <= 1e-5 and grid_err <= 1e-5 * grid_max):
        raise AssertionError(f"g2p2g kernel: pos {pos_err} F {f_err} grid "
                             f"{grid_err} (max {grid_max})")
    if float((mk.pos[:, act] - model.pos[:, act]).abs().max()) == 0.0:
        raise AssertionError("g2p2g kernel: particles did not move")
    out = {"max_abs_err": grid_err, "grid_max": grid_max, "pos_err": pos_err,
           "F_err": f_err}
    if time_it:
        acc = torch.zeros_like(state.grid)
        out["ms"] = cuda_ms(lambda: kernel(acc.zero_()), reps=reps)
        out["plain_ms"] = cuda_ms(lambda: plain(acc.zero_()), reps=max(3, reps // 4),
                                  warmup=1)
    return out


# --------------------------------------------------------------------------
# scenes (bench.py:48-73)
# --------------------------------------------------------------------------

def scene(name: str):
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.io.sampler import sample_sphere, sample_uniform_box_world

    if name == "cube":
        cfg = ct.SimConfig(domain_bits=8, max_active_blocks=8192, default_dt=1e-4,
                           rebucket_auto=True, particle_tile=512)
        pos = sample_uniform_box_world(cfg.dx, [0.3, 0.5, 0.3], [0.5, 0.7, 0.5],
                                       cfg.ppc)
    elif name == "sphere25m":
        cfg = ct.SimConfig(domain_bits=8, max_active_blocks=65536, default_dt=1e-4,
                           rebucket_auto=True, particle_tile=512)
        pos = sample_sphere(cfg.dx, (0.5, 0.55, 0.5), 0.3547, cfg.ppc)
    else:
        raise ValueError(name)
    cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, [pos], slack=1.25))
    mat = ct.FixedCorotated(volume=cfg.default_volume(), e=5e3, nu=0.4)
    return cfg, mat, pos, (0.0, -0.5, 0.0)


def probe(state, n: int = 4096) -> np.ndarray:
    """Positions [3, n] of particles 0..n-1, found by id."""
    m = state.models[0]
    sel = m.active & (m.pid < n)
    pid = m.pid[sel].long()
    out = torch.empty((3, n), dtype=torch.float32, device=m.pos.device)
    out[:, pid] = m.pos[:, sel]
    if int(sel.sum()) != n:
        raise AssertionError("probe particles missing")
    return out.cpu().numpy()


# --------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.ops import _build, g2p2g_kernel, grid_kernel

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

    # 2. build
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {_build.BUILD_DIR / _build.LIB_NAME}")

    # 3. K2 at the flagship pool shape
    cfg25, mat25, pos25, v0 = scene("sphere25m")
    k2 = check_grid_kernel(cfg25, n_active=cfg25.num_oct_keys)
    log(f"K2 grid_update vs plain, pool {cfg25.max_active_octs + 1}x16x128: "
        f"max_abs_err {k2['max_abs_err']:.3e}, kernel {k2['ms']:.4f} ms, "
        f"plain {k2['plain_ms']:.4f} ms | {facts}")

    # 4. K1 on the 1.07M cube after init and one grid update
    cfgc, matc, posc, v0c = scene("cube")
    engc = ct.MPMEngine(cfgc, [matc], tile_chunk=64, device=DEVICE)
    sc = engc.init_state([posc], [v0c])
    k1c = check_g2p2g_kernel(cfgc, matc, sc, tile_chunk=64)
    log(f"K1 g2p2g vs plain, cube {posc.shape[0]} particles: grid err "
        f"{k1c['max_abs_err']:.3e} (max {k1c['grid_max']:.3e}), pos {k1c['pos_err']:.3e}, "
        f"F {k1c['F_err']:.3e}, kernel {k1c['ms']:.4f} ms, plain {k1c['plain_ms']:.4f} ms "
        f"| {facts}")
    del sc

    # 5. main path: the 25M sphere, counted launches
    n = pos25.shape[0]
    eng = ct.MPMEngine(cfg25, [mat25], tile_chunk=64, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    grid_kernel.grid_update.launches = 0
    g2p2g_kernel.g2p2g.launches = 0
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
    launches = {"grid_update": grid_kernel.grid_update.launches,
                "g2p2g_fixed_corotated": g2p2g_kernel.g2p2g.launches}
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
    log(f"K1 g2p2g vs plain, sphere25m state: grid err {k1['max_abs_err']:.3e} "
        f"(max {k1['grid_max']:.3e}), pos {k1['pos_err']:.3e}, F {k1['F_err']:.3e}, "
        f"kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms | {facts}")
    del state

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

    src = "claymore_tpu_torch/csrc/"
    kernels = [
        {"name": "grid_update", "route": "cuda", "source": src + "grid_update.cu",
         "replaces": "claymore_tpu/ops/pallas_grid.py:192",
         "launches": launches["grid_update"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
        {"name": "g2p2g_fixed_corotated", "route": "cuda", "source": src + "g2p2g.cu",
         "replaces": "claymore_tpu/ops/pallas_g2p2g.py:783",
         "launches": launches["g2p2g_fixed_corotated"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(facts)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
