"""K1 by material and slot order, the particle-stream floor, the drift
check, the drift-only substep and the lane-window probes P2/P3, on one card.

    python -m claymore_tpu_torch.scripts.prof_k1 [--substeps 64] [--reps 10] [--cells]
    PYTHONPATH=<another checkout> python3 claymore_tpu_torch/scripts/prof_k1.py

CUDA-event milliseconds (median of ``--reps`` calls after a warm-up) of:

* K1 on the benchmark's sphere25m and dambreak12m states, built as its
  cells build theirs (jittered lattice, capacity from ``exact_tiles`` at
  the cell's slack), at set-up and after 20 substeps, with their live,
  dead and overflow tiles, the share of the slots K1 streams, and how
  evenly its blocks shared the tiles: the static walks' model
  (``block_live``) and, from the kernel's own counter, the busiest block's
  live tiles and span over the mean (``block_balance``) (under ``cells``;
  with ``--cells`` nothing else);
* K1-FC on ``bench.py``'s sphere25m (25,088,753 particles) after one
  substep and after ``--substeps``, with every tile's slots as they are,
  permuted by a seeded permutation, and sorted by G2P stencil base
  (``permute_tiles``); and with every tile dead, which leaves only the
  particle state streaming through (``stream_floor``);
* K1-JF on dambreak12m (12,103,168 JFluid) after 20 substeps, K1-SD and
  K1-NC on the 2,132,820-particle sand and nacc boxes after 40 substeps,
  their grid velocities stirred so that the return maps branch;
* K1's span-4 variant on the span-4 states ``chip_smoke.py`` holds to the
  plain version: sphere25m after 61 substeps with a rebuild every 4
  (FixedCorotated), sand and nacc after 21 and multimat's JFluid after 21
  (``rebucket_every=4``, stirred), each also with every 4th live tile's
  particles spread over the arena (``spread_tiles``), and each state's
  share of wide tiles (``wide_tiles`` on K1's output; with the kernel's own
  count, ``wide_tile_counter``, beside it);
* the drift check on the sphere25m state (what the substep does after K1
  to decide on a rebuild, host read included) and, on the host clock, its
  drift-only substep (median of 20 synchronised substeps);
* P2 ``dyn_lane_read`` and P3 ``dyn_lane_read_wide`` at 65,536 random tiles,
  and ``torch.gather`` with a precomputed index doing the same (each timed
  10 calls back to back).

Prints one JSON line.  Only the package's entry points are used: run as a
file with another checkout first on ``PYTHONPATH``, it times that
checkout's kernels, and two checkouts compare on one card within one call.
Needs a CUDA device (exit 2 without one).
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


WINDOW_BASES = 6     # stencil bases an axis of K1's span-4 P2G window (csrc/g2p2g.cu)


def tile_extent(cfg, model) -> torch.Tensor:
    """[3, T] extent per axis (max - min + 1) of the stencil bases
    (``partition.base_cell``) of each tile's active particles; 0 for a dead
    tile or one with none active.  On K1's output (post-advection
    positions, the particles it kept) at span 4, a tile whose extent exceeds
    ``WINDOW_BASES`` on some axis is one the kernel transfers in more than
    one P2G pass."""
    from claymore_tpu_torch.core import partition

    t, n = model.tiles.tvalid.shape[0], cfg.particle_tile
    base = partition.base_cell(cfg, model.pos).reshape(3, t, n)
    live = (model.active.reshape(t, n) & model.tiles.tvalid[:, None])[None]
    big = torch.iinfo(torch.int32).max
    hi = torch.where(live, base, -big).amax(dim=2)
    lo = torch.where(live, base, big).amin(dim=2)
    return torch.where(live.any(dim=2), hi - lo + 1, torch.zeros_like(hi))


def wide_tiles(cfg, model):
    """(wide tiles, tiles holding an active particle) of ``model``: wide
    where ``tile_extent`` exceeds ``WINDOW_BASES`` on some axis."""
    ext = tile_extent(cfg, model)
    return int((ext > WINDOW_BASES).any(dim=0).sum()), int((ext > 0).any(dim=0).sum())


def spread_tiles(cfg, state, every: int = 4, seed: int = SEED, model_idx: int = 0):
    """``state`` (span 4) with the active particles of every ``every``-th
    live tile of one model moved to seeded positions spread over the tile's
    arena: per tile and axis a run of 4..14 stencil bases at a seeded
    offset among the arena's 14, so that nearly every such tile spans more
    bases than K1's window and some the whole arena (three P2G passes an
    axis).  The numbers come from numpy, so the CPU and the card get the
    same state.  Tiles, partition, grid and fields are kept."""
    if cfg.arena_span != 4:
        raise ValueError("spread_tiles takes a span-4 state")
    m = state.models[model_idx]
    t, n, bs = m.tiles.tvalid.shape[0], cfg.particle_tile, cfg.block_size
    pick = np.nonzero(m.tiles.tvalid.cpu().numpy())[0][::every]
    rng = np.random.default_rng(seed)
    k = len(pick)
    width = rng.integers(4, 15, size=(3, k))
    start = rng.integers(0, 15 - width)
    # relative cell coordinates whose stencil bases run start .. start + width - 1
    xs = start[..., None] + 0.5 + rng.random((3, k, n), dtype=np.float32) * width[..., None]
    dev = m.pos.device
    idx = torch.from_numpy(pick).to(dev)
    org = ((m.tiles.bcoord[:, idx] + cfg.arena_lo) * bs).to(torch.float32)[..., None]
    new = (org + torch.from_numpy(xs.astype(np.float32)).to(dev)) * cfg.dx
    pos = m.pos.clone().reshape(3, t, n)
    act = m.active.reshape(t, n)[idx][None]
    pos[:, idx] = torch.where(act, new, pos[:, idx])
    models = list(state.models)
    models[model_idx] = dataclasses.replace(m, pos=pos.reshape(3, -1))
    return dataclasses.replace(state, models=tuple(models))


def carve_tiles(cfg, state, seed: int = SEED, model_idx: int = 0):
    """``state`` with uneven occupied prefixes for K1 (tiles, partition and
    grid kept; the choice is numpy-seeded, so the CPU and the card get the
    same state): of the live tiles in order, every third keeps only its
    first 1..34 slots (an overflow tile's few particles), the one after it
    keeps a seeded half of its slots (holes inside its prefix) and every
    17th keeps none (a valid tile with no active slot).  Every inactive
    slot, the dead tiles' too, holds NaN in its position and fields, and id
    S."""
    m = state.models[model_idx]
    t, n = m.tiles.tvalid.shape[0], cfg.particle_tile
    live = np.nonzero(m.tiles.tvalid.cpu().numpy())[0]
    rng = np.random.default_rng(seed)
    keep = np.ones((t, n), dtype=bool)
    short = live[0::3]
    keep[short] = np.arange(n)[None, :] < rng.integers(1, 35, size=(len(short), 1))
    holes = live[1::3]
    keep[holes] = rng.random((len(holes), n)) < 0.5
    keep[live[::17]] = False
    act = m.active & torch.from_numpy(keep.reshape(-1)).to(m.active.device)

    def nan(x):
        return torch.where(act, x, torch.full_like(x, float("nan")))

    models = list(state.models)
    models[model_idx] = dataclasses.replace(
        m, pos=nan(m.pos), fields={k: nan(v) for k, v in m.fields.items()}, active=act,
        pid=torch.where(act, m.pid, torch.full_like(m.pid, t * n)))
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


def k1_ms(cfg, mat, state, reps: int, dead: bool = False, model_idx: int = 0) -> float:
    """K1 from one grid update of ``state`` into a pool it keeps adding to
    (the accumulator's contents do not change the work)."""
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    pool_v, _ = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt)
    model = state.models[model_idx]
    if dead:
        model = dataclasses.replace(model, tiles=dataclasses.replace(
            model.tiles, tvalid=torch.zeros_like(model.tiles.tvalid)))
    acc = torch.zeros_like(state.grid)
    return median_ms(lambda: g2p2g_kernel.g2p2g(cfg, mat, pool_v, state.partition.table,
                                                model, state.dt, state.dt, acc, 64),
                     reps, warmup=1)


def drift_check_ms(cfg, mat, state, reps: int) -> float:
    """What the substep does after K1 to decide on a rebuild: the host read
    of the margin K1 returned."""
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    pool_v, _ = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt)
    _, _, margin = g2p2g_kernel.g2p2g(cfg, mat, pool_v, state.partition.table,
                                      state.models[0], state.dt, state.dt,
                                      torch.zeros_like(state.grid), 64)
    return median_ms(lambda: bool(margin <= 0.0), reps, warmup=1)


def k1_wide(cfg, mat, state, model_idx: int = 0) -> dict:
    """One K1 call on ``state``: ``wide_tiles`` of its output, and the
    kernel's own count of wide tiles."""
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    pool_v, _ = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt)
    g2p2g_kernel.wide_tile_counter("cuda").zero_()
    out = g2p2g_kernel.g2p2g(cfg, mat, pool_v, state.partition.table,
                             state.models[model_idx], state.dt, state.dt,
                             torch.zeros_like(state.grid), 64)[0]
    wide, live = wide_tiles(cfg, out)
    return {"wide": wide, "live": live, "share": wide / max(live, 1),
            "kernel_count": int(g2p2g_kernel.wide_tile_counter("cuda")[0])}


def engine(name: str, steps: int, stirred: bool = False, **cfg_kw):
    """(engine, cfg, materials, state) of ``bench.py``'s scene ``name`` (its
    configuration with ``cfg_kw`` replaced) after ``steps`` substeps."""
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.scripts.bench import build

    cfg, mats, parts, v0s, cols = build(name, False)
    cfg = dataclasses.replace(cfg, **cfg_kw)
    eng = ct.MPMEngine(cfg, mats, cols, tile_chunk=64, device="cuda")
    state = eng.run_steps(eng.init_state(parts, v0s), steps, np.float32(1e9))
    return eng, cfg, mats, stir(state) if stirred else state


# the benchmark's cells: bench.py's scene and the tile slack of its
# configuration (mpmbench/configs/<name>.json)
CELL_SLACK = {"sphere25m": 1.25, "dambreak12m": 2.5}


def jittered_engine(name: str, seed: int = SEED):
    """(engine, cfg, material, state) of ``bench.py``'s scene ``name`` built
    as the benchmark's cells build theirs (``mpmbench/scene.py``): the
    source's lattice with every point moved by a seeded uniform offset
    inside its own lattice spacing, and the tile capacity from
    ``exact_tiles`` of those points at the cell's ``CELL_SLACK``."""
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.scripts.bench import build

    cfg, (mat,), (pos,), (v0,), _ = build(name, False)
    h = cfg.dx / cfg.ppc ** (1.0 / 3.0)
    rng = np.random.default_rng(seed)
    pos = (pos + (rng.random(pos.shape, dtype=np.float32) - 0.5) * np.float32(h)).astype(
        np.float32)
    cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, [pos], slack=CELL_SLACK[name]))
    eng = ct.MPMEngine(cfg, [mat], (), tile_chunk=64, device="cuda")
    return eng, cfg, mat, eng.init_state([pos], [v0])


def tile_counts(cfg, model) -> dict:
    """Slots, active particles and tiles of ``model`` as K1 streams them:
    live tiles (valid, an active slot), dead tiles (the rest), overflow
    tiles (live, the second or later tile of their block), and the share
    of the slots in the tiles' occupied prefixes (one past the last active
    slot rounded up to 16: ``g2p2g_kernel.occupied_slots``)."""
    from claymore_tpu_torch.ops.g2p2g_kernel import occupied_slots

    t, n = model.tiles.tvalid.shape[0], cfg.particle_tile
    act = model.active.reshape(t, n) & model.tiles.tvalid[:, None]
    live = act.any(dim=1)
    block = model.tiles.block
    second = torch.zeros_like(live)
    second[1:] = live[1:] & live[:-1] & (block[1:] == block[:-1])
    prefix = occupied_slots(cfg, model)
    return {"slots": t * n, "active": int(act.sum()), "tiles": t, "live_tiles": int(live.sum()),
            "dead_tiles": int((~live).sum()), "overflow_tiles": int(second.sum()),
            "active_share": int(act.sum()) / (t * n),
            "occupied_share": int(prefix.sum()) / (t * n)}


def block_loads(live: torch.Tensor, blocks: int) -> dict:
    """The static walks' model of K1's balance (the kernel hands its tiles
    out at run time; ``block_balance`` reads what it did): live
    tiles a block of a persistent grid of ``blocks`` walks when block b
    takes tiles b, b + blocks, ...: max and mean over the blocks, and the
    same for a walk whose k-th tile of block b is k blocks + (b + k) mod
    blocks (every residue of the tile index mod 8, where each oct's tiles
    are padded to 8, seen alike)."""
    t = live.shape[0]
    rows = -(-t // blocks)
    x = torch.cat([live.int(), live.new_zeros(rows * blocks - t, dtype=torch.int32)])
    x = x.reshape(rows, blocks)
    per = x.sum(dim=0).float()
    k = torch.arange(rows, device=x.device)[:, None]
    b = torch.arange(blocks, device=x.device)[None, :]
    rot = torch.zeros(blocks, dtype=torch.float32, device=x.device).index_add_(
        0, ((b - k) % blocks).reshape(-1), x.reshape(-1).float())
    return {"blocks": blocks, "max": float(per.max()), "mean": float(per.mean()),
            "rotated_max": float(rot.max())}


def block_balance(words) -> dict:
    """K1's ``block_balance_counter`` (blocks, the sum and max of the live
    tiles a block transferred, the sum and max of a block's span in ns,
    claims) as the mean and max a block and their ratio (1: every block
    alike), and the claims a block; None where no block ran."""
    blocks, live_sum, live_max, ns_sum, ns_max, claims = (int(w) for w in words)
    if blocks == 0:
        return None
    live_mean, ns_mean = live_sum / blocks, ns_sum / blocks
    return {"blocks": blocks, "live_max": live_max, "live_mean": live_mean,
            "live_ratio": live_max / live_mean if live_sum else None,
            "block_ms_max": ns_max / 1e6, "block_ms_mean": ns_mean / 1e6,
            "time_ratio": ns_max / ns_mean if ns_sum else None,
            "claims_per_block": claims / blocks}


def cell_states(reps: int, substeps: int = 20) -> dict:
    """K1 on the benchmark's two configurations built as its cells build
    them (``jittered_engine``), at set-up and after ``substeps`` drift
    substeps: ms, the tile counts, the static walks' model of the blocks'
    live tiles (``block_loads``), the kernel's own count of streamed slots
    as a share of the slots (``streamed_slot_counter``), and what its
    blocks did (``block_balance`` of ``block_balance_counter``)."""
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    counter = g2p2g_kernel.streamed_slot_counter
    balance = g2p2g_kernel.block_balance_counter
    fe = torch.tensor(1e9, device="cuda")
    out = {}
    for name in CELL_SLACK:
        eng, cfg, mat, state = jittered_engine(name)
        res = {}
        for label, steps in (("init", 0), (f"after_{substeps}", substeps)):
            state = eng.run_steps(state, steps, fe)
            row = tile_counts(cfg, state.models[0])
            m = state.models[0]
            live = (m.active.reshape(row["tiles"], -1) & m.tiles.tvalid[:, None]).any(dim=1)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            row["block_live"] = block_loads(live, sms * g2p2g_kernel.kernel_info(
                mat, cfg.particle_tile, cfg.arena_span)["blocks_per_sm"])
            row["ms"] = k1_ms(cfg, mat, state, reps)
            pool_v, _ = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt)
            counter("cuda").zero_()
            balance("cuda").zero_()
            g2p2g_kernel.g2p2g(cfg, mat, pool_v, state.partition.table, state.models[0],
                               state.dt, state.dt, torch.zeros_like(state.grid), 64)
            row["streamed_share"] = int(counter("cuda")[0]) / row["slots"]
            row["block_balance"] = block_balance(balance("cuda").tolist())
            res[label] = row
        out[name] = res
        del eng, state
        torch.cuda.empty_cache()
    return out


def span4_states(reps: int) -> dict:
    """K1's span-4 variant on ``chip_smoke.py``'s span-4 states and on the
    same with every 4th live tile spread over its arena: ms and wide tiles."""
    out = {}
    for key, name, steps, model_idx, kw, stirred in (
            ("fc_sphere25m", "sphere25m", 61, 0, dict(rebucket_auto=False), False),
            ("jf_multimat", "multimat", 21, 1, {}, True),
            ("sd_sand", "sand", 21, 0, {}, True),
            ("nc_nacc", "nacc", 21, 0, {}, True)):
        _, cfg, mats, state = engine(name, steps, stirred, rebucket_every=4, **kw)
        mat = mats[model_idx]
        spread = spread_tiles(cfg, state, model_idx=model_idx)
        out[key] = {"ms": k1_ms(cfg, mat, state, reps, model_idx=model_idx),
                    "wide": k1_wide(cfg, mat, state, model_idx),
                    "spread_ms": k1_ms(cfg, mat, spread, reps, model_idx=model_idx),
                    "spread_wide": k1_wide(cfg, mat, spread, model_idx)}
        del state, spread
        torch.cuda.empty_cache()
    return out


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
        out[name] = {"ms": median_ms(lambda: kernel(x, s), reps * 2, warmup=1, batch=10),
                     "gather_ms": median_ms(lambda: torch.gather(x, 2, index), reps * 2,
                                            warmup=1, batch=10)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("prof_k1", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--substeps", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cells", action="store_true",
                    help="only K1 on the benchmark's cells' states (cell_states)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_k1: no CUDA device is available", file=sys.stderr)
        return 2
    import claymore_tpu_torch
    from claymore_tpu_torch.utils.timers import device_label

    res = {"package": os.path.dirname(os.path.abspath(claymore_tpu_torch.__file__)),
           "device": device_label("cuda")}
    t0 = time.perf_counter()
    res["cells"] = cell_states(args.reps)
    if args.cells:
        res["wall_s"] = time.perf_counter() - t0
        print("PROFK1", json.dumps(res), flush=True)
        return 0
    eng, cfg, mats, state = engine("sphere25m", 1)
    mat = mats[0]
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
        _, cfg, mats, state = engine(name, steps, stirred)
        res[key] = k1_ms(cfg, mats[0], state, args.reps)
        del state
        torch.cuda.empty_cache()
    res["span4"] = span4_states(args.reps)
    res.update(lane_probe_ms(args.reps))
    res["wall_s"] = time.perf_counter() - t0
    print("PROFK1", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
