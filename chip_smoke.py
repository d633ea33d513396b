"""Smoke run of the PyTorch/CUDA port (claymore_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``claymore_tpu_torch/csrc``, holds each against
its plain PyTorch version on the card (the collider grid kernels also on
pools where every row crosses a collider surface, and their per-row cull
against its plain twin), and drives the port's main paths through
``MPMEngine`` with their invariants checked:

* the ~25M-particle FixedCorotated sphere of ``bench.py --scene=sphere25m``
  and the ``run()`` entry point on the 1M-particle cube;
* the 12.1M-particle JFluid dam break of ``bench.py --scene=dambreak12m``,
  whose drift-triggered rebuilds fire every few substeps;
* the bench-size ``sand``, ``nacc``, ``multimat`` and ``dambreak_hs``
  scenes (Sand, NACC, three materials in one pool, a frictional half-space
  ramp resolved inside the grid kernel);
* ``dambreak_sdf``, 4.3M JFluid particles against ``bench.py``'s 128^3 SDF
  dome, driven until the fluid has reached the dome (the SDF collider is
  sampled inside the grid kernel);
* the CLI, ``python -m claymore_tpu_torch -f scenes/dambreak.json``, and the
  CLI on a scene built from SDF assets it writes itself (an ``.obj`` turned
  into an ``.sdf`` model, an ``sdf`` and an ``sdf_file`` collider) with a
  checkpoint after every frame and a resume from the first; that model also
  seeded with ``"sampling": "poisson"`` (the g++-built sample elimination);
* the rebucket schedules: sphere25m at span 4 (``rebucket_every=4``, fixed
  cadence and drift-triggered) beside span 2; K1's span-4 variant of every
  material against its plain version, on each span-4 state and on the same
  with every 4th live tile spread over its arena (tiles wider than the
  kernel's P2G window, counted by the kernel); dambreak12m and dambreak_sdf with
  the incremental rebucket (``defrag_every=4``), and the incremental plan
  on the card against the CPU, bit for bit;
* several devices through ``MultiChipEngine`` with every shard on the card
  (``multi_paths``): sphere25m on a 2x2 mesh (overlap on and off) and
  dambreak12m on 4 x-slabs, each held to ``MPMEngine`` on the same
  substeps, with a CUDA-event stage breakdown; a mesh of one on the cube;
  the CLI on ``scenes/cube_4dev.json`` with a resume; ``validate_scale``;
  and ``DistGroup`` over NCCL where two cards are visible, and the 2x2
  sphere with one shard per card where four are (with fewer, a line says
  each did not run).  K1 is also held to its plain version on the tile ranges of
  the boundary/interior split;
* config 5, ``scenes/sphere_100m_8dev.json`` (``config5_paths``): its shard
  (``prof_multichip --config5shard``, 12.5M particles, K1 held to its
  plain version there), the 99.6M-particle scene on one device (its file
  less the ``device`` block, through ``load_scene``) with every invariant,
  its peak and the frame written by the native and the numpy writers,
  sync and async; the scene on its 4x2 mesh with every shard on the card,
  held to the one-device run by pid over every particle, with K1 held to
  its plain version on its fullest shard; and the CLI on
  the one-device file for one frame, both frames through the native
  writer and read back.

The rebucket kernels (``csrc/rebucket.cu``: the home-block keys, the
segment heads, the tile plan, the placement) are held against their plain
twins bit for bit (``check_rebucket_kernel``) on the sphere25m final state
as it is, with every tile's slots permuted, with every slot shuffled and
in half its tiles (particles dropped), on dambreak12m's and dambreak_sdf's
final states and on shard 0 of the 2x2 sphere with its region; every path
counts their launches (the init's sort and each full rebuild).

The partition kernels (``csrc/partition.cu``: the first-k compaction
``first_marked``, the oct flags, the remap, ``finalize_tiles``) are held
against their plain twins bit for bit (``check_partition_kernel``) on the
stale rebuild of the sphere25m final state, of its span-4 state, of
dambreak12m's, dambreak_sdf's and config 5's one-device final states and of
shard 0 of the 2x2 sphere with its halo mask, and on the sphere25m tiles
rebuilt into half the octs they need (overflow); ``first_marked`` also on
42.9M-flag masks into 262,144 indices, fewer and more marked than that
(``check_first_marked``).  Every path counts their launches: each rebuild
(the init's, each substep's on a mesh) and each compaction of a migration.

The halo kernels (``csrc/halo.cu``: the halo pack of every direction of a
shard, the halo mass mask, the halo add, the migration pack) are held
against their plain twins (``parallel/halo.py``) bit for bit
(``check_halo_kernel``) on the sphere25m 2x2 final state (every shard; and
with a halo capacity of 64 and a migration capacity of 256 that both
overflow) and on config 5's 4x2 final state (its fullest shard and an
empty one); every mesh path with a neighbour counts their launches
(sphere25m 2x2 runs past its first drift rebuild, so that its shards pack
their crossers).

It also holds the probes P1-P6 (the kernels of the profiling scripts)
against their plain versions at the TPU scripts' inputs and drives the
profiling path: ``prof_laneops``, ``prof_dma`` (each printing its launches),
``prof_stages25m`` and ``prof_rebuild`` as subprocesses, ``MPMEngine.profile_stages``
on the sphere25m state, ``run(..., auto_grow=True)`` regrowing a tight
sphere25m engine against an ample one, and ``update_material`` on the
cube.  It runs the benchmark entry point as a user does,
``python -m claymore_tpu_torch.scripts.bench`` on sphere25m with its
kernel-vs-oracle gate and ``--scene=dambreak_sdf --nogate``, checks each
JSON line and folds the launches each printed into K1's and K2's entries
(``launches_bench``).

Every phase raises on failure (the two incremental-rebucket paths at the
end of the run, after the kernels line).  The line before the last is a JSON object
with one entry per kernel (its launches on its main path, its error
against its plain version, its time, the plain version's time, the time of
one library call doing the same where there is one, and its bound on this
card); the last line is ``{"ok": true, "device": {...}}``.
Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from claymore_tpu_torch.utils.bounds import bound, dma_bound, g2p2g_bound, grid_bound

SEED = 0
DEVICE = "cuda"
SDF_STEPS = 1749          # dambreak_sdf: + 1 warm-up = 1750 substeps
PEAK_BOUND = 80e9         # bytes of device memory a path may peak at: one card
REBUCKET_KERNELS = ("rebucket_keys", "rebucket_heads", "rebucket_plan", "rebucket_place")
PARTITION_KERNELS = ("first_marked", "oct_mask", "remap", "finalize_tiles")
HALO_KERNELS = ("halo_pack", "halo_mask", "halo_add", "migrate_pack")


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def gpu_facts() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 2, batch: int = 1) -> float:
    """Median milliseconds of ``fn()`` on the device: each of ``reps``
    samples times ``batch`` back-to-back calls with CUDA events
    (``utils.timers.device_ms``) and divides by ``batch``.  A batch keeps a
    short kernel's host-side launch work off the device's clock."""
    from claymore_tpu_torch.utils.timers import device_ms

    def run():
        for _ in range(batch):
            fn()

    for _ in range(warmup):
        fn()
    return float(np.median([device_ms(run, DEVICE) for _ in range(reps)])) / batch


# --------------------------------------------------------------------------
# bounds: the least time an H100 SXM could take for a kernel's work
# (claymore_tpu_torch/utils/bounds.py holds K1's and K2's and the peaks)
# --------------------------------------------------------------------------

def laneop_bound(name: str, tiles: int) -> dict:
    """P1-P4's bound on ``tiles`` tiles: the lanes each probe reads and
    writes, once, and the shifts (``probe_kernels.laneop_bytes``); P4 does
    one multiplication per lane of its first window and one addition per
    lane of its second, the others move values only."""
    from claymore_tpu_torch.ops import probe_kernels as pk

    ops = tiles * 16 * 48 if name == "dyn_lane_write" else 0
    return bound(pk.laneop_bytes(name, tiles), ops)


# --------------------------------------------------------------------------
# kernel checks (also used by tests/test_torch_kernels_cuda.py)
# --------------------------------------------------------------------------

def check_grid_kernel(cfg, n_active: int, time_it: bool = True) -> dict:
    """K2 against core.grid.grid_update on the card: mass rows bit-equal,
    velocities within rtol 1e-5 / atol 1e-7 (FMA contraction), max |v|^2
    within 1e-6 relative, and a NaN momentum giving inf in both."""
    from claymore_tpu_torch.core import grid
    from claymore_tpu_torch.ops import grid_kernel
    from claymore_tpu_torch.scripts import prof_k2

    part, pool = prof_k2.grid_inputs(cfg, n_active)
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
        out.update(grid_bound(cfg, pool, part))
        out.update(grid_info("grid_update"))
    return out


def grid_info(name: str, num_colliders: int = 3) -> dict:
    """Registers and blocks per SM of a grid kernel variant (kernel_info)."""
    from claymore_tpu_torch.ops import grid_kernel

    info = grid_kernel.kernel_info(name, num_colliders)
    return {"registers": info["registers"], "blocks_per_sm": info["blocks_per_sm"]}


def check_g2p2g_kernel(cfg, mat, state, tile_chunk: int, time_it: bool = True,
                       reps: int = 20, model_idx: int = 0,
                       time_plain: bool = True, plain_reps: int = 0,
                       tile_split: int = None) -> dict:
    """K1 (the variant of ``mat``) against core.transfer.g2p2g_model on the
    card, from one grid update of ``state``: the grids (the pools' live
    rows) within 1e-5 x the largest grid value (float atomics reorder the
    sums), identical active
    sets, positions of the same particle within 2e-6, and every field (F,
    J, logJp) within 1e-5 x max(1, its largest value), but for the few
    NACC particles its discontinuous return map sends to another branch
    (see below); and the margin K1 returns equal, bit for bit, to
    ``arena_margin`` of its output.  The kernel is the variant of the
    state's arena span (``cfg.arena_span``); ``plain_reps`` > 0 times the
    plain version that many calls with no warm-up (the span-4 plain version
    takes seconds a call).  ``tile_split`` bt: the kernel and the plain
    version each run on the tile range [0, bt), then [bt, T) into the same
    outputs, as the multi-device transfer split does, with the margin the
    minimum of the two.  At span 4 it also reads the kernel's count of wide
    tiles (transferred in more than one P2G pass), which must equal
    ``prof_k1.wide_tiles`` of the kernel's output (``wide_tiles``,
    ``live_tiles``).  The kernel streams each tile's occupied prefix
    (``g2p2g_kernel.occupied_slots`` of the input): its count of streamed
    slots must equal their sum over the range (``streamed_slots`` of
    ``slots``), and every output slot past a prefix must read inactive, pid
    S."""
    from claymore_tpu_torch.core import grid, partition, transfer
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel
    from claymore_tpu_torch.scripts import prof_k1

    pool_v, mvs = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt)
    next_dt = grid.compute_dt(cfg, mvs, state.t + state.dt,
                              torch.tensor(1e9, device=DEVICE))
    table, model = state.partition.table, state.models[model_idx]

    nt = model.tiles.tvalid.shape[0]
    ranges = [None] if tile_split is None else [(0, tile_split), (tile_split, nt)]

    def kernel(acc):
        out, margin = None, None
        for r in ranges:
            out, acc, m = g2p2g_kernel.g2p2g(cfg, mat, pool_v, table, model, state.dt,
                                             next_dt, acc, tile_chunk, r, out)
            margin = m if margin is None else torch.minimum(margin, m)
        return out, acc, margin

    def plain(acc):
        out = None
        for r in ranges:
            out, acc = transfer.g2p2g_model(cfg, mat, pool_v, table, model, state.dt,
                                            next_dt, acc, tile_chunk, r, out)
        return out, acc

    span4 = cfg.arena_span == 4
    if span4:
        g2p2g_kernel.wide_tile_counter(DEVICE).zero_()
    g2p2g_kernel.streamed_slot_counter(DEVICE).zero_()
    mk, pk, margin = kernel(torch.zeros_like(state.grid))
    streamed = int(g2p2g_kernel.streamed_slot_counter(DEVICE)[0])
    mt, pt = plain(torch.zeros_like(state.grid))
    torch.cuda.synchronize()
    prefix = g2p2g_kernel.occupied_slots(cfg, model)
    if streamed != int(prefix.sum()):
        raise AssertionError(f"g2p2g kernel: {streamed} slots streamed, the occupied "
                             f"prefixes hold {int(prefix.sum())}")
    past = (torch.arange(cfg.particle_tile, device=DEVICE)[None, :] >= prefix[:, None]).reshape(-1)
    s_cap = model.pos.shape[1]
    if bool(mk.active[past].any()) or bool((mk.pid[past] != s_cap).any()):
        raise AssertionError("g2p2g kernel: a slot past its tile's occupied prefix is "
                             "active or keeps its pid")
    wide = {}
    if span4:
        # dx_inv is a power of two, so the kernel's stencil bases are
        # base_cell's exactly, and so are the two counts
        n_wide, n_live = prof_k1.wide_tiles(cfg, mk)
        wide = {"wide_tiles": int(g2p2g_kernel.wide_tile_counter(DEVICE)[0]),
                "live_tiles": n_live}
        if wide["wide_tiles"] != n_wide:
            raise AssertionError(f"g2p2g kernel: {wide['wide_tiles']} wide tiles counted, "
                                 f"{n_wide} in its output")
    want = partition.arena_margin(cfg, mk)
    if not torch.equal(margin, want):
        raise AssertionError(f"g2p2g kernel: fused margin {float(margin)!r} vs "
                             f"arena_margin {float(want)!r}")
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
    # both pools hold the rows of one partition, so its live rows, compared
    # row for row, are the dense grids' cells (pool_to_dense would make
    # 34 GB of dense float64 at domain_bits 10)
    count = int(state.partition.count[0])
    grid_err = float((pk[:count].double() - pt[:count].double()).abs().max())
    grid_max = float(pt[:count].abs().max())
    if float(pk[cfg.null_oct].abs().sum()) != 0.0:
        raise AssertionError("g2p2g kernel: null row not zero")
    if not (pos_err <= 2e-6 and grid_err <= 1e-5 * grid_max):
        raise AssertionError(f"g2p2g kernel: pos {pos_err} grid "
                             f"{grid_err} (max {grid_max})")
    if float((mk.pos[:, act] - model.pos[:, act]).abs().max()) == 0.0:
        raise AssertionError("g2p2g kernel: particles did not move")
    out = {"max_abs_err": grid_err, "grid_max": grid_max, "pos_err": pos_err,
           "field_err": field_err, "flipped": flipped, "active": n_act,
           "margin": float(margin), "streamed_slots": streamed, "slots": s_cap, **wide}
    if time_it:
        # into one pool that keeps adding up: its contents do not change the
        # work, and a zeroing pass would add 0.5 GB of stores to the time
        acc = torch.zeros_like(state.grid)
        out["ms"] = cuda_ms(lambda: kernel(acc), reps=reps)
        if time_plain:
            out["plain_ms"] = cuda_ms(lambda: plain(acc),
                                      reps=plain_reps or max(3, reps // 4),
                                      warmup=0 if plain_reps else 1)
        out.update(g2p2g_bound(cfg, mat, state, model_idx))
        out.update(g2p2g_kernel.kernel_info(mat, cfg.particle_tile, cfg.arena_span))
    return out


def check_wide(cfg, mat, state, facts: str, label: str, model_idx: int = 0) -> dict:
    """K1's span-4 variant against its plain version (``check_g2p2g_kernel``,
    the kernel timed, the plain version not) on ``state`` with every 4th
    live tile's particles spread over its arena (``prof_k1.spread_tiles``):
    tiles wider than the kernel's P2G window, which it must count (> 0) and
    transfer exactly as the plain version does."""
    from claymore_tpu_torch.scripts import prof_k1

    spread = prof_k1.spread_tiles(cfg, state, model_idx=model_idx)
    out = check_g2p2g_kernel(cfg, mat, spread, tile_chunk=64, reps=10, model_idx=model_idx,
                             time_plain=False)
    if out["wide_tiles"] <= 0:
        raise AssertionError(f"{label}, spread: no wide tile counted")
    log(f"{label}, every 4th live tile spread over its arena: {out['wide_tiles']} of "
        f"{out['live_tiles']} tiles wide, max_abs_err {out['max_abs_err']:.3e}, pos_err "
        f"{out['pos_err']:.3e}, field_err {out['field_err']}, flipped {out['flipped']}, "
        f"kernel {out['ms']:.4f} ms, bound {out['bound_ms']:.4f} ms | {facts}")
    return out


def check_incremental_plan(cfg, model) -> dict:
    """``incremental_plan`` of ``model`` on the card against the same call on
    a CPU copy: every output bit for bit (it only moves data, so a sort
    that is not stable or a scatter order that differs would show).
    Returns the movers, the deferred and the card's milliseconds."""
    from claymore_tpu_torch.core import partition as part
    from claymore_tpu_torch.utils.timers import device_ms

    tk = part.tile_block_keys(cfg, model.tiles)
    cpu = dataclasses.replace(
        model, pos=model.pos.cpu(), fields={k: v.cpu() for k, v in model.fields.items()},
        active=model.active.cpu(), pid=model.pid.cpu(), tiles=None)
    out = {}
    ms = device_ms(lambda: out.update(card=part.incremental_plan(cfg, model, tk)), DEVICE)
    m2, tk2, d2 = out["card"]
    c2, ctk2, cd2 = part.incremental_plan(cfg, cpu, tk.cpu())
    pairs = [("pos", m2.pos, c2.pos), ("active", m2.active, c2.active),
             ("pid", m2.pid, c2.pid), ("tile_keys", tk2, ctk2), ("deferred", d2, cd2)]
    pairs += [(k, m2.fields[k], c2.fields[k]) for k in model.fields]
    for name, a, b in pairs:
        # by bits: the slots it leaves inactive keep what they held, NaN too
        if not _same(a.cpu(), b):
            raise AssertionError(f"incremental_plan on the card differs from the CPU in {name}")
    key = part.flatten_key(cfg, part.home_block(cfg, model.pos))
    movers = int((model.active & (key != tk.repeat_interleave(cfg.particle_tile))).sum())
    return {"movers": movers, "deferred": int(d2[0]), "ms": ms,
            "slots": int(model.pos.shape[1]), "active": int(model.active.sum())}


def _same(a, b) -> bool:
    """Bit for bit: same dtype, shape and bits (floats compared as int32)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def shuffle_slots(model, seed: int = SEED, keep_slots: int = None):
    """``model`` with every slot moved by one seeded permutation of all
    slots (the worst order for the rebucket's gathers); with
    ``keep_slots``, only the first ``keep_slots`` of the shuffled slots (a
    capacity the particles may overflow)."""
    s_cap = model.pos.shape[1]
    idx = torch.from_numpy(np.random.default_rng(seed).permutation(s_cap)).to(model.pos.device)
    if keep_slots is not None:
        idx = idx[:keep_slots]

    def take(x):
        return x[..., idx].contiguous()

    return dataclasses.replace(model, pos=take(model.pos), active=take(model.active),
                               pid=take(model.pid), tiles=None,
                               fields={k: take(v) for k, v in model.fields.items()})


def check_rebucket_kernel(cfg, model, label: str, facts: str, region_fn=None,
                          reps: int = 10, plain_reps: int = 3) -> dict:
    """The rebucket kernels (``ops/rebucket_kernel.py``) against their plain
    twins (``core/partition.py``) on ``model``, bit for bit, each on the
    same inputs: the keys (``home_keys``), the heads (``segment_heads``),
    the plan (``segment_bases`` and ``tile_windows``) and the placement
    (``place``), then the whole ``sort_permute`` against the plain version.
    Times (CUDA events, median of ``reps``; the plain ones of
    ``plain_reps``): the keys and the sort, the sort alone, each kernel,
    the whole and the plain version, beside ``rebucket_bound``.  Not
    counted."""
    from claymore_tpu_torch.core import partition as part
    from claymore_tpu_torch.ops import rebucket_kernel as rk
    from claymore_tpu_torch.utils.bounds import rebucket_bound

    s_cap = model.pos.shape[1]
    nt = s_cap // cfg.particle_tile
    errs = {}

    def expect(name, a, b):
        if not _same(a, b):
            raise AssertionError(f"rebucket kernel {label}: {name} differs from the plain twin")
        errs[name] = _abs_err(a, b)

    expect("home_keys", rk.home_keys(cfg, model), part.home_keys(cfg, model))
    skey, perm, region = rk.sort_keys(cfg, model, region_fn)
    skey_p, perm_p, _ = part.sort_keys(cfg, model, region_fn)
    expect("sorted keys", skey, skey_p)
    expect("sort index", perm, perm_p)
    del skey_p, perm_p
    off, sentinel = part.region_offsets(cfg, region)

    seg_start, meta = rk.launch_heads(cfg, skey, region)
    heads = part.segment_heads(skey, sentinel)
    g = heads.shape[0] - 1
    expect("seg_start", seg_start[:g + 1], heads)
    expect("meta", meta, torch.tensor([g, int(heads[-1])], dtype=torch.int32, device=DEVICE))
    dstart, dlen, tile_keys, dropped, base = rk.launch_plan(cfg, skey, seg_start, meta, nt,
                                                            region)
    base_p = part.segment_bases(cfg, skey, heads)
    plan_p = part.tile_windows(cfg, skey, heads, base_p, nt, region)
    expect("base", base[:g], base_p)
    for name, a, b in zip(("dstart", "dlen", "tile_keys", "dropped"),
                          (dstart, dlen, tile_keys, dropped), plan_p):
        expect(name, a, b)
    out = rk.place(cfg, model, perm, dstart, dlen)
    ref = part.place(cfg, model, perm, plan_p[0], plan_p[1])
    for name in ("pos", "active", "pid"):
        expect("place." + name, getattr(out, name), getattr(ref, name))
    for k in model.fields:
        expect("place." + k, out.fields[k], ref.fields[k])
    del out, ref
    whole = rk.sort_permute(cfg, model, nt, region_fn)
    plain = part.sort_permute(cfg, model, nt, region_fn)
    for name, a, b in (("pos", whole[0].pos, plain[0].pos), ("pid", whole[0].pid, plain[0].pid),
                       ("active", whole[0].active, plain[0].active),
                       ("tile_keys", whole[1], plain[1]), ("dropped", whole[2], plain[2]),
                       *((k, whole[0].fields[k], plain[0].fields[k]) for k in model.fields)):
        expect("sort_permute." + name, a, b)
    n_act = int(heads[-1])
    n_dropped = int(whole[2][0])
    del whole, plain
    src = part.region_source(cfg, rk.home_keys(cfg, model), region_fn)
    ms = {
        "keys+sort": cuda_ms(lambda: rk.sort_keys(cfg, model, region_fn), reps=reps),
        "sort": cuda_ms(lambda: torch.sort(src, stable=True), reps=reps),
        "keys": cuda_ms(lambda: rk.home_keys(cfg, model), reps=reps),
        "heads": cuda_ms(lambda: rk.launch_heads(cfg, skey, region), reps=reps),
        "plan": cuda_ms(lambda: rk.launch_plan(cfg, skey, seg_start, meta, nt, region),
                        reps=reps),
        "place": cuda_ms(lambda: rk.place(cfg, model, perm, dstart, dlen), reps=reps),
        "sort_permute": cuda_ms(lambda: rk.sort_permute(cfg, model, nt, region_fn), reps=reps),
    }
    plain = {
        "keys": lambda: part.home_keys(cfg, model),
        "heads": lambda: part.segment_heads(skey, sentinel),
        "plan": lambda: part.tile_windows(cfg, skey, heads, part.segment_bases(cfg, skey, heads),
                                          nt, region),
        "place": lambda: part.place(cfg, model, perm, dstart, dlen),
        "sort_permute": lambda: part.sort_permute(cfg, model, nt, region_fn),
    }
    plain_ms = {k: cuda_ms(f, reps=plain_reps) for k, f in plain.items()}
    del src
    channels = 3 + sum(v.numel() // s_cap for v in model.fields.values()) + 1
    b = rebucket_bound(cfg, s_cap, channels, active=n_act, segments=g)
    beyond = ms["sort_permute"] - ms["sort"]
    res = {"label": label, "slots": s_cap, "active": n_act, "segments": g, "tiles": nt,
           "dropped": n_dropped, "region": region, "max_abs_err": max(errs.values()),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
           "sort_bound_ms": b["sort"]["bound_ms"], "beyond_sort_ms": beyond,
           "share": b["bound_ms"] / beyond if beyond > 0 else None,
           "stages": {k: {"ms": ms[k], "plain_ms": plain_ms[k],
                          "bound_ms": b["stages"][k]["bound_ms"],
                          "share": b["stages"][k]["bound_ms"] / ms[k]}
                      for k in ("keys", "heads", "plan", "place")}}
    share = "n/a" if res["share"] is None else f"{res['share']:.1%}"
    log(f"rebucket kernels vs plain twins, {label}: {s_cap} slots, {n_act} active, {g} "
        f"segments, dropped {n_dropped}: every output equal bit for bit; ms (median of "
        f"{reps}) keys+sort {ms['keys+sort']:.4f}, sort {ms['sort']:.4f} (bound "
        f"{b['sort']['bound_ms']:.4f}), keys {ms['keys']:.4f}, heads {ms['heads']:.4f}, plan "
        f"{ms['plan']:.4f}, place {ms['place']:.4f}, sort_permute {ms['sort_permute']:.4f}; "
        f"plain twins keys {plain_ms['keys']:.4f}, heads "
        f"{plain_ms['heads']:.4f}, plan {plain_ms['plan']:.4f}, place "
        f"{plain_ms['place']:.4f}, sort_permute {plain_ms['sort_permute']:.4f}; bound beyond "
        f"the sort {b['bound_ms']:.4f} ms ({b['bound_by']}) against {beyond:.4f}: {share}; "
        f"stage bounds and shares " + ", ".join(
            f"{k} {v['bound_ms']:.4f} ({v['share']:.1%})" for k, v in res["stages"].items())
        + f" | {facts}")
    return res


def _bits_err(a, b) -> float:
    """Largest absolute difference of two tensors equal bit for bit (NaNs
    in the same places count 0)."""
    if not a.numel():
        return 0.0
    return float(torch.nan_to_num((a.double() - b.double()).abs(), nan=0.0).max())


def rebuild_inputs(cfg, state):
    """The stale rebuild's inputs of ``state``: its pool, its partition and
    every model's tile block keys (what a mesh shard rebuilds from on every
    substep, ``engine.rebucket(..., stale=True)``)."""
    from claymore_tpu_torch.core import partition as part

    return (state.grid, state.partition,
            tuple(part.tile_block_keys(cfg, m.tiles) for m in state.models))


def check_partition_kernel(cfg, pool, partition, tile_keys, label: str, facts: str,
                           extra_mask=None, reps: int = 10, plain_reps: int = 3,
                           time_it: bool = True) -> dict:
    """The partition kernels (``ops/partition_kernel.py``) against their
    plain twins (``core/partition.py``) on one rebuild's inputs, bit for
    bit, each on the same inputs: the oct flags (``oct_flags``), the
    compaction of the flags (``_first_marked``), the remap (``remap``: the
    table, keys, count, overflow and every pool row), the whole rebuild
    (``rebuild``) and every model's ``finalize_tiles``.  Times (CUDA
    events, median of ``reps``; the plain ones of ``plain_reps``): each
    kernel, its twin, ``rebuild`` + ``finalize_tiles`` both ways, and
    ``torch.nonzero(flags)[:nb]`` as the compaction's library call (it
    synchronises: its time holds the host's round trip), beside
    ``partition_bound``.  Not counted."""
    from claymore_tpu_torch.core import partition as part
    from claymore_tpu_torch.ops import partition_kernel as pk
    from claymore_tpu_torch.utils.bounds import first_marked_bound, partition_bound

    no, nb = cfg.num_oct_keys, cfg.max_active_octs
    errs = {}

    def expect(name, a, b):
        if not _same(a, b):
            raise AssertionError(f"partition kernel {label}: {name} differs from the plain twin")
        errs[name] = _bits_err(a, b)

    flags = pk.oct_mask(cfg, pool, partition, tile_keys, extra_mask)
    expect("oct_mask", flags, part.oct_flags(cfg, pool, partition, tile_keys, extra_mask))
    idx, total = pk.first_marked(flags, nb, no)
    expect("first_marked", idx, part._first_marked(flags, nb, no))
    expect("first_marked total", total, flags.sum(dtype=torch.int32).reshape(1))
    newp, newpool = pk.remap(cfg, pool, partition, flags)
    refp, refpool = part.remap(cfg, pool, partition, flags)
    for f in ("table", "keys", "count", "overflow"):
        expect("remap." + f, getattr(newp, f), getattr(refp, f))
    expect("remap.pool", newpool, refpool)
    del newpool, refpool
    wp, wpool = pk.rebuild(cfg, pool, partition, tile_keys, extra_mask)
    pp, ppool = part.rebuild(cfg, pool, partition, tile_keys, extra_mask)
    for f in ("table", "keys", "count", "overflow"):
        expect("rebuild." + f, getattr(wp, f), getattr(pp, f))
    expect("rebuild.pool", wpool, ppool)
    del wpool, ppool
    dropped = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
    for i, tk in enumerate(tile_keys):
        t, r = pk.finalize_tiles(cfg, newp, tk, dropped), part.finalize_tiles(cfg, refp, tk, dropped)
        for f in ("block", "bcoord", "tvalid"):
            expect(f"finalize_tiles[{i}].{f}", getattr(t, f), getattr(r, f))
    n_tiles = sum(int(tk.shape[0]) for tk in tile_keys)
    res = {"label": label, "oct_keys": no, "capacity": nb, "live_rows": int(partition.count[0]),
           "tiles": n_tiles, "extra_mask": extra_mask is not None,
           "flagged": int(total[0]), "octs": int(newp.count[0]),
           "overflow": int(newp.overflow[0]), "max_abs_err": max(errs.values())}
    if not time_it:
        return res

    def kernels():
        p2, _ = pk.rebuild(cfg, pool, partition, tile_keys, extra_mask)
        return [pk.finalize_tiles(cfg, p2, tk, dropped) for tk in tile_keys]

    def plain():
        p2, _ = part.rebuild(cfg, pool, partition, tile_keys, extra_mask)
        return [part.finalize_tiles(cfg, p2, tk, dropped) for tk in tile_keys]

    ms = {"first_marked": cuda_ms(lambda: pk.first_marked(flags, nb, no), reps=reps),
          "oct_mask": cuda_ms(lambda: pk.oct_mask(cfg, pool, partition, tile_keys, extra_mask),
                              reps=reps),
          "remap": cuda_ms(lambda: pk.remap(cfg, pool, partition, flags), reps=reps),
          "finalize_tiles": cuda_ms(lambda: [pk.finalize_tiles(cfg, newp, tk, dropped)
                                             for tk in tile_keys], reps=reps),
          "rebuild+finalize": cuda_ms(kernels, reps=reps)}
    plain_ms = {
        "first_marked": cuda_ms(lambda: part._first_marked(flags, nb, no), reps=plain_reps),
        "oct_mask": cuda_ms(lambda: part.oct_flags(cfg, pool, partition, tile_keys, extra_mask),
                            reps=plain_reps),
        "remap": cuda_ms(lambda: part.remap(cfg, pool, partition, flags), reps=plain_reps),
        "finalize_tiles": cuda_ms(lambda: [part.finalize_tiles(cfg, refp, tk, dropped)
                                           for tk in tile_keys], reps=plain_reps),
        "rebuild+finalize": cuda_ms(plain, reps=plain_reps)}
    library_ms = cuda_ms(lambda: torch.nonzero(flags)[:nb], reps=reps)
    b = partition_bound(cfg, res["live_rows"], n_tiles, extra_mask is not None, res["octs"])
    bounds = {"first_marked": first_marked_bound(no, nb)["bound_ms"],
              **{k: v["bound_ms"] for k, v in b["stages"].items()},
              "rebuild+finalize": b["bound_ms"]}
    res.update(ms=ms, plain_ms=plain_ms, bound_ms=bounds, library_ms=library_ms,
               share={k: bounds[k] / ms[k] for k in ms})
    log(f"partition kernels vs plain twins, {label}: {no} oct keys, {res['live_rows']} live "
        f"rows, {n_tiles} tiles, halo mask {res['extra_mask']}, {res['flagged']} octs flagged, "
        f"{res['octs']} kept, overflow {res['overflow']}: every output equal bit for bit; "
        f"ms (median of {reps}) " + ", ".join(
            f"{k} {ms[k]:.4f} (plain {plain_ms[k]:.4f}, bound {bounds[k]:.4f}, "
            f"{res['share'][k]:.1%})" for k in ms)
        + f"; torch.nonzero(flags)[:nb] {library_ms:.4f} (synchronises) | {facts}")
    return res


def check_first_marked(n: int, size: int, facts: str, reps: int = 10) -> dict:
    """``first_marked`` at a mesh shard's migration shape, ``n`` flags into
    ``size`` indices, against its plain twin bit for bit on three seeded
    masks: fewer marked than ``size`` (the crossers of a substep), more
    (the total past the capacity), and holes before a long marked suffix
    (``_place``'s free slots).  Kernel, twin and ``torch.nonzero(mark)[:size]``
    times (CUDA events; nonzero synchronises) beside
    ``first_marked_bound``.  Not counted."""
    from claymore_tpu_torch.core import partition as part
    from claymore_tpu_torch.ops import partition_kernel as pk
    from claymore_tpu_torch.utils.bounds import first_marked_bound

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    u = torch.rand((n,), generator=gen, device=DEVICE)
    iota = torch.arange(n, device=DEVICE)
    masks = {"below": u < 0.5 * size / n, "above": u < 4.0 * size / n,
             "suffix": (u < 0.002) | (iota >= n - size // 2)}
    del iota
    out = {}
    for name, mark in masks.items():
        idx, total = pk.first_marked(mark, size, n)
        want = part._first_marked(mark, size, n)
        if not (_same(idx, want) and int(total[0]) == int(mark.sum())):
            raise AssertionError(f"first_marked {name}: differs from the plain twin")
        err = _bits_err(idx, want)
        del want
        r = {"n": n, "size": size, "marked": int(total[0]), "max_abs_err": err,
             "ms": cuda_ms(lambda: pk.first_marked(mark, size, n), reps=reps),
             "plain_ms": cuda_ms(lambda: part._first_marked(mark, size, n), reps=3),
             "library_ms": cuda_ms(lambda: torch.nonzero(mark)[:size], reps=reps),
             "bound_ms": first_marked_bound(n, size)["bound_ms"]}
        r["share"] = r["bound_ms"] / r["ms"]
        out[name] = r
        log(f"first_marked vs plain twin, {n} flags, size {size}, {name}: {r['marked']} "
            f"marked, equal bit for bit; kernel {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
            f"{r['share']:.1%}), plain {r['plain_ms']:.4f}, torch.nonzero {r['library_ms']:.4f} "
            f"(synchronises) | {facts}")
    return out


def check_halo_kernel(comm, pools, partitions, models, label: str, facts: str, shards=None,
                      targets=None, narrow: int = 0, reps: int = 10, plain_reps: int = 3,
                      time_it: bool = True) -> dict:
    """The halo kernels (``ops/halo_kernel.py``) against their plain twins
    (``parallel/halo.py``) bit for bit, on one mesh state held by ``comm``'s
    group (every shard's pool, partition and first model): for each shard
    in ``shards`` (default all) its packs of every direction (as a dense
    group ships them: keys, mass bits, rows by bits, the overflow); what the
    exchange (the kernels) delivers to it, through the mass mask and the add
    (into ``targets[j]``'s (pool, table), by default its own pool and
    table, on clones); its migration pack along each live axis (``narrow``
    blocks inside each slab face, so that particles well inside the slab
    cross: payloads by bits, active, dropped).  Times (CUDA events, median
    of ``reps``; the twins of ``plain_reps``) on the first shard of
    ``shards``: each kernel, its twin, and for the add ``index_add_`` of one
    received direction (the library call), beside ``halo_bound`` /
    ``migrate_bound``.  Not counted."""
    from claymore_tpu_torch.ops import halo_kernel as hk
    from claymore_tpu_torch.parallel import halo
    from claymore_tpu_torch.utils.bounds import halo_bound, migrate_bound

    cfg, h, m = comm.cfg, comm.halo_capacity, comm.margin
    no = cfg.num_oct_keys
    shards = list(range(len(pools))) if shards is None else list(shards)
    dirs = comm._directions()
    errs = {}

    def expect(name, a, b):
        if not _same(a, b):
            raise AssertionError(f"halo kernel {label}: {name} differs from the plain twin")
        errs[name] = _bits_err(a, b)

    res = {"label": label, "halo_capacity": h, "migration_capacity": comm.mig_cap,
           "shards": shards, "overflow": {}, "packed_octs": {}, "dropped": {}, "crossers": {}}
    received, _ = comm.exchange_halo(pools, partitions)
    comm.wait_halo()
    for j in shards:
        pt, win = partitions[j], comm._windows(comm.shards[j])
        args = (cfg, pools[j], pt.keys, pt.count, win, [True] * len(dirs), h, m)
        kp, ko = hk.pack_windows(*args)
        tp, to = halo.pack_windows(*args)
        expect(f"pack[{j}].overflow", ko, to)
        for d, ((km, kr), (tm, tr)) in enumerate(zip(kp, tp)):
            expect(f"pack[{j}][{d}].meta", km, tm)
            expect(f"pack[{j}][{d}].rows", kr, tr)
        res["overflow"][j] = int(ko[0])
        res["packed_octs"][j] = sum(int((km[0] < no).sum()) for km, _ in kp)
        del kp, tp
        rv = received[j]
        if rv:
            expect(f"mask[{j}]", hk.mass_mask(cfg, rv), halo.mass_mask(cfg, rv))
            pool, table = targets[j] if targets is not None else (pools[j], pt.table)
            expect(f"add[{j}]", hk.add_rows(cfg, pool.clone(), table, rv),
                   halo.add_rows(cfg, pool.clone(), table, rv))
        mj = models[j]
        for a in comm.live_axes:
            dim = comm.axes[a][1]
            lo, hi = comm._bounds(comm.shards[j], a)
            margs = (cfg, mj, dim, lo + narrow, hi - narrow, comm.mig_cap)
            kl, kr, ka, kd = hk.migrate_pack(*margs)
            tl, tr, ta, td = halo.migrate_pack(*margs)
            for name, x, y in (("left", kl, tl), ("right", kr, tr), ("active", ka, ta),
                               ("dropped", kd, td)):
                expect(f"migrate[{j}][{a}].{name}", x, y)
            res["dropped"][f"{j}/{a}"] = int(kd[0])
            res["crossers"][f"{j}/{a}"] = int(mj.active.sum() - ka.sum())
            del kl, kr, tl, tr
    res["max_abs_err"] = max(errs.values())
    if not time_it:
        return res
    j = shards[0]
    pt, win, rv, mj = partitions[j], comm._windows(comm.shards[j]), received[j], models[j]
    pool, table = targets[j] if targets is not None else (pools[j], pt.table)
    packed = [comm._target(comm.shards[j], d) is not None for d in dirs]
    args = (cfg, pools[j], pt.keys, pt.count, win, packed, h, m)
    a0 = comm.live_axes[0]
    lo, hi = comm._bounds(comm.shards[j], a0)
    margs = (cfg, mj, comm.axes[a0][1], lo + narrow, hi - narrow, comm.mig_cap)
    add_k, add_t = pool.clone(), pool.clone()
    slots = torch.where(rv[0][0] < no, table[torch.clamp(rv[0][0], max=no).long()],
                        cfg.null_oct).long()
    fns = {"halo_pack": (lambda: hk.pack_windows(*args), lambda: halo.pack_windows(*args)),
           "halo_mask": (lambda: hk.mass_mask(cfg, rv), lambda: halo.mass_mask(cfg, rv)),
           "halo_add": (lambda: hk.add_rows(cfg, add_k, table, rv),
                        lambda: halo.add_rows(cfg, add_t, table, rv)),
           "migrate_pack": (lambda: hk.migrate_pack(*margs), lambda: halo.migrate_pack(*margs))}
    ms = {k: cuda_ms(f, reps=reps) for k, (f, _) in fns.items()}
    plain_ms = {k: cuda_ms(f, reps=plain_reps) for k, (_, f) in fns.items()}
    library_ms = cuda_ms(lambda: add_t.index_add_(0, slots, rv[0][2]), reps=reps)
    hits = sum(int(((k < no) & (table[torch.clamp(k, max=no).long()] != cfg.null_oct)).sum())
               for k, _, _ in rv)
    plan, _ = halo.window_marks(cfg, pt.keys, pt.count, win, h, m)
    octs = sum(min(int(c.sum()), h) for c, p in zip(plan, packed) if p)
    b = halo_bound(cfg, h, sum(packed), octs, len(rv), hits)
    b["migrate_pack"] = migrate_bound(mj.pos.shape[1], halo.payload_channels(mj), comm.mig_cap)
    bounds = {k: v["bound_ms"] for k, v in b.items()}
    del add_k, add_t
    res.update(timed_shard=j, ms=ms, plain_ms=plain_ms, library_ms={"halo_add": library_ms},
               bound_ms=bounds, share={k: bounds[k] / ms[k] for k in ms},
               timed={"packed_windows": sum(packed), "packed_octs": octs,
                      "received_directions": len(rv), "add_hits": hits,
                      "slots": mj.pos.shape[1]})
    log(f"halo kernels vs plain twins, {label}: halo capacity {h}, migration capacity "
        f"{comm.mig_cap}, shards {shards}: overflow {res['overflow']}, packed octs "
        f"{res['packed_octs']}, crossers {res['crossers']}, dropped {res['dropped']}: every "
        f"output equal bit for bit; shard {j} ({res['timed']}), ms (median of {reps}) "
        + ", ".join(f"{k} {ms[k]:.4f} (plain {plain_ms[k]:.4f}, bound {bounds[k]:.4f}, "
                    f"{res['share'][k]:.1%})" for k in ms)
        + f"; index_add_ of one received direction {library_ms:.4f} | {facts}")
    return res


def k1_order_sensitivity(cfg, mat, state, as_is: dict, facts: str) -> dict:
    """K1 on ``state`` in three slot orders: as it is (``as_is``, the result
    of ``check_g2p2g_kernel`` on it), every tile's slots permuted by a
    seeded permutation, and every tile's slots sorted by stencil base.  Each
    reordered copy is held against the plain version as
    ``check_g2p2g_kernel`` does; the times and their max / min ratio."""
    from claymore_tpu_torch.scripts.prof_k1 import permute_tiles

    times = {"as_is": as_is["ms"]}
    for order in ("permuted", "sorted"):
        r = check_g2p2g_kernel(cfg, mat, permute_tiles(cfg, state, order), tile_chunk=64,
                               reps=10, time_plain=False)
        times[order] = r["ms"]
        log(f"K1 {mat.name}, sphere25m state, slots {order}: grid err "
            f"{r['max_abs_err']:.3e}, pos {r['pos_err']:.3e}, kernel {r['ms']:.4f} ms "
            f"| {facts}")
    ratio = max(times.values()) / min(times.values())
    log(f"K1 {mat.name} slot-order sensitivity: {times}, max/min {ratio:.4f} | {facts}")
    return {"ms": times, "ratio": ratio}


def check_fused_margin(eng, state, shard: int = None) -> list:
    """One grid update and every model's K1 from ``state`` with ``eng``'s
    materials and colliders (not counted): each margin K1 returns equal,
    bit for bit, to ``arena_margin`` of its output.  Returns the margins.
    ``shard``: ``state`` is that shard's state of a ``MultiChipEngine``."""
    from claymore_tpu_torch.core import grid, partition
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    cfg = eng.cfg
    tables = ((eng._collider_table, eng._sdf_pointers) if shard is None
              else (eng._collider_tables[shard], eng._sdf_pointers[shard]))
    pool_v, mvs = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt,
                                          eng.colliders, state.t, *tables)
    next_dt = grid.compute_dt(cfg, mvs, state.t + state.dt, torch.tensor(1e9, device=DEVICE))
    acc = torch.zeros_like(state.grid)
    margins = []
    for mat, model in zip(eng.materials, state.models):
        new, acc, margin = g2p2g_kernel.g2p2g(cfg, mat, pool_v, state.partition.table,
                                              model, state.dt, next_dt, acc, eng.tile_chunk)
        want = partition.arena_margin(cfg, new)
        if not torch.equal(margin, want):
            raise AssertionError(f"fused margin {float(margin)!r} vs arena_margin "
                                 f"{float(want)!r}")
        margins.append(float(margin))
    return margins


def collider_pool(cfg, n_active: int, colliders, straddle: bool):
    """(partition, pool, crossed).  The check pool (``n_active`` random
    octs; ``crossed`` None) or, with ``straddle``, the straddle pool: the
    octs whose cells lie on both sides of one of ``colliders``' surfaces,
    repeated to fill every row (``prof_k2.straddle_octs``), and per row the
    index in ``colliders`` of the surface it crosses, which may never be
    culled there."""
    from claymore_tpu_torch.scripts import prof_k2

    if not straddle:
        return (*prof_k2.grid_inputs(cfg, n_active), None)
    octs, crossed = prof_k2.straddle_octs(cfg, colliders)
    if len(octs) == 0:
        raise AssertionError("no oct straddles the colliders' surfaces")
    rows = cfg.max_active_octs
    return (*prof_k2.grid_inputs(cfg, octs=prof_k2.fill(octs, rows), seed=SEED + 1),
            np.resize(crossed, rows))


def check_collider_kernel(cfg, part, pool, cols, t: float, label: str, baseline=(),
                          time_it: bool = True, plain_reps: int = 5, crossed=None) -> dict:
    """K2-AC or K2-SDF (by ``cols``) against core.grid.grid_update on the
    card, at collider time ``t``: mass rows bit-equal, velocities within
    rtol 1e-5 / atol 1e-7 (sinf/cosf/sqrtf may round apart from PyTorch's
    by an ulp; everything else is the same IEEE operations in the same
    order), max |v|^2 within 1e-6 relative, the colliders changed cells
    (against the grid update with ``baseline`` only), the kernel's cull
    decision per (row, collider) equal to ``grid_kernel.collider_row_mask``,
    and, where ``crossed`` gives per row the index in ``cols`` of a surface
    the row crosses, that collider kept on every such row."""
    from claymore_tpu_torch.core import grid
    from claymore_tpu_torch.ops import grid_kernel

    table = grid_kernel.pack_colliders(cols, DEVICE)
    ptrs = grid_kernel.sdf_table_pointers(cols, DEVICE)
    dt = torch.tensor(3e-4, dtype=torch.float32, device=DEVICE)
    tt = torch.tensor(t, dtype=torch.float32, device=DEVICE)
    mask = torch.zeros((pool.shape[0], len(cols)), dtype=torch.bool, device=DEVICE)

    def kernel(row_mask=None):
        return grid_kernel.grid_update(cfg, pool, part, dt, cols, tt, table, ptrs,
                                       row_mask)

    kv, km = kernel(mask)
    pv, pm = grid.grid_update(cfg, pool, part, dt, cols, tt)
    base, _ = grid.grid_update(cfg, pool, part, dt, baseline, tt)
    twin = grid_kernel.collider_row_mask(cfg, part, cols, tt)
    torch.cuda.synchronize()
    if not torch.equal(kv[:, 0:4], pv[:, 0:4]):
        raise AssertionError(f"{label}: mass rows differ")
    torch.testing.assert_close(kv[:, 4:16], pv[:, 4:16], rtol=1e-5, atol=1e-7)
    km, pm = float(km), float(pm)
    if not (pm > 0.0 and abs(km - pm) <= 1e-6 * pm):
        raise AssertionError(f"{label}: max|v|^2 {km} vs {pm}")
    hit = int((pv[:, 4:16] != base[:, 4:16]).sum())
    if hit == 0:
        raise AssertionError(f"{label}: no cell met a collider")
    differ = int((mask != twin).sum())
    if differ:
        raise AssertionError(f"{label}: the kernel's cull differs from collider_row_mask "
                             f"in {differ} of {mask.numel()} (row, collider) pairs")
    if crossed is not None:
        rows = torch.arange(len(crossed), device=DEVICE)
        lost = int((~mask[rows, torch.from_numpy(crossed).to(DEVICE)]).sum())
        if lost:
            raise AssertionError(f"{label}: {lost} rows culled the collider whose surface "
                                 f"they cross")
    out = {"max_abs_err": float((kv - pv).abs().max()), "cells_changed": hit,
           "culled_share": 1.0 - float(mask.float().mean()),
           "culled_by_collider": [round(1.0 - float(c), 4)
                                  for c in mask.float().mean(dim=0)]}
    if time_it:
        out["ms"] = cuda_ms(kernel)
        out["plain_ms"] = cuda_ms(lambda: grid.grid_update(cfg, pool, part, dt, cols, tt),
                                  reps=plain_reps, warmup=1)
        out.update(grid_bound(cfg, pool, part, cols, t))
        out.update(grid_info(grid_kernel_name(cols), len(cols)))
    return out


def check_grid_colliders_kernel(cfg, n_active: int, t: float = 0.37,
                                time_it: bool = True, straddle: bool = False) -> dict:
    """K2-AC with the three analytic colliders of tests/test_pallas_grid.py
    on the check pool or its straddle pool (``check_collider_kernel``)."""
    from claymore_tpu_torch.scripts import prof_k2

    cols = prof_k2.pallas_colliders()
    part, pool, crossed = collider_pool(cfg, n_active, cols, straddle)
    return check_collider_kernel(cfg, part, pool, cols, t, "grid collider kernel",
                                 time_it=time_it, crossed=crossed)


def check_grid_sdf_kernel(cfg, n_active: int, t: float = 0.37,
                          time_it: bool = True, straddle: bool = False) -> dict:
    """K2-SDF with the static dome, a half-space and the animated spinner on
    the check pool or the straddle pool of the two SDF colliders
    (``check_collider_kernel``; the SDF colliders must change cells beside
    the half-space)."""
    from claymore_tpu_torch.scripts import prof_k2

    cols = prof_k2.sdf_colliders()
    part, pool, crossed = collider_pool(cfg, n_active, (cols[0], cols[2]), straddle)
    if crossed is not None:
        crossed = np.array([0, 2])[crossed]        # into cols
    return check_collider_kernel(cfg, part, pool, cols, t, "grid SDF kernel",
                                 baseline=cols[1:2], time_it=time_it, plain_reps=3,
                                 crossed=crossed)


# --------------------------------------------------------------------------
# the probes P1-P6 (scripts/prof_laneops.py, scripts/prof_dma.py)
# --------------------------------------------------------------------------

# probe: (lanes of its input rows, largest shift, the TPU probe's pallas_call)
LANEOPS = {
    "dyn_roll": (128, 127, "scripts/prof_laneops.py:33"),
    "dyn_lane_read": (128, 96, "scripts/prof_laneops.py:48"),
    "dyn_lane_read_wide": (384, 240, "scripts/prof_laneops.py:66"),
    "dyn_lane_write": (128, 80, "scripts/prof_laneops.py:83"),
}
PROBE_TILES = 65536
LANE_BATCH = 10                  # P1-P4 and their plain and library calls are
                                 # timed 10 back to back (0.1-0.4 ms each)
DMA_BATCH = 10                   # P5/P6's ``ms_batch10``: a call enqueues up
                                 # to three kernels and scratch
DMA_ROWS = 65536                 # the TPU script's pool, 0.5 GiB
# scripts/prof_dma.py:266-278 and :284: (G, D, R) without and with the
# double buffer, and of the RMW
P5_CONFIGS = {False: [(8192, 4, 9), (8192, 8, 1), (2048, 4, 9), (8192, 4, 3)],
              True: [(8192, 4, 9), (8192, 8, 1), (8192, 4, 3), (5120, 16, 1)]}
P6_CONFIGS = [(4096, 4, 9), (4096, 4, 3)]
P5_CALL = "scripts/prof_dma.py:89"
P6_CALL = "scripts/prof_dma.py:221"


def library_laneop_ms(name: str, x, s):
    """One ``torch.gather`` with a precomputed lane index doing P1-P3's
    work on ``x``; None for P4 (no one call writes two windows)."""
    if name == "dyn_lane_write":
        return None
    j = torch.arange(128 if name == "dyn_roll" else 32, device=x.device)
    if name == "dyn_roll":
        lanes = (j[None, :] + s.long()[:, None]) % 128
    else:
        lanes = s.long()[:, None] + (112 if name == "dyn_lane_read_wide" else 0) + j
    index = lanes[:, None, :].expand(-1, 16, -1)
    return cuda_ms(lambda: torch.gather(x, 2, index), batch=LANE_BATCH)


def check_laneops(tiles: int = PROBE_TILES, time_it: bool = True,
                  names=tuple(LANEOPS)) -> dict:
    """P1-P4 against their plain versions on the card, bit for bit (the
    kernels move values; P4 doubles and adds to 0 as the plain version
    does): at G = 1 on the TPU script's tile and shift 48, and on ``tiles``
    random tiles with shifts drawn from SEED over each probe's range; P1
    also on negative and large shifts, the others give NaN for a tile whose
    shift leaves the window.  Then the kernel's, the plain version's and
    the library call's times and the bound."""
    from claymore_tpu_torch.ops import probe_kernels as pk

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s48 = torch.tensor([48], dtype=torch.int32, device=dev)
    out = {}
    for name in names:
        lanes, smax, _ = LANEOPS[name]
        kernel, plain = getattr(pk, name), getattr(pk, "plain_" + name)
        x1 = torch.arange(16 * lanes, dtype=torch.float32, device=dev).reshape(1, 16, lanes)
        if not torch.equal(kernel(x1, s48), plain(x1, s48)):
            raise AssertionError(f"{name}: kernel differs from plain on the TPU script's tile")
        x = torch.randn((tiles, 16, lanes), generator=gen, device=dev)
        s = torch.from_numpy(rng.integers(0, smax + 1, size=tiles).astype(np.int32)).to(dev)
        k, p = kernel(x, s), plain(x, s)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"{name}: kernel differs from plain at G={tiles}: "
                                 f"max {float((k - p).abs().max())}")
        edge = torch.tensor([-5, 300] if name == "dyn_roll" else [smax, smax + 1],
                            dtype=torch.int32, device=dev)
        ke = kernel(x[:2], edge)
        if name == "dyn_roll":
            ok = torch.equal(ke, plain(x[:2], edge))
        else:
            ok = torch.equal(ke[0], plain(x[:1], edge[:1])[0]) and bool(ke[1].isnan().all())
        if not ok:
            raise AssertionError(f"{name}: wrong result at the shifts {edge.tolist()}")
        res = {"max_abs_err": float((k - p).abs().max()), "tiles": tiles}
        if time_it:
            res["ms"] = cuda_ms(lambda: kernel(x, s), batch=LANE_BATCH)
            res["plain_ms"] = cuda_ms(lambda: plain(x, s), batch=LANE_BATCH)
            res["library_ms"] = library_laneop_ms(name, x, s)
            res.update(laneop_bound(name, tiles))
            if name in ("dyn_lane_read", "dyn_lane_read_wide"):
                res.update(pk.laneop_info(name))
        out[name] = res
        del x, s, k, p
    return out


def _starts(starts, runs: int):
    return torch.from_numpy(np.asarray(starts, np.int32)).to(DEVICE).view(-1, runs)


def p6_pool(rows: int, zero: bool = True):
    """P6's pool on the card: zeros (the TPU script's), or 2**24 with 0.1 in
    every odd lane, where adding 1.0 once per covering program and adding
    the count once round differently."""
    pool = torch.zeros((rows, 16, 128), dtype=torch.float32, device=DEVICE)
    if not zero:
        pool.fill_(2.0 ** 24)
        pool[..., 1::2] = 0.1
    return pool


def check_dma(time_it: bool = True, rows: int = DMA_ROWS, p5=None, p6=None) -> dict:
    """P5 (both variants, both plans) at the TPU script's eight
    configurations and P6 at its two, on the script's inputs (the pool
    ``arange(O * 2048)`` in float32, O = 65,536, so the sums round past
    2**24; the starts from ``default_rng(0)``), against their plain versions
    on the card, bit for bit: P5's kernels and plain version add the same
    rows in the same order (d, then r; the two-pass plan's window sums are
    the plain version's ``part``), and the variants and plans agree; P6 adds
    1.0 once per covering program, as the plain version, on the zero pool
    and on the 2**24/0.1 pool.  Then times (the kernel's by the plan
    ``gather_plan`` picks and by the other plan, the plain version's, the
    library call's: ``embedding_bag(mode="sum")`` for P5, ``index_add_`` of
    ones made beforehand for P6; one call per pair of CUDA events, and the
    kernel also DMA_BATCH calls back to back), payload GB/s, the bytes each
    call moves (``probe_kernels.dma_bytes``) and bounds.  ``rows``, ``p5`` and ``p6``
    replace the pool size and the configurations for a smaller check."""
    import torch.nn.functional as F

    from claymore_tpu_torch.ops import probe_kernels as pk
    from claymore_tpu_torch.scripts import prof_dma

    dev = torch.device(DEVICE)
    o = rows
    pool = torch.arange(o * 2048, dtype=torch.float32, device=dev).reshape(o, 16, 128)
    flat = pool.view(o, 2048)
    out = {"dma_gather": [], "dma_gather_ring": [], "rmw": []}
    for ring, configs in (P5_CONFIGS if p5 is None else p5).items():
        name = "dma_gather_ring" if ring else "dma_gather"
        for g, d, r in configs:
            idx = _starts(prof_dma.gather_starts(o, g, d, r), d)
            plan = pk.gather_plan(o, g, d, r)
            plans = pk.PLANS if 2 <= r <= pk.MAX_WINDOW_ROWS else ("direct",)
            p = pk.plain_dma_gather(pool, idx, r)
            err = 0.0
            for pl in plans:
                for rg in (ring, not ring):
                    k = pk._launch_gather(pool, idx, r, rg, pl)
                    torch.cuda.synchronize()
                    if not torch.equal(k, p):
                        raise AssertionError(
                            f"{name} {(g, d, r)}: the {'ring' if rg else 'register'} "
                            f"variant's {pl} plan differs from plain by "
                            f"{float((k - p).abs().max())}")
                    err = max(err, float((k - p).abs().max()))
                    del k
            res = {"config": [g, d, r], "plan": plan, "plans_checked": list(plans),
                   "max_abs_err": err,
                   "moved_bytes": pk.dma_bytes("dma_gather", pool, idx, r, plan)}
            if time_it:
                rows_ = (idx.long()[..., None] + torch.arange(r, device=dev)).reshape(g, d * r)
                res["ms"] = cuda_ms(lambda: pk.dma_gather(pool, idx, r, ring=ring))
                res["ms_batch10"] = cuda_ms(lambda: pk.dma_gather(pool, idx, r, ring=ring),
                                            batch=DMA_BATCH)
                if len(plans) > 1:
                    other = plans[1 - plans.index(plan)]
                    res["other_plan"] = other
                    res["other_plan_ms"] = cuda_ms(
                        lambda: pk._launch_gather(pool, idx, r, ring, other))
                res["plain_ms"] = cuda_ms(lambda: pk.plain_dma_gather(pool, idx, r),
                                          reps=5, warmup=1)
                res["library_ms"] = cuda_ms(lambda: F.embedding_bag(rows_, flat, mode="sum"))
                res["payload_gbs"] = g * d * r * 8192 / res["ms"] / 1e6
                res.update(dma_bound(idx, r))
            out[name].append(res)
            del p
    for g, d, r in P6_CONFIGS if p6 is None else p6:
        idx = _starts(prof_dma.rmw_starts(o, g, d, r), d)
        err = 0.0
        for zero in (True, False):
            pk_pool, pp_pool = p6_pool(o, zero), p6_pool(o, zero)
            ko, po = pk.rmw(pk_pool, idx, r), pk.plain_rmw(pp_pool, idx, r)
            torch.cuda.synchronize()
            if not (torch.equal(pk_pool, pp_pool) and torch.equal(ko, po)):
                raise AssertionError(
                    f"rmw {(g, d, r)} on the {'zero' if zero else '2**24/0.1'} pool: kernel "
                    f"differs from plain by {float((pk_pool - pp_pool).abs().max())}")
            err = max(err, float((pk_pool - pp_pool).abs().max()))
            if zero:
                max_count = float(pk_pool.max())
            del pk_pool, pp_pool, ko, po
        pk_pool, pp_pool = p6_pool(o), p6_pool(o)
        res = {"config": [g, d, r], "max_abs_err": err, "max_count": max_count,
               "pools_checked": ["zero", "2**24/0.1"],
               "moved_bytes": pk.dma_bytes("rmw", pk_pool, idx, r)}
        if time_it:
            rows_ = (idx.long()[..., None] + torch.arange(r, device=dev)).reshape(-1)
            ones = torch.ones((rows_.numel(), 2048), dtype=torch.float32, device=dev)
            kflat = pk_pool.view(o, 2048)
            res["ms"] = cuda_ms(lambda: pk.rmw(pk_pool, idx, r))
            res["ms_batch10"] = cuda_ms(lambda: pk.rmw(pk_pool, idx, r), batch=DMA_BATCH)
            res["plain_ms"] = cuda_ms(lambda: pk.plain_rmw(pp_pool, idx, r), reps=5, warmup=1)
            res["library_ms"] = cuda_ms(lambda: kflat.index_add_(0, rows_, ones))
            res["payload_gbs"] = 2 * g * d * r * 8192 / res["ms"] / 1e6
            res.update(dma_bound(idx, r, rmw=True))
            del ones
        out["rmw"].append(res)
        del pk_pool, pp_pool
    return out


def run_entry(module: str, *args: str, timeout: int = 600) -> str:
    """``python -m claymore_tpu_torch.scripts.<module>`` in a subprocess on
    the card; raises unless it exits 0; returns its standard output."""
    root = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-m", f"claymore_tpu_torch.scripts.{module}", *args],
        cwd=root, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    return proc.stdout


def entry_launches(module: str, out: str) -> dict:
    """The ``launches {...}`` line an entry point prints last: the kernel
    launches of its run, counted by its process's wrappers from 0."""
    lines = [ln for ln in out.splitlines() if ln.startswith("launches ")]
    if len(lines) != 1:
        raise AssertionError(f"{module}: no launches line:\n{out}")
    return json.loads(lines[0].split(" ", 1)[1])


def check_probe_entry_points(facts: str) -> dict:
    """The probe path: ``prof_laneops`` (at its 65,536 tiles) and
    ``prof_dma`` (at its configurations) as a user runs them, in
    subprocesses: exit 0, the TPU script's ``OK sum=`` line of each lane
    probe with the plain version's sum, a timed line per lane probe and
    every section of prof_dma.  Returns the launches each printed, per
    probe kernel."""
    from claymore_tpu_torch.ops import probe_kernels as pk

    t0 = time.perf_counter()
    lane_out = run_entry("prof_laneops")
    s48 = torch.tensor([48], dtype=torch.int32)
    for name, (lanes, _, _) in LANEOPS.items():
        x = torch.arange(16 * lanes, dtype=torch.float32).reshape(1, 16, lanes)
        want = f"OK   sum={float(getattr(pk, 'plain_' + name)(x, s48).double().sum()):.1f}"
        if not any(want in ln for ln in lane_out.splitlines()):
            raise AssertionError(f"prof_laneops: no '{want}' line:\n{lane_out}")
        if f"{name} G={PROBE_TILES}:" not in lane_out:
            raise AssertionError(f"prof_laneops: no timed line of {name}:\n{lane_out}")
    dma_out = run_entry("prof_dma")
    timed = [ln for ln in dma_out.splitlines() if " ms " in ln]
    if dma_out.count("== ") != 7 or len(timed) != 23:
        raise AssertionError(f"prof_dma: {len(timed)} timed lines:\n{dma_out}")
    wall = time.perf_counter() - t0
    lane_n, dma_n = entry_launches("prof_laneops", lane_out), entry_launches("prof_dma", dma_out)
    launches = {k: lane_n[k] if k.startswith("dyn_") else dma_n[k] for k in pk.launches}
    log(f"probe path, entry points prof_laneops and prof_dma: exit 0 in {wall:.1f} s, "
        f"4 OK lines with the plain versions' sums, {len(timed)} timed prof_dma lines, "
        f"launches {launches} | {facts}")
    return {"wall_s": wall, "launches": launches}


def check_prof_stages_entry(facts: str) -> dict:
    """``prof_stages25m`` as a subprocess at full width: exit 0, the
    sphere25m's particle count, the five stages finite and the particle
    stream floor positive."""
    t0 = time.perf_counter()
    out = run_entry("prof_stages25m", timeout=900)
    wall = time.perf_counter() - t0
    lines = {ln.split()[1]: ln for ln in out.splitlines() if ln.startswith("PROF25M")}
    stages = json.loads(lines["stages"].split(" ", 2)[2].rsplit(" |", 1)[0])
    floor = float(lines["particle_stream_floor_ms"].split()[2])
    if ("particles: 25088753" not in lines["particles:"]
            or set(stages) != {"grid_update", "g2p2g", "rebuild", "substep", "overhead"}
            or not all(np.isfinite(v) for v in stages.values()) or not floor > 0.0):
        raise AssertionError(f"prof_stages25m output:\n{out}")
    log(f"entry point prof_stages25m: exit 0 in {wall:.1f} s\n"
        + "\n".join(lines.values()) + f"\n| {facts}")
    return {"wall_s": wall, "stages_ms": stages, "particle_stream_floor_ms": floor}


def check_prof_rebuild_entry(facts: str) -> dict:
    """``prof_rebuild`` as a subprocess on the 1M cube: exit 0, one JSON
    line with the JAX script's three stages, each finite and positive."""
    t0 = time.perf_counter()
    out = run_entry("prof_rebuild")
    wall = time.perf_counter() - t0
    res = json.loads(out.strip().splitlines()[-1])
    stages = ("sort", "sort_permute", "table_rebuild+remap")
    if res.get("particles") != 1061208 or not all(
            np.isfinite(res[k]) and res[k] > 0.0 for k in stages):
        raise AssertionError(f"prof_rebuild output:\n{out}")
    log(f"entry point prof_rebuild: exit 0 in {wall:.1f} s: {json.dumps(res)} | {facts}")
    return {"wall_s": wall, **res}


# the benchmark entry point's runs: (scene, arguments, particles, K2, K1)
BENCH_RUNS = (("sphere25m", (), 25088753, "grid_update", "g2p2g_fixed_corotated"),
              ("dambreak_sdf", ("--scene=dambreak_sdf", "--nogate"), 4286550,
               "grid_update_sdf", "g2p2g_jfluid"))


def check_bench_entry(facts: str) -> dict:
    """``python -m claymore_tpu_torch.scripts.bench`` as a user runs it, in
    subprocesses: the default sphere25m with its gate, then dambreak_sdf
    with ``--nogate`` (K2-SDF launched from the entry point).  Each must
    exit 0 and end with its JSON line: every particle active, none dropped,
    no overflow, particles moving, mass within 1e-5, the roofline share in
    (0, 1.05], ``validate_ok`` true where the gate ran (its artifact's
    pairs are logged) and its scene's K2 and K1 launched once a substep.
    Returns each run's record, launches and wall seconds."""
    from claymore_tpu_torch.scripts import bench

    out = {}
    t_phase = time.perf_counter()
    for scene_name, args, n, k2, k1 in BENCH_RUNS:
        t0 = time.perf_counter()
        text = run_entry("bench", *args, timeout=900)
        wall = time.perf_counter() - t0
        rec = json.loads(text.strip().splitlines()[-1])
        launches = entry_launches("bench", text)
        gated = not args
        substeps = 1 + 4 * rec["steps"]
        checks = {
            "particles": rec["particles"] == rec["active_particles"] == n,
            "dropped": rec["dropped_tiles"] == 0,
            "overflow": rec["block_overflow"] == 0,
            "moves": rec["moves"] is True,
            "mass": rec["mass_rel_err"] < 1e-5,
            "validate_ok": rec["validate_ok"] is (True if gated else None),
            "roofline_share": 0.0 < rec["roofline_share"] <= 1.05,
            "backend": rec["backend"] == rec["grid_backend"] == "cuda",
            "launches": launches[k2] == launches[k1] == substeps,
        }
        log(f"entry point bench --scene={scene_name}: exit 0 in {wall:.1f} s, "
            f"launches {launches}: {json.dumps(rec)} | {facts}")
        out[scene_name] = {"wall_s": wall, "record": rec, "launches": launches}
        if gated:
            art = json.loads(bench.default_validate_out().read_text())
            pairs = {k: v for k, v in art.items() if isinstance(v, dict) and "ok" in v}
            log(f"bench gate ({art.get('seconds', 0.0):.1f} s, ok {art['ok']}): " + "; ".join(
                f"{k} grid_err {v['grid_err']:.3e}, cloud_err {v['cloud_err']:.3e}, "
                f"mass_vs_analytic {v['mass_vs_analytic']:.3e}, displacement "
                f"{v['displacement']:.3e} / oracle {v['displacement_oracle']:.3e}"
                for k, v in pairs.items()) + f" | {facts}")
            out[scene_name]["gate"] = art
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"bench --scene={scene_name} checks failed: {failed}\n{text}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"benchmark entry point phase: {out['wall_s']:.1f} s | {facts}")
    return out


# --------------------------------------------------------------------------
# scenes (bench.py:35-177)
# --------------------------------------------------------------------------

def scene(name: str):
    """(cfg, materials, positions, velocities, colliders) of a bench.py
    scene as ``scripts/bench.py:build`` gives it, but ``dambreak_sdf`` is
    ``scripts/prof_k2.scene``'s (tile slack 2.5 for its 1,750 substeps);
    ``config5_shard`` is ``scripts/prof_multichip.config5_shard``'s (one
    shard of config 5)."""
    from claymore_tpu_torch.scripts import prof_k2
    from claymore_tpu_torch.scripts.bench import build

    if name == "dambreak_sdf":
        return prof_k2.scene(name)
    if name == "config5_shard":
        from claymore_tpu_torch.scripts import prof_multichip

        cfg, mat, pos, v0 = prof_multichip.config5_shard()
        return cfg, [mat], [pos], [v0], ()
    return build(name, quick=False)


def probe(state, n: int = 4096, model_idx: int = 0) -> np.ndarray:
    """Positions [3, n] of particles 0..n-1 of a model, found by id
    (``scripts/bench.py:probe``); raises if one is not active."""
    from claymore_tpu_torch.scripts import bench

    out = bench.probe(state, n, model_idx)
    if np.isnan(out).any():
        raise AssertionError("probe particles missing")
    return out


def _launch_dicts():
    from claymore_tpu_torch.ops import (g2p2g_kernel, grid_kernel, halo_kernel,
                                        partition_kernel, probe_kernels, rebucket_kernel)

    return (grid_kernel.grid_update.launches, g2p2g_kernel.g2p2g.launches,
            probe_kernels.launches, rebucket_kernel.launches, partition_kernel.launches,
            halo_kernel.launches)


def reset_counts() -> None:
    for counts in _launch_dicts():
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    out = {}
    for counts in _launch_dicts():
        out.update(counts)
    return out


def grid_kernel_name(colliders) -> str:
    """The grid kernel's launch key for a collider list."""
    from claymore_tpu_torch.models.boundary import SignedDistanceCollider

    if any(isinstance(c, SignedDistanceCollider) for c in colliders):
        return "grid_update_sdf"
    return "grid_update_colliders" if colliders else "grid_update"


def drive(name: str, steps: int, facts: str, tile_chunk: int = 64,
          on_step=None, strict: bool = True, warmup: int = 1, **cfg_kw) -> dict:
    """One main path: build the bench scene ``name`` (its configuration
    with ``cfg_kw`` replaced), zero the launch counts, init, ``warmup``
    warm-up substeps and ``steps`` timed substeps (each ended by a synchronise, so
    rebuilding substeps are timed apart), read the counts, and check the
    invariants and K1's fused margin on the final state
    (``check_fused_margin``).  Each timed rebuild is logged with its
    substep, its kind by the step number (full sort or incremental plan,
    ``full_rebuild``), whether an incremental plan fell back to the full
    sort (``engine.last_rebuild``: its plan would have deferred the movers
    logged as ``plan_deferred``), its milliseconds and the movers left
    deferred (``tiles.dropped``, read after the clock), which must be 0.
    ``on_step(i, engine, state)`` runs after timed substep ``i``, outside the timing and the peak memory, and must
    launch no counted kernel.  Returns the metrics, the engine and the
    final state; a failed check raises, or with ``strict=False`` is
    returned as ``failed`` for the caller to fail the run with later."""
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.core.engine import full_rebuild
    from claymore_tpu_torch.ops.g2p2g_kernel import variant_name

    cfg, mats, parts, v0s, cols = scene(name)
    cfg = dataclasses.replace(cfg, **cfg_kw)
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
    for _ in range(warmup):
        state = eng.substep(state, fe)
    torch.cuda.synchronize()
    plain_ms, rebuild_ms, rebuild_log, peak = [], [], [], 0
    for i in range(steps):
        before = eng.rebuilds
        step = warmup + i
        t0 = time.perf_counter()
        state = eng.substep(state, fe)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        (rebuild_ms if eng.rebuilds > before else plain_ms).append(ms)
        if eng.rebuilds > before:
            kind, plan_deferred = eng.last_rebuild
            rebuild_log.append({"step": step, "full": full_rebuild(cfg, step), "kind": kind,
                                "ms": ms, "plan_deferred": plan_deferred,
                                "deferred": [int(m.tiles.dropped[0]) for m in state.models]})
        if on_step is not None:
            # the hook's temporaries stay out of the path's peak memory
            peak = max(peak, torch.cuda.max_memory_allocated())
            on_step(i, eng, state)
            torch.cuda.reset_peak_memory_stats()
    launches = read_counts()
    substeps = warmup + steps
    peak_gib = max(peak, torch.cuda.max_memory_allocated()) / 2**30

    d = eng.diagnostics(state)
    mass = float(state.grid[:-1, 0:4].double().sum())
    expected = sum(p.shape[0] * m.mass for p, m in zip(parts, mats))
    mass_err = abs(mass - expected) / expected
    disp = min(float(np.abs(probe(state, n_probe[i], i) - p0[i]).max())
               for i in range(len(mats)))
    grid_name = grid_kernel_name(cols)
    used = [grid_name] + [variant_name(m, cfg.arena_span) for m in mats]
    margins = check_fused_margin(eng, state)
    checks = {
        "mass": mass_err < 1e-5,
        "null_row": d["null_block_mass"] == 0.0,
        "dropped": all(d[f"model{i}_dropped_tiles"] == 0 for i in range(len(mats))),
        "active": all(d[f"model{i}_active"] == p.shape[0] for i, p in enumerate(parts)),
        "overflow": d["block_overflow"] == 0,
        "finite": bool(np.isfinite(d["t"]) and np.isfinite(float(state.max_vel))),
        "moves": disp > 0.0,
        "launches": (launches[grid_name] == substeps
                     and min(launches[k] for k in used) >= substeps),
        "steps": d["step"] == substeps,
        "deferred": all(max(r["deferred"]) == 0 for r in rebuild_log),
        "rebuild_kind": all((r["kind"] == "full") == r["full"] for r in rebuild_log),
        "peak": peak_gib * 2**30 < PEAK_BOUND,
        # the init's sort of each model and each model's full rebuild (and
        # each incremental plan that fell back) run the rebucket kernels
        "rebucket_launches": (
            len({launches[k] for k in REBUCKET_KERNELS}) == 1
            and launches["rebucket_place"] >= len(mats) * (
                1 + sum(r["kind"] == "full" for r in rebuild_log))),
        # the init's rebuild and every rebuild's, each finalizing every model
        "partition_launches": (
            launches["oct_mask"] == launches["remap"] == 1 + eng.rebuilds
            and launches["finalize_tiles"] == len(mats) * (1 + eng.rebuilds)
            and launches["first_marked"] >= launches["remap"]),
    }
    total_ms = sum(plain_ms) + sum(rebuild_ms)
    full = [r["ms"] for r in rebuild_log if r["full"]]
    inc = [r["ms"] for r in rebuild_log if r["kind"] == "incremental"]
    fell = [r["ms"] for r in rebuild_log if r["kind"] == "fallback"]
    out = {
        "particles": n, "substeps": substeps, "ms_per_substep": total_ms / steps,
        "mpps": n * steps / total_ms / 1e3, "rebuilds": eng.rebuilds,
        "ms_rebuilding": float(np.mean(rebuild_ms)) if rebuild_ms else None,
        "ms_drift_only": float(np.mean(plain_ms)) if plain_ms else None,
        "init_s": init_s, "peak_gib": peak_gib, "mass_rel_err": mass_err,
        "displacement": disp, "launches": {k: launches[k] for k in used},
        "rebucket_launches": {k: launches[k] for k in REBUCKET_KERNELS},
        "partition_launches": {k: launches[k] for k in PARTITION_KERNELS},
        "fused_margins": margins, "arena_span": cfg.arena_span,
        "defrag_every": cfg.defrag_every,
        "rebuilds_full": len(full), "rebuilds_incremental": len(inc),
        "rebuilds_fallback": len(fell),
        "ms_rebuilding_full": float(np.mean(full)) if full else None,
        "ms_rebuilding_incremental": float(np.mean(inc)) if inc else None,
        "ms_rebuilding_fallback": float(np.mean(fell)) if fell else None,
        "plan_deferred_by_rebuild": [r["plan_deferred"] for r in rebuild_log
                                     if not r["full"]],
        "deferred_by_rebuild": [r["deferred"] for r in rebuild_log],
    }
    def r3(x):
        return x if x is None else round(x, 3)

    label = name + "".join(f" {k}={v}" for k, v in cfg_kw.items())
    log(f"main path {label}: {n} particles, {substeps} substeps, "
        f"{out['ms_per_substep']:.3f} ms/substep, {out['mpps']:.2f} M particle-steps/s, "
        f"span {cfg.arena_span}, rebuilds {eng.rebuilds} "
        f"({'auto' if cfg.rebucket_auto else f'every {cfg.rebucket_every}'}; timed: "
        f"{len(full)} full at {r3(out['ms_rebuilding_full'])} ms, {len(inc)} incremental at "
        f"{r3(out['ms_rebuilding_incremental'])} ms, {len(fell)} incremental fallen back to "
        f"the full sort at {r3(out['ms_rebuilding_fallback'])} ms, plan deferrals "
        f"{out['plan_deferred_by_rebuild']}, left deferred by rebuild "
        f"{out['deferred_by_rebuild']}), rebuilding substep "
        f"{out['ms_rebuilding'] if out['ms_rebuilding'] is None else round(out['ms_rebuilding'], 3)} ms, "
        f"drift-only substep {out['ms_drift_only'] if out['ms_drift_only'] is None else round(out['ms_drift_only'], 3)} ms, "
        f"init {init_s:.2f} s, peak {peak_gib:.2f} GiB, mass_rel_err {mass_err:.3e}, "
        f"displacement {disp:.3e}, launches {out['launches']}, rebucket "
        f"{out['rebucket_launches']}, partition {out['partition_launches']}, fused margins "
        f"{margins} == arena_margin | {facts}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        msg = (f"main path {label} checks failed: {failed} ({d}, launches {launches}, "
               f"deferred {out['deferred_by_rebuild']})")
        if strict:
            raise AssertionError(msg)
        log("FAILED " + msg)
    out["failed_checks"] = failed
    return {"metrics": out, "engine": eng, "state": state, "cfg": cfg, "mats": mats,
            "name": name, "failed": failed}


def positions_by_pid(model, n: int) -> np.ndarray:
    """Positions [3, n] of a model's active particles, column = pid, on the
    host."""
    out = torch.empty((3, n), dtype=torch.float32, device=model.pos.device)
    out[:, model.pid[model.active].long()] = model.pos[:, model.active]
    return out.cpu().numpy()


# the regrown run against the ample one, particles paired by id: float
# atomics in K1 reorder sums run to run (tests/test_regrow.py's bound)
REGROW_POS_BOUND = 1e-5
REGROW_FILL = 0.95        # the tight engine's initial oct occupancy


def regrow_path(cfg, mat, pos, v0, facts: str, frames: int = 2) -> dict:
    """tests/test_regrow.py at full width.  The ample engine runs
    ``frames`` frames; a tight engine, whose capacity its initial octs fill
    to REGROW_FILL (above the 0.9 trigger), runs them with
    ``auto_grow=True`` and must regrow at the end of frame 1 without having
    overflowed, then step frame 2 on the regrown engine through K1 and K2
    (counts zeroed before the tight run, read after each frame), keep every
    particle and its mass, and end where the ample run ends, particle by
    particle (new pid k = the k-th active slot at the regrow), within
    REGROW_POS_BOUND."""
    import math

    import claymore_tpu_torch as ct

    n = pos.shape[0]
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=64, device=DEVICE)
    state = eng.init_state([pos], [v0])
    octs0 = int(state.partition.count[0])
    t0 = time.perf_counter()
    state = eng.run(state, frames=frames)
    ample_s = time.perf_counter() - t0
    ample = positions_by_pid(state.models[0], n)
    ample_steps = int(state.step)
    del state, eng
    torch.cuda.empty_cache()

    cap = math.ceil(octs0 / REGROW_FILL)
    tight = dataclasses.replace(cfg, max_active_blocks=cap)
    eng = ct.MPMEngine(tight, [mat], tile_chunk=64, device=DEVICE)
    state = eng.init_state([pos], [v0])
    seen = []
    grow = eng.regrow

    def recording_regrow(st, factor=1.5):
        m = st.models[0]
        seen.append({"octs": int(st.partition.count[0]),
                     "overflow": int(st.partition.overflow[0]),
                     "dropped": int(m.tiles.dropped[0]), "step": int(st.step),
                     "old_pid": m.pid[m.active].cpu().numpy()})
        return grow(st, factor)

    eng.regrow = recording_regrow
    counts = []
    reset_counts()
    t0 = time.perf_counter()
    eng2, state = eng.run(state, frames=frames, auto_grow=True,
                          on_frame=lambda f, st: counts.append(read_counts()))
    tight_s = time.perf_counter() - t0
    d = eng2.diagnostics(state)
    mass_err = abs(float(state.grid[:-1, 0:4].double().sum()) - n * mat.mass) / (n * mat.mass)
    diff = None
    if len(seen) == 1:
        regrown = positions_by_pid(state.models[0], n)
        diff = float(np.abs(regrown - ample[:, seen[0]["old_pid"]]).max())
    frame2 = {k: counts[-1][k] - counts[0][k]
              for k in ("grid_update", "g2p2g_fixed_corotated")}
    checks = {
        "one_regrow_after_frame_1": len(seen) == 1 and eng2 is not eng,
        "grew": eng2.cfg.max_active_blocks > cap,
        "no_overflow_before": (bool(seen) and seen[0]["overflow"] == 0
                               and seen[0]["dropped"] == 0),
        "frame2_launches": min(frame2.values()) > 0,
        "active": d["model0_active"] == n, "dropped": d["model0_dropped_tiles"] == 0,
        "overflow": d["block_overflow"] == 0, "null_row": d["null_block_mass"] == 0.0,
        "mass": mass_err < 1e-5,
        "positions": diff is not None and diff <= REGROW_POS_BOUND,
    }
    at = {k: v for k, v in seen[0].items() if k != "old_pid"} if seen else None
    out = {"particles": n, "octs0": octs0, "tight_blocks": cap,
           "regrown_blocks": eng2.cfg.max_active_blocks, "at_regrow": at,
           "frame2_launches": frame2, "mass_rel_err": mass_err, "pos_diff": diff,
           "steps": d["step"], "ample_steps": ample_steps, "ample_s": ample_s,
           "tight_s": tight_s}
    log(f"regrow sphere25m: {n} particles, ample engine {cfg.max_active_blocks} blocks "
        f"(initial octs {octs0}) {frames} frames in {ample_s:.1f} s; tight engine {cap} "
        f"blocks regrew at {at} to {eng2.cfg.max_active_blocks} blocks, frame 2 on it "
        f"launched {frame2}; {d['step']} substeps (ample {ample_steps}), active "
        f"{d['model0_active']}, dropped {d['model0_dropped_tiles']}, overflow "
        f"{d['block_overflow']}, mass_rel_err {mass_err:.3e}; positions by mapped pid "
        f"vs the ample run: max {diff} (bound {REGROW_POS_BOUND}) | {facts}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"regrow path checks failed: {failed} ({out})")
    return out


def update_material_path(cfg, mat, pos, v0, facts: str, steps: int = 20) -> dict:
    """``update_material`` on the cube: ``steps`` substeps with Young's
    modulus lowered 100x against the unchanged engine from the same state,
    the initial state stirred (``prof_k1.stir``) so that the material deforms from
    the first substep.  F must differ, mass agree with the particles' to
    1e-5 on both, and both runs launch K1-FC every substep (counts zeroed
    before each)."""
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.core.engine import clone_state
    from claymore_tpu_torch.scripts import prof_k1

    eng = ct.MPMEngine(cfg, [mat], tile_chunk=64, device=DEVICE)
    s0 = prof_k1.stir(eng.init_state([pos], [v0]))
    soft = eng.update_material(0, e=mat.e / 100.0)
    fe = np.float32(1e9)
    n = pos.shape[0]
    ends, launches = {}, {}
    for key, e in (("unchanged", eng), ("soft", soft)):
        reset_counts()
        ends[key] = e.run_steps(clone_state(s0), steps, fe)
        launches[key] = read_counts()["g2p2g_fixed_corotated"]
    f = {}
    for key, st in ends.items():
        m = st.models[0]
        buf = torch.empty((9, n), dtype=torch.float32, device=DEVICE)
        buf[:, m.pid[m.active].long()] = m.fields["F"][:, m.active]
        f[key] = buf
    f_diff = float((f["unchanged"] - f["soft"]).abs().max())
    mass = {k: abs(float(st.grid[:-1, 0:4].double().sum()) - n * mat.mass) / (n * mat.mass)
            for k, st in ends.items()}
    log(f"update_material cube: e {mat.e} -> {soft.materials[0].e}, {steps} substeps "
        f"each: max |F_soft - F| by pid {f_diff:.3e}, mass_rel_err {mass}, "
        f"g2p2g_fixed_corotated launches {launches} | {facts}")
    if not (f_diff > 1e-6 and max(mass.values()) < 1e-5
            and min(launches.values()) >= steps):
        raise AssertionError(f"update_material: F diff {f_diff}, mass {mass}, "
                             f"launches {launches}")
    return {"f_diff": f_diff, "mass_rel_err": mass, "launches": launches}


def stage_breakdown(cfg, mats, state, reps: int = 10, tile_chunk: int = 64,
                    colliders=()) -> dict:
    """Median CUDA-event milliseconds of each stage of a substep on
    ``state`` (single model): K2 (with ``colliders``), the CFL step, K1
    (which computes the drift margin in its epilogue), what is left of the
    drift check, the host read of that margin, and the three parts of a
    rebuild (``sort_permute`` as the engine runs it, through the rebucket
    kernels, with its keys and sort alone beside it; ``rebuild`` and
    ``finalize_tiles`` through the partition kernels).  Not counted."""
    from claymore_tpu_torch.core import grid
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel, partition_kernel, rebucket_kernel

    mat, model = mats[0], state.models[0]
    fe = torch.tensor(1e9, device=DEVICE)
    table = grid_kernel.pack_colliders(colliders, DEVICE) if colliders else None
    ptrs = grid_kernel.sdf_table_pointers(colliders, DEVICE)
    pool_v, mvs = grid_kernel.grid_update(cfg, state.grid, state.partition, state.dt,
                                          colliders, state.t, table, ptrs)
    next_dt = grid.compute_dt(cfg, mvs, state.t + state.dt, fe)
    acc = torch.zeros_like(state.grid)
    _, _, margin = g2p2g_kernel.g2p2g(cfg, mat, pool_v, state.partition.table, model,
                                      state.dt, next_dt, acc, tile_chunk)
    nt = model.tiles.block.shape[0]
    pm, tk, dr = rebucket_kernel.sort_permute(cfg, model, nt)
    part, _ = partition_kernel.rebuild(cfg, state.grid, state.partition, (tk,))
    stages = {
        "K2 grid_update": lambda: grid_kernel.grid_update(
            cfg, state.grid, state.partition, state.dt, colliders, state.t, table, ptrs),
        "compute_dt": lambda: grid.compute_dt(cfg, mvs, state.t + state.dt, fe),
        "K1 g2p2g": lambda: g2p2g_kernel.g2p2g(
            cfg, mat, pool_v, state.partition.table, model, state.dt, next_dt,
            acc, tile_chunk),
        "drift check host read": lambda: bool(margin <= 0.0),
        "sort_permute": lambda: rebucket_kernel.sort_permute(cfg, model, nt),
        "sort_permute: keys+sort": lambda: rebucket_kernel.sort_keys(cfg, model),
        "rebuild": lambda: partition_kernel.rebuild(cfg, state.grid, state.partition, (tk,)),
        "finalize_tiles": lambda: partition_kernel.finalize_tiles(cfg, part, tk, dr),
    }
    return {k: cuda_ms(f, reps=reps) for k, f in stages.items()}


def scene_stages(run: dict, facts: str) -> dict:
    """The stage breakdown of a collider scene's final state (``drive``'s
    result), with its collider kernel's bound on that state."""
    cfg, state, cols = run["cfg"], run["state"], run["engine"].colliders
    stages = stage_breakdown(cfg, run["mats"], state, colliders=cols)
    b = grid_bound(cfg, state.grid, state.partition, cols, float(state.t))
    name = grid_kernel_name(cols)
    log(f"{run['name']} stages on its final state (ms, median of 10): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; {name} bound on this state {b['bound_ms']:.4f} ms ({b['bound_by']}), "
        f"{int((state.grid[:, 0:4] > 0.0).sum())} massive cells | {facts}")
    return {"stages_ms": stages, "k2_bound_ms": b["bound_ms"]}


def log_k1(label: str, k1: dict, facts: str) -> None:
    log(f"K1 {label} vs plain: grid err {k1['max_abs_err']:.3e} (max "
        f"{k1['grid_max']:.3e}), pos {k1['pos_err']:.3e}, fields "
        f"{ {k: float(f'{v:.3e}') for k, v in k1['field_err'].items()} } "
        f"(particles over 1e-5 x scale: {k1['flipped']} of {k1['active']}), "
        f"kernel {k1['ms']:.4f} ms, plain "
        + (f"{k1['plain_ms']:.4f} ms" if "plain_ms" in k1 else "not timed") + ", margin "
        f"{k1['margin']!r} == arena_margin, streamed {k1['streamed_slots']} of "
        f"{k1['slots']} slots, {k1['registers']} registers, "
        f"{k1['blocks_per_sm']} blocks/SM"
        + (f", wide tiles {k1['wide_tiles']} of {k1['live_tiles']}" if "wide_tiles" in k1
           else "") + f" | {facts}")


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


def sdf_contact(cfg, state, colliders, plain: bool = False) -> int:
    """Cells with mass whose velocity the colliders change: the grid update
    of ``state`` with and without them (the plain version when ``plain``,
    so that a probe inside a counted run launches no kernel)."""
    from claymore_tpu_torch.core import grid
    from claymore_tpu_torch.ops import grid_kernel

    update = grid.grid_update if plain else grid_kernel.grid_update
    a, _ = update(cfg, state.grid, state.partition, state.dt, colliders, state.t)
    b, _ = update(cfg, state.grid, state.partition, state.dt)
    o1 = a.shape[0]
    changed = (a[:, 4:16] != b[:, 4:16]).reshape(o1, 3, 4, 128).any(dim=1)
    return int((changed & (state.grid[:, 0:4] > 0.0)).sum())


# the CLI phase's resumed frame against the uninterrupted one, particles
# paired by id: K1 sums with float atomics, so two runs on the card differ
# in the last bits and the difference grows over a frame (417 substeps)
RESUME_POS_BOUND = 1e-5


def write_sdf_assets(out: Path, fps: int = 24) -> dict:
    """The SDF assets of the CLI phase: a closed cube ``.obj`` turned into
    an ``.sdf`` model by the port's ``obj_to_sdf_file``, a 48^3 ball
    written with ``write_sdf_file`` (an ``sdf`` collider) and a tilted
    floor at 128^3 in the reference's raw format (an ``sdf_file``
    collider, whose dx defaults to the grid's 1/128)."""
    from claymore_tpu_torch.io.meshsdf import obj_to_sdf_file
    from claymore_tpu_torch.io.sdf import write_sdf_file

    obj = out / "cube.obj"
    verts = [(x, y, z) for x in (0.0, 1.0) for y in (0.0, 1.0) for z in (0.0, 1.0)]
    quads = [(1, 3, 4, 2), (5, 6, 8, 7), (1, 2, 6, 5), (3, 7, 8, 4), (1, 5, 7, 3),
             (2, 4, 8, 6)]
    obj.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in verts)
                   + "".join("f " + " ".join(map(str, q)) + "\n" for q in quads))
    obj_to_sdf_file(str(obj), str(out / "cube.sdf"), dx=0.05)

    dx = 1.0 / 48
    ax = np.arange(48) * dx
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    ball = np.sqrt((X - 0.45) ** 2 + (Y - 0.32) ** 2 + (Z - 0.45) ** 2) - 0.07
    write_sdf_file(str(out / "ball.sdf"), ball, (0.0, 0.0, 0.0), dx)

    ax = np.arange(128, dtype=np.float32) / 128
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    floor = ((Y - 0.33) + 0.25 * (X - 0.5)) / np.float32(np.sqrt(1.0625))
    prefix = out / "floor"
    floor.astype(np.float32).reshape(-1).tofile(f"{prefix}_sdf.bin")
    for c, g in enumerate(np.gradient(floor, 1.0 / 128)):
        g.astype(np.float32).reshape(-1).tofile(f"{prefix}_grad_{c}.bin")

    doc = {
        "simulation": {"default_dt": 1e-4, "fps": fps, "frames": 2},
        "grid": {"domain_bits": 7, "max_active_blocks": 4096},
        "models": [{"constitutive": "jfluid", "file": "cube.sdf",
                    "offset": [0.35, 0.36, 0.35], "span": [0.2, 0.2, 0.2],
                    "velocity": [0.2, 0.0, 0.1]}],
        "colliders": [
            {"type": "sdf", "file": str(out / "ball.sdf"), "kind": "separate",
             "friction": 0.2},
            {"type": "sdf_file", "prefix": str(prefix), "resolution": [128, 128, 128],
             "kind": "slip", "friction": 0.1},
        ],
    }
    path = out / "sdf_scene.json"
    path.write_text(json.dumps(doc))
    return {"scene": path, "doc": doc}


def run_cli_sdf(facts: str, fps: int = 24) -> dict:
    """The CLI on a scene of SDF assets: two frames with a checkpoint after
    each, then the last frame again from the first checkpoint.  Every
    particle is read back from each ``.bgeo``; the state loaded from a
    checkpoint equals the saved arrays bit for bit; the uninterrupted and
    the resumed frame-2 states keep mass and particles and agree, paired by
    id, within RESUME_POS_BOUND."""
    import shutil

    from claymore_tpu_torch.io import bgeo
    from claymore_tpu_torch.io import checkpoint as ckpt
    from claymore_tpu_torch.io.scene import load_scene
    from claymore_tpu_torch.utils.debug import to_numpy

    root = Path(__file__).resolve().parent
    work = root / "build" / "smoke_sdf_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    assets = write_sdf_assets(work, fps)
    assets_s = time.perf_counter() - t0
    scene_file = assets["scene"]
    full, part = work / "full", work / "resumed"

    def cli(*args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "claymore_tpu_torch", "-f", str(scene_file),
             "--device", DEVICE, "--checkpoint-every", "1", *args],
            cwd=root, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exited {proc.returncode}:\n{proc.stdout}\n"
                                 f"{proc.stderr}")
        return proc.stdout, time.perf_counter() - t0

    out_full, wall_full = cli("-o", str(full))
    out_part, wall_part = cli("-o", str(part), "--frames", "1", "--resume",
                              str(full / "ckpt_0000.npz"))
    if "resumed from" not in out_part:
        raise AssertionError(f"the resumed run did not resume:\n{out_part}")

    sc = load_scene(str(scene_file), device=DEVICE, tile_chunk=64)   # the CLI's default
    n = sc.positions[0].shape[0]
    for d, frames in ((full, (-1, 0, 1)), (part, (-1, 0))):
        for f in frames:
            pos, _ = bgeo.read_bgeo(str(d / f"model0_frame{f:04d}.bgeo"))
            if pos.shape != (n, 3) or not np.all(np.isfinite(pos)):
                raise AssertionError(f"{d.name} frame {f}: {pos.shape} positions, "
                                     f"scene has {n}")
    # loaded = saved, bit for bit
    saved = full / "ckpt_0000.npz"
    loaded = ckpt.load_state(str(saved), sc.state)
    with np.load(saved) as data:
        for i, leaf in enumerate(ckpt.leaves(loaded)):
            a, b = to_numpy(leaf), data[f"leaf_{i}"]
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"checkpoint leaf {i} differs after load")
    ends = {k: ckpt.load_state(str(p), sc.state) for k, p in
            (("full", full / "ckpt_0001.npz"), ("resumed", part / "ckpt_0000.npz"))}
    expected = n * sc.materials[0].mass
    report = {"particles": n, "assets_s": assets_s, "wall_full_s": wall_full,
              "wall_resumed_s": wall_part}
    for k, st in ends.items():
        d = sc.engine.diagnostics(st)
        mass_err = abs(float(st.grid[:-1, 0:4].double().sum()) - expected) / expected
        ok = (mass_err < 1e-5 and d["null_block_mass"] == 0.0
              and d["model0_dropped_tiles"] == 0 and d["block_overflow"] == 0
              and d["model0_active"] == n)
        if not ok:
            raise AssertionError(f"CLI {k} run: mass_rel_err {mass_err:.3e}, {d}")
        report[f"{k}_mass_rel_err"] = mass_err
        report[f"{k}_step"] = d["step"]
    a, b = ends["full"].models[0], ends["resumed"].models[0]
    if not (torch.equal(ends["full"].t, ends["resumed"].t)
            and torch.equal(ends["full"].step, ends["resumed"].step)):
        raise AssertionError("resumed run ended at another t or step")
    pa = torch.empty((3, n), device=DEVICE)
    pb = torch.empty((3, n), device=DEVICE)
    pa[:, a.pid[a.active].long()] = a.pos[:, a.active]
    pb[:, b.pid[b.active].long()] = b.pos[:, b.active]
    diff = float((pa - pb).abs().max())
    report["resume_pos_diff"] = diff
    contact = sdf_contact(sc.cfg, ends["full"], sc.engine.colliders)
    report["sdf_cells_touched"] = contact
    log(f"CLI SDF scene (cube.obj -> cube.sdf model, ball.sdf and raw floor "
        f"colliders, {n} particles): assets {assets_s:.1f} s; 2 frames with "
        f"checkpoints exit 0 in {wall_full:.1f} s; resume from frame 1 exit 0 in "
        f"{wall_part:.1f} s; every particle read back from 5 .bgeo files; loaded "
        f"checkpoint == saved bit for bit; frame 2 mass_rel_err "
        f"{report['full_mass_rel_err']:.3e} (uninterrupted) "
        f"{report['resumed_mass_rel_err']:.3e} (resumed), step "
        f"{report['full_step']}; resumed vs uninterrupted positions by pid: max "
        f"{diff:.3e} (bound {RESUME_POS_BOUND}); {contact} massive cells touched "
        f"by the SDF colliders at the end | {facts}")
    if not diff <= RESUME_POS_BOUND:
        raise AssertionError(f"resumed frame 2 differs by {diff} > {RESUME_POS_BOUND}")
    if contact == 0:
        raise AssertionError("the CLI scene's fluid never met its SDF colliders")
    report["poisson"] = check_poisson_model(assets["doc"], scene_file.parent, facts)
    return report


def check_poisson_model(doc: dict, base: Path, facts: str) -> dict:
    """The CLI scene's ``.sdf`` model loaded with ``"sampling": "poisson"``
    (the scene loader's own path): the port's g++-built weighted sample
    elimination ran (no fallback), the cloud holds within 10% of the
    uniform lattice's particles, no two coincide, and its 5th-percentile
    nearest-neighbour spacing beats a lattice jittered by +-0.45 spacings
    at equal count by 1.5x (tests/test_io.py's blue-noise check)."""
    from scipy.spatial import cKDTree

    from claymore_tpu_torch.config import SimConfig
    from claymore_tpu_torch.io.scene import _model_positions
    from claymore_tpu_torch.ops import _build

    g = doc["grid"]
    cfg = SimConfig(domain_bits=g["domain_bits"], max_active_blocks=g["max_active_blocks"])
    model = dict(doc["models"][0])
    t0 = time.perf_counter()
    uni = _model_positions(model, cfg, str(base))
    model["sampling"] = "poisson"
    pois = _model_positions(model, cfg, str(base))
    wall = time.perf_counter() - t0
    if _build.host_library() is None:
        raise AssertionError("the host library (csrc/sample_elim.cpp) did not build")
    rng = np.random.default_rng(SEED)
    h = cfg.dx / cfg.ppc ** (1.0 / 3.0)
    jit = (uni + rng.uniform(-0.45, 0.45, uni.shape) * h)[:len(pois)]
    k = min(len(pois), len(jit))

    def nn(p):
        return cKDTree(p).query(p, k=2)[0][:, 1]

    d_pois, d_jit = nn(pois[:k]), nn(jit[:k])
    res = {"particles": int(len(pois)), "uniform_particles": int(len(uni)),
           "min_nn": float(d_pois.min()), "q05_nn": float(np.quantile(d_pois, 0.05)),
           "q05_nn_jittered": float(np.quantile(d_jit, 0.05)), "wall_s": wall}
    log(f"poisson sampling of the CLI scene's cube.sdf model: {res} | {facts}")
    if not (abs(len(pois) - len(uni)) <= 0.1 * len(uni) and res["min_nn"] > 0.0
            and res["q05_nn"] > 1.5 * res["q05_nn_jittered"]):
        raise AssertionError(f"poisson sampling: {res}")
    return res


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# multiple devices: MultiChipEngine with every shard on the card
# --------------------------------------------------------------------------

MULTI_BOUND = 1e-5      # multi vs one device: mass, momentum, dt (relative), positions
MULTI25_STEPS = 100     # sphere25m 2x2: past its first drift rebuild (so crossers are packed)
MIG_CAP = 262144        # scenes/sphere_100m_8dev.json's migration capacity


def positions_all(states, n: int) -> torch.Tensor:
    """f32[3, n] on the card: every state's active particles, column = pid;
    NaN where no state holds the pid."""
    out = torch.full((3, n), float("nan"), device=DEVICE)
    for st in states:
        m = st.models[0]
        out[:, m.pid[m.active].long().to(DEVICE)] = m.pos[:, m.active].to(DEVICE)
    return out


def grid_totals(states, eng=None) -> np.ndarray:
    """float64 (mass, momentum x, y, z): the whole pool of a one-device
    state, or each block on its owner shard (``owned_rows``)."""
    tot = torch.zeros(4, dtype=torch.float64, device=DEVICE)
    for j, st in enumerate(states):
        rows = (st.grid[:-1] if eng is None else eng.owned_rows(states, j)).double()
        tot[0] += rows[:, 0:4].sum().to(DEVICE)
        tot[1:] += rows[:, 4:16].reshape(rows.shape[0], 3, 4, 128).sum(dim=(0, 2, 3)).to(DEVICE)
    return tot.cpu().numpy()


def single_reference(name: str, steps: int, facts: str, slack: float = None) -> dict:
    """MPMEngine on the bench scene ``name``, ``steps`` substeps from init:
    every dt, the grid totals, every position by pid (kept on the card) and
    ms/substep; the engine and its state are freed before returning.
    ``slack``: size the tiles with ``exact_tiles(slack=)`` (as a mesh of
    one does) instead of the scene's capacity."""
    import claymore_tpu_torch as ct

    cfg, mats, parts, v0s, cols = scene(name)
    if slack is not None:
        cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, parts, slack=slack))
    eng = ct.MPMEngine(cfg, mats, cols, tile_chunk=64, device=DEVICE)
    state = eng.init_state(parts, v0s)
    n = parts[0].shape[0]
    fe = np.float32(1e9)
    dts = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = eng.substep(state, fe)
        dts.append(state.dt)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    out = {"dt": torch.stack(dts).cpu().numpy(), "totals": grid_totals((state,)),
           "pos": positions_all((state,), n), "ms_per_substep": ms,
           "rebuilds": eng.rebuilds, "n": n}
    log(f"reference MPMEngine {name}: {n} particles, {steps} substeps, {ms:.3f} ms/substep, "
        f"rebuilds {eng.rebuilds} | {facts}")
    del state, eng
    torch.cuda.empty_cache()
    return out


def multi_run(name: str, mesh, steps: int, facts: str, ref: dict, overlap: bool = True,
              label: str = "", slack: float = None, make=None) -> dict:
    """MultiChipEngine on the bench scene ``name``, every shard on the card,
    ``steps`` substeps from init with the launch counts zeroed before the
    init and read after the last substep.  ``make()``, when given, builds
    the engine and its initial state in place of the bench scene: it
    returns (engine, state, positions per model).  Each substep's stages are timed
    with CUDA events recorded where ``substep_impl`` calls ``on_stage``
    (on the main stream), and the halo exchange from its start on the main
    stream to the end of the last shard's side-stream work.  Held to the
    one-device run ``ref`` of the same substeps: dt at every substep, mass
    and momentum (each block on its owner) within MULTI_BOUND relative,
    positions of every particle, paired by pid, within MULTI_BOUND (and of
    pids 0..4095, logged apart); nothing overflows, drops
    or is lost, particles move, and the peak stays under PEAK_BOUND."""
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.ops.g2p2g_kernel import variant_name

    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    reset_counts()
    if make is None:
        cfg, mats, parts, v0s, cols = scene(name)
        if slack is None:
            slack = 2.5 if name == "dambreak12m" else 1.5      # the column spreads (bench.py)
        eng = ct.MultiChipEngine(cfg, mats, mesh_shape=mesh, device=DEVICE, tile_chunk=64,
                                 migration_capacity=MIG_CAP, overlap_halo=overlap,
                                 colliders=cols, particle_capacity_factor=slack)
        t0 = time.perf_counter()
        state = eng.init_state(parts, v0s)
    else:
        t0 = time.perf_counter()
        eng, state, parts = make()
        cfg, mats = eng.cfg, eng.materials
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = parts[0].shape[0]
    comm = eng.comm
    p0 = positions_all(state, n)
    shard0 = torch.from_numpy(eng.shard_of(parts[0])).to(DEVICE)
    exchange_events, stage_events = [], []
    plain_exchange = comm.exchange_halo

    def timed_exchange(pools, partitions):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain_exchange(pools, partitions)
        ends = []
        for j in range(len(pools)):
            with comm.group.on_side(j):
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
        exchange_events.append((start, ends))
        return out

    def on_stage(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        stage_events[-1].append((stage, ev))

    comm.exchange_halo = timed_exchange
    fe = np.float32(1e9)
    dts = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        stage_events.append([("start", start)])
        state = eng.substep(state, fe, on_stage=on_stage)
        dts.append(state[0].dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    comm.exchange_halo = plain_exchange
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    stages = {}
    for evs in stage_events:
        for (_, a), (stage, b) in zip(evs[:-1], evs[1:]):
            stages.setdefault(stage, []).append(a.elapsed_time(b))
    stage_ms = {k: float(np.mean(v)) for k, v in stages.items()}
    each = [evs[0][1].elapsed_time(evs[-1][1]) for evs in stage_events]
    stage_ms["substep (events)"] = float(np.mean(each))
    # the init's exchange is not timed (the wrapper went in after it); a
    # mesh of one exchanges nothing
    if exchange_events:
        stage_ms["exchange (start to last side-stream end)"] = float(np.mean(
            [max(s.elapsed_time(e) for e in ends) for s, ends in exchange_events]))

    d = eng.diagnostics(state)
    pos = positions_all(state, n)
    disp = float(torch.nan_to_num(pos - p0).abs().max())
    k = min(4096, n)
    pos_err = float((pos[:, :k] - ref["pos"][:, :k]).abs().max())
    pos_err_all = float((pos - ref["pos"]).abs().max())
    totals = grid_totals(state, eng)
    mass_err = abs(totals[0] - ref["totals"][0]) / ref["totals"][0]
    mom_err = float(np.abs(totals[1:] - ref["totals"][1:]).max()
                    / max(np.linalg.norm(ref["totals"][1:]), 1e-30))
    dt = torch.stack(dts).cpu().numpy()
    dt_err = float(np.max(np.abs(dt - ref["dt"]) / ref["dt"]))
    owner = torch.full((n,), -1, dtype=torch.long, device=DEVICE)
    for j, st in enumerate(state):
        m = st.models[0]
        owner[m.pid[m.active].long()] = comm.shards[j]
    moved_shard = int((owner != shard0).sum())
    expected = n * mats[0].mass
    k1 = variant_name(mats[0], cfg.arena_span)
    nd = eng.n_dev
    used = {"grid_update": launches["grid_update"], k1: launches[k1],
            **{k: launches[k] for k in REBUCKET_KERNELS + PARTITION_KERNELS + HALO_KERNELS}}
    bytes_ = comm.exchanged_bytes([st.partition for st in state], state[0].models)
    checks = {
        "finite": bool(np.isfinite(d["t"]) and torch.isfinite(pos).all()),
        "active": d["model0_active"] == n and bool((owner >= 0).all()),
        "dropped": d["model0_dropped_tiles"] == 0,
        "overflow": d["block_overflow"] == 0,
        "halo_overflow": d["halo_overflow"] == 0,
        "migration_dropped": d["migration_dropped"] == 0,
        "null_row": d["null_block_mass"] == 0.0,
        "mass": abs(totals[0] - expected) / expected < MULTI_BOUND and mass_err < MULTI_BOUND,
        "momentum": mom_err < MULTI_BOUND,
        "dt": dt_err < MULTI_BOUND,
        "positions": pos_err < MULTI_BOUND and pos_err_all < MULTI_BOUND,
        "moves": disp > 0.0,
        "launches": used["grid_update"] == steps * nd and used[k1] >= steps * nd,
        # every shard's initial sort at least
        "rebucket_launches": min(used[k] for k in REBUCKET_KERNELS) >= nd,
        # every shard's init and rebuilds (the compaction of each, and of
        # every migration where a comm is live)
        "partition_launches": (min(used[k] for k in PARTITION_KERNELS) >= nd
                               and used["oct_mask"] == used["remap"]
                               and used["first_marked"] >= used["remap"]),
        # a live mesh packs, masks and adds every substep on every shard,
        # and packs its crossers on each rebuilding substep; a mesh of one
        # exchanges nothing
        "halo_launches": (all(used[k] == 0 for k in HALO_KERNELS) if comm.trivial else
                          min(used[k] for k in HALO_KERNELS[:3]) >= steps * nd
                          and used["migrate_pack"] >= 1),
        "peak": peak_gib * 2**30 < PEAK_BOUND,
    }
    out = {"mesh": list(mesh), "particles": n, "substeps": steps, "overlap_halo": overlap,
           "split": comm.overlap and cfg.defrag_every == 1,
           "boundary_tiles": [comm.boundary_tile_cap(
               st.models[0].tiles.tvalid.shape[0], math.lcm(cfg.group_tiles, 64))
               for st in state[:1]] + [state[0].models[0].tiles.tvalid.shape[0]],
           "ms_per_substep": wall / steps * 1e3, "ref_ms_per_substep": ref["ms_per_substep"],
           "first_substep_ms": each[0], "later_substep_ms": float(np.mean(each[1:])),
           "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0,
           "stage_ms": stage_ms, "init_s": init_s, "peak_gib": peak_gib,
           "launches": used, "rebuilds": eng.rebuilds, "ref_rebuilds": ref["rebuilds"],
           "active_blocks": d["active_blocks"], "halo_capacity": comm.halo_capacity,
           "exchanged_bytes": bytes_, "migrated_by_pid": moved_shard,
           "mass_rel_err": float(mass_err), "momentum_rel_err": mom_err,
           "dt_rel_err": dt_err, "pos_err_pid4096": pos_err, "pos_err_all": pos_err_all,
           "displacement": disp}
    log(f"multi {name}{label} mesh {mesh} (shards on {DEVICE}, overlap_halo={overlap}, "
        f"split {out['split']}, boundary tiles {out['boundary_tiles'][0]} of "
        f"{out['boundary_tiles'][1]}): {n} particles, {steps} substeps, "
        f"{out['ms_per_substep']:.3f} ms/substep (one device "
        f"{ref['ms_per_substep']:.3f}), stages (ms, mean) "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
        + f"; rebuilds {eng.rebuilds} (one device {ref['rebuilds']}), blocks per shard "
        f"{d['active_blocks']}, halo capacity {comm.halo_capacity} octs, exchanged bytes "
        f"{bytes_}, particles whose shard changed {moved_shard}, init {init_s:.2f} s, peak "
        f"{peak_gib:.2f} GiB, allocator retries {out['alloc_retries']}, substep events first "
        f"{each[0]:.3f} ms, later mean {out['later_substep_ms']:.3f}, launches {used}; vs one "
        f"device: mass {mass_err:.3e}, momentum "
        f"{mom_err:.3e}, dt {dt_err:.3e}, positions pid<4096 {pos_err:.3e} (all "
        f"{pos_err_all:.3e}), displacement {disp:.3e} | {facts}")
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"multi {name}{label} {mesh}: checks failed {failed} ({d}, "
                             f"{out})")
    out["pos"] = pos
    out["state"] = state
    out["engine"] = eng
    return out


def multi_cli(facts: str, frames: int = 4) -> dict:
    """The CLI on scenes/cube_4dev.json (a 2x2 mesh, every shard on the
    card): ``frames`` frames with a checkpoint after each, then the last
    frame again from the one before; the resumed state lands within
    RESUME_POS_BOUND of the uninterrupted one, paired by pid."""
    import shutil

    from claymore_tpu_torch.io import bgeo
    from claymore_tpu_torch.io import checkpoint as ckpt
    from claymore_tpu_torch.io.scene import load_scene

    root = Path(__file__).resolve().parent
    scene_file = root / "scenes" / "cube_4dev.json"
    work = root / "build" / "smoke_multi_cli"
    shutil.rmtree(work, ignore_errors=True)
    full, part = work / "full", work / "resumed"

    def cli(*args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "claymore_tpu_torch", "-f", str(scene_file),
             "--device", DEVICE, "--checkpoint-every", "1", *args],
            cwd=root, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exited {proc.returncode}:\n{proc.stdout}\n"
                                 f"{proc.stderr}")
        return proc.stdout, time.perf_counter() - t0

    out_full, wall_full = cli("-o", str(full), "--frames", str(frames), "--profile")
    out_part, wall_part = cli("-o", str(part), "--frames", "1", "--resume",
                              str(full / f"ckpt_{frames - 2:04d}.npz"))
    sc = load_scene(str(scene_file), device=DEVICE, tile_chunk=64)
    n = sc.positions[0].shape[0]
    for f in range(-1, frames):
        pos, _ = bgeo.read_bgeo(str(full / f"model0_frame{f:04d}.bgeo"))
        if pos.shape != (n, 3) or not np.all(np.isfinite(pos)):
            raise AssertionError(f"multi CLI frame {f}: {pos.shape} positions, scene has {n}")
    a = ckpt.load_state(str(full / f"ckpt_{frames - 1:04d}.npz"), sc.state)
    b = ckpt.load_state(str(part / "ckpt_0000.npz"), sc.state)
    da, db = sc.engine.diagnostics(a), sc.engine.diagnostics(b)
    diff = float((positions_all(a, n) - positions_all(b, n)).abs().max())
    expected = n * sc.materials[0].mass
    log(f"multi CLI cube_4dev.json (mesh {sc.engine.mesh_shape}, {n} particles): {frames} "
        f"frames with checkpoints exit 0 in {wall_full:.1f} s, resume of the last frame "
        f"exit 0 in {wall_part:.1f} s; step {da['step']} / {db['step']}, mass "
        f"{da['grid_mass']:.6f} / {db['grid_mass']:.6f} (expected {expected:.6f}); resumed "
        f"vs uninterrupted positions by pid: max {diff:.3e} (bound {RESUME_POS_BOUND}); "
        f"the uninterrupted run's --profile:\n" + "\n".join(out_full.strip().splitlines()[-3:])
        + f"\n| {facts}")
    ok = (da["step"] == db["step"] and da["model0_active"] == db["model0_active"] == n
          and abs(da["grid_mass"] - expected) < 1e-5 * expected
          and da["migration_dropped"] == da["halo_overflow"] == 0 and diff <= RESUME_POS_BOUND)
    if not ok:
        raise AssertionError(f"multi CLI: {da} / {db}, resume diff {diff}")
    return {"particles": n, "wall_full_s": wall_full, "wall_resumed_s": wall_part,
            "resume_pos_diff": diff, "step": da["step"]}


def multi_validate_scale(facts: str) -> dict:
    """scripts/validate_scale.py's port at domain_bits=10 over 4 shards on
    the card, as a subprocess."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "claymore_tpu_torch.scripts.validate_scale",
                           "4", "--device", DEVICE], cwd=root, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or "scale validation: OK" not in proc.stdout:
        raise AssertionError(f"validate_scale exited {proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    log(f"validate_scale (domain_bits=10, 4 shards on {DEVICE}) in {wall:.1f} s: "
        + " ".join(proc.stdout.strip().splitlines()) + f" | {facts}")
    return {"wall_s": wall, "stdout": proc.stdout.strip()}


def dist_rank(rank: int, port: int, out: str, backend: str = "nccl") -> None:
    """One rank of ``dist_path``: the cube on a (2,) mesh through a
    ``DistGroup``, shard ``rank`` on cuda:<rank> (on the CPU with gloo);
    its positions by pid and the group's diagnostics into ``out``."""
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.parallel import distributed

    global DEVICE
    if backend == "nccl":
        DEVICE = f"cuda:{rank}"
        torch.cuda.set_device(rank)
    distributed.init_multihost(f"tcp://localhost:{port}", world_size=2, rank=rank,
                               backend=backend)
    group = distributed.DistGroup((2,), DEVICE)
    cfg, mats, parts, v0s, _ = scene("cube")
    eng = ct.MultiChipEngine(cfg, mats, n_devices=2, device=DEVICE, tile_chunk=64,
                             migration_capacity=MIG_CAP, group=group)
    st = eng.run_steps(eng.init_state(parts, v0s), 20, np.float32(1e9))
    d = eng.diagnostics(st)
    np.savez(out, pos=positions_all(st, parts[0].shape[0]).cpu().numpy(),
             mass=d["grid_mass"], active=d["model0_active"])
    torch.distributed.destroy_process_group()


def dist_path(facts: str) -> dict:
    """``DistGroup`` on the card: with two or more cards, two NCCL ranks
    (cuda:0 and cuda:1) run the cube on a (2,) mesh, held to a
    ``LocalGroup`` run on the same two cards within MULTI_BOUND.  With one
    card it does not run: NCCL refuses two ranks on one card."""
    import socket

    import claymore_tpu_torch as ct

    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"DistGroup on the card: not run, {cards} CUDA device visible and NCCL refuses "
            "two ranks on one card; tests/test_torch_multi_dist.py holds DistGroup to "
            "LocalGroup bit for bit over gloo on the CPU")
        return {"run": False, "cards": cards}
    root = Path(__file__).resolve().parent
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outs = [root / "build" / f"smoke_dist_rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.dist_rank({r}, {port}, "
                               f"{str(outs[r])!r})"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        text, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"DistGroup rank exited {p.returncode}:\n{text}")
    cfg, mats, parts, v0s, _ = scene("cube")
    eng = ct.MultiChipEngine(cfg, mats, n_devices=2, device=["cuda:0", "cuda:1"],
                             tile_chunk=64, migration_capacity=MIG_CAP)
    st = eng.run_steps(eng.init_state(parts, v0s), 20, np.float32(1e9))
    n = parts[0].shape[0]
    want = positions_all(st, n).cpu().numpy()
    d = eng.diagnostics(st)
    got = [np.load(o) for o in outs]
    # each rank holds its shard's particles; together they hold every one
    pos = np.where(np.isnan(got[0]["pos"]), got[1]["pos"], got[0]["pos"])
    if np.isnan(pos).any() or not (np.isnan(got[0]["pos"]) | np.isnan(got[1]["pos"])).all():
        raise AssertionError("DistGroup: a particle on no rank, or on both")
    err = float(np.abs(pos - want).max())
    for g in got:
        if int(g["active"]) != d["model0_active"] or abs(float(g["mass"]) - d["grid_mass"]) \
                > MULTI_BOUND * d["grid_mass"]:
            raise AssertionError(f"DistGroup diagnostics {dict(g)} vs {d}")
    log(f"DistGroup over NCCL, 2 ranks on cuda:0/cuda:1, cube 20 substeps: positions vs "
        f"LocalGroup on the same cards max {err:.3e}, diagnostics summed over the ranks "
        f"equal | {facts}")
    if not err <= MULTI_BOUND:
        raise AssertionError(f"DistGroup positions differ by {err}")
    return {"run": True, "cards": cards, "pos_err": err}


def cards_path(facts: str, steps: int = 20) -> dict:
    """``LocalGroup`` across cards: sphere25m on a 2x2 mesh with one shard
    per card (peer copies between cards, a side stream per shard) against
    every shard on cuda:0, ``steps`` substeps after two: positions by pid
    within MULTI_BOUND, nothing lost, ms/substep of each.  Needs four
    cards; with fewer it does not run and says so."""
    import claymore_tpu_torch as ct

    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"LocalGroup across cards: not run, {cards} CUDA device visible (a 2x2 mesh "
            "with one shard per card needs 4)")
        return {"run": False, "cards": cards}
    fe = np.float32(1e9)
    res, pos = {}, {}
    for key, devices in (("one_card", ["cuda:0"] * 4),
                         ("four_cards", [f"cuda:{d}" for d in range(4)])):
        cfg, mats, parts, v0s, _ = scene("sphere25m")
        eng = ct.MultiChipEngine(cfg, mats, mesh_shape=(2, 2), device=devices,
                                 tile_chunk=64, migration_capacity=MIG_CAP)
        st = eng.run_steps(eng.init_state(parts, v0s), 2, fe)
        for d in range(4):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        st = eng.run_steps(st, steps, fe)
        for d in range(4):
            torch.cuda.synchronize(d)
        d = eng.diagnostics(st)
        res[key] = {"ms_per_substep": (time.perf_counter() - t0) / steps * 1e3,
                    "mass": d["grid_mass"], "active": d["model0_active"],
                    "halo_overflow": d["halo_overflow"], "mig": d["migration_dropped"]}
        pos[key] = positions_all(st, parts[0].shape[0])
        n = parts[0].shape[0]
        del st, eng
        torch.cuda.empty_cache()
    err = float((pos["one_card"] - pos["four_cards"]).abs().max())
    log(f"LocalGroup sphere25m 2x2, one shard per card vs four shards on cuda:0, {steps} "
        f"substeps: positions by pid max {err:.3e}, {res['four_cards']['ms_per_substep']:.3f} "
        f"vs {res['one_card']['ms_per_substep']:.3f} ms/substep, {res} | {facts}")
    if not (err <= MULTI_BOUND and all(r["active"] == n and r["halo_overflow"] == 0
                                       and r["mig"] == 0 for r in res.values())):
        raise AssertionError(f"LocalGroup across cards: positions {err}, {res}")
    return {"run": True, "cards": cards, "pos_err": err, **res}


def multi_paths(facts: str) -> dict:
    """The multi-device paths: sphere25m 2x2 (overlap on and off),
    dambreak12m 4x1, a mesh of one on the cube, the CLI on
    scenes/cube_4dev.json, validate_scale, and the phases that need several
    cards (each says so where it cannot run)."""
    out = {}
    # 1-2. sphere25m on a 2x2 mesh, overlap on and off, against MPMEngine
    ref = single_reference("sphere25m", MULTI25_STEPS, facts)
    p1 = multi_run("sphere25m", (2, 2), MULTI25_STEPS, facts, ref)
    st = p1.pop("state")
    eng = p1.pop("engine")
    k1s = check_g2p2g_kernel(eng.cfg, eng.materials[0], st[0], tile_chunk=64,
                             time_it=False)
    log(f"K1 on shard 0 of the multi sphere25m state vs plain: grid err "
        f"{k1s['max_abs_err']:.3e}, pos {k1s['pos_err']:.3e} | {facts}")
    # the rebucket kernels on shard 0 with its region (boundary blocks first)
    p1["rebucket"] = check_rebucket_kernel(
        eng.cfg, st[0].models[0], "shard 0 of the multi sphere25m 2x2 state, its region",
        facts, region_fn=lambda k: eng.comm.is_boundary_key(k, eng.comm.shards[0]))
    # the partition kernels on shard 0's stale rebuild with the halo mask of
    # the rows its neighbours send it
    received, _ = eng.comm.exchange_halo([s.grid for s in st], [s.partition for s in st])
    eng.comm.wait_halo()
    extra = eng.comm.halo_mass_mask(received[0])
    if extra is None or not bool(extra.any()):
        raise AssertionError("multi sphere25m 2x2: shard 0 received no halo mass")
    p1["partition"] = check_partition_kernel(
        eng.cfg, *rebuild_inputs(eng.cfg, st[0]),
        "shard 0 of the multi sphere25m 2x2 state, its halo mask", facts, extra_mask=extra)
    del received, extra
    # the halo kernels on the final state, and with capacities it overflows
    # (a halo capacity of 64 octs; a migration capacity of 256 with each
    # slab narrowed by 2 blocks a face, so ~12% of its particles cross)
    from claymore_tpu_torch.parallel import HaloComm

    args = ([s.grid for s in st], [s.partition for s in st], [s.models[0] for s in st])
    p1["halo"] = check_halo_kernel(eng.comm, *args, "sphere25m 2x2 final state", facts)
    small = HaloComm(eng.cfg, eng.comm.axes, eng.comm.mesh_shape, eng.comm.margin, 256, 64,
                     group=eng.comm.group)
    over = check_halo_kernel(small, *args, "sphere25m 2x2 final state, overflowing "
                             "capacities", facts, narrow=2)
    if not (sum(over["overflow"].values()) > 0 and sum(over["dropped"].values()) > 0):
        raise AssertionError(f"halo check: the small capacities did not overflow: {over}")
    p1["halo_overflowing"] = over
    del args, small
    del st, eng
    torch.cuda.empty_cache()
    p2 = multi_run("sphere25m", (2, 2), MULTI25_STEPS, facts, ref, overlap=False,
                   label=" overlap_halo=False")
    p2.pop("state"), p2.pop("engine")
    diff = float((p1["pos"] - p2["pos"]).abs().max())
    log(f"multi sphere25m 2x2: overlap_halo=False vs True, positions by pid max {diff:.3e}, "
        f"{p2['ms_per_substep']:.3f} vs {p1['ms_per_substep']:.3f} ms/substep | {facts}")
    if not diff < MULTI_BOUND:
        raise AssertionError(f"overlap_halo=False differs from True by {diff}")
    p2["pos_vs_overlap"] = diff
    del ref, p1["pos"], p2["pos"]
    torch.cuda.empty_cache()
    out["multi_sphere25m_2x2"], out["multi_sphere25m_2x2_no_overlap"] = p1, p2
    # 3. dambreak12m on 4 x-slabs, drift-triggered rebuilds; K1-JF on a tile
    #    range of shard 1's final state against its plain version
    ref = single_reference("dambreak12m", 80, facts)
    p3 = multi_run("dambreak12m", (4,), 80, facts, ref)
    st, eng = p3.pop("state"), p3.pop("engine")
    del p3["pos"], ref
    if p3["migrated_by_pid"] == 0:
        raise AssertionError("multi dambreak12m: no particle changed shard")
    nt = st[1].models[0].tiles.tvalid.shape[0]
    bt = eng.comm.boundary_tile_cap(nt, math.lcm(eng.cfg.group_tiles, 64))
    k1j = check_g2p2g_kernel(eng.cfg, eng.materials[0], st[1], tile_chunk=64, reps=10,
                             plain_reps=1, tile_split=bt)
    log_k1(f"g2p2g_jfluid on tiles [0, {bt}) + [{bt}, {nt}), shard 1 of the multi "
           f"dambreak12m state", k1j, facts)
    p3["k1_tile_range"] = {k: k1j[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "pos_err")}
    del st, eng
    torch.cuda.empty_cache()
    out["multi_dambreak12m_4x1"] = p3
    # 4. a mesh of one on the 1M cube: MPMEngine's pipeline and its cost,
    #    both engines with the tiles a mesh sizes (exact_tiles, slack 1.3)
    ref = single_reference("cube", 40, facts, slack=1.3)
    p4 = multi_run("cube", (1,), 40, facts, ref, slack=1.3)
    p4.pop("state"), p4.pop("engine"), p4.pop("pos")
    p4["overhead_ms_per_substep"] = p4["ms_per_substep"] - ref["ms_per_substep"]
    log(f"mesh (1,) on the cube: {p4['ms_per_substep']:.3f} ms/substep against MPMEngine's "
        f"{ref['ms_per_substep']:.3f}: overhead {p4['overhead_ms_per_substep']:.3f} "
        f"ms/substep | {facts}")
    del ref
    torch.cuda.empty_cache()
    out["multi_cube_mesh1"] = p4
    # 5-6. the CLI on scenes/cube_4dev.json; validate_scale; DistGroup
    out["multi_cli_cube_4dev"] = multi_cli(facts)
    out["validate_scale"] = multi_validate_scale(facts)
    out["dist_group"] = dist_path(facts)
    out["local_group_cards"] = cards_path(facts)
    return out


# --------------------------------------------------------------------------
# config 5: scenes/sphere_100m_8dev.json, BASELINE.md's 99.6M-particle
# FixedCorotated sphere on a 1024^3 grid (a 4x2 mesh in the scene file)
# --------------------------------------------------------------------------

C5_SCENE = Path(__file__).resolve().parent / "scenes" / "sphere_100m_8dev.json"
C5_STEPS = 6      # substeps of the scene on one device and on its mesh: the
#                   mesh on one card takes ~0.5 s a substep
C5_BUSY_STEPS = 12  # one-device substeps (~1.4 s) run while a frame is written
C5_SHARD_SLOTS = 42_942_464   # slots of each shard of the 4x2 mesh (config5_mesh logs them)


def config5_one_device_scene(work: Path) -> Path:
    """The scene file less its ``device`` block (the same grid, model and
    simulation): how a user with one card runs config 5."""
    doc = json.loads(C5_SCENE.read_text())
    doc.pop("device")
    work.mkdir(parents=True, exist_ok=True)
    path = work / "sphere_100m_1dev.json"
    path.write_text(json.dumps(doc, indent=1))
    return path


def config5_shard_path(facts: str) -> dict:
    """One shard of config 5 (``prof_multichip --config5shard``: 12.5M
    particles at domain_bits 10) through ``drive``: two warm-up substeps,
    then 20 timed, with every invariant; the JAX script's three keys; then
    K1 held against its plain version on the final state (not counted)."""
    run = drive("config5_shard", steps=20, facts=facts, warmup=2)
    m = run["metrics"]
    keys = {"config5_shard_particles": m["particles"],
            "config5_shard_ms_per_step": m["ms_per_substep"],
            "config5_shard_dropped": int(run["state"].models[0].tiles.dropped[0])}
    log(f"prof_multichip --config5shard on the card: {json.dumps(keys)} | {facts}")
    k1 = check_g2p2g_kernel(run["cfg"], run["mats"][0], run["state"], tile_chunk=64,
                            reps=10, plain_reps=1)
    log_k1(f"g2p2g_fixed_corotated, config-5 shard state ({m['particles']} particles)",
           k1, facts)
    del run
    torch.cuda.empty_cache()
    return {**m, **keys, "k1": k1}


def files_equal(a: Path, b: Path) -> bool:
    """Byte for byte (two non-empty files)."""
    if a.stat().st_size != b.stat().st_size:
        return False
    return bool(np.array_equal(np.memmap(a, np.uint8, mode="r"),
                               np.memmap(b, np.uint8, mode="r")))


def write_ab(positions: np.ndarray, work: Path, facts: str, busy) -> dict:
    """One frame written four ways, one after the other: the native and
    the numpy writer, each synchronously and on the IO thread.  A queued
    write is timed to its return, then ``busy()`` (substeps of the
    simulation) runs while it writes, then the wait left at ``flush``;
    ``busy()`` alone before and after gives what a write in flight costs
    the loop.  The synchronous native file reads back equal to
    ``positions``; the others are byte for byte the same file."""
    from claymore_tpu_torch.io import async_io, bgeo

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    first = work / "ab_native_sync.bgeo"
    out = {"busy_alone_before_s": timed(busy),
           "native_sync_s": timed(lambda: bgeo.write_bgeo_native(str(first), positions)),
           "bytes": first.stat().st_size}
    back, _ = bgeo.read_bgeo(str(first))
    if not np.array_equal(back, positions):
        raise AssertionError("native BGEO writer: the frame reads back different")
    del back

    def native_async(p):
        if bgeo.write_bgeo(p, positions, asynchronous=True) != "native":
            raise AssertionError("write_bgeo did not take the native writer")

    writers = {
        "native_async": native_async,
        "numpy_sync": lambda p: bgeo.write_bgeo_numpy(p, positions),
        "numpy_async": lambda p: async_io.insert_job(
            lambda: bgeo.write_bgeo_numpy(p, positions)),
    }
    for name, write in writers.items():
        f = work / f"ab_{name}.bgeo"
        out[f"{name}_{'return_' if name.endswith('async') else ''}s"] = timed(
            lambda: write(str(f)))
        if name.endswith("async"):
            out[f"{name}_busy_s"] = timed(busy)
            out[f"{name}_flush_s"] = timed(async_io.flush)
        if not files_equal(first, f):
            raise AssertionError(f"{name} wrote another file than the native writer")
        f.unlink()
    first.unlink()
    out["busy_alone_after_s"] = timed(busy)
    log(f"config 5 frame writes ({positions.shape[0]} particles, {out['bytes']} bytes): "
        + ", ".join(f"{k} {v:.3f}" for k, v in out.items() if k != "bytes")
        + f"; every file equal, the native one read back equal | {facts}")
    return out


def config5_one_device(facts: str, work: Path, steps: int = C5_STEPS) -> dict:
    """Config 5 on one device, as ``load_scene`` builds it from the scene
    file less its device block (tiles of 256, a rebuild every substep):
    load (sampling included), ``steps`` substeps each ended by a
    synchronise, counted launches, every invariant and the peak; the
    stage breakdown and K1/K2 beside their bounds on the final state; the
    write A/B on its positions, with substeps run while each queued write
    is in flight (after the reference is taken).  Returns the metrics, the one-device
    reference the mesh is held to, the sampled positions and the initial
    positions in slot order (what the CLI writes as frame -1)."""
    from claymore_tpu_torch.io.scene import load_scene
    from claymore_tpu_torch.ops.g2p2g_kernel import variant_name

    path = config5_one_device_scene(work)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    sc = load_scene(str(path), device=DEVICE, tile_chunk=64)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    eng, state, cfg, mat = sc.engine, sc.state, sc.cfg, sc.materials[0]
    n = sc.positions[0].shape[0]
    initial = eng.get_positions(state)
    p0 = positions_all((state,), n)
    fe = np.float32(1e9)
    dts, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state = eng.substep(state, fe)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        dts.append(state.dt)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    d = eng.diagnostics(state)
    totals = grid_totals((state,))
    expected = n * mat.mass
    mass_err = abs(totals[0] - expected) / expected
    pos = positions_all((state,), n)
    disp = float((pos - p0).abs().max())
    del p0
    margins = check_fused_margin(eng, state)
    k1 = variant_name(mat, cfg.arena_span)
    used = {"grid_update": launches["grid_update"], k1: launches[k1],
            **{k: launches[k] for k in REBUCKET_KERNELS + PARTITION_KERNELS}}
    checks = {
        "mass": mass_err < 1e-5,
        "null_row": d["null_block_mass"] == 0.0,
        "dropped": d["model0_dropped_tiles"] == 0,
        "overflow": d["block_overflow"] == 0,
        "migration_halo": d["migration_dropped"] == 0 and int(state.halo_overflow) == 0,
        "active": d["model0_active"] == n,
        "finite": bool(np.isfinite(d["t"]) and torch.isfinite(pos).all()),
        "moves": disp > 0.0,
        "launches": used["grid_update"] == steps and used[k1] == steps,
        # the init's sort and every substep's rebuild
        "rebucket_launches": all(used[k] == steps + 1 for k in REBUCKET_KERNELS),
        "partition_launches": all(used[k] == steps + 1 for k in PARTITION_KERNELS),
        "rebuilds": eng.rebuilds == steps,          # rebucket_every=1: every substep
        "peak": peak < PEAK_BOUND,
    }
    out = {"particles": n, "substeps": steps, "load_s": load_s,
           "ms_per_substep": float(np.mean(ms)), "ms_by_substep": ms,
           "rebuilds": eng.rebuilds, "peak_gib": peak / 2**30, "mass_rel_err": mass_err,
           "displacement": disp, "launches": used, "fused_margins": margins,
           "tiles": eng._num_tiles, "particle_tile": cfg.particle_tile,
           "slots": eng._num_tiles[0] * cfg.particle_tile,
           "active_octs": d["active_octs"]}
    log(f"config 5 on one device ({path.name}): {n} particles, {out['slots']} slots "
        f"(tile {cfg.particle_tile}), load {load_s:.2f} s, {steps} substeps at "
        f"{out['ms_per_substep']:.3f} ms/substep ({[round(x, 3) for x in ms]}), rebuilds "
        f"{eng.rebuilds}, {d['active_octs']} octs, peak {out['peak_gib']:.2f} GiB, "
        f"mass_rel_err {mass_err:.3e}, displacement {disp:.3e}, launches {used}, fused "
        f"margins {margins} == arena_margin | {facts}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"config 5 on one device: checks failed {failed} ({d}, {out})")
    # where a substep's time goes, and K1/K2 beside their bounds (not counted)
    stages = stage_breakdown(cfg, [mat], state, reps=5)
    out["stages_ms"] = stages
    out["k1"] = {"ms": stages["K1 g2p2g"], **g2p2g_bound(cfg, mat, state)}
    out["k2"] = {"ms": stages["K2 grid_update"], **grid_bound(cfg, state.grid, state.partition)}
    out["partition"] = check_partition_kernel(cfg, *rebuild_inputs(cfg, state),
                                              "config 5 one-device final state", facts,
                                              reps=5, plain_reps=2)
    log(f"config 5 on one device, through the rebucket kernels: sort_permute "
        f"{stages['sort_permute']:.3f} ms (keys+sort {stages['sort_permute: keys+sort']:.3f}), "
        f"peak {out['peak_gib']:.2f} GiB | {facts}")
    log("config 5 on one device, stages on its final state (ms, median of 5): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; K1 bound {out['k1']['bound_ms']:.4f} ms ({out['k1']['bound_by']}), K2 bound "
        f"{out['k2']['bound_ms']:.4f} ms ({out['k2']['bound_by']}) | {facts}")
    torch.cuda.empty_cache()
    sim = {"state": state}

    def busy():
        # substeps of the simulation, as a run of many frames overlaps them
        # with the last frame's write
        for _ in range(C5_BUSY_STEPS):
            sim["state"] = eng.substep(sim["state"], fe)
        torch.cuda.synchronize()

    out["writes"] = write_ab(eng.get_positions(state), work, facts, busy)
    state = sim.pop("state")
    ref = {"dt": torch.stack(dts).cpu().numpy(), "totals": totals, "pos": pos,
           "ms_per_substep": out["ms_per_substep"], "rebuilds": out["rebuilds"], "n": n}
    positions = sc.positions
    del sc, eng, state
    torch.cuda.empty_cache()
    return {"metrics": out, "ref": ref, "positions": positions, "initial": initial}


def config5_mesh(facts: str, positions, ref: dict, steps: int = C5_STEPS) -> dict:
    """The scene file itself, ``load_scene(..., device="cuda")``: its 4x2
    mesh with every shard on the card, from the positions the one-device
    run sampled, through ``multi_run`` against that run; K1's margin on
    every shard, the four empty ones too; K1 held to its plain version on
    the fullest shard's final state (tiles of 256, as on one device; not
    counted)."""
    from claymore_tpu_torch.io.scene import load_scene

    def make():
        sc = load_scene(str(C5_SCENE), device=DEVICE, tile_chunk=64, positions=positions)
        return sc.engine, sc.state, sc.positions

    out = multi_run("config5", (4, 2), steps, facts, ref, make=make,
                    label=f" ({C5_SCENE.name})")
    st, eng = out.pop("state"), out.pop("engine")
    del out["pos"]
    counts = [int(s.models[0].active.sum()) for s in st]
    margins = [check_fused_margin(eng, s, j) for j, s in enumerate(st)]
    out.update({"particles_by_shard": counts, "fused_margins": margins,
                "slots_by_shard": st[0].models[0].pos.shape[1],
                "shard_tiles": eng._num_tiles})
    log(f"config 5 4x2 mesh: particles by shard {counts} ({st[0].models[0].pos.shape[1]} "
        f"slots each), fused margins {margins} == arena_margin | {facts}")
    if sum(1 for c in counts if c == 0) != 4:
        raise AssertionError(f"config 5 4x2: the outer x slabs should be empty: {counts}")
    j = int(np.argmax(counts))
    out["halo"] = check_halo_kernel(
        eng.comm, [s.grid for s in st], [s.partition for s in st], [s.models[0] for s in st],
        "config 5 4x2 final state, the fullest shard and an empty one", facts,
        shards=[j, counts.index(0)])
    t0 = time.perf_counter()
    k1 = check_g2p2g_kernel(eng.cfg, eng.materials[0], st[j], tile_chunk=64, time_it=False)
    out["k1_shard"] = {"shard": j, "seconds": time.perf_counter() - t0,
                       **{k: k1[k] for k in ("max_abs_err", "grid_max", "pos_err",
                                             "field_err", "active", "margin")}}
    log(f"K1 on shard {j} of the config 5 4x2 state ({k1['active']} particles, tiles of "
        f"{eng.cfg.particle_tile}) vs plain: grid err {k1['max_abs_err']:.3e} (max "
        f"{k1['grid_max']:.3e}), pos {k1['pos_err']:.3e}, fields {k1['field_err']}, in "
        f"{out['k1_shard']['seconds']:.1f} s | {facts}")
    del st, eng
    torch.cuda.empty_cache()
    return out


def config5_cli(facts: str, scene_file: Path, initial: np.ndarray, work: Path) -> dict:
    """``python -m claymore_tpu_torch -f <the one-device scene> --frames 1``
    on the card: frame -1 (the initial cloud) reads back equal, bit for
    bit, to the in-process load's initial positions in slot order, frame 0
    holds every particle, finite, fallen; both went through the native
    writer; the profile's frame, write and flush seconds."""
    from claymore_tpu_torch.io import bgeo

    root = Path(__file__).resolve().parent
    out_dir = work / "cli"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "claymore_tpu_torch", "-f", str(scene_file), "--frames", "1",
         "-o", str(out_dir), "--device", DEVICE, "--profile"],
        cwd=root, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"config 5 CLI exited {proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    lines = proc.stdout.strip().splitlines()
    if "frames written: native 2, numpy 0" not in lines:
        raise AssertionError(f"config 5 CLI: the frames did not go through the native "
                             f"writer:\n{proc.stdout}")
    import re

    prof = {}      # the StageTimer report: tag, total s, mean ms, count
    for line in lines:
        hit = re.fullmatch(r"(.+?)\s+([\d.]+)\s+([\d.]+)\s+(\d+)", line.strip())
        if hit:
            prof[hit[1]] = {"total_s": float(hit[2]), "mean_ms": float(hit[3]),
                            "count": int(hit[4])}
    n = initial.shape[0]
    first, _ = bgeo.read_bgeo(str(out_dir / "model0_frame-001.bgeo"))
    if not np.array_equal(first, initial):
        raise AssertionError("config 5 CLI: frame -1 differs from the initial positions")
    del first
    last, _ = bgeo.read_bgeo(str(out_dir / "model0_frame0000.bgeo"))
    if not (last.shape == (n, 3) and np.isfinite(last).all()
            and float(last[:, 1].mean()) < float(initial[:, 1].mean())):
        raise AssertionError(f"config 5 CLI frame 0: {last.shape}, mean y "
                             f"{float(last[:, 1].mean())} vs {float(initial[:, 1].mean())}")
    steps = [line for line in lines if line.startswith("frame 1/1")]
    out = {"wall_s": wall, "particles": n, "profile": prof,
           "frame_line": steps[0] if steps else None,
           "stdout_tail": lines[-8:]}
    log(f"config 5 CLI --frames 1: exit 0 in {wall:.1f} s, frames -1 and 0 through the native "
        f"writer, {n} particles each read back (frame -1 equal to the load's), "
        f"{out['frame_line']}, profile {prof} | {facts}")
    for f in out_dir.glob("*.bgeo"):
        f.unlink()
    return out


def config5_paths(facts: str) -> dict:
    """Config 5: its shard (``prof_multichip --config5shard``), the scene on
    one device (with the write A/B), the scene on its 4x2 mesh held to the
    one-device run by pid, and the CLI writing its frame natively."""
    import shutil

    root = Path(__file__).resolve().parent
    work = root / "build" / "smoke_config5"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    du = shutil.disk_usage(work)
    log(f"config 5: disk at {work}: {du.free / 1e9:.1f} GB free of {du.total / 1e9:.1f}")
    out = {"config5_shard": config5_shard_path(facts)}
    one = config5_one_device(facts, work)
    out["config5_one_device"] = one["metrics"]
    out["multi_config5_4x2"] = config5_mesh(facts, one["positions"], one["ref"])
    del one["ref"], one["positions"]
    torch.cuda.empty_cache()
    out["config5_cli"] = config5_cli(facts, work / "sphere_100m_1dev.json", one["initial"],
                                     work)
    shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    import claymore_tpu_torch as ct
    from claymore_tpu_torch.ops import _build, halo_kernel, partition_kernel
    from claymore_tpu_torch.ops import probe_kernels as pk
    from claymore_tpu_torch.scripts import prof_k1

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
    # K1's and the collider K2s' persistent grids are SMs x the blocks per SM
    # the runtime allows
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    vol = 1e-6
    for mat in (ct.FixedCorotated(volume=vol), ct.JFluid(volume=vol),
                ct.Sand(volume=vol), ct.NACC(volume=vol)):
        for span in (2, 4):
            log(f"K1 {mat.name} span {span}: " + ", ".join(
                f"tile {tile} {g2p2g_kernel.kernel_info(mat, tile, span)}"
                for tile in (256, 512, 1024)) + f" | {facts}")
    for name in ("grid_update", "grid_update_colliders", "grid_update_sdf"):
        log(f"K2 {name}: {grid_kernel.kernel_info(name)} | {facts}")

    # 3. K2 and K2 with colliders at the flagship pool shape: the check pool
    #    (every oct of the domain) and, for the collider kernels, the
    #    straddle pool (every row crosses a surface of one of their colliders)
    cfg25, mats25, parts25, v0s25, _ = scene("sphere25m")
    mat25, pos25, v0 = mats25[0], parts25[0], v0s25[0]
    k2 = check_grid_kernel(cfg25, n_active=cfg25.num_oct_keys)
    log(f"K2 grid_update vs plain, pool {cfg25.max_active_octs + 1}x16x128: "
        f"max_abs_err {k2['max_abs_err']:.3e}, kernel {k2['ms']:.4f} ms, "
        f"plain {k2['plain_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms | {facts}")

    def log_colliders(label, r):
        log(f"{label}: max_abs_err {r['max_abs_err']:.3e}, {r['cells_changed']} velocity "
            f"values changed by the colliders, cull == collider_row_mask, culled "
            f"{r['culled_share']:.4f} of (row, collider) pairs {r['culled_by_collider']}, "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['registers']} registers, "
            f"{r['blocks_per_sm']} blocks/SM | {facts}")

    pool_shape = f"pool {cfg25.max_active_octs + 1}x16x128"
    k2c = check_grid_colliders_kernel(cfg25, n_active=cfg25.num_oct_keys)
    log_colliders(f"K2 grid_update_colliders vs plain, {pool_shape}, 3 colliders, t=0.37",
                  k2c)
    k2c_straddle = check_grid_colliders_kernel(cfg25, 0, straddle=True)
    log_colliders(f"K2 grid_update_colliders vs plain, straddle {pool_shape}", k2c_straddle)
    k2s = check_grid_sdf_kernel(cfg25, n_active=cfg25.num_oct_keys)
    log_colliders(f"K2 grid_update_sdf vs plain, {pool_shape}, dome 128^3 + half-space + "
                  f"animated 96x80x64 SDF, t=0.37", k2s)
    k2s_straddle = check_grid_sdf_kernel(cfg25, 0, straddle=True)
    log_colliders(f"K2 grid_update_sdf vs plain, straddle {pool_shape}", k2s_straddle)
    torch.cuda.empty_cache()

    # 4. K1 on the 1.07M cube after init and one grid update
    cfgc, matsc, partsc, v0sc, _ = scene("cube")
    matc, posc, v0c = matsc[0], partsc[0], v0sc[0]
    engc = ct.MPMEngine(cfgc, [matc], tile_chunk=64, device=DEVICE)
    sc = engc.init_state([posc], [v0c])
    k1c = check_g2p2g_kernel(cfgc, matc, sc, tile_chunk=64)
    log_k1(f"g2p2g_fixed_corotated, cube {posc.shape[0]} particles", k1c, facts)
    del sc
    # K1-FC at span 4 on the cube's span-4 initial state (the plain version
    # is timed once: at span 4 it takes seconds)
    cfgc4 = dataclasses.replace(cfgc, rebucket_every=4)
    sc4 = ct.MPMEngine(cfgc4, [matc], tile_chunk=64, device=DEVICE).init_state([posc], [v0c])
    k1c4 = check_g2p2g_kernel(cfgc4, matc, sc4, tile_chunk=64, plain_reps=1)
    log_k1(f"g2p2g_fixed_corotated_span4, cube {posc.shape[0]} particles, span-4 init",
           k1c4, facts)
    del sc4

    # 4b. the probes P1-P6 against their plain versions at the TPU scripts'
    #     inputs (not counted), then the probe path: the two probe entry
    #     points as subprocesses, each counting its launches from 0
    lane = check_laneops()
    for name, r in lane.items():
        log(f"{name} vs plain, {r['tiles']} tiles [16,{LANEOPS[name][0]}], random "
            f"shifts: max_abs_err {r['max_abs_err']}, kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f", {r['registers']} registers, {r['blocks_per_sm']} blocks/SM"
               if "registers" in r else "") + f" | {facts}")
    dma = check_dma()
    for name, rows in dma.items():
        for r in rows:
            what = (f"plan {r['plan']} (checked {'/'.join(r['plans_checked'])}, both variants)"
                    if name != "rmw" else "zero and 2**24/0.1 pools")
            log(f"{name} vs plain {tuple(r['config'])}, {what}: max_abs_err "
                f"{r['max_abs_err']}, kernel {r['ms']:.4f} ms"
                + (f" ({r['other_plan']} {r['other_plan_ms']:.4f} ms)"
                   if "other_plan" in r else "")
                + f", plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
                f"payload {r['payload_gbs']:.1f} GB/s, moves {r['moved_bytes'] / 1e9:.3f} GB, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.0%}) | {facts}")
    dma_subs = {name: pk.dma_info(name) for name in ("dma_gather", "dma_gather_ring", "rmw")}
    for name, subs in dma_subs.items():
        log(f"{name} sub-kernels at R = 9: {subs} | {facts}")
    paths_probe = check_probe_entry_points(facts)

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
    launches = {k: counts[k] for k in ("grid_update", "g2p2g_fixed_corotated",
                                       *REBUCKET_KERNELS, *PARTITION_KERNELS)}
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
        "launches": min(launches[k] for k in ("grid_update", "g2p2g_fixed_corotated"))
        >= substeps,
        # the init's sort and every rebuild's
        "rebucket_launches": all(launches[k] == 1 + rebuilds for k in REBUCKET_KERNELS),
        # and the init's partition rebuild and every rebuild's
        "partition_launches": all(launches[k] == 1 + rebuilds for k in PARTITION_KERNELS),
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
    log(f"sphere25m final state: fused margin {check_fused_margin(eng, state)} == "
        f"arena_margin | {facts}")

    # kernels at the main path's shapes, on its final state (not counted);
    # K1 also on the tile ranges a 4x1 mesh's transfer split gives it
    k1 = check_g2p2g_kernel(cfg25, mat25, state, tile_chunk=64, reps=10, plain_reps=1)
    log_k1("g2p2g_fixed_corotated, sphere25m state", k1, facts)
    from claymore_tpu_torch.parallel.multi import HaloComm

    nt25 = state.models[0].tiles.tvalid.shape[0]
    bt25 = HaloComm(cfg25, (("x", 0),), (4,), 1, 1).boundary_tile_cap(
        nt25, math.lcm(cfg25.group_tiles, 64))
    k1r = check_g2p2g_kernel(cfg25, mat25, state, tile_chunk=64, reps=10, time_plain=False,
                             tile_split=bt25)
    log_k1(f"g2p2g_fixed_corotated on tiles [0, {bt25}) + [{bt25}, {nt25}), sphere25m "
           "state", k1r, facts)
    # K1's time against the order of the slots inside the tiles
    k1_order = k1_order_sensitivity(cfg25, mat25, state, k1, facts)
    # the engine's own stage profile on the same state, beside the CUDA-event
    # breakdown; it must leave the state as it was
    before = (state.grid.clone(), state.models[0].pos.clone())
    prof = eng.profile_stages(state, iters=8, reps=2)
    sb = stage_breakdown(cfg25, [mat25], state)
    if not (torch.equal(before[0], state.grid) and _same(before[1], state.models[0].pos)
            and all(np.isfinite(v) for v in prof.values())):
        raise AssertionError(f"profile_stages: {prof}, or it changed its input state")
    log("sphere25m profile_stages (ms per call, best of 2 x 8): "
        + ", ".join(f"{k} {v:.3f}" for k, v in prof.items())
        + "; stage_breakdown (median of 10): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sb.items()) + f" | {facts}")
    # the rebucket kernels against their plain twins on the final state: as
    # it is, every tile's slots permuted (as K1's order check), every slot
    # shuffled, and half the shuffled slots' tiles (particles dropped)
    model25 = state.models[0]
    rebucket_checks = {"sphere25m": check_rebucket_kernel(cfg25, model25, "sphere25m final state",
                                                          facts)}
    rebucket_checks["sphere25m_permuted"] = check_rebucket_kernel(
        cfg25, prof_k1.permute_tiles(cfg25, state, "permuted").models[0],
        "sphere25m final state, every tile's slots permuted", facts)
    rebucket_checks["sphere25m_shuffled"] = check_rebucket_kernel(
        cfg25, shuffle_slots(model25), "sphere25m final state, every slot shuffled", facts)
    tight = check_rebucket_kernel(
        cfg25, shuffle_slots(model25, keep_slots=nt25 // 2 * cfg25.particle_tile),
        f"sphere25m final state shuffled, its first {nt25 // 2} of {nt25} tiles", facts,
        reps=3)
    if tight["dropped"] == 0:
        raise AssertionError("rebucket check: the tight state dropped no particle")
    rebucket_checks["sphere25m_tight"] = tight
    # the partition kernels against their twins on the stale rebuild of the
    # final state, and on its tiles rebuilt into a partition of half its
    # octs (overflow); first_marked at a config-5 mesh shard's migration
    # shape (42,942,464 slots, 262,144 migrants)
    from claymore_tpu_torch.core.engine import empty_partition

    partition_checks = {"sphere25m": check_partition_kernel(
        cfg25, *rebuild_inputs(cfg25, state), "sphere25m final state", facts)}
    cfg_half = dataclasses.replace(cfg25, max_active_blocks=int(state.partition.count[0]) // 2)
    over = check_partition_kernel(
        cfg_half, torch.zeros((cfg_half.max_active_octs + 1, 16, 128), device=DEVICE),
        empty_partition(cfg_half, DEVICE), rebuild_inputs(cfg25, state)[2],
        f"sphere25m final state's tiles into {cfg_half.max_active_octs} octs", facts,
        reps=3, plain_reps=1)
    if over["overflow"] == 0:
        raise AssertionError("partition check: the half-capacity rebuild did not overflow")
    partition_checks["sphere25m_overflow"] = over
    first_marked_checks = check_first_marked(C5_SHARD_SLOTS, MIG_CAP, facts)
    torch.cuda.empty_cache()
    del state, eng, eng_every, before
    torch.cuda.empty_cache()

    # 5b. sphere25m at span 4: a fixed cadence of 4 and drift-triggered
    #     rebuilds, beside the span-2 drift-triggered path in the same call;
    #     K1-FC timed alone on each final state, and at span 4 held against
    #     its plain version there (timed once: ~14 s a call)
    spans = {}
    for key, kw in (("span2_auto", {}),
                    ("span4_every4", dict(rebucket_every=4, rebucket_auto=False)),
                    ("span4_auto", dict(rebucket_every=4))):
        run = drive("sphere25m", steps=60, facts=facts, **kw)
        k1ms = prof_k1.k1_ms(run["cfg"], mat25, run["state"], reps=10)
        spans[key] = {**run["metrics"], "k1_ms": k1ms}
        log(f"sphere25m {key}: K1 {run['metrics']['launches']} alone on the final state "
            f"{k1ms:.4f} ms | {facts}")
        if key == "span4_every4":
            partition_checks["sphere25m_span4"] = check_partition_kernel(
                run["cfg"], *rebuild_inputs(run["cfg"], run["state"]),
                "sphere25m span-4 final state", facts, reps=3, plain_reps=1)
            k1s4 = check_g2p2g_kernel(run["cfg"], mat25, run["state"], tile_chunk=64,
                                      reps=10, plain_reps=1)
            log_k1("g2p2g_fixed_corotated_span4, sphere25m span-4 state", k1s4, facts)
            k1s4_wide = check_wide(run["cfg"], mat25, run["state"], facts,
                                   "g2p2g_fixed_corotated_span4, sphere25m span-4 state")
        del run
        torch.cuda.empty_cache()
    log("sphere25m span 4 vs span 2 (ms/substep, rebuilds, K1 ms): "
        + ", ".join(f"{k} {v['ms_per_substep']:.3f} / {v['rebuilds']} / {v['k1_ms']:.4f}"
                    for k, v in spans.items()) + f" | {facts}")

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

    # 6b. update_material on the cube; run(auto_grow=True) regrowing the
    #     sphere25m; the stage profile's entry point in a subprocess
    update_material_path(cfgc, matc, posc, v0c, facts)
    regrow = regrow_path(cfg25, mat25, pos25, v0, facts)
    torch.cuda.empty_cache()
    prof_entry = check_prof_stages_entry(facts)

    # 7. main path 2: the 12.1M JFluid dam break, drift-triggered rebuilds
    paths = {"sphere25m": {"launches": launches, "k1_slot_order": k1_order}}
    db = drive("dambreak12m", steps=80, facts=facts)
    if db["metrics"]["rebuilds"] == 0:
        raise AssertionError("dambreak12m: no drift-triggered rebuild fired")
    paths["dambreak12m"] = db["metrics"]
    stages = stage_breakdown(db["cfg"], db["mats"], db["state"])
    log("dambreak12m stages on its final state (ms, median of 10): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f" | {facts}")
    rebucket_checks["dambreak12m"] = check_rebucket_kernel(
        db["cfg"], db["state"].models[0], "dambreak12m final state", facts)
    partition_checks["dambreak12m"] = check_partition_kernel(
        db["cfg"], *rebuild_inputs(db["cfg"], db["state"]), "dambreak12m final state", facts,
        reps=3, plain_reps=1)
    del db
    torch.cuda.empty_cache()

    # 7b. the same path with the incremental rebucket (defrag_every=4: every
    #     4th rebuild, by substep number, a full sort), then the incremental
    #     plan on its final state on the card against the CPU, bit for bit.
    #     An incremental rebuild whose plan would defer movers runs the full
    #     sort instead (``engine.rebucket``); both kinds are timed apart.
    #     Its checks (and 9b's) fail the run at the end, after every other
    #     phase has run
    dbi = drive("dambreak12m", steps=80, facts=facts, strict=False, defrag_every=4)
    failures = {"dambreak12m defrag_every=4": dbi["failed"]} if dbi["failed"] else {}
    m_dbi = dbi["metrics"]
    if m_dbi["rebuilds_incremental"] + m_dbi["rebuilds_fallback"] == 0:
        raise AssertionError("dambreak12m defrag_every=4: no incremental rebuild was timed")
    paths["dambreak12m_incremental"] = dbi["metrics"]
    st = dbi["state"]
    plan = check_incremental_plan(dbi["cfg"], st.models[0])
    if plan["movers"] == 0:       # the last substep rebuilt: one more has movers
        st = dbi["engine"].substep(st, np.float32(1e9))
        plan = check_incremental_plan(dbi["cfg"], st.models[0])
    if plan["movers"] == 0:
        raise AssertionError("dambreak12m: no mover for the card-vs-CPU incremental plan")
    paths["incremental_plan_card_vs_cpu"] = plan
    log(f"incremental_plan on the card == on the CPU, bit for bit, dambreak12m state: "
        f"{plan} | {facts}")
    del dbi, st
    torch.cuda.empty_cache()

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
            k1v[key] = check_g2p2g_kernel(run["cfg"], mat, prof_k1.stir(run["state"]),
                                          tile_chunk=64, reps=10, model_idx=model_idx)
            n_model = int(run["state"].models[model_idx].active.sum())
            log_k1(f"{key}, {name} state, model {model_idx}, {n_model} particles",
                   k1v[key], facts)
        else:
            paths[name].update(scene_stages(run, facts))
        del run

    # 8b. sand, nacc and multimat at span 4 (rebucket_every=4); each
    #     material's span-4 K1 held against its plain version on a stirred
    #     copy of the final state (the plain version timed once)
    for name, steps, model_idx in (("sand", 20, 0), ("nacc", 20, 0), ("multimat", 20, 1)):
        run = drive(name, steps=steps, facts=facts, rebucket_every=4)
        paths[name + "_span4"] = run["metrics"]
        mat = run["mats"][model_idx]
        key = f"g2p2g_{mat.name}_span4"
        stirred = prof_k1.stir(run["state"])
        k1v[key] = check_g2p2g_kernel(run["cfg"], mat, stirred,
                                      tile_chunk=64, reps=10, model_idx=model_idx,
                                      plain_reps=1)
        n_model = int(run["state"].models[model_idx].active.sum())
        label = f"{key}, {name} span-4 state, model {model_idx}, {n_model} particles"
        log_k1(label, k1v[key], facts)
        k1v[key + "_wide"] = check_wide(run["cfg"], mat, stirred, facts, label,
                                        model_idx=model_idx)
        del run, stirred
        torch.cuda.empty_cache()

    # 9. dambreak_sdf: 4.3M JFluid onto the 128^3 SDF dome, 1750 substeps
    #    (0.175 s at dt 1e-4; the fluid enters the dome's band after ~1300);
    #    the plain version probes contact every 125
    contact = {}

    def probe_contact(i, eng, st):
        if (i + 2) % 125 == 0:
            contact[i + 2] = sdf_contact(eng.cfg, st, eng.colliders, plain=True)
            log(f"dambreak_sdf substep {i + 2}: {contact[i + 2]} massive cells "
                f"touched by the dome")

    sdfrun = drive("dambreak_sdf", steps=SDF_STEPS, facts=facts, on_step=probe_contact)
    touched = sdf_contact(sdfrun["cfg"], sdfrun["state"], sdfrun["engine"].colliders)
    paths["dambreak_sdf"] = {**sdfrun["metrics"], "sdf_cells_touched": touched,
                             "contact_by_substep": contact}
    log(f"dambreak_sdf: massive cells whose velocity the dome changes, by "
        f"substep: {contact}; at the end {touched} | {facts}")
    if touched == 0:
        raise AssertionError("dambreak_sdf: the fluid never reached the SDF dome")
    paths["dambreak_sdf"].update(scene_stages(sdfrun, facts))
    rebucket_checks["dambreak_sdf"] = check_rebucket_kernel(
        sdfrun["cfg"], sdfrun["state"].models[0], "dambreak_sdf final state", facts)
    partition_checks["dambreak_sdf"] = check_partition_kernel(
        sdfrun["cfg"], *rebuild_inputs(sdfrun["cfg"], sdfrun["state"]),
        "dambreak_sdf final state", facts, reps=3, plain_reps=1)
    del sdfrun
    torch.cuda.empty_cache()

    # 9b. dambreak_sdf with the incremental rebucket (defrag_every=4)
    sdfi = drive("dambreak_sdf", steps=SDF_STEPS, facts=facts, strict=False, defrag_every=4)
    if sdfi["failed"]:
        failures["dambreak_sdf defrag_every=4"] = sdfi["failed"]
    paths["dambreak_sdf_incremental"] = sdfi["metrics"]
    m_full, m_inc = paths["dambreak_sdf"], sdfi["metrics"]
    log(f"dambreak_sdf rebuilding substeps: full-sort path {m_full['rebuilds']} rebuilds at "
        f"{m_full['ms_rebuilding']:.3f} ms; defrag_every=4 path {m_inc['rebuilds_full']} full "
        f"at {m_inc['ms_rebuilding_full']} ms, {m_inc['rebuilds_incremental']} incremental "
        f"at {m_inc['ms_rebuilding_incremental']} ms, {m_inc['rebuilds_fallback']} incremental "
        f"fallen back to the full sort at {m_inc['ms_rebuilding_fallback']} ms | {facts}")
    del sdfi
    torch.cuda.empty_cache()

    # 10. the CLI, and the CLI on SDF assets with checkpoints and a resume
    run_cli(facts)
    paths["cli_sdf"] = run_cli_sdf(facts)
    paths["prof_rebuild"] = check_prof_rebuild_entry(facts)

    # 10b. the benchmark entry point: sphere25m with its gate, dambreak_sdf
    #      without it, each counting its launches from 0
    bench_runs = check_bench_entry(facts)

    # 11. multiple devices: sphere25m on a 2x2 mesh (overlap on and off),
    #     dambreak12m on 4 x-slabs, a mesh of one on the cube, the CLI on
    #     scenes/cube_4dev.json, validate_scale, DistGroup
    paths.update(multi_paths(facts))

    # 12. config 5: its shard, the 99.6M-particle scene on one device and on
    #     its 4x2 mesh (every shard on the card), the CLI and the frame writes
    paths.update(config5_paths(facts))

    src = "claymore_tpu_torch/csrc/"
    k2_call = "claymore_tpu/ops/pallas_grid.py:192"
    k1_call = "claymore_tpu/ops/pallas_g2p2g.py:783"

    def entry(name, source, replaces, path, check):
        e = {"name": name, "route": "cuda", "source": src + source,
             "replaces": replaces, "launches": paths[path]["launches"][name],
             "max_abs_err": check["max_abs_err"], "ms": check["ms"],
             "plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"],
             "bound_by": check["bound_by"], "library_ms": None}
        # K1 and P2/P3: what the card gives them (kernel_info, laneop_info)
        e.update({k: check[k] for k in ("registers", "blocks_per_sm") if k in check})
        return e

    kernels = [
        entry("grid_update", "grid_update.cu", k2_call, "sphere25m", k2),
        entry("grid_update_colliders", "grid_update.cu", k2_call, "dambreak_hs", k2c),
        entry("grid_update_sdf", "grid_update.cu", k2_call, "dambreak_sdf", k2s),
        entry("g2p2g_fixed_corotated", "g2p2g.cu", k1_call, "sphere25m", k1),
        entry("g2p2g_jfluid", "g2p2g.cu", k1_call, "dambreak12m", k1v["g2p2g_jfluid"]),
        entry("g2p2g_sand", "g2p2g.cu", k1_call, "sand", k1v["g2p2g_sand"]),
        entry("g2p2g_nacc", "g2p2g.cu", k1_call, "nacc", k1v["g2p2g_nacc"]),
    ]
    # K1 at span 4: the TPU kernel refuses span 4, the JAX package runs it on
    # its XLA path; the variant is held against the plain version where the
    # span-2 one is
    paths["sphere25m_span4"] = spans["span4_every4"]
    for name, path, check, wide in (
            ("g2p2g_fixed_corotated_span4", "sphere25m_span4", k1s4, k1s4_wide),
            ("g2p2g_jfluid_span4", "multimat_span4", k1v["g2p2g_jfluid_span4"],
             k1v["g2p2g_jfluid_span4_wide"]),
            ("g2p2g_sand_span4", "sand_span4", k1v["g2p2g_sand_span4"],
             k1v["g2p2g_sand_span4_wide"]),
            ("g2p2g_nacc_span4", "nacc_span4", k1v["g2p2g_nacc_span4"],
             k1v["g2p2g_nacc_span4_wide"])):
        e = entry(name, "g2p2g.cu", k1_call, path, check)
        e["span4_on_the_tpu"] = "claymore_tpu/core/transfer.py:127 (XLA)"
        # tiles the kernel transferred in more than one P2G pass, of those
        # holding particles: on the path's state and on the same with every
        # 4th live tile spread over its arena (held to the plain version too)
        e["wide_tiles"] = {"state": [check["wide_tiles"], check["live_tiles"]],
                           "spread_state": [wide["wide_tiles"], wide["live_tiles"]]}
        e["spread_state"] = {k: wide[k] for k in ("max_abs_err", "pos_err", "field_err",
                                                  "flipped", "active", "ms", "bound_ms")}
        kernels.append(e)
    paths["sphere25m_spans"] = spans
    # the multi-device paths' launches; K1 on the tile ranges of the split
    multi_k1 = {"g2p2g_fixed_corotated": ("multi_sphere25m_2x2",
                                          "multi_sphere25m_2x2_no_overlap", "multi_cube_mesh1",
                                          "multi_config5_4x2"),
                "g2p2g_jfluid": ("multi_dambreak12m_4x1",)}
    for e in kernels:
        if e["name"] == "grid_update":
            e["launches_multi"] = {p: paths[p]["launches"]["grid_update"]
                                   for p in (*multi_k1["g2p2g_fixed_corotated"],
                                             *multi_k1["g2p2g_jfluid"])}
        if e["name"] in multi_k1:
            e["launches_multi"] = {p: paths[p]["launches"][e["name"]]
                                   for p in multi_k1[e["name"]]}
    kernels[3]["tile_range"] = {
        "split": [bt25, nt25], **{k: k1r[k] for k in ("max_abs_err", "ms", "bound_ms",
                                                      "pos_err")}}
    kernels[4]["tile_range"] = paths["multi_dambreak12m_4x1"]["k1_tile_range"]
    # config 5: K1 held to its plain version on its shard's state and on the
    # fullest shard of the 4x2 mesh (tiles of 256, as on one device); K1 and K2
    # timed beside their bounds on the one-device scene's final state; their
    # launches on the shard, the one-device and the 4x2 paths
    c5s, c5 = paths["config5_shard"], paths["config5_one_device"]
    c5_launches = {p: paths[p]["launches"] for p in ("config5_shard", "config5_one_device",
                                                     "multi_config5_4x2")}
    kernels[3]["config5"] = {
        "shard": {k: c5s["k1"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "pos_err", "active")},
        "mesh_shard": paths["multi_config5_4x2"]["k1_shard"],
        "one_device": c5["k1"],
        "launches": {p: v["g2p2g_fixed_corotated"] for p, v in c5_launches.items()}}
    kernels[0]["config5"] = {
        "one_device": c5["k2"],
        "launches": {p: v["grid_update"] for p, v in c5_launches.items()}}
    if min(v for e in kernels for v in e.get("launches_multi", {}).values()) <= 0:
        raise AssertionError(f"a kernel was not launched on a multi-device path: {kernels}")
    # the collider kernels' cull and their straddle pools
    for e, check, straddle in ((kernels[1], k2c, k2c_straddle), (kernels[2], k2s, k2s_straddle)):
        e["culled_share"] = check["culled_share"]
        e["straddle"] = {k: straddle[k] for k in ("ms", "plain_ms", "max_abs_err", "bound_ms",
                                                  "culled_share")}
    paths["probes"] = paths_probe
    paths["regrow"] = regrow
    paths["prof_stages25m"] = prof_entry

    def probe_entry(name, source, replaces, check):
        e = entry(name, source, replaces, "probes", check)
        e["library_ms"] = check["library_ms"]
        return e

    kernels += [probe_entry(name, "prof_laneops.cu", call, lane[name])
                for name, (_, _, call) in LANEOPS.items()]
    # P5 and P6 at the TPU script's first configuration, (8192, 4, 9) and
    # (4096, 4, 9); the other configurations are in the log above.  Their
    # registers and blocks per SM are those of the sub-kernel that moves most
    # of the bytes there (the window sums, the gather, the row stream)
    main_sub = {"two_pass": "window", "direct": "gather"}
    for name, check in (("dma_gather", dma["dma_gather"][0]),
                        ("dma_gather_ring", dma["dma_gather_ring"][0]),
                        ("rmw", dma["rmw"][0])):
        e = probe_entry(name, "prof_dma.cu", P6_CALL if name == "rmw" else P5_CALL, check)
        sub = dma_subs[name]["stream" if name == "rmw" else main_sub[check["plan"]]]
        e.update({k: sub[k] for k in ("registers", "blocks_per_sm")})
        e["sub_kernels"] = dma_subs[name]
        e["ms_batch10"] = check["ms_batch10"]
        if name != "rmw":
            e["plan"] = check["plan"]
        kernels.append(e)
    # the rebucket kernels: not TPU kernels (the JAX package runs the stage
    # in XLA); times on the sphere25m final state, every state's checks
    # beside them, and their launches on the other paths
    rebucket_checks["multi_sphere25m_2x2_shard0"] = paths["multi_sphere25m_2x2"]["rebucket"]
    rb = rebucket_checks["sphere25m"]
    for name, stage in zip(REBUCKET_KERNELS, ("keys", "heads", "plan", "place")):
        e = {"name": name, "route": "cuda", "source": src + "rebucket.cu",
             "replaces": "claymore_tpu/core/partition.py:83",
             "tpu_route": "not a TPU kernel: XLA in the JAX package (sort_permute's lax.sort "
                          "carrying every channel, searchsorted, window slices)",
             "launches": paths["sphere25m"]["launches"][name],
             "max_abs_err": max(c["max_abs_err"] for c in rebucket_checks.values()),
             "ms": rb["stages"][stage]["ms"], "plain_ms": rb["stages"][stage]["plain_ms"],
             "bound_ms": rb["stages"][stage]["bound_ms"], "bound_by": "bytes",
             "library_ms": None,
             "states": {k: {"slots": c["slots"], "dropped": c["dropped"],
                            "ms": c["stages"][stage]["ms"],
                            "bound_ms": c["stages"][stage]["bound_ms"]}
                        for k, c in rebucket_checks.items()},
             "launches_paths": {p: paths[p]["rebucket_launches"][name]
                                for p in ("dambreak12m", "dambreak_sdf",
                                          "dambreak12m_incremental")}}
        e["launches_paths"]["config5_one_device"] = paths["config5_one_device"]["launches"][name]
        e["launches_paths"]["multi_sphere25m_2x2"] = (
            paths["multi_sphere25m_2x2"]["launches"][name])
        if stage == "keys":
            e["sort_permute"] = {k: rb[k] for k in ("ms", "plain_ms", "bound_ms",
                                                    "sort_bound_ms", "beyond_sort_ms",
                                                    "share")}
        kernels.append(e)
    paths["rebucket_checks"] = rebucket_checks
    # the partition kernels: not TPU kernels either (XLA in the JAX
    # package); times on the sphere25m final state's stale rebuild (the
    # compaction there: the oct flags into the partition's capacity), every
    # state's checks beside them, first_marked also at a config-5 mesh
    # shard's migration shape, and their launches on the other paths
    partition_checks["multi_sphere25m_2x2_shard0"] = paths["multi_sphere25m_2x2"]["partition"]
    partition_checks["config5_one_device"] = paths["config5_one_device"]["partition"]
    pinfo = partition_kernel.kernel_info()
    log(f"partition sub-kernels (registers, blocks per SM): {pinfo} | {facts}")
    pc = partition_checks["sphere25m"]
    jax_part = "claymore_tpu/core/partition.py"
    for name, replaces, sub in (
            ("first_marked", f"{jax_part}:448", "write"),
            ("oct_mask", f"{jax_part}:401", "mass"),
            ("remap", f"{jax_part}:401", "rows"),
            ("finalize_tiles", f"{jax_part}:353", "finalize")):
        e = {"name": name, "route": "cuda", "source": src + "partition.cu",
             "replaces": replaces,
             "tpu_route": "not a TPU kernel: XLA in the JAX package (rebuild's mask, "
                          "jnp.nonzero(size=, fill_value=), table scatter and row gather; "
                          "finalize_tiles)",
             "launches": paths["sphere25m"]["launches"][name],
             "max_abs_err": max([c["max_abs_err"] for c in partition_checks.values()]
                                + [c["max_abs_err"] for c in first_marked_checks.values()]),
             "ms": pc["ms"][name], "plain_ms": pc["plain_ms"][name],
             "bound_ms": pc["bound_ms"][name], "bound_by": "bytes",
             "library_ms": pc["library_ms"] if name == "first_marked" else None,
             **pinfo[sub],
             "states": {k: {"octs": c["octs"], "overflow": c["overflow"],
                            "ms": c.get("ms", {}).get(name),
                            "bound_ms": c.get("bound_ms", {}).get(name)}
                        for k, c in partition_checks.items()},
             "launches_paths": {p: paths[p]["partition_launches"][name]
                                for p in ("dambreak12m", "dambreak_sdf",
                                          "dambreak12m_incremental")}}
        for p in ("config5_one_device", "multi_sphere25m_2x2", "multi_dambreak12m_4x1",
                  "multi_config5_4x2"):
            e["launches_paths"][p] = paths[p]["launches"][name]
        if name == "first_marked":
            e["mesh_migration_shape"] = first_marked_checks
            e["sub_kernels"] = {k: pinfo[k] for k in ("count", "scan", "write", "fill")}
        if name == "oct_mask":
            e["sub_kernels"] = {k: pinfo[k] for k in ("base", "mass", "tiles")}
        if name == "remap":
            e["sub_kernels"] = {k: pinfo[k] for k in ("count", "scan", "write_table", "fill",
                                                      "rows")}
            e["rebuild+finalize"] = {k: pc[k]["rebuild+finalize"]
                                     for k in ("ms", "plain_ms", "bound_ms")}
            e["device_ops"] = paths["prof_rebuild"]["device_ops"]
        kernels.append(e)
    paths["partition_checks"] = partition_checks
    # the halo kernels: not TPU kernels (XLA inside shard_map in the JAX
    # package); times on config 5's 4x2 final state (its fullest shard),
    # every state's checks beside them, and their launches on every mesh
    # path with a neighbour (config 5's 4x2 the main one)
    halo_checks = {"config5_4x2": paths["multi_config5_4x2"]["halo"],
                   "sphere25m_2x2": paths["multi_sphere25m_2x2"]["halo"],
                   "sphere25m_2x2_overflowing": paths["multi_sphere25m_2x2"]["halo_overflowing"]}
    hinfo = halo_kernel.kernel_info()
    log(f"halo sub-kernels (registers, blocks per SM): {hinfo} | {facts}")
    hc = halo_checks["config5_4x2"]
    jax_multi = "claymore_tpu/parallel/multi.py"
    for name, replaces, sub, what in (
            ("halo_pack", f"{jax_multi}:220", "rows", "_pack_window and exchange_halo's "
             "window tests: jnp.nonzero(size=), a row gather, a lane-mask multiply"),
            ("halo_mask", f"{jax_multi}:307", "mask", "halo_mass_mask: .at[].max"),
            ("halo_add", f"{jax_multi}:325", "add", "add_halo: .at[].add"),
            ("migrate_pack", f"{jax_multi}:378", "migrate_count", "migrate's _pack: "
             "home_block, jnp.nonzero(size=), payload gathers")):
        e = {"name": name, "route": "cuda", "source": src + "halo.cu", "replaces": replaces,
             "tpu_route": f"not a TPU kernel: XLA inside shard_map in the JAX package ({what})",
             "launches": paths["multi_config5_4x2"]["launches"][name],
             "max_abs_err": max(c["max_abs_err"] for c in halo_checks.values()),
             "ms": hc["ms"][name], "plain_ms": hc["plain_ms"][name],
             "bound_ms": hc["bound_ms"][name], "bound_by": "bytes",
             "library_ms": hc["library_ms"].get(name), **hinfo[sub],
             "states": {k: {f: c.get(f, {}).get(name) if f in ("ms", "bound_ms") else c[f]
                            for f in ("ms", "bound_ms", "overflow", "dropped")}
                        for k, c in halo_checks.items()},
             "launches_paths": {p: paths[p]["launches"][name]
                                for p in ("multi_sphere25m_2x2", "multi_sphere25m_2x2_no_overlap",
                                          "multi_dambreak12m_4x1", "multi_config5_4x2")}}
        if name == "halo_add":
            e["states"]["sphere25m_2x2"]["library_ms"] = (
                halo_checks["sphere25m_2x2"]["library_ms"]["halo_add"])
        kernels.append(e)
    paths["halo_checks"] = halo_checks
    if min(v for e in kernels for v in e.get("launches_paths", {}).values()) <= 0:
        raise AssertionError(f"a kernel was not launched on one of its paths: {kernels}")
    if min(k["launches"] for k in kernels) <= 0:
        raise AssertionError(f"a kernel was not launched on its main path: {kernels}")
    # the benchmark entry point's launches, by scene, on K1's and K2's rows
    for scene_name, _, _, k2, k1 in BENCH_RUNS:
        for e in kernels:
            if e["name"] in (k2, k1):
                e.setdefault("launches_bench", {})[scene_name] = (
                    bench_runs[scene_name]["launches"][e["name"]])
    if min(v for e in kernels for v in e.get("launches_bench", {}).values()) <= 0:
        raise AssertionError(f"a kernel was not launched by the benchmark entry point: "
                             f"{kernels}")
    paths["bench"] = bench_runs
    log(f"paths: {json.dumps(paths)}")
    log(f"whole script: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    if failures:
        raise AssertionError(f"main paths failed their checks: {failures}")
    print(facts)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
