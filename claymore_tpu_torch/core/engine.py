"""Simulation orchestrator: one device, or the shards of a mesh this process
holds (with ``parallel/multi.py``'s comm hook).

Port of ``claymore_tpu/core/engine.py``: ``init_impl`` builds the partition,
tiles and rasterized grid; ``substep_impl`` runs one explicit MPM substep,
grid update (CUDA kernel K2) -> CFL step -> fused G2P2G (CUDA kernel K1,
which also returns the drift margin) -> drift check -> rebucket when
needed (the full sort's keys, slot plan and placement as CUDA kernels,
``ops/rebucket_kernel.py``).  On CPU tensors the kernel wrappers run
their plain PyTorch versions, which is how the tests hold the port
against the JAX package.

PyTorch runs eagerly, so the JAX package's on-device ``lax.while_loop``
frame loop becomes a host loop over substeps.  Several materials share one
pool: each model's transfer accumulates into the same next pool.  ``dt``, ``next_dt``,
``max_vel`` and ``t`` stay 0-d device tensors that the kernels read through
pointers.  The host synchronises with the device at exactly these points:

* ``substep_impl``: reading the rebuild decision, once per substep
  (``margin <= drift * safety`` under ``rebucket_auto``, or the step count
  for a fixed cadence of 2..8), and on a rebuilding substep with
  ``defrag_every > 1`` the step count, for the choice between the full sort
  and the incremental plan, and after an incremental plan its deferred
  counts, for the fall-back to the full sort; over several shards it reads
  every shard's decision in one read, and on a substep where some shards
  rebuild and others do not, whether migrants reached each shard;
* ``MPMEngine.run_frame``: the loop test ``t < frame_end`` and the substep
  cap, once per substep;
* ``run`` / ``check_health`` / ``diagnostics`` / ``get_positions``: once per
  call; with ``run(..., auto_grow=True)`` the growth test reads the
  occupancy counters once per frame, and ``regrow`` (at most once per
  frame) unites the oct keys and sizes the tiles on the host.

Under ``torch.profiler`` the substep marks its stages, a rebuild's steps
and each of these host reads with ``claymore.*`` ranges
(``utils/timers.py:span``; ``claymore.sync.<site>`` spans a read alone).
``profile_stages`` times the stages of a substep; ``update_material``
returns an engine with new material parameters.  Capturing substeps into
CUDA graphs would remove the per-launch host cost; that is later work.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import SimConfig
from ..models.boundary import check_colliders
from ..models.materials import Material
from ..ops import g2p2g_kernel, grid_kernel, partition_kernel, rebucket_kernel
from ..utils.timers import device_ms, span
from . import grid as grid_ops
from . import partition as part
from . import transfer
from .types import Partition, ParticleModel, SimState


def exact_tiles(cfg: SimConfig, raw_positions, slack: float = 1.3) -> int:
    """Tile capacity sized from actual particle positions: per-block tile
    needs, summed per home oct and padded to group multiples (the tile
    plan's two-level padding), times a drift slack.  Undersized capacity
    surfaces through the TileMap.dropped counter."""
    g = cfg.grid_size
    gt = cfg.group_tiles
    need = 0
    for raw in raw_positions:
        raw = np.asarray(raw, np.float32)
        if raw.size == 0:
            continue
        # int32 throughout: a block key is below 2**30 (SimConfig), and at
        # 100M particles int64 arrays cost the host more than the sort
        base = np.floor(raw * cfg.dx_inv + 0.5).astype(np.int32) - 1
        hb = (base - 1) >> cfg.block_bits
        keys = (hb[:, 0] * g + hb[:, 1]) * g + hb[:, 2]
        sk = np.sort(keys)
        newblk = np.r_[True, sk[1:] != sk[:-1]]
        starts = np.flatnonzero(newblk)
        counts = np.diff(np.r_[starts, sk.size])
        tiles = -(-counts // cfg.particle_tile)
        okeys = sk[starts] >> 3
        oid = np.cumsum(np.r_[0, okeys[1:] != okeys[:-1]])
        osum = np.bincount(oid, weights=tiles).astype(np.int64)
        padded = int((-(-osum // gt) * gt).sum())
        need = max(need, padded)
    return int(np.ceil(need * slack / gt) * gt) + gt


def empty_partition(cfg: SimConfig, device) -> Partition:
    i32 = dict(dtype=torch.int32, device=device)
    return Partition(
        table=torch.full((cfg.num_oct_keys + 1,), cfg.null_oct, **i32),
        keys=torch.full((cfg.max_active_octs,), cfg.num_oct_keys, **i32),
        count=torch.zeros((1,), **i32),
        overflow=torch.zeros((1,), **i32),
    )


def init_impl(cfg: SimConfig, materials, tile_counts, tile_chunk: int,
              pos_tuple, active_tuple, v0_tuple, region_fn=None,
              pid_tuple=None) -> SimState:
    """Initial setup: partition + tiles + rasterized grid.

    ``pos_tuple[i]`` is [3, S_i] with S_i = tile_counts[i] * particle_tile
    (slot capacity); padding lanes are marked inactive in ``active_tuple``.
    ``pid_tuple[i]`` (i32[S_i]) numbers the active slots; by default a
    particle's id is its slot.  ``region_fn`` is ``sort_permute``'s.
    """
    dev = pos_tuple[0].device
    pool = torch.zeros((cfg.max_active_octs + 1, 16, 128), dtype=torch.float32,
                       device=dev)
    permuted, tile_keys, droppeds = [], [], []
    for i, (mat, pos, active, nt) in enumerate(zip(materials, pos_tuple, active_tuple,
                                                   tile_counts)):
        s_cap = pos.shape[1]
        if s_cap != nt * cfg.particle_tile:
            raise ValueError(f"slot capacity {s_cap} != {nt} tiles")
        ids = (torch.arange(s_cap, dtype=torch.int32, device=dev) if pid_tuple is None
               else pid_tuple[i])
        raw = ParticleModel(
            pos=pos, fields=mat.init_fields(s_cap, dev), active=active,
            pid=torch.where(active, ids, torch.full_like(ids, s_cap)),
            tiles=None)
        pm, tk, dr = rebucket_kernel.sort_permute(cfg, raw, nt, region_fn)
        permuted.append(pm)
        tile_keys.append(tk)
        droppeds.append(dr)
    partition, pool = partition_kernel.rebuild(cfg, pool, empty_partition(cfg, dev),
                                               tuple(tile_keys))
    models = []
    for mat, pm, tk, dr, v0 in zip(materials, permuted, tile_keys, droppeds,
                                   v0_tuple):
        pm.tiles = partition_kernel.finalize_tiles(cfg, partition, tk, dr)
        models.append(pm)
        pool = transfer.rasterize_model(
            cfg, mat, partition.table, pm,
            torch.tensor(v0, dtype=torch.float32, device=dev), pool, tile_chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    return SimState(
        grid=pool, partition=partition, models=tuple(models),
        dt=torch.tensor(cfg.default_dt, **f32),
        max_vel=torch.zeros((), **f32),
        t=torch.zeros((), **f32),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mig_dropped=torch.zeros((1,), dtype=torch.int32, device=dev),
        halo_overflow=torch.zeros((1,), dtype=torch.int32, device=dev),
    )


def full_rebuild(cfg: SimConfig, step) -> bool:
    """Whether the rebuild at the end of substep ``step`` (0-based, an int
    or a 0-d tensor, read only when ``defrag_every > 1``) runs the full
    sort: always when ``defrag_every <= 1``, else every ``defrag_every``-th
    rebuild counted as ``(step + 1) // rebucket_every`` (under
    ``rebucket_auto`` that count is the substep number, as in the JAX
    package)."""
    if cfg.defrag_every <= 1:
        return True
    with span("claymore.sync.defrag"):
        step = int(step)
    return ((step + 1) // max(cfg.rebucket_every, 1)) % cfg.defrag_every == 0


def rebucket(cfg: SimConfig, pool: torch.Tensor, partition: Partition, models,
             full: bool = True, region_fn=None, extra_mask=None, stale: bool = False):
    """Rebucket every model's particles, recompute the active oct set and
    remap the pool.  ``full``: the full sort into new tiles (with
    ``sort_permute``'s ``region_fn``); else the
    incremental plan, which moves only the particles that changed home
    block.  ``stale``: keep every particle where it is and rebuild only the
    partition (the multi-device engine's substeps without a rebucket);
    ``extra_mask`` is ``partition_kernel.rebuild``'s.  A model whose plan would defer movers (past the mover capacity
    or past the free tiles) takes the full sort instead: a deferred mover
    stays in a tile of another block, and once it drifts out of that
    tile's arena it is lost (the JAX package keeps the deferral and loses
    them).  Reading the deferred counts is one host synchronisation.

    Returns (partition, pool, models, kind, deferred): ``kind`` is "full",
    "stale", "incremental" or "fallback" (some model's plan deferred and it
    took the full sort), ``deferred`` the movers each model's plan would
    have deferred (empty for "full" and "stale")."""
    if stale:
        with span("claymore.rebuild.incremental"):
            plans = [(dataclasses.replace(m), part.tile_block_keys(cfg, m.tiles),
                      m.tiles.dropped) for m in models]
        kind, deferred = "stale", []
    elif full:
        plans = [rebucket_kernel.sort_permute(cfg, m, m.tiles.block.shape[0], region_fn)
                 for m in models]
        kind, deferred = "full", []
    else:
        with span("claymore.rebuild.incremental"):
            plans = [part.incremental_plan(cfg, m, part.tile_block_keys(cfg, m.tiles))
                     for m in models]
            counts = torch.cat([dr for _, _, dr in plans])
        with span("claymore.sync.deferred"):
            deferred = [int(d) for d in counts.tolist()]
        plans = [rebucket_kernel.sort_permute(cfg, m, m.tiles.block.shape[0]) if d > 0 else plan
                 for m, plan, d in zip(models, plans, deferred)]
        kind = "fallback" if max(deferred) > 0 else "incremental"
    with span("claymore.rebuild.partition"):
        partition, pool = partition_kernel.rebuild(cfg, pool, partition,
                                                   tuple(tk for _, tk, _ in plans), extra_mask)
    with span("claymore.rebuild.tiles"):
        for pm, tk, dr in plans:
            pm.tiles = partition_kernel.finalize_tiles(cfg, partition, tk, dr)
    return partition, pool, tuple(pm for pm, _, _ in plans), kind, deferred


def clone_state(x):
    """A deep copy of a state (or any of its parts): every tensor cloned on
    its device."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: clone_state(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: clone_state(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(clone_state(v) for v in x)
    return x


def time_state_loop(fn, state: SimState, iters: int, reps: int, device) -> float:
    """Milliseconds per call of ``fn``, a state -> state function, run
    ``iters`` times back to back: the best of ``reps`` runs after one
    warm-up run (CUDA events on a card, the host clock on the CPU).

    Each run starts from its own copy of ``state``, made before the clock
    starts; ``state`` itself is never passed to ``fn``.  The copy is handed
    over as the only reference, so each call frees its input once it
    returns, and the run's output is freed before the next copy is made: at
    most ``state``, one input and one output are live (the JAX package
    donates its copies for the same reason, a 25M state being several
    GiB)."""
    dev = torch.device(device)

    def run(box):
        s = box.pop()
        for _ in range(iters):
            s = fn(s)

    best = float("inf")
    for rep in range(reps + 1):
        box = [clone_state(state)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = device_ms(lambda: run(box), dev)
        if rep:
            best = min(best, ms)
    return best / iters


def substep_impl(cfg: SimConfig, materials, colliders, tile_chunk: int, states,
                 frame_end, collider_tables=None, sdf_pointers=None, comm=None,
                 on_stage=None):
    """One explicit MPM substep of every shard this process holds.

    ``states`` is a tuple of shard states (``MPMEngine`` passes one), and
    ``frame_end``, ``collider_tables`` and ``sdf_pointers`` are tuples over
    them: the colliders are posed at each shard's start time ``t``, and the
    tables are their packed form and the addresses of their SDF node tables
    for the CUDA grid kernel (``grid_kernel.pack_colliders``,
    ``sdf_table_pointers``), made once per engine.  Returns (new states,
    rebuilt): ``rebuilt[j]`` is None, or ``rebucket``'s (kind, deferred) on
    a shard that rebucketed.

    ``comm`` is the multi-device hook (``parallel/multi.py:HaloComm``).  Its
    stages run only when it is live, on a mesh where some shard has a
    neighbour (``comm.trivial`` has none, and takes the one-device
    pipeline), as in the JAX package:

    1. K2 per shard; ``comm.reduce_max`` of max|v|^2 over every shard, so
       all shards take the same dt.
    2. K1 per shard.  Under the transfer split (``comm.overlap`` and
       ``defrag_every == 1``) the tiles run in two launches: the boundary
       prefix [0, bt) (``sort_permute``'s region), then the halo exchange
       is issued (on a side stream per shard on a card), then the interior
       [bt, T) runs while it is in flight.  Boundary tiles past the prefix
       are counted in ``halo_overflow``, as are octs past
       ``halo_capacity``.  Without the split the exchange follows K1.
    3. The rebuild decision of every shard, read in one host
       synchronisation.  ``comm.migrate`` ships the particles that left
       their shard's slab on the shards that rebuild, and a shard that
       received any rebuilds too (one more read, on substeps where some
       shards rebuild and others do not).
    4. A shard rebuckets when its decision says so.  Under a live comm every
       shard rebuilds its partition every substep, with the blocks its
       neighbours sent mass into (``comm.halo_mass_mask``), and the rest
       keep their tiles; ``comm.add_halo`` then adds the neighbours' rows
       into the new pool.

    Each stage runs inside a ``claymore.*`` range (``utils/timers.py:span``)
    while ``torch.profiler`` records.  ``on_stage(name)``, when given, is
    called as each stage's range closes, its work queued for every shard
    (``chip_smoke.py`` records CUDA events there): "K2", "reduce_max", "K1"
    (or "K1 boundary", "exchange issued", "K1 interior" under the split;
    "exchange issued" after "K1" under a live comm without it), "decision",
    "migrate", "mask", "rebuild", "add_halo"; the comm's stages only under
    a live comm."""
    n = len(states)
    collider_tables = collider_tables or (None,) * n
    sdf_pointers = sdf_pointers or (None,) * n
    comm_live = comm is not None and not comm.trivial
    n3 = cfg.grid_size ** 3
    with span("claymore.k2", on_stage, "K2"):
        grid_out = [grid_kernel.grid_update(cfg, s.grid, s.partition, s.dt, colliders, s.t,
                                            collider_tables[j], sdf_pointers[j])
                    for j, s in enumerate(states)]
        pool_vs = [pv for pv, _ in grid_out]
        max_vel_sqr = [mv for _, mv in grid_out]
        del grid_out
    if comm_live:
        with span("claymore.reduce_max", on_stage, "reduce_max"):
            max_vel_sqr = comm.reduce_max(max_vel_sqr)
    with span("claymore.dt"):
        t_after = [s.t + s.dt for s in states]
        next_dt = [grid_ops.compute_dt(cfg, mv, ta, fe)
                   for mv, ta, fe in zip(max_vel_sqr, t_after, frame_end)]

    split = comm_live and comm.overlap and cfg.defrag_every == 1
    halo_overflow = [s.halo_overflow for s in states]
    mig_dropped = [s.mig_dropped for s in states]
    margins = [None] * n
    models = [[None] * len(materials) for _ in states]

    def transfer(j, mi, tile_range=None):
        # each transfer returns its output's arena_margin (the kernel
        # computes it in its epilogue); two ranges write into one output
        s = states[j]
        models[j][mi], next_pools[j], m = g2p2g_kernel.g2p2g(
            cfg, materials[mi], pool_vs[j], s.partition.table, s.models[mi], s.dt,
            next_dt[j], next_pools[j], tile_chunk, tile_range, models[j][mi])
        margins[j] = m if margins[j] is None else torch.minimum(margins[j], m)

    bts = [[m.tiles.tvalid.shape[0] for m in s.models] for s in states]
    if split:
        with span("claymore.k1.boundary", on_stage, "K1 boundary"):
            next_pools = [torch.zeros_like(s.grid) for s in states]
            mult = math.lcm(cfg.group_tiles, tile_chunk)
            for j, s in enumerate(states):
                for mi, model in enumerate(s.models):
                    tcount = bts[j][mi]
                    bt = bts[j][mi] = comm.boundary_tile_cap(tcount, mult)
                    if bt < tcount:
                        # boundary tiles past the prefix would ship incomplete
                        # window rows: count them
                        tk = part.flatten_key(cfg, model.tiles.bcoord[:, bt:])
                        bad = model.tiles.tvalid[bt:] & comm.is_boundary_key(
                            torch.clamp(tk, max=n3 - 1), comm.shards[j])
                        halo_overflow[j] = halo_overflow[j] + bad.sum(dtype=torch.int32).reshape(1)
                    transfer(j, mi, (0, bt))
    else:
        with span("claymore.k1", on_stage, "K1"):
            next_pools = [torch.zeros_like(s.grid) for s in states]
            for j in range(n):
                for mi in range(len(materials)):
                    transfer(j, mi)
    if comm_live:
        with span("claymore.exchange", on_stage, "exchange issued"):
            received, overflow = comm.exchange_halo(next_pools, [s.partition for s in states])
            halo_overflow = [h + o for h, o in zip(halo_overflow, overflow)]
    if split:
        with span("claymore.k1.interior", on_stage, "K1 interior"):
            for j, s in enumerate(states):
                for mi, model in enumerate(s.models):
                    transfer(j, mi, (bts[j][mi], model.tiles.tvalid.shape[0]))
    del pool_vs

    with span("claymore.decision", on_stage, "decision"):
        if cfg.rebucket_auto:
            # rebuild when the next advection could push some particle past its
            # tile's arena bound (margin on the advected positions, stale tiles)
            flags = [m <= ndt * torch.sqrt(mv) * cfg.dx_inv * cfg.rebucket_safety + 1e-3
                     for m, ndt, mv in zip(margins, next_dt, max_vel_sqr)]
            if comm_live:
                do_rebuild = comm.read_flags(flags)
            else:
                with span("claymore.sync.decision"):
                    do_rebuild = [bool(f) for f in flags]
        elif cfg.rebucket_every == 1:
            do_rebuild = [True] * n
        else:
            with span("claymore.sync.cadence"):
                step = int(states[0].step)
            do_rebuild = [(step + 1) % cfg.rebucket_every == 0] * n
    extra = [None] * n
    if comm_live:
        with span("claymore.migrate", on_stage, "migrate"):
            models, drop, arrived = comm.migrate(models, do_rebuild)
            mig_dropped = [md + d for md, d in zip(mig_dropped, drop)]
            if not all(do_rebuild) and (comm.group.dense or any(do_rebuild)):
                # a shard that received migrants rebuilds, so they are sorted
                # into tiles of their own blocks (the JAX package leaves them in
                # free slots of other tiles, whose next transfer drops them)
                do_rebuild = [d or a for d, a in
                              zip(do_rebuild, comm.read_flags(arrived, "arrived"))]
        with span("claymore.mask", on_stage, "mask"):
            comm.wait_halo()
            extra = [comm.halo_mass_mask(r) for r in received]

    with span("claymore.rebuild", on_stage, "rebuild"):
        full = any(do_rebuild) and full_rebuild(cfg, states[0].step)
        rebuilt, planned = [], []
        for j, s in enumerate(states):
            partition, pool, new_models = s.partition, next_pools[j], tuple(models[j])
            if do_rebuild[j] or comm_live:
                # under a live comm the partition must hold this substep's halo
                # blocks (add_halo drops rows of blocks it lacks): only the
                # particle sort waits for the decision
                region = (functools.partial(comm.is_boundary_key, shard=comm.shards[j])
                          if split else None)
                partition, pool, new_models, kind, deferred = rebucket(
                    cfg, pool, partition, new_models, full=full, region_fn=region,
                    extra_mask=extra[j], stale=not do_rebuild[j])
            rebuilt.append((kind, deferred) if do_rebuild[j] else None)
            planned.append((partition, pool, new_models))
            # drop this shard's pre-rebuild particles and pool before the next
            # shard sorts: on a mesh held in one process the peak then holds one
            # shard's copies, not every shard's
            models[j] = next_pools[j] = None
    if comm_live:
        with span("claymore.add_halo", on_stage, "add_halo"):
            for j, (partition, pool, new_models) in enumerate(planned):
                planned[j] = (partition, comm.add_halo(pool, partition, received[j]),
                              new_models)
                received[j] = None
    out = tuple(SimState(
        grid=pool, partition=partition, models=new_models, dt=next_dt[j],
        max_vel=torch.sqrt(max_vel_sqr[j]), t=t_after[j], step=s.step + 1,
        mig_dropped=mig_dropped[j], halo_overflow=halo_overflow[j])
        for j, (s, (partition, pool, new_models)) in enumerate(zip(states, planned)))
    return out, tuple(rebuilt)


def health_check(states, strict: bool = True) -> None:
    """Raise on divergence; raise (or warn) on the silent-loss counters,
    summed over ``states`` (one state, or the shards of a multi-device
    state): partition overflow, particles dropped from the tiles, particles
    lost to the migration capacity and halo octs past the halo capacity
    (the JAX package's ``MultiChipEngine.check_health`` messages)."""
    import warnings

    t = float(states[0].t)
    max_vel = float(states[0].max_vel)
    if not np.isfinite(t) or not np.isfinite(max_vel):
        raise FloatingPointError(
            f"simulation diverged: t={t}, max_vel={max_vel} at step "
            f"{int(states[0].step)} (NaN/inf velocity — reduce dt or stiffness)")

    def total(get):
        return sum(int(get(s).sum()) for s in states)

    msgs = []
    overflow = total(lambda s: s.partition.overflow)
    if overflow > 0:
        msgs.append(f"partition overflow: {overflow} active blocks beyond "
                    "max_active_blocks")
    for i in range(len(states[0].models)):
        d = total(lambda s: s.models[i].tiles.dropped)
        if d > 0:
            msgs.append(f"model {i}: {d} particles dropped (tile capacity)")
    md = total(lambda s: s.mig_dropped)
    if md > 0:
        msgs.append(f"{md} particles lost to migration capacity")
    ho = total(lambda s: s.halo_overflow)
    if ho > 0:
        msgs.append(f"{ho} halo octs beyond halo_capacity (mass leaked)")
    if msgs:
        msg = "; ".join(msgs) + " — increase capacities"
        if strict:
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


class MPMEngine:
    """One engine = (config, materials, colliders) on one device.

    ``device`` has no default: a CUDA device runs the kernels, a CPU device
    their plain PyTorch versions, and asking for CUDA without a card raises.
    Colliders are ``models/boundary.py``'s (analytic and SDF grid), resolved
    in list order; on a CUDA device their packed table and the SDF node
    tables are uploaded here, once, and a list longer than the grid kernel
    takes (``grid_kernel.max_colliders``) raises.  ``substeps`` counts the
    substeps run, ``rebuilds`` those that rebucketed, ``fallbacks`` those of
    them whose incremental plan deferred movers and so ran the full sort,
    and ``last_rebuild`` is the latest rebuild's (kind, deferred) from
    ``rebucket``: host counts, no device read.
    """

    def __init__(self, cfg: SimConfig, materials: Sequence[Material],
                 colliders: Sequence = (), tile_chunk: int = 32, *, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        check_colliders(colliders)
        self.cfg = cfg
        self.materials = tuple(materials)
        self.colliders = tuple(colliders)
        on_card = bool(self.colliders) and self.device.type == "cuda"
        if on_card:
            grid_kernel.check_collider_count(len(self.colliders))
        self._collider_table = (
            grid_kernel.pack_colliders(self.colliders, self.device)
            if on_card else None)
        self._sdf_pointers = (
            grid_kernel.sdf_table_pointers(self.colliders, self.device)
            if on_card else None)
        self.tile_chunk = tile_chunk
        self.substeps = 0
        self.rebuilds = 0
        self.fallbacks = 0
        self.last_rebuild = None
        self._num_tiles: List[int] = []

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def _round_tiles(self, n_particles: int, raw=None) -> int:
        if self.cfg.max_tiles:
            t = self.cfg.max_tiles
        elif raw is not None:
            t = exact_tiles(self.cfg, [raw])
        else:
            t = self.cfg.tiles_for(n_particles)
        c = max(self.tile_chunk, self.cfg.group_tiles)
        return -(-t // c) * c

    def init_state(self, model_positions: Sequence[np.ndarray],
                   model_velocities: Optional[Sequence] = None) -> SimState:
        """Build the initial state from [N, 3] numpy positions per model."""
        if len(model_positions) != len(self.materials):
            raise ValueError("one position array per material expected")
        if model_velocities is None:
            model_velocities = [(0.0, 0.0, 0.0)] * len(self.materials)
        positions, actives = [], []
        self._num_tiles = []
        for raw in model_positions:
            raw = np.asarray(raw, np.float32)
            n = raw.shape[0]
            nt = self._round_tiles(n, raw)
            s_cap = nt * self.cfg.particle_tile
            pos = torch.zeros((3, s_cap), dtype=torch.float32, device=self.device)
            pos[:, :n] = torch.from_numpy(np.ascontiguousarray(raw.T)).to(self.device)
            act = torch.zeros((s_cap,), dtype=torch.bool, device=self.device)
            act[:n] = True
            positions.append(pos)
            actives.append(act)
            self._num_tiles.append(nt)
        return init_impl(
            self.cfg, self.materials, tuple(self._num_tiles), self.tile_chunk,
            tuple(positions), tuple(actives),
            tuple(tuple(float(c) for c in v) for v in model_velocities))

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _frame_end(self, frame_end) -> torch.Tensor:
        return torch.as_tensor(frame_end, dtype=torch.float32).to(self.device)

    def substep(self, state: SimState, frame_end, on_stage=None) -> SimState:
        """One substep (``substep_impl``, inside a ``claymore.substep``
        range under ``torch.profiler``); ``on_stage(name)``, when given, is
        called as each stage's work has been queued ("K2", "K1",
        "decision", "rebuild")."""
        with span("claymore.substep"):
            (state,), (rebuilt,) = substep_impl(
                self.cfg, self.materials, self.colliders, self.tile_chunk, (state,),
                (self._frame_end(frame_end),), (self._collider_table,), (self._sdf_pointers,),
                on_stage=on_stage)
        self.substeps += 1
        if rebuilt is not None:
            self.rebuilds += 1
            self.fallbacks += rebuilt[0] == "fallback"
            self.last_rebuild = rebuilt
        return state

    def run_steps(self, state: SimState, n: int, frame_end) -> SimState:
        fe = self._frame_end(frame_end)
        for _ in range(n):
            state = self.substep(state, fe)
        return state

    def run_frame(self, state: SimState, frame_end) -> SimState:
        """Substeps until ``t`` reaches ``frame_end`` (or the substep cap);
        the first dt is clamped to the frame end."""
        fe = self._frame_end(frame_end)
        eps = 1e-9
        state = dataclasses.replace(
            state, dt=torch.minimum(state.dt, torch.clamp(fe - state.t, min=0.0)))
        for _ in range(self.cfg.max_substeps_per_frame):
            with span("claymore.sync.loop"):
                going = bool(state.t < fe - eps)
            if not going:
                break
            state = self.substep(state, fe)
        return state

    def check_health(self, state: SimState, strict: bool = True) -> None:
        """Raise on divergence; raise (or warn) on the silent-loss counters
        (``health_check``)."""
        health_check((state,), strict)

    def run(self, state: SimState, frames: int, on_frame=None,
            check_health: bool = True, auto_grow: bool = False):
        """Frame loop: ``frames`` frames of 1/fps each.  Returns the final
        state, or ``(engine, state)`` with ``auto_grow``.

        ``auto_grow=True`` is the capacity recovery of the reference's
        ``check_capacity`` (blocks grown x1.5 at run time): when a frame ends
        with a loss counter firing or occupancy near capacity
        (``_needs_growth``), the engine is rebuilt larger by ``regrow`` and
        the run goes on with the new engine, which is returned."""
        eng = self
        frame_dt = self.cfg.frame_dt()
        t0 = float(state.t)
        for f in range(frames):
            frame_end = np.float32(t0 + (f + 1) * frame_dt)
            state = eng.run_frame(state, frame_end)
            if check_health:
                eng.check_health(state, strict=False)
            if auto_grow and eng._needs_growth(state):
                eng, state = eng.regrow(state)
            if on_frame is not None:
                on_frame(f, state)
        return (eng, state) if auto_grow else state

    def _needs_growth(self, state: SimState) -> bool:
        """Partition overflow or octs above 0.9 of capacity; dropped
        particles or valid tiles above 0.9 of a model's tiles."""
        if int(state.partition.overflow[0]) > 0:
            return True
        if int(state.partition.count[0]) > 0.9 * self.cfg.max_active_octs:
            return True
        for m in state.models:
            if int(m.tiles.dropped[0]) > 0:
                return True
            nt = m.tiles.tvalid.shape[0]
            if int(m.tiles.tvalid.sum()) > 0.9 * nt:
                return True
        return False

    def regrow(self, state: SimState, factor: float = 1.5):
        """A larger engine and ``state`` carried over into it: returns
        (engine, state).

        Blocks grow by ``factor`` when the octs fill more than 0.8 of the
        capacity (or overflowed); tile capacities are re-derived from the
        particles (``max_tiles=0``).  Grid rows are relabelled by oct key
        over the union of the old live octs (momentum may live in blocks no
        particle is in) and the new plan's; particles and their fields are
        re-planned into the new tiles.  As in the JAX package, every model's
        active particles get new ids ``0..n-1`` in their old slot order.
        The new engine re-packs its colliders as ``__init__`` does."""
        cfg = self.cfg
        dev = self.device
        octs = int(state.partition.count[0])
        new_blocks = cfg.max_active_blocks
        if octs > 0.8 * cfg.max_active_octs or int(state.partition.overflow[0]):
            new_blocks = int(cfg.max_active_blocks * factor)
        new_cfg = dataclasses.replace(cfg, max_active_blocks=new_blocks, max_tiles=0)
        eng = MPMEngine(new_cfg, self.materials, self.colliders, self.tile_chunk,
                        device=dev)

        # the active particles, in slot order, planned into the new tiles
        planned = []
        for m in state.models:
            act = m.active
            n = int(act.sum())
            nt = eng._round_tiles(n, m.pos[:, act].T.cpu().numpy())
            eng._num_tiles.append(nt)
            s_cap = nt * new_cfg.particle_tile
            pos = torch.zeros((3, s_cap), dtype=m.pos.dtype, device=dev)
            pos[:, :n] = m.pos[:, act]
            fields = {}
            for k, v in m.fields.items():
                buf = torch.zeros(v.shape[:-1] + (s_cap,), dtype=v.dtype, device=dev)
                buf[..., :n] = v[..., act]
                fields[k] = buf
            iota = torch.arange(s_cap, dtype=torch.int32, device=dev)
            active = iota < n
            raw = ParticleModel(pos=pos, fields=fields, active=active,
                                pid=torch.where(active, iota, torch.full_like(iota, s_cap)),
                                tiles=None)
            planned.append(rebucket_kernel.sort_permute(new_cfg, raw, nt))

        # the octs the new plan's particles reach (what init_impl's rebuild
        # activates), united with the old live octs; rows relabel by key
        no = cfg.num_oct_keys
        reach = part.particle_blocks(new_cfg, tuple(tk for _, tk, _ in planned), dev)
        plan_keys = torch.nonzero(reach.reshape(no, 8).any(dim=1)).flatten()
        keys_u = np.union1d(state.partition.keys[:octs].cpu().numpy(),
                            plan_keys.cpu().numpy()).astype(np.int32)
        cap = new_cfg.max_active_octs
        if len(keys_u) > cap:
            raise RuntimeError(
                f"regrow factor {factor} insufficient: {len(keys_u)} octs > {cap}")
        keys = np.full((cap,), no, np.int32)
        keys[:len(keys_u)] = keys_u
        table = np.full((no + 1,), new_cfg.null_oct, np.int32)
        table[keys_u] = np.arange(len(keys_u), dtype=np.int32)
        i32 = dict(dtype=torch.int32, device=dev)
        partition = Partition(table=torch.from_numpy(table).to(dev),
                              keys=torch.from_numpy(keys).to(dev),
                              count=torch.tensor([len(keys_u)], **i32),
                              overflow=torch.zeros((1,), **i32))
        old_slot = state.partition.table[torch.from_numpy(np.minimum(keys, no)).to(dev)]
        rows = state.grid[old_slot.long()]
        rows[torch.from_numpy(keys >= no).to(dev)] = 0.0
        grid = torch.cat([rows, torch.zeros_like(rows[:1])], dim=0)

        models = []
        for pm, tk, dr in planned:
            pm.tiles = partition_kernel.finalize_tiles(new_cfg, partition, tk, dr)
            models.append(pm)
        new_state = SimState(
            grid=grid, partition=partition, models=tuple(models), dt=state.dt,
            max_vel=state.max_vel, t=state.t, step=state.step,
            mig_dropped=torch.zeros((1,), **i32), halo_overflow=torch.zeros((1,), **i32))
        return eng, new_state

    # ------------------------------------------------------------------
    # profiling
    # ------------------------------------------------------------------

    def profile_stages(self, state: SimState, iters: int = 10, reps: int = 3) -> dict:
        """Milliseconds per call of each stage of a substep on ``state``:
        ``grid_update`` (K2), ``g2p2g`` (K1, every model, from the pool as
        it is), ``rebuild`` (the full rebucket), ``substep``, and
        ``overhead`` = substep minus the three (the CFL step and the drift
        check's host read; it can come out negative).

        Each stage is a state -> state function run ``iters`` times back to
        back, best of ``reps`` (``time_state_loop``: CUDA events on a card,
        the host clock on the CPU), so each includes its own data movement.
        Each run gets its own copy of ``state``, freed before the next is
        made; ``state`` is left as it was."""
        cfg = self.cfg
        fe = self._frame_end(np.float32(1e9))

        def grid_stage(s):
            pool_v, mv = grid_kernel.grid_update(
                cfg, s.grid, s.partition, s.dt, self.colliders, s.t,
                self._collider_table, self._sdf_pointers)
            return dataclasses.replace(s, grid=pool_v, max_vel=torch.sqrt(mv))

        def transfer_stage(s):
            nxt = torch.zeros_like(s.grid)
            models = []
            for mat, m in zip(self.materials, s.models):
                m, nxt, _ = g2p2g_kernel.g2p2g(cfg, mat, s.grid, s.partition.table, m,
                                               s.dt, s.dt, nxt, self.tile_chunk)
                models.append(m)
            return dataclasses.replace(s, grid=nxt, models=tuple(models))

        def rebuild_stage(s):
            partition, pool, models, _, _ = rebucket(cfg, s.grid, s.partition, s.models)
            return dataclasses.replace(s, grid=pool, partition=partition, models=models)

        def substep_stage(s):
            return substep_impl(cfg, self.materials, self.colliders, self.tile_chunk, (s,),
                                (fe,), (self._collider_table,), (self._sdf_pointers,))[0][0]

        stages = {"grid_update": grid_stage, "g2p2g": transfer_stage,
                  "rebuild": rebuild_stage, "substep": substep_stage}
        out = {name: time_state_loop(fn, state, iters, reps, self.device)
               for name, fn in stages.items()}
        out["overhead"] = out["substep"] - (
            out["grid_update"] + out["g2p2g"] + out["rebuild"])
        return out

    # ------------------------------------------------------------------
    # runtime parameter updates
    # ------------------------------------------------------------------

    def update_material(self, model_idx: int, **params) -> "MPMEngine":
        """A new engine with ``params`` replaced in material ``model_idx``
        (the reference's update_fr/j_fluid/nacc_parameters).  States carry
        over as they are, and so do the tile counts."""
        mats = list(self.materials)
        mats[model_idx] = dataclasses.replace(mats[model_idx], **params)
        eng = MPMEngine(self.cfg, mats, self.colliders, self.tile_chunk,
                        device=self.device)
        eng._num_tiles = list(self._num_tiles)
        return eng

    # ------------------------------------------------------------------
    # inspection / output
    # ------------------------------------------------------------------

    def get_positions(self, state: SimState, model_idx: int = 0) -> np.ndarray:
        """Active particle positions [N, 3] on the host, in slot order."""
        m = state.models[model_idx]
        return m.pos[:, m.active].T.cpu().numpy()

    def diagnostics(self, state: SimState) -> dict:
        """Conservation / occupancy probes."""
        cfg = self.cfg
        o = state.grid.shape[0] - 1
        mom = state.grid[:-1, 4:16].reshape(o, 3, 4, 128).sum(dim=(0, 2, 3))
        out = {
            "grid_mass": float(state.grid[:-1, 0:4].sum()),
            "grid_momentum": mom.cpu().numpy(),
            "active_octs": int(state.partition.count[0]),
            "block_overflow": int(state.partition.overflow[0]),
            "null_block_mass": float(state.grid[cfg.null_oct, 0:4].abs().sum()),
            "migration_dropped": int(state.mig_dropped.sum()),
            "t": float(state.t),
            "dt": float(state.dt),
            "step": int(state.step),
        }
        for i, m in enumerate(state.models):
            out[f"model{i}_active"] = int(m.active.sum())
            out[f"model{i}_dropped_tiles"] = int(m.tiles.dropped[0])
        return out
