"""Simulation orchestrator (single device).

Port of ``claymore_tpu/core/engine.py``: ``init_impl`` builds the partition,
tiles and rasterized grid; ``substep_impl`` runs one explicit MPM substep,
grid update (CUDA kernel K2) -> CFL step -> fused G2P2G (CUDA kernel K1) ->
drift check -> rebucket when needed.  On CPU tensors the kernel wrappers run
their plain PyTorch versions, which is how the tests hold the port against
the JAX package.

PyTorch runs eagerly, so the JAX package's on-device ``lax.while_loop``
frame loop becomes a host loop over substeps.  Several materials share one
pool: each model's transfer accumulates into the same next pool.  ``dt``, ``next_dt``,
``max_vel`` and ``t`` stay 0-d device tensors that the kernels read through
pointers.  The host synchronises with the device at exactly these points:

* ``substep_impl``: reading the rebuild decision, once per substep
  (``margin <= drift * safety`` under ``rebucket_auto``, or the step count
  for a fixed cadence of 2);
* ``MPMEngine.run_frame``: the loop test ``t < frame_end`` and the substep
  cap, once per substep;
* ``run`` / ``check_health`` / ``diagnostics`` / ``get_positions``: once per
  call.

Capturing substeps into CUDA graphs would remove the per-launch host cost;
that is later work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import SimConfig
from ..models.boundary import check_analytic
from ..models.materials import Material
from ..ops import g2p2g_kernel, grid_kernel
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
        base = np.floor(raw * cfg.dx_inv + 0.5).astype(np.int64) - 1
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
              pos_tuple, active_tuple, v0_tuple) -> SimState:
    """Initial setup: partition + tiles + rasterized grid.

    ``pos_tuple[i]`` is [3, S_i] with S_i = tile_counts[i] * particle_tile
    (slot capacity); padding lanes are marked inactive in ``active_tuple``.
    """
    dev = pos_tuple[0].device
    pool = torch.zeros((cfg.max_active_octs + 1, 16, 128), dtype=torch.float32,
                       device=dev)
    permuted, tile_keys, droppeds = [], [], []
    for mat, pos, active, nt in zip(materials, pos_tuple, active_tuple, tile_counts):
        s_cap = pos.shape[1]
        if s_cap != nt * cfg.particle_tile:
            raise ValueError(f"slot capacity {s_cap} != {nt} tiles")
        iota = torch.arange(s_cap, dtype=torch.int32, device=dev)
        raw = ParticleModel(
            pos=pos, fields=mat.init_fields(s_cap, dev), active=active,
            pid=torch.where(active, iota, torch.full_like(iota, s_cap)),
            tiles=None)
        pm, tk, dr = part.sort_permute(cfg, raw, nt)
        permuted.append(pm)
        tile_keys.append(tk)
        droppeds.append(dr)
    partition, pool = part.rebuild(cfg, pool, empty_partition(cfg, dev),
                                   tuple(tile_keys))
    models = []
    for mat, pm, tk, dr, v0 in zip(materials, permuted, tile_keys, droppeds,
                                   v0_tuple):
        pm.tiles = part.finalize_tiles(cfg, partition, tk, dr)
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


def substep_impl(cfg: SimConfig, materials, colliders, tile_chunk: int,
                 state: SimState, frame_end: torch.Tensor, collider_table=None):
    """One explicit MPM substep.  Returns (new_state, rebuilt: bool).

    The colliders are posed at the substep's start time ``state.t``;
    ``collider_table`` is their packed form for the CUDA grid kernel
    (``grid_kernel.pack_colliders``), built once per engine."""
    dt = state.dt
    pool_v, max_vel_sqr = grid_kernel.grid_update(
        cfg, state.grid, state.partition, dt, colliders, state.t, collider_table)
    t_after = state.t + dt
    next_dt = grid_ops.compute_dt(cfg, max_vel_sqr, t_after, frame_end)

    next_pool = torch.zeros_like(state.grid)
    new_models = []
    for mat, model in zip(materials, state.models):
        model, next_pool = g2p2g_kernel.g2p2g(
            cfg, mat, pool_v, state.partition.table, model, dt, next_dt,
            next_pool, tile_chunk)
        new_models.append(model)
    del pool_v

    k_every = cfg.rebucket_every
    if cfg.rebucket_auto:
        # rebuild when the next advection could push some particle past its
        # tile's arena bound (margin on the advected positions, stale tiles)
        margin = part.arena_margin(cfg, new_models[0])
        for m in new_models[1:]:
            margin = torch.minimum(margin, part.arena_margin(cfg, m))
        drift_next = next_dt * torch.sqrt(max_vel_sqr) * cfg.dx_inv
        do_rebuild = bool(margin <= drift_next * cfg.rebucket_safety + 1e-3)
    elif k_every == 1:
        do_rebuild = True
    else:
        do_rebuild = (int(state.step) + 1) % k_every == 0

    partition = state.partition
    if do_rebuild:
        permuted, tile_keys, droppeds = [], [], []
        for m in new_models:
            pm, tk, dr = part.sort_permute(cfg, m, m.tiles.block.shape[0])
            permuted.append(pm)
            tile_keys.append(tk)
            droppeds.append(dr)
        partition, next_pool = part.rebuild(cfg, next_pool, state.partition,
                                            tuple(tile_keys))
        for pm, tk, dr in zip(permuted, tile_keys, droppeds):
            pm.tiles = part.finalize_tiles(cfg, partition, tk, dr)
        new_models = permuted

    new_state = SimState(
        grid=next_pool, partition=partition, models=tuple(new_models),
        dt=next_dt, max_vel=torch.sqrt(max_vel_sqr), t=t_after,
        step=state.step + 1, mig_dropped=state.mig_dropped,
        halo_overflow=state.halo_overflow)
    return new_state, do_rebuild


class MPMEngine:
    """One engine = (config, materials, colliders) on one device.

    ``device`` has no default: a CUDA device runs the kernels, a CPU device
    their plain PyTorch versions, and asking for CUDA without a card raises.
    Colliders are the analytic ones (``models/boundary.py``); an SDF
    collider raises.  ``rebuilds`` counts the substeps that rebucketed.
    """

    def __init__(self, cfg: SimConfig, materials: Sequence[Material],
                 colliders: Sequence = (), tile_chunk: int = 32, *, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        check_analytic(colliders)
        if cfg.defrag_every != 1:
            raise ValueError(
                "defrag_every must be 1: the incremental mover path is not "
                "ported; use rebucket_auto=True")
        if cfg.arena_span != 2:
            raise ValueError(
                "rebucket_every <= 2 required (span-2 arenas); the span-4 "
                "arena is not ported")
        self.cfg = cfg
        self.materials = tuple(materials)
        self.colliders = tuple(colliders)
        self._collider_table = (
            grid_kernel.pack_colliders(self.colliders, self.device)
            if self.colliders and self.device.type == "cuda" else None)
        self.tile_chunk = tile_chunk
        self.rebuilds = 0
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

    def substep(self, state: SimState, frame_end) -> SimState:
        state, rebuilt = substep_impl(self.cfg, self.materials, self.colliders,
                                      self.tile_chunk, state,
                                      self._frame_end(frame_end),
                                      self._collider_table)
        self.rebuilds += int(rebuilt)
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
        step0 = int(state.step)
        state = dataclasses.replace(
            state, dt=torch.minimum(state.dt, torch.clamp(fe - state.t, min=0.0)))
        while (bool(state.t < fe - eps)
               and int(state.step) - step0 < self.cfg.max_substeps_per_frame):
            state = self.substep(state, fe)
        return state

    def check_health(self, state: SimState, strict: bool = True) -> None:
        """Raise on divergence; raise (or warn) on the silent-loss counters."""
        import warnings

        t = float(state.t)
        max_vel = float(state.max_vel)
        if not np.isfinite(t) or not np.isfinite(max_vel):
            raise FloatingPointError(
                f"simulation diverged: t={t}, max_vel={max_vel} at step "
                f"{int(state.step)} (NaN/inf velocity — reduce dt or stiffness)")
        msgs = []
        overflow = int(state.partition.overflow[0])
        if overflow > 0:
            msgs.append(f"partition overflow: {overflow} active blocks beyond "
                        "max_active_blocks")
        for i, m in enumerate(state.models):
            d = int(m.tiles.dropped[0])
            if d > 0:
                msgs.append(f"model {i}: {d} particles dropped (tile capacity)")
        if msgs:
            msg = "; ".join(msgs) + " — increase capacities in SimConfig"
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)

    def run(self, state: SimState, frames: int, on_frame=None,
            check_health: bool = True) -> SimState:
        """Frame loop: ``frames`` frames of 1/fps each."""
        frame_dt = self.cfg.frame_dt()
        t0 = float(state.t)
        for f in range(frames):
            frame_end = np.float32(t0 + (f + 1) * frame_dt)
            state = self.run_frame(state, frame_end)
            if check_health:
                self.check_health(state, strict=False)
            if on_frame is not None:
                on_frame(f, state)
        return state

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
