"""Spatial decomposition across devices (port of ``claymore_tpu/parallel/multi.py``).

The domain is cut into slabs along x, or into an (x, z) box grid (the
reference's 4-GPU 2x2 split), one shard per slab.  Each shard holds a
full-domain index table and runs the single-device substep; three hooks
join the shards (``core/engine.py:substep_impl``, with this module's
``HaloComm`` as its ``comm``):

* ``reduce_max``: the CFL max|v|^2 over every shard, so every shard takes
  the same dt;
* the packed halo exchange: each shard packs the (key, pool row) of its
  active octs inside the 2*margin window around each slab face it shares
  (8 directions on a 2-D mesh: 4 faces, 4 corners) into a buffer of
  ``halo_capacity`` rows and ships it to its neighbour, which adds it into
  its own pool by table lookup; so every block of the window holds the sum
  of both shards' contributions, as the reference's collect/reduce does;
* migration: particles whose home block left the shard's slab are shipped
  to the neighbour, ``migration_capacity`` per face.

Every collective goes through a *group*: ``shift(xs, axis, step)`` is the
JAX package's ``ppermute`` by +-1 along a mesh axis (an edge shard gets
nothing: ``None`` here, zeros in ``distributed.DistGroup``), and
``reduce_max`` its ``pmax``.  ``LocalGroup`` holds every shard in this
process, shard i on ``devices[i]`` (several shards may share one card),
and shifts by copying a shard's buffer to its neighbour's device: a peer
copy across cards, a device-local copy on one card.  Under the
boundary/interior transfer split those copies run on a side stream per
shard, so they overlap the interior K1.  ``distributed.DistGroup`` holds one
shard per process of a ``torch.distributed`` group.  The engine code is the
same for both: it runs over "the shards this process holds".

The packs, the halo mass mask, the halo add and migration's pack are
``ops/halo_kernel.py``'s: CUDA kernels on a card (one pack launch pair per
shard over every direction), the plain twins of ``parallel/halo.py`` on
the CPU.

Fixed capacities, as in the JAX package: a pack ships ``halo_capacity``
rows whatever it holds, and octs past it are counted in
``SimState.halo_overflow``; migrants past ``migration_capacity``, and
arrivals with no free slot, in ``SimState.mig_dropped``.

Particle ids: each particle's id is its index in the model's input
positions, the id ``MPMEngine`` gives it, so ids stay unique across shards
and a multi-device run pairs with a single-device one by id.  (The JAX
package numbers each shard's particles from 0, so two particles in one
shard share an id after a migration.)
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import SimConfig
from ..core import engine as engine_mod
from ..core.types import ParticleModel
from ..models.boundary import check_colliders
from ..models.materials import Material
from ..ops import grid_kernel, halo_kernel, partition_kernel
from ..utils.timers import span
from . import halo


def mesh_coord(mesh_shape, shard: int) -> tuple:
    """Row-major mesh coordinates of shard ``shard``."""
    return tuple(int(c) for c in np.unravel_index(shard, mesh_shape))


def mesh_index(mesh_shape, coord) -> int:
    return int(np.ravel_multi_index(tuple(coord), mesh_shape))


def neighbour(mesh_shape, shard: int, axis: int, step: int) -> Optional[int]:
    """The shard ``step`` places from ``shard`` along ``axis``, or None."""
    c = list(mesh_coord(mesh_shape, shard))
    c[axis] += step
    if not 0 <= c[axis] < mesh_shape[axis]:
        return None
    return mesh_index(mesh_shape, c)


class LocalGroup:
    """Every shard of the mesh in this process, shard i on ``devices[i]``.

    ``side_streams``: give each shard on a CUDA device a side stream for
    the halo exchange (``HaloComm.exchange_halo``)."""

    dense = False          # an edge shard receives None, not zeros

    def __init__(self, mesh_shape, devices, side_streams: bool = False):
        self.mesh_shape = tuple(mesh_shape)
        self.devices = [torch.device(d) for d in devices]
        n = math.prod(self.mesh_shape)
        if len(self.devices) != n:
            raise ValueError(f"{n} shards need {n} devices, got {len(self.devices)}")
        self.shards = list(range(n))
        self._side = [torch.cuda.Stream(d) if side_streams and d.type == "cuda" else None
                      for d in self.devices]

    def _main(self, j):
        return torch.cuda.current_stream(self.devices[j])

    def on_side(self, j):
        """Context: shard j's side stream is current (a no-op without one)."""
        s = self._side[j]
        return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()

    def keep_for_side(self, t: torch.Tensor, j: int) -> None:
        """``t`` (made on shard j's main stream) is read on its side stream:
        keep its memory until that use is done."""
        if self._side[j] is not None:
            t.record_stream(self._side[j])

    def begin_side(self) -> None:
        """Each side stream waits for the work queued on its main stream."""
        for j, s in enumerate(self._side):
            if s is not None:
                s.wait_stream(self._main(j))

    def wait_side(self) -> None:
        """Each main stream waits for its side stream (before the received
        rows are read)."""
        for j, s in enumerate(self._side):
            if s is not None:
                self._main(j).wait_stream(s)

    def shift(self, xs, axis: int, step: int, side: bool = False):
        """``ppermute`` of xs[i] by ``step`` shards along ``axis``: shard j
        gets a copy of its source's tensor on its own device, or None where
        it has no source (or the source sent None).  ``side``: the copies
        run on the receivers' side streams, after the senders' side work."""
        out = []
        for j, shard in enumerate(self.shards):
            src = neighbour(self.mesh_shape, shard, axis, -step)
            x = None if src is None else xs[src]
            if x is None:
                out.append(None)
                continue
            s_src, s_dst = (self._side[src], self._side[j]) if side else (None, None)
            if s_dst is None:
                y = torch.empty_like(x, device=self.devices[j])
                y.copy_(x, non_blocking=True)
            else:
                with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
                    s_dst.wait_stream(s_src)
                    y = torch.empty_like(x, device=self.devices[j])
                    y.copy_(x, non_blocking=True)
                x.record_stream(s_dst)
                y.record_stream(self._main(j))
            out.append(y)
        return out

    def reduce_max(self, xs):
        """``pmax``: the max of every shard's 0-d tensor, on each device."""
        dev0 = self.devices[0]
        m = torch.stack([x.to(dev0) for x in xs]).max()
        return [m.to(d) for d in self.devices]

    def read_flags(self, flags) -> List[bool]:
        """Every shard's 0-d bool tensor on the host, in one read."""
        dev0 = self.devices[0]
        return [bool(f) for f in torch.stack([f.to(dev0) for f in flags]).tolist()]

    def sum_all(self, values: np.ndarray) -> np.ndarray:
        """Sum of per-process host values over the group (one process)."""
        return values


class HaloComm:
    """The comm hooks of one engine: mesh geometry, the packed halo
    exchange and migration, for the shards ``group`` holds.

    ``axes`` maps mesh axes to decomposed spatial dimensions: x-slabs
    ``(("x", 0),)``, the (x, z) box split ``(("x", 0), ("z", 2))``.  Axes of
    extent 1 have no neighbours and are skipped (``live_axes``); a mesh of
    one shard on every axis is ``trivial`` and runs the single-device
    pipeline.  ``overlap`` turns on the boundary/interior transfer split
    (the engine also needs ``defrag_every == 1``)."""

    def __init__(self, cfg: SimConfig, axes, mesh_shape, margin: int, mig_cap: int,
                 halo_capacity: Optional[int] = None, overlap: bool = True, group=None):
        self.cfg = cfg
        self.axes = tuple(axes)
        self.mesh_shape = tuple(mesh_shape)
        self.margin = margin
        self.mig_cap = mig_cap
        self.live_axes = tuple(a for a, n in enumerate(self.mesh_shape) if n > 1)
        self.trivial = not self.live_axes
        self.overlap = overlap and not self.trivial
        self.slabs = []
        for n in self.mesh_shape:
            if cfg.grid_size % n:
                raise ValueError(f"{cfg.grid_size} blocks do not split into {n} slabs")
            self.slabs.append(cfg.grid_size // n)
        if halo_capacity is None:
            # a direction's window is ~2*margin of the slab's block layers:
            # at most ~2m/slab of the shard's octs, x4 for uneven occupancy,
            # at least 512
            frac = min(1.0, 2.0 * margin / max(min(self.slabs), 1))
            halo_capacity = min(cfg.max_active_octs,
                                max(512, int(4.0 * frac * cfg.max_active_octs)))
        self.halo_capacity = halo_capacity
        self.group = group
        self.shards = [] if group is None else list(group.shards)

    # -- mesh geometry -------------------------------------------------
    def _bounds(self, shard: int, a: int):
        """(lo, hi) of the shard's block range along decomposed axis a."""
        lo = mesh_coord(self.mesh_shape, shard)[a] * self.slabs[a]
        return lo, lo + self.slabs[a]

    def reduce_max(self, xs):
        return self.group.reduce_max(xs)

    def read_flags(self, flags, site: str = "flags") -> List[bool]:
        """Every shard's 0-d bool flag on the host (the group's one read),
        inside a ``claymore.sync.<site>`` range."""
        with span("claymore.sync." + site):
            return self.group.read_flags(flags)

    # -- boundary/interior transfer split -------------------------------
    def is_boundary_key(self, keys: torch.Tensor, shard: int) -> torch.Tensor:
        """bool over flat BLOCK keys: could a tile homed at this block
        scatter into a window that shard ``shard`` ships?  Conservative per
        home oct (the P2G arena is anchored at the home block, so its reach,
        [b, b+1] blocks and [oct, oct+8] along z, is fixed between
        rebuilds)."""
        g = self.cfg.grid_size
        m = self.margin
        bound = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
        for a in self.live_axes:
            if self.axes[a][1] == 0:
                c, reach_hi = torch.div(keys, g * g, rounding_mode="floor"), 1
            else:
                c, reach_hi = (keys % g) & ~7, 8
            lo, hi = self._bounds(shard, a)
            bound = bound | (c < lo + m) | (c + reach_hi >= hi - m)
        return bound

    def boundary_tile_cap(self, num_tiles: int, multiple: int) -> int:
        """The boundary prefix's static tile capacity: the geometric share
        of the windows x4, at least 4 * ``multiple``, in whole multiples."""
        frac = 0.0
        for a in self.live_axes:
            reach = 1 if self.axes[a][1] == 0 else 8
            frac += min(1.0, (2.0 * self.margin + reach) / self.slabs[a])
        cap = int(4.0 * min(frac, 1.0) * num_tiles)
        cap = max(cap, 4 * multiple)
        cap = -(-cap // multiple) * multiple
        return min(cap, num_tiles)

    # -- packed halo exchange -------------------------------------------
    def _directions(self):
        """Every nonzero neighbour offset over the mesh axes: 2 for a 1-D
        split, 8 for the 2-D one; size-1 axes stay at step 0."""
        steps = [(-1, 0, 1) if n > 1 else (0,) for n in self.mesh_shape]
        return [d for d in itertools.product(*steps) if any(d)]

    def _target(self, shard: int, d) -> Optional[int]:
        """The shard ``shard`` ships direction d's pack to, or None."""
        for a, step in enumerate(d):
            shard = None if shard is None else neighbour(self.mesh_shape, shard, a, step)
        return shard

    def _windows(self, shard: int):
        """Per direction (``_directions``), its window of shard ``shard``:
        ((dim, edge), ...) of each face it crosses (``parallel/halo.py``)."""
        out = []
        for d in self._directions():
            win = []
            for a, step in enumerate(d):
                if step:
                    lo, hi = self._bounds(shard, a)
                    win.append((self.axes[a][1], hi if step > 0 else lo))
            out.append(tuple(win))
        return out

    def exchange_halo(self, pools, partitions):
        """Pack each window a shard shares with a neighbour and ship it
        (corners by a chain of shifts, x then z).  Returns (received,
        overflow): per shard, a list of (keys, bits, rows) it received, and
        i32[1] of its octs past ``halo_capacity``, over every direction.

        Each shard's packs of every direction are one ``halo_kernel`` call
        pair: the count (and so the overflow, which the engine reads before
        waiting for the side streams) on the main stream, the packs on the
        shard's side stream where the group has one, then the copies there
        too; ``wait_halo`` must come before the received rows are read.  A
        shard packs only the windows that reach a neighbour, or, in a group
        that must send every buffer (``dense``), all of them."""
        received = [[] for _ in pools]
        if self.trivial:
            return received, [torch.zeros((1,), dtype=torch.int32, device=p.device)
                              for p in pools]
        cfg, h, m = self.cfg, self.halo_capacity, self.margin
        dirs = self._directions()
        plans, overflow = [], []
        for j, pt in enumerate(partitions):
            plan, over = halo_kernel.pack_count(cfg, pt.keys, pt.count,
                                                self._windows(self.shards[j]), h, m)
            plans.append(plan)
            overflow.append(over)
        self.group.begin_side()
        packs = []
        for j, (pool, pt, plan) in enumerate(zip(pools, partitions, plans)):
            packed = [self._target(self.shards[j], d) is not None or self.group.dense
                      for d in dirs]
            for t in plan.buffers:
                self.group.keep_for_side(t, j)
            with self.group.on_side(j):
                packs.append(halo_kernel.pack_write(cfg, pool, pt.keys, pt.count, plan, packed,
                                                    h, m))
        for i, d in enumerate(dirs):
            metas = [p[i][0] if p[i] is not None else None for p in packs]
            rows = [p[i][1] if p[i] is not None else None for p in packs]
            for p in packs:
                p[i] = None            # each source is freed once it is shipped
            for a, step in enumerate(d):
                if step:
                    metas = self.group.shift(metas, a, step, side=True)
                    rows = self.group.shift(rows, a, step, side=True)
            for j, (meta, r) in enumerate(zip(metas, rows)):
                if meta is not None:
                    received[j].append((meta[0], meta[1], r))
        return received, overflow

    def exchanged_bytes(self, partitions=None, models=None) -> dict:
        """Bytes the exchanges copy, counted from the shapes: ``halo`` per
        substep, every hop of every pack that reaches a neighbour (8 B of
        key and mass bits and an 8 KiB pool row per slot of
        ``halo_capacity``); ``migration`` per substep on which every shard
        rebuilds (``migration_capacity`` slots of pos, valid, pid and the
        fields of ``models``, one shard's, per face shared).  With
        ``partitions`` (every shard's), ``halo_trimmed``: what an exchange
        shipping only each window's packed octs would copy."""
        row = 2 * 4 + 16 * 128 * 4
        out = {"halo": 0, "halo_trimmed": 0 if partitions is not None else None,
               "migration": 0}
        for i, d in enumerate(self._directions()):
            hops = sum(1 for step in d if step)
            for j, shard in enumerate(self.shards):
                if self._target(shard, d) is None:
                    continue
                out["halo"] += hops * self.halo_capacity * row
                if partitions is not None:
                    pt = partitions[j]
                    (cond,), _ = halo.window_marks(self.cfg, pt.keys, pt.count,
                                                   [self._windows(shard)[i]],
                                                   self.halo_capacity, self.margin)
                    n = min(int(cond.sum()), self.halo_capacity)
                    out["halo_trimmed"] += hops * n * row
        for m in models or ():
            chans = halo.payload_channels(m)
            for a in self.live_axes:
                faces = sum(neighbour(self.mesh_shape, shard, a, step) is not None
                            for shard in self.shards for step in (-1, 1))
                out["migration"] += faces * self.mig_cap * chans * 4
        return out

    def wait_halo(self) -> None:
        if not self.trivial:
            self.group.wait_side()

    def halo_mass_mask(self, received) -> Optional[torch.Tensor]:
        """bool[G^3]: the blocks a neighbour sent mass into (they must stay
        active: ``partition_kernel.rebuild``'s ``extra_mask``), None if nothing
        was received."""
        return halo_kernel.mass_mask(self.cfg, received)

    def add_halo(self, pool, partition, received):
        """Add the neighbours' rows into my (rebuilt) pool by key; rows of
        octs I do not hold fall into the null row, which ends zero."""
        return halo_kernel.add_rows(self.cfg, pool, partition.table, received)

    # -- particle migration -------------------------------------------
    def _place(self, m: ParticleModel, rv: torch.Tensor):
        """Write the valid migrants of payload ``rv`` into the first free
        slots of ``m`` (in place) and mark them active; returns the count of
        migrants that found no free slot (i32[1])."""
        s_cap = m.pos.shape[1]
        k = rv.shape[1]
        valid = rv[3] > 0
        free, _ = partition_kernel.first_marked(~m.active, k, s_cap)
        ok = valid & (free < s_cap)
        lost = (valid & (free >= s_cap)).sum(dtype=torch.int32).reshape(1)
        # valid migrants and free slots are both prefixes, so ``ok`` is one;
        # the entries past it repeat entry 0's write (or slot 0's own value
        # when nothing is placed), so every write to a slot agrees
        first = ok[0]
        tgt = torch.where(ok, free, torch.where(first, free[0], torch.zeros_like(free[0])))

        def put(x, vals):
            fallback = torch.where(first, vals[..., 0], x[..., 0])
            x[..., tgt] = torch.where(ok, vals, fallback[..., None])

        put(m.pos, rv[0:3])
        put(m.pid, rv[4].contiguous().view(torch.int32))
        row = 5
        for name, v in sorted(m.fields.items()):
            c = 1 if v.dim() == 1 else v.shape[0]
            put(v, rv[row:row + c].reshape(v.shape[:-1] + (k,)))
            row += c
        put(m.active, torch.ones_like(valid))
        return lost

    def migrate(self, models, enable):
        """Ship the particles that left their shard's slab to the
        neighbour, one live axis at a time (corner crossers take two hops).

        ``models[j]`` are shard j's models, ``enable[j]`` its rebuild
        decision: a shard packs its crossers (and deactivates them) only on
        a rebuilding substep, and places whatever arrives (the JAX package's
        placement is gated on arrival, not on the receiver's decision).
        Returns (models, dropped, arrived), per shard: dropped (i32[1]) the
        crossers past ``migration_capacity`` (deactivated, lost) and the
        arrivals that found no free slot; arrived (0-d bool) whether any
        particle arrived.  A migrant waits in a free slot of some tile, so a
        shard that received one must rebuild this substep (the engine sees
        to it; in the JAX package a shard that does not rebuild loses its
        arrivals at the next transfer)."""
        cfg, k = self.cfg, self.mig_cap
        models = [list(ms) for ms in models]
        dropped = [torch.zeros((1,), dtype=torch.int32, device=ms[0].pos.device)
                   for ms in models]
        arrived = [torch.zeros((), dtype=torch.bool, device=ms[0].pos.device)
                   for ms in models]
        for mi in range(len(models[0]) if models else 0):
            for a in self.live_axes:
                dim = self.axes[a][1]
                lefts, rights = [], []
                for j, shard in enumerate(self.shards):
                    m = models[j][mi]
                    if not enable[j]:
                        zero = None
                        if self.group.dense:
                            zero = torch.zeros((halo.payload_channels(m), k),
                                               dtype=torch.float32, device=m.pos.device)
                        lefts.append(zero)
                        rights.append(zero)
                        continue
                    # crossers past the capacity are deactivated too, and
                    # counted: they must not go on scattering here
                    left, right, active, drop = halo_kernel.migrate_pack(
                        cfg, m, dim, *self._bounds(shard, a), k)
                    dropped[j] = dropped[j] + drop
                    models[j][mi] = dataclasses.replace(m, active=active)
                    lefts.append(left)
                    rights.append(right)
                arrivals = zip(self.group.shift(lefts, a, -1), self.group.shift(rights, a, +1))
                for j, rvs in enumerate(arrivals):
                    for rv in rvs:
                        if rv is not None:
                            dropped[j] = dropped[j] + self._place(models[j][mi], rv)
                            arrived[j] = arrived[j] | (rv[3, 0] > 0)
        return models, dropped, arrived


def _devices(device, n: int) -> List[torch.device]:
    """One device per shard: ``device`` (every shard on it) or a list with
    one entry per shard (a list of another length raises)."""
    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if len(devs) != n:
            raise ValueError(f"a mesh of {n} shards needs {n} devices, got {len(devs)}")
    else:
        devs = [torch.device(device)] * n
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
    return devs


class MultiChipEngine:
    """``MPMEngine``'s API over a mesh of shards: 1-D x-slabs
    (``n_devices``) or the reference's 2-D (x, z) box split
    (``mesh_shape=(nx, nz)``).

    ``device`` is one device (every shard on it) or one per shard in
    row-major mesh order; it has no default.  ``group`` is the process's
    group (``LocalGroup`` over ``device`` by default, or a
    ``distributed.DistGroup``, whose rank holds one shard).  The state is a
    tuple of per-shard ``SimState``s (the shards this process holds), each
    on its shard's device.  ``halo_margin`` must cover the transfer arena's
    scatter reach; the remaining arguments are the JAX package's.
    ``substeps`` counts the substeps run and ``rebuilds`` those on which
    some shard rebucketed (host counts)."""

    def __init__(self, cfg: SimConfig, materials: Sequence[Material],
                 n_devices: Optional[int] = None, mesh_shape: Optional[Sequence[int]] = None,
                 *, device, halo_margin: Optional[int] = None,
                 migration_capacity: int = 2048, halo_capacity: Optional[int] = None,
                 colliders: Sequence = (), tile_chunk: int = 32,
                 particle_capacity_factor: float = 1.5, overlap_halo: bool = True,
                 group=None):
        if mesh_shape is not None:
            mesh_shape = tuple(int(n) for n in mesh_shape)
            if len(mesh_shape) not in (1, 2):
                raise ValueError(f"mesh_shape {mesh_shape}: 1 or 2 axes")
        else:
            if n_devices is None:
                if isinstance(device, (list, tuple)):
                    n_devices = len(device)
                elif group is not None:
                    n_devices = math.prod(group.mesh_shape)
                else:
                    n_devices = 1
            mesh_shape = (int(n_devices),)
        self.mesh_shape = mesh_shape
        self.n_dev = math.prod(mesh_shape)
        axes = (("x", 0), ("z", 2))[:len(mesh_shape)]
        arena_reach = max(cfg.arena_lo + cfg.arena_span - 1, -cfg.arena_lo, 1)
        if halo_margin is None:
            halo_margin = arena_reach
        if halo_margin < arena_reach:
            raise ValueError(
                f"halo_margin={halo_margin} cannot cover the transfer arena's scatter "
                f"reach of {arena_reach} block layers (rebucket_every="
                f"{cfg.rebucket_every} widens the arena; raise halo_margin or lower "
                "rebucket_every)")
        for n in mesh_shape:
            if cfg.grid_size // n < halo_margin:
                raise ValueError("slab thinner than the halo margin; use fewer devices "
                                 "or a larger domain")
        check_colliders(colliders)
        if group is None:
            group = LocalGroup(mesh_shape, _devices(device, self.n_dev),
                               side_streams=overlap_halo and self.n_dev > 1)
        elif tuple(group.mesh_shape) != mesh_shape:
            raise ValueError(f"group mesh {group.mesh_shape} != engine mesh {mesh_shape}")
        else:
            _devices(list(group.devices), len(group.devices))
        self.group = group
        self.overlap_halo = overlap_halo
        self.devices = list(group.devices)
        self.device = self.devices[0]
        self.comm = HaloComm(cfg, axes, mesh_shape, halo_margin, migration_capacity,
                             halo_capacity, overlap=overlap_halo, group=group)
        self.cfg = cfg
        self.materials = tuple(materials)
        self.colliders = tuple(colliders)
        self.tile_chunk = tile_chunk
        self.capacity_factor = particle_capacity_factor
        on_card = [bool(self.colliders) and d.type == "cuda" for d in self.devices]
        if any(on_card):
            grid_kernel.check_collider_count(len(self.colliders))
        self._collider_tables = tuple(
            grid_kernel.pack_colliders(self.colliders, d) if c else None
            for d, c in zip(self.devices, on_card))
        self._sdf_pointers = tuple(
            grid_kernel.sdf_table_pointers(self.colliders, d) if c else None
            for d, c in zip(self.devices, on_card))
        self._num_tiles: List[int] = []
        self.substeps = 0
        self.rebuilds = 0

    # -- init ----------------------------------------------------------
    def shard_of(self, raw: np.ndarray) -> np.ndarray:
        """The shard of each of [N, 3] positions: its home block's slab,
        row-major over the mesh axes."""
        cfg = self.cfg
        raw = np.asarray(raw, np.float32)
        shard = np.zeros(len(raw), np.int64)
        for (_name, dim), n_ax in zip(self.comm.axes, self.mesh_shape):
            # the home block along the decomposed axis only, in int32
            base = np.floor(raw[:, dim] * cfg.dx_inv + 0.5).astype(np.int32) - 1
            hb = (base - 1) >> cfg.block_bits
            slab = cfg.grid_size // n_ax
            shard = shard * n_ax + np.clip(hb // slab, 0, n_ax - 1)
        return shard

    def init_state(self, model_positions, model_velocities=None):
        """Assign each particle to the shard of its home block, size every
        shard's tiles for the worst shard (``exact_tiles``), build each
        shard's state and reduce the halo once, so every active copy of a
        block holds the sum.  Particle ids are indices into each model's
        input positions."""
        cfg = self.cfg
        if len(model_positions) != len(self.materials):
            raise ValueError("one position array per material expected")
        if model_velocities is None:
            model_velocities = [(0.0, 0.0, 0.0)] * len(self.materials)
        split = self.comm.overlap and cfg.defrag_every == 1
        per_shard = [([], [], []) for _ in self.comm.shards]
        self._num_tiles = []
        for raw in model_positions:
            raw = np.asarray(raw, np.float32)
            shard = self.shard_of(raw)
            nt = max(engine_mod.exact_tiles(cfg, [raw[shard == d]],
                                            slack=max(self.capacity_factor, 1.3))
                     for d in range(self.n_dev))
            c = max(self.tile_chunk, cfg.group_tiles)
            nt = -(-nt // c) * c
            s_cap = nt * cfg.particle_tile
            self._num_tiles.append(nt)
            for j, d in enumerate(self.comm.shards):
                dev = self.devices[j]
                ids = np.flatnonzero(shard == d)
                if len(ids) > s_cap:
                    raise RuntimeError(f"shard {d}: {len(ids)} particles > {s_cap} slots")
                pos = torch.zeros((3, s_cap), dtype=torch.float32, device=dev)
                pos[:, :len(ids)] = torch.from_numpy(np.ascontiguousarray(raw[ids].T)).to(dev)
                act = torch.zeros((s_cap,), dtype=torch.bool, device=dev)
                act[:len(ids)] = True
                pid = torch.full((s_cap,), s_cap, dtype=torch.int32, device=dev)
                pid[:len(ids)] = torch.from_numpy(ids.astype(np.int32)).to(dev)
                for lst, x in zip(per_shard[j], (pos, act, pid)):
                    lst.append(x)
        v0s = tuple(tuple(float(c) for c in v) for v in model_velocities)
        states = []
        for j, (pos, act, pid) in enumerate(per_shard):
            region = None
            if split:
                shard = self.comm.shards[j]
                region = lambda k, shard=shard: self.comm.is_boundary_key(k, shard)
            states.append(engine_mod.init_impl(
                cfg, self.materials, tuple(self._num_tiles), self.tile_chunk, tuple(pos),
                tuple(act), v0s, region_fn=region, pid_tuple=tuple(pid)))
        received, _ = self.comm.exchange_halo([s.grid for s in states],
                                              [s.partition for s in states])
        self.comm.wait_halo()
        return tuple(dataclasses.replace(s, grid=self.comm.add_halo(s.grid, s.partition, r))
                     for s, r in zip(states, received))

    # -- stepping ------------------------------------------------------
    def _frame_end(self, frame_end):
        return tuple(torch.as_tensor(frame_end, dtype=torch.float32).to(d)
                     for d in self.devices)

    def substep(self, state, frame_end, on_stage=None):
        """One substep of every shard (``core/engine.py:substep_impl``,
        inside a ``claymore.substep`` range under ``torch.profiler``)."""
        with span("claymore.substep"):
            fe = frame_end if isinstance(frame_end, tuple) else self._frame_end(frame_end)
            state, rebuilt = engine_mod.substep_impl(
                self.cfg, self.materials, self.colliders, self.tile_chunk, state, fe,
                self._collider_tables, self._sdf_pointers, comm=self.comm, on_stage=on_stage)
        self.substeps += 1
        self.rebuilds += any(r is not None for r in rebuilt)
        return state

    def run_steps(self, state, n: int, frame_end):
        fe = self._frame_end(frame_end)
        for _ in range(n):
            state = self.substep(state, fe)
        return state

    def run_frame(self, state, frame_end):
        """Substeps until ``t`` reaches ``frame_end`` (or the substep cap);
        the first dt is clamped to the frame end."""
        fe = self._frame_end(frame_end)
        eps = 1e-9
        state = tuple(dataclasses.replace(s, dt=torch.minimum(s.dt, torch.clamp(f - s.t, min=0.0)))
                      for s, f in zip(state, fe))
        for _ in range(self.cfg.max_substeps_per_frame):
            with span("claymore.sync.loop"):
                going = bool(state[0].t < fe[0] - eps)
            if not going:
                break
            state = self.substep(state, fe)
        return state

    def run(self, state, frames: int, on_frame=None, check_health: bool = True):
        frame_dt = self.cfg.frame_dt()
        t0 = float(state[0].t)
        for f in range(frames):
            state = self.run_frame(state, np.float32(t0 + (f + 1) * frame_dt))
            if check_health:
                self.check_health(state, strict=False)
            if on_frame is not None:
                on_frame(f, state)
        return state

    def check_health(self, state, strict: bool = True) -> None:
        """``MPMEngine.check_health`` summed over the shards this process
        holds (``core/engine.py:health_check``)."""
        engine_mod.health_check(tuple(state), strict)

    def update_material(self, model_idx: int, **params) -> "MultiChipEngine":
        """A new engine with ``params`` replaced in material ``model_idx``;
        states carry over as they are."""
        mats = list(self.materials)
        mats[model_idx] = dataclasses.replace(mats[model_idx], **params)
        eng = MultiChipEngine(
            self.cfg, mats, mesh_shape=self.mesh_shape, device=self.devices,
            halo_margin=self.comm.margin, migration_capacity=self.comm.mig_cap,
            halo_capacity=self.comm.halo_capacity, colliders=self.colliders,
            tile_chunk=self.tile_chunk, particle_capacity_factor=self.capacity_factor,
            overlap_halo=self.overlap_halo,
            group=self.group if not isinstance(self.group, LocalGroup) else None)
        eng._num_tiles = list(self._num_tiles)
        return eng

    # -- inspection ----------------------------------------------------
    def get_positions(self, state, model_idx: int = 0) -> np.ndarray:
        """Active particle positions [N, 3] on the host, shard by shard in
        slot order."""
        return np.concatenate([s.models[model_idx].pos[:, s.models[model_idx].active]
                               .T.cpu().numpy() for s in state])

    def owned_rows(self, state, j: int) -> torch.Tensor:
        """f32[O, 16, 128]: shard j's live pool rows with every lane of a
        block that another shard owns zeroed.  After a halo reduction the
        owner's copy of a block holds the sum over shards; a copy elsewhere
        only its window share."""
        cfg = self.cfg
        s = state[j]
        g, gzo = cfg.grid_size, cfg.grid_size_zo
        nb = s.partition.keys.shape[0]
        dev = s.grid.device
        live = torch.arange(nb, device=dev) < s.partition.count
        kk = torch.clamp(s.partition.keys, max=cfg.num_oct_keys - 1).long()
        coords = (torch.div(kk, gzo * g, rounding_mode="floor")[:, None],
                  (torch.div(kk, gzo, rounding_mode="floor") % g)[:, None],
                  (kk % gzo)[:, None] * 8 + torch.arange(8, device=dev)[None, :])
        owner = torch.zeros((nb, 8), dtype=torch.long, device=dev)
        for (_name, dim), n_ax in zip(self.comm.axes, self.mesh_shape):
            owner = owner * n_ax + torch.clamp(
                torch.div(coords[dim], g // n_ax, rounding_mode="floor"), 0, n_ax - 1)
        mine = (owner == self.comm.shards[j]) & live[:, None]
        lanes = mine.repeat_interleave(16, dim=1)                 # [nb, 128]
        return s.grid[:nb] * lanes[:, None, :].to(s.grid.dtype)

    def diagnostics(self, state) -> dict:
        """Global probes over every shard, each block counted on the shard
        that owns it (``owned_rows``); totals over a ``DistGroup`` are summed
        across its processes."""
        sums = []
        for j in range(len(state)):
            rows = self.owned_rows(state, j).double()
            nb = rows.shape[0]
            sums.append(torch.cat([rows[:, 0:4].sum().reshape(1),
                                   rows[:, 4:16].reshape(nb, 3, 4, 128).sum(dim=(0, 2, 3))]
                                  ).cpu().numpy())
        per_shard = lambda get: [int(get(s).sum()) for s in state]
        local = np.concatenate([
            np.sum(sums, axis=0),
            [sum(per_shard(lambda s: s.mig_dropped)), sum(per_shard(lambda s: s.halo_overflow))],
            [sum(per_shard(lambda s, i=i: s.models[i].active))
             for i in range(len(self.materials))],
            [sum(per_shard(lambda s, i=i: s.models[i].tiles.dropped))
             for i in range(len(self.materials))],
            [sum(per_shard(lambda s: s.partition.overflow))]]).astype(np.float64)
        tot = self.group.sum_all(local)
        nm = len(self.materials)
        out = {
            "grid_mass": float(tot[0]),
            "grid_momentum": tot[1:4].astype(np.float32),
            "t": float(state[0].t),
            "dt": float(state[0].dt),
            "step": int(state[0].step),
            "active_blocks": [int(s.partition.count[0]) for s in state],
            "migration_dropped": int(tot[4]),
            "halo_overflow": int(tot[5]),
            "block_overflow": int(tot[6 + 2 * nm]),
            "null_block_mass": float(sum(float(s.grid[self.cfg.null_oct, 0:4].abs().sum())
                                         for s in state)),
        }
        for i in range(nm):
            out[f"model{i}_active"] = int(tot[6 + i])
            out[f"model{i}_dropped_tiles"] = int(tot[6 + nm + i])
        return out
