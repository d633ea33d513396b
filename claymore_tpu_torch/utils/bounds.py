"""Bounds: the least time an H100 SXM could take for a kernel's work.

The larger of its bytes over 3.35 TB/s and its float32 operations over
67 TFLOP/s (the published peaks at 700 W).  Bytes: each input read once,
each output written once.  Operations: additions, multiplications,
divisions, square roots and transcendentals counted one each, per cell or
particle as the kernel source does them, for the work these inputs need.

``grid_bound`` is the grid kernels' (K2, K2-AC, K2-SDF), ``g2p2g_bound``
the transfer kernel's (K1), ``dma_bound`` the pool-row probes' (P5, P6),
``rebucket_bound`` the full rebucket's (``csrc/rebucket.cu``),
``partition_bound`` and ``first_marked_bound`` the partition rebuild's and
the compaction's (``csrc/partition.cu``), ``halo_bound`` and
``migrate_bound`` the mesh's halo and migration packs' (``csrc/halo.cu``);
``chip_smoke.py`` and the profiling scripts report them beside the
kernels' times.
"""

from __future__ import annotations

import torch

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# K2 per massive cell: 1/m, 3 momenta x 1/m, 3 gravity adds, |v|^2 (5)
K2_OPS = 12
# per collider and massive cell: world -> material (3 subtractions, 3
# divisions; 15 more for a rotation) and the SDF of its type
# (csrc/grid_update.cu: analytic_sd and analytic_normal, sdf_value and
# sdf_normal); the projection of the cells that hit is data-dependent and
# not counted
K2_SDF_OPS = {"HalfSpace": 8, "Sphere": 14, "Box": 35,
              "SignedDistanceCollider": 109}
# K1 per active particle (csrc/g2p2g.cu): two stencils 132, G2P 783,
# advection 6, P2G 876; and each material's update
K1_OPS = 1797
K1_MATERIAL_OPS = {"fixed_corotated": 576, "jfluid": 42, "sand": 1216, "nacc": 1251}
K1_FIELD_FLOATS = {"fixed_corotated": 9, "jfluid": 1, "sand": 10, "nacc": 10}


def bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def grid_bound(cfg, pool, partition, colliders=(), t: float = 0.0) -> dict:
    """K2's bound on ``pool``: the pool read and written, the keys and the
    collider tables read once; K2_OPS per massive cell plus each collider's
    transform and SDF, the SDF grid's only where the cell lies in its band
    (the kernel samples nothing elsewhere)."""
    from ..core import grid
    from ..models.boundary import SignedDistanceCollider

    massive = pool[:, 0:4] > 0.0
    n_mass = int(massive.sum())
    nbytes = 2 * pool.numel() * 4 + cfg.max_active_octs * 4 + len(colliders) * 96
    ops = K2_OPS * n_mass
    x3 = None
    for c in colliders:
        per = 6 + (15 if c.motion.rotating else 0)
        name = type(c).__name__
        if isinstance(c, SignedDistanceCollider):
            nbytes += c.values.size * 16
            if x3 is None:
                x3 = tuple(a[massive] for a in grid.cell_positions(cfg, partition))
            ops += per * n_mass + K2_SDF_OPS[name] * sdf_band_cells(c, x3, t)
        else:
            ops += (per + K2_SDF_OPS[name]) * n_mass
    return bound(nbytes, ops)


def sdf_band_cells(col, x3, t: float) -> int:
    """How many of the world positions ``x3`` lie in the SDF collider's
    interior band once posed at time ``t``."""
    tt = torch.tensor(t, dtype=torch.float32, device=x3[0].device)
    _, x_mat, _ = col.pose(x3, tt)
    lo, hi = col.band
    inside = torch.ones_like(x_mat[0], dtype=torch.bool)
    for c in x_mat:
        inside &= (c >= lo) & (c < hi)
    return int(inside.sum())


def g2p2g_bound(cfg, mat, state, model_idx: int = 0) -> dict:
    """K1's bound on ``state``: every slot's position, fields, active flag
    and id read and written, the tiles' coordinates and flags read, the
    velocity rows of the active octs read and their 16 rows written;
    K1_OPS plus the material's update per active particle."""
    model = state.models[model_idx]
    slots = model.pos.shape[1]
    tiles = model.tiles.block.shape[0]
    octs = int(state.partition.count[0])
    n_act = int(model.active.sum())
    nf = K1_FIELD_FLOATS[mat.name]
    nbytes = (2 * slots * (12 + 4 * nf + 1 + 4) + tiles * 13
              + octs * (12 + 16) * 512)
    return bound(nbytes, n_act * (K1_OPS + K1_MATERIAL_OPS[mat.name]))


def dma_bound(idx, run_rows: int, rmw: bool = False) -> dict:
    """P5's bound (P6's with ``rmw``) for the run starts ``idx`` i32[G, D]:
    every distinct pool row the runs touch read once (and written once for
    P6), the starts read, the output written (G rows for P5, G x 128 floats
    for P6); one addition per float of every run's rows."""
    g, d = idx.shape
    r = torch.arange(run_rows, device=idx.device)
    distinct = int(torch.unique(idx.long()[..., None] + r).numel())
    row_bytes = 16 * 128 * 4
    nbytes = (distinct * row_bytes * (2 if rmw else 1) + idx.numel() * 4
              + g * (128 * 4 if rmw else row_bytes))
    return bound(nbytes, g * d * run_rows * 16 * 128)


def rebucket_bound(cfg, slots: int, channels: int, active: int = None,
                   segments: int = 0) -> dict:
    """The full rebucket's bound (``ops/rebucket_kernel.py:sort_permute``)
    over ``slots`` slots of ``channels`` 4-byte channels (position 3, the
    material's fields, the id: 13 for FixedCorotated), ``active`` of them
    active (all by default), in ``segments`` block segments.

    Beyond the sort, per slot: its active flag read, 1 B, its key written,
    4 B, every channel written, 4 C B, and its new active flag, 1 B; per
    active slot: its position read for the key, 12 B, its sorted key, 4 B
    (the heads pass: the active keys are a prefix), its sort index, 4 B
    (int32), and every channel read once, 4 C B.  In all
    ``slots (6 + 4 C) + active (20 + 4 C)`` bytes, 26 + 8 C = 130 a slot
    for FixedCorotated when every slot is active.  The plan's own traffic
    is added (per segment its start written and read and its key read, per
    tile its window and key written); operations are negligible.  ``sort``
    is the key sort alone, its own line: each key read and each sorted key
    and int32 index written, 12 B a slot.  ``stages`` splits the bytes over the
    kernels, each kernel's inputs and outputs: ``keys`` (flags and the
    active positions in, keys out), ``heads`` (the active sorted keys in,
    the starts out), ``plan`` (the starts and the heads' keys in, the
    tiles' windows and keys and the drop count out) and ``place``
    (windows, indices and channels in, channels and the flag out); the
    total is their sum."""
    active = slots if active is None else active
    tiles = slots // cfg.particle_tile
    stages = {
        "keys": 5 * slots + 12 * active,
        "heads": 4 * (active + 1) + 4 * (segments + 1),
        "plan": 4 * (segments + 1) + 4 * segments + 12 * tiles + 4,
        "place": 8 * tiles + active * (4 + 4 * channels) + slots * (4 * channels + 1),
    }
    out = bound(sum(stages.values()), 0)
    out["sort"] = bound(12 * slots, 0)
    out["stages"] = {k: bound(v, 0) for k, v in stages.items()}
    return out


def first_marked_bound(n: int, size: int) -> dict:
    """The compaction's bound (``ops/partition_kernel.py:first_marked``) over
    ``n`` flags into ``size`` indices: each flag read once (1 B), each index
    written (8 B) and the count (4 B)."""
    return bound(n + 8 * size + 4, 0)


def partition_bound(cfg, live_rows: int, tiles: int, extra: bool, octs: int) -> dict:
    """The partition rebuild's bound (``ops/partition_kernel.py``) on one
    rebuild's inputs: ``live_rows`` rows of the old partition, ``tiles``
    tile keys over every model, a halo mask or not, ``octs`` octs in the
    new partition.  ``stages``, each kernel's inputs read once and outputs
    written once:

    * ``oct_mask``: per live row its key (4 B) and its mass rows 0-3
      (2 KB), the count, per tile its key (4 B), the halo mask (G^3 B)
      where given; one flag (1 B) written per oct key;
    * ``remap``: the flags (1 B an oct key) read, the keys (4 nb), the table
      (4 (no + 1)), the count and overflow written; per oct of the new
      partition its old table entry (4 B) and its old row (8 KB) read; the
      new pool (8 KB a row, nb + 1 rows) written;
    * ``finalize_tiles``: per tile its key and one table entry read (8 B),
      its address, coordinates and flag written (17 B).

    ``rebuild`` is ``oct_mask`` + ``remap``, the total adds
    ``finalize_tiles``; operations are negligible."""
    no, nb = cfg.num_oct_keys, cfg.max_active_octs
    row = 16 * 128 * 4
    stages = {
        "oct_mask": live_rows * (4 + row // 4) + 4 + 4 * tiles
        + (cfg.grid_size ** 3 if extra else 0) + no,
        "remap": no + 4 * nb + 4 * (no + 1) + 8 + octs * (4 + row) + (nb + 1) * row,
        "finalize_tiles": 25 * tiles,
    }
    out = bound(sum(stages.values()), 0)
    out["stages"] = {k: bound(v, 0) for k, v in stages.items()}
    out["rebuild"] = bound(stages["oct_mask"] + stages["remap"], 0)
    return out


def halo_bound(cfg, h: int, packed: int, packed_octs: int, received: int, hits: int) -> dict:
    """The halo kernels' bounds (``ops/halo_kernel.py``), each stage's
    inputs read once and outputs written once:

    * ``halo_pack``, one shard over ``packed`` windows: every pool-row key
      (4 B, nb of them) and the count, the ``packed_octs`` rows it packs
      (8 KB each) read; ``h`` rows (8 KB) and their key and bits (8 B) a
      window written;
    * ``halo_mask`` over ``received`` directions of ``h`` rows: their keys
      and bits (8 B a row) read, the mask (G^3 + 1 B) written;
    * ``halo_add``: the received keys (4 B a row) read, and for the
      ``hits`` rows whose oct the pool holds, the row's table entry (4 B),
      the received row and the pool row read and the pool row written (8 KB
      each); the null row written.

    Operations (one add a float of the hits) are negligible."""
    row = 16 * 128 * 4
    stages = {
        "halo_pack": 4 * cfg.max_active_octs + 4 + packed_octs * row + packed * h * (row + 8),
        "halo_mask": received * h * 8 + cfg.grid_size ** 3 + 1,
        "halo_add": received * h * 4 + hits * (4 + 3 * row) + row,
    }
    return {k: bound(v, 0) for k, v in stages.items()}


def migrate_bound(slots: int, channels: int, k: int) -> dict:
    """The migration pack's bound (``ops/halo_kernel.py:migrate_pack``) on
    one shard and axis: per slot its position along the axis (4 B) and its
    active flag (1 B) read and its new flag (1 B) written; both payloads
    (``channels`` x ``k`` words each) written."""
    return bound(6 * slots + 2 * channels * k * 4, 0)
