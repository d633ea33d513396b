"""Operations and bytes of the substep's kernels, and the chip's peaks.

Copied from claymore_tpu_torch/utils/bounds.py at commit 5f9f87e (its
``PEAK_*``, ``K1_*``, ``K2_OPS``, ``K2_SDF_OPS``, ``bound``, ``grid_bound``
with its colliders, ``sdf_band_cells``, ``g2p2g_bound``,
``rebucket_bound`` and ``partition_bound``), frozen here
so that a change to the program cannot move the yardstick.  The functions
take plain counts (slots, tiles, octs, particles, cells), which the harness
reads from the program's state; the arithmetic is the original's.  They
count the work these inputs need, whatever implements it: each input byte
read once and each output byte written once.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM, published, dense, at 700 W
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# K2 per massive cell: 1/m, 3 momenta x 1/m, 3 gravity adds, |v|^2 (5)
K2_OPS = 12
# per collider and massive cell: world -> material (3 subtractions, 3
# divisions; the colliders here are static, so no rotation's 15) and the
# SDF of its type; the projection of the cells that hit is data-dependent
# and not counted
K2_TRANSFORM_OPS = 6
K2_SDF_OPS = {"HalfSpace": 8, "Sphere": 14, "Box": 35, "SignedDistanceCollider": 109}
# bytes of one collider's packed record; an SDF node's (value, gradient)
COLLIDER_BYTES = 96
SDF_NODE_BYTES = 16
# the program's collider type of each kind of a configuration file
COLLIDER_TYPES = {"half_space": "HalfSpace", "sphere": "Sphere", "box": "Box",
                  "sdf": "SignedDistanceCollider"}
# K1 per active particle: two stencils 132, G2P 783, advection 6, P2G 876;
# and each material's update
K1_OPS = 1797
K1_MATERIAL_OPS = {"FixedCorotated": 576, "JFluid": 42, "Sand": 1216, "NACC": 1251}
K1_FIELD_FLOATS = {"FixedCorotated": 9, "JFluid": 1, "Sand": 10, "NACC": 10}
ROW_BYTES = 16 * 128 * 4      # one pool row: 8 blocks of 64 cells, 4 channels


def bound(nbytes: float, ops: float) -> dict:
    """The least time: the larger of the bytes over the bandwidth and the
    operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def grid_bound(pool_rows: int, max_active_octs: int, massive_cells: int,
               colliders=()) -> dict:
    """K2: the pool ([rows, 16, 128] floats) read and written, the keys and
    the collider tables read once; K2_OPS per massive cell plus each
    collider's transform and SDF, an SDF grid's only where the cell lies in
    its band (the kernel samples nothing elsewhere).  ``colliders``: one
    dict a static collider, its ``type`` (``K2_SDF_OPS``'s keys), an SDF's
    table ``nodes`` and its ``band_cells`` (``sdf_band_cells``)."""
    nbytes = 2 * pool_rows * ROW_BYTES + max_active_octs * 4 + len(colliders) * COLLIDER_BYTES
    ops = K2_OPS * massive_cells
    for c in colliders:
        if c["type"] == "SignedDistanceCollider":
            nbytes += c["nodes"] * SDF_NODE_BYTES
            ops += K2_TRANSFORM_OPS * massive_cells + K2_SDF_OPS[c["type"]] * c["band_cells"]
        else:
            ops += (K2_TRANSFORM_OPS + K2_SDF_OPS[c["type"]]) * massive_cells
    return bound(nbytes, ops)


def sdf_band_cells(x3, lo: float, hi: float) -> int:
    """How many of the world positions ``x3`` (three f32 tensors) lie in a
    static SDF collider's interior band, [lo, hi) on every axis."""
    inside = torch.ones_like(x3[0], dtype=torch.bool)
    for c in x3:
        inside &= (c >= lo) & (c < hi)
    return int(inside.sum())


def g2p2g_bound(material: str, slots: int, tiles: int, octs: int, active: int) -> dict:
    """K1 of one model: every slot's position, fields, active flag and id
    read and written, the tiles' coordinates and flags read, the velocity
    rows of the active octs read and their 16 rows written; K1_OPS plus
    the material's update per active particle."""
    nf = K1_FIELD_FLOATS[material]
    nbytes = (2 * slots * (12 + 4 * nf + 1 + 4) + tiles * 13
              + octs * (12 + 16) * 512)
    return bound(nbytes, active * (K1_OPS + K1_MATERIAL_OPS[material]))


def rebucket_bound(particle_tile: int, slots: int, channels: int, active: int,
                   segments: int) -> dict:
    """The full rebucket of one model (keys, heads, plan, placement) over
    ``slots`` slots of ``channels`` 4-byte channels (position 3, the
    fields, the id), ``active`` of them active, in ``segments`` home-block
    segments; ``sort`` is the key sort alone (each key read, each sorted
    key and index written)."""
    tiles = slots // particle_tile
    stages = {
        "keys": 5 * slots + 12 * active,
        "heads": 4 * (active + 1) + 4 * (segments + 1),
        "plan": 4 * (segments + 1) + 4 * segments + 12 * tiles + 4,
        "place": 8 * tiles + active * (8 + 4 * channels) + slots * (4 * channels + 1),
    }
    out = bound(sum(stages.values()), 0)
    out["sort"] = bound(16 * slots, 0)
    return out


def partition_bound(num_oct_keys: int, max_active_octs: int, live_rows: int, tiles: int,
                    octs: int, halo_mask_bytes: int = 0) -> dict:
    """The partition rebuild (oct mask, remap) and ``finalize_tiles`` on one
    rebuild's inputs: ``live_rows`` rows of the old partition, ``tiles``
    tile keys over every model, ``octs`` octs in the new partition."""
    no, nb = num_oct_keys, max_active_octs
    stages = {
        "oct_mask": live_rows * (4 + ROW_BYTES // 4) + 4 + 4 * tiles + halo_mask_bytes + no,
        "remap": no + 4 * nb + 4 * (no + 1) + 8 + octs * (4 + ROW_BYTES)
        + (nb + 1) * ROW_BYTES,
        "finalize_tiles": 25 * tiles,
    }
    return bound(sum(stages.values()), 0)
