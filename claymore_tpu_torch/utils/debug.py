"""Debug / validation helpers.

``pool_to_dense`` is numpy only and reads either package's state (JAX
arrays, numpy arrays or tensors on any device), so the two can be compared
cell by cell.
"""

from __future__ import annotations

import numpy as np

from ..config import SimConfig


def to_numpy(x) -> np.ndarray:
    """A tensor (any device), JAX array or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pool_to_dense(cfg: SimConfig, state):
    """Expand the sparse oct pool to dense float64 (m, mom) grids."""
    n = cfg.domain_size
    bs = cfg.block_size
    g = cfg.grid_size
    gzo = cfg.grid_size_zo
    m = np.zeros((n, n, n), np.float64)
    mom = np.zeros((n, n, n, 3), np.float64)
    pool = to_numpy(state.grid).astype(np.float64)
    keys = to_numpy(state.partition.keys)
    count = int(to_numpy(state.partition.count)[0])
    for s in range(count):
        k = keys[s]
        bx = (k // (gzo * g)) * bs
        by = ((k // gzo) % g) * bs
        bz0 = (k % gzo) * 8 * bs
        # row (c, cx), lane (z8, cy, cz) -> [4ch, 4cx, 8z8, 4cy, 4cz]
        oct = pool[s].reshape(4, 4, 8, 4, 4)
        blk = oct.transpose(0, 2, 1, 3, 4)                # c, z8, cx, cy, cz
        for z8 in range(8):
            zz = bz0 + z8 * bs
            m[bx : bx + bs, by : by + bs, zz : zz + bs] = blk[0, z8]
            mom[bx : bx + bs, by : by + bs, zz : zz + bs] = np.moveaxis(
                blk[1:4, z8], 0, -1)
    return m, mom


def check_partition(cfg: SimConfig, partition) -> None:
    """Key <-> slot round trip; raises AssertionError on a broken table."""
    keys = to_numpy(partition.keys)
    table = to_numpy(partition.table)
    count = int(to_numpy(partition.count)[0])
    if int(to_numpy(partition.overflow)[0]) != 0:
        raise AssertionError("partition overflow")
    for s in range(count):
        if not (keys[s] < cfg.num_oct_keys and table[keys[s]] == s):
            raise AssertionError((s, keys[s], table[keys[s]]))
    if not np.all(keys[count:] == cfg.num_oct_keys):
        raise AssertionError("stale keys beyond count")
    if (table != cfg.null_oct).sum() != count:
        raise AssertionError("table and count disagree")


def check_tiles(cfg: SimConfig, state, model_idx: int = 0) -> None:
    """Slot-major invariants: no duplicate particle ids, no dropped
    particles, and every active slot's home block matches its tile."""
    from ..core.partition import home_block, lookup

    m = state.models[model_idx]
    tm = m.tiles
    active = to_numpy(m.active)
    pid = to_numpy(m.pid)[active]
    if len(pid) != len(set(pid.tolist())):
        raise AssertionError("duplicate particle in slots")
    if int(to_numpy(tm.dropped)[0]) != 0:
        raise AssertionError("dropped particles")
    slot_of = to_numpy(lookup(cfg, state.partition.table, home_block(cfg, m.pos)))
    tile_of_slot = np.repeat(to_numpy(tm.block), cfg.particle_tile)
    if not np.all(slot_of[active] == tile_of_slot[active]):
        raise AssertionError("slot home block differs from its tile")
