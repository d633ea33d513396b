"""Oct-packed grid pool layout helpers.

The sparse grid pool is ``f32[max_active_octs + 1, 16, 128]``: one row per
OCT = 8 z-consecutive, z-aligned 4^3 blocks.  rows = (channel c in 0..3,
cx in 0..3); lanes = (z8 in 0..7, cy, cz).  The trailing row is the *null
oct* absorbing traffic for inactive octs.  The layout is the JAX package's
(``claymore_tpu/core/octpool.py``) so pools compare and convert unchanged.

A *block address* (``braddr``) is ``oct_slot * 8 + z8``; ``cfg.null_block``
is the first block of the null oct.
"""

from __future__ import annotations

import torch

from ..config import SimConfig


def oct_key_from_coord(cfg: SimConfig, coord: torch.Tensor) -> torch.Tensor:
    """[3, ...] block coords -> flat oct key; out-of-range -> sentinel."""
    g = cfg.grid_size
    gzo = cfg.grid_size_zo
    valid = ((coord >= 0) & (coord < g)).all(dim=0)
    k = (coord[0] * g + coord[1]) * gzo + (coord[2] >> 3)
    return torch.where(valid, k, torch.full_like(k, cfg.num_oct_keys))


def oct_key_from_block_key(cfg: SimConfig, key: torch.Tensor) -> torch.Tensor:
    """flat block key (sentinel n3 for invalid) -> flat oct key."""
    g = cfg.grid_size
    gzo = cfg.grid_size_zo
    n3 = g * g * g
    xy = torch.div(key, g, rounding_mode="floor")
    k = xy * gzo + torch.div(key % g, cfg.oct_z, rounding_mode="floor")
    return torch.where(key < n3, k, torch.full_like(k, cfg.num_oct_keys))


def oct_coord(cfg: SimConfig, okey: torch.Tensor):
    """flat oct key -> (bx, by, bzo) block-column coords."""
    g = cfg.grid_size
    gzo = cfg.grid_size_zo
    bzo = okey % gzo
    by = torch.div(okey, gzo, rounding_mode="floor") % g
    bx = torch.clamp(torch.div(okey, gzo * g, rounding_mode="floor"), max=g - 1)
    return bx, by, bzo


def lookup_braddr(cfg: SimConfig, table: torch.Tensor,
                  coord: torch.Tensor) -> torch.Tensor:
    """[3, ...] block coords -> block address (null_block when inactive)."""
    oslot = table[oct_key_from_coord(cfg, coord).long()]
    z8 = coord[2] & 7
    return torch.where(oslot == cfg.null_oct,
                       torch.full_like(oslot, cfg.null_block), oslot * 8 + z8)


def gather_block_rows(cfg: SimConfig, pool: torch.Tensor,
                      braddr: torch.Tensor) -> torch.Tensor:
    """Block addresses [...] -> per-block rows [..., 4, 64] with the cell
    axis ordered (cx, cy, cz)."""
    oslot = (braddr >> 3).long()
    z8 = (braddr & 7).long()
    r4 = pool.reshape(pool.shape[0], 16, 8, 16)
    blk = r4[oslot, :, z8]                              # [..., 16, 16]
    # rows (c, cx) x lanes (cy, cz) flatten directly to (c, (cx, cy, cz))
    return blk.reshape(braddr.shape + (4, 64))


def scatter_add_block_rows(cfg: SimConfig, pool: torch.Tensor,
                           braddr: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """Add per-block rows [N, 4, 64] (cells ordered (cx, cy, cz)) into the
    pool at block addresses [N], in place.  Null-oct traffic is re-zeroed by
    the caller."""
    oslot = (braddr >> 3).long()
    z8 = (braddr & 7).long()
    p4 = pool.view(pool.shape[0], 16, 8, 16)
    rix = torch.arange(16, device=pool.device)
    p4.index_put_((oslot[:, None], rix[None, :], z8[:, None]),
                  rows.reshape(rows.shape[0], 16, 16), accumulate=True)
    return pool


def block_has_mass(cfg: SimConfig, pool: torch.Tensor) -> torch.Tensor:
    """bool[O, 8]: per (live oct row, z8) any nonzero mass."""
    m = pool[:-1, 0:4]                                   # [O, 4, 128]
    o = m.shape[0]
    return (m.reshape(o, 4, 8, 16) != 0.0).any(dim=3).any(dim=1)


def oct_block_keys(cfg: SimConfig, okeys: torch.Tensor) -> torch.Tensor:
    """oct keys [O] -> flat block keys [O, 8] (sentinel rows -> n3)."""
    g = cfg.grid_size
    n3 = g * g * g
    bx, by, bzo = oct_coord(cfg, torch.clamp(okeys, max=cfg.num_oct_keys - 1))
    base = (bx * g + by) * g + bzo * 8
    keys = base[:, None] + torch.arange(8, dtype=okeys.dtype,
                                        device=okeys.device)[None, :]
    return torch.where((okeys < cfg.num_oct_keys)[:, None], keys,
                       torch.full_like(keys, n3))
