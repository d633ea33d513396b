"""The mesh's halo exchange and migration pack as plain functions on tensors.

These are the plain twins of the CUDA kernels in ``csrc/halo.cu``
(``ops/halo_kernel.py`` launches them on a card and runs these on the
CPU); ``parallel/multi.py:HaloComm`` calls the wrapper.  The JAX package
runs the same functions in XLA inside ``shard_map``
(``claymore_tpu/parallel/multi.py``: ``_pack_window`` and
``exchange_halo``, ``halo_mass_mask``, ``add_halo``, ``migrate``'s pack),
and each twin here gives its result exactly.

A window is one direction's view of a shard's slab faces: a tuple of
``(dim, edge)``, one per mesh axis the direction crosses, ``dim`` the
spatial dimension the axis cuts and ``edge`` the block coordinate of the
face (the slab's ``hi`` for a step of +1, its ``lo`` for -1).  An oct
meets the window when on every such axis the blocks it covers reach into
``[edge - margin, edge + margin)``; along z (where an oct covers 8 blocks)
its row's lanes outside that range are masked off.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..config import SimConfig
from ..core import octpool
from ..core import partition as part
from ..core.types import ParticleModel

Window = Tuple[Tuple[int, int], ...]


def oct_span(cfg: SimConfig, keys: torch.Tensor, dim: int):
    """(lo, hi) block coordinates each flat oct key covers along ``dim``
    (octs are single blocks in x and y and 8-block runs in z)."""
    bx, by, bzo = octpool.oct_coord(cfg, torch.clamp(keys, max=cfg.num_oct_keys - 1))
    if dim == 0:
        return bx, bx + 1
    if dim == 1:
        return by, by + 1
    return bzo * 8, bzo * 8 + 8


def window_marks(cfg: SimConfig, keys: torch.Tensor, count: torch.Tensor,
                 windows: Sequence[Window], h: int, margin: int):
    """(marks, overflow): per window, bool[nb] over the partition's keys,
    the live octs (below ``count``, an oct key) that meet it; and i32[1],
    the octs past ``h`` summed over every window."""
    live = ((torch.arange(keys.shape[0], device=keys.device) < count)
            & (keys < cfg.num_oct_keys))
    marks = []
    overflow = torch.zeros((1,), dtype=torch.int32, device=keys.device)
    for win in windows:
        cond = live
        for dim, edge in win:
            lo, hi = oct_span(cfg, keys, dim)
            cond = cond & (hi > edge - margin) & (lo < edge + margin)
        overflow = overflow + torch.clamp(cond.sum(dtype=torch.int32) - h, min=0).reshape(1)
        marks.append(cond)
    return marks, overflow


def pack_marked(cfg: SimConfig, pool: torch.Tensor, keys: torch.Tensor, cond: torch.Tensor,
                win: Window, h: int, margin: int):
    """(meta i32[2, h], rows f32[h, 16, 128]) of the first ``h`` octs where
    ``cond`` holds: meta's keys (``num_oct_keys`` past the last) and each
    row's 8 per-block mass bits; each row is its pool row times its lane
    mask (1.0 for the blocks inside the window's z ranges, 0.0 elsewhere
    and on every lane past the last oct, whose row is pool row nb - 1)."""
    no, nb = cfg.num_oct_keys, cfg.max_active_octs
    idx = part._first_marked(cond, h, nb)
    valid = idx < nb
    gidx = torch.clamp(idx, max=nb - 1)
    k = torch.where(valid, keys[gidx], torch.full_like(keys[gidx], no)).to(torch.int32)
    mask = valid[:, None].expand(h, 128)
    zedges = [edge for dim, edge in win if dim == 2]
    if zedges:
        lane_bz = torch.arange(128, device=keys.device) >> 4
        _, _, bzo = octpool.oct_coord(cfg, torch.clamp(k, max=no - 1))
        bz = bzo[:, None] * 8 + lane_bz[None, :]
        for edge in zedges:
            mask = mask & (bz >= edge - margin) & (bz < edge + margin)
    rows = pool[gidx] * mask[:, None, :].to(pool.dtype)
    has = (rows[:, 0:4].reshape(h, 4, 8, 16) != 0.0).any(dim=3).any(dim=1)
    bits = (has.to(torch.int32) << torch.arange(8, dtype=torch.int32,
                                                 device=keys.device)).sum(dim=1)
    return torch.stack([k, bits.to(torch.int32)]), rows


def pack_windows(cfg: SimConfig, pool: torch.Tensor, keys: torch.Tensor, count: torch.Tensor,
                 windows: Sequence[Window], packed: Sequence[bool], h: int, margin: int):
    """One shard's halo packs: (packs, overflow), ``packs[d]`` the
    ``pack_marked`` (meta, rows) of window d where ``packed[d]``, else None;
    the overflow counts every window, packed or not."""
    marks, overflow = window_marks(cfg, keys, count, windows, h, margin)
    packs = [pack_marked(cfg, pool, keys, cond, win, h, margin) if p else None
             for cond, win, p in zip(marks, windows, packed)]
    return packs, overflow


def mass_mask(cfg: SimConfig, received) -> Optional[torch.Tensor]:
    """bool[G^3]: the blocks whose mass bit is set in some received (keys,
    bits, rows); None if nothing was received."""
    if not received:
        return None
    n3 = cfg.grid_size ** 3
    dev = received[0][0].device
    mask = torch.zeros((n3 + 1,), dtype=torch.bool, device=dev)
    lanes = torch.arange(8, dtype=torch.int32, device=dev)
    for keys, bits, _rows in received:
        has = ((bits[:, None] >> lanes[None, :]) & 1) > 0
        bkeys = octpool.oct_block_keys(cfg, keys)
        idx = torch.where(has & (bkeys < n3), bkeys, torch.full_like(bkeys, n3))
        mask.index_fill_(0, idx.reshape(-1).long(), True)
    return mask[:n3]


def add_rows(cfg: SimConfig, pool: torch.Tensor, table: torch.Tensor, received) -> torch.Tensor:
    """Add each received row into ``pool`` (in place) at its key's slot in
    ``table``, direction by direction; rows of keys past the oct keys or of
    octs the table does not hold fall into the null row, which ends zero."""
    if not received:
        return pool
    no = cfg.num_oct_keys
    for keys, _bits, rows in received:
        slots = table[torch.clamp(keys, max=no).long()]
        slots = torch.where(keys < no, slots, torch.full_like(slots, cfg.null_oct))
        pool.index_add_(0, slots.long(), rows)
    pool[cfg.null_oct] = 0.0
    return pool


def payload_channels(m: ParticleModel) -> int:
    """Rows of a migration payload of ``m``: pos (3), valid, pid, and each
    field's channels."""
    return 5 + sum(1 if v.dim() == 1 else v.shape[0] for v in m.fields.values())


def payload(m: ParticleModel, gidx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """f32[C, K]: pos, valid (1.0 / 0.0), pid (its int32 bits) and the
    fields of the slots ``gidx``, the fields in sorted name order."""
    k = gidx.shape[0]
    rows = [m.pos[:, gidx], valid.to(torch.float32)[None],
            m.pid[gidx].view(torch.float32)[None]]
    for _name, v in sorted(m.fields.items()):
        rows.append(v[..., gidx].reshape(-1, k))
    return torch.cat(rows)


def migrate_pack(cfg: SimConfig, m: ParticleModel, dim: int, lo: int, hi: int, k: int):
    """One shard's crossers along ``dim``: (left f32[C, k], right f32[C, k],
    active, dropped i32[1]).  The active slots whose home block lies below
    ``lo`` (left) or at or past ``hi`` (right), the first ``k`` of each side
    in slot order, as ``payload``s; the columns past the last crosser hold
    slot S - 1 with valid 0.  Every crosser is deactivated, shipped or not;
    ``dropped`` counts those past ``k``."""
    s_cap = m.pos.shape[1]
    hb = part.home_block(cfg, m.pos[dim:dim + 1])[0]
    active = m.active
    out: List[torch.Tensor] = []
    dropped = torch.zeros((1,), dtype=torch.int32, device=m.pos.device)
    for cond in (active & (hb < lo), active & (hb >= hi)):
        idx = part._first_marked(cond, k, s_cap)
        dropped = dropped + torch.clamp(cond.sum(dtype=torch.int32) - k, min=0).reshape(1)
        out.append(payload(m, torch.clamp(idx, max=s_cap - 1), idx < s_cap))
        active = active & ~cond
    return out[0], out[1], active, dropped
