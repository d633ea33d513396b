"""Sparse block partition: activation, compaction, tile building.

Port of ``claymore_tpu/core/partition.py``.  The full rebucket moves the
particle state into its new tile layout by one stable key sort and one
gather per channel; the incremental one moves only the particles whose
home block changed into free tiles.  The padded destination slots come
from the same segment arithmetic as the JAX package, so slot order, tile
keys and the partition agree exactly.

Nothing here reads a value back to the host: variable-length results
(nonzero, dropped elements) are written through a trailing dummy slot
instead of boolean indexing, so the rebuild queues on the device without a
synchronisation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import SimConfig
from . import octpool
from .types import Partition, TileMap


# --------------------------------------------------------------------------
# coordinate helpers (coords are [3, ...])
# --------------------------------------------------------------------------

def flatten_key(cfg: SimConfig, coord: torch.Tensor) -> torch.Tensor:
    """[3, ...] block coords -> flat key; out-of-range -> sentinel (G^3)."""
    g = cfg.grid_size
    valid = ((coord >= 0) & (coord < g)).all(dim=0)
    flat = (coord[0] * g + coord[1]) * g + coord[2]
    return torch.where(valid, flat, torch.full_like(flat, g * g * g))


def unflatten_key(cfg: SimConfig, key: torch.Tensor) -> torch.Tensor:
    """flat key -> [3, ...] block coords."""
    g = cfg.grid_size
    kz = key % g
    ky = torch.div(key, g, rounding_mode="floor") % g
    kx = torch.clamp(torch.div(key, g * g, rounding_mode="floor"), max=g - 1)
    return torch.stack([kx, ky, kz], dim=0)


def lookup(cfg: SimConfig, table: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """[3, ...] block coords -> block address (null_block when inactive/OOB)."""
    return octpool.lookup_braddr(cfg, table, coord)


def base_cell(cfg: SimConfig, pos: torch.Tensor) -> torch.Tensor:
    """Lowest corner cell of the quadratic B-spline stencil: round(x/dx) - 1."""
    return torch.floor(pos * cfg.dx_inv + 0.5).to(torch.int32) - 1


def home_block(cfg: SimConfig, pos: torch.Tensor) -> torch.Tensor:
    """Home block = block of cell (base - 1): the 3^3 stencil and its
    one-step advected version stay inside the 2^3 block arena anchored at
    the home block."""
    return (base_cell(cfg, pos) - 1) >> cfg.block_bits


def _shift_right(x: torch.Tensor, first) -> torch.Tensor:
    """[first, x[0], ..., x[-2]]"""
    head = torch.full((1,), first, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[:-1]])


def _last_marked(mark: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``values`` at the last marked position at or before each i (0 before
    the first mark) — ``cummax(where(mark, values, 0))`` for values that
    do not decrease along the marks.  torch.cummax takes ~120 ms on 41M
    elements on an H100; this cumsum + scatter + gather form ~2 ms."""
    n = mark.shape[0]
    rank = torch.cumsum(mark, dim=0)                # marks at or before i
    buf = torch.zeros((n + 2,), dtype=values.dtype, device=values.device)
    buf.scatter_(0, torch.where(mark, rank, torch.full_like(rank, n + 1)), values)
    return buf[rank]


def _compact_into(n_out: int, dest: torch.Tensor, src: torch.Tensor,
                  fill) -> torch.Tensor:
    """out[dest[j]] = src[j] for dest < n_out, ``fill`` elsewhere; entries
    whose dest is n_out land in a dummy slot that is cut off."""
    out = torch.full((n_out + 1,), fill, dtype=src.dtype, device=src.device)
    out.scatter_(0, dest, src)
    return out[:n_out]


# --------------------------------------------------------------------------
# tile (bucket) building
# --------------------------------------------------------------------------

def sort_permute(cfg: SimConfig, model, num_tiles: int, region_fn=None):
    """Full rebucket: group slots into block-aligned, oct-group-padded tiles
    and move the whole particle state into the new layout.

    Level 1 of the padding tile-aligns block boundaries, level 2 aligns
    home-oct boundaries to groups of ``group_tiles`` tiles.  Particles that
    do not fit the slot capacity are counted in ``dropped``.

    ``region_fn``: a bool predicate over flat block keys.  Slots whose home
    block satisfies it sort first (keys ascending within each region): the
    multi-device engine makes its halo-boundary tiles a prefix this way, so
    the transfer can run them, ship the halo, then run the rest.  The
    interior's offset ``G^3 + 8`` is a multiple of 8, so oct grouping
    (key >> 3) survives it.

    Returns (permuted model, tile_keys i32[T], dropped i32[1]).
    """
    s_cap = model.pos.shape[1]
    tile = cfg.particle_tile
    n3 = cfg.grid_size ** 3
    dev = model.pos.device

    key = flatten_key(cfg, home_block(cfg, model.pos))
    key = torch.where(model.active, key, torch.full_like(key, n3)).to(torch.int32)
    if region_fn is None:
        sort_src, sentinel = key, n3
    else:
        off = n3 + 8
        sentinel = 2 * off
        if sentinel >= 1 << 30:
            raise ValueError("domain too large for region packing")
        interior = ~region_fn(torch.clamp(key, max=n3 - 1))
        sort_src = torch.where(key < n3, key + interior.to(torch.int32) * off,
                               torch.full_like(key, sentinel))
    skey, perm = torch.sort(sort_src, stable=True)
    act_s = skey < sentinel

    skey64 = skey.long()
    iota = torch.arange(s_cap, dtype=torch.int64, device=dev)
    prev_key = _shift_right(skey64, -1)
    boundary = (skey64 != prev_key) & act_s
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    seg_start = _last_marked(boundary, iota)
    prev_seg_start = _shift_right(seg_start, 0)
    prev_len = torch.where(boundary, iota - prev_seg_start, zero)
    waste = torch.where(boundary, (-prev_len) % tile, zero)
    p1 = iota + torch.cumsum(waste, dim=0)
    gt = cfg.group_tiles * tile
    o_boundary = ((skey64 >> 3) != (prev_key >> 3)) & boundary
    o_start_p1 = _last_marked(o_boundary, p1)
    prev_o_p1 = _shift_right(o_start_p1, 0)
    prev_o_len = torch.where(o_boundary, p1 - prev_o_p1, zero)
    waste2 = torch.where(o_boundary, (-prev_o_len) % gt, zero)
    new_slot = p1 + torch.cumsum(waste2, dim=0)
    fits = act_s & (new_slot < s_cap)
    dropped = (act_s & ~fits).sum(dtype=torch.int32).reshape(1)
    dest = torch.where(fits, new_slot, torch.full_like(new_slot, s_cap))

    # invert the placement once (sorted index landing in each slot, -1 for
    # an empty slot), then move every channel with one gather
    src = _compact_into(s_cap, dest, iota, -1)
    active = src >= 0
    src = torch.clamp(src, min=0)
    gather = perm[src]

    def place(x, fill=0):
        return torch.where(active, x[..., gather], fill)

    pos = place(model.pos)
    fields = {k: place(v) for k, v in model.fields.items()}
    pid = place(model.pid, s_cap)
    # each tile's block key: the sort key less the region offset
    tkey = skey if region_fn is None else key[perm]
    tile_keys = torch.where(active, tkey[src], n3)[::tile].contiguous()

    new_model = type(model)(pos=pos, fields=fields, active=active, pid=pid,
                            tiles=model.tiles)
    return new_model, tile_keys, dropped


def arena_margin(cfg: SimConfig, model) -> torch.Tensor:
    """Minimum distance in cells (can go negative) of any active particle to
    its tile's transfer-arena bound, as a 0-d tensor: how many cells of
    further drift the current bucketing tolerates."""
    tm = model.tiles
    t = tm.bcoord.shape[1]
    tile = cfg.particle_tile
    origin = (tm.bcoord + cfg.arena_lo) * cfg.block_size            # [3, T]
    c = (model.pos.reshape(3, t, tile) * cfg.dx_inv - 0.5
         - origin[:, :, None].to(torch.float32))
    m = torch.minimum(c, (cfg.arena_cells - 2) - c)
    live = model.active.reshape(1, t, tile) & tm.tvalid[None, :, None]
    return torch.where(live, m, torch.inf).min()


def _first_marked(mark: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Indices of the first ``size`` True entries of ``mark`` in ascending
    order, ``fill`` past the last one: ``jnp.nonzero(mark, size=size,
    fill_value=fill)`` without a host synchronisation."""
    rank = torch.cumsum(mark, dim=0) - 1
    dest = torch.where(mark & (rank < size), rank, torch.full_like(rank, size))
    iota = torch.arange(mark.shape[0], dtype=torch.int64, device=mark.device)
    return _compact_into(size, dest, iota, fill)


def tile_block_keys(cfg: SimConfig, tiles: TileMap) -> torch.Tensor:
    """i32[T]: each tile's block key as the TileMap stands (G^3 for a tile
    that is not valid), the input of ``incremental_plan``."""
    n3 = cfg.grid_size ** 3
    key = flatten_key(cfg, tiles.bcoord)
    return torch.where(tiles.tvalid, key, torch.full_like(key, n3)).to(torch.int32)


def incremental_plan(cfg: SimConfig, model, tile_keys: torch.Tensor):
    """Stable-tile rebucket: move only the particles whose home block is no
    longer their tile's block; the others keep their slots.

    Movers (the first ``mover_capacity_frac`` of the slots' worth, in slot
    order) are sorted stably by their new home block, packed into
    tile-aligned runs and placed into the tiles that hold no active
    particle, in ascending tile order.  Movers past the capacity or past
    the free tiles stay active where they are and are counted in
    ``deferred``.  Tiles left empty release their key; each mover tile takes
    its movers' key.  Slots a mover left, and the slots of a free tile no
    mover fills, keep their old contents, inactive.

    Returns (model, tile_keys i32[T], deferred i32[1]), equal to the JAX
    package's ``incremental_plan``."""
    s_cap = model.pos.shape[1]
    tile = cfg.particle_tile
    num_tiles = tile_keys.shape[0]
    n3 = cfg.grid_size ** 3
    m_cap = max(tile, int(s_cap * cfg.mover_capacity_frac))
    dev = model.pos.device

    key = flatten_key(cfg, home_block(cfg, model.pos))
    key = torch.where(model.active, key, torch.full_like(key, n3)).to(torch.int32)
    tk_slot = tile_keys.repeat_interleave(tile)
    stay = model.active & (key == tk_slot)
    mover = model.active & ~stay

    midx = _first_marked(mover, m_cap, s_cap)
    got_m = midx < s_cap
    deferred = mover.sum(dtype=torch.int32) - got_m.sum(dtype=torch.int32)
    gmid = torch.clamp(midx, max=s_cap - 1)
    mkey = torch.where(got_m, key[gmid], torch.full_like(gmid, n3, dtype=torch.int32))

    # pack movers into fresh tiles: sort by key, pad to tile boundaries
    iota_m = torch.arange(m_cap, dtype=torch.int64, device=dev)
    skey, sord = torch.sort(mkey, stable=True)
    act_s = skey < n3
    skey64 = skey.long()
    boundary = (skey64 != _shift_right(skey64, -1)) & act_s
    seg_start = _last_marked(boundary, iota_m)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    prev_len = torch.where(boundary, iota_m - _shift_right(seg_start, 0), zero)
    waste = torch.where(boundary, (-prev_len) % tile, zero)
    mslot = iota_m + torch.cumsum(waste, dim=0)         # mover-local padded slot

    # free tiles: no active slot at all (movers count: a tile whose movers
    # may be deferred must not be handed out under them)
    occ = model.active.reshape(num_tiles, tile).sum(dim=1)
    free = occ == 0
    ftile = _first_marked(free, num_tiles, num_tiles)
    n_free = free.sum()

    # mover tile j -> tile ftile[j]; past the free tiles: deferred
    mtile = torch.div(mslot, tile, rounding_mode="floor")
    placeable = act_s & (mtile < n_free)
    deferred = deferred + (act_s & ~placeable).sum(dtype=torch.int32)
    gt = ftile[torch.clamp(mtile, max=num_tiles - 1)]
    # each unplaced mover lands in a slot of its own past the end
    dest = torch.where(placeable, gt * tile + mslot % tile, s_cap + iota_m)

    src = gmid[sord]

    def place(x):
        buf = torch.cat([x, x.new_zeros(x.shape[:-1] + (m_cap,))], dim=-1)
        buf[..., dest] = x[..., src]
        return buf[..., :s_cap].contiguous()

    pos2 = place(model.pos)
    fields2 = {k: place(v) for k, v in model.fields.items()}
    pid2 = place(model.pid)
    ext = torch.cat([stay, torch.zeros((m_cap,), dtype=torch.bool, device=dev)])
    ext[dest] = placeable
    # deferred movers (past the capacity or the free tiles) stay active
    placed_from = _mark(s_cap, torch.where(placeable, src, s_cap), dev)
    active2 = ext[:s_cap] | (mover & ~placed_from)

    # freed tiles release their key, mover tiles bind theirs (tiles are
    # key-pure: a mover tile's key is the key at its first slot)
    tile_keys2 = torch.where(free, torch.full_like(tile_keys, n3), tile_keys)
    starts = placeable & (mslot % tile == 0)
    buf = torch.cat([tile_keys2, tile_keys2.new_zeros(1)])
    buf.scatter_(0, torch.where(starts, gt, torch.full_like(gt, num_tiles)), skey)
    tile_keys2 = buf[:num_tiles]

    new_model = type(model)(pos=pos2, fields=fields2, active=active2, pid=pid2,
                            tiles=model.tiles)
    return new_model, tile_keys2.to(torch.int32), deferred.reshape(1)


def finalize_tiles(cfg: SimConfig, partition: Partition, tile_keys: torch.Tensor,
                   dropped: torch.Tensor) -> TileMap:
    """Bind tiles to block addresses / coordinates of the new partition."""
    n3 = cfg.grid_size ** 3
    tvalid = tile_keys < n3
    kc = torch.clamp(tile_keys, max=n3 - 1)
    bcoord = unflatten_key(cfg, kc)
    bcoord = torch.where(tvalid[None, :], bcoord, torch.zeros_like(bcoord))
    okey = octpool.oct_key_from_block_key(cfg, tile_keys)
    oslot = partition.table[okey.long()]
    braddr = torch.where(
        tvalid & (oslot != cfg.null_oct),
        oslot * 8 + (kc & 7),
        torch.full_like(oslot, cfg.null_block),
    )
    return TileMap(block=braddr.to(torch.int32), bcoord=bcoord.to(torch.int32),
                   tvalid=tvalid, dropped=dropped)


# --------------------------------------------------------------------------
# partition rebuild
# --------------------------------------------------------------------------

def _dilate(cfg: SimConfig, mask3: torch.Tensor) -> torch.Tensor:
    """OR of shifts by every offset in the transfer's scatter stencil:
    {0,1}^3 for the 2^3 arena, {-1..2}^3 for the 4^3 arena."""
    lo, hi = cfg.arena_lo, cfg.arena_lo + cfg.arena_span - 1
    n = mask3.shape[0]
    out = mask3.clone()

    def span(o):
        """(destination, source) slices along one axis for shift o."""
        return (slice(o, n), slice(0, n - o)) if o >= 0 else \
            (slice(0, n + o), slice(-o, n))

    for ox in range(lo, hi + 1):
        for oy in range(lo, hi + 1):
            for oz in range(lo, hi + 1):
                if ox == 0 and oy == 0 and oz == 0:
                    continue
                (dx_, sx), (dy_, sy), (dz_, sz) = span(ox), span(oy), span(oz)
                out[dx_, dy_, dz_] |= mask3[sx, sy, sz]
    return out


def _mark(n: int, idx: torch.Tensor, dev) -> torch.Tensor:
    """bool[n], True at every idx < n (idx == n is dropped)."""
    buf = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    buf.index_fill_(0, idx.reshape(-1).long(), True)
    return buf[:n]


def particle_blocks(cfg: SimConfig, model_block_keys: Tuple[torch.Tensor, ...],
                    dev) -> torch.Tensor:
    """bool[G^3]: the particles' home blocks (the tiles' block keys, the
    sentinel G^3 dropped), dilated by the transfer stencil."""
    g = cfg.grid_size
    n3 = g * g * g
    pmask = torch.zeros((n3,), dtype=torch.bool, device=dev)
    for keys in model_block_keys:
        pmask |= _mark(n3, torch.clamp(keys, max=n3), dev)
    return _dilate(cfg, pmask.reshape(g, g, g)).reshape(-1)


def rebuild(
    cfg: SimConfig,
    pool: torch.Tensor,
    partition: Partition,
    model_block_keys: Tuple[torch.Tensor, ...],
    extra_mask: Optional[torch.Tensor] = None,
) -> Tuple[Partition, torch.Tensor]:
    """Recompute the active OCT set, compact it, and remap the grid pool.

    Active blocks: blocks holding grid mass, union the {0,1}^3-dilated
    particle home blocks, union ``extra_mask`` (bool[G^3], the blocks a
    neighbour shard sent mass into); coarsened to octs and compacted in
    ascending oct key order.  Returns (new_partition, remapped_pool)."""
    g = cfg.grid_size
    n3 = g * g * g
    no = cfg.num_oct_keys
    nb = cfg.max_active_octs
    dev = pool.device

    # blocks with grid mass survive (momentum ballistic past particles)
    has_mass = octpool.block_has_mass(cfg, pool)          # [O, 8]
    slot_live = (torch.arange(nb, device=dev) < partition.count) & (partition.keys < no)
    bkeys = octpool.oct_block_keys(cfg, partition.keys)   # [O, 8]
    sel = has_mass & slot_live[:, None] & (bkeys < n3)
    mask = _mark(n3, torch.where(sel, bkeys, torch.full_like(bkeys, n3)), dev)

    mask = mask | particle_blocks(cfg, model_block_keys, dev)
    if extra_mask is not None:
        mask = mask | extra_mask.reshape(-1)

    # coarsen to octs: z is the low bits of the block key, so consecutive
    # groups of 8 block keys form one oct
    omask = mask.reshape(no, 8).any(dim=1)

    total = omask.sum(dtype=torch.int32).reshape(1)
    rank = torch.cumsum(omask.long(), dim=0) - 1
    dest = torch.where(omask & (rank < nb), rank, torch.full_like(rank, nb))
    keys = _compact_into(nb, dest, torch.arange(no, device=dev), no).to(torch.int32)
    overflow = torch.clamp(total - nb, min=0)
    count = torch.clamp(total, max=nb)

    kc = torch.clamp(keys, max=no).long()
    slots = torch.arange(nb, dtype=torch.int32, device=dev)
    table = torch.full((no + 1,), cfg.null_oct, dtype=torch.int32, device=dev)
    table.scatter_(0, kc, torch.where(keys < no, slots, torch.full_like(slots, cfg.null_oct)))
    table[no] = cfg.null_oct

    # remap pool rows old-slot -> new-slot ordering
    old_slot = partition.table[kc]
    new_pool = pool[old_slot.long()]
    new_pool = torch.where((keys < no)[:, None, None], new_pool, 0.0)
    new_pool = torch.cat([new_pool, torch.zeros_like(pool[:1])], dim=0)

    return Partition(table=table, keys=keys, count=count, overflow=overflow), new_pool
