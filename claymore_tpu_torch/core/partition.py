"""Sparse block partition: activation, compaction, tile building.

Port of ``claymore_tpu/core/partition.py``.  The full rebucket moves the
particle state into its new tile layout by one stable key sort and one
gather per channel; the incremental one moves only the particles whose
home block changed into free tiles.  The padded destination slots come
from the same segment arithmetic as the JAX package, so slot order, tile
keys and the partition agree exactly.

The full rebucket's plain version is the stable key sort
(``sort_keys``) and the plain twins of its CUDA kernels (``home_keys``,
``segment_heads``, ``segment_bases``, ``tile_windows``, ``place``;
``ops/rebucket_kernel.py`` launches the kernels).  ``segment_heads``
and ``segment_bases`` read their counts back to the host (the kernels do
not).  Nothing else here does:
variable-length results (nonzero, dropped elements) are written through a
trailing dummy slot instead of boolean indexing, so the rebuild queues on
the device without a synchronisation.
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

def home_keys(cfg: SimConfig, model) -> torch.Tensor:
    """i32[S]: each slot's home-block key, ``G^3`` for an inactive slot or
    one outside the grid."""
    n3 = cfg.grid_size ** 3
    key = flatten_key(cfg, home_block(cfg, model.pos))
    return torch.where(model.active, key, torch.full_like(key, n3)).to(torch.int32)


def region_source(cfg: SimConfig, key: torch.Tensor, region_fn=None) -> torch.Tensor:
    """The sort keys from the home-block keys: as they are, or with the
    interior's offset added where ``region_fn`` is given (see
    ``sort_permute``)."""
    if region_fn is None:
        return key
    n3 = cfg.grid_size ** 3
    off, sentinel = region_offsets(cfg, True)
    if sentinel >= 1 << 30:
        raise ValueError("domain too large for region packing")
    interior = ~region_fn(torch.clamp(key, max=n3 - 1))
    return torch.where(key < n3, key + interior.to(torch.int32) * off,
                       torch.full_like(key, sentinel))


def sort_keys(cfg: SimConfig, model, region_fn=None):
    """The rebucket's sort: ``region_source`` of ``home_keys``, sorted
    stably by ``torch.sort``, the plain twin of the package's own sort on
    the card (``ops/rebucket_kernel.py:key_sort``: an LSD radix sort of the
    active slots alone over the bits below the sentinel, with int32
    indices; ~1.6 GB of traffic on sphere25m's 69.6M slots where
    ``torch.sort`` moves ~7 GB).

    Returns (skey i32[S], perm i64[S], region): ``perm[i]`` is the slot of
    the i-th sorted key (ties in slot order), ``region`` whether the keys
    carry the offset."""
    skey, perm = torch.sort(region_source(cfg, home_keys(cfg, model), region_fn), stable=True)
    return skey, perm, region_fn is not None


def region_offsets(cfg: SimConfig, region: bool):
    """(offset, sentinel) of the sort keys: the interior's offset ``G^3 + 8``
    and the sentinel ``2 (G^3 + 8)`` with a region, else (0, G^3)."""
    n3 = cfg.grid_size ** 3
    return (n3 + 8, 2 * (n3 + 8)) if region else (0, n3)


def segment_heads(skey: torch.Tensor, sentinel: int) -> torch.Tensor:
    """i32[G + 1]: the sorted index at which each of the G block segments
    starts (an active key unlike the one before it), then the count of
    active keys (they form a prefix of the sorted keys)."""
    act = skey < sentinel
    head = act.clone()
    head[1:] &= skey[1:] != skey[:-1]
    starts = torch.nonzero(head).flatten()
    return torch.cat([starts, act.sum().reshape(1)]).to(torch.int32)


def segment_bases(cfg: SimConfig, skey: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """i64[G]: the padded slot at which each segment's elements start.

    Level 1 takes each segment to a whole number of tiles; level 2 takes
    each home oct (the segments whose keys agree but for the low 3 bits) to
    a multiple of ``group_tiles`` tiles.  Element i of segment g lands in
    slot ``base[g] + i - seg_start[g]``: the JAX package's
    ``p1 + cumsum(waste2)``, since the waste at each head is the padding
    of the segment (level 1) or oct (level 2) before it."""
    tile = cfg.particle_tile
    gt = cfg.group_tiles * tile
    st = seg_start.long()
    length = st[1:] - st[:-1]
    padded = (length + tile - 1) // tile * tile
    okey = skey[st[:-1]].long() >> 3
    ohead = torch.ones_like(okey, dtype=torch.bool)
    ohead[1:] = okey[1:] != okey[:-1]
    l1 = torch.cumsum(padded, dim=0) - padded            # level-1 start
    oid = torch.cumsum(ohead.long(), dim=0) - 1
    o_l1 = l1[ohead]
    span = torch.diff(o_l1, append=padded.sum().reshape(1))
    span = (span + gt - 1) // gt * gt
    o_base = torch.cumsum(span, dim=0) - span
    return o_base[oid] + l1 - o_l1[oid]


def tile_windows(cfg: SimConfig, skey: torch.Tensor, seg_start: torch.Tensor,
                 base: torch.Tensor, num_tiles: int, region: bool = False):
    """Each destination tile's window of sorted indices, from the segments'
    starts and bases.

    Returns (dstart i32[T], dlen i32[T], tile_keys i32[T], dropped i32[1]):
    tile t takes the sorted elements ``dstart[t] .. dstart[t] + dlen[t] -
    1`` into its first ``dlen[t]`` slots (``dstart`` is the JAX package's
    ``searchsorted`` of ``t * tile`` in the destination slots, empty tiles
    too); ``tile_keys`` is the block key of a tile's elements (less the
    region offset), ``G^3`` for an empty tile; ``dropped`` counts the
    active elements whose slot lies past the capacity ``num_tiles *
    tile``."""
    tile = cfg.particle_tile
    n3 = cfg.grid_size ** 3
    s_cap = num_tiles * tile
    dev = skey.device
    off, _ = region_offsets(cfg, region)
    st = seg_start.long()
    g_count = st.shape[0] - 1
    if g_count == 0:
        zero = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
        return (zero, zero.clone(), torch.full_like(zero, n3),
                torch.zeros((1,), dtype=torch.int32, device=dev))
    length = st[1:] - st[:-1]
    target = torch.arange(num_tiles, dtype=torch.int64, device=dev) * tile
    g = torch.searchsorted(base, target, right=True) - 1     # base[0] == 0
    into = target - base[g]
    inside = into < length[g]
    dstart = torch.where(inside, st[g] + into, st[g + 1])
    dlen = torch.where(inside, torch.clamp(length[g] - into, max=tile), 0)
    key = skey[st[:-1]]
    if region:
        key = torch.where(key >= off, key - off, key)
    tile_keys = torch.where(inside, key[g], n3)
    fit = torch.minimum(torch.clamp(s_cap - base, min=0), length)
    dropped = (st[-1] - fit.sum()).to(torch.int32).reshape(1)
    return (dstart.to(torch.int32), dlen.to(torch.int32), tile_keys.to(torch.int32),
            dropped)


def tile_plan(cfg: SimConfig, skey: torch.Tensor, num_tiles: int, region: bool = False):
    """The slot plan of the sorted keys: ``segment_heads``, then
    ``segment_bases``, then ``tile_windows``, whose result it returns:
    (dstart, dlen, tile_keys, dropped)."""
    seg_start = segment_heads(skey, region_offsets(cfg, region)[1])
    base = segment_bases(cfg, skey, seg_start)
    return tile_windows(cfg, skey, seg_start, base, num_tiles, region)


def place(cfg: SimConfig, model, perm: torch.Tensor, dstart: torch.Tensor,
          dlen: torch.Tensor):
    """Move every channel into the planned layout: slot ``t * tile + j``
    with ``j < dlen[t]`` takes slot ``perm[dstart[t] + j]`` of ``model``
    (position, each field, id) and is active; any other slot is empty:
    position and fields 0, id ``S``, inactive.  ``perm`` is int64 (the
    plain sort's) or int32 (the kernel's)."""
    s_cap = model.pos.shape[1]
    tile = cfg.particle_tile
    j = torch.arange(tile, dtype=torch.int64, device=dstart.device)
    active = (j[None, :] < dlen[:, None].long()).reshape(-1)
    src = torch.clamp(dstart[:, None].long() + j[None, :], max=s_cap - 1).reshape(-1)
    gather = perm[src]

    def move(x, fill=0):
        return torch.where(active, x[..., gather], fill)

    return type(model)(pos=move(model.pos), fields={k: move(v) for k, v in model.fields.items()},
                       active=active, pid=move(model.pid, s_cap), tiles=model.tiles)


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

    The plain version, on any device: ``sort_keys`` (``home_keys`` and
    the sort), ``tile_plan`` and ``place``, the plain twins of the CUDA
    kernels behind ``ops/rebucket_kernel.py:sort_permute``, which the
    engine calls.

    Returns (permuted model, tile_keys i32[T], dropped i32[1]).
    """
    if model.pos.shape[1] != num_tiles * cfg.particle_tile:
        raise ValueError(f"slot capacity {model.pos.shape[1]} != {num_tiles} tiles")
    skey, perm, region = sort_keys(cfg, model, region_fn)
    dstart, dlen, tile_keys, dropped = tile_plan(cfg, skey, num_tiles, region)
    return place(cfg, model, perm, dstart, dlen), tile_keys, dropped


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
    package's ``incremental_plan``.  Its two compactions go through
    ``ops/partition_kernel.py:first_marked`` (the kernel on the card)."""
    from ..ops import partition_kernel

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

    midx, n_movers = partition_kernel.first_marked(mover, m_cap, s_cap)
    got_m = midx < s_cap
    deferred = torch.clamp(n_movers[0] - m_cap, min=0)
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
    ftile, n_free = partition_kernel.first_marked(free, num_tiles, num_tiles)

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


def oct_flags(
    cfg: SimConfig,
    pool: torch.Tensor,
    partition: Partition,
    model_block_keys: Tuple[torch.Tensor, ...],
    extra_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """bool[num_oct_keys]: the octs the rebuild keeps.

    Active blocks: blocks holding grid mass, union the {0,1}^3-dilated
    particle home blocks, union ``extra_mask`` (bool[G^3], the blocks a
    neighbour shard sent mass into); coarsened to octs.  The plain twin of
    ``ops/partition_kernel.py:oct_mask``."""
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
    return mask.reshape(no, 8).any(dim=1)


def remap(cfg: SimConfig, pool: torch.Tensor, partition: Partition,
          omask: torch.Tensor) -> Tuple[Partition, torch.Tensor]:
    """The partition of the oct flags ``omask`` (compacted in ascending oct
    key order, the octs past the capacity counted in ``overflow``) and the
    pool remapped into it: each new slot takes its oct's old row (an oct
    new to the partition takes the old null row), every other row is zero.
    The plain twin of ``ops/partition_kernel.py:remap``."""
    no = cfg.num_oct_keys
    nb = cfg.max_active_octs
    dev = pool.device

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


def rebuild(
    cfg: SimConfig,
    pool: torch.Tensor,
    partition: Partition,
    model_block_keys: Tuple[torch.Tensor, ...],
    extra_mask: Optional[torch.Tensor] = None,
) -> Tuple[Partition, torch.Tensor]:
    """Recompute the active OCT set (``oct_flags``), compact it, and remap
    the grid pool (``remap``).  Returns (new_partition, remapped_pool).
    The plain version of ``ops/partition_kernel.py:rebuild``, which the
    engine calls."""
    return remap(cfg, pool, partition,
                 oct_flags(cfg, pool, partition, model_block_keys, extra_mask))
