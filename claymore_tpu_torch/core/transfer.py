"""Fused G2P2G transfer: the plain PyTorch version.

``g2p2g_model`` is a straight port of ``claymore_tpu/core/transfer.py``: per
chunk of tiles it gathers the 8^3-cell velocity arena of each tile's 2^3
neighbor blocks, runs the quadratic B-spline G2P with APIC moments as
separable per-axis contractions, the material update, advection, and the
fused P2G of mass and momentum  w (m v + Q (x_i - x_p))  as one contraction
over the particle axis, then adds the per-block results into the next pool.
It is the reference the CUDA kernel (``ops/g2p2g_kernel.py``,
``csrc/g2p2g.cu``) is held against, and what the kernel's wrapper runs on
CPU tensors.  ``rasterize_model`` is the initial P2G (init only).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..models.materials import Material
from . import octpool
from . import partition as part
from .types import ParticleModel


def _nb_offsets(cfg: SimConfig) -> np.ndarray:
    """[3, span^3] neighbor block offsets (arena_lo .. arena_lo+span-1)."""
    r = np.arange(cfg.arena_lo, cfg.arena_lo + cfg.arena_span, dtype=np.int32)
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=0).reshape(3, -1)


def _bspline_onehot(cfg: SimConfig, pos, origin):
    """Per-axis one-hot B-spline weight/moment vectors over the arena axis.

    pos: [3, ct, tile]; origin: [3, ct, 1] arena origin cell per tile.
    Returns (w, m, in_range): w, m are 3-lists of [ct, C, tile] (C = arena
    cells); in_range is [ct, tile].
    """
    dx = cfg.dx
    cells = cfg.arena_cells
    base = part.base_cell(cfg, pos)                       # [3, ct, tile]
    d = pos * cfg.dx_inv - base.to(pos.dtype)             # in [0.5, 1.5]

    li = base - origin
    in_range = ((li >= 0) & (li <= cells - 3)).all(dim=0)
    li = torch.clamp(li, 0, cells - 3)

    iota = torch.arange(cells, dtype=torch.int32, device=pos.device)[None, :, None]
    ws, ms = [], []
    for ax in range(3):
        da = d[ax][:, None, :]                            # [ct, 1, tile]
        w0 = 0.5 * (1.5 - da) ** 2
        w1 = 0.75 - (da - 1.0) ** 2
        w2 = 0.5 * (da - 0.5) ** 2
        lia = li[ax][:, None, :]
        w = (
            w0 * (iota == lia)
            + w1 * (iota == lia + 1)
            + w2 * (iota == lia + 2)
        ).to(pos.dtype)                                   # [ct, 8, tile]
        cell_x = (origin[ax][:, None, :] + iota).to(pos.dtype) * dx
        m = w * (cell_x - pos[ax][:, None, :])
        ws.append(w)
        ms.append(m)
    return ws, ms, in_range


def neighbor_slots(cfg: SimConfig, table, bcoord):
    """Block addresses of the arena's neighbor blocks per tile: [T, span^3]."""
    off = torch.as_tensor(_nb_offsets(cfg), device=bcoord.device)
    nb = bcoord[:, :, None] + off[:, None, :]
    return part.lookup(cfg, table, nb)


def _arena_from_slots(cfg: SimConfig, pool, nb_slot):
    """[ct, span^3] block addresses -> [ct, 4, C, C, C] cell arena."""
    bs = cfg.block_size
    sp = cfg.arena_span
    blocks = octpool.gather_block_rows(cfg, pool, nb_slot)  # [ct, s^3, 4, bv]
    t = blocks.shape[0]
    arena = blocks.reshape(t, sp, sp, sp, 4, bs, bs, bs)
    arena = arena.permute(0, 4, 1, 5, 2, 6, 3, 7)
    c = sp * bs
    return arena.reshape(t, 4, c, c, c)


def _scatter_layout(cfg: SimConfig, arena_out):
    """[ct, C, C, C, 4] (x, y, z, c) cell arena -> [ct, s^3, 4, bv] rows."""
    bs = cfg.block_size
    sp = cfg.arena_span
    t = arena_out.shape[0]
    a = arena_out.reshape(t, sp, bs, sp, bs, sp, bs, 4)
    a = a.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return a.reshape(t, sp ** 3, 4, cfg.block_volume)


def _tile_nb_slots(cfg: SimConfig, table, tiles):
    nb_slot = neighbor_slots(cfg, table, tiles.bcoord)    # [T, span^3]
    return torch.where(tiles.tvalid[:, None], nb_slot,
                       torch.full_like(nb_slot, cfg.null_block))


def empty_like_model(model: ParticleModel) -> ParticleModel:
    """Uninitialised particle tensors shaped like ``model``'s (its tiles):
    the outputs a transfer writes."""
    return ParticleModel(pos=torch.empty_like(model.pos),
                         fields={k: torch.empty_like(v) for k, v in model.fields.items()},
                         active=torch.empty_like(model.active),
                         pid=torch.empty_like(model.pid), tiles=model.tiles)


def g2p2g_model(
    cfg: SimConfig,
    material: Material,
    pool_v: torch.Tensor,
    table: torch.Tensor,
    model: ParticleModel,
    dt: torch.Tensor,
    next_dt: torch.Tensor,
    next_pool: torch.Tensor,
    tile_chunk: int = 32,
    tile_range: Optional[Tuple[int, int]] = None,
    out: Optional[ParticleModel] = None,
) -> Tuple[ParticleModel, torch.Tensor]:
    """One material's fused grid->particle->grid transfer.

    ``pool_v`` holds (m, vx, vy, vz) after the grid update; ``next_pool``
    accumulates (m, mx, my, mz) for the next step IN PLACE and is returned
    with its null row zeroed.  Particle outputs are new tensors, or those
    of ``out`` (a model shaped like ``model``), written in place.

    ``tile_range`` (lo, hi), multiples of ``tile_chunk``: transfer only the
    tiles in [lo, hi) and write only their slots of the outputs; the
    multi-device engine runs [0, bt) and [bt, T) into the same outputs."""
    tm = model.tiles
    num_tiles = tm.block.shape[0]
    tile = cfg.particle_tile
    if num_tiles % tile_chunk:
        raise ValueError(f"{num_tiles} tiles do not split into chunks of {tile_chunk}")
    lo, hi = (0, num_tiles) if tile_range is None else tile_range
    if lo % tile_chunk or hi % tile_chunk or not 0 <= lo <= hi <= num_tiles:
        raise ValueError(f"tile range {tile_range} of {num_tiles} tiles is not in "
                         f"whole chunks of {tile_chunk}")
    ct = tile_chunk
    cs = ct * tile
    d_inv = torch.tensor(cfg.d_inv, dtype=pool_v.dtype, device=pool_v.device)
    mass = material.mass
    cells = cfg.arena_cells
    s_cap = model.pos.shape[1]
    if out is None:
        out = empty_like_model(model)

    nb_slot_all = _tile_nb_slots(cfg, table, tm)

    for ci in range(lo // ct, hi // ct):
        sl = slice(ci * cs, (ci + 1) * cs)
        pos = model.pos[:, sl].reshape(3, ct, tile)
        valid = model.active[sl].reshape(ct, tile)
        fields = {k: v[..., sl] for k, v in model.fields.items()}
        bcoord = tm.bcoord[:, ci * ct:(ci + 1) * ct]
        nb_slot = nb_slot_all[ci * ct:(ci + 1) * ct]
        arena = _arena_from_slots(cfg, pool_v, nb_slot)

        origin = ((bcoord + cfg.arena_lo) * cfg.block_size)[:, :, None]
        w, mvec, in_range_pre = _bspline_onehot(cfg, pos, origin)
        (wx, wy, wz), (mx, my, mz) = w, mvec              # [ct, C, tile]

        vgrid = arena[:, 1:4]                             # [ct, 3, 8, 8, 8]
        gx = torch.einsum("txp,tcxyz->tcyzp", wx, vgrid)
        gmx = torch.einsum("txp,tcxyz->tcyzp", mx, vgrid)
        wy_b = wy[:, None, :, None, :]
        my_b = my[:, None, :, None, :]
        gxy = (gx * wy_b).sum(dim=2)                      # [ct, 3, 8, tile]
        gxmy = (gx * my_b).sum(dim=2)
        gmxy = (gmx * wy_b).sum(dim=2)
        wz_b = wz[:, None, :, :]
        mz_b = mz[:, None, :, :]
        vel = (gxy * wz_b).sum(dim=2)                     # [ct, 3, tile]
        col2 = (gxy * mz_b).sum(dim=2)
        col1 = (gxmy * wz_b).sum(dim=2)
        col0 = (gmxy * wz_b).sum(dim=2)
        cols = (col0, col1, col2)
        a_soa = tuple(cols[c][:, r] for r in range(3) for c in range(3))

        new_fields, contrib = material.update(
            d_inv, dt, tuple(c.reshape(-1) for c in a_soa), fields)

        new_pos = pos + vel.permute(1, 0, 2) * dt         # [3, ct, tile]

        # fused momentum matrix  Q = (A m - contrib dt_next) D^-1
        q = tuple(
            ((a.reshape(-1) * mass - c * next_dt) * d_inv).reshape(ct, tile)
            for a, c in zip(a_soa, contrib)
        )

        # P2G at the advected position, same arena; a particle outside the
        # arena before advection gathered with clipped weights, so it must
        # not scatter either
        w2, m2, in_range = _bspline_onehot(cfg, new_pos, origin)
        ok = valid & in_range_pre & in_range
        # a slot that does not scatter adds exact zeros, selected and not
        # multiplied away: an inactive slot's state may hold anything, NaN too
        okc = ok[:, None, :]                              # [ct, 1, tile]
        wx2, wy2, wz2 = (torch.where(okc, x, 0.0) for x in w2)
        mx2, my2, mz2 = (torch.where(okc, x, 0.0) for x in m2)

        velm = vel * mass
        s0 = torch.where(okc, torch.cat(
            [torch.full((ct, 1, tile), mass, dtype=pos.dtype, device=pos.device), velm],
            dim=1), 0.0)
        zero = torch.zeros((ct, 1, tile), dtype=pos.dtype, device=pos.device)
        s1 = torch.where(okc, torch.cat([zero, q[0][:, None], q[3][:, None], q[6][:, None]],
                                        dim=1), 0.0)
        s2 = torch.where(okc, torch.cat([zero, q[1][:, None], q[4][:, None], q[7][:, None]],
                                        dim=1), 0.0)
        s3 = torch.where(okc, torch.cat([zero, q[2][:, None], q[5][:, None], q[8][:, None]],
                                        dim=1), 0.0)

        ux = torch.cat([wx2, mx2, wx2, wx2], dim=2)       # [ct, 8, 4*tile]
        uy = torch.cat([wy2, wy2, my2, wy2], dim=2)
        uz = torch.cat([wz2, wz2, wz2, mz2], dim=2)
        sv = torch.cat([s0, s1, s2, s3], dim=2)           # [ct, 4, 4*tile]

        e = (ux[:, :, None, :] * uy[:, None, :, :]).reshape(ct, cells * cells, 4 * tile)
        r = (uz[:, :, None, :] * sv[:, None, :, :]).reshape(ct, cells * 4, 4 * tile)
        arena_out = torch.einsum("tep,tfp->tef", e, r).reshape(ct, cells, cells, cells, 4)

        blocks = _scatter_layout(cfg, arena_out)
        octpool.scatter_add_block_rows(
            cfg, next_pool, nb_slot.reshape(-1),
            blocks.reshape(ct * cfg.arena_span ** 3, 4, cfg.block_volume))
        out.pos[:, sl] = new_pos.reshape(3, -1)
        ok = ok.reshape(-1)
        out.active[sl] = ok
        out.pid[sl] = torch.where(ok, model.pid[sl], torch.full_like(model.pid[sl], s_cap))
        for k, v in new_fields.items():
            out.fields[k][..., sl] = v

    next_pool[cfg.null_oct] = 0.0
    return ParticleModel(pos=out.pos, fields=out.fields, active=out.active,
                         pid=out.pid, tiles=tm), next_pool


RASTER_TILES = 2048      # rasterize_model's chunk on a card: 0.3 GB of temporaries at
#                          span 2 and tiles of 256, 2.5 GB at span 4 and tiles of 1024


def rasterize_model(
    cfg: SimConfig,
    material: Material,
    table: torch.Tensor,
    model: ParticleModel,
    v0: torch.Tensor,
    pool: torch.Tensor,
    tile_chunk: int = 32,
) -> torch.Tensor:
    """Initial P2G of mass and momentum with a uniform initial velocity,
    accumulated into ``pool`` in place (null row zeroed).

    On the CPU it runs ``tile_chunk`` tiles at a time, the JAX package's
    chunks, so the sums come in its order.  On a card it runs at least
    ``RASTER_TILES`` tiles at a time (the last chunk may be short): a chunk
    is a dozen launches issued by the host, and config 5's 100M particles
    in chunks of 64 tiles would take the host ~20,000 chunks.  The card's
    ``index_add_`` adds in no fixed order anyway."""
    tm = model.tiles
    num_tiles = tm.block.shape[0]
    tile = cfg.particle_tile
    if num_tiles % tile_chunk:
        raise ValueError(f"{num_tiles} tiles do not split into chunks of {tile_chunk}")
    dev = pool.device
    step = tile_chunk if dev.type == "cpu" else max(tile_chunk, RASTER_TILES)
    mass = material.mass
    cells = cfg.arena_cells

    nb_slot_all = _tile_nb_slots(cfg, table, tm)
    for t0 in range(0, num_tiles, step):
        ct = min(step, num_tiles - t0)
        sl = slice(t0 * tile, (t0 + ct) * tile)
        pos = model.pos[:, sl].reshape(3, ct, tile)
        valid = model.active[sl].reshape(ct, tile)
        bcoord = tm.bcoord[:, t0:t0 + ct]
        nb_slot = nb_slot_all[t0:t0 + ct]
        origin = ((bcoord + cfg.arena_lo) * cfg.block_size)[:, :, None]
        w, _, in_range = _bspline_onehot(cfg, pos, origin)
        wx, wy, wz = w
        okf = (valid & in_range)[:, None, :].to(pos.dtype)
        sv = torch.cat(
            [torch.full((ct, 1, tile), mass, dtype=pos.dtype, device=dev),
             (mass * v0)[None, :, None].expand(ct, 3, tile)],
            dim=1,
        ) * okf
        e = (wx[:, :, None, :] * wy[:, None, :, :]).reshape(ct, cells * cells, tile)
        r = (wz[:, :, None, :] * sv[:, None, :, :]).reshape(ct, cells * 4, tile)
        arena_out = torch.einsum("tep,tfp->tef", e, r).reshape(ct, cells, cells, cells, 4)
        blocks = _scatter_layout(cfg, arena_out)
        octpool.scatter_add_block_rows(
            cfg, pool, nb_slot.reshape(-1),
            blocks.reshape(ct * cfg.arena_span ** 3, 4, cfg.block_volume))
    pool[cfg.null_oct] = 0.0
    return pool
