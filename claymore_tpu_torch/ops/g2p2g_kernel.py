"""Fused G2P2G: the wrapper of the CUDA kernel K1 (``csrc/g2p2g.cu``).

On CUDA tensors it launches the kernel, which replaces
``claymore_tpu/ops/pallas_g2p2g.py`` with the scatter-add and null-row
zeroing around it; on CPU tensors it runs the plain PyTorch version,
``core/transfer.py:g2p2g_model``.  There is no fallback from the kernel:
a material other than FixedCorotated, or a span-4 arena, raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SimConfig
from ..core import transfer
from ..core.types import ParticleModel
from ..models.materials import FixedCorotated, Material
from .grid_kernel import _expect


def g2p2g(
    cfg: SimConfig,
    material: Material,
    pool_v: torch.Tensor,
    table: torch.Tensor,
    model: ParticleModel,
    dt: torch.Tensor,
    next_dt: torch.Tensor,
    next_pool: torch.Tensor,
    tile_chunk: int = 32,
) -> Tuple[ParticleModel, torch.Tensor]:
    """One material's transfer.  ``next_pool`` accumulates (m, mx, my, mz) in
    place and comes back with its null row zeroed; the particle state comes
    back in new tensors (``tile_chunk`` only shapes the plain version)."""
    if not pool_v.is_cuda:
        return transfer.g2p2g_model(cfg, material, pool_v, table, model, dt,
                                    next_dt, next_pool, tile_chunk)
    if type(material) is not FixedCorotated:
        raise NotImplementedError(
            f"the CUDA transfer kernel supports FixedCorotated only, not "
            f"{type(material).__name__}")
    if cfg.arena_span != 2:
        raise NotImplementedError("the CUDA transfer kernel needs span-2 arenas "
                                  "(rebucket_every <= 2)")
    return _launch(cfg, material, pool_v, table, model, dt, next_dt, next_pool)


def _launch(cfg, material, pool_v, table, model, dt, next_dt, next_pool):
    from . import _build

    dev = pool_v.device
    tm = model.tiles
    num_tiles = tm.tvalid.shape[0]
    s_cap = num_tiles * cfg.particle_tile
    o1 = cfg.max_active_octs + 1
    _expect(pool_v, torch.float32, (o1, 16, 128), dev, "pool_v")
    _expect(next_pool, torch.float32, (o1, 16, 128), dev, "next_pool")
    _expect(table, torch.int32, (cfg.num_oct_keys + 1,), dev, "table")
    _expect(tm.bcoord, torch.int32, (3, num_tiles), dev, "tiles.bcoord")
    _expect(tm.tvalid, torch.bool, (num_tiles,), dev, "tiles.tvalid")
    _expect(model.pos, torch.float32, (3, s_cap), dev, "pos")
    _expect(model.fields["F"], torch.float32, (9, s_cap), dev, "F")
    _expect(model.active, torch.bool, (s_cap,), dev, "active")
    _expect(model.pid, torch.int32, (s_cap,), dev, "pid")
    _expect(dt, torch.float32, (), dev, "dt")
    _expect(next_dt, torch.float32, (), dev, "next_dt")

    pos_out = torch.empty_like(model.pos)
    f_out = torch.empty_like(model.fields["F"])
    active_out = torch.empty_like(model.active)
    pid_out = torch.empty_like(model.pid)
    lam, mu = material.lame
    err = _build.library().cm_g2p2g_fixed_corotated(
        pool_v.data_ptr(), table.data_ptr(), tm.bcoord.data_ptr(),
        tm.tvalid.data_ptr(), model.pos.data_ptr(),
        model.fields["F"].data_ptr(), model.active.data_ptr(),
        model.pid.data_ptr(), dt.data_ptr(), next_dt.data_ptr(),
        pos_out.data_ptr(), f_out.data_ptr(), active_out.data_ptr(),
        pid_out.data_ptr(), next_pool.data_ptr(),
        num_tiles, cfg.particle_tile, cfg.grid_size, cfg.grid_size_zo,
        cfg.num_oct_keys, cfg.null_oct,
        cfg.dx, cfg.dx_inv, cfg.d_inv, material.mass, material.volume,
        2.0 * mu, lam, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cm_g2p2g_fixed_corotated")
    g2p2g.launches += 1
    new_model = ParticleModel(pos=pos_out, fields={"F": f_out},
                              active=active_out, pid=pid_out, tiles=tm)
    return new_model, next_pool


g2p2g.launches = 0
