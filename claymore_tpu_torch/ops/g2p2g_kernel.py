"""Fused G2P2G: the wrapper of the CUDA kernel K1 (``csrc/g2p2g.cu``).

On CUDA tensors it launches the kernel variant of the model's material,
which replaces ``claymore_tpu/ops/pallas_g2p2g.py`` with the scatter-add
and null-row zeroing around it; on CPU tensors it runs the plain PyTorch
version, ``core/transfer.py:g2p2g_model``.  There is no fallback from the
kernel: an unknown material or a span-4 arena raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import torch

from ..config import SimConfig
from ..core import transfer
from ..core.types import ParticleModel
from ..models.materials import JFluid, FixedCorotated, Material, NACC, Sand
from .grid_kernel import _expect

# material -> (kernel entry, F field, scalar field)
_LAYOUT = {
    FixedCorotated: ("g2p2g_fixed_corotated", "F", None),
    JFluid: ("g2p2g_jfluid", None, "J"),
    Sand: ("g2p2g_sand", "F", "logJp"),
    NACC: ("g2p2g_nacc", "F", "logJp"),
}


def kernel_params(material: Material) -> List[float]:
    """The material's constants in the order its ``struct`` in
    ``csrc/g2p2g.cu`` reads ``mp``.  Constants the plain version folds in
    Python (double) are folded here the same way."""
    if isinstance(material, FixedCorotated):
        lam, mu = material.lame
        return [2.0 * mu, lam, material.volume]
    if isinstance(material, JFluid):
        return [material.bulk, -material.gamma, material.viscosity, material.volume]
    if isinstance(material, Sand):
        lam, mu = material.lame
        return [material.cohesion, (3.0 * lam + 2.0 * mu) / (2.0 * mu),
                material.yield_surface, math.exp(material.cohesion),
                material.beta, float(material.volume_correction), 2.0 * mu, lam,
                material.volume]
    if isinstance(material, NACC):
        _, mu = material.lame
        bm, beta = material.bm, material.beta
        return [mu, bm, material.xi, -beta, material.msqr, material.volume,
                float(material.hardening_on), 1.5 * (1.0 + 2.0 * beta),
                1.0 - beta, 1.0 + 2.0 * beta, -bm * 0.5, bm * 0.5]
    raise NotImplementedError(f"no transfer kernel for {type(material).__name__}")


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
    if type(material) not in _LAYOUT:
        raise NotImplementedError(
            f"no CUDA transfer kernel for {type(material).__name__}")
    if cfg.arena_span != 2:
        raise NotImplementedError("the CUDA transfer kernel needs span-2 arenas "
                                  "(rebucket_every <= 2)")
    return _launch(cfg, material, pool_v, table, model, dt, next_dt, next_pool)


def _launch(cfg, material, pool_v, table, model, dt, next_dt, next_pool):
    from . import _build

    name, f_name, aux_name = _LAYOUT[type(material)]
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
    _expect(model.active, torch.bool, (s_cap,), dev, "active")
    _expect(model.pid, torch.int32, (s_cap,), dev, "pid")
    _expect(dt, torch.float32, (), dev, "dt")
    _expect(next_dt, torch.float32, (), dev, "next_dt")
    expected = {k for k in (f_name, aux_name) if k}
    if set(model.fields) != expected:
        raise ValueError(f"{type(material).__name__} fields {sorted(model.fields)}, "
                         f"expected {sorted(expected)}")
    if f_name:
        _expect(model.fields[f_name], torch.float32, (9, s_cap), dev, f_name)
    if aux_name:
        _expect(model.fields[aux_name], torch.float32, (s_cap,), dev, aux_name)
    fields_out = {k: torch.empty_like(v) for k, v in model.fields.items()}

    def ptr(fields, key):
        return fields[key].data_ptr() if key else None

    pos_out = torch.empty_like(model.pos)
    active_out = torch.empty_like(model.active)
    pid_out = torch.empty_like(model.pid)
    mp = kernel_params(material)
    mp_arr = (ctypes.c_float * len(mp))(*mp)
    entry = "cm_" + name
    err = getattr(_build.library(), entry)(
        pool_v.data_ptr(), table.data_ptr(), tm.bcoord.data_ptr(),
        tm.tvalid.data_ptr(), model.pos.data_ptr(), ptr(model.fields, f_name),
        ptr(model.fields, aux_name), model.active.data_ptr(), model.pid.data_ptr(),
        dt.data_ptr(), next_dt.data_ptr(), pos_out.data_ptr(),
        ptr(fields_out, f_name), ptr(fields_out, aux_name),
        active_out.data_ptr(), pid_out.data_ptr(), next_pool.data_ptr(),
        num_tiles, cfg.particle_tile, cfg.grid_size, cfg.grid_size_zo,
        cfg.num_oct_keys, cfg.null_oct,
        cfg.dx, cfg.dx_inv, cfg.d_inv, material.mass, mp_arr, len(mp),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    g2p2g.launches[name] += 1
    new_model = ParticleModel(pos=pos_out, fields=fields_out,
                              active=active_out, pid=pid_out, tiles=tm)
    return new_model, next_pool


# launches per kernel variant, counted where each is launched
g2p2g.launches = {name: 0 for name, _, _ in _LAYOUT.values()}
