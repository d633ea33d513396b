"""Fused G2P2G: the wrapper of the CUDA kernel K1 (``csrc/g2p2g.cu``).

On CUDA tensors it launches the kernel variant of the model's material and
arena span (2, or 4 for ``rebucket_every`` 3..8), which replaces
``claymore_tpu/ops/pallas_g2p2g.py`` with the scatter-add and null-row
zeroing around it, and which also returns the drift margin of its output
(``core/partition.py:arena_margin``, fused into its epilogue); on CPU
tensors it runs the plain PyTorch version, ``core/transfer.py:g2p2g_model``,
and ``arena_margin`` of its output.  There is no fallback from the kernel:
an unknown material, a tile size outside 32..1024, a (span, tile) pair
whose layout does not fit the card's shared memory (``kernel_info``) or a
misaligned tensor raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch

from ..config import SimConfig
from ..core import partition, transfer
from ..core.types import ParticleModel
from ..models.materials import JFluid, FixedCorotated, Material, NACC, Sand
from .grid_kernel import _expect

# material -> (kernel entry, F field, scalar field, variant index of cm_g2p2g_info)
_LAYOUT = {
    FixedCorotated: ("g2p2g_fixed_corotated", "F", None, 0),
    JFluid: ("g2p2g_jfluid", None, "J", 1),
    Sand: ("g2p2g_sand", "F", "logJp", 2),
    NACC: ("g2p2g_nacc", "F", "logJp", 3),
}
MIN_TILE, MAX_TILE = 32, 1024     # the kernel's range of particle_tile
_WIDE = {}                        # device -> wide_tile_counter
_STREAMED = {}                    # device -> streamed_slot_counter


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
    tile_range: Optional[Tuple[int, int]] = None,
    out: Optional[ParticleModel] = None,
) -> Tuple[ParticleModel, torch.Tensor, torch.Tensor]:
    """One material's transfer.  ``next_pool`` accumulates (m, mx, my, mz) in
    place and comes back with its null row zeroed; the particle state comes
    back in new tensors, or in ``out``'s (a model shaped like ``model``),
    written in place (``tile_chunk`` only shapes the plain version).
    Returns (model, next_pool, margin): ``margin`` is the 0-d drift margin
    of the new model, ``arena_margin(cfg, model)``.  The new model's
    inactive slots hold undefined positions and fields: the kernel writes
    them only over each tile's occupied prefix (``occupied_slots``), so a
    reader of the state selects by ``active``.

    ``tile_range`` (lo, hi): transfer the tiles of [lo, hi) only, writing
    only their slots; ``margin`` is then that of those tiles (+inf for an
    empty range, which launches nothing).  Two calls on [0, bt) and
    [bt, T) into one ``out`` give what one call gives, margin the minimum of
    theirs."""
    lo, hi = (0, model.tiles.tvalid.shape[0]) if tile_range is None else tile_range
    if out is None:
        out = transfer.empty_like_model(model)
    if lo == hi:
        inf = torch.full((), torch.inf, dtype=torch.float32, device=pool_v.device)
        return dataclasses.replace(out, tiles=model.tiles), next_pool, inf
    if not pool_v.is_cuda:
        new, pool = transfer.g2p2g_model(cfg, material, pool_v, table, model, dt,
                                         next_dt, next_pool, tile_chunk, (lo, hi), out)
        return new, pool, partition.arena_margin(cfg, slice_tiles(cfg, new, lo, hi))
    if type(material) not in _LAYOUT:
        raise NotImplementedError(
            f"no CUDA transfer kernel for {type(material).__name__}")
    if not MIN_TILE <= cfg.particle_tile <= MAX_TILE:
        raise NotImplementedError(f"the CUDA transfer kernel takes particle_tile "
                                  f"{MIN_TILE}..{MAX_TILE}, not {cfg.particle_tile}")
    info = kernel_info(material, cfg.particle_tile, cfg.arena_span)
    if info["blocks_per_sm"] < 1:
        raise NotImplementedError(
            f"the CUDA transfer kernel of {type(material).__name__} at span "
            f"{cfg.arena_span} needs {info['smem_bytes']} bytes of shared memory a "
            f"block at particle_tile {cfg.particle_tile}, more than the card has; "
            f"use a smaller particle_tile")
    with torch.cuda.device(pool_v.device):   # the kernel runs on the current device
        return _launch(cfg, material, pool_v, table, model, dt, next_dt, next_pool, lo, hi,
                       out)


def slice_tiles(cfg: SimConfig, model: ParticleModel, lo: int, hi: int) -> ParticleModel:
    """A view of the tiles [lo, hi) of ``model`` (its slots sliced in tile
    units): the JAX package's ``_slice_tiles``."""
    a, b = lo * cfg.particle_tile, hi * cfg.particle_tile
    tm = model.tiles
    tiles = dataclasses.replace(tm, block=tm.block[lo:hi], bcoord=tm.bcoord[:, lo:hi],
                                tvalid=tm.tvalid[lo:hi])
    return ParticleModel(pos=model.pos[:, a:b],
                         fields={k: v[..., a:b] for k, v in model.fields.items()},
                         active=model.active[a:b], pid=model.pid[a:b], tiles=tiles)


def variant_name(material: Material, span: int) -> str:
    """The launch key of K1 for ``material`` at arena span ``span``:
    ``g2p2g_<material>``, with ``_span4`` at span 4."""
    name = _LAYOUT[type(material)][0]
    return name if span == 2 else f"{name}_span{span}"


def _launch(cfg, material, pool_v, table, model, dt, next_dt, next_pool, lo, hi, out):
    from . import _build

    name, f_name, aux_name, _ = _LAYOUT[type(material)]
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
    for key, x in (("pos", out.pos), ("active", out.active), ("pid", out.pid),
                   *out.fields.items()):
        ref = model.fields[key] if key in model.fields else getattr(model, key)
        _expect(x, ref.dtype, tuple(ref.shape), dev, "out." + key)
    # the kernel moves particle columns with 16-byte bulk copies
    for key, x in (("pos", model.pos), ("active", model.active), ("pid", model.pid),
                   ("pool_v", pool_v), ("next_pool", next_pool), *model.fields.items(),
                   ("out.pos", out.pos), ("out.active", out.active), ("out.pid", out.pid),
                   *(("out." + k, v) for k, v in out.fields.items())):
        if x.data_ptr() % 16:
            raise ValueError(f"{key} must be 16-byte aligned")
    fields_out = out.fields

    def ptr(fields, key):
        return fields[key].data_ptr() if key else None

    pos_out, active_out, pid_out = out.pos, out.active, out.pid
    margin_key = torch.zeros((2,), dtype=torch.int32, device=dev)
    margin = torch.empty((), dtype=torch.float32, device=dev)
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
        margin_key.data_ptr(), margin.data_ptr(), wide_tile_counter(dev).data_ptr(),
        streamed_slot_counter(dev).data_ptr(), num_tiles, lo, hi, cfg.particle_tile,
        cfg.arena_span, cfg.grid_size, cfg.grid_size_zo,
        cfg.num_oct_keys, cfg.null_oct,
        cfg.dx, cfg.dx_inv, cfg.d_inv, material.mass, mp_arr, len(mp),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    g2p2g.launches[variant_name(material, cfg.arena_span)] += 1
    new_model = ParticleModel(pos=pos_out, fields=fields_out,
                              active=active_out, pid=pid_out, tiles=tm)
    return new_model, next_pool, margin


def _counter(store: dict, device, dtype) -> torch.Tensor:
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    if dev not in store:
        store[dev] = torch.zeros((1,), dtype=dtype, device=dev)
    return store[dev]


def wide_tile_counter(device) -> torch.Tensor:
    """The device counter (i32[1] on ``device``) of the tiles K1's span-4
    variant has transferred in more than one P2G pass (their post-advection
    stencil bases span more than the 6 of one window on some axis), summed
    over every launch on the device.  The substep never reads it; a
    profiling script zeroes it (``zero_()``) and reads it after its run."""
    return _counter(_WIDE, device, torch.int32)


def streamed_slot_counter(device) -> torch.Tensor:
    """The device counter (i64[1] on ``device``) of the particle slots K1
    has streamed, summed over every launch on the device: each transferred
    tile's occupied prefix, one past its last active slot rounded up to 16
    (``occupied_slots``); a tile that is not valid or holds no active slot
    streams none.  Its share of the slots is how much of the particle state
    the transfer moves.  The substep never reads it; a profiling script
    zeroes it (``zero_()``) and reads it after its run."""
    return _counter(_STREAMED, device, torch.int64)


def occupied_slots(cfg: SimConfig, model: ParticleModel) -> torch.Tensor:
    """i64[T]: each tile's occupied prefix as K1 streams it, one past its
    last active slot rounded up to 16 slots, 0 for a tile that is not valid
    or holds no active slot.  Past it K1 leaves the output's position and
    fields as they were and writes every slot inactive, pid S."""
    tiles = model.tiles.tvalid.shape[0]
    act = model.active.reshape(tiles, cfg.particle_tile) & model.tiles.tvalid[:, None]
    idx = torch.arange(1, cfg.particle_tile + 1, device=act.device)
    last = torch.where(act, idx, 0).amax(dim=1)
    return (last + 15) // 16 * 16


def kernel_info(material: Material, tile: int, span: int = 2) -> dict:
    """What the card gives the material's K1 variant at ``tile`` and arena
    ``span``: registers per thread, resident blocks per SM (the persistent
    grid is SMs x this; 0 when the layout does not fit the card's shared
    memory) and dynamic shared memory per block in bytes."""
    return dict(_info(type(material), tile, span))


@functools.lru_cache(maxsize=None)
def _info(material_type, tile: int, span: int):
    from . import _build

    out = (ctypes.c_int * 3)()
    err = _build.library().cm_g2p2g_info(_LAYOUT[material_type][3], span, tile, out)
    _build.check(err, "cm_g2p2g_info")
    return (("registers", out[0]), ("blocks_per_sm", out[1]), ("smem_bytes", out[2]))


# launches per kernel variant and span, counted where each is launched
g2p2g.launches = {f"{name}{sfx}": 0 for name, _, _, _ in _LAYOUT.values()
                  for sfx in ("", "_span4")}
