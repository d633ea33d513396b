"""Grid update: the wrapper of the CUDA kernel K2 (``csrc/grid_update.cu``).

On a CUDA pool it launches the kernel, which replaces
``claymore_tpu/ops/pallas_grid.py`` (analytic colliders included); on a CPU
pool it runs the plain PyTorch version, ``core/grid.py:grid_update``.
There is no fallback from the kernel: anything it does not take (an SDF
collider) raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..core import grid as grid_ops
from ..core.types import Partition
from ..models import boundary

# words per packed collider: struct Collider in csrc/grid_update.cu
_COLLIDER_WORDS = 24
_TYPES = {boundary.HalfSpace: 0, boundary.Sphere: 1, boundary.Box: 2}
_KINDS = {boundary.STICKY: 0, boundary.SLIP: 1, boundary.SEPARATE: 2}


def pack_colliders(colliders: Sequence, device) -> torch.Tensor:
    """The analytic colliders as the kernel's POD array, i32[n, 24] on
    ``device`` (float words stored by bit pattern).  Geometry constants are
    computed in double and rounded to float32 once, as the plain version's
    Python constants are."""
    boundary.check_analytic(colliders)
    f = np.zeros((len(colliders), _COLLIDER_WORDS), np.float32)
    i = f.view(np.int32)
    for row, c in enumerate(colliders):
        mo = c.motion
        i[row, 0] = _TYPES[type(c)]
        i[row, 1] = _KINDS[c.kind]
        i[row, 2] = int(mo.rotating)
        f[row, 4] = c.friction
        f[row, 5] = mo.dsdt / max(mo.scale, 1e-20)
        f[row, 6] = mo.dsdt
        if isinstance(c, boundary.HalfSpace):
            f[row, 8:11], f[row, 11:14] = c.origin, c.normal
        elif isinstance(c, boundary.Sphere):
            f[row, 7], f[row, 8:11] = c.radius, c.center
        else:
            f[row, 8:11], f[row, 11:14] = c.center, c.half
        f[row, 14:17] = mo.trans
        f[row, 17:20] = mo.trans_vel
        f[row, 20:23] = mo.omega
    return torch.from_numpy(i).to(device)


def grid_update(
    cfg: SimConfig,
    pool: torch.Tensor,
    partition: Partition,
    dt: torch.Tensor,
    colliders: Sequence = (),
    collider_time: Optional[torch.Tensor] = None,
    collider_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, mom) pool -> (m, v) pool and max |v|^2 (a 0-d tensor).

    ``collider_time`` (0-d, default 0) poses the colliders;
    ``collider_table`` is ``pack_colliders(colliders)`` when the caller
    keeps one, else it is packed here."""
    if not pool.is_cuda:
        return grid_ops.grid_update(cfg, pool, partition, dt, colliders,
                                    collider_time)
    if not colliders:
        return _launch(cfg, pool, partition.keys, dt)
    if collider_table is None:
        collider_table = pack_colliders(colliders, pool.device)
    if collider_time is None:
        collider_time = torch.zeros((), dtype=torch.float32, device=pool.device)
    return _launch(cfg, pool, partition.keys, dt, collider_table, collider_time)


def _launch(cfg: SimConfig, pool, keys, dt, table=None, t=None):
    from . import _build

    o1 = cfg.max_active_octs + 1
    dev = pool.device
    _expect(pool, torch.float32, (o1, 16, 128), dev, "pool")
    _expect(keys, torch.int32, (cfg.max_active_octs,), dev, "partition.keys")
    _expect(dt, torch.float32, (), dev, "dt")
    pool_v = torch.empty_like(pool)
    max_vel_sqr = torch.zeros((), dtype=torch.float32, device=dev)
    gx, gy, gz = (float(v) for v in cfg.gravity)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    geometry = (cfg.grid_size, cfg.grid_size_zo, cfg.num_oct_keys,
                cfg.bound_blocks, gx, gy, gz)
    if table is None:
        name = "cm_grid_update"
        err = lib.cm_grid_update(
            pool.data_ptr(), keys.data_ptr(), pool_v.data_ptr(),
            max_vel_sqr.data_ptr(), dt.data_ptr(), o1, cfg.max_active_octs,
            *geometry, stream)
    else:
        name = "cm_grid_update_colliders"
        _expect(table, torch.int32, (table.shape[0], _COLLIDER_WORDS), dev,
                "collider_table")
        _expect(t, torch.float32, (), dev, "collider_time")
        err = lib.cm_grid_update_colliders(
            pool.data_ptr(), keys.data_ptr(), pool_v.data_ptr(),
            max_vel_sqr.data_ptr(), dt.data_ptr(), table.data_ptr(),
            table.shape[0], t.data_ptr(), o1, cfg.max_active_octs,
            *geometry, cfg.dx, stream)
    _build.check(err, name)
    grid_update.launches[name[3:]] += 1
    return pool_v, max_vel_sqr


def _expect(x: torch.Tensor, dtype, shape, device, name: str) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# launches per kernel, counted where each is launched
grid_update.launches = {"grid_update": 0, "grid_update_colliders": 0}
