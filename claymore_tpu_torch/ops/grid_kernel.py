"""Grid update: the wrapper of the CUDA kernel K2 (``csrc/grid_update.cu``).

On a CUDA pool it launches the kernel, which replaces
``claymore_tpu/ops/pallas_grid.py``; on a CPU pool it runs the plain
PyTorch version, ``core/grid.py:grid_update``.  There is no fallback from
the kernel: anything it does not take raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import SimConfig
from ..core import grid as grid_ops
from ..core.types import Partition


def grid_update(
    cfg: SimConfig,
    pool: torch.Tensor,
    partition: Partition,
    dt: torch.Tensor,
    colliders: Sequence = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, mom) pool -> (m, v) pool and max |v|^2 (a 0-d tensor)."""
    if not pool.is_cuda:
        return grid_ops.grid_update(cfg, pool, partition, dt, colliders)
    if colliders:
        raise NotImplementedError("the CUDA grid kernel takes no colliders yet")
    return _launch(cfg, pool, partition.keys, dt)


def _launch(cfg: SimConfig, pool, keys, dt):
    from . import _build

    o1 = cfg.max_active_octs + 1
    dev = pool.device
    _expect(pool, torch.float32, (o1, 16, 128), dev, "pool")
    _expect(keys, torch.int32, (cfg.max_active_octs,), dev, "partition.keys")
    _expect(dt, torch.float32, (), dev, "dt")
    pool_v = torch.empty_like(pool)
    max_vel_sqr = torch.zeros((), dtype=torch.float32, device=dev)
    gx, gy, gz = (float(v) for v in cfg.gravity)
    err = _build.library().cm_grid_update(
        pool.data_ptr(), keys.data_ptr(), pool_v.data_ptr(),
        max_vel_sqr.data_ptr(), dt.data_ptr(), o1, cfg.max_active_octs,
        cfg.grid_size, cfg.grid_size_zo, cfg.num_oct_keys, cfg.bound_blocks,
        gx, gy, gz, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cm_grid_update")
    grid_update.launches += 1
    return pool_v, max_vel_sqr


def _expect(x: torch.Tensor, dtype, shape, device, name: str) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


grid_update.launches = 0
