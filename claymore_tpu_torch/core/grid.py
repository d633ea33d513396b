"""Grid velocity update and CFL step.

``grid_update`` is the plain PyTorch version of the grid kernel
(``ops/grid_kernel.py``, ``csrc/grid_update.cu``) and a straight port of
``claymore_tpu/core/grid.py``: momentum -> velocity, per-axis sticky domain
slab, gravity after the clamp, the analytic colliders, and the global max
|v|^2 with NaN mapped to inf.  Colliders are resolved through
``resolve_soa``, the component form the JAX package runs inside its grid
kernel (``claymore_tpu/ops/pallas_grid.py:74-90``), so this version and the
CUDA kernel share one definition of the math.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..config import SimConfig
from ..models.boundary import check_analytic
from .octpool import oct_coord
from .types import Partition


def _cell_coords(cfg: SimConfig, partition: Partition):
    """Per-(row-group, lane) integer cell coords of every pool cell.

    Returns (cx, cy, cz) broadcastable against the [O+1, 4, 128] per-channel
    view: cx [1, 4, 1]; cy, cz [1, 1, 128]; and block coords bx, by [O+1],
    bz [O+1, 1, 128] (global z-block index resolving the lane's z8).
    """
    dev = partition.keys.device
    bx, by, bzo = oct_coord(
        cfg, torch.clamp(partition.keys, max=cfg.num_oct_keys - 1))
    # null row -> coord 0 (inside the sticky bound)
    zero = torch.zeros((1,), dtype=bx.dtype, device=dev)
    bx = torch.cat([bx, zero])
    by = torch.cat([by, zero])
    bzo = torch.cat([bzo, zero])
    lane = torch.arange(128, dtype=torch.int32, device=dev)
    z8 = lane >> 4
    cy = (lane >> 2) & 3
    cz = lane & 3
    cx = torch.arange(4, dtype=torch.int32, device=dev)[None, :, None]
    bz = bzo[:, None, None] * 8 + z8[None, None, :]
    return cx, cy[None, None, :], cz[None, None, :], bx, by, bz


def cell_positions(cfg: SimConfig, partition: Partition):
    """World-space x, y, z of every pool cell, each f32[O+1, 4, 128]."""
    cx, cy, cz, bx, by, bz = _cell_coords(cfg, partition)
    bs = cfg.block_size
    x = ((bx[:, None, None] * bs + cx).to(torch.float32) * cfg.dx)
    y = ((by[:, None, None] * bs + cy).to(torch.float32) * cfg.dx)
    z = ((bz * bs + cz).to(torch.float32) * cfg.dx)
    shape = (bx.shape[0], 4, 128)
    return tuple(a.expand(shape) for a in (x, y, z))


def grid_update(
    cfg: SimConfig,
    pool: torch.Tensor,
    partition: Partition,
    dt: torch.Tensor,
    colliders: Sequence = (),
    collider_time: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, mom) pool -> (m, v) pool and max |v|^2, both in the oct layout.

    ``collider_time`` is the time the colliders are posed at, a 0-d tensor
    (the substep's start time; 0 when omitted)."""
    check_analytic(colliders)
    o1 = pool.shape[0]
    m = pool[:, 0:4]                                      # [O+1, 4, 128]
    mom = pool[:, 4:16].reshape(o1, 3, 4, 128)
    has_mass = m > 0.0
    minv = torch.where(has_mass, 1.0 / torch.where(has_mass, m, 1.0), 0.0)
    v = mom * minv[:, None]

    _, _, _, bx, by, bz = _cell_coords(cfg, partition)
    g = cfg.grid_size
    b = cfg.bound_blocks

    def near(c):
        return (c < b) | (c >= g - b)

    v = torch.stack([
        torch.where(near(bx)[:, None, None], 0.0, v[:, 0]),
        torch.where(near(by)[:, None, None], 0.0, v[:, 1]),
        torch.where(near(bz), 0.0, v[:, 2]),
    ], dim=1)

    gvec = torch.tensor(cfg.gravity, dtype=v.dtype, device=v.device)
    v = v + gvec[None, :, None, None] * dt

    if colliders:
        t = (collider_time if collider_time is not None
             else torch.zeros((), dtype=torch.float32, device=pool.device))
        x3 = cell_positions(cfg, partition)
        v3 = (v[:, 0], v[:, 1], v[:, 2])
        for col in colliders:
            v3 = col.resolve_soa(x3, v3, t)
        v = torch.stack(v3, dim=1)

    v = torch.where(has_mass[:, None], v, 0.0)

    vel_sqr = (v * v).sum(dim=1)                          # [O+1, 4, 128]
    vel_sqr = torch.where(torch.isnan(vel_sqr), torch.inf, vel_sqr)
    max_vel_sqr = torch.where(has_mass, vel_sqr, 0.0).max()

    pool_v = torch.cat([m, v.reshape(o1, 12, 128)], dim=1)
    return pool_v, max_vel_sqr


def compute_dt(
    cfg: SimConfig,
    max_vel_sqr: torch.Tensor,
    cur_time: torch.Tensor,
    next_time: torch.Tensor,
) -> torch.Tensor:
    """CFL-limited step size as a 0-d device tensor.

    A non-finite max velocity (NaN mapped to inf by grid_update) poisons dt
    to NaN, so ``t`` leaves the frame loop in one more substep and the
    divergence surfaces in ``check_health``."""
    max_vel = torch.sqrt(max_vel_sqr)
    dt = torch.full_like(max_vel, cfg.default_dt)
    # a tensor numerator: ``scalar / tensor`` would round via a reciprocal
    cfl_dx = torch.full_like(max_vel, cfg.dx * cfg.cfl)
    dt = torch.where(
        max_vel > 0.0,
        torch.minimum(dt, cfl_dx / torch.clamp(max_vel, min=1e-30)), dt)
    dt = torch.minimum(dt, torch.clamp(next_time - cur_time, min=0.0))
    dt = torch.where(torch.isfinite(max_vel), dt, torch.nan)
    return dt
