"""Grid update: the wrapper of the CUDA kernels K2, K2-AC and K2-SDF
(``csrc/grid_update.cu``).

On a CUDA pool it launches a kernel, which replaces
``claymore_tpu/ops/pallas_grid.py`` (analytic and SDF-grid colliders
included); on a CPU pool it runs the plain PyTorch version,
``core/grid.py:grid_update``.  There is no fallback from the kernel:
anything it does not take raises.  Three entry points: no colliders,
analytic colliders only, and any list with an SDF collider in it (which
also takes the SDF node tables).

The collider kernels skip, row by row, the colliders no cell of the row
can touch; ``collider_row_mask`` is the plain twin of that decision (for
the tests and the card's checks: nothing on the main path calls it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..core import grid as grid_ops
from ..core.octpool import oct_coord
from ..core.types import Partition
from ..models import boundary

# words per packed collider: struct Collider in csrc/grid_update.cu
_COLLIDER_WORDS = 24
_TYPES = {boundary.HalfSpace: 0, boundary.Sphere: 1, boundary.Box: 2,
          boundary.SignedDistanceCollider: 3}
_KINDS = {boundary.STICKY: 0, boundary.SLIP: 1, boundary.SEPARATE: 2}
# variant index of cm_grid_update_info
_VARIANTS = {"grid_update": 0, "grid_update_colliders": 1, "grid_update_sdf": 2}

# the cull's constants (csrc/grid_update.cu: kRel, kGrow, kMinPositive)
_REL = np.float32(2.0 ** -16)
_GROW = np.float32(1.0 + 2.0 ** -20)
_MIN_POSITIVE = np.float32(1e-30)


def _sdf_colliders(colliders):
    return [c for c in colliders if isinstance(c, boundary.SignedDistanceCollider)]


def pack_colliders(colliders: Sequence, device) -> torch.Tensor:
    """The colliders as the kernel's POD array, i32[n, 24] on ``device``
    (float words stored by bit pattern).  Geometry constants are computed in
    double and rounded to float32 once, as the plain version's Python
    constants are.  An SDF collider's row holds the index of its node table
    in ``sdf_table_pointers``' array and, in words 7 (low) and 23 (high),
    the device address of its brick minima (``bricks``), or 0 when its band
    is thinner than two nodes and the kernel may not cull by node value."""
    boundary.check_colliders(colliders)
    f = np.zeros((len(colliders), _COLLIDER_WORDS), np.float32)
    i = f.view(np.int32)
    u = f.view(np.uint32)
    n_sdf = 0
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
        elif isinstance(c, boundary.Box):
            f[row, 8:11], f[row, 11:14] = c.center, c.half
        else:
            i[row, 3] = n_sdf
            n_sdf += 1
            f[row, 8:11] = (c.dx,) + c.band
            f[row, 11:14] = c.values.shape
            if c.bound_cells >= 2:
                addr = c.bricks(device).data_ptr()
                u[row, 7], u[row, 23] = addr & 0xFFFFFFFF, addr >> 32
        f[row, 14:17] = mo.trans
        f[row, 17:20] = mo.trans_vel
        f[row, 20:23] = mo.omega
    return torch.from_numpy(i).to(device)


def sdf_table_pointers(colliders: Sequence, device) -> Optional[torch.Tensor]:
    """Device addresses of the SDF colliders' node tables, in list order,
    as i64[k] on ``device`` (None without SDF colliders).  Each table is
    uploaded once per collider and device (``SignedDistanceCollider.table``)
    and lives as long as its collider."""
    sdf = _sdf_colliders(colliders)
    if not sdf:
        return None
    ptrs = [c.table(device).data_ptr() for c in sdf]
    return torch.tensor(ptrs, dtype=torch.int64).to(device)


def grid_update(
    cfg: SimConfig,
    pool: torch.Tensor,
    partition: Partition,
    dt: torch.Tensor,
    colliders: Sequence = (),
    collider_time: Optional[torch.Tensor] = None,
    collider_table: Optional[torch.Tensor] = None,
    sdf_pointers: Optional[torch.Tensor] = None,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, mom) pool -> (m, v) pool and max |v|^2 (a 0-d tensor).

    ``collider_time`` (0-d, default 0) poses the colliders;
    ``collider_table`` and ``sdf_pointers`` are ``pack_colliders`` and
    ``sdf_table_pointers`` of ``colliders`` when the caller keeps them
    (the engine makes both once), else they are made here.  ``row_mask``,
    bool[O+1, len(colliders)] on the pool's device, is optional: it
    receives the kernel's decision per (pool row, collider), True where the
    collider is resolved on the row (``collider_row_mask`` on a CPU pool)."""
    if not pool.is_cuda:
        if row_mask is not None:
            row_mask.copy_(collider_row_mask(cfg, partition, colliders, collider_time))
        return grid_ops.grid_update(cfg, pool, partition, dt, colliders,
                                    collider_time)
    if not colliders:
        if row_mask is not None:
            raise ValueError("row_mask: the grid kernel without colliders culls nothing")
        return _launch(cfg, pool, partition.keys, dt)
    check_collider_count(len(colliders))
    if collider_table is None:
        collider_table = pack_colliders(colliders, pool.device)
    if collider_time is None:
        collider_time = torch.zeros((), dtype=torch.float32, device=pool.device)
    n_sdf = len(_sdf_colliders(colliders))
    if n_sdf and sdf_pointers is None:
        sdf_pointers = sdf_table_pointers(colliders, pool.device)
    return _launch(cfg, pool, partition.keys, dt, collider_table, collider_time,
                   sdf_pointers if n_sdf else None, n_sdf, row_mask)


def _launch(cfg: SimConfig, pool, keys, dt, table=None, t=None, sdf_pointers=None,
            n_sdf: int = 0, row_mask=None):
    with torch.cuda.device(pool.device):     # the kernel runs on the current device
        return _launch_on(cfg, pool, keys, dt, table, t, sdf_pointers, n_sdf, row_mask)


def _launch_on(cfg: SimConfig, pool, keys, dt, table, t, sdf_pointers, n_sdf, row_mask):
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
        nc = table.shape[0]
        _expect(table, torch.int32, (nc, _COLLIDER_WORDS), dev, "collider_table")
        _expect(t, torch.float32, (), dev, "collider_time")
        mask = 0
        if row_mask is not None:
            _expect(row_mask, torch.bool, (o1, nc), dev, "row_mask")
            mask = row_mask.data_ptr()
        if sdf_pointers is None:
            name = "cm_grid_update_colliders"
            err = lib.cm_grid_update_colliders(
                pool.data_ptr(), keys.data_ptr(), pool_v.data_ptr(),
                max_vel_sqr.data_ptr(), dt.data_ptr(), table.data_ptr(),
                nc, t.data_ptr(), mask, o1, cfg.max_active_octs,
                *geometry, cfg.dx, stream)
        else:
            name = "cm_grid_update_sdf"
            _expect(sdf_pointers, torch.int64, (n_sdf,), dev, "sdf_pointers")
            err = lib.cm_grid_update_sdf(
                pool.data_ptr(), keys.data_ptr(), pool_v.data_ptr(),
                max_vel_sqr.data_ptr(), dt.data_ptr(), table.data_ptr(),
                nc, sdf_pointers.data_ptr(), n_sdf, t.data_ptr(), mask,
                o1, cfg.max_active_octs, *geometry, cfg.dx, stream)
    _build.check(err, name)
    grid_update.launches[name[3:]] += 1
    return pool_v, max_vel_sqr


def kernel_info(name: str, num_colliders: int = 3) -> dict:
    """What the card gives a grid kernel variant (``grid_update``,
    ``grid_update_colliders``, ``grid_update_sdf``) with ``num_colliders``
    colliders: registers per thread, resident blocks per SM (the collider
    kernels' persistent grid is SMs x this), dynamic shared memory per block
    in bytes (the collider kernels' grows with the list) and the most
    colliders one launch takes (0 for ``grid_update``)."""
    from . import _build

    out = (ctypes.c_int * 4)()
    _build.check(_build.library().cm_grid_update_info(_VARIANTS[name], num_colliders, out),
                 "cm_grid_update_info")
    return {"registers": out[0], "blocks_per_sm": out[1], "smem_bytes": out[2],
            "max_colliders": out[3]}


@functools.lru_cache(maxsize=None)
def max_colliders() -> int:
    """The most colliders one launch of the collider kernels takes: their
    posed list lives in a block's shared memory (``kMaxColliders``)."""
    return kernel_info("grid_update_colliders", 1)["max_colliders"]


def check_collider_count(n: int) -> None:
    """Raise unless the CUDA collider kernels take ``n`` colliders (the
    plain version takes any number)."""
    if n > max_colliders():
        raise ValueError(f"{n} colliders: the CUDA grid kernel takes at most "
                         f"{max_colliders()} in one list")


def _expect(x: torch.Tensor, dtype, shape, device, name: str) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# --------------------------------------------------------------------------
# the plain twin of the collider kernels' row cull
# --------------------------------------------------------------------------

def _l1(v):
    return (v[0].abs() + v[1].abs()) + v[2].abs()


def _dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _rot_xyz(omega, t, c32):
    """The kernel's rot_xyz: Rx(ox t) Ry(oy t) Rz(oz t), row-major, each
    entry summed in its order."""
    ang = [c32(w) * t for w in omega]
    cx, sx = torch.cos(ang[0]), torch.sin(ang[0])
    cy, sy = torch.cos(ang[1]), torch.sin(ang[1])
    cz, sz = torch.cos(ang[2]), torch.sin(ang[2])
    one, zero = c32(1.0), c32(0.0)
    rx = (one, zero, zero, zero, cx, -sx, zero, sx, cx)
    ry = (cy, zero, sy, zero, one, zero, -sy, zero, cy)
    rz = (cz, -sz, zero, sz, cz, zero, zero, zero, one)

    def mm(a, b):
        return [(a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]) + a[3 * i + 2] * b[6 + j]
                for i in range(3) for j in range(3)]

    return mm(mm(rx, ry), rz)


def _analytic_sd(typ: int, a, b, radius, x):
    if typ == 0:
        return _dot3([x[k] - a[k] for k in range(3)], b)
    if typ == 1:
        d = [x[k] - a[k] for k in range(3)]
        return torch.sqrt(_dot3(d, d)) - radius
    zero = torch.zeros((), dtype=torch.float32, device=x[0].device)
    d = [(x[k] - a[k]).abs() - b[k] for k in range(3)]
    o = [torch.fmax(dk, zero) for dk in d]
    dmax = torch.fmax(torch.fmax(d[0], d[1]), d[2])
    return torch.sqrt(_dot3(o, o)) + torch.fmin(dmax, zero)


def collider_row_mask(cfg: SimConfig, partition: Partition, colliders: Sequence,
                      collider_time: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool[O+1, len(colliders)]: True where the CUDA collider kernels
    resolve collider i on pool row r, False where they skip it because no
    cell of the row can have sd <= 0.  The plain twin of the kernel's cull
    (``csrc/grid_update.cu:plan_collider``, whose header states why it is
    conservative), operation for operation in float32 from the packed
    constants: the row's world box, the collider posed at
    ``collider_time`` (0-d, default 0), the margin, and for SDF grids the
    band test and the brick minima.  On the partition's device."""
    boundary.check_colliders(colliders)
    dev = partition.keys.device
    f32 = torch.float32
    t = (torch.zeros((), dtype=f32, device=dev) if collider_time is None
         else collider_time.to(dev, f32))
    words = pack_colliders(colliders, "cpu").numpy()
    fl = words.view(np.float32)

    def c32(x):
        return torch.tensor(np.float32(x), dtype=f32, device=dev)

    # the world box of each row: cells (bx*4 + 0..3, by*4 + 0..3, bzo*32 + 0..31)
    bx, by, bzo = oct_coord(cfg, torch.clamp(partition.keys, max=cfg.num_oct_keys - 1))
    zero_i = torch.zeros((1,), dtype=bx.dtype, device=dev)
    base = [torch.cat([bx, zero_i]) * 4, torch.cat([by, zero_i]) * 4,
            torch.cat([bzo, zero_i]) * 32]
    dx, half = c32(cfg.dx), c32(0.5)
    c, h = [], []
    for k, ext in enumerate((3, 3, 31)):
        lo = base[k].to(f32) * dx
        hi = (base[k] + ext).to(f32) * dx
        c.append((lo + hi) * half)
        h.append((hi - lo) * half)
    o1 = c[0].shape[0]
    rel, grow, inf = c32(_REL), c32(_GROW), c32(np.inf)
    keep = torch.ones((o1, len(colliders)), dtype=torch.bool, device=dev)
    for i, col in enumerate(colliders):
        typ, rotating, f = int(words[i, 0]), bool(words[i, 2]), fl[i]
        s = c32(1.0) + c32(f[6]) * t
        off = [c32(f[14 + k]) + c32(f[17 + k]) * t for k in range(3)]
        x0 = [(c[k] - off[k]) / s for k in range(3)]
        if rotating:
            r = _rot_xyz(f[20:23], t, c32)
            xm = [(r[k] * x0[0] + r[3 + k] * x0[1]) + r[6 + k] * x0[2] for k in range(3)]
        else:
            xm = x0
        s_abs = s.abs()
        big = ((_l1(c) + _l1(h)) + _l1(off)) / s_abs
        a = [c32(f[8 + k]) for k in range(3)]
        b = [c32(f[11 + k]) for k in range(3)]
        if typ == 3:
            geo = a[1].abs() + a[2].abs()
        else:
            geo = (_l1(a) + _l1(b)) + c32(f[7] if typ == 1 else 0.0)
        margin = dx + (big + geo) * rel
        if typ != 3:
            rr = (torch.sqrt(_dot3(h, h)) / s_abs) * grow
            keep[:, i] = ~((_analytic_sd(typ, a, b, c32(f[7]), xm) - rr) > margin)
            continue
        dxn, lo, hi = a
        n = [int(f[11 + k]) for k in range(3)]
        if rotating:
            e = [((r[k].abs() * h[0] + r[3 + k].abs() * h[1]) + r[6 + k].abs() * h[2]) / s_abs
                 for k in range(3)]
        else:
            e = [h[k] / s_abs for k in range(3)]
        e = [ek * grow for ek in e]
        amin = [(xm[k] - e[k]) - margin for k in range(3)]
        amax = [(xm[k] + e[k]) + margin for k in range(3)]
        out = torch.zeros((o1,), dtype=torch.bool, device=dev)
        for k in range(3):
            out |= (amax[k] < lo) | (amin[k] >= hi)
        kept = ~out
        if col.bound_cells >= 2 and bool(kept.any()):
            bricks = col.bricks(dev)
            nb = bricks.shape
            blo, cnt = [], []
            for k in range(3):
                i0 = torch.clamp(torch.floor(torch.fmax(amin[k], lo) / dxn).to(torch.int32) - 1,
                                 0, n[k] - 1)
                i1 = torch.clamp(torch.floor(torch.fmin(amax[k], hi) / dxn).to(torch.int32) + 2,
                                 0, n[k] - 1)
                blo.append(i0 >> 3)
                cnt.append(torch.clamp((i1 >> 3) - blo[k] + 1, min=1))
            vmin = torch.full((o1,), np.inf, dtype=f32, device=dev)
            top = [int(cnt[k][kept].max()) for k in range(3)]
            for du in range(top[0]):
                for dv in range(top[1]):
                    for dw in range(top[2]):
                        d = (du, dv, dw)
                        valid = (cnt[0] > du) & (cnt[1] > dv) & (cnt[2] > dw)
                        idx = [torch.clamp(blo[k] + d[k], max=nb[k] - 1).long()
                               for k in range(3)]
                        val = bricks[idx[0], idx[1], idx[2]]
                        vmin = torch.fmin(vmin, torch.where(valid, val, inf))
            kept &= ~(vmin > c32(_MIN_POSITIVE))
        keep[:, i] = kept
    return keep


# launches per kernel, counted where each is launched
grid_update.launches = {"grid_update": 0, "grid_update_colliders": 0,
                        "grid_update_sdf": 0}
