"""The Mosaic probes P1-P6 as CUDA kernels: their wrappers and plain versions.

P1-P4 (``csrc/prof_laneops.cu``) replace the four probes of
``scripts/prof_laneops.py``: reads and writes in fast memory at a
data-dependent lane offset.  P5 and P6 (``csrc/prof_dma.cu``) replace
``dma_gather_bench`` and ``rmw_bench`` of ``scripts/prof_dma.py``: the
gather of runs of pool rows and their read-modify-write.  On CUDA tensors
each wrapper launches its kernel and counts the launch in ``launches``; on
CPU tensors it runs the plain PyTorch version beside it.  Anything the
kernel does not take raises; there is no fallback.

P1-P4 take a grid of G tiles, ``x`` f32[G, 16, 128] (P3: f32[G, 16, 384])
with one shift per tile, ``shifts`` i32[G]; G = 1 is the TPU probe.  P5 and
P6 take the pool f32[O, 16, 128] and the run starts ``idx`` i32[G, D] (the
script's flat ``idx`` viewed as G programs of D runs), each run ``run_rows``
(R) rows long.
"""

from __future__ import annotations

import torch

from .grid_kernel import _expect

ROWS, LANES = 16, 128
ROW_FLOATS = ROWS * LANES
# the largest shift each windowed probe takes (its window stays in the tile)
MAX_SHIFT = {"dyn_lane_read": 96, "dyn_lane_read_wide": 240, "dyn_lane_write": 80}
WIDE_LANES = 384      # P3's three-oct row
WIDE_BASE = 112       # P3 reads lanes s + 112 ... s + 143
# lanes of each row a probe must read and write
LANE_TRAFFIC = {"dyn_roll": (128, 128), "dyn_lane_read": (32, 32),
                "dyn_lane_read_wide": (32, 32), "dyn_lane_write": (32, 128)}


def laneop_bytes(name: str, tiles: int) -> int:
    """Bytes a lane probe must move on ``tiles`` tiles: the lanes it reads
    and writes, once each, and the shifts."""
    read, written = LANE_TRAFFIC[name]
    return tiles * (ROWS * 4 * (read + written) + 4)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _check_shifts(name: str, shifts: torch.Tensor) -> None:
    bad = (shifts < 0) | (shifts > MAX_SHIFT[name])
    if bool(bad.any()):
        raise ValueError(f"{name}: shift {int(shifts[bad][0])} leaves the window "
                         f"(0 <= s <= {MAX_SHIFT[name]})")


def _lane_gather(x: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """out[g, row, j] = x[g, row, lanes[g, j]]"""
    return x.gather(2, lanes[:, None, :].expand(-1, x.shape[1], -1))


def plain_dyn_roll(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P1: ``o[g, :, j] = x[g, :, (j + s[g]) % 128]``, ``pltpu.roll(x, -s, 1)``."""
    j = torch.arange(LANES, device=x.device)
    return _lane_gather(x, (j[None, :] + shifts.long()[:, None]) % LANES)


def plain_dyn_lane_read(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P2: ``o[g] = x[g, :, s[g] : s[g] + 32]``."""
    _check_shifts("dyn_lane_read", shifts)
    j = torch.arange(32, device=x.device)
    return _lane_gather(x, shifts.long()[:, None] + j[None, :])


def plain_dyn_lane_read_wide(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P3: ``o[g] = x[g, :, s[g] + 112 : s[g] + 144]`` of a [16, 384] row."""
    _check_shifts("dyn_lane_read_wide", shifts)
    j = torch.arange(32, device=x.device)
    return _lane_gather(x, shifts.long()[:, None] + WIDE_BASE + j[None, :])


def plain_dyn_lane_write(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P4: ``o = 0; o[:, s:s+32] = 2 x[:, :32]; o[:, s+32:s+48] += x[:, :16]``."""
    _check_shifts("dyn_lane_write", shifts)
    d = torch.arange(LANES, device=x.device)[None, :] - shifts.long()[:, None]
    x32 = x[..., :32]
    doubled = _lane_gather(x32, d.clamp(0, 31)) * 2.0
    added = _lane_gather(x32, (d - 32).clamp(0, 31))
    out = torch.zeros_like(x)
    out = torch.where(((d >= 0) & (d < 32))[:, None, :], doubled, out)
    return torch.where(((d >= 32) & (d < 48))[:, None, :], out + added, out)


def _run_rows(name: str, pool: torch.Tensor, idx: torch.Tensor, run_rows: int):
    """Row indices [G, D, R] of every run, after checking the starts."""
    o = pool.shape[0]
    if run_rows < 1 or bool(((idx < 0) | (idx > o - run_rows)).any()):
        raise ValueError(f"{name}: run starts must lie in [0, {o - run_rows}]")
    r = torch.arange(run_rows, device=idx.device)
    return idx.long()[..., None] + r


def plain_dma_gather(pool: torch.Tensor, idx: torch.Tensor, run_rows: int) -> torch.Tensor:
    """P5: ``out[g] = sum_d sum_r pool[idx[g, d] + r]``, summed as the kernel
    sums: ``part = row_0 + ... + row_{R-1}``, then ``acc = acc + part`` over d."""
    rows = _run_rows("dma_gather", pool, idx, run_rows)
    flat = pool.reshape(pool.shape[0], ROW_FLOATS)
    acc = torch.zeros((idx.shape[0], ROW_FLOATS), dtype=pool.dtype, device=pool.device)
    for d in range(idx.shape[1]):
        part = flat[rows[:, d, 0]]
        for r in range(1, run_rows):
            part = part + flat[rows[:, d, r]]
        acc = acc + part
    return acc.reshape(idx.shape[0], ROWS, LANES)


def plain_rmw(pool: torch.Tensor, idx: torch.Tensor, run_rows: int) -> torch.Tensor:
    """P6: ``pool[idx[g, d] + r] += 1`` for every run, in place; returns
    ``out`` f32[G, 128] with ``out[g, 0] = g`` and 0 elsewhere.

    Each row gets its count of covering runs in one add, which equals one
    add of 1 per run wherever the sums are exact (integer-valued pool
    values below 2**24, as in the script's zero pool)."""
    rows = _run_rows("rmw", pool, idx, run_rows).reshape(-1)
    o = pool.shape[0]
    counts = torch.bincount(rows, minlength=o).to(pool.dtype)
    touched = counts > 0
    flat = pool.view(o, ROW_FLOATS)
    flat[touched] += counts[touched][:, None]
    out = torch.zeros((idx.shape[0], LANES), dtype=pool.dtype, device=pool.device)
    out[:, 0] = torch.arange(idx.shape[0], dtype=pool.dtype, device=pool.device)
    return out


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _launch_laneop(name: str, x: torch.Tensor, shifts: torch.Tensor, lanes: int,
                   out_lanes: int) -> torch.Tensor:
    from . import _build

    g = x.shape[0] if x.dim() == 3 else 0
    if g < 1:
        raise ValueError(f"{name}: x must be f32[G, 16, {lanes}] with G >= 1")
    _expect(x, torch.float32, (g, ROWS, lanes), x.device, "x")
    _expect(shifts, torch.int32, (g,), x.device, "shifts")
    out = torch.empty((g, ROWS, out_lanes), dtype=torch.float32, device=x.device)
    entry = "cm_prof_" + name
    err = getattr(_build.library(), entry)(
        x.data_ptr(), shifts.data_ptr(), out.data_ptr(), g,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, entry)
    launches[name] += 1
    return out


def dyn_roll(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P1 on G tiles: f32[G, 16, 128] -> f32[G, 16, 128]."""
    if not x.is_cuda:
        return plain_dyn_roll(x, shifts)
    return _launch_laneop("dyn_roll", x, shifts, LANES, LANES)


def dyn_lane_read(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P2 on G tiles: f32[G, 16, 128] -> f32[G, 16, 32], 0 <= s <= 96 (the
    kernel writes NaN for a tile whose shift is out of range)."""
    if not x.is_cuda:
        return plain_dyn_lane_read(x, shifts)
    return _launch_laneop("dyn_lane_read", x, shifts, LANES, 32)


def dyn_lane_read_wide(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P3 on G tiles: f32[G, 16, 384] -> f32[G, 16, 32], 0 <= s <= 240."""
    if not x.is_cuda:
        return plain_dyn_lane_read_wide(x, shifts)
    return _launch_laneop("dyn_lane_read_wide", x, shifts, WIDE_LANES, 32)


def laneop_info(name: str) -> dict:
    """Registers per thread, resident blocks per SM and static shared memory
    per block of P2's or P3's kernel on the current card."""
    import ctypes

    from . import _build

    which = {"dyn_lane_read": 0, "dyn_lane_read_wide": 1}[name]
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().cm_prof_laneops_info(which, out), "cm_prof_laneops_info")
    return {"registers": out[0], "blocks_per_sm": out[1], "smem_bytes": out[2]}


def dyn_lane_write(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P4 on G tiles: f32[G, 16, 128] -> f32[G, 16, 128], 0 <= s <= 80."""
    if not x.is_cuda:
        return plain_dyn_lane_write(x, shifts)
    return _launch_laneop("dyn_lane_write", x, shifts, LANES, LANES)


def _launch_dma(name: str, pool: torch.Tensor, idx: torch.Tensor, run_rows: int,
                out: torch.Tensor) -> None:
    from . import _build

    if pool.dim() != 3 or idx.dim() != 2 or min(idx.shape) < 1 or run_rows < 1:
        raise ValueError(f"{name}: pool f32[O, 16, 128], idx i32[G, D], R >= 1 expected")
    _expect(pool, torch.float32, (pool.shape[0], ROWS, LANES), pool.device, "pool")
    _expect(idx, torch.int32, tuple(idx.shape), pool.device, "idx")
    g, d = idx.shape
    entry = "cm_prof_" + name
    err = getattr(_build.library(), entry)(
        pool.data_ptr(), idx.data_ptr(), out.data_ptr(), pool.shape[0], g, d,
        run_rows, torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(err, entry)
    launches[name] += 1


def dma_gather(pool: torch.Tensor, idx: torch.Tensor, run_rows: int,
               ring: bool = False) -> torch.Tensor:
    """P5: f32[G, 16, 128], the sum of each program's D runs of R rows;
    ``ring`` streams the rows through the cp.async ring (the TPU probe's
    ``double_buffer``).  Both variants give the same bits."""
    if not pool.is_cuda:
        return plain_dma_gather(pool, idx, run_rows)
    out = torch.empty((idx.shape[0], ROWS, LANES), dtype=torch.float32,
                      device=pool.device)
    _launch_dma("dma_gather_ring" if ring else "dma_gather", pool, idx, run_rows, out)
    return out


def rmw(pool: torch.Tensor, idx: torch.Tensor, run_rows: int,
        atomic: bool = True) -> torch.Tensor:
    """P6: add 1 to every row of every run of ``pool`` in place; returns
    ``out`` f32[G, 128] (``out[g, 0] = g``).  ``atomic=False`` adds with a
    plain load-add-store, right only when no two runs share a row."""
    if not pool.is_cuda:
        return plain_rmw(pool, idx, run_rows)
    out = torch.empty((idx.shape[0], LANES), dtype=torch.float32, device=pool.device)
    _launch_dma("rmw" if atomic else "rmw_nonatomic", pool, idx, run_rows, out)
    return out


# launches per kernel, counted where each is launched
launches = {"dyn_roll": 0, "dyn_lane_read": 0, "dyn_lane_read_wide": 0,
            "dyn_lane_write": 0, "dma_gather": 0, "dma_gather_ring": 0, "rmw": 0,
            "rmw_nonatomic": 0}
