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

P5 and P6 run several kernels a call (``csrc/prof_dma.cu`` names them);
each phase has a plain twin here: ``rmw_cover`` (P6's count),
``gather_slots`` (P5's plan of distinct starts), ``window_entries`` (the
rows each block of the window sums streams) and ``plain_window_sums``, and
``gather_plan`` is the rule that picks P5's plan from (O, G, D, R).
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


# P5's two plans (csrc/prof_dma.cu): every named row gathered, or each
# distinct start's window summed once and the sums gathered
PLANS = ("direct", "two_pass")
WINDOW_UNIT = 128       # pool rows per block of the window sums (kUnit)
MAX_WINDOW_ROWS = 16    # the longest run the two-pass plan takes (kMaxWindowRows)
# two_pass when it moves under this share of direct's rows: on an H100 the
# two-pass plan moves its bytes at ~0.8-0.87 of the direct gather's rate
# (scripts/prof_dma.py, PERF.md), so it loses at (2048, 4, 9), a share of 0.84
TWO_PASS_SHARE = 0.75


def gather_rows(o: int, g: int, d: int, r: int) -> dict:
    """Pool rows each plan of P5 is expected to move for G D starts drawn
    uniformly from [0, O - R) (the TPU script's): read and written, 8 KB
    each.  Direct reads every named row and writes G; two-pass reads the
    rows the windows cover (and again the halo rows past a block that a
    window of its starts reaches), writes a sum per distinct start, reads
    G D sums back and writes G."""
    q = 1.0 - 1.0 / max(o - r, 1)
    units = -(-o // WINDOW_UNIT)
    # halo row j past a block is read if one of its last R - 1 - j rows starts
    halo = units * sum(1.0 - q ** (g * d * m) for m in range(1, r))
    two = (o * (1.0 - q ** (g * d * r)) + halo + (o - r) * (1.0 - q ** (g * d))
           + g * d + g)
    return {"direct": float(g * d * r + g), "two_pass": two}


def gather_plan(o: int, g: int, d: int, r: int) -> str:
    """The plan ``dma_gather`` runs at (O, G, D, R): two-pass where it is
    expected to move under TWO_PASS_SHARE of the direct plan's rows; direct
    for R = 1 (a window is its row) and for R past MAX_WINDOW_ROWS (the
    ring would not fit a block's shared memory)."""
    if r < 2 or r > MAX_WINDOW_ROWS:
        return "direct"
    est = gather_rows(o, g, d, r)
    return "two_pass" if est["two_pass"] < TWO_PASS_SHARE * est["direct"] else "direct"


def _valid(idx: torch.Tensor, rows: int, run_rows: int) -> torch.Tensor:
    return (idx >= 0) & (idx <= rows - run_rows)


def gather_slots(idx: torch.Tensor, rows: int, run_rows: int) -> torch.Tensor:
    """Twin of P5's plan kernel: i32[rows], at each distinct start s
    1 + the largest flat run index g D + d naming it, 0 elsewhere; starts
    outside the pool are left out."""
    flat = idx.reshape(-1).long()
    k = torch.arange(1, flat.numel() + 1, device=idx.device)
    ok = _valid(flat, rows, run_rows)
    slot = torch.zeros(rows, dtype=torch.long, device=idx.device)
    slot.scatter_reduce_(0, flat[ok], k[ok], "amax")
    return slot.to(torch.int32)


def window_entries(slot: torch.Tensor, run_rows: int, unit: int = WINDOW_UNIT):
    """Twin of the window kernels' lists: ``(rows, need, win)``, each
    [units, unit + R - 1].  Block u covers the starts in [u unit, (u + 1)
    unit); ``rows[u, i]`` is row u unit + i, ``need`` says whether a window
    of the block's starts spans it (the block streams exactly those rows,
    in order), ``win`` is the W index of the window whose last row it is
    (slot - 1), else -1."""
    o, r = slot.shape[0], run_rows
    units = -(-o // unit)
    dev = slot.device
    marks = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                       (slot > 0).long().cumsum(0)])           # marks before row i
    b = torch.arange(units, device=dev)[:, None] * unit
    e = (b + unit).clamp(max=o)
    rows = b + torch.arange(unit + r - 1, device=dev)[None, :]
    lo = torch.maximum(b, rows - r + 1).clamp(max=o)
    hi = torch.minimum(e, rows + 1).clamp(max=o)
    need = (rows < o) & (marks[hi] - marks[lo.clamp(max=hi)] > 0)
    s = rows - r + 1
    inside = (s >= b) & (s < e)
    win = torch.where(inside, slot[s.clamp(0, o - 1)].long() - 1,
                      torch.full_like(s, -1))
    return rows, need, torch.where(need, win, torch.full_like(win, -1))


def plain_window_sums(pool: torch.Tensor, slot: torch.Tensor, run_rows: int,
                      windows: int) -> torch.Tensor:
    """Twin of the window sums: f32[windows, 16, 128] with
    ``W[slot[s] - 1] = row_s + ... + row_{s+R-1}`` (in that order) for each
    start s, 0 in the rows no start names."""
    flat = pool.reshape(pool.shape[0], ROW_FLOATS)
    starts = torch.nonzero(slot > 0).reshape(-1)
    part = flat[starts]
    for r in range(1, run_rows):
        part = part + flat[starts + r]
    w = torch.zeros((windows, ROW_FLOATS), dtype=pool.dtype, device=pool.device)
    w[slot[starts].long() - 1] = part
    return w.reshape(windows, ROWS, LANES)


def plain_dma_gather_two_pass(pool: torch.Tensor, idx: torch.Tensor,
                              run_rows: int) -> torch.Tensor:
    """P5 by the two-pass plan: each distinct start's window summed once,
    then ``acc = ((0 + W_0) + W_1) + ...`` over each program's runs, the
    same adds in the same order as ``plain_dma_gather``."""
    _run_rows("dma_gather", pool, idx, run_rows)
    slot = gather_slots(idx, pool.shape[0], run_rows)
    w = plain_window_sums(pool, slot, run_rows, idx.numel()).reshape(-1, ROW_FLOATS)
    acc = torch.zeros((idx.shape[0], ROW_FLOATS), dtype=pool.dtype, device=pool.device)
    for d in range(idx.shape[1]):
        acc = acc + w[slot[idx[:, d].long()].long() - 1]
    return acc.reshape(idx.shape[0], ROWS, LANES)


def rmw_cover(idx: torch.Tensor, rows: int, run_rows: int) -> torch.Tensor:
    """Twin of P6's count kernel: i32[rows], how many programs' runs cover
    each row (a row that two runs of one program share counts once);
    starts outside the pool are left out."""
    r = torch.arange(run_rows, device=idx.device)
    span = idx.long()[..., None] + r                                  # [G, D, R]
    prog = torch.arange(idx.shape[0], device=idx.device)[:, None, None].expand_as(span)
    ok = _valid(idx, rows, run_rows)[..., None].expand_as(span)
    pairs = torch.unique(prog[ok] * rows + span[ok])
    return torch.bincount(pairs % rows, minlength=rows).to(torch.int32)


def plain_rmw(pool: torch.Tensor, idx: torch.Tensor, run_rows: int) -> torch.Tensor:
    """P6: ``pool[idx[g, d] + r] += 1`` in place, as the TPU grid adds:
    program after program, each reading all its runs before writing them,
    so a row gains 1.0 once per program whose runs cover it (``rmw_cover``),
    one add at a time (1.0 is added to every row covered k or more times,
    for k = 1 ... the largest count).  Returns ``out`` f32[G, 128] with
    ``out[g, 0] = g`` and 0 elsewhere."""
    _run_rows("rmw", pool, idx, run_rows)
    o = pool.shape[0]
    cover = rmw_cover(idx, o, run_rows)
    touched = torch.nonzero(cover).reshape(-1)
    if touched.numel():
        flat = pool.view(o, ROW_FLOATS)
        count = cover[touched][:, None]
        vals = flat[touched]
        for k in range(1, int(count.max()) + 1):
            vals = torch.where(count >= k, vals + 1.0, vals)
        flat[touched] = vals
    out = torch.zeros((idx.shape[0], LANES), dtype=pool.dtype, device=pool.device)
    out[:, 0] = torch.arange(idx.shape[0], dtype=pool.dtype, device=pool.device)
    return out


def dma_bytes(name: str, pool: torch.Tensor, idx: torch.Tensor, run_rows: int,
              plan: str = "direct") -> int:
    """Bytes a P5 (``dma_gather``, by ``plan``) or P6 (``rmw``) call moves
    on these inputs, as its kernels read and write them: rows of 8 KB, the
    starts and the scratch."""
    o, (g, d) = pool.shape[0], idx.shape
    row = ROW_FLOATS * 4
    if name == "rmw":
        touched = int((rmw_cover(idx, o, run_rows) > 0).sum())
        return 2 * touched * row + 3 * o * 4 + idx.numel() * 4 + g * LANES * 4
    if plan == "direct":
        return (g * d * run_rows + g) * row + idx.numel() * 4
    slot = gather_slots(idx, o, run_rows)
    _, need, _ = window_entries(slot, run_rows)
    windows = int((slot > 0).sum())
    return ((int(need.sum()) + windows + g * d + g) * row + 3 * o * 4
            + 2 * idx.numel() * 4)


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


def _check_dma(name: str, pool: torch.Tensor, idx: torch.Tensor, run_rows: int) -> None:
    if pool.dim() != 3 or idx.dim() != 2 or min(idx.shape) < 1 or run_rows < 1:
        raise ValueError(f"{name}: pool f32[O, 16, 128], idx i32[G, D], R >= 1 expected")
    _expect(pool, torch.float32, (pool.shape[0], ROWS, LANES), pool.device, "pool")
    _expect(idx, torch.int32, tuple(idx.shape), pool.device, "idx")


def dma_gather(pool: torch.Tensor, idx: torch.Tensor, run_rows: int,
               ring: bool = False) -> torch.Tensor:
    """P5: f32[G, 16, 128], the sum of each program's D runs of R rows;
    ``ring`` streams the rows through the cp.async.bulk ring (the TPU
    probe's ``double_buffer``).  The plan is ``gather_plan``'s; both
    variants and both plans give the same bits."""
    plan = gather_plan(pool.shape[0], *idx.shape, run_rows)
    return _launch_gather(pool, idx, run_rows, ring, plan)


def _launch_gather(pool: torch.Tensor, idx: torch.Tensor, run_rows: int, ring: bool,
                   plan: str) -> torch.Tensor:
    """``dma_gather`` by ``plan`` ("direct", or "two_pass" for
    2 <= R <= MAX_WINDOW_ROWS): the tests and profilers force the plan
    ``gather_plan`` did not pick through this."""
    o = pool.shape[0]
    if plan not in PLANS or (plan == "two_pass"
                             and not 2 <= run_rows <= MAX_WINDOW_ROWS):
        raise ValueError(f"dma_gather: no plan {plan!r} at R = {run_rows}")
    if not pool.is_cuda:
        fn = plain_dma_gather_two_pass if plan == "two_pass" else plain_dma_gather
        return fn(pool, idx, run_rows)
    from . import _build

    name = "dma_gather_ring" if ring else "dma_gather"
    _check_dma(name, pool, idx, run_rows)
    g, d = idx.shape
    out = torch.empty((g, ROWS, LANES), dtype=torch.float32, device=pool.device)
    slot = wsum = None
    if plan == "two_pass":
        slot = torch.zeros(o, dtype=torch.int32, device=pool.device)
        wsum = torch.empty((g * d, ROWS, LANES), dtype=torch.float32, device=pool.device)
    entry = "cm_prof_" + name
    err = getattr(_build.library(), entry)(
        pool.data_ptr(), idx.data_ptr(), out.data_ptr(),
        None if slot is None else slot.data_ptr(), None if wsum is None else wsum.data_ptr(),
        o, g, d, run_rows, PLANS.index(plan),
        torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(err, entry)
    launches[name] += 1
    return out


def rmw(pool: torch.Tensor, idx: torch.Tensor, run_rows: int) -> torch.Tensor:
    """P6: add 1 in place to every row of ``pool`` once per program whose
    runs cover it (``plain_rmw``); returns ``out`` f32[G, 128]
    (``out[g, 0] = g``; NaN for a program with a start outside the pool,
    whose other runs still count)."""
    if not pool.is_cuda:
        return plain_rmw(pool, idx, run_rows)
    from . import _build

    _check_dma("rmw", pool, idx, run_rows)
    g, d = idx.shape
    out = torch.empty((g, LANES), dtype=torch.float32, device=pool.device)
    cover = torch.zeros(pool.shape[0], dtype=torch.int32, device=pool.device)
    err = _build.library().cm_prof_rmw(
        pool.data_ptr(), idx.data_ptr(), out.data_ptr(), cover.data_ptr(), pool.shape[0],
        g, d, run_rows, torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(err, "cm_prof_rmw")
    launches["rmw"] += 1
    return out


# the sub-kernels of P5 and P6 (csrc/prof_dma.cu, cm_prof_dma_info's order)
DMA_SUBKERNELS = {
    "dma_gather": {"gather": 0, "plan": 2, "window": 3},
    "dma_gather_ring": {"gather": 1, "plan": 2, "window": 4},
    "rmw": {"count": 5, "stream": 6},
}


def dma_info(name: str, run_rows: int = 9) -> dict:
    """Registers per thread, resident blocks per SM and shared memory per
    block (static and dynamic, at ``run_rows``) of each sub-kernel of P5 or
    P6 on the current card: {sub-kernel: {...}}."""
    import ctypes

    from . import _build

    info = {}
    for sub, which in DMA_SUBKERNELS[name].items():
        out = (ctypes.c_int * 3)()
        _build.check(_build.library().cm_prof_dma_info(which, run_rows, out),
                     "cm_prof_dma_info")
        info[sub] = {"registers": out[0], "blocks_per_sm": out[1], "smem_bytes": out[2]}
    return info


# launches per kernel, counted where each is launched
launches = {"dyn_roll": 0, "dyn_lane_read": 0, "dyn_lane_read_wide": 0,
            "dyn_lane_write": 0, "dma_gather": 0, "dma_gather_ring": 0, "rmw": 0}
