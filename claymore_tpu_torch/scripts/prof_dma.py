"""The gather and the read-modify-write of runs of pool rows: the probes P5
and P6, beside torch indexing and ``index_add_``.

    python -m claymore_tpu_torch.scripts.prof_dma [--device cuda|cpu]
        [--rows 65536] [--scale 1]

The port of ``scripts/prof_dma.py``, with its configurations on a pool of
``--rows`` rows f32[16, 128] (65,536 rows, 0.5 GiB, as there; ``--scale k``
divides every program count by k, for a small run on the CPU).  Program g
of P5 sums D runs of R rows starting at random rows (the TPU kernel's DMA
gather; its double buffer becomes a ring of cp.async.bulk copies); P6 adds
1 to every row of the same kind of runs in place.  The TPU script's XLA
baselines become the same work in one torch call each: ``index_select`` of
every run's rows, ``index_add_`` of ones into them, and ``index_add_`` with
sorted indices.
Each line gives the milliseconds per call, best of 3 runs of 10 calls (CUDA
events on a card), and the payload over that time (every row as often as a
run names it; P6 and the scatters read and write it); P5 also microseconds
per run.  Every P5 and P6 line also names the plan its call ran (P5:
``probe_kernels.gather_plan``'s choice, direct or two_pass; P6: count, then
stream), the bound (``utils.bounds.dma_bound``) and the share of the bound
that time reaches.  A section times P5 by the plan the rule did not pick,
where R > 1.  The last line, ``launches {...}``, gives the kernel launches
of the run per probe (``probe_kernels.launches``; 0 on the CPU).  Exits 2
when ``--device cuda`` finds no card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

ROW_BYTES = 16 * 128 * 4


def _pool(rows: int, dev, zero: bool = False):
    import torch

    if zero:
        return torch.zeros((rows, 16, 128), dtype=torch.float32, device=dev)
    return torch.arange(rows * 16 * 128, dtype=torch.float32, device=dev).reshape(
        rows, 16, 128)


def _idx(starts: np.ndarray, runs: int, dev):
    import torch

    return torch.from_numpy(np.asarray(starts, np.int32)).to(dev).view(-1, runs)


def _rows(idx, run_rows: int):
    import torch

    r = torch.arange(run_rows, device=idx.device)
    return (idx.reshape(-1).long()[:, None] + r).reshape(-1)


def _gbs(nbytes: float, ms: float) -> float:
    return nbytes / (ms * 1e-3) / 1e9


def gather_starts(o: int, g: int, d: int, r: int) -> np.ndarray:
    """The TPU script's run starts of P5: ``default_rng(0).integers(0, O - R)``."""
    return np.random.default_rng(0).integers(0, o - r, size=(g * d,))


def rmw_starts(o: int, g: int, d: int, r: int) -> np.ndarray:
    """The TPU script's run starts of P6: ``default_rng(0).permutation(O - R)``
    (distinct starts; the runs overlap for R > 1)."""
    return np.random.default_rng(0).permutation(o - r)[: g * d]


def index_gather_bench(o, g, d, r, dev):
    """Same payload as P5 through torch indexing: every run's rows gathered."""
    import torch

    from ..utils.timers import best_ms

    pool = _pool(o, dev)
    rows = _rows(_idx(gather_starts(o, g, d, r), d, dev), r)
    ms = best_ms(lambda: torch.index_select(pool, 0, rows)[:, 0, 0].sum(), dev)
    return ms, _gbs(g * d * r * ROW_BYTES, ms)


def index_add_bench(o, g, d, r, dup, dev):
    """Scatter-add of R-row runs into the pool with ``index_add_`` (the P2G
    output side); ``dup=False`` uses disjoint strided runs, repeated."""
    import torch

    from ..utils.timers import best_ms

    rng = np.random.default_rng(0)
    if dup:
        starts = rng.integers(0, o - r, size=(g * d,))
    else:
        n = min(g * d, o // r - 1)
        starts = np.resize(rng.permutation(o // r - 1)[:n] * r, g * d)
    pool = _pool(o, dev, zero=True)
    rows = _rows(_idx(starts, d, dev), r)
    upd = torch.ones((rows.numel(), 16, 128), dtype=torch.float32, device=dev)
    ms = best_ms(lambda: pool.index_add_(0, rows, upd), dev)
    return ms, _gbs(g * d * r * ROW_BYTES, ms)


def index_add_sorted_bench(o, g, s=8, dups=0.1, dev="cuda"):
    """S scatter-adds, each of G rows at sorted, near-unique indices (the
    per-(col, w) decomposition of the TPU script)."""
    import torch

    from ..utils.timers import best_ms

    rng = np.random.default_rng(0)
    base = np.sort(rng.choice(o, size=g, replace=False))
    dup_at = rng.random(g) < dups
    base[dup_at] = np.minimum(base[dup_at] + 0, o - 1)
    idx = torch.from_numpy(np.sort(base)).to(dev)
    pool = _pool(o, dev, zero=True)
    upd = torch.ones((g, 16, 128), dtype=torch.float32, device=dev)

    def body():
        for _ in range(s):
            pool.index_add_(0, idx, upd)

    ms = best_ms(body, dev)
    return ms, _gbs(s * g * ROW_BYTES, ms)


def dma_gather_bench(o, g, d, r, dev, ring: bool = False, plan=None):
    """P5: program g sums D runs of R rows from random starts, by ``plan``
    (``gather_plan``'s when None): (ms, GB/s, plan, bound ms)."""
    from ..ops import probe_kernels as pk
    from ..utils.bounds import dma_bound
    from ..utils.timers import best_ms

    pool = _pool(o, dev)
    idx = _idx(gather_starts(o, g, d, r), d, dev)
    plan = pk.gather_plan(o, g, d, r) if plan is None else plan
    ms = best_ms(lambda: pk._launch_gather(pool, idx, r, ring, plan), dev)
    return ms, _gbs(g * d * r * ROW_BYTES, ms), plan, dma_bound(idx, r)["bound_ms"]


def rmw_bench(o, g, d, r, dev):
    """P6: each of G programs adds 1 to its D runs of R rows in place:
    (ms, GB/s, bound ms)."""
    from ..ops import probe_kernels as pk
    from ..utils.bounds import dma_bound
    from ..utils.timers import best_ms

    pool = _pool(o, dev, zero=True)
    idx = _idx(rmw_starts(o, g, d, r), d, dev)
    ms = best_ms(lambda: pk.rmw(pool, idx, r), dev)
    return ms, _gbs(2 * g * d * r * ROW_BYTES, ms), dma_bound(idx, r, rmw=True)["bound_ms"]


def _plan_tail(plan: str, bound: float, ms: float) -> str:
    return f"  plan {plan}  bound {bound:.4f} ms ({bound / ms:.0%})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("prof_dma", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=65536, help="pool rows O")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every program count G by this")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("prof_dma: --device cuda but no CUDA device is available", file=sys.stderr)
        return 2
    from ..ops import probe_kernels as pk
    from ..utils.timers import device_label

    dev = torch.device(args.device)
    o = args.rows

    def gs(g):
        return max(1, g // args.scale)

    label = device_label(dev)
    print(f"pool [{o},16,128] = {o * ROW_BYTES / 2**30:.2f} GiB; all BW = payload "
          f"GB/s | {label}")
    print("== torch index_select window row-gather baseline ==")
    for g, d, r in [(8192, 4, 9), (8192, 8, 1)]:
        ms, bw = index_gather_bench(o, gs(g), d, r, dev)
        print(f"  G={gs(g)} D={d} R={r}: {ms:7.3f} ms  {bw:7.1f} GB/s")
    print("== torch index_add_ window scatter-add ==")
    for g, d, r, dup in [(8192, 4, 9, True), (4096, 4, 9, False), (8192, 8, 1, True),
                         (8192, 4, 3, True)]:
        ms, bw = index_add_bench(o, gs(g), d, r, dup, dev)
        print(f"  G={gs(g)} D={d} R={r} dup={dup}: {ms:7.3f} ms  {bw:7.1f} GB/s")
    p5 = {False: [(8192, 4, 9), (8192, 8, 1), (2048, 4, 9), (8192, 4, 3)],
          True: [(8192, 4, 9), (8192, 8, 1), (8192, 4, 3), (5120, 16, 1)]}
    for ring, title in ((False, "P5 gather kernel (no double buffer)"),
                        (True, "P5 gather kernel (double buffered: cp.async.bulk ring)")):
        print(f"== {title} ==")
        for g, d, r in p5[ring]:
            ms, bw, plan, bound = dma_gather_bench(o, gs(g), d, r, dev, ring=ring)
            print(f"  G={gs(g)} D={d} R={r}: {ms:7.3f} ms  {bw:7.1f} GB/s  "
                  f"{ms * 1e3 / (gs(g) * d):.3f} us/run" + _plan_tail(plan, bound, ms))
    print("== torch index_add_, sorted near-unique per-slot indices ==")
    for g, s in [(10240, 8), (10240, 1)]:
        ms, bw = index_add_sorted_bench(o, gs(g), s, dev=dev)
        print(f"  G={gs(g)} S={s}: {ms:7.3f} ms  {bw:7.1f} GB/s")
    print("== P5 by the plan the rule did not pick (R > 1) ==")
    for ring in (False, True):
        for g, d, r in p5[ring]:
            if not 2 <= r <= pk.MAX_WINDOW_ROWS:
                continue
            other = pk.PLANS[1 - pk.PLANS.index(pk.gather_plan(o, gs(g), d, r))]
            ms, bw, plan, bound = dma_gather_bench(o, gs(g), d, r, dev, ring=ring, plan=other)
            print(f"  {'ring' if ring else 'registers'} G={gs(g)} D={d} R={r}: {ms:7.3f} ms  "
                  f"{bw:7.1f} GB/s" + _plan_tail(plan, bound, ms))
    print("== P6 RMW read+add+write (count, then stream) ==")
    for g, d, r in [(4096, 4, 9), (4096, 4, 3)]:
        ms, bw, bound = rmw_bench(o, gs(g), d, r, dev)
        print(f"  G={gs(g)} D={d} R={r}: {ms:7.3f} ms  {bw:7.1f} GB/s (r+w)"
              + _plan_tail("count+stream", bound, ms))
    print(f"launches {json.dumps(pk.launches)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
