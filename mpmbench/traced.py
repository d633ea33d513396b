"""The traced episodes of a ``--trace 1`` run and what the readers get.

``trace_episodes`` runs whole episodes (after the window, so the
profiler's cost stays out of it) under ``torch.profiler`` with the CPU and
CUDA activities, each episode inside a ``mpmbench.episode`` range and each
substep call inside ``mpmbench.substep``, and reduces the profile to one
record: the device operations (kernels, copies, sets) inside the episodes,
the host ranges, the episodes' spans, how much of them the device was
busy, and the breakdown (the device operations that took the most time,
and the device's idle gaps by the host range that was running).  Nothing
is written to disk.  ``bounds`` prices one substep and one rebuild of the
snapshot with the frozen counts.  The per-layer readers
(``metrics/<name>.py``) take this record.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

from . import counts

EPISODE = "mpmbench.episode"
# host ranges looked back through to name a gap
_SCAN = 4096


def trace_episodes(eps, n: int, device) -> dict:
    """Run ``n`` episodes of ``eps`` under the profiler; the record."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    runs = []
    with profile(activities=acts) as prof:
        for _ in range(n):
            runs.append(eps.run(label=EPISODE))
    return reduce(prof.events(), runs)


def merge(intervals):
    """The union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return (name[5:] if name.startswith("void ") else name)[:160]


def reduce(events, runs) -> dict:
    """The record of a profile: ``events`` as ``prof.events()`` gives them,
    ``runs`` the episodes' (seconds, spans, rebuilt)."""
    from torch.autograd import DeviceType

    device_ops, host, episodes = [], [], []
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("mpmbench.") or getattr(e, "is_user_annotation", False):
                continue
            device_ops.append((e.name, s, t))
        else:
            if e.name == EPISODE:
                episodes.append((s, t))
            host.append((e.name, s, t))
    episodes.sort()

    def inside(s, t):
        return any(s < b and t > a for a, b in episodes)

    device_ops = [op for op in device_ops if inside(op[1], op[2])]
    window_us = sum(b - a for a, b in episodes)
    busy = []
    for a, b in episodes:
        busy += [(max(s, a), min(t, b)) for _, s, t in device_ops if s < b and t > a]
    busy = merge(busy)
    busy_us = sum(b - a for a, b in busy)

    # idle gaps inside each episode, named by the innermost host range then
    # running (the substep call or the harness when no program range is)
    gaps = []
    for a, b in episodes:
        cur = a
        for s, t in busy:
            if t <= a or s >= b:
                continue
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, t)
        if b > cur:
            gaps.append((cur, b))
    host_sorted = sorted((s, t, n) for n, s, t in host if n != EPISODE)
    starts = [h[0] for h in host_sorted]
    by_host = defaultdict(float)
    for gs, ge in gaps:
        mid = 0.5 * (gs + ge)
        name = "harness"
        # the latest-starting range that still runs at the gap's middle
        for j in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 1 - _SCAN), -1):
            if host_sorted[j][1] >= mid:
                name = host_sorted[j][2]
                break
        by_host[name] += (ge - gs) * 1e-6
    by_op = defaultdict(float)
    for name, s, t in device_ops:
        by_op[short_name(name)] += (t - s) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {
        "device_ops": device_ops,
        "episodes": episodes,
        "window_us": window_us,
        "busy_us": busy_us,
        "substeps": sum(len(r[2]) for r in runs),
        "rebuilds": sum(sum(r[2]) for r in runs),
        "breakdown": {"device_ops": top(by_op), "idle_gaps": top(by_host)},
    }


def kernel_us(rec: dict, patterns) -> tuple:
    """(summed device microseconds, operations) of the device operations
    whose name matches one of ``patterns`` (regular expressions)."""
    rx = re.compile("|".join(patterns))
    hits = [t - s for name, s, t in rec["device_ops"] if rx.search(name)]
    return sum(hits), len(hits)


def bounds(sizes: dict) -> dict:
    """Least times (ms) of one substep's K1 (every model) and K2, and of one
    rebuild (the rebucket with its sort, every model, and the partition
    rebuild), on the snapshot's sizes (``harness.state_sizes``)."""
    k1 = sum(counts.g2p2g_bound(m["material"], m["slots"], m["tiles"], sizes["octs"],
                                m["active"])["bound_ms"] for m in sizes["models"])
    k2 = counts.grid_bound(sizes["pool_rows"], sizes["max_active_octs"],
                           sizes["massive_cells"])["bound_ms"]
    rb = 0.0
    for m in sizes["models"]:
        b = counts.rebucket_bound(sizes["particle_tile"], m["slots"], m["channels"],
                                  m["active"], m["segments"])
        rb += b["bound_ms"] + b["sort"]["bound_ms"]
    part = counts.partition_bound(sizes["num_oct_keys"], sizes["max_active_octs"],
                                  sizes["octs"], sum(m["tiles"] for m in sizes["models"]),
                                  sizes["octs"])["bound_ms"]
    return {"k1_ms": k1, "k2_ms": k2, "rebucket_ms": rb + part}
