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

Each device operation keeps its card (``op_cards``, beside
``device_ops``), and each card of the run its busy time
(``card_busy_us``, over ``cards``).  ``busy_us`` is the union over every
card.  Where the operations ran on more than one card, the breakdown
names each operation and each idle gap with its card (``name@cuda:k``),
the gaps being those of each card's own timeline.
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
    cards = sorted({d.index or 0 for d in eps.devices}) if device.type == "cuda" else None
    return reduce(prof.events(), runs, cards)


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


def busy_of(device_ops, episodes) -> list:
    """The merged intervals inside ``episodes`` in which some of
    ``device_ops`` runs."""
    busy = []
    for a, b in episodes:
        busy += [(max(s, a), min(t, b)) for _, s, t in device_ops if s < b and t > a]
    return merge(busy)


def reduce(events, runs, cards=None) -> dict:
    """The record of a profile: ``events`` as ``prof.events()`` gives them,
    ``runs`` the episodes' (seconds, spans, rebuilt), ``cards`` the device
    indices the run used (by default those the operations ran on)."""
    from torch.autograd import DeviceType

    device_ops, op_cards, host, episodes = [], [], [], []
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("mpmbench.") or getattr(e, "is_user_annotation", False):
                continue
            device_ops.append((e.name, s, t))
            op_cards.append(int(getattr(e, "device_index", 0)))
        else:
            if e.name == EPISODE:
                episodes.append((s, t))
            host.append((e.name, s, t))
    episodes.sort()

    def inside(s, t):
        return any(s < b and t > a for a, b in episodes)

    kept = [i for i, op in enumerate(device_ops) if inside(op[1], op[2])]
    device_ops = [device_ops[i] for i in kept]
    op_cards = [op_cards[i] for i in kept]
    cards = sorted(set(op_cards)) if cards is None else list(cards)
    window_us = sum(b - a for a, b in episodes)
    busy = busy_of(device_ops, episodes)
    busy_us = sum(b - a for a, b in busy)
    per_card = {c: busy_of([op for op, k in zip(device_ops, op_cards) if k == c], episodes)
                for c in cards}
    several = len(set(op_cards)) > 1
    host_sorted = sorted((s, t, n) for n, s, t in host if n != EPISODE)
    starts = [h[0] for h in host_sorted]
    by_host = defaultdict(float)
    # idle gaps inside each episode (of each card's timeline where the
    # operations ran on several), named by the innermost host range then
    # running (the substep call or the harness when no program range is)
    for card, card_busy in (per_card.items() if several else [(None, busy)]):
        for gs, ge in gaps_of(card_busy, episodes):
            mid = 0.5 * (gs + ge)
            name = "harness"
            # the latest-starting range that still runs at the gap's middle
            for j in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 1 - _SCAN), -1):
                if host_sorted[j][1] >= mid:
                    name = host_sorted[j][2]
                    break
            by_host[name if card is None else f"{name}@cuda:{card}"] += (ge - gs) * 1e-6
    by_op = defaultdict(float)
    for (name, s, t), card in zip(device_ops, op_cards):
        by_op[short_name(name) + (f"@cuda:{card}" if several else "")] += (t - s) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {
        "device_ops": device_ops,
        "op_cards": op_cards,
        "cards": cards,
        "card_busy_us": [sum(b - a for a, b in per_card[c]) for c in cards],
        "episodes": episodes,
        "window_us": window_us,
        "busy_us": busy_us,
        "substeps": sum(len(r[2]) for r in runs),
        "rebuilds": sum(sum(r[2]) for r in runs),
        "breakdown": {"device_ops": top(by_op), "idle_gaps": top(by_host)},
    }


def gaps_of(busy, episodes) -> list:
    """The intervals inside each episode in which none of the merged
    ``busy`` intervals runs."""
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
    return gaps


def kernel_us(rec: dict, patterns) -> tuple:
    """(summed device microseconds, operations) of the device operations
    whose name matches one of ``patterns`` (regular expressions)."""
    rx = re.compile("|".join(patterns))
    hits = [t - s for name, s, t in rec["device_ops"] if rx.search(name)]
    return sum(hits), len(hits)


def card_kernel_us(rec: dict, patterns) -> tuple:
    """({card: summed device microseconds}, operations) of the device
    operations whose name matches one of ``patterns``, each on its card."""
    rx = re.compile("|".join(patterns))
    per_card = {c: 0.0 for c in rec.get("cards", [])}
    hits = 0
    for (name, s, t), card in zip(rec["device_ops"], rec["op_cards"]):
        if card in per_card and rx.search(name):
            per_card[card] += t - s
            hits += 1
    return per_card, hits


def bounds(sizes: dict) -> dict:
    """Least times (ms) of one substep's K1 (every model) and K2 (with the
    configuration's colliders), and of one rebuild (the rebucket with its sort, every model, and the partition
    rebuild), on the snapshot's sizes (``harness.state_sizes``)."""
    k1 = sum(counts.g2p2g_bound(m["material"], m["slots"], m["tiles"], sizes["octs"],
                                m["active"])["bound_ms"] for m in sizes["models"])
    k2 = counts.grid_bound(sizes["pool_rows"], sizes["max_active_octs"],
                           sizes["massive_cells"], sizes.get("colliders", ()))["bound_ms"]
    rb = 0.0
    for m in sizes["models"]:
        b = counts.rebucket_bound(sizes["particle_tile"], m["slots"], m["channels"],
                                  m["active"], m["segments"])
        rb += b["bound_ms"] + b["sort"]["bound_ms"]
    part = counts.partition_bound(sizes["num_oct_keys"], sizes["max_active_octs"],
                                  sizes["octs"], sum(m["tiles"] for m in sizes["models"]),
                                  sizes["octs"])["bound_ms"]
    return {"k1_ms": k1, "k2_ms": k2, "rebucket_ms": rb + part}
