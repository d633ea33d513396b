"""Stage timers: tick()/tock(tag) pairs accumulating wall time per stage.

Port of ``claymore_tpu/utils/timers.py``.  ``tock`` synchronises the CUDA
device first when asked to, so the time includes the device work queued
since ``tick`` (the JAX package blocks on a value instead).  ``device_ms``,
``best_ms`` and ``device_label`` time device work and name the device for
``MPMEngine.profile_stages`` and the profiling scripts; ``device_ops``
counts the device operations of a call; ``profile_trace`` records a
``torch.profiler`` trace (the JAX package's ``jax.profiler`` trace).

``span`` marks the program's own ranges (``claymore.*``: each stage of a
substep, each step of a rebuild, each host read) in such a trace, at no
more than a flag test when no profiler records; ``span_summary`` sums a
profile's device time, host reads and the device's wait after each read
by those ranges.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

# the program's ranges, and of them the host reads (one read a range)
PREFIX = "claymore."
SYNC = PREFIX + "sync."

_profiling = torch.autograd._profiler_enabled
# the profiler's C++ range, the one ``record_function`` opens less its
# Python operator: 1.8 us a use while the profiler records against 14.2 us
# for ``record_function`` (an H100 machine's host, torch 2.11)
_Range = torch._C._profiler._RecordFunctionFast


def device_ms(fn, device) -> float:
    """Milliseconds of one call of ``fn()`` on ``device``: CUDA events around
    it (ending in a synchronise) on a CUDA device, the host clock on the
    CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    stream = torch.cuda.current_stream(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end)


def best_ms(fn, device, iters: int = 10, reps: int = 3) -> float:
    """Milliseconds per call of ``fn()``: the best of ``reps`` runs of
    ``iters`` back-to-back calls, after one warm-up call."""
    fn()

    def run():
        for _ in range(iters):
            fn()

    return min(device_ms(run, device) for _ in range(reps)) / iters


def device_label(device) -> str:
    """What a measurement ran on: ``nvidia-smi``'s ``name, power.limit`` of a
    CUDA device (its torch name where nvidia-smi is missing), else ``cpu``."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(index)


def device_ops(fn):
    """How many operations (kernels, copies, sets) one call of ``fn()`` runs
    on the card: the CUDA events ``torch.profiler`` records, None where it
    records none.  The profiler's tracing stays set up in the process
    after it, and may slow later launches: count after any timing, or in a
    process of its own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA) or None


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` over the block: host activity, and the CUDA
    kernels when a card is present; on exit a Chrome trace (viewable in
    chrome://tracing or Perfetto) is written into ``logdir``.  Yields the
    profiler, whose ``events()`` and ``key_averages()`` stay readable after
    the block."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


class span:
    """``with span(name):`` a ``torch.profiler`` range ``name`` (a host
    event of the trace, as ``record_function`` makes) over the block while
    the profiler records, else nothing (1.0 us a use on an H100 machine's
    host; a bare ``record_function`` costs ~12 us with no profiler
    running).
    ``on_stage(stage)``, when given, is called once the block has ended
    without an exception, outside the range."""

    __slots__ = ("name", "on_stage", "stage", "_range")

    def __init__(self, name: str, on_stage=None, stage: Optional[str] = None):
        self.name = name
        self.on_stage = on_stage
        self.stage = stage
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = _Range(self.name)
            self._range.__enter__()

    def __exit__(self, kind, value, tb):
        if self._range is not None:
            self._range.__exit__(kind, value, tb)
            self._range = None
        if self.on_stage is not None and kind is None:
            self.on_stage(self.stage)


def span_ops(events):
    """(spans, ops) of a ``torch.profiler`` profile (``prof.events()``):
    ``spans`` the program's ranges (``claymore.*``) as (name, start, end) in
    the profile's microseconds, sorted by start; ``ops`` the device
    operations (kernels, copies, sets) as (name, start, end, names) sorted
    by start, ``names`` the spans open when the host launched the operation,
    outermost first (``()`` when none was, or its launch is not in the
    profile).  Spans nest on one host thread, as the program opens them."""
    from torch.autograd import DeviceType

    spans, ops = [], []
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                ops.append((e.name, s, t, getattr(e, "linked_correlation_id", 0) or e.id))
        elif e.name.startswith(PREFIX):
            spans.append((e.name, s, t))
    spans.sort(key=lambda x: (x[1], -x[2]))
    # a device operation carries its launch's correlation id (as
    # ``linked_correlation_id`` where the profiler has it, else as its own
    # ``id``), which is the id of the CUDA runtime call that launched it
    # (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...); the host's framework
    # operations number from 1 in another count, so only runtime calls count
    launched = {e.id: float(e.time_range.start) for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    # each launch's open spans: one sweep over launches and span starts in
    # time order, the open spans a stack
    order = sorted((launched[cid], k) for k, (_, _, _, cid) in enumerate(ops)
                   if cid in launched)
    names = [()] * len(ops)
    stack, i = [], 0
    for at, k in order:
        while i < len(spans) and spans[i][1] <= at:
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < at:
            stack.pop()
        names[k] = tuple(n for n, _, _ in stack)
    ops = sorted(((n, s, t, names[k]) for k, (n, s, t, _) in enumerate(ops)),
                 key=lambda x: x[1])
    return spans, ops


def span_summary(events) -> Dict[str, dict]:
    """{span name: {"count", "host_ms", "device_ms", "stall_ms"}} of a
    ``torch.profiler`` profile (``prof.events()``, CPU and CUDA
    activities): how many ranges of that name ran, their summed host time,
    the device time of the operations launched while one was open (at any
    depth, so a span's sum holds its children's), and for a host read
    (``claymore.sync.*``) the device's idle time from the read's end to
    the start of the next device operation, summed."""
    spans, ops = span_ops(events)
    out = defaultdict(lambda: {"count": 0, "host_ms": 0.0, "device_ms": 0.0,
                               "stall_ms": 0.0})
    for name, s, t in spans:
        out[name]["count"] += 1
        out[name]["host_ms"] += (t - s) * 1e-3
    for _, s, t, names in ops:
        for name in set(names):
            out[name]["device_ms"] += (t - s) * 1e-3
    starts = [s for _, s, _, _ in ops]
    ends = []
    for _, _, t, _ in ops:
        ends.append(max(t, ends[-1]) if ends else t)
    for name, _, t in spans:
        if name.startswith(SYNC):
            k = bisect.bisect_left(starts, t)
            # idle only where no operation started before the read's end
            # still runs at it
            if k < len(ops) and not (k and ends[k - 1] > t):
                out[name]["stall_ms"] += (starts[k] - t) * 1e-3
    return dict(out)


class StageTimer:
    """tick()/tock(tag) accumulating per-stage wall times."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = torch.device(device) if device is not None else None
        self.records: Dict[str, List[float]] = defaultdict(list)
        self._t0: Optional[float] = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self):
        if self.enabled:
            self._sync()
            self._t0 = time.perf_counter()

    def tock(self, tag: str) -> float:
        if not self.enabled:
            return 0.0
        self._sync()
        dt = time.perf_counter() - self._t0
        self.records[tag].append(dt)
        return dt

    @contextlib.contextmanager
    def stage(self, tag: str):
        self.tick()
        yield
        self.tock(tag)

    def summary(self) -> List[Tuple[str, float, float, int]]:
        """[(tag, total_s, mean_ms, count)] sorted by total."""
        rows = [(tag, sum(v), 1e3 * sum(v) / len(v), len(v))
                for tag, v in self.records.items()]
        return sorted(rows, key=lambda r: -r[1])

    def report(self) -> str:
        lines = [f"{'stage':30s} {'total s':>9s} {'mean ms':>9s} {'count':>6s}"]
        for tag, tot, mean, cnt in self.summary():
            lines.append(f"{tag:30s} {tot:9.3f} {mean:9.3f} {cnt:6d}")
        return "\n".join(lines)
