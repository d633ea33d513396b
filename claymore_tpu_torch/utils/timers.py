"""Stage timers: tick()/tock(tag) pairs accumulating wall time per stage.

Port of ``claymore_tpu/utils/timers.py``.  ``tock`` synchronises the CUDA
device first when asked to, so the time includes the device work queued
since ``tick`` (the JAX package blocks on a value instead).  ``device_ms``,
``best_ms`` and ``device_label`` time device work and name the device for
``MPMEngine.profile_stages`` and the profiling scripts; ``device_ops``
counts the device operations of a call; ``profile_trace`` records a
``torch.profiler`` trace (the JAX package's ``jax.profiler`` trace).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


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
