"""Stage timers: tick()/tock(tag) pairs accumulating wall time per stage.

Port of ``claymore_tpu/utils/timers.py``.  ``tock`` synchronises the CUDA
device first when asked to, so the time includes the device work queued
since ``tick`` (the JAX package blocks on a value instead).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


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
