"""The rebucket's least time per rebuild on the snapshot's sizes (the
frozen ``rebucket_bound`` with its sort, every model, plus
``partition_bound``, bytes over 3.35 TB/s) over ``rebucket_ms``, in %."""

import importlib.util
from pathlib import Path

LAYER = "rebucket"
UNIT = "%"
MOVES = "rebuild_ms_p95"


def _rebucket_ms():
    spec = importlib.util.spec_from_file_location(
        "mpmbench_metric_rebucket_ms", Path(__file__).with_name("rebucket_ms.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read(rec: dict):
    ms = _rebucket_ms()(rec)
    if not ms:
        return None
    return 100.0 * rec["bounds"]["rebucket_ms"] / ms
