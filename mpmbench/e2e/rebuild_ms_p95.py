"""The 95th percentile, over every rebuilding substep of the window, of the
substep's span on the device timeline (CUDA events recorded before and
after the ``substep`` call, read after each episode's closing
synchronise)."""

import numpy as np

UNIT = "ms"


def read(run: dict):
    spans = run["rebuild_ms"]
    if not spans:
        return None
    return float(np.percentile(np.asarray(spans, np.float64), 95))
