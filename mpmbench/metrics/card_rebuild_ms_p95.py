"""On a mesh of cards, the 95th percentile over every rebuilding substep
of the window of the substep's span on the card where it is longest (CUDA
events recorded on every card's stream before and after the ``substep``
call, read after each episode's closing synchronise)."""

import numpy as np

LAYER = "mesh"
UNIT = "ms"
MOVES = "mpps"


def read(rec: dict):
    spans = rec["window"]["rebuild_ms"]
    if len(rec.get("cards", [])) < 2 or not spans:
        return None
    return float(np.percentile(np.asarray(spans, np.float64), 95))
