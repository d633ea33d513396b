"""Mean span on the device timeline (the window's CUDA events around each
``substep`` call) of the window's substeps that did not rebuild."""

LAYER = "substep"
UNIT = "ms"
MOVES = "mpps"


def read(rec: dict):
    spans = rec["window"]["drift_ms"]
    return sum(spans) / len(spans) if spans else None
