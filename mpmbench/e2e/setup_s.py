"""Process start until the window opens: imports, the kernel library's
load (or build), the inputs, ``init_state``, the snapshot and the warm-up
episode."""

UNIT = "s"


def read(run: dict):
    return run["setup_s"]
