"""The whole substep: its least time on the snapshot's sizes (K1 of every
model and K2 each substep, plus the rebuild's least time times the share
of traced substeps that rebuilt; bytes over 3.35 TB/s) over the traced
episodes' time per substep, in %.  It bounds the kernels' shares: a
kernel taken off the path leaves its own share silent, not this one."""

LAYER = "substep"
UNIT = "%"
MOVES = "mpps"


def read(rec: dict):
    n = rec["substeps"]
    if not n or not rec["window_us"] > 0:
        return None
    b = rec["bounds"]
    least = b["k1_ms"] + b["k2_ms"] + b["rebucket_ms"] * rec["rebuilds"] / n
    return 100.0 * least / (rec["window_us"] * 1e-3 / n)
