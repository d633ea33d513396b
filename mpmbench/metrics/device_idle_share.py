"""Share of the traced episodes' span in which no kernel, copy or set runs
on the device (the profiler's timeline), in %."""

LAYER = "device"
UNIT = "%"
MOVES = "mpps"


def read(rec: dict):
    if not rec["window_us"] > 0:
        return None
    return 100.0 * (1.0 - rec["busy_us"] / rec["window_us"])
