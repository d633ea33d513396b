"""Device time per rebuild in the traced episodes of the rebucket's
kernels, the partition kernels and the key sort's kernels (cub's radix
sort and the sort's index fill)."""

from mpmbench.traced import kernel_us

LAYER = "rebucket"
UNIT = "ms"
MOVES = "rebuild_ms_p95"
PATTERNS = [r"rebucket::", r"partition::", r"DeviceRadixSort", r"fill_reverse_indices"]


def read(rec: dict):
    us, ops = kernel_us(rec, PATTERNS)
    if not ops or not rec["rebuilds"]:
        return None
    return us * 1e-3 / rec["rebuilds"]
