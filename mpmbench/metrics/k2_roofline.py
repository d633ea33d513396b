"""K2, the grid update: its least time on the snapshot's pool (the frozen
``grid_bound`` with the configuration's colliders, bytes over 3.35 TB/s)
over the device time of its kernels (with or without colliders) per
substep in the traced episodes, in %."""

from mpmbench.traced import kernel_us

LAYER = "grid update"
UNIT = "%"
MOVES = "mpps"
PATTERNS = [r"grid_update_kernel", r"grid_collider_kernel"]


def read(rec: dict):
    us, ops = kernel_us(rec, PATTERNS)
    if not ops or not rec["substeps"]:
        return None
    return 100.0 * rec["bounds"]["k2_ms"] / (us * 1e-3 / rec["substeps"])
