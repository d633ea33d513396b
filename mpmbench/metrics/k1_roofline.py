"""K1, the fused transfer: its least time on the snapshot's sizes (the
frozen ``g2p2g_bound`` of every model, bytes over 3.35 TB/s) over the
device time of its kernels per substep in the traced episodes, in %."""

from mpmbench.traced import kernel_us

LAYER = "transfer"
UNIT = "%"
MOVES = "mpps"
PATTERNS = [r"g2p2g_kernel"]


def read(rec: dict):
    us, ops = kernel_us(rec, PATTERNS)
    if not ops or not rec["substeps"]:
        return None
    return 100.0 * rec["bounds"]["k1_ms"] / (us * 1e-3 / rec["substeps"])
