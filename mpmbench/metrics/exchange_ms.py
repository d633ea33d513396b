"""The mesh's exchange: device time per substep in the traced episodes of
the halo and migration kernels (``csrc/halo.cu``'s ``halo::`` kernels:
the packs' count, scan and write, the halo rows, the mass mask, the halo
add and the migration payload) and of the copies between cards (the
profiler's peer copies), on the card where it is largest."""

from mpmbench.traced import card_kernel_us

LAYER = "mesh exchange"
UNIT = "ms"
MOVES = "mpps"
PATTERNS = [r"halo::", r"Memcpy PtoP"]


def read(rec: dict):
    per_card, hits = card_kernel_us(rec, PATTERNS)
    if len(per_card) < 2 or not hits or not rec["substeps"]:
        return None
    return max(per_card.values()) * 1e-3 / rec["substeps"]
