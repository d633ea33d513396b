"""K1, the fused transfer, on a mesh of cards: the device time per
substep of its kernels in the traced episodes, on the card where it is
largest (the card the others wait for)."""

from mpmbench.traced import card_kernel_us

LAYER = "transfer"
UNIT = "ms"
MOVES = "mpps"
PATTERNS = [r"g2p2g_kernel"]


def read(rec: dict):
    per_card, hits = card_kernel_us(rec, PATTERNS)
    if len(per_card) < 2 or not hits or not rec["substeps"]:
        return None
    return max(per_card.values()) * 1e-3 / rec["substeps"]
