"""The rebucket on a mesh of cards: the device time per rebuild of the
rebucket's kernels, the partition kernels and the key sort's kernels in
the traced episodes, on the card where it is largest."""

from mpmbench.traced import card_kernel_us

LAYER = "rebucket"
UNIT = "ms"
MOVES = "mpps"
PATTERNS = [r"rebucket::", r"partition::", r"DeviceRadixSort", r"fill_reverse_indices"]


def read(rec: dict):
    per_card, hits = card_kernel_us(rec, PATTERNS)
    if len(per_card) < 2 or not hits or not rec["rebuilds"]:
        return None
    return max(per_card.values()) * 1e-3 / rec["rebuilds"]
