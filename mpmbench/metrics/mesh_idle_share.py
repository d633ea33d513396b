"""The largest, over the run's cards, of the share of the traced episodes'
span in which that card runs no kernel, copy or set (each card's own
timeline in the profiler), in %: the time a card of the mesh waits for
the host or for the others.  It is read under the profiler, whose host
cost lengthens a host-bound substep, so it reads higher than the
untraced window's idle would."""

LAYER = "mesh"
UNIT = "%"
MOVES = "mpps"


def read(rec: dict):
    cards = rec.get("cards", [])
    if len(cards) < 2 or not rec["window_us"] > 0:
        return None
    return max(100.0 * (1.0 - b / rec["window_us"]) for b in rec["card_busy_us"])
