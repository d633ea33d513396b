"""Particles times substeps run in the window, over the window's summed
episode time on the host clock (each episode from a synchronise to a
synchronise), in millions a second."""

UNIT = "Mpps"


def read(run: dict):
    if not run["window_s"] > 0:
        return None
    return run["particles"] * run["substeps"] / run["window_s"] / 1e6
