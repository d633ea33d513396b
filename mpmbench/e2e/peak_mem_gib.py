"""``torch.cuda.max_memory_allocated()`` over set-up and window (the peak
statistics reset at the start of the run), in GiB."""

UNIT = "GiB"


def read(run: dict):
    peak = run.get("peak_bytes")
    return None if peak is None else peak / 2 ** 30
