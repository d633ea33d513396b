"""Frame output: per-model ``.bgeo`` dumps through the async IO queue.

The part of ``claymore_tpu/io/checkpoint.py`` the CLI needs
(``save_frame_bgeo``, ``flush_io``).  Saving and resuming whole states
(``save_state``/``load_state``) is not ported yet (ROADMAP Queue 1,
checkpoints).
"""

from __future__ import annotations

from ..core.types import SimState
from . import async_io, bgeo


def save_frame_bgeo(path: str, engine, state: SimState, model_idx: int = 0,
                    asynchronous: bool = True) -> None:
    """Dump one model's active particles to ``path``.  The positions are
    copied to the host here; the file is written by the IO worker when
    ``asynchronous`` (``flush_io`` waits for it)."""
    pos = engine.get_positions(state, model_idx)
    if asynchronous:
        async_io.insert_job(lambda: bgeo.write_bgeo(path, pos))
    else:
        bgeo.write_bgeo(path, pos)


def flush_io() -> None:
    """Wait for every queued frame dump."""
    async_io.flush()
