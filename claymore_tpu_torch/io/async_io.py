"""Asynchronous output: one background worker thread running IO jobs in
order, so frame dumps overlap the simulation (port of
``claymore_tpu/io/async_io.py``).  File writes release the interpreter
lock, and so does the native BGEO writer (``csrc/bgeo_io.cpp``, called
through ctypes), so a Python thread gives the overlap where the JAX
package queues native writes on its runtime's own thread.  Unlike that
queue, which drops a failed write's code, ``flush`` raises the first
error a job hit.

The worker starts with the first job, not at import.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional


class AsyncIO:
    """Single background worker executing IO jobs in order."""

    _instance: Optional["AsyncIO"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._q: "queue.Queue[Callable[[], None]]" = queue.Queue()
        self._errors: List[BaseException] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @classmethod
    def instance(cls) -> "AsyncIO":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def _run(self):
        while True:
            job = self._q.get()
            try:
                job()
            except Exception as e:  # raised again by flush()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def insert_job(self, fn: Callable[[], None]) -> None:
        """Enqueue an IO job."""
        self._q.put(fn)

    def flush(self) -> None:
        """Wait for all queued jobs; raise the first error one of them hit."""
        self._q.join()
        if self._errors:
            err, self._errors = self._errors[0], []
            raise err


def insert_job(fn: Callable[[], None]) -> None:
    AsyncIO.instance().insert_job(fn)


def flush() -> None:
    AsyncIO.instance().flush()
