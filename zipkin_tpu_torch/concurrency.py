"""Concurrency primitives for host-side store coordination.

The port's copy of ``zipkin_tpu/concurrency.py``. ``RWLock`` lets many
readers share a snapshot while one writer publishes the next: the
device-free read replica (``store/replica.py``) applies a shipped
record under the write half and serves reads under the read half, so
its visible (segments, mirror, frontier) triple never moves mid-read.
Writer-preference keeps the apply path from starving behind a stream of
queries. (The port's device store commits in place under its
``_state_lock`` instead, ``store/torch_store.py``.)
"""

from __future__ import annotations

import contextlib
import threading


class RWLock:
    """Writer-preference readers/writer lock (non-reentrant)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()  # lock-order: 42 rwlock-internal
        self._readers = 0  # guarded-by: _cond
        self._writers_waiting = 0  # guarded-by: _cond
        self._writer = False  # guarded-by: _cond

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()
