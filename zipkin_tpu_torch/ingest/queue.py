"""Bounded work queue with worker pool and graceful drain.

Reference semantics (ItemQueue.scala:24-68): bounded buffer (default 500)
with N concurrent workers (default 10); ``add`` fails fast with
QueueFullException when the buffer is full (no blocking — pushback
propagates to the transport); ``close`` stops intake, drains what's
queued, then joins the workers. Gauges (size, active workers) mirror the
reference's stats — served through the telemetry registry, which also
fixes the old unlocked ``processed += 1`` read-modify-write: every
worker bumped the same plain int, so concurrent batches could lose
increments (obs.Counter takes a lock per bump)."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Generic, List, Optional, TypeVar

from zipkin_tpu_torch import obs

T = TypeVar("T")

DEFAULT_MAX_SIZE = 500
DEFAULT_CONCURRENCY = 10


class QueueFullException(RuntimeError):
    """The ingest buffer is full; callers should answer TRY_LATER."""


class ItemQueue(Generic[T]):
    def __init__(
        self,
        process: Callable[[T], None],
        max_size: int = DEFAULT_MAX_SIZE,
        concurrency: int = DEFAULT_CONCURRENCY,
        on_error: Optional[Callable[[T, Exception], None]] = None,
        registry: Optional[obs.Registry] = None,
    ):
        self._process = process
        self._on_error = on_error
        self._q: "queue.Queue[T]" = queue.Queue(maxsize=max_size)
        self._closed = threading.Event()
        self._active = 0  # guarded-by: _active_lock
        self._active_lock = threading.Lock()  # lock-order: 81 queue-active
        reg = registry or obs.default_registry()
        self._c_enqueued = reg.register(obs.Counter(
            "zipkin_queue_enqueued_total",
            "Items accepted into the ingest queue"))
        self._c_rejected = reg.register(obs.Counter(
            "zipkin_queue_rejected_total",
            "Enqueue attempts dropped because the queue was full or "
            "closed (TRY_LATER pushback)"))
        self._c_processed = reg.register(obs.Counter(
            "zipkin_queue_processed_total",
            "Items fully processed by queue workers"))
        self._c_errors = reg.register(obs.Counter(
            "zipkin_queue_errors_total",
            "Items whose processing raised (swallow-and-count)"))
        reg.register(obs.Gauge(
            "zipkin_queue_depth", "Items waiting in the ingest queue",
            fn=self._q.qsize))
        reg.register(obs.Gauge(
            "zipkin_queue_active_workers",
            "Workers currently processing an item",
            fn=lambda: self.active_workers))
        self._workers: List[threading.Thread] = [
            threading.Thread(target=self._loop, name=f"item-queue-{i}",
                             daemon=True)
            for i in range(concurrency)
        ]
        for w in self._workers:
            w.start()

    # -- gauges (ItemQueue.scala:43-48) ---------------------------------

    @property
    def size(self) -> int:
        return self._q.qsize()

    @property
    def active_workers(self) -> int:
        with self._active_lock:
            return self._active

    @property
    def processed(self) -> int:
        return int(self._c_processed.value)

    @property
    def errors(self) -> int:
        return int(self._c_errors.value)

    @property
    def rejected(self) -> int:
        return int(self._c_rejected.value)

    # -- intake ---------------------------------------------------------

    def add(self, item: T) -> None:
        if self._closed.is_set():
            self._c_rejected.inc()
            raise QueueFullException("queue is closed")
        try:
            self._q.put_nowait(item)
        except queue.Full:
            self._c_rejected.inc()
            raise QueueFullException(
                f"ingest queue full ({self._q.maxsize})"
            ) from None
        self._c_enqueued.inc()

    # -- workers --------------------------------------------------------

    def _loop(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            with self._active_lock:
                self._active += 1
            try:
                self._process(item)
                self._c_processed.inc()
            except Exception as e:  # swallow-and-count, like the reference
                self._c_errors.inc()
                if self._on_error is not None:
                    self._on_error(item, e)
            finally:
                with self._active_lock:
                    self._active -= 1
                self._q.task_done()

    def join(self) -> None:
        """Block until everything currently queued is processed."""
        self._q.join()

    def close(self, timeout: float = 30.0) -> None:
        """Stop intake, drain the queue, join workers
        (ItemQueue.scala:65-68; 30s default mirrors the collector flag)."""
        self._closed.set()
        self._q.join()
        for w in self._workers:
            w.join(timeout=timeout / max(1, len(self._workers)))
