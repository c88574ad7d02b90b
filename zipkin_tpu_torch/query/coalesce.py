"""Cross-request query coalescing: N concurrent trace-id queries share
ONE store read (the port's copy of ``zipkin_tpu/query/coalesce.py``).

A read on the card pays a fixed cost whatever its work: the eager
launches of its probe pass, their host syncs and the copy of the
result matrices back. The store already folds arbitrarily many index
probes into one pass (``TorchSpanStore.get_trace_ids_multi`` →
``dev.iquery_trace_ids_multi``), but only WITHIN one call: an API
server handles each request on its own thread, so concurrent requests
would each pay their own pass. QueryCoalescer adds the cross-request
tier: the first arriving thread becomes the micro-batch LEADER, waits
``window_s`` for followers, then executes the union through one
get_trace_ids_multi call and hands each caller its slice. Aggregate
query throughput then scales with concurrency instead of serializing
on the per-read floor.

Correctness: get_trace_ids_multi resolves every query independently
(data-independent probes in one pass; per-query scan fallbacks run
their own singular paths), so coalesced results are identical to
serial execution — asserted by tests/test_torch_query_engine.py, as
tests/test_coalesce.py does for the reference.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence


class _Slot:
    """One caller's queries + its rendezvous state."""

    __slots__ = ("queries", "results", "error", "done")

    def __init__(self, queries):
        self.queries = queries
        self.results = None
        self.error = None
        self.done = False


class ResidentCoalescer:
    """Standing micro-batch executor: the QueryCoalescer's leader
    election generalized into ONE continuously-running thread
    (query/engine.py's index tier rides this).

    Double-buffered staging: while the executor thread has a batch on
    the device, new arrivals accumulate in ``_pending`` (the second
    buffer); the thread swaps the buffers the moment the launch
    returns, so consecutive batches pipeline back-to-back with no
    leader re-election and no per-request window sleep once traffic is
    continuous — the Ragged-Paged-Attention dispatch shape (PAPERS.md):
    one standing probe path fed micro-batches.

    ``window_s`` only applies when the executor went idle: the first
    request of a quiet period waits at most one window for company.
    A batch that accumulated DURING a previous launch dispatches
    immediately (the launch itself was the window). The attribute is
    writable at runtime (daemon ``/vars/queryWindowMs``).

    ``run`` semantics, accounting fields, and error propagation match
    QueryCoalescer exactly (tests/test_torch_query_engine.py drives
    both).
    After ``close()`` the thread is gone and ``run`` degrades to
    inline per-caller execution — queries still answer during and
    after an ordered shutdown.
    """

    def __init__(self, store, window_s: float = 0.0, registry=None,
                 dispatch_timer: Optional[Callable[[float], None]] = None):
        self.store = store
        self.window_s = window_s
        self._dispatch_timer = dispatch_timer
        self._cv = threading.Condition()  # lock-order: 15 coalesce
        self._pending: List[_Slot] = []  # guarded-by: _cv
        self._inflight = 0  # executing slots; guarded-by: _cv
        self._closed = False  # guarded-by: _cv
        self.batches = 0
        self.queries = 0
        self.launches_saved = 0
        self.max_batch = 0
        from zipkin_tpu_torch import obs

        reg = registry or obs.default_registry()
        self._h_batch = reg.register(obs.LatencySketch(
            "zipkin_query_coalesce_batch_queries",
            "Queries per coalesced device launch (size distribution)",
            min_value=1.0))
        # Requests (slots) per launch — the amortization observable:
        # mean > 1 means concurrent requests genuinely shared launches.
        self._h_size = reg.register(obs.LatencySketch(
            "zipkin_query_coalesce_batch_size",
            "Concurrent requests sharing one coalesced device launch",
            min_value=1.0))
        # Started lazily on the first coalesced run(): a QueryService
        # constructed for a handful of reads (tests, read-only library
        # embedding) never pays a standing thread it didn't use.
        self._thread: Optional[threading.Thread] = None

    def _ensure_thread(self) -> None:
        # Caller holds _cv and has checked not-closed.
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="zipkin-query-exec", daemon=True)
            self._thread.start()

    def run(self, queries: Sequence[tuple]) -> List[list]:
        """Resolve ``queries`` (SpanStore.get_trace_ids_multi tuples),
        sharing the standing executor's next launch with every
        concurrent caller. Results are exactly serial execution's."""
        queries = list(queries)
        if not queries:
            return []
        slot = _Slot(queries)
        with self._cv:
            if not self._closed:
                self._ensure_thread()
                self._pending.append(slot)
                self._cv.notify_all()
                while not slot.done:
                    self._cv.wait()
                if slot.error is not None:
                    raise slot.error
                return slot.results
        # Executor stopped (ordered shutdown): inline fallback.
        self._execute([slot])
        if slot.error is not None:
            raise slot.error
        return slot.results

    # -- executor thread -------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                waited = False
                while not self._pending and not self._closed:
                    self._cv.wait()
                    waited = True
                if self._closed and not self._pending:
                    return
            # Idle-entry window only: a batch built while the previous
            # launch ran needs no extra wait (see class docstring).
            w = self.window_s
            if waited and w and w > 0:
                time.sleep(w)
            with self._cv:
                batch, self._pending = self._pending, []
                self._inflight = len(batch)
            try:
                self._execute(batch)
            finally:
                with self._cv:
                    self._inflight = 0
                    self._cv.notify_all()

    def _execute(self, batch: List[_Slot]) -> None:
        """Run one batch through ONE get_trace_ids_multi call and
        resolve every slot (on error: every slot, same error)."""
        err = None
        try:
            flat = [q for s in batch for q in s.queries]
            t0 = time.perf_counter()
            res = self.store.get_trace_ids_multi(flat)
            if self._dispatch_timer is not None:
                self._dispatch_timer(time.perf_counter() - t0)
            i = 0
            for s in batch:
                s.results = res[i:i + len(s.queries)]
                i += len(s.queries)
        except BaseException as e:  # noqa: BLE001 — delivered per slot
            err = e
        with self._cv:
            n_q = 0
            for s in batch:
                if s.results is None and s.error is None:
                    s.error = err or RuntimeError("executor died")
                s.done = True
                n_q += len(s.queries)
            self.batches += 1
            self.queries += n_q
            self.launches_saved += len(batch) - 1
            self.max_batch = max(self.max_batch, len(batch))
            self._cv.notify_all()
        self._h_batch.observe(max(n_q, 1))
        self._h_size.observe(max(len(batch), 1))

    # -- lifecycle -------------------------------------------------------

    def drain(self) -> None:
        """Block until the executor is idle: nothing pending, nothing
        in flight. The quiesce barrier Collector.flush/checkpoint.save
        use — after it returns, no query launch predating the call is
        still on the device."""
        with self._cv:
            while self._pending or self._inflight:
                self._cv.wait(timeout=0.5)

    def close(self) -> None:
        """Stop the executor thread (processing everything already
        queued); later run() calls execute inline."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed


class QueryCoalescer:
    """Leader-based micro-batcher over ``store.get_trace_ids_multi``.

    ``window_s`` is the cross-request batching window: the leader
    sleeps that long before draining the queue, trading a bounded
    latency add for sharing one device launch among every request that
    arrives inside it (the ItemQueue batch-drain role, applied to the
    read path). ``window_s=0`` still coalesces whatever queued while a
    previous batch executed — concurrency alone builds batches, the
    window just widens them.
    """

    def __init__(self, store, window_s: float = 0.002, registry=None):
        self.store = store
        self.window_s = window_s
        self._cv = threading.Condition()  # lock-order: 15 coalesce
        self._pending: List[_Slot] = []  # guarded-by: _cv
        self._leader_active = False  # guarded-by: _cv
        # Observability (surfaced via /metrics): launches_saved is the
        # number of device dispatches coalescing removed vs one-call-
        # per-request; the sketch is the full batch-size distribution
        # (queries per coalesced launch).
        self.batches = 0
        self.queries = 0
        self.launches_saved = 0
        self.max_batch = 0
        from zipkin_tpu_torch import obs

        reg = registry or obs.default_registry()
        self._h_batch = reg.register(obs.LatencySketch(
            "zipkin_query_coalesce_batch_queries",
            "Queries per coalesced device launch (size distribution)",
            min_value=1.0))
        self._h_size = reg.register(obs.LatencySketch(
            "zipkin_query_coalesce_batch_size",
            "Concurrent requests sharing one coalesced device launch",
            min_value=1.0))

    def run(self, queries: Sequence[tuple]) -> List[list]:
        """Resolve ``queries`` (SpanStore.get_trace_ids_multi tuples),
        sharing a launch with any concurrent callers. Returns one id
        list per query, exactly as the store would serially."""
        queries = list(queries)
        if not queries:
            return []
        slot = _Slot(queries)
        with self._cv:
            self._pending.append(slot)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        if not lead:
            with self._cv:
                while not slot.done:
                    self._cv.wait()
            if slot.error is not None:
                raise slot.error
            return slot.results
        # Leader path: from election on, EVERY exit (including an async
        # exception in the sleep or an allocation failure building the
        # flat list) must release leadership and resolve every enqueued
        # slot — a leader that dies without doing both wedges all
        # present AND future callers (followers wait on done; new
        # arrivals defer to the stuck leader flag).
        batch = []
        err = None
        try:
            if self.window_s > 0:
                time.sleep(self.window_s)
            with self._cv:
                batch = self._pending
                self._pending = []
                # New arrivals elect a fresh leader while this batch is
                # on the device — batches pipeline behind the store's
                # own read lock, nothing serializes on this object.
                self._leader_active = False
            flat = [q for s in batch for q in s.queries]
            res = self.store.get_trace_ids_multi(flat)
            i = 0
            for s in batch:
                s.results = res[i:i + len(s.queries)]
                i += len(s.queries)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err = e
        finally:
            with self._cv:
                if self._leader_active:
                    # Died before the drain: take the queue now so the
                    # waiters fail fast instead of hanging leaderless.
                    batch = batch + self._pending
                    self._pending = []
                    self._leader_active = False
                fail = err or RuntimeError("coalesce leader died")
                n_q = 0
                for s in batch:
                    if s.results is None and s.error is None:
                        s.error = fail
                    s.done = True
                    n_q += len(s.queries)
                self.batches += 1
                self.queries += n_q
                self.launches_saved += len(batch) - 1
                self.max_batch = max(self.max_batch, len(batch))
                self._cv.notify_all()
            self._h_batch.observe(max(n_q, 1))
            self._h_size.observe(max(len(batch), 1))
        if slot.error is not None:
            raise slot.error
        return slot.results
