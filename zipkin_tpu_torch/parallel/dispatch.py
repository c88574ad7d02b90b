"""Cross-shard query dispatcher, torch side: N concurrent sharded
reads, ONE fused cross-shard read per micro-window.

The port's copy of ``zipkin_tpu/parallel/dispatch.py``. The sharded
store serialises every fused cross-shard read behind its
``_coll_lock`` (on one card: the per-shard reads and their reduction
run back to back on the current stream and never interleave with
another thread's), and correctness-by-queueing is a throughput
ceiling: N API threads each pay a full cross-shard read, back to back.
This module batches ANY sharded read into one:

- **catalog reads** (``ShardedSpanStore._cat`` — service presence,
  histogram/top-k rows, HLL registers, spans_seen): >=2 concurrent
  requests fuse into ONE catalog-bundle read (``_fetch_cat_bundle``)
  that reduces every catalog array across the shards at once; the host
  slices each caller's row. A lone request keeps the cheap singular
  per-key read.
- **index top-k reads** (``get_trace_ids_by_name`` /
  ``get_trace_ids_by_annotation``): concurrent requests ride one
  ``get_trace_ids_multi`` call — the batched multi-probe read on every
  shard — the ``query/coalesce.ResidentCoalescer`` move, one tier
  lower (the engine's coalescer batches requests per engine; this
  batches across everything hitting the store, engines included).

Both merges are monoid folds of per-shard results (sums, maxima, row
slicing on the host), so batched answers are bitwise identical to
serialized ones (tests/test_torch_sharded_serving.py).

Executor discipline matches ResidentCoalescer: one standing daemon
thread, started lazily; double-buffered pending list; ``window_s``
applies only on idle entry (a batch built while a read ran needs no
extra wait); after ``close()`` callers degrade to inline execution.
One addition: the store's singular fallbacks re-enter the public query
methods (``get_trace_ids_multi``'s distrusted-bucket path), so a
request arriving FROM the executor thread itself executes inline
instead of enqueueing — the executor waiting on itself would deadlock.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional


class _Req:
    """One caller's request + its rendezvous state. ``ctx`` is the
    submitting thread's (trace_id, span_id) request context
    (obs.fleet.current_request_context) — the dispatcher's fused
    launch span parents under it, so an API read that rode a shared
    collective shows the shared launch as a child span. ``t_enq`` is
    the enqueue timestamp the stuck-queue watchdog ages against."""

    __slots__ = ("kind", "payload", "result", "error", "done", "ctx",
                 "t_enq")

    def __init__(self, kind: str, payload):
        self.kind = kind  # "cat" | "ids"
        self.payload = payload
        self.result = None
        self.error = None
        self.done = False
        self.ctx = None
        self.t_enq = 0.0


class CrossShardDispatcher:
    """Standing micro-batch executor for a ``ShardedSpanStore``.

    The store routes ``_cat`` and the singular top-k entry points here
    while the dispatcher is open; ``window_s`` (writable at runtime)
    widens batches when traffic is bursty rather than continuous.
    """

    def __init__(self, store, window_s: float = 0.0, registry=None):
        self.store = store
        self.window_s = window_s
        self._cv = threading.Condition()  # lock-order: 15 coalesce
        self._pending: List[_Req] = []  # guarded-by: _cv
        self._inflight = 0  # guarded-by: _cv
        self._closed = False  # guarded-by: _cv
        self.batches = 0
        self.requests = 0
        self.launches_saved = 0
        self.max_batch = 0
        from zipkin_tpu_torch import obs

        reg = registry or obs.default_registry()
        # Requests per dispatcher batch — the amortization observable
        # (mean > 1 ⇔ concurrent sharded reads genuinely shared
        # collective launches).
        self._h_size = reg.register(obs.LatencySketch(
            "zipkin_shard_dispatch_batch_size",
            "Concurrent sharded reads sharing one dispatcher batch",
            min_value=1.0))
        # Self-trace sink (obs.fleet.LineageTracker or None): when set,
        # each executed batch records a "shard dispatch" span parented
        # under the first rider's request context — the causal link
        # from an API read to the fused collective launch it shared.
        self.span_sink = None
        self._busy_since = 0.0  # guarded-by: _cv (0.0 = idle)
        # Started lazily: a store constructed for a handful of reads
        # never pays a standing thread it didn't use.
        self._thread: Optional[threading.Thread] = None

    # -- public request surface ------------------------------------------

    def cat(self, key: str, row=None):
        """One catalog entry (optionally one row of it), batched with
        every concurrent catalog read into one fused launch."""
        return self._submit(_Req("cat", (key, row)))

    def ids(self, query: tuple):
        """One get_trace_ids_multi-style query tuple, batched with
        every concurrent index read into one multi-probe launch."""
        return self._submit(_Req("ids", query))

    def _submit(self, req: _Req):
        if self.span_sink is not None:
            from zipkin_tpu_torch.obs import fleet as _fleet

            req.ctx = _fleet.current_request_context()
        req.t_enq = time.monotonic()
        with self._cv:
            closed = self._closed
            reentrant = threading.current_thread() is self._thread
            if not closed and not reentrant:
                self._ensure_thread()
                self._pending.append(req)
                self._cv.notify_all()
                while not req.done:
                    self._cv.wait()
                if req.error is not None:
                    raise req.error
                return req.result
        # Closed (ordered shutdown) or called FROM the executor thread
        # (a singular fallback re-entering the public query surface):
        # execute inline — enqueueing from the executor would deadlock
        # on its own batch.
        self._execute([req])
        if req.error is not None:
            raise req.error
        return req.result

    # -- executor thread -------------------------------------------------

    def _ensure_thread(self) -> None:
        # Caller holds _cv and has checked not-closed.
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="zipkin-shard-dispatch",
                daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cv:
                waited = False
                while not self._pending and not self._closed:
                    self._cv.wait()
                    waited = True
                if self._closed and not self._pending:
                    return
            # Idle-entry window only (see ResidentCoalescer): a batch
            # built while the previous launch ran dispatches now.
            w = self.window_s
            if waited and w and w > 0:
                time.sleep(w)
            with self._cv:
                batch, self._pending = self._pending, []
                self._inflight = len(batch)
                self._busy_since = time.monotonic()
            try:
                self._execute(batch)
            finally:
                with self._cv:
                    self._inflight = 0
                    self._busy_since = 0.0
                    self._cv.notify_all()

    def _execute(self, batch: List[_Req]) -> None:
        """Resolve one batch: every cat request through ≤1 fused
        catalog launch, every ids request through ≤1 multi-probe
        launch. Per-group error fan-out (a failing catalog launch must
        not poison the index reads riding the same batch)."""
        store = self.store
        cat_reqs = [r for r in batch if r.kind == "cat"]
        ids_reqs = [r for r in batch if r.kind == "ids"]
        saved = 0
        t_exec0 = time.perf_counter()
        if cat_reqs:
            try:
                fused = (len(cat_reqs) >= 2 and all(
                    r.payload[0] in store.CAT_BUNDLE_KEYS
                    for r in cat_reqs))
                if fused:
                    bundle = store._fetch_cat_bundle()
                    saved += len(cat_reqs) - 1
                for r in cat_reqs:
                    key, row = r.payload
                    entry = (bundle[key] if fused
                             else store._cat_direct(key))
                    r.result = entry if row is None else entry[row]
            except BaseException as e:  # noqa: BLE001 — per-request
                for r in cat_reqs:
                    if r.error is None and r.result is None:
                        r.error = e
        if ids_reqs:
            try:
                if len(ids_reqs) == 1:
                    q = ids_reqs[0].payload
                    if q[0] == "name":
                        ids_reqs[0].result = (
                            store._get_trace_ids_by_name_direct(*q[1:]))
                    else:
                        ids_reqs[0].result = (
                            store._get_trace_ids_by_annotation_direct(
                                *q[1:]))
                else:
                    res = store.get_trace_ids_multi(
                        [r.payload for r in ids_reqs])
                    for r, ids in zip(ids_reqs, res):
                        r.result = ids
                    saved += len(ids_reqs) - 1
            except BaseException as e:  # noqa: BLE001 — per-request
                for r in ids_reqs:
                    if r.error is None and r.result is None:
                        r.error = e
        with self._cv:
            for r in batch:
                if r.result is None and r.error is None:
                    # A valid empty answer is [] / an array, never None
                    # — None here means the group body died before
                    # assigning.
                    if r.kind == "ids":
                        r.result = []
                r.done = True
            self.batches += 1
            self.requests += len(batch)
            self.launches_saved += saved
            self.max_batch = max(self.max_batch, len(batch))
            self._cv.notify_all()
        self._h_size.observe(max(len(batch), 1))
        sink = self.span_sink
        if sink is not None:
            # One span per executed batch, parented under the first
            # rider that carried a request context — the other riders
            # are listed in the tags rather than given duplicate spans
            # (a fused launch IS one unit of work).
            ctx = next((r.ctx for r in batch if r.ctx is not None),
                       None)
            if ctx is not None:
                dur_us = max(
                    1, int((time.perf_counter() - t_exec0) * 1e6))
                try:
                    sink.record_span(
                        ctx[0], ctx[1], "shard dispatch",
                        int(time.time() * 1e6) - dur_us, dur_us,
                        {"dispatch.batch": str(len(batch)),
                         "dispatch.cat": str(len(cat_reqs)),
                         "dispatch.ids": str(len(ids_reqs)),
                         "dispatch.saved": str(saved)})
                except Exception:  # graftlint: disable=swallowed-exception
                    pass  # tracing is advisory — a sink failure must
                    # never fail the query batch it annotates

    # -- lifecycle -------------------------------------------------------

    def drain(self) -> None:
        """Block until the executor is idle (nothing pending, nothing
        in flight) — the quiesce barrier checkpoint/close use."""
        with self._cv:
            while self._pending or self._inflight:
                self._cv.wait(timeout=0.5)

    def close(self) -> None:
        """Stop the executor thread (processing everything already
        queued); later requests execute inline."""
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

    def queue_age_s(self) -> float:
        """Age of the dispatcher's oldest unfinished work: seconds the
        oldest pending request has waited, or seconds the in-flight
        batch has been executing — whichever is older; 0.0 when idle.
        The stuck-queue watchdog signal (obs.fleet): a healthy
        dispatcher turns batches over in one launch time."""
        now = time.monotonic()
        with self._cv:
            age = 0.0
            if self._pending:
                age = now - min(r.t_enq for r in self._pending)
            if self._inflight and self._busy_since:
                age = max(age, now - self._busy_since)
            return max(0.0, age)

    def stats(self) -> dict:
        with self._cv:
            return {
                "batches": self.batches,
                "requests": self.requests,
                "launches_saved": self.launches_saved,
                "max_batch": self.max_batch,
            }
