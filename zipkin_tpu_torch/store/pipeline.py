"""Pipelined ingest (host side), torch side.

The port's ``IngestPipeline`` and ``EvictionSealer``
(``zipkin_tpu/store/pipeline.py``). The ingest pipeline is a
three-stage software pipeline over the store's write path.

1. **produce** (caller threads, under the store's encode lock): encode,
   index-policy bits, error flags, the sketch-mirror delta and pow2
   padding — everything that needs the dictionaries but not the device
   — feeding a bounded prefetch queue whose depth is the only
   backpressure on writers;
2. **stage** (one thread): the H2D copy of the padded unit. On CUDA it
   runs on a stream of its own: the unit packed into one pinned host
   buffer and sent with ``non_blocking=True`` (``device.stage_batches``),
   then an event that
   the commit stream waits on before the step. The stage→commit queue
   holds ``stage_buffers`` units (2: double buffering);
3. **commit** (one thread): ``TorchSpanStore._commit_unit``, on the
   stream that was current where the pipeline was started (the stream
   the serial path and the readers use), so readers need no extra
   synchronisation.

Units flow strictly FIFO and the serial and pipelined paths cut the
same launch units through the store's shared ``_plan_units`` /
``_pad_unit`` / ``_commit_unit``, so a pipelined drive lands a state
bitwise equal to the serial path's (``tests/test_torch_pipeline.py``).

Stages 1 and 3 are Python: they share the interpreter lock, and the
step's eager launches and host syncs hold it for most of a commit, so
the overlap is what the chip measures (``chip_smoke.py``
``pipeline_path``), not what three stages promise.

Error semantics match the reference: a worker failure parks the error,
the failed unit is dropped (counted done, so blocked producers always
unblock), and the parked error re-raises once on the next feed or
drain, after which the stage keeps processing.

The ``EvictionSealer`` moves a capture window's device-to-host copy,
decode and seal off the write path (the daemon's ``--capture-backlog``):
the store's pull stays synchronous, the sealer thread copies the pulled
matrices out on a stream of its own and hands the rows to the eviction
sink.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import NamedTuple, Optional

import torch

from zipkin_tpu_torch.store import device as dev

_STOP = object()


class IngestUnit(NamedTuple):
    """One committed launch's worth of work: a padded numpy DeviceBatch
    (stacked along a leading axis when ``chained``: a chained group's
    chunks, or a sharded unit's shards) plus the host
    bookkeeping the commit stage needs. ``n_parts`` is the number of
    chunker parts inside (the sweep-cadence increment). ``wal_seq`` is
    the unit's write-ahead-log sequence (None when no WAL is attached);
    the commit advances the store's applied frontier to it under the
    state lock, in the same hold as the step, so a checkpoint cut is
    always consistent with its manifest sequence. ``sketch`` is
    the unit's host sketch-mirror delta (``store/mirror.py``), folded
    in by the commit under the state lock. ``reclaims`` are the (lo, hi)
    gid ranges of the pages a paged unit's plan reclaims, captured for
    the cold tier before the launch that invalidates them. ``staged``
    is set by stage 2: (the unit's per-step device batches, the device
    buffer they are views of, the CUDA event that marks its copy done);
    the last two are None off CUDA."""

    db: object
    n_spans: int
    n_anns: int
    n_banns: int
    n_parts: int
    chained: bool
    wal_seq: Optional[int] = None
    sketch: Optional[object] = None
    # Sharded units only (parallel/shard.ShardedSpanStore): max spans
    # any shard's part carries, taken from the host batches.
    incoming: Optional[int] = None
    reclaims: tuple = ()
    staged: Optional[tuple] = None


def unit_batches(unit: IngestUnit):
    """The unit's per-step numpy batches, in launch order."""
    return dev.unstack_batches(unit.db) if unit.chained else [unit.db]


class _StageBase:
    """Shared fed/done accounting: every item fed is eventually counted
    done exactly once (processed or dropped on error), so ``drain`` and
    blocked producers always terminate."""

    def __init__(self):
        self._cond = threading.Condition()  # lock-order: 65 stage
        self._fed = 0  # guarded-by: _cond
        self._done = 0  # guarded-by: _cond
        self._error: Optional[BaseException] = None  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        # Monotonic time of the last forward progress (an item
        # completing, or work arriving at an idle stage): the stall
        # watchdog's probe reads its age (obs.fleet).
        self._last_progress = time.monotonic()  # guarded-by: _cond

    @property
    def error(self) -> Optional[BaseException]:
        """The parked worker error, without clearing it."""
        with self._cond:
            return self._error

    def take_error(self) -> Optional[BaseException]:
        """Pop the parked worker error (if any): one failed unit fails
        one caller, then the stage keeps working."""
        with self._cond:
            err, self._error = self._error, None
            return err

    def _check_feedable(self) -> None:
        err = self.take_error()
        if err is not None:
            raise err
        with self._cond:
            if self._closed:
                raise RuntimeError("pipeline stage is stopped")
            if self._done == self._fed:
                # Idle to busy: the stall clock starts at arrival, not
                # at the last completion before the idle gap.
                self._last_progress = time.monotonic()
            self._fed += 1

    def _mark_done(self) -> None:
        with self._cond:
            self._done += 1
            self._last_progress = time.monotonic()
            self._cond.notify_all()

    def progress_age_s(self) -> float:
        """Seconds since this stage last made forward progress while
        holding queued work; 0.0 when idle. The watchdog's pipeline and
        sealer stall signal: a large age with a non-empty queue means a
        wedged worker, not backpressure."""
        with self._cond:
            if self._done >= self._fed:
                return 0.0
            return max(0.0, time.monotonic() - self._last_progress)

    def _park_error(self, exc: BaseException) -> None:
        with self._cond:
            if self._error is None:
                self._error = exc

    def _wait_idle(self) -> None:
        with self._cond:
            while self._done < self._fed:
                self._cond.wait(timeout=0.5)

    def drain(self) -> None:
        """Block until everything fed before this call is processed;
        re-raises (and clears) a parked worker error. Drains to a
        snapshot target, so it ends under sustained feeding."""
        with self._cond:
            target = self._fed
            while self._done < target:
                self._cond.wait(timeout=0.5)
        err = self.take_error()
        if err is not None:
            raise err

    def _unregister(self, registry, metrics) -> None:
        for m in metrics:
            if registry.get(m.name) is m:
                registry.unregister(m.name)


class IngestPipeline(_StageBase):
    """Three-stage ingest pipeline over one TorchSpanStore or one
    ``parallel.ShardedSpanStore`` (see the module docstring). Created by
    the store's ``start_pipeline``;
    writers call ``feed`` (stage 1's tail)."""

    def __init__(self, store, depth: int, stage_buffers: int,
                 registry=None):
        from zipkin_tpu_torch import obs

        super().__init__()
        self._store = store
        self.depth = max(1, int(depth))
        self._prefetch: "queue.Queue" = queue.Queue(maxsize=self.depth)
        # Staged units in flight: 2 is double buffering (one committing,
        # one staging).
        self._staged: "queue.Queue" = queue.Queue(maxsize=stage_buffers)
        self.device = store.device
        # CUDA: the copy runs on a stream of its own; the step runs on
        # the stream that is current here (the serial path's and the
        # readers' stream). Each worker thread sets the device first.
        self._h2d = self._commit_stream = self._cuda_index = None
        if self.device.type == "cuda":
            self._cuda_index = (self.device.index
                                if self.device.index is not None
                                else torch.cuda.current_device())
            self._h2d = torch.cuda.Stream(self._cuda_index)
            self._commit_stream = torch.cuda.current_stream(
                self._cuda_index)
        reg = registry or obs.default_registry()
        self._registry = reg
        self.h_encode = reg.register(obs.LatencySketch(
            "zipkin_store_pipeline_encode_seconds",
            "Stage 1 per apply call: columnar encode + index bits + "
            "sketch delta + pow2 padding (outside the state lock)"))
        self.h_stage = reg.register(obs.LatencySketch(
            "zipkin_store_pipeline_stage_seconds",
            "Stage 2 per unit: H2D copy of the padded batch (enqueue)"))
        self.h_commit = reg.register(obs.LatencySketch(
            "zipkin_store_pipeline_commit_seconds",
            "Stage 3 per unit: the in-place step(s) and mirror fold "
            "under the state lock"))
        self.g_depth = reg.register(obs.Gauge(
            "zipkin_store_pipeline_prefetch_depth",
            "Padded units waiting in the ingest prefetch queue",
            fn=lambda: float(self._prefetch.qsize())))
        self.c_stall = reg.register(obs.Counter(
            "zipkin_store_pipeline_stall_seconds_total",
            "Seconds writers blocked on a full prefetch queue "
            "(pipeline backpressure)"))
        self.c_units = reg.register(obs.Counter(
            "zipkin_store_pipeline_units_total",
            "Launch units fed through the ingest pipeline"))
        self._stager = threading.Thread(
            target=self._stage_loop, name="zipkin-ingest-stage",
            daemon=True)
        self._committer = threading.Thread(
            target=self._commit_loop, name="zipkin-ingest-commit",
            daemon=True)
        self._stager.start()
        self._committer.start()

    # -- stage 1 tail (caller threads) ----------------------------------

    def feed(self, unit: IngestUnit) -> float:
        """Enqueue one padded unit; blocks when the prefetch queue is
        full (the designed writer backpressure). Returns the seconds
        spent blocked, so stage-1 timing can exclude them."""
        self._check_feedable()
        full = self._prefetch.full()
        t0 = time.perf_counter()
        self._prefetch.put(unit)
        stall = (time.perf_counter() - t0) if full else 0.0
        if stall > 1e-4:
            self.c_stall.inc(stall)
        self.c_units.inc()
        return stall

    # -- stage 2: H2D staging -------------------------------------------

    def _stage_unit(self, unit: IngestUnit) -> IngestUnit:
        dbs = unit_batches(unit)
        if self._h2d is None:
            return unit._replace(staged=dev.stage_batches(dbs, self.device)
                                 + (None,))
        with torch.cuda.stream(self._h2d):
            batches, buf = dev.stage_batches(dbs, self.device)
            done = torch.cuda.Event()
            done.record(self._h2d)
        return unit._replace(staged=(batches, buf, done))

    def _stage_loop(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while True:
            item = self._prefetch.get()
            if item is _STOP:
                self._staged.put(_STOP)
                return
            try:
                t0 = time.perf_counter()
                item = self._stage_unit(item)
                self.h_stage.observe(time.perf_counter() - t0)
            except BaseException as e:  # noqa: BLE001 — parked, re-raised
                self._park_error(e)
                self._mark_done()  # drop this unit; keep flowing
                continue
            self._staged.put(item)

    # -- stage 3: commit ------------------------------------------------

    def _commit_loop(self) -> None:
        if self._cuda_index is None:
            return self._commit_items()
        torch.cuda.set_device(self._cuda_index)
        with torch.cuda.stream(self._commit_stream):
            return self._commit_items()

    def _commit_items(self) -> None:
        store = self._store
        while True:
            item = self._staged.get()
            if item is _STOP:
                return
            try:
                t0 = time.perf_counter()
                store._commit_unit(item)
                self.h_commit.observe(time.perf_counter() - t0)
            except BaseException as e:  # noqa: BLE001 — parked, re-raised
                # The unit's spans are dropped (host clocks untouched),
                # the cost a serial per-batch failure has.
                self._park_error(e)
            finally:
                self._mark_done()

    # -- lifecycle ------------------------------------------------------

    def stop(self) -> None:
        """Drain, stop both workers, unregister the metrics. Never
        raises: callers that care about a parked error read ``.error``
        (``TorchSpanStore.stop_pipeline`` re-raises it)."""
        with self._cond:
            self._closed = True
        self._wait_idle()
        self._prefetch.put(_STOP)
        self._stager.join(timeout=30.0)
        self._committer.join(timeout=30.0)
        self._unregister(self._registry, (
            self.h_encode, self.h_stage, self.h_commit, self.g_depth,
            self.c_stall, self.c_units,
        ))

    def queued(self) -> int:
        return self._prefetch.qsize() + self._staged.qsize()


class EvictionSealer(_StageBase):
    """Background seal stage for eviction capture: the device-to-host
    copy of a pulled window, its decode and seal, and the directory
    append, off the write path. The PULL stays synchronous in
    ``TorchSpanStore._capture_window`` (the captured-before-overwrite
    order); this thread only touches the pull's OUTPUT tensors, which no
    ingest step writes, so it needs no store lock.

    On CUDA the copy runs on a stream of its own: ``submit`` records an
    event on the pulling thread's stream after the pull, the copy
    stream waits on it, and the matrices are ``record_stream``-ed onto
    the copy stream, so the caching allocator cannot hand their memory
    to a later step before the copy has read it."""

    def __init__(self, store, backlog: int = 4, registry=None):
        from zipkin_tpu_torch import obs

        super().__init__()
        self._store = store
        self.backlog = max(1, int(backlog))
        self._q: "queue.Queue" = queue.Queue(maxsize=self.backlog)
        self._d2h = self._cuda_index = None
        device = store.device
        if device.type == "cuda":
            self._cuda_index = (device.index if device.index is not None
                                else torch.cuda.current_device())
            self._d2h = torch.cuda.Stream(self._cuda_index)
        reg = registry or obs.default_registry()
        self._registry = reg
        self.g_backlog = reg.register(obs.Gauge(
            "zipkin_store_capture_backlog",
            "Pulled-but-unsealed eviction capture windows in flight",
            fn=lambda: float(self._q.qsize())))
        self.c_stall = reg.register(obs.Counter(
            "zipkin_store_capture_stall_seconds_total",
            "Seconds the write path blocked on a full capture-seal "
            "backlog (sealer backpressure)"))
        self.c_sealed = reg.register(obs.Counter(
            "zipkin_store_capture_windows_sealed_total",
            "Capture windows sealed into cold segments"))
        self.c_errors = reg.register(obs.Counter(
            "zipkin_store_capture_seal_errors_total",
            "Capture windows whose async seal failed (window lost "
            "from the cold tier; error re-raised on the write path)"))
        self._worker = threading.Thread(
            target=self._loop, name="zipkin-capture-seal", daemon=True)
        self._worker.start()

    def submit(self, n_s: int, n_a: int, n_b: int,
               s_m, a_m, b_m, lo: int, hi: int,
               pull_s: float) -> None:
        """Hand one pulled window (device-resident row matrices) to
        the sealer. Blocks when ``backlog`` windows are in flight —
        the ONLY way capture can stall ingest. Raises a parked error
        from an earlier failed seal (matching the inline path, where a
        sink failure surfaced on the write path that triggered it)."""
        self._check_feedable()
        pulled = None
        if self._d2h is not None:
            pulled = torch.cuda.Event()
            pulled.record()
        full = self._q.full()  # see IngestPipeline.feed: full-at-entry
        t0 = time.perf_counter()
        self._q.put((n_s, n_a, n_b, s_m, a_m, b_m, lo, hi, pull_s,
                     pulled))
        stall = time.perf_counter() - t0
        if full and stall > 1e-4:
            self.c_stall.inc(stall)

    def _loop(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            try:
                self._seal(item)
                self.c_sealed.inc()
            except BaseException as e:  # noqa: BLE001 — parked, re-raised
                # The window is LOST from the cold tier (its rows may
                # already be overwritten in the rings) — counted, and
                # the error fails the next write/barrier ONCE; later
                # windows still seal. The sealed frontier does not
                # advance, so a checkpoint cut never claims the hole.
                self.c_errors.inc()
                self._park_error(e)
            finally:
                self._mark_done()

    def _seal(self, item) -> None:
        from zipkin_tpu_torch.store.torch_store import mats_to_batch
        from zipkin_tpu_torch.testing.crash import kill_point

        n_s, n_a, n_b, s_m, a_m, b_m, lo, hi, pull_s, pulled = item
        t0 = time.perf_counter()
        host = fetch_mats((s_m, a_m, b_m), self._d2h, pulled)
        batch, gids = mats_to_batch(n_s, n_a, n_b, *host)
        sink = self._store.eviction_sink
        if sink is None:
            # Sink detached with windows still in flight: no segment
            # was written, so the frontier must NOT advance — leaving
            # the hole visible keeps a later checkpoint cut from
            # claiming a window the cold tier never got.
            return
        kill_point("mid-seal")
        sink(batch, gids, lo, hi, pull_s + (time.perf_counter() - t0))
        self._store._note_sealed(lo, hi)

    def stop(self) -> None:
        """Seal everything in flight, then stop. Never raises."""
        with self._cond:
            self._closed = True
        self._wait_idle()
        self._q.put(_STOP)
        self._worker.join(timeout=30.0)
        self._unregister(self._registry, (
            self.g_backlog, self.c_stall, self.c_sealed, self.c_errors,
        ))

    def queued(self) -> int:
        return self._q.qsize()

    def at_capacity(self) -> bool:
        """True when the in-flight window queue is full: the next
        capture submit will stall the write path (the watchdog's
        sealer-backlog signal)."""
        return self._q.qsize() >= self.backlog


def fetch_mats(mats, stream=None, after=None):
    """The pulled matrices as numpy arrays. With a CUDA ``stream`` the
    copy runs there, after the event ``after`` (recorded behind the
    pull), each matrix ``record_stream``-ed onto it first; without one
    (inline sealing, or CPU tensors) on the current stream."""
    if stream is None:
        return [m.detach().cpu().numpy() for m in mats]
    with torch.cuda.stream(stream):
        stream.wait_event(after)
        for m in mats:
            m.record_stream(stream)
        return [m.cpu().numpy() for m in mats]
