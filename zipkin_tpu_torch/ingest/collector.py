"""Collector: receiver → bounded queue → sampler filter → store(s).

Reference wiring (ZipkinCollectorFactory.scala:40-76): the receiver
pushes span batches into the ItemQueue; worker threads run the filter
chain (sampling: keep iff debug or the rate test passes,
SpanSamplerFilter.scala:40-47) and hand survivors to the WriteSpanStore.
The adaptive controller reads the flow from the store counters and
moves the sampler's rate (AdaptiveSampler wiring, SURVEY.md §3.5).

Stats live in the telemetry registry (zipkin_tpu_torch.obs): the old
``_stats_lock`` dict is gone — every counter bump is an obs.Counter
increment (one lock per bump, none lost under concurrent queue
workers, including the failure paths), and each processed batch feeds
the batch-size and write-latency sketches. With ``self_trace=True``
the collector also records one genuine Zipkin span per ingest step
under the ``zipkin-tpu`` service name, written STRAIGHT to the store
(bypassing queue + sampler, so the tracer can never feed back into the
stream it measures)."""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from zipkin_tpu_torch import obs
from zipkin_tpu_torch.ingest.queue import ItemQueue
from zipkin_tpu_torch.models.span import Span
from zipkin_tpu_torch.sampler.adaptive import (
    AdaptiveConfig,
    AdaptiveSampleRateController,
    FlowEstimator,
)
from zipkin_tpu_torch.sampler.core import Sampler
from zipkin_tpu_torch.store.base import WriteSpanStore


class _ThriftPayload:
    """Queue item marking raw thrift bytes for the columnar fast path.

    ``segments`` keeps transport-level message boundaries (one scribe
    LogEntry / kafka message each) so a corrupt segment can be isolated
    instead of poisoning the whole batch."""

    __slots__ = ("segments",)

    def __init__(self, segments: Sequence[bytes]):
        self.segments = list(segments)


class Collector:
    def __init__(
        self,
        store: WriteSpanStore,
        sampler: Optional[Sampler] = None,
        adaptive: Optional[AdaptiveConfig] = None,
        max_queue: int = 500,
        concurrency: int = 10,
        registry: Optional[obs.Registry] = None,
        self_trace: bool = False,
        self_service_name: str = "zipkin-tpu",
        pipeline_depth: int = 0,
    ):
        self.store = store
        # Pipelined ingest (store/pipeline): queue workers become the
        # pipeline's stage-1 producers (encode + pad outside the device
        # critical section) and the store's commit thread feeds the
        # accelerator. flush()/close() drain it so "flushed" keeps
        # meaning "visible to reads".
        if pipeline_depth:
            start = getattr(store, "start_pipeline", None)
            if start is None:
                raise ValueError(
                    "pipeline_depth requires a store with pipelined "
                    "ingest (TorchSpanStore / TieredSpanStore)"
                )
            start(pipeline_depth)
        self.sampler = sampler or Sampler(1.0)
        reg = registry or obs.default_registry()
        self.queue: ItemQueue = ItemQueue(
            self._write, max_size=max_queue, concurrency=concurrency,
            registry=reg,
        )
        self.controller = (
            AdaptiveSampleRateController(adaptive) if adaptive else None
        )
        self._flow = FlowEstimator()
        self._last_tick_s: Optional[float] = None
        self._c_stored = reg.register(obs.Counter(
            "zipkin_collector_spans_stored_total",
            "Spans written to the store after the sampler filter"))
        self._c_dropped = reg.register(obs.Counter(
            "zipkin_collector_spans_dropped_total",
            "Spans dropped by the sampler"))
        self._c_bad = reg.register(obs.Counter(
            "zipkin_collector_bad_payloads_total",
            "Transport segments that failed thrift decode"))
        self._h_batch = reg.register(obs.LatencySketch(
            "zipkin_collector_batch_spans",
            "Spans per processed collector batch (size distribution)",
            min_value=1.0))
        self._h_write = reg.register(obs.LatencySketch(
            "zipkin_collector_write_seconds",
            "Collector batch processing latency: decode + sample + "
            "store write, per queue item"))
        # Sampler-stage metrics ride the collector's registration (the
        # sampler already locks its own counts; these adapt them).
        reg.register(obs.Gauge(
            "zipkin_sampler_rate", "Current sample rate [0, 1]",
            fn=lambda: self.sampler.rate))
        reg.register(obs.Counter(
            "zipkin_sampler_allowed_total",
            "Trace-id sampler decisions that kept the span",
            fn=lambda: self.sampler.snapshot()[0]))
        reg.register(obs.Counter(
            "zipkin_sampler_denied_total",
            "Trace-id sampler decisions that dropped the span",
            fn=lambda: self.sampler.snapshot()[1]))
        # Ingest-step self-tracing (SURVEY §5): transport writes DIRECT
        # to the store — never through accept()/the queue — so a
        # self-trace span can't generate another self-trace span.
        # Spans buffer and flush in batches: a device store pays a full
        # padded ingest launch per apply(), so one launch PER PROCESSED
        # ITEM would double ingest dispatches and pollute the store's
        # own launch metrics with 1-span steps.
        self.tracer = None
        self._self_buf = []  # guarded-by: _self_lock
        self._self_lock = threading.Lock()  # lock-order: 79 self-trace
        # Self-trace batches dropped because the store write failed —
        # self-tracing must never fail ingest, but a silent drop hid
        # every such failure (graftlint swallowed-exception).
        self._c_self_drops = reg.register(obs.Counter(
            "zipkin_collector_self_trace_drops_total",
            "Self-trace span batches dropped by a failed store write"))
        if self_trace:
            from zipkin_tpu_torch.client import Tracer

            self.tracer = Tracer(self_service_name, self._self_transport)
        # The fast path needs both the native parser and a store that
        # accepts raw thrift (TorchSpanStore.write_thrift); probed once.
        self._fast_ok: Optional[bool] = None

    # -- registry-backed stats (read by /metrics json + the controller) -

    @property
    def spans_stored(self) -> int:
        return int(self._c_stored.value)

    @property
    def spans_dropped(self) -> int:
        return int(self._c_dropped.value)

    @property
    def bad_payloads(self) -> int:
        return int(self._c_bad.value)

    # -- pipeline -------------------------------------------------------

    def accept(self, spans: Sequence[Span]) -> None:
        """Receiver-facing entry; raises QueueFullException when full."""
        self.queue.add(list(spans))

    def accept_thrift(self, payload) -> None:
        """Raw thrift Span-sequence entry (scribe/kafka fast path): the
        payload — one bytes blob or a sequence of per-message segments —
        decodes on a worker via the native columnar parser when
        available (ScribeSpanReceiver.scala:96-107's scrooge hot decode),
        falling back to the python codec. Sampling is applied either
        way. Raises QueueFullException when full."""
        segments = [payload] if isinstance(payload, (bytes, bytearray)) \
            else list(payload)
        self.queue.add(_ThriftPayload(segments))

    # -- durable (ack-after-append) entries -----------------------------
    #
    # With a write-ahead log attached to the store, a receiver that
    # promises durability on ack (scribe returning OK, a kafka client
    # committing offsets after ``process`` returns) must not ack from
    # the async queue — an accepted-but-unprocessed batch would be
    # acked yet absent from the log at a crash. These entries run the
    # same decode + sample + store path SYNCHRONOUSLY on the calling
    # thread (the store's write path journals before committing) and
    # then block on the WAL's durable frontier: under the group-commit
    # fsync policy, concurrent ackers share one fsync per commit
    # window. Wire them as the receiver's ``process``/
    # ``process_thrift`` callables (main/example.py does when
    # --wal-dir is set); see docs/DURABILITY.md.

    def ingest_durable(self, spans: Sequence[Span]) -> int:
        """Synchronous span ingest + durable-append barrier; returns
        the stored count. Drop-in ``process`` target for receivers."""
        stored = self._write_spans(list(spans))
        self._wal_barrier()
        return stored

    def ingest_thrift_durable(self, payload) -> int:
        """Synchronous raw-thrift ingest + durable-append barrier;
        drop-in ``process_thrift`` target for receivers."""
        segments = [payload] if isinstance(payload, (bytes, bytearray)) \
            else list(payload)
        stored = self._write_thrift(segments)
        self._wal_barrier()
        return stored

    def _wal_barrier(self) -> None:
        """Block until every record appended so far is fsynced (the
        group-commit ack barrier). No-op without a WAL. Raises
        WalDurabilityError when the frontier cannot be covered (fsync
        failing, or the wait timed out) — the caller must NOT ack;
        receivers map it to scribe TRY_LATER."""
        wal = getattr(self.store, "wal", None)
        if wal is not None:
            from zipkin_tpu_torch.wal.log import WalDurabilityError

            if not wal.wait_durable(wal.last_seq):
                raise WalDurabilityError(
                    "timed out waiting for the WAL durable frontier; "
                    "refusing to ack")

    def _fast_path_available(self) -> bool:
        if self._fast_ok is None:
            if getattr(self.store, "write_thrift", None) is None:
                self._fast_ok = False
            else:
                from zipkin_tpu_torch import native

                self._fast_ok = native.available()
        return self._fast_ok

    # Self spans per store write: amortizes the device store's
    # per-launch dispatch floor over many ingest-step spans.
    SELF_TRACE_FLUSH = 64

    def _self_transport(self, spans) -> None:
        with self._self_lock:
            self._self_buf.extend(spans)
            if len(self._self_buf) < self.SELF_TRACE_FLUSH:
                return
            batch, self._self_buf = self._self_buf, []
        try:
            self.store.apply(batch)
        except Exception:
            # Counted, never raised: self-tracing must not fail the
            # ingest step it annotates.
            self._c_self_drops.inc()

    def _flush_self_spans(self) -> None:
        with self._self_lock:
            batch, self._self_buf = self._self_buf, []
        if batch:
            try:
                self.store.apply(batch)
            except Exception:
                self._c_self_drops.inc()  # see _self_transport

    def _write(self, item) -> None:
        """Queue worker entry: time the step, process, self-trace."""
        t0 = time.perf_counter()
        stored = 0
        try:
            if isinstance(item, _ThriftPayload):
                stored = self._write_thrift(item.segments)
            else:
                stored = self._write_spans(item)
        finally:
            dt = time.perf_counter() - t0
            self._h_write.observe(dt)
            if self.tracer is not None:
                self._emit_self_span(dt, stored)

    def _emit_self_span(self, dt_s: float, stored: int) -> None:
        from zipkin_tpu_torch.client import B3Headers

        end_us = int(time.time() * 1e6)
        resolved = self.tracer.resolve(B3Headers())
        self.tracer.server_span(
            "collector ingest", resolved,
            start_us=end_us - max(int(dt_s * 1e6), 1), end_us=end_us,
            tags={"ingest.stored": str(stored)},
        )

    def _write_spans(self, spans) -> int:
        """Sample + store one span batch; returns the stored count."""
        kept = [s for s in spans if s.debug or self.sampler.decide(s.trace_id)]
        # One locked counter update per batch (debug spans bypass the
        # sampler and are not counted, matching the fast path).
        n_debug = sum(1 for s in kept if s.debug)
        self.sampler.count(len(kept) - n_debug, len(spans) - len(kept))
        self._h_batch.observe(len(spans))
        self._c_dropped.inc(len(spans) - len(kept))
        if kept:
            self.store.apply(kept)
            self._c_stored.inc(len(kept))
        return len(kept)

    def _write_thrift(self, segments) -> int:
        """Fast-path write; returns the stored count (summed across
        split-and-retry recursion)."""
        if not self._fast_path_available():
            return self._decode_segments_slow(segments)
        from zipkin_tpu_torch.native import ParseCapacityError

        try:
            written, dropped, written_debug = self.store.write_thrift(
                b"".join(segments), sample_threshold=self.sampler.threshold
            )
        except ParseCapacityError:
            # Valid but oversized: halve and retry (single segments that
            # still don't fit go through the chunking python path).
            if len(segments) > 1:
                mid = len(segments) // 2
                return (self._write_thrift(segments[:mid])
                        + self._write_thrift(segments[mid:]))
            return self._decode_segments_slow(segments)
        except ValueError:
            # A corrupt segment poisons the concatenated parse; isolate
            # it by decoding per segment (slow-path semantics: skip bad,
            # keep good — ScribeReceiver's per-entry 'bad' accounting).
            return self._decode_segments_slow(segments)
        # Slow-path counter parity: debug spans never hit the sampler.
        self.sampler.count(written - written_debug, dropped)
        self._h_batch.observe(max(written + dropped, 1))
        self._c_stored.inc(written)
        self._c_dropped.inc(dropped)
        return written

    def _decode_segments_slow(self, segments) -> int:
        from zipkin_tpu_torch.wire.thrift import ThriftError, spans_from_bytes

        spans = []
        for seg in segments:
            try:
                spans.extend(spans_from_bytes(seg))
            except ThriftError:
                self._c_bad.inc()
        if spans:
            return self._write_spans(spans)
        return 0

    # -- control loop (call periodically, e.g. every 30s) ---------------

    def control_tick(self, now_s: Optional[float] = None) -> Optional[float]:
        """Feed the store rate into the adaptive controller; returns the
        new sample rate when it moves. Single-controller: this replaces
        the ZK group + leader election (AdaptiveSampler.scala:177-237).

        Safe to call at any cadence — observations are gated to the
        controller's update_freq_s so a tight daemon loop doesn't shrink
        the adaptive windows.
        """
        if self.controller is None:
            return None
        now_s = time.time() if now_s is None else now_s
        freq = self.controller.config.update_freq_s
        if self._last_tick_s is not None and now_s - self._last_tick_s < freq:
            return None
        self._last_tick_s = now_s
        # Flow source: the store's own counters (the device spans_seen
        # scalar on the device store; a psum-ed shard summary when sharded)
        # — BASELINE's "sampler reads its counts directly from the
        # on-device sketches". Host accounting is only the fallback for
        # stores without counters.
        stored = self.store.stored_span_count()
        if stored is None:
            stored = float(self.spans_stored)
        rate = self._flow.observe(stored, now_s)
        if rate is None:
            return None
        new_rate = self.controller.observe(rate, now_s)
        if new_rate is not None:
            self.sampler.rate = new_rate
        return new_rate

    def _drain_store_pipeline(self) -> None:
        drain = getattr(self.store, "drain_pipeline", None)
        if drain is not None:
            drain()

    def _drain_query_engines(self) -> None:
        """Quiesce the resident query executors registered on the
        store (query/engine.py): wait until no coalesced query launch
        is in flight, so the drain→seal→fsync→checkpoint sequence
        below never interleaves with a standing executor's dispatch."""
        for engine in getattr(self.store, "query_engines",
                              lambda: ())():
            engine.drain()

    def _quiesce_store(self) -> None:
        """Durability-ordered drain of the store's async machinery:
        drain-queries → drain-pipeline → seal-barrier → WAL-fsync
        (docs/DURABILITY.md shutdown ordering — each step's output is
        the next step's input: committed units may pull capture
        windows, sealed windows advance the frontier a checkpoint cuts
        at, and the fsync makes every journaled record durable before
        any checkpoint claims to cover it)."""
        self._drain_query_engines()
        self._drain_store_pipeline()
        barrier = getattr(self.store, "seal_barrier", None)
        if barrier is not None:
            barrier()
        sync = getattr(self.store, "wal_sync", None)
        if sync is not None:
            sync()

    def flush(self) -> None:
        """Drain everything accepted so far: queue workers, buffered
        self-trace spans, the ingest pipeline, pending capture seals,
        and the WAL (fsync) — after this, 'flushed' means visible to
        reads AND durable in the log."""
        self.queue.join()
        self._flush_self_spans()
        self._quiesce_store()

    def close(self) -> None:
        self.queue.close()
        self._flush_self_spans()
        self._quiesce_store()
        # Stop the resident query executors for good BEFORE the store
        # tears down its own async machinery — a standing executor
        # thread must not launch against a closing store. Queries
        # after this still answer (inline, uncoalesced).
        for engine in getattr(self.store, "query_engines",
                              lambda: ())():
            engine.close()
        # store.close() stops the ingest pipeline (draining accepted
        # batches) and the capture sealer before returning.
        self.store.close()
