"""Fleet observability, torch side: causal self-tracing of the write
path, metrics federation, and a stall watchdog.

The port's copy of ``zipkin_tpu/obs/fleet.py``; only the imports
change. Everything here is host Python: no piece launches a kernel of
its own. The lineage spans reach the card the way any other span does,
through ``store.apply`` (one ingest step each flush: the flat histogram
once, both arena halves once).

**Lineage tracing** (``LineageTracker``, primary side). With a tracker
attached (``TorchSpanStore.attach_lineage``), every launch unit's WAL
record is stamped with its commit timestamp (``ts``), and a sampled
subset (1 in ``SAMPLE_EVERY``, the first always) additionally carries a
B3 context (``b3``) minted at stage-1 encode. The tracker then emits
genuine Zipkin spans into the system's own store as the unit moves
through the write path: an ``ingest unit`` root plus ``wal append`` /
``wal fsync`` children, a ``ship`` child per follower a shipper sends
the record to, and the ``replica apply`` / ``standby apply`` children a
follower mints and backhauls. One sampled unit is one trace, queryable
through ``/api/traces`` like any other.

**Follower half** (``FollowerLineage``). Reads the lineage keys off
each shipped record (``wal.record.unit_meta``), derives the
commit-to-visible lag (``zipkin_replication_visible_lag_seconds`` + a
``lagSeconds`` gauge), buffers apply spans for the next fetch, and
throttles registry-snapshot pushes to the primary.

**Metrics federation** (``registry_snapshot`` / ``render_federated``).
Followers push registry snapshots; the primary serves a merged
``/metrics?fleet=1`` — every sample from every process, distinguished
by injected ``role``/``follower`` labels (never summed), values
formatted through the same ``_fmt`` as the per-process scrape, one
HELP/TYPE line per family. Latency sketches also ship their raw bucket
counts + Moments, so fleet roll-ups are a true monoid merge
(``merge_sketches``).

**Watchdog + flight recorder** (``Watchdog``, ``FlightRecorder``).
Named probes over the async machinery (pipeline commit stall, parked
fsync, sealer backlog at cap, dispatcher queue stuck, follower lag past
threshold) evaluated on demand — probes run OUTSIDE the watchdog's own
lock, because they acquire component locks of every rank.
``/api/health`` serves liveness/readiness with reasons; state
*transitions* land in a bounded in-memory event ring served at
``/debug/events``.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import random
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from zipkin_tpu_torch.models.dependencies import Moments
from zipkin_tpu_torch.models.span import (
    Annotation,
    BinaryAnnotation,
    Endpoint,
    Span,
)
from zipkin_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    LatencySketch,
    Registry,
    _fmt,
    _label_str,
    escape_help,
)

# ---------------------------------------------------------------------------
# request-context propagation (API handler → dispatcher / downstream)
# ---------------------------------------------------------------------------

# (trace_id, span_id) of the request currently being served on this
# task — set by the API server around traced handlers so downstream
# machinery (the cross-shard dispatcher) can parent its spans.
_REQUEST_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "zipkin_tpu_fleet_b3", default=None)


def set_request_context(trace_id: int, span_id: int):
    """Bind the active request's B3 context; returns the reset token."""
    return _REQUEST_CTX.set((int(trace_id), int(span_id)))


def reset_request_context(token) -> None:
    _REQUEST_CTX.reset(token)


def current_request_context() -> Optional[Tuple[int, int]]:
    return _REQUEST_CTX.get()


# ---------------------------------------------------------------------------
# wire span codec (backhauled follower spans / dispatcher spans)
# ---------------------------------------------------------------------------

def make_span(trace_id: int, span_id: int, parent_id: Optional[int],
              name: str, service: str, start_us: int, duration_us: int,
              tags: Optional[Dict[str, str]] = None) -> Span:
    """A genuine server-side Zipkin span (sr/ss pair) for a fleet
    self-trace event."""
    ep = Endpoint(0, 0, service)
    return Span(
        int(trace_id), name, int(span_id),
        None if parent_id is None else int(parent_id),
        (Annotation(int(start_us), "sr", ep),
         Annotation(int(start_us) + max(int(duration_us), 1), "ss", ep)),
        tuple(BinaryAnnotation(k, str(v), host=ep)
              for k, v in sorted((tags or {}).items())),
    )


def span_to_wire(trace_id: int, span_id: int, parent_id: Optional[int],
                 name: str, service: str, start_us: int, duration_us: int,
                 tags: Optional[Dict[str, str]] = None) -> dict:
    """Compact JSON form for FETCH-meta backhaul (ints stay ints —
    json round-trips 64-bit span ids exactly)."""
    return {"traceId": int(trace_id), "id": int(span_id),
            "parentId": None if parent_id is None else int(parent_id),
            "name": name, "service": service, "ts": int(start_us),
            "dur": int(duration_us), "tags": dict(tags or {})}


def span_from_wire(d: dict) -> Span:
    """Inverse of ``span_to_wire`` (primary side). Raises on a
    malformed dict — callers isolate per span."""
    return make_span(d["traceId"], d["id"], d.get("parentId"),
                     str(d.get("name", "span")),
                     str(d.get("service", "zipkin-tpu")),
                     d["ts"], d.get("dur", 1), d.get("tags"))


def _new_id(rng: random.Random) -> int:
    return rng.getrandbits(63) + 1


# ---------------------------------------------------------------------------
# lineage tracing — primary side
# ---------------------------------------------------------------------------

class _UnitCtx:
    """Pending lineage state for one sampled launch unit."""

    __slots__ = ("trace_id", "root_id", "start_us", "append_us",
                 "durable_us")

    def __init__(self, trace_id: int, root_id: int, start_us: int):
        self.trace_id = trace_id
        self.root_id = root_id
        self.start_us = start_us
        self.append_us = start_us
        self.durable_us: Optional[int] = None


class LineageTracker:
    """Primary-side lineage tracer: stamps WAL records, emits the
    per-stage spans, ingests backhauled follower spans.

    ``sink`` is the span write target — ``store.apply`` in production
    (spans land in the system's own store, ride the WAL, and therefore
    replicate to standbys bitwise like any other span).

    Threading: ``stamp``/``note_append`` run on the encoding thread
    UNDER the store's encode lock, so they only ever buffer;
    ``on_durable`` runs on the WAL's group-commit thread (no locks
    held) — or, under ``fsync=off``/``batch``, synchronously inside
    ``wal.append`` while the encode lock is still held, which is why
    the store wraps the append in ``suppressed()``: the port's encode
    lock is re-entrant, so a flush there would not block but journal a
    nested launch group between this group's append and its dictionary
    high-water update, breaking the delta chain replay depends on.
    Flushes happen from ``on_durable``
    (sync thread), ``note_shipped`` (ship handler thread), and
    ``flush()`` — all outside the store's write path. The sink call
    itself sets a thread-local ``emitting`` flag so the spans' own
    journaling is never sampled (no feedback trace)."""

    SAMPLE_EVERY = 64   # first unit always sampled
    FLUSH_AT = 32       # buffered spans per sink call (launch amortization)
    MAX_PENDING = 4096  # sampled units awaiting fsync/ship

    def __init__(self, sink: Callable[[List[Span]], None],
                 registry: Optional[Registry] = None,
                 service_name: str = "zipkin-tpu",
                 sample_every: Optional[int] = None,
                 clock: Callable[[], float] = time.time):
        self.sink = sink
        self.service_name = service_name
        self.sample_every = max(int(sample_every or self.SAMPLE_EVERY), 1)
        self._clock = clock
        self._lock = threading.Lock()  # lock-order: 82 fleet-trace
        self._tl = threading.local()
        self._rng = random.Random()          # guarded-by: _lock
        self._units = 0                      # guarded-by: _lock
        self._pending = collections.OrderedDict()  # guarded-by: _lock
        self._buf: List[Span] = []           # guarded-by: _lock
        reg = registry
        self._h_stage = None
        self._c_units = None
        self._c_drops = None
        if reg is not None:
            self._h_stage = reg.register(LatencySketch(
                "zipkin_lineage_stage_seconds",
                "Per-stage latency of sampled launch units "
                "(commit-to-visible decomposition)",
                labelnames=("stage",)))
            self._c_units = reg.register(Counter(
                "zipkin_lineage_units_total",
                "Launch units stamped with a sampled lineage context"))
            self._c_drops = reg.register(Counter(
                "zipkin_lineage_spans_dropped_total",
                "Lineage spans dropped (failed sink write or pending-"
                "table overflow)"))

    # -- stage-1 stamping (encode thread, under the store's encode lock)

    def stamp(self) -> Dict[str, object]:
        """Extra WAL-record meta for the unit being journaled: always
        the commit timestamp, plus a fresh B3 context for sampled
        units. Never samples the tracker's own span batches (the
        ``emitting`` flag breaks the feedback loop)."""
        now_us = int(self._clock() * 1e6)
        extra: Dict[str, object] = {"ts": now_us}
        if getattr(self._tl, "emitting", False):
            return extra
        with self._lock:
            n = self._units
            self._units += 1
            if n % self.sample_every:
                return extra
            tid = _new_id(self._rng)
            sid = _new_id(self._rng)
        extra["b3"] = [tid, sid]
        return extra

    def note_append(self, seq: int, extra: Dict[str, object]) -> None:
        """Record the appended unit's context + emit (buffer) the root
        and append spans. Called under the store's encode lock —
        buffers only, never flushes."""
        b3 = extra.get("b3") if extra else None
        if not b3:
            return
        now_us = int(self._clock() * 1e6)
        start_us = int(extra["ts"])
        ctx = _UnitCtx(int(b3[0]), int(b3[1]), start_us)
        ctx.append_us = now_us
        dropped = None
        with self._lock:
            self._pending[int(seq)] = ctx
            if len(self._pending) > self.MAX_PENDING:
                dropped = self._pending.popitem(last=False)
            append_id = _new_id(self._rng)
        if self._c_units is not None:
            self._c_units.inc()
        if dropped is not None and self._c_drops is not None:
            self._c_drops.inc()
        dur = max(now_us - start_us, 1)
        self._observe("append", dur)
        self._push([
            make_span(ctx.trace_id, ctx.root_id, None, "ingest unit",
                      self.service_name, start_us, dur,
                      {"wal.seq": str(seq)}),
            make_span(ctx.trace_id, append_id, ctx.root_id, "wal append",
                      self.service_name, start_us, dur,
                      {"wal.seq": str(seq)}),
        ], flush=False)

    @contextlib.contextmanager
    def suppressed(self):
        """No-flush guard for callbacks fired synchronously inside the
        store's write path (``fsync=off``/``batch`` appends invoke
        ``on_durable`` on the appending thread)."""
        prev = getattr(self._tl, "suppress", False)
        self._tl.suppress = True
        try:
            yield
        finally:
            self._tl.suppress = prev

    # -- downstream stages ----------------------------------------------

    def on_durable(self, durable_seq: int) -> None:
        """WAL durable-frontier callback: emit ``wal fsync`` children
        for every pending unit now covered. Runs on the group-commit
        thread (flushes) or inside an append under ``suppressed()``
        (buffers only)."""
        now_us = int(self._clock() * 1e6)
        spans: List[Span] = []
        with self._lock:
            for seq, ctx in self._pending.items():
                if seq > durable_seq or ctx.durable_us is not None:
                    continue
                ctx.durable_us = now_us
                spans.append((ctx, _new_id(self._rng), seq))
        for ctx, sid, seq in spans:
            dur = max(now_us - ctx.append_us, 1)
            self._observe("fsync", dur)
            self._push([make_span(
                ctx.trace_id, sid, ctx.root_id, "wal fsync",
                self.service_name, ctx.append_us, dur,
                {"wal.seq": str(seq)})], flush=False)
        if spans:
            self._maybe_flush()

    def ctx_for(self, seq: int) -> Optional[Tuple[int, int]]:
        """(trace_id, root_span_id) of a sampled record, for shippers."""
        with self._lock:
            ctx = self._pending.get(int(seq))
            return None if ctx is None else (ctx.trace_id, ctx.root_id)

    def note_shipped(self, seq: int, follower: str) -> None:
        """Emit the ``ship`` child for one sampled record sent to one
        follower (ship handler thread)."""
        now_us = int(self._clock() * 1e6)
        with self._lock:
            ctx = self._pending.get(int(seq))
            if ctx is None:
                return
            sid = _new_id(self._rng)
        from_us = ctx.durable_us or ctx.append_us
        dur = max(now_us - from_us, 1)
        self._observe("ship", dur)
        self._push([make_span(
            ctx.trace_id, sid, ctx.root_id, "ship",
            self.service_name, from_us, dur,
            {"wal.seq": str(seq), "follower": follower})])

    def ingest_remote_spans(self, follower: str,
                            wire_spans: Sequence[dict]) -> int:
        """Backhauled follower spans (FETCH meta) → the primary store.
        Malformed entries are dropped and counted, never raised."""
        spans: List[Span] = []
        for d in wire_spans:
            try:
                spans.append(span_from_wire(d))
                if d.get("name", "").endswith("apply"):
                    self._observe("apply", int(d.get("dur", 1)))
            except Exception:  # graftlint: disable=swallowed-exception
                if self._c_drops is not None:
                    self._c_drops.inc()
        if spans:
            self._push(spans)
        return len(spans)

    def record_span(self, trace_id: int, parent_id: Optional[int],
                    name: str, start_us: int, duration_us: int,
                    tags: Optional[Dict[str, str]] = None) -> int:
        """Generic child-span hook (the dispatcher's ``shard dispatch``
        spans); returns the new span id."""
        with self._lock:
            sid = _new_id(self._rng)
        self._push([make_span(trace_id, sid, parent_id, name,
                              self.service_name, start_us, duration_us,
                              tags)])
        return sid

    # -- buffering / emission -------------------------------------------

    def _observe(self, stage: str, dur_us: float) -> None:
        if self._h_stage is not None:
            self._h_stage.labels(stage=stage).observe(
                max(dur_us, 1) / 1e6)

    def _push(self, spans: List[Span], flush: bool = True) -> None:
        with self._lock:
            self._buf.extend(spans)
        if flush:
            self._maybe_flush()

    def _maybe_flush(self, force: bool = False) -> None:
        if getattr(self._tl, "suppress", False):
            return
        with self._lock:
            if not self._buf or (not force
                                 and len(self._buf) < self.FLUSH_AT):
                return
            batch, self._buf = self._buf, []
        self._tl.emitting = True
        try:
            self.sink(batch)
        except Exception:  # graftlint: disable=swallowed-exception
            # Self-tracing must never fail the pipeline it observes.
            if self._c_drops is not None:
                self._c_drops.inc(len(batch))
        finally:
            self._tl.emitting = False

    def flush(self) -> None:
        self._maybe_flush(force=True)

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)


# ---------------------------------------------------------------------------
# lineage — follower side
# ---------------------------------------------------------------------------

class FollowerLineage:
    """Follower half of the lineage trace: reads the stamped keys off
    each shipped record, derives visible lag, buffers apply spans for
    backhaul, and throttles registry-snapshot pushes."""

    MAX_BACKLOG = 512          # buffered apply spans awaiting a FETCH
    METRICS_PUSH_INTERVAL_S = 1.0

    def __init__(self, name: str, mode: str = "replica",
                 registry: Optional[Registry] = None,
                 service_name: Optional[str] = None,
                 clock: Callable[[], float] = time.time):
        self.name = name
        self.mode = mode
        self.service_name = service_name or f"zipkin-tpu-{name}"
        self.registry = registry
        self._clock = clock
        self._lock = threading.Lock()  # lock-order: 81 follower-lineage
        self._rng = random.Random()    # guarded-by: _lock
        self._spans: List[dict] = []   # guarded-by: _lock
        self._lag_s: Optional[float] = None  # guarded-by: _lock
        self._last_push_s: Optional[float] = None  # guarded-by: _lock
        self._h_lag = None
        self._c_drops = None
        if registry is not None:
            self._h_lag = registry.register(LatencySketch(
                "zipkin_replication_visible_lag_seconds",
                "Primary-commit to visible-on-this-follower latency, "
                "per applied record"))
            registry.register(Gauge(
                "zipkin_replication_lag_seconds",
                "Last observed commit-to-visible lag on this follower",
                fn=self.lag_seconds_or_zero))
            self._c_drops = registry.register(Counter(
                "zipkin_lineage_spans_dropped_total",
                "Apply spans dropped by the bounded backhaul buffer"))

    def observe_record(self, seq: int, payload: bytes,
                       apply_s: float) -> None:
        """Called once per applied record with the apply duration.
        Parses the record meta header only; records without lineage
        keys (unstamped logs) are a no-op."""
        from zipkin_tpu_torch.wal.record import unit_meta

        try:
            meta = unit_meta(payload)
        except Exception:  # graftlint: disable=swallowed-exception
            return  # the record already applied; meta is advisory
        now_us = int(self._clock() * 1e6)
        ts = meta.get("ts")
        if ts is not None:
            lag = max((now_us - int(ts)) / 1e6, 0.0)
            with self._lock:
                self._lag_s = lag
            if self._h_lag is not None:
                self._h_lag.observe(lag)
        b3 = meta.get("b3")
        if not b3:
            return
        dur_us = max(int(apply_s * 1e6), 1)
        with self._lock:
            sid = _new_id(self._rng)
            if len(self._spans) >= self.MAX_BACKLOG:
                self._spans.pop(0)
                if self._c_drops is not None:
                    self._c_drops.inc()
            self._spans.append(span_to_wire(
                int(b3[0]), sid, int(b3[1]), f"{self.mode} apply",
                self.service_name, now_us - dur_us, dur_us,
                {"wal.seq": str(seq), "follower": self.name}))

    def take_spans(self) -> List[dict]:
        """Drain the apply-span backlog for the next FETCH meta."""
        with self._lock:
            out, self._spans = self._spans, []
        return out

    def lag_seconds(self) -> Optional[float]:
        with self._lock:
            return self._lag_s

    def lag_seconds_or_zero(self) -> float:
        lag = self.lag_seconds()
        return 0.0 if lag is None else lag

    def maybe_metrics_snapshot(self) -> Optional[dict]:
        """A registry snapshot for FETCH meta, throttled to one per
        METRICS_PUSH_INTERVAL_S (None between pushes)."""
        if self.registry is None:
            return None
        now_s = self._clock()
        with self._lock:
            if (self._last_push_s is not None
                    and now_s - self._last_push_s
                    < self.METRICS_PUSH_INTERVAL_S):
                return None
            self._last_push_s = now_s
        return registry_snapshot(self.registry)


# ---------------------------------------------------------------------------
# metrics federation
# ---------------------------------------------------------------------------

def _sketch_state(sk: LatencySketch) -> dict:
    """Raw monoid state of one (child) sketch: sparse bucket counts +
    Moments + sum, with the layout needed to reconstruct and merge."""
    with sk._lock:
        counts = sk.counts.copy()
        m = sk.moments
        s = sk._sum
    nz = np.flatnonzero(counts)
    return {"alpha": sk.alpha, "min_value": sk.min_value,
            "n_buckets": int(len(counts)),
            "quantiles": list(sk.quantiles),
            "counts": [[int(i), int(counts[i])] for i in nz],
            "moments": [m.n, m.mean, m.m2, m.m3, m.m4], "sum": s}


def _sketch_states(sk: LatencySketch) -> dict:
    """State of a sketch metric incl. labeled children."""
    if sk.labelnames:
        return {"labelnames": list(sk.labelnames),
                "children": [
                    {"labels": [[k, v] for k, v in labels],
                     "state": _sketch_state(child)}
                    for labels, child in sk._child_items()
                ]}
    return {"labelnames": [], "state": _sketch_state(sk)}


def sketch_from_state(name: str, help_: str, state: dict) -> LatencySketch:
    """Reconstruct a mergeable sketch from its transported state."""
    sk = LatencySketch(name, help_, alpha=state["alpha"],
                       n_buckets=state["n_buckets"],
                       min_value=state["min_value"],
                       quantiles=tuple(state.get("quantiles")
                                       or (0.5, 0.99)))
    for i, c in state["counts"]:
        sk.counts[int(i)] = int(c)
    sk.moments = Moments(*state["moments"])
    sk._sum = float(state["sum"])
    return sk


def merge_sketches(name: str, help_: str,
                   states: Iterable[dict]) -> Optional[LatencySketch]:
    """Fold transported sketch states into one fleet-wide sketch (the
    monoid merge — bucket counts add, Moments combine). Layout
    mismatches raise, like ``LatencySketch.merge``."""
    merged: Optional[LatencySketch] = None
    for state in states:
        sk = sketch_from_state(name, help_, state)
        if merged is None:
            merged = sk
        else:
            merged.merge(sk)
    return merged


def registry_snapshot(registry: Registry) -> dict:
    """JSON-able snapshot of every metric's samples (plus raw sketch
    state for summaries). Values transport as floats — python json
    round-trips them exactly, so a federated render of this snapshot
    is bitwise-identical to the process's own scrape."""
    metrics = []
    for m in registry.collect():
        entry: Dict[str, object] = {
            "name": m.name, "type": m.prom_type, "help": m.help,
            "samples": [
                [suffix, [[k, v] for k, v in labels], float(value)]
                for suffix, labels, value in m.samples()
            ],
        }
        if isinstance(m, LatencySketch):
            entry["sketch"] = _sketch_states(m)
        metrics.append(entry)
    return {"v": 1, "metrics": metrics}


def render_federated(
        sources: Sequence[Tuple[Sequence[Tuple[str, str]], dict]]) -> str:
    """Merged Prometheus text over ``(extra_labels, snapshot)``
    sources. One HELP/TYPE pair per family (first source's wins);
    every sample line carries its source's injected labels prepended
    (``role``/``follower``), so identically-named samples from
    different processes stay distinct — label-distinguished, never
    summed, no double counting. Sample values go through the same
    ``_fmt`` as ``Registry.render_text`` → bitwise-consistent with
    each process's own scrape."""
    families: "collections.OrderedDict[str, dict]" = \
        collections.OrderedDict()
    for extra_labels, snap in sources:
        for m in snap.get("metrics", ()):
            fam = families.get(m["name"])
            if fam is None:
                fam = {"type": m["type"], "help": m["help"], "rows": []}
                families[m["name"]] = fam
            for suffix, labels, value in m["samples"]:
                merged = tuple(extra_labels) + tuple(
                    (k, v) for k, v in labels)
                fam["rows"].append((suffix, merged, value))
    lines: List[str] = []
    for name in sorted(families):
        fam = families[name]
        lines.append(f"# HELP {name} {escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for suffix, labels, value in fam["rows"]:
            lines.append(
                f"{name}{suffix}{_label_str(labels)} {_fmt(value)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded in-memory ring of structured events (watchdog
    transitions, operator-notable conditions) served at
    ``/debug/events``. Append-only, O(1), never blocks the paths that
    feed it."""

    def __init__(self, capacity: int = 256,
                 clock: Callable[[], float] = time.time):
        self._clock = clock
        self._lock = threading.Lock()  # lock-order: 88 flight-recorder
        self._ring = collections.deque(maxlen=max(int(capacity), 1))  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock

    def record(self, kind: str, severity: str = "info",
               **fields) -> dict:
        evt = {"tsUs": int(self._clock() * 1e6), "kind": kind,
               "severity": severity, "fields": fields}
        with self._lock:
            evt["seq"] = self._seq
            self._seq += 1
            self._ring.append(evt)
        return evt

    def events(self, limit: Optional[int] = None) -> List[dict]:
        """Events oldest→newest (the bounded window)."""
        with self._lock:
            out = list(self._ring)
        if limit is not None:
            out = out[-max(int(limit), 0):]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# ---------------------------------------------------------------------------
# stall watchdog
# ---------------------------------------------------------------------------

class Watchdog:
    """Named liveness/readiness probes over the async machinery.

    A probe is ``fn() -> (ok, reason, value)``; probes run OUTSIDE the
    watchdog's lock (they acquire component locks across the whole
    rank spine — pipeline cond, WAL cond, follower stats). ``check()``
    evaluates everything, records state *transitions* into the flight
    recorder, and returns the health document ``/api/health`` serves:
    not-ready whenever any probe fails, with the failing probes'
    reasons."""

    def __init__(self, recorder: Optional[FlightRecorder] = None,
                 registry: Optional[Registry] = None):
        self.recorder = recorder
        self._lock = threading.Lock()  # lock-order: 87 watchdog
        self._probes: List[Tuple[str, Callable]] = []  # guarded-by: _lock
        self._failing: Dict[str, str] = {}  # guarded-by: _lock
        self._c_trips = None
        if registry is not None:
            registry.register(Gauge(
                "zipkin_watchdog_failing_probes",
                "Probes currently failing (0 = ready)",
                fn=lambda: float(len(self.failing()))))
            self._c_trips = registry.register(Counter(
                "zipkin_watchdog_trips_total",
                "Probe ok→failing transitions"))

    def add_probe(self, name: str, fn: Callable) -> None:
        with self._lock:
            self._probes.append((name, fn))

    def failing(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._failing)

    def check(self) -> dict:
        with self._lock:
            probes = list(self._probes)
        results = []
        for name, fn in probes:  # probe calls: no watchdog lock held
            try:
                ok, reason, value = fn()
            except Exception as e:  # a broken probe is a failing probe
                ok, reason, value = False, f"probe error: {e}", None
            results.append((name, bool(ok), reason, value))
        tripped, cleared = [], []
        with self._lock:
            for name, ok, reason, value in results:
                was = self._failing.get(name)
                if ok and was is not None:
                    del self._failing[name]
                    cleared.append(name)
                elif not ok and was is None:
                    self._failing[name] = reason or name
                    tripped.append((name, reason, value))
        for name, reason, value in tripped:
            if self._c_trips is not None:
                self._c_trips.inc()
            if self.recorder is not None:
                self.recorder.record("watchdog_trip", severity="error",
                                     probe=name, reason=reason,
                                     value=value)
        for name in cleared:
            if self.recorder is not None:
                self.recorder.record("watchdog_clear", severity="info",
                                     probe=name)
        reasons = [{"probe": n, "reason": r, "value": v}
                   for n, ok, r, v in results if not ok]
        return {
            "live": True,
            "ready": not reasons,
            "reasons": reasons,
            "probes": {n: {"ok": ok, "reason": r, "value": v}
                       for n, ok, r, v in results},
        }


# -- probe factories --------------------------------------------------------

def pipeline_stall_probe(store, stall_after_s: float = 5.0) -> Callable:
    """Fails when the ingest pipeline holds queued units but has made
    no commit progress for ``stall_after_s``."""
    def probe():
        pipe = getattr(store, "ingest_pipeline", lambda: None)()
        if pipe is None:
            return True, None, 0.0
        age = pipe.progress_age_s()
        if age > stall_after_s:
            return (False,
                    f"ingest pipeline stalled: {pipe.queued()} queued "
                    f"units, no commit progress for {age:.1f}s", age)
        return True, None, age
    return probe


def fsync_parked_probe(wal) -> Callable:
    """Fails while the WAL's fsync machinery is parked on an error
    (the durable frontier cannot advance — acks will time out)."""
    def probe():
        err = wal.sync_error()
        if err is not None:
            return False, f"wal fsync parked: {err}", None
        return True, None, None
    return probe


def sealer_backlog_probe(store) -> Callable:
    """Fails when the async eviction sealer's bounded backlog is at
    cap (the next capture will stall the write path)."""
    def probe():
        sealer = getattr(store, "eviction_sealer", lambda: None)()
        if sealer is None:
            return True, None, 0.0
        depth = sealer.queued()
        if sealer.at_capacity():
            return (False,
                    f"sealer backlog at cap ({depth} windows queued)",
                    float(depth))
        return True, None, float(depth)
    return probe


def dispatcher_stuck_probe(dispatcher, stall_after_s: float = 5.0
                           ) -> Callable:
    """Fails when cross-shard requests have waited past
    ``stall_after_s`` without the executor draining them."""
    def probe():
        age = dispatcher.queue_age_s()
        if age > stall_after_s:
            return (False,
                    f"cross-shard dispatcher stuck: oldest queued "
                    f"request waited {age:.1f}s", age)
        return True, None, age
    return probe


def follower_lag_probe(status_fn: Callable[[], dict],
                       max_lag_records: int = 10000,
                       max_lag_seconds: float = 30.0) -> Callable:
    """Fails when replication lag passes either threshold (follower
    side: own applied lag; primary side: worst follower cursor)."""
    def probe():
        st = status_fn() or {}
        lag_r = st.get("lagRecords")
        lag_s = st.get("lagSeconds")
        if lag_r is not None and lag_r > max_lag_records:
            return (False,
                    f"replication lag {lag_r} records "
                    f"(> {max_lag_records})", float(lag_r))
        if lag_s is not None and lag_s > max_lag_seconds:
            return (False,
                    f"replication lag {lag_s:.1f}s "
                    f"(> {max_lag_seconds:.0f}s)", float(lag_s))
        return True, None, float(lag_r or 0)
    return probe


# ---------------------------------------------------------------------------
# per-process facade (what the API server serves)
# ---------------------------------------------------------------------------

class FleetObs:
    """One process's fleet-observability surface: role identity, the
    merged-metrics view, health, and the event ring — handed to
    ``ApiServer(fleet=...)`` and wired by the daemon.

    ``remote_sources`` returns ``[(extra_labels, snapshot), ...]`` for
    the other processes this one can see (the primary's shipper serves
    its followers' pushed snapshots); follower processes have none."""

    def __init__(self, role: str, name: str = "",
                 registry: Optional[Registry] = None,
                 tracker: Optional[LineageTracker] = None,
                 follower: Optional[FollowerLineage] = None,
                 watchdog: Optional[Watchdog] = None,
                 recorder: Optional[FlightRecorder] = None,
                 remote_sources: Optional[Callable[[], list]] = None,
                 replication: Optional[Callable[[], dict]] = None):
        self.role = role
        self.name = name
        self.registry = registry
        self.tracker = tracker
        self.follower = follower
        self.watchdog = watchdog
        self.recorder = recorder
        self.remote_sources = remote_sources
        self.replication = replication

    def _own_labels(self) -> Tuple[Tuple[str, str], ...]:
        labels: Tuple[Tuple[str, str], ...] = (("role", self.role),)
        if self.name:
            labels += (("follower", self.name),)
        return labels

    def sources(self) -> list:
        out = []
        if self.registry is not None:
            out.append((self._own_labels(),
                        registry_snapshot(self.registry)))
        if self.remote_sources is not None:
            out.extend(self.remote_sources())
        return out

    def federated_text(self) -> str:
        return render_federated(self.sources())

    def health(self) -> dict:
        if self.watchdog is None:
            return {"live": True, "ready": True, "reasons": [],
                    "probes": {}}
        return self.watchdog.check()

    def events(self, limit: Optional[int] = None) -> List[dict]:
        if self.recorder is None:
            return []
        return self.recorder.events(limit)

    def status(self) -> dict:
        """The ``/api/fleet`` document: roles, replication, lag, and
        fleet-wide monoid roll-ups of the lineage sketches."""
        out: Dict[str, object] = {"role": self.role}
        if self.name:
            out["name"] = self.name
        if self.replication is not None:
            out["replication"] = self.replication()
        if self.follower is not None:
            out["lagSeconds"] = self.follower.lag_seconds()
        sources = self.sources()
        out["processes"] = [dict(labels) for labels, _ in sources]
        merged = {}
        for sketch_name in ("zipkin_replication_visible_lag_seconds",
                            "zipkin_lineage_stage_seconds"):
            states = []
            for _, snap in sources:
                for m in snap.get("metrics", ()):
                    if m["name"] != sketch_name or "sketch" not in m:
                        continue
                    sk = m["sketch"]
                    if sk.get("labelnames"):
                        states.extend(c["state"]
                                      for c in sk["children"])
                    else:
                        states.append(sk["state"])
            if states:
                try:
                    agg = merge_sketches(sketch_name, "", states)
                except ValueError:
                    continue  # mixed layouts across versions: skip
                merged[sketch_name] = agg.snapshot()
        out["merged"] = merged
        if self.watchdog is not None:
            out["health"] = self.watchdog.check()
        return out
