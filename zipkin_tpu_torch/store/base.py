"""SpanStore SPI.

Parity targets (reference):
- ``SpanStore = WriteSpanStore with ReadSpanStore`` —
  zipkin-common/.../storage/SpanStore.scala:26,56,71
- ``IndexedTraceId`` / ``TraceIdDuration`` — storage/Index.scala:29,26
- ``FanoutWriteSpanStore`` — SpanStore.scala:38

The API is array-friendly: every read returns plain python data, every write
takes a batch of spans; implementations may be host-resident (memory) or
device-resident (TPU columnar + sketches). Synchronous by design — the
async boundary in this framework lives in the ingest queue
(zipkin_tpu_torch.ingest.queue), not in the store.
"""

from __future__ import annotations

import abc
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Set

from zipkin_tpu_torch.models.span import Span

# Reference default TTLs (CassieSpanStore.scala:47-48).
DEFAULT_SPAN_TTL_S = 7 * 24 * 3600
DEFAULT_INDEX_TTL_S = 3 * 24 * 3600
TTL_TOP = float("inf")


class StorageException(RuntimeError):
    """Raised by stores on write/read failure (storage/util SpanStoreException)."""


def as_bytes(v) -> bytes:
    """Canonical byte form of a binary-annotation value for comparisons."""
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode("utf-8")
    return bytes(v)


@dataclass(frozen=True)
class IndexedTraceId:
    """A trace id with the index timestamp that matched (Index.scala:29)."""

    trace_id: int
    timestamp: int


@dataclass(frozen=True)
class TraceIdDuration:
    """Trace duration in µs + start timestamp (Index.scala:26)."""

    trace_id: int
    duration: int
    start_timestamp: int


def should_index(span: Span) -> bool:
    """Skip indexing client-side spans attributed to the literal service
    "client" (SpanStore.scala:66-67)."""
    return not (span.is_client_side() and "client" in span.service_names)


class PinBank:
    """Host-side eviction-exempt storage for pinned traces.

    The reference's setTimeToLive actually extends storage retention
    (SpanStore.scala:66; web pin → Handlers.scala:490). The device ring
    evicts by wraparound regardless of TTL, so pinning a trace
    materializes its spans into this bank at pin time, keeps the bank
    fresh as later spans of the trace arrive, and trace-id read paths
    union it with ring results — the pinned trace stays fully readable
    after the ring has lapped it. Unpinning drops the entry.

    Banks dedup on append (transport retries re-deliver spans) and are
    bounded per trace by MAX_SPANS_PER_TRACE — the maxTraceCols guard
    (CassieSpanStore.scala:50) applied to pinned retention.
    """

    MAX_SPANS_PER_TRACE = 100_000

    def __init__(self):
        self._pins = {}
        self._seen = {}  # tid -> set of banked spans (dedup)

    def __bool__(self) -> bool:
        return bool(self._pins)

    def __contains__(self, tid: int) -> bool:
        return tid in self._pins

    def pin(self, tid: int, spans) -> None:
        out, seen = [], set()
        for s in spans:
            if s not in seen and len(out) < self.MAX_SPANS_PER_TRACE:
                out.append(s)
                seen.add(s)
        self._pins[tid] = out
        self._seen[tid] = seen

    def unpin(self, tid: int) -> None:
        self._pins.pop(tid, None)
        self._seen.pop(tid, None)

    def get(self, tid: int):
        return self._pins.get(tid)

    def tids(self):
        return set(self._pins)

    def items(self):
        return self._pins.items()

    def note_write(self, key_of, spans) -> None:
        """Append incoming spans of already-pinned traces — post-pin
        arrivals must survive eviction too. Idempotent per span."""
        if not self._pins:
            return
        for s in spans:
            tid = key_of(s.trace_id)
            bank = self._pins.get(tid)
            if bank is None:
                continue
            seen = self._seen[tid]
            if s not in seen and len(bank) < self.MAX_SPANS_PER_TRACE:
                bank.append(s)
                seen.add(s)

    def merge(self, tid: int, ring_spans):
        """Union bank + ring rows for one trace: bank spans (inserted
        earlier) first, then ring spans whose span id isn't banked.

        Dedup is by span id, not object equality: a ring row whose
        annotations were evicted from their own ring decodes as a
        partial twin of the banked span — every post-pin arrival is
        banked by note_write, so a ring copy sharing a banked id is
        redundant (or partial) by construction."""
        bank = self._pins.get(tid)
        if not bank:
            return list(ring_spans)
        seen_ids = {s.id for s in bank}
        return list(bank) + [s for s in ring_spans if s.id not in seen_ids]


# Bound on a store's host TTL map (pins + recent traces); ring/segment
# eviction has no host-side hook, so pruning happens on insert. Shared
# by the device, sharded, and replica stores.
MAX_TTL_ENTRIES = 1 << 20


def prune_ttls(ttls: dict, max_entries: int) -> None:
    """Drop oldest non-pinned TTL entries beyond the bound (ring
    eviction is the real retention; pinned entries — ttl > 1.0 —
    survive). Shared by the single-device and sharded stores."""
    excess = len(ttls) - max_entries
    if excess <= 0:
        return
    for tid in list(ttls):
        if excess <= 0:
            break
        if ttls[tid] <= 1.0:
            del ttls[tid]
            excess -= 1


def fill_pin(pins: PinBank, lock, tid: int, fetch_spans) -> None:
    """Pin-materialization with the TOCTOU window closed: open the bank
    under ``lock`` FIRST (so concurrent writes bank their arrivals via
    note_write), then fetch the ring snapshot outside the lock, then
    union both under the lock."""
    with lock:
        if tid in pins:
            return
        pins.pin(tid, [])
    found = fetch_spans()
    with lock:
        banked = pins.get(tid)
        if banked is None:  # unpinned while fetching
            return
        seen = set(banked)
        pins.pin(tid, list(banked) + [s for s in found if s not in seen])


def service_scan_only(svc_id: int, config) -> bool:
    """True when a resolved service id overflows the store's service
    capacity (dictionary id >= max_services): such services exist only
    in the raw ring columns — no index family, histogram, or key record
    can represent them — so the index fast path would return a trusted
    EMPTY while the scan finds their spans. Every device-store query
    path must route these to the scan (slower, never wrong)."""
    return svc_id >= config.max_services


def resolve_annotation_query(dicts, annotation: str, value):
    """Dictionary-id resolution for get_trace_ids_by_annotation, shared
    by the single-device and sharded stores. Returns
    (ann_value, bann_key, bann_value, bann_value2) with -1 sentinels,
    or None when nothing in the dictionaries can match."""
    bann_key = dicts.binary_keys.get(annotation)
    bann_key = -1 if bann_key is None else bann_key
    if value is not None:
        # Value given: only binary annotations with that exact value
        # match. The dictionary keys values in their original python
        # form, so probe both the bytes and the decoded-str shape.
        ann_value = -1
        vb = as_bytes(value)
        bann_value = dicts.binary_values.get(vb)
        try:
            bann_value2 = dicts.binary_values.get(vb.decode("utf-8"))
        except UnicodeDecodeError:
            bann_value2 = None
        bann_value = -1 if bann_value is None else bann_value
        bann_value2 = -1 if bann_value2 is None else bann_value2
        if (bann_value < 0 and bann_value2 < 0) or bann_key < 0:
            return None
    else:
        ann_value = dicts.annotations.get(annotation)
        ann_value = -1 if ann_value is None else ann_value
        bann_value = bann_value2 = -1
        if ann_value < 0 and bann_key < 0:
            return None
    return ann_value, bann_key, bann_value, bann_value2


def topk_ids_with_escalation(limit: int, k_max: int, fetch,
                             k0: int = 64) -> List["IndexedTraceId"]:
    """Escalating candidate fetch for index queries: ``fetch(k)``
    returns (candidates [(tid, ts)...], truncated) off the device top-k
    kernel; when dedup-by-trace can't fill ``limit`` AND the candidate
    window was full (a hot trace may have crowded it), re-query with
    k×8. Exact: any trace absent from a candidate window ranks below
    every candidate in it, so ``limit`` distinct found traces are the
    true top ``limit``."""
    k = min(max(k0, 4 * limit), max(k_max, 1))
    while True:
        candidates, truncated = fetch(k)
        ids = dedup_rank_limit(candidates, limit)
        if len(ids) >= limit or not truncated or k >= k_max:
            return ids
        k = min(k * 8, k_max)


def index_topk_or_none(limit: int, k: int, candidates, complete,
                       watermark) -> Optional[List["IndexedTraceId"]]:
    """The index trust gate as a pure function over an already-fetched
    bucket window of ``k`` candidate slots; None means the window can't
    be trusted and the caller must scan. Shared by the per-query path
    (index_first_topk) and the batched multi-probe path
    (TpuSpanStore.get_trace_ids_multi)."""
    ids = dedup_rank_limit(candidates, limit)
    if len(ids) >= limit:
        # A complete bucket's top candidates are exact; a wrapped one's
        # are exact iff nothing displaced could outrank the limit-th.
        if complete or ids[-1].timestamp >= watermark:
            return ids
    elif complete and len(candidates) < k:
        # Every entry the bucket has ever held was inside the top-k
        # window: the underfull result is the true, full answer.
        return ids
    return None


def index_first_topk(limit: int, k_max: int, index_fetch,
                     scan_fetch, stats=None) -> List["IndexedTraceId"]:
    """Index fast path with scan fallback, the shared read policy of the
    device stores. ``index_fetch(k)`` reads an O(depth) index bucket and
    returns (candidates, complete, watermark, window):

    - ``complete`` — the bucket never wrapped, so it holds every entry
      ever written for the key: the result is exact, full stop.
    - otherwise the bucket holds its newest entries, and ``watermark``
      is the max ts ever displaced from it: the result is exact iff the
      limit-th ranked candidate still sits at or above the watermark
      (every span the index no longer holds ranks at or below it).
    - ``window`` — the number of candidate slots the kernel ACTUALLY
      returned (it may clamp the requested k to its bucket geometry).
      The underfull-equals-complete claim compares against this, never
      against the requested k: a kernel-truncated window full of
      candidates must read as saturated, not underfull (a saturated
      window silently cut real candidates — the bug the 3-store oracle
      parity drive caught in the two-bucket binary-value probe).

    A complete bucket whose top-k window saturated gets ONE retry at
    full bucket depth (the kernel clamps the oversized request to its
    geometry) — an O(depth) read that usually proves the answer without
    the O(ring) scan when a hot key's entries crowd the window.

    Anything else falls back to the O(ring) scan kernel's escalation.
    Near-monotonic traffic (the normal case: spans arrive roughly in
    timestamp order) keeps wrapped buckets trusted; shuffled arrival
    degrades to the scan, never to a wrong answer.

    ``stats`` (optional) is any object with ``index_hits`` /
    ``index_fallbacks`` counters — the accounting hook /metrics reads
    (TpuSpanStore passes itself)."""
    k = limit * 8
    candidates, complete, watermark, window = index_fetch(k)
    ids = index_topk_or_none(limit, min(k, window), candidates,
                             complete, watermark)
    if (ids is None and complete and 0 < k <= window
            and len(candidates) >= k):
        # window >= k: the first read was top-k-truncated, not
        # bucket-clamped — a full-depth reread can actually add rows.
        k = 1 << 20
        candidates, complete, watermark, window = index_fetch(k)
        ids = index_topk_or_none(limit, min(k, window), candidates,
                                 complete, watermark)
    if ids is not None:
        if stats is not None:
            stats.index_hits += 1
        return ids
    if stats is not None:
        stats.index_fallbacks += 1
    return topk_ids_with_escalation(limit, k_max, scan_fetch)


def dedup_rank_limit(candidates, limit: int) -> List["IndexedTraceId"]:
    """One IndexedTraceId per trace id (max timestamp wins), sorted by
    timestamp descending, truncated to ``limit`` — the dedup-before-limit
    semantics every store's index queries share."""
    best = {}
    for tid, ts in candidates:
        if ts > best.get(tid, -1):
            best[tid] = ts
    ranked = sorted(best.items(), key=lambda kv: kv[1], reverse=True)
    return [IndexedTraceId(t, ts) for t, ts in ranked[:limit]]


def apply_pin_merges(pins: PinBank, by_tid: dict, trace_ids, key_of) -> None:
    """Union each requested pinned trace's bank into ``by_tid`` in place.
    Callers hold whatever lock guards ``pins``."""
    if not pins:
        return
    for tid in trace_ids:
        stid = key_of(tid)
        if stid in pins:
            merged = pins.merge(stid, by_tid.get(stid, []))
            if merged:
                by_tid[stid] = merged


def escalate_cap(n: int, k: int, cap: int) -> int:
    """Grow a static gather cap ×8 until it covers ``n`` (bounded by the
    ring capacity) — shared by the single-store and sharded trace reads
    so their compile-cache keys stay aligned."""
    while n > k:
        k = min(k * 8, cap)
    return k


GATHER_K0 = 4096


def gather_with_escalation(config, fetch, k0: int = GATHER_K0):
    """Run a device trace-row gather with cap escalation: ``fetch(k_s,
    k_a, k_b)`` returns (n_s, n_a, n_b, payload); retried with ×8 caps
    until the counts fit (bounded by the ring capacities). Shared retry
    policy of the single-store and sharded whole-trace reads."""
    k_s = min(k0, config.capacity)
    k_a = min(2 * k0, config.ann_capacity)
    k_b = min(k0, config.bann_capacity)
    while True:
        n_s, n_a, n_b, payload = fetch(k_s, k_a, k_b)
        if n_s <= k_s and n_a <= k_a and n_b <= k_b:
            return payload
        k_s = escalate_cap(n_s, k_s, config.capacity)
        k_a = escalate_cap(n_a, k_a, config.ann_capacity)
        k_b = escalate_cap(n_b, k_b, config.bann_capacity)


def index_gather_with_escalation(config, nq: int, fetch):
    """Cap-escalating retry for the trace-membership gather fast path,
    shared by the single-device and sharded stores (same reasoning as
    gather_with_escalation: one policy, aligned compile caches).
    ``fetch(k_s, k_a, k_b)`` returns (exact, n_s, n_a, n_b, payload);
    returns the payload, or None the moment any queried bucket fails
    its exactness gate (callers then run the scan gather). Caps are
    bounded by nq x the per-family bucket depths — the most candidates
    the buckets can hold for the request."""
    c = config
    max_s = min(nq * c.TRACE_SPAN_DEPTH, c.capacity)
    max_a = min(nq * c.TRACE_ANN_DEPTH, c.ann_capacity)
    max_b = min(nq * c.TRACE_BANN_DEPTH, c.bann_capacity)
    k_s = min(GATHER_K0, max_s)
    k_a = min(2 * GATHER_K0, max_a)
    k_b = min(GATHER_K0, max_b)
    while True:
        exact, n_s, n_a, n_b, payload = fetch(k_s, k_a, k_b)
        if not exact:
            return None
        if n_s <= k_s and n_a <= k_a and n_b <= k_b:
            return payload
        k_s = escalate_cap(n_s, k_s, max_s)
        k_a = escalate_cap(n_a, k_a, max_a)
        k_b = escalate_cap(n_b, k_b, max_b)


def pinned_duration(trace_id: int, bank, existing=None):
    """TraceIdDuration over a pinned trace's banked spans, widened by
    any ring result (partial eviction leaves the ring narrower)."""
    ts = []
    for s in bank or ():
        if s.first_timestamp is not None:
            ts.append(s.first_timestamp)
            ts.append(s.last_timestamp)
    if existing is not None:
        ts.append(existing.start_timestamp)
        ts.append(existing.start_timestamp + existing.duration)
    if not ts:
        return existing
    return TraceIdDuration(trace_id, max(ts) - min(ts), min(ts))


def exist_from_duration_mat(canon, qids, present_row, pins: PinBank, lock):
    """traces_exist result from the stacked durations kernel's present
    row, unioned with requested pinned traces (shared by both stores)."""
    out = {
        canon[int(q)] for q, present in zip(qids, present_row) if present
    }
    with lock:
        if pins:
            out |= {
                orig for stid, orig in canon.items()
                if stid in pins and pins.get(stid)
            }
    return out


def durations_from_mat(trace_ids, canon, qids, mat, pins: PinBank, lock):
    """get_traces_duration result from the stacked durations kernel
    output [4, nq], with pin-bank widening (shared by both stores)."""
    by_tid = {
        canon[int(q)]: TraceIdDuration(canon[int(q)], int(mx - mn), int(mn))
        for q, f, mn, mx in zip(qids, mat[1], mat[2], mat[3])
        if f
    }
    with lock:
        if pins:
            for stid, orig in canon.items():
                if stid not in pins:
                    continue
                d = pinned_duration(orig, pins.get(stid), by_tid.get(orig))
                if d is not None:
                    by_tid[orig] = d
    return [by_tid[t] for t in trace_ids if t in by_tid]


class StoreSuspectError(RuntimeError):
    """The store's device state may still be read by an orphaned
    transfer thread (a slab-save timeout abandoned a wedged
    ``device_get``); donating writes must not run until the orphan is
    joined (ADVICE r5 checkpoint hazard)."""


_SUSPECT_LOCK = threading.Lock()  # lock-order: 83 suspect-flag


class SuspectGuard:
    # -- suspect protocol (checkpoint slab-timeout hazard) --------------
    # A deadline-bounded checkpoint save that times out leaves its
    # device_get running on an abandoned daemon thread, which may still
    # be READING the state buffers after the save's read lock releases.
    # A donating ingest step (or a fresh save's consistent cut) racing
    # that orphan reads/writes freed-or-reused buffers. checkpoint.save
    # stamps the store via mark_suspect(); every donating write path
    # calls ensure_writable() first, which joins the orphans (bounded)
    # and either clears the flag or raises StoreSuspectError.
    _suspect = False

    def mark_suspect(self, orphan=None) -> None:
        """Flag the device state as possibly-shared with an orphaned
        reader thread; ``orphan`` is the abandoned Thread when known."""
        with _SUSPECT_LOCK:
            self._suspect = True
            if orphan is not None:
                if not hasattr(self, "_suspect_orphans"):
                    self._suspect_orphans = []
                self._suspect_orphans.append(orphan)

    @property
    def suspect(self) -> bool:
        return self._suspect

    def ensure_writable(self, wait_s: float = 0.0) -> None:
        """No-op unless suspect. Joins each known orphan for up to
        ``wait_s``; the flag clears only if EVERY currently-recorded
        orphan is finished at re-check time (a concurrent save timeout
        may have appended a new orphan while we joined the snapshot),
        else StoreSuspectError. A suspect store with no recorded
        orphans can only be cleared explicitly (clear_suspect) or by a
        process restart."""
        if not self._suspect:
            return
        with _SUSPECT_LOCK:
            orphans = list(getattr(self, "_suspect_orphans", ()))
        for t in orphans:
            t.join(wait_s)
        with _SUSPECT_LOCK:
            if not self._suspect:
                return
            current = getattr(self, "_suspect_orphans", [])
            alive = [t for t in current if t.is_alive()]
            if alive or not current:
                if hasattr(self, "_suspect_orphans"):
                    self._suspect_orphans[:] = alive
                raise StoreSuspectError(
                    "store state may be shared with an orphaned "
                    "device_get reader (slab-save timeout); retry after "
                    "the transfer un-wedges or restart the process"
                )
            self._suspect_orphans[:] = []
            self._suspect = False

    def clear_suspect(self) -> None:
        """Operator override: declare the orphan dealt with."""
        with _SUSPECT_LOCK:
            self._suspect = False
            if hasattr(self, "_suspect_orphans"):
                self._suspect_orphans[:] = []


class WriteSpanStore(SuspectGuard, abc.ABC):
    @abc.abstractmethod
    def apply(self, spans: Sequence[Span]) -> None:
        """Store a batch of spans."""

    @abc.abstractmethod
    def set_time_to_live(self, trace_id: int, ttl_seconds: float) -> None:
        """Pin/extend a trace's retention (SpanStore.scala:66)."""

    def stored_span_count(self) -> Optional[float]:
        """Total spans ever admitted, from the store's own counters —
        the adaptive sampler's flow source (the device ``spans_seen``
        counter on the TPU store; psum-ed across shards when sharded —
        replacing the reference's ZK group sum,
        AdaptiveSampler.scala:204-237). None = unknown; callers fall
        back to host-side accounting."""
        return None

    def close(self) -> None:
        pass


class ReadSpanStore(abc.ABC):
    # -- resident query engines (query/engine.py) ----------------------
    # Engines register here so lifecycle owners that only hold the
    # store (Collector.flush/close, checkpoint.save) can join the
    # executor thread into the ordered drain→seal→fsync→checkpoint
    # sequence without knowing the query layer.

    def register_query_engine(self, engine) -> None:
        self.__dict__.setdefault("_query_engines", []).append(engine)

    def query_engines(self):
        return list(self.__dict__.get("_query_engines", ()))

    @abc.abstractmethod
    def get_time_to_live(self, trace_id: int) -> float:
        ...

    @abc.abstractmethod
    def traces_exist(self, trace_ids: Sequence[int]) -> Set[int]:
        ...

    @abc.abstractmethod
    def get_spans_by_trace_ids(self, trace_ids: Sequence[int]) -> List[List[Span]]:
        """Found traces only; absent ids are dropped from the result."""

    def get_spans_by_trace_id(self, trace_id: int) -> List[Span]:
        found = self.get_spans_by_trace_ids([trace_id])
        return found[0] if found else []

    @abc.abstractmethod
    def get_trace_ids_by_name(
        self,
        service_name: str,
        span_name: Optional[str],
        end_ts: int,
        limit: int,
    ) -> List[IndexedTraceId]:
        ...

    @abc.abstractmethod
    def get_trace_ids_by_annotation(
        self,
        service_name: str,
        annotation: str,
        value: Optional[bytes],
        end_ts: int,
        limit: int,
    ) -> List[IndexedTraceId]:
        ...

    def get_trace_ids_multi(self, queries) -> List[List[IndexedTraceId]]:
        """Resolve several independent trace-id queries at once. Each
        query is a tuple:

        - ``("name", service_name, span_name_or_None, end_ts, limit)``
        - ``("annotation", service_name, annotation, value_or_None,
          end_ts, limit)``

        The generic implementation loops over the singular methods;
        device stores override it to fold every query's index probe
        into a single kernel launch (the batched analogue of the
        reference resolving a request's slices with separate index
        reads, ThriftQueryService.scala:166-196)."""
        out: List[List[IndexedTraceId]] = []
        for q in queries:
            if q[0] == "name":
                _, svc, name, end_ts, limit = q
                out.append(
                    self.get_trace_ids_by_name(svc, name, end_ts, limit)
                )
            else:
                _, svc, ann, value, end_ts, limit = q
                out.append(self.get_trace_ids_by_annotation(
                    svc, ann, value, end_ts, limit
                ))
        return out

    @abc.abstractmethod
    def get_traces_duration(self, trace_ids: Sequence[int]) -> List[TraceIdDuration]:
        ...

    @abc.abstractmethod
    def get_all_service_names(self) -> Set[str]:
        ...

    @abc.abstractmethod
    def get_span_names(self, service: str) -> Set[str]:
        ...


class SpanStore(WriteSpanStore, ReadSpanStore, abc.ABC):
    """The unified store interface (SpanStore.scala:26)."""


class FanoutWriteSpanStore(WriteSpanStore):
    """Replicate writes to several stores (SpanStore.scala:38)."""

    def __init__(self, *stores: WriteSpanStore):
        self.stores = stores

    def apply(self, spans: Sequence[Span]) -> None:
        for s in self.stores:
            s.apply(spans)

    def set_time_to_live(self, trace_id: int, ttl_seconds: float) -> None:
        for s in self.stores:
            s.set_time_to_live(trace_id, ttl_seconds)

    def close(self) -> None:
        for s in self.stores:
            s.close()
