"""TieredSpanStore: the full SpanStore SPI over hot ring + cold segments.

The port's copy of ``zipkin_tpu/store/archive/tiered.py`` over a
``TorchSpanStore``. Writes (``apply``, the native thrift fast path
``write_thrift``) go to the hot store, whose write path captures.

Tiering contract (what makes the federation exact):

- Every span row carries a global id (gid). The hot tier is the device
  ring: rows with gid in [write_pos - capacity, write_pos). The cold
  tier covers gids [0, captured_upto): the capture hook in
  TorchSpanStore pulls every row BEFORE any of the three rings (span /
  annotation / binary) can overwrite it, so a captured copy is always
  COMPLETE (its annotation rows were still resident at capture time)
  and the two tiers overlap only in rows that exist identically in
  both. Row-level reads therefore dedupe by gid, preferring the cold
  copy (the ring twin may have lost side-table rows to the
  faster-lapping annotation rings).

- Index reads union each tier's top-``limit`` candidate list and
  re-rank: a trace absent from BOTH per-tier top lists is outranked by
  ``limit`` distinct traces globally (the topk_ids_with_escalation
  argument applied across tiers), so the union is the true global
  top-``limit``.

- Cold candidates come from zone-map pruning (service bitmap, tagged
  key CMS, ts range, trace bloom) followed by the memory-oracle match
  functions (store/memory.py) over decoded rows — bit-for-bit the
  reference semantics, including spans long evicted from the device.

- Lifetime streaming aggregates (dependency banks, per-service
  histograms, HLL, top-k counters) survive eviction ON DEVICE, so
  those queries delegate to the hot store; the cold tier additionally
  answers them from segment sketches alone (``cold_*`` methods) —
  quantiles and cardinality without decompressing a single row.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Set

from zipkin_tpu_torch.columnar.encode import to_signed64
from zipkin_tpu_torch.models.span import Span
from zipkin_tpu_torch.store.archive.coldquery import (
    ColdQueries,
    durations_from_bounds,
    union_topk,
)
from zipkin_tpu_torch.store.archive.directory import (
    ArchiveParams,
    SegmentDirectory,
)
from zipkin_tpu_torch.store.archive.segment import seal_segment
from zipkin_tpu_torch.store.base import (
    IndexedTraceId,
    SpanStore,
    TraceIdDuration,
    apply_pin_merges,
    fill_pin,
)


class TieredSpanStore(ColdQueries, SpanStore):
    """Federates a TorchSpanStore (hot) with a SegmentDirectory (cold).
    The cold read half (zone pruning + oracle-match semantics) lives in
    the shared ColdQueries mixin (store/archive/coldquery.py) — the
    device-free ReplicaSpanStore runs the identical code over segments
    sealed from shipped WAL records."""

    def __init__(self, hot, params: Optional[ArchiveParams] = None,
                 directory: Optional[SegmentDirectory] = None,
                 registry=None, background_compaction: bool = False):
        self.hot = hot
        self.params = params or ArchiveParams.for_config(hot.config)
        self.archive = directory or SegmentDirectory(
            self.params, hot.codec, registry=registry)
        self.captures = 0
        hot.eviction_sink = self._capture_sink
        if background_compaction:
            self.archive.start_compactor()

    # -- capture --------------------------------------------------------

    def _capture_sink(self, batch, gids, gid_lo: int, gid_hi: int,
                      pull_s: float) -> None:
        """Called from the hot write path with one capture window's
        pulled columns; seals a segment and hands it to the directory
        (which may compact inline)."""
        t0 = time.perf_counter()
        spans = self.hot.codec.decode(batch)
        seg = seal_segment(
            self.archive.next_id(), batch, gids, spans,
            self.hot.dicts, self.params, gid_lo, gid_hi,
        )
        self.archive.append(seg, cache=(batch, gids, spans))
        self.captures += 1
        self.archive.h_capture.observe(
            pull_s + (time.perf_counter() - t0))

    # -- writes (delegate; capture rides the hot write path) ------------

    def apply(self, spans: Sequence[Span]) -> None:
        self.hot.apply(spans)

    def write_thrift(self, payload: bytes, sample_threshold: int = 0):
        return self.hot.write_thrift(payload, sample_threshold)

    def set_time_to_live(self, trace_id: int, ttl_seconds: float) -> None:
        # Same TTL/pin bookkeeping as the hot store, but pin
        # materialization reads THROUGH the tiers so pinning an
        # already-evicted trace banks its cold rows too.
        hot = self.hot
        tid = to_signed64(trace_id)
        with hot._lock:
            hot.ttls[tid] = ttl_seconds
            hot._bump_read_epoch()
            pin = ttl_seconds > hot.DEFAULT_TTL_S
            if not pin:
                hot.pins.unpin(tid)
        if pin:
            fill_pin(hot.pins, hot._lock, tid, lambda: (
                self.get_spans_by_trace_ids([trace_id]) or [[]])[0])
            with hot._lock:
                hot._bump_read_epoch()  # bank filled: reads widened

    def get_time_to_live(self, trace_id: int) -> float:
        return self.hot.get_time_to_live(trace_id)

    def write_frontier(self):
        """The hot store's commit frontier keys the result cache for
        the WHOLE federation: cold-tier content only changes through
        hot commits (capture windows are pulled inside the committing
        write's lock hold, and cold reads run behind seal_barrier), so
        a fixed hot frontier pins the federated answer too."""
        return self.hot.write_frontier()

    @property
    def dicts(self):
        """The dictionary set that encoded every tier's rows (the
        ColdQueries mixin resolves query names against it)."""
        return self.hot.dicts

    def capture_now(self) -> None:
        """Flush everything resident-but-uncaptured into a segment."""
        self.hot.capture_now()

    def close(self) -> None:
        # Hot store first: it drains the ingest pipeline (committing
        # accepted batches, which may trigger final captures) and then
        # the capture sealer — only after that is detaching the sink
        # safe (a pending async seal still needs it).
        self.hot.close()
        self.archive.stop_compactor()
        self.archive.close()
        self.hot.eviction_sink = None

    # -- pipelined-ingest passthrough (the pipeline lives on the hot
    # store; collector/daemon wiring sees one store object) ------------

    def start_pipeline(self, depth: Optional[int] = None):
        return self.hot.start_pipeline(depth)

    def drain_pipeline(self) -> None:
        self.hot.drain_pipeline()

    def stop_pipeline(self, raise_errors: bool = True) -> None:
        self.hot.stop_pipeline(raise_errors)

    def seal_barrier(self) -> None:
        self.hot.seal_barrier()

    # -- write-ahead log passthrough (the journal hook lives on the hot
    # store's write path; capture/seal replays ride it) ----------------

    @property
    def wal(self):
        return self.hot.wal

    def attach_wal(self, wal) -> None:
        self.hot.attach_wal(wal)

    def wal_sync(self) -> None:
        self.hot.wal_sync()

    # -- row reads ------------------------------------------------------

    def _segments(self):
        """Directory snapshot behind the hot store's seal barrier:
        with an async sealer a capture window can be pulled (rows
        possibly already overwritten in the rings) but not yet
        appended — a cold read that skipped the barrier could miss
        rows neither tier still serves."""
        self.hot.seal_barrier()
        return self.archive.snapshot()

    def _pruned(self, probe):
        """Zone-pruned scan behind the seal barrier (see _segments)."""
        self.hot.seal_barrier()
        return self.archive.pruned_scan(probe)

    def get_spans_by_trace_ids(self, trace_ids: Sequence[int]
                               ) -> List[List[Span]]:
        if not trace_ids:
            return []
        hot = self.hot
        qids = {to_signed64(t) for t in trace_ids}
        rows: Dict[int, Dict[int, Span]] = {}
        for gid, span in hot.get_trace_rows(trace_ids):
            rows.setdefault(to_signed64(span.trace_id), {})[gid] = span
        t0 = time.perf_counter()
        # Cold copy wins on gid overlap: captured before any ring
        # could drop its annotation rows.
        self.cold_rows_for_traces(qids, rows)
        self.archive.h_cold_query.observe(time.perf_counter() - t0)
        by_tid = {
            tid: [span for _, span in sorted(found.items())]
            for tid, found in rows.items()
        }
        with hot._lock:
            apply_pin_merges(hot.pins, by_tid, trace_ids, to_signed64)
        return [
            by_tid[to_signed64(t)] for t in trace_ids
            if by_tid.get(to_signed64(t))
        ]

    def traces_exist(self, trace_ids: Sequence[int]) -> Set[int]:
        if not trace_ids:
            return set()
        found = self.hot.traces_exist(trace_ids)
        missing = [t for t in trace_ids if t not in found]
        if not missing:
            return found
        qids = {to_signed64(t): t for t in missing}
        t0 = time.perf_counter()
        found |= self.cold_traces_exist(qids)
        self.archive.h_cold_query.observe(time.perf_counter() - t0)
        return found

    def get_traces_duration(self, trace_ids: Sequence[int]
                            ) -> List[TraceIdDuration]:
        if not trace_ids:
            return []
        bounds: Dict[int, list] = {}
        for d in self.hot.get_traces_duration(trace_ids):
            bounds[d.trace_id] = [d.start_timestamp,
                                  d.start_timestamp + d.duration]
        canon = {to_signed64(t): t for t in trace_ids}
        t0 = time.perf_counter()
        self.cold_duration_bounds(canon, bounds)
        self.archive.h_cold_query.observe(time.perf_counter() - t0)
        return durations_from_bounds(trace_ids, bounds)

    # -- index reads (cold halves come from the ColdQueries mixin) ------

    @staticmethod
    def _union(limit: int, *tiers) -> List[IndexedTraceId]:
        """Re-rank the union of per-tier top-``limit`` lists — exact
        (see the module docstring's cross-tier top-k argument)."""
        return union_topk(limit, *tiers)

    def get_trace_ids_by_name(self, service_name: str,
                              span_name: Optional[str], end_ts: int,
                              limit: int) -> List[IndexedTraceId]:
        return self._union(
            limit,
            self.hot.get_trace_ids_by_name(service_name, span_name,
                                           end_ts, limit),
            self._cold_ids_by_name(service_name, span_name, end_ts,
                                   limit),
        )

    def get_trace_ids_by_annotation(self, service_name: str,
                                    annotation: str,
                                    value: Optional[bytes], end_ts: int,
                                    limit: int) -> List[IndexedTraceId]:
        return self._union(
            limit,
            self.hot.get_trace_ids_by_annotation(
                service_name, annotation, value, end_ts, limit),
            self._cold_ids_by_annotation(service_name, annotation,
                                         value, end_ts, limit),
        )

    def get_trace_ids_multi(self, queries) -> List[List[IndexedTraceId]]:
        """Hot probes ride the device's one-launch batched path; each
        query then unions its cold candidates."""
        hot_res = self.hot.get_trace_ids_multi(queries)
        out = []
        for q, hot_ids in zip(queries, hot_res):
            if q[0] == "name":
                _, svc, name, end_ts, limit = q
                cold = self._cold_ids_by_name(svc, name, end_ts, limit)
            else:
                _, svc, ann, value, end_ts, limit = q
                cold = self._cold_ids_by_annotation(svc, ann, value,
                                                    end_ts, limit)
            out.append(self._union(q[-1], hot_ids, cold))
        return out

    # -- catalogs -------------------------------------------------------

    def get_all_service_names(self) -> Set[str]:
        out = self.hot.get_all_service_names()
        d = self.hot.dicts.services
        for seg in self._segments():
            out.update(
                name for i in seg.zone.service_ids
                if i < len(d) and (name := d.decode(i))
            )
        return out

    def get_span_names(self, service: str) -> Set[str]:
        out = self.hot.get_span_names(service)
        out.update(self.cold_span_names(service))
        return out

    # -- lifetime aggregates (device streaming state; see module doc) ---

    def get_dependencies(self, start_ts: Optional[int] = None,
                         end_ts: Optional[int] = None):
        return self.hot.get_dependencies(start_ts, end_ts)

    def archive_now(self) -> None:
        self.hot.archive_now()

    def service_duration_quantiles(self, service: str,
                                   qs: Sequence[float]):
        return self.hot.service_duration_quantiles(service, qs)

    def top_annotations(self, service: str, k: int = 10):
        return self.hot.top_annotations(service, k)

    def top_binary_keys(self, service: str, k: int = 10):
        return self.hot.top_binary_keys(service, k)

    def estimated_unique_traces(self) -> float:
        return self.hot.estimated_unique_traces()

    def stored_span_count(self):
        return self.hot.stored_span_count()

    # -- cold-only sketch answers: cold_duration_quantiles /
    # cold_estimated_unique_traces come from the ColdQueries mixin ------

    # -- telemetry ------------------------------------------------------

    def counters(self) -> Dict[str, float]:
        out = dict(self.hot.counters())
        out.update(self.archive.stats())
        out["archive_captures"] = float(self.captures)
        return out
