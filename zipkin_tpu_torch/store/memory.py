"""In-memory reference SpanStore.

Parity target: ``InMemorySpanStore`` (zipkin-common/.../storage/SpanStore.scala:128).
This is the correctness oracle the conformance suite and the device store
are checked against (the port's copy of ``zipkin_tpu/store/memory.py``).
Deliberate deviations from the reference's *in-memory* store, each
matching what its *real* backends (Cassandra/anormdb) do instead:

- indexed-id results are deduplicated by trace id (keeping the trace's
  most recent matching span) and sorted by timestamp descending before
  the limit is applied (the reference in-memory store truncates per-span
  in insertion order; its query layer uniques ids afterwards — deduping
  before the limit keeps one hot trace from crowding out the rest);
- binary-annotation *keys* match annotation queries even without a value
  (Cassandra writes AnnotationsIndex rows for binary-annotation keys,
  CassieSpanStore.scala:168-251);
- the end_ts filter compares the span's last timestamp uniformly (the
  reference in-memory store mixes first/last between the two paths);
- empty span names and empty service names are not indexed
  (CassieSpanStore skips them on write).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set

from zipkin_tpu_torch.models.constants import CORE_ANNOTATIONS
from zipkin_tpu_torch.models.span import Span
from zipkin_tpu_torch.store.base import (
    IndexedTraceId,
    SpanStore,
    TraceIdDuration,
    as_bytes,
    should_index,
)


def match_spans_by_name(spans, service_name: str,
                        span_name: Optional[str], end_ts: int
                        ) -> List[Span]:
    """The reference store's name-index match over a plain span list —
    module-level so the cold-tier segment scan
    (store/archive/tiered.py) applies EXACTLY the oracle's semantics to
    decoded segment rows (one definition, zero drift)."""
    name = service_name.lower()
    matched = [
        s for s in spans if should_index(s) and name in s.service_names
    ]
    if span_name is not None:
        wanted = span_name.lower()
        matched = [s for s in matched if s.name.lower() == wanted]
    return [
        s for s in matched
        if s.last_timestamp is not None and s.last_timestamp <= end_ts
    ]


def match_spans_by_annotation(spans, service_name: str, annotation: str,
                              value: Optional[bytes], end_ts: int
                              ) -> List[Span]:
    """Annotation-index match over a plain span list (see
    match_spans_by_name for why this is module-level)."""
    if annotation in CORE_ANNOTATIONS:
        return []
    name = service_name.lower()
    candidates = [
        s for s in spans if should_index(s) and name in s.service_names
    ]
    matched = []
    for s in candidates:
        if s.last_timestamp is None or s.last_timestamp > end_ts:
            continue
        if value is not None:
            ok = any(
                b.key == annotation and as_bytes(b.value) == value
                for b in s.binary_annotations
            )
        else:
            ok = any(a.value == annotation for a in s.annotations) or any(
                b.key == annotation for b in s.binary_annotations
            )
        if ok:
            matched.append(s)
    return matched


class InMemorySpanStore(SpanStore):
    def __init__(self):
        self._lock = threading.Lock()  # lock-order: 10 encode
        self.spans: List[Span] = []
        self.ttls: Dict[int, float] = {}
        # Windowed-analytics time-bucket width (s) for the exact-scan
        # heatmap — the daemon sets it from --window-seconds so a
        # memory-store deployment serves the same grid granularity a
        # device store would at the same flags.
        self.window_seconds = 60

    # -- writes ---------------------------------------------------------

    def apply(self, spans: Sequence[Span]) -> None:
        with self._lock:
            for span in spans:
                self.ttls[span.trace_id] = 1.0
            self.spans.extend(spans)

    def set_time_to_live(self, trace_id: int, ttl_seconds: float) -> None:
        with self._lock:
            self.ttls[trace_id] = ttl_seconds

    # -- reads (all under the same lock as writes, like the reference's
    #    synchronized `call`, SpanStore.scala:131) ------------------------

    def get_time_to_live(self, trace_id: int) -> float:
        with self._lock:
            return self.ttls[trace_id]

    def traces_exist(self, trace_ids: Sequence[int]) -> Set[int]:
        with self._lock:
            present = {s.trace_id for s in self.spans}
        return present & set(trace_ids)

    def get_spans_by_trace_ids(self, trace_ids: Sequence[int]) -> List[List[Span]]:
        with self._lock:
            snapshot = list(self.spans)
        out = []
        for tid in trace_ids:
            found = [s for s in snapshot if s.trace_id == tid]
            if found:
                out.append(found)
        return out

    def _spans_for_service(self, name: str) -> List[Span]:
        name = name.lower()
        with self._lock:
            snapshot = list(self.spans)
        return [s for s in snapshot if should_index(s) and name in s.service_names]

    def get_trace_ids_by_name(
        self,
        service_name: str,
        span_name: Optional[str],
        end_ts: int,
        limit: int,
    ) -> List[IndexedTraceId]:
        with self._lock:
            snapshot = list(self.spans)
        return _dedup_limit(
            match_spans_by_name(snapshot, service_name, span_name, end_ts),
            limit,
        )

    def get_trace_ids_by_annotation(
        self,
        service_name: str,
        annotation: str,
        value: Optional[bytes],
        end_ts: int,
        limit: int,
    ) -> List[IndexedTraceId]:
        # Core annotations are not indexed (SpanStore.scala:199).
        with self._lock:
            snapshot = list(self.spans)
        return _dedup_limit(
            match_spans_by_annotation(
                snapshot, service_name, annotation, value, end_ts
            ),
            limit,
        )

    def get_traces_duration(self, trace_ids: Sequence[int]) -> List[TraceIdDuration]:
        with self._lock:
            snapshot = list(self.spans)
        out = []
        for tid in trace_ids:
            ts = []
            for s in snapshot:
                if s.trace_id == tid:
                    if s.first_timestamp is not None:
                        ts.append(s.first_timestamp)
                    if s.last_timestamp is not None:
                        ts.append(s.last_timestamp)
            if ts:
                out.append(TraceIdDuration(tid, max(ts) - min(ts), min(ts)))
        return out

    def stored_span_count(self) -> float:
        with self._lock:
            return float(len(self.spans))

    def counters(self) -> Dict[str, float]:
        """Minimal store-stage counters (the /metrics hook every
        backend answers; the device store serves its counter block
        through the same shape)."""
        with self._lock:
            return {
                "spans_stored": float(len(self.spans)),
                "traces_stored": float(
                    len({s.trace_id for s in self.spans})
                ),
            }

    def get_all_service_names(self) -> Set[str]:
        with self._lock:
            snapshot = list(self.spans)
        return {n for s in snapshot for n in s.service_names if n}

    def get_span_names(self, service: str) -> Set[str]:
        return {s.name for s in self._spans_for_service(service) if s.name}

    # -- windowed analytics: the exact-scan oracle -----------------------
    # Host-backend twins of the device store's windowed Moments-sketch
    # reads (aggregate/windows.py), answered by scanning the raw span
    # list: EXACT values with the SAME attribution rules — owning
    # service (span.service_name, what the columnar encoder puts in
    # service_id), first_timestamp for time bucketing, and the "error"
    # annotation-value / binary-key convention. tests/test_windows.py
    # uses these as the memory oracle the sketch answers are gated
    # against; the API serves them for --memory-store parity.

    @staticmethod
    def _is_error_span(s: Span) -> bool:
        return (any(a.value == "error" for a in s.annotations)
                or any(b.key == "error" for b in s.binary_annotations))

    def _windowed_spans(self, service: str, start_us, end_us):
        service = service.lower()
        with self._lock:
            snapshot = list(self.spans)
        out = []
        for s in snapshot:
            svc = s.service_name
            ts = s.first_timestamp
            if svc is None or svc.lower() != service or ts is None:
                continue
            if start_us is not None and ts < start_us:
                continue
            if end_us is not None and ts >= end_us:
                continue
            out.append(s)
        return out

    def windowed_quantiles(self, service: str, qs,
                           start_us=None, end_us=None):
        durs = sorted(
            s.duration for s in self._windowed_spans(
                service, start_us, end_us)
            if s.duration is not None and s.duration >= 0)
        if not durs:
            return None
        n = len(durs)
        return [
            float(durs[min(int(round(
                min(max(q, 0.0), 1.0) * (n - 1))), n - 1)])
            for q in qs
        ]

    def slo_burn(self, service: str, objective: float = None,
                 windows_s=None, now_us=None):
        from zipkin_tpu_torch.aggregate import windows as win_mod

        objective = (win_mod.DEFAULT_OBJECTIVE if objective is None
                     else float(objective))
        windows_s = list(windows_s or win_mod.DEFAULT_BURN_WINDOWS_S)
        if now_us is None:
            ts = [s.first_timestamp
                  for s in self._windowed_spans(service, None, None)]
            now_us = (max(ts) + 1) if ts else 0
        budget = max(1.0 - objective, 1e-9)
        out = []
        for w_s in windows_s:
            spans = self._windowed_spans(
                service, int(now_us) - int(w_s) * 1_000_000,
                int(now_us))
            total = len(spans)
            errors = sum(1 for s in spans if self._is_error_span(s))
            rate = (errors / total) if total else 0.0
            out.append({
                "windowSeconds": int(w_s),
                "total": total,
                "errors": errors,
                "errorRate": rate,
                "burnRate": rate / budget,
            })
        return {"serviceName": service, "objective": objective,
                "nowTs": int(now_us), "windows": out}

    def latency_heatmap(self, service: str, start_us=None, end_us=None,
                        bands: int = None, bucket_s: int = None):
        """Exact grid: spans bucketed by first_timestamp // bucket_s
        (default: the store's window_seconds), durations histogrammed
        over ``bands`` log-spaced bands."""
        import math

        from zipkin_tpu_torch.aggregate import windows as win_mod

        bands = int(bands or win_mod.DEFAULT_HEATMAP_BANDS)
        bucket_s = int(bucket_s or self.window_seconds or 60)
        spans = self._windowed_spans(service, start_us, end_us)
        bucket_us = int(bucket_s) * 1_000_000
        by_bucket: Dict[int, list] = {}
        for s in spans:
            by_bucket.setdefault(s.first_timestamp // bucket_us,
                                 []).append(s)
        buckets = sorted(by_bucket)
        durs = [s.duration for s in spans
                if s.duration is not None and s.duration >= 0]
        lo = math.log(max(min(durs), 1.0)) if durs else 0.0
        hi = math.log(max(max(durs), 1.0) + 1.0) if durs else 1.0
        if hi <= lo:
            hi = lo + 1.0
        edges = [math.exp(lo + (hi - lo) * i / bands)
                 for i in range(bands + 1)]
        grid = []
        for b in buckets:
            row = [0.0] * bands
            for s in by_bucket[b]:
                if s.duration is None or s.duration < 0:
                    continue
                v = max(float(s.duration), 1.0)
                i = min(int((math.log(v) - lo) / (hi - lo) * bands),
                        bands - 1)
                row[max(i, 0)] += 1.0
            grid.append(row)
        return {
            "serviceName": service,
            "bucketSeconds": int(bucket_s),
            "bucketStartsTs": [b * bucket_us for b in buckets],
            "bandEdgesMicros": [round(e, 1) for e in edges],
            "cells": grid,
            "totals": [len(by_bucket[b]) for b in buckets],
            "errors": [
                sum(1 for s in by_bucket[b] if self._is_error_span(s))
                for b in buckets
            ],
        }


def _dedup_limit(matched: List[Span], limit: int) -> List[IndexedTraceId]:
    from zipkin_tpu_torch.store.base import dedup_rank_limit

    return dedup_rank_limit(
        ((s.trace_id, s.last_timestamp) for s in matched
         if s.last_timestamp is not None),
        limit,
    )

