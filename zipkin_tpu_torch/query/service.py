"""QueryService: getTraceIds slice/intersect/order semantics + trace reads.

Reference: ThriftQueryService.scala:32-197 and the older
QueryService.scala:39-511, re-expressed over the SpanStore SPI. The RPC
framing (thrift) is replaced by plain python + the JSON HTTP layer in
zipkin_tpu_torch.api; the semantics — slice queries, probe-then-align
intersection with the one-minute pad, order-by with batched duration
fetches — carry over.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from zipkin_tpu_torch.models.span import Span
from zipkin_tpu_torch.models.trace import Trace, TraceCombo, TraceSummary, TraceTimeline
from zipkin_tpu_torch.query.adjusters import TimeSkewAdjuster
from zipkin_tpu_torch.query.engine import DEFAULT_COALESCE_WINDOW_S, QueryEngine
from zipkin_tpu_torch.query.request import (
    Order,
    QueryException,
    QueryRequest,
    QueryResponse,
)
from zipkin_tpu_torch.store.base import IndexedTraceId, SpanStore

# Reference constants (zipkin-query/.../Constants.scala:26,
# ThriftQueryService.scala:33).
TRACE_TIMESTAMP_PADDING_US = 60 * 1_000_000
DURATION_FETCH_BATCH = 500

__all__ = [
    "DEFAULT_COALESCE_WINDOW_S", "DURATION_FETCH_BATCH", "QueryService",
    "TRACE_TIMESTAMP_PADDING_US",
]


class QueryService:
    def __init__(
        self,
        store: SpanStore,
        adjust_clock_skew: bool = True,
        duration_batch: int = DURATION_FETCH_BATCH,
        coalesce_window_s: Optional[float] = None,
        registry=None,
        engine: Optional[QueryEngine] = None,
    ):
        self.store = store
        self.adjust_clock_skew = adjust_clock_skew
        self.duration_batch = duration_batch
        # EVERY read routes through the resident query engine
        # (query/engine.py): sketch-answerable queries come off the
        # host mirror with zero device round-trips, trace-id lookups
        # share the standing executor's launches, and repeat reads hit
        # the frontier-keyed result cache — with answers exactly equal
        # to direct store execution's. ``coalesce_window_s`` is the
        # executor's idle-entry micro-batch window (None = 2 ms for
        # batched device stores, 0 for host backends).
        self.engine = engine or QueryEngine(
            store, window_s=coalesce_window_s, registry=registry)
        # Back-compat alias: the executor exposes the coalescer's
        # run()/accounting surface (ApiServer's gauges read it).
        self.coalescer = self.engine.executor

    def close(self) -> None:
        """Stop the engine's standing executor thread and deregister
        it from the store. Library consumers embedding a QueryService
        without a Collector own this call; under the daemon,
        Collector.close() reaches the same engines via the store
        registry, so both orders are safe (close is idempotent)."""
        self.engine.close()

    def _multi(self, queries) -> List[List[IndexedTraceId]]:
        return self.engine.get_trace_ids_multi(queries)

    # -- getTraceIds ----------------------------------------------------

    def get_trace_ids(self, qr: QueryRequest) -> QueryResponse:
        if not qr.service_name:
            raise QueryException("No service name provided")
        slices = self._slice_queries(qr)
        if not slices:
            ids = self._multi(
                [("name", qr.service_name, None, qr.end_ts, qr.limit)]
            )[0]
            return self._response(ids, qr)
        if len(slices) == 1:
            return self._response(self._query_slices(slices, qr), qr)
        # Multi-slice: probe each slice at limit 1 to find the latest
        # timestamp they can all reach, pad by one minute, re-query all
        # slices aligned there, then intersect. Both rounds ride the
        # store's batched multi-query path (one probe pass per round
        # on the device store, instead of one per slice) — and the
        # cross-request coalescer on top of it.
        probes = [
            i for ids in self._multi(
                [self._multi_query(s, qr, qr.end_ts, 1) for s in slices]
            ) for i in ids
        ]
        probe_ts = [i.timestamp for i in probes]
        aligned = (min(probe_ts) if probe_ts else 0) + TRACE_TIMESTAMP_PADDING_US
        per_slice = self._multi([
            self._multi_query(s, qr, aligned, qr.limit) for s in slices
        ])
        common = _intersect(per_slice)
        if not common:
            # Nothing common: report the best next endTs for pagination.
            mins = [
                min((i.timestamp for i in ids), default=0) for ids in per_slice
            ]
            return self._response([], qr, end_ts=max(mins, default=0))
        return self._response(common, qr)

    def _slice_queries(self, qr: QueryRequest) -> List[tuple]:
        slices: List[tuple] = []
        if qr.span_name:
            slices.append(("span", qr.span_name, None))
        for a in qr.annotations:
            slices.append(("annotation", a, None))
        for b in qr.binary_annotations:
            slices.append(("annotation", b.key, b.value))
        return slices

    @staticmethod
    def _multi_query(s, qr: QueryRequest, end_ts: int, limit: int) -> tuple:
        """One slice as a SpanStore.get_trace_ids_multi query tuple."""
        kind, key, value = s
        if kind == "span":
            return ("name", qr.service_name, key, end_ts, limit)
        return ("annotation", qr.service_name, key, value, end_ts, limit)

    def _query_slices(self, slices, qr: QueryRequest, limit: Optional[int] = None
                      ) -> List[IndexedTraceId]:
        per_slice = self._multi([
            self._multi_query(s, qr, qr.end_ts, limit or qr.limit)
            for s in slices
        ])
        return [i for ids in per_slice for i in ids]

    def _response(self, ids: Sequence[IndexedTraceId], qr: QueryRequest,
                  end_ts: int = -1) -> QueryResponse:
        sorted_ids = self._sorted_trace_ids(ids, qr.limit, qr.order)
        if not sorted_ids:
            return QueryResponse((), -1, end_ts)
        ts = [i.timestamp for i in ids]
        return QueryResponse(tuple(sorted_ids), min(ts), max(ts))

    def _sorted_trace_ids(self, ids: Sequence[IndexedTraceId], limit: int,
                          order: Order) -> List[int]:
        if order is Order.NONE:
            return [i.trace_id for i in ids][:limit]
        if order in (Order.TIMESTAMP_DESC, Order.TIMESTAMP_ASC):
            rev = order is Order.TIMESTAMP_DESC
            return [
                i.trace_id
                for i in sorted(ids, key=lambda x: x.timestamp, reverse=rev)
            ][:limit]
        # Duration orders: fetch durations in batches of 500
        # (ThriftQueryService.scala:33, QueryService.scala:493-511).
        tids = [i.trace_id for i in ids]
        durations = []
        for i in range(0, len(tids), self.duration_batch):
            durations.extend(
                self.engine.get_traces_duration(
                    tids[i:i + self.duration_batch])
            )
        rev = order is Order.DURATION_DESC
        return [
            d.trace_id
            for d in sorted(durations, key=lambda x: x.duration, reverse=rev)
        ][:limit]

    # -- trace reads ----------------------------------------------------

    def get_traces_by_ids(self, trace_ids: Sequence[int],
                          adjust: Optional[bool] = None) -> List[Trace]:
        adjust = self.adjust_clock_skew if adjust is None else adjust
        found = self.engine.get_spans_by_trace_ids(trace_ids)
        traces = [Trace(spans) for spans in found]
        if adjust:
            adjuster = TimeSkewAdjuster()
            traces = [adjuster.adjust(t) for t in traces]
        return traces

    def get_trace_summaries_by_ids(self, trace_ids, adjust=None
                                   ) -> List[TraceSummary]:
        out = []
        for t in self.get_traces_by_ids(trace_ids, adjust):
            s = TraceSummary.from_trace(t)
            if s is not None:
                out.append(s)
        return out

    def get_trace_timelines_by_ids(self, trace_ids, adjust=None
                                   ) -> List[TraceTimeline]:
        out = []
        for t in self.get_traces_by_ids(trace_ids, adjust):
            tl = TraceTimeline.from_trace(t)
            if tl is not None:
                out.append(tl)
        return out

    def get_trace_combos_by_ids(self, trace_ids, adjust=None
                                ) -> List[TraceCombo]:
        return [
            TraceCombo.from_trace(t)
            for t in self.get_traces_by_ids(trace_ids, adjust)
        ]

    def trace_exists(self, trace_id: int) -> bool:
        return bool(self.engine.traces_exist([trace_id]))

    def traces_exist(self, trace_ids: Sequence[int]):
        """Which of ``trace_ids`` have any stored span — the thrift
        ``tracesExist(ids)`` method (zipkinQuery.thrift:154), served by
        every backend's batched membership read (the device store answers
        through the trace-membership gid buckets when their exactness
        gate holds)."""
        return self.engine.traces_exist(trace_ids)

    # -- catalogs / aggregates -----------------------------------------

    def get_service_names(self):
        return self.engine.get_all_service_names()

    def get_span_names(self, service: str):
        return self.engine.get_span_names(service)

    def get_dependencies(self, start_ts: Optional[int] = None,
                         end_ts: Optional[int] = None):
        """Dependencies from the store's aggregate state, optionally
        restricted to [start_ts, end_ts]
        (Aggregates.getDependencies(startDate, endDate),
        Aggregates.scala:26-31; QueryService.scala:393).

        Stores without dependency aggregation (the in-memory reference
        store) behave like NullAggregates and return zero."""
        from zipkin_tpu_torch.models.dependencies import Dependencies

        if not hasattr(self.engine.store, "get_dependencies"):
            return Dependencies.zero()
        return self.engine.get_dependencies(start_ts, end_ts)

    def get_top_annotations(self, service: str, k: int = 10) -> List[str]:
        if not hasattr(self.engine.store, "top_annotations"):
            return []
        return [a for a, _ in self.engine.top_annotations(service, k)]

    def get_top_key_value_annotations(self, service: str, k: int = 10
                                      ) -> List[str]:
        if not hasattr(self.engine.store, "top_binary_keys"):
            return []
        return [a for a, _ in self.engine.top_binary_keys(service, k)]

    def get_service_duration_quantiles(self, service: str, qs):
        """Per-service latency percentiles off the device histogram
        (BASELINE config #4; the aggregates-page data the reference
        computed offline). Stores without the histogram return None."""
        if not hasattr(self.engine.store,
                       "service_duration_quantiles"):
            return None
        return self.engine.service_duration_quantiles(service, list(qs))

    # -- windowed analytics (aggregate/windows.py) ----------------------
    # Time-scoped latency/error analytics off the windowed
    # Moments-sketch arena — the engine's sketch tier on device
    # stores, the backend's exact scan elsewhere; None when neither
    # can serve.

    def get_windowed_quantiles(self, service: str, qs,
                               start_us=None, end_us=None):
        return self.engine.windowed_quantiles(
            service, list(qs), start_us=start_us, end_us=end_us)

    def get_slo_burn(self, service: str, objective=None,
                     windows_s=None, now_us=None):
        return self.engine.slo_burn(
            service, objective=objective, windows_s=windows_s,
            now_us=now_us)

    def get_latency_heatmap(self, service: str, start_us=None,
                            end_us=None, bands=None):
        return self.engine.latency_heatmap(
            service, start_us=start_us, end_us=end_us, bands=bands)

    def set_trace_time_to_live(self, trace_id: int, ttl_s: float) -> None:
        self.store.set_time_to_live(trace_id, ttl_s)

    def get_trace_time_to_live(self, trace_id: int) -> float:
        return self.store.get_time_to_live(trace_id)

    # -- remaining thrift surface (zipkinQuery.thrift) -----------------

    # Candidate window for the duration/service aggregation methods —
    # the reference aggregates over the traces its index returns for
    # the slice, bounded like any index read.
    SLICE_AGG_LIMIT = 100

    def _slice_trace_spans(self, time_stamp: int, service_name: str,
                           rpc_name: Optional[str], limit: int):
        """Traces matched by the (service, rpc) name index at or before
        ``time_stamp`` — the shared fetch behind getSpanDurations and
        getServiceNamesToTraceIds. Rides the coalescer like every other
        trace-id lookup."""
        if not service_name:
            raise QueryException("No service name provided")
        ids = self._multi([
            ("name", service_name, rpc_name, time_stamp, limit)
        ])[0]
        return self.engine.get_spans_by_trace_ids(
            [i.trace_id for i in ids])

    def get_span_durations(self, time_stamp: int, service_name: str,
                           rpc_name: str,
                           limit: Optional[int] = None
                           ) -> Dict[str, List[int]]:
        """``getSpanDurations(time_stamp, server_service_name,
        rpc_name)`` (zipkinQuery.thrift): for the traces the name index
        matches, the durations (µs) of every span named ``rpc_name``,
        grouped by the span's owning service — the data behind the
        reference's duration-histogram aggregation page."""
        wanted = rpc_name.lower()
        out: Dict[str, List[int]] = {}
        for spans in self._slice_trace_spans(
                time_stamp, service_name, rpc_name,
                limit or self.SLICE_AGG_LIMIT):
            for s in spans:
                if s.name.lower() != wanted or s.duration is None:
                    continue
                svc = s.service_name
                if svc is not None:
                    out.setdefault(svc.lower(), []).append(s.duration)
        return out

    def get_service_names_to_trace_ids(self, time_stamp: int,
                                       service_name: str,
                                       rpc_name: Optional[str],
                                       limit: Optional[int] = None
                                       ) -> Dict[str, List[int]]:
        """``getServiceNamesToTraceIds`` (zipkinQuery.thrift): for the
        traces the (service, rpc) index matches, every service name
        participating in each trace, mapped to the trace ids it appears
        in — the cross-service fan-out view."""
        out: Dict[str, List[int]] = {}
        for spans in self._slice_trace_spans(
                time_stamp, service_name, rpc_name,
                limit or self.SLICE_AGG_LIMIT):
            if not spans:
                continue
            tid = spans[0].trace_id
            names = set()
            for s in spans:
                names.update(s.service_names)
            for n in sorted(names):
                out.setdefault(n, []).append(tid)
        return out

    def get_data_time_to_live(self) -> int:
        """``getDataTimeToLive`` (zipkinQuery.thrift): the storage
        tier's span retention in seconds. Backends with a configured
        TTL expose ``data_ttl_s``; the device ring (eviction-retained)
        and the reference default both answer the Cassandra span TTL
        (CassieSpanStore.scala:47)."""
        from zipkin_tpu_torch.store.base import DEFAULT_SPAN_TTL_S

        ttl = getattr(self.store, "data_ttl_s", None)
        return int(ttl if ttl is not None else DEFAULT_SPAN_TTL_S)


def _intersect(per_slice: List[List[IndexedTraceId]]) -> List[IndexedTraceId]:
    """Ids present in every slice, stamped with their max timestamp
    (traceIdsIntersect, ThriftQueryService.scala:92)."""
    if not per_slice:
        return []
    maps: List[Dict[int, List[int]]] = []
    for ids in per_slice:
        m: Dict[int, List[int]] = {}
        for i in ids:
            m.setdefault(i.trace_id, []).append(i.timestamp)
        maps.append(m)
    common = set(maps[0])
    for m in maps[1:]:
        common &= set(m)
    return [
        IndexedTraceId(tid, max(ts for m in maps for ts in m[tid]))
        for tid in common
    ]
