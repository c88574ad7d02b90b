"""Cold-tier query mixin: zone-map-pruned reads over a SegmentDirectory.

The port's copy of ``zipkin_tpu/store/archive/coldquery.py``.

The query half of the cold tier, factored out of ``TieredSpanStore``
so two hosts share ONE implementation of the pruning + oracle-match
semantics:

- ``TieredSpanStore`` (store/archive/tiered.py) — cold answers unioned
  with the hot device ring's;
- ``ReplicaSpanStore`` (store/replica.py) — a device-free read replica
  whose ENTIRE row store is segments sealed from shipped WAL records.

Host contract: ``self.archive`` (a SegmentDirectory), ``self.dicts``
(the DictionarySet that encoded the rows), and ``self._segments()`` /
``self._pruned(probe)`` — snapshot hooks the host implements so it can
interpose its visibility barrier (the tiered store waits on the hot
store's seal barrier; the replica snapshots under its apply lock).

Candidate semantics are the memory-oracle's (store/memory.py match
functions over decoded rows) behind exact zone-map pruning (service
bitmap, tagged-key CMS, ts range, trace bloom) — bit-for-bit the
reference store's answers, without decoding pruned segments.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from zipkin_tpu_torch.models.span import Span
from zipkin_tpu_torch.ops.quantile import quantiles_host
from zipkin_tpu_torch.store.archive import sketches as SK
from zipkin_tpu_torch.store.archive.segment import (
    TAG_ANN,
    TAG_BKEY,
    TAG_BVAL,
    TAG_NAME,
)
from zipkin_tpu_torch.store.base import (
    IndexedTraceId,
    TraceIdDuration,
    dedup_rank_limit,
    resolve_annotation_query,
)
from zipkin_tpu_torch.store.memory import (
    match_spans_by_annotation,
    match_spans_by_name,
)


class ColdQueries:
    """Zone-pruned segment reads (see module docstring for the host
    contract)."""

    # -- visibility hooks (hosts override to add their barrier) ---------

    def _segments(self):
        return self.archive.snapshot()

    def _pruned(self, probe):
        return self.archive.pruned_scan(probe)

    # -- catalogs -------------------------------------------------------

    def cold_service_ids(self) -> Set[int]:
        """Service ids present in any cold segment, from zone-map
        metadata alone (host memory, no decompression) — the sketch
        tier's cold half of getAllServiceNames (exact: zone service
        sets are exact per segment, see archive/segment.py)."""
        out: Set[int] = set()
        for seg in self._segments():
            out.update(seg.zone.service_ids)
        return out

    def cold_span_names(self, service: str) -> Set[str]:
        """Span names of ``service`` over decoded cold rows (segments
        without the service pruned by the exact zone service set)."""
        out: Set[str] = set()
        svc = self.dicts.services.get(service.lower())
        if svc is None:
            return out
        for seg in self._pruned(
                lambda s: svc in s.zone.service_ids):
            _, _, spans = self.archive.decoded(seg)
            out.update(
                s.name for s in match_spans_by_name(
                    spans, service, None, (1 << 62))
                if s.name
            )
        return out

    # -- trace reads ----------------------------------------------------

    def _cold_segments_for_traces(self, qids: Set[int]):
        return self._pruned(
            lambda seg: any(seg.zone.may_contain_trace(t) for t in qids)
        )

    def cold_rows_for_traces(self, qids: Set[int],
                             rows: Optional[Dict[int, Dict[int, Span]]]
                             = None) -> Dict[int, Dict[int, Span]]:
        """{signed trace id: {gid: span}} over matching cold rows,
        merged INTO ``rows`` (cold copy wins on gid overlap: captured
        before any ring could drop its annotation rows)."""
        from zipkin_tpu_torch.columnar.encode import to_signed64

        rows = {} if rows is None else rows
        for seg in self._cold_segments_for_traces(qids):
            batch, gids, spans = self.archive.decoded(seg)
            hit = np.isin(batch.trace_id,
                          np.fromiter(qids, np.int64, len(qids)))
            for i in np.flatnonzero(hit):
                span = spans[int(i)]
                rows.setdefault(to_signed64(span.trace_id), {})[
                    int(gids[i])] = span
        return rows

    def cold_traces_exist(self, qids: Dict[int, int]) -> Set:
        """Resolve {signed id: original id} membership against the
        trace-id columns alone (no row decode); consumes resolved
        entries from ``qids`` and returns the original ids found."""
        found = set()
        for seg in self._cold_segments_for_traces(set(qids)):
            if not qids:
                break
            tid_col = seg.column("trace_id")
            stids = np.fromiter(qids, np.int64, len(qids))
            for stid in stids[np.isin(stids, tid_col)]:
                found.add(qids.pop(int(stid)))
        return found

    def cold_duration_bounds(self, canon: Dict[int, int],
                             bounds: Dict[int, list]) -> Dict[int, list]:
        """Widen {original id: [min_ts, max_ts]} with the cold rows'
        timestamp bounds (column-only read, one membership pass)."""
        stids = np.fromiter(canon, np.int64, len(canon))
        for seg in self._cold_segments_for_traces(set(canon)):
            tid_col = seg.column("trace_id")
            hit = np.isin(tid_col, stids)
            if not hit.any():
                continue
            tid_hit = tid_col[hit]
            tsf_hit = seg.column("ts_first")[hit]
            tsl_hit = seg.column("ts_last")[hit]
            for stid in np.unique(tid_hit):
                orig = canon[int(stid)]
                m = tid_hit == stid
                tsf = tsf_hit[m]
                tsl = tsl_hit[m]
                ts = np.concatenate([tsf[tsf >= 0], tsl[tsl >= 0]])
                if not ts.size:
                    continue
                b = bounds.setdefault(orig, [int(ts.min()),
                                             int(ts.max())])
                b[0] = min(b[0], int(ts.min()))
                b[1] = max(b[1], int(ts.max()))
        return bounds

    # -- index reads ----------------------------------------------------

    def _cold_ids_by_name(self, service_name: str,
                          span_name: Optional[str], end_ts: int,
                          limit: int) -> List[IndexedTraceId]:
        dicts = self.dicts
        svc = dicts.services.get(service_name.lower())
        if svc is None or limit <= 0:
            return []
        name_lc = (dicts.span_names.get(span_name.lower())
                   if span_name is not None else None)
        if span_name is not None and name_lc is None:
            return []

        def probe(seg):
            z = seg.zone
            if svc not in z.service_ids or not z.may_match_end_ts(end_ts):
                return False
            if name_lc is not None and not z.may_contain_key(
                    TAG_NAME, svc, name_lc):
                return False
            return True

        return self._cold_match(
            probe,
            lambda spans: match_spans_by_name(
                spans, service_name, span_name, end_ts),
            limit,
        )

    def _cold_ids_by_annotation(self, service_name: str, annotation: str,
                                value: Optional[bytes], end_ts: int,
                                limit: int) -> List[IndexedTraceId]:
        from zipkin_tpu_torch.models.constants import CORE_ANNOTATIONS

        dicts = self.dicts
        if annotation in CORE_ANNOTATIONS or limit <= 0:
            return []
        svc = dicts.services.get(service_name.lower())
        if svc is None:
            return []
        resolved = resolve_annotation_query(dicts, annotation, value)
        if resolved is None:
            return []
        ann_value, bann_key, bann_value, bann_value2 = resolved

        def probe(seg):
            z = seg.zone
            if svc not in z.service_ids or not z.may_match_end_ts(end_ts):
                return False
            if value is not None:
                return any(
                    v >= 0 and z.may_contain_key(TAG_BVAL, svc,
                                                 bann_key, v)
                    for v in (bann_value, bann_value2)
                )
            may = False
            if ann_value >= 0:
                may = z.may_contain_key(TAG_ANN, svc, ann_value)
            if not may and bann_key >= 0:
                may = z.may_contain_key(TAG_BKEY, svc, bann_key)
            return may

        return self._cold_match(
            probe,
            lambda spans: match_spans_by_annotation(
                spans, service_name, annotation, value, end_ts),
            limit,
        )

    def _cold_match(self, probe, matcher, limit: int
                    ) -> List[IndexedTraceId]:
        import time

        t0 = time.perf_counter()
        cands = []
        for seg in self._pruned(probe):
            _, _, spans = self.archive.decoded(seg)
            cands.extend(
                (s.trace_id, s.last_timestamp) for s in matcher(spans)
                if s.last_timestamp is not None
            )
        self.archive.h_cold_query.observe(time.perf_counter() - t0)
        return dedup_rank_limit(cands, limit)

    # -- cold-only sketch answers (no row decompression) ----------------

    def cold_duration_quantiles(self, service: str, qs: Sequence[float]
                                ) -> Optional[List[float]]:
        """Per-service latency quantiles over cold rows, answered from
        segment zone-map histograms alone (same ops.quantile geometry
        as the device svc_hist)."""
        svc = self.dicts.services.get(service.lower())
        if svc is None:
            return None
        counts = None
        for seg in self._segments():
            row = seg.zone.dur_hist.get(svc)
            if row is not None:
                counts = row if counts is None else counts + row
        if counts is None:
            return None
        return quantiles_host(counts, self.archive.params.hist_gamma,
                              1.0, list(qs))

    def cold_estimated_unique_traces(self) -> float:
        """Distinct-trace estimate over the cold tier from merged
        segment HLLs."""
        regs = None
        for seg in self._segments():
            regs = (seg.zone.hll if regs is None
                    else SK.hll_merge(regs, seg.zone.hll))
        if regs is None:
            return 0.0
        return SK.hll_estimate(regs)


def union_topk(limit: int, *tiers) -> List[IndexedTraceId]:
    """Re-rank the union of per-tier top-``limit`` lists — exact: a
    trace absent from BOTH per-tier top lists is outranked by ``limit``
    distinct traces globally (the topk_ids_with_escalation argument
    applied across tiers)."""
    return dedup_rank_limit(
        [(i.trace_id, i.timestamp) for ids in tiers for i in ids],
        limit,
    )


def durations_from_bounds(trace_ids, bounds: Dict[int, list]
                          ) -> List[TraceIdDuration]:
    return [
        TraceIdDuration(t, bounds[t][1] - bounds[t][0], bounds[t][0])
        for t in trace_ids if t in bounds
    ]
