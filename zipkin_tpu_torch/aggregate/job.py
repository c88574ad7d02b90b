"""Dependency-link aggregation jobs (the port's copy of
``zipkin_tpu/aggregate/job.py``)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from zipkin_tpu_torch.models.dependencies import (
    Dependencies,
    DependencyLink,
    Moments,
    merge_dependency_links,
)
from zipkin_tpu_torch.models.span import Span, merge_by_span_id


def aggregate_spans(
    spans: Iterable[Span],
    start_ts: Optional[float] = None,
    end_ts: Optional[float] = None,
) -> Dependencies:
    """Pure-python oracle with the batch job's exact semantics
    (ZipkinAggregateJob.scala:21-46):

    1. merge span halves by (id, trace_id); drop invalid merges;
    2. join children to parents on (parent_id, trace_id);
    3. one Moments(child.duration) per joined pair, summed per
       (parent.service, child.service) link.
    """
    by_key: Dict[Tuple[int, int], Span] = {}
    for s in spans:
        key = (s.id, s.trace_id)
        by_key[key] = by_key[key].merge(s) if key in by_key else s
    merged = {k: s for k, s in by_key.items() if s.is_valid()}

    links: List[DependencyLink] = []
    ts_seen: List[int] = []
    for (sid, tid), child in merged.items():
        if child.parent_id is None:
            continue
        parent = merged.get((child.parent_id, tid))
        if parent is None:
            continue
        p_name, c_name = parent.service_name, child.service_name
        if p_name is None or c_name is None:
            continue
        d = child.duration
        moments = Moments.of(float(d)) if d is not None else Moments.zero()
        links.append(DependencyLink(p_name, c_name, moments))
        if child.first_timestamp is not None:
            ts_seen.append(child.first_timestamp)
            ts_seen.append(child.last_timestamp)
    if start_ts is None:
        start_ts = min(ts_seen) if ts_seen else float("inf")
    if end_ts is None:
        end_ts = max(ts_seen) if ts_seen else float("-inf")
    return Dependencies(
        float(start_ts), float(end_ts),
        tuple(merge_dependency_links(links)),
    )


def links_from_bank(bank, services_dict, n_services: int
                    ) -> List[DependencyLink]:
    """Decode a [S*S, 5] device Moments bank into DependencyLinks."""
    bank = np.asarray(bank, np.float64)
    links = []
    for li in np.flatnonzero(bank[:, 0] > 0):
        parent, child = divmod(int(li), n_services)
        if parent >= len(services_dict) or child >= len(services_dict):
            continue
        links.append(DependencyLink(
            services_dict.decode(parent), services_dict.decode(child),
            Moments.from_central(*bank[li]),
        ))
    return links


def dependencies_from_bank(bank, services_dict, n_services: int,
                           ts_min: float, ts_max: float) -> Dependencies:
    links = links_from_bank(bank, services_dict, n_services)
    if not links and ts_min > ts_max:
        return Dependencies.zero()
    return Dependencies(float(ts_min), float(ts_max), tuple(links))


def recompute_dependencies(store) -> Dependencies:
    """Re-derive dependencies from a TorchSpanStore's live span rows
    (ignores the streaming banks) — the idempotent-rerunnable batch
    job. Only sees spans still in retention, unlike the streaming bank.
    Holds the store's state lock over the join and the copy of the bank
    (the reference takes its shared read lock there)."""
    from zipkin_tpu_torch.store.device import recompute_dep_moments

    with store._state_lock:
        st = store.state
        bank = recompute_dep_moments(st).cpu().numpy()
        ts_min, ts_max = float(st.ts_min), float(st.ts_max)
    return dependencies_from_bank(
        bank,
        store.dicts.services,
        store.config.max_services,
        ts_min,
        ts_max,
    )


class IncrementalAggregator:
    """Resumable aggregation over a span feed (AnormAggregator.scala:32-90).

    Processes spans in batches of at most ``batch_size`` (the reference's
    10k bound), folds each batch's links into the running Dependencies,
    and tracks the aggregated high-water mark so a restart resumes from
    ``resume_from()`` — the MAX(end_ts)-in-zipkin_dependencies behavior.
    """

    BATCH_SIZE = 10_000

    def __init__(self, batch_size: int = BATCH_SIZE,
                 resume_ts: Optional[float] = None):
        self.batch_size = batch_size
        self.deps = Dependencies.zero()
        self._resume_ts = resume_ts

    def resume_from(self) -> Optional[float]:
        """Timestamp to restart the feed from after a crash."""
        if self.deps.end_time > self.deps.start_time:
            return self.deps.end_time
        return self._resume_ts

    def offer(self, spans: Sequence[Span]) -> None:
        resume = self._resume_ts
        if resume is not None:
            spans = [
                s for s in spans
                if s.last_timestamp is None or s.last_timestamp > resume
            ]
        # Dependency joins are trace-local, so batches are packed on
        # whole-trace boundaries: the per-batch monoid fold then equals
        # the one-shot aggregate.
        by_trace: Dict[int, List[Span]] = {}
        for s in spans:
            by_trace.setdefault(s.trace_id, []).append(s)
        batch: List[Span] = []
        for trace_spans in by_trace.values():
            if batch and len(batch) + len(trace_spans) > self.batch_size:
                self.deps = self.deps + aggregate_spans(batch)
                batch = []
            batch.extend(trace_spans)
        if batch:
            self.deps = self.deps + aggregate_spans(batch)

    def result(self) -> Dependencies:
        return self.deps
