"""Trace assembly & projections (the port's copy of
``zipkin_tpu/models/trace.py``).

Parity targets (reference):
- ``Trace`` incl. mergeBySpanId / getSpanTree / toSpanDepths —
  zipkin-common/.../query/Trace.scala:36,178,211,147
- ``SpanTreeEntry`` — query/SpanTreeEntry.scala
- ``TraceSummary`` — query/TraceSummary.scala:26,53
- ``TraceTimeline`` — query/TraceTimeline.scala
- ``TraceCombo`` — query/TraceCombo.scala
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from zipkin_tpu_torch.models.span import Annotation, BinaryAnnotation, Endpoint, Span, merge_by_span_id


@dataclass
class SpanTreeEntry:
    """A span plus its children, forming the trace tree."""

    span: Span
    children: List["SpanTreeEntry"] = field(default_factory=list)

    def to_list(self) -> List[Span]:
        out = [self.span]
        for c in self.children:
            out.extend(c.to_list())
        return out

    def depths(self, start_depth: int = 1) -> Dict[int, int]:
        """span id -> depth, root at ``start_depth`` (SpanTreeEntry.depths)."""
        out = {self.span.id: start_depth}
        for c in self.children:
            out.update(c.depths(start_depth + 1))
        return out


@dataclass(frozen=True)
class Trace:
    """A bundle of spans belonging to one trace (query/Trace.scala:36).

    ``spans`` is the merged-by-span-id list sorted by first-annotation
    timestamp (missing timestamps sort last), as in Trace.scala:38-44.
    """

    spans: Tuple[Span, ...]

    def __init__(self, spans: Sequence[Span]):
        merged = merge_by_span_id(spans)
        merged.sort(
            key=lambda s: s.first_timestamp
            if s.first_timestamp is not None
            else float("inf")
        )
        object.__setattr__(self, "spans", tuple(merged))

    @property
    def id(self) -> Optional[int]:
        return self.spans[0].trace_id if self.spans else None

    def get_root_span(self) -> Optional[Span]:
        for s in self.spans:
            if s.parent_id is None:
                return s
        return None

    def get_root_most_span(self) -> Optional[Span]:
        """Root span, or the span closest to the root if the root is missing
        (Trace.scala getRootMostSpan)."""
        root = self.get_root_span()
        if root is not None:
            return root
        if not self.spans:
            return None
        by_id = self.id_to_span_map()
        span = self.spans[0]
        seen = set()
        while (
            span.parent_id is not None
            and span.parent_id in by_id
            and span.id not in seen
        ):
            seen.add(span.id)
            span = by_id[span.parent_id]
        return span

    def get_span_by_id(self, span_id: int) -> Optional[Span]:
        for s in self.spans:
            if s.id == span_id:
                return s
        return None

    def id_to_span_map(self) -> Dict[int, Span]:
        return {s.id: s for s in self.spans}

    # -- time ----------------------------------------------------------

    def start_and_end_timestamp(self) -> Optional[Tuple[int, int]]:
        ts = [a.timestamp for s in self.spans for a in s.annotations]
        if not ts:
            return None
        return (min(ts), max(ts))

    @property
    def duration(self) -> int:
        se = self.start_and_end_timestamp()
        return 0 if se is None else se[1] - se[0]

    # -- structure ------------------------------------------------------

    @property
    def endpoints(self) -> frozenset:
        return frozenset(e for s in self.spans for e in s.endpoints)

    @property
    def services(self) -> frozenset:
        return frozenset(n for s in self.spans for n in s.service_names)

    def service_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.spans:
            for n in s.service_names:
                out[n] = out.get(n, 0) + 1
        return out

    def get_span_tree(
        self,
        root: Span,
        children_index: Optional[Dict[int, List[Span]]] = None,
        _visited: Optional[set] = None,
    ) -> SpanTreeEntry:
        """Build the tree under ``root`` (Trace.scala:211).

        Malformed traces can contain parent-id cycles; the visited guard
        breaks them instead of recursing forever.
        """
        if children_index is None:
            children_index = {}
            for s in self.spans:
                if s.parent_id is not None:
                    children_index.setdefault(s.parent_id, []).append(s)
        if _visited is None:
            _visited = set()
        _visited.add(root.id)
        entry = SpanTreeEntry(root)
        for child in children_index.get(root.id, ()):  # insertion (time) order
            if child.id in _visited:
                continue
            entry.children.append(
                self.get_span_tree(child, children_index, _visited)
            )
        return entry

    def to_span_depths(self) -> Optional[Dict[int, int]]:
        """span id -> depth map from the root-most span (Trace.scala:147)."""
        root = self.get_root_most_span()
        if root is None:
            return None
        return self.get_span_tree(root).depths()


# ---------------------------------------------------------------------------
# Projections


@dataclass(frozen=True)
class SpanTimestamp:
    """Per-span-name start/end used by summary aggregation
    (query/TraceSummary.scala SpanTimestamp)."""

    name: str
    start_timestamp: int
    end_timestamp: int


@dataclass(frozen=True)
class TraceSummary:
    """Condensed trace view (query/TraceSummary.scala:26): trace id, time
    range, per-span timestamps, and involved endpoints. ``service_counts``
    is an extra convenience for the web UI's summary rendering."""

    trace_id: int
    start_timestamp: int
    end_timestamp: int
    duration_micro: int
    span_timestamps: Tuple[SpanTimestamp, ...]
    endpoints: Tuple[Endpoint, ...]
    service_counts: Tuple[Tuple[str, int], ...]

    @staticmethod
    def from_trace(trace: Trace) -> Optional["TraceSummary"]:
        if trace.id is None:
            return None
        se = trace.start_and_end_timestamp()
        if se is None:
            return None
        span_ts = tuple(
            SpanTimestamp(s.name, s.first_timestamp, s.last_timestamp)
            for s in trace.spans
            if s.first_timestamp is not None
        )
        return TraceSummary(
            trace.id,
            se[0],
            se[1],
            se[1] - se[0],
            span_ts,
            tuple(sorted(trace.endpoints)),
            tuple(sorted(trace.service_counts().items())),
        )


@dataclass(frozen=True)
class TimelineAnnotation:
    timestamp: int
    value: str
    host: Optional[Endpoint]
    span_id: int
    parent_id: Optional[int]
    service_name: str
    span_name: str


@dataclass(frozen=True)
class TraceTimeline:
    """Flat, time-ordered view of all annotations (query/TraceTimeline.scala)."""

    trace_id: int
    root_span_id: int
    annotations: Tuple[TimelineAnnotation, ...]
    binary_annotations: Tuple[BinaryAnnotation, ...]

    @staticmethod
    def from_trace(trace: Trace) -> Optional["TraceTimeline"]:
        if not trace.spans:
            return None
        root = trace.get_root_most_span()
        anns = []
        bins: List[BinaryAnnotation] = []
        for s in trace.spans:
            bins.extend(s.binary_annotations)
            for a in s.annotations:
                anns.append(
                    TimelineAnnotation(
                        a.timestamp,
                        a.value,
                        a.host,
                        s.id,
                        s.parent_id,
                        (a.host.service_name if a.host else s.service_name) or "unknown",
                        s.name,
                    )
                )
        anns.sort(key=lambda t: (t.timestamp, t.value))
        return TraceTimeline(
            trace.id, root.id if root else 0, tuple(anns), tuple(bins)
        )


@dataclass(frozen=True)
class TraceCombo:
    """Trace + summary + timeline + depth map bundle (query/TraceCombo.scala)."""

    trace: Trace
    summary: Optional[TraceSummary]
    timeline: Optional[TraceTimeline]
    span_depths: Optional[Dict[int, int]]

    @staticmethod
    def from_trace(trace: Trace) -> "TraceCombo":
        return TraceCombo(
            trace,
            TraceSummary.from_trace(trace),
            TraceTimeline.from_trace(trace),
            trace.to_span_depths(),
        )
