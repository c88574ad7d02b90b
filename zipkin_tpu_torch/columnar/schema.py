"""SoA span-batch schema — what the device actually sees.

Design (SURVEY.md §7.1): a span batch is three flat tables of fixed-width
columns. Core RPC annotations (cs/cr/sr/ss) get dedicated timestamp
columns on the span row so duration/skew math vectorizes; everything else
(custom annotations, binary annotations) lives in ragged side tables tied
back to the span row by ``span_idx``.

All timestamps are microseconds (int64); ``NO_TS`` (-1) marks absence.
String-ish columns are dictionary ids (see columnar/dictionary.py);
``NO_SERVICE``/``NO_ENDPOINT`` (-1) mark absence.

Reference parity: the per-span columns carry exactly the information the
reference's stores index on — service name, span name, annotations and
binary annotations with timestamps (CassieSpanStore.scala:168-251), plus
the debug flag honoured by the sampler (SpanSamplerFilter.scala:40-47).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

NO_TS = np.int64(-1)
NO_SERVICE = np.int32(-1)
NO_ENDPOINT = np.int32(-1)
NO_PARENT = np.int64(0)

FLAG_DEBUG = np.uint8(1)
FLAG_HAS_PARENT = np.uint8(2)

# Core-annotation timestamp column order (matches CORE_ANNOTATION_IDS).
CORE_TS_COLUMNS = ("ts_cs", "ts_cr", "ts_sr", "ts_ss")


@dataclass
class SpanBatch:
    """A batch of spans in columnar form (host: numpy; device: jax arrays).

    Span table (length ``n_spans``):
      trace_id, span_id: int64; parent_id: int64 (FLAG_HAS_PARENT gates);
      name_id, service_id: int32; ts_cs/ts_cr/ts_sr/ts_ss: int64 (NO_TS
      when absent); ts_first/ts_last: int64 over *all* annotations;
      duration: int64 = ts_last - ts_first (NO_TS when the span has no
      annotations; 0 when it has exactly one); flags: uint8.

    Annotation table (length ``n_annotations``):
      ann_span_idx: int32 row index into the span table;
      ann_ts: int64; ann_value_id: int32 (core ids < FIRST_USER_ANNOTATION_ID);
      ann_service_id: int32 (host's service, NO_SERVICE when hostless);
      ann_endpoint_id: int32 (NO_ENDPOINT when hostless).

    Binary-annotation table (length ``n_binary``):
      bann_span_idx: int32; bann_key_id: int32; bann_value_id: int32;
      bann_type: uint8 (AnnotationType); bann_service_id: int32;
      bann_endpoint_id: int32.
    """

    # span table
    trace_id: np.ndarray
    span_id: np.ndarray
    parent_id: np.ndarray
    name_id: np.ndarray
    service_id: np.ndarray
    ts_cs: np.ndarray
    ts_cr: np.ndarray
    ts_sr: np.ndarray
    ts_ss: np.ndarray
    ts_first: np.ndarray
    ts_last: np.ndarray
    duration: np.ndarray
    flags: np.ndarray

    # annotation table
    ann_span_idx: np.ndarray
    ann_ts: np.ndarray
    ann_value_id: np.ndarray
    ann_service_id: np.ndarray
    ann_endpoint_id: np.ndarray

    # binary-annotation table
    bann_span_idx: np.ndarray
    bann_key_id: np.ndarray
    bann_value_id: np.ndarray
    bann_type: np.ndarray
    bann_service_id: np.ndarray
    bann_endpoint_id: np.ndarray

    @property
    def n_spans(self) -> int:
        return int(self.trace_id.shape[0])

    @property
    def n_annotations(self) -> int:
        return int(self.ann_ts.shape[0])

    @property
    def n_binary(self) -> int:
        return int(self.bann_key_id.shape[0])

    SPAN_COLUMNS: Tuple[str, ...] = (
        "trace_id", "span_id", "parent_id", "name_id", "service_id",
        "ts_cs", "ts_cr", "ts_sr", "ts_ss", "ts_first", "ts_last",
        "duration", "flags",
    )
    ANN_COLUMNS: Tuple[str, ...] = (
        "ann_span_idx", "ann_ts", "ann_value_id", "ann_service_id",
        "ann_endpoint_id",
    )
    BANN_COLUMNS: Tuple[str, ...] = (
        "bann_span_idx", "bann_key_id", "bann_value_id", "bann_type",
        "bann_service_id", "bann_endpoint_id",
    )

    @staticmethod
    def empty(n_spans: int = 0, n_annotations: int = 0, n_binary: int = 0) -> "SpanBatch":
        return SpanBatch(
            trace_id=np.zeros(n_spans, np.int64),
            span_id=np.zeros(n_spans, np.int64),
            parent_id=np.full(n_spans, NO_PARENT, np.int64),
            name_id=np.zeros(n_spans, np.int32),
            service_id=np.full(n_spans, NO_SERVICE, np.int32),
            ts_cs=np.full(n_spans, NO_TS, np.int64),
            ts_cr=np.full(n_spans, NO_TS, np.int64),
            ts_sr=np.full(n_spans, NO_TS, np.int64),
            ts_ss=np.full(n_spans, NO_TS, np.int64),
            ts_first=np.full(n_spans, NO_TS, np.int64),
            ts_last=np.full(n_spans, NO_TS, np.int64),
            duration=np.full(n_spans, NO_TS, np.int64),
            flags=np.zeros(n_spans, np.uint8),
            ann_span_idx=np.zeros(n_annotations, np.int32),
            ann_ts=np.zeros(n_annotations, np.int64),
            ann_value_id=np.zeros(n_annotations, np.int32),
            ann_service_id=np.full(n_annotations, NO_SERVICE, np.int32),
            ann_endpoint_id=np.full(n_annotations, NO_ENDPOINT, np.int32),
            bann_span_idx=np.zeros(n_binary, np.int32),
            bann_key_id=np.zeros(n_binary, np.int32),
            bann_value_id=np.zeros(n_binary, np.int32),
            bann_type=np.zeros(n_binary, np.uint8),
            bann_service_id=np.full(n_binary, NO_SERVICE, np.int32),
            bann_endpoint_id=np.full(n_binary, NO_ENDPOINT, np.int32),
        )

    def concat(self, other: "SpanBatch") -> "SpanBatch":
        """Append ``other``'s rows after self's (span_idx refs re-based)."""
        out = {}
        for col in self.SPAN_COLUMNS:
            out[col] = np.concatenate([getattr(self, col), getattr(other, col)])
        base = self.n_spans
        for col in self.ANN_COLUMNS + self.BANN_COLUMNS:
            a, b = getattr(self, col), getattr(other, col)
            if col.endswith("span_idx"):
                b = b + np.int32(base)
            out[col] = np.concatenate([a, b])
        return SpanBatch(**out)

    def select(self, span_rows: np.ndarray) -> "SpanBatch":
        """Row-subset batch for the given span rows (bool mask or indices)."""
        if span_rows.dtype == np.bool_:
            span_rows = np.flatnonzero(span_rows)
        remap = np.full(self.n_spans, -1, np.int64)
        remap[span_rows] = np.arange(len(span_rows))
        out = {c: getattr(self, c)[span_rows] for c in self.SPAN_COLUMNS}
        ann_keep = remap[self.ann_span_idx] >= 0
        bann_keep = remap[self.bann_span_idx] >= 0
        for col in self.ANN_COLUMNS:
            v = getattr(self, col)[ann_keep]
            out[col] = remap[v].astype(np.int32) if col == "ann_span_idx" else v
        for col in self.BANN_COLUMNS:
            v = getattr(self, col)[bann_keep]
            out[col] = remap[v].astype(np.int32) if col == "bann_span_idx" else v
        return SpanBatch(**out)
