"""Span ↔ SpanBatch codec.

Encoding happens on the host ingest path (the analogue of the reference's
thrift→common.Span ``SpanConvertingFilter``, ZipkinCollectorFactory.scala:30,
fused with the HBase-style dictionary mapping); decoding happens on the
query path when a trace is materialised back into span objects.

Lossless: every field of Span/Annotation/BinaryAnnotation survives a
roundtrip (binary-annotation values are dictionary-encoded, not hashed).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from zipkin_tpu_torch.columnar.dictionary import DictionarySet
from zipkin_tpu_torch.columnar.schema import (
    FLAG_DEBUG,
    FLAG_HAS_PARENT,
    NO_ENDPOINT,
    NO_PARENT,
    NO_SERVICE,
    NO_TS,
    SpanBatch,
)
from zipkin_tpu_torch.models.constants import (
    CLIENT_RECV,
    CLIENT_SEND,
    SERVER_RECV,
    SERVER_SEND,
)
from zipkin_tpu_torch.models.span import (
    Annotation,
    AnnotationType,
    BinaryAnnotation,
    Span,
)

_CORE_TS_FIELD = {
    CLIENT_SEND: "ts_cs",
    CLIENT_RECV: "ts_cr",
    SERVER_RECV: "ts_sr",
    SERVER_SEND: "ts_ss",
}


def _norm_value(value: object, ann_type: AnnotationType):
    """Canonical hashable form for dictionary encoding of binary values."""
    if isinstance(value, bytearray):
        return bytes(value)
    return value


def to_signed64(x: int) -> int:
    """Canonicalise a python int to signed 64-bit (the wire interpretation)."""
    x &= 0xFFFFFFFFFFFFFFFF
    return x - 0x10000000000000000 if x >= 0x8000000000000000 else x


class SpanCodec:
    """Encode python spans into a SpanBatch and back, sharing dictionaries."""

    def __init__(self, dictionaries: Optional[DictionarySet] = None):
        self.dicts = dictionaries if dictionaries is not None else DictionarySet()

    # -- encode ---------------------------------------------------------

    def encode(self, spans: Sequence[Span]) -> SpanBatch:
        n = len(spans)
        n_ann = sum(len(s.annotations) for s in spans)
        n_bann = sum(len(s.binary_annotations) for s in spans)
        b = SpanBatch.empty(n, n_ann, n_bann)
        d = self.dicts
        ai = bi = 0
        for i, s in enumerate(spans):
            b.trace_id[i] = to_signed64(s.trace_id)
            b.span_id[i] = to_signed64(s.id)
            flags = 0
            if s.debug:
                flags |= int(FLAG_DEBUG)
            if s.parent_id is not None:
                flags |= int(FLAG_HAS_PARENT)
                b.parent_id[i] = to_signed64(s.parent_id)
            b.flags[i] = flags
            b.name_id[i] = d.span_names.encode(s.name)
            svc = s.service_name
            b.service_id[i] = (
                d.services.encode(svc.lower()) if svc is not None else NO_SERVICE
            )
            ts_first = ts_last = None
            for a in s.annotations:
                b.ann_span_idx[ai] = i
                b.ann_ts[ai] = a.timestamp
                b.ann_value_id[ai] = d.annotations.encode(a.value)
                if a.host is not None:
                    b.ann_service_id[ai] = d.services.encode(
                        a.host.service_name.lower()
                    )
                    b.ann_endpoint_id[ai] = d.encode_endpoint(a.host)
                ai += 1
                core_field = _CORE_TS_FIELD.get(a.value)
                if core_field is not None:
                    getattr(b, core_field)[i] = a.timestamp
                if ts_first is None or a.timestamp < ts_first:
                    ts_first = a.timestamp
                if ts_last is None or a.timestamp > ts_last:
                    ts_last = a.timestamp
            if ts_first is not None:
                b.ts_first[i] = ts_first
                b.ts_last[i] = ts_last
                b.duration[i] = ts_last - ts_first
            for ba in s.binary_annotations:
                b.bann_span_idx[bi] = i
                b.bann_key_id[bi] = d.binary_keys.encode(ba.key)
                b.bann_value_id[bi] = d.binary_values.encode(
                    _norm_value(ba.value, ba.annotation_type)
                )
                b.bann_type[bi] = int(ba.annotation_type)
                if ba.host is not None:
                    b.bann_service_id[bi] = d.services.encode(
                        ba.host.service_name.lower()
                    )
                    b.bann_endpoint_id[bi] = d.encode_endpoint(ba.host)
                bi += 1
        return b

    # -- decode ---------------------------------------------------------

    def decode(self, batch: SpanBatch) -> List[Span]:
        d = self.dicts
        n = batch.n_spans
        anns: List[list] = [[] for _ in range(n)]
        banns: List[list] = [[] for _ in range(n)]
        for j in range(batch.n_annotations):
            i = int(batch.ann_span_idx[j])
            eid = int(batch.ann_endpoint_id[j])
            host = d.decode_endpoint(eid) if eid != NO_ENDPOINT else None
            anns[i].append(
                Annotation(
                    timestamp=int(batch.ann_ts[j]),
                    value=d.annotations.decode(int(batch.ann_value_id[j])),
                    host=host,
                )
            )
        for j in range(batch.n_binary):
            i = int(batch.bann_span_idx[j])
            eid = int(batch.bann_endpoint_id[j])
            host = d.decode_endpoint(eid) if eid != NO_ENDPOINT else None
            banns[i].append(
                BinaryAnnotation(
                    key=d.binary_keys.decode(int(batch.bann_key_id[j])),
                    value=d.binary_values.decode(int(batch.bann_value_id[j])),
                    annotation_type=AnnotationType(int(batch.bann_type[j])),
                    host=host,
                )
            )
        out = []
        for i in range(n):
            flags = int(batch.flags[i])
            out.append(
                Span(
                    trace_id=int(batch.trace_id[i]),
                    name=d.span_names.decode(int(batch.name_id[i])),
                    id=int(batch.span_id[i]),
                    parent_id=(
                        int(batch.parent_id[i]) if flags & int(FLAG_HAS_PARENT) else None
                    ),
                    annotations=tuple(anns[i]),
                    binary_annotations=tuple(banns[i]),
                    debug=bool(flags & int(FLAG_DEBUG)),
                )
            )
        return out
