"""GET params → QueryRequest (QueryExtractor.scala:26-92 semantics).

Notably the ``annotationQuery`` mini-language: terms joined by " and ";
``key=value`` terms become binary-annotation (string) queries, bare
``key`` terms become annotation queries. ``spanName`` values "all"/""
mean no span filter. Default limit mirrors the web constant (100).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from zipkin_tpu_torch.query.request import (
    BinaryAnnotationQuery,
    Order,
    QueryRequest,
)

DEFAULT_LIMIT = 100

_ORDERS = {
    "timestamp-desc": Order.TIMESTAMP_DESC,
    "timestamp-asc": Order.TIMESTAMP_ASC,
    "duration-desc": Order.DURATION_DESC,
    "duration-asc": Order.DURATION_ASC,
    "none": Order.NONE,
}


def extract_query(params: Dict[str, str]) -> Optional[QueryRequest]:
    service = params.get("serviceName")
    if not service:
        return None
    span_name = params.get("spanName")
    if span_name in ("all", "", None):
        span_name = None
    annotations = []
    binary = []
    for term in params.get("annotationQuery", "").split(" and "):
        if not term:
            continue
        if "=" in term:
            key, _, value = term.partition("=")
            if key:
                binary.append(
                    BinaryAnnotationQuery(key, value.encode("utf-8"))
                )
        else:
            annotations.append(term)
    end_ts = int(params.get("timestamp") or params.get("endTs")
                 or int(time.time() * 1_000_000))
    limit = int(params.get("limit") or DEFAULT_LIMIT)
    order = _ORDERS.get(params.get("order", "none"), Order.NONE)
    return QueryRequest(
        service_name=service,
        span_name=span_name,
        annotations=tuple(annotations),
        binary_annotations=tuple(binary),
        end_ts=end_ts,
        limit=limit,
        order=order,
    )
