"""Query request/response model.

Reference: QueryRequest/QueryResponse/Order in zipkin-common
(query/QueryRequest.scala, QueryResponse.scala, Order.scala) and the
thrift shapes in zipkinQuery.thrift:93-251.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


class QueryException(Exception):
    """Raised for malformed queries (thrift QueryException analogue)."""


class Order(enum.Enum):
    NONE = "none"
    TIMESTAMP_DESC = "timestamp-desc"
    TIMESTAMP_ASC = "timestamp-asc"
    DURATION_DESC = "duration-desc"
    DURATION_ASC = "duration-asc"


@dataclass(frozen=True)
class BinaryAnnotationQuery:
    key: str
    value: bytes


@dataclass(frozen=True)
class QueryRequest:
    service_name: str
    span_name: Optional[str] = None
    annotations: Tuple[str, ...] = ()
    binary_annotations: Tuple[BinaryAnnotationQuery, ...] = ()
    end_ts: int = 0x7FFFFFFFFFFFFFFF
    limit: int = 100
    order: Order = Order.NONE

    def __post_init__(self):
        if not isinstance(self.annotations, tuple):
            object.__setattr__(self, "annotations", tuple(self.annotations))
        if not isinstance(self.binary_annotations, tuple):
            object.__setattr__(
                self, "binary_annotations", tuple(self.binary_annotations)
            )


@dataclass(frozen=True)
class QueryResponse:
    """Sorted trace ids + the time range covered, for pagination
    (QueryResponse.scala: pass ``start_ts`` back as the next end_ts)."""

    trace_ids: Tuple[int, ...] = ()
    start_ts: int = -1
    end_ts: int = -1

    def __post_init__(self):
        if not isinstance(self.trace_ids, tuple):
            object.__setattr__(self, "trace_ids", tuple(self.trace_ids))
