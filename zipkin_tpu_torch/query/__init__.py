"""Query layer: the ZipkinQuery service semantics over any SpanStore.

Reference parity: zipkin-query (ThriftQueryService.scala:32) — slice
queries with aligned-timestamp intersection, timestamp/duration
ordering, trace assembly with pluggable adjusters (TimeSkewAdjuster),
and summary/timeline/combo projections — re-hosted as a plain python
service over the SpanStore SPI (the port's copy of ``zipkin_tpu/query``;
``zipkin_tpu_torch.api`` holds the request extractor, the HTTP surface
comes with the daemon).
"""

from zipkin_tpu_torch.query.request import (  # noqa: F401
    BinaryAnnotationQuery,
    Order,
    QueryException,
    QueryRequest,
    QueryResponse,
)
from zipkin_tpu_torch.query.adjusters import TimeSkewAdjuster  # noqa: F401
from zipkin_tpu_torch.query.coalesce import (  # noqa: F401
    QueryCoalescer,
    ResidentCoalescer,
)
from zipkin_tpu_torch.query.engine import QueryEngine  # noqa: F401
from zipkin_tpu_torch.query.service import QueryService  # noqa: F401
