"""Ingest runtime: bounded queue, receivers, and the collector assembly.

Reference parity: zipkin-collector's ItemQueue pipeline
(ItemQueue.scala:39, SpanReceiver.scala:27, ZipkinCollectorFactory.scala:40-76)
and the scribe/kafka receivers — the host-side runtime that feeds the
device. Backpressure semantics carry over exactly: a full queue raises
QueueFullException, which receivers surface as TRY_LATER so upstream
transports buffer and retry. The port's copy of ``zipkin_tpu/ingest``.
"""

from zipkin_tpu_torch.ingest.queue import (  # noqa: F401
    ItemQueue,
    QueueFullException,
)
from zipkin_tpu_torch.ingest.receiver import (  # noqa: F401
    JsonReceiver,
    ResultCode,
    ScribeReceiver,
)
from zipkin_tpu_torch.ingest.collector import Collector  # noqa: F401
