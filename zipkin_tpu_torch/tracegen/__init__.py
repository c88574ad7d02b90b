"""Synthetic trace generation (zipkin-tracegen parity + vectorized scale).

Two generators:

- ``generate_traces``: python Span objects with the reference generator's
  shape (TraceGen.scala:50 — random tree depth ≤ 7, lorem-ish
  service/rpc names, cs/sr/ss/cr core annotations, one custom and one
  binary annotation per span). Feeds any SpanStore; used by the
  end-to-end smoke test (tracegen/Main.scala:48-117 analogue).

- ``ColumnarTraceGen``: vectorized numpy generator that emits SpanBatch
  columns directly — no python span objects — so the ingest benchmark
  can stream 100M+ spans (BASELINE.md config #2) without the host
  object layer becoming the bottleneck.
"""

from zipkin_tpu_torch.tracegen.gen import (  # noqa: F401
    ColumnarTraceGen,
    generate_traces,
)
