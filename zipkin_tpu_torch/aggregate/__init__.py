"""Aggregation, torch side: the windowed Moments-sketch arena
(``windows``) and the dependency jobs (``job``).

Reference: zipkin-aggregate's Scalding job (ZipkinAggregateJob.scala:10-47
— merge span halves, join parents×children, Moments per link, monoid
sum) and the incremental SQL aggregator (AnormAggregator.scala:32-90 —
≤10k-span batches, resume from the last aggregated end_ts).

- ``aggregate_spans``: the pure-python oracle with full merge semantics;
- ``recompute_dependencies``: the join over the store's live span rows
  (``store/device.recompute_dep_moments``) — the rerunnable batch job;
- ``IncrementalAggregator``: resumable batch-driven aggregation with the
  reference's resume-from-MAX(end_ts) behavior.
"""

from zipkin_tpu_torch.aggregate.job import (  # noqa: F401
    IncrementalAggregator,
    aggregate_spans,
    dependencies_from_bank,
    links_from_bank,
    recompute_dependencies,
)
