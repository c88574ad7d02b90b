"""Sharded ingest on one device: N store shards, cross-shard merges.

The port's copy of ``zipkin_tpu/parallel``. The reference shards the
ingest stream over a device mesh axis and merges with XLA collectives
(psum for counters/histograms/count-min, pmax for HyperLogLog
registers, all_gather + a tree-combine for the Moments banks). The
port keeps N independent store states on one device and turns each
collective into a torch reduction over the shards' results.
"""

from zipkin_tpu_torch.parallel.shard import (  # noqa: F401
    ShardedSpanStore,
    ShardedStore,
    global_summary,
)
