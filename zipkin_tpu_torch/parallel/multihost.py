"""Trace routing of the sharded store, torch side.

The port's copy of the routing half of ``zipkin_tpu/parallel/
multihost.py``: ``shard_of`` is the trace-affine hash
``ShardedSpanStore`` places traces by, and ``partition_for_trace`` /
``route_spans`` apply the same hash on the producer side (a topic with
one partition per shard), so every span a shard's host consumes is
local by construction. The multi-process half (``initialize``, the
global shard view and the per-process partition set) is not here yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

from zipkin_tpu_torch.columnar.encode import to_signed64

# Keep the hash in lockstep with ShardedSpanStore._shard_of: one
# constant, two call sites, zero drift.
_GOLDEN = 0x9E3779B97F4A7C15


def shard_of(trace_id: int, n_shards: int) -> int:
    """Owning shard of a trace — identical to ShardedSpanStore's
    trace-affine routing (parallel/shard.py), applied to the GLOBAL
    shard count. Called once per span on the ingest routing path, so
    to_signed64 is bound at module scope, not per call."""
    return (to_signed64(trace_id) * _GOLDEN) % n_shards


def partition_for_trace(trace_id: int, n_shards: int) -> int:
    """Kafka partition key for a span: partition i feeds shard i. A
    producer using this guarantees every message a host consumes is for
    a shard that host owns."""
    return shard_of(trace_id, n_shards)


def route_spans(spans: Sequence, n_shards: int,
                keep: Optional[Sequence[int]] = None):
    """Group spans by owning shard; ``keep`` (e.g. this process's local
    shard ids) filters to locally-owned groups. Returns
    {shard_id: [spans]} — the host-side pre-partitioning a multi-host
    feed applies before ShardedSpanStore.apply (which re-derives the
    same affinity, so a locally-complete group lands intact)."""
    keep_set = None if keep is None else set(keep)
    out = {}
    for s in spans:
        sid = shard_of(s.trace_id, n_shards)
        if keep_set is not None and sid not in keep_set:
            continue
        out.setdefault(sid, []).append(s)
    return out
