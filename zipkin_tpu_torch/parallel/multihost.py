"""Multi-process deployment of the sharded store, torch side.

The port's copy of ``zipkin_tpu/parallel/multihost.py``. Every trace
lives on exactly one shard of a global 1-D shard view, and a span must
reach the PROCESS that owns that shard before it can be written.

1. ``initialize`` joins the processes of a deployment into one
   ``torch.distributed`` group (one call per process, a coordinator
   address, a rank).
2. ``global_mesh`` / ``local_shard_ids`` — the global 1-D shard view
   and the slice of it this process owns. The port has no device mesh:
   a process keeps its shards as the N ``StoreState``s of a local
   ``ShardedSpanStore(N)``, so a device of the reference's mesh becomes
   a shard SLOT a process holds, ordered by process, then local index,
   as ``jax.devices()`` orders devices.
3. Trace routing: ``shard_of`` is the trace-affine hash
   ``ShardedSpanStore`` places traces by, and ``partition_for_trace`` /
   ``route_spans`` apply the same hash on the producer side (a topic
   with one partition per shard), so every span a process consumes is
   local by construction. Process p of P, each with k local shards,
   owns the global shards ``[p*k, p*k + k)``, and for every trace id
   ``shard_of(t, k) == shard_of(t, k*P) - p*k``: a local
   ``ShardedSpanStore(k)`` fed ``route_spans(..., keep=local_shard_ids(
   mesh))`` places every span on the local slot of its global shard.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Join the deployment's process group (one call per process, before
    ``global_mesh``): ``coordinator_address`` is ``host:port`` of rank
    0's rendezvous. The group is gloo: the collectives here carry host
    objects and small CPU tensors, and NCCL refuses two ranks on one
    card. A multi-card deployment (a card a process) would pick its
    backend here. ``torch.distributed.destroy_process_group`` leaves
    it."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True)
class GlobalMesh:
    """The global 1-D shard view, read like the reference's ``Mesh``:
    ``axis_names``, ``shape[axis]`` and ``devices``, one
    ``(process_index, local_index, device)`` entry a global shard slot.
    ``process_index`` is the rank of the process that built it."""

    axis_names: Tuple[str, ...]
    devices: Tuple[Tuple[int, int, str], ...]
    process_index: int

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}


def mesh_layout(local: Sequence[Tuple[int, str]], process_index: int,
                axis: str = "shard") -> GlobalMesh:
    """The global view from every process's ``(local shard count,
    device)``, in rank order: process p's slots follow those of every
    rank before it."""
    devices = tuple((p, i, device) for p, (n, device) in enumerate(local)
                    for i in range(n))
    return GlobalMesh((axis,), devices, process_index)


def global_mesh(axis: str = "shard",
                local_shards: Optional[int] = None) -> GlobalMesh:
    """The global 1-D shard view over every shard slot of every process:
    with a process group up, each process's ``local_shards`` is gathered
    from every rank; without one the world is this process alone.

    ``local_shards`` exists because shards are not devices in the port:
    it stands for the reference's ``jax.local_devices()`` and defaults
    to the process's CUDA device count (1 on a host without a card). A
    process that keeps N shards on one card, as the daemon's
    ``--shards N`` does, passes N."""
    import torch
    import torch.distributed as dist

    on_card = torch.cuda.is_available()
    if local_shards is None:
        local_shards = torch.cuda.device_count() if on_card else 1
    device = f"cuda:{torch.cuda.current_device()}" if on_card else "cpu"
    mine = (int(local_shards), device)
    if not dist.is_initialized():
        return mesh_layout([mine], 0, axis)
    local: List = [None] * dist.get_world_size()
    dist.all_gather_object(local, mine)
    return mesh_layout(local, dist.get_rank(), axis)


def local_shard_ids(mesh: GlobalMesh) -> List[int]:
    """Global shard indices this process owns — the shards it feeds and
    serves."""
    return [i for i, (p, _, _) in enumerate(mesh.devices)
            if p == mesh.process_index]


def partitions_for_process(mesh: GlobalMesh) -> List[int]:
    """Kafka partitions this process must consume: exactly its local
    shards' indices (partition i feeds shard i)."""
    return local_shard_ids(mesh)


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
