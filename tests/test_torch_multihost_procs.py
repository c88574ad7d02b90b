"""Multi-process span routing of the port across REAL processes.

The port's counterpart of ``tests/test_multihost.py``: two processes
joined through ``zipkin_tpu_torch.parallel.multihost.initialize`` (a
gloo group), each holding 2 local shard slots of a 4-shard global view,
route one shared deterministic span set with ``route_spans`` and feed
what they keep to a local ``ShardedSpanStore(2)`` on the CPU. The
parent checks the partition property the data plane depends on: every
span lands on exactly one process, that process owns the span's shard
(and its local store placed it on that shard's local slot), and the
union across processes is the whole set. Marked ``slow`` (it spawns
subprocesses and a rendezvous).
"""

import json
import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import json, sys

import torch
torch.set_num_threads(1)

from zipkin_tpu_torch import obs
from zipkin_tpu_torch.models.span import Span
from zipkin_tpu_torch.parallel import multihost
from zipkin_tpu_torch.parallel.shard import ShardedSpanStore
from zipkin_tpu_torch.store.device import StoreConfig

coordinator, pid = sys.argv[1], int(sys.argv[2])
multihost.initialize(coordinator, num_processes=2, process_id=pid)
import torch.distributed as dist

mesh = multihost.global_mesh(local_shards=2)
n_shards = int(mesh.shape["shard"])
local = multihost.local_shard_ids(mesh)

# The SAME deterministic span set in both processes (the producer
# view); each process keeps only what it owns (the consumer view).
spans = [Span(tid * 2654435761 % (1 << 62) + 1, "op", 1, None, (), ())
         for tid in range(1, 65)]
kept = multihost.route_spans(spans, n_shards, keep=local)
fleet = ShardedSpanStore(2, StoreConfig(
    capacity=256, ann_capacity=1024, bann_capacity=512, max_services=16,
    max_span_names=32, max_annotation_values=64, max_binary_keys=16,
    cms_width=256, hll_p=8, quantile_buckets=128), device="cpu",
    registry=obs.Registry())
fleet.apply([s for sid in sorted(kept) for s in kept[sid]])
gathered = [None, None]
dist.all_gather_object(gathered, sorted(local))
print(json.dumps({
    "pid": pid,
    "world": dist.get_world_size(),
    "n_devices": len(mesh.devices),
    "n_local_devices": len(local),
    "n_shards": n_shards,
    "local_shards": sorted(local),
    "gathered_local": gathered,
    "partitions": sorted(multihost.partitions_for_process(mesh)),
    "kept": {str(sid): sorted(s.trace_id for s in group)
             for sid, group in kept.items()},
    "local_slot": {str(s.trace_id): fleet._shard_of(s.trace_id)
                   for group in kept.values() for s in group},
    "spans_by_slot": [b["spans_seen"] for b in fleet.shard_counters()],
    "all_tids": sorted(s.trace_id for s in spans),
}), flush=True)
fleet.close()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_routing_over_gloo():
    coordinator = f"127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, coordinator, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=root,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=60)

    by_pid = {o["pid"]: o for o in outs}
    a, b = by_pid[0], by_pid[1]
    # Both processes saw the same 4-slot global view, 2 local each.
    assert a["world"] == b["world"] == 2
    assert a["n_devices"] == b["n_devices"] == 4
    assert a["n_local_devices"] == b["n_local_devices"] == 2
    assert a["n_shards"] == b["n_shards"] == 4
    assert a["gathered_local"] == b["gathered_local"] == [[0, 1], [2, 3]]
    # Local shard ownership partitions the view, in rank order.
    assert a["local_shards"] == [0, 1] and b["local_shards"] == [2, 3]
    # Kafka partition mapping is exactly shard ownership.
    assert a["partitions"] == a["local_shards"]
    assert b["partitions"] == b["local_shards"]
    # Routing delivered every span to EXACTLY ONE process, that process
    # owns the span's shard, its local store placed the span on that
    # shard's local slot, and nothing was lost or duplicated.
    from zipkin_tpu_torch.parallel.multihost import shard_of

    assert a["all_tids"] == b["all_tids"]
    seen = []
    for o in (a, b):
        local = set(o["local_shards"])
        base = min(local)
        for sid_str, tids in o["kept"].items():
            assert int(sid_str) in local
            for tid in tids:
                assert shard_of(tid, o["n_shards"]) == int(sid_str)
                assert o["local_slot"][str(tid)] == int(sid_str) - base
            seen.extend(tids)
        assert o["spans_by_slot"] == [
            float(len(o["kept"].get(str(sid), []))) for sid in sorted(local)]
    assert sorted(seen) == a["all_tids"]
