"""The process half of the port's ``parallel/multihost.py`` against the
reference's, on the CPU.

The reference's global mesh is the 8-device virtual CPU mesh that
``tests/conftest.py`` forces; the port's global view is a list of shard
slots, gathered over a ``torch.distributed`` gloo group when one is up.
No test here starts a process (the two-process drive is in the slow
lane, ``tests/test_torch_multihost_procs.py``); the one group made here
is a world of one, destroyed in a fixture finalizer.

Tolerances: reads of traces, existence, durations and per-shard span
counts bitwise; dependency moments with the count field exact and the
other fields within the stated tolerance 2 (``moments_close``: rtol
1e-5 of the field's largest magnitude).
"""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from zipkin_tpu.parallel import multihost as ref_mh  # noqa: E402
from zipkin_tpu.parallel.shard import (  # noqa: E402
    ShardedSpanStore as RefShardedSpanStore,
)
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.checkpoint import _dict_dump, _load_dicts  # noqa: E402
from zipkin_tpu_torch.columnar.encode import SpanCodec  # noqa: E402
from zipkin_tpu_torch.parallel import multihost as mh  # noqa: E402
from zipkin_tpu_torch.parallel.shard import ShardedSpanStore  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.convert import sharded_states_from_numpy  # noqa: E402

from test_torch_store import PORT, REF, _convert, moments_close  # noqa: E402

# tests/test_parallel.py's CFG.
SMALL = dict(capacity=256, ann_capacity=1024, bann_capacity=512,
             max_services=16, max_span_names=32, max_annotation_values=64,
             max_binary_keys=16, cms_width=256, hll_p=8,
             quantile_buckets=128)
# The split drive's store: the window arena on, rings deep enough that
# no shard laps (a lap's evictions are paced by the fleet-wide clock,
# which a local fleet of 2 keeps apart from a global one of 4).
SPLIT = dict(SMALL, capacity=2048, ann_capacity=8192, bann_capacity=4096,
             max_span_names=64, window_seconds=3600, window_buckets=4)
END = 2**62
# Per-shard counters that count spans and their time range; the
# fleet-paced ones (dependency bucket closes, sweeps, steps) are not
# the shard's alone.
SPAN_COUNTERS = ("write_pos", "ann_write_pos", "bann_write_pos",
                 "ring_occupancy", "ring_laps", "spans_seen", "anns_seen",
                 "banns_seen", "ts_min", "ts_max")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture()
def process_group():
    """A world-of-one gloo group through ``initialize``, destroyed in the
    finalizer."""
    import torch.distributed as dist

    mh.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    yield dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _spans(n_traces, seed):
    traces = generate_traces(n_traces=n_traces, max_depth=3, n_services=6,
                             rng=np.random.default_rng(seed))
    return traces, [s for t in traces for s in t]


# -- (a) the reference's test_multihost_routing_math on both packages --------


def test_routing_math_on_both_packages():
    """The producer-side partitioner, each package's store placement
    hash and the per-process consume set agree; the port's global view
    with 8 local shards reads like the reference's over the 8-device
    mesh; routed groups partition the spans and a local group ingests
    and reads back in both stores."""
    mesh = Mesh(np.array(jax.devices()), axis_names=("shard",))
    ref = RefShardedSpanStore(mesh, dev.StoreConfig(**SMALL))
    port = ShardedSpanStore(8, tdev.StoreConfig(**SMALL), device="cpu",
                            registry=obs.Registry())
    try:
        n = port.n
        assert n == ref.n == 8
        _, spans = _spans(20, 1)
        pspans = _convert(spans, PORT)
        for s, p in zip(spans, pspans):
            assert mh.partition_for_trace(p.trace_id, n) == \
                ref_mh.partition_for_trace(s.trace_id, n) == \
                port._shard_of(p.trace_id) == ref._shard_of(s.trace_id)
        ref_mesh = ref_mh.global_mesh()
        gmesh = mh.global_mesh(local_shards=len(jax.devices()))
        assert gmesh.axis_names == ref_mesh.axis_names == ("shard",)
        assert gmesh.shape["shard"] == ref_mesh.shape["shard"] == n
        local = mh.local_shard_ids(gmesh)
        assert local == ref_mh.local_shard_ids(ref_mesh) == list(range(n))
        assert mh.partitions_for_process(gmesh) == \
            ref_mh.partitions_for_process(ref_mesh) == local
        groups = mh.route_spans(pspans, n)
        ref_groups = ref_mh.route_spans(spans, n)
        assert {k: _convert(v, REF) for k, v in groups.items()} == \
            ref_groups
        assert sum(len(g) for g in groups.values()) == len(spans)
        for sid, group in groups.items():
            assert all(mh.shard_of(s.trace_id, n) == sid for s in group)
        owned = [0, 1]
        sub = mh.route_spans(pspans, n, keep=owned)
        assert set(sub) <= set(owned)
        assert sum(len(g) for g in sub.values()) == \
            sum(len(g) for sid, g in groups.items() if sid in owned)
        sid = min(groups)
        ref.apply(ref_groups[sid])
        port.apply(groups[sid])
        tid = groups[sid][0].trace_id
        assert _convert(port.get_spans_by_trace_ids([tid]), REF) == \
            ref.get_spans_by_trace_ids([tid]) != []
    finally:
        port.close()
        ref.close()


# -- (b) the global layout of P processes -------------------------------------


@pytest.mark.parametrize("n_procs,k", [(2, 2), (4, 1), (3, 3)])
def test_mesh_layout_of_processes(n_procs, k):
    """P processes of k local shards: a P*k-slot view ordered by process,
    then local index; process p owns [p*k, p*k + k) and consumes those
    partitions. Counts need not be equal."""
    local = [(k, f"cuda:{p % 2}") for p in range(n_procs)]
    for p in range(n_procs):
        mesh = mh.mesh_layout(local, p)
        assert mesh.axis_names == ("shard",)
        assert mesh.shape == {"shard": n_procs * k}
        assert mesh.devices == tuple(
            (q, i, f"cuda:{q % 2}") for q in range(n_procs)
            for i in range(k))
        want = list(range(p * k, p * k + k))
        assert mh.local_shard_ids(mesh) == want
        assert mh.partitions_for_process(mesh) == want
    uneven = [(1, "cpu"), (3, "cpu"), (2, "cpu")]
    assert [mh.local_shard_ids(mh.mesh_layout(uneven, p, axis="x"))
            for p in range(3)] == [[0], [1, 2, 3], [4, 5]]
    assert mh.mesh_layout(uneven, 0, axis="x").shape == {"x": 6}


# -- (c) the local re-hash identity ----------------------------------------


@pytest.mark.parametrize("k,n_procs", [(2, 2), (1, 4), (4, 2), (3, 3)])
def test_local_rehash_places_on_the_global_slot(k, n_procs):
    """For a trace owned by process p of P (k shards each),
    shard_of(t, k) == shard_of(t, k*P) - p*k, signed and unsigned ids
    alike: a local fleet of k places every routed span on the local slot
    of its global shard."""
    rng = np.random.default_rng(k * 10 + n_procs)
    ids = [int(x) for x in rng.integers(-2**63, 2**63 - 1, 20_000,
                                        dtype=np.int64)]
    ids += [int(x) for x in rng.integers(0, 2**64 - 1, 5_000,
                                         dtype=np.uint64)]
    n = k * n_procs
    owners = [0] * n_procs
    for tid in ids:
        g = mh.shard_of(tid, n)
        assert g == ref_mh.shard_of(tid, n)
        p = g // k
        owners[p] += 1
        assert mh.shard_of(tid, k) == g - p * k
    assert all(owners)


# -- (d) initialize, a world of one ------------------------------------------


def test_initialize_world_of_one(process_group):
    dist = process_group
    assert dist.is_initialized()
    assert dist.get_backend() == "gloo"
    assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
    mesh = mh.global_mesh(local_shards=3)
    assert mesh.shape["shard"] == 3
    assert mesh.devices == ((0, 0, "cpu"), (0, 1, "cpu"), (0, 2, "cpu"))
    assert mh.local_shard_ids(mesh) == mh.partitions_for_process(mesh) \
        == [0, 1, 2]
    got = [None]
    dist.all_gather_object(got, {"local": mh.local_shard_ids(mesh)})
    assert got == [{"local": [0, 1, 2]}]
    # Without a card the default is one slot (the CPU).
    assert mh.global_mesh().shape["shard"] == 1


# -- (e) the split against the reference's fleet of 4 -----------------------


def _port_dicts(ref_dicts):
    return _load_dicts({name: _dict_dump(getattr(ref_dicts, name))
                        for name in ("services", "span_names",
                                     "annotations", "binary_keys",
                                     "binary_values", "endpoints")})


def _span_counts(fleet):
    return [{c: b[c] for c in SPAN_COUNTERS} for b in fleet.shard_counters()]


def _links(deps):
    return sorted((l.parent, l.child) for l in deps.links), sorted(
        ((l.parent, l.child), tuple(float(getattr(l.duration_moments, f))
                                    for f in ("n", "mean", "m2", "m3",
                                              "m4")))
        for l in deps.links)


@pytest.fixture(scope="module")
def split_drive():
    """The reference's ShardedSpanStore on a 4-device submesh fed every
    span; per process p of 2, a port ShardedSpanStore(2) fed the routed
    spans it owns (each chunk routed as a producer would send it), and
    a port fleet over the reference's states of shards [2p, 2p + 2)."""
    mesh4 = Mesh(np.array(jax.devices()[:4]), axis_names=("shard",))
    ref = RefShardedSpanStore(mesh4, dev.StoreConfig(**SPLIT))
    traces, spans = _spans(220, 11)
    cfg = tdev.StoreConfig(**SPLIT)
    fed = [ShardedSpanStore(2, cfg, device="cpu", registry=obs.Registry())
           for _ in range(2)]
    meshes = [mh.mesh_layout([(2, "cpu")] * 2, p) for p in range(2)]
    for i in range(0, len(spans), 100):
        chunk = spans[i:i + 100]
        ref.apply(chunk)
        pchunk = _convert(chunk, PORT)
        for fleet, mesh in zip(fed, meshes):
            kept = mh.route_spans(pchunk, 4, keep=mh.local_shard_ids(mesh))
            fleet.apply([s for sid in sorted(kept) for s in kept[sid]])
    leaves = {f: getattr(jax.device_get(ref.inner.states), f)
              for f in dev.StoreState._FIELDS}
    converted = []
    for p in range(2):
        fleet = ShardedSpanStore(2, cfg, device="cpu",
                                 codec=SpanCodec(_port_dicts(ref.dicts)),
                                 registry=obs.Registry())
        part = {f: ({c: np.asarray(v)[2 * p:2 * p + 2]
                     for c, v in leaves[f].items()} if f == "counters"
                    else np.asarray(leaves[f])[2 * p:2 * p + 2])
                for f in dev.StoreState._FIELDS}
        fleet.inner.states = sharded_states_from_numpy(cfg, part,
                                                       device="cpu")
        converted.append(fleet)
    yield dict(ref=ref, fed=fed, converted=converted, traces=traces,
               spans=spans)
    for fleet in fed + converted:
        fleet.close()
    ref.close()


def test_split_fleets_read_like_the_reference(split_drive):
    """Every trace reads back from its owner exactly as from the
    reference's 4-shard fleet fed all spans; the owners' kept spans
    partition the feed; each local shard counts what the reference's
    global shard counts."""
    ref, fed = split_drive["ref"], split_drive["fed"]
    traces, spans = split_drive["traces"], split_drive["spans"]
    ref_counts = ref.shard_counters()
    assert max(b["write_pos"] for b in ref_counts) <= SPLIT["capacity"]
    assert all(b["spans_seen"] > 0 for b in ref_counts)
    tids = [t[0].trace_id for t in traces]
    owned = [[t for t in tids if mh.shard_of(t, 4) // 2 == p]
             for p in range(2)]
    assert sorted(owned[0] + owned[1]) == sorted(tids)
    assert owned[0] and owned[1]
    for p, fleet in enumerate(fed):
        for b, want in zip(_span_counts(fleet), ref_counts[2 * p:2 * p + 2]):
            assert b == {c: want[c] for c in SPAN_COUNTERS}
        mine, other = owned[p], owned[1 - p]
        assert _convert(fleet.get_spans_by_trace_ids(mine), REF) == \
            ref.get_spans_by_trace_ids(mine)
        assert _convert(fleet.get_traces_duration(mine), REF) == \
            ref.get_traces_duration(mine)
        assert fleet.traces_exist(mine) == ref.traces_exist(mine) \
            == set(mine)
        assert fleet.get_spans_by_trace_ids(other) == []
        assert fleet.traces_exist(other) == set()
    assert sum(b["spans_seen"] for f in fed for b in f.shard_counters()) \
        == len(spans)
    # The links of the two processes add up to the reference's.
    counts = {}
    for fleet in fed:
        for l in fleet.get_dependencies().links:
            key = (l.parent, l.child)
            counts[key] = counts.get(key, 0) + l.duration_moments.n
    want = {(l.parent, l.child): l.duration_moments.n
            for l in ref.get_dependencies().links}
    assert want and counts == want


def test_converted_reference_shards_read_like_the_fed_fleet(split_drive):
    """The reference's states of shards [2p, 2p + 2), converted with
    ``sharded_states_from_numpy``, read in the port as the routed port
    fleet of process p reads: traces, durations, per-shard span counts,
    and dependency links (moments by stated tolerance 2)."""
    traces = split_drive["traces"]
    tids = [t[0].trace_id for t in traces]
    for p, (fed, conv) in enumerate(zip(split_drive["fed"],
                                        split_drive["converted"])):
        mine = [t for t in tids if mh.shard_of(t, 4) // 2 == p]
        assert conv.get_spans_by_trace_ids(mine) == \
            fed.get_spans_by_trace_ids(mine)
        assert conv.get_traces_duration(mine) == \
            fed.get_traces_duration(mine)
        assert _span_counts(conv) == _span_counts(fed)
        keys_c, moments_c = _links(conv.get_dependencies())
        keys_f, moments_f = _links(fed.get_dependencies())
        assert keys_c == keys_f and keys_f
        assert moments_close([m for _, m in moments_c],
                             [m for _, m in moments_f])
