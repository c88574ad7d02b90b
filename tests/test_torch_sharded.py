"""The port's sharded store (``zipkin_tpu_torch.parallel``) against the
JAX reference's, on the CPU.

The reference runs its shards on a 2-device virtual CPU mesh
(``tests/conftest.py``); the port keeps two ``StoreState``s on the CPU
(``device="cpu"``). Both take the same spans or the same padded
batches, made from a seed, and must agree: integer leaves, counters,
registers and every integer read bitwise; the float32 dependency
moments with the count field exact and the rest within the stated
tolerance 2 (``moments_close``, rtol 1e-5 of the field's largest
magnitude: the cross-shard combine adds a reduction order); HLL
estimates within the stated tolerance 3 (rel 1e-5: float64 sums here,
float32 in the reference, over equal registers).

Counterparts of ``tests/test_parallel.py`` (the summary drive, the
query round trip, multi against singular, the overflow services, the
concurrent catalog readers), of ``test_sharded_pinned_trace_survives_
eviction``, ``test_sharded_dependencies_window`` and
``test_sharded_store_rejects_paged_layout``, and the JAX conformance
suite over a 2-shard port store.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from zipkin_tpu.parallel import multihost as ref_mh  # noqa: E402
from zipkin_tpu.parallel.shard import (  # noqa: E402
    ShardedSpanStore as RefShardedSpanStore,
    ShardedStore as RefShardedStore,
    global_summary as ref_global_summary,
    stack_batches as ref_stack_batches,
    stacked_incoming as ref_stacked_incoming,
)
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.mirror import (  # noqa: E402
    FleetMirror as RefFleetMirror,
    SketchMirror as RefSketchMirror,
)
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu.testing import conformance  # noqa: E402
from zipkin_tpu.tracegen import ColumnarTraceGen, generate_traces  # noqa: E402
from zipkin_tpu_torch import checkpoint as port_checkpoint  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.models.span import Annotation, Endpoint, Span  # noqa: E402
from zipkin_tpu_torch.parallel import multihost as mh  # noqa: E402
from zipkin_tpu_torch.parallel.shard import (  # noqa: E402
    DEP_SUMMARY_K,
    ShardedSpanStore,
    ShardedStore,
    global_summary,
    stack_batches,
    stacked_incoming,
)
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.convert import (  # noqa: E402
    sharded_states_from_numpy,
    sharded_states_to_numpy,
)
from zipkin_tpu_torch.store.memory import InMemorySpanStore  # noqa: E402
from zipkin_tpu_torch.store.mirror import FleetMirror, SketchMirror  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402
from zipkin_tpu_torch.tracegen import generate_traces as port_traces  # noqa: E402

from test_torch_store import (  # noqa: E402
    FLOAT_LEAVES,
    PORT,
    _convert,
    _RefSpanAdapter,
    moments_close,
)

# tests/test_parallel.py's CFG.
SMALL = dict(capacity=256, ann_capacity=1024, bann_capacity=512,
             max_services=16, max_span_names=32, max_annotation_values=64,
             max_binary_keys=16, cms_width=256, hll_p=8,
             quantile_buckets=128)
# tests/test_sharded_serving.py's CFG: the window arena on.
SERVING = dict(SMALL, max_span_names=64, window_seconds=3600,
               window_buckets=4)
END = 2**62


def ref_cfg(kw):
    return dev.StoreConfig(**kw)


def port_cfg(kw):
    return tdev.StoreConfig(**kw)


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.array(jax.devices()[:2]), axis_names=("shard",))


def to_port(db):
    return tdev.DeviceBatch(**db._asdict())


def jax_fleet(states):
    st = jax.device_get(states)
    return {f: getattr(st, f) for f in dev.StoreState._FIELDS}


def assert_fleet_equal(ref, got, where=""):
    """Stacked [n, ...] leaves: integers bitwise, moments to
    tolerance 2."""
    for k in dev.StoreState._FIELDS:
        if k == "counters":
            for c, v in ref[k].items():
                assert np.array_equal(np.asarray(v), got[k][c]), (c, where)
        elif k in FLOAT_LEAVES:
            assert moments_close(ref[k], got[k]), (k, where)
        else:
            a, b = np.asarray(ref[k]), np.asarray(got[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (k, where)
            assert np.array_equal(a, b), (k, int((a != b).sum()), where)


def summary_np(s):
    return {k: np.asarray(v) for k, v in s.items()}


SUMMARY_INTS = ("spans_seen", "svc_span_counts", "svc_hist",
                "cms_trace_spans", "ann_svc_counts", "hll_traces",
                "ts_min", "ts_max")


# ---------------------------------------------------------------------------
# ShardedStore: the per-step summary, against the reference's
# ---------------------------------------------------------------------------

ROUNDS = 25  # 28 spans a shard a round vs capacity 256: laps ~2.7x


@pytest.fixture(scope="module")
def summary_drive(mesh2):
    """tests/test_parallel.py's drive: rounds of 4 traces (7 spans) a
    shard through the reference's ShardedStore and the port's, the
    same padded batches to both; the summaries of every round."""
    ref = RefShardedStore(mesh2, ref_cfg(SMALL))
    port = ShardedStore(2, port_cfg(SMALL), device="cpu")
    gen = ColumnarTraceGen(TpuSpanStore(ref_cfg(SMALL)).dicts,
                           n_services=8, n_span_names=16)
    pad = 4 * gen.spans_per_trace
    rounds, first = [], None
    for _ in range(ROUNDS):
        dbs = []
        for _ in range(2):
            b, lc, ix = gen.next_batch(4)
            dbs.append(dev.make_device_batch(
                b, lc, ix, pad_spans=pad, pad_anns=2 * pad,
                pad_banns=pad))
        first = first or dbs
        stacked = ref_stack_batches(dbs)
        rs = ref.ingest(
            jax.device_put(stacked, NamedSharding(mesh2, P("shard"))),
            incoming=ref_stacked_incoming(stacked))
        pstacked = stack_batches([to_port(d) for d in dbs])
        ps = port.ingest(pstacked, incoming=stacked_incoming(pstacked))
        rounds.append((summary_np(jax.device_get(rs)),
                       {k: v.numpy() for k, v in ps.items()}))
    return dict(ref=ref, port=port, rounds=rounds, first=first,
                spans_per_trace=gen.spans_per_trace)


def test_fleet_ingest_totals(summary_drive):
    _, got = summary_drive["rounds"][0]
    assert float(got["spans_seen"]) == 2 * 4 * 7
    assert float(got["svc_span_counts"].sum()) == 2 * 4 * 7
    for i, (want, got) in enumerate(summary_drive["rounds"]):
        for k in SUMMARY_INTS:
            assert want[k].dtype == got[k].dtype, k
            assert np.array_equal(want[k], got[k]), (k, i)
        assert moments_close(want["dep_moments"], got["dep_moments"]), i
    assert_fleet_equal(jax_fleet(summary_drive["ref"].states),
                       sharded_states_to_numpy(summary_drive["port"].states))


def test_fleet_hll_is_union(summary_drive):
    want, got = summary_drive["rounds"][0]
    assert np.array_equal(want["hll_traces"], got["hll_traces"])
    from zipkin_tpu.ops import hll as ref_hll
    from zipkin_tpu_torch.ops import hll

    est = hll.estimate(got["hll_traces"])
    true = 2 * 4  # all trace ids distinct across shards
    assert abs(est - true) / true < 0.25
    assert est == pytest.approx(float(ref_hll.estimate(
        ref_hll.HyperLogLog(want["hll_traces"]))), rel=1e-5)


def test_fleet_dep_moments_match_single_state(summary_drive):
    """The fleet's cross-shard moments after one round == one state
    stepping both shards' batches (counts exact)."""
    single = tdev.init_state(port_cfg(SMALL), "cpu")
    for db in summary_drive["first"]:
        tdev.ingest_step(single, tdev.batch_to_device(to_port(db), "cpu"))
    want = tdev.total_dep_moments(single).numpy().astype(np.float64)
    got = summary_drive["rounds"][0][1]["dep_moments"].astype(np.float64)
    nz = np.flatnonzero(want[:, 0] > 0)
    assert nz.size > 0
    np.testing.assert_allclose(got[nz, 0], want[nz, 0])  # counts exact
    np.testing.assert_allclose(got[nz, 1], want[nz, 1], rtol=1e-5)
    np.testing.assert_allclose(got[nz, 2], want[nz, 2], rtol=1e-3)


def test_fleet_dep_links_survive_eviction(summary_drive):
    """Ring wraparound on the shards must not lose dependency links:
    the per-shard bucket close folds links of soon-to-be-evicted
    children, so summaries never regress."""
    last = 0.0
    for want, got in summary_drive["rounds"]:
        total = float(got["dep_moments"][:, 0].sum())
        assert total >= last
        assert total == float(want["dep_moments"][:, 0].sum())
        last = total
    assert last == 2 * ROUNDS * 4 * (summary_drive["spans_per_trace"] - 1)
    assert summary_drive["port"].states[0].write_pos.item() > 2 * 256


def test_fleet_summary_compaction_on_both_sides_of_k(summary_drive, mesh2):
    """The summary merges only the top-k live dependency cells; it must
    equal the full merge bit for bit on both sides of the k edge:
    exactly k live cells (every live cell compacted) and k - 1 (the
    full fallback), and equal the reference's full merge to
    tolerance 2."""
    states = summary_drive["port"].states
    want = global_summary(states, dep_k=None)["dep_moments"].numpy()
    nz = int((want[:, 0] > 0).sum())
    cells = want.shape[0]
    assert 1 < nz < 128 < cells, (nz, cells)
    for k in (nz, nz - 1, 128, 1, DEP_SUMMARY_K):
        got = global_summary(states, dep_k=k)["dep_moments"].numpy()
        assert np.array_equal(got, want), k
    ref = np.asarray(ref_global_summary(summary_drive["ref"].states, mesh2,
                                        dep_k=None)["dep_moments"])
    assert moments_close(ref, want)


# ---------------------------------------------------------------------------
# ShardedSpanStore: every read against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleets(mesh2):
    """The reference's and the port's 2-shard ShardedSpanStore (window
    arena on) fed the same spans: enough that every shard's span and
    annotation rings lap."""
    ref = RefShardedSpanStore(mesh2, ref_cfg(SERVING))
    raw = ShardedSpanStore(2, port_cfg(SERVING), device="cpu",
                           registry=obs.Registry())
    port = _RefSpanAdapter(raw)
    traces = generate_traces(n_traces=220, max_depth=3, n_services=6,
                             rng=np.random.default_rng(11))
    spans = [s for t in traces for s in t]
    for i in range(0, len(spans), 100):
        ref.apply(spans[i:i + 100])
        port.apply(spans[i:i + 100])
    yield dict(ref=ref, port=port, raw=raw, traces=traces)
    raw.close()
    ref.close()


def test_fleet_states_match_reference(fleets):
    got = sharded_states_to_numpy(fleets["raw"].states)
    assert (got["write_pos"] > 256).all(), "every shard's ring laps"
    assert_fleet_equal(jax_fleet(fleets["ref"].inner.states), got)


def _links(deps):
    return sorted((l.parent, l.child, l.duration_moments)
                  for l in deps.links)


def test_fleet_reads_match_reference(fleets):
    """Every read of the SPI: catalogs, id lookups (direct, dispatched,
    batched), trace fetches, durations, dependencies, quantiles, top-k,
    windowed reads, cardinality and counters."""
    ref, port, traces = fleets["ref"], fleets["port"], fleets["traces"]
    services = sorted(ref.get_all_service_names())
    assert services and port.get_all_service_names() == set(services)
    queries = []
    for svc in services:
        assert port.get_span_names(svc) == ref.get_span_names(svc)
        for name in [None] + sorted(ref.get_span_names(svc))[:2]:
            for limit in (3, 10, 50):
                want = ref.get_trace_ids_by_name(svc, name, END, limit)
                assert port.get_trace_ids_by_name(svc, name, END,
                                                  limit) == want
                queries.append(("name", svc, name, END, limit))
        for ann, val in (("some custom annotation", None),
                         ("http.uri", b"/api/widgets"), ("http.uri", None)):
            want = ref.get_trace_ids_by_annotation(svc, ann, val, END, 10)
            assert port.get_trace_ids_by_annotation(svc, ann, val, END,
                                                    10) == want
            queries.append(("annotation", svc, ann, val, END, 10))
        assert (port.service_duration_quantiles(svc, [0.5, 0.99])
                == ref.service_duration_quantiles(svc, [0.5, 0.99]))
        assert port.top_annotations(svc) == ref.top_annotations(svc)
        assert port.top_binary_keys(svc) == ref.top_binary_keys(svc)
        assert (port.windowed_quantiles(svc, [0.5, 0.99])
                == ref.windowed_quantiles(svc, [0.5, 0.99]))
        assert port.latency_heatmap(svc) == ref.latency_heatmap(svc)
    assert any(ref.get_trace_ids_by_name(s, None, END, 10)
               for s in services)
    assert port.get_trace_ids_multi(queries) == \
        ref.get_trace_ids_multi(queries)
    tids = [t[0].trace_id for t in traces[-60:]] + [12345]
    old = [t[0].trace_id for t in traces[:40]]
    for ids in (tids, old):
        assert port.get_spans_by_trace_ids(ids) == \
            ref.get_spans_by_trace_ids(ids)
        assert port.traces_exist(ids) == ref.traces_exist(ids)
        assert port.get_traces_duration(ids) == ref.get_traces_duration(ids)
    assert port.get_spans_by_trace_id(tids[0]) == \
        ref.get_spans_by_trace_id(tids[0])
    assert ref.get_dependencies().links, "no dependency links"
    for window in ((None, None), (0, END), (0, 1)):
        a = _links(ref.get_dependencies(*window))
        b = _links(port.get_dependencies(*window))
        assert [x[:2] for x in a] == [x[:2] for x in b]
        for (_, _, ma), (_, _, mb) in zip(a, b):
            assert ma.n == mb.n
            assert mb.mean == pytest.approx(ma.mean, rel=1e-5)
    assert port.estimated_unique_traces() == pytest.approx(
        ref.estimated_unique_traces(), rel=1e-5)
    assert port.stored_span_count() == ref.stored_span_count()
    assert port.counters() == ref.counters()
    assert port.shard_counters() == ref.shard_counters()


def test_fleet_mirror_matches_reference_and_device(fleets):
    """The fleet sketch tier: the port's FleetMirror bitwise equal to
    the reference's, both over the live stores and when built from the
    same per-shard mirrors, and its lifetime arrays equal to the sums
    and maxima of the device leaves."""
    raw, ref = fleets["raw"], fleets["ref"]
    got = raw.ensure_sketch_mirror().arrays()
    want = ref.ensure_sketch_mirror().arrays()
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b)
    leaves = sharded_states_to_numpy(raw.states)
    per_shard = [[leaves[f][i] for f in ShardedSpanStore._MIRROR_LEAVES]
                 for i in range(2)]
    ref_m, port_m = [], []
    for arrays in per_shard:
        ref_m.append(RefSketchMirror(ref_cfg(SERVING)))
        ref_m[-1].adopt(*arrays)
        port_m.append(SketchMirror(port_cfg(SERVING)))
        port_m[-1].adopt(*arrays)
    rebuilt = FleetMirror(port_cfg(SERVING), port_m, lambda: 0).arrays()
    ref_rebuilt = RefFleetMirror(ref_cfg(SERVING), ref_m,
                                 lambda: 0).arrays()
    for a, b, c in zip(ref_rebuilt, rebuilt, got):
        assert np.array_equal(np.asarray(a), b)
        assert np.array_equal(b, c)
    for i, f in enumerate(ShardedSpanStore._MIRROR_LEAVES[:6]):
        dev_merge = (leaves[f].max(0) if f == "hll_traces"
                     else leaves[f].sum(0, dtype=leaves[f].dtype))
        assert np.array_equal(got[i], dev_merge), f


def test_sharded_states_round_trip(fleets):
    want = jax_fleet(fleets["ref"].inner.states)
    states = sharded_states_from_numpy(port_cfg(SERVING), want,
                                       device="cpu")
    assert len(states) == 2
    got = sharded_states_to_numpy(states)
    for k in dev.StoreState._FIELDS:
        if k == "counters":
            for c, v in want[k].items():
                assert np.array_equal(np.asarray(v), got[k][c]), c
        else:
            assert np.array_equal(np.asarray(want[k]), got[k]), k


_CONFORMANCE_STORES = []


@pytest.fixture(scope="module")
def conformance_stores():
    yield _CONFORMANCE_STORES
    while _CONFORMANCE_STORES:
        _CONFORMANCE_STORES.pop().close()


def _conformance_store():
    store = ShardedSpanStore(2, port_cfg(SMALL), device="cpu",
                             registry=obs.Registry())
    _CONFORMANCE_STORES.append(store)
    return _RefSpanAdapter(store)


@pytest.mark.parametrize("name", conformance.conformance_test_names())
def test_fleet_conformance(conformance_stores, name):
    """The JAX package's SPI conformance suite over a 2-shard port
    store (SpanStoreValidator.scala:27 reused across backends)."""
    conformance.run_conformance_test(name, _conformance_store)


# ---------------------------------------------------------------------------
# Port-side counterparts of the reference's sharded tests
# ---------------------------------------------------------------------------


@pytest.fixture()
def new_store():
    made = []

    def make(n, kw, **extra):
        store = ShardedSpanStore(n, port_cfg(kw), device="cpu",
                                 registry=obs.Registry(), **extra)
        made.append(store)
        return store

    yield make
    for store in made:
        store.close()


def _port_spans(n_traces, n_services, seed=None):
    rng = None if seed is None else np.random.default_rng(seed)
    return [s for t in port_traces(n_traces=n_traces, max_depth=3,
                                   n_services=n_services, rng=rng)
            for s in t]


def test_fleet_query_roundtrip(new_store):
    """Tracegen traffic in, every read API answers across shards."""
    store = new_store(2, SMALL)
    spans = _port_spans(12, 6, seed=1)
    store.apply(spans)
    assert store.stored_span_count() == float(len(spans))
    svc = sorted(store.get_all_service_names())[0]
    ids = store.get_trace_ids_by_name(svc, None, END, 10)
    assert ids
    assert len({i.trace_id for i in ids}) == len(ids)
    found = store.get_spans_by_trace_ids([i.trace_id for i in ids[:4]])
    assert found and all(found)
    # Spans of one trace live on exactly one shard (trace-affine
    # routing), and the cross-shard fetch returns them all.
    for tr in found:
        tid = tr[0].trace_id
        assert len(tr) == sum(1 for s in spans if s.trace_id == tid)
        assert {store._shard_of(s.trace_id) for s in tr} == {
            mh.shard_of(tid, 2)}
    assert store.get_dependencies().links
    assert store.service_duration_quantiles(svc, [0.5, 0.99]) is not None
    assert store.estimated_unique_traces() > 0


def test_fleet_multi_query_matches_singular(new_store):
    """get_trace_ids_multi (one fused read for all probes) answers
    exactly what the singular sharded paths — and a single-store port
    oracle — answer."""
    store = new_store(2, SMALL)
    oracle = TorchSpanStore(port_cfg(SMALL), device="cpu")
    spans = _port_spans(24, 5, seed=2)
    store.apply(spans)
    oracle.apply(spans)
    end_ts = max(s.last_timestamp for s in spans if s.last_timestamp) + 1
    queries = []
    for svc in sorted(oracle.get_all_service_names()):
        queries.append(("name", svc, None, end_ts, 10))
        queries.append(("annotation", svc, "some custom annotation",
                        None, end_ts, 10))
        queries.append(("annotation", svc, "http.uri", b"/api/widgets",
                        end_ts, 10))
        queries.append(("annotation", svc, "http.uri", None, end_ts, 10))
    queries.append(("name", "no-such-svc", None, end_ts, 10))
    got = store.get_trace_ids_multi(queries)
    assert len(got) == len(queries)

    def ids(r):
        return sorted((i.trace_id, i.timestamp) for i in r)

    nonempty = 0
    for q, res in zip(queries, got):
        if q[0] == "name":
            single = store.get_trace_ids_by_name(*q[1:])
            want = oracle.get_trace_ids_by_name(*q[1:])
        else:
            single = store.get_trace_ids_by_annotation(*q[1:])
            want = oracle.get_trace_ids_by_annotation(*q[1:])
        assert ids(res) == ids(single) == ids(want), q
        nonempty += bool(want)
    assert nonempty > 0


def test_fleet_routing_math(new_store):
    """The producer-side partitioner, the store's placement hash and
    the reference's hash agree, negative and unsigned ids included."""
    store = new_store(2, SMALL)
    rng = np.random.default_rng(4)
    ids = [int(x) for x in rng.integers(-2**63, 2**63 - 1, 200,
                                        dtype=np.int64)]
    ids += [int(x) for x in rng.integers(0, 2**64 - 1, 50,
                                         dtype=np.uint64)]
    for n in (1, 2, 3, 8):
        for tid in ids:
            assert mh.shard_of(tid, n) == ref_mh.shard_of(tid, n)
            assert mh.partition_for_trace(tid, n) == mh.shard_of(tid, n)
    for tid in ids:
        assert store._shard_of(tid) == mh.shard_of(tid, 2)
    spans = _port_spans(20, 4, seed=5)
    groups = mh.route_spans(spans, 4)
    assert sum(len(g) for g in groups.values()) == len(spans)
    for sid, group in groups.items():
        assert all(mh.shard_of(s.trace_id, 4) == sid for s in group)
    sub = mh.route_spans(spans, 4, keep=[0, 1])
    assert set(sub) <= {0, 1}
    assert sum(len(g) for g in sub.values()) == sum(
        len(g) for sid, g in groups.items() if sid in (0, 1))


def test_fleet_overflow_service_routes_to_scan(new_store):
    """Overflow services (dictionary id >= max_services) scan on the
    sharded store too — the index path would trusted-empty them; the
    catalog reads must not clamp overflow ids into the last row."""
    cfg = dict(capacity=1 << 10, ann_capacity=1 << 12,
               bann_capacity=1 << 11, max_services=4, use_index=True)
    sharded = new_store(2, cfg)
    oracle = new_store(2, dict(cfg, use_index=False))
    big = new_store(2, dict(cfg, max_services=32))
    spans = _port_spans(24, 12, seed=6)
    names = {a.host.service_name for s in spans for a in s.annotations
             if a.host and a.host.service_name}
    assert len(names) > 4
    for st in (sharded, oracle, big):
        st.apply(spans)
    end_ts = max(s.last_timestamp for s in spans if s.last_timestamp) + 1

    def ids(res):
        return sorted((i.trace_id, i.timestamp) for i in res)

    def canon(pairs):  # top-k tie ORDER is not a product guarantee
        return sorted(pairs, key=lambda p: (-p[1], p[0]))

    for svc in sorted(names):
        assert ids(sharded.get_trace_ids_by_name(svc, None, end_ts, 10)) \
            == ids(oracle.get_trace_ids_by_name(svc, None, end_ts, 10)), svc
        assert ids(sharded.get_trace_ids_by_annotation(
            svc, "some custom annotation", None, end_ts, 10)) == \
            ids(oracle.get_trace_ids_by_annotation(
                svc, "some custom annotation", None, end_ts, 10)), svc
        assert sharded.get_span_names(svc) == big.get_span_names(svc), svc
        assert canon(sharded.top_annotations(svc, 999)) == \
            canon(big.top_annotations(svc, 999)), svc
        assert canon(sharded.top_binary_keys(svc, 999)) == \
            canon(big.top_binary_keys(svc, 999)), svc
        assert sharded.service_duration_quantiles(svc, [0.5, 0.99]) == \
            big.service_duration_quantiles(svc, [0.5, 0.99]), svc
    assert sharded.get_all_service_names() == big.get_all_service_names()


def test_fleet_concurrent_catalog_reads_finish(new_store):
    """N API threads each running a fused cross-shard read (catalogs,
    quantiles, cardinality, span names) under the shared read lock:
    the _coll_lock serialization keeps them from interleaving, and
    every thread finishes inside a hard timeout."""
    store = new_store(2, SMALL)
    store.apply(_port_spans(10, 6, seed=7))
    svc = sorted(store.get_all_service_names())[0]
    want = (store.service_duration_quantiles(svc, [0.5, 0.99]),
            store.estimated_unique_traces(), store.get_span_names(svc))
    errors = []

    def worker():
        try:
            for _ in range(3):
                assert store.get_all_service_names()
                got = (store.service_duration_quantiles(svc, [0.5, 0.99]),
                       store.estimated_unique_traces(),
                       store.get_span_names(svc))
                assert got == want
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not [t for t in threads if t.is_alive()], "catalog reader hung"
    assert not errors, errors


def _mk_span(tid, sid, ts, svc="pinned-svc"):
    ep = Endpoint(1, 80, svc)
    return Span(tid, "op", sid, None,
                (Annotation(ts, "sr", ep), Annotation(ts + 5, "custom", ep)),
                ())


def _flood(store, n_spans, base_sid=10_000):
    ep = Endpoint(2, 80, "noise")
    chunk = []
    for i in range(n_spans):
        chunk.append(Span(5_000_000 + i, "noise-op", base_sid + i, None,
                          (Annotation(50 + i, "sr", ep),), ()))
        if len(chunk) == 256:
            store.apply(chunk)
            chunk = []
    if chunk:
        store.apply(chunk)


def test_fleet_pinned_trace_survives_eviction(new_store):
    cfg = dict(SMALL, capacity=128, ann_capacity=512, bann_capacity=256,
               hll_p=6)
    store = new_store(2, cfg)
    tid = 909090
    store.apply([_mk_span(tid, 1, 10), _mk_span(tid, 2, 20)])
    store.set_time_to_live(tid, 30 * 24 * 3600.0)
    _flood(store, 2 * 2 * 128)
    assert store.counters()["ring_laps"] >= 2
    got = store.get_spans_by_trace_id(tid)
    assert sorted(s.id for s in got) == [1, 2]
    assert tid in store.traces_exist([tid])
    assert store.get_time_to_live(tid) == 30 * 24 * 3600.0


HOUR = 3_600_000_000  # µs


def _pair(parent_svc, child_svc, tid, base_ts):
    pa = Endpoint(1, 80, parent_svc)
    ca = Endpoint(2, 80, child_svc)
    parent = Span(tid, "op", 1, None,
                  (Annotation(base_ts, "sr", pa),
                   Annotation(base_ts + 100, "ss", pa)), ())
    child = Span(tid, "op2", 2, 1,
                 (Annotation(base_ts + 10, "sr", ca),
                  Annotation(base_ts + 60, "ss", ca)), ())
    return [parent, child]


def test_fleet_dependencies_window(new_store):
    store = new_store(2, dict(
        capacity=1 << 10, ann_capacity=1 << 12, bann_capacity=1 << 11,
        max_services=32, max_span_names=64, max_annotation_values=128,
        max_binary_keys=32, cms_width=512, hll_p=6, quantile_buckets=128,
        dep_buckets=4))
    store.apply(_pair("alpha", "beta", 100, 1 * HOUR))

    def links(deps):
        return {(l.parent, l.child) for l in deps.links}

    assert links(store.get_dependencies(1 * HOUR, 2 * HOUR)) == {
        ("alpha", "beta")}
    assert links(store.get_dependencies(5 * HOUR, 6 * HOUR)) == set()


def test_fleet_rejects_paged_layout():
    paged = port_cfg(dict(SMALL, capacity=1 << 10, layout="paged",
                          page_rows=64))
    with pytest.raises(ValueError, match="single-device only"):
        ShardedStore(2, paged, device="cpu")
    with pytest.raises(ValueError, match="single-device only"):
        ShardedSpanStore(2, paged, device="cpu", registry=obs.Registry())


def test_fleet_durability_is_ported(new_store, tmp_path):
    """Item 6b is ported: the sharded log, the pipeline and the
    checkpoint run on the fleet, and no entry point raises naming it or
    falls back to a single-store path; ingest without incoming= is the
    reference's TypeError. tests/test_torch_sharded_durability.py holds
    what they produce against the reference."""
    from zipkin_tpu_torch.wal import ShardedWal

    store = new_store(2, SMALL)
    wal = ShardedWal(str(tmp_path / "wal"), 2, fsync="off")
    try:
        store.attach_wal(wal)
        store.apply(_port_spans(4, 3, seed=8))
        with store.pipelined(2) as pipe:
            store.apply(_port_spans(4, 3, seed=9))
            assert pipe is store._pipeline
        store.drain_pipeline()
        store.stop_pipeline()
        store.wal_sync()
        assert wal.last_seq == wal.durable_seq == 2 == store._wal_applied
        port_checkpoint.save(store, str(tmp_path / "ckpt"))
        assert (tmp_path / "ckpt" / "meta.json").exists()
        store.close()
    finally:
        wal.close()
    with pytest.raises(TypeError, match="incoming"):
        store.inner.ingest(())


def test_dispatched_reads_match_memory_oracle(new_store):
    """Direct and dispatched id reads and the trace fetch against the
    port's in-memory oracle, on traffic that stays resident."""
    store = new_store(2, SERVING)
    oracle = InMemorySpanStore()
    spans = _port_spans(12, 4, seed=3)
    store.apply(spans)
    oracle.apply(spans)

    def key(ids):
        return sorted((int(i.trace_id), int(i.timestamp)) for i in ids)

    for svc in sorted(oracle.get_all_service_names()):
        want = key(oracle.get_trace_ids_by_name(svc, None, END, 50))
        assert key(store.get_trace_ids_by_name(svc, None, END, 50)) == want
        assert key(store._get_trace_ids_by_name_direct(
            svc, None, END, 50)) == want
        assert store.get_span_names(svc) == oracle.get_span_names(svc)
    tids = sorted({s.trace_id for s in spans})
    got = {tr[0].trace_id: len(tr)
           for tr in store.get_spans_by_trace_ids(tids)}
    assert got == {t: sum(1 for s in spans if s.trace_id == t)
                   for t in tids}


def test_port_spans_convert_like_reference():
    """The port's tracegen copy makes the reference's spans from the
    same seed, so port-only drives here sit on the traffic the
    reference's tests use."""
    ref = [s for t in generate_traces(n_traces=6, max_depth=3,
                                      n_services=4,
                                      rng=np.random.default_rng(9))
           for s in t]
    assert _convert(ref, PORT) == _port_spans(6, 4, seed=9)
