"""Sharded serving on the port (``zipkin_tpu_torch.parallel``), on the
CPU: the cross-shard dispatcher's fusion accounting and bitwise
identity with serialized reads, dispatcher-routed reads against the
port's in-memory oracle while a writer ingests, the per-shard gauges,
and the dispatcher's self-trace span sink — the counterparts of
``tests/test_sharded_serving.py`` and ``tests/test_fleet.py``'s
``TestDispatcherSpanSink`` (the sharded log, checkpoint and pipeline
cases there wait for the port's sharded durability).

Every store and dispatcher made here is closed in a fixture finalizer,
and every join has a timeout.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.models.span import Annotation, Endpoint, Span  # noqa: E402
from zipkin_tpu_torch.obs import fleet as fobs  # noqa: E402
from zipkin_tpu_torch.parallel.dispatch import CrossShardDispatcher  # noqa: E402
from zipkin_tpu_torch.parallel.shard import ShardedSpanStore  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.memory import InMemorySpanStore  # noqa: E402
from zipkin_tpu_torch.tracegen import generate_traces  # noqa: E402

# tests/test_sharded_serving.py's CFG (the window arena on).
CFG = tdev.StoreConfig(
    capacity=256, ann_capacity=1024, bann_capacity=512,
    max_services=16, max_span_names=64, max_annotation_values=64,
    max_binary_keys=16, cms_width=256, hll_p=8, quantile_buckets=128,
    window_seconds=3600, window_buckets=4,
)
JOIN_S = 120.0


@pytest.fixture()
def fleet():
    made = []

    def make(**kw):
        kw.setdefault("registry", obs.Registry())
        store = ShardedSpanStore(2, CFG, device="cpu", **kw)
        made.append(store)
        return store

    yield make
    for store in made:
        store.close()


@pytest.fixture()
def dispatchers():
    made = []

    def make(store, **kw):
        d = CrossShardDispatcher(store, registry=obs.Registry(), **kw)
        made.append(d)
        return d

    yield make
    for d in made:
        d.close()


def _spans(n_traces=12, n_services=6, seed=7):
    return [s for t in generate_traces(
        n_traces=n_traces, max_depth=3, n_services=n_services,
        rng=np.random.default_rng(seed)) for s in t]


def _disjoint_spans(n, seed):
    """Hand-built spans on 'xtra-*' services the oracle never queries:
    concurrent-ingest noise that cannot collide with the generated
    service/span-name universe."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tid = int(rng.integers(1, 2**62))
        ep = Endpoint(1, 80, f"xtra-{int(rng.integers(0, 4))}")
        out.append(Span(tid, "xtra-op", tid, None, (
            Annotation(1_000_000_000_000 + tid % 10_000, "sr", ep),
            Annotation(1_000_000_000_100 + tid % 10_000, "ss", ep),
        )))
    return out


def _ids_key(ids):
    return sorted((int(i.trace_id), int(i.timestamp)) for i in ids)


def _join_all(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    return [t for t in threads if t.is_alive()]


def test_dispatcher_fuses_concurrent_reads(fleet):
    """8 concurrent reads (4 catalog + 4 index) land in one dispatcher
    micro-window and cost <= 2 fused cross-shard reads — one catalog
    bundle, one multi-probe read — counter-proven via
    collective_launches() deltas, with results identical to serialized
    execution."""
    store = fleet()
    store.apply(_spans())
    svcs = sorted(store.get_all_service_names())[:4]
    for svc in svcs:
        store.service_duration_quantiles(svc, [0.5, 0.99])
        store.get_trace_ids_by_name(svc, None, 2**62, 10)
    store.dispatcher.drain()
    # The micro-window (writable at runtime) only for the burst.
    store.dispatcher.window_s = 1.0

    barrier = threading.Barrier(9)
    results = {}
    errors = []

    def cat_worker(i, svc):
        try:
            barrier.wait(timeout=JOIN_S)
            results[i] = store.service_duration_quantiles(svc, [0.5, 0.99])
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    def ids_worker(i, svc):
        try:
            barrier.wait(timeout=JOIN_S)
            results[i] = _ids_key(store.get_trace_ids_by_name(
                svc, None, 2**62, 10))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = (
        [threading.Thread(target=cat_worker, args=(i, svcs[i]), daemon=True)
         for i in range(4)]
        + [threading.Thread(target=ids_worker, args=(4 + i, svcs[i]),
                            daemon=True) for i in range(4)]
    )
    for t in threads:
        t.start()
    before = store.collective_launches()
    barrier.wait(timeout=JOIN_S)
    assert not _join_all(threads), "reader hung"
    assert not errors, errors
    delta = store.collective_launches() - before
    assert delta <= 2, (
        f"8 concurrent reads cost {delta} fused cross-shard reads; the "
        "dispatcher must fuse them into <= 2 (one catalog bundle + one "
        "multi-probe read)")
    assert store.dispatcher.stats()["launches_saved"] >= 6
    store.dispatcher.window_s = 0.0
    # Bitwise identity with serialized execution: re-issue every query
    # alone (a batch of one rides the singular reads).
    for i in range(4):
        assert results[i] == store.service_duration_quantiles(
            svcs[i], [0.5, 0.99])
        assert results[4 + i] == _ids_key(
            store.get_trace_ids_by_name(svcs[i], None, 2**62, 10))


def test_singular_reads_count_one_fused_read_each(fleet):
    """A lone read is one fused cross-shard read: the catalog key's own
    read, one index read, one durations read on an exact gate."""
    store = fleet()
    spans = _spans(n_traces=8, seed=5)
    store.apply(spans)
    svc = sorted(store.get_all_service_names())[0]
    store.dispatcher.drain()
    for read in (lambda: store.stored_span_count(),
                 lambda: store.estimated_unique_traces(),
                 lambda: store.get_trace_ids_by_name(svc, None, 2**62, 10),
                 lambda: store.traces_exist([spans[0].trace_id])):
        before = store.collective_launches()
        read()
        assert store.collective_launches() - before == 1
    before = store.collective_launches()
    a, b = store._fetch_cat_bundle(), store._cat_direct("svc_hist")
    assert store.collective_launches() - before == 2
    assert np.array_equal(a["svc_hist"], b)


def test_dispatcher_reads_match_memory_oracle_under_ingest(fleet):
    """N threads issue mixed queries (trace-id index, span-name catalog,
    fleet-mirror windowed quantiles, cross-shard trace fetch) while a
    writer keeps ingesting on disjoint services; every answer equals the
    in-memory oracle's (device reads) or the pre-ingest fleet answer
    (windowed reads, which the disjoint writer must not perturb)."""
    store = fleet(dispatch_window_s=0.02)
    oracle = InMemorySpanStore()
    base = _spans(n_traces=12, n_services=4, seed=3)
    store.apply(base)
    oracle.apply(base)
    svcs = sorted(oracle.get_all_service_names())
    expect_ids = {svc: _ids_key(oracle.get_trace_ids_by_name(
        svc, None, 2**62, 50)) for svc in svcs}
    expect_names = {svc: set(oracle.get_span_names(svc)) for svc in svcs}
    expect_wq = {svc: store.windowed_quantiles(svc, [0.5, 0.99])
                 for svc in svcs}
    assert any(v is not None for v in expect_wq.values())
    by_trace = {}
    for s in base:
        by_trace[s.trace_id] = by_trace.get(s.trace_id, 0) + 1
    errors = []

    def writer():
        # Disjoint 'xtra-*' services, little enough volume that the
        # base spans never evict (ring 256 a shard).
        try:
            for i in range(3):
                store.apply(_disjoint_spans(12, seed=100 + i))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    def reader():
        try:
            for _ in range(3):
                for svc in svcs:
                    assert _ids_key(store.get_trace_ids_by_name(
                        svc, None, 2**62, 50)) == expect_ids[svc], svc
                    assert set(store.get_span_names(svc)) == \
                        expect_names[svc], svc
                    assert store.windowed_quantiles(
                        svc, [0.5, 0.99]) == expect_wq[svc], svc
                tids = list(by_trace)[:4]
                for tr in store.get_spans_by_trace_ids(tids):
                    assert len(tr) == by_trace[tr[0].trace_id]
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=writer, daemon=True)] + [
        threading.Thread(target=reader, daemon=True) for _ in range(5)]
    for t in threads:
        t.start()
    assert not _join_all(threads), "hung"
    assert not errors, errors
    assert store.dispatcher.stats()["requests"] > 0
    assert store.stored_span_count() == float(len(base) + 36)


def test_shard_occupancy_gauges_track_per_shard_state(fleet):
    """Per-shard occupancy/lap gauges read off the memoized counter
    blocks and key by shard index."""
    reg = obs.Registry()
    store = fleet(registry=reg)
    store.apply(_spans(n_traces=8, seed=41))
    occ = store._occupancy_by_shard()
    laps = store._laps_by_shard()
    assert set(occ) == {"0", "1"}
    assert sum(occ.values()) == store.counters()["ring_occupancy"]
    assert all(v >= 0 for v in laps.values())
    fam = reg.get("zipkin_shard_occupancy")
    assert fam is not None
    assert {labels[0][1]: v for _, labels, v in fam.samples()} == occ
    per_shard = store.shard_counters()
    assert len(per_shard) == 2
    assert sum(b["ring_occupancy"] for b in per_shard) == \
        store.counters()["ring_occupancy"]
    store.close()
    assert reg.get("zipkin_shard_occupancy") is None
    assert reg.get("zipkin_shard_ring_laps") is None


def test_dispatcher_stuck_probe_reads_queue_age(fleet):
    """The watchdog's dispatcher probe (obs.fleet.dispatcher_stuck_probe)
    over the store's own dispatcher: healthy at idle."""
    store = fleet()
    probe = fobs.dispatcher_stuck_probe(store.dispatcher,
                                        stall_after_s=5.0)
    ok, reason, age = probe()
    assert ok and reason is None and age == 0.0


class TestDispatcherSpanSink:
    def test_fused_batch_parents_under_request_context(self, dispatchers):
        store = SimpleNamespace(CAT_BUNDLE_KEYS=frozenset(),
                                _cat_direct=lambda key: {"n": 1})
        d = dispatchers(store)
        spans = []
        d.span_sink = SimpleNamespace(
            record_span=lambda *a, **k: spans.append((a, k)))
        token = fobs.set_request_context(0xAB, 0xCD)
        try:
            assert d.cat("svc") == {"n": 1}
        finally:
            fobs.reset_request_context(token)
        d.close()
        assert spans, "dispatch span not recorded"
        (args, _kw) = spans[0]
        trace_id, parent_id, name = args[0], args[1], args[2]
        assert (trace_id, parent_id) == (0xAB, 0xCD)
        assert name == "shard dispatch"

    def test_no_context_no_span(self, dispatchers):
        store = SimpleNamespace(CAT_BUNDLE_KEYS=frozenset(),
                                _cat_direct=lambda key: {})
        d = dispatchers(store)
        spans = []
        d.span_sink = SimpleNamespace(
            record_span=lambda *a, **k: spans.append(a))
        d.cat("svc")
        d.close()
        assert not spans

    def test_queue_age_idle_zero(self, dispatchers):
        d = dispatchers(SimpleNamespace(CAT_BUNDLE_KEYS=frozenset(),
                                        _cat_direct=lambda key: {}))
        assert d.queue_age_s() == 0.0
        d.close()


def test_query_service_and_api_over_the_fleet(fleet):
    """The read stack the daemon puts over a store (QueryService with
    its resident engine, ApiServer) serves a fleet: every answer equals
    the same stack over a single port store fed the same spans (the
    engine's sketch tier reads the FleetMirror)."""
    from zipkin_tpu_torch.api import ApiServer, extract_query
    from zipkin_tpu_torch.query import QueryService
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore

    store = fleet()
    single = TorchSpanStore(CFG, device="cpu")
    spans = _spans(n_traces=16, n_services=5, seed=13)
    store.apply(spans)
    single.apply(spans)
    services = [QueryService(s, registry=obs.Registry())
                for s in (store, single)]
    try:
        apis = [ApiServer(q, registry=obs.Registry()) for q in services]
        names = sorted(single.get_all_service_names())
        for name in names:
            req = extract_query({"serviceName": name, "limit": "10"})
            a, b = (q.get_trace_ids(req) for q in services)
            assert a.trace_ids == b.trace_ids and a.trace_ids, name
            assert (services[0].get_service_duration_quantiles(
                name, [0.5, 0.99]) == services[1]
                .get_service_duration_quantiles(name, [0.5, 0.99]))
        for route, params in (("/api/services", {}),
                              ("/api/spans", {"serviceName": names[0]})):
            got = [api.handle("GET", route, params) for api in apis]
            assert got[0][0] == 200 and got[0] == got[1], route
        # Dependencies: counts exact, moments by stated tolerance 2 (the
        # fleet merges its shards' banks in another order), links by
        # name (the two stores intern services in another order).
        deps = [sorted(api.handle("GET", "/api/dependencies", {})[1]
                       ["links"], key=lambda l: (l["parent"], l["child"]))
                for api in apis]
        assert deps[0] and len(deps[0]) == len(deps[1])
        for a, b in zip(*deps):
            assert (a["parent"], a["child"]) == (b["parent"], b["child"])
            ma, mb = a["durationMoments"], b["durationMoments"]
            assert ma["count"] == mb["count"]
            assert ma["mean"] == pytest.approx(mb["mean"], rel=1e-5)
    finally:
        for q in services:
            q.close()
