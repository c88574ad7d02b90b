"""The port's resident query engine and coalescers, on the CPU.

The cases of ``tests/test_query_engine.py`` and ``tests/test_coalesce.py``
on ``TorchSpanStore(device="cpu")``: the sketch tier equals the store's
own read path bitwise; result-cache hits are bitwise equal and keyed by
the write frontier; commits, pins and TTLs invalidate; answers stay
exact under concurrent ingest and through eviction capture; the
executor joins the ordered shutdown and ``checkpoint.save`` drains it;
the window plumbs through; an engine over a host store is a plain
facade; coalesced reads equal serial ones. Where the reference package
runs the same drive, the port's answers equal its answers (the HLL
estimate within ``rel=1e-5``: float64 against float32).

Every engine a test starts is closed by the ``engines`` fixture's
finalizer, so no ``zipkin-query-exec`` thread outlives its test.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from zipkin_tpu.query.engine import QueryEngine as RefEngine  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.query import (  # noqa: E402
    QueryCoalescer,
    QueryEngine,
    QueryRequest,
    QueryService,
    ResidentCoalescer,
)
from zipkin_tpu_torch.query.engine import DEFAULT_COALESCE_WINDOW_S  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.memory import InMemorySpanStore  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402

from test_torch_store import PORT, _convert  # noqa: E402

CONFIG = dict(
    capacity=1 << 10, ann_capacity=1 << 12, bann_capacity=1 << 11,
    max_services=32, max_span_names=64, max_annotation_values=256,
    max_binary_keys=64, cms_width=1 << 10, hll_p=8,
    quantile_buckets=256,
)
REF_SPANS = [s for t in generate_traces(
    n_traces=40, max_depth=4, n_services=6,
    rng=np.random.default_rng(5)) for s in t]
SPANS = _convert(REF_SPANS, PORT)
END_TS = max(s.last_timestamp for s in SPANS if s.last_timestamp) + 1
QS = [0.5, 0.95, 0.99]
EXEC_THREAD = "zipkin-query-exec"


@pytest.fixture
def engines():
    """``make(cls_or_factory, *a, **kw)`` builds an engine or service and
    closes it (its executor thread with it) when the test ends."""
    made = []

    def make(factory, *a, **kw):
        obj = factory(*a, **kw)
        made.append(obj)
        return obj

    yield make
    for obj in made:
        obj.close()


def _cfg(**kw):
    return tdev.StoreConfig(**{**CONFIG, **kw})


def _store(spans=SPANS, **kw):
    st = TorchSpanStore(_cfg(**kw), device="cpu", registry=obs.Registry())
    for i in range(0, len(spans), 64):
        st.apply(spans[i:i + 64])
    return st


def _ref_store(spans=REF_SPANS):
    st = TpuSpanStore(dev.StoreConfig(**CONFIG))
    for i in range(0, len(spans), 64):
        st.apply(spans[i:i + 64])
    return st


def _ids(rows):
    return [[(i.trace_id, i.timestamp) for i in r] for r in rows]


def _exec_threads():
    return [t for t in threading.enumerate()
            if t.name == EXEC_THREAD and t.is_alive()]


def _assert_sketch_matches_store(engine, store):
    """Every sketch-tier answer equals the store's own read path,
    bitwise (the estimate too: the same float64 estimator on registers
    equal to the device leaf)."""
    assert engine.get_all_service_names() == store.get_all_service_names()
    for svc in sorted(store.get_all_service_names()):
        assert engine.get_span_names(svc) == store.get_span_names(svc)
        assert (engine.service_duration_quantiles(svc, QS)
                == store.service_duration_quantiles(svc, QS)), svc
        assert engine.top_annotations(svc) == store.top_annotations(svc)
        assert engine.top_binary_keys(svc) == store.top_binary_keys(svc)
    assert (engine.estimated_unique_traces()
            == store.estimated_unique_traces())
    assert engine.get_span_names("no-such-service") == set()
    assert engine.service_duration_quantiles("no-such-service", QS) is None
    assert engine.top_annotations("no-such-service") == []


def _assert_sketch_matches_reference(engine, ref_engine):
    names = ref_engine.get_all_service_names()
    assert engine.get_all_service_names() == names
    for svc in sorted(names):
        assert engine.get_span_names(svc) == ref_engine.get_span_names(svc)
        assert (engine.service_duration_quantiles(svc, QS)
                == ref_engine.service_duration_quantiles(svc, QS))
        assert engine.top_annotations(svc) == ref_engine.top_annotations(svc)
        assert (engine.top_binary_keys(svc)
                == ref_engine.top_binary_keys(svc))
    assert engine.estimated_unique_traces() == pytest.approx(
        ref_engine.estimated_unique_traces(), rel=1e-5)


def test_sketch_tier_matches_store_and_reference(engines):
    """Incremental mirror deltas: after a serial drive every sketch
    answer is bitwise the store's, with zero mirror resyncs, and equals
    the reference engine's over the reference store."""
    store = _store()
    engine = engines(QueryEngine, store, window_s=0.0,
                     registry=obs.Registry())
    assert store.sketch_mirror.warm
    _assert_sketch_matches_store(engine, store)
    assert engine.c_sketch.value > 0
    ref_engine = engines(RefEngine, _ref_store(), window_s=0.0)
    _assert_sketch_matches_reference(engine, ref_engine)


def test_sketch_tier_resync_after_state_adoption(engines):
    store = _store()
    store.adopt_state(store.state, spans_written=store._wp)
    assert not store.sketch_mirror.warm
    engine = engines(QueryEngine, store, window_s=0.0,
                     registry=obs.Registry())
    _assert_sketch_matches_store(engine, store)
    assert store.sketch_mirror.warm


def test_pipelined_ingest_keeps_mirror_exact(engines):
    store = TorchSpanStore(_cfg(), device="cpu", registry=obs.Registry())
    with store.pipelined(4):
        for i in range(0, len(SPANS), 64):
            store.apply(SPANS[i:i + 64])
        store.drain_pipeline()
        engine = engines(QueryEngine, store, window_s=0.0,
                         registry=obs.Registry())
        _assert_sketch_matches_store(engine, store)


def test_result_cache_hits_are_bitwise_equal_and_frontier_keyed(engines):
    store = _store()
    engine = engines(QueryEngine, store, window_s=0.0,
                     registry=obs.Registry())
    svcs = sorted(store.get_all_service_names())
    queries = [("name", s, None, END_TS, 10) for s in svcs]
    cold = _ids(engine.get_trace_ids_multi(queries))
    h0, m0 = engine.c_hits.value, engine.c_misses.value
    warm = _ids(engine.get_trace_ids_multi(queries))
    assert warm == cold
    assert engine.c_hits.value - h0 == len(queries)
    assert engine.c_misses.value == m0
    ref_engine = engines(RefEngine, _ref_store(), window_s=0.0)
    assert cold == _ids(ref_engine.get_trace_ids_multi(queries))
    tids = [t for r in cold for t, _ in r][:4]
    spans1 = engine.get_spans_by_trace_ids(tids)
    spans2 = engine.get_spans_by_trace_ids(tids)
    assert spans1 == spans2
    spans2[0].clear()  # mutating the returned copy ...
    assert engine.get_spans_by_trace_ids(tids) == spans1  # ... is safe
    assert engine.traces_exist(tids) == store.traces_exist(tids)
    assert (engine.get_traces_duration(tids)
            == store.get_traces_duration(tids))
    assert len(engine.cache) > 0


def test_result_cache_invalidates_on_ingest_commit(engines):
    store = _store()
    engine = engines(QueryEngine, store, window_s=0.0,
                     registry=obs.Registry())
    svcs = sorted(store.get_all_service_names())
    queries = [("name", s, None, 1 << 61, 50) for s in svcs]
    f0 = store.write_frontier()
    engine.get_trace_ids_multi(queries)
    extra = _convert([s for t in generate_traces(
        n_traces=10, max_depth=3, n_services=6,
        rng=np.random.default_rng(6)) for s in t], PORT)
    store.apply(extra)
    assert store.write_frontier() != f0
    after = _ids(engine.get_trace_ids_multi(queries))
    assert after == _ids(store.get_trace_ids_multi(queries))
    new_tid = extra[0].trace_id
    assert engine.traces_exist([new_tid]) == {new_tid}


def test_result_cache_invalidates_on_pin_and_ttl_mutation(engines):
    store = _store()
    engine = engines(QueryEngine, store, window_s=0.0,
                     registry=obs.Registry())
    tid = SPANS[0].trace_id
    before = engine.get_spans_by_trace_ids([tid])
    f0 = store.write_frontier()
    store.set_time_to_live(tid, 3600.0)  # pin
    assert store.write_frontier() != f0
    assert engine.get_spans_by_trace_ids([tid]) == \
        store.get_spans_by_trace_ids([tid])
    f1 = store.write_frontier()
    store.set_time_to_live(tid, 60.0)  # unpin
    assert store.write_frontier() != f1
    assert engine.get_spans_by_trace_ids([tid]) == \
        store.get_spans_by_trace_ids([tid])
    assert before


def test_cache_and_executor_exact_through_eviction_capture(engines):
    """Tiered store, 4x-ring drive with queries interleaved: engine
    answers (cached across the laps) always match the memory oracle,
    spans only the cold tier still holds included."""
    from zipkin_tpu_torch.store.archive import ArchiveParams, TieredSpanStore

    cfg = tdev.StoreConfig(
        capacity=1 << 8, ann_capacity=1 << 10, bann_capacity=1 << 9,
        max_services=16, max_span_names=64, max_annotation_values=128,
        max_binary_keys=32, cms_width=1 << 9, hll_p=6,
        quantile_buckets=256,
    )
    n = 4 * cfg.capacity
    spans = _convert([s for t in generate_traces(
        n_traces=n // 4, max_depth=3, n_services=8,
        rng=np.random.default_rng(8)) for s in t][:n], PORT)
    hot = TorchSpanStore(cfg, device="cpu", registry=obs.Registry())
    tiered = TieredSpanStore(hot, params=ArchiveParams.for_config(
        cfg, compact_fanin=2, small_span_limit=cfg.capacity,
        bloom_bits=1 << 12, cms_width=1 << 10, hll_p=6,
    ), registry=obs.Registry())
    oracle = InMemorySpanStore()
    engine = engines(QueryEngine, tiered, window_s=0.0,
                     registry=obs.Registry())
    svc0 = None
    try:
        for i in range(0, len(spans), 128):
            tiered.apply(spans[i:i + 128])
            oracle.apply(spans[i:i + 128])
            if svc0 is None:
                svc0 = sorted(oracle.get_all_service_names())[0]
            engine.get_trace_ids_by_name(svc0, None, 1 << 61, 8)
        assert tiered.counters()["archive_segments_written"] > 0
        tids = sorted({s.trace_id for s in spans})
        sample = (tids[:3] + tids[len(tids) // 2:len(tids) // 2 + 3]
                  + tids[-3:])
        for t in sample:
            want = oracle.get_spans_by_trace_ids([t])
            assert engine.get_spans_by_trace_ids([t]) == want, t
            assert engine.get_spans_by_trace_ids([t]) == want, t  # hit
        assert (_ids(engine.get_trace_ids_multi(
            [("name", svc0, None, 1 << 61, 10 * n)]))
            == _ids([oracle.get_trace_ids_by_name(svc0, None, 1 << 61,
                                                  10 * n)]))
        assert (engine.get_all_service_names()
                == tiered.get_all_service_names()
                == oracle.get_all_service_names())
    finally:
        tiered.close()


def test_staleness_freedom_under_concurrent_ingest_and_query(engines):
    """Writers and engine readers race; reads never error, and once
    writes drain every answer equals a fresh store read, the memory
    oracle and the reference store's."""
    store = _store(spans=SPANS[:64])
    oracle = InMemorySpanStore()
    oracle.apply(SPANS[:64])
    engine = engines(QueryEngine, store, window_s=0.0,
                     registry=obs.Registry())
    rest = SPANS[64:]
    errors = []
    stop = threading.Event()

    def write():
        try:
            for i in range(0, len(rest), 32):
                store.apply(rest[i:i + 32])
                oracle.apply(rest[i:i + 32])
        finally:
            stop.set()

    svc0 = sorted(store.get_all_service_names())[0]

    def read():
        try:
            while not stop.is_set():
                engine.get_trace_ids_multi(
                    [("name", svc0, None, END_TS, 10)])
                engine.get_all_service_names()
                engine.traces_exist([SPANS[0].trace_id])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=write)] + [
        threading.Thread(target=read) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    engine.drain()
    _assert_sketch_matches_store(engine, store)
    svcs = sorted(oracle.get_all_service_names())
    assert engine.get_all_service_names() == set(svcs)
    queries = [("name", s, None, 1 << 61, 50) for s in svcs]
    got = _ids(engine.get_trace_ids_multi(queries))
    assert got == _ids(store.get_trace_ids_multi(queries)) == _ids(
        [oracle.get_trace_ids_by_name(s, None, 1 << 61, 50) for s in svcs])
    assert got == _ids(_ref_store(REF_SPANS).get_trace_ids_multi(queries))


def test_executor_joins_ordered_shutdown(engines):
    """The engine registers on the store; Collector.flush drains the
    standing executor, Collector.close stops it before the store closes,
    and queries still answer inline afterwards."""
    from zipkin_tpu_torch.ingest import Collector

    store = TorchSpanStore(_cfg(), device="cpu", registry=obs.Registry())
    collector = Collector(store, self_trace=False, concurrency=2,
                          registry=obs.Registry())
    service = engines(QueryService, store, coalesce_window_s=0.0,
                      registry=obs.Registry())
    engine = service.engine
    assert engine in store.query_engines()
    collector.accept(SPANS[:64])
    collector.flush()
    svc0 = sorted(store.get_all_service_names())[0]
    want = _ids(engine.get_trace_ids_multi(
        [("name", svc0, None, END_TS, 10)]))
    assert want and want[0]
    thread = engine.executor._thread
    assert thread is not None and thread.is_alive()
    collector.close()
    assert engine.executor.closed
    assert not thread.is_alive()
    got = _ids(engine.get_trace_ids_multi(
        [("name", svc0, None, END_TS, 10)]))
    assert got == want


def test_no_exec_thread_survives_close(engines):
    """A service's first coalesced read starts the standing thread;
    ``close()`` stops it and deregisters the engine from the store."""
    store = _store()
    before = set(_exec_threads())
    service = engines(QueryService, store, registry=obs.Registry())
    assert service.engine.window_s == DEFAULT_COALESCE_WINDOW_S
    assert service.engine.executor._thread is None
    svc0 = sorted(store.get_all_service_names())[0]
    assert service.get_trace_ids(QueryRequest(svc0, end_ts=END_TS)).trace_ids
    mine = set(_exec_threads()) - before
    assert len(mine) == 1
    service.close()
    assert not any(t.is_alive() for t in mine)
    assert service.engine not in store.query_engines()
    service.close()  # idempotent


def test_checkpoint_save_drains_executor(engines, tmp_path):
    """checkpoint.save quiesces registered engines before the gather (no
    query read in flight when the cut is taken), and a restored store's
    mirror resyncs to exact sketch answers."""
    from zipkin_tpu_torch import checkpoint

    store = _store()
    engine = engines(QueryEngine, store, window_s=0.0,
                     registry=obs.Registry())
    order = []
    orig_drain, orig_pipe = engine.drain, store.drain_pipeline
    engine.drain = lambda: (order.append("queries"), orig_drain())[1]
    store.drain_pipeline = lambda: (order.append("pipeline"),
                                    orig_pipe())[1]
    checkpoint.save(store, str(tmp_path / "ckpt"))
    assert order[:2] == ["queries", "pipeline"]
    restored = checkpoint.load(str(tmp_path / "ckpt"), device="cpu")
    assert not restored.sketch_mirror.warm
    engine2 = engines(QueryEngine, restored, window_s=0.0,
                      registry=obs.Registry())
    _assert_sketch_matches_store(engine2, restored)
    _assert_sketch_matches_store(engine2, store)


def test_window_plumbs_end_to_end(engines):
    """QueryService's window reaches the executor, stays writable at run
    time, and each store kind gets the reference's default: 2 ms for a
    store with its own batched probe (the port's ReadSpanStore is the
    one compared against), 0 for a host store."""
    from zipkin_tpu.store.memory import InMemorySpanStore as RefMemory
    from zipkin_tpu_torch.store.archive import TieredSpanStore

    store = InMemorySpanStore()
    store.apply(SPANS[:16])
    service = engines(QueryService, store, coalesce_window_s=7 / 1000.0,
                      registry=obs.Registry())
    assert service.engine.window_s == pytest.approx(0.007)
    service.engine.window_s = 0.0035
    assert service.engine.executor.window_s == pytest.approx(0.0035)
    device = TorchSpanStore(_cfg(), device="cpu", registry=obs.Registry())
    tiered = TieredSpanStore(
        TorchSpanStore(_cfg(), device="cpu", registry=obs.Registry()),
        registry=obs.Registry())
    got = {kind: engines(QueryEngine, s, registry=obs.Registry()).window_s
           for kind, s in (("device", device), ("tiered", tiered),
                           ("memory", InMemorySpanStore()))}
    want = {"device": RefEngine._default_window(
                TpuSpanStore(dev.StoreConfig(**CONFIG))),
            "memory": RefEngine._default_window(RefMemory())}
    assert got == {"device": want["device"], "tiered": want["device"],
                   "memory": want["memory"]}
    assert got["device"] == DEFAULT_COALESCE_WINDOW_S > 0
    tiered.close()


def test_engine_on_host_store_is_transparent(engines):
    store = InMemorySpanStore()
    store.apply(SPANS)
    engine = engines(QueryEngine, store, window_s=0.0,
                     registry=obs.Registry())
    svcs = sorted(store.get_all_service_names())
    assert engine.get_all_service_names() == set(svcs)
    for s in svcs[:3]:
        assert engine.get_span_names(s) == store.get_span_names(s)
        assert (_ids(engine.get_trace_ids_multi(
            [("name", s, None, END_TS, 10)]))
            == _ids([store.get_trace_ids_by_name(s, None, END_TS, 10)]))
    tid = SPANS[0].trace_id
    assert (engine.get_spans_by_trace_ids([tid])
            == store.get_spans_by_trace_ids([tid]))
    assert len(engine.cache) == 0


# -- coalescers (tests/test_coalesce.py's cases) -------------------------------

@pytest.mark.parametrize("window_s", [0.2, 0.0])
def test_concurrent_requests_share_launch_and_match_serial(engines,
                                                           window_s):
    """N threads fire get_trace_ids at once; at least some share one
    get_trace_ids_multi call, and every caller gets its serial answer
    (the reference store's too)."""
    store = _store()
    ref = _ref_store()
    svc = engines(QueryService, store, coalesce_window_s=window_s,
                  registry=obs.Registry())
    svcs = sorted(store.get_all_service_names())
    reqs = [QueryRequest(service_name=svcs[i % len(svcs)], end_ts=END_TS,
                         limit=10) for i in range(12)]
    want = [[i.trace_id for i in store.get_trace_ids_by_name(
        r.service_name, None, r.end_ts, r.limit)] for r in reqs]
    assert want == [[i.trace_id for i in ref.get_trace_ids_by_name(
        r.service_name, None, r.end_ts, r.limit)] for r in reqs]
    results = [None] * len(reqs)
    errors = []
    barrier = threading.Barrier(len(reqs))

    def call(i):
        try:
            barrier.wait()
            results[i] = list(svc.get_trace_ids(reqs[i]).trace_ids)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert results == want
    co = svc.coalescer
    assert co.queries == len(reqs)
    assert co.batches + co.launches_saved == len(reqs)
    if window_s:
        assert co.launches_saved >= 1


def test_batched_and_unbatched_paths_bitwise_identical():
    """One get_trace_ids_multi call, the singular per-query paths and
    both coalescers give the same (trace id, timestamp) lists, and so
    does the reference store."""
    store = _store()
    queries = []
    for s in sorted(store.get_all_service_names()):
        queries.append(("name", s, None, END_TS, 10))
        queries.append(
            ("annotation", s, "some custom annotation", None, END_TS, 10))
        queries.append(
            ("annotation", s, "http.uri", b"/api/widgets", END_TS, 10))
    batched = store.get_trace_ids_multi(queries)
    for q, got in zip(queries, batched):
        if q[0] == "name":
            want = store.get_trace_ids_by_name(*q[1:])
        else:
            want = store.get_trace_ids_by_annotation(*q[1:])
        assert _ids([got]) == _ids([want]), q
    assert any(batched)
    assert _ids(batched) == _ids(_ref_store().get_trace_ids_multi(queries))
    coal = QueryCoalescer(store, window_s=0.0, registry=obs.Registry())
    assert _ids(coal.run(queries)) == _ids(batched)
    resident = ResidentCoalescer(store, window_s=0.0,
                                 registry=obs.Registry())
    try:
        assert _ids(resident.run(queries)) == _ids(batched)
    finally:
        resident.close()


class _Boom:
    def get_trace_ids_multi(self, queries):
        raise RuntimeError("device gone")


@pytest.mark.parametrize("kind", ["leader", "resident"])
def test_coalescer_propagates_errors_to_every_caller(kind):
    if kind == "leader":
        coal = QueryCoalescer(_Boom(), window_s=0.05,
                              registry=obs.Registry())
    else:
        coal = ResidentCoalescer(_Boom(), window_s=0.05,
                                 registry=obs.Registry())
    errs = []
    barrier = threading.Barrier(3)

    def call():
        try:
            barrier.wait()
            coal.run([("name", "svc", None, 10, 10)])
        except RuntimeError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=call) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        if kind == "resident":
            coal.close()
    assert not any(t.is_alive() for t in threads)
    assert errs == ["device gone"] * 3


def test_multi_slice_request_rides_one_launch_per_round(engines):
    """A two-term request resolves its probe and aligned rounds through
    the batched path; its ids lie in both slices' singular answers."""
    store = _store()
    svc = engines(QueryService, store, coalesce_window_s=0.0,
                  registry=obs.Registry())
    service = sorted(store.get_all_service_names())[0]
    names = sorted(store.get_span_names(service))
    assert names
    qr = QueryRequest(service_name=service, span_name=names[0],
                      annotations=["some custom annotation"],
                      end_ts=END_TS, limit=10)
    b0 = svc.coalescer.batches
    resp = svc.get_trace_ids(qr)
    assert svc.coalescer.batches - b0 == 2
    by_name = {i.trace_id for i in store.get_trace_ids_by_name(
        service, names[0], END_TS, 10)}
    by_ann = {i.trace_id for i in store.get_trace_ids_by_annotation(
        service, "some custom annotation", None, END_TS, 10)}
    assert set(resp.trace_ids) <= (by_name & by_ann) or not resp.trace_ids
