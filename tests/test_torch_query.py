"""The port's query layer against the JAX reference, on the CPU.

The same spans (generated from a numpy seed, plus hand-built traces
with clock skew) go into ``TorchSpanStore(device="cpu")`` and
``TpuSpanStore``, and into the port's and the reference's
``InMemorySpanStore``; each store sits behind its own package's
``QueryService``. Every request of the matrix (by service, span name,
annotation and binary annotation; limits 10 and 100; each ``Order``;
two-term requests for the intersection) must give the reference's
answer exactly, and so must the traces, combos, summaries and
timelines of the ids it returns, with skew adjustment on and off.
``estimated_unique_traces`` is the one stated tolerance: the port's
HLL estimate is float64, the reference's float32 (``rel=1e-5``).

Also: ``TimeSkewAdjuster`` and the trace model on the hand-built traces
of ``tests/test_query.py`` and ``tests/test_trace.py``, and
``extract_query`` on a table of parameters, bad ones included, with
``time.time`` pinned.
"""

import dataclasses
import enum
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from zipkin_tpu.api.query_extractor import extract_query as ref_extract  # noqa: E402
from zipkin_tpu.models import span as ref_span  # noqa: E402
from zipkin_tpu.models import trace as ref_trace  # noqa: E402
from zipkin_tpu import query as ref_query  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.memory import InMemorySpanStore as RefMemory  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu_torch import query as port_query  # noqa: E402
from zipkin_tpu_torch.api import extract_query as port_extract  # noqa: E402
from zipkin_tpu_torch.models import span as port_span  # noqa: E402
from zipkin_tpu_torch.models import trace as port_trace  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.memory import InMemorySpanStore as PortMemory  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402

from test_torch_store import PORT, _convert  # noqa: E402

# tests/test_query.py's SMALL geometry, with the windowed arena on so
# the sketch tier's windowed reads are live.
CFG = dict(capacity=1 << 10, ann_capacity=1 << 12, bann_capacity=1 << 11,
           max_services=32, max_span_names=128, max_annotation_values=256,
           max_binary_keys=64, cms_width=1 << 10, hll_p=8,
           quantile_buckets=512, window_seconds=60, window_buckets=8)
QS = [0.5, 0.9, 0.99]
ORDERS = ("NONE", "TIMESTAMP_DESC", "TIMESTAMP_ASC", "DURATION_DESC",
          "DURATION_ASC")


def plain(obj):
    """A class-named, order-keeping plain form of a result (dataclasses,
    enums, containers), so the two packages' objects compare exactly."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, tuple(
            (f.name, plain(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)))
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.value)
    if isinstance(obj, dict):
        return ("dict", tuple((plain(k), plain(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, tuple(plain(o) for o in obj))
    if isinstance(obj, (set, frozenset)):
        return ("set", frozenset(plain(o) for o in obj))
    return obj


def outcome(fn, *a, **kw):
    """``plain`` of the result, or the exception's class name."""
    try:
        return ("ok", plain(fn(*a, **kw)))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__)


# -- hand-built traces with clock skew (tests/test_query.py's shapes) -------

def _eps(m):
    return (m.Endpoint(0x01010101, 80, "web"), m.Endpoint(0x02020202, 80,
                                                          "api"),
            m.Endpoint(0x03030303, 80, "db"))


def rpc(m, tid, sid, parent, client_ep, server_ep, cs, sr, ss, cr,
        name="call", extra_ann=None, bann=None):
    anns = [m.Annotation(cs, "cs", client_ep), m.Annotation(sr, "sr",
                                                            server_ep),
            m.Annotation(ss, "ss", server_ep), m.Annotation(cr, "cr",
                                                            client_ep)]
    if extra_ann:
        anns.append(extra_ann)
    return m.Span(tid, name, sid, parent, tuple(anns), tuple(bann or ()))


def skew_cases(m):
    """name -> span list, in the span model module ``m``."""
    web, api, db = _eps(m)
    return {
        "server_ahead": [rpc(m, 1, 1, None, web, api, 100, 1150, 1180,
                             200)],
        "well_ordered": [rpc(m, 1, 1, None, web, api, 100, 110, 180, 200)],
        "propagates_to_children": [
            rpc(m, 1, 1, None, web, api, 100, 10150, 10180, 300),
            rpc(m, 1, 2, 1, api, db, 10160, 10165, 10170, 10175)],
        "server_longer_than_client": [rpc(m, 1, 1, None, web, api, 100, 90,
                                          250, 200)],
        "client_only_parent": [
            m.Span(1, "p", 1, None, (m.Annotation(100, "cs", web),
                                     m.Annotation(200, "cr", web))),
            rpc(m, 1, 2, 1, api, db, 120, 130, 150, 160)],
        "no_root": [m.Span(1, "x", 5, parent_id=99, annotations=(
            m.Annotation(1, "cs", web),))],
        "loopback_client": [
            rpc(m, 1, 1, None, m.Endpoint(0x7F000001, 80, "web"), api,
                100, 5150, 5180, 300)],
        "three_hops": [
            rpc(m, 1, 1, None, web, api, 100, 2150, 2400, 600),
            rpc(m, 1, 2, 1, api, db, 2200, 9210, 9300, 2350),
            m.Span(1, "leaf", 3, 2, (m.Annotation(9250, "sr", db),
                                     m.Annotation(9260, "ss", db)))],
    }


def model_cases(m):
    """tests/test_trace.py's traces."""
    ep = m.Endpoint(1, 80, "svc")

    def ann(ts, v):
        return m.Annotation(ts, v, ep)

    root = m.Span(1, "root", 100, None, (ann(100, "sr"), ann(500, "ss")))
    c1 = m.Span(1, "c1", 200, 100, (ann(150, "sr"), ann(200, "ss")))
    c2 = m.Span(1, "c2", 300, 100, (ann(250, "sr"), ann(300, "ss")))
    g = m.Span(1, "g", 400, 300, (ann(260, "sr"), ann(280, "ss")))
    return {
        "shuffled": [c2, g, root, c1],
        "missing_root": [m.Span(1, "orphan", 200, 999, (ann(150, "sr"),)),
                         m.Span(1, "child", 300, 200, (ann(160, "sr"),))],
        "split_spans": [m.Span(1, "rpc", 7, None, (ann(10, "cs"),
                                                   ann(40, "cr"))),
                        m.Span(1, "rpc", 7, None, (ann(20, "sr"),
                                                   ann(30, "ss")))],
        "empty": [],
        "parent_cycle": [m.Span(9, "a", 1, 2, (ann(1, "sr"),)),
                         m.Span(9, "b", 2, 1, (ann(2, "sr"),))],
    }


def _trace_views(tm, t):
    return (t, t.id, t.get_root_span(), t.get_root_most_span(),
            t.start_and_end_timestamp(), t.duration, sorted(t.services),
            t.service_counts(), t.to_span_depths(),
            tm.TraceSummary.from_trace(t), tm.TraceTimeline.from_trace(t),
            tm.TraceCombo.from_trace(t))


@pytest.mark.parametrize("case", list(model_cases(ref_span)))
def test_trace_model_matches_reference(case):
    ref = ref_trace.Trace(model_cases(ref_span)[case])
    got = port_trace.Trace(model_cases(port_span)[case])
    assert plain(_trace_views(port_trace, got)) == plain(
        _trace_views(ref_trace, ref))
    if case == "shuffled":
        assert [s.name for s in got.spans] == ["root", "c1", "c2", "g"]
        assert got.to_span_depths() == {100: 1, 200: 2, 300: 2, 400: 3}


@pytest.mark.parametrize("case", list(skew_cases(ref_span)))
def test_time_skew_adjuster_matches_reference(case):
    ref_adj, port_adj = ref_query.TimeSkewAdjuster(), \
        port_query.TimeSkewAdjuster()
    ref = ref_adj.adjust(ref_trace.Trace(skew_cases(ref_span)[case]))
    got = port_adj.adjust(port_trace.Trace(skew_cases(port_span)[case]))
    assert plain(got) == plain(ref)
    assert port_adj.warnings == ref_adj.warnings
    spans = {s.id: s.annotations_as_map() for s in got.spans}
    if case == "server_ahead":
        a = spans[1]
        assert 100 <= a["sr"].timestamp <= a["ss"].timestamp <= 200
    elif case == "propagates_to_children":
        root, child = spans[1], spans[2]
        assert child["cs"].timestamp >= root["sr"].timestamp
        assert child["cr"].timestamp <= root["ss"].timestamp + 1
    elif case == "client_only_parent":
        assert "TIME_SKEW_ADD_SERVER_RECV" in port_adj.warnings
    elif case in ("well_ordered", "server_longer_than_client", "no_root"):
        assert plain(got.spans) == plain(
            tuple(port_trace.Trace(skew_cases(port_span)[case]).spans))


# -- extract_query ------------------------------------------------------------

EXTRACT_CASES = {
    "service_only": {"serviceName": "api"},
    "no_service": {"spanName": "index"},
    "empty_service": {"serviceName": ""},
    "span_all": {"serviceName": "api", "spanName": "all"},
    "span_empty": {"serviceName": "api", "spanName": ""},
    "span_named": {"serviceName": "api", "spanName": "Index"},
    "annotation": {"serviceName": "api", "annotationQuery": "boom"},
    "binary": {"serviceName": "api", "annotationQuery": "k=v1"},
    "terms": {"serviceName": "api",
              "annotationQuery": "boom and k=v1 and http.uri=/a=b"},
    "empty_terms": {"serviceName": "api", "annotationQuery": " and  and "},
    "empty_key": {"serviceName": "api", "annotationQuery": "=v"},
    "end_ts": {"serviceName": "api", "endTs": "1500"},
    "timestamp_wins": {"serviceName": "api", "timestamp": "77",
                       "endTs": "1500"},
    "limit_order": {"serviceName": "api", "limit": "2",
                    "order": "timestamp-desc"},
    "each_order": {"serviceName": "api", "order": "duration-asc"},
    "unknown_order": {"serviceName": "api", "order": "sideways"},
    "bad_limit": {"serviceName": "api", "limit": "ten"},
    "bad_end_ts": {"serviceName": "api", "endTs": "soon"},
    "float_end_ts": {"serviceName": "api", "endTs": "1.5"},
    "zero_limit": {"serviceName": "api", "limit": "0"},
}


@pytest.mark.parametrize("case", list(EXTRACT_CASES))
def test_extract_query_matches_reference(case, monkeypatch):
    """The same request (or None, or the same exception) from the same
    params with the clock pinned; then each package's QueryService over
    its in-memory store answers it alike, ``QueryException`` in the
    same cases."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    params = EXTRACT_CASES[case]
    want = outcome(ref_extract, dict(params))
    assert outcome(port_extract, dict(params)) == want
    if want[0] != "ok" or want[1] is None:
        return
    ref_svc = ref_query.QueryService(_hand_store(RefMemory, ref_span),
                                     coalesce_window_s=0.0)
    port_svc = port_query.QueryService(_hand_store(PortMemory, port_span),
                                       coalesce_window_s=0.0)
    try:
        ref_qr, port_qr = ref_extract(dict(params)), port_extract(
            dict(params))
        got = outcome(port_svc.get_trace_ids, port_qr)
        assert got == outcome(ref_svc.get_trace_ids, ref_qr)
        blank = dataclasses.replace(port_qr, service_name="")
        with pytest.raises(port_query.QueryException):
            port_svc.get_trace_ids(blank)
        with pytest.raises(ref_query.QueryException):
            ref_svc.get_trace_ids(dataclasses.replace(ref_qr,
                                                      service_name=""))
    finally:
        ref_svc.close()
        port_svc.close()


def _hand_store(cls, m):
    """tests/test_query.py's three-trace store."""
    web, api, _ = _eps(m)
    store = cls()
    store.apply([rpc(m, 1, 10, None, web, api, 100, 110, 190, 200,
                     name="index", extra_ann=m.Annotation(150, "boom", api),
                     bann=[m.BinaryAnnotation("k", b"v1", host=api)])])
    store.apply([rpc(m, 2, 10, None, web, api, 1100, 1110, 1190, 1200,
                     name="index")])
    store.apply([rpc(m, 3, 10, None, web, api, 2100, 2110, 2190, 2200,
                     name="other")])
    return store


# -- QueryService over both store kinds ---------------------------------------

def _spans(ref_mod):
    """Generated traces (numpy seed) and skewed hand-built traces under
    trace ids of their own, as reference Span objects."""
    rng = np.random.default_rng(17)
    traces = generate_traces(n_traces=70, max_depth=3, n_services=6,
                             rng=rng, base_ts=1_700_000_000_000_000)
    spans = [s for t in traces for s in t]
    for i, case in enumerate(skew_cases(ref_mod).values()):
        spans += [dataclasses.replace(
            s, trace_id=9_000_000 + i,
            annotations=tuple(dataclasses.replace(
                a, timestamp=a.timestamp + 1_700_000_000_000_000)
                for a in s.annotations)) for s in case]
    return spans


@pytest.fixture(scope="module")
def services():
    """{kind: (reference QueryService, port QueryService)} over the same
    spans: the device stores and the in-memory stores."""
    spans = _spans(ref_span)
    port_spans = _convert(spans, PORT)
    pairs = {
        "device": (TpuSpanStore(dev.StoreConfig(**CFG)),
                   TorchSpanStore(tdev.StoreConfig(**CFG), device="cpu")),
        "memory": (RefMemory(), PortMemory()),
    }
    out = {}
    for kind, (ref, port) in pairs.items():
        for i in range(0, len(spans), 96):
            ref.apply(spans[i:i + 96])
            port.apply(port_spans[i:i + 96])
        out[kind] = (ref_query.QueryService(ref, coalesce_window_s=0.0),
                     port_query.QueryService(port, coalesce_window_s=0.0))
    yield out
    for ref, port in out.values():
        ref.close()
        port.close()


END_TS = 1 << 62


def _requests(q, svc_names, span_names, end_ts=END_TS):
    """The request matrix in the query module ``q``."""
    B = q.BinaryAnnotationQuery
    out = []
    i = 0
    for svc in svc_names:
        names = span_names[svc]
        terms = [dict(), dict(span_name=names[0]),
                 dict(annotations=("some custom annotation",)),
                 dict(binary_annotations=(B("http.uri", b"/api/widgets"),)),
                 dict(span_name=names[-1],
                      annotations=("some custom annotation",)),
                 dict(annotations=("some custom annotation",),
                      binary_annotations=(B("http.uri", b"/api/widgets"),)),
                 dict(annotations=("no such annotation",))]
        for kw in terms:
            for limit in (10, 100):
                order = getattr(q.Order, ORDERS[i % len(ORDERS)])
                i += 1
                out.append(q.QueryRequest(svc, end_ts=end_ts, limit=limit,
                                          order=order, **kw))
    return out


@pytest.mark.parametrize("kind", ["device", "memory"])
def test_get_trace_ids_matrix_matches_reference(services, kind):
    ref, port = services[kind]
    svc_names = sorted(ref.get_service_names())
    assert port.get_service_names() == set(svc_names)
    span_names = {s: sorted(ref.get_span_names(s)) for s in svc_names}
    for s in svc_names:
        assert port.get_span_names(s) == set(span_names[s])
    reqs = list(zip(_requests(ref_query, svc_names, span_names),
                    _requests(port_query, svc_names, span_names)))
    nonempty = multi = 0
    for rq, pq in reqs:
        want = ref.get_trace_ids(rq)
        assert plain(port.get_trace_ids(pq)) == plain(want), rq
        nonempty += bool(want.trace_ids)
        multi += bool(want.trace_ids) and (
            len(rq.annotations) + len(rq.binary_annotations)
            + bool(rq.span_name)) >= 2
    assert nonempty >= len(reqs) // 2 and multi > 0


@pytest.mark.parametrize("kind", ["device", "memory"])
@pytest.mark.parametrize("order", ORDERS)
def test_each_order_and_pagination_match_reference(services, kind, order):
    ref, port = services[kind]
    svc = sorted(ref.get_service_names())[0]
    for end_ts in (END_TS, None):
        if end_ts is None:
            mid = ref.get_trace_ids(ref_query.QueryRequest(
                svc, limit=100, order=ref_query.Order.TIMESTAMP_ASC))
            end_ts = (mid.start_ts + mid.end_ts) // 2
        for limit in (3, 10, 100):
            want = ref.get_trace_ids(ref_query.QueryRequest(
                svc, end_ts=end_ts, limit=limit,
                order=getattr(ref_query.Order, order)))
            got = port.get_trace_ids(port_query.QueryRequest(
                svc, end_ts=end_ts, limit=limit,
                order=getattr(port_query.Order, order)))
            assert plain(got) == plain(want)
            assert want.trace_ids


@pytest.mark.parametrize("kind", ["device", "memory"])
@pytest.mark.parametrize("adjust", [True, False])
def test_trace_projections_match_reference(services, kind, adjust):
    """Traces, combos, summaries and timelines of every known id (the
    skewed hand-built ones among them) and an absent id, exactly."""
    ref, port = services[kind]
    tids = sorted({t for s in sorted(ref.get_service_names())
                   for t in ref.get_trace_ids(ref_query.QueryRequest(
                       s, limit=100)).trace_ids})
    tids += [9_000_000 + i for i in range(len(skew_cases(ref_span)))]
    tids += [424242]
    for chunk in (tids[:25], tids[25:], tids[-9:]):
        for name in ("get_traces_by_ids", "get_trace_combos_by_ids",
                     "get_trace_summaries_by_ids",
                     "get_trace_timelines_by_ids"):
            want = getattr(ref, name)(chunk, adjust)
            assert plain(getattr(port, name)(chunk, adjust)) == plain(
                want), name
    combos = port.get_trace_combos_by_ids(tids[-9:-1], adjust)
    assert len(combos) == 8 and all(c.summary for c in combos)
    assert port.traces_exist(tids) == ref.traces_exist(tids)
    assert port.trace_exists(tids[0]) and not port.trace_exists(424242)


@pytest.mark.parametrize("kind", ["device", "memory"])
def test_aggregates_and_thrift_surface_match_reference(services, kind):
    ref, port = services[kind]
    for svc in sorted(ref.get_service_names()) + ["no-such-service"]:
        for name in ("get_top_annotations",
                     "get_top_key_value_annotations"):
            assert getattr(port, name)(svc) == getattr(ref, name)(svc)
        assert (port.get_service_duration_quantiles(svc, QS)
                == ref.get_service_duration_quantiles(svc, QS))
        for name, kw in (("get_windowed_quantiles", dict(qs=QS)),
                         ("get_slo_burn", dict(windows_s=[300, 3600])),
                         ("get_latency_heatmap", {})):
            assert plain(getattr(port, name)(svc, **kw)) == plain(
                getattr(ref, name)(svc, **kw)), name
        names = sorted(ref.get_span_names(svc))
        ts = END_TS
        for rpc_name in names[:2]:
            assert (port.get_span_durations(ts, svc, rpc_name)
                    == ref.get_span_durations(ts, svc, rpc_name))
        assert plain(port.get_service_names_to_trace_ids(ts, svc, None)) \
            == plain(ref.get_service_names_to_trace_ids(ts, svc, None))
    deps_ref, deps_port = ref.get_dependencies(), port.get_dependencies()
    assert sorted((l.parent, l.child, l.duration_moments.count)
                  for l in deps_port.links) == sorted(
        (l.parent, l.child, l.duration_moments.count)
        for l in deps_ref.links)
    assert port.get_data_time_to_live() == ref.get_data_time_to_live()
    with pytest.raises(port_query.QueryException):
        port.get_span_durations(END_TS, "", "x")
    if kind == "device":
        assert deps_port.links
        est = port.engine.estimated_unique_traces()
        assert est == pytest.approx(ref.engine.estimated_unique_traces(),
                                    rel=1e-5)
        assert est == port.store.estimated_unique_traces()


def test_trace_ttl_matches_reference(services):
    """TTL reads and writes through the service: a pin moves the
    frontier, and the pinned trace reads back alike."""
    ref, port = services["device"]
    tid = sorted(ref.get_trace_ids(ref_query.QueryRequest(
        sorted(ref.get_service_names())[0], limit=5)).trace_ids)[0]
    assert (port.get_trace_time_to_live(tid)
            == ref.get_trace_time_to_live(tid))
    f0 = port.store.write_frontier()
    for svc in (ref, port):
        svc.set_trace_time_to_live(tid, 30 * 24 * 3600.0)
    assert port.store.write_frontier() != f0
    assert (port.get_trace_time_to_live(tid)
            == ref.get_trace_time_to_live(tid) == 30 * 24 * 3600.0)
    assert plain(port.get_trace_combos_by_ids([tid])) == plain(
        ref.get_trace_combos_by_ids([tid]))
