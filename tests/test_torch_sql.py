"""The port's ``SqliteSpanStore`` against the reference, on the CPU.

The reference's conformance suite (``zipkin_tpu/testing/conformance.py``)
runs against the port's store through ``_RefSpanAdapter``
(``tests/test_torch_store.py``), one test a conformance case;
``tests/test_sql_store.py``'s aggregator cases (the join and its
moments, the incremental resume, the empty store, a file-backed store
reopened) run on the port; and the same seeded spans go into both
packages' stores, whose every read, the dependency aggregation and the
on-disk rows must be equal. Both stores hold the same float64 Moments,
so the comparison is exact.
"""

import sqlite3

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from zipkin_tpu.store.sql import SqliteSpanStore as RefSql  # noqa: E402
from zipkin_tpu.testing.conformance import (  # noqa: E402
    conformance_test_names,
    run_conformance_test,
)
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu_torch.models.span import Annotation, Endpoint, Span  # noqa: E402
from zipkin_tpu_torch.store.sql import SqliteSpanStore  # noqa: E402

from test_torch_store import PORT, _convert, _RefSpanAdapter  # noqa: E402

WEB = Endpoint(1, 80, "web")
API = Endpoint(2, 80, "api")
DB = Endpoint(3, 80, "db")


@pytest.mark.parametrize("name", conformance_test_names())
def test_port_sqlite_conformance(name):
    run_conformance_test(name, lambda: _RefSpanAdapter(SqliteSpanStore()))


def rpc(tid, sid, parent, client, server, t0, t1):
    return Span(tid, "op", sid, parent, (
        Annotation(t0, "cs", client),
        Annotation(t0 + 1, "sr", server),
        Annotation(t1 - 1, "ss", server),
        Annotation(t1, "cr", client),
    ))


def test_join_and_moments():
    store = SqliteSpanStore()
    store.apply([
        rpc(1, 1, None, WEB, API, 0, 1000),
        rpc(1, 2, 1, API, DB, 100, 400),
        rpc(2, 1, None, WEB, API, 5000, 6000),
        rpc(2, 2, 1, API, DB, 5100, 5200),
    ])
    deps = store.aggregate_dependencies()
    links = {(l.parent, l.child): l for l in deps.links}
    assert set(links) == {("api", "db")}
    m = links[("api", "db")].duration_moments
    assert m.count == 2
    assert m.mean == pytest.approx((300 + 100) / 2)
    store.close()


def test_incremental_resume():
    store = SqliteSpanStore()
    store.apply([
        rpc(1, 1, None, WEB, API, 0, 1000),
        rpc(1, 2, 1, API, DB, 100, 400),
    ])
    first = store.aggregate_dependencies()
    assert sum(l.duration_moments.count for l in first.links) == 1
    # Re-running without new data must not double-count.
    again = store.aggregate_dependencies()
    assert sum(l.duration_moments.count for l in again.links) == 1
    # New spans after the watermark are picked up.
    store.apply([
        rpc(9, 1, None, WEB, API, 10_000, 11_000),
        rpc(9, 2, 1, API, DB, 10_100, 10_500),
    ])
    third = store.aggregate_dependencies()
    assert sum(l.duration_moments.count for l in third.links) == 2
    store.close()


def test_empty():
    store = SqliteSpanStore()
    assert store.get_dependencies().links == ()
    assert store.stored_span_count() == 0.0
    store.close()


def test_file_backed(tmp_path):
    path = str(tmp_path / "spans.db")
    store = SqliteSpanStore(path)
    store.apply([rpc(1, 1, None, WEB, API, 0, 100)])
    store.close()
    reopened = SqliteSpanStore(path)
    assert reopened.traces_exist([1]) == {1}
    assert reopened.get_all_service_names() == {"web", "api"}
    assert reopened.stored_span_count() == 1.0
    reopened.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The reference's and the port's store, file-backed, after the same
    seeded spans in the same batches."""
    rng = np.random.default_rng(23)
    traces = generate_traces(n_traces=60, max_depth=3, n_services=5,
                             rng=rng, base_ts=1_700_000_000_000_000)
    spans = [s for t in traces for s in t]
    d = tmp_path_factory.mktemp("sql")
    ref, port = RefSql(str(d / "ref.db")), SqliteSpanStore(str(d /
                                                               "port.db"))
    port_spans = _convert(spans, PORT)
    for i in range(0, len(spans), 50):
        ref.apply(spans[i:i + 50])
        port.apply(port_spans[i:i + 50])
    yield ref, _RefSpanAdapter(port), traces, d
    ref.close()
    port.close()


def test_reads_match_reference(pair):
    ref, port, traces, _ = pair
    services = sorted(ref.get_all_service_names())
    assert port.get_all_service_names() == set(services)
    end = 1 << 62
    nonempty = 0
    for svc in services:
        assert port.get_span_names(svc) == ref.get_span_names(svc)
        for name in sorted(ref.get_span_names(svc))[:3] + [None]:
            want = ref.get_trace_ids_by_name(svc, name, end, 20)
            assert port.get_trace_ids_by_name(svc, name, end, 20) == want
            nonempty += bool(want)
        for ann, val in (("some custom annotation", None),
                         ("http.uri", b"/api/widgets"),
                         ("http.uri", None), ("cs", None)):
            assert (port.get_trace_ids_by_annotation(svc, ann, val, end, 20)
                    == ref.get_trace_ids_by_annotation(svc, ann, val, end,
                                                       20))
    assert nonempty >= len(services)
    tids = [t[0].trace_id for t in traces] + [424242]
    assert port.traces_exist(tids) == ref.traces_exist(tids)
    assert (port.get_spans_by_trace_ids(tids[:15])
            == ref.get_spans_by_trace_ids(tids[:15]))
    assert (port.get_traces_duration(tids)
            == ref.get_traces_duration(tids))
    assert port.stored_span_count() == ref.stored_span_count()
    for tid in tids[:3]:
        port.set_time_to_live(tid, 99.0)
        ref.set_time_to_live(tid, 99.0)
        assert port.get_time_to_live(tid) == ref.get_time_to_live(tid)
    with pytest.raises(KeyError):
        port.get_time_to_live(424242)


def test_dependencies_and_rows_match_reference(pair):
    ref, port, _, d = pair
    want = ref.aggregate_dependencies()
    assert want.links
    assert port.aggregate_dependencies() == want
    assert port.get_dependencies(0, 1 << 62) == ref.get_dependencies(
        0, 1 << 62)
    assert port.get_dependencies(end_ts=0) == ref.get_dependencies(
        end_ts=0)
    tables = ("spans", "annotations", "binary_annotations", "ttls",
              "dependencies", "dependency_links")
    rows = []
    for name in ("ref.db", "port.db"):
        with sqlite3.connect(str(d / name)) as conn:
            rows.append({t: conn.execute(
                f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                for t in tables})
    assert rows[0] == rows[1]
