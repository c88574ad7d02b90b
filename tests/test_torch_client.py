"""The port's client HTTP half against the reference, on the CPU.

``ZipkinWSGIMiddleware``: ``tests/test_client.py``'s cases on the port
(the instrumented request lands in the store, the response echoes the
recorded B3 ids, nested middlewares emit one B3 header set), each also
driven through the reference's middleware with the same seeded
``random.Random`` and the clock pinned, so the recorded spans and the
response headers must be equal. ``http_transport``: the request it
sends equals the reference's byte for byte, and over a real socket its
spans reach a port server's collector. ``QueryClient``: every method
asks for the reference's URL. Servers bind ``127.0.0.1:0`` and are shut
down, closed and joined by the ``serve`` fixture.
"""

import json
import random
import time
import urllib.request

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from zipkin_tpu import client as ref_client  # noqa: E402
from zipkin_tpu.ingest.collector import Collector as RefCollector  # noqa: E402
from zipkin_tpu.models import span as ref_span  # noqa: E402
from zipkin_tpu.store.memory import InMemorySpanStore as RefMemory  # noqa: E402
from zipkin_tpu_torch import client  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.api import server as port_server  # noqa: E402
from zipkin_tpu_torch.ingest.collector import Collector  # noqa: E402
from zipkin_tpu_torch.query.service import QueryService  # noqa: E402
from zipkin_tpu_torch.store.memory import InMemorySpanStore  # noqa: E402

from test_torch_store import PORT, REF, _convert  # noqa: E402


def make_app(extra_headers=()):
    def app(environ, start_response):
        start_response("200 OK", [("Content-Type", "text/plain"),
                                  *extra_headers])
        return [b"hello"]

    return app


ENVIRONS = {
    "continued": {"PATH_INFO": "/hello", "REQUEST_METHOD": "GET",
                  "HTTP_X_B3_TRACEID": "ff", "HTTP_X_B3_SPANID": "ee",
                  "HTTP_X_B3_SAMPLED": "1"},
    "child_of_parent": {"PATH_INFO": "/x", "REQUEST_METHOD": "POST",
                        "HTTP_X_B3_TRACEID": "ab", "HTTP_X_B3_SPANID": "cd",
                        "HTTP_X_B3_PARENTSPANID": "12"},
    "fresh": {"PATH_INFO": "/y", "REQUEST_METHOD": "GET"},
    "unsampled": {"PATH_INFO": "/z", "REQUEST_METHOD": "GET",
                  "HTTP_X_B3_SAMPLED": "0"},
    "garbage_ids": {"PATH_INFO": "/g", "REQUEST_METHOD": "GET",
                    "HTTP_X_B3_TRACEID": "zz-not-hex"},
}


def _drive(pkg, env, seed, extra_headers=()):
    """One request through ``pkg``'s middleware over its own memory
    store: (response headers, the stored spans)."""
    store = (RefMemory if pkg is ref_client else InMemorySpanStore)()
    col = (RefCollector if pkg is ref_client else Collector)(
        store, concurrency=1)
    try:
        tracer = pkg.Tracer("front", col.accept, rng=random.Random(seed))
        app = pkg.ZipkinWSGIMiddleware(make_app(extra_headers), tracer)
        captured = {}

        def start_response(status, headers, exc_info=None):
            captured["status"] = status
            captured["headers"] = list(headers)

        assert app(dict(env), start_response) == [b"hello"]
        col.flush()
        return captured, list(store.spans)
    finally:
        col.close()


@pytest.mark.parametrize("case", list(ENVIRONS))
def test_middleware_matches_reference(case, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
    got = _drive(client, ENVIRONS[case], seed=4)
    want = _drive(ref_client, ENVIRONS[case], seed=4)
    assert got[0] == want[0]
    assert _convert(got[1], REF) == want[1]
    headers = dict(got[0]["headers"])
    if case == "unsampled":
        assert got[1] == [] and "X-B3-TraceId" not in headers
        assert headers["X-B3-Sampled"] == "0"
        return
    (span,) = got[1]
    assert span.trace_id == int(headers["X-B3-TraceId"], 16)
    assert span.id == int(headers["X-B3-SpanId"], 16)
    tags = {b.key: b.value for b in span.binary_annotations}
    assert tags["http.status"] == "200"
    assert tags["http.uri"] == ENVIRONS[case]["PATH_INFO"]
    assert span.service_name == "front"
    if case == "continued":
        assert (span.trace_id, span.id, span.name) == (0xFF, 0xEE,
                                                       "get /hello")


def test_nested_middleware_emits_single_b3_header_set():
    """tests/test_client.py's nested case on the port: the outer
    middleware's echo wins, pre-existing X-B3-* headers (any case) are
    filtered, and the header list equals the reference's."""
    out = []
    for pkg in (client, ref_client):
        inner = pkg.ZipkinWSGIMiddleware(
            make_app((("x-b3-traceid", "dead"), ("X-B3-SpanId", "beef"))),
            pkg.Tracer("inner", lambda spans: None, rng=random.Random(1)))
        outer = pkg.ZipkinWSGIMiddleware(
            inner, pkg.Tracer("outer", lambda spans: None,
                              rng=random.Random(2)))
        captured = {}

        def start_response(status, headers, exc_info=None):
            captured["headers"] = headers

        outer(dict(ENVIRONS["continued"], HTTP_X_B3_TRACEID="ab",
                   HTTP_X_B3_SPANID="cd"), start_response)
        out.append(captured["headers"])
    assert out[0] == out[1]
    names = [k.lower() for k, _ in out[0] if k.lower().startswith("x-b3-")]
    assert sorted(names) == sorted(set(names))
    by_name = {k.lower(): v for k, v in out[0]}
    assert (by_name["x-b3-traceid"], by_name["x-b3-spanid"],
            by_name["x-b3-sampled"]) == ("ab", "cd", "1")


class _Recorder:
    """Stands in for ``urllib.request.urlopen``: keeps each request's
    method, URL, headers, body and timeout; answers ``reply``."""

    def __init__(self, reply=b"{}"):
        self.calls, self.reply = [], reply

    def __call__(self, req, timeout=None):
        if isinstance(req, str):
            self.calls.append(("GET", req, {}, None, timeout))
        else:
            self.calls.append((req.get_method(), req.full_url,
                               dict(req.header_items()), req.data, timeout))
        reply = self.reply

        class _Resp:
            def read(self):
                return reply

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

        return _Resp()


def _spans(m):
    ep = m.Endpoint(0x0A000001, 8080, "svc")
    return [m.Span(-7, "op", 3, None, (m.Annotation(10, "sr", ep),
                                       m.Annotation(25, "ss", ep)),
                   (m.BinaryAnnotation("k", b"v", host=ep),)),
            m.Span(9, "child", 4, 3, (m.Annotation(12, "cs", ep),))]


def test_http_transport_sends_reference_bytes(monkeypatch):
    recs = []
    for pkg, m in ((client, PORT[0]), (ref_client, ref_span)):
        rec = _Recorder()
        monkeypatch.setattr(urllib.request, "urlopen", rec)
        pkg.http_transport("http://collector:9411/")(_spans(m))
        recs.append(rec.calls)
    assert recs[0] == recs[1]
    ((method, url, headers, body, timeout),) = recs[0]
    assert (method, url, timeout) == ("POST",
                                      "http://collector:9411/api/spans", 10)
    assert headers["Content-type"] == "application/json"
    assert [s["traceId"] for s in json.loads(body)] == [
        "fffffffffffffff9", "9"]


QUERY_CALLS = [
    ("services", (), {}),
    ("span_names", ("api",), {}),
    ("query", ("api",), {"limit": 5, "spanName": "x"}),
    ("trace", (-123,), {}),
    ("trace", ("ff",), {}),
    ("dependencies", (), {}),
    ("traces_exist", ([1, -2, "ab"],), {}),
    ("span_durations", ("web", "call"), {}),
    ("span_durations", ("web", "call", 500), {}),
    ("service_names_to_trace_ids", ("web",), {}),
    ("service_names_to_trace_ids", ("web", "call", 7), {}),
    ("data_ttl", (), {}),
]


@pytest.mark.parametrize("idx", range(len(QUERY_CALLS)),
                         ids=[c[0] for c in QUERY_CALLS])
def test_query_client_urls_match_reference(idx, monkeypatch):
    name, args, kw = QUERY_CALLS[idx]
    reply = json.dumps({"exist": [], "durations": {}, "serviceNames": {},
                        "dataTimeToLive": 1}).encode()
    calls = []
    for pkg in (client, ref_client):
        rec = _Recorder(reply)
        monkeypatch.setattr(urllib.request, "urlopen", rec)
        got = getattr(pkg.QueryClient("http://q:9411/", timeout=3.5),
                      name)(*args, **kw)
        calls.append((rec.calls, got))
    assert calls[0] == calls[1]
    assert calls[0][0][0][4] == 3.5


@pytest.fixture
def serve():
    started = []

    def start(api):
        server = port_server.make_server(api, host="127.0.0.1", port=0)
        thread = port_server.serve_forever_in_thread(server)
        started.append((server, thread))
        return f"http://127.0.0.1:{server.server_address[1]}"

    yield start
    for server, thread in started:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def test_instrumented_app_to_server_to_query_loop(serve):
    """An instrumented WSGI app ships its server spans with
    ``http_transport`` to a port server's ``POST /api/spans``; the
    port's ``QueryClient`` reads them back through the same server."""
    store = InMemorySpanStore()
    col = Collector(store, concurrency=1, registry=obs.Registry())
    api = port_server.ApiServer(QueryService(store, coalesce_window_s=0.0),
                                col, self_trace=False,
                                registry=obs.Registry())
    try:
        base = serve(api)
        tracer = client.Tracer("front", client.http_transport(base),
                               rng=random.Random(5))
        app = client.ZipkinWSGIMiddleware(make_app(), tracer)
        headers = {}
        app({"PATH_INFO": "/hello", "REQUEST_METHOD": "GET"},
            lambda status, h, exc_info=None: headers.update(h))
        col.flush()
        qc = client.QueryClient(base, timeout=10)
        assert qc.services() == ["front"]
        assert qc.span_names("front") == ["get /hello"]
        spans = qc.trace(headers["X-B3-TraceId"])
        assert [s["name"] for s in spans] == ["get /hello"]
        assert qc.traces_exist([int(headers["X-B3-TraceId"], 16)]) == [
            headers["X-B3-TraceId"]]
    finally:
        col.close()
        api.query.close()
