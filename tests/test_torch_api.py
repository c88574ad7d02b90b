"""The port's HTTP API against the reference, on the CPU.

The same spans (generated from a numpy seed, plus the hand-built traces
of ``tests/test_api.py``) go into three pairs of stores: the reference's
``InMemorySpanStore`` and the port's, the reference's
``SqliteSpanStore`` and the port's, and ``TpuSpanStore`` on JAX-CPU and
``TorchSpanStore(device="cpu")``. Each store sits behind its own
package's ``ApiServer(QueryService(...), self_trace=False)``. Every
route of ``_KNOWN_ROUTES``, the id, pin and vars routes, and the bad
requests (a missing ``serviceName``, malformed ids, unknown routes, a
refused ``/vars`` write) must give the reference's status and payload
(after a ``json.dumps``/``json.loads`` round trip; raw pages byte for
byte). Stated tolerance (ROADMAP Queue 3): on the device pair the
dependency links' float32 moments, count exact and the other fields
within 1e-5 of the field's largest magnitude (tolerance 2, bounded by
``tests/test_torch_store.py::test_ingest_steps_match_reference``).

Also ``/metrics``: the JSON key set against the reference's for the
ring, paged, window and tiered configs, the store counters' values after
equal writes, the Prometheus families and label names; the ingest doors
and the socket round trips. Every server binds ``127.0.0.1:0`` and is
shut down and closed by the ``serve`` fixture; every client call has a
timeout.
"""

import dataclasses
import json
import re
import subprocess
import sys
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from zipkin_tpu import obs as ref_obs  # noqa: E402
from zipkin_tpu import query as ref_query  # noqa: E402
from zipkin_tpu.api import server as ref_server  # noqa: E402
from zipkin_tpu.ingest.collector import Collector as RefCollector  # noqa: E402
from zipkin_tpu.ingest.receiver import span_to_json as ref_to_json  # noqa: E402
from zipkin_tpu.models import span as ref_span  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.memory import InMemorySpanStore as RefMemory  # noqa: E402
from zipkin_tpu.store.sql import SqliteSpanStore as RefSql  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu.wire.thrift import span_to_scribe_message  # noqa: E402
from zipkin_tpu_torch import obs as port_obs  # noqa: E402
from zipkin_tpu_torch import query as port_query  # noqa: E402
from zipkin_tpu_torch.api import server as port_server  # noqa: E402
from zipkin_tpu_torch.client import QueryClient  # noqa: E402
from zipkin_tpu_torch.ingest.collector import Collector as PortCollector  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.memory import InMemorySpanStore as PortMemory  # noqa: E402
from zipkin_tpu_torch.store.sql import SqliteSpanStore as PortSql  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402

from test_torch_store import PORT, _convert, moments_close  # noqa: E402

# tests/test_query.py's SMALL geometry with the windowed arena on, as
# tests/test_torch_query.py uses it.
CFG = dict(capacity=1 << 10, ann_capacity=1 << 12, bann_capacity=1 << 11,
           max_services=32, max_span_names=128, max_annotation_values=256,
           max_binary_keys=64, cms_width=1 << 10, hll_p=8,
           quantile_buckets=512, window_seconds=60, window_buckets=8)
BASE_TS = 1_700_000_000_000_000


def _hex(tid: int) -> str:
    return f"{tid & (2 ** 64 - 1):x}"


def hand_spans(m):
    """tests/test_api.py's traces 1-3 and its negative-id trace, in the
    span model module ``m``."""
    web, api = m.Endpoint(0x01010101, 80, "web"), m.Endpoint(0x02020202,
                                                             80, "api")

    def rpc(tid, sid, cs, cr, name="call"):
        return m.Span(tid, name, sid, None, (
            m.Annotation(cs, "cs", web), m.Annotation(cs + 1, "sr", api),
            m.Annotation(cr - 1, "ss", api), m.Annotation(cr, "cr", web),
            m.Annotation(cs + 5, "hot", api),
        ), (m.BinaryAnnotation("k", b"v", host=api),))

    neg = m.Endpoint(1, 80, "neg")
    return [rpc(1, 10, 100, 200), rpc(2, 11, 1100, 1300),
            rpc(3, 12, 2100, 2500, name="other"),
            m.Span(-123, "op", 1, None, (m.Annotation(5, "sr", neg),
                                         m.Annotation(9, "ss", neg)), ())]


def seed_spans():
    """Generated traces (numpy seed) then the hand-built ones, as
    reference Span objects."""
    traces = generate_traces(n_traces=70, max_depth=3, n_services=6,
                             rng=np.random.default_rng(17),
                             base_ts=BASE_TS)
    return [s for t in traces for s in t] + hand_spans(ref_span)


SPANS = seed_spans()
TID = _hex(SPANS[0].trace_id)
NAME = SPANS[0].name
SVC = "elit-5"


def _api(pkg, store, registry):
    q = (ref_query if pkg == "ref" else port_query).QueryService(
        store, coalesce_window_s=0.0, registry=registry)
    srv = ref_server if pkg == "ref" else port_server
    return srv.ApiServer(q, self_trace=False, registry=registry)


def _stores(kind):
    if kind == "memory":
        return RefMemory(), PortMemory()
    if kind == "sql":
        return RefSql(), PortSql()
    reg_r, reg_p = ref_obs.Registry(), port_obs.Registry()
    return (TpuSpanStore(dev.StoreConfig(**CFG), registry=reg_r),
            TorchSpanStore(tdev.StoreConfig(**CFG), device="cpu",
                           registry=reg_p))


@pytest.fixture(scope="module")
def servers():
    """{kind: (reference ApiServer, port ApiServer)} over the same
    spans."""
    port_spans = _convert(SPANS, PORT)
    out = {}
    for kind in ("memory", "sql", "device"):
        ref, port = _stores(kind)
        for i in range(0, len(SPANS), 96):
            ref.apply(SPANS[i:i + 96])
            port.apply(port_spans[i:i + 96])
        out[kind] = (_api("ref", ref, ref_obs.Registry()),
                     _api("port", port, port_obs.Registry()))
    yield out
    for ref, port in out.values():
        for api in (ref, port):
            api.query.close()
            if isinstance(api.query.store, (RefSql, PortSql)):
                api.query.store.close()


def norm(status, payload):
    """Status plus a comparable payload: raw pages as (type, bytes),
    JSON as its strict round trip."""
    if isinstance(payload, (ref_server.RawResponse,
                            port_server.RawResponse)):
        return status, ("raw", payload.content_type, payload.body)

    def boom(name):
        raise AssertionError(f"route emitted non-JSON constant {name!r}")

    return status, json.loads(json.dumps(payload), parse_constant=boom)


def both(pair, method, path, params=None, body=b""):
    ref, port = pair
    return (norm(*port.handle(method, path, dict(params or {}), body)),
            norm(*ref.handle(method, path, dict(params or {}), body)))


def _deps_close(got, want) -> bool:
    """The dependency payloads with the moments held by stated
    tolerance 2 (float32 moments: count exact)."""
    (gs, gb), (ws, wb) = got, want
    if gs != ws or {k: v for k, v in gb.items() if k != "links"} != {
            k: v for k, v in wb.items() if k != "links"}:
        return False
    key = lambda l: (l["parent"], l["child"])  # noqa: E731
    gl, wl = sorted(gb["links"], key=key), sorted(wb["links"], key=key)
    if [key(l) for l in gl] != [key(l) for l in wl]:
        return False
    fields = ("count", "mean", "stddev", "m2", "m3", "m4")
    gm = [[l["durationMoments"][f] for f in fields] for l in gl]
    wm = [[l["durationMoments"][f] for f in fields] for l in wl]
    if [[v is None for v in r] for r in gm] != [[v is None for v in r]
                                                for r in wm]:
        return False

    def fill(m):
        return np.array([[0.0 if v is None else v for v in r] for r in m],
                        np.float64).reshape(-1, len(fields))

    return moments_close(fill(wm), fill(gm))


# (method, path, params, body) for every route of _KNOWN_ROUTES, the id,
# pin and vars routes, and the bad requests.
ROUTES = {
    "index": ("GET", "/", {}, b""),
    "index_html": ("GET", "/index.html", {}, b""),
    "traces_page": ("GET", "/traces", {}, b""),
    "aggregate_page": ("GET", "/aggregate", {}, b""),
    "health": ("GET", "/health", {}, b""),
    "api_health": ("GET", "/api/health", {}, b""),
    "fleet": ("GET", "/api/fleet", {}, b""),
    "events": ("GET", "/debug/events", {}, b""),
    "events_limit": ("GET", "/debug/events", {"limit": "5"}, b""),
    "profile_get": ("GET", "/debug/profile", {}, b""),
    "profile_bad_seconds": ("POST", "/debug/profile", {"seconds": "nope"},
                            b""),
    "query": ("GET", "/api/query", {"serviceName": SVC, "limit": "10"}, b""),
    "query_span_order": ("GET", "/api/query",
                         {"serviceName": SVC, "spanName": NAME,
                          "limit": "100", "order": "duration-desc"}, b""),
    "query_terms": ("GET", "/api/query",
                    {"serviceName": SVC, "endTs": str(BASE_TS + 10 ** 9),
                     "annotationQuery": "some custom annotation and "
                                        "http.uri=/api/widgets"}, b""),
    "query_hand": ("GET", "/api/query",
                   {"serviceName": "api", "timestamp": str(10 ** 18)}, b""),
    "query_negative_id": ("GET", "/api/query", {"serviceName": "neg"}, b""),
    "query_missing_service": ("GET", "/api/query", {}, b""),
    "query_bad_limit": ("GET", "/api/query",
                        {"serviceName": "api", "limit": "ten"}, b""),
    "services": ("GET", "/api/services", {}, b""),
    "spans": ("GET", "/api/spans", {"serviceName": "api"}, b""),
    "spans_generated": ("GET", "/api/spans", {"serviceName": SVC}, b""),
    "spans_missing_service": ("GET", "/api/spans", {}, b""),
    "v1_spans_get": ("GET", "/api/v1/spans", {}, b""),
    "v1_spans_no_collector": ("POST", "/api/v1/spans", {}, b"[]"),
    "spans_post_no_collector": ("POST", "/api/spans", {}, b"[]"),
    "top_annotations": ("GET", "/api/top_annotations",
                        {"serviceName": SVC}, b""),
    "top_kv_annotations": ("GET", "/api/top_kv_annotations",
                           {"serviceName": SVC}, b""),
    "top_annotations_missing": ("GET", "/api/top_annotations", {}, b""),
    "quantiles": ("GET", "/api/quantiles",
                  {"serviceName": SVC, "q": "0.5,0.99"}, b""),
    "quantiles_default": ("GET", "/api/quantiles", {"serviceName": "api"},
                          b""),
    "quantiles_unknown_service": ("GET", "/api/quantiles",
                                  {"serviceName": "no-such"}, b""),
    "quantiles_missing": ("GET", "/api/quantiles", {}, b""),
    "dependencies": ("GET", "/api/dependencies", {}, b""),
    "dependencies_path_window": ("GET", "/api/dependencies/0/100", {}, b""),
    "dependencies_params": ("GET", "/api/dependencies",
                            {"startTime": str(BASE_TS),
                             "endTime": str(BASE_TS + 10 ** 10)}, b""),
    "traces_exist": ("GET", "/api/traces_exist",
                     {"traceIds": f"1,2,deadbeef,{TID},ffffffffffffff85"},
                     b""),
    "traces_exist_missing": ("GET", "/api/traces_exist", {}, b""),
    "span_durations": ("GET", "/api/span_durations",
                       {"serviceName": "web", "spanName": "call"}, b""),
    "span_durations_ts": ("GET", "/api/span_durations",
                          {"serviceName": "web", "spanName": "call",
                           "timeStamp": "500"}, b""),
    "span_durations_generated": ("GET", "/api/span_durations",
                                 {"serviceName": SVC, "spanName": NAME},
                                 b""),
    "span_durations_all": ("GET", "/api/span_durations",
                           {"serviceName": "web", "spanName": "all"}, b""),
    "span_durations_missing": ("GET", "/api/span_durations", {}, b""),
    "service_names_to_trace_ids": ("GET",
                                   "/api/service_names_to_trace_ids",
                                   {"serviceName": "web",
                                    "spanName": "call"}, b""),
    "service_names_generated": ("GET", "/api/service_names_to_trace_ids",
                                {"serviceName": SVC}, b""),
    "service_names_missing": ("GET", "/api/service_names_to_trace_ids", {},
                              b""),
    "data_ttl": ("GET", "/api/data_ttl", {}, b""),
    "windowed_quantiles": ("GET", "/api/windowed_quantiles",
                           {"serviceName": SVC, "q": "0.5,0.9"}, b""),
    "windowed_quantiles_range": ("GET", "/api/windowed_quantiles",
                                 {"serviceName": SVC,
                                  "startTs": str(BASE_TS),
                                  "endTs": str(BASE_TS + 10 ** 9)}, b""),
    "windowed_quantiles_missing": ("GET", "/api/windowed_quantiles", {},
                                   b""),
    "slo_burn": ("GET", "/api/slo_burn",
                 {"serviceName": SVC, "windows": "300,3600",
                  "nowTs": str(BASE_TS + 10 ** 8)}, b""),
    "slo_burn_objective": ("GET", "/api/slo_burn",
                           {"serviceName": SVC, "objective": "0.9",
                            "nowTs": str(BASE_TS + 10 ** 8)}, b""),
    "slo_burn_missing": ("GET", "/api/slo_burn", {}, b""),
    "latency_heatmap": ("GET", "/api/latency_heatmap",
                        {"serviceName": SVC, "bands": "4"}, b""),
    "latency_heatmap_missing": ("GET", "/api/latency_heatmap", {}, b""),
    "replication": ("GET", "/api/replication", {}, b""),
    "scribe_get": ("GET", "/scribe", {}, b""),
    "scribe_no_collector": ("POST", "/scribe", {}, b"[]"),
    "unknown": ("GET", "/api/nope", {}, b""),
    "unknown_other": ("GET", "/some/scanner/path", {}, b""),
    "trace": ("GET", f"/api/trace/{TID}", {}, b""),
    "trace_get_alias": ("GET", f"/api/get/{TID}", {}, b""),
    "trace_no_adjust": ("GET", f"/api/trace/{TID}",
                        {"adjust_clock_skew": "false"}, b""),
    "trace_hand": ("GET", "/api/trace/1", {}, b""),
    "trace_negative_hex": ("GET", "/api/trace/ffffffffffffff85", {}, b""),
    "trace_legacy_decimal": ("GET", "/api/trace/-123", {}, b""),
    "trace_missing": ("GET", "/api/trace/999", {}, b""),
    "trace_malformed": ("GET", "/api/trace/xyz", {}, b""),
    "trace_malformed_decimal": ("GET", "/api/trace/-12a", {}, b""),
    "timeline": ("GET", f"/api/timeline/{TID}", {}, b""),
    "timeline_hand": ("GET", "/api/timeline/1", {}, b""),
    "timeline_missing": ("GET", "/api/timeline/dead", {}, b""),
    "combo": ("GET", f"/api/combo/{TID}", {}, b""),
    "combo_no_adjust": ("GET", "/api/combo/1",
                        {"adjust_clock_skew": "false"}, b""),
    "combo_missing": ("GET", "/api/combo/dead", {}, b""),
    "is_pinned": ("GET", "/api/is_pinned/2", {}, b""),
    "pin_get_refused": ("GET", "/api/pin/2/true", {}, b""),
    "vars_query_window": ("GET", "/vars/queryWindowMs", {}, b""),
    "vars_window_seconds": ("GET", "/vars/windowSeconds", {}, b""),
    "vars_window_buckets": ("GET", "/vars/windowBuckets", {}, b""),
    "vars_layout": ("GET", "/vars/layout", {}, b""),
    "vars_page_rows": ("GET", "/vars/pageRows", {}, b""),
    "vars_window_seconds_write": ("POST", "/vars/windowSeconds", {}, b"30"),
    "vars_sample_rate_no_collector": ("GET", "/vars/sampleRate", {}, b""),
    "vars_unknown": ("GET", "/vars/nope", {}, b""),
}


def test_route_table_covers_every_known_route():
    covered = {port_server._route_label(path)
               for _, path, _, _ in ROUTES.values()}
    assert port_server._KNOWN_ROUTES == ref_server._KNOWN_ROUTES
    missing = {r for r in port_server._KNOWN_ROUTES
               if r not in covered and r != "/metrics"}
    assert not missing
    for label in ("/api/trace/{id}", "/api/get/{id}", "/api/timeline/{id}",
                  "/api/combo/{id}", "/api/is_pinned/{id}",
                  "/api/pin/{id}", "/api/dependencies/{window}",
                  "/vars/{name}", "other"):
        assert label in covered, label


@pytest.mark.parametrize("kind", ["memory", "sql", "device"])
@pytest.mark.parametrize("case", list(ROUTES))
def test_route_matches_reference(servers, kind, case):
    method, path, params, body = ROUTES[case]
    got, want = both(servers[kind], method, path, params, body)
    if kind == "device" and case.startswith("dependencies") \
            and got != want:
        assert _deps_close(got, want), (got, want)
    else:
        assert got == want
    if case in ("query", "query_terms", "trace", "combo", "spans_generated",
                "span_durations_generated", "quantiles"):
        assert want[0] == 200 and want[1], "vacuous"


@pytest.mark.parametrize("kind", ["memory", "sql", "device"])
def test_pin_cycle_matches_reference(servers, kind):
    """pin → is_pinned → unpin → is_pinned, step by step (the pin
    writes a TTL on both sides, then takes it back)."""
    pair = servers[kind]
    for method, path in (("POST", "/api/pin/2/true"),
                         ("GET", "/api/is_pinned/2"),
                         ("POST", "/api/pin/ffffffffffffff85/true"),
                         ("GET", "/api/is_pinned/ffffffffffffff85"),
                         ("POST", "/api/pin/2/false"),
                         ("GET", "/api/is_pinned/2"),
                         ("POST", "/api/pin/ffffffffffffff85/false"),
                         ("GET", f"/api/trace/{TID}")):
        got, want = both(pair, method, path)
        assert got == want, path
        assert want[0] == 200, path


def test_query_window_var_write_matches_reference(servers):
    """The one writable var without a collector: the executor window,
    set and read back, then restored."""
    pair = servers["device"]
    before = both(pair, "GET", "/vars/queryWindowMs")
    assert before[0] == before[1]
    for body in (b"5", b"0"):
        got, want = both(pair, "POST", "/vars/queryWindowMs", body=body)
        assert got == want and want[0] == 200
    assert pair[1].query.coalescer.window_s == 0.0


# -- /metrics -----------------------------------------------------------------

def _families(text: str):
    """{family: (type, label names of every sample)} of a Prometheus
    text exposition."""
    out, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split()
            types[name] = typ
            out.setdefault(name, set())
        elif line and not line.startswith("#"):
            m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$",
                         line)
            assert m, line
            name = m.group(1)
            fam = next(f for f in (name, re.sub(r"_(count|sum)$", "",
                                                name)) if f in types)
            labels = tuple(sorted(re.findall(r'([a-zA-Z_]+)="', m.group(3)
                                             or "")))
            out[fam].add(labels)
    return {k: (types[k], frozenset(v)) for k, v in out.items()}


@pytest.mark.parametrize("kind", ["memory", "sql", "device"])
def test_metrics_text_families_match_reference(servers, kind):
    ref, port = servers[kind]
    for api in (ref, port):
        api.handle("GET", "/api/services", {})
    texts = []
    for api in (port, ref):
        status, payload = api.handle("GET", "/metrics", {})
        assert status == 200
        assert payload.content_type == "text/plain; version=0.0.4; " \
                                       "charset=utf-8"
        texts.append(payload.body.decode())
    got, want = (_families(t) for t in texts)
    assert got == want
    assert "zipkin_api_request_seconds" in got
    fleet = [norm(*api.handle("GET", "/metrics", {"fleet": "1"}))
             for api in (port, ref)]
    assert fleet[0][0] == fleet[1][0] == 200
    assert _families(fleet[0][1][2].decode()) == got


def _store_keys(text: str):
    return set(re.findall(r'^zipkin_store_counter\{name="([^"]+)"\}',
                          text, re.M))


@pytest.mark.parametrize("kind", ["memory", "sql", "device"])
def test_metrics_json_keys_match_reference(servers, kind):
    ref, port = servers[kind]
    got = port.handle("GET", "/metrics", {"format": "json"})
    want = ref.handle("GET", "/metrics", {"format": "json"})
    assert got[0] == want[0] == 200
    assert set(got[1]) == set(want[1])
    text = port.handle("GET", "/metrics", {})[1].body.decode()
    assert _store_keys(text) == {k[len("store."):] for k in got[1]
                                 if k.startswith("store.")}


def _tiered_pair():
    from zipkin_tpu.store.archive import ArchiveParams as RefParams
    from zipkin_tpu.store.archive import TieredSpanStore as RefTiered
    from zipkin_tpu_torch.store.archive import ArchiveParams, TieredSpanStore

    ref, port = _stores("device")
    return (RefTiered(ref, params=RefParams.for_config(ref.config),
                      registry=ref_obs.Registry()),
            TieredSpanStore(port, params=ArchiveParams.for_config(
                port.config), registry=port_obs.Registry()))


CONFIGS = {
    "ring": dict(CFG, window_seconds=0),
    "paged": dict(CFG, window_seconds=0, layout="paged", page_rows=64),
    "window": CFG,
    "tiered": None,
}
NEW_KEYS = ("jit_compiles", "query_jit_compiles", "rank_path_counting",
            "scatter_path_pallas")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_metrics_json_store_counters_match_reference(config):
    """The ``store.*`` key set equals the reference's, the four keys
    the port added among them, and every value but the two compile
    counters (whose port meaning is kernel libraries loaded) equals the
    reference's after equal writes; the compile counters stay flat."""
    if CONFIGS[config] is None:
        ref, port = _tiered_pair()
    else:
        reg_r, reg_p = ref_obs.Registry(), port_obs.Registry()
        ref = TpuSpanStore(dev.StoreConfig(**CONFIGS[config]),
                           registry=reg_r)
        port = TorchSpanStore(tdev.StoreConfig(**CONFIGS[config]),
                              device="cpu", registry=reg_p)
    apis = (_api("ref", ref, ref_obs.Registry()),
            _api("port", port, port_obs.Registry()))
    try:
        half = len(SPANS) // 2
        port_spans = _convert(SPANS, PORT)
        ref.apply(SPANS[:half])
        port.apply(port_spans[:half])
        first = apis[1].handle("GET", "/metrics", {"format": "json"})[1]
        ref.apply(SPANS[half:])
        port.apply(port_spans[half:])
        want = apis[0].handle("GET", "/metrics", {"format": "json"})[1]
        got = apis[1].handle("GET", "/metrics", {"format": "json"})[1]
        assert set(got) == set(want)
        store_keys = {k for k in want if k.startswith("store.")}
        assert {f"store.{k}" for k in NEW_KEYS} <= store_keys
        compile_keys = {"store.jit_compiles", "store.query_jit_compiles"}
        assert {k: got[k] for k in store_keys - compile_keys} == {
            k: want[k] for k in store_keys - compile_keys}
        assert got["store.batches"] > first["store.batches"]
        assert {k: got[k] for k in compile_keys} == {
            k: first[k] for k in compile_keys}
        # On the CPU no kernel library loads (the wrappers take their
        # plain twins), so the compile counters read 0.
        assert got["store.jit_compiles"] == 0.0
    finally:
        for api in apis:
            api.query.close()


def test_store_path_counters_follow_the_step():
    """``scatter_path_pallas`` is 1.0 once a ``use_pallas`` step sent
    its scatter-adds and arena write through the K1 and K2 wrappers,
    ``rank_path_counting`` once a step's rank_mode chose the counting
    ranks."""
    cfg = dict(CFG, window_seconds=0, use_pallas=True, rank_path="counting",
               cms_width=1 << 11)
    port = TorchSpanStore(tdev.StoreConfig(**cfg), device="cpu",
                          registry=port_obs.Registry())
    before = port.counters()
    assert (before["scatter_path_pallas"], before["rank_path_counting"]) \
        == (0.0, 0.0)
    port.apply(_convert(SPANS[:60], PORT))
    after = port.counters()
    assert (after["scatter_path_pallas"], after["rank_path_counting"]) \
        == (1.0, 1.0)
    assert port.state.paths == {"rank": {"counting"},
                                "scatter": {"pallas"}}


# -- ingest doors --------------------------------------------------------------

def _door_pair(kind):
    out = []
    for pkg, store, reg, col in (
            ("ref",) + (_stores(kind)[0],) + (ref_obs.Registry(),
                                              RefCollector),
            ("port",) + (_stores(kind)[1],) + (port_obs.Registry(),
                                               PortCollector)):
        collector = col(store, concurrency=1, registry=reg)
        q = (ref_query if pkg == "ref" else port_query).QueryService(
            store, coalesce_window_s=0.0, registry=reg)
        srv = ref_server if pkg == "ref" else port_server
        out.append(srv.ApiServer(q, collector, self_trace=False,
                                 registry=reg))
    return tuple(out)


@pytest.fixture
def doors():
    made = []

    def make(kind):
        pair = _door_pair(kind)
        made.append(pair)
        return pair

    yield make
    for pair in made:
        for api in pair:
            api.collector.close()
            api.query.close()
            if isinstance(api.query.store, (RefSql, PortSql)):
                api.query.store.close()


@pytest.mark.parametrize("kind", ["memory", "sql", "device"])
def test_ingest_doors_match_reference(doors, kind):
    """``POST /api/spans``, ``/api/v1/spans`` and ``/scribe`` (a good
    entry, a corrupt one, a bad body), ``/vars/sampleRate`` both ways,
    then the spans read back alike."""
    pair = doors(kind)
    spans = SPANS[:40]
    json_body = json.dumps([ref_to_json(s) for s in spans[:20]]).encode()
    scribe_body = json.dumps(
        [{"category": "zipkin", "message": span_to_scribe_message(s)}
         for s in spans[20:]]).encode()
    for method, path, body in (
            ("POST", "/api/spans", json_body),
            ("POST", "/api/v1/spans", b"[]"),
            ("POST", "/scribe", scribe_body),
            ("POST", "/scribe", json.dumps(
                [{"category": "zipkin", "message": "!!not-base64"}]).encode()),
            ("POST", "/scribe", b"{not json"),
            ("POST", "/api/spans", b"{not json")):
        got, want = both(pair, method, path, body=body)
        assert got == want, (path, body[:20])
    # The queue workers sample when they write: flush before the rate
    # moves, so both packages write every span at rate 1.0.
    for api in pair:
        api.collector.flush()
    for method, body in (("GET", b""), ("POST", b"0.5"), ("POST", b"1.0")):
        got, want = both(pair, method, "/vars/sampleRate", body=body)
        assert got == want and want[0] == 200, body
    for tid in sorted({s.trace_id for s in spans}):
        got, want = both(pair, "GET", f"/api/trace/{_hex(tid)}")
        assert got == want and want[0] == 200
    got, want = both(pair, "GET", "/api/services")
    assert got == want
    mj = [api.handle("GET", "/metrics", {"format": "json"})[1]
          for api in pair]
    for key in ("collector.processed", "collector.spans_stored",
                "collector.spans_dropped", "sampler.rate"):
        assert mj[0][key] == mj[1][key], key


def test_self_tracing_on_the_port(doors):
    """With self-tracing on, an API request records a server span under
    ``zipkin-tpu`` continuing the caller's B3 context as a child, the
    response echoes the recorded ids, and the ingest doors stay
    untraced (tests/test_api.py's TestSelfTracing, on the port)."""
    door = doors("memory")[1]
    port = port_server.ApiServer(door.query, door.collector,
                                 registry=port_obs.Registry())
    hdrs: list = []
    status, _ = port.handle("GET", "/api/services", {},
                            headers={"X-B3-TraceId": "beef",
                                     "X-B3-SpanId": "77"},
                            response_headers=hdrs)
    assert status == 200
    echo = dict(hdrs)
    assert echo["X-B3-TraceId"] == "beef" and echo["X-B3-SpanId"] != "77"
    hdrs = []
    port.handle("POST", "/api/spans", {}, b"[]", response_headers=hdrs)
    assert not dict(hdrs).get("X-B3-TraceId")
    port.collector.flush()
    spans = port.query.store.get_spans_by_trace_id(0xBEEF)
    assert len(spans) == 1
    assert spans[0].id == int(echo["X-B3-SpanId"], 16)
    assert spans[0].parent_id == 0x77
    assert port.query.store.get_span_names("zipkin-tpu") == {
        "get /api/services"}


def test_request_context_is_published_to_the_handler():
    """The traced handler runs with the request's (trace, span) in
    ``obs.fleet``'s context, and the context is reset afterwards."""
    from zipkin_tpu_torch.obs import fleet

    store = PortMemory()
    collector = PortCollector(store, concurrency=1,
                              registry=port_obs.Registry())
    api = port_server.ApiServer(
        port_query.QueryService(store, coalesce_window_s=0.0),
        collector, registry=port_obs.Registry())
    seen = []
    real = api._dispatch
    api._dispatch = lambda *a: (seen.append(
        fleet.current_request_context()), real(*a))[1]
    try:
        hdrs: list = []
        api.handle("GET", "/api/services", {},
                   headers={"X-B3-TraceId": "abc", "X-B3-SpanId": "1"},
                   response_headers=hdrs)
        echo = dict(hdrs)
        assert seen == [(0xABC, int(echo["X-B3-SpanId"], 16))]
        assert fleet.current_request_context() is None
        api.handle("GET", "/health", {})
        assert seen[-1] is None
    finally:
        collector.close()
        api.query.close()


# -- sockets -------------------------------------------------------------------

@pytest.fixture
def serve():
    """Start ApiServers on 127.0.0.1:0; shut each down, close its socket
    and join its thread at the end of the test."""
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


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers.get("Content-Type"), e.read()


@pytest.mark.parametrize("kind", ["memory", "device"])
def test_socket_answers_equal_direct_handle(servers, serve, kind):
    """Over a real socket, each route's status, content type and body
    equal the port's ``handle`` called directly (and so the
    reference's)."""
    port = servers[kind][1]
    base = serve(port)
    for case in ("services", "query_hand", "trace", "combo", "timeline",
                 "trace_missing", "dependencies", "index",
                 "quantiles_missing", "unknown"):
        method, path, params, _ = ROUTES[case]
        assert method == "GET"
        qs = urllib.parse.urlencode(params)
        status, ctype, body = _get(base + path + ("?" + qs if qs else ""))
        want_status, want = norm(*port.handle(method, path, dict(params)))
        assert status == want_status, case
        if isinstance(want, tuple):
            assert (ctype, body) == want[1:], case
        else:
            assert ctype == "application/json"
            assert json.loads(body) == want, case


def test_real_http_roundtrip(serve):
    """tests/test_api.py's TestSocketEndToEnd, on the port: a GET, then
    a JSON POST through the collector door, read back by id."""
    store = PortMemory()
    collector = PortCollector(store, concurrency=1,
                              registry=port_obs.Registry())
    api = port_server.ApiServer(
        port_query.QueryService(store, coalesce_window_s=0.0), collector,
        registry=port_obs.Registry())
    try:
        store.apply(_convert(hand_spans(ref_span), PORT))
        base = serve(api)
        assert _get(base + "/api/services")[2] == b'["api", "neg", "web"]'
        span = _convert(hand_spans(ref_span)[0], PORT)
        span = dataclasses.replace(span, trace_id=5)
        from zipkin_tpu_torch.ingest.receiver import span_to_json

        req = urllib.request.Request(
            base + "/api/spans", method="POST",
            data=json.dumps([span_to_json(span)]).encode())
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 202
            assert json.loads(r.read()) == {"accepted": True}
        collector.flush()
        status, _, body = _get(base + "/api/trace/5")
        assert status == 200 and json.loads(body)[0]["traceId"] == "5"
        status, ctype, body = _get(base + "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert b'zipkin_api_request_seconds{route="/api/trace/{id}"' in body
    finally:
        collector.close()
        api.query.close()


def test_query_client_matches_reference(servers, serve):
    """The port's QueryClient against the port's server equals the
    reference QueryClient's reading of the reference's server."""
    from zipkin_tpu.client import QueryClient as RefClient

    ref, port = servers["memory"]
    got, want = QueryClient(serve(port), timeout=10), None
    ref_srv = ref_server.make_server(ref, host="127.0.0.1", port=0)
    ref_thread = ref_server.serve_forever_in_thread(ref_srv)
    try:
        want = RefClient(f"http://127.0.0.1:{ref_srv.server_address[1]}",
                         timeout=10)
        for name, args in (("services", ()), ("span_names", ("api",)),
                           ("query", ("api",)),
                           ("trace", (1,)), ("trace", (TID,)),
                           ("dependencies", ()),
                           ("traces_exist", ([1, 2, 999, -123],)),
                           ("span_durations", ("web", "call")),
                           ("span_durations", ("web", "call", 500)),
                           ("service_names_to_trace_ids", ("web", "call")),
                           ("data_ttl", ())):
            assert getattr(got, name)(*args) == getattr(want, name)(
                *args), name
        assert got.query("api", timestamp=10 ** 18)["traceIds"] == [
            "3", "2", "1"]
    finally:
        ref_srv.shutdown()
        ref_srv.server_close()
        ref_thread.join(timeout=10)


def test_new_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['zipkin_tpu'] = None; "
            "import zipkin_tpu_torch.api, zipkin_tpu_torch.api.server, "
            "zipkin_tpu_torch.obs.fleet, zipkin_tpu_torch.obs.profile, "
            "zipkin_tpu_torch.store.sql, zipkin_tpu_torch.web, "
            "zipkin_tpu_torch.client; "
            "from zipkin_tpu_torch.obs import CallbackFamily; "
            "from zipkin_tpu_torch.client import QueryClient, "
            "ZipkinWSGIMiddleware, http_transport; "
            "assert zipkin_tpu_torch.web.index_html()")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# -- web ------------------------------------------------------------------------

WEB_FILES = ["index.html", "extension/devtools.html", "extension/devtools.js",
             "extension/manifest.json", "extension/panel.html",
             "extension/panel.js"]


@pytest.mark.parametrize("name", WEB_FILES)
def test_web_files_equal_reference_bytes(name):
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    got = (root / "zipkin_tpu_torch" / "web" / name).read_bytes()
    assert got == (root / "zipkin_tpu" / "web" / name).read_bytes()


def test_web_extension_has_the_reference_files():
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    names = sorted(p.name for p in (root / "zipkin_tpu_torch" / "web" /
                                    "extension").iterdir())
    assert names == sorted(p.name for p in (root / "zipkin_tpu" / "web" /
                                            "extension").iterdir()
                           if p.name != "__pycache__")
    assert f"extension/{names[0]}" in WEB_FILES and len(names) == 5


def test_api_routes_used_by_ui_exist_on_port_server(servers):
    """tests/test_web_ui.py's check on the port: every /api route the
    page calls is in the port server's source and answers there (no
    404 from the route table) on the seeded memory store."""
    from zipkin_tpu_torch import web

    html = web.index_html().decode()
    src = open(port_server.__file__).read()
    called = set(re.findall(r'"(/api/[a-z_]+)[?"]', html))
    assert {"/api/services", "/api/query", "/api/spans",
            "/api/dependencies", "/api/quantiles", "/api/top_annotations",
            "/api/top_kv_annotations"} <= called
    port = servers["memory"][1]
    for route in sorted(called):
        assert route in src, f"UI calls {route} but server lacks it"
        status, body = port.handle("GET", route, {"serviceName": "api"})
        assert status == 200, (route, body)
