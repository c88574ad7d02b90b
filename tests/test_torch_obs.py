"""The port's Prometheus exposition, request context and profiler, on
the CPU.

``escape_help``, ``escape_label_value``, ``_fmt`` and the rendered text
of the same metrics (counters, gauges, latency sketches and a
``CallbackFamily``) against the reference's, on a table of strings and
values (quotes, backslashes, newlines, NaN, infinities); the request
context of ``obs.fleet``; and ``obs.profile`` on ``torch.profiler``: the
clamp, one capture at a time, the trace file, and the
``POST /debug/profile`` statuses (200, 400, 409, 503) as the reference
gives them (``tests/test_obs.py``'s profile-endpoint case, on the port).
"""

import json
import math
import os
import shutil
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from zipkin_tpu import obs as ref_obs  # noqa: E402
from zipkin_tpu.obs import fleet as ref_fleet  # noqa: E402
from zipkin_tpu.obs import registry as ref_registry  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.api import server as port_server  # noqa: E402
from zipkin_tpu_torch.ingest.collector import Collector  # noqa: E402
from zipkin_tpu_torch.obs import fleet  # noqa: E402
from zipkin_tpu_torch.obs import profile  # noqa: E402
from zipkin_tpu_torch.obs import registry  # noqa: E402
from zipkin_tpu_torch.query.service import QueryService  # noqa: E402
from zipkin_tpu_torch.store.memory import InMemorySpanStore  # noqa: E402

STRINGS = ["plain", 'we"ird', "back\\slash", "new\nline", "tab\tand space",
           '\\"\n', "", "ünïcode ✓", "trailing\\", "a=b,c}"]
VALUES = [0, 1, -3, 2.5, 1e20, 1e-9, 0.1 + 0.2, float("nan"), float("inf"),
          float("-inf"), True, "7", "nope", None, 2 ** 53]


@pytest.mark.parametrize("s", STRINGS)
def test_escapes_match_reference(s):
    assert registry.escape_help(s) == ref_registry.escape_help(s)
    assert (registry.escape_label_value(s)
            == ref_registry.escape_label_value(s))
    assert registry._label_str((("k", s), ("j", s))) == \
        ref_registry._label_str((("k", s), ("j", s)))


@pytest.mark.parametrize("v", VALUES, ids=repr)
def test_sample_format_matches_reference(v):
    assert registry._fmt(v) == ref_registry._fmt(v)


def _populate(mod):
    """The same metrics, in ``mod``'s registry."""
    r = mod.Registry()
    r.register(mod.Counter("z_total", 'a "counter"\nwith \\ escapes')).inc(2)
    c = r.register(mod.Counter("z_route_total", "by route",
                               labelnames=("route",)))
    for s in STRINGS:
        c.labels(route=s).inc(len(s) + 1)
    r.register(mod.Gauge("z_gauge", "a gauge", fn=lambda: 1.5))
    r.register(mod.Gauge("z_nan_gauge", "nan", fn=lambda: float("nan")))
    h = r.register(mod.LatencySketch("z_seconds", "a summary",
                                     labelnames=("endpoint",)))
    for i, s in enumerate(STRINGS[:4]):
        for k in range(1, 40):
            h.labels(endpoint=s).observe(k * 1e-4 * (i + 1))
    r.register(mod.LatencySketch("z_empty_seconds", "never observed"))
    table = {s: v for s, v in zip(STRINGS, VALUES)}
    r.register(mod.CallbackFamily("z_store_counter", "store counters",
                                  "name", lambda: dict(table)))

    def broken():
        raise RuntimeError("callback failed")

    r.register(mod.CallbackFamily("z_broken", "absent family", "name",
                                  broken))
    return r


def test_render_text_matches_reference():
    got, want = _populate(obs).render_text(), _populate(ref_obs).render_text()
    assert got == want
    assert 'z_store_counter{name="we\\"ird"} 1\n' in got
    assert 'z_store_counter{name="new\\nline"} 2.5\n' in got
    assert 'z_store_counter{name="ünïcode ✓"} NaN\n' in got
    assert 'z_store_counter{name="trailing\\\\"} +Inf\n' in got
    assert 'z_empty_seconds{quantile="0.5"} NaN' in got
    assert "# HELP z_total a \"counter\"\\nwith \\\\ escapes\n" in got
    assert "# TYPE z_broken gauge\n" in got
    assert "z_broken{" not in got
    assert _populate(obs).as_dict().keys() == \
        _populate(ref_obs).as_dict().keys()


def test_callback_family_samples_match_reference():
    values = {"b": 2.0, "a": float("nan"), 'q"': -1}
    got = list(obs.CallbackFamily("f", "h", "name",
                                  lambda: values).samples())
    want = list(ref_obs.CallbackFamily("f", "h", "name",
                                       lambda: values).samples())
    assert [(s, l) for s, l, _ in got] == [(s, l) for s, l, _ in want]
    assert [str(v) for *_, v in got] == [str(v) for *_, v in want]
    assert [l for _, l, _ in got] == [(("name", "a"),), (("name", "b"),),
                                      (("name", 'q"'),)]


def test_request_context_matches_reference():
    assert fleet.current_request_context() is None
    tok = fleet.set_request_context(0xABC, -5)
    rtok = ref_fleet.set_request_context(0xABC, -5)
    try:
        assert (fleet.current_request_context()
                == ref_fleet.current_request_context() == (0xABC, -5))
        seen = []
        t = threading.Thread(
            target=lambda: seen.append(fleet.current_request_context()))
        t.start()
        t.join(timeout=10)
        assert seen == [None]  # a context var: per thread, not global
    finally:
        fleet.reset_request_context(tok)
        ref_fleet.reset_request_context(rtok)
    assert fleet.current_request_context() is None


def _trace_events(out_dir):
    with open(os.path.join(out_dir, profile.TRACE_FILE)) as f:
        return json.load(f)["traceEvents"]


def test_capture_writes_a_chrome_trace(tmp_path, monkeypatch):
    out, secs = profile.capture(0.001, out_dir=str(tmp_path / "a"))
    assert (out, secs) == (str(tmp_path / "a"), 0.01)  # clamped up
    assert _trace_events(out)
    # A thread started inside the window (as the HTTP server starts one
    # a request): its ops are in the trace where the installed torch
    # records every thread.
    real_sleep = profile.time.sleep

    def window(seconds):
        t = threading.Thread(target=lambda: [torch.ones(512).cumsum(0)
                                             for _ in range(20)])
        t.start()
        t.join(timeout=30)
        real_sleep(seconds)

    monkeypatch.setattr(profile.time, "sleep", window)
    out, secs = profile.capture(0.05, out_dir=str(tmp_path / "b"))
    assert secs == 0.05
    names = {e.get("name") for e in _trace_events(out)}
    if profile._all_threads_config() is not None:
        assert "aten::cumsum" in names


def test_capture_clamps_and_is_exclusive(tmp_path, monkeypatch):
    slept = []
    monkeypatch.setattr(profile.time, "sleep", slept.append)
    assert profile.capture(10_000, str(tmp_path))[1] == profile.MAX_SECONDS
    assert slept == [profile.MAX_SECONDS]
    assert profile._capture_lock.acquire(blocking=False)
    try:
        with pytest.raises(profile.ProfilerBusy):
            profile.capture(0.5)
    finally:
        profile._capture_lock.release()


@pytest.fixture
def api():
    store = InMemorySpanStore()
    col = Collector(store, concurrency=1, registry=obs.Registry())
    api = port_server.ApiServer(QueryService(store, coalesce_window_s=0.0),
                                col, registry=obs.Registry())
    yield api
    col.close()
    api.query.close()


def test_profile_endpoint_statuses(api, monkeypatch):
    status, body = api.handle("POST", "/debug/profile", {"seconds": "0.05"})
    assert status == 200, body
    assert body["seconds"] == 0.05 and os.path.isdir(body["profileDir"])
    assert _trace_events(body["profileDir"])
    shutil.rmtree(body["profileDir"])
    assert api.handle("POST", "/debug/profile",
                      {"seconds": "nope"})[0] == 400
    assert api.handle("GET", "/debug/profile", {})[0] == 404
    assert profile._capture_lock.acquire(blocking=False)
    try:
        status, body = api.handle("POST", "/debug/profile", {})
        assert status == 409 and "already running" in body["error"]
    finally:
        profile._capture_lock.release()

    def unavailable(*a, **kw):
        raise RuntimeError("no tracer here")

    monkeypatch.setattr(torch.profiler, "profile", unavailable)
    status, body = api.handle("POST", "/debug/profile", {"seconds": "0.01"})
    assert status == 503
    assert body == {"error": "profiler unavailable: no tracer here"}
    assert not profile._capture_lock.locked()


def test_request_latency_family_counts_routes(api):
    for path in ("/api/services", "/api/trace/ab", "/api/pin/1/true",
                 "/nope", "/vars/x"):
        api.handle("GET", path, {})
    d = api.registry.as_dict()
    for route in ("/api/services", "/api/trace/{id}", "/api/pin/{id}",
                  "other", "/vars/{name}"):
        assert d[f'zipkin_api_requests_total{{route="{route}"}}'] == 1.0
        assert d[f'zipkin_api_request_seconds_count{{route="{route}"}}'] \
            == 1.0
    assert math.isfinite(
        d['zipkin_api_request_seconds{route="/api/services",'
          'quantile="0.99"}'])
