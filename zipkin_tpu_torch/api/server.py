"""Threaded HTTP server exposing the query + ingest surface.

The port's copy of ``zipkin_tpu/api/server.py``: the same routes,
status codes and JSON. Plays zipkin-web's server role
(web/Main.scala:31-89) minus the mustache UI: JSON in/out, stdlib-only
(ThreadingHTTPServer), fronted by the QueryService and Collector. Trace
pinning adjusts TTL exactly like the reference
(Handlers.scala:461-490: pin=true → webPinTtl, pin=false → default
TTL).

The server never picks a device: it serves whatever store its
``QueryService`` and ``Collector`` wrap, and a store on the card stays
there (spans that come in through ``POST /scribe`` and ``POST
/api/spans`` reach its ingest step, trace reads its gathers). The fleet
routes are live when a ``FleetObs`` (``obs/fleet.py``) is passed as
``fleet``: ``/api/health`` answers the watchdog's readiness (503 while a
probe fails, with its reasons), ``/api/fleet`` the roles and merged
lineage sketches, ``/debug/events`` the flight recorder, and
``/metrics?fleet=1`` the federated scrape; with ``fleet=None`` each
answers as a single process. ``/api/replication`` answers ``{"role":
"none"}`` until replication is ported.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qsl, urlparse

from zipkin_tpu_torch import obs
from zipkin_tpu_torch.api.query_extractor import extract_query
from zipkin_tpu_torch.ingest.collector import Collector
from zipkin_tpu_torch.ingest.receiver import (
    JsonReceiver,
    ResultCode,
    ScribeReceiver,
    _hex_id,
    binary_annotation_to_json,
    span_to_json,
)
from zipkin_tpu_torch.query.request import QueryException
from zipkin_tpu_torch.query.service import QueryService
from zipkin_tpu_torch.store.base import StorageException

DEFAULT_PIN_TTL_S = 30 * 24 * 3600  # webPinTtl default 30 days
DEFAULT_TTL_S = 1.0


class RawResponse:
    """Non-JSON payload (the static UI) with its content type."""

    def __init__(self, content_type: str, body: bytes):
        self.content_type = content_type
        self.body = body


def _trace_json(trace):
    return [span_to_json(s) for s in trace.spans]


def _timeline_json(tl):
    return {
        "traceId": _hex_id(tl.trace_id),
        "rootSpanId": _hex_id(tl.root_span_id),
        "annotations": [
            {
                "timestamp": a.timestamp, "value": a.value,
                "spanId": _hex_id(a.span_id),
                "parentId": None if a.parent_id is None
                else _hex_id(a.parent_id),
                "serviceName": a.service_name, "spanName": a.span_name,
            }
            for a in tl.annotations
        ],
        "binaryAnnotations": [
            binary_annotation_to_json(b) for b in tl.binary_annotations
        ],
    }


def _summary_json(s):
    return {
        "traceId": _hex_id(s.trace_id),
        "startTimestamp": s.start_timestamp,
        "endTimestamp": s.end_timestamp,
        "durationMicro": s.duration_micro,
        "endpoints": [
            {"ipv4": e.ipv4, "port": e.port, "serviceName": e.service_name}
            for e in s.endpoints
        ],
    }


def _finite_or_none(v):
    """JSON-safe float: json.dumps serializes inf/nan as the bare
    tokens Infinity/NaN, which are NOT JSON — JSON.parse in every
    browser rejects them. The Dependencies monoid zero is
    (+inf, -inf) (Time.Top/Bottom, models/dependencies.py), so an
    empty store's /api/dependencies used to emit invalid JSON. No data
    serializes as null, the /api/quantiles convention."""
    return v if v == v and abs(v) != float("inf") else None


def _moments_json(m):
    return {
        "count": m.count,
        "mean": _finite_or_none(m.mean),
        "stddev": _finite_or_none(m.stddev),
        "m2": _finite_or_none(m.m2),
        "m3": _finite_or_none(m.m3),
        "m4": _finite_or_none(m.m4),
    }


class ApiServer:
    """Route table + handlers, decoupled from the HTTP plumbing so tests
    can drive it without sockets."""

    def __init__(self, query: QueryService, collector: Optional[Collector] = None,
                 pin_ttl_s: float = DEFAULT_PIN_TTL_S,
                 self_trace: bool = True,
                 self_service_name: str = "zipkin-tpu",
                 registry: Optional[obs.Registry] = None,
                 replication=None, fleet=None):
        self.query = query
        self.collector = collector
        self.pin_ttl_s = pin_ttl_s
        # /api/replication status provider: a zero-arg callable — the
        # primary's WalShipper.status or a follower's Follower.status
        # (docs/REPLICATION.md); None answers {"role": "none"}.
        self.replication = replication
        # Fleet observability hub (obs.fleet.FleetObs): serves
        # /api/health (watchdog readiness), /api/fleet (merged roll-up
        # status), /debug/events (flight recorder) and the federated
        # /metrics?fleet=1 view; None degrades each to its
        # single-process answer (docs/OBSERVABILITY.md).
        self.fleet = fleet
        self.registry = registry or obs.default_registry()
        # Query-stage latency sketch: p50/p99 per normalized route
        # (moments + log-histogram, see obs.LatencySketch).
        self.request_latency = self.registry.register(obs.LatencySketch(
            "zipkin_api_request_seconds",
            "API request handling latency per route",
            labelnames=("route",)))
        self.requests_total = self.registry.register(obs.Counter(
            "zipkin_api_requests_total", "API requests handled",
            labelnames=("route",)))
        self._c_self_drops = self.registry.register(obs.Counter(
            "zipkin_api_self_trace_drops_total",
            "API self-trace span batches dropped by a failed "
            "collector accept"))
        coal = getattr(query, "coalescer", None)
        if coal is not None:
            for attr, help_ in (
                ("batches", "Coalesced query batches executed"),
                ("queries", "Trace-id queries served through the "
                            "coalescer"),
                ("launches_saved", "Device dispatches removed by "
                                   "cross-request coalescing"),
                ("max_batch", "Largest coalesced batch so far"),
            ):
                self.registry.register(obs.Gauge(
                    f"zipkin_query_coalesce_{attr}", help_,
                    fn=(lambda a=attr: getattr(coal, a))))
        disp = getattr(query.store, "dispatcher", None)
        if disp is not None:
            for attr, help_ in (
                ("batches", "Cross-shard dispatcher batches executed"),
                ("requests", "Sharded reads served through the "
                             "dispatcher"),
                ("launches_saved", "Collective launches removed by "
                                   "cross-shard batching"),
                ("max_batch", "Largest dispatcher batch so far"),
            ):
                self.registry.register(obs.Gauge(
                    f"zipkin_shard_dispatch_{attr}", help_,
                    fn=(lambda a=attr: getattr(disp, a))))
        counters = getattr(query.store, "counters", None)
        if callable(counters):
            self.registry.register(obs.CallbackFamily(
                "zipkin_store_counter",
                "Store counters (device counter block + host guards)",
                "name", counters))
        # Self-tracing (SURVEY §5): the query service records a server
        # span per API request into its own collector, continuing any
        # incoming B3 trace — the finagle-zipkin role the reference
        # wires everywhere (ThriftQueryService.scala:139-144,
        # QueryService.scala:216-222).
        self.tracer = None
        if collector is not None and self_trace:
            from zipkin_tpu_torch.client import Tracer

            self.tracer = Tracer(self_service_name, self._self_transport)
        # Scribe rides the columnar fast path (raw thrift bytes →
        # native parse on a collector worker); the collector falls back
        # to the python codec when the native library is unavailable.
        self.scribe = (
            ScribeReceiver(collector.accept,
                           process_thrift=collector.accept_thrift)
            if collector is not None else None
        )
        self.json_ingest = (
            JsonReceiver(collector.accept) if collector is not None else None
        )
        if self.scribe is not None:
            scribe = self.scribe
            self.registry.register(obs.CallbackFamily(
                "zipkin_scribe_entries",
                "Scribe receiver entry accounting "
                "(received/ignored/bad/pushed_back)",
                "result", lambda: dict(scribe.stats)))
        # Runtime-adjustable vars (HttpVar.scala:30 / the old
        # /config/sampleRate endpoint): name → (getter, setter).
        self.vars = {}
        if collector is not None:
            self.vars["sampleRate"] = (
                lambda: collector.sampler.rate,
                lambda v: setattr(collector.sampler, "rate", float(v)),
            )
        # The resident executor's micro-batch window, adjustable at
        # runtime (ms — matches the daemon's --query-window-ms flag):
        # GET /vars/queryWindowMs, POST /vars/queryWindowMs <number>.
        if coal is not None and hasattr(coal, "window_s"):
            self.vars["queryWindowMs"] = (
                lambda: coal.window_s * 1000.0,
                lambda v: setattr(coal, "window_s", float(v) / 1000.0),
            )
        # Windowed-arena geometry echo (the daemon's --window-seconds /
        # --window-buckets): READ-ONLY — the grid is static device
        # state; changing it means a new store.
        def _static(_v):
            raise QueryException(
                "static store state (window geometry / span-plane "
                "layout shape device arrays; restart with the "
                "matching flag to change them)")

        backing = getattr(query.store, "hot", query.store)
        store_cfg = getattr(backing, "config", None)
        if store_cfg is not None and hasattr(store_cfg,
                                             "window_seconds"):
            self.vars["windowSeconds"] = (
                lambda: store_cfg.window_seconds, _static)
            self.vars["windowBuckets"] = (
                lambda: store_cfg.window_buckets, _static)
        # Span-plane layout echo (the daemon's --layout/--page-rows):
        # READ-ONLY like the window geometry — the layout shapes the
        # device planes and the page planner; changing it means a new
        # store (rebuild via checkpoint restore, docs/MIGRATION.md).
        if store_cfg is not None and hasattr(store_cfg, "layout"):
            self.vars["layout"] = (lambda: store_cfg.layout, _static)
            self.vars["pageRows"] = (
                lambda: store_cfg.page_rows, _static)
        elif hasattr(backing, "window_seconds"):
            # Scan backends (memory store): bucket width only — the
            # exact scan has no ring, so no windowBuckets to echo.
            self.vars["windowSeconds"] = (
                lambda: backing.window_seconds, _static)

    # -- dispatch -------------------------------------------------------

    def _self_transport(self, spans) -> None:
        try:
            self.collector.accept(spans)
        except Exception:
            # Counted, never raised: self-tracing must not fail the
            # request it annotates (graftlint swallowed-exception).
            self._c_self_drops.inc()

    def _should_self_trace(self, method: str, path: str) -> bool:
        if self.tracer is None or not path.startswith("/api/"):
            return False
        # Don't trace the ingest doors — a span per accepted span batch
        # would feed back into the stream it measures.
        return not (method == "POST" and path in ("/api/spans",
                                                  "/api/v1/spans"))

    def handle(self, method: str, path: str, params: dict,
               body: bytes = b"", headers: Optional[dict] = None,
               response_headers: Optional[list] = None
               ) -> Tuple[int, object]:
        t0 = time.perf_counter()
        try:
            return self._handle_traced(method, path, params, body,
                                       headers, response_headers)
        finally:
            route = _route_label(path)
            self.requests_total.labels(route=route).inc()
            self.request_latency.labels(route=route).observe(
                time.perf_counter() - t0)

    def _handle_traced(self, method: str, path: str, params: dict,
                       body: bytes = b"",
                       headers: Optional[dict] = None,
                       response_headers: Optional[list] = None
                       ) -> Tuple[int, object]:
        if not self._should_self_trace(method, path):
            return self._dispatch(method, path, params, body)
        import time as _time

        from zipkin_tpu_torch.client import B3Headers

        b3 = B3Headers.parse(headers or {})
        # Resolve ids up front so the response can echo X-B3-TraceId
        # (the devtools extension's signal, web/extension/) with
        # exactly the ids the recorded span carries — the one contract
        # site is Tracer.resolve (unsampled requests echo only
        # X-B3-Sampled: 0, never a dead trace link). child=True: an
        # inbound B3 context is JOINED as a proper child span (fresh
        # id, parent = the caller's span id) instead of the legacy
        # shared-span reuse, so external probes and the web UI see the
        # API's server span as a distinct hop in their own trace.
        resolved = self.tracer.resolve(b3, child=True)
        if response_headers is not None:
            response_headers.extend(resolved.emit().items())
        start_us = int(_time.time() * 1e6)
        status = 500
        token = None
        if resolved.trace_id is not None:
            # Publish this request's (trace, span) to the thread/task
            # context so downstream shared work — the cross-shard
            # dispatcher's fused launches — can parent spans under it.
            from zipkin_tpu_torch.obs import fleet as _fleet

            token = _fleet.set_request_context(resolved.trace_id,
                                               resolved.span_id)
        try:
            status, payload = self._dispatch(method, path, params, body)
            return status, payload
        finally:
            if token is not None:
                _fleet.reset_request_context(token)
            self.tracer.server_span(
                f"{method.lower()} {path}", resolved,
                start_us=start_us, end_us=int(_time.time() * 1e6),
                tags={"http.uri": path, "http.method": method,
                      "http.status": str(status)},
            )

    def _dispatch(self, method: str, path: str, params: dict,
                  body: bytes) -> Tuple[int, object]:
        try:
            return self._route(method, path, params, body)
        except QueryException as e:
            return 400, {"error": str(e)}
        except KeyError as e:
            return 404, {"error": f"not found: {e}"}
        except (ValueError, json.JSONDecodeError) as e:
            return 400, {"error": str(e)}
        except StorageException as e:
            # A write reaching a read replica (store/replica.py), or a
            # suspect/closing store: the request is routable elsewhere.
            return 503, {"error": str(e)}

    def _route(self, method, path, params, body):
        if path in ("/", "/index.html", "/traces", "/aggregate"):
            # The SPA serves every page route (web/Main.scala:77-89's
            # /, /traces/:id, /aggregate mustache pages collapse into
            # one client-rendered file).
            from zipkin_tpu_torch import web

            return 200, RawResponse("text/html; charset=utf-8",
                                    web.index_html())
        if path == "/health":
            return 200, {"status": "ok"}
        if path == "/api/health":
            # Watchdog-backed liveness/readiness with reasons
            # (docs/OBSERVABILITY.md runbook). Without a fleet hub the
            # process is trivially ready — /health's contract with a
            # structured body.
            if self.fleet is None:
                return 200, {"live": True, "ready": True, "reasons": []}
            h = self.fleet.health()
            return (200 if h.get("ready") else 503), h
        if path == "/api/fleet":
            if self.fleet is None:
                return 200, {"role": "none"}
            return 200, self.fleet.status()
        if path == "/debug/events":
            limit = params.get("limit")
            events = ([] if self.fleet is None
                      else self.fleet.events(int(limit) if limit
                                             else None))
            return 200, {"events": events}
        if path == "/metrics":
            # Prometheus text exposition by default; the legacy JSON
            # dict stays at ?format=json (docs/MIGRATION.md).
            if params.get("format") == "json":
                return 200, self._metrics()
            if params.get("fleet") and self.fleet is not None:
                # Federated scrape: this process's registry plus every
                # pushed follower/shard snapshot, label-distinguished
                # (obs.fleet.render_federated — no double counting).
                return 200, RawResponse(
                    "text/plain; version=0.0.4; charset=utf-8",
                    self.fleet.federated_text().encode("utf-8"),
                )
            return 200, RawResponse(
                "text/plain; version=0.0.4; charset=utf-8",
                self.registry.render_text().encode("utf-8"),
            )
        if method == "POST" and path == "/debug/profile":
            return self._profile(params)
        if path == "/api/query":
            return self._query(params)
        if path == "/api/services":
            return 200, sorted(self.query.get_service_names())
        if path == "/api/spans" and method == "GET":
            return 200, sorted(self.query.get_span_names(
                _require(params, "serviceName")))
        if path == "/api/top_annotations":
            return 200, self.query.get_top_annotations(
                _require(params, "serviceName"))
        if path == "/api/top_kv_annotations":
            return 200, self.query.get_top_key_value_annotations(
                _require(params, "serviceName"))
        if path == "/api/quantiles":
            qs = [float(x) for x in
                  params.get("q", "0.5,0.95,0.99").split(",")]
            vals = self.query.get_service_duration_quantiles(
                _require(params, "serviceName"), qs)
            # An empty histogram yields NaNs, which json.dumps would
            # emit as BARE NaN — invalid JSON that breaks JSON.parse
            # in the browser. No data serializes as null.
            if vals is not None:
                vals = [round(v, 1) for v in vals]
                if any(v != v for v in vals):
                    vals = None
            return 200, {"quantiles": qs, "durationsMicro": vals}
        if path == "/api/windowed_quantiles":
            return self._windowed_quantiles(params)
        if path == "/api/slo_burn":
            return self._slo_burn(params)
        if path == "/api/latency_heatmap":
            return self._latency_heatmap(params)
        if path == "/api/span_durations":
            return self._span_durations(params)
        if path == "/api/service_names_to_trace_ids":
            return self._service_names_to_trace_ids(params)
        if path == "/api/data_ttl":
            return 200, {
                "dataTimeToLive": self.query.get_data_time_to_live()
            }
        if path == "/api/replication":
            if self.replication is None:
                return 200, {"role": "none"}
            return 200, self.replication()
        if path == "/api/dependencies" or re.match(r"^/api/dependencies/", path):
            return self._dependencies(path, params)
        if path == "/api/traces_exist":
            return self._traces_exist(params)
        # Trace ids in paths are unsigned hex (upstream zipkin URL
        # convention; span_to_json emits the same form). A leading "-"
        # keeps accepting legacy signed-decimal callers unambiguously.
        m = re.match(r"^/api/(?:trace|get)/(-?[0-9a-fA-F]+)$", path)
        if m:
            return self._trace(_parse_trace_id(m.group(1)), params)
        # Thrift query-surface parity beyond the web routes:
        # getTraceTimelinesByIds / getTraceCombosByIds
        # (zipkinQuery.thrift:109-251).
        m = re.match(r"^/api/timeline/(-?[0-9a-fA-F]+)$", path)
        if m:
            return self._timeline(_parse_trace_id(m.group(1)), params)
        m = re.match(r"^/api/combo/(-?[0-9a-fA-F]+)$", path)
        if m:
            return self._combo(_parse_trace_id(m.group(1)), params)
        m = re.match(r"^/api/is_pinned/(-?[0-9a-fA-F]+)$", path)
        if m:
            return self._is_pinned(_parse_trace_id(m.group(1)))
        m = re.match(r"^/api/pin/(-?[0-9a-fA-F]+)/(true|false)$", path)
        if m and method == "POST":
            return self._pin(_parse_trace_id(m.group(1)),
                             m.group(2) == "true")
        if method == "POST" and path in ("/api/spans", "/api/v1/spans"):
            return self._ingest_json(body)
        if method == "POST" and path == "/scribe":
            return self._ingest_scribe(body)
        m = re.match(r"^/vars/(\w+)$", path)
        if m:
            return self._var(m.group(1), method, body)
        raise KeyError(path)

    def _var(self, name: str, method: str, body: bytes):
        getter_setter = self.vars.get(name)
        if getter_setter is None:
            raise KeyError(name)
        getter, setter = getter_setter
        if method == "POST":
            setter(json.loads(body or b"null"))
        return 200, {name: getter()}

    # -- handlers -------------------------------------------------------

    def _query(self, params):
        qr = extract_query(params)
        if qr is None:
            return 400, {"error": "serviceName is required"}
        resp = self.query.get_trace_ids(qr)
        summaries = self.query.get_trace_summaries_by_ids(resp.trace_ids)
        return 200, {
            "traceIds": [_hex_id(t) for t in resp.trace_ids],
            "startTs": resp.start_ts,
            "endTs": resp.end_ts,
            "summaries": [_summary_json(s) for s in summaries],
        }

    def _trace(self, trace_id: int, params):
        adjust = params.get("adjust_clock_skew", "true") != "false"
        traces = self.query.get_traces_by_ids([trace_id], adjust=adjust)
        if not traces:
            raise KeyError(trace_id)
        return 200, _trace_json(traces[0])

    def _timeline(self, trace_id: int, params):
        adjust = params.get("adjust_clock_skew", "true") != "false"
        tls = self.query.get_trace_timelines_by_ids([trace_id],
                                                    adjust=adjust)
        if not tls:
            raise KeyError(trace_id)
        return 200, _timeline_json(tls[0])

    def _combo(self, trace_id: int, params):
        adjust = params.get("adjust_clock_skew", "true") != "false"
        combos = self.query.get_trace_combos_by_ids([trace_id],
                                                    adjust=adjust)
        if not combos or not combos[0].trace.spans:
            raise KeyError(trace_id)
        c = combos[0]
        return 200, {
            "trace": _trace_json(c.trace),
            "summary": None if c.summary is None
            else _summary_json(c.summary),
            "timeline": None if c.timeline is None
            else _timeline_json(c.timeline),
            "spanDepths": None if c.span_depths is None else {
                _hex_id(k): v for k, v in c.span_depths.items()
            },
        }

    def _dependencies(self, path, params):
        """Optionally windowed: /api/dependencies/<startTs>/<endTs> or
        ?startTime=&endTime= (µs) — Aggregates.getDependencies(start,
        end), web route parity with /api/dependencies (Main.scala:85)."""
        m = re.match(r"^/api/dependencies/(-?\d+)(?:/(-?\d+))?$", path)
        start_ts = end_ts = None
        if m:
            start_ts = int(m.group(1))
            end_ts = int(m.group(2)) if m.group(2) else None
        for key, val in (("startTime", "start"), ("endTime", "end"),
                         ("startTs", "start"), ("endTs", "end")):
            raw = params.get(key)
            if raw is not None:
                if val == "start":
                    start_ts = int(raw)
                else:
                    end_ts = int(raw)
        deps = self.query.get_dependencies(start_ts, end_ts)
        return 200, {
            "startTime": _finite_or_none(deps.start_time),
            "endTime": _finite_or_none(deps.end_time),
            "links": [
                {
                    "parent": l.parent,
                    "child": l.child,
                    "durationMoments": _moments_json(l.duration_moments),
                }
                for l in deps.links
            ],
        }

    @staticmethod
    def _slice_params(params):
        """(timeStamp, serviceName, spanName) for the thrift slice
        methods: timeStamp defaults to 'everything so far' and spanName
        'all' means no rpc-name restriction (the query-extractor
        convention)."""
        ts_raw = params.get("timeStamp") or params.get("endTs")
        time_stamp = int(ts_raw) if ts_raw else (1 << 62)
        span_name = params.get("spanName")
        if span_name == "all":
            span_name = None
        return time_stamp, params.get("serviceName"), span_name

    @staticmethod
    def _opt_int(params, *keys):
        for k in keys:
            raw = params.get(k)
            if raw is not None and raw != "":
                return int(raw)
        return None

    def _windowed_quantiles(self, params):
        """Windowed latency quantiles off the (service × time-bucket)
        Moments-sketch cells (docs/OBSERVABILITY.md): any [startTs,
        endTs) µs window answers as a cell-sum + one Moments solve —
        no segment scan, no device dispatch. null durations = no
        duration-carrying span in the window (or no arena)."""
        qs = [float(x) for x in
              params.get("q", "0.5,0.95,0.99").split(",")]
        vals = self.query.get_windowed_quantiles(
            _require(params, "serviceName"), qs,
            start_us=self._opt_int(params, "startTs", "startTime"),
            end_us=self._opt_int(params, "endTs", "endTime"))
        if vals is not None:
            vals = [round(v, 1) for v in vals]
            if any(v != v for v in vals):
                vals = None
        return 200, {"quantiles": qs, "durationsMicro": vals}

    def _slo_burn(self, params):
        """Multi-window error-budget burn rate: per lookback window
        (seconds, comma list), error rate over the windowed cells'
        error/total counts divided by the budget (1 - objective)."""
        windows = params.get("windows")
        windows_s = ([int(x) for x in windows.split(",") if x]
                     if windows else None)
        objective = params.get("objective")
        out = self.query.get_slo_burn(
            _require(params, "serviceName"),
            objective=float(objective) if objective else None,
            windows_s=windows_s,
            now_us=self._opt_int(params, "nowTs"))
        if out is None:
            return 200, {"windows": None}
        return 200, out

    def _latency_heatmap(self, params):
        """Service × time × duration-band grid from the windowed
        cells: one column per live time bucket, log-spaced duration
        bands, per-cell mass from the Moments solve."""
        bands = params.get("bands")
        out = self.query.get_latency_heatmap(
            _require(params, "serviceName"),
            start_us=self._opt_int(params, "startTs", "startTime"),
            end_us=self._opt_int(params, "endTs", "endTime"),
            bands=int(bands) if bands else None)
        if out is None:
            return 200, {"cells": None}
        return 200, out

    def _span_durations(self, params):
        """getSpanDurations (zipkinQuery.thrift) over HTTP: durations
        (µs) of spans named spanName, grouped by owning service."""
        time_stamp, service, span_name = self._slice_params(params)
        if not service:
            raise QueryException("serviceName is required")
        if not span_name:
            # Distinguish absent from the explicit "all" wildcard —
            # getSpanDurations has no all-spans form, so the wildcard
            # gets an accurate rejection, not "required".
            if params.get("spanName") == "all":
                raise QueryException(
                    "spanName must name a specific span "
                    "(getSpanDurations has no 'all' form)")
            raise QueryException("spanName is required")
        return 200, {
            "durations": self.query.get_span_durations(
                time_stamp, service, span_name)
        }

    def _service_names_to_trace_ids(self, params):
        """getServiceNamesToTraceIds (zipkinQuery.thrift) over HTTP:
        participating service name -> unsigned-hex trace ids."""
        time_stamp, service, span_name = self._slice_params(params)
        if not service:
            raise QueryException("serviceName is required")
        mapping = self.query.get_service_names_to_trace_ids(
            time_stamp, service, span_name)
        return 200, {
            "serviceNames": {
                svc: [_hex_id(t) for t in tids]
                for svc, tids in sorted(mapping.items())
            }
        }

    def _traces_exist(self, params):
        """tracesExist (zipkinQuery.thrift:154): which of the queried
        ids have ANY stored span — the cheap batched membership probe
        the thrift surface offers before a full trace fetch. Ids are
        comma-separated unsigned hex (the /api/trace/<id> URL
        convention; legacy signed decimal accepted). The TPU store
        answers through the trace-membership gid buckets when their
        exactness gate holds, the O(ring) scan otherwise."""
        raw = _require(params, "traceIds")
        tids = [_parse_trace_id(t.strip())
                for t in raw.split(",") if t.strip()]
        exist = self.query.traces_exist(tids)
        return 200, {"exist": sorted(_hex_id(t) for t in exist)}

    def _is_pinned(self, trace_id: int):
        try:
            ttl = self.query.get_trace_time_to_live(trace_id)
        except KeyError:
            raise
        return 200, {"pinned": ttl >= self.pin_ttl_s}

    def _pin(self, trace_id: int, state: bool):
        self.query.set_trace_time_to_live(
            trace_id, self.pin_ttl_s if state else DEFAULT_TTL_S
        )
        return 200, {"pinned": state}

    def _ingest_json(self, body: bytes):
        if self.json_ingest is None:
            return 501, {"error": "no collector attached"}
        code = self.json_ingest.post(body)
        if code is ResultCode.TRY_LATER:
            return 503, {"error": "try later"}
        return 202, {"accepted": True}

    def _ingest_scribe(self, body: bytes):
        if self.scribe is None:
            return 501, {"error": "no collector attached"}
        entries = [
            (e["category"], e["message"]) for e in json.loads(body)
        ]
        code = self.scribe.log(entries)
        return 200, {"result": code.name}

    def _profile(self, params):
        """POST /debug/profile?seconds=N — capture a torch.profiler
        trace for N seconds (this request's thread blocks for the
        window; ThreadingHTTPServer keeps serving others). Returns the
        trace directory, viewable with Perfetto."""
        from zipkin_tpu_torch.obs import profile as obs_profile

        try:
            seconds = float(params.get("seconds", "1.0"))
        except ValueError:
            return 400, {"error": "seconds must be a number"}
        try:
            out_dir, effective = obs_profile.capture(seconds)
        except obs_profile.ProfilerBusy as e:
            return 409, {"error": str(e)}
        except Exception as e:  # backend can't trace → service-level 503
            return 503, {"error": f"profiler unavailable: {e}"}
        return 200, {"profileDir": out_dir, "seconds": effective}

    def _metrics(self):
        out = {}
        if self.collector is not None:
            out.update({
                "collector.queue_size": self.collector.queue.size,
                "collector.active_workers": self.collector.queue.active_workers,
                "collector.processed": self.collector.queue.processed,
                "collector.errors": self.collector.queue.errors,
                "collector.spans_stored": self.collector.spans_stored,
                "collector.spans_dropped": self.collector.spans_dropped,
                "sampler.rate": self.collector.sampler.rate,
            })
        counters = getattr(self.query.store, "counters", None)
        if callable(counters):
            out.update({f"store.{k}": v for k, v in counters().items()})
        coal = getattr(self.query, "coalescer", None)
        if coal is not None:
            # The read-path dispatch-floor observable: how many device
            # launches cross-request micro-batching removed.
            out.update({
                "query.coalesce_batches": coal.batches,
                "query.coalesce_queries": coal.queries,
                "query.coalesce_launches_saved": coal.launches_saved,
                "query.coalesce_max_batch": coal.max_batch,
            })
        disp = getattr(self.query.store, "dispatcher", None)
        if disp is not None:
            # Store-level twin of the coalescer block: collective
            # launches the cross-shard dispatcher fused away
            # (docs/SHARDING.md).
            out.update({
                "shard.dispatch_batches": disp.batches,
                "shard.dispatch_requests": disp.requests,
                "shard.dispatch_launches_saved": disp.launches_saved,
                "shard.dispatch_max_batch": disp.max_batch,
            })
        eng = getattr(self.query, "engine", None)
        if eng is not None:
            # Resident-engine tier accounting (docs/QUERY_ENGINE.md).
            out.update({
                "query.cache_hits": eng.c_hits.value,
                "query.cache_misses": eng.c_misses.value,
                "query.cache_entries": len(eng.cache),
                "query.sketch_answers": eng.c_sketch.value,
            })
        return out


# Dynamic path segments collapse to {id} so the per-route latency
# family stays bounded-cardinality; anything unrecognized buckets into
# "other" (a hostile scanner must not mint one series per probe).
_ROUTE_ID_RE = re.compile(
    r"^(/api/(?:trace|get|timeline|combo|is_pinned))/[^/]+$")
_ROUTE_PIN_RE = re.compile(r"^/api/pin/[^/]+/(?:true|false)$")
_KNOWN_ROUTES = frozenset((
    "/", "/index.html", "/traces", "/aggregate", "/health", "/metrics",
    "/debug/profile", "/api/query", "/api/services", "/api/spans",
    "/api/v1/spans", "/api/top_annotations", "/api/top_kv_annotations",
    "/api/quantiles", "/api/dependencies", "/api/traces_exist",
    "/api/span_durations", "/api/service_names_to_trace_ids",
    "/api/data_ttl", "/api/windowed_quantiles", "/api/slo_burn",
    "/api/latency_heatmap", "/api/replication", "/api/health",
    "/api/fleet", "/debug/events", "/scribe",
))


def _route_label(path: str) -> str:
    m = _ROUTE_ID_RE.match(path)
    if m:
        return m.group(1) + "/{id}"
    if _ROUTE_PIN_RE.match(path):
        return "/api/pin/{id}"
    if path in _KNOWN_ROUTES:
        return path
    if path.startswith("/api/dependencies/"):
        return "/api/dependencies/{window}"
    if path.startswith("/vars/"):
        return "/vars/{name}"
    return "other"


def _parse_trace_id(raw: str) -> int:
    """Unsigned hex (the wire form) or signed decimal (legacy),
    canonicalized to signed int64 — span_from_json does the same, and
    stores that compare ids exactly (the in-memory reference) must see
    the id the span was stored under, not its unsigned twin."""
    if raw.startswith("-"):
        return int(raw)
    u = int(raw, 16)
    return u - (1 << 64) if u >= (1 << 63) else u


def _require(params, key):
    v = params.get(key)
    if not v:
        raise QueryException(f"{key} is required")
    return v


def make_server(api: ApiServer, host: str = "0.0.0.0", port: int = 9411
                ) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _respond(self):
            parsed = urlparse(self.path)
            params = dict(parse_qsl(parsed.query))
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            extra_headers: list = []
            status, payload = api.handle(
                self.command, parsed.path, params, body,
                headers=dict(self.headers),
                response_headers=extra_headers,
            )
            if isinstance(payload, RawResponse):
                ctype, data = payload.content_type, payload.body
            else:
                ctype = "application/json"
                data = json.dumps(payload).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for name, value in extra_headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(data)

        do_GET = _respond
        do_POST = _respond

        def log_message(self, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t
