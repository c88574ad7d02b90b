"""Client-side instrumentation + query client (the zipkin-gems role),
the port's copy of ``zipkin_tpu/client.py``.

Reference: the Ruby ``ZipkinTracer::RackHandler``
(zipkin-gems/zipkin-tracer/lib/zipkin-tracer.rb:7-45) — B3 header
propagation, per-request server spans, percentage sampling, scribe
transport — re-expressed for python:

- ``B3Headers``: parse/emit X-B3-TraceId / X-B3-SpanId /
  X-B3-ParentSpanId / X-B3-Sampled
- ``Tracer``: span lifecycle + transport (any callable taking spans —
  a Collector.accept, an HTTP poster, or a scribe sender)
- ``ZipkinWSGIMiddleware``: wraps a WSGI app, continuing or starting a
  trace per request with sr/ss annotations
- ``QueryClient``: typed access to the HTTP query API
  (the zipkin-query gem role)
"""

from __future__ import annotations

import json
import random
import time
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from zipkin_tpu_torch.models.constants import SERVER_RECV, SERVER_SEND
from zipkin_tpu_torch.models.span import (Annotation, BinaryAnnotation,
                                          Endpoint, Span)

TRACE_ID_HEADER = "X-B3-TraceId"
SPAN_ID_HEADER = "X-B3-SpanId"
PARENT_ID_HEADER = "X-B3-ParentSpanId"
SAMPLED_HEADER = "X-B3-Sampled"


def _new_id(rng: random.Random) -> int:
    return rng.getrandbits(63) + 1


@dataclass(frozen=True)
class B3Headers:
    trace_id: Optional[int] = None
    span_id: Optional[int] = None
    parent_id: Optional[int] = None
    sampled: Optional[bool] = None

    @staticmethod
    def parse(headers: Dict[str, str]) -> "B3Headers":
        # HTTP header names are case-insensitive (and WSGI's HTTP_*
        # environ keys arrive fully uppercased), so match on a
        # lowercased view of the mapping.
        lowered = {k.lower(): v for k, v in headers.items()}

        def hex_of(name):
            v = lowered.get(name.lower())
            if v is None:
                return None
            try:
                return int(v, 16)
            except ValueError:
                return None

        sampled_raw = lowered.get(SAMPLED_HEADER.lower())
        sampled = None
        if sampled_raw:
            sampled = sampled_raw in ("1", "true", "True")
        return B3Headers(
            trace_id=hex_of(TRACE_ID_HEADER),
            span_id=hex_of(SPAN_ID_HEADER),
            parent_id=hex_of(PARENT_ID_HEADER),
            sampled=sampled,
        )

    def emit(self) -> Dict[str, str]:
        out = {}
        if self.trace_id is not None:
            out[TRACE_ID_HEADER] = f"{self.trace_id & (2**64 - 1):x}"
        if self.span_id is not None:
            out[SPAN_ID_HEADER] = f"{self.span_id & (2**64 - 1):x}"
        if self.parent_id is not None:
            out[PARENT_ID_HEADER] = f"{self.parent_id & (2**64 - 1):x}"
        if self.sampled is not None:
            out[SAMPLED_HEADER] = "1" if self.sampled else "0"
        return out


class Tracer:
    """Creates spans and ships them through a transport callable."""

    def __init__(
        self,
        service_name: str,
        transport: Callable[[Sequence[Span]], None],
        sample_rate: float = 1.0,
        ipv4: int = 0x7F000001,
        port: int = 0,
        rng: Optional[random.Random] = None,
    ):
        self.endpoint = Endpoint(ipv4, port, service_name)
        self.transport = transport
        self.sample_rate = sample_rate
        self.rng = rng or random.Random()

    def should_sample(self, b3: B3Headers) -> bool:
        if b3.sampled is not None:
            return b3.sampled
        return self.rng.random() < self.sample_rate

    def resolve(self, b3: B3Headers, child: bool = False) -> B3Headers:
        """Pin the ids and sampling decision for one server request —
        THE single place the echo/record contract lives: the resolved
        headers are what the response echoes (so the devtools
        extension links real traces) and exactly what server_span
        records. Unsampled requests resolve with ids=None: nothing
        will be recorded, so echoing a trace id would hand out dead
        links — only X-B3-Sampled: 0 is emitted for them.

        ``child=False`` (the default) is the classic shared-span
        model: an inbound span id is REUSED, so the server span and
        the caller's client span are the same id (finagle-era B3).
        ``child=True`` joins the caller's trace as a proper CHILD:
        a fresh span id parented under the inbound span id — what
        the fleet self-tracing uses so an external probe's request
        and the API's own server span stay distinct spans in one
        trace. Without inbound ids the two modes are identical (a
        fresh root either way)."""
        sampled = self.should_sample(b3)
        if not sampled:
            return B3Headers(sampled=False)
        if child and b3.span_id is not None:
            return B3Headers(
                trace_id=(b3.trace_id if b3.trace_id is not None
                          else _new_id(self.rng)),
                span_id=_new_id(self.rng),
                parent_id=b3.span_id,
                sampled=True,
            )
        return B3Headers(
            trace_id=(b3.trace_id if b3.trace_id is not None
                      else _new_id(self.rng)),
            span_id=(b3.span_id if b3.span_id is not None
                     else _new_id(self.rng)),
            parent_id=b3.parent_id,
            sampled=True,
        )

    def server_span(
        self, name: str, b3: B3Headers,
        start_us: Optional[int] = None, end_us: Optional[int] = None,
        tags: Optional[Dict[str, str]] = None,
    ) -> Optional[Span]:
        """Record one server-side span (sr/ss) for a handled request."""
        if not self.should_sample(b3):
            return None
        trace_id = b3.trace_id if b3.trace_id is not None else _new_id(self.rng)
        span_id = b3.span_id if b3.span_id is not None else _new_id(self.rng)
        start_us = start_us or int(time.time() * 1e6)
        end_us = end_us or int(time.time() * 1e6)
        banns = tuple(
            BinaryAnnotation(k, v, host=self.endpoint)
            for k, v in (tags or {}).items()
        )
        span = Span(
            trace_id=trace_id, name=name, id=span_id, parent_id=b3.parent_id,
            annotations=(
                Annotation(start_us, SERVER_RECV, self.endpoint),
                Annotation(end_us, SERVER_SEND, self.endpoint),
            ),
            binary_annotations=banns,
        )
        self.transport([span])
        return span


class ZipkinWSGIMiddleware:
    """WSGI middleware: a server span per request (RackHandler role)."""

    def __init__(self, app, tracer: Tracer):
        self.app = app
        self.tracer = tracer

    def __call__(self, environ, start_response):
        headers = {
            k[5:].replace("_", "-"): v
            for k, v in environ.items() if k.startswith("HTTP_")
        }
        b3 = B3Headers.parse(headers)
        # Resolve ids and the sampling decision UP FRONT so the
        # response can echo X-B3-TraceId/-SpanId — the signal the
        # browser-extension role watches to link the current page's
        # trace into the UI (reference: zipkin-browser-extension's
        # request observer; ours reads these echoed headers in a
        # devtools panel, zipkin_tpu_torch/web/extension/). The recorded
        # span reuses exactly the echoed ids; unsampled requests echo
        # only X-B3-Sampled: 0 (see Tracer.resolve).
        resolved = self.tracer.resolve(b3)
        start_us = int(time.time() * 1e6)
        path = environ.get("PATH_INFO", "/")
        method = environ.get("REQUEST_METHOD", "GET")
        status_holder: List[str] = []

        def capture_start_response(status, resp_headers, exc_info=None):
            status_holder.append(status)
            # Filter any pre-existing X-B3-* response headers (case-
            # insensitively) before appending ours: a nested tracing
            # middleware (or the wrapped app itself) may already have
            # emitted them, and a response carrying two conflicting
            # X-B3-TraceId values makes the devtools panel link
            # whichever it reads first (ADVICE r5). The OUTERMOST
            # middleware resolved the request's ids — its echo wins.
            resp_headers = [
                (k, v) for k, v in resp_headers
                if not k.lower().startswith("x-b3-")
            ] + list(resolved.emit().items())
            return start_response(status, resp_headers, exc_info)

        try:
            return self.app(environ, capture_start_response)
        finally:
            self.tracer.server_span(
                f"{method.lower()} {path}",
                resolved,
                start_us=start_us,
                end_us=int(time.time() * 1e6),
                tags={
                    "http.uri": path,
                    "http.method": method,
                    "http.status": (status_holder[0].split()[0]
                                    if status_holder else "?"),
                },
            )


def http_transport(base_url: str) -> Callable[[Sequence[Span]], None]:
    """Transport posting JSON spans to a collector's /api/spans door."""
    from zipkin_tpu_torch.ingest.receiver import span_to_json

    def send(spans: Sequence[Span]) -> None:
        body = json.dumps([span_to_json(s) for s in spans]).encode()
        req = urllib.request.Request(
            base_url.rstrip("/") + "/api/spans", data=body, method="POST",
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=10).read()

    return send


class QueryClient:
    """Typed client for the HTTP query API (zipkin-query gem role)."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str):
        with urllib.request.urlopen(
            self.base_url + path, timeout=self.timeout
        ) as r:
            return json.loads(r.read())

    def services(self) -> List[str]:
        return self._get("/api/services")

    def span_names(self, service: str) -> List[str]:
        return self._get(f"/api/spans?serviceName={service}")

    def query(self, service: str, **params) -> dict:
        qs = "&".join(
            [f"serviceName={service}"]
            + [f"{k}={v}" for k, v in params.items()]
        )
        return self._get(f"/api/query?{qs}")

    def trace(self, trace_id) -> List[dict]:
        """``trace_id`` as int (formatted as unsigned hex, the URL
        convention) or an already-hex string from a query response."""
        if isinstance(trace_id, int):
            trace_id = f"{trace_id & (2**64 - 1):x}"
        return self._get(f"/api/trace/{trace_id}")

    def dependencies(self) -> dict:
        return self._get("/api/dependencies")

    def traces_exist(self, trace_ids) -> List[str]:
        """tracesExist over the HTTP surface: returns the unsigned-hex
        ids (the query-response form) that have any stored span."""
        ids = ",".join(
            f"{t & (2**64 - 1):x}" if isinstance(t, int) else str(t)
            for t in trace_ids
        )
        return self._get(f"/api/traces_exist?traceIds={ids}")["exist"]

    def span_durations(self, service: str, span_name: str,
                       time_stamp: Optional[int] = None) -> Dict:
        """getSpanDurations: {service name: [duration µs, ...]} for
        spans named ``span_name`` in traces the index matches."""
        qs = f"serviceName={service}&spanName={span_name}"
        if time_stamp is not None:
            qs += f"&timeStamp={time_stamp}"
        return self._get(f"/api/span_durations?{qs}")["durations"]

    def service_names_to_trace_ids(self, service: str,
                                   span_name: Optional[str] = None,
                                   time_stamp: Optional[int] = None
                                   ) -> Dict:
        """getServiceNamesToTraceIds: {participating service:
        [unsigned-hex trace ids]}."""
        qs = f"serviceName={service}"
        if span_name is not None:
            qs += f"&spanName={span_name}"
        if time_stamp is not None:
            qs += f"&timeStamp={time_stamp}"
        return self._get(
            f"/api/service_names_to_trace_ids?{qs}")["serviceNames"]

    def data_ttl(self) -> int:
        """getDataTimeToLive: the storage tier's retention (seconds)."""
        return self._get("/api/data_ttl")["dataTimeToLive"]
