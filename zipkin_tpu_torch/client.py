"""Client-side instrumentation (the zipkin-gems role), the port's copy
of ``zipkin_tpu/client.py`` without its HTTP half.

Reference: the Ruby ``ZipkinTracer::RackHandler``
(zipkin-gems/zipkin-tracer/lib/zipkin-tracer.rb:7-45) — B3 header
propagation, per-request server spans, percentage sampling, scribe
transport — re-expressed for python:

- ``B3Headers``: parse/emit X-B3-TraceId / X-B3-SpanId /
  X-B3-ParentSpanId / X-B3-Sampled
- ``Tracer``: span lifecycle + transport (any callable taking spans —
  a Collector.accept, an HTTP poster, or a scribe sender)

The WSGI middleware, the HTTP transport and the query client come with
the port's HTTP server.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

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
