"""Trace adjusters: clock-skew correction on assembled traces.

Reference semantics (TimeSkewAdjuster.scala:25-270, re-expressed):

An RPC span carries cs/cr stamped by the client's clock and sr/ss by the
server's. If the clocks disagree, children appear to start before their
parents. Using the one-way-latency symmetry assumption:

    latency = ((cr - cs) - (ss - sr)) / 2
    skew    = sr - latency - cs

every annotation stamped by the skewed endpoint is shifted by -skew, and
the correction propagates down the span tree (children were stamped by
the same skewed clock on their client side).

Rules preserved from the reference:
- no adjustment when the server interval exceeds the client's, or when
  the core annotations are already well-ordered (cs < sr and ss < cr);
- client-only spans (cs/cr but no sr/ss) with children get synthetic
  sr/ss at the cs/cr timestamps (warning recorded) and the skew for
  client-core children is computed manually against those;
- cs/cr annotations on the loopback address count as the skewed host.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

from zipkin_tpu_torch.models.constants import (
    CLIENT_RECV,
    CLIENT_SEND,
    SERVER_RECV,
    SERVER_SEND,
)
from zipkin_tpu_torch.models.span import Annotation, Endpoint, Span
from zipkin_tpu_torch.models.trace import Trace

LOCALHOST_LOOPBACK_IP = 0x7F000001

WARN_ADDED_SERVER_RECV = "TIME_SKEW_ADD_SERVER_RECV"
WARN_ADDED_SERVER_SEND = "TIME_SKEW_ADD_SERVER_SEND"


@dataclass(frozen=True)
class ClockSkew:
    endpoint: Endpoint
    skew: int


class TimeSkewAdjuster:
    """adjust(trace) → trace with per-endpoint clock skew corrected."""

    def __init__(self):
        self.warnings: List[str] = []

    def adjust(self, trace: Trace) -> Trace:
        root = trace.get_root_span()
        if root is None:
            return trace
        tree = trace.get_span_tree(root)
        adjusted = self._adjust_tree(tree, None)
        return Trace(_flatten(adjusted))

    # -- tree walk ------------------------------------------------------

    def _adjust_tree(self, node, inherited: Optional[ClockSkew]):
        span, children = node.span, list(node.children)
        if inherited is not None:
            span = _shift(span, inherited)
        span, children = self._synthesize_server_half(span, children)
        own = _clock_skew(span)
        if own is not None:
            span = _shift(span, own)
        return _Node(span, [self._adjust_tree(c, own) for c in children])

    def _synthesize_server_half(self, span: Span, children):
        """Client-only span with children → synthetic sr/ss + manual
        child skew propagation (validateSpan semantics)."""
        ann = span.annotations_as_map()
        client_only = (
            CLIENT_SEND in ann and CLIENT_RECV in ann
            and not (SERVER_SEND in ann and SERVER_RECV in ann)
        )
        if not (span.is_valid() and children and client_only):
            return span, children
        endpoint = None
        for a in children[0].span.client_side_annotations:
            endpoint = a.host
            break
        sr_ts = ann[CLIENT_SEND].timestamp
        ss_ts = ann[CLIENT_RECV].timestamp
        span = replace(
            span,
            annotations=span.annotations + (
                Annotation(sr_ts, SERVER_RECV, endpoint),
                Annotation(ss_ts, SERVER_SEND, endpoint),
            ),
        )
        self.warnings += [WARN_ADDED_SERVER_RECV, WARN_ADDED_SERVER_SEND]
        out = []
        for c in children:
            cann = c.span.annotations_as_map()
            if CLIENT_SEND in cann and CLIENT_RECV in cann and endpoint is not None:
                skew = _compute_skew(
                    sr_ts, ss_ts,
                    cann[CLIENT_SEND].timestamp, cann[CLIENT_RECV].timestamp,
                    endpoint,
                )
                if skew is not None:
                    out.append(_Node(_shift(c.span, skew), list(c.children)))
                    continue
            out.append(c)
        return span, out


class _Node:
    __slots__ = ("span", "children")

    def __init__(self, span, children):
        self.span = span
        self.children = children


def _flatten(node) -> List[Span]:
    out = [node.span]
    for c in node.children:
        out.extend(_flatten(c))
    return out


def _clock_skew(span: Span) -> Optional[ClockSkew]:
    ann = span.annotations_as_map()
    if not all(k in ann for k in (CLIENT_SEND, CLIENT_RECV, SERVER_RECV,
                                  SERVER_SEND)):
        return None
    endpoint = None
    for key in (SERVER_RECV, SERVER_SEND):
        if ann[key].host is not None:
            endpoint = ann[key].host
            break
    if endpoint is None:
        return None
    return _compute_skew(
        ann[CLIENT_SEND].timestamp, ann[CLIENT_RECV].timestamp,
        ann[SERVER_RECV].timestamp, ann[SERVER_SEND].timestamp,
        endpoint,
    )


def _compute_skew(
    client_send: int, client_recv: int, server_recv: int, server_send: int,
    endpoint: Endpoint,
) -> Optional[ClockSkew]:
    client_duration = client_recv - client_send
    server_duration = server_send - server_recv
    cs_ahead = client_send < server_recv
    cr_ahead = client_recv > server_send
    if server_duration > client_duration or (cs_ahead and cr_ahead):
        return None
    latency = (client_duration - server_duration) // 2
    skew = server_recv - latency - client_send
    return ClockSkew(endpoint, skew) if skew != 0 else None


def _shift(span: Span, skew: ClockSkew) -> Span:
    """Shift annotations stamped by the skewed endpoint by -skew."""
    if skew.skew == 0:
        return span
    out = []
    for a in span.annotations:
        ep = a.host
        if ep is not None and (
            ep.ipv4 == skew.endpoint.ipv4
            or (a.value in (CLIENT_SEND, CLIENT_RECV)
                and ep.ipv4 == LOCALHOST_LOOPBACK_IP)
        ):
            out.append(replace(a, timestamp=a.timestamp - skew.skew))
        else:
            out.append(a)
    return replace(span, annotations=tuple(out))
