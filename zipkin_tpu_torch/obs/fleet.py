"""Fleet observability, torch side: the request context only.

The port's copy of the request-context part of
``zipkin_tpu/obs/fleet.py``. The API server publishes the (trace id,
span id) of the request it serves around each traced handler, so that
shared work downstream can parent its spans under it. Lineage tracing,
metrics federation, the watchdog and the flight recorder are not
ported yet (ROADMAP Queue 1, item 2); until then the server answers
``/api/health``, ``/api/fleet``, ``/debug/events`` and
``/metrics?fleet=1`` as a process without a fleet hub.
"""

from __future__ import annotations

import contextvars
from typing import Optional, Tuple

# (trace_id, span_id) of the request currently being served on this
# task — set by the API server around traced handlers so downstream
# machinery can parent its spans.
_REQUEST_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "zipkin_tpu_fleet_b3", default=None)


def set_request_context(trace_id: int, span_id: int):
    """Bind the active request's B3 context; returns the reset token."""
    return _REQUEST_CTX.set((int(trace_id), int(span_id)))


def reset_request_context(token) -> None:
    _REQUEST_CTX.reset(token)


def current_request_context() -> Optional[Tuple[int, int]]:
    return _REQUEST_CTX.get()
