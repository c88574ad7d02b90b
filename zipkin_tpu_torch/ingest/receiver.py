"""Span receivers: transport payloads → spans → the collector pipeline.

Reference: SpanReceiver (zipkin-collector/.../SpanReceiver.scala:27) and
the scribe receiver's decode/whitelist/pushback behavior
(ScribeSpanReceiver.scala:78-141). The kafka receiver's consumer loop is
a transport concern; its decode path is identical to scribe's minus the
base64 (KafkaProcessor.scala:25) and is covered by ``decode_thrift``.
"""

from __future__ import annotations

import enum
import json
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from zipkin_tpu_torch.ingest.queue import QueueFullException
from zipkin_tpu_torch.wal.log import WalDurabilityError
from zipkin_tpu_torch.models.span import (
    Annotation,
    AnnotationType,
    BinaryAnnotation,
    Endpoint,
    Span,
)
from zipkin_tpu_torch.wire.thrift import (
    ThriftError,
    scribe_message_to_span,
    spans_from_bytes,
)


class ResultCode(enum.Enum):
    """Scribe result codes (scribe.thrift): TRY_LATER = backpressure."""

    OK = 0
    TRY_LATER = 1


class ScribeReceiver:
    """Scribe Log() endpoint: base64-thrift LogEntries → spans → process.

    ``process`` is typically Collector.accept (→ ItemQueue.add); a
    QueueFullException surfaces as TRY_LATER so scribe clients buffer
    and retry (ScribeSpanReceiver.scala:133-141).
    """

    def __init__(
        self,
        process: Callable[[Sequence[Span]], None],
        categories: Iterable[str] = ("zipkin",),
        process_thrift: Optional[Callable[[bytes], None]] = None,
    ):
        self.process = process
        self.process_thrift = process_thrift
        self.categories = {c.lower() for c in categories}
        # Bumped from every API handler thread; unlocked += would lose
        # increments under concurrent Log() calls.
        self._stats_lock = threading.Lock()  # lock-order: 82 receiver-stats
        self.stats: Dict[str, int] = {
            "received": 0, "ignored": 0, "bad": 0, "pushed_back": 0,
        }

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def log(self, entries: Sequence[tuple]) -> ResultCode:
        """entries: (category, message) pairs — the Scribe.Log call.

        With ``process_thrift`` wired (Collector.accept_thrift), decoded
        payloads stay raw thrift bytes end-to-end and the columnar
        native parser runs on the collector worker — span objects are
        never built on the hot path (the scrooge-decode role,
        ScribeSpanReceiver.scala:96-107).
        """
        if self.process_thrift is not None:
            return self._log_fast(entries)
        spans: List[Span] = []
        for category, message in entries:
            self._bump("received")
            if category.lower() not in self.categories:
                self._bump("ignored")
                continue
            try:
                spans.append(scribe_message_to_span(message))
            except ThriftError:
                self._bump("bad")
        if not spans:
            return ResultCode.OK
        try:
            self.process(spans)
        except (QueueFullException, WalDurabilityError):
            # Queue full and not-yet-durable are the same answer on
            # the wire: don't ack, client retries (the ack-after-
            # durable-append contract, docs/DURABILITY.md).
            self._bump("pushed_back")
            return ResultCode.TRY_LATER
        except Exception:
            # The durable entries run the whole store write path on
            # this handler thread, so its exception surface (suspect
            # store, closing store) lands here; any of it maps to
            # TRY_LATER — a torn connection would read as a lost batch
            # to clients that only retry on the wire code.
            self._bump("pushed_back")
            return ResultCode.TRY_LATER
        return ResultCode.OK

    def _log_fast(self, entries: Sequence[tuple]) -> ResultCode:
        import base64
        import binascii

        raws: List[bytes] = []
        for category, message in entries:
            self._bump("received")
            if category.lower() not in self.categories:
                self._bump("ignored")
                continue
            try:
                if isinstance(message, str):
                    message = message.encode("ascii")
                raws.append(base64.b64decode(message, validate=False))
            except (binascii.Error, ValueError):
                self._bump("bad")
        if not raws:
            return ResultCode.OK
        try:
            # Segments keep entry boundaries so the collector can
            # isolate a thrift-corrupt entry instead of dropping the
            # whole batch.
            self.process_thrift(raws)
        except (QueueFullException, WalDurabilityError):
            # See log(): not-yet-durable == backpressure on the wire.
            self._bump("pushed_back")
            return ResultCode.TRY_LATER
        except Exception:
            # See log(): any store-path failure is TRY_LATER, never a
            # torn connection.
            self._bump("pushed_back")
            return ResultCode.TRY_LATER
        return ResultCode.OK


def decode_thrift(payload: bytes) -> List[Span]:
    """Raw thrift span sequence → spans (the kafka message decode path)."""
    return spans_from_bytes(payload)


class JsonReceiver:
    """JSON span receiver for HTTP-posted spans (the tracegen/web feed).

    Accepts a list of span dicts in the shape the web API emits; not a
    reference transport, but the natural REST ingest door for a modern
    deployment.
    """

    def __init__(self, process: Callable[[Sequence[Span]], None]):
        self.process = process

    def post(self, body: bytes) -> ResultCode:
        spans = [span_from_json(d) for d in json.loads(body)]
        try:
            self.process(spans)
        except QueueFullException:
            return ResultCode.TRY_LATER
        return ResultCode.OK


def _endpoint_from_json(d: Optional[dict]) -> Optional[Endpoint]:
    if not d:
        return None
    return Endpoint(
        ipv4=int(d.get("ipv4", 0)),
        port=int(d.get("port", 0)),
        service_name=d.get("serviceName", "unknown"),
    )


def span_from_json(d: dict) -> Span:
    anns = tuple(
        Annotation(
            timestamp=int(a["timestamp"]),
            value=a["value"],
            host=_endpoint_from_json(a.get("endpoint")),
        )
        for a in d.get("annotations", ())
    )
    banns = []
    for b in d.get("binaryAnnotations", ()):
        t = AnnotationType[b.get("type", "STRING")]
        value = b.get("value", "")
        if t == AnnotationType.BYTES and isinstance(value, str):
            import base64

            value = base64.b64decode(value)
        banns.append(
            BinaryAnnotation(
                key=b["key"], value=value, annotation_type=t,
                host=_endpoint_from_json(b.get("endpoint")),
            )
        )
    def _id(v):
        """Hex string (the wire form) or number → canonical SIGNED
        int64 — keeps span_to_json → span_from_json an exact round
        trip for ids with the top bit set."""
        u = int(v, 16) if isinstance(v, str) else int(v)
        return u - (1 << 64) if u >= (1 << 63) else u

    return Span(
        trace_id=_id(d["traceId"]),
        name=d.get("name", ""),
        id=_id(d["id"]),
        parent_id=(
            None if d.get("parentId") in (None, "")
            else _id(d["parentId"])
        ),
        annotations=anns,
        binary_annotations=tuple(banns),
        debug=bool(d.get("debug", False)),
    )


def _hex_id(v: int) -> str:
    return f"{v & (2**64 - 1):x}"


def endpoint_to_json(e: Optional[Endpoint]):
    if e is None:
        return None
    return {"ipv4": e.ipv4, "port": e.port, "serviceName": e.service_name}


def binary_annotation_to_json(b) -> dict:
    value = b.value
    if isinstance(value, (bytes, bytearray)):
        if b.annotation_type == AnnotationType.BYTES:
            import base64

            value = base64.b64encode(bytes(value)).decode("ascii")
        else:
            value = bytes(value).decode("utf-8", "replace")
    return {
        "key": b.key, "value": value,
        "type": b.annotation_type.name,
        "endpoint": endpoint_to_json(b.host),
    }


def span_to_json(s: Span) -> dict:
    ep = endpoint_to_json
    banns = [binary_annotation_to_json(b) for b in s.binary_annotations]
    # Ids serialize as unsigned hex STRINGS (upstream zipkin JSON
    # convention, and span_from_json's string interpretation): a JSON
    # number round-trips through JS float64, which silently rounds ids
    # above 2^53 — the UI would then fetch the wrong trace.
    return {
        "traceId": _hex_id(s.trace_id),
        "name": s.name,
        "id": _hex_id(s.id),
        "parentId": None if s.parent_id is None else _hex_id(s.parent_id),
        "annotations": [
            {"timestamp": a.timestamp, "value": a.value,
             "endpoint": ep(a.host)}
            for a in s.annotations
        ],
        "binaryAnnotations": banns,
        "debug": s.debug,
    }
