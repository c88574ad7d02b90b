"""Kafka-style streaming receiver + producer sink (client-agnostic).

Reference: zipkin-receiver-kafka (KafkaProcessor.scala:25,
KafkaStreamProcessor.scala:8) — N consumer streams, each decoding thrift
span payloads and pushing into the collector with retry-on-pushback —
and zipkin-kafka's producer sink (collector/Kafka.scala: a
``Service[Span, Unit]`` publishing thrift-encoded spans to a topic).

No kafka client library ships in this environment, so the transport is
injected: a *consumer* here is any iterable of ``bytes`` messages (a
real kafka consumer's message-value iterator fits directly), and a
*producer* is any ``send(topic, bytes)`` callable (kafka-python's
``KafkaProducer.send`` fits directly). The decode/encode and pushback
semantics are this module's.

INTEGRATION CONTRACT (what a real client must provide / may assume):

Consumer side (``KafkaSpanReceiver``):
- Each element of ``streams`` is an iterable yielding message VALUES as
  ``bytes``. One worker thread drains each stream; run one consumer
  INSTANCE per stream, all in one consumer group — Kafka's group
  protocol then balances partitions across the workers exactly like the
  reference's N KafkaStreams (KafkaProcessor.scala:25).
- Message payload: one or more back-to-back TBinaryProtocol Span
  structs (the scribe/zipkin wire form). A partial/garbage payload
  raises inside the decoder and is COUNTED (``stats['bad']``), never
  fatal — consumers may deliver duplicates or corruption freely.
- Delivery: at-least-once. On collector pushback (QueueFullException)
  the message retries with backoff up to ``max_retries`` before being
  counted dropped; a client that wants zero drops should disable
  auto-commit and commit offsets AFTER ``process`` returns — the
  receiver itself never commits (it has no client handle).
- Rebalance: safe by construction — the receiver keeps no per-partition
  state; a replayed message is just a duplicate span, which the store
  tolerates (same-id spans merge downstream).

Producer side (``KafkaSpanSink``):
- ``producer(topic, value)`` may be sync (returns anything) or async
  (returns a future exposing ``add_callback``/``add_errback`` —
  kafka-python's FutureRecordMetadata shape). Broker errors surface via
  the errback and are counted, never raised into the write pipeline
  (the reference sink's swallow-and-count stance).
- ``close()`` calls ``producer.flush()`` when present; callers that
  need delivery confirmation before shutdown must close the sink.

``connect_kafka_python`` below wires all of this to kafka-python when
that library is importable (the function degrades to a clear error
otherwise; it imports lazily). This is the port's copy of
``zipkin_tpu/ingest/kafka.py``; tests/test_torch_ingest.py holds its
sink -> receiver loop against the reference's.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Iterable, List, Optional, Sequence

from zipkin_tpu_torch.ingest.queue import QueueFullException
from zipkin_tpu_torch.models.span import Span
from zipkin_tpu_torch.wire.thrift import ThriftError, spans_from_bytes

# Wire-path compression framing: an optional ONE-BYTE negotiation
# prefix on each message value. 0x01 = the rest is a raw-deflate
# (zlib) stream of concatenated thrift Span structs; 0x00 = the rest
# is those structs uncompressed (framed but not worth compressing).
# Any other first byte is a LEGACY unframed payload: a TBinaryProtocol
# Span struct always starts with a field-type byte >= 0x02 (trace_id
# i64 => 0x0a), so the two framed markers can never collide with real
# spans — old producers and new consumers interoperate byte-for-byte.
FRAME_DEFLATE = 0x01
FRAME_RAW = 0x00
# Tiny payloads inflate under deflate (header + dictionary overhead);
# below this the sink ships the framed-raw form instead.
COMPRESS_MIN_BYTES = 128


def encode_frame(payload: bytes, compress: bool,
                 min_bytes: int = COMPRESS_MIN_BYTES) -> bytes:
    if not compress:
        return payload  # legacy unframed (backward compatible)
    if len(payload) < min_bytes:
        return bytes([FRAME_RAW]) + payload
    return bytes([FRAME_DEFLATE]) + zlib.compress(payload, 6)


def decode_frame(message: bytes) -> bytes:
    """Unframe a message value; raises ThriftError on a corrupt
    deflate stream (counted like any bad payload, never fatal)."""
    if not message:
        return message
    marker = message[0]
    if marker == FRAME_DEFLATE:
        try:
            return zlib.decompress(message[1:])
        except zlib.error as e:
            raise ThriftError(f"bad deflate frame: {e}") from e
    if marker == FRAME_RAW:
        return message[1:]
    return message  # legacy unframed


class KafkaSpanReceiver:
    """Drains message streams into the collector.

    ``streams``: one iterable of raw message bytes per worker thread
    (the reference's consumer streams). On QueueFullException the
    message is retried with backoff — kafka's at-least-once stance —
    rather than dropped.
    """

    def __init__(
        self,
        process: Callable[[Sequence[Span]], None],
        streams: Sequence[Iterable[bytes]],
        retry_backoff_s: float = 0.05,
        max_retries: int = 100,
        process_thrift: Optional[Callable[[bytes], None]] = None,
    ):
        self.process = process
        self.process_thrift = process_thrift
        self.streams = streams
        self.retry_backoff_s = retry_backoff_s
        self.max_retries = max_retries
        self.stats = {"messages": 0, "bad": 0, "retries": 0, "dropped": 0}
        self._threads: List[threading.Thread] = []

    def _drain(self, stream: Iterable[bytes]) -> None:
        for message in stream:
            self.stats["messages"] += 1
            if not message:
                continue
            try:
                # Negotiation byte first: framed-deflate payloads
                # decompress here, framed-raw strip the marker, and
                # legacy unframed bytes pass through untouched.
                message = decode_frame(message)
            except ThriftError:
                self.stats["bad"] += 1
                continue
            if not message:
                continue
            if self.process_thrift is not None:
                # Fast path: raw bytes straight to the collector; the
                # columnar parse happens on its worker (malformed
                # payloads count there as bad_payloads).
                self._offer(self.process_thrift, message)
                continue
            try:
                spans = spans_from_bytes(message)
            except ThriftError:
                self.stats["bad"] += 1
                continue
            if not spans:
                continue
            self._offer(self.process, spans)

    def _offer(self, fn, item) -> None:
        for attempt in range(self.max_retries + 1):
            try:
                fn(item)
                break
            except QueueFullException:
                if attempt == self.max_retries:
                    self.stats["dropped"] += 1
                    break
                self.stats["retries"] += 1
                time.sleep(self.retry_backoff_s)

    def run(self) -> None:
        """Drain every stream to exhaustion on worker threads and join
        (a real deployment's streams never exhaust)."""
        self._threads = [
            threading.Thread(target=self._drain, args=(s,), daemon=True)
            for s in self.streams
        ]
        for t in self._threads:
            t.start()
        for t in self._threads:
            t.join()


class KafkaSpanSink:
    """Producer side: publish spans to a kafka topic as thrift bytes —
    the zipkin-kafka role (collector/Kafka.scala's Service[Span, Unit]
    with its SpanEncoder), so a collector can fan spans out to a topic
    (e.g. for an offline aggregation consumer) alongside storage.

    ``producer``: any ``send(topic: str, value: bytes)`` callable —
    kafka-python's ``KafkaProducer.send`` fits directly; tests inject a
    list-appender. Usable as a FanoutWriteSpanStore member: ``apply``
    publishes, ``set_time_to_live`` is a no-op (a topic has no per-trace
    retention; parity with the reference sink, which only writes).
    """

    def __init__(self, producer: Callable[[str, bytes], object],
                 topic: str = "zipkin",
                 batch: bool = False,
                 compress: bool = False,
                 compress_min_bytes: int = COMPRESS_MIN_BYTES):
        from zipkin_tpu_torch.wire.thrift import span_to_bytes

        self._encode = span_to_bytes
        self.producer = producer
        self.topic = topic
        self.batch = batch
        # ``compress`` turns on the negotiation-byte framing (see
        # encode_frame): deflate for payloads past compress_min_bytes,
        # framed-raw below it. Off by default — unframed output stays
        # byte-identical for legacy consumers.
        self.compress = compress
        self.compress_min_bytes = compress_min_bytes
        self.stats = {"published": 0, "errors": 0,
                      "bytes_raw": 0, "bytes_wire": 0}
        # Async producers report delivery on their returned future from
        # an IO thread; counters need the lock either way.
        self._stats_lock = threading.Lock()  # lock-order: 82 kafka-stats

    def _count(self, key: str, n: int) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def apply(self, spans: Sequence[Span]) -> None:
        if self.batch:
            # One message per batch (concatenated Span structs — the
            # form KafkaSpanReceiver/spans_from_bytes decodes).
            payload = b"".join(self._encode(s) for s in spans)
            self._send(payload, len(spans))
            return
        for s in spans:
            self._send(self._encode(s), 1)

    def _send(self, payload: bytes, n: int) -> None:
        wire = encode_frame(payload, self.compress,
                            self.compress_min_bytes)
        self._count("bytes_raw", len(payload))
        self._count("bytes_wire", len(wire))
        try:
            result = self.producer(self.topic, wire)
        except Exception:
            # The reference sink swallows-and-counts producer errors
            # rather than failing the write pipeline.
            self._count("errors", n)
            return
        # Async producers (kafka-python) surface broker errors on the
        # returned future, not synchronously — hook its callbacks so a
        # down broker counts as errors instead of phantom publishes.
        errback = getattr(result, "add_errback", None)
        callback = getattr(result, "add_callback", None)
        if callable(errback) and callable(callback):
            callback(lambda *_: self._count("published", n))
            errback(lambda *_: self._count("errors", n))
        else:
            self._count("published", n)

    def set_time_to_live(self, trace_id: int, ttl_seconds: float) -> None:
        pass

    def close(self) -> None:
        flush = getattr(self.producer, "flush", None)
        if callable(flush):
            flush()


def record_value_stream(consumer) -> Iterable[bytes]:
    """Adapt a kafka-python style consumer (iterating records that carry
    ``.value`` bytes) into the raw-bytes stream KafkaSpanReceiver
    drains. Also accepts already-raw byte iterables unchanged."""
    for rec in consumer:
        yield rec.value if hasattr(rec, "value") else rec


def connect_kafka_python(
    process: Callable[[Sequence[Span]], None],
    bootstrap_servers,
    topic: str = "zipkin",
    group_id: str = "zipkin-tpu",
    n_streams: int = 1,
    process_thrift: Optional[Callable[[bytes], None]] = None,
    **consumer_kwargs,
) -> "KafkaSpanReceiver":
    """Build a KafkaSpanReceiver over REAL kafka-python consumers: one
    consumer instance per worker stream, all in ``group_id`` so the
    broker balances partitions across them (the N-streams topology of
    KafkaProcessor.scala:25). The kafka-python library is not baked
    into this environment; when absent this raises a RuntimeError that
    restates the integration contract instead of failing obscurely.

    The constructed clients are exposed on the returned receiver as
    ``receiver.consumers`` — for the zero-drop variant described in the
    module contract, pass ``enable_auto_commit=False`` through
    ``consumer_kwargs`` and call ``commit()`` on them from your
    ``process`` callable; call ``close()`` on them at shutdown."""
    try:
        from kafka import KafkaConsumer  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "kafka-python is not installed. KafkaSpanReceiver only needs "
            "iterables of message-value bytes — adapt any client via "
            "record_value_stream(consumer); see the module docstring's "
            "integration contract."
        ) from e
    consumers = []
    try:
        for _ in range(n_streams):
            consumers.append(KafkaConsumer(
                topic, bootstrap_servers=bootstrap_servers,
                group_id=group_id, **consumer_kwargs,
            ))
    except Exception:
        # Don't leak sockets / phantom group members when a later
        # consumer fails to construct.
        for c in consumers:
            try:
                c.close()
            except Exception:  # graftlint: disable=swallowed-exception
                pass  # best-effort cleanup; the original error re-raises
        raise
    receiver = KafkaSpanReceiver(
        process=process,
        streams=[record_value_stream(c) for c in consumers],
        process_thrift=process_thrift,
    )
    # Expose the client handles: manual offset commits (the zero-drop
    # recipe above) and clean shutdown both need them.
    receiver.consumers = consumers
    return receiver
