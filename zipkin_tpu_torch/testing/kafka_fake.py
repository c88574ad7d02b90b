"""In-process Kafka broker FAKE speaking the real v0 wire protocol.

The simulate-don't-mock pattern the reference uses for exactly this
situation — an external datastore its tests can't assume — is an
in-process protocol server, not a mock (its Cassandra tests boot a
thrift-speaking FakeCassandra rather than stubbing the client:
zipkin-cassandra/src/test/scala/com/twitter/cassie/tests/util/
FakeCassandra.scala:33-61).
This module is the Kafka equivalent for the receiver/sink pair
(reference roles: KafkaProcessor.scala:25, collector/Kafka.scala): a
TCP broker implementing Metadata (api 3), Produce (api 0) and Fetch
(api 1) at protocol version 0 over real message sets (offset / size /
CRC32 / magic / attributes / key / value), with auto-created topics of
one partition each — enough surface for batching, redelivery, corrupt
payloads, and consumer-group-less offset management to be exercised
against bytes on a socket instead of injected callables.

Also here: a minimal real-protocol client pair (MinimalKafkaProducer /
MinimalKafkaConsumer). They speak the same v0 wire format — the fake
never special-cases them — so tests drive KafkaSpanSink and
KafkaSpanReceiver through actual sockets; they double as a usable
fallback transport where kafka-python is not installed.

This is the port's copy of ``zipkin_tpu/testing/kafka_fake.py``: the
same wire bytes and error codes (tests/test_torch_kafka_wire.py crosses
brokers and clients of the two packages). Every socket call has a
timeout, and ``close()`` also ends the connections its handlers still
serve (``daemon_threads`` alone leaves them served after
``shutdown()``). The consumer counts its fetch round trips and the
message-set bytes they brought (``stats``).
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

from zipkin_tpu_torch.ingest.scribe_server import read_exact as _read_exact

API_PRODUCE = 0
API_FETCH = 1
API_METADATA = 3

# Request frames larger than this are a protocol violation or an
# attack, not traffic (same stance as scribe_server.MAX_FRAME).
MAX_FRAME = 64 << 20
# A broker connection idle this long is dropped (a real broker's
# connections.max.idle.ms defaults to ten minutes).
IDLE_TIMEOUT_S = 600.0
# Client socket calls: connect, send, and the wait for a response.
CLIENT_TIMEOUT_S = 10.0

ERR_NONE = 0
ERR_UNKNOWN_TOPIC = 3
ERR_CORRUPT = 2  # CRC mismatch on a produced message


# -- wire primitives --------------------------------------------------------


def _i8(v):
    return struct.pack(">b", v)


def _i16(v):
    return struct.pack(">h", v)


def _i32(v):
    return struct.pack(">i", v)


def _i64(v):
    return struct.pack(">q", v)


def _string(s: Optional[str]) -> bytes:
    if s is None:
        return _i16(-1)
    b = s.encode()
    return _i16(len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return _i32(-1)
    return _i32(len(b)) + b


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("short kafka frame")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def i8(self):
        return struct.unpack(">b", self._take(1))[0]

    def i16(self):
        return struct.unpack(">h", self._take(2))[0]

    def i32(self):
        return struct.unpack(">i", self._take(4))[0]

    def i64(self):
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self._take(n).decode()

    def nbytes(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else self._take(n)


def encode_message(value: Optional[bytes], key: Optional[bytes] = None,
                   corrupt_crc: bool = False) -> bytes:
    """One v0 message (magic 0): crc covers magic..value.
    ``corrupt_crc`` writes a wrong checksum — for testing the broker's
    verification path."""
    body = _i8(0) + _i8(0) + _bytes(key) + _bytes(value)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    if corrupt_crc:
        crc ^= 0xDEADBEEF
    return struct.pack(">I", crc) + body


def encode_message_set(values: Iterable[bytes], base_offset: int = 0,
                       corrupt_crc: bool = False) -> bytes:
    out = []
    for i, v in enumerate(values):
        msg = encode_message(v, corrupt_crc=corrupt_crc)
        out.append(_i64(base_offset + i) + _i32(len(msg)) + msg)
    return b"".join(out)


def decode_message_set(
    buf: bytes, strict: bool = False
) -> List[Tuple[int, Optional[bytes], Optional[bytes]]]:
    """[(offset, key, value)] — verifies each message's CRC; raises
    ValueError on mismatch. A trailing partial message is skipped per
    protocol on the FETCH side (responses truncate at max_bytes); a
    PRODUCE set must be complete, so producers pass ``strict=True`` and
    a truncated set raises instead of silently shipping a prefix."""
    out = []
    pos = 0
    while pos < len(buf):
        truncated = pos + 12 > len(buf)
        if not truncated:
            offset, size = struct.unpack(">qi", buf[pos:pos + 12])
            truncated = size < 0 or pos + 12 + size > len(buf)
        if truncated:
            if strict:
                raise ValueError("truncated message set")
            break  # partial trailing message (fetch truncation)
        msg = buf[pos + 12:pos + 12 + size]
        crc = struct.unpack(">I", msg[:4])[0]
        if zlib.crc32(msg[4:]) & 0xFFFFFFFF != crc:
            raise ValueError(f"crc mismatch at offset {offset}")
        r = _Reader(msg[4:])
        r.i8()  # magic
        r.i8()  # attributes
        key = r.nbytes()
        out.append((offset, key, r.nbytes()))
        pos += 12 + size
    return out


# -- the broker -------------------------------------------------------------


class _PartitionLog:
    """One partition's in-memory log: a list of encoded messages, each
    re-stamped with its real offset at append time."""

    def __init__(self):
        self.values: List[bytes] = []  # raw message bytes (crc..value)
        self.lock = threading.Lock()  # lock-order: 89 fake-partition

    def append(self, msgs: List[bytes]) -> int:
        with self.lock:
            base = len(self.values)
            self.values.extend(msgs)
            return base

    def fetch(self, offset: int, max_bytes: int) -> Tuple[bytes, int]:
        with self.lock:
            hw = len(self.values)
            out, size = [], 0
            for off in range(max(0, offset), hw):
                msg = self.values[off]
                entry = _i64(off) + _i32(len(msg)) + msg
                if size + len(entry) > max_bytes and out:
                    break
                out.append(entry)
                size += len(entry)
                if size >= max_bytes:
                    break
            return b"".join(out), hw


class _BrokerHandler(socketserver.BaseRequestHandler):
    def setup(self) -> None:
        self.request.settimeout(IDLE_TIMEOUT_S)
        self.server.broker._track(self.request, True)

    def finish(self) -> None:
        self.server.broker._track(self.request, False)

    def handle(self) -> None:
        sock = self.request
        while True:
            head = _read_exact(sock, 4)
            if head is None:
                return
            (size,) = struct.unpack(">i", head)
            if size <= 0 or size > MAX_FRAME:
                return  # protocol violation: drop the connection
            frame = _read_exact(sock, size)
            if frame is None:
                return
            resp = self.server.broker._dispatch(frame)
            if resp is not None:
                sock.sendall(_i32(len(resp)) + resp)


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class FakeKafkaBroker:
    """Single-node, single-partition-per-topic broker. Topics
    auto-create on first produce/fetch/metadata mention (the dev-mode
    kafka default the reference's quickstart assumes)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.topics: Dict[str, _PartitionLog] = {}
        self._lock = threading.Lock()  # lock-order: 87 fake-broker
        self.stats = {"produce": 0, "fetch": 0, "metadata": 0,
                      "corrupt_rejected": 0}
        self._conns = set()  # guarded-by: _lock
        self._server = _Server((host, port), _BrokerHandler)
        self._server.broker = self
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --

    def start(self) -> "FakeKafkaBroker":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop serving and end every live connection (their handlers'
        reads fail and the handler threads return)."""
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=10)
        self._server.server_close()
        with self._lock:
            conns, self._conns = list(self._conns), set()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closed by its peer

    def _track(self, sock, live: bool) -> None:
        with self._lock:
            if live:
                self._conns.add(sock)
            else:
                self._conns.discard(sock)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def log(self, topic: str) -> _PartitionLog:
        with self._lock:
            if topic not in self.topics:
                self.topics[topic] = _PartitionLog()
            return self.topics[topic]

    # -- protocol --

    def _dispatch(self, frame: bytes) -> Optional[bytes]:
        r = _Reader(frame)
        api_key = r.i16()
        r.i16()  # api_version (v0 assumed)
        corr = r.i32()
        r.string()  # client_id
        if api_key == API_PRODUCE:
            acks, body = self._produce(r)
            return None if acks == 0 else _i32(corr) + body
        if api_key == API_FETCH:
            return _i32(corr) + self._fetch(r)
        if api_key == API_METADATA:
            return _i32(corr) + self._metadata(r)
        # Unknown api: drop the connection's request (close).
        return _i32(corr)

    def _produce(self, r: _Reader) -> Tuple[int, bytes]:
        self.stats["produce"] += 1
        acks = r.i16()
        r.i32()  # timeout
        out = []
        n_topics = r.i32()
        out.append(_i32(n_topics))
        for _ in range(n_topics):
            topic = r.string() or ""
            n_parts = r.i32()
            out.append(_string(topic) + _i32(n_parts))
            for _ in range(n_parts):
                partition = r.i32()
                mset = r.nbytes() or b""
                try:
                    # strict: a truncated produce set is a framing bug,
                    # not fetch truncation — reject it whole.
                    triples = decode_message_set(mset, strict=True)
                    # Re-encode key+value; offsets are assigned here.
                    msgs = [encode_message(v, key=k)
                            for _, k, v in triples]
                    base = self.log(topic).append(msgs)
                    err = ERR_NONE
                except ValueError:
                    self.stats["corrupt_rejected"] += 1
                    base, err = -1, ERR_CORRUPT
                out.append(_i32(partition) + _i16(err) + _i64(base))
        return acks, b"".join(out)

    def _fetch(self, r: _Reader) -> bytes:
        self.stats["fetch"] += 1
        r.i32()  # replica_id
        r.i32()  # max_wait_ms (the fake answers immediately)
        r.i32()  # min_bytes
        out = []
        n_topics = r.i32()
        out.append(_i32(n_topics))
        for _ in range(n_topics):
            topic = r.string() or ""
            n_parts = r.i32()
            out.append(_string(topic) + _i32(n_parts))
            for _ in range(n_parts):
                partition = r.i32()
                offset = r.i64()
                max_bytes = r.i32()
                mset, hw = self.log(topic).fetch(offset, max_bytes)
                out.append(_i32(partition) + _i16(ERR_NONE) + _i64(hw)
                           + _i32(len(mset)) + mset)
        return b"".join(out)

    def _metadata(self, r: _Reader) -> bytes:
        self.stats["metadata"] += 1
        n = r.i32()
        names = [r.string() or "" for _ in range(n)]
        with self._lock:
            if not names:
                names = sorted(self.topics)
        out = [_i32(1), _i32(0), _string(self.host), _i32(self.port)]
        out.append(_i32(len(names)))
        for name in names:
            self.log(name)  # auto-create
            out.append(_i16(ERR_NONE) + _string(name) + _i32(1)
                       + _i16(ERR_NONE) + _i32(0) + _i32(0)
                       + _i32(1) + _i32(0)      # replicas: [0]
                       + _i32(1) + _i32(0))     # isr: [0]
        return b"".join(out)


# -- minimal real-protocol clients ------------------------------------------


class _Conn:
    def __init__(self, host: str, port: int, client_id: str):
        self.sock = socket.create_connection((host, port),
                                             timeout=CLIENT_TIMEOUT_S)
        self.client_id = client_id
        self._corr = 0  # guarded-by: _lock
        self._lock = threading.Lock()  # lock-order: 88 fake-conn

    def request(self, api_key: int, body: bytes,
                expect_response: bool = True) -> Optional[_Reader]:
        with self._lock:
            self._corr += 1
            corr = self._corr
            frame = (_i16(api_key) + _i16(0) + _i32(corr)
                     + _string(self.client_id) + body)
            self.sock.sendall(_i32(len(frame)) + frame)
            if not expect_response:
                return None
            head = _read_exact(self.sock, 4)
            if head is None:
                raise ConnectionError("broker closed connection")
            (size,) = struct.unpack(">i", head)
            payload = _read_exact(self.sock, size)
            if payload is None:
                raise ConnectionError("short broker response")
            r = _Reader(payload)
            got = r.i32()
            if got != corr:
                raise ConnectionError(f"correlation {got} != {corr}")
            return r

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class MinimalKafkaProducer:
    """send(topic, value) over the v0 produce API, acks=1: the send
    raises on broker-reported errors (corrupt message set), matching
    the sync stance KafkaSpanSink's counters expect from a callable
    producer."""

    def __init__(self, host: str, port: int,
                 client_id: str = "zipkin-tpu-producer"):
        self._conn = _Conn(host, port, client_id)

    def __call__(self, topic: str, value: bytes) -> None:
        self.send(topic, value)

    def send(self, topic: str, value: bytes,
             corrupt_crc: bool = False) -> int:
        mset = encode_message_set([value], corrupt_crc=corrupt_crc)
        body = (_i16(1) + _i32(1000) + _i32(1) + _string(topic)
                + _i32(1) + _i32(0) + _bytes(mset))
        r = self._conn.request(API_PRODUCE, body)
        r.i32()  # topic count
        r.string()
        r.i32()  # partition count
        r.i32()  # partition
        err = r.i16()
        base = r.i64()
        if err != ERR_NONE:
            raise IOError(f"produce failed: kafka error {err}")
        return base

    def flush(self) -> None:
        pass  # acks=1 sends are synchronous

    def close(self) -> None:
        self._conn.close()


class MinimalKafkaConsumer:
    """Iterate one partition's values from ``offset`` via v0 fetch.
    No consumer group (the fake has no coordinator): offset management
    is the caller's, which is exactly the at-least-once redelivery
    model KafkaSpanReceiver documents — re-creating a consumer at an
    old offset redelivers."""

    def __init__(self, host: str, port: int, topic: str,
                 offset: int = 0, max_bytes: int = 1 << 20,
                 poll_forever: bool = False, poll_interval_s: float = 0.02,
                 client_id: str = "zipkin-tpu-consumer"):
        self._conn = _Conn(host, port, client_id)
        self.topic = topic
        self.offset = offset
        self.max_bytes = max_bytes
        self.poll_forever = poll_forever
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self.stats = {"fetches": 0, "bytes": 0}

    def stop(self) -> None:
        self._stop.set()

    def _fetch_once(
        self,
    ) -> List[Tuple[int, Optional[bytes], Optional[bytes]]]:
        body = (_i32(-1) + _i32(10) + _i32(0) + _i32(1)
                + _string(self.topic) + _i32(1) + _i32(0)
                + _i64(self.offset) + _i32(self.max_bytes))
        r = self._conn.request(API_FETCH, body)
        r.i32()  # topic count
        r.string()
        r.i32()  # partition count
        r.i32()  # partition
        err = r.i16()
        r.i64()  # high watermark
        mset = r.nbytes() or b""
        self.stats["fetches"] += 1
        self.stats["bytes"] += len(mset)
        if err != ERR_NONE:
            raise IOError(f"fetch failed: kafka error {err}")
        return decode_message_set(mset)

    def __iter__(self) -> Iterable[bytes]:
        while not self._stop.is_set():
            pairs = self._fetch_once()
            if not pairs:
                if not self.poll_forever:
                    return
                time.sleep(self.poll_interval_s)
                continue
            for off, _key, value in pairs:
                self.offset = off + 1
                yield value or b""

    def close(self) -> None:
        self._stop.set()
        self._conn.close()
