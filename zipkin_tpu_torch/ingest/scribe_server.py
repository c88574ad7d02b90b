"""Raw-TCP framed-thrift Scribe server — the real transport endpoint.

Implements the Scribe service's ``Log(messages: list<LogEntry>)`` RPC
(scribe.thrift:25-30: ``LogEntry {1: string category, 2: string
message}``, result ``ResultCode {OK=0, TRY_LATER=1}``) over
TFramedTransport + TBinaryProtocol — the wire format finagle's
ThriftMux-less thrift clients and original scribe emitters speak
(reference server: ScribeSpanReceiver.scala:69-78). Base64 payload
decode and span parsing happen in the ScribeReceiver/Collector behind
``receiver.log``.

Both strict (versioned) and old-style unversioned message headers are
accepted. Unknown methods get a TApplicationException so well-behaved
clients fail fast instead of hanging.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import List, Optional, Tuple

from zipkin_tpu_torch.ingest.receiver import ResultCode, ScribeReceiver
from zipkin_tpu_torch.wire.thrift import (
    T_I32,
    T_LIST,
    T_STOP,
    T_STRING,
    T_STRUCT,
    ThriftError,
    _Reader,
)

VERSION_1 = 0x80010000
MSG_CALL = 1
MSG_REPLY = 2
MSG_EXCEPTION = 3

MAX_FRAME = 64 << 20  # a 64MB frame bound keeps a bad client from OOMing us


def _read_message_header(r: _Reader) -> Tuple[str, int]:
    first = r.i32()
    if first < 0:
        if (first & 0xFFFF0000) != (VERSION_1 & 0xFFFF0000):
            raise ThriftError("bad thrift version")
        mtype = first & 0xFF
        if mtype != MSG_CALL:
            raise ThriftError(f"unexpected message type {mtype}")
        name = r.take(r.i32()).decode("utf-8", "replace")
        seqid = r.i32()
    else:
        # Old-style unversioned: name (we already consumed its length),
        # then a type byte and seqid.
        name = r.take(first).decode("utf-8", "replace")
        mtype = r.u8()
        if mtype != MSG_CALL:
            raise ThriftError(f"unexpected message type {mtype}")
        seqid = r.i32()
    return name, seqid


def _parse_log_args(r: _Reader) -> List[Tuple[str, str]]:
    """Scribe.Log args struct: {1: list<LogEntry>}."""
    entries: List[Tuple[str, str]] = []
    while True:
        ftype = r.u8()
        if ftype == T_STOP:
            break
        fid = r.i16()
        if fid == 1 and ftype == T_LIST:
            etype = r.u8()
            n = r.i32()
            if etype != T_STRUCT or n < 0:
                raise ThriftError("bad LogEntry list")
            for _ in range(n):
                category = message = ""
                while True:
                    et = r.u8()
                    if et == T_STOP:
                        break
                    eid = r.i16()
                    if eid == 1 and et == T_STRING:
                        category = r.string().decode("utf-8", "replace")
                    elif eid == 2 and et == T_STRING:
                        message = r.string().decode("utf-8", "replace")
                    else:
                        r.skip(et)
                entries.append((category, message))
        else:
            r.skip(ftype)
    return entries


def _reply(name: str, seqid: int, code: ResultCode) -> bytes:
    # Thrift string length is the UTF-8 byte count, not code points — a
    # non-ASCII method name (e.g. from a 'replace'-decoded bad frame)
    # must not desync the reply framing.
    nb = name.encode()
    body = [
        struct.pack(">I", (VERSION_1 | MSG_REPLY) & 0xFFFFFFFF),
        struct.pack(">i", len(nb)), nb,
        struct.pack(">i", seqid),
        # result struct: {0: i32 success}
        struct.pack(">bh", T_I32, 0), struct.pack(">i", code.value),
        b"\x00",
    ]
    return b"".join(body)


def _exception_reply(name: str, seqid: int, message: str) -> bytes:
    nb = name.encode()
    mb = message.encode()
    body = [
        struct.pack(">I", (VERSION_1 | MSG_EXCEPTION) & 0xFFFFFFFF),
        struct.pack(">i", len(nb)), nb,
        struct.pack(">i", seqid),
        # TApplicationException {1: string message, 2: i32 type}
        struct.pack(">bh", T_STRING, 1),
        struct.pack(">i", len(mb)), mb,
        struct.pack(">bh", T_I32, 2), struct.pack(">i", 1),  # UNKNOWN_METHOD
        b"\x00",
    ]
    return b"".join(body)


def handle_call(receiver: ScribeReceiver, frame: bytes) -> Optional[bytes]:
    """One framed thrift CALL → reply frame payload (None = drop conn)."""
    r = _Reader(frame)
    name, seqid = _read_message_header(r)
    if name != "Log":
        return _exception_reply(name, seqid, f"unknown method {name!r}")
    entries = _parse_log_args(r)
    code = receiver.log(entries)
    return _reply(name, seqid, code)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        sock: socket.socket = self.request
        sock.settimeout(self.server.io_timeout_s)  # type: ignore[attr-defined]
        receiver = self.server.receiver  # type: ignore[attr-defined]
        try:
            while True:
                header = self._read_exact(sock, 4)
                if header is None:
                    return
                (n,) = struct.unpack(">i", header)
                if n <= 0 or n > MAX_FRAME:
                    return
                frame = self._read_exact(sock, n)
                if frame is None:
                    return
                try:
                    out = handle_call(receiver, frame)
                except ThriftError:
                    return
                if out is None:
                    return
                sock.sendall(struct.pack(">i", len(out)) + out)
        except (socket.timeout, ConnectionError, OSError):
            return

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
        return read_exact(sock, n)


def read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes or None on disconnect/socket error —
    shared by every framed-TCP server here (scribe, the kafka fake)."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


class ScribeServer(socketserver.ThreadingTCPServer):
    """Threaded framed-thrift scribe endpoint bound to (host, port)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, receiver: ScribeReceiver, host: str = "0.0.0.0",
                 port: int = 9410, io_timeout_s: float = 60.0):
        super().__init__((host, port), _Handler)
        self.receiver = receiver
        self.io_timeout_s = io_timeout_s

    def serve_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


def encode_log_call(entries: List[Tuple[str, str]], seqid: int = 0) -> bytes:
    """Client-side Scribe.Log frame (for tests and the tracegen feeder)."""
    body = [
        struct.pack(">I", (VERSION_1 | MSG_CALL) & 0xFFFFFFFF),
        struct.pack(">i", 3), b"Log",
        struct.pack(">i", seqid),
        struct.pack(">bh", T_LIST, 1),
        struct.pack(">bi", T_STRUCT, len(entries)),
    ]
    for category, message in entries:
        c = category.encode()
        m = message.encode()
        body.append(struct.pack(">bh", T_STRING, 1))
        body.append(struct.pack(">i", len(c)) + c)
        body.append(struct.pack(">bh", T_STRING, 2))
        body.append(struct.pack(">i", len(m)) + m)
        body.append(b"\x00")
    body.append(b"\x00")
    payload = b"".join(body)
    return struct.pack(">i", len(payload)) + payload


def decode_log_reply(frame: bytes) -> ResultCode:
    """Client-side reply decode (tests / tracegen)."""
    r = _Reader(frame)
    first = r.i32()
    if first >= 0:
        r.take(first)
        mtype = r.u8()
        r.i32()
    else:
        mtype = first & 0xFF
        r.take(r.i32())
        r.i32()
    if mtype == MSG_EXCEPTION:
        raise ThriftError("server exception")
    code = ResultCode.OK
    while True:
        ftype = r.u8()
        if ftype == T_STOP:
            break
        fid = r.i16()
        if fid == 0 and ftype == T_I32:
            code = ResultCode(r.i32())
        else:
            r.skip(ftype)
    return code


class ScribeClient:
    """Minimal blocking scribe client (the CarelessScribe role in the
    ruby gem, zipkin-tracer.rb) — used by tracegen's smoke feed."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self.addr = (host, port)
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._seq = 0

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self.addr, self.timeout_s)
            self._sock.settimeout(self.timeout_s)
        return self._sock

    def log(self, entries: List[Tuple[str, str]]) -> ResultCode:
        self._seq += 1
        sock = self._connect()
        try:
            sock.sendall(encode_log_call(entries, self._seq))
            header = _Handler._read_exact(sock, 4)
            if header is None:
                raise ConnectionError("scribe server closed connection")
            (n,) = struct.unpack(">i", header)
            frame = _Handler._read_exact(sock, n)
            if frame is None:
                raise ConnectionError("scribe server closed connection")
            return decode_log_reply(frame)
        except (OSError, ConnectionError):
            self.close()
            raise

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
