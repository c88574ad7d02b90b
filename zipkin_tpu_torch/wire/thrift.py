"""TBinaryProtocol codec for the zipkin Span wire struct.

Implements exactly the layout of zipkinCore.thrift (reference
zipkin-thrift/.../zipkinCore.thrift:27-57):

    Endpoint  { 1: i32 ipv4, 2: i16 port, 3: string service_name }
    Annotation{ 1: i64 timestamp, 2: string value,
                3: optional Endpoint host, 4: optional i32 duration }
    BinaryAnnotation { 1: string key, 2: binary value,
                       3: AnnotationType annotation_type,
                       4: optional Endpoint host }
    Span { 1: i64 trace_id, 3: string name, 4: i64 id,
           5: optional i64 parent_id, 6: list<Annotation> annotations,
           8: list<BinaryAnnotation> binary_annotations,
           9: optional bool debug }

Unknown fields are skipped (forward compat); the optional annotation
``duration`` field is accepted and ignored (the model derives durations
from timestamps). All integers big-endian, ids/timestamps signed 64-bit.
"""

from __future__ import annotations

import base64
import struct
from typing import List, Optional, Tuple

from zipkin_tpu_torch.models.span import (
    Annotation,
    AnnotationType,
    BinaryAnnotation,
    Endpoint,
    Span,
)

# TBinaryProtocol type codes.
T_STOP = 0
T_BOOL = 2
T_BYTE = 3
T_DOUBLE = 4
T_I16 = 6
T_I32 = 8
T_I64 = 10
T_STRING = 11
T_STRUCT = 12
T_MAP = 13
T_SET = 14
T_LIST = 15


class ThriftError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _w_field(out: List[bytes], ftype: int, fid: int) -> None:
    out.append(struct.pack(">bh", ftype, fid))


def _w_string(out: List[bytes], s) -> None:
    b = s.encode("utf-8") if isinstance(s, str) else bytes(s)
    out.append(struct.pack(">i", len(b)))
    out.append(b)


def _w_endpoint(out: List[bytes], ep: Endpoint) -> None:
    _w_field(out, T_I32, 1)
    out.append(struct.pack(">i", _i32(ep.ipv4)))
    _w_field(out, T_I16, 2)
    out.append(struct.pack(">h", _i16(ep.port)))
    _w_field(out, T_STRING, 3)
    _w_string(out, ep.service_name)
    out.append(b"\x00")


def _w_annotation(out: List[bytes], a: Annotation) -> None:
    _w_field(out, T_I64, 1)
    out.append(struct.pack(">q", a.timestamp))
    _w_field(out, T_STRING, 2)
    _w_string(out, a.value)
    if a.host is not None:
        _w_field(out, T_STRUCT, 3)
        _w_endpoint(out, a.host)
    out.append(b"\x00")


def _binary_value_bytes(b: BinaryAnnotation) -> bytes:
    v = b.value
    t = b.annotation_type
    if isinstance(v, bytes):
        return v
    if isinstance(v, bytearray):
        return bytes(v)
    if t == AnnotationType.STRING or isinstance(v, str):
        return str(v).encode("utf-8")
    if t == AnnotationType.BOOL:
        return b"\x01" if v else b"\x00"
    if t == AnnotationType.I16:
        return struct.pack(">h", int(v))
    if t == AnnotationType.I32:
        return struct.pack(">i", int(v))
    if t == AnnotationType.I64:
        return struct.pack(">q", int(v))
    if t == AnnotationType.DOUBLE:
        return struct.pack(">d", float(v))
    return bytes(v)


def _w_binary_annotation(out: List[bytes], b: BinaryAnnotation) -> None:
    _w_field(out, T_STRING, 1)
    _w_string(out, b.key)
    _w_field(out, T_STRING, 2)
    _w_string(out, _binary_value_bytes(b))
    _w_field(out, T_I32, 3)
    out.append(struct.pack(">i", int(b.annotation_type)))
    if b.host is not None:
        _w_field(out, T_STRUCT, 4)
        _w_endpoint(out, b.host)
    out.append(b"\x00")


def span_to_bytes(span: Span) -> bytes:
    out: List[bytes] = []
    _w_field(out, T_I64, 1)
    out.append(struct.pack(">q", _i64(span.trace_id)))
    _w_field(out, T_STRING, 3)
    _w_string(out, span.name)
    _w_field(out, T_I64, 4)
    out.append(struct.pack(">q", _i64(span.id)))
    if span.parent_id is not None:
        _w_field(out, T_I64, 5)
        out.append(struct.pack(">q", _i64(span.parent_id)))
    _w_field(out, T_LIST, 6)
    out.append(struct.pack(">bi", T_STRUCT, len(span.annotations)))
    for a in span.annotations:
        _w_annotation(out, a)
    _w_field(out, T_LIST, 8)
    out.append(struct.pack(">bi", T_STRUCT, len(span.binary_annotations)))
    for b in span.binary_annotations:
        _w_binary_annotation(out, b)
    _w_field(out, T_BOOL, 9)
    out.append(b"\x01" if span.debug else b"\x00")
    out.append(b"\x00")
    return b"".join(out)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ThriftError("truncated thrift payload")
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def string(self) -> bytes:
        n = self.i32()
        if n < 0:
            raise ThriftError("negative string length")
        return self.take(n)

    # Depth-bounded: crafted deeply nested containers on the
    # network-facing ingest path must fail the parse (ThriftError), not
    # exhaust the interpreter stack. Mirrors the native parser's bound.
    MAX_SKIP_DEPTH = 64

    def skip(self, ftype: int, depth: int = 0) -> None:
        if depth > self.MAX_SKIP_DEPTH:
            raise ThriftError("thrift container nesting too deep")
        if ftype == T_BOOL or ftype == T_BYTE:
            self.take(1)
        elif ftype == T_I16:
            self.take(2)
        elif ftype in (T_I32,):
            self.take(4)
        elif ftype in (T_I64, T_DOUBLE):
            self.take(8)
        elif ftype == T_STRING:
            self.string()
        elif ftype == T_STRUCT:
            while True:
                ft = self.u8()
                if ft == T_STOP:
                    break
                self.i16()
                self.skip(ft, depth + 1)
        elif ftype in (T_LIST, T_SET):
            et = self.u8()
            for _ in range(self.i32()):
                self.skip(et, depth + 1)
        elif ftype == T_MAP:
            kt, vt = self.u8(), self.u8()
            for _ in range(self.i32()):
                self.skip(kt, depth + 1)
                self.skip(vt, depth + 1)
        else:
            raise ThriftError(f"unknown thrift type {ftype}")


def _r_endpoint(r: _Reader) -> Endpoint:
    ipv4, port, service = 0, 0, "unknown"
    while True:
        ft = r.u8()
        if ft == T_STOP:
            break
        fid = r.i16()
        if fid == 1 and ft == T_I32:
            ipv4 = r.i32()
        elif fid == 2 and ft == T_I16:
            port = r.i16() & 0xFFFF
        elif fid == 3 and ft == T_STRING:
            service = r.string().decode("utf-8", "replace")
        else:
            r.skip(ft)
    return Endpoint(ipv4=ipv4, port=port, service_name=service)


def _r_annotation(r: _Reader) -> Annotation:
    ts, value, host = 0, "", None
    while True:
        ft = r.u8()
        if ft == T_STOP:
            break
        fid = r.i16()
        if fid == 1 and ft == T_I64:
            ts = r.i64()
        elif fid == 2 and ft == T_STRING:
            value = r.string().decode("utf-8", "replace")
        elif fid == 3 and ft == T_STRUCT:
            host = _r_endpoint(r)
        else:
            r.skip(ft)  # includes the optional i32 duration (fid 4)
    return Annotation(timestamp=ts, value=value, host=host)


def _decode_binary_value(raw: bytes, ann_type: AnnotationType):
    try:
        if ann_type == AnnotationType.STRING:
            return raw.decode("utf-8")
        if ann_type == AnnotationType.BOOL:
            return raw != b"\x00"
        if ann_type == AnnotationType.I16 and len(raw) == 2:
            return struct.unpack(">h", raw)[0]
        if ann_type == AnnotationType.I32 and len(raw) == 4:
            return struct.unpack(">i", raw)[0]
        if ann_type == AnnotationType.I64 and len(raw) == 8:
            return struct.unpack(">q", raw)[0]
        if ann_type == AnnotationType.DOUBLE and len(raw) == 8:
            return struct.unpack(">d", raw)[0]
    except (struct.error, UnicodeDecodeError):
        pass
    return raw


def _r_binary_annotation(r: _Reader) -> BinaryAnnotation:
    key, raw, ann_type, host = "", b"", AnnotationType.BYTES, None
    while True:
        ft = r.u8()
        if ft == T_STOP:
            break
        fid = r.i16()
        if fid == 1 and ft == T_STRING:
            key = r.string().decode("utf-8", "replace")
        elif fid == 2 and ft == T_STRING:
            raw = r.string()
        elif fid == 3 and ft == T_I32:
            try:
                ann_type = AnnotationType(r.i32())
            except ValueError:
                ann_type = AnnotationType.BYTES
        elif fid == 4 and ft == T_STRUCT:
            host = _r_endpoint(r)
        else:
            r.skip(ft)
    return BinaryAnnotation(
        key=key, value=_decode_binary_value(raw, ann_type),
        annotation_type=ann_type, host=host,
    )


def span_from_bytes(data: bytes, pos: int = 0) -> Tuple[Span, int]:
    r = _Reader(data, pos)
    trace_id = span_id = 0
    name = ""
    parent_id: Optional[int] = None
    anns: List[Annotation] = []
    banns: List[BinaryAnnotation] = []
    debug = False
    while True:
        ft = r.u8()
        if ft == T_STOP:
            break
        fid = r.i16()
        if fid == 1 and ft == T_I64:
            trace_id = r.i64()
        elif fid == 3 and ft == T_STRING:
            name = r.string().decode("utf-8", "replace")
        elif fid == 4 and ft == T_I64:
            span_id = r.i64()
        elif fid == 5 and ft == T_I64:
            parent_id = r.i64()
        elif fid == 6 and ft == T_LIST:
            et = r.u8()
            n = r.i32()
            if et != T_STRUCT:
                raise ThriftError("annotations must be a struct list")
            anns = [_r_annotation(r) for _ in range(n)]
        elif fid == 8 and ft == T_LIST:
            et = r.u8()
            n = r.i32()
            if et != T_STRUCT:
                raise ThriftError("binary annotations must be a struct list")
            banns = [_r_binary_annotation(r) for _ in range(n)]
        elif fid == 9 and ft == T_BOOL:
            debug = r.u8() != 0
        else:
            r.skip(ft)
    span = Span(
        trace_id=trace_id, name=name, id=span_id, parent_id=parent_id,
        annotations=tuple(anns), binary_annotations=tuple(banns), debug=debug,
    )
    return span, r.pos


def spans_from_bytes(data: bytes) -> List[Span]:
    """Parse a back-to-back sequence of Span structs."""
    out, pos = [], 0
    while pos < len(data):
        span, pos = span_from_bytes(data, pos)
        out.append(span)
    return out


# -- scribe framing ---------------------------------------------------------


def span_to_scribe_message(span: Span) -> str:
    """Span → base64 thrift, the LogEntry.message payload
    (ScribeSpanReceiver.scala:50-54)."""
    return base64.b64encode(span_to_bytes(span)).decode("ascii")


def scribe_message_to_span(message: str) -> Span:
    try:
        raw = base64.b64decode(message, validate=False)
    except Exception as e:  # binascii.Error subclasses ValueError
        raise ThriftError(f"bad base64 payload: {e}") from None
    span, _ = span_from_bytes(raw)
    return span


def _i64(x: int) -> int:
    x &= 0xFFFFFFFFFFFFFFFF
    return x - 0x10000000000000000 if x >= 0x8000000000000000 else x


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def _i16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x
