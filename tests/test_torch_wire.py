"""The port's thrift wire codec (``zipkin_tpu_torch/wire``) against the
JAX package's, on the CPU: the same span gives the same bytes, the same
scribe message, and each package decodes the other's bytes to the same
span, for generated spans, edge ids (``LONG_MIN``, ``LONG_MAX``, 0,
-1), every ``AnnotationType``, unicode names, hostless and debug spans.
Malformed payloads raise ``ThriftError`` in both. Exact equality
throughout (the codec is integer and byte work)."""

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_store import PORT, REF, _convert  # noqa: E402
from zipkin_tpu.models.span import (  # noqa: E402
    Annotation,
    AnnotationType,
    BinaryAnnotation,
    Endpoint,
    Span,
)
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu.wire import thrift as ref_wire  # noqa: E402
from zipkin_tpu_torch.wire import thrift as port_wire  # noqa: E402

LONG_MAX = (1 << 63) - 1
LONG_MIN = -(1 << 63)
WEB = Endpoint(0x7F000001, 8080, "Web-Front")
API = Endpoint(-0x3F5F5F5F, -1, "api")


def generated_spans(seed: int, n_traces: int = 40):
    rng = np.random.default_rng(seed)
    traces = generate_traces(n_traces=n_traces, max_depth=4, n_services=6,
                             rng=rng)
    return [s for t in traces for s in t]


def edge_spans():
    banns = (
        BinaryAnnotation("flag", True, AnnotationType.BOOL, WEB),
        BinaryAnnotation("raw", b"\x00\xff\x10", AnnotationType.BYTES, None),
        BinaryAnnotation("i16", -32768, AnnotationType.I16, API),
        BinaryAnnotation("i32", 2**31 - 1, AnnotationType.I32, None),
        BinaryAnnotation("i64", LONG_MIN, AnnotationType.I64, API),
        BinaryAnnotation("dbl", -2.5e-300, AnnotationType.DOUBLE, None),
        BinaryAnnotation("str", "été 日本", AnnotationType.STRING,
                         WEB),
    )
    return [
        Span(trace_id=LONG_MIN, name="über-call ☃", id=LONG_MAX,
             parent_id=LONG_MIN,
             annotations=(Annotation(LONG_MIN, "cs", WEB),
                          Annotation(0, "sr", API),
                          Annotation(LONG_MAX, "ss", None)),
             binary_annotations=banns, debug=True),
        Span(trace_id=LONG_MAX, name="", id=0, parent_id=None),
        Span(trace_id=0, name="zero", id=-1, parent_id=0,
             annotations=(Annotation(5, "注釈", Endpoint(0, 0, "")),),
             debug=False),
        Span(trace_id=-1, name="hostless", id=1,
             binary_annotations=(
                 BinaryAnnotation("k", "", AnnotationType.STRING, None),)),
    ]


CASES = {
    "generated_a": lambda: generated_spans(1),
    "generated_b": lambda: generated_spans(2),
    "edge": edge_spans,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_bytes_match_reference(case):
    spans = CASES[case]()
    for s in spans:
        ps = _convert(s, PORT)
        assert port_wire.span_to_bytes(ps) == ref_wire.span_to_bytes(s), s


@pytest.mark.parametrize("case", sorted(CASES))
def test_scribe_message_matches_reference(case):
    for s in CASES[case]():
        ps = _convert(s, PORT)
        msg = ref_wire.span_to_scribe_message(s)
        assert port_wire.span_to_scribe_message(ps) == msg
        assert _convert(port_wire.scribe_message_to_span(msg), REF) == \
            ref_wire.scribe_message_to_span(msg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_from_bytes_cross_decode(case):
    spans = CASES[case]()
    ref_payload = b"".join(ref_wire.span_to_bytes(s) for s in spans)
    port_payload = b"".join(port_wire.span_to_bytes(_convert(s, PORT))
                            for s in spans)
    assert port_payload == ref_payload
    want = ref_wire.spans_from_bytes(ref_payload)
    assert _convert(port_wire.spans_from_bytes(ref_payload), REF) == want
    got, pos = port_wire.span_from_bytes(ref_payload)
    assert pos == len(ref_wire.span_to_bytes(spans[0]))
    assert _convert(got, REF) == want[0]


def test_unknown_fields_skipped_as_reference():
    s = edge_spans()[0]
    data = ref_wire.span_to_bytes(s)
    patched = data[:-1] + struct.pack(">bhi", 8, 99, 7) + b"\x00"
    want, _ = ref_wire.span_from_bytes(patched)
    got, _ = port_wire.span_from_bytes(patched)
    assert _convert(got, REF) == want


@pytest.mark.parametrize("payload", [
    b"\xff\xff\xff",
    b"\x0a\x00\x01\x00",
    ref_wire.span_to_bytes(edge_spans()[0])[:40],
    b"\x0f\x00\x06\x0c\x7f\xff\xff\xff",
], ids=["bad_type", "short_i64", "truncated", "huge_list"])
def test_malformed_raises_thrift_error_in_both(payload):
    with pytest.raises(ref_wire.ThriftError):
        ref_wire.spans_from_bytes(payload)
    with pytest.raises(port_wire.ThriftError):
        port_wire.spans_from_bytes(payload)
    assert issubclass(port_wire.ThriftError, ValueError)
