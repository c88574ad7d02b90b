"""Wire compatibility: thrift binary span codec + scribe framing.

Instrumented apps emit spans as TBinaryProtocol-serialized thrift
structs, base64-wrapped in scribe LogEntry messages (reference:
zipkinCore.thrift:27-57, scribe.thrift:29, decoded at
ScribeSpanReceiver.scala:96-107). This package speaks that exact wire
format so existing zipkin clients can feed the collector unchanged. The
port's copy of ``zipkin_tpu/wire``: the same bytes for the same span.
"""

from zipkin_tpu_torch.wire.thrift import (  # noqa: F401
    ThriftError,
    scribe_message_to_span,
    span_from_bytes,
    span_to_bytes,
    span_to_scribe_message,
    spans_from_bytes,
)
