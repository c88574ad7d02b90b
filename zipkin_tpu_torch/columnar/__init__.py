"""Columnar (structure-of-arrays) span representation.

This is the TPU-native wire between the host span model and the device:
strings are dictionary-encoded on the host (mirroring the reference's
HBase dictionary mappers, zipkin-hbase/.../mapping/ServiceMapper.scala),
and the device sees only fixed-width integer/float arrays.
"""

from zipkin_tpu_torch.columnar.dictionary import Dictionary, DictionarySet  # noqa: F401
from zipkin_tpu_torch.columnar.schema import (  # noqa: F401
    FLAG_DEBUG,
    FLAG_HAS_PARENT,
    NO_ENDPOINT,
    NO_SERVICE,
    NO_TS,
    SpanBatch,
)
from zipkin_tpu_torch.columnar.encode import SpanCodec  # noqa: F401
