"""Immutable span model.

Parity targets (reference, /root/reference):
- ``Span`` trait — zipkin-common/src/main/scala/com/twitter/zipkin/common/Span.scala:89
  (serviceName preference :125, mergeSpan :148, duration :228, isValid :236)
- ``Annotation`` — common/Annotation.scala:27
- ``BinaryAnnotation`` — common/BinaryAnnotation.scala:21
- ``Endpoint`` — common/Endpoint.scala:35

Timestamps are microseconds since epoch throughout, as in the reference.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

from zipkin_tpu_torch.models.constants import (
    CORE_ANNOTATIONS,
    CORE_CLIENT,
    CORE_SERVER,
)


@dataclass(frozen=True, order=True)
class Endpoint:
    """A network endpoint: service name + ipv4 + port.

    Reference: common/Endpoint.scala:35. ipv4 is the packed signed-int form
    used on the wire; port is the unsigned 16-bit port stored in a signed
    short on the wire (we keep it as a plain int 0..65535).
    """

    ipv4: int = 0
    port: int = 0
    service_name: str = "unknown"

    def ipv4_str(self) -> str:
        v = self.ipv4 & 0xFFFFFFFF
        return ".".join(str((v >> s) & 0xFF) for s in (24, 16, 8, 0))


@dataclass(frozen=True)
class Annotation:
    """A timestamped event in a span (reference: common/Annotation.scala:27)."""

    timestamp: int  # microseconds since epoch
    value: str
    host: Optional[Endpoint] = None

    def sort_key(self) -> Tuple[int, str]:
        return (self.timestamp, self.value)


class AnnotationType(enum.IntEnum):
    """Binary annotation value types (reference: zipkinCore.thrift:27-38)."""

    BOOL = 0
    BYTES = 1
    I16 = 2
    I32 = 3
    I64 = 4
    DOUBLE = 5
    STRING = 6


@dataclass(frozen=True)
class BinaryAnnotation:
    """A key/value span tag (reference: common/BinaryAnnotation.scala:21)."""

    key: str
    value: object
    annotation_type: AnnotationType = AnnotationType.STRING
    host: Optional[Endpoint] = None


@dataclass(frozen=True)
class Span:
    """A single RPC span (reference: common/Span.scala:89).

    ``trace_id`` / ``id`` / ``parent_id`` are 64-bit ints (python ints,
    interpreted as signed on the wire). ``annotations`` are kept in insert
    order; ordering-sensitive accessors sort by timestamp like the reference.
    """

    trace_id: int
    name: str
    id: int
    parent_id: Optional[int] = None
    annotations: Tuple[Annotation, ...] = field(default_factory=tuple)
    binary_annotations: Tuple[BinaryAnnotation, ...] = field(default_factory=tuple)
    debug: bool = False

    def __post_init__(self):
        # Normalise sequences to tuples so the dataclass stays hashable.
        if not isinstance(self.annotations, tuple):
            object.__setattr__(self, "annotations", tuple(self.annotations))
        if not isinstance(self.binary_annotations, tuple):
            object.__setattr__(
                self, "binary_annotations", tuple(self.binary_annotations)
            )

    # -- naming ---------------------------------------------------------

    @property
    def service_names(self) -> frozenset:
        """All (lowercased) service names of annotation hosts (Span.scala:120)."""
        return frozenset(
            a.host.service_name.lower() for a in self.annotations if a.host is not None
        )

    @property
    def service_name(self) -> Optional[str]:
        """Best-effort owning service: server-side host, else client-side
        (Span.scala:125)."""
        if not self.annotations:
            return None
        for pool in (self.server_side_annotations, self.client_side_annotations):
            for a in pool:
                if a.host is not None:
                    return a.host.service_name
        return None

    # -- annotation access ----------------------------------------------

    def get_annotation(self, value: str) -> Optional[Annotation]:
        for a in self.annotations:
            if a.value == value:
                return a
        return None

    def get_binary_annotation(self, key: str) -> Optional[BinaryAnnotation]:
        for b in self.binary_annotations:
            if b.key == key:
                return b
        return None

    @property
    def client_side_annotations(self) -> Tuple[Annotation, ...]:
        return tuple(a for a in self.annotations if a.value in CORE_CLIENT)

    @property
    def server_side_annotations(self) -> Tuple[Annotation, ...]:
        return tuple(a for a in self.annotations if a.value in CORE_SERVER)

    def is_client_side(self) -> bool:
        return any(a.value in CORE_CLIENT for a in self.annotations)

    @property
    def first_annotation(self) -> Optional[Annotation]:
        return min(self.annotations, key=Annotation.sort_key, default=None)

    @property
    def last_annotation(self) -> Optional[Annotation]:
        return max(self.annotations, key=Annotation.sort_key, default=None)

    @property
    def first_timestamp(self) -> Optional[int]:
        a = self.first_annotation
        return None if a is None else a.timestamp

    @property
    def last_timestamp(self) -> Optional[int]:
        a = self.last_annotation
        return None if a is None else a.timestamp

    @property
    def endpoints(self) -> frozenset:
        return frozenset(a.host for a in self.annotations if a.host is not None)

    @property
    def client_side_endpoint(self) -> Optional[Endpoint]:
        for a in self.client_side_annotations:
            if a.host is not None:
                return a.host
        return None

    # -- algebra --------------------------------------------------------

    @property
    def duration(self) -> Optional[int]:
        """Microseconds between first and last annotation (Span.scala:228)."""
        first, last = self.first_timestamp, self.last_timestamp
        if first is None or last is None:
            return None
        return last - first

    def is_valid(self) -> bool:
        """True iff at most one of each core annotation (Span.scala:236)."""
        for c in CORE_ANNOTATIONS:
            if sum(1 for a in self.annotations if a.value == c) > 1:
                return False
        return True

    def merge(self, other: "Span") -> "Span":
        """Merge two halves (client/server) of the same span (Span.scala:148)."""
        if self.id != other.id:
            raise ValueError("Span ids must match")
        name = self.name
        if name in ("", "Unknown"):
            name = other.name
        return replace(
            self,
            name=name,
            annotations=self.annotations + other.annotations,
            binary_annotations=self.binary_annotations + other.binary_annotations,
            debug=self.debug or other.debug,
        )

    def annotations_as_map(self) -> dict:
        return {a.value: a for a in self.annotations}


def merge_by_span_id(spans: Sequence[Span]) -> list:
    """Group spans by id and merge each group (query/Trace.scala:178)."""
    by_id: dict = {}
    order: list = []
    for s in spans:
        if s.id in by_id:
            by_id[s.id] = by_id[s.id].merge(s)
        else:
            by_id[s.id] = s
            order.append(s.id)
    return [by_id[i] for i in order]
