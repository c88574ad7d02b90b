"""Host-side dictionary encoding: strings/bytes/endpoints ↔ small ints.

Parity note: plays the role of the reference's HBase dictionary mappers
(zipkin-hbase/.../mapping/ServiceMapper.scala, SpanNameMapper.scala,
AnnotationMapper.scala with utils/IDGenerator.scala:8) — but as a plain
in-process map, since in this framework the dictionaries never leave the
host and the device only ever sees the ids.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Optional

from zipkin_tpu_torch.models.constants import (
    CORE_ANNOTATION_IDS,
    FIRST_USER_ANNOTATION_ID,
)
from zipkin_tpu_torch.models.span import Endpoint


class Dictionary:
    """Bidirectional value↔id map with dense int ids.

    Thread-safe (ingest workers encode concurrently). Ids are assigned
    densely from ``first_id`` in first-seen order, which keeps device-side
    arrays (e.g. per-service counters indexed by service_id) compact.
    """

    def __init__(self, first_id: int = 0, reserved: Optional[Dict[Hashable, int]] = None):
        self._lock = threading.Lock()  # lock-order: 78 dictionary
        self._to_id: Dict[Hashable, int] = {}
        self._values: List[Hashable] = []
        self._first_id = first_id
        if reserved:
            top = max(reserved.values()) + 1
            self._values = [None] * (max(top, first_id) - first_id)
            for value, vid in reserved.items():
                self._to_id[value] = vid
                self._values[vid - first_id] = value

    def encode(self, value: Hashable) -> int:
        """Return the id for ``value``, assigning a new one if unseen."""
        got = self._to_id.get(value)
        if got is not None:
            return got
        with self._lock:
            got = self._to_id.get(value)
            if got is not None:
                return got
            vid = self._first_id + len(self._values)
            self._values.append(value)
            self._to_id[value] = vid
            return vid

    def get(self, value: Hashable) -> Optional[int]:
        """Id for ``value`` or None if never seen (no assignment)."""
        return self._to_id.get(value)

    def decode(self, vid: int):
        return self._values[vid - self._first_id]

    def __len__(self) -> int:
        return len(self._values)

    def __contains__(self, value: Hashable) -> bool:
        return value in self._to_id

    def values(self) -> List[Hashable]:
        return list(self._values)

    def items(self):
        return [(v, self._first_id + i) for i, v in enumerate(self._values)]


class DictionarySet:
    """The full set of dictionaries one store/pipeline shares.

    - ``services``: lowercased service names
    - ``span_names``: span (rpc) names
    - ``annotations``: annotation values; core cs/cr/sr/ss/ca/sa ids are
      reserved (models/constants.CORE_ANNOTATION_IDS) so device kernels can
      exclude core annotations with ``id < FIRST_USER_ANNOTATION_ID``
    - ``binary_keys`` / ``binary_values``: binary-annotation key strings and
      value bytes (values dictionary-encoded so decode is lossless)
    - ``endpoints``: (ipv4, port, service_name) triples
    """

    def __init__(self):
        self.services = Dictionary()
        self.span_names = Dictionary()
        self.annotations = Dictionary(
            reserved=dict(CORE_ANNOTATION_IDS),
        )
        # Make sure user annotation values start at the reserved boundary.
        while len(self.annotations) < FIRST_USER_ANNOTATION_ID:
            self.annotations.encode(f"__reserved_{len(self.annotations)}__")
        self.binary_keys = Dictionary()
        self.binary_values = Dictionary()
        self.endpoints = Dictionary()

    def encode_endpoint(self, ep: Endpoint) -> int:
        return self.endpoints.encode((ep.ipv4, ep.port, ep.service_name))

    def decode_endpoint(self, eid: int) -> Endpoint:
        ipv4, port, service_name = self.endpoints.decode(eid)
        return Endpoint(ipv4=ipv4, port=port, service_name=service_name)
