"""Cold-tier segment store, torch side: capture ring evictions into
immutable compressed columnar segments with sketch zone-maps, and
federate queries across the hot device ring and the cold segments.

The port's copy of ``zipkin_tpu/store/archive``. The segment byte
format is the reference's, so segment files (and the tiered snapshots
that carry them) cross between the two packages.

- ``sketches`` — numpy twins of the ops/ hash + sketch primitives
  (bloom / CMS / HLL / log-histogram), all mergeable monoids.
- ``segment`` — the immutable segment format: deflate-compressed
  SpanBatch column planes + a zone-map header.
- ``directory`` — the segment list + the background compactor that
  merges small segments (zone maps merge monoidally, no re-scan).
- ``coldquery`` — the zone-pruned cold read half (``ColdQueries``).
- ``tiered`` — ``TieredSpanStore``: the full SpanStore SPI over
  hot ring + cold segments, pruning segments by zone-map before any
  row decode.
"""

from zipkin_tpu_torch.store.archive.directory import (  # noqa: F401
    ArchiveParams,
    SegmentDirectory,
)
from zipkin_tpu_torch.store.archive.segment import (  # noqa: F401
    Segment,
    ZoneMap,
    merge_segments,
    seal_segment,
)
from zipkin_tpu_torch.store.archive.tiered import (  # noqa: F401
    TieredSpanStore,
)

__all__ = [
    "ArchiveParams",
    "Segment",
    "SegmentDirectory",
    "TieredSpanStore",
    "ZoneMap",
    "merge_segments",
    "seal_segment",
]
