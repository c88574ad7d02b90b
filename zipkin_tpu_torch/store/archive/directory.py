"""Segment directory + background compactor.

The port's copy of ``zipkin_tpu/store/archive/directory.py``, on the
port's ``obs`` registry.

The directory owns the cold tier's segment list (sorted by gid range,
immutable entries), the decoded-row cache the query paths share, and
the compaction policy: whenever ``compact_fanin`` consecutive segments
are each below ``small_span_limit`` rows, the oldest such run merges
into one (rows concatenated, zone maps merged monoidally) — the
log-structured size-tiering that keeps the per-query segment count
O(log total) instead of O(captures). Compaction runs inline after each
append by default (deterministic for tests); ``start_compactor()``
moves it to a background thread for deployments where capture latency
matters.

Telemetry rides the obs registry: segments written / compacted /
pruned counters, live-segment and cold-span gauges, and a cold-scan
latency sketch the tiered reads observe into.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, NamedTuple, Optional

from zipkin_tpu_torch.store.archive.segment import Segment, merge_segments


class ArchiveParams(NamedTuple):
    """Fixed sketch geometry — merge requires equal shapes, so the
    directory pins these for its lifetime (checkpoint restores them).

    ``hist_gamma``/``hist_buckets`` default to the device svc_hist
    geometry (StoreConfig.quantile_alpha/quantile_buckets) via
    ``ArchiveParams.for_config`` so hot and cold histogram rows merge
    by ``+``."""

    bloom_bits: int = 1 << 16
    cms_depth: int = 4
    cms_width: int = 1 << 12
    hll_p: int = 10
    hist_buckets: int = 2048
    hist_gamma: float = (1.0 + 0.01) / (1.0 - 0.01)
    compact_fanin: int = 4
    small_span_limit: int = 1 << 18

    @staticmethod
    def for_config(config, **overrides) -> "ArchiveParams":
        gamma = (1.0 + config.quantile_alpha) / (1.0 - config.quantile_alpha)
        base = ArchiveParams(
            hist_buckets=config.quantile_buckets, hist_gamma=gamma,
            # Small segments arrive every half ring; merge them until
            # they pass ~2 ring turns of rows.
            small_span_limit=max(2 * config.capacity, 1024),
        )
        return base._replace(**overrides)


class SegmentDirectory:
    # Decoded (batch, gids, spans) cached for the most recent segments
    # a query touched — cold reads decode a segment at most once per
    # generation of the cache. Bounded by COUNT and by (approximate)
    # BYTES: at production geometry one compacted segment decodes to
    # multi-GB of rows + Span objects, so an entry-count bound alone
    # would quietly pin several of those in host memory.
    DECODE_CACHE = 8
    DECODE_CACHE_BYTES = 256 << 20

    def __init__(self, params: ArchiveParams, codec,
                 registry=None):
        from zipkin_tpu_torch import obs

        self.params = params
        self.codec = codec
        self._lock = threading.Lock()  # lock-order: 55 archive-dir
        self._segments: List[Segment] = []
        self._next_id = 0  # guarded-by: _lock
        self._decoded: Dict[int, tuple] = {}
        self._compactor: Optional[threading.Thread] = None
        self._compactor_stop = threading.Event()
        reg = registry or obs.default_registry()
        self._registry = reg
        self.c_written = reg.register(obs.Counter(
            "zipkin_archive_segments_written_total",
            "Cold-tier segments sealed from eviction captures"))
        self.c_compacted = reg.register(obs.Counter(
            "zipkin_archive_compactions_total",
            "Compaction merges executed (N small segments -> 1)"))
        self.c_pruned = reg.register(obs.Counter(
            "zipkin_archive_segments_pruned_total",
            "Segments skipped by zone-map pruning before row decode"))
        self.g_live = reg.register(obs.Gauge(
            "zipkin_archive_segments_live",
            "Segments currently in the directory",
            fn=lambda: float(len(self._segments))))
        self.g_cold_spans = reg.register(obs.Gauge(
            "zipkin_archive_cold_spans",
            "Span rows held by the cold tier",
            fn=self._cold_spans))
        self.h_cold_query = reg.register(obs.LatencySketch(
            "zipkin_archive_cold_query_seconds",
            "Cold-tier scan latency per federated read"))
        self.h_capture = reg.register(obs.LatencySketch(
            "zipkin_archive_capture_seconds",
            "Eviction capture latency (device pull + seal)"))

    # -- bookkeeping ----------------------------------------------------

    def close(self) -> None:
        """Unregister this directory's metrics: gauge closures hold the
        directory alive and a later directory's registration would
        otherwise silently shadow a dead one's counters (the registry
        is last-wins)."""
        for m in (self.c_written, self.c_compacted, self.c_pruned,
                  self.g_live, self.g_cold_spans, self.h_cold_query,
                  self.h_capture):
            # Only drop the registration if it is still OURS — a newer
            # directory may have re-registered the name already.
            if self._registry.get(m.name) is m:
                self._registry.unregister(m.name)

    def _cold_spans(self) -> float:
        return float(sum(s.n_spans for s in self._segments))

    def next_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id - 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._segments)

    def snapshot(self) -> List[Segment]:
        with self._lock:
            return list(self._segments)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            segs = list(self._segments)
        return {
            "archive_segments_live": float(len(segs)),
            "archive_segments_written": float(self.c_written.value),
            "archive_compactions": float(self.c_compacted.value),
            "archive_segments_pruned": float(self.c_pruned.value),
            "archive_cold_spans": float(sum(s.n_spans for s in segs)),
            "archive_cold_bytes": float(sum(s.comp_bytes for s in segs)),
            "archive_cold_raw_bytes": float(sum(s.raw_bytes
                                                for s in segs)),
        }

    # -- mutation -------------------------------------------------------

    def append(self, segment: Segment, cache: Optional[tuple] = None
               ) -> None:
        """Add a freshly sealed segment (sorted by gid range) and run
        one inline compaction pass unless a background compactor owns
        that job. ``cache`` optionally pre-seeds the decode cache with
        the (batch, gids, spans) the sealer already materialized."""
        with self._lock:
            self._segments.append(segment)
            self._segments.sort(key=lambda s: s.gid_lo)
            if cache is not None:
                self._cache_put(segment.seg_id, cache,
                                3 * segment.raw_bytes)
        self.c_written.inc()
        if self._compactor is None:
            self.compact_once()

    def restore(self, segments: List[Segment], next_id: int) -> None:
        """Checkpoint restore: adopt an already-built segment list."""
        with self._lock:
            self._segments = sorted(segments, key=lambda s: s.gid_lo)
            self._next_id = next_id
            self._decoded.clear()

    def drop_below(self, gid_upto: int) -> int:
        """Drop whole segments whose rows all precede ``gid_upto`` —
        the read replica's retention bound (store/replica.py). The
        tiered primary never calls this: its cold tier IS the
        retention. Returns the number of segments dropped."""
        with self._lock:
            dropped = [s for s in self._segments if s.gid_hi <= gid_upto]
            if not dropped:
                return 0
            self._segments = [s for s in self._segments
                              if s.gid_hi > gid_upto]
            for s in dropped:
                self._decoded.pop(s.seg_id, None)
        return len(dropped)

    # -- compaction -----------------------------------------------------

    def _find_run(self) -> Optional[List[Segment]]:
        p = self.params
        run: List[Segment] = []
        for seg in self._segments:
            if seg.n_spans <= p.small_span_limit:
                run.append(seg)
                if len(run) >= p.compact_fanin:
                    return run
            else:
                run = []
        return None

    def compact_once(self) -> bool:
        """Merge one run of small segments; True if a merge happened."""
        with self._lock:
            run = self._find_run()
            if run is None:
                return False
            seg_id = self._next_id
            self._next_id += 1
        # Merge OUTSIDE the lock (decompress + recompress is the bulk
        # of the work); immutability makes the stale-read window safe —
        # the replace below re-checks membership.
        merged = merge_segments(seg_id, run)
        with self._lock:
            ids = {s.seg_id for s in run}
            if not ids.issubset({s.seg_id for s in self._segments}):
                return False  # lost a race with another compactor pass
            self._segments = [s for s in self._segments
                              if s.seg_id not in ids]
            self._segments.append(merged)
            self._segments.sort(key=lambda s: s.gid_lo)
            for sid in ids:
                self._decoded.pop(sid, None)
        self.c_compacted.inc()
        return True

    def start_compactor(self, interval_s: float = 1.0) -> None:
        """Move compaction to a background thread (deployment mode)."""
        if self._compactor is not None:
            return

        def loop():
            while not self._compactor_stop.wait(interval_s):
                while self.compact_once():
                    pass

        self._compactor = threading.Thread(target=loop, daemon=True)
        self._compactor.start()

    def stop_compactor(self) -> None:
        if self._compactor is None:
            return
        self._compactor_stop.set()
        self._compactor.join(timeout=5.0)
        self._compactor = None
        self._compactor_stop.clear()

    # -- decoded-row cache ----------------------------------------------

    def _cache_put(self, seg_id: int, value: tuple,
                   nbytes: int) -> None:
        self._decoded[seg_id] = (value, nbytes)
        while len(self._decoded) > 1 and (
                len(self._decoded) > self.DECODE_CACHE
                or sum(b for _, b in self._decoded.values())
                > self.DECODE_CACHE_BYTES):
            self._decoded.pop(next(iter(self._decoded)))

    def decoded(self, segment: Segment) -> tuple:
        """(SpanBatch, gids, List[Span]) for a segment, cached."""
        with self._lock:
            got = self._decoded.get(segment.seg_id)
            if got is not None:
                return got[0]
        batch, gids = segment.decode()
        spans = self.codec.decode(batch)
        value = (batch, gids, spans)
        with self._lock:
            # Span objects cost a few x the column bytes; 3x raw is a
            # serviceable estimate for the bound's purpose.
            self._cache_put(segment.seg_id, value,
                            3 * segment.raw_bytes)
        return value

    # -- pruning helper -------------------------------------------------

    def pruned_scan(self, probe: Callable[[Segment], bool]
                    ) -> List[Segment]:
        """Segments surviving ``probe`` (True = may match); skipped
        segments count into the pruning telemetry."""
        out = []
        for seg in self.snapshot():
            if probe(seg):
                out.append(seg)
            else:
                self.c_pruned.inc()
        return out
