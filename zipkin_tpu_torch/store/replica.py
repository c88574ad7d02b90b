"""ReplicaSpanStore — a device-free CPU read replica fed by shipped WAL.

The disaggregated-serving split (docs/REPLICATION.md): one chip owns
the write path; any number of plain-CPU replicas own dashboard reads.
A replica replays the primary's journaled stage-1 launch groups
(wal/record.py) into exactly two host structures and nothing else:

- the **SketchMirror** (store/mirror.py) — numpy twins of the device's
  lifetime aggregates AND the windowed Moments-sketch arena. The
  mirror's ``delta_of`` is a pure host function of the record's
  columns, and its integer folds are the same adds/maxes the fused
  device step scatters — so a replica's mirror is BITWISE the
  primary's device arrays at the same applied WAL sequence. The whole
  sketch tier (catalogs, quantiles, top-k, HLL cardinality, windowed
  quantiles / SLO burn / latency heatmaps) answers from it with no
  device anywhere.

- a **cold-tier SegmentDirectory** (store/archive/) — every record's
  batches seal into an immutable zone-mapped segment (gids = the
  primary's global write positions, assigned identically by replay
  order), compacted by the background size-tiering. Row reads and
  index queries run the ColdQueries mixin — the SAME zone-prune +
  memory-oracle-match code the TieredSpanStore's cold half runs — so
  trace reads agree with the primary's hot+cold federation wherever
  both still retain the rows (the replica's retention is
  ``retain_spans``; the primary's is its cold tier).

Writes are refused (``ReplicaReadOnlyError``): the replica's only
writer is the replication follower (replicate/follow.py) calling
``apply_record``. Records must arrive in sequence — the dictionary
delta chain (wal/record.py) makes any gap or reorder a hard
``WalReplayError`` rather than silent divergence. Staleness is
explicit: ``applied_seq`` is the replica's frontier and
``write_frontier()`` keys the resident query engine's result cache, so
a cached answer is never served across an apply.

The port's copy of ``zipkin_tpu/store/replica.py``, on the port's own
mirror, archive, record codec and sketches. It is host-only by the
reference's design, not as a fallback: no tensor, no kernel. Its
sealed segments are the reference replica's bytes, and its mirror is
bitwise the port primary's device aggregates (on the CPU and on the
card alike: every mirrored leaf is an integer fold). The HLL estimate
is the port's float64 ``ops/hll.estimate`` over the mirrored registers,
so it equals the port primary's ``estimated_unique_traces`` bit for bit
and the reference's float32 estimate within stated tolerance 3.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from zipkin_tpu_torch.columnar.encode import SpanCodec, to_signed64
from zipkin_tpu_torch.columnar.schema import SpanBatch
from zipkin_tpu_torch.concurrency import RWLock
from zipkin_tpu_torch.models.span import Span
from zipkin_tpu_torch.ops import hll
from zipkin_tpu_torch.ops import quantile as Q
from zipkin_tpu_torch.store.analytics import WindowedAnalytics
from zipkin_tpu_torch.store.archive.coldquery import (
    ColdQueries,
    durations_from_bounds,
)
from zipkin_tpu_torch.store.archive.directory import (
    ArchiveParams,
    SegmentDirectory,
)
from zipkin_tpu_torch.store.archive.segment import seal_segment
from zipkin_tpu_torch.store.base import (
    IndexedTraceId,
    ReadSpanStore,
    StorageException,
    TraceIdDuration,
)
from zipkin_tpu_torch.store.mirror import SketchMirror
from zipkin_tpu_torch.wal.record import (
    WalReplayError,
    apply_dict_deltas,
    decode_unit,
)


class ReplicaReadOnlyError(StorageException):
    """A write reached a read replica: replicas are fed ONLY by the
    replication follower's ``apply_record``. Route writes to the
    primary."""


def concat_batch_parts(parts: Sequence[Tuple]) -> SpanBatch:
    """One SpanBatch from a launch unit's (batch, name_lc, indexable)
    parts, annotation span indices rebased — the replica seals one
    segment per WAL record instead of one per chunk."""
    batches = [b for b, _, _ in parts]
    if len(batches) == 1:
        return batches[0]
    out = {}
    for col in SpanBatch.SPAN_COLUMNS:
        out[col] = np.concatenate([getattr(b, col) for b in batches])
    offs = np.cumsum([0] + [b.n_spans for b in batches])
    for cols, idx_col in ((SpanBatch.ANN_COLUMNS, "ann_span_idx"),
                          (SpanBatch.BANN_COLUMNS, "bann_span_idx")):
        for col in cols:
            if col == idx_col:
                out[col] = np.concatenate([
                    getattr(b, col) + off
                    for b, off in zip(batches, offs)
                ]).astype(np.int32)
            else:
                out[col] = np.concatenate(
                    [getattr(b, col) for b in batches])
    return SpanBatch(**out)


class ReplicaSpanStore(WindowedAnalytics, ColdQueries, ReadSpanStore):
    """See the module docstring. Thread-safe: ``apply_record`` runs on
    the follower thread; reads run on API threads under the read half
    of the same RWLock discipline the device stores use."""

    def __init__(self, config, codec: Optional[SpanCodec] = None,
                 params: Optional[ArchiveParams] = None,
                 registry=None, retain_spans: int = 0,
                 background_compaction: bool = True):
        from zipkin_tpu_torch import obs

        self.config = config
        self.codec = codec or SpanCodec()
        self.params = params or ArchiveParams.for_config(config)
        reg = registry or obs.default_registry()
        self._registry = reg
        self.archive = SegmentDirectory(self.params, self.codec,
                                        registry=reg)
        if background_compaction:
            # Inline compaction would run its deflate merge inside the
            # apply write-lock hold and stall every reader behind it.
            self.archive.start_compactor()
        self.sketch_mirror = SketchMirror(config,
                                          dicts=self.codec.dicts)
        # Replica retention: drop whole segments older than this many
        # spans behind the applied frontier (0 = keep everything).
        self.retain_spans = max(0, int(retain_spans))
        # Serializes appliers (the follower is single-threaded, but
        # anchor adoption and tests may race it).
        self._lock = threading.Lock()  # lock-order: 12 replica-apply
        # Guards the visible (segments, mirror, frontier) triple:
        # apply_record publishes under write, reads snapshot under
        # read — the frontier can never move mid-read, which is what
        # makes the engine's frontier-keyed cache sound here.
        self._rw = RWLock()  # lock-order: 40 commit
        # _wp is mutated only by the (single) applier under _lock and
        # published under _rw.write; the applier's own pre-publish read
        # (gid assignment) is safe under _lock alone, so the stricter
        # of the two guards can't be declared without false positives.
        self._wp = 0
        self._applied_seq = 0  # guarded-by: _rw.write
        self._step_seq = 0  # guarded-by: _rw.write
        self.ttls: Dict[int, float] = {}  # guarded-by: _lock
        self.records_applied = 0  # guarded-by: _rw.write
        self.spans_applied = 0  # guarded-by: _rw.write

    @property
    def dicts(self):
        return self.codec.dicts

    # -- replication write path (follower thread only) ------------------

    def applied_seq(self) -> int:
        with self._rw.read():
            return self._applied_seq

    def apply_record(self, seq: int, payload: bytes) -> int:
        """Fold one shipped WAL record in; returns its span count.
        Records must arrive in sequence order; an already-applied
        sequence is skipped idempotently (reconnect overlap), a gap is
        a lineage error (the dictionary delta chain would desync)."""
        with self._lock:
            with self._rw.read():
                applied = self._applied_seq
            if seq <= applied:
                return 0
            if applied and seq != applied + 1:
                raise WalReplayError(
                    f"replica at seq {applied} was shipped seq {seq} — "
                    f"records must arrive without gaps")
            group, before, deltas = decode_unit(payload)
            apply_dict_deltas(self.dicts, before, deltas)
            delta = self.sketch_mirror.delta_of(group)
            batch = concat_batch_parts(group)
            n = batch.n_spans
            gid_lo = self._wp
            gids = np.arange(gid_lo, gid_lo + n, dtype=np.int64)
            spans = self.codec.decode(batch)
            seg = seal_segment(
                self.archive.next_id(), batch, gids, spans,
                self.dicts, self.params, gid_lo, gid_lo + n,
            )
            from zipkin_tpu_torch.store.base import (
                MAX_TTL_ENTRIES,
                prune_ttls,
            )

            for tid in np.unique(batch.trace_id):
                self.ttls.setdefault(int(tid), 1.0)
            prune_ttls(self.ttls, MAX_TTL_ENTRIES)
            with self._rw.write():
                self.archive.append(seg, cache=(batch, gids, spans))
                self.sketch_mirror.apply(delta)
                self._wp += n
                self._applied_seq = seq
                self._step_seq += 1
                self.records_applied += 1
                self.spans_applied += n
                if self.retain_spans:
                    self.archive.drop_below(self._wp - self.retain_spans)
            return n

    def adopt_anchor(self, applied_seq: int, wp: int,
                     dict_values: Dict[str, list],
                     arrays: Sequence[np.ndarray]) -> None:
        """Bootstrap from a primary anchor (replicate/ship.anchor_of):
        adopt the dictionary values in id order and the mirror arrays
        as of ``applied_seq``. The replica's sketch tier is then exact
        from genesis; row/segment coverage starts at the anchor
        (documented in docs/REPLICATION.md)."""
        from zipkin_tpu_torch.wal.record import DICT_NAMES, load_value

        with self._lock:
            for name in DICT_NAMES:
                d = getattr(self.dicts, name)
                values = dict_values.get(name, [])
                for pos, item in enumerate(values):
                    value = load_value(item)
                    if pos < len(d):
                        existing = d.decode(pos + d._first_id)
                        if existing != value:
                            raise WalReplayError(
                                f"anchor dictionary '{name}' entry "
                                f"{pos} is {value!r} but the replica "
                                f"has {existing!r} — wrong lineage")
                        continue
                    got = d.encode(value)
                    if got != pos + d._first_id:
                        raise WalReplayError(
                            f"anchor dictionary '{name}' assigned id "
                            f"{got} for entry {pos} — wrong lineage")
            self.sketch_mirror.adopt(*arrays)
            with self._rw.write():
                self._wp = int(wp)
                self._applied_seq = int(applied_seq)
                self._step_seq += 1

    # -- visibility hooks (ColdQueries) ---------------------------------
    # The mixin defaults (plain directory snapshot/prune) are exactly
    # right here: the replica has no seal barrier to interpose —
    # sealing is synchronous inside apply_record.

    # -- query-engine hooks ---------------------------------------------

    def write_frontier(self) -> Tuple[int, int]:
        with self._rw.read():
            return (self._step_seq, 0)

    def ensure_sketch_mirror(self) -> SketchMirror:
        return self.sketch_mirror

    def _svc_id(self, service_name: str) -> Optional[int]:
        return self.dicts.services.get(service_name.lower())

    # -- sketch-tier reads (mirror ≡ primary device arrays) -------------

    def get_all_service_names(self) -> Set[str]:
        d = self.dicts.services
        with self._rw.read():
            present = self.sketch_mirror.service_presence()
            cold = self.cold_service_ids()
        out = {
            d.decode(i) for i in np.flatnonzero(present)
            if i < len(d) and d.decode(i)
        }
        out.update(
            name for i in cold if i < len(d) and (name := d.decode(i))
        )
        return out

    def get_span_names(self, service: str) -> Set[str]:
        svc = self._svc_id(service)
        if svc is None:
            return set()
        with self._rw.read():
            if svc < self.config.max_services:
                row = self.sketch_mirror.name_row(svc) > 0
                d = self.dicts.span_names
                out = {
                    d.decode(i) for i in np.flatnonzero(row)
                    if i < len(d) and d.decode(i)
                }
            else:
                out = set()
            # Segment rows cover overflow services (no mirror row can
            # represent them) and pre-mirror-anchor names.
            out.update(self.cold_span_names(service))
        return out

    def service_duration_quantiles(self, service: str,
                                   qs: Sequence[float]
                                   ) -> Optional[List[float]]:
        svc = self._svc_id(service)
        if svc is None:
            return None
        c = self.config
        gamma = (1.0 + c.quantile_alpha) / (1.0 - c.quantile_alpha)
        with self._rw.read():
            if svc < c.max_services:
                counts = self.sketch_mirror.hist_row(svc)
            else:
                return self.cold_duration_quantiles(service, qs)
        return Q.quantiles_host(counts, gamma, 1.0, qs)

    @staticmethod
    def _top_row(row, dictionary, k: int):
        order = np.argsort(-row)[:k]
        return [
            (dictionary.decode(int(i)), int(row[i])) for i in order
            if row[i] > 0 and i < len(dictionary)
        ]

    def top_annotations(self, service: str, k: int = 10):
        svc = self._svc_id(service)
        if svc is None or svc >= self.config.max_services:
            return []
        with self._rw.read():
            row = self.sketch_mirror.ann_value_row(svc)
        return self._top_row(row, self.dicts.annotations, k)

    def top_binary_keys(self, service: str, k: int = 10):
        svc = self._svc_id(service)
        if svc is None or svc >= self.config.max_services:
            return []
        with self._rw.read():
            row = self.sketch_mirror.bann_key_row(svc)
        return self._top_row(row, self.dicts.binary_keys, k)

    def estimated_unique_traces(self) -> float:
        with self._rw.read():
            regs = self.sketch_mirror.hll_registers()
        return float(hll.estimate(regs))

    # -- row reads (segments; ColdQueries semantics == memory oracle) ---

    def traces_exist(self, trace_ids: Sequence[int]) -> Set[int]:
        if not trace_ids:
            return set()
        qids = {to_signed64(t): t for t in trace_ids}
        with self._rw.read():
            return self.cold_traces_exist(qids)

    def get_spans_by_trace_ids(self, trace_ids: Sequence[int]
                               ) -> List[List[Span]]:
        if not trace_ids:
            return []
        qids = {to_signed64(t) for t in trace_ids}
        with self._rw.read():
            rows = self.cold_rows_for_traces(qids)
        by_tid = {
            tid: [span for _, span in sorted(found.items())]
            for tid, found in rows.items()
        }
        return [
            by_tid[to_signed64(t)] for t in trace_ids
            if by_tid.get(to_signed64(t))
        ]

    def get_traces_duration(self, trace_ids: Sequence[int]
                            ) -> List[TraceIdDuration]:
        if not trace_ids:
            return []
        canon = {to_signed64(t): t for t in trace_ids}
        with self._rw.read():
            bounds = self.cold_duration_bounds(canon, {})
        return durations_from_bounds(trace_ids, bounds)

    def get_trace_ids_by_name(self, service_name: str,
                              span_name: Optional[str], end_ts: int,
                              limit: int) -> List[IndexedTraceId]:
        with self._rw.read():
            return self._cold_ids_by_name(service_name, span_name,
                                          end_ts, limit)

    def get_trace_ids_by_annotation(self, service_name: str,
                                    annotation: str,
                                    value: Optional[bytes], end_ts: int,
                                    limit: int) -> List[IndexedTraceId]:
        with self._rw.read():
            return self._cold_ids_by_annotation(
                service_name, annotation, value, end_ts, limit)

    def get_time_to_live(self, trace_id: int) -> float:
        with self._lock:
            return self.ttls[to_signed64(trace_id)]

    # -- refused writes --------------------------------------------------

    def apply(self, spans) -> None:
        raise ReplicaReadOnlyError(
            "read replica: writes go to the primary")

    def set_time_to_live(self, trace_id: int, ttl_seconds: float) -> None:
        raise ReplicaReadOnlyError(
            "read replica: pin/TTL mutations go to the primary")

    # -- telemetry / lifecycle ------------------------------------------

    def counters(self) -> Dict[str, float]:
        with self._rw.read():
            out = {
                "replica_applied_seq": float(self._applied_seq),
                "replica_records_applied": float(self.records_applied),
                "replica_spans_applied": float(self.spans_applied),
                "replica_wp": float(self._wp),
            }
        out.update(self.archive.stats())
        out["window_spans"] = float(self.sketch_mirror.win_spans_total)
        out["window_errors"] = float(
            self.sketch_mirror.win_errors_total)
        return out

    def stored_span_count(self) -> float:
        with self._rw.read():
            return float(self.spans_applied)

    def close(self) -> None:
        self.archive.stop_compactor()
        self.archive.close()
