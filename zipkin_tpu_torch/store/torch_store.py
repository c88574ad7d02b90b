"""TorchSpanStore — the SpanStore SPI over the torch device store.

The serial write path and the read API of ``zipkin_tpu.store.tpu.
TpuSpanStore`` on ``store/device.py``: the host owns the dictionaries,
the index policy bits and the chunking, padding and launch planning;
one fused ``ingest_step`` per chunk (a loop of them per chained unit)
updates the device state in place; reads run the index kernels with
the ring scans as exact fallbacks and fetch only the winners.

Both span layouts: ``layout="ring"`` and ``layout="paged"``, where the
host ``PagePlanner`` assigns every span its slot and epoch-encoded gid
in ``_pad_unit``, whole-trace reads go through the page table
(``dev.gather_paged_trace_rows``), and the index reads stay off
because their trust gates are FIFO-gid arithmetic.

The hooks ``_plan_units`` / ``_pad_unit`` / ``_commit_unit`` keep the
reference's names and contracts, and the serial path and the ingest
pipeline (``start_pipeline``, ``store/pipeline.py``) cut identical
launch units through them. Every commit folds its unit's host sketch
delta into ``sketch_mirror`` before the frontier bump; the windowed
reads (``WindowedAnalytics``: ``windowed_quantiles``, ``slo_burn``,
``latency_heatmap``) answer from it.

Durability: with a write-ahead log attached (``attach_wal``), every
planned launch group is journaled before its commit (the kill points
``before-append``, ``after-append`` and ``after-commit`` sit where the
reference has them), and ``_commit_unit`` stamps the applied sequence
with the host clocks under the state lock, so ``checkpoint.save`` cuts
a state, clocks and sequence that belong together and
``wal.recover`` replays the tail through the same commit body.

Eviction capture: with an ``eviction_sink`` attached (a
``store/archive.TieredSpanStore`` attaches its own), every commit first
pulls the rows it would overwrite — on a ring store the whole
uncaptured window [cap_upto, write_pos) once any of the three rings
would lap it (``_maybe_capture``), on a paged store each page its plan
reclaims (``_capture_pages``) — and the sink seals them into a cold
segment, inline or, with ``capture_backlog > 0``, on the
``EvictionSealer`` thread. Not ported yet (later slices): the query
engine, the native thrift fast path, sharding and the daemon.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from zipkin_tpu_torch.columnar.dictionary import DictionarySet
from zipkin_tpu_torch.columnar.encode import SpanCodec, to_signed64
from zipkin_tpu_torch.columnar.schema import SpanBatch
from zipkin_tpu_torch.models.constants import CORE_ANNOTATIONS
from zipkin_tpu_torch.models.dependencies import (
    Dependencies,
    DependencyLink,
    Moments,
)
from zipkin_tpu_torch.models.span import Span
from zipkin_tpu_torch.aggregate import windows as win
from zipkin_tpu_torch.ops import hll
from zipkin_tpu_torch.ops import quantile as Q
from zipkin_tpu_torch.store import device as dev
from zipkin_tpu_torch.store.analytics import WindowedAnalytics
from zipkin_tpu_torch.store.base import (
    MAX_TTL_ENTRIES,
    IndexedTraceId,
    PinBank,
    SpanStore,
    TraceIdDuration,
    apply_pin_merges,
    durations_from_mat,
    escalate_cap,
    exist_from_duration_mat,
    fill_pin,
    gather_with_escalation,
    index_first_topk,
    index_gather_with_escalation,
    index_topk_or_none,
    prune_ttls,
    resolve_annotation_query,
    service_scan_only,
    should_index,
    topk_ids_with_escalation,
)
from zipkin_tpu_torch.store.mirror import SketchMirror
from zipkin_tpu_torch.store.paged import PagePlanner
from zipkin_tpu_torch.store.pipeline import (
    EvictionSealer,
    IngestPipeline,
    IngestUnit,
    fetch_mats,
    unit_batches,
)
from zipkin_tpu_torch.testing.crash import kill_point
from zipkin_tpu_torch.wal.record import (
    dict_sizes,
    dump_dict_deltas,
    encode_unit,
)

_BATCH_MIN = 64


def _next_pow2(n: int) -> int:
    p = _BATCH_MIN
    while p < n:
        p <<= 1
    return p


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def resolve_multi_probes(config, dicts, queries):
    """``get_trace_ids_multi`` queries -> index-bucket probe rows:
    (results, probes, limits, fallback), as in the reference store."""
    lay, _, _ = config.cand_layout
    results = [None] * len(queries)
    fallback: List[int] = []
    probes: List[tuple] = []
    limits = [0] * len(queries)
    for qi, q in enumerate(queries):
        if q[0] == "name":
            _, service, span_name, end_ts, limit = q
            limits[qi] = limit
            svc = dicts.services.get(service.lower())
            if svc is None or limit <= 0:
                results[qi] = []
                continue
            if service_scan_only(svc, config):
                fallback.append(qi)
                continue
            if span_name is not None:
                name_lc = dicts.span_names.get(span_name.lower())
                if name_lc is None:
                    results[qi] = []
                    continue
                probes.append((qi, lay[dev.StoreConfig.CAND_NAME], svc,
                               name_lc, -1, False, False, False, end_ts))
            else:
                probes.append((qi, lay[dev.StoreConfig.CAND_SVC], svc, -1,
                               -1, False, True, False, end_ts))
        else:
            _, service, annotation, value, end_ts, limit = q
            limits[qi] = limit
            if annotation in CORE_ANNOTATIONS or limit <= 0:
                results[qi] = []
                continue
            svc = dicts.services.get(service.lower())
            if svc is None:
                results[qi] = []
                continue
            if service_scan_only(svc, config):
                fallback.append(qi)
                continue
            resolved = resolve_annotation_query(dicts, annotation, value)
            if resolved is None:
                results[qi] = []
                continue
            ann_value, bann_key, bann_value, bann_value2 = resolved
            if ann_value >= 0 and bann_key >= 0:
                fallback.append(qi)
                continue
            if ann_value >= 0:
                probes.append((qi, lay[dev.StoreConfig.CAND_ANN], svc,
                               ann_value, -1, False, False, True, end_ts))
                continue
            fam = lay[dev.StoreConfig.CAND_BANN]
            if bann_value < 0 and bann_value2 < 0:
                probes.append((qi, fam, svc, bann_key, -1, True, False,
                               True, end_ts))
                continue
            v1 = bann_value if bann_value >= 0 else bann_value2
            v2 = bann_value2 if bann_value2 >= 0 else bann_value
            probes.append((qi, fam, svc, bann_key, v1, True, False, True,
                           end_ts))
            if v2 != v1:
                probes.append((qi, fam, svc, bann_key, v2, True, False,
                               True, end_ts))
    return results, probes, limits, fallback


def build_probe_arrays(config, probes, limits):
    """Probe rows -> numpy arrays padded to a power-of-two probe count
    (padding probes match nothing). Returns (arrays, k, k_eff)."""
    lay, _, _ = config.cand_layout
    k = max(1, max(limits[p[0]] for p in probes)) * 8
    n = _next_pow2(len(probes))
    pad_row = (None, lay[dev.StoreConfig.CAND_SVC], 0, -1, -1, False, True,
               False, -1)
    rows = probes + [pad_row] * (n - len(probes))
    arrs = {
        "b_base": np.asarray([r[1][0] for r in rows], np.int64),
        "s_base": np.asarray([r[1][1] for r in rows], np.int64),
        "n_b": np.asarray([r[1][2] for r in rows], np.int64),
        "depth": np.asarray([r[1][3] for r in rows], np.int64),
        "key1": np.asarray([r[2] for r in rows], np.int32),
        "key2": np.asarray([r[3] for r in rows], np.int32),
        "key3": np.asarray([r[4] for r in rows], np.int32),
        "three": np.asarray([r[5] for r in rows], bool),
        "is_svc": np.asarray([r[6] for r in rows], bool),
        "poison_on": np.asarray([r[7] for r in rows], bool),
        "end_ts": np.asarray([r[8] for r in rows], np.int64),
    }
    return arrs, k, min(k, max(fam[3] for fam in lay))


def gate_multi_probes(probes, limits, per_probe):
    """Trust gating of batched probes: {query_idx: ids or None}, None
    meaning the query falls back to its singular path."""
    by_q: Dict[int, list] = {}
    for pi, p in enumerate(probes):
        by_q.setdefault(p[0], []).append(pi)
    out = {}
    for qi, pis in by_q.items():
        cands = []
        complete = True
        wm = -(1 << 62)
        saturated = False
        win_total = 0
        for pi in pis:
            c_, comp_, wm_, sat_ = per_probe[pi]
            cands.extend(c_)
            complete = complete and comp_
            wm = max(wm, wm_)
            saturated |= sat_
            win_total += len(c_) + (0 if sat_ else 1)
        if len(pis) > 1 and saturated:
            out[qi] = None
        else:
            out[qi] = index_topk_or_none(limits[qi], win_total, cands,
                                         complete, wm)
    return out


def name_lc_ids(batch: SpanBatch, dicts: DictionarySet,
                cache: Dict[int, int]) -> np.ndarray:
    """Lowercased span-name dictionary id per span (-1 for empty names)."""
    out = np.empty(batch.n_spans, np.int32)
    for i, nid in enumerate(batch.name_id):
        nid = int(nid)
        lc = cache.get(nid)
        if lc is None:
            name = dicts.span_names.decode(nid)
            lc = -1 if name == "" else dicts.span_names.encode(name.lower())
            cache[nid] = lc
        out[i] = lc
    return out


def _owner_rows(gids: np.ndarray, owner: np.ndarray) -> np.ndarray:
    """Row of each ``owner`` gid in ``gids`` (int32), 0 where absent and
    the last row where a gid repeats — the reference's dict lookup,
    vectorized (a capture window holds millions of rows)."""
    if not gids.size:
        return np.zeros(owner.shape, np.int32)
    order = np.argsort(gids, kind="stable")
    pos = np.searchsorted(gids[order], owner, side="right") - 1
    posc = np.clip(pos, 0, gids.size - 1)
    hit = (pos >= 0) & (gids[order[posc]] == owner)
    return np.where(hit, order[posc], 0).astype(np.int32)


def mats_to_batch(n_s, n_a, n_b, span_mat, ann_mat, bann_mat):
    """(SpanBatch, per-row gids) from the gathered or captured stacked
    matrices (spans in insertion order); the side rows point at their
    span by gid."""
    batch = SpanBatch.empty(n_s, n_a, n_b)
    for i, col in enumerate(dev.SPAN_MAT_COLS[:-1]):
        tgt = getattr(batch, col)
        setattr(batch, col, span_mat[i, :n_s].astype(tgt.dtype))
    gids = span_mat[len(dev.SPAN_MAT_COLS) - 1, :n_s].astype(np.int64)
    if n_a:
        a = {name: ann_mat[i, :n_a]
             for i, name in enumerate(dev.ANN_MAT_COLS)}
        batch.ann_span_idx = _owner_rows(gids, a["ann_gid"])
        batch.ann_ts = a["ann_ts"]
        batch.ann_value_id = a["ann_value_id"].astype(np.int32)
        batch.ann_service_id = a["ann_service_id"].astype(np.int32)
        batch.ann_endpoint_id = a["ann_endpoint_id"].astype(np.int32)
    if n_b:
        b = {name: bann_mat[i, :n_b]
             for i, name in enumerate(dev.BANN_MAT_COLS)}
        batch.bann_span_idx = _owner_rows(gids, b["bann_gid"])
        batch.bann_key_id = b["bann_key_id"].astype(np.int32)
        batch.bann_value_id = b["bann_value_id"].astype(np.int32)
        batch.bann_type = b["bann_type"].astype(np.uint8)
        batch.bann_service_id = b["bann_service_id"].astype(np.int32)
        batch.bann_endpoint_id = b["bann_endpoint_id"].astype(np.int32)
    return batch, gids


def links_from_bank(bank, services_dict, n_services: int
                    ) -> List[DependencyLink]:
    """Decode a [S*S, 5] Moments bank into DependencyLinks."""
    bank = np.asarray(bank, np.float64)
    links = []
    for li in np.flatnonzero(bank[:, 0] > 0):
        parent, child = divmod(int(li), n_services)
        if parent >= len(services_dict) or child >= len(services_dict):
            continue
        links.append(DependencyLink(
            services_dict.decode(parent), services_dict.decode(child),
            Moments.from_central(*bank[li])))
    return links


def dependencies_from_bank(bank, services_dict, n_services: int,
                           ts_min: float, ts_max: float) -> Dependencies:
    links = links_from_bank(bank, services_dict, n_services)
    if not links and ts_min > ts_max:
        return Dependencies.zero()
    return Dependencies(float(ts_min), float(ts_max), tuple(links))


_SPAN_COLS = ("trace_id", "span_id", "parent_id", "name_id", "service_id",
              "ts_cs", "ts_cr", "ts_sr", "ts_ss", "ts_first", "ts_last",
              "duration", "flags")
_ANN_COLS = ("ann_ts", "ann_value_id", "ann_service_id", "ann_endpoint_id")
_BANN_COLS = ("bann_key_id", "bann_value_id", "bann_type",
              "bann_service_id", "bann_endpoint_id")


class TorchSpanStore(WindowedAnalytics, SpanStore):
    """SpanStore over the torch device store. ``device`` defaults to
    ``"cuda"`` and raises when CUDA is missing unless the caller passes
    ``device="cpu"``. ``registry`` takes the ingest pipeline's metrics
    (default: the process-wide ``obs.default_registry()``)."""

    MAX_CHUNK = 4096
    MAX_TTL_ENTRIES = MAX_TTL_ENTRIES
    CHAIN_SIZES = (16, 8, 4)
    SWEEP_EVERY = 64
    DEFAULT_TTL_S = 1.0
    # The ingest pipeline's default prefetch depth and its staged units.
    PIPELINE_DEPTH = 8
    STAGE_BUFFERS = 2
    # Default async-seal backlog: 0 seals inline on the write path (the
    # library default, deterministic timing); deployments that want the
    # seal off the critical path set capture_backlog > 0 (the daemon's
    # --capture-backlog does).
    CAPTURE_BACKLOG = 0

    def __init__(self, config: Optional[dev.StoreConfig] = None,
                 codec: Optional[SpanCodec] = None, device="cuda",
                 registry=None):
        self.config = config or dev.StoreConfig()
        self.device = dev.resolve_device(device)
        self.codec = codec or SpanCodec()
        self.state = dev.init_state(self.config, self.device)
        self._registry = registry
        # Pipelined ingest (store/pipeline.py), opt-in through
        # start_pipeline(): apply() becomes stage 1 and the pipeline's
        # commit thread is the only device writer.
        self._pipeline: Optional[IngestPipeline] = None
        # Host twins of the device aggregates and the windowed arena,
        # folded by every commit (store/mirror.py); the dictionaries
        # resolve the "error" ids of the window cells' error counts.
        self.sketch_mirror = SketchMirror(self.config,
                                          dicts=self.codec.dicts)
        # Paged layout: the host page allocator plans every unit's slots
        # and gids (``slot == gid % capacity`` still holds, so the ring
        # scans stay layout-blind).
        self._planner = (PagePlanner(self.config)
                         if self.config.paged_enabled else None)
        # Writers serialize on _lock; _state_lock guards the in-place
        # state against a concurrent reader (both re-entrant).
        self._lock = threading.RLock()
        self._state_lock = threading.RLock()
        self._wp = 0
        self._archived = 0
        self._batches_since_sweep = 0
        # Eviction capture (cold tier, store/archive): with a sink
        # attached, the write path pulls every ring row BEFORE any of the
        # three rings can overwrite it. _awp/_bwp mirror the side rings'
        # write cursors (host-side, no device sync); a capture window is
        # [_cap_upto, _wp) with exactly _awp - _cap_a annotation and
        # _bwp - _cap_b binary rows (a batch's side rows belong to its
        # own spans). sink(batch, gids, gid_lo, gid_hi, pull_seconds).
        # Checkpoints carry every clock.
        self.eviction_sink = None
        self._awp = 0
        self._bwp = 0
        self._cap_upto = 0  # guarded-by: _cap_lock
        self._cap_a = 0  # guarded-by: _cap_lock
        self._cap_b = 0  # guarded-by: _cap_lock
        # Async sealing (store/pipeline.EvictionSealer): with
        # capture_backlog > 0 the write path only PULLS a window and the
        # sealer thread copies, decodes and seals it. _sealed_upto trails
        # _cap_upto by the windows in flight; checkpoints cut at it.
        # _cap_lock serializes window capture between the serial writer
        # (under _lock) and the pipeline's commit thread, and is taken
        # BEFORE _state_lock (the pull reads the state). _sealed_upto has
        # a leaf lock of its own: checkpoint.save waits for the sealer
        # while it holds _state_lock, and a commit thread can hold
        # _cap_lock while it waits for _state_lock, so a sealer that
        # needed _cap_lock to publish its frontier would deadlock them.
        self.capture_backlog = self.CAPTURE_BACKLOG
        self._sealer: Optional[EvictionSealer] = None
        self._sealed_upto = 0  # guarded-by: _seal_lock
        self._cap_lock = threading.Lock()
        self._seal_lock = threading.Lock()
        # Durable write-ahead log (wal/): when attached, every planned
        # launch group is journaled (stage-1 output + dictionary delta)
        # BEFORE its commit; _wal_applied is the highest sequence whose
        # unit has committed (stamped under _state_lock with the step,
        # so a checkpoint cut reads a sequence consistent with the
        # state), _wal_marks the dictionary sizes of the last record.
        self.wal = None
        self._wal_applied = 0
        self._wal_marks = None
        self._step_seq = 0
        self._read_epoch = 0
        self._cblock_memo = None
        self._svc_scan_memo = None
        self.ttls: Dict[int, float] = {}
        self.pins = PinBank()
        self.anns_truncated = 0
        self.banns_truncated = 0
        self.index_hits = 0
        self.index_fallbacks = 0
        self._name_lc: Dict[int, int] = {}

    @property
    def dicts(self) -> DictionarySet:
        return self.codec.dicts

    @property
    def _index_reads(self) -> bool:
        """Whether reads may take the index fast paths. Off on a paged
        store: their trust gates (wm < write_pos - capacity) are FIFO-gid
        arithmetic, unsound against epoch-encoded gids, so id lookups
        take the exact ring scans (the index writes still run)."""
        return self.config.use_index and self._planner is None

    # -- writes ---------------------------------------------------------

    def _name_lc_ids(self, batch: SpanBatch) -> np.ndarray:
        return name_lc_ids(batch, self.dicts, self._name_lc)

    def apply(self, spans: Sequence[Span]) -> None:
        if not spans:
            return
        with self._lock:
            for span in spans:
                self.ttls.setdefault(to_signed64(span.trace_id), 1.0)
            if self.pins:
                self._bump_read_epoch()
            self.pins.note_write(to_signed64, spans)
            self._prune_ttls()
            if self._pipeline is not None:
                self._apply_pipelined(spans)
                return
            parts = []
            for part in self._chunk_by_trace(spans):
                batch = self.codec.encode(part)
                indexable = np.fromiter((should_index(s) for s in part),
                                        bool, len(part))
                parts.extend(self._chunk_columnar(
                    batch, self._name_lc_ids(batch), indexable))
                if len(parts) >= self.CHAIN_SIZES[0]:
                    self._write_parts(parts)
                    parts = []
            if parts:
                self._write_parts(parts)

    def _apply_pipelined(self, spans: Sequence[Span]) -> None:
        """Stage 1 of the ingest pipeline (caller thread, under the
        encode lock): encode, index bits, sketch delta and padding,
        feeding the prefetch queue. The chunk flush boundary, the
        CHAIN_SIZES grouping and the pads are the serial path's, so both
        modes cut the same launch units."""
        pipe = self._pipeline
        self.ensure_writable()
        t0 = time.perf_counter()
        stalled = 0.0
        parts = []
        for part in self._chunk_by_trace(spans):
            batch = self.codec.encode(part)
            indexable = np.fromiter((should_index(s) for s in part), bool,
                                    len(part))
            parts.extend(self._chunk_columnar(
                batch, self._name_lc_ids(batch), indexable))
            if len(parts) >= self.CHAIN_SIZES[0]:
                stalled += self._feed_units(pipe, parts)
                parts = []
        if parts:
            stalled += self._feed_units(pipe, parts)
        pipe.h_encode.observe(max(time.perf_counter() - t0 - stalled, 0.0))

    def _feed_units(self, pipe: IngestPipeline, parts) -> float:
        """Pad and enqueue one flushed part list as launch units; returns
        the seconds spent blocked on the pipeline's backpressure. With a
        WAL attached each group is journaled here, on the stage-1
        caller thread under the encode lock, so append order equals
        feed order equals commit order."""
        stalled = 0.0
        for group in self._plan_units(parts):
            stalled += pipe.feed(self._journaled_unit(group))
        return stalled

    def _journaled_unit(self, group) -> IngestUnit:
        """Journal one planned group (when a WAL is attached), then pad
        it into its launch unit carrying the record's sequence. Journal
        BEFORE padding: a paged store's planner keys its claim plan to
        the sequence inside _pad_unit, so a checkpoint's planner
        snapshot never holds a plan without its seq."""
        seq = self._journal_group(group) if self.wal is not None else None
        unit = self._pad_unit(group, wal_seq=seq)
        if seq is None:
            return unit
        kill_point("after-append")
        return unit._replace(wal_seq=seq)

    def _prune_ttls(self) -> None:
        prune_ttls(self.ttls, self.MAX_TTL_ENTRIES)

    def _chunk_by_trace(self, spans: Sequence[Span]):
        chunk_size = self._max_chunk_spans()
        by_trace: Dict[int, List[Span]] = {}
        for s in spans:
            by_trace.setdefault(s.trace_id, []).append(s)
        batch: List[Span] = []
        for trace_spans in by_trace.values():
            if batch and len(batch) + len(trace_spans) > chunk_size:
                yield batch
                batch = []
            batch.extend(trace_spans)
            while len(batch) > chunk_size:
                yield batch[:chunk_size]
                batch = batch[chunk_size:]
        if batch:
            yield batch

    def _span_budget(self) -> int:
        """One launch unit's span bound: capacity//2, the bucket-close
        cadence; capacity//8 on a paged store, which keeps a unit's page
        demand under half the pool, so the allocator always finds a
        victim page the unit has not touched."""
        c = self.config
        return max(1, c.capacity // (8 if c.paged_enabled else 2))

    def _max_chunk_spans(self) -> int:
        c = self.config
        limit = c.batch_spans if c.batch_spans > 0 else self.MAX_CHUNK
        return max(1, min(limit, self._span_budget(), c.pending_slots))

    def _chunk_columnar(self, batch: SpanBatch, name_lc: np.ndarray,
                        indexable: np.ndarray):
        """Split a columnar batch so every chunk fits the rings."""
        c = self.config
        max_spans = self._max_chunk_spans()
        if (batch.n_spans <= max_spans
                and batch.n_annotations <= c.ann_capacity
                and batch.n_binary <= c.bann_capacity):
            yield batch, name_lc, indexable
            return
        start = 0
        while start < batch.n_spans:
            stop = min(start + max_spans, batch.n_spans)
            while stop > start + 1:
                a_n = int(np.count_nonzero(
                    (batch.ann_span_idx >= start)
                    & (batch.ann_span_idx < stop)))
                b_n = int(np.count_nonzero(
                    (batch.bann_span_idx >= start)
                    & (batch.bann_span_idx < stop)))
                if a_n <= c.ann_capacity and b_n <= c.bann_capacity:
                    break
                stop = start + (stop - start) // 2
            part = self._slice_batch(batch, start, stop)
            if part.n_annotations > c.ann_capacity:
                self.anns_truncated += part.n_annotations - c.ann_capacity
                part = self._truncate_anns(part, c.ann_capacity, False)
            if part.n_binary > c.bann_capacity:
                self.banns_truncated += part.n_binary - c.bann_capacity
                part = self._truncate_anns(part, c.bann_capacity, True)
            yield part, name_lc[start:stop], indexable[start:stop]
            start = stop

    @staticmethod
    def _truncate_anns(batch: SpanBatch, cap: int, binary: bool):
        import dataclasses

        cols = SpanBatch.BANN_COLUMNS if binary else SpanBatch.ANN_COLUMNS
        return dataclasses.replace(
            batch, **{c: getattr(batch, c)[:cap] for c in cols})

    @staticmethod
    def _select_batch(batch: SpanBatch, keep: np.ndarray) -> SpanBatch:
        """Columnar selection of arbitrary span rows (bool mask) with
        their annotation rows, span indices rebased."""
        idx = np.flatnonzero(keep)
        remap = np.full(batch.n_spans, -1, np.int32)
        remap[idx] = np.arange(idx.size, dtype=np.int32)
        a_sel = (keep[batch.ann_span_idx] if batch.n_annotations
                 else np.zeros(0, bool))
        b_sel = (keep[batch.bann_span_idx] if batch.n_binary
                 else np.zeros(0, bool))
        out = SpanBatch.empty(idx.size, int(a_sel.sum()), int(b_sel.sum()))
        for col in _SPAN_COLS:
            setattr(out, col, getattr(batch, col)[idx])
        out.ann_span_idx = remap[batch.ann_span_idx[a_sel]]
        for col in _ANN_COLS:
            setattr(out, col, getattr(batch, col)[a_sel])
        out.bann_span_idx = remap[batch.bann_span_idx[b_sel]]
        for col in _BANN_COLS:
            setattr(out, col, getattr(batch, col)[b_sel])
        return out

    @staticmethod
    def _slice_batch(batch: SpanBatch, start: int, stop: int) -> SpanBatch:
        a_sel = (batch.ann_span_idx >= start) & (batch.ann_span_idx < stop)
        b_sel = (batch.bann_span_idx >= start) & (batch.bann_span_idx < stop)
        out = SpanBatch.empty(stop - start, int(a_sel.sum()),
                              int(b_sel.sum()))
        for col in _SPAN_COLS:
            setattr(out, col, getattr(batch, col)[start:stop])
        out.ann_span_idx = batch.ann_span_idx[a_sel] - start
        for col in _ANN_COLS:
            setattr(out, col, getattr(batch, col)[a_sel])
        out.bann_span_idx = batch.bann_span_idx[b_sel] - start
        for col in _BANN_COLS:
            setattr(out, col, getattr(batch, col)[b_sel])
        return out

    def write_batch(self, batch: SpanBatch, indexable: np.ndarray) -> None:
        """Upload one columnar batch and run the fused ingest step. The
        batch must fit the rings (``apply`` chunks; callers of this
        method must). Raises while an ingest pipeline runs: its commit
        thread is then the only device writer."""
        if self._pipeline is not None:
            raise RuntimeError(
                "write_batch commits inline and cannot run while an "
                "ingest pipeline is active; use apply() or "
                "stop_pipeline() first")
        c = self.config
        if (batch.n_spans > min(c.capacity, c.pending_slots)
                or batch.n_annotations > c.ann_capacity
                or batch.n_binary > c.bann_capacity):
            raise ValueError(
                f"batch ({batch.n_spans} spans / {batch.n_annotations} "
                f"anns / {batch.n_binary} banns) exceeds ring capacity "
                f"({min(c.capacity, c.pending_slots)}/{c.ann_capacity}/"
                f"{c.bann_capacity}); split into smaller batches")
        with self._lock:
            self._commit_group([(batch, self._name_lc_ids(batch),
                                 indexable)])

    def _write_parts(self, parts) -> None:
        for group in self._plan_units(parts):
            self._commit_group(group)

    def _commit_group(self, group) -> None:
        """Journal (when a WAL is attached) then commit one planned
        launch group — the serial path's ack-after-append point: by the
        time the step runs, the group's record is in the log, so a crash
        between append and commit replays the group instead of losing
        it."""
        if self.wal is not None:
            kill_point("before-append")
        self._commit_unit(self._journaled_unit(group))
        kill_point("after-commit")

    def _plan_units(self, parts):
        """CHAIN_SIZES greedy grouping of chunker parts into launch
        units; spans bounded by _span_budget, side rows by their ring
        capacities."""
        c = self.config
        span_budget = self._span_budget()
        i = 0
        n = len(parts)
        while i < n:
            took = 1
            for size in self.CHAIN_SIZES:
                if i + size > n:
                    continue
                group = parts[i:i + size]
                if (sum(p[0].n_spans for p in group) <= span_budget
                        and sum(p[0].n_annotations for p in group)
                        <= max(1, c.ann_capacity)
                        and sum(p[0].n_binary for p in group)
                        <= max(1, c.bann_capacity)):
                    yield group
                    took = size
                    break
            else:
                yield parts[i:i + 1]
            i += took

    def _pad_unit(self, group, wal_seq: Optional[int] = None
                  ) -> IngestUnit:
        """Pad one planned group to its pow2 buckets (host numpy);
        chained groups pad every chunk to the group max and stack. The
        unit carries its sketch-mirror delta and, with the window on,
        each span's error bit (a pure function of the batch and the
        dictionaries). On a paged store the planner plans the unit's
        slot and gid claims here, in feed order, keyed to ``wal_seq``;
        WAL replay passes the seq of a unit the checkpoint already
        planned and gets the recorded plan back. Every chunk's reclaim
        list pads to one pow2 length across the unit."""
        sketch = self.sketch_mirror.delta_of(group)
        if self.config.window_enabled:
            ea, eb = win.error_ids(self.dicts)

            def err_of(b):
                return win.span_error_flags(b, ea, eb)
        else:
            def err_of(b):
                return None
        chunks = [None] * len(group)
        pad_rc = 1
        reclaims = ()
        if self._planner is not None:
            plan = self._planner.plan_unit(
                [np.asarray(b.trace_id) for b, _, _ in group],
                wal_seq=wal_seq)
            chunks = plan.chunks
            reclaims = plan.reclaims
            pad_rc = _next_pow2(max(
                [1] + [len(cp.reclaim_pages) for cp in chunks]))

        def paged_cols(cp):
            if cp is None:
                return {}
            return dict(span_slot=cp.span_slot, span_gid=cp.span_gid,
                        reclaim_pages=cp.reclaim_pages,
                        pad_reclaims=pad_rc)

        if len(group) == 1:
            b, lc, ix = group[0]
            db = dev.make_device_batch(
                b, name_lc_id=lc, indexable=ix,
                pad_spans=_next_pow2(b.n_spans),
                pad_anns=_next_pow2(b.n_annotations),
                pad_banns=_next_pow2(b.n_binary), error_flag=err_of(b),
                **paged_cols(chunks[0]))
            return IngestUnit(db, b.n_spans, b.n_annotations, b.n_binary,
                              1, False, sketch=sketch, reclaims=reclaims)
        pad_s = _next_pow2(max(b.n_spans for b, _, _ in group))
        pad_a = _next_pow2(max(b.n_annotations for b, _, _ in group))
        pad_b = _next_pow2(max(b.n_binary for b, _, _ in group))
        dbs = [dev.make_device_batch(b, name_lc_id=lc, indexable=ix,
                                     pad_spans=pad_s, pad_anns=pad_a,
                                     pad_banns=pad_b, error_flag=err_of(b),
                                     **paged_cols(cp))
               for (b, lc, ix), cp in zip(group, chunks)]
        return IngestUnit(
            dev.stack_device_batches(dbs),
            sum(b.n_spans for b, _, _ in group),
            sum(b.n_annotations for b, _, _ in group),
            sum(b.n_binary for b, _, _ in group), len(group), True,
            sketch=sketch, reclaims=reclaims)

    def _commit_unit(self, unit: IngestUnit) -> None:
        """The device commit behind both write modes (inline under
        ``_lock`` on the serial path; alone on the pipeline's commit
        thread): eviction-capture trigger, bucket-close trigger, the
        in-place step(s), the sketch mirror fold, host clocks and the
        sweep cadence. A unit the pipeline staged brings its device
        batches; the step waits for their copy. Capture comes first:
        a ring store pulls the uncaptured window once the unit would
        lap it; a paged unit's step invalidates the pages it reclaims,
        so their rows are pulled before it (page-granular capture; the
        ring trigger's [cap_upto, wp) arithmetic is FIFO-gid
        arithmetic and stays off)."""
        self.ensure_writable()
        if self._planner is not None:
            if unit.reclaims:
                self._capture_pages(unit.reclaims)
        else:
            self._maybe_capture(unit.n_spans, unit.n_anns, unit.n_banns)
        self._maybe_archive(unit.n_spans)
        if unit.staged is None:
            batches = [dev.batch_to_device(b, self.device)
                       for b in unit_batches(unit)]
        else:
            batches, buf, done = unit.staged
            dev.await_staged(buf, done, self.device)
        with self._state_lock:
            dev.ingest_steps(self.state, batches)
            # The mirror before the frontier bump: a read at frontier F
            # already sees commit F's delta.
            if unit.sketch is not None:
                self.sketch_mirror.apply(unit.sketch)
            # The host clocks and the applied WAL sequence advance in the
            # same hold as the step: a checkpoint's gather (under this
            # lock) pairs the device cut with exactly these clocks.
            self._wp += unit.n_spans
            self._awp += unit.n_anns
            self._bwp += unit.n_banns
            if unit.wal_seq is not None:
                self._wal_applied = unit.wal_seq
            self._step_seq += 1
            self._batches_since_sweep += unit.n_parts
            if self._batches_since_sweep >= self.SWEEP_EVERY:
                dev.dep_sweep(self.state)
                self._step_seq += 1
                self._batches_since_sweep = 0

    def _sweep_pending(self) -> None:
        self.ensure_writable()
        with self._state_lock:
            dev.dep_sweep(self.state)
            self._step_seq += 1
            self._batches_since_sweep = 0

    def _maybe_archive(self, incoming: int) -> None:
        """Close the dependency time bucket once per half ring."""
        cap = self.config.capacity
        if self._wp + incoming - self._archived <= cap:
            return
        with self._state_lock:
            dev.dep_close_bucket(self.state)
            self._step_seq += 1
            self._batches_since_sweep = 0
            self._archived = min(self._wp, max(self._wp + incoming - cap,
                                               self._wp - cap // 2))

    # -- eviction capture (cold tier, store/archive) --------------------

    def _maybe_capture(self, n_s: int, n_a: int, n_b: int) -> None:
        """Eviction capture trigger, called BEFORE every device write
        with the incoming row counts: if the write would overwrite any
        uncaptured row of ANY of the three rings (the annotation rings
        lap faster than the span ring whenever spans average more side
        rows than the capacity ratio), pull the whole uncaptured window
        [_cap_upto, _wp) and hand it to the sink. The pull is its own
        read-only launch; the ingest step is unchanged."""
        if self.eviction_sink is None:
            return
        c = self.config
        with self._cap_lock:
            if (self._wp + n_s - self._cap_upto <= c.capacity
                    and self._awp + n_a - self._cap_a <= c.ann_capacity
                    and self._bwp + n_b - self._cap_b
                    <= c.bann_capacity):
                return
            self._capture_window()

    def _capture_window(self) -> None:  # called-under: _cap_lock
        """Pull the whole uncaptured window [cap_upto, wp) — the one
        capture body behind the write-path trigger and capture_now.
        The pull is synchronous (the overwriting step must not run
        before it has read the rows); with capture_backlog > 0 the rows
        stay on the device and the copy, decode and seal move to the
        sealer thread, whose bounded queue is the only thing that can
        stall ingest."""
        lo, hi = self._cap_upto, self._wp
        if hi <= lo:
            self._cap_upto, self._cap_a, self._cap_b = (
                self._wp, self._awp, self._bwp)
            return
        t0 = time.perf_counter()
        pulled = self._pull_evicted_rows(lo, hi, self._awp - self._cap_a,
                                         self._bwp - self._cap_b)
        self._hand_off(pulled, lo, hi, t0)
        # Clocks advance only AFTER the pull succeeds: a transient
        # device error mid-pull leaves the window uncaptured but
        # resident, and the next write retries it. (An async seal
        # failure after a good pull is counted and re-raised on the
        # write path; its window cannot be retried, and checkpoints cut
        # at the SEALED frontier so a snapshot never claims it.)
        self._cap_upto, self._cap_a, self._cap_b = (
            self._wp, self._awp, self._bwp)

    def _capture_pages(self, reclaims) -> None:
        """Paged eviction capture: pull each reclaimed page's rows (one
        [lo, hi) = one page's gid range) through the ring window's
        pull and seal, before the claiming unit's launch. The sealed
        frontier stays contiguity-gated: least-recently-written reclaim
        hands pages back out of gid order, so the frontier lags the
        newest sealed page until the live pages below it are reclaimed
        too (a checkpoint never claims a live page's gids as cold)."""
        if self.eviction_sink is None:
            return
        c = self.config
        with self._cap_lock:
            for lo, hi in reclaims:
                t0 = time.perf_counter()
                pulled = self._pull_evicted_rows(lo, hi, c.page_rows * 2,
                                                 c.page_rows)
                self._hand_off(pulled, lo, hi, t0)

    def _hand_off(self, pulled, lo: int, hi: int,
                  t0: float) -> None:  # called-under: _cap_lock
        """Seal one pulled window: queue it on the sealer when
        capture_backlog > 0, else copy, seal and advance the sealed
        frontier inline."""
        n_s, n_a, n_b, s_m, a_m, b_m = pulled
        pull_s = time.perf_counter() - t0
        if self.capture_backlog and self.capture_backlog > 0:
            if self._sealer is None:
                self._sealer = EvictionSealer(
                    self, backlog=self.capture_backlog,
                    registry=self._registry)
            self._sealer.submit(n_s, n_a, n_b, s_m, a_m, b_m, lo, hi,
                                pull_s)
            return
        batch, gids = mats_to_batch(n_s, n_a, n_b,
                                    *fetch_mats((s_m, a_m, b_m)))
        kill_point("mid-seal")
        self.eviction_sink(batch, gids, lo, hi, time.perf_counter() - t0)
        self._note_sealed(lo, hi)

    def _pull_evicted_rows(self, lo: int, hi: int, n_anns: int,
                           n_banns: int):
        """One capture window as (n_s, n_a, n_b, span_mat, ann_mat,
        bann_mat), the matrices still on the device: only the [3]
        counts sync. The host mirrors predict the side-row counts
        exactly; the escalation loop guards, it is not the steady
        state."""
        c = self.config
        k_s = min(_next_pow2(hi - lo), c.capacity)
        k_a = min(_next_pow2(max(n_anns, 1)), c.ann_capacity)
        k_b = min(_next_pow2(max(n_banns, 1)), c.bann_capacity)
        while True:
            with self._state_lock:
                counts, s_m, a_m, b_m = dev.capture_eviction_rows(
                    self.state, lo, hi, k_s, k_a, k_b)
                n_s, n_a, n_b = (int(x) for x in counts.tolist())
            if n_s <= k_s and n_a <= k_a and n_b <= k_b:
                return n_s, n_a, n_b, s_m, a_m, b_m
            k_s = escalate_cap(n_s, k_s, c.capacity)
            k_a = escalate_cap(n_a, k_a, c.ann_capacity)
            k_b = escalate_cap(n_b, k_b, c.bann_capacity)

    def _note_sealed(self, lo: int, hi: int) -> None:
        """Advance the sealed frontier — every gid below it is in the
        cold tier. Contiguity-gated: if an earlier window's seal failed
        (a hole), the frontier stays below it as later windows seal, so
        a checkpoint cut never claims the hole and a restore re-captures
        what of it the saved rings still hold."""
        with self._seal_lock:
            if lo <= self._sealed_upto:
                self._sealed_upto = max(self._sealed_upto, hi)

    def sealed_frontier(self) -> int:
        """Cold-tier durability frontier (gid): every span below it is
        sealed into a cold segment."""
        with self._seal_lock:
            return self._sealed_upto

    def seal_barrier(self) -> None:
        """Wait until every pulled capture window is sealed (no-op
        without an async sealer); re-raises a parked seal error.
        Cold-tier reads and checkpoint cuts run behind it, so a
        captured row is never invisible."""
        s = self._sealer
        if s is not None:
            s.drain()

    def capture_now(self) -> None:
        """Flush the uncaptured window [cap_upto, write_pos) through the
        eviction sink and wait for the seal: checkpoint restore uses it
        to re-align the capture clocks, operators to make the cold tier
        current before a planned shutdown. A paged store captures at
        reclaim time only (live pages are never flushed early), so it
        only drains."""
        with self._lock:
            if self.eviction_sink is None:
                return
            self.drain_pipeline()
            if self._planner is None:
                with self._cap_lock:
                    self._capture_window()
            self.seal_barrier()

    def eviction_sealer(self) -> Optional[EvictionSealer]:
        """The async capture sealer, or None when sealing is inline."""
        return self._sealer

    def archive_now(self) -> None:
        with self._lock, self._state_lock:
            dev.dep_close_bucket(self.state)
            self._step_seq += 1
            self._archived = self._wp
            self._batches_since_sweep = 0

    def adopt_state(self, state: dev.StoreState, spans_written: int,
                    archived: Optional[int] = None) -> None:
        """Adopt a device state produced outside the store's write path
        (for example a benchmark driving ``dev.ingest_step`` directly)
        and re-seed the host clocks: ``spans_written`` is the state's
        write_pos (it seeds the archive cadence), ``archived`` the span
        watermark of the last bucket close (default: "just rotated").
        The sweep clock is marked dirty, so the first dependency read
        runs a pending sweep; the sketch mirror goes cold and resyncs
        from the device on its next read; a paged store rebuilds its
        page table from the adopted columns. Pulled capture windows are
        sealed first (the seal barrier); the adopted history predates
        the sink, so only later evictions are captured."""
        self.drain_pipeline()
        self.seal_barrier()
        self.ensure_writable()
        with self._lock, self._cap_lock, self._state_lock:
            self.state = state
            self._step_seq += 1
            self._wp = int(spans_written)
            self._archived = self._wp if archived is None else int(archived)
            self._batches_since_sweep = 1
            self._awp = self._bwp = 0
            self._cap_upto = self._wp
            self._cap_a = self._cap_b = 0
            with self._seal_lock:
                self._sealed_upto = self._cap_upto
            self.sketch_mirror.mark_cold()
            if self._planner is not None:
                self._planner.rebuild(_np(state.row_gid),
                                      _np(state.trace_id),
                                      wal_applied=self._wal_applied)

    # -- durable write-ahead log (wal/) ---------------------------------

    def attach_wal(self, wal) -> None:
        """Journal every later launch group into ``wal`` before its
        commit (the ack-after-append contract). Attach before live
        writes: groups committed earlier are covered only by
        checkpoints. The store does not own the log: callers close() it
        after the store. The lineage tracker (``attach_lineage``) comes
        with the fleet observability slice."""
        with self._lock:
            self.wal = wal
            self._wal_marks = dict_sizes(self.dicts)

    def _journal_group(self, group) -> int:
        """Append one planned launch group (+ the dictionary entries its
        encode step added) to the WAL; returns the record's sequence.
        Runs on the encoding thread under ``_lock``, so append order ==
        encode order == commit order — the property replay's
        dictionary-delta chain depends on."""
        sizes, deltas = dump_dict_deltas(self.dicts, self._wal_marks)
        seq = self.wal.append(encode_unit(group, self._wal_marks, deltas))
        self._wal_marks = sizes
        return seq

    def wal_sync(self) -> None:
        """Force the attached WAL's durable frontier to its append
        frontier (fsync); no-op without a WAL. Shutdown order:
        drain the pipeline, wal_sync, checkpoint."""
        if self.wal is not None:
            self.wal.sync()

    # -- pipelined ingest lifecycle (store/pipeline.py) -----------------

    def start_pipeline(self, depth: Optional[int] = None) -> IngestPipeline:
        """Switch the write path to the three-stage ingest pipeline:
        apply() becomes stage 1, a stage thread copies units to the
        device (``STAGE_BUFFERS`` in flight), a commit thread runs the
        steps. ``depth`` bounds the prefetch queue
        (writer backpressure). Reads see a consistent, possibly a few
        units stale state until drain_pipeline()."""
        with self._lock:
            if self._pipeline is not None:
                raise RuntimeError("ingest pipeline already running")
            self._pipeline = IngestPipeline(
                self, depth or self.PIPELINE_DEPTH, self.STAGE_BUFFERS,
                registry=self._registry)
            return self._pipeline

    def drain_pipeline(self) -> None:
        """Block until every accepted unit is committed (no-op without a
        pipeline); re-raises a parked pipeline error. After it returns,
        reads see everything apply() accepted before the call."""
        p = self._pipeline
        if p is not None:
            p.drain()

    def stop_pipeline(self, raise_errors: bool = True) -> None:
        """Drain, stop the pipeline's threads and return to the serial
        write path. The quiesce runs under the encode lock with the
        pipeline still published, so no writer can fall through to the
        serial path while the commit thread still has units."""
        with self._lock:
            p = self._pipeline
            if p is None:
                return
            p.stop()
            self._pipeline = None
        err = p.take_error()
        if raise_errors and err is not None:
            raise err

    def ingest_pipeline(self) -> Optional[IngestPipeline]:
        """The running ingest pipeline, or None on the serial path."""
        return self._pipeline

    @contextlib.contextmanager
    def pipelined(self, depth: Optional[int] = None):
        """Scoped pipelined ingest: ``with store.pipelined(8): ...``;
        drains and stops on exit (re-raising any parked error)."""
        pipe = self.start_pipeline(depth)
        try:
            yield pipe
        finally:
            self.stop_pipeline()

    def close(self) -> None:
        """Stop the pipeline (committing every accepted unit, which may
        capture), then the capture sealer (sealing every pulled
        window): nothing accepted or captured is dropped."""
        self.stop_pipeline(raise_errors=False)
        s, self._sealer = self._sealer, None
        if s is not None:
            s.stop()

    # -- TTL / pins -----------------------------------------------------

    def set_time_to_live(self, trace_id: int, ttl_seconds: float) -> None:
        tid = to_signed64(trace_id)
        with self._lock:
            self.ttls[tid] = ttl_seconds
            self._read_epoch += 1
            pin = ttl_seconds > self.DEFAULT_TTL_S
            if not pin:
                self.pins.unpin(tid)
        if pin:
            fill_pin(self.pins, self._lock, tid, lambda: (
                self.get_spans_by_trace_ids([trace_id]) or [[]])[0])
            with self._lock:
                self._read_epoch += 1

    def _bump_read_epoch(self) -> None:
        self._read_epoch += 1

    def get_time_to_live(self, trace_id: int) -> float:
        with self._lock:
            return self.ttls[to_signed64(trace_id)]

    def write_frontier(self) -> Tuple[int, int]:
        return (self._step_seq, self._read_epoch)

    def ensure_sketch_mirror(self) -> SketchMirror:
        """The sketch mirror, resynced from the device leaves in one
        fetch if a state swap left it cold; incremental deltas keep it
        warm after that. Lock order: the state lock, then the
        mirror's (the commit path takes them in the same order)."""
        m = self.sketch_mirror
        if not m.warm:
            with self._state_lock:
                st = self.state
                m.adopt(*(_np(getattr(st, f)) for f in (
                    "svc_hist", "ann_svc_counts", "name_presence",
                    "ann_value_counts", "bann_key_counts", "hll_traces",
                    "win_epoch", "win_counts", "win_sums", "win_mm")))
        return m

    # -- id lookups -----------------------------------------------------

    def _svc_id(self, service_name: str) -> Optional[int]:
        return self.dicts.services.get(service_name.lower())

    @staticmethod
    def _cands(mat) -> List[Tuple[int, int]]:
        return [(int(t), int(ts))
                for t, ts, v in zip(mat[0], mat[1], mat[2]) if v]

    def _index_fetcher(self, call):
        def fetch(k):
            with self._state_lock:
                mat, complete, wm = call(k)
                mat = _np(mat)
                complete, wm = bool(complete), int(wm)
            return self._cands(mat), complete, wm, mat.shape[1]
        return fetch

    def _scan_fetcher(self, call):
        def fetch(k):
            with self._state_lock:
                mat = _np(call(k))
            cands = self._cands(mat)
            return cands, len(cands) >= k
        return fetch

    def _index_first(self, limit, k_max, index_fetch, scan_fetch):
        return index_first_topk(limit, k_max, index_fetch, scan_fetch,
                                stats=self)

    def get_trace_ids_by_name(self, service_name: str,
                              span_name: Optional[str], end_ts: int,
                              limit: int, force_scan: bool = False
                              ) -> List[IndexedTraceId]:
        svc = self._svc_id(service_name)
        if svc is None or limit <= 0:
            return []
        force_scan = force_scan or service_scan_only(svc, self.config)
        if span_name is not None:
            name_lc = self.dicts.span_names.get(span_name.lower())
            if name_lc is None:
                return []
        else:
            name_lc = -1
        fetch = self._scan_fetcher(lambda k: dev.query_trace_ids_by_service(
            self.state, svc, name_lc, end_ts, k))
        if self._index_reads and not force_scan:
            index_fetch = self._index_fetcher(
                lambda k: dev.iquery_trace_ids_by_service(
                    self.state, svc, name_lc, end_ts, k))
            return self._index_first(limit, self.config.ann_capacity,
                                     index_fetch, fetch)
        return topk_ids_with_escalation(limit, self.config.ann_capacity,
                                        fetch)

    def get_trace_ids_by_annotation(self, service_name: str,
                                    annotation: str, value: Optional[bytes],
                                    end_ts: int, limit: int,
                                    force_scan: bool = False
                                    ) -> List[IndexedTraceId]:
        if annotation in CORE_ANNOTATIONS or limit <= 0:
            return []
        svc = self._svc_id(service_name)
        if svc is None:
            return []
        force_scan = force_scan or service_scan_only(svc, self.config)
        resolved = resolve_annotation_query(self.dicts, annotation, value)
        if resolved is None:
            return []
        ann_value, bann_key, bann_value, bann_value2 = resolved
        args = (svc, ann_value, bann_key, bann_value, bann_value2, end_ts)
        fetch = self._scan_fetcher(
            lambda k: dev.query_trace_ids_by_annotation(self.state, *args,
                                                        k))
        c = self.config
        k_max = c.ann_capacity + c.bann_capacity
        mixed = ann_value >= 0 and bann_key >= 0
        if self._index_reads and not mixed and not force_scan:
            index_fetch = self._index_fetcher(
                lambda k: dev.iquery_trace_ids_by_annotation(
                    self.state, *args, k))
            return self._index_first(limit, k_max, index_fetch, fetch)
        return topk_ids_with_escalation(limit, k_max, fetch)

    def get_trace_ids_multi(self, queries) -> List[List[IndexedTraceId]]:
        """Batched index read: every query's bucket probe in one pass;
        unresolvable keys, mixed names and distrusted buckets drop to
        the singular paths."""
        c = self.config
        if not self._index_reads or not queries:
            return super().get_trace_ids_multi(queries)
        results, probes, limits, fallback = resolve_multi_probes(
            c, self.dicts, queries)
        if probes:
            arrs, k, k_eff = build_probe_arrays(c, probes, limits)
            with self._state_lock:
                mats, completes, wms = (
                    _np(x) for x in dev.iquery_trace_ids_multi(
                        self.state, arrs, k))
            per_probe = []
            for pi, p in enumerate(probes):
                cands = self._cands(mats[pi])
                window_pi = min(k_eff, p[1][3])
                per_probe.append((cands, bool(completes[pi]),
                                  int(wms[pi]), len(cands) >= window_pi))
            for qi, ids in gate_multi_probes(probes, limits,
                                             per_probe).items():
                if ids is None:
                    fallback.append(qi)
                else:
                    self.index_hits += 1
                    results[qi] = ids
        for qi in fallback:
            q = queries[qi]
            if q[0] == "name":
                results[qi] = self.get_trace_ids_by_name(*q[1:])
            else:
                results[qi] = self.get_trace_ids_by_annotation(*q[1:])
        return [r if r is not None else [] for r in results]

    # -- trace reads ----------------------------------------------------

    @staticmethod
    def _canon_ids(trace_ids: Sequence[int]) -> Dict[int, int]:
        return {to_signed64(t): t for t in trace_ids}

    @staticmethod
    def _sorted_qids(trace_ids: Sequence[int]) -> np.ndarray:
        return np.unique(np.asarray([to_signed64(t) for t in trace_ids],
                                    np.int64))

    def _durations_mat(self, qids: np.ndarray,
                       force_scan: bool = False) -> np.ndarray:
        with self._state_lock:
            if self._index_reads and not force_scan:
                mat, exact = dev.iquery_durations(self.state, qids)
                if bool(exact):
                    return _np(mat)
            return _np(dev.query_durations(self.state, qids))

    def traces_exist(self, trace_ids: Sequence[int]) -> Set[int]:
        if not trace_ids:
            return set()
        canon = self._canon_ids(trace_ids)
        qids = self._sorted_qids(trace_ids)
        mat = self._durations_mat(qids)
        return exist_from_duration_mat(canon, qids, mat[0], self.pins,
                                       self._lock)

    def _gather_trace_mats(self, trace_ids: Sequence[int],
                           force_scan: bool = False):
        qids = self._sorted_qids(trace_ids)
        with self._state_lock:
            st = self.state
            payload = None
            if self._planner is not None and not force_scan:
                payload = self._gather_via_pages(st, qids)
            elif self._index_reads and not force_scan:
                def ifetch(k_s, k_a, k_b):
                    counts, s_m, a_m, b_m, exact = \
                        dev.iquery_gather_trace_rows(st, qids, k_s, k_a,
                                                     k_b)
                    n_s, n_a, n_b = (int(x) for x in _np(counts))
                    return (bool(exact), n_s, n_a, n_b,
                            (n_s, n_a, n_b, _np(s_m), _np(a_m), _np(b_m)))

                payload = index_gather_with_escalation(self.config,
                                                       len(qids), ifetch)
            if payload is None:
                def fetch(k_s, k_a, k_b):
                    counts, s_m, a_m, b_m = dev.gather_trace_rows(
                        st, qids, k_s, k_a, k_b)
                    n_s, n_a, n_b = (int(x) for x in _np(counts))
                    return n_s, n_a, n_b, (n_s, n_a, n_b, _np(s_m),
                                           _np(a_m), _np(b_m))

                payload = gather_with_escalation(self.config, fetch)
        return payload

    def _gather_via_pages(self, st, qids: np.ndarray):
        """Whole-trace gather over the queried traces' page chains: the
        read touches K x page_rows candidate rows, not the whole arena.
        Returns None when a chain overflowed page_max_chain; those reads
        take the exact ring scan."""
        chains = self._planner.chains_for(qids)
        if chains is None:
            return None
        pages, epochs = chains
        # Pad the page list to a pow2 count with holes (-1 pages give
        # no rows), as the reference does for its compile cache.
        k = _next_pow2(max(1, len(pages)))
        pg = np.full(k, -1, np.int32)
        ep = np.zeros(k, np.int64)
        pg[:len(pages)] = pages
        ep[:len(epochs)] = epochs

        def fetch(k_s, k_a, k_b):
            counts, s_m, a_m, b_m = dev.gather_paged_trace_rows(
                st, qids, pg, ep, k_s, k_a, k_b)
            n_s, n_a, n_b = (int(x) for x in _np(counts))
            return n_s, n_a, n_b, (n_s, n_a, n_b, _np(s_m), _np(a_m),
                                   _np(b_m))

        return gather_with_escalation(self.config, fetch)

    def get_trace_rows(self, trace_ids: Sequence[int],
                       force_scan: bool = False) -> List[Tuple[int, Span]]:
        """Ring rows of the requested traces as (row gid, Span) pairs in
        insertion order, without pin-bank merging."""
        if not trace_ids:
            return []
        n_s, n_a, n_b, s_m, a_m, b_m = self._gather_trace_mats(
            trace_ids, force_scan)
        if n_s == 0:
            return []
        batch, gids = mats_to_batch(n_s, n_a, n_b, s_m, a_m, b_m)
        return [(int(g), s) for g, s in zip(gids, self.codec.decode(batch))]

    def get_spans_by_trace_ids(self, trace_ids: Sequence[int],
                               force_scan: bool = False) -> List[List[Span]]:
        if not trace_ids:
            return []
        n_s, n_a, n_b, s_m, a_m, b_m = self._gather_trace_mats(
            trace_ids, force_scan)
        spans = []
        if n_s:
            batch, _ = mats_to_batch(n_s, n_a, n_b, s_m, a_m, b_m)
            spans = self.codec.decode(batch)
        by_tid: Dict[int, List[Span]] = {}
        for span in spans:
            by_tid.setdefault(span.trace_id, []).append(span)
        with self._lock:
            apply_pin_merges(self.pins, by_tid, trace_ids, to_signed64)
        return [by_tid[to_signed64(tid)] for tid in trace_ids
                if to_signed64(tid) in by_tid]

    def get_traces_duration(self, trace_ids: Sequence[int],
                            force_scan: bool = False
                            ) -> List[TraceIdDuration]:
        if not trace_ids:
            return []
        canon = self._canon_ids(trace_ids)
        qids = self._sorted_qids(trace_ids)
        mat = self._durations_mat(qids, force_scan)
        return durations_from_mat(trace_ids, canon, qids, mat, self.pins,
                                  self._lock)

    # -- name catalogs --------------------------------------------------

    def get_all_service_names(self) -> Set[str]:
        with self._state_lock:
            present = _np(self.state.ann_svc_counts) > 0
        d = self.dicts.services
        out = {d.decode(i) for i in np.flatnonzero(present)
               if i < len(d) and d.decode(i)}
        S = self.config.max_services
        n_over = len(d) - S
        if n_over > 0:
            pad = 1 << max(0, (n_over - 1)).bit_length()
            with self._state_lock:
                pres = _np(dev.overflow_service_presence(self.state, pad))
            out.update(name for i in np.flatnonzero(pres[:n_over])
                       if (name := d.decode(S + int(i))))
        return out

    def _svc_catalog_scan(self, svc: int):
        key = (svc, self._wp)
        if self._svc_scan_memo is not None and self._svc_scan_memo[0] == key:
            return self._svc_scan_memo[1]
        with self._state_lock:
            rows = tuple(_np(r) for r in dev.svc_scan_catalog(self.state,
                                                               svc))
        self._svc_scan_memo = (key, rows)
        return rows

    def get_span_names(self, service: str) -> Set[str]:
        svc = self._svc_id(service)
        if svc is None:
            return set()
        if service_scan_only(svc, self.config):
            row = self._svc_catalog_scan(svc)[0] > 0
        else:
            with self._state_lock:
                row = _np(self.state.name_presence[svc]) > 0
        d = self.dicts.span_names
        return {d.decode(i) for i in np.flatnonzero(row)
                if i < len(d) and d.decode(i)}

    # -- analytics ------------------------------------------------------

    def get_dependencies(self, start_ts: Optional[int] = None,
                         end_ts: Optional[int] = None) -> Dependencies:
        """DependencyLinks from the banks + the open window, after a
        pending sweep; with a window, only banks overlapping it."""
        if self._batches_since_sweep:
            with self._lock:
                if self._batches_since_sweep:
                    self._sweep_pending()
        S = self.config.max_services
        k = min(S * S, 1 << 14)
        with self._state_lock:
            st = self.state
            if start_ts is None and end_ts is None:
                bank = dev.total_dep_moments(st)
                lo, hi = int(st.ts_min), int(st.ts_max)
            else:
                s = dev.I64_MIN if start_ts is None else int(start_ts)
                e = dev.I64_MAX if end_ts is None else int(end_ts)
                bank = dev.dep_moments_in_range(st, s, e)
                lo, hi = max(int(st.ts_min), s), min(int(st.ts_max), e)
            nz, idx, rows = dev.compact_bank(bank, k)
            if int(nz) > k:
                full = _np(bank)
            else:
                full = np.zeros((S * S, bank.shape[1]), np.float32)
                full[_np(idx)] = _np(rows)
        return dependencies_from_bank(full, self.dicts.services, S,
                                      float(lo), float(hi))

    def service_duration_quantiles(self, service: str, qs: Sequence[float]
                                   ) -> Optional[List[float]]:
        svc = self._svc_id(service)
        if svc is None:
            return None
        if service_scan_only(svc, self.config):
            counts = self._svc_catalog_scan(svc)[1]
        else:
            with self._state_lock:
                counts = _np(self.state.svc_hist[svc])
        return Q.quantiles_host(counts, self.config.gamma, 1.0, qs)

    def _top_row(self, service: str, leaf: str, col: int, dictionary,
                 k: int) -> List[Tuple[str, int]]:
        svc = self._svc_id(service)
        if svc is None:
            return []
        if service_scan_only(svc, self.config):
            row = self._svc_catalog_scan(svc)[col]
        else:
            with self._state_lock:
                row = _np(self.state.leaves[leaf][svc])
        order = np.argsort(-row)[:k]
        return [(dictionary.decode(int(i)), int(row[i])) for i in order
                if row[i] > 0 and i < len(dictionary)]

    def top_annotations(self, service: str, k: int = 10
                        ) -> List[Tuple[str, int]]:
        return self._top_row(service, "ann_value_counts", 2,
                             self.dicts.annotations, k)

    def top_binary_keys(self, service: str, k: int = 10
                        ) -> List[Tuple[str, int]]:
        return self._top_row(service, "bann_key_counts", 3,
                             self.dicts.binary_keys, k)

    def estimated_unique_traces(self) -> float:
        with self._state_lock:
            regs = _np(self.state.hll_traces)
        return hll.estimate(regs)

    def counter_block(self) -> Dict[str, int]:
        """The device counter block, memoized per state mutation."""
        memo = self._cblock_memo
        if memo is not None and memo[0] == self._step_seq:
            return memo[1]
        with self._state_lock:
            vec = _np(dev.counter_block(self.state))
        blk = {n: int(v) for n, v in zip(dev.COUNTER_BLOCK_FIELDS, vec)}
        self._cblock_memo = (self._step_seq, blk)
        return blk

    def counters(self) -> Dict[str, float]:
        out = {k: float(v) for k, v in self.counter_block().items()}
        out["anns_truncated"] = float(self.anns_truncated)
        out["banns_truncated"] = float(self.banns_truncated)
        out["index_hits"] = float(self.index_hits)
        out["index_scan_fallbacks"] = float(self.index_fallbacks)
        out["batch_spans_limit"] = float(self._max_chunk_spans())
        p = self._pipeline
        if p is not None:
            out["pipeline_prefetch_depth"] = float(p.queued())
        s = self._sealer
        if s is not None:
            out["capture_backlog"] = float(s.queued())
        if self._planner is not None:
            pstats = self._planner.stats()
            out["pages_active"] = float(pstats["pages_active"])
            out["pages_free"] = float(pstats["pages_free"])
            out["page_reclaims_total"] = float(pstats["page_reclaims"])
        # Windowed-arena fold totals (host mirror counters, no device
        # traffic).
        out["window_spans"] = float(self.sketch_mirror.win_spans_total)
        out["window_errors"] = float(self.sketch_mirror.win_errors_total)
        return out

    def stored_span_count(self) -> float:
        return float(self.counter_block()["spans_seen"])
