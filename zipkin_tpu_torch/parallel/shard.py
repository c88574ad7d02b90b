"""N store shards on one device, torch side.

The port's copy of ``zipkin_tpu/parallel/shard.py``. The reference
stacks its shard states on a leading ``[n_shards]`` dim sharded over a
device mesh, runs the fused ``ingest_step`` per shard under
``shard_map`` and merges across shards with ICI collectives (``psum``,
``pmax``/``pmin``, ``all_gather`` + a Moments tree-combine). Here the
shards are N independent ``StoreState``s on one device (the H100, or
the CPU when the caller asks), each stepped in place by the port's own
``store/device.ingest_step`` — so every shard's step runs the K1 and K2
kernels — and every collective becomes a torch reduction over the
per-shard results: a sum, a max or a min over ``torch.stack`` of the
shards' leaves (or of a single-state read run once per shard), and
``ops/moments.reduce_moments`` over a stacked ``[n, S*S, 5]`` bank.

The states are a list, never views of one stacked tensor: the step
rebinds leaves rather than writing every one in place, so a state
whose leaves were views ``x[i]`` of a stack would stop aliasing it
after its first step. Reads stack per read, where a merge needs it.

Writes route whole traces to shards by trace-id hash
(``parallel/multihost.shard_of``), so every trace is resident on
exactly one shard and trace-local reads stay local. Every shard steps
on every launch unit, an empty shard on an empty padded batch, as the
reference's one mapped launch steps them all: the per-shard counters,
``ts_min``/``ts_max`` and the sweep cadence advance alike.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from zipkin_tpu_torch import obs
from zipkin_tpu_torch.aggregate import windows as win_mod
from zipkin_tpu_torch.aggregate.job import dependencies_from_bank
from zipkin_tpu_torch.columnar.encode import SpanCodec, to_signed64
from zipkin_tpu_torch.concurrency import RWLock
from zipkin_tpu_torch.models.constants import CORE_ANNOTATIONS
from zipkin_tpu_torch.ops import hll
from zipkin_tpu_torch.ops import moments as M
from zipkin_tpu_torch.ops import quantile as Q
from zipkin_tpu_torch.ops.topk import topk_desc
from zipkin_tpu_torch.parallel.dispatch import CrossShardDispatcher
from zipkin_tpu_torch.parallel.multihost import shard_of
from zipkin_tpu_torch.store import device as dev
from zipkin_tpu_torch.store.analytics import WindowedAnalytics
from zipkin_tpu_torch.store.base import (
    MAX_TTL_ENTRIES,
    PinBank,
    ReadSpanStore,
    SuspectGuard,
    apply_pin_merges,
    durations_from_mat,
    exist_from_duration_mat,
    fill_pin,
    gather_with_escalation,
    index_first_topk,
    index_gather_with_escalation,
    prune_ttls,
    resolve_annotation_query,
    service_scan_only,
    should_index,
    topk_ids_with_escalation,
)
from zipkin_tpu_torch.store.mirror import FleetMirror, SketchMirror
from zipkin_tpu_torch.store.pipeline import IngestPipeline, IngestUnit
from zipkin_tpu_torch.store.torch_store import (
    TorchSpanStore,
    _next_pow2,
    build_probe_arrays,
    gate_multi_probes,
    mats_to_batch,
    name_lc_ids,
    resolve_multi_probes,
)
from zipkin_tpu_torch.wal.record import dict_sizes, dump_dict_deltas

DEP_SUMMARY_K = 1 << 14  # the single-store deps-read compaction bound


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise sum over shards in the leaves' own dtype (int32
    sums wrap as the reference's ``psum`` does)."""
    return torch.stack(list(xs)).sum(0, dtype=xs[0].dtype)


def _max(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(xs)).amax(0)


def _min(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(xs)).amin(0)


def merge_dep_banks(banks: torch.Tensor,
                    dep_k: Optional[int] = DEP_SUMMARY_K) -> torch.Tensor:
    """Merge per-shard dependency banks ``[n, S*S, 5]`` into one.

    Moments combine is associative and commutative but not "+", so
    the banks merge through ``reduce_moments``; their COUNT columns
    sum, and the counts decide which cells are live. Instead of
    combining all S*S cells, sum the counts, take the top ``dep_k``
    live cells (``topk_desc``, the reference's tie rule) and combine
    only those rows — the compaction the single-store deps read uses.
    When more than ``dep_k`` cells are live the compacted bank would
    drop links, so the full combine runs instead; ``dep_k`` None (or at
    least the cell count) always combines in full."""
    cells = banks.shape[1]
    if dep_k is None or dep_k >= cells:
        return M.reduce_moments(banks, axis=0)
    cnt = banks[:, :, 0].sum(0)
    if int((cnt > 0).sum()) > dep_k:
        return M.reduce_moments(banks, axis=0)
    idx = topk_desc(cnt, dep_k)[1]
    out = torch.zeros_like(banks[0])
    out[idx] = M.reduce_moments(banks[:, idx], axis=0)
    return out


def _summarize(states: Sequence[dev.StoreState],
               dep_k: Optional[int] = DEP_SUMMARY_K
               ) -> Dict[str, torch.Tensor]:
    """Cross-shard global aggregates: counters and additive sketches
    sum, HLL registers take the elementwise max, the dependency banks
    merge by ``merge_dep_banks``, the timestamp range by min / max."""
    def leaf(name):
        return [getattr(st, name) for st in states]

    return {
        "spans_seen": _sum([st.counters["spans_seen"] for st in states]),
        "svc_span_counts": _sum(leaf("svc_span_counts")),
        "svc_hist": _sum(leaf("svc_hist")),
        "cms_trace_spans": _sum(leaf("cms_trace_spans")),
        "ann_svc_counts": _sum(leaf("ann_svc_counts")),
        "hll_traces": _max(leaf("hll_traces")),
        "dep_moments": merge_dep_banks(torch.stack(
            [dev.total_dep_moments(st) for st in states]), dep_k),
        "ts_min": _min(leaf("ts_min")),
        "ts_max": _max(leaf("ts_max")),
    }


def global_summary(states: Sequence[dev.StoreState],
                   dep_k: Optional[int] = DEP_SUMMARY_K):
    """One-off cross-shard summary over the shard states (no ingest).
    ``dep_k`` bounds the dependency-bank merge (None = full combine;
    see merge_dep_banks)."""
    return _summarize(states, dep_k)


def stack_batches(batches) -> dev.DeviceBatch:
    """Host: list of n numpy DeviceBatch -> one stacked [n, ...]."""
    return dev.stack_device_batches(batches)


def stacked_incoming(device_batches: dev.DeviceBatch) -> int:
    """Max spans any shard's batch carries, read off a host-stacked
    DeviceBatch (``stack_batches``). Call it OUTSIDE store locks and
    pass the result to ``ShardedStore.ingest``."""
    return int(np.max(device_batches.n_spans))


def shard_device_batches(device_batches: dev.DeviceBatch, device) -> Tuple:
    """One launch unit's host-stacked DeviceBatch as one batch a shard
    on ``device`` (on CUDA all of it in one pinned copy,
    ``device.stage_batches``)."""
    staged, _ = dev.stage_batches(dev.unstack_batches(device_batches),
                                  device)
    return tuple(staged)


class ShardedStore:
    """Host handle for an n-shard store on one device: N independent
    ``StoreState``s, every one stepped on every launch unit.

    ``device`` is CUDA unless the caller passes ``"cpu"``; without a
    card it raises (``device.resolve_device``)."""

    # Same cadence as TorchSpanStore.SWEEP_EVERY: bounds how long a
    # cross-batch child waits for its link in per-ingest summaries.
    SWEEP_EVERY = 64

    def __init__(self, n_shards: int, config: dev.StoreConfig,
                 device="cuda"):
        if config.paged_enabled:
            # The page planner is per-store HOST state; the shard states
            # have no per-shard planner yet (the reference's daemon
            # rejects --layout paged with --shards too).
            raise ValueError(
                "layout='paged' is single-device only; the sharded "
                "store has no per-shard page planner yet")
        self.config = config
        self.n = int(n_shards)
        self.device = dev.resolve_device(device)
        self.states: List[dev.StoreState] = [
            dev.init_state(config, self.device) for _ in range(self.n)]
        self.last_summary = None
        # Host upper bound of any shard's write_pos / lower bound of any
        # shard's last bucket close — paces rotation without device
        # syncs (mirrors TorchSpanStore._maybe_archive).
        self._wp_upper = 0
        self._archived_lower = 0
        self._batches_since_sweep = 0

    def ingest(self, device_batches,
               incoming: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """One launch unit: ``device_batches`` is the host-stacked
        DeviceBatch of one batch a shard (``stack_batches``); returns
        the cross-shard summary.

        ``incoming`` is the max spans any shard's batch carries —
        compute it HOST-SIDE (or via ``stacked_incoming`` outside any
        store lock) and pass it in. It is required, as in the
        reference, so no caller reads it off device batches inside its
        write-lock hold."""
        if incoming is None:
            raise TypeError(
                "ShardedStore.ingest requires incoming= (max spans "
                "per shard batch); use stacked_incoming(batches) "
                "OUTSIDE store locks")
        return self.step(shard_device_batches(device_batches, self.device),
                         int(incoming))

    def step(self, batches, incoming: int) -> Dict[str, torch.Tensor]:
        """The commit body of ``ingest``: ``batches`` holds one device
        batch a shard, already on the device (``shard_device_batches``
        outside any write hold), ``incoming`` their max span count."""
        self._maybe_archive(incoming)
        self._batches_since_sweep += 1
        if self._batches_since_sweep >= self.SWEEP_EVERY:
            self.sweep()
        for st, b in zip(self.states, batches):
            dev.ingest_step(st, b)
        self._wp_upper += incoming
        self.last_summary = _summarize(self.states)
        return self.last_summary

    def sweep(self) -> None:
        """Resolve pending (late-parent) children on every shard."""
        for st in self.states:
            dev.dep_sweep(st)
        self._batches_since_sweep = 0

    def _maybe_archive(self, incoming: int) -> None:
        """Close every shard's dependency time bucket once per half
        ring (``dep_close_bucket`` a shard). Writes route whole traces
        to one shard, so the streaming join is shard-local."""
        cap = self.config.capacity
        if self._wp_upper + incoming - self._archived_lower <= cap:
            return
        for st in self.states:
            dev.dep_close_bucket(st)
        self._batches_since_sweep = 0
        self._archived_lower = min(
            self._wp_upper,
            max(self._wp_upper + incoming - cap, self._wp_upper - cap // 2),
        )


# ---------------------------------------------------------------------------
# ShardedSpanStore — the full SpanStore SPI over the shards
# ---------------------------------------------------------------------------


class ShardedSpanStore(WindowedAnalytics, SuspectGuard):
    """SpanStore SPI over an n-shard store on one device.

    Writes route whole traces to shards by trace-id hash (the role of
    Cassandra's key-range sharding, CassieSpanStore.scala:49,108-116).
    Reads run the single-store read of ``store/device.py`` once per
    shard and merge across shards: elementwise sums / maxima / minima
    where the merge is one (durations, presence, sketches), or a host
    merge of the per-shard top-k candidates for index queries. Each
    such fused cross-shard read — its per-shard launches, its reduction
    and its device-to-host copy — runs in one ``_coll_lock`` hold and
    counts once in ``collective_launches()``.

    Implements the surface the conformance suite drives against the
    in-memory and single-device stores (SpanStoreValidator.scala:27).
    Durable like the single store: ``attach_wal`` journals every launch
    unit into a ``wal.ShardedWal`` (one part a shard plus the
    group-commit epoch) before its commit, ``checkpoint.save`` /
    ``load`` snapshot the fleet (each leaf stacked ``[n, ...]`` on the
    host), ``wal.recover`` replays the log's tail, and ``pipelined``
    runs the three-stage ingest pipeline over every shard's commit."""

    # Catalog keys the fused bundle read serves — everything the
    # dispatcher may merge into ONE read.
    CAT_BUNDLE_KEYS = frozenset((
        "svc_hist", "ann_svc_counts", "name_presence",
        "ann_value_counts", "bann_key_counts", "spans_seen",
        "hll_traces",
    ))
    _SUM_CAT_KEYS = ("svc_hist", "ann_svc_counts", "name_presence",
                     "ann_value_counts", "bann_key_counts")
    _MIRROR_LEAVES = ("svc_hist", "ann_svc_counts", "name_presence",
                      "ann_value_counts", "bann_key_counts", "hll_traces",
                      "win_epoch", "win_counts", "win_sums", "win_mm")
    DEFAULT_TTL_S = 1.0

    def __init__(self, n_shards: int, config: dev.StoreConfig,
                 device="cuda", codec=None, registry=None,
                 dispatch_window_s: float = 0.0):
        self.config = config
        self.inner = ShardedStore(n_shards, config, device)
        self.n = self.inner.n
        self.device = self.inner.device
        self.codec = codec or SpanCodec()
        self.ttls: Dict[int, float] = {}
        self.pins = PinBank()
        self._name_lc: Dict[int, int] = {}
        self._kernels: Dict = {}  # guarded-by: _kernels_lock
        # _lock serializes writers and host dicts; the RWLock guards the
        # in-place steps against in-flight reads. _kernels_lock is a
        # LEAF for the read-function cache, which query threads fill
        # while HOLDING the read lock (guarding it with _lock would
        # invert the encode(10) -> commit(40) order).
        self._lock = threading.Lock()  # lock-order: 10 encode
        self._rw = RWLock()  # lock-order: 40 commit
        self._kernels_lock = threading.Lock()  # lock-order: 75 kernel-cache
        # Cross-shard read serializer: a fused read launches its
        # per-shard reads and its reduction on the current stream and
        # copies the result out; readers share the read lock, so without
        # this leaf two threads would interleave half-finished
        # reductions. One fused read at a time, launches and copy inside
        # the hold. Below the read-lock hold (40 -> 45).
        self._coll_lock = threading.Lock()  # lock-order: 45 collective-launch
        # Monotonic fused-read count (one per _coll_lock hold): the
        # dispatcher-batching counter-proof reads deltas of this.
        self._coll_launches = 0  # guarded-by: _coll_lock
        # Host commit frontier: _step_seq advances inside every write
        # hold; _read_epoch covers host-only visibility changes (pin/TTL
        # mutations) — together the query engine's result-cache key.
        self._step_seq = 0
        self._read_epoch = 0
        self._cblock_memo = None
        self._svc_scan_memo = None
        # Per-shard sketch-mirror twins, fed deltas on the commit path,
        # merged lazily into the fleet view the engine sketch tier and
        # the windowed-analytics mixin read.
        self._mirrors = [SketchMirror(config, dicts=self.codec.dicts)
                         for _ in range(self.n)]
        self._fleet_mirror = FleetMirror(config, self._mirrors,
                                         lambda: self._step_seq)
        # Durable write-ahead log (wal/sharded.ShardedWal) and pipelined
        # ingest (store/pipeline): both optional, attached or started by
        # the deployment wiring (main/example.py --wal-dir /
        # --pipeline-depth).
        self.wal = None
        self._wal_marks = None  # guarded-by: _lock
        self._wal_applied = 0
        self._pipeline = None  # guarded-by: _lock
        self._registry = reg = registry or obs.default_registry()
        # Per-shard occupancy/lap gauges: hash-partition imbalance is
        # invisible in the summed counters() totals.
        self._occ_family = reg.register(obs.CallbackFamily(
            "zipkin_shard_occupancy",
            "Per-shard span ring occupancy (hash-partition skew view)",
            "shard", self._occupancy_by_shard))
        self._laps_family = reg.register(obs.CallbackFamily(
            "zipkin_shard_ring_laps",
            "Per-shard span ring laps (eviction-pressure skew view)",
            "shard", self._laps_by_shard))
        # Cross-shard query dispatcher: concurrent API reads coalesce
        # into one fused read per micro-window instead of queueing
        # singly behind _coll_lock.
        self._dispatcher = CrossShardDispatcher(
            self, window_s=dispatch_window_s, registry=reg)

    @property
    def dicts(self):
        return self.codec.dicts

    @property
    def states(self) -> List[dev.StoreState]:
        return self.inner.states

    @property
    def dispatcher(self) -> CrossShardDispatcher:
        return self._dispatcher

    def collective_launches(self) -> int:
        """Monotonic count of fused cross-shard reads (each one a
        _coll_lock hold). The dispatcher-batching acceptance test
        proves N concurrent reads land in <= 2 by differencing this
        around the burst."""
        with self._coll_lock:
            return self._coll_launches

    def close(self) -> None:
        """Ordered shutdown of what the store runs: stop the dispatcher
        (queued reads finish; later ones execute inline), drain and stop
        the pipeline, force the WAL durable, and unregister the
        per-shard gauge families. The WAL itself stays open (its owner
        closes it, after any final checkpoint truncation)."""
        d = self.__dict__.get("_dispatcher")
        if d is not None:
            d.close()
        self.stop_pipeline(raise_errors=False)
        if self.wal is not None:
            self.wal.sync()
        for fam in (self.__dict__.get("_occ_family"),
                    self.__dict__.get("_laps_family")):
            if fam is not None and self._registry.get(fam.name) is fam:
                self._registry.unregister(fam.name)

    # -- resident query engines (query/engine.py) -------------------------

    def register_query_engine(self, engine) -> None:
        self.__dict__.setdefault("_query_engines", []).append(engine)

    def query_engines(self):
        return list(self.__dict__.get("_query_engines", ()))

    # -- writes ---------------------------------------------------------

    def _shard_of(self, trace_id: int) -> int:
        # Shared with the multi-host routing tier (multihost
        # partition_for_trace): one hash, no drift between the producer
        # partitioner and the store's placement.
        return shard_of(trace_id, self.n)

    def apply(self, spans) -> None:
        if not spans:
            return
        with self._lock:
            # In-place sharded ingest must not race an orphaned
            # checkpoint reader (see store.base.SuspectGuard).
            self.ensure_writable()
            for s in spans:
                self.ttls.setdefault(to_signed64(s.trace_id), 1.0)
            prune_ttls(self.ttls, MAX_TTL_ENTRIES)
            if self.pins:
                # Pin-bank arrivals change read answers before the
                # commit bumps the frontier — invalidate cached reads.
                self._bump_read_epoch()
            self.pins.note_write(to_signed64, spans)
            self._apply_locked(list(spans))

    def _apply_locked(self, spans) -> None:  # called-under: _lock
        groups = [[] for _ in range(self.n)]
        for s in spans:
            groups[self._shard_of(s.trace_id)].append(s)
        # One launch per shard must fit every ring (span AND annotation):
        # colliding slot scatters within a launch would be undefined.
        # Split-and-retry; a single span fatter than an annotation ring
        # gets truncated. A launch's unresolved children must also fit
        # the pending ring without self-collision (the bound
        # TorchSpanStore applies in _max_chunk_spans).
        c = self.config
        cap = max(1, min(c.capacity // 2, c.pending_slots))

        def oversized(g):
            return (len(g) > cap
                    or sum(len(s.annotations) for s in g) > c.ann_capacity
                    or sum(len(s.binary_annotations) for s in g)
                    > c.bann_capacity)

        if any(oversized(g) for g in groups):
            if len(spans) > 1:
                mid = len(spans) // 2
                self._apply_locked(spans[:mid])
                self._apply_locked(spans[mid:])
                return
            s = spans[0]
            spans = [dataclasses.replace(
                s,
                annotations=tuple(s.annotations[:c.ann_capacity]),
                binary_annotations=tuple(
                    s.binary_annotations[:c.bann_capacity]),
            )]
            groups = [[] for _ in range(self.n)]
            groups[self._shard_of(s.trace_id)] = spans
        batches = [self.codec.encode(g) for g in groups]
        parts = []
        for g, batch in zip(groups, batches):
            indexable = np.fromiter(
                (should_index(s) for s in g), bool, len(g))
            lc = name_lc_ids(batch, self.dicts, self._name_lc)
            parts.append((batch, lc, indexable))
        unit = self._build_unit(parts)
        if self.wal is not None:
            # Journal BEFORE the commit (ack-after-append) and under
            # self._lock, so append order == encode order == commit
            # order — the property the dictionary-delta replay chain
            # depends on.
            unit = unit._replace(wal_seq=self._journal_unit(parts))
        if self._pipeline is not None:
            # Pipelined sharded ingest: stage 2 copies the unit's shard
            # batches to the device, stage 3 runs _commit_unit.
            self._pipeline.feed(unit)
            return
        unit = unit._replace(db=self.stage_unit(unit.db))
        self._commit_unit(unit)

    def _build_unit(self, parts) -> IngestUnit:
        """Host stage-1 body: pad every shard's encoded part to the
        fleet-wide pow2 buckets, stack host-side, and compute each
        shard's sketch-mirror delta from the PRE-PAD columns. ``parts``
        is one (SpanBatch, name_lc, indexable) triple per shard, in
        shard order."""
        batches = [b for b, _, _ in parts]
        pad_s = _next_pow2(max(b.n_spans for b in batches))
        pad_a = _next_pow2(max(b.n_annotations for b in batches))
        pad_b = _next_pow2(max(b.n_binary for b in batches))
        if self.config.window_enabled:
            ea, eb = win_mod.error_ids(self.dicts)

            def err_of(b):
                return win_mod.span_error_flags(b, ea, eb)
        else:
            def err_of(b):
                return None
        dbs = [
            dev.make_device_batch(
                b, lc, ix, pad_spans=pad_s, pad_anns=pad_a,
                pad_banns=pad_b, error_flag=err_of(b))
            for b, lc, ix in parts
        ]
        sketch = tuple(m.delta_of([part])
                       for m, part in zip(self._mirrors, parts))
        return IngestUnit(
            stack_batches(dbs),
            sum(b.n_spans for b in batches),
            sum(b.n_annotations for b in batches),
            sum(b.n_binary for b in batches),
            # chained: the pipeline's stage 2 unstacks the db into one
            # batch a shard and copies them to the device together.
            self.n, True, sketch=sketch,
            # incoming from the HOST batches, never read off the device
            # inside the write hold.
            incoming=max(b.n_spans for b in batches),
        )

    def stage_unit(self, db) -> Tuple:
        """Stage-2 H2D of the serial path and of WAL replay: the
        host-stacked batch becomes one device batch a shard, before the
        commit takes the write lock. (The pipeline's stage thread
        copies a unit's shard batches on a stream of its own.)"""
        return shard_device_batches(db, self.device)

    def _commit_unit(self, unit: IngestUnit) -> None:
        """Stage 3 — the ONE commit body behind the serial writer, the
        pipeline's commit thread and WAL replay: every shard's step and
        the cross-shard summary under the WRITE lock (which excludes
        every reader, so ingest never overlaps a fused read and needs no
        _coll_lock). A unit the pipeline staged brings its device
        batches, and the step waits for their copy; otherwise ``db``
        holds them (``stage_unit``). Mirror deltas fold inside the same
        hold, BEFORE the frontier bump, so a sketch-tier read at
        frontier F already includes commit F; the applied WAL sequence
        advances in the same hold, so a checkpoint's cut pairs with
        it."""
        self.ensure_writable()
        if unit.staged is None:
            batches = unit.db
        else:
            batches, buf, done = unit.staged
            dev.await_staged(buf, done, self.device)
        with self._rw.write():
            self.inner.step(batches, unit.incoming)
            if unit.sketch is not None:
                for m, d in zip(self._mirrors, unit.sketch):
                    m.apply(d)
            self._step_seq += 1
            if unit.wal_seq is not None:
                self._wal_applied = unit.wal_seq

    # -- durable write-ahead log (wal/sharded.ShardedWal) ----------------

    def attach_wal(self, wal) -> None:
        """Journal every later launch unit into ``wal`` (a ShardedWal:
        one segment log a shard plus the group-commit epoch log) before
        its commit. Attach before live writes: units committed earlier
        are covered only by checkpoints. The store does not own the
        log: callers close() it after the store."""
        with self._lock:
            self.wal = wal
            self._wal_marks = dict_sizes(self.dicts)

    def _journal_unit(self, parts) -> int:  # called-under: _lock
        """Append one sharded launch unit — every shard's part plus the
        dictionary entries its encode step added — as one group-commit
        epoch; returns the epoch sequence. Runs on the encoding thread
        under self._lock."""
        sizes, deltas = dump_dict_deltas(self.dicts, self._wal_marks)
        seq = self.wal.append_unit(parts, self._wal_marks, deltas)
        self._wal_marks = sizes
        return seq

    def wal_sync(self) -> None:
        """Force the attached WAL durable; no-op without one."""
        if self.wal is not None:
            self.wal.sync()

    # -- pipelined ingest lifecycle (store/pipeline) ---------------------

    PIPELINE_DEPTH = 8
    STAGE_BUFFERS = 2

    def start_pipeline(self, depth: Optional[int] = None,
                       stage_buffers: Optional[int] = None
                       ) -> IngestPipeline:
        """Switch the write path to the three-stage ingest pipeline:
        apply() becomes stage 1 (encode, partition, pad and host stack,
        outside the device critical section), a stage thread copies
        each unit's shard batches to the device, and a commit thread
        holds the write lock only for the shard steps. The same quiesce
        rules as TorchSpanStore."""
        with self._lock:
            if self._pipeline is not None:
                raise RuntimeError("ingest pipeline already running")
            self._pipeline = IngestPipeline(
                self, depth or self.PIPELINE_DEPTH,
                stage_buffers or self.STAGE_BUFFERS,
                registry=self._registry)
            return self._pipeline

    def drain_pipeline(self) -> None:
        """Block until every accepted batch is committed on every shard
        (no-op when no pipeline runs); re-raises a parked pipeline
        error."""
        with self._lock:
            p = self._pipeline
        if p is not None:
            p.drain()

    def stop_pipeline(self, raise_errors: bool = True) -> None:
        """Drain, stop the pipeline threads and return to the serial
        write path — quiesced UNDER the encode lock with the pipeline
        still published (two concurrent device writers would break the
        ring-scatter contract; see TorchSpanStore.stop_pipeline)."""
        with self._lock:
            p = self._pipeline
            if p is None:
                return
            p.stop()
            self._pipeline = None
        err = p.take_error()
        if raise_errors and err is not None:
            raise err

    @contextlib.contextmanager
    def pipelined(self, depth: Optional[int] = None):
        """Scoped pipelined ingest: drains and stops on exit."""
        pipe = self.start_pipeline(depth)
        try:
            yield pipe
        finally:
            self.stop_pipeline()

    # -- query-engine hooks (query/engine.py) ----------------------------

    def write_frontier(self) -> Tuple[int, int]:
        """Monotonic host-mirrored commit frontier — the result-cache
        key component (same contract as TorchSpanStore.write_frontier).
        No device traffic."""
        return (self._step_seq, self._read_epoch)

    def _bump_read_epoch(self) -> None:
        self._read_epoch += 1

    def ensure_sketch_mirror(self) -> FleetMirror:
        """The fleet sketch mirror (FleetMirror over the per-shard
        twins), resynced from the device aggregates if a state swap
        left any shard cold — one copy of each listed leaf a shard (a
        plain copy, not a cross-shard read, so no _coll_lock), after
        which incremental per-commit deltas keep every shard warm with
        zero device traffic."""
        fm = self._fleet_mirror
        if not fm.warm:
            with self._rw.read():
                for st, m in zip(self.states, self._mirrors):
                    if not m.warm:
                        m.adopt(*(_np(getattr(st, f))
                                  for f in self._MIRROR_LEAVES))
        return fm

    def set_time_to_live(self, trace_id: int, ttl_seconds: float) -> None:
        tid = to_signed64(trace_id)
        with self._lock:
            self.ttls[tid] = ttl_seconds
            pin = ttl_seconds > self.DEFAULT_TTL_S
            if not pin:
                self.pins.unpin(tid)
            # Pin/unpin changes read answers without a commit — the
            # result cache must not serve the stale frontier.
            self._bump_read_epoch()
        if pin:
            fill_pin(self.pins, self._lock, tid, lambda: (
                self.get_spans_by_trace_ids([trace_id]) or [[]])[0])
            with self._lock:
                self._bump_read_epoch()

    def get_time_to_live(self, trace_id: int) -> float:
        with self._lock:
            return self.ttls[to_signed64(trace_id)]

    # -- cross-shard read functions (cached per static shape) -------------

    def _kernel(self, key, build):
        # The cache dict is shared by every API handler thread. build()
        # runs OUTSIDE the hold; a duplicate build for a racing key is
        # harmless (setdefault keeps the first).
        with self._kernels_lock:
            fn = self._kernels.get(key)
        if fn is None:
            fn = build()
            with self._kernels_lock:
                fn = self._kernels.setdefault(key, fn)
        return fn

    def _collect(self, kernel, *args):
        """Run one fused cross-shard read and fetch its result to the
        host, serialized behind the collective-launch leaf lock. Callers
        hold the read lock; the per-shard launches, the reduction AND
        the copy complete inside the hold."""
        with self._coll_lock:
            self._coll_launches += 1
            return kernel(self.states, *args)

    @staticmethod
    def _per_shard(states, read, *args):
        """Run a single-state read on every shard: a list of its
        results, one a shard."""
        return [read(st, *args) for st in states]

    @staticmethod
    def _stacked(rows) -> np.ndarray:
        return _np(torch.stack(list(rows)))

    def _q_by_service(self, limit: int):
        def build():
            def fn(states, svc, name_lc, end_ts):
                return self._stacked(self._per_shard(
                    states, dev.query_trace_ids_by_service, svc, name_lc,
                    end_ts, limit))
            return fn

        return self._kernel(("svc", limit), build)

    def _iq_mats(self, results):
        mats, complete, wm = zip(*results)
        return (self._stacked(mats), self._stacked(complete),
                self._stacked(wm))

    def _iq_by_service(self, limit: int, named: bool):
        """Index fast path: per-shard bucket read + completeness flag
        (dev.iquery_trace_ids_by_service). The named/unnamed branch is
        host state, so it keys the cache."""
        def build():
            def fn(states, svc, name_lc, end_ts):
                return self._iq_mats(self._per_shard(
                    states, dev.iquery_trace_ids_by_service, svc,
                    name_lc if named else -1, end_ts, limit))
            return fn

        return self._kernel(("isvc", limit, named), build)

    def _iq_by_annotation(self, limit: int, mode: str):
        """mode: 'ann' (user annotation value), 'bkey' (binary key
        only), or 'bval' (binary key + 1-2 value forms; its 2-bucket
        window clamps to 2*depth, dev.iquery_trace_ids_by_annotation)."""
        def build():
            def fn(states, svc, ann, bkey, bval, bval2, end_ts):
                return self._iq_mats(self._per_shard(
                    states, dev.iquery_trace_ids_by_annotation, svc, ann,
                    bkey, bval, bval2, end_ts, limit))
            return fn

        return self._kernel(("iann", limit, mode), build)

    def _q_by_annotation(self, limit: int):
        def build():
            def fn(states, svc, ann, bkey, bval, bval2, end_ts):
                return self._stacked(self._per_shard(
                    states, dev.query_trace_ids_by_annotation, svc, ann,
                    bkey, bval, bval2, end_ts, limit))
            return fn

        return self._kernel(("ann", limit), build)

    @staticmethod
    def _merge_durations(mats) -> torch.Tensor:
        """[present, found, first, last] rows merged across shards by
        max, max, min, max."""
        st = torch.stack(list(mats))
        return torch.stack([st[:, 0].amax(0), st[:, 1].amax(0),
                            st[:, 2].amin(0), st[:, 3].amax(0)])

    def _q_durations(self):
        def build():
            def fn(states, qids):
                return _np(self._merge_durations(self._per_shard(
                    states, dev.query_durations, qids)))
            return fn

        return self._kernel(("durations",), build)

    def _iq_durations(self):
        """Trace-membership fast path (dev.iquery_durations) with the
        cross-shard min/max merge; ``exact`` requires every shard's
        queried buckets to pass the displaced-gid gate."""
        def build():
            def fn(states, qids):
                mats, exact = zip(*self._per_shard(
                    states, dev.iquery_durations, qids))
                return (_np(self._merge_durations(mats)),
                        bool(torch.stack(list(exact)).all()))
            return fn

        return self._kernel(("idurations",), build)

    def _durations_mat(self, qids):
        with self._rw.read():
            if self.config.use_index:
                mat, exact = self._collect(self._iq_durations(), qids)
                if exact:
                    return mat
            return self._collect(self._q_durations(), qids)

    def _iq_gather(self, k_s: int, k_a: int, k_b: int):
        """Per-shard trace-membership gather
        (dev.iquery_gather_trace_rows) + a cross-shard AND of the
        exactness gates."""
        def build():
            def fn(states, qids):
                counts, s, a, b, exact = zip(*self._per_shard(
                    states, dev.iquery_gather_trace_rows, qids, k_s, k_a,
                    k_b))
                return (self._stacked(counts), self._stacked(s),
                        self._stacked(a), self._stacked(b),
                        bool(torch.stack(list(exact)).all()))
            return fn

        return self._kernel(("igather", k_s, k_a, k_b), build)

    def _gather_via_index(self, qids):
        """Returns the per-shard gather payload, or None when any
        shard's queried bucket fails its gate (caller scans)."""
        def fetch(k_s, k_a, k_b):
            counts, s_m, a_m, b_m, exact = self._collect(
                self._iq_gather(k_s, k_a, k_b), qids)
            return (exact, int(counts[:, 0].max()),
                    int(counts[:, 1].max()), int(counts[:, 2].max()),
                    (counts, s_m, a_m, b_m))

        return index_gather_with_escalation(self.config, len(qids), fetch)

    def _q_gather(self, k_s: int, k_a: int, k_b: int):
        def build():
            def fn(states, qids):
                counts, s, a, b = zip(*self._per_shard(
                    states, dev.gather_trace_rows, qids, k_s, k_a, k_b))
                return (self._stacked(counts), self._stacked(s),
                        self._stacked(a), self._stacked(b))
            return fn

        return self._kernel(("gather", k_s, k_a, k_b), build)

    def _cat_kernel(self, key: str):
        """One small cross-shard read per catalog key — reducing the
        whole catalog to read one scalar/row would waste device time on
        hot paths like the sampler's stored_span_count tick."""
        def build():
            def fn(states):
                if key == "hll_traces":
                    return _np(_max([st.hll_traces for st in states]))
                if key == "spans_seen":
                    return _np(_sum([st.counters["spans_seen"]
                                     for st in states]))
                return _np(_sum([getattr(st, key) for st in states]))
            return fn

        return self._kernel(("cat", key), build)

    # -- id lookups ------------------------------------------------------

    def _svc_id(self, service_name: str):
        return self.dicts.services.get(service_name.lower())

    @staticmethod
    def _shard_candidates(mats: np.ndarray, k: int):
        """Flatten per-shard candidate matrices [n, 3, kk]; truncated if
        ANY shard filled its window. The window bound is the kernel's
        ACTUAL slot count (kk = mats.shape[-1]), which may be clamped
        below the requested k by bucket geometry — comparing against
        the requested k would let a full clamped window read as
        untruncated."""
        kk = min(k, mats.shape[-1])
        cands, truncated = [], False
        for mat in mats:
            shard_cands = TorchSpanStore._cands(mat)
            cands.extend(shard_cands)
            truncated |= len(shard_cands) >= kk
        return cands, truncated

    def get_trace_ids_by_name(self, service_name, span_name, end_ts,
                              limit):
        """Top-k trace ids by (service[, span name]) via the
        cross-shard dispatcher: concurrent index reads ride ONE
        multi-probe read (get_trace_ids_multi) instead of queueing
        singly behind _coll_lock."""
        return self._dispatcher.ids(
            ("name", service_name, span_name, end_ts, limit))

    def _get_trace_ids_by_name_direct(self, service_name, span_name,
                                      end_ts, limit):
        svc = self._svc_id(service_name)
        if svc is None or limit <= 0:
            return []
        if span_name is not None:
            name_lc = self.dicts.span_names.get(span_name.lower())
            if name_lc is None:
                return []
        else:
            name_lc = -1

        def fetch(k):
            with self._rw.read():
                mats = self._collect(self._q_by_service(k), svc, name_lc,
                                     int(end_ts))
            return self._shard_candidates(mats, k)

        def index_fetch(k):
            with self._rw.read():
                mats, complete, wm = self._collect(
                    self._iq_by_service(k, name_lc >= 0), svc, name_lc,
                    int(end_ts))
            cands, truncated = self._shard_candidates(mats, k)
            # window > len(cands) <=> no shard's window truncated: only
            # then may the underfull-equals-complete claim fire.
            window = len(cands) if truncated else len(cands) + 1
            return cands, bool(np.all(complete)), int(np.max(wm)), window

        if self.config.use_index and not service_scan_only(
                svc, self.config):
            return index_first_topk(
                limit, self.config.ann_capacity, index_fetch, fetch)
        return topk_ids_with_escalation(
            limit, self.config.ann_capacity, fetch)

    def get_trace_ids_by_annotation(self, service_name, annotation,
                                    value, end_ts, limit):
        """Top-k trace ids by annotation via the cross-shard
        dispatcher (see get_trace_ids_by_name)."""
        return self._dispatcher.ids(
            ("annotation", service_name, annotation, value, end_ts,
             limit))

    def _get_trace_ids_by_annotation_direct(self, service_name,
                                            annotation, value, end_ts,
                                            limit):
        if annotation in CORE_ANNOTATIONS or limit <= 0:
            return []
        svc = self._svc_id(service_name)
        if svc is None:
            return []
        resolved = resolve_annotation_query(self.dicts, annotation, value)
        if resolved is None:
            return []
        ann_value, bann_key, bann_value, bann_value2 = resolved

        def fetch(k):
            with self._rw.read():
                mats = self._collect(
                    self._q_by_annotation(k), svc, ann_value, bann_key,
                    bann_value, bann_value2, int(end_ts))
            return self._shard_candidates(mats, k)

        if ann_value >= 0:
            mode = "ann"
        elif bann_value < 0 and bann_value2 < 0:
            mode = "bkey"
        else:
            mode = "bval"
        bv1 = bann_value if bann_value >= 0 else bann_value2
        bv2 = bann_value2 if bann_value2 >= 0 else bv1
        # Mixed user-annotation + binary-key names OR across families:
        # only the scan sees both sides.
        mixed = ann_value >= 0 and bann_key >= 0

        def index_fetch(k):
            with self._rw.read():
                mats, complete, wm = self._collect(
                    self._iq_by_annotation(k, mode), svc, ann_value,
                    bann_key, bv1, bv2, int(end_ts))
            cands, truncated = self._shard_candidates(mats, k)
            window = len(cands) if truncated else len(cands) + 1
            return cands, bool(np.all(complete)), int(np.max(wm)), window

        c = self.config
        if c.use_index and not mixed and not service_scan_only(svc, c):
            return index_first_topk(
                limit, c.ann_capacity + c.bann_capacity, index_fetch,
                fetch)
        return topk_ids_with_escalation(
            limit, c.ann_capacity + c.bann_capacity, fetch)

    def _iq_multi(self, n: int, k: int):
        """Batched multi-probe index read over the shards: every probe
        reads its bucket on EVERY shard in one fused read
        (dev.iquery_trace_ids_multi a shard); the host merges per-shard
        candidates."""
        def build():
            def fn(states, arrs):
                return self._iq_mats(self._per_shard(
                    states, dev.iquery_trace_ids_multi, arrs, k))
            return fn

        return self._kernel(("imulti", n, k), build)

    def get_trace_ids_multi(self, queries):
        """Batched index read over the shards: all queries' probes ride
        one fused read; distrusted buckets fall back to the singular
        sharded paths. Same trust policy as
        TorchSpanStore.get_trace_ids_multi (shared resolve/gate
        helpers), with per-shard saturation folded into each probe's
        flag."""
        c = self.config
        if not c.use_index or not queries:
            return ReadSpanStore.get_trace_ids_multi(self, queries)
        results, probes, limits, fallback = resolve_multi_probes(
            c, self.dicts, queries)
        if probes:
            # The per-shard read takes the clamped k directly (k_eff).
            arrs, _, k_eff = build_probe_arrays(c, probes, limits)
            with self._rw.read():
                mats, completes, wms = self._collect(
                    self._iq_multi(len(arrs["key1"]), k_eff), arrs)
            per_probe = []
            for pi, p in enumerate(probes):
                window_pi = min(k_eff, p[1][3])
                cands = []
                saturated = False
                for sh in range(mats.shape[0]):
                    shard_cands = TorchSpanStore._cands(mats[sh, pi])
                    saturated |= len(shard_cands) >= window_pi
                    cands.extend(shard_cands)
                per_probe.append((
                    cands, bool(np.all(completes[:, pi])),
                    int(np.max(wms[:, pi])), saturated,
                ))
            gated = gate_multi_probes(probes, limits, per_probe)
            for qi, ids in gated.items():
                if ids is None:
                    fallback.append(qi)
                else:
                    results[qi] = ids
        for qi in fallback:
            q = queries[qi]
            if q[0] == "name":
                results[qi] = self.get_trace_ids_by_name(*q[1:])
            else:
                results[qi] = self.get_trace_ids_by_annotation(*q[1:])
        return [r if r is not None else [] for r in results]

    # -- trace reads -----------------------------------------------------

    _sorted_qids = staticmethod(TorchSpanStore._sorted_qids)

    def traces_exist(self, trace_ids):
        if not trace_ids:
            return set()
        canon = {to_signed64(t): t for t in trace_ids}
        qids = self._sorted_qids(trace_ids)
        mat = self._durations_mat(qids)
        return exist_from_duration_mat(canon, qids, mat[0], self.pins,
                                       self._lock)

    def get_traces_duration(self, trace_ids):
        if not trace_ids:
            return []
        canon = {to_signed64(t): t for t in trace_ids}
        qids = self._sorted_qids(trace_ids)
        mat = self._durations_mat(qids)
        return durations_from_mat(trace_ids, canon, qids, mat, self.pins,
                                  self._lock)

    def get_spans_by_trace_ids(self, trace_ids):
        if not trace_ids:
            return []
        qids = self._sorted_qids(trace_ids)
        with self._rw.read():
            payload = None
            if self.config.use_index:
                payload = self._gather_via_index(qids)
            if payload is None:
                def fetch(k_s, k_a, k_b):
                    counts, s_m, a_m, b_m = self._collect(
                        self._q_gather(k_s, k_a, k_b), qids)
                    return (int(counts[:, 0].max()),
                            int(counts[:, 1].max()),
                            int(counts[:, 2].max()),
                            (counts, s_m, a_m, b_m))

                payload = gather_with_escalation(self.config, fetch)
            counts, s_m, a_m, b_m = payload
        spans = []
        for sh in range(self.n):
            n_s, n_a, n_b = (int(x) for x in counts[sh])
            if n_s:
                batch, _ = mats_to_batch(n_s, n_a, n_b, s_m[sh], a_m[sh],
                                         b_m[sh])
                spans.extend(self.codec.decode(batch))
        by_tid: Dict[int, list] = {}
        for span in spans:
            by_tid.setdefault(span.trace_id, []).append(span)
        with self._lock:
            apply_pin_merges(self.pins, by_tid, trace_ids, to_signed64)
        return [
            by_tid[to_signed64(tid)]
            for tid in trace_ids
            if to_signed64(tid) in by_tid
        ]

    def get_spans_by_trace_id(self, trace_id: int):
        found = self.get_spans_by_trace_ids([trace_id])
        return found[0] if found else []

    # -- name catalogs / analytics --------------------------------------

    def _cat_bundle_kernel(self):
        """ONE cross-shard read reducing every catalog array the
        dispatcher can serve: >=2 concurrent catalog reads sharing a
        micro-window cost one read total instead of one each behind
        _coll_lock."""
        def build():
            def fn(states):
                out = {k: _np(_sum([getattr(st, k) for st in states]))
                       for k in self._SUM_CAT_KEYS}
                out["spans_seen"] = _np(_sum(
                    [st.counters["spans_seen"] for st in states]))
                out["hll_traces"] = _np(_max(
                    [st.hll_traces for st in states]))
                return out
            return fn

        return self._kernel(("cat_bundle",), build)

    def _fetch_cat_bundle(self):
        """Every dispatcher-servable catalog entry: one fused read, one
        copy out (the dispatcher's fused path)."""
        with self._rw.read():
            return self._collect(self._cat_bundle_kernel())

    def _cat_direct(self, key):
        """Read-locked fetch of ONE cross-shard catalog entry — the
        cheap singular read, for a read with nothing to share with."""
        with self._rw.read():
            return self._collect(self._cat_kernel(key))

    def _cat(self, key, row=None):
        """One catalog entry (optionally one row of it), via the
        cross-shard dispatcher: concurrent catalog reads coalesce into
        one fused bundle read (parallel/dispatch)."""
        return self._dispatcher.cat(key, row)

    def get_all_service_names(self):
        present = self._cat("ann_svc_counts") > 0
        d = self.dicts.services
        out = {
            d.decode(i) for i in np.flatnonzero(present)
            if i < len(d) and d.decode(i)
        }
        # Dictionary-overflow services can't mark the presence array —
        # list the ones any shard's rings still hold as hosts (see
        # TorchSpanStore.get_all_service_names; OR across shards is a
        # sum of the per-shard presence).
        S = self.config.max_services
        n_over = len(d) - S
        if n_over > 0:
            pad = 1 << max(0, (n_over - 1)).bit_length()

            def build():
                def fn(states):
                    pres = self._per_shard(
                        states, dev.overflow_service_presence, pad)
                    return _np(_sum([p.to(torch.int32) for p in pres])
                               > 0)
                return fn

            with self._rw.read():
                pres = self._collect(
                    self._kernel(("overflow_presence", pad), build))
            out.update(
                name for i in np.flatnonzero(pres[:n_over])
                if (name := d.decode(S + int(i)))
            )
        return out

    def _scan_cat_kernel(self):
        """Overflow-service catalog reads: per-shard ring scans
        (dev.svc_scan_catalog) summed across the shards — the
        [max_services]-sized catalog arrays cannot represent services
        past the dictionary cap, and a clamped row read would serve
        service max_services-1's data under the wrong name."""
        def build():
            def fn(states, svc):
                rows = self._per_shard(states, dev.svc_scan_catalog, svc)
                return tuple(_np(_sum(r)) for r in zip(*rows))
            return fn

        return self._kernel(("scan_catalog",), build)

    def _svc_catalog_scan(self, svc: int):
        # One-entry memo keyed on (svc, write position): the read
        # returns all four catalog rows at once — see
        # TorchSpanStore._svc_catalog_scan.
        key = (svc, self.inner._wp_upper)
        cached = self._svc_scan_memo
        if cached is not None and cached[0] == key:
            return cached[1]
        with self._rw.read():
            rows = self._collect(self._scan_cat_kernel(), svc)
        self._svc_scan_memo = (key, rows)
        return rows

    def get_span_names(self, service: str):
        svc = self._svc_id(service)
        if svc is None:
            return set()
        if service_scan_only(svc, self.config):
            row = self._svc_catalog_scan(svc)[0] > 0
        else:
            row = self._cat("name_presence", svc) > 0
        d = self.dicts.span_names
        return {
            d.decode(i) for i in np.flatnonzero(row)
            if i < len(d) and d.decode(i)
        }

    def _summary_kernel(self):
        def build():
            def fn(states):
                s = _summarize(states)
                return (_np(s["dep_moments"]), int(s["ts_min"]),
                        int(s["ts_max"]))
            return fn

        return self._kernel(("summary",), build)

    def _deps_range_kernel(self):
        def build():
            def fn(states, start_ts, end_ts):
                banks = torch.stack(self._per_shard(
                    states, dev.dep_moments_in_range, start_ts, end_ts))
                # The ts range rides the same read — running the full
                # summary just to clip two scalars would reduce every
                # catalog array per windowed query.
                ts_min = max(int(_min([st.ts_min for st in states])),
                             start_ts)
                ts_max = min(int(_max([st.ts_max for st in states])),
                             end_ts)
                return (_np(M.reduce_moments(banks, axis=0)), ts_min,
                        ts_max)
            return fn

        return self._kernel(("deps_range",), build)

    def get_dependencies(self, start_ts=None, end_ts=None):
        # Sweep first — but only when something was written since the
        # last sweep, so read-only dependency polling stays a pure read
        # (same contract as TorchSpanStore.get_dependencies).
        if self.inner._batches_since_sweep:
            with self._lock:
                if self.inner._batches_since_sweep:
                    # The sweep writes the states in place — same
                    # suspect gate as every other writing path.
                    self.ensure_writable()
                    with self._rw.write():
                        self.inner.sweep()
        with self._rw.read():
            if start_ts is None and end_ts is None:
                bank, ts_min, ts_max = self._collect(self._summary_kernel())
            else:
                s = dev.I64_MIN if start_ts is None else int(start_ts)
                e = dev.I64_MAX if end_ts is None else int(end_ts)
                bank, ts_min, ts_max = self._collect(
                    self._deps_range_kernel(), s, e)
        return dependencies_from_bank(
            bank, self.dicts.services, self.config.max_services,
            float(ts_min), float(ts_max))

    def service_duration_quantiles(self, service: str, qs):
        svc = self._svc_id(service)
        if svc is None:
            return None
        c = self.config
        if service_scan_only(svc, c):
            counts = self._svc_catalog_scan(svc)[1]
        else:
            counts = self._cat("svc_hist", svc)
        return Q.quantiles_host(counts, c.gamma, 1.0, qs)

    def top_annotations(self, service: str, k: int = 10):
        svc = self._svc_id(service)
        if svc is None:
            return []
        if service_scan_only(svc, self.config):
            row = self._svc_catalog_scan(svc)[2]
        else:
            row = self._cat("ann_value_counts", svc)
        order = np.argsort(-row)[:k]
        d = self.dicts.annotations
        return [
            (d.decode(int(i)), int(row[i])) for i in order
            if row[i] > 0 and i < len(d)
        ]

    def top_binary_keys(self, service: str, k: int = 10):
        svc = self._svc_id(service)
        if svc is None:
            return []
        if service_scan_only(svc, self.config):
            row = self._svc_catalog_scan(svc)[3]
        else:
            row = self._cat("bann_key_counts", svc)
        order = np.argsort(-row)[:k]
        d = self.dicts.binary_keys
        return [
            (d.decode(int(i)), int(row[i])) for i in order
            if row[i] > 0 and i < len(d)
        ]

    def estimated_unique_traces(self) -> float:
        return float(hll.estimate(self._cat("hll_traces")))

    def stored_span_count(self) -> float:
        """spans_seen summed across every shard — the sharded flow
        source for the adaptive controller (the ZK group-sum role,
        AdaptiveSampler.scala:204-237)."""
        return float(self._cat("spans_seen"))

    def _counter_blocks(self):
        """(totals dict, per-shard [n, F] block matrix), memoized on
        the host-side write clocks — the fetched-once-per-ingest-step
        contract of TorchSpanStore.counter_block, so scrapes between
        writes cost no device traffic. The per-shard matrix is a plain
        per-shard read (not reduced on the device, so no _coll_lock)."""
        key = (self.inner._wp_upper, self.inner._batches_since_sweep,
               self.inner._archived_lower)
        memo = self._cblock_memo
        if memo is not None and memo[0] == key:
            return dict(memo[1]), memo[2]
        with self._rw.read():
            blocks = self._stacked(
                self._per_shard(self.states, dev.counter_block))
        out: Dict[str, float] = {}
        for i, name in enumerate(dev.COUNTER_BLOCK_FIELDS):
            col = blocks[:, i]
            if name == "ts_min":
                out[name] = float(col.min())
            elif name == "ts_max":
                out[name] = float(col.max())
            else:
                out[name] = float(col.sum())
        out["shards"] = float(self.n)
        self._cblock_memo = (key, dict(out), blocks)
        return dict(out), blocks

    def counters(self) -> Dict[str, float]:
        """Store-stage counters for /metrics: per-shard device counter
        blocks summed across the shards (occupancy/laps are per-shard
        quantities, so sums read as fleet totals; ts_min/ts_max reduce
        by min/max). Per-shard SKEW — which the sums erase — is
        surfaced separately by shard_counters() and the
        zipkin_shard_occupancy{shard=}/zipkin_shard_ring_laps{shard=}
        gauge families."""
        totals, _ = self._counter_blocks()
        return totals

    def shard_counters(self):
        """One counter dict PER SHARD, in shard order — the
        hash-partition imbalance view counters()'s totals sum away."""
        _, blocks = self._counter_blocks()
        return [
            {name: float(blocks[sh, i])
             for i, name in enumerate(dev.COUNTER_BLOCK_FIELDS)}
            for sh in range(blocks.shape[0])
        ]

    def _shard_column(self, field: str) -> Dict[str, float]:
        i = dev.COUNTER_BLOCK_FIELDS.index(field)
        _, blocks = self._counter_blocks()
        return {str(sh): float(blocks[sh, i])
                for sh in range(blocks.shape[0])}

    def _occupancy_by_shard(self) -> Dict[str, float]:
        return self._shard_column("ring_occupancy")

    def _laps_by_shard(self) -> Dict[str, float]:
        return self._shard_column("ring_laps")
