"""Host-mirrored monoid sketches, torch side.

The port's copy of ``SketchMirror`` and ``SketchDelta`` from
``zipkin_tpu/store/mirror.py``, and the sharded store's
``FleetMirror``, the lazily merged fleet view over its per-shard
mirrors. The fused ingest step maintains six LIFETIME aggregate arrays on the device (per-service duration
log-histogram, annotation-host service counts, span-name presence,
top-annotation and top-binary-key count matrices, the distinct-trace
HyperLogLog) and, with the window on, the windowed Moments-sketch
arena. Every one is a monoid updated by a masked integer scatter-add
or scatter-max over columns that are already on the host in stage 1
of the write path, so ``SketchMirror.delta_of`` computes a small COO
delta a launch unit and ``TorchSpanStore._commit_unit`` folds it in
under the state lock, before the frontier bump: reads answered from
the mirror cost no device round trip and are never behind the
committed frontier.

Exactness contract: the mirror's arrays equal the device arrays bit
for bit — same dtypes, same masks as ``ingest_step``, the same bucket
math (``store/archive/sketches.hist_bucket_index``, the numpy twin of
the port's ``ops/quantile.bucket_index``) and the same murmur3 hash
family for the HLL (seeds 101/202 as ``ops/hll.update_``). After a
state swap the mirror did not see, it is marked cold and resynced from
the device leaves in one fetch (``TorchSpanStore.ensure_sketch_mirror``).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Sequence, Tuple

import numpy as np

from zipkin_tpu_torch.aggregate import windows as win
from zipkin_tpu_torch.models.constants import FIRST_USER_ANNOTATION_ID
from zipkin_tpu_torch.ops.hashing import split64
from zipkin_tpu_torch.store.archive.sketches import (
    hist_bucket_index,
    np_clz32,
    np_hash2_32,
)

_U32 = np.uint32


class SketchDelta(NamedTuple):
    """One launch unit's aggregate increments in COO form (flat indices
    into each mirror array; every index is pre-masked — invalid rows
    are already dropped, mirroring the device's ``where(ok, idx, -1)``
    scatter convention). ``win`` carries the windowed-arena rows
    PER CHUNK (a chained unit runs one device step per chunk and the
    epoch war is stateful, so chunks must fold in launch order)."""

    hist_idx: np.ndarray  # flat into svc_hist [S*B]
    svc_idx: np.ndarray  # into ann_svc_counts [S]
    name_idx: np.ndarray  # flat into name_presence [S*N]
    av_idx: np.ndarray  # flat into ann_value_counts [S*A]
    bk_idx: np.ndarray  # flat into bann_key_counts [S*K]
    hll_idx: np.ndarray  # HLL register indices
    hll_rank: np.ndarray  # matching ranks (scatter-max)
    win: Tuple[win.WindowUpdate, ...] = ()  # per-chunk window rows


class SketchMirror:
    """Host twins of the device's lifetime aggregate arrays (see module
    docstring). Thread-safe: ``apply`` runs on the commit path,
    ``adopt`` on a resync, readers on API threads."""

    def __init__(self, config, dicts=None):
        self.config = config
        c = config
        self.gamma = (1.0 + c.quantile_alpha) / (1.0 - c.quantile_alpha)
        self._lock = threading.Lock()  # lock-order: 50 mirror
        self._warm = True  # a fresh store's zeros are warm; guarded-by: _lock
        S = c.max_services
        self.svc_hist = np.zeros((S, c.quantile_buckets), np.int32)  # guarded-by: _lock
        self.ann_svc_counts = np.zeros(S, np.int32)  # guarded-by: _lock
        self.name_presence = np.zeros((S, c.max_span_names), np.int32)  # guarded-by: _lock
        self.ann_value_counts = np.zeros(
            (S, c.max_annotation_values), np.int32)  # guarded-by: _lock
        self.bann_key_counts = np.zeros((S, c.max_binary_keys), np.int32)  # guarded-by: _lock
        self.hll_traces = np.zeros(1 << c.hll_p, np.int32)  # guarded-by: _lock
        # Windowed Moments-sketch arena twins (aggregate/windows.py):
        # same dtypes/fills as the device arrays, folded by the same
        # integer adds/maxes → bitwise-equal cells. ``dicts`` resolves
        # the "error" annotation/key ids for the per-span error bit
        # (None = no dictionary ⇒ no error detection).
        self.dicts = dicts
        Wn = c.win_slots
        self.win_epoch = np.full(Wn, -1, np.int64)  # guarded-by: _lock
        self.win_counts = np.zeros((S, Wn, win.N_COUNT_FIELDS), np.int32)  # guarded-by: _lock
        self.win_sums = np.zeros((S, Wn, win.N_SUM_FIELDS), np.int64)  # guarded-by: _lock
        self.win_mm = np.full((S, Wn, win.N_MM_FIELDS), win.I32_MIN,
                              np.int32)  # guarded-by: _lock
        # Process-lifetime monotonic fold counters (the
        # zipkin_window_* Prometheus families): unaffected by ring
        # self-clears or adoption resyncs, so scrapes never regress.
        self.win_spans_total = 0
        self.win_errors_total = 0

    # -- state ----------------------------------------------------------

    @property
    def warm(self) -> bool:
        with self._lock:
            return self._warm

    def mark_cold(self) -> None:
        """The device state was swapped without a delta (checkpoint
        restore, adopt_state): the mirror must resync before serving."""
        with self._lock:
            self._warm = False

    def adopt(self, svc_hist, ann_svc_counts, name_presence,
              ann_value_counts, bann_key_counts, hll_traces,
              win_epoch=None, win_counts=None, win_sums=None,
              win_mm=None) -> None:
        """Resync from already-fetched device arrays. Callers fetch
        under the store's READ lock (so no commit's delta can be
        concurrent with the snapshot) and adopt after — a delta from a
        LATER commit applying after this simply lands on top. The
        window arena rides the same snapshot (the lifetime fold
        counters don't: they are process-monotonic by contract)."""
        with self._lock:
            self.svc_hist = np.array(svc_hist, np.int32)
            self.ann_svc_counts = np.array(ann_svc_counts, np.int32)
            self.name_presence = np.array(name_presence, np.int32)
            self.ann_value_counts = np.array(ann_value_counts, np.int32)
            self.bann_key_counts = np.array(bann_key_counts, np.int32)
            self.hll_traces = np.array(hll_traces, np.int32)
            if win_epoch is not None:
                self.win_epoch = np.array(win_epoch, np.int64)
                self.win_counts = np.array(win_counts, np.int32)
                self.win_sums = np.array(win_sums, np.int64)
                self.win_mm = np.array(win_mm, np.int32)
            self._warm = True

    # -- write path ------------------------------------------------------

    def delta_of(self, group) -> SketchDelta:
        """COO delta for one planned launch group (stage 1, host side):
        ``group`` is the ``_plan_units`` list of (SpanBatch, name_lc,
        indexable) parts. Pure function — no lock, no device.

        LAYOUT-INDEPENDENT by contract: this reads batch CONTENT
        columns only (ids, services, durations, annotations) — never
        row placement (write_pos arithmetic, or the paged layout's
        span_slot/span_gid planner columns), so ring and paged stores
        fed the same stream build bitwise-equal mirrors.
        tests/test_torch_windows.py gates this (mirror arrays compared
        element-for-element across layouts)."""
        c = self.config
        S = c.max_services
        hist_parts, svc_parts, name_parts, av_parts, bk_parts = (
            [], [], [], [], [])
        hll_i_parts, hll_r_parts = [], []
        for batch, name_lc, indexable in group:
            b = batch
            # Per-service duration histogram (svc_ok in ingest_step).
            svc = np.asarray(b.service_id, np.int64)
            ok = (svc >= 0) & (svc < S) & (b.duration >= 0)
            if ok.any():
                bidx = hist_bucket_index(
                    b.duration[ok], c.quantile_buckets, self.gamma, 1.0)
                hist_parts.append(svc[ok] * c.quantile_buckets + bidx)
            # Distinct-trace HLL (seeds 101/202, ops.hll.update).
            tid = np.asarray(b.trace_id, np.int64)
            if tid.size:
                hi, lo = split64(tid)
                # Register-count mask from CONFIG, not the live array:
                # delta_of is stage 1's lock-free pure function, and
                # reading a _lock-guarded array here (even just .size)
                # would break that contract.
                hll_i_parts.append(
                    (np_hash2_32(hi, lo, 101)
                     & _U32((1 << c.hll_p) - 1)).astype(np.int64))
                hll_r_parts.append(
                    (np_clz32(np_hash2_32(hi, lo, 202)) + 1).astype(
                        np.int32))
            # Annotation-host aggregates.
            a_svc = np.asarray(b.ann_service_id, np.int64)
            a_ok = (a_svc >= 0) & (a_svc < S)
            if a_ok.any():
                svc_parts.append(a_svc[a_ok])
                aidx = b.ann_span_idx
                # Span-name presence: indexable ann-hosted spans with a
                # resolved (and representable) name (np_ok).
                name = np.asarray(b.name_id, np.int64)[aidx]
                name_lc_a = np.asarray(name_lc, np.int64)[aidx]
                ixa = np.asarray(indexable, bool)[aidx]
                np_ok = (a_ok & ixa & (name_lc_a >= 0) & (name >= 0)
                         & (name < c.max_span_names))
                if np_ok.any():
                    name_parts.append(
                        a_svc[np_ok] * c.max_span_names + name[np_ok])
                # Top annotations (user annotations only — av_ok).
                av = np.asarray(b.ann_value_id, np.int64)
                av_ok = (a_ok & (av >= FIRST_USER_ANNOTATION_ID)
                         & (av < c.max_annotation_values))
                if av_ok.any():
                    av_parts.append(
                        a_svc[av_ok] * c.max_annotation_values
                        + av[av_ok])
            # Top binary keys (bk_ok).
            bk_svc = np.asarray(b.bann_service_id, np.int64)
            bk = np.asarray(b.bann_key_id, np.int64)
            bk_ok = ((bk_svc >= 0) & (bk_svc < S) & (bk >= 0)
                     & (bk < c.max_binary_keys))
            if bk_ok.any():
                bk_parts.append(
                    bk_svc[bk_ok] * c.max_binary_keys + bk[bk_ok])

        def cat(parts):
            return (np.concatenate(parts) if parts
                    else np.zeros(0, np.int64))

        return SketchDelta(
            cat(hist_parts), cat(svc_parts), cat(name_parts),
            cat(av_parts), cat(bk_parts), cat(hll_i_parts),
            (np.concatenate(hll_r_parts) if hll_r_parts
             else np.zeros(0, np.int32)),
            win=self._window_updates(group),
        )

    def _window_updates(self, group):
        """Per-chunk windowed-arena rows — one WindowUpdate per launch
        chunk, pre-masked exactly like the device step's w_ok (the
        chained unit runs one step per chunk, and the epoch war is
        stateful, so apply() folds them in order)."""
        c = self.config
        if not c.window_enabled:
            return ()
        ea, eb = (win.error_ids(self.dicts) if self.dicts is not None
                  else (-1, -1))
        return tuple(
            win.plan_window_update(
                batch, win.span_error_flags(batch, ea, eb), c)
            for batch, _, _ in group
        )

    def apply(self, delta: SketchDelta) -> None:  # under the state lock
        """Fold one unit's delta in — called from the commit stage
        INSIDE the store's state-lock hold, immediately before the
        frontier bump, so sketch-tier reads at frontier F always
        include every commit ≤ F."""
        with self._lock:
            np.add.at(self.svc_hist.reshape(-1), delta.hist_idx,
                      np.int32(1))
            np.add.at(self.ann_svc_counts, delta.svc_idx, np.int32(1))
            np.add.at(self.name_presence.reshape(-1), delta.name_idx,
                      np.int32(1))
            np.add.at(self.ann_value_counts.reshape(-1), delta.av_idx,
                      np.int32(1))
            np.add.at(self.bann_key_counts.reshape(-1), delta.bk_idx,
                      np.int32(1))
            np.maximum.at(self.hll_traces, delta.hll_idx,
                          delta.hll_rank)
            for u in delta.win:
                spans, errs = win.apply_window_update(
                    u, self.win_epoch, self.win_counts,
                    self.win_sums, self.win_mm)
                self.win_spans_total += spans
                self.win_errors_total += errs

    # -- reads (engine sketch tier) --------------------------------------

    def service_presence(self) -> np.ndarray:
        with self._lock:
            return self.ann_svc_counts > 0

    def name_row(self, svc: int) -> np.ndarray:
        with self._lock:
            return self.name_presence[svc].copy()

    def hist_row(self, svc: int) -> np.ndarray:
        with self._lock:
            return self.svc_hist[svc].copy()

    def ann_value_row(self, svc: int) -> np.ndarray:
        with self._lock:
            return self.ann_value_counts[svc].copy()

    def bann_key_row(self, svc: int) -> np.ndarray:
        with self._lock:
            return self.bann_key_counts[svc].copy()

    def hll_registers(self) -> np.ndarray:
        with self._lock:
            return self.hll_traces.copy()

    def window_row(self, svc: int):
        """(epoch, counts[svc], sums[svc], mm[svc]) copies — one
        service's windowed cells for the analytics read path."""
        with self._lock:
            return (self.win_epoch.copy(), self.win_counts[svc].copy(),
                    self.win_sums[svc].copy(), self.win_mm[svc].copy())

    def window_arrays(self):
        """Snapshot of the full window arena (bitwise gates + the
        all-service heatmap)."""
        with self._lock:
            return (self.win_epoch.copy(), self.win_counts.copy(),
                    self.win_sums.copy(), self.win_mm.copy())

    def window_live_cells(self) -> int:
        """Occupied (service, bucket) cells — the
        zipkin_window_cells_active gauge."""
        with self._lock:
            return int(((self.win_counts[:, :, 0] > 0)
                        & (self.win_epoch >= 0)[None, :]).sum())

    def arrays(self) -> Sequence[np.ndarray]:
        """Snapshot of every mirrored array (conformance tests compare
        these bitwise against the device state)."""
        with self._lock:
            return (self.svc_hist.copy(), self.ann_svc_counts.copy(),
                    self.name_presence.copy(),
                    self.ann_value_counts.copy(),
                    self.bann_key_counts.copy(), self.hll_traces.copy(),
                    self.win_epoch.copy(), self.win_counts.copy(),
                    self.win_sums.copy(), self.win_mm.copy())


class FleetMirror:
    """Lazily merged fleet view over N per-shard ``SketchMirror`` twins
    — the sharded store's zero-dispatch sketch tier.

    Every lifetime aggregate is a monoid, so the fleet value is the
    shard values folded by the SAME reduction the sharded store's
    cross-shard reads use: integer sums for the count arrays,
    elementwise max for the HLL registers. Integer adds are
    order-independent, so the host fold is bitwise-equal to the
    device's cross-shard reduction.

    The windowed arena needs the epoch rule, not a plain sum: shards
    rotate slot ``w`` independently (each shard's epoch war runs on its
    own ingest), so a slot's merged epoch is the max over shards, and
    only shards AT that epoch contribute counts/sums (a shard still on
    an older epoch received no spans for the newer window — its slot
    holds a different, dead window). min/max cells fold by
    ``np.maximum`` over the contributing shards (I32_MIN fill loses to
    any real value). This is exactly the single-store value: every span
    landed on exactly one shard, and integer adds commute.

    The merge is rebuilt only when ``version_fn()`` (the store's commit
    frontier) moves — steady-state reads are dict lookups into a cached
    ``SketchMirror``, zero device traffic and zero re-merges."""

    def __init__(self, config, mirrors, version_fn):
        self.config = config
        self.gamma = mirrors[0].gamma if mirrors else (
            (1.0 + config.quantile_alpha) / (1.0 - config.quantile_alpha))
        self._mirrors = list(mirrors)
        self._version_fn = version_fn
        # Rank BELOW the shard mirrors' 50: the refresh calls
        # ``SketchMirror.arrays()`` (which takes each mirror's lock)
        # while holding this one.
        self._lock = threading.Lock()  # lock-order: 48 fleet-mirror
        self._merged = None  # guarded-by: _lock
        self._merged_version = None  # guarded-by: _lock

    @property
    def warm(self) -> bool:
        return all(m.warm for m in self._mirrors)

    def mark_cold(self) -> None:
        for m in self._mirrors:
            m.mark_cold()
        with self._lock:
            self._merged = None
            self._merged_version = None

    def _merge_locked(self) -> "SketchMirror":  # called-under: _lock
        version = self._version_fn()
        if (self._merged is not None
                and self._merged_version == version):
            return self._merged
        snaps = [m.arrays() for m in self._mirrors]
        out = SketchMirror(self.config)
        (out.svc_hist, out.ann_svc_counts, out.name_presence,
         out.ann_value_counts, out.bann_key_counts) = (
            sum(np.asarray(s[i]) for s in snaps)
            for i in range(5)
        )
        out.hll_traces = np.maximum.reduce([s[5] for s in snaps])
        if self.config.window_enabled and snaps:
            epochs = np.stack([s[6] for s in snaps])  # [n, Wn]
            merged_epoch = epochs.max(axis=0)
            live = epochs == merged_epoch[None, :]  # [n, Wn]
            counts = np.stack([s[7] for s in snaps])  # [n, S, Wn, f]
            sums = np.stack([s[8] for s in snaps])
            mm = np.stack([s[9] for s in snaps])
            mask = live[:, None, :, None]
            out.win_epoch = merged_epoch
            out.win_counts = np.where(mask, counts, 0).sum(
                axis=0, dtype=counts.dtype)
            out.win_sums = np.where(mask, sums, 0).sum(
                axis=0, dtype=sums.dtype)
            out.win_mm = np.where(mask, mm, win.I32_MIN).max(axis=0)
        self._merged = out
        self._merged_version = version
        return out

    def _view(self) -> "SketchMirror":
        with self._lock:
            return self._merge_locked()

    # Lifetime fold counters: plain sums over the shard mirrors (each
    # span folded into exactly one shard's arena).
    @property
    def win_spans_total(self) -> int:
        return sum(m.win_spans_total for m in self._mirrors)

    @property
    def win_errors_total(self) -> int:
        return sum(m.win_errors_total for m in self._mirrors)

    # -- SketchMirror reader surface (engine sketch tier) ---------------

    def service_presence(self) -> np.ndarray:
        return self._view().ann_svc_counts > 0

    def name_row(self, svc: int) -> np.ndarray:
        return self._view().name_presence[svc].copy()

    def hist_row(self, svc: int) -> np.ndarray:
        return self._view().svc_hist[svc].copy()

    def ann_value_row(self, svc: int) -> np.ndarray:
        return self._view().ann_value_counts[svc].copy()

    def bann_key_row(self, svc: int) -> np.ndarray:
        return self._view().bann_key_counts[svc].copy()

    def hll_registers(self) -> np.ndarray:
        return self._view().hll_traces.copy()

    def window_row(self, svc: int):
        v = self._view()
        return (v.win_epoch.copy(), v.win_counts[svc].copy(),
                v.win_sums[svc].copy(), v.win_mm[svc].copy())

    def window_arrays(self):
        v = self._view()
        return (v.win_epoch.copy(), v.win_counts.copy(),
                v.win_sums.copy(), v.win_mm.copy())

    def window_live_cells(self) -> int:
        v = self._view()
        return int(((v.win_counts[:, :, 0] > 0)
                    & (v.win_epoch >= 0)[None, :]).sum())

    def arrays(self) -> Sequence[np.ndarray]:
        v = self._view()
        return (v.svc_hist.copy(), v.ann_svc_counts.copy(),
                v.name_presence.copy(), v.ann_value_counts.copy(),
                v.bann_key_counts.copy(), v.hll_traces.copy(),
                v.win_epoch.copy(), v.win_counts.copy(),
                v.win_sums.copy(), v.win_mm.copy())
