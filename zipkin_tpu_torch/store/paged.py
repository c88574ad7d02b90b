"""Host page planner for the paged span layout (r19).

The port's own copy of ``zipkin_tpu/store/paged.py``, line for line:
pure numpy host code, so its plans and snapshots are the reference
planner's exactly (tests/test_torch_paged.py holds the two together).

The ring's skew tax is geometric: one global FIFO means a 10k-span
batch trace and a 1-span health poll compete for the same slot window,
so keeping a slow trace complete requires provisioning the whole ring
for churn-rate x trace-lifetime. The paged layout (the "Ragged Paged
Attention" design, PAPERS.md) carves the SAME span arena into
``capacity / page_rows`` fixed pages allocated from a free list:

- big traces (>= page_rows/2 spans in a unit, or already holding an
  open page) get EXCLUSIVE pages chained per trace — their rows are
  block-contiguous for the Pallas page gather and survive together;
- small traces share a communal open page (a 1-span poll costs one
  row, not a page) — page rows are validated per (slot, epoch) at read
  time, so sharing is free;
- reclaim takes the least-recently-WRITTEN non-open page, captures its
  rows through the cold-tier path, splices it out of every owner's
  chain, and hands it back with a fresh epoch.

gids stay epoch-encoded: ``gid = page_epoch * capacity + slot`` with
``slot = page * page_rows + offset``, so ``slot == gid % capacity``
and every ring-scan liveness check in store/device.py works unchanged.

Everything here is a PURE function of the unit stream (chunk trace-id
sequences in feed order), which is what keeps WAL replay and the crash
harness bitwise: replaying the same units re-derives the same claims.
The ``recent``/``note_seq`` memo covers the pipelined-save window where
stage-1 planning runs ahead of the device frontier — a checkpoint's
planner snapshot may include units the gathered state hasn't applied
yet, and replay must REUSE those recorded claims instead of
re-planning them on top of the snapshot.

Concurrency: one planner lock, ordered after the encode lock (stage-1
plans while holding store._lock) and before the capture/commit locks.
"""

from __future__ import annotations

import threading
from collections import Counter, OrderedDict, deque
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

# Units planned while a checkpoint was in flight must be replayable
# from the snapshot: keep this many recent unit plans keyed by WAL seq
# (>= any sane pipeline depth + stage buffers).
RECENT_PLANS = 64

# A trace addressable through the page table spans at most
# config.page_max_chain pages; beyond that it stays correct but its
# reads fall back to the exact ring scan (bounded host memory).


class ChunkPlan(NamedTuple):
    span_slot: np.ndarray       # i32 [n_spans]
    span_gid: np.ndarray        # i64 [n_spans]
    reclaim_pages: np.ndarray   # i32 [k] pages this chunk invalidates


class UnitPlan(NamedTuple):
    chunks: Tuple[ChunkPlan, ...]
    # (lo, hi) gid ranges of every page the unit reclaims — captured by
    # TpuSpanStore._capture_pages BEFORE the unit's launch so the
    # captured-before-overwrite invariant holds per page.
    reclaims: Tuple[Tuple[int, int], ...]


class _Trace:
    __slots__ = ("chain", "live", "overflowed")

    def __init__(self):
        self.chain: List[Tuple[int, int]] = []  # (page, epoch)
        self.live = 0
        self.overflowed = False


class PagePlanner:
    """Deterministic free-list page allocator + per-trace page table.

    All mutable fields below are guarded-by: _lock (plan_unit runs
    under the store encode lock as well; queries and metrics take only
    the planner lock).
    """

    def __init__(self, config):
        if not config.paged_enabled:
            raise ValueError("PagePlanner requires layout='paged'")
        R = int(config.page_rows)
        cap = int(config.capacity)
        if R < 8 or (R & (R - 1)) != 0:
            raise ValueError("page_rows must be a power of two >= 8")
        if cap % R != 0:
            raise ValueError("capacity must be a multiple of page_rows")
        n_pages = cap // R
        if n_pages < 8:
            raise ValueError(
                "paged layout needs >= 8 pages "
                f"(capacity {cap} / page_rows {R} = {n_pages})")
        self.config = config
        self.R = R
        self.capacity = cap
        self.n_pages = n_pages
        self.max_chain = int(config.page_max_chain)
        self.big_thresh = max(1, R // 2)
        # At most this many traces keep an open exclusive page; past it
        # the least-recently-written open page is closed (stays active
        # and reclaimable — no data moves).
        self.max_open = max(1, n_pages // 4)
        self._lock = threading.Lock()  # lock-order: 15 paged-planner
        # ---- page pool (guarded-by: _lock) ----
        self.free = deque(range(n_pages))
        self.page_epoch = [-1] * n_pages     # -1 = free
        self.page_fill = [0] * n_pages
        self.page_touch = [0] * n_pages      # last-write stamp
        self.page_owners: List[List[int]] = [[] for _ in range(n_pages)]
        self._owner_sets: List[set] = [set() for _ in range(n_pages)]
        self.open_shared: Optional[int] = None
        self.open_excl: Dict[int, int] = {}  # tid -> page
        self.traces: Dict[int, _Trace] = {}
        self.epoch_next = 0
        self.touch_next = 1
        self.reclaims_total = 0
        # ---- WAL replay memo (guarded-by: _lock) ----
        self.last_seq = 0
        self.recent: "OrderedDict[int, UnitPlan]" = OrderedDict()
        self._pending: Optional[UnitPlan] = None

    # -- planning ------------------------------------------------------

    def plan_unit(self, chunk_tids: List[np.ndarray],
                  wal_seq: Optional[int] = None) -> UnitPlan:
        """Assign a (slot, gid) pair to every span of every chunk and
        decide which pages the unit reclaims. ``chunk_tids`` is the
        per-chunk trace-id column (valid rows only), in feed order.
        During WAL replay ``wal_seq`` selects a recorded plan for units
        the snapshot already planned (seq <= last_seq) — state is NOT
        mutated for those."""
        with self._lock:
            if wal_seq is not None and wal_seq <= self.last_seq:
                plan = self.recent.get(wal_seq)
                if plan is None:
                    raise KeyError(
                        f"paged plan for WAL seq {wal_seq} fell out of "
                        f"the {RECENT_PLANS}-unit replay memo")
                return plan
            unit_touched: set = set()
            reclaims: List[Tuple[int, int]] = []
            chunks = []
            for tids in chunk_tids:
                chunks.append(
                    self._plan_chunk(np.asarray(tids), unit_touched,
                                     reclaims))
            plan = UnitPlan(tuple(chunks), tuple(reclaims))
            self._pending = plan
            if wal_seq is not None:
                self._note_seq_locked(wal_seq)
            return plan

    def note_seq(self, wal_seq: int) -> None:
        """Key the plan made by the immediately preceding plan_unit to
        its WAL seq (the store calls this right after _journal_group,
        still under the encode lock — append order == feed order)."""
        with self._lock:
            self._note_seq_locked(wal_seq)

    def _note_seq_locked(self, wal_seq: int) -> None:
        if self._pending is None:
            return
        self.recent[wal_seq] = self._pending
        self._pending = None
        self.last_seq = max(self.last_seq, wal_seq)
        while len(self.recent) > RECENT_PLANS:
            self.recent.popitem(last=False)

    def _plan_chunk(self, tids: np.ndarray, unit_touched: set,
                    reclaims: List[Tuple[int, int]]) -> ChunkPlan:
        n = len(tids)
        slots = np.empty(n, np.int32)
        gids = np.empty(n, np.int64)
        counts = Counter(int(t) for t in tids)
        chunk_reclaims: List[int] = []
        R = self.R
        # Trace-granular LRW: a WRITING trace refreshes its whole live
        # chain before this chunk claims pages, so reclaim prefers
        # pages of IDLE traces over earlier pages of still-active ones.
        # This is the retention win over the FIFO ring — a long-running
        # trace's old spans survive wrap as long as it keeps writing —
        # and it stays deterministic from the unit stream (insertion-
        # ordered iteration, monotone stamps), which WAL replay needs.
        for tid in counts:
            ent = self.traces.get(tid)
            if ent is None:
                continue
            for page, epoch in ent.chain:
                if self.page_epoch[page] == epoch:
                    self.page_touch[page] = self.touch_next
                    self.touch_next += 1
        for i in range(n):
            tid = int(tids[i])
            big = tid in self.open_excl or counts[tid] >= self.big_thresh
            if big:
                page = self.open_excl.get(tid)
                if page is None or self.page_fill[page] >= R:
                    page = self._claim(unit_touched, reclaims,
                                       chunk_reclaims)
                    self._open_excl_put(tid, page)
            else:
                page = self.open_shared
                if page is None or self.page_fill[page] >= R:
                    page = self._claim(unit_touched, reclaims,
                                       chunk_reclaims)
                    self.open_shared = page
            j = self.page_fill[page]
            self.page_fill[page] = j + 1
            slots[i] = page * R + j
            gids[i] = self.page_epoch[page] * self.capacity + page * R + j
            self.page_touch[page] = self.touch_next
            self.touch_next += 1
            unit_touched.add(page)
            if tid not in self._owner_sets[page]:
                self._owner_sets[page].add(tid)
                self.page_owners[page].append(tid)
            self._track(tid, page, self.page_epoch[page])
        return ChunkPlan(slots, gids,
                         np.asarray(chunk_reclaims, np.int32))

    def _track(self, tid: int, page: int, epoch: int) -> None:
        ent = self.traces.get(tid)
        if ent is None:
            ent = self.traces[tid] = _Trace()
        key = (page, epoch)
        if key not in ent.chain:
            ent.chain.append(key)
            ent.live += 1
            if len(ent.chain) > self.max_chain:
                # Stop page-addressing this trace: its reads fall back
                # to the exact ring scan until its pages all die.
                ent.chain.pop(0)
                ent.overflowed = True

    def _open_excl_put(self, tid: int, page: int) -> None:
        self.open_excl[tid] = page
        if len(self.open_excl) > self.max_open:
            victim = min(
                self.open_excl,
                key=lambda t: (self.page_touch[self.open_excl[t]], t),
            )
            if victim != tid:
                del self.open_excl[victim]
            else:  # pragma: no cover - max_open >= 1 keeps tid
                self.open_excl.pop(
                    next(iter(k for k in self.open_excl if k != tid)),
                    None)

    def _claim(self, unit_touched: set, reclaims, chunk_reclaims) -> int:
        if self.free:
            page = self.free.popleft()
        else:
            page = self._pick_victim(unit_touched)
            self._reclaim(page, reclaims, chunk_reclaims)
        self.page_epoch[page] = self.epoch_next
        self.epoch_next += 1
        self.page_fill[page] = 0
        self.page_owners[page] = []
        self._owner_sets[page] = set()
        self.page_touch[page] = self.touch_next
        self.touch_next += 1
        unit_touched.add(page)
        return page

    def _pick_victim(self, unit_touched: set) -> int:
        """Least-recently-written active page that is neither open nor
        already touched by this unit (its rows must be capturable
        BEFORE the unit's launch). The paged span budget in
        store/tpu.py bounds per-unit page demand well under the pool,
        so a candidate always exists for conforming units."""
        open_set = set(self.open_excl.values())
        if self.open_shared is not None:
            open_set.add(self.open_shared)
        best = -1
        best_touch = None
        for p in range(self.n_pages):
            if self.page_epoch[p] < 0 or p in open_set \
                    or p in unit_touched:
                continue
            t = self.page_touch[p]
            if best_touch is None or t < best_touch:
                best, best_touch = p, t
        if best < 0:
            raise RuntimeError(
                "page pool exhausted within one unit — unit exceeds "
                "the paged span budget (store bug)")
        return best

    def _reclaim(self, page: int, reclaims, chunk_reclaims) -> None:
        old_e = self.page_epoch[page]
        lo = old_e * self.capacity + page * self.R
        reclaims.append((lo, lo + self.R))
        chunk_reclaims.append(page)
        for tid in self.page_owners[page]:
            ent = self.traces.get(tid)
            if ent is None:
                continue
            try:
                ent.chain.remove((page, old_e))
            except ValueError:
                pass  # entry was dropped by a max_chain overflow
            ent.live -= 1
            if ent.live <= 0:
                del self.traces[tid]
                self.open_excl.pop(tid, None)
        self.reclaims_total += 1

    # -- reads ---------------------------------------------------------

    def chains_for(self, qids):
        """(pages i32 [K], epochs i64 [K]) covering every page any of
        ``qids`` has live rows in, deduped (small traces share pages).
        Returns None when any queried trace overflowed its chain —
        caller must use the exact ring-scan gather. Traces unknown to
        the planner have no live rows and contribute nothing."""
        with self._lock:
            pages: List[int] = []
            epochs: List[int] = []
            seen: set = set()
            for tid in qids:
                ent = self.traces.get(int(tid))
                if ent is None:
                    continue
                if ent.overflowed:
                    return None
                for (p, e) in ent.chain:
                    if p not in seen:
                        seen.add(p)
                        pages.append(p)
                        epochs.append(e)
            return (np.asarray(pages, np.int32),
                    np.asarray(epochs, np.int64))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            n_free = len(self.free)
            return {
                "pages_free": n_free,
                "pages_active": self.n_pages - n_free,
                "page_reclaims": self.reclaims_total,
            }

    # -- checkpoint ----------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able planner state for the rev-18 checkpoint meta,
        including the recent-plan memo (units planned ahead of the
        gathered device frontier replay from here)."""
        with self._lock:
            return {
                "free": list(self.free),
                "epoch": list(self.page_epoch),
                "fill": list(self.page_fill),
                "touch": list(self.page_touch),
                "owners": [list(o) for o in self.page_owners],
                "open_shared": self.open_shared,
                "open_excl": [[t, p] for t, p in self.open_excl.items()],
                "traces": [
                    [t, [[p, e] for p, e in ent.chain], ent.live,
                     bool(ent.overflowed)]
                    for t, ent in self.traces.items()
                ],
                "epoch_next": self.epoch_next,
                "touch_next": self.touch_next,
                "reclaims_total": self.reclaims_total,
                "last_seq": self.last_seq,
                "recent": [
                    [seq, [
                        [c.span_slot.tolist(), c.span_gid.tolist(),
                         c.reclaim_pages.tolist()] for c in plan.chunks
                    ], [list(r) for r in plan.reclaims]]
                    for seq, plan in self.recent.items()
                ],
            }

    def restore(self, snap: dict) -> None:
        with self._lock:
            self.free = deque(int(p) for p in snap["free"])
            self.page_epoch = [int(e) for e in snap["epoch"]]
            self.page_fill = [int(f) for f in snap["fill"]]
            self.page_touch = [int(t) for t in snap["touch"]]
            self.page_owners = [[int(t) for t in o]
                                for o in snap["owners"]]
            self._owner_sets = [set(o) for o in self.page_owners]
            self.open_shared = (
                None if snap["open_shared"] is None
                else int(snap["open_shared"]))
            self.open_excl = {int(t): int(p)
                              for t, p in snap["open_excl"]}
            self.traces = {}
            for t, chain, live, over in snap["traces"]:
                ent = _Trace()
                ent.chain = [(int(p), int(e)) for p, e in chain]
                ent.live = int(live)
                ent.overflowed = bool(over)
                self.traces[int(t)] = ent
            self.epoch_next = int(snap["epoch_next"])
            self.touch_next = int(snap["touch_next"])
            self.reclaims_total = int(snap["reclaims_total"])
            self.last_seq = int(snap["last_seq"])
            self.recent = OrderedDict()
            for seq, chunks, reclaims in snap.get("recent", []):
                self.recent[int(seq)] = UnitPlan(
                    tuple(
                        ChunkPlan(np.asarray(s, np.int32),
                                  np.asarray(g, np.int64),
                                  np.asarray(r, np.int32))
                        for s, g, r in chunks),
                    tuple((int(lo), int(hi)) for lo, hi in reclaims),
                )
            self._pending = None

    def rebuild(self, row_gid: np.ndarray, trace_col: np.ndarray,
                wal_applied: int = 0) -> None:
        """Reconstruct the page table from device columns — the compat
        path for snapshots without planner meta (adopt_state, or a
        paged config pointed at a state saved another way). Partial
        pages are NOT reopened (their tails are wasted until reclaim),
        and chain order is epoch order — reads stay exact either way
        because page rows verify per (slot, epoch)."""
        cap, R = self.capacity, self.R
        with self._lock:
            self.free = deque()
            self.open_shared = None
            self.open_excl = {}
            self.traces = {}
            self.recent = OrderedDict()
            self._pending = None
            self.last_seq = int(wal_applied)
            per_trace: Dict[int, List[Tuple[int, int]]] = {}
            max_epoch = -1
            order = []
            for p in range(self.n_pages):
                rows = np.asarray(row_gid[p * R:(p + 1) * R])
                live = rows >= 0
                if not live.any():
                    self.page_epoch[p] = -1
                    self.page_fill[p] = 0
                    self.page_owners[p] = []
                    self._owner_sets[p] = set()
                    self.free.append(p)
                    continue
                e = int(rows[live][0]) // cap
                max_epoch = max(max_epoch, e)
                self.page_epoch[p] = e
                self.page_fill[p] = int(np.nonzero(live)[0][-1]) + 1
                tids = [int(t) for t in
                        np.asarray(trace_col[p * R:(p + 1) * R])[live]]
                owners: List[int] = []
                oset: set = set()
                for t in tids:
                    if t not in oset:
                        oset.add(t)
                        owners.append(t)
                self.page_owners[p] = owners
                self._owner_sets[p] = oset
                order.append((e, p))
                for t in owners:
                    per_trace.setdefault(t, []).append((p, e))
            order.sort()
            for i, (_, p) in enumerate(order):
                self.page_touch[p] = i + 1
            self.touch_next = len(order) + 1
            self.epoch_next = max_epoch + 1
            for t, chain in per_trace.items():
                ent = _Trace()
                ent.chain = sorted(chain, key=lambda pe: pe[1])
                ent.live = len(ent.chain)
                if len(ent.chain) > self.max_chain:
                    ent.chain = ent.chain[-self.max_chain:]
                    ent.overflowed = True
                self.traces[t] = ent
