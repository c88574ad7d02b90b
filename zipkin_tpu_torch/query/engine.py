"""Resident query engine: three latency tiers over the SpanStore SPI
(the port's copy of ``zipkin_tpu/query/engine.py``).

A read that reaches the card pays a launch, its host syncs and the copy
of its matrices back, whatever its work. The engine splits the read
path so most requests never touch the card, and the ones that must
share launches:

1. **Sketch tier** — quantiles, top-k annotations/keys, HLL
   cardinality, and the service/span-name catalogs answered entirely
   from the host sketch mirror (store/mirror.SketchMirror): numpy
   twins of the store's lifetime aggregate tensors, updated
   incrementally by the ingest commit inside the write-lock hold.
   ZERO device round-trips; answers are bitwise what the store's own
   read path returns (tests/test_torch_query_engine.py). On a
   TieredSpanStore the catalog federates the cold tier from zone-map
   metadata alone (``cold_service_ids`` — host memory, no
   decompression).

2. **Index tier** — trace-id reads ride the standing executor
   (query/coalesce.ResidentCoalescer): one continuously running thread
   feeds every concurrent request's probes into ONE
   ``get_trace_ids_multi`` call (one ``dev.iquery_trace_ids_multi``
   pass over the unified [slots, 3] arena) with double-buffered
   staging, so N concurrent requests cost one probe pass instead of N.
   The executor thread reads on its current CUDA stream, the default
   stream every store read uses, under the store's ``_state_lock``;
   it adds no stream.

3. **Result cache** — host-side, keyed on ``(normalized query,
   store.write_frontier())``. The frontier is the store's host commit
   counter (``TorchSpanStore._step_seq``, advanced inside every commit
   under the write lock, so ring eviction is a frontier advance) plus
   a read epoch covering pin/TTL mutations. No device fetch;
   invalidation is precise: a cached entry is only ever served at the
   exact frontier it was computed at, and an entry is only STORED when
   the frontier did not move during its computation (so a result that
   raced a commit can be returned once but never pinned stale).

Stores without a frontier (the in-memory store) bypass the cache;
stores without a sketch mirror bypass tier 1 — the engine degrades to
a thin executor facade with identical semantics.

Observability: ``zipkin_query_serve_seconds{tier=sketch|cache|index}``
is end-to-end request service time including cache/sketch hits;
``zipkin_query_dispatch_seconds`` isolates the store call itself (the
index tier's probe pass and its copy back). Cache hits/misses and
sketch answers are counters.

Lifecycle: the engine registers itself on the store
(``register_query_engine``), so ``Collector.flush``/``close`` and
``checkpoint.save`` join the executor into the ordered
drain-queries → drain-pipeline → seal-barrier → WAL-fsync →
checkpoint sequence — no query read races the checkpoint gather.
After ``close()`` queries still answer (inline, uncoalesced).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Set

import numpy as np

from zipkin_tpu_torch.query.coalesce import ResidentCoalescer
from zipkin_tpu_torch.store.base import ReadSpanStore, service_scan_only

# Cross-request micro-batch window (s) for stores with a batched
# multi-probe kernel; host backends default to 0 (no sleep — see
# QueryEngine._default_window).
DEFAULT_COALESCE_WINDOW_S = 0.002

_MISS = object()


def _copy_json(v):
    """Cheap deep copy for the JSON trees the windowed endpoints
    return (dicts/lists of scalars) — cache hits must never alias a
    mutable value a caller can corrupt (the r11 quantiles lesson)."""
    if isinstance(v, dict):
        return {k: _copy_json(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_json(x) for x in v]
    return v


class _ResultCache:
    """Bounded LRU over ((method, args...), frontier) keys. Entries at
    a superseded frontier can never be served (the lookup key carries
    the CURRENT frontier) and age out of the LRU bound."""

    def __init__(self, entries: int = 1024):
        self.entries = entries
        self._lock = threading.Lock()  # lock-order: 70 result-cache
        self._map: "OrderedDict" = OrderedDict()  # guarded-by: _lock

    def get(self, key):
        with self._lock:
            v = self._map.get(key, _MISS)
            if v is not _MISS:
                self._map.move_to_end(key)
            return v

    def put(self, key, value) -> None:
        with self._lock:
            self._map[key] = value
            self._map.move_to_end(key)
            while len(self._map) > self.entries:
                self._map.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def clear(self) -> None:
        with self._lock:
            self._map.clear()


class QueryEngine:
    """The resident read path over one SpanStore (see module doc).

    Exposes the read SPI; anything else delegates to the wrapped
    store. QueryService routes every read through an engine;
    construct one directly to reuse across services."""

    def __init__(self, store, window_s: Optional[float] = None,
                 registry=None, cache_entries: int = 1024):
        from zipkin_tpu_torch import obs

        self.store = store
        self.hot = getattr(store, "hot", store)
        reg = registry or obs.default_registry()
        if window_s is None:
            window_s = self._default_window(store)
        self.h_serve = reg.register(obs.LatencySketch(
            "zipkin_query_serve_seconds",
            "Query serve latency end-to-end, by answering tier "
            "(sketch/cache hits included — the user-visible number)",
            labelnames=("tier",)))
        self.h_dispatch = reg.register(obs.LatencySketch(
            "zipkin_query_dispatch_seconds",
            "Device launch + D2H time per query dispatch (the index "
            "tier's floor; sketch/cache answers never appear here)"))
        self.c_hits = reg.register(obs.Counter(
            "zipkin_query_cache_hits_total",
            "Reads answered from the frontier-keyed result cache"))
        self.c_misses = reg.register(obs.Counter(
            "zipkin_query_cache_misses_total",
            "Reads that missed the result cache (served by a lower "
            "tier, then cached when the frontier held still)"))
        self.c_sketch = reg.register(obs.Counter(
            "zipkin_query_sketch_answers_total",
            "Reads answered from host-mirrored sketches "
            "(zero device round-trips)"))
        self.h_window = reg.register(obs.LatencySketch(
            "zipkin_window_query_seconds",
            "Windowed-analytics serve latency by endpoint "
            "(windowed_quantiles / slo_burn / latency_heatmap — "
            "sketch-tier: mirror cells + Moments solve, no device)",
            labelnames=("endpoint",)))
        self.executor = ResidentCoalescer(
            store, window_s=window_s, registry=reg,
            dispatch_timer=self.h_dispatch.observe)
        self.cache = _ResultCache(cache_entries)
        reg.register(obs.Gauge(
            "zipkin_query_cache_entries",
            "Live result-cache entries (all frontiers, LRU-bounded)",
            fn=lambda: float(len(self.cache))))
        self._frontier_fn = getattr(store, "write_frontier", None)
        register = getattr(store, "register_query_engine", None)
        if register is not None:
            register(self)

    @staticmethod
    def _default_window(store) -> float:
        """The window only pays against a per-dispatch floor: stores
        overriding the port's ``ReadSpanStore.get_trace_ids_multi``
        (the device store's one-pass batched probe) get the 2 ms
        window; host backends keep 0 so a lone request pays no sleep
        (concurrency alone still builds batches while a read is in
        flight)."""
        batched = (type(store).get_trace_ids_multi
                   is not ReadSpanStore.get_trace_ids_multi)
        return DEFAULT_COALESCE_WINDOW_S if batched else 0.0

    # -- window (runtime adjustable: daemon /vars/queryWindowMs) --------

    @property
    def window_s(self) -> float:
        return self.executor.window_s

    @window_s.setter
    def window_s(self, v: float) -> None:
        self.executor.window_s = float(v)

    # -- tier plumbing ---------------------------------------------------

    def _frontier(self):
        fn = self._frontier_fn
        return fn() if fn is not None else None

    def _serve(self, tier: str, t0: float) -> None:
        self.h_serve.labels(tier=tier).observe(time.perf_counter() - t0)

    def _cached(self, key: tuple, compute, copy=lambda v: v):
        """Frontier-keyed read-through: serve the cache at the current
        frontier, else compute (timing the store call as dispatch) and
        cache ONLY if the frontier held still across the computation —
        a result that raced a commit may be returned once but is never
        pinned."""
        t0 = time.perf_counter()
        f1 = self._frontier()
        if f1 is not None:
            v = self.cache.get((key, f1))
            if v is not _MISS:
                self.c_hits.inc()
                self._serve("cache", t0)
                return copy(v)
            self.c_misses.inc()
        td = time.perf_counter()
        value = compute()
        self.h_dispatch.observe(time.perf_counter() - td)
        if f1 is not None and self._frontier() == f1:
            self.cache.put((key, f1), value)
        self._serve("index", t0)
        return copy(value)

    def _sketch_mirror(self):
        """The hot store's WARM sketch mirror, or None when the store
        has no mirror (the in-memory backend)."""
        ensure = getattr(self.hot, "ensure_sketch_mirror", None)
        return ensure() if ensure is not None else None

    # -- index tier: trace-id lookups ------------------------------------

    def get_trace_ids_multi(self, queries) -> List[list]:
        """The read hub: per-query result cache in front of the
        standing executor; only misses ride a device launch. Results
        are exactly serial store execution's."""
        t0 = time.perf_counter()
        queries = [tuple(q) for q in queries]
        if not queries:
            return []
        f1 = self._frontier()
        results: List[Optional[list]] = [None] * len(queries)
        misses: List[int] = []
        if f1 is not None:
            for i, q in enumerate(queries):
                v = self.cache.get((("ids", q), f1))
                if v is _MISS:
                    misses.append(i)
                else:
                    results[i] = list(v)
            self.c_hits.inc(len(queries) - len(misses))
            self.c_misses.inc(len(misses))
        else:
            misses = list(range(len(queries)))
        if misses:
            fresh = self.executor.run([queries[i] for i in misses])
            cacheable = f1 is not None and self._frontier() == f1
            for i, r in zip(misses, fresh):
                results[i] = r
                if cacheable:
                    self.cache.put((("ids", queries[i]), f1), list(r))
        self._serve("cache" if not misses else "index", t0)
        return results  # type: ignore[return-value]

    def get_trace_ids_by_name(self, service_name, span_name, end_ts,
                              limit):
        return self.get_trace_ids_multi(
            [("name", service_name, span_name, end_ts, limit)])[0]

    def get_trace_ids_by_annotation(self, service_name, annotation,
                                    value, end_ts, limit):
        return self.get_trace_ids_multi(
            [("annotation", service_name, annotation, value, end_ts,
              limit)])[0]

    # -- index tier: row reads (frontier-cached) -------------------------

    def traces_exist(self, trace_ids: Sequence[int]) -> Set[int]:
        ids = tuple(trace_ids)
        return self._cached(("exist", ids),
                            lambda: self.store.traces_exist(ids),
                            copy=set)

    def get_spans_by_trace_ids(self, trace_ids: Sequence[int]):
        ids = tuple(trace_ids)
        return self._cached(
            ("spans", ids),
            lambda: self.store.get_spans_by_trace_ids(ids),
            copy=lambda v: [list(t) for t in v])

    def get_traces_duration(self, trace_ids: Sequence[int]):
        ids = tuple(trace_ids)
        return self._cached(
            ("durations", ids),
            lambda: self.store.get_traces_duration(ids), copy=list)

    def get_dependencies(self, start_ts=None, end_ts=None):
        # The first read after writes runs the store's pending sweep
        # (a frontier advance), so it computes-without-caching; repeat
        # reads of a quiet store hit the cache.
        # Dependencies is a frozen dataclass (tuple links) — immutable,
        # so the cached object is safe to hand out by reference.
        return self._cached(
            ("deps", start_ts, end_ts),
            lambda: self.store.get_dependencies(start_ts, end_ts))

    # -- sketch tier: catalogs + aggregates ------------------------------

    def get_all_service_names(self) -> Set[str]:
        t0 = time.perf_counter()
        m = self._sketch_mirror()
        hot = self.hot
        if m is None or len(hot.dicts.services) > hot.config.max_services:
            # Dictionary-overflow services live only in raw ring
            # columns (a device scan) — the store path handles them.
            return self._cached(
                ("service_names",),
                lambda: self.store.get_all_service_names(), copy=set)
        d = hot.dicts.services
        out = {
            d.decode(i) for i in np.flatnonzero(m.service_presence())
            if i < len(d) and d.decode(i)
        }
        cold_ids = getattr(self.store, "cold_service_ids", None)
        if cold_ids is not None:
            out.update(
                name for i in cold_ids()
                if i < len(d) and (name := d.decode(i))
            )
        self.c_sketch.inc()
        self._serve("sketch", t0)
        return out

    def get_span_names(self, service: str) -> Set[str]:
        t0 = time.perf_counter()
        m = self._sketch_mirror()
        hot = self.hot
        fallback = (m is None or hot is not self.store)
        svc = None
        if not fallback:
            svc = hot.dicts.services.get(service.lower())
            if svc is None:
                self.c_sketch.inc()
                self._serve("sketch", t0)
                return set()
            fallback = service_scan_only(svc, hot.config)
        if fallback:
            # Tiered stores decode cold segments for span names, and
            # overflow services need the ring scan — both store paths.
            return self._cached(
                ("span_names", service),
                lambda: self.store.get_span_names(service), copy=set)
        row = m.name_row(svc) > 0
        d = hot.dicts.span_names
        out = {
            d.decode(i) for i in np.flatnonzero(row)
            if i < len(d) and d.decode(i)
        }
        self.c_sketch.inc()
        self._serve("sketch", t0)
        return out

    def _scan_only(self, service: str):
        """(mirror, svc_id, scan_only) for a per-service aggregate —
        these delegate to the HOT store on every backend that has
        them, so the mirror serves tiered stores too."""
        m = self._sketch_mirror()
        if m is None:
            return None, None, True
        svc = self.hot.dicts.services.get(service.lower())
        if svc is None:
            return m, None, False
        return m, svc, service_scan_only(svc, self.hot.config)

    def service_duration_quantiles(self, service: str,
                                   qs: Sequence[float]):
        from zipkin_tpu_torch.ops.quantile import quantiles_host

        t0 = time.perf_counter()
        m, svc, scan = self._scan_only(service)
        if scan:
            return self._cached(
                ("quantiles", service, tuple(qs)),
                lambda: self.store.service_duration_quantiles(
                    service, list(qs)),
                copy=lambda v: None if v is None else list(v))
        self.c_sketch.inc()
        if svc is None:
            self._serve("sketch", t0)
            return None
        vals = quantiles_host(m.hist_row(svc), m.gamma, 1.0, list(qs))
        self._serve("sketch", t0)
        return vals

    def _top_row(self, service: str, k: int, row_of, dictionary,
                 store_fn, kind: str):
        t0 = time.perf_counter()
        m, svc, scan = self._scan_only(service)
        if scan:
            return self._cached((kind, service, k),
                                lambda: store_fn(service, k), copy=list)
        self.c_sketch.inc()
        if svc is None:
            self._serve("sketch", t0)
            return []
        row = row_of(m, svc)
        order = np.argsort(-row)[:k]
        d = dictionary
        out = [
            (d.decode(int(i)), int(row[i])) for i in order
            if row[i] > 0 and i < len(d)
        ]
        self._serve("sketch", t0)
        return out

    def top_annotations(self, service: str, k: int = 10):
        return self._top_row(
            service, k, lambda m, s: m.ann_value_row(s),
            self.hot.dicts.annotations,
            self.store.top_annotations, "top_ann")

    def top_binary_keys(self, service: str, k: int = 10):
        return self._top_row(
            service, k, lambda m, s: m.bann_key_row(s),
            self.hot.dicts.binary_keys,
            self.store.top_binary_keys, "top_bkey")

    def estimated_unique_traces(self) -> float:
        from zipkin_tpu_torch.ops import hll

        t0 = time.perf_counter()
        m = self._sketch_mirror()
        if m is None:
            return self._cached(
                ("unique_traces",),
                lambda: self.store.estimated_unique_traces())
        # The store's own estimator (float64 on the host) on the
        # mirror's registers, which equal the device leaf: the same
        # estimate bit for bit.
        est = float(hll.estimate(m.hll_registers()))
        self.c_sketch.inc()
        self._serve("sketch", t0)
        return est

    # -- sketch tier: windowed analytics ---------------------------------
    # (aggregate/windows.py): the hot store's mirror answers windowed
    # quantiles / burn rates / heatmaps from the (service ×
    # time-bucket) Moments-sketch cells — host math only. Backends
    # without the arena (the in-memory store) fall back to their own exact-scan
    # implementations through the frontier cache; stores with neither
    # answer None.

    def _window_call(self, endpoint: str, cache_key: tuple, args: tuple,
                     kwargs: dict, copy=lambda v: v):
        t0 = time.perf_counter()
        hot = self.hot
        fn = getattr(hot, endpoint, None)
        if fn is not None and hasattr(hot, "ensure_sketch_mirror"):
            out = fn(*args, **kwargs)
            if out is None:
                # Disabled arena / unknown service: a null body is not
                # a sketch answer — don't inflate the sketch counters.
                return None
            self.c_sketch.inc()
            self.h_window.labels(endpoint=endpoint).observe(
                time.perf_counter() - t0)
            self._serve("sketch", t0)
            return out
        store_fn = getattr(self.store, endpoint, None)
        if store_fn is None:
            return None
        out = self._cached(cache_key,
                           lambda: store_fn(*args, **kwargs),
                           copy=lambda v: v if v is None else copy(v))
        if out is not None:
            self.h_window.labels(endpoint=endpoint).observe(
                time.perf_counter() - t0)
        return out

    def windowed_quantiles(self, service: str, qs,
                           start_us=None, end_us=None):
        qs = list(qs)
        return self._window_call(
            "windowed_quantiles",
            ("win_q", service, tuple(qs), start_us, end_us),
            (service, qs), {"start_us": start_us, "end_us": end_us},
            copy=list)

    def slo_burn(self, service: str, objective=None, windows_s=None,
                 now_us=None):
        key = ("win_burn", service, objective,
               tuple(windows_s) if windows_s else None, now_us)
        return self._window_call(
            "slo_burn", key, (service,),
            {"objective": objective, "windows_s": windows_s,
             "now_us": now_us}, copy=_copy_json)

    def latency_heatmap(self, service: str, start_us=None, end_us=None,
                        bands=None):
        return self._window_call(
            "latency_heatmap",
            ("win_heat", service, start_us, end_us, bands),
            (service,),
            {"start_us": start_us, "end_us": end_us, "bands": bands},
            copy=_copy_json)

    # -- lifecycle -------------------------------------------------------

    def drain(self) -> None:
        """Quiesce barrier: block until the standing executor has no
        launch in flight (Collector.flush / checkpoint.save ordering)."""
        self.executor.drain()

    def close(self) -> None:
        """Stop the executor thread; queries keep answering inline.
        Deregisters from the store so short-lived engines (tests,
        per-request embeddings) don't accumulate in its registry."""
        self.executor.close()
        engines = self.store.__dict__.get("_query_engines")
        if engines is not None and self in engines:
            engines.remove(self)

    # -- store passthrough ----------------------------------------------

    def __getattr__(self, name):
        # Reads the engine doesn't tier (TTL lookups are already
        # host-side) and store admin (counters, set_time_to_live, …)
        # delegate untouched. Only called when normal lookup fails.
        if name == "store":  # not yet bound (mid-__init__/unpickle)
            raise AttributeError(name)
        return getattr(self.store, name)
