"""The port's eviction capture and cold tier (``zipkin_tpu_torch/store/
archive``, ``store/device.capture_eviction_rows``, the capture family of
``TorchSpanStore`` and the ``EvictionSealer``) on the CPU, against the
JAX package and the in-memory oracle.

Tolerances, stated:

- the capture pull's valid prefix (the first ``n_s`` span columns, and
  the ann/bann matrices whose tails both packages mask to -1) is
  bitwise equal to the JAX function's;
- the bloom, CMS and HLL sketches are bitwise equal to the JAX module's;
  the log-histogram bucket index is the port's device-exact index
  (``sketches.hist_bucket_index``), which may put a value one bucket
  over from the JAX twin's float32 ``log`` (ROADMAP Queue 3, stated
  tolerance 1), so ``dur_hist`` is held within one bucket;
- a port tiered store fed the same spans as the JAX tiered store seals
  the same segments (boundaries equal, rows and ``to_bytes()`` bitwise:
  this drive's durations sit on no bucket edge) and answers every read
  of the tiered conformance set exactly as the oracle and the JAX
  store do, evicted traces included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_archive import CFG, PARAMS, make_trace  # noqa: E402
from test_torch_store import (  # noqa: E402
    PORT,
    REF,
    _convert,
    _RefSpanAdapter,
    jax_leaves,
)
from zipkin_tpu.aggregate.job import aggregate_spans  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.archive import Segment as RefSegment  # noqa: E402
from zipkin_tpu.store.archive import (  # noqa: E402
    TieredSpanStore as RefTiered,
)
from zipkin_tpu.store.archive import merge_segments as ref_merge  # noqa: E402
from zipkin_tpu.store.archive import sketches as RSK  # noqa: E402
from zipkin_tpu.store.memory import InMemorySpanStore  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu.testing.conformance import (  # noqa: E402
    conformance_test_names,
    run_conformance_test,
)
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.ops.quantile import quantiles_host  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.archive import (  # noqa: E402
    ArchiveParams,
    Segment,
    TieredSpanStore,
    merge_segments,
)
from zipkin_tpu_torch.store.archive import sketches as SK  # noqa: E402
from zipkin_tpu_torch.store.convert import (  # noqa: E402
    state_from_numpy,
    state_to_numpy,
)
from zipkin_tpu_torch.store.memory import (  # noqa: E402
    InMemorySpanStore as PortMemoryStore,
)
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402

PCFG = tdev.StoreConfig(**CFG._asdict())
PPARAMS = ArchiveParams(**PARAMS._asdict())
N_TRACES = 4 * CFG.capacity // 2  # 2 spans a trace: 4 ring laps
END = 1 << 60


def port_tiered(cfg=PCFG, params=PPARAMS, backlog=0):
    hot = TorchSpanStore(cfg, device="cpu", registry=obs.Registry())
    hot.capture_backlog = backlog
    return TieredSpanStore(hot, params=params, registry=obs.Registry())


def drive_three(n_traces=N_TRACES, chunk=64):
    """The same make_trace spans into a JAX tiered store, a port tiered
    store and the JAX oracle, in the same apply calls."""
    ref = RefTiered(TpuSpanStore(CFG), params=PARAMS)
    port = port_tiered()
    oracle = InMemorySpanStore()
    batch = []
    for tid in range(1, n_traces + 1):
        batch.extend(make_trace(tid))
        if len(batch) >= chunk or tid == n_traces:
            ref.apply(batch)
            port.apply(_convert(batch, PORT))
            oracle.apply(batch)
            batch = []
    return ref, port, oracle


@pytest.fixture(scope="module")
def three():
    return drive_three()


def _assert_hist_within_one_bucket(ref, got, what):
    """Stated tolerance 1: every value in the same or an adjacent
    bucket, so the cumulative counts of ``got`` at bucket b lie between
    those of ``ref`` at b - 1 and b + 1."""
    assert ref.sum() == got.sum(), what
    cr, cg = np.cumsum(ref), np.cumsum(got)
    lo = np.concatenate([[0], cr[:-1]])
    hi = np.concatenate([cr[1:], [cr[-1]]])
    assert np.all((lo <= cg) & (cg <= hi)), what


def assert_segments_match(ref_segs, port_segs):
    """Boundaries equal, every row plane bitwise, bloom/CMS/HLL bitwise,
    ``dur_hist`` within stated tolerance 1; and the whole blob bitwise
    where no duration sits on a bucket edge (every drive here)."""
    assert ([(s.seg_id, s.gid_lo, s.gid_hi, s.n_spans) for s in ref_segs]
            == [(s.seg_id, s.gid_lo, s.gid_hi, s.n_spans)
                for s in port_segs])
    for a, b in zip(ref_segs, port_segs):
        assert sorted(a.cols) == sorted(b.cols)
        for col in a.cols:
            assert np.array_equal(a.column(col), b.column(col)), col
        za, zb = a.zone, b.zone
        assert np.array_equal(za.key_cms, zb.key_cms)
        assert np.array_equal(za.trace_bloom, zb.trace_bloom)
        assert np.array_equal(za.hll, zb.hll)
        assert za.service_ids == zb.service_ids
        assert (za.ts_first_min, za.ts_last_min, za.ts_last_max) == (
            zb.ts_first_min, zb.ts_last_min, zb.ts_last_max)
        assert sorted(za.dur_hist) == sorted(zb.dur_hist)
        for svc, row in za.dur_hist.items():
            _assert_hist_within_one_bucket(row, zb.dur_hist[svc],
                                           (a.seg_id, svc))
        assert a.dict_sizes == b.dict_sizes
        assert a.to_bytes() == b.to_bytes(), a.seg_id


# ---------------------------------------------------------------------------
# Sketches and the segment format
# ---------------------------------------------------------------------------


def _keys(seed, n=3000):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)


def test_sketches_bitwise_against_reference():
    keys, more = _keys(1), _keys(2)
    for init, add, merge, args in (
            ("bloom_init", "bloom_add", "bloom_merge", (1 << 14,)),
            ("cms_init", "cms_add", "cms_merge", (4, 1 << 10)),
            ("hll_init", "hll_add", "hll_merge", (10,))):
        a, b = getattr(SK, init)(*args), getattr(RSK, init)(*args)
        a2, b2 = getattr(SK, init)(*args), getattr(RSK, init)(*args)
        getattr(SK, add)(a, keys)
        getattr(RSK, add)(b, keys)
        getattr(SK, add)(a2, more)
        getattr(RSK, add)(b2, more)
        assert np.array_equal(a, b), add
        assert np.array_equal(getattr(SK, merge)(a, a2),
                              getattr(RSK, merge)(b, b2)), merge
    cms_p, cms_r = SK.cms_init(4, 1 << 10), RSK.cms_init(4, 1 << 10)
    SK.cms_add(cms_p, keys)
    RSK.cms_add(cms_r, keys)
    bl_p, bl_r = SK.bloom_init(1 << 14), RSK.bloom_init(1 << 14)
    SK.bloom_add(bl_p, keys)
    RSK.bloom_add(bl_r, keys)
    for k in list(keys[:50]) + list(more[:50]):
        assert SK.cms_query(cms_p, int(k)) == RSK.cms_query(cms_r, int(k))
        assert (SK.bloom_contains(bl_p, int(k))
                == RSK.bloom_contains(bl_r, int(k)))
    h = SK.hll_init(10)
    SK.hll_add(h, keys)
    assert SK.hll_estimate(h) == RSK.hll_estimate(h)


def test_duration_histogram_within_one_bucket_of_reference():
    rng = np.random.default_rng(7)
    gamma = PARAMS.hist_gamma
    durs = np.concatenate([rng.integers(1, 10 ** 7, 20000),
                           rng.lognormal(8, 3, 20000).astype(np.int64)])
    a = np.zeros(PARAMS.hist_buckets, np.int64)
    b = np.zeros(PARAMS.hist_buckets, np.int64)
    SK.hist_add(a, durs, gamma)
    RSK.hist_add(b, durs, gamma)
    _assert_hist_within_one_bucket(b, a, "hist_add")
    assert np.abs(SK.hist_bucket_index(durs, 2048, gamma).astype(np.int64)
                  - RSK.hist_bucket_index(durs, 2048, gamma)).max() <= 1


def test_segment_bytes_cross_between_packages(three):
    ref, port, _ = three
    rsegs, psegs = ref.archive.snapshot(), port.archive.snapshot()
    assert psegs
    for r, p in zip(rsegs, psegs):
        blob = r.to_bytes()
        # JAX bytes load in the port and re-serialize identically ...
        assert Segment.from_bytes(blob).to_bytes() == blob
        # ... and the port's load in the JAX package.
        assert RefSegment.from_bytes(p.to_bytes()).to_bytes() == blob
        twin = Segment.from_bytes(p.to_bytes())
        b1, g1 = p.decode()
        b2, g2 = twin.decode()
        assert np.array_equal(g1, g2)
        for col in type(b1).SPAN_COLUMNS + type(b1).ANN_COLUMNS:
            assert np.array_equal(getattr(b1, col), getattr(b2, col)), col
    if len(psegs) >= 2:
        assert (merge_segments(99, psegs[:2]).to_bytes()
                == ref_merge(99, rsegs[:2]).to_bytes())


# ---------------------------------------------------------------------------
# The capture pull
# ---------------------------------------------------------------------------


def _pull_both(ref_state, pcfg, lo, hi, ks):
    want = [np.asarray(x) for x in dev.capture_eviction_rows(
        ref_state, lo, hi, *ks)]
    pstate = state_from_numpy(pcfg, jax_leaves(ref_state), "cpu")
    before = state_to_numpy(pstate)
    got = [x.numpy() for x in tdev.capture_eviction_rows(
        pstate, lo, hi, *ks)]
    after = state_to_numpy(pstate)
    for k, v in before.items():
        if k != "counters":
            assert np.array_equal(v, after[k]), f"the pull wrote {k}"
    # Fresh tensors, never views of the state.
    outs = tdev.capture_eviction_rows(pstate, lo, hi, *ks)
    leaves = [t for t in pstate.leaves.values()
              if isinstance(t, torch.Tensor)]
    for o in outs:
        assert not any(o.untyped_storage().data_ptr()
                       == t.untyped_storage().data_ptr() for t in leaves)
    return want, got


def _assert_prefix_equal(want, got):
    counts = want[0]
    assert np.array_equal(counts, got[0])
    n_s = int(counts[0])
    assert n_s > 0
    assert np.array_equal(want[1][:, :n_s], got[1][:, :n_s])
    assert np.array_equal(want[2], got[2])  # tails masked to -1
    assert np.array_equal(want[3], got[3])


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_capture_pull_matches_reference(layout):
    cfg = (CFG if layout == "ring"
           else CFG._replace(capacity=1 << 9, layout="paged",
                             page_rows=64))
    ref = TpuSpanStore(cfg)
    spans = [s for tid in range(1, cfg.capacity) for s in make_trace(tid)]
    for i in range(0, len(spans), 64):
        ref.apply(spans[i:i + 64])
    st = ref.state
    pcfg = tdev.StoreConfig(**cfg._asdict())
    gids = np.asarray(st.row_gid)
    live = np.sort(gids[gids >= 0])
    if layout == "ring":
        wp = int(np.asarray(st.write_pos))
        windows = [(wp - cfg.capacity, wp - cfg.capacity // 2),
                   (wp - 100, wp)]
    else:
        R, cap = cfg.page_rows, cfg.capacity
        windows = []
        for g in (int(live[0]), int(live[len(live) // 2])):
            lo = (g // cap) * cap + ((g % cap) // R) * R
            windows.append((lo, lo + R))
    assert int(np.asarray(st.write_pos)) > cfg.capacity  # wrapped
    for lo, hi in windows:
        ks = (min(1 << (hi - lo - 1).bit_length(), cfg.capacity),
              cfg.ann_capacity, cfg.bann_capacity)
        want, got = _pull_both(st, pcfg, lo, hi, ks)
        _assert_prefix_equal(want, got)


# ---------------------------------------------------------------------------
# Capture invariants (tests/test_archive.py's, on the port)
# ---------------------------------------------------------------------------


def _port_oracle_drive(store, n_traces, chunk=64):
    oracle = PortMemoryStore()
    batch = []
    for tid in range(1, n_traces + 1):
        batch.extend(_convert(make_trace(tid), PORT))
        if len(batch) >= chunk or tid == n_traces:
            store.apply(batch)
            oracle.apply(batch)
            batch = []
    return oracle


def test_capture_covers_contiguously_with_complete_spans(three):
    _, port, _ = three
    segs = port.archive.snapshot()
    assert segs and segs[0].gid_lo == 0
    for a, b in zip(segs, segs[1:]):
        assert a.gid_hi == b.gid_lo
    hot = port.hot
    assert segs[-1].gid_hi == hot._cap_upto == hot.sealed_frontier()
    assert sum(s.n_spans for s in segs) == hot._cap_upto
    # The annotation ring laps ~2.5x faster than the span ring here:
    # every cold span must still decode with its full annotation set.
    _, _, spans = port.archive.decoded(segs[0])
    want = {(s.trace_id, s.id): s for tid in range(1, N_TRACES + 1)
            for s in _convert(make_trace(tid), PORT)}
    for s in spans[:200]:
        assert s == want[(s.trace_id, s.id)]


def test_annotation_heavy_chained_writes_capture_complete():
    from zipkin_tpu_torch.models.span import Annotation, Endpoint, Span

    cfg = tdev.StoreConfig(
        capacity=1 << 9, ann_capacity=1 << 11, bann_capacity=1 << 9,
        max_services=8, max_span_names=16, max_annotation_values=64,
        max_binary_keys=8, cms_width=1 << 8, hll_p=6, quantile_buckets=128)
    tiered = port_tiered(cfg, ArchiveParams.for_config(
        cfg, compact_fanin=2, small_span_limit=cfg.capacity,
        bloom_bits=1 << 12, cms_width=1 << 9, hll_p=6))
    oracle = PortMemoryStore()
    api = Endpoint(0x02020202, 80, "api")
    n = 2 * cfg.capacity
    spans = [Span(tid, "fat", tid, None, tuple(
        [Annotation(1000 + 100 * tid, "sr", api)]
        + [Annotation(1000 + 100 * tid + i, "custom", api)
           for i in range(31)]), ()) for tid in range(1, n + 1)]
    for i in range(0, n, 256):
        tiered.apply(spans[i:i + 256])
        oracle.apply(spans[i:i + 256])
    assert tiered.counters()["archive_segments_written"] >= 1
    for tid in (1, 2, n // 2, n):
        assert (tiered.get_spans_by_trace_ids([tid])
                == oracle.get_spans_by_trace_ids([tid])), tid


def test_transient_pull_failure_retries_the_window(monkeypatch):
    tiered = port_tiered()
    real = TorchSpanStore._pull_evicted_rows
    state = {"fail": 1}

    def flaky(self, *a, **kw):
        if state["fail"] > 0:
            state["fail"] -= 1
            raise TimeoutError("simulated wedged capture pull")
        return real(self, *a, **kw)

    monkeypatch.setattr(TorchSpanStore, "_pull_evicted_rows", flaky)
    oracle = PortMemoryStore()
    n = CFG.capacity
    failed = None
    for tid in range(1, n + 1):
        batch = _convert(make_trace(tid), PORT)
        try:
            tiered.apply(batch)
        except TimeoutError:
            failed = batch
            tiered.apply(batch)
        oracle.apply(batch)
    assert failed is not None, "the fault never fired"
    segs = tiered.archive.snapshot()
    assert segs and segs[0].gid_lo == 0
    for a, b in zip(segs, segs[1:]):
        assert a.gid_hi == b.gid_lo
    for tid in (1, 2, n):
        assert (tiered.get_spans_by_trace_ids([tid])
                == oracle.get_spans_by_trace_ids([tid])), tid


# ---------------------------------------------------------------------------
# The port tiered store against the JAX one and the oracle
# ---------------------------------------------------------------------------


def test_port_seals_the_reference_segments(three):
    ref, port, _ = three
    assert port.counters()["ring_laps"] >= 3
    assert_segments_match(ref.archive.snapshot(), port.archive.snapshot())
    assert port.counters()["archive_compactions"] >= 1
    assert (port.counters()["archive_compactions"]
            == ref.counters()["archive_compactions"])


def _port(store):
    return _RefSpanAdapter(store)


def test_trace_reads_match_oracle_and_reference(three):
    ref, port, oracle = three
    p = _port(port)
    n = N_TRACES
    sample = [1, 2, 3, n // 4, n // 2, n - 1, n]
    for tid in sample:
        want = oracle.get_spans_by_trace_ids([tid])
        assert p.get_spans_by_trace_ids([tid]) == want, tid
        assert ref.get_spans_by_trace_ids([tid]) == want, tid
    assert (p.get_spans_by_trace_ids(sample + [10 ** 12])
            == oracle.get_spans_by_trace_ids(sample + [10 ** 12]))
    qt = [1, 2, n // 2, n, 10 ** 12]
    assert p.traces_exist(qt) == oracle.traces_exist(qt)
    assert p.get_traces_duration(qt) == oracle.get_traces_duration(qt)
    assert p.get_traces_duration(qt) == ref.get_traces_duration(qt)


@pytest.mark.parametrize("limit", [1, 3, 10, 10 * N_TRACES])
def test_id_lookups_match_oracle_and_reference(three, limit):
    ref, port, oracle = three
    p = _port(port)
    for q in (("web", "index"), ("web", None), ("api", "lookup"),
              ("db", None)):
        want = oracle.get_trace_ids_by_name(q[0], q[1], END, limit)
        assert p.get_trace_ids_by_name(q[0], q[1], END, limit) == want, q
        assert ref.get_trace_ids_by_name(q[0], q[1], END, limit) == want
    for q in (("api", "boom", None), ("api", "k", b"v1"),
              ("api", "k", None)):
        want = oracle.get_trace_ids_by_annotation(*q, END, limit)
        assert p.get_trace_ids_by_annotation(*q, END, limit) == want, q
        assert ref.get_trace_ids_by_annotation(*q, END, limit) == want
    queries = [("name", "web", "index", END, limit),
               ("annotation", "api", "boom", None, END, limit)]
    assert p.get_trace_ids_multi(queries) == [
        oracle.get_trace_ids_by_name("web", "index", END, limit),
        oracle.get_trace_ids_by_annotation("api", "boom", None, END,
                                           limit)]


def test_aggregates_match_oracle(three):
    _, port, oracle = three
    want = {(lk.parent, lk.child): lk.duration_moments.count
            for lk in aggregate_spans(oracle.spans).links}
    got = {(lk.parent, lk.child): lk.duration_moments.count
           for lk in port.get_dependencies().links}
    assert got == want
    gamma = PPARAMS.hist_gamma
    for svc in ("api", "db"):
        counts = np.zeros(CFG.quantile_buckets, np.int64)
        SK.hist_add(counts, np.asarray(
            [s.duration for s in oracle.spans
             if s.service_name == svc and s.duration is not None],
            np.int64), gamma)
        qs = [0.5, 0.95, 0.99]
        assert (port.service_duration_quantiles(svc, qs)
                == quantiles_host(counts, gamma, 1.0, qs)), svc
    assert (port.get_all_service_names()
            == oracle.get_all_service_names())
    for svc in ("web", "api", "db"):
        assert port.get_span_names(svc) == oracle.get_span_names(svc)


def test_cold_sketches_pruning_and_counters(three):
    ref, port, oracle = three
    cold_q = port.cold_duration_quantiles("api", [0.5, 0.99])
    assert cold_q == ref.cold_duration_quantiles("api", [0.5, 0.99])
    assert cold_q is not None and all(v == v for v in cold_q)
    assert (port.cold_estimated_unique_traces()
            == ref.cold_estimated_unique_traces() > 0)
    before = port.archive.c_pruned.value
    assert (_port(port).get_trace_ids_by_name("web", None, 1_400, 50)
            == oracle.get_trace_ids_by_name("web", None, 1_400, 50))
    assert port.archive.c_pruned.value > before
    c = port.counters()
    assert c["archive_captures"] >= 1 and c["archive_cold_spans"] > 0
    assert c["archive_cold_bytes"] < c["archive_cold_raw_bytes"]


def test_pin_and_capture_now_through_tiers():
    tiered = port_tiered()
    oracle = _port_oracle_drive(tiered, CFG.capacity // 4)  # no wrap
    assert len(tiered.archive) == 0
    tiered.capture_now()
    segs = tiered.archive.snapshot()
    assert segs and segs[-1].gid_hi == tiered.hot._wp
    assert (tiered.get_spans_by_trace_ids([1])
            == oracle.get_spans_by_trace_ids([1]))
    more = _port_oracle_drive(tiered, 2 * CFG.capacity)
    # Trace 1 is evicted from the ring now: pinning banks its cold rows.
    tiered.set_time_to_live(1, 3600.0)
    assert tiered.hot.pins.get(1)
    assert (tiered.get_spans_by_trace_ids([1])
            == more.get_spans_by_trace_ids([1]))


@pytest.mark.parametrize("name", conformance_test_names())
def test_port_tiered_conformance(name):
    run_conformance_test(name, lambda: _RefSpanAdapter(port_tiered()))


# ---------------------------------------------------------------------------
# Async sealing and the paged layout
# ---------------------------------------------------------------------------


def test_pipelined_async_sealing_equals_serial_inline():
    """The sealer moves the copy and the seal, never what is captured:
    pipelined ingest with capture_backlog 2 lands the serial inline
    drive's state and segments bitwise."""
    spans = [s for tid in range(1, N_TRACES + 1)
             for s in _convert(make_trace(tid), PORT)]

    def drive(backlog, pipeline):
        tiered = port_tiered(backlog=backlog)
        hot = tiered.hot
        if pipeline:
            hot.start_pipeline(3)
        for i in range(0, len(spans), 64):
            tiered.apply(spans[i:i + 64])
        hot.drain_pipeline()
        hot.seal_barrier()
        hot.stop_pipeline()
        return tiered

    serial, piped = drive(0, False), drive(2, True)
    assert piped.hot.eviction_sealer() is not None
    assert serial.hot.eviction_sealer() is None
    sa, sb = state_to_numpy(serial.hot.state), state_to_numpy(
        piped.hot.state)
    for k, v in sa.items():
        if k != "counters":
            assert np.array_equal(v, sb[k]), k
    assert piped.hot.sealed_frontier() == piped.hot._cap_upto > 0
    a, b = serial.archive.snapshot(), piped.archive.snapshot()
    assert [(s.gid_lo, s.gid_hi) for s in a] == [
        (s.gid_lo, s.gid_hi) for s in b]
    assert [s.to_bytes() for s in a] == [s.to_bytes() for s in b]
    sample = [1, N_TRACES // 2, N_TRACES]
    assert (piped.get_spans_by_trace_ids(sample)
            == serial.get_spans_by_trace_ids(sample))
    piped.close()
    serial.close()
    assert piped.hot.eviction_sealer() is None


def test_seal_failure_is_counted_and_raised_on_next_write():
    tiered = port_tiered(backlog=2)
    sink = tiered.hot.eviction_sink
    fired = []

    def failing(*a):
        if not fired:
            fired.append(1)
            raise RuntimeError("seal failed")
        return sink(*a)

    tiered.hot.eviction_sink = failing
    with pytest.raises(RuntimeError, match="seal failed"):
        _port_oracle_drive(tiered, 2 * CFG.capacity)
        tiered.hot.seal_barrier()
    sealer = tiered.hot.eviction_sealer()
    assert sealer.c_errors.value == 1
    # The hole keeps the sealed frontier below it.
    assert tiered.hot.sealed_frontier() == 0
    tiered.close()


def test_paged_tiered_matches_ring_and_reference():
    """Past the page pool, reclaimed pages are captured before their
    rows are overwritten: a paged tiered store reads every trace back
    complete, as the ring one does, and seals the JAX paged tiered
    store's segments bitwise. The side rings are sized so they do not
    lap before a page is reclaimed: paged capture runs at reclaim time
    only, so a faster-lapping annotation ring loses side rows first in
    both packages."""
    cfg = CFG._replace(capacity=1 << 9, ann_capacity=1 << 12,
                       bann_capacity=1 << 11, layout="paged",
                       page_rows=64)
    params = PARAMS._replace(small_span_limit=cfg.capacity)
    ref = RefTiered(TpuSpanStore(cfg), params=params)
    paged = port_tiered(tdev.StoreConfig(**cfg._asdict()),
                        ArchiveParams(**params._asdict()))
    ring = port_tiered()
    oracle = InMemorySpanStore()
    n = 3 * cfg.capacity // 2
    for lo in range(1, n + 1, 32):
        batch = [s for tid in range(lo, min(lo + 32, n + 1))
                 for s in make_trace(tid)]
        ref.apply(batch)
        paged.apply(_convert(batch, PORT))
        ring.apply(_convert(batch, PORT))
        oracle.apply(batch)
    assert paged.hot._planner.stats()["page_reclaims"] > 0
    assert paged.counters()["archive_segments_written"] > 0
    assert_segments_match(ref.archive.snapshot(), paged.archive.snapshot())
    for tid in (1, 2, n // 3, n // 2, n):
        want = oracle.get_spans_by_trace_ids([tid])
        assert _port(paged).get_spans_by_trace_ids([tid]) == want, tid
        assert _port(ring).get_spans_by_trace_ids([tid]) == want, tid
    assert (_convert(paged.get_trace_ids_by_name("web", None, END, 40),
                     REF)
            == oracle.get_trace_ids_by_name("web", None, END, 40))
