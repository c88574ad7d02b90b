"""The port's paged span layout against the JAX reference, on the CPU.

Geometry: ``tests/test_paged.py``'s CFG_PAGED (capacity 2^10, 128-row
pages, 8 pages). Planner: the port's ``PagePlanner`` copy plans and
snapshots exactly like the reference's. Step level: the same planned,
padded batches through the JAX ``ingest_step``/``ingest_steps`` and the
port's, states equal after every step (``assert_states_equal``'s rule)
through several pool laps with reclaims. Reads: ``_paged_gather_impl``
(both JAX gather paths, the Pallas one in interpret mode) against the
port's ``gather_paged_trace_rows``, the page-gather twin against the
Pallas kernel, every read API against ``TpuSpanStore`` past wrap, the
SPI conformance suite on a paged port store, and rev-18 snapshots of
the driven stores loaded across packages (state and planner).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_store import (  # noqa: E402
    SMALL,
    _pow2,
    _RefSpanAdapter,
    assert_reads_match,
    assert_states_equal,
    jax_leaves,
    to_port,
)
from zipkin_tpu import checkpoint as ref_checkpoint  # noqa: E402
from zipkin_tpu.columnar.encode import SpanCodec  # noqa: E402
from zipkin_tpu.models.span import (  # noqa: E402
    Annotation,
    BinaryAnnotation,
    Endpoint,
    Span,
)
from zipkin_tpu.ops import pallas_kernels as PK  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.base import should_index  # noqa: E402
from zipkin_tpu.store.paged import PagePlanner  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore, name_lc_ids  # noqa: E402
from zipkin_tpu.testing.conformance import (  # noqa: E402
    conformance_test_names,
    run_conformance_test,
)
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu_torch import checkpoint  # noqa: E402
from zipkin_tpu_torch.ops import kernels as K  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store import paged as tpaged  # noqa: E402
from zipkin_tpu_torch.store.convert import (  # noqa: E402
    state_from_numpy,
    state_to_numpy,
)
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402

PAGED = dict(layout="paged", page_rows=128)
CFG_PAGED = dev.StoreConfig(**SMALL, **PAGED)
BASE_TS = 1_700_000_000_000_000


def _spans_for(tid: int, n: int, svc: str = "psvc") -> list:
    """n spans of one trace (tests/test_paged.py's shape)."""
    ep = Endpoint(10, 80, svc)
    out = []
    for j in range(n):
        t0 = BASE_TS + tid * 1000 + j
        out.append(Span(
            tid, f"op{j % 4}", tid * 100_000 + j + 1, None,
            (Annotation(t0, "sr", ep), Annotation(t0 + 7, "ss", ep)),
            (BinaryAnnotation("k", b"v", host=ep),),
        ))
    return out


def _mixed_traces(seed: int, n_small: int, n_big: int, max_big: int = 200):
    """generate_traces traces (parents, several services, annotation
    values) interleaved with zipf-sized single-service traces of up to
    ``max_big`` spans (exclusive pages from R/2 = 64 spans on)."""
    rng = np.random.default_rng(seed)
    traces = generate_traces(n_traces=n_small, max_depth=3, n_services=12,
                             rng=rng, base_ts=BASE_TS)
    for i in range(n_big):
        n = min(int(rng.zipf(1.3)) * 8, max_big)
        tid = 10_000_000 + seed * 100_000 + i
        traces.append(_spans_for(tid, n, svc=f"psvc{i % 3}"))
    return [traces[i] for i in rng.permutation(len(traces))]


def _tid_units(seed: int, total: int):
    """Per unit, its chunks' trace-id columns: zipf trace sizes, some
    traces writing again in later units, 1-3 chunks a unit, at most
    capacity//8 spans a unit (the paged span budget)."""
    rng = np.random.default_rng(seed)
    budget = CFG_PAGED.capacity // 8
    units, count, tid, recent = [], 0, 1, []
    while count < total:
        chunks = []
        for _ in range(int(rng.integers(1, 4))):
            tids = []
            while len(tids) < budget // 3:
                if recent and rng.random() < 0.2:
                    t = int(rng.choice(recent))
                else:
                    t, tid = tid, tid + 1
                    recent = (recent + [t])[-16:]
                tids += [t] * min(int(rng.zipf(1.5)), 90)
            chunks.append(np.asarray(tids[:budget // 3], np.int64))
            count += len(chunks[-1])
        units.append(chunks)
    return units


def _assert_plans_equal(a, b):
    assert a.reclaims == b.reclaims
    assert len(a.chunks) == len(b.chunks)
    for ca, cb in zip(a.chunks, b.chunks):
        for f in ("span_slot", "span_gid", "reclaim_pages"):
            x, y = getattr(ca, f), getattr(cb, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_planner_matches_reference():
    """Identical plans unit by unit and identical snapshots on a ~4x
    capacity skewed stream; restore and rebuild agree too."""
    ref, port = PagePlanner(CFG_PAGED), tpaged.PagePlanner(CFG_PAGED)
    cap, R = CFG_PAGED.capacity, CFG_PAGED.page_rows
    row_gid = np.full(cap, -1, np.int64)
    trace_col = np.zeros(cap, np.int64)
    for seq, unit in enumerate(_tid_units(5, 4 * cap), start=1):
        a = ref.plan_unit(unit, wal_seq=seq)
        b = port.plan_unit(unit, wal_seq=seq)
        _assert_plans_equal(a, b)
        for cp, tids in zip(b.chunks, unit):
            for p in cp.reclaim_pages:
                row_gid[p * R:(p + 1) * R] = -1
            row_gid[cp.span_slot] = cp.span_gid
            trace_col[cp.span_slot] = tids
    snap = ref.snapshot()
    assert port.snapshot() == snap
    assert ref.stats() == port.stats()
    assert port.stats()["page_reclaims"] >= 3 * port.n_pages
    restored = tpaged.PagePlanner(CFG_PAGED)
    restored.restore(snap)
    assert restored.snapshot() == snap
    qids = sorted(ref.traces)[:40]
    for x, y in zip(ref.chains_for(qids), port.chains_for(qids)):
        np.testing.assert_array_equal(x, y)
    ref.rebuild(row_gid, trace_col, wal_applied=7)
    port.rebuild(row_gid, trace_col, wal_applied=7)
    assert port.snapshot() == ref.snapshot()


def _encoded_chunks(traces, chunk: int):
    codec = SpanCodec()
    cache = {}
    spans = [s for t in traces for s in t]
    out = []
    for i in range(0, len(spans), chunk):
        part = spans[i:i + chunk]
        b = codec.encode(part)
        ix = np.array([should_index(s) for s in part])
        out.append((b, name_lc_ids(b, codec.dicts, cache), ix))
    return out


@pytest.mark.parametrize("use_kernels", [False, True])
def test_paged_ingest_steps_match_reference(use_kernels):
    """Planned, padded paged batches: the port's state equals the
    reference's after every step, through >= 3 pool laps of reclaims,
    chained units, sweeps and bucket closes."""
    cfg = CFG_PAGED
    tcfg = tdev.StoreConfig(**SMALL, **PAGED, use_pallas=use_kernels)
    parts = _encoded_chunks(_mixed_traces(9, 420, 40), 40)
    planner = PagePlanner(cfg)
    units, i = [], 0
    while i < len(parts):
        group = parts[i:i + 3] if len(units) % 3 == 2 else parts[i:i + 1]
        i += len(group)
        units.append((group, planner.plan_unit(
            [b.trace_id for b, _, _ in group])))
    # One padding for the whole drive keeps the reference's compiles to
    # one step and one chained step.
    pad = [_pow2(max(getattr(b, a) for b, _, _ in parts))
           for a in ("n_spans", "n_annotations", "n_binary")]
    rc = _pow2(max(len(cp.reclaim_pages) for _, p in units
                   for cp in p.chunks))
    jst = dev.init_state(cfg)
    tst = tdev.init_state(tcfg, device="cpu")
    for step, (group, plan) in enumerate(units, start=1):
        dbs = [dev.make_device_batch(
            b, lc, ix, *pad, span_slot=cp.span_slot, span_gid=cp.span_gid,
            reclaim_pages=cp.reclaim_pages, pad_reclaims=rc)
            for (b, lc, ix), cp in zip(group, plan.chunks)]
        if len(dbs) == 1:
            jst = dev.ingest_step(jst, dbs[0])
            tdev.ingest_step(tst, tdev.batch_to_device(to_port(dbs[0]),
                                                       "cpu"))
        else:
            stacked = dev.stack_device_batches(dbs)
            jst = dev.ingest_steps(jst, stacked)
            tdev.ingest_steps(tst, [
                tdev.batch_to_device(b, "cpu")
                for b in tdev.unstack_batches(to_port(stacked))])
        if step % 4 == 0:
            jst = dev.dep_sweep(jst)
            tdev.dep_sweep(tst)
        if step % 7 == 0:
            jst = dev.dep_close_bucket(jst)
            tdev.dep_close_bucket(tst)
        assert_states_equal(jax_leaves(jst), state_to_numpy(tst),
                            f"step {step}")
    assert planner.stats()["page_reclaims"] >= 3 * cfg.n_pages
    ref = jax_leaves(jst)
    assert int(ref["dep_bank_seq"]) >= 1
    assert int((ref["row_gid"] // cfg.capacity).max()) >= 3 * cfg.n_pages


# ---------------------------------------------------------------------------
# Reads
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def driven():
    """One JAX paged store and one port paged store after the same
    spans, past wrap, with one chain-overflowed trace written last
    (page_max_chain 3: 400 spans take 4 exclusive pages)."""
    cfg = CFG_PAGED._replace(page_max_chain=3)
    traces = _mixed_traces(17, 300, 20)
    overflow = _spans_for(99_000_001, 400, svc="psvc0")
    ref = TpuSpanStore(cfg)
    port = _RefSpanAdapter(TorchSpanStore(tdev.StoreConfig(
        **cfg._asdict()), device="cpu"))
    spans = [s for t in traces for s in t]
    # One paged span budget (capacity // 8) per apply: single-chunk units
    # keep the reference to a few compiled step shapes; the overflowed
    # trace below is a chained unit.
    step = cfg.capacity // 8
    for i in range(0, len(spans), step):
        ref.apply(spans[i:i + step])
        port.apply(spans[i:i + step])
    ref.apply(overflow)
    port.apply(overflow)
    return ref, port, traces, overflow


def _padded_pages(pages, epochs):
    """Hole pages at the front, in the middle and at the end, padded to
    a power of two."""
    mid = len(pages) // 2
    pg = np.concatenate([[-1], pages[:mid], [-1, -1], pages[mid:]])
    ep = np.concatenate([[0], epochs[:mid], [0, 0], epochs[mid:]])
    k = 1 << (len(pg) - 1).bit_length()
    return (np.concatenate([pg, np.full(k - len(pg), -1)]).astype(np.int32),
            np.concatenate([ep, np.zeros(k - len(ep))]).astype(np.int64))


def test_paged_gather_matches_reference_both_paths(driven):
    ref = driven[0]
    live = [t for t, e in ref._planner.traces.items() if not e.overflowed]
    qids = np.unique(np.asarray(live[::2] + [12345], np.int64))
    pages, epochs = _padded_pages(*ref._planner.chains_for(qids))
    assert (pages >= 0).sum() >= 2
    st = ref.state
    c = st.config
    k = (256, 512, 256)

    def jax_gather(pallas: bool):
        return jax.device_get(dev._paged_gather_impl(
            tuple(getattr(st, col) for col in dev.SPAN_MAT_COLS),
            tuple(getattr(st, col) for col in dev.ANN_MAT_COLS),
            tuple(getattr(st, col) for col in dev.BANN_MAT_COLS),
            jnp.asarray(qids), jnp.asarray(pages), jnp.asarray(epochs),
            st.ann_write_pos, st.bann_write_pos, c.capacity, c.page_rows,
            c.ann_capacity, c.bann_capacity, *k, pallas))

    want = jax_gather(False)
    assert int(want[0][0]) > 0
    names = ("counts", "span_mat", "ann_mat", "bann_mat")
    for name, a, b in zip(names, jax_gather(True), want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for use_kernels in (False, True):
        tst = state_from_numpy(tdev.StoreConfig(
            **c._replace(use_pallas=use_kernels)._asdict()),
            jax_leaves(st), device="cpu")
        got = tdev.gather_paged_trace_rows(tst, qids, pages, epochs, *k)
        for name, a, b in zip(names, want, got):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    assert K.LAUNCHES["paged_page_gather"] == 0  # the twin never counts


def _jax_page_gather_int64(cols64: np.ndarray, pages, R: int):
    """The Pallas kernel (interpret mode) on the plane matrix the
    reference builds from the columns, recombined to int64."""
    n = cols64.shape[0]
    planes = np.ascontiguousarray(
        cols64.view(np.int32).reshape(n, -1, 2).transpose(0, 2, 1)
    ).reshape(2 * n, -1)
    out = np.asarray(PK.paged_page_gather(jnp.asarray(planes),
                                          jnp.asarray(pages), R))
    return np.ascontiguousarray(
        out.reshape(n, 2, -1).transpose(0, 2, 1)).view(np.int64)[..., 0]


def _random_cols(rng, cap, kinds):
    """Span-like columns of ``cap`` rows, one a character of ``kinds``:
    ``l`` int64, ``i`` int32."""
    return [rng.integers(-2**62, 2**62, cap) if k == "l" else
            rng.integers(-2**31, 2**31, cap).astype(np.int32)
            for k in kinds]


@pytest.mark.parametrize("source", ["store", "random", "holes",
                                    "int32_8_rows", "int64_only"])
def test_page_gather_twin_matches_pallas(driven, source):
    """The page gather (its twin on the CPU) against the Pallas kernel in
    interpret mode, on the driven store's columns and on random ones:
    mixed columns, hole pages at both ends and past the last page,
    8-row pages of int32 columns, int64 columns only. The Pallas kernel
    takes no page past the last (its index map would clamp it); the
    port's contract makes such a page a hole, so the reference gets -1
    there."""
    rng = np.random.default_rng(4)
    if source == "store":
        st = driven[0].state
        cols = [np.asarray(getattr(st, c)) for c in dev.SPAN_MAT_COLS]
        R = st.config.page_rows
        pages = np.asarray([3, -1, 0, 7, -1, 5, 2, -1], np.int32)
    elif source == "int32_8_rows":
        R = 8
        cols = _random_cols(rng, 64 * R, "i" * 14)
        pages = np.asarray([-1, 63, 0, 64, 9, -7, 9, 1, 100, -1], np.int32)
    else:
        R, cap = 256, 1 << 12
        cols = _random_cols(rng, cap, "l" * 14 if source == "int64_only"
                            else "illilllilllill")
        pages = (np.asarray([-1, -1, 16, 15, 0, -3, 9, 9, 1, 2**31 - 1, -1],
                            np.int32) if source == "holes"
                 else np.asarray([-1, 15, 0, -1, 9, 9, 1, -1], np.int32))
    n_pages = cols[0].shape[0] // R
    want = _jax_page_gather_int64(
        np.stack([c.astype(np.int64) for c in cols]),
        np.where(pages < n_pages, pages, -1).astype(np.int32), R)
    tcols = [torch.from_numpy(np.array(c)) for c in cols]
    got = K.paged_page_gather(tcols, torch.from_numpy(pages), R)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        want, K.paged_page_gather_plain(tcols, torch.from_numpy(pages),
                                        R).numpy())


def test_gather_table_cache_follows_column_identity():
    """K3's host table (built the same way for CPU tensors): a repeat
    call with the same column tensors hits, in any sequence object; a
    column replaced by another tensor, or another page size, misses;
    an entry leaves the cache when one of its columns is freed."""
    cpu = torch.device("cpu")
    cols = [torch.arange(64, dtype=torch.int64) for _ in range(3)]
    cols.append(torch.arange(64, dtype=torch.int32))
    K._GATHER_TABLES.clear()
    first = K._gather_table(cols, 8, cpu)
    assert K._gather_table(tuple(cols), 8, cpu) is first
    assert K._gather_table(cols, 16, cpu) is not first
    other = cols[:2] + [cols[2].clone()] + cols[3:]
    table = K._gather_table(other, 8, cpu)
    assert table is not first and table[0][2] == other[2].data_ptr()
    assert list(table[1]) == [8, 8, 8, 4] and table[2] == 64
    assert len(K._GATHER_TABLES) == 3
    del other[2], table
    assert len(K._GATHER_TABLES) == 2
    assert K._gather_table(cols, 8, cpu) is first
    with pytest.raises(ValueError, match="power of two"):
        K._gather_table(cols, 12, cpu)
    with pytest.raises(TypeError):
        K._gather_table(cols[:3] + [cols[3].float()], 8, cpu)
    K._GATHER_TABLES.clear()


def test_paged_store_reads_match_reference(driven):
    ref, port, traces, overflow = driven
    pc, rc = port.counters(), ref.counters()
    for k in ("pages_active", "pages_free", "page_reclaims_total"):
        assert pc[k] == rc[k], k
    assert pc["page_reclaims_total"] > 0
    assert port.counter_block()["ring_laps"] >= 2
    # The overflowed trace: its chain is gone, its read takes the ring
    # scan and still comes back whole.
    tid = overflow[0].trace_id
    assert ref._planner.chains_for([tid]) is None
    got = port.get_spans_by_trace_ids([tid])
    assert got == ref.get_spans_by_trace_ids([tid])
    assert sorted(s.id for s in got[0]) == sorted(s.id for s in overflow)
    assert_reads_match(ref, port, traces)
    ids = [t[0].trace_id for t in traces[-80:]]
    assert port.get_spans_by_trace_ids(ids, force_scan=True) == \
        ref.get_spans_by_trace_ids(ids, force_scan=True)
    assert port.get_traces_duration(ids, force_scan=True) == \
        ref.get_traces_duration(ids, force_scan=True)
    assert port._s.index_hits == 0  # index reads stay off when paged


@pytest.mark.parametrize("name", conformance_test_names())
def test_paged_port_conformance(name):
    run_conformance_test(name, lambda: _RefSpanAdapter(TorchSpanStore(
        tdev.StoreConfig(**SMALL, **PAGED), device="cpu")))


def test_paged_snapshots_cross_packages(driven, tmp_path):
    """A JAX paged snapshot loads into the port and a port one into JAX:
    every leaf bitwise, the planner snapshot (allocator, page table,
    plan memo) equal, the reads equal, and post-restore writes plan the
    same claims on both sides."""
    ref, port, traces, _ = driven
    raw = port._s
    ref_checkpoint.save(ref, str(tmp_path / "j"))
    checkpoint.save(raw, str(tmp_path / "p"))
    from_ref = checkpoint.load(str(tmp_path / "j"), device="cpu")
    back = ref_checkpoint.load(str(tmp_path / "p"))
    for a, b in ((jax_leaves(ref.state), state_to_numpy(from_ref.state)),
                 (state_to_numpy(raw.state), jax_leaves(back.state))):
        for k, x in a.items():
            if k == "counters":
                assert {c: int(v) for c, v in x.items()} == {
                    c: int(v) for c, v in b[k].items()}
            else:
                assert np.array_equal(np.asarray(x), np.asarray(b[k])), k
    assert from_ref._planner.snapshot() == ref._planner.snapshot()
    assert back._planner.snapshot() == raw._planner.snapshot()
    tids = [t[0].trace_id for t in traces[-40:]]
    got = _RefSpanAdapter(from_ref)
    assert got.get_spans_by_trace_ids(tids) == ref.get_spans_by_trace_ids(
        tids)
    tail = [s for t in _mixed_traces(29, 30, 2) for s in t]
    got.apply(tail)
    back.apply(tail)
    assert_states_equal(jax_leaves(back.state),
                        state_to_numpy(from_ref.state), "after writes")
    assert from_ref._planner.snapshot() == back._planner.snapshot()
