"""The port's checkpoint (``zipkin_tpu_torch/checkpoint.py``) against
the JAX package's, on the CPU.

Across packages: a JAX ``checkpoint.save`` loads through the port's
``checkpoint.load`` with every leaf bitwise equal and every read
equal, and a port save loads through the JAX ``checkpoint.load`` the
same way, on the ring store and on the window store; pinned traces
survive a restart in both directions. Legacy revisions (the rev-3
live-link fixture, a rev-3 snapshot of a wrapped ring, rev-8 with an
int64 ``key_tab``, rev-10 with ``cand_*``/``tr_*`` arrays and packed
``span_tab`` words, rev-12 without CRCs or clocks) load into both
packages with equal states and reads, and keep equal after more
writes. Integrity: a corrupt slab raises ``CorruptSlabError``; a
chunked save resumes after a wedged transfer and stamps the store
suspect; a write between two attempts discards the staging directory.
Paged (the cross-package snapshots are in ``test_torch_paged.py``,
on its driven stores): a paged config pointed at a snapshot without
``meta["paged"]`` rebuilds, and a pipelined save with units planned
ahead of the gathered frontier replays their recorded plans.
Tiered (``store/archive``): a port round trip restores the segments,
the hot state and the capture clocks and keeps capturing; tiered
snapshots cross between the packages both ways; a segment referencing
dictionary ids the snapshot lacks is refused.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_store import (  # noqa: E402
    PIN_TTL_S,
    PORT,
    REF,
    SMALL,
    WINDOW_KW,
    _convert,
    _RefSpanAdapter,
    assert_reads_match,
    jax_leaves,
    pinned_stores,
)
from test_archive import CFG, PARAMS, make_trace  # noqa: E402
from zipkin_tpu import checkpoint as ref_checkpoint  # noqa: E402
from zipkin_tpu.models.span import (  # noqa: E402
    Annotation,
    BinaryAnnotation,
    Endpoint,
    Span,
)
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu_torch import checkpoint  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.checkpoint import CorruptSlabError  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.archive import (  # noqa: E402
    ArchiveParams,
    TieredSpanStore,
)
from zipkin_tpu_torch.store.base import StoreSuspectError  # noqa: E402
from zipkin_tpu_torch.store.convert import state_to_numpy  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402
from zipkin_tpu_torch.testing.crash import state_mismatches  # noqa: E402
from zipkin_tpu_torch.wal import WriteAheadLog, recover  # noqa: E402

WIN_US = 60_000_000


def assert_bitwise(ref: dict, got: dict, where=""):
    """Every leaf and counter of two numpy state dicts equal, bit for
    bit, dtype and shape included (moments too: a snapshot copies
    bytes)."""
    assert set(ref) == set(got), where
    for k, a in ref.items():
        b = got[k]
        if k == "counters":
            assert {c: int(v) for c, v in a.items()} == {
                c: int(v) for c, v in b.items()}, where
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (k, where)
        assert np.array_equal(a, b), (k, int((a != b).sum()), where)


def _traces(kind: str, n: int = 240, seed: int = 5):
    """Traces that wrap the 2^9 ring; on the window store, batches of
    40 traces one bucket apart (the 8-slot ring laps)."""
    rng = np.random.default_rng(seed)
    if kind == "ring":
        return generate_traces(n_traces=n, max_depth=3, n_services=12,
                               rng=rng)
    out = []
    for i in range(n // 40):
        out += generate_traces(n_traces=40, max_depth=3, n_services=12,
                               rng=rng,
                               base_ts=1_700_000_000_000_000 + i * WIN_US)
    return out


# A 2^9 ring, so a few hundred traces wrap it.
RING = dict(SMALL, capacity=1 << 9, ann_capacity=1 << 11,
            bann_capacity=1 << 10)


def _cfg(kind: str) -> dict:
    return dict(RING, **(WINDOW_KW if kind == "window" else {}))


def _drive(ref, port, traces, chunk: int = 150):
    spans = [s for t in traces for s in t]
    for i in range(0, len(spans), chunk):
        if ref is not None:
            ref.apply(spans[i:i + chunk])
        if port is not None:
            port.apply(_convert(spans[i:i + chunk], PORT))


@pytest.fixture(scope="module", params=["ring", "window"])
def driven(request):
    kind = request.param
    traces = _traces(kind)
    ref = TpuSpanStore(dev.StoreConfig(**_cfg(kind)))
    port = TorchSpanStore(tdev.StoreConfig(**_cfg(kind)), device="cpu")
    _drive(ref, port, traces)
    assert port.counter_block()["ring_laps"] >= 1
    return kind, ref, port, traces


def test_reference_snapshot_loads_into_port(driven, tmp_path):
    kind, ref, _, traces = driven
    ref_checkpoint.save(ref, str(tmp_path / "ckpt"))
    got = checkpoint.load(str(tmp_path / "ckpt"), device="cpu")
    assert_bitwise(jax_leaves(ref.state), state_to_numpy(got.state), kind)
    assert got.config == tdev.StoreConfig(**_cfg(kind))
    # The restored mirror resyncs from the restored leaves.
    st = state_to_numpy(got.state)
    m = got.ensure_sketch_mirror()
    for name, arr in zip(("svc_hist", "ann_svc_counts"), m.arrays()):
        assert np.array_equal(arr, st[name]), name
    assert_reads_match(ref, _RefSpanAdapter(got), traces)


def test_port_snapshot_loads_into_reference(driven, tmp_path):
    kind, _, port, traces = driven
    want = state_to_numpy(port.state)
    checkpoint.save(port, str(tmp_path / "ckpt"))
    got = ref_checkpoint.load(str(tmp_path / "ckpt"))
    assert_bitwise(want, jax_leaves(got.state), kind)
    assert got._wal_applied == port._wal_applied
    assert (got._archived, got._batches_since_sweep) == (
        port._archived, port._batches_since_sweep)
    assert_reads_match(got, _RefSpanAdapter(port), traces)


@pytest.fixture(scope="module")
def pinned():
    return pinned_stores()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_pinned_traces_survive_restart(tmp_path, pinned, direction):
    """Pin, save, load in the other package, flood: the pinned banks
    restore with their TTLs and keep serving (the reads compare span
    objects, so the classes must be the loader's own). Each direction
    saves and floods only its own side of the shared drive."""
    ref, port, _, pinned = pinned
    path = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        ref_checkpoint.save(ref, path)
        got = _RefSpanAdapter(checkpoint.load(path, device="cpu"))
        want = ref
    else:
        checkpoint.save(port, path)
        got = ref_checkpoint.load(path)
        want = _RefSpanAdapter(port)
    assert got.get_time_to_live(pinned[0]) == PIN_TTL_S
    assert (got.get_spans_by_trace_ids(pinned)
            == want.get_spans_by_trace_ids(pinned))
    rng = np.random.default_rng(9)
    flood = generate_traces(n_traces=200, max_depth=3, n_services=8,
                            rng=rng, base_ts=3_000_000_000_000)
    spans = [s for t in flood for s in t]
    for i in range(0, len(spans), 200):
        got.apply(spans[i:i + 200])
        want.apply(spans[i:i + 200])
    assert (got.get_spans_by_trace_ids(pinned)
            == want.get_spans_by_trace_ids(pinned))
    assert len(got.get_spans_by_trace_ids(pinned)) == len(pinned)
    assert got.traces_exist(pinned) == set(pinned)


def test_pins_refuse_foreign_globals(tmp_path):
    import pickle

    path = tmp_path / "ckpt"
    checkpoint.save(TorchSpanStore(tdev.StoreConfig(**SMALL),
                                   device="cpu"), str(path))
    with open(path / "pins.pkl", "wb") as f:
        pickle.dump({1: [os.getcwd]}, f)
    with pytest.raises(pickle.UnpicklingError, match="span model"):
        checkpoint.load(str(path), device="cpu")


# ---------------------------------------------------------------------------
# Legacy revisions
# ---------------------------------------------------------------------------

CFG_LEGACY = dict(capacity=1 << 9, ann_capacity=1 << 11,
                  bann_capacity=1 << 10, max_services=16,
                  max_span_names=64, max_annotation_values=64,
                  max_binary_keys=16, cms_width=1 << 9, hll_p=6,
                  quantile_buckets=128)
WEB = Endpoint(1, 80, "web")
API = Endpoint(2, 80, "api")


def rpc(tid, sid, parent, t0, t1):
    return Span(tid, "op", sid, parent, (
        Annotation(t0, "cs", WEB),
        Annotation(t0 + 1, "sr", API),
        Annotation(t1 - 1, "ss", API),
        Annotation(t1, "cr", WEB),
    ), (BinaryAnnotation("k", b"v", host=API),))


def _rewrite(path, revision, data_fn=None, keep_crc_clocks=False):
    state_file = os.path.join(path, "state.npz")
    data = dict(np.load(state_file))
    if data_fn is not None:
        data_fn(data)
    np.savez_compressed(state_file, **data)
    meta_file = os.path.join(path, "meta.json")
    with open(meta_file) as f:
        meta = json.load(f)
    meta["revision"] = revision
    if not keep_crc_clocks:
        meta.pop("slab_crc32", None)
        meta.pop("clocks", None)
    with open(meta_file, "w") as f:
        json.dump(meta, f)


def _rev3(data):
    for gone in ("span_tab", "pend_key", "pend_dur", "pend_tsf",
                 "pend_tsl", "pend_pos", "dep_window", "dep_window_ts"):
        del data[gone]
    data["dep_moments"] = np.zeros_like(data["dep_moments"])
    data["dep_banks"] = np.zeros_like(data["dep_banks"])
    data["dep_archived_gid"] = np.int64(0)


def _rev8(data):
    data["key_tab"] = data["key_tab"].astype(np.int64) * 3 + 1


def _rev10(data):
    n = data["cand_pos"].shape[0]
    data["tr_idx"] = np.zeros((n // 2, 2), np.int64)
    data["tr_pos"] = np.zeros(n // 4, np.int32)
    data["tr_wm"] = np.zeros(n // 4, np.int64)
    tab = np.ascontiguousarray(data["span_tab"])
    data["span_tab"] = tab.view(np.int64).reshape(tab.shape[:-1])


LEGACY = {
    "rev3_live_links": (3, _rev3),
    "rev3_wrapped_ring": (3, _rev3),
    "rev8_int64_key_tab": (8, _rev8),
    "rev10_cand_tr": (10, _rev10),
    "rev12_no_crc_no_clocks": (12, None),
}


@pytest.mark.parametrize("case", sorted(LEGACY))
def test_legacy_snapshot_loads_into_both_packages(tmp_path, case):
    revision, fix = LEGACY[case]
    cfg = dict(RING)
    if case == "rev3_live_links":
        traces = [[rpc(1, 1, None, 100, 200), rpc(1, 2, 1, 110, 150)],
                  [rpc(2, 7, None, 300, 400), rpc(2, 8, 7, 310, 330)],
                  [rpc(3, 21, 20, 500, 550)]]
        later = [rpc(3, 20, None, 490, 560)]
    else:
        traces = _traces("ring", n=240, seed=17)
        later = [s for t in _traces("ring", n=30, seed=18) for s in t]
    store = TpuSpanStore(dev.StoreConfig(**cfg))
    _drive(store, None, traces)
    if case == "rev3_wrapped_ring":
        assert store.counter_block()["ring_laps"] >= 1
    path = str(tmp_path / "ckpt")
    ref_checkpoint.save(store, path)
    _rewrite(path, revision, fix)

    ref = ref_checkpoint.load(path)
    port = checkpoint.load(path, device="cpu")
    assert_bitwise(jax_leaves(ref.state), state_to_numpy(port.state), case)
    adapter = _RefSpanAdapter(port)
    if case == "rev3_live_links":
        links = [(l.parent, l.child, l.duration_moments.count)
                 for l in ref.get_dependencies().links]
        assert links and [
            (l.parent, l.child, l.duration_moments.count)
            for l in adapter.get_dependencies().links] == links
    else:
        assert_reads_match(ref, adapter, traces)
    # Post-restore writes: children find restored parents through the
    # rebuilt span table, the poisoned trust stays in step.
    ref.apply(later)
    adapter.apply(later)
    assert_bitwise(jax_leaves(ref.state), state_to_numpy(port.state),
                   f"{case} after writes")
    assert ([(l.parent, l.child) for l in ref.get_dependencies().links]
            == [(l.parent, l.child)
                for l in adapter.get_dependencies().links])


def test_rebuild_span_tab_matches_reference_on_wrapped_ring():
    """The in-place min-insert gives the reference's table for every
    live row of a ring that has wrapped (rows of many batches, both
    halves of each RPC, colliding probes)."""
    cfg = dict(RING)
    traces = _traces("ring", n=320, seed=23)
    ref = TpuSpanStore(dev.StoreConfig(**cfg))
    _drive(ref, None, traces)
    assert ref.counter_block()["ring_laps"] >= 1
    leaves = jax_leaves(ref.state)
    empty = np.ascontiguousarray(np.full(leaves["span_tab"].shape[0],
                                         dev._TAB_EMPTY, np.int64))
    leaves["span_tab"] = empty.view(np.int32).reshape(-1, 2)
    from zipkin_tpu_torch.store.convert import state_from_numpy

    port_state = state_from_numpy(tdev.StoreConfig(**cfg), leaves,
                                  device="cpu")
    tdev.rebuild_span_tab(port_state)
    ref_state = dev.init_state(dev.StoreConfig(**cfg)).replace(
        **{k: v for k, v in leaves.items() if k != "counters"})
    want = np.asarray(dev.rebuild_span_tab(ref_state).span_tab)
    got = port_state.span_tab.numpy()
    assert np.array_equal(want, got), int((want != got).sum())
    assert (got.view(np.int64) != dev._TAB_EMPTY).sum() > 0


# ---------------------------------------------------------------------------
# Integrity and resumable saves
# ---------------------------------------------------------------------------


def _small_store():
    store = TorchSpanStore(tdev.StoreConfig(**CFG_LEGACY), device="cpu")
    store.apply(_convert([rpc(1, 1, None, 100, 200),
                          rpc(1, 2, 1, 110, 150)], PORT))
    return store


def test_corrupt_slab_fails_fast(tmp_path):
    store = _small_store()
    path = str(tmp_path / "ckpt")
    checkpoint.save(store, path)
    state_file = os.path.join(path, "state.npz")
    data = dict(np.load(state_file))
    arr = data["trace_id"].copy()
    arr[0] ^= 1
    data["trace_id"] = arr
    checkpoint._savez_fast(state_file, data)
    with pytest.raises(CorruptSlabError, match="trace_id"):
        checkpoint.load(path, device="cpu")


def _flaky(real_get, after: int):
    left = {"n": after}

    def get(x, deadline_s):
        if deadline_s is not None and left["n"] <= 0:
            raise TimeoutError("simulated wedge")
        left["n"] -= 1
        return real_get(x, None)

    return get


def test_port_chunked_save_resumes_after_a_wedge(tmp_path, monkeypatch):
    store = _small_store()
    path = str(tmp_path / "ckpt")
    real_get = checkpoint._bounded_get
    monkeypatch.setattr(checkpoint, "_bounded_get", _flaky(real_get, 5))
    with pytest.raises(TimeoutError):
        checkpoint.save(store, path, chunk_deadline_s=5.0)
    assert os.path.isdir(path + ".staging") and not os.path.isdir(path)
    # The suspect stamp: writes and the next save refuse until cleared
    # (a real timeout's orphan thread would be joined instead).
    assert store.suspect
    with pytest.raises(StoreSuspectError):
        store.apply(_convert([rpc(5, 1, None, 100, 200)], PORT))
    store.clear_suspect()
    monkeypatch.setattr(checkpoint, "_bounded_get", real_get)
    stats = checkpoint.save(store, path, chunk_deadline_s=5.0)
    assert stats["resumed_leaves"] > 0
    assert not os.path.isdir(path + ".staging")
    got = checkpoint.load(path, device="cpu")
    assert not state_mismatches(store.state, got.state)
    assert got.get_spans_by_trace_ids([1]) == store.get_spans_by_trace_ids([1])


def test_write_between_attempts_discards_staging(tmp_path, monkeypatch):
    store = _small_store()
    path = str(tmp_path / "ckpt")
    real_get = checkpoint._bounded_get
    monkeypatch.setattr(checkpoint, "_bounded_get", _flaky(real_get, 5))
    with pytest.raises(TimeoutError):
        checkpoint.save(store, path, chunk_deadline_s=5.0)
    store.clear_suspect()
    monkeypatch.setattr(checkpoint, "_bounded_get", real_get)
    store.apply(_convert([rpc(2, 3, None, 300, 400)], PORT))
    stats = checkpoint.save(store, path, chunk_deadline_s=5.0)
    assert stats["resumed_leaves"] == 0
    got = checkpoint.load(path, device="cpu")
    assert not state_mismatches(store.state, got.state)


def test_port_chunked_save_slabs_big_leaves(tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoint, "_SLAB_BYTES", 1 << 12)
    store = _small_store()
    stats = checkpoint.save(store, str(tmp_path / "ckpt"),
                            chunk_deadline_s=30.0)
    assert stats["slabs"] > 50 and stats["mb_per_s_avg"] > 0
    got = checkpoint.load(str(tmp_path / "ckpt"), device="cpu")
    assert not state_mismatches(store.state, got.state)


def test_sharded_and_tiered_snapshots_are_refused(tmp_path):
    """Sharded snapshots wait for the sharding slice; a tiered snapshot
    whose segments reference dictionary ids past the saved dictionaries
    is inconsistent and refused."""
    path = tmp_path / "ckpt"
    checkpoint.save(_small_store(), str(path))
    meta = json.loads((path / "meta.json").read_text())
    (path / "meta.json").write_text(json.dumps(dict(meta, shards=4)))
    with pytest.raises(NotImplementedError, match="item 7"):
        checkpoint.load(str(path), device="cpu")
    tiered, _ = _tiered_drive(CFG.capacity)
    checkpoint.save(tiered, str(path))
    meta = json.loads((path / "meta.json").read_text())
    assert meta["archive"]["segments"]
    meta["dicts"]["services"] = meta["dicts"]["services"][:1]
    (path / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="inconsistent"):
        checkpoint.load(str(path), device="cpu")


# ---------------------------------------------------------------------------
# Tiered stores (store/archive): the hot snapshot plus segment blobs
# ---------------------------------------------------------------------------


def _tiered_drive(n_traces, port=None, ref=None):
    """make_trace spans (tests/test_archive.py) into a port tiered
    store (and a JAX one when ``ref`` is given) and a port oracle."""
    from zipkin_tpu_torch.store.memory import InMemorySpanStore

    port = port or TieredSpanStore(
        TorchSpanStore(tdev.StoreConfig(**CFG._asdict()), device="cpu",
                       registry=obs.Registry()),
        params=ArchiveParams(**PARAMS._asdict()), registry=obs.Registry())
    oracle = InMemorySpanStore()
    for lo in range(1, n_traces + 1, 32):
        batch = [s for tid in range(lo, min(lo + 32, n_traces + 1))
                 for s in make_trace(tid)]
        if ref is not None:
            ref.apply(batch)
        port.apply(_convert(batch, PORT))
        oracle.apply(_convert(batch, PORT))
    return port, oracle


def _segs(tiered):
    return [(s.seg_id, s.gid_lo, s.gid_hi, s.to_bytes())
            for s in tiered.archive.snapshot()]


def test_port_tiered_snapshot_roundtrip(tmp_path):
    n = 3 * CFG.capacity // 2
    tiered, oracle = _tiered_drive(n)
    path = str(tmp_path / "ckpt")
    stats = checkpoint.save(tiered, path)
    assert os.listdir(os.path.join(path, "segments"))
    got = checkpoint.load(path, device="cpu")
    assert isinstance(got, TieredSpanStore)
    assert _segs(got) == _segs(tiered)
    assert not state_mismatches(tiered.hot.state, got.hot.state)
    assert (got.hot._cap_upto, got.hot.sealed_frontier()) == (
        tiered.hot._cap_upto, tiered.hot.sealed_frontier())
    for tid in (1, n // 2, n):
        assert (got.get_spans_by_trace_ids([tid])
                == oracle.get_spans_by_trace_ids([tid])), tid
    assert (got.get_trace_ids_by_name("web", None, 1 << 60, 10 * n)
            == oracle.get_trace_ids_by_name("web", None, 1 << 60, 10 * n))
    # A second save links the unchanged blobs instead of rewriting them.
    again = checkpoint.save(got, path)
    assert again["reused_segments"] == len(got.archive)
    assert stats.get("reused_segments", 0) == 0
    # Ingest after the restore keeps capturing.
    extra = _convert(make_trace(10 ** 6), PORT)
    _tiered_drive(CFG.capacity, port=got)
    got.apply(extra)
    assert got.get_spans_by_trace_ids([10 ** 6]) == [extra]
    assert got.archive.snapshot()[-1].gid_hi > tiered.hot._cap_upto


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_tiered_snapshots_cross_packages(tmp_path, direction):
    from zipkin_tpu.store.archive import TieredSpanStore as RefTiered

    n = 3 * CFG.capacity // 2
    ref = RefTiered(TpuSpanStore(CFG), params=PARAMS)
    port, oracle = _tiered_drive(n, ref=ref)
    path = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        ref_checkpoint.save(ref, path)
        got = checkpoint.load(path, device="cpu")
        assert isinstance(got, TieredSpanStore)
        assert_bitwise(jax_leaves(ref.hot.state),
                       state_to_numpy(got.hot.state))
        want_segs = [(s.seg_id, s.gid_lo, s.gid_hi, s.to_bytes())
                     for s in ref.archive.snapshot()]
        reads = got
    else:
        checkpoint.save(port, path)
        got = ref_checkpoint.load(path)
        assert isinstance(got, RefTiered)
        assert_bitwise(state_to_numpy(port.hot.state),
                       jax_leaves(got.hot.state))
        want_segs = _segs(port)
        reads = _RefSpanAdapter(port)
    assert [(s.seg_id, s.gid_lo, s.gid_hi, s.to_bytes())
            for s in got.archive.snapshot()] == want_segs
    assert got.hot._cap_upto == port.hot._cap_upto
    for tid in (1, n // 3, n):
        a = got.get_spans_by_trace_ids([tid])
        b = reads.get_spans_by_trace_ids([tid])
        assert a == b and a, tid
    if direction == "jax_to_port":
        assert got.get_spans_by_trace_ids([1]) == (
            oracle.get_spans_by_trace_ids([1]))


# ---------------------------------------------------------------------------
# Paged layout
# ---------------------------------------------------------------------------

PAGED = dict(RING, layout="paged", page_rows=64)


def _paged_spans(seed: int, n: int = 300):
    return [s for t in _traces("ring", n=n, seed=seed) for s in t]


def _store_paged(**kw):
    return TorchSpanStore(tdev.StoreConfig(**PAGED), device="cpu", **kw)


def test_paged_config_without_planner_meta_rebuilds(tmp_path):
    spans = _paged_spans(53)
    port = _store_paged()
    for i in range(0, len(spans), 150):
        port.apply(_convert(spans[i:i + 150], PORT))
    path = str(tmp_path / "ckpt")
    checkpoint.save(port, path)
    meta_file = os.path.join(path, "meta.json")
    with open(meta_file) as f:
        meta = json.load(f)
    assert "paged" in meta
    del meta["paged"]
    meta["revision"] = 17
    with open(meta_file, "w") as f:
        json.dump(meta, f)
    got = checkpoint.load(path, device="cpu")
    assert not state_mismatches(port.state, got.state)
    a, b = port._planner.stats(), got._planner.stats()
    assert (a["pages_active"], a["pages_free"]) == (
        b["pages_active"], b["pages_free"])
    tids = sorted({s.trace_id for s in spans})[::9][:16]
    assert got.get_spans_by_trace_ids(tids) == \
        port.get_spans_by_trace_ids(tids)


def test_pipelined_paged_replay_uses_recorded_plans(tmp_path):
    """A pipelined store saved while a writer plans units past the
    gathered frontier: the snapshot's planner memo holds their plans,
    and recovery replays them from the memo (not fresh planning) to
    the uncrashed store's state and planner."""
    spans = _convert(_paged_spans(83, n=360), PORT)
    half, ahead = 600, 150
    oracle = _store_paged()
    store = _store_paged(registry=obs.Registry())
    wal = WriteAheadLog(str(tmp_path / "wal"), fsync="off",
                        registry=obs.Registry())
    store.attach_wal(wal)
    with store.pipelined(4):
        for i in range(0, half, 150):
            store.apply(spans[i:i + 150])
        snapshot = store._planner.snapshot

        def racing_snapshot():
            # A writer lands between the gather and the planner cut.
            store.apply(spans[half:half + ahead])
            return snapshot()

        store._planner.snapshot = racing_snapshot
        checkpoint.save(store, str(tmp_path / "ckpt"))
        store._planner.snapshot = snapshot
        for i in range(half + ahead, len(spans), 150):
            store.apply(spans[i:i + 150])
    wal.sync()
    wal.close()
    for i in range(0, len(spans), 150):
        oracle.apply(spans[i:i + 150])
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["paged"]["last_seq"] > meta["clocks"]["wal_applied"]

    memo_hits = []
    real_plan = None

    def counting_plan(chunk_tids, wal_seq=None):
        if wal_seq is not None and wal_seq <= planner.last_seq:
            memo_hits.append(wal_seq)
        return real_plan(chunk_tids, wal_seq=wal_seq)

    rec = checkpoint.load(str(tmp_path / "ckpt"), device="cpu")
    planner = rec._planner
    real_plan = planner.plan_unit
    planner.plan_unit = counting_plan
    wal2 = WriteAheadLog(str(tmp_path / "wal"), fsync="off",
                         registry=obs.Registry())
    rec.attach_wal(wal2)
    from zipkin_tpu_torch.wal import replay_into

    stats = replay_into(rec, wal2)
    wal2.close()
    assert memo_hits and stats["replayed_records"] > len(memo_hits)
    assert not state_mismatches(oracle.state, rec.state)
    assert rec._planner.snapshot()["traces"] == \
        oracle._planner.snapshot()["traces"]
    assert rec._planner.stats() == oracle._planner.stats()


def test_recover_restores_clocks_exactly(tmp_path):
    """Revision-13 clocks: every host clock the port keeps comes back
    as saved, so the replayed tail re-cuts the uncrashed launches."""
    store = TorchSpanStore(tdev.StoreConfig(**SMALL), device="cpu")
    wal = WriteAheadLog(str(tmp_path / "wal"), fsync="off",
                        registry=obs.Registry())
    store.attach_wal(wal)
    _drive(None, store, _traces("ring", n=200, seed=3))
    checkpoint.save(store, str(tmp_path / "ckpt"))
    got = checkpoint.load(str(tmp_path / "ckpt"), device="cpu")
    for k in ("_wp", "_awp", "_bwp", "_archived", "_batches_since_sweep",
              "_cap_upto", "_cap_a", "_cap_b", "_sealed_upto",
              "_wal_applied"):
        assert getattr(got, k) == getattr(store, k), k
    assert store._awp > 0 and store._wal_applied == wal.last_seq
    wal2 = WriteAheadLog(str(tmp_path / "wal"), fsync="off",
                         registry=obs.Registry())
    rec, stats = recover(str(tmp_path / "ckpt"), wal2, device="cpu")
    assert stats["replayed_records"] == 0
    assert not state_mismatches(store.state, rec.state)
    wal.close()
    wal2.close()


def test_adopt_state_reseeds_clocks():
    src = TorchSpanStore(tdev.StoreConfig(**SMALL), device="cpu")
    _drive(None, src, _traces("ring", n=60, seed=4))
    dst = TorchSpanStore(tdev.StoreConfig(**SMALL), codec=src.codec,
                         device="cpu")
    wp = int(src.state.write_pos)
    dst.adopt_state(src.state, wp)
    assert (dst._wp, dst._archived, dst._batches_since_sweep) == (wp, wp, 1)
    assert dst._cap_upto == dst._sealed_upto == wp
    assert not dst.sketch_mirror.warm
    tids = [int(t) for t in np.unique(src.state.trace_id.numpy())[:5]
            if t != 0]
    assert dst.get_spans_by_trace_ids(tids) == src.get_spans_by_trace_ids(
        tids)
    assert np.array_equal(dst.ensure_sketch_mirror().arrays()[0],
                          src.sketch_mirror.arrays()[0])
