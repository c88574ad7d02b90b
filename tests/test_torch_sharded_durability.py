"""Sharded durability on the port (``zipkin_tpu_torch.wal.ShardedWal``,
``wal.replay_sharded_into``, the sharded ``checkpoint`` and the fleet's
pipelined ingest) against the JAX reference's, on the CPU.

The reference's fleet runs on a 2-device virtual CPU mesh
(``tests/conftest.py``); the port keeps two ``StoreState``s on the CPU.
Both take the same spans, made from a seed, at
``tests/test_sharded_serving.py``'s small config (the window arena on).
Port against port (crashed and recovered, pipelined and serial) is
bitwise; port against reference holds integer leaves bitwise and the
float32 dependency moments within the stated tolerance 2
(``moments_close``). Logs and snapshots cross both ways: the segment
bytes, the replayed units and the restored leaves are the same in
either package.

Counterparts of ``tests/test_sharded_serving.py``'s crash recovery,
checkpoint plus WAL tail and pipelined-equals-serial cases and of
``tests/test_checkpoint_main.py``'s sharded round trip and legacy
sharded snapshot; their names here differ, because
``tests/conftest.py`` marks the reference's names slow. Every store and
log is closed in the ``closers`` finalizer.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from test_torch_sharded import assert_fleet_equal, jax_fleet  # noqa: E402
from test_torch_store import PORT, REF, _convert  # noqa: E402
from zipkin_tpu import checkpoint as ref_checkpoint  # noqa: E402
from zipkin_tpu.models.span import Annotation, Endpoint, Span  # noqa: E402
from zipkin_tpu.parallel.shard import (  # noqa: E402
    ShardedSpanStore as RefShardedSpanStore,
)
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu.wal import ShardedWal as RefShardedWal  # noqa: E402
from zipkin_tpu.wal import recover as ref_recover  # noqa: E402
from zipkin_tpu_torch import checkpoint  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.parallel.shard import ShardedSpanStore  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.convert import sharded_states_to_numpy  # noqa: E402
from zipkin_tpu_torch.testing.crash import state_mismatches  # noqa: E402
from zipkin_tpu_torch.wal import ShardedWal, recover, replay_into  # noqa: E402
from zipkin_tpu_torch.wal import record as walrec  # noqa: E402

# tests/test_sharded_serving.py's CFG: the window arena on.
SERVING = dict(capacity=256, ann_capacity=1024, bann_capacity=512,
               max_services=16, max_span_names=64, max_annotation_values=64,
               max_binary_keys=16, cms_width=256, hll_p=8,
               quantile_buckets=128, window_seconds=3600, window_buckets=4)
# tests/test_checkpoint_main.py's sharded config (no window arena).
CKPT = dict(SERVING, max_span_names=32, hll_p=6, window_seconds=0)
END = 2**62
MONTH_S = 30 * 24 * 3600.0


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.array(jax.devices()[:2]), axis_names=("shard",))


@pytest.fixture()
def closers():
    """Things to close at teardown, in reverse order: fleets before the
    logs they journal into."""
    made = []
    yield made
    for c in reversed(made):
        c.close()


def port_fleet(closers, kw=SERVING):
    fleet = ShardedSpanStore(2, tdev.StoreConfig(**kw), device="cpu",
                             registry=obs.Registry())
    closers.append(fleet)
    return fleet


def ref_fleet(closers, mesh, kw=SERVING):
    fleet = RefShardedSpanStore(mesh, dev.StoreConfig(**kw))
    closers.append(fleet)
    return fleet


def port_wal(closers, path, **kw):
    kw.setdefault("fsync", "off")
    wal = ShardedWal(str(path), 2, registry=obs.Registry(), **kw)
    closers.append(wal)
    return wal


def ref_wal(closers, path, **kw):
    from zipkin_tpu import obs as ref_obs

    kw.setdefault("fsync", "off")
    wal = RefShardedWal(str(path), 2, registry=ref_obs.Registry(), **kw)
    closers.append(wal)
    return wal


def ref_spans(n_traces, seed, n_services=6):
    return [s for t in generate_traces(
        n_traces=n_traces, max_depth=3, n_services=n_services,
        rng=np.random.default_rng(seed)) for s in t]


def port_spans(n_traces, seed, n_services=6):
    return _convert(ref_spans(n_traces, seed, n_services), PORT)


def fleet_np(fleet):
    return sharded_states_to_numpy(fleet.states)


def assert_port_fleets_equal(a, b):
    """Two port fleets on the CPU: every leaf of every shard bitwise."""
    assert a.n == b.n
    for i, (sa, sb) in enumerate(zip(a.states, b.states)):
        assert not state_mismatches(sa, sb), (i, state_mismatches(sa, sb))


def clocks_of(fleet):
    inner = fleet.inner
    return (inner._wp_upper, inner._archived_lower,
            inner._batches_since_sweep, fleet._step_seq,
            fleet._wal_applied)


def ids_key(ids):
    return sorted((int(i.trace_id), int(i.timestamp)) for i in ids)


def replayed(wal):
    """A log's complete epochs as (seq, record bytes re-encoded by the
    port's codec): equal lists mean equal parts, marks and deltas."""
    return [(seq, walrec.encode_unit(parts, before, deltas))
            for seq, parts, before, deltas in wal.replay_units(0)]


def segment_files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            full = os.path.join(dirpath, n)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


CHUNKS = ((6, 11), (5, 12), (4, 13))


# ---------------------------------------------------------------------------
# The log itself: bytes, crossings, torn and ragged members
# ---------------------------------------------------------------------------


def test_fleet_wal_bytes_equal_reference(mesh2, closers, tmp_path):
    """The same spans journaled by the port's fleet and the reference's
    leave the same directory tree, byte for byte: shard-NNN/ and
    epoch/ segment logs, shard records first, the epoch last."""
    port = port_fleet(closers)
    ref = ref_fleet(closers, mesh2)
    pw = port_wal(closers, tmp_path / "port")
    rw = ref_wal(closers, tmp_path / "ref")
    port.attach_wal(pw)
    ref.attach_wal(rw)
    for n, seed in CHUNKS:
        port.apply(port_spans(n, seed))
        ref.apply(ref_spans(n, seed))
    pw.sync()
    rw.sync()
    got = segment_files(tmp_path / "port")
    want = segment_files(tmp_path / "ref")
    assert sorted(got) == sorted(want)
    assert {os.path.dirname(k) for k in got} == {
        "shard-000", "shard-001", "epoch"}
    assert got == want
    assert pw.last_seq == rw.last_seq == len(CHUNKS)
    assert port._wal_applied == ref._wal_applied == len(CHUNKS)
    assert pw.stats()["wal_shards"] == 2


def test_fleet_logs_cross_both_ways(mesh2, closers, tmp_path):
    """A directory the reference wrote opens and replays in the port,
    and the reverse, with equal ``replay_units``; the port replays the
    reference's log into a fleet equal to the reference's fleet."""
    ref = ref_fleet(closers, mesh2)
    port = port_fleet(closers)
    rw = ref_wal(closers, tmp_path / "ref")
    pw = port_wal(closers, tmp_path / "port")
    ref.attach_wal(rw)
    port.attach_wal(pw)
    for n, seed in CHUNKS:
        ref.apply(ref_spans(n, seed))
        port.apply(port_spans(n, seed))
    ref.wal_sync()
    port.wal_sync()
    ref_in_port = port_wal(closers, tmp_path / "ref")
    port_in_ref = ref_wal(closers, tmp_path / "port")
    want = replayed(rw)
    assert len(want) == len(CHUNKS)
    assert replayed(ref_in_port) == want
    assert replayed(port_in_ref) == replayed(pw) == want
    fresh = port_fleet(closers)
    stats = replay_into(fresh, ref_in_port)
    assert stats["replayed_records"] == len(CHUNKS)
    assert_fleet_equal(jax_fleet(ref.inner.states), fleet_np(fresh))
    assert fresh.write_frontier() == port.write_frontier()


def test_fleet_wal_member_cut_mid_record_aligns(mesh2, closers, tmp_path):
    """A shard log whose last record is torn (cut mid-record): the torn
    scan drops it and alignment cuts the epoch and the other shard log
    to the same complete prefix, in both packages (the loss counts one
    torn record plus the two it cut); the port's replay lands the fleet
    of the first two units."""
    port = port_fleet(closers)
    wal = port_wal(closers, tmp_path / "wal")
    port.attach_wal(wal)
    for n, seed in CHUNKS:
        port.apply(port_spans(n, seed))
    wal.close()
    seg = sorted((tmp_path / "wal" / "shard-001").glob("wal-*.seg"))[-1]
    seg.write_bytes(seg.read_bytes()[:-7])
    shutil.copytree(tmp_path / "wal", tmp_path / "ref")
    cut = port_wal(closers, tmp_path / "wal")
    other = ref_wal(closers, tmp_path / "ref")
    assert cut.torn_records_cut == other.torn_records_cut == 3
    assert cut.aligned_records_cut == other.aligned_records_cut == 2
    assert cut.last_seq == other.last_seq == 2
    assert replayed(cut) == replayed(other)
    fresh = port_fleet(closers)
    stats = replay_into(fresh, cut)
    assert stats["replayed_records"] == 2
    assert stats["torn_records_cut"] == 3
    twin = port_fleet(closers)
    for n, seed in CHUNKS[:2]:
        twin.apply(port_spans(n, seed))
    assert_port_fleets_equal(fresh, twin)


@pytest.mark.parametrize("cuts", [(1, 3, 2), (3, 2, 1)],
                         ids=["shard-000-shortest", "epoch-shortest"])
def test_fleet_wal_ragged_members_cut_to_shortest(mesh2, closers, tmp_path,
                                                  cuts):
    """Member logs left at different frontiers (a crash between member
    appends or fsyncs): open cuts every log back to the shortest, in
    both packages, and replay stops at that complete prefix."""
    port = port_fleet(closers)
    wal = port_wal(closers, tmp_path / "wal")
    port.attach_wal(wal)
    for n, seed in CHUNKS:
        port.apply(port_spans(n, seed))
    for log, upto in zip(wal.shards + [wal.epoch], cuts):
        log.cut_tail(upto)
    wal.close()
    shutil.copytree(tmp_path / "wal", tmp_path / "ref")
    short = min(cuts)
    want_cut = sum(c - short for c in cuts)
    opened = port_wal(closers, tmp_path / "wal")
    other = ref_wal(closers, tmp_path / "ref")
    assert opened.aligned_records_cut == other.aligned_records_cut == want_cut
    assert [log.last_seq for log in opened.shards + [opened.epoch]] == \
        [short] * 3
    got = replayed(opened)
    assert [s for s, _ in got] == list(range(1, short + 1))
    assert got == replayed(other)


# ---------------------------------------------------------------------------
# Crash recovery, with and without a checkpoint
# ---------------------------------------------------------------------------


def test_port_fleet_crash_recovery_matches_uncrashed_and_reference(
        mesh2, closers, tmp_path):
    """Group-commit recovery: a fleet that crashed after its appends
    (no checkpoint ever taken) replays to bitwise the uncrashed fleet's
    state, frontier and reads, and equals the reference's fleet fed the
    same spans."""
    primary = port_fleet(closers)
    ref = ref_fleet(closers, mesh2)
    wal = ShardedWal(str(tmp_path / "wal"), 2, fsync="off",
                     registry=obs.Registry())
    primary.attach_wal(wal)
    chunks = CHUNKS[:2]
    for n, seed in chunks:
        primary.apply(port_spans(n, seed))
        ref.apply(ref_spans(n, seed))
    primary.wal_sync()
    svc = sorted(primary.get_all_service_names())[0]
    want_ids = ids_key(primary.get_trace_ids_by_name(svc, None, END, 20))
    assert want_ids
    wal.close()  # crash: the fleet is abandoned, no checkpoint

    wal2 = port_wal(closers, tmp_path / "wal")
    rec, stats = recover(None, wal2, fresh_store=lambda d: port_fleet(
        closers), device="cpu")
    assert isinstance(rec, ShardedSpanStore)
    assert stats["replayed_records"] == len(chunks)
    assert stats["replayed_spans"] == sum(
        len(port_spans(n, seed)) for n, seed in chunks)
    assert stats["torn_records_cut"] == 0
    assert_port_fleets_equal(rec, primary)
    assert rec.write_frontier() == primary.write_frontier()
    assert rec._wal_applied == len(chunks)
    assert clocks_of(rec) == clocks_of(primary)
    assert ids_key(rec.get_trace_ids_by_name(svc, None, END, 20)) == \
        want_ids
    assert_fleet_equal(jax_fleet(ref.inner.states), fleet_np(rec))
    # Appends continue past the replayed frontier.
    rec.apply(port_spans(*CHUNKS[2]))
    assert wal2.last_seq == len(chunks) + 1 == rec._wal_applied


def test_port_fleet_checkpoint_plus_tail_recovers(mesh2, closers, tmp_path):
    """The full loop: checkpoint (the fleet clocks and the log's
    truncation), a post-checkpoint tail in the log, crash, recover —
    replaying ONLY the tail on the snapshot lands bitwise on the
    uncrashed fleet (and the reference's), and the mirrors resync
    warm."""
    primary = port_fleet(closers)
    ref = ref_fleet(closers, mesh2)
    wal = ShardedWal(str(tmp_path / "wal"), 2, fsync="off",
                     registry=obs.Registry())
    primary.attach_wal(wal)
    primary.apply(port_spans(6, 21))
    ref.apply(ref_spans(6, 21))
    stats = checkpoint.save(primary, str(tmp_path / "ckpt"))
    assert stats["wal_truncated_segments"] >= 0
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["shards"] == 2 and meta["clocks"]["sharded"] == 1
    assert meta["clocks"]["wal_applied"] == 1
    primary.apply(port_spans(5, 22))  # the tail
    ref.apply(ref_spans(5, 22))
    primary.wal_sync()
    wal.close()

    wal2 = port_wal(closers, tmp_path / "wal")
    rec, rstats = recover(str(tmp_path / "ckpt"), wal2, device="cpu")
    closers.append(rec)
    assert rstats["replayed_records"] == 1  # the tail only
    assert set(rstats["load"]) >= {"inflate_s", "crc_s", "h2d_s"}
    assert_port_fleets_equal(rec, primary)
    assert rec.write_frontier() == primary.write_frontier()
    assert clocks_of(rec) == clocks_of(primary)
    assert rec.ensure_sketch_mirror().warm
    for a, b in zip(rec.ensure_sketch_mirror().arrays(),
                    primary.ensure_sketch_mirror().arrays()):
        assert np.array_equal(a, b)
    assert_fleet_equal(jax_fleet(ref.inner.states), fleet_np(rec))


def test_port_recover_on_reference_snapshot_and_log(mesh2, closers,
                                                   tmp_path):
    """The reference's snapshot plus its log's tail, recovered by the
    port's ``recover``, equal the reference's own ``recover`` of the
    same files: states, clocks and replay stats."""
    ref = ref_fleet(closers, mesh2)
    rw = ref_wal(closers, tmp_path / "wal")
    ref.attach_wal(rw)
    ref.apply(ref_spans(6, 31))
    ref.set_time_to_live(ref.get_trace_ids_by_name(
        sorted(ref.get_all_service_names())[0], None, END, 1)[0].trace_id,
        MONTH_S)
    ref_checkpoint.save(ref, str(tmp_path / "ckpt"))
    ref.apply(ref_spans(5, 32))
    ref.apply(ref_spans(4, 33))
    ref.wal_sync()
    rw.close()
    for d in ("wal", "ckpt"):
        shutil.copytree(tmp_path / d, tmp_path / f"port-{d}")

    rw2 = ref_wal(closers, tmp_path / "wal")
    want, wstats = ref_recover(str(tmp_path / "ckpt"), rw2, mesh=mesh2)
    closers.append(want)
    pw = port_wal(closers, tmp_path / "port-wal")
    got, gstats = recover(str(tmp_path / "port-ckpt"), pw, device="cpu")
    closers.append(got)
    for k in ("replayed_records", "replayed_spans", "applied_seq",
              "torn_records_cut"):
        assert gstats[k] == wstats[k], k
    assert gstats["replayed_records"] == 2
    assert_fleet_equal(jax_fleet(want.inner.states), fleet_np(got))
    assert clocks_of(got) == (want.inner._wp_upper,
                              want.inner._archived_lower,
                              want.inner._batches_since_sweep,
                              want._step_seq, want._wal_applied)
    assert got.ttls == want.ttls
    assert sorted(got.pins.tids()) == sorted(want.pins.tids())


def test_port_fleet_replay_banks_pinned_tail(mesh2, closers, tmp_path):
    """A span of a pinned trace that lands after the checkpoint is banked
    again when the sharded replay re-drives its record, as live ingest
    banked it: the recovered pin bank equals the uncrashed fleet's and
    the reference's recovered bank."""
    pin = _pin_span(Span, Annotation, Endpoint)
    late = Span(4242, "q", 2, 1,
                (Annotation(9, "sr", Endpoint(1, 80, "pinsvc")),), ())

    def journal(fleet, wal, ckpt, save, conv):
        fleet.attach_wal(wal)
        fleet.apply(conv(ref_spans(6, 41) + [pin]))
        fleet.set_time_to_live(4242, MONTH_S)
        save(fleet, str(ckpt))
        fleet.apply(conv(ref_spans(4, 42) + [late]))  # the tail
        fleet.wal_sync()
        wal.close()

    primary = port_fleet(closers)
    journal(primary, port_wal(closers, tmp_path / "wal"), tmp_path / "ckpt",
            checkpoint.save, lambda spans: _convert(spans, PORT))
    ref = ref_fleet(closers, mesh2)
    journal(ref, ref_wal(closers, tmp_path / "ref-wal"),
            tmp_path / "ref-ckpt", ref_checkpoint.save, list)

    rec, stats = recover(str(tmp_path / "ckpt"),
                         port_wal(closers, tmp_path / "wal"), device="cpu")
    closers.append(rec)
    want, _ = ref_recover(str(tmp_path / "ref-ckpt"),
                          ref_wal(closers, tmp_path / "ref-wal"), mesh=mesh2)
    closers.append(want)
    assert stats["replayed_records"] == 1

    def bank(fleet):
        return sorted((int(s.id), s.name) for s in fleet.pins.get(4242))

    assert bank(rec) == bank(primary) == bank(want)
    assert (2, "q") in bank(rec)
    assert_port_fleets_equal(rec, primary)


# ---------------------------------------------------------------------------
# Pipelined sharded ingest
# ---------------------------------------------------------------------------


def test_port_fleet_pipelined_matches_serial(mesh2, closers, tmp_path):
    """The three-stage pipeline driving every shard's commit lands the
    serial path's fleet bitwise (states, frontier, counters, mirrors),
    equal to the reference's serial fleet; a journaled pipelined drive
    replays into the same fleet."""
    serial = port_fleet(closers)
    piped = port_fleet(closers)
    ref = ref_fleet(closers, mesh2)
    wal = port_wal(closers, tmp_path / "wal")
    piped.attach_wal(wal)
    chunks = [(4, s) for s in (31, 32, 33, 34, 35)]
    for n, seed in chunks:
        serial.apply(port_spans(n, seed))
        ref.apply(ref_spans(n, seed))
    with piped.pipelined(depth=4) as pipe:
        for n, seed in chunks:
            piped.apply(port_spans(n, seed))
        assert pipe.c_units.value == len(chunks)
    assert piped._pipeline is None
    assert_port_fleets_equal(serial, piped)
    assert serial.write_frontier() == piped.write_frontier()
    assert serial.counters() == piped.counters()
    assert serial.shard_counters() == piped.shard_counters()
    for a, b in zip(serial.ensure_sketch_mirror().arrays(),
                    piped.ensure_sketch_mirror().arrays()):
        assert np.array_equal(a, b)
    assert_fleet_equal(jax_fleet(ref.inner.states), fleet_np(piped))
    assert piped._wal_applied == len(chunks)
    fresh = port_fleet(closers)
    assert replay_into(fresh, wal)["replayed_records"] == len(chunks)
    assert_port_fleets_equal(fresh, piped)


def test_port_fleet_pipeline_lifecycle(closers):
    """One pipeline at a time; drain and stop are no-ops without one;
    close() stops a running pipeline after committing what it took."""
    fleet = port_fleet(closers)
    fleet.drain_pipeline()
    fleet.stop_pipeline()
    pipe = fleet.start_pipeline(2)
    assert pipe.depth == 2
    with pytest.raises(RuntimeError, match="already running"):
        fleet.start_pipeline()
    fleet.apply(port_spans(4, 41))
    fleet.close()
    assert fleet._pipeline is None
    assert fleet.shard_counters()[0]["batches"] == 1


# ---------------------------------------------------------------------------
# Snapshots: round trip, legacy migration, crossings
# ---------------------------------------------------------------------------


def _pin_span(cls_span, cls_ann, cls_ep):
    ep = cls_ep(1, 80, "pinsvc")
    return cls_span(4242, "p", 1, None, (cls_ann(7, "sr", ep),), ())


def test_port_fleet_snapshot_round_trip(closers, tmp_path):
    """A fleet snapshot restores a fleet with the snapshot's shard
    count: states bitwise, reads, sketches, TTLs and pinned banks."""
    store = port_fleet(closers, CKPT)
    store.apply(port_spans(12, 51))
    store.apply(_convert([_pin_span(Span, Annotation, Endpoint)], PORT))
    store.set_time_to_live(4242, MONTH_S)
    path = str(tmp_path / "sharded-ckpt")
    stats = checkpoint.save(store, path)
    assert stats["bytes_on_disk"] > 0
    restored = checkpoint.load(path, device="cpu")
    closers.append(restored)
    assert isinstance(restored, ShardedSpanStore) and restored.n == 2
    assert_port_fleets_equal(restored, store)
    assert restored.stored_span_count() == store.stored_span_count()
    svc = sorted(store.get_all_service_names())[0]
    want = store.get_trace_ids_by_name(svc, None, END, 10)
    got = restored.get_trace_ids_by_name(svc, None, END, 10)
    assert ids_key(got) == ids_key(want)
    tid = want[0].trace_id
    assert [s.id for t in restored.get_spans_by_trace_ids([tid])
            for s in t] == [s.id for t in store.get_spans_by_trace_ids(
                [tid]) for s in t]
    assert restored.get_time_to_live(4242) == MONTH_S
    assert restored.get_spans_by_trace_id(4242)
    d1 = {(lk.parent, lk.child) for lk in store.get_dependencies().links}
    d2 = {(lk.parent, lk.child)
          for lk in restored.get_dependencies().links}
    assert d1 == d2 and d1
    for a, b in zip(restored.ensure_sketch_mirror().arrays(),
                    store.ensure_sketch_mirror().arrays()):
        assert np.array_equal(a, b)


def test_port_fleet_chunked_save_matches_one_pass(closers, tmp_path,
                                                  monkeypatch):
    """The chunked, resumable gather stacks a fleet's leaves as the
    one-pass gather does."""
    monkeypatch.setattr(checkpoint, "_SLAB_BYTES", 1 << 12)
    store = port_fleet(closers)
    store.apply(port_spans(12, 52))
    stats = checkpoint.save(store, str(tmp_path / "chunked"),
                            chunk_deadline_s=30.0)
    assert stats["slabs"] > 20
    checkpoint.save(store, str(tmp_path / "one"))
    a = np.load(str(tmp_path / "chunked" / "state.npz"))
    b = np.load(str(tmp_path / "one" / "state.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def _to_legacy(path, n):
    """Rewrite a fleet snapshot into the revision-3 layout: links only
    implicit in the per-shard rings plus zero watermarks, no
    streaming-join leaves (tests/test_checkpoint_main.py's rewrite)."""
    state_file = os.path.join(path, "state.npz")
    data = dict(np.load(state_file))
    for gone in ("span_tab", "pend_key", "pend_dur", "pend_tsf",
                 "pend_tsl", "pend_pos", "dep_window", "dep_window_ts"):
        del data[gone]
    data["dep_moments"] = np.zeros_like(data["dep_moments"])
    data["dep_banks"] = np.zeros_like(data["dep_banks"])
    data["dep_archived_gid"] = np.zeros(n, np.int64)
    np.savez_compressed(state_file, **data)
    meta_file = os.path.join(path, "meta.json")
    with open(meta_file) as f:
        meta = json.load(f)
    meta["revision"] = 3
    for k in ("span_tab_slots", "pend_slots"):
        meta["config"].pop(k, None)
    with open(meta_file, "w") as f:
        json.dump(meta, f)


def test_port_legacy_fleet_snapshot_migrates(mesh2, closers, tmp_path):
    """A pre-revision-4 fleet snapshot: per-shard live-link migration,
    the ``[n_shards]`` write_pos fallback slicing and the per-shard span
    table rebuild restore the links and cross-batch joins — and the
    restored fleet equals the reference's restore of the same files."""
    store = port_fleet(closers, CKPT)
    traces = generate_traces(n_traces=10, max_depth=3, n_services=6,
                             rng=np.random.default_rng(61))
    parents = [t[0] for t in traces]
    children = [s for t in traces for s in t[1:]]
    store.apply(_convert(parents + children, PORT))
    expected = {(lk.parent, lk.child, lk.duration_moments.count)
                for lk in store.get_dependencies().links}
    assert expected
    path = str(tmp_path / "sharded-legacy")
    checkpoint.save(store, path)
    _to_legacy(path, 2)

    restored = checkpoint.load(path, device="cpu")
    closers.append(restored)
    ref = ref_checkpoint.load(path, mesh=mesh2)
    closers.append(ref)
    assert_fleet_equal(jax_fleet(ref.inner.states), fleet_np(restored))
    got = {(lk.parent, lk.child, lk.duration_moments.count)
           for lk in restored.get_dependencies().links}
    assert got == expected
    assert got == {(lk.parent, lk.child, lk.duration_moments.count)
                   for lk in ref.get_dependencies().links}
    # The rebuilt span table resolves a child arriving after the restore
    # whose parent exists only in the checkpointed ring.
    parent = parents[0]
    ep = Endpoint(9, 80, sorted(restored.get_all_service_names())[0])
    child = Span(parent.trace_id, "late", 987654, parent.id,
                 (Annotation(50, "sr", ep), Annotation(60, "ss", ep)), ())
    restored.apply(_convert([child], PORT))
    ref.apply([child])
    after = {(lk.parent, lk.child)
             for lk in restored.get_dependencies().links}
    assert len(after) >= len({(p, c) for p, c, _ in expected})
    assert after == {(lk.parent, lk.child)
                     for lk in ref.get_dependencies().links}
    assert_fleet_equal(jax_fleet(ref.inner.states), fleet_np(restored))


def test_fleet_snapshots_cross_both_ways(mesh2, closers, tmp_path):
    """A reference fleet snapshot loads into the port and a port one
    into the reference's ``checkpoint.load`` on the mesh: the stacked
    leaves (bitwise: a snapshot copies bytes), the fleet clocks, TTLs
    and pinned banks come back."""
    ref = ref_fleet(closers, mesh2, CKPT)
    port = port_fleet(closers, CKPT)
    pin = _pin_span(Span, Annotation, Endpoint)
    ref.apply(ref_spans(12, 71) + [pin])
    port.apply(port_spans(12, 71) + _convert([pin], PORT))
    ref.set_time_to_live(4242, MONTH_S)
    port.set_time_to_live(4242, MONTH_S)
    ref_checkpoint.save(ref, str(tmp_path / "from-ref"))
    checkpoint.save(port, str(tmp_path / "from-port"))

    in_port = checkpoint.load(str(tmp_path / "from-ref"), device="cpu")
    closers.append(in_port)
    in_ref = ref_checkpoint.load(str(tmp_path / "from-port"), mesh=mesh2)
    closers.append(in_ref)
    assert in_port.n == 2 and in_ref.n == 2
    ref_np = jax_fleet(ref.inner.states)
    got = fleet_np(in_port)
    for k, v in ref_np.items():
        if k == "counters":
            for c, x in v.items():
                assert np.array_equal(np.asarray(x), got[k][c]), c
        else:
            assert np.array_equal(np.asarray(v), got[k]), k
    assert_fleet_equal(jax_fleet(in_ref.inner.states), fleet_np(port))
    assert clocks_of(in_port) == (ref.inner._wp_upper,
                                  ref.inner._archived_lower,
                                  ref.inner._batches_since_sweep,
                                  ref._step_seq, ref._wal_applied)
    assert (in_ref.inner._wp_upper, in_ref._step_seq) == (
        port.inner._wp_upper, port._step_seq)
    assert in_port.get_time_to_live(4242) == MONTH_S
    assert in_ref.get_time_to_live(4242) == MONTH_S
    assert _convert(in_port.get_spans_by_trace_id(4242), REF) == \
        in_ref.get_spans_by_trace_id(4242)
