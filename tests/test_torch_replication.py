"""The port's replication (``zipkin_tpu_torch/replicate``,
``store/replica.py``, ``concurrency.py`` and the daemon's ``--ship-port``
/ ``--follow``) against the JAX package's, on the CPU, at
``tests/test_replication.py``'s small ``CFG``.

- frames: every message both packages send is byte-identical, each
  package decodes (and reads off a socket) the other's, a bad CRC
  raises ``ShipProtocolError`` in both, and ``config_to_dict`` agrees;
- the reference's ``TestReplicaAgreement`` on the port: a port replica
  fed the JAX primary's log and a port primary's log has the port
  primary's device aggregates and the reference replica's mirror bit
  for bit, answers every read as the reference replica does (the HLL
  estimate within stated tolerance 3, ``rel=1e-5``; bitwise against the
  port primary) and seals the reference's segment bytes; the durable
  bound, gap, duplicate, read-only and retention cases run on both;
- across the wire over 127.0.0.1, both ways: a port standby follows a
  reference primary (state equal to the JAX primary's: integer leaves
  bitwise, the float32 moments within stated tolerance 2), a reference
  replica follows a port primary, and an anchor crosses each way;
- the reference's ``TestShipWire``, ``TestStandbyAck`` and
  ``TestColdResync`` as scenarios each package runs in the same test,
  their outcomes equal;
- the daemon: ``build_app`` with a ship port, ``build_follower_app`` in
  both modes with ``--platform cpu``, the follower's serving loop and
  ordered shutdown, called as functions, its ``/api/replication`` and
  reads equal to the reference follower daemon's.

Every server, follower, client, store and log is closed in a fixture
finalizer, every socket call and join has a timeout, and no test here
starts a process or installs a signal handler. The reference's
``TestCrashDuringShip`` (3 cases) and ``TestLiveFleetTrace`` (1 case)
run on the port in the slow lane, where the reference keeps them.
"""

import json
import os
import socket
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_replication import CFG as RCFG  # noqa: E402
from test_torch_store import (  # noqa: E402
    PORT,
    _convert,
    assert_states_equal,
    jax_leaves,
)
from zipkin_tpu import checkpoint as ref_checkpoint  # noqa: E402
from zipkin_tpu import obs as ref_obs  # noqa: E402
from zipkin_tpu import replicate as ref_replicate  # noqa: E402
from zipkin_tpu.replicate import protocol as RP  # noqa: E402
from zipkin_tpu.store.archive import TieredSpanStore as RefTiered  # noqa: E402
from zipkin_tpu.store.replica import ReplicaReadOnlyError as RefReadOnly  # noqa: E402
from zipkin_tpu.store.replica import ReplicaSpanStore as RefReplica  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu.wal import WalReplayError as RefReplayError  # noqa: E402
from zipkin_tpu.wal import WriteAheadLog as RefWal  # noqa: E402
from zipkin_tpu_torch import checkpoint  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch import replicate  # noqa: E402
from zipkin_tpu_torch.replicate import protocol as P  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.archive import TieredSpanStore  # noqa: E402
from zipkin_tpu_torch.store.convert import state_to_numpy  # noqa: E402
from zipkin_tpu_torch.store.replica import (  # noqa: E402
    ReplicaReadOnlyError,
    ReplicaSpanStore,
)
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402
from zipkin_tpu_torch.testing.crash import state_mismatches  # noqa: E402
from zipkin_tpu_torch.wal import WalReplayError, WriteAheadLog  # noqa: E402

PCFG = tdev.StoreConfig(**RCFG._asdict())
MIRROR_LEAVES = ("svc_hist", "ann_svc_counts", "name_presence",
                 "ann_value_counts", "bann_key_counts", "hll_traces",
                 "win_epoch", "win_counts", "win_sums", "win_mm")
END_TS = 1 << 62
IO_S = 30.0
DRAIN_S = 60.0


def ref_spans(n=2400, n_traces=500, seed=5):
    """``tests/test_replication.py``'s drive, seeded."""
    traces = generate_traces(n_traces=n_traces, max_depth=3,
                             n_services=12, rng=np.random.default_rng(seed))
    return [s for t in traces for s in t][:n]


SPANS = ref_spans()


def feed(store, spans, chunk=128):
    for i in range(0, len(spans), chunk):
        store.apply(spans[i:i + chunk])


def mirror_equal(a, b) -> bool:
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b, strict=True))


def _port_store(cfg=PCFG):
    return TorchSpanStore(cfg, device="cpu", registry=obs.Registry())


# Each package's replication pieces, so one scenario body drives either.
JAX = types.SimpleNamespace(
    name="jax", R=ref_replicate, P=RP, cfg=RCFG,
    new_store=lambda cfg=RCFG: TpuSpanStore(cfg),
    tiered=lambda hot: RefTiered(hot),
    wal=lambda d, **kw: RefWal(d, **kw),
    replica=lambda **kw: RefReplica(RCFG, background_compaction=False,
                                    registry=ref_obs.Registry(), **kw),
    spans=lambda spans: spans, leaves=jax_leaves,
    registry=ref_obs.Registry, checkpoint=ref_checkpoint,
    ReplayError=RefReplayError, ReadOnly=RefReadOnly)
TORCH = types.SimpleNamespace(
    name="port", R=replicate, P=P, cfg=PCFG,
    new_store=lambda cfg=PCFG: _port_store(cfg),
    tiered=lambda hot: TieredSpanStore(hot, registry=obs.Registry()),
    wal=lambda d, **kw: WriteAheadLog(d, registry=obs.Registry(), **kw),
    replica=lambda **kw: ReplicaSpanStore(PCFG, background_compaction=False,
                                          registry=obs.Registry(), **kw),
    spans=lambda spans: _convert(spans, PORT), leaves=state_to_numpy,
    registry=obs.Registry, checkpoint=checkpoint,
    ReplayError=WalReplayError, ReadOnly=ReplicaReadOnlyError)
PKGS = (JAX, TORCH)


def device_mirror(pkg, hot):
    leaves = pkg.leaves(hot.state)
    return [np.asarray(leaves[k]) for k in MIRROR_LEAVES]


@pytest.fixture
def closers():
    """Close what a test opens, last opened first, even when it fails."""
    out = []
    yield out
    errors = []
    for fn in reversed(out):
        try:
            fn()
        except Exception as e:  # keep closing the others
            errors.append(e)
    if errors:
        raise errors[0]


def serve(pkg, shipper, closers):
    server = pkg.R.ShipServer(shipper, host="127.0.0.1", port=0,
                              io_timeout_s=IO_S)
    thread = server.serve_in_thread()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=IO_S)
        assert not thread.is_alive()

    closers.append(stop)
    return server, server.server_address[1]


def client_of(pkg, port, name, mode="replica"):
    return pkg.R.ShipClient("127.0.0.1", port, name, mode=mode,
                            timeout_s=IO_S)


def drained(follower, wal):
    """``Follower.drain`` until the follower has applied ``wal``'s last
    record: a fetch that began before a drain call can complete after it
    with nothing, so one drain may return before the newest record is
    fetched (both packages' ``drain`` alike)."""
    deadline = time.monotonic() + DRAIN_S
    while True:
        assert follower.drain(DRAIN_S), follower.status()
        if follower.status()["appliedSeq"] >= wal.last_seq:
            return
        assert time.monotonic() < deadline, follower.status()


def follower_of(pkg, target, client, closers, start=True):
    f = pkg.R.Follower(target, client, poll_interval_s=0.002,
                       registry=pkg.registry())
    closers.append(f.close)
    return f.start() if start else f


# ---------------------------------------------------------------------------
# (a) Frames
# ---------------------------------------------------------------------------


def _wire_span(i):
    return obs.fleet.span_to_wire(1000 + i, 2000 + i, 1000 + i,
                                  "replica apply", "zipkin-tpu-r1",
                                  1_700_000_000_000_000 + i, 37,
                                  {"wal.seq": str(i)})


ANCHOR_ARRAYS = (np.arange(12, dtype=np.int32).reshape(3, 4),
                 np.full(5, -1, np.int64), np.zeros((2, 0, 3), np.int32),
                 np.array([1.5, -2.25], np.float32))
ANCHOR_DICTS = {"services": [{"s": "a"}, {"s": "b"}], "span_names": []}
MESSAGES = {
    "hello": lambda M: M.encode_msg(M.HELLO, {
        "proto": M.PROTO_VERSION, "follower": "standby-host",
        "mode": "standby"}),
    "hello_ok": lambda M: M.encode_msg(M.HELLO_OK, {
        "proto": M.PROTO_VERSION, "config": M.config_to_dict(
            M.config_from_dict({})), "last_seq": 7, "durable_seq": 5,
        "first_seq": 1}),
    "fetch": lambda M: M.encode_msg(M.FETCH, {"cursor": 3,
                                              "max_bytes": 8 << 20}),
    "fetch_ack": lambda M: M.encode_msg(M.FETCH, {
        "cursor": 3, "max_bytes": 8 << 20, "ack": 0}),
    "fetch_spans": lambda M: M.encode_msg(M.FETCH, {
        "cursor": 9, "max_bytes": 1 << 20, "ack": 9,
        "spans": [_wire_span(i) for i in range(3)]}),
    "fetch_metrics": lambda M: M.encode_msg(M.FETCH, {
        "cursor": 9, "max_bytes": 1 << 20, "metrics": obs.registry_snapshot(
            _snapshot_registry())}),
    "fetch_spans_metrics": lambda M: M.encode_msg(M.FETCH, {
        "cursor": 9, "max_bytes": 1 << 20, "ack": 4,
        "spans": [_wire_span(7)],
        "metrics": obs.registry_snapshot(_snapshot_registry())}),
    "anchor": lambda M: M.encode_msg(M.ANCHOR, {}),
    "records_0": lambda M: M.encode_records([], 12, 11),
    "records_3": lambda M: M.encode_records(
        [(4, b"\x00\x01rec"), (5, bytes(range(256)) * 3), (6, b"")], 6, 6),
    "anchor_ok": lambda M: M.encode_anchor(
        41, 123_456, M.config_to_dict(M.config_from_dict({})),
        ANCHOR_DICTS, list(ANCHOR_ARRAYS)),
    "need_anchor": lambda M: M.encode_msg(M.NEED_ANCHOR, {"first_seq": 9}),
    "err": lambda M: M.encode_msg(M.ERR, {"error": "FETCH before HELLO"}),
}


def _snapshot_registry():
    reg = obs.Registry()
    reg.register(obs.Counter("zipkin_replication_applied_records_total",
                             "Shipped WAL records applied locally")).inc(3)
    reg.register(obs.Gauge("zipkin_replication_lag_records", "lag",
                           fn=lambda: 2.0))
    return reg


def _read_off_socket(M, frame):
    a, b = socket.socketpair()
    try:
        a.settimeout(IO_S)
        b.settimeout(IO_S)
        a.sendall(frame)
        return M.read_msg(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("kind", sorted(MESSAGES))
def test_port_frames_are_the_reference_bytes(kind):
    mine, theirs = MESSAGES[kind](P), MESSAGES[kind](RP)
    assert mine == theirs
    (n,) = P._LEN.unpack_from(mine, 0)
    assert n == len(mine) - 4
    # Each package decodes the other's frame, off a socket too.
    got = P.decode_msg(theirs[4:])
    want = RP.decode_msg(mine[4:])
    assert got == want
    assert _read_off_socket(P, theirs) == _read_off_socket(RP, mine) == got
    msg_type, meta, blob = got
    if msg_type == P.RECORDS:
        assert P.decode_records(meta, blob) == RP.decode_records(meta, blob)
    if msg_type == P.ANCHOR_OK:
        a, b = P.decode_anchor(meta, blob), RP.decode_anchor(meta, blob)
        assert a[:4] == b[:4] == (41, 123_456, meta["config"], ANCHOR_DICTS)
        for x, y, z in zip(a[4], b[4], ANCHOR_ARRAYS, strict=True):
            assert x.dtype == y.dtype == z.dtype and x.shape == z.shape
            assert np.array_equal(x, z) and np.array_equal(y, z)


@pytest.mark.parametrize("where", ["crc", "length"])
def test_port_bad_frames_raise_as_the_reference(where):
    frame = bytearray(MESSAGES["records_3"](P))
    if where == "crc":
        frame[-1] ^= 0xFF
        for M in (P, RP):
            with pytest.raises(M.ShipProtocolError, match="CRC"):
                M.decode_msg(bytes(frame[4:]))
            with pytest.raises(M.ShipProtocolError, match="CRC"):
                _read_off_socket(M, bytes(frame))
    else:
        frame[:4] = (3).to_bytes(4, "big")
        for M in (P, RP):
            with pytest.raises(M.ShipProtocolError, match="length 3"):
                _read_off_socket(M, bytes(frame))


def test_port_config_dict_is_the_reference_and_crosses():
    assert P.config_to_dict(PCFG) == RP.config_to_dict(RCFG)
    assert json.dumps(P.config_to_dict(PCFG)) == json.dumps(
        RP.config_to_dict(RCFG))
    assert P.config_from_dict(RP.config_to_dict(RCFG)) == PCFG
    assert RP.config_from_dict(P.config_to_dict(PCFG)) == RCFG
    # Unknown keys are ignored, missing ones take the defaults.
    assert P.config_from_dict({"capacity": 512, "future_knob": 1}) == \
        tdev.StoreConfig(capacity=512)


# ---------------------------------------------------------------------------
# (b) The reference's TestReplicaAgreement on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def primaries(tmp_path_factory):
    """A JAX tiered primary and a port tiered primary (device cpu) with
    logs at fsync=off, each fed the same 2,400 spans in 128-span
    applies (the ring of 1,024 laps, so both cold tiers hold rows)."""
    tmp = tmp_path_factory.mktemp("primaries")
    out = {}
    try:
        for pkg in PKGS:
            store = pkg.tiered(pkg.new_store())
            wal = pkg.wal(str(tmp / pkg.name), fsync="off")
            out[pkg.name] = (store, wal)
            store.attach_wal(wal)
            feed(store, pkg.spans(SPANS))
            store.hot.ensure_sketch_mirror()
        assert out["jax"][1].last_seq == out["port"][1].last_seq >= 10
        yield out
    finally:
        for store, wal in out.values():
            wal.close()
            store.close()


def _reads(store, svcs, tids):
    """Every read ``TestReplicaAgreement`` compares, as plain values."""
    reads = {"services": sorted(store.get_all_service_names())}
    for svc in svcs:
        reads[svc] = (
            sorted(store.get_span_names(svc)),
            store.service_duration_quantiles(svc, [0.5, 0.95, 0.99]),
            store.top_annotations(svc), store.top_binary_keys(svc),
            store.get_trace_ids_by_name(svc, None, END_TS, 10),
            store.get_trace_ids_by_annotation(svc, "sr", None, END_TS, 10))
    reads["rows"] = store.get_spans_by_trace_ids(tids)
    reads["exist"] = sorted(store.traces_exist(tids))
    reads["durations"] = store.get_traces_duration(tids)
    return reads


@pytest.mark.parametrize("source", ["jax", "port"])
def test_port_replica_agrees_with_primary_and_reference(primaries, source,
                                                        closers):
    """The acceptance gate of the reference's agreement test, on the
    port: fed only the ``source`` primary's WAL records, the port's
    device-free replica holds the port primary's device aggregates and
    the reference replica's mirror bitwise, seals the reference
    replica's segment bytes, and answers every read as both do."""
    wal = primaries[source][1]
    port_primary = primaries["port"][0]
    rep = TORCH.replica()
    closers.append(rep.close)
    ref = JAX.replica()
    closers.append(ref.close)
    for seq, payload in wal.replay(0):
        assert rep.apply_record(seq, payload) == ref.apply_record(
            seq, payload)
    assert rep.applied_seq() == ref.applied_seq() == wal.last_seq
    got = rep.sketch_mirror.arrays()
    assert mirror_equal(got, device_mirror(TORCH, port_primary.hot))
    assert mirror_equal(got, ref.sketch_mirror.arrays())
    segs = rep.archive.snapshot()
    assert segs and segs[0].gid_lo == 0
    assert segs[-1].gid_hi == rep.counters()["replica_wp"] == len(SPANS)
    assert [s.to_bytes() for s in segs] == [
        s.to_bytes() for s in ref.archive.snapshot()]
    svcs = sorted(rep.get_all_service_names())[:4]
    tids = sorted({s.trace_id for s in SPANS[::37]})[:20]
    want = {k: _convert(v, PORT) for k, v in _reads(ref, svcs, tids).items()}
    assert _reads(rep, svcs, tids) == want
    # ... and the port primary's hot + cold federation answers the same.
    assert _reads(port_primary, svcs, tids) == want
    # HLL: bitwise the port primary's, the reference's within tolerance 3.
    assert (rep.estimated_unique_traces()
            == port_primary.estimated_unique_traces())
    assert rep.estimated_unique_traces() == pytest.approx(
        ref.estimated_unique_traces(), rel=1e-5)
    counters = rep.counters()
    assert {k: counters[k] for k in counters if k.startswith("replica_")} \
        == {k: v for k, v in ref.counters().items()
            if k.startswith("replica_")}
    f0 = rep.write_frontier()
    assert rep.write_frontier() == f0 == (wal.last_seq, 0)


def _unacked_tail(pkg, tmp):
    primary = pkg.new_store()
    # Huge group-commit interval: appends stay un-durable until an
    # explicit sync — the durable frontier visibly lags.
    wal = pkg.wal(str(tmp / f"tail-{pkg.name}"), fsync="interval",
                  interval_s=3600)
    try:
        primary.attach_wal(wal)
        shipper = pkg.R.WalShipper(primary, wal, registry=pkg.registry())
        feed(primary, pkg.spans(SPANS[:600]))
        out = {"durable": wal.durable_seq, "last": wal.last_seq}
        assert wal.durable_seq < wal.last_seq
        records, last, durable = shipper.fetch("f1", 0, 1 << 30)
        assert last == wal.last_seq and durable == wal.durable_seq
        assert all(seq <= durable for seq, _ in records)
        assert len(records) == durable
        out["first"] = [(s, len(p)) for s, p in records]
        wal.sync()
        records2, _, durable2 = shipper.fetch("f1", durable, 1 << 30)
        assert durable2 == wal.last_seq
        out["second"] = [(s, p) for s, p in records2]
        assert [s for s, _ in records2] == list(
            range(durable + 1, wal.last_seq + 1))
        out["status"] = shipper.status()
        shipper.close()
        return out
    finally:
        wal.close()
        primary.close()


def test_port_unacked_tail_absent_in_full(tmp_path):
    """The durable-only ship bound on both packages: the same fetches
    give the same records (equal bytes) and the same status."""
    assert _unacked_tail(TORCH, tmp_path) == _unacked_tail(JAX, tmp_path)


def _gap_and_duplicate(pkg, records):
    rep = pkg.replica()
    try:
        out = [rep.apply_record(*records[0])]
        # Duplicate: idempotent no-op.
        out.append(rep.apply_record(*records[0]))
        # Gap: lineage error, nothing applied.
        with pytest.raises(pkg.ReplayError, match="without gaps"):
            rep.apply_record(*records[2])
        out.append(rep.applied_seq())
        # In-order continues fine.
        out.append(rep.apply_record(*records[1]))
        out.append(rep.applied_seq())
        # Writes are refused.
        with pytest.raises(pkg.ReadOnly):
            rep.apply([])
        with pytest.raises(pkg.ReadOnly):
            rep.set_time_to_live(1, 60.0)
        out.append(rep.get_time_to_live(SPANS[0].trace_id))
        return out
    finally:
        rep.close()


def test_port_replica_gap_rejected_duplicate_skipped(primaries):
    records = list(primaries["port"][1].replay(0))[:3]
    got = _gap_and_duplicate(TORCH, records)
    assert got == _gap_and_duplicate(JAX, records)
    assert got[1] == 0 and got[2] == got[4] - 1 == records[0][0]


def _retention(pkg, wal):
    rep = pkg.replica(retain_spans=512)
    try:
        for seq, payload in wal.replay(0):
            rep.apply_record(seq, payload)
        segs = rep.archive.snapshot()
        assert segs, "retention dropped everything"
        lo = min(s.gid_lo for s in segs)
        wp = rep.counters()["replica_wp"]
        assert lo >= wp - 512 - RCFG.capacity  # whole segments only
        # Recent traces still read; the sketch tier still covers the
        # WHOLE history (the mirror is lifetime state).
        recent = [SPANS[-1].trace_id]
        assert rep.get_spans_by_trace_ids(recent)
        return ([(s.gid_lo, s.gid_hi, s.to_bytes()) for s in segs],
                rep.get_spans_by_trace_ids(recent),
                rep.estimated_unique_traces(), rep.sketch_mirror.arrays())
    finally:
        rep.close()


def test_port_replica_retention_drops_old_segments(primaries):
    wal = primaries["port"][1]
    segs, rows, hll, mirror = _retention(TORCH, wal)
    r_segs, r_rows, r_hll, r_mirror = _retention(JAX, wal)
    assert segs == r_segs and rows == _convert(r_rows, PORT)
    assert mirror_equal(mirror, r_mirror)
    assert hll == primaries["port"][0].estimated_unique_traces()
    assert hll == pytest.approx(r_hll, rel=1e-5)


# ---------------------------------------------------------------------------
# (d) The reference's TestShipWire, TestStandbyAck and TestColdResync,
#     each package in turn, outcomes equal
# ---------------------------------------------------------------------------


def _tcp_follow_and_anchor(pkg, tmp, closers):
    primary = pkg.tiered(pkg.new_store())
    wal = pkg.wal(str(tmp / f"wire-{pkg.name}"), fsync="off")
    closers.append(wal.close)
    primary.attach_wal(wal)
    shipper = pkg.R.WalShipper(primary, registry=pkg.registry())
    _, port = serve(pkg, shipper, closers)
    spans = pkg.spans(SPANS[:1600])
    half = 768
    feed(primary, spans[:half])
    client = client_of(pkg, port, "t1")
    hello = client.connect()
    assert pkg.P.config_from_dict(hello["config"]) == pkg.cfg
    replica = pkg.replica()
    closers.append(replica.close)
    follower = follower_of(pkg, pkg.R.ReplicaTarget(replica), client,
                           closers)
    feed(primary, spans[half:])
    wal.sync()
    drained(follower, wal)
    assert mirror_equal(primary.hot.ensure_sketch_mirror().arrays(),
                        replica.sketch_mirror.arrays())
    status = follower.status()
    assert status["lagRecords"] == 0 and status["role"] == "replica"
    ship_status = shipper.status()
    assert ship_status["followers"]["t1"]["cursor"] >= 1
    # Anchor bootstrap: release the pin, truncate the whole log, and
    # bring up a SECOND replica from nothing — it must adopt the anchor
    # (sketch tier exact from genesis) and resume at the primary's
    # frontier.
    wal.drop_cursor("t1")
    truncated = wal.truncate(wal.last_seq)
    assert truncated >= 1
    c2 = client_of(pkg, port, "t2")
    c2.connect()
    rep2 = pkg.replica()
    closers.append(rep2.close)
    f2 = follower_of(pkg, pkg.R.ReplicaTarget(rep2), c2, closers,
                     start=False)
    assert f2.step() is True  # NEED_ANCHOR -> adopt
    assert rep2.applied_seq() == wal.last_seq
    assert mirror_equal(replica.sketch_mirror.arrays(),
                        rep2.sketch_mirror.arrays())
    assert (rep2.estimated_unique_traces()
            == primary.estimated_unique_traces())
    # Row coverage starts at the anchor: no segments, sketch tier live.
    assert len(rep2.archive) == 0
    for f in ship_status["followers"].values():
        f.pop("shippedBytes")  # the reference counts the same records
    return {"last_seq": wal.last_seq, "truncated": truncated,
            "followers": ship_status["followers"],
            "applied": status["appliedRecords"],
            "anchors": shipper.c_anchors.value,
            "mirror": rep2.sketch_mirror.arrays()}


def _standby_follow_promote(pkg, tmp, closers):
    primary = pkg.new_store()
    wal = pkg.wal(str(tmp / f"sby-{pkg.name}"), fsync="off")
    closers.append(wal.close)
    primary.attach_wal(wal)
    _, port = serve(pkg, pkg.R.WalShipper(primary, registry=pkg.registry()),
                    closers)
    spans = pkg.spans(SPANS[:1600])
    client = client_of(pkg, port, "sby", mode="standby")
    client.connect()
    standby = pkg.new_store()
    follower = follower_of(pkg, pkg.R.StandbyTarget(standby), client,
                           closers)
    feed(primary, spans)
    wal.sync()
    drained(follower, wal)
    assert follower.status()["role"] == "standby"
    promoted = follower.promote()
    assert promoted is standby
    want, got = pkg.leaves(primary.state), pkg.leaves(promoted.state)
    assert_states_equal(want, got, f"{pkg.name} standby")
    if pkg is TORCH:  # CPU twins: bitwise, moments included
        assert state_mismatches(primary.state, promoted.state) == {}
    # The promoted store owns writes now.
    promoted.apply(spans[:32])
    return {"state": pkg.leaves(promoted.state),
            "counters": promoted.counter_block()}


def _standby_ack(pkg, tmp):
    primary = pkg.new_store()
    wal = pkg.wal(str(tmp / f"ack-{pkg.name}"), fsync="off")
    try:
        primary.attach_wal(wal)
        feed(primary, pkg.spans(SPANS[:600]))
        shipper = pkg.R.WalShipper(primary, wal, registry=pkg.registry())
        standby = pkg.new_store()
        target = pkg.R.StandbyTarget(standby)
        # Hand-drive one fetch round the way Follower.step does.
        got = shipper.fetch("sby", target.applied_seq(), 1 << 30,
                            ack=target.ack_seq())
        for seq, payload in got[0]:
            target.apply(seq, payload)
        out = [target.applied_seq(), target.ack_seq()]
        assert out == [wal.last_seq, 0]
        # Applied is ahead, but NOTHING is locally durable yet: the pin
        # (ack) is still 0 and truncation deletes nothing.
        shipper.fetch("sby", target.applied_seq(), 1 << 30,
                      ack=target.ack_seq())
        out.append(wal.truncate(wal.last_seq))
        out.append([s for s, _ in wal.replay(0)][0])
        # A reconnect overlap is skipped.
        out.append(target.apply(*got[0][0]))
        # A successful local checkpoint advances the ack; only then may
        # the covered prefix go.
        target.note_checkpointed(target.applied_seq())
        out.append(target.ack_seq())
        shipper.fetch("sby", target.applied_seq(), 1 << 30,
                      ack=target.ack_seq())
        out.append(wal.truncate(wal.last_seq))
        out.append(shipper.status())
        shipper.close()
        assert out[2:5] == [0, 1, 0] and out[5] == wal.last_seq
        assert out[6] >= 1
        return out
    finally:
        wal.close()


def _cold_resync(pkg, tmp):
    """A standby restored from a PRE-rev-14 checkpoint (no window
    leaves) fed the replicated tail resyncs its mirror from its own
    device leaves, window twins included; its lifetime sketches match
    the uncrashed primary's."""
    cfg = pkg.cfg._replace(window_seconds=60, window_buckets=8)
    primary = pkg.new_store(cfg)
    wal = pkg.wal(str(tmp / f"cold-{pkg.name}" / "wal"), fsync="off")
    try:
        primary.attach_wal(wal)
        spans = pkg.spans(SPANS[:1200])
        feed(primary, spans[:600])
        path = str(tmp / f"cold-{pkg.name}" / "ckpt")
        pkg.checkpoint.save(primary, path)
        feed(primary, spans[600:])  # the replicated tail
        wal.sync()
        # Doctor the snapshot into pre-rev-14 shape (the r13 compat
        # idiom: drop the win_* leaves and the window config keys).
        state_file = os.path.join(path, "state.npz")
        data = dict(np.load(state_file))
        for k in list(data):
            if k.startswith("win_"):
                del data[k]
        np.savez(state_file, **data)
        meta_file = os.path.join(path, "meta.json")
        with open(meta_file) as f:
            meta = json.load(f)
        meta["revision"] = 13
        for k in ("window_seconds", "window_buckets"):
            meta["config"].pop(k, None)
        meta["slab_crc32"] = {
            k: v for k, v in (meta.get("slab_crc32") or {}).items()
            if not k.startswith("win_")}
        with open(meta_file, "w") as f:
            json.dump(meta, f)
        defaults = {"window_seconds": 60, "window_buckets": 8}
        standby = (pkg.checkpoint.load(path, config_defaults=defaults)
                   if pkg is JAX else pkg.checkpoint.load(
                       path, device="cpu", config_defaults=defaults))
        assert standby.config.window_enabled
        assert not standby.sketch_mirror.warm  # restore marked cold
        target = pkg.R.StandbyTarget(standby)
        for seq, payload in wal.replay(int(standby._wal_applied)):
            target.apply(seq, payload)
        assert int(standby._wal_applied) == wal.last_seq
        m = standby.ensure_sketch_mirror().arrays()
        assert mirror_equal(device_mirror(pkg, standby), m)
        oracle = primary.ensure_sketch_mirror().arrays()
        assert mirror_equal(oracle[:6], m[:6])
        return {"mirror": m, "state": pkg.leaves(standby.state)}
    finally:
        wal.close()


def _same_state(want, got, where):
    """A JAX state's leaves against the port's: integer leaves bitwise,
    the float32 moments within stated tolerance 2."""
    assert_states_equal({k: np.asarray(v) if k != "counters" else v
                         for k, v in want.items()}, got, where)


def test_port_tcp_follow_and_anchor_bootstrap(tmp_path, closers):
    got = _tcp_follow_and_anchor(TORCH, tmp_path, closers)
    want = _tcp_follow_and_anchor(JAX, tmp_path, closers)
    assert mirror_equal(got.pop("mirror"), want.pop("mirror"))
    assert got == want


def test_port_standby_follow_promote(tmp_path, closers):
    got = _standby_follow_promote(TORCH, tmp_path, closers)
    want = _standby_follow_promote(JAX, tmp_path, closers)
    assert got["counters"] == want["counters"]
    _same_state(want["state"], got["state"], "promoted standby")


def test_port_standby_acks_checkpoint_frontier(tmp_path):
    assert _standby_ack(TORCH, tmp_path) == _standby_ack(JAX, tmp_path)


def test_port_cold_resync_from_pre_rev14_checkpoint(tmp_path):
    got = _cold_resync(TORCH, tmp_path)
    want = _cold_resync(JAX, tmp_path)
    assert mirror_equal(got["mirror"], want["mirror"])
    _same_state(want["state"], got["state"], "resynced standby")


# ---------------------------------------------------------------------------
# (c) Across the wire, both ways
# ---------------------------------------------------------------------------


def _primary_with_server(pkg, tmp, closers, tiered=False):
    store = pkg.new_store()
    if tiered:
        store = pkg.tiered(store)
    wal = pkg.wal(str(tmp / f"x-{pkg.name}"), fsync="off")
    closers.append(wal.close)
    store.attach_wal(wal)
    shipper = pkg.R.WalShipper(store, registry=pkg.registry())
    _, port = serve(pkg, shipper, closers)
    return store, wal, shipper, port


def test_port_standby_follows_reference_primary(tmp_path, closers):
    """A port standby (device cpu) follows a JAX primary's ship server:
    HELLO's config crosses into the port's StoreConfig, and the drained
    standby's state equals the JAX primary's."""
    ref, wal, _, port = _primary_with_server(JAX, tmp_path, closers)
    feed(ref, SPANS[:640])
    client = client_of(TORCH, port, "port-standby", mode="standby")
    hello = client.connect()
    standby = _port_store(P.config_from_dict(hello["config"]))
    assert standby.config == PCFG
    follower = follower_of(TORCH, replicate.StandbyTarget(standby), client,
                           closers)
    feed(ref, SPANS[640:1600])
    wal.sync()
    drained(follower, wal)
    assert follower.status()["appliedSeq"] == wal.last_seq
    _same_state(jax_leaves(ref.state), state_to_numpy(standby.state),
                "port standby of a JAX primary")
    assert standby.counter_block() == ref.counter_block()
    tids = sorted({s.trace_id for s in SPANS[:1600:41]})
    assert standby.get_spans_by_trace_ids(tids) == _convert(
        ref.get_spans_by_trace_ids(tids), PORT)


def test_reference_replica_follows_port_primary(tmp_path, closers):
    """A JAX-package replica follows a port primary's ship server; its
    mirror equals the port primary's device aggregates."""
    primary, wal, shipper, port = _primary_with_server(TORCH, tmp_path,
                                                       closers, tiered=True)
    feed(primary, TORCH.spans(SPANS[:640]))
    client = client_of(JAX, port, "ref-replica")
    hello = client.connect()
    assert RP.config_from_dict(hello["config"]) == RCFG
    replica = JAX.replica()
    closers.append(replica.close)
    follower = follower_of(JAX, ref_replicate.ReplicaTarget(replica), client,
                           closers)
    feed(primary, TORCH.spans(SPANS[640:1600]))
    wal.sync()
    drained(follower, wal)
    assert mirror_equal(device_mirror(TORCH, primary.hot),
                        replica.sketch_mirror.arrays())
    tids = sorted({s.trace_id for s in SPANS[:1600:41]})
    assert _convert(replica.get_spans_by_trace_ids(tids), PORT) == \
        primary.get_spans_by_trace_ids(tids)
    assert shipper.status()["followers"]["ref-replica"]["lagRecords"] == 0


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_anchor_crosses_between_packages(tmp_path, closers, direction):
    """A replica whose cursor precedes the primary's retained log gets
    NEED_ANCHOR from the other package's server and bootstraps from its
    anchor: its mirror equals the primary's device aggregates, and it
    then follows the live tail."""
    serve_pkg, follow_pkg = ((TORCH, JAX) if direction == "port_to_reference"
                             else (JAX, TORCH))
    primary, wal, _, port = _primary_with_server(serve_pkg, tmp_path,
                                                 closers)
    spans = serve_pkg.spans(SPANS[:1600])
    feed(primary, spans[:1024])
    assert wal.truncate(wal.last_seq) >= 1
    client = client_of(follow_pkg, port, "late")
    client.connect()
    replica = follow_pkg.replica()
    closers.append(replica.close)
    follower = follower_of(follow_pkg, follow_pkg.R.ReplicaTarget(replica),
                           client, closers, start=False)
    assert follower.step() is True  # NEED_ANCHOR -> adopt
    assert replica.applied_seq() == wal.last_seq
    assert mirror_equal(device_mirror(serve_pkg, primary),
                        replica.sketch_mirror.arrays())
    feed(primary, spans[1024:])
    wal.sync()
    while follower.step():
        pass
    assert replica.applied_seq() == wal.last_seq
    assert mirror_equal(device_mirror(serve_pkg, primary),
                        replica.sketch_mirror.arrays())
    assert replica.estimated_unique_traces() == pytest.approx(
        primary.estimated_unique_traces(), rel=1e-5)


# ---------------------------------------------------------------------------
# (e) The daemon: --ship-port and --follow, as functions
# ---------------------------------------------------------------------------

SELF = "zipkin-tpu"
KNOWN = generate_traces(n_traces=12, max_depth=3, n_services=6,
                        rng=np.random.default_rng(31))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _primary_flags(tmp, ship_port):
    return ["--platform", "cpu", "--capacity", "4096", "--host",
            "127.0.0.1", "--port", "0", "--scribe-port", "0",
            "--wal-dir", str(tmp / "wal"), "--ship-port", str(ship_port)]


def _follower_flags(ship_port, mode, extra=()):
    return ["--platform", "cpu", "--host", "127.0.0.1", "--port", "0",
            "--follow", f"127.0.0.1:{ship_port}", "--follow-mode", mode,
            "--follower-name", f"{mode}-test", "--follow-poll-ms", "5",
            *extra]


def _follower_reads(api):
    """What the comparisons read through ``api.handle``: each known
    trace, a by-service query for each known service, and the catalog,
    less the daemon's own self-trace service."""
    from zipkin_tpu_torch.ingest.receiver import _hex_id

    out = {}
    for t in KNOWN:
        tid = _hex_id(t[0].trace_id)
        out[f"trace {tid}"] = api.handle("GET", f"/api/trace/{tid}", {})
    svcs = sorted({n for t in KNOWN for s in t for n in s.service_names})
    for svc in svcs:
        out[f"query {svc}"] = api.handle("GET", "/api/query", {
            "serviceName": svc, "endTs": str(END_TS), "limit": "10"})
    status, names = api.handle("GET", "/api/services", {})
    out["services"] = (status, sorted(n for n in names if n != SELF))
    return json.loads(json.dumps(out))


def _wait_current(follower, shipper_status, what):
    """Poll until the follower has applied the primary's durable
    frontier and reads zero lag (lineage records may still land)."""
    deadline = time.monotonic() + DRAIN_S
    while time.monotonic() < deadline:
        assert follower.drain(DRAIN_S), follower.status()
        st = follower.status()
        if (st["lagRecords"] == 0
                and st["appliedSeq"] >= shipper_status()["durableSeq"]):
            return st
    raise AssertionError(f"{what}: still lagging {follower.status()}")


def _run_daemons(ex, tmp, mode, closers, port_side):
    """A primary daemon with ``--ship-port`` and a follower daemon of
    ``mode`` built through ``ex`` (either package's ``main/example``),
    the known traces acked through the primary's durable ingest; returns
    (primary api, follower api, follower, shipper)."""
    ship_port = _free_port()
    args = ex.build_parser().parse_args(_primary_flags(tmp, ship_port))
    store, collector, api, shipper = ex.build_app(args)
    api.tracer.sample_rate = 0.0
    closers.append(store.wal.close)
    closers.append(api.query.close)
    closers.append(collector.close)
    closers.append(shipper.close)
    assert shipper is not None and shipper.store is store
    if port_side:
        servers = ex.start_servers(args, store, collector, api, shipper)
        closers.append(lambda: [(s.shutdown(), s.server_close())
                                for s in servers if s is not None])
        ship_srv = servers[2]
    else:
        ship_srv = ref_replicate.ShipServer(shipper, "127.0.0.1", ship_port)
        ship_srv.serve_in_thread()
        closers.append(lambda: (ship_srv.shutdown(), ship_srv.server_close()))
    assert ship_srv.server_address[1] == ship_port
    fargs = ex.build_parser().parse_args(_follower_flags(ship_port, mode))
    fstore, follower, fapi = ex.build_follower_app(fargs)
    closers.append(fstore.close)
    closers.append(fapi.query.close)
    closers.append(follower.close)
    assert fapi.tracer is None  # no collector: no self-traced requests
    base = None
    if port_side:
        server = ex.start_follower(fargs, follower, fapi)
        closers.append(lambda: (server.shutdown(), server.server_close()))
        base = f"http://127.0.0.1:{server.server_address[1]}"
    else:
        follower.start()
    spans = [s for t in KNOWN for s in t]
    collector.ingest_durable(TORCH.spans(spans) if port_side else spans)
    collector.flush()
    _wait_current(follower, shipper.status, f"{mode} follower")
    return api, fapi, follower, shipper, fstore, base


@pytest.fixture(scope="module")
def reference_followers(tmp_path_factory):
    """The reference daemon's primary and a follower of each mode, built
    by ``zipkin_tpu/main/example.py`` the same way: their reads and
    ``/api/replication`` documents."""
    from zipkin_tpu.main import example as ref_example

    out = {}
    for mode in ("replica", "standby"):
        tmp = tmp_path_factory.mktemp(f"ref-{mode}")
        closers = []
        try:
            api, fapi, follower, shipper, _, _ = _run_daemons(
                ref_example, tmp, mode, closers, port_side=False)
            out[mode] = {"primary": _follower_reads(api),
                         "follower": _follower_reads(fapi),
                         "replication": fapi.handle(
                             "GET", "/api/replication", {})[1],
                         "shipper": shipper.status()}
        finally:
            for fn in reversed(closers):
                fn()
    return out


def _comparable_status(st):
    """A follower's ``/api/replication`` less what differs by run: the
    primary's address, byte counts (records carry commit timestamps)
    and the seconds of lag."""
    return {k: v for k, v in st.items()
            if k not in ("primary", "fetchedBytes", "lagSeconds")}


@pytest.mark.parametrize("mode", ["replica", "standby"])
def test_port_daemon_ships_to_a_follower_daemon(tmp_path, closers, mode,
                                                reference_followers):
    from zipkin_tpu_torch.main import example

    api, fapi, follower, shipper, fstore, base = _run_daemons(
        example, tmp_path, mode, closers, port_side=True)
    want = reference_followers[mode]
    if mode == "standby":
        assert isinstance(fstore, TorchSpanStore)
        assert fstore.device.type == "cpu"
    else:
        assert isinstance(fstore, ReplicaSpanStore)
    # The wiring: the shipper behind /api/replication and the fleet's
    # federation, the follower-lag probe on both sides.
    assert api.replication == shipper.status
    assert api.fleet.replication == shipper.status
    assert api.fleet.remote_sources == shipper.fleet_sources
    assert "follower_lag" in [n for n, _ in api.fleet.watchdog._probes]
    assert [n for n, _ in fapi.fleet.watchdog._probes] == [
        "replication_lag"]
    assert fapi.fleet.follower is follower.lineage
    status, doc = fapi.handle("GET", "/api/replication", {})
    assert status == 200 and doc["role"] == mode and doc["lagRecords"] == 0
    assert _comparable_status(doc)["appliedSeq"] >= 1
    got = _follower_reads(fapi)
    assert all(status == 200 for status, _ in got.values())
    assert all(body for k, (_, body) in got.items()
               if k.startswith("trace"))
    assert any(body["traceIds"] for k, (_, body) in got.items()
               if k.startswith("query"))
    assert got == _follower_reads(api)
    assert got == want["follower"] == want["primary"]
    assert {k: v for k, v in _comparable_status(doc).items()
            if k not in ("appliedSeq", "primaryDurableSeq",
                         "appliedRecords")} == {
        k: v for k, v in _comparable_status(want["replication"]).items()
        if k not in ("appliedSeq", "primaryDurableSeq", "appliedRecords")}
    st = shipper.status()
    assert st["role"] == "primary" and f"{mode}-test" in st["followers"]
    assert st["followers"][f"{mode}-test"]["mode"] == mode
    assert st["followers"][f"{mode}-test"]["lagRecords"] == 0
    # The follower's read API over its own socket.
    with urllib.request.urlopen(base + "/api/replication",
                                timeout=IO_S) as r:
        assert r.status == 200
        assert json.loads(r.read())["role"] == mode


def test_port_follower_loop_checkpoints_and_shuts_down(tmp_path, closers):
    """The follower daemon's serving loop and ordered shutdown, called as
    functions: a standby with ``--checkpoint`` saves on its cadence and
    only then acks its frontier to the primary; a stop ends the loop;
    the shutdown closes the read API, stops the follower, saves a final
    snapshot the applied frontier restores from, and closes the store.
    The primary's ordered shutdown then closes its ship endpoint and
    unregisters the shipper's metrics."""
    from zipkin_tpu_torch.main import example

    ship_port = _free_port()
    args = example.build_parser().parse_args(
        _primary_flags(tmp_path, ship_port))
    store, collector, api, shipper = example.build_app(args)
    api.tracer.sample_rate = 0.0
    closers.append(store.wal.close)
    closers.append(api.query.close)
    closers.append(collector.close)
    servers = example.start_servers(args, store, collector, api, shipper)
    closers.append(lambda: [(s.shutdown(), s.server_close())
                            for s in servers if s is not None])
    ckpt = str(tmp_path / "standby-ckpt")
    fargs = example.build_parser().parse_args(_follower_flags(
        ship_port, "standby", ["--checkpoint", ckpt,
                               "--checkpoint-interval", "0"]))
    fstore, follower, fapi = example.build_follower_app(fargs)
    closers.append(fstore.close)
    closers.append(fapi.query.close)
    closers.append(follower.close)
    server = example.start_follower(fargs, follower, fapi)
    closers.append(lambda: (server.shutdown(), server.server_close()))
    stop = threading.Event()
    loop = threading.Thread(target=example.follow_until,
                            args=(stop, fargs, fstore, follower),
                            daemon=True)
    loop.start()
    try:
        collector.ingest_durable(TORCH.spans([s for t in KNOWN for s in t]))
        collector.flush()
        applied = _wait_current(follower, shipper.status,
                                "standby")["appliedSeq"]
        # The ack moves only after a checkpoint covers the frontier.
        deadline = time.monotonic() + DRAIN_S
        while (shipper.status()["followers"]["standby-test"]["ackSeq"]
               < applied and time.monotonic() < deadline):
            time.sleep(0.05)
        assert shipper.status()["followers"]["standby-test"][
            "ackSeq"] >= applied
        assert checkpoint.exists(ckpt)
    finally:
        stop.set()
        loop.join(timeout=DRAIN_S)
    assert not loop.is_alive()
    example.follower_shutdown(fargs, fstore, follower, fapi, server)
    assert follower._thread is None
    with pytest.raises(OSError):
        socket.create_connection(server.server_address, timeout=1.0)
    reloaded = checkpoint.load(ckpt, device="cpu")
    assert int(reloaded._wal_applied) == follower.target.applied_seq()
    assert reloaded.get_spans_by_trace_ids([KNOWN[0][0].trace_id]) == \
        fstore.get_spans_by_trace_ids([KNOWN[0][0].trace_id])
    # The primary's ordered shutdown closes the ship endpoint too.
    example.shutdown(args, store, collector, api, servers, shipper)
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", ship_port), timeout=1.0)
    assert obs.default_registry().get(
        "zipkin_replication_shipped_records_total") is not shipper.c_records


def test_port_standby_daemon_is_on_the_card_or_raises(tmp_path, closers):
    """A standby asked for no ``--platform`` builds its store on the
    card, and raises (closing its connection) where there is none: no
    fallback to the CPU."""
    from zipkin_tpu_torch.main import example

    _, _, _, port = _primary_with_server(TORCH, tmp_path, closers)
    argv = _follower_flags(port, "standby")
    argv = argv[argv.index("--host"):]  # no --platform
    fargs = example.build_parser().parse_args(argv)
    assert fargs.platform is None
    if torch.cuda.is_available():
        fstore, follower, fapi = example.build_follower_app(fargs)
        closers.append(follower.close)
        closers.append(fapi.query.close)
        assert fstore.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            example.build_follower_app(fargs)


def test_port_follower_loop_ends_when_a_standby_needs_an_anchor(
        tmp_path, closers, capsys):
    """A standby cannot bootstrap from a sketch anchor (the reference's
    refusal): once the primary's log no longer holds its cursor, the
    follower parks the lineage error and stops, and the serving loop
    sees the stopped thread and returns."""
    from zipkin_tpu_torch.main import example

    primary, wal, _, port = _primary_with_server(TORCH, tmp_path, closers)
    feed(primary, TORCH.spans(SPANS[:256]))
    assert wal.truncate(wal.last_seq) >= 1
    fargs = example.build_parser().parse_args(_follower_flags(port,
                                                              "standby"))
    fstore, follower, fapi = example.build_follower_app(fargs)
    closers.append(fstore.close)
    closers.append(fapi.query.close)
    closers.append(follower.close)
    assert fstore.config == PCFG and fstore.device.type == "cpu"
    follower.start()
    stop = threading.Event()
    loop = threading.Thread(target=example.follow_until,
                            args=(stop, fargs, fstore, follower),
                            daemon=True)
    loop.start()
    loop.join(timeout=DRAIN_S)
    stop.set()
    assert not loop.is_alive()
    assert isinstance(follower.error(), WalReplayError)
    assert "cannot bootstrap from a sketch anchor" in str(follower.error())
    assert "follower stopped: WalReplayError" in capsys.readouterr().out
    assert fstore.counter_block()["batches"] == 0


# ---------------------------------------------------------------------------
# Slow lane: the reference's TestCrashDuringShip and TestLiveFleetTrace
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestPortCrashDuringShip:
    def test_port_follower_reconnects_across_server_restart(self, tmp_path,
                                                            closers):
        """The ship endpoint dies mid-stream; the follower backs off,
        reconnects when it returns on the same port, and converges
        bitwise with nothing skipped."""
        primary = _port_store()
        wal = TORCH.wal(str(tmp_path / "wal"), fsync="off")
        closers.append(wal.close)
        primary.attach_wal(wal)
        shipper = replicate.WalShipper(primary, registry=obs.Registry())
        server = replicate.ShipServer(shipper, host="127.0.0.1", port=0)
        port = server.server_address[1]
        server.serve_in_thread()
        spans = TORCH.spans(SPANS[:2000])
        replica = TORCH.replica()
        closers.append(replica.close)
        follower = follower_of(TORCH, replicate.ReplicaTarget(replica),
                               client_of(TORCH, port, "rc"), closers)
        try:
            feed(primary, spans[:768])
            deadline = time.monotonic() + 30
            while (replica.applied_seq() == 0
                    and time.monotonic() < deadline):
                time.sleep(0.005)
            assert replica.applied_seq() > 0
            server.shutdown()
            server.server_close()
            feed(primary, spans[768:1408])
            server = replicate.ShipServer(shipper, host="127.0.0.1",
                                          port=port)
            server.serve_in_thread()
            feed(primary, spans[1408:])
            wal.sync()
            drained(follower, wal)
            assert mirror_equal(primary.ensure_sketch_mirror().arrays(),
                                replica.sketch_mirror.arrays())
        finally:
            server.shutdown()
            server.server_close()

    def test_port_primary_crash_recovery_resumes_ship(self, tmp_path,
                                                      closers):
        """The primary dies and recovers from its own WAL; the replica's
        cursor stays valid and it converges with the RECOVERED primary
        bitwise."""
        from zipkin_tpu_torch.wal import recover

        wal_dir = str(tmp_path / "wal")
        primary = _port_store()
        wal = TORCH.wal(wal_dir, fsync="off")
        primary.attach_wal(wal)
        spans = TORCH.spans(SPANS[:1600])
        feed(primary, spans[:768])
        replica = TORCH.replica()
        closers.append(replica.close)
        for seq, payload in wal.replay(0):
            replica.apply_record(seq, payload)
        cursor = replica.applied_seq()
        wal.close()
        del primary
        wal2 = TORCH.wal(wal_dir, fsync="off")
        closers.append(wal2.close)
        recovered, stats = recover(None, wal2, fresh_store=lambda d: (
            _port_store()), device="cpu")
        assert stats["replayed_records"] >= 1
        feed(recovered, spans[768:])
        wal2.sync()
        for seq, payload in wal2.replay(cursor):
            replica.apply_record(seq, payload)
        assert mirror_equal(recovered.ensure_sketch_mirror().arrays(),
                            replica.sketch_mirror.arrays())
        assert replica.applied_seq() == wal2.last_seq

    def test_port_truncation_never_outruns_pinned_follower(self, tmp_path,
                                                           closers):
        """Checkpoint-style truncation after every batch races the
        follower's fetches: the cursor pin means no record is skipped."""
        primary = _port_store()
        wal = TORCH.wal(str(tmp_path / "wal"), fsync="off")
        closers.append(wal.close)
        primary.attach_wal(wal)
        _, port = serve(TORCH, replicate.WalShipper(
            primary, registry=obs.Registry()), closers)
        replica = TORCH.replica()
        closers.append(replica.close)
        follower = follower_of(TORCH, replicate.ReplicaTarget(replica),
                               client_of(TORCH, port, "pin"), closers)
        spans = TORCH.spans(SPANS[:2000])
        for i in range(0, len(spans), 128):
            primary.apply(spans[i:i + 128])
            wal.truncate(int(primary._wal_applied))
        wal.sync()
        drained(follower, wal)
        assert replica.applied_seq() == wal.last_seq
        assert mirror_equal(primary.ensure_sketch_mirror().arrays(),
                            replica.sketch_mirror.arrays())


@pytest.mark.slow
class TestPortLiveFleetTrace:
    def test_port_ship_pair_single_trace(self, tmp_path, closers):
        """A primary + follower pair under ingest produces ONE causally
        linked trace spanning encode → WAL append → fsync → ship →
        follower apply, queryable from the primary's own store."""
        from zipkin_tpu_torch.obs import FleetObs, FollowerLineage
        from zipkin_tpu_torch.obs import LineageTracker

        cfg = PCFG._replace(capacity=1 << 9, ann_capacity=1 << 11,
                            bann_capacity=1 << 10)
        reg = obs.Registry()
        primary = _port_store(cfg)
        wal = TORCH.wal(str(tmp_path / "wal"), fsync="off")
        closers.append(wal.close)
        primary.attach_wal(wal)
        tracker = LineageTracker(primary.apply, registry=reg,
                                 sample_every=1)
        primary.attach_lineage(tracker)
        shipper = replicate.WalShipper(primary, registry=reg,
                                       tracker=tracker)
        _, port = serve(TORCH, shipper, closers)
        freg = obs.Registry()
        replica = ReplicaSpanStore(cfg, background_compaction=False,
                                   registry=obs.Registry())
        closers.append(replica.close)
        flin = FollowerLineage("r1", mode="replica", registry=freg)
        follower = replicate.Follower(
            replicate.ReplicaTarget(replica), client_of(TORCH, port, "r1"),
            registry=freg, lineage=flin)
        closers.append(follower.close)
        spans = TORCH.spans([s for t in generate_traces(
            n_traces=20, max_depth=3, n_services=4,
            rng=np.random.default_rng(8)) for s in t][:100])
        primary.apply(spans)
        wal.sync()
        deadline = time.monotonic() + 30.0
        while (replica.applied_seq() < wal.last_seq
               and time.monotonic() < deadline):
            follower.step()
        assert replica.applied_seq() >= wal.last_seq
        follower.step()  # backhauls the buffered apply spans
        tracker.flush()
        wal.sync()
        found = primary.get_trace_ids_by_name("zipkin-tpu", None, END_TS,
                                              50)
        assert found, "no lineage trace recorded"
        want = {"ingest unit", "wal append", "wal fsync", "ship",
                "replica apply"}
        complete = None
        for itid in found:
            trace = primary.get_spans_by_trace_ids([itid.trace_id])[0]
            if want <= {s.name for s in trace}:
                complete = trace
                break
        assert complete is not None, "no trace spans the full pipeline"
        root = next(s for s in complete
                    if s.name == "ingest unit" and s.parent_id is None)
        for s in complete:
            if s.name in want - {"ingest unit"}:
                assert s.parent_id == root.id, s.name
                assert s.trace_id == root.trace_id
        applied = next(s for s in complete if s.name == "replica apply")
        assert (applied.annotations[0].host.service_name
                == "zipkin-tpu-r1")
        assert flin.lag_seconds() is not None
        assert freg.get("zipkin_replication_lag_seconds").value >= 0.0
        fleet = FleetObs(role="primary", registry=reg, tracker=tracker,
                         remote_sources=shipper.fleet_sources,
                         replication=shipper.status)
        text = fleet.federated_text()
        assert 'role="primary"' in text and 'follower="r1"' in text
        assert len(fleet.status()["processes"]) == 2
