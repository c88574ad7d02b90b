"""The port's fleet observability (``zipkin_tpu_torch/obs/fleet.py``)
and WAL lineage (``TorchSpanStore.attach_lineage``) against the JAX
package's, on the CPU.

The first half ports ``tests/test_fleet.py`` onto the port: the wire
codec, the lineage tracker, the follower half, federation, the flight
recorder, the watchdog and the API's fleet routes. The four reference
cases that need the dispatcher or the ship protocol
(``TestDispatcherSpanSink``, ``TestLiveFleetTrace``) wait for those
slices.

The second half holds the port against the reference with pinned clocks
and seeded id generators: tracker span lists, the follower's backhauled
spans and lag, registry snapshots and federated text, merged sketch
states, watchdog and recorder output, the probes, the API answers, and
a store drive at ``sample_every=1`` with a small ``FLUSH_AT`` whose WAL
must equal the reference store's byte for byte, for ``fsync`` off and
interval. Each package's ``recover`` of the port's log must give the
live store's state.

Threads (WAL group commit, pipeline, sealer, server) are closed in
fixture finalizers; every join and socket call has a timeout.
"""

import json
import os
import random
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_store import (  # noqa: E402
    PORT,
    _convert,
    assert_states_equal,
    jax_leaves,
)
from zipkin_tpu import obs as ref_obs  # noqa: E402
from zipkin_tpu.api import ApiServer as RefApiServer  # noqa: E402
from zipkin_tpu.ingest.collector import Collector as RefCollector  # noqa: E402
from zipkin_tpu.obs import fleet as ref_fleet  # noqa: E402
from zipkin_tpu.query.service import QueryService as RefQueryService  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.memory import InMemorySpanStore as RefMemory  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu.testing import crash as ref_crash  # noqa: E402
from zipkin_tpu.wal import WriteAheadLog as RefWal  # noqa: E402
from zipkin_tpu.wal import recover as ref_recover  # noqa: E402
from zipkin_tpu.wal import record as ref_record  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.api import server as port_server  # noqa: E402
from zipkin_tpu_torch.api.server import ApiServer  # noqa: E402
from zipkin_tpu_torch.ingest.collector import Collector  # noqa: E402
from zipkin_tpu_torch.obs import fleet as fobs  # noqa: E402
from zipkin_tpu_torch.obs.fleet import (  # noqa: E402
    FleetObs,
    FlightRecorder,
    FollowerLineage,
    LineageTracker,
    Watchdog,
    merge_sketches,
    registry_snapshot,
    render_federated,
    span_from_wire,
    span_to_wire,
)
from zipkin_tpu_torch.query.service import QueryService  # noqa: E402
from zipkin_tpu_torch.store.convert import state_to_numpy  # noqa: E402
from zipkin_tpu_torch.store.memory import InMemorySpanStore  # noqa: E402
from zipkin_tpu_torch.store.pipeline import EvictionSealer  # noqa: E402
from zipkin_tpu_torch.testing.crash import (  # noqa: E402
    build_crash_store,
    crash_batches,
    state_mismatches,
)
from zipkin_tpu_torch.wal import WriteAheadLog, recover  # noqa: E402
from zipkin_tpu_torch.wal import record as walrec  # noqa: E402

T0 = 1_700_000_000.0  # pinned clocks start here (seconds)


def _drain_spans():
    """A sink that collects flushed span batches."""
    got = []

    def sink(spans):
        got.extend(spans)

    return got, sink


# ---------------------------------------------------------------------------
# The reference cases on the port (tests/test_fleet.py)
# ---------------------------------------------------------------------------


class TestWireCodec:
    def test_roundtrip(self):
        w = span_to_wire(7, 9, 3, "wal append", "zipkin-tpu",
                         1_000_000, 42, {"seq": "5"})
        s = span_from_wire(w)
        assert s.trace_id == 7 and s.id == 9 and s.parent_id == 3
        assert s.name == "wal append"
        assert s.annotations[0].host.service_name == "zipkin-tpu"
        assert s.annotations[1].timestamp - s.annotations[0].timestamp == 42
        assert dict((b.key, b.value) for b in s.binary_annotations) == {
            "seq": "5"}

    def test_root_parent_none(self):
        s = span_from_wire(span_to_wire(1, 2, None, "r", "svc", 10, 1))
        assert s.parent_id is None


class TestLineageTracker:
    def test_stamp_sampling_cadence(self):
        got, sink = _drain_spans()
        t = LineageTracker(sink, sample_every=4)
        extras = [t.stamp() for _ in range(8)]
        assert all("ts" in e for e in extras)
        sampled = [i for i, e in enumerate(extras) if "b3" in e]
        assert sampled == [0, 4]  # first unit always traced

    def test_unit_spans_causally_linked(self):
        got, sink = _drain_spans()
        t = LineageTracker(sink, sample_every=1)
        extra = t.stamp()
        t.note_append(3, extra)
        t.on_durable(3)
        t.note_shipped(3, "r1")
        t.flush()
        by_name = {s.name: s for s in got}
        assert set(by_name) == {"ingest unit", "wal append", "wal fsync",
                                "ship"}
        root = by_name["ingest unit"]
        tid, sid = extra["b3"]
        assert root.trace_id == tid and root.id == sid
        assert root.parent_id is None
        for name in ("wal append", "wal fsync", "ship"):
            child = by_name[name]
            assert child.trace_id == tid
            assert child.parent_id == sid
            assert child.id != sid

    def test_remote_spans_join_same_trace(self):
        got, sink = _drain_spans()
        t = LineageTracker(sink, sample_every=1)
        extra = t.stamp()
        t.note_append(1, extra)
        tid, sid = extra["b3"]
        t.ingest_remote_spans("r1", [
            span_to_wire(tid, 12345, sid, "replica apply",
                         "zipkin-tpu-r1", 50, 7),
            {"broken": True},  # malformed entries drop, not raise
        ])
        t.flush()
        applied = [s for s in got if s.name == "replica apply"]
        assert len(applied) == 1
        assert applied[0].trace_id == tid and applied[0].parent_id == sid

    def test_suppressed_blocks_reentrant_flush(self):
        flushed = []

        def sink(spans):
            flushed.append(list(spans))

        t = LineageTracker(sink, sample_every=1)
        for seq in range(t.FLUSH_AT + 1):
            t.note_append(seq, t.stamp())
        with t.suppressed():
            t.flush()
            assert not flushed  # suppressed: nothing may emit
        t.flush()
        assert flushed and not t._buf

    def test_sink_failure_counts_drops_not_raises(self):
        reg = obs.Registry()

        def bad_sink(spans):
            raise RuntimeError("store down")

        t = LineageTracker(bad_sink, registry=reg, sample_every=1)
        t.note_append(1, t.stamp())
        t.flush()  # must not raise
        assert reg.get("zipkin_lineage_spans_dropped_total").value > 0

    def test_stage_sketch_observes(self):
        reg = obs.Registry()
        got, sink = _drain_spans()
        t = LineageTracker(sink, registry=reg, sample_every=1)
        t.note_append(1, t.stamp())
        t.on_durable(1)
        sk = reg.get("zipkin_lineage_stage_seconds")
        stages = {labels[0][1]
                  for _suffix, labels, _v in sk.samples()
                  if labels and labels[0][0] == "stage"}
        assert {"append", "fsync"} <= stages

    def test_pending_bounded(self):
        got, sink = _drain_spans()
        t = LineageTracker(sink, sample_every=1)
        for seq in range(t.MAX_PENDING + 64):
            t.note_append(seq, t.stamp())
        assert len(t._pending) <= t.MAX_PENDING


class TestFollowerLineage:
    def _record(self, tracker):
        """One stamped WAL-style payload via the real encoder (an empty
        launch group still carries the full json header)."""
        extra = tracker.stamp()
        return walrec.encode_unit([], [], {}, extra=extra), extra

    def test_lag_and_apply_span_backhaul(self):
        got, sink = _drain_spans()
        t = LineageTracker(sink, sample_every=1)
        payload, extra = self._record(t)
        f = FollowerLineage("r1", mode="replica")
        f.observe_record(9, payload, apply_s=0.002)
        lag = f.lag_seconds()
        assert lag is not None and 0 <= lag < 60
        spans = f.take_spans()
        assert len(spans) == 1
        w = spans[0]
        tid, sid = extra["b3"]
        assert w["traceId"] == tid and w["parentId"] == sid
        assert w["name"] == "replica apply"
        assert w["service"] == "zipkin-tpu-r1"
        assert f.take_spans() == []  # drained

    def test_unstamped_record_harmless(self):
        f = FollowerLineage("r1")
        f.observe_record(1, walrec.encode_unit([], [], {}), apply_s=0.001)
        assert f.lag_seconds() is None
        assert f.take_spans() == []

    def test_backlog_bounded(self):
        got, sink = _drain_spans()
        t = LineageTracker(sink, sample_every=1)
        f = FollowerLineage("r1")
        for seq in range(f.MAX_BACKLOG + 32):
            payload, _ = self._record(t)
            f.observe_record(seq, payload, apply_s=0.001)
        assert len(f.take_spans()) <= f.MAX_BACKLOG

    def test_metrics_snapshot_throttled(self):
        reg = obs.Registry()
        reg.register(obs.Counter("x_total", "h")).inc()
        now = [1000.0]
        f = FollowerLineage("r1", registry=reg, clock=lambda: now[0])
        snap = f.maybe_metrics_snapshot()
        assert snap is not None and snap["v"] == 1
        assert f.maybe_metrics_snapshot() is None  # within interval
        now[0] += f.METRICS_PUSH_INTERVAL_S + 0.1
        assert f.maybe_metrics_snapshot() is not None

    def test_lag_gauge_registered(self):
        reg = obs.Registry()
        f = FollowerLineage("r1", registry=reg)
        assert reg.get("zipkin_replication_lag_seconds").value == 0.0
        got, sink = _drain_spans()
        t = LineageTracker(sink, sample_every=1)
        payload, _ = self._record(t)
        f.observe_record(1, payload, apply_s=0.001)
        assert reg.get("zipkin_replication_lag_seconds").value >= 0.0


class TestFederation:
    def _registry(self, counter=3.0, sketch_vals=(0.01, 0.02)):
        reg = obs.Registry()
        reg.register(obs.Counter("f_req_total", "requests")).inc(counter)
        sk = reg.register(obs.LatencySketch("f_lat_seconds", "latency"))
        for v in sketch_vals:
            sk.observe(v)
        return reg

    def test_single_source_bitwise_vs_own_scrape(self):
        """A federated render of one process's snapshot differs from its
        own scrape ONLY by the injected labels: every value formats
        identically (same _fmt path)."""
        reg = self._registry()
        own = reg.render_text()
        fed = render_federated(
            [((("role", "primary"),), registry_snapshot(reg))])
        own_vals = sorted(line.rsplit(" ", 1)[1]
                          for line in own.splitlines()
                          if line and not line.startswith("#"))
        fed_vals = sorted(line.rsplit(" ", 1)[1]
                          for line in fed.splitlines()
                          if line and not line.startswith("#"))
        assert own_vals == fed_vals

    def test_merged_scrape_no_double_counting(self):
        a = self._registry(counter=3.0)
        b = self._registry(counter=5.0)
        fed = render_federated([
            ((("role", "primary"),), registry_snapshot(a)),
            ((("role", "follower"), ("follower", "r1")),
             registry_snapshot(b)),
        ])
        rows = [r for r in fed.splitlines() if r.startswith("f_req_total")]
        assert len(rows) == 2
        assert any('role="primary"' in r and r.endswith(" 3")
                   for r in rows)
        assert any('follower="r1"' in r and r.endswith(" 5")
                   for r in rows)

    def test_sketch_monoid_merge(self):
        a = obs.LatencySketch("m_seconds", "h")
        b = obs.LatencySketch("m_seconds", "h")
        both = obs.LatencySketch("m_seconds", "h")
        for v in (0.001, 0.01, 0.1):
            a.observe(v)
            both.observe(v)
        for v in (0.2, 0.4):
            b.observe(v)
            both.observe(v)
        merged = merge_sketches("m_seconds", "h", [
            fobs._sketch_state(a), fobs._sketch_state(b)])
        assert np.array_equal(merged.counts, both.counts)
        assert merged.moments.n == both.moments.n
        assert list(merged.samples()) == list(both.samples())

    def test_fleet_status_rolls_up(self):
        reg_a = obs.Registry()
        sk = reg_a.register(obs.LatencySketch(
            "zipkin_replication_visible_lag_seconds", "lag"))
        sk.observe(0.01)
        reg_b = obs.Registry()
        sk2 = reg_b.register(obs.LatencySketch(
            "zipkin_replication_visible_lag_seconds", "lag"))
        sk2.observe(0.03)

        fleet = FleetObs(
            role="primary", registry=reg_a,
            remote_sources=lambda: [
                ((("role", "follower"), ("follower", "r1")),
                 registry_snapshot(reg_b))])
        st = fleet.status()
        assert len(st["processes"]) == 2
        merged = st["merged"]["zipkin_replication_visible_lag_seconds"]
        assert merged["count"] == 2


class TestFlightRecorder:
    def test_bounded_ring_keeps_newest(self):
        r = FlightRecorder(capacity=4)
        for i in range(10):
            r.record("k", severity="info", i=i)
        evs = r.events()
        assert len(evs) == 4
        assert [e["fields"]["i"] for e in evs] == [6, 7, 8, 9]
        assert [e["fields"]["i"] for e in r.events(limit=2)] == [8, 9]

    def test_event_shape(self):
        r = FlightRecorder()
        r.record("watchdog", severity="error", probe="fsync",
                 reason="parked")
        (e,) = r.events()
        assert e["kind"] == "watchdog" and e["severity"] == "error"
        assert e["fields"]["probe"] == "fsync"
        assert "tsUs" in e and "seq" in e


class TestWatchdog:
    def test_transitions_recorded_once(self):
        rec = FlightRecorder()
        reg = obs.Registry()
        wd = Watchdog(recorder=rec, registry=reg)
        state = {"ok": True}
        wd.add_probe("p", lambda: (state["ok"],
                                   None if state["ok"] else "stuck",
                                   1.0))
        assert wd.check()["ready"] is True
        state["ok"] = False
        h = wd.check()
        assert h["ready"] is False and h["live"] is True
        assert h["reasons"][0]["probe"] == "p"
        wd.check()  # still failing: no new transition event
        state["ok"] = True
        wd.check()
        kinds = [(e["kind"], e["fields"].get("probe"))
                 for e in rec.events()]
        assert kinds.count(("watchdog_trip", "p")) == 1
        assert kinds.count(("watchdog_clear", "p")) == 1
        assert reg.get("zipkin_watchdog_trips_total").value == 1
        assert reg.get("zipkin_watchdog_failing_probes").value == 0

    def test_probe_exception_is_a_failure(self):
        wd = Watchdog()

        def boom():
            raise RuntimeError("probe died")

        wd.add_probe("boom", boom)
        h = wd.check()
        assert h["ready"] is False
        assert "probe died" in h["reasons"][0]["reason"]

    def test_fsync_parked_probe(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "w"), fsync="off",
                            registry=obs.Registry())
        try:
            probe = fobs.fsync_parked_probe(wal)
            assert probe()[0] is True
            wal._sync_error = RuntimeError("disk gone")
            ok, reason, _ = probe()
            assert ok is False and "disk gone" in reason
        finally:
            wal._sync_error = None
            wal.close()

    def test_follower_lag_probe_thresholds(self):
        st = {"lagRecords": 5, "lagSeconds": 1.0}
        probe = fobs.follower_lag_probe(lambda: st,
                                        max_lag_records=10,
                                        max_lag_seconds=30.0)
        assert probe()[0] is True
        st["lagRecords"] = 50
        assert probe()[0] is False
        st["lagRecords"] = 5
        st["lagSeconds"] = 31.0
        assert probe()[0] is False


@pytest.fixture
def closers():
    """Close functions registered by a test, run in reverse at its end
    (collectors, query services, pipelines, logs, servers)."""
    out = []
    yield out
    for fn in reversed(out):
        fn()


def _port_api(fleet, closers):
    store = InMemorySpanStore()
    collector = Collector(store, concurrency=0, self_trace=False,
                          registry=obs.Registry())
    query = QueryService(store, coalesce_window_s=0.0)
    api = ApiServer(query, collector, self_trace=False,
                    registry=obs.Registry(), fleet=fleet)
    closers.append(query.close)
    closers.append(collector.close)
    return api


def _ref_api(fleet, closers):
    store = RefMemory()
    collector = RefCollector(store, concurrency=0, self_trace=False,
                             registry=ref_obs.Registry())
    query = RefQueryService(store, coalesce_window_s=0.0)
    api = RefApiServer(query, collector, self_trace=False,
                       registry=ref_obs.Registry(), fleet=fleet)
    closers.append(query.close)
    closers.append(collector.close)
    return api


class TestApiFleetSurface:
    def test_health_flips_on_failing_probe(self, closers):
        rec = FlightRecorder()
        wd = Watchdog(recorder=rec)
        state = {"ok": True}
        wd.add_probe("fsync", lambda: (
            state["ok"], None if state["ok"] else "wal fsync parked",
            None))
        fleet = FleetObs(role="primary", registry=obs.Registry(),
                         watchdog=wd, recorder=rec)
        api = _port_api(fleet, closers)
        code, body = api.handle("GET", "/api/health", {}, headers={})
        assert code == 200 and body["ready"] is True
        state["ok"] = False
        code, body = api.handle("GET", "/api/health", {}, headers={})
        assert code == 503 and body["ready"] is False
        assert body["reasons"][0]["reason"] == "wal fsync parked"
        # The trip is visible in the flight recorder.
        code, body = api.handle("GET", "/debug/events", {}, headers={})
        assert code == 200
        assert any(e["kind"] == "watchdog_trip" for e in body["events"])

    def test_health_without_fleet_always_ready(self, closers):
        api = _port_api(None, closers)
        code, body = api.handle("GET", "/api/health", {}, headers={})
        assert code == 200 and body["ready"] is True

    def test_fleet_endpoint_and_merged_scrape(self, closers):
        reg = obs.Registry()
        reg.register(obs.Counter("p_total", "h")).inc(2)
        freg = obs.Registry()
        freg.register(obs.Counter("p_total", "h")).inc(7)
        fleet = FleetObs(
            role="primary", registry=reg,
            remote_sources=lambda: [
                ((("role", "follower"), ("follower", "r1")),
                 registry_snapshot(freg))])
        api = _port_api(fleet, closers)
        code, body = api.handle("GET", "/api/fleet", {}, headers={})
        assert code == 200 and body["role"] == "primary"
        assert len(body["processes"]) == 2
        code, raw = api.handle("GET", "/metrics", {"fleet": "1"},
                               headers={})
        text = raw.body.decode("utf-8")
        assert code == 200
        rows = [r for r in text.splitlines() if r.startswith("p_total")]
        assert any('role="primary"' in r and r.endswith(" 2")
                   for r in rows)
        assert any('follower="r1"' in r and r.endswith(" 7")
                   for r in rows)

    def test_plain_scrape_unchanged_by_fleet_param_absence(self, closers):
        fleet = FleetObs(role="primary", registry=obs.Registry())
        api = _port_api(fleet, closers)
        code, raw = api.handle("GET", "/metrics", {}, headers={})
        assert code == 200
        text = raw.body.decode("utf-8")
        # Plain scrape stays the per-process registry: no injected
        # federation labels anywhere.
        assert 'role="primary"' not in text


# ---------------------------------------------------------------------------
# The port against the reference: pinned clocks, seeded ids
# ---------------------------------------------------------------------------

PKGS = {"port": (fobs, obs, walrec), "ref": (ref_fleet, ref_obs, ref_record)}


def _tracker_drive(pkg, seed):
    """One scripted tracker run: every entry point, a pinned clock and a
    seeded id generator. Returns (stamps, flushed batches, stage-sketch
    text, pending, ctx of unit 1)."""
    fleet, o, _ = PKGS[pkg]
    now = [T0]
    reg = o.Registry()
    batches = []
    t = fleet.LineageTracker(lambda spans: batches.append(list(spans)),
                             registry=reg, sample_every=3,
                             clock=lambda: now[0])
    t._rng = random.Random(seed)
    t.FLUSH_AT = 4
    extras = []
    for seq in range(1, 11):
        now[0] += 0.003
        extras.append(t.stamp())
        now[0] += 0.0007
        t.note_append(seq, extras[-1])
        if seq % 2 == 0:
            now[0] += 0.002
            t.on_durable(seq)
    ctx = t.ctx_for(1)
    assert t.ctx_for(2) is None  # unit 2 was not sampled
    now[0] += 0.01
    for seq, follower in ((1, "r1"), (4, "r2"), (2, "r1"), (7, "r1")):
        t.note_shipped(seq, follower)
    assert t.ingest_remote_spans("r1", [
        fleet.span_to_wire(ctx[0], 99, ctx[1], "replica apply",
                           "zipkin-tpu-r1", int(now[0] * 1e6), 1500),
        {"broken": True},
    ]) == 1
    sid = t.record_span(ctx[0], ctx[1], "shard dispatch",
                        int(now[0] * 1e6), 7, {"k": "v"})
    with t.suppressed():
        now[0] += 0.001
        t.on_durable(10)
        t.flush()
    n_before = len(batches)
    t.flush()
    return extras, batches, n_before, reg.render_text(), t.pending(), sid


def test_tracker_spans_match_reference():
    """stamp / note_append / on_durable / ctx_for / note_shipped /
    ingest_remote_spans / record_span / suppressed / flush: the same
    stamps, the same flushed batches (cut at the same FLUSH_AT points),
    the same stage sketches and drop counts."""
    want = _tracker_drive("ref", seed=5)
    got = _tracker_drive("port", seed=5)
    assert got[0] == want[0]
    assert sum("b3" in e for e in got[0]) == 4
    assert len(got[1]) >= 3 and got[2] == want[2]
    assert got[1] == [_convert(b, PORT) for b in want[1]]
    assert got[3:] == want[3:]
    names = {s.name for b in got[1] for s in b}
    assert names == {"ingest unit", "wal append", "wal fsync", "ship",
                     "replica apply", "shard dispatch"}
    assert "zipkin_lineage_spans_dropped_total 1" in got[3]


def _follower_drive(pkg, seed):
    fleet, o, record = PKGS[pkg]
    now = [T0]
    reg = o.Registry()
    t = fleet.LineageTracker(lambda spans: None, sample_every=2,
                             clock=lambda: now[0])
    t._rng = random.Random(seed)
    f = fleet.FollowerLineage("r1", mode="standby", registry=reg,
                              clock=lambda: now[0])
    f._rng = random.Random(seed + 1)
    f.MAX_BACKLOG = 3
    out = {"lags": [], "snaps": []}
    for seq in range(1, 9):
        payload = record.encode_unit([], [], {}, extra=t.stamp())
        now[0] += 0.25 * seq
        f.observe_record(seq, payload, apply_s=0.0004 * seq)
        out["lags"].append(f.lag_seconds())
        out["snaps"].append(f.maybe_metrics_snapshot())
    f.observe_record(9, record.encode_unit([], [], {}), apply_s=0.001)
    f.observe_record(10, b"\x00\x00\x00\x05junk!", apply_s=0.001)
    out["spans"] = f.take_spans()
    out["after"] = f.take_spans()
    out["text"] = reg.render_text()
    return out


def test_follower_lineage_matches_reference():
    """Backhauled apply spans (bounded backlog, oldest dropped), the lag
    after every record, the throttled snapshots and the registry text."""
    want = _follower_drive("ref", seed=9)
    got = _follower_drive("port", seed=9)
    assert got == want
    assert len(got["spans"]) == 3 and got["after"] == []
    assert all(s["name"] == "standby apply" for s in got["spans"])
    assert sum(s is not None for s in got["snaps"]) >= 2


def _fed_registry(o, k):
    """A counter, a gauge, a labelled sketch and an unlabelled one, fed
    values that depend on ``k``."""
    reg = o.Registry()
    reg.register(o.Counter("fed_events_total", "events")).inc(3 + k)
    g = reg.register(o.Gauge("fed_depth", "queue depth"))
    g.set(0.125 * (k + 1))
    sk = reg.register(o.LatencySketch(
        "zipkin_lineage_stage_seconds", "stages", labelnames=("stage",)))
    for i, stage in enumerate(("append", "fsync", "ship")):
        for v in range(1, 6 + k):
            sk.labels(stage=stage).observe(v * 0.0011 * (i + 1))
    lag = reg.register(o.LatencySketch(
        "zipkin_replication_visible_lag_seconds", "lag"))
    for v in range(1, 4 + k):
        lag.observe(0.01 * v)
    return reg


def _fed_outputs(pkg):
    fleet, o, _ = PKGS[pkg]
    regs = [_fed_registry(o, k) for k in range(3)]
    snaps = [fleet.registry_snapshot(r) for r in regs]
    sources = [((("role", "primary"),), snaps[0])] + [
        ((("role", "follower"), ("follower", f"r{k}")), snaps[k])
        for k in (1, 2)]
    fo = fleet.FleetObs(role="primary", registry=regs[0],
                        remote_sources=lambda: sources[1:])
    return {"snaps": json.loads(json.dumps(snaps)),
            "own": [r.render_text() for r in regs],
            "fed": fleet.render_federated(sources),
            "fleet_text": fo.federated_text(),
            "status": fo.status()}


def test_federation_matches_reference():
    """registry_snapshot, render_federated and FleetObs text/status over
    registries fed the same values (counter, gauge, labelled and plain
    sketches): equal to the reference's, and each process's values in
    the merged text equal its own scrape's."""
    want = _fed_outputs("ref")
    got = _fed_outputs("port")
    assert got["snaps"] == want["snaps"]
    assert got["own"] == want["own"]
    assert got["fed"] == want["fed"]
    assert got["fleet_text"] == want["fleet_text"] == got["fed"]
    assert json.dumps(got["status"], sort_keys=True) == json.dumps(
        want["status"], sort_keys=True)
    merged = got["status"]["merged"]
    assert merged["zipkin_lineage_stage_seconds"]["count"] == (
        3 * (5 + 6 + 7))
    own = sorted(line.rsplit(" ", 1)[1]
                 for line in got["own"][0].splitlines()
                 if line and not line.startswith("#"))
    fed = sorted(line.rsplit(" ", 1)[1]
                 for line in got["fed"].splitlines()
                 if 'role="primary"' in line)
    assert own == fed


@pytest.mark.parametrize("labelled", [False, True])
def test_merge_sketches_matches_reference(labelled):
    """Transported states and the monoid merge: bucket counts, moments,
    sum and the rendered samples equal the reference's."""
    out = {}
    for pkg in ("ref", "port"):
        fleet, o, _ = PKGS[pkg]
        sks = []
        for k in range(3):
            sk = o.LatencySketch("m_seconds", "h",
                                 labelnames=("stage",) if labelled else ())
            for v in range(1, 20 + 7 * k):
                x = (v * 0.37 + k) * 1e-3
                (sk.labels(stage=f"s{v % 2}") if labelled else sk).observe(x)
            sks.append(sk)
        states = []
        for sk in sks:
            st = fleet._sketch_states(sk)
            states.extend(c["state"] for c in st["children"]) \
                if labelled else states.append(st["state"])
        merged = fleet.merge_sketches("m_seconds", "h", states)
        out[pkg] = (json.loads(json.dumps(states)), merged.counts.tolist(),
                    (merged.moments.n, merged.moments.mean,
                     merged.moments.m2, merged.moments.m3,
                     merged.moments.m4),
                    merged.sum, list(merged.samples()))
    assert out["port"] == out["ref"]


def _watch_drive(pkg):
    fleet, o, _ = PKGS[pkg]
    now = [T0]
    rec = fleet.FlightRecorder(capacity=5, clock=lambda: now[0])
    reg = o.Registry()
    wd = fleet.Watchdog(recorder=rec, registry=reg)
    state = {"a": True, "b": True}
    wd.add_probe("a", lambda: (state["a"], None if state["a"] else "a down",
                               1.5))
    wd.add_probe("b", lambda: (state["b"], None if state["b"] else "b down",
                               None))

    def boom():
        if state.get("boom"):
            raise RuntimeError("probe died")
        return True, None, 0.0

    wd.add_probe("boom", boom)
    checks = []
    for step in ({}, {"a": False}, {"b": False}, {"boom": True},
                 {"a": True}, {"b": True, "boom": False}, {}):
        state.update(step)
        now[0] += 0.5
        checks.append(wd.check())
    rec.record("operator", severity="warn", note="manual")
    return checks, rec.events(), rec.events(limit=2), len(rec), \
        reg.render_text()


def test_watchdog_and_recorder_match_reference():
    """Seven checks across trips, clears and a probe that raises: the
    health documents, the bounded event ring and the watchdog's
    registry text equal the reference's."""
    got = _watch_drive("port")
    assert got == _watch_drive("ref")
    kinds = [e["kind"] for e in got[1]]
    assert len(got[1]) == 5 and kinds.count("watchdog_clear") >= 2
    assert got[0][3]["ready"] is False


class _FakePipe:
    def __init__(self, age, queued):
        self.age, self.n = age, queued

    def progress_age_s(self):
        return self.age

    def queued(self):
        return self.n


class _FakeSealer:
    def __init__(self, depth, cap):
        self.depth, self.cap = depth, cap

    def queued(self):
        return self.depth

    def at_capacity(self):
        return self.depth >= self.cap


def _probe_cases(fleet):
    ns = types.SimpleNamespace
    yield fleet.pipeline_stall_probe(ns(ingest_pipeline=lambda: None))
    for age in (0.0, 4.0, 7.5):
        yield fleet.pipeline_stall_probe(
            ns(ingest_pipeline=lambda a=age: _FakePipe(a, 3)))
    yield fleet.sealer_backlog_probe(ns())
    for depth in (1, 4):
        yield fleet.sealer_backlog_probe(
            ns(eviction_sealer=lambda d=depth: _FakeSealer(d, 4)))
    for age in (0.5, 9.0):
        yield fleet.dispatcher_stuck_probe(ns(queue_age_s=lambda a=age: a))
    for st in (None, {"lagRecords": 3}, {"lagRecords": 20000},
               {"lagSeconds": 45.0}, {"lagRecords": 1, "lagSeconds": 2.0}):
        yield fleet.follower_lag_probe(lambda s=st: s)


def test_probes_match_reference(tmp_path):
    """Each probe builder over the same component states gives the
    reference's (ok, reason, value); the fsync probe over each
    package's own log, parked and cleared."""
    assert ([p() for p in _probe_cases(fobs)]
            == [p() for p in _probe_cases(ref_fleet)])
    port = WriteAheadLog(str(tmp_path / "p"), fsync="off",
                         registry=obs.Registry())
    ref = RefWal(str(tmp_path / "r"), fsync="off",
                 registry=ref_obs.Registry())
    try:
        for err in (None, OSError(5, "EIO on fsync"), None):
            port._sync_error = ref._sync_error = err
            assert (fobs.fsync_parked_probe(port)()
                    == ref_fleet.fsync_parked_probe(ref)())
    finally:
        port._sync_error = ref._sync_error = None
        port.close()
        ref.close()


# ---------------------------------------------------------------------------
# The probe handles on the port's own pipeline and sealer
# ---------------------------------------------------------------------------


def test_pipeline_progress_age_reads_a_stalled_commit(closers, monkeypatch):
    """``progress_age_s`` is 0 while idle, grows while a unit waits on a
    wedged commit (the pipeline probe trips), and the probe clears once
    the commit goes on."""
    store = build_crash_store(device="cpu")
    gate = threading.Event()
    commit = store._commit_unit

    def held(unit):
        gate.wait(timeout=30)
        commit(unit)

    monkeypatch.setattr(store, "_commit_unit", held)
    pipe = store.start_pipeline(2)
    closers.append(lambda: store.stop_pipeline(raise_errors=False))
    closers.append(gate.set)
    probe = fobs.pipeline_stall_probe(store, stall_after_s=0.05)
    assert pipe.progress_age_s() == 0.0 and probe()[0] is True
    store.apply(crash_batches(1)[0])
    deadline = time.monotonic() + 10
    while pipe.progress_age_s() <= 0.1 and time.monotonic() < deadline:
        time.sleep(0.01)
    ok, reason, age = probe()
    assert not ok and age > 0.05
    assert "ingest pipeline stalled" in reason
    gate.set()
    store.drain_pipeline()
    assert pipe.progress_age_s() == 0.0 and probe()[0] is True


def test_sealer_at_capacity_trips_the_backlog_probe(closers, monkeypatch):
    """``EvictionSealer.at_capacity`` is true once ``backlog`` windows
    wait behind a busy seal; the sealer probe fails then and clears
    when the seals finish."""
    sealed = []
    store = types.SimpleNamespace(device=torch.device("cpu"),
                                  eviction_sink=None,
                                  _note_sealed=lambda lo, hi: None)
    gate = threading.Event()
    sealer = EvictionSealer(store, backlog=1, registry=obs.Registry())
    closers.append(sealer.stop)
    closers.append(gate.set)

    def slow_seal(item):
        gate.wait(timeout=30)
        sealed.append(item[6:8])

    monkeypatch.setattr(sealer, "_seal", slow_seal)
    store.eviction_sealer = lambda: sealer
    probe = fobs.sealer_backlog_probe(store)
    assert not sealer.at_capacity() and probe()[0] is True
    m = torch.zeros(1, 1)
    sealer.submit(1, 0, 0, m, m, m, 0, 1, 0.0)
    deadline = time.monotonic() + 10
    while sealer.queued() and time.monotonic() < deadline:
        time.sleep(0.01)  # the worker took the first window
    sealer.submit(1, 0, 0, m, m, m, 1, 2, 0.0)
    assert sealer.at_capacity()
    ok, reason, depth = probe()
    assert not ok and depth == 1.0 and "sealer backlog at cap" in reason
    gate.set()
    sealer.drain()
    assert sealed == [(0, 1), (1, 2)]
    assert not sealer.at_capacity() and probe()[0] is True


# ---------------------------------------------------------------------------
# Lineage on the store: WAL bytes, recovery, the readback
# ---------------------------------------------------------------------------


def _ref_crash_store():
    return TpuSpanStore(dev.StoreConfig(
        **ref_crash.crash_config(False)._asdict()))


def _segments(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".seg"))


def _settle(wal, done, timeout=30.0):
    """Interval mode: wait until every appended record is durable and
    the durable callback for it has returned (a flush it ran, and the
    record that flush appended, included)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        last = wal.last_seq
        if done and done[-1] >= last and wal.last_seq == last:
            return
        time.sleep(0.005)
    raise AssertionError(f"durable callbacks stuck at {done[-1:]}, "
                         f"last seq {wal.last_seq}")


def _lineage_drive(pkg, path, fsync, closers, pipelined=False,
                   n_batches=6):
    """Drive crash batches through a store with a WAL and a tracker
    (``sample_every=1``, ``FLUSH_AT`` 4, pinned clock, seeded ids).
    Under fsync=interval every apply settles before the next, so the
    group-commit thread's flushes land at the same points in both
    packages."""
    if pkg == "port":
        store = build_crash_store(device="cpu")
        wal = WriteAheadLog(path, fsync=fsync, interval_s=0.01,
                            registry=obs.Registry())
        batches = crash_batches(n_batches)
        fleet, reg = fobs, obs.Registry()
    else:
        store = _ref_crash_store()
        wal = RefWal(path, fsync=fsync, interval_s=0.01,
                     registry=ref_obs.Registry())
        batches = ref_crash.crash_batches(n_batches)
        fleet, reg = ref_fleet, ref_obs.Registry()
    closers.append(wal.close)
    now = [T0]
    tracker = fleet.LineageTracker(store.apply, registry=reg,
                                   sample_every=1, clock=lambda: now[0])
    tracker._rng = random.Random(17)
    tracker.FLUSH_AT = 4
    store.attach_lineage(tracker)  # before the WAL: order-independent
    store.attach_wal(wal)
    assert wal._on_durable == tracker.on_durable
    done = []
    if fsync == "interval":
        def observed(seq):
            tracker.on_durable(seq)
            done.append(seq)

        wal.set_on_durable(observed)
    if pipelined:
        store.start_pipeline(4)
        closers.append(lambda: store.stop_pipeline(raise_errors=False))
    for b in batches:
        now[0] += 0.25
        store.apply(b)
        if fsync == "interval":
            _settle(wal, done)
    if pipelined:
        store.stop_pipeline()
    now[0] += 0.25
    wal.sync()
    if fsync == "interval":
        _settle(wal, done)
    tracker.flush()
    wal.sync()
    if fsync == "interval":
        _settle(wal, done)
    assert tracker.pending() == n_batches
    return store, wal, tracker, reg


def _lineage_traces(store, n):
    ids = store.get_trace_ids_by_name("zipkin-tpu", None, 1 << 62, 4 * n)
    return [store.get_spans_by_trace_ids([i.trace_id])[0] for i in ids]


@pytest.mark.parametrize("fsync", ["off", "interval"])
def test_lineage_wal_bytes_match_reference(tmp_path, closers, fsync):
    """The stamped log a ``TorchSpanStore(device="cpu")`` writes equals
    the one ``TpuSpanStore`` writes from the same spans, byte for byte
    (stamps, the lineage spans' own records, their dictionary deltas);
    the lineage traces read back alike, each with its root and three
    children parented on it; the stage sketch saw append and fsync."""
    ref, _, _, _ = _lineage_drive("ref", str(tmp_path / "ref"), fsync,
                                  closers)
    port, pwal, ptracker, preg = _lineage_drive(
        "port", str(tmp_path / "port"), fsync, closers)
    names = _segments(tmp_path / "ref")
    assert names and names == _segments(tmp_path / "port")
    for n in names:
        a = (tmp_path / "ref" / n).read_bytes()
        b = (tmp_path / "port" / n).read_bytes()
        assert a == b, n
    metas = [walrec.unit_meta(p) for _, p in pwal.replay(0)]
    assert len(metas) > 6 and all("ts" in m for m in metas)
    assert sum("b3" in m for m in metas) == 6  # flushes are not sampled
    traces = _lineage_traces(port, 6)
    assert len(traces) == 6
    assert traces == [_convert(t, PORT) for t in _lineage_traces(ref, 6)]
    for trace in traces:
        root = next(s for s in trace if s.parent_id is None)
        assert root.name == "ingest unit"
        assert sorted(s.name for s in trace if s is not root) == [
            "wal append", "wal fsync"]
        assert all(s.parent_id == root.id and s.trace_id == root.trace_id
                   for s in trace if s is not root)
    stages = {labels[0][1] for _, labels, _ in
              preg.get("zipkin_lineage_stage_seconds").samples() if labels}
    assert stages == {"append", "fsync"}
    assert_states_equal(jax_leaves(ref.state), state_to_numpy(port.state),
                        f"lineage {fsync}")


@pytest.mark.parametrize("fsync", ["off", "interval"])
def test_lineage_log_recovers_in_both_packages(tmp_path, closers, fsync):
    """``recover`` of the port's stamped log into a fresh port store, and
    the reference's ``recover`` of the same log into a fresh
    ``TpuSpanStore``, each give the live port store's state (the port
    bitwise; the reference with the moments within stated tolerance)."""
    live, wal, _, _ = _lineage_drive("port", str(tmp_path / "w"), fsync,
                                     closers)
    wal.close()
    wal2 = WriteAheadLog(str(tmp_path / "w"), fsync="off",
                         registry=obs.Registry())
    closers.append(wal2.close)
    rec, stats = recover(None, wal2, device="cpu",
                         fresh_store=lambda d: build_crash_store(device=d))
    assert stats["replayed_records"] == wal.last_seq > 6
    assert not state_mismatches(live.state, rec.state)
    assert rec.counter_block() == live.counter_block()
    rwal = RefWal(str(tmp_path / "w"), fsync="off",
                  registry=ref_obs.Registry())
    closers.append(rwal.close)
    ref, rstats = ref_recover(None, rwal, fresh_store=_ref_crash_store)
    assert rstats["replayed_records"] == wal.last_seq
    assert_states_equal(jax_leaves(ref.state), state_to_numpy(live.state),
                        f"reference recovery of the port's {fsync} log")
    assert _lineage_traces(rec, 6) == _lineage_traces(live, 6)


def test_pipelined_lineage_log_matches_reference_serial(tmp_path, closers):
    """Pipelined, the port journals on stage 1 under the encode lock:
    its stamped log equals the reference's serial one byte for byte."""
    _lineage_drive("ref", str(tmp_path / "ref"), "off", closers)
    port, _, _, _ = _lineage_drive("port", str(tmp_path / "port"), "off",
                                   closers, pipelined=True)
    names = _segments(tmp_path / "ref")
    assert names == _segments(tmp_path / "port")
    for n in names:
        assert ((tmp_path / "ref" / n).read_bytes()
                == (tmp_path / "port" / n).read_bytes()), n
    assert len(_lineage_traces(port, 6)) == 6


def test_lineage_without_wal_journals_nothing(closers):
    """A tracker on a store with no WAL stamps nothing and the store
    ingests as before (the daemon attaches it either way)."""
    store = build_crash_store(device="cpu")
    got, sink = _drain_spans()
    tracker = LineageTracker(sink, sample_every=1)
    store.attach_lineage(tracker)
    store.apply(crash_batches(1)[0])
    tracker.flush()
    assert got == [] and tracker.pending() == 0
    assert store.counter_block()["batches"] >= 1


def _close_drive(pkg, path, closers):
    if pkg == "port":
        store, batches = build_crash_store(device="cpu"), crash_batches(3)
        wal = WriteAheadLog(path, fsync="off", registry=obs.Registry())
        fleet = fobs
    else:
        store, batches = _ref_crash_store(), ref_crash.crash_batches(3)
        wal = RefWal(path, fsync="off", registry=ref_obs.Registry())
        fleet = ref_fleet
    closers.append(wal.close)
    got, sink = _drain_spans()
    tracker = fleet.LineageTracker(sink, sample_every=1,
                                   clock=lambda: T0)
    tracker._rng = random.Random(4)
    store.attach_wal(wal)
    store.attach_lineage(tracker)
    for b in batches:
        store.apply(b)

    def unsynced():
        return sum(c.durable_us is None for c in tracker._pending.values())

    before = unsynced()
    store.close()
    after = unsynced()
    tracker.flush()
    return before, after, got


def test_close_makes_the_log_durable_as_the_reference(tmp_path, closers):
    """``close()`` ends with ``wal_sync()``, as the reference's does: at
    fsync=off the last unit's durable callback comes from that sync, so
    its ``wal fsync`` span is emitted on close in both packages."""
    want = _close_drive("ref", str(tmp_path / "ref"), closers)
    got = _close_drive("port", str(tmp_path / "port"), closers)
    assert got[:2] == want[:2] == (1, 0)
    assert got[2] == _convert(want[2], PORT)
    assert [s.name for s in got[2]].count("wal fsync") == 3


# ---------------------------------------------------------------------------
# The API's fleet routes against the reference's
# ---------------------------------------------------------------------------


def _fleet_pair(pkg, closers):
    fleet, o, _ = PKGS[pkg]
    now = [T0]
    rec = fleet.FlightRecorder(clock=lambda: now[0])
    reg = _fed_registry(o, 0)
    wd = fleet.Watchdog(recorder=rec, registry=reg)
    state = {"ok": True}
    wd.add_probe("wal_fsync", lambda: (
        state["ok"], None if state["ok"] else "wal fsync parked: EIO",
        None))
    remote = ((("role", "follower"), ("follower", "r1")),
              fleet.registry_snapshot(_fed_registry(o, 2)))
    fo = fleet.FleetObs(role="primary", registry=reg, watchdog=wd,
                        recorder=rec, remote_sources=lambda: [remote])
    api = (_port_api if pkg == "port" else _ref_api)(fo, closers)
    return api, state, now


def _answer(api, path, params=None):
    code, body = api.handle("GET", path, dict(params or {}), headers={})
    if hasattr(body, "body"):
        return code, body.content_type, body.body.decode("utf-8")
    return code, json.dumps(body, sort_keys=True)


def test_fleet_routes_match_reference(closers):
    """/api/health (200, 503 with the reason, 200), /api/fleet,
    /debug/events (also ?limit=) and /metrics?fleet=1: the same status,
    JSON and text as the reference's ApiServer with the same FleetObs."""
    out = {}
    for pkg in ("ref", "port"):
        api, state, now = _fleet_pair(pkg, closers)
        answers = []
        for ok in (True, False, False, True):
            state["ok"] = ok
            now[0] += 1.0
            answers.append(_answer(api, "/api/health"))
            answers.append(_answer(api, "/api/fleet"))
        answers.append(_answer(api, "/debug/events"))
        answers.append(_answer(api, "/debug/events", {"limit": "1"}))
        answers.append(_answer(api, "/metrics", {"fleet": "1"}))
        out[pkg] = answers
    assert out["port"] == out["ref"]
    codes = [a[0] for a in out["port"][0:8:2]]
    assert codes == [200, 503, 503, 200]
    events = json.loads(out["port"][8][1])["events"]
    assert [e["kind"] for e in events] == ["watchdog_trip",
                                           "watchdog_clear"]


def test_fleet_routes_over_a_socket(closers):
    """One round trip through ``make_server``: health 200, then 503
    with the parked reason while the probe fails, and the events."""
    api, state, _ = _fleet_pair("port", closers)
    server = port_server.make_server(api, host="127.0.0.1", port=0)
    thread = port_server.serve_forever_in_thread(server)

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()

    closers.append(stop)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        try:
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            with e:
                return e.code, e.read()

    code, body = get("/api/health")
    assert code == 200 and json.loads(body)["ready"] is True
    state["ok"] = False
    code, body = get("/api/health")
    doc = json.loads(body)
    assert code == 503 and doc["ready"] is False
    assert doc["reasons"][0]["reason"] == "wal fsync parked: EIO"
    code, body = get("/debug/events")
    assert code == 200
    assert [e["kind"] for e in json.loads(body)["events"]] == [
        "watchdog_trip"]
    code, body = get("/metrics?fleet=1")
    assert code == 200 and b'follower="r1"' in body
