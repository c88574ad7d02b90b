"""The port's daemon entry and tracegen main (``zipkin_tpu_torch/main``)
against the JAX package's, on the CPU.

- the parser: every flag with the reference's dest, default, type and
  choices (``--platform`` takes cpu/cuda);
- ``build_app`` with the memory store (ports ``tests/test_checkpoint_main
  .py``'s ``test_example_build_app_and_seed``), its catalog equal to the
  reference's;
- ``build_app`` on a device store on the CPU with the cold tier, a WAL
  and a checkpoint: the wiring, reads through ``api.handle`` equal to the
  reference ``build_app``'s at the same flags, the ordered shutdown and a
  boot that replays nothing, then a crash (no checkpoint) and a boot that
  replays the log's tail, both reading back what the reference reads;
- ``--shards 2`` with a WAL and a checkpoint, built in-process: the
  fleet, its ``ShardedWal`` and the dispatcher's wiring, reads equal to
  the reference daemon's, shutdown then a boot and a crash then a boot,
  each boot's ``wal: replayed`` line the reference's;
- the refused flags, each with the reference's message (``--ship-port``
  without a log, a malformed ``--follow``, and what the reference
  refuses on a sharded store);
- tracegen's ``run`` on the device store and the memory store, its
  output line for line the reference's.

No test here calls ``main()``, installs a signal handler, sends a signal
or starts a process: the daemon's objects are built through the
functions ``main()`` calls. Servers bind 127.0.0.1:0; every collector,
query service, sealer, WAL and server is closed in a fixture finalizer.
"""

import contextlib
import io
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_store import moments_close  # noqa: E402
from zipkin_tpu.main import example as ref_example  # noqa: E402
from zipkin_tpu.main import tracegen as ref_tracegen  # noqa: E402
from zipkin_tpu_torch.ingest.receiver import _hex_id  # noqa: E402
from zipkin_tpu_torch.main import example  # noqa: E402
from zipkin_tpu_torch.main import tracegen  # noqa: E402
from zipkin_tpu_torch.obs import FleetObs  # noqa: E402
from zipkin_tpu_torch.store.archive import TieredSpanStore  # noqa: E402
from zipkin_tpu_torch.store.memory import InMemorySpanStore  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402
from zipkin_tpu_torch.tracegen import generate_traces  # noqa: E402

SELF = "zipkin-tpu"
END_TS = str(2 * 10**12)


def _parser_actions(parser):
    return {a.dest: a for a in parser._actions}


def test_port_parser_matches_reference():
    ref = _parser_actions(ref_example.build_parser())
    port = _parser_actions(example.build_parser())
    assert port.keys() == ref.keys()
    for dest, a in ref.items():
        b = port[dest]
        assert (b.option_strings, b.default, b.type, b.nargs, b.const,
                type(b)) == (a.option_strings, a.default, a.type, a.nargs,
                             a.const, type(a)), dest
        if dest == "platform":
            assert a.choices == ("cpu", "tpu")
            assert b.choices == ("cpu", "cuda")
        else:
            assert b.choices == a.choices, dest


class _Daemons:
    """Every app a test builds (either package), closed at teardown:
    servers first, then the collector (which closes the query engines
    and the store), then the WAL."""

    def __init__(self):
        self.live = []

    def add(self, store, collector, api, servers=None):
        d = {"store": store, "collector": collector, "api": api,
             "servers": servers}
        self.live.append(d)
        return d

    @staticmethod
    def stop_servers(d):
        servers, d["servers"] = d["servers"], None
        for srv in servers or ():
            if srv is not None:
                srv.shutdown()
                srv.server_close()

    def close(self, d):
        if d not in self.live:
            return
        self.live.remove(d)
        self.stop_servers(d)
        d["collector"].close()
        d["api"].query.close()
        wal = getattr(d["store"], "wal", None)
        if wal is not None:
            wal.close()

    def close_all(self):
        errors = []
        for d in list(reversed(self.live)):
            try:
                self.close(d)
            except Exception as e:  # keep closing the others
                errors.append(e)
        if errors:
            raise errors[0]


@pytest.fixture
def daemons():
    ds = _Daemons()
    yield ds
    ds.close_all()


def _json(payload):
    return json.loads(json.dumps(payload))


def test_port_memory_store_build_app_and_seed(daemons):
    args = example.build_parser().parse_args(
        ["--memory-store", "--seed-traces", "2"])
    store, collector, api, shipper = example.build_app(args)
    daemons.add(store, collector, api)
    assert isinstance(store, InMemorySpanStore) and shipper is None
    example.seed(collector, 2)
    status, services = api.handle("GET", "/api/services", {})
    assert status == 200 and services
    # Runtime-adjustable sample rate (HttpVar parity).
    status, body = api.handle("POST", "/vars/sampleRate", {}, b"0.25")
    assert status == 200 and body["sampleRate"] == 0.25
    assert collector.sampler.rate == 0.25

    ref_args = ref_example.build_parser().parse_args(
        ["--memory-store", "--seed-traces", "2"])
    r_store, r_collector, r_api, _ = ref_example.build_app(ref_args)
    daemons.add(r_store, r_collector, r_api)
    ref_example.seed(r_collector, 2)
    assert _json(r_api.handle("GET", "/api/services", {})) == \
        _json((status, services))


@pytest.mark.parametrize("argv, item", [
    (["--shards", "2", "--ship-port", "1"], "requires --wal-dir"),
    (["--ship-port", "1"], "requires --wal-dir"),
    (["--follow", "h1"], "wants HOST:PORT"),
])
def test_port_refuses_unported_flags(argv, item):
    """Every flag is ported (``--shards`` since ROADMAP item 6b): the
    daemon refuses only what the reference refuses, with its messages,
    before anything is built or connected."""
    assert not hasattr(example, "refuse_unported")
    args = example.build_parser().parse_args(["--platform", "cpu"] + argv)
    build = (example.build_follower_app if argv[0] == "--follow"
             else example.build_app)
    if argv[0] == "--follow":
        ref_args = ref_example.build_parser().parse_args(argv)
        with pytest.raises(SystemExit, match=item):
            ref_example.build_follower_app(ref_args)
    with pytest.raises(SystemExit, match=item):
        build(args)


def test_port_wal_retain_bytes_passes_through(daemons, tmp_path):
    args = example.build_parser().parse_args([
        "--platform", "cpu", "--capacity", "1024", "--window-seconds", "0",
        "--wal-dir", str(tmp_path / "wal"), "--wal-retain-bytes", "12345",
        "--no-fleet-obs"])
    store, collector, api, _ = example.build_app(args)
    daemons.add(store, collector, api)
    assert isinstance(store, TorchSpanStore)
    assert store.wal.retain_bytes == 12345
    assert store.device.type == "cpu" and api.fleet is None


# ---------------------------------------------------------------------------
# The device store on the CPU: wiring, reads, shutdown, boot, crash, boot
# ---------------------------------------------------------------------------


def _flags(tmp):
    return ["--platform", "cpu", "--capacity", "4096", "--cold-tier",
            "--capture-backlog", "4", "--wal-dir", str(tmp / "wal"),
            "--checkpoint", str(tmp / "ckpt"), "--host", "127.0.0.1",
            "--port", "0", "--scribe-port", "0"]


def _known(seed, n):
    return generate_traces(n, max_depth=3, rng=np.random.default_rng(seed))


KNOWN_A = _known(21, 8)
KNOWN_B = _known(22, 4)


def _services(traces):
    return sorted({svc for t in traces for s in t for svc in s.service_names})


def _reads(api, traces):
    """What the comparisons read through ``api.handle``: each trace, a
    by-service query for every service of ``traces``, the dependency
    links and the catalog, less the daemon's own self-trace service
    (its spans carry wall-clock times)."""
    out = {}
    for t in traces:
        tid = _hex_id(t[0].trace_id)
        out[f"trace {tid}"] = _json(api.handle("GET", f"/api/trace/{tid}",
                                               {}))
    for svc in _services(traces):
        out[f"query {svc}"] = _json(api.handle("GET", "/api/query", {
            "serviceName": svc, "endTs": END_TS, "limit": "10"}))
    status, deps = _json(api.handle("GET", "/api/dependencies", {}))
    out["links"] = (status, sorted(
        (lk for lk in deps["links"]
         if SELF not in (lk["parent"], lk["child"])),
        key=lambda lk: (lk["parent"], lk["child"])))
    status, svcs = _json(api.handle("GET", "/api/services", {}))
    out["services"] = (status, [s for s in svcs if s != SELF])
    return out


def _same_reads(got, want):
    """Equal reads, the dependency moments by stated tolerance 2."""
    assert got.keys() == want.keys()
    for k in got:
        if k != "links":
            assert got[k] == want[k], k
    (gs, gl), (ws, wl) = got["links"], want["links"]
    assert gs == ws == 200 and wl
    key = [(lk["parent"], lk["child"]) for lk in wl]
    assert [(lk["parent"], lk["child"]) for lk in gl] == key
    fields = ("count", "mean", "stddev", "m2", "m3", "m4")

    def mat(links):
        return np.array([[lk["durationMoments"][f] or 0.0 for f in fields]
                         for lk in links], np.float64)

    assert moments_close(mat(wl), mat(gl))
    assert any(got[k][1]["traceIds"] for k in got if k.startswith("query"))


def _sharded_flags(tmp):
    return ["--platform", "cpu", "--shards", "2", "--capacity", "1024",
            "--wal-dir", str(tmp / "wal"), "--checkpoint",
            str(tmp / "ckpt"), "--host", "127.0.0.1", "--port", "0",
            "--scribe-port", "0"]


def _ref_boot(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        store, collector, api, _ = ref_example.build_app(args)
    api.tracer.sample_rate = 0.0
    return store, collector, api, out.getvalue().splitlines()


def _ref_close(store, collector, api, args=None):
    """The reference ``main``'s ordered shutdown with no server open:
    drain, checkpoint (with ``args``; none is a crash), close, flush the
    lineage tail, close the log."""
    from zipkin_tpu import checkpoint as ref_checkpoint

    collector.flush()
    if args is not None:
        ref_checkpoint.save(store, args.checkpoint)
    collector.close()
    api.query.close()
    api.fleet.tracker.flush()
    store.wal.close()


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference daemon's lifecycle at the same flags on JAX CPU:
    boot, set A through ``ingest_durable`` and its reads, the ordered
    shutdown, a boot (its replay line) and the reads again, set B acked
    and a crash, a boot (its replay line) and the reads of both sets."""
    tmp = tmp_path_factory.mktemp("ref-daemon")
    args = ref_example.build_parser().parse_args(_flags(tmp))
    out = {}
    store, collector, api, _ = _ref_boot(args)
    try:
        collector.ingest_durable([s for t in KNOWN_A for s in t])
        collector.flush()
        out["a"] = _reads(api, KNOWN_A)
    finally:
        _ref_close(store, collector, api, args)
    store, collector, api, lines = _ref_boot(args)
    try:
        out["boot2"] = _replayed(lines)
        out["a2"] = _reads(api, KNOWN_A)
        collector.ingest_durable([s for t in KNOWN_B for s in t])
    finally:
        _ref_close(store, collector, api)
    store, collector, api, lines = _ref_boot(args)
    try:
        out["boot3"] = _replayed(lines)
        out["b"] = _reads(api, KNOWN_A + KNOWN_B)
    finally:
        _ref_close(store, collector, api)
    return out


def _boot(daemons, tmp, capsys, flags=_flags):
    args = example.build_parser().parse_args(flags(tmp))
    store, collector, api, _ = example.build_app(args)
    api.tracer.sample_rate = 0.0
    servers = example.start_servers(args, store, collector, api)
    d = daemons.add(store, collector, api, servers)
    return args, d, capsys.readouterr().out.splitlines()


def _replayed(lines):
    """(records, spans) of a boot's ``wal: replayed`` line; (0, 0) when
    it printed none."""
    got = [ln.split() for ln in lines if ln.startswith("wal: replayed ")]
    return (int(got[0][2]), int(got[0][4].lstrip("("))) if got else (0, 0)


def test_port_daemon_boot_shutdown_crash_match_reference(
        daemons, tmp_path, capsys, reference_run):
    want = reference_run

    # Boot 1: a fresh store, the daemon's wiring.
    args, d, lines = _boot(daemons, tmp_path, capsys)
    store, collector, api = d["store"], d["collector"], d["api"]
    assert isinstance(store, TieredSpanStore)
    assert isinstance(store.hot, TorchSpanStore)
    assert store.hot.device.type == "cpu"
    assert store.hot.capture_backlog == 4
    assert store.wal is not None and store.wal.fsync == "interval"
    assert isinstance(api.fleet, FleetObs)
    assert store.hot.lineage is api.fleet.tracker
    assert [n for n, _ in api.fleet.watchdog._probes] == [
        "pipeline", "sealer", "wal_fsync"]
    assert store.archive._compactor is not None
    assert _replayed(lines) == (0, 0)
    port = d["servers"][0].server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/health",
                                timeout=30) as r:
        assert r.status == 200
    collector.ingest_durable([s for t in KNOWN_A for s in t])
    collector.flush()
    _same_reads(_reads(api, KNOWN_A), want["a"])

    # The ordered shutdown saves; boot 2 restores it. What it replays is
    # only the lineage tail that the shutdown flushes after its
    # checkpoint, as the reference's boot does.
    example.shutdown(args, store, collector, api, d["servers"])
    daemons.live.remove(d)
    args, d, lines = _boot(daemons, tmp_path, capsys)
    assert any(ln.startswith("checkpoint: restored ") for ln in lines)
    assert _replayed(lines) == want["boot2"]
    assert want["boot2"][0] <= 1
    store, collector, api = d["store"], d["collector"], d["api"]
    assert isinstance(store, TieredSpanStore)
    assert store.archive._compactor is not None
    _same_reads(_reads(api, KNOWN_A), want["a"])
    _same_reads(want["a2"], want["a"])

    # A crash: set B acked, then the collector and the log closed with
    # no checkpoint. Boot 3 replays the tail.
    collector.ingest_durable([s for t in KNOWN_B for s in t])
    daemons.stop_servers(d)
    collector.close()
    api.query.close()
    api.fleet.tracker.flush()
    store.wal.close()
    daemons.live.remove(d)
    args, d, lines = _boot(daemons, tmp_path, capsys)
    assert _replayed(lines) == want["boot3"]
    assert want["boot3"][0] >= 1
    _same_reads(_reads(d["api"], KNOWN_A + KNOWN_B), want["b"])


# ---------------------------------------------------------------------------
# --shards: the sharded store with its group-commit log and snapshot
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_sharded_run(tmp_path_factory):
    """The reference daemon's lifecycle at ``--shards 2`` (a 2-device
    CPU mesh) and the same flags: boot and its probes, set A acked and
    its reads, the ordered shutdown, a boot (its replay line and reads),
    set B acked and a crash, a boot (its replay line) and the reads of
    both sets."""
    tmp = tmp_path_factory.mktemp("ref-sharded-daemon")
    args = ref_example.build_parser().parse_args(_sharded_flags(tmp))
    out = {}
    store, collector, api, _ = _ref_boot(args)
    try:
        out["probes"] = [n for n, _ in api.fleet.watchdog._probes]
        collector.ingest_durable([s for t in KNOWN_A for s in t])
        collector.flush()
        out["a"] = _reads(api, KNOWN_A)
    finally:
        _ref_close(store, collector, api, args)
    store, collector, api, lines = _ref_boot(args)
    try:
        out["boot2"] = _replayed(lines)
        out["a2"] = _reads(api, KNOWN_A)
        collector.ingest_durable([s for t in KNOWN_B for s in t])
    finally:
        _ref_close(store, collector, api)
    store, collector, api, lines = _ref_boot(args)
    try:
        out["boot3"] = _replayed(lines)
        out["b"] = _reads(api, KNOWN_A + KNOWN_B)
    finally:
        _ref_close(store, collector, api)
    return out


def test_port_sharded_daemon_boot_shutdown_crash_match_reference(
        daemons, tmp_path, capsys, reference_sharded_run):
    """``--shards 2 --wal-dir --checkpoint`` through ``build_app``: two
    shards on the one device (the CPU here), a ShardedWal replayed at
    boot, the dispatcher wired to the lineage tracker and the watchdog;
    every boot's replay line and reads equal the reference daemon's."""
    from zipkin_tpu_torch.parallel.shard import ShardedSpanStore
    from zipkin_tpu_torch.wal import ShardedWal

    want = reference_sharded_run
    args, d, lines = _boot(daemons, tmp_path, capsys, _sharded_flags)
    store, collector, api = d["store"], d["collector"], d["api"]
    assert isinstance(store, ShardedSpanStore) and store.n == 2
    assert store.device.type == "cpu"
    assert isinstance(store.wal, ShardedWal) and store.wal.n_shards == 2
    assert store.wal.epoch.fsync == "interval"
    assert store.dispatcher.span_sink is api.fleet.tracker
    assert [n for n, _ in api.fleet.watchdog._probes] == want["probes"]
    assert "dispatcher" in want["probes"]
    assert _replayed(lines) == (0, 0)
    collector.ingest_durable([s for t in KNOWN_A for s in t])
    collector.flush()
    assert store._wal_applied == store.wal.last_seq >= 1
    _same_reads(_reads(api, KNOWN_A), want["a"])

    example.shutdown(args, store, collector, api, d["servers"])
    daemons.live.remove(d)
    args, d, lines = _boot(daemons, tmp_path, capsys, _sharded_flags)
    assert any(ln.startswith("checkpoint: restored ") for ln in lines)
    assert _replayed(lines) == want["boot2"]
    store, collector, api = d["store"], d["collector"], d["api"]
    assert isinstance(store, ShardedSpanStore) and store.n == 2
    _same_reads(_reads(api, KNOWN_A), want["a"])
    _same_reads(want["a2"], want["a"])

    collector.ingest_durable([s for t in KNOWN_B for s in t])
    daemons.stop_servers(d)
    collector.close()
    api.query.close()
    api.fleet.tracker.flush()
    store.wal.close()
    daemons.live.remove(d)
    args, d, lines = _boot(daemons, tmp_path, capsys, _sharded_flags)
    assert _replayed(lines) == want["boot3"]
    assert want["boot3"][0] >= 1
    _same_reads(_reads(d["api"], KNOWN_A + KNOWN_B), want["b"])


def _fleet_snapshot(tmp):
    """A 2-shard snapshot saved by the port's daemon wiring."""
    from zipkin_tpu_torch import checkpoint
    from zipkin_tpu_torch.parallel.shard import ShardedSpanStore
    from zipkin_tpu_torch.store.device import StoreConfig

    path = str(tmp / "fleet-ckpt")
    fleet = ShardedSpanStore(2, StoreConfig(capacity=1024), device="cpu")
    try:
        checkpoint.save(fleet, path)
    finally:
        fleet.close()
    return path


@pytest.mark.parametrize("extra, message", [
    (["--layout", "paged"], "--layout paged requires the single-device "
     "store (the sharded store's per-shard page planner is not wired "
     "yet)"),
    (["--cold-tier"], "--cold-tier requires the single-device store (the "
     "sharded store's per-shard capture is not wired yet)"),
    (["--wal-dir", "{tmp}/wal", "--ship-port", "1"],
     "--ship-port/--wal-retain-bytes are single-log features; the "
     "sharded group-commit log does not ship to followers yet"),
    (["--wal-dir", "{tmp}/wal", "--wal-retain-bytes", "4096"],
     "--ship-port/--wal-retain-bytes are single-log features; the "
     "sharded group-commit log does not ship to followers yet"),
    (["--checkpoint", "{ckpt}", "--shards", "3"],
     "checkpoint has 2 shard(s); --shards 3 does not match"),
], ids=["paged", "cold-tier", "ship-port", "wal-retain-bytes",
        "shard-count"])
def test_port_sharded_refusals_match_reference(tmp_path, extra, message):
    """What a sharded daemon refuses, word for word the reference's
    refusal at the same flags (the shard-count case restores a port
    snapshot in both packages)."""
    ckpt = _fleet_snapshot(tmp_path) if "{ckpt}" in extra else ""
    argv = ["--shards", "2", "--capacity", "1024", "--no-fleet-obs"] + [
        a.format(tmp=tmp_path, ckpt=ckpt) for a in extra]
    args = example.build_parser().parse_args(["--platform", "cpu"] + argv)
    with pytest.raises(SystemExit) as got:
        example.build_app(args)
    ref_args = ref_example.build_parser().parse_args(
        ["--platform", "cpu"] + argv)
    with pytest.raises(SystemExit) as want:
        ref_example.build_app(ref_args)
    assert str(got.value) == str(want.value) == message


# ---------------------------------------------------------------------------
# tracegen
# ---------------------------------------------------------------------------


def _run_captured(fn, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ok = fn(**kw)
    return ok, out.getvalue().splitlines()


@pytest.mark.parametrize("memory", [False, True], ids=["device", "memory"])
def test_port_tracegen_run_matches_reference(memory):
    ok, lines = _run_captured(tracegen.run, n_traces=3, max_depth=4,
                              device="cpu", memory_store=memory)
    want_ok, want = _run_captured(ref_tracegen.run, n_traces=3, max_depth=4,
                                  use_tpu=not memory)
    assert ok is True and want_ok is True
    assert lines == want and lines[-1].endswith("-> OK")
    assert tracegen.run(n_traces=3, max_depth=4, device="cpu",
                        verbose=False, memory_store=memory) is True
