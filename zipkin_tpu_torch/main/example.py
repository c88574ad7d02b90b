"""All-in-one daemon: collector + device store + query + HTTP API.

Usage:
    python -m zipkin_tpu_torch.main.example --port 9411 [--seed-traces 10]
        [--sample-rate 1.0] [--adaptive-target N] [--checkpoint DIR]
        [--memory-store] [--platform cpu]

    python -m zipkin_tpu_torch.main.example --wal-dir DIR --ship-port 9412
    python -m zipkin_tpu_torch.main.example --follow HOST:9412
        [--follow-mode replica|standby] [--checkpoint DIR]

The port's copy of ``zipkin_tpu/main/example.py``: the same flags and
defaults, on the port's modules. The device store lives on the card
(CUDA) unless ``--platform cpu`` puts it on the CPU; without a card the
daemon raises rather than fall back. ``--ship-port`` serves the WAL to
replication followers; ``--follow`` runs a follower instead of a
collector: a warm standby (a device store, on the card like a primary's,
replaying every shipped record through the ingest step's kernels) or a
device-free replica (host-only by design). ``--shards`` is not ported
yet and refuses with a ``SystemExit`` naming the ROADMAP item it waits
for.

Reference shape: zipkin-example's Main (scribe receiver + store + query
+ web in one process) and zipkin-deployment-collector's sampler wiring.
"""

from __future__ import annotations

import argparse
import signal
import threading
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9411)
    p.add_argument("--scribe-port", type=int, default=9410,
                   help="framed-thrift Scribe.Log TCP port (0 disables)")
    p.add_argument("--memory-store", action="store_true",
                   help="use the in-memory reference store instead of "
                        "the device store")
    p.add_argument("--shards", type=int, default=0,
                   help="serve from an N-shard sharded store (0 = "
                        "single-device store); not ported yet: any "
                        "other value refuses (ROADMAP Queue 1, item 6)")
    p.add_argument("--capacity", type=int, default=1 << 16,
                   help="span ring capacity (device store)")
    p.add_argument("--layout", default="ring",
                   choices=("ring", "paged"),
                   help="span-plane layout: 'ring' = the FIFO ring "
                        "(default); 'paged' = fixed-size device pages "
                        "with per-trace chaining and LRW page reclaim, "
                        "so one hot 10k-span trace can't evict a "
                        "thousand cold 1-span traces "
                        "(docs/STORAGE_TIERS.md; echoed at /vars/layout)")
    p.add_argument("--page-rows", type=int, default=128,
                   help="rows per page for --layout paged (power of "
                        "two dividing --capacity; echoed at "
                        "/vars/pageRows)")
    p.add_argument("--batch-spans", type=int, default=0,
                   help="ingest batch escalation: max spans per device "
                        "launch (0 = the store's legacy 4096 default; "
                        "the ring guards still clamp to capacity/2)")
    p.add_argument("--use-pallas", action="store_true",
                   help="route the ingest step's scatter-adds, the "
                        "index arena's claim and write, and the paged "
                        "trace gather through the hand-written CUDA "
                        "kernels (ops/kernels.py) instead of plain torch "
                        "ops; the active path is reported in "
                        "counters()/metrics (scatter_path_pallas)")
    p.add_argument("--rank-path", default="auto",
                   choices=("auto", "argsort", "counting"),
                   help="index-write FIFO rank implementation without "
                        "the kernels (both are bitwise-identical; auto "
                        "takes the argsort rank, as the reference does "
                        "off the TPU)")
    p.add_argument("--window-seconds", type=int, default=60,
                   help="windowed-analytics time-bucket width for the "
                        "(service × time) Moments-sketch arena behind "
                        "/api/windowed_quantiles, /api/slo_burn and "
                        "/api/latency_heatmap (0 disables the arena; "
                        "echoed at /vars/windowSeconds)")
    p.add_argument("--window-buckets", type=int, default=64,
                   help="windowed-analytics ring length: retention is "
                        "window_seconds × window_buckets of cells per "
                        "service; stale slots self-clear on reuse "
                        "(echoed at /vars/windowBuckets)")
    p.add_argument("--sample-rate", type=float, default=1.0)
    p.add_argument("--adaptive-target", type=float, default=0.0,
                   help="target stored spans/minute; 0 disables adaptive")
    p.add_argument("--queue-max", type=int, default=500)
    p.add_argument("--queue-workers", type=int, default=10)
    p.add_argument("--no-self-trace-ingest", action="store_true",
                   help="disable the per-ingest-step zipkin-tpu self "
                        "spans (API-request self-tracing stays on)")
    p.add_argument("--no-fleet-obs", action="store_true",
                   help="disable the fleet-observability surface: "
                        "batch-lineage tracing (WAL-stamped causal "
                        "spans), metrics federation (/metrics?fleet=1, "
                        "/api/fleet), and the stall watchdog behind "
                        "/api/health + /debug/events")
    p.add_argument("--lineage-sample-every", type=int, default=0,
                   help="trace 1-in-N launch units end-to-end through "
                        "WAL append → fsync (0 = the default 64; 1 "
                        "traces every unit — bench/debug only)")
    p.add_argument("--cold-tier", action="store_true",
                   help="capture ring evictions into the compressed "
                        "segment archive and federate queries across "
                        "hot + cold (store/archive; single-device "
                        "stores only)")
    p.add_argument("--pipeline-depth", type=int, default=0,
                   help="pipelined ingest: overlap host encode + H2D "
                        "staging with device compute behind a bounded "
                        "prefetch queue of this depth (0 = serial "
                        "write path)")
    p.add_argument("--capture-backlog", type=int, default=4,
                   help="cold-tier async sealer: bound on pulled-but-"
                        "unsealed eviction capture windows; a full "
                        "backlog is the only way capture can stall "
                        "ingest (0 = seal inline on the write path)")
    p.add_argument("--wal-dir", default=None,
                   help="write-ahead log dir: journal every ingest "
                        "batch before commit, replay the tail at boot, "
                        "and switch the scribe receiver to "
                        "ack-after-durable-append")
    p.add_argument("--wal-fsync", default="interval",
                   choices=("batch", "interval", "off"),
                   help="WAL fsync policy: per-batch, group-commit "
                        "interval (default), or off (page-cache only)")
    p.add_argument("--wal-fsync-interval", type=float, default=0.05,
                   help="group-commit fsync cadence in seconds "
                        "(--wal-fsync interval)")
    p.add_argument("--wal-segment-bytes", type=int, default=64 << 20,
                   help="roll WAL segment files at this size; whole "
                        "segments are deleted once a checkpoint "
                        "covers them")
    p.add_argument("--wal-retain-bytes", type=int, default=0,
                   help="shipping retention floor: keep at least this "
                        "many newest WAL bytes on disk even when a "
                        "checkpoint covers them, so reconnecting "
                        "followers catch up from the log instead of "
                        "re-anchoring (0 = truncate everything "
                        "covered; registered follower cursors always "
                        "pin regardless)")
    p.add_argument("--ship-port", type=int, default=0,
                   help="serve sealed WAL records to replication "
                        "followers on this framed-TCP port (0 "
                        "disables; requires --wal-dir)")
    p.add_argument("--follow", default=None, metavar="HOST:PORT",
                   help="run as a replication follower of the primary "
                        "at HOST:PORT instead of a collector daemon: "
                        "no ingest ports open, reads serve from the "
                        "replicated store, staleness is exposed at "
                        "/api/replication")
    p.add_argument("--follow-mode", default="replica",
                   choices=("replica", "standby"),
                   help="follower role: 'replica' = device-free read "
                        "replica (SketchMirror + cold segments on the "
                        "host, no device); 'standby' = full device "
                        "store (on --platform's device) replaying "
                        "through the normal commit body, ready for "
                        "failover")
    p.add_argument("--follow-poll-ms", type=float, default=20.0,
                   help="follower fetch-poll cadence when the primary "
                        "has nothing new (each fetch is also the ack "
                        "that advances the primary's retention pin)")
    p.add_argument("--follower-name", default=None,
                   help="stable follower identity for the primary's "
                        "cursor registry (default: <mode>-<hostname> — "
                        "STABLE across restarts, so a restarted "
                        "follower reuses its retention pin instead of "
                        "leaking a dead one; set explicitly when "
                        "running several same-mode followers per host)")
    p.add_argument("--query-window-ms", type=float, default=None,
                   help="resident query executor micro-batch window "
                        "(ms): how long an idle-entry request waits "
                        "for company before its coalesced device "
                        "launch (default: 2 ms on device stores, 0 on "
                        "the memory store; runtime-adjustable via "
                        "/vars/queryWindowMs)")
    p.add_argument("--seed-traces", type=int, default=0,
                   help="generate N synthetic traces at startup")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir: restore at boot, save on exit "
                        "and every --checkpoint-interval seconds")
    p.add_argument("--checkpoint-interval", type=float, default=300.0)
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="device of the store: cuda (the default; raises "
                        "without a card) or cpu")
    return p


def refuse_unported(args) -> None:
    """SystemExit for the flags whose modules the port does not have
    yet, naming the ROADMAP item each waits for; never ignore them."""
    if args.shards:
        raise SystemExit(
            "--shards: the sharded store and its group-commit log are "
            "not ported yet (ROADMAP Queue 1, item 6: sharding)")


def build_app(args):
    from zipkin_tpu_torch.api.server import ApiServer
    from zipkin_tpu_torch.ingest.collector import Collector
    from zipkin_tpu_torch.query.service import QueryService
    from zipkin_tpu_torch.sampler.adaptive import AdaptiveConfig
    from zipkin_tpu_torch.sampler.core import Sampler

    refuse_unported(args)
    if args.ship_port and not args.wal_dir:
        # Refused before anything is built (the reference refuses once
        # the store is up; the message is its own).
        raise SystemExit("--ship-port requires --wal-dir (sealed "
                         "WAL records are what gets shipped)")
    if args.checkpoint and args.memory_store:
        raise SystemExit(
            "--checkpoint requires a device store (the in-memory "
            "reference store has no snapshot support)"
        )
    if args.layout != "ring" and args.memory_store:
        raise SystemExit(
            "--layout paged requires a device store (the "
            "in-memory reference store has no span planes)"
        )
    device = args.platform or "cuda"
    store = None
    if args.checkpoint:
        from zipkin_tpu_torch import checkpoint

        if checkpoint.exists(args.checkpoint):
            # exists() includes the .old mid-swap fallback — booting
            # FRESH after a crashed save would replay the WAL tail
            # against empty dictionaries (lineage error at best,
            # silent loss of checkpoint-covered spans at worst).
            # config_defaults: a pre-rev-14 snapshot (no window keys)
            # restores with an EMPTY window arena at the flag
            # geometry; a rev-14+ snapshot's saved geometry wins, and
            # so does its capacity and kernel choice over the flags.
            stats = {}
            store = checkpoint.load(args.checkpoint, device=device,
                                    config_defaults={
                                        "window_seconds": args.window_seconds,
                                        "window_buckets": args.window_buckets,
                                    }, stats=stats)
            print(f"checkpoint: restored {args.checkpoint} in "
                  f"{stats['total_s']}s")
    if store is None:
        if args.memory_store:
            from zipkin_tpu_torch.store.memory import InMemorySpanStore

            store = InMemorySpanStore()
            # Exact-scan windowed analytics use the same bucket width
            # the device arena would (0 keeps the 60s default — the
            # scan path has no arena to disable).
            if args.window_seconds > 0:
                store.window_seconds = args.window_seconds
        else:
            from zipkin_tpu_torch.store.device import StoreConfig
            from zipkin_tpu_torch.store.torch_store import TorchSpanStore

            store = TorchSpanStore(StoreConfig(
                capacity=args.capacity,
                batch_spans=args.batch_spans,
                use_pallas=args.use_pallas,
                rank_path=args.rank_path,
                window_seconds=args.window_seconds,
                window_buckets=args.window_buckets,
                layout=args.layout,
                page_rows=args.page_rows,
            ), device=device)
    if args.cold_tier:
        if hasattr(store, "archive"):
            # Restored tiered checkpoint: already wrapped, but the
            # daemon still wants compaction off the ingest write path.
            store.archive.start_compactor()
        else:
            if args.memory_store:
                raise SystemExit(
                    "--cold-tier requires the single-device store "
                    "(the in-memory reference store has no ring to "
                    "capture)"
                )
            from zipkin_tpu_torch.store.archive import TieredSpanStore

            store = TieredSpanStore(store, background_compaction=True)
    # The async capture sealer takes effect the first time a capture
    # window is pulled, so the knob just needs to be set before writes.
    hot = getattr(store, "hot", store)
    if hasattr(hot, "capture_backlog"):
        hot.capture_backlog = max(0, args.capture_backlog)
    if args.wal_dir:
        if not hasattr(hot, "attach_wal"):
            raise SystemExit(
                "--wal-dir requires a device store (the in-memory "
                "reference store has no journaled commit path)"
            )
        from zipkin_tpu_torch.wal import WriteAheadLog, replay_into

        wal = WriteAheadLog(
            args.wal_dir, fsync=args.wal_fsync,
            interval_s=args.wal_fsync_interval,
            segment_bytes=args.wal_segment_bytes,
            retain_bytes=args.wal_retain_bytes,
        )
        # Boot-time recovery: the checkpoint (restored above, or a
        # fresh store) is the base; every WAL record past its applied
        # sequence replays through the normal ingest path — capture,
        # sealing, and sweep cadence included — BEFORE the collector's
        # pipeline starts and the ports open.
        hot.attach_wal(wal)
        stats = replay_into(store, wal)
        if stats["replayed_records"]:
            print(f"wal: replayed {stats['replayed_records']} records "
                  f"({stats['replayed_spans']} spans) in "
                  f"{stats['replay_s']}s")
    adaptive = (
        AdaptiveConfig(target_store_rate=args.adaptive_target)
        if args.adaptive_target > 0 else None
    )
    collector = Collector(
        store, sampler=Sampler(args.sample_rate), adaptive=adaptive,
        max_queue=args.queue_max, concurrency=args.queue_workers,
        self_trace=not args.no_self_trace_ingest,
        pipeline_depth=args.pipeline_depth,
    )
    tracker = None
    watchdog = None
    recorder = None
    if not args.no_fleet_obs:
        from zipkin_tpu_torch import obs
        from zipkin_tpu_torch.obs import fleet as fobs

        reg = obs.default_registry()
        # Batch-lineage tracing: spans land through store.apply so they
        # live in the system's own store (and ride the WAL/ship path
        # like any span). attach_lineage is a no-op journal-wise until
        # a WAL is attached.
        tracker = fobs.LineageTracker(
            store.apply, registry=reg,
            sample_every=args.lineage_sample_every or None)
        if hasattr(hot, "attach_lineage"):
            hot.attach_lineage(tracker)
        disp = getattr(hot, "dispatcher", None)
        if disp is not None:
            disp.span_sink = tracker
        recorder = fobs.FlightRecorder()
        watchdog = fobs.Watchdog(recorder=recorder, registry=reg)
        watchdog.add_probe("pipeline", fobs.pipeline_stall_probe(hot))
        watchdog.add_probe("sealer", fobs.sealer_backlog_probe(hot))
        wal_obj = getattr(store, "wal", None)
        if wal_obj is not None and hasattr(wal_obj, "sync_error"):
            watchdog.add_probe("wal_fsync",
                               fobs.fsync_parked_probe(wal_obj))
        if disp is not None:
            watchdog.add_probe("dispatcher",
                               fobs.dispatcher_stuck_probe(disp))
    shipper = None
    if args.ship_port:
        from zipkin_tpu_torch.replicate import WalShipper

        shipper = WalShipper(store, tracker=tracker)
        if watchdog is not None:
            def _worst_follower_lag():
                st = shipper.status()
                lags = [f["lagRecords"]
                        for f in st.get("followers", {}).values()]
                return {"lagRecords": max(lags) if lags else 0}

            watchdog.add_probe(
                "follower_lag",
                fobs.follower_lag_probe(_worst_follower_lag))
    fleet = None
    if not args.no_fleet_obs:
        fleet = fobs.FleetObs(
            role="primary", registry=reg,
            tracker=tracker, watchdog=watchdog, recorder=recorder,
            remote_sources=(shipper.fleet_sources
                            if shipper is not None else None),
            replication=(shipper.status
                         if shipper is not None else None),
        )
    window_s = (args.query_window_ms / 1000.0
                if args.query_window_ms is not None else None)
    api = ApiServer(
        QueryService(store, coalesce_window_s=window_s), collector,
        replication=shipper.status if shipper is not None else None,
        fleet=fleet,
    )
    return store, collector, api, shipper


def build_follower_app(args):
    """Follower daemon (--follow): connect to the primary's ship port,
    build the local store from the primary's config, and serve the
    read API from it — no ingest ports, no collector. A standby's store
    lives on ``--platform``'s device (the card by default; it raises
    without one); a replica's on the host, by design. Returns
    (store, follower, api)."""
    import socket as _socket

    from zipkin_tpu_torch.api.server import ApiServer
    from zipkin_tpu_torch.query.service import QueryService
    from zipkin_tpu_torch.replicate import (
        Follower,
        ReplicaTarget,
        ShipClient,
        StandbyTarget,
    )
    from zipkin_tpu_torch.replicate.protocol import config_from_dict

    refuse_unported(args)
    host, _, port = args.follow.rpartition(":")
    if not host or not port.isdigit():
        raise SystemExit(f"--follow wants HOST:PORT, got {args.follow!r}")
    # No PID in the default: the name keys the primary's retention pin,
    # and a per-process name would leak one pinned cursor per restart
    # (truncation blocked at the dead cursor forever).
    name = args.follower_name or (
        f"{args.follow_mode}-{_socket.gethostname()}")
    client = ShipClient(host, int(port), name, mode=args.follow_mode)
    hello = client.connect()
    config = config_from_dict(hello["config"])
    try:
        if args.follow_mode == "standby":
            from zipkin_tpu_torch.store.torch_store import TorchSpanStore

            device = args.platform or "cuda"
            store = None
            if args.checkpoint:
                from zipkin_tpu_torch import checkpoint

                # Anchor bootstrap for a standby is a CHECKPOINT of the
                # primary lineage: the shipped tail replays on top of it
                # exactly like crash recovery would.
                if checkpoint.exists(args.checkpoint):
                    stats = {}
                    store = checkpoint.load(args.checkpoint,
                                            device=device, stats=stats)
                    print(f"checkpoint: restored {args.checkpoint} in "
                          f"{stats['total_s']}s")
            if store is None:
                store = TorchSpanStore(config, device=device)
            target = StandbyTarget(store)
        else:
            from zipkin_tpu_torch.store.replica import ReplicaSpanStore

            store = ReplicaSpanStore(config)
            target = ReplicaTarget(store)
    except BaseException:
        # No store (no card for a standby, a bad snapshot): the
        # connection to the primary goes too.
        client.close()
        raise
    lineage = None
    fleet = None
    if not args.no_fleet_obs:
        from zipkin_tpu_torch import obs
        from zipkin_tpu_torch.obs import fleet as fobs

        reg = obs.default_registry()
        lineage = fobs.FollowerLineage(name, mode=args.follow_mode,
                                       registry=reg)
    follower = Follower(target, client,
                        poll_interval_s=args.follow_poll_ms / 1000.0,
                        lineage=lineage)
    if lineage is not None:
        recorder = fobs.FlightRecorder()
        watchdog = fobs.Watchdog(recorder=recorder, registry=reg)
        watchdog.add_probe("replication_lag",
                           fobs.follower_lag_probe(follower.status))
        fleet = fobs.FleetObs(
            role=args.follow_mode, name=name, registry=reg,
            follower=lineage, watchdog=watchdog, recorder=recorder,
            replication=follower.status,
        )
    window_s = (args.query_window_ms / 1000.0
                if args.query_window_ms is not None else None)
    api = ApiServer(
        QueryService(store, coalesce_window_s=window_s), None,
        replication=follower.status,
        fleet=fleet,
    )
    return store, follower, api


def seed(collector, n_traces: int) -> None:
    from zipkin_tpu_torch.tracegen import generate_traces

    for spans in generate_traces(n_traces=n_traces):
        collector.accept(spans)
    collector.flush()


def start_servers(args, store, collector, api, shipper=None):
    """Open the HTTP API on ``--port``, the WAL-ship endpoint on
    ``--ship-port`` when ``shipper`` is given, and, unless
    ``--scribe-port`` is 0, the Scribe receiver, each served from a
    thread of its own. Returns (http server, scribe server or None,
    ship server or None)."""
    from zipkin_tpu_torch.api.server import (make_server,
                                             serve_forever_in_thread)

    server = make_server(api, args.host, args.port)
    serve_forever_in_thread(server)
    ship_srv = None
    if shipper is not None:
        from zipkin_tpu_torch.replicate import ShipServer

        ship_srv = ShipServer(shipper, args.host, args.ship_port)
        ship_srv.serve_in_thread()
    scribe_srv = None
    if args.scribe_port:
        from zipkin_tpu_torch.ingest.receiver import ScribeReceiver
        from zipkin_tpu_torch.ingest.scribe_server import ScribeServer

        # Ack contract: with a WAL, scribe's OK means "durably
        # appended" — the receiver processes synchronously through the
        # durable entries instead of acking from the async queue.
        if getattr(store, "wal", None) is not None:
            receiver = ScribeReceiver(
                collector.ingest_durable,
                process_thrift=collector.ingest_thrift_durable,
            )
        else:
            receiver = ScribeReceiver(
                collector.accept,
                process_thrift=collector.accept_thrift,
            )
        scribe_srv = ScribeServer(receiver, args.host, args.scribe_port)
        scribe_srv.serve_in_thread()
    return server, scribe_srv, ship_srv


def checkpoint_now(args, store) -> None:
    if args.checkpoint:
        from zipkin_tpu_torch import checkpoint

        checkpoint.save(store, args.checkpoint)


def serve_until(stop: threading.Event, args, store, collector) -> None:
    """The serving loop: the collector's control tick every second and a
    checkpoint every ``--checkpoint-interval`` seconds, until ``stop``
    is set."""
    last_ckpt = time.time()
    while not stop.is_set():
        stop.wait(1.0)
        collector.control_tick()
        if (args.checkpoint
                and time.time() - last_ckpt > args.checkpoint_interval):
            checkpoint_now(args, store)
            last_ckpt = time.time()


def shutdown(args, store, collector, api, servers, shipper=None) -> None:
    """Graceful-save ordering (docs/DURABILITY.md): stop intake first,
    then drain-pipeline → seal-barrier → WAL-fsync (collector.flush
    enforces that order), THEN checkpoint — so the snapshot's sealed
    frontier and applied WAL sequence cover everything accepted, and
    its success truncates the covered log segments. close() comes
    last."""
    import traceback

    server, scribe_srv, ship_srv = servers
    for srv in (scribe_srv, ship_srv):
        if srv is not None:
            srv.shutdown()
            srv.server_close()
    server.shutdown()
    server.server_close()
    try:
        collector.flush()
    except Exception:
        # A failed drain must not block the checkpoint — but it must
        # be SEEN.
        traceback.print_exc()
    try:
        checkpoint_now(args, store)
    except Exception:
        # A failed final save (disk full, suspect store) must not skip
        # the drain/fsync below: the WAL still covers what the snapshot
        # was meant to, so close() losing its final fsync would be the
        # only way to actually lose data here.
        traceback.print_exc()
    collector.close()
    if shipper is not None:
        shipper.close()
    if api.fleet is not None and api.fleet.tracker is not None:
        # Flush buffered lineage spans before the WAL's final fsync so
        # the self-trace tail is durable too.
        try:
            api.fleet.tracker.flush()
        except Exception:
            traceback.print_exc()
    wal = getattr(store, "wal", None)
    if wal is not None:
        wal.close()


def start_follower(args, follower, api):
    """Start the follower's fetch-apply thread and open the read API on
    ``--port`` (no ingest port). Returns the HTTP server."""
    from zipkin_tpu_torch.api.server import (make_server,
                                             serve_forever_in_thread)

    follower.start()
    server = make_server(api, args.host, args.port)
    serve_forever_in_thread(server)
    return server


def follow_until(stop: threading.Event, args, store, follower) -> None:
    """The follower's serving loop, until ``stop`` is set or the
    follower parks a terminal lineage error: a standby with
    ``--checkpoint`` snapshots every ``--checkpoint-interval`` seconds,
    as a primary does, and only then advances its retention ack."""
    can_checkpoint = args.follow_mode == "standby" and args.checkpoint
    last_ckpt = time.time()
    while not stop.is_set():
        stop.wait(1.0)
        err = follower.error()
        if err is not None and not follower.status()["connected"]:
            # Transient disconnects retry inside the loop; only a
            # terminal lineage error lands here with the thread
            # stopped.
            if follower._thread is None or not \
                    follower._thread.is_alive():
                print(f"follower stopped: {err!r}", flush=True)
                return
        if (can_checkpoint
                and time.time() - last_ckpt > args.checkpoint_interval):
            from zipkin_tpu_torch import checkpoint

            # Captured BEFORE the save: the snapshot covers at least
            # this frontier (records applied mid-save only push the
            # manifest higher), so acking it after a successful save is
            # always conservative.
            seq = follower.target.applied_seq()
            checkpoint.save(store, args.checkpoint)
            # The standby's retention ack is its CHECKPOINTED frontier
            # — only now may the primary truncate the covered records
            # (replicate/follow.StandbyTarget).
            follower.target.note_checkpointed(seq)
            last_ckpt = time.time()


def follower_shutdown(args, store, follower, api, server) -> None:
    """The follower's ordered shutdown: close the read API, stop the
    fetch-apply thread, then (a standby with ``--checkpoint``) save a
    final snapshot, and close the store last."""
    import traceback

    server.shutdown()
    server.server_close()
    follower.close()
    if args.follow_mode == "standby" and args.checkpoint:
        try:
            from zipkin_tpu_torch import checkpoint

            checkpoint.save(store, args.checkpoint)
        except Exception:
            traceback.print_exc()
    api.query.close()
    store.close()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    stop = threading.Event()

    def stop_on_signals():
        # SIGINT and SIGTERM share the graceful path: both land in the
        # ordered shutdown (a primary's drain → seal → WAL-fsync →
        # checkpoint) instead of an interpreter teardown mid-write.
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())

    if args.follow:
        store, follower, api = build_follower_app(args)
        server = start_follower(args, follower, api)
        print(f"zipkin-tpu {args.follow_mode} following {args.follow}, "
              f"serving reads on {args.host}:{args.port}", flush=True)
        stop_on_signals()
        try:
            follow_until(stop, args, store, follower)
        finally:
            follower_shutdown(args, store, follower, api, server)
        return
    store, collector, api, shipper = build_app(args)
    if args.seed_traces:
        seed(collector, args.seed_traces)
    servers = start_servers(args, store, collector, api, shipper)
    print(f"zipkin-tpu example serving on {args.host}:{args.port}"
          + (f" (scribe tcp :{args.scribe_port})" if servers[1] else "")
          + (f" (wal-ship tcp :{args.ship_port})" if servers[2] else ""),
          flush=True)
    stop_on_signals()
    try:
        serve_until(stop, args, store, collector)
    finally:
        shutdown(args, store, collector, api, servers, shipper)


if __name__ == "__main__":
    main()
