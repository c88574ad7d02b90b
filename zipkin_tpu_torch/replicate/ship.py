"""Primary-side WAL shipping: the log-structured replication feed.

``WalShipper`` serves three questions against a live primary store and
its attached WAL:

- ``fetch(follower, cursor, max_bytes)`` — the records past the
  follower's cursor, bounded by bytes, NEVER past the WAL's durable
  frontier (a follower must not apply what the primary could still
  lose to a crash). The cursor doubles as the ack: it advances the
  follower's retention pin (WriteAheadLog.register_cursor), so
  checkpoint truncation can never delete a segment the slowest
  registered follower still needs.

- ``anchor()`` — a bootstrap anchor for followers whose cursor
  precedes the log's first retained record: the primary's dictionary
  values, sketch-mirror arrays (≡ device aggregates, bitwise) and
  write clocks, captured under the store's read lock so they are
  exactly consistent with the applied WAL sequence. A device-free
  replica adopting it serves the whole sketch tier from genesis; its
  row/segment coverage starts at the anchor.

- ``status()`` — per-follower cursors and lag for /api/replication.

``ShipServer`` is the framed-TCP endpoint (the scribe server's
threading shape) speaking replicate/protocol.py.

The port's copy of ``zipkin_tpu/replicate/ship.py``. One difference of
mechanism: the port's store has no readers/writer lock; its commit
folds the sketch mirror and advances ``_wp`` and ``_wal_applied`` in
one ``_state_lock`` hold (``TorchSpanStore._commit_unit``), so the
anchor takes that lock for the same cut. Everything the shipper does is
host work: no piece here launches a kernel.
"""

from __future__ import annotations

import socketserver
import threading
import time
from typing import Dict, Optional

from zipkin_tpu_torch.replicate import protocol as P


class WalShipper:
    """See the module docstring. One instance per primary process."""

    def __init__(self, store, wal=None, registry=None, tracker=None):
        from zipkin_tpu_torch import obs

        self.store = store
        self.hot = getattr(store, "hot", store)
        self.wal = wal if wal is not None else self.hot.wal
        if self.wal is None:
            raise ValueError(
                "WAL shipping needs a WriteAheadLog attached to the "
                "primary store (--wal-dir)")
        # Batch-lineage tracker (obs.fleet.LineageTracker): fetch()
        # reports each shipped sampled record ("ship" child span) and
        # stitches the follower's backhauled apply spans into the
        # primary's own trace store. None = tracing off.
        self.tracker = tracker
        # Follower bookkeeping only — WAL calls happen OUTSIDE the
        # hold (the cursor pin itself lives in the WAL, under its own
        # condition).
        self._lock = threading.Lock()  # lock-order: 79 ship-followers
        self._followers: Dict[str, dict] = {}  # guarded-by: _lock
        # Latest pushed registry snapshot per follower (the FETCH
        # "metrics" ride-along) — the federation's remote sources.
        self._follower_metrics: Dict[str, dict] = {}  # guarded-by: _lock
        reg = registry or obs.default_registry()
        self._registry = reg
        self.c_bytes = reg.register(obs.Counter(
            "zipkin_replication_shipped_bytes_total",
            "WAL record bytes shipped to followers"))
        self.c_records = reg.register(obs.Counter(
            "zipkin_replication_shipped_records_total",
            "WAL records shipped to followers"))
        self.c_anchors = reg.register(obs.Counter(
            "zipkin_replication_anchors_total",
            "Bootstrap anchors served to followers"))
        self.g_followers = reg.register(obs.Gauge(
            "zipkin_replication_followers",
            "Followers with a registered shipping cursor",
            fn=lambda: float(len(self._followers))))
        self.g_min_lag = reg.register(obs.Gauge(
            "zipkin_replication_max_follower_lag_records",
            "Durable records not yet fetched by the furthest-behind "
            "follower (0 = all followers current)",
            fn=self._max_lag))

    def _max_lag(self) -> float:
        durable = self.wal.durable_seq
        with self._lock:
            cursors = [f["cursor"] for f in self._followers.values()]
        if not cursors:
            return 0.0
        return float(max(0, durable - min(cursors)))

    # -- protocol bodies ------------------------------------------------

    def hello(self, follower: str, mode: str) -> dict:
        self.wal.register_cursor(follower)
        now = time.time()
        with self._lock:
            self._followers.setdefault(follower, {
                "cursor": 0, "mode": mode, "connected_at": now,
                "bytes": 0, "records": 0,
            })["mode"] = mode
        return {
            "proto": P.PROTO_VERSION,
            "config": P.config_to_dict(self.hot.config),
            "last_seq": self.wal.last_seq,
            "durable_seq": self.wal.durable_seq,
            "first_seq": self.wal.first_available_seq(),
        }

    def fetch(self, follower: str, cursor: int, max_bytes: int,
              ack: Optional[int] = None, spans=None, metrics=None):
        """(records, last_seq, durable_seq) past ``cursor`` — or None
        when the cursor precedes the retained log (anchor needed).
        ``ack`` is the follower's LOCALLY-DURABLE frontier and is what
        moves its retention pin (defaults to the cursor — right for a
        replica, which re-anchors after total loss; a warm standby
        acks its checkpointed frontier so a crash can always re-replay
        the gap from the log).

        ``spans``/``metrics`` are the FETCH frame's observability
        ride-alongs (replicate/protocol.py): backhauled follower apply
        spans get stitched into the primary's lineage trace, and the
        pushed registry snapshot becomes the follower's column of the
        federated ``/metrics?fleet=1`` view."""
        cursor = max(0, int(cursor))
        ack = cursor if ack is None else max(0, int(ack))
        self.wal.advance_cursor(follower, ack)
        trk = self.tracker
        if trk is not None and spans:
            trk.ingest_remote_spans(follower, spans)
        if metrics is not None:
            with self._lock:
                self._follower_metrics[follower] = metrics
        first = self.wal.first_available_seq()
        if cursor + 1 < first:
            return None
        durable = self.wal.durable_seq
        records = []
        nbytes = 0
        for seq, payload in self.wal.replay(cursor):
            if seq > durable:
                break
            records.append((seq, payload))
            nbytes += len(payload)
            if nbytes >= max_bytes:
                break
        if trk is not None:
            for seq, _payload in records:
                trk.note_shipped(seq, follower)
        self.c_records.inc(len(records))
        self.c_bytes.inc(nbytes)
        with self._lock:
            f = self._followers.get(follower)
            if f is not None:
                f["cursor"] = max(f["cursor"], cursor)
                f["ack"] = max(f.get("ack", 0), ack)
                f["bytes"] += nbytes
                f["records"] += len(records)
        return records, self.wal.last_seq, durable

    def anchor(self) -> bytes:
        """Serialize a bootstrap anchor (see module docstring). The
        mirror snapshot, the write position and the applied sequence
        are taken under ONE ``_state_lock`` hold — the hold in which a
        commit folds its delta and advances both clocks — so no commit
        can land between them: a record is either inside the anchor or
        past its ``applied_seq``, never both."""
        from zipkin_tpu_torch.wal.record import DICT_NAMES, dump_value

        hot = self.hot
        hot.ensure_sketch_mirror()  # warm it OUTSIDE the hold
        with hot._state_lock:
            arrays = hot.sketch_mirror.arrays()
            applied = int(hot._wal_applied)
            wp = int(hot._wp)
        dict_values = {
            name: [dump_value(v)
                   for v in getattr(hot.dicts, name).values()]
            for name in DICT_NAMES
        }
        self.c_anchors.inc()
        return P.encode_anchor(applied, wp,
                               P.config_to_dict(hot.config),
                               dict_values, list(arrays))

    def drop_follower(self, follower: str) -> None:
        """Release a decommissioned follower's retention pin (an
        operator action — a mere disconnect keeps the pin so the
        follower can reconnect without an anchor)."""
        self.wal.drop_cursor(follower)
        with self._lock:
            self._followers.pop(follower, None)
            self._follower_metrics.pop(follower, None)

    def fleet_sources(self):
        """The federation's remote half: one ((label, value), ...)
        + registry-snapshot pair per follower that has pushed metrics
        (obs.fleet.render_federated's ``sources`` shape, minus the
        primary's own row — FleetObs prepends that)."""
        with self._lock:
            snaps = sorted(self._follower_metrics.items())
        return [
            ((("role", "follower"), ("follower", name)), snap)
            for name, snap in snaps
        ]

    def status(self) -> dict:
        durable = self.wal.durable_seq
        with self._lock:
            followers = {
                name: {
                    "mode": f["mode"],
                    "cursor": f["cursor"],
                    "ackSeq": f.get("ack", f["cursor"]),
                    "lagRecords": max(0, durable - f["cursor"]),
                    "shippedBytes": f["bytes"],
                    "shippedRecords": f["records"],
                }
                for name, f in self._followers.items()
            }
        return {
            "role": "primary",
            "lastSeq": self.wal.last_seq,
            "durableSeq": durable,
            "firstSeq": self.wal.first_available_seq(),
            "followers": followers,
        }

    def close(self) -> None:
        for m in (self.c_bytes, self.c_records, self.c_anchors,
                  self.g_followers, self.g_min_lag):
            if self._registry.get(m.name) is m:
                self._registry.unregister(m.name)


class _ShipHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        import socket

        sock = self.request
        sock.settimeout(self.server.io_timeout_s)  # type: ignore[attr-defined]
        shipper: WalShipper = self.server.shipper  # type: ignore[attr-defined]
        follower = None
        try:
            while True:
                msg = P.read_msg(sock)
                if msg is None:
                    return
                msg_type, meta, _blob = msg
                if msg_type == P.HELLO:
                    follower = str(meta.get("follower", "anonymous"))
                    out = P.encode_msg(
                        P.HELLO_OK,
                        shipper.hello(follower,
                                      str(meta.get("mode", "replica"))))
                elif msg_type == P.FETCH:
                    if follower is None:
                        out = P.encode_msg(
                            P.ERR, {"error": "FETCH before HELLO"})
                    else:
                        ack = meta.get("ack")
                        got = shipper.fetch(
                            follower, int(meta.get("cursor", 0)),
                            int(meta.get("max_bytes", 8 << 20)),
                            ack=None if ack is None else int(ack),
                            spans=meta.get("spans"),
                            metrics=meta.get("metrics"))
                        if got is None:
                            out = P.encode_msg(P.NEED_ANCHOR, {
                                "first_seq":
                                    shipper.wal.first_available_seq(),
                            })
                        else:
                            records, last, durable = got
                            out = P.encode_records(records, last,
                                                   durable)
                elif msg_type == P.ANCHOR:
                    out = shipper.anchor()
                else:
                    out = P.encode_msg(
                        P.ERR, {"error": f"unknown msg {msg_type}"})
                # encode_msg frames include their own length word.
                sock.sendall(out)
        except (P.ShipProtocolError, socket.timeout, ConnectionError,
                OSError):
            return


class ShipServer(socketserver.ThreadingTCPServer):
    """Framed-TCP WAL-ship endpoint bound to (host, port)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, shipper: WalShipper, host: str = "0.0.0.0",
                 port: int = 9412, io_timeout_s: float = 60.0):
        super().__init__((host, port), _ShipHandler)
        self.shipper = shipper
        self.io_timeout_s = io_timeout_s

    def serve_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             name="zipkin-ship-server")
        t.start()
        return t
