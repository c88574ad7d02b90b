"""Follower: pull shipped WAL records and apply them locally.

One ``Follower`` thread drives one target from one primary:

- **device-free replica** (``ReplicaTarget``) — applies records into a
  ``ReplicaSpanStore`` (store/replica.py): sketch mirror + cold
  segments, no device. Bootstraps from a primary anchor when its cursor
  precedes the retained log.

- **warm standby** (``StandbyTarget``) — applies records through a
  full device store's NORMAL commit body (wal.apply_record_into — the
  same code crash recovery runs), so the standby's device state is
  the primary's at every applied sequence (bitwise, but for the three
  float32 moment leaves on the card: stated tolerance 2,
  ``testing/crash.py``). ``promote()`` detaches the follower and
  returns the store ready to own writes (attach a fresh WAL, open
  ports); the promote latency is the failover RTO.

The fetch loop is pull-based over replicate/protocol.py: each FETCH
carries the cursor (= the ack that advances the primary's retention
pin) and returns durable records only. Disconnects back off and
reconnect; a follower that is AHEAD of the primary's log (the primary
lost un-durable tail the follower somehow applied — impossible under
the durable-only ship rule, so: wrong primary or wiped log) parks a
lineage error instead of diverging silently.

The port's copy of ``zipkin_tpu/replicate/follow.py``. A standby's
store is a ``TorchSpanStore`` (on the card unless its caller put it on
the CPU), so every applied record runs the ingest step's CUDA kernels
(the flat histogram, the arena claim and write) exactly as the
primary's commit of it did; a replica touches no device.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from zipkin_tpu_torch.replicate import protocol as P
from zipkin_tpu_torch.wal.record import WalReplayError


class ShipClient:
    """Minimal blocking client for the ship endpoint."""

    def __init__(self, host: str, port: int, follower: str,
                 mode: str = "replica", timeout_s: float = 30.0):
        self.addr = (host, port)
        self.follower = follower
        self.mode = mode
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self.hello_meta: Optional[dict] = None

    def connect(self) -> dict:
        self.close()
        self._sock = socket.create_connection(self.addr, self.timeout_s)
        self._sock.settimeout(self.timeout_s)
        self._sock.sendall(P.encode_msg(P.HELLO, {
            "proto": P.PROTO_VERSION, "follower": self.follower,
            "mode": self.mode,
        }))
        msg = P.read_msg(self._sock)
        if msg is None or msg[0] != P.HELLO_OK:
            raise P.ShipProtocolError("ship HELLO failed")
        self.hello_meta = msg[1]
        return msg[1]

    def _roundtrip(self, frame: bytes):
        if self._sock is None:
            self.connect()
        self._sock.sendall(frame)
        msg = P.read_msg(self._sock)
        if msg is None:
            raise ConnectionError("ship server closed connection")
        return msg

    def fetch(self, cursor: int, max_bytes: int = 8 << 20,
              ack: Optional[int] = None,
              extra_meta: Optional[dict] = None):
        """(records, last_seq, durable_seq) or None when the primary
        says the cursor needs an anchor bootstrap. ``ack`` moves the
        retention pin (defaults to cursor server-side).
        ``extra_meta`` merges fleet-observability ride-alongs into the
        FETCH frame (``spans`` backhaul, ``metrics`` snapshot — see
        replicate/protocol.py); an older primary ignores them."""
        meta = {"cursor": int(cursor), "max_bytes": int(max_bytes)}
        if ack is not None:
            meta["ack"] = int(ack)
        if extra_meta:
            meta.update(extra_meta)
        msg_type, meta, blob = self._roundtrip(
            P.encode_msg(P.FETCH, meta))
        if msg_type == P.NEED_ANCHOR:
            return None
        if msg_type != P.RECORDS:
            raise P.ShipProtocolError(
                f"unexpected ship reply {msg_type}: {meta}")
        return P.decode_records(meta, blob)

    def anchor(self):
        msg_type, meta, blob = self._roundtrip(
            P.encode_msg(P.ANCHOR, {}))
        if msg_type != P.ANCHOR_OK:
            raise P.ShipProtocolError(
                f"unexpected anchor reply {msg_type}: {meta}")
        return P.decode_anchor(meta, blob)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class ReplicaTarget:
    """Apply shipped records into a device-free ReplicaSpanStore."""

    def __init__(self, store):
        self.store = store

    def applied_seq(self) -> int:
        return self.store.applied_seq()

    def ack_seq(self) -> int:
        """The retention pin the primary may truncate up to. A replica
        re-anchors after total loss BY DESIGN (its state is memory),
        so its applied frontier is its ack."""
        return self.store.applied_seq()

    def apply(self, seq: int, payload: bytes) -> int:
        return self.store.apply_record(seq, payload)

    def adopt_anchor(self, anchor) -> None:
        applied_seq, wp, _config, dict_values, arrays = anchor
        self.store.adopt_anchor(applied_seq, wp, dict_values, arrays)


class StandbyTarget:
    """Apply shipped records through a full device store's normal
    commit body — the warm-standby half of failover."""

    def __init__(self, store):
        from zipkin_tpu_torch.wal.recovery import pin_tids_of

        self.store = store
        self.hot = getattr(store, "hot", store)
        self._pin_tids = pin_tids_of(self.hot)
        # The DURABLE frontier this standby can recover to on its own
        # (its restored checkpoint; 0 for a from-genesis standby).
        # Acking the volatile applied frontier instead would let the
        # primary truncate records a crashed standby still needs —
        # and a standby cannot anchor-bootstrap out of that hole.
        self._ckpt_applied = int(self.hot._wal_applied)

    def applied_seq(self) -> int:
        return int(self.hot._wal_applied)

    def ack_seq(self) -> int:
        return self._ckpt_applied

    def note_checkpointed(self, seq: Optional[int] = None) -> None:
        """Advance the durable ack after a successful LOCAL checkpoint
        save (the follower daemon calls this; without checkpoints the
        standby pins the primary's log at its bootstrap frontier —
        bound it with --wal-retain-bytes or run checkpoints)."""
        seq = self.applied_seq() if seq is None else int(seq)
        self._ckpt_applied = max(self._ckpt_applied, seq)

    def apply(self, seq: int, payload: bytes) -> int:
        from zipkin_tpu_torch.wal.recovery import apply_record_into

        if seq <= self.applied_seq():
            return 0  # reconnect overlap
        return apply_record_into(self.hot, seq, payload,
                                 self._pin_tids)

    def adopt_anchor(self, anchor) -> None:
        raise WalReplayError(
            "warm standby cannot bootstrap from a sketch anchor — "
            "restore a checkpoint of the primary (or start both from "
            "genesis) so the WAL tail covers the gap")


class Follower:
    """The standing fetch-apply loop (see module docstring)."""

    def __init__(self, target, client: ShipClient,
                 poll_interval_s: float = 0.02,
                 max_fetch_bytes: int = 8 << 20,
                 registry=None, lineage=None):
        from zipkin_tpu_torch import obs

        self.target = target
        self.client = client
        # Fleet-observability half (obs.fleet.FollowerLineage): times
        # each record's apply against its shipped commit timestamp
        # (lag seconds), buffers apply spans for the FETCH backhaul,
        # and throttles metric snapshots for federation. None = the
        # pre-r17 wire behavior, byte for byte.
        self.lineage = lineage
        self.poll_interval_s = max(1e-3, float(poll_interval_s))
        self.max_fetch_bytes = int(max_fetch_bytes)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()  # lock-order: 80 follower-stats
        self._primary_durable = 0  # guarded-by: _lock
        self._primary_last = 0  # guarded-by: _lock
        self._connected = False  # guarded-by: _lock
        self._fetched_bytes = 0  # guarded-by: _lock
        self._applied_records = 0  # guarded-by: _lock
        self._last_apply_ts = 0.0  # guarded-by: _lock
        # Completed fetches that returned NO records (the primary had
        # nothing past our cursor): drain()'s freshness witness.
        self._idle_fetches = 0  # guarded-by: _lock
        self._error: Optional[BaseException] = None  # guarded-by: _lock
        reg = registry or obs.default_registry()
        self._registry = reg
        self.g_lag = reg.register(obs.Gauge(
            "zipkin_replication_lag_records",
            "Durable primary records not yet applied locally",
            fn=lambda: float(self.lag_records())))
        self.g_applied = reg.register(obs.Gauge(
            "zipkin_replication_applied_seq",
            "Highest WAL sequence applied from the primary",
            fn=lambda: float(self.target.applied_seq())))
        self.c_fetched = reg.register(obs.Counter(
            "zipkin_replication_fetched_bytes_total",
            "WAL record bytes fetched from the primary"))
        self.c_applied = reg.register(obs.Counter(
            "zipkin_replication_applied_records_total",
            "Shipped WAL records applied locally"))

    # -- status ----------------------------------------------------------

    def lag_records(self) -> int:
        with self._lock:
            durable = self._primary_durable
        return max(0, durable - self.target.applied_seq())

    def error(self) -> Optional[BaseException]:
        with self._lock:
            return self._error

    def status(self) -> dict:
        with self._lock:
            durable = self._primary_durable
            connected = self._connected
            fetched = self._fetched_bytes
            applied_n = self._applied_records
            err = self._error
        return {
            "role": ("standby"
                     if isinstance(self.target, StandbyTarget)
                     else "replica"),
            "primary": "%s:%d" % self.client.addr,
            "connected": connected,
            "appliedSeq": self.target.applied_seq(),
            "primaryDurableSeq": durable,
            "lagRecords": max(0, durable - self.target.applied_seq()),
            "fetchedBytes": fetched,
            "appliedRecords": applied_n,
            "lagSeconds": (self.lineage.lag_seconds()
                           if self.lineage is not None else None),
            "error": repr(err) if err is not None else None,
        }

    # -- loop ------------------------------------------------------------

    def start(self) -> "Follower":
        if self._thread is not None:
            raise RuntimeError("follower already running")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="zipkin-follower")
        self._thread.start()
        return self

    def _run(self) -> None:
        backoff = self.poll_interval_s
        while not self._stop.is_set():
            try:
                made_progress = self.step()
                with self._lock:
                    self._connected = True
                backoff = self.poll_interval_s
                if not made_progress:
                    self._stop.wait(self.poll_interval_s)
            except WalReplayError as e:
                # Lineage divergence is terminal: applying anything
                # further would corrupt the replica. Park and stop.
                with self._lock:
                    self._error = e
                    self._connected = False
                return
            except Exception as e:  # noqa: BLE001 — transient I/O:
                # disconnects/timeouts back off and reconnect; the
                # last error stays visible in status().
                with self._lock:
                    self._error = e
                    self._connected = False
                self.client.close()
                self._stop.wait(backoff)
                backoff = min(2.0, backoff * 2)

    def step(self) -> bool:
        """One fetch-apply round on the caller's thread (the loop and
        the tests share it). Returns True when records were applied."""
        cursor = self.target.applied_seq()
        ack_fn = getattr(self.target, "ack_seq", None)
        extra = None
        lin = self.lineage
        if lin is not None:
            extra = {}
            spans = lin.take_spans()
            if spans:
                extra["spans"] = spans
            snap = lin.maybe_metrics_snapshot()
            if snap is not None:
                extra["metrics"] = snap
        got = self.client.fetch(
            cursor, self.max_fetch_bytes,
            ack=ack_fn() if ack_fn is not None else None,
            extra_meta=extra or None)
        if got is None:
            # Cursor precedes the retained log: bootstrap. "AHEAD of
            # the primary" is judged against the FRESHEST last_seq we
            # have seen (hello OR any RECORDS response) — the
            # connect-time hello alone goes stale the moment records
            # flow, and would misread a legitimate re-anchor (operator
            # dropped our pin + truncated) as lineage divergence.
            with self._lock:
                primary_last = self._primary_last
            primary_last = max(
                primary_last,
                int((self.client.hello_meta or {}).get("last_seq", 0)))
            if cursor > primary_last:
                raise WalReplayError(
                    f"follower at seq {cursor} is AHEAD of the "
                    f"primary's log (last_seq {primary_last}) — wrong "
                    f"primary or wiped log")
            self.target.adopt_anchor(self.client.anchor())
            return True
        records, last, durable = got
        with self._lock:
            self._primary_durable = max(self._primary_durable, durable)
            self._primary_last = max(self._primary_last, last)
            self._error = None
        nbytes = 0
        for seq, payload in records:
            t0 = time.perf_counter()
            self.target.apply(seq, payload)
            nbytes += len(payload)
            if lin is not None:
                lin.observe_record(seq, payload,
                                   time.perf_counter() - t0)
        if records:
            self.c_applied.inc(len(records))
            self.c_fetched.inc(nbytes)
            with self._lock:
                self._applied_records += len(records)
                self._fetched_bytes += nbytes
                self._last_apply_ts = time.time()
        else:
            with self._lock:
                self._idle_fetches += 1
        return bool(records)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until the follower is provably current: an EMPTY
        fetch completed AFTER this call began (the primary reported
        nothing past our cursor) and the lag reads zero. Requiring the
        fresh idle fetch closes the TOCTOU where lag-vs-the-LAST-
        response is already 0 while newer appends sit unfetched.
        Callers quiesce primary writes first (the fixed-frontier
        gate). False on timeout."""
        with self._lock:
            mark0 = self._idle_fetches
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            # Capture ONCE (a concurrent successful fetch clears the
            # parked error between a check and a re-read), and raise
            # only when it is TERMINAL — the loop thread is gone.
            # Transient disconnects are the loop's job to retry; drain
            # just keeps waiting them out inside the timeout.
            err = self.error()
            if err is not None:
                t = self._thread
                if t is None or not t.is_alive():
                    raise err
            with self._lock:
                idle = self._idle_fetches
            if idle > mark0 and self.lag_records() == 0:
                return True
            time.sleep(min(self.poll_interval_s, 0.01))
        return False

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        self.client.close()

    def promote(self):
        """Failover: stop following and hand back the target store,
        ready to own writes. The caller attaches a fresh WAL and opens
        intake — the elapsed time of (stop + final state visibility)
        is the failover RTO."""
        self.stop()
        for m in (self.g_lag, self.g_applied, self.c_fetched,
                  self.c_applied):
            if self._registry.get(m.name) is m:
                self._registry.unregister(m.name)
        return self.target.store

    def close(self) -> None:
        self.stop()
        for m in (self.g_lag, self.g_applied, self.c_fetched,
                  self.c_applied):
            if self._registry.get(m.name) is m:
                self._registry.unregister(m.name)
