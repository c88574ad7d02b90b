"""Segmented, CRC-framed write-ahead log (host side).

The reference Zipkin inherits durability from Cassandra's commit log
(every SnappyCodec'd write lands in the commit log before the memtable
acks); this store's production state is volatile device HBM, so the
commit-log role must be explicit. ``WriteAheadLog`` is that role: an
append-only sequence of CRC32-framed records across size-bounded
segment files, with a configurable fsync policy and a durable-sequence
frontier receivers ack against (docs/DURABILITY.md).

Format. A segment file is

    b"ZWAL1" | u32 header_len | header json {"version", "base_seq"}
    record*  where record = u32 payload_len | u8 flags | u32 crc32
                            | payload

``flags & FLAG_DEFLATE`` marks a raw-zlib-compressed payload (level 1,
the checkpoint's tradeoff); the CRC covers the stored (possibly
compressed) bytes, so a scan never pays decompression to validate.
Sequence numbers are implicit — ``base_seq`` plus the record's index —
which keeps the frame 9 bytes and makes "the log is a prefix" the only
shape a valid log can have. Sequence 0 is reserved for "nothing
applied"; the first record is seq 1.

Torn tails. A crash mid-append leaves a short or CRC-bad final record;
``open`` scans every segment and CUTS the log at the last valid prefix
(physically truncating the torn segment and deleting anything after
it), so replay and subsequent appends always see a clean prefix. A
CRC-corrupt record in the MIDDLE of the log gets the same treatment —
prefix semantics, never skip-and-continue (a skipped record would
desynchronize the dictionary deltas every later record builds on).

Fsync policy (``fsync=``):

- ``"batch"``    — fsync inside every append; ``append`` returning
  means durable (lowest loss window, highest per-batch latency).
- ``"interval"`` — group commit: appends buffer in the OS, a
  background thread fsyncs every ``interval_s``; ackers block in
  ``wait_durable`` until the group commit covering their record lands
  (the default: amortizes one fsync over every record in the window).
- ``"off"``      — never fsync; the durable frontier tracks the append
  frontier (OS-crash loss window, process-crash safe — the bytes are
  in the page cache). Measurably reproduces no-WAL throughput.

Truncation. ``truncate(upto_seq)`` deletes whole segments whose
records are all covered by a checkpoint (checkpoint.save calls it with
the manifest's applied sequence once the snapshot is durably in
place); the active segment is rolled first when fully covered, so
steady-state disk is one checkpoint plus the post-checkpoint tail.

Shipping-aware retention (docs/REPLICATION.md). A log being shipped to
followers must not truncate records a registered follower has not yet
fetched: ``register_cursor(name, seq)`` pins the truncation frontier
at the minimum registered cursor (``advance_cursor`` moves it as the
follower acks, ``drop_cursor`` releases it), and ``retain_bytes``
keeps at least that many newest bytes of checkpoint-covered tail on
disk regardless — so a follower that reconnects shortly after a
checkpoint can still catch up from the log instead of needing an
anchor bootstrap. An un-pinned log with retain_bytes=0 truncates
exactly as before.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Iterator, List, Optional, Tuple

_MAGIC = b"ZWAL1"
_HDR = struct.Struct(">I")
_REC = struct.Struct(">IBI")  # payload_len, flags, crc32
FLAG_DEFLATE = 0x01
# Payloads below this don't deflate (header overhead dominates).
_COMPRESS_MIN = 512
# Frame sanity bound: a length word past this is torn garbage, not a
# record (also bounds a corrupt length from allocating the read).
_MAX_RECORD = 1 << 31


class FsyncPolicy:
    BATCH = "batch"
    INTERVAL = "interval"
    OFF = "off"
    ALL = (BATCH, INTERVAL, OFF)


class WalDurabilityError(RuntimeError):
    """The durable-append barrier cannot be satisfied right now: the
    group-commit fsync is failing, the durability wait timed out, or a
    failed append could not be rolled back to a clean prefix. Callers
    on the ack path MUST NOT ack — receivers map this to scribe
    TRY_LATER (backpressure, the client retries)."""


class _Segment:
    """Host bookkeeping for one segment file."""

    __slots__ = ("path", "base_seq", "n_records", "nbytes")

    def __init__(self, path: str, base_seq: int, n_records: int,
                 nbytes: int):
        self.path = path
        self.base_seq = base_seq
        self.n_records = n_records
        self.nbytes = nbytes

    @property
    def last_seq(self) -> int:
        return self.base_seq + self.n_records - 1


def _segment_path(directory: str, base_seq: int) -> str:
    return os.path.join(directory, f"wal-{base_seq:016d}.seg")


def _fsync_dir(directory: str) -> None:
    """Fsync the directory entry itself: file-data fsync does not
    cover the dirent, so a power/OS crash after a segment create (or
    delete) could otherwise resurface a pre-roll directory — a created
    segment vanishing loses acked records, a deleted one resurrecting
    breaks the base_seq chain and cuts the valid tail at open. Best
    effort on filesystems that reject directory fsync (EINVAL)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_header(f, base_seq: int) -> int:
    header = json.dumps({"version": 1, "base_seq": base_seq},
                        separators=(",", ":")).encode("utf-8")
    f.write(_MAGIC + _HDR.pack(len(header)) + header)
    return len(_MAGIC) + _HDR.size + len(header)


def _read_header(f) -> Optional[Tuple[int, int]]:
    """(base_seq, header_end_offset) or None for an unreadable header
    (treated as an empty/garbage segment)."""
    head = f.read(len(_MAGIC) + _HDR.size)
    if len(head) < len(_MAGIC) + _HDR.size or head[:len(_MAGIC)] != _MAGIC:
        return None
    (hlen,) = _HDR.unpack(head[len(_MAGIC):])
    if hlen > 1 << 20:
        return None
    raw = f.read(hlen)
    if len(raw) < hlen:
        return None
    try:
        header = json.loads(raw.decode("utf-8"))
        base_seq = int(header["base_seq"])
    except (ValueError, KeyError, UnicodeDecodeError):
        return None
    return base_seq, len(_MAGIC) + _HDR.size + hlen


def _iter_records(path: str):
    """Yield (index, payload_bytes, end_offset) for every CRC-valid
    record from the segment's prefix; stops (without raising) at the
    first torn or corrupt frame. Payloads are decompressed."""
    with open(path, "rb") as f:
        got = _read_header(f)
        if got is None:
            return
        _, off = got
        i = 0
        while True:
            head = f.read(_REC.size)
            if len(head) < _REC.size:
                return
            length, flags, crc = _REC.unpack(head)
            if length > _MAX_RECORD:
                return
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return
            off += _REC.size + length
            if flags & FLAG_DEFLATE:
                try:
                    payload = zlib.decompress(payload)
                except zlib.error:
                    return
            yield i, payload, off
            i += 1


def _scan_segment(path: str) -> Tuple[Optional[int], int, int]:
    """(base_seq, n_valid_records, valid_prefix_bytes); base_seq None
    when even the header is unreadable. Validates CRCs only — never
    decompresses (see _iter_records for the replay-time read)."""
    with open(path, "rb") as f:
        got = _read_header(f)
        if got is None:
            return None, 0, 0
        base_seq, off = got
        n = 0
        while True:
            head = f.read(_REC.size)
            if len(head) < _REC.size:
                return base_seq, n, off
            length, _flags, crc = _REC.unpack(head)
            if length > _MAX_RECORD:
                return base_seq, n, off
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return base_seq, n, off
            off += _REC.size + length
            n += 1


class WriteAheadLog:
    """See the module docstring. Thread-safe; one instance owns one
    directory. ``append`` takes opaque payload bytes (the store's unit
    record codec lives in zipkin_tpu_torch.wal.record) and returns the
    record's sequence number."""

    def __init__(self, directory: str, fsync: str = FsyncPolicy.INTERVAL,
                 interval_s: float = 0.05,
                 segment_bytes: int = 64 << 20,
                 compress: bool = True,
                 retain_bytes: int = 0,
                 registry=None):
        from zipkin_tpu_torch import obs

        if fsync not in FsyncPolicy.ALL:
            raise ValueError(
                f"fsync policy must be one of {FsyncPolicy.ALL}; "
                f"got {fsync!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.fsync = fsync
        self.interval_s = max(1e-3, float(interval_s))
        self.segment_bytes = max(1 << 12, int(segment_bytes))
        self.compress = compress
        # Shipping retention floor: keep at least this many newest
        # bytes of checkpoint-covered tail (0 = truncate everything
        # covered, the pre-replication behavior).
        self.retain_bytes = max(0, int(retain_bytes))
        self._cond = threading.Condition()  # lock-order: 60 wal
        # Registered follower cursors: name -> highest fetched seq.
        # truncate() never deletes a segment holding records past the
        # minimum cursor (the shipping retention pin).
        self._cursors: dict = {}  # guarded-by: _cond
        self._segments: List[_Segment] = []  # guarded-by: _cond
        self._file = None  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        # Set when a failed append leaves bytes we could not truncate
        # away (every later append would sit past a torn frame and be
        # silently cut at recovery — refuse instead).
        self._poisoned: Optional[BaseException] = None  # guarded-by: _cond
        # Last group-commit fsync failure (cleared by the next success);
        # wait_durable surfaces it instead of timing out silently.
        # _sync_fails counts failures monotonically, so waiters can
        # distinguish "still failing" (a FRESH failure landed while
        # they waited) from "stale error, retry thread merely starved".
        self._sync_error: Optional[BaseException] = None  # guarded-by: _cond
        self._sync_fails = 0  # guarded-by: _cond
        # Durable-frontier observer (obs.fleet lineage): called with
        # the new durable seq AFTER _cond is released at every site
        # that advances the frontier. Must never be invoked under
        # _cond — the callback flushes self-trace spans through
        # store.apply, whose lock ranks BELOW the WAL's (10 < 60).
        self._on_durable = None  # guarded-by: _cond (the slot, not the call)
        self.torn_records_cut = 0  # records dropped by the open() scan
        self._next_seq = 1  # guarded-by: _cond
        self._durable = 0  # guarded-by: _cond
        self._open_scan()
        reg = registry or obs.default_registry()
        self._registry = reg
        self.h_append = reg.register(obs.LatencySketch(
            "zipkin_wal_append_seconds",
            "WAL record append latency (frame + OS write; excludes "
            "group-commit fsync waits)"))
        self.h_fsync = reg.register(obs.LatencySketch(
            "zipkin_wal_fsync_seconds",
            "WAL fsync latency (per batch, per group commit, or "
            "explicit sync())"))
        self.g_bytes = reg.register(obs.Gauge(
            "zipkin_wal_segment_bytes",
            "Live WAL bytes on disk across all segments",
            fn=self._live_bytes))
        self.g_backlog = reg.register(obs.Gauge(
            "zipkin_wal_truncation_backlog_segments",
            "Segment files not yet covered by a checkpoint truncation",
            fn=self._live_segments))
        self.c_records = reg.register(obs.Counter(
            "zipkin_wal_records_total", "Records appended to the WAL"))
        self.c_replayed = reg.register(obs.Counter(
            "zipkin_wal_replayed_records_total",
            "Records replayed through the ingest path at recovery"))
        self.c_corrupt = reg.register(obs.Counter(
            "zipkin_wal_corrupt_records_total",
            "Torn/CRC-corrupt records cut from the log tail"))
        self.c_truncated = reg.register(obs.Counter(
            "zipkin_wal_truncated_segments_total",
            "Segment files deleted by checkpoint-covered truncation"))
        if self.torn_records_cut:
            self.c_corrupt.inc(self.torn_records_cut)
        self._syncer: Optional[threading.Thread] = None
        if self.fsync == FsyncPolicy.INTERVAL:
            self._syncer = threading.Thread(
                target=self._sync_loop, name="zipkin-wal-sync",
                daemon=True)
            self._syncer.start()

    def _live_bytes(self) -> float:
        """Gauge callback (exposition thread): the _segments list is
        _cond-guarded, so snapshot under it — the old lock-free lambda
        raced truncate()'s list swap (graftlint guarded-by)."""
        with self._cond:
            return float(sum(s.nbytes for s in self._segments))

    def _live_segments(self) -> float:
        with self._cond:
            return float(len(self._segments))

    # -- open-time scan -------------------------------------------------

    # graftlint: disable=guarded-by — __init__-time, pre-thread
    def _open_scan(self) -> None:
        """Adopt the valid prefix of an existing directory: scan every
        segment in base_seq order, truncate the first torn/corrupt one
        at its last valid record, and delete everything after it."""
        names = sorted(n for n in os.listdir(self.directory)
                       if n.startswith("wal-") and n.endswith(".seg"))
        cut = False
        expect = None
        for name in names:
            path = os.path.join(self.directory, name)
            if cut:
                # Count the RECORDS this discarded file held, not the
                # file: the corrupt counter is an operator's data-loss
                # signal (docs/DURABILITY.md runbook), and a later
                # segment can carry hundreds of acked records.
                _, n_lost, _ = _scan_segment(path)
                self.torn_records_cut += max(1, n_lost)
                os.remove(path)
                continue
            base_seq, n_valid, valid_bytes = _scan_segment(path)
            total = os.path.getsize(path)
            if base_seq is None or (expect is not None
                                    and base_seq != expect):
                # Unreadable header or a sequence hole: nothing after
                # this point is a sound prefix.
                cut = True
                self.torn_records_cut += max(1, n_valid)
                os.remove(path)
                continue
            if valid_bytes < total:
                # Torn tail: cut at the last valid record. Anything in
                # LATER segments would sit past the cut — drop it too.
                self.torn_records_cut += 1
                with open(path, "r+b") as f:
                    f.truncate(valid_bytes)
                cut = True
            self._segments.append(
                _Segment(path, base_seq, n_valid, valid_bytes))
            expect = base_seq + n_valid
        self._next_seq = (self._segments[-1].last_seq + 1
                          if self._segments else 1)
        self._durable = self._next_seq - 1

    # -- frontier properties --------------------------------------------

    @property
    def last_seq(self) -> int:
        """Sequence of the most recently appended record (0 = none)."""
        with self._cond:
            return self._next_seq - 1

    @property
    def durable_seq(self) -> int:
        """Highest sequence known fsynced (== last_seq under the
        'batch' and 'off' policies)."""
        with self._cond:
            return self._durable

    def first_available_seq(self) -> int:
        """Lowest sequence the log can still replay (truncation may
        have deleted earlier records). ``last_seq + 1`` when the log
        holds no records — a follower whose cursor is at or past
        ``first_available_seq() - 1`` can catch up from the log alone;
        anything older needs an anchor bootstrap (replicate/ship)."""
        with self._cond:
            for seg in self._segments:
                if seg.n_records:
                    return seg.base_seq
            return self._next_seq

    # -- follower cursors (shipping retention pins) ---------------------

    def register_cursor(self, name: str, seq: int = 0) -> None:
        """Pin truncation at ``seq``: segments holding records past the
        minimum registered cursor survive truncate() until the cursor
        advances. Re-registering moves the pin (monotonically — a
        follower can never un-fetch)."""
        with self._cond:
            have = self._cursors.get(name, -1)
            self._cursors[name] = max(have, int(seq))

    def advance_cursor(self, name: str, seq: int) -> None:
        self.register_cursor(name, seq)

    def drop_cursor(self, name: str) -> None:
        with self._cond:
            self._cursors.pop(name, None)

    def cursors(self) -> dict:
        with self._cond:
            return dict(self._cursors)

    # -- fleet observability hooks --------------------------------------

    def set_on_durable(self, fn) -> None:
        """Register ``fn(durable_seq)`` to run after every durable-
        frontier advance, OUTSIDE ``_cond``. With ``fsync='off'`` or
        ``'batch'`` the call happens synchronously inside ``append``
        (the caller may hold its own locks — obs.fleet's tracker
        defers its flush via ``suppressed()`` for exactly this case);
        under ``'interval'`` it runs on the group-commit thread."""
        with self._cond:
            self._on_durable = fn

    def _notify_durable(self, prev: int) -> None:
        """Fire the durable observer if the frontier moved past
        ``prev``. Called WITHOUT _cond held."""
        with self._cond:
            fn, now = self._on_durable, self._durable
        if fn is not None and now > prev:
            try:
                fn(now)
            except Exception:  # graftlint: disable=swallowed-exception
                pass  # the observer must not poison the append/fsync path

    def sync_error(self) -> Optional[BaseException]:
        """The parked group-commit fsync failure, or None when the
        last fsync succeeded — the stall watchdog's fsync probe."""
        with self._cond:
            return self._sync_error

    # -- append path ----------------------------------------------------

    def _ensure_file_locked(self):  # called-under: _cond
        if self._file is None:
            if not self._segments:
                self._roll_locked()
            else:
                self._file = open(self._segments[-1].path, "ab")
        if self._segments[-1].nbytes >= self.segment_bytes:
            self._roll_locked()
        return self._file

    def _roll_locked(self) -> None:  # called-under: _cond
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
        path = _segment_path(self.directory, self._next_seq)
        self._file = open(path, "wb")
        nbytes = _write_header(self._file, self._next_seq)
        self._file.flush()
        # The new segment's DIRENT must be durable before any record
        # in it is claimed durable — fsyncing file bytes alone leaves
        # the file itself able to vanish in a power crash.
        _fsync_dir(self.directory)
        self._segments.append(_Segment(path, self._next_seq, 0, nbytes))

    def append(self, payload: bytes) -> int:
        """Append one record; returns its sequence number. Durability
        on return follows the fsync policy (module docstring) — use
        ``wait_durable``/``sync`` for an explicit barrier."""
        flags = 0
        data = payload
        if self.compress and len(payload) >= _COMPRESS_MIN:
            packed = zlib.compress(payload, 1)
            if len(packed) < len(payload):
                data, flags = packed, FLAG_DEFLATE
        frame = _REC.pack(len(data), flags, zlib.crc32(data)) + data
        t0 = time.perf_counter()
        with self._cond:
            if self._closed:
                raise RuntimeError("write-ahead log is closed")
            if self._poisoned is not None:
                raise WalDurabilityError(
                    "write-ahead log is poisoned by an earlier "
                    "unrecoverable append failure"
                ) from self._poisoned
            f = self._ensure_file_locked()
            seg = self._segments[-1]
            try:
                f.write(frame)
                f.flush()
            except BaseException as e:
                # A partial frame may be on disk. Left there, every
                # LATER append would sit past a torn frame and be
                # silently cut at recovery — so restore the segment's
                # valid prefix now (truncate + reposition), or refuse
                # all further appends if even that fails.
                try:
                    f.truncate(seg.nbytes)
                    f.seek(seg.nbytes)
                except OSError as e2:
                    self._poisoned = e2
                raise WalDurabilityError(
                    "WAL append failed; the torn frame was "
                    + ("rolled back" if self._poisoned is None
                       else "NOT rolled back — log poisoned")
                ) from e
            seg.n_records += 1
            seg.nbytes += len(frame)
            seq = self._next_seq
            self._next_seq += 1
            prev_durable = self._durable
            if self.fsync == FsyncPolicy.BATCH:
                self._fsync_locked()
            elif self.fsync == FsyncPolicy.OFF:
                self._durable = seq
                self._cond.notify_all()
            # INTERVAL: the group-commit thread advances the frontier.
        self._notify_durable(prev_durable)
        self.h_append.observe(time.perf_counter() - t0)
        self.c_records.inc()
        return seq

    def _fsync_locked(self) -> None:  # called-under: _cond
        if self._file is not None:
            t0 = time.perf_counter()
            os.fsync(self._file.fileno())
            self.h_fsync.observe(time.perf_counter() - t0)
        self._sync_error = None
        self._durable = self._next_seq - 1
        self._cond.notify_all()

    def sync(self) -> None:
        """Force every appended record durable now — fsyncs under ANY
        policy, including ``off`` (the graceful-shutdown barrier must
        not depend on the steady-state policy)."""
        with self._cond:
            self._fsync_locked()
        # Always notify (prev=-1): under fsync='off' the frontier was
        # already at the append frontier, but lineage seqs registered
        # AFTER their append's own notification (note_append runs once
        # append returns) still need a durable callback — sync() is
        # the explicit barrier that drains them.
        self._notify_durable(-1)

    def wait_durable(self, seq: int, timeout: Optional[float] = 30.0
                     ) -> bool:
        """Block until the durable frontier covers ``seq`` (the
        group-commit ack barrier). True when covered; False on
        timeout."""
        deadline = None if timeout is None else (
            time.monotonic() + timeout)
        # A parked group-commit error gets a grace period to clear (a
        # transient EIO the sync loop recovers from on its next tick);
        # past that, it surfaces here — the acker must fail fast, not
        # time out against a broken fsync and (worse) ack. The raise
        # additionally requires a FRESH failure since this wait began
        # (the monotonic failure count moved): a stale parked error
        # whose retry thread is merely starved for the CPU keeps
        # waiting instead of spuriously failing the ack.
        err_grace = max(2.0 * self.interval_s, 0.05)
        err_since = None
        fails0 = None
        with self._cond:
            while self._durable < seq:
                if self._sync_error is not None:
                    now = time.monotonic()
                    if err_since is None:
                        err_since = now
                        fails0 = self._sync_fails
                    elif (now - err_since > err_grace
                            and self._sync_fails > fails0):
                        raise WalDurabilityError(
                            "group-commit fsync is failing; record "
                            "not durable"
                        ) from self._sync_error
                else:
                    err_since = None
                if self._closed:
                    return self._durable >= seq
                rest = None if deadline is None else (
                    deadline - time.monotonic())
                if rest is not None and rest <= 0:
                    return False
                wait = 0.5 if rest is None else rest
                if self._sync_error is not None:
                    wait = min(wait, err_grace / 2)
                self._cond.wait(timeout=wait)
            return True

    def _sync_loop(self) -> None:
        while True:
            fd = None
            target = 0
            with self._cond:
                if self._closed:
                    return
                if (self._durable < self._next_seq - 1
                        and self._file is not None):
                    # Snapshot the frontier and dup the fd, then fsync
                    # OUTSIDE the lock: appends (which only need the OS
                    # buffer) must not stall behind the group commit's
                    # disk wait, or the WAL's append overhead grows a
                    # synchronous fsync every interval. Every record
                    # <= target is already flushed to the OS (append
                    # flushes under the lock; rolled segments fsync at
                    # roll), so advancing to the pre-snapshot target
                    # after the fsync is sound even while new appends
                    # land — or the segment rolls — mid-fsync.
                    target = self._next_seq - 1
                    try:
                        fd = os.dup(self._file.fileno())
                    except OSError as e:
                        self._sync_error = e
                        self._sync_fails += 1
                        self._cond.notify_all()
            if fd is not None:
                try:
                    t0 = time.perf_counter()
                    os.fsync(fd)
                except Exception as e:  # noqa: BLE001
                    # The thread must SURVIVE a transient EIO/ENOSPC:
                    # park the error for wait_durable to surface
                    # (ackers fail instead of timing out against a
                    # silently dead group commit) and retry next tick.
                    with self._cond:
                        self._sync_error = e
                        self._sync_fails += 1
                        self._cond.notify_all()
                else:
                    self.h_fsync.observe(time.perf_counter() - t0)
                    with self._cond:
                        prev = self._durable
                        self._sync_error = None
                        if target > self._durable:
                            self._durable = target
                        self._cond.notify_all()
                    self._notify_durable(prev)
                finally:
                    os.close(fd)
            time.sleep(self.interval_s)

    # -- replay ---------------------------------------------------------

    def replay(self, from_seq: int = 0) -> Iterator[Tuple[int, bytes]]:
        """Yield (seq, payload) for every record with seq > from_seq,
        in order. The open()-time scan already cut any torn tail, so
        this sees only CRC-valid frames; a record that rots BETWEEN
        open and replay still stops the iteration at the last valid
        prefix (counted corrupt) rather than raising."""
        with self._cond:
            segments = list(self._segments)
        for seg in segments:
            if seg.last_seq <= from_seq:
                continue
            n_seen = 0
            try:
                for i, payload, _off in _iter_records(seg.path):
                    n_seen = i + 1
                    seq = seg.base_seq + i
                    if seq > from_seq:
                        yield seq, payload
            except FileNotFoundError:
                # A concurrent truncate() deleted the file after the
                # snapshot (possible only for already-covered,
                # un-pinned segments — shipping readers pin theirs):
                # stop at the prefix served so far; the caller's next
                # replay(from_seq) resumes past the hole.
                return
            if n_seen < seg.n_records:
                self.c_corrupt.inc(seg.n_records - n_seen)
                return

    # -- truncation -----------------------------------------------------

    def _delete_segment(self, path: str) -> None:
        from zipkin_tpu_torch.testing.crash import kill_point

        kill_point("mid-truncate")
        os.remove(path)

    def truncate(self, upto_seq: int) -> int:
        """Delete whole segments fully covered by ``upto_seq`` (a
        checkpoint's applied frontier). The active segment rolls first
        when fully covered so its file can go too. Registered follower
        cursors clamp the frontier (a shipped log never deletes what a
        follower still has to fetch) and ``retain_bytes`` keeps the
        newest covered tail on disk. Returns the number of segment
        files deleted."""
        removed = 0
        with self._cond:
            # Follower pin: records past the minimum cursor are not
            # yet fetched — truncation must stop below them no matter
            # what the checkpoint covers.
            if self._cursors:
                upto_seq = min(upto_seq, min(self._cursors.values()))
            # Roll BEFORE deleting whenever the newest record-bearing
            # segment is covered — even on a reopened log that has not
            # appended yet (file not open). Deleting every segment
            # would leave an empty directory with no record of
            # _next_seq: the next open would restart sequences at 1
            # below the checkpoint's applied frontier, and recovery
            # would silently skip that many durably-acked records. The
            # fresh empty segment persists base_seq across the wipe.
            if (self._segments
                    and self._segments[-1].n_records > 0
                    and self._segments[-1].last_seq <= upto_seq):
                self._roll_locked()
            # Byte floor: walking from the newest segment, everything
            # inside the retain_bytes window survives even when
            # checkpoint-covered (reconnecting followers catch up from
            # the log instead of re-anchoring).
            protected: set = set()
            if self.retain_bytes > 0:
                tail = 0
                for seg in reversed(self._segments):
                    if tail >= self.retain_bytes:
                        break
                    protected.add(seg.base_seq)
                    tail += seg.nbytes
            keep: List[_Segment] = []
            for seg in self._segments:
                is_active = (self._file is not None
                             and seg is self._segments[-1])
                if (not is_active and seg.n_records > 0
                        and seg.last_seq <= upto_seq
                        and seg.base_seq not in protected):
                    self._delete_segment(seg.path)
                    removed += 1
                else:
                    keep.append(seg)
            self._segments = keep
            if removed:
                # Make the deletes durable: a deleted segment
                # resurrecting after a power crash would break the
                # base_seq chain and cut the surviving valid tail.
                _fsync_dir(self.directory)
        if removed:
            self.c_truncated.inc(removed)
        return removed

    def cut_tail(self, upto_seq: int) -> int:
        """Physically cut the log back so ``upto_seq`` is its last
        record — the sharded group-commit alignment (wal/sharded): a
        crash between one member log's append and another's leaves the
        fleet's logs at different frontiers, and every log must rewind
        to the shortest so the epoch chain stays lockstep. Segments
        wholly past the cut are deleted; the segment containing the
        cut is truncated at the record boundary. Returns the number of
        records cut (counted corrupt — they were never part of a
        complete group and are data loss in the same operator sense as
        a torn tail)."""
        removed = 0
        cut = 0
        with self._cond:
            if upto_seq >= self._next_seq - 1:
                return 0
            if self._file is not None:
                self._file.flush()
                self._file.close()
                self._file = None
            keep: List[_Segment] = []
            for seg in self._segments:
                if seg.base_seq > upto_seq:
                    cut += seg.n_records
                    self._delete_segment(seg.path)
                    removed += 1
                    continue
                if seg.n_records and seg.last_seq > upto_seq:
                    n_keep = upto_seq - seg.base_seq + 1
                    end = None
                    for i, _payload, off in _iter_records(seg.path):
                        if i + 1 == n_keep:
                            end = off
                            break
                    cut += seg.n_records - n_keep
                    with open(seg.path, "r+b") as f:
                        f.truncate(end)
                    seg.n_records = n_keep
                    seg.nbytes = end
                keep.append(seg)
            self._segments = keep
            self._next_seq = upto_seq + 1
            self._durable = min(self._durable, upto_seq)
            if removed or cut:
                _fsync_dir(self.directory)
        if cut:
            self.torn_records_cut += cut
            self.c_corrupt.inc(cut)
        return cut

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        """Fsync, stop the group-commit thread, release the file, and
        unregister this log's metrics."""
        with self._cond:
            if self._closed:
                return
            self._fsync_locked()
            self._closed = True
            self._cond.notify_all()
            if self._file is not None:
                self._file.close()
                self._file = None
        if self._syncer is not None:
            self._syncer.join(timeout=5.0)
        for m in (self.h_append, self.h_fsync, self.g_bytes,
                  self.g_backlog, self.c_records, self.c_replayed,
                  self.c_corrupt, self.c_truncated):
            if self._registry.get(m.name) is m:
                self._registry.unregister(m.name)

    def stats(self) -> dict:
        with self._cond:
            return {
                "wal_segments": len(self._segments),
                "wal_bytes": sum(s.nbytes for s in self._segments),
                "wal_last_seq": self._next_seq - 1,
                "wal_durable_seq": self._durable,
            }
