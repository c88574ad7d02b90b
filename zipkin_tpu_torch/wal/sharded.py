"""Sharded write-ahead log: per-shard segment logs + a group-commit
epoch log (the durability tier under parallel/shard.ShardedSpanStore).

The port's copy of ``zipkin_tpu/wal/sharded.py``; the directory and
every segment byte are the reference's, so either package opens and
replays the other's log.

One launch unit of an n-shard store carries one encoded part PER SHARD
(every shard steps on every unit), so its journal entry must cover all
n parts atomically — replaying some shards' parts without the others
would desynchronize the fleet. Layout:

    <dir>/shard-000/wal-*.seg   part 0 of every unit (record codec,
    <dir>/shard-001/wal-*.seg   empty dictionary deltas)
    ...
    <dir>/epoch/wal-*.seg       the GROUP-COMMIT record: a part-less
                                unit record carrying the dictionary
                                delta the unit's encode step appended

Every member log shares one sequence numbering: epoch N's record in
the epoch log and part record N in each shard log describe the same
launch unit. ``append_unit`` appends the n shard records FIRST, the
epoch record LAST — under the 'batch' fsync policy that makes the
epoch record a true group commit (it cannot be durable before the
parts it spans); under 'interval'/'off' the member logs drift within
their fsync windows and open-time ALIGNMENT restores lockstep: every
log is physically cut (``WriteAheadLog.cut_tail``) back to the
shortest member's frontier, i.e. the longest prefix of COMPLETE
epochs. A unit is committed iff its epoch survives alignment; partial
groups are cut in full, never partially applied — the same
prefix-or-nothing shape the single log's torn-tail scan guarantees.

Replay (``replay_units``) zips the epoch log with the shard logs:
apply the epoch's dictionary delta, rebuild the n-part group, drive it
through ``ShardedSpanStore._build_unit``/``_commit_unit`` — the exact
stage-1/stage-3 bodies live ingest uses — so a recovery lands the
uncrashed fleet's state (wal/recovery.replay_sharded_into).

Shard logs register their metrics on a PRIVATE registry (n twins of
every zipkin_wal_* family would collide on the default registry); the
epoch log's metrics land on the registry passed in and read as the
fleet's group-commit observables.
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, List, Optional, Tuple

from zipkin_tpu_torch import obs
from zipkin_tpu_torch.wal.log import FsyncPolicy, WriteAheadLog
from zipkin_tpu_torch.wal.record import decode_unit, encode_unit


class ShardedWal:
    """See the module docstring. Thread-safe; one instance owns one
    directory tree. The surface mirrors WriteAheadLog where the
    checkpoint/recovery layers touch it (truncate/sync/close/stats,
    torn_records_cut, c_replayed) and adds the unit-level
    append_unit/replay_units pair the sharded store journals through."""

    def __init__(self, directory: str, n_shards: int,
                 fsync: str = FsyncPolicy.INTERVAL,
                 interval_s: float = 0.05,
                 segment_bytes: int = 64 << 20,
                 compress: bool = True,
                 registry=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1; got {n_shards}")
        self.directory = os.path.abspath(directory)
        self.n_shards = int(n_shards)
        # Keeps member appends lockstep (one unit's n+1 records carry
        # one sequence number) across concurrent append/truncate.
        # Held ABOVE the member logs' own conditions (rank 60).
        self._lock = threading.Lock()  # lock-order: 58 wal-group
        # Shard logs meter on a private registry: n copies of every
        # zipkin_wal_* family would fight over one name on the default
        # registry. The epoch log IS the fleet's group-commit
        # observable, so it meters for real.
        self._shard_registry = obs.Registry()
        self.shards: List[WriteAheadLog] = [
            WriteAheadLog(
                os.path.join(self.directory, f"shard-{i:03d}"),
                fsync=fsync, interval_s=interval_s,
                segment_bytes=segment_bytes, compress=compress,
                registry=self._shard_registry,
            )
            for i in range(self.n_shards)
        ]
        self.epoch = WriteAheadLog(
            os.path.join(self.directory, "epoch"),
            fsync=fsync, interval_s=interval_s,
            segment_bytes=segment_bytes, compress=compress,
            registry=registry)
        # Open-time alignment: cut every member back to the shortest
        # frontier — the longest prefix of COMPLETE epochs (a crash
        # between member appends/fsyncs leaves the logs ragged).
        logs = self.shards + [self.epoch]
        upto = min(log.last_seq for log in logs)
        self.aligned_records_cut = sum(
            log.cut_tail(upto) for log in logs)
        # c_replayed rides the epoch log (recovery bumps it per unit).
        self.c_replayed = self.epoch.c_replayed

    # -- frontier / loss accounting ---------------------------------------

    @property
    def last_seq(self) -> int:
        return self.epoch.last_seq

    @property
    def durable_seq(self) -> int:
        """Highest epoch durable across EVERY member — the group-commit
        ack frontier (an epoch whose parts are not all durable is not
        a durable unit)."""
        return min(log.durable_seq
                   for log in self.shards + [self.epoch])

    @property
    def torn_records_cut(self) -> int:
        """Units lost to torn tails or group alignment, fleet-wide
        (the recovery stats' data-loss signal)."""
        return sum(log.torn_records_cut
                   for log in self.shards + [self.epoch])

    # -- append path ------------------------------------------------------

    def append_unit(self, parts, before, deltas) -> int:
        """Journal one launch unit: ``parts`` is one
        (SpanBatch, name_lc, indexable) triple per shard in shard
        order; ``before``/``deltas`` are the unit's dictionary marks
        (wal/record.dump_dict_deltas). Returns the epoch sequence.
        Shard records append before the epoch record — the group's
        commit point."""
        if len(parts) != self.n_shards:
            raise ValueError(
                f"unit has {len(parts)} parts for a {self.n_shards}"
                f"-shard log")
        with self._lock:
            seqs = [
                log.append(encode_unit([part], before, {}))
                for log, part in zip(self.shards, parts)
            ]
            seq = self.epoch.append(encode_unit([], before, deltas))
            if any(s != seq for s in seqs):
                raise RuntimeError(
                    f"sharded WAL lost lockstep: shard seqs {seqs} vs "
                    f"epoch seq {seq}")
            return seq

    def wait_durable(self, seq: int,
                     timeout: Optional[float] = 30.0) -> bool:
        """Group-commit ack barrier: epoch ``seq`` and all its parts
        durable on every member."""
        return all(log.wait_durable(seq, timeout)
                   for log in self.shards + [self.epoch])

    def sync(self) -> None:
        """Force everything appended durable — parts first, then the
        epochs that span them."""
        for log in self.shards:
            log.sync()
        self.epoch.sync()

    # -- replay -----------------------------------------------------------

    def replay_units(self, from_seq: int = 0
                     ) -> Iterator[Tuple[int, list, list, dict]]:
        """Yield (seq, parts, before_sizes, deltas) for every COMPLETE
        epoch past ``from_seq``. Open-time alignment already cut the
        members to a common frontier, so a shard iterator running out
        mid-replay means post-open rot — stop at the last complete
        prefix (the single log's prefix semantics, fleet-wide)."""
        shard_iters = [log.replay(from_seq) for log in self.shards]
        for seq, payload in self.epoch.replay(from_seq):
            parts = []
            for it in shard_iters:
                got = next(it, None)
                if got is None or got[0] != seq:
                    return
                group, _before, _deltas = decode_unit(got[1])
                parts.append(group[0])
            _group, before, deltas = decode_unit(payload)
            yield seq, parts, before, deltas

    # -- truncation / lifecycle -------------------------------------------

    def truncate(self, upto_seq: int) -> int:
        """Checkpoint-covered truncation on every member; returns
        segment files deleted fleet-wide (the checkpoint.save stat)."""
        with self._lock:
            return sum(log.truncate(upto_seq)
                       for log in self.shards + [self.epoch])

    def close(self) -> None:
        for log in self.shards:
            log.close()
        self.epoch.close()

    def stats(self) -> dict:
        out = {f"shard{i}_{k}": v
               for i, log in enumerate(self.shards)
               for k, v in log.stats().items()}
        out.update(self.epoch.stats())
        out["wal_shards"] = self.n_shards
        out["wal_aligned_records_cut"] = self.aligned_records_cut
        return out
