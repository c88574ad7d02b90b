"""Durable write-ahead log + crash recovery, torch side.

The port's copy of ``zipkin_tpu/wal``:

- ``WriteAheadLog`` (wal/log.py) — segmented, CRC-framed, optionally
  deflated append log with per-batch / group-commit / off fsync
  policies and checkpoint-coordinated truncation;
- ``wal/record.py`` — the unit record codec: stage-1 encoded launch
  groups plus their dictionary deltas, so replay re-cuts identical
  launches. Records are byte-for-byte the JAX package's, so a log
  written by either package replays into the other;
- ``wal/recovery.py`` — checkpoint restore + deterministic tail
  replay through the store's normal commit body.

Ack contract: with a WAL attached, ``TorchSpanStore.apply`` returns
only after the batch's launch units are APPENDED; receivers that
promise durability additionally wait on the durable frontier
(``WriteAheadLog.wait_durable``).

``ShardedWal`` (wal/sharded.py) journals a sharded store: one segment
log per shard plus a group-commit epoch log; ``replay_sharded_into``
replays its complete epochs into a ``parallel.ShardedSpanStore``.
"""

from zipkin_tpu_torch.wal.log import (
    FsyncPolicy,
    WalDurabilityError,
    WriteAheadLog,
)
from zipkin_tpu_torch.wal.record import WalReplayError
from zipkin_tpu_torch.wal.recovery import (
    apply_record_into,
    recover,
    replay_into,
    replay_sharded_into,
)
from zipkin_tpu_torch.wal.sharded import ShardedWal

__all__ = [
    "FsyncPolicy",
    "WalDurabilityError",
    "WriteAheadLog",
    "WalReplayError",
    "ShardedWal",
    "apply_record_into",
    "recover",
    "replay_into",
    "replay_sharded_into",
]
