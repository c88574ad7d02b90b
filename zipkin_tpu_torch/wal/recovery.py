"""Crash recovery: checkpoint restore + deterministic WAL tail replay.

Recovery is re-execution: restore the newest checkpoint (manifest
revision 13 carries the last-applied WAL sequence plus the host pacing
clocks), then drive every WAL record past that sequence through the
store's NORMAL commit body — ``_commit_unit``, the same one the serial
writer and the ingest pipeline's commit thread run — so the sweep
cadence and the dependency-bucket rotation re-fire exactly as they did
before the crash. Because records are the pre-pad launch groups
(wal/record.py) and the pacing clocks restore exactly, a recovered
store equals one that never crashed, for every durably appended batch
(bitwise on the CPU; on CUDA the float32 moment leaves within the
stated tolerance, ``testing/crash.py``); batches whose append never
reached the log (or sat past a torn tail) are absent in full — never
partially applied.

A ``ShardedWal`` replays into a ``parallel.ShardedSpanStore`` through
``replay_sharded_into``: every complete epoch re-cut by the fleet's
own stage-1/stage-3 bodies, so each shard steps exactly as it did.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np

from zipkin_tpu_torch.columnar.encode import to_signed64
from zipkin_tpu_torch.store.base import MAX_TTL_ENTRIES, prune_ttls
from zipkin_tpu_torch.wal.record import (
    WalReplayError,
    apply_dict_deltas,
    decode_unit,
    dict_sizes,
)


def pin_tids_of(hot) -> Optional[np.ndarray]:
    """Pinned trace ids as an int64 array (None when the bank is
    empty) — taken once per replay, like live ingest's pin path."""
    return (np.fromiter(hot.pins.tids(), np.int64,
                        len(hot.pins.tids()))
            if hot.pins else None)


def _bank_replayed(store, parts, pin_tids: Optional[np.ndarray]) -> None:
    """Give every trace of a replayed unit's parts its TTL and bank the
    spans of pinned traces, as live ingest does; the caller holds the
    store's lock. Serves the single store and the fleet alike."""
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore

    for batch, _lc, _ix in parts:
        for tid in np.unique(batch.trace_id):
            store.ttls.setdefault(int(tid), 1.0)
        if pin_tids is not None and len(pin_tids):
            keep = np.isin(batch.trace_id, pin_tids)
            if keep.any():
                pinned = TorchSpanStore._select_batch(batch, keep)
                store._bump_read_epoch()
                store.pins.note_write(
                    to_signed64, store.codec.decode(pinned))
    prune_ttls(store.ttls, MAX_TTL_ENTRIES)


def apply_record_into(hot, seq: int, payload: bytes,
                      pin_tids: Optional[np.ndarray] = None) -> int:
    """Drive ONE journaled record through the store's normal commit
    body (``_commit_unit``) — the single replay step of crash recovery
    (and of the warm-standby follower, ``replicate/follow.StandbyTarget``).
    Returns the unit's span count."""
    group, before, deltas = decode_unit(payload)
    apply_dict_deltas(hot.dicts, before, deltas)
    # wal_seq threads into the pad so a paged store's planner can
    # serve RECORDED page claims for sequences the checkpoint already
    # planned (pipelined-save window) instead of re-planning them.
    unit = hot._pad_unit(group, wal_seq=seq)._replace(wal_seq=seq)
    with hot._lock:
        _bank_replayed(hot, group, pin_tids)
        hot._commit_unit(unit)
    return unit.n_spans


def replay_sharded_into(store, wal,
                        from_seq: Optional[int] = None) -> dict:
    """Sharded twin of ``replay_into``: drive every COMPLETE epoch of
    a ShardedWal past ``from_seq`` through the sharded store's normal
    stage-1/stage-3 bodies (``_build_unit`` → ``stage_unit`` →
    ``_commit_unit``), so an n-shard recovery re-cuts the uncrashed
    fleet's launch units — every shard's state, sketch-mirror twin and
    the fleet frontier land where an uncrashed fleet's would."""
    if from_seq is None:
        from_seq = int(getattr(store, "_wal_applied", 0))
    t0 = time.perf_counter()
    n_records = 0
    n_spans = 0
    pin_tids = pin_tids_of(store)
    for seq, parts, before, deltas in wal.replay_units(from_seq):
        apply_dict_deltas(store.dicts, before, deltas)
        with store._lock:
            unit = store._build_unit(parts)._replace(wal_seq=seq)
            _bank_replayed(store, parts, pin_tids)
            unit = unit._replace(db=store.stage_unit(unit.db))
            store._commit_unit(unit)
        n_spans += unit.n_spans
        wal.c_replayed.inc()
        n_records += 1
    with store._lock:
        store._wal_marks = dict_sizes(store.dicts)
    return {
        "replayed_records": n_records,
        "replayed_spans": n_spans,
        "replay_s": time.perf_counter() - t0,
        "applied_seq": int(store._wal_applied),
        "torn_records_cut": int(wal.torn_records_cut),
    }


def replay_into(store, wal, from_seq: Optional[int] = None) -> dict:
    """Replay every WAL record with seq > ``from_seq`` (default: the
    store's restored applied frontier) through the normal ingest path.
    Accepts a TorchSpanStore or a TieredSpanStore (replay routes through
    the hot store; an attached eviction sink captures and seals exactly
    as live ingest would), or a ShardedSpanStore paired with a
    ShardedWal (dispatched to ``replay_sharded_into``). Returns replay
    stats."""
    if hasattr(wal, "replay_units"):
        return replay_sharded_into(store, wal, from_seq)
    hot = getattr(store, "hot", store)
    if from_seq is None:
        from_seq = int(getattr(hot, "_wal_applied", 0))
    t0 = time.perf_counter()
    n_records = 0
    n_spans = 0
    # Pinned traces restored from the checkpoint keep banking their
    # post-checkpoint arrivals during replay, exactly as live ingest
    # would — otherwise replayed spans of a pinned trace would live
    # only in the volatile ring and vanish once it laps.
    pin_tids = pin_tids_of(hot)
    for seq, payload in wal.replay(from_seq):
        n_spans += apply_record_into(hot, seq, payload, pin_tids)
        wal.c_replayed.inc()
        n_records += 1
    # Future appends journal deltas from the replayed high-water marks.
    with hot._lock:
        hot._wal_marks = dict_sizes(hot.dicts)
    return {
        "replayed_records": n_records,
        "replayed_spans": n_spans,
        "replay_s": time.perf_counter() - t0,
        "applied_seq": int(hot._wal_applied),
        "torn_records_cut": int(wal.torn_records_cut),
    }


def recover(checkpoint_dir: Optional[str], wal,
            fresh_store: Optional[Callable[[object], object]] = None,
            device="cuda") -> Tuple[object, dict]:
    """Full recovery: restore the newest checkpoint under
    ``checkpoint_dir`` onto ``device`` (falling back to ``.old``,
    exactly like checkpoint.load), or build a fresh store with
    ``fresh_store(device)`` when no checkpoint exists yet, then attach
    ``wal`` and replay its tail. A sharded snapshot restores a
    ``ShardedSpanStore`` with the snapshot's shard count, and a
    ``ShardedWal`` replays into it (there is no mesh to pass: the
    shards share ``device``). Returns (store, stats); with a
    checkpoint, ``stats["load"]`` holds the load's phase seconds. The
    store is ready for live ingest: appends continue after the last
    replayed sequence and journal dictionary deltas from the replayed
    high-water marks."""
    from zipkin_tpu_torch import checkpoint

    load_stats = {}
    if checkpoint.exists(checkpoint_dir):
        store = checkpoint.load(checkpoint_dir, device=device,
                                stats=load_stats)
    elif fresh_store is not None:
        store = fresh_store(device)
    else:
        raise WalReplayError(
            f"no checkpoint at {checkpoint_dir!r} and no fresh_store "
            f"factory to build an empty store for WAL replay")
    if not hasattr(store, "attach_wal"):
        raise WalReplayError(
            "recovered store does not support a write-ahead log")
    store.attach_wal(wal)
    stats = replay_into(store, wal)
    if load_stats:
        stats["load"] = load_stats
    return store, stats
