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

Sharded logs (``replay_sharded_into``, ``ShardedWal``) come with the
sharding slice; a log with ``replay_units`` is refused.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np

from zipkin_tpu_torch.columnar.encode import to_signed64
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
        for batch, _lc, _ix in group:
            for tid in np.unique(batch.trace_id):
                hot.ttls.setdefault(int(tid), 1.0)
            if pin_tids is not None and len(pin_tids):
                keep = np.isin(batch.trace_id, pin_tids)
                if keep.any():
                    pinned = hot._select_batch(batch, keep)
                    hot._bump_read_epoch()
                    hot.pins.note_write(
                        to_signed64, hot.codec.decode(pinned))
        hot._prune_ttls()
        hot._commit_unit(unit)
    return unit.n_spans


def replay_into(store, wal, from_seq: Optional[int] = None) -> dict:
    """Replay every WAL record with seq > ``from_seq`` (default: the
    store's restored applied frontier) through the normal ingest path.
    Accepts a TorchSpanStore or a TieredSpanStore (replay routes through
    the hot store; an attached eviction sink captures and seals exactly
    as live ingest would). Returns replay stats."""
    if hasattr(wal, "replay_units"):
        raise NotImplementedError(
            "sharded logs replay into sharded stores through the "
            "sharded replay, which the port does not have yet (ROADMAP "
            "Queue 1, item 6b: sharded durability)")
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
    ``wal`` and replay its tail. Returns (store, stats); with a
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
