"""Checkpoint/restore for the torch device stores (durability).

The port's copy of ``zipkin_tpu/checkpoint.py``. A snapshot is a
directory: ``state.npz`` (every state leaf,
counters as ``counters.<name>``, deflate level 1), ``meta.json``
(revision, config, per-leaf CRC32s, TTLs, dictionaries, the host
clocks, the paged planner) and ``pins.pkl`` (pinned traces' banks).
The files are the reference's, so a snapshot written by either package
restores into the other: leaves keep the reference's names, dtypes and
shapes, and the pins name the reference's span module (see
``_SpanPickler``).

Snapshots are atomic (write to a temp dir, swap through ``path.old``)
so a crash mid-save leaves the previous checkpoint restorable, and the
attached WAL is truncated only after the new snapshot is in place.

Consistency: the reference's state is functional and its save takes
one device_get under a read lock while writers make new buffers. The
port's state is mutated in place, so ``save`` drains the ingest
pipeline and then holds the store's ``_lock`` (no stage-1 writer) and
``_state_lock`` (no commit, no reader) across the whole device-to-host
gather and the clock read. Nothing is copied into a second device
buffer: at full width that would be another ~4.8 GB.

A ``TieredSpanStore`` (``store/archive``) snapshots as its hot store
plus ``meta["archive"]`` (the sketch params, the sealed frontier and the
segment manifest) and one immutable blob per segment under
``segments/``; a blob the previous snapshot already holds is linked,
not written again. ``load`` then returns a ``TieredSpanStore`` whose
cold tier continues contiguously from the snapshot's frontier.

A ``parallel.ShardedSpanStore`` snapshots in the reference's sharded
layout: ``meta["shards"] = n``, every leaf stacked ``[n, ...]`` on the
host (one shard at a time into the host buffer, never stacked on the
card), and the fleet's pacing clocks (``_sharded_clocks``). Its save
holds the fleet's ``_lock`` and the read half of its ``_rw`` (no
stage-1 writer, no commit) across the gather. ``load`` of such a
snapshot returns a ``ShardedSpanStore`` with the snapshot's shard
count, every shard's leaves on ``device``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import shutil
import tempfile
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from zipkin_tpu_torch.columnar.dictionary import Dictionary, DictionarySet
from zipkin_tpu_torch.columnar.encode import SpanCodec
from zipkin_tpu_torch.store import device as dev
from zipkin_tpu_torch.store.torch_store import TorchSpanStore
from zipkin_tpu_torch.testing.crash import kill_point
from zipkin_tpu_torch.wal.record import dump_value, load_value

_STATE_FILE = "state.npz"
_META_FILE = "meta.json"
_PINS_FILE = "pins.pkl"
_SEGMENTS_DIR = "segments"
# The reference's revision history (zipkin_tpu/checkpoint.py) applies
# unchanged; load() adapts every single-device revision:
# 3 dep_banks; 4 streaming-join leaves (pre-4 live links migrate);
# 6 index families (pre-6 trust poisoned); 7 _TAB_EMPTY sentinel and
# ann_poison (pre-7 poisoned); 8 key_claim_drops; 9 i32 key_tab
# fingerprints (pre-9 tombstoned); 10/11 one unified index arena
# (pre-11 cand_*/tr_* dropped, span_tab bitcast to planes); 13 exact
# host clocks + per-leaf CRC32; 12 the cold-tier archive manifest;
# 14 windowed arena leaves; 18 the paged planner's snapshot.
_REVISION = 18

# The span model's module in each package: pins.pkl names the
# reference's, so either package's loader gets its own classes back.
_REF_SPAN_MODULE = "zipkin_tpu.models.span"
_PORT_SPAN_MODULE = "zipkin_tpu_torch.models.span"


class CorruptSlabError(RuntimeError):
    """A checkpoint state slab failed its manifest CRC32 — the
    snapshot is damaged (torn copy, disk rot, or mixed cuts). Restore
    refuses to feed the corrupt leaf to the device; recover from the
    ``.old`` snapshot or an earlier checkpoint plus the WAL."""


def _slab_crc(arr) -> int:
    """CRC32 over a leaf's raw C-order bytes (dtype/shape are pinned by
    the npy header, so content bytes are the integrity surface)."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(memoryview(a).cast("B"))


def _host_clocks(store) -> dict:
    """The store's host pacing clocks plus the applied WAL sequence,
    read under the same locks as the state gather (the commit advances
    them in the same ``_state_lock`` hold as the step, so the pair is
    exact). The capture clocks are ``_cap_lock``'s, which is taken
    BEFORE ``_state_lock`` (a pull holds it while it waits for the
    state), so they are read here without it: taking ``_cap_lock``
    under the gather's state lock would invert the _cap_lock(30) ->
    _state_lock(40) order, a real deadlock with a pull waiting for the
    state. A pull cannot complete, and so cannot move them, while the
    gather holds the state lock; int reads cannot tear. The sealed
    frontier's lock is a leaf, so it is read under it."""
    return {
        "wp": int(store._wp),
        "awp": int(store._awp),
        "bwp": int(store._bwp),
        "archived": int(store._archived),
        "batches_since_sweep": int(store._batches_since_sweep),
        "cap_upto": int(store._cap_upto),  # graftlint: disable=guarded-by
        "cap_a": int(store._cap_a),  # graftlint: disable=guarded-by
        "cap_b": int(store._cap_b),  # graftlint: disable=guarded-by
        "sealed_upto": int(store.sealed_frontier()),
        "wal_applied": int(store._wal_applied),
    }


def _seal_barrier(store) -> None:
    """Wait for the store's async capture sealer (if any) to finish
    every pulled window; see save() for why it runs under the locks."""
    barrier = getattr(store, "seal_barrier", None)
    if barrier is not None:
        barrier()


def _sharded_clocks(store) -> dict:
    """The sharded store's host pacing clocks, read under the same
    holds as the per-shard gather. The top-level ``wal_applied`` key
    keeps save()'s WAL-truncation coordination identical across store
    kinds (a ShardedWal truncates by epoch sequence exactly as a
    WriteAheadLog does by record sequence)."""
    inner = store.inner
    return {
        "sharded": 1,
        "wp_upper": int(inner._wp_upper),
        "archived_lower": int(inner._archived_lower),
        "batches_since_sweep": int(inner._batches_since_sweep),
        # Read under the gather's hold of _rw (save's _cut), which the
        # checker cannot see through the call.
        "step_seq": int(store._step_seq),  # graftlint: disable=guarded-by
        "wal_applied": int(store._wal_applied),
    }


@contextlib.contextmanager
def _cut(store, sharded: bool):
    """The gather's hold: the encode lock (no stage-1 writer) and, for
    a single store, its state lock (no commit, no reader); for a fleet,
    the read half of its commit lock (no commit; readers do not write
    the shards)."""
    with store._lock:
        with (store._rw.read() if sharded else store._state_lock):
            yield


def _dict_dump(d) -> list:
    # One entry codec shared with the WAL's dictionary deltas: replay
    # equality-verifies restored entries against delta values.
    return [dump_value(v) for v in d.values()]


def _dict_load(dictionary, values: list) -> None:
    for item in values:
        dictionary.encode(load_value(item))


def _savez_fast(path: str, leaves: dict) -> None:
    """npz-compatible writer at deflate level 1 (np.savez_compressed is
    hardwired to level 6 on one core); np.load reads any
    deflate-compressed zip member unchanged."""
    import zipfile

    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED,
                         compresslevel=1, allowZip64=True) as zf:
        for name, arr in leaves.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(
                    f, np.asanyarray(arr), allow_pickle=False)


class _SpanPickler(pickle._Pickler):
    """Pickles the port's span classes under the reference's module
    path, so the JAX package's loader gets its own ``Span`` back
    (dataclass equality checks the class)."""

    def save_global(self, obj, name=None):
        if getattr(obj, "__module__", None) != _PORT_SPAN_MODULE:
            return super().save_global(obj, name)
        # Protocol 4+ (_dump_pins): module and name go on the stack.
        self.save(_REF_SPAN_MODULE)
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _SpanUnpickler(pickle.Unpickler):
    """Loads pins.pkl of either package into the port's span classes
    and refuses every other global."""

    def find_class(self, module, name):
        if module in (_REF_SPAN_MODULE, _PORT_SPAN_MODULE):
            from zipkin_tpu_torch.models import span

            return getattr(span, name)
        raise pickle.UnpicklingError(
            f"pins.pkl names {module}.{name}; only the span model may "
            f"appear in a pin bank")


def _dump_pins(pins: dict) -> bytes:
    buf = io.BytesIO()
    _SpanPickler(buf, pickle.DEFAULT_PROTOCOL).dump(pins)
    return buf.getvalue()


_SLAB_BYTES = 64 << 20  # transfer granularity for big leaves
_GEN_FILE = "generation.json"


def _to_host(x):
    """A host copy of a tensor (or a dict of them) as numpy. Always a
    copy: ``.cpu()`` of a CPU tensor is the tensor itself, and the
    state is mutated in place once the save's locks are released."""
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    t = x.detach()
    return (t.clone() if t.device.type == "cpu" else t.cpu()).numpy()


def _bounded_get(x, deadline_s: Optional[float]):
    """Device-to-host copy of a tensor (or a dict of them) with a
    deadline. A wedged transfer is uninterruptible from Python, so the
    copy runs on an abandonable daemon thread; on timeout the thread is
    orphaned and TimeoutError raised — the caller retries or gives up,
    but never loses work already staged to disk."""
    if deadline_s is None:
        return _to_host(x)
    box = {}

    def run():
        try:
            box["v"] = _to_host(x)
        except Exception as e:  # noqa: BLE001 — re-raised below
            box["e"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(deadline_s)
    if t.is_alive():
        err = TimeoutError(
            f"device-to-host copy exceeded {deadline_s:.0f}s "
            f"(wedged transfer?)")
        # The abandoned thread may keep READING state tensors after the
        # caller's locks release; carry it so save() can stamp the
        # store suspect (store.base.SuspectGuard).
        err.orphan = t
        raise err
    if "e" in box:
        raise box["e"]
    return box["v"]


def _fetch_leaf(arr, deadline_s, stats: Optional[dict]):
    """Fetch one device leaf as slabs of <= _SLAB_BYTES (sliced on
    device along the leading axis), each under its own deadline.
    Fail-fast: the first slab timeout raises (a retry inside the lock
    hold only lengthens the ingest stall); recovery is the staged
    resume of the next save()."""
    nbytes = arr.numel() * arr.element_size()
    shape = tuple(arr.shape)
    if deadline_s is None or not shape or nbytes <= _SLAB_BYTES:
        slabs = [arr]
    else:
        rows = shape[0]
        row_bytes = max(1, nbytes // max(rows, 1))
        step = max(1, _SLAB_BYTES // row_bytes)
        slabs = [arr[i:i + step] for i in range(0, rows, step)]
    out = []
    for slab in slabs:
        t0 = time.perf_counter()
        try:
            h = _bounded_get(slab, deadline_s)
        except TimeoutError:
            if stats is not None:
                stats["slab_timeouts"] = stats.get("slab_timeouts", 0) + 1
            raise
        dt = time.perf_counter() - t0
        h = np.asarray(h)
        if stats is not None:
            stats["slabs"] = stats.get("slabs", 0) + 1
            stats["bytes"] = stats.get("bytes", 0) + h.nbytes
            stats["slab_s"] = stats.get("slab_s", 0.0) + dt
            mbps = h.nbytes / 1e6 / max(dt, 1e-9)
            stats["mb_per_s_min"] = round(min(
                stats.get("mb_per_s_min", mbps), mbps), 2)
            stats["mb_per_s_max"] = round(max(
                stats.get("mb_per_s_max", mbps), mbps), 2)
        out.append(h)
    return out[0] if len(out) == 1 else np.concatenate(out, axis=0)


def _state_generation(store, sharded, deadline_s) -> list:
    """A cheap scalar fingerprint of the device state's write history:
    equal generations mean no ingest/sweep/close touched the state
    between two save attempts, so staged leaves from the earlier
    attempt are still a consistent cut and may be reused."""
    def of(st):
        return {
            "write_pos": st.write_pos,
            "ann_write_pos": st.ann_write_pos,
            "bann_write_pos": st.bann_write_pos,
            "pend_pos": st.pend_pos,
            "dep_bank_seq": st.dep_bank_seq,
            "ts_max": st.ts_max,
            **{f"counters.{k}": v for k, v in st.counters.items()},
        }

    if sharded:
        per = [of(st) for st in store.states]
        gen = {k: torch.stack([g[k] for g in per]) for k in per[0]}
    else:
        gen = of(store.state)
    host = _bounded_get(gen, deadline_s)
    # Lists, not tuples: the fingerprint round-trips through JSON and
    # must compare equal to its own deserialization.
    return sorted(
        [k, np.asarray(v).reshape(-1).tolist()] for k, v in host.items())


def _state_items(state):
    """(npz key, tensor) for every leaf, counters expanded."""
    for name in dev.FIELDS:
        value = state.leaves[name]
        if name == "counters":
            for k, v in value.items():
                yield f"counters.{k}", v
        else:
            yield name, value


def _store_items(store, sharded: bool):
    """(npz key, tensor) for every leaf of a single store, or (npz key,
    [one tensor a shard]) for a fleet."""
    if not sharded:
        yield from _state_items(store.state)
        return
    per = [dict(_state_items(st)) for st in store.states]
    for key in per[0]:
        yield key, [p[key] for p in per]


def _host_leaf(leaf, fetch=None) -> np.ndarray:
    """A host copy of one leaf. A fleet's per-shard tensors stack
    ``[n, ...]`` into one host buffer, one shard at a time: straight
    into its slot (``fetch`` None), or through ``fetch`` (the chunked
    path's bounded slabs)."""
    if not isinstance(leaf, list):
        return np.asarray(_to_host(leaf) if fetch is None else fetch(leaf))
    t0 = leaf[0]
    out = np.empty((len(leaf),) + tuple(t0.shape),
                   torch.empty(0, dtype=t0.dtype).numpy().dtype)
    for i, t in enumerate(leaf):
        if fetch is None:
            torch.from_numpy(out[i:i + 1].reshape(tuple(t.shape))).copy_(
                t.detach())
        else:
            out[i] = fetch(t)
    return out


def save(store, path: str, chunk_deadline_s: Optional[float] = None
         ) -> dict:
    """Snapshot a TorchSpanStore OR a ShardedSpanStore to ``path`` (a
    directory), atomically. A fleet saves every leaf stacked
    ``[n_shards, ...]`` on the host; load() restores it as a fleet.

    With ``chunk_deadline_s`` set, the device-to-host gather is CHUNKED
    and RESUMABLE: each leaf transfers in <= 64 MB slabs, each under
    its own deadline, and completed leaves persist in a
    ``<path>.staging`` directory — if a transfer wedges, the failed save
    raises (and stamps the store suspect) but a retry skips everything
    already staged (guarded by a state-generation fingerprint, so a
    write between attempts discards the stage rather than mixing two
    cuts). Returns stats: the phase seconds (``gather_s``, ``crc_s``,
    ``compress_s``, ``rename_s``), ``bytes_on_disk``, slab transfer
    counts, resumed leaves, segment blobs reused and WAL segments
    truncated. A ``TieredSpanStore`` saves as its hot store plus the
    segment manifest and blobs (segments add host IO only, never
    device time under the locks)."""
    # Resident-query-executor quiesce (query/engine.py): wait for any
    # in-flight coalesced query read to finish before the gather
    # begins, so the cut never interleaves with a standing executor's
    # batch (the ordered-shutdown contract: drain-queries →
    # drain-pipeline → seal → gather).
    for eng in getattr(store, "query_engines", lambda: ())():
        eng.drain()
    # The same quiesce for a fleet's cross-shard dispatcher: a fused
    # read mid-dispatch finishes before the gather's cut.
    dispatcher = getattr(store, "dispatcher", None)
    if dispatcher is not None:
        dispatcher.drain()
    tiered = (store if getattr(store, "archive", None) is not None
              and hasattr(store, "hot") else None)
    if tiered is not None:
        store = tiered.hot
    sharded = hasattr(store, "states")
    # A prior save's timeout may have left an orphaned transfer thread
    # still reading the state; a fresh cut must not race it.
    if store.suspect:
        store.ensure_writable(wait_s=5.0)
    # Batches accepted by apply() but still in the pipeline's queues
    # must land in this cut.
    store.drain_pipeline()
    stats: dict = {"resumed_leaves": 0,
                   "chunked": chunk_deadline_s is not None}
    staging = os.path.abspath(path) + ".staging"
    leaves = {}
    t0 = time.perf_counter()
    clocks_of = _sharded_clocks if sharded else _host_clocks
    if chunk_deadline_s is None:
        # One pass over the leaves under the locks: no stage-1 writer,
        # no commit (and, on a single store, no reader) moves the state
        # or the clocks while they are copied out.
        with _cut(store, sharded):
            # Capture-backlog quiesce under the locks: a window pulled
            # before this point seals now; one pulled after cannot lose
            # rows from this cut (its overwriting step waits for the
            # state lock until the gather is done).
            _seal_barrier(store)
            clocks = clocks_of(store)
            for key, leaf in _store_items(store, sharded):
                leaves[key] = _host_leaf(leaf)
    else:
        try:
            with _cut(store, sharded):
                _seal_barrier(store)  # as in the one-pass gather
                clocks = clocks_of(store)
                gen = _state_generation(store, sharded, chunk_deadline_s)
                if os.path.isdir(staging):
                    try:
                        with open(os.path.join(staging, _GEN_FILE)) as f:
                            prior = json.load(f)
                    except (OSError, ValueError):
                        prior = None
                    if prior != gen:
                        shutil.rmtree(staging, ignore_errors=True)
                os.makedirs(staging, exist_ok=True)
                with open(os.path.join(staging, _GEN_FILE), "w") as f:
                    json.dump(gen, f)
                for key, leaf in _store_items(store, sharded):
                    dest = os.path.join(staging, key + ".npy")
                    if os.path.exists(dest):
                        stats["resumed_leaves"] += 1
                        continue
                    host = _host_leaf(leaf, lambda t: _fetch_leaf(
                        t, chunk_deadline_s, stats))
                    tmp_leaf = dest + ".tmp"
                    with open(tmp_leaf, "wb") as f:
                        np.save(f, host, allow_pickle=False)
                    os.replace(tmp_leaf, dest)
        except TimeoutError as e:
            store.mark_suspect(getattr(e, "orphan", None))
            raise
        if stats.get("slab_s"):
            stats["mb_per_s_avg"] = round(
                stats["bytes"] / 1e6 / stats["slab_s"], 2)
        for fname in os.listdir(staging):
            if fname.endswith(".npy"):
                # mmap: the finalize zip streams from the staged files.
                leaves[fname[:-4]] = np.load(
                    os.path.join(staging, fname), mmap_mode="r",
                    allow_pickle=False)
    stats["gather_s"] = time.perf_counter() - t0
    # Paged layout (revision 18): plan_unit keys each claim plan to its
    # WAL seq under the planner lock, so this cut is self-consistent at
    # any boundary: plans at seq <= the snapshot's last_seq replay from
    # the recorded memo; later ones re-derive deterministically.
    planner = getattr(store, "_planner", None)
    paged_meta = planner.snapshot() if planner is not None else None
    with store._lock:
        # Pinned traces' banks must survive restarts, pickled (not
        # wire-encoded) so they restore the exact objects reads
        # returned before the restart.
        pins_snapshot = {tid: list(bank) for tid, bank in store.pins.items()}
        ttls_snapshot = {str(k): v for k, v in store.ttls.items()}
        archive_meta, seg_blobs = (_archive_manifest(tiered)
                                   if tiered is not None else (None, []))
    t0 = time.perf_counter()
    crcs = {k: _slab_crc(v) for k, v in leaves.items()}
    stats["crc_s"] = time.perf_counter() - t0
    meta = {
        "revision": _REVISION,
        "config": store.config._asdict(),
        "shards": store.n if sharded else None,
        "slab_crc32": crcs,
        "ttls": ttls_snapshot,
        "name_lc": {str(k): v for k, v in store._name_lc.items()},
        "dicts": {
            "services": _dict_dump(store.dicts.services),
            "span_names": _dict_dump(store.dicts.span_names),
            "annotations": _dict_dump(store.dicts.annotations),
            "binary_keys": _dict_dump(store.dicts.binary_keys),
            "binary_values": _dict_dump(store.dicts.binary_values),
            "endpoints": _dict_dump(store.dicts.endpoints),
        },
        "clocks": clocks,
    }
    if archive_meta is not None:
        meta["archive"] = archive_meta
    if paged_meta is not None:
        meta["paged"] = paged_meta
    parent = os.path.dirname(os.path.abspath(path)) or "."
    tmp = tempfile.mkdtemp(prefix=".ckpt-", dir=parent)
    old = path + ".old"
    try:
        t0 = time.perf_counter()
        _savez_fast(os.path.join(tmp, _STATE_FILE), leaves)
        stats["compress_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(os.path.join(tmp, _META_FILE), "w") as f:
            json.dump(meta, f)
        if pins_snapshot:
            with open(os.path.join(tmp, _PINS_FILE), "wb") as f:
                f.write(_dump_pins(pins_snapshot))
        if seg_blobs:
            _write_segments(tmp, path, seg_blobs, stats)
        stats["bytes_on_disk"] = sum(
            os.path.getsize(os.path.join(root, n))
            for root, _, names in os.walk(tmp) for n in names)
        # Keep the previous checkpoint alive until the new one is in
        # place: path -> path.old, tmp -> path, then drop path.old. A
        # crash at any point leaves path or path.old restorable.
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(path):
            os.replace(path, old)
        # Crash-harness injection site: dying HERE is the worst mid-swap
        # moment — only path.old (or nothing, on the first save) is
        # restorable and the WAL is not truncated yet.
        kill_point("mid-checkpoint")
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
        del leaves
        shutil.rmtree(staging, ignore_errors=True)
        stats["rename_s"] = time.perf_counter() - t0
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # Checkpoint-coordinated WAL truncation, only after the rename
    # landed — a failed save never shrinks the log.
    if store.wal is not None:
        stats["wal_truncated_segments"] = store.wal.truncate(
            int(clocks["wal_applied"]))
    return stats


def _archive_manifest(tiered):
    """(meta["archive"], [(file name, segment)]) of a tiered store.
    Called under the hot store's ``_lock`` after the gather. The
    manifest cuts at the SEALED frontier, not the pull clock: with an
    async sealer ``_cap_upto`` can run ahead of the last appended
    segment, and a restore re-captures only [captured_upto, wp) from
    the restored rings. The clocks are read BEFORE the segment snapshot
    (segments only grow, so every window sealed before the read has its
    segment in the list); the list may then cover gids past
    captured_upto, a harmless superset (reads dedupe by gid)."""
    hot = tiered.hot
    with hot._cap_lock, hot._seal_lock:
        captured_upto = int(min(hot._cap_upto, hot._sealed_upto))
    segs = tiered.archive.snapshot()
    meta = {
        "params": tiered.params._asdict(),
        "captured_upto": captured_upto,
        "segments": [
            {"seg_id": s.seg_id, "gid_lo": s.gid_lo, "gid_hi": s.gid_hi,
             "n_spans": s.n_spans, "file": f"seg-{s.seg_id:08d}.bin"}
            for s in segs
        ],
    }
    return meta, [(f"seg-{s.seg_id:08d}.bin", s) for s in segs]


def _write_segments(tmp: str, path: str, seg_blobs, stats: dict) -> None:
    """Write the segment blobs under ``tmp/segments``. Segments are
    immutable, so a blob the live snapshot at ``path`` already holds is
    hard-linked (or copied) instead of serialized again — a save costs
    O(new segments), not O(history). Reuse is gated on the blob's own
    header matching the live segment (id, gid range, row count, size),
    not on the file name: a restored older lineage can mint a seg id
    again."""
    seg_dir = os.path.join(tmp, _SEGMENTS_DIR)
    os.makedirs(seg_dir)
    prev_dir = os.path.join(path, _SEGMENTS_DIR)
    for fname, seg in seg_blobs:
        dest = os.path.join(seg_dir, fname)
        prev = os.path.join(prev_dir, fname)
        if _segment_blob_matches(prev, seg):
            try:
                os.link(prev, dest)
            except OSError:
                try:
                    shutil.copyfile(prev, dest)
                except OSError:
                    prev = None
            if prev is not None:
                stats["reused_segments"] = stats.get(
                    "reused_segments", 0) + 1
                continue
        with open(dest, "wb") as f:
            f.write(seg.to_bytes())


def _segment_blob_matches(blob_path: str, seg) -> bool:
    """True iff the blob at ``blob_path`` has the SAME identity header
    as the live segment — a header-only read, never the full blob."""
    import struct

    try:
        with open(blob_path, "rb") as f:
            head = f.read(9)
            if head[:5] != b"ZSEG1":
                return False
            (hlen,) = struct.unpack(">I", head[5:9])
            if hlen > 1 << 22:
                return False
            header = json.loads(f.read(hlen).decode("utf-8"))
    except (OSError, ValueError, struct.error):
        return False
    return (header.get("seg_id") == seg.seg_id
            and header.get("gid_lo") == seg.gid_lo
            and header.get("gid_hi") == seg.gid_hi
            and header.get("n_spans") == seg.n_spans
            and header.get("comp_bytes") == seg.comp_bytes)


def exists(path) -> bool:
    """True when ``load(path)`` has a snapshot to restore — the
    directory itself, or the ``.old`` fallback a crash mid-swap leaves
    behind (a boot that checked only ``path`` would build a fresh store
    and replay the WAL tail against empty dictionaries)."""
    return bool(path) and (os.path.isdir(path)
                           or os.path.isdir(path + ".old"))


def _load_dicts(d: dict) -> DictionarySet:
    dicts = DictionarySet.__new__(DictionarySet)
    # The annotation dump includes the reserved entries, so every
    # dictionary replays in order from empty.
    for name in ("services", "span_names", "annotations", "binary_keys",
                 "binary_values", "endpoints"):
        table = Dictionary()
        _dict_load(table, d[name])
        setattr(dicts, name, table)
    return dicts


class _Members:
    """A snapshot's inflated npz members as the revision migrations read
    them (``files`` and ``[name]``, like the npz file): for a fleet,
    every stacked leaf sliced to one shard."""

    def __init__(self, raw: dict, shard: Optional[int] = None):
        self._raw = raw
        self._shard = shard
        self.files = list(raw)

    def __getitem__(self, name):
        v = self._raw[name]
        if self._shard is None or np.ndim(v) == 0:
            return v
        return v[self._shard]


def _adapt(cols: _Members, revision: int, config, drops_init: int):
    """One state's leaves and counters from a snapshot's members,
    migrated from ``revision`` to the current schema (the reference's
    rules). Returns (leaves, counters) as host arrays."""
    upd = {}
    counters = {}
    for key in cols.files:
        if key.startswith("counters."):
            counters[key.split(".", 1)[1]] = cols[key]
        else:
            upd[key] = cols[key]
    # Counters the snapshot predates keep their init defaults; counters
    # the schema no longer carries are dropped.
    counters = {k: v for k, v in counters.items() if k in dev.COUNTER_NAMES}
    if revision < 9:
        # Pre-rev-8 stores never counted key-claim drops, and rev-8
        # tables are tombstoned below: either way absence proves
        # nothing, so the negative-lookup gate stays off for good.
        drops = int(np.asarray(counters.get("key_claim_drops", drops_init)))
        counters["key_claim_drops"] = np.int64(max(drops, 1))
    if revision < 11:
        # Revision 11 merged every index family into ONE arena: drop the
        # stale per-family arrays and poison trust per segment — the
        # candidate prefix for good (scans serve), the trace suffix
        # seeded at the restore-time write_pos (self-heals after one
        # ring lap).
        for k in ("tr_idx", "tr_pos", "tr_wm",
                  "cand_idx", "cand_pos", "cand_wm"):
            upd.pop(k, None)
        n_total = config.idx_layout[1]
        n_cand = config.cand_layout[1]
        upd["cand_pos"] = np.full(n_total, 1 << 60, np.int64)
        wp = upd.get("write_pos")
        tr_seed = dev.I64_MAX if wp is None else int(np.asarray(wp))
        upd["cand_wm"] = np.where(np.arange(n_total) < n_cand,
                                  np.int64(dev.I64_MAX),
                                  np.int64(tr_seed)).astype(np.int64)
    if revision < 9 and "key_tab" in upd:
        # Pre-9 tables stored exact 64-bit key words; the claim-is-first-
        # record invariant can't be re-certified, so tombstone the table.
        upd["key_tab"] = np.full(np.asarray(upd["key_tab"]).shape,
                                 dev._FP_TOMB, np.int32)
        if "key_wm" in upd:
            upd["key_wm"] = np.full(np.asarray(upd["key_wm"]).shape,
                                    dev.I64_MAX, np.int64)
    upd = {k: v for k, v in upd.items() if k in dev.FIELDS}
    if "span_tab" in upd and np.asarray(upd["span_tab"]).dtype == np.int64:
        # Pre-11 packed i64 words -> [H, 2] i32 planes: a lossless
        # little-endian bitcast, gated on the stored dtype.
        tab = np.asarray(upd["span_tab"])
        if revision < 7:
            tab = np.where(tab == 0, dev._TAB_EMPTY, tab)
        tab = np.ascontiguousarray(tab)
        upd["span_tab"] = tab.view(np.int32).reshape(tab.shape + (2,))
    if revision < 4:
        _migrate_legacy_live_links(cols, upd, config)
    if "dep_banks" not in upd:
        # Pre-revision-3 snapshot: the saved dep_moments becomes the
        # all-time tail, marked as covering every window.
        if float(np.asarray(cols["dep_moments"])[:, 0].sum()) > 0:
            upd["dep_overflow_ts"] = np.array([dev.I64_MIN, dev.I64_MAX],
                                              np.int64)
    # Host tensors now, so the placement under the store's locks only
    # copies.
    return ({k: torch.from_numpy(np.asarray(v, order="C"))
             for k, v in upd.items()},
            {k: int(np.asarray(v)) for k, v in counters.items()})


def _place(state, leaves: dict, counters: dict, revision: int,
           device) -> None:
    """Copy one state's restored leaves onto ``device`` (in place where
    the shape and dtype match) and run the trust migrations of
    snapshots that predate the index families (pre-6) or ann_poison
    (pre-7)."""
    cur = state.leaves
    for k, src in leaves.items():
        t = cur[k]
        if tuple(t.shape) == tuple(src.shape) and t.dtype == src.dtype:
            t.copy_(src)
        else:
            cur[k] = src.to(device)
    for k, v in counters.items():
        cur["counters"][k].fill_(v)
    if revision < 6:
        # Empty buckets whose zero cursors claim completeness: poison.
        dev.poison_index_trust(state)
    if revision < 7:
        dev.poison_ann_trust(state)


def load(path: str, device="cuda", config_defaults=None,
         stats: Optional[dict] = None):
    """Restore a store on ``device`` from a snapshot directory written
    by either package (falling back to ``.old`` if a save crashed
    mid-swap): a TorchSpanStore, a ``TieredSpanStore`` around one for a
    tiered snapshot (``meta["archive"]``), or a ``ShardedSpanStore``
    with the snapshot's shard count for a sharded one
    (``meta["shards"]``; every shard on ``device``).

    ``config_defaults`` fills config keys the snapshot's meta does NOT
    carry (a knob newer than the snapshot) — keys in the meta always
    win, since the saved leaves were shaped by them. ``stats``, when
    given, receives the phase seconds: ``inflate_s`` (reading and
    decompressing the leaves), ``crc_s``, ``h2d_s`` and ``total_s``."""
    t_start = time.perf_counter()
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        path = path + ".old"
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    cfg_map = dict(meta["config"])
    for k, v in (config_defaults or {}).items():
        cfg_map.setdefault(k, v)
    config = dev.StoreConfig(**cfg_map)
    codec = SpanCodec(_load_dicts(meta["dicts"]))
    n_shards = meta.get("shards")
    if n_shards:
        from zipkin_tpu_torch.parallel.shard import ShardedSpanStore

        store = ShardedSpanStore(n_shards, config, device=device,
                                 codec=codec)
        states = store.states
    else:
        store = TorchSpanStore(config, codec=codec, device=device)
        states = [store.state]
    store.ttls = {int(k): v for k, v in meta["ttls"].items()}
    store._name_lc = {int(k): v for k, v in meta["name_lc"].items()}
    pins_path = os.path.join(path, _PINS_FILE)
    if os.path.exists(pins_path):
        with open(pins_path, "rb") as f:
            for tid, bank in _SpanUnpickler(f).load().items():
                store.pins.pin(int(tid), bank)

    data = np.load(os.path.join(path, _STATE_FILE))
    # Slab integrity (revision 13): every leaf checks against its
    # manifest CRC32 before anything reaches the device. Pre-13
    # snapshots carry no CRCs and skip the check.
    crcs = meta.get("slab_crc32") or {}
    times = {"inflate_s": 0.0, "crc_s": 0.0, "h2d_s": 0.0}

    def _leaf(key):
        t0 = time.perf_counter()
        arr = np.asarray(data[key])
        t1 = time.perf_counter()
        want = crcs.get(key)
        bad = want is not None and _slab_crc(arr) != int(want)
        times["inflate_s"] += t1 - t0
        times["crc_s"] += time.perf_counter() - t1
        if bad:
            raise CorruptSlabError(
                f"checkpoint slab '{key}' fails its manifest CRC32 — "
                f"snapshot at {path} is damaged; restore from the .old "
                f"snapshot or an earlier checkpoint + WAL replay")
        return arr

    raw = {key: _leaf(key) for key in data.files}
    revision = meta.get("revision", 1)
    drops_init = int(states[0].counters["key_claim_drops"])
    shards = [None] if not n_shards else list(range(n_shards))
    restored = [_adapt(_Members(raw, i), revision, config, drops_init)
                for i in shards]
    clocks = meta.get("clocks")
    t0 = time.perf_counter()
    if n_shards:
        with store._lock, store._rw.write():
            for st, (leaves, counters) in zip(states, restored):
                _place(st, leaves, counters, revision, store.device)
                if revision < 4:
                    # The pre-rev-4 schema had no span table: re-insert
                    # the resident spans so later children find parents.
                    dev.rebuild_span_tab(st)
        times["h2d_s"] = _synced(store.device, t0)
        inner = store.inner
        inner._wp_upper = max(int(st.write_pos) for st in states)
        # Links resolve at ingest; the clock only paces time-bucket
        # rotation, so resume it at "just rotated".
        inner._archived_lower = inner._wp_upper
        # The restored aggregates were never deltas on this process's
        # per-shard mirror twins: resync lazily on the first sketch-tier
        # read (FleetMirror.mark_cold cascades).
        store._fleet_mirror.mark_cold()
        if clocks and clocks.get("sharded"):
            # Revision-16 sharded snapshots carry the fleet pacing
            # clocks: restore them EXACTLY so a ShardedWal tail replay
            # re-cuts the uncrashed fleet's launch units.
            inner._wp_upper = int(clocks["wp_upper"])
            inner._archived_lower = int(clocks["archived_lower"])
            inner._batches_since_sweep = int(clocks["batches_since_sweep"])
            # The store is load-local (not yet published to any reader
            # or writer thread), so the bare clock store is race-free.
            store._step_seq = int(  # graftlint: disable=guarded-by
                clocks.get("step_seq", 0))
            store._wal_applied = int(clocks.get("wal_applied", 0))
    else:
        leaves, counters = restored[0]
        # _cap_lock before _state_lock (the store's order): the capture
        # clocks below are _cap_lock's, and _sealed_upto its leaf
        # _seal_lock's, as the reference writes them.
        with store._lock, store._cap_lock, store._state_lock:
            _place(store.state, leaves, counters, revision, store.device)
            if revision < 4:
                dev.rebuild_span_tab(store.state)
            times["h2d_s"] = _synced(store.device, t0)
            # Re-seed the host clocks that pace bucket rotation — or,
            # for revision-13 snapshots, restore them EXACTLY, so a WAL
            # replay re-cuts the uncrashed drive's launches.
            store._wp = int(store.state.write_pos)
            store._archived = store._wp
            if clocks:
                store._archived = int(clocks["archived"])
                store._batches_since_sweep = int(
                    clocks["batches_since_sweep"])
                store._awp = int(clocks["awp"])
                store._bwp = int(clocks["bwp"])
                store._cap_upto = int(clocks["cap_upto"])
                store._cap_a = int(clocks["cap_a"])
                store._cap_b = int(clocks["cap_b"])
                with store._seal_lock:
                    store._sealed_upto = int(clocks["sealed_upto"])
                store._wal_applied = int(clocks.get("wal_applied", 0))
            # The restored aggregates were never deltas on this
            # process's sketch mirror: ensure_sketch_mirror resyncs it
            # on first read.
            store.sketch_mirror.mark_cold()
            # Paged layout (revision 18): restore the page allocator and
            # table — or, for a paged config pointed at a snapshot saved
            # without it, rebuild the table from the resident columns.
            if store._planner is not None:
                pmeta = meta.get("paged")
                if pmeta:
                    store._planner.restore(pmeta)
                else:
                    store._planner.rebuild(
                        _to_host(store.state.row_gid),
                        _to_host(store.state.trace_id),
                        wal_applied=store._wal_applied)
        arch = meta.get("archive")
        if arch:
            store = _restore_tiered(path, store, arch,
                                    exact_clocks=bool(clocks))
    if stats is not None:
        stats.update(times)
        stats["total_s"] = time.perf_counter() - t_start
    return store


def _synced(device, t0: float) -> float:
    """Seconds since ``t0`` once ``device`` has finished its copies."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _restore_tiered(path: str, store, arch: dict,
                    exact_clocks: bool = False):
    """Rebuild the TieredSpanStore around a restored hot store: the
    segments load from their blobs, then either the saved capture
    clocks stand (``exact_clocks``, revision 13+: capture resumes
    mid-stride, so a WAL replay cuts the uncrashed drive's windows) or
    the capture clock restarts at the segments' CONTIGUOUS frontier and
    one ``capture_now`` flushes the resident uncaptured window, which
    re-aligns the side-ring clocks (their host mirrors do not survive a
    restart; the overlap with the ring is deduped by gid)."""
    from zipkin_tpu_torch.store.archive import (
        ArchiveParams,
        Segment,
        SegmentDirectory,
        TieredSpanStore,
    )

    params = ArchiveParams(**arch["params"])
    directory = SegmentDirectory(params, store.codec)
    segs = []
    for ent in arch["segments"]:
        with open(os.path.join(path, _SEGMENTS_DIR, ent["file"]),
                  "rb") as f:
            segs.append(Segment.from_bytes(f.read()))
    sizes = (len(store.dicts.services), len(store.dicts.span_names),
             len(store.dicts.annotations), len(store.dicts.binary_keys),
             len(store.dicts.binary_values), len(store.dicts.endpoints))
    for seg in segs:
        # Every id a segment references lies below its seal-time
        # dictionary marks; the restored dictionaries must cover them.
        if any(have < need for have, need in zip(sizes, seg.dict_sizes)):
            raise ValueError(
                f"segment {seg.seg_id} references dictionary ids past "
                f"the restored dictionaries ({sizes} < "
                f"{seg.dict_sizes}); snapshot is inconsistent")
    directory.restore(segs, max((s.seg_id for s in segs), default=-1) + 1)
    tiered = TieredSpanStore(store, params=params, directory=directory)
    if exact_clocks:
        return tiered
    # Walk contiguity, not max(gid_hi): where a failed async seal left
    # a hole, the frontier stops below it so the flush re-captures what
    # of it the restored rings still hold.
    frontier = int(arch.get("captured_upto", 0))
    for s in sorted(segs, key=lambda s: s.gid_lo):
        if s.gid_lo <= frontier:
            frontier = max(frontier, s.gid_hi)
    with store._cap_lock:
        store._cap_upto = min(frontier, store._wp)
        store._cap_a = store._cap_b = 0
        with store._seal_lock:
            store._sealed_upto = store._cap_upto
    store._awp = store._bwp = 0
    tiered.capture_now()
    return tiered


def _migrate_legacy_live_links(data, upd, config) -> None:
    """Pre-revision-4 snapshots carry links only in dep_moments/dep_banks
    plus an eviction watermark (dep_archived_gid): links of unarchived
    resident children existed only implicitly. Reconstruct exactly those
    links here (host numpy, the same segmented-Moments arithmetic as the
    reference) into the streaming-join window bank, and queue children
    whose parent was NOT resident into the pending ring (packed with the
    bit-identical host mixer), so a parent arriving after the upgrade
    still links. An upgrade loses nothing. ``data`` is one state's
    members (``_Members``): a fleet migrates shard by shard, each shard
    reading its own slice of every stacked leaf."""
    from zipkin_tpu_torch.columnar.schema import FLAG_HAS_PARENT
    from zipkin_tpu_torch.ops.hashing import np_mix_keys64

    S = config.max_services
    Q = config.pending_slots

    def col(name):
        if name in data.files:
            return np.asarray(data[name])
        if name == "dep_archived_gid":
            # Revision-1 layout: no watermark leaf, but its dep_moments
            # bank was the complete link state — treat the ring as fully
            # archived or every resident link would double-count.
            return np.asarray(data["write_pos"])
        return np.int64(0)

    gid = col("row_gid")
    live = gid >= 0
    has_parent = (col("flags") & int(FLAG_HAS_PARENT)) != 0
    archived = np.int64(col("dep_archived_gid"))
    tid, sid, pid = col("trace_id"), col("span_id"), col("parent_id")
    svc, dur = col("service_id"), col("duration")
    tsf, tsl = col("ts_first"), col("ts_last")
    probe = live & has_parent & (gid >= archived)
    window = np.zeros((S * S, 5), np.float32)
    wts = np.array([dev.I64_MAX, dev.I64_MIN], np.int64)
    pend = {
        "pend_key": np.zeros(Q, np.int64),
        "pend_dur": np.zeros(Q, np.int64),
        "pend_tsf": np.zeros(Q, np.int64),
        "pend_tsl": np.zeros(Q, np.int64),
        "pend_pos": np.int64(0),
    }
    if probe.any():
        order = np.lexsort((sid[live], tid[live]))
        b_tid, b_sid = tid[live][order], sid[live][order]
        b_svc = svc[live][order]
        q_tid, q_pid = tid[probe], pid[probe]
        # Two-key search: positions where (tid, sid) == (q_tid, q_pid).
        bk = np.rec.fromarrays([b_tid, b_sid])
        qk = np.rec.fromarrays([q_tid, q_pid])
        pos = np.searchsorted(bk, qk)
        pos_c = np.clip(pos, 0, len(bk) - 1)
        found = (len(bk) > 0) & (bk[pos_c] == qk)
        psvc = np.where(found, b_svc[pos_c], -1)
        csvc = svc[probe]
        d = dur[probe]
        ok = (found & (psvc >= 0) & (csvc >= 0) & (psvc < S)
              & (csvc < S) & (d >= 0))
        # Children with no resident parent: queue the newest Q so a
        # parent arriving after the upgrade still links via dep_sweep.
        pend_mask = ~found & (csvc >= 0) & (csvc < S) & (d >= 0)
        if pend_mask.any():
            sel = np.flatnonzero(pend_mask)[-Q:]
            nq = sel.size
            key48 = np_mix_keys64([q_tid[sel], q_pid[sel]]) >> np.uint64(16)
            svc_part = (np.clip(csvc[sel], -1, dev._SVC_MASK - 2)
                        .astype(np.uint64) + np.uint64(1))
            packed = ((key48 << np.uint64(16))
                      | (svc_part << np.uint64(1))
                      | np.uint64(1)).view(np.int64)
            pend["pend_key"][:nq] = packed
            pend["pend_dur"][:nq] = d[sel]
            pend["pend_tsf"][:nq] = tsf[probe][sel]
            pend["pend_tsl"][:nq] = tsl[probe][sel]
            pend["pend_pos"] = np.int64(nq)
        if ok.any():
            link = (psvc.astype(np.int64) * S + csvc)[ok]
            dv = d[ok].astype(np.float64)
            n = np.bincount(link, minlength=S * S).astype(np.float64)
            sx = np.bincount(link, weights=dv, minlength=S * S)
            mean = np.divide(sx, n, out=np.zeros_like(sx), where=n > 0)
            c = dv - mean[link]
            m2 = np.bincount(link, weights=c * c, minlength=S * S)
            m3 = np.bincount(link, weights=c * c * c, minlength=S * S)
            m4 = np.bincount(link, weights=c * c * c * c, minlength=S * S)
            window = np.stack([n, mean, m2, m3, m4], axis=-1).astype(
                np.float32)
            ptsf, ptsl = tsf[probe][ok], tsl[probe][ok]
            lo = ptsf[ptsf >= 0]
            hi = ptsl[ptsl >= 0]
            if lo.size:
                wts[0] = lo.min()
            if hi.size:
                wts[1] = hi.max()
    upd["dep_window"] = window
    upd["dep_window_ts"] = wts
    for k, v in pend.items():
        upd[k] = np.asarray(v)
