"""WAL unit records: the stage-1 encoded launch group ↔ bytes.

What gets journaled is the ``TpuSpanStore._plan_units`` output — one
launch unit's chunker parts, each a (SpanBatch, name_lc, indexable)
triple — BEFORE the donating commit. Journaling at this point (post
encode, pre pad) is what makes replay deterministic: the columns
already carry final dictionary ids, and replay re-pads through the
same ``_pad_unit`` body, so a replayed drive cuts bitwise-identical
launches (the serial==pipelined property extended across a
restart).

Because the columns are dictionary ids, each record also carries the
DICTIONARY DELTA its encode step appended — the entries between the
previous record's high-water sizes and this one's. Dictionaries are
append-only and encode order equals journal order (both happen under
the store's encode lock), so replaying deltas in sequence rebuilds the
exact id assignment; a record whose "before" sizes don't match the
replay-time dictionaries is a checkpoint/log mismatch and fails fast
(``WalReplayError``) instead of decoding garbage.

Payload layout (inside the log's CRC frame):

    u32 meta_len | meta json | column blobs back-to-back

where meta lists, per part, each column's (name, dtype, length) in a
fixed order (SpanBatch columns + name_lc + indexable) and the blobs
follow in exactly that order — no per-column framing needed.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from zipkin_tpu_torch.columnar.schema import SpanBatch

_LEN = struct.Struct(">I")

# Fixed column order per part; the two host-side sidecars ride last.
_PART_COLS: Tuple[str, ...] = (
    SpanBatch.SPAN_COLUMNS + SpanBatch.ANN_COLUMNS
    + SpanBatch.BANN_COLUMNS
)
_EXTRA_COLS: Tuple[str, ...] = ("name_lc", "indexable")

# Dictionary order is part of the record format (sizes/deltas are
# positional) — it matches checkpoint.save's meta["dicts"] order.
DICT_NAMES: Tuple[str, ...] = (
    "services", "span_names", "annotations", "binary_keys",
    "binary_values", "endpoints",
)


class WalReplayError(RuntimeError):
    """A WAL record is inconsistent with the state being replayed into
    (dictionary high-water mismatch, unknown record version): the log
    and the checkpoint are not from the same lineage. Recovery fails
    fast rather than committing misencoded batches."""


def dict_sizes(dicts) -> List[int]:
    return [len(getattr(dicts, name)) for name in DICT_NAMES]


def dump_value(v) -> dict:
    """Tagged JSON form of one dictionary entry — the ONE codec shared
    by WAL records and checkpoint manifests (checkpoint._dict_dump
    delegates here). apply_dict_deltas equality-verifies restored
    checkpoint entries against WAL-delta values, so the two surfaces
    must stay byte-compatible forever; sharing the codec makes drift
    impossible."""
    if isinstance(v, bytes):
        return {"b": v.hex()}
    if isinstance(v, tuple):
        return {"t": list(v)}
    if v is None:
        return {"n": None}
    return {"s": v}


def load_value(item: dict):
    """Inverse of dump_value."""
    if "b" in item:
        return bytes.fromhex(item["b"])
    if "t" in item:
        return tuple(item["t"])
    if "n" in item:
        return None
    return item["s"]


def dump_dict_deltas(dicts, before: Sequence[int]
                     ) -> Tuple[List[int], Dict[str, list]]:
    """(current sizes, per-dictionary entry dumps for [before, now)).
    Caller holds the store's encode lock, so the sizes are stable."""
    sizes = dict_sizes(dicts)
    deltas: Dict[str, list] = {}
    for i, name in enumerate(DICT_NAMES):
        if sizes[i] > before[i]:
            d = getattr(dicts, name)
            values = d.values()
            deltas[name] = [
                dump_value(v) for v in values[before[i]:sizes[i]]
            ]
    return sizes, deltas


def apply_dict_deltas(dicts, before: Sequence[int],
                      deltas: Dict[str, list]) -> None:
    """Replay one record's dictionary delta. Entries already present
    (the checkpoint's dictionary snapshot can run ahead of its applied
    sequence — it is cut later, under the host lock) are VERIFIED
    rather than re-encoded; a mismatch is a lineage error."""
    for i, name in enumerate(DICT_NAMES):
        d = getattr(dicts, name)
        have = len(d)
        if have < before[i]:
            raise WalReplayError(
                f"dictionary '{name}' has {have} entries but the WAL "
                f"record was encoded against {before[i]} — the log "
                f"does not belong to this checkpoint lineage")
        for j, item in enumerate(deltas.get(name, ())):
            pos = before[i] + j
            value = load_value(item)
            if pos < have:
                existing = d.decode(pos + d._first_id)
                if existing != value:
                    raise WalReplayError(
                        f"dictionary '{name}' entry {pos} is "
                        f"{existing!r} but the WAL record appended "
                        f"{value!r} — checkpoint/log lineage mismatch")
                continue
            got = d.encode(value)
            if got != pos + d._first_id:
                raise WalReplayError(
                    f"dictionary '{name}' assigned id {got} replaying "
                    f"entry {pos} — out-of-order replay or lineage "
                    f"mismatch")


def encode_unit(group, before: Sequence[int],
                deltas: Dict[str, list],
                extra: Dict[str, object] = None) -> bytes:
    """One launch group (list of (SpanBatch, name_lc, indexable)) plus
    its dictionary delta → record payload bytes.

    ``extra`` merges additional meta keys into the record header —
    lineage keys the fleet-observability layer stamps (``ts``: commit
    timestamp µs, ``b3``: [trace_id, span_id] of the sampled launch
    unit's self-trace). ``decode_unit`` ignores unknown keys, so
    stamped and unstamped records replay identically; the keys ride
    the shipped payload to followers, who read them via
    ``unit_meta``."""
    parts_meta = []
    blobs: List[bytes] = []
    for batch, name_lc, indexable in group:
        cols = []
        for col in _PART_COLS:
            arr = np.ascontiguousarray(getattr(batch, col))
            cols.append([col, arr.dtype.str, int(arr.shape[0])])
            blobs.append(arr.tobytes())
        for col, arr in zip(_EXTRA_COLS, (name_lc, indexable)):
            arr = np.ascontiguousarray(arr)
            cols.append([col, arr.dtype.str, int(arr.shape[0])])
            blobs.append(arr.tobytes())
        parts_meta.append(cols)
    head = {"v": 1, "before": list(map(int, before)), "deltas": deltas,
            "parts": parts_meta}
    if extra:
        for k in ("v", "before", "deltas", "parts"):
            if k in extra:
                raise ValueError(f"extra meta key {k!r} shadows the "
                                 f"record header")
        head.update(extra)
    meta = json.dumps(head, separators=(",", ":")).encode("utf-8")
    return _LEN.pack(len(meta)) + meta + b"".join(blobs)


def unit_meta(payload: bytes) -> Dict[str, object]:
    """Record payload → its json meta header alone (no column blobs
    decoded). Followers use this to read the lineage keys (``ts``,
    ``b3``) off a shipped record without paying a second columnar
    decode."""
    (mlen,) = _LEN.unpack_from(payload, 0)
    return json.loads(payload[_LEN.size:_LEN.size + mlen]
                      .decode("utf-8"))


def decode_unit(payload: bytes):
    """Record payload → (group, before_sizes, deltas); the inverse of
    ``encode_unit``. Raises WalReplayError on an unknown version (the
    frame CRC already vouches for the bytes themselves)."""
    (mlen,) = _LEN.unpack_from(payload, 0)
    meta = json.loads(payload[_LEN.size:_LEN.size + mlen]
                      .decode("utf-8"))
    if meta.get("v") != 1:
        raise WalReplayError(
            f"unknown WAL record version {meta.get('v')!r}")
    off = _LEN.size + mlen
    group = []
    for cols in meta["parts"]:
        arrays = {}
        for col, dtype, length in cols:
            dt = np.dtype(dtype)
            nbytes = dt.itemsize * length
            arrays[col] = np.frombuffer(
                payload, dtype=dt, count=length, offset=off
            ).copy()
            off += nbytes
        name_lc = arrays.pop("name_lc")
        indexable = arrays.pop("indexable")
        group.append((SpanBatch(**arrays), name_lc, indexable))
    return group, meta["before"], meta["deltas"]
