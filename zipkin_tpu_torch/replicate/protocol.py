"""WAL-ship wire protocol: length-framed, CRC-checked JSON + blobs.

The port's copy of ``zipkin_tpu/replicate/protocol.py``: frames are
byte for byte the reference's, so a follower of either package follows
a primary of the other. ``config_from_dict`` builds the port's
``store/device.StoreConfig`` (the same fields and defaults).

Rides the same framed-TCP shape as the rest of the wire layer (the
scribe server's ``u32 length | payload`` framing,
ingest/scribe_server.py) with the WAL's integrity discipline: every
frame carries a CRC32 over its body, and a bad CRC drops the
connection rather than desyncing the stream.

Frame layout::

    u32 frame_len | u8 msg_type | u32 crc32(body) | body
    body = u32 meta_len | meta json | blobs back-to-back

``meta`` describes the blobs (names/sizes) exactly like wal/record.py
describes its column planes — no per-blob framing. Messages:

client → server
    HELLO  {proto, follower, mode}        — once per connection
    FETCH  {cursor, ack, max_bytes}       — cursor = highest applied
           seq (read position); ack = highest LOCALLY-DURABLE seq
           (retention pin; defaults to cursor). A warm standby acks
           its checkpointed frontier, not its volatile applied one, so
           a crashed standby can always re-replay from its checkpoint.
    ANCHOR {}                             — request a bootstrap anchor

server → client
    HELLO_OK {config, last_seq, durable_seq, first_seq}
    RECORDS  {seqs: [s0, n], sizes: [...], last_seq, durable_seq}
             + the n record payloads as blobs (may be n = 0: heartbeat)
    ANCHOR_OK {applied_seq, wp, dicts, arrays: [[name, dtype, shape]..]}
             + the mirror arrays as blobs
    NEED_ANCHOR {first_seq}               — cursor precedes the log
    ERR      {error}

The FETCH ack advances the follower's retention pin
(wal.register_cursor), so truncation never outruns the slowest
registered follower's DURABLE frontier. RECORDS only ever
carries records at or below the primary's DURABLE frontier — a
follower can never apply what the primary could still lose, which is
what makes "un-acked tail absent in full" hold across the pair.

Fleet-observability ride-alongs (r17, all OPTIONAL meta keys an older
peer simply ignores — the codec passes unknown keys through):

- FETCH may carry ``spans`` (a list of wire-form self-trace spans,
  obs.fleet.span_to_wire) — the follower's apply spans backhauled to
  the primary, which owns the writable store and stitches them into
  the batch-lineage trace; and ``metrics`` (a registry snapshot,
  obs.fleet.registry_snapshot, throttled to ~1/s) — the follower's
  half of the ``/metrics?fleet=1`` federation.
- Record PAYLOADS may carry lineage meta (``ts``, sampled ``b3``) in
  their WAL json header (wal/record.encode_unit extra); followers
  read them with wal/record.unit_meta. Replay ignores the keys, so
  shipped bytes stay bitwise-deterministic inputs to apply.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

PROTO_VERSION = 1

# Message types.
HELLO = 1
FETCH = 2
ANCHOR = 3
HELLO_OK = 16
RECORDS = 17
ANCHOR_OK = 18
NEED_ANCHOR = 19
ERR = 20

_FRAME = struct.Struct(">IBI")  # frame_len covers type+crc+body
_LEN = struct.Struct(">I")
# A frame past this is a desynced/hostile stream, not a message (the
# scribe server's MAX_FRAME role).
MAX_FRAME = 256 << 20


class ShipProtocolError(RuntimeError):
    """Framing/CRC/lineage violation on the ship stream — the
    connection is dropped and re-established rather than resynced."""


def encode_msg(msg_type: int, meta: dict,
               blobs: Tuple[bytes, ...] = ()) -> bytes:
    mjson = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    body = b"".join((_LEN.pack(len(mjson)), mjson, *blobs))
    return _FRAME.pack(
        1 + 4 + len(body), msg_type, zlib.crc32(body)) + body


def decode_msg(frame: bytes) -> Tuple[int, dict, bytes]:
    """(msg_type, meta, blob_bytes) from one frame body (the caller
    already stripped the u32 length word)."""
    if len(frame) < 1 + 4:
        raise ShipProtocolError("short ship frame")
    msg_type = frame[0]
    (crc,) = _LEN.unpack_from(frame, 1)
    body = frame[5:]
    if zlib.crc32(body) != crc:
        raise ShipProtocolError("ship frame CRC mismatch")
    if len(body) < _LEN.size:
        raise ShipProtocolError("truncated ship meta")
    (mlen,) = _LEN.unpack_from(body, 0)
    if mlen > len(body) - _LEN.size:
        raise ShipProtocolError("truncated ship meta")
    meta = json.loads(body[_LEN.size:_LEN.size + mlen].decode("utf-8"))
    return msg_type, meta, body[_LEN.size + mlen:]


def read_msg(sock) -> Optional[Tuple[int, dict, bytes]]:
    """Read one framed message; None on orderly disconnect."""
    from zipkin_tpu_torch.ingest.scribe_server import read_exact

    header = read_exact(sock, 4)
    if header is None:
        return None
    (n,) = struct.unpack(">I", header)
    if n < 5 or n > MAX_FRAME:
        raise ShipProtocolError(f"bad ship frame length {n}")
    frame = read_exact(sock, n)
    if frame is None:
        return None
    return decode_msg(frame)


# -- records ----------------------------------------------------------


def encode_records(records: List[Tuple[int, bytes]], last_seq: int,
                   durable_seq: int) -> bytes:
    meta = {
        "seqs": [records[0][0] if records else 0, len(records)],
        "sizes": [len(p) for _, p in records],
        "last_seq": int(last_seq),
        "durable_seq": int(durable_seq),
    }
    return encode_msg(RECORDS, meta,
                      tuple(p for _, p in records))


def decode_records(meta: dict, blob: bytes
                   ) -> Tuple[List[Tuple[int, bytes]], int, int]:
    s0, n = meta["seqs"]
    sizes = meta["sizes"]
    if len(sizes) != n or sum(sizes) != len(blob):
        raise ShipProtocolError("RECORDS blob/size mismatch")
    out = []
    off = 0
    for i, size in enumerate(sizes):
        out.append((s0 + i, blob[off:off + size]))
        off += size
    return out, int(meta["last_seq"]), int(meta["durable_seq"])


# -- anchors ----------------------------------------------------------


def encode_anchor(applied_seq: int, wp: int, config_dict: dict,
                  dict_values: dict, arrays: List[np.ndarray]) -> bytes:
    specs = []
    blobs = []
    for i, a in enumerate(arrays):
        a = np.ascontiguousarray(a)
        specs.append([f"a{i}", a.dtype.str, list(a.shape)])
        blobs.append(a.tobytes())
    meta = {
        "applied_seq": int(applied_seq), "wp": int(wp),
        "config": config_dict, "dicts": dict_values, "arrays": specs,
    }
    return encode_msg(ANCHOR_OK, meta, tuple(blobs))


def decode_anchor(meta: dict, blob: bytes):
    """(applied_seq, wp, config_dict, dict_values, arrays)."""
    arrays = []
    off = 0
    for _name, dtype, shape in meta["arrays"]:
        dt = np.dtype(dtype)
        count = int(np.prod(shape)) if shape else 1
        nbytes = dt.itemsize * count
        arrays.append(np.frombuffer(
            blob, dtype=dt, count=count, offset=off
        ).reshape(shape).copy())
        off += nbytes
    return (int(meta["applied_seq"]), int(meta["wp"]), meta["config"],
            meta["dicts"], arrays)


# -- config -----------------------------------------------------------


def config_to_dict(config) -> dict:
    """A StoreConfig as a JSON-safe dict (NamedTuple of scalars)."""
    return {k: v for k, v in config._asdict().items()}


def config_from_dict(d: dict):
    from zipkin_tpu_torch.store.device import StoreConfig

    base = StoreConfig()._asdict()
    # Ignore fields this build doesn't know (forward compat) and let
    # the defaults fill ones the primary didn't send.
    base.update({k: v for k, v in d.items() if k in base})
    return StoreConfig(**base)
