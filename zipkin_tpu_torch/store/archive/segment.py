"""Immutable compressed columnar segments + sketch zone-maps.

The port's copy of ``zipkin_tpu/store/archive/segment.py``; the byte
format (``to_bytes``/``from_bytes``) is the reference's, so a segment
sealed by either package loads in the other.

A segment is the cold-tier unit: the SpanBatch column planes of one
capture window (plus the per-row global ids), deflate-compressed per
column, under a zone-map header built from the repo's sketch
primitives. The zone map answers "can this segment possibly contain a
match?" without touching the compressed rows:

- ``ts_last_min``/``ts_last_max`` — index queries filter on a span's
  last timestamp (`<= end_ts`), so a segment whose minimum valid last
  timestamp exceeds ``end_ts`` can be skipped outright.
- ``service_ids`` — exact set of (annotation-host) service ids present;
  the bitmap role, exact because the dictionary keeps ids dense.
- ``key_cms`` — one count-min over tagged (service, key) pairs: span
  names, user annotation values, binary keys, (binary key, value)
  pairs. CMS never under-counts, so a zero is a proof of absence.
- ``trace_bloom`` — trace-id membership (no false negatives).
- ``hll`` — distinct trace ids (cold-tier cardinality telemetry).
- ``dur_hist`` — per-service duration log-histograms in the exact
  ops.quantile geometry of the device svc_hist, so hot and cold rows
  merge by ``+`` and quantiles read through the same
  ``quantiles_host``.

All header parts are monoids (OR / + / max / set-union / min-max), so
the compactor merges zone maps without re-scanning rows. Segments are
immutable once sealed; ``to_bytes``/``from_bytes`` give the durable
form the checkpoint manifest references. The ``dict_sizes`` high-water
tuple records how much of each shared dictionary the segment's ids
reference — the "dictionary delta" boundary a restore validates
(dictionaries are append-only, so ids below the mark decode forever).
"""

from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from zipkin_tpu_torch.columnar.encode import _norm_value
from zipkin_tpu_torch.columnar.schema import SpanBatch
from zipkin_tpu_torch.models.constants import CORE_ANNOTATIONS
from zipkin_tpu_torch.ops.hashing import np_mix_keys64
from zipkin_tpu_torch.store.archive import sketches as SK

_MAGIC = b"ZSEG1"
_DEFLATE_LEVEL = 1  # same tradeoff as checkpoint._savez_fast

# Zone-key tags: one CMS, four key spaces.
TAG_NAME = 1  # (service, lowercased span-name id)
TAG_ANN = 2  # (service, user annotation value id)
TAG_BKEY = 3  # (service, binary key id)
TAG_BVAL = 4  # (service, binary key id, binary value id)

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)

_COLS: Tuple[str, ...] = (
    SpanBatch.SPAN_COLUMNS + SpanBatch.ANN_COLUMNS
    + SpanBatch.BANN_COLUMNS
)


def zone_key(tag: int, svc: int, a: int, b: int = 0) -> np.ndarray:
    """Tagged key tuple → well-dispersed int64 (np_mix_keys64 so any
    future device-side probe of the same tuple hashes identically)."""
    return np_mix_keys64([
        np.asarray([tag], np.int64), np.asarray([svc], np.int64),
        np.asarray([a], np.int64), np.asarray([b], np.int64),
    ]).view(np.int64)


@dataclass(frozen=True)
class ZoneMap:
    # ts_first_min is informational time-range metadata (segment
    # inspection, and the lower bound a future start_ts-windowed query
    # would prune on); today's SpanStore surface filters only on
    # end_ts, so the active time probe is may_match_end_ts below.
    ts_first_min: int
    ts_last_min: int
    ts_last_max: int
    service_ids: frozenset
    key_cms: np.ndarray  # [depth, width] int32
    trace_bloom: np.ndarray  # [bits/8] uint8
    hll: np.ndarray  # [2^p] int32
    dur_hist: Dict[int, np.ndarray]  # svc_id -> [B] int64
    hist_gamma: float
    hist_buckets: int

    def merge(self, other: "ZoneMap") -> "ZoneMap":
        """Monoidal merge — the compactor's whole zone-map cost."""
        assert self.key_cms.shape == other.key_cms.shape
        assert self.trace_bloom.shape == other.trace_bloom.shape
        assert self.hll.shape == other.hll.shape
        assert (self.hist_gamma == other.hist_gamma
                and self.hist_buckets == other.hist_buckets)
        hist = {k: v.copy() for k, v in self.dur_hist.items()}
        for k, v in other.dur_hist.items():
            if k in hist:
                hist[k] = hist[k] + v
            else:
                hist[k] = v.copy()
        return ZoneMap(
            ts_first_min=min(self.ts_first_min, other.ts_first_min),
            ts_last_min=min(self.ts_last_min, other.ts_last_min),
            ts_last_max=max(self.ts_last_max, other.ts_last_max),
            service_ids=self.service_ids | other.service_ids,
            key_cms=SK.cms_merge(self.key_cms, other.key_cms),
            trace_bloom=SK.bloom_merge(self.trace_bloom,
                                       other.trace_bloom),
            hll=SK.hll_merge(self.hll, other.hll),
            dur_hist=hist,
            hist_gamma=self.hist_gamma,
            hist_buckets=self.hist_buckets,
        )

    # -- pruning probes (False == provably no match) --------------------

    def may_contain_trace(self, tid: int) -> bool:
        return SK.bloom_contains(self.trace_bloom, tid)

    def may_contain_key(self, tag: int, svc: int, a: int,
                        b: int = 0) -> bool:
        return SK.cms_query(self.key_cms, int(zone_key(tag, svc, a,
                                                       b)[0])) > 0

    def may_match_end_ts(self, end_ts: int) -> bool:
        """Index queries require span.last_ts <= end_ts; if even the
        SMALLEST valid last timestamp exceeds it, nothing matches."""
        return self.ts_last_min <= end_ts


@dataclass(frozen=True)
class Segment:
    seg_id: int
    gid_lo: int
    gid_hi: int  # capture range [gid_lo, gid_hi) this segment covers
    n_spans: int
    n_anns: int
    n_banns: int
    zone: ZoneMap
    cols: Dict[str, bytes]  # column name -> deflate blob (incl "gids")
    col_meta: Dict[str, Tuple[str, int]]  # name -> (dtype str, length)
    dict_sizes: Tuple[int, ...]  # dictionary high-water marks at seal
    raw_bytes: int
    comp_bytes: int

    def column(self, name: str) -> np.ndarray:
        """Decompress ONE column plane — membership probes and other
        single-column reads pay one zlib stream, not a row decode."""
        dtype, n = self.col_meta[name]
        return np.frombuffer(
            zlib.decompress(self.cols[name]), np.dtype(dtype)
        )[:n].copy()

    def decode(self) -> Tuple[SpanBatch, np.ndarray]:
        """(SpanBatch, gids) — the full row-decompression path."""
        batch = SpanBatch(**{c: self.column(c) for c in _COLS})
        return batch, self.column("gids")

    # -- durable form ---------------------------------------------------

    def to_bytes(self) -> bytes:
        header = {
            "seg_id": self.seg_id, "gid_lo": self.gid_lo,
            "gid_hi": self.gid_hi, "n_spans": self.n_spans,
            "n_anns": self.n_anns, "n_banns": self.n_banns,
            "dict_sizes": list(self.dict_sizes),
            "raw_bytes": self.raw_bytes, "comp_bytes": self.comp_bytes,
            "zone": {
                "ts_first_min": self.zone.ts_first_min,
                "ts_last_min": self.zone.ts_last_min,
                "ts_last_max": self.zone.ts_last_max,
                "service_ids": sorted(self.zone.service_ids),
                "hist_gamma": self.zone.hist_gamma,
                "hist_buckets": self.zone.hist_buckets,
                "cms_shape": list(self.zone.key_cms.shape),
                "hll_size": int(self.zone.hll.size),
                "bloom_bytes": int(self.zone.trace_bloom.size),
                "hist_svcs": sorted(self.zone.dur_hist),
            },
            "col_meta": {k: [v[0], v[1]]
                         for k, v in self.col_meta.items()},
            "col_order": sorted(self.cols),
        }
        hdr = json.dumps(header).encode("utf-8")
        parts = [_MAGIC, struct.pack(">I", len(hdr)), hdr]
        # Zone arrays ride as deflate blobs after the header, in a
        # fixed order, each length-prefixed.
        zone_blobs = [
            zlib.compress(np.ascontiguousarray(a).tobytes(),
                          _DEFLATE_LEVEL)
            for a in (
                self.zone.key_cms, self.zone.trace_bloom, self.zone.hll,
                *[self.zone.dur_hist[s]
                  for s in sorted(self.zone.dur_hist)],
            )
        ]
        for blob in zone_blobs:
            parts.append(struct.pack(">I", len(blob)))
            parts.append(blob)
        for name in header["col_order"]:
            blob = self.cols[name]
            parts.append(struct.pack(">I", len(blob)))
            parts.append(blob)
        return b"".join(parts)

    @staticmethod
    def from_bytes(data: bytes) -> "Segment":
        if data[:5] != _MAGIC:
            raise ValueError("not a segment blob")
        (hlen,) = struct.unpack(">I", data[5:9])
        header = json.loads(data[9:9 + hlen].decode("utf-8"))
        off = 9 + hlen

        def blob():
            nonlocal off
            (n,) = struct.unpack(">I", data[off:off + 4])
            off += 4
            b = data[off:off + n]
            off += n
            return b

        z = header["zone"]
        depth, width = z["cms_shape"]
        cms = np.frombuffer(zlib.decompress(blob()),
                            np.int32).reshape(depth, width).copy()
        bloom = np.frombuffer(zlib.decompress(blob()), np.uint8).copy()
        hll = np.frombuffer(zlib.decompress(blob()), np.int32).copy()
        hist = {}
        for svc in z["hist_svcs"]:
            hist[int(svc)] = np.frombuffer(
                zlib.decompress(blob()), np.int64).copy()
        cols = {name: blob() for name in header["col_order"]}
        zone = ZoneMap(
            ts_first_min=z["ts_first_min"],
            ts_last_min=z["ts_last_min"], ts_last_max=z["ts_last_max"],
            service_ids=frozenset(z["service_ids"]),
            key_cms=cms, trace_bloom=bloom, hll=hll, dur_hist=hist,
            hist_gamma=z["hist_gamma"], hist_buckets=z["hist_buckets"],
        )
        return Segment(
            seg_id=header["seg_id"], gid_lo=header["gid_lo"],
            gid_hi=header["gid_hi"], n_spans=header["n_spans"],
            n_anns=header["n_anns"], n_banns=header["n_banns"],
            zone=zone, cols=cols,
            col_meta={k: (v[0], v[1])
                      for k, v in header["col_meta"].items()},
            dict_sizes=tuple(header["dict_sizes"]),
            raw_bytes=header["raw_bytes"],
            comp_bytes=header["comp_bytes"],
        )


def _zone_from_rows(batch: SpanBatch, gids: np.ndarray, spans, dicts,
                    params) -> ZoneMap:
    """Build a zone map from one capture window.

    Column-plane parts (bloom / HLL / ts range / per-service duration
    histograms) come straight from the columns; the key CMS needs each
    span's full service set crossed with its names/annotations (the
    memory-oracle match rule: a span matches under ANY of its
    annotation-host services), which is exact only from the decoded
    spans — the caller decodes once and shares the spans with the
    query cache.
    """
    cms = SK.cms_init(params.cms_depth, params.cms_width)
    bloom = SK.bloom_init(params.bloom_bits)
    hll = SK.hll_init(params.hll_p)
    SK.bloom_add(bloom, batch.trace_id)
    SK.hll_add(hll, batch.trace_id)
    tsf = batch.ts_first[batch.ts_first >= 0]
    tsl = batch.ts_last[batch.ts_last >= 0]
    hist: Dict[int, np.ndarray] = {}
    dur_ok = (batch.service_id >= 0) & (batch.duration >= 0)
    for svc in np.unique(batch.service_id[dur_ok]):
        row = np.zeros(params.hist_buckets, np.int64)
        SK.hist_add(row, batch.duration[dur_ok
                                        & (batch.service_id == svc)],
                    params.hist_gamma)
        hist[int(svc)] = row
    svc_ids = set(int(s) for s in np.unique(batch.service_id)
                  if s >= 0)
    # The key tuples are collected per span and hashed in one vectorized
    # np_mix_keys64 call (zone_key over all of them at once): the same
    # keys as one zone_key call per tuple, so the CMS is bitwise the
    # reference's, at a fraction of the host cost of a full-width seal.
    tuples: List[Tuple[int, int, int, int]] = []
    add = tuples.append
    for span in spans:
        svcs = [dicts.services.get(n) for n in span.service_names]
        svcs = [s for s in svcs if s is not None]
        svc_ids.update(svcs)
        if not svcs:
            continue
        name_lc = (dicts.span_names.get(span.name.lower())
                   if span.name else None)
        ann_vals = {dicts.annotations.get(a.value)
                    for a in span.annotations
                    if a.value not in CORE_ANNOTATIONS}
        bkeys = {}
        for b in span.binary_annotations:
            kid = dicts.binary_keys.get(b.key)
            if kid is None:
                continue
            vid = dicts.binary_values.get(
                _norm_value(b.value, b.annotation_type))
            bkeys.setdefault(kid, set()).add(vid)
        for svc in svcs:
            if name_lc is not None:
                add((TAG_NAME, svc, name_lc, 0))
            for av in ann_vals:
                if av is not None:
                    add((TAG_ANN, svc, av, 0))
            for kid, vids in bkeys.items():
                add((TAG_BKEY, svc, kid, 0))
                for vid in vids:
                    if vid is not None:
                        add((TAG_BVAL, svc, kid, vid))
    if tuples:
        cols = np.asarray(tuples, np.int64).T
        SK.cms_add(cms, np_mix_keys64(list(cols)).view(np.int64))
    return ZoneMap(
        ts_first_min=int(tsf.min()) if tsf.size else _I64_MAX,
        ts_last_min=int(tsl.min()) if tsl.size else _I64_MAX,
        ts_last_max=int(tsl.max()) if tsl.size else _I64_MIN,
        service_ids=frozenset(svc_ids),
        key_cms=cms, trace_bloom=bloom, hll=hll, dur_hist=hist,
        hist_gamma=params.hist_gamma, hist_buckets=params.hist_buckets,
    )


def _compress_cols(batch: SpanBatch, gids: np.ndarray):
    cols: Dict[str, bytes] = {}
    meta: Dict[str, Tuple[str, int]] = {}
    raw = comp = 0
    for name in _COLS + ("gids",):
        arr = gids if name == "gids" else getattr(batch, name)
        arr = np.ascontiguousarray(arr)
        blob = zlib.compress(arr.tobytes(), _DEFLATE_LEVEL)
        cols[name] = blob
        meta[name] = (arr.dtype.str, int(arr.shape[0]))
        raw += arr.nbytes
        comp += len(blob)
    return cols, meta, raw, comp


def seal_segment(seg_id: int, batch: SpanBatch, gids: np.ndarray,
                 spans, dicts, params, gid_lo: int,
                 gid_hi: int) -> Segment:
    """Freeze one capture window into an immutable segment."""
    cols, meta, raw, comp = _compress_cols(batch, gids)
    zone = _zone_from_rows(batch, gids, spans, dicts, params)
    return Segment(
        seg_id=seg_id, gid_lo=gid_lo, gid_hi=gid_hi,
        n_spans=batch.n_spans, n_anns=batch.n_annotations,
        n_banns=batch.n_binary, zone=zone, cols=cols, col_meta=meta,
        dict_sizes=(len(dicts.services), len(dicts.span_names),
                    len(dicts.annotations), len(dicts.binary_keys),
                    len(dicts.binary_values), len(dicts.endpoints)),
        raw_bytes=raw, comp_bytes=comp,
    )


def merge_segments(seg_id: int, segs: Sequence[Segment]) -> Segment:
    """Compaction merge: concat rows (span_idx refs rebased by
    SpanBatch.concat), merge zone maps MONOIDALLY — no re-scan of span
    objects, the whole point of mergeable sketch headers."""
    assert len(segs) >= 2
    segs = sorted(segs, key=lambda s: s.gid_lo)
    batch, gids = segs[0].decode()
    zone = segs[0].zone
    for s in segs[1:]:
        b2, g2 = s.decode()
        batch = batch.concat(b2)
        gids = np.concatenate([gids, g2])
        zone = zone.merge(s.zone)
    cols, meta, raw, comp = _compress_cols(batch, gids)
    return Segment(
        seg_id=seg_id, gid_lo=segs[0].gid_lo, gid_hi=segs[-1].gid_hi,
        n_spans=batch.n_spans, n_anns=batch.n_annotations,
        n_banns=batch.n_binary, zone=zone, cols=cols, col_meta=meta,
        dict_sizes=tuple(max(t) for t in zip(*[s.dict_sizes
                                               for s in segs])),
        raw_bytes=raw, comp_bytes=comp,
    )
