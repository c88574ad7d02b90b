"""ctypes bindings for the native span parser (csrc/span_codec.cc).

The port's copy of ``zipkin_tpu/native.py``. The C++ parser turns a raw
thrift Span sequence into columnar numpy arrays in one pass — the
native fast path for the collector's hot decode (reference role:
scrooge's binary deserializer on ScribeSpanReceiver.scala:96-107).
String fields come back as (offset, length) slices into the input
buffer; the host interns them through the shared DictionarySet so
device ids stay consistent.

The library is built with g++ at first use from the package's own
source into ``build/zipkin_tpu_torch/`` (``build/`` is listed in
``.gitignore``), under a lock and through an atomic rename, so queue
workers and concurrent processes never load a half-written object.
Callers must handle ``NativeUnavailable`` and fall back to the pure
python codec (``zipkin_tpu_torch.wire.thrift``) — see
``parse_spans_columnar``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

from zipkin_tpu_torch.columnar.dictionary import DictionarySet
from zipkin_tpu_torch.columnar.schema import (
    FLAG_DEBUG,
    FLAG_HAS_PARENT,
    NO_ENDPOINT,
    NO_SERVICE,
    NO_TS,
    SpanBatch,
)
from zipkin_tpu_torch.models.constants import (
    CLIENT_RECV,
    CLIENT_SEND,
    SERVER_RECV,
    SERVER_SEND,
)
from zipkin_tpu_torch.models.span import AnnotationType
from zipkin_tpu_torch.wire.thrift import _decode_binary_value

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "span_codec.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "zipkin_tpu_torch")
_SO = os.path.join(BUILD_DIR, "libzipkin_span_codec.so")

_lock = threading.Lock()  # lock-order: 86 native-build
_lib = None
# The path the loaded library came from (None until the first load).
loaded_from = None


class NativeUnavailable(RuntimeError):
    pass


class _SpanColumns(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "trace_id", "span_id", "parent_id", "has_parent", "debug",
        "name_off", "name_len",
        "ann_span_idx", "ann_ts", "ann_value_off", "ann_value_len",
        "ann_ipv4", "ann_port", "ann_svc_off", "ann_svc_len",
        "bann_span_idx", "bann_key_off", "bann_key_len",
        "bann_value_off", "bann_value_len", "bann_type",
        "bann_ipv4", "bann_port", "bann_svc_off", "bann_svc_len",
    )]


def _build(force: bool = False) -> str:
    if not force and os.path.exists(_SO) and (
        os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
    ):
        return _SO
    tmp = f"{_SO}.tmp{os.getpid()}"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-Wall", "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailable(f"could not build native codec: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _SO


def _load() -> ctypes.CDLL:
    """Build (if stale) and dlopen, rebuilding once on a load failure —
    a stale or wrong-arch .so from a previous checkout must fall through
    to a fresh build, and a still-failing load must surface as
    NativeUnavailable so callers engage the pure-python fallback."""
    path = _build()
    try:
        return ctypes.CDLL(path)
    except OSError:
        path = _build(force=True)
        try:
            return ctypes.CDLL(path)
        except OSError as e:
            raise NativeUnavailable(
                f"could not load native codec: {e}"
            ) from e


def get_lib():
    global _lib, loaded_from
    with _lock:
        if _lib is None:
            lib = _load()
            lib.zk_parse_spans.restype = ctypes.c_int
            lib.zk_parse_spans.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(_SpanColumns),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.zk_base64_decode.restype = ctypes.c_int64
            lib.zk_base64_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ]
            lib.zk_group_strings.restype = ctypes.c_int32
            lib.zk_group_strings.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            _lib = lib
            loaded_from = lib._name
    return _lib


def _group_strings(lib, payload: bytes, offs: np.ndarray, lens: np.ndarray):
    """Content-dedup of (off, len) slices via the C++ hash table.

    Returns (group_of [n] int32 with -1 for len<0 rows, reps: list of
    the unique byte strings in group order)."""
    n = len(offs)
    if n == 0:
        return np.zeros(0, np.int32), []
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    group_of = np.empty(n, np.int32)
    rep_off = np.empty(n, np.int64)
    rep_len = np.empty(n, np.int32)
    ng = lib.zk_group_strings(
        payload,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        group_of.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rep_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rep_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
    )
    reps = [
        payload[int(rep_off[g]):int(rep_off[g]) + int(rep_len[g])]
        for g in range(ng)
    ]
    return group_of, reps


def available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


def base64_decode(data: bytes) -> bytes:
    lib = get_lib()
    out = ctypes.create_string_buffer((len(data) * 3) // 4 + 4)
    n = lib.zk_base64_decode(data, len(data), out)
    if n < 0:
        raise ValueError("bad base64 payload")
    return out.raw[:n]


_CORE_TS = {CLIENT_SEND: "ts_cs", CLIENT_RECV: "ts_cr",
            SERVER_RECV: "ts_sr", SERVER_SEND: "ts_ss"}


def indexable_from_batch(batch: SpanBatch, dicts: DictionarySet) -> np.ndarray:
    """Columnar should_index (store/base.py:51): exclude spans that are
    client-side and carry the literal service name "client"."""
    ns = batch.n_spans
    out = np.ones(ns, bool)
    client_svc = dicts.services.get("client")
    if client_svc is None or ns == 0:
        return out
    cs_id, cr_id = 0, 1  # CORE_ANNOTATION_IDS cs/cr
    is_core_client = np.isin(batch.ann_value_id, (cs_id, cr_id))
    has_client_side = np.zeros(ns, bool)
    np.logical_or.at(has_client_side, batch.ann_span_idx[is_core_client], True)
    svc_is_client = batch.ann_service_id == client_svc
    has_client_svc = np.zeros(ns, bool)
    np.logical_or.at(has_client_svc, batch.ann_span_idx[svc_is_client], True)
    out &= ~(has_client_side & has_client_svc)
    return out


class ParseCapacityError(ValueError):
    """Valid payload larger than the parse buffers — chunk and retry
    (distinct from malformed input so callers don't drop good data)."""


def parse_spans_columnar(
    payload: bytes, dicts: DictionarySet,
    max_spans: int = 1 << 16,
) -> Tuple[SpanBatch, np.ndarray]:
    """Thrift Span sequence → (SpanBatch, name_lc_id column).

    The numeric work happens in C++; this wrapper interns strings and
    assembles the SpanBatch. Raises NativeUnavailable when the shared
    object can't be built; ValueError on malformed input;
    ParseCapacityError when the payload exceeds the parse buffers.
    """
    batch, name_lc, _, _ = parse_spans_columnar_sampled(
        payload, dicts, 0, max_spans
    )
    return batch, name_lc


def parse_spans_columnar_sampled(
    payload: bytes, dicts: DictionarySet,
    sample_threshold: int, max_spans: int = 1 << 16,
) -> Tuple[SpanBatch, np.ndarray, int, int]:
    """parse_spans_columnar with the sampler's trace-id threshold test
    applied on the numeric columns BEFORE any string interning, so
    sampled-out traffic never pollutes the dictionaries (or pays intern
    cost). Debug-flagged spans always pass (SpanSamplerFilter.scala:40).

    Returns (batch, name_lc, n_dropped, n_kept_debug) where
    n_kept_debug counts kept spans carrying the debug flag (the slow
    path never runs those through the sampler's counters).
    """
    lib = get_lib()
    max_anns = max_spans * 8
    max_banns = max_spans * 8

    cols = {}

    def arr(name, n, dtype):
        a = np.zeros(n, dtype)
        cols[name] = a
        return a.ctypes.data_as(ctypes.c_void_p)

    sc = _SpanColumns(
        trace_id=arr("trace_id", max_spans, np.int64),
        span_id=arr("span_id", max_spans, np.int64),
        parent_id=arr("parent_id", max_spans, np.int64),
        has_parent=arr("has_parent", max_spans, np.uint8),
        debug=arr("debug", max_spans, np.uint8),
        name_off=arr("name_off", max_spans, np.int64),
        name_len=arr("name_len", max_spans, np.int32),
        ann_span_idx=arr("ann_span_idx", max_anns, np.int32),
        ann_ts=arr("ann_ts", max_anns, np.int64),
        ann_value_off=arr("ann_value_off", max_anns, np.int64),
        ann_value_len=arr("ann_value_len", max_anns, np.int32),
        ann_ipv4=arr("ann_ipv4", max_anns, np.int32),
        ann_port=arr("ann_port", max_anns, np.int32),
        ann_svc_off=arr("ann_svc_off", max_anns, np.int64),
        ann_svc_len=arr("ann_svc_len", max_anns, np.int32),
        bann_span_idx=arr("bann_span_idx", max_banns, np.int32),
        bann_key_off=arr("bann_key_off", max_banns, np.int64),
        bann_key_len=arr("bann_key_len", max_banns, np.int32),
        bann_value_off=arr("bann_value_off", max_banns, np.int64),
        bann_value_len=arr("bann_value_len", max_banns, np.int32),
        bann_type=arr("bann_type", max_banns, np.int32),
        bann_ipv4=arr("bann_ipv4", max_banns, np.int32),
        bann_port=arr("bann_port", max_banns, np.int32),
        bann_svc_off=arr("bann_svc_off", max_banns, np.int64),
        bann_svc_len=arr("bann_svc_len", max_banns, np.int32),
    )
    n_spans = ctypes.c_int32(0)
    n_anns = ctypes.c_int32(0)
    n_banns = ctypes.c_int32(0)
    rc = lib.zk_parse_spans(
        payload, len(payload), ctypes.byref(sc),
        max_spans, max_anns, max_banns,
        ctypes.byref(n_spans), ctypes.byref(n_anns), ctypes.byref(n_banns),
    )
    if rc == -1:
        raise ValueError("malformed thrift span payload")
    if rc in (-2, -3, -4):
        raise ParseCapacityError(
            "payload exceeds parse capacity; chunk the input"
        )
    ns, na, nb = n_spans.value, n_anns.value, n_banns.value

    # Sampler threshold test on the numeric columns, pre-intern.
    debug_col = cols["debug"][:ns] != 0
    if sample_threshold > 0 and ns:
        tids = cols["trace_id"][:ns]
        t = np.where(tids == np.int64(-(2**63)), np.int64(2**63 - 1),
                     np.abs(tids))
        keep = debug_col | (t > np.int64(sample_threshold))
    else:
        keep = np.ones(ns, bool)
    kept_idx = np.flatnonzero(keep)
    dropped = int(ns - kept_idx.size)
    kept_debug = int(np.count_nonzero(debug_col & keep))
    new_of_old = np.cumsum(keep) - 1  # old span index → new
    ka = (keep[cols["ann_span_idx"][:na]] if na
          else np.zeros(0, bool))
    kb = (keep[cols["bann_span_idx"][:nb]] if nb
          else np.zeros(0, bool))
    kns = kept_idx.size

    b = SpanBatch.empty(kns, int(np.count_nonzero(ka)),
                        int(np.count_nonzero(kb)))
    b.trace_id[:] = cols["trace_id"][:ns][keep]
    b.span_id[:] = cols["span_id"][:ns][keep]
    b.parent_id[:] = cols["parent_id"][:ns][keep]
    b.flags[:] = (
        cols["has_parent"][:ns][keep] * np.uint8(FLAG_HAS_PARENT)
        + cols["debug"][:ns][keep] * np.uint8(FLAG_DEBUG)
    )

    # From here on, work is per UNIQUE string (C++ content-dedup +
    # vectorized id lookup), not per row — annotation-heavy traffic
    # repeats the same few names/values millions of times, and the
    # per-row intern loop this replaces dominated the decode profile.
    I64_MAX = np.int64(2**63 - 1)
    I64_MIN = np.int64(-(2**63) + 1)

    # Span names: unique → intern once (original + lowercase).
    n_g, n_reps = _group_strings(
        lib, payload, cols["name_off"][:ns][keep],
        cols["name_len"][:ns][keep],
    )
    name_strs = [r.decode("utf-8", "replace") for r in n_reps]
    name_ids = np.array(
        [dicts.span_names.encode(s) for s in name_strs], np.int32
    ).reshape(-1)
    name_lc_ids_u = np.array(
        [-1 if s == "" else dicts.span_names.encode(s.lower())
         for s in name_strs], np.int32,
    ).reshape(-1)
    if kns:
        b.name_id[:] = name_ids[n_g]
        name_lc = name_lc_ids_u[n_g].copy()
    else:
        name_lc = np.empty(0, np.int32)

    def svc_and_endpoints(sel, off_col, len_col, ipv4_col, port_col, nrows):
        """Per-row (service_id, endpoint_id) columns for one annotation
        table. len == -2 means endpoint present but service_name absent
        (decodes as "unknown", wire/thrift.py _r_endpoint); len == -1
        means no endpoint."""
        offs = off_col[sel]
        lens = len_col[sel]
        s_g, s_reps = _group_strings(lib, payload, offs, lens)
        s_strs = [r.decode("utf-8", "replace") for r in s_reps]
        s_ids = np.array(
            [dicts.services.encode(s.lower()) for s in s_strs], np.int64
        ).reshape(-1)
        svc_col = np.full(nrows, NO_SERVICE, np.int64)
        named = s_g >= 0
        if named.any():
            svc_col[named] = s_ids[s_g[named]]
        unknown = lens == -2
        if unknown.any():
            svc_col[unknown] = dicts.services.encode("unknown")
        # Endpoint ids: unique (ipv4, port, service token) triples.
        ep_col = np.full(nrows, NO_ENDPOINT, np.int64)
        token = s_g.astype(np.int64)
        token[unknown] = -2
        present = (lens >= 0) | unknown

        def signed32(v: int) -> int:
            # Endpoint tuples key the dictionary with the SIGNED ipv4
            # (thrift i32), matching the python codec bit-for-bit.
            return v - (1 << 32) if v >= (1 << 31) else v

        def signed16(v: int) -> int:
            return v - (1 << 16) if v >= (1 << 15) else v

        if present.any():
            # One packed int64 key per row — np.unique(axis=0) sorts
            # void-dtype rows and dominates the profile; the 1-D unique
            # is an order of magnitude cheaper. token+2 >= 0 (< 2^15
            # unique services per payload by construction: group count
            # <= rows, and packed overflow falls back to the row path).
            tok = token[present] + 2
            ipv4 = ipv4_col[sel][present].astype(np.int64) & 0xFFFFFFFF
            port = port_col[sel][present].astype(np.int64) & 0xFFFF
            if int(tok.max(initial=0)) < (1 << 15):
                packed = (tok << 48) | (ipv4 << 16) | port
                uniq, inv = np.unique(packed, return_inverse=True)
                ep_ids = np.array([
                    dicts.endpoints.encode((
                        signed32(int((u >> 16) & 0xFFFFFFFF)),
                        signed16(int(u & 0xFFFF)),
                        "unknown" if (u >> 48) == 0
                        else s_strs[int(u >> 48) - 2],
                    ))
                    for u in uniq
                ], np.int64).reshape(-1)
            else:
                key = np.stack([ipv4, port, tok], axis=1)
                uniq, inv = np.unique(key, axis=0, return_inverse=True)
                ep_ids = np.array([
                    dicts.endpoints.encode((
                        signed32(int(u[0])), signed16(int(u[1])),
                        "unknown" if u[2] == 0 else s_strs[int(u[2]) - 2],
                    ))
                    for u in uniq
                ], np.int64).reshape(-1)
            ep_col[present] = ep_ids[inv]
        return svc_col, ep_col, present

    # Annotations.
    a_span = new_of_old[cols["ann_span_idx"][:na]][ka].astype(np.int32)
    a_ts = cols["ann_ts"][:na][ka]
    kna = a_span.size
    v_g, v_reps = _group_strings(
        lib, payload, cols["ann_value_off"][:na][ka],
        cols["ann_value_len"][:na][ka],
    )
    v_strs = [r.decode("utf-8", "replace") for r in v_reps]
    v_ids = np.array(
        [dicts.annotations.encode(s) for s in v_strs], np.int32
    ).reshape(-1)
    group_of_value = {s: g for g, s in enumerate(v_strs)}
    if kna:
        b.ann_span_idx[:] = a_span
        b.ann_ts[:] = a_ts
        b.ann_value_id[:] = v_ids[v_g]
        svc_col, ep_col, ep_present = svc_and_endpoints(
            ka, cols["ann_svc_off"][:na], cols["ann_svc_len"][:na],
            cols["ann_ipv4"][:na], cols["ann_port"][:na], kna,
        )
        b.ann_service_id[:] = svc_col.astype(np.int32)
        b.ann_endpoint_id[:] = ep_col.astype(np.int32)

        # Core-ts columns: duplicate indices in fancy assignment keep
        # the LAST occurrence — same as the sequential loop's overwrite.
        for value_str, core_col in _CORE_TS.items():
            g = group_of_value.get(value_str)
            if g is not None:
                m = v_g == g
                getattr(b, core_col)[a_span[m]] = a_ts[m]
        firsts = np.full(kns, I64_MAX, np.int64)
        lasts = np.full(kns, I64_MIN, np.int64)
        np.minimum.at(firsts, a_span, a_ts)
        np.maximum.at(lasts, a_span, a_ts)
        touched = firsts != I64_MAX
        b.ts_first[touched] = firsts[touched]
        b.ts_last[touched] = lasts[touched]

        # Owning service (server-preferred, first occurrence wins —
        # assign in reverse so the first write lands last).
        def first_wins(kind_groups):
            out = np.full(kns, NO_SERVICE, np.int64)
            m = np.isin(v_g, kind_groups) & ep_present
            out[a_span[m][::-1]] = svc_col[m][::-1]
            return out

        server_svc = first_wins([
            g for s, g in group_of_value.items()
            if s in (SERVER_RECV, SERVER_SEND)
        ])
        client_svc = first_wins([
            g for s, g in group_of_value.items()
            if s in (CLIENT_SEND, CLIENT_RECV)
        ])
    else:
        server_svc = np.full(kns, NO_SERVICE, np.int64)
        client_svc = np.full(kns, NO_SERVICE, np.int64)

    has_ts = b.ts_first != NO_TS
    b.duration[has_ts] = b.ts_last[has_ts] - b.ts_first[has_ts]
    b.service_id[:] = np.where(
        server_svc >= 0, server_svc,
        np.where(client_svc >= 0, client_svc, NO_SERVICE),
    ).astype(np.int32)

    # Binary annotations.
    knb = int(np.count_nonzero(kb))
    if knb:
        b.bann_span_idx[:] = (
            new_of_old[cols["bann_span_idx"][:nb]][kb].astype(np.int32)
        )
        k_g, k_reps = _group_strings(
            lib, payload, cols["bann_key_off"][:nb][kb],
            cols["bann_key_len"][:nb][kb],
        )
        k_ids = np.array(
            [dicts.binary_keys.encode(r.decode("utf-8", "replace"))
             for r in k_reps], np.int32,
        ).reshape(-1)
        b.bann_key_id[:] = k_ids[k_g]
        btype = cols["bann_type"][:nb][kb]
        btype = np.where((btype >= 0) & (btype <= 6), btype, 1)
        b.bann_type[:] = btype.astype(np.uint8)
        # Values decode per unique (bytes, type) pair.
        bv_g, bv_reps = _group_strings(
            lib, payload, cols["bann_value_off"][:nb][kb],
            cols["bann_value_len"][:nb][kb],
        )
        packed = bv_g.astype(np.int64) * 8 + btype.astype(np.int64)
        uniq, inv = np.unique(packed, return_inverse=True)
        pair_ids = np.empty(len(uniq), np.int64)
        for u_i, u in enumerate(uniq):
            value = _decode_binary_value(
                bv_reps[int(u) // 8], AnnotationType(int(u) % 8)
            )
            if isinstance(value, bytearray):
                value = bytes(value)
            pair_ids[u_i] = dicts.binary_values.encode(value)
        b.bann_value_id[:] = pair_ids[inv]
        svc_col, ep_col, _ = svc_and_endpoints(
            kb, cols["bann_svc_off"][:nb], cols["bann_svc_len"][:nb],
            cols["bann_ipv4"][:nb], cols["bann_port"][:nb], knb,
        )
        b.bann_service_id[:] = svc_col.astype(np.int32)
        b.bann_endpoint_id[:] = ep_col.astype(np.int32)
    return b, name_lc, dropped, kept_debug
