"""The bytes each hand-written kernel needs for one ingest step of the
stream, counted from the step's own inputs (the template and the step's
salt and time shift) with the reference's hashing and bucket functions.

K2's rows follow the fused step's index families, in the store's order:
candidate rows by annotation host, by host and span name, by host and
annotation value (each span's lowest and, when different, highest
host), by host and binary key (with and without its value), then the
trace-membership rows of spans, annotations and binary annotations.
A family's rows land in its own buckets; a bucket keeps the last
``depth`` of its rows, so its survivors are min(rows, depth)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import gen
from .reference import bucket_index, cms_cells

_PI = 0x243F6A8885A308D3
_K = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)
_BIG = 1 << 30


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _distinct(a: np.ndarray) -> int:
    return int(np.unique(a).size)


def mix_keys(keys) -> np.ndarray:
    """A splitmix64-style fold of int64 key columns (uint64), the hash
    that picks an index row's bucket."""
    arrs = [np.asarray(k, np.int64).astype(np.uint64) for k in keys]
    acc = np.full(arrs[0].shape, _PI, np.uint64)
    with np.errstate(over="ignore"):
        for a in arrs:
            acc = (acc ^ a) * np.uint64(_K[0])
            acc ^= acc >> np.uint64(29)
        acc *= np.uint64(_K[1])
        acc ^= acc >> np.uint64(32)
        acc *= np.uint64(_K[2])
        acc ^= acc >> np.uint64(29)
    return acc


def _s64(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


def _srl(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) & ((1 << (64 - n)) - 1)


def mix_key_torch(x: torch.Tensor) -> torch.Tensor:
    """``mix_keys([x])`` on int64 tensors (the bits as int64)."""
    acc = (x ^ _s64(_PI)) * _s64(_K[0])
    acc = acc ^ _srl(acc, 29)
    acc = acc * _s64(_K[1])
    acc = acc ^ _srl(acc, 32)
    acc = acc * _s64(_K[2])
    return acc ^ _srl(acc, 29)


def _survivors(buckets: np.ndarray, n_b: int, depth: int) -> Tuple[int, int]:
    """(buckets touched, rows kept) of one family's valid rows."""
    cnt = np.bincount(buckets, minlength=n_b)
    return int(np.count_nonzero(cnt)), int(np.minimum(cnt, depth).sum())


class StepBytes:
    """Per-step byte counts of K1 and K2 for a configuration's store
    section ``st``, the run's ``templates`` and the store's index
    ``families``: (buckets, depth) of each of the seven, in order."""

    def __init__(self, st: Dict, templates, seed: int,
                 families: List[Tuple[int, int]] = (), device="cpu"):
        self.st, self.templates, self.seed = st, templates, seed
        self.families = [tuple(int(x) for x in f) for f in families]
        self.device = torch.device(device)
        self._fixed: Dict[int, tuple] = {}
        self._cand: Dict[int, tuple] = {}
        self._rows: Dict[int, list] = {}

    def _template_parts(self, t: int):
        if t in self._fixed:
            return self._fixed[t]
        st, tm = self.st, self.templates[t]
        col = tm.cols
        S, B = st["max_services"], st["quantile_buckets"]
        N, A, K = (st["max_span_names"], st["max_annotation_values"],
                   st["max_binary_keys"])
        P, PA, PB = _pow2(tm.n_spans), _pow2(tm.n_anns), _pow2(tm.n_banns)
        svc = col["service_id"].astype(np.int64)
        ok = (svc >= 0) & (svc < S)
        bidx = bucket_index(col["duration"], B, st.get("quantile_alpha", 0.01))
        a_svc = col["ann_service_id"].astype(np.int64)
        a_ok = (a_svc >= 0) & (a_svc < S)
        a_name = col["name_id"][col["ann_span_idx"]].astype(np.int64)
        av = col["ann_value_id"].astype(np.int64)
        b_svc = col["bann_service_id"].astype(np.int64)
        bk = col["bann_key_id"].astype(np.int64)
        touched = (
            _distinct(svc[ok & (col["duration"] >= 0)] * B
                      + bidx[ok & (col["duration"] >= 0)])
            + _distinct(svc[ok]) + _distinct(a_svc[a_ok])
            + _distinct((a_svc * N + a_name)[a_ok & (a_name < N)])
            + _distinct((a_svc * A + av)[a_ok & (av >= gen.FIRST_USER_ANNOTATION_ID)
                                         & (av < A)])
            + _distinct((b_svc * K + bk)[(b_svc >= 0) & (b_svc < S)
                                         & (bk >= 0) & (bk < K)]))
        depth = st.get("cms_depth", 4)
        rows = P + P + 3 * PA + PB + depth * P
        k2_rows = P + 5 * PA + 5 * PB
        self._fixed[t] = (rows, touched, k2_rows, P,
                          torch.from_numpy(col["trace_id"]).to(self.device),
                          torch.from_numpy(col["service_id"].astype(np.int64)
                                           ).to(self.device),
                          torch.from_numpy(col["ts_first"]).to(self.device))
        return self._fixed[t]

    def k1(self, t: int, k: int):
        """(rows, touched cells) of step ``k`` (template ``t``)."""
        st = self.st
        rows, touched, _, P, tid, svc, tsf = self._template_parts(t)
        depth, width = st.get("cms_depth", 4), st["cms_width"]
        cells = cms_cells(tid ^ gen.step_salt(self.seed, k), depth, width)
        touched += int(torch.unique(cells).numel())
        if st.get("window_seconds"):
            Wn = st.get("window_buckets", 64)
            wus = st["window_seconds"] * 1_000_000
            ts = tsf + gen.step_delta(k)
            ok = (svc >= 0) & (svc < st["max_services"]) & (tsf >= 0)
            cell = svc[ok] * Wn + (ts[ok] // wus) % Wn
            touched += 2 * int(torch.unique(cell).numel())  # spans, timed
            rows += 3 * P
        return rows, touched

    def _candidates(self, t: int):
        """(valid rows, buckets touched, rows kept) of the four candidate
        families, which no step's salt or time shift moves."""
        if t in self._cand:
            return self._cand[t]
        st, col = self.st, self.templates[t].cols
        S = st["max_services"]
        (n_svc, d_svc), (n_nm, d_nm), (n_an, d_an), (n_bn, d_bn) = \
            self.families[:4]
        n = self.templates[t].n_spans
        a_host = col["ann_service_id"].astype(np.int64)
        a_si = col["ann_span_idx"].astype(np.int64)
        a_ok = (a_host >= 0) & (a_host < S)
        lo = np.full(n, _BIG, np.int64)
        hi = np.full(n, -1, np.int64)
        np.minimum.at(lo, a_si[a_ok], a_host[a_ok])
        np.maximum.at(hi, a_si[a_ok], a_host[a_ok])
        fams = [(np.minimum(a_host[a_ok], n_svc - 1), n_svc, d_svc)]
        name = col["name_id"][a_si].astype(np.int64)
        nm = a_ok & (name >= 0)
        fams.append((mix_keys([a_host[nm], name[nm]]) & np.uint64(n_nm - 1),
                     n_nm, d_nm))
        av = col["ann_value_id"].astype(np.int64)
        v_ok = (av >= gen.FIRST_USER_ANNOTATION_ID) & (av < _BIG)
        h1, h2 = lo[a_si], hi[a_si]
        parts = []
        for h, extra in ((h1, None), (h2, h2 != h1)):
            ok = v_ok & (h >= 0) & (h < S)
            if extra is not None:
                ok &= extra
            parts.append(mix_keys([h[ok], av[ok]]) & np.uint64(n_an - 1))
        fams.append((np.concatenate(parts), n_an, d_an))
        b_si = col["bann_span_idx"].astype(np.int64)
        bk = col["bann_key_id"].astype(np.int64)
        bv = col["bann_value_id"].astype(np.int64)
        bh1, bh2 = lo[b_si], hi[b_si]
        parts = []
        for h, val, extra in ((bh1, bv, None), (bh2, bv, bh2 != bh1),
                              (bh1, -np.ones_like(bv), None),
                              (bh2, -np.ones_like(bv), bh2 != bh1)):
            ok = (bk >= 0) & (h >= 0) & (h < S)
            if extra is not None:
                ok &= extra
            parts.append(mix_keys([h[ok], bk[ok], val[ok]])
                         & np.uint64(n_bn - 1))
        fams.append((np.concatenate(parts), n_bn, d_bn))
        valid = touched = kept = 0
        for b, n_b, d in fams:
            tb, kb = _survivors(b.astype(np.int64), n_b, d)
            valid += b.size
            touched += tb
            kept += kb
        self._cand[t] = (valid, touched, kept)
        return self._cand[t]

    def k2_rows(self, t: int) -> int:
        """Index rows of a step of template ``t``, padding included."""
        return self._template_parts(t)[2]

    def k2(self, t: int, k: int):
        """(index rows, valid rows, buckets touched, rows kept) of step
        ``k`` (template ``t``)."""
        _, _, k2_rows, _, tid, _, _ = self._template_parts(t)
        valid, touched, kept = self._candidates(t)
        if t not in self._rows:
            col = self.templates[t].cols
            self._rows[t] = [None] + [
                torch.from_numpy(col[c].astype(np.int64)).to(self.device)
                for c in ("ann_span_idx", "bann_span_idx")]
        tb = mix_key_torch(tid ^ gen.step_salt(self.seed, k))
        for (n_b, d), rows in zip(self.families[4:], self._rows[t]):
            b = tb & (n_b - 1)
            if rows is not None:
                b = b[rows]
            cnt = torch.bincount(b, minlength=n_b)
            valid += b.numel()
            touched += int(torch.count_nonzero(cnt))
            kept += int(torch.clamp(cnt, max=d).sum())
        return k2_rows, valid, touched, kept


def of_stream(system, device="cpu") -> StepBytes:
    """The byte counts of a restamped stream's steps: its configuration,
    templates and seed, and its store's index families."""
    families = [(f[2], f[3]) for f in system.store.config.idx_layout[0]]
    return StepBytes(system.config["store"], system.templates, system.seed,
                     families, device)
