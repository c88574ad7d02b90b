"""The plain reference: what a store fed the benchmark's stream must hold
and answer, worked out from the stream alone.

Plain numpy and torch (on whichever device the caller gives, in blocks
of one step), written from the stated semantics of each structure and
importing nothing of the port: the ring and side-ring rows, the exact
integer aggregates (per-service span counts and duration histograms,
annotation-host counts, span-name presence, annotation-value and
binary-key counts), the count-min sketch of trace ids, the HyperLogLog
registers, the dependency links' moments, the windowed arena, and the
answers of the trace-id searches and trace fetches.

``precision`` selects the control: ``"low"`` keeps every integer
aggregate in int16 (in place of int32), every id and timestamp in int32
(in place of int64) and the dependency moments in bfloat16 (in place of
float32) -- the next precision down from what the configuration states.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Dict, List, Optional

import numpy as np
import torch

from . import gen

M32 = 0xFFFFFFFF
I32_MIN = -(1 << 31)


# -- hashing (murmur3 finalizer over (hi, lo) 32-bit words) -----------------

def _fmix32(h):
    h = h & M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def hash2_32(hi, lo, seed: int):
    """32-bit hash of a 64-bit key given as int64 tensors of 32-bit words."""
    s = (seed * 0x9E3779B9 + 1) & M32
    h = _fmix32((lo & M32) ^ s)
    return _fmix32(h ^ (hi & M32) ^ ((s * 0x85EBCA6B) & M32))


def words(x: torch.Tensor):
    x = x.to(torch.int64)
    return (x >> 32) & M32, x & M32


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit words (held in int64), by the float64
    exponent (exact below 2^53)."""
    _, e = torch.frexp(x.to(torch.float64))
    return torch.where(x == 0, torch.full_like(e, 32), 32 - e).to(torch.int64)


def hll_update(regs: torch.Tensor, trace_ids: torch.Tensor) -> None:
    hi, lo = words(trace_ids)
    m = regs.shape[0]
    idx = hash2_32(hi, lo, 101) & (m - 1)
    rank = clz32(hash2_32(hi, lo, 202)) + 1
    regs.scatter_reduce_(0, idx, rank.to(regs.dtype), "amax")


def cms_cells(trace_ids: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """[depth, n] flat cells (row * width + bucket) of each key."""
    hi, lo = words(trace_ids)
    h0 = hash2_32(hi, lo, 0)
    h1 = hash2_32(hi, lo, 1)
    rows = torch.arange(depth, dtype=torch.int64, device=trace_ids.device)
    h = h0[None, :] ^ ((h1[None, :] * (2 * rows + 1)[:, None]) & M32)
    return (h & (width - 1)) + rows[:, None] * width


# -- the duration histogram's buckets --------------------------------------

def bucket_index(durations: np.ndarray, n_buckets: int, alpha: float
                 ) -> np.ndarray:
    """DDSketch bucket of each duration: ``ceil(log(v) / log(gamma))`` with
    the log correctly rounded to float32 and the division and ceil in
    float32, values under 1 in bucket 0, clipped to the last bucket."""
    gamma = (1.0 + alpha) / (1.0 - alpha)
    lg = np.float32(math.log(gamma))
    v = np.maximum(durations.astype(np.float32), np.float32(1.0))
    scaled = np.log(v.astype(np.float64)).astype(np.float32)
    idx = np.ceil(scaled / lg)
    return np.clip(idx.astype(np.int64), 0, n_buckets - 1)


# -- the reference store ----------------------------------------------------

class Reference:
    """The expected state after the steps ``steps`` (``gen.plan_steps``)
    of templates ``templates`` under ``seed``; ``store`` is the
    configuration's store section (a dict)."""

    def __init__(self, store: Dict, templates: List[gen.Template],
                 steps: List[gen.Step], seed: int, device="cpu",
                 precision: str = "exact"):
        self.c = store
        self.templates = templates
        self.steps = steps
        self.seed = seed
        self.device = torch.device(device)
        self.low = precision == "low"
        self._gid0 = [s.gid0 for s in steps]
        self._agid0 = [s.agid0 for s in steps]
        self._bgid0 = [s.bgid0 for s in steps]
        self._agg_cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._link_cache: Dict[int, tuple] = {}
        self._bidx = [bucket_index(t.cols["duration"],
                                   store["quantile_buckets"],
                                   store.get("quantile_alpha", 0.01))
                      for t in templates]

    # -- frontier arithmetic -------------------------------------------

    def totals(self, n_steps: int):
        """(spans, annotations, binary annotations) written by the first
        ``n_steps`` steps."""
        if n_steps == 0:
            return 0, 0, 0
        s = self.steps[n_steps - 1]
        t = self.templates[s.tmpl]
        return s.gid0 + t.n_spans, s.agid0 + t.n_anns, s.bgid0 + t.n_banns

    def _step_of(self, gid0s, g: int) -> int:
        return bisect_right(gid0s, g) - 1

    def _cols(self, k: int) -> Dict[str, np.ndarray]:
        s = self.steps[k]
        cols = gen.restamp_host(self.templates[s.tmpl].cols,
                                gen.step_salt(self.seed, k), gen.step_delta(k))
        if self.low:
            cols = {c: (v.astype(np.int32).astype(np.int64)
                        if v.dtype == np.int64 else v)
                    for c, v in cols.items()}
        return cols

    # -- aggregates ------------------------------------------------------

    def _per(self, n_steps: int) -> np.ndarray:
        """Steps of each template among the first ``n_steps``."""
        return np.bincount([s.tmpl for s in self.steps[:n_steps]],
                           minlength=len(self.templates))

    def _tmpl_aggs(self, t: int) -> Dict[str, np.ndarray]:
        """One step of template ``t``'s exact integer aggregates."""
        if t in self._agg_cache:
            return self._agg_cache[t]
        c = self.c
        S, B = c["max_services"], c["quantile_buckets"]
        N, A, K = (c["max_span_names"], c["max_annotation_values"],
                   c["max_binary_keys"])
        col, bidx = self.templates[t].cols, self._bidx[t]
        svc = col["service_id"].astype(np.int64)
        ok = (svc >= 0) & (svc < S)
        hok = ok & (col["duration"] >= 0)
        a_svc = col["ann_service_id"].astype(np.int64)
        a_ok = (a_svc >= 0) & (a_svc < S)
        a_name = col["name_id"][col["ann_span_idx"]].astype(np.int64)
        n_ok = a_ok & (a_name >= 0) & (a_name < N)
        av = col["ann_value_id"].astype(np.int64)
        v_ok = a_ok & (av >= gen.FIRST_USER_ANNOTATION_ID) & (av < A)
        b_svc = col["bann_service_id"].astype(np.int64)
        bk = col["bann_key_id"].astype(np.int64)
        b_ok = (b_svc >= 0) & (b_svc < S) & (bk >= 0) & (bk < K)
        out = {
            "svc_span_counts": np.bincount(svc[ok], minlength=S),
            "svc_hist": np.bincount(svc[hok] * B + bidx[hok],
                                    minlength=S * B).reshape(S, B),
            "ann_svc_counts": np.bincount(a_svc[a_ok], minlength=S),
            "name_presence": np.bincount(a_svc[n_ok] * N + a_name[n_ok],
                                         minlength=S * N).reshape(S, N),
            "ann_value_counts": np.bincount(a_svc[v_ok] * A + av[v_ok],
                                            minlength=S * A).reshape(S, A),
            "bann_key_counts": np.bincount(b_svc[b_ok] * K + bk[b_ok],
                                           minlength=S * K).reshape(S, K),
        }
        self._agg_cache[t] = {k: v.astype(np.int64) for k, v in out.items()}
        return self._agg_cache[t]

    def _low_int(self, a: np.ndarray, dtype=np.int16) -> np.ndarray:
        """``a`` as the control keeps it: ``dtype`` (int16 for int32
        counts, int32 for int64 sums), back in int64."""
        return a.astype(dtype).astype(np.int64) if self.low else a

    def aggregates(self, n_steps: int) -> Dict[str, np.ndarray]:
        """Every exact integer aggregate after ``n_steps`` steps, as
        int64 numpy arrays (int16 arithmetic for the control)."""
        per = self._per(n_steps)
        out: Dict[str, np.ndarray] = {}
        for t in np.nonzero(per)[0]:
            for k, v in self._tmpl_aggs(int(t)).items():
                out[k] = out.get(k, 0) + per[t] * v
        spans, anns, banns = self.totals(n_steps)
        out["counters"] = np.array([spans, anns, banns, n_steps], np.int64)
        return {k: self._low_int(v) for k, v in out.items()}

    def sketches(self, n_steps: int) -> Dict[str, np.ndarray]:
        """HyperLogLog registers and count-min counts of the trace ids of
        the first ``n_steps`` steps."""
        sim = StreamSim(self)
        for k in range(n_steps):
            sim.advance(k)
        return sim.sketches()

    def window(self, n_steps: int) -> Dict[str, np.ndarray]:
        """The windowed arena after ``n_steps`` steps (see StreamSim)."""
        sim = StreamSim(self, sketches=False)
        for k in range(n_steps):
            sim.advance(k)
        return sim.window()

    def _tmpl_links(self, t: int):
        """Template ``t``'s links: (link ids, n, mean, m2) arrays, over
        every child span whose parent is in its trace."""
        if t in self._link_cache:
            return self._link_cache[t]
        S = self.c["max_services"]
        tm = self.templates[t]
        col = tm.cols
        j = np.tile(np.arange(tm.spans_per_trace), tm.n_traces)
        child = np.nonzero(j > 0)[0]
        parent = child - j[child] + (j[child] - 1) // 2
        psvc = col["service_id"][parent].astype(np.int64)
        csvc = col["service_id"][child].astype(np.int64)
        d = col["duration"][child]
        ok = (psvc >= 0) & (psvc < S) & (csvc >= 0) & (csvc < S) & (d >= 0)
        link = psvc[ok] * S + csvc[ok]
        x = d[ok].astype(np.float64)
        if self.low:
            x = _bf16(x)
        n = np.bincount(link, minlength=S * S).astype(np.float64)
        mean = np.bincount(link, weights=x, minlength=S * S) / np.maximum(n, 1)
        dev = x - mean[link]
        m2 = np.bincount(link, weights=dev * dev, minlength=S * S)
        if self.low:
            mean, m2 = _bf16(mean), _bf16(m2)
        ids = np.nonzero(n)[0]
        self._link_cache[t] = (ids, n[ids], mean[ids], m2[ids])
        return self._link_cache[t]

    def links(self, n_steps: int) -> Dict[tuple, tuple]:
        """{(parent service, child service): (n, mean, m2)} after
        ``n_steps`` steps, float64 (bfloat16 moments for the control).
        Every step of one template adds the same durations, so a
        template's moments scale with its step count; templates merge by
        the pairwise (Chan) formula."""
        S = self.c["max_services"]
        per = self._per(n_steps)
        acc: Dict[int, tuple] = {}
        for t in np.nonzero(per)[0]:
            ids, n, mean, m2 = self._tmpl_links(int(t))
            for li, ni, mi, qi in zip(ids.tolist(), (per[t] * n).tolist(),
                                      mean.tolist(), (per[t] * m2).tolist()):
                if li in acc:
                    na, ma, qa = acc[li]
                    nt = na + ni
                    d = mi - ma
                    acc[li] = (nt, ma + d * ni / nt,
                               qa + qi + d * d * na * ni / nt)
                else:
                    acc[li] = (ni, mi, qi)
        return {(li // S, li % S): v for li, v in acc.items()}

    # -- rows --------------------------------------------------------------

    def span_rows(self, n_steps: int, slots: np.ndarray
                  ) -> Dict[str, np.ndarray]:
        """The span ring's columns at ``slots``: the newest span whose
        write position maps to each slot (``row_gid`` -1 where none)."""
        cap = self.c["capacity"]
        total = self.totals(n_steps)[0]
        return self._ring(slots, cap, total, self._gid0, None,
                          ("trace_id", "span_id", "parent_id", "name_id",
                           "service_id", "ts_cs", "ts_cr", "ts_sr", "ts_ss",
                           "ts_first", "ts_last", "duration", "flags"),
                          "row_gid")

    def ann_rows(self, n_steps: int, slots: np.ndarray):
        return self._ring(slots, self.c["ann_capacity"],
                          self.totals(n_steps)[1], self._agid0,
                          "ann_span_idx",
                          ("ann_ts", "ann_value_id", "ann_service_id",
                           "ann_endpoint_id"), "ann_gid")

    def bann_rows(self, n_steps: int, slots: np.ndarray):
        return self._ring(slots, self.c["bann_capacity"],
                          self.totals(n_steps)[2], self._bgid0,
                          "bann_span_idx",
                          ("bann_key_id", "bann_value_id", "bann_type",
                           "bann_service_id", "bann_endpoint_id"), "bann_gid")

    def _ring(self, slots, cap, total, gid0s, owner, cols, gid_col):
        """Rows at ``slots`` of a ring of ``cap`` slots after ``total``
        writes; a side ring's row carries its span's write position (the
        step's first plus the row's ``owner`` column)."""
        slots = np.asarray(slots, np.int64)
        top = total - 1 - ((total - 1 - slots) % cap)
        live = (top >= 0) & (top < total)
        out = {c: np.zeros(len(slots), np.int64) for c in cols}
        out[gid_col] = np.full(len(slots), -1, np.int64)
        by_step: Dict[int, list] = {}
        for i in np.nonzero(live)[0]:
            by_step.setdefault(self._step_of(gid0s, int(top[i])), []).append(i)
        for k, rows in by_step.items():
            rows = np.asarray(rows)
            cols_k = self._cols(k)
            r = top[rows] - gid0s[k]
            for c in cols:
                out[c][rows] = cols_k[c][r]
            out[gid_col][rows] = (top[rows] if owner is None else
                                  self.steps[k].gid0 + cols_k[owner][r])
        out["live"] = live
        return out

    # -- searches and fetches ----------------------------------------------

    def _live_lo(self, n_steps: int) -> int:
        """The oldest write position still in all three rings."""
        spans, anns, banns = self.totals(n_steps)
        lo = spans - self.c["capacity"]
        # a span's side rows must still be in their rings too; the
        # generator writes 2 annotation rows and 1 binary row a span, in
        # span order
        lo = max(lo, -(-(anns - self.c["ann_capacity"]) // 2),
                 banns - self.c["bann_capacity"])
        return max(lo, 0)

    def trace_hits(self, n_steps: int, service: int,
                   name: Optional[int] = None) -> Dict[int, int]:
        """{trace id: newest ts_last} over the live spans of ``service``
        (and span name ``name``) after ``n_steps`` steps: what a search by
        service, by service and span name, by the custom annotation or by
        the binary annotation ranks (every span carries both, hosted on
        its own service)."""
        lo = self._live_lo(n_steps)
        hits: Dict[int, int] = {}
        for k in range(n_steps - 1, -1, -1):
            s = self.steps[k]
            t = self.templates[s.tmpl]
            if s.gid0 + t.n_spans <= lo:
                break
            col = t.cols
            sel = col["service_id"] == service
            if name is not None:
                sel &= col["name_id"] == name
            rows = np.nonzero(sel)[0]
            rows = rows[s.gid0 + rows >= lo]
            salt = gen.step_salt(self.seed, k)
            tid = col["trace_id"][rows] ^ np.int64(salt)
            ts = col["ts_last"][rows] + gen.step_delta(k)
            if self.low:
                tid, ts = _i32(tid), _i32(ts)
            for a, b in zip(tid.tolist(), ts.tolist()):
                if hits.get(a, -1) < b:
                    hits[a] = b
        return hits


def _i32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.int32).astype(np.int64)


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float64)).to(
        torch.bfloat16).double().numpy()


class StreamSim:
    """The reference's stateful structures, advanced one step at a time
    on the reference's device: the HyperLogLog registers, the count-min
    counts and the windowed arena. Arena: per (service, time-bucket
    slot) cell the span, error and timed-span counts, the sums of x^1..x^4
    and the max of -x and x, where x is the duration's histogram bucket
    shifted to 9 bits; a slot belongs to the newest bucket any row
    reached, and older rows are dropped."""

    def __init__(self, ref: Reference, sketches: bool = True):
        c, dev = ref.c, ref.device
        self.ref, self.dev, self.do_sketches = ref, dev, sketches
        self.D, self.W = c.get("cms_depth", 4), c["cms_width"]
        self.regs = torch.zeros(1 << c["hll_p"], dtype=torch.int64, device=dev)
        self.cms = torch.zeros(self.D * self.W, dtype=torch.int64, device=dev)
        self.win = bool(c.get("window_seconds"))
        self.S, self.Wn = c["max_services"], c.get("window_buckets", 64)
        self.wus = c.get("window_seconds", 0) * 1_000_000
        self.shift = max(0, (c["quantile_buckets"] - 1).bit_length() - 9)
        S, Wn = self.S, self.Wn
        self.epoch = torch.full((Wn,), -1, dtype=torch.int64, device=dev)
        self.counts = torch.zeros(S * Wn * 3, dtype=torch.int64, device=dev)
        self.sums = torch.zeros(S * Wn * 4, dtype=torch.int64, device=dev)
        self.mm = torch.full((S * Wn * 2,), I32_MIN, dtype=torch.int64,
                             device=dev)
        self._t: Dict[int, tuple] = {}

    def _cols(self, t: int):
        if t not in self._t:
            ref = self.ref
            col = ref.templates[t].cols
            self._t[t] = tuple(torch.from_numpy(a).to(self.dev) for a in (
                col["trace_id"], col["service_id"].astype(np.int64),
                col["ts_first"], col["duration"],
                ref._bidx[t] >> self.shift))
        return self._t[t]

    def advance(self, k: int) -> None:
        s = self.ref.steps[k]
        tid, svc, tsf, dur, x = self._cols(s.tmpl)
        if self.do_sketches:
            tid = tid ^ gen.step_salt(self.ref.seed, k)
            if self.ref.low:
                tid = tid.to(torch.int32).to(torch.int64)
            hll_update(self.regs, tid)
            cells = cms_cells(tid, self.D, self.W).reshape(-1)
            self.cms.index_add_(0, cells, torch.ones_like(cells))
        if self.win:
            self._window_step(svc, tsf + gen.step_delta(k) * (tsf >= 0), dur, x)

    def _window_step(self, svc, tsf, dur, x) -> None:
        S, Wn = self.S, self.Wn
        ok = (svc >= 0) & (svc < S) & (tsf >= 0)
        bkt = torch.where(ok, tsf, 0) // self.wus
        slot = torch.where(ok, bkt % Wn, 0)
        new = self.epoch.clone()
        new.scatter_reduce_(0, slot[ok], bkt[ok], "amax")
        stale = (new != self.epoch).repeat(S)
        self.epoch = new
        self.counts.view(S * Wn, 3)[stale] = 0
        self.sums.view(S * Wn, 4)[stale] = 0
        self.mm.view(S * Wn, 2)[stale] = I32_MIN
        live = ok & (bkt == self.epoch[slot])
        cell = svc * Wn + slot
        timed = live & (dur >= 0)
        self.counts.index_add_(0, cell[live] * 3, torch.ones_like(cell[live]))
        self.counts.index_add_(0, cell[timed] * 3 + 2,
                               torch.ones_like(cell[timed]))
        xt = x[timed]
        for p in range(4):
            self.sums.index_add_(0, cell[timed] * 4 + p, xt ** (p + 1))
        self.mm.scatter_reduce_(0, cell[timed] * 2, -xt, "amax")
        self.mm.scatter_reduce_(0, cell[timed] * 2 + 1, xt, "amax")

    def sketches(self) -> Dict[str, np.ndarray]:
        cms = self.cms.reshape(self.D, self.W).cpu().numpy()
        return {"hll_traces": self.regs.cpu().numpy(),
                "cms_trace_spans": self.ref._low_int(cms)}

    def window(self) -> Dict[str, np.ndarray]:
        S, Wn = self.S, self.Wn
        out = {"win_epoch": self.epoch.cpu().numpy(),
               "win_counts": self.ref._low_int(
                   self.counts.view(S, Wn, 3).cpu().numpy()),
               "win_sums": self.ref._low_int(
                   self.sums.view(S, Wn, 4).cpu().numpy(), np.int32),
               "win_mm": self.mm.view(S, Wn, 2).cpu().numpy()}
        return out
