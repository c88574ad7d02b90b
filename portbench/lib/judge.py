"""What decides ``correct``: the program's outputs after the window,
held against the reference.

Each number compared is a count of what disagrees (limit 0) or a
relative gap (limit set from readings; ``limits/<cell>.json``):

- ``counts_off``: summed absolute difference of the counters (spans,
  annotations, binary annotations, steps), the per-service span counts
  and duration histograms, the annotation-host, span-name, annotation-
  value and binary-key counts, and the count-min counts.
- ``hll_off``: HyperLogLog registers that differ.
- ``window_off``: summed absolute difference of the windowed arena
  (epochs, counts, sums, min/max) where the configuration has one.
- ``rows_off``: sampled rows of the span, annotation and binary rings
  with any column different.
- ``index_off``: sampled trace-id searches by service, by service and
  span name, by annotation and by binary annotation, made on the store
  after the window, whose answer is not the newest ``limit`` traces.
- ``dep_count_off``: summed difference of dependency-link call counts
  (a link missing or extra counts whole).
- ``dep_gap``: the largest relative gap of a link's mean or m2.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import gen
from .reference import Reference


def signed(x: int) -> int:
    return gen.signed64(int(x))


# -- what the program holds ---------------------------------------------

AGG_LEAVES = ("svc_span_counts", "svc_hist", "ann_svc_counts",
              "name_presence", "ann_value_counts", "bann_key_counts")
COUNTERS = ("spans_seen", "anns_seen", "banns_seen", "batches")
SPAN_COLS = ("trace_id", "span_id", "parent_id", "name_id", "service_id",
             "ts_cs", "ts_cr", "ts_sr", "ts_ss", "ts_first", "ts_last",
             "duration", "flags", "row_gid")
ANN_COLS = ("ann_ts", "ann_value_id", "ann_service_id", "ann_endpoint_id",
            "ann_gid")
BANN_COLS = ("bann_key_id", "bann_value_id", "bann_type", "bann_service_id",
             "bann_endpoint_id", "bann_gid")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.int64)


def program_state(store, slots: Dict[str, np.ndarray]) -> Dict:
    """The program's integer leaves and sampled ring rows (numpy)."""
    st = store.state
    out = {k: _np(st.leaves[k]) for k in AGG_LEAVES}
    out["counters"] = np.array([int(st.counters[k]) for k in COUNTERS],
                               np.int64)
    out["cms_trace_spans"] = _np(st.cms_trace_spans)
    out["hll_traces"] = _np(st.hll_traces)
    if store.config.window_enabled:
        for k in ("win_epoch", "win_counts", "win_sums", "win_mm"):
            out[k] = _np(st.leaves[k])
    for ring, cols in (("span", SPAN_COLS), ("ann", ANN_COLS),
                       ("bann", BANN_COLS)):
        idx = torch.as_tensor(slots[ring], device=st.device)
        out[ring] = {c: _np(st.leaves[c][idx]) for c in cols}
    return out


def program_links(store) -> Dict[tuple, tuple]:
    svc = {n: i for i, n in enumerate(store.dicts.services.values())}
    return {(svc[l.parent], svc[l.child]):
            (l.duration_moments.n, l.duration_moments.mean,
             l.duration_moments.m2)
            for l in store.get_dependencies().links}


def program_searches(store, names, queries) -> List[list]:
    """Each query of ``queries`` asked of the store directly."""
    end = (1 << 62)
    out = []
    for kind, svc, arg, limit in queries:
        s = names.services[svc]
        if kind == "by_service":
            got = store.get_trace_ids_by_name(s, None, end, limit)
        elif kind == "by_name":
            got = store.get_trace_ids_by_name(s, names.span_names[arg], end,
                                              limit)
        elif kind == "by_annotation":
            got = store.get_trace_ids_by_annotation(
                s, gen.CUSTOM_ANNOTATION, None, end, limit)
        else:
            got = store.get_trace_ids_by_annotation(
                s, gen.URI_KEY, gen.URI_VALUE, end, limit)
        out.append([(signed(i.trace_id), int(i.timestamp)) for i in got])
    return out


# -- what the reference holds -------------------------------------------

def reference_state(ref: Reference, n: int, slots: Dict[str, np.ndarray],
                    window: bool) -> Dict:
    out = dict(ref.aggregates(n))
    out.update(ref.sketches(n))
    if window:
        out.update(ref.window(n))
    out["span"] = ref.span_rows(n, slots["span"])
    out["ann"] = ref.ann_rows(n, slots["ann"])
    out["bann"] = ref.bann_rows(n, slots["bann"])
    return out


def reference_searches(ref: Reference, n: int, queries) -> List[list]:
    out = []
    for kind, svc, arg, limit in queries:
        hits = ref.trace_hits(n, svc, arg if kind == "by_name" else None)
        top = sorted(hits.items(), key=lambda kv: -kv[1])[:limit]
        out.append(top)
    return out


# -- comparisons -----------------------------------------------------------

def _l1(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64)).sum())


def _rows_off(got: Dict, want: Dict, cols) -> int:
    bad = np.zeros(len(want[cols[-1]]), bool)
    live = want["live"]
    for c in cols:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if c.endswith("gid"):
            bad |= g != w
        else:
            bad |= live & (g != w)
    return int(bad.sum())


def search_ok(answer: List[tuple], hits: Dict[int, int], limit: int) -> bool:
    """An answer of (trace id, timestamp) pairs or of trace ids is right
    when it holds the newest ``limit`` distinct traces: each a trace with
    a matching live span, their newest timestamps those of the top
    ``limit`` (ties at the edge may pick either trace)."""
    ids = [a[0] if isinstance(a, tuple) else a for a in answer]
    ids = [signed(i) for i in ids]
    if len(set(ids)) != len(ids) or any(i not in hits for i in ids):
        return False
    if isinstance(answer[0] if answer else None, tuple):
        if any(hits[signed(a[0])] != a[1] for a in answer):
            return False
    want = sorted(hits.values(), reverse=True)[:limit]
    return sorted((hits[i] for i in ids), reverse=True) == want


def compare_state(got: Dict, want: Dict, window: bool) -> Dict[str, int]:
    counts = _l1(got["counters"], want["counters"])
    for k in AGG_LEAVES + ("cms_trace_spans",):
        counts += _l1(got[k], want[k])
    out = {"counts_off": counts,
           "hll_off": int((np.asarray(got["hll_traces"])
                           != np.asarray(want["hll_traces"])).sum())}
    if window:
        out["window_off"] = sum(_l1(got[k], want[k]) for k in (
            "win_epoch", "win_counts", "win_sums", "win_mm"))
    out["rows_off"] = (_rows_off(got["span"], want["span"], SPAN_COLS)
                       + _rows_off(got["ann"], want["ann"], ANN_COLS)
                       + _rows_off(got["bann"], want["bann"], BANN_COLS))
    return out


def compare_links(got: Dict[tuple, tuple], want: Dict[tuple, tuple]):
    off, gap = 0, 0.0
    for key in set(got) | set(want):
        if key not in got or key not in want:
            off += int((got.get(key) or want.get(key))[0])
            continue
        g, w = got[key], want[key]
        off += int(abs(g[0] - w[0]))
        for i in (1, 2):
            if w[i] != 0 or g[i] != 0:
                gap = max(gap, abs(g[i] - w[i]) / max(abs(w[i]), 1e-30))
    return off, gap
