"""Traffic of the port's benchmark: a template of generated traces and
its restamp, one step of the stream at a time.

The template is the columnar generator's batch (the same draws, in the
same order, as ``zipkin_tpu_torch/tracegen/gen.py:ColumnarTraceGen`` with
``topology=True``, which mirrors upstream zipkin-tracegen): every trace
is a heap-shaped tree of ``spans_per_trace`` spans, root services
uniform, a child's service a fixed function of its parent's (a sparse
call graph), lognormal durations shrinking with depth, two annotation
rows a span (``sr`` and one custom annotation) and one binary
annotation. Dictionary ids are assigned here, densely in first-use
order as a fresh store's dictionaries assign them; the harness checks
that the store hands out the same ids.

Step ``k`` of a run restamps the template: every id is XORed with a
splitmix64 salt of (seed, k), which keeps ``span_id = trace_id ^ node``
and the parent joins, and every timestamp moves ``k`` minutes on. The
same seed gives the same stream; ids of two steps never share a trace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

M64 = (1 << 64) - 1
GOLDEN64 = 0x9E3779B97F4A7C15
STEP_US = 60_000_000
BASE_TS = 1_000_000_000_000
NO_TS = -1
FLAG_HAS_PARENT = 2  # the columnar schema's flag bit (1 is debug)
SR_ID = 2  # the core annotation "sr" (reserved id)
FIRST_USER_ANNOTATION_ID = 8
CUSTOM_ANNOTATION = "some custom annotation"
URI_KEY, URI_VALUE = "http.uri", b"/api/widgets"
BYTES_TYPE = 1

TS_COLS = ("ts_cs", "ts_cr", "ts_sr", "ts_ss", "ts_first", "ts_last")


def splitmix64(x: int) -> int:
    x = (x + GOLDEN64) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def signed64(u: int) -> int:
    u &= M64
    return u - (1 << 64) if u >> 63 else u


def step_salt(seed: int, k: int) -> int:
    """The int64 XOR salt of step ``k`` of a run seeded ``seed``."""
    return signed64(splitmix64((splitmix64(seed & M64) + k + 1) & M64))


def step_delta(k: int) -> int:
    return k * STEP_US


@dataclass
class Names:
    """The strings the template's ids stand for, id order."""

    services: List[str]
    span_names: List[str]
    endpoints: List[tuple]
    annotations: Dict[str, int]
    binary_keys: Dict[str, int]
    binary_values: Dict[bytes, int]


def names_of(n_services: int, n_span_names: int) -> Names:
    return Names(
        services=[f"svc-{i:04d}" for i in range(n_services)],
        span_names=[f"op-{i:04d}" for i in range(n_span_names)],
        endpoints=[(0x0A000000 + i, 9410, f"svc-{i:04d}")
                   for i in range(n_services)],
        annotations={CUSTOM_ANNOTATION: FIRST_USER_ANNOTATION_ID},
        binary_keys={URI_KEY: 0}, binary_values={URI_VALUE: 0})


@dataclass
class Template:
    """One batch of generated traces as numpy columns (``cols``),
    unstamped (step 0 is the template itself)."""

    cols: Dict[str, np.ndarray]
    n_traces: int
    spans_per_trace: int
    first_trace: int = 1

    @property
    def n_spans(self) -> int:
        return self.n_traces * self.spans_per_trace

    @property
    def n_anns(self) -> int:
        return 2 * self.n_spans

    @property
    def n_banns(self) -> int:
        return self.n_spans


def make_template(n_traces: int, n_services: int, n_span_names: int,
                  spans_per_trace: int, seed: int,
                  first_trace: int = 1) -> Template:
    """``n_traces`` traces drawn from ``seed``; trace ``i`` is numbered
    ``first_trace + i`` before the golden-ratio multiply."""
    rng = np.random.default_rng(seed & M64)
    spt = spans_per_trace
    n = n_traces * spt
    tid = np.arange(first_trace, first_trace + n_traces, dtype=np.int64)
    trace_id = np.repeat((tid.astype(np.uint64) * np.uint64(GOLDEN64))
                         .view(np.int64), spt)
    j = np.tile(np.arange(spt, dtype=np.int64), n_traces)
    span_id = trace_id ^ (j + 1)
    has_parent = j > 0
    parent_id = np.where(has_parent, trace_id ^ ((j - 1) // 2 + 1), 0)
    cols_svc = [rng.integers(0, n_services, size=n_traces)]
    for jj in range(1, spt):
        pj = (jj - 1) // 2
        cols_svc.append((cols_svc[pj] * 31 + (jj - 2 * pj)) % n_services)
    service_id = np.stack(cols_svc, axis=1).reshape(-1).astype(np.int32)
    name_id = rng.integers(0, n_span_names, size=n).astype(np.int32)
    depth = np.floor(np.log2(j + 1)).astype(np.int64)
    t0 = BASE_TS + np.repeat(rng.integers(0, 60_000_000, size=n_traces), spt)
    duration = (rng.lognormal(11.0, 1.0, size=n) / (1.0 + depth)
                ).astype(np.int64) + 4
    start = t0 + j * 1000
    end = start + duration
    idx = np.arange(n, dtype=np.int32)
    ann_idx = np.repeat(idx, 2)
    ann_ts = np.empty(2 * n, np.int64)
    ann_ts[0::2] = start + 1
    ann_ts[1::2] = start + duration // 2
    ann_val = np.empty(2 * n, np.int32)
    ann_val[0::2] = SR_ID
    ann_val[1::2] = FIRST_USER_ANNOTATION_ID
    cols = dict(
        trace_id=trace_id, span_id=span_id, parent_id=parent_id,
        name_id=name_id, service_id=service_id,
        ts_cs=start, ts_sr=start + 1, ts_ss=end - 1, ts_cr=end,
        ts_first=start, ts_last=end, duration=duration,
        flags=np.where(has_parent, FLAG_HAS_PARENT, 0).astype(np.uint8),
        ann_span_idx=ann_idx, ann_ts=ann_ts, ann_value_id=ann_val,
        ann_service_id=np.repeat(service_id, 2),
        ann_endpoint_id=np.repeat(service_id, 2),
        bann_span_idx=idx, bann_key_id=np.zeros(n, np.int32),
        bann_value_id=np.zeros(n, np.int32),
        bann_type=np.full(n, BYTES_TYPE, np.uint8),
        bann_service_id=service_id.copy(),
        bann_endpoint_id=service_id.copy())
    return Template(cols, n_traces, spt, first_trace)


def restamp_host(cols: Dict[str, np.ndarray], salt: int, delta: int
                 ) -> Dict[str, np.ndarray]:
    """Step columns on the host (numpy): ids XOR ``salt``, timestamps
    + ``delta``; columns not stamped are shared with ``cols``."""
    out = dict(cols)
    s = np.int64(salt)
    has_parent = (cols["flags"] & FLAG_HAS_PARENT) != 0
    out["trace_id"] = cols["trace_id"] ^ s
    out["span_id"] = cols["span_id"] ^ s
    out["parent_id"] = np.where(has_parent, cols["parent_id"] ^ s, 0)
    for c in TS_COLS + ("ann_ts",):
        v = cols[c]
        out[c] = np.where(v >= 0, v + np.int64(delta), v)
    return out


def restamp_device(db, salt: int, delta: int):
    """The same restamp on the card: ``db`` is the program's padded
    device batch of the template; returns the step's batch (the
    stamped columns new tensors, the rest shared)."""
    import torch

    def shift(ts):
        return torch.where(ts >= 0, ts + delta, ts)

    return db._replace(
        trace_id=db.trace_id ^ salt, span_id=db.span_id ^ salt,
        parent_id=torch.where(db.has_parent, db.parent_id ^ salt,
                              torch.zeros_like(db.parent_id)),
        ts_cs=shift(db.ts_cs), ts_cr=shift(db.ts_cr),
        ts_sr=shift(db.ts_sr), ts_ss=shift(db.ts_ss),
        ts_first=shift(db.ts_first), ts_last=shift(db.ts_last),
        ann_ts=shift(db.ann_ts))


@dataclass(frozen=True)
class Step:
    """Step ``k`` of the stream, made from template ``tmpl``; its spans
    take write positions ``[gid0, gid0 + n_spans)``."""

    k: int
    tmpl: int
    gid0: int
    agid0: int
    bgid0: int


def plan_steps(templates: List[Template], order: List[int]) -> List[Step]:
    """The stream's steps, one per entry of ``order`` (template indices),
    numbered from 0, with their write positions."""
    out, g, a, b = [], 0, 0, 0
    for k, t in enumerate(order):
        out.append(Step(k, t, g, a, b))
        g += templates[t].n_spans
        a += templates[t].n_anns
        b += templates[t].n_banns
    return out
