"""Windowed Moments-sketch analytics arena: the host math.

The port's copy of ``zipkin_tpu/aggregate/windows.py``; only the
bucket-index import differs (``store/archive/sketches.py``, the twin of
the port's device ``bucket_index``).

The store keeps a dense ``[S, W, k]`` grid of integer Moments-sketch
cells keyed by (service, time bucket): per cell a count triple
(total spans, error spans, duration-carrying spans), the power sums
``Σx, Σx², Σx³, Σx⁴`` of the QUANTIZED log-duration ``x``, and the
cell's (min, max) of ``x``. Merging two cells — and therefore
answering ANY ad-hoc window [b0, b1] — is a vector add (+ min/max),
the Moments-sketch property (PAPERS.md: "Moment-Based Quantile
Sketches…", with the time/space cell-grid layout of "Sketch
Disaggregation Across Time and Space"). Time buckets are
RING-indexed: absolute bucket ``a = ts_first // window_us`` lives at
slot ``a % W`` stamped with ``a`` in the epoch array, so a stale slot
self-clears the first time a newer bucket lands on it — no sweep.

Quantization (why integers, not the paper's floats): every cell field
is an int32/int64 accumulated by scatter-add/-max, so device cells and
the numpy mirror twins agree BITWISE regardless of accumulation order
(float sums would diverge between the device's scatter order and
np.add.at).
``x`` is the span duration's ``ops.quantile.bucket_index`` in the
store's log-histogram geometry, right-shifted so x < 2^MAX_X_BITS:
moments of x are log-duration moments up to a known affine map, which
is exactly the paper's log-transform for long-tailed data, and the
shift bounds ``Σx⁴`` so a cell holds ~1e8 worst-case spans before
int64 overflow (documented in docs/OBSERVABILITY.md).

Reads solve the classic maximum-entropy problem over the cell's
bounded integer support (min_x..max_x): Newton iterations on a
Chebyshev-basis exponential-family density, with a Gaussian
(moment-matched) fallback when the solve degenerates. Quantile error
is a RANK-space tolerance (``SOLVER_RANK_TOL``), the paper's metric —
cell SUMS are exact (bitwise vs any oracle using the same
quantization); only the density reconstruction is approximate.

Everything here is pure numpy — it runs identically against the
host mirror twins (store/mirror.SketchMirror) and against
device-fetched arrays, which is what the bitwise gates compare.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np

from zipkin_tpu_torch.store.archive.sketches import hist_bucket_index

I32_MIN = np.int32(-(1 << 31))
# Cell layout widths (the k axis of the three state arrays).
N_COUNT_FIELDS = 3  # total, err, n(duration-carrying)
N_SUM_FIELDS = 4  # Σx, Σx², Σx³, Σx⁴
N_MM_FIELDS = 2  # max(-x) (i.e. -min x), max(x)
# x < 2^MAX_X_BITS after the shift: Σx⁴ < n · 2^36, so an int64 cell
# sum is exact to ~1.3e8 spans per (service, bucket) cell even with
# every span in the top duration bucket.
MAX_X_BITS = 9
# Documented solver tolerance: the maxent quantile estimate's CDF rank
# at the true distribution is within this of the requested q (the
# Moments-sketch paper's ε_avg metric; tests/test_windows.py gates it).
SOLVER_RANK_TOL = 0.10

DEFAULT_BURN_WINDOWS_S = (300, 1800, 3600, 21600)
DEFAULT_OBJECTIVE = 0.999
DEFAULT_HEATMAP_BANDS = 12


def win_x_shift(quantile_buckets: int) -> int:
    """Right-shift applied to the fine histogram bucket index so the
    window cells' x domain stays under 2^MAX_X_BITS."""
    return max(0, (quantile_buckets - 1).bit_length() - MAX_X_BITS)


def duration_x(durations, quantile_buckets: int, gamma: float) -> np.ndarray:
    """Quantized log-duration (int32): fine bucket index >> shift.
    The fine index is the float32 twin the mirror already shares with
    the device (archive.sketches.hist_bucket_index)."""
    fine = hist_bucket_index(durations, quantile_buckets, gamma, 1.0)
    return (fine >> win_x_shift(quantile_buckets)).astype(np.int32)


def x_to_duration(x: float, gamma: float, shift: int,
                  min_value: float = 1.0) -> float:
    """Geometric midpoint of coarse bucket ``x`` in µs — the same
    bucket→value convention as ops.quantile.quantiles_host, at the
    coarse bucket's center fine index."""
    if x <= 0:
        return float(min_value)
    fine = x * (1 << shift) + ((1 << shift) - 1) / 2.0
    return float(min_value * gamma ** fine * (2.0 / (1.0 + gamma)))


def x_edge_duration(x: float, gamma: float, shift: int,
                    min_value: float = 1.0) -> float:
    """LOWER boundary (µs) of coarse bucket ``x`` — heatmap band
    edges, vs the midpoint convention quantiles report."""
    if x <= 0:
        return float(min_value)
    return float(min_value * gamma ** (x * (1 << shift)))


# -- error spans -------------------------------------------------------------


def error_ids(dicts) -> tuple:
    """(annotation-value id, binary-key id) of the "error" convention
    strings, -1 when never interned. Deterministic given dictionary
    state, so WAL replay recomputes identical flags."""
    ea = dicts.annotations.get("error")
    eb = dicts.binary_keys.get("error")
    return (-1 if ea is None else int(ea), -1 if eb is None else int(eb))


def span_error_flags(batch, err_ann_id: int, err_bann_id: int) -> np.ndarray:
    """Per-span bool: carries an annotation valued "error" or a binary
    annotation keyed "error" (the zipkin error convention). Pure
    function of the encoded SpanBatch — stage 1 computes it once for
    the device batch and once for the mirror delta, identically."""
    flags = np.zeros(batch.n_spans, bool)
    if err_ann_id >= 0 and batch.n_annotations:
        sel = batch.ann_value_id[: batch.n_annotations] == err_ann_id
        flags[batch.ann_span_idx[: batch.n_annotations][sel]] = True
    if err_bann_id >= 0 and batch.n_binary:
        sel = batch.bann_key_id[: batch.n_binary] == err_bann_id
        flags[batch.bann_span_idx[: batch.n_binary][sel]] = True
    return flags


# -- stage-1 planning + the numpy fold (the device step's twin) --------------


class WindowUpdate(NamedTuple):
    """One launch CHUNK's pre-masked window rows (COO). Chunks must
    fold in launch order: the epoch war + stale-clear is stateful, and
    a chained group runs one device step per chunk."""

    svc: np.ndarray  # int32 [N]
    bucket: np.ndarray  # int64 [N] — absolute time bucket
    x: np.ndarray  # int32 [N]; -1 = span carries no duration
    err: np.ndarray  # bool [N]


def plan_window_update(batch, error_flags, config) -> WindowUpdate:
    """The mirror twin of the device masking: rows with a
    representable owning service and a timestamp. Pure host function
    (stage 1)."""
    n = batch.n_spans
    svc = np.asarray(batch.service_id[:n], np.int64)
    tsf = np.asarray(batch.ts_first[:n], np.int64)
    ok = (svc >= 0) & (svc < config.max_services) & (tsf >= 0)
    dur = np.asarray(batch.duration[:n], np.int64)
    gamma = (1.0 + config.quantile_alpha) / (1.0 - config.quantile_alpha)
    x = duration_x(dur, config.quantile_buckets, gamma)
    x = np.where(dur >= 0, x, np.int32(-1))
    bucket = tsf // np.int64(config.window_us)
    err = np.asarray(error_flags, bool)[:n]
    return WindowUpdate(
        svc[ok].astype(np.int32), bucket[ok], x[ok], err[ok]
    )


def apply_window_update(u: WindowUpdate, epoch: np.ndarray,
                        counts: np.ndarray, sums: np.ndarray,
                        mm: np.ndarray) -> tuple:
    """Fold one chunk's rows into the (epoch, counts, sums, mm) arena
    IN PLACE — integer-for-integer what the device step does, so
    mirror cells match device cells bitwise. Returns (spans, errors)
    folded (the zipkin_window_* counters)."""
    W = epoch.shape[0]
    if u.svc.size == 0:
        return 0, 0
    slot = (u.bucket % W).astype(np.int64)
    new_epoch = epoch.copy()
    np.maximum.at(new_epoch, slot, u.bucket)
    stale = new_epoch != epoch
    if stale.any():
        counts[:, stale, :] = 0
        sums[:, stale, :] = 0
        mm[:, stale, :] = I32_MIN
    epoch[:] = new_epoch
    live = u.bucket == new_epoch[slot]
    svc = u.svc[live].astype(np.int64)
    cid = svc * W + slot[live]
    np.add.at(counts.reshape(-1), cid * N_COUNT_FIELDS, np.int32(1))
    err = u.err[live]
    np.add.at(counts.reshape(-1), cid[err] * N_COUNT_FIELDS + 1,
              np.int32(1))
    x = u.x[live]
    d = x >= 0
    cid_d = cid[d]
    np.add.at(counts.reshape(-1), cid_d * N_COUNT_FIELDS + 2,
              np.int32(1))
    xi = x[d].astype(np.int64)
    flat_sums = sums.reshape(-1)
    base = cid_d * N_SUM_FIELDS
    np.add.at(flat_sums, base, xi)
    np.add.at(flat_sums, base + 1, xi * xi)
    np.add.at(flat_sums, base + 2, xi * xi * xi)
    np.add.at(flat_sums, base + 3, xi * xi * xi * xi)
    flat_mm = mm.reshape(-1)
    x32 = x[d].astype(np.int32)
    np.maximum.at(flat_mm, cid_d * N_MM_FIELDS, -x32)
    np.maximum.at(flat_mm, cid_d * N_MM_FIELDS + 1, x32)
    return int(live.sum()), int(err.sum())


# -- merged-cell reads -------------------------------------------------------


class WindowSum(NamedTuple):
    """A merged (service × bucket-range) Moments-sketch cell."""

    total: int
    err: int
    n: int
    s1: int
    s2: int
    s3: int
    s4: int
    min_x: int
    max_x: int

    @property
    def error_rate(self) -> float:
        return (self.err / self.total) if self.total else 0.0


def live_slots(epoch: np.ndarray, b0: int, b1: int) -> np.ndarray:
    """Ring slots whose stamped absolute bucket lies in [b0, b1]."""
    return np.flatnonzero((epoch >= b0) & (epoch <= b1))


def merge_cells(epoch: np.ndarray, counts_row: np.ndarray,
                sums_row: np.ndarray, mm_row: np.ndarray,
                b0: int, b1: int) -> WindowSum:
    """Sum one service's live cells over absolute buckets [b0, b1] —
    the O(1)-per-cell vector-add merge that makes any ad-hoc window a
    cell-sum instead of a segment scan. Row arrays are [W, k] (the
    mirror's ``window_row`` slices)."""
    slots = live_slots(epoch, b0, b1)
    if slots.size == 0:
        return WindowSum(0, 0, 0, 0, 0, 0, 0, 0, 0)
    c = counts_row[slots, :].astype(np.int64).sum(axis=0)
    s = sums_row[slots, :].sum(axis=0)
    m = mm_row[slots, :]
    have = counts_row[slots, 2] > 0
    if have.any():
        min_x = int(-m[have, 0].max())
        max_x = int(m[have, 1].max())
    else:
        min_x = max_x = 0
    return WindowSum(int(c[0]), int(c[1]), int(c[2]),
                     int(s[0]), int(s[1]), int(s[2]), int(s[3]),
                     min_x, max_x)


def cell_sums(slots: np.ndarray, counts_row, sums_row, mm_row):
    """Per-slot WindowSum list (heatmap columns)."""
    out = []
    for w in np.asarray(slots, np.int64):
        c = counts_row[w, :]
        s = sums_row[w, :]
        n = int(c[2])
        out.append(WindowSum(
            int(c[0]), int(c[1]), n,
            int(s[0]), int(s[1]), int(s[2]), int(s[3]),
            int(-mm_row[w, 0]) if n else 0,
            int(mm_row[w, 1]) if n else 0,
        ))
    return out


# -- maximum-entropy density reconstruction ----------------------------------


def _power_moments(ws: WindowSum) -> np.ndarray:
    """E[x^k] for k = 0..4 (float64)."""
    n = float(ws.n)
    return np.array([1.0, ws.s1 / n, ws.s2 / n, ws.s3 / n, ws.s4 / n])


def _cheb_recurrence(u: np.ndarray, k: int) -> np.ndarray:
    """[k+1, len(u)] Chebyshev T_0..T_k on points u ∈ [-1, 1]."""
    T = np.empty((k + 1, u.shape[0]))
    T[0] = 1.0
    if k >= 1:
        T[1] = u
    for i in range(2, k + 1):
        T[i] = 2.0 * u * T[i - 1] - T[i - 2]
    return T


def maxent_pmf(ws: WindowSum) -> Optional[tuple]:
    """(support xs, pmf) solving the 4-moment maximum-entropy problem
    over the integer support [min_x, max_x] (the Moments-sketch
    solver, discrete form): Newton on the dual potential in a
    Chebyshev basis, Gaussian moment-matched fallback when the solve
    degenerates. Deterministic (no randomness)."""
    if ws.n <= 0:
        return None
    if ws.max_x <= ws.min_x:
        return np.array([ws.min_x]), np.array([1.0])
    xs = np.arange(ws.min_x, ws.max_x + 1, dtype=np.int64)
    c = 0.5 * (ws.min_x + ws.max_x)
    h = 0.5 * (ws.max_x - ws.min_x)
    m = _power_moments(ws)
    # E[u^k] via binomial expansion of ((x - c)/h)^k.
    mu = np.zeros(5)
    for k in range(5):
        acc = 0.0
        for j in range(k + 1):
            acc += (math.comb(k, j) * ((-c) ** (k - j)) * m[j])
        mu[k] = acc / (h ** k)
    # Chebyshev targets from normalized power moments.
    t = np.array([
        mu[1],
        2.0 * mu[2] - 1.0,
        4.0 * mu[3] - 3.0 * mu[1],
        8.0 * mu[4] - 8.0 * mu[2] + 1.0,
    ])
    u = (xs - c) / h
    T = _cheb_recurrence(u, 4)[1:]  # [4, n] — T_1..T_4
    theta = np.zeros(4)

    def density(th):
        z = th @ T
        z -= z.max()
        p = np.exp(z)
        return p / p.sum()

    converged = False
    for _ in range(60):
        p = density(theta)
        e = T @ p
        grad = e - t
        if np.abs(grad).max() < 1e-9:
            converged = True
            break
        cov = (T * p) @ T.T - np.outer(e, e)
        try:
            step = np.linalg.solve(cov + 1e-10 * np.eye(4), grad)
        except np.linalg.LinAlgError:
            break
        # Backtracking on the dual potential F(θ) = log Z(θ) - θ·t.
        def potential(th):
            z = th @ T
            zm = z.max()
            return zm + math.log(np.exp(z - zm).sum()) - th @ t

        f0 = potential(theta)
        scale = 1.0
        for _bt in range(25):
            cand = theta - scale * step
            if potential(cand) < f0:
                theta = cand
                break
            scale *= 0.5
        else:
            break
    else:
        converged = np.abs(T @ density(theta) - t).max() < 1e-5
    p = density(theta)
    if not converged or not np.isfinite(p).all():
        # Gaussian moment-matched fallback on the same support.
        mean = m[1]
        var = max(m[2] - m[1] * m[1], 1e-12)
        z = -0.5 * (xs - mean) ** 2 / var
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
    return xs, p


def quantiles_from_sums(ws: WindowSum, qs: Sequence[float],
                        gamma: float, shift: int) -> Optional[list]:
    """Quantile estimates (µs) from one merged cell: maxent pmf →
    CDF inversion → coarse-bucket geometric midpoint. None when the
    window holds no duration-carrying span."""
    solved = maxent_pmf(ws)
    if solved is None:
        return None
    xs, p = solved
    cdf = np.cumsum(p)
    out = []
    for q in qs:
        i = int(np.searchsorted(cdf, min(max(q, 0.0), 1.0) - 1e-12))
        i = min(i, xs.shape[0] - 1)
        out.append(x_to_duration(float(xs[i]), gamma, shift))
    return out


def band_edges_x(min_x: int, max_x: int, bands: int) -> np.ndarray:
    """Integer band edges (len bands+1) covering [min_x, max_x+1) —
    the duration axis of the heatmap, even in log space because x
    already is log-duration."""
    bands = max(1, int(bands))
    edges = np.unique(np.round(
        np.linspace(min_x, max_x + 1, bands + 1)).astype(np.int64))
    if edges.shape[0] < 2:
        edges = np.array([min_x, max_x + 1], np.int64)
    return edges


def band_masses(ws: WindowSum, edges: np.ndarray) -> np.ndarray:
    """Expected span count per duration band for one cell: pmf mass
    within each [edges[i], edges[i+1]) times the cell count."""
    out = np.zeros(edges.shape[0] - 1)
    solved = maxent_pmf(ws)
    if solved is None:
        return out
    xs, p = solved
    idx = np.clip(np.searchsorted(edges, xs, side="right") - 1, 0,
                  out.shape[0] - 1)
    np.add.at(out, idx, p * ws.n)
    return out
