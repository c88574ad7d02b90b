"""Device-resident columnar span store on torch tensors: state, the fused
ingest step, the dependency path and the read kernels.

The PyTorch counterpart of ``zipkin_tpu/store/device.py``. One batch of
spans goes through ONE ``ingest_step`` call that writes the span,
annotation and binary-annotation rings, runs the streaming dependency
join, writes the unified index arena, and updates the counters,
presence matrices, latency histograms, HyperLogLog and count-min.

State is a ``StoreState``: the static ``StoreConfig`` plus a dict of
tensors keyed by the JAX ``StoreState`` field names (``counters`` is a
nested dict of 0-d int64 tensors). Every function works on the tensors'
own device. Where the JAX functions donate the state buffer
(``ingest_step``, ``ingest_steps``, ``dep_sweep``, ``dep_close_bucket``)
the port updates the state IN PLACE and returns the same object.

With ``StoreConfig.use_pallas`` the step makes its seven scatter-adds
in one launch of the flat-histogram kernel, takes the index rows' FIFO
ranks and bucket counts from the arena claim kernel (in place of either
rank path) and the arena entry write from the arena write kernel, and
the paged trace read gathers its pages through
the page-gather kernel (``ops/kernels.py``); on CPU tensors those
wrappers run their plain twins. Both span layouts are ported:
``layout="ring"`` and ``layout="paged"`` (slots and gids planned by the
host ``store/paged.PagePlanner``). With ``window_seconds > 0`` the step
also folds every span into the windowed Moments-sketch arena
(``win_*``; host math and mirror twin in ``aggregate/windows.py``); its
``win_counts`` update is the eighth site of the fused flat-histogram
launch. ``stage_batches`` is the ingest pipeline's stage-2 H2D copy.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from zipkin_tpu_torch.columnar.schema import SpanBatch
from zipkin_tpu_torch.models.constants import FIRST_USER_ANNOTATION_ID
from zipkin_tpu_torch.ops import cms, hll
from zipkin_tpu_torch.ops import join
from zipkin_tpu_torch.ops import kernels as K
from zipkin_tpu_torch.ops import moments as M
from zipkin_tpu_torch.ops import quantile as Q
from zipkin_tpu_torch.ops.hashing import dev_split64, mix_keys64, srl

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
I32_MIN = -(1 << 31)
NO_TS = -1


class _StoreConfigFields(NamedTuple):
    capacity: int = 1 << 16
    ann_capacity: int = 1 << 18
    bann_capacity: int = 1 << 17
    max_services: int = 256
    max_span_names: int = 2048
    max_annotation_values: int = 4096
    max_binary_keys: int = 1024
    cms_depth: int = 4
    cms_width: int = 1 << 16
    hll_p: int = 14
    quantile_buckets: int = 2048
    quantile_alpha: float = 0.01
    dep_buckets: int = 16
    span_tab_slots: int = 0
    pend_slots: int = 0
    use_index: bool = True
    idx_service_depth: int = 0
    idx_name_buckets: int = 0
    idx_name_depth: int = 0
    idx_ann_buckets: int = 0
    idx_ann_depth: int = 0
    idx_bann_buckets: int = 0
    idx_bann_depth: int = 0
    idx_trace_buckets: int = 0
    idx_key_slots: int = 0
    use_pallas: bool = False
    batch_spans: int = 0
    rank_path: str = "auto"
    window_seconds: int = 0
    window_buckets: int = 64
    layout: str = "ring"
    page_rows: int = 256
    page_max_chain: int = 64


class StoreConfig(_StoreConfigFields):
    """Static store geometry: the same fields and derived geometry as
    ``zipkin_tpu.store.device.StoreConfig``. ``use_pallas`` selects the
    hand-written CUDA kernels (the name is kept so configurations carry
    over unchanged)."""

    __slots__ = ()

    def __new__(cls, *args, **kw):
        self = super().__new__(cls, *args, **kw)
        if self.layout not in ("ring", "paged"):
            raise ValueError(f"unknown layout {self.layout!r} "
                             "(expected 'ring' or 'paged')")
        if self.rank_path not in ("auto", "argsort", "counting"):
            raise ValueError(f"unknown rank_path {self.rank_path!r}")
        return self

    @property
    def paged_enabled(self) -> bool:
        return self.layout == "paged"

    @property
    def n_pages(self) -> int:
        return self.capacity // max(1, self.page_rows)

    @property
    def tab_slots(self) -> int:
        return _next_pow2_int(self.span_tab_slots or 2 * self.capacity)

    @property
    def pending_slots(self) -> int:
        return _next_pow2_int(self.pend_slots or max(1 << 16,
                                                     self.capacity // 4))

    def _derived(self, explicit: int, scale: int, lo: int, hi: int) -> int:
        return _next_pow2_int(
            explicit or max(lo, min(hi, self.capacity // scale)))

    @property
    def svc_depth(self) -> int:
        return self._derived(self.idx_service_depth, 64, 64, 4096)

    @property
    def name_buckets(self) -> int:
        return self._derived(self.idx_name_buckets, 32, 256, 8192)

    @property
    def name_depth(self) -> int:
        return self._derived(self.idx_name_depth, 512, 64, 512)

    @property
    def ann_buckets(self) -> int:
        return self._derived(self.idx_ann_buckets, 16, 256, 16384)

    @property
    def ann_depth(self) -> int:
        return self._derived(self.idx_ann_depth, 512, 64, 512)

    @property
    def bann_buckets(self) -> int:
        return self._derived(self.idx_bann_buckets, 32, 256, 8192)

    @property
    def bann_depth(self) -> int:
        return self._derived(self.idx_bann_depth, 1024, 32, 256)

    TRACE_SPAN_DEPTH = 64
    TRACE_ANN_DEPTH = 128
    TRACE_BANN_DEPTH = 64

    @property
    def trace_buckets(self) -> int:
        return _next_pow2_int(
            self.idx_trace_buckets
            or max(256, 4 * self.capacity // self.TRACE_SPAN_DEPTH))

    @property
    def idx_layout(self):
        B = self.trace_buckets
        return _pack_layout((
            (self.max_services, self.svc_depth),
            (self.name_buckets, self.name_depth),
            (self.ann_buckets, self.ann_depth),
            (self.bann_buckets, self.bann_depth),
            (B, self.TRACE_SPAN_DEPTH),
            (B, self.TRACE_ANN_DEPTH),
            (B, self.TRACE_BANN_DEPTH),
        ))

    CAND_SVC, CAND_NAME, CAND_ANN, CAND_BANN = range(4)
    N_CAND_FAMILIES = 4

    @property
    def cand_layout(self):
        rows, _, _ = self.idx_layout
        cand = rows[: self.N_CAND_FAMILIES]
        b_base, s_base, n_b, depth = cand[-1]
        return cand, b_base + n_b, s_base + n_b * depth

    @property
    def key_slots(self) -> int:
        return _next_pow2_int(self.idx_key_slots or 2 * self.cand_layout[1])

    @property
    def trace_layout(self):
        rows, total_b, total_s = self.idx_layout
        return rows[self.N_CAND_FAMILIES:], total_b, total_s

    TR_SPAN, TR_ANN, TR_BANN = range(3)

    # -- windowed analytics arena geometry --------------------------------

    @property
    def window_us(self) -> int:
        return int(self.window_seconds) * 1_000_000

    @property
    def window_enabled(self) -> bool:
        return self.window_seconds > 0 and self.window_buckets > 0

    @property
    def win_slots(self) -> int:
        """The ring length with the arena on; a 1-slot stub otherwise
        (the state keeps its schema without [S, W, k] memory)."""
        return max(1, self.window_buckets) if self.window_enabled else 1

    @property
    def win_x_shift(self) -> int:
        """Right shift of the fine bucket index that gives the window
        cells' quantized log-duration ``x`` (one definition, shared
        with the host mirror)."""
        from zipkin_tpu_torch.aggregate.windows import win_x_shift

        return win_x_shift(self.quantile_buckets)

    @property
    def gamma(self) -> float:
        return Q.gamma_of(self.quantile_alpha)


def _next_pow2_int(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _pack_layout(fams):
    out = []
    b_base = s_base = 0
    for n_b, depth in fams:
        out.append((b_base, s_base, n_b, depth))
        b_base += n_b
        s_base += n_b * depth
    return tuple(out), b_base, s_base


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for
    the CPU, and no silent fallback when CUDA is missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the store "
            "on the CPU")
    return dev


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

FIELDS = (
    "trace_id", "span_id", "parent_id", "name_id", "name_lc_id",
    "service_id", "ts_cs", "ts_cr", "ts_sr", "ts_ss", "ts_first",
    "ts_last", "duration", "flags", "indexable", "row_gid", "write_pos",
    "ann_gid", "ann_ts", "ann_value_id", "ann_service_id",
    "ann_endpoint_id", "ann_write_pos",
    "bann_gid", "bann_key_id", "bann_value_id", "bann_type",
    "bann_service_id", "bann_endpoint_id", "bann_write_pos",
    "dep_moments", "dep_banks", "dep_bank_ts", "dep_overflow_ts",
    "dep_bank_seq", "dep_window", "dep_window_ts", "span_tab",
    "pend_key", "pend_dur", "pend_tsf", "pend_tsl", "pend_pos",
    "cand_idx", "cand_pos", "cand_wm",
    "ann_poison", "key_tab", "key_wm",
    "svc_hist", "svc_span_counts", "ann_svc_counts",
    "name_presence", "ann_value_counts", "bann_key_counts",
    "hll_traces", "cms_trace_spans", "ts_min", "ts_max",
    "win_epoch", "win_counts", "win_sums", "win_mm", "counters",
)
COUNTER_NAMES = ("spans_seen", "anns_seen", "banns_seen", "batches",
                 "key_claim_drops", "sweeps")


class StoreState:
    """``config`` plus ``leaves``: a dict of tensors keyed by the JAX
    StoreState field names (``counters`` a nested dict). Leaves read as
    attributes (``state.trace_id``)."""

    def __init__(self, config: StoreConfig, leaves: Dict[str, object]):
        self.config = config
        self.leaves = leaves

    def __getattr__(self, name):
        try:
            return self.__dict__["leaves"][name]
        except KeyError:
            raise AttributeError(name) from None

    @property
    def device(self) -> torch.device:
        return self.leaves["write_pos"].device


_FP_EMPTY = 0x7FFFFFFF
# Tombstone fingerprint: the i32 min-war never overwrites it and _fp31
# never produces it, so a tombstoned key table claims nothing.
_FP_TOMB = -0x80000000
_KEY_PROBES = 3
_TAB_PROBES = 4
_SVC_MASK = 0x7FFF
_TAB_EMPTY = I64_MAX


def init_state(config: StoreConfig = StoreConfig(),
               device="cuda") -> StoreState:
    """Fresh store state on ``device`` (CUDA unless the caller passes
    ``device="cpu"``)."""
    dev = resolve_device(device)
    c = config
    S = c.max_services

    def full(shape, fill, dtype):
        return torch.full(shape if isinstance(shape, tuple) else (shape,),
                          fill, dtype=dtype, device=dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    i64, i32, f32 = torch.int64, torch.int32, torch.float32
    cap, acap, bcap = c.capacity, c.ann_capacity, c.bann_capacity
    lay = c.idx_layout
    leaves = dict(
        trace_id=full(cap, 0, i64), span_id=full(cap, 0, i64),
        parent_id=full(cap, 0, i64), name_id=full(cap, 0, i32),
        name_lc_id=full(cap, -1, i32), service_id=full(cap, -1, i32),
        ts_cs=full(cap, NO_TS, i64), ts_cr=full(cap, NO_TS, i64),
        ts_sr=full(cap, NO_TS, i64), ts_ss=full(cap, NO_TS, i64),
        ts_first=full(cap, NO_TS, i64), ts_last=full(cap, NO_TS, i64),
        duration=full(cap, NO_TS, i64), flags=full(cap, 0, i32),
        indexable=full(cap, False, torch.bool),
        row_gid=full(cap, -1, i64), write_pos=scalar(0),
        ann_gid=full(acap, -1, i64), ann_ts=full(acap, NO_TS, i64),
        ann_value_id=full(acap, -1, i32),
        ann_service_id=full(acap, -1, i32),
        ann_endpoint_id=full(acap, -1, i32), ann_write_pos=scalar(0),
        bann_gid=full(bcap, -1, i64), bann_key_id=full(bcap, -1, i32),
        bann_value_id=full(bcap, -1, i32), bann_type=full(bcap, 0, i32),
        bann_service_id=full(bcap, -1, i32),
        bann_endpoint_id=full(bcap, -1, i32), bann_write_pos=scalar(0),
        dep_moments=full((S * S, M.N_FIELDS), 0.0, f32),
        dep_banks=full((c.dep_buckets, S * S, M.N_FIELDS), 0.0, f32),
        dep_bank_ts=torch.tensor([[I64_MAX, I64_MIN]] * c.dep_buckets,
                                 dtype=i64, device=dev),
        dep_overflow_ts=torch.tensor([I64_MAX, I64_MIN], dtype=i64,
                                     device=dev),
        dep_bank_seq=scalar(0),
        dep_window=full((S * S, M.N_FIELDS), 0.0, f32),
        dep_window_ts=torch.tensor([I64_MAX, I64_MIN], dtype=i64,
                                   device=dev),
        span_tab=_p32(full(c.tab_slots, _TAB_EMPTY, i64)),
        pend_key=full(c.pending_slots, 0, i64),
        pend_dur=full(c.pending_slots, 0, i64),
        pend_tsf=full(c.pending_slots, 0, i64),
        pend_tsl=full(c.pending_slots, 0, i64),
        pend_pos=scalar(0),
        # Load-bearing init values (see the reference's init_state):
        # -1 / I64_MIN entries lose every watermark war and match no key.
        cand_idx=full((lay[2], 3), -1, i64),
        cand_pos=full(lay[1], 0, i64),
        cand_wm=full(lay[1], I64_MIN, i64),
        ann_poison=full(S, I64_MIN, i64),
        key_tab=full(c.key_slots, _FP_EMPTY, i32),
        key_wm=full(c.key_slots, I64_MIN, i64),
        svc_hist=full((S, c.quantile_buckets), 0, i32),
        svc_span_counts=full(S, 0, i32),
        ann_svc_counts=full(S, 0, i32),
        name_presence=full((S, c.max_span_names), 0, i32),
        ann_value_counts=full((S, c.max_annotation_values), 0, i32),
        bann_key_counts=full((S, c.max_binary_keys), 0, i32),
        hll_traces=full(1 << c.hll_p, 0, i32),
        cms_trace_spans=full((c.cms_depth, c.cms_width), 0, i32),
        ts_min=scalar(I64_MAX), ts_max=scalar(I64_MIN),
        win_epoch=full(c.win_slots, -1, i64),
        win_counts=full((S, c.win_slots, 3), 0, i32),
        win_sums=full((S, c.win_slots, 4), 0, i64),
        win_mm=full((S, c.win_slots, 2), I32_MIN, i32),
        counters={k: scalar(0) for k in COUNTER_NAMES},
    )
    return StoreState(c, leaves)


# -- plane views and unique scatters -----------------------------------------


def _p32(x: torch.Tensor) -> torch.Tensor:
    """int64[...] -> int32[..., 2] bit-planes (lo, hi): the plane order of
    jax.lax.bitcast_convert_type on a little-endian device."""
    x = x.contiguous()
    return x.view(torch.int32).reshape(*x.shape, 2)


def _p64(p: torch.Tensor) -> torch.Tensor:
    """int32[..., 2] bit-planes -> int64[...]."""
    p = p.contiguous()
    return p.view(torch.int64).reshape(p.shape[:-1])


def _uset(arr: torch.Tensor, idx, vals, ok) -> torch.Tensor:
    """In place ``arr[idx[ok]] = vals[ok]`` (indices unique among ok)."""
    arr[idx[ok].to(torch.int64)] = vals[ok].to(arr.dtype)
    return arr


def _uset_p(arr2: torch.Tensor, idx, vals, ok) -> torch.Tensor:
    """In place scatter of logical int64 ``vals`` into the [M, 2] int32
    plane-pair array ``arr2`` at unique ``idx`` among ok rows."""
    flat = arr2.view(torch.int64).view(-1)
    flat[idx[ok].to(torch.int64)] = vals[ok].to(torch.int64)
    return arr2


def _uset_cols64(arr: torch.Tensor, idx, vals, ok) -> torch.Tensor:
    """In place row scatter ``arr[idx[ok]] = vals[ok]`` ([M, C] int64)."""
    arr[idx[ok].to(torch.int64)] = vals[ok]
    return arr


def _war_max64(arr: torch.Tensor, idx, vals, ok) -> torch.Tensor:
    """Exact ``arr.at[idx[ok]].max(vals[ok])`` (duplicates allowed)."""
    return arr.scatter_reduce_(0, idx[ok].to(torch.int64),
                               vals[ok].to(arr.dtype), "amax")


def _war_min64(arr: torch.Tensor, idx, vals, ok) -> torch.Tensor:
    return arr.scatter_reduce_(0, idx[ok].to(torch.int64),
                               vals[ok].to(arr.dtype), "amin")


def _fp31(k48: torch.Tensor) -> torch.Tensor:
    """48-bit key -> 31-bit non-negative fingerprint (never _FP_EMPTY)."""
    f = (k48 >> 17).to(torch.int32) & 0x7FFFFFFF
    return torch.clamp(f, max=0x7FFFFFFE)


_WM_COARSE_FRAC_BITS = 8
_WM_TS_SHIFT = 20


def _coarse_gid32(gids, ok, shift: int):
    g = gids.to(torch.int64)
    v = torch.clamp((g >> shift) + 1, max=0x7FFFFFFF).to(torch.int32)
    return torch.where(ok & (g >= 0), v, torch.zeros_like(v))


def _coarse_ts32(ts, ok, shift: int):
    t = ts.to(torch.int64)
    lim = ((1 << 31) - 1) << shift
    in_dom = ok & (t >= 0) & (t < lim)
    v = ((t >> shift) + 1).to(torch.int32)
    return torch.where(in_dom, v, torch.zeros_like(v)), ok & (t >= lim)


def scatter_histogram(counts, idx):
    """``counts.view(-1)[idx] += 1`` for every row with idx in [0,
    counts.numel()), in place: the plain scatter-add (the counterpart of
    the reference's ``scatter_histogram_xla`` with its default
    weights)."""
    flat = counts.view(-1)
    idx = idx.to(torch.int64)
    sel = idx[(idx >= 0) & (idx < flat.shape[0])]
    flat.index_add_(0, sel, torch.ones(sel.shape, dtype=flat.dtype,
                                       device=flat.device))
    return counts


def _ones(n: int, dev) -> torch.Tensor:
    return torch.ones(n, dtype=torch.int32, device=dev)


def _arange(n: int, dev, dtype=torch.int64) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# Device batch (padded, fixed shape)
# ---------------------------------------------------------------------------


class DeviceBatch(NamedTuple):
    """A SpanBatch padded to static shape + host-computed index columns
    (numpy from make_device_batch; tensors after batch_to_device, with
    the three ``n_*`` counts as python ints)."""

    trace_id: object
    span_id: object
    parent_id: object
    name_id: object
    name_lc_id: object
    service_id: object
    ts_cs: object
    ts_cr: object
    ts_sr: object
    ts_ss: object
    ts_first: object
    ts_last: object
    duration: object
    flags: object
    has_parent: object
    indexable: object
    n_spans: object
    ann_span_idx: object
    ann_ts: object
    ann_value_id: object
    ann_service_id: object
    ann_endpoint_id: object
    n_anns: object
    bann_span_idx: object
    bann_key_id: object
    bann_value_id: object
    bann_type: object
    bann_service_id: object
    bann_endpoint_id: object
    n_banns: object
    error_flag: object
    span_slot: object
    span_gid: object
    reclaim_page: object


_COUNT_FIELDS = ("n_spans", "n_anns", "n_banns")


def _pad(a: np.ndarray, n: int, fill=0, dtype=None) -> np.ndarray:
    dtype = dtype or a.dtype
    out = np.full(n, fill, dtype)
    out[: len(a)] = a
    return out


def make_device_batch(batch: SpanBatch, name_lc_id: np.ndarray,
                      indexable: np.ndarray, pad_spans: int, pad_anns: int,
                      pad_banns: int, error_flag: np.ndarray = None,
                      span_slot: np.ndarray = None,
                      span_gid: np.ndarray = None,
                      reclaim_pages: np.ndarray = None,
                      pad_reclaims: int = 1) -> DeviceBatch:
    """Host: pad a SpanBatch (+ index columns) to static shapes (numpy;
    the same arrays the reference's make_device_batch builds). Paged
    stores pass the planner's ``span_slot``/``span_gid`` per span and
    the chunk's ``reclaim_pages`` (padded to ``pad_reclaims`` with -1);
    ring batches keep shape-(1,) placeholders."""
    from zipkin_tpu_torch.columnar.schema import FLAG_HAS_PARENT

    if batch.n_spans > pad_spans or batch.n_annotations > pad_anns:
        raise ValueError("batch larger than device batch padding")
    if batch.n_binary > pad_banns:
        raise ValueError("batch larger than device batch padding")
    f = batch.flags.astype(np.int32)
    return DeviceBatch(
        trace_id=_pad(batch.trace_id, pad_spans),
        span_id=_pad(batch.span_id, pad_spans),
        parent_id=_pad(batch.parent_id, pad_spans),
        name_id=_pad(batch.name_id, pad_spans),
        name_lc_id=_pad(np.asarray(name_lc_id, np.int32), pad_spans, -1),
        service_id=_pad(batch.service_id, pad_spans, -1),
        ts_cs=_pad(batch.ts_cs, pad_spans, NO_TS),
        ts_cr=_pad(batch.ts_cr, pad_spans, NO_TS),
        ts_sr=_pad(batch.ts_sr, pad_spans, NO_TS),
        ts_ss=_pad(batch.ts_ss, pad_spans, NO_TS),
        ts_first=_pad(batch.ts_first, pad_spans, NO_TS),
        ts_last=_pad(batch.ts_last, pad_spans, NO_TS),
        duration=_pad(batch.duration, pad_spans, NO_TS),
        flags=_pad(f, pad_spans),
        has_parent=_pad((f & int(FLAG_HAS_PARENT)).astype(bool), pad_spans,
                        False),
        indexable=_pad(np.asarray(indexable, bool), pad_spans, False),
        n_spans=np.int32(batch.n_spans),
        ann_span_idx=_pad(batch.ann_span_idx, pad_anns),
        ann_ts=_pad(batch.ann_ts, pad_anns, NO_TS),
        ann_value_id=_pad(batch.ann_value_id, pad_anns, -1),
        ann_service_id=_pad(batch.ann_service_id, pad_anns, -1),
        ann_endpoint_id=_pad(batch.ann_endpoint_id, pad_anns, -1),
        n_anns=np.int32(batch.n_annotations),
        bann_span_idx=_pad(batch.bann_span_idx, pad_banns),
        bann_key_id=_pad(batch.bann_key_id, pad_banns, -1),
        bann_value_id=_pad(batch.bann_value_id, pad_banns, -1),
        bann_type=_pad(batch.bann_type.astype(np.int32), pad_banns),
        bann_service_id=_pad(batch.bann_service_id, pad_banns, -1),
        bann_endpoint_id=_pad(batch.bann_endpoint_id, pad_banns, -1),
        n_banns=np.int32(batch.n_binary),
        error_flag=_pad(
            np.zeros(batch.n_spans, bool) if error_flag is None
            else np.asarray(error_flag, bool), pad_spans, False),
        span_slot=(np.zeros(1, np.int32) if span_slot is None
                   else _pad(np.asarray(span_slot, np.int32), pad_spans)),
        span_gid=(np.zeros(1, np.int64) if span_gid is None
                  else _pad(np.asarray(span_gid, np.int64), pad_spans, -1)),
        reclaim_page=(np.full(1, -1, np.int32) if reclaim_pages is None
                      else _pad(np.asarray(reclaim_pages, np.int32),
                                pad_reclaims, -1)),
    )


def stack_device_batches(dbs) -> DeviceBatch:
    """Stack equal-shape numpy DeviceBatches along a new leading axis."""
    return DeviceBatch(*(
        np.stack([np.asarray(getattr(db, f)) for db in dbs])
        for f in DeviceBatch._fields
    ))


def batch_to_device(db: DeviceBatch, device) -> DeviceBatch:
    """numpy DeviceBatch -> tensors on ``device`` (counts as ints)."""
    out = {}
    for f in DeviceBatch._fields:
        v = getattr(db, f)
        if f in _COUNT_FIELDS:
            out[f] = int(v)
        else:
            out[f] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return DeviceBatch(**out)


def stage_batches(dbs, device):
    """Stage 2 of the ingest pipeline (the reference's ``stage_batch``):
    a unit's numpy DeviceBatches -> ``(batches, buf)``, tensors on
    ``device``. On CUDA every column of every batch is packed into ONE
    pinned host buffer (8-byte columns first, so every column's offset
    stays aligned to its element size) and sent in one copy with
    ``non_blocking=True`` on the current stream; each column is a view
    of the device buffer ``buf``. One packing copy and one transfer a
    unit, not one a column: each call that releases the interpreter
    lock costs the staging thread a wait to get it back while the other
    stages run Python. The caller records an event after the copy and
    has the stream that runs the step wait on it (``await_staged``).
    Other devices take ``batch_to_device`` (``buf`` None)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return tuple(batch_to_device(db, dev) for db in dbs), None
    cols = staging_columns(dbs)
    host = torch.empty(sum(c[2].nbytes for c in cols), dtype=torch.uint8,
                       pin_memory=True)
    np.concatenate([c[2].reshape(-1).view(np.uint8) for c in cols],
                   out=host.numpy())
    buf = host.to(dev, non_blocking=True)
    return staged_views(dbs, cols, buf), buf


def staging_columns(dbs):
    """The packing order of ``stage_batches``: (batch index, field,
    array) for every array column, 8-byte columns first (a stable sort,
    so each column's byte offset is a multiple of its element size)."""
    cols = [(i, f, np.ascontiguousarray(getattr(db, f)))
            for i, db in enumerate(dbs) for f in DeviceBatch._fields
            if f not in _COUNT_FIELDS]
    cols.sort(key=lambda c: -c[2].dtype.itemsize)
    return cols


def staged_views(dbs, cols, buf: torch.Tensor):
    """The batches whose columns are views of ``buf``, the uint8 buffer
    that holds ``cols`` packed in order."""
    out = [{f: int(getattr(db, f)) for f in _COUNT_FIELDS} for db in dbs]
    off = 0
    for i, f, a in cols:
        dtype = torch.from_numpy(a[:0]).dtype
        out[i][f] = buf[off:off + a.nbytes].view(dtype).view(a.shape)
        off += a.nbytes
    return tuple(DeviceBatch(**o) for o in out)


def await_staged(buf, done, device) -> None:
    """Before a step on staged batches: the current stream of ``device``
    waits for the staging copy's event ``done`` (None: nothing to wait
    for), and the staged buffer is recorded as used on that stream, so
    the caching allocator does not hand its memory back to the staging
    stream before the step is done with it."""
    if done is None:
        return
    stream = torch.cuda.current_stream(device)
    stream.wait_event(done)
    buf.record_stream(stream)


def unstack_batches(stacked: DeviceBatch):
    """A stacked numpy DeviceBatch -> its per-step numpy batches."""
    k = np.asarray(stacked.trace_id).shape[0]
    return [DeviceBatch(*(np.asarray(getattr(stacked, f))[i]
                          for f in DeviceBatch._fields)) for i in range(k)]


# ---------------------------------------------------------------------------
# Streaming hash join
# ---------------------------------------------------------------------------


def _mix48(a, b):
    """48-bit mixed key of two int64 columns (non-negative int64)."""
    return srl(mix_keys64([a, b]), 16)


def _tab_pack(key48, svc):
    s = (torch.clamp(svc.to(torch.int64), -1, _SVC_MASK - 2) + 1)
    return (key48 << 16) | (s << 1) | 1


def _tab_slots(key48, n_slots: int):
    h0 = key48 & (n_slots - 1)
    step = ((key48 >> 20) << 1) | 1
    return [(h0 + j * step) & (n_slots - 1) for j in range(_TAB_PROBES)]


def _tab_lookup(tab, key48):
    """(found, svc) per probe key; svc is -1 when absent/serviceless."""
    found = torch.zeros(key48.shape, dtype=torch.bool, device=key48.device)
    svc = torch.full(key48.shape, -1, dtype=torch.int32,
                     device=key48.device)
    flat = tab.view(torch.int64).view(-1)
    for slot in _tab_slots(key48, tab.shape[0]):
        cur = flat[slot]
        hit = (cur != _TAB_EMPTY) & (srl(cur, 16) == key48)
        first = hit & ~found
        svc = torch.where(first, (((cur >> 1) & _SVC_MASK) - 1).to(
            torch.int32), svc)
        found |= hit
    return found, svc


def _tab_insert(tab, key48, svc, valid):
    """Insert (key48 -> svc) rows in place. Each probe round is a
    scatter-MIN war: the empty sentinel loses to every packed word and
    racing rows keep the numerically smallest word (the lowest service
    of an RPC's two halves). Rows that find every probe taken by a
    foreign key steal their last probe slot (smallest stealer wins)."""
    flat = tab.view(torch.int64).view(-1)
    packed = _tab_pack(key48, svc)
    placed = ~valid
    slots = _tab_slots(key48, tab.shape[0])
    for slot in slots:
        cur = flat[slot]
        open_ = (cur == _TAB_EMPTY) | (srl(cur, 16) == key48)
        attempt = ~placed & open_
        flat.scatter_reduce_(0, slot[attempt], packed[attempt], "amin")
        after = flat[slot]
        placed = placed | (attempt & (srl(after, 16) == key48))
    steal = ~placed
    _uset_p(tab, slots[-1], torch.full_like(packed, _TAB_EMPTY), steal)
    flat.scatter_reduce_(0, slots[-1][steal], packed[steal], "amin")
    return tab



def rebuild_span_tab(state: StoreState) -> StoreState:
    """(Re)insert every live resident span into the hash table, in
    place. Used when restoring pre-revision-4 snapshots (whose schema
    had no table), so children arriving after the restore still find
    checkpointed parents. The min-insert is order-free, so the table
    equals the reference's for every live row of the ring."""
    live = state.row_gid >= 0
    key = _mix48(state.trace_id, state.span_id)
    _tab_insert(state.span_tab, key, state.service_id, live)
    return state


def poison_index_trust(state: StoreState) -> StoreState:
    """Mark every index bucket permanently untrusted (cursor past depth,
    watermark at +inf), in place, forcing all reads through the exact
    scan kernels. Used when restoring snapshots that predate the index
    families: empty buckets with zero cursors would otherwise claim
    completeness and hide every restored span from the fast paths. New
    writes still append, but trust never returns for a poisoned bucket
    — the pre-index behaviour the snapshot was taken under."""
    state.cand_pos.fill_(1 << 60)
    state.cand_wm.fill_(I64_MAX)
    return state


def poison_ann_trust(state: StoreState) -> StoreState:
    """Trust reset, in place, for snapshots predating revision 7, which
    added both of these:

    - ``ann_poison``: any restored span might have 3+ distinct
      annotation hosts, so every service is stamped with the current
      write_pos — the annotation fast paths distrust their buckets
      until the ring has turned over, then self-heal.
    - ``key_tab``: a post-restore claim cannot certify that a key was
      never displaced before the restore, so the table is tombstoned
      (claims always fail, the bucket gates serve), ``key_wm`` pinned
      at +inf and the drop counter forced >= 1, which keeps the
      negative-lookup gate off."""
    wp = state.write_pos.to(torch.int64)
    state.ann_poison.copy_(wp.expand_as(state.ann_poison))
    state.key_tab.fill_(_FP_TOMB)
    state.key_wm.fill_(I64_MAX)
    drops = state.counters["key_claim_drops"]
    drops.copy_(torch.clamp(drops, min=1))
    return state

# ---------------------------------------------------------------------------
# Index FIFO ranks
# ---------------------------------------------------------------------------

_fifo_ranks = K.fifo_ranks
_RANK_BLOCKS = (8, 16, 32, 64)
_RANK_SCRATCH_ELEMS = 1 << 25


def rank_block_for(n_rows: int, n_buckets: int) -> int:
    for blk in _RANK_BLOCKS:
        groups = -(-n_rows // blk)
        if (n_buckets + 1) * groups <= _RANK_SCRATCH_ELEMS:
            return blk
    return 0


def rank_mode(rank_path: str, n_rows: int, n_buckets: int, wm_shift: int):
    """("argsort", 0) or ("counting", block). Both paths are bitwise the
    same; "auto" takes the sort, as the reference does off the TPU."""
    if rank_path not in ("auto", "argsort", "counting"):
        raise ValueError(f"unknown rank_path {rank_path!r}")
    if rank_path != "counting" or wm_shift == 0:
        return "argsort", 0
    blk = rank_block_for(n_rows, n_buckets)
    return ("counting", blk) if blk else ("argsort", 0)


def _fifo_ranks_counting(bucket, valid, n_buckets: int, block: int):
    """Counting twin of _fifo_ranks: per-(bucket, block) counts, an
    exclusive prefix along the blocks, and block-1 shifted compares."""
    n = bucket.shape[0]
    dev = bucket.device
    groups = -(-n // block)
    b_eff = torch.where(valid, torch.clamp(bucket.to(torch.int64), 0,
                                           n_buckets - 1),
                        torch.full((n,), n_buckets, dtype=torch.int64,
                                   device=dev))
    rows = _arange(n, dev)
    sidx = b_eff * groups + rows // block
    cnt = torch.zeros((n_buckets + 1) * groups, dtype=torch.int32,
                      device=dev).index_add_(0, sidx, _ones(n, dev))
    cnt2 = cnt.view(n_buckets + 1, groups)
    prefix = (torch.cumsum(cnt2, dim=1, dtype=torch.int32) - cnt2).reshape(-1)
    pre = prefix[sidx]
    in_block = rows & (block - 1)
    w = torch.zeros(n, dtype=torch.int32, device=dev)
    for d in range(1, min(block, n)):
        same = torch.zeros(n, dtype=torch.bool, device=dev)
        same[d:] = b_eff[d:] == b_eff[:-d]
        w += (same & (in_block >= d)).to(torch.int32)
    return pre + w


# ---------------------------------------------------------------------------
# Unified index write
# ---------------------------------------------------------------------------


def _index_write(entries, pos, wm, key_tab, key_wm, ann_poison,
                 gbucket, slot0, depth, gid, verify, ts, valid,
                 keyed_from: int, n_cand_rows: int, n_cand_buckets: int,
                 poison_bucket=None, poison_gid=None, poison_ok=None,
                 wm_shift: int = 0, ts_shift: int = _WM_TS_SHIFT,
                 rank_sel=("argsort", 0), use_kernel: bool = False):
    """ONE combined append of (gid, verify, ts) rows into the unified
    index arena, with the per-key record claims and the shared watermark
    war — ``zipkin_tpu.store.device._index_write``. Updates ``entries``,
    ``pos``, ``wm``, ``key_tab``, ``key_wm`` and ``ann_poison`` in place
    and returns the number of keyed rows whose claim found no slot."""
    dev = entries.device
    n_b = pos.shape[0]
    b_c = torch.clamp(gbucket.to(torch.int64), 0, n_b - 1)
    if use_kernel:
        # The claim kernel gives both rank paths' ranks (bitwise) and the
        # bucket counts in one call; the write below reuses them.
        bucket32 = gbucket.to(torch.int32).contiguous()
        rank, cnt = K.arena_claim(bucket32, valid.contiguous(), n_b)
    else:
        rank_kind, rank_blk = rank_sel
        if rank_kind == "counting":
            rank = _fifo_ranks_counting(gbucket, valid, n_b, rank_blk)
        else:
            rank = _fifo_ranks(gbucket, valid, n_b)
        oob_b = torch.where(valid, b_c, torch.full_like(b_c, n_b))
        cnt = torch.zeros(n_b + 1, dtype=torch.int32,
                          device=dev).index_add_(
            0, oob_b, torch.ones_like(rank))[:n_b]
    keep = valid & (rank >= cnt[b_c] - depth)
    pos_b = _p32(pos)[:, 0][b_c]
    slot = slot0.to(torch.int32) + ((pos_b + rank) % depth)
    occupied = keep & (pos_b + rank >= depth)
    gidx = torch.where(keep, slot, torch.zeros_like(slot)).to(torch.int64)
    old_rows = entries[gidx]
    cand = slice(0, n_cand_rows)
    trc = slice(n_cand_rows, None)
    old_ts_c = torch.where(occupied[cand], old_rows[cand, 2],
                           torch.full_like(old_rows[cand, 2], I64_MIN))
    sfx = slice(keyed_from, n_cand_rows)
    old_gid_s = old_rows[sfx, 0]
    old_verify_s = old_rows[sfx, 1]
    dropped_ts = torch.where(valid[cand] & ~keep[cand], ts[cand],
                             torch.full_like(ts[cand], I64_MIN))
    disp_ts = torch.maximum(old_ts_c, dropped_ts)
    tr_wmv = torch.where(occupied[trc], old_rows[trc, 0], gid[trc])
    tr_ok = occupied[trc] | (valid[trc] & ~keep[trc])
    vals = torch.stack([gid, verify, ts], dim=-1)
    if use_kernel:
        K.arena_write(entries, rank, cnt, bucket32, pos_b.contiguous(),
                      slot0.to(torch.int64).contiguous(),
                      depth.to(torch.int32).contiguous(), vals.contiguous(),
                      valid.contiguous())
    else:
        _uset_cols64(entries, slot, vals, keep)
    pos += cnt.to(torch.int64)

    # -- per-key fingerprint records (suffix rows only) ----------------
    T = key_tab.shape[0]
    v_s = valid[sfx]
    verify_s = verify[sfx]
    k48n = srl(verify_s, 16)
    fp = _fp31(k48n)
    slots3 = torch.stack(_tab_slots(k48n, T)[:_KEY_PROBES])  # [3, M]

    def claim_round(placed):
        cur = key_tab[slots3]
        already = (cur == fp[None, :]).any(0)
        empty = cur == _FP_EMPTY
        choose = torch.full(fp.shape, T, dtype=torch.int64, device=dev)
        for i in range(_KEY_PROBES - 1, -1, -1):
            choose = torch.where(empty[i], slots3[i], choose)
        attempt = v_s & ~placed & ~already & (choose < T)
        key_tab.scatter_reduce_(0, choose[attempt], fp[attempt], "amin")
        after = key_tab[torch.where(attempt, choose,
                                    torch.zeros_like(choose))]
        placed = placed | already | (attempt & (after == fp))
        return placed, attempt & ~placed

    placed, unresolved = claim_round(torch.zeros_like(v_s))
    for _ in range(_KEY_PROBES - 1):
        if not bool(unresolved.any()):
            break
        placed, unresolved = claim_round(placed)
    keep_s = keep[sfx]
    disp_ok = (keep_s & occupied[sfx]) | (v_s & ~keep_s)
    disp_key = torch.where(keep_s, old_verify_s, verify_s)
    disp_gid = torch.where(keep_s, old_gid_s, gid[sfx])
    k48d = srl(disp_key, 16)
    fpd = _fp31(k48d)
    dslots3 = torch.stack(_tab_slots(k48d, T)[:_KEY_PROBES])
    dhit = key_tab[dslots3] == fpd[None, :]
    dslot = torch.full(k48d.shape, T, dtype=torch.int64, device=dev)
    for i in range(_KEY_PROBES - 1, -1, -1):
        dslot = torch.where(dhit[i], dslots3[i], dslot)
    key_hit = disp_ok & dhit.any(0)

    # -- the shared watermark war ----------------------------------------
    valid_c = valid[cand]
    S_p = ann_poison.shape[0]
    n_scr = n_b + T + S_p + 1
    val_c, over_c = _coarse_ts32(disp_ts, valid_c, ts_shift)
    sink = torch.full_like(b_c[cand], n_scr - 1)
    parts_idx = [torch.where(valid_c, b_c[cand], sink)]
    parts_val = [val_c]
    exact_gid_wars = wm_shift == 0
    p_b = None
    if poison_bucket is not None:
        p_b = torch.clamp(poison_bucket.to(torch.int64), 0, S_p - 1)
    if not exact_gid_wars:
        parts_idx.append(torch.where(tr_ok, b_c[trc],
                                     torch.full_like(b_c[trc], n_scr - 1)))
        parts_val.append(_coarse_gid32(tr_wmv, tr_ok, wm_shift))
        parts_idx.append(torch.where(key_hit, n_b + dslot,
                                     torch.full_like(dslot, n_scr - 1)))
        parts_val.append(_coarse_gid32(disp_gid, key_hit, wm_shift))
        if p_b is not None:
            parts_idx.append(torch.where(poison_ok, n_b + T + p_b,
                                         torch.full_like(p_b, n_scr - 1)))
            parts_val.append(_coarse_gid32(poison_gid, poison_ok,
                                           wm_shift))
    scr = torch.zeros(n_scr, dtype=torch.int32, device=dev).scatter_reduce_(
        0, torch.cat(parts_idx), torch.cat(parts_val), "amax")
    scr_b = scr[:n_b].to(torch.int64)
    is_cand = _arange(n_b, dev) < n_cand_buckets
    ts_upd = torch.where(scr_b > 0, scr_b << ts_shift,
                         torch.full_like(scr_b, I64_MIN))
    if exact_gid_wars:
        wm.copy_(torch.maximum(wm, torch.where(
            is_cand, ts_upd, torch.full_like(ts_upd, I64_MIN))))
        _war_max64(wm, b_c[trc], tr_wmv, tr_ok)
        _war_max64(key_wm, dslot, disp_gid, key_hit)
        if p_b is not None:
            _war_max64(ann_poison, p_b, poison_gid, poison_ok)
    else:
        gid_upd = torch.where(scr_b > 0, scr_b << wm_shift,
                              torch.full_like(scr_b, I64_MIN))
        wm.copy_(torch.maximum(wm, torch.where(is_cand, ts_upd, gid_upd)))
        scr_k = scr[n_b:n_b + T].to(torch.int64)
        key_wm.copy_(torch.maximum(key_wm, torch.where(
            scr_k > 0, scr_k << wm_shift, torch.full_like(scr_k, I64_MIN))))
        if p_b is not None:
            scr_p = scr[n_b + T:n_b + T + S_p].to(torch.int64)
            ann_poison.copy_(torch.maximum(ann_poison, torch.where(
                scr_p > 0, scr_p << wm_shift,
                torch.full_like(scr_p, I64_MIN))))
    # Exact fallback for ts contributions past the coarse ceiling (a
    # no-op scatter when there are none).
    _war_max64(wm, b_c[cand], disp_ts, over_c)
    return (v_s & ~placed).sum().to(torch.int64)


def _span_host_range(ann_svc, ann_span_idx, valid_a, n_spans: int):
    """Per span: (min, max) service over its annotation hosts."""
    dev = ann_svc.device
    big = 1 << 30
    seg = torch.where(valid_a, ann_span_idx.to(torch.int64),
                      torch.full_like(ann_span_idx, n_spans,
                                      dtype=torch.int64))
    mn = torch.full((n_spans + 1,), big, dtype=torch.int32, device=dev)
    mn.scatter_reduce_(0, seg, torch.where(valid_a, ann_svc,
                                           torch.full_like(ann_svc, big)),
                       "amin")
    mx = torch.full((n_spans + 1,), -1, dtype=torch.int32, device=dev)
    mx.scatter_reduce_(0, seg, torch.where(valid_a, ann_svc,
                                           torch.full_like(ann_svc, -1)),
                       "amax")
    return mn[:n_spans], mx[:n_spans]


def _mixb(keys):
    return mix_keys64([k.to(torch.int64) for k in keys])


def _bucket_of(mixed, n_buckets: int):
    return mixed & (n_buckets - 1)


def _window_fold(window, window_ts, durations, link_id, ok, tsf, tsl, S):
    """Fold resolved links into the accumulating window bank."""
    bank = M.segment_moments(durations.to(torch.float32), link_id, S * S,
                             valid=ok)
    new_window = M.combine(window, bank)
    any_ok = ok.any()
    ts_f = torch.where(ok & (tsf >= 0), tsf,
                       torch.full_like(tsf, I64_MAX)).min()
    ts_l = torch.where(ok & (tsl >= 0), tsl,
                       torch.full_like(tsl, I64_MIN)).max()
    new_ts = torch.stack([torch.minimum(window_ts[0], ts_f),
                          torch.maximum(window_ts[1], ts_l)])
    return new_window, torch.where(any_ok, new_ts, window_ts)


def _resolve_links(tab, trace_id, span_id, parent_id, svc, child_svc,
                   duration, build_ok, probe_ok, S):
    """Resolve each child's parent service: the in-batch sort-join
    first, then a span-table probe. Returns (resolved, link_id, pending,
    ckey)."""
    in_batch, psvc_b = join.lookup((trace_id, span_id), build_ok, svc,
                                   (trace_id, parent_id), probe_ok)
    ckey = _mix48(trace_id, parent_id)
    in_tab, psvc_t = _tab_lookup(tab, ckey)
    found = in_batch | in_tab
    psvc = torch.where(in_batch, psvc_b, psvc_t)
    resolved = (probe_ok & found & (psvc >= 0) & (child_svc >= 0)
                & (child_svc < S) & (psvc < S) & (duration >= 0))
    link_id = torch.where(resolved, psvc * S + child_svc,
                          torch.zeros_like(psvc))
    pending = (probe_ok & ~found & (child_svc >= 0) & (child_svc < S)
               & (duration >= 0))
    return resolved, link_id, pending, ckey


def _sweep_core(state: StoreState):
    S = state.config.max_services
    u = state.pend_key
    occupied = (u & 1) == 1
    ckey = srl(u, 16)
    csvc = (((u >> 1) & _SVC_MASK) - 1).to(torch.int32)
    found, psvc = _tab_lookup(state.span_tab, ckey)
    resolved = (occupied & found & (psvc >= 0) & (psvc < S)
                & (csvc >= 0) & (csvc < S))
    link_id = torch.where(resolved, psvc * S + csvc,
                          torch.zeros_like(psvc))
    window, window_ts = _window_fold(
        state.dep_window, state.dep_window_ts, state.pend_dur, link_id,
        resolved, state.pend_tsf, state.pend_tsl, S)
    drop = occupied & found & ((psvc < 0) | (psvc >= S) | (csvc < 0)
                               | (csvc >= S))
    cleared = torch.where(resolved | drop, torch.zeros_like(u), u)
    return window, window_ts, cleared


def _bump_sweeps(state: StoreState) -> None:
    state.counters["sweeps"] = state.counters["sweeps"] + 1


def dep_sweep(state: StoreState) -> StoreState:
    """Resolve pending children against the span table (in place)."""
    window, window_ts, cleared = _sweep_core(state)
    state.leaves.update(dep_window=window, dep_window_ts=window_ts,
                        pend_key=cleared)
    _bump_sweeps(state)
    return state


def dep_close_bucket(state: StoreState) -> StoreState:
    """Sweep, then rotate the window bank into a time-tagged slot of
    ``dep_banks``; the displaced slot merges into the all-time tail. An
    empty window only sweeps. In place."""
    window, window_ts, cleared = _sweep_core(state)
    lv = state.leaves
    lv["pend_key"] = cleared
    if bool((window[:, 0] > 0).any()):
        Kb = state.config.dep_buckets
        slot = int(state.dep_bank_seq.item()) % Kb
        displaced = lv["dep_banks"][slot].clone()
        dts = lv["dep_bank_ts"][slot].clone()
        lv["dep_moments"] = M.combine(lv["dep_moments"], displaced)
        ov = lv["dep_overflow_ts"]
        lv["dep_overflow_ts"] = torch.stack([torch.minimum(ov[0], dts[0]),
                                             torch.maximum(ov[1], dts[1])])
        lv["dep_banks"][slot] = window
        lv["dep_bank_ts"][slot] = window_ts
        lv["dep_bank_seq"] = lv["dep_bank_seq"] + 1
        lv["dep_window"] = torch.zeros_like(window)
        lv["dep_window_ts"] = torch.tensor([I64_MAX, I64_MIN],
                                           dtype=torch.int64,
                                           device=window.device)
    else:
        lv["dep_window"] = window
        lv["dep_window_ts"] = window_ts
    _bump_sweeps(state)
    return state


def dep_archive_step(state: StoreState, w_new=None) -> StoreState:
    """Compatibility alias of dep_close_bucket (in place)."""
    del w_new
    return dep_close_bucket(state)


def dep_archive_auto(state: StoreState, incoming=None) -> StoreState:
    """Compatibility alias of dep_close_bucket (in place)."""
    del incoming
    return dep_close_bucket(state)


# ---------------------------------------------------------------------------
# ingest_step: one fused update per batch
# ---------------------------------------------------------------------------

_SPAN_RING_COLS = (
    "trace_id", "span_id", "parent_id", "name_id", "name_lc_id",
    "service_id", "ts_cs", "ts_cr", "ts_sr", "ts_ss", "ts_first",
    "ts_last", "duration", "flags", "indexable",
)


def ingest_step(state: StoreState, b: DeviceBatch) -> StoreState:
    """Fold one padded batch (tensors on the state's device, see
    batch_to_device) into ``state`` IN PLACE — the reference's donating
    ``ingest_step``. The host chunkers guarantee the per-batch ring
    bounds (n_spans <= capacity, n_anns <= ann_capacity, ...), so ring
    slots are unique among valid rows. On a paged store the batch
    carries the planner's slots and epoch-encoded gids (unique among
    valid rows, ``slot == gid % capacity``) and the pages it reclaims."""
    c = state.config
    lv = state.leaves
    dev = state.device
    S = c.max_services
    P = b.trace_id.shape[0]
    PA = b.ann_ts.shape[0]
    PB = b.bann_key_id.shape[0]
    n_spans, n_anns, n_banns = b.n_spans, b.n_anns, b.n_banns
    mask = _arange(P, dev) < n_spans
    mask_a = _arange(PA, dev) < n_anns
    mask_b = _arange(PB, dev) < n_banns
    wp = lv["write_pos"]
    awp = lv["ann_write_pos"]
    bwp = lv["bann_write_pos"]
    upd = {}

    # -- span ring/page writes -------------------------------------------
    if c.paged_enabled:
        # Invalidate every row of the reclaimed pages BEFORE the batch
        # writes land (in place, the order the reference's functional
        # chain fixes): a stale row_gid would keep spliced-out spans
        # visible to the ring scans. Padded reclaims (-1) give negative
        # slots that _uset drops by masking before it indexes.
        R = c.page_rows
        rp = b.reclaim_page.to(torch.int64)
        r_slots = (rp[:, None] * R + _arange(R, dev)[None, :]).reshape(-1)
        r_ok = (rp >= 0).repeat_interleave(R)
        _uset(lv["row_gid"], r_slots, torch.full_like(r_slots, -1), r_ok)
        gids = b.span_gid
        slots = b.span_slot.to(torch.int64)
    else:
        gids = wp + _arange(P, dev)
        slots = gids % c.capacity
    for col in _SPAN_RING_COLS:
        _uset(lv[col], slots, getattr(b, col), mask)
    _uset(lv["row_gid"], slots, gids, mask)
    upd["write_pos"] = wp + n_spans

    # Annotation rings stay FIFO under both layouts; a row carries its
    # span's gid (ring: write_pos + index, paged: the planner's gid).
    a_gids = awp + _arange(PA, dev)
    a_slots = a_gids % c.ann_capacity
    span_gid_of_ann = gids[b.ann_span_idx.to(torch.int64)]
    _uset(lv["ann_gid"], a_slots, span_gid_of_ann, mask_a)
    for col in ("ann_ts", "ann_value_id", "ann_service_id",
                "ann_endpoint_id"):
        _uset(lv[col], a_slots, getattr(b, col), mask_a)
    upd["ann_write_pos"] = awp + n_anns

    bb_gids = bwp + _arange(PB, dev)
    bb_slots = bb_gids % c.bann_capacity
    span_gid_of_bann = gids[b.bann_span_idx.to(torch.int64)]
    _uset(lv["bann_gid"], bb_slots, span_gid_of_bann, mask_b)
    for col in ("bann_key_id", "bann_value_id", "bann_type",
                "bann_service_id", "bann_endpoint_id"):
        _uset(lv[col], bb_slots, getattr(b, col), mask_b)
    upd["bann_write_pos"] = bwp + n_banns

    # -- streaming dependency join ---------------------------------------
    skey = _mix48(b.trace_id, b.span_id)
    tab = _tab_insert(lv["span_tab"], skey, b.service_id, mask)
    resolved, link_id, pending, ckey = _resolve_links(
        tab, b.trace_id, b.span_id, b.parent_id, b.service_id,
        b.service_id, b.duration, mask, mask & b.has_parent, S)
    upd["dep_window"], upd["dep_window_ts"] = _window_fold(
        lv["dep_window"], lv["dep_window_ts"], b.duration, link_id,
        resolved, b.ts_first, b.ts_last, S)
    Qp = lv["pend_key"].shape[0]
    prank = torch.cumsum(pending.to(torch.int64), 0) - 1
    pslot = (lv["pend_pos"] + prank) % Qp
    _uset(lv["pend_key"], pslot, _tab_pack(ckey, b.service_id), pending)
    _uset(lv["pend_dur"], pslot, b.duration, pending)
    _uset(lv["pend_tsf"], pslot, b.ts_first, pending)
    _uset(lv["pend_tsl"], pslot, b.ts_last, pending)
    upd["pend_pos"] = lv["pend_pos"] + pending.sum()

    # -- unified index write ---------------------------------------------
    n_key_drops = torch.zeros((), dtype=torch.int64, device=dev)
    if c.use_index:
        lay, _, _ = c.idx_layout
        wm_shift = max(0, c.capacity.bit_length() - 1
                       - _WM_COARSE_FRAC_BITS)
        a_host = b.ann_service_id
        a_idx_ok = mask_a & (a_host >= 0) & (a_host < S)
        gid_a = torch.where(a_idx_ok, span_gid_of_ann,
                            torch.full_like(span_gid_of_ann, -1))
        a_si = b.ann_span_idx.to(torch.int64)
        b_si = b.bann_span_idx.to(torch.int64)
        ts_a = b.ts_last[a_si]

        def seg(fam, local_bucket, gid, verify, ts, ok):
            b_base, s_base, n_b, depth = lay[fam]
            lb = torch.clamp(local_bucket.to(torch.int64), 0, n_b - 1)
            n = lb.shape[0]
            return fam, (
                (lb + b_base).to(torch.int32),
                lb * depth + s_base,
                torch.full((n,), depth, dtype=torch.int32, device=dev),
                gid.to(torch.int64), verify.to(torch.int64),
                ts.to(torch.int64), ok,
            )

        segments = [seg(StoreConfig.CAND_SVC, a_host, gid_a, a_host, ts_a,
                        a_idx_ok)]
        ann_name_lc_i = b.name_lc_id[a_si]
        nm_ok = a_idx_ok & (ann_name_lc_i >= 0)
        nm_mix = _mixb([a_host, ann_name_lc_i])
        segments.append(seg(StoreConfig.CAND_NAME,
                            _bucket_of(nm_mix, c.name_buckets), gid_a,
                            nm_mix, ts_a, nm_ok))
        hmin, hmax = _span_host_range(a_host, b.ann_span_idx, a_idx_ok, P)
        h1 = hmin[a_si]
        h2 = hmax[a_si]
        mid = a_idx_ok & (a_host != h1) & (a_host != h2)
        v_ok = (mask_a & (b.ann_value_id >= FIRST_USER_ANNOTATION_ID)
                & (b.ann_value_id < (1 << 30)))
        neg1 = torch.full_like(span_gid_of_ann, -1)
        for h, extra in ((h1, None), (h2, h2 != h1)):
            ok = v_ok & (h >= 0) & (h < S)
            if extra is not None:
                ok = ok & extra
            mix = _mixb([h, b.ann_value_id])
            segments.append(seg(StoreConfig.CAND_ANN,
                                _bucket_of(mix, c.ann_buckets),
                                torch.where(ok, span_gid_of_ann, neg1),
                                mix, ts_a, ok))
        bh1 = hmin[b_si]
        bh2 = hmax[b_si]
        bk_idx_ok = mask_b & (b.bann_key_id >= 0)
        ts_b = b.ts_last[b_si]
        no_val = torch.full((PB,), -1, dtype=torch.int32, device=dev)
        neg1b = torch.full_like(span_gid_of_bann, -1)
        for h, val, extra in ((bh1, b.bann_value_id, None),
                              (bh2, b.bann_value_id, bh2 != bh1),
                              (bh1, no_val, None),
                              (bh2, no_val, bh2 != bh1)):
            ok = bk_idx_ok & (h >= 0) & (h < S)
            if extra is not None:
                ok = ok & extra
            mix = _mixb([h, b.bann_key_id, val])
            segments.append(seg(StoreConfig.CAND_BANN,
                                _bucket_of(mix, c.bann_buckets),
                                torch.where(ok, span_gid_of_bann, neg1b),
                                mix, ts_b, ok))
        n_cand_rows = sum(p[0].shape[0] for _, p in segments)
        tmix = _mixb([b.trace_id])
        tb = _bucket_of(tmix, c.trace_buckets)
        NC = StoreConfig.N_CAND_FAMILIES
        segments.append(seg(NC + StoreConfig.TR_SPAN, tb, gids, tmix,
                            b.ts_last, mask))
        segments.append(seg(NC + StoreConfig.TR_ANN, tb[a_si], a_gids,
                            tmix[a_si], ts_a, mask_a))
        segments.append(seg(NC + StoreConfig.TR_BANN, tb[b_si], bb_gids,
                            tmix[b_si], b.ts_last[b_si], mask_b))
        cat = [torch.cat(parts) for parts in zip(*(p for _, p in segments))]
        rank_sel = rank_mode(c.rank_path, cat[0].shape[0], c.idx_layout[1],
                             wm_shift)
        n_key_drops = _index_write(
            lv["cand_idx"], lv["cand_pos"], lv["cand_wm"], lv["key_tab"],
            lv["key_wm"], lv["ann_poison"], *cat,
            keyed_from=segments[0][1][0].shape[0],
            n_cand_rows=n_cand_rows, n_cand_buckets=c.cand_layout[1],
            poison_bucket=a_host, poison_gid=span_gid_of_ann,
            poison_ok=mid, wm_shift=wm_shift, rank_sel=rank_sel,
            use_kernel=c.use_pallas)

    # -- latency histogram, counters, presence ----------------------------
    # Seven scatter-adds of weight 1 into seven distinct count arrays
    # (eight with the windowed arena's counts), made after the last site
    # in one call (one kernel launch with ``use_pallas``).
    svc_ok = (mask & (b.service_id >= 0) & (b.service_id < S)
              & (b.duration >= 0))
    bidx = Q.bucket_index(b.duration, c.quantile_buckets, c.gamma)
    g = torch.clamp(b.service_id, 0, S - 1)
    neg_p = torch.full((P,), -1, dtype=torch.int32, device=dev)
    neg_a = torch.full((PA,), -1, dtype=torch.int32, device=dev)
    hist = [(lv["svc_hist"], torch.where(
        svc_ok, g * c.quantile_buckets + bidx, neg_p))]
    svc_cnt_ok = mask & (b.service_id >= 0) & (b.service_id < S)
    hist.append((lv["svc_span_counts"],
                 torch.where(svc_cnt_ok, b.service_id, neg_p)))
    a_svc = b.ann_service_id
    a_svc_ok = mask_a & (a_svc >= 0) & (a_svc < S)
    hist.append((lv["ann_svc_counts"], torch.where(a_svc_ok, a_svc, neg_a)))
    a_si = b.ann_span_idx.to(torch.int64)
    ann_name = b.name_id[a_si]
    np_ok = (a_svc_ok & b.indexable[a_si] & (b.name_lc_id[a_si] >= 0)
             & (ann_name >= 0) & (ann_name < c.max_span_names))
    hist.append((lv["name_presence"], torch.where(
        np_ok, a_svc * c.max_span_names + ann_name, neg_a)))
    av_ok = (a_svc_ok & (b.ann_value_id >= FIRST_USER_ANNOTATION_ID)
             & (b.ann_value_id < c.max_annotation_values))
    hist.append((lv["ann_value_counts"], torch.where(
        av_ok, a_svc * c.max_annotation_values + b.ann_value_id, neg_a)))
    bk_svc = b.bann_service_id
    bk_ok = (mask_b & (bk_svc >= 0) & (bk_svc < S) & (b.bann_key_id >= 0)
             & (b.bann_key_id < c.max_binary_keys))
    hist.append((lv["bann_key_counts"], torch.where(
        bk_ok, bk_svc * c.max_binary_keys + b.bann_key_id,
        torch.full((PB,), -1, dtype=torch.int32, device=dev))))

    # -- probabilistic state -------------------------------------------
    t_hi, t_lo = dev_split64(b.trace_id)
    hll.update_(lv["hll_traces"], t_hi, t_lo, mask)
    cms_idx = cms.indices(c.cms_depth, c.cms_width, t_hi, t_lo)
    cms_flat = cms_idx + (_arange(c.cms_depth, dev) * c.cms_width)[:, None]
    cms_flat = torch.where(mask[None, :], cms_flat,
                           torch.full_like(cms_flat, -1)).reshape(-1)
    hist.append((lv["cms_trace_spans"], cms_flat))

    # -- windowed Moments-sketch arena -------------------------------------
    # (service x ring-indexed time bucket) integer cells; the host mirror
    # folds the same rows in numpy (aggregate/windows.apply_window_update)
    # and every op here is an integer add or max, so the two agree bitwise
    # in any order. In place: the epoch war advances win_epoch, the slots
    # it advanced are cleared (judged against the epochs from before the
    # war), and win_counts joins the fused scatter as its eighth site.
    if c.window_enabled:
        Wn = c.win_slots
        w_ok = svc_cnt_ok & (b.ts_first >= 0)
        zero = torch.zeros_like(b.ts_first)
        a_bkt = torch.where(w_ok, b.ts_first, zero) // c.window_us
        slot = torch.where(w_ok, a_bkt % Wn, zero)
        epoch = lv["win_epoch"]
        old_epoch = epoch.clone()
        _war_max64(epoch, slot, a_bkt, w_ok)
        stale = (epoch != old_epoch)[None, :, None]
        lv["win_counts"].masked_fill_(stale, 0)
        lv["win_sums"].masked_fill_(stale, 0)
        lv["win_mm"].masked_fill_(stale, I32_MIN)
        # Rows older than their slot's winner (late rows, the losers of an
        # in-batch ring wrap) are dropped.
        live = w_ok & (a_bkt == epoch[slot])
        cid = g.to(torch.int64) * Wn + slot
        d_ok = live & (b.duration >= 0)
        base3 = (cid * 3).to(torch.int32)
        hist.append((lv["win_counts"], torch.cat([
            torch.where(live, base3, neg_p),
            torch.where(live & b.error_flag, base3 + 1, neg_p),
            torch.where(d_ok, base3 + 2, neg_p)])))
        # The reference drops masked rows (``mode="drop"``); torch has no
        # drop mode, so they add 0 to cell 0 and offer I32_MIN to cell 0's
        # max: both no-ops.
        x = torch.where(d_ok, (bidx >> c.win_x_shift).to(torch.int64), zero)
        b4 = torch.where(d_ok, cid * 4, zero)
        lv["win_sums"].view(-1).index_add_(
            0, torch.cat([b4, b4 + 1, b4 + 2, b4 + 3]),
            torch.cat([x, x * x, x * x * x, x * x * x * x]))
        b2 = torch.where(d_ok, cid * 2, zero)
        x32 = x.to(torch.int32)
        lost = torch.full_like(x32, I32_MIN)
        lv["win_mm"].view(-1).scatter_reduce_(
            0, torch.cat([b2, b2 + 1]),
            torch.cat([torch.where(d_ok, -x32, lost),
                       torch.where(d_ok, x32, lost)]), "amax")
    if c.use_pallas:
        K.histogram_update_many([
            (counts, idx.to(torch.int32).contiguous(), None)
            for counts, idx in hist])
    else:
        for counts, idx in hist:
            scatter_histogram(counts, idx)

    # -- time range + counters -----------------------------------------
    firsts = torch.where(mask & (b.ts_first >= 0), b.ts_first,
                         torch.full_like(b.ts_first, I64_MAX))
    lasts = torch.where(mask & (b.ts_last >= 0), b.ts_last,
                        torch.full_like(b.ts_last, I64_MIN))
    upd["ts_min"] = torch.minimum(lv["ts_min"], firsts.min())
    upd["ts_max"] = torch.maximum(lv["ts_max"], lasts.max())
    ctr = lv["counters"]
    upd["counters"] = {
        **ctr,
        "spans_seen": ctr["spans_seen"] + n_spans,
        "anns_seen": ctr["anns_seen"] + n_anns,
        "banns_seen": ctr["banns_seen"] + n_banns,
        "batches": ctr["batches"] + 1,
        "key_claim_drops": ctr["key_claim_drops"] + n_key_drops,
    }
    lv.update(upd)
    return state


def ingest_steps(state: StoreState, batches) -> StoreState:
    """Chained ingest: one fused step per batch, in order (in place).
    ``batches`` is a sequence of device batches (unstack_batches +
    batch_to_device of a stacked unit)."""
    for b in batches:
        ingest_step(state, b)
    return state


# ---------------------------------------------------------------------------
# Reads
# ---------------------------------------------------------------------------


def _topk_desc(key: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest along ``dim``, equal values in
    index order — the tie rule of jax.lax.top_k."""
    vals, idx = torch.sort(key, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def _span_slot(gid, row_gid, capacity: int):
    slot = torch.clamp(gid % capacity, 0, capacity - 1)
    return slot, (gid >= 0) & (row_gid[slot] == gid)


def _topk_candidates(tid, ts, valid, k: int):
    """Top-k candidate rows by ts desc -> one stacked [3, k] int64."""
    key = torch.where(valid, ts, torch.full_like(ts, -1))
    vals, idx = _topk_desc(key, k)
    return torch.stack([tid[idx], ts[idx], (vals >= 0).to(torch.int64)])


def query_trace_ids_by_service(state: StoreState, svc_id, name_lc_id,
                               end_ts, k: int):
    """Scan fallback of getTraceIdsByName: [3, k] candidates."""
    slot, live = _span_slot(state.ann_gid, state.row_gid,
                            state.config.capacity)
    ok = live & (state.ann_service_id == svc_id) & state.indexable[slot]
    if name_lc_id >= 0:
        ok &= state.name_lc_id[slot] == name_lc_id
    ts = state.ts_last[slot]
    ok &= (ts >= 0) & (ts <= end_ts)
    return _topk_candidates(state.trace_id[slot], ts, ok, k)


def query_trace_ids_by_annotation(state: StoreState, svc_id, ann_value_id,
                                  bann_key_id, bann_value_id,
                                  bann_value_id2, end_ts, k: int):
    """Scan fallback of the annotation query: [3, k] candidates."""
    cap = state.config.capacity
    dev = state.device
    a_slot, a_live = _span_slot(state.ann_gid, state.row_gid, cap)
    hit = a_live & (state.ann_service_id == svc_id)
    per_slot = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    per_slot.scatter_reduce_(0, torch.where(hit, a_slot,
                                            torch.full_like(a_slot, cap)),
                             hit.to(torch.int32), "amax")
    per_slot = per_slot[:-1] > 0
    a_ok = (a_live & (state.ann_value_id == ann_value_id)
            & (ann_value_id >= 0) & state.indexable[a_slot]
            & per_slot[a_slot])
    a_ts = state.ts_last[a_slot]
    a_ok &= (a_ts >= 0) & (a_ts <= end_ts)
    b_slot, b_live = _span_slot(state.bann_gid, state.row_gid, cap)
    value_free = (bann_value_id < 0) and (bann_value_id2 < 0)
    bv = state.bann_value_id
    value_hit = torch.zeros_like(b_live)
    if bann_value_id >= 0:
        value_hit |= bv == bann_value_id
    if bann_value_id2 >= 0:
        value_hit |= bv == bann_value_id2
    b_ok = (b_live & (state.bann_key_id == bann_key_id)
            & (bann_key_id >= 0) & (value_hit | value_free)
            & state.indexable[b_slot] & per_slot[b_slot])
    b_ts = state.ts_last[b_slot]
    b_ok &= (b_ts >= 0) & (b_ts <= end_ts)
    tid = torch.cat([state.trace_id[a_slot], state.trace_id[b_slot]])
    return _topk_candidates(tid, torch.cat([a_ts, b_ts]),
                            torch.cat([a_ok, b_ok]), k)


def _iq_finish(entries, cnt, wm, state, extra_ok, depth: int, k: int,
               end_ts):
    cap = state.config.capacity
    gid = entries[:, 0]
    slot = torch.clamp(gid % cap, 0, cap - 1)
    live = (gid >= 0) & (state.row_gid[slot] == gid)
    ok = live & state.indexable[slot] & extra_ok
    ts = state.ts_last[slot]
    ok &= (ts >= 0) & (ts <= end_ts)
    mat = _topk_candidates(state.trace_id[slot], ts, ok, k)
    return mat, cnt <= depth, wm


def _key_lookup_wm(key_tab, key_wm, mixed):
    T = key_tab.shape[0]
    k48 = srl(mixed, 16)
    fp = _fp31(k48)
    found = torch.zeros(k48.shape, dtype=torch.bool, device=k48.device)
    wmv = torch.full(k48.shape, I64_MIN, dtype=torch.int64,
                     device=k48.device)
    for slot in _tab_slots(k48, T)[:_KEY_PROBES]:
        hit = key_tab[slot] == fp
        wmv = torch.where(hit & ~found, key_wm[slot], wmv)
        found |= hit
    return found, wmv


def _scalar(v, dev, dtype=torch.int64):
    return torch.tensor(v, dtype=dtype, device=dev)


def _bucket_rows(state, s_base: int, lb, depth: int):
    start = s_base + lb * depth
    return state.cand_idx[start:start + depth]


def _iq_verify(state, layout, k: int, key_parts_list, end_ts, poison: bool):
    """Verify-word bucket probe over one or two keys of one family."""
    dev = state.device
    b_base, s_base, n_b, depth = layout
    cap = state.config.capacity
    horizon = state.write_pos - cap
    rows, cnts, wms, vers, kfs, kws = [], [], [], [], [], []
    for parts in key_parts_list:
        mixed = _mixb([_scalar(p, dev) for p in parts])
        lb = int(_bucket_of(mixed, n_b).item())
        rows.append(_bucket_rows(state, s_base, lb, depth))
        cnts.append(state.cand_pos[b_base + lb])
        wms.append(state.cand_wm[b_base + lb])
        vers.append(mixed)
        kf, kw = _key_lookup_wm(state.key_tab, state.key_wm, mixed)
        kfs.append(kf)
        kws.append(kw)
    row = torch.cat(rows)
    cnt = torch.stack(cnts).max()
    bwm = torch.stack(wms).max()
    kf_all = torch.stack(kfs).all()
    kf_none = ~torch.stack(kfs).any()
    kw_ok = (torch.stack(kws) < horizon).all()
    drops = state.counters["key_claim_drops"]
    key_complete = (kf_all & kw_ok) | (kf_none & (drops == 0))
    if poison:
        svc = min(max(int(key_parts_list[0][0]), 0),
                  state.ann_poison.shape[0] - 1)
        bad = state.ann_poison[svc] >= horizon
        cnt = torch.where(bad, _scalar(depth + 1, dev), cnt)
        bwm = torch.where(bad, _scalar(I64_MAX, dev), bwm)
        key_complete = key_complete & ~bad
    ver_ok = torch.zeros(row.shape[0], dtype=torch.bool, device=dev)
    for v in vers:
        ver_ok |= row[:, 1] == v
    mat, complete, out_wm = _iq_finish(row, cnt, bwm, state, ver_ok, depth,
                                       k, end_ts)
    return mat, complete | key_complete, out_wm


def _iq_service(state, layout, k: int, svc: int, end_ts):
    b_base, s_base, n_b, depth = layout
    svc_i = min(max(int(svc), 0), n_b - 1)
    row = _bucket_rows(state, s_base, svc_i, depth)
    ok = torch.ones(depth, dtype=torch.bool, device=state.device)
    gb = b_base + svc_i
    return _iq_finish(row, state.cand_pos[gb], state.cand_wm[gb], state,
                      ok, depth, k, end_ts)


def iquery_trace_ids_by_service(state: StoreState, svc_id, name_lc_id,
                                end_ts, k: int):
    """Index fast path for getTraceIdsByName: (candidates [3, k],
    complete, watermark)."""
    lay, _, _ = state.config.cand_layout
    if name_lc_id is not None and name_lc_id >= 0:
        fam = lay[StoreConfig.CAND_NAME]
        return _iq_verify(state, fam, min(k, fam[3]),
                          [(svc_id, name_lc_id)], end_ts, False)
    fam = lay[StoreConfig.CAND_SVC]
    return _iq_service(state, fam, min(k, fam[3]), svc_id, end_ts)


def iquery_trace_ids_by_annotation(state: StoreState, svc_id, ann_value_id,
                                   bann_key_id, bann_value_id,
                                   bann_value_id2, end_ts, k: int):
    """Index fast path for the annotation query; same contract."""
    lay, _, _ = state.config.cand_layout
    if ann_value_id is not None and ann_value_id >= 0:
        fam = lay[StoreConfig.CAND_ANN]
        return _iq_verify(state, fam, min(k, fam[3]),
                          [(svc_id, ann_value_id)], end_ts, True)
    if bann_value_id is None or bann_value_id < 0:
        bann_value_id = -1
    if bann_value_id2 is None or bann_value_id2 < 0:
        bann_value_id2 = -1
    if bann_value_id < 0 and bann_value_id2 >= 0:
        bann_value_id = bann_value_id2
    if bann_value_id >= 0 and bann_value_id2 < 0:
        bann_value_id2 = bann_value_id
    fam = lay[StoreConfig.CAND_BANN]
    if bann_value_id < 0:
        return _iq_verify(state, fam, min(k, fam[3]),
                          [(svc_id, bann_key_id, -1)], end_ts, True)
    return _iq_verify(state, fam, min(k, 2 * fam[3]),
                      [(svc_id, bann_key_id, bann_value_id),
                       (svc_id, bann_key_id, bann_value_id2)], end_ts, True)


def iquery_trace_ids_multi(state: StoreState, probes, k: int):
    """N independent index-bucket probes in one pass. ``probes`` is a
    dict of equal-length numpy arrays (see the store's
    build_probe_arrays). Returns ([N, 3, k], [N] complete, [N] wm)."""
    c = state.config
    dev = state.device
    cap = c.capacity
    k_max = max(fam[3] for fam in c.cand_layout[0])
    k = min(k, k_max)

    def t(name, dtype):
        return torch.from_numpy(np.asarray(probes[name])).to(
            device=dev, dtype=dtype)

    i64 = torch.int64
    b_base, s_base, n_b, depth = (t(n, i64) for n in
                                  ("b_base", "s_base", "n_b", "depth"))
    key1, key2, key3 = (t(n, i64) for n in ("key1", "key2", "key3"))
    three, is_svc, poison_on = (t(n, torch.bool) for n in
                                ("three", "is_svc", "poison_on"))
    end_ts = t("end_ts", i64)
    mixed = torch.where(three, _mixb([key1, key2, key3]),
                        _mixb([key1, key2]))
    lb = torch.where(is_svc, torch.minimum(torch.clamp(key1, min=0),
                                           n_b - 1),
                     mixed & (n_b - 1))
    gb = b_base + lb
    slot0 = s_base + lb * depth
    rows = _arange(k_max, dev)[None, :]
    valid_row = rows < depth[:, None]
    n_ent = state.cand_idx.shape[0]
    idx = torch.where(valid_row, slot0[:, None] + rows,
                      torch.full_like(rows, n_ent))
    eg = state.cand_idx[torch.clamp(idx, 0, n_ent - 1)]
    exp_ver = torch.where(is_svc, key1, mixed)
    ver_ok = valid_row & (eg[:, :, 1] == exp_ver[:, None])
    gid = eg[:, :, 0]
    slot = torch.clamp(gid % cap, 0, cap - 1)
    live = (gid >= 0) & (state.row_gid[slot] == gid)
    ok = live & state.indexable[slot] & ver_ok
    ts = state.ts_last[slot]
    ok &= (ts >= 0) & (ts <= end_ts[:, None])
    key = torch.where(ok, ts, torch.full_like(ts, -1))
    vals, sel = _topk_desc(key, k, dim=1)
    tid = torch.gather(state.trace_id[slot], 1, sel)
    tsk = torch.gather(ts, 1, sel)
    mat = torch.stack([tid, tsk, (vals >= 0).to(i64)], dim=1)
    n_pos = state.cand_pos.shape[0]
    cnt = state.cand_pos[torch.clamp(gb, 0, n_pos - 1)]
    wmv = state.cand_wm[torch.clamp(gb, 0, n_pos - 1)]
    horizon = state.write_pos - cap
    S_p = state.ann_poison.shape[0]
    bad = poison_on & (state.ann_poison[torch.clamp(key1, 0, S_p - 1)]
                       >= horizon)
    cnt = torch.where(bad, depth + 1, cnt)
    wmv = torch.where(bad, torch.full_like(wmv, I64_MAX), wmv)
    kfound, kwmv = _key_lookup_wm(state.key_tab, state.key_wm, mixed)
    drops = state.counters["key_claim_drops"]
    key_complete = ~is_svc & ~bad & ((kfound & (kwmv < horizon))
                                     | (~kfound & (drops == 0)))
    return mat, (cnt <= depth) | key_complete, wmv


def _trace_bucket_gids(state, layout, lb):
    b_base, s_base, _, depth = layout
    rows = s_base + lb[:, None] * depth + _arange(depth, state.device)[None]
    gid = state.cand_idx[rows.reshape(-1), 0].reshape(lb.shape[0], depth)
    return gid, b_base + lb


def iquery_durations(state: StoreState, sorted_qids):
    """Trace-membership fast path of getTracesDuration / tracesExist:
    (mat [4, nq], exact)."""
    c = state.config
    cap = c.capacity
    q = _as_i64(sorted_qids, state.device)
    lay = c.trace_layout[0][StoreConfig.TR_SPAN]
    lb = _bucket_of(_mixb([q]), lay[2])
    gid, qb = _trace_bucket_gids(state, lay, lb)
    slot = torch.clamp(gid % cap, 0, cap - 1)
    live = (gid >= 0) & (state.row_gid[slot] == gid)
    match = live & (state.trace_id[slot] == q[:, None])
    tf = state.ts_first[slot]
    tl = state.ts_last[slot]
    has_ts = match & (tf >= 0)
    firsts = torch.where(has_ts, tf, torch.full_like(tf, I64_MAX)).min(1)[0]
    lasts = torch.where(match & (tl >= 0), tl,
                        torch.full_like(tl, I64_MIN)).max(1)[0]
    gate = ((state.cand_pos[qb] <= lay[3])
            | (state.cand_wm[qb] < state.write_pos - cap))
    mat = torch.stack([match.any(1).to(torch.int64),
                       has_ts.any(1).to(torch.int64), firsts, lasts])
    return mat, gate.all()


def _as_i64(x, dev):
    return torch.as_tensor(np.asarray(x, np.int64)).to(dev)


SPAN_MAT_COLS = (
    "trace_id", "span_id", "parent_id", "name_id", "service_id",
    "ts_cs", "ts_cr", "ts_sr", "ts_ss", "ts_first", "ts_last",
    "duration", "flags", "row_gid",
)
ANN_MAT_COLS = ("ann_gid", "ann_ts", "ann_value_id", "ann_service_id",
                "ann_endpoint_id")
BANN_MAT_COLS = ("bann_gid", "bann_key_id", "bann_value_id", "bann_type",
                 "bann_service_id", "bann_endpoint_id")


def _mat(state, cols, sel):
    return torch.stack([getattr(state, c)[sel].to(torch.int64)
                        for c in cols])


def iquery_gather_trace_rows(state: StoreState, sorted_qids, k_spans: int,
                             k_anns: int, k_banns: int):
    """Trace-membership fast path of whole-trace reads: (counts [3],
    span_mat, ann_mat, bann_mat, exact)."""
    c = state.config
    cap = c.capacity
    dev = state.device
    q = _as_i64(sorted_qids, dev)
    tlay = c.trace_layout[0]
    lay_s = tlay[StoreConfig.TR_SPAN]
    lb = _bucket_of(_mixb([q]), lay_s[2])

    def family(layout, ring_wp, ring_cap):
        gid, qb = _trace_bucket_gids(state, layout, lb)
        gate = ((state.cand_pos[qb] <= layout[3])
                | (state.cand_wm[qb] < ring_wp - ring_cap))
        return gid, gate.all()

    s_gid, gate_s = family(lay_s, state.write_pos, cap)
    s_slot = torch.clamp(s_gid % cap, 0, cap - 1)
    s_ok = ((s_gid >= 0) & (state.row_gid[s_slot] == s_gid)
            & (state.trace_id[s_slot] == q[:, None]))
    key_s = torch.where(s_ok, I64_MAX - s_gid,
                        torch.full_like(s_gid, -1)).reshape(-1)
    vals_s, sel_s = _topk_desc(key_s, min(k_spans, key_s.shape[0]))
    span_mat = _mat(state, SPAN_MAT_COLS, s_slot.reshape(-1)[sel_s])
    span_mat = torch.where((vals_s >= 0)[None], span_mat,
                           torch.full_like(span_mat, -1))
    span_mat = _pad_cols(span_mat, k_spans)

    def ragged(layout, ring_wp, ring_cap, owner_col, cols, k):
        gid, gate = family(layout, ring_wp, ring_cap)
        slot = torch.clamp(gid % ring_cap, 0, ring_cap - 1)
        fresh = (gid >= 0) & (gid >= ring_wp - ring_cap)
        owner = owner_col[slot]
        oslot = torch.clamp(owner % cap, 0, cap - 1)
        ok = (fresh & (owner >= 0) & (state.row_gid[oslot] == owner)
              & (state.trace_id[oslot] == q[:, None]))
        key = torch.where(ok, I64_MAX - gid,
                          torch.full_like(gid, -1)).reshape(-1)
        vals, sel = _topk_desc(key, min(k, key.shape[0]))
        mat = _mat(state, cols, slot.reshape(-1)[sel])
        mat = torch.where((vals >= 0)[None], mat, torch.full_like(mat, -1))
        return ok.sum(), _pad_cols(mat, k), gate

    count_a, ann_mat, gate_a = ragged(
        tlay[StoreConfig.TR_ANN], state.ann_write_pos, c.ann_capacity,
        state.ann_gid, ANN_MAT_COLS, k_anns)
    count_b, bann_mat, gate_b = ragged(
        tlay[StoreConfig.TR_BANN], state.bann_write_pos, c.bann_capacity,
        state.bann_gid, BANN_MAT_COLS, k_banns)
    counts = torch.stack([s_ok.sum(), count_a, count_b])
    return counts, span_mat, ann_mat, bann_mat, gate_s & gate_a & gate_b


def _pad_cols(mat, k: int):
    """Pad a [C, n] matrix with -1 columns up to k (n < k only when the
    candidate window is narrower than the requested cap)."""
    if mat.shape[1] >= k:
        return mat
    pad = torch.full((mat.shape[0], k - mat.shape[1]), -1,
                     dtype=mat.dtype, device=mat.device)
    return torch.cat([mat, pad], dim=1)


def query_durations(state: StoreState, sorted_qids):
    """Per queried trace id one stacked [4, nq] int64: (present, found,
    min first_ts, max last_ts) — the full-ring scan."""
    dev = state.device
    q = _as_i64(sorted_qids, dev)
    nq = q.shape[0]
    live = state.row_gid >= 0
    pos = torch.clamp(torch.searchsorted(q, state.trace_id), 0, nq - 1)
    match = live & (q[pos] == state.trace_id)
    seg = torch.where(match, pos, torch.full_like(pos, nq))
    has_ts = match & (state.ts_first >= 0)
    min_first = _war_min64(torch.full((nq + 1,), I64_MAX, dtype=torch.int64,
                                      device=dev), seg, state.ts_first,
                           has_ts)[:nq]
    max_last = _war_max64(torch.full((nq + 1,), I64_MIN, dtype=torch.int64,
                                     device=dev), seg, state.ts_last,
                          has_ts)[:nq]
    found = torch.zeros(nq + 1, dtype=torch.int64, device=dev)
    found.scatter_reduce_(0, seg, has_ts.to(torch.int64), "amax")
    present = torch.zeros(nq + 1, dtype=torch.int64, device=dev)
    present.scatter_reduce_(0, seg, match.to(torch.int64), "amax")
    return torch.stack([present[:nq], found[:nq], min_first, max_last])


def _oldest_k(mask, wp, cap: int, k: int):
    dev = mask.device
    head = wp % cap
    age = (_arange(cap, dev) - head) % cap
    key = torch.where(mask, cap - age, torch.zeros_like(age))
    return _topk_desc(key, k)[1]


def _span_in(state: StoreState, q):
    """Per span slot: live and carrying one of the sorted ids ``q``."""
    nq = q.shape[0]
    pos = torch.clamp(torch.searchsorted(q, state.trace_id), 0, nq - 1)
    return (state.row_gid >= 0) & (q[pos] == state.trace_id)


def _side_rows(state: StoreState, span_in, k_anns: int, k_banns: int):
    """The annotation and binary rows of the ``span_in`` spans, oldest
    first by ring age (their insertion order under both layouts):
    (ann count, ann_mat, bann count, bann_mat)."""
    c = state.config
    a_slot, a_live = _span_slot(state.ann_gid, state.row_gid, c.capacity)
    ann_in = a_live & span_in[a_slot]
    b_slot, b_live = _span_slot(state.bann_gid, state.row_gid, c.capacity)
    bann_in = b_live & span_in[b_slot]
    a_sel = _oldest_k(ann_in, state.ann_write_pos, c.ann_capacity, k_anns)
    ann_mat = _mat(state, ANN_MAT_COLS, a_sel)
    ann_mat = torch.where(ann_in[a_sel][None], ann_mat,
                          torch.full_like(ann_mat, -1))
    b_sel = _oldest_k(bann_in, state.bann_write_pos, c.bann_capacity,
                      k_banns)
    bann_mat = _mat(state, BANN_MAT_COLS, b_sel)
    bann_mat = torch.where(bann_in[b_sel][None], bann_mat,
                           torch.full_like(bann_mat, -1))
    return ann_in.sum(), ann_mat, bann_in.sum(), bann_mat


def gather_trace_rows(state: StoreState, sorted_qids, k_spans: int,
                      k_anns: int, k_banns: int):
    """Full-ring gather of every row of ``sorted_qids``, compacted in
    insertion order: (counts [3], span_mat, ann_mat, bann_mat). On a
    paged store span rows order by gid (slot position is a page
    assignment, not an arrival rank); the columns past the match count
    are then left unmasked, as in the reference."""
    c = state.config
    q = _as_i64(sorted_qids, state.device)
    span_in = _span_in(state, q)
    if c.paged_enabled:
        skey = torch.where(span_in, I64_MAX - state.row_gid,
                           torch.full_like(state.row_gid, -1))
        sel = _topk_desc(skey, k_spans)[1]
    else:
        sel = _oldest_k(span_in, state.write_pos, c.capacity, k_spans)
    span_mat = _mat(state, SPAN_MAT_COLS, sel)
    n_a, ann_mat, n_b, bann_mat = _side_rows(state, span_in, k_anns,
                                             k_banns)
    counts = torch.stack([span_in.sum(), n_a, n_b])
    return counts, span_mat, ann_mat, bann_mat


def capture_eviction_rows(state: StoreState, lo: int, hi: int,
                          k_spans: int, k_anns: int, k_banns: int):
    """Eviction capture: every ring row (span, annotation, binary) whose
    SPAN gid lies in [lo, hi), compacted to the front in insertion order:
    (counts [3], span_mat, ann_mat, bann_mat), the matrices of
    ``gather_trace_rows``, so the host decode is shared. A pure read: no
    leaf changes, and every output is a fresh tensor (a gather, a stack
    or a where), never a view of the state, so later in-place steps
    cannot reach what the sealer copies out. On a paged store span rows
    order by gid (their insertion order; slot position is a page
    assignment). The annotation and binary tails past their counts are
    -1; the span tail is whatever the sort put there, as in the
    reference (callers read the first ``counts[0]`` columns).

    The caller pulls BEFORE any of the three rings can overwrite a row
    of the window (``TorchSpanStore._maybe_capture`` tracks all three
    write cursors), so every captured span is complete."""
    c = state.config
    span_in = (state.row_gid >= lo) & (state.row_gid < hi)
    ann_in = (state.ann_gid >= lo) & (state.ann_gid < hi)
    bann_in = (state.bann_gid >= lo) & (state.bann_gid < hi)
    if c.paged_enabled:
        skey = torch.where(span_in, I64_MAX - state.row_gid,
                           torch.full_like(state.row_gid, -1))
        sel = _topk_desc(skey, k_spans)[1]
    else:
        sel = _oldest_k(span_in, state.write_pos, c.capacity, k_spans)
    span_mat = _mat(state, SPAN_MAT_COLS, sel)
    a_sel = _oldest_k(ann_in, state.ann_write_pos, c.ann_capacity, k_anns)
    ann_mat = _mat(state, ANN_MAT_COLS, a_sel)
    ann_mat = torch.where(ann_in[a_sel][None], ann_mat,
                          torch.full_like(ann_mat, -1))
    b_sel = _oldest_k(bann_in, state.bann_write_pos, c.bann_capacity,
                      k_banns)
    bann_mat = _mat(state, BANN_MAT_COLS, b_sel)
    bann_mat = torch.where(bann_in[b_sel][None], bann_mat,
                           torch.full_like(bann_mat, -1))
    counts = torch.stack([span_in.sum(), ann_in.sum(), bann_in.sum()])
    return counts, span_mat, ann_mat, bann_mat


def gather_paged_trace_rows(state: StoreState, sorted_qids, pages, epochs,
                            k_spans: int, k_anns: int, k_banns: int):
    """Paged twin of gather_trace_rows: span rows come from the page
    list ``pages`` [K] (-1 holes) with their ``epochs`` [K], annotation
    rows from the ring scan; same four-array contract. The expected gid
    of slot (page p, offset j) is ``epoch * capacity + p * R + j``; a
    gathered row counts only when its row_gid equals it and its trace
    id is queried (small traces share pages). Dead rows are masked to
    -1, so which page gather ran (the kernel with ``use_pallas``, its
    plain twin otherwise) never shows through."""
    c = state.config
    dev = state.device
    q = _as_i64(sorted_qids, dev)
    pages = torch.as_tensor(np.asarray(pages, np.int32)).to(dev)
    epochs = torch.as_tensor(np.asarray(epochs, np.int64)).to(dev)
    R = c.page_rows
    cap = c.capacity
    pg = torch.clamp(pages.to(torch.int64), 0, c.n_pages - 1)
    page_slots = pg[:, None] * R + _arange(R, dev)[None, :]
    expected = torch.where(pages[:, None] >= 0,
                           epochs[:, None] * cap + page_slots,
                           torch.full_like(page_slots, -1)).reshape(-1)
    gather = K.paged_page_gather if c.use_pallas else \
        K.paged_page_gather_plain
    rows = gather([getattr(state, col) for col in SPAN_MAT_COLS], pages, R)
    g_tid = rows[0]
    nq = q.shape[0]
    g_pos = torch.clamp(torch.searchsorted(q, g_tid), 0, nq - 1)
    ok = (expected >= 0) & (rows[-1] == expected) & (q[g_pos] == g_tid)
    skey = torch.where(ok, I64_MAX - expected, torch.full_like(expected, -1))
    _, sel = _topk_desc(skey, min(k_spans, skey.shape[0]))
    span_mat = torch.where(ok[sel][None], rows[:, sel],
                           torch.full_like(rows[:, sel], -1))
    span_mat = _pad_cols(span_mat, k_spans)
    n_a, ann_mat, n_b, bann_mat = _side_rows(state, _span_in(state, q),
                                             k_anns, k_banns)
    counts = torch.stack([ok.sum(), n_a, n_b])
    return counts, span_mat, ann_mat, bann_mat


def svc_scan_catalog(state: StoreState, svc_id: int):
    """Ring-scan catalog rows for one dictionary-overflow service:
    (span-name presence, duration histogram, annotation-value counts,
    binary-key counts), each an int32 row."""
    c = state.config
    dev = state.device

    def hadd(n, idx, ok):
        out = torch.zeros(n, dtype=torch.int32, device=dev)
        return scatter_histogram(
            out, torch.where(ok, idx, torch.full_like(idx, -1)))

    m_sp = ((state.row_gid >= 0) & (state.service_id == svc_id)
            & (state.duration >= 0))
    bidx = Q.bucket_index(state.duration, c.quantile_buckets, c.gamma)
    dur_row = hadd(c.quantile_buckets, bidx, m_sp)
    m_a = (state.ann_gid >= 0) & (state.ann_service_id == svc_id)
    slot, live = _span_slot(state.ann_gid, state.row_gid, c.capacity)
    nm = state.name_id[slot]
    nm_ok = (m_a & live & state.indexable[slot]
             & (state.name_lc_id[slot] >= 0) & (nm >= 0)
             & (nm < c.max_span_names))
    name_row = hadd(c.max_span_names, nm, nm_ok)
    av = state.ann_value_id
    av_ok = (m_a & (av >= FIRST_USER_ANNOTATION_ID)
             & (av < c.max_annotation_values))
    ann_row = hadd(c.max_annotation_values, av, av_ok)
    bk = state.bann_key_id
    bk_ok = ((state.bann_gid >= 0) & (state.bann_service_id == svc_id)
             & (bk >= 0) & (bk < c.max_binary_keys))
    bkey_row = hadd(c.max_binary_keys, bk, bk_ok)
    return name_row, dur_row, ann_row, bkey_row


def overflow_service_presence(state: StoreState, n_over: int):
    """Which dictionary-overflow service ids (>= max_services) host a
    ring-resident annotation or binary annotation: bool [n_over]."""
    base = state.config.max_services
    pres = torch.zeros(n_over, dtype=torch.int32, device=state.device)
    for gid, svc in ((state.ann_gid, state.ann_service_id),
                     (state.bann_gid, state.bann_service_id)):
        ok = (gid >= 0) & (svc >= base)
        scatter_histogram(
            pres, torch.where(ok, svc - base, torch.full_like(svc, -1)))
    return pres > 0


COUNTER_BLOCK_FIELDS = (
    "write_pos", "ann_write_pos", "bann_write_pos", "pend_pos",
    "dep_bank_seq", "ring_occupancy", "ring_laps", "ann_ring_occupancy",
    "bann_ring_occupancy", "pend_depth", "poisoned_services",
    "spans_seen", "anns_seen", "banns_seen", "batches",
    "key_claim_drops", "sweeps", "ts_min", "ts_max",
)


def counter_block(state: StoreState) -> torch.Tensor:
    """[len(COUNTER_BLOCK_FIELDS)] int64 — one read of every counter."""
    c = state.config
    wp = state.write_pos
    poisoned = ((state.ann_poison >= wp - c.capacity)
                & (state.ann_poison > I64_MIN)).sum()
    vals = {
        "write_pos": wp,
        "ann_write_pos": state.ann_write_pos,
        "bann_write_pos": state.bann_write_pos,
        "pend_pos": state.pend_pos,
        "dep_bank_seq": state.dep_bank_seq,
        "ring_occupancy": torch.clamp(wp, max=c.capacity),
        "ring_laps": wp // c.capacity,
        "ann_ring_occupancy": torch.clamp(state.ann_write_pos,
                                          max=c.ann_capacity),
        "bann_ring_occupancy": torch.clamp(state.bann_write_pos,
                                           max=c.bann_capacity),
        "pend_depth": torch.clamp(state.pend_pos, max=c.pending_slots),
        "poisoned_services": poisoned,
        "ts_min": state.ts_min,
        "ts_max": state.ts_max,
        **{k: state.counters[k] for k in (
            "spans_seen", "anns_seen", "banns_seen", "batches",
            "key_claim_drops", "sweeps")},
    }
    return torch.stack([vals[f].to(torch.int64).reshape(())
                        for f in COUNTER_BLOCK_FIELDS])


def total_dep_moments(state: StoreState) -> torch.Tensor:
    """Tail + time-tagged banks + accumulating window."""
    banks = M.reduce_moments(state.dep_banks)
    return M.combine(M.combine(state.dep_moments, banks), state.dep_window)


def dep_moments_in_range(state: StoreState, start_ts: int, end_ts: int):
    """Link moments of the banks (and the open window) whose children's
    ts range overlaps [start_ts, end_ts] (bucket-granular)."""
    bts = state.dep_bank_ts
    sel = (bts[:, 0] <= end_ts) & (bts[:, 1] >= start_ts)
    banks = torch.where(sel[:, None, None], state.dep_banks,
                        torch.zeros_like(state.dep_banks))
    total = M.reduce_moments(banks)
    ov = state.dep_overflow_ts
    ov_ok = (ov[0] <= end_ts) & (ov[1] >= start_ts)
    total = M.combine(total, torch.where(ov_ok, state.dep_moments,
                                         torch.zeros_like(total)))
    wts = state.dep_window_ts
    w_ok = (wts[0] <= end_ts) & (wts[1] >= start_ts)
    return M.combine(total, torch.where(w_ok, state.dep_window,
                                        torch.zeros_like(total)))


def compact_bank(bank: torch.Tensor, k: int):
    """(n_nonzero, row ids [k], rows [k, 5]) — the k densest link cells
    of a [S*S, 5] bank; the caller falls back to the full bank when
    n_nonzero > k."""
    counts = bank[:, 0]
    nz = (counts > 0).sum()
    idx = _topk_desc(counts, k)[1]
    return nz, idx, bank[idx]
