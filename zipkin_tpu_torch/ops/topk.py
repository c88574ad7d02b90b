"""Top-k heavy hitters over dictionary-encoded (bounded) key domains,
torch side.

Exact counting into a fixed counter array, as ``zipkin_tpu.ops.topk``:
update is one scatter-add (one flat histogram, so one launch of the
hand-written kernel on the card, for int32 counters), merge is ``+``,
and top-k is one stable descending sort. For unbounded keys,
``topk_from_cms`` ranks candidate keys by their count-min estimates.

``topk_desc`` is the port's one tie rule, the store's reads use it too:
equal values come out in index order, lowest first, as
``jax.lax.top_k`` gives them (``torch.topk`` promises no order on ties).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from zipkin_tpu_torch.ops import cms
from zipkin_tpu_torch.ops import kernels as K


def topk_desc(key: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest along ``dim``, equal values in
    index order — the tie rule of jax.lax.top_k."""
    vals, idx = torch.sort(key, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


class Counters(NamedTuple):
    counts: torch.Tensor  # [capacity]

    @property
    def capacity(self) -> int:
        return self.counts.shape[0]


def init(capacity: int, dtype=torch.float32, device="cuda") -> Counters:
    return Counters(torch.zeros(capacity, dtype=dtype, device=device))


def update(state: Counters, ids, weights=None, valid=None) -> Counters:
    """Add ``weights`` (default 1) at each id; ids outside capacity and
    invalid rows are dropped (routed to a scratch slot)."""
    counts = state.counts
    dev = counts.device
    ids = torch.as_tensor(ids, device=dev).to(torch.int64)
    ok = (ids >= 0) & (ids < state.capacity)
    if valid is not None:
        ok = ok & torch.as_tensor(valid, device=dev).to(torch.bool)
    idx = torch.where(ok, ids, torch.full_like(ids, state.capacity))
    padded = torch.cat([counts, counts.new_zeros(1)])
    if weights is not None:
        weights = torch.as_tensor(weights, device=dev)
    if counts.dtype == torch.int32 and (
            weights is None or weights.dtype == torch.int32):
        K.histogram_update(padded, idx.to(torch.int32), weights)
    else:
        w = (torch.ones(ids.shape, dtype=counts.dtype, device=dev)
             if weights is None else weights.to(counts.dtype))
        padded.index_add_(0, idx, w)
    return Counters(padded[:-1])


def merge(a: Counters, b: Counters) -> Counters:
    return Counters(a.counts + b.counts)


def top_k(state: Counters, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts, ids) of the k largest counters, ties lowest id first."""
    return topk_desc(state.counts, min(k, state.capacity))


def topk_from_cms(sketch: cms.CountMin, cand_hi, cand_lo,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimated counts + positions of the top-k among candidate keys."""
    est = cms.query(sketch, cand_hi, cand_lo)
    return topk_desc(est, min(k, int(est.shape[0])))
