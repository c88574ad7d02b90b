"""Count-min sketch over 64-bit keys (as (hi, lo) uint32 words), torch side.

Point-queryable frequency counts for unbounded key domains. Never
under-estimates; over-estimation is bounded by ``e * total / width`` a
row, minimised over ``depth`` rows. The state is a plain ``[depth,
width]`` count array and ``merge`` is ``+``, as in
``zipkin_tpu.ops.cms``. Width must be a power of two (the index is a
mask). ``indices`` is the row-hash family the store's ingest step
inlines, bit-identical to the reference's ``_indices``.

``update`` on int32 counts with int32 [n] (or no) weights is
``kernels.cms_update`` over the int64 buckets as ``indices`` gives them
(one launch of the hand-written kernel on the card); other dtypes and
weight shapes scatter with ``index_add_``. Keys are numpy uint32 columns or int64 tensors holding
uint32 words (``hashing.words``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zipkin_tpu_torch.ops import kernels as K
from zipkin_tpu_torch.ops.hashing import M32, hash2_32, words

DEFAULT_DEPTH = 4
DEFAULT_WIDTH = 1 << 16


class CountMin(NamedTuple):
    counts: torch.Tensor  # [depth, width]

    @property
    def depth(self) -> int:
        return self.counts.shape[0]

    @property
    def width(self) -> int:
        return self.counts.shape[1]


def init(depth: int = DEFAULT_DEPTH, width: int = DEFAULT_WIDTH,
         dtype=torch.int32, device="cuda") -> CountMin:
    assert width & (width - 1) == 0, "width must be a power of two"
    return CountMin(torch.zeros((depth, width), dtype=dtype, device=device))


def indices(depth: int, width: int, key_hi: torch.Tensor,
            key_lo: torch.Tensor) -> torch.Tensor:
    """[depth, n] int64 bucket indices (width must be a power of two)."""
    rows = torch.arange(depth, dtype=torch.int64, device=key_hi.device)
    h0 = hash2_32(key_hi, key_lo, 0)[None, :]
    h1 = hash2_32(key_hi, key_lo, 1)[None, :]
    h = h0 ^ ((h1 * (rows * 2 + 1)[:, None]) & M32)
    return h & (width - 1)


def _keys(sketch: CountMin, key_hi, key_lo):
    dev = sketch.counts.device
    hi, lo = words(key_hi, dev), words(key_lo, dev)
    return indices(sketch.depth, sketch.width, hi, lo)


def update(sketch: CountMin, key_hi, key_lo, weights=None) -> CountMin:
    """Add ``weights`` (default 1) for each key. Duplicate keys accumulate."""
    idx = _keys(sketch, key_hi, key_lo)  # [depth, n]
    counts = sketch.counts.clone()
    if weights is not None:
        weights = torch.as_tensor(weights, device=counts.device)
    if counts.dtype == torch.int32 and (weights is None or (
            weights.dtype == torch.int32
            and weights.shape == idx.shape[1:])):
        K.cms_update(counts, idx,
                     None if weights is None else weights.contiguous())
        return CountMin(counts)
    flat = K.cms_flat_index(idx, sketch.width).to(torch.int64)
    w = (torch.ones(idx.shape, dtype=counts.dtype, device=counts.device)
         if weights is None
         else torch.broadcast_to(weights.to(counts.dtype), idx.shape))
    counts.view(-1).index_add_(0, flat, w.reshape(-1))
    return CountMin(counts)


def query(sketch: CountMin, key_hi, key_lo) -> torch.Tensor:
    """Estimated count per key (min over rows). Never underestimates."""
    idx = _keys(sketch, key_hi, key_lo)
    return torch.gather(sketch.counts, 1, idx).min(dim=0).values


def merge(a: CountMin, b: CountMin) -> CountMin:
    return CountMin(a.counts + b.counts)


def total(sketch: CountMin) -> torch.Tensor:
    """Total weight inserted (exact: every row sums to it)."""
    return sketch.counts[0].sum()
