"""Mergeable log-histogram quantile sketch (DDSketch-style), torch side.

Bucket ``i`` covers values in ``(min_value * gamma^(i-1), min_value *
gamma^i]`` with ``gamma = (1+alpha)/(1-alpha)``; values <= min_value
land in bucket 0. The state is a ``[..., n_buckets]`` count array (the
store's ``StoreState.svc_hist`` is an int32 ``[services, buckets]``
bank); ``merge`` is ``+``, as in ``zipkin_tpu.ops.quantile``.

Updates on int32 counts are one flat histogram (``kernels.
histogram_update``: one launch of the hand-written kernel on the card);
other dtypes scatter with ``index_add_``. ``quantile`` computes in
float32, as the reference does.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from zipkin_tpu_torch.ops import kernels as K

DEFAULT_ALPHA = 0.01
DEFAULT_BUCKETS = 2048


def gamma_of(alpha: float) -> float:
    return (1.0 + alpha) / (1.0 - alpha)


def bucket_index(values: torch.Tensor, n_buckets: int, gamma: float,
                 min_value: float = 1.0) -> torch.Tensor:
    """Bucket index per value (int32), clipped into range.

    The reference's arithmetic is float32: ``ceil(log(v) / lg)`` with
    ``lg`` the float32 rounding of ``log(gamma)``. Here the log is
    taken in float64 and rounded once to float32, i.e. the correctly
    rounded float32 log, so the CPU and the CUDA twin agree bit for
    bit; the division and the ceil stay float32. Where a backend's
    float32 log is not correctly rounded, a value within an ulp or two
    of a bucket edge can land one bucket over (ROADMAP.md, Queue 3)."""
    v = values.to(torch.float32)
    mv = torch.tensor(min_value, dtype=torch.float32, device=v.device)
    lg = torch.tensor(math.log(gamma), dtype=torch.float32, device=v.device)
    ratio = (torch.maximum(v, mv) / mv).to(torch.float64)
    scaled = torch.log(ratio).to(torch.float32)
    idx = torch.ceil(scaled / lg)
    return torch.clamp(idx.to(torch.int32), 0, n_buckets - 1)


@dataclass
class LogHistogram:
    counts: torch.Tensor  # [..., n_buckets]
    gamma: float
    min_value: float

    @property
    def n_buckets(self) -> int:
        return self.counts.shape[-1]

    def _replace(self, **kw) -> "LogHistogram":
        return replace(self, **kw)

    def bucket_index(self, values) -> torch.Tensor:
        """The reference's ``bucket_index(sketch, values)``."""
        return bucket_index(torch.as_tensor(values, device=self.counts.device),
                            self.n_buckets, self.gamma, self.min_value)


def init(shape=(), n_buckets: int = DEFAULT_BUCKETS,
         alpha: float = DEFAULT_ALPHA, min_value: float = 1.0,
         dtype=torch.float32, device="cuda") -> LogHistogram:
    return LogHistogram(
        torch.zeros(tuple(shape) + (n_buckets,), dtype=dtype, device=device),
        gamma_of(alpha), min_value)


def _add(sketch: LogHistogram, flat, valid) -> LogHistogram:
    """A copy of ``sketch`` with ``valid`` (None: ones) added at the flat
    cells ``flat``."""
    counts = sketch.counts.clone()
    if valid is not None:
        valid = torch.as_tensor(valid, device=counts.device)
    if counts.dtype == torch.int32:
        K.histogram_update(counts, flat.to(torch.int32),
                           None if valid is None else valid.to(torch.int32))
    else:
        w = (torch.ones(flat.shape, dtype=counts.dtype, device=counts.device)
             if valid is None else valid.to(counts.dtype))
        counts.view(-1).index_add_(0, flat.to(torch.int64), w)
    return sketch._replace(counts=counts)


def update(sketch: LogHistogram, values, valid=None) -> LogHistogram:
    """Flat (no leading dims) update: add each value to its bucket."""
    return _add(sketch, sketch.bucket_index(values), valid)


def update_grouped(sketch: LogHistogram, group_ids, values,
                   valid=None) -> LogHistogram:
    """Banked update: sketch [G, B]; value i goes to (group_ids[i],
    bucket), the group id clipped into range."""
    idx = sketch.bucket_index(values).to(torch.int64)
    g = torch.as_tensor(group_ids, device=idx.device).to(torch.int64)
    g = torch.clamp(g, 0, sketch.counts.shape[0] - 1)
    return _add(sketch, g * sketch.n_buckets + idx, valid)


def merge(a: LogHistogram, b: LogHistogram) -> LogHistogram:
    assert a.gamma == b.gamma and a.min_value == b.min_value
    return a._replace(counts=a.counts + b.counts)


@functools.lru_cache(maxsize=16)
def _midpoints(n_buckets: int, gamma: float, min_value: float,
               device: str) -> torch.Tensor:
    """Each bucket's geometric midpoint in float32, as the reference
    computes it (``min_value * gamma^b * 2 / (1 + gamma)``, bucket 0 at
    ``min_value``). Taken on the CPU and copied, so a quantile read is
    the same on the card (whose float32 pow is not correctly rounded)."""
    f32 = torch.float32
    g = torch.tensor(gamma, dtype=f32)
    mv = torch.tensor(min_value, dtype=f32)
    mid = mv * torch.pow(g, torch.arange(n_buckets, dtype=f32)) * (
        2.0 / (1.0 + g))
    mid[0] = mv
    return mid.to(device)


def quantile(sketch: LogHistogram, q) -> torch.Tensor:
    """q-quantile value estimate per leading dim; NaN where count is 0:
    the geometric midpoint of the matched bucket, in float32."""
    f32 = torch.float32
    dev = sketch.counts.device
    counts = sketch.counts.to(f32)
    total = counts.sum(dim=-1, keepdim=True)
    ranks = torch.tensor(q, dtype=f32, device=dev) * torch.clamp(
        total - 1, min=0)
    cum = torch.cumsum(counts, dim=-1)
    b = torch.clamp((cum <= ranks).sum(dim=-1), max=sketch.n_buckets - 1)
    mid = _midpoints(sketch.n_buckets, sketch.gamma, sketch.min_value,
                     str(dev))[b]
    return torch.where(total[..., 0] > 0, mid,
                       torch.tensor(float("nan"), dtype=f32, device=dev))


def count(sketch: LogHistogram) -> torch.Tensor:
    return sketch.counts.sum(dim=-1)


def quantiles_host(counts, gamma: float, min_value: float, qs):
    """numpy quantiles of one fetched [n_buckets] row (geometric
    midpoint of the matched bucket; NaN when the row is empty)."""
    counts = np.asarray(counts, np.float64)
    total = float(counts.sum())
    if total <= 0:
        return [float("nan")] * len(qs)
    cum = np.cumsum(counts)
    out = []
    for q in qs:
        rank = q * max(total - 1.0, 0.0)
        b = min(int(np.searchsorted(cum, rank, side="right")),
                len(counts) - 1)
        mid = min_value if b == 0 else (
            min_value * gamma**b * (2.0 / (1.0 + gamma))
        )
        out.append(float(mid))
    return out
