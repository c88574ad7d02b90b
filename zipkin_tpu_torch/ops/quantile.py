"""Mergeable log-histogram quantile sketch (DDSketch-style), torch side.

Bucket ``i`` covers values in ``(min_value * gamma^(i-1), min_value *
gamma^i]`` with ``gamma = (1+alpha)/(1-alpha)``; values <= min_value
land in bucket 0. The device state is a plain ``[..., n_buckets]`` int32
count array (``StoreState.svc_hist``); the index math is float32, as in
``zipkin_tpu.ops.quantile``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

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
