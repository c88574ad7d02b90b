"""Vectorized streaming central moments on torch tensors.

State layout: a trailing-dim-5 float32 array ``[..., (n, mean, m2, m3,
m4)]``, as in ``zipkin_tpu.ops.moments``. ``combine`` is the Chan/Pébay
pairwise formula; ``segment_moments`` is exact two-pass per-segment
moments. Sums run in another order than XLA's (and, on the card, in
atomic order), so float fields agree to float32 rounding, the count
field exactly.
"""

from __future__ import annotations

import torch

N_FIELDS = 5  # n, mean, m2, m3, m4


def zero(shape=(), dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (N_FIELDS,), dtype=dtype,
                       device=device)


def of(x) -> torch.Tensor:
    """Moments of single observations: x[...] -> [..., 5]."""
    x = torch.as_tensor(x)
    z = torch.zeros_like(x)
    return torch.stack([torch.ones_like(x), x, z, z, z], dim=-1)


def combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise combine, elementwise over leading dims ([...,5],[...,5])."""
    na, ma, m2a, m3a, m4a = a.unbind(-1)
    nb, mb, m2b, m3b, m4b = b.unbind(-1)
    n = na + nb
    safe_n = torch.where(n > 0, n, torch.ones_like(n))
    delta = mb - ma
    d_n = delta / safe_n
    mean = ma + nb * d_n
    m2 = m2a + m2b + delta * d_n * na * nb
    m3 = (
        m3a
        + m3b
        + delta * d_n * d_n * na * nb * (na - nb)
        + 3.0 * d_n * (na * m2b - nb * m2a)
    )
    m4 = (
        m4a
        + m4b
        + delta * (d_n * d_n * d_n) * na * nb * (na * na - na * nb + nb * nb)
        + 6.0 * d_n * d_n * (na * na * m2b + nb * nb * m2a)
        + 4.0 * d_n * (na * m3b - nb * m3a)
    )
    out = torch.stack([n, mean, m2, m3, m4], dim=-1)
    out = torch.where((na == 0)[..., None], b, out)
    return torch.where((nb == 0)[..., None], a, out)


def segment_moments(values, segment_ids, num_segments: int, valid=None,
                    dtype=torch.float32) -> torch.Tensor:
    """Exact per-segment moments of ``values`` -> [num_segments, 5];
    ``valid`` (default: every row) masks out padding rows."""
    x = torch.as_tensor(values).to(dtype)
    seg = torch.as_tensor(segment_ids, device=x.device).to(torch.int64)
    valid = (torch.ones(seg.shape, dtype=torch.bool, device=x.device)
             if valid is None
             else torch.as_tensor(valid, device=x.device).to(torch.bool))
    w = valid.to(dtype)
    # Masked and out-of-range rows go to a scratch segment (segment_sum
    # drops out-of-range ids).
    seg = torch.where(valid & (seg >= 0) & (seg < num_segments), seg,
                      torch.full_like(seg, num_segments))

    def ssum(v):
        out = torch.zeros(num_segments + 1, dtype=dtype, device=x.device)
        return out.index_add_(0, seg, v)

    n = ssum(w)
    sx = ssum(w * x)
    mean = sx / torch.where(n > 0, n, torch.ones_like(n))
    c = (x - mean[seg]) * w
    m2 = ssum(c * c)
    m3 = ssum(c * c * c)
    m4 = ssum(c * c * c * c)
    return torch.stack([n, mean, m2, m3, m4], dim=-1)[:num_segments]


def reduce_moments(m: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Tree-reduce a stack of moments [..., k, ..., 5] along ``axis``
    via combine (log2(k) combine steps)."""
    m = torch.movedim(m, axis, 0)
    k = m.shape[0]
    while k > 1:
        if k % 2:
            m = torch.cat([m, torch.zeros_like(m[:1])], dim=0)
            k += 1
        m = combine(m[0::2], m[1::2])
        k = m.shape[0]
    return m[0]


def variance(m: torch.Tensor) -> torch.Tensor:
    n = m[..., 0]
    return m[..., 2] / torch.where(n > 0, n, torch.ones_like(n))


def mean(m: torch.Tensor) -> torch.Tensor:
    return m[..., 1]


def count(m: torch.Tensor) -> torch.Tensor:
    return m[..., 0]
