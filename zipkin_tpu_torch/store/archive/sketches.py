"""Host (numpy) twins of the device hash and sketch primitives.

The port's copy of ``zipkin_tpu/store/archive/sketches.py``. Segments
are sealed on the host from already-pulled columns, so their zone-map
sketches run in numpy, with the same hash family as the device
sketches (murmur3 fmix32 composed per seed, ``ops/hashing.py``;
bit-identical on uint32 words) and the bucket math of
``ops.quantile``. Every sketch is a monoid, which is what the compactor
needs to merge segment headers without re-scanning rows:

- bloom: bitwise OR          - CMS: elementwise +
- HLL: elementwise max       - log-histogram: elementwise +

The host sketch mirror (``store/mirror.py``) shares the hashes and the
bucket index with the device step.

``hist_bucket_index`` computes the index exactly as the port's device
``bucket_index`` does (the float64 log rounded once to float32, then a
float32 division and ceil), not with numpy's float32 ``log``, which is
not correctly rounded. So the mirror, the device cells and a segment's
``dur_hist`` agree bit for bit on every value, and a segment's
``dur_hist`` merges with the device ``svc_hist`` bucket for bucket.
Against the JAX package's numpy twin (and so against a ``dur_hist`` the
JAX package sealed) a value whose float32 log that twin rounds
differently can land one bucket over (ROADMAP.md, Queue 3, stated
tolerance 1); bloom, CMS and HLL are bitwise equal to the reference's.
"""

from __future__ import annotations

import math

import numpy as np

from zipkin_tpu_torch.ops.hashing import split64

_U32 = np.uint32
GOLDEN32 = _U32(0x9E3779B9)


def np_fmix32(h: np.ndarray) -> np.ndarray:
    """murmur3 finalizer on uint32 arrays — bit-identical to
    ops.hashing.fmix32."""
    h = np.asarray(h, _U32)
    with np.errstate(over="ignore"):
        h = h ^ (h >> _U32(16))
        h = h * _U32(0x85EBCA6B)
        h = h ^ (h >> _U32(13))
        h = h * _U32(0xC2B2AE35)
        h = h ^ (h >> _U32(16))
    return h


def np_hash2_32(hi, lo, seed: int) -> np.ndarray:
    """Seeded 64->32-bit hash — bit-identical to ops.hashing.hash2_32."""
    with np.errstate(over="ignore"):
        s = _U32(seed) * GOLDEN32 + _U32(1)
        h = np_fmix32(np.asarray(lo, _U32) ^ s)
        h = np_fmix32(h ^ np.asarray(hi, _U32) ^ (s * _U32(0x85EBCA6B)))
    return h


def np_clz32(x: np.ndarray) -> np.ndarray:
    """Leading zeros of uint32 (vectorized) — twin of ops.hashing.clz32."""
    x = np.asarray(x, _U32)
    n = np.zeros(x.shape, np.int32)
    zero = x == 0
    with np.errstate(over="ignore"):
        for bits, mask in ((16, 0xFFFF0000), (8, 0xFF000000),
                           (4, 0xF0000000), (2, 0xC0000000),
                           (1, 0x80000000)):
            hi_clear = (x & _U32(mask)) == 0
            n = np.where(hi_clear, n + bits, n)
            x = np.where(hi_clear, x << _U32(bits), x)
    return np.where(zero, np.int32(32), n)


# -- bloom filter (trace-id membership) -------------------------------------


def bloom_init(n_bits: int) -> np.ndarray:
    assert n_bits % 8 == 0 and n_bits & (n_bits - 1) == 0
    return np.zeros(n_bits // 8, np.uint8)


BLOOM_HASHES = 4


def _bloom_indices(keys: np.ndarray, n_bits: int) -> np.ndarray:
    """[BLOOM_HASHES, n] bit indices via double hashing (h1 + i*h2)."""
    hi, lo = split64(np.asarray(keys, np.int64))
    h1 = np_hash2_32(hi, lo, 11)
    h2 = np_hash2_32(hi, lo, 12) | _U32(1)
    rows = np.arange(BLOOM_HASHES, dtype=_U32)[:, None]
    with np.errstate(over="ignore"):
        return ((h1[None, :] + rows * h2[None, :])
                & _U32(n_bits - 1)).astype(np.int64)


def bloom_add(bits: np.ndarray, keys) -> None:
    """In-place add (builders only touch unsealed arrays)."""
    keys = np.asarray(keys, np.int64)
    if keys.size == 0:
        return
    idx = _bloom_indices(keys, bits.size * 8).reshape(-1)
    np.bitwise_or.at(bits, idx >> 3,
                     (np.uint8(1) << (idx & 7).astype(np.uint8)))


def bloom_contains(bits: np.ndarray, key: int) -> bool:
    """No false negatives; false-positive rate ~(1-e^(-kn/m))^k."""
    idx = _bloom_indices(np.asarray([key], np.int64), bits.size * 8)[:, 0]
    sel = (bits[idx >> 3] >> (idx & 7).astype(np.uint8)) & np.uint8(1)
    return bool(sel.all())


def bloom_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a | b


# -- count-min (key-pair presence/frequency) --------------------------------


def cms_init(depth: int, width: int) -> np.ndarray:
    assert width & (width - 1) == 0
    return np.zeros((depth, width), np.int32)


def _cms_indices(counts: np.ndarray, hi, lo) -> np.ndarray:
    """[depth, n] — same row-hash family as ops.cms._indices."""
    depth, width = counts.shape
    rows = np.arange(depth, dtype=_U32)[:, None]
    with np.errstate(over="ignore"):
        h = np_hash2_32(hi[None, :], lo[None, :], 0) ^ (
            np_hash2_32(hi[None, :], lo[None, :], 1)
            * (rows * _U32(2) + _U32(1))
        )
    return (h & _U32(width - 1)).astype(np.int64)


def cms_add(counts: np.ndarray, keys) -> None:
    keys = np.asarray(keys, np.int64)
    if keys.size == 0:
        return
    hi, lo = split64(keys)
    idx = _cms_indices(counts, hi, lo)
    flat = idx + (np.arange(counts.shape[0], dtype=np.int64)
                  * counts.shape[1])[:, None]
    np.add.at(counts.reshape(-1), flat.reshape(-1),
              np.ones(flat.size, np.int32))


def cms_query(counts: np.ndarray, key: int) -> int:
    """Min over rows — never underestimates (0 proves absence)."""
    hi, lo = split64(np.asarray([key], np.int64))
    idx = _cms_indices(counts, hi, lo)[:, 0]
    return int(counts[np.arange(counts.shape[0]), idx].min())


def cms_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a + b


# -- HyperLogLog (distinct trace ids per segment) ---------------------------


def hll_init(p: int) -> np.ndarray:
    return np.zeros(1 << p, np.int32)


def hll_add(regs: np.ndarray, keys) -> None:
    """Same (index, rank) hash pair as ops.hll.update."""
    keys = np.asarray(keys, np.int64)
    if keys.size == 0:
        return
    hi, lo = split64(keys)
    idx = (np_hash2_32(hi, lo, 101) & _U32(regs.size - 1)).astype(np.int64)
    rank = np_clz32(np_hash2_32(hi, lo, 202)) + 1
    np.maximum.at(regs, idx, rank)


def hll_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.maximum(a, b)


def hll_estimate(regs: np.ndarray) -> float:
    """ops.hll.estimate on host data (same small-range correction)."""
    m = regs.size
    if m == 16:
        alpha = 0.673
    elif m == 32:
        alpha = 0.697
    elif m == 64:
        alpha = 0.709
    else:
        alpha = 0.7213 / (1.0 + 1.079 / m)
    raw = alpha * m * m / np.exp2(-regs.astype(np.float64)).sum()
    zeros = float((regs == 0).sum())
    if raw <= 2.5 * m and zeros > 0:
        return float(m * math.log(m / max(zeros, 1.0)))
    return float(raw)


# -- log-histogram (duration quantiles, ops.quantile geometry) --------------


def hist_bucket_index(values: np.ndarray, n_buckets: int, gamma: float,
                      min_value: float = 1.0) -> np.ndarray:
    """Twin of ops.quantile.bucket_index, bit for bit: the float32
    ratio, its log taken in float64 and rounded once to float32, a
    float32 division by the float32 ``log(gamma)``, then the ceil."""
    v = np.asarray(values, np.float32)
    mv = np.float32(min_value)
    ratio = (np.maximum(v, mv) / mv).astype(np.float64)
    scaled = np.log(ratio).astype(np.float32)
    idx = np.ceil(scaled / np.float32(math.log(gamma)))
    return np.clip(idx.astype(np.int32), 0, n_buckets - 1)


def hist_add(counts: np.ndarray, values, gamma: float,
             min_value: float = 1.0) -> None:
    values = np.asarray(values)
    if values.size == 0:
        return
    idx = hist_bucket_index(values, counts.size, gamma, min_value)
    np.add.at(counts, idx, np.int64(1))
