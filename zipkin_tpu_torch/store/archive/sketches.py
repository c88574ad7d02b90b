"""Host (numpy) twins of the device hash and bucket primitives.

The port's copy of the part of ``zipkin_tpu/store/archive/sketches.py``
that the host sketch mirror needs: the murmur3 hash family of
``ops/hashing.py`` (bit-identical on uint32 words) and the
log-histogram bucket index of ``ops/quantile.bucket_index``.

``hist_bucket_index`` computes the index exactly as the port's device
``bucket_index`` does (the float64 log rounded once to float32, then a
float32 division and ceil), not with numpy's float32 ``log``, which is
not correctly rounded. So the mirror and the device cells agree bit for
bit on every value; against the JAX package's numpy twin a value whose
float32 log that twin rounds differently can land one bucket over
(ROADMAP.md, Queue 3, stated tolerance 1).
"""

from __future__ import annotations

import math

import numpy as np

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
