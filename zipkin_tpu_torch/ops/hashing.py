"""32-bit hashing primitives for 64-bit keys, on torch tensors.

The JAX package works on (hi, lo) uint32 word pairs and uint64 mixed
keys. PyTorch has no ``>>`` on uint32/uint64 on the CPU, so here every
uint32 word travels as an int64 holding a value in [0, 2^32), masked
with ``& 0xFFFFFFFF`` after each multiply and shift, and every uint64
word travels as an int64 holding the same 64 bits (multiplies wrap
modulo 2^64 in two's complement; right shifts are made logical with a
mask). Results are bit-identical to ``zipkin_tpu.ops.hashing``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN32 = 0x9E3779B9


def s64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >= (1 << 63) else u


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the 64 bits held in an int64 tensor."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def split64(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host: int64 column -> (hi, lo) uint32 columns."""
    u = x.astype(np.int64).view(np.uint64)
    return (u >> np.uint64(32)).astype(np.uint32), (
        u & np.uint64(0xFFFFFFFF)
    ).astype(np.uint32)


def dev_split64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 tensor -> (hi, lo) words, each an int64 in [0, 2^32)."""
    x = x.to(torch.int64)
    return (x >> 32) & M32, x & M32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    return (h * c) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 words held in int64."""
    h = h & M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash2_32(hi: torch.Tensor, lo: torch.Tensor, seed: int) -> torch.Tensor:
    """Hash a (hi, lo) 64-bit key to 32 bits under an integer ``seed``."""
    s = (seed * GOLDEN32 + 1) & M32
    h = fmix32((lo & M32) ^ s)
    return fmix32(h ^ (hi & M32) ^ ((s * 0x85EBCA6B) & M32))


_PI = s64(0x243F6A8885A308D3)
_K1 = s64(0x9E3779B97F4A7C15)
_K2 = s64(0xBF58476D1CE4E5B9)
_K3 = s64(0x94D049BB133111EB)


def mix_keys64(keys) -> torch.Tensor:
    """Fold int64 key columns into one well-dispersed 64-bit word
    (splitmix64-style finalizer), returned as int64 bits."""
    keys = [k.to(torch.int64) for k in keys]
    acc = torch.full_like(keys[0], _PI)
    for k in keys:
        acc = (acc ^ k) * _K1
        acc = acc ^ srl(acc, 29)
    acc = acc * _K2
    acc = acc ^ srl(acc, 32)
    acc = acc * _K3
    return acc ^ srl(acc, 29)



def np_mix_keys64(keys) -> np.ndarray:
    """Host (numpy) mirror of mix_keys64, as uint64 — bit-identical, so
    host-side migrations can seed device hash structures (checkpoint.py)
    and the device probes find the keys."""
    arrs = [np.asarray(k, np.int64).astype(np.uint64) for k in keys]
    acc = np.full(arrs[0].shape, 0x243F6A8885A308D3, np.uint64)
    with np.errstate(over="ignore"):
        for a in arrs:
            acc = (acc ^ a) * np.uint64(0x9E3779B97F4A7C15)
            acc ^= acc >> np.uint64(29)
        acc *= np.uint64(0xBF58476D1CE4E5B9)
        acc ^= acc >> np.uint64(32)
        acc *= np.uint64(0x94D049BB133111EB)
        acc ^= acc >> np.uint64(29)
    return acc

def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of uint32 words held in int64 (int32 out)."""
    x = x & M32
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    zero = x == 0
    for bits, mask in ((16, 0xFFFF0000), (8, 0xFF000000), (4, 0xF0000000),
                       (2, 0xC0000000), (1, 0x80000000)):
        hi_clear = (x & mask) == 0
        n = torch.where(hi_clear, n + bits, n)
        x = torch.where(hi_clear, (x << bits) & M32, x)
    return torch.where(zero, torch.full_like(n, 32), n)
