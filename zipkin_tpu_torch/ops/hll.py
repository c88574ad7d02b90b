"""HyperLogLog cardinality sketch over 64-bit keys, torch side.

Two independent 32-bit hashes, one for the register index and one for
the rank (leading zeros + 1), as in ``zipkin_tpu.ops.hll``. Update is a
scatter-max into the int32 registers; the estimate is taken on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from zipkin_tpu_torch.ops.hashing import clz32, hash2_32

DEFAULT_P = 14


def update_(registers: torch.Tensor, key_hi: torch.Tensor,
            key_lo: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fold keys into ``registers`` in place (int32 [2^p])."""
    m = registers.shape[0]
    idx = hash2_32(key_hi, key_lo, 101) & (m - 1)
    rank = clz32(hash2_32(key_hi, key_lo, 202)) + 1  # 1..33
    rank = torch.where(valid, rank, torch.zeros_like(rank))
    return registers.scatter_reduce_(0, idx, rank, "amax")


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def estimate(registers) -> float:
    """Estimated distinct-key count from fetched registers (float64,
    with linear counting below 2.5m)."""
    regs = np.asarray(registers, np.float64)
    m = regs.shape[0]
    raw = _alpha(m) * m * m / np.sum(np.exp2(-regs))
    zeros = float(np.sum(regs == 0))
    if raw <= 2.5 * m and zeros > 0:
        return float(m * np.log(m / max(zeros, 1.0)))
    return float(raw)
