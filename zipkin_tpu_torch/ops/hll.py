"""HyperLogLog cardinality sketch over 64-bit keys, torch side.

Two independent 32-bit hashes, one for the register index and one for
the rank (leading zeros + 1), as in ``zipkin_tpu.ops.hll``. Update is a
scatter-max into the int32 registers; merge is the elementwise max. The
estimate is taken on the host in float64 (the reference sums in float32:
the registers are equal bitwise, the estimates within ``rel=1e-5``,
ROADMAP.md's stated tolerance 3).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from zipkin_tpu_torch.ops.hashing import clz32, hash2_32, words

DEFAULT_P = 14


class HyperLogLog(NamedTuple):
    registers: torch.Tensor  # [2^p] int32 max rank a register

    @property
    def m(self) -> int:
        return self.registers.shape[0]


def init(p: int = DEFAULT_P, device="cuda") -> HyperLogLog:
    return HyperLogLog(torch.zeros(1 << p, dtype=torch.int32, device=device))


def update_(registers: torch.Tensor, key_hi: torch.Tensor,
            key_lo: torch.Tensor, valid=None) -> torch.Tensor:
    """Fold keys into ``registers`` in place (int32 [2^p])."""
    m = registers.shape[0]
    idx = hash2_32(key_hi, key_lo, 101) & (m - 1)
    rank = clz32(hash2_32(key_hi, key_lo, 202)) + 1  # 1..33
    if valid is not None:
        rank = torch.where(valid, rank, torch.zeros_like(rank))
    return registers.scatter_reduce_(0, idx, rank, "amax")


def update(sketch: HyperLogLog, key_hi, key_lo, valid=None) -> HyperLogLog:
    dev = sketch.registers.device
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev).to(torch.bool)
    return HyperLogLog(update_(sketch.registers.clone(), words(key_hi, dev),
                               words(key_lo, dev), valid))


def merge(a: HyperLogLog, b: HyperLogLog) -> HyperLogLog:
    return HyperLogLog(torch.maximum(a.registers, b.registers))


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def estimate(registers) -> float:
    """Estimated distinct-key count of a sketch or of its registers
    (float64, with linear counting below 2.5m)."""
    if isinstance(registers, HyperLogLog):
        registers = registers.registers
    if isinstance(registers, torch.Tensor):
        registers = registers.cpu().numpy()
    regs = np.asarray(registers, np.float64)
    m = regs.shape[0]
    raw = _alpha(m) * m * m / np.sum(np.exp2(-regs))
    zeros = float(np.sum(regs == 0))
    if raw <= 2.5 * m and zeros > 0:
        return float(m * np.log(m / max(zeros, 1.0)))
    return float(raw)
