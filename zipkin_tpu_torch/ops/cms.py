"""Count-min sketch indices over 64-bit keys, torch side.

The sketch state is a plain ``[depth, width]`` int32 count array whose
update is a flat histogram (``ops.kernels``); this module only derives
the per-row bucket of each key, bit-identical to
``zipkin_tpu.ops.cms._indices``.
"""

from __future__ import annotations

import torch

from zipkin_tpu_torch.ops.hashing import M32, hash2_32


def indices(depth: int, width: int, key_hi: torch.Tensor,
            key_lo: torch.Tensor) -> torch.Tensor:
    """[depth, n] int64 bucket indices (width must be a power of two)."""
    rows = torch.arange(depth, dtype=torch.int64, device=key_hi.device)
    h0 = hash2_32(key_hi, key_lo, 0)[None, :]
    h1 = hash2_32(key_hi, key_lo, 1)[None, :]
    h = h0 ^ ((h1 * (rows * 2 + 1)[:, None]) & M32)
    return h & (width - 1)
