"""Vectorized equi-join (sort-merge) on torch tensors.

One stable single-key sort over the union of build and probe rows, the
key being a 64-bit hash of the composite key with the build/probe tag
in the low bit, then a forward fill of the latest build row; equality
is re-verified on the original columns. Same contract and the same
winner among duplicate build keys (the latest in arrival order) as
``zipkin_tpu.ops.join.lookup``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from zipkin_tpu_torch.ops.hashing import mix_keys64

_SIGN = -(1 << 63)


def lookup(build_keys: Sequence[torch.Tensor], build_valid: torch.Tensor,
           build_values: torch.Tensor, probe_keys: Sequence[torch.Tensor],
           probe_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found, values) per probe row; values are 0 where not found."""
    dev = build_valid.device
    n_b = build_keys[0].shape[0]
    n_q = probe_keys[0].shape[0]
    n = n_b + n_q
    keys = [torch.cat([b.to(torch.int64), q.to(torch.int64)])
            for b, q in zip(build_keys, probe_keys)]
    is_build = torch.cat([build_valid,
                          torch.zeros(n_q, dtype=torch.bool, device=dev)])
    tag = torch.cat([torch.zeros(n_b, dtype=torch.int64, device=dev),
                     torch.ones(n_q, dtype=torch.int64, device=dev)])
    payload = torch.cat([build_values,
                         torch.zeros(n_q, dtype=build_values.dtype,
                                     device=dev)])
    sort_key = (mix_keys64(keys) << 1) | tag
    # Unsigned order of the 64-bit key == signed order with the sign
    # bit flipped.
    order = torch.sort(sort_key ^ _SIGN, stable=True).indices
    s_build = is_build[order]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    src = torch.cummax(torch.where(s_build, idx, torch.full_like(idx, -1)),
                       dim=0).values
    src_c = src.clamp(0, n - 1)
    same = src >= 0
    for k in keys:
        sk = k[order]
        same = same & (sk[src_c] == sk)
    hit = same & ~s_build
    val = torch.where(hit, payload[order][src_c],
                      torch.zeros_like(payload))
    probe_pos = torch.cat([torch.full((n_b,), n_q, dtype=torch.int64,
                                      device=dev),
                           torch.arange(n_q, dtype=torch.int64,
                                        device=dev)])[order]
    found = torch.zeros(n_q + 1, dtype=torch.bool, device=dev)
    found[probe_pos] = hit
    values = torch.zeros(n_q + 1, dtype=payload.dtype, device=dev)
    values[probe_pos] = val
    return found[:n_q] & probe_valid, values[:n_q]
