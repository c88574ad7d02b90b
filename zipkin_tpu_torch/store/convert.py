"""Carry store state across as numpy leaves.

``state_from_numpy`` builds a port ``StoreState`` from a dict of numpy
arrays keyed by the JAX ``StoreState`` field names — ``counters`` as a
nested dict, ``span_tab`` as its [H, 2] int32 bit-planes — the dict a
caller gets from ``jax.device_get`` of the reference store's leaves.
``state_to_numpy`` goes the other way. Both are plain copies: dtypes
and shapes are the reference's.

The sharded pair carries a fleet across: ``sharded_states_from_numpy``
splits the reference's stacked ``[n, ...]`` leaves (``jax.device_get``
of a ``ShardedSpanStore``'s states; every counter an ``[n]`` array)
into the N independent port states a ``parallel.ShardedStore`` keeps,
and ``sharded_states_to_numpy`` stacks N port states back.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from zipkin_tpu_torch.store.device import (
    COUNTER_NAMES,
    FIELDS,
    StoreConfig,
    StoreState,
    resolve_device,
)


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def state_from_numpy(config: StoreConfig, leaves: Dict[str, object],
                     device="cuda") -> StoreState:
    dev = resolve_device(device)
    out = {}
    for name in FIELDS:
        if name == "counters":
            ctr = leaves["counters"]
            out[name] = {k: torch.tensor(int(np.asarray(ctr[k])),
                                         dtype=torch.int64, device=dev)
                         for k in COUNTER_NAMES}
            continue
        out[name] = _tensor(leaves[name], dev)
    if out["span_tab"].dim() != 2 or out["span_tab"].dtype != torch.int32:
        raise ValueError("span_tab must be [H, 2] int32 bit-planes")
    return StoreState(config, out)


def state_to_numpy(state: StoreState) -> Dict[str, object]:
    out = {}
    for name in FIELDS:
        if name == "counters":
            out[name] = {k: np.int64(v.item())
                         for k, v in state.counters.items()}
        else:
            out[name] = state.leaves[name].detach().cpu().numpy()
    return out


def sharded_states_from_numpy(config: StoreConfig,
                              stacked_leaves: Dict[str, object],
                              device="cuda") -> List[StoreState]:
    n = int(np.asarray(stacked_leaves["write_pos"]).shape[0])
    out = []
    for i in range(n):
        leaves = {name: (
            {k: np.asarray(v)[i] for k, v in stacked_leaves[name].items()}
            if name == "counters" else np.asarray(stacked_leaves[name])[i])
            for name in FIELDS}
        out.append(state_from_numpy(config, leaves, device=device))
    return out


def sharded_states_to_numpy(states: Sequence[StoreState]
                            ) -> Dict[str, object]:
    per = [state_to_numpy(st) for st in states]
    out = {}
    for name in FIELDS:
        if name == "counters":
            out[name] = {k: np.stack([p[name][k] for p in per])
                         for k in COUNTER_NAMES}
        else:
            out[name] = np.stack([p[name] for p in per])
    return out
