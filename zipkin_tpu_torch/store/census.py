"""The dispatch census of one ingest step, and the table that gates it.

The port's counterpart of ``zipkin_tpu/store/census.py``. The reference
counts the scatter, sort and gather ops of the fused step's StableHLO
lowering, the proxy for its cost on a device where each op is a kernel
of its own. The port has no lowering: its step runs eagerly, one aten
op after another from Python, and is host-bound (the ring launch's
device sits idle most of the launch). So what it spends per step is
the ops it DISPATCHES, and this census counts them:

- ``count_step`` runs ``store/device.ingest_step`` once on an empty
  batch padded to the asked shapes, under a ``TorchDispatchMode``, and
  counts every aten op it dispatches: ``scatter`` (ops that write at
  computed indices: ``index_put_``, ``index_add_``, ``scatter_reduce_``
  and the like), ``gather`` (ops that read at computed indices:
  advanced ``index``, ``gather``, ``index_select``, ...), ``sort``
  (``sort``, ``argsort``, ``topk``, ...) and ``ops``, every aten op of
  any class;
- each call of an ``ops/kernels.py`` wrapper counts once, under its
  kernel's name, and the ops inside it do not count. The wrapper runs
  as it always does: its plain twin on the CPU, its kernel on the card
  (a launch over the empty batch's invalid rows, which ``LAUNCHES``
  counts like any other). So a step gives the same census on the CPU
  and on the card.

The empty batch makes every write of the step a no-op, and the step's
functional updates (cursors, counters, the dependency window) are put
back after it, so a census leaves the store's state as it found it.

Why the numbers are not the reference's 95/4/79: XLA lowers the
reference's step as one program in which a scatter of an i64 array is
two i32 plane scatters, a multi-operand sort one sort, and a gather of
rows one gather; torch dispatches what the Python says, so a masked
write ``x[idx[ok]] = v[ok]`` is two gathers and one ``index_put_``, and
the seven histogram scatter-adds of the plain route are seven
``index_add_`` with their masks. The kernel route (``use_pallas``)
replaces those seven scatter-adds (eight with the window) by one
``flat_histogram`` call and the index write's rank and store by one
``arena_claim`` and one ``arena_write`` call.

``LOWERING_TABLE`` holds each route's counts: ``BASE`` (the ring
layout, window off, ``rank_path="auto"``, which takes the argsort rank
off the TPU as in the reference) plus one row for each optional
feature, composed by ``expected_census``. The rows hold for stores
above 2^9 spans, where the index's gid watermark wars are coarse (at
and below it they take the exact path, as in the reference). Any
change to what the step dispatches must change a row here, with its
reason.

History: the table was measured when the port's daemon entry came (the
census's first version) at the pad shapes (256, 512, 256) and
(64, 128, 64), which give the same counts.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict

CLASSES = ("scatter", "sort", "gather")
KERNELS = ("flat_histogram", "arena_claim", "arena_write",
           "paged_page_gather")
GATED = CLASSES + KERNELS

_OPS_OF = {
    "scatter": frozenset((
        "index_put", "index_put_", "_index_put_impl_", "index_add",
        "index_add_", "index_copy", "index_copy_", "index_fill_",
        "index_reduce_", "scatter", "scatter_", "scatter_add",
        "scatter_add_", "scatter_reduce", "scatter_reduce_",
        "masked_scatter_", "put_")),
    "sort": frozenset((
        "sort", "argsort", "msort", "topk", "kthvalue", "_unique2",
        "unique_dim", "unique_consecutive")),
    "gather": frozenset((
        "index", "gather", "index_select", "take", "take_along_dim",
        "masked_select")),
}
_CLASS_OF = {op: cls for cls, ops in _OPS_OF.items() for op in ops}


def _row(scatter=0, sort=0, gather=0, **kernels) -> Dict[str, int]:
    return {"scatter": scatter, "sort": sort, "gather": gather,
            **{k: kernels.get(k, 0) for k in KERNELS}}


# The per-route table: "BASE" is the default lowering; every "+NAME" row
# is what one optional feature adds to it.
LOWERING_TABLE = {
    "plain": {
        "BASE": _row(60, 2, 132),
        # The windowed arena: the epoch war (a masked scatter-max and
        # its gathers), the power-sum and min/max scatters, and the
        # eighth histogram site.
        "+WINDOW": _row(4, 0, 4),
        # The paged layout: the reclaimed pages' row_gid invalidation
        # and the planner's slot and gid columns gathered by row.
        "+PAGED": _row(1, 0, 2),
        # rank_path="counting": the counting rank in place of the stable
        # argsort (a scatter-add and a cumsum for the sort).
        "+COUNTING": _row(0, -1, 0),
    },
    "kernels": {
        "BASE": _row(50, 1, 122, flat_histogram=1, arena_claim=1,
                     arena_write=1),
        # The window's count site joins the one flat_histogram call.
        "+WINDOW": _row(3, 0, 3),
        "+PAGED": _row(1, 0, 2),
    },
}


def expected_census(*bumps: str, route: str = "plain") -> Dict[str, int]:
    """The gated counts of ``route``'s BASE plus the named bumps, e.g.
    ``expected_census("+WINDOW", "+PAGED", route="kernels")``. Unknown
    bump names raise: a feature cannot ride ungated."""
    table = LOWERING_TABLE[route]
    out = dict(table["BASE"])
    for b in bumps:
        if b == "BASE":
            continue
        for k, v in table[b].items():
            out[k] += v
    return out


def row_of(config) -> Dict[str, int]:
    """The table's row for a store config (capacity above 2^9)."""
    route = "kernels" if config.use_pallas else "plain"
    bumps = []
    if config.window_seconds > 0:
        bumps.append("+WINDOW")
    if config.paged_enabled:
        bumps.append("+PAGED")
    if route == "plain" and config.rank_path == "counting":
        bumps.append("+COUNTING")
    return expected_census(*bumps, route=route)


def gated(census: Dict[str, int]) -> Dict[str, int]:
    """The keys of a census that the table gates (all but ``ops``)."""
    return {k: census[k] for k in GATED}


def count_step(state, batch) -> Dict[str, int]:
    """Run ``ingest_step(state, batch)`` on an EMPTY padded ``batch``
    (tensors on the state's device) and count what it dispatches; the
    state is left as it was. The caller holds the store's locks."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from zipkin_tpu_torch.ops import kernels as K
    from zipkin_tpu_torch.store import device as dev

    if int(batch.n_spans) or int(batch.n_anns) or int(batch.n_banns):
        raise ValueError("count_step takes an empty batch")
    ops = Counter()
    calls = Counter()
    inside = [0]

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not inside[0]:
                name = func.overloadpacket.__name__
                ops["ops"] += 1
                cls = _CLASS_OF.get(name)
                if cls is not None:
                    ops[cls] += 1
            return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def wrapper_call(name):
        calls[name] += 1
        inside[0] += 1
        try:
            yield
        finally:
            inside[0] -= 1

    leaves = dict(state.leaves)
    paths = {k: set(v) for k, v in state.paths.items()}
    K.CENSUS.hook = wrapper_call
    try:
        with _Count():
            dev.ingest_step(state, batch)
    finally:
        K.CENSUS.hook = None
        state.leaves.clear()
        state.leaves.update(leaves)
        state.paths = paths
    return {**{k: ops[k] for k in CLASSES},
            **{k: calls[k] for k in KERNELS}, "ops": ops["ops"]}
