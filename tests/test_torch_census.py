"""The port's step census (``zipkin_tpu_torch/store/census.py``,
``TorchSpanStore.step_census``) on the CPU.

Ports ``tests/test_obs.py``'s memoized census and ``tests/test_paged.py``'s
census budget (ring and paged censuses equal their composed table rows,
exactly), and holds the window-on census to ``BASE + WINDOW`` on both
routes. The port counts dispatched aten ops, not a lowering, so its rows
are its own: the reference's numbers are not compared.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from zipkin_tpu_torch.ops import kernels as K  # noqa: E402
from zipkin_tpu_torch.store import census  # noqa: E402
from zipkin_tpu_torch.store.convert import state_to_numpy  # noqa: E402
from zipkin_tpu_torch.store.device import StoreConfig  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402
from zipkin_tpu_torch.tracegen import generate_traces  # noqa: E402

CFG = StoreConfig(
    capacity=1 << 10, ann_capacity=1 << 12, bann_capacity=1 << 11,
    max_services=32, max_span_names=128, max_annotation_values=256,
    max_binary_keys=64, cms_width=1 << 10, hll_p=8, quantile_buckets=256,
)
PAGED = dict(layout="paged", page_rows=128)
WINDOW = dict(window_seconds=60)


def _store(cfg=CFG, n_traces=6):
    store = TorchSpanStore(cfg, device="cpu")
    for spans in generate_traces(n_traces, rng=np.random.default_rng(5)):
        store.apply(spans)
    return store


def test_port_step_census_is_memoized():
    store = _store()
    got = store.step_census(n_spans=64, n_anns=128, n_banns=64)
    assert got["scatter"] > 0 and got["sort"] > 0 and got["gather"] > 0
    assert store.step_census(n_spans=64, n_anns=128, n_banns=64) is got
    assert got["ops"] > got["scatter"] + got["sort"] + got["gather"]


def test_port_paged_census_equals_composed_rows():
    """counters() carries the allocator gauges only on the paged layout,
    and the paged step costs exactly the table's +PAGED bump."""
    cfg_ring = CFG._replace(rank_path="counting")
    cfg_paged = cfg_ring._replace(**PAGED)
    ring = _store(cfg_ring)
    paged = _store(cfg_paged)
    pc = paged.counters()
    assert pc["pages_active"] >= 1
    assert pc["pages_active"] + pc["pages_free"] == float(cfg_paged.n_pages)
    assert "page_reclaims_total" in pc
    assert "pages_active" not in ring.counters()
    assert census.gated(paged.step_census(256, 1024, 512)) == \
        census.expected_census("+PAGED", "+COUNTING")
    assert census.gated(ring.step_census(256, 1024, 512)) == \
        census.expected_census("+COUNTING")


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_port_window_census_is_base_plus_window(route):
    cfg = CFG._replace(use_pallas=route == "kernels")
    off = census.gated(_store(cfg, 2).step_census())
    on = census.gated(_store(cfg._replace(**WINDOW), 2).step_census())
    assert off == census.expected_census(route=route)
    assert on == census.expected_census("+WINDOW", route=route)
    both = census.gated(
        _store(cfg._replace(**WINDOW, **PAGED), 2).step_census())
    assert both == census.expected_census("+WINDOW", "+PAGED", route=route)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_port_census_of_each_route_on_the_cpu(layout):
    """On the CPU the kernel route's wrappers run their plain twins, so
    ``use_pallas`` changes the ops the step dispatches: the plain route
    makes the seven histogram scatter-adds and the rank and store ops
    itself, the kernel route one call of each wrapper. Each equals its
    own row; the kernel route counts each wrapper once and dispatches
    fewer ops."""
    extra = PAGED if layout == "paged" else {}
    plain = _store(CFG._replace(**extra), 2).step_census()
    kern = _store(CFG._replace(use_pallas=True, **extra), 2).step_census()
    bumps = ("+PAGED",) if extra else ()
    assert census.gated(plain) == census.expected_census(*bumps)
    assert census.gated(kern) == census.expected_census(
        *bumps, route="kernels")
    assert {k: kern[k] for k in census.KERNELS} == {
        "flat_histogram": 1, "arena_claim": 1, "arena_write": 1,
        "paged_page_gather": 0}
    assert not any(plain[k] for k in census.KERNELS)
    assert kern["ops"] < plain["ops"]
    assert kern["scatter"] < plain["scatter"]


@pytest.mark.parametrize("cfg", [
    CFG, CFG._replace(use_pallas=True, **WINDOW),
    CFG._replace(use_pallas=True, **PAGED),
    CFG._replace(rank_path="counting", **WINDOW, **PAGED),
], ids=["ring", "kernels-window", "kernels-paged", "counting-window-paged"])
def test_port_census_leaves_the_store_as_it_was(cfg):
    """The census runs one step on an empty batch under the store's
    locks: no leaf, counter or path record moves, nor, on the CPU where
    each wrapper runs its twin, a kernel launch count; and the shapes do
    not change the counts."""
    store = _store(cfg)
    before = state_to_numpy(store.state)
    blk = store.counter_block()
    paths = {k: set(v) for k, v in store.state.paths.items()}
    launches = dict(K.LAUNCHES)
    big = store.step_census(256, 512, 256)
    small = store.step_census(64, 128, 64)
    assert census.gated(big) == census.gated(small) == census.row_of(cfg)
    assert big["ops"] == small["ops"]
    after = state_to_numpy(store.state)
    assert before.keys() == after.keys()
    for k, v in before.items():
        if isinstance(v, dict):
            assert v == after[k], k
        else:
            assert v.dtype == after[k].dtype and np.array_equal(
                v, after[k]), k
    store._cblock_memo = None
    assert store.counter_block() == blk
    assert store.state.paths == paths
    assert dict(K.LAUNCHES) == launches
    assert K.CENSUS.hook is None
    # The store still ingests and reads after a census.
    spans = generate_traces(1, rng=np.random.default_rng(9))[0]
    store.apply(spans)
    assert store.get_spans_by_trace_ids([spans[0].trace_id])[0]


def test_port_census_table_refuses_unknown_bumps():
    from zipkin_tpu_torch.store import device as dev
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    with pytest.raises(KeyError):
        census.expected_census("+SHARDED")
    with pytest.raises(KeyError):
        census.expected_census("+COUNTING", route="kernels")
    store = TorchSpanStore(CFG, device="cpu")
    batch, name_lc, ix = ColumnarTraceGen(store.dicts).next_batch(2)
    db = dev.make_device_batch(batch, name_lc, ix, 256, 512, 256)
    with pytest.raises(ValueError, match="empty batch"):
        census.count_step(store.state, dev.batch_to_device(db, "cpu"))
