"""The port's pipelined ingest (``zipkin_tpu_torch/store/pipeline.py``)
on the CPU.

The pipeline changes when work happens, never what state results:
pipelined equals serial bitwise (every leaf, the sketch mirror too) on
both layouts with the windowed arena on, and the port pipelined equals
the JAX store serial. Lifecycle and error semantics follow
``zipkin_tpu/store/pipeline.py``: one pipeline a store, no inline
``write_batch`` while it runs, drain makes reads see everything, stop
returns to serial; a failed step parks its error, re-raises it once and
the pipeline keeps going. Its metrics live in the registry the store
was given.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_store import (  # noqa: E402
    PORT,
    _convert,
    assert_states_equal,
    jax_leaves,
)
from test_torch_windows import LAYOUTS, WIN, window_spans  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.convert import state_to_numpy  # noqa: E402
from zipkin_tpu_torch.store.pipeline import IngestUnit  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402

PIPE_METRICS = ("zipkin_store_pipeline_encode_seconds",
                "zipkin_store_pipeline_stage_seconds",
                "zipkin_store_pipeline_commit_seconds",
                "zipkin_store_pipeline_prefetch_depth",
                "zipkin_store_pipeline_stall_seconds_total",
                "zipkin_store_pipeline_units_total")


def _port_spans():
    return [_convert(s, PORT) for s in window_spans()]


def _store(layout="ring", **kw):
    return TorchSpanStore(tdev.StoreConfig(**WIN, **LAYOUTS[layout]),
                          device="cpu", registry=obs.Registry(), **kw)


def _assert_bitwise(a: TorchSpanStore, b: TorchSpanStore):
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    for k, v in sa.items():
        if k == "counters":
            assert {c: int(x) for c, x in v.items()} == {
                c: int(x) for c, x in sb[k].items()}
        else:
            assert v.dtype == sb[k].dtype, k
            np.testing.assert_array_equal(v, sb[k], err_msg=k)
    for x, y in zip(a.sketch_mirror.arrays(), b.sketch_mirror.arrays()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_port_pipelined_equals_serial_bitwise(layout):
    applies = _port_spans()
    serial = _store(layout)
    for spans in applies:
        serial.apply(spans)
    piped = _store(layout)
    with piped.pipelined(depth=3) as pipe:
        for spans in applies:
            piped.apply(spans)
        piped.drain_pipeline()
        assert pipe.c_units.value >= len(applies)
        assert (piped.counter_block()["spans_seen"]
                == serial.counter_block()["spans_seen"])
    assert piped.ingest_pipeline() is None
    _assert_bitwise(serial, piped)
    assert piped.counters()["window_spans"] == \
        serial.counters()["window_spans"] > 0


def test_port_pipelined_equals_jax_serial():
    applies = window_spans()
    ref = TpuSpanStore(dev.StoreConfig(**WIN))
    for spans in applies:
        ref.apply(spans)
    port = _store()
    port.start_pipeline(4)
    for spans in applies:
        port.apply(_convert(spans, PORT))
    port.stop_pipeline()
    assert_states_equal(jax_leaves(ref.state), state_to_numpy(port.state))
    for got, want in zip(port.sketch_mirror.arrays(),
                         ref.sketch_mirror.arrays()):
        np.testing.assert_array_equal(got, want)
    assert (port.windowed_quantiles("wsvc1", [0.5, 0.99])
            == ref.windowed_quantiles("wsvc1", [0.5, 0.99]))


def test_port_pipeline_lifecycle():
    applies = _port_spans()[:3]
    store = _store()
    pipe = store.start_pipeline(2)
    with pytest.raises(RuntimeError, match="already running"):
        store.start_pipeline(2)
    assert store.ingest_pipeline() is pipe
    batch = store.codec.encode(applies[0][:8])
    with pytest.raises(RuntimeError, match="pipeline"):
        store.write_batch(batch, np.ones(8, bool))
    for spans in applies[:2]:
        store.apply(spans)
    store.drain_pipeline()
    # Reads after a drain see every accepted span.
    n = sum(len(s) for s in applies[:2])
    assert store.counter_block()["spans_seen"] == n
    assert store.counters()["pipeline_prefetch_depth"] == 0
    assert store.windowed_quantiles("wsvc0", [0.5]) is not None
    store.stop_pipeline()
    assert store.ingest_pipeline() is None
    with pytest.raises(RuntimeError, match="stopped"):
        pipe.feed(IngestUnit(None, 0, 0, 0, 1, False))
    # Serial again: write_batch and apply commit inline.
    store.write_batch(batch, np.ones(8, bool))
    store.apply(applies[2])
    assert store.counter_block()["spans_seen"] == n + 8 + len(applies[2])
    store.stop_pipeline()  # no pipeline: a no-op
    store.close()


def test_port_pipeline_fault_parks_and_pipeline_continues(monkeypatch):
    applies = _port_spans()[:3]
    store = _store()
    steps = tdev.ingest_steps
    faults = []

    def flaky(state, batches):
        if not faults:
            faults.append(len(batches))
            raise RuntimeError("step exploded")
        return steps(state, batches)

    monkeypatch.setattr(tdev, "ingest_steps", flaky)
    store.start_pipeline(2)
    store.apply(applies[0])  # one unit: the faulted one
    with pytest.raises(RuntimeError, match="step exploded"):
        store.drain_pipeline()
    # Surfaced once: the next drain and feed go through.
    store.apply(applies[1])
    store.drain_pipeline()
    store.apply(applies[2])
    store.stop_pipeline()
    assert faults == [8]
    # The faulted unit's spans were dropped, host clocks untouched.
    n = len(applies[1]) + len(applies[2])
    assert store.counter_block()["spans_seen"] == n
    assert store._wp == n
    st = state_to_numpy(store.state)
    np.testing.assert_array_equal(store.sketch_mirror.arrays()[7],
                                  st["win_counts"])


def test_port_pipeline_error_surfaces_on_next_feed(monkeypatch):
    applies = _port_spans()[:2]
    store = _store()
    store.start_pipeline(2)
    monkeypatch.setattr(tdev, "ingest_steps", lambda *a: 1 / 0)
    store.apply(applies[0])
    pipe = store.ingest_pipeline()
    pipe._wait_idle()
    monkeypatch.undo()
    with pytest.raises(ZeroDivisionError):
        store.apply(applies[1])  # the parked error fails this caller
    store.apply(applies[1])
    store.stop_pipeline()
    assert store.counter_block()["spans_seen"] == len(applies[1])


def test_port_pipeline_metrics_in_registry():
    reg = obs.Registry()
    store = TorchSpanStore(tdev.StoreConfig(**WIN), device="cpu",
                           registry=reg)
    store.start_pipeline(3)
    for spans in _port_spans()[:2]:
        store.apply(spans)
    store.drain_pipeline()
    d = reg.as_dict()
    assert d["zipkin_store_pipeline_encode_seconds_count"] == 2
    assert d["zipkin_store_pipeline_stage_seconds_count"] == \
        d["zipkin_store_pipeline_commit_seconds_count"] == \
        d["zipkin_store_pipeline_units_total"] >= 2
    assert d["zipkin_store_pipeline_prefetch_depth"] == 0
    assert all(reg.get(m) is not None for m in PIPE_METRICS)
    store.stop_pipeline()
    assert all(reg.get(m) is None for m in PIPE_METRICS)


def test_port_pipeline_concurrent_writers():
    """Six writer threads (more than the two torch threads and the
    stage and commit workers) feed one pipeline with a short switch
    interval: every span lands once, and the mirror stays equal to the
    device leaves."""
    applies = _port_spans()
    store = _store()
    store.start_pipeline(2)
    errors = []

    def writer(k):
        try:
            for spans in applies[k::6]:
                store.apply(spans)
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    store.stop_pipeline()
    assert not errors
    n = sum(len(s) for s in applies)
    assert store.counter_block()["spans_seen"] == n
    st = state_to_numpy(store.state)
    names = ("svc_hist", "ann_svc_counts", "name_presence",
             "ann_value_counts", "bann_key_counts", "hll_traces",
             "win_epoch", "win_counts", "win_sums", "win_mm")
    for name, got in zip(names, store.sketch_mirror.arrays()):
        np.testing.assert_array_equal(got, st[name], err_msg=name)


def test_port_staging_packs_every_column():
    """Stage 2's packing (on the card: one pinned buffer, one copy),
    checked on the CPU: the views of the packed buffer are the columns,
    value and dtype, for a chained unit of padded batches."""
    store = _store("paged")
    spans = _port_spans()[0]
    store.start_pipeline(2)
    units = []
    feed = store._pipeline.feed
    store._pipeline.feed = lambda u: units.append(u) or feed(u)
    store.apply(spans)
    store.stop_pipeline()
    unit = units[0]
    assert unit.chained
    dbs = tdev.unstack_batches(unit.db)
    cols = tdev.staging_columns(dbs)
    packed = np.concatenate([a.reshape(-1).view(np.uint8)
                             for _, _, a in cols])
    offs = np.cumsum([0] + [a.nbytes for _, _, a in cols])
    assert all(o % a.dtype.itemsize == 0
               for o, (_, _, a) in zip(offs, cols))
    views = tdev.staged_views(dbs, cols, torch.from_numpy(packed))
    for db, v in zip(dbs, views):
        want = tdev.batch_to_device(db, "cpu")
        for f in tdev.DeviceBatch._fields:
            a, b = getattr(want, f), getattr(v, f)
            if torch.is_tensor(a):
                assert a.dtype == b.dtype and torch.equal(a, b), f
            else:
                assert a == b, f
