"""The port's store against the JAX reference, on the CPU.

Step level: the same padded batches go through
``zipkin_tpu.store.device.ingest_step``/``ingest_steps`` and the port's,
from one warmed state carried across with ``state_from_numpy``; every
integer leaf must stay bitwise equal after every step. The float32
dependency leaves (``dep_window``, ``dep_moments``, ``dep_banks``)
compare with the count field exact and the other fields within
rtol=1e-5 of the field's largest magnitude: their central moments are
float32 sums taken in another order, and m3/m4 cancel.

Store level: ``TorchSpanStore(device="cpu")`` against ``TpuSpanStore``
on the same spans, every read API equal, and the SPI conformance suite.
"""

import dataclasses
import enum

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from zipkin_tpu.columnar.encode import SpanCodec  # noqa: E402
from zipkin_tpu.models import dependencies as ref_deps  # noqa: E402
from zipkin_tpu.models import span as ref_span  # noqa: E402
from zipkin_tpu.store import base as ref_base  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.base import should_index  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore, name_lc_ids  # noqa: E402
from zipkin_tpu.testing import conformance  # noqa: E402
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu_torch.models import dependencies as port_deps  # noqa: E402
from zipkin_tpu_torch.models import span as port_span  # noqa: E402
from zipkin_tpu_torch.store import base as port_base  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.convert import (  # noqa: E402
    state_from_numpy,
    state_to_numpy,
)
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402

# The scripts/bench_smoke.py WAL-phase geometry.
SMALL = dict(capacity=1 << 10, ann_capacity=1 << 12, bann_capacity=1 << 11,
             max_services=32, max_span_names=128, max_annotation_values=256,
             max_binary_keys=64, cms_width=1 << 10, hll_p=8,
             quantile_buckets=512)
FLOAT_LEAVES = ("dep_window", "dep_moments", "dep_banks")


def jax_leaves(state):
    st = jax.device_get(state)
    return {f: getattr(st, f) for f in dev.StoreState._FIELDS}


def moments_close(ref, got) -> bool:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    scale = np.abs(ref).reshape(-1, ref.shape[-1]).max(0)
    return (np.array_equal(ref[..., 0], got[..., 0])
            and bool(np.all(np.abs(ref - got)
                            <= 1e-5 * (np.abs(ref) + scale))))


def assert_states_equal(ref, got, where=""):
    for k in dev.StoreState._FIELDS:
        if k == "counters":
            assert {c: int(v) for c, v in ref[k].items()} == {
                c: int(v) for c, v in got[k].items()}, where
        elif k in FLOAT_LEAVES:
            assert moments_close(ref[k], got[k]), (k, where)
        else:
            a, b = np.asarray(ref[k]), np.asarray(got[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (k, where)
            assert np.array_equal(a, b), (k, int((a != b).sum()), where)


def _pow2(n: int) -> int:
    return 1 << max(6, (max(n, 1) - 1).bit_length())


def padded_batches(n_traces: int, chunk: int, seed: int):
    """Shuffled generate_traces spans (children often arrive before
    their parents) encoded and padded, chunk by chunk."""
    codec = SpanCodec()
    cache = {}
    rng = np.random.default_rng(seed)
    traces = generate_traces(n_traces=n_traces, max_depth=3, n_services=16,
                             rng=rng)
    spans = [s for t in traces for s in t]
    spans = [spans[i] for i in rng.permutation(len(spans))]
    out = []
    for i in range(0, len(spans), chunk):
        part = spans[i:i + chunk]
        b = codec.encode(part)
        ix = np.array([should_index(s) for s in part])
        out.append((b, name_lc_ids(b, codec.dicts, cache), ix))
    return out


def to_port(db):
    return tdev.DeviceBatch(**db._asdict())


@pytest.mark.parametrize("rank_path,use_kernels", [
    ("auto", False), ("counting", True), ("counting", False)])
def test_ingest_steps_match_reference(rank_path, use_kernels):
    """Laps every ring, overflows index buckets inside one batch, leaves
    children pending across sweeps and closes dependency buckets; the
    state stays equal to the reference's after every launch."""
    cfg = dev.StoreConfig(**SMALL, rank_path=rank_path)
    tcfg = tdev.StoreConfig(**SMALL, rank_path=rank_path,
                            use_pallas=use_kernels)
    parts = padded_batches(1900, 160, seed=7)
    jst = dev.init_state(cfg)
    # Warm the reference a little so the carried state is non-trivial.
    for b, lc, ix in parts[:3]:
        jst = dev.ingest_step(jst, dev.make_device_batch(
            b, lc, ix, _pow2(b.n_spans), _pow2(b.n_annotations),
            _pow2(b.n_binary)))
    tst = state_from_numpy(tcfg, jax_leaves(jst), device="cpu")
    svc_depth = cfg.svc_depth
    overflowed = pending_swept = False
    i = 3
    step = 0
    while i < len(parts):
        step += 1
        group = parts[i:i + 4] if step % 3 == 0 else parts[i:i + 1]
        i += len(group)
        pad = [_pow2(max(getattr(b, a) for b, _, _ in group))
               for a in ("n_spans", "n_annotations", "n_binary")]
        dbs = [dev.make_device_batch(b, lc, ix, *pad) for b, lc, ix in group]
        for b, _, _ in group:
            counts = np.bincount(b.ann_service_id[b.ann_service_id >= 0])
            overflowed |= bool(counts.max(initial=0) > svc_depth)
        if len(dbs) == 1:
            jst = dev.ingest_step(jst, dbs[0])
            tdev.ingest_step(tst, tdev.batch_to_device(to_port(dbs[0]),
                                                       "cpu"))
        else:
            stacked = dev.stack_device_batches(dbs)
            jst = dev.ingest_steps(jst, stacked)
            tdev.ingest_steps(tst, [
                tdev.batch_to_device(b, "cpu")
                for b in tdev.unstack_batches(to_port(stacked))])
        if step % 4 == 0:
            before = int(np.count_nonzero(np.asarray(jst.pend_key) & 1))
            jst = dev.dep_sweep(jst)
            tdev.dep_sweep(tst)
            after = int(np.count_nonzero(np.asarray(jst.pend_key) & 1))
            pending_swept |= before > after > 0
        if step % 7 == 0:
            jst = dev.dep_close_bucket(jst)
            tdev.dep_close_bucket(tst)
        assert_states_equal(jax_leaves(jst), state_to_numpy(tst),
                            f"step {step}")
    ref = jax_leaves(jst)
    assert int(ref["write_pos"]) > 2 * cfg.capacity
    assert int(ref["ann_write_pos"]) > 2 * cfg.ann_capacity
    assert int(ref["bann_write_pos"]) > 2 * cfg.bann_capacity
    assert overflowed, "no batch overflowed a service bucket"
    assert pending_swept, "no sweep resolved some and kept other children"
    assert int(ref["dep_bank_seq"]) >= 1
    assert int(ref["counters"]["sweeps"]) >= 1
    np.testing.assert_array_equal(
        tdev.counter_block(tst).numpy(), np.asarray(dev.counter_block(jst)))


def test_step_claims_only_in_range_buckets(monkeypatch):
    """Every valid index row the step hands the arena claim lies in [0,
    n_buckets) (seg() clips), so the claim's rule for a valid row out of
    that range (ranked and counted as invalid) never applies."""
    seen = []
    claim = tdev.K.arena_claim

    def checked(bucket, valid, n_buckets):
        b = bucket[valid]
        assert bool(((b >= 0) & (b < n_buckets)).all())
        seen.append(int(valid.sum()))
        return claim(bucket, valid, n_buckets)

    monkeypatch.setattr(tdev.K, "arena_claim", checked)
    tst = tdev.init_state(tdev.StoreConfig(**SMALL, use_pallas=True),
                          device="cpu")
    parts = padded_batches(300, 160, seed=3)[:6]
    for b, lc, ix in parts:
        db = dev.make_device_batch(b, lc, ix, _pow2(b.n_spans),
                                   _pow2(b.n_annotations), _pow2(b.n_binary))
        tdev.ingest_step(tst, tdev.batch_to_device(to_port(db), "cpu"))
    assert len(seen) == len(parts) and min(seen) > 0


def test_state_roundtrip_and_plane_order():
    cfg = dev.StoreConfig(**SMALL)
    leaves = jax_leaves(dev.init_state(cfg))
    leaves["span_tab"] = np.asarray(jax.lax.bitcast_convert_type(
        np.arange(-5, cfg.tab_slots - 5, dtype=np.int64), np.int32))
    st = state_from_numpy(tdev.StoreConfig(**SMALL), leaves, device="cpu")
    back = state_to_numpy(st)
    assert_states_equal(leaves, back)
    # int64.view(int32) gives the (lo, hi) plane order of
    # jax.lax.bitcast_convert_type.
    x = np.array([1, -2, 2**40 + 7, -(2**63)], np.int64)
    np.testing.assert_array_equal(
        tdev._p32(torch.from_numpy(x)).numpy(),
        np.asarray(jax.lax.bitcast_convert_type(x, np.int32)))
    np.testing.assert_array_equal(
        tdev._p64(tdev._p32(torch.from_numpy(x))).numpy(), x)


def test_unported_layouts_raise():
    """Both layouts and the windowed arena are ported; what the reference
    refuses, the port refuses too."""
    paged = tdev.StoreConfig(layout="paged", page_rows=128)
    assert paged.paged_enabled and paged.n_pages == paged.capacity // 128
    win = tdev.StoreConfig(window_seconds=60, window_buckets=64)
    ref = dev.StoreConfig(window_seconds=60, window_buckets=64)
    assert win.window_enabled and (win.win_slots, win.window_us,
                                   win.win_x_shift) == (
        ref.win_slots, ref.window_us, ref.win_x_shift)
    assert tdev.StoreConfig().win_slots == dev.StoreConfig().win_slots == 1
    with pytest.raises(ValueError, match="layout"):
        tdev.StoreConfig(layout="columnar")


# ---------------------------------------------------------------------------
# Store level
# ---------------------------------------------------------------------------


def _convert(obj, modules):
    """Rebuild span-model and result objects (and their parts) as the
    same-named class of ``modules``, so the two packages' objects
    compare."""
    if isinstance(obj, (list, tuple, set)):
        return type(obj)(_convert(o, modules) for o in obj)
    if isinstance(obj, enum.Enum) or dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        cls = next(getattr(m, name) for m in modules if hasattr(m, name))
        if isinstance(obj, enum.Enum):
            return cls(obj.value)
        return cls(**{f.name: _convert(getattr(obj, f.name), modules)
                      for f in dataclasses.fields(obj)})
    return obj


REF = (ref_span, ref_base, ref_deps)
PORT = (port_span, port_base, port_deps)


class _RefSpanAdapter:
    """The port store behind the reference's classes: spans go in as
    port objects and every result comes back as reference objects."""

    def __init__(self, store):
        self._s = store

    def apply(self, spans):
        self._s.apply(_convert(list(spans), PORT))

    def __getattr__(self, name):
        attr = getattr(self._s, name)
        if not callable(attr):
            return attr
        return lambda *a, **kw: _convert(attr(*a, **kw), REF)


def test_conformance_suite():
    conformance.run_all(lambda: _RefSpanAdapter(TorchSpanStore(
        tdev.StoreConfig(**SMALL), device="cpu")))


def _links(deps):
    return sorted((l.parent, l.child, l.duration_moments) for l in deps.links)


def test_store_reads_match_reference():
    rng = np.random.default_rng(3)
    traces = generate_traces(n_traces=900, max_depth=3, n_services=12,
                             rng=rng)
    spans = [s for t in traces for s in t]
    ref = TpuSpanStore(dev.StoreConfig(**SMALL))
    port = _RefSpanAdapter(TorchSpanStore(tdev.StoreConfig(**SMALL),
                                          device="cpu"))
    for i in range(0, len(spans), 150):
        ref.apply(spans[i:i + 150])
        port.apply(spans[i:i + 150])
    assert port.counter_block() == ref.counter_block()
    assert port.counter_block()["ring_laps"] >= 2
    assert_reads_match(ref, port, traces)


def assert_reads_match(ref, port, traces):
    """Every read API of the port store (behind _RefSpanAdapter) equal to
    the reference store's, after both took the same spans."""
    services = sorted(ref.get_all_service_names())
    assert services and port.get_all_service_names() == set(services)
    end = 2**62
    queries = []
    for svc in services:
        assert port.get_span_names(svc) == ref.get_span_names(svc)
        names = sorted(ref.get_span_names(svc))[:2]
        for name in [None] + names:
            for limit in (3, 10, 50):
                a = ref.get_trace_ids_by_name(svc, name, end, limit)
                assert port.get_trace_ids_by_name(svc, name, end,
                                                  limit) == a
                queries.append(("name", svc, name, end, limit))
        for ann, val in (("some custom annotation", None),
                         ("http.uri", b"/api/widgets"), ("http.uri", None)):
            a = ref.get_trace_ids_by_annotation(svc, ann, val, end, 10)
            assert port.get_trace_ids_by_annotation(svc, ann, val, end,
                                                    10) == a
            queries.append(("annotation", svc, ann, val, end, 10))
        assert (port.service_duration_quantiles(svc, [0.5, 0.99])
                == ref.service_duration_quantiles(svc, [0.5, 0.99]))
        assert port.top_annotations(svc) == ref.top_annotations(svc)
        assert port.top_binary_keys(svc) == ref.top_binary_keys(svc)
    assert any(ref.get_trace_ids_by_name(s, None, end, 10)
               for s in services)
    assert port.get_trace_ids_multi(queries) == ref.get_trace_ids_multi(
        queries)
    tids = [t[0].trace_id for t in traces[-60:]] + [12345]
    assert port.get_spans_by_trace_ids(tids) == ref.get_spans_by_trace_ids(
        tids)
    assert port.get_spans_by_trace_ids(tids, force_scan=True) == \
        ref.get_spans_by_trace_ids(tids, force_scan=True)
    assert port.traces_exist(tids) == ref.traces_exist(tids)
    assert port.get_traces_duration(tids) == ref.get_traces_duration(tids)
    old = [t[0].trace_id for t in traces[:40]]
    assert port.get_spans_by_trace_ids(old) == ref.get_spans_by_trace_ids(
        old)
    assert port.get_traces_duration(old) == ref.get_traces_duration(old)
    assert ref.get_dependencies().links, "no dependency links"
    for window in ((None, None), (0, 2**62), (0, 1)):
        a = _links(ref.get_dependencies(*window))
        b = _links(port.get_dependencies(*window))
        assert [x[:2] for x in a] == [x[:2] for x in b]
        for (_, _, ma), (_, _, mb) in zip(a, b):
            assert ma.n == mb.n
            assert mb.mean == pytest.approx(ma.mean, rel=1e-5)
    # float32 HLL sum (reference) vs float64 (port).
    assert port.estimated_unique_traces() == pytest.approx(
        ref.estimated_unique_traces(), rel=1e-5)
    assert port.counter_block() == ref.counter_block()


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSpanStore(tdev.StoreConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA"):
        tdev.init_state(tdev.StoreConfig(**SMALL))
