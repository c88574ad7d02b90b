"""The port's windowed Moments-sketch arena and host sketch mirror
against the JAX reference, on the CPU.

One drive a layout, shared by the tests below (module fixtures): the
same spans go through ``TpuSpanStore`` and ``TorchSpanStore(device=
"cpu")`` with the daemon's arena on (60 s buckets; 8 ring slots here),
as 256-span ``apply`` calls of 32-span chunks, so every launch unit is
chained (8 chunks on the ring, 4 on a paged store). The drive crosses
28 buckets (the slot ring laps three times), carries late rows (older
than their slot's epoch), in-batch ring wraps, spans without a duration
or a timestamp, and error spans of both conventions (an "error"
annotation and an "error" binary key).

Checked: every state leaf equal to the reference's (``win_*`` and the
other integer leaves bitwise, ``dep_*`` by stated tolerance 2), the
port's mirror equal to the reference's mirror and to the port's own
device leaves, the three windowed reads equal to the reference's, the
cold-mirror resync, layout independence of the mirror, and the port's
``hist_bucket_index`` against its device ``bucket_index`` and against
the reference's numpy twin (stated tolerance 1).
"""

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
from zipkin_tpu.models.span import (  # noqa: E402
    Annotation,
    BinaryAnnotation,
    Endpoint,
    Span,
)
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.archive import sketches as ref_sketches  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu_torch.aggregate import windows as twin  # noqa: E402
from zipkin_tpu_torch.ops import quantile as tq  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.archive import sketches as tsk  # noqa: E402
from zipkin_tpu_torch.store.convert import state_to_numpy  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402

BASE_US = 1_700_000_000_000_000
BUCKET_US = 60 * 1_000_000
WIN = dict(capacity=1 << 10, ann_capacity=1 << 12, bann_capacity=1 << 11,
           max_services=32, max_span_names=64, max_annotation_values=128,
           max_binary_keys=32, cms_width=1 << 10, hll_p=8,
           quantile_buckets=2048, window_seconds=60, window_buckets=8,
           batch_spans=32)
LAYOUTS = {"ring": {}, "paged": dict(layout="paged", page_rows=64)}
EPS = [Endpoint(0x0A000001 + i, 80, f"wsvc{i}") for i in range(5)]
SERVICES = [e.service_name for e in EPS]
N_APPLIES, APPLY_SPANS = 10, 256


def window_spans(seed: int = 11):
    """``N_APPLIES`` lists of 256 spans (64 traces of 4). Apply ``k``
    lands in buckets ``3k .. 3k + 2``; every 16th span is late (30
    buckets back), and one span of apply 4 is 8 buckets ahead (an
    in-batch ring wrap: its chunk's rows on that slot lose); 1 in 10 carries an "error" annotation, 1 in 17 an "error"
    binary key; 1 in 13 has no duration (one annotation), 1 in 29 no
    annotation at all. Every span has three annotations otherwise and
    one binary annotation, so each 32-span chunk pads to 128 annotation
    and 64 binary rows (one compiled shape a layout)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(N_APPLIES):
        spans = []
        for j in range(APPLY_SPANS):
            i = k * APPLY_SPANS + j
            ep = EPS[i % len(EPS)]
            bucket = 3 * k + int(rng.integers(0, 3))
            if i % 16 == 5:
                bucket = max(0, bucket - 30)
            elif i == 4 * APPLY_SPANS + 7:
                bucket += 8
            ts = BASE_US + bucket * BUCKET_US + int(rng.integers(0, BUCKET_US))
            dur = int(rng.lognormal(8.0, 1.5)) + 1
            if i % 29 == 11:
                anns = ()
            elif i % 13 == 4:
                anns = (Annotation(ts, "sr", ep),)
            else:
                anns = (Annotation(ts, "sr", ep),
                        Annotation(ts + dur // 2, "step", ep),
                        Annotation(ts + dur, "ss", ep))
            if i % 10 == 3 and anns:
                anns = anns[:-1] + (Annotation(ts + 1, "error", ep),) + \
                    anns[-1:]
            banns = (BinaryAnnotation("error" if i % 17 == 9 else "http.uri",
                                      b"/x", 6, ep),)
            spans.append(Span(1 + i // 4, f"op{i % 6}", 1 + i, None, anns,
                              banns))
        out.append(spans)
    return out


def _drive(layout: str):
    cfg = dict(WIN, **LAYOUTS[layout])
    ref = TpuSpanStore(dev.StoreConfig(**cfg))
    port = TorchSpanStore(tdev.StoreConfig(**cfg), device="cpu")
    for spans in window_spans():
        ref.apply(spans)
        port.apply(_convert(spans, PORT))
    return ref, port


@pytest.fixture(scope="module")
def ring():
    return _drive("ring")


@pytest.fixture(scope="module")
def paged():
    return _drive("paged")


@pytest.fixture(params=["ring", "paged"])
def drive(request):
    return request.getfixturevalue(request.param)


def test_window_drive_covers_its_cases(ring):
    ref, port = ring
    c = port.config
    assert c.window_enabled and c.win_slots == 8 and c.win_x_shift == 2
    assert int(ref.state.write_pos) > 2 * c.capacity
    # Folded rows: all but the late and wrap-losing ones.
    n = N_APPLIES * APPLY_SPANS
    spans_folded = port.counters()["window_spans"]
    assert 0.8 * n < spans_folded < n
    assert port.counters()["window_errors"] > 0
    epoch = port.sketch_mirror.win_epoch
    assert epoch.max() - epoch.min() == c.win_slots - 1
    assert epoch.min() > c.win_slots  # the slot ring lapped


def test_state_matches_reference(drive):
    """Every leaf after the drive, ``win_*`` bitwise, through chained
    units on both layouts."""
    ref, port = drive
    assert_states_equal(jax_leaves(ref.state), state_to_numpy(port.state),
                        port.config.layout)
    assert port.counter_block() == ref.counter_block()


def test_mirror_matches_reference_mirror(drive):
    ref, port = drive
    for got, want in zip(port.sketch_mirror.arrays(),
                         ref.sketch_mirror.arrays()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (port.sketch_mirror.win_spans_total
            == ref.sketch_mirror.win_spans_total)
    assert (port.sketch_mirror.win_errors_total
            == ref.sketch_mirror.win_errors_total)


def test_mirror_matches_own_device_leaves(drive):
    _, port = drive
    st = state_to_numpy(port.state)
    names = ("svc_hist", "ann_svc_counts", "name_presence",
             "ann_value_counts", "bann_key_counts", "hll_traces",
             "win_epoch", "win_counts", "win_sums", "win_mm")
    for name, got in zip(names, port.sketch_mirror.arrays()):
        assert got.dtype == st[name].dtype, name
        np.testing.assert_array_equal(got, st[name], err_msg=name)


def test_port_mirror_same_on_both_layouts(ring, paged):
    for a, b in zip(ring[1].sketch_mirror.arrays(),
                    paged[1].sketch_mirror.arrays()):
        np.testing.assert_array_equal(a, b)


def test_windowed_reads_match_reference(drive):
    ref, port = drive
    last = int(port.sketch_mirror.win_epoch.max())
    windows = [(None, None),
               ((last - 3) * BUCKET_US + 17, (last + 1) * BUCKET_US - 5),
               (BASE_US, BASE_US + 2 * BUCKET_US)]
    served = 0
    for svc in SERVICES + ["nope"]:
        for start, end in windows:
            want = ref.windowed_quantiles(svc, [0.5, 0.9, 0.99], start, end)
            assert port.windowed_quantiles(svc, [0.5, 0.9, 0.99], start,
                                           end) == want
            served += want is not None
            assert port.latency_heatmap(svc, start, end, bands=6) == \
                ref.latency_heatmap(svc, start, end, bands=6)
        for now in (None, (last + 1) * BUCKET_US):
            want = ref.slo_burn(svc, windows_s=[60, 300, 3600], now_us=now)
            assert port.slo_burn(svc, windows_s=[60, 300, 3600],
                                 now_us=now) == want
    assert served >= len(SERVICES)
    burn = port.slo_burn(SERVICES[0], windows_s=[3600])
    assert burn["windows"][0]["errors"] > 0


def test_cold_mirror_resyncs_from_device(ring):
    _, port = ring
    want = port.sketch_mirror.arrays()
    port.sketch_mirror.mark_cold()
    assert not port.sketch_mirror.warm
    m = port.ensure_sketch_mirror()
    assert m.warm
    for got, w in zip(m.arrays(), want):
        np.testing.assert_array_equal(got, w)


def test_window_off_store_still_serves():
    cfg = dict(WIN, window_seconds=0)
    ref = TpuSpanStore(dev.StoreConfig(**cfg))
    port = TorchSpanStore(tdev.StoreConfig(**cfg), device="cpu")
    spans = window_spans()[0]
    ref.apply(spans)
    port.apply(_convert(spans, PORT))
    assert not port.config.window_enabled
    assert port.state.win_counts.shape == (32, 1, 3)
    assert port.windowed_quantiles(SERVICES[0], [0.5]) is None
    assert port.slo_burn(SERVICES[0]) is None
    assert port.latency_heatmap(SERVICES[0]) is None
    assert port.counters()["window_spans"] == 0
    assert (port.service_duration_quantiles(SERVICES[0], [0.5, 0.99])
            == ref.service_duration_quantiles(SERVICES[0], [0.5, 0.99]))
    assert_states_equal(jax_leaves(ref.state), state_to_numpy(port.state))
    for got, want in zip(port.sketch_mirror.arrays()[:6],
                         ref.sketch_mirror.arrays()[:6]):
        np.testing.assert_array_equal(got, want)


def _edge_values(n_buckets: int, gamma: float) -> np.ndarray:
    """Every float32 within 2 ulp of each bucket edge gamma^k."""
    edges = (gamma ** np.arange(n_buckets)).astype(np.float32)
    out = [edges]
    up = dn = edges
    for _ in range(2):
        up = np.nextafter(up, np.float32(np.inf))
        dn = np.nextafter(dn, np.float32(0))
        out += [up, dn]
    v = np.concatenate(out)
    return v[np.isfinite(v)]


@pytest.mark.parametrize("n_buckets,alpha", [(2048, 0.01), (512, 0.01),
                                             (256, 0.05)])
def test_hist_bucket_index_is_the_device_bucket_index(n_buckets, alpha):
    gamma = (1 + alpha) / (1 - alpha)
    v = _edge_values(n_buckets, gamma)
    rng = np.random.default_rng(8)
    v = np.concatenate([v, np.arange(-3, 5000, dtype=np.float32),
                        rng.integers(0, 2**40, 50_000).astype(np.float32)])
    got = tsk.hist_bucket_index(v, n_buckets, gamma)
    want = tq.bucket_index(torch.from_numpy(v), n_buckets, gamma).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # The window cells' x through both routes.
    d = rng.integers(-1, 2**32, 20_000)
    x_host = twin.duration_x(d, n_buckets, gamma)
    x_dev = (tq.bucket_index(torch.from_numpy(d), n_buckets, gamma)
             >> twin.win_x_shift(n_buckets)).numpy()
    np.testing.assert_array_equal(x_host, x_dev)


def test_hist_bucket_index_against_reference_twin():
    """2,000,000 random integer durations: the port's index equals the
    JAX package's numpy twin wherever that twin's float32 log is the
    correctly rounded one; elsewhere it may be one bucket over (stated
    tolerance 1), which happens for a handful of values."""
    gamma = (1 + 0.01) / (1 - 0.01)
    rng = np.random.default_rng(21)
    d = np.concatenate([rng.integers(0, 2**40, 1_000_000),
                        rng.lognormal(11.0, 2.0, 1_000_000).astype(np.int64)])
    got = tsk.hist_bucket_index(d, 2048, gamma)
    want = ref_sketches.hist_bucket_index(d, 2048, gamma)
    vm = np.maximum(d.astype(np.float32), np.float32(1))
    ref_log = np.log(vm)
    cr_log = np.log(vm.astype(np.float64)).astype(np.float32)
    differ = got != want
    assert np.all(ref_log[differ] != cr_log[differ])
    assert np.all(np.abs(got.astype(np.int64) - want) <= 1)
    assert differ.sum() <= 20
    # The hash twins are the reference's, bit for bit.
    hi = rng.integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)
    for seed in (101, 202):
        np.testing.assert_array_equal(tsk.np_hash2_32(hi, lo, seed),
                                      ref_sketches.np_hash2_32(hi, lo, seed))
    h = tsk.np_hash2_32(hi, lo, 7)
    np.testing.assert_array_equal(tsk.np_clz32(h), ref_sketches.np_clz32(h))
