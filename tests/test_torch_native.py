"""The port's native span codec (``zipkin_tpu_torch/native.py`` over its
own ``csrc/span_codec.cc``) and ``TorchSpanStore.write_thrift`` against
the JAX package, on the CPU (g++ builds the codec on both machines).

Exact equality throughout: every column of ``parse_spans_columnar`` and
``parse_spans_columnar_sampled`` (thresholds 0, mid and ``LONG_MAX``;
``LONG_MIN`` trace ids; debug spans), the dropped and kept-debug counts,
every dictionary, ``indexable_from_batch``, the errors (malformed input,
``ParseCapacityError``) and ``base64_decode``. ``write_thrift`` returns
the reference's tuple and leaves a state equal to ``TpuSpanStore``'s
under the step-state rules of tests/test_torch_store.py (integer leaves
bitwise, the float32 moments by stated tolerance 2); a tiered store's
``write_thrift`` seals the reference's segments.
"""

import base64

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_archive import CFG, PARAMS, make_trace  # noqa: E402
from test_native import spans_fixture  # noqa: E402
from test_torch_archive import assert_segments_match, port_tiered  # noqa: E402
from test_torch_store import (  # noqa: E402
    SMALL,
    assert_states_equal,
    jax_leaves,
)
from zipkin_tpu import native as ref_native  # noqa: E402
from zipkin_tpu.columnar.dictionary import (  # noqa: E402
    DictionarySet as RefDicts,
)
from zipkin_tpu.models.span import Annotation, Endpoint, Span  # noqa: E402
from zipkin_tpu.sampler.core import rate_to_threshold  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.archive import (  # noqa: E402
    TieredSpanStore as RefTiered,
)
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu.wire.thrift import span_to_bytes  # noqa: E402
from zipkin_tpu_torch import native  # noqa: E402
from zipkin_tpu_torch.columnar.dictionary import DictionarySet  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.convert import state_to_numpy  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402

LONG_MAX = (1 << 63) - 1
LONG_MIN = -(1 << 63)
DICTS = ("services", "span_names", "annotations", "binary_keys",
         "binary_values", "endpoints")
THRESHOLDS = {"zero": 0, "mid": rate_to_threshold(0.5),
              "long_max": LONG_MAX}
CLIENT = Endpoint(5, 5, "client")


def mixed_spans(seed: int = 7, n_traces: int = 60):
    """The reference's fixture spans, generated traces, ``LONG_MIN`` and
    ``LONG_MAX`` trace ids (debug and not), and client-side spans of the
    literal service "client"."""
    rng = np.random.default_rng(seed)
    traces = generate_traces(n_traces=n_traces, max_depth=3, n_services=8,
                             rng=rng)
    extra = [
        Span(trace_id=LONG_MIN, name="min", id=1,
             annotations=(Annotation(10, "sr", CLIENT),)),
        Span(trace_id=LONG_MIN, name="min-debug", id=2, parent_id=1,
             debug=True, annotations=(Annotation(11, "cs", CLIENT),)),
        Span(trace_id=LONG_MAX, name="MAX", id=3, debug=True),
        Span(trace_id=17, name="client-call", id=4,
             annotations=(Annotation(12, "cs", CLIENT),
                          Annotation(20, "cr", CLIENT))),
    ]
    spans = spans_fixture() + [s for t in traces for s in t] + extra
    return [spans[i] for i in rng.permutation(len(spans))]


def payload_of(spans):
    return b"".join(span_to_bytes(s) for s in spans)


def assert_dicts_equal(ref, port):
    for name in DICTS:
        assert list(getattr(port, name).items()) == list(
            getattr(ref, name).items()), name


def assert_batches_equal(ref, port):
    for col in ref.SPAN_COLUMNS + ref.ANN_COLUMNS + ref.BANN_COLUMNS:
        a, b = getattr(ref, col), getattr(port, col)
        assert a.dtype == b.dtype and np.array_equal(a, b), col


@pytest.mark.parametrize("threshold", sorted(THRESHOLDS))
def test_sampled_parse_matches_reference(threshold):
    payload = payload_of(mixed_spans())
    ref_d, port_d = RefDicts(), DictionarySet()
    want = ref_native.parse_spans_columnar_sampled(
        payload, ref_d, THRESHOLDS[threshold])
    got = native.parse_spans_columnar_sampled(
        payload, port_d, THRESHOLDS[threshold])
    assert_batches_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1])
    assert got[2:] == want[2:]
    assert_dicts_equal(ref_d, port_d)
    if threshold == "long_max":
        # Only debug spans survive; LONG_MIN maps to LONG_MAX, which is
        # not above a LONG_MAX threshold.
        assert got[0].n_spans == got[3] > 0
    if threshold == "zero":
        assert got[2] == 0


def test_parse_and_indexable_match_reference():
    payload = payload_of(mixed_spans(seed=8))
    ref_d, port_d = RefDicts(), DictionarySet()
    want, want_lc = ref_native.parse_spans_columnar(payload, ref_d)
    got, got_lc = native.parse_spans_columnar(payload, port_d)
    assert_batches_equal(want, got)
    assert np.array_equal(want_lc, got_lc)
    assert_dicts_equal(ref_d, port_d)
    ix = native.indexable_from_batch(got, port_d)
    assert np.array_equal(ix, ref_native.indexable_from_batch(want, ref_d))
    assert not ix.all()


@pytest.mark.parametrize("payload", [
    b"\xff\xff\xff",
    b"\xff\xfegarbage",
    span_to_bytes(spans_fixture()[0])[:37],
], ids=["bad_type", "garbage", "truncated"])
def test_malformed_raises_as_reference(payload):
    with pytest.raises(ValueError) as want:
        ref_native.parse_spans_columnar(payload, RefDicts())
    with pytest.raises(ValueError) as got:
        native.parse_spans_columnar(payload, DictionarySet())
    assert not isinstance(want.value, ref_native.ParseCapacityError)
    assert not isinstance(got.value, native.ParseCapacityError)


@pytest.mark.parametrize("spans,max_spans", [
    (lambda: spans_fixture(), 2),
    (lambda: [Span(trace_id=1, name="wide", id=1, annotations=tuple(
        Annotation(i, f"a{i}", CLIENT) for i in range(9)))], 1),
], ids=["spans", "annotations"])
def test_capacity_error_as_reference(spans, max_spans):
    payload = payload_of(spans())
    with pytest.raises(ref_native.ParseCapacityError):
        ref_native.parse_spans_columnar(payload, RefDicts(), max_spans)
    with pytest.raises(native.ParseCapacityError):
        native.parse_spans_columnar(payload, DictionarySet(), max_spans)
    # With room for them, both parse the same columns.
    n = len(spans()) + 1
    want, _ = ref_native.parse_spans_columnar(payload, RefDicts(), 2 * n)
    got, _ = native.parse_spans_columnar(payload, DictionarySet(), 2 * n)
    assert_batches_equal(want, got)


def test_base64_matches_reference():
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 3, 4, 255, 4096):
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        enc = base64.b64encode(raw)
        assert native.base64_decode(enc) == ref_native.base64_decode(enc)
        assert native.base64_decode(enc) == raw
    for bad in (b"!!!!", b"ab$d"):
        with pytest.raises(ValueError):
            ref_native.base64_decode(bad)
        with pytest.raises(ValueError):
            native.base64_decode(bad)


# ---------------------------------------------------------------------------
# write_thrift
# ---------------------------------------------------------------------------


def _stores():
    return (TpuSpanStore(dev.StoreConfig(**SMALL)),
            TorchSpanStore(tdev.StoreConfig(**SMALL), device="cpu"))


def _payloads(seed: int, n: int = 6):
    spans = mixed_spans(seed=seed, n_traces=120)
    step = -(-len(spans) // n)
    return [payload_of(spans[i:i + step]) for i in range(0, len(spans), step)]


@pytest.mark.parametrize("case", ["plain", "sampled", "pinned",
                                  "pipelined"])
def test_write_thrift_matches_reference(case):
    ref, port = _stores()
    threshold = rate_to_threshold(0.5) if case == "sampled" else 0
    payloads = _payloads(seed=11) + _payloads(seed=12)
    if case == "pinned":
        first = mixed_spans(seed=11, n_traces=120)
        pin = first[0].trace_id
        for s in (ref, port):
            s.write_thrift(payload_of(first[:1]))
            s.set_time_to_live(pin, 30 * 24 * 3600.0)
    if case == "pipelined":
        port.start_pipeline(4)
    for p in payloads:
        want = ref.write_thrift(p, sample_threshold=threshold)
        assert port.write_thrift(p, sample_threshold=threshold) == want
    if case == "pipelined":
        port.stop_pipeline()
    assert_states_equal(jax_leaves(ref.state), state_to_numpy(port.state),
                        case)
    assert port.counter_block() == ref.counter_block()
    assert_dicts_equal(ref.dicts, port.dicts)
    assert port.ttls == ref.ttls
    if case == "pinned":
        assert set(port.pins.tids()) == set(ref.pins.tids()) == {pin}
        assert sorted(map(repr, port.pins.get(pin))) == sorted(
            map(repr, ref.pins.get(pin)))


def test_tiered_write_thrift_seals_reference_segments():
    ref = RefTiered(TpuSpanStore(CFG), params=PARAMS)
    port = port_tiered()
    batch = []
    for tid in range(1, 2 * CFG.capacity // 2 + 1):
        batch.extend(make_trace(tid))
        if len(batch) >= 64:
            payload = payload_of(batch)
            assert port.write_thrift(payload) == ref.write_thrift(payload)
            batch = []
    ref.capture_now()
    port.capture_now()
    assert_segments_match(ref.archive.snapshot(), port.archive.snapshot())
