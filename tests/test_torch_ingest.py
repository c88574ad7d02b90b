"""The port's ingest front end (``zipkin_tpu_torch/ingest``: the item
queue, the collector, the Scribe receiver and server, the Kafka receiver
and sink) against the JAX package's, on the CPU.

The collector runs with ``concurrency=1``, so both packages process the
same queue items in the same order: the stored, dropped and bad
counters, the sampler's counts, the store state (integer leaves
bitwise, the float32 moments by stated tolerance 2) and every read
equal the reference collector's over ``TpuSpanStore``. Wire bytes (the
scribe frames, the Kafka messages) are byte-equal. The rest holds the
port alone to the reference's contracts: ``ItemQueue`` backpressure and
close, the receiver's result codes (``TRY_LATER`` on a full queue and
on ``WalDurabilityError``), a ``ScribeServer`` loopback drive (every
socket with its own timeout), the durable entries over the port's WAL
and the self-trace spans.
"""

import base64
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_store import (  # noqa: E402
    PORT,
    REF,
    SMALL,
    _convert,
    _links,
    assert_states_equal,
    jax_leaves,
    moments_close,
)
from zipkin_tpu import obs as ref_obs  # noqa: E402
from zipkin_tpu.ingest import kafka as ref_kafka  # noqa: E402
from zipkin_tpu.ingest import scribe_server as ref_scribe  # noqa: E402
from zipkin_tpu.ingest.collector import (  # noqa: E402
    Collector as RefCollector,
)
from zipkin_tpu.sampler.core import Sampler as RefSampler  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu.wire.thrift import span_to_bytes  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.ingest import (  # noqa: E402
    Collector,
    ItemQueue,
    QueueFullException,
    ResultCode,
    ScribeReceiver,
)
from zipkin_tpu_torch.ingest import kafka  # noqa: E402
from zipkin_tpu_torch.ingest import scribe_server  # noqa: E402
from zipkin_tpu_torch.sampler import Sampler  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.convert import state_to_numpy  # noqa: E402
from zipkin_tpu_torch.store.memory import InMemorySpanStore  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402
from zipkin_tpu_torch.wal import WriteAheadLog, recover  # noqa: E402
from zipkin_tpu_torch.wal.log import WalDurabilityError  # noqa: E402
from zipkin_tpu_torch.wire import thrift as port_wire  # noqa: E402

CORRUPT = b"\xff\xfecorrupt"
END = 2**62
SOCKET_TIMEOUT_S = 10.0


def traces(seed: int, n: int = 90):
    """Generated traces under uniform signed 64-bit trace ids (the
    generator's own ids are non-negative, below the sampler's mid
    threshold)."""
    rng = np.random.default_rng(seed)
    out = generate_traces(n_traces=n, max_depth=3, n_services=10, rng=rng)
    tids = rng.integers(-(1 << 63), (1 << 63) - 1, size=n, dtype=np.int64)
    return [[dataclasses.replace(s, trace_id=int(tid)) for s in t]
            for t, tid in zip(out, tids)]


def items_of(seed: int):
    """Queue items in three shapes: Span lists, single thrift payloads
    and segment lists with one corrupt entry."""
    ts = traces(seed)
    out = []
    for i in range(0, len(ts), 10):
        spans = [s for t in ts[i:i + 10] for s in t]
        kind = (i // 10) % 3
        if kind == 0:
            out.append(("spans", spans))
        elif kind == 1:
            out.append(("thrift", b"".join(span_to_bytes(s) for s in spans)))
        else:
            segs = [span_to_bytes(s) for s in spans]
            segs.insert(len(segs) // 2, CORRUPT)
            out.append(("thrift", segs))
    return ts, out


def feed(collector, items, port: bool):
    for kind, item in items:
        if kind == "spans":
            collector.accept(_convert(item, PORT) if port else item)
        else:
            collector.accept_thrift(item)
    collector.flush()


def assert_same_traces(got, want):
    """Trace by trace, the same spans (their order within a trace may
    follow arrival, which two queue workers interleave)."""
    assert [sorted(map(repr, t)) for t in got] == [
        sorted(map(repr, t)) for t in want]
    assert want


def assert_links_close(want, got):
    """Dependency links: the same (parent, child) pairs and counts, the
    other moment fields within stated tolerance 2 (float32 sums in
    another order)."""
    assert [x[:2] for x in got] == [x[:2] for x in want] and want
    assert moments_close(
        np.array([dataclasses.astuple(m) for _, _, m in want]),
        np.array([dataclasses.astuple(m) for _, _, m in got]))


def _reads(store, ts):
    tids = [t[0].trace_id for t in ts]
    out = {"traces": store.get_spans_by_trace_ids(tids),
           "services": sorted(store.get_all_service_names()),
           "links": _links(store.get_dependencies())}
    out["by_name"] = [store.get_trace_ids_by_name(s, None, END, 20)
                      for s in out["services"]]
    return out


@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_collector_matches_reference(rate):
    ts, items = items_of(seed=int(rate * 10))
    ref_store = TpuSpanStore(dev.StoreConfig(**SMALL))
    ref = RefCollector(ref_store, sampler=RefSampler(rate), max_queue=64,
                       concurrency=1, registry=ref_obs.Registry())
    port_store = TorchSpanStore(tdev.StoreConfig(**SMALL), device="cpu")
    port = Collector(port_store, sampler=Sampler(rate), max_queue=64,
                     concurrency=1, registry=obs.Registry())
    feed(ref, items, port=False)
    feed(port, items, port=True)
    assert (port.spans_stored, port.spans_dropped, port.bad_payloads) == (
        ref.spans_stored, ref.spans_dropped, ref.bad_payloads)
    assert port.bad_payloads == len(items) // 3
    assert port.sampler.snapshot() == ref.sampler.snapshot()
    assert port.spans_stored > 0
    assert (port.spans_dropped > 0) == (rate < 1.0)
    assert_states_equal(jax_leaves(ref_store.state),
                        state_to_numpy(port_store.state))
    want = _reads(ref_store, ts)
    got = {k: _convert(v, REF) for k, v in _reads(port_store, ts).items()}
    assert_links_close(want.pop("links"), got.pop("links"))
    assert got == want
    assert want["traces"] and any(want["by_name"])
    ref.close()
    port.close()


# ---------------------------------------------------------------------------
# ItemQueue
# ---------------------------------------------------------------------------


def test_queue_processes_counts_and_drains_on_close():
    seen = []
    lock = threading.Lock()

    def work(i):
        if i % 10 == 0:
            raise RuntimeError("boom")
        with lock:
            seen.append(i)

    reg = obs.Registry()
    q = ItemQueue(work, max_size=500, concurrency=8, registry=reg)
    for i in range(400):
        q.add(i)
    q.join()
    assert q.errors == 40 and q.processed == 360
    for i in range(401, 451):
        q.add(i)
    q.close(timeout=5)
    assert len(seen) == 405
    with pytest.raises(QueueFullException):
        q.add(999)
    d = reg.as_dict()
    assert d["zipkin_queue_enqueued_total"] == 450
    assert d["zipkin_queue_rejected_total"] == 1


def test_queue_backpressure_and_gauges():
    reg = obs.Registry()
    gate = threading.Event()
    q = ItemQueue(lambda _: gate.wait(10), max_size=2, concurrency=1,
                  registry=reg)
    try:
        q.add("a")
        deadline = time.monotonic() + 5
        while q.active_workers < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        q.add("b")
        q.add("c")
        for _ in range(3):
            with pytest.raises(QueueFullException):
                q.add("d")
        d = reg.as_dict()
        assert d["zipkin_queue_depth"] == 2
        assert d["zipkin_queue_rejected_total"] == 3
        assert d["zipkin_queue_active_workers"] == 1
    finally:
        gate.set()
        q.close(timeout=5)
    assert q.processed == 3


# ---------------------------------------------------------------------------
# ScribeReceiver
# ---------------------------------------------------------------------------


def _entry(span):
    return ("zipkin", base64.b64encode(
        port_wire.span_to_bytes(span)).decode())


def _port_spans(n=3):
    return _convert([s for t in traces(3, n) for s in t], PORT)


@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
def test_receiver_result_codes(fast):
    spans = _port_spans()
    got = []

    def rx_of(fn):
        return (ScribeReceiver(lambda s: None, process_thrift=fn) if fast
                else ScribeReceiver(fn))

    rx = rx_of(got.append)
    entries = [_entry(s) for s in spans]
    assert rx.log(entries + [("other", entries[0][1])]) is ResultCode.OK
    assert rx.stats["ignored"] == 1 and rx.stats["received"] == len(spans) + 1
    if fast:
        assert got == [[port_wire.span_to_bytes(s) for s in spans]]
    else:
        assert got == [spans]
    rx.log([("zipkin", "!!!not-thrift!!!")])
    assert rx.stats["bad"] == 1

    def raise_(exc):
        def fn(_):
            raise exc
        return fn

    for exc in (QueueFullException("full"),
                WalDurabilityError("not durable"), RuntimeError("closing")):
        rx = rx_of(raise_(exc))
        assert rx.log(entries) is ResultCode.TRY_LATER, exc
        assert rx.stats["pushed_back"] == 1


class _GatedStore:
    """A write store whose ``apply`` blocks until released, so a
    collector's queue fills behind it."""

    def __init__(self):
        self.gate = threading.Event()
        self.spans = []

    def apply(self, spans):
        self.gate.wait(10)
        self.spans.extend(spans)

    def close(self):
        pass


def test_try_later_on_a_full_collector_queue():
    store = _GatedStore()
    col = Collector(store, max_queue=1, concurrency=1,
                    registry=obs.Registry())
    rx = ScribeReceiver(col.accept)
    spans = _port_spans(4)
    try:
        assert rx.log([_entry(spans[0])]) is ResultCode.OK
        deadline = time.monotonic() + 5
        while col.queue.active_workers < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert rx.log([_entry(spans[1])]) is ResultCode.OK
        assert rx.log([_entry(spans[2])]) is ResultCode.TRY_LATER
        assert col.queue.rejected == 1
    finally:
        store.gate.set()
        col.close()
    assert len(store.spans) == 2


# ---------------------------------------------------------------------------
# ScribeServer
# ---------------------------------------------------------------------------


def test_scribe_frames_match_reference():
    spans = _port_spans(4)
    entries = [_entry(s) for s in spans]
    frame = scribe_server.encode_log_call(entries, seqid=7)
    assert frame == ref_scribe.encode_log_call(entries, seqid=7)
    got = []
    rx = ScribeReceiver(got.extend)
    reply = scribe_server.handle_call(rx, frame[4:])
    ref_rx = ref_scribe.ScribeReceiver(lambda s: None)
    assert reply == ref_scribe.handle_call(ref_rx, frame[4:])
    assert scribe_server.decode_log_reply(reply) is ResultCode.OK
    assert got == spans
    bad = scribe_server.handle_call(rx, frame[4:].replace(b"Log", b"Nop", 1))
    assert bad == ref_scribe.handle_call(ref_rx,
                                         frame[4:].replace(b"Log", b"Nop", 1))
    with pytest.raises(port_wire.ThriftError):
        scribe_server.decode_log_reply(bad)


def test_scribe_server_loopback_into_the_port_store():
    ts = traces(5, 80)
    spans = _convert([s for t in ts for s in t], PORT)
    store = TorchSpanStore(tdev.StoreConfig(**SMALL), device="cpu")
    col = Collector(store, max_queue=32, concurrency=2,
                    registry=obs.Registry())
    rx = ScribeReceiver(col.accept, process_thrift=col.accept_thrift)
    server = scribe_server.ScribeServer(rx, host="127.0.0.1", port=0)
    server.serve_in_thread()
    host, port = server.server_address
    client = scribe_server.ScribeClient(host, port,
                                        timeout_s=SOCKET_TIMEOUT_S)
    try:
        entries = [_entry(s) for s in spans]
        entries.insert(7, ("zipkin", base64.b64encode(CORRUPT).decode()))
        for i in range(0, len(entries), 64):
            assert client.log(entries[i:i + 64]) is ResultCode.OK
        col.flush()
    finally:
        client.close()
        server.shutdown()
        server.server_close()
        col.close()
    assert col.spans_stored == len(spans) and col.bad_payloads == 1
    oracle = InMemorySpanStore()
    oracle.apply(spans)
    tids = sorted({s.trace_id for s in spans})
    assert_same_traces(store.get_spans_by_trace_ids(tids),
                       oracle.get_spans_by_trace_ids(tids))
    assert store.get_all_service_names() == oracle.get_all_service_names()


# ---------------------------------------------------------------------------
# Kafka
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,compress", [(False, False), (True, False),
                                            (True, True), (False, True)])
def test_kafka_sink_to_receiver_loop_matches_reference(batch, compress):
    ts = traces(7, 12)
    ref_spans = [s for t in ts for s in t]
    spans = _convert(ref_spans, PORT)
    sent, ref_sent = [], []
    sink = kafka.KafkaSpanSink(lambda t, v: sent.append((t, v)),
                               batch=batch, compress=compress)
    ref_sink = ref_kafka.KafkaSpanSink(lambda t, v: ref_sent.append((t, v)),
                                       batch=batch, compress=compress)
    sink.apply(spans)
    ref_sink.apply(ref_spans)
    assert sent == ref_sent and sink.stats == ref_sink.stats
    messages = [v for _, v in sent] + [bytes([kafka.FRAME_DEFLATE]) + b"xx"]
    for m in messages:
        try:
            want = ref_kafka.decode_frame(m)
        except ref_kafka.ThriftError:
            with pytest.raises(port_wire.ThriftError):
                kafka.decode_frame(m)
            continue
        assert kafka.decode_frame(m) == want
    got = []
    rx = kafka.KafkaSpanReceiver(got.extend, [messages])
    rx.run()
    assert got == spans and rx.stats["bad"] == 1
    # The fast path: the collector parses the same messages natively.
    store = TorchSpanStore(tdev.StoreConfig(**SMALL), device="cpu")
    col = Collector(store, concurrency=1, registry=obs.Registry())
    rx = kafka.KafkaSpanReceiver(col.accept, [messages],
                                 process_thrift=col.accept_thrift)
    rx.run()
    col.flush()
    assert col.spans_stored == len(spans)
    tids = sorted({s.trace_id for s in spans})
    oracle = InMemorySpanStore()
    oracle.apply(spans)
    assert_same_traces(store.get_spans_by_trace_ids(tids),
                       oracle.get_spans_by_trace_ids(tids))
    col.close()


def test_kafka_frame_codec_matches_reference():
    rng = np.random.default_rng(8)
    for n in (0, 1, 127, 128, 4000):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for compress in (False, True):
            enc = kafka.encode_frame(payload, compress)
            assert enc == ref_kafka.encode_frame(payload, compress)
            assert kafka.decode_frame(enc) == ref_kafka.decode_frame(enc)
    with pytest.raises(RuntimeError, match="kafka"):
        kafka.connect_kafka_python(lambda s: None, "localhost:9092")


# ---------------------------------------------------------------------------
# Durable entries and self-tracing
# ---------------------------------------------------------------------------


def test_durable_entries_over_the_port_wal(tmp_path):
    cfg = tdev.StoreConfig(**SMALL)
    store = TorchSpanStore(cfg, device="cpu")
    wal = WriteAheadLog(str(tmp_path / "wal"), registry=obs.Registry())
    store.attach_wal(wal)
    col = Collector(store, concurrency=1, registry=obs.Registry())
    ts, items = items_of(seed=9)
    stored = 0
    for kind, item in items:
        if kind == "spans":
            stored += col.ingest_durable(_convert(item, PORT))
        else:
            stored += col.ingest_thrift_durable(item)
    assert stored == col.spans_stored == sum(len(t) for t in ts)
    assert wal.last_seq > 0 and wal.durable_seq >= wal.last_seq
    rx = ScribeReceiver(col.ingest_durable,
                        process_thrift=col.ingest_thrift_durable)
    wal.wait_durable = lambda seq, timeout=None: False
    spans = _port_spans(2)
    assert rx.log([_entry(spans[0])]) is ResultCode.TRY_LATER
    del wal.wait_durable
    col.flush()
    want = state_to_numpy(store.state)
    wal.close()
    rec, stats = recover(None, WriteAheadLog(str(tmp_path / "wal"),
                                             registry=obs.Registry()),
                         fresh_store=lambda d: TorchSpanStore(cfg, device=d),
                         device="cpu")
    assert stats["replayed_records"] == wal.last_seq
    assert_states_equal(want, state_to_numpy(rec.state))


def test_self_trace_one_span_per_processed_item():
    store = TorchSpanStore(tdev.StoreConfig(**SMALL), device="cpu")
    col = Collector(store, concurrency=3, registry=obs.Registry(),
                    self_trace=True)
    col.SELF_TRACE_FLUSH = 8
    ts, items = items_of(seed=12)
    feed(col, items, port=True)
    n = col.queue.processed
    assert n == len(items)
    got = store.get_trace_ids_by_name("zipkin-tpu", "collector ingest",
                                      END, 10 * n)
    assert len(got) == n
    spans = store.get_spans_by_trace_ids([t.trace_id for t in got])
    stored = sorted(int(s[0].binary_annotations[0].value) for s in spans)
    assert sum(stored) == col.spans_stored
    assert col._c_self_drops.value == 0
    col.close()
