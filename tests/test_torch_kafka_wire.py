"""The port's Kafka pair over bytes on a socket: the port's v0 broker
fake and its minimal producer and consumer (``zipkin_tpu_torch/testing/
kafka_fake.py``) under the port's ``KafkaSpanSink`` and
``KafkaSpanReceiver``.

Every case of tests/test_kafka_wire.py runs here on the port's broker
and clients. Then the two packages cross: a port consumer on a
reference broker, a reference consumer on a port broker, a port
producer into a reference broker, the message-set bytes of both codecs,
and the answers both brokers give a corrupt CRC and a truncated set.
Last, one drive on the CPU: ``KafkaSpanSink`` -> the port's broker ->
``KafkaSpanReceiver`` -> ``Collector`` -> ``TorchSpanStore``, with every
trace read back equal to an in-memory oracle's.

Every broker, producer, consumer and thread is closed in a fixture
finalizer, every join and socket call has a timeout, the live-polling
case stops its consumer itself; no child process, no signal.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_ingest import assert_same_traces, traces  # noqa: E402
from test_torch_store import PORT, SMALL, _convert  # noqa: E402
from zipkin_tpu.ingest import kafka as ref_kafka  # noqa: E402
from zipkin_tpu.store.memory import (  # noqa: E402
    InMemorySpanStore as RefMemoryStore,
)
from zipkin_tpu.testing import kafka_fake as ref_fake  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.ingest import Collector  # noqa: E402
from zipkin_tpu_torch.ingest.kafka import (  # noqa: E402
    FRAME_DEFLATE,
    FRAME_RAW,
    KafkaSpanReceiver,
    KafkaSpanSink,
)
from zipkin_tpu_torch.ingest.queue import QueueFullException  # noqa: E402
from zipkin_tpu_torch.models.trace import Trace  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.memory import InMemorySpanStore  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402
from zipkin_tpu_torch.testing import kafka_fake as fake  # noqa: E402
from zipkin_tpu_torch.testing.kafka_fake import (  # noqa: E402
    FakeKafkaBroker,
    MinimalKafkaConsumer,
    MinimalKafkaProducer,
)
from zipkin_tpu_torch.tracegen import generate_traces  # noqa: E402
from zipkin_tpu_torch.wire.thrift import span_to_bytes  # noqa: E402

SOCKET_TIMEOUT_S = 10.0
JOIN_TIMEOUT_S = 10.0

SPANS = [s for t in generate_traces(n_traces=6, max_depth=3,
                                    n_services=4) for s in t]


@pytest.fixture()
def closing():
    """Register clients (anything with ``close``) to close at teardown."""
    opened = []
    yield lambda c: opened.append(c) or c
    for c in reversed(opened):
        c.close()


@pytest.fixture()
def broker():
    with FakeKafkaBroker() as b:
        yield b


@pytest.fixture()
def ref_broker():
    with ref_fake.FakeKafkaBroker() as b:
        yield b


@pytest.fixture()
def clients(broker, closing):
    """(producer, consumer factory) on the port's broker, both closed at
    teardown."""
    def consumer(topic, **kw):
        return closing(MinimalKafkaConsumer(broker.host, broker.port, topic,
                                            **kw))

    return closing(MinimalKafkaProducer(broker.host, broker.port)), consumer


def _raw_request(b, frame: bytes) -> bytes:
    """One raw request frame to broker ``b``; the whole response."""
    with socket.create_connection((b.host, b.port),
                                  timeout=SOCKET_TIMEOUT_S) as s:
        s.sendall(struct.pack(">i", len(frame)) + frame)
        head = fake._read_exact(s, 4)
        (size,) = struct.unpack(">i", head)
        return fake._read_exact(s, size)


def _produce_frame(mset: bytes, topic: str = "t") -> bytes:
    body = (fake._i16(1) + fake._i32(1000) + fake._i32(1)
            + fake._string(topic) + fake._i32(1) + fake._i32(0)
            + fake._bytes(mset))
    return (fake._i16(0) + fake._i16(0) + fake._i32(1)
            + fake._string("raw") + body)


# ---------------------------------------------------------------------------
# The reference's cases on the port's broker and clients
# ---------------------------------------------------------------------------


def test_produce_fetch_roundtrip(broker, clients):
    prod, consumer = clients
    for i in range(5):
        prod.send("raw", b"value-%d" % i)
    cons = consumer("raw")
    assert list(cons) == [b"value-%d" % i for i in range(5)]
    assert cons.stats["fetches"] == 2 and cons.stats["bytes"] > 0
    tail = list(consumer("raw", offset=3))
    assert tail == [b"value-3", b"value-4"]


def test_broker_rejects_corrupt_crc(broker, clients):
    prod, consumer = clients
    prod.send("t", b"fine")
    with pytest.raises(IOError):
        prod.send("t", b"mangled", corrupt_crc=True)
    assert broker.stats["corrupt_rejected"] == 1
    assert list(consumer("t")) == [b"fine"]


def test_truncated_produce_set_rejected_whole(broker):
    """A produce set missing its tail is rejected whole (ERR_CORRUPT),
    never appended as its complete prefix."""
    mset = fake.encode_message_set([b"a", b"b"])[:-1]
    resp = _raw_request(broker, _produce_frame(mset))
    err = struct.unpack(">h", resp[-10:-8])[0]
    assert err == fake.ERR_CORRUPT
    assert broker.stats["corrupt_rejected"] == 1
    assert broker.log("t").values == []


def test_message_keys_round_trip(broker):
    msg = fake.encode_message(b"the-value", key=b"the-key")
    mset = fake._i64(0) + fake._i32(len(msg)) + msg
    _raw_request(broker, _produce_frame(mset, "keyed"))
    stored = broker.log("keyed").values[0]
    assert fake.decode_message_set(
        fake._i64(0) + fake._i32(len(stored)) + stored) == [
            (0, b"the-key", b"the-value")]


def test_sink_to_receiver_end_to_end(broker, clients):
    prod, consumer = clients
    sink = KafkaSpanSink(prod, topic="zipkin")
    sink.apply(SPANS)
    sink.close()
    assert sink.stats["published"] == len(SPANS)
    store = InMemorySpanStore()
    receiver = KafkaSpanReceiver(process=store.apply,
                                 streams=[consumer("zipkin")])
    receiver.run()
    assert receiver.stats["messages"] == len(SPANS)
    assert receiver.stats["bad"] == 0
    assert store.get_spans_by_trace_id(SPANS[0].trace_id)
    assert store.get_all_service_names()


def test_sink_batching_one_message_many_spans(broker, clients):
    prod, consumer = clients
    sink = KafkaSpanSink(prod, topic="batched", batch=True)
    sink.apply(SPANS)
    sink.close()
    assert len(broker.log("batched").values) == 1
    store = InMemorySpanStore()
    receiver = KafkaSpanReceiver(process=store.apply,
                                 streams=[consumer("batched")])
    receiver.run()
    assert receiver.stats["messages"] == 1
    assert float(store.stored_span_count()) == len(SPANS)


def test_receiver_retries_on_pushback(broker, clients):
    prod, consumer = clients
    sink = KafkaSpanSink(prod)
    sink.apply(SPANS[:4])
    sink.close()
    store = InMemorySpanStore()
    fails = {"left": 3}

    def congested(spans):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise QueueFullException("full")
        store.apply(spans)

    receiver = KafkaSpanReceiver(process=congested,
                                 streams=[consumer("zipkin")],
                                 retry_backoff_s=0.001)
    receiver.run()
    assert receiver.stats["retries"] == 3
    assert receiver.stats["dropped"] == 0
    assert float(store.stored_span_count()) == 4


def test_receiver_drops_after_max_retries(broker, clients):
    prod, consumer = clients
    sink = KafkaSpanSink(prod)
    sink.apply(SPANS[:2])
    sink.close()

    def always_full(spans):
        raise QueueFullException("full")

    receiver = KafkaSpanReceiver(process=always_full,
                                 streams=[consumer("zipkin")],
                                 retry_backoff_s=0.0, max_retries=2)
    receiver.run()
    assert receiver.stats["dropped"] == 2
    assert receiver.stats["retries"] == 4


def test_corrupt_payload_on_topic_is_counted_not_fatal(broker, clients):
    prod, consumer = clients
    prod.send("zipkin", span_to_bytes(SPANS[0]))
    prod.send("zipkin", b"\x0c\x00\x01garbage-not-thrift")
    prod.send("zipkin", span_to_bytes(SPANS[1]))
    store = InMemorySpanStore()
    receiver = KafkaSpanReceiver(process=store.apply,
                                 streams=[consumer("zipkin")])
    receiver.run()
    assert receiver.stats["messages"] == 3
    assert receiver.stats["bad"] == 1
    assert float(store.stored_span_count()) == 2


def test_at_least_once_redelivery_is_tolerated(broker, clients):
    prod, consumer = clients
    sink = KafkaSpanSink(prod)
    sink.apply(SPANS[:7])
    sink.close()
    store = InMemorySpanStore()
    for _ in range(2):
        KafkaSpanReceiver(process=store.apply,
                          streams=[consumer("zipkin")]).run()
    tid = SPANS[0].trace_id
    spans = store.get_spans_by_trace_id(tid)
    once = [s for s in SPANS[:7] if s.trace_id == tid]
    assert len(spans) == 2 * len(once)
    t_dup, t_once = Trace(spans), Trace(once)
    assert [s.id for s in t_dup.spans] == [s.id for s in t_once.spans]
    assert t_dup.duration == t_once.duration


def _first_stored_value(b, topic):
    v = b.log(topic).values[0]
    return fake.decode_message_set(fake._i64(0) + fake._i32(len(v)) + v)[0][2]


def test_compressed_sink_round_trips_through_broker(broker, clients):
    prod, consumer = clients
    sink = KafkaSpanSink(prod, topic="deflated", batch=True, compress=True)
    sink.apply(SPANS)
    sink.close()
    assert sink.stats["published"] == len(SPANS)
    assert sink.stats["bytes_wire"] < sink.stats["bytes_raw"]
    assert _first_stored_value(broker, "deflated")[0] == FRAME_DEFLATE
    store = InMemorySpanStore()
    receiver = KafkaSpanReceiver(process=store.apply,
                                 streams=[consumer("deflated")])
    receiver.run()
    assert receiver.stats["bad"] == 0
    assert float(store.stored_span_count()) == len(SPANS)
    tid = SPANS[0].trace_id
    assert store.get_spans_by_trace_id(tid) == [
        s for s in SPANS if s.trace_id == tid]


def test_small_payload_framed_raw_not_inflated(broker, clients):
    prod, consumer = clients
    sink = KafkaSpanSink(prod, topic="tiny", compress=True,
                         compress_min_bytes=1 << 20)
    sink.apply(SPANS[:1])
    sink.close()
    assert _first_stored_value(broker, "tiny")[0] == FRAME_RAW
    store = InMemorySpanStore()
    KafkaSpanReceiver(process=store.apply, streams=[consumer("tiny")]).run()
    assert float(store.stored_span_count()) == 1


def test_mixed_legacy_and_framed_messages_interoperate(broker, clients):
    prod, consumer = clients
    KafkaSpanSink(prod, topic="mixed").apply(SPANS[:2])
    KafkaSpanSink(prod, topic="mixed", compress=True,
                  compress_min_bytes=0).apply(SPANS[2:4])
    KafkaSpanSink(prod, topic="mixed", compress=True,
                  compress_min_bytes=1 << 20).apply(SPANS[4:5])
    store = InMemorySpanStore()
    receiver = KafkaSpanReceiver(process=store.apply,
                                 streams=[consumer("mixed")])
    receiver.run()
    assert receiver.stats["bad"] == 0
    assert float(store.stored_span_count()) == 5


def test_corrupt_deflate_frame_counted_not_fatal(broker, clients):
    prod, consumer = clients
    prod.send("zx", b"\x01this-is-not-a-zlib-stream")
    prod.send("zx", span_to_bytes(SPANS[0]))
    store = InMemorySpanStore()
    receiver = KafkaSpanReceiver(process=store.apply,
                                 streams=[consumer("zx")])
    receiver.run()
    assert receiver.stats["bad"] == 1
    assert float(store.stored_span_count()) == 1


@pytest.fixture()
def live_receiver(broker, closing):
    """A receiver on a poll_forever consumer, run on a thread; stopped
    and joined (with a timeout) at teardown if the test did not."""
    store = InMemorySpanStore()
    consumer = closing(MinimalKafkaConsumer(broker.host, broker.port,
                                            "zipkin", poll_forever=True))
    receiver = KafkaSpanReceiver(process=store.apply, streams=[consumer])
    t = threading.Thread(target=receiver.run, daemon=True)
    t.start()
    yield store, consumer, t
    consumer.stop()
    t.join(timeout=JOIN_TIMEOUT_S)


def test_live_polling_consumer_sees_later_produces(broker, clients,
                                                   live_receiver):
    prod, _ = clients
    store, consumer, t = live_receiver
    sink = KafkaSpanSink(prod)
    sink.apply(SPANS[:3])
    sink.close()
    deadline = time.time() + 5
    while time.time() < deadline and store.stored_span_count() < 3:
        time.sleep(0.01)
    assert float(store.stored_span_count()) == 3
    consumer.stop()
    t.join(timeout=JOIN_TIMEOUT_S)
    assert not t.is_alive()


def test_close_ends_live_connections(closing):
    """``close()`` ends the connections its handlers still serve: an
    open client's next request fails at once instead of being served."""
    b = FakeKafkaBroker().start()
    try:
        prod = closing(MinimalKafkaProducer(b.host, b.port))
        prod.send("t", b"before")
    finally:
        b.close()
    with pytest.raises(OSError):
        prod.send("t", b"after")


# ---------------------------------------------------------------------------
# Crossings between the two packages
# ---------------------------------------------------------------------------


def test_message_set_bytes_equal_the_references():
    values = [b"", b"a", b"value-%d" % 7, bytes(range(256)) * 3]
    for base in (0, 5, 2**40):
        assert fake.encode_message_set(values, base) == \
            ref_fake.encode_message_set(values, base)
        assert fake.encode_message_set(values, base, corrupt_crc=True) == \
            ref_fake.encode_message_set(values, base, corrupt_crc=True)
    for key in (None, b"", b"the-key"):
        for value in (None, b"", b"the-value"):
            msg = fake.encode_message(value, key=key)
            assert msg == ref_fake.encode_message(value, key=key)
            mset = fake._i64(3) + fake._i32(len(msg)) + msg
            assert fake.decode_message_set(mset) == \
                ref_fake.decode_message_set(mset) == [(3, key, value)]
    trunc = fake.encode_message_set(values)[:-2]
    assert fake.decode_message_set(trunc) == \
        ref_fake.decode_message_set(trunc)
    with pytest.raises(ValueError):
        fake.decode_message_set(trunc, strict=True)


@pytest.mark.parametrize("case", ["crc", "truncated", "fine"])
def test_brokers_answer_bad_sets_alike(broker, ref_broker, case):
    if case == "crc":
        mset = fake.encode_message_set([b"x", b"y"], corrupt_crc=True)
    elif case == "truncated":
        mset = fake.encode_message_set([b"a", b"b"])[:-1]
    else:
        mset = fake.encode_message_set([b"a", b"b"])
    frame = _produce_frame(mset)
    assert _raw_request(broker, frame) == _raw_request(ref_broker, frame)
    assert broker.stats == ref_broker.stats
    assert broker.log("t").values == ref_broker.log("t").values


def test_port_consumer_on_a_reference_broker(ref_broker, closing):
    ref_spans = [s for t in traces(21, 12) for s in t]
    prod = closing(ref_fake.MinimalKafkaProducer(ref_broker.host,
                                                 ref_broker.port))
    ref_kafka.KafkaSpanSink(prod, topic="zipkin", batch=True,
                            compress=True).apply(ref_spans)
    prod.send("zipkin", b"\x01not-deflate")
    want = list(closing(ref_fake.MinimalKafkaConsumer(
        ref_broker.host, ref_broker.port, "zipkin")))
    cons = closing(MinimalKafkaConsumer(ref_broker.host, ref_broker.port,
                                        "zipkin"))
    store = InMemorySpanStore()
    receiver = KafkaSpanReceiver(process=store.apply, streams=[cons])
    receiver.run()
    assert receiver.stats["messages"] == len(want) == 2
    assert receiver.stats["bad"] == 1
    spans = _convert(ref_spans, PORT)
    tids = sorted({s.trace_id for s in spans})
    oracle = InMemorySpanStore()
    oracle.apply(spans)
    assert_same_traces(store.get_spans_by_trace_ids(tids),
                       oracle.get_spans_by_trace_ids(tids))


def test_reference_consumer_on_a_port_broker(broker, clients, closing):
    prod, _ = clients
    ref_spans = [s for t in traces(22, 12) for s in t]
    KafkaSpanSink(prod, topic="zipkin", batch=True, compress=True).apply(
        _convert(ref_spans, PORT))
    prod.send("zipkin", b"\x0c\x00\x01garbage-not-thrift")
    store = RefMemoryStore()
    receiver = ref_kafka.KafkaSpanReceiver(
        process=store.apply, streams=[closing(ref_fake.MinimalKafkaConsumer(
            broker.host, broker.port, "zipkin"))])
    receiver.run()
    assert receiver.stats["messages"] == 2 and receiver.stats["bad"] == 1
    tids = sorted({s.trace_id for s in ref_spans})
    oracle = RefMemoryStore()
    oracle.apply(ref_spans)
    assert [sorted(map(repr, t)) for t in store.get_spans_by_trace_ids(
        tids)] == [sorted(map(repr, t))
                   for t in oracle.get_spans_by_trace_ids(tids)]


def test_port_producer_into_a_reference_broker(broker, ref_broker, closing):
    values = [b"value-%d" % i for i in range(6)] + [bytes(range(200))]
    for b in (broker, ref_broker):
        prod = closing(MinimalKafkaProducer(b.host, b.port))
        bases = [prod.send("raw", v) for v in values]
        assert bases == list(range(len(values)))
        with pytest.raises(IOError):
            prod.send("raw", b"mangled", corrupt_crc=True)
    assert broker.log("raw").values == ref_broker.log("raw").values
    assert broker.stats == ref_broker.stats
    assert list(closing(ref_fake.MinimalKafkaConsumer(
        ref_broker.host, ref_broker.port, "raw"))) == values


# ---------------------------------------------------------------------------
# The drive on the CPU: sink -> broker -> receiver -> collector -> store
# ---------------------------------------------------------------------------


@pytest.fixture()
def collector():
    store = TorchSpanStore(tdev.StoreConfig(**SMALL), device="cpu")
    col = Collector(store, concurrency=2, registry=obs.Registry(),
                    self_trace=True)
    yield store, col
    col.close()


def test_kafka_drive_into_a_torch_store(broker, clients, collector):
    prod, consumer = clients
    store, col = collector
    spans = _convert([s for t in traces(23, 40) for s in t], PORT)
    sink = KafkaSpanSink(prod, topic="zipkin", batch=True, compress=True)
    chunks = [spans[i:i + 64] for i in range(0, len(spans), 64)]
    for chunk in chunks:
        sink.apply(chunk)
    prod.send("zipkin", bytes([FRAME_DEFLATE]) + b"not-a-zlib-stream")
    assert sink.stats["published"] == len(spans)
    cons = consumer("zipkin", max_bytes=1 << 12)
    receiver = KafkaSpanReceiver(col.accept, [cons],
                                 process_thrift=col.accept_thrift)
    receiver.run()
    col.flush()
    assert receiver.stats["messages"] == len(chunks) + 1
    assert receiver.stats["bad"] == 1 and receiver.stats["dropped"] == 0
    assert cons.stats["fetches"] > 1
    assert col.spans_stored == len(spans)
    tids = sorted({s.trace_id for s in spans})
    oracle = InMemorySpanStore()
    oracle.apply(spans)
    assert_same_traces(store.get_spans_by_trace_ids(tids),
                       oracle.get_spans_by_trace_ids(tids))
    # Each queue item left one self-trace span.
    selfs = store.get_trace_ids_by_name("zipkin-tpu", "collector ingest",
                                        2**62, 100)
    assert len(selfs) == len(chunks)
