"""The port's write-ahead log (``zipkin_tpu_torch/wal``) against the
JAX package's, on the CPU.

Framing: the same appends through both packages' ``WriteAheadLog``
give byte-identical segment files, compressed and not, and each reads
the other's log; the torn-tail, CRC-corrupt, sequence-hole and
truncate-with-cursor cases run against the port's log. Codec: both
packages' ``encode_unit`` give equal bytes for the same group.
Recovery: checkpoint plus tail replay into ``TorchSpanStore(device=
"cpu")`` equals the uncrashed port store bitwise; a pipelined drive
recovers from an empty store; a torn tail leaves the batch absent; a
foreign lineage fails fast; and a log written by a JAX store (with its
checkpoint) recovers into the port equal to the JAX store, integer
leaves bitwise and the moments within ``moments_close``, on the ring
store and on the window store.
"""

import os
import struct

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
from zipkin_tpu import checkpoint as ref_checkpoint  # noqa: E402
from zipkin_tpu.columnar.encode import SpanCodec as RefCodec  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.base import should_index  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore, name_lc_ids  # noqa: E402
from zipkin_tpu.testing import crash as ref_crash  # noqa: E402
from zipkin_tpu.wal import WriteAheadLog as RefWal  # noqa: E402
from zipkin_tpu.wal import record as ref_record  # noqa: E402
from zipkin_tpu_torch import checkpoint  # noqa: E402
from zipkin_tpu_torch import obs  # noqa: E402
from zipkin_tpu_torch.columnar.encode import SpanCodec  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store import torch_store  # noqa: E402
from zipkin_tpu_torch.store.convert import state_to_numpy  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402
from zipkin_tpu_torch.testing.crash import (  # noqa: E402
    build_crash_store,
    crash_batches,
    state_mismatches,
)
from zipkin_tpu_torch.wal import (  # noqa: E402
    WalReplayError,
    WriteAheadLog,
    recover,
    replay_into,
)
from zipkin_tpu_torch.wal import record as walrec  # noqa: E402
from zipkin_tpu_torch.wal.log import _MAGIC, _REC  # noqa: E402


def _wal(path, **kw):
    return WriteAheadLog(str(path), registry=obs.Registry(), **kw)


def _payloads(n, size=64):
    return [bytes([i % 251]) * size + i.to_bytes(4, "big")
            for i in range(n)]


def _segments(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".seg"))


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compress", [True, False])
def test_framing_is_the_reference_byte_for_byte(tmp_path, compress):
    pays = _payloads(40, size=300) + [b"abcdefgh" * 2048]
    kw = dict(fsync="off", segment_bytes=1 << 12, compress=compress)
    ref = RefWal(str(tmp_path / "ref"), **kw)
    port = _wal(tmp_path / "port", **kw)
    for p in pays:
        assert ref.append(p) == port.append(p)
    ref.close()
    port.close()
    names = _segments(tmp_path / "ref")
    assert len(names) >= 3 and names == _segments(tmp_path / "port")
    for n in names:
        with open(tmp_path / "ref" / n, "rb") as a, \
                open(tmp_path / "port" / n, "rb") as b:
            assert a.read() == b.read(), n
    # Each package reads the other's log.
    other = _wal(tmp_path / "ref", fsync="off")
    assert [p for _, p in other.replay(0)] == pays
    other.close()
    back = RefWal(str(tmp_path / "port"), fsync="off")
    assert [p for _, p in back.replay(0)] == pays
    back.close()


def _torn_tail(d):
    seg = os.path.join(d, _segments(d)[-1])
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 10)


def _crc_corrupt(d):
    victim = os.path.join(d, _segments(d)[1])
    with open(victim, "r+b") as f:
        head = f.read(len(_MAGIC) + 4)
        (hlen,) = struct.unpack(">I", head[len(_MAGIC):])
        at = len(_MAGIC) + 4 + hlen + _REC.size + 5
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


def _seq_hole(d):
    os.remove(os.path.join(d, _segments(d)[1]))


@pytest.mark.parametrize("fault", ["torn_tail", "crc_corrupt", "seq_hole",
                                   "truncate_with_cursor"])
def test_port_log_faults(tmp_path, fault):
    """The log is a prefix after any damage (never skip-and-continue),
    and truncation never deletes what a follower cursor still needs."""
    d = str(tmp_path / "w")
    wal = _wal(d, fsync="off", segment_bytes=1 << 12, compress=False)
    pays = _payloads(30, size=300)
    for p in pays:
        wal.append(p)
    wal.sync()
    if fault == "truncate_with_cursor":
        wal.register_cursor("f1", 4)
        wal.truncate(upto_seq=20)
        assert [p for _, p in wal.replay(4)] == pays[4:]
        wal.advance_cursor("f1", 20)
        assert wal.truncate(upto_seq=20) >= 1
        assert [p for _, p in wal.replay(20)] == pays[20:]
        wal.drop_cursor("f1")
        wal.truncate(upto_seq=30)
        assert list(wal.replay(0)) == []
        assert wal.append(b"tail") == 31
        wal.close()
        return
    wal.close()
    assert len(_segments(d)) >= 3
    {"torn_tail": _torn_tail, "crc_corrupt": _crc_corrupt,
     "seq_hole": _seq_hole}[fault](d)
    wal2 = _wal(d, fsync="off")
    survivors = [p for _, p in wal2.replay(0)]
    assert survivors == pays[:len(survivors)]
    assert wal2.torn_records_cut >= 1
    if fault == "torn_tail":
        assert len(survivors) == 29
    else:
        assert 0 < len(survivors) < 30
    # Appends continue right after the surviving prefix.
    assert wal2.append(b"next") == len(survivors) + 1
    wal2.close()


# ---------------------------------------------------------------------------
# Record codec
# ---------------------------------------------------------------------------


def _group_of(record, codec, batches, names, index_of):
    """One launch group of ``batches`` encoded by ``codec``: (group,
    dictionary sizes before, sizes after, deltas), through one
    package's ``record`` module."""
    marks = record.dict_sizes(codec.dicts)
    cache = {}
    group = []
    for spans in batches:
        b = codec.encode(spans)
        ix = np.array([index_of(s) for s in spans])
        group.append((b, names(b, codec.dicts, cache), ix))
    sizes, deltas = record.dump_dict_deltas(codec.dicts, marks)
    return group, marks, sizes, deltas


def test_encode_unit_matches_reference():
    ref_batches = ref_crash.crash_batches(3)
    port_batches = crash_batches(3)
    assert _convert(ref_batches, PORT) == port_batches
    rg, rmarks, rsizes, rdeltas = _group_of(
        ref_record, RefCodec(), ref_batches, name_lc_ids, should_index)
    pg, pmarks, psizes, pdeltas = _group_of(
        walrec, SpanCodec(), port_batches, torch_store.name_lc_ids,
        torch_store.should_index)
    assert (rmarks, rsizes, rdeltas) == (pmarks, psizes, pdeltas)
    a = ref_record.encode_unit(rg, rmarks, rdeltas)
    assert a == walrec.encode_unit(pg, pmarks, pdeltas)
    # The port decodes the reference's record into the same group.
    group, before, deltas = walrec.decode_unit(a)
    assert before == pmarks and deltas == pdeltas
    for (x, lx, ix), (y, ly, iy) in zip(group, pg):
        assert np.array_equal(lx, ly) and np.array_equal(ix, iy)
        for col in x.SPAN_COLUMNS + x.ANN_COLUMNS + x.BANN_COLUMNS:
            assert np.array_equal(getattr(x, col), getattr(y, col)), col


# ---------------------------------------------------------------------------
# Recovery, port only
# ---------------------------------------------------------------------------


def _drive(store, batches):
    for b in batches:
        store.apply(b)


def _fresh(device):
    return build_crash_store(device=device)


def test_checkpoint_plus_tail_replay_is_bitwise(tmp_path):
    batches = crash_batches(8)
    oracle = build_crash_store(device="cpu")
    _drive(oracle, batches)

    store = build_crash_store(device="cpu")
    wal = _wal(tmp_path / "wal", fsync="off")
    store.attach_wal(wal)
    _drive(store, batches[:4])
    stats = checkpoint.save(store, str(tmp_path / "ckpt"))
    assert "wal_truncated_segments" in stats
    _drive(store, batches[4:])
    wal.sync()
    wal.close()
    del store

    wal2 = _wal(tmp_path / "wal", fsync="off")
    rec, rstats = recover(str(tmp_path / "ckpt"), wal2, device="cpu")
    assert rstats["applied_seq"] == 8
    assert rstats["replayed_records"] == 4
    assert not state_mismatches(oracle.state, rec.state)
    assert rec.counter_block() == oracle.counter_block()
    # The recovered store keeps journaling: live appends continue.
    rec.apply(batches[0])
    assert wal2.last_seq == 9
    wal2.close()


def test_pipelined_drive_recovers_from_empty(tmp_path):
    batches = crash_batches(6)
    oracle = build_crash_store(device="cpu")
    _drive(oracle, batches)

    store = build_crash_store(device="cpu")
    wal = _wal(tmp_path / "wal", fsync="off")
    store.attach_wal(wal)
    with store.pipelined(4):
        _drive(store, batches)
    wal.sync()
    wal.close()
    del store

    wal2 = _wal(tmp_path / "wal", fsync="off")
    rec, rstats = recover(None, wal2, fresh_store=_fresh, device="cpu")
    assert rstats["replayed_records"] == 6
    assert not state_mismatches(oracle.state, rec.state)
    assert int(wal2.c_replayed.value) == 6
    wal2.close()


def test_torn_tail_batch_is_absent_not_partial(tmp_path):
    batches = crash_batches(6)
    store = build_crash_store(device="cpu")
    wal = _wal(tmp_path / "wal", fsync="off", compress=False)
    store.attach_wal(wal)
    _drive(store, batches)
    wal.sync()
    wal.close()
    del store
    d = str(tmp_path / "wal")
    seg = os.path.join(d, _segments(d)[-1])
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 64)

    wal2 = _wal(d, fsync="off")
    rec, rstats = recover(None, wal2, fresh_store=_fresh, device="cpu")
    assert rstats["applied_seq"] == 5
    oracle = build_crash_store(device="cpu")
    _drive(oracle, batches[:5])
    assert not state_mismatches(oracle.state, rec.state)
    missing = sorted({s.trace_id for s in batches[5]})
    assert not any(rec.get_spans_by_trace_ids(missing))
    wal2.close()


def test_foreign_log_lineage_fails_fast(tmp_path):
    store = build_crash_store(device="cpu")
    wal = _wal(tmp_path / "wal", fsync="off")
    store.attach_wal(wal)
    _drive(store, crash_batches(3))
    wal.sync()
    wal.close()
    other = build_crash_store(device="cpu")
    other.dicts.services.encode("not-from-this-log")
    other.dicts.services.encode("nor-this")
    wal2 = _wal(tmp_path / "wal", fsync="off")
    with pytest.raises(WalReplayError, match="lineage"):
        replay_into(other, wal2, from_seq=0)
    wal2.close()


def test_sharded_log_is_refused(tmp_path):
    """A log with ``replay_units`` (a ShardedWal) is no longer refused:
    ``replay_into`` hands it to the sharded replay, which replays its
    epochs into a fleet (tests/test_torch_sharded_durability.py holds
    the replayed states)."""
    from zipkin_tpu_torch.parallel.shard import ShardedSpanStore
    from zipkin_tpu_torch.tracegen import generate_traces
    from zipkin_tpu_torch.wal import ShardedWal

    cfg = tdev.StoreConfig(
        capacity=512, ann_capacity=2048, bann_capacity=1024,
        max_services=16, max_span_names=32, max_annotation_values=64,
        max_binary_keys=16, cms_width=256, hll_p=8, quantile_buckets=128)
    spans = [s for t in generate_traces(
        n_traces=8, max_depth=3, n_services=4,
        rng=np.random.default_rng(3)) for s in t]
    wal = ShardedWal(str(tmp_path / "wal"), 2, fsync="off")
    fleet = ShardedSpanStore(2, cfg, device="cpu", registry=obs.Registry())
    other = ShardedSpanStore(2, cfg, device="cpu", registry=obs.Registry())
    try:
        fleet.attach_wal(wal)
        fleet.apply(spans[:20])
        fleet.apply(spans[20:])
        stats = replay_into(other, wal)
        assert stats["replayed_records"] == 2
        assert stats["replayed_spans"] == len(spans)
        assert stats["applied_seq"] == 2 == other._wal_applied
    finally:
        fleet.close()
        other.close()
        wal.close()


# ---------------------------------------------------------------------------
# A JAX-written log (and checkpoint) recovered into the port
# ---------------------------------------------------------------------------

WINDOWED = dict(window_seconds=60, window_buckets=8)


@pytest.mark.parametrize("ckpt", [True, False], ids=["ckpt", "empty"])
@pytest.mark.parametrize("kind", ["ring", "window"])
def test_reference_log_recovers_into_port(tmp_path, kind, ckpt):
    extra = WINDOWED if kind == "window" else {}
    cfg = {**ref_crash.crash_config(False)._asdict(), **extra}
    batches = ref_crash.crash_batches(8)
    ref = TpuSpanStore(dev.StoreConfig(**cfg))
    wal = RefWal(str(tmp_path / "wal"), fsync="off")
    ref.attach_wal(wal)
    _drive(ref, batches[:4])
    if ckpt:
        ref_checkpoint.save(ref, str(tmp_path / "ckpt"))
    _drive(ref, batches[4:])
    wal.sync()
    wal.close()

    wal2 = _wal(tmp_path / "wal", fsync="off")
    port, stats = recover(
        str(tmp_path / "ckpt") if ckpt else None, wal2,
        fresh_store=lambda d: TorchSpanStore(tdev.StoreConfig(**cfg),
                                             device=d),
        device="cpu")
    assert stats["replayed_records"] == (4 if ckpt else 8)
    assert stats["applied_seq"] == 8
    assert_states_equal(jax_leaves(ref.state), state_to_numpy(port.state),
                        f"{kind} recovered")
    assert port.counter_block() == ref.counter_block()
    tids = sorted({s.trace_id for b in batches for s in b})
    assert (port.get_spans_by_trace_ids(tids)
            == _convert(ref.get_spans_by_trace_ids(tids), PORT))
    if kind == "window":
        m = port.ensure_sketch_mirror()
        assert np.array_equal(m.win_counts,
                              state_to_numpy(port.state)["win_counts"])
    wal2.close()
