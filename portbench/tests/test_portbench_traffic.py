"""The stream: restamped steps keep their traces apart and their joins."""

import numpy as np
import torch

from portbench.lib import gen


def _template():
    return gen.make_template(50, 12, 20, 7, seed=3)


def test_restamp_keeps_ids_distinct_across_steps():
    t = _template()
    seen = set()
    for k in range(20):
        cols = gen.restamp_host(t.cols, gen.step_salt(99, k), gen.step_delta(k))
        tids = set(np.unique(cols["trace_id"]).tolist())
        assert len(tids) == t.n_traces
        assert not tids & seen
        seen |= tids


def test_restamp_keeps_parent_joins_and_moves_time():
    t = _template()
    for k in (0, 1, 17):
        cols = gen.restamp_host(t.cols, gen.step_salt(2**31 + 5, k),
                                gen.step_delta(k))
        spans = set(zip(cols["trace_id"].tolist(), cols["span_id"].tolist()))
        hp = (cols["flags"] & gen.FLAG_HAS_PARENT) != 0
        assert hp.sum() == t.n_traces * 6
        for tid, pid in zip(cols["trace_id"][hp].tolist(),
                            cols["parent_id"][hp].tolist()):
            assert (tid, pid) in spans
        assert (cols["parent_id"][~hp] == 0).all()
        assert (cols["span_id"] ^ cols["trace_id"]
                == t.cols["span_id"] ^ t.cols["trace_id"]).all()
        assert (cols["ts_first"] - t.cols["ts_first"] == k * gen.STEP_US).all()
        assert (cols["duration"] == t.cols["duration"]).all()


def test_device_restamp_equals_host_restamp():
    from zipkin_tpu_torch.columnar.schema import SpanBatch
    from zipkin_tpu_torch.store import device as dev

    t = _template()
    db = dev.batch_to_device(dev.make_device_batch(
        SpanBatch(**{k: v.copy() for k, v in t.cols.items()}),
        name_lc_id=t.cols["name_id"], indexable=np.ones(t.n_spans, bool),
        pad_spans=512, pad_anns=1024, pad_banns=512), "cpu")
    salt, delta = gen.step_salt(7, 3), gen.step_delta(3)
    got = gen.restamp_device(db, salt, delta)
    want = gen.restamp_host(t.cols, salt, delta)
    n = t.n_spans
    for c in ("trace_id", "span_id", "parent_id") + gen.TS_COLS:
        assert torch.equal(getattr(got, c)[:n], torch.from_numpy(want[c])), c
    assert torch.equal(got.ann_ts[:2 * n], torch.from_numpy(want["ann_ts"]))


def test_same_seed_same_stream_other_seed_other_ids():
    a, b = _template(), _template()
    for c in a.cols:
        assert (a.cols[c] == b.cols[c]).all()
    assert gen.step_salt(1, 0) != gen.step_salt(2, 0)
    assert gen.step_salt(2**31 + 17, 4) == gen.step_salt(2**31 + 17, 4)
