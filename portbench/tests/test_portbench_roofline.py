"""The kernels' byte counts against hand arithmetic at small shapes."""

import numpy as np
import pytest
import torch

from portbench.lib import gen, roofline
from portbench.lib.stepbytes import StepBytes, mix_key_torch, mix_keys


def test_k1_bytes_by_hand():
    assert roofline.k1_bytes(1000, 10) == 1000 * 4 + 10 * 8


def test_k2_bytes_by_hand():
    assert roofline.k2_claim_bytes(64, 16) == 64 * 9 + 16 * 4
    # 64 rows, 50 valid in 16 buckets, 40 kept
    assert roofline.k2_write_bytes(64, 50, 16, 40) == \
        64 * 1 + 50 * (4 + 4 + 4) + 16 * 4 + 40 * (4 + 8 + 24 + 24)


def test_k3_and_cms_bytes_by_hand():
    assert roofline.k3_bytes(3, 4, 8, 60, 14) == 3 * 8 * 60 + 4 * 8 * 14 * 8
    assert roofline.cms_update_bytes(100, 4, 50) == 100 * 4 * 8 + 50 * 8
    assert roofline.cms_update_bytes(100, 4, 50, 4) == 100 * 4 * 4 + 50 * 8


def test_share_is_least_time_over_device_time():
    bw = roofline.bytes_per_s("NVIDIA H100 80GB HBM3")
    assert roofline.share(int(bw), 2.0, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(50.0)


def _store(window=False):
    st = {"max_services": 4, "max_span_names": 8, "max_annotation_values": 16,
          "max_binary_keys": 4, "quantile_buckets": 2048, "cms_depth": 4,
          "cms_width": 64}
    if window:
        st.update(window_seconds=60, window_buckets=8)
    return st


def test_step_bytes_count_rows_and_touched_cells_by_hand():
    t = gen.make_template(1, 4, 8, 3, seed=1)
    sb = StepBytes(_store(), [t], seed=5)
    rows, touched = sb.k1(0, 0)
    # 3 spans pad to 4, 6 annotations to 8, 3 binary rows to 4
    assert rows == 4 + 4 + 3 * 8 + 4 + 4 * 4
    col = t.cols
    svc = col["service_id"]
    hist_cells = len({(s, b) for s, b in zip(
        svc, np.ceil(np.log(col["duration"].astype(np.float64))
                     / np.log(1.01 / 0.99)).astype(int))})
    n_svc = len(set(svc))
    pres = len(set(zip(svc, col["name_id"])))
    fixed = hist_cells + n_svc + n_svc + pres + n_svc + n_svc
    assert touched - fixed == len(set(
        (r, b) for r in range(4) for b in
        (sb_cells(col["trace_id"] ^ gen.step_salt(5, 0), r))))
    assert sb.k2_rows(0) == 4 + 5 * 8 + 5 * 4


def sb_cells(tids, r):
    from portbench.lib.reference import cms_cells

    return cms_cells(torch.from_numpy(tids), 4, 64)[r].tolist()


def test_window_site_adds_its_rows_and_cells():
    t = gen.make_template(2, 4, 8, 3, seed=1)
    plain = StepBytes(_store(), [t], seed=5).k1(0, 1)
    win = StepBytes(_store(True), [t], seed=5).k1(0, 1)
    assert win[0] - plain[0] == 3 * 8
    cells = {(s, (ts + gen.step_delta(1)) // 60_000_000 % 8)
             for s, ts in zip(t.cols["service_id"], t.cols["ts_first"])}
    assert win[1] - plain[1] == 2 * len(cells)


def test_k2_kept_rows_by_hand_with_one_bucket_a_family():
    """With one bucket a family, every valid row lands in it and the
    bucket keeps min(rows, depth)."""
    t = gen.make_template(1, 4, 8, 3, seed=1)  # 3 spans, 6 anns, 3 banns
    fams = [(1, 2), (1, 8), (1, 8), (1, 2), (1, 8), (1, 4), (1, 8)]
    rows, valid, touched, kept = StepBytes(_store(), [t], 5, fams).k2(0, 0)
    assert rows == 4 + 5 * 8 + 5 * 4
    # by host 6, by host + name 6, the custom value's 3 (one host a span),
    # binary key with and without its value 3 + 3, membership 3 + 6 + 3
    assert valid == 6 + 6 + 3 + 6 + 3 + 6 + 3
    assert touched == 7
    assert kept == 2 + 6 + 3 + 2 + 3 + 4 + 3


def test_mix_keys_on_the_card_and_the_host_agree():
    x = np.array([0, 1, -1, 2**62 + 12345, -(2**63)], np.int64)
    want = mix_keys([x]).view(np.int64)
    assert (mix_key_torch(torch.from_numpy(x)).numpy() == want).all()


def test_k2_counts_match_the_rows_the_program_writes(monkeypatch):
    """Each step's (rows, valid, buckets, kept) as the yardstick counts
    them equal those of the rows the port's index write receives."""
    from conftest import tiny
    from portbench.drivers.restamp_stream import RestampStream
    from portbench.lib import stepbytes
    from zipkin_tpu_torch.store import device as dev

    seen = []
    real = dev._index_write

    def spy(*a, **kw):
        b, d, v = a[6].to(torch.int64), a[8].to(torch.int64), a[12]
        cnt = torch.bincount(b[v], minlength=int(b.max()) + 1)
        dep = torch.zeros_like(cnt).scatter_(0, b, d)
        seen.append((b.numel(), int(v.sum()), int((cnt > 0).sum()),
                     int(torch.minimum(cnt, dep).sum())))
        return real(*a, **kw)

    monkeypatch.setattr(dev, "_index_write", spy)
    cfg, mix = tiny("ring.bulk")
    cfg["store"].update(idx_name_buckets=256, idx_name_depth=4,
                        idx_service_depth=64)
    mix["templates"] = [{"traces": 60}]
    s = RestampStream(cfg, mix, 2**31 + 77, "cpu")
    for _ in range(4):
        s.commit(0)
    sb = stepbytes.of_stream(s)
    assert seen == [sb.k2(0, k) for k in range(4)]
    assert any(v > k for _, v, _, k in seen)  # some buckets overflow
