"""Each CUDA kernel of the port against its plain twin, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()``
is false. This file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from zipkin_tpu_torch.ops import kernels as K  # noqa: E402


def _hist_inputs(seed, n, m):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, m, size=n).astype(np.int32)
    idx[::97] = m + 5  # past the end: dropped
    w = rng.integers(1, 4, size=n).astype(np.int32)
    return idx, w


def _arena_case(seed, n, n_b, depth):
    rng = np.random.default_rng(seed)
    S = n_b * depth
    bucket = rng.integers(0, n_b, n).astype(np.int32)
    pos = rng.integers(0, 500, n_b).astype(np.int64)
    t = torch.from_numpy
    return (t(rng.integers(-2**62, 2**62, (S, 3))), t(bucket),
            t((pos.astype(np.uint64) & 0xFFFFFFFF)[bucket].astype(np.int32)),
            t(bucket.astype(np.int64) * depth),
            t(np.full(n, depth, np.int32)),
            t(rng.integers(-2**62, 2**62, (n, 3))),
            t(rng.random(n) < 0.8), n_b)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    K.build_all()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1000, 1000 * 2048, 4 * 65536])
def test_cuda_histogram_matches_twin(cuda, m):
    idx, w = _hist_inputs(m, 200_000, m)
    counts = torch.from_numpy(np.arange(m, dtype=np.int32) % 7)
    want = K.histogram_update(counts.clone(), torch.from_numpy(idx),
                              torch.from_numpy(w))
    before = K.LAUNCHES["flat_histogram"]
    got = K.histogram_update(counts.to(cuda), torch.from_numpy(idx).to(cuda),
                             torch.from_numpy(w).to(cuda))
    torch.cuda.synchronize()
    assert K.LAUNCHES["flat_histogram"] == before + 1
    np.testing.assert_array_equal(want.numpy(), got.cpu().numpy())


def _hist_site(seed, m, n, weighted=False, hot=False, cms=False,
               window=False):
    """One site as numpy: (counts, idx, weights or None). ``cms``: n rows
    into a [4, m // 4] count-min table, flattened as the step does;
    ``hot``: every row hits cell 3; ``window``: the window arena's
    counts, [m // 192, 64, 3], three index sets of n // 3 rows on two
    live slots as the step makes them (masked rows -1)."""
    rng = np.random.default_rng(seed)
    counts = (np.arange(m) % 7).astype(np.int32)
    if window:
        k = n // 3
        cid = rng.integers(0, m // 192, k) * 64 + rng.integers(5, 7, k)
        live = rng.random(k) < 0.9
        idx = np.concatenate([np.where(live, cid * 3, -1),
                              np.where(live & (rng.random(k) < 0.02),
                                       cid * 3 + 1, -1),
                              np.where(live, cid * 3 + 2, -1)])
        idx = idx.astype(np.int32)
    elif cms:
        w4 = m // 4
        rows = rng.integers(0, w4, (4, n // 4)) + (np.arange(4) * w4)[:, None]
        rows[:, rng.random(n // 4) < 0.1] = -1
        idx = rows.reshape(-1).astype(np.int32)
    else:
        idx = rng.integers(-1, m, n).astype(np.int32)
        idx[::97] = m + 5  # past the end: dropped
    if hot:
        idx[:] = 3
    w = rng.integers(1, 4, n).astype(np.int32) if weighted else None
    return counts, idx, w


# Fused calls on the card: each a list of _hist_site arguments.
_MANY = {
    "privatised 1000 cells": [dict(m=1000, n=131_072)],
    "hot cell": [dict(m=1000, n=131_072, hot=True),
                 dict(m=1 << 20, n=200_000, hot=True),
                 dict(m=1 << 20, n=100_000, hot=True, weighted=True)],
    "count-min": [dict(m=4 * 65_536, n=524_288, cms=True)],
    "eight sites": [dict(m=1000 * 2048, n=131_072),
                    dict(m=1000, n=131_072, weighted=True),
                    dict(m=1000, n=262_144),
                    dict(m=1000 * 2048, n=262_144, weighted=True),
                    dict(m=1000 * 4096, n=262_144, hot=True),
                    dict(m=1000 * 1024, n=0),
                    dict(m=4 * 65_536, n=524_288, cms=True),
                    dict(m=4096, n=50_001)],
    "empty site": [dict(m=1000, n=0), dict(m=1 << 20, n=1000)],
    # The window path's first step: the seven ring sites at 114,688
    # spans (padded to 131,072) and win_counts, 2,097,152 rows into
    # 9,672,144 cells.
    "window path: eight sites": [
        dict(m=1000 * 2048, n=131_072), dict(m=1000, n=131_072),
        dict(m=1000, n=262_144), dict(m=1000 * 2048, n=262_144),
        dict(m=1000 * 4096, n=262_144), dict(m=1000 * 1024, n=131_072),
        dict(m=4 * 65_536, n=524_288, cms=True),
        dict(m=1000 * 64 * 3, n=393_216, window=True)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_MANY))
def test_cuda_histogram_many_matches_twin(cuda, case):
    t = torch.from_numpy
    cpu = [(t(c), t(i), None if w is None else t(w))
           for c, i, w in (_hist_site(k, **a)
                           for k, a in enumerate(_MANY[case]))]
    want = [(c.clone(), i, w) for c, i, w in cpu]
    K.histogram_update_many_plain(want)
    got = [(c.to(cuda), i.to(cuda), None if w is None else w.to(cuda))
           for c, i, w in cpu]
    before = K.LAUNCHES["flat_histogram"]
    K.histogram_update_many(got)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flat_histogram"] == before + 1
    for (w_c, _, _), (g_c, _, _) in zip(want, got):
        np.testing.assert_array_equal(w_c.numpy(), g_c.cpu().numpy())
    # Each site alone, through the one-site call: one launch each.
    for (c, i, w), (w_c, _, _) in zip(cpu, want):
        before = K.LAUNCHES["flat_histogram"]
        one = K.histogram_update(c.to(cuda), i.to(cuda),
                                 None if w is None else w.to(cuda))
        torch.cuda.synchronize()
        assert K.LAUNCHES["flat_histogram"] == before + int(i.numel() > 0)
        np.testing.assert_array_equal(w_c.numpy(), one.cpu().numpy())


@pytest.mark.cuda
def test_cuda_histogram_many_raises_rather_than_falls_back(cuda):
    c = torch.zeros(16, dtype=torch.int32, device=cuda)
    i = torch.zeros(4, dtype=torch.int32, device=cuda)
    before = K.LAUNCHES["flat_histogram"]
    with pytest.raises(TypeError):
        K.histogram_update_many([(c, i.long(), None)])
    with pytest.raises(TypeError):
        K.histogram_update_many([(c.long(), i, None)])
    with pytest.raises(ValueError, match="device"):
        K.histogram_update_many([(c, i, None), (c.cpu(), i.cpu(), None)])
    with pytest.raises(ValueError, match="device"):
        K.histogram_update_many([(c, i.cpu(), None)])
    with pytest.raises(ValueError, match="at most 8"):
        K.histogram_update_many([(c, i, None)] * 9)
    assert K.LAUNCHES["flat_histogram"] == before
    assert int(c.sum()) == 0


def _on(args, device):
    return tuple(a.to(device) if torch.is_tensor(a) else a for a in args)


def _claim_case(seed, n, variant, n_b=997):
    """Claim rows: ``odd`` and ``pow2`` bucket counts (the sentinel of a
    power of two needs one more key bit), ``invalid`` (no valid row),
    ``hot`` (half the rows in one bucket: it spans many 4096-row blocks
    and overflows any depth)."""
    rng = np.random.default_rng(seed)
    if variant == "pow2":
        n_b = 1 << max(1, (n_b - 1).bit_length())
    bucket = rng.integers(0, n_b, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    if variant == "invalid":
        valid[:] = False
    if variant == "hot":
        hot = rng.random(n) < 0.5
        bucket[hot] = 5
        valid[hot] = True
    return torch.from_numpy(bucket), torch.from_numpy(valid), n_b


def _check_claim_write(cuda, bucket, valid, n_b, depth=16, seed=0):
    """Claim, write and their composite on the card against the twins,
    bitwise, on one arena."""
    rng = np.random.default_rng(seed)
    n = bucket.shape[0]
    want_r, want_c = K.arena_claim_plain(bucket, valid, n_b)
    before = dict(K.LAUNCHES)
    rank, cnt = K.arena_claim(bucket.to(cuda), valid.to(cuda), n_b)
    torch.cuda.synchronize()
    assert K.LAUNCHES["arena_claim"] == before["arena_claim"] + 1
    np.testing.assert_array_equal(want_r.numpy(), rank.cpu().numpy())
    np.testing.assert_array_equal(want_c.numpy(), cnt.cpu().numpy())
    pos = rng.integers(0, 2**33, n_b)
    bl = bucket.long().clamp(0, n_b - 1)
    args = (torch.from_numpy(rng.integers(-2**62, 2**62, (n_b * depth, 3))),
            bucket,
            torch.from_numpy((pos & 0xFFFFFFFF).astype(np.uint32)
                             .view(np.int32))[bl],
            bl * depth, torch.full((n,), depth, dtype=torch.int32),
            torch.from_numpy(rng.integers(-2**62, 2**62, (n, 3))), valid)
    entries, bucket, base, slot0, dvec, vals, valid = args
    want = K.arena_write_plain(entries.clone(), want_r, want_c, bucket, base,
                               slot0, dvec, vals, valid)
    got = K.arena_write(*_on((entries, rank, cnt, bucket, base, slot0, dvec,
                              vals, valid), cuda))
    torch.cuda.synchronize()
    assert K.LAUNCHES["arena_write"] == before["arena_write"] + 1
    np.testing.assert_array_equal(want.numpy(), got.cpu().numpy())
    whole = K.arena_claim_scatter(*_on(args, cuda), n_buckets=n_b)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        K.arena_claim_scatter_plain(entries.clone(), *args[1:], n_b).numpy(),
        whole.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 300, 1024, 100_000])
def test_cuda_arena_matches_twin(cuda, n):
    args = _arena_case(5 + n, n, n_b=997, depth=16)
    want = K.arena_claim_scatter(*(a.clone() if torch.is_tensor(a) else a
                                   for a in args))
    got = K.arena_claim_scatter(*_on(args, cuda))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(want.numpy(), got.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["odd", "pow2", "invalid", "hot"])
@pytest.mark.parametrize("n", [7, 300, 1024, 100_000])
def test_cuda_arena_claim_write_match_twins(cuda, n, variant):
    _check_claim_write(cuda, *_claim_case(n, n, variant), seed=n)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["odd", "pow2"])
def test_cuda_arena_claim_write_main_path_shape(cuda, variant):
    # The ring path's launch: 2,097,152 index rows into 877,544 buckets
    # (2^20 in the power-of-two case: 21 key bits).
    _check_claim_write(cuda, *_claim_case(3, 2_097_152, variant,
                                          n_b=877_544), depth=4)


@pytest.mark.cuda
def test_cuda_wrappers_check_inputs(cuda):
    counts = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        K.histogram_update(counts, torch.zeros(4, dtype=torch.int64,
                                               device=cuda),
                           torch.ones(4, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        K.arena_claim(torch.zeros(4, dtype=torch.int64, device=cuda),
                      torch.ones(4, dtype=torch.bool, device=cuda), 8)
    with pytest.raises(ValueError):
        K.arena_claim(torch.zeros(4, dtype=torch.int32, device=cuda),
                      torch.ones(4, dtype=torch.bool, device=cuda), 0)


@pytest.mark.cuda
def test_cuda_arena_hot_bucket_spans_blocks(cuda):
    # One bucket holds 20,000 rows in a row, across five 4096-row blocks
    # of the claim's radix passes, and overflows its depth of 16 inside
    # the batch; the rest is the usual mix.
    args = list(_arena_case(1, 50_000, 997, 16))
    hot = slice(5_000, 25_000)
    args[1][hot] = 3
    args[2][args[1] == 3] = 7
    args[3][hot] = 3 * 16
    args[6][hot] = True
    want = K.arena_claim_scatter(*(a.clone() if torch.is_tensor(a) else a
                                   for a in args))
    got = K.arena_claim_scatter(*_on(args, cuda))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(want.numpy(), got.cpu().numpy())
    _check_claim_write(cuda, args[1], args[6], 997, seed=1)


def _gather_case(seed, page_rows, k, n_pages=64):
    """14 span-like columns (eleven int64, three int32) of n_pages pages
    and a page list of k entries with holes at the front, the middle
    and the end (k >= 3), one past the last page when k >= 16."""
    rng = np.random.default_rng(seed)
    cap = n_pages * page_rows
    cols = [torch.from_numpy(
        rng.integers(-2**31, 2**31, cap).astype(np.int32) if i in (3, 4, 12)
        else rng.integers(-2**62, 2**62, cap)) for i in range(14)]
    pages = rng.integers(0, n_pages, k).astype(np.int32)
    if k >= 3:
        pages[[0, k // 2, k - 1]] = -1
    if k >= 16:
        pages[k // 3] = n_pages
    return cols, torch.from_numpy(pages)


@pytest.mark.cuda
@pytest.mark.parametrize("page_rows", [64, 128, 256])
@pytest.mark.parametrize("k", [1, 16, 256])
def test_cuda_page_gather_matches_twin(cuda, page_rows, k):
    cols, pages = _gather_case(page_rows + k, page_rows, k)
    want = K.paged_page_gather(cols, pages, page_rows)
    before = K.LAUNCHES["paged_page_gather"]
    got = K.paged_page_gather([c.to(cuda) for c in cols], pages.to(cuda),
                              page_rows)
    torch.cuda.synchronize()
    assert K.LAUNCHES["paged_page_gather"] == before + 1
    assert got.dtype == torch.int64 and got.shape == (14, k * page_rows)
    np.testing.assert_array_equal(want.numpy(), got.cpu().numpy())


@pytest.mark.cuda
def test_cuda_page_gather_cache_sees_replaced_column(cuda):
    cols, pages = _gather_case(9, 128, 32)
    dcols = [c.to(cuda) for c in cols]
    first = K.paged_page_gather(dcols, pages.to(cuda), 128)
    again = K.paged_page_gather(dcols, pages.to(cuda), 128)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    # A column replaced by a new tensor (another address) is read anew.
    cols[5] = torch.from_numpy(np.random.default_rng(1).integers(
        -2**62, 2**62, cols[5].shape[0]))
    old5 = dcols[5]
    dcols[5] = cols[5].to(cuda)
    got = K.paged_page_gather(dcols, pages.to(cuda), 128)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        K.paged_page_gather(cols, pages, 128).numpy(), got.cpu().numpy())
    # An int64 column replaced by an int32 one at the same address (a
    # view of the same storage) misses too, and is sign-extended.
    dcols[5] = old5.view(torch.int32)[:old5.shape[0]]
    got = K.paged_page_gather(dcols, pages.to(cuda), 128)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        K.paged_page_gather([c.cpu() for c in dcols], pages, 128).numpy(),
        got.cpu().numpy())


@pytest.mark.cuda
def test_cuda_page_gather_checks_inputs(cuda):
    cols, pages = _gather_case(0, 128, 8)
    cols = [c.to(cuda) for c in cols]
    K.paged_page_gather(cols, pages.to(cuda), 128)  # caches the table
    with pytest.raises(TypeError):
        K.paged_page_gather(cols, pages.to(cuda).long(), 128)
    with pytest.raises(ValueError):
        K.paged_page_gather(cols, pages.to(cuda), 96)
    with pytest.raises(ValueError):
        K.paged_page_gather(cols[:-1] + [cols[-1][:-8]], pages.to(cuda),
                            128)
    with pytest.raises(TypeError):
        K.paged_page_gather(cols[:-1] + [cols[-1].float()], pages.to(cuda),
                            128)


# -- the window and pipeline paths on the card ------------------------------

WIN_US = 60_000_000


def _window_store(**kw):
    from zipkin_tpu_torch.store import device as tdev
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore

    cfg = tdev.StoreConfig(
        capacity=1 << 12, ann_capacity=1 << 13, bann_capacity=1 << 12,
        max_services=64, max_span_names=128, max_annotation_values=256,
        max_binary_keys=64, cms_width=1 << 12, hll_p=10,
        quantile_buckets=2048, window_seconds=60, window_buckets=16,
        batch_spans=512, use_pallas=True)
    return TorchSpanStore(cfg, **kw)


def _window_applies(n_applies=8, n_traces=300):
    """Span lists (generated columns decoded, every 37th span's custom
    annotation an "error"), three window buckets apart."""
    from zipkin_tpu_torch.columnar.encode import SpanCodec
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    codec = SpanCodec()
    gen = ColumnarTraceGen(codec.dicts, n_services=40, n_span_names=100,
                           topology=True, seed=9)
    err = codec.dicts.annotations.encode("error")
    out = []
    for i in range(n_applies):
        batch, _, _ = gen.next_batch(
            n_traces, base_ts=(1 << 50) // WIN_US * WIN_US + 3 * i * WIN_US)
        batch.ann_value_id[1::2][::37] = err
        out.append(codec.decode(batch))
    return out


def _assert_same_store(a, b):
    from zipkin_tpu_torch.store.convert import state_to_numpy

    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    for k, ref in sa.items():
        got = sb[k]
        if k == "counters":
            assert {c: int(v) for c, v in ref.items()} == {
                c: int(v) for c, v in got.items()}
        elif k.startswith("dep_") and ref.dtype == np.float32:
            # Stated tolerance 2: float32 moments summed in atomic order.
            r, g = ref.astype(np.float64), got.astype(np.float64)
            scale = np.abs(r).reshape(-1, r.shape[-1]).max(0)
            np.testing.assert_array_equal(r[..., 0], g[..., 0], err_msg=k)
            assert np.all(np.abs(r - g) <= 1e-5 * (np.abs(r) + scale)), k
        else:
            np.testing.assert_array_equal(ref, got, err_msg=k)
    for x, y in zip(a.sketch_mirror.arrays(), b.sketch_mirror.arrays()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_cuda_pipelined_matches_serial(cuda):
    """The pipeline's side-stream H2D and commit thread on the card give
    the serial store's state: integer leaves bitwise, the window arena
    among them; K1 once a step with its eight sites."""
    applies = _window_applies()
    serial = _window_store(device="cuda")
    for spans in applies:
        serial.apply(spans)
    piped = _window_store(device="cuda")
    before = K.LAUNCHES["flat_histogram"]
    with piped.pipelined(depth=4) as pipe:
        for spans in applies:
            piped.apply(spans)
        piped.drain_pipeline()
        assert pipe._h2d is not None
        assert pipe._h2d.cuda_stream != pipe._commit_stream.cuda_stream
    torch.cuda.synchronize()
    steps = piped.counter_block()["batches"]
    assert steps >= len(applies)
    assert K.LAUNCHES["flat_histogram"] - before == steps
    assert piped.counters()["window_errors"] > 0
    _assert_same_store(serial, piped)


@pytest.mark.cuda
def test_cuda_pipeline_commit_failure_surfaces_on_drain(cuda, monkeypatch):
    from zipkin_tpu_torch.store import device as tdev

    applies = _window_applies(n_applies=3)
    steps = tdev.ingest_steps
    failed = []

    def fail_once(state, batches):
        if not failed:
            failed.append(sum(b.n_spans for b in batches))
            raise RuntimeError("step failed on the commit thread")
        return steps(state, batches)

    monkeypatch.setattr(tdev, "ingest_steps", fail_once)
    store = _window_store(device="cuda")
    store.start_pipeline(2)
    store.apply(applies[0])
    with pytest.raises(RuntimeError, match="commit thread"):
        store.drain_pipeline()
    store.apply(applies[1])
    store.apply(applies[2])
    store.stop_pipeline()
    torch.cuda.synchronize()
    # The failed unit's spans are dropped, the rest committed.
    assert 0 < failed[0] <= len(applies[0])
    assert store.counter_block()["spans_seen"] == sum(
        len(a) for a in applies) - failed[0]


# -- durability on the card -------------------------------------------------


@pytest.mark.cuda
def test_cuda_recovery_matches_cpu_store(cuda, tmp_path):
    """A card store recovered from checkpoint plus WAL tail equals a CPU
    store driven with the same spans: integer leaves bitwise, moments
    by stated tolerance 2, mirrors equal; K1 once a replayed step."""
    from zipkin_tpu_torch import checkpoint, obs
    from zipkin_tpu_torch.wal import WriteAheadLog, recover

    applies = _window_applies()
    cpu = _window_store(device="cpu")
    for spans in applies:
        cpu.apply(spans)
    card = _window_store(device="cuda")
    wal = WriteAheadLog(str(tmp_path / "wal"), fsync="off",
                        registry=obs.Registry())
    card.attach_wal(wal)
    for spans in applies[:4]:
        card.apply(spans)
    checkpoint.save(card, str(tmp_path / "ckpt"))
    steps_at_save = card.counter_block()["batches"]
    for spans in applies[4:]:
        card.apply(spans)
    wal.sync()
    wal.close()
    wal2 = WriteAheadLog(str(tmp_path / "wal"), fsync="off",
                         registry=obs.Registry())
    before = K.LAUNCHES["flat_histogram"]
    rec, stats = recover(str(tmp_path / "ckpt"), wal2, device="cuda")
    torch.cuda.synchronize()
    assert stats["replayed_records"] > 0
    replayed = rec.counter_block()["batches"] - steps_at_save
    assert K.LAUNCHES["flat_histogram"] - before == replayed
    rec.ensure_sketch_mirror()
    _assert_same_store(cpu, rec)
    wal2.close()


@pytest.mark.cuda
def test_cuda_snapshots_cross_devices(cuda, tmp_path):
    """A card snapshot loads on the CPU and a CPU snapshot on the card,
    every leaf bitwise."""
    from zipkin_tpu_torch import checkpoint
    from zipkin_tpu_torch.testing.crash import state_mismatches

    applies = _window_applies(n_applies=4)
    for src_dev, dst_dev in (("cuda", "cpu"), ("cpu", "cuda")):
        src = _window_store(device=src_dev)
        for spans in applies:
            src.apply(spans)
        path = str(tmp_path / f"{src_dev}-to-{dst_dev}")
        checkpoint.save(src, path)
        got = checkpoint.load(path, device=dst_dev)
        assert got.state.device.type == dst_dev
        assert not state_mismatches(src.state, got.state)
        tids = sorted({s.trace_id for s in applies[-1]})[:20]
        assert got.get_spans_by_trace_ids(tids) == \
            src.get_spans_by_trace_ids(tids)


# -- eviction capture and the cold tier on the card --------------------------


def _tiered(device, backlog=0):
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.store.archive import ArchiveParams, TieredSpanStore

    hot = _window_store(device=device, registry=obs.Registry())
    hot.capture_backlog = backlog
    return TieredSpanStore(hot, params=ArchiveParams.for_config(
        hot.config, compact_fanin=2, small_span_limit=hot.config.capacity),
        registry=obs.Registry())


def _segments(tiered):
    tiered.seal_barrier()
    return [(s.seg_id, s.gid_lo, s.gid_hi, s.to_bytes())
            for s in tiered.archive.snapshot()]


@pytest.mark.cuda
def test_cuda_capture_pull_matches_cpu(cuda):
    """The pull on the card returns the CPU pull's counts and valid
    prefix bitwise (the ann/bann tails masked to -1 in both), and a card
    tiered store seals the CPU twin's segments bitwise."""
    from zipkin_tpu_torch.store import device as tdev

    applies = _window_applies()
    stores = {d: _tiered(d) for d in ("cuda", "cpu")}
    for spans in applies:
        for s in stores.values():
            s.apply(spans)
    card, cpu = stores["cuda"], stores["cpu"]
    torch.cuda.synchronize()
    assert card.counters()["archive_segments_written"] >= 1
    assert _segments(card) == _segments(cpu)
    cap = card.hot.config.capacity
    wp = card.hot._wp
    for lo, hi in ((wp - cap, wp - cap // 2), (wp - 300, wp)):
        ks = (cap, card.hot.config.ann_capacity,
              card.hot.config.bann_capacity)
        got = [x.cpu().numpy() for x in tdev.capture_eviction_rows(
            card.hot.state, lo, hi, *ks)]
        want = [x.numpy() for x in tdev.capture_eviction_rows(
            cpu.hot.state, lo, hi, *ks)]
        np.testing.assert_array_equal(want[0], got[0])
        n_s = int(want[0][0])
        assert n_s == hi - lo
        np.testing.assert_array_equal(want[1][:, :n_s], got[1][:, :n_s])
        np.testing.assert_array_equal(want[2], got[2])
        np.testing.assert_array_equal(want[3], got[3])


@pytest.mark.cuda
def test_cuda_sealer_copies_on_its_own_stream(cuda, monkeypatch):
    """With capture_backlog > 0 the sealer copies each pulled window on
    a stream of its own, after the pull's event, with the matrices
    record_stream-ed onto it; pipelined ingest with a slowed sealer
    (windows queue, later steps allocate) seals the inline twin's
    segments bitwise."""
    import time

    from zipkin_tpu_torch.store import pipeline

    applies = _window_applies()
    inline = _tiered("cuda")
    for spans in applies:
        inline.apply(spans)
    fetch = pipeline.fetch_mats
    seen = []

    def slow_fetch(mats, stream=None, after=None):
        seen.append((stream is not None and after is not None,
                     stream.cuda_stream if stream is not None else None))
        time.sleep(0.2)
        return fetch(mats, stream, after)

    monkeypatch.setattr(pipeline, "fetch_mats", slow_fetch)
    piped = _tiered("cuda", backlog=2)
    with piped.hot.pipelined(depth=4):
        for spans in applies:
            piped.apply(spans)
    main = torch.cuda.current_stream().cuda_stream
    assert seen and all(ok and s != main for ok, s in seen)
    assert _segments(piped) == _segments(inline)
    assert piped.hot.sealed_frontier() == piped.hot._cap_upto
    assert piped.hot.eviction_sealer().c_sealed.value == len(seen)
    piped.close()


# -- the ingest front end on the card ---------------------------------------


def _thrift_payloads(n_payloads=6, n_traces=200):
    """Thrift Span-sequence payloads of decoded generated batches, one
    debug-flagged span in 100."""
    from zipkin_tpu_torch.wire.thrift import span_to_bytes

    out = []
    for spans in _window_applies(n_payloads, n_traces):
        spans = [dataclasses.replace(s, debug=True) if i % 100 == 0 else s
                 for i, s in enumerate(spans)]
        out.append(b"".join(span_to_bytes(s) for s in spans))
    return out


@pytest.mark.cuda
def test_cuda_write_thrift_matches_cpu(cuda):
    """The native parse, the sampler's threshold and the launch on the
    card: the same tuples and state as the CPU store; K1 once a step."""
    from zipkin_tpu_torch.sampler import rate_to_threshold

    payloads = _thrift_payloads()
    card, cpu = _window_store(device="cuda"), _window_store(device="cpu")
    before = K.LAUNCHES["flat_histogram"]
    for i, p in enumerate(payloads):
        th = rate_to_threshold(0.5 if i % 2 else 1.0)
        assert card.write_thrift(p, th) == cpu.write_thrift(p, th)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["flat_histogram"] - before
            == card.counter_block()["batches"] > 0)
    _assert_same_store(cpu, card)


@pytest.mark.cuda
def test_cuda_collector_drive_matches_cpu(cuda):
    """A single-worker collector with a Scribe receiver's fast path on
    the card against the same drive on the CPU: counters and state."""
    import base64

    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.ingest import Collector, ResultCode, ScribeReceiver
    from zipkin_tpu_torch.sampler import Sampler

    payloads = _thrift_payloads(4, 150)
    out = []
    for device in ("cuda", "cpu"):
        store = _window_store(device=device)
        col = Collector(store, sampler=Sampler(0.5), concurrency=1,
                        registry=obs.Registry())
        rx = ScribeReceiver(col.accept, process_thrift=col.accept_thrift)
        for p in payloads:
            entries = [("zipkin", base64.b64encode(p).decode())]
            assert rx.log(entries) is ResultCode.OK
        col.flush()
        out.append((store, (col.spans_stored, col.spans_dropped,
                            col.bad_payloads, col.sampler.snapshot())))
        col.close()
    assert out[0][1] == out[1][1] and out[0][1][1] > 0
    _assert_same_store(out[1][0], out[0][0])


@pytest.mark.cuda
def test_cuda_sample_mask_matches_cpu(cuda):
    from zipkin_tpu_torch.sampler import rate_to_threshold, sample_mask

    rng = np.random.default_rng(12)
    tids = rng.integers(-2**63, 2**63 - 1, 1 << 16, dtype=np.int64,
                        endpoint=True)
    tids[:3] = [-2**63, 2**63 - 1, 0]
    debug = rng.random(tids.size) < 0.01
    for rate in (0.0, 0.3, 1.0):
        th = rate_to_threshold(rate)
        want = sample_mask(torch.from_numpy(tids), torch.from_numpy(debug),
                           th)
        got = sample_mask(torch.from_numpy(tids).to(cuda),
                          torch.from_numpy(debug).to(cuda), th)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


# -- the query layer on the card --------------------------------------------


def _query_requests(store, n_services=8):
    from zipkin_tpu_torch.query import BinaryAnnotationQuery, Order, \
        QueryRequest

    orders = list(Order)
    out = []
    for i, svc in enumerate(sorted(store.get_all_service_names())
                            [:n_services]):
        names = sorted(store.get_span_names(svc))
        for j, kw in enumerate((
                {}, {"span_name": names[0]},
                {"annotations": ("some custom annotation",)},
                {"binary_annotations": (BinaryAnnotationQuery(
                    "http.uri", b"/api/widgets"),)},
                {"span_name": names[-1],
                 "annotations": ("some custom annotation",)})):
            for limit in (10, 100):
                out.append(QueryRequest(
                    svc, limit=limit, end_ts=1 << 62,
                    order=orders[(i + j + limit) % len(orders)], **kw))
    return out


@pytest.mark.cuda
def test_cuda_query_service_matches_cpu(cuda, tmp_path):
    """A QueryService over a card window store against one over its CPU
    twin: eight threads' requests (coalesced on the executor thread,
    which reads on the default stream under the store's state lock)
    equal the CPU service's serial answers, and so do the combos; the
    sketch tier equals the card store's own reads; ``checkpoint.save``
    drains the engine before its cut."""
    import threading

    from zipkin_tpu_torch import checkpoint, obs
    from zipkin_tpu_torch.query import QueryService

    applies = _window_applies(n_applies=4)
    card = _window_store(device="cuda", registry=obs.Registry())
    cpu = _window_store(device="cpu", registry=obs.Registry())
    for spans in applies:
        card.apply(spans)
        cpu.apply(spans)
    on_card = QueryService(card, registry=obs.Registry())
    on_cpu = QueryService(cpu, coalesce_window_s=0.0,
                          registry=obs.Registry())
    streams = []
    multi = card.get_trace_ids_multi

    def noted(queries):
        streams.append((threading.current_thread().name,
                        torch.cuda.current_stream().cuda_stream))
        return multi(queries)

    card.get_trace_ids_multi = noted
    try:
        reqs = _query_requests(cpu)
        want = [on_cpu.get_trace_ids(r) for r in reqs]
        assert sum(bool(w.trace_ids) for w in want) > len(reqs) // 2
        got = [None] * len(reqs)
        errors = []

        def reader(k):
            try:
                for i in range(k, len(reqs), 8):
                    got[i] = on_card.get_trace_ids(reqs[i])
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=reader, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors and got == want
        assert on_card.coalescer.queries > 0
        # The executor thread reads on the stream every store read uses.
        main = torch.cuda.current_stream().cuda_stream
        assert streams and set(streams) == {("zipkin-query-exec", main)}
        tids = sorted({t for w in want for t in w.trace_ids})[:50]
        assert (on_card.get_trace_combos_by_ids(tids)
                == on_cpu.get_trace_combos_by_ids(tids))
        eng = on_card.engine
        for svc in sorted(card.get_all_service_names())[:8]:
            assert eng.get_span_names(svc) == card.get_span_names(svc)
            assert (eng.service_duration_quantiles(svc, [0.5, 0.99])
                    == card.service_duration_quantiles(svc, [0.5, 0.99]))
            assert eng.top_annotations(svc) == card.top_annotations(svc)
            assert (eng.windowed_quantiles(svc, [0.5, 0.99])
                    == card.windowed_quantiles(svc, [0.5, 0.99]))
        assert eng.estimated_unique_traces() == \
            card.estimated_unique_traces()
        drained = []
        orig = eng.drain
        eng.drain = lambda: (drained.append(True), orig())[1]
        checkpoint.save(card, str(tmp_path / "ckpt"))
        assert drained
    finally:
        on_card.close()
        on_cpu.close()
    assert not on_card.engine.executor._thread.is_alive()


# -- the HTTP API on the card ------------------------------------------------


@pytest.mark.cuda
def test_cuda_api_server_matches_cpu(cuda):
    """``ApiServer`` over a card store behind a real socket: ``POST
    /api/spans`` lands in the card store's steps (K1 and both K2 halves
    once a step), ``GET /api/trace/<id>`` equals the same server over the
    CPU twin, and ``/metrics`` carries every store counter, with the
    K1/K2 path flag set."""
    import json
    import re
    import urllib.request

    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.api import server as api_server
    from zipkin_tpu_torch.ingest import Collector
    from zipkin_tpu_torch.ingest.receiver import span_to_json
    from zipkin_tpu_torch.query import QueryService

    applies = _window_applies(n_applies=3, n_traces=200)
    answers = []
    for device in ("cuda", "cpu"):
        store = _window_store(device=device, registry=obs.Registry())
        col = Collector(store, concurrency=1, registry=obs.Registry())
        api = api_server.ApiServer(QueryService(store), col,
                                   self_trace=False,
                                   registry=obs.Registry())
        server = api_server.make_server(api, "127.0.0.1", 0)
        thread = api_server.serve_forever_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            K.reset_launches()
            for spans in applies:
                req = urllib.request.Request(
                    base + "/api/spans", method="POST",
                    data=json.dumps([span_to_json(s)
                                     for s in spans]).encode())
                with urllib.request.urlopen(req, timeout=60) as r:
                    assert r.status == 202
            col.flush()
            steps = store.counter_block()["batches"]
            if device == "cuda":
                torch.cuda.synchronize()
                assert steps > len(applies)
                assert {k: K.LAUNCHES[k] for k in (
                    "flat_histogram", "arena_claim", "arena_write")} == {
                    "flat_histogram": steps, "arena_claim": steps,
                    "arena_write": steps}
            tids = sorted({s.trace_id for s in applies[-1]})[:20]
            got = []
            for tid in tids:
                with urllib.request.urlopen(
                        f"{base}/api/trace/{tid & (2**64 - 1):x}",
                        timeout=60) as r:
                    got.append(json.loads(r.read()))
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=60) as r:
                text = r.read().decode()
            names = set(re.findall(
                r'^zipkin_store_counter\{name="([^"]+)"\} ', text, re.M))
            assert names == set(store.counters())
            assert store.counters()["scatter_path_pallas"] == 1.0
            answers.append(got)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            col.close()
            api.query.close()
    assert answers[0] == answers[1] and all(answers[0])


# -- fleet observability on the card ----------------------------------------


@pytest.mark.cuda
def test_cuda_lineage_matches_cpu_twin(cuda, tmp_path):
    """Lineage on a card store (WAL fsync=off, every unit sampled,
    pinned clock, seeded ids) against its CPU twin: the same stamped
    log byte for byte, equal states and mirrors, the lineage traces read
    back alike; K1 and both K2 halves once a step, the flushes
    included."""
    import random

    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.obs.fleet import LineageTracker
    from zipkin_tpu_torch.wal import WriteAheadLog

    applies = _window_applies(n_applies=4)
    out = {}
    for device in ("cpu", "cuda"):
        store = _window_store(device=device, registry=obs.Registry())
        wal = WriteAheadLog(str(tmp_path / device), fsync="off",
                            registry=obs.Registry())
        now = [(1 << 50) / 1e6]
        tracker = LineageTracker(store.apply, registry=obs.Registry(),
                                 sample_every=1, clock=lambda: now[0])
        tracker._rng = random.Random(3)
        tracker.FLUSH_AT = 4
        store.attach_wal(wal)
        store.attach_lineage(tracker)
        K.reset_launches()
        for spans in applies:
            now[0] += 0.5
            store.apply(spans)
        wal.sync()
        tracker.flush()
        wal.sync()
        steps = store.counter_block()["batches"]
        if device == "cuda":
            torch.cuda.synchronize()
            assert steps > len(applies)
            assert {k: K.LAUNCHES[k] for k in (
                "flat_histogram", "arena_claim", "arena_write")} == {
                "flat_histogram": steps, "arena_claim": steps,
                "arena_write": steps}
        ids = store.get_trace_ids_by_name("zipkin-tpu", None, 1 << 62, 50)
        traces = [store.get_spans_by_trace_ids([i.trace_id])[0]
                  for i in ids]
        wal.close()
        out[device] = (store, traces, [
            f.read_bytes() for f in sorted((tmp_path / device).iterdir())])
    cpu, card = out["cpu"], out["cuda"]
    assert len(card[1]) >= len(applies) and card[1] == cpu[1]
    assert card[2] == cpu[2]
    _assert_same_store(cpu[0], card[0])


@pytest.mark.cuda
def test_cuda_tracegen_run_on_the_card(cuda):
    from zipkin_tpu_torch.main import tracegen

    # The default device is the card; the small store takes the plain
    # torch route (no use_pallas), as the reference's takes XLA's.
    assert tracegen.run(n_traces=3, max_depth=4, verbose=False) is True


_CENSUS_CFG = dict(
    capacity=1 << 10, ann_capacity=1 << 12, bann_capacity=1 << 11,
    max_services=32, max_span_names=128, max_annotation_values=256,
    max_binary_keys=64, cms_width=1 << 10, hll_p=8, quantile_buckets=256)


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("layout", [
    {}, {"window_seconds": 60}, {"layout": "paged", "page_rows": 128}],
    ids=["ring", "window", "paged"])
def test_cuda_step_census_matches_cpu(cuda, layout, use_pallas):
    from zipkin_tpu_torch.store import census
    from zipkin_tpu_torch.store.convert import state_to_numpy
    from zipkin_tpu_torch.store.device import StoreConfig
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore

    cfg = StoreConfig(**_CENSUS_CFG, **layout, use_pallas=use_pallas)
    got = {}
    for dev in ("cpu", "cuda"):
        store = TorchSpanStore(cfg, device=dev)
        before = state_to_numpy(store.state)
        launches = dict(K.LAUNCHES)
        got[dev] = store.step_census()
        # On the card each counted wrapper call launched its kernel, over
        # the empty batch's invalid rows; on the CPU the twins launch
        # nothing.
        assert {k: K.LAUNCHES[k] - launches[k] for k in census.KERNELS} \
            == {k: got[dev][k] if dev == "cuda" else 0
                for k in census.KERNELS}
        after = state_to_numpy(store.state)
        assert all(np.array_equal(before[k], after[k]) for k in before
                   if not isinstance(before[k], dict))
    assert got["cuda"] == got["cpu"]
    assert census.gated(got["cuda"]) == census.row_of(cfg)


@pytest.mark.cuda
def test_cuda_build_app_platform_cpu_builds_a_cpu_store(cuda):
    from zipkin_tpu_torch.main import example

    built = []
    try:
        for argv, want in ((["--platform", "cpu"], "cpu"), ([], "cuda")):
            args = example.build_parser().parse_args(
                argv + ["--capacity", "1024", "--no-fleet-obs"])
            store, collector, api, _ = example.build_app(args)
            built.append((collector, api))
            assert store.device.type == want
            assert store.state.leaves["write_pos"].device.type == want
    finally:
        for collector, api in built:
            collector.close()
            api.query.close()


# -- replication on the card -------------------------------------------------


@pytest.mark.cuda
def test_cuda_standby_and_replica_follow_a_card_primary(cuda, tmp_path):
    """A card primary ships its log over 127.0.0.1 to a warm standby on
    the card and a device-free replica: the drained standby's state
    equals the primary's (integer leaves bitwise, moments by stated
    tolerance 2), the replica's mirror equals the primary's device
    aggregates bitwise, and every standby step took the kernel route:
    K1 and both K2 halves once a step (the replica launches nothing)."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.replicate import (Follower, ReplicaTarget,
                                            ShipClient, ShipServer,
                                            StandbyTarget, WalShipper)
    from zipkin_tpu_torch.replicate.protocol import config_from_dict
    from zipkin_tpu_torch.store.convert import state_to_numpy
    from zipkin_tpu_torch.store.replica import ReplicaSpanStore
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.testing.crash import state_mismatches
    from zipkin_tpu_torch.wal import WriteAheadLog

    primary = _window_store(device="cuda", registry=obs.Registry())
    wal = WriteAheadLog(str(tmp_path / "wal"), fsync="off",
                        registry=obs.Registry())
    primary.attach_wal(wal)
    for spans in _window_applies():
        primary.apply(spans)
    wal.sync()
    torch.cuda.synchronize()
    server = ShipServer(WalShipper(primary, registry=obs.Registry()),
                        host="127.0.0.1", port=0, io_timeout_s=30.0)
    server.serve_in_thread()
    port = server.server_address[1]
    closers = [wal.close, lambda: (server.shutdown(), server.server_close())]
    try:
        sby_client = ShipClient("127.0.0.1", port, "sby", mode="standby",
                                timeout_s=30.0)
        config = config_from_dict(sby_client.connect()["config"])
        assert config == primary.config and config.use_pallas
        standby = TorchSpanStore(config, device="cuda",
                                 registry=obs.Registry())
        replica = ReplicaSpanStore(config, background_compaction=False,
                                   registry=obs.Registry())
        closers.append(replica.close)
        K.reset_launches()
        followers = [
            Follower(StandbyTarget(standby), sby_client,
                     poll_interval_s=0.002, registry=obs.Registry()),
            Follower(ReplicaTarget(replica),
                     ShipClient("127.0.0.1", port, "rep", timeout_s=30.0),
                     poll_interval_s=0.002, registry=obs.Registry())]
        closers += [f.close for f in followers]
        for f in followers:
            f.start()
        for f in followers:
            assert f.drain(120.0), f.status()
        torch.cuda.synchronize()
        steps = standby.counter_block()["batches"]
        assert steps == primary.counter_block()["batches"] > 0
        assert {k: K.LAUNCHES[k] for k in (
            "flat_histogram", "arena_claim", "arena_write")} == {
            "flat_histogram": steps, "arena_claim": steps,
            "arena_write": steps}
        assert standby.counters()["scatter_path_pallas"] == 1.0
        assert state_mismatches(primary.state, standby.state,
                                moments_tolerance=True) == {}
        leaves = state_to_numpy(primary.state)
        for name, got in zip((
                "svc_hist", "ann_svc_counts", "name_presence",
                "ann_value_counts", "bann_key_counts", "hll_traces",
                "win_epoch", "win_counts", "win_sums", "win_mm"),
                replica.sketch_mirror.arrays()):
            np.testing.assert_array_equal(leaves[name], got, err_msg=name)
        assert (replica.estimated_unique_traces()
                == standby.estimated_unique_traces()
                == primary.estimated_unique_traces())
    finally:
        for fn in reversed(closers):
            fn()


@pytest.mark.cuda
def test_cuda_sketch_apis_match_cpu(cuda):
    """Each standalone sketch API on the card and on the CPU, the same
    inputs, equal bitwise: count-min (int32 through the flat-histogram
    kernel, one launch an update; float32 through ``index_add_``), HLL,
    the banked log-histogram and its quantiles, top-k counters with
    forced ties, ``topk_from_cms`` and the moments helpers."""
    from zipkin_tpu_torch.ops import cms, hll, moments as M, quantile as Q
    from zipkin_tpu_torch.ops import topk
    from zipkin_tpu_torch.ops.hashing import split64
    from zipkin_tpu_torch.testing.crash import moments_close

    rng = np.random.default_rng(61)
    n = 100_000
    keys = rng.integers(0, 30_000, n).astype(np.int64)
    hi, lo = split64(keys)
    svc = rng.integers(-2, 1003, n).astype(np.int32)
    dur = rng.integers(-5, 10**7, n).astype(np.int64)
    ok = (svc >= 0) & (svc < 1000) & (dur >= 0)
    w = rng.integers(1, 4, n).astype(np.int32)

    def run(dev):
        t = (lambda a: torch.from_numpy(a).to(dev))
        before = K.LAUNCHES["flat_histogram"]
        sk = cms.update(cms.init(device=dev), hi, lo)
        cms_launches = K.LAUNCHES["flat_histogram"] - before
        skw = cms.update(sk, hi, lo, weights=t(w))
        skf = cms.update(cms.init(dtype=torch.float32, device=dev), hi, lo)
        reg = hll.update(hll.init(device=dev), hi, lo, valid=t(ok))
        hist = Q.update_grouped(Q.init(shape=(1000,), dtype=torch.int32,
                                       device=dev), t(svc), t(dur),
                                valid=t(ok))
        histf = Q.update(Q.init(device=dev), t(dur[:5000]))
        ctr = topk.update(topk.init(1000, dtype=torch.int32, device=dev),
                          t(svc // 4 * 4), valid=t(ok))
        cand_hi, cand_lo = split64(np.arange(30_000, dtype=np.int64))
        out = [sk.counts, skw.counts, skf.counts, reg.registers,
               hist.counts, histf.counts, ctr.counts,
               *topk.top_k(ctr, 1000),
               *topk.topk_from_cms(sk, cand_hi, cand_lo, 500),
               cms.query(skw, cand_hi, cand_lo),
               *(Q.quantile(hist, q) for q in (0.5, 0.99)),
               M.reduce_moments(M.of(t(dur[:4096].astype(np.float32))))]
        return [x.cpu() for x in out], cms_launches

    want, cpu_launches = run("cpu")
    got, card_launches = run(cuda)
    torch.cuda.synchronize()
    assert cpu_launches == 0 and card_launches == 1
    # Moments: stated tolerance 2 (float32 arithmetic on another device).
    assert moments_close(want.pop().numpy(), got.pop().numpy())
    for k, (a, b) in enumerate(zip(want, got)):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=f"output {k}")
        else:
            assert torch.equal(a, b), f"output {k}"


# -- the sharded store on the card --------------------------------------------


def _sharded_pair(cuda, cfg=None):
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.parallel.shard import ShardedSpanStore

    cfg = cfg or _window_store(device="cpu").config
    return [ShardedSpanStore(2, cfg, device=d, registry=obs.Registry())
            for d in (cuda, "cpu")]


@pytest.mark.cuda
def test_cuda_sharded_fleet_matches_cpu(cuda):
    """A 2-shard fleet on the card against its CPU twin, the same
    applies: every shard's state (moments to stated tolerance 2), the
    fleet mirror, the reads; K1, the claim and the write launch once a
    shard step, empty shards included."""
    from zipkin_tpu_torch.testing.crash import state_mismatches

    card, cpu = _sharded_pair(cuda)
    try:
        applies = _window_applies(6, 200)
        before = dict(K.LAUNCHES)
        for spans in applies:
            card.apply(spans)
            cpu.apply(spans)
        torch.cuda.synchronize()
        steps = sum(b["batches"] for b in card.shard_counters())
        assert steps == 2 * len(applies)
        for k in ("flat_histogram", "arena_claim", "arena_write"):
            assert K.LAUNCHES[k] - before[k] == steps, k
        for a, b in zip(cpu.states, card.states):
            assert not state_mismatches(a, b, moments_tolerance=True)
        for a, b in zip(cpu.ensure_sketch_mirror().arrays(),
                        card.ensure_sketch_mirror().arrays()):
            np.testing.assert_array_equal(a, b)
        assert card.counters() == cpu.counters()
        svcs = sorted(cpu.get_all_service_names())
        assert card.get_all_service_names() == set(svcs)
        for svc in svcs[:8]:
            assert (card.get_trace_ids_by_name(svc, None, 2**62, 20)
                    == cpu.get_trace_ids_by_name(svc, None, 2**62, 20))
            assert card.get_span_names(svc) == cpu.get_span_names(svc)
            assert (card.service_duration_quantiles(svc, [0.5, 0.99])
                    == cpu.service_duration_quantiles(svc, [0.5, 0.99]))
        tids = sorted({s.trace_id for s in applies[-1]})[:40]
        assert card.get_spans_by_trace_ids(tids) == \
            cpu.get_spans_by_trace_ids(tids)
        assert card.get_traces_duration(tids) == \
            cpu.get_traces_duration(tids)
        a, b = card.get_dependencies(), cpu.get_dependencies()
        assert [(l.parent, l.child, l.duration_moments.n)
                for l in a.links] == [(l.parent, l.child,
                                       l.duration_moments.n)
                                      for l in b.links]
    finally:
        card.close()
        cpu.close()


@pytest.mark.cuda
def test_cuda_sharded_dispatcher_fuses_reads(cuda):
    """8 concurrent reads on a card fleet: at most 2 fused cross-shard
    reads, answers equal to the serialized ones."""
    import threading

    card, cpu = _sharded_pair(cuda)
    cpu.close()
    try:
        card.apply(_window_applies(1, 200)[0])
        svcs = sorted(card.get_all_service_names())[:4]
        serial = ([card.service_duration_quantiles(s, [0.5, 0.99])
                   for s in svcs]
                  + [card.get_trace_ids_by_name(s, None, 2**62, 10)
                     for s in svcs])
        card.dispatcher.window_s = 1.0
        barrier = threading.Barrier(9)
        got, errors = {}, []

        def run(i):
            try:
                barrier.wait(timeout=120)
                s = svcs[i % 4]
                got[i] = (card.service_duration_quantiles(s, [0.5, 0.99])
                          if i < 4 else
                          card.get_trace_ids_by_name(s, None, 2**62, 10))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(8)]
        for t in threads:
            t.start()
        before = card.collective_launches()
        barrier.wait(timeout=120)
        for t in threads:
            t.join(timeout=120)
        assert not [t for t in threads if t.is_alive()] and not errors
        assert card.collective_launches() - before <= 2
        assert [got[i] for i in range(8)] == serial
    finally:
        card.close()


@pytest.mark.cuda
def test_cuda_sharded_fleet_journals_crashes_and_recovers(cuda, tmp_path):
    """A 2-shard fleet on the card journaled into a ShardedWal (fsync
    batch), a checkpoint, a one-unit tail, a crash: ``recover`` on the
    card replays exactly the tail with K1, the claim and the write once
    a shard step, and equals the uncrashed card fleet and its CPU twin
    fed the same spans (moments to stated tolerance 2)."""
    from zipkin_tpu_torch import checkpoint, obs
    from zipkin_tpu_torch.testing.crash import state_mismatches
    from zipkin_tpu_torch.wal import ShardedWal, recover

    card, cpu = _sharded_pair(cuda)
    ckpt = str(tmp_path / "ckpt")
    wal = ShardedWal(str(tmp_path / "wal"), 2, fsync="batch",
                     registry=obs.Registry())
    rec, wal2 = None, None
    try:
        card.attach_wal(wal)
        applies = _window_applies(4, 200)
        for spans in applies[:3]:
            card.apply(spans)
            cpu.apply(spans)
        checkpoint.save(card, ckpt)
        card.apply(applies[3])
        cpu.apply(applies[3])
        card.wal_sync()
        wal.close()  # crash: no save after the tail
        wal2 = ShardedWal(str(tmp_path / "wal"), 2, fsync="batch",
                          registry=obs.Registry())
        before = dict(K.LAUNCHES)
        rec, stats = recover(ckpt, wal2, device=cuda)
        torch.cuda.synchronize()
        assert stats["replayed_records"] == 1
        assert stats["replayed_spans"] == len(applies[3])
        for k in ("flat_histogram", "arena_claim", "arena_write"):
            assert K.LAUNCHES[k] - before[k] == 2, k
        assert rec.write_frontier() == card.write_frontier()
        assert rec._wal_applied == card._wal_applied == 4
        for a, b in zip(card.states, rec.states):
            assert not state_mismatches(a, b, moments_tolerance=True)
        for a, b in zip(cpu.states, rec.states):
            assert not state_mismatches(a, b, moments_tolerance=True)
        tids = sorted({s.trace_id for s in applies[3]})[:40]
        assert rec.get_spans_by_trace_ids(tids) == \
            cpu.get_spans_by_trace_ids(tids)
    finally:
        for c in (rec, card, cpu, wal2):
            if c is not None:
                c.close()


@pytest.mark.cuda
def test_cuda_multihost_routed_half_matches_cpu(cuda):
    """A world-of-one gloo group through ``multihost.initialize``, the
    global view with 2 local shards, then process 0's routed half of a
    2-process, 4-shard feed into a card ``ShardedSpanStore(2)`` at 2^14
    and into its CPU twin: every kept span on its local slot, K1, the
    claim and the write once a shard step, states equal (moments to
    stated tolerance 2) and the reads equal."""
    import socket

    import torch.distributed as dist

    from zipkin_tpu_torch.parallel import multihost as mh
    from zipkin_tpu_torch.testing.crash import state_mismatches

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mh.initialize(f"127.0.0.1:{port}", 1, 0)
    card = cpu = None
    try:
        mesh = mh.global_mesh(local_shards=2)
        here = f"cuda:{torch.cuda.current_device()}"
        assert mesh.devices == ((0, 0, here), (0, 1, here))
        gathered = [None]
        dist.all_gather_object(gathered, mh.local_shard_ids(mesh))
        assert gathered == [[0, 1]]
        two = mh.mesh_layout([(2, here)] * 2, 0)
        local = mh.local_shard_ids(two)
        assert local == mh.partitions_for_process(two) == [0, 1]
        cfg = _window_store(device="cpu").config._replace(
            capacity=1 << 14, ann_capacity=1 << 15, bann_capacity=1 << 14)
        card, cpu = _sharded_pair(cuda, cfg)
        before = dict(K.LAUNCHES)
        kept_tids = set()
        for spans in _window_applies(4, 400):
            groups = mh.route_spans(spans, 4, keep=local)
            kept = [s for sid in sorted(groups) for s in groups[sid]]
            assert all(card._shard_of(s.trace_id) == sid
                       for sid, g in groups.items() for s in g)
            card.apply(kept)
            cpu.apply(kept)
            kept_tids |= {s.trace_id for s in kept}
        torch.cuda.synchronize()
        steps = sum(b["batches"] for b in card.shard_counters())
        assert steps == 2 * 4
        for k in ("flat_histogram", "arena_claim", "arena_write"):
            assert K.LAUNCHES[k] - before[k] == steps, k
        for a, b in zip(cpu.states, card.states):
            assert not state_mismatches(a, b, moments_tolerance=True)
        tids = sorted(kept_tids)[:60]
        assert card.get_spans_by_trace_ids(tids) == \
            cpu.get_spans_by_trace_ids(tids) != []
        assert card.get_traces_duration(tids) == \
            cpu.get_traces_duration(tids)
        assert card.shard_counters() == cpu.shard_counters()
    finally:
        for c in (card, cpu):
            if c is not None:
                c.close()
        dist.destroy_process_group()
