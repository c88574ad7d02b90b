"""The port's flat-histogram and arena kernels: plain twins against the
JAX package's Pallas kernels (interpret mode on the CPU, as
tests/test_pallas_kernels.py runs them) and its XLA formulations,
bitwise. The CUDA kernels against their twins are in
tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from zipkin_tpu.ops import pallas_kernels as pk  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu_torch.ops import kernels as K  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402


def _hist_inputs(seed, n, m):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, m, size=n).astype(np.int32)
    w = rng.integers(1, 4, size=n).astype(np.int32)
    return idx, w


@pytest.mark.parametrize("n,m", [(3000, 1024), (777, 4 * 128)])
def test_histogram_twin_matches_pallas_and_xla(n, m):
    idx, w = _hist_inputs(n, n, m)
    counts0 = np.random.default_rng(1).integers(0, 9, m).astype(np.int32)
    want_p = np.asarray(pk.histogram_update(
        jnp.asarray(counts0), jnp.asarray(idx), jnp.asarray(w), tile=256))
    want_x = np.asarray(pk.scatter_histogram_xla(
        jnp.asarray(counts0), jnp.asarray(idx), jnp.asarray(w)))
    got = K.histogram_update(torch.from_numpy(counts0.copy()),
                             torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_array_equal(want_p, got.numpy())
    np.testing.assert_array_equal(want_x, got.numpy())
    delta = K.flat_histogram(torch.from_numpy(idx), torch.from_numpy(w), m)
    np.testing.assert_array_equal(
        np.asarray(pk.flat_histogram(jnp.asarray(idx), jnp.asarray(w), m,
                                     tile=256)), delta.numpy())
    assert K.LAUNCHES["flat_histogram"] == 0  # twins never count
    # Rows past the end drop, as in the XLA formulation.
    idx[::97] = m + 5
    np.testing.assert_array_equal(
        np.asarray(pk.scatter_histogram_xla(
            jnp.asarray(counts0), jnp.asarray(idx), jnp.asarray(w))),
        K.histogram_update(torch.from_numpy(counts0.copy()),
                           torch.from_numpy(idx),
                           torch.from_numpy(w)).numpy())


# Sites of one fused call: (kind, cells, rows, weighted). ``flat`` rows
# hold idx in [-1, m); ``past`` also rows at idx >= m (the XLA
# formulation drops them; the Pallas kernel has no such rows); ``cms``
# is a [4, 256] count-min table fed as the step feeds it.
_SITES = [("flat", 1024, 3000, True), ("flat", 512, 0, False),
          ("cms", 4 * 256, 300, False), ("past", 640, 777, False),
          ("flat", 128, 2000, False), ("past", 896, 500, True),
          ("flat", 3 * 128, 1, True), ("flat", 1024, 1500, False)]


def _site(seed, kind, m, n, weighted):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, m).astype(np.int32)
    w = rng.integers(1, 4, n).astype(np.int32) if weighted else None
    if kind == "cms":
        rows = rng.integers(0, m // 4, (4, n)).astype(np.int32)
        rows[:, rng.random(n) < 0.2] = -1  # masked spans
        return counts, rows, w
    idx = rng.integers(-1, m, n).astype(np.int32)
    if kind == "past":
        idx[::7] = m + rng.integers(0, 50)
    return counts, idx, w


def _reference(kind, counts, idx, w):
    """The JAX package's result for one site: the Pallas kernel
    (interpret mode) where its contract holds, and the XLA formulation."""
    if kind == "cms":
        want = np.asarray(pk.cms_update(
            jnp.asarray(counts.reshape(4, -1)), jnp.asarray(idx),
            tile=256)).reshape(-1)
        flat = np.where(idx >= 0, idx + (np.arange(4) * (counts.size // 4))
                        [:, None], -1).reshape(-1).astype(np.int32)
        xla = np.asarray(pk.scatter_histogram_xla(jnp.asarray(counts),
                                                  jnp.asarray(flat)))
        np.testing.assert_array_equal(want, xla)
        return want, flat
    jw = None if w is None else jnp.asarray(w)
    want = np.asarray(pk.scatter_histogram_xla(
        jnp.asarray(counts), jnp.asarray(idx), jw))
    if kind == "flat":
        np.testing.assert_array_equal(want, np.asarray(pk.histogram_update(
            jnp.asarray(counts), jnp.asarray(idx), jw, tile=256)))
    return want, idx


@pytest.mark.parametrize("n_sites", [1, 2, 8])
def test_histogram_many_twin_matches_pallas_and_xla(n_sites):
    specs = _SITES[:n_sites] if n_sites != 1 else [_SITES[2]]
    cases = [_site(40 + k, *spec) for k, spec in enumerate(specs)]
    sites, wants = [], []
    for (kind, *_), (counts, idx, w) in zip(specs, cases):
        want, flat = _reference(kind, counts, idx, w)
        wants.append(want)
        sites.append((torch.from_numpy(counts.copy()), torch.from_numpy(flat),
                      None if w is None else torch.from_numpy(w)))
    before = dict(K.LAUNCHES)
    plain = [(c.clone(), i, w) for c, i, w in sites]
    K.histogram_update_many_plain(plain)
    K.histogram_update_many(sites)  # CPU tensors: the twin
    for want, (c, _, _), (p, _, _) in zip(wants, sites, plain):
        np.testing.assert_array_equal(want, c.numpy())
        np.testing.assert_array_equal(want, p.numpy())
    assert K.LAUNCHES == before  # twins never count


# Edge inputs of the count-min update, made by ``_cms_case``.
_CMS_CASES = ("site", "negative", "past_w_middle_row", "past_w_last_row",
              "wrap", "d1", "n0", "int64", "int64_wide", "one_cell")


def _cms_case(case, seed, d=4, w=256, n=700):
    """(counts [D, W], buckets [D, N]) as numpy: ``site`` the cms site's
    inputs (masked keys -1 in every row); ``negative`` assorted negative
    buckets; ``past_w_*`` buckets >= W in row 1 (they land in rows 2-3)
    or in the last row (past D x W: dropped); ``wrap`` buckets near
    2^31 - 1 in row 2, whose flat index wraps negative (dropped);
    ``d1`` one row; ``n0`` no key; ``int64`` int64 buckets; ``int64_wide``
    int64 buckets outside int32, cut to their low 32 bits; ``one_cell``
    every key on one cell."""
    rng = np.random.default_rng(seed)
    d = 1 if case == "d1" else d
    n = 0 if case == "n0" else n
    counts = rng.integers(0, 9, (d, w)).astype(np.int32)
    rows = rng.integers(0, w, (d, n))
    if case in ("site", "d1", "int64"):
        rows[:, rng.random(n) < 0.2] = -1
    elif case == "negative":
        pick = rng.random((d, n)) < 0.3
        rows[pick] = rng.choice([-1, -5, -w, -2**31], pick.sum())
    elif case == "past_w_middle_row":
        rows[1, ::5] = w + rng.integers(0, 2 * w, rows[1, ::5].shape)
    elif case == "past_w_last_row":
        rows[-1, ::5] = w + rng.integers(0, 3 * w, rows[-1, ::5].shape)
    elif case == "wrap":
        rows[2, ::7] = 2**31 - 1 - rng.integers(0, w, rows[2, ::7].shape)
    elif case == "int64_wide":
        rows[:, ::3] += rng.choice([2**32, -2**32, 2**40], rows[:, ::3].shape)
        rows[:, 1::11] = 2**31 + rng.integers(0, w, rows[:, 1::11].shape)
    elif case == "one_cell":
        rows[:] = 3
    wide = case in ("int64", "int64_wide")
    return counts, rows.astype(np.int64 if wide else np.int32)


def _cms_reference(counts, rows, w):
    """``pallas_kernels.cms_update``'s result, held to the XLA scatter of
    the flat index it builds. The Pallas kernel takes no cell past D x
    W (interpret mode clamps such a row into the table's last 128
    cells; on a TPU it is out of bounds), so it gets -1 there: the
    function's drop, which the XLA formulation shows. int64 buckets
    outside int32 go in cut to int32, the port's contract."""
    d, width = counts.shape
    r32 = rows.astype(np.int32)
    flat = (np.where(r32 >= 0, r32 + np.arange(d)[:, None] * width, -1)
            .astype(np.int64) + 2**31) % 2**32 - 2**31
    jw = None if w is None else jnp.asarray(w)
    xla = np.asarray(pk.scatter_histogram_xla(
        jnp.asarray(counts.reshape(-1)),
        jnp.asarray(flat.reshape(-1).astype(np.int32)),
        None if w is None else jnp.asarray(np.tile(w, d))))
    fits = np.array_equal(r32, rows)
    ref_rows = np.where(flat >= d * width, -1, rows if fits else r32)
    want = np.asarray(pk.cms_update(jnp.asarray(counts),
                                    jnp.asarray(ref_rows), jw, tile=256))
    np.testing.assert_array_equal(want.reshape(-1), xla)
    return want


@pytest.mark.parametrize("case,weighted", [
    pytest.param(c, wt, id=str(wt) if c == "site"
                 else f"{c}-{'weights' if wt else 'ones'}")
    for c in _CMS_CASES for wt in (False, True)])
def test_cms_update_matches_pallas_cms_update(case, weighted):
    """``kernels.cms_update`` (its twin on the CPU) against
    ``pallas_kernels.cms_update`` in interpret mode on the edge inputs
    of ``_cms_case``, without and with weights."""
    counts, rows = _cms_case(case, 90 + _CMS_CASES.index(case))
    w = (np.random.default_rng(91).integers(1, 4, rows.shape[1]).astype(
        np.int32) if weighted else None)
    want = _cms_reference(counts, rows, w)
    tw = None if w is None else torch.from_numpy(w)
    before = dict(K.LAUNCHES)
    got = K.cms_update(torch.from_numpy(counts.copy()),
                       torch.from_numpy(rows), tw)
    np.testing.assert_array_equal(want, got.numpy())
    assert K.LAUNCHES == before  # the CPU route is the twin; it never counts


def test_cms_update_checks_inputs():
    c = torch.zeros((4, 256), dtype=torch.int32)
    r = torch.zeros((4, 10), dtype=torch.int32)
    with pytest.raises(TypeError):
        K.cms_update(c, r.float())
    with pytest.raises(TypeError):
        K.cms_update(c.long(), r)
    with pytest.raises(TypeError):
        K.cms_update(c, r, torch.ones(10, dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        K.cms_update(c, r, torch.ones((4, 10), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[D, N\]"):
        K.cms_update(c, r[:3])
    with pytest.raises(ValueError, match="contiguous"):
        K.cms_update(c, torch.zeros((4, 20), dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError, match="device"):
        K.cms_update(c, r.to("meta"))
    assert not c.any()


def test_store_plain_scatter_matches_xla():
    # The store's own plain scatter (weight 1, no weights argument).
    for k, (kind, m, n, _) in enumerate(_SITES):
        counts, idx, _ = _site(70 + k, kind, m, n, False)
        want, flat = _reference(kind, counts, idx, None)
        got = tdev.scatter_histogram(torch.from_numpy(counts.copy()),
                                     torch.from_numpy(flat))
        np.testing.assert_array_equal(want, got.numpy())


def test_histogram_many_checks_inputs():
    c = torch.zeros(16, dtype=torch.int32)
    i = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 8"):
        K.histogram_update_many([(c, i, None)] * 9)
    with pytest.raises(TypeError):
        K.histogram_update_many([(c, i.long(), None)])
    with pytest.raises(TypeError):
        K.histogram_update_many([(c, i, torch.ones(4))])
    with pytest.raises(ValueError, match="contiguous"):
        K.histogram_update_many([(c, torch.zeros(8, dtype=torch.int32)[::2],
                                  None)])
    with pytest.raises(ValueError, match="device"):
        K.histogram_update_many([(c, i, None), (c, i.to("meta"), None)])
    with pytest.raises(ValueError, match="shape"):
        K.histogram_update_many([(c, i, torch.ones(3, dtype=torch.int32))])
    assert K.LAUNCHES["flat_histogram"] == 0


def _arena_case(seed, n, n_b=53, depth=8):
    rng = np.random.default_rng(seed)
    S = n_b * depth
    entries = rng.integers(-2**62, 2**62, (S, 3))
    bucket = rng.integers(0, n_b, n).astype(np.int32)
    pos = rng.integers(0, 500, n_b).astype(np.int64)
    valid = rng.random(n) < 0.8
    vals = rng.integers(-2**62, 2**62, (n, 3))
    base = (pos.astype(np.uint64) & 0xFFFFFFFF)[bucket].astype(np.int32)
    slot0 = bucket.astype(np.int64) * depth
    dvec = np.full(n, depth, np.int32)
    return entries, bucket, base, slot0, dvec, vals, valid, n_b


def _torch_args(case):
    entries, bucket, base, slot0, dvec, vals, valid, n_b = case
    t = torch.from_numpy
    return (t(entries.copy()), t(bucket), t(base), t(slot0), t(dvec),
            t(vals), t(valid), n_b)


@pytest.mark.parametrize("n", [7, 300, 1024])
def test_arena_twin_matches_pallas(n):
    case = _arena_case(11 + n, n)
    entries, bucket, base, slot0, dvec, vals, valid, n_b = case
    want = pk.arena_claim_scatter(
        jnp.asarray(entries), jnp.asarray(bucket), jnp.asarray(base),
        jnp.asarray(slot0), jnp.asarray(dvec), jnp.asarray(vals),
        jnp.asarray(valid), n_buckets=n_b, tile=256)
    got = K.arena_claim_scatter(*_torch_args(case))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # The write twin composed with the claim twin, as the step calls them.
    entries_t, bucket_t, base_t, slot0_t, dvec_t, vals_t, valid_t, _ = \
        _torch_args(case)
    rank, cnt = K.arena_claim_plain(bucket_t, valid_t, n_b)
    composed = K.arena_write_plain(entries_t, rank, cnt, bucket_t, base_t,
                                   slot0_t, dvec_t, vals_t, valid_t)
    np.testing.assert_array_equal(np.asarray(want), composed.numpy())


def test_arena_twin_single_bucket_overflow():
    n_b, depth, n = 4, 4, 100
    entries = np.full((n_b * depth, 3), -1, np.int64)
    vals = np.stack([np.arange(n, dtype=np.int64)] * 3, axis=-1)
    args = (np.zeros(n, np.int32), np.zeros(n, np.int32),
            np.zeros(n, np.int64), np.full(n, depth, np.int32), vals,
            np.ones(n, bool))
    want = np.asarray(pk.arena_claim_scatter(
        jnp.asarray(entries), *(jnp.asarray(a) for a in args),
        n_buckets=n_b, tile=256))
    got = K.arena_claim_scatter(torch.from_numpy(entries.copy()),
                                *(torch.from_numpy(a) for a in args),
                                n_buckets=n_b).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(got[:4, 0], [96, 97, 98, 99])


def test_fifo_ranks_match_reference():
    rng = np.random.default_rng(2)
    b = rng.integers(0, 40, 2000).astype(np.int32)
    v = rng.random(2000) < 0.7
    want = np.asarray(dev._fifo_ranks(jnp.asarray(b), jnp.asarray(v), 40))
    got = K.fifo_ranks(torch.from_numpy(b), torch.from_numpy(v), 40)
    np.testing.assert_array_equal(want, got.numpy())


def _claim_case(seed, n, variant):
    """Rows for the claim: ``odd`` and ``pow2`` bucket counts (the
    sentinel of a power of two needs one more key bit), ``invalid`` (no
    valid row) and ``hot`` (half the rows in one bucket, far past any
    depth)."""
    rng = np.random.default_rng(seed)
    n_b = 1024 if variant == "pow2" else 997
    bucket = rng.integers(0, n_b, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    if variant == "invalid":
        valid[:] = False
    if variant == "hot":
        hot = rng.random(n) < 0.5
        bucket[hot] = 5
        valid[hot] = True
    return bucket, valid, n_b


@pytest.mark.parametrize("variant", ["odd", "pow2", "invalid", "hot"])
@pytest.mark.parametrize("n", [7, 300, 1024, 100_000])
def test_arena_claim_twin_matches_reference(n, variant):
    bucket, valid, n_b = _claim_case(n, n, variant)
    jb, jv = jnp.asarray(bucket), jnp.asarray(valid)
    rank, cnt = K.arena_claim(torch.from_numpy(bucket),
                              torch.from_numpy(valid), n_b)
    assert rank.dtype == torch.int32 and cnt.dtype == torch.int32
    assert tuple(cnt.shape) == (n_b,)
    np.testing.assert_array_equal(
        np.asarray(dev._fifo_ranks(jb, jv, n_b)), rank.numpy())
    np.testing.assert_array_equal(
        np.asarray(dev._fifo_ranks_counting(jb, jv, n_b, 8)), rank.numpy())
    np.testing.assert_array_equal(
        np.bincount(bucket[valid], minlength=n_b), cnt.numpy())
    assert K.LAUNCHES["arena_claim"] == 0  # twins never count


def test_arena_claim_out_of_range_rows_rank_as_invalid():
    # A valid row outside [0, n_buckets) ranks among the invalid rows and
    # counts nowhere (the CUDA kernel's rule; the step never makes one).
    bucket = np.array([3, 9, -1, 3, 0, 12], np.int32)
    valid = np.array([1, 1, 1, 0, 1, 1], bool)
    rank, cnt = K.arena_claim_plain(torch.from_numpy(bucket),
                                    torch.from_numpy(valid), 4)
    np.testing.assert_array_equal(rank.numpy(), [0, 0, 1, 2, 0, 3])
    np.testing.assert_array_equal(cnt.numpy(), [1, 0, 0, 1])
