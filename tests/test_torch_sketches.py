"""The port's standalone sketch APIs against the JAX package's, on the CPU:
hashing, moments, count-min, HyperLogLog, log-histogram quantiles and
top-k counters.

Every case of tests/test_ops_sketches.py, run on both packages in the
same test from the same numpy inputs. Where a case is a property (never
underestimates, merge is union, relative error <= alpha) it is
parametrised over the package; where it is a value the two packages are
compared directly: counts, registers and top-k values and indices
bitwise (ties included), HLL estimates within ``rel=1e-5`` (stated
tolerance 3: the port sums in float64), quantile midpoints equal in
float32 with NaN matching NaN, and moments with the count field exact
and the other fields within 1e-5 of the field's largest magnitude
(stated tolerance 2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from zipkin_tpu.models.dependencies import Moments  # noqa: E402
from zipkin_tpu.ops import cms as rcms  # noqa: E402
from zipkin_tpu.ops import hashing as RH  # noqa: E402
from zipkin_tpu.ops import hll as rhll  # noqa: E402
from zipkin_tpu.ops import moments as RM  # noqa: E402
from zipkin_tpu.ops import quantile as RQ  # noqa: E402
from zipkin_tpu.ops import topk as rtopk  # noqa: E402
from zipkin_tpu_torch.ops import cms, hll  # noqa: E402
from zipkin_tpu_torch.ops import hashing as H  # noqa: E402
from zipkin_tpu_torch.ops import kernels as K  # noqa: E402
from zipkin_tpu_torch.ops import moments as M  # noqa: E402
from zipkin_tpu_torch.ops import quantile as Q  # noqa: E402
from zipkin_tpu_torch.ops import topk  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.testing.crash import moments_close  # noqa: E402

CPU = "cpu"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Jax:
    """The JAX package behind the adapter the property cases share."""

    name = "jax"
    cms, hll, Q, topk = rcms, rhll, RQ, rtopk

    @staticmethod
    def arr(x):
        return jnp.asarray(x)

    @staticmethod
    def cms_init(**kw):
        return rcms.init(**kw)

    @staticmethod
    def hll_init():
        return rhll.init()

    @staticmethod
    def q_init(**kw):
        return RQ.init(**kw)

    @staticmethod
    def topk_init(capacity, **kw):
        return rtopk.init(capacity, **kw)


class _Torch:
    """The port behind the same adapter (state on the CPU)."""

    name = "torch"
    cms, hll, Q, topk = cms, hll, Q, topk

    @staticmethod
    def arr(x):
        return torch.as_tensor(np.asarray(x))

    @staticmethod
    def cms_init(**kw):
        return cms.init(device=CPU, **kw)

    @staticmethod
    def hll_init():
        return hll.init(device=CPU)

    @staticmethod
    def q_init(**kw):
        if kw.get("dtype") is not None:
            kw["dtype"] = getattr(torch, kw["dtype"])
        return Q.init(device=CPU, **kw)

    @staticmethod
    def topk_init(capacity, **kw):
        if kw.get("dtype") is not None:
            kw["dtype"] = getattr(torch, kw["dtype"])
        return topk.init(capacity, device=CPU, **kw)


PKGS = [_Jax, _Torch]
_ids = [p.name for p in PKGS]


def _both(fn):
    """``fn(pkg)`` for the JAX package and the port, as numpy."""
    return [fn(p) for p in PKGS]


def _equal(fn):
    """``fn(pkg)`` on both packages; assert the results equal bitwise
    (dtype aside) and return the port's."""
    want, got = _both(fn)
    if isinstance(want, tuple):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(_np(w), _np(g))
    else:
        np.testing.assert_array_equal(_np(want), _np(got))
    return got


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------


class TestHashing:
    def test_split_join_roundtrip(self):
        xs = np.array([0, 1, -1, 2**63 - 1, -(2**63), 123456789012345],
                      np.int64)
        hi, lo = H.split64(xs)
        rhi, rlo = RH.split64(xs)
        assert hi.dtype == np.uint32 and lo.dtype == np.uint32
        np.testing.assert_array_equal(hi, rhi)
        np.testing.assert_array_equal(lo, rlo)
        np.testing.assert_array_equal(H.join64(hi, lo), xs)
        np.testing.assert_array_equal(H.join64(hi, lo), RH.join64(hi, lo))

    def test_fmix32_avalanche(self):
        xs = np.arange(1, 10000, dtype=np.uint32)
        hs = H.fmix32(H.words(xs, CPU)).numpy().astype(np.uint32)
        np.testing.assert_array_equal(hs, np.asarray(RH.fmix32(
            jnp.asarray(xs))))
        assert len(np.unique(hs)) == len(hs)  # bijective on a small range
        bits = np.unpackbits(hs.view(np.uint8)).mean()
        assert 0.45 < bits < 0.55

    def test_hash2_seed_independence(self):
        hi = np.zeros(1000, np.uint32)
        lo = np.arange(1000, dtype=np.uint32)
        th, tl = H.words(hi, CPU), H.words(lo, CPU)
        h0 = H.hash2_32(th, tl, 0).numpy()
        h1 = H.hash2_32(th, tl, 1).numpy()
        np.testing.assert_array_equal(h0, np.asarray(RH.hash2_32(
            jnp.asarray(hi), jnp.asarray(lo), 0)))
        np.testing.assert_array_equal(h1, np.asarray(RH.hash2_32(
            jnp.asarray(hi), jnp.asarray(lo), 1)))
        assert (h0 != h1).mean() > 0.99
        assert len(np.unique(h0 & 255)) > 235

    def test_hash_uses_both_words(self):
        lo = np.arange(1000, dtype=np.uint32)
        out = []
        for hi in (np.zeros(1000, np.uint32), np.ones(1000, np.uint32)):
            got = H.hash2_32(H.words(hi, CPU), H.words(lo, CPU), 7).numpy()
            np.testing.assert_array_equal(got, np.asarray(RH.hash2_32(
                jnp.asarray(hi), jnp.asarray(lo), 7)))
            out.append(got)
        assert (out[0] != out[1]).mean() > 0.99

    def test_clz32(self):
        xs = np.array([0, 1, 2, 3, 255, 256, 2**31, 2**32 - 1], np.uint32)
        got = H.clz32(H.words(xs, CPU)).numpy()
        np.testing.assert_array_equal(got, [32, 31, 30, 30, 24, 23, 0, 0])
        np.testing.assert_array_equal(got, np.asarray(RH.clz32(
            jnp.asarray(xs))))

    def test_words_from_tensors_and_columns_agree(self):
        xs = np.array([0, 1, 2**31, 2**32 - 1], np.uint32)
        a = H.words(xs, CPU)
        b = H.words(torch.from_numpy(xs.astype(np.int64)), CPU)
        assert a.dtype == torch.int64 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Moments
# ---------------------------------------------------------------------------


def _assert_moments(ref, got):
    ref = np.asarray(ref, np.float64)
    got = _np(got).astype(np.float64)
    assert moments_close(ref.reshape(-1, 5), got.reshape(-1, 5)), (ref, got)


class TestMoments:
    def test_combine_matches_host_moments(self):
        rng = np.random.default_rng(0)
        xs = rng.lognormal(8.0, 1.0, size=256).astype(np.float32)
        host = Moments.of_many(float(x) for x in xs)
        want = jax.jit(lambda v: RM.reduce_moments(RM.of(v)))(
            jnp.asarray(xs))
        dev = M.reduce_moments(M.of(torch.from_numpy(xs)))
        got = dev.numpy().astype(np.float64)
        assert got[0] == pytest.approx(host.n)
        assert got[1] == pytest.approx(host.mean, rel=1e-5)
        assert got[2] == pytest.approx(host.m2, rel=1e-3)
        assert got[3] == pytest.approx(host.m3, rel=1e-2,
                                       abs=1e-2 * abs(host.m4))
        assert got[4] == pytest.approx(host.m4, rel=1e-2)
        _assert_moments(want, dev)

    def test_combine_zero_identity(self):
        m = M.of(torch.tensor(5.0))
        z = M.zero(device=CPU)
        assert z.shape == (5,) and not z.any()
        np.testing.assert_array_equal(M.combine(m, z).numpy(), m.numpy())
        np.testing.assert_array_equal(M.combine(z, m).numpy(), m.numpy())
        np.testing.assert_array_equal(m.numpy(), np.asarray(RM.of(
            jnp.asarray(5.0))))
        np.testing.assert_array_equal(M.zero((3, 2), device=CPU).numpy(),
                                      np.asarray(RM.zero((3, 2))))

    def test_segment_moments_exact(self):
        values = [10.0, 20.0, 30.0, 100.0, 5.0]
        seg = [0, 0, 0, 1, 2]
        out = M.segment_moments(torch.tensor(values), torch.tensor(seg), 4)
        _assert_moments(RM.segment_moments(jnp.asarray(values),
                                           jnp.asarray(seg), 4), out)
        out = out.numpy().astype(np.float64)
        ref0 = Moments.of_many([10.0, 20.0, 30.0])
        assert out[0][0] == 3 and out[0][1] == pytest.approx(ref0.mean)
        assert out[0][2] == pytest.approx(ref0.m2, rel=1e-5)
        assert out[1][0] == 1 and out[1][1] == 100.0
        assert out[3][0] == 0  # untouched segment

    def test_segment_moments_mask(self):
        values = [10.0, 999.0, 20.0]
        seg = [0, 0, 0]
        valid = [True, False, True]
        out = M.segment_moments(torch.tensor(values), torch.tensor(seg), 1,
                                valid=torch.tensor(valid))
        _assert_moments(RM.segment_moments(
            jnp.asarray(values), jnp.asarray(seg), 1,
            valid=jnp.asarray(valid)), out)
        assert out[0][0] == 2
        assert float(out[0][1]) == pytest.approx(15.0)

    @pytest.mark.parametrize("axis", [0, 1])
    def test_reduce_along_axis_and_accessors(self, axis):
        rng = np.random.default_rng(3 + axis)
        xs = rng.lognormal(6.0, 1.0, size=(3, 7, 4)).astype(np.float32)
        seg = rng.integers(0, 4, size=(3, 7, 4))
        stacks_ref = RM.segment_moments(jnp.asarray(xs.reshape(-1)),
                                        jnp.asarray(seg.reshape(-1)), 4)
        stack = M.segment_moments(torch.from_numpy(xs.reshape(-1)),
                                  torch.from_numpy(seg.reshape(-1)), 4)
        _assert_moments(stacks_ref, stack)
        # A [3, 5, 4, 5] stack of per-row moments, reduced along ``axis``.
        per = M.of(torch.from_numpy(xs[:, :5]))
        ref_per = RM.of(jnp.asarray(xs[:, :5]))
        got = M.reduce_moments(per, axis=axis)
        want = RM.reduce_moments(ref_per, axis=axis)
        assert tuple(got.shape) == tuple(want.shape)
        _assert_moments(want, got)
        for fn, rfn in ((M.count, RM.count), (M.mean, RM.mean),
                        (M.variance, RM.variance)):
            np.testing.assert_allclose(
                fn(got).numpy(), np.asarray(rfn(want)),
                rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(
                    rfn(want))).max()))
        np.testing.assert_array_equal(M.count(got).numpy(),
                                      np.asarray(RM.count(want)))


# ---------------------------------------------------------------------------
# Count-min
# ---------------------------------------------------------------------------


class TestCountMin:
    def test_exact_when_sparse(self):
        keys = np.arange(100, dtype=np.int64) * 7919
        hi, lo = H.split64(keys)
        sk = cms.update(cms.init(depth=4, width=1 << 12, device=CPU), hi, lo)
        ref = jax.jit(rcms.update)(rcms.init(depth=4, width=1 << 12), hi, lo)
        np.testing.assert_array_equal(sk.counts.numpy(),
                                      np.asarray(ref.counts))
        est = cms.query(sk, hi, lo).numpy()
        np.testing.assert_array_equal(est, np.ones(100))
        np.testing.assert_array_equal(est, np.asarray(rcms.query(
            ref, jnp.asarray(hi), jnp.asarray(lo))))
        assert (sk.depth, sk.width) == (ref.depth, ref.width)

    @pytest.mark.parametrize("pkg", PKGS, ids=_ids)
    def test_never_underestimates(self, pkg):
        rng = np.random.default_rng(1)
        keys = rng.integers(-(2**62), 2**62, size=5000, dtype=np.int64)
        true = {}
        for k in keys:
            true[k] = true.get(k, 0) + 1
        hi, lo = H.split64(keys)
        sk = pkg.cms.update(pkg.cms_init(depth=4, width=1 << 10), hi, lo)
        uniq = np.array(list(true), np.int64)
        uh, ul = H.split64(uniq)
        est = _np(pkg.cms.query(sk, uh, ul))
        want = np.array([true[k] for k in uniq])
        assert (est >= want).all()
        assert (est - want).mean() < np.e * len(keys) / (1 << 10)
        _equal(lambda p: p.cms.query(p.cms.update(
            p.cms_init(depth=4, width=1 << 10), hi, lo), uh, ul))

    def test_weights_and_merge(self):
        hi, lo = H.split64(np.array([42, 43], np.int64))

        def run(p):
            a = p.cms.update(p.cms_init(), hi, lo, weights=p.arr(
                np.array([5, 3], np.int32)))
            b = p.cms.update(p.cms_init(), hi, lo, weights=p.arr(
                np.array([1, 2], np.int32)))
            m = p.cms.merge(a, b)
            return m.counts, p.cms.query(m, hi, lo), p.cms.total(m)

        counts, est, total = _equal(run)
        np.testing.assert_array_equal(est.numpy(), [6, 5])
        assert int(total) == 11

    def test_duplicate_keys_in_batch(self):
        hi, lo = H.split64(np.array([7, 7, 7, 9], np.int64))
        qh, ql = H.split64(np.array([7, 9], np.int64))
        est = _equal(lambda p: p.cms.query(p.cms.update(p.cms_init(), hi,
                                                        lo), qh, ql))
        np.testing.assert_array_equal(est.numpy(), [3, 1])

    @pytest.mark.parametrize("dtype,weights", [
        ("int32", None), ("int32", "int64"), ("float32", None),
        ("float32", "float32"), ("int64", "int32")])
    def test_dtypes_and_weight_types(self, dtype, weights):
        """int32 counts with int32 (or no) weights go through the kernel
        wrapper (its twin on the CPU); the rest scatter with index_add_:
        both equal the reference's, weights cast to the counts' dtype."""
        rng = np.random.default_rng(5)
        keys = rng.integers(0, 300, 2000).astype(np.int64)
        hi, lo = H.split64(keys)
        w = (None if weights is None
             else rng.integers(1, 5, 2000).astype(weights))
        jd = {"int64": jnp.int32}.get(dtype, getattr(jnp, dtype))
        ref = rcms.update(rcms.init(width=1 << 8, dtype=jd), hi, lo,
                          weights=None if w is None else jnp.asarray(w))
        got = cms.update(cms.init(width=1 << 8, dtype=getattr(torch, dtype),
                                  device=CPU), hi, lo,
                         weights=None if w is None else torch.from_numpy(w))
        assert got.counts.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(ref.counts))

    def test_update_leaves_its_input_unchanged(self):
        hi, lo = H.split64(np.arange(50, dtype=np.int64))
        sk = cms.init(width=1 << 8, device=CPU)
        out = cms.update(sk, hi, lo)
        assert not sk.counts.any() and int(cms.total(out)) == 50
        # the twin never counts
        assert K.LAUNCHES["cms_update"] == K.LAUNCHES["flat_histogram"] == 0


# ---------------------------------------------------------------------------
# HyperLogLog
# ---------------------------------------------------------------------------


def _hll_both(keys, valid=None):
    hi, lo = H.split64(keys)
    ref = rhll.update(rhll.init(), hi, lo,
                      None if valid is None else jnp.asarray(valid))
    got = hll.update(hll.init(device=CPU), hi, lo,
                     None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got.registers.numpy(),
                                  np.asarray(ref.registers))
    want = float(rhll.estimate(ref))
    assert hll.estimate(got) == pytest.approx(want, rel=1e-5)
    return got, ref


class TestHLL:
    @pytest.mark.parametrize("n", [100, 10_000, 200_000])
    def test_cardinality_within_error(self, n):
        keys = np.arange(n, dtype=np.int64) * 2654435761 + 17
        got, ref = _hll_both(keys)
        for est in (hll.estimate(got), float(rhll.estimate(ref))):
            assert abs(est - n) / n < 0.033

    def test_duplicates_do_not_inflate(self):
        keys = np.tile(np.arange(1000, dtype=np.int64), 50)
        got, _ = _hll_both(keys)
        assert abs(hll.estimate(got) - 1000) / 1000 < 0.05

    @pytest.mark.parametrize("pkg", PKGS, ids=_ids)
    def test_merge_is_union(self, pkg):
        a_keys = np.arange(0, 30_000, dtype=np.int64)
        b_keys = np.arange(15_000, 45_000, dtype=np.int64)  # 50% overlap

        def merged(p):
            a = p.hll.update(p.hll_init(), *H.split64(a_keys))
            b = p.hll.update(p.hll_init(), *H.split64(b_keys))
            return p.hll.merge(a, b).registers

        est = float(pkg.hll.estimate(pkg.hll.HyperLogLog(
            merged(pkg))))
        assert abs(est - 45_000) / 45_000 < 0.033
        _equal(merged)

    def test_empty(self):
        assert hll.estimate(hll.init(device=CPU)) == 0.0
        assert float(rhll.estimate(rhll.init())) == 0.0
        assert hll.init(device=CPU).m == rhll.init().m

    def test_valid_mask_and_input_unchanged(self):
        keys = np.arange(5000, dtype=np.int64)
        valid = np.random.default_rng(6).random(5000) < 0.5
        got, _ = _hll_both(keys, valid)
        sk = hll.init(device=CPU)
        hll.update(sk, *H.split64(keys))
        assert not sk.registers.any()


# ---------------------------------------------------------------------------
# Log-histogram quantiles
# ---------------------------------------------------------------------------


def _assert_quantiles(want, got):
    """Equal in float32, NaN matching NaN."""
    np.testing.assert_array_equal(np.asarray(want, np.float32),
                                  _np(got).astype(np.float32))


class TestLogHistogram:
    @pytest.mark.parametrize("pkg", PKGS, ids=_ids)
    def test_relative_error_guarantee(self, pkg):
        rng = np.random.default_rng(2)
        xs = rng.lognormal(mean=9.0, sigma=1.5, size=50_000).astype(
            np.float32)
        sk = pkg.Q.update(pkg.q_init(alpha=0.01), pkg.arr(xs))
        for q in (0.5, 0.95, 0.99):
            got = float(pkg.Q.quantile(sk, q))
            want = float(np.quantile(xs, q))
            assert abs(got - want) / want < 0.021  # 2*alpha margin
        _equal(lambda p: p.Q.update(p.q_init(alpha=0.01),
                                    p.arr(xs)).counts)
        _equal(lambda p: tuple(p.Q.quantile(p.Q.update(
            p.q_init(alpha=0.01), p.arr(xs)), q) for q in (0.5, 0.95, 0.99)))

    def test_grouped_update(self):
        values = np.array([100.0, 200.0, 100.0, 1e6], np.float32)
        groups = np.array([0, 0, 1, 2], np.int32)

        def run(p):
            sk = p.Q.update_grouped(p.q_init(shape=(3,)), p.arr(groups),
                                    p.arr(values))
            return sk.counts, p.Q.count(sk), p.Q.quantile(sk, 0.5)

        _, counts, q50 = _equal(run)
        np.testing.assert_array_equal(counts.numpy(), [2, 1, 1])
        assert float(q50[2]) == pytest.approx(1e6, rel=0.02)

    def test_merge(self):
        def run(p):
            a = p.Q.update(p.q_init(), p.arr(np.full(100, 10.0, np.float32)))
            b = p.Q.update(p.q_init(),
                           p.arr(np.full(100, 1000.0, np.float32)))
            m = p.Q.merge(a, b)
            return p.Q.count(m), p.Q.quantile(m, 0.99), m.counts

        count, q99, _ = _equal(run)
        assert float(count) == 200
        assert float(q99) == pytest.approx(1000.0, rel=0.02)

    def test_empty_is_nan(self):
        got, want = Q.quantile(Q.init(device=CPU), 0.5), RQ.quantile(
            RQ.init(), 0.5)
        assert np.isnan(float(got))
        _assert_quantiles(want, got)

    def test_valid_mask(self):
        def run(p):
            sk = p.Q.update(p.q_init(), p.arr(np.array([10.0, 1e9],
                                                       np.float32)),
                            valid=p.arr(np.array([True, False])))
            return p.Q.count(sk), sk.counts

        count, _ = _equal(run)
        assert float(count) == 1

    @pytest.mark.parametrize("dtype", ["int32", "float32"])
    def test_banked_int32_and_float_counts_with_nan_rows(self, dtype):
        """A [40, 256] bank as the store keeps one (int32: the kernel
        wrapper's twin), groups past the bank clipped into it as the
        reference clips them, some rows empty (NaN quantiles)."""
        rng = np.random.default_rng(7)
        n = 20_000
        values = rng.integers(1, 5_000_000, n).astype(np.float32)
        groups = rng.integers(-3, 45, n).astype(np.int32)
        groups[groups == 17] = 18  # row 17 stays empty
        valid = rng.random(n) < 0.9

        def run(p):
            sk = p.Q.update_grouped(
                p.q_init(shape=(40,), n_buckets=256, dtype=dtype),
                p.arr(groups), p.arr(values), valid=p.arr(valid))
            return (sk.counts, p.Q.count(sk),
                    *(p.Q.quantile(sk, q) for q in (0.0, 0.5, 0.99, 1.0)))

        want, got = _both(run)
        np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
        for w, g in zip(want[2:], got[2:]):
            _assert_quantiles(w, g)
        assert np.isnan(_np(got[3])[17])

    def test_bucket_index_reads_as_the_reference(self):
        sk = Q.init(n_buckets=512, device=CPU)
        ref = RQ.init(n_buckets=512)
        xs = np.random.default_rng(8).integers(0, 10**7, 5000).astype(
            np.float32)
        np.testing.assert_array_equal(
            sk.bucket_index(xs).numpy(),
            np.asarray(RQ.bucket_index(ref, jnp.asarray(xs))))
        assert sk.n_buckets == ref.n_buckets and sk.gamma == ref.gamma


# ---------------------------------------------------------------------------
# Top-k
# ---------------------------------------------------------------------------


class TestTopK:
    def test_exact_topk(self):
        ids = np.array([5, 5, 5, 9, 9, 3], np.int32)
        vals, got = _equal(lambda p: p.topk.top_k(
            p.topk.update(p.topk_init(100), p.arr(ids)), 2))
        np.testing.assert_array_equal(got.numpy(), [5, 9])
        np.testing.assert_array_equal(vals.numpy(), [3, 2])

    def test_out_of_range_and_invalid_dropped(self):
        ids = np.array([0, 7, -1, 2, 2], np.int32)
        valid = np.array([True, True, True, True, False])
        counts = _equal(lambda p: p.topk.update(
            p.topk_init(4), p.arr(ids), valid=p.arr(valid)).counts)
        np.testing.assert_array_equal(counts.numpy(), [1, 0, 1, 0])

    def test_weighted_merge(self):
        def run(p):
            a = p.topk.update(p.topk_init(8), p.arr(np.array([1], np.int32)),
                              weights=p.arr(np.array([10.0], np.float32)))
            b = p.topk.update(p.topk_init(8),
                              p.arr(np.array([1, 2], np.int32)),
                              weights=p.arr(np.array([5.0, 99.0],
                                                     np.float32)))
            return p.topk.top_k(p.topk.merge(a, b), 2)

        vals, ids = _equal(run)
        np.testing.assert_array_equal(ids.numpy(), [2, 1])
        np.testing.assert_array_equal(vals.numpy(), [99.0, 15.0])

    def test_topk_from_cms(self):
        hi, lo = H.split64(np.array([11, 22, 33], np.int64))
        w = np.array([5, 50, 2], np.int32)
        vals, pos = _equal(lambda p: p.topk.topk_from_cms(p.cms.update(
            p.cms_init(), hi, lo, weights=p.arr(w)), p.arr(hi), p.arr(lo),
            2))
        assert int(pos[0]) == 1 and int(vals[0]) == 50

    @pytest.mark.parametrize("dtype", ["int32", "float32"])
    def test_ties_come_out_lowest_id_first(self, dtype):
        """Forced ties: 1,000 counters where most share a count; top_k
        must give jax.lax.top_k's order, equal counts by id."""
        rng = np.random.default_rng(9)
        ids = (rng.integers(0, 250, 30_000) * 4).astype(np.int32)
        valid = rng.random(30_000) < 0.95
        for k in (1, 10, 999, 1000, 1200):
            vals, got = _equal(lambda p: p.topk.top_k(p.topk.update(
                p.topk_init(1000, dtype=dtype), p.arr(ids),
                valid=p.arr(valid)), k))
            counts = np.bincount(ids[valid], minlength=1000)
            order = np.lexsort((np.arange(1000), -counts))[:min(k, 1000)]
            np.testing.assert_array_equal(got.numpy(), order)

    def test_topk_from_cms_ties(self):
        rng = np.random.default_rng(10)
        keys = rng.integers(0, 400, 6000).astype(np.int64)
        hi, lo = H.split64(keys)
        ch, cl = H.split64(np.arange(400, dtype=np.int64))
        for k in (5, 50, 400, 500):
            _equal(lambda p: p.topk.topk_from_cms(p.cms.update(
                p.cms_init(width=1 << 6), hi, lo), p.arr(ch), p.arr(cl), k))

    def test_store_reads_share_the_tie_rule(self):
        assert tdev.topk_desc is topk.topk_desc
