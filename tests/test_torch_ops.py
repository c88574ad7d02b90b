"""The port's device primitives against their ``zipkin_tpu.ops``
originals, on the CPU: hashing, HLL and count-min indices bitwise; the
log-histogram bucket index bitwise except where the reference's float32
log is not correctly rounded (ROADMAP.md, Queue 3); moments with the
count field exact and float fields within rtol=1e-5 (float32 sums in
another order)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from zipkin_tpu.ops import cms as jcms  # noqa: E402
from zipkin_tpu.ops import hashing as jh  # noqa: E402
from zipkin_tpu.ops import hll as jhll  # noqa: E402
from zipkin_tpu.ops import join as jjoin  # noqa: E402
from zipkin_tpu.ops import moments as jm  # noqa: E402
from zipkin_tpu.ops import quantile as jq  # noqa: E402
from zipkin_tpu_torch.ops import cms as tcms  # noqa: E402
from zipkin_tpu_torch.ops import hashing as th  # noqa: E402
from zipkin_tpu_torch.ops import hll as thll  # noqa: E402
from zipkin_tpu_torch.ops import join as tjoin  # noqa: E402
from zipkin_tpu_torch.ops import moments as tm  # noqa: E402
from zipkin_tpu_torch.ops import quantile as tq  # noqa: E402


def _ids(seed: int, n: int = 4000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, -1, 2**63 - 1, -(2**63), -(2**63) + 1,
                     2**32, 2**32 - 1, -(2**32)], np.int64)
    return np.concatenate([edge, rng.integers(-(2**63), 2**63 - 1, n,
                                              dtype=np.int64)])


def _u64_as_i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint64).view(np.int64)


def test_split_fmix_hash2():
    x = _ids(1)
    hi, lo = jh.dev_split64(jnp.asarray(x))
    thi, tlo = th.dev_split64(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(hi, np.int64), thi.numpy())
    np.testing.assert_array_equal(np.asarray(lo, np.int64), tlo.numpy())
    np.testing.assert_array_equal(
        np.asarray(jh.fmix32(lo), np.int64), th.fmix32(tlo).numpy())
    for seed in (0, 1, 101, 202):
        np.testing.assert_array_equal(
            np.asarray(jh.hash2_32(hi, lo, seed), np.int64),
            th.hash2_32(thi, tlo, seed).numpy())
    np.testing.assert_array_equal(
        np.asarray(jh.clz32(lo), np.int32), th.clz32(tlo).numpy())


@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_mix_keys64(n_keys):
    cols = [_ids(10 + i) for i in range(n_keys)]
    want = _u64_as_i64(jh.mix_keys64([jnp.asarray(c) for c in cols]))
    got = th.mix_keys64([torch.from_numpy(c) for c in cols]).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        _u64_as_i64(jh.np_mix_keys64(cols)), got)
    # The port's host mirror (checkpoint migrations) is the same word.
    np.testing.assert_array_equal(
        _u64_as_i64(th.np_mix_keys64(cols)), got)


def test_hll_and_cms_indices():
    x = _ids(2)
    hi, lo = jh.dev_split64(jnp.asarray(x))
    thi, tlo = th.dev_split64(torch.from_numpy(x))
    valid = np.random.default_rng(3).random(x.shape[0]) < 0.8
    want = jhll.update(jhll.init(10), hi, lo, valid=jnp.asarray(valid))
    regs = torch.zeros(1 << 10, dtype=torch.int32)
    thll.update_(regs, thi, tlo, torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(want.registers), regs.numpy())
    assert thll.estimate(regs.numpy()) == pytest.approx(
        float(jhll.estimate(want)), rel=1e-5)
    sk = jcms.init(4, 1 << 12)
    np.testing.assert_array_equal(
        np.asarray(jcms._indices(sk, hi, lo), np.int64),
        tcms.indices(4, 1 << 12, thi, tlo).numpy())


def _edge_values(n_buckets: int, gamma: float) -> np.ndarray:
    """Float32 values at -2..+2 ulp of every bucket edge gamma^k."""
    edges = np.array([gamma ** k for k in range(n_buckets)],
                     np.float64).astype(np.float32)
    out = [edges]
    for direction in (np.float32(0), np.float32(np.inf)):
        x = edges
        for _ in range(2):
            x = np.nextafter(x, direction)
            out.append(x)
    v = np.concatenate(out)
    return v[np.isfinite(v)]


@pytest.mark.parametrize("n_buckets,alpha", [(2048, 0.01), (512, 0.01),
                                             (256, 0.05)])
def test_bucket_index_at_edges(n_buckets, alpha):
    gamma = (1 + alpha) / (1 - alpha)
    sk = jq.init(n_buckets=n_buckets, alpha=alpha)
    v = _edge_values(n_buckets, gamma)
    want = np.asarray(jq.bucket_index(sk, jnp.asarray(v)))
    got = tq.bucket_index(torch.from_numpy(v), n_buckets, gamma).numpy()
    # Where the two differ, the reference's float32 log of that value is
    # not the correctly rounded one; everywhere else they are bitwise.
    vm = np.maximum(v, np.float32(1))
    ref_log = np.asarray(jnp.log(jnp.asarray(vm)))
    cr_log = np.log(vm.astype(np.float64)).astype(np.float32)
    differ = want != got
    assert np.all(ref_log[differ] != cr_log[differ])
    assert differ.mean() < 0.02
    assert np.all(np.abs(want.astype(int) - got) <= 1)
    # Integer durations (what the store feeds) and random values.
    rng = np.random.default_rng(5)
    d = np.concatenate([np.arange(-2, 5000), rng.integers(
        0, 2**40, 20000)]).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jq.bucket_index(sk, jnp.asarray(d))),
        tq.bucket_index(torch.from_numpy(d), n_buckets, gamma).numpy())


def test_segment_moments_and_combine():
    rng = np.random.default_rng(9)
    x = rng.lognormal(11, 1, 6000).astype(np.int64).astype(np.float32)
    seg = rng.integers(0, 70, 6000).astype(np.int32)
    valid = rng.random(6000) < 0.9
    want = np.asarray(jm.segment_moments(jnp.asarray(x), jnp.asarray(seg),
                                         64, valid=jnp.asarray(valid)))
    got = tm.segment_moments(torch.from_numpy(x), torch.from_numpy(seg), 64,
                             torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(want[:, 0], got[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=1e-5)
    a, b = want[:32].copy(), want[32:].copy()
    b[::5] = 0  # empty sides take the monoid identity path
    cw = np.asarray(jm.combine(jnp.asarray(a), jnp.asarray(b)))
    cg = tm.combine(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(cw[:, 0], cg[:, 0])
    np.testing.assert_allclose(cg[:, 1:], cw[:, 1:], rtol=1e-5)
    stack = want[:48].reshape(3, 16, 5)
    np.testing.assert_allclose(
        tm.reduce_moments(torch.from_numpy(stack)).numpy(),
        np.asarray(jm.reduce_moments(jnp.asarray(stack), axis=0)),
        rtol=1e-5)


def test_join_lookup_keeps_latest_duplicate():
    rng = np.random.default_rng(4)
    n = 500
    tid = rng.integers(0, 40, n).astype(np.int64)
    sid = rng.integers(0, 40, n).astype(np.int64)  # many duplicate keys
    pid = rng.integers(0, 40, n).astype(np.int64)
    val = rng.integers(0, 1000, n).astype(np.int32)
    bv = rng.random(n) < 0.9
    pv = rng.random(n) < 0.9
    f, v = jjoin.lookup((jnp.asarray(tid), jnp.asarray(sid)),
                        jnp.asarray(bv), jnp.asarray(val),
                        (jnp.asarray(tid), jnp.asarray(pid)),
                        jnp.asarray(pv))
    t = torch.from_numpy
    tf, tv = tjoin.lookup((t(tid), t(sid)), t(bv), t(val),
                          (t(tid), t(pid)), t(pv))
    np.testing.assert_array_equal(np.asarray(f), tf.numpy())
    np.testing.assert_array_equal(np.asarray(v), tv.numpy())
    assert tf.numpy().any()


def test_gamma_matches():
    assert tq.gamma_of(0.01) == pytest.approx((1.01) / (0.99))
    assert math.isfinite(tq.gamma_of(0.05))
