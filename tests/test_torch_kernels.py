"""The port's two kernels: plain twins against the JAX package's Pallas
kernels (interpret mode on the CPU, as tests/test_pallas_kernels.py
runs them) and its XLA formulations, bitwise. The CUDA kernels against
their twins are in tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from zipkin_tpu.ops import pallas_kernels as pk  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu_torch.ops import kernels as K  # noqa: E402


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
