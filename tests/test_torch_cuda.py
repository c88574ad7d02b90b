"""Each CUDA kernel of the port against its plain twin, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()``
is false. This file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 300, 1024, 100_000])
def test_cuda_arena_matches_twin(cuda, n):
    args = _arena_case(5 + n, n, n_b=997, depth=16)
    want = K.arena_claim_scatter(*(a.clone() if torch.is_tensor(a) else a
                                   for a in args))
    got = K.arena_claim_scatter(*(a.to(cuda) if torch.is_tensor(a) else a
                                  for a in args))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(want.numpy(), got.cpu().numpy())


@pytest.mark.cuda
def test_cuda_wrappers_check_inputs(cuda):
    counts = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        K.histogram_update(counts, torch.zeros(4, dtype=torch.int64,
                                               device=cuda),
                           torch.ones(4, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
def test_cuda_arena_long_tiles_and_overflow(cuda, monkeypatch):
    # A small scratch budget forces 3 tiles of ~17k rows: the in-tile
    # predecessor scan crosses many 256-row chunks.
    monkeypatch.setattr(K, "ARENA_SCRATCH_CELLS", 997 * 3)
    args = list(_arena_case(1, 50_000, 997, 16))
    n_over = 40  # one bucket overflows its depth of 16 inside the batch
    args[1][:n_over] = 3
    args[2][:n_over] = 7
    args[3][:n_over] = 3 * 16
    args[6][:n_over] = True
    want = K.arena_claim_scatter(*(a.clone() if torch.is_tensor(a) else a
                                   for a in args))
    got = K.arena_claim_scatter(*(a.to(cuda) if torch.is_tensor(a) else a
                                  for a in args))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(want.numpy(), got.cpu().numpy())
