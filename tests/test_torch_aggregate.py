"""The port's dependency jobs (``zipkin_tpu_torch/aggregate/job.py``)
and ``store/device.recompute_dep_moments`` against the JAX package's,
on the CPU.

``recompute_dep_moments`` runs on a port state carried over from the
JAX store's leaves (``state_from_numpy``) and holds the JAX function's
bank by stated tolerance 2 (the count field exact, the other fields
within 1e-5 of the field's largest magnitude: float32 sums in another
order). ``recompute_dependencies`` over a port store fed the same spans
as a ``TpuSpanStore`` gives the same links by the same rule and the
same time range. The host jobs (``aggregate_spans``,
``IncrementalAggregator``, the bank decoders) are float64 Python in
both packages and equal exactly.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_aggregate import API, DB, WEB, rpc, split_halves  # noqa: E402
from test_torch_archive import port_tiered  # noqa: E402
from test_torch_ingest import assert_links_close  # noqa: E402
from test_torch_store import (  # noqa: E402
    PORT,
    REF,
    SMALL,
    WINDOW_KW,
    _convert,
    _links,
    jax_leaves,
    moments_close,
)
from zipkin_tpu.aggregate import job as ref_job  # noqa: E402
from zipkin_tpu.columnar.dictionary import Dictionary as RefDict  # noqa: E402
from zipkin_tpu.store import device as dev  # noqa: E402
from zipkin_tpu.store.tpu import TpuSpanStore  # noqa: E402
from zipkin_tpu.tracegen import generate_traces  # noqa: E402
from zipkin_tpu_torch.aggregate import (  # noqa: E402
    IncrementalAggregator,
    aggregate_spans,
    dependencies_from_bank,
    links_from_bank,
    recompute_dependencies,
)
from zipkin_tpu_torch.columnar.dictionary import Dictionary  # noqa: E402
from zipkin_tpu_torch.store import device as tdev  # noqa: E402
from zipkin_tpu_torch.store.convert import state_from_numpy  # noqa: E402
from zipkin_tpu_torch.store.torch_store import TorchSpanStore  # noqa: E402

def _spans(seed: int, n_traces: int):
    rng = np.random.default_rng(seed)
    traces = generate_traces(n_traces=n_traces, max_depth=4, n_services=12,
                             rng=rng)
    spans = [s for t in traces for s in t]
    # Children often arrive before their parents.
    return [spans[i] for i in rng.permutation(len(spans))]


@pytest.fixture(scope="module")
def drives():
    """The same spans through a JAX store and a port store, on the ring
    (450 traces: past two laps, so the join sees only the live rows)
    and with the windowed arena on. Also the JAX state and recompute
    bank after the first apply (every span live)."""
    out = {}
    for name, cfg, n_traces in (("ring", SMALL, 450),
                                ("window", dict(SMALL, **WINDOW_KW), 150)):
        ref = TpuSpanStore(dev.StoreConfig(**cfg))
        port = TorchSpanStore(tdev.StoreConfig(**cfg), device="cpu")
        spans = _spans(5, n_traces)
        for i in range(0, len(spans), 200):
            ref.apply(spans[i:i + 200])
            port.apply(_convert(spans[i:i + 200], PORT))
            if i == 0 and name == "ring":
                out["fresh"] = (cfg, jax_leaves(ref.state), np.asarray(
                    dev.recompute_dep_moments(ref.state)))
        out[name] = (cfg, jax_leaves(ref.state),
                     np.asarray(dev.recompute_dep_moments(ref.state)))
        out[name + "_stores"] = (ref, port)
    return out


@pytest.mark.parametrize("case", ["fresh", "ring", "window"])
def test_recompute_dep_moments_matches_reference(drives, case):
    cfg, leaves, want = drives[case]
    st = state_from_numpy(tdev.StoreConfig(**cfg), leaves, "cpu")
    got = tdev.recompute_dep_moments(st)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert moments_close(want, got.numpy())
    assert want[:, 0].sum() > 0


@pytest.mark.parametrize("case", ["ring", "window"])
def test_recompute_dependencies_matches_reference(drives, case):
    ref, port = drives[case + "_stores"]
    want = ref_job.recompute_dependencies(ref)
    got = recompute_dependencies(port)
    assert (got.start_time, got.end_time) == (want.start_time,
                                              want.end_time)
    assert_links_close(_links(want), _convert(_links(got), REF))


def test_recompute_matches_streaming_in_retention():
    port = TorchSpanStore(tdev.StoreConfig(**SMALL), device="cpu")
    spans = _convert(_spans(3, 30), PORT)
    port.apply(spans)
    streaming = _links(port.get_dependencies())
    recomputed = _links(recompute_dependencies(port))
    assert [x[:2] for x in streaming] == [x[:2] for x in recomputed]
    assert [m.n for _, _, m in streaming] == [m.n for _, _, m in recomputed]
    oracle = _links(aggregate_spans(spans))
    assert [(p, c, m.n) for p, c, m in oracle] == [
        (p, c, m.n) for p, c, m in recomputed]


def test_recompute_runs_beside_an_async_sealer():
    """The job takes the state lock only; a sealer working through a
    backlog of capture windows does not hold it up."""
    tiered = port_tiered(backlog=2)
    spans = _convert(_spans(9, 900), PORT)
    for i in range(0, len(spans), 200):
        tiered.apply(spans[i:i + 200])
    out = []
    t = threading.Thread(target=lambda: out.append(
        recompute_dependencies(tiered.hot)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and out[0].links
    tiered.seal_barrier()
    assert tiered.hot.eviction_sealer().c_sealed.value >= 1
    tiered.close()


@pytest.mark.parametrize("seed", [1, 2])
def test_aggregate_spans_matches_reference(seed):
    rng = np.random.default_rng(seed)
    spans = _spans(seed, 40)
    spans += split_halves(7, 1, None, WEB, API, 0, 1000)
    spans += split_halves(7, 2, 1, API, DB, 100, 400)
    spans += [rpc(8, 2, 99, API, DB, 0, 100)]
    want = ref_job.aggregate_spans(spans)
    got = aggregate_spans(_convert(spans, PORT))
    assert _convert(got, REF) == want and want.links
    lo, hi = sorted(rng.integers(0, 2**40, 2).tolist())
    assert _convert(aggregate_spans(_convert(spans, PORT), lo, hi), REF) \
        == ref_job.aggregate_spans(spans, lo, hi)


@pytest.mark.parametrize("batch_size,resume", [(3, None), (50, None),
                                               (10_000, 1_000_002_000_000)])
def test_incremental_aggregator_matches_reference(batch_size, resume):
    spans = _spans(4, 60)
    a = ref_job.IncrementalAggregator(batch_size=batch_size,
                                      resume_ts=resume)
    b = IncrementalAggregator(batch_size=batch_size, resume_ts=resume)
    for i in range(0, len(spans), 97):
        a.offer(spans[i:i + 97])
        b.offer(_convert(spans[i:i + 97], PORT))
        assert b.resume_from() == a.resume_from()
    assert _convert(b.result(), REF) == a.result()
    assert a.result().links


def test_bank_decoders_match_reference():
    rng = np.random.default_rng(6)
    S = 8
    bank = np.zeros((S * S, 5), np.float32)
    cells = rng.choice(S * S, 20, replace=False)
    bank[cells, 0] = rng.integers(1, 50, 20)
    bank[cells, 1:] = rng.random((20, 4)) * 1000
    names = [f"svc-{i}" for i in range(6)]  # ids 6, 7 undecodable
    ref_d, port_d = RefDict(), Dictionary()
    for n in names:
        ref_d.encode(n)
        port_d.encode(n)
    assert _convert(links_from_bank(bank, port_d, S), REF) == \
        ref_job.links_from_bank(bank, ref_d, S)
    for lo, hi in ((1.0, 9.0), (5.0, 2.0)):
        assert _convert(dependencies_from_bank(bank, port_d, S, lo, hi),
                        REF) == ref_job.dependencies_from_bank(
                            bank, ref_d, S, lo, hi)
    empty = np.zeros_like(bank)
    assert _convert(dependencies_from_bank(empty, port_d, S, 5.0, 2.0),
                    REF) == ref_job.dependencies_from_bank(empty, ref_d, S,
                                                           5.0, 2.0)
