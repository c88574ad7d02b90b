"""The port's sampler (``zipkin_tpu_torch/sampler``) against the JAX
package's, on the CPU. Exact equality throughout: ``sample_mask`` on
torch tensors equals the JAX function's mask (seeded trace ids with
``LONG_MIN``, ``LONG_MAX``, 0 and -1, debug flags, thresholds from 0 to
``LONG_MAX``), ``rate_to_threshold`` and the host ``Sampler`` equal the
reference's, and the adaptive stages, the controller and the
``FlowEstimator`` give the reference's trajectories over seeded
sequences."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from zipkin_tpu import sampler as ref  # noqa: E402
from zipkin_tpu.sampler.adaptive import (  # noqa: E402
    FlowEstimator as RefFlow,
)
from zipkin_tpu_torch import sampler as port  # noqa: E402
from zipkin_tpu_torch.sampler.adaptive import FlowEstimator  # noqa: E402
from zipkin_tpu_torch.sampler.core import LONG_MAX, LONG_MIN  # noqa: E402

RATES = (0.0, 1e-9, 0.01, 0.2, 0.25, 0.5, 0.999, 1.0 - 1e-12, 1.0, 1.5,
         -0.3)


def _tids(seed: int, n: int = 20_000):
    rng = np.random.default_rng(seed)
    tids = rng.integers(LONG_MIN, LONG_MAX, size=n, dtype=np.int64,
                        endpoint=True)
    tids[:6] = [LONG_MIN, LONG_MAX, 0, -1, 1, LONG_MIN + 1]
    debug = rng.random(n) < 0.05
    return tids, debug


def test_rate_to_threshold_matches_reference():
    rng = np.random.default_rng(1)
    for r in list(RATES) + list(rng.random(200)):
        assert port.rate_to_threshold(r) == ref.rate_to_threshold(r), r


@pytest.mark.parametrize("rate", [0.0, 0.01, 0.5, 0.999, 1.0])
def test_sample_mask_matches_reference(rate):
    tids, debug = _tids(seed=int(rate * 1000) + 2)
    th = ref.rate_to_threshold(rate)
    want = np.asarray(ref.sample_mask(jnp.asarray(tids),
                                      jnp.asarray(debug), th))
    got = port.sample_mask(torch.from_numpy(tids), torch.from_numpy(debug),
                           port.rate_to_threshold(rate))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    # LONG_MIN maps to LONG_MAX: kept at every threshold below LONG_MAX.
    assert bool(got[0]) == (th < LONG_MAX or bool(debug[0]))


def test_sample_mask_threshold_extremes_and_tensor_threshold():
    tids, debug = _tids(seed=9, n=4096)
    for th in (0, -5, 1, LONG_MAX - 1, LONG_MAX):
        want = np.asarray(ref.sample_mask(jnp.asarray(tids),
                                          jnp.asarray(debug), th))
        got = port.sample_mask(torch.from_numpy(tids),
                               torch.from_numpy(debug), th)
        assert np.array_equal(got.numpy(), want), th
        t = torch.tensor(th, dtype=torch.int64)
        assert np.array_equal(port.sample_mask(
            torch.from_numpy(tids), torch.from_numpy(debug), t).numpy(),
            want), th


def test_host_sampler_matches_reference():
    tids, _ = _tids(seed=4, n=3000)
    for rate in (0.0, 0.35, 1.0):
        a, b = ref.Sampler(rate), port.Sampler(rate)
        assert a.threshold == b.threshold
        assert [a(int(t)) for t in tids] == [b(int(t)) for t in tids]
        assert a.snapshot() == b.snapshot()
        assert [a.decide(int(t)) for t in tids[:50]] == [
            b.decide(int(t)) for t in tids[:50]]


def test_adaptive_stages_match_reference():
    rng = np.random.default_rng(6)
    for _ in range(300):
        n = int(rng.integers(0, 12))
        vals = list(rng.normal(100, 40, n))
        if rng.random() < 0.2 and n:
            vals[int(rng.integers(n))] = -1.0
        target = float(rng.choice([0.0, 50.0, 100.0, 250.0]))
        req = int(rng.integers(1, 8))
        for name, args in (
                ("request_rate_check", (vals, target)),
                ("sufficient_data_check", (vals, req)),
                ("valid_data_check", (vals,)),
                ("outlier_check", (vals, target, req)),
                ("calculate_sample_rate",
                 (vals, float(rng.random()), max(target, 1.0))),
                ("cooldown_check", (float(rng.random()),
                                    float(rng.integers(0, 100)),
                                    float(rng.integers(0, 100)), 30.0))):
            if name == "calculate_sample_rate" and not vals:
                continue
            assert getattr(port, name)(*args) == getattr(ref, name)(
                *args), name
        if vals:
            assert port.discounted_average(vals) == \
                ref.discounted_average(vals)


@pytest.mark.parametrize("target,flow", [(100.0, 400.0), (100.0, 100.0),
                                         (0.0, 500.0), (250.0, 90.0)])
def test_controller_and_flow_trajectories_match_reference(target, flow):
    kw = dict(target_store_rate=target, update_freq_s=30.0, window_s=300.0,
              sufficient_window_s=90.0, outlier_window_s=60.0,
              cooldown_s=45.0)
    a = ref.AdaptiveSampleRateController(ref.AdaptiveConfig(**kw))
    b = port.AdaptiveSampleRateController(port.AdaptiveConfig(**kw))
    fa, fb = RefFlow(), FlowEstimator()
    rng = np.random.default_rng(int(target + flow))
    total_a = total_b = 0.0
    trajectory = []
    for i in range(60):
        now = 30.0 * i + float(rng.random())
        noise = float(rng.normal(0, 5))
        total_a += (flow + noise) * a.rate / 2
        total_b += (flow + noise) * b.rate / 2
        ra, rb = fa.observe(total_a, now), fb.observe(total_b, now)
        assert ra == rb
        if ra is None:
            continue
        got = (a.observe(ra, now), b.observe(rb, now))
        assert got[0] == got[1]
        trajectory.append(b.rate)
    assert a.rate == b.rate and a.buffer == b.buffer
    assert a.last_update_s == b.last_update_s
    if target and flow > 2 * target:
        assert trajectory[-1] < 1.0
