"""Adaptive sample-rate controller as a pure-function pipeline.

Reference: AdaptiveSampler.scala:59-71 — the calculator is the chain
``RequestRateCheck → SufficientDataCheck → ValidDataCheck → OutlierCheck
→ CalculateSampleRate (→ IsLeaderCheck → CooldownCheck)``, each an
``Option[A] => Option[B]``. Here each stage is a pure function over
``Optional`` values, so everything is unit-testable without any
coordination infrastructure — the same decomposition the reference's
tests rely on (AdaptiveSamplerTest.scala:26-50).

Differences by design (SURVEY.md §3.5): there is no ZooKeeper. The
controller runs on the single Python controller process (the "leader" by
construction), and the global store rate comes from the device ingest
counters — summed across shards with a psum/sum rather than a ZK group
snapshot (GlobalSampleRateUpdater's role, AdaptiveSampler.scala:204-237).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence


def request_rate_check(vals: Optional[Sequence[float]], target_rate: float
                       ) -> Optional[Sequence[float]]:
    """Pass only when a positive target store rate is configured
    (RequestRateCheck, AdaptiveSampler.scala:239)."""
    return vals if (vals is not None and target_rate > 0) else None


def sufficient_data_check(vals: Optional[Sequence[float]], required: int
                          ) -> Optional[Sequence[float]]:
    """Pass only with a full-enough window (SufficientDataCheck :259)."""
    return vals if (vals is not None and len(vals) >= required) else None


def valid_data_check(vals: Optional[Sequence[float]]
                     ) -> Optional[Sequence[float]]:
    """Pass only when every datum is non-negative (ValidDataCheck :276)."""
    return vals if (vals is not None and all(v >= 0 for v in vals)) else None


def outlier_check(vals: Optional[Sequence[float]], target_rate: float,
                  required_points: int, threshold: float = 0.15
                  ) -> Optional[Sequence[float]]:
    """Pass only when the last ``required_points`` data all deviate from
    the target by more than ``threshold`` (OutlierCheck :311): the rate
    only moves when the flow is *persistently* off-target."""
    if vals is None or len(vals) < required_points:
        return None
    tail = list(vals)[-required_points:]
    if all(abs(v - target_rate) > target_rate * threshold for v in tail):
        return vals
    return None


def discounted_average(vals: Sequence[float], discount: float = 0.9) -> float:
    """Recency-weighted mean; vals[-1] is the newest sample
    (DiscountedAverage, AdaptiveSampler.scala:332)."""
    newest_first = list(reversed(list(vals)))
    weights = [discount**i for i in range(len(newest_first))]
    return sum(w * v for w, v in zip(weights, newest_first)) / sum(weights)


def calculate_sample_rate(
    vals: Optional[Sequence[float]],
    current_rate: float,
    target_store_rate: float,
    threshold: float = 0.05,
    max_rate: float = 1.0,
) -> Optional[float]:
    """Linear controller (CalculateSampleRate :344-390):

        new = current * target_store_rate / current_store_rate

    clamped to ``max_rate``; suppressed when the relative change is below
    ``threshold`` (5%) so the fleet isn't churned by noise."""
    if vals is None:
        return None
    cur_store_rate = discounted_average(vals)
    if cur_store_rate <= 0:
        return None
    new_rate = min(max_rate, current_rate * target_store_rate / cur_store_rate)
    change = abs(current_rate - new_rate) / current_rate
    return new_rate if change >= threshold else None


def cooldown_check(value, now_s: float, last_update_s: Optional[float],
                   period_s: float):
    """Rate updates at most once per ``period_s`` (CooldownCheck :293)."""
    if value is None:
        return None
    if last_update_s is not None and now_s - last_update_s < period_s:
        return None
    return value


@dataclass
class AdaptiveConfig:
    """Flag parity with AdaptiveSampler.scala:33-57 (seconds, not Durations)."""

    target_store_rate: float = 0.0  # spans/minute to admit; 0 = disabled
    update_freq_s: float = 30.0
    window_s: float = 30 * 60.0
    sufficient_window_s: float = 10 * 60.0
    outlier_window_s: float = 5 * 60.0
    outlier_threshold: float = 0.15
    change_threshold: float = 0.05
    max_rate: float = 1.0
    cooldown_s: float = 0.0

    @property
    def window_len(self) -> int:
        return max(1, int(self.window_s / self.update_freq_s))

    @property
    def sufficient_len(self) -> int:
        return max(1, int(self.sufficient_window_s / self.update_freq_s))

    @property
    def outlier_len(self) -> int:
        return max(1, int(self.outlier_window_s / self.update_freq_s))


class AdaptiveSampleRateController:
    """Single-controller loop: feed store rates, get rate updates.

    ``observe(store_rate, now_s)`` is called every ``update_freq_s`` with
    the global spans/minute admitted (from device counters, psum-ed
    across shards). Returns the new sample rate when the pipeline decides
    to move, else None. ``rate`` always holds the current value.
    """

    def __init__(self, config: AdaptiveConfig, initial_rate: float = 1.0):
        self.config = config
        self.rate = initial_rate
        self.buffer: List[float] = []  # AtomicRingBuffer analogue
        self.last_update_s: Optional[float] = None

    def observe(self, store_rate: float, now_s: float) -> Optional[float]:
        c = self.config
        self.buffer.append(float(store_rate))
        if len(self.buffer) > c.window_len:
            self.buffer = self.buffer[-c.window_len:]
        vals: Optional[Sequence[float]] = list(self.buffer)
        vals = request_rate_check(vals, c.target_store_rate)
        vals = sufficient_data_check(vals, c.sufficient_len)
        vals = valid_data_check(vals)
        vals = outlier_check(vals, c.target_store_rate, c.outlier_len,
                             c.outlier_threshold)
        new_rate = calculate_sample_rate(
            vals, self.rate, c.target_store_rate, c.change_threshold, c.max_rate
        )
        new_rate = cooldown_check(new_rate, now_s, self.last_update_s,
                                  c.cooldown_s)
        if new_rate is not None:
            self.rate = new_rate
            self.last_update_s = now_s
        return new_rate


class FlowEstimator:
    """spans/minute from a monotonically increasing span counter — the
    FlowReportingFilter analogue (AdaptiveSampler.scala:151-174), reading
    the device ``spans_seen`` counter instead of wrapping the pipeline."""

    def __init__(self):
        self._last_count: Optional[float] = None
        self._last_ts: Optional[float] = None

    def observe(self, total_spans: float, now_s: float) -> Optional[float]:
        if self._last_count is None or now_s <= self._last_ts:
            self._last_count, self._last_ts = total_spans, now_s
            return None
        per_min = (total_spans - self._last_count) * 60.0 / (now_s - self._last_ts)
        self._last_count, self._last_ts = total_spans, now_s
        return per_min
