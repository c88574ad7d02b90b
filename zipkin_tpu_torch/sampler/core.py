"""Trace-id sampling: the vectorized threshold test.

Reference semantics (zipkin-sampler/.../Sampler.scala:39-48): keep a
trace iff ``rate == 1`` or ``t > Long.MaxValue * (1 - rate)`` where ``t``
is ``abs(traceId)`` (with ``Long.MinValue`` mapped to ``Long.MaxValue``).
Because trace ids are uniform random 64-bit ints, this passes an
unbiased ``rate`` fraction and is *consistent*: every collector makes
the same decision for the same trace id at the same rate.

The debug override (SpanSamplerFilter.scala:40-47: spans with the debug
flag always pass) is part of ``sample_mask``.

The float→threshold conversion happens once on the host in float64
(``rate_to_threshold``); ``sample_mask`` compares 64-bit ints exactly on
the tensors' own device, so no float64 reaches the card.
"""

from __future__ import annotations

import threading

import torch

LONG_MAX = (1 << 63) - 1
LONG_MIN = -(1 << 63)


def rate_to_threshold(rate: float) -> int:
    """Host: sample rate in [0,1] → int64 threshold (exclusive lower bound)."""
    rate = min(max(float(rate), 0.0), 1.0)
    # float64 LONG_MAX rounds to 2^63; clamp back into int64 range.
    return min(int(LONG_MAX * (1.0 - rate)), LONG_MAX)


def sample_mask(trace_ids, debug, threshold):
    """Keep-mask for a batch, on the device of ``trace_ids``.

    ``trace_ids`` int64, ``debug`` bool, ``threshold`` int64 scalar from
    ``rate_to_threshold`` (0 keeps everything). ``abs(LONG_MIN)`` wraps
    to ``LONG_MIN``, so the ``where`` maps it to ``LONG_MAX`` first.
    """
    tids = torch.as_tensor(trace_ids, dtype=torch.int64)
    debug = torch.as_tensor(debug, dtype=torch.bool, device=tids.device)
    t = torch.where(tids == LONG_MIN, torch.full_like(tids, LONG_MAX),
                    torch.abs(tids))
    return debug | (threshold <= 0) | (t > threshold)


class Sampler:
    """Host-side stateful wrapper with counters (Sampler.scala:27).

    The rate is a plain attribute (the Var analogue); the adaptive
    controller updates it.
    """

    def __init__(self, rate: float = 1.0):
        self.rate = rate
        self.allowed = 0  # guarded-by: lock
        self.denied = 0  # guarded-by: lock
        # Counters are bumped from every collector worker thread; an
        # unlocked read-modify-write loses increments under concurrency
        # and skews the adaptive controller's inputs.
        self.lock = threading.Lock()  # lock-order: 80 sampler

    @property
    def threshold(self) -> int:
        return rate_to_threshold(self.rate)

    def count(self, allowed: int, denied: int) -> None:
        """Thread-safe bulk counter update (fast-path batches)."""
        with self.lock:
            self.allowed += allowed
            self.denied += denied

    def snapshot(self):
        """(allowed, denied) under the lock — the metrics read path
        (the collector's gauges read these from the exposition thread
        while workers bump them; graftlint guarded-by)."""
        with self.lock:
            return self.allowed, self.denied

    def decide(self, trace_id: int) -> bool:
        """Pure threshold test, no counters, no lock — batch callers
        fold their decisions into one count() per batch instead of
        taking the lock once per span."""
        if self.rate >= 1.0:
            return True
        t = LONG_MAX if trace_id == LONG_MIN else abs(trace_id)
        return t > self.threshold

    def __call__(self, trace_id: int) -> bool:
        allow = self.decide(trace_id)
        self.count(int(allow), int(not allow))
        return allow
