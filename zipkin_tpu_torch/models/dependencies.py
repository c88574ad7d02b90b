"""Dependency-link algebra: Moments, DependencyLink, Dependencies.

Parity targets (reference):
- ``DependencyLink(parent, child, durationMoments)`` + Semigroup —
  zipkin-common/.../common/Dependencies.scala:34,38
- ``Dependencies`` Monoid (zero = Time.Top/Bottom, link-map merge) —
  Dependencies.scala:59,67
- algebird ``Moments`` — like algebird, we keep the *central* form
  (n, mean, M2, M3, M4 — Mk = Σ(x-mean)^k) and merge with the
  Chan/Pébay pairwise-combine formulas. Central sums avoid the
  catastrophic cancellation that raw power sums (Σx, Σx², ...) suffer for
  realistic microsecond durations (mean ~1e7, σ ~1e3). The same combine
  runs vectorized on device (zipkin_tpu_torch.ops.sketches.moments_combine).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Sequence, Tuple

_TIME_TOP = float("inf")
_TIME_BOTTOM = float("-inf")


@dataclass(frozen=True)
class Moments:
    """Streaming central moments of a scalar distribution.

    Fields mirror algebird Moments / the thrift wire form m0..m4
    (zipkinDependencies.thrift): ``n`` count, ``mean``, and central sums
    ``m2 = Σ(x-mean)²``, ``m3``, ``m4``.
    """

    n: float = 0.0
    mean: float = 0.0
    m2: float = 0.0
    m3: float = 0.0
    m4: float = 0.0

    @staticmethod
    def of(x: float) -> "Moments":
        return Moments(1.0, x, 0.0, 0.0, 0.0)

    @staticmethod
    def of_many(xs: Iterable[float]) -> "Moments":
        m = Moments.zero()
        for x in xs:
            m = m + Moments.of(x)
        return m

    @staticmethod
    def zero() -> "Moments":
        return Moments()

    def __add__(self, other: "Moments") -> "Moments":
        """Pairwise combine (Chan et al. / Pébay 2008), numerically stable."""
        na, nb = self.n, other.n
        if na == 0:
            return other
        if nb == 0:
            return self
        n = na + nb
        delta = other.mean - self.mean
        d_n = delta / n
        mean = self.mean + nb * d_n
        m2 = self.m2 + other.m2 + delta * d_n * na * nb
        m3 = (
            self.m3
            + other.m3
            + delta * d_n * d_n * na * nb * (na - nb)
            + 3.0 * d_n * (na * other.m2 - nb * self.m2)
        )
        m4 = (
            self.m4
            + other.m4
            + delta * d_n ** 3 * na * nb * (na * na - na * nb + nb * nb)
            + 6.0 * d_n * d_n * (na * na * other.m2 + nb * nb * self.m2)
            + 4.0 * d_n * (na * other.m3 - nb * self.m3)
        )
        return Moments(n, mean, m2, m3, m4)

    # -- derived views --------------------------------------------------

    @property
    def count(self) -> int:
        return int(self.n)

    @property
    def variance(self) -> float:
        return self.m2 / self.n if self.n > 0 else 0.0

    @property
    def stddev(self) -> float:
        return math.sqrt(max(self.variance, 0.0))

    @property
    def skewness(self) -> float:
        if self.n <= 0 or self.m2 <= 0:
            return 0.0
        return math.sqrt(self.n) * self.m3 / self.m2 ** 1.5

    @property
    def kurtosis(self) -> float:
        """Excess kurtosis."""
        if self.n <= 0 or self.m2 <= 0:
            return 0.0
        return self.n * self.m4 / (self.m2 * self.m2) - 3.0

    def to_central(self) -> Tuple[float, float, float, float, float]:
        """(m0..m4) as on the thrift wire (zipkinDependencies.thrift)."""
        return (self.n, self.mean, self.m2, self.m3, self.m4)

    @staticmethod
    def from_central(m0: float, m1: float, m2: float, m3: float, m4: float) -> "Moments":
        return Moments(m0, m1, m2, m3, m4)


@dataclass(frozen=True)
class DependencyLink:
    """One service calling another (Dependencies.scala:34)."""

    parent: str
    child: str
    duration_moments: Moments = field(default_factory=Moments.zero)

    def __add__(self, other: "DependencyLink") -> "DependencyLink":
        if (self.parent, self.child) != (other.parent, other.child):
            raise ValueError("DependencyLink parent/child must match to merge")
        return DependencyLink(
            self.parent, self.child, self.duration_moments + other.duration_moments
        )


def merge_dependency_links(links: Sequence[DependencyLink]) -> list:
    """Group by (parent, child) and sum (Dependencies.scala:45-51)."""
    acc: Dict[Tuple[str, str], DependencyLink] = {}
    for link in links:
        key = (link.parent, link.child)
        acc[key] = acc[key] + link if key in acc else link
    return list(acc.values())


@dataclass(frozen=True)
class Dependencies:
    """All dependency links over a time period (Dependencies.scala:59).

    Monoid: zero has an empty-inverted time range; plus takes the inclusive
    span of both ranges and merges links by (parent, child).
    """

    start_time: float = _TIME_TOP  # microseconds; inf == Time.Top (zero elt)
    end_time: float = _TIME_BOTTOM
    links: Tuple[DependencyLink, ...] = ()

    def __post_init__(self):
        if not isinstance(self.links, tuple):
            object.__setattr__(self, "links", tuple(self.links))

    @staticmethod
    def zero() -> "Dependencies":
        return Dependencies()

    def __add__(self, other: "Dependencies") -> "Dependencies":
        return Dependencies(
            min(self.start_time, other.start_time),
            max(self.end_time, other.end_time),
            tuple(merge_dependency_links(tuple(self.links) + tuple(other.links))),
        )
