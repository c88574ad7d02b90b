"""Metric types + registry (the stats-receiver role, host side).

The port's copy of ``zipkin_tpu/obs/registry.py``. Everything here is
plain python/numpy and thread-safe: these objects are bumped from the
store's write path, the ingest pipeline's threads and the API's
handler threads concurrently. ``Registry.render_text`` is the
Prometheus text exposition the API serves at ``GET /metrics``. The
latency sketch reuses the repo's sketch math:

- bucketing is the DDSketch log-histogram of ``ops.quantile`` (same
  gamma formula, same geometric-midpoint quantile read via
  ``quantiles_host``);
- central moments are ``models.dependencies.Moments`` (the algebird
  monoid), so mean/stddev come from the same arithmetic the dependency
  links use.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from zipkin_tpu_torch.models.dependencies import Moments

DEFAULT_QUANTILES = (0.5, 0.99)
# 1024 buckets at alpha=0.01 span a ~8e8 relative range: 1 µs .. ~13 min
# when observing seconds with min_value=1e-6.
DEFAULT_ALPHA = 0.01
DEFAULT_BUCKETS = 1024


def _fmt(v) -> str:
    """Prometheus sample value: integers render bare, floats via repr
    (shortest round-trip), non-finite as NaN/+Inf/-Inf."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, quote, newline."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labels: Sequence[Tuple[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in labels
    )
    return "{" + inner + "}"


class Metric:
    """Base: name, help, prometheus type, optional label dimensions.

    With ``labelnames`` set, the metric is a family: ``labels(k=v)``
    returns (creating on first use) the child for those label values;
    the parent itself carries no samples.
    """

    prom_type = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()  # lock-order: 90 metric (leaf)
        self._children: Dict[Tuple[str, ...], "Metric"] = {}  # guarded-by: _lock

    def labels(self, **kv) -> "Metric":
        if tuple(sorted(kv)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(kv)}"
            )
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def _make_child(self) -> "Metric":
        raise NotImplementedError

    def _child_items(self) -> List[Tuple[Tuple[Tuple[str, str], ...],
                                         "Metric"]]:
        with self._lock:
            return [
                (tuple(zip(self.labelnames, key)), child)
                for key, child in sorted(self._children.items())
            ]

    def samples(self) -> Iterable[Tuple[str, tuple, float]]:
        """(name_suffix, ((label, value), ...), value) triples."""
        if self.labelnames:
            for labels, child in self._child_items():
                for suffix, sub, v in child.samples():
                    yield suffix, labels + sub, v
            return
        yield from self._own_samples()

    def _own_samples(self):
        return ()


class Counter(Metric):
    """Monotonic counter. ``fn``-backed counters read an external
    monotonic source at scrape time (adapting pre-registry accounting
    like the sampler's allowed/denied) instead of owning the count."""

    prom_type = "counter"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help, labelnames)
        self._value = 0
        self._fn = fn

    def _make_child(self) -> "Counter":
        return Counter(self.name, self.help)

    def inc(self, n: float = 1) -> None:
        if self._fn is not None:
            raise RuntimeError(f"{self.name} is function-backed")
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self):
        if self._fn is not None:
            return self._fn()
        with self._lock:
            return self._value

    def _own_samples(self):
        yield "", (), self.value


class Gauge(Metric):
    """Point-in-time value; ``fn``-backed gauges read live state
    (queue depth, sampler rate) at scrape time."""

    prom_type = "gauge"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help, labelnames)
        self._value = 0.0
        self._fn = fn

    def _make_child(self) -> "Gauge":
        return Gauge(self.name, self.help)

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v
            self._fn = None

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self):
        fn = self._fn
        if fn is not None:
            try:
                return fn()
            except Exception:  # graftlint: disable=swallowed-exception
                return float("nan")  # NaN IS the broken-callback signal
        with self._lock:
            return self._value

    def _own_samples(self):
        yield "", (), self.value


class CallbackFamily(Metric):
    """A labeled gauge family whose samples come from one callback
    returning ``{label_value: number}`` — the adapter for existing
    snapshot hooks like ``SpanStore.counters()``, which already
    aggregate on their own locks and would be awkward to re-plumb as
    individual gauges."""

    prom_type = "gauge"

    def __init__(self, name: str, help: str, label: str,
                 fn: Callable[[], Dict[str, float]]):
        super().__init__(name, help, (label,))
        self._fn = fn

    def samples(self):
        try:
            values = self._fn()
        except Exception:  # graftlint: disable=swallowed-exception
            return  # absent family = the broken-callback signal
        label = self.labelnames[0]
        for k in sorted(values):
            yield "", ((label, str(k)),), values[k]


class LatencySketch(Metric):
    """Mergeable latency/size distribution: log-histogram buckets
    (ops.quantile math) + streaming central moments (the Moments
    monoid). Rendered as a Prometheus summary: one ``{quantile=...}``
    line per requested quantile plus ``_sum``/``_count``.

    ``observe`` takes seconds for latency metrics by convention
    (min_value 1e-6 = microsecond resolution); size distributions pass
    ``min_value=1.0``.
    """

    prom_type = "summary"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 alpha: float = DEFAULT_ALPHA,
                 n_buckets: int = DEFAULT_BUCKETS,
                 min_value: float = 1e-6,
                 quantiles: Sequence[float] = DEFAULT_QUANTILES):
        super().__init__(name, help, labelnames)
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self.min_value = min_value
        self.quantiles = tuple(quantiles)
        self.counts = np.zeros(n_buckets, np.int64)
        self.moments = Moments.zero()
        self._sum = 0.0

    def _make_child(self) -> "LatencySketch":
        return LatencySketch(
            self.name, self.help, alpha=self.alpha,
            n_buckets=len(self.counts), min_value=self.min_value,
            quantiles=self.quantiles,
        )

    def observe(self, value: float) -> None:
        idx = math.ceil(
            math.log(max(value, self.min_value) / self.min_value)
            / self._log_gamma
        )
        idx = min(max(int(idx), 0), len(self.counts) - 1)
        with self._lock:
            self.counts[idx] += 1
            self.moments = self.moments + Moments.of(float(value))
            self._sum += float(value)

    def merge(self, other: "LatencySketch") -> None:
        """Fold another sketch in (same bucketing required) — the
        cross-process / cross-shard aggregation path."""
        if (other.gamma != self.gamma
                or other.min_value != self.min_value
                or len(other.counts) != len(self.counts)):
            raise ValueError("sketch layouts differ")
        with other._lock:
            counts = other.counts.copy()
            moments, s = other.moments, other._sum
        with self._lock:
            self.counts += counts
            self.moments = self.moments + moments
            self._sum += s

    @property
    def count(self) -> int:
        with self._lock:
            return int(self.moments.n)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile_values(self, qs: Optional[Sequence[float]] = None
                        ) -> List[float]:
        """Quantile estimates via the same host read the per-service
        duration histogram uses (ops.quantile.quantiles_host); NaN when
        empty."""
        from zipkin_tpu_torch.ops.quantile import quantiles_host

        with self._lock:
            counts = self.counts.copy()
        return quantiles_host(
            counts, self.gamma, self.min_value, list(qs or self.quantiles)
        )

    def snapshot(self) -> Dict[str, float]:
        """Summary dict for BENCH json / as_dict."""
        with self._lock:
            m = self.moments
            s = self._sum
        out = {"count": float(m.n), "sum": s,
               "mean": m.mean if m.n else float("nan"),
               "stddev": (math.sqrt(m.m2 / m.n)
                          if m.n else float("nan"))}
        for q, v in zip(self.quantiles, self.quantile_values()):
            out[f"p{int(q * 100)}"] = float(v)
        return out

    def _own_samples(self):
        for q, v in zip(self.quantiles, self.quantile_values()):
            yield "", (("quantile", _fmt(q)),), v
        yield "_sum", (), self.sum
        yield "_count", (), self.count


class Registry:
    """Name → metric map with replace-on-reregister semantics."""

    def __init__(self):
        # Held only for map mutation/snapshot — samples() and gauge
        # callbacks run OUTSIDE it (collect() snapshots), so this is a
        # leaf despite exposition fanning out into other locks.
        self._lock = threading.Lock()  # lock-order: 84 registry
        self._metrics: Dict[str, Metric] = {}  # guarded-by: _lock

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            self._metrics[metric.name] = metric
        return metric

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # -- views ----------------------------------------------------------

    def render_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for m in self.collect():
            lines.append(f"# HELP {m.name} {escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.prom_type}")
            for suffix, labels, value in m.samples():
                lines.append(
                    f"{m.name}{suffix}{_label_str(labels)} {_fmt(value)}"
                )
        return "\n".join(lines) + "\n"

    def as_dict(self) -> Dict[str, float]:
        """Flat snapshot: sample key → value (summary quantiles keyed
        like their exposition lines)."""
        out: Dict[str, float] = {}
        for m in self.collect():
            for suffix, labels, value in m.samples():
                try:
                    out[f"{m.name}{suffix}{_label_str(labels)}"] = float(
                        value
                    )
                except (TypeError, ValueError):
                    continue
        return out


_DEFAULT = Registry()


def default_registry() -> Registry:
    """The process-wide registry every stage registers into by default."""
    return _DEFAULT
