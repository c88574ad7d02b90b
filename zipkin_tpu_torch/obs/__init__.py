"""Process-wide telemetry, torch side: counters, gauges and latency
sketches (``registry``), the port's copy of the JAX package's metric
types. Components take a ``registry`` argument defaulting to the
process-wide instance (``default_registry()``); registering a name
twice replaces the earlier metric. Fleet observability and the
Prometheus text output come with later slices."""

from zipkin_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    LatencySketch,
    Registry,
    default_registry,
)

__all__ = [
    "Counter",
    "Gauge",
    "LatencySketch",
    "Registry",
    "default_registry",
]
