"""Process-wide telemetry, torch side: counters, gauges, callback
families and latency sketches (``registry``), the port's copy of the
JAX package's metric types, with the Prometheus text exposition the
API serves at ``GET /metrics``. Components take a ``registry`` argument
defaulting to the process-wide instance (``default_registry()``);
registering a name twice replaces the earlier metric. ``fleet`` holds
the request context the API publishes around traced handlers; the rest
of fleet observability (lineage, federation, the watchdog) comes with a
later slice. ``profile`` is the on-demand ``torch.profiler`` capture
behind ``POST /debug/profile``."""

from zipkin_tpu_torch.obs.registry import (
    CallbackFamily,
    Counter,
    Gauge,
    LatencySketch,
    Registry,
    default_registry,
)

__all__ = [
    "CallbackFamily",
    "Counter",
    "Gauge",
    "LatencySketch",
    "Registry",
    "default_registry",
]
