"""Process-wide telemetry, torch side: counters, gauges, callback
families and latency sketches (``registry``), the port's copy of the
JAX package's metric types, with the Prometheus text exposition the
API serves at ``GET /metrics``. Components take a ``registry`` argument
defaulting to the process-wide instance (``default_registry()``);
registering a name twice replaces the earlier metric. ``fleet`` extends
the registry and the self-trace across processes: batch-lineage
tracing of the write path, pushed-snapshot federation
(``/metrics?fleet=1``), and the stall watchdog and flight recorder
behind ``/api/health`` and ``/debug/events``. ``profile`` is the
on-demand ``torch.profiler`` capture behind ``POST /debug/profile``."""

from zipkin_tpu_torch.obs.fleet import (
    FleetObs,
    FlightRecorder,
    FollowerLineage,
    LineageTracker,
    Watchdog,
    merge_sketches,
    registry_snapshot,
    render_federated,
)
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
    "FleetObs",
    "FlightRecorder",
    "FollowerLineage",
    "Gauge",
    "LatencySketch",
    "LineageTracker",
    "Registry",
    "Watchdog",
    "default_registry",
    "merge_sketches",
    "registry_snapshot",
    "render_federated",
]
