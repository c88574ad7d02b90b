"""Shared tiny configuration for the benchmark's CPU tests: the cells'
shapes cut to a size a test run holds, twins in place of the kernels."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_STORE = {
    "capacity": 1024, "ann_capacity": 2048, "bann_capacity": 1024,
    "max_services": 40, "max_span_names": 64, "max_annotation_values": 64,
    "max_binary_keys": 16, "cms_depth": 4, "cms_width": 256, "hll_p": 8,
    "quantile_buckets": 2048, "quantile_alpha": 0.01, "dep_buckets": 4,
    "use_pallas": False, "layout": "ring", "window_seconds": 0}
TINY_GEN = {"n_services": 40, "n_span_names": 64, "spans_per_trace": 7,
            "topology": True}
CELLS = ("ring.bulk", "window.bulk")


def tiny(cell: str):
    """(config, mix) of ``cell`` at test size."""
    cfg = {"store": dict(TINY_STORE), "generator": dict(TINY_GEN)}
    if cell.startswith("window"):
        cfg["store"].update(window_seconds=60, window_buckets=8)
    mix = {"driver": "restamp_stream", "templates": [{"traces": 30}],
           "setup": [0, 0], "window_template": 0}
    return cfg, mix
