"""One run of one cell: the driver's set-up, the measured window, the
per-layer readers, the check, and the result line's fields.

A cell's mix (``traffic/<mix>.json``) names its driver, a module
``drivers/<driver>.py`` found by name, whose ``build(config, mix, seed,
device)`` returns the system under test as that kind of traffic drives
it. The system has:

- ``spans``: a ``Spans``, the harness's own spans around calls into the
  program (recorded while the window is traced);
- ``warm()``: set-up, which runs every shape and path the window takes;
- ``window(seconds)``: the measured window, returning a ``Window`` of
  the end-to-end values it measured by the host clock;
- ``check(limits, seed, device)``: after the window, each number that
  decides ``correct`` (the program's outputs against the plain
  reference, run once the program's state is freed).

Per-layer readers (``metrics/<name>.py``) get a ``Context``: the system,
the device trace and the card's name. A later kind of traffic or system
is a new driver and a mix that names it; no file here changes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from .manifest import Manifest
from .trace import Capture


@dataclass
class Spans:
    """The harness's own spans around calls into the program, in
    ``time.time_ns()`` (the profiler's clock): name -> [(start, end,
    thread id)]. Recording only appends to a list."""

    on: bool = True
    spans: Dict[str, list] = field(default_factory=dict)

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.on:
            self.spans.setdefault(name, []).append(
                (t0, t1, threading.get_native_id()))


@dataclass
class Window:
    """What a driver's window measured: end-to-end values by name, the
    operations attempted and those that failed."""

    values: Dict[str, float]
    attempted: int
    failed: int


@dataclass
class Outcome:
    """What a run measured and checked."""

    metrics: Dict[str, Dict] = field(default_factory=dict)
    checks: Dict[str, Dict] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    device: Dict = field(default_factory=dict)
    breakdown: Optional[Dict] = None

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())


@dataclass
class Context:
    """What a per-layer metric's reader gets."""

    system: object
    capture: Optional[Capture]
    card: str


def run_cell(root, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             config_override: Optional[Dict] = None,
             mix_override: Optional[Dict] = None) -> Outcome:
    """Run cell ``name`` once. ``config_override``/``mix_override``
    replace the configuration and the mix (the CPU tests run tiny ones)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    man = Manifest(root)
    cell = man.cell(name)
    config = config_override or man.config(cell)
    mix = mix_override or man.traffic(cell)
    limits = man.limits(cell)
    on_card = torch.device(device).type == "cuda"
    out = Outcome()

    # -- set-up ------------------------------------------------------------
    system = man.driver(mix).build(config, mix, seed, device)
    system.warm()
    if trace and on_card:
        Capture.warm(torch)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # -- the window -----------------------------------------------------------
    capture = Capture(torch, torch.device(device)) if trace and on_card \
        else None
    system.spans.on = trace
    if capture is not None:
        capture.__enter__()
    win = system.window(seconds)
    if capture is not None:
        capture.__exit__(None, None, None)
    system.spans.on = False
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # -- metrics --------------------------------------------------------------
    values = {"setup_s": setup_s, **win.values}
    out.attempted, out.failed = win.attempted, win.failed
    card = torch.cuda.get_device_name(0) if on_card else "cpu"
    out.device = {"platform": "gpu" if on_card else "cpu", "kind": card,
                  "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        ctx = Context(system, capture, card)
        for m in man.per_layer(cell):
            v = man.reader(m["name"])(ctx)
            if v is not None:
                out.metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if capture is not None:
            out.device["busy_s"] = capture.busy_ns() / 1e9
            out.device["window_s"] = capture.window_ns() / 1e9
            out.breakdown = {"device_ops": capture.top_ops(),
                             "idle_gaps": capture.idle_by_host(
                                 system.spans.spans)}
    else:
        for m in man.end_to_end(cell):
            if m["name"] not in values:
                raise RuntimeError(f"{m['name']} was not measured")
            out.metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    # -- checks ---------------------------------------------------------------
    numbers = system.check(limits, seed, device)
    out.checks = {k: {"value": v, "limit": limits[k]}
                  for k, v in numbers.items()}
    return out
