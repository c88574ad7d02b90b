"""On-demand ``torch.profiler`` capture (the ostrich /pprof role).

The port's copy of ``zipkin_tpu/obs/profile.py``, on ``torch.profiler``
in place of ``jax.profiler``. One capture at a time, process-wide: the
torch profiler is a global singleton, so a second concurrent start
would fail or cut the first trace. The API exposes this as ``POST
/debug/profile?seconds=N`` — the caller blocks for the window
(ThreadingHTTPServer gives it its own thread) and gets back the trace
directory, which holds one Chrome trace file (``TRACE_FILE``), viewable
with Perfetto or ``chrome://tracing``. The capture records host (CPU)
activity, and the card's kernels and copies when CUDA is available.
CUDA activity is traced device-wide, so the kernels that other threads
launch during the window are in the trace. Host ops of other threads
are recorded where the installed torch offers ``profile_all_threads``,
for threads that start inside the window (the HTTP server starts one a
request); otherwise only the capturing thread's own.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Optional

MAX_SECONDS = 120.0
TRACE_FILE = "trace.json"

_capture_lock = threading.Lock()  # lock-order: 86 profiler


class ProfilerBusy(RuntimeError):
    """A capture is already running."""


def _all_threads_config():
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # a torch without the option: this thread only
        return None


def capture(seconds: float, out_dir: Optional[str] = None
            ) -> "tuple[str, float]":
    """Trace host + device activity for ``seconds`` (clamped to
    [0.01, MAX_SECONDS] — the one clamp site); returns (trace
    directory, effective seconds). Raises ProfilerBusy when a capture
    is in flight, and propagates whatever ``torch.profiler`` raises
    when it cannot trace (callers map that to a 503)."""
    seconds = min(max(float(seconds), 0.01), MAX_SECONDS)
    if not _capture_lock.acquire(blocking=False):
        raise ProfilerBusy("a profiler capture is already running")
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        out_dir = out_dir or tempfile.mkdtemp(prefix="zipkin-tpu-profile-")
        os.makedirs(out_dir, exist_ok=True)
        with profile(activities=activities,
                     experimental_config=_all_threads_config()) as prof:
            time.sleep(seconds)
        prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))
        return out_dir, seconds
    finally:
        _capture_lock.release()
