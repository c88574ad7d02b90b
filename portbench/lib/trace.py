"""The card's trace over the measured window: ``torch.profiler`` with
CUDA activity only, read from the profiler's raw events (timestamps in
``time.time_ns()``'s clock, the clock of the harness's own spans)."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    busy = 0
    cur_s = cur_e = None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def merged(intervals) -> List[Tuple[int, int]]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Capture:
    """Profile a ``with`` block on the card. After it: ``device`` holds
    (start_ns, end_ns, name, correlation id) of every device activity
    (kernels, copies, sets) and ``t0``/``t1`` the block's bounds
    (synchronised)."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.device_ev: List[Tuple[int, int, str, int]] = []
        self.t0 = self.t1 = 0

    @staticmethod
    def warm(torch) -> None:
        """A first profiler start on a process costs seconds; pay it in
        set-up."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize(self.device)
        self.t1 = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType

        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                self.device_ev.append((s, s + e.duration_ns(), e.name(),
                                       e.correlation_id()))
        self._prof = None
        return False

    # -- reductions -------------------------------------------------------

    def in_window(self):
        return [e for e in self.device_ev if e[1] > self.t0 and e[0] < self.t1]

    def busy_ns(self) -> int:
        return union_ns((max(s, self.t0), min(e, self.t1))
                        for s, e, _, _ in self.in_window())

    def window_ns(self) -> int:
        return self.t1 - self.t0

    def by_name(self, part: str) -> int:
        """Summed device ns of activities whose name holds ``part``."""
        return sum(e - s for s, e, n, _ in self.in_window() if part in n)

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, int] = {}
        for s, e, n, _ in self.in_window():
            tot[n] = tot.get(n, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], t / 1e9] for n, t in top]

    def idle_by_host(self, spans: Dict[str, list], k: int = 10
                     ) -> List[list]:
        """Idle device seconds inside the window by what the harness was
        doing: for each kind of its own spans, the idle time while at least
        one such span was open (kinds open at once each count it), and
        ``none`` for idle time with no span open; longest first."""
        w0, w1 = self.t0, self.t1
        busy = merged((max(s, w0), min(e, w1)) for s, e, _, _ in self.in_window())
        idle, prev = [], w0
        for a, b in busy:
            if a > prev:
                idle.append((prev, a))
            prev = max(prev, b)
        if prev < w1:
            idle.append((prev, w1))
        out: Dict[str, int] = {}
        any_open = []
        for name, lst in spans.items():
            opened = merged((max(s, w0), min(e, w1)) for s, e, _ in lst
                            if e > w0 and s < w1)
            any_open += opened
            out[name] = _overlap(idle, opened)
        out["none"] = (sum(b - a for a, b in idle)
                       - _overlap(idle, merged(any_open)))
        top = sorted(out.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t / 1e9] for n, t in top]


def _overlap(a, b) -> int:
    """Total length where two sorted lists of disjoint intervals meet."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot
