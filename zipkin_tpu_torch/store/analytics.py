"""Windowed-analytics read mixin over a SketchMirror.

The port's copy of ``zipkin_tpu/store/analytics.py``.

Every read here is HOST-ONLY: the mirror twins of the windowed
(service × time-bucket) Moments-sketch arena answer with zero device
round-trips. Window answers are
whole-bucket granular: [start_us, end_us) expands to the time buckets
it overlaps, and only buckets still live in the ring
(window_seconds × window_buckets of retention) contribute.

Mixed into ``TorchSpanStore`` (mirror fed by the fused ingest step's
commit deltas). Hosts must provide
``config`` (a StoreConfig), ``ensure_sketch_mirror()`` and
``_svc_id(name)``.
"""

from __future__ import annotations

import numpy as np


class WindowedAnalytics:
    """windowed_quantiles / slo_burn / latency_heatmap over the host's
    sketch mirror (see module docstring for the host contract)."""

    def _window_ctx(self, service: str):
        """(mirror, svc id) — or (None, None) when the arena can't
        represent the service (disabled arena, unknown name, or a
        dictionary-overflow id past max_services)."""
        c = self.config
        if not c.window_enabled:
            return None, None
        svc = self._svc_id(service)
        if svc is None or svc >= c.max_services:
            return None, None
        return self.ensure_sketch_mirror(), svc

    def _bucket_range(self, epoch, start_us, end_us):
        """[b0, b1] absolute-bucket span for a µs half-open window;
        None bounds default to the arena's live extent."""
        bucket_us = self.config.window_us
        live = epoch[epoch >= 0]
        if start_us is None:
            b0 = int(live.min()) if live.size else 0
        else:
            b0 = max(0, int(start_us) // bucket_us)
        if end_us is None:
            b1 = int(live.max()) if live.size else -1
        else:
            b1 = (max(0, int(end_us)) - 1) // bucket_us
        return b0, b1

    def windowed_quantiles(self, service: str, qs,
                           start_us=None, end_us=None):
        """Duration quantile estimates (µs) for ``service`` over the
        time window — a cell-sum + one Moments solve
        (windows.quantiles_from_sums; tolerance documented there).
        None when no duration-carrying span is in the window."""
        from zipkin_tpu_torch.aggregate import windows as win_mod

        m, svc = self._window_ctx(service)
        if m is None:
            return None
        epoch, counts, sums, mm = m.window_row(svc)
        b0, b1 = self._bucket_range(epoch, start_us, end_us)
        ws = win_mod.merge_cells(epoch, counts, sums, mm, b0, b1)
        return win_mod.quantiles_from_sums(
            ws, list(qs), m.gamma, self.config.win_x_shift)

    def slo_burn(self, service: str, objective: float = None,
                 windows_s=None, now_us=None):
        """Multi-window error-budget burn rates: per lookback window,
        error rate over the covered cells divided by the budget
        (1 - objective). ``now_us`` defaults to the end of the arena's
        newest live bucket (data time, so replays and tests are
        deterministic). None when the arena can't serve the service."""
        from zipkin_tpu_torch.aggregate import windows as win_mod

        objective = (win_mod.DEFAULT_OBJECTIVE if objective is None
                     else float(objective))
        windows_s = list(windows_s or win_mod.DEFAULT_BURN_WINDOWS_S)
        m, svc = self._window_ctx(service)
        if m is None:
            return None
        epoch, counts, sums, mm = m.window_row(svc)
        bucket_us = self.config.window_us
        live = epoch[epoch >= 0]
        if now_us is None:
            now_us = (int(live.max()) + 1) * bucket_us if live.size else 0
        budget = max(1.0 - objective, 1e-9)
        out = []
        for w_s in windows_s:
            b1 = (int(now_us) - 1) // bucket_us
            b0 = max(0, (int(now_us) - int(w_s) * 1_000_000)
                     // bucket_us)
            ws = win_mod.merge_cells(epoch, counts, sums, mm, b0, b1)
            rate = ws.error_rate
            out.append({
                "windowSeconds": int(w_s),
                "total": ws.total,
                "errors": ws.err,
                "errorRate": rate,
                "burnRate": rate / budget,
            })
        return {"serviceName": service, "objective": objective,
                "nowTs": int(now_us), "windows": out}

    def latency_heatmap(self, service: str, start_us=None, end_us=None,
                        bands: int = None):
        """Service × time × duration-bucket grid: one column per live
        time bucket in range, ``bands`` log-spaced duration bands,
        cell mass from each column's Moments solve. None when the
        arena can't serve the service."""
        from zipkin_tpu_torch.aggregate import windows as win_mod

        bands = int(bands or win_mod.DEFAULT_HEATMAP_BANDS)
        m, svc = self._window_ctx(service)
        if m is None:
            return None
        epoch, counts, sums, mm = m.window_row(svc)
        b0, b1 = self._bucket_range(epoch, start_us, end_us)
        slots = win_mod.live_slots(epoch, b0, b1)
        order = np.argsort(epoch[slots])
        slots = slots[order]
        cells = win_mod.cell_sums(slots, counts, sums, mm)
        bucket_us = self.config.window_us
        shift = self.config.win_x_shift
        with_dur = [c for c in cells if c.n > 0]
        if with_dur:
            lo = min(c.min_x for c in with_dur)
            hi = max(c.max_x for c in with_dur)
        else:
            lo = hi = 0
        edges = win_mod.band_edges_x(lo, hi, bands)
        grid = [
            [round(v, 3) for v in win_mod.band_masses(c, edges)]
            for c in cells
        ]
        return {
            "serviceName": service,
            "bucketSeconds": self.config.window_seconds,
            "bucketStartsTs": [int(epoch[w]) * bucket_us
                               for w in slots],
            "bandEdgesMicros": [
                round(win_mod.x_edge_duration(int(e), m.gamma, shift),
                      1)
                for e in edges
            ],
            "cells": grid,
            "totals": [c.total for c in cells],
            "errors": [c.err for c in cells],
        }
