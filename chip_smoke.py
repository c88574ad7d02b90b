"""Chip smoke test of the PyTorch/CUDA port (``zipkin_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the three CUDA kernels from ``zipkin_tpu_torch/csrc`` (one
nvcc per source, started together), then

1. drives the ring store's main path at full width: a ``TorchSpanStore``
   at the 1k-service / 2^22-span-ring configuration with the kernels on
   streams >= 1.25 x 2^22 generated spans through ``write_batch`` (the
   span ring wraps, index buckets displace entries), profiles three
   more launches (``--profile``: device time by kernel, idle share),
   applies ~2000 known traces and queries them with known answers; the
   launch counters of the flat histogram and of both arena halves
   (claim, write), zeroed just before the drive, must have advanced,
   the flat histogram's by exactly one an ingest step (the step's seven
   scatter-add sites are one fused launch);
2. drives the paged layout the same way (128-row pages, 32,768 pages):
   >= 39 launches so the page pool runs out and pages are reclaimed,
   then the known traces plus 32 big traces (exclusive, multi-page
   chains) and one trace past ``page_max_chain`` (its read takes the
   ring-scan fallback); all four kernel wrappers must have launched, the
   flat histogram once a step;
3. holds each kernel against its plain PyTorch twin, bitwise, on inputs
   the paths gave it (recorded during the drives): the fused flat
   histogram on the first step's seven sites, and each site alone; the
   arena claim,
   write and the two together also on an in-batch bucket overflow, a
   power-of-two bucket count, no valid row and one bucket spanning
   several of the claim's blocks; the page gather also on hole pages.
   It times call, kernel alone, twin and a one-call PyTorch yardstick;
4. drives the daemon's default store (the same configuration with the
   windowed arena on, 60 s x 64 buckets): 46 launches two buckets apart
   (the slot ring laps), then one late launch whose rows lose the epoch
   war; the flat histogram must launch once a step with eight sites
   (``win_counts`` the eighth), the host sketch mirror must equal the
   device leaves bitwise, and ten services' live-cell span and error
   counts must equal a count kept on the host from the generated
   batches; it times the three windowed reads and the mirror's host
   share of a launch, and holds the eight-site call (and the eighth
   site alone) against the twin;
5. drives the daemon's ``--pipeline-depth 4`` write path at full width
   with the window on: the same ``apply`` calls into a serial store and
   a pipelined one must give equal states and mirrors; it records both
   rates and the stage sketches;
6. runs each layout's stream at capacity 2^14 (same widths, window on)
   on the card and on the CPU (plain twins) and requires equal states
   and mirrors (and, paged, equal planner snapshots), then the same
   spans pipelined on the card against serial on the CPU;
7. durability on the daemon's default store (the window on) at full
   width: a write-ahead log with the daemon's defaults (group commit
   every 0.05 s, 64 MB segments), 5 launches, ``checkpoint.save``, 5
   more launches; then ``wal.recover`` restores a second store on the
   card and replays the 5-record tail. Integer leaves and counters must
   equal the uncrashed store's bitwise and the three moment leaves
   within the stated tolerance, the recovered mirror its own device
   leaves, and trace reads, name queries, dependency link counts and
   the windowed reads the uncrashed store's answers; the flat histogram
   launches once a replayed step and the arena halves launch too. It
   prints the save, load and replay seconds by phase, the snapshot and
   WAL bytes, the log's append latency and the peak device memory; one
   more launch must journal as record 11;
8. the paged layout at capacity 2^14: a pipelined store is saved while
   a writer plans units past the gathered frontier; recovery on the
   card must take those units' page claims from the snapshot's plan
   memo, land the uncrashed planner snapshot and state, and serve
   trace reads (the page gather) equal to the uncrashed store's;
9. the crash harness's child on the card (``python -m
   zipkin_tpu_torch.testing.crash --device cuda``; the children run at
   the same time, the recoveries one after another), SIGKILLed once at
   each of before-append, after-append, after-commit, mid-checkpoint and
   mid-truncate, and twice at mid-seal on a tiered drive; each recovery
   keeps every acked batch, equals an uncrashed drive of the recovered
   prefix and leaves the first unapplied batch absent (tiered: the same
   cold segments, the sealed frontier at the capture clock);
10. the daemon's ``--cold-tier --capture-backlog 4`` store at full
   width (the window store wrapped in a ``TieredSpanStore``, its
   ``capture_backlog`` 4): launches past one lap of the span ring, so
   the first capture window (~capacity spans) is pulled and sealed on
   the sealer thread, with known traces of services of their own early
   (evicted) and late (resident); sampled evicted and resident traces,
   exist/duration, the name and annotation lookups, the dependency
   links and the duration quantiles must equal an in-memory oracle fed
   the same spans, K1 and both K2 halves must launch once a step, and
   after ``capture_now`` the segments must tile [0, write_pos) with the
   sealed frontier at the capture clock. It prints the pull (gather
   device ms, count sync) and the seal (copy, batch rebuild, decode,
   ``seal_segment``) a window, stalls, cold fetch ms, the segments and
   their compression;
11. a pipelined paged tiered store at capacity 2^14 past its page pool:
   reclaimed pages sealed before reuse, trace reads through the page
   gather equal to the oracle's;
12. a tiered store on the card (sealer) against its CPU twin (inline)
   at 2^14 with the window on: equal segment lists and bytes, then a
   tiered ``checkpoint.save``/``load`` round trip on the card.

``--hist-variants`` also builds copies of the flat-histogram kernel with
one design constant changed each and reads their device time on the
first step's sites (the evidence for its constants).

It fails on any phase failure and catches none. The line before the
last is the kernels JSON; the last line is the device JSON. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result. ``--rehearse`` runs the same flow on the CPU at a
tiny size (kernel checks compare twin with twin) and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def full_config(dev, capacity_log2: int, n_services: int, **layout):
    """The reference bench's _tpu_config(capacity_log2, n_services,
    use_pallas=True): 1k services, 2048 span names, 4096 annotation
    values, 1024 binary keys, CMS 4x2^16, HLL p=14, 2048 quantile
    buckets; name index 2^16x256, key table 2^23 and 64 dependency
    banks at capacity >= 2^20. ``layout`` adds the paged layout's
    fields (the daemon's ``--layout paged --page-rows R``)."""
    big = capacity_log2 >= 20
    return dev.StoreConfig(
        capacity=1 << capacity_log2,
        ann_capacity=1 << (capacity_log2 + 1),
        bann_capacity=1 << capacity_log2,
        max_services=n_services, max_span_names=2048,
        max_annotation_values=4096, max_binary_keys=1024,
        cms_width=1 << 16, hll_p=14, quantile_buckets=2048,
        use_pallas=True,
        idx_name_buckets=(1 << 16) if big else 0,
        idx_name_depth=256 if big else 0,
        idx_key_slots=(1 << 23) if big else 0,
        dep_buckets=64 if big else 16,
        **layout,
    )


def paged_layout(scale) -> dict:
    return dict(layout="paged", page_rows=128,
                page_max_chain=scale.page_max_chain)


class Scale:
    def __init__(self, rehearse: bool, profile_steps: int = 0):
        self.profile_steps = profile_steps
        if rehearse:
            self.cap_log2, self.services, self.names = 10, 40, 64
            self.batch_traces, self.stream_spans = 64, 4 * (1 << 10)
            self.known, self.small_log2, self.small_batches = 60, 10, 24
            self.small_traces = 16
            self.window_launches, self.pipe_applies = 34, 4
            self.pipe_traces = 64
            self.durability_launches = 3
            self.dur_paged_log2, self.dur_paged_applies = 12, 8
            self.dur_paged_traces = 128
            # Paged: 32 pages (a smaller pool cannot hold the known set),
            # a chain bound of 3 pages so a 400-span trace overflows it.
            self.paged_cap_log2, self.paged_launches = 12, 20
            self.page_max_chain, self.n_big = 3, 6
            self.big_min, self.big_max, self.overflow_spans = 64, 200, 400
            self.cold_known, self.cold_sample = 10, 8
        else:
            self.cap_log2, self.services, self.names = 22, 1000, 2048
            self.batch_traces = 16384  # 114,688 spans a launch
            self.stream_spans = (5 * (1 << 22)) // 4
            self.known, self.small_log2, self.small_batches = 2000, 14, 24
            self.small_traces = 512
            # 46 launches two buckets apart: 92 buckets > 64 slots.
            self.window_launches = 46
            # 8 apply calls of 28,672 spans (the first untimed), and 5
            # launches before the checkpoint and 5 after (the tail): cut
            # from 12 and 8 + 8 to keep the script near half its time
            # limit since the cold-tier phases.
            self.pipe_applies, self.pipe_traces = 8, 4096
            self.durability_launches = 5
            # 12 apply calls of 3,584 spans into 2^14 slots: the page
            # pool of 128 pages runs out and reclaims.
            self.dur_paged_log2, self.dur_paged_applies = 14, 12
            self.dur_paged_traces = 512
            # 39 launches = 4,472,832 spans > 2^22: the pool runs out.
            self.paged_cap_log2, self.paged_launches = 22, 39
            self.page_max_chain, self.n_big = 64, 32
            self.big_min, self.big_max = 200, 4000
            self.overflow_spans = 20000  # > 64 pages x 128 rows
            # Cold tier: 100 known traces early and late, 20 sampled
            # stream traces of an evicted and of a resident launch.
            self.cold_known, self.cold_sample = 100, 20
        # Launches past one lap of the span ring: the first capture
        # window (~capacity spans) is pulled and sealed, then three more.
        self.cold_launches = -(-(1 << self.cap_log2)
                               // (self.batch_traces * 7)) + 3


# ---------------------------------------------------------------------------
# Timing and recording
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps: int = 10, warm: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events), or on the
    host clock for CPU tensors."""
    for _ in range(warm):
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(torch, fn, kernel, reps: int = 10):
    """Mean device milliseconds of the device activities whose name
    holds ``kernel`` (a string, or a tuple of strings: any of them) in
    one ``fn`` call (torch.profiler's CUDA activity): no host launch
    gaps, and a 256 MB fill between calls so each starts with the 50 MB
    L2 cold, as a read on the store finds it. The fill writes ones, so
    it is a kernel and never a memset. "not measured" off the card."""
    if not torch.cuda.is_available():
        return "not measured"
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and any(n in e.name for n in names))
    return busy / reps / 1e3


class Recorder:
    """Wraps the kernels module's wrappers to keep a copy of their inputs
    on a path (the first step's fused flat-histogram call with its seven
    sites, arena claim and arena write; the page gather call with the
    most pages, by reference to the state's columns); the kernel then
    runs as usual and counts its launch."""

    NAMES = ("histogram_update_many", "arena_claim", "arena_write",
             "paged_page_gather")

    def __init__(self, K, record=("hist", "arena")):
        self.K = K
        self.hist, self.claim, self.write, self.gather = [], None, None, None
        self._orig = {n: getattr(K, n) for n in self.NAMES}
        orig = self._orig

        def hist(sites):
            sites = tuple(sites)
            if "hist" in record and not self.hist:
                self.hist = [(c.clone(), i.clone(),
                              None if w is None else w.clone())
                             for c, i, w in sites]
            return orig["histogram_update_many"](sites)

        def claim(bucket, valid, n_buckets):
            if "arena" in record and self.claim is None:
                self.claim = (bucket.clone(), valid.clone(), n_buckets)
            return orig["arena_claim"](bucket, valid, n_buckets)

        def write(entries, *args):
            if "arena" in record and self.write is None:
                self.write = (entries.clone(),
                              tuple(a.clone() for a in args))
            return orig["arena_write"](entries, *args)

        def gather(cols, pages, page_rows):
            if "gather" in record and (
                    self.gather is None
                    or pages.numel() > self.gather[1].numel()):
                self.gather = (list(cols), pages.clone(), page_rows)
            return orig["paged_page_gather"](cols, pages, page_rows)

        for n, fn in zip(self.NAMES, (hist, claim, write, gather)):
            setattr(K, n, fn)

    def restore(self):
        for n, fn in self._orig.items():
            setattr(self.K, n, fn)


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def rename_services(spans, names, span_names):
    """Known traces on the stream's service and span names (svc-NNNN,
    op-NNNN), so their dictionary ids fall below max_services and
    max_span_names and the catalogs can hold them."""
    mapping = {}
    op = {}

    def ep(e):
        if e is None:
            return None
        if e.service_name not in mapping:
            mapping[e.service_name] = names[len(mapping) % len(names)]
        return dataclasses.replace(e, service_name=mapping[e.service_name])

    out = []
    for s in spans:
        anns = tuple(dataclasses.replace(a, host=ep(a.host))
                     for a in s.annotations)
        banns = tuple(dataclasses.replace(b, host=ep(b.host))
                      for b in s.binary_annotations)
        name = op.setdefault(s.name, span_names[len(op) % len(span_names)])
        out.append(dataclasses.replace(s, name=name, annotations=anns,
                                       binary_annotations=banns))
    return out


def profile_steps(torch, store, gen, scale, batch_of=None, label="ring"):
    """torch.profiler over a few more launches of the stream: device
    time by kernel name and the card's idle share over the window
    (1 - union of kernel intervals / wall time). ``batch_of(i)`` makes
    the ``i``-th profiled batch (default: the generator's next)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [gen.next_batch(scale.batch_traces) if batch_of is None
               else batch_of(i) for i in range(scale.profile_steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch, _, ix in batches:
            store.write_batch(batch, ix)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy = 0.0
    cur_s = cur_e = None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    out = {"launches": len(batches), "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3,
           "idle_share": max(0.0, 1.0 - busy / wall_us),
           "top_kernels_ms": [(n[:80], t / 1e3) for n, t in top]}
    log(f"profile ({label}): " + json.dumps(out))
    return out


def stream(torch, store, gen, scale, n_launches: int, device,
           batch_of=None):
    """``n_launches`` generated batches through ``write_batch``, each
    synchronised: (spans written, per-launch seconds, wall seconds,
    peaks). ``peaks`` splits peak device memory into the first launch
    (CUDA warm-up, the recorder's copies) and the launches after it.
    ``batch_of(i)`` makes launch ``i``'s batch (default: the generator's
    next batch)."""
    t0 = time.perf_counter()
    written = 0
    step_s = []
    peaks = {}
    for i in range(n_launches):
        if batch_of is None:
            batch, _, indexable = gen.next_batch(scale.batch_traces)
        else:
            batch, _, indexable = batch_of(i)
        ts = time.perf_counter()
        store.write_batch(batch, indexable)
        sync(torch, device)
        step_s.append(time.perf_counter() - ts)
        written += batch.n_spans
        if i == 0 and device.type == "cuda":
            peaks["first_launch_peak_bytes"] = (
                torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
    if device.type == "cuda":
        peaks["stream_peak_bytes_after_first"] = (
            torch.cuda.max_memory_allocated())
    return written, step_s, time.perf_counter() - t0, peaks


def known_traces(scale):
    """The ~2000 generate_traces traces on the stream's names."""
    from zipkin_tpu_torch.tracegen import generate_traces

    rng = np.random.default_rng(2)
    traces = generate_traces(n_traces=scale.known, max_depth=3,
                             n_services=10, rng=rng,
                             base_ts=4_000_000_000_000)
    names = [f"svc-{i:04d}" for i in range(min(10, scale.services))]
    ops = [f"op-{i:04d}" for i in range(min(50, scale.names))]
    return [rename_services(t, names, ops) for t in traces], names


def big_traces(scale, names):
    """``scale.n_big`` traces of zipf sizes in [big_min, big_max] (each
    >= page_rows / 2 spans, so they take exclusive, multi-page chains)
    and one trace of ``overflow_spans`` spans, past page_max_chain
    pages: the shape of tests/test_paged.py's traces, on the stream's
    service and span names."""
    from zipkin_tpu_torch.models.span import (Annotation, BinaryAnnotation,
                                              Endpoint, Span)

    rng = np.random.default_rng(4)
    sizes = np.clip(scale.big_min * rng.zipf(1.6, scale.n_big),
                    scale.big_min, scale.big_max)
    sizes = list(sizes) + [scale.overflow_spans]
    out = []
    for i, n in enumerate(sizes):
        tid = 7_000_000_000 + i
        ep = Endpoint(10, 80, names[i % len(names)])
        t0 = 4_100_000_000_000 + i * 1_000_000
        out.append([Span(tid, f"op-{j % 4:04d}", tid * 100_000 + j + 1, None,
                         (Annotation(t0 + j, "sr", ep),
                          Annotation(t0 + j + 7, "ss", ep)),
                         (BinaryAnnotation("k", b"v", host=ep),))
                    for j in range(int(n))])
    return out[:-1], out[-1]


class GcPauses:
    """Host milliseconds spent in Python's cyclic garbage collector while
    installed in ``gc.callbacks``."""

    def __init__(self):
        self.ms = 0.0
        self._t = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t) * 1e3


def known_answer_reads(store, traces, big, overflow, names, gen):
    """Round-trip every known trace (batches of 250; the overflowed
    trace alone), by-service and by-annotation lookups, the catalogs,
    dependencies and the HLL estimate. Returns (ms, query, ms of it in
    the garbage collector) a query."""
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    try:
        return _known_answer_reads(store, traces, big, overflow, names,
                                   gen, pauses)
    finally:
        gc.callbacks.remove(pauses)


def _known_answer_reads(store, traces, big, overflow, names, gen, pauses):
    lat = []

    def q(fn, *a):
        g = pauses.ms
        t = time.perf_counter()
        out = fn(*a)
        n = len(a[0]) if a and isinstance(a[0], list) else None
        lat.append(((time.perf_counter() - t) * 1e3,
                    fn.__name__ + (f"[{n} ids]" if n else ""),
                    pauses.ms - g))
        return out

    small = [s for t in traces for s in t]
    known = small + [s for t in big + ([overflow] if overflow else [])
                     for s in t]
    by_tid = {}
    for s in known:
        by_tid.setdefault(s.trace_id, []).append(s)
    tids = list(by_tid)
    batches = [tids[i:i + 250] for i in range(0, len(tids), 250)]
    if overflow:
        last = overflow[0].trace_id
        batches = [[t for t in b if t != last] for b in batches] + [[last]]
    for chunk in batches:
        got = q(store.get_spans_by_trace_ids, chunk)
        if len(got) != len(chunk):
            fail(f"{len(chunk) - len(got)} known traces missing")
        for tid, spans in zip(chunk, got):
            if sorted(map(repr, spans)) != sorted(map(repr, by_tid[tid])):
                fail(f"trace {tid} did not round-trip")
    known_set = set(tids)

    def hosted_by(spans):
        out = {}
        for s in spans:
            for a in s.annotations:
                if a.host is not None:
                    out.setdefault(a.host.service_name, set()).add(
                        s.trace_id)
        return out

    hosted, hosted_small = hosted_by(known), hosted_by(small)
    end = 2**62
    limit = 20
    for svc in names:
        expected = hosted.get(svc, set())
        ids = {t.trace_id for t in q(store.get_trace_ids_by_name, svc,
                                     None, end, limit)}
        got = ids & known_set
        # Known traces are the newest: they fill the answer first.
        if not got <= expected or len(got) != min(limit, len(expected)):
            fail(f"by-service lookup for {svc}: {len(got)} known of "
                 f"{len(expected)} expected")
        expected = hosted_small.get(svc, set())
        for ann, val in (("some custom annotation", None),
                         ("http.uri", b"/api/widgets")):
            ids = {t.trace_id for t in q(store.get_trace_ids_by_annotation,
                                         svc, ann, val, end, limit)}
            got = ids & known_set
            if not got <= expected or bool(expected) != bool(got):
                fail(f"by-annotation lookup {svc}/{ann}: {len(got)} known "
                     f"of {len(expected)}")
    services = q(store.get_all_service_names)
    span_names = {}
    for s in known:
        for h in {a.host.service_name for a in s.annotations if a.host}:
            span_names.setdefault(h, set()).add(s.name)
    if not set(span_names) <= services:
        fail("service catalog misses known services")
    for svc, want in span_names.items():
        if not want <= q(store.get_span_names, svc):
            fail(f"span-name catalog of {svc} misses known names")
    pairs = set()
    for spans in by_tid.values():
        by_id = {s.id: s for s in spans}
        for s in spans:
            p = by_id.get(s.parent_id)
            if p is not None and p.service_name and s.service_name:
                pairs.add((p.service_name, s.service_name))
    deps = q(store.get_dependencies)
    links = {(l.parent, l.child) for l in deps.links}
    if not pairs or not pairs <= links:
        fail(f"dependencies miss {len(pairs - links)} known links")
    distinct = gen._next_trace - 1 + len(tids)
    est = q(store.estimated_unique_traces)
    if abs(est - distinct) > 0.05 * distinct:
        fail(f"HLL estimate {est:.0f} vs {distinct} distinct traces")
    return lat


def read_split(store, ids, reps: int = 3):
    """Host-clock ms of a whole-trace read and of its gather alone (the
    device work and the copy of its matrices to the host); the rest of
    the read is the host's decode into spans."""
    out = {"read_ms": [], "gather_ms": []}
    for _ in range(reps):
        t = time.perf_counter()
        store.get_spans_by_trace_ids(ids)
        out["read_ms"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        store._gather_trace_mats(ids)
        out["gather_ms"].append((time.perf_counter() - t) * 1e3)
    return out


def check_launches(launches, names, device, path, steps):
    """Every kernel of ``names`` launched on the path, and the flat
    histogram exactly once an ingest step (its seven sites fused)."""
    if device.type != "cuda":
        return
    for name in names:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {path} path")
    if launches["flat_histogram"] != steps:
        fail(f"flat_histogram launched {launches['flat_histogram']} times "
             f"in {steps} ingest steps on the {path} path, not once a step")


def path_result(torch, store, scale, written, step_s, stream_s, lat,
                launches, device, peaks):
    counters = store.counters()
    mem = (max(peaks["first_launch_peak_bytes"],
               torch.cuda.max_memory_allocated())
           if device.type == "cuda" else 0)
    steady = step_s[1:] or step_s
    ms = [t for t, _, _ in lat]
    return {
        "spans_streamed": written, "launches": len(step_s),
        "batch_spans": scale.batch_traces * 7,
        "ingest_spans_per_s": written / stream_s,
        "ingest_spans_per_s_after_first": (
            scale.batch_traces * 7 * len(steady) / sum(steady)),
        "first_launch_s": step_s[0],
        "query_p50_ms": float(np.percentile(ms, 50)),
        "query_p99_ms": float(np.percentile(ms, 99)),
        "queries": len(lat),
        "slowest_queries_ms": sorted(lat, reverse=True)[:5],
        "query_gc_ms": sum(g for _, _, g in lat),
        "index_hits": counters["index_hits"],
        "index_scan_fallbacks": counters["index_scan_fallbacks"],
        "max_memory_allocated_bytes": mem,
        **peaks,
        "kernel_launches": launches,
        "ingest_steps": store.counter_block()["batches"],
    }


def main_path(torch, K, dev, scale, device):
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    cfg = full_config(dev, scale.cap_log2, scale.services)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    store = TorchSpanStore(cfg, device=device.type)
    gen = ColumnarTraceGen(store.dicts, n_services=scale.services,
                           n_span_names=scale.names, topology=True, seed=1)
    rec = Recorder(K)
    K.reset_launches()
    n_launches = -(-scale.stream_spans // (scale.batch_traces * 7))
    written, step_s, stream_s, peaks = stream(torch, store, gen, scale,
                                              n_launches, device)
    profile = None
    if scale.profile_steps:
        profile = profile_steps(torch, store, gen, scale)
    traces, names = known_traces(scale)
    store.apply([s for t in traces for s in t])
    sync(torch, device)
    launches = dict(K.LAUNCHES)
    rec.restore()
    cb = store.counter_block()
    log(f"ring path: {written} spans streamed in {len(step_s)} launches, "
        f"{stream_s:.3f} s; ring laps {cb['ring_laps']}; launches "
        f"{launches}")
    check_launches(launches, ("flat_histogram", "arena_claim",
                              "arena_write"), device, "ring", cb["batches"])
    if cb["ring_laps"] < 1:
        fail("the span ring did not wrap")
    lat = known_answer_reads(store, traces, [], None, names, gen)
    result = path_result(torch, store, scale, written, step_s, stream_s,
                         lat, launches, device, peaks)
    result["idle_share"] = (profile["idle_share"] if profile
                            else "not measured")
    result["device_ms_per_launch"] = (
        profile["device_busy_ms"] / profile["launches"] if profile
        else "not measured")
    result["spans_profiled"] = (profile["launches"] * scale.batch_traces * 7
                                if profile else 0)
    log("ring path result: " + json.dumps(result))
    del store
    return rec, result


def paged_path(torch, K, dev, scale, device):
    """The paged layout at full width: stream past the page pool, then
    the known set with big and chain-overflowed traces."""
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    cfg = full_config(dev, scale.paged_cap_log2, scale.services,
                      **paged_layout(scale))
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    store = TorchSpanStore(cfg, device=device.type)
    planner = store._planner
    plan_s = []
    plan_unit = planner.plan_unit

    def timed_plan(*a, **kw):
        t = time.perf_counter()
        out = plan_unit(*a, **kw)
        plan_s.append(time.perf_counter() - t)
        return out

    planner.plan_unit = timed_plan
    gen = ColumnarTraceGen(store.dicts, n_services=scale.services,
                           n_span_names=scale.names, topology=True, seed=1)
    rec = Recorder(K, record=("gather",))
    K.reset_launches()
    written, step_s, stream_s, peaks = stream(torch, store, gen, scale,
                                              scale.paged_launches, device)
    stream_plan_s = list(plan_s)
    reclaims_stream = planner.stats()["page_reclaims"]
    traces, names = known_traces(scale)
    big, overflow = big_traces(scale, names)
    store.apply([s for t in traces + big + [overflow] for s in t])
    sync(torch, device)
    if planner.chains_for([overflow[0].trace_id]) is not None:
        fail("the overflow trace kept a page chain")
    lat = known_answer_reads(store, traces, big, overflow, names, gen)
    sync(torch, device)
    launches = dict(K.LAUNCHES)
    rec.restore()
    split = {"overflow_trace": read_split(store, [overflow[0].trace_id]),
             "big_traces": read_split(store, [t[0].trace_id for t in big])}
    counters = store.counters()
    log(f"paged path: {written} spans streamed in {len(step_s)} launches, "
        f"{stream_s:.3f} s; {counters['page_reclaims_total']:.0f} page "
        f"reclaims; launches {launches}")
    check_launches(launches, K.KERNELS, device, "paged",
                   store.counter_block()["batches"])
    if counters["page_reclaims_total"] <= 0 or reclaims_stream <= 0:
        fail("the paged stream reclaimed no page")
    result = path_result(torch, store, scale, written, step_s, stream_s,
                         lat, launches, device, peaks)
    steady_plan = stream_plan_s[1:] or stream_plan_s
    result.update({
        "pages": cfg.n_pages, "page_rows": cfg.page_rows,
        "page_reclaims_stream": reclaims_stream,
        "page_reclaims_total": counters["page_reclaims_total"],
        "pages_active": counters["pages_active"],
        "planner_s_stream": sum(stream_plan_s),
        "planner_s_max_launch": max(stream_plan_s),
        "planner_s_share_after_first": (
            sum(steady_plan) / sum(step_s[1:] or step_s)),
        "planner_s_known_apply": sum(plan_s) - sum(stream_plan_s),
        "step_s_per_launch": step_s, "planner_s_per_launch": stream_plan_s,
        "big_trace_spans": [len(t) for t in big],
        "overflow_trace_spans": len(overflow),
        "gather_pages_max": int(rec.gather[1].numel()) if rec.gather else 0,
        "read_split": split,
    })
    log("paged path result: " + json.dumps(result))
    del store
    return rec, result


# The daemon's window geometry (``--window-seconds 60 --window-buckets
# 64``); window-path launches move two buckets a launch, parity batches
# three, so both lap the 64-slot ring.
WINDOW = dict(window_seconds=60, window_buckets=64)
WIN_US = 60_000_000
WIN_BASE_US = (1_700_000_000_000_000 // WIN_US) * WIN_US
WIN_STEP_US = 2 * WIN_US
PARITY_STEP_US = 3 * WIN_US
WINDOW_LEAVES = ("svc_hist", "ann_svc_counts", "name_presence",
                 "ann_value_counts", "bann_key_counts", "hll_traces",
                 "win_epoch", "win_counts", "win_sums", "win_mm")


def error_marker(dicts):
    """Marks error spans of a generated batch in place, in both
    conventions: every 53rd span's custom annotation becomes "error",
    every 71st span's binary key becomes "error". Returns ``mark(batch)
    -> per-span error flags``."""
    ea = dicts.annotations.encode("error")
    eb = dicts.binary_keys.encode("error")

    def mark(batch):
        n = batch.n_spans
        # Annotation rows alternate (sr, custom) a span.
        batch.ann_value_id[1::2][::53] = ea
        batch.bann_key_id[::71] = eb
        err = np.zeros(n, bool)
        err[::53] = err[::71] = True
        return err

    return mark


class WindowOracle:
    """The window cells' span and error counts a service, kept on the
    host from the generated batches alone: a slot ends holding exactly
    the rows of the largest bucket that ever landed on it."""

    def __init__(self, n_services: int, slots: int):
        self.S, self.W = n_services, slots
        self.svc, self.bkt, self.err = [], [], []

    def add(self, batch, err):
        n = batch.n_spans
        svc = batch.service_id[:n].astype(np.int64)
        tsf = batch.ts_first[:n]
        ok = (svc >= 0) & (svc < self.S) & (tsf >= 0)
        self.svc.append(svc[ok])
        self.bkt.append(tsf[ok] // WIN_US)
        self.err.append(err[ok])

    def epochs(self):
        bkt = np.concatenate(self.bkt)
        ep = np.full(self.W, -1, np.int64)
        np.maximum.at(ep, bkt % self.W, bkt)
        return ep

    def counts(self):
        """(spans, errors) a service over the live cells."""
        svc, bkt = np.concatenate(self.svc), np.concatenate(self.bkt)
        err = np.concatenate(self.err)
        live = bkt == self.epochs()[bkt % self.W]
        return (np.bincount(svc[live], minlength=self.S),
                np.bincount(svc[live & err], minlength=self.S))


def free_card(torch, device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def timed_mirror(store):
    """Wraps the store's mirror so each ``delta_of`` (stage 1) and
    ``apply`` (commit) call adds its host seconds to the returned
    list."""
    m = store.sketch_mirror
    seconds = []
    for name in ("delta_of", "apply"):
        def timed(*a, _fn=getattr(m, name)):
            t = time.perf_counter()
            out = _fn(*a)
            seconds.append(time.perf_counter() - t)
            return out
        setattr(m, name, timed)
    return seconds


def mirror_equals_device(store, what):
    from zipkin_tpu_torch.store.convert import state_to_numpy

    st = state_to_numpy(store.state)
    for name, got in zip(WINDOW_LEAVES, store.sketch_mirror.arrays()):
        if got.dtype != st[name].dtype or not np.array_equal(got, st[name]):
            fail(f"{what}: the sketch mirror's {name} differs from the "
                 f"device leaf")


def window_path(torch, K, dev, scale, device, ring):
    """The daemon's default store: the 1k-service / 2^22 ring with the
    windowed arena on (60 s x 64 buckets). Streams launches two buckets
    apart (the slot ring laps), then one late launch at the first
    launch's time, whose rows lose the epoch war. K1 must launch once a
    step with eight sites; the mirror must equal the device leaves; ten
    services' live-cell span and error counts must equal the host
    oracle's. Times the three windowed reads."""
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    cfg = full_config(dev, scale.cap_log2, scale.services, **WINDOW)
    free_card(torch, device)
    store = TorchSpanStore(cfg, device=device.type)
    gen = ColumnarTraceGen(store.dicts, n_services=scale.services,
                           n_span_names=scale.names, topology=True, seed=1)
    mark = error_marker(store.dicts)
    oracle = WindowOracle(cfg.max_services, cfg.win_slots)
    mirror_s = timed_mirror(store)
    m = store.sketch_mirror

    def batch_of(i):
        batch, lc, ix = gen.next_batch(scale.batch_traces,
                                       base_ts=WIN_BASE_US + i * WIN_STEP_US)
        oracle.add(batch, mark(batch))
        return batch, lc, ix

    rec = Recorder(K, record=("hist",))
    K.reset_launches()
    written, step_s, stream_s, peaks = stream(
        torch, store, gen, scale, scale.window_launches, device, batch_of)
    profile = None
    if scale.profile_steps:
        n = scale.window_launches
        profile = profile_steps(torch, store, gen, scale,
                                lambda i: batch_of(n + i), "window")
    stream_mirror_s = mirror_s[:2 * len(step_s)]
    epoch_before = oracle.epochs()
    before = m.win_spans_total
    # The late launch: the first launch's time, after the ring lapped.
    late, _, late_ix = batch_of(0)
    store.write_batch(late, late_ix)
    sync(torch, device)
    launches = dict(K.LAUNCHES)
    rec.restore()
    cb = store.counter_block()
    check_launches(launches, ("flat_histogram", "arena_claim",
                              "arena_write"), device, "window", cb["batches"])
    late_bkt = late.ts_first[:late.n_spans] // WIN_US
    late_live = int((late_bkt >= epoch_before[late_bkt % cfg.win_slots]).sum())
    if m.win_spans_total - before != late_live:
        fail(f"window path: the late launch folded "
             f"{m.win_spans_total - before} rows, {late_live} expected")
    if late_live >= late.n_spans // 2:
        fail("window path: the late launch's rows did not lose the war")
    mirror_equals_device(store, "window path")
    epoch = m.win_epoch
    b0 = WIN_BASE_US // WIN_US
    if epoch[b0 % cfg.win_slots] <= b0 or not np.array_equal(
            epoch, oracle.epochs()):
        fail("window path: the slot ring did not lap as the oracle did")
    names = [f"svc-{i:04d}" for i in range(10)]
    spans_want, errs_want = oracle.counts()
    live = epoch >= 0
    for name in names:
        svc = store.dicts.services.get(name)
        got = m.win_counts[svc][live].sum(axis=0)
        if (int(got[0]), int(got[1])) != (int(spans_want[svc]),
                                          int(errs_want[svc])):
            fail(f"window path: {name} holds {got[:2]} spans/errors in its "
                 f"live cells, the host counted "
                 f"{(spans_want[svc], errs_want[svc])}")
    reads = {}
    for label, fn in (
            ("windowed_quantiles",
             lambda n: store.windowed_quantiles(n, [0.5, 0.9, 0.99])),
            ("slo_burn", lambda n: store.slo_burn(
                n, windows_s=[300, 3600, 21600])),
            ("latency_heatmap", lambda n: store.latency_heatmap(n))):
        ms = []
        for name in names:
            t = time.perf_counter()
            out = fn(name)
            ms.append((time.perf_counter() - t) * 1e3)
            if out is None:
                fail(f"window path: {label} of {name} answered None")
        reads[label] = {"p50_ms": float(np.percentile(ms, 50)),
                        "max_ms": max(ms)}
    per_launch = [a + b for a, b in zip(stream_mirror_s[0::2],
                                        stream_mirror_s[1::2])]
    steady = step_s[1:] or step_s
    counters = store.counters()
    mem = (max(peaks["first_launch_peak_bytes"],
               torch.cuda.max_memory_allocated())
           if device.type == "cuda" else 0)
    result = {
        "spans_streamed": written, "launches": len(step_s),
        "spans_profiled": (profile["launches"] * scale.batch_traces * 7
                           if profile else 0),
        "ingest_spans_per_s": written / stream_s,
        "ingest_spans_per_s_after_first": (
            scale.batch_traces * 7 * len(steady) / sum(steady)),
        "ring_path_spans_per_s_after_first": ring[
            "ingest_spans_per_s_after_first"],
        "mirror_s_per_launch_after_first": float(np.mean(
            per_launch[1:] or per_launch)),
        "mirror_share_after_first": (sum(per_launch[1:] or per_launch)
                                     / sum(steady)),
        "mirror_delta_s_mean": float(np.mean(stream_mirror_s[0::2])),
        "mirror_apply_s_mean": float(np.mean(stream_mirror_s[1::2])),
        "window_spans": counters["window_spans"],
        "window_errors": counters["window_errors"],
        "late_rows": late.n_spans, "late_rows_folded": late_live,
        "device_ms_per_launch": (profile["device_busy_ms"]
                                 / profile["launches"] if profile
                                 else "not measured"),
        "idle_share": profile["idle_share"] if profile else "not measured",
        "ring_path_device_ms_per_launch": ring.get(
            "device_ms_per_launch", "not measured"),
        "buckets_spanned": int(epoch.max() - WIN_BASE_US // WIN_US + 1),
        "reads_ms": reads,
        "max_memory_allocated_bytes": mem,
        "ring_path_max_memory_allocated_bytes": ring[
            "max_memory_allocated_bytes"], **peaks,
        "kernel_launches": launches, "ingest_steps": cb["batches"],
    }
    log("window path result: " + json.dumps(result))
    del store
    return rec, result


def span_applies(scale, n_applies: int, n_traces: int, step_us: int,
                 seed: int):
    """``n_applies`` lists of Span objects (generated columns decoded,
    errors marked), one an ``apply`` call, ``step_us`` apart."""
    from zipkin_tpu_torch.columnar.encode import SpanCodec
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    codec = SpanCodec()
    gen = ColumnarTraceGen(codec.dicts, n_services=scale.services,
                           n_span_names=scale.names, topology=True,
                           seed=seed)
    mark = error_marker(codec.dicts)
    out = []
    for i in range(n_applies):
        batch, _, _ = gen.next_batch(n_traces,
                                     base_ts=WIN_BASE_US + i * step_us)
        mark(batch)
        out.append(codec.decode(batch))
    return out


def pipeline_path(torch, K, dev, scale, device):
    """The daemon's ``--pipeline-depth 4`` write path at full width with
    the window on: the same ``apply`` calls into a serial store and
    into ``store.pipelined(depth=4)``; the states must be equal (integer
    leaves bitwise, ``dep_*`` by stated tolerance 2) and so must the
    mirrors. The first call warms each store and is not timed. The
    pipelined drive runs twice: at the interpreter's default thread
    switch interval, and at 0.5 ms (restored after), which shows how
    much of the pipelined rate the threads lose waiting for the
    interpreter lock."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.store.convert import state_to_numpy
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore

    cfg = full_config(dev, scale.cap_log2, scale.services, **WINDOW)
    t = time.perf_counter()
    applies = span_applies(scale, scale.pipe_applies, scale.pipe_traces,
                           WIN_STEP_US, seed=5)
    setup_s = time.perf_counter() - t
    n_timed = sum(len(a) for a in applies[1:])
    free_card(torch, device)
    serial = TorchSpanStore(cfg, device=device.type)
    serial.apply(applies[0])
    sync(torch, device)
    t = time.perf_counter()
    for spans in applies[1:]:
        serial.apply(spans)
    sync(torch, device)
    serial_s = time.perf_counter() - t
    want = state_to_numpy(serial.state)
    result = {
        "applies": len(applies), "spans_timed": n_timed,
        "spans_per_apply": len(applies[1]), "setup_decode_s": setup_s,
        "serial_s": serial_s, "serial_spans_per_s": n_timed / serial_s}
    default_interval = sys.getswitchinterval()
    for label, interval in (("pipelined", default_interval),
                            ("pipelined_switch_0p5ms", 5e-4)):
        piped = TorchSpanStore(cfg, device=device.type,
                               registry=obs.Registry())
        K.reset_launches()
        sys.setswitchinterval(interval)
        try:
            with piped.pipelined(depth=4) as pipe:
                piped.apply(applies[0])
                piped.drain_pipeline()
                sync(torch, device)
                t = time.perf_counter()
                for spans in applies[1:]:
                    piped.apply(spans)
                piped.drain_pipeline()
                sync(torch, device)
                piped_s = time.perf_counter() - t
                if pipe.error is not None:
                    fail(f"pipeline path: parked error {pipe.error!r}")
                sketches = {k: getattr(pipe, k).snapshot()
                            for k in ("h_encode", "h_stage", "h_commit")}
                units = pipe.c_units.value
        finally:
            sys.setswitchinterval(default_interval)
        launches = dict(K.LAUNCHES)
        cb = piped.counter_block()
        check_launches(launches, ("flat_histogram", "arena_claim",
                                  "arena_write"), device, "pipeline",
                       cb["batches"])
        if cb != serial.counter_block():
            fail("pipeline path: counter blocks differ from the serial "
                 "store's")
        _check_states_equal(want, state_to_numpy(piped.state),
                            f"pipeline path ({label})")
        for a, b in zip(serial.sketch_mirror.arrays(),
                        piped.sketch_mirror.arrays()):
            if not np.array_equal(a, b):
                fail(f"pipeline path ({label}): the mirrors differ")
        mirror_equals_device(piped, f"pipeline path ({label})")
        result[label] = {
            "switch_interval_s": interval, "units": units,
            "ingest_steps": cb["batches"], "seconds": piped_s,
            "spans_per_s": n_timed / piped_s,
            "over_serial": serial_s / piped_s, "sketches_s": sketches,
            "window_spans": piped.counters()["window_spans"]}
        result["kernel_launches"] = launches
        result["ingest_steps"] = cb["batches"]
        del piped
        free_card(torch, device)
    log("pipeline path result: " + json.dumps(result))
    del serial
    return result


def _answers(store, tids, names):
    """The reads the durability phases compare: whole traces (in
    batches of 250), by-service lookups, dependency links with their
    counts and, with the window on, the windowed reads."""
    out = {"traces": [store.get_spans_by_trace_ids(tids[i:i + 250])
                      for i in range(0, len(tids), 250)]}
    end = 2**62
    out["by_service"] = [store.get_trace_ids_by_name(n, None, end, 20)
                         for n in names]
    out["by_annotation"] = [store.get_trace_ids_by_annotation(
        n, "http.uri", b"/api/widgets", end, 20) for n in names]
    out["links"] = sorted((l.parent, l.child, l.duration_moments.count)
                          for l in store.get_dependencies().links)
    if store.config.window_enabled:
        out["windowed_quantiles"] = [
            store.windowed_quantiles(n, [0.5, 0.9, 0.99]) for n in names]
        out["slo_burn"] = [store.slo_burn(n, windows_s=[300, 3600, 21600])
                           for n in names]
    return out


def _compare_answers(want, got, what):
    for k, v in want.items():
        if got[k] != v:
            fail(f"{what}: the recovered store's {k} answers differ")
    if not any(want["by_service"]) or not want["links"]:
        fail(f"{what}: the reads compared nothing")


def durability_path(torch, K, dev, scale, device):
    """Checkpoint + WAL at full width on the daemon's default store (the
    window on): 5 launches journaled with the daemon's log defaults,
    ``checkpoint.save``, 5 more, then ``wal.recover`` on the card into a
    second store; the uncrashed store is the reference."""
    from zipkin_tpu_torch import checkpoint, obs
    from zipkin_tpu_torch.store.convert import state_to_numpy
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen
    from zipkin_tpu_torch.wal import WriteAheadLog, recover

    cfg = full_config(dev, scale.cap_log2, scale.services, **WINDOW)
    free_card(torch, device)
    work = tempfile.mkdtemp(prefix="zipkin-durability-")
    wal_dir, ckpt = os.path.join(work, "wal"), os.path.join(work, "ckpt")
    try:
        store = TorchSpanStore(cfg, device=device.type,
                               registry=obs.Registry())
        gen = ColumnarTraceGen(store.dicts, n_services=scale.services,
                               n_span_names=scale.names, topology=True,
                               seed=11)
        mark = error_marker(store.dicts)
        reg = obs.Registry()
        # The daemon's log defaults (zipkin_tpu/main/example.py).
        wal = WriteAheadLog(wal_dir, fsync="interval", interval_s=0.05,
                            segment_bytes=64 << 20, registry=reg)
        store.attach_wal(wal)
        # The journal's host seconds a launch (encode_unit + deflate +
        # the log's write), to split the journaled launch.
        journal_s = []
        journal = store._journal_group

        def timed_journal(group):
            t = time.perf_counter()
            seq = journal(group)
            journal_s.append(time.perf_counter() - t)
            return seq

        store._journal_group = timed_journal
        n = scale.durability_launches
        tids = []

        def launch(i, into):
            batch, _, ix = gen.next_batch(
                scale.batch_traces, base_ts=WIN_BASE_US + i * WIN_STEP_US)
            mark(batch)
            tids.extend(int(t) for t in np.unique(
                batch.trace_id[:batch.n_spans][::1009]))
            into.write_batch(batch, ix)

        t = time.perf_counter()
        for i in range(n):
            launch(i, store)
        sync(torch, device)
        first_s = time.perf_counter() - t
        wal_before = wal.stats()
        steps_at_save = store.counter_block()["batches"]
        t = time.perf_counter()
        save = checkpoint.save(store, ckpt)
        save["total_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(n, 2 * n):
            launch(i, store)
        sync(torch, device)
        second_s = time.perf_counter() - t
        store.wal_sync()
        append_p50, append_p99 = wal.h_append.quantile_values([0.5, 0.99])
        wal_after = wal.stats()
        wal.close()
        store.wal = None
        want_state = state_to_numpy(store.state)
        names = [f"svc-{i:04d}" for i in range(min(10, scale.services))]

        free_card(torch, device)
        wal2 = WriteAheadLog(wal_dir, fsync="interval", interval_s=0.05,
                             segment_bytes=64 << 20, registry=obs.Registry())
        K.reset_launches()
        t = time.perf_counter()
        rec, stats = recover(ckpt, wal2, device=device.type)
        sync(torch, device)
        recover_s = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated()
                if device.type == "cuda" else 0)
        replayed_steps = rec.counter_block()["batches"] - steps_at_save
        if (device.type == "cuda"
                and K.LAUNCHES["flat_histogram"] != replayed_steps):
            fail(f"durability path: flat_histogram launched "
                 f"{K.LAUNCHES['flat_histogram']} times in "
                 f"{replayed_steps} replayed steps")
        if stats["replayed_records"] != n or stats["applied_seq"] != 2 * n:
            fail(f"durability path: replayed {stats}, expected {n} records "
                 f"up to seq {2 * n}")
        _check_states_equal(want_state, state_to_numpy(rec.state),
                            "durability path (recovered)")
        if rec.counter_block() != store.counter_block():
            fail("durability path: the recovered counter block differs")
        rec.ensure_sketch_mirror()
        mirror_equals_device(rec, "durability path (recovered)")
        for a, b in zip(store.sketch_mirror.arrays(),
                        rec.sketch_mirror.arrays()):
            if not np.array_equal(a, b):
                fail("durability path: the recovered mirror differs")
        want = _answers(store, tids, names)
        got = _answers(rec, tids, names)
        _compare_answers(want, got, "durability path")
        # One more launch journals after the replayed tail.
        launch(2 * n, rec)
        sync(torch, device)
        launches = dict(K.LAUNCHES)
        steps = replayed_steps + 1
        check_launches(launches, ("flat_histogram", "arena_claim",
                                  "arena_write"), device, "durability",
                       steps)
        if wal2.last_seq != 2 * n + 1:
            fail(f"durability path: the launch after recovery journaled "
                 f"as record {wal2.last_seq}, not {2 * n + 1}")
        wal2.close()
        load = stats["load"]
        result = {
            "launches_before_save": n, "launches_after_save": n,
            "spans_per_launch": scale.batch_traces * 7,
            "journaled_ingest_spans_per_s": (
                2 * n * scale.batch_traces * 7 / (first_s + second_s)),
            "journal_s_per_launch": float(np.mean(journal_s)),
            "journal_share_of_launch": (sum(journal_s)
                                        / (first_s + second_s)),
            "save_s": save["total_s"],
            "save_split_s": {k: save[k] for k in (
                "gather_s", "crc_s", "compress_s", "rename_s")},
            "snapshot_bytes_on_disk": save["bytes_on_disk"],
            "wal_truncated_segments": save["wal_truncated_segments"],
            "load_s": load["total_s"],
            "load_split_s": {k: load[k] for k in (
                "inflate_s", "crc_s", "h2d_s")},
            "replay_s": stats["replay_s"],
            "replayed_records": stats["replayed_records"],
            "replayed_spans": stats["replayed_spans"],
            "replayed_spans_per_s": (stats["replayed_spans"]
                                     / stats["replay_s"]),
            "recover_s": recover_s,
            "wal_bytes_before_save": wal_before["wal_bytes"],
            "wal_bytes_end": wal_after["wal_bytes"],
            "wal_segments_end": wal_after["wal_segments"],
            "wal_append_p50_s": append_p50, "wal_append_p99_s": append_p99,
            "recover_peak_device_bytes": peak,
            "traces_compared": len(tids),
            "links_compared": len(want["links"]),
            "kernel_launches": launches, "ingest_steps": steps,
        }
        log("durability path result: " + json.dumps(result))
        del store, rec
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def durability_paged(torch, K, dev, scale, device):
    """The paged layout at capacity 2^14, pipelined: the checkpoint is
    cut while a writer plans units past the gathered frontier, so its
    planner memo holds their page claims; recovery on the card must
    take them from the memo, land the uncrashed planner and state, and
    serve the page-gather reads the uncrashed store serves."""
    from zipkin_tpu_torch import checkpoint, obs
    from zipkin_tpu_torch.store.convert import state_to_numpy
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.wal import WriteAheadLog, replay_into

    cfg = full_config(dev, scale.dur_paged_log2, scale.services,
                      **paged_layout(scale))
    applies = span_applies(scale, scale.dur_paged_applies,
                           scale.dur_paged_traces, WIN_STEP_US, seed=13)
    free_card(torch, device)
    work = tempfile.mkdtemp(prefix="zipkin-durability-paged-")
    wal_dir, ckpt = os.path.join(work, "wal"), os.path.join(work, "ckpt")
    half = len(applies) // 2
    try:
        store = TorchSpanStore(cfg, device=device.type,
                               registry=obs.Registry())
        wal = WriteAheadLog(wal_dir, fsync="off", registry=obs.Registry())
        store.attach_wal(wal)
        planner = store._planner
        with store.pipelined(depth=4):
            for spans in applies[:half]:
                store.apply(spans)
            snapshot = planner.snapshot

            def racing_snapshot():
                # A writer lands between the gather and the planner cut.
                store.apply(applies[half])
                return snapshot()

            planner.snapshot = racing_snapshot
            t = time.perf_counter()
            save = checkpoint.save(store, ckpt)
            save_s = time.perf_counter() - t
            planner.snapshot = snapshot
            for spans in applies[half + 1:]:
                store.apply(spans)
        sync(torch, device)
        wal.sync()
        wal.close()
        store.wal = None
        with open(os.path.join(ckpt, "meta.json")) as f:
            meta = json.load(f)
        ahead = meta["paged"]["last_seq"] - meta["clocks"]["wal_applied"]
        if ahead <= 0:
            fail("durability paged: no unit was planned past the "
                 "checkpoint's frontier")
        if planner.stats()["page_reclaims"] <= 0:
            fail("durability paged: the page pool never reclaimed")
        # recover()'s two steps, with the replay's planner calls counted:
        # a unit the snapshot planned must take its recorded plan.
        load_stats = {}
        rec = checkpoint.load(ckpt, device=device.type, stats=load_stats)
        memo = []
        plan_unit = rec._planner.plan_unit

        def counting(chunk_tids, wal_seq=None):
            if wal_seq is not None and wal_seq <= rec._planner.last_seq:
                memo.append(wal_seq)
            return plan_unit(chunk_tids, wal_seq=wal_seq)

        rec._planner.plan_unit = counting
        wal2 = WriteAheadLog(wal_dir, fsync="off", registry=obs.Registry())
        rec.attach_wal(wal2)
        stats = replay_into(rec, wal2)
        wal2.close()
        rec._planner.plan_unit = plan_unit
        if len(memo) != ahead:
            fail(f"durability paged: {len(memo)} replayed units took the "
                 f"recorded plan, {ahead} were planned ahead")
        if rec._planner.snapshot() != planner.snapshot():
            fail("durability paged: the recovered planner differs")
        _check_states_equal(state_to_numpy(store.state),
                            state_to_numpy(rec.state),
                            "durability paged (recovered)")
        tids = sorted({s.trace_id for spans in applies[-3:]
                       for s in spans[::97]})
        K.reset_launches()
        got = [rec.get_spans_by_trace_ids(tids[i:i + 250])
               for i in range(0, len(tids), 250)]
        sync(torch, device)
        launches = dict(K.LAUNCHES)
        want = [store.get_spans_by_trace_ids(tids[i:i + 250])
                for i in range(0, len(tids), 250)]
        if got != want or not any(want):
            fail("durability paged: recovered trace reads differ")
        if device.type == "cuda" and launches["paged_page_gather"] <= 0:
            fail("durability paged: the reads did not launch the page "
                 "gather")
        result = {
            "capacity": cfg.capacity, "pages": cfg.n_pages,
            "applies": len(applies), "units_planned_ahead": ahead,
            "replayed_from_memo": len(memo),
            "replayed_records": stats["replayed_records"],
            "page_reclaims": planner.stats()["page_reclaims"],
            "save_s": save_s, "save_split_s": {k: save[k] for k in (
                "gather_s", "crc_s", "compress_s", "rename_s")},
            "load_s": load_stats["total_s"],
            "replay_s": stats["replay_s"],
            "traces_read": len(tids), "read_launches": launches,
        }
        log("durability paged result: " + json.dumps(result))
        del store, rec
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# Eviction capture and the cold tier
# ---------------------------------------------------------------------------

# The cold-tier phases' known traces run on services and span names of
# their own (the stream's generator leaves these ids free), so an
# oracle fed only the known and sampled spans answers the lookups, the
# dependency links and the quantiles of these services exactly.
COLD_SERVICES = [f"ck-svc-{i}" for i in range(5)]
COLD_OPS = [f"ck-op-{i}" for i in range(10)]


def cold_known(n_traces: int, seed: int, base_ts: int):
    from zipkin_tpu_torch.tracegen import generate_traces

    rng = np.random.default_rng(seed)
    traces = generate_traces(n_traces=n_traces, max_depth=3, n_services=5,
                             rng=rng, base_ts=base_ts)
    return [rename_services(t, COLD_SERVICES, COLD_OPS) for t in traces]


def link_counts(spans, services):
    """(parent service, child service) -> joined children with a
    duration, over ``spans`` (one object a span), restricted to
    ``services``: the dependency links an exact join gives."""
    by_key = {(s.trace_id, s.id): s for s in spans}
    out = {}
    for s in spans:
        p = by_key.get((s.trace_id, s.parent_id))
        if p is None or s.duration is None:
            continue
        pair = (p.service_name, s.service_name)
        if pair[0] in services and pair[1] in services:
            out[pair] = out.get(pair, 0) + 1
    return out


def cold_reads_vs_oracle(store, oracle, tids, what, lookups=True,
                         bounds=None):
    """Every read the cold-tier phases hold against the oracle: whole
    traces one by one (returns their ms), traces_exist and
    get_traces_duration on the sample plus an absent id, and, with
    ``lookups``, the name and annotation lookups, the dependency links
    and the duration quantiles of the cold-tier services. ``bounds``
    gives the (first, last) timestamps of generated stream traces from
    their columns: the generator's ts columns carry client-side times
    its annotation rows do not, so a decoded span's timestamps (the
    oracle's) differ from the columns every store reads."""
    from zipkin_tpu_torch.ops.quantile import quantiles_host
    from zipkin_tpu_torch.store.archive import sketches as SK

    ms = []
    for tid in tids:
        t = time.perf_counter()
        got = store.get_spans_by_trace_ids([tid])
        ms.append((time.perf_counter() - t) * 1e3)
        want = oracle.get_spans_by_trace_ids([tid])
        if got != want or not want:
            fail(f"{what}: trace {tid} reads back "
                 f"{sum(map(len, got))} spans, the oracle "
                 f"{sum(map(len, want))}")
    probe = list(tids) + [123456789]
    if store.traces_exist(probe) != oracle.traces_exist(probe):
        fail(f"{what}: traces_exist differs from the oracle")
    if (store.get_traces_duration(probe)
            != expected_durations(oracle, probe, bounds or {})):
        fail(f"{what}: get_traces_duration differs from the oracle")
    if not lookups:
        return ms
    end = 2**62
    for svc, name in ((COLD_SERVICES[0], None),
                      (COLD_SERVICES[1], COLD_OPS[3])):
        want = oracle.get_trace_ids_by_name(svc, name, end, 20)
        if store.get_trace_ids_by_name(svc, name, end, 20) != want \
                or not want:
            fail(f"{what}: by-name lookup {svc}/{name} differs")
    want = oracle.get_trace_ids_by_annotation(
        COLD_SERVICES[2], "http.uri", b"/api/widgets", end, 20)
    if not want or store.get_trace_ids_by_annotation(
            COLD_SERVICES[2], "http.uri", b"/api/widgets", end,
            20) != want:
        fail(f"{what}: by-annotation lookup differs")
    svcs = set(COLD_SERVICES)
    want = link_counts(oracle.spans, svcs)
    got = {(lk.parent, lk.child): int(lk.duration_moments.count)
           for lk in store.get_dependencies().links
           if lk.parent in svcs and lk.child in svcs}
    if got != want or not want:
        fail(f"{what}: dependency links of the cold-tier services "
             f"differ ({len(got)} vs {len(want)})")
    gamma = store.params.hist_gamma
    qs = [0.5, 0.9, 0.99]
    for svc in COLD_SERVICES:
        counts = np.zeros(store.params.hist_buckets, np.int64)
        SK.hist_add(counts, np.asarray(
            [s.duration for s in oracle.spans
             if s.service_name == svc and s.duration is not None],
            np.int64), gamma)
        if store.service_duration_quantiles(svc, qs) != quantiles_host(
                counts, gamma, 1.0, qs):
            fail(f"{what}: duration quantiles of {svc} differ")
    return ms


def expected_durations(oracle, tids, bounds):
    from zipkin_tpu_torch.store.base import TraceIdDuration

    want = {d.trace_id: d for d in oracle.get_traces_duration(tids)}
    for tid, (lo, hi) in bounds.items():
        want[tid] = TraceIdDuration(tid, hi - lo, lo)
    return [want[t] for t in tids if t in want]


def column_bounds(batch, tids):
    """{trace id: (min first ts, max last ts)} of ``tids`` from the
    batch's columns (the store's duration semantics)."""
    n = batch.n_spans
    tid, tsf, tsl = (batch.trace_id[:n], batch.ts_first[:n],
                     batch.ts_last[:n])
    out = {}
    for t in tids:
        m = tid == t
        ts = np.concatenate([tsf[m][tsf[m] >= 0], tsl[m][tsl[m] >= 0]])
        out[int(t)] = (int(ts.min()), int(ts.max()))
    return out


def check_cold_coverage(tiered, what):
    """Segments tile [0, capture clock) without gaps; the sealed
    frontier reaches the clock."""
    hot = tiered.hot
    segs = tiered.archive.snapshot()
    if not segs or segs[0].gid_lo != 0:
        fail(f"{what}: no segment, or the first starts past gid 0")
    for a, b in zip(segs, segs[1:]):
        if a.gid_hi != b.gid_lo:
            fail(f"{what}: cold coverage has a hole at {a.gid_hi}")
    if not (segs[-1].gid_hi == hot._cap_upto == hot.sealed_frontier()):
        fail(f"{what}: sealed frontier {hot.sealed_frontier()}, capture "
             f"clock {hot._cap_upto}, last segment {segs[-1].gid_hi}")
    return segs


class SealClock:
    """Times the capture machinery of one tiered store: the pull (host
    ms, its gather's device ms, the count sync), and the seal split
    into the device-to-host copy, the batch rebuild, the decode to Span
    objects, ``seal_segment`` and the directory append. Installs
    wrappers on modules and on the store; ``restore`` takes them off."""

    def __init__(self, torch, tiered):
        from zipkin_tpu_torch.store import device as dev
        from zipkin_tpu_torch.store import pipeline, torch_store
        from zipkin_tpu_torch.store.archive import tiered as tiered_mod

        self.t = {k: [] for k in ("pull_ms", "gather_enqueue_ms",
                                  "gather_device_ms", "d2h_s",
                                  "to_batch_s", "sink_s", "seal_segment_s",
                                  "append_s", "window_spans")}
        self._undo = []
        cuda = torch.cuda.is_available()
        t = self.t

        def patch(obj, name, wrap):
            orig = getattr(obj, name)
            self._undo.append((obj, name, orig, name in vars(obj)))
            setattr(obj, name, wrap(orig))

        def timed(key, scale=1.0, sealer_only=False):
            def wrap(fn):
                def run(*a, **kw):
                    t0 = time.perf_counter()
                    out = fn(*a, **kw)
                    if not sealer_only or (threading.current_thread().name
                                           == "zipkin-capture-seal"):
                        t[key].append((time.perf_counter() - t0) * scale)
                    return out
                return run
            return wrap

        def gather(fn):
            def run(*a, **kw):
                ev = None
                if cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                t["gather_enqueue_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
                if ev is not None:
                    ev[1].record()
                    self._events.append(ev)
                return out
            return run

        self._events = []
        patch(dev, "capture_eviction_rows", gather)
        hot = tiered.hot
        patch(hot, "_pull_evicted_rows", timed("pull_ms", 1e3))
        patch(pipeline, "fetch_mats", timed("d2h_s"))
        # The reads rebuild batches too: time only the sealer's.
        patch(torch_store, "mats_to_batch",
              timed("to_batch_s", sealer_only=True))
        patch(tiered_mod, "seal_segment", timed("seal_segment_s"))
        patch(tiered.archive, "append", timed("append_s"))

        def sink(fn):
            def run(batch, *a):
                t["window_spans"].append(batch.n_spans)
                t0 = time.perf_counter()
                fn(batch, *a)
                t["sink_s"].append(time.perf_counter() - t0)
            return run

        patch(hot, "eviction_sink", sink)

    def restore(self):
        for obj, name, orig, own in reversed(self._undo):
            if own:
                setattr(obj, name, orig)
            else:
                delattr(obj, name)
        self._undo = []

    def summary(self):
        t = self.t
        dev_ms = [a.elapsed_time(b) for a, b in self._events]
        decode = [s - a - b for s, a, b in zip(
            t["sink_s"], t["seal_segment_s"], t["append_s"])]
        n = len(t["sink_s"])
        return {
            "windows_sealed": n, "window_spans": t["window_spans"],
            "pull_ms": t["pull_ms"],
            "pull_gather_enqueue_ms": t["gather_enqueue_ms"],
            "pull_gather_device_ms": dev_ms or "not measured",
            "pull_count_sync_ms": [p - e for p, e in zip(
                t["pull_ms"], t["gather_enqueue_ms"])],
            "seal_s": [a + b + c for a, b, c in zip(
                t["d2h_s"], t["to_batch_s"], t["sink_s"])][:n],
            "seal_d2h_s": t["d2h_s"][:n], "seal_to_batch_s":
                t["to_batch_s"][:n], "seal_decode_s": decode,
            "seal_segment_s": t["seal_segment_s"],
            "seal_append_s": t["append_s"],
        }


def cold_tier_path(torch, K, dev, scale, device, window):
    """The daemon's ``--cold-tier --capture-backlog 4`` store at full
    width: the window path's geometry wrapped as ``TieredSpanStore(hot,
    params=ArchiveParams.for_config(config), background_compaction=
    True)`` with ``hot.capture_backlog = 4``. Launches lap the span ring
    once, so the first capture window (~capacity spans) is pulled and
    sealed on the sealer thread; known traces on services of their own
    go in early (evicted: cold only) and late (resident). The reads hold
    sampled cold-only and resident traces, exist/duration, the lookups,
    dependencies and quantiles against an oracle fed the same spans;
    then ``capture_now`` and ``seal_barrier`` flush the rest and the
    sealed frontier must tile [0, write_pos)."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.store.archive import ArchiveParams, TieredSpanStore
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore

    cfg = full_config(dev, scale.cap_log2, scale.services, **WINDOW)
    free_card(torch, device)
    hot = TorchSpanStore(cfg, device=device.type, registry=obs.Registry())
    hot.capture_backlog = 4
    tiered = TieredSpanStore(hot, params=ArchiveParams.for_config(cfg),
                             registry=obs.Registry(),
                             background_compaction=True)
    clock = SealClock(torch, tiered)
    try:
        return _cold_tier_path(torch, K, scale, device, window, cfg, hot,
                               tiered, clock)
    finally:
        clock.restore()
        tiered.close()
        del hot, tiered
        free_card(torch, device)


def _cold_tier_path(torch, K, scale, device, window, cfg, hot, tiered,
                    clock):
    from zipkin_tpu_torch.store.memory import InMemorySpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    gen = ColumnarTraceGen(hot.dicts,
                           n_services=scale.services - len(COLD_SERVICES),
                           n_span_names=scale.names - len(COLD_OPS),
                           topology=True, seed=21)
    known = cold_known(2 * scale.cold_known, 22, WIN_BASE_US)
    early, late = known[:scale.cold_known], known[scale.cold_known:]
    oracle = InMemorySpanStore()
    sampled = {}
    bounds = {}
    n_launches = scale.cold_launches

    def batch_of(i):
        batch, lc, ix = gen.next_batch(scale.batch_traces,
                                       base_ts=WIN_BASE_US + i * WIN_STEP_US)
        if i in (1, n_launches - 1):
            tid = batch.trace_id[:batch.n_spans]
            pick = np.unique(tid)[::max(1, scale.batch_traces
                                        // scale.cold_sample)]
            keep = np.isin(tid, pick)
            oracle.apply(hot.codec.decode(batch.select(keep)))
            sampled[i] = [int(t) for t in pick]
            bounds.update(column_bounds(batch, pick))
        return batch, lc, ix

    K.reset_launches()
    free_card(torch, device)
    t_start = time.perf_counter()
    step_s = []
    known_s = 0.0
    for i in range(n_launches):
        batch, _, ix = batch_of(i)
        t = time.perf_counter()
        hot.write_batch(batch, ix)
        sync(torch, device)
        step_s.append(time.perf_counter() - t)
        if i == 0 or i == n_launches - 1:
            spans = [s for tr in (early if i == 0 else late) for s in tr]
            t = time.perf_counter()
            tiered.apply(spans)
            sync(torch, device)
            known_s += time.perf_counter() - t
            oracle.apply(spans)
    stream_s = time.perf_counter() - t_start
    t = time.perf_counter()
    tiered.seal_barrier()
    barrier_s = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    steps = hot.counter_block()["batches"]
    check_launches(launches, ("flat_histogram", "arena_claim",
                              "arena_write"), device, "cold tier", steps)
    for half in ("arena_claim", "arena_write"):
        if device.type == "cuda" and launches[half] != steps:
            fail(f"cold tier: {half} launched {launches[half]} times in "
                 f"{steps} steps, not once a step")
    sealer = hot.eviction_sealer()
    if sealer is None or sealer.c_sealed.value < 1:
        fail("cold tier: no capture window was sealed on the sealer")
    segs = tiered.archive.snapshot()
    full_window = max(s.n_spans for s in segs)
    if full_window < cfg.capacity - 2 * scale.batch_traces * 7:
        fail(f"cold tier: the largest sealed window holds {full_window} "
             f"spans, not ~capacity ({cfg.capacity})")
    cold_only = sampled[1] + [tr[0].trace_id for tr in early]
    resident = sampled[n_launches - 1] + [tr[0].trace_id for tr in late]
    if any(hot.get_trace_rows(cold_only[:5])):
        fail("cold tier: the early traces are still in the hot ring")
    mem_peak = (torch.cuda.max_memory_allocated()
                if device.type == "cuda" else 0)
    t = time.perf_counter()
    cold_ms = cold_reads_vs_oracle(tiered, oracle, cold_only,
                                   "cold tier (cold only)", bounds=bounds)
    hot_ms = cold_reads_vs_oracle(tiered, oracle, resident,
                                  "cold tier (resident)", lookups=False,
                                  bounds=bounds)
    reads_s = time.perf_counter() - t
    t = time.perf_counter()
    tiered.capture_now()
    tiered.seal_barrier()
    flush_s = time.perf_counter() - t
    segs = check_cold_coverage(tiered, "cold tier")
    if hot._cap_upto != hot._wp:
        fail("cold tier: capture_now left an uncaptured window")
    # Column-only reads after the flush (no row decode).
    probe = cold_only + resident + [123456789]
    if tiered.traces_exist(probe) != oracle.traces_exist(probe):
        fail("cold tier: traces_exist after the flush differs")
    if (tiered.get_traces_duration(probe)
            != expected_durations(oracle, probe, bounds)):
        fail("cold tier: get_traces_duration after the flush differs")
    stats = tiered.counters()
    seal = clock.summary()
    spans_streamed = n_launches * scale.batch_traces * 7
    steady = step_s[1:] or step_s
    result = {
        "launches": n_launches, "spans_streamed": spans_streamed,
        "known_spans": sum(len(t) for t in known),
        "ingest_spans_per_s": spans_streamed / sum(step_s),
        "ingest_spans_per_s_after_first": (
            scale.batch_traces * 7 * len(steady) / sum(steady)),
        "window_path_spans_per_s_after_first": window[
            "ingest_spans_per_s_after_first"],
        "step_s": step_s, "stream_s": stream_s, "known_apply_s": known_s,
        "seal_barrier_wait_s": barrier_s, "reads_s": reads_s,
        "capture_now_s": flush_s,
        **seal,
        "backlog_stall_s": sealer.c_stall.value,
        "cold_fetch_ms_p50": float(np.percentile(cold_ms, 50)),
        "cold_fetch_ms_p99": float(np.percentile(cold_ms, 99)),
        "resident_fetch_ms_p50": float(np.percentile(hot_ms, 50)),
        "resident_fetch_ms_p99": float(np.percentile(hot_ms, 99)),
        "traces_compared": len(cold_only) + len(resident),
        "segments_written": stats["archive_segments_written"],
        "segments_live": stats["archive_segments_live"],
        "segment_spans": [s.n_spans for s in segs],
        "compactions": stats["archive_compactions"],
        "cold_bytes": stats["archive_cold_bytes"],
        "cold_raw_bytes": stats["archive_cold_raw_bytes"],
        "compression_ratio": (stats["archive_cold_raw_bytes"]
                              / max(stats["archive_cold_bytes"], 1)),
        "max_memory_allocated_bytes": mem_peak,
        "kernel_launches": launches, "ingest_steps": steps,
    }
    log("cold tier path result: " + json.dumps(result))
    return result


def cold_tier_paged(torch, K, dev, scale, device):
    """A paged tiered store at capacity 2^14, pipelined, past the page
    pool: each reclaimed page is pulled and sealed before the launch
    that reuses it (``_capture_pages``); the side rings are sized as in
    tests/test_paged.py (4x and 2x) so they do not lap before a page is
    reclaimed. Whole-trace reads (the page gather) of sampled evicted
    and resident traces are held against the oracle."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.store.archive import ArchiveParams, TieredSpanStore
    from zipkin_tpu_torch.store.memory import InMemorySpanStore
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore

    cfg = full_config(dev, scale.dur_paged_log2, scale.services,
                      **paged_layout(scale))
    cfg = cfg._replace(ann_capacity=4 * cfg.capacity,
                       bann_capacity=2 * cfg.capacity)
    applies = span_applies(scale, scale.dur_paged_applies,
                           scale.dur_paged_traces, WIN_STEP_US, seed=23)
    free_card(torch, device)
    hot = TorchSpanStore(cfg, device=device.type, registry=obs.Registry())
    hot.capture_backlog = 4
    tiered = TieredSpanStore(hot, params=ArchiveParams.for_config(cfg),
                             registry=obs.Registry())
    oracle = InMemorySpanStore()
    K.reset_launches()
    t = time.perf_counter()
    with hot.pipelined(depth=4):
        for spans in applies:
            tiered.apply(spans)
            oracle.apply(spans)
    tiered.seal_barrier()
    sync(torch, device)
    ingest_s = time.perf_counter() - t
    steps = hot.counter_block()["batches"]
    write_launches = dict(K.LAUNCHES)
    check_launches(write_launches, ("flat_histogram", "arena_claim",
                                    "arena_write"), device,
                   "cold tier paged", steps)
    reclaims = hot._planner.stats()["page_reclaims"]
    if reclaims <= 0 or tiered.counters()["archive_segments_written"] <= 0:
        fail("cold tier paged: no page was reclaimed and sealed")
    tids = sorted({s.trace_id for spans in (applies[0], applies[-1])
                   for s in spans[::61]})
    K.reset_launches()
    ms = cold_reads_vs_oracle(tiered, oracle, tids, "cold tier paged",
                              lookups=False)
    sync(torch, device)
    read_launches = dict(K.LAUNCHES)
    if device.type == "cuda" and read_launches["paged_page_gather"] <= 0:
        fail("cold tier paged: the trace reads did not launch the page "
             "gather")
    stats = tiered.counters()
    result = {
        "capacity": cfg.capacity, "pages": cfg.n_pages,
        "applies": len(applies), "ingest_s": ingest_s,
        "page_reclaims": reclaims,
        "segments_written": stats["archive_segments_written"],
        "segments_live": stats["archive_segments_live"],
        "compactions": stats["archive_compactions"],
        "sealed_frontier": hot.sealed_frontier(),
        "cold_spans": stats["archive_cold_spans"],
        "traces_compared": len(tids),
        "read_ms_p50": float(np.percentile(ms, 50)),
        "read_ms_p99": float(np.percentile(ms, 99)),
        "kernel_launches": write_launches, "ingest_steps": steps,
        "read_launches": read_launches,
    }
    log("cold tier paged result: " + json.dumps(result))
    tiered.close()
    del hot, tiered
    return result


def cold_tier_parity(torch, dev, scale, rehearse: bool):
    """A tiered store on the card (capture_backlog 4: the sealer) and
    its CPU twin (inline sealing) fed the same batches at capacity 2^14
    with the window on: the segment lists (ids, [gid_lo, gid_hi)) and
    every segment's ``to_bytes()`` must be bitwise equal; the seal is
    host code, so this holds the pulled rows. Then the card store's
    ``checkpoint.save``/``load`` round trip on the card: the segments,
    the hot state and the capture clocks come back, and trace reads
    equal the saved store's."""
    from zipkin_tpu_torch import checkpoint, obs
    from zipkin_tpu_torch.store.archive import ArchiveParams, TieredSpanStore
    from zipkin_tpu_torch.store.convert import state_to_numpy
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    cfg = full_config(dev, scale.small_log2, scale.services, **WINDOW)
    card = "cpu" if rehearse else "cuda"
    stores = []
    tids = []
    for device, backlog in ((card, 4), ("cpu", 0)):
        hot = TorchSpanStore(cfg, device=device, registry=obs.Registry())
        hot.capture_backlog = backlog
        tiered = TieredSpanStore(hot, params=ArchiveParams.for_config(cfg),
                                 registry=obs.Registry())
        gen = ColumnarTraceGen(hot.dicts, n_services=scale.services,
                               n_span_names=scale.names, topology=True,
                               seed=24)
        for i in range(scale.small_batches):
            batch, _, ix = gen.next_batch(
                scale.small_traces, base_ts=WIN_BASE_US + i * PARITY_STEP_US)
            hot.write_batch(batch, ix)
            if not stores and i % 5 == 0:
                tids.append(int(batch.trace_id[0]))
        tiered.capture_now()
        stores.append(tiered)
    a, b = stores

    def segs(t):
        return [(s.seg_id, s.gid_lo, s.gid_hi, s.to_bytes())
                for s in t.archive.snapshot()]

    want = segs(b)
    if segs(a) != want or len(want) < 2:
        fail(f"cold tier parity: the card's {len(segs(a))} segments differ "
             f"from the cpu twin's {len(want)}")
    check_cold_coverage(a, "cold tier parity")
    _check_states_equal(state_to_numpy(b.hot.state),
                        state_to_numpy(a.hot.state), "cold tier parity")
    work = tempfile.mkdtemp(prefix="zipkin-cold-ckpt-")
    try:
        path = os.path.join(work, "ckpt")
        t = time.perf_counter()
        save = checkpoint.save(a, path)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        got = checkpoint.load(path, device=card)
        load_s = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if not isinstance(got, TieredSpanStore) or segs(got) != segs(a):
        fail("cold tier checkpoint: the restored segments differ")
    _check_states_equal(state_to_numpy(a.hot.state),
                        state_to_numpy(got.hot.state),
                        "cold tier checkpoint")
    if (got.hot._cap_upto, got.hot.sealed_frontier()) != (
            a.hot._cap_upto, a.hot.sealed_frontier()):
        fail("cold tier checkpoint: the capture clocks differ")
    if (got.get_spans_by_trace_ids(tids) != a.get_spans_by_trace_ids(tids)
            or not tids):
        fail("cold tier checkpoint: trace reads differ after the load")
    result = {"capacity": cfg.capacity,
              "spans": int(a.hot._wp), "segments": len(want),
              "segment_bytes": sum(len(s[3]) for s in want),
              "save_s": save_s, "load_s": load_s,
              "snapshot_bytes_on_disk": save["bytes_on_disk"],
              "traces_read": len(tids)}
    log("cold tier parity result: " + json.dumps(result))
    for t in stores + [got]:
        t.close()
    return result


# (point, hit, batches, checkpoint after these batches, segment bytes,
#  applied, acked, tiered): the cases of tests/test_crash.py; mid-seal
#  kills a tiered drive (2^8 ring, capture on its path) between a
#  capture pull and the segment append.
KILL_CASES = (
    ("before-append", 5, 8, (3,), 64 << 20, 4, 4, False),
    ("after-append", 4, 6, (2,), 64 << 20, 4, 3, False),
    ("after-commit", 5, 8, (3,), 64 << 20, 5, 4, False),
    ("mid-checkpoint", 2, 10, (4, 8), 64 << 20, 8, 8, False),
    ("mid-truncate", 2, 8, (6,), 1 << 12, 6, 6, False),
    ("mid-seal", 2, 30, (), 64 << 20, 21, 20, True),
    ("mid-seal", 3, 30, (10,), 64 << 20, 30, 29, True),
)


def crash_kill_points(torch, device):
    """The crash child on the card, SIGKILLed at each kill point; each
    recovery on the card must keep the acked batches, equal an
    uncrashed drive of the recovered prefix (integer leaves bitwise, the
    moments within the stated tolerance) and leave the first unapplied
    batch absent. The children run at the same time (each is a fresh
    process that spends most of its ~10 s reaching the card); the
    recoveries run one after another."""
    from concurrent.futures import ThreadPoolExecutor

    from zipkin_tpu_torch.testing.crash import run_crash_child, \
        verify_recovery

    def child(case):
        point, hit, batches, ckpt_at, seg, _, _, tiered = case
        t = time.perf_counter()
        proc = run_crash_child(case_dirs[case], point=point, hit=hit,
                               batches=batches, ckpt_at=ckpt_at,
                               segment_bytes=seg, tiered=tiered,
                               device=device.type, timeout=300)
        return proc, time.perf_counter() - t

    case_dirs = {case: tempfile.mkdtemp(prefix=f"zipkin-crash-{case[0]}-")
                 for case in KILL_CASES}
    out = {}
    try:
        with ThreadPoolExecutor(max_workers=len(KILL_CASES)) as pool:
            runs = list(pool.map(child, KILL_CASES))
        for case, (proc, child_s) in zip(KILL_CASES, runs):
            point, hit, batches, _, _, applied, acked, tiered = case
            if proc.returncode != -signal.SIGKILL:
                fail(f"crash child at {point}:{hit} exited "
                     f"{proc.returncode}, not by SIGKILL\n"
                     f"{proc.stderr[-2000:]}")
            t = time.perf_counter()
            info = verify_recovery(case_dirs[case], total_batches=batches,
                                   tiered=tiered, device=device.type)
            verify_s = time.perf_counter() - t
            if (info["applied"], info["acked"]) != (applied, acked):
                fail(f"kill point {point}: applied/acked "
                     f"{info['applied']}/{info['acked']}, expected "
                     f"{applied}/{acked}")
            out[f"{point}:{hit}"] = {
                "hit": hit, "batches": batches, "tiered": tiered,
                "applied": info["applied"], "acked": info["acked"],
                "replayed_records": info["replayed_records"],
                "child_s": child_s, "verify_s": verify_s}
    finally:
        for wd in case_dirs.values():
            shutil.rmtree(wd, ignore_errors=True)
    log("crash kill points result: " + json.dumps(out))
    return out


def hist_phase(torch, K, rec, n_sites: int = 7, alone=None):
    """K1 on a path's first step: the fused call of its ``n_sites``
    sites (seven; eight on the window path) against the twin, bitwise,
    and the sites ``alone`` (default: every site) through the one-site
    call, bitwise. Then the fused call's call ms, host us, device ms,
    twin ms, the ``index_put_`` yardstick (one call a site) and the
    bound; and the numbers of each site alone through the one-site
    call."""
    if len(rec.hist) != n_sites:
        fail(f"recorded {len(rec.hist)} flat_histogram sites, not "
             f"{n_sites}")

    def fresh():
        return [(c.clone(), i, w) for c, i, w in rec.hist]

    want = fresh()
    K.histogram_update_many_plain(want)
    got = fresh()
    K.histogram_update_many(got)
    err = max(_disagree(g[0], w[0]) for g, w in zip(got, want))
    if err:
        fail(f"fused flat_histogram disagrees (max err {err})")
    del got
    scratch = fresh()
    lib_sites = []
    touched = []
    for counts, idx, _ in scratch:
        flat, i64 = counts.view(-1), idx.long()
        ok = (i64 >= 0) & (i64 < flat.shape[0])
        lib_sites.append((flat, i64, torch.ones_like(idx)))
        touched.append(int(torch.unique(i64[ok]).numel()))

    def library():
        for flat, i64, ones in lib_sites:
            ok = (i64 >= 0) & (i64 < flat.shape[0])
            flat.index_put_((i64[ok],), ones[ok], accumulate=True)

    def host_us(fn, reps=50):
        sync(torch, scratch[0][0].device)
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t) * 1e6 / reps
        sync(torch, scratch[0][0].device)
        return host

    def bound(rows, cells):
        # 4 B of index a row (no weights), each touched cell read and
        # written once
        return (rows * 4 + cells * 8) / H100_BYTES_PER_S * 1e3

    fused = lambda: K.histogram_update_many(scratch)  # noqa: E731
    rows = [i.numel() for _, i, _ in scratch]
    row = {"sites": len(scratch), "rows": sum(rows),
           "cells": sum(c.numel() for c, _, _ in scratch),
           "touched": sum(touched), "ms": time_ms(torch, fused),
           "host_us": host_us(fused),
           "device_ms": device_ms(torch, fused, "hist_multi"),
           "plain_ms": time_ms(torch, lambda: K.histogram_update_many_plain(
               scratch)),
           "library_ms": time_ms(torch, library),
           "library": f"{n_sites} index_put_(accumulate=True) calls in a "
                      f"row",
           "bound_ms": bound(sum(rows), sum(touched)), "bound_by": "bytes",
           "max_abs_err": 0}
    site_rows = []
    for k, (counts, idx, _) in enumerate(rec.hist):
        if alone is not None and k not in alone:
            continue
        one = K.histogram_update(counts.clone(), idx)
        err = _disagree(one, want[k][0])
        if err:
            fail(f"flat_histogram site {k} alone disagrees (max err {err})")
        c = scratch[k][0]
        flat, i64, ones = lib_sites[k]
        call = lambda: K.histogram_update(c, idx)  # noqa: E731

        def lib_one():
            ok = (i64 >= 0) & (i64 < flat.shape[0])
            flat.index_put_((i64[ok],), ones[ok], accumulate=True)

        site_rows.append({
            "site": k, "cells": counts.numel(), "rows": idx.numel(),
            "touched": touched[k], "ms": time_ms(torch, call),
            "device_ms": device_ms(torch, call, "hist_multi"),
            "plain_ms": time_ms(torch, lambda: K.histogram_update_plain(
                c, idx)),
            "library_ms": time_ms(torch, lib_one),
            "bound_ms": bound(idx.numel(), touched[k]), "max_abs_err": err})
    for r in site_rows:
        log("flat_histogram site: " + json.dumps(r))
    if row["device_ms"] != "not measured" and alone is None:
        row["sites_ms_sum"] = sum(r["ms"] for r in site_rows)
        row["sites_device_ms_sum"] = sum(r["device_ms"] for r in site_rows)
    log("flat_histogram fused: " + json.dumps(row))
    return row, site_rows


# ``--hist-variants``: copies of csrc/flat_histogram.cu with one design
# constant changed each.
HIST_VARIANTS = {
    "one atomic a row (no warp aggregation)": {"kAggregate": "false"},
    "privatise at >= 8 x m rows a block": {"kPrivRatio": "8"},
    "privatise at >= 16 x m rows a block": {"kPrivRatio": "16"},
    "no privatisation": {"kPrivCells": "0"},
    "2 rows in flight a thread": {"kUnroll": "2"},
    "8 rows in flight a thread": {"kUnroll": "8"},
    "2 blocks an SM": {"kBlocksPerSm": "2"},
    "8 blocks an SM": {"kBlocksPerSm": "8"},
    "256 threads a block, 8 blocks an SM": {"kThreads": "256",
                                            "kBlocksPerSm": "8"},
}


def hist_variants(torch, K, rec):
    """The design check of K1: builds each of ``HIST_VARIANTS`` (and the
    source as it is) into a library of its own, holds each fused call on
    the first step's seven sites bitwise against the twin, and reads its
    cold device ms."""
    import ctypes
    import re

    src = (K.CSRC / "flat_histogram.cu").read_text()
    out = K.BUILD_DIR / "hist_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, consts in {"as built": {}, **HIST_VARIANTS}.items():
        text = src
        for name, value in consts.items():
            text, n = re.subn(rf"(constexpr [\w ]+ {name} = )[^;]+;",
                              rf"\g<1>{value};", text)
            if n != 1:
                fail(f"hist variant {label}: no constant {name}")
        cu = out / f"v{len(procs)}.cu"
        cu.write_text(text)
        procs[label] = (cu.with_suffix(".so"), subprocess.Popen(
            K.nvcc_command(cu, cu.with_suffix(".so")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    want = [(c.clone(), i, w) for c, i, w in rec.hist]
    K.histogram_update_many_plain(want)
    rows = {}
    for label, (so, proc) in procs.items():
        build_log, _ = proc.communicate()
        if proc.returncode:
            fail(f"hist variant {label} did not build:\n{build_log}")
        fn = ctypes.CDLL(str(so)).zt_flat_histogram_multi
        fn.argtypes = K._ARGTYPES["zt_flat_histogram_multi"]
        got = [(c.clone(), i, w) for c, i, w in rec.hist]
        stream = K._stream(got[0][0].device)

        def call(sites):
            if fn(K.hist_table(sites)[0], len(sites), stream):
                fail(f"hist variant {label} did not launch")

        call(got)
        if max(_disagree(g[0], w[0]) for g, w in zip(got, want)):
            fail(f"hist variant {label} disagrees")
        rows[label] = device_ms(torch, lambda: call(got), "hist_multi",
                                reps=20)
        log(f"flat_histogram variant {label}: device_ms {rows[label]}")
    return rows


def _disagree(got, want) -> int:
    """Max abs difference of two integer tensors (0 when equal)."""
    if got.equal(want):
        return 0
    return int((got.long() - want.long()).abs().max())


def arena_phase(torch, K, rec):
    """K2: the claim (rank and cnt), the write and the whole function
    against their twins, bitwise, on the ring path's first step and on
    four variants of its rows (an in-batch overflow, a power-of-two
    bucket count, no valid row, one bucket spanning several 4096-row
    blocks of the claim); then call ms, device ms, plain ms, bound and
    yardstick of each half and of the whole, at the step's shape."""
    if rec.claim is None or rec.write is None:
        fail("no arena_claim / arena_write call was recorded")
    bucket, valid, n_b = rec.claim
    entries, wargs = rec.write
    _, _, wbucket, base, slot0, depth, vals, wvalid = wargs
    if not (wbucket.equal(bucket) and wvalid.equal(valid)):
        fail("the step's claim and write saw different rows")
    n = bucket.numel()
    d0 = int(depth[0])

    def bucket0(k):
        # k rows of global bucket 0 (the service family's first bucket:
        # slot0 0, its depth) ahead of the step's rows; one cursor a
        # bucket, so every row of bucket 0 carries the same base.
        ob, obase, oslot0, odepth, ovalid = (
            bucket.clone(), base.clone(), slot0.clone(), depth.clone(),
            valid.clone())
        ob[:k], oslot0[:k], odepth[:k], ovalid[:k] = 0, 0, d0, True
        obase[ob == 0] = 12345
        return ob, obase, oslot0, odepth, vals, ovalid

    rows = (bucket, base, slot0, depth, vals, valid)
    cases = [
        ("main-path step", rows, n_b),
        ("in-batch overflow", bucket0(min(n, 2 * d0 + 1)), n_b),
        ("n_buckets a power of two", rows, 1 << n_b.bit_length()),
        ("all rows invalid", rows[:5] + (torch.zeros_like(valid),), n_b),
        ("one bucket over several blocks",
         bucket0(min(n, 5 * 4096 + 123)), n_b),
    ]
    for label, (b, bs, s0, dp, vl, v), nb in cases:
        want_r, want_c = K.arena_claim_plain(b, v, nb)
        got_r, got_c = K.arena_claim(b, v, nb)
        err = max(_disagree(got_r, want_r), _disagree(got_c, want_c))
        if err:
            fail(f"arena_claim ({label}) disagrees (max err {err})")
        want = K.arena_write_plain(entries.clone(), want_r, want_c, b, bs,
                                   s0, dp, vl, v)
        got = K.arena_write(entries.clone(), got_r, got_c, b, bs, s0, dp,
                            vl, v)
        err = _disagree(got, want)
        if err:
            fail(f"arena_write ({label}) disagrees (max err {err})")
        del got, want
        want = K.arena_claim_scatter_plain(entries.clone(), b, bs, s0, dp,
                                           vl, v, nb)
        got = K.arena_claim_scatter(entries.clone(), b, bs, s0, dp, vl, v,
                                    n_buckets=nb)
        err = _disagree(got, want)
        if err:
            fail(f"arena_claim_scatter ({label}) disagrees (max err {err})")
        del got, want
        log(f"arena ({label}): claim, write and composite equal their "
            f"twins ({n} rows, {nb} buckets)")

    rank, cnt = K.arena_claim_plain(bucket, valid, n_b)
    wrow = (rank, cnt, bucket, base, slot0, depth, vals, valid)
    scratch = entries.clone()
    bl = bucket.long()
    keep = valid & (rank >= cnt[bl] - depth)
    survivors = int(keep.sum())
    s_keep = slot0[keep] + ((base[keep] + rank[keep]) % depth[keep]).long()
    v_keep = vals[keep]
    key = torch.where(valid, bucket, torch.full_like(bucket, n_b))

    def unique_scatter():
        scratch[s_keep] = v_keep

    claim_peak = "not measured"
    if bucket.is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        K.arena_claim(bucket, valid, n_b)
        torch.cuda.synchronize()
        claim_peak = torch.cuda.max_memory_allocated() - before

    def bound(nbytes):
        return nbytes / H100_BYTES_PER_S * 1e3

    row_in = 4 + 4 + 8 + 4 + 1 + 24  # bucket, base, slot0, depth, valid, vals
    halves = {
        "arena_claim": {
            "ms": time_ms(torch, lambda: K.arena_claim(bucket, valid, n_b)),
            "device_ms": device_ms(torch, lambda: K.arena_claim(
                bucket, valid, n_b), ("arena_claim", "Memset")),
            "plain_ms": time_ms(torch, lambda: K.arena_claim_plain(
                bucket, valid, n_b), reps=5),
            "library_ms": time_ms(torch, lambda: torch.sort(key,
                                                            stable=True)),
            "library": "torch.sort(key, stable=True), int32 keys",
            # bucket and valid in, rank and the counts out
            "bound_ms": bound(n * (4 + 1 + 4) + n_b * 4),
            "bound_by": "bytes", "peak_bytes": claim_peak},
        "arena_write": {
            "ms": time_ms(torch, lambda: K.arena_write(scratch, *wrow)),
            "device_ms": device_ms(torch, lambda: K.arena_write(
                scratch, *wrow), "arena_write"),
            "plain_ms": time_ms(torch, lambda: K.arena_write_plain(
                scratch, *wrow), reps=5),
            "library_ms": time_ms(torch, unique_scatter, reps=5),
            "library": "index_put of the precomputed survivors",
            # the rows and rank in, the counts, the survivors out
            "bound_ms": bound(n * (row_in + 4) + n_b * 4 + survivors * 24),
            "bound_by": "bytes"},
    }
    whole = {
        "ms": time_ms(torch, lambda: K.arena_claim_scatter(
            scratch, *rows, n_buckets=n_b), reps=5),
        "device_ms": device_ms(torch, lambda: K.arena_claim_scatter(
            scratch, *rows, n_buckets=n_b), ("arena_", "Memset"), reps=5),
        "plain_ms": time_ms(torch, lambda: K.arena_claim_scatter_plain(
            scratch, *rows, n_b), reps=5),
        "bound_ms": bound(n * row_in + survivors * 24),
        "bound_by": "bytes", "library_ms": None,
    }
    row = {"arena_rows": entries.shape[0], "rows": n, "buckets": n_b,
           "survivors": survivors, "cases": [c[0] for c in cases],
           "halves": halves, **whole, "max_abs_err": 0}
    log("arena_claim_scatter: " + json.dumps(row))
    return row


def gather_phase(torch, K, rec):
    """K3 against its twin on the paged reads' largest page list and on
    that list with hole pages (front, middle, past the last page, end);
    times the call (column table cached, and rebuilt every call), the
    kernel alone, the twin and ``torch.index_select`` on a pre-stacked
    [14, capacity] int64 matrix (the stack itself not timed)."""
    if rec.gather is None:
        fail("no paged_page_gather call was recorded")
    cols, pages, R = rec.gather
    n_pages = cols[0].numel() // R
    mid = pages.numel() // 2
    hole = torch.tensor([-1], dtype=torch.int32, device=pages.device)
    past = torch.tensor([n_pages], dtype=torch.int32, device=pages.device)
    holed = torch.cat([hole, pages[:mid], hole, past, pages[mid:], hole])
    for label, pg in (("main-path read", pages), ("hole pages", holed)):
        want = K.paged_page_gather_plain(cols, pg, R)
        got = K.paged_page_gather(cols, pg, R)
        if not torch.equal(got, want):
            err = int((got - want).abs().max())
            fail(f"paged_page_gather ({label}) disagrees (max err {err})")
    ms = time_ms(torch, lambda: K.paged_page_gather(cols, pages, R),
                 reps=20)

    def uncached():
        K._GATHER_TABLES.clear()
        return K.paged_page_gather(cols, pages, R)

    uncached_ms = time_ms(torch, uncached, reps=20)
    plain = time_ms(torch, lambda: K.paged_page_gather_plain(cols, pages,
                                                             R), reps=20)
    dev_ms = device_ms(torch, lambda: K.paged_page_gather(cols, pages, R),
                       "page_gather", reps=20)
    mat = torch.stack([c.to(torch.int64) for c in cols])
    slots = (torch.clamp(pages.long(), 0, n_pages - 1)[:, None] * R
             + torch.arange(R, device=pages.device)[None, :]).reshape(-1)
    lib = time_ms(torch, lambda: torch.index_select(mat, 1, slots),
                  reps=20)
    del mat
    k = pages.numel()
    k_real = int(((pages >= 0) & (pages < n_pages)).sum())
    read_b = k_real * R * sum(c.element_size() for c in cols)
    write_b = k * R * len(cols) * 8
    row = {"pages": k, "live_pages": k_real, "page_rows": R,
           "columns": len(cols), "capacity": cols[0].numel(),
           "cases": ["main-path read", "hole pages"], "ms": ms,
           "uncached_ms": uncached_ms, "device_ms": dev_ms,
           "plain_ms": plain, "library_ms": lib,
           "bound_ms": (read_b + write_b) / H100_BYTES_PER_S * 1e3,
           "bytes": read_b + write_b, "max_abs_err": 0}
    log("paged_page_gather: " + json.dumps(row))
    return row


def _check_states_equal(a, b, what):
    float_leaves = ("dep_window", "dep_moments", "dep_banks")
    for k, ref in a.items():
        got = b[k]
        if k == "counters":
            if {c: int(v) for c, v in ref.items()} != {
                    c: int(v) for c, v in got.items()}:
                fail(f"{what}: counters differ")
        elif k in float_leaves:
            ref64, got64 = ref.astype(np.float64), got.astype(np.float64)
            scale_ = np.abs(ref64).reshape(-1, ref64.shape[-1]).max(0)
            if not (np.array_equal(ref64[..., 0], got64[..., 0])
                    and np.all(np.abs(ref64 - got64)
                               <= 1e-5 * (np.abs(ref64) + scale_))):
                fail(f"{what}: {k} differs beyond float32 tolerance")
        elif not np.array_equal(ref, got):
            fail(f"{what}: {k} differs in {int((ref != got).sum())} cells")


def parity_phase(torch, dev, scale, rehearse: bool, paged: bool):
    """The same stream at reduced depth, with the windowed arena on
    (three buckets a batch: the slot ring laps), on the card (kernels)
    and on the CPU (plain twins): equal states, equal sketch mirrors
    (each equal to its device leaves) and, paged, equal planner
    snapshots. Then the same spans through ``apply``: pipelined on the
    card against serial on the CPU. A rehearsal runs the card's side on
    the CPU too."""
    from zipkin_tpu_torch.store.convert import state_to_numpy
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    what = "paged parity" if paged else "parity"
    cfg = full_config(dev, scale.small_log2, scale.services, **WINDOW,
                      **(paged_layout(scale) if paged else {}))
    card = "cpu" if rehearse else "cuda"
    states, snaps, mirrors = [], [], []
    for device in (card, "cpu"):
        store = TorchSpanStore(cfg, device=device)
        gen = ColumnarTraceGen(store.dicts, n_services=scale.services,
                               n_span_names=scale.names, topology=True,
                               seed=3)
        mark = error_marker(store.dicts)
        for i in range(scale.small_batches):
            batch, _, ix = gen.next_batch(
                scale.small_traces, base_ts=WIN_BASE_US + i * PARITY_STEP_US)
            mark(batch)
            store.write_batch(batch, ix)
        store.get_dependencies()
        mirror_equals_device(store, f"{what} ({device})")
        states.append(state_to_numpy(store.state))
        mirrors.append(store.sketch_mirror.arrays())
        if paged:
            snaps.append(store._planner.snapshot())
    _check_states_equal(*states, what)
    for a, b in zip(*mirrors):
        if not np.array_equal(a, b):
            fail(f"{what}: the cuda and cpu mirrors differ")
    if paged and snaps[0] != snaps[1]:
        fail(f"{what}: planner snapshots differ")
    epoch = mirrors[0][6]
    if epoch.max() - WIN_BASE_US // WIN_US < cfg.win_slots:
        fail(f"{what}: the window buckets did not outrun the slot ring")
    wp = int(states[0]["write_pos"])
    extra = (f", {snaps[0]['reclaims_total']} page reclaims, planner "
             f"snapshots equal" if paged else "")
    log(f"{what}: cuda and cpu states and mirrors equal after {wp} spans "
        f"(capacity {cfg.capacity}, {wp // cfg.capacity} laps, window "
        f"buckets {int(epoch[epoch >= 0].min())}..{int(epoch.max())}{extra})")
    applies = span_applies(scale, scale.small_batches // 4,
                           4 * scale.small_traces, 4 * PARITY_STEP_US,
                           seed=6)
    piped = TorchSpanStore(cfg, device=card)
    with piped.pipelined(depth=4):
        for spans in applies:
            piped.apply(spans)
    serial = TorchSpanStore(cfg, device="cpu")
    for spans in applies:
        serial.apply(spans)
    _check_states_equal(state_to_numpy(serial.state),
                        state_to_numpy(piped.state), f"{what} (pipelined)")
    for a, b in zip(serial.sketch_mirror.arrays(),
                    piped.sketch_mirror.arrays()):
        if not np.array_equal(a, b):
            fail(f"{what}: the pipelined mirror differs")
    n = int(serial.counter_block()["spans_seen"])
    log(f"{what}: pipelined {card} and serial cpu states and mirrors "
        f"equal after {n} spans in {len(applies)} apply calls")
    return wp


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny CPU run of the same flow; prints no result")
    ap.add_argument("--hist-variants", action="store_true",
                    help="also build and time design variants of the flat "
                         "histogram kernel on the first step's sites")
    ap.add_argument("--profile", type=int, default=3, metavar="N",
                    help="profile N more launches of the ring stream "
                         "(torch.profiler): kernel time and idle share; "
                         "0 skips it")
    args = ap.parse_args()
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from zipkin_tpu_torch.ops import kernels as K
        from zipkin_tpu_torch.store import device as dev
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    scale = Scale(args.rehearse, 0 if args.rehearse else args.profile)
    device = torch.device("cpu" if args.rehearse else "cuda")
    smi = "not measured"
    if not args.rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")
        build_s = K.build_all()
        log(f"kernel build: {build_s:.2f} s")
        for name, out in K.BUILD_LOG.items():
            for line in out.splitlines():
                if "registers" in line or "error" in line.lower():
                    log(f"  nvcc {name}: {line.strip()}")
    phase_s = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    rec, result = phase("ring_path", main_path, torch, K, dev, scale,
                        device)
    hist, hist_rows = phase("flat_histogram", hist_phase, torch, K, rec)
    if args.hist_variants and not args.rehearse:
        phase("flat_histogram_variants", hist_variants, torch, K, rec)
    arena = phase("arena_claim_scatter", arena_phase, torch, K, rec)
    del rec
    prec, presult = phase("paged_path", paged_path, torch, K, dev, scale,
                          device)
    gather = phase("paged_page_gather", gather_phase, torch, K, prec)
    del prec
    wrec, wresult = phase("window_path", window_path, torch, K, dev, scale,
                          device, result)
    hist8, hist8_rows = phase("flat_histogram_window", hist_phase, torch, K,
                              wrec, 8, (7,))
    del wrec
    cold = phase("cold_tier_path", cold_tier_path, torch, K, dev, scale,
                 device, wresult)
    cpaged = phase("cold_tier_paged", cold_tier_paged, torch, K, dev, scale,
                   device)
    phase("cold_tier_parity", cold_tier_parity, torch, dev, scale,
          args.rehearse)
    piped = phase("pipeline_path", pipeline_path, torch, K, dev, scale,
                  device)
    phase("parity", parity_phase, torch, dev, scale, args.rehearse, False)
    phase("paged_parity", parity_phase, torch, dev, scale, args.rehearse,
          True)
    durable = phase("durability_path", durability_path, torch, K, dev,
                    scale, device)
    dpaged = phase("durability_paged", durability_paged, torch, K, dev,
                   scale, device)
    phase("crash_kill_points", crash_kill_points, torch, device)
    big = max(hist_rows, key=lambda r: r["cells"])
    by_path = {"ring": result["kernel_launches"],
               "paged": presult["kernel_launches"],
               "window": wresult["kernel_launches"],
               "pipeline": piped["kernel_launches"],
               "durability": durable["kernel_launches"],
               "durability_paged": dpaged["read_launches"],
               "cold_tier": cold["kernel_launches"],
               "cold_tier_paged": {k: cpaged["kernel_launches"][k]
                                   + cpaged["read_launches"][k]
                                   for k in cpaged["kernel_launches"]}}
    steps_by_path = {"ring": result["ingest_steps"],
                     "paged": presult["ingest_steps"],
                     "window": wresult["ingest_steps"],
                     "pipeline": piped["ingest_steps"],
                     "durability": durable["ingest_steps"],
                     "durability_paged": 0,
                     "cold_tier": cold["ingest_steps"],
                     "cold_tier_paged": cpaged["ingest_steps"]}
    kernels = [
        {"name": "flat_histogram", "route": "cuda",
         "source": "zipkin_tpu_torch/csrc/flat_histogram.cu",
         "replaces": "zipkin_tpu/ops/pallas_kernels.py:105",
         "launches": result["kernel_launches"]["flat_histogram"],
         "launches_by_path": {p: v["flat_histogram"]
                              for p, v in by_path.items()},
         "steps_by_path": steps_by_path,
         "max_abs_err": max([hist["max_abs_err"], hist8["max_abs_err"]]
                            + [r["max_abs_err"]
                               for r in hist_rows + hist8_rows]),
         **{k: hist[k] for k in (
             "ms", "host_us", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "library")},
         "shape": {k: hist[k] for k in ("sites", "rows", "cells")},
         "largest_site": {k: big[k] for k in (
             "cells", "rows", "ms", "device_ms", "plain_ms", "bound_ms",
             "library_ms")},
         "window_path": {
             **{k: hist8[k] for k in (
                 "sites", "rows", "cells", "touched", "ms", "host_us",
                 "device_ms", "plain_ms", "bound_ms", "library_ms")},
             "eighth_site": {k: hist8_rows[0][k] for k in (
                 "cells", "rows", "touched", "ms", "device_ms", "plain_ms",
                 "bound_ms", "library_ms")}}},
        {"name": "arena_claim_scatter", "route": "cuda",
         "source": "zipkin_tpu_torch/csrc/arena_claim_scatter.cu",
         "replaces": "zipkin_tpu/ops/pallas_kernels.py:247",
         "launches": result["kernel_launches"]["arena_claim"],
         "launches_by_path": {p: {h: v[h] for h in arena["halves"]}
                              for p, v in by_path.items()},
         "max_abs_err": arena["max_abs_err"], "ms": arena["ms"],
         "device_ms": arena["device_ms"],
         "plain_ms": arena["plain_ms"],
         "bound_ms": arena["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "halves": {h: {**v, "launches": result["kernel_launches"][h]}
                    for h, v in arena["halves"].items()},
         "shape": {"arena_rows": arena["arena_rows"],
                   "rows": arena["rows"], "buckets": arena["buckets"]}},
        {"name": "paged_page_gather", "route": "cuda",
         "source": "zipkin_tpu_torch/csrc/paged_page_gather.cu",
         "replaces": "zipkin_tpu/ops/pallas_kernels.py:357",
         "launches": presult["kernel_launches"]["paged_page_gather"],
         "launches_by_path": {p: v["paged_page_gather"]
                              for p, v in by_path.items()},
         "max_abs_err": gather["max_abs_err"], "ms": gather["ms"],
         "uncached_ms": gather["uncached_ms"],
         "device_ms": gather["device_ms"],
         "plain_ms": gather["plain_ms"],
         "bound_ms": gather["bound_ms"], "bound_by": "bytes",
         "library_ms": gather["library_ms"],
         "shape": {"pages": gather["pages"],
                   "page_rows": gather["page_rows"],
                   "columns": gather["columns"]}},
    ]
    log("phases: " + json.dumps(phase_s))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    if args.rehearse:
        log("rehearsal ok: " + json.dumps({"kernels": kernels}))
        return 0
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
