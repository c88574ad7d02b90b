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
   spans pipelined on the card against serial on the CPU.

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
import subprocess
import sys
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
            # Paged: 32 pages (a smaller pool cannot hold the known set),
            # a chain bound of 3 pages so a 400-span trace overflows it.
            self.paged_cap_log2, self.paged_launches = 12, 20
            self.page_max_chain, self.n_big = 3, 6
            self.big_min, self.big_max, self.overflow_spans = 64, 200, 400
        else:
            self.cap_log2, self.services, self.names = 22, 1000, 2048
            self.batch_traces = 16384  # 114,688 spans a launch
            self.stream_spans = (5 * (1 << 22)) // 4
            self.known, self.small_log2, self.small_batches = 2000, 14, 24
            self.small_traces = 512
            # 46 launches two buckets apart: 92 buckets > 64 slots.
            self.window_launches = 46
            # 12 apply calls of 28,672 spans (the first untimed).
            self.pipe_applies, self.pipe_traces = 12, 4096
            # 39 launches = 4,472,832 spans > 2^22: the pool runs out.
            self.paged_cap_log2, self.paged_launches = 22, 39
            self.page_max_chain, self.n_big = 64, 32
            self.big_min, self.big_max = 200, 4000
            self.overflow_spans = 20000  # > 64 pages x 128 rows


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
    piped = phase("pipeline_path", pipeline_path, torch, K, dev, scale,
                  device)
    phase("parity", parity_phase, torch, dev, scale, args.rehearse, False)
    phase("paged_parity", parity_phase, torch, dev, scale, args.rehearse,
          True)
    big = max(hist_rows, key=lambda r: r["cells"])
    by_path = {"ring": result["kernel_launches"],
               "paged": presult["kernel_launches"],
               "window": wresult["kernel_launches"],
               "pipeline": piped["kernel_launches"]}
    steps_by_path = {"ring": result["ingest_steps"],
                     "paged": presult["ingest_steps"],
                     "window": wresult["ingest_steps"],
                     "pipeline": piped["ingest_steps"]}
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
