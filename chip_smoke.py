"""Chip smoke test of the PyTorch/CUDA port (``zipkin_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the two CUDA kernels from ``zipkin_tpu_torch/csrc`` (one nvcc
per source, started together), then

1. drives the store's main path at full width: a ``TorchSpanStore`` at
   the 1k-service / 2^22-span-ring configuration with the kernels on
   streams >= 1.25 x 2^22 generated spans through ``write_batch`` (the
   span ring wraps, index buckets displace entries), applies ~2000
   known traces and queries them with known answers; both kernels'
   launch counters, zeroed just before the drive, must have advanced;
2. holds each kernel against its plain PyTorch twin, bitwise, on the
   inputs the main path's first step gave it (recorded during the
   drive), plus an in-batch bucket overflow for the arena kernel, and
   times kernel, twin and a one-call PyTorch yardstick;
3. runs the same stream at capacity 2^14 (same widths) on the card and
   on the CPU (plain twins) and requires equal states.

It fails on any phase failure and catches none. The line before the
last is the kernels JSON; the last line is the device JSON. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result. ``--rehearse`` runs the same flow on the CPU at a
tiny size (kernel checks compare twin with twin) and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def full_config(dev, capacity_log2: int, n_services: int):
    """The reference bench's _tpu_config(capacity_log2, n_services,
    use_pallas=True): 1k services, 2048 span names, 4096 annotation
    values, 1024 binary keys, CMS 4x2^16, HLL p=14, 2048 quantile
    buckets; name index 2^16x256, key table 2^23 and 64 dependency
    banks at capacity >= 2^20."""
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
    )


class Scale:
    def __init__(self, rehearse: bool, profile_steps: int = 0):
        self.profile_steps = profile_steps
        if rehearse:
            self.cap_log2, self.services, self.names = 10, 40, 64
            self.batch_traces, self.stream_spans = 64, 4 * (1 << 10)
            self.known, self.small_log2, self.small_batches = 60, 9, 6
            self.small_traces = 16
        else:
            self.cap_log2, self.services, self.names = 22, 1000, 2048
            self.batch_traces = 16384  # 114,688 spans a launch
            self.stream_spans = (5 * (1 << 22)) // 4
            self.known, self.small_log2, self.small_batches = 2000, 14, 24
            self.small_traces = 512


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


class Recorder:
    """Wraps the kernels module's two wrappers to keep a copy of the
    inputs of the main path's first step (seven flat-histogram call
    sites, one arena write); the kernel then runs as usual and counts
    its launch."""

    def __init__(self, K):
        self.K = K
        self.hist, self.arena = [], []
        self._orig = (K.histogram_update, K.arena_claim_scatter)

        def hist(counts, idx, weights):
            if len(self.hist) < 7:
                self.hist.append((counts.clone(), idx.clone(),
                                  weights.clone()))
            return self._orig[0](counts, idx, weights)

        def arena(entries, *args, n_buckets):
            if not self.arena:
                self.arena.append((entries.clone(),
                                   tuple(a.clone() for a in args),
                                   n_buckets))
            return self._orig[1](entries, *args, n_buckets=n_buckets)

        K.histogram_update, K.arena_claim_scatter = hist, arena

    def restore(self):
        self.K.histogram_update, self.K.arena_claim_scatter = self._orig


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


def profile_steps(torch, store, gen, scale):
    """torch.profiler over a few more launches of the stream: device
    time by kernel name and the card's idle share over the window
    (1 - union of kernel intervals / wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [gen.next_batch(scale.batch_traces)
               for _ in range(scale.profile_steps)]
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
    log("profile: " + json.dumps(out))
    return out


def main_path(torch, K, dev, scale, device):
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen, generate_traces

    cfg = full_config(dev, scale.cap_log2, scale.services)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    store = TorchSpanStore(cfg, device=device.type)
    gen = ColumnarTraceGen(store.dicts, n_services=scale.services,
                           n_span_names=scale.names, topology=True, seed=1)
    rec = Recorder(K)
    K.reset_launches()
    t0 = time.perf_counter()
    written = 0
    step_s = []
    while written < scale.stream_spans:
        batch, _, indexable = gen.next_batch(scale.batch_traces)
        ts = time.perf_counter()
        store.write_batch(batch, indexable)
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        written += batch.n_spans
    stream_s = time.perf_counter() - t0
    profile = None
    if scale.profile_steps:
        profile = profile_steps(torch, store, gen, scale)
        written += scale.profile_steps * scale.batch_traces * 7
    rng = np.random.default_rng(2)
    traces = generate_traces(n_traces=scale.known, max_depth=3,
                             n_services=10, rng=rng,
                             base_ts=4_000_000_000_000)
    names = [f"svc-{i:04d}" for i in range(min(10, scale.services))]
    ops = [f"op-{i:04d}" for i in range(min(50, scale.names))]
    traces = [rename_services(t, names, ops) for t in traces]
    known = [s for t in traces for s in t]
    store.apply(known)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    rec.restore()
    cb = store.counter_block()
    log(f"main path: {written} spans streamed in {len(step_s)} launches, "
        f"{stream_s:.3f} s; ring laps {cb['ring_laps']}; launches "
        f"{launches}")
    for name, n in launches.items():
        if n <= 0 and device.type == "cuda":
            fail(f"kernel {name} was not launched on the main path")
    if cb["ring_laps"] < 1:
        fail("the span ring did not wrap")

    # -- known-answer queries -------------------------------------------
    lat = []

    def q(fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        lat.append((time.perf_counter() - t) * 1e3)
        return out

    by_tid = {}
    for s in known:
        by_tid.setdefault(s.trace_id, []).append(s)
    tids = list(by_tid)
    for i in range(0, len(tids), 250):
        chunk = tids[i:i + 250]
        got = q(store.get_spans_by_trace_ids, chunk)
        if len(got) != len(chunk):
            fail(f"{len(chunk) - len(got)} known traces missing")
        for tid, spans in zip(chunk, got):
            if sorted(map(repr, spans)) != sorted(map(repr, by_tid[tid])):
                fail(f"trace {tid} did not round-trip")
    known_set = set(tids)
    hosted = {}
    for s in known:
        for a in s.annotations:
            if a.host is not None:
                hosted.setdefault(a.host.service_name, set()).add(s.trace_id)
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
    counters = store.counters()
    mem = (torch.cuda.max_memory_allocated() if device.type == "cuda"
           else 0)
    steady = step_s[1:] or step_s
    result = {
        "spans_streamed": written, "launches": len(step_s),
        "batch_spans": scale.batch_traces * 7,
        "ingest_spans_per_s": written / stream_s,
        "ingest_spans_per_s_after_first": (
            sum(scale.batch_traces * 7 for _ in steady) / sum(steady)),
        "first_launch_s": step_s[0],
        "query_p50_ms": float(np.percentile(lat, 50)),
        "query_p99_ms": float(np.percentile(lat, 99)),
        "queries": len(lat), "index_hits": counters["index_hits"],
        "index_scan_fallbacks": counters["index_scan_fallbacks"],
        "max_memory_allocated_bytes": mem,
        "idle_share": (profile["idle_share"] if profile
                       else "not measured"),
        "kernel_launches": launches,
    }
    log("main path result: " + json.dumps(result))
    del store
    return rec, result


def hist_phase(torch, K, rec):
    if len(rec.hist) != 7:
        fail(f"recorded {len(rec.hist)} flat_histogram call sites, not 7")
    rows = []
    for i, (counts, idx, w) in enumerate(rec.hist):
        want = K.histogram_update_plain(counts.clone(), idx, w)
        got = K.histogram_update(counts.clone(), idx, w)
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            fail(f"flat_histogram call {i} disagrees (max err {err})")
        scratch = counts.clone()
        ms = time_ms(torch, lambda: K.histogram_update(scratch, idx, w))
        plain = time_ms(torch, lambda: K.histogram_update_plain(
            scratch, idx, w))
        flat = scratch.view(-1)
        i64 = idx.long()

        def library():
            ok = (i64 >= 0) & (i64 < flat.shape[0])
            flat.index_put_((i64[ok],), w[ok], accumulate=True)

        lib = time_ms(torch, library)
        ok = (i64 >= 0) & (i64 < flat.shape[0])
        touched = int(torch.unique(i64[ok]).numel())
        nbytes = idx.numel() * 8 + touched * 8
        rows.append({"site": i, "cells": counts.numel(),
                     "rows": idx.numel(), "touched": touched, "ms": ms,
                     "plain_ms": plain, "library_ms": lib,
                     "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
                     "max_abs_err": err})
    for r in rows:
        log("flat_histogram site: " + json.dumps(r))
    return rows


def arena_phase(torch, K, rec):
    if not rec.arena:
        fail("no arena_claim_scatter call was recorded")
    entries, args, n_b = rec.arena[0]
    bucket, base, slot0, depth, vals, valid = args
    out = []
    cases = [("main-path step", args)]
    # The same rows with an in-batch overflow: 2*depth+1 rows of global
    # bucket 0 (the service family's first bucket: slot0 0, its depth)
    # ahead of the step's rows.
    d0 = int(depth[0])
    k = 2 * d0 + 1
    ob, obase, oslot0, odepth = (bucket.clone(), base.clone(),
                                 slot0.clone(), depth.clone())
    ob[:k], oslot0[:k], odepth[:k] = 0, 0, d0
    # One cursor per bucket: every row of bucket 0 carries the same base.
    obase[ob == 0] = 12345
    ovalid = valid.clone()
    ovalid[:k] = True
    cases.append(("in-batch overflow", (ob, obase, oslot0, odepth, vals,
                                        ovalid)))
    for label, a in cases:
        want = K.arena_claim_scatter_plain(entries.clone(), *a, n_b)
        got = K.arena_claim_scatter(entries.clone(), *a, n_buckets=n_b)
        diff = (got != want)
        err = int((got[diff.any(1)] - want[diff.any(1)]).abs().max()) \
            if bool(diff.any()) else 0
        if err != 0:
            fail(f"arena_claim_scatter ({label}) disagrees: "
                 f"{int(diff.any(1).sum())} rows")
        out.append(label)
    scratch = entries.clone()
    ms = time_ms(torch, lambda: K.arena_claim_scatter(
        scratch, *args, n_buckets=n_b), reps=5)
    plain = time_ms(torch, lambda: K.arena_claim_scatter_plain(
        scratch, *args, n_b), reps=5)
    rank = K.fifo_ranks(bucket, valid, n_b)
    bl = bucket.long()
    cnt = torch.zeros(n_b + 1, dtype=torch.int32, device=bucket.device)
    cnt.index_add_(0, torch.where(valid, bl, torch.full_like(bl, n_b)),
                   torch.ones_like(rank))
    keep = valid & (rank >= cnt[bl] - depth)
    slot = slot0 + ((base + rank) % depth).long()
    s_keep, v_keep = slot[keep], vals[keep]

    def library():
        scratch[s_keep] = v_keep

    lib = time_ms(torch, library, reps=5)
    n = bucket.numel()
    survivors = int(keep.sum())
    nbytes = n * (5 * 4 + 24) + survivors * 24
    row = {"arena_rows": entries.shape[0], "rows": n, "buckets": n_b,
           "survivors": survivors, "cases": out, "ms": ms,
           "plain_ms": plain, "library_ms": lib,
           "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "max_abs_err": 0}
    log("arena_claim_scatter: " + json.dumps(row))
    return row


def parity_phase(torch, dev, scale):
    """The same stream at reduced depth on the card (kernels) and on
    the CPU (plain twins): equal states."""
    from zipkin_tpu_torch.store.convert import state_to_numpy
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    cfg = full_config(dev, scale.small_log2, scale.services)
    states = []
    for device in ("cuda", "cpu"):
        if device == "cuda" and not torch.cuda.is_available():
            device = "cpu"
        store = TorchSpanStore(cfg, device=device)
        gen = ColumnarTraceGen(store.dicts, n_services=scale.services,
                               n_span_names=scale.names, topology=True,
                               seed=3)
        for _ in range(scale.small_batches):
            batch, _, ix = gen.next_batch(scale.small_traces)
            store.write_batch(batch, ix)
        store.get_dependencies()
        states.append(state_to_numpy(store.state))
    a, b = states
    float_leaves = ("dep_window", "dep_moments", "dep_banks")
    for k, ref in a.items():
        got = b[k]
        if k == "counters":
            if {c: int(v) for c, v in ref.items()} != {
                    c: int(v) for c, v in got.items()}:
                fail("parity: counters differ")
        elif k in float_leaves:
            ref64, got64 = ref.astype(np.float64), got.astype(np.float64)
            scale_ = np.abs(ref64).reshape(-1, ref64.shape[-1]).max(0)
            if not (np.array_equal(ref64[..., 0], got64[..., 0])
                    and np.all(np.abs(ref64 - got64)
                               <= 1e-5 * (np.abs(ref64) + scale_))):
                fail(f"parity: {k} differs beyond float32 tolerance")
        elif not np.array_equal(ref, got):
            fail(f"parity: {k} differs in {int((ref != got).sum())} cells")
    wp = int(a["write_pos"])
    log(f"parity: cuda and cpu states equal after {wp} spans "
        f"(capacity {cfg.capacity}, {wp // cfg.capacity} ring laps)")
    return wp


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny CPU run of the same flow; prints no result")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="profile N more launches of the stream "
                         "(torch.profiler): kernel time and idle share")
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
    rec, result = main_path(torch, K, dev, scale, device)
    hist_rows = hist_phase(torch, K, rec)
    arena = arena_phase(torch, K, rec)
    del rec
    parity_phase(torch, dev, scale)
    big = max(hist_rows, key=lambda r: r["cells"])
    kernels = [
        {"name": "flat_histogram", "route": "cuda",
         "source": "zipkin_tpu_torch/csrc/flat_histogram.cu",
         "replaces": "zipkin_tpu/ops/pallas_kernels.py:105",
         "launches": result["kernel_launches"]["flat_histogram"],
         "max_abs_err": max(r["max_abs_err"] for r in hist_rows),
         "ms": big["ms"], "kernel_ms": big["ms"],
         "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
         "bound_by": "bytes", "library_ms": big["library_ms"],
         "shape": {"cells": big["cells"], "rows": big["rows"]}},
        {"name": "arena_claim_scatter", "route": "cuda",
         "source": "zipkin_tpu_torch/csrc/arena_claim_scatter.cu",
         "replaces": "zipkin_tpu/ops/pallas_kernels.py:247",
         "launches": result["kernel_launches"]["arena_claim_scatter"],
         "max_abs_err": arena["max_abs_err"], "ms": arena["ms"],
         "kernel_ms": arena["ms"], "plain_ms": arena["plain_ms"],
         "bound_ms": arena["bound_ms"], "bound_by": "bytes",
         "library_ms": arena["library_ms"],
         "shape": {"arena_rows": arena["arena_rows"],
                   "rows": arena["rows"]}},
    ]
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
