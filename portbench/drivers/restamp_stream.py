"""The device-resident stream: one writer commits a template, restamped
on the card each step, through the port store's own commit path.

A mix of this kind (``"driver": "restamp_stream"``) gives:

- ``templates``: a list of ``{"traces": n}``, each a template made once
  from ``--seed`` (the columnar generator's draws, ``lib/gen.py``) and
  uploaded, padded to powers of two;
- ``setup``: the template of each set-up step, in order;
- ``window_template``: the template the window commits back to back.

Every step restamps its template on the card (ids XOR a splitmix64 salt
of (seed, step), timestamps + 60 s a step) and commits it through
``TorchSpanStore._commit_unit`` (the commit behind ``write_batch`` and
the pipeline: eviction capture, the bucket close every half ring, the
fused step, the host clocks and the sweep cadence) as a unit whose batch
is already on the device. No read needs the sketch mirror in the window:
it is marked cold after each commit and resyncs from the device on the
first read after it.

``check`` holds the store after the window against ``lib/reference.py``
fed the same steps; ``control`` is that reference one precision down in
the program's place.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from portbench.lib import gen, judge
from portbench.lib.cell import Spans, Window
from portbench.lib.reference import Reference

ROW_SAMPLE = 2048
NEWEST_ROWS = 64
SEARCHES = {"by_service": 32, "by_name": 32, "by_annotation": 16,
            "by_binary": 16}
SEARCH_LIMIT = 10


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def make_templates(config: Dict, mix: Dict, seed: int) -> List[gen.Template]:
    g = config["generator"]
    out, first = [], 1
    for i, spec in enumerate(mix["templates"]):
        out.append(gen.make_template(
            spec["traces"], g["n_services"], g["n_span_names"],
            g["spans_per_trace"], seed=gen.splitmix64(seed) + i,
            first_trace=first))
        first += spec["traces"]
    return out


def build(config: Dict, mix: Dict, seed: int, device) -> "RestampStream":
    return RestampStream(config, mix, seed, device)


class RestampStream:
    """One store, its templates on the device, and the steps committed
    so far (``order``: the template index of each step;
    ``window_steps``: the indices of the window's steps)."""

    def __init__(self, config: Dict, mix: Dict, seed: int, device):
        import torch
        from zipkin_tpu_torch.columnar.schema import SpanBatch
        from zipkin_tpu_torch.store import device as dev
        from zipkin_tpu_torch.store.pipeline import IngestUnit
        from zipkin_tpu_torch.store.torch_store import TorchSpanStore

        self.torch, self._unit = torch, IngestUnit
        self.device = torch.device(device)
        self.seed, self.config, self.mix = seed, config, mix
        self.store = TorchSpanStore(dev.StoreConfig(**config["store"]),
                                    device=self.device)
        g = config["generator"]
        self.names = gen.names_of(g["n_services"], g["n_span_names"])
        self._intern()
        self.templates = make_templates(config, mix, seed)
        self.dbs = []
        for t in self.templates:
            batch = SpanBatch(**{k: v.copy() for k, v in t.cols.items()})
            db = dev.make_device_batch(
                batch, name_lc_id=t.cols["name_id"],
                indexable=np.ones(t.n_spans, bool),
                pad_spans=_next_pow2(t.n_spans),
                pad_anns=_next_pow2(t.n_anns),
                pad_banns=_next_pow2(t.n_banns))
            self.dbs.append(dev.batch_to_device(db, self.device))
        self.order: List[int] = []
        self.window_steps: List[int] = []
        self.spans = Spans(on=False)

    def _intern(self) -> None:
        """Intern the stream's names in the store's dictionaries and check
        that they get the ids the template carries."""
        d, n = self.store.dicts, self.names
        got = ([d.services.encode(s) for s in n.services]
               + [d.span_names.encode(s) for s in n.span_names]
               + [d.endpoints.encode(e) for e in n.endpoints])
        want = (list(range(len(n.services))) + list(range(len(n.span_names)))
                + list(range(len(n.endpoints))))
        for kind, table in (("annotations", n.annotations),
                            ("binary_keys", n.binary_keys),
                            ("binary_values", n.binary_values)):
            for value, vid in table.items():
                got.append(getattr(d, kind).encode(value))
                want.append(vid)
        if got != want:
            raise RuntimeError("the store's dictionaries assigned other ids "
                               "than the stream's")

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def commit(self, t: int) -> None:
        """Restamp template ``t`` as the next step and commit it."""
        k = len(self.order)
        tm = self.templates[t]
        t0 = time.time_ns()
        db = gen.restamp_device(self.dbs[t], gen.step_salt(self.seed, k),
                                gen.step_delta(k))
        unit = self._unit(None, tm.n_spans, tm.n_anns, tm.n_banns, 1, False,
                          staged=((db,), None, None))
        t1 = time.time_ns()
        store = self.store
        with store._lock:
            store._commit_unit(unit)
        store.sketch_mirror.mark_cold()
        self.order.append(t)
        t2 = time.time_ns()
        self.spans.add("restamp", t0, t1)
        self.spans.add("commit", t1, t2)

    def warm(self) -> None:
        """Set-up: commit the mix's set-up steps, then close a dependency
        bucket (which sweeps first), so that every shape and path the
        window takes has run once."""
        for t in self.mix["setup"]:
            self.commit(t)
        self.store.archive_now()
        self.sync()

    def window(self, seconds: float) -> Window:
        """Commit the window's template back to back for ``seconds``,
        synchronised at the end."""
        t = self.mix["window_template"]
        self.sync()
        n0 = len(self.order)
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            self.commit(t)
        self.sync()
        w1 = time.perf_counter()
        self.window_steps = list(range(n0, len(self.order)))
        spans = len(self.window_steps) * self.templates[t].n_spans
        return Window({"ingest_spans_per_s": spans / (w1 - w0)},
                      attempted=len(self.window_steps), failed=0)

    def check(self, limits: Dict, seed: int, device) -> Dict[str, float]:
        """The store's outputs against the reference: reads what the
        program holds, frees the program's state, then runs the
        reference on ``device``."""
        torch = self.torch
        rng = np.random.default_rng([gen.splitmix64(seed), 7])
        n = len(self.order)
        steps = gen.plan_steps(self.templates, self.order)
        st = self.config["store"]
        slots = sample_slots(rng, st, self.templates, steps)
        queries = searches(rng, self.templates, self.order,
                           self.config["generator"]["n_services"])
        got = judge.program_state(self.store, slots)
        got_links = judge.program_links(self.store)
        got_search = judge.program_searches(self.store, self.names, queries)
        self.store.close()
        self.store.state = None
        self.dbs = None
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        ref = Reference(st, self.templates, steps, seed, device=device)
        return compare(ref, n, slots, queries, got, got_links, got_search,
                       bool(st.get("window_seconds")))


def _ring_sample(rng, cap: int, total: int) -> np.ndarray:
    newest = (total - 1 - np.arange(min(NEWEST_ROWS, max(total, 0)))) % cap
    return np.unique(np.concatenate([rng.integers(0, cap, ROW_SAMPLE),
                                     newest]))


def sample_slots(rng, st: Dict, templates, steps) -> Dict[str, np.ndarray]:
    """Ring slots to compare, drawn from ``rng``: a sample of each ring
    and its newest rows."""
    last = steps[-1]
    tl = templates[last.tmpl]
    return {"span": _ring_sample(rng, st["capacity"], last.gid0 + tl.n_spans),
            "ann": _ring_sample(rng, st["ann_capacity"],
                                last.agid0 + tl.n_anns),
            "bann": _ring_sample(rng, st["bann_capacity"],
                                 last.bgid0 + tl.n_banns)}


def searches(rng, templates, order, n_services: int) -> List[tuple]:
    """Trace-id searches to ask of the store after the window, drawn from
    ``rng``: (kind, service, span name or None, limit)."""
    col = templates[order[-1]].cols
    out = []
    for kind, n in SEARCHES.items():
        for _ in range(n):
            if kind == "by_name":
                r = int(rng.integers(len(col["service_id"])))
                out.append((kind, int(col["service_id"][r]),
                            int(col["name_id"][r]), SEARCH_LIMIT))
            else:
                out.append((kind, int(rng.integers(n_services)), None,
                            SEARCH_LIMIT))
    return out


def compare(ref: Reference, n: int, slots, queries, got, got_links,
            got_search, window: bool) -> Dict[str, float]:
    """Each compared number of a store (or of what stands in its place)
    after ``n`` steps against the reference ``ref``."""
    want = judge.reference_state(ref, n, slots, window)
    numbers = judge.compare_state(got, want, window)
    numbers["index_off"] = sum(
        0 if judge.search_ok(g, ref.trace_hits(
            n, q[1], q[2] if q[0] == "by_name" else None), q[3]) else 1
        for g, q in zip(got_search, queries))
    numbers["dep_count_off"], numbers["dep_gap"] = judge.compare_links(
        got_links, ref.links(n))
    return numbers


def control(config: Dict, mix: Dict, seed: int, window_steps: int,
            device) -> Dict[str, float]:
    """The numbers the check compares, with the reference one precision
    down (``Reference(precision="low")``) in the program's place, after
    the set-up and ``window_steps`` window steps."""
    st = config["store"]
    templates = make_templates(config, mix, seed)
    order = list(mix["setup"]) + [mix["window_template"]] * window_steps
    steps = gen.plan_steps(templates, order)
    n = len(steps)
    exact = Reference(st, templates, steps, seed, device=device)
    low = Reference(st, templates, steps, seed, device=device,
                    precision="low")
    rng = np.random.default_rng([gen.splitmix64(seed), 7])
    slots = sample_slots(rng, st, templates, steps)
    queries = searches(rng, templates, order,
                       config["generator"]["n_services"])
    window = bool(st.get("window_seconds"))
    got = judge.reference_state(low, n, slots, window)
    return compare(exact, n, slots, queries, got, low.links(n),
                   judge.reference_searches(low, n, queries), window)
