"""Trace generators: object-level (reference parity) and columnar (scale).

Reference: zipkin-tracegen/.../TraceGen.scala:50 — random span trees up
to depth 7, randomized rpc/service names, core annotation pairs with
realistic timing, custom ("some custom annotation") and binary
annotations. Re-expressed, not translated: the columnar generator plays
the role the reference never needed — feeding a device at line rate.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from zipkin_tpu_torch.columnar.dictionary import DictionarySet
from zipkin_tpu_torch.columnar.schema import (
    FLAG_HAS_PARENT,
    NO_TS,
    SpanBatch,
)
from zipkin_tpu_torch.models.span import (
    Annotation,
    AnnotationType,
    BinaryAnnotation,
    Endpoint,
    Span,
)

_WORDS = (
    "lorem", "ipsum", "dolor", "sit", "amet", "consectetur", "adipiscing",
    "elit", "vivamus", "posuere", "mauris", "tortor", "gravida", "sodales",
)


def _name(rng: np.random.Generator, n_words: int = 2) -> str:
    return "-".join(rng.choice(_WORDS, size=n_words))


def generate_traces(
    n_traces: int = 5,
    max_depth: int = 7,
    rng: Optional[np.random.Generator] = None,
    base_ts: int = 1_000_000_000_000,
    n_services: int = 10,
) -> List[List[Span]]:
    """Random span trees, one list per trace (TraceGen.scala:50 shape)."""
    rng = rng or np.random.default_rng(0)
    services = [f"{_name(rng, 1)}-{i}" for i in range(n_services)]
    traces = []
    for _ in range(n_traces):
        trace_id = int(rng.integers(1, 2**62))
        spans: List[Span] = []
        t0 = base_ts + int(rng.integers(0, 10_000_000))

        def walk(parent_id, depth, start, budget, client_svc):
            span_id = int(rng.integers(1, 2**62))
            svc = services[int(rng.integers(0, len(services)))]
            client = Endpoint(int(rng.integers(1, 2**31)), 80, client_svc)
            server = Endpoint(int(rng.integers(1, 2**31)), 443, svc)
            end = start + budget
            anns = (
                Annotation(start, "cs", client),
                Annotation(start + 1, "sr", server),
                Annotation(start + budget // 2, _name(rng), server),
                # The fixed value the module docstring promises (and the
                # annotation-query tests/benchmarks probe for) — same
                # vocabulary as ColumnarTraceGen.
                Annotation(start + budget // 2 + 1,
                           "some custom annotation", server),
                Annotation(end - 1, "ss", server),
                Annotation(end, "cr", client),
            )
            banns = (
                BinaryAnnotation(
                    _name(rng, 1), _name(rng, 3).encode(),
                    AnnotationType.BYTES, server,
                ),
                BinaryAnnotation(
                    "http.uri", b"/api/widgets", AnnotationType.BYTES,
                    server,
                ),
            )
            spans.append(
                Span(trace_id, _name(rng), span_id, parent_id, anns, banns)
            )
            if depth < max_depth:
                n_children = int(rng.integers(0, 3))
                for c in range(n_children):
                    child_budget = max(2, budget // (2 + c))
                    child_start = start + 1 + int(
                        rng.integers(0, max(1, budget - child_budget))
                    )
                    walk(span_id, depth + 1, child_start, child_budget, svc)

        walk(None, 1, t0, int(rng.integers(10_000, 1_000_000)), services[0])
        traces.append(spans)
    return traces


class ColumnarTraceGen:
    """Vectorized generator emitting SpanBatch columns directly.

    Every trace is a ``spans_per_trace``-node heap-shaped tree (parent of
    span j is span (j-1)//2, root parentless) — depth ≤ 7 holds for
    spans_per_trace ≤ 127, mirroring the reference's depth bound while
    keeping generation branch-free.

    Dictionaries are pre-seeded so the device batch can be built without
    per-span python; callers share ``dicts`` with their store/codec.
    """

    def __init__(
        self,
        dicts: DictionarySet,
        n_services: int = 100,
        n_span_names: int = 200,
        spans_per_trace: int = 7,
        seed: int = 0,
        topology: bool = False,
    ):
        """``topology=True`` assigns services from a fixed sparse call
        graph (each service calls two deterministic callees per child
        slot) instead of uniformly at random — real microservice fleets
        have O(S) dependency links, not O(S^2); uniform assignment makes
        every benchmark dep-link bank artificially dense."""
        self.dicts = dicts
        self.spans_per_trace = spans_per_trace
        self.topology = topology
        self.rng = np.random.default_rng(seed)
        self.service_ids = np.array(
            [dicts.services.encode(f"svc-{i:04d}") for i in range(n_services)],
            np.int32,
        )
        self.name_ids = np.array(
            [dicts.span_names.encode(f"op-{i:04d}") for i in range(n_span_names)],
            np.int32,
        )
        # Lowercased ids coincide (names are already lowercase).
        self.custom_ann_id = dicts.annotations.encode("some custom annotation")
        self.endpoint_ids = np.array(
            [
                dicts.endpoints.encode((0x0A000000 + i, 9410, f"svc-{i:04d}"))
                for i in range(n_services)
            ],
            np.int32,
        )
        self._next_trace = 1

    def next_batch(
        self, n_traces: int, base_ts: int = 1_000_000_000_000
    ) -> Tuple[SpanBatch, np.ndarray, np.ndarray]:
        """Returns (batch, name_lc_id, indexable) ready for
        TpuSpanStore.write_batch / device upload."""
        rng = self.rng
        spt = self.spans_per_trace
        n = n_traces * spt
        tid_base = np.arange(self._next_trace, self._next_trace + n_traces,
                             dtype=np.int64)
        self._next_trace += n_traces
        trace_id = np.repeat(
            (tid_base.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
            .view(np.int64),
            spt,
        )
        j = np.tile(np.arange(spt, dtype=np.int64), n_traces)  # node index
        span_id = trace_id ^ (j + 1)
        parent_j = (j - 1) // 2
        has_parent = j > 0
        parent_id = np.where(has_parent, trace_id ^ (parent_j + 1), 0)

        S = len(self.service_ids)
        if self.topology:
            # Root service random; child j's service is a fixed function
            # of its parent's service and child slot (heap parent
            # (j-1)//2, slot 1 or 2) — a sparse static call graph.
            cols = [rng.integers(0, S, size=n_traces)]
            for jj in range(1, spt):
                pj = (jj - 1) // 2
                slot = jj - 2 * pj
                cols.append((cols[pj] * 31 + slot) % S)
            svc_idx = np.stack(cols, axis=1).reshape(-1)
        else:
            svc_idx = rng.integers(0, S, size=n)
        service_id = self.service_ids[svc_idx]
        name_id = self.name_ids[rng.integers(0, len(self.name_ids), size=n)]

        # Timing: root spans start at base_ts + trace offset; children
        # nest inside with lognormal durations shrinking with depth.
        depth = np.floor(np.log2(j + 1)).astype(np.int64)
        trace_t0 = base_ts + np.repeat(
            rng.integers(0, 60_000_000, size=n_traces), spt
        )
        duration = (
            rng.lognormal(11.0, 1.0, size=n) / (1.0 + depth)
        ).astype(np.int64) + 4
        start = trace_t0 + j * 1000
        end = start + duration

        batch = SpanBatch.empty(n, 2 * n, n)
        batch.trace_id[:] = trace_id
        batch.span_id[:] = span_id
        batch.parent_id[:] = parent_id
        batch.name_id[:] = name_id
        batch.service_id[:] = service_id
        batch.flags[:] = np.where(has_parent, FLAG_HAS_PARENT, 0).astype(np.uint8)
        batch.ts_cs[:] = start
        batch.ts_sr[:] = start + 1
        batch.ts_ss[:] = end - 1
        batch.ts_cr[:] = end
        batch.ts_first[:] = start
        batch.ts_last[:] = end
        batch.duration[:] = duration

        # Two annotation rows per span: sr (server side, owning service)
        # and the custom annotation — enough to exercise the service
        # index and top-annotation paths at full rate.
        idx = np.arange(n, dtype=np.int32)
        batch.ann_span_idx[0::2] = idx
        batch.ann_span_idx[1::2] = idx
        batch.ann_ts[0::2] = start + 1
        batch.ann_ts[1::2] = (start + duration // 2)
        batch.ann_value_id[0::2] = 2  # CORE_ANNOTATION_IDS["sr"]
        batch.ann_value_id[1::2] = self.custom_ann_id
        batch.ann_service_id[0::2] = service_id
        batch.ann_service_id[1::2] = service_id
        batch.ann_endpoint_id[0::2] = self.endpoint_ids[svc_idx]
        batch.ann_endpoint_id[1::2] = self.endpoint_ids[svc_idx]

        # One binary annotation per span.
        key_id = self.dicts.binary_keys.encode("http.uri")
        val_id = self.dicts.binary_values.encode(b"/api/widgets")
        batch.bann_span_idx[:] = idx
        batch.bann_key_id[:] = key_id
        batch.bann_value_id[:] = val_id
        batch.bann_type[:] = int(AnnotationType.BYTES)
        batch.bann_service_id[:] = service_id
        batch.bann_endpoint_id[:] = self.endpoint_ids[svc_idx]

        name_lc = batch.name_id.copy()  # generator names are lowercase
        indexable = np.ones(n, bool)
        return batch, name_lc, indexable
