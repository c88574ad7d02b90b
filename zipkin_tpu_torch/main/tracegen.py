"""tracegen main: write synthetic traces, then query everything back.

The end-to-end smoke of the whole pipeline (tracegen/Main.scala:40-117),
the port's copy of ``zipkin_tpu/main/tracegen.py``: generate →
scribe-encode → receiver decode → collector → store, then exercise
every read API and print what came back. The device store runs on the
card; ``--memory-store`` uses the in-memory reference store. Exits
non-zero if any read comes back empty.
"""

from __future__ import annotations

import argparse
import sys


def run(n_traces: int = 5, max_depth: int = 7, device: str = "cuda",
        verbose: bool = True, memory_store: bool = False) -> bool:
    """Write ``n_traces`` generated traces through the collector into a
    small device store on ``device`` (or the in-memory store with
    ``memory_store``) and read them back; True when every read answered."""
    from zipkin_tpu_torch.ingest.collector import Collector
    from zipkin_tpu_torch.ingest.receiver import ScribeReceiver
    from zipkin_tpu_torch.query.request import QueryRequest
    from zipkin_tpu_torch.query.service import QueryService
    from zipkin_tpu_torch.tracegen import generate_traces
    from zipkin_tpu_torch.wire.thrift import span_to_scribe_message

    if memory_store:
        from zipkin_tpu_torch.store.memory import InMemorySpanStore

        store = InMemorySpanStore()
    else:
        from zipkin_tpu_torch.store.device import StoreConfig
        from zipkin_tpu_torch.store.torch_store import TorchSpanStore

        store = TorchSpanStore(StoreConfig(
            capacity=1 << 12, ann_capacity=1 << 14, bann_capacity=1 << 13,
            max_services=64, max_span_names=512, max_annotation_values=1024,
            max_binary_keys=128, cms_width=1 << 12, hll_p=10,
            quantile_buckets=1024,
        ), device=device)
    collector = Collector(store)
    receiver = ScribeReceiver(collector.accept)
    query = QueryService(store)
    try:
        traces = generate_traces(n_traces=n_traces, max_depth=max_depth)
        for spans in traces:
            entries = [("zipkin", span_to_scribe_message(s)) for s in spans]
            code = receiver.log(entries)
            assert code.name == "OK", code
        collector.flush()

        def say(*a):
            if verbose:
                print(*a)

        ok = True
        services = query.get_service_names()
        say(f"services: {sorted(services)}")
        ok &= bool(services)
        for svc in sorted(services)[:3]:
            names = query.get_span_names(svc)
            say(f"  spans[{svc}]: {sorted(names)[:5]}")
            resp = query.get_trace_ids(QueryRequest(svc, end_ts=10**18,
                                                    limit=10))
            say(f"  trace ids[{svc}]: {list(resp.trace_ids)[:5]}")
            if resp.trace_ids:
                got = query.get_traces_by_ids(resp.trace_ids[:3])
                summaries = query.get_trace_summaries_by_ids(
                    resp.trace_ids[:3])
                combos = query.get_trace_combos_by_ids(resp.trace_ids[:3])
                say(f"  fetched {len(got)} traces, {len(summaries)} "
                    f"summaries, {len(combos)} combos")
                ok &= bool(got) and bool(summaries) and bool(combos)
        deps = query.get_dependencies()
        say(f"dependency links: {len(deps.links)}")
        if not memory_store:
            ok &= bool(deps.links)
        total = sum(len(t) for t in traces)
        say(f"wrote {total} spans across {len(traces)} traces -> "
            + ("OK" if ok else "FAILED"))
        return bool(ok)
    finally:
        # The reference leaves its threads to the interpreter's exit;
        # the port stops the collector's workers, the query executor
        # and the store here, so a caller in a long-lived process
        # keeps none of them.
        query.close()
        collector.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--traces", type=int, default=5)
    p.add_argument("--max-depth", type=int, default=7)
    p.add_argument("--memory-store", action="store_true")
    args = p.parse_args(argv)
    ok = run(args.traces, args.max_depth, memory_store=args.memory_store)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
