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
   scatter-add sites are one fused launch); on the first launch's
   columns the standalone sketch APIs (``cms.update``, ``hll.update``,
   ``quantile.update_grouped`` on fresh sketches on the card) must
   equal the step's own sketch deltas bitwise, and each API, ``top_k``
   on a 1,000-service ``Counters`` with forced ties and
   ``topk_from_cms`` must give the card's and the CPU's results
   bitwise equal; it times ``kernels.cms_update`` (K1's count-min
   call) at that shape;
2. drives the paged layout the same way (128-row pages, 32,768 pages):
   >= 37 launches so the page pool runs out and pages are reclaimed,
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
   windowed arena on, 60 s x 64 buckets): 34 launches two buckets apart
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
   every 0.05 s, 64 MB segments), 4 launches, ``checkpoint.save``, 4
   more launches; then ``wal.recover`` restores a second store on the
   card and replays the 4-record tail. Integer leaves and counters must
   equal the uncrashed store's bitwise and the three moment leaves
   within the stated tolerance, the recovered mirror its own device
   leaves, and trace reads, name queries, dependency link counts and
   the windowed reads the uncrashed store's answers; the flat histogram
   launches once a replayed step and the arena halves launch too. It
   prints the save, load and replay seconds by phase, the snapshot and
   WAL bytes, the log's append latency and the peak device memory; one
   more launch must journal as record 9;
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
10. the daemon's ``--cold-tier --capture-backlog 4`` store at the full
   configuration's widths with a 2^20 span ring (the window store
   wrapped in a ``TieredSpanStore``, its ``capture_backlog`` 4; the ring
   cut from 2^22 so the sealed window is ~1 M spans, not ~4.13 M):
   launches past one lap of the span ring, so
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
   tiered ``checkpoint.save``/``load`` round trip on the card;
13. the daemon's ingest front end at full width (``collector_path``):
   the window store behind the daemon's ``Collector`` (``Sampler(1.0)``,
   queue 500, 10 workers, self-tracing) and a ``ScribeReceiver`` fast
   path on a ``ScribeServer``; four Scribe clients send one launch
   of generated spans (made in worker processes from the
   ``cold_tier_paged`` phase on, ``EarlyTraffic``), 100
   known traces on services of their own and one corrupt entry, in log
   calls of 2,048 entries. It fails unless the port's native codec
   loaded from ``build/zipkin_tpu_torch/``, every span but the corrupt
   entry is stored, the slow path ran only on the call holding it,
   each queue item left one self-trace span, the known traces' reads
   equal the in-memory oracle's, K1 and both K2 halves launched once a
   step, and the first step's fused K1 call (eight sites) and both K2
   halves equal their plain versions bitwise; then a sampled launch (rate 0.25, 1% debug) must keep exactly
   the threshold test's set with the sampler's counts, a durable
   sub-drive at 2^14 (WAL, ``ingest_thrift_durable``) must recover to
   the live state, card and CPU collectors must agree at 2^14, and
   ``recompute_dependencies`` must match the streaming links of the
   known services within stated tolerance 2. Between the Scribe drive's
   reads and the sampled launch, Kafka ingest runs through the same
   collector and store: a worker publishes one launch of new spans
   through ``KafkaSpanSink(MinimalKafkaProducer(...), batch=True,
   compress=True)`` to the port's ``FakeKafkaBroker`` on 127.0.0.1
   (a message of 2,048 spans) while the Scribe traffic is made, 100
   known traces and one corrupt deflate frame follow, and a
   ``KafkaSpanReceiver`` on a ``MinimalKafkaConsumer`` drains the topic
   into ``collector.accept_thrift``; every message must be counted, one
   bad, every published span stored, the known traces read back equal
   to the oracle and K1 and both K2 halves launched once a step (the
   ``kafka`` entry of ``launches_by_path``); it prints
   ``kafka_spans_per_s`` and ``kafka_over_scribe``. It prints scribe spans/s
   beside serial ``write_batch`` of the same launches, ack and write
   latencies, ``write_thrift``'s split (lock wait, parse + intern, chunk
   + pad, commit) and the idle share over the drive (taken under the
   CUDA-only profiler, as the drive's spans/s are);
14. the daemon's read path at the full configuration's widths with a
   2^21 span ring (``query_path``): ``QueryService(store)`` with the
   daemon's 2 ms window over the window store, loaded with 12 launches
   of the stream and 100 known traces on five services of their own;
   eight reader threads send ~600
   ``get_trace_ids`` requests (by service, span name, annotation and
   binary annotation, limits 10 and 100, each order, a tenth with two
   or three terms, drawn with repeats) and ~200 sketch reads while the
   store takes four more launches. It fails unless every known-service
   answer and the known traces' combos (skew adjustment on) equal an
   oracle ``QueryService`` over ``InMemorySpanStore``, every index-tier
   answer equals the store's direct serial ``get_trace_ids_multi`` at
   the frontier it was served at, every sketch-tier answer the store's
   direct read, a repeat read at a still frontier hits the result cache
   and misses after a commit, K1 and both K2 halves launch once a step,
   ``checkpoint.save`` (run while readers read) drains the engine before
   the pipeline, and a ``QueryService`` over a paged store at 2^14 reads
   the known traces' combos through the page gather equal to its CPU
   twin's and the oracle's. It prints serve p50/p99 by tier, dispatch
   p50/p99, requests a launch, reads/s, request ms split by what they
   overlapped (a launch, a long collector pause), the collector's
   pauses by generation and the card's idle share over the drive.
   Inside it, ``http_drive`` serves the same store through the port's
   ``ApiServer`` on a socket, with the daemon's collector behind it:
   every pool request as ``GET /api/query`` must equal the direct
   ``QueryService`` answer, the known traces' ``/api/trace`` an oracle
   server's, and the catalog, dependency and quantile routes
   ``api.handle``; eight readers send 600 requests through the
   sockets with no launch landing (client ms, the server's handle ms,
   the engine's serve ms by tier, the HTTP share, reads/s, idle share);
   three ``POST /scribe`` calls of 2,048 entries with 20 late known
   traces must read back equal to an oracle, with K1 and both K2 halves
   once a step (the ``http`` entry of ``launches_by_path``); a
   self-traced request must read back by its echoed id; ``/metrics``
   must parse as Prometheus text with every store counter, in both
   forms; ``POST /debug/profile`` must answer 200 with CUDA kernels in
   its trace (reads sent meanwhile) and a second capture 409; and ten
   ``/api/combo`` reads through a server over the paged 2^14 store must
   launch K3 and equal the CPU twin's server;
15. fleet observability on the daemon's default store (``fleet_path``,
   full width, the window on, a WAL with the daemon's defaults): a
   ``LineageTracker`` at ``sample_every=1`` through four journaled
   launches, its flushes landing through ``store.apply`` from the
   log's group-commit thread; every sampled record's trace (``ingest
   unit`` with ``wal append`` and ``wal fsync`` under it, tagged with
   the record's sequence) must read back from the card store, the stage
   sketch must have seen each stage, and K1 and both K2 halves must
   launch once a step, the flushes' steps included (the ``fleet`` entry
   of ``launches_by_path``). Then ``ApiServer(QueryService(store),
   collector, fleet=FleetObs(...))`` with the daemon's watchdog probes
   on a socket: ``/api/health`` 200, 503 with the reason while the
   log's fsync error is parked, 200 again, ``/debug/events`` exactly
   those two transitions, ``/metrics?fleet=1`` the registry's own
   values labelled ``role="primary"``, ``/api/fleet`` one process and
   the merged stage sketch. Last, lineage's cost at the production
   cadence (1 in 64): two stores with logs at fsync=off, one with a
   tracker, the same launches in interleaved rounds (three each, the
   minimum of each); it fails if a kernel library loads during the
   rounds or K1/K2 launches a step differ, and prints the ratio beside
   the reference's bound, 1.05, without gating on it;
16. the port's daemon as a process (``daemon_path``, right after
   ``durability_path``, whose full-width snapshot and log it boots
   from): ``python -m zipkin_tpu_torch.main.example --use-pallas
   --cold-tier --capture-backlog 4 --wal-dir --checkpoint`` (the rest at
   the daemon's defaults) in a session of its own, driven over its own
   sockets. Boot A must replay exactly the log records past the
   snapshot and answer 71 reads equal to the recovered store's through
   an ``ApiServer`` in this process; four Scribe clients send a
   launch of spans, 100 known traces and a corrupt entry (acked after
   the durable append; the traffic made with the collector phase's)
   while ``POST /debug/profile`` traces the card: its kernels must be
   one arena claim, one arena write and one flat histogram a step (the
   ``daemon`` entry of ``launches_by_path``); ``/metrics?format=json``
   must show ``store.scatter_path_pallas`` 1; the known traces read back
   equal to an oracle server's. SIGTERM must end it with exit 0 and no
   traceback after the ordered shutdown; boot B (the saved, now tiered,
   snapshot) replays at most the lineage tail and reads the known
   traces back; 20 more known traces are acked and the child SIGKILLed;
   boot C replays the tail and reads back every acked trace. Two
   ``python -m zipkin_tpu_torch.main.tracegen`` children (the card
   store and ``--memory-store``) must exit 0. The children run with no
   CUDA toolkit in reach and must leave the kernel libraries this script
   built as they were. Beside boot A (``--ship-port``) a standby
   follower runs as a child (``--follow --follow-mode standby`` from a
   copy of the same snapshot, on the card): after the Scribe traffic its
   ``/api/replication`` must show zero lag at the primary's durable
   frontier (read once: the primary's API self-traces, so polling it
   would journal a record a request) and the known
   traces must read back over its HTTP port equal to the oracle's; then
   SIGTERM ends both with exit 0. It prints each boot's ready, restore
   and replay seconds and health, the scribe spans/s and ack ms of the
   unprofiled half (the profiled half beside them, as the profiler's
   cost), the follower's ready, catch-up and exit seconds, and the
   seconds from SIGTERM to exit. Beside it, on a thread of its own, a
   sharded daemon (``--use-pallas --shards 2 --wal-dir --checkpoint``)
   at the full configuration's widths with a 2^20 span ring a shard:
   boot A restores an empty 2-shard snapshot (the daemon's flags set no
   widths) with a fresh log, takes the same Scribe traffic from four
   clients (its profile must show one claim, one write and one flat
   histogram a shard step: the ``sharded_daemon`` entry of
   ``launches_by_path``), reads the known traces back and is SIGKILLed;
   boot B replays the whole log, reads them back, and SIGTERM saves and
   ends it with exit 0; boot C restores that snapshot, replays at most
   the lineage flush and reads them back;
17. replication (``replication_path``, full width, the window on): a
   primary with a WAL at the daemon's fsync interval and lineage at 1
   in 64 serves a ``ShipServer`` on 127.0.0.1; a warm standby on the
   same card (built from HELLO's config) and a device-free replica
   follow it through three journaled launches and 100 known traces. The
   standby's state must equal the primary's (moments within stated
   tolerance 2), the replica's mirror the primary's device aggregates
   bitwise, the reads agree three ways, each standby step launch K1 and
   both K2 halves once (the ``replication`` entry of
   ``launches_by_path``: the launches less the primary's steps), and
   each sampled record's trace hold ``ship``, ``standby apply`` and
   ``replica apply``. Then the ship server is closed and rebound with
   both connections dropped (both reconnect, no anchor served), the
   standby is promoted and takes a journaled launch, and a late replica
   whose cursor precedes the truncated log bootstraps from an anchor
   equal to the primary's mirror. It prints shipped records/s and MB/s,
   commit-to-visible lag p50/p99 a follower, the standby's apply
   spans/s beside the primary's journaled ``write_batch``, the
   replica's seconds a record (mirror fold, seal), the anchor's bytes
   and seconds, and the reconnect seconds;
18. the sharded store (``sharded_path``): a ``ShardedSpanStore`` of 4
   shards at the full configuration on the one card (4 x ~4.8 GB) and
   a ``TorchSpanStore`` at the same configuration take the same Span
   lists through ``apply``: 4 units of 114,688 generated spans (each
   one launch unit: ~28,672 spans a shard step), then 100 known traces
   on services of their own; no ring laps. K1, the claim and the write
   must launch exactly 4 times a unit, once a shard step, empty shards
   included (the ``sharded`` entry of ``launches_by_path``; K3 0: the
   sharded store refuses the paged layout). The fleet's reads must
   equal the single store's: the known traces by id, existence,
   durations, the service and span-name catalogs, quantiles, the
   summed count, histogram and count-min leaves, the HLL registers, the
   dependency links (moments by stated tolerance 2) and the known
   services' index reads. The ``FleetMirror`` must equal the device's
   cross-shard merge bitwise, as the commits fed it and again after a
   resync; 8 readers released at a barrier must take at most 2 fused
   cross-shard reads with the serialized answers; a 2-shard fleet at
   2^14 must equal its CPU twin. It prints apply spans/s after the
   first unit, each unit's ms split (host encode and build, the shard
   steps, the summary), the reduction's ms, read ms p50/p99 by kind and
   the peak device memory, beside the card's name and power limit;
19. multi-process sharding (``multihost_path``, right after
   ``sharded_path``): two processes on the one card, each started with
   ``python3 -c "import chip_smoke; chip_smoke.multihost_worker(...)"``
   before ``sharded_path`` (their start, rendezvous and decode run
   beside it), join one gloo group through
   ``parallel.multihost.initialize`` and build the global view with
   ``global_mesh(local_shards=2)``: 4 global shards, process p owning
   [2p, 2p + 2). Each decodes ``sharded_path``'s first unit (114,688
   spans) and its 100 known traces, keeps what ``route_spans(...,
   keep=local_shard_ids(mesh))`` gives it, and, once ``sharded_path``
   has freed the card, applies it to a ``ShardedSpanStore(2)`` at the
   full configuration (2 x ~4.8 GB a process). Every kept span must sit
   on the local slot of its global shard; K1, the claim and the write
   must launch once a shard step, both counted (the ``multihost`` entry
   of ``launches_by_path``, both workers summed); over gloo the kept
   trace sets must be disjoint, cover the unit and lie on shards their
   keeper owns; each owner's reads of its known traces (spans and
   durations) must equal ``sharded_path``'s 4-shard fleet's. A worker
   that fails, hangs or exits non-zero fails the phase with its stderr,
   and both are killed; a rendezvous whose port was taken meanwhile is
   started again on a fresh one. It prints each worker's ready seconds
   (spawn to global view), apply spans/s and peak device memory;
20. sharded durability (``sharded_durability_path``): a 2-shard
   ``ShardedSpanStore`` at the full configuration journals into a
   ``ShardedWal`` at fsync ``batch`` through ``pipelined(depth=4)``: 2
   of ``sharded_path``'s units, ``checkpoint.save`` (every leaf stacked
   on the host, shard by shard), 1 more unit with 100 known traces,
   ``wal_sync``; then a crash (the log closed, no save) and
   ``wal.recover`` on the card, which must replay exactly that one
   record and land the uncrashed fleet (every shard's leaves compared
   on the card, the frontier, the applied sequence, the clocks, the
   known traces' reads); K1, the claim and the write must launch once a
   shard step, journaled and replayed (the ``sharded_durability`` entry
   of ``launches_by_path``). A 2-shard fleet at 2^14 then journals 3
   applies, its epoch log's last segment is cut mid-record, and the
   reopened log must align to the 2 complete units and replay into the
   fleet of those two. It prints the journaled ``apply`` spans/s, the
   journal's ms a unit, save s by part and bytes, load s by part,
   replay s and spans/s and the alignment's seconds.

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
import base64
import dataclasses
import gc
import json
import os
import re
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
            self.known, self.small_log2, self.small_batches = 60, 10, 18
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
            self.collector_log2, self.scribe_call = 12, 128
            self.prep_workers = 2
            self.query_log2, self.query_launches = 13, 2
            self.query_requests, self.query_pool = 200, 40
            self.fleet_round = 2
            self.cold_log2 = self.cap_log2
            self.shard_units, self.shard_parity_applies = 2, 4
            self.cold_parity_batches = self.small_batches
            self.shard_daemon_log2 = self.cap_log2
        else:
            self.cap_log2, self.services, self.names = 22, 1000, 2048
            self.batch_traces = 16384  # 114,688 spans a launch
            self.stream_spans = (5 * (1 << 22)) // 4
            # 18 batches four buckets apart (72 > 64 slots; cut from 24
            # three apart since the replication phase).
            self.known, self.small_log2, self.small_batches = 2000, 14, 18
            self.small_traces = 512
            # 34 launches two buckets apart: 68 buckets > 64 slots (46
            # before the Kafka drive came, 36 before the sharded phase).
            self.window_launches = 34
            # 3 apply calls of 28,672 spans (the first untimed), and 4
            # launches before the checkpoint and 4 after (the tail): cut
            # from 12 and 8 + 8 to keep the script near half its time
            # limit since the cold-tier phases (the applies from 8 to 6
            # since the replication phase, to 4 since the Kafka drive,
            # to 3 and the launches from 5 + 5 since the sharded phase).
            self.pipe_applies, self.pipe_traces = 3, 4096
            self.durability_launches = 4
            # 12 apply calls of 3,584 spans into 2^14 slots: the page
            # pool of 128 pages runs out and reclaims.
            self.dur_paged_log2, self.dur_paged_applies = 14, 12
            self.dur_paged_traces = 512
            # 37 launches = 4,243,456 spans > 2^22: the pool runs out
            # (39 before the sharded phase).
            self.paged_cap_log2, self.paged_launches = 22, 37
            self.page_max_chain, self.n_big = 64, 32
            self.big_min, self.big_max = 200, 4000
            self.overflow_spans = 20000  # > 64 pages x 128 rows
            # Cold tier: 100 known traces early and late, 20 sampled
            # stream traces of an evicted and of a resident launch.
            self.cold_known, self.cold_sample = 100, 20
            # The collector phase: the window store at 2^22, log calls
            # of 2,048 entries, its traffic made in 5 worker processes.
            self.collector_log2, self.scribe_call = 22, 2048
            self.prep_workers = 5
            # The query phase: 12 + 4 launches (1,835,008 spans) stay
            # inside one lap of a 2^21 ring (2^22 before the
            # multi-process phase: the save its readers read beside
            # shrinks with the ring), so no known trace laps; ~600
            # requests drawn from a pool of 160 (repeats; 2,000 before
            # the replication phase came, 1,200 before the Kafka drive,
            # 800 before the sharded phase).
            self.query_log2, self.query_launches = 21, 12
            self.query_requests, self.query_pool = 600, 160
            # The fleet phase's overhead rounds: 3 journaled launches a
            # round (~0.45 s each), three rounds a store after a warm one.
            self.fleet_round = 3
            # The cold tier at a 2^19 span ring (the other widths of the
            # full configuration kept): its sealed capture window is
            # ~0.5 M spans, not the 2^22 ring's ~4.13 M, whose host seal
            # took 154-208 s of the script's 1,200 s (2^20 before the
            # sharded durability phase).
            self.cold_log2 = 19
            # The sharded phase: 3 units of 114,688 spans (4 before the
            # sharded durability phase, which reuses them), each one
            # apply of Span objects, ~28,672 spans a shard step.
            self.shard_units, self.shard_parity_applies = 3, 2
            # The cold tier's card-vs-cpu parity: 9 batches of 3,584
            # spans, ~2 laps of the 2^14 ring, two segments (18 before
            # the sharded phase).
            self.cold_parity_batches = 9
            # The sharded daemon: config #2's widths, a 2^20 span ring a
            # shard (a depth cut from 2^22: its three boots restore and
            # save the fleet).
            self.shard_daemon_log2 = 20
        # The replication phase: 3 journaled launches (4 before the Kafka
        # drive) and the known traces shipped to a standby and a replica.
        self.replication_launches = 3
        # The fleet phase: 4 journaled launches traced unit by unit,
        # then 3 timed rounds a store, lineage off and on in turn.
        self.fleet_launches, self.fleet_rounds = 4, 3
        # One launch of the stream through the Scribe front end (cut
        # from four to two to make room for the daemon phase, to one for
        # the Kafka drive, which sends one more launch through the same
        # collector), and one through the daemon's own Scribe port (cut
        # from two to make room for the replication phase and the
        # daemon's standby child).
        self.collector_launches = 1
        self.daemon_launches = 1
        # The query phase: the window store loaded with part of a lap,
        # eight readers, four launches while they read.
        self.query_writes, self.query_readers = 4, 8
        # Launches past one lap of the span ring: the first capture
        # window (~capacity spans) is pulled and sealed, then two more,
        # so launch 1 (sampled as cold only) is overwritten (three
        # before the sharded phase).
        self.cold_launches = -(-(1 << self.cold_log2)
                               // (self.batch_traces * 7)) + 2
        # A daemon boot is held to this many of the stream's traces
        # (100 before the sharded phase, 50 before the multi-process
        # phase) and each service's queries.
        self.boot_traces = 25
        # The sharded daemon's boots read back this many of the 100 known
        # traces (each read is an API self-trace span, one journaled unit
        # of the fleet) and the known services' queries (25 before the
        # multi-process phase).
        self.shard_daemon_known = 15


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
    """Mean device milliseconds, a call, of the device activities whose
    name holds ``kernel`` (a string, or a tuple of strings: any of them)
    in ``fn`` calls (torch.profiler's CUDA activity): no host launch
    gaps, and a 256 MB fill before each call so each starts with the
    50 MB L2 cold, as a read on the store finds it. The fill writes
    ones, so it is a kernel and never a memset. "not measured" off the
    card; see ``device_profile`` for the calls it counts."""
    return device_profile(torch, fn, kernel, reps)[0]


def device_profile(torch, fn, kernel, reps: int = 10, warm: int = 3):
    """``device_ms`` and what the profile held. The profiler does not
    report the first few activities of a capture (run 1 of PR 11: the
    first two to five of 20), so ``warm`` calls run first inside it, and
    the mean is over the last ``reps`` calls whose fill it reported:
    their matched activities (those that start after the first of those
    fills) over their count. ``info``: the calls counted, the activities
    matched in them, and by name those the filter matched neither."""
    if not torch.cuda.is_available():
        return "not measured", {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(warm + reps):
            flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    fills = [e.time_range.start for e in events
             if "FillFunctor" in e.name][-reps:]
    info = {"calls_counted": len(fills), "matched": 0, "reps": reps,
            "unmatched": {}}
    if not fills:
        return "not measured", info
    busy = 0.0
    for e in events:
        if e.time_range.start < fills[0] or "FillFunctor" in e.name:
            continue
        if any(n in e.name for n in names):
            busy += e.time_range.end - e.time_range.start
            info["matched"] += 1
        else:
            info["unmatched"][e.name] = info["unmatched"].get(e.name, 0) + 1
    return busy / len(fills) / 1e3, info


def checked_device_ms(torch, fn, kernel, bound_ms, launches: int,
                      what: str, reps: int = 10, tries: int = 3):
    """``device_ms`` of a call that launches ``kernel`` ``launches``
    times, held to what a profile can show: all ``reps`` calls counted,
    each call's launches all matched by the name filter, and a time no
    less than the call's bound. A profile that falls short is taken
    again (``tries`` in all); then the phase fails."""
    seen = []
    for _ in range(tries):
        ms, info = device_profile(torch, fn, kernel, reps)
        if not torch.cuda.is_available():
            return ms, info
        seen.append((ms, info))
        calls = info["calls_counted"]
        if calls == reps and info["matched"] == launches * calls \
                and ms != "not measured" and ms >= bound_ms:
            return ms, {**info, "tries": len(seen)}
    fail(f"{what}: device time of {kernel} under its bound, or its "
         f"launches not all reported, in {tries} profiles: " + json.dumps(
             [{"device_ms": ms, **info} for ms, info in seen]))


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy = 0.0
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


class DeviceIdle:
    """The card's idle share over a ``with`` block: torch.profiler's
    CUDA activity only (kernels from every thread), 1 - the union of
    the device intervals over the block's wall time. ``result`` is None
    off the card."""

    def __init__(self, torch, device):
        self.torch, self.on = torch, device.type == "cuda"
        self.result, self._prof = None, None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        self.torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self._t0) * 1e6
        self._prof.__exit__(*exc)
        if exc[0] is None:
            from torch.autograd import DeviceType

            spans = [(e.time_range.start, e.time_range.end)
                     for e in self._prof.events()
                     if e.device_type == DeviceType.CUDA]
            busy = union_us(spans)
            self.result = {"wall_ms": wall_us / 1e3,
                           "device_busy_ms": busy / 1e3,
                           "device_events": len(spans),
                           "idle_share": max(0.0, 1.0 - busy / wall_us)}
        return False


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
    busy = union_us([(e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA])
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
    installed in ``gc.callbacks``; ``by_gen`` splits them (and counts
    the collections) by the generation collected, ``spans`` keeps each
    pause's (start, end) on the host clock."""

    def __init__(self):
        self.ms = 0.0
        self._t = 0.0
        self.by_gen = {}
        self.spans = []

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            t = time.perf_counter()
            ms = (t - self._t) * 1e3
            self.ms += ms
            self.spans.append((self._t, t))
            n, total = self.by_gen.get(info["generation"], (0, 0.0))
            self.by_gen[info["generation"]] = (n + 1, total + ms)


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


class FirstStepSketches:
    """Wraps ``dev.ingest_steps`` for its next call (one launch's steps):
    keeps copies of the sketch leaves before and after it and of the
    columns the steps consumed (each batch's rows below ``n_spans``, the
    step's mask), then takes itself off."""

    LEAVES = ("cms_trace_spans", "hll_traces", "svc_hist")

    def __init__(self, dev):
        self.dev, self._orig = dev, dev.ingest_steps
        self.before = self.after = self.cols = None
        dev.ingest_steps = self._steps

    def _steps(self, state, batches):
        import torch

        self.restore()
        batches = list(batches)
        lv = state.leaves
        self.before = {k: lv[k].clone() for k in self.LEAVES}
        self.cols = {c: torch.cat([getattr(b, c)[:b.n_spans].clone()
                                   for b in batches])
                     for c in ("trace_id", "service_id", "duration")}
        out = self._orig(state, batches)
        self.after = {k: lv[k].clone() for k in self.LEAVES}
        return out

    def restore(self):
        self.dev.ingest_steps = self._orig


def sketch_api_check(torch, K, cfg, probe, device):
    """The standalone sketch APIs on the columns the ring path's first
    launch consumed: ``cms.update``, ``hll.update`` and
    ``quantile.update_grouped`` on fresh sketches on the card must equal
    the store's own delta bitwise (counts and histograms: after - before;
    HLL: max(before, api) == after); then each API again on the CPU,
    with ``top_k`` on a 1,000-service ``Counters`` with forced ties and
    ``topk_from_cms``, equal to the card's bitwise, the tie order that
    of a numpy lexsort. It times ``kernels.cms_update`` at this shape
    against its plain version, one ``index_add_`` and its bound, and
    counts the K1 launches the API calls made."""
    from zipkin_tpu_torch.ops import cms, hll, quantile as Q, topk
    from zipkin_tpu_torch.ops.hashing import dev_split64

    if probe.cols is None:
        fail("ring path: the first launch's steps were not seen")
    S = cfg.max_services
    t0 = time.perf_counter()

    def apis(dev):
        tid, sid, dur = (probe.cols[c].to(dev) for c in (
            "trace_id", "service_id", "duration"))
        hi, lo = dev_split64(tid)
        ok = (sid >= 0) & (sid < S) & (dur >= 0)
        before = K.LAUNCHES["flat_histogram"]
        sk = cms.update(cms.init(cfg.cms_depth, cfg.cms_width, device=dev),
                        hi, lo)
        reg = hll.update(hll.init(cfg.hll_p, device=dev), hi, lo)
        hist = Q.update_grouped(
            Q.init((S,), cfg.quantile_buckets, cfg.quantile_alpha,
                   dtype=torch.int32, device=dev), sid, dur, valid=ok)
        ctr = topk.update(topk.init(S, dtype=torch.int32, device=dev),
                          torch.div(sid, 4, rounding_mode="floor") * 4)
        cand_hi, cand_lo = hi[:20_000], lo[:20_000]
        out = {"cms": sk.counts, "hll": reg.registers, "hist": hist.counts,
               "counters": ctr.counts}
        out["top_k_values"], out["top_k_ids"] = topk.top_k(ctr, S)
        out["cms_top_values"], out["cms_top_positions"] = \
            topk.topk_from_cms(sk, cand_hi, cand_lo, 1000)
        sync(torch, torch.device(dev) if isinstance(dev, str) else dev)
        return out, K.LAUNCHES["flat_histogram"] - before

    card, k1 = apis(device)
    b, a = probe.before, probe.after
    if not torch.equal(card["cms"], a["cms_trace_spans"]
                       - b["cms_trace_spans"]):
        fail("ring path: cms.update differs from the step's count-min delta")
    if not torch.equal(card["hist"], a["svc_hist"] - b["svc_hist"]):
        fail("ring path: quantile.update_grouped differs from the step's "
             "svc_hist delta")
    if not torch.equal(torch.maximum(b["hll_traces"], card["hll"]),
                       a["hll_traces"]):
        fail("ring path: hll.update differs from the step's registers")
    if device.type == "cuda" and k1 != 3:
        fail(f"ring path: the int32 sketch updates launched K1 {k1} "
             f"times, not 3 (cms, histogram bank, counters)")
    cpu, _ = apis("cpu")
    for k, v in cpu.items():
        if not torch.equal(v, card[k].cpu()):
            fail(f"ring path: the sketch API's {k} differs card vs CPU")
    counts = cpu["counters"].numpy()
    order = np.lexsort((np.arange(S), -counts))
    if not np.array_equal(cpu["top_k_ids"].numpy(), order):
        fail("ring path: top_k does not order ties by id")
    api_s = time.perf_counter() - t0

    # kernels.cms_update at this shape (4 x 114,688 rows into 4 x 2^16).
    tid = probe.cols["trace_id"].to(device)
    hi, lo = dev_split64(tid)
    rows = cms.indices(cfg.cms_depth, cfg.cms_width, hi, lo).to(
        torch.int32).contiguous()
    zeros = torch.zeros((cfg.cms_depth, cfg.cms_width), dtype=torch.int32,
                        device=device)
    want = K.histogram_update_plain(zeros.clone(),
                                    K.cms_flat_index(rows, cfg.cms_width))
    got = K.cms_update(zeros.clone(), rows)
    err = _disagree(got, want)
    if err:
        fail(f"kernels.cms_update disagrees with its plain version "
             f"(max err {err})")
    scratch = zeros.clone()
    flat = K.cms_flat_index(rows, cfg.cms_width).long()
    ones = torch.ones_like(flat, dtype=torch.int32)
    touched = int(torch.unique(flat).numel())
    bound_ms = (rows.numel() * 4 + touched * 8) / H100_BYTES_PER_S * 1e3
    call = lambda: K.cms_update(scratch, rows)  # noqa: E731
    out = {
        "rows": rows.numel(), "cells": scratch.numel(), "touched": touched,
        "ms": time_ms(torch, call),
        "device_ms": checked_device_ms(torch, call, "hist_multi", bound_ms,
                                       1, "kernels.cms_update")[0],
        "plain_ms": time_ms(torch, lambda: K.histogram_update_plain(
            scratch, K.cms_flat_index(rows, cfg.cms_width))),
        "library_ms": time_ms(torch, lambda: scratch.view(-1).index_add_(
            0, flat, ones)),
        "library": "one index_add_ over the flat index",
        "bound_ms": bound_ms, "bound_by": "bytes", "max_abs_err": err,
        "api_k1_launches": k1, "api_check_s": api_s,
        "keys": tid.numel(),
    }
    log("sketch APIs vs the ring step: " + json.dumps(out))
    return out


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
    probe = FirstStepSketches(dev)
    K.reset_launches()
    n_launches = -(-scale.stream_spans // (scale.batch_traces * 7))
    try:
        written, step_s, stream_s, peaks = stream(torch, store, gen, scale,
                                                  n_launches, device)
    finally:
        probe.restore()
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
    sketch_api = sketch_api_check(torch, K, cfg, probe, device)
    del probe
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
    result["sketch_api"] = sketch_api
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
# four, so both lap the 64-slot ring.
WINDOW = dict(window_seconds=60, window_buckets=64)
WIN_US = 60_000_000
WIN_BASE_US = (1_700_000_000_000_000 // WIN_US) * WIN_US
WIN_STEP_US = 2 * WIN_US
PARITY_STEP_US = 4 * WIN_US
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
    """The store's sketch mirror equals its device leaves bitwise (only
    the mirrored leaves are copied out)."""
    for name, got in zip(WINDOW_LEAVES, store.sketch_mirror.arrays()):
        want = store.state.leaves[name].cpu().numpy()
        if got.dtype != want.dtype or not np.array_equal(got, want):
            fail(f"{what}: the sketch mirror's {name} differs from the "
                 f"device leaf")


def check_card_states_equal(a, b, what):
    """Two port states equal where they lie (on the card: no copy of
    ~4.8 GB out): integer leaves bitwise, the moment leaves by stated
    tolerance 2 (``testing.crash.state_mismatches``)."""
    from zipkin_tpu_torch.testing.crash import state_mismatches

    bad = state_mismatches(a, b, moments_tolerance=True)
    if bad:
        fail(f"{what}: leaves differ (cells a leaf, -1 for a shape, dtype "
             f"or counter mismatch): {bad}")


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
        check_card_states_equal(serial.state, piped.state,
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


def step_census_of(store, what):
    """The store's step census at the default pad shapes, held to its
    table row (``store/census.py``). On the card each wrapper call the
    census counts is one launch of its kernel (over the empty batch's
    invalid rows), and the launch counts move by exactly those calls."""
    from zipkin_tpu_torch.ops import kernels as K
    from zipkin_tpu_torch.store import census

    launches = dict(K.LAUNCHES)
    got = store.step_census()
    on_card = store.device.type == "cuda"
    moved = {k: K.LAUNCHES[k] - launches[k] for k in census.KERNELS}
    if moved != {k: got[k] if on_card else 0 for k in census.KERNELS}:
        fail(f"{what}: the census's wrapper calls {got} launched {moved}")
    if census.gated(got) != census.row_of(store.config):
        fail(f"{what}: step census {got}, table row "
             f"{census.row_of(store.config)}")
    return got


def _compare_answers(want, got, what):
    for k, v in want.items():
        if got[k] != v:
            fail(f"{what}: the recovered store's {k} answers differ")
    if not any(want["by_service"]) or not want["links"]:
        fail(f"{what}: the reads compared nothing")


def durability_path(torch, K, dev, scale, device):
    """Checkpoint + WAL at full width on the daemon's default store (the
    window on): 4 launches journaled with the daemon's log defaults,
    ``checkpoint.save``, 4 more, then ``wal.recover`` on the card into a
    second store; the uncrashed store is the reference. Returns (result,
    the daemon phase's boot: the snapshot and log directories, the
    records past the snapshot, and the recovered store's answers to the
    routes the daemon is held to, taken through an ``ApiServer``)."""
    from zipkin_tpu_torch import checkpoint, obs
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen
    from zipkin_tpu_torch.wal import WriteAheadLog, recover

    # The ring holds the phase's launches and the daemon's without a lap
    # (2^22 at full width, 2^12 in the rehearsal), so the daemon's cold
    # tier stays empty.
    spans = ((2 * scale.durability_launches + 1 + scale.daemon_launches)
             * scale.batch_traces * 7)
    cfg = full_config(dev, max(scale.cap_log2, (spans - 1).bit_length()),
                      scale.services, **WINDOW)
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
        _timed_method(store, "_journal_group", journal_s)
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
        check_card_states_equal(store.state, rec.state,
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
        census_row = step_census_of(rec, "durability path")
        boot = {"work": work, "wal_dir": wal_dir, "ckpt": ckpt,
                "records_past_snapshot": wal2.last_seq - n,
                "answers": boot_answers(rec, tids, names,
                                        scale.boot_traces)}
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
            "step_census": census_row,
            "kernel_launches": launches, "ingest_steps": steps,
        }
        log("durability path result: " + json.dumps(result))
        del store, rec
        return result, boot
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


# ---------------------------------------------------------------------------
# The daemon as a process
# ---------------------------------------------------------------------------

DAEMON_READY = "zipkin-tpu example serving on "
DAEMON_RESTORED = "checkpoint: restored "
DAEMON_REPLAYED = "wal: replayed "
SELF_SERVICE = "zipkin-tpu"
BOOT_END_TS = str(2**62)
DAEMON_BOOT_S = 600
DAEMON_EXIT_S = 600
DAEMON_LATE_KNOWN = 20
DAEMON_PROFILE_S = 4
DAEMON_BIND_TRIES = 3


def boot_routes(tids, names, n_traces: int):
    """The routes a daemon boot is held to: ``n_traces`` of the stream's
    traces, and each service's by-name and by-annotation query."""
    from zipkin_tpu_torch.ingest.receiver import _hex_id

    step = max(1, len(tids) // n_traces)
    routes = [(f"/api/trace/{_hex_id(t)}", {})
              for t in tids[::step][:n_traces]]
    for n in names:
        q = {"serviceName": n, "endTs": BOOT_END_TS, "limit": "20"}
        routes += [("/api/query", q),
                   ("/api/query", {**q,
                                   "annotationQuery": "http.uri=/api/widgets"})]
    return routes


def other_links(body):
    """The dependency links of a ``/api/dependencies`` body between
    services other than the daemon's own (its self-trace and lineage
    spans carry wall-clock times)."""
    return sorted((lk for lk in body["links"]
                   if SELF_SERVICE not in (lk["parent"], lk["child"])),
                  key=lambda lk: (lk["parent"], lk["child"]))


def links_close(got, want) -> bool:
    """Equal links, their float32 moments by stated tolerance 2."""
    from zipkin_tpu_torch.testing.crash import moments_close

    key = [(lk["parent"], lk["child"]) for lk in want]
    if [(lk["parent"], lk["child"]) for lk in got] != key:
        return False
    fields = ("count", "mean", "stddev", "m2", "m3", "m4")

    def mat(links):
        return [[lk["durationMoments"][f] or 0.0 for f in fields]
                for lk in links]

    return not want or moments_close(mat(want), mat(got))


def boot_answers(store, tids, names, n_traces: int):
    """``boot_routes`` and the dependency links answered by ``store``
    through an ``ApiServer`` in this process (the JSON a socket
    carries)."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.api import ApiServer
    from zipkin_tpu_torch.query import QueryService

    service = QueryService(store, coalesce_window_s=0.0)
    api = ApiServer(service, self_trace=False, registry=obs.Registry())
    try:
        routes = [(path, params, *direct_json(api, path, params))
                  for path, params in boot_routes(tids, names, n_traces)]
        status, deps = direct_json(api, "/api/dependencies")
        return {"routes": routes, "links": other_links(deps)}
    finally:
        service.close()


def http_json(base, path, params=None):
    from urllib.parse import quote

    qs = "&".join(f"{k}={quote(v, safe='')}"
                  for k, v in (params or {}).items())
    status, _, body = http_call(base + path + ("?" + qs if qs else ""))
    return status, json.loads(body)


def boot_reads_equal(base, want, what):
    for path, params, status, body in want["routes"]:
        if http_json(base, path, params) != (status, body):
            fail(f"{what}: {path} {params} differs from the store that "
                 f"applied the same records")
    if not any(b.get("traceIds") for p, _, _, b in want["routes"]
               if p == "/api/query"):
        fail(f"{what}: the queries compared nothing")
    status, deps = http_json(base, "/api/dependencies")
    if status != 200 or not want["links"] or not links_close(
            other_links(deps), want["links"]):
        fail(f"{what}: the dependency links differ")
    return len(want["routes"]) + 1


def known_reads_equal(base, oracle_api, known, what):
    """The known traces' ``/api/trace`` and their services' queries over
    the socket against the oracle server's answers."""
    from zipkin_tpu_torch.ingest.receiver import _hex_id

    routes = [(f"/api/trace/{_hex_id(tr[0].trace_id)}", {}) for tr in known]
    q = {"endTs": BOOT_END_TS, "limit": "20"}
    routes += [("/api/query", {"serviceName": svc, **q})
               for svc in COLD_SERVICES]
    routes += [("/api/query", {"serviceName": COLD_SERVICES[1],
                               "spanName": COLD_OPS[3], **q}),
               ("/api/query", {"serviceName": COLD_SERVICES[2],
                               "annotationQuery": "http.uri=/api/widgets",
                               **q})]
    for path, params in routes:
        want = direct_json(oracle_api, path, params)
        if want[0] != 200 or http_json(base, path, params) != want:
            fail(f"{what}: {path} {params} differs from the oracle's")
    return len(routes)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class DaemonProcess:
    """``python -m zipkin_tpu_torch.main.example`` as a child in a
    session of its own, its output (stdout and stderr) read on a
    thread; every wait has a deadline, and ``kill`` ends its process
    group."""

    def __init__(self, flags, env, what):
        self.what = what
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "zipkin_tpu_torch.main.example", *flags],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        self.lines = []
        self._cond = threading.Condition()
        self._done = False
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            with self._cond:
                self.lines.append((time.perf_counter() - self.t0,
                                   line.rstrip("\n")))
                self._cond.notify_all()
        with self._cond:
            self._done = True
            self._cond.notify_all()

    def tail(self, n: int = 40) -> str:
        with self._cond:
            return "\n".join(line for _, line in self.lines[-n:])

    def find(self, prefix):
        """(seconds from the start, line) of the first output line that
        starts with ``prefix``, or None."""
        with self._cond:
            return next(((t, line) for t, line in self.lines
                         if line.startswith(prefix)), None)

    def wait_line(self, prefix, timeout_s: float, must: bool = True):
        """The first line that starts with ``prefix``, waited for until
        the deadline or the child's exit; without it, a failure, or None
        when not ``must``."""
        deadline = time.perf_counter() + timeout_s
        with self._cond:
            while True:
                hit = next(((t, line) for t, line in self.lines
                            if line.startswith(prefix)), None)
                left = deadline - time.perf_counter()
                if hit is not None or self._done or left <= 0:
                    break
                self._cond.wait(min(left, 1.0))
        if hit is None and must:
            fail(f"daemon {self.what}: no {prefix!r} line within "
                 f"{timeout_s} s (exit {self.proc.poll()}); its output:\n"
                 f"{self.tail()}")
        return hit

    def signal(self, sig) -> None:
        os.killpg(self.proc.pid, sig)

    def wait_exit(self, timeout_s: float) -> int:
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            fail(f"daemon {self.what}: still running {timeout_s} s after "
                 f"its signal; its output:\n{self.tail()}")
        self._reader.join(timeout=60)
        return rc

    def kill(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=120)
        self._reader.join(timeout=60)


def replayed_of(daemon):
    """(records, spans, seconds) of a boot's replay line; zeros when the
    boot replayed nothing (the daemon prints no line then)."""
    hit = daemon.find(DAEMON_REPLAYED)
    if hit is None:
        return 0, 0, 0.0
    w = hit[1].split()
    return int(w[2]), int(w[4].lstrip("(")), float(w[7].rstrip("s"))


def boot_daemon(torch, device, flags, env, what, live):
    """Start a daemon and wait for its serving line: (process, base URL,
    scribe port, boot record)."""
    free_card(torch, device)
    for attempt in range(DAEMON_BIND_TRIES):
        # free_port releases its ports before the child binds them, after
        # its boot: another process on the host may take one meanwhile.
        # The child then dies on the bind, before it serves or journals
        # anything, and a boot on fresh ports replays the same log.
        port, scribe = free_port(), free_port()
        d = DaemonProcess(flags + ["--port", str(port), "--scribe-port",
                                   str(scribe)], env, what)
        live.append(d)
        hit = d.wait_line(DAEMON_READY, DAEMON_BOOT_S,
                          must=attempt + 1 == DAEMON_BIND_TRIES)
        if hit is not None:
            break
        if not any("Address already in use" in line for _, line in d.lines):
            fail(f"daemon {what}: no serving line within {DAEMON_BOOT_S} s "
                 f"(exit {d.proc.poll()}); its output:\n{d.tail()}")
        d.kill()
        log(f"daemon {what}: a port was taken before the child bound it; "
            f"booting again on fresh ports")
    ready_s, _ = hit
    base = f"http://127.0.0.1:{port}"
    restored = d.find(DAEMON_RESTORED)
    records, spans, replay_s = replayed_of(d)
    status, health = http_json(base, "/api/health")
    if status != 200 or not health["ready"]:
        fail(f"daemon {what}: /api/health answered {status} {health}")
    rec = {"ready_s": ready_s,
           "restore_s": (float(restored[1].split()[-1].rstrip("s"))
                         if restored else None),
           "replayed_records": records, "replayed_spans": spans,
           "replay_s": replay_s, "health": [status, health["ready"]]}
    log(f"daemon {what}: " + json.dumps(rec))
    return d, base, scribe, rec


FOLLOWER_READY = "zipkin-tpu standby following "
FOLLOWER_NAME = "standby-smoke"


def spawn_follower(flags, env, live):
    """Start a follower daemon (``--follow``) on a fresh port: (process,
    port). ``await_follower`` waits for its serving line."""
    port = free_port()
    d = DaemonProcess(flags + ["--port", str(port)], env, "follower")
    live.append(d)
    return d, port


def await_follower(d, port, flags, env, live):
    """Wait for a spawned follower's serving line (booting again on a
    fresh port when another process took its port meanwhile): (process,
    base URL, boot record)."""
    for attempt in range(DAEMON_BIND_TRIES):
        hit = d.wait_line(FOLLOWER_READY, DAEMON_BOOT_S,
                          must=attempt + 1 == DAEMON_BIND_TRIES)
        if hit is not None:
            break
        if not any("Address already in use" in line for _, line in d.lines):
            fail(f"daemon follower: no serving line within {DAEMON_BOOT_S} "
                 f"s (exit {d.proc.poll()}); its output:\n{d.tail()}")
        d.kill()
        log("daemon follower: its port was taken; booting again")
        d, port = spawn_follower(flags, env, live)
    restored = d.find(DAEMON_RESTORED)
    rec = {"ready_s": hit[0],
           "restore_s": (float(restored[1].split()[-1].rstrip("s"))
                         if restored else None)}
    log("daemon follower: " + json.dumps(rec))
    return d, f"http://127.0.0.1:{port}", rec


def follower_current(base, fbase, what, timeout_s=DAEMON_BOOT_S):
    """Read the primary's durable frontier once, then poll the
    follower's ``/api/replication`` until it has applied that frontier
    with zero lag: (seconds waited, the follower's document, the
    primary's). Polling the primary itself would journal a record a
    request (its API self-traces), and the follower would chase them."""
    t = time.perf_counter()
    _, theirs = http_json(base, "/api/replication")
    want = theirs["durableSeq"]
    if FOLLOWER_NAME not in theirs.get("followers", {}):
        fail(f"{what}: the primary lists no follower {FOLLOWER_NAME}: "
             f"{theirs}")
    while True:
        _, mine = http_json(fbase, "/api/replication")
        if (mine.get("lagRecords") == 0 and mine.get("error") is None
                and mine.get("appliedSeq", -1) >= want):
            return time.perf_counter() - t, mine, theirs
        if time.perf_counter() - t > timeout_s:
            fail(f"{what}: not current within {timeout_s} s: {mine} "
                 f"{theirs}")
        time.sleep(0.2)


def kernel_sequence(events):
    """The ingest step kernels of a Chrome trace in start order: ``C``
    for the arena claim (its kernels merged), ``W`` the arena write,
    ``H`` the flat histogram."""
    seq = []
    for _, name in sorted((e["ts"], e["name"]) for e in events
                          if e.get("cat") == "kernel"):
        c = ("H" if "hist_multi" in name else
             "W" if "arena_write" in name else
             "C" if "arena_claim" in name else None)
        if c is not None and not (c == "C" and seq and seq[-1] == "C"):
            seq.append(c)
    return seq


def steps_in(seq, what):
    """Complete claim-write-histogram steps in a kernel sequence; fails
    unless, past a partial step at each edge of the capture, it is those
    steps and nothing else (K1 once a step, after both K2 halves)."""
    head = seq.index("C") if "C" in seq else len(seq)
    body = seq[head:]
    full = len(body) // 3
    if (body[:3 * full] != ["C", "W", "H"] * full
            or body[3 * full:] not in ([], ["C"], ["C", "W"])
            or seq[:head] not in ([], ["H"], ["W", "H"])):
        fail(f"{what}: the profiled kernels are not one claim, one write "
             f"and one flat histogram a step: {''.join(seq)}")
    return full


def warm_profiler(base, what):
    """Start one short ``POST /debug/profile`` on a thread, so that the
    daemon's first profiler start is paid before a capture that must hold
    traffic; returns a callable that waits for it and returns its
    seconds."""
    got = {}

    def capture():
        t = time.perf_counter()
        got["resp"] = http_call(base + "/debug/profile?seconds=0.01", b"",
                                timeout=300)
        got["s"] = time.perf_counter() - t

    th = threading.Thread(target=capture, daemon=True)
    th.start()

    def wait():
        th.join(timeout=300)
        status, _, body = got.get("resp", (None, None, b"{}"))
        if th.is_alive() or status != 200:
            fail(f"{what}: the profiler's warm-up capture answered {status} "
                 f"{body[:200]!r}")
        shutil.rmtree(json.loads(body)["profileDir"], ignore_errors=True)
        return got["s"]

    return wait


def profile_during(base, what):
    """Start ``POST /debug/profile?seconds=N`` on a thread and return once
    the capture holds the profiler (a probe answers 409): (thread, result
    dict)."""
    got = {}

    def capture():
        got["resp"] = http_call(
            base + f"/debug/profile?seconds={DAEMON_PROFILE_S}", b"",
            timeout=300)

    th = threading.Thread(target=capture, daemon=True)
    th.start()
    time.sleep(0.5)
    deadline = time.perf_counter() + 120
    while True:
        status, _, body = http_call(base + "/debug/profile?seconds=0.01",
                                    b"")
        if status == 409:
            break
        if status == 200:
            shutil.rmtree(json.loads(body)["profileDir"], ignore_errors=True)
        if not th.is_alive() or time.perf_counter() > deadline:
            fail(f"{what}: the profile capture did not start "
                 f"({got.get('resp', (None,))[0]})")
        time.sleep(0.2)
    time.sleep(1.0)
    return th, got


class Background:
    """``fn(*args)`` on a thread of its own; ``result()`` waits for it
    and raises what it raised."""

    def __init__(self, name, fn, *args):
        self._out = self._err = None
        self._thread = threading.Thread(target=self._run, args=(fn, args),
                                        name=name, daemon=True)
        self._thread.start()

    def _run(self, fn, args):
        try:
            self._out = fn(*args)
        except BaseException as e:  # noqa: BLE001 — raised in result()
            self._err = e

    def result(self, timeout_s: float):
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            fail(f"{self._thread.name} did not end in {timeout_s} s")
        if self._err is not None:
            raise self._err
        return self._out


def empty_fleet_snapshot(dev, scale):
    """An empty 2-shard snapshot at the full configuration's widths with
    a ``2^shard_daemon_log2`` span ring a shard, saved from a fleet on
    the host into a directory of its own: the sharded daemon's first
    boot restores it (the daemon's flags set no widths, and a snapshot's
    geometry wins over them). Returns (the directory, seconds)."""
    from zipkin_tpu_torch import checkpoint, obs
    from zipkin_tpu_torch.parallel.shard import ShardedSpanStore

    t = time.perf_counter()
    work = tempfile.mkdtemp(prefix="zipkin-sharded-daemon-")
    try:
        cfg = full_config(dev, scale.shard_daemon_log2, scale.services)
        empty = ShardedSpanStore(2, cfg, device="cpu",
                                 registry=obs.Registry())
        try:
            checkpoint.save(empty, os.path.join(work, "ckpt"))
        finally:
            empty.close()
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    return work, time.perf_counter() - t


def sharded_daemon(torch, scale, device, traffic, env, live, snapshot):
    """The daemon with ``--shards 2 --wal-dir --checkpoint`` (and
    ``--use-pallas``) as a child, its two shards on the one card at the
    full configuration's widths with a ``2^shard_daemon_log2`` span ring
    a shard. The daemon's flags set no widths, so boot A restores the
    empty 2-shard snapshot ``snapshot`` (a ``Background`` running
    ``empty_fleet_snapshot``; a snapshot's geometry wins over the flags)
    and starts with an empty fresh log: it replays nothing, takes the
    daemon phase's Scribe traffic from 4 clients (one launch, 100 known
    traces, a corrupt entry; the first half beside the profiler's
    warm-up, the second under ``POST /debug/profile``, whose kernels
    must be one claim, one write and one flat histogram a shard step),
    reads ``shard_daemon_known`` of the known traces back equal to an
    oracle's, and is SIGKILLed. Boot B replays the whole log, reads them
    back, and SIGTERM saves and ends it with exit 0; boot C restores
    that snapshot, replays at most the lineage flush that follows the
    shutdown's save, and reads them back."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.api import ApiServer
    from zipkin_tpu_torch.query import QueryService
    from zipkin_tpu_torch.store.memory import InMemorySpanStore

    what = "sharded daemon"
    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    work, snapshot_s = snapshot.result(DAEMON_BOOT_S)
    ckpt, wal_dir = os.path.join(work, "ckpt"), os.path.join(work, "wal")
    known = traffic["known"][:scale.shard_daemon_known]
    oracle = InMemorySpanStore()
    for tr in traffic["known"]:
        oracle.apply(tr)
    oracle_svc = QueryService(oracle, coalesce_window_s=0.0)
    oracle_api = ApiServer(oracle_svc, self_trace=False,
                           registry=obs.Registry())
    out = {"shards": 2, "capacity_a_shard": 1 << scale.shard_daemon_log2,
           "empty_snapshot_s": snapshot_s}
    try:
        flags = ["--host", "127.0.0.1", "--use-pallas", "--shards", "2",
                 "--wal-dir", wal_dir, "--checkpoint", ckpt,
                 "--checkpoint-interval", "3600"]
        if not on_card:
            flags += ["--platform", "cpu"]

        # -- boot A: the empty fleet, Scribe traffic, then SIGKILL ---------
        d, base, scribe, out["boot_a"] = boot_daemon(
            torch, device, flags, env, "sharded boot A", live)
        if out["boot_a"]["replayed_records"]:
            fail(f"{what} boot A: replayed records from a fresh log")
        warm = warm_profiler(base, what)
        calls = traffic["calls"]
        half = len(calls) // 2
        corrupt = base64.b64encode(CORRUPT_ENTRY).decode()
        spans = [sum(m != corrupt for c in part for _, m in c)
                 for part in (calls[:half], calls[half:])]
        t0 = time.perf_counter()
        acks, retries = send_calls("127.0.0.1", scribe, calls[:half],
                                   what=what)
        first_s = time.perf_counter() - t0
        out["profiler_warmup_s"] = warm()
        cap, got = profile_during(base, what)
        t1 = time.perf_counter()
        more, more_retries = send_calls("127.0.0.1", scribe, calls[half:],
                                        what=what)
        second_s = time.perf_counter() - t1
        cap.join(timeout=300)
        status, _, body = got.get("resp", (None, None, b"{}"))
        if status != 200:
            fail(f"{what}: /debug/profile answered {status} {body[:200]!r}")
        prof = json.loads(body)
        try:
            with open(os.path.join(prof["profileDir"], "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(prof["profileDir"], ignore_errors=True)
        seq = kernel_sequence(events)
        steps = steps_in(seq, what) if on_card else 0
        if on_card and steps < 1:
            fail(f"{what}: the profile holds no whole shard step "
                 f"({len(events)} events)")
        launches = {"flat_histogram": seq.count("H"),
                    "arena_claim": seq.count("C"),
                    "arena_write": seq.count("W"), "paged_page_gather": 0}
        t = time.perf_counter()
        n_known = known_reads_equal(base, oracle_api, known,
                                    f"{what} boot A")
        out["traffic"] = {
            "spans": spans[0], "send_s": first_s,
            "beside_profiler_warmup": True,
            "scribe_spans_per_s": spans[0] / first_s,
            "ack_ms_p50": float(np.percentile(acks, 50)),
            "ack_ms_p99": float(np.percentile(acks, 99)),
            "profiled_half": {
                "spans": spans[1], "send_s": second_s,
                "scribe_spans_per_s": spans[1] / second_s},
            "try_later": retries + more_retries,
            "profiled_steps": steps, "profiled_launches": launches,
            "known_reads": n_known,
            "known_reads_s": time.perf_counter() - t}
        d.signal(signal.SIGKILL)
        d.wait_exit(120)

        # -- boot B: the whole log replays; SIGTERM saves ----------------
        d, base, scribe, out["boot_b"] = boot_daemon(
            torch, device, flags, env, "sharded boot B", live)
        b = out["boot_b"]
        if b["replayed_records"] < 1:
            fail(f"{what} boot B: nothing replayed after the SIGKILL")
        b["replayed_spans_per_s"] = (b["replayed_spans"] / b["replay_s"]
                                     if b["replay_s"] else None)
        known_reads_equal(base, oracle_api, known, f"{what} boot B")
        t = time.perf_counter()
        d.signal(signal.SIGTERM)
        rc = d.wait_exit(DAEMON_EXIT_S)
        out["sigterm_to_exit_s"] = time.perf_counter() - t
        if rc != 0 or any("Traceback" in line for _, line in d.lines):
            fail(f"{what}: exit {rc} after SIGTERM; its output:\n"
                 f"{d.tail()}")

        # -- boot C: the saved snapshot --------------------------------------
        d, base, scribe, out["boot_c"] = boot_daemon(
            torch, device, flags, env, "sharded boot C", live)
        # The shutdown flushes the lineage tracker after its checkpoint,
        # so at most that one record lies past the snapshot.
        if out["boot_c"]["replayed_records"] > 1:
            fail(f"{what} boot C: replayed "
                 f"{out['boot_c']['replayed_records']} records after a "
                 f"graceful shutdown")
        known_reads_equal(base, oracle_api, known, f"{what} boot C")
        d.signal(signal.SIGKILL)
        d.wait_exit(120)
    finally:
        for d in live:
            d.kill()
        oracle_svc.close()
        shutil.rmtree(work, ignore_errors=True)
    out["kernel_launches"] = launches
    out["ingest_steps"] = steps
    out["s"] = time.perf_counter() - t_phase
    log(f"{what} result: " + json.dumps(out))
    return out


def daemon_path(torch, K, scale, device, boot, traffic, snapshot):
    """The port's daemon as a process, ``python -m zipkin_tpu_torch.main.
    example``, booted from ``durability_path``'s full-width snapshot and
    log with the daemon's flags (``--use-pallas --cold-tier
    --capture-backlog 4 --wal-dir --checkpoint``, the rest at its
    defaults) and driven over its own sockets: boot A replays exactly the
    records past the snapshot and reads back what the recovered store
    answered; four Scribe clients send a launch of spans, 100 known
    traces and one corrupt entry (acked after the durable append) while
    ``POST /debug/profile`` captures the card, whose kernels must be one
    arena claim, one arena write and one flat histogram a step; the known
    traces read back equal to an oracle server's; SIGTERM ends it with
    exit 0 after the ordered shutdown; boot B from the snapshot that
    shutdown saved reads the known traces back; 20 more known traces
    are acked and the child is SIGKILLed; boot C replays the tail and
    reads back every acked trace. Meanwhile ``main.tracegen`` runs as
    two children (the card store and ``--memory-store``), each exit 0,
    and ``sharded_daemon`` runs its three boots on a thread of its own.
    The children load the kernels this script built (nvcc is out of
    their reach) and leave the libraries as they were."""
    import glob

    from zipkin_tpu_torch import native, obs
    from zipkin_tpu_torch.api import ApiServer
    from zipkin_tpu_torch.ingest import ResultCode
    from zipkin_tpu_torch.ingest.scribe_server import ScribeClient
    from zipkin_tpu_torch.query import QueryService
    from zipkin_tpu_torch.store.memory import InMemorySpanStore
    from zipkin_tpu_torch.wire.thrift import span_to_scribe_message

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    work = boot["work"]
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    if on_card:
        # No toolkit in reach: a child that tried to build a kernel
        # would fail, so the boots prove it loads the built libraries.
        env["CUDA_HOME"] = os.path.join(work, "no-cuda-toolkit")
    if not native.available():
        fail("daemon path: the port's native codec did not build")
    libs = {p: os.stat(p).st_mtime_ns for p in glob.glob(
        os.path.join(HERE, "build", "zipkin_tpu_torch", "*.so"))}
    flags = ["--host", "127.0.0.1", "--use-pallas", "--cold-tier",
             "--capture-backlog", "4", "--wal-dir", boot["wal_dir"],
             "--checkpoint", boot["ckpt"], "--checkpoint-interval", "3600"]
    if not on_card:
        flags += ["--platform", "cpu"]
    # The standby follows boot A from a copy of the same snapshot: the
    # primary's log begins after it, so the standby needs that base.
    ship_port = free_port()
    standby_ckpt = os.path.join(work, "standby-ckpt")
    shutil.copytree(boot["ckpt"], standby_ckpt)
    follower_flags = ["--host", "127.0.0.1", "--follow",
                      f"127.0.0.1:{ship_port}", "--follow-mode", "standby",
                      "--follower-name", FOLLOWER_NAME, "--checkpoint",
                      standby_ckpt, "--checkpoint-interval", "3600"]
    if not on_card:
        follower_flags += ["--platform", "cpu"]
    tracegens = [(extra, subprocess.Popen(
        [sys.executable, "-m", "zipkin_tpu_torch.main.tracegen", *extra],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True))
        for extra in ([], ["--memory-store"]) if on_card or extra]
    oracle = InMemorySpanStore()
    for tr in traffic["known"]:
        oracle.apply(tr)
    oracle_svc = QueryService(oracle, coalesce_window_s=0.0)
    oracle_api = ApiServer(oracle_svc, self_trace=False,
                           registry=obs.Registry())
    live, sharded_live = [], []
    # The sharded daemon's boots run beside this daemon's (they share
    # the card and the host).
    sharded = Background("sharded-daemon", sharded_daemon, torch, scale,
                         device, traffic, env, sharded_live, snapshot)
    out = {"spans_sent": traffic["sent"], "log_calls": len(traffic["calls"])}
    try:
        # -- boot A: the durability snapshot plus the log's tail ---------
        d, base, scribe, out["boot_a"] = boot_daemon(
            torch, device, flags + ["--ship-port", str(ship_port)], env,
            "boot A", live)
        # -- the standby follower beside it: it restores while boot A
        # reads and takes the traffic, and catches up after ------------
        fd, fport = spawn_follower(follower_flags, env, live)
        want = boot["records_past_snapshot"]
        if out["boot_a"]["replayed_records"] != want:
            fail(f"daemon boot A: replayed "
                 f"{out['boot_a']['replayed_records']} records, {want} lie "
                 f"past the snapshot")
        # The daemon's first profiler start takes seconds (the card's
        # tracing is set up then) while the route already answers 409:
        # a capture started cold can open after the traffic it was to
        # hold. One short capture beside the boot reads pays that start.
        warm = warm_profiler(base, "daemon path")
        t = time.perf_counter()
        out["boot_a"]["reads_compared"] = boot_reads_equal(
            base, boot["answers"], "daemon boot A")
        out["boot_a"]["reads_s"] = time.perf_counter() - t
        out["profiler_warmup_s"] = warm()

        # -- Scribe traffic, profiled in its second half ---------------------
        # The first half runs with no capture: its rate and ack tail are
        # the daemon's. The second half runs under the torch.profiler
        # capture; beside the first, it is the profiler's cost.
        calls = traffic["calls"]
        half = len(calls) // 2
        corrupt = base64.b64encode(CORRUPT_ENTRY).decode()
        spans = [sum(m != corrupt for c in part for _, m in c)
                 for part in (calls[:half], calls[half:])]
        t0 = time.perf_counter()
        acks, retries = send_calls("127.0.0.1", scribe, calls[:half],
                                   what="daemon path")
        first_s = time.perf_counter() - t0
        cap, got = profile_during(base, "daemon path")
        t1 = time.perf_counter()
        more, more_retries = send_calls("127.0.0.1", scribe, calls[half:],
                                        what="daemon path")
        second_s = time.perf_counter() - t1
        cap.join(timeout=300)
        profile_wait_s = time.perf_counter() - t1 - second_s
        status, _, body = got.get("resp", (None, None, b"{}"))
        if status != 200:
            fail(f"daemon path: /debug/profile answered {status} "
                 f"{body[:200]!r}")
        prof = json.loads(body)
        try:
            with open(os.path.join(prof["profileDir"], "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(prof["profileDir"], ignore_errors=True)
        seq = kernel_sequence(events)
        steps = steps_in(seq, "daemon path") if on_card else 0
        if on_card and steps < 1:
            fail(f"daemon path: the profile holds no whole ingest step "
                 f"({len(events)} events)")
        launches = {"flat_histogram": seq.count("H"),
                    "arena_claim": seq.count("C"),
                    "arena_write": seq.count("W"), "paged_page_gather": 0}
        status, mj = http_json(base, "/metrics", {"format": "json"})
        if status != 200 or mj.get("store.scatter_path_pallas") != 1:
            fail(f"daemon path: /metrics?format=json shows "
                 f"store.scatter_path_pallas "
                 f"{mj.get('store.scatter_path_pallas')}")
        t = time.perf_counter()
        n_known = known_reads_equal(base, oracle_api, traffic["known"],
                                    "daemon path (known traces)")
        known_s = time.perf_counter() - t
        # -- the standby caught up: zero lag, the known traces over HTTP ---
        fd, fbase, out["follower"] = await_follower(
            fd, fport, follower_flags, env, live)
        wait_s, doc, primary_doc = follower_current(base, fbase,
                                                    "daemon follower")
        t_f = time.perf_counter()
        known_reads_equal(fbase, oracle_api, traffic["known"],
                          "daemon path (standby follower)")
        out["follower"].update({
            "current_after_traffic_s": wait_s,
            "known_reads_s": time.perf_counter() - t_f,
            "applied_seq": doc["appliedSeq"],
            "primary_durable_seq": primary_doc["durableSeq"],
            "applied_records": doc["appliedRecords"],
            "fetched_bytes": doc["fetchedBytes"],
            "lag_seconds": doc["lagSeconds"]})
        out["traffic"] = {
            "spans": spans[0], "send_s": first_s,
            "scribe_spans_per_s": spans[0] / first_s,
            "ack_ms_p50": float(np.percentile(acks, 50)),
            "ack_ms_p99": float(np.percentile(acks, 99)),
            "profiled_half": {
                "spans": spans[1], "send_s": second_s,
                "scribe_spans_per_s": spans[1] / second_s,
                "ack_ms_p50": float(np.percentile(more, 50)),
                "ack_ms_p99": float(np.percentile(more, 99))},
            "try_later": retries + more_retries,
            "profile_s": prof["seconds"], "profile_events": len(events),
            "profile_wait_after_send_s": profile_wait_s,
            "profiled_steps": steps, "profiled_launches": launches,
            "known_reads": n_known, "known_reads_s": known_s,
            "collector_spans_stored": mj.get("collector.spans_stored"),
            "store_batches": mj.get("store.batches")}
        log("daemon traffic: " + json.dumps(out["traffic"]))

        # -- SIGTERM to both: the ordered shutdowns, then exit 0 -------------
        t = time.perf_counter()
        fd.signal(signal.SIGTERM)
        d.signal(signal.SIGTERM)
        frc = fd.wait_exit(DAEMON_EXIT_S)
        out["follower"]["sigterm_to_exit_s"] = time.perf_counter() - t
        if frc != 0 or any("Traceback" in line for _, line in fd.lines):
            fail(f"daemon follower: exit {frc} after SIGTERM; its output:\n"
                 f"{fd.tail()}")
        rc = d.wait_exit(DAEMON_EXIT_S)
        out["sigterm_to_exit_s"] = time.perf_counter() - t
        if rc != 0 or any("Traceback" in line for _, line in d.lines):
            fail(f"daemon path: exit {rc} after SIGTERM; its output:\n"
                 f"{d.tail()}")
        log(f"daemon path: SIGTERM to exit 0 in "
            f"{out['sigterm_to_exit_s']:.1f} s")

        # -- boot B: the snapshot the shutdown saved (tiered now) ------------
        d, base, scribe, out["boot_b"] = boot_daemon(
            torch, device, flags, env, "boot B", live)
        # The shutdown flushes the lineage tracker after its checkpoint
        # (as the reference's does), so at most that one record lies past
        # the snapshot.
        if out["boot_b"]["replayed_records"] > 1:
            fail(f"daemon boot B: replayed "
                 f"{out['boot_b']['replayed_records']} records after a "
                 f"graceful shutdown")
        known_reads_equal(base, oracle_api, traffic["known"],
                          "daemon boot B")

        # -- a crash after 20 more acked known traces ------------------------
        late = cold_known(DAEMON_LATE_KNOWN, 42, WIN_BASE_US + (
            traffic["first_launch"] + 2) * WIN_STEP_US)
        client = ScribeClient("127.0.0.1", scribe, timeout_s=120.0)
        try:
            code = client.log([("zipkin", span_to_scribe_message(s))
                               for tr in late for s in tr])
        finally:
            client.close()
        if code is not ResultCode.OK:
            fail(f"daemon path: the late known traces were answered {code}")
        for tr in late:
            oracle.apply(tr)
        d.signal(signal.SIGKILL)
        d.wait_exit(120)

        # -- boot C: the log's tail replays; every acked trace reads back ----
        d, base, scribe, out["boot_c"] = boot_daemon(
            torch, device, flags, env, "boot C", live)
        if out["boot_c"]["replayed_records"] < 1:
            fail("daemon boot C: no record replayed after the crash")
        known_reads_equal(base, oracle_api, traffic["known"] + late,
                          "daemon boot C")
        d.signal(signal.SIGKILL)
        d.wait_exit(120)

        # -- the tracegen children and the built libraries -------------------
        out["tracegen"] = {}
        for extra, proc in tracegens:
            try:
                text, _ = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                fail(f"tracegen {extra}: still running after 600 s")
            lines = text.splitlines()
            if proc.returncode != 0 or not lines or not lines[-1].endswith(
                    "-> OK"):
                fail(f"tracegen {extra}: exit {proc.returncode}:\n{text}")
            out["tracegen"][" ".join(extra) or "card"] = lines[-1]
        out["sharded"] = sharded.result(2 * DAEMON_BOOT_S + DAEMON_EXIT_S)
        now = {p: os.stat(p).st_mtime_ns for p in glob.glob(
            os.path.join(HERE, "build", "zipkin_tpu_torch", "*.so"))}
        if now != libs:
            fail("daemon path: a child rebuilt or added a kernel library")
    finally:
        for d in live + sharded_live:
            d.kill()
        for _, proc in tracegens:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=120)
        oracle_svc.close()
        shutil.rmtree(work, ignore_errors=True)
    out["kernel_launches"] = launches
    out["ingest_steps"] = steps
    out["s"] = time.perf_counter() - t_phase
    log("daemon path result: " + json.dumps(out))
    return out


def _lineage_checks(store, wal, reg, what):
    """Every sampled record of ``wal`` (its ``b3`` stamp) must read back
    from ``store`` as one trace: the ``ingest unit`` root with the
    stamp's span id and no parent, ``wal append`` and ``wal fsync``
    children parented on it, each tagged with the record's sequence;
    the stage sketch must have seen append and fsync once a unit."""
    from zipkin_tpu_torch.wal.record import unit_meta

    sampled = []
    records = 0
    for seq, payload in wal.replay(0):
        records += 1
        meta = unit_meta(payload)
        if "ts" not in meta:
            fail(f"{what}: record {seq} carries no lineage timestamp")
        if "b3" in meta:
            sampled.append((seq, int(meta["b3"][0]), int(meta["b3"][1])))
    if not sampled:
        fail(f"{what}: no record was sampled")
    want = {"ingest unit", "wal append", "wal fsync"}
    for seq, tid, sid in sampled:
        trace = (store.get_spans_by_trace_ids([tid]) or [[]])[0]
        names = sorted(s.name for s in trace)
        if sorted(want) != names:
            fail(f"{what}: the trace of record {seq} holds {names}")
        for s in trace:
            tags = {b.key: b.value for b in s.binary_annotations}
            if s.trace_id != tid or tags.get("wal.seq") != str(seq):
                fail(f"{what}: span {s.name} of record {seq} has trace "
                     f"{s.trace_id} and tags {tags}")
            if s.name == "ingest unit":
                if s.id != sid or s.parent_id is not None:
                    fail(f"{what}: the root of record {seq} is {s.id} "
                         f"under {s.parent_id}, not {sid} at the top")
            elif s.parent_id != sid:
                fail(f"{what}: {s.name} of record {seq} has parent "
                     f"{s.parent_id}, not the root {sid}")
    stages = {}
    for suffix, labels, value in reg.get(
            "zipkin_lineage_stage_seconds").samples():
        if suffix == "_count":
            stages[dict(labels)["stage"]] = int(value)
    if (stages.get("append", 0) < len(sampled)
            or stages.get("fsync", 0) < len(sampled)):
        fail(f"{what}: the stage sketch saw {stages} for {len(sampled)} "
             f"sampled units")
    return {"records": records, "sampled_units": len(sampled),
            "stage_counts": stages}


def _federation_values(text, role=None):
    """(name, labels, value) of every sample line of a Prometheus text;
    with ``role``, only the lines labelled with it, the label dropped."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, value = line.rsplit(" ", 1)
        name, _, labels = head.partition("{")
        labels = labels.rstrip("}")
        if role is not None:
            tag = f'role="{role}"'
            if not labels.startswith(tag):
                continue
            labels = labels[len(tag):].lstrip(",")
        out.append((name, labels, value))
    return sorted(out)


def fleet_path(torch, K, dev, scale, device):
    """Fleet observability on the daemon's default store (full width,
    the window on, a WAL with the daemon's defaults): (a) lineage at
    ``sample_every=1`` through journaled launches, each sampled unit's
    trace read back from the card store with every parent id right,
    the flushes landing through ``store.apply`` (K1 and both K2 halves
    once a step, the flushes' steps included); (c) the watchdog behind
    ``ApiServer(QueryService(store), collector, fleet=FleetObs(...))``
    on a socket: ready, 503 with the reason while the log's fsync is
    parked, ready again, and exactly those two transitions in
    ``/debug/events``; (d) ``/metrics?fleet=1`` against the registry's
    own scrape, and ``/api/fleet``; then (b) the cost of lineage at the
    production cadence (1 in 64): two stores with logs at fsync=off,
    one with a tracker, the same launches in interleaved rounds, no
    kernel library loaded and K1/K2 launches a step equal on and off
    (the ratio is reported, not gated: the host is shared)."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.api import ApiServer
    from zipkin_tpu_torch.ingest import Collector
    from zipkin_tpu_torch.obs import fleet as fobs
    from zipkin_tpu_torch.query import QueryService
    from zipkin_tpu_torch.sampler import Sampler
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen
    from zipkin_tpu_torch.wal import WriteAheadLog
    from zipkin_tpu_torch.wal.record import unit_meta

    cfg = full_config(dev, scale.cap_log2, scale.services, **WINDOW)
    free_card(torch, device)
    work = tempfile.mkdtemp(prefix="zipkin-fleet-")
    result = {}
    try:
        # -- (a) lineage round trip at sample_every=1 ---------------------
        t = time.perf_counter()
        reg = obs.Registry()
        store = TorchSpanStore(cfg, device=device.type, registry=reg)
        gen = ColumnarTraceGen(store.dicts, n_services=scale.services,
                               n_span_names=scale.names, topology=True,
                               seed=23)
        wal = WriteAheadLog(os.path.join(work, "wal"), fsync="interval",
                            interval_s=0.05, segment_bytes=64 << 20,
                            registry=reg)
        store.attach_wal(wal)
        flush_threads = []

        def sink(spans):
            flush_threads.append((threading.current_thread().name,
                                  len(spans)))
            store.apply(spans)

        tracker = fobs.LineageTracker(sink, registry=reg, sample_every=1)
        # Flush every two units' spans, so the group-commit thread's
        # on_durable flushes into the store while launches go on.
        tracker.FLUSH_AT = 6
        store.attach_lineage(tracker)
        # Seen durable callbacks, to know when the group-commit thread's
        # last one (and the flush it ran) has returned.
        done = []

        def observed(seq):
            tracker.on_durable(seq)
            done.append(seq)

        wal.set_on_durable(observed)
        steps0 = store.counter_block()["batches"]
        K.reset_launches()
        for i in range(scale.fleet_launches):
            batch, _, ix = gen.next_batch(
                scale.batch_traces, base_ts=WIN_BASE_US + i * WIN_STEP_US)
            store.write_batch(batch, ix)
        wal.sync()
        tracker.flush()
        wal.sync()
        deadline = time.monotonic() + 60
        while not (done and done[-1] >= wal.last_seq):
            if time.monotonic() > deadline:
                fail(f"fleet path: durable callbacks stuck at {done[-1:]}"
                     f" with {wal.last_seq} records")
            time.sleep(0.01)
        sync(torch, device)
        # ``wal.sync()`` fires the durable callback on this thread, so
        # ``done`` can reach the last record while the group-commit
        # thread's own flush (its ``store.apply``) is still stepping:
        # read the launches and the steps in one hold of the write lock,
        # which an apply holds through its journal and its step.
        with store._lock:
            launches = dict(K.LAUNCHES)
            steps = store.counter_block()["batches"] - steps0
        check_launches(launches, ("flat_histogram", "arena_claim",
                                  "arena_write"), device, "fleet", steps)
        if device.type == "cuda" and not (
                launches["arena_claim"] == launches["arena_write"]
                == steps):
            fail(f"fleet path: arena halves {launches} in {steps} steps")
        if steps <= scale.fleet_launches:
            fail(f"fleet path: {steps} steps for {scale.fleet_launches} "
                 f"launches: no lineage flush reached the store")
        lin = _lineage_checks(store, wal, reg, "fleet path")
        result["lineage"] = {
            **lin, "launches": scale.fleet_launches, "ingest_steps": steps,
            "flushes": flush_threads,
            "wal_records": wal.last_seq,
            "s": time.perf_counter() - t}
        result["kernel_launches"] = launches
        result["ingest_steps"] = steps

        # -- (c) the watchdog over a socket; (d) federation ---------------
        t = time.perf_counter()
        recorder = fobs.FlightRecorder()
        watchdog = fobs.Watchdog(recorder=recorder, registry=reg)
        watchdog.add_probe("pipeline", fobs.pipeline_stall_probe(store))
        watchdog.add_probe("sealer", fobs.sealer_backlog_probe(store))
        watchdog.add_probe("wal_fsync", fobs.fsync_parked_probe(wal))
        fleet = fobs.FleetObs(role="primary", registry=reg,
                              tracker=tracker, watchdog=watchdog,
                              recorder=recorder)
        collector = Collector(store, sampler=Sampler(1.0), max_queue=500,
                              concurrency=10, self_trace=True,
                              registry=reg)
        query = QueryService(store)
        api = ApiServer(query, collector, registry=obs.Registry(),
                        fleet=fleet)
        # No span may land while the fsync error is parked: a group
        # commit with work to do would clear it.
        api.tracer.sample_rate = 0.0
        server, thread, base = serve_api(api)
        try:
            health = []
            for parked in (None, RuntimeError("injected fsync stall"),
                           None):
                with wal._cond:
                    wal._sync_error = parked
                status, _, body = http_call(base + "/api/health")
                health.append((status, json.loads(body)))
            want = [200, 503, 200]
            if [s for s, _ in health] != want:
                fail(f"fleet path: /api/health answered "
                     f"{[s for s, _ in health]}, not {want}: {health}")
            reasons = health[1][1]["reasons"]
            if (health[1][1]["ready"] or len(reasons) != 1
                    or reasons[0]["probe"] != "wal_fsync"
                    or reasons[0]["reason"]
                    != "wal fsync parked: injected fsync stall"):
                fail(f"fleet path: the parked health was {health[1]}")
            status, _, body = http_call(base + "/debug/events")
            events = [(e["kind"], e["fields"].get("probe"))
                      for e in json.loads(body)["events"]]
            if status != 200 or events != [("watchdog_trip", "wal_fsync"),
                                           ("watchdog_clear", "wal_fsync")]:
                fail(f"fleet path: /debug/events answered {status} "
                     f"{events}")
            status, _, body = http_call(base + "/metrics?fleet=1")
            own = reg.render_text()
            fed = body.decode("utf-8")
            if status != 200 or (_federation_values(fed, "primary")
                                 != _federation_values(own)):
                fail("fleet path: /metrics?fleet=1 differs from the "
                     "registry's own scrape")
            status, _, body = http_call(base + "/api/fleet")
            doc = json.loads(body)
            merged = doc.get("merged", {}).get(
                "zipkin_lineage_stage_seconds")
            stage_n = sum(lin["stage_counts"].values())
            if (status != 200 or doc["processes"] != [{"role": "primary"}]
                    or merged is None or merged["count"] != stage_n
                    or not doc["health"]["ready"]):
                fail(f"fleet path: /api/fleet answered {status} {doc}")
        finally:
            with wal._cond:
                wal._sync_error = None
            stop_api(server, thread)
            collector.close()
            query.close()
        result["watchdog"] = {
            "health_status": [s for s, _ in health],
            "parked_reason": reasons[0]["reason"], "events": events,
            "federated_samples": len(_federation_values(own)),
            "fleet_merged_count": merged["count"],
            "s": time.perf_counter() - t}
        wal.close()
        del store, tracker, api, fleet
        free_card(torch, device)

        # -- (b) the cost of lineage at 1 in 64 ---------------------------
        t = time.perf_counter()
        stores, drives = {}, {}
        for mode in ("off", "on"):
            s = TorchSpanStore(cfg, device=device.type,
                               registry=obs.Registry())
            w = WriteAheadLog(os.path.join(work, f"wal-{mode}"),
                              fsync="off", segment_bytes=64 << 20,
                              registry=obs.Registry())
            s.attach_wal(w)
            if mode == "on":
                s.attach_lineage(fobs.LineageTracker(
                    s.apply, registry=obs.Registry()))
            g = ColumnarTraceGen(s.dicts, n_services=scale.services,
                                 n_span_names=scale.names, topology=True,
                                 seed=29)
            drives[mode] = [[g.next_batch(scale.batch_traces,
                                          base_ts=WIN_BASE_US
                                          + (r * 8 + i) * WIN_STEP_US)
                             for i in range(scale.fleet_round)]
                            for r in range(scale.fleet_rounds + 1)]
            stores[mode] = (s, w)

        def drive(mode, r):
            s = stores[mode][0]
            steps0 = s.counter_block()["batches"]
            launched = dict(K.LAUNCHES)
            t0 = time.perf_counter()
            for batch, _, ix in drives[mode][r]:
                s.write_batch(batch, ix)
            sync(torch, device)
            took = time.perf_counter() - t0
            n = s.counter_block()["batches"] - steps0
            per = {k: (K.LAUNCHES[k] - launched[k]) / n for k in (
                "flat_histogram", "arena_claim", "arena_write")}
            return took, per

        drive("off", 0)
        drive("on", 0)  # warm: every pad bucket both stores will hit
        libs0 = K.compile_count(K.SOURCES)
        times = {"off": [], "on": []}
        per_step = {"off": [], "on": []}
        for r in range(1, scale.fleet_rounds + 1):
            for mode in ("off", "on"):
                took, per = drive(mode, r)
                times[mode].append(took)
                per_step[mode].append(per)
        libs = K.compile_count(K.SOURCES) - libs0
        if libs:
            fail(f"fleet path: {libs} kernel libraries loaded during the "
                 f"timed rounds")
        if per_step["on"] != per_step["off"]:
            fail(f"fleet path: launches a step with lineage "
                 f"{per_step['on']} vs without {per_step['off']}")
        on_store = stores["on"][0]
        t_on, t_off = min(times["on"]), min(times["off"])
        records = [unit_meta(p) for _, p in stores["on"][1].replay(0)]
        result["overhead"] = {
            "overhead_ratio": t_on / t_off,
            "reference_bound": 1.05,
            "lineage_on_s": t_on, "lineage_off_s": t_off,
            "rounds_on_s": times["on"], "rounds_off_s": times["off"],
            "launches_per_round": scale.fleet_round,
            "spans_per_launch": scale.batch_traces * 7,
            "launches_per_step": per_step["on"][0],
            "kernel_libraries_loaded": libs,
            "sampled_units": sum("b3" in m for m in records),
            "stamped_records": sum("ts" in m for m in records),
            "tracker_pending": on_store.lineage.pending(),
            "s": time.perf_counter() - t}
        for s, w in stores.values():
            w.close()
        del stores, on_store
        log("fleet path result: " + json.dumps(result))
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# Replication: WAL shipping, a warm standby on the card, the replica
# ---------------------------------------------------------------------------

REPLICATION_IO_S = 120.0
# The replica seals each record in host Python (~37-50 us a span,
# PERF.md section 5): ~5 s a 114,688-span record, so it trails the
# standby by design and its waits are sized for it.
REPLICATION_DRAIN_S = 600.0
REPLICATION_READ_END = 2**62


def _timed(fn, into, sync_fn=None):
    """``fn`` wrapped so each call appends its host seconds to ``into``
    (after ``sync_fn`` when given: the card's work is inside)."""
    def timed(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        if sync_fn is not None:
            sync_fn()
        into.append(time.perf_counter() - t)
        return out
    return timed


def _stamped(fn, into):
    """``fn`` wrapped so each call that returns appends the host clock
    at its return to ``into``."""
    def stamped(*a, **kw):
        out = fn(*a, **kw)
        into.append(time.perf_counter())
        return out
    return stamped


def _drain(f, wal, what, timeout_s=REPLICATION_DRAIN_S):
    """``Follower.drain`` until ``f`` has applied ``wal``'s last record
    (a fetch that began before a drain call can end after it with
    nothing, so one drain may return early): the seconds waited."""
    t = time.perf_counter()
    while True:
        left = timeout_s - (time.perf_counter() - t)
        if left <= 0 or not f.drain(left):
            fail(f"{what}: not current within {timeout_s} s: {f.status()}")
        if f.status()["appliedSeq"] >= wal.last_seq:
            return time.perf_counter() - t


def _three_way_reads(store, tids, mirrored):
    """The reads a replication follower must answer as its primary does:
    the known traces (on services of their own, past ``max_services``)
    by id, by name and their quantiles, the service catalog and the HLL,
    and the span-name catalog, quantiles and top-k rows of ``mirrored``
    services (inside ``max_services``). A replica answers the last two
    for a service past ``max_services`` from its segments (span names,
    even past ``max_span_names``) or not at all (top-k), where a device
    store scans its catalog, as the reference's replica does; and the
    name lookups stay on the known services, whose answers are exact on
    both tiers (the stream's traces are held to an oracle nowhere)."""
    end = REPLICATION_READ_END
    out = {"rows": store.get_spans_by_trace_ids(tids),
           "exist": sorted(store.traces_exist(tids)),
           "durations": store.get_traces_duration(tids),
           "services": sorted(store.get_all_service_names()),
           "hll": store.estimated_unique_traces()}
    for svc in COLD_SERVICES:
        out[svc] = (store.get_trace_ids_by_name(svc, None, end, 20),
                    store.service_duration_quantiles(svc, [0.5, 0.95, 0.99]))
    for svc in mirrored:
        out[f"sketch {svc}"] = (
            sorted(store.get_span_names(svc)),
            store.service_duration_quantiles(svc, [0.5, 0.95, 0.99]),
            store.top_annotations(svc), store.top_binary_keys(svc))
    out["by_span_name"] = store.get_trace_ids_by_name(
        COLD_SERVICES[1], COLD_OPS[3], end, 20)
    out["by_annotation"] = store.get_trace_ids_by_annotation(
        COLD_SERVICES[2], "http.uri", b"/api/widgets", end, 20)
    return out


def _lineage_of_followers(store, wal, what):
    """Every sampled record's trace, read back from the primary, holds
    a ``ship`` child for each follower and the ``standby apply`` and
    ``replica apply`` children the followers backhauled, all under the
    record's root."""
    from zipkin_tpu_torch.wal.record import unit_meta

    sampled = [(seq, int(m["b3"][0]), int(m["b3"][1]))
               for seq, m in ((s, unit_meta(p)) for s, p in wal.replay(0))
               if "b3" in m]
    if not sampled:
        fail(f"{what}: no record was sampled")
    want = ["ingest unit", "replica apply", "ship", "ship",
            "standby apply", "wal append", "wal fsync"]
    for seq, tid, sid in sampled:
        trace = (store.get_spans_by_trace_ids([tid]) or [[]])[0]
        names = sorted(s.name for s in trace)
        if names != want:
            fail(f"{what}: the trace of record {seq} holds {names}")
        for s in trace:
            if s.name != "ingest unit" and s.parent_id != sid:
                fail(f"{what}: {s.name} of record {seq} has parent "
                     f"{s.parent_id}, not the root {sid}")
        ships = sorted(dict((b.key, b.value) for b in s.binary_annotations)
                       .get("follower", "") for s in trace
                       if s.name == "ship")
        if ships != ["replica", "standby"]:
            fail(f"{what}: record {seq} was shipped to {ships}")
    return len(sampled)


def replication_path(torch, K, dev, scale, device):
    """Replication at full width on the daemon's default store (the
    window on): a primary on the card with a WAL at the daemon's fsync
    interval and lineage at 1 in 64 serves a ``ShipServer`` on
    127.0.0.1; a warm standby on the same card (a second store built
    from HELLO's config, replaying every shipped record through the
    commit body and so through K1 and both K2 halves) and a device-free
    replica (host-only by the reference's design) follow it. Four
    journaled launches and 100 known traces, then both drained: the
    standby's state equals the primary's (moments within stated
    tolerance 2), the replica's mirror equals the primary's device
    aggregates bitwise, the reads agree three ways, every standby step
    launched each kernel once, and each sampled record's trace holds
    ``ship`` and the followers' apply children. Then the ship server is
    closed and rebound with both connections dropped (both followers
    reconnect without an anchor), the standby is promoted and takes one
    launch, and a late replica whose cursor precedes the retained log
    bootstraps from an anchor equal to the primary's mirror."""
    import socket

    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.obs import fleet as fobs
    from zipkin_tpu_torch.replicate import (Follower, ReplicaTarget,
                                            ShipClient, ShipServer,
                                            StandbyTarget, WalShipper)
    from zipkin_tpu_torch.replicate.protocol import config_from_dict
    from zipkin_tpu_torch.store import replica as replica_mod
    from zipkin_tpu_torch.store.replica import ReplicaSpanStore
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.testing.crash import state_mismatches
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen
    from zipkin_tpu_torch.wal import WriteAheadLog

    t_phase = time.perf_counter()
    cfg = full_config(dev, scale.cap_log2, scale.services, **WINDOW)
    free_card(torch, device)
    work = tempfile.mkdtemp(prefix="zipkin-replication-")
    closers = []
    seal_orig = replica_mod.seal_segment
    out = {"spans_per_launch": scale.batch_traces * 7}
    what = "replication path"

    def card_sync():
        sync(torch, device)

    try:
        reg = obs.Registry()
        primary = TorchSpanStore(cfg, device=device.type, registry=reg)
        # The daemon's log defaults and its lineage cadence (1 in 64).
        wal = WriteAheadLog(os.path.join(work, "wal"), fsync="interval",
                            interval_s=0.05, segment_bytes=64 << 20,
                            registry=reg)
        closers.append(wal.close)
        primary.attach_wal(wal)
        tracker = fobs.LineageTracker(primary.apply, registry=reg)
        primary.attach_lineage(tracker)
        # Seen durable callbacks: the group-commit thread emits a unit's
        # ``wal fsync`` span after the frontier moves (and the followers
        # may fetch before it does), so the lineage flush below waits
        # for the callback of the last record.
        durable_seen = []

        def observed(seq):
            tracker.on_durable(seq)
            durable_seen.append(seq)

        wal.set_on_durable(observed)
        shipper = WalShipper(primary, registry=reg, tracker=tracker)
        closers.append(shipper.close)
        servers = [ShipServer(shipper, "127.0.0.1", 0,
                              io_timeout_s=REPLICATION_IO_S)]
        servers[0].serve_in_thread()
        port = servers[0].server_address[1]
        closers.append(lambda: [(s.shutdown(), s.server_close())
                                for s in servers])

        def follow(name, mode, target_of):
            freg = obs.Registry()
            client = ShipClient("127.0.0.1", port, name, mode=mode,
                                timeout_s=REPLICATION_IO_S)
            config = config_from_dict(client.connect()["config"])
            if config != cfg:
                fail(f"{what}: HELLO's config {config} is not the "
                     f"primary's")
            target = target_of(config)
            f = Follower(target, client, poll_interval_s=0.005,
                         registry=freg,
                         lineage=fobs.FollowerLineage(name, mode=mode,
                                                      registry=freg))
            closers.append(f.close)
            fetches = []

            def timed_fetch(*a, _fetch=client.fetch, **kw):
                t = time.perf_counter()
                got = _fetch(*a, **kw)
                if got and got[0]:
                    fetches.append((time.perf_counter() - t, len(got[0]),
                                    sum(len(p) for _, p in got[0])))
                return got

            client.fetch = timed_fetch
            return f, freg, fetches

        # -- the standby on the card and the replica on the host ----------
        standby_apply_s = []
        standby = None

        def standby_target(config):
            nonlocal standby
            standby = TorchSpanStore(config, device=device.type,
                                     registry=obs.Registry())
            target = StandbyTarget(standby)
            target.apply = _timed(target.apply, standby_apply_s, card_sync)
            return target

        replica_apply_s, replica_seal_s = [], []
        replica = None

        def replica_target(config):
            nonlocal replica
            replica = ReplicaSpanStore(config, background_compaction=False,
                                       registry=obs.Registry())
            closers.append(replica.close)
            target = ReplicaTarget(replica)
            target.apply = _timed(target.apply, replica_apply_s)
            replica.codec.decode = _timed(replica.codec.decode,
                                          replica_seal_s)
            return target

        replica_mod.seal_segment = _timed(seal_orig, replica_seal_s)
        f_sby, sreg, sby_fetches = follow("standby", "standby",
                                          standby_target)
        f_rep, rreg, rep_fetches = follow("replica", "replica",
                                          replica_target)
        replica_fold_s = timed_mirror(replica)
        K.reset_launches()
        f_sby.start()
        f_rep.start()

        # -- traffic: journaled launches and the known traces ------------
        gen = ColumnarTraceGen(primary.dicts, n_services=scale.services,
                               n_span_names=scale.names, topology=True,
                               seed=37)
        n = scale.replication_launches
        known = cold_known(scale.cold_known, 47,
                           WIN_BASE_US + (n + 1) * WIN_STEP_US)
        tids = sorted(tr[0].trace_id for tr in known)
        t = time.perf_counter()
        for i in range(n):
            batch, _, ix = gen.next_batch(
                scale.batch_traces, base_ts=WIN_BASE_US + i * WIN_STEP_US)
            primary.write_batch(batch, ix)
        card_sync()
        out["primary_write_s"] = time.perf_counter() - t
        primary.apply([s for tr in known for s in tr])
        primary.wal_sync()
        t_written = time.perf_counter()
        out["standby_drain_s"] = _drain(f_sby, wal, f"{what} (standby)")
        out["standby_visible_s"] = time.perf_counter() - t_written
        out["replica_drain_s"] = _drain(f_rep, wal, f"{what} (replica)")
        out["replica_visible_s"] = time.perf_counter() - t_written
        # The followers' apply spans came back on their last fetches;
        # flush them (one more record) once the last unit's fsync span is
        # out, and let both apply it.
        deadline = time.perf_counter() + REPLICATION_IO_S
        while not (durable_seen and durable_seen[-1] >= wal.last_seq):
            if time.perf_counter() > deadline:
                fail(f"{what}: durable callbacks stuck at "
                     f"{durable_seen[-1:]} with {wal.last_seq} records")
            time.sleep(0.01)
        tracker.flush()
        primary.wal_sync()
        _drain(f_sby, wal, f"{what} (standby)")
        _drain(f_rep, wal, f"{what} (replica)")
        card_sync()

        # -- the checks ---------------------------------------------------
        last = wal.last_seq
        for f, name in ((f_sby, "standby"), (f_rep, "replica")):
            st = f.status()
            if st["appliedSeq"] != last or st["lagRecords"] or st["error"]:
                fail(f"{what}: the {name} is not at seq {last}: {st}")
        primary_steps = primary.counter_block()["batches"]
        standby_steps = standby.counter_block()["batches"]
        launches = dict(K.LAUNCHES)
        if standby_steps != primary_steps:
            fail(f"{what}: the standby took {standby_steps} steps for "
                 f"the primary's {primary_steps}")
        kernels = ("flat_histogram", "arena_claim", "arena_write")
        if device.type == "cuda" and any(
                launches[k] != primary_steps + standby_steps
                for k in kernels):
            fail(f"{what}: {launches} launches for {primary_steps} primary "
                 f"and {standby_steps} standby steps, not one of each "
                 f"kernel a step")
        if device.type == "cuda" and launches["paged_page_gather"]:
            fail(f"{what}: a ring store launched the page gather")
        # The standby's share: the launches less the primary's steps.
        out["kernel_launches"] = {
            k: (v - primary_steps if device.type == "cuda" and k in kernels
                else v)
            for k, v in launches.items()}
        out["ingest_steps"] = standby_steps
        if standby.counters()["scatter_path_pallas"] != 1.0:
            fail(f"{what}: the standby's steps took the plain route")
        t = time.perf_counter()
        bad = state_mismatches(primary.state, standby.state,
                               moments_tolerance=True)
        if bad:
            fail(f"{what}: the standby's state differs from the "
                 f"primary's: {bad}")
        if standby.counter_block() != primary.counter_block():
            fail(f"{what}: the standby's counter block differs")
        for name, got in zip(WINDOW_LEAVES, replica.sketch_mirror.arrays()):
            leaf = primary.state.leaves[name].cpu().numpy()
            if got.dtype != leaf.dtype or not np.array_equal(got, leaf):
                fail(f"{what}: the replica's mirror {name} differs from "
                     f"the primary's device leaf")
        out["state_compare_s"] = time.perf_counter() - t
        replica_split = (sum(replica_apply_s), sum(replica_fold_s),
                         sum(replica_seal_s), len(replica_apply_s),
                         replica.counters()["replica_spans_applied"])
        t = time.perf_counter()
        mirrored = sorted(
            svc for svc in primary.get_all_service_names()
            if primary._svc_id(svc) < cfg.max_services)[:4]
        want = _three_way_reads(primary, tids, mirrored)
        out["reads_s"] = {"primary": time.perf_counter() - t}
        if not all(want[f"sketch {svc}"][2] for svc in mirrored):
            fail(f"{what}: no top annotations to compare")
        for name, store in (("standby", standby), ("replica", replica)):
            t = time.perf_counter()
            got = _three_way_reads(store, tids, mirrored)
            out["reads_s"][name] = time.perf_counter() - t
            for k, v in want.items():
                if got[k] != v:
                    fail(f"{what}: the {name}'s {k} differs from the "
                         f"primary's: {str(got[k])[:1500]} against "
                         f"{str(v)[:1500]}")
        if not want["rows"] or not any(want[s][0] for s in COLD_SERVICES):
            fail(f"{what}: the reads compared nothing")
        out["sampled_records"] = _lineage_of_followers(primary, wal, what)

        # -- what moved -------------------------------------------------------
        def shipped(fetches):
            secs = sum(s for s, _, _ in fetches)
            recs = sum(r for _, r, _ in fetches)
            nbytes = sum(b for _, _, b in fetches)
            return {"records": recs, "bytes": nbytes, "fetch_s": secs,
                    "records_per_s": recs / secs,
                    "mb_per_s": nbytes / secs / 1e6}

        def lag(freg):
            p50, p99 = freg.get(
                "zipkin_replication_visible_lag_seconds").quantile_values(
                    [0.5, 0.99])
            return {"p50_s": p50, "p99_s": p99}

        applied_spans = standby.counter_block()["spans_seen"]
        apply_s, fold_s, seal_s, records, rep_spans = replica_split
        out.update({
            "records": last, "wal_bytes": wal.stats()["wal_bytes"],
            "shipped": {"standby": shipped(sby_fetches),
                        "replica": shipped(rep_fetches)},
            "visible_lag": {"standby": lag(sreg), "replica": lag(rreg)},
            "primary_write_spans_per_s": (
                n * scale.batch_traces * 7 / out["primary_write_s"]),
            "standby_apply_s": sum(standby_apply_s),
            "standby_apply_spans_per_s": (applied_spans
                                          / sum(standby_apply_s)),
            "replica_records": records, "replica_spans": rep_spans,
            "replica_apply_s_per_record": apply_s / records,
            "replica_mirror_fold_s_per_record": fold_s / records,
            "replica_seal_s_per_record": seal_s / records,
            "replica_apply_us_per_span": apply_s / rep_spans * 1e6,
        })
        log(f"{what}: " + json.dumps(out))

        # -- the ship server closed and rebound, both connections lost -----
        anchors = shipper.c_anchors.value
        reconnects = {"standby": [], "replica": []}
        for f, name in ((f_sby, "standby"), (f_rep, "replica")):
            f.client.connect = _stamped(f.client.connect, reconnects[name])
        for s in servers:
            s.shutdown()
            s.server_close()
        servers.clear()
        for f in (f_sby, f_rep):
            sock = f.client._sock
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass  # the follower closed it first
        # One record journaled while the endpoint is down: 20 more known
        # traces (a small record, so the replica's seal does not hide
        # the reconnect).
        late = cold_known(DAEMON_LATE_KNOWN, 53,
                          WIN_BASE_US + (n + 2) * WIN_STEP_US)
        primary.apply([s for tr in late for s in tr])
        primary.wal_sync()
        t = time.perf_counter()
        servers.append(ShipServer(shipper, "127.0.0.1", port,
                                  io_timeout_s=REPLICATION_IO_S))
        servers[0].serve_in_thread()
        caught_up = {}
        for f, name in ((f_sby, "standby"), (f_rep, "replica")):
            _drain(f, wal, f"{what} ({name}, reconnected)")
            caught_up[name] = time.perf_counter() - t
        if (shipper.c_anchors.value != anchors
                or f_sby.status()["appliedSeq"] != wal.last_seq
                or f_rep.status()["appliedSeq"] != wal.last_seq):
            fail(f"{what}: after the reconnect {f_sby.status()} "
                 f"{f_rep.status()}, anchors {shipper.c_anchors.value}")
        for name, seen in reconnects.items():
            if not seen:
                fail(f"{what}: the {name} never reconnected")
        late_ids = sorted(tr[0].trace_id for tr in late)
        want_late = primary.get_spans_by_trace_ids(late_ids)
        if len(want_late) != len(late) or any(
                store.get_spans_by_trace_ids(late_ids) != want_late
                for store in (standby, replica)):
            fail(f"{what}: the traces journaled while the endpoint was "
                 f"down do not read back alike on both followers")
        # Seconds from the rebind to each follower's next HELLO, and to
        # its applying the launch journaled while the endpoint was down.
        out["reconnect_s"] = {name: seen[0] - t
                              for name, seen in reconnects.items()}
        out["caught_up_s"] = caught_up

        # -- promotion: the standby owns writes ---------------------------
        t = time.perf_counter()
        promoted = f_sby.promote()
        out["promote_s"] = time.perf_counter() - t
        if promoted is not standby:
            fail(f"{what}: promote() handed back another store")
        wal2 = WriteAheadLog(os.path.join(work, "wal-promoted"),
                             fsync="interval", interval_s=0.05,
                             segment_bytes=64 << 20, registry=obs.Registry())
        closers.append(wal2.close)
        promoted.attach_wal(wal2)
        steps = promoted.counter_block()["batches"]
        pgen = ColumnarTraceGen(promoted.dicts, n_services=scale.services,
                                n_span_names=scale.names, topology=True,
                                seed=41)
        t = time.perf_counter()
        batch, _, ix = pgen.next_batch(
            scale.batch_traces, base_ts=WIN_BASE_US + (n + 3) * WIN_STEP_US)
        promoted.write_batch(batch, ix)
        promoted.wal_sync()
        card_sync()
        out["promoted_write_s"] = time.perf_counter() - t
        if (promoted.counter_block()["batches"] != steps + 1
                or wal2.last_seq != 1):
            fail(f"{what}: the promoted store's launch made "
                 f"{promoted.counter_block()['batches'] - steps} steps and "
                 f"{wal2.last_seq} records")
        # Decommission the standby: its retention pin goes.
        shipper.drop_follower("standby")

        # -- a late replica bootstraps from an anchor ---------------------
        dropped = wal.truncate(wal.last_seq)
        if wal.first_available_seq() <= 1:
            fail(f"{what}: truncation kept the whole log ({dropped} "
                 f"segments dropped)")
        late_anchor = []

        def sized_anchor_frame(_anchor=shipper.anchor):
            t0 = time.perf_counter()
            frame = _anchor()
            late_anchor.append((time.perf_counter() - t0, len(frame)))
            return frame

        shipper.anchor = sized_anchor_frame
        late = ReplicaSpanStore(cfg, background_compaction=False,
                                registry=obs.Registry())
        closers.append(late.close)
        late_client = ShipClient("127.0.0.1", port, "late", mode="replica",
                                 timeout_s=REPLICATION_IO_S)
        late_client.connect()
        f_late = Follower(ReplicaTarget(late), late_client,
                          registry=obs.Registry())
        closers.append(f_late.close)
        frames = []
        late_client.anchor = _timed(late_client.anchor, frames)
        t = time.perf_counter()
        if f_late.step() is not True:
            fail(f"{what}: the late replica's first fetch applied nothing")
        bootstrap_s = time.perf_counter() - t
        if len(frames) != 1 or len(late_anchor) != 1 \
                or late.applied_seq() != wal.last_seq:
            fail(f"{what}: the late replica did not bootstrap from an "
                 f"anchor ({late.applied_seq()} of {wal.last_seq})")
        for name, got, want_a in zip(WINDOW_LEAVES,
                                     late.sketch_mirror.arrays(),
                                     primary.ensure_sketch_mirror().arrays()):
            if not np.array_equal(got, want_a):
                fail(f"{what}: the anchored replica's {name} differs")
        if late.estimated_unique_traces() != \
                primary.estimated_unique_traces():
            fail(f"{what}: the anchored replica's HLL differs")
        out["anchor"] = {
            "bootstrap_s": bootstrap_s,
            "serve_s": late_anchor[0][0], "frame_bytes": late_anchor[0][1],
            "rpc_s": frames[0], "segments_dropped": dropped,
            "first_available_seq": wal.first_available_seq()}
        out["s"] = time.perf_counter() - t_phase
        log(f"{what} result: " + json.dumps(out))
        return out
    finally:
        replica_mod.seal_segment = seal_orig
        errors = []
        for fn in reversed(closers):
            try:
                fn()
            except Exception as e:  # close the others, then raise it
                errors.append(e)
        shutil.rmtree(work, ignore_errors=True)
        if errors:
            raise errors[0]


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
    from zipkin_tpu_torch.store.archive import ArchiveParams
    from zipkin_tpu_torch.store.archive import sketches as SK

    params = getattr(store, "params", None) or ArchiveParams.for_config(
        store.config)
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
    gamma = params.hist_gamma
    qs = [0.5, 0.9, 0.99]
    for svc in COLD_SERVICES:
        counts = np.zeros(params.hist_buckets, np.int64)
        SK.hist_add(counts, np.asarray(
            [s.duration for s in oracle.spans
             if s.service_name == svc and s.duration is not None],
            np.int64), gamma)
        want = quantiles_host(counts, gamma, 1.0, qs) if counts.any() \
            else None
        if store.service_duration_quantiles(svc, qs) != want:
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

    cfg = full_config(dev, scale.cold_log2, scale.services, **WINDOW)
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
        for i in range(scale.cold_parity_batches):
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
# ---------------------------------------------------------------------------
# The ingest front end: Scribe server -> collector queue -> write_thrift
# ---------------------------------------------------------------------------

CORRUPT_ENTRY = b"\xff\xfecorrupt"


def scribe_messages(args):
    """Launch ``i`` of the collector phase's generator (the launches
    before it drawn and dropped, so every launch matches a serial run),
    decoded to Span objects, every ``debug_every``-th span debug-flagged,
    and encoded as base64 scribe messages. Runs in a worker process that
    imports only the port. Returns (messages, trace ids, debug flags)."""
    i, seed, n_services, n_names, n_traces, debug_every = args
    from zipkin_tpu_torch.columnar.encode import SpanCodec
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen
    from zipkin_tpu_torch.wire.thrift import span_to_scribe_message

    codec = SpanCodec()
    gen = ColumnarTraceGen(codec.dicts, n_services=n_services,
                           n_span_names=n_names, topology=True, seed=seed)
    for k in range(i + 1):
        batch, _, _ = gen.next_batch(n_traces,
                                     base_ts=WIN_BASE_US + k * WIN_STEP_US)
    spans = codec.decode(batch)
    debug = np.zeros(len(spans), bool)
    if debug_every:
        debug[::debug_every] = True
        spans = [dataclasses.replace(s, debug=True) if d else s
                 for s, d in zip(spans, debug)]
    return ([span_to_scribe_message(s) for s in spans],
            np.array([s.trace_id for s in spans], np.int64), debug)


def scribe_calls(msgs, known, size):
    """Log calls of ``size`` entries over the stream's ``msgs``, each of
    the ``known`` traces placed whole at the head of one call, and one
    corrupt entry in the second call. Returns (calls, spans sent)."""
    from zipkin_tpu_torch.wire.thrift import span_to_scribe_message

    calls = [[("zipkin", m) for m in msgs[i:i + size]]
             for i in range(0, len(msgs), size)]
    for k, tr in enumerate(known):
        head = [("zipkin", span_to_scribe_message(s)) for s in tr]
        c = k * len(calls) // len(known)
        calls[c] = head + calls[c]
    calls[1].insert(len(calls[1]) // 2, (
        "zipkin", base64.b64encode(CORRUPT_ENTRY).decode()))
    return calls, len(msgs) + sum(len(tr) for tr in known)


def kafka_publish(args):
    """Launch ``i`` of the collector phase's generator (drawn as
    ``scribe_messages`` draws it), decoded to Span objects and published
    to ``topic`` on the broker at ``host:port`` through the port's
    ``KafkaSpanSink(MinimalKafkaProducer(...), batch=True,
    compress=True)``, one call (one framed message) a ``chunk`` spans.
    Runs in a worker process that imports only the port. Returns (spans
    published, messages, the sink's stats, publish s)."""
    i, seed, n_services, n_names, n_traces, host, port, topic, chunk = args
    from zipkin_tpu_torch.columnar.encode import SpanCodec
    from zipkin_tpu_torch.ingest.kafka import KafkaSpanSink
    from zipkin_tpu_torch.testing.kafka_fake import MinimalKafkaProducer
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    codec = SpanCodec()
    gen = ColumnarTraceGen(codec.dicts, n_services=n_services,
                           n_span_names=n_names, topology=True, seed=seed)
    for k in range(i + 1):
        batch, _, _ = gen.next_batch(n_traces,
                                     base_ts=WIN_BASE_US + k * WIN_STEP_US)
    spans = codec.decode(batch)
    prod = MinimalKafkaProducer(host, port)
    try:
        sink = KafkaSpanSink(prod, topic=topic, batch=True, compress=True)
        t = time.perf_counter()
        chunks = [spans[j:j + chunk] for j in range(0, len(spans), chunk)]
        for c in chunks:
            sink.apply(c)
        sink.close()
        publish_s = time.perf_counter() - t
    finally:
        prod.close()
    return len(spans), len(chunks), dict(sink.stats), publish_s


def prepare_scribe_traffic(scale, kafka_at=None):
    """The Scribe traffic of the collector and daemon phases, made before
    any clock starts, in worker processes, one a launch: the collector's
    stream launches and its sampled launch (1% debug); the daemon's
    stream launches, drawn past the durability stream's launches (the
    generators number traces alike, so the daemon's trace ids are new to
    the snapshot it boots from); each phase's known traces on services
    of their own; one corrupt entry a phase. With ``kafka_at`` (host,
    port), one more worker publishes the collector's Kafka launch (the
    launch after its sampled one) to that broker's ``zipkin`` topic
    (``kafka_publish``). Returns (stream calls, sampled calls, sampled
    trace ids and debug flags, known traces, span count sent, prep s,
    the Kafka publish's result or None, the daemon's traffic)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t = time.perf_counter()
    n = scale.collector_launches
    first = 2 * scale.durability_launches + 1
    n_services = scale.services - len(COLD_SERVICES) - 1
    n_names = scale.names - len(COLD_OPS) - 1
    jobs = [(i, 31, n_services, n_names, scale.batch_traces,
             100 if i == n else 0) for i in range(n + 1)]
    jobs += [(first + k, 31, n_services, n_names, scale.batch_traces, 0)
             for k in range(scale.daemon_launches)]
    published = None
    with ProcessPoolExecutor(max_workers=scale.prep_workers,
                             mp_context=multiprocessing.get_context(
                                 "spawn")) as pool:
        if kafka_at is not None:
            published = pool.submit(kafka_publish, (
                n + 1, 31, n_services, n_names, scale.batch_traces,
                *kafka_at, "zipkin", scale.scribe_call))
        made = list(pool.map(scribe_messages, jobs))
        if published is not None:
            published = published.result()
    size = scale.scribe_call
    known = cold_known(scale.cold_known, 32, WIN_BASE_US)
    calls, sent = scribe_calls([m for msgs, _, _ in made[:n] for m in msgs],
                               known, size)
    msgs, tids, debug = made[n]
    sampled = [[("zipkin", m) for m in msgs[i:i + size]]
               for i in range(0, len(msgs), size)]
    d_known = cold_known(scale.cold_known, 41,
                         WIN_BASE_US + first * WIN_STEP_US)
    d_calls, d_sent = scribe_calls(
        [m for msgs, _, _ in made[n + 1:] for m in msgs], d_known, size)
    daemon = {"calls": d_calls, "known": d_known, "sent": d_sent,
              "first_launch": first}
    return (calls, sampled, tids, debug, known, sent,
            time.perf_counter() - t, published, daemon)


class EarlyTraffic:
    """``prepare_scribe_traffic`` on a thread of its own, started a few
    phases before the collector phase so its worker processes run
    beside those phases: the Kafka launch is published to a broker
    started here (its messages wait there for the collector phase's
    consumer). ``result()`` waits for it; ``close()`` closes the
    broker."""

    def __init__(self, scale):
        from zipkin_tpu_torch.testing.kafka_fake import FakeKafkaBroker

        self.broker = FakeKafkaBroker().start()
        self._job = Background("the collector phase's traffic",
                               prepare_scribe_traffic, scale,
                               (self.broker.host, self.broker.port))

    def result(self):
        return self._job.result(1200)

    def close(self):
        self.broker.close()


def send_calls(host, port, calls, n_clients: int = 4,
               what: str = "collector path"):
    """``n_clients`` ScribeClient connections share ``calls`` (client c
    sends calls c, c + n, ...); a client resends a call answered
    TRY_LATER. Returns (ack ms of each call answered OK, TRY_LATER
    answers)."""
    from zipkin_tpu_torch.ingest import ResultCode
    from zipkin_tpu_torch.ingest.scribe_server import ScribeClient

    acks, retries, errors = [], [0], []
    lock = threading.Lock()

    def client(c):
        cl = ScribeClient(host, port, timeout_s=120.0)
        try:
            for call in calls[c::n_clients]:
                while True:
                    t = time.perf_counter()
                    code = cl.log(call)
                    ms = (time.perf_counter() - t) * 1e3
                    if code is ResultCode.OK:
                        break
                    with lock:
                        retries[0] += 1
                    time.sleep(0.002)
                with lock:
                    acks.append(ms)
        except Exception as e:  # surfaced below, on the main thread
            errors.append(e)
        finally:
            cl.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        fail(f"{what}: a scribe client failed: {errors[0]!r}")
    return acks, retries[0]


class _WaitedLock:
    """A store's write lock behind a proxy that adds each acquire's wait
    to ``waits[thread]`` while ``on(thread)`` holds."""

    def __init__(self, lock, on, waits):
        self._real, self._on, self._waits = lock, on, waits

    def acquire(self, *a, **kw):
        t = time.perf_counter()
        got = self._real.acquire(*a, **kw)
        if self._on():
            k = threading.get_ident()
            self._waits[k] = self._waits.get(k, 0.0) + (
                time.perf_counter() - t)
        return got

    def release(self):
        self._real.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


class WriteThriftClock:
    """Host seconds of ``write_thrift`` on one store and of its parts, by
    wrapping them: the wait for the store's write lock, the native parse
    with the sampler's threshold and interning, the index bits, chunk
    plus pad, and the commit (the launch and the mirror fold). The parts
    count only inside a ``write_thrift`` call (the self-trace ``apply``
    shares the helpers); ``held`` is ``write_thrift`` less its lock
    wait. Installs on construction; ``restore`` removes it."""

    def __init__(self, store):
        from zipkin_tpu_torch import native

        self.s = {"write_thrift": 0.0, "lock_wait": 0.0, "held": 0.0,
                  "parse_intern": 0.0, "index_bits": 0.0,
                  "chunk_pad": 0.0, "commit": 0.0}
        self._lock = threading.Lock()
        self._inside = threading.local()
        self._waits = {}
        self._store, self._store_lock = store, store._lock
        store._lock = _WaitedLock(
            store._lock, lambda: getattr(self._inside, "on", False),
            self._waits)
        self._undo = []
        self._wrap(store, "write_thrift", "write_thrift", outer=True)
        self._wrap(native, "parse_spans_columnar_sampled", "parse_intern")
        self._wrap(native, "indexable_from_batch", "index_bits")
        self._wrap(store, "_chunk_columnar", "chunk_pad", wrap=list)
        self._wrap(store, "_pad_unit", "chunk_pad")
        self._wrap(store, "_commit_unit", "commit")

    def _wrap(self, owner, name, key, wrap=None, outer=False):
        fn = getattr(owner, name)

        def call(*a, **kw):
            if not outer and not getattr(self._inside, "on", False):
                return fn(*a, **kw)
            self._inside.on = True
            t = time.perf_counter()
            try:
                out = fn(*a, **kw)
                return out if wrap is None else wrap(out)
            finally:
                dt = time.perf_counter() - t
                with self._lock:
                    self.s[key] += dt
                    if outer:
                        wait = self._waits.pop(threading.get_ident(), 0.0)
                        self.s["lock_wait"] += wait
                        self.s["held"] += dt - wait
                if outer:
                    self._inside.on = False

        self._undo.append((owner, name, fn, name in vars(owner)))
        setattr(owner, name, call)

    def restore(self):
        self._store._lock = self._store_lock
        for owner, name, fn, own in reversed(self._undo):
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)


def serve(receiver):
    from zipkin_tpu_torch.ingest.scribe_server import ScribeServer

    server = ScribeServer(receiver, host="127.0.0.1", port=0)
    server.serve_in_thread()
    return server


def stop_server(server):
    server.shutdown()
    server.server_close()


def kafka_known_chunks(known, size):
    """The known traces as chunks of whole traces, each at most ``size``
    spans (a trace larger than ``size`` alone), so every trace travels
    in one message."""
    chunks, cur = [], []
    for tr in known:
        if cur and len(cur) + len(tr) > size:
            chunks.append(cur)
            cur = []
        cur = cur + list(tr)
    return chunks + ([cur] if cur else [])


def kafka_drive(torch, K, scale, device, store, collector, clock, broker,
                published, oracle, scribe_spans_per_s):
    """Kafka ingest through the collector phase's ``Collector`` and store:
    the stream launch (published before the clock by ``kafka_publish``)
    and 100 known traces of the known services (published here, a
    message of whole traces at most ``scribe_call`` spans) plus one
    corrupt deflate frame sit on the port's broker; then, timed, a
    ``KafkaSpanReceiver(collector.accept, [MinimalKafkaConsumer(...)],
    process_thrift=collector.accept_thrift)`` drains the topic and
    ``collector.flush()`` lands it, under the CUDA-only profiler (as the
    Scribe drive). It fails unless every message is counted, one bad,
    every published span stored, the known traces read back equal to
    the oracle, and K1 and both K2 halves launched once a step."""
    from zipkin_tpu_torch.ingest.kafka import (FRAME_DEFLATE,
                                               KafkaSpanReceiver,
                                               KafkaSpanSink)
    from zipkin_tpu_torch.ops.quantile import quantiles_host
    from zipkin_tpu_torch.testing.kafka_fake import (MinimalKafkaConsumer,
                                                     MinimalKafkaProducer)

    n_stream, stream_msgs, stream_stats, publish_s = published
    known = cold_known(scale.cold_known, 51, WIN_BASE_US + (
        scale.collector_launches + 1) * WIN_STEP_US)
    chunks = kafka_known_chunks(known, scale.scribe_call)
    prod = MinimalKafkaProducer(broker.host, broker.port)
    try:
        sink = KafkaSpanSink(prod, topic="zipkin", batch=True, compress=True)
        for c in chunks:
            sink.apply(c)
        prod.send("zipkin", bytes([FRAME_DEFLATE]) + b"not-a-zlib-stream")
    finally:
        prod.close()
    n_known = sum(len(tr) for tr in known)
    spans = n_stream + n_known
    messages = stream_msgs + len(chunks) + 1
    if sink.stats["published"] != n_known or stream_stats[
            "published"] != n_stream or stream_stats["errors"]:
        fail(f"collector path (kafka): published {stream_stats} and "
             f"{sink.stats}")
    for tr in known:
        oracle.apply(tr)
    with collector._h_write._lock:
        h0 = collector._h_write.counts.copy()
    split0 = dict(clock.s)
    cb0 = store.counter_block()
    stored0 = collector.spans_stored
    fetch0 = broker.stats["fetch"]
    consumer = MinimalKafkaConsumer(broker.host, broker.port, "zipkin")
    receiver = KafkaSpanReceiver(collector.accept, [consumer],
                                 process_thrift=collector.accept_thrift)
    try:
        K.reset_launches()
        with DeviceIdle(torch, device) as idle:
            t0 = time.perf_counter()
            receiver.run()
            t_consumed = time.perf_counter()
            collector.flush()
            sync(torch, device)
            drive_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        consumer.close()
    cb = store.counter_block()
    steps = cb["batches"] - cb0["batches"]
    stored = collector.spans_stored - stored0
    if receiver.stats["messages"] != messages or receiver.stats["bad"] != 1 \
            or receiver.stats["dropped"]:
        fail(f"collector path (kafka): receiver {receiver.stats}, "
             f"{messages} messages published with 1 corrupt frame")
    if stored != spans:
        fail(f"collector path (kafka): stored {stored} of {spans} "
             f"published spans")
    if device.type == "cuda":
        for name in ("flat_histogram", "arena_claim", "arena_write"):
            if launches[name] != steps:
                fail(f"collector path (kafka): {name} launched "
                     f"{launches[name]} times in {steps} ingest steps, "
                     f"not once a step")
    fetch_ms = cold_reads_vs_oracle(store, oracle,
                                    [tr[0].trace_id for tr in known],
                                    "collector path (kafka known traces)")
    with collector._h_write._lock:
        h = collector._h_write.counts - h0
    w = collector._h_write
    write_p50, write_p99 = quantiles_host(h, w.gamma, w.min_value,
                                          [0.5, 0.99])
    split = {k: clock.s[k] - split0[k] for k in clock.s}
    rate = spans / drive_s
    out = {
        "kafka_spans_per_s": rate,
        "kafka_over_scribe": rate / scribe_spans_per_s,
        "spans": spans, "stream_spans": n_stream, "known_spans": n_known,
        "known_traces": len(known), "messages": messages,
        "fetch_round_trips": consumer.stats["fetches"],
        "broker_fetches": broker.stats["fetch"] - fetch0,
        "bytes_fetched": consumer.stats["bytes"],
        "bytes_raw": stream_stats["bytes_raw"] + sink.stats["bytes_raw"],
        "bytes_wire": stream_stats["bytes_wire"] + sink.stats["bytes_wire"],
        "publish_s_in_worker": publish_s,
        "drive_s": drive_s, "consume_s": t_consumed - t0,
        "flush_s": drive_s - (t_consumed - t0),
        "receiver": dict(receiver.stats),
        "collector_write_s_p50": write_p50,
        "collector_write_s_p99": write_p99,
        "ingest_steps": steps, "spans_per_step": (
            (cb["spans_seen"] - cb0["spans_seen"]) / max(steps, 1)),
        "write_thrift_split_s": split,
        "write_lock_held_share": split["held"] / drive_s,
        "known_fetch_ms_p50": float(np.percentile(fetch_ms, 50)),
        "known_fetch_ms_p99": float(np.percentile(fetch_ms, 99)),
        "drive_idle_share": (idle.result["idle_share"] if idle.result
                             else "not measured"),
        "kernel_launches": launches,
    }
    log("kafka drive: " + json.dumps(out))
    return out


def collector_path(torch, K, dev, scale, device, window, traffic):
    """The daemon's ingest front end at full width (``example.py``:
    ``Collector(store, Sampler(1.0), max_queue=500, concurrency=10,
    self_trace=True)`` behind a ``ScribeReceiver(collector.accept,
    process_thrift=collector.accept_thrift)`` on a ``ScribeServer``) in
    front of the window store: a launch of generated spans plus
    100 known traces and one corrupt entry, sent by four Scribe clients
    in log calls of 2,048 entries, then ``flush()``, profiled for the
    idle share, its first step held against the plain versions of K1
    and K2; a sampled launch at
    rate 0.25 (1% debug); a durable sub-drive at 2^14 recovered on the
    card; card against CPU at 2^14; ``recompute_dependencies``; and the
    same launch through serial ``write_batch`` on a fresh store,
    for the ratio. Between the Scribe drive's reads and the sampled
    launch, ``kafka_drive`` sends a launch through Kafka into the same
    collector and store."""
    from zipkin_tpu_torch import native, obs
    from zipkin_tpu_torch.aggregate import recompute_dependencies
    from zipkin_tpu_torch.ingest import Collector, ScribeReceiver
    from zipkin_tpu_torch.sampler import Sampler
    from zipkin_tpu_torch.store.memory import InMemorySpanStore
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.testing.crash import moments_close

    if not native.available() or os.path.dirname(os.path.realpath(
            native.loaded_from)) != os.path.realpath(os.path.join(
                HERE, "build", "zipkin_tpu_torch")):
        fail(f"collector path: the native codec did not load from the "
             f"port's build directory ({native.loaded_from})")
    broker = traffic.broker
    t = time.perf_counter()
    try:
        (calls, sampled_calls, s_tids, s_debug, known, sent, prep_s,
         published, daemon_traffic) = traffic.result()
    except BaseException:
        traffic.close()
        raise
    log(f"collector path: {sent} spans in {len(calls)} log calls, "
        f"{published[0]} spans in {published[1]} Kafka messages, and "
        f"{len(sampled_calls)} sampled calls prepared in {prep_s:.1f} s "
        f"(waited {time.perf_counter() - t:.1f} s for them here) "
        f"(and the daemon phase's {daemon_traffic['sent']} spans in "
        f"{len(daemon_traffic['calls'])} calls)")
    oracle = InMemorySpanStore()
    for tr in known:
        oracle.apply(tr)
    cfg = full_config(dev, scale.collector_log2, scale.services, **WINDOW)
    free_card(torch, device)
    store = TorchSpanStore(cfg, device=device.type, registry=obs.Registry())
    reg = obs.Registry()
    collector = Collector(store, sampler=Sampler(1.0), max_queue=500,
                          concurrency=10, self_trace=True, registry=reg)
    slow = []
    decode_slow = collector._decode_segments_slow

    def traced_slow(segments):
        slow.append((len(segments), CORRUPT_ENTRY in segments))
        return decode_slow(segments)

    collector._decode_segments_slow = traced_slow
    server = serve(ScribeReceiver(collector.accept,
                                  process_thrift=collector.accept_thrift))
    clock = WriteThriftClock(store)
    rec = Recorder(K, record=("hist", "arena"))
    try:
        host, port = server.server_address
        K.reset_launches()
        with DeviceIdle(torch, device) as idle:
            t0 = time.perf_counter()
            acks, try_later = send_calls(host, port, calls)
            t_sent = time.perf_counter()
            collector.flush()
            sync(torch, device)
            drive_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        rec.restore()
        split = dict(clock.s)
        steps = store.counter_block()["batches"]
        check_launches(launches, ("flat_histogram", "arena_claim",
                                  "arena_write"), device, "collector", steps)
        for half in ("arena_claim", "arena_write"):
            if device.type == "cuda" and launches[half] != steps:
                fail(f"collector path: {half} launched {launches[half]} "
                     f"times in {steps} steps, not once a step")
        step_check = step_vs_plain(K, rec, "collector path", 8)
        del rec
        processed = collector.queue.processed
        stats = reg.as_dict()
        if collector.spans_stored != sent:
            fail(f"collector path: stored {collector.spans_stored} of "
                 f"{sent} spans sent (less the corrupt entry)")
        if stats["zipkin_collector_bad_payloads_total"] != 1:
            fail(f"collector path: "
                 f"{stats['zipkin_collector_bad_payloads_total']} bad "
                 f"payloads, 1 injected")
        if slow != [(len(calls[1]), True)]:
            fail(f"collector path: the slow path decoded {slow}, not only "
                 f"the call holding the corrupt entry")
        end = 2**62
        selfs = store.get_trace_ids_by_name("zipkin-tpu", "collector ingest",
                                            end, processed + 16)
        if len(selfs) != processed or processed != len(calls):
            fail(f"collector path: {len(selfs)} self-trace spans for "
                 f"{processed} processed queue items ({len(calls)} calls)")
        seen = store.counter_block()["spans_seen"]
        if seen != sent + processed:
            fail(f"collector path: the store saw {seen} spans, "
                 f"{sent} sent + {processed} self-trace expected")
        t = time.perf_counter()
        known_tids = [tr[0].trace_id for tr in known]
        fetch_ms = cold_reads_vs_oracle(store, oracle, known_tids,
                                        "collector path (known traces)")
        reads_s = time.perf_counter() - t
        write_p50, write_p99 = collector._h_write.quantile_values(
            [0.5, 0.99])

        # Kafka into the same collector and store, after the Scribe
        # drive's reads (so no second full-width store is made).
        kafka = kafka_drive(torch, K, scale, device, store, collector,
                            clock, broker, published, oracle,
                            sent / drive_s)

        # The sampled launch: rate 0.25, 1% debug, profiled.
        collector.sampler.rate = 0.25
        th = collector.sampler.threshold
        allowed0, denied0 = collector.sampler.snapshot()
        stored0, dropped0 = collector.spans_stored, collector.spans_dropped
        send_calls(host, port, sampled_calls)
        collector.flush()
        t_abs = np.where(s_tids == np.int64(-(2**63)),
                         np.int64(2**63 - 1), np.abs(s_tids))
        keep = s_debug | (t_abs > np.int64(th))
        allowed1, denied1 = collector.sampler.snapshot()
        got = (collector.spans_stored - stored0,
               collector.spans_dropped - dropped0,
               allowed1 - allowed0, denied1 - denied0)
        want = (int(keep.sum()), int((~keep).sum()),
                int((keep & ~s_debug).sum()), int((~keep).sum()))
        if got != want or not 0 < want[0] < len(keep):
            fail(f"collector path: sampled drive stored/dropped/allowed/"
                 f"denied {got}, the threshold test gives {want}")
        uniq = np.unique(s_tids)
        exist = store.traces_exist([int(x) for x in uniq])
        if exist != {int(x) for x in np.unique(s_tids[keep])}:
            fail("collector path: the sampled drive's kept trace set "
                 "differs from the threshold test's")
        debug_only = np.unique(s_tids[s_debug & ~(t_abs > np.int64(th))])
        if len(debug_only) == 0:
            fail("collector path: no sampled-out trace carries a debug span")
        for tid, spans in zip(debug_only[:20], store.get_spans_by_trace_ids(
                [int(x) for x in debug_only[:20]])):
            if not spans or not all(s.debug for s in spans) or len(
                    spans) != int((s_debug & (s_tids == tid)).sum()):
                fail(f"collector path: the debug spans of sampled-out "
                     f"trace {tid} were not kept alone")

        # The dependency job over the full-width ring.
        t = time.perf_counter()
        recomputed = recompute_dependencies(store)
        recompute_s = time.perf_counter() - t
        svcs = set(COLD_SERVICES)
        stream_links = {(lk.parent, lk.child): lk.duration_moments
                        for lk in store.get_dependencies().links
                        if lk.parent in svcs and lk.child in svcs}
        re_links = {(lk.parent, lk.child): lk.duration_moments
                    for lk in recomputed.links
                    if lk.parent in svcs and lk.child in svcs}
        if not stream_links or sorted(stream_links) != sorted(re_links):
            fail("collector path: recomputed links of the known services "
                 "differ from the streaming bank's")
        keys = sorted(stream_links)
        fields = ("n", "mean", "m2", "m3", "m4")
        if not moments_close(
                [[getattr(stream_links[k], f) for f in fields]
                 for k in keys],
                [[getattr(re_links[k], f) for f in fields] for k in keys]):
            fail(f"collector path: recomputed links differ from the "
                 f"streaming bank's beyond stated tolerance 2: "
                 f"{[re_links[k] for k in keys]} vs "
                 f"{[stream_links[k] for k in keys]}")
        mem = (torch.cuda.max_memory_allocated()
               if device.type == "cuda" else 0)
    finally:
        clock.restore()
        if "rec" in locals():
            rec.restore()
        collector._decode_segments_slow = decode_slow
        stop_server(server)
        traffic.close()
        collector.close()
    n_sampled = len(s_tids)
    del store, collector
    free_card(torch, device)
    durable = collector_durable(torch, dev, scale, device)
    parity = collector_parity(torch, dev, scale, device)
    serial = serial_write_batch(torch, dev, scale, device)
    e2e = sent / drive_s
    result = {
        "spans_sent": sent, "log_calls": len(calls),
        "entries_per_call": scale.scribe_call, "clients": 4,
        "prep_s": prep_s, "drive_s": drive_s,
        "send_s": t_sent - t0, "flush_s": drive_s - (t_sent - t0),
        "scribe_spans_per_s": e2e,
        "serial_write_batch_spans_per_s": serial["spans_per_s"],
        "serial_write_batch_spans_per_s_after_first": serial[
            "spans_per_s_after_first"],
        "scribe_over_serial": e2e / serial["spans_per_s"],
        "window_path_spans_per_s_after_first": window[
            "ingest_spans_per_s_after_first"],
        "ack_ms_p50": float(np.percentile(acks, 50)),
        "ack_ms_p99": float(np.percentile(acks, 99)),
        "collector_write_s_p50": write_p50,
        "collector_write_s_p99": write_p99,
        "ingest_steps": steps, "spans_per_launch": seen / steps,
        "queue_items": processed, "try_later": try_later,
        "queue_rejections": int(stats["zipkin_queue_rejected_total"]),
        "write_thrift_split_s": split,
        "write_thrift_share_of_held": {
            k: split[k] / max(split["held"], 1e-12)
            for k in ("parse_intern", "index_bits", "chunk_pad", "commit")},
        "slow_path_items": len(slow), "slow_path_segments": slow[0][0],
        "known_fetch_ms_p50": float(np.percentile(fetch_ms, 50)),
        "known_fetch_ms_p99": float(np.percentile(fetch_ms, 99)),
        "known_reads_s": reads_s,
        "sampled_spans": n_sampled, "sampled_kept": want[0],
        "sampled_debug": int(s_debug.sum()),
        "drive_idle_share": (idle.result["idle_share"] if idle.result
                             else "not measured"),
        "drive_profile": idle.result or "not measured",
        "first_step_vs_plain": step_check,
        "recompute_dependencies_s": recompute_s,
        "max_memory_allocated_bytes": mem,
        "durable": durable, "parity": parity, "serial": serial,
        "kernel_launches": launches, "kafka": kafka,
    }
    log("collector path result: " + json.dumps(result))
    return result, daemon_traffic


def small_scribe_calls(scale, seed: int):
    """Four 2^14-scale launches of generated spans as log calls (made in
    this process: ~14 k spans)."""
    msgs = [m for i in range(4) for m in scribe_messages(
        (i, seed, scale.services, scale.names, scale.small_traces, 0))[0]]
    size = scale.scribe_call
    return [[("zipkin", m) for m in msgs[i:i + size]]
            for i in range(0, len(msgs), size)]


def collector_durable(torch, dev, scale, device):
    """The daemon's durable wiring at 2^14 (``example.py:630-633``): a
    WAL with the daemon's defaults, ``ScribeReceiver(collector.
    ingest_durable, process_thrift=collector.ingest_thrift_durable)``;
    then ``wal.recover`` on the card must give the live state."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.ingest import Collector, ScribeReceiver
    from zipkin_tpu_torch.sampler import Sampler
    from zipkin_tpu_torch.store.convert import state_to_numpy
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.wal import WriteAheadLog, recover

    cfg = full_config(dev, scale.small_log2, scale.services, **WINDOW)
    calls = small_scribe_calls(scale, 41)
    work = tempfile.mkdtemp(prefix="zipkin-collector-wal-")
    try:
        store = TorchSpanStore(cfg, device=device.type,
                               registry=obs.Registry())
        wal = WriteAheadLog(work, fsync="interval", interval_s=0.05,
                            segment_bytes=64 << 20, registry=obs.Registry())
        store.attach_wal(wal)
        col = Collector(store, sampler=Sampler(1.0), max_queue=500,
                        concurrency=10, self_trace=True,
                        registry=obs.Registry())
        server = serve(ScribeReceiver(
            col.ingest_durable, process_thrift=col.ingest_thrift_durable))
        try:
            t = time.perf_counter()
            acks, try_later = send_calls(*server.server_address, calls)
            send_s = time.perf_counter() - t
            col.flush()
        finally:
            stop_server(server)
        want = state_to_numpy(store.state)
        records = wal.last_seq
        stored = col.spans_stored
        col.close()
        wal.close()
        t = time.perf_counter()
        rec, stats = recover(
            None, WriteAheadLog(work, registry=obs.Registry()),
            fresh_store=lambda d: TorchSpanStore(
                cfg, device=d, registry=obs.Registry()),
            device=device.type)
        recover_s = time.perf_counter() - t
        if stats["replayed_records"] != records or not records:
            fail(f"collector path (durable): replayed "
                 f"{stats['replayed_records']} of {records} records")
        _check_states_equal(want, state_to_numpy(rec.state),
                            "collector path (durable, recovered)")
        if stored != sum(len(c) for c in calls):
            fail("collector path (durable): not every span was stored")
        rec.wal.close()
        out = {"spans": stored, "log_calls": len(calls),
               "wal_records": records, "send_s": send_s,
               "durable_spans_per_s": stored / send_s,
               "ack_ms_p50": float(np.percentile(acks, 50)),
               "ack_ms_p99": float(np.percentile(acks, 99)),
               "try_later": try_later, "recover_s": recover_s}
        log("collector path (durable): " + json.dumps(out))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def collector_parity(torch, dev, scale, device):
    """The same payloads through ``Collector(concurrency=1,
    self_trace=False)`` with the sampler at 0.5 into a store on the card
    and one on the CPU: equal counters and states."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.ingest import Collector
    from zipkin_tpu_torch.sampler import Sampler
    from zipkin_tpu_torch.store.convert import state_to_numpy
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore

    cfg = full_config(dev, scale.small_log2, scale.services, **WINDOW)
    calls = [[base64.b64decode(m) for _, m in c]
             for c in small_scribe_calls(scale, 43)]
    calls[0].insert(3, CORRUPT_ENTRY)
    states, counts = [], []
    for d in (device.type, "cpu"):
        store = TorchSpanStore(cfg, device=d, registry=obs.Registry())
        col = Collector(store, sampler=Sampler(0.5), concurrency=1,
                        self_trace=False, registry=obs.Registry())
        for segs in calls:
            col.accept_thrift(segs)
        col.flush()
        states.append(state_to_numpy(store.state))
        counts.append((col.spans_stored, col.spans_dropped,
                       col.bad_payloads, col.sampler.snapshot()))
        col.close()
    if counts[0] != counts[1] or not counts[0][1] or counts[0][2] != 1:
        fail(f"collector path (parity): counters {counts[0]} on "
             f"{device.type}, {counts[1]} on the cpu")
    _check_states_equal(states[1], states[0], "collector path (parity)")
    log(f"collector path (parity): {device.type} and cpu states equal "
        f"after {counts[0][0]} stored, {counts[0][1]} sampled out")
    return {"stored": counts[0][0], "dropped": counts[0][1]}


def serial_write_batch(torch, dev, scale, device):
    """The collector phase's launches as columns through serial
    ``write_batch`` on a fresh window store, each synchronised."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    cfg = full_config(dev, scale.collector_log2, scale.services, **WINDOW)
    free_card(torch, device)
    store = TorchSpanStore(cfg, device=device.type, registry=obs.Registry())
    gen = ColumnarTraceGen(store.dicts,
                           n_services=scale.services - len(COLD_SERVICES) - 1,
                           n_span_names=scale.names - len(COLD_OPS) - 1,
                           topology=True, seed=31)
    step_s = []
    spans = 0
    for i in range(scale.collector_launches):
        batch, _, ix = gen.next_batch(scale.batch_traces,
                                      base_ts=WIN_BASE_US + i * WIN_STEP_US)
        t = time.perf_counter()
        store.write_batch(batch, ix)
        sync(torch, device)
        step_s.append(time.perf_counter() - t)
        spans += batch.n_spans
    steady = step_s[1:] or step_s
    del store
    free_card(torch, device)
    return {"launches": len(step_s), "step_s": step_s,
            "spans_per_s": spans / sum(step_s),
            "spans_per_s_after_first": (spans // len(step_s) * len(steady)
                                        / sum(steady))}


# ---------------------------------------------------------------------------
# The query layer: QueryService over the daemon's store while it ingests
# ---------------------------------------------------------------------------

QUERY_TERMS = ("service", "span", "annotation", "binary")
QUERY_MULTI = (("span", "annotation"), ("annotation", "binary"),
               ("span", "annotation", "binary"))
# The cache check's query: a limit no reader asks for.
CACHE_PROBE_LIMIT = 7


def same_json(a, b) -> bool:
    """Equal as JSON text: NaN equals NaN, tuples equal lists."""
    return (json.dumps(a, sort_keys=True, default=repr)
            == json.dumps(b, sort_keys=True, default=repr))


def query_request(svc, span_name, terms, limit, order):
    from zipkin_tpu_torch.query import BinaryAnnotationQuery, QueryRequest

    kw = {}
    if "span" in terms:
        kw["span_name"] = span_name
    if "annotation" in terms:
        kw["annotations"] = ("some custom annotation",)
    if "binary" in terms:
        kw["binary_annotations"] = (
            BinaryAnnotationQuery("http.uri", b"/api/widgets"),)
    return QueryRequest(svc, end_ts=2**62, limit=limit, order=order, **kw)


def query_ops(scale, store, service, rng):
    """The reader drive: ``scale.query_requests`` get_trace_ids requests
    drawn with repeats from a pool over the five known services and the
    first twenty of the stream's (by service, span name, annotation, binary
    annotation; limits 10 and 100; each Order), a tenth of them with two
    or three terms, and one sketch read after every tenth request."""
    from zipkin_tpu_torch.query import Order

    present = store.get_all_service_names()
    svcs = [s for s in COLD_SERVICES if s in present] + sorted(
        s for s in present if s.startswith("svc-"))[:20]
    names = {s: sorted(store.get_span_names(s)) for s in svcs}
    if not all(names.values()):
        fail("query path: a service of the mix has no span name")
    orders = list(Order)
    n_single, n_multi = scale.query_pool, max(2, scale.query_pool // 8)

    def draw(terms_of, n):
        out = []
        for _ in range(n):
            svc = svcs[int(rng.integers(len(svcs)))]
            out.append(query_request(
                svc, names[svc][int(rng.integers(len(names[svc])))],
                terms_of(), (10, 100)[int(rng.integers(2))],
                orders[int(rng.integers(len(orders)))]))
        return out

    single = draw(lambda: (QUERY_TERMS[int(rng.integers(4))],), n_single)
    multi = draw(lambda: QUERY_MULTI[int(rng.integers(3))], n_multi)
    now_us = WIN_BASE_US + (scale.query_launches
                           + scale.query_writes) * WIN_STEP_US
    sketch = [
        lambda s: service.get_service_names(),
        lambda s: service.get_span_names(s),
        lambda s: service.get_service_duration_quantiles(s, [0.5, 0.99]),
        lambda s: service.get_top_annotations(s),
        lambda s: service.get_top_key_value_annotations(s),
        lambda s: service.get_windowed_quantiles(s, [0.5, 0.99]),
        lambda s: service.get_slo_burn(s, windows_s=[300, 3600],
                                       now_us=now_us),
        lambda s: service.get_latency_heatmap(s),
    ]
    ops = []
    for i in range(scale.query_requests):
        pool = multi if i % 10 == 9 else single
        ops.append(("ids", pool[int(rng.integers(len(pool)))]))
        if i % 10 == 9:
            fn = sketch[int(rng.integers(len(sketch)))]
            svc = svcs[int(rng.integers(len(svcs)))]
            ops.append(("sketch", lambda fn=fn, svc=svc: fn(svc)))
    return ops, svcs, now_us, single + multi


class IndexLog:
    """Wraps an engine's ``get_trace_ids_multi``: every call whose store
    frontier held still across it is logged (queries, results, frontier)
    under ``lock``; the phase's writer holds ``lock`` while it checks
    the log against the store's direct serial reads and commits the
    next launch, so each logged entry is checked at its own frontier.
    A reader's seconds waiting for ``lock`` (the writer's check and
    launch) add up in ``waited()``, so request times can leave them
    out."""

    def __init__(self, engine, store):
        self.engine, self.store = engine, store
        self.orig = engine.get_trace_ids_multi
        self.lock = threading.Lock()
        self.entries, self.raced = [], 0
        self.compared = self.queries = 0
        self._local = threading.local()
        engine.get_trace_ids_multi = self._multi

    def waited(self) -> float:
        return getattr(self._local, "waited", 0.0)

    def _multi(self, queries):
        queries = [tuple(q) for q in queries]
        f1 = self.store.write_frontier()
        res = self.orig(queries)
        t = time.perf_counter()
        with self.lock:
            self._local.waited = self.waited() + time.perf_counter() - t
            if self.store.write_frontier() == f1:
                self.entries.append((queries, res, f1))
            else:
                self.raced += 1
        return res

    def check(self, what):
        """Every entry logged since the last check against
        ``store.get_trace_ids_multi`` at the current frontier, then drops
        them; the caller holds ``lock``."""
        f = self.store.write_frontier()
        todo, self.entries = self.entries, []
        if any(fe != f for _, _, fe in todo):
            fail(f"{what}: an entry logged at another frontier")
        unique = list({q: None for qs, _, _ in todo for q in qs})
        direct = {}
        for i in range(0, len(unique), 64):
            chunk = unique[i:i + 64]
            direct.update(zip(chunk, self.store.get_trace_ids_multi(chunk)))
        for qs, res, _ in todo:
            for q, r in zip(qs, res):
                if list(r) != list(direct[q]):
                    fail(f"{what}: the engine answered {q} with "
                         f"{len(r)} ids, the store's direct read "
                         f"{len(direct[q])} at frontier {f}")
        self.compared += len(todo)
        self.queries += sum(len(qs) for qs, _, _ in todo)

    def restore(self):
        del self.engine.get_trace_ids_multi


def cache_probe(engine, multi, store, query, commit, what):
    """A repeat read at an unchanged frontier is a hit; after ``commit()``
    (a launch) the same read is a miss. ``multi`` is the engine's own
    ``get_trace_ids_multi``."""
    from zipkin_tpu_torch.query.engine import _MISS

    f = store.write_frontier()
    first = multi([query])
    if engine.cache.get((("ids", query), f)) is _MISS:
        fail(f"{what}: a read at a still frontier was not cached")
    hits = engine.c_hits.value
    if multi([query]) != first or \
            engine.c_hits.value <= hits:
        fail(f"{what}: the repeat read was not a cache hit")
    commit()
    f2 = store.write_frontier()
    if f2 == f or engine.cache.get((("ids", query), f2)) is not _MISS:
        fail(f"{what}: the commit did not move the frontier past the "
             f"cached entry")
    misses = engine.c_misses.value
    multi([query])
    if engine.c_misses.value <= misses:
        fail(f"{what}: the read after a commit was not a miss")


def run_readers(ops, n_readers, body):
    """``n_readers`` threads take ops in turn and call ``body(op)``;
    returns (threads, done counter, errors)."""
    cursor, done, errors = [0], [0], []
    lock = threading.Lock()

    def reader():
        try:
            while True:
                with lock:
                    i = cursor[0]
                    cursor[0] += 1
                if i >= len(ops):
                    return
                body(ops[i])
                with lock:
                    done[0] += 1
        except BaseException as e:  # noqa: BLE001 — failed below
            errors.append(e)

    threads = [threading.Thread(target=reader, name=f"query-reader-{k}")
               for k in range(n_readers)]
    for t in threads:
        t.start()
    return threads, done, errors


def join_readers(threads, errors, what):
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or errors:
        fail(f"{what}: a reader failed or hung: {errors[:3]}")


def sketch_vs_store(engine, store, svcs, now_us, what):
    """Every sketch-tier answer equals the store's direct read."""
    if engine.get_all_service_names() != store.get_all_service_names():
        fail(f"{what}: the service catalog differs from the store's")
    qs = [0.5, 0.9, 0.99]
    for s in svcs:
        pairs = (
            (engine.get_span_names(s), store.get_span_names(s)),
            (engine.service_duration_quantiles(s, qs),
             store.service_duration_quantiles(s, qs)),
            (engine.top_annotations(s), store.top_annotations(s)),
            (engine.top_binary_keys(s), store.top_binary_keys(s)),
            (engine.windowed_quantiles(s, qs),
             store.windowed_quantiles(s, qs)),
            (engine.slo_burn(s, windows_s=[300, 3600], now_us=now_us),
             store.slo_burn(s, windows_s=[300, 3600], now_us=now_us)),
            (engine.latency_heatmap(s), store.latency_heatmap(s)))
        for k, (a, b) in enumerate(pairs):
            if not (a == b if isinstance(a, set) else same_json(a, b)):
                fail(f"{what}: sketch answer {k} of {s} differs from the "
                     f"store's direct read")
    if engine.estimated_unique_traces() != store.estimated_unique_traces():
        fail(f"{what}: the HLL estimate differs from the store's")


def combos_vs(service, other, tids, what):
    for i in range(0, len(tids), 25):
        chunk = tids[i:i + 25]
        got = service.get_trace_combos_by_ids(chunk)
        if got != other.get_trace_combos_by_ids(chunk) or \
                len(got) != len(chunk):
            fail(f"{what}: trace combos of known traces {i}..{i + 25} "
                 f"differ")


def request_split(reqs, launches, pauses, long_ms: float = 10.0):
    """p50/p99 request ms (``reqs``: (seconds, start, end)) split by what
    each overlapped on the host clock: a launch during the reads, a
    collector pause of ``long_ms`` or more, neither."""
    long = [(a, b) for a, b in pauses if (b - a) * 1e3 >= long_ms]

    def hits(a, b, spans):
        return any(x < b and y > a for x, y in spans)

    groups = {"overlapping_launch": [], "overlapping_long_gc_pause": [],
              "neither": []}
    for sec, a, b in reqs:
        if hits(a, b, launches):
            groups["overlapping_launch"].append(sec)
        elif hits(a, b, long):
            groups["overlapping_long_gc_pause"].append(sec)
        else:
            groups["neither"].append(sec)
    return {k: {"n": len(v),
                "p50_ms": float(np.percentile(v, 50)) * 1e3 if v else None,
                "p99_ms": float(np.percentile(v, 99)) * 1e3 if v else None}
            for k, v in groups.items()} | {"long_gc_pauses": len(long)}


def query_path(torch, K, dev, scale, device):
    """The daemon's read path at the full widths with a
    ``Scale.query_log2`` span ring (``example.py:439-442``):
    ``QueryService(store)`` with the 2 ms window over the window store,
    part of a lap of the stream and 100 known traces of five services
    of their own; eight readers send the request mix while the store
    takes four more launches. Known-service answers and combos must
    equal an oracle ``QueryService`` over ``InMemorySpanStore``; every
    index-tier answer the store's direct serial read at its frontier;
    every sketch-tier answer the store's direct read; a repeat read at
    a still frontier is a hit, after a commit a miss. Then
    ``checkpoint.save`` while readers run (the engine drains first), and
    a paged 2^14 store's combos through K3 against its CPU twin."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.query import QueryService
    from zipkin_tpu_torch.query.engine import DEFAULT_COALESCE_WINDOW_S
    from zipkin_tpu_torch.store.memory import InMemorySpanStore
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    cfg = full_config(dev, scale.query_log2, scale.services, **WINDOW)
    free_card(torch, device)
    store = TorchSpanStore(cfg, device=device.type, registry=obs.Registry())
    gen = ColumnarTraceGen(store.dicts,
                           n_services=scale.services - len(COLD_SERVICES),
                           n_span_names=scale.names - len(COLD_OPS),
                           topology=True, seed=51)
    mark = error_marker(store.dicts)

    launch_s = []

    def launch(i):
        batch, _, ix = gen.next_batch(scale.batch_traces,
                                      base_ts=WIN_BASE_US + i * WIN_STEP_US)
        mark(batch)
        t = time.perf_counter()
        store.write_batch(batch, ix)
        sync(torch, device)
        launch_s.append((t, time.perf_counter()))

    t = time.perf_counter()
    for i in range(scale.query_launches):
        launch(i)
    known = cold_known(scale.cold_known, 52, WIN_BASE_US + 3 * WIN_US)
    known_spans = [s for tr in known for s in tr]
    store.apply(known_spans)
    sync(torch, device)
    load_s = time.perf_counter() - t
    oracle = InMemorySpanStore()
    oracle.apply(known_spans)
    service = QueryService(store, registry=obs.Registry())
    oracle_svc = QueryService(oracle, registry=obs.Registry())
    engine = service.engine
    if engine.window_s != DEFAULT_COALESCE_WINDOW_S:
        fail(f"query path: the engine's window is {engine.window_s} s, not "
             f"the daemon's {DEFAULT_COALESCE_WINDOW_S}")
    ops, svcs, now_us, pool = query_ops(scale, store, service,
                                        np.random.default_rng(53))
    want = {op[1]: oracle_svc.get_trace_ids(op[1]) for op in ops
            if op[0] == "ids" and op[1].service_name in COLD_SERVICES}
    if sum(bool(w.trace_ids) for w in want.values()) < len(want) // 2:
        fail("query path: most known-service requests are empty")
    lat = {"ids": [], "sketch": []}
    wrong = []

    def body(op):
        t0, w0 = time.perf_counter(), idx.waited()
        if op[0] == "sketch":
            op[1]()
            lat["sketch"].append(time.perf_counter() - t0)
            return
        resp = service.get_trace_ids(op[1])
        t1 = time.perf_counter()
        lat["ids"].append((t1 - t0 - (idx.waited() - w0), t0, t1))
        w = want.get(op[1])
        if w is not None and resp != w:
            wrong.append(op[1])

    idx = IndexLog(engine, store)
    probe = ("name", COLD_SERVICES[0], None, 2**62, CACHE_PROBE_LIMIT)
    n_ids = sum(op[0] == "ids" for op in ops)
    marks = [len(ops) * (k + 1) // (scale.query_writes + 1)
             for k in range(scale.query_writes)]
    pauses = GcPauses()
    K.reset_launches()
    steps0 = store.counter_block()["batches"]
    gate_s = []
    with DeviceIdle(torch, device) as idle:
        # The collector's pauses over the drive alone (the profiler's
        # own parse at the block's exit makes millions of objects).
        gc.callbacks.append(pauses)
        try:
            t0 = time.perf_counter()
            threads, done, errors = run_readers(ops, scale.query_readers,
                                                body)
            for k, m in enumerate(marks):
                while done[0] < m and any(t.is_alive() for t in threads):
                    time.sleep(0.002)
                with idx.lock:
                    t = time.perf_counter()
                    idx.check(f"query path (before launch {k})")
                    cache_probe(engine, idx.orig, store, probe,
                                lambda: launch(scale.query_launches + k),
                                "query path")
                    gate_s.append(time.perf_counter() - t)
            join_readers(threads, errors, "query path")
            drive_s = time.perf_counter() - t0
        finally:
            gc.callbacks.remove(pauses)
    launches = dict(K.LAUNCHES)
    steps = store.counter_block()["batches"] - steps0
    with idx.lock:
        idx.check("query path (after the drive)")
    idx.restore()
    if steps != scale.query_writes:
        fail(f"query path: {steps} ingest steps during the reads, "
             f"{scale.query_writes} launched")
    check_launches(launches, ("flat_histogram", "arena_claim",
                              "arena_write"), device, "query", steps)
    if wrong:
        fail(f"query path: {len(wrong)} known-service answers differ from "
             f"the oracle's, first {wrong[0]}")
    ex = engine.executor
    tiers = {}
    for tier in ("sketch", "cache", "index"):
        h = engine.h_serve.labels(tier=tier)
        p50, p99 = h.quantile_values([0.5, 0.99])
        tiers[tier] = {"count": h.count, "p50_ms": p50 * 1e3,
                       "p99_ms": p99 * 1e3}
    d50, d99 = engine.h_dispatch.quantile_values([0.5, 0.99])
    coalesce = {"batches": ex.batches, "queries": ex.queries,
                "launches_saved": ex.launches_saved,
                "max_batch": ex.max_batch,
                "requests_per_launch": (ex.batches + ex.launches_saved)
                / max(ex.batches, 1),
                "queries_per_launch": ex.queries / max(ex.batches, 1)}
    if idx.compared <= 0 or tiers["cache"]["count"] <= 0 or \
            tiers["sketch"]["count"] <= 0:
        fail("query path: no index answer was checked, or no read hit the "
             "cache or the sketch tier")
    # Quiescent now: the sketch tier and the known traces' combos.
    sketch_vs_store(engine, store, COLD_SERVICES + svcs[5:15], now_us,
                    "query path")
    known_tids = [tr[0].trace_id for tr in known]
    t = time.perf_counter()
    combos_vs(service, oracle_svc, known_tids, "query path")
    combos_s = time.perf_counter() - t
    cache = {"hits": engine.c_hits.value, "misses": engine.c_misses.value,
             "entries": len(engine.cache)}
    drain = query_drain(scale, store, service, ops)
    http = http_drive(torch, K, scale, store, service, oracle_svc, gen,
                      known, pool, device)
    service.close()
    if ex._thread is not None and ex._thread.is_alive():
        fail("query path: the executor thread outlived close()")
    mem = (torch.cuda.max_memory_allocated()
           if device.type == "cuda" else 0)
    del store, service, engine, ex
    free_card(torch, device)
    paged = query_paged(torch, K, dev, scale, device, known, oracle_svc)
    oracle_svc.close()
    ms = np.array([r[0] for r in lat["ids"]]) * 1e3
    during = launch_s[scale.query_launches:]
    result = {
        "load_s": load_s, "load_launches": scale.query_launches,
        "known_traces": len(known), "readers": scale.query_readers,
        "requests": n_ids, "sketch_reads": len(ops) - n_ids,
        "drive_s": drive_s, "reads_per_s": len(ops) / drive_s,
        "request_ms_p50": float(np.percentile(ms, 50)),
        "request_ms_p99": float(np.percentile(ms, 99)),
        "sketch_read_ms_p99": float(np.percentile(lat["sketch"], 99)) * 1e3,
        "serve_by_tier": tiers,
        "dispatch_ms_p50": d50 * 1e3, "dispatch_ms_p99": d99 * 1e3,
        "coalesce": coalesce,
        "cache": cache,
        "index_entries_checked": idx.compared,
        "index_queries_checked": idx.queries, "index_raced": idx.raced,
        "known_requests_vs_oracle": sum(
            op[0] == "ids" and op[1] in want for op in ops),
        "writes_during_reads": steps,
        "launch_s_during_reads": [b - a for a, b in during],
        "request_ms_split": request_split(lat["ids"], during,
                                          pauses.spans),
        "gate_s": gate_s, "gc_ms_in_drive": pauses.ms,
        "gc_by_generation": {str(g): {"collections": n, "ms": t}
                             for g, (n, t) in sorted(pauses.by_gen.items())},
        "drive_idle_share": (idle.result["idle_share"] if idle.result
                             else "not measured"),
        "drive_profile": idle.result or "not measured",
        "known_combos_s": combos_s, "drain": drain, "paged": paged,
        "max_memory_allocated_bytes": mem,
        "kernel_launches": {k: launches[k] + paged["read_launches"][k]
                            for k in launches},
        "ingest_steps": steps,
        "http": {**http, "paged_combos": paged["http"],
                 "kernel_launches": {
                     k: http["kernel_launches"][k]
                     + paged["http"]["read_launches"][k]
                     for k in launches}},
    }
    log("query path result: " + json.dumps(result))
    return result


def query_drain(scale, store, service, ops):
    """``checkpoint.save`` while eight readers run: the engine's drain
    must come first, before the pipeline's, then the gather."""
    from zipkin_tpu_torch import checkpoint

    engine = service.engine
    order, drain_ms = [], []
    drain, drain_pipeline = engine.drain, store.drain_pipeline

    def timed_drain():
        ex = engine.executor
        with ex._cv:
            busy = len(ex._pending) + ex._inflight
        t = time.perf_counter()
        drain()
        drain_ms.append(((time.perf_counter() - t) * 1e3, busy))
        order.append("queries")

    def noted_pipeline():
        order.append("pipeline")
        drain_pipeline()

    engine.drain, store.drain_pipeline = timed_drain, noted_pipeline
    work = tempfile.mkdtemp(prefix="zipkin-query-ckpt-")
    burst = [op for op in ops if op[0] == "ids"][:scale.query_requests // 10]
    try:
        threads, done, errors = run_readers(
            burst, scale.query_readers,
            lambda op: service.get_trace_ids(op[1]))
        while done[0] < len(burst) // 10 and any(
                t.is_alive() for t in threads):
            time.sleep(0.002)
        before = done[0]
        t = time.perf_counter()
        stats = checkpoint.save(store, os.path.join(work, "ckpt"))
        save_s = time.perf_counter() - t
        during = done[0] - before
        join_readers(threads, errors, "query path (drain)")
    finally:
        del engine.drain, store.drain_pipeline
        shutil.rmtree(work, ignore_errors=True)
    if order[:2] != ["queries", "pipeline"]:
        fail(f"query path: checkpoint.save drained {order}, not the "
             f"queries first")
    out = {"save_s": save_s, "drain_ms": drain_ms[0][0],
           "in_flight_at_drain": drain_ms[0][1],
           "reads_before_save": before, "reads_during_save": during,
           "burst": len(burst), "gather_s": stats.get("gather_s")}
    log("query path (drain): " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The HTTP API over the query phase's store
# ---------------------------------------------------------------------------

HTTP_SCRIBE_CALLS = 3
HTTP_LATE_KNOWN = 20
PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*\})? \S+$')


def serve_api(api):
    """``api`` on 127.0.0.1, a free port, served from a thread: (server,
    thread, base URL)."""
    from zipkin_tpu_torch.api.server import (make_server,
                                             serve_forever_in_thread)

    server = make_server(api, "127.0.0.1", 0)
    thread = serve_forever_in_thread(server)
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def stop_api(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=60)
    if thread.is_alive():
        fail("http: a server thread outlived its shutdown")


def http_call(url, body=None, headers=None, timeout=120):
    """(status, headers, body bytes) of a GET (or a POST of ``body``)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers or {},
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, dict(e.headers), e.read()


def direct_json(api, path, params=None):
    """``api.handle`` called directly, as the JSON a socket would carry."""
    status, payload = api.handle("GET", path, dict(params or {}))
    return status, json.loads(json.dumps(payload))


def query_params(qr):
    """GET /api/query params that ``extract_query`` maps back to
    ``qr``."""
    from zipkin_tpu_torch.api.query_extractor import _ORDERS

    p = {"serviceName": qr.service_name, "endTs": str(qr.end_ts),
         "limit": str(qr.limit),
         "order": {v: k for k, v in _ORDERS.items()}[qr.order]}
    if qr.span_name:
        p["spanName"] = qr.span_name
    terms = list(qr.annotations) + [f"{b.key}={b.value.decode()}"
                                    for b in qr.binary_annotations]
    if terms:
        p["annotationQuery"] = " and ".join(terms)
    return p


def query_json(service, qr):
    """The JSON of ``GET /api/query`` built from the service's direct
    answer."""
    from zipkin_tpu_torch.api.server import _summary_json
    from zipkin_tpu_torch.ingest.receiver import _hex_id

    resp = service.get_trace_ids(qr)
    summaries = service.get_trace_summaries_by_ids(resp.trace_ids)
    return json.loads(json.dumps({
        "traceIds": [_hex_id(t) for t in resp.trace_ids],
        "startTs": resp.start_ts, "endTs": resp.end_ts,
        "summaries": [_summary_json(s) for s in summaries]}))


def sketch_mark(h):
    with h._lock:
        return h.counts.copy(), h._sum, int(h.moments.n)


def sketch_since(h, mark):
    """Count, mean and p50/p99 (ms) of what a latency sketch took since
    ``mark``."""
    from zipkin_tpu_torch.ops.quantile import quantiles_host

    counts, total, n = sketch_mark(h)
    dn = n - mark[2]
    if dn <= 0:
        return {"count": 0}
    p50, p99 = quantiles_host(counts - mark[0], h.gamma, h.min_value,
                              [0.5, 0.99])
    return {"count": dn, "mean_ms": (total - mark[1]) / dn * 1e3,
            "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3}


def http_drive(torch, K, scale, store, service, oracle_svc, gen, known,
               pool, device):
    """The daemon's HTTP API over the query phase's full-width window
    store, driven through sockets: ``ApiServer(service, Collector(store,
    Sampler(1.0), max_queue=500, concurrency=10, self_trace=True))`` on
    127.0.0.1. On the quiescent store: each pool request as ``GET
    /api/query`` must equal the JSON of the direct ``QueryService``
    answer; the known traces' ``/api/trace`` the oracle server's; the
    catalog, dependency and quantile routes ``api.handle`` called
    directly. Then eight readers send the pool through the sockets
    (timed: client ms, the server's handle ms, the engine's serve ms by
    tier, the HTTP share, reads/s, idle share; no launch may land); a
    few ``POST /scribe`` calls of 2,048 entries with late known traces
    (read back equal to an oracle; K1 and both K2 halves once a step);
    a self-traced request read back by its echoed id; ``/metrics`` in
    both forms; and ``POST /debug/profile`` with reads meanwhile (CUDA
    kernels in its trace; a second capture answers 409). The API's
    tracer samples nothing outside the self-trace check, so the reads
    add no span and no launch."""
    from urllib.parse import quote

    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.api import ApiServer, extract_query
    from zipkin_tpu_torch.client import QueryClient
    from zipkin_tpu_torch.ingest import Collector
    from zipkin_tpu_torch.ingest.receiver import _hex_id
    from zipkin_tpu_torch.obs import profile as obs_profile
    from zipkin_tpu_torch.query import QueryService
    from zipkin_tpu_torch.sampler import Sampler
    from zipkin_tpu_torch.store.memory import InMemorySpanStore
    from zipkin_tpu_torch.wire.thrift import span_to_scribe_message

    t_phase = time.perf_counter()
    reg = obs.Registry()
    collector = Collector(store, sampler=Sampler(1.0), max_queue=500,
                          concurrency=10, self_trace=True, registry=reg)
    api = ApiServer(service, collector, registry=reg)
    oracle_api = ApiServer(oracle_svc, self_trace=False,
                           registry=obs.Registry())
    api.tracer.sample_rate = 0.0
    server, thread, base = serve_api(api)
    qc = QueryClient(base, timeout=120)
    out = {}
    try:
        batches0 = store.counter_block()["batches"]
        # -- answers on the quiescent store ---------------------------------
        # The routes first: the engine's first dependency read runs the
        # store's pending sweep, a frontier move, before any answer is
        # kept.
        t = time.perf_counter()
        known_tids = [tr[0].trace_id for tr in known]
        for tid in known_tids:
            want = direct_json(oracle_api, f"/api/trace/{_hex_id(tid)}")
            if want[0] != 200 or qc.trace(tid) != want[1]:
                fail(f"http: /api/trace/{_hex_id(tid)} differs from the "
                     f"oracle server's")
        svcs = sorted(store.get_all_service_names())
        routes = [("/api/services", {}), ("/api/dependencies", {})]
        for svc in COLD_SERVICES + svcs[:5]:
            routes += [("/api/spans", {"serviceName": svc}),
                       ("/api/quantiles", {"serviceName": svc,
                                           "q": "0.5,0.9,0.99"})]
        for path, params in routes:
            direct_json(api, path, params)  # the engine's first compute
            qs = "&".join(f"{k}={quote(v, safe='')}"
                          for k, v in params.items())
            status, _, body = http_call(base + path + ("?" + qs if qs
                                                       else ""))
            if (status, json.loads(body)) != direct_json(api, path, params):
                fail(f"http: {path} {params} over the socket differs from "
                     f"api.handle")
        wrong, nonempty = [], 0
        for qr in pool:
            params = query_params(qr)
            if extract_query(params) != qr:
                fail(f"http: /api/query params do not map back to {qr}")
            got = qc.query(quote(qr.service_name, safe=""), **{
                k: quote(v, safe="") for k, v in params.items()
                if k != "serviceName"})
            want = query_json(service, qr)
            wrong += [qr] if got != want else []
            nonempty += bool(want["traceIds"])
        if wrong:
            fail(f"http: {len(wrong)} of {len(pool)} /api/query answers "
                 f"differ from the direct QueryService's, first {wrong[0]}")
        if nonempty < len(pool) // 2:
            fail(f"http: only {nonempty} of {len(pool)} pool requests "
                 f"answer any trace")
        out["answers"] = {"pool_requests": len(pool),
                          "pool_nonempty": nonempty,
                          "known_traces": len(known_tids),
                          "routes": len(routes),
                          "s": time.perf_counter() - t}
        if store.counter_block()["batches"] != batches0:
            fail("http: the answers phase launched an ingest step")

        # -- timed reads through the sockets --------------------------------
        rng = np.random.default_rng(58)
        reqs = [pool[int(rng.integers(len(pool)))]
                for _ in range(scale.query_requests)]
        handle_h = api.request_latency.labels(route="/api/query")
        tier_h = {tier: service.engine.h_serve.labels(tier=tier)
                  for tier in ("sketch", "cache", "index")}
        marks = {"handle": sketch_mark(handle_h),
                 **{k: sketch_mark(h) for k, h in tier_h.items()}}
        client_ms = [[] for _ in range(scale.query_readers)]
        errors = []
        args = [(qr.service_name, {k: quote(v, safe="")
                                   for k, v in query_params(qr).items()
                                   if k != "serviceName"}) for qr in reqs]

        def reader(k):
            cl = QueryClient(base, timeout=120)
            try:
                for svc, params in args[k::scale.query_readers]:
                    t0 = time.perf_counter()
                    cl.query(quote(svc, safe=""), **params)
                    client_ms[k].append((time.perf_counter() - t0) * 1e3)
            except Exception as e:  # surfaced below, on the main thread
                errors.append(e)

        K.reset_launches()
        with DeviceIdle(torch, device) as idle:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=reader, args=(k,))
                       for k in range(scale.query_readers)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            drive_s = time.perf_counter() - t0
        if errors or any(th.is_alive() for th in threads):
            fail(f"http: a reader failed: {errors[:1]!r}")
        if any(K.LAUNCHES.values()) or \
                store.counter_block()["batches"] != batches0:
            fail(f"http: the timed reads launched {dict(K.LAUNCHES)}")
        cms = np.array([m for ms in client_ms for m in ms])
        handle = sketch_since(handle_h, marks["handle"])
        if handle["count"] != len(reqs) or cms.size != len(reqs):
            fail(f"http: {handle['count']} handled, {cms.size} answered of "
                 f"{len(reqs)} requests")
        out["timed_reads"] = {
            "readers": scale.query_readers, "requests": len(reqs),
            "drive_s": drive_s, "reads_per_s": len(reqs) / drive_s,
            "client_ms_p50": float(np.percentile(cms, 50)),
            "client_ms_p99": float(np.percentile(cms, 99)),
            "client_ms_mean": float(cms.mean()),
            "handle_ms": handle,
            "serve_by_tier": {k: sketch_since(h, marks[k])
                              for k, h in tier_h.items()},
            "http_ms_mean": float(cms.mean()) - handle["mean_ms"],
            "http_share": 1.0 - handle["mean_ms"] / float(cms.mean()),
            "idle_share": (idle.result["idle_share"] if idle.result
                           else "not measured"),
            "device_busy_ms": (idle.result["device_busy_ms"]
                               if idle.result else "not measured")}
        log("http (timed reads): " + json.dumps(out["timed_reads"]))

        # -- ingest through POST /scribe ------------------------------------
        late_ts = WIN_BASE_US + (scale.query_launches + scale.query_writes
                                 + 1) * WIN_STEP_US
        late = cold_known(HTTP_LATE_KNOWN, 57, late_ts)
        batch, _, _ = gen.next_batch(
            HTTP_SCRIBE_CALLS * scale.scribe_call // 7, base_ts=late_ts)
        stream = [span_to_scribe_message(s)
                  for s in store.codec.decode(batch)]
        size = scale.scribe_call
        calls = [[("zipkin", m) for m in stream[i:i + size]]
                 for i in range(0, len(stream), size)]
        for k, tr in enumerate(late):
            c = k * len(calls) // len(late)
            calls[c] = [("zipkin", span_to_scribe_message(s))
                        for s in tr] + calls[c]
        sent = len(stream) + sum(len(tr) for tr in late)
        if http_call(base + "/vars/sampleRate")[2] != b'{"sampleRate": 1.0}':
            fail("http: the collector's sample rate is not 1.0")
        K.reset_launches()
        steps0 = store.counter_block()["batches"]
        t = time.perf_counter()
        acks = []
        for call in calls:
            body = json.dumps([{"category": c, "message": m}
                               for c, m in call]).encode()
            t0 = time.perf_counter()
            status, _, resp = http_call(base + "/scribe", body)
            acks.append((time.perf_counter() - t0) * 1e3)
            if (status, json.loads(resp)) != (200, {"result": "OK"}):
                fail(f"http: POST /scribe answered {status} {resp[:200]!r}")
        collector.flush()
        sync(torch, device)
        ingest_s = time.perf_counter() - t
        late_store = InMemorySpanStore()
        for tr in late:
            late_store.apply(tr)
        late_svc = QueryService(late_store, registry=obs.Registry())
        late_api = ApiServer(late_svc, self_trace=False,
                             registry=obs.Registry())
        try:
            for tr in late:
                tid = tr[0].trace_id
                want = direct_json(late_api, f"/api/trace/{_hex_id(tid)}")
                if want[0] != 200 or qc.trace(tid) != want[1]:
                    fail(f"http: late trace {_hex_id(tid)} read back "
                         f"differs from the oracle's")
        finally:
            late_svc.close()
        # One self-traced request: its span, found by the echoed id.
        api.tracer.sample_rate = 1.0
        try:
            _, hdrs, _ = http_call(base + "/api/services", headers={
                "X-B3-TraceId": "5eed", "X-B3-SpanId": "77"})
        finally:
            api.tracer.sample_rate = 0.0
        collector.flush()
        sync(torch, device)
        spans = qc.trace(0x5EED)
        if [s["id"] for s in spans] != [hdrs.get("X-B3-SpanId")] or \
                spans[0]["name"] != "get /api/services":
            fail(f"http: the self-traced request's span reads back as "
                 f"{spans}")
        launches = dict(K.LAUNCHES)
        steps = store.counter_block()["batches"] - steps0
        check_launches(launches, ("flat_histogram", "arena_claim",
                                  "arena_write"), device, "http", steps)
        for half in ("arena_claim", "arena_write"):
            if device.type == "cuda" and launches[half] != steps:
                fail(f"http: {half} launched {launches[half]} times in "
                     f"{steps} steps, not once a step")
        if steps < len(calls):
            fail(f"http: {steps} ingest steps for {len(calls)} calls")
        if collector.spans_stored != sent + 1:
            fail(f"http: the collector stored {collector.spans_stored} "
                 f"spans, {sent} sent and 1 self-traced")
        out["ingest"] = {"calls": len(calls), "spans": sent,
                         "late_known": len(late), "steps": steps,
                         "ack_ms": acks, "s": ingest_s}
        out["kernel_launches"] = launches
        out["ingest_steps"] = steps

        # -- /metrics -------------------------------------------------------
        status, hdrs, body = http_call(base + "/metrics")
        text = body.decode()
        bad = [ln for ln in text.splitlines()
               if ln and not ln.startswith("#") and not PROM_LINE.match(ln)]
        if status != 200 or bad:
            fail(f"http: /metrics is not Prometheus text: {bad[:3]}")
        keys = set(store.counters())
        have = set(re.findall(r'^zipkin_store_counter\{name="([^"]+)"\} ',
                              text, re.M))
        if have != keys:
            fail(f"http: /metrics store counters {sorted(have ^ keys)} "
                 f"missing or extra")
        status, _, body = http_call(base + "/metrics?format=json")
        mj = json.loads(body)
        new = ("jit_compiles", "query_jit_compiles", "rank_path_counting",
               "scatter_path_pallas")
        if {k[6:] for k in mj if k.startswith("store.")} != keys or \
                not all(f"store.{k}" in mj for k in new):
            fail("http: /metrics?format=json lacks a store counter")
        out["metrics"] = {"lines": len(text.splitlines()),
                          "store_counters": len(keys),
                          **{k: mj[f"store.{k}"] for k in new}}

        # -- POST /debug/profile with reads meanwhile -----------------------
        got, stop = {}, threading.Event()

        def capture():
            got["resp"] = http_call(base + "/debug/profile?seconds=0.5",
                                    b"")

        reads = [0]

        def read_meanwhile():
            while not stop.is_set():
                qc.trace(known_tids[reads[0] % len(known_tids)])
                reads[0] += 1

        cap = threading.Thread(target=capture)
        cap.start()
        deadline = time.perf_counter() + 60
        while not obs_profile._capture_lock.locked():
            if time.perf_counter() > deadline or not cap.is_alive():
                break
            time.sleep(0.001)
        busy = http_call(base + "/debug/profile?seconds=0.5", b"")
        rd = threading.Thread(target=read_meanwhile)
        rd.start()
        cap.join(timeout=300)
        stop.set()
        rd.join(timeout=300)
        status, _, body = got.get("resp", (None, None, b"{}"))
        if status != 200 or busy[0] != 409:
            fail(f"http: /debug/profile answered {status} {body[:200]!r}, "
                 f"the second capture {busy[0]}")
        prof = json.loads(body)
        try:
            with open(os.path.join(prof["profileDir"],
                                   obs_profile.TRACE_FILE)) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(prof["profileDir"], ignore_errors=True)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if device.type == "cuda" and not kernels:
            fail(f"http: the profile of {reads[0]} reads holds no CUDA "
                 f"kernel")
        out["profile"] = {"seconds": prof["seconds"], "reads": reads[0],
                          "events": len(events),
                          "kernel_events": len(kernels),
                          "busy_status": busy[0]}
    finally:
        stop_api(server, thread)
        collector.close()
    out["s"] = time.perf_counter() - t_phase
    log("http: " + json.dumps({k: v for k, v in out.items()
                               if k != "timed_reads"}))
    return out


def paged_http_combos(K, card, cpu, tids, device):
    """``GET /api/combo/<id>`` through a server over the paged card
    store's ``QueryService``: each equals the same route of a server over
    its CPU twin, and the page gather launches (single-id reads miss the
    engine's cache, which holds the 25-id chunks read before)."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.api import ApiServer
    from zipkin_tpu_torch.ingest.receiver import _hex_id

    card_api = ApiServer(card, self_trace=False, registry=obs.Registry())
    cpu_api = ApiServer(cpu, self_trace=False, registry=obs.Registry())
    server, thread, base = serve_api(card_api)
    try:
        K.reset_launches()
        t = time.perf_counter()
        for tid in tids:
            path = f"/api/combo/{_hex_id(tid)}"
            status, _, body = http_call(base + path)
            want = direct_json(cpu_api, path)
            if want[0] != 200 or (status, json.loads(body)) != want:
                fail(f"query path (paged): {path} over the socket differs "
                     f"from the CPU twin's server")
        read_s = time.perf_counter() - t
        launches = dict(K.LAUNCHES)
    finally:
        stop_api(server, thread)
    if device.type == "cuda" and launches["paged_page_gather"] <= 0:
        fail("query path (paged): the combos through the server did not "
             "launch the page gather")
    return {"combos": len(tids), "read_s": read_s,
            "read_launches": launches}


def query_paged(torch, K, dev, scale, device, known, oracle_svc):
    """``QueryService`` over a paged store at 2^14 (128-row pages) on the
    card and over its CPU twin: the known traces' combos (trace reads
    through the page gather) and the known-service requests equal the
    twin's and the oracle's; the gather's launches are counted."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.query import Order, QueryService
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore

    cfg = full_config(dev, scale.dur_paged_log2, scale.services,
                      **paged_layout(scale))
    applies = span_applies(scale, 2, scale.dur_paged_traces, WIN_STEP_US,
                           seed=54)
    known_spans = [s for tr in known for s in tr]
    services = {}
    for d in dict.fromkeys((device.type, "cpu")):
        st = TorchSpanStore(cfg, device=d, registry=obs.Registry())
        for spans in applies:
            st.apply(spans)
        st.apply(known_spans)
        services[d] = QueryService(st, registry=obs.Registry())
    card, cpu = services[device.type], services["cpu"]
    tids = [tr[0].trace_id for tr in known]
    try:
        K.reset_launches()
        t = time.perf_counter()
        got = []
        for i in range(0, len(tids), 25):
            got += card.get_trace_combos_by_ids(tids[i:i + 25])
        sync(torch, device)
        read_s = time.perf_counter() - t
        launches = dict(K.LAUNCHES)
        if device.type == "cuda" and launches["paged_page_gather"] <= 0:
            fail("query path (paged): the combos did not launch the page "
                 "gather")
        want = []
        for i in range(0, len(tids), 25):
            want += cpu.get_trace_combos_by_ids(tids[i:i + 25])
        if got != want or len(got) != len(tids):
            fail("query path (paged): combos differ from the CPU twin's")
        combos_vs(card, oracle_svc, tids, "query path (paged)")
        for svc in COLD_SERVICES:
            for order in Order:
                qr = query_request(svc, None, ("service",), 10, order)
                a = card.get_trace_ids(qr)
                if a != cpu.get_trace_ids(qr) or \
                        a != oracle_svc.get_trace_ids(qr):
                    fail(f"query path (paged): {svc} {order} differs")
        http = paged_http_combos(K, card, cpu, tids[:10], device)
    finally:
        for s in services.values():
            s.close()
    out = {"capacity": cfg.capacity, "pages": cfg.n_pages,
           "combos": len(got), "combos_read_s": read_s,
           "read_launches": launches, "http": http}
    log("query path (paged): " + json.dumps(out))
    return out


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
    bound_ms = bound(sum(rows), sum(touched))
    dev_ms, profiled = checked_device_ms(
        torch, fused, "hist_multi", bound_ms, 1,
        f"flat_histogram ({n_sites} sites)")
    row = {"sites": len(scratch), "rows": sum(rows),
           "cells": sum(c.numel() for c, _, _ in scratch),
           "touched": sum(touched), "ms": time_ms(torch, fused),
           "host_us": host_us(fused),
           "device_ms": dev_ms, "device_profile": profiled,
           "plain_ms": time_ms(torch, lambda: K.histogram_update_many_plain(
               scratch)),
           "library_ms": time_ms(torch, library),
           "library": f"{n_sites} index_put_(accumulate=True) calls in a "
                      f"row",
           "bound_ms": bound_ms, "bound_by": "bytes",
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

        site_bound = bound(idx.numel(), touched[k])
        site_rows.append({
            "site": k, "cells": counts.numel(), "rows": idx.numel(),
            "touched": touched[k], "ms": time_ms(torch, call),
            "device_ms": checked_device_ms(
                torch, call, "hist_multi", site_bound, 1,
                f"flat_histogram site {k} alone")[0],
            "plain_ms": time_ms(torch, lambda: K.histogram_update_plain(
                c, idx)),
            "library_ms": time_ms(torch, lib_one),
            "bound_ms": site_bound, "max_abs_err": err})
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


def step_vs_plain(K, rec, what: str, n_sites: int):
    """K1's fused call and both K2 halves on a path's recorded first
    step against their plain versions, bitwise: the fused histogram of
    its ``n_sites`` sites, the claim's rank and counts (and the ones the
    path's own claim passed on to the write), and the write from the
    path's own claim. Fails on any difference."""
    if len(rec.hist) != n_sites or rec.claim is None or rec.write is None:
        fail(f"{what}: recorded {len(rec.hist)} flat_histogram sites (not "
             f"{n_sites}) or no arena_claim / arena_write call")
    want = [(c.clone(), i, w) for c, i, w in rec.hist]
    K.histogram_update_many_plain(want)
    got = [(c.clone(), i, w) for c, i, w in rec.hist]
    K.histogram_update_many(got)
    err = max(_disagree(g[0], w[0]) for g, w in zip(got, want))
    if err:
        fail(f"{what}: fused flat_histogram disagrees (max err {err})")
    cells = sum(c.numel() for c, _, _ in rec.hist)
    rows = sum(i.numel() for _, i, _ in rec.hist)
    del got, want
    bucket, valid, n_b = rec.claim
    entries, wargs = rec.write
    p_rank, p_cnt, wbucket, base, slot0, depth, vals, wvalid = wargs
    if not (wbucket.equal(bucket) and wvalid.equal(valid)):
        fail(f"{what}: the step's claim and write saw different rows")
    want_r, want_c = K.arena_claim_plain(bucket, valid, n_b)
    got_r, got_c = K.arena_claim(bucket, valid, n_b)
    err = max(_disagree(got_r, want_r), _disagree(got_c, want_c),
              _disagree(p_rank, want_r), _disagree(p_cnt, want_c))
    if err:
        fail(f"{what}: arena_claim disagrees (max err {err})")
    want = K.arena_write_plain(entries.clone(), want_r, want_c, bucket,
                               base, slot0, depth, vals, valid)
    got = K.arena_write(entries.clone(), *wargs)
    err = _disagree(got, want)
    if err:
        fail(f"{what}: arena_write disagrees (max err {err})")
    out = {"hist_sites": n_sites, "hist_rows": rows, "hist_cells": cells,
           "arena_rows": bucket.numel(), "buckets": n_b,
           "arena_slots": entries.shape[0], "max_abs_err": 0}
    log(f"{what}: K1 (fused) and both K2 halves equal their plain "
        f"versions on the first step: " + json.dumps(out))
    return out


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
    [14, capacity] int64 matrix, without and with the stack of the 14
    columns timed."""
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
    # Like for like: K3 reads the columns in place, so the library route
    # pays the stack of the 14 columns too.
    lib_stacked = time_ms(torch, lambda: torch.index_select(
        torch.stack([c.to(torch.int64) for c in cols]), 1, slots), reps=20)
    k = pages.numel()
    k_real = int(((pages >= 0) & (pages < n_pages)).sum())
    read_b = k_real * R * sum(c.element_size() for c in cols)
    write_b = k * R * len(cols) * 8
    row = {"pages": k, "live_pages": k_real, "page_rows": R,
           "columns": len(cols), "capacity": cols[0].numel(),
           "cases": ["main-path read", "hole pages"], "ms": ms,
           "uncached_ms": uncached_ms, "device_ms": dev_ms,
           "plain_ms": plain, "library_ms": lib,
           "library_with_stack_ms": lib_stacked,
           "bound_ms": (read_b + write_b) / H100_BYTES_PER_S * 1e3,
           "bytes": read_b + write_b, "max_abs_err": 0}
    log("paged_page_gather: " + json.dumps(row))
    return row


def _check_states_equal(a, b, what):
    float_leaves = ("dep_window", "dep_moments", "dep_banks")
    for k, ref in a.items():
        got = b[k]
        if k == "counters":
            if {c: np.asarray(v).tolist() for c, v in ref.items()} != {
                    c: np.asarray(v).tolist() for c, v in got.items()}:
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
    (four buckets a batch: the slot ring laps), on the card (kernels)
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


# ---------------------------------------------------------------------------
# The sharded store: N shards on the one card
# ---------------------------------------------------------------------------

SHARDS = 4
SHARD_READ_REPS = 10


def _timed_calls(torch, device, obj, name, into):
    """Wraps ``obj.name`` so each call adds its seconds (synchronised
    before and after on the card) to ``into``; returns the original."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        sync(torch, device)
        t = time.perf_counter()
        out = fn(*a, **kw)
        sync(torch, device)
        into.append(time.perf_counter() - t)
        return out

    setattr(obj, name, timed)
    return fn


def _timed_method(obj, name, into):
    """Wraps ``obj.name`` so each call adds its host seconds to
    ``into``."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        into.append(time.perf_counter() - t)
        return out

    setattr(obj, name, timed)


def _by_service(store, arr, names):
    """Rows of a [max_services, ...] leaf keyed by service name (the
    fleet and a single store intern names in different orders)."""
    d = store.dicts.services
    return {n: arr[d.get(n)] for n in names}


def _links_close(a, b) -> bool:
    """Equal dependency links, counts exact, moments by stated
    tolerance 2."""
    from zipkin_tpu_torch.testing.crash import moments_close

    def rows(deps):
        return sorted((lk.parent, lk.child, tuple(
            float(getattr(lk.duration_moments, f))
            for f in ("n", "mean", "m2", "m3", "m4"))) for lk in deps.links)

    ra, rb = rows(a), rows(b)
    if [r[:2] for r in ra] != [r[:2] for r in rb]:
        return False
    return not ra or moments_close([r[2] for r in ra], [r[2] for r in rb])


def _fleet_device_merge(torch, fleet):
    """The device's cross-shard merge of the mirrored leaves: the
    lifetime arrays by the catalog bundle (sums, HLL max), the window
    cells by the epoch rule (max epoch, then the masked sums and max)."""
    bundle = fleet._fetch_cat_bundle()
    st = fleet.states

    def stack(f):
        return torch.stack([getattr(s, f) for s in st])

    epochs = stack("win_epoch")
    top = epochs.amax(0)
    live = (epochs == top[None])[:, None, :, None]
    out = [bundle[k] for k in ("svc_hist", "ann_svc_counts",
                               "name_presence", "ann_value_counts",
                               "bann_key_counts", "hll_traces")]
    counts, sums, mm = stack("win_counts"), stack("win_sums"), stack("win_mm")
    out += [top.cpu().numpy(),
            torch.where(live, counts, 0).sum(0, dtype=counts.dtype)
            .cpu().numpy(),
            torch.where(live, sums, 0).sum(0, dtype=sums.dtype)
            .cpu().numpy(),
            torch.where(live, mm, torch.full_like(mm, -2**31)).amax(0)
            .cpu().numpy()]
    return out


def _fleet_mirror_check(torch, fleet, what):
    """The FleetMirror (fed by the commits' deltas) bitwise equal to the
    device merge; then marked cold, resynced from the shards' leaves
    (``ensure_sketch_mirror``), equal again."""
    want = _fleet_device_merge(torch, fleet)
    for stage in ("deltas", "resync"):
        if stage == "resync":
            fleet._fleet_mirror.mark_cold()
            if fleet._fleet_mirror.warm:
                fail(f"{what}: the fleet mirror stayed warm")
        got = fleet.ensure_sketch_mirror().arrays()
        for i, (a, b) in enumerate(zip(want, got)):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                fail(f"{what}: the fleet mirror ({stage}) differs from the "
                     f"device merge in array {i}")


def _dispatcher_check(fleet, services, what):
    """8 reader threads released at a barrier: at most 2 fused
    cross-shard reads, answers equal to the serialized ones."""
    svcs = services[:4]
    end = 2**62
    serial = ([fleet.service_duration_quantiles(s, [0.5, 0.99])
               for s in svcs]
              + [fleet.get_trace_ids_by_name(s, None, end, 10)
                 for s in svcs])
    fleet.dispatcher.drain()
    fleet.dispatcher.window_s = 0.5
    barrier = threading.Barrier(9)
    got, errors = {}, []

    def run(i):
        try:
            barrier.wait(timeout=120)
            s = svcs[i % 4]
            got[i] = (fleet.service_duration_quantiles(s, [0.5, 0.99])
                      if i < 4 else
                      fleet.get_trace_ids_by_name(s, None, end, 10))
        except BaseException as e:  # noqa: BLE001 — failed below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), name=f"fleet-{i}")
               for i in range(8)]
    for t in threads:
        t.start()
    before = fleet.collective_launches()
    barrier.wait(timeout=120)
    for t in threads:
        t.join(timeout=300)
    fleet.dispatcher.window_s = 0.0
    if any(t.is_alive() for t in threads) or errors:
        fail(f"{what}: a dispatcher reader failed or hung: {errors[:3]}")
    fused = fleet.collective_launches() - before
    if fused > 2:
        fail(f"{what}: 8 concurrent reads took {fused} fused cross-shard "
             f"reads, not <= 2")
    if [got[i] for i in range(8)] != serial:
        fail(f"{what}: dispatched answers differ from the serialized ones")
    return {"fused_reads": fused, **fleet.dispatcher.stats()}


def _read_ms(fleet, known_tids):
    """Host ms of each read kind, ``SHARD_READ_REPS`` calls each."""
    kinds = {
        "bundle_catalog": fleet._fetch_cat_bundle,
        "index": lambda: fleet._get_trace_ids_by_name_direct(
            COLD_SERVICES[0], None, 2**62, 10),
        "trace_fetch": lambda: fleet.get_spans_by_trace_ids(
            known_tids[:10]),
        "dependencies": fleet.get_dependencies,
    }
    out = {}
    for kind, fn in kinds.items():
        fn()
        ms = []
        for _ in range(SHARD_READ_REPS):
            t = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t) * 1e3)
        out[kind] = {"p50": float(np.percentile(ms, 50)),
                     "p99": float(np.percentile(ms, 99))}
    return out


def _fleet_vs_single(torch, fleet, single, known, what):
    """The fleet's reads equal the single store's: the known traces by
    id, existence, durations, the catalogs, the summed count leaves and
    the HLL registers, the dependency links, the index reads."""
    from zipkin_tpu_torch.parallel.shard import global_summary

    tids = [tr[0].trace_id for tr in known]
    ask = tids + [12345]
    checks = {
        "spans by id": lambda s: s.get_spans_by_trace_ids(tids),
        "traces_exist": lambda s: s.traces_exist(ask),
        "durations": lambda s: s.get_traces_duration(ask),
        "services": lambda s: s.get_all_service_names(),
    }
    for name, read in checks.items():
        if read(fleet) != read(single):
            fail(f"{what}: {name} differs from the single store's")
    if len(fleet.get_spans_by_trace_ids(tids)) != len(tids):
        fail(f"{what}: a known trace is missing")
    services = sorted(single.get_all_service_names())
    sample = COLD_SERVICES + services[:: max(1, len(services) // 20)]
    end = 2**62
    for svc in sample:
        if fleet.get_span_names(svc) != single.get_span_names(svc):
            fail(f"{what}: span names of {svc} differ")
        if (fleet.service_duration_quantiles(svc, [0.5, 0.99])
                != single.service_duration_quantiles(svc, [0.5, 0.99])):
            fail(f"{what}: quantiles of {svc} differ")
    nonempty = 0
    for svc in COLD_SERVICES:
        reads = [lambda s, lim=lim: s.get_trace_ids_by_name(svc, None, end,
                                                            lim)
                 for lim in (10, 100)]
        reads += [lambda s, a=a, v=v: s.get_trace_ids_by_annotation(
            svc, a, v, end, 100) for a, v in (
                ("some custom annotation", None),
                ("http.uri", b"/api/widgets"))]
        for read in reads:
            a = sorted((i.trace_id, i.timestamp) for i in read(fleet))
            b = sorted((i.trace_id, i.timestamp) for i in read(single))
            if a != b:
                fail(f"{what}: an index read of {svc} differs")
            nonempty += bool(a)
    if nonempty < len(COLD_SERVICES):
        fail(f"{what}: the known services' index reads are empty")
    summary = {k: v.cpu().numpy()
               for k, v in global_summary(fleet.states).items()}
    st = single.state
    for leaf in ("cms_trace_spans", "hll_traces"):
        if not np.array_equal(summary[leaf], getattr(st, leaf).cpu().numpy()):
            fail(f"{what}: the summed {leaf} differs from the single store's")
    for leaf in ("svc_hist", "svc_span_counts", "ann_svc_counts"):
        a = _by_service(fleet, summary[leaf], services)
        b = _by_service(single, getattr(st, leaf).cpu().numpy(), services)
        if any(not np.array_equal(a[n], b[n]) for n in services):
            fail(f"{what}: the summed {leaf} differs from the single "
                 f"store's")
    if int(summary["spans_seen"]) != int(st.counters["spans_seen"]):
        fail(f"{what}: spans_seen differs")
    deps_f, deps_s = fleet.get_dependencies(), single.get_dependencies()
    if not deps_s.links or not _links_close(deps_f, deps_s):
        fail(f"{what}: the dependency links differ beyond tolerance 2")
    return {"services_compared": len(sample),
            "dependency_links": len(deps_s.links),
            "known_traces": len(tids)}


def _fleet_parity(torch, dev, scale, rehearse: bool):
    """The fleet at 2 shards and capacity 2^14 (the other widths full)
    on the card and on the CPU: equal ``sharded_states_to_numpy``
    leaves (integers bitwise, moments by stated tolerance 2) and equal
    fleet mirrors."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.parallel.shard import ShardedSpanStore
    from zipkin_tpu_torch.store.convert import sharded_states_to_numpy

    cfg = full_config(dev, scale.small_log2, scale.services)
    applies = span_applies(scale, scale.shard_parity_applies,
                           scale.small_traces, PARITY_STEP_US, seed=73)
    out = []
    for device in ("cpu" if rehearse else "cuda", "cpu"):
        fleet = ShardedSpanStore(2, cfg, device=device,
                                 registry=obs.Registry())
        for spans in applies:
            fleet.apply(spans)
        out.append((sharded_states_to_numpy(fleet.states),
                    fleet.ensure_sketch_mirror().arrays()))
        fleet.close()
    _check_states_equal(out[1][0], out[0][0], "sharded parity")
    for a, b in zip(out[0][1], out[1][1]):
        if not np.array_equal(a, b):
            fail("sharded parity: the card and cpu fleet mirrors differ")
    wp = out[0][0]["write_pos"]
    log(f"sharded parity: cuda and cpu fleets equal after "
        f"{int(wp.sum())} spans ({[int(x) for x in wp]} a shard, capacity "
        f"{cfg.capacity})")
    return int(wp.sum())


def sharded_path(torch, K, dev, scale, device, smi):
    """The sharded store (``parallel.ShardedSpanStore``) with ``SHARDS``
    shards at BASELINE config #2 on the one card, beside one
    ``TorchSpanStore`` at the same config: the same Span lists through
    ``apply`` (launch units of 114,688 spans, then the known traces on
    services of their own); K1, the claim and the write launch once a
    shard step, ``SHARDS`` a unit, empty shards included; the fleet's
    reads equal the single store's; the FleetMirror equals the device
    merge (fed by deltas, then resynced); 8 dispatched readers take at
    most 2 fused reads; a 2-shard fleet at 2^14 equals its CPU twin.
    Returns (result, the decoded units, for
    ``sharded_durability_path``)."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.columnar.encode import SpanCodec
    from zipkin_tpu_torch.parallel import shard as shard_mod
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    what = "sharded path"
    cfg = full_config(dev, scale.cap_log2, scale.services)
    t = time.perf_counter()
    codec = SpanCodec()
    gen = ColumnarTraceGen(codec.dicts,
                           n_services=scale.services - len(COLD_SERVICES),
                           n_span_names=scale.names - len(COLD_OPS),
                           topology=True, seed=71)
    units = []
    for i in range(scale.shard_units):
        batch, _, _ = gen.next_batch(scale.batch_traces,
                                     base_ts=WIN_BASE_US + i * WIN_STEP_US)
        units.append(codec.decode(batch))
    known = cold_known(scale.cold_known, 72, WIN_BASE_US + WIN_US)
    setup_s = time.perf_counter() - t
    free_card(torch, device)
    fleet = shard_mod.ShardedSpanStore(SHARDS, cfg, device=device.type,
                                       registry=obs.Registry())
    apply_s, step_s, summary_s = [], [], []
    orig_step = _timed_calls(torch, device, fleet.inner, "step", step_s)
    orig_summary = _timed_calls(torch, device, shard_mod, "_summarize",
                                summary_s)
    K.reset_launches()
    try:
        for spans in units:
            sync(torch, device)
            t = time.perf_counter()
            fleet.apply(spans)
            sync(torch, device)
            apply_s.append(time.perf_counter() - t)
    finally:
        fleet.inner.step = orig_step
        shard_mod._summarize = orig_summary
    launches = dict(K.LAUNCHES)
    steps = sum(int(b["batches"]) for b in fleet.shard_counters())
    n_units = len(units)
    if device.type == "cuda":
        for k in ("flat_histogram", "arena_claim", "arena_write"):
            if launches[k] != SHARDS * n_units:
                fail(f"{what}: {k} launched {launches[k]} times in "
                     f"{n_units} units of {SHARDS} shards")
    if steps != SHARDS * n_units:
        fail(f"{what}: {steps} shard steps in {n_units} units")
    fleet.apply([s for tr in known for s in tr])
    single = TorchSpanStore(cfg, device=device.type,
                            registry=obs.Registry())
    for spans in units:
        single.apply(spans)
    single.apply([s for tr in known for s in tr])
    sync(torch, device)
    wp = [int(b["write_pos"]) for b in fleet.shard_counters()]
    if max(wp) > cfg.capacity or single.counter_block()["ring_laps"]:
        fail(f"{what}: a ring lapped ({wp}); the single store must hold "
             f"every span")
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    compared = _fleet_vs_single(torch, fleet, single, known, what)
    del single
    free_card(torch, device)
    _fleet_mirror_check(torch, fleet, what)
    services = sorted(fleet.get_all_service_names())
    dispatch = _dispatcher_check(
        fleet, COLD_SERVICES[:2] + [s for s in services
                                    if s not in COLD_SERVICES][:2], what)
    reads = _read_ms(fleet, [tr[0].trace_id for tr in known])
    sync(torch, device)
    t = time.perf_counter()
    shard_mod.global_summary(fleet.states)
    sync(torch, device)
    reduce_ms = (time.perf_counter() - t) * 1e3
    spans_unit = [len(u) for u in units]
    timed = sum(apply_s[1:])
    per_unit = [{"host_encode_build_ms": (a - s) * 1e3,
                 "steps_ms": (s - m) * 1e3, "summary_ms": m * 1e3}
                for a, s, m in zip(apply_s, step_s, summary_s)]
    known_reads = known_read_digests(fleet, [tr[0].trace_id for tr in known])
    fleet.close()
    del fleet
    free_card(torch, device)
    parity_spans = _fleet_parity(torch, dev, scale, device.type != "cuda")
    result = {
        "shards": SHARDS, "units": n_units, "spans_per_unit": spans_unit,
        "known_traces": len(known), "setup_decode_s": setup_s,
        "apply_spans_per_s": (sum(spans_unit[1:]) / timed if timed
                              else None),
        "apply_s": apply_s, "per_unit": per_unit,
        "reduction_ms": reduce_ms, "read_ms": reads,
        "dispatcher": dispatch, "compared": compared,
        "write_pos_by_shard": wp, "peak_device_bytes": peak,
        "parity_spans": parity_spans, "card": smi,
        "kernel_launches": launches, "ingest_steps": steps}
    log(f"sharded path result ({smi}): " + json.dumps(result))
    return result, units, known_reads


def known_read_digests(store, tids):
    """{trace id: sha256} of each trace's reads: its spans as a set and
    its duration."""
    import hashlib

    durations = {d.trace_id: d for d in store.get_traces_duration(tids)}
    out = {}
    for spans in store.get_spans_by_trace_ids(tids):
        tid = spans[0].trace_id
        text = repr((sorted(repr(s) for s in spans), durations.get(tid)))
        out[str(tid)] = hashlib.sha256(text.encode()).hexdigest()
    return out


MULTIHOST_PROCS = 2
MULTIHOST_LOCAL = 2
# Every wait of the multi-process phase: a worker's start, rendezvous
# and unit decode, then its card drive.
MULTIHOST_WAIT_S = 600
MULTIHOST_BIND_TRIES = 3
MULTIHOST_READY = "multihost worker ready"


def multihost_worker(coordinator: str, pid: int, device: str,
                     rehearse: bool) -> None:
    """One process of ``multihost_path``, run as ``python3 -c "import
    chip_smoke; chip_smoke.multihost_worker(...)"``: joins the gloo group
    of ``MULTIHOST_PROCS`` processes through ``multihost.initialize``,
    builds the global view with ``MULTIHOST_LOCAL`` shard slots a
    process, decodes ``sharded_path``'s first unit and its known traces
    and routes them to the shards it owns; prints ``MULTIHOST_READY``
    and waits for ``go`` on its standard input before it touches the
    card's memory. Then a ``ShardedSpanStore(MULTIHOST_LOCAL)`` at
    config #2 takes the kept unit and the kept known traces through
    ``apply``; every kept span must sit on the local slot of its global
    shard, K1, the claim and the write must launch once a shard step
    (both counted), and the owned known traces must read back whole.
    The kept trace ids, span counts and read digests are gathered over
    gloo, and each process checks that the kept and the read trace sets
    are disjoint, cover the unit and its known traces, and lie on
    shards their keeper owns.
    The last line of its standard output is its JSON result."""
    import torch
    import torch.distributed as dist

    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.columnar.encode import SpanCodec
    from zipkin_tpu_torch.ops import kernels as K
    from zipkin_tpu_torch.parallel import multihost as mh
    from zipkin_tpu_torch.parallel import shard as shard_mod
    from zipkin_tpu_torch.store import device as dev
    from zipkin_tpu_torch.tracegen import ColumnarTraceGen

    what = f"multihost worker {pid}"
    scale = Scale(rehearse)
    card = torch.device(device)
    n = MULTIHOST_PROCS * MULTIHOST_LOCAL
    base = MULTIHOST_LOCAL * pid
    out = {"pid": pid}
    t = time.perf_counter()
    mh.initialize(coordinator, MULTIHOST_PROCS, pid)
    mesh = mh.global_mesh(local_shards=MULTIHOST_LOCAL)
    out["mesh_wall"] = time.time()
    out["initialize_s"] = time.perf_counter() - t
    local = mh.local_shard_ids(mesh)
    if (mesh.shape["shard"] != n or len(mesh.devices) != n
            or local != list(range(base, base + MULTIHOST_LOCAL))
            or mh.partitions_for_process(mesh) != local):
        fail(f"{what}: the global view {mesh} gives local shards {local}")
    t = time.perf_counter()
    codec = SpanCodec()
    gen = ColumnarTraceGen(codec.dicts,
                           n_services=scale.services - len(COLD_SERVICES),
                           n_span_names=scale.names - len(COLD_OPS),
                           topology=True, seed=71)
    batch, _, _ = gen.next_batch(scale.batch_traces, base_ts=WIN_BASE_US)
    unit = codec.decode(batch)
    known = cold_known(scale.cold_known, 72, WIN_BASE_US + WIN_US)
    feed = [unit, [s for tr in known for s in tr]]
    routed = [mh.route_spans(spans, n, keep=local) for spans in feed]
    out["unit_s"] = time.perf_counter() - t
    print(MULTIHOST_READY, flush=True)
    if sys.stdin.readline().strip() != "go":
        fail(f"{what}: no go from the parent")
    cfg = full_config(dev, scale.cap_log2, scale.services)
    t = time.perf_counter()
    fleet = shard_mod.ShardedSpanStore(MULTIHOST_LOCAL, cfg, device=device,
                                       registry=obs.Registry())
    step_s, summary_s = [], []
    _timed_calls(torch, card, fleet.inner, "step", step_s)
    _timed_calls(torch, card, shard_mod, "_summarize", summary_s)
    try:
        sync(torch, card)
        out["fleet_s"] = time.perf_counter() - t
        K.reset_launches()
        out["apply_s"], out["spans_kept"] = [], []
        for groups in routed:
            spans = [s for sid in sorted(groups) for s in groups[sid]]
            for sid, group in groups.items():
                if any(fleet._shard_of(s.trace_id) != sid - base
                       for s in group):
                    fail(f"{what}: a span of global shard {sid} does not "
                         f"sit on local slot {sid - base}")
            sync(torch, card)
            t = time.perf_counter()
            fleet.apply(spans)
            sync(torch, card)
            out["apply_s"].append(time.perf_counter() - t)
            out["spans_kept"].append(len(spans))
        launches = dict(K.LAUNCHES)
        out["per_apply"] = [{"host_encode_build_ms": (a - st) * 1e3,
                             "steps_ms": (st - m) * 1e3,
                             "summary_ms": m * 1e3}
                            for a, st, m in zip(out["apply_s"], step_s,
                                                summary_s)]
        steps = sum(int(b["batches"]) for b in fleet.shard_counters())
        if steps != MULTIHOST_LOCAL * len(routed):
            fail(f"{what}: {steps} shard steps in {len(routed)} applies")
        if card.type == "cuda":
            for k in ("flat_histogram", "arena_claim", "arena_write"):
                if launches[k] != steps:
                    fail(f"{what}: {k} launched {launches[k]} times in "
                         f"{steps} shard steps")
        t = time.perf_counter()
        owned = [tr for tr in known if mh.shard_of(tr[0].trace_id, n) in local]
        tids = [tr[0].trace_id for tr in owned]
        if [len(t) for t in fleet.get_spans_by_trace_ids(tids)] != [
                len(tr) for tr in owned]:
            fail(f"{what}: an owned known trace did not read back whole")
        out["reads"] = known_read_digests(fleet, tids)
        out["reads_s"] = time.perf_counter() - t
        out["peak_device_bytes"] = (torch.cuda.max_memory_allocated()
                                    if card.type == "cuda" else 0)
        out["kernel_launches"], out["ingest_steps"] = launches, steps
        out["write_pos_by_shard"] = [int(b["write_pos"])
                                     for b in fleet.shard_counters()]
    finally:
        fleet.close()
    t = time.perf_counter()
    kept = sorted({s.trace_id for groups in routed
                   for g in groups.values() for s in g})
    gathered = [None] * MULTIHOST_PROCS
    dist.all_gather_object(gathered, {"pid": pid, "kept": kept,
                                      "spans": sum(out["spans_kept"]),
                                      "reads": out["reads"]})
    out["gather_s"] = time.perf_counter() - t
    owner = [p for p, _, _ in mesh.devices]
    for key, want in (("kept", {s.trace_id for spans in feed
                                for s in spans}),
                      ("reads", {str(tr[0].trace_id) for tr in known})):
        sets = [set(g[key]) for g in gathered]
        if any(a & b for i, a in enumerate(sets) for b in sets[i + 1:]):
            fail(f"{what}: two processes hold the same trace ({key})")
        if set().union(*sets) != want:
            fail(f"{what}: the processes' traces ({key}) do not cover the "
                 f"unit's")
    if sum(g["spans"] for g in gathered) != sum(len(s) for s in feed):
        fail(f"{what}: the kept spans do not add up to the unit's")
    for g in gathered:
        if any(owner[mh.shard_of(t, n)] != g["pid"] for t in g["kept"]):
            fail(f"{what}: process {g['pid']} kept a trace of a shard it "
                 f"does not own")
    out["kept_traces_by_process"] = [len(g["kept"]) for g in gathered]
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


class MultihostWorkers:
    """The ``MULTIHOST_PROCS`` processes of ``multihost_path``, spawned
    before ``sharded_path`` so that their start, rendezvous and unit
    decode run beside it; ``go()`` lets them onto the card. A rendezvous
    that lost its port (``Address already in use``) spawns both again
    on a fresh one, up to ``MULTIHOST_BIND_TRIES`` times."""

    def __init__(self, device, rehearse: bool):
        self.device, self.rehearse = device, rehearse
        self.work = tempfile.mkdtemp(prefix="zipkin-multihost-")
        self.env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=HERE)
        if device.type == "cuda":
            # No toolkit in reach: a worker that tried to build a kernel
            # would fail, so the drive proves it loads the built ones.
            self.env["CUDA_HOME"] = os.path.join(self.work, "no-cuda-toolkit")
        self.procs, self.tries = [], 0
        self._spawn()

    def _path(self, pid, stream):
        return os.path.join(self.work, f"worker{pid}.{stream}")

    def _spawn(self):
        self.tries += 1
        coordinator = f"127.0.0.1:{free_port()}"
        self.spawned = time.time()
        self.procs = []
        for pid in range(MULTIHOST_PROCS):
            code = (f"import chip_smoke; chip_smoke.multihost_worker("
                    f"{coordinator!r}, {pid}, {self.device.type!r}, "
                    f"{self.rehearse})")
            with open(self._path(pid, "out"), "w") as o, \
                    open(self._path(pid, "err"), "w") as e:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], cwd=HERE, env=self.env,
                    stdin=subprocess.PIPE, stdout=o, stderr=e, text=True,
                    start_new_session=True))

    def _read(self, pid, stream):
        with open(self._path(pid, stream)) as f:
            return f.read()

    def _failed(self, pid, why):
        tail = self._read(pid, "err")[-3000:]
        self.close()
        fail(f"multihost path: worker {pid} {why}; its stderr ends:\n{tail}")

    def _await(self, done):
        """Polls until ``done(pid)`` holds for every worker; a worker that
        exits first (or a wait past ``MULTIHOST_WAIT_S``) fails the
        phase. Returns the pid of a worker that lost its port instead."""
        deadline = time.monotonic() + MULTIHOST_WAIT_S
        while True:
            if all(done(pid) for pid in range(MULTIHOST_PROCS)):
                return None
            for pid, p in enumerate(self.procs):
                if p.poll() is not None and not done(pid):
                    if "address already in use" in self._read(
                            pid, "err").lower():
                        return pid
                    self._failed(pid, f"exited {p.returncode}")
            if time.monotonic() > deadline:
                late = next(pid for pid in range(MULTIHOST_PROCS)
                            if not done(pid))
                self._failed(late, f"did not finish in {MULTIHOST_WAIT_S} s")
            time.sleep(0.2)

    def go(self):
        """Waits for every worker's ready line, then lets them onto the
        card."""
        while True:
            lost = self._await(
                lambda pid: MULTIHOST_READY in self._read(pid, "out"))
            if lost is None:
                break
            if self.tries >= MULTIHOST_BIND_TRIES:
                self._failed(lost, "lost its rendezvous port every time")
            self._stop()
            self._spawn()
        for pid, p in enumerate(self.procs):
            try:
                p.stdin.write("go\n")
                p.stdin.close()
            except BrokenPipeError:
                self._failed(pid, "ended before the go")

    def wait(self):
        """Every worker's JSON result, once all have exited 0."""
        lost = self._await(lambda pid: self.procs[pid].poll() == 0)
        if lost is not None:
            self._failed(lost, "lost its port on the card drive")
        return [json.loads(self._read(pid, "out").strip().splitlines()[-1])
                for pid in range(MULTIHOST_PROCS)]

    def _stop(self):
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=60)
            if p.stdin and not p.stdin.closed:
                p.stdin.close()

    def close(self):
        self._stop()
        shutil.rmtree(self.work, ignore_errors=True)


def multihost_path(torch, workers, known_reads, smi):
    """Multi-process sharding: ``MULTIHOST_PROCS`` processes on the one
    card (``MultihostWorkers``, ``multihost_worker``), each owning
    ``MULTIHOST_LOCAL`` of the 4 global shards at config #2, take their
    routed halves of ``sharded_path``'s first unit and of its known
    traces; the partition property is checked over gloo in each. Each
    owner's reads of the known traces must equal ``sharded_path``'s
    4-shard fleet's (``known_reads``), and the owners must partition the
    known traces. Its ``launches_by_path`` entry sums both workers'."""
    what = "multihost path"
    try:
        workers.go()
        t = time.perf_counter()
        outs = workers.wait()
        drive_s = time.perf_counter() - t
    finally:
        workers.close()
    owners = {}
    for o in outs:
        for tid, digest in o["reads"].items():
            if tid in owners:
                fail(f"{what}: known trace {tid} read back from two "
                     f"processes")
            if known_reads.get(tid) != digest:
                fail(f"{what}: worker {o['pid']}'s reads of known trace "
                     f"{tid} differ from the 4-shard fleet's")
            owners[tid] = o["pid"]
    if set(owners) != set(known_reads):
        fail(f"{what}: {len(owners)} of {len(known_reads)} known traces "
             f"read back from their owners")
    launches = {k: sum(o["kernel_launches"][k] for o in outs)
                for k in outs[0]["kernel_launches"]}
    steps = sum(o["ingest_steps"] for o in outs)
    result = {
        "processes": MULTIHOST_PROCS, "local_shards": MULTIHOST_LOCAL,
        "global_shards": MULTIHOST_PROCS * MULTIHOST_LOCAL,
        "rendezvous_tries": workers.tries, "drive_s": drive_s,
        "workers": [{
            "ready_s": o["mesh_wall"] - workers.spawned,
            **{k: o[k] for k in (
                "initialize_s", "unit_s", "fleet_s", "apply_s", "per_apply",
                "spans_kept", "reads_s", "gather_s", "peak_device_bytes",
                "write_pos_by_shard", "kept_traces_by_process",
                "kernel_launches", "ingest_steps")},
            "apply_spans_per_s": o["spans_kept"][0] / o["apply_s"][0],
            "known_traces_owned": len(o["reads"])} for o in outs],
        "known_traces": len(owners), "card": smi,
        "kernel_launches": launches, "ingest_steps": steps}
    log(f"multihost path result ({smi}): " + json.dumps(result))
    return result


def _fleet_reads(fleet, tids):
    """The reads a recovered fleet is held to: the known traces by id,
    their durations and existence, and each known service's by-name
    query."""
    end = 2**62
    return {
        "traces": fleet.get_spans_by_trace_ids(tids),
        "durations": fleet.get_traces_duration(tids),
        "exist": sorted(fleet.traces_exist(tids)),
        "by_name": {svc: fleet.get_trace_ids_by_name(svc, None, end, 20)
                    for svc in COLD_SERVICES},
        "services": sorted(fleet.get_all_service_names()),
    }


def _cut_drive(torch, dev, scale, device, work):
    """A 2-shard fleet at 2^14 journals 3 applies into a ShardedWal at
    fsync batch; the epoch log's last segment is cut mid-record and the
    log reopened: alignment must cut the shard logs back to the complete
    prefix (``aligned_records_cut`` > 0) and the replay must land the
    fleet of the first two applies."""
    from zipkin_tpu_torch import obs
    from zipkin_tpu_torch.parallel.shard import ShardedSpanStore
    from zipkin_tpu_torch.wal import ShardedWal, replay_into

    what = "sharded durability cut drive"
    cfg = full_config(dev, scale.small_log2, scale.services)
    applies = span_applies(scale, 3, scale.small_traces, PARITY_STEP_US,
                           seed=75)
    wal_dir = os.path.join(work, "cut-wal")
    made = []

    def fleet():
        f = ShardedSpanStore(2, cfg, device=device.type,
                             registry=obs.Registry())
        made.append(f)
        return f

    try:
        a = fleet()
        wal = ShardedWal(wal_dir, 2, fsync="batch", registry=obs.Registry())
        a.attach_wal(wal)
        for spans in applies:
            a.apply(spans)
        wal.close()
        seg = sorted(os.listdir(os.path.join(wal_dir, "epoch")))[-1]
        seg = os.path.join(wal_dir, "epoch", seg)
        os.truncate(seg, os.path.getsize(seg) - 7)
        t = time.perf_counter()
        cut = ShardedWal(wal_dir, 2, fsync="batch", registry=obs.Registry())
        align_s = time.perf_counter() - t
        try:
            if cut.aligned_records_cut <= 0 or cut.last_seq != 2:
                fail(f"{what}: reopening cut {cut.aligned_records_cut} "
                     f"records and left seq {cut.last_seq}, not 2")
            b = fleet()
            stats = replay_into(b, cut)
        finally:
            cut.close()
        if stats["replayed_records"] != 2:
            fail(f"{what}: replayed {stats}, not the 2 complete units")
        twin = fleet()
        for spans in applies[:2]:
            twin.apply(spans)
        for i, (x, y) in enumerate(zip(twin.states, b.states)):
            check_card_states_equal(x, y, f"{what} (shard {i})")
        if b.write_frontier() != twin.write_frontier():
            fail(f"{what}: the replayed frontier differs")
        return {"capacity": cfg.capacity, "applies": len(applies),
                "align_s": align_s,
                "aligned_records_cut": cut.aligned_records_cut,
                "torn_records_cut": cut.torn_records_cut,
                "replayed_records": stats["replayed_records"]}
    finally:
        for f in made:
            f.close()


def sharded_durability_path(torch, K, dev, scale, device, smi, units):
    """Sharded durability on the card: a 2-shard ``ShardedSpanStore`` at
    the full configuration (2 x ~4.8 GB) journals into a ``ShardedWal``
    at fsync ``batch`` through ``pipelined(depth=4)``: 2 of
    ``sharded_path``'s units of 114,688 decoded spans, ``checkpoint.
    save``, then 1 more unit with 100 known traces (the tail) and
    ``wal_sync``. A crash (the log closed, no save) and ``recover`` of
    the snapshot plus the log on the card must replay exactly the tail's
    one record; the recovered fleet must equal the uncrashed one on the
    card (every shard's leaves, integers bitwise and moments by stated
    tolerance 2), its frontier, applied sequence, clocks and the known
    traces' reads; K1, the claim and the write must launch once a shard
    step, journaled and replayed (the ``sharded_durability`` entry of
    ``launches_by_path``); one apply after the recovery journals as
    record 4. Then ``_cut_drive`` at 2^14. The snapshot is deleted at
    the end."""
    from zipkin_tpu_torch import checkpoint, obs
    from zipkin_tpu_torch.parallel.shard import ShardedSpanStore
    from zipkin_tpu_torch.wal import ShardedWal, recover

    what = "sharded durability path"
    cfg = full_config(dev, scale.cap_log2, scale.services)
    known = cold_known(scale.cold_known, 74, WIN_BASE_US + 3 * WIN_STEP_US)
    tids = [tr[0].trace_id for tr in known]
    # Two units before the save and one after (one and one in the
    # rehearsal, whose sharded phase makes two).
    before = units[:-1][:2]
    tail = units[len(before)] + [s for tr in known for s in tr]
    after = [s for tr in cold_known(10, 76, WIN_BASE_US + 4 * WIN_STEP_US)
             for s in tr]
    free_card(torch, device)
    work = tempfile.mkdtemp(prefix="zipkin-sharded-durability-")
    wal_dir, ckpt = os.path.join(work, "wal"), os.path.join(work, "ckpt")
    fleet = rec = wal2 = None
    try:
        fleet = ShardedSpanStore(2, cfg, device=device.type,
                                 registry=obs.Registry())
        wal = ShardedWal(wal_dir, 2, fsync="batch", registry=obs.Registry())
        fleet.attach_wal(wal)
        journal_s = []
        _timed_method(fleet, "_journal_unit", journal_s)
        K.reset_launches()
        apply_s = []
        with fleet.pipelined(depth=4):
            t0 = time.perf_counter()
            for spans in before:
                t = time.perf_counter()
                fleet.apply(spans)
                apply_s.append(time.perf_counter() - t)
            fleet.drain_pipeline()
            sync(torch, device)
            ingest_s = time.perf_counter() - t0
            steps_at_save = sum(int(b["batches"])
                                for b in fleet.shard_counters())
            t = time.perf_counter()
            save = checkpoint.save(fleet, ckpt)
            save_s = time.perf_counter() - t
            t = time.perf_counter()
            fleet.apply(tail)
            fleet.drain_pipeline()
            sync(torch, device)
            tail_s = time.perf_counter() - t
        fleet.wal_sync()
        ingest_launches = dict(K.LAUNCHES)
        n_units = len(before) + 1
        steps = sum(int(b["batches"]) for b in fleet.shard_counters())
        if steps != 2 * n_units or wal.last_seq != n_units:
            fail(f"{what}: {steps} shard steps and {wal.last_seq} epochs "
                 f"in {n_units} journaled units")
        if device.type == "cuda":
            for k in ("flat_histogram", "arena_claim", "arena_write"):
                if ingest_launches[k] != 2 * n_units:
                    fail(f"{what}: {k} launched {ingest_launches[k]} times "
                         f"in {n_units} journaled units of 2 shards")
        wal.close()  # the crash: no save after the tail
        fleet.wal = None
        free_card(torch, device)
        wal2 = ShardedWal(wal_dir, 2, fsync="batch", registry=obs.Registry())
        t = time.perf_counter()
        rec, stats = recover(ckpt, wal2, device=device.type)
        sync(torch, device)
        recover_s = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated()
                if device.type == "cuda" else 0)
        launches = dict(K.LAUNCHES)
        replayed = {k: launches[k] - ingest_launches[k] for k in launches}
        # The shard steps the replay ran, counted by the recovered
        # fleet's own counter blocks past the snapshot's.
        replayed_steps = sum(int(b["batches"])
                             for b in rec.shard_counters()) - steps_at_save
        if stats["replayed_records"] != 1 or stats["applied_seq"] != n_units:
            fail(f"{what}: replayed {stats}, not the one tail record up to "
                 f"seq {n_units}")
        if replayed_steps != 2 * stats["replayed_records"]:
            fail(f"{what}: {replayed_steps} shard steps replayed for "
                 f"{stats['replayed_records']} records of 2 shards")
        if device.type == "cuda":
            for k in ("flat_histogram", "arena_claim", "arena_write"):
                if replayed[k] != replayed_steps:
                    fail(f"{what}: {k} launched {replayed[k]} times in "
                         f"{replayed_steps} replayed shard steps")
        for i, (a, b) in enumerate(zip(fleet.states, rec.states)):
            check_card_states_equal(a, b, f"{what} (shard {i})")
        clocks = [(f.inner._wp_upper, f.inner._archived_lower,
                   f.inner._batches_since_sweep, f._step_seq,
                   f._wal_applied, f.write_frontier())
                  for f in (fleet, rec)]
        if clocks[0] != clocks[1]:
            fail(f"{what}: the recovered clocks {clocks[1]} differ from "
                 f"the uncrashed fleet's {clocks[0]}")
        want, got = _fleet_reads(fleet, tids), _fleet_reads(rec, tids)
        if got != want:
            fail(f"{what}: the recovered fleet's reads differ: " + ", ".join(
                k for k in want if got[k] != want[k]))
        if [len(t) for t in got["traces"]] != [len(tr) for tr in known]:
            fail(f"{what}: the known traces did not read back whole")
        if not any(got["by_name"].values()):
            fail(f"{what}: the known services' queries came back empty")
        rec.apply(after)
        if wal2.last_seq != n_units + 1:
            fail(f"{what}: the apply after recovery journaled as epoch "
                 f"{wal2.last_seq}, not {n_units + 1}")
        load = stats["load"]
        spans_in = sum(len(u) for u in before) + len(tail)
        result = {
            "shards": 2, "units": n_units, "known_traces": len(known),
            "spans_per_unit": [len(u) for u in before] + [len(tail)],
            "journaled_apply_spans_per_s": spans_in / (ingest_s + tail_s),
            "apply_return_s": apply_s, "ingest_s": ingest_s,
            "tail_s": tail_s,
            "journal_ms_per_unit": 1e3 * float(np.mean(journal_s)),
            "save_s": save_s,
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
            "recover_s": recover_s, "recover_peak_device_bytes": peak,
            "card": smi, "kernel_launches": launches,
            "replayed_steps": replayed_steps,
            "ingest_steps": steps + replayed_steps}
        rec.close()
        fleet.close()
        wal2.close()
        rec = fleet = wal2 = None
        free_card(torch, device)
        result["cut_drive"] = _cut_drive(torch, dev, scale, device, work)
        log(f"sharded durability path result ({smi}): "
            + json.dumps(result))
        return result
    finally:
        for c in (rec, fleet, wal2):
            if c is not None:
                c.close()
        shutil.rmtree(work, ignore_errors=True)
        free_card(torch, device)


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
    # The collector phase's traffic is made from here on, in worker
    # processes beside the next phases.
    traffic = EarlyTraffic(scale)
    # The sharded daemon's empty snapshot is made on the host from here
    # on too.
    snapshot = Background("sharded-snapshot", empty_fleet_snapshot, dev,
                          scale)
    cpaged = phase("cold_tier_paged", cold_tier_paged, torch, K, dev, scale,
                   device)
    phase("cold_tier_parity", cold_tier_parity, torch, dev, scale,
          args.rehearse)
    coll, daemon_traffic = phase("collector_path", collector_path, torch, K,
                                 dev, scale, device, wresult, traffic)
    query = phase("query_path", query_path, torch, K, dev, scale, device)
    phase_s["http (inside query_path)"] = query["http"]["s"]
    log(f"phase http (inside query_path): {query['http']['s']:.1f} s")
    piped = phase("pipeline_path", pipeline_path, torch, K, dev, scale,
                  device)
    phase("parity", parity_phase, torch, dev, scale, args.rehearse, False)
    phase("paged_parity", parity_phase, torch, dev, scale, args.rehearse,
          True)
    # The multi-process phase's workers start, meet and decode their
    # unit beside the sharded phase; they touch the card after it.
    workers = MultihostWorkers(device, args.rehearse)
    sharded, units, known_reads = phase("sharded_path", sharded_path, torch,
                                        K, dev, scale, device, smi)
    multihost = phase("multihost_path", multihost_path, torch, workers,
                      known_reads, smi)
    sdurable = phase("sharded_durability_path", sharded_durability_path,
                     torch, K, dev, scale, device, smi, units)
    del units
    durable, boot = phase("durability_path", durability_path, torch, K,
                          dev, scale, device)
    daemon = phase("daemon_path", daemon_path, torch, K, scale, device,
                   boot, daemon_traffic, snapshot)
    fleet = phase("fleet_path", fleet_path, torch, K, dev, scale, device)
    repl = phase("replication_path", replication_path, torch, K, dev, scale,
                 device)
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
                                   for k in cpaged["kernel_launches"]},
               "collector": coll["kernel_launches"],
               "query": query["kernel_launches"],
               "http": query["http"]["kernel_launches"],
               "fleet": fleet["kernel_launches"],
               "daemon": daemon["kernel_launches"],
               "replication": repl["kernel_launches"],
               "kafka": coll["kafka"]["kernel_launches"],
               "sharded": sharded["kernel_launches"],
               "multihost": multihost["kernel_launches"],
               "sharded_durability": sdurable["kernel_launches"],
               "sharded_daemon": daemon["sharded"]["kernel_launches"]}
    steps_by_path = {"ring": result["ingest_steps"],
                     "paged": presult["ingest_steps"],
                     "window": wresult["ingest_steps"],
                     "pipeline": piped["ingest_steps"],
                     "durability": durable["ingest_steps"],
                     "durability_paged": 0,
                     "cold_tier": cold["ingest_steps"],
                     "cold_tier_paged": cpaged["ingest_steps"],
                     "collector": coll["ingest_steps"],
                     "query": query["ingest_steps"],
                     "http": query["http"]["ingest_steps"],
                     "fleet": fleet["ingest_steps"],
                     "daemon": daemon["ingest_steps"],
                     "replication": repl["ingest_steps"],
                     "kafka": coll["kafka"]["ingest_steps"],
                     "sharded": sharded["ingest_steps"],
                     "multihost": multihost["ingest_steps"],
                     "sharded_durability": sdurable["ingest_steps"],
                     "sharded_daemon": daemon["sharded"]["ingest_steps"]}
    kernels = [
        {"name": "flat_histogram", "route": "cuda",
         "source": "zipkin_tpu_torch/csrc/flat_histogram.cu",
         "replaces": "zipkin_tpu/ops/pallas_kernels.py:105",
         "launches": result["kernel_launches"]["flat_histogram"],
         "launches_by_path": {p: v["flat_histogram"]
                              for p, v in by_path.items()},
         "steps_by_path": steps_by_path,
         "max_abs_err": max([hist["max_abs_err"], hist8["max_abs_err"],
                             result["sketch_api"]["max_abs_err"]]
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
                 "bound_ms", "library_ms")}},
         "cms_update": {k: result["sketch_api"][k] for k in (
             "rows", "cells", "touched", "ms", "device_ms", "plain_ms",
             "bound_ms", "library_ms", "max_abs_err", "api_k1_launches")}},
        {"name": "arena_claim_scatter", "route": "cuda",
         "source": "zipkin_tpu_torch/csrc/arena_claim_scatter.cu",
         "replaces": "zipkin_tpu/ops/pallas_kernels.py:247",
         "launches": result["kernel_launches"]["arena_claim"],
         "launches_by_path": {p: {h: v[h] for h in arena["halves"]}
                              for p, v in by_path.items()},
         "steps_by_path": steps_by_path,
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
         "steps_by_path": steps_by_path,
         "max_abs_err": gather["max_abs_err"], "ms": gather["ms"],
         "uncached_ms": gather["uncached_ms"],
         "device_ms": gather["device_ms"],
         "plain_ms": gather["plain_ms"],
         "bound_ms": gather["bound_ms"], "bound_by": "bytes",
         "library_ms": gather["library_ms"],
         "library_with_stack_ms": gather["library_with_stack_ms"],
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
