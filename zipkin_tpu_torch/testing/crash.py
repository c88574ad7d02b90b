"""Crash-injection harness: named kill points + a subprocess drive.

The durability contract is only testable by actually dying: a child
process drives the normal ingest path of a ``TorchSpanStore`` with a
WAL attached and ``SIGKILL``s ITSELF at a named point mid-write; the
parent then recovers from what survived on disk and compares the
result against an uncrashed oracle drive of the same batches, on the
same device.

Kill points (activated via ``ZIPKIN_CRASH_POINT=<name>[:N]`` — fire on
the Nth hit, default the 1st; SIGKILL, so no atexit/finally runs):

- ``before-append``   just before a launch group's WAL append — the
  batch must be absent in full after recovery.
- ``after-append``    between the durable append and the device
  commit — replay must re-apply the batch.
- ``after-commit``    after the device commit, before the ack returns —
  the batch is present though never acked (durability is one-way).
- ``mid-seal``        between an eviction-capture pull and the cold
  segment append (``_hand_off`` inline, the sealer thread otherwise) —
  tiered drives (``--tiered``) only; the window is re-captured from
  the restored rings and the cold frontier stays contiguous.
- ``mid-checkpoint``  between checkpoint.save's two renames — load
  must fall back to ``.old`` (or a fresh store) + WAL replay.
- ``mid-truncate``    between per-segment deletes of a checkpoint's
  WAL truncation — the surviving suffix must still recover.

``kill_point`` is a dict-miss-fast no-op when the env var is unset, so
the production hooks cost one attribute load per call site.

Child usage (the parent helper ``run_crash_child`` builds this):

    ZIPKIN_CRASH_POINT=after-append \\
    python -m zipkin_tpu_torch.testing.crash WORKDIR --batches 10 \\
        --ckpt-at 5 --device cuda

The child acks each batch only after ``wait_durable`` (fsync=batch by
default) and journals progress to ``WORKDIR/acked.log`` (fsync'd), so
the parent knows exactly which batches were durably acked. It asserts
one WAL record per batch (exit 3 otherwise) — the invariant that lets
the parent line the recovered record frontier up against a batch-
granular oracle drive.

Exactness: on the CPU the port is deterministic, so a recovered state
equals the oracle's bitwise. On CUDA the float32 dependency moments
(``dep_window``, ``dep_moments``, ``dep_banks``) are summed in atomic
order, so there every integer leaf and counter is held bitwise and
those three leaves within ``moments_close`` (ROADMAP Queue 3, stated
tolerance 2).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

# -- the kill switch (read once, at import, in the CHILD process) -------

_spec = os.environ.get("ZIPKIN_CRASH_POINT")
if _spec:
    _name, _, _nth = _spec.partition(":")
    _POINT: Optional[str] = _name
    _NTH = int(_nth) if _nth else 1
else:
    _POINT, _NTH = None, 0
_hits = 0

KILL_POINTS = ("before-append", "after-append", "after-commit",
               "mid-seal", "mid-checkpoint", "mid-truncate")

MOMENT_LEAVES = ("dep_window", "dep_moments", "dep_banks")


def kill_point(name: str) -> None:
    """Die here (SIGKILL — no cleanup, no flush) when this is the
    activated point's Nth hit. No-op unless ZIPKIN_CRASH_POINT is set."""
    global _hits
    if _POINT is None or name != _POINT:
        return
    _hits += 1
    if _hits >= _NTH:
        os.kill(os.getpid(), signal.SIGKILL)


# -- shared drive fixtures (child AND parent oracle use these) ----------
#
# Geometry note: the serial config never evicts at the drive sizes the
# tests use (WAL mechanics only); the tiered config's 2^8 ring laps
# several times, so eviction capture and cold-tier sealing are on the
# replayed path. Batches are sized so each apply plans exactly ONE
# launch unit (<= CHAIN_SIZES[0] trace parts, well under the span/ann
# budgets) — the child asserts it, see module docstring.

_TRACES_PER_BATCH = 6


def crash_config(tiered: bool = False):
    from zipkin_tpu_torch.store import device as dev

    if tiered:
        return dev.StoreConfig(
            capacity=1 << 8, ann_capacity=1 << 10, bann_capacity=1 << 9,
            max_services=32, max_span_names=64,
            max_annotation_values=256, max_binary_keys=64,
            cms_width=1 << 10, hll_p=6, quantile_buckets=256,
        )
    return dev.StoreConfig(
        capacity=1 << 10, ann_capacity=1 << 12, bann_capacity=1 << 11,
        max_services=32, max_span_names=128, max_annotation_values=256,
        max_binary_keys=64, cms_width=1 << 10, hll_p=8,
        quantile_buckets=512,
    )


def build_crash_store(tiered: bool = False, device="cuda"):
    """A fresh store at the harness geometry — the recovery factory
    and the oracle's constructor (identical construction on both sides is
    what makes the comparison meaningful). Tiered: a TieredSpanStore
    with the reference harness's archive params."""
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore

    hot = TorchSpanStore(crash_config(tiered), device=device)
    if not tiered:
        return hot
    from zipkin_tpu_torch.store.archive import ArchiveParams, TieredSpanStore

    return TieredSpanStore(hot, params=ArchiveParams.for_config(
        hot.config, compact_fanin=2, small_span_limit=hot.config.capacity,
        bloom_bits=1 << 12, cms_width=1 << 10, hll_p=6,
    ))


def crash_batches(n_batches: int, tiered: bool = False) -> List[list]:
    """Deterministic batches (seeded rng): the child drives them, the
    parent re-derives them for the oracle. The same spans as the JAX
    package's harness draws."""
    import numpy as np

    from zipkin_tpu_torch.tracegen.gen import generate_traces

    rng = np.random.default_rng(41 if tiered else 40)
    traces = generate_traces(
        n_traces=n_batches * _TRACES_PER_BATCH, max_depth=3,
        rng=rng, n_services=8,
    )
    return [
        [s for t in traces[i * _TRACES_PER_BATCH:
                           (i + 1) * _TRACES_PER_BATCH] for s in t]
        for i in range(n_batches)
    ]


def _paths(workdir: str) -> Tuple[str, str, str]:
    return (os.path.join(workdir, "wal"),
            os.path.join(workdir, "ckpt"),
            os.path.join(workdir, "acked.log"))


# -- child ---------------------------------------------------------------


def _child_main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="zipkin_tpu_torch.testing.crash")
    ap.add_argument("workdir")
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--ckpt-at", default="",
                    help="comma-separated 1-based batch counts after "
                         "which to checkpoint")
    ap.add_argument("--tiered", action="store_true")
    ap.add_argument("--fsync", default="batch")
    ap.add_argument("--segment-bytes", type=int, default=64 << 20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from zipkin_tpu_torch import checkpoint
    from zipkin_tpu_torch.wal import WriteAheadLog

    if args.device == "cpu":
        # The harness geometry is tiny; more threads only contend.
        torch.set_num_threads(2)
    os.makedirs(args.workdir, exist_ok=True)
    wal_dir, ckpt_dir, acked_path = _paths(args.workdir)
    ckpt_at = {int(x) for x in args.ckpt_at.split(",") if x}

    store = build_crash_store(args.tiered, device=args.device)
    wal = WriteAheadLog(wal_dir, fsync=args.fsync,
                        segment_bytes=args.segment_bytes)
    store.attach_wal(wal)
    batches = crash_batches(args.batches, tiered=args.tiered)

    acked = open(acked_path, "a")
    for i, batch in enumerate(batches):
        store.apply(batch)
        if wal.last_seq != i + 1:
            print(f"batch {i} planned {wal.last_seq - i} launch units; "
                  f"the harness requires exactly one — shrink the "
                  f"batch geometry", file=sys.stderr)
            return 3
        wal.wait_durable(wal.last_seq)
        # The ack: a receiver would return OK here. Journaled with its
        # own fsync so the parent knows the durably-acked frontier.
        acked.write(f"{i} {wal.last_seq}\n")
        acked.flush()
        os.fsync(acked.fileno())
        if i + 1 in ckpt_at:
            checkpoint.save(store, ckpt_dir)
    # No kill fired (point unset, or set past the drive): exit clean.
    wal.sync()
    return 0


# -- parent helpers ------------------------------------------------------


def run_crash_child(workdir: str, point: Optional[str] = None,
                    hit: int = 1, batches: int = 10,
                    ckpt_at: Sequence[int] = (), tiered: bool = False,
                    fsync: str = "batch",
                    segment_bytes: int = 64 << 20,
                    timeout: float = 600.0, device="cuda"):
    """Spawn the child drive; returns the CompletedProcess. A fired
    kill point shows up as ``returncode == -signal.SIGKILL``."""
    env = dict(os.environ)
    env.pop("ZIPKIN_CRASH_POINT", None)
    if point is not None:
        if point not in KILL_POINTS:
            raise ValueError(f"unknown kill point {point!r}")
        env["ZIPKIN_CRASH_POINT"] = f"{point}:{hit}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "zipkin_tpu_torch.testing.crash",
           workdir, "--batches", str(batches), "--fsync", fsync,
           "--segment-bytes", str(segment_bytes),
           "--device", str(device)]
    if ckpt_at:
        cmd += ["--ckpt-at", ",".join(str(x) for x in ckpt_at)]
    if tiered:
        cmd.append("--tiered")
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def acked_batches(workdir: str) -> int:
    """Number of batches the child durably acked before dying."""
    path = _paths(workdir)[2]
    if not os.path.exists(path):
        return 0
    n = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                n = int(parts[0]) + 1
    return n


def recover_crashed(workdir: str, tiered: bool = False, device="cuda"):
    """Recover from whatever the dead child left on disk. Returns
    (store, replay stats, wal)."""
    from zipkin_tpu_torch.wal import WriteAheadLog, recover

    wal_dir, ckpt_dir, _ = _paths(workdir)
    wal = WriteAheadLog(wal_dir, fsync="off")
    store, stats = recover(
        ckpt_dir, wal,
        fresh_store=lambda dev: build_crash_store(tiered, device=dev),
        device=device)
    return store, stats, wal


def moments_close(ref, got) -> bool:
    """Stated tolerance 2: the count field exact, the other fields
    within 1e-5 of the field's largest magnitude."""
    import numpy as np

    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    if ref.shape != got.shape:
        return False
    scale = np.abs(ref).reshape(-1, ref.shape[-1]).max(0)
    return (np.array_equal(ref[..., 0], got[..., 0])
            and bool(np.all(np.abs(ref - got)
                            <= 1e-5 * (np.abs(ref) + scale))))


def state_mismatches(a, b, moments_tolerance: bool = False
                     ) -> Dict[str, int]:
    """Leaf name -> differing cells between two port states (``-1``
    for a dtype/shape or counter mismatch); empty when equal. With
    ``moments_tolerance`` the three float32 moment leaves compare under
    ``moments_close`` and every other leaf stays bitwise."""
    import numpy as np

    from zipkin_tpu_torch.store.convert import state_to_numpy

    na, nb = state_to_numpy(a), state_to_numpy(b)
    out: Dict[str, int] = {}
    for k, x in na.items():
        y = nb[k]
        if k == "counters":
            if {c: int(v) for c, v in x.items()} != {
                    c: int(v) for c, v in y.items()}:
                out[k] = -1
        elif x.dtype != y.dtype or x.shape != y.shape:
            out[k] = -1
        elif moments_tolerance and k in MOMENT_LEAVES:
            if not moments_close(x, y):
                out[k] = int(np.count_nonzero(x != y))
        elif not np.array_equal(x, y):
            out[k] = int(np.count_nonzero(x != y))
    return out


def states_bitwise_equal(a, b) -> bool:
    return not state_mismatches(a, b)


def verify_recovery(workdir: str, total_batches: int,
                    tiered: bool = False, device="cuda") -> dict:
    """The acceptance check, shared by every kill-point test:

    1. every durably-ACKED batch survived (applied >= acked);
    2. the recovered state equals an uncrashed oracle that applied
       exactly the recovered batch prefix on the same device — bitwise
       on the CPU; on CUDA every integer leaf and counter bitwise and
       the moments under ``moments_close``;
    3. the first un-applied batch is PROVABLY ABSENT (its trace ids
       resolve to nothing), never partially applied;
    4. tiered: the cold segments' (gid_lo, gid_hi, n_spans) equal the
       oracle's, the sealed frontier is contiguous and reaches the
       capture clock, and federated trace reads equal the oracle's.

    Raises AssertionError with context on any violation."""
    import torch

    store, stats, wal = recover_crashed(workdir, tiered=tiered,
                                        device=device)
    wal.close()
    acked = acked_batches(workdir)
    applied = stats["applied_seq"]
    assert applied >= acked, (
        f"durably-acked batch lost: acked {acked}, recovered only "
        f"{applied} ({stats})")
    assert applied <= total_batches

    batches = crash_batches(total_batches, tiered=tiered)
    oracle = build_crash_store(tiered, device=device)
    for b in batches[:applied]:
        oracle.apply(b)

    hot, ohot = getattr(store, "hot", store), getattr(oracle, "hot", oracle)
    exact = torch.device(device).type == "cpu"
    bad = state_mismatches(ohot.state, hot.state,
                           moments_tolerance=not exact)
    assert not bad, (
        f"recovered state differs from the {applied}-batch oracle in "
        f"{bad} (acked {acked}, {stats})")
    if tiered:
        hot.seal_barrier()
        cold = sorted((s.gid_lo, s.gid_hi, s.n_spans)
                      for s in store.archive.snapshot())
        ocold = sorted((s.gid_lo, s.gid_hi, s.n_spans)
                       for s in oracle.archive.snapshot())
        assert cold == ocold, (
            f"cold tier differs: {cold} vs oracle {ocold}")
        for a, b in zip(cold, cold[1:]):
            assert a[1] == b[0], f"cold coverage has a hole: {cold}"
        with hot._cap_lock:
            cap_upto = hot._cap_upto
        assert hot.sealed_frontier() == cap_upto, (
            f"sealed frontier {hot.sealed_frontier()} short of the "
            f"capture clock {cap_upto}")
        for b in batches[:applied]:
            tids = sorted({s.trace_id for s in b})[:3]
            assert (store.get_spans_by_trace_ids(tids)
                    == oracle.get_spans_by_trace_ids(tids))
    if applied < total_batches:
        missing = sorted({s.trace_id for s in batches[applied]})
        got = store.get_spans_by_trace_ids(missing)
        assert not any(got), (
            f"un-acked batch {applied} partially applied: "
            f"{sum(map(len, got))} spans present")
    return {"acked": acked, "applied": applied, **stats}


if __name__ == "__main__":
    sys.exit(_child_main())
