"""graftlint (the JAX package's analyzer, ``zipkin_tpu/analysis``) over
the port, ``zipkin_tpu_torch/``, against an empty baseline.

The port keeps the reference's lock conventions: every lock declares
its rank with ``# lock-order: <rank>`` (the store's encode lock 10,
capture 30, commit 40, the sealed-frontier leaf 45, the WAL 60, the
pipeline stage 65, the fleet tracker 82; replication's as the reference
ranks them: the replica's apply lock 12 and its readers/writer lock 40,
the lock's own condition 42, the shipper's followers 79, the follower's
stats 80), every ``# guarded-by:`` field
is read under its lock or suppressed with a reason, and the acquisition
graph has no cycle and no inverted edge. Any finding fails; there is no
baseline to hide one in.
"""

import os

import pytest

from zipkin_tpu.analysis import ALL_RULES, analyze, load_project
from zipkin_tpu.analysis import baseline as baseline_mod
from zipkin_tpu.analysis.rules_locks import build_edges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "zipkin_tpu_torch")


@pytest.fixture(scope="module")
def project():
    return load_project([PORT], REPO)


@pytest.fixture(scope="module")
def findings(project):
    return analyze(project)


def test_port_has_no_findings_against_an_empty_baseline(findings, tmp_path):
    empty = tmp_path / "baseline.json"
    empty.write_text('{"findings": {}, "version": 1}')
    new, stale = baseline_mod.diff(findings, baseline_mod.load(str(empty)))
    assert stale == []
    assert new == [], "graftlint findings in the port:\n" + "\n".join(
        f.render() for f in new)


@pytest.mark.parametrize("rule", ALL_RULES)
def test_port_is_clean_rule_by_rule(findings, rule):
    got = [f.render() for f in findings if f.rule == rule]
    assert got == []


def test_every_port_lock_is_ranked(project):
    unranked = [k for k, d in project.locks.items() if d.rank is None]
    assert unranked == []
    ranks = {k: d.rank for k, d in project.locks.items()}
    assert ranks["TorchSpanStore._lock"] == 10
    assert ranks["TorchSpanStore._cap_lock"] == 30
    assert ranks["TorchSpanStore._state_lock"] == 40
    assert ranks["WriteAheadLog._cond"] == 60
    assert ranks["_StageBase._cond"] == 65
    assert ranks["LineageTracker._lock"] == 82
    # Replication, ranked as the reference ranks them.
    assert ranks["ReplicaSpanStore._lock"] == 12
    assert ranks["ReplicaSpanStore._rw"] == 40
    assert ranks["RWLock._cond"] == 42
    assert ranks["WalShipper._lock"] == 79
    assert ranks["Follower._lock"] == 80


def test_port_lock_graph_sees_the_write_path(project):
    """The analyzer resolves the write path's canonical edges, so the
    order and cycle rules protect it (the lineage stamp under the encode
    lock among them)."""
    edges = {(a, b) for a, b, *_ in build_edges(project)}
    expected = {
        ("TorchSpanStore._lock", "TorchSpanStore._cap_lock"),
        ("TorchSpanStore._cap_lock", "TorchSpanStore._state_lock"),
        ("TorchSpanStore._state_lock", "SketchMirror._lock"),
        ("TorchSpanStore._lock", "WriteAheadLog._cond"),
        ("TorchSpanStore._lock", "LineageTracker._lock"),
        ("TorchSpanStore._cap_lock", "_StageBase._cond"),
        ("TorchSpanStore._state_lock", "TorchSpanStore._seal_lock"),
    }
    missing = expected - edges
    assert not missing, f"lock graph lost edges: {sorted(missing)}"


def test_fleet_module_is_analyzed(project):
    locks = set(project.locks)
    assert {"LineageTracker._lock", "FollowerLineage._lock",
            "Watchdog._lock", "FlightRecorder._lock"} <= locks
