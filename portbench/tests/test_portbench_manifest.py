"""BENCHMARK.json against the contract's names and links, and a cell of a
new kind (a configuration, a mix, its driver, limits and a per-layer
metric) added as new files only."""

import json
import re
import shutil

from conftest import ROOT, tiny
from portbench.lib.cell import run_cell
from portbench.lib.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_files():
    man = Manifest(ROOT)
    d = man.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = []
    for c in d["configs"]:
        names.append(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in d["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
        assert w["chips"] in (1, 4)
        mix = man.traffic(w)
        assert (man.dir / "drivers" / f"{mix['driver']}.py").is_file()
        assert (man.dir / "limits" / f"{w['name']}.json").is_file()
        assert len(w["why"]) <= 200
    for m in d["end_to_end"] + d["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in d["per_layer"]:
        assert (man.dir / "metrics" / f"{m['name']}.py").is_file()
    assert all(NAME.match(n) for n in names), names
    assert any(m["name"] == "setup_s" for m in d["end_to_end"])


def test_every_cell_reports_what_its_per_layer_metrics_move():
    man = Manifest(ROOT)
    for w in man.data["workloads"]:
        e2e = {m["name"] for m in man.end_to_end(w)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = man.per_layer(w)
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


# A kind of traffic the benchmark does not have: the stream's steps
# restamped on the host and committed through the store's public
# ``write_batch`` (host columns uploaded each step), with a per-step
# counter of its own.
HOST_DRIVER = '''"""Host batches: each step restamped on the host and committed
through ``TorchSpanStore.write_batch``."""

import time

import numpy as np

from portbench.drivers.restamp_stream import RestampStream
from portbench.lib import gen


def build(config, mix, seed, device):
    return HostBatches(config, mix, seed, device)


class HostBatches(RestampStream):
    def commit(self, t):
        from zipkin_tpu_torch.columnar.schema import SpanBatch

        k, tm = len(self.order), self.templates[t]
        cols = gen.restamp_host(tm.cols, gen.step_salt(self.seed, k),
                                gen.step_delta(k))
        t0 = time.time_ns()
        self.store.write_batch(SpanBatch(**cols), np.ones(tm.n_spans, bool))
        self.order.append(t)
        self.spans.add("write_batch", t0, time.time_ns())
'''


def test_a_new_kind_of_cell_needs_only_new_files(tmp_path):
    """A configuration, a mix of a new kind with its driver, a cell, its
    limits and a per-layer metric added as new files and new entries:
    the harness finds and runs them, and no file it had changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    cfg, mix = tiny("ring.bulk")
    mix["driver"] = "host_batches"
    pb = tmp_path / "portbench"
    (pb / "configs/tiny.ring.json").write_text(json.dumps(cfg))
    (pb / "traffic/host_trickle.json").write_text(json.dumps(mix))
    (pb / "drivers/host_batches.py").write_text(HOST_DRIVER)
    (pb / "limits/tiny.host_trickle.json").write_text(
        (ROOT / "portbench/limits/ring.bulk.json").read_text())
    (pb / "metrics/write_batch_ms.py").write_text(
        "def read(ctx):\n"
        "    s = ctx.system.spans.spans.get('write_batch', [])\n"
        "    return sum(b - a for a, b, _ in s) / len(s) / 1e6 if s "
        "else None\n")
    bench["configs"].append({"name": "tiny.ring", "source": "a test",
                             "file": "portbench/configs/tiny.ring.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.host_trickle",
                               "config": "tiny.ring",
                               "traffic": "host_trickle", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "write_batch_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "store commit",
                               "moves": "ingest_spans_per_s",
                               "workloads": ["tiny.host_trickle"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cell(tmp_path, "tiny.host_trickle", 3, 0.4, True, device="cpu")
    assert out.correct, out.checks
    assert out.attempted >= 1
    assert out.metrics["write_batch_ms"]["value"] > 0
    assert "commit_call_ms" not in out.metrics
    untraced = run_cell(tmp_path, "tiny.host_trickle", 4, 0.4, False,
                        device="cpu")
    assert untraced.correct, untraced.checks
    assert untraced.metrics["ingest_spans_per_s"]["value"] > 0
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data
