"""The PyTorch port stands alone: no module of ``zipkin_tpu_torch`` and
not ``chip_smoke.py`` imports JAX or the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "zipkin_tpu")


def _sources():
    files = sorted((ROOT / "zipkin_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_imports(path):
    assert path.exists(), path
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax():
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['zipkin_tpu'] = None; "
            "import zipkin_tpu_torch.store.torch_store, "
            "zipkin_tpu_torch.store.convert, zipkin_tpu_torch.tracegen, "
            "zipkin_tpu_torch.store.pipeline, zipkin_tpu_torch.store.mirror, "
            "zipkin_tpu_torch.store.analytics, "
            "zipkin_tpu_torch.aggregate.windows, zipkin_tpu_torch.obs, "
            "zipkin_tpu_torch.checkpoint, zipkin_tpu_torch.wal, "
            "zipkin_tpu_torch.wal.log, zipkin_tpu_torch.wal.record, "
            "zipkin_tpu_torch.wal.recovery, zipkin_tpu_torch.wal.sharded, "
            "zipkin_tpu_torch.testing.crash, "
            "zipkin_tpu_torch.store.memory, zipkin_tpu_torch.store.archive, "
            "zipkin_tpu_torch.store.archive.sketches, "
            "zipkin_tpu_torch.store.archive.segment, "
            "zipkin_tpu_torch.store.archive.directory, "
            "zipkin_tpu_torch.store.archive.coldquery, "
            "zipkin_tpu_torch.store.archive.tiered, "
            "zipkin_tpu_torch.wire, zipkin_tpu_torch.wire.thrift, "
            "zipkin_tpu_torch.native, zipkin_tpu_torch.sampler, "
            "zipkin_tpu_torch.sampler.core, "
            "zipkin_tpu_torch.sampler.adaptive, zipkin_tpu_torch.ingest, "
            "zipkin_tpu_torch.ingest.queue, "
            "zipkin_tpu_torch.ingest.collector, "
            "zipkin_tpu_torch.ingest.receiver, "
            "zipkin_tpu_torch.ingest.scribe_server, "
            "zipkin_tpu_torch.ingest.kafka, zipkin_tpu_torch.client, "
            "zipkin_tpu_torch.aggregate, zipkin_tpu_torch.aggregate.job, "
            "zipkin_tpu_torch.models.trace, zipkin_tpu_torch.query, "
            "zipkin_tpu_torch.query.request, zipkin_tpu_torch.query.adjusters, "
            "zipkin_tpu_torch.query.coalesce, zipkin_tpu_torch.query.engine, "
            "zipkin_tpu_torch.query.service, zipkin_tpu_torch.api, "
            "zipkin_tpu_torch.api.query_extractor, "
            "zipkin_tpu_torch.concurrency, zipkin_tpu_torch.replicate, "
            "zipkin_tpu_torch.replicate.protocol, "
            "zipkin_tpu_torch.replicate.ship, "
            "zipkin_tpu_torch.replicate.follow, "
            "zipkin_tpu_torch.store.replica; "
            "from zipkin_tpu_torch.store.torch_store import TorchSpanStore; "
            "from zipkin_tpu_torch.store.archive import TieredSpanStore; "
            "from zipkin_tpu_torch.replicate import Follower, ReplicaTarget, "
            "ShipClient, ShipProtocolError, ShipServer, StandbyTarget, "
            "WalShipper; "
            "from zipkin_tpu_torch.store.replica import ReplicaSpanStore, "
            "ReplicaReadOnlyError, concat_batch_parts; "
            "from zipkin_tpu_torch.concurrency import RWLock; "
            "from zipkin_tpu_torch.store.device import "
            "recompute_dep_moments, dep_link_moments; "
            "assert TorchSpanStore.write_thrift and "
            "TieredSpanStore.write_thrift; "
            "from zipkin_tpu_torch.client import B3Headers, Tracer; "
            "from zipkin_tpu_torch.query import QueryService, QueryEngine; "
            "from zipkin_tpu_torch.api import extract_query; "
            "from zipkin_tpu_torch.ops import cms, hashing, hll, moments, "
            "quantile, topk; "
            "from zipkin_tpu_torch.ops.kernels import cms_update; "
            "assert hashing.join64 and cms.CountMin and hll.HyperLogLog "
            "and quantile.LogHistogram and moments.variance and "
            "topk.Counters; "
            "from zipkin_tpu_torch.testing.kafka_fake import "
            "FakeKafkaBroker, MinimalKafkaConsumer, MinimalKafkaProducer")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_native_codec_builds_from_the_port_source_into_its_build_dir():
    """The port's codec is compiled from ``zipkin_tpu_torch/csrc`` into
    ``build/zipkin_tpu_torch/`` and loaded from there, never from the
    JAX package's ``native/`` directory (both packages' tests share one
    process)."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['zipkin_tpu'] = None; "
            "from zipkin_tpu_torch import native; "
            "assert native.available(); print(native.loaded_from); "
            "print(native._SRC)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         check=True, timeout=180, capture_output=True,
                         text=True).stdout.split()
    so, src = Path(out[0]).resolve(), Path(out[1]).resolve()
    assert so.parent == (ROOT / "build" / "zipkin_tpu_torch").resolve()
    assert src == (ROOT / "zipkin_tpu_torch" / "csrc" / "span_codec.cc")
    assert (ROOT / "native").resolve() not in so.parents
    from zipkin_tpu import native as ref_native

    assert Path(ref_native._SO).resolve() != so


def test_fleet_imports_without_jax():
    """Fleet observability and the lineage hook import with JAX and the
    JAX package blocked, and the store exposes ``attach_lineage``."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['zipkin_tpu'] = None; "
            "from zipkin_tpu_torch.obs import fleet; "
            "from zipkin_tpu_torch.obs import FleetObs, LineageTracker, "
            "Watchdog, FlightRecorder, FollowerLineage; "
            "from zipkin_tpu_torch.store.torch_store import TorchSpanStore; "
            "from zipkin_tpu_torch.store.pipeline import EvictionSealer, "
            "IngestPipeline; "
            "assert TorchSpanStore.attach_lineage; "
            "assert EvictionSealer.at_capacity and "
            "IngestPipeline.progress_age_s; "
            "assert fleet.fsync_parked_probe and fleet.sealer_backlog_probe")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_sharded_durability_imports_without_jax():
    """The sharded log, its replay and the fleet's journal and pipeline
    import with JAX and the JAX package blocked."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['zipkin_tpu'] = None; "
            "from zipkin_tpu_torch.wal import ShardedWal, "
            "replay_sharded_into; "
            "from zipkin_tpu_torch.parallel import ShardedSpanStore; "
            "from zipkin_tpu_torch import checkpoint; "
            "assert ShardedWal.append_unit and ShardedWal.replay_units; "
            "assert ShardedSpanStore.attach_wal and "
            "ShardedSpanStore.pipelined; "
            "assert checkpoint._sharded_clocks and replay_sharded_into")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_daemon_imports_without_jax():
    """The daemon entry, tracegen's main and the step census import with
    JAX and the JAX package blocked, and the store has ``step_census``."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['zipkin_tpu'] = None; "
            "import zipkin_tpu_torch.main; "
            "from zipkin_tpu_torch.main import example, tracegen; "
            "from zipkin_tpu_torch.store import census; "
            "from zipkin_tpu_torch.store.torch_store import TorchSpanStore; "
            "assert example.build_app and example.shutdown and "
            "example.serve_until and tracegen.run; "
            "assert example.build_follower_app and example.start_follower "
            "and example.follow_until and example.follower_shutdown; "
            "assert census.LOWERING_TABLE and TorchSpanStore.step_census")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
